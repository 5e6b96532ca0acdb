"""Fused training dispatch — the port of the JAX loop's multi-step scan
(``zoo.train.scan_steps``), device-resident dataset
(``zoo.train.device_cache``) and multi-epoch block
(``zoo.train.fuse_epochs``): JAX ``training.py`` ``_stack_batches``/
``_chunked``, ``build_scan_step``, ``build_epoch_fn``/``_make_epoch_body``
and ``build_multi_epoch_fn``.

Where the JAX loop traces K optimizer steps into one ``lax.scan``, a
:class:`StepProgram` captures K steps once as a ``torch.cuda.CUDAGraph``
over static device buffers and replays it: one launch from the host for
K steps of forward, backward and optimizer update. Its inputs:

* the step's batch: :class:`HostChunks` are ``(K, batch, ...)`` buffers
  the host fills with a stacked chunk of FeatureSet batches (through
  pinned memory, without a host wait); :class:`DeviceData` is the whole
  dataset on the device and a ``(K, batch)`` buffer of row indices, and
  each step gathers its batch there, inside the graph;
* the optimizer's per-step values (learning rate, bias corrections) in a
  ``(K, n)`` buffer the host writes before each replay
  (``optimizers.step_scalars``);
* the step's noise: one device generator a step, registered with the
  graph and seeded from ``(zoo.seed, iteration)`` before each replay
  (``common/noise.py``).

A shorter last chunk gets a graph of its own, in the same memory pool.
The first capture follows a warm-up step on the capture stream, whose
effect on the parameters and the optimizer state is undone. An op that
cannot be captured (a host sync, a copy from pageable memory) makes the
fit raise: there is no eager fallback. The kernel wrappers' launch
counters are kept true under replay (``ops/launch_count.py``).

On the CPU the same program runs its steps as they are, with a loop in
place of the replay: the same buffers, gathers and per-step values,
which is what the CPU tests hold against the JAX loop.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ....common.noise import step_seed
from ....ops.launch_count import Launches, record_launches
from .optimizers import n_scalars


def device_permutation(n: int, seed: int, device) -> torch.Tensor:
    """The epoch's order of a device-resident dataset of ``n`` rows, drawn
    on ``device`` from ``seed`` (``fs.seed + zoo.seed + epoch``): the
    counterpart of ``jax.random.permutation(jax.random.key(seed), n)``,
    which torch cannot reproduce, so parity tests replace this function."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randperm(n, generator=gen, device=device)


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _copy_in(dst: torch.Tensor, src: np.ndarray) -> None:
    """Host array → device buffer; a CUDA copy goes through pinned memory
    and does not block the host."""
    t = _tensor(src)
    if dst.is_cuda:
        t = t.pin_memory()
    dst.copy_(t, non_blocking=dst.is_cuda)


def _batch(xs: List[torch.Tensor], y: torch.Tensor):
    return (xs if len(xs) > 1 else xs[0]), y


class HostChunks:
    """``(K, batch, ...)`` buffers that the host fills with one stacked
    chunk (``feature_set.chunked``) before each dispatch."""

    def __init__(self, xs: List[np.ndarray], y: np.ndarray, k: int,
                 batch_size: int, device: torch.device):
        def buf(a):
            return torch.empty((k, batch_size) + a.shape[1:],
                               dtype=_tensor(a[:0]).dtype, device=device)
        self.device = device
        self.xs = [buf(a) for a in xs]
        self.y = buf(y)

    def fill(self, chunk) -> int:
        """Copies a chunk in; returns its number of steps."""
        cx, cy = chunk
        cx = cx if isinstance(cx, list) else [cx]
        k = cy.shape[0]
        for dst, src in zip(self.xs, cx):
            _copy_in(dst[:k], src)
        _copy_in(self.y[:k], cy)
        return k

    def batch(self, j: int):
        return _batch([b[j] for b in self.xs], self.y[j])


class DeviceData:
    """A FeatureSet's arrays on the device, uploaded once, and the ``(K,
    batch)`` row indices of the steps of one dispatch; each step gathers
    its batch on the device."""

    def __init__(self, xs: List[np.ndarray], y: np.ndarray, k: int,
                 batch_size: int, device: torch.device):
        self.device = device
        self.xs = [_tensor(a).to(device) for a in xs]
        self.y = _tensor(y).to(device)
        self.idx = torch.zeros(k, batch_size, dtype=torch.int64,
                               device=device)

    def fill(self, rows: torch.Tensor) -> int:
        """``rows`` (k, batch) indices on the device; returns k."""
        k = rows.shape[0]
        self.idx[:k].copy_(rows)
        return k

    def batch(self, j: int):
        idx = self.idx[j]
        return _batch([a.index_select(0, idx) for a in self.xs],
                      self.y.index_select(0, idx))


def _leaves(tree) -> List[torch.Tensor]:
    """Every tensor of an optimizer state (dicts and lists of tensors)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _leaves(sub)]
    return []


class StepProgram:
    """Up to ``k_max`` optimizer steps of a training loop over the static
    buffers of ``inputs``: captured and replayed on CUDA, run as they are
    on the CPU. ``run`` returns the steps' losses on the device."""

    def __init__(self, loop, params: Dict[str, torch.Tensor], opt_state,
                 inputs, k_max: int):
        device = inputs.device
        self.loop, self.params, self.opt_state = loop, params, opt_state
        self.inputs = inputs
        self.cuda = device.type == "cuda"
        n = n_scalars(loop.optimizer)
        self.scalars = (torch.zeros(k_max, n, device=device) if n
                        else None)
        self.losses = torch.zeros(k_max, device=device)
        self.noise: List[torch.Generator] = (
            [torch.Generator(device=device) for _ in range(k_max)]
            if self.cuda else [])
        self.graphs: Dict[int, Tuple[torch.cuda.CUDAGraph, Launches]] = {}
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def run(self, k: int, seed: int, iteration: int,
            scalars: Optional[torch.Tensor]) -> torch.Tensor:
        """Steps ``iteration .. iteration + k - 1`` on the batches filled
        into ``inputs``; ``scalars`` their ``(k, n)`` per-step values."""
        if self.scalars is not None:
            self.scalars[:k].copy_(scalars)
        if self.cuda:
            graph, launches = self._graph(k)
            # seeded after the capture (and its warm-up step's draws): a
            # replay draws from each generator's seed and offset as they
            # stand when it starts
            for j in range(k):
                self.noise[j].manual_seed(step_seed(seed, iteration + j))
            graph.replay()
            launches.replayed()
        else:
            self.noise = [torch.Generator().manual_seed(
                step_seed(seed, iteration + j)) for j in range(k)]
            self._steps(k)
        return self.losses[:k].clone()

    def _steps(self, k: int) -> None:
        for j in range(k):
            x, y = self.inputs.batch(j)
            loss = self.loop.train_step(
                x, y, self.noise[j], self.params, self.opt_state,
                None if self.scalars is None else self.scalars[j])
            self.losses[j].copy_(loss)

    def _graph(self, k: int):
        if k not in self.graphs:
            if not self.graphs:
                self._warm_up()
            graph = torch.cuda.CUDAGraph()
            for gen in self.noise[:k]:
                graph.register_generator_state(gen)
            pool = (next(iter(self.graphs.values()))[0].pool()
                    if self.graphs else None)
            try:
                with record_launches() as launches:
                    with torch.cuda.graph(graph, pool=pool,
                                          stream=self.stream):
                        self._steps(k)
            except RuntimeError as e:
                raise RuntimeError(
                    f"the training step cannot be captured in a CUDA graph "
                    f"(zoo.train.scan_steps / zoo.train.device_cache): an "
                    f"op in it syncs with the host or is not capturable: "
                    f"{e}") from e
            self.graphs[k] = (graph, launches)
        return self.graphs[k]

    def _warm_up(self) -> None:
        """One step on the capture stream before the first capture, as
        PyTorch's whole-network capture asks (libraries, workspaces and
        lazy allocations set up outside the graph); its update of the
        parameters and the optimizer state is undone."""
        state = list(self.params.values()) + _leaves(self.opt_state)
        with torch.no_grad():
            saved = [t.detach().clone() for t in state]
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            self._steps(1)
            with torch.no_grad():
                for t, s in zip(state, saved):
                    t.copy_(s)
        torch.cuda.current_stream().wait_stream(self.stream)
