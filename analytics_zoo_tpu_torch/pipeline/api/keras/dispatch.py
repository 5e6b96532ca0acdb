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
  (``common/noise.py``); under ``zoo.train.remat`` a twin of each,
  registered and seeded alike, from which the backward's recompute draws
  the forward's noise again.

A shorter last chunk gets a graph of its own, in the same memory pool.
The first capture follows a warm-up step on the capture stream, whose
effect on the parameters and the optimizer state is undone; garbage is
collected before each capture and not during it. An op that
cannot be captured (a host sync, a copy from pageable memory) makes the
fit raise: there is no eager fallback. The kernel wrappers' launch
counters are kept true under replay (``ops/launch_count.py``), and each
capture counts as a compile (``observability/compile.py``; a capture for
a new K of a program that captured before, as a retrace).

With the anomaly sentinel or gradient clipping active (the loop's
:class:`Guard`), each step is the guarded step
(``TrainingLoop.guarded_step``) and the program holds its inputs and
outputs in static buffers too: a ``(K, 2)`` fault input the host fills
before each replay (``train.grads``), the ``(K,)`` flag words, and a
``(K, n)`` table of per-step values gathered on the device, before the
replay, from the block's table at the device count's offset — after a
discarded step the optimizer count does not advance, so the steps
behind it read the rows of the counts they really have.

On the CPU the same program runs its steps as they are, with a loop in
place of the replay: the same buffers, gathers and per-step values,
which is what the CPU tests hold against the JAX loop.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ....common import anomaly
from ....common.noise import step_seed, twins
from ....observability.compile import CompileTracker
from ....ops.guard import guard_commit
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


def _on(a, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``: a tensor already there is used as it is."""
    return (a if isinstance(a, torch.Tensor) else _tensor(a)).to(device)


class DeviceData:
    """A FeatureSet's arrays on the device, uploaded once (arrays that are
    tensors on the device already stay where they are), and the ``(K,
    batch)`` row indices of the steps of one dispatch; each step gathers
    its batch on the device."""

    def __init__(self, xs: List[np.ndarray], y: np.ndarray, k: int,
                 batch_size: int, device: torch.device):
        self.device = device
        self.xs = [_on(a, device) for a in xs]
        self.y = _on(y, device)
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


@contextlib.contextmanager
def _no_collection():
    """Garbage collected before a capture and not inside it: a
    collection inside may free a dead cycle that holds CUDA resources
    (pinned host memory, whose release queries events; events; graphs),
    and that CUDA call invalidates the capture (``torch.cuda.graph`` no
    longer collects first). The remat'd captured step, whose checkpoint
    bookkeeping makes many Python objects, lost its capture that way on
    the card after other fits had left such cycles behind."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _leaves(tree) -> List[torch.Tensor]:
    """Every tensor of an optimizer state (dicts and lists of tensors)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _leaves(sub)]
    return []


class Guard:
    """The device state of a training loop's guarded step
    (``anomaly.SentinelConfig.active``): the spike check's EWMA state
    (two f32 scalars, fresh each fit attempt), the optimizer count (an
    int64 scalar, set by the host at each block start and advanced by
    each applied update), ``base``, the count of row 0 of the per-step
    table the eager steps read, and — in ``recover`` mode — the pre-step
    copies of the parameters and the optimizer state that a discarded
    update is undone from. The tensors are made once a loop and updated
    in place, so a captured graph keeps reading them."""

    def __init__(self, cfg: anomaly.SentinelConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.ewma, self.obs = anomaly.init_state(device)
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.base = torch.zeros((), dtype=torch.int64, device=device)
        self.prev: Optional[List[torch.Tensor]] = None
        # G1's device tables (keep, commit), made once a set of tensors
        self.tables: List = [None, None]
        self._tickets: Optional[torch.Tensor] = None

    def tensors(self) -> List[torch.Tensor]:
        return [self.ewma, self.obs, self.count, self.base]

    def reset(self) -> None:
        """A fit attempt's fresh EWMA state."""
        self.ewma.zero_()
        self.obs.zero_()

    def start_block(self, count: int) -> None:
        """The host's exact count at a block's start (no host wait)."""
        self.count.fill_(count)
        self.base.fill_(count)

    def tickets(self, n: int) -> Optional[torch.Tensor]:
        """G2's tickets for ``n`` gradients on the card (None on the
        CPU): ``n + 1`` int32 zeros, made once a loop, which each launch
        leaves at zero."""
        if self.device.type != "cuda":
            return None
        if self._tickets is None or self._tickets.numel() < n + 1:
            self._tickets = torch.zeros(n + 1, dtype=torch.int32,
                                        device=self.device)
        return self._tickets

    def keep(self, state: List[torch.Tensor], bad: torch.Tensor) -> None:
        """The pre-step copies of ``state`` (the step's parameters,
        optimizer state and written model state), taken after the check
        and before the update. On the CPU they are copied now (one
        multi-tensor copy); on the card G1 copies them where ``bad``, so
        a good step copies nothing (its table made once a set of
        tensors)."""
        if (self.prev is None or len(self.prev) != len(state)
                or any(p.shape != t.shape or p.dtype != t.dtype
                       or p.stride() != t.stride()
                       for p, t in zip(self.prev, state))):
            with torch.no_grad():
                self.prev = [torch.empty_like(t) for t in state]
            self.tables = [None, None]
        if not state or not state[0].is_cuda:
            torch._foreach_copy_(self.prev, state)
            return
        self.tables[0] = guard_commit(self.prev, state, bad, self.tables[0])

    def commit(self, state: List[torch.Tensor], bad: torch.Tensor) -> None:
        """Where ``bad``, the pre-step values back; else the update's, bit
        for bit (a select, no arithmetic): G1, one launch for every tensor
        on the card."""
        self.tables[1] = guard_commit(state, self.prev, bad, self.tables[1])


class StepProgram:
    """Up to ``k_max`` optimizer steps of a training loop over the static
    buffers of ``inputs``: captured and replayed on CUDA, run as they are
    on the CPU. ``run`` returns the steps' losses on the device."""

    def __init__(self, loop, params: Dict[str, torch.Tensor], opt_state,
                 inputs, k_max: int, guard: Optional[Guard] = None,
                 name: str = "train.scan_chunk"):
        device = inputs.device
        self.loop, self.params, self.opt_state = loop, params, opt_state
        self.inputs = inputs
        self.guard = guard
        self.cuda = device.type == "cuda"
        n = n_scalars(loop.optimizer)
        self.scalars = (torch.zeros(k_max, n, device=device) if n
                        else None)
        self.losses = torch.zeros(k_max, device=device)
        self.flags = self.fault = None
        if guard is not None:
            self.flags = torch.zeros(k_max, dtype=torch.int32, device=device)
            self.base = torch.zeros((), dtype=torch.int64, device=device)
            self.steps = torch.arange(k_max, device=device)
            if guard.cfg.faults:
                self.fault = torch.zeros(k_max, 2, device=device)
        self.noise: List[torch.Generator] = (
            [torch.Generator(device=device) for _ in range(k_max)]
            if self.cuda else [])
        self.twins: List[torch.Generator] = (
            [torch.Generator(device=device) for _ in self.noise]
            if loop._resolve_remat() is not None else [])
        self.graphs: Dict[int, Tuple[torch.cuda.CUDAGraph, Launches]] = {}
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.compiles = CompileTracker(name, loop._registry)

    def run(self, k: int, seed: int, iteration: int,
            scalars: Optional[torch.Tensor],
            fault: Optional[np.ndarray] = None):
        """Steps ``iteration .. iteration + k - 1`` on the batches filled
        into ``inputs``; returns their losses (and, guarded, their flag
        words: the program's buffer, which the next run overwrites) on the
        device. ``scalars`` are the steps' ``(k, n)``
        per-step values; guarded, the block's table, whose row 0 is the
        guard's ``base`` count; ``fault`` the steps' ``(k, 2)``
        ``train.grads`` inputs."""
        guard = self.guard
        if guard is None:
            if self.scalars is not None:
                self.scalars[:k].copy_(scalars)
        else:
            if self.scalars is not None:
                rows = (guard.count - guard.base) + self.steps[:k]
                self.scalars[:k].copy_(scalars.index_select(0, rows))
            if self.fault is not None:
                _copy_in(self.fault[:k], fault)
        if self.cuda:
            self.replay(k, [step_seed(seed, iteration + j) for j in range(k)])
        else:
            self._start_block()
            self.noise = [torch.Generator().manual_seed(
                step_seed(seed, iteration + j)) for j in range(k)]
            self._steps(k)
        if guard is None:
            return self.losses[:k].clone()
        return self.losses[:k].clone(), self.flags[:k]

    def replay(self, k: int, seeds: Sequence[int]) -> None:
        """Replays the ``k``-step graph, captured at its first call, on
        what ``inputs`` and the step tables hold: guarded, the block's
        start count is the guard's count; each step's generator (and its
        twin) is seeded from ``seeds``."""
        self._start_block()
        graph, launches = self._graph(k)
        # seeded after the capture (and its warm-up step's draws): a
        # replay draws from each generator's seed and offset as they
        # stand when it starts
        for j, s in enumerate(seeds):
            self.noise[j].manual_seed(s)
            if self.twins:
                self.twins[j].manual_seed(s)
        graph.replay()
        launches.replayed()

    def _start_block(self) -> None:
        # guarded, the block's start count: the guard's count before it
        if self.guard is not None:
            self.base.copy_(self.guard.count)

    def _steps(self, k: int) -> None:
        for j in range(k):
            x, y = self.inputs.batch(j)
            if self.guard is None:
                loss = self.loop.train_step(
                    x, y, self.noise[j], self.params, self.opt_state,
                    None if self.scalars is None else self.scalars[j])
            else:
                loss, _ = self.loop.guarded_step(
                    x, y, self.noise[j], self.params, self.opt_state,
                    self.scalars, self.base,
                    None if self.fault is None else self.fault[j],
                    flags_out=self.flags[j])
            self.losses[j].copy_(loss)

    def _graph(self, k: int):
        if k not in self.graphs:
            # the capture is this path's compile (goodput: "compile")
            self.loop._gp_note("device_step")
            t0 = time.perf_counter()
            if not self.graphs:
                self._warm_up()
            graph = torch.cuda.CUDAGraph()
            for gen in self.noise[:k] + self.twins[:k]:
                graph.register_generator_state(gen)
            pool = (next(iter(self.graphs.values()))[0].pool()
                    if self.graphs else None)
            try:
                with record_launches() as launches, _no_collection():
                    with torch.cuda.graph(graph, pool=pool,
                                          stream=self.stream), \
                            twins(zip(self.noise, self.twins)):
                        self._steps(k)
            except RuntimeError as e:
                raise RuntimeError(
                    f"the training step cannot be captured in a CUDA graph "
                    f"(zoo.train.scan_steps / zoo.train.device_cache): an "
                    f"op in it syncs with the host or is not capturable: "
                    f"{e}") from e
            self.graphs[k] = (graph, launches)
            self.compiles.record(k, time.perf_counter() - t0)
            self.loop._gp_note("compile")
        return self.graphs[k]

    def _warm_up(self) -> None:
        """One step on the capture stream before the first capture, as
        PyTorch's whole-network capture asks (libraries, workspaces, cuDNN's
        algorithm choice and lazy allocations set up outside the graph);
        its update of the parameters, the optimizer state and the model
        state the step writes is undone."""
        state = (list(self.params.values()) + _leaves(self.opt_state)
                 + self.loop._written_state())
        if self.guard is not None:
            state += self.guard.tensors()
        with torch.no_grad():
            saved = [t.detach().clone() for t in state]
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            self._steps(1)
            with torch.no_grad():
                for t, s in zip(state, saved):
                    t.copy_(s)
        torch.cuda.current_stream().wait_stream(self.stream)
