"""TrainingLoop — port of ``analytics_zoo_tpu/pipeline/api/keras/
training.py``: ``fit`` → ``fit_feature_set`` (retry, rollback, SIGTERM,
goodput) → the epoch loop, the plain step of ``_make_step_core``
(forward, loss, backward, optimizer update) and its guarded form,
``evaluate`` with masked padded tails, and ``predict``.

What the JAX loop does and this one keeps:

* batch order: ``FeatureSet(seed=zoo.seed)`` walked with ``epoch =
  zoo.seed + epoch`` (epochs count from ``finished_epochs + 1``), drop-last;
* ``nb_epoch`` is additive over fit calls (the target fixed once, after a
  resume); the epoch loss is the mean of the step losses;
  ``history["loss"]`` holds one value per epoch and every callback gets
  ``{"epoch", "loss", "iteration", "throughput"}``; ``end_trigger``
  (``common/triggers.py``) stops the fit early;
* the dispatch paths (``dispatch.py``): one step at a time by default;
  ``zoo.train.scan_steps = K`` steps a dispatch over chunks of K
  FeatureSet batches; ``zoo.train.device_cache`` the dataset resident on
  the device, each epoch's order a permutation drawn there (seeded from
  ``fs.seed + zoo.seed + epoch``), drop-last, batches gathered on the
  device, triggers observed at epoch boundaries; with it,
  ``zoo.train.fuse_epochs = g`` runs g epochs a block when nothing needs
  the host between epochs (no checkpoint manager, validation or end
  trigger), with one read of the device a block. On CUDA a multi-step
  dispatch is the replay of a captured CUDA graph;
* no host sync inside an epoch (or a fused block): the eager loop,
  ``evaluate`` and ``predict`` stream their batches through
  ``prefetch_to_device`` (assembled and pinned on a thread, copied ahead
  on a copy stream of their own, as the JAX loop streams them); the
  multi-step path assembles its chunks on a thread and copies each into
  the captured program's buffers on the compute stream; step losses stay
  on the device and are read once at the epoch's (the block's) end (flag
  words are copied to the host as they come and read four dispatches
  late);
* a sliced ``DiskFeatureSet``: one loop epoch is one slice pass;
  ``nb_epoch``, ``EveryEpoch`` and ``MaxEpoch`` count full passes of its
  ``num_of_slice`` slices, and ``device_cache`` declines it;
* the optimizer's count and per-step values: the count is kept beside
  the optimizer state (``model.opt_state``) and continues over fits; the
  host computes each step's scalars and every path's update reads them
  from a device row (``optimizers.step_scalars``);
* **anomaly sentinels and gradient clipping** (``common/anomaly.py``;
  ``zoo.train.sentinel``, ``zoo.train.grad_clip``), decided once a loop:
  off and unclipped, the step is the plain one, with no added op; active,
  :meth:`TrainingLoop.guarded_step` computes the global gradient norm,
  the packed flag word and the clip on the device, and in ``recover``
  mode discards an anomalous step's update of the parameters and the
  optimizer state on the device (a select against pre-step copies, so
  a healthy step keeps the update's bits) without advancing the count,
  which then lives on the device (:class:`dispatch.Guard`). The host reads
  each dispatch's flags four dispatches late, as the JAX loop does, and
  keeps the books (:class:`_SentinelMonitor`: counters, ``train.anomaly``
  events, the skip budget); past
  ``zoo.train.max_skips_per_epoch`` it rolls back to the last good
  snapshot and replays with the flagged window skipped, at most
  ``zoo.train.max_rollbacks`` times a fit (``TrainingDiverged`` after);
  an active sentinel turns ``device_cache`` off;
* **checkpoints** (``utils/checkpoint.py``, the JAX on-disk format) on
  the ``set_checkpoint`` trigger (``EveryEpoch`` by default), written
  off the step path; ``fit`` resumes from the newest snapshot that
  verifies; a failed step retries from it, at most
  ``zoo.failure.retry_times`` times in ``zoo.failure.retry_window_sec``;
  with ``zoo.checkpoint.on_sigterm`` a SIGTERM cuts a final synchronous
  snapshot at the next step boundary and raises ``TrainingPreempted``
  (``zoo.checkpoint.sigterm_grace_s``: a mid-epoch snapshot at once when
  the next boundary is further off than the budget);
* the ``zoo_train_*`` step-time, throughput, step, example, anomaly,
  skip, rollback and clip metrics in the process registry, and the fit's
  goodput ledger (``zoo.goodput.enabled``).

Training noise: each step draws from a generator seeded from
``(zoo.seed, iteration)``, the counterpart of ``fold_in(base_rng,
iteration)``: on the CPU a CPU generator the layers split, on CUDA a
device generator every noise site draws from (``common/noise.py``).

The step's forward and loss come from :meth:`TrainingLoop.
_loss_application`, resolved once per loop as in the JAX package: a
big-vocab Dense head with a sparse-CE loss streams through the fused
LM-head cross-entropy (``keras/fused_loss.py``, ``zoo.train.fused_ce``)
and the ``zoo_train_fused_ce`` gauge says so; everything else runs the
plain forward and objective, which ``evaluate`` and ``predict`` always
use (the full-logits oracle). The sharded-embedding resolution
(``keras/sharded_embed.py``, ``zoo.embed.sharded``) runs there once per
loop too; it engages only on a mesh whose ``model`` axis is larger than
1. Integer inputs (ids) stay integer from the ``FeatureSet`` to the
model.

``zoo.train.remat`` (opt-in, resolved once per loop like the fused loss
and the sentinel) wraps the step's forward and loss in
``torch.utils.checkpoint`` (:func:`remat`): ``true``/``dots`` keeps the
outputs of the dense products with no batch dims (``aten.mm``/``addmm``,
JAX's ``dots_with_no_batch_dims_saveable``, by selective checkpointing),
``full`` keeps nothing; every other tensor, the hand-written kernels'
autograd functions included, is recomputed in the backward, whose noise
is the forward's again (``common/noise.py``). It sits in
:meth:`TrainingLoop._grads`, so the eager, guarded and captured steps all
run it.

On a device mesh (``parallel/mesh.py``; more than one rank of
``torch.distributed``) the loop runs the JAX loop's data, tensor, expert,
pipeline and sequence parallelism and ZeRO-1 as explicit collectives
(``mesh_step.py``); snapshots record the live ``mesh_metadata``, and a
snapshot of another mesh restores re-placed under the live one (the
elastic re-mesh restore, reported as ``ckpt.elastic_restore``).

Not ported yet: the TensorBoard sink.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import logging
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ....common import anomaly, faults, noise
from ....common.context import (FALSE_FLAG_SPELLINGS, TRUE_FLAG_SPELLINGS,
                                get_zoo_context, train_dispatch)
from ....common.noise import step_seed
from ....common.reliability import RetryBudget
from ....common.triggers import (EveryEpoch, MaxEpoch, SeveralIteration,
                                 TrainLoopState, Trigger)
from ....feature.feature_set import (FeatureSet, _ThreadedIterator, chunked,
                                     prefetch_to_device)
from ....observability import default_registry, span
from ....ops.guard import guard_check
from ....parallel.collectives import all_gather, all_reduce
from ....parallel.mesh import format_mesh, global_mesh, mesh_metadata
from ....utils.checkpoint import (CheckpointArchitectureError,
                                  CheckpointManager)
from . import dispatch, objectives
from .engine import (collect_aux_losses, collect_state, commit_state,
                     discard_state, load_param_tree, named_state,
                     written_state)
from .mesh_step import MeshStep, _full_shape
from .metrics import Metric
from .optimizers import (GradientTransformation, apply_updates,
                         load_optax_leaves, optax_leaves, scalar_rows)

log = logging.getLogger("analytics_zoo_tpu_torch")

#: the manifest meta of a snapshot whose optimizer state has no optax
#: layout (a transform without slots): its leaves are the port's own order
OPT_STATE_ORDER = ("opt_state_order", "analytics_zoo_tpu_torch")


class TrainingPreempted(SystemExit):
    """Raised out of ``fit`` after a SIGTERM-requested final checkpoint
    (``zoo.checkpoint.on_sigterm``): the snapshot is on disk, in-memory
    model state is published, and the process should now exit — a
    ``SystemExit`` subclass so it escapes the step-failure retry loop and
    terminates cleanly."""


class TrainingDiverged(RuntimeError):
    """The anomaly sentinels (``zoo.train.sentinel=recover``) could not
    contain a divergence: either skip-then-rollback recovery exhausted
    its ``zoo.train.max_rollbacks`` budget, or escalation was required
    with no checkpoint to roll back to. Raised INSTEAD of looping
    forever or silently training on garbage — the params published on
    the model are the last known-good (restored) state."""


class _RollbackRequested(RuntimeError):
    """Internal escalation signal: more than
    ``zoo.train.max_skips_per_epoch`` updates were discarded in one
    epoch — reload the last good checkpoint and replay with the
    offending data window skipped. Handled by ``_fit_with_retry``
    under the rollback :class:`RetryBudget`; never escapes ``fit``."""

    def __init__(self, skips: int, epoch: int):
        super().__init__(
            f"{skips} anomalous step(s) skipped in epoch {epoch} "
            f"(zoo.train.max_skips_per_epoch exceeded)")
        self.skips = skips
        self.epoch = epoch


#: the "no fault" train.grads input, shared by every healthy dispatch
_NO_FAULT = np.zeros(2, np.float32)


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _num_examples(x) -> int:
    return _as_list(x)[0].shape[0]


def _to_device(x, device: torch.device):
    """numpy batch (array or list) → tensors on ``device``. CUDA copies go
    through pinned memory and do not block the host; the caching host
    allocator keeps each pinned buffer until its copy has run."""
    def one(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    xs = [one(a) for a in _as_list(x)]
    return xs if isinstance(x, (list, tuple)) else xs[0]


def _host_arrays(x, y):
    """``(x, y)`` of a FeatureSet (its host view: tensors read back once),
    or the arrays as given."""
    if isinstance(x, FeatureSet):
        if getattr(x, "ragged", False):
            raise ValueError("a ragged (bucketed) FeatureSet has no single "
                             "dense array: evaluate or predict each bucket")
        xs, y = x._host_view()
        return (xs if len(xs) > 1 else xs[0]), y
    return x, y


def _pad_to(x, size: int):
    """Pad the batch dim to ``size`` by repeating the last row."""
    out = []
    for a in _as_list(x):
        pad = size - a.shape[0]
        if pad > 0:
            a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)
        out.append(a)
    return out if isinstance(x, (list, tuple)) else out[0]


def _padded_batches(x, y, batch_size: int):
    """Fixed-size batches in order, the tail padded by repeating its last
    row, each with a ``(batch_size,)`` validity mask — so the device sees
    one batch shape and padded rows never enter a statistic."""
    n = _num_examples(x)
    for i in range(0, n, batch_size):
        idx = np.arange(i, min(i + batch_size, n))
        bx = [np.asarray(a)[idx] for a in _as_list(x)]
        bx = bx if isinstance(x, (list, tuple)) else bx[0]
        by = None if y is None else np.asarray(y)[idx]
        real = len(idx)
        if real < batch_size:
            bx = _pad_to(bx, batch_size)
            by = None if by is None else _pad_to(by, batch_size)
        mask = np.zeros(batch_size, np.float32)
        mask[:real] = 1.0
        yield bx, by, mask, real


#: the products ``dots`` keeps: dense matmuls with no batch dims (a
#: ``Dense`` on any rank folds to one); ``bmm`` and everything else is
#: recomputed, as under JAX's ``dots_with_no_batch_dims_saveable``
_DOTS = frozenset([torch.ops.aten.mm.default, torch.ops.aten.addmm.default])


def _keep_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_mode(value: Any = None) -> Optional[str]:
    """``zoo.train.remat`` (default: the context's) as ``None`` (off),
    ``"dots"`` or ``"full"``, with the JAX package's spellings; anything
    else raises its ``ValueError``."""
    mode = (get_zoo_context().get("zoo.train.remat", False)
            if value is None else value)
    if isinstance(mode, str):
        low = mode.strip().lower()
        if low in FALSE_FLAG_SPELLINGS or low == "none":
            return None
        if low in TRUE_FLAG_SPELLINGS or low in (
                "dots", "dots_with_no_batch_dims_saveable"):
            return "dots"
        if low in ("full", "all", "nothing_saveable"):
            return "full"
        raise ValueError(f"zoo.train.remat must be "
                         f"false|true|dots|full, got {mode!r}")
    return "dots" if mode else None


def remat(fn: Callable, mode: str) -> Callable:
    """``fn(x, y, generator) -> loss`` rematerialised: the backward runs
    ``fn`` again for what ``mode`` does not keep (:func:`remat_mode`),
    drawing the forward's noise from ``generator`` again
    (``noise.stash``/``noise.redraw``). The default generators' states are
    not stashed (``preserve_rng_state=False``): every noise site of a step
    draws from the step's own generator, and a CUDA generator's state
    cannot be read while a step is being captured."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts,
                                        noop_context_fn)
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    _keep_dots)
                  if mode == "dots" else noop_context_fn)

    def run(x, y, generator):
        stashed = noise.stash(generator)
        forward = True

        def body(x, y):
            nonlocal forward
            if forward:
                forward = False
                return fn(x, y, generator)
            # the recompute: the forward's noise again, its new state
            # dropped (the first run handed it to the step)
            with noise.redraw(generator, stashed), discard_state():
                return fn(x, y, generator)

        return checkpoint(body, x, y, use_reentrant=False,
                          preserve_rng_state=False, context_fn=context_fn)
    return run


def step_generator(seed: int, iteration: int) -> torch.Generator:
    """The CPU generator of one training step's noise."""
    return torch.Generator().manual_seed(step_seed(seed, iteration))


class _FullPassEveryEpoch(Trigger):
    """``EveryEpoch`` over a sliced dataset: fires only when the finished
    slice pass completes a full pass over all slices
    (``ZooTrigger.scala:53-58``: ``currentSlice % numSlice == 0``)."""

    def __init__(self, num_slices: int):
        self.num_slices = int(num_slices)

    def __call__(self, state: TrainLoopState) -> bool:
        return state.epoch_finished and state.epoch % self.num_slices == 0


def _fired_within(trigger: Optional[Trigger], state: TrainLoopState,
                  prev_iter: int) -> bool:
    """Whether a trigger fired at any step in ``(prev_iter,
    state.iteration]``: multi-step dispatches are observed at their
    boundaries, so an interval trigger is checked over the whole window
    (acted on at the boundary, up to the window's length late)."""
    if trigger is None:
        return False
    if isinstance(trigger, SeveralIteration):
        return (state.iteration // trigger.interval
                > prev_iter // trigger.interval)
    return trigger(state)


def _param_tree(named: Dict[str, Any]) -> Dict[str, Any]:
    """``{"a.b": x}`` → ``{"a": {"b": x}}``: the JAX param tree's
    nesting, whose sorted flatten order a snapshot's leaves follow."""
    tree: Dict[str, Any] = {}
    for name, value in named.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def tree_module(model) -> torch.nn.Module:
    """The module whose parameter paths spell the JAX param tree: a
    ZooModel's inner network (the JAX model's tree is its network's), else
    the model itself."""
    inner = getattr(model, "model", None)
    if hasattr(model, "build_model") and isinstance(inner, torch.nn.Module):
        return inner
    return model


def _shape_of(t: torch.Tensor) -> np.ndarray:
    """A zero-byte host stand-in of ``t``'s shape (a restore template)."""
    return np.broadcast_to(np.zeros((), np.float32), tuple(t.shape))


def _map_leaves(tree, fn):
    """``tree`` (dicts and lists of tensors) with ``fn`` applied to every
    tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return tree


def _clone_tree(tree):
    """Device copies of every tensor of a state (dicts and lists)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree


class _SentinelMonitor:
    """Host-side bookkeeping for the packed per-step sentinel flags
    (``common/anomaly.py``; one int32 per step), the JAX loop's monitor:
    counters, ``train.anomaly`` events, the per-epoch skip budget and the
    rollback replay set.

    Flag reads trail the dispatch stream by ``LAG`` dispatches, as in the
    JAX loop, so observing them never waits on the step in flight: after
    each dispatch its flag words are copied, without a host wait, into the
    next of a ring of ``LAG + 1`` host buffers (pinned, with a CUDA event
    each, on a CUDA device; a captured program's words live in its static
    buffer, so the copy is queued after its replay and before the next).
    Once more than ``LAG`` dispatches are pending the oldest is read (its
    event waited for); the rest are read at the epoch's end. The budget
    check and the escalation therefore happen at the JAX loop's
    iteration, and a ``train.grads`` fault plan sees the same site
    calls."""

    #: dispatches a flag word may trail the stream before being read
    LAG = 4

    def __init__(self, loop: "TrainingLoop", cfg: anomaly.SentinelConfig):
        self.loop = loop
        self.cfg = cfg
        self.pending: collections.deque = collections.deque()
        self.epoch = 0
        self.epoch_start = 0                # iteration at epoch start
        self.epoch_skips = 0
        self.epoch_flags: List[int] = []    # one per recorded loss
        self.epoch_step_iters: List[int] = []   # global iter per loss
        self._ring: List[Optional[torch.Tensor]] = [None] * (self.LAG + 1)
        self._events: List[Optional[torch.cuda.Event]] = \
            [None] * (self.LAG + 1)
        self._slot = 0

    def begin_epoch(self, epoch: int, start_iter: int) -> None:
        self.drain()                        # belongs to the PREVIOUS epoch
        self.epoch = epoch
        self.epoch_start = start_iter
        self.epoch_skips = 0
        self.epoch_flags = []
        self.epoch_step_iters = []

    def step_key(self, it: int):
        """Replay-stable identity of a dispatched step: (epoch, ordinal
        within the epoch) — the batch order per epoch is deterministic,
        global iterations shift after a mid-epoch restore."""
        return (self.epoch, it - self.epoch_start)

    def push(self, first_iter: int, flags: torch.Tensor) -> None:
        """Queue one dispatch's flag words (``k`` int32 on the device);
        reads the oldest pending dispatch once more than ``LAG`` are
        pending, which may raise :class:`_RollbackRequested`."""
        k = int(flags.numel())
        self.epoch_step_iters.extend(range(first_iter, first_iter + k))
        self.pending.append((first_iter, *self._stage(flags.view(-1))))
        if len(self.pending) > self.LAG:
            self._drain_one()

    def _stage(self, flags: torch.Tensor):
        """Copies ``flags`` into the ring's next host buffer without a host
        wait; returns the buffer's view and its event (None on the CPU).
        The slot reused was pushed ``LAG + 1`` dispatches ago and has been
        read."""
        slot = self._slot
        self._slot = (slot + 1) % len(self._ring)
        k = flags.numel()
        buf = self._ring[slot]
        if buf is None or buf.numel() < k:
            buf = self._ring[slot] = torch.empty(
                k, dtype=flags.dtype, pin_memory=flags.is_cuda)
        view = buf[:k]
        view.copy_(flags, non_blocking=flags.is_cuda)
        if not flags.is_cuda:
            return view, None
        event = self._events[slot]
        if event is None:
            event = self._events[slot] = torch.cuda.Event()
        event.record()
        return view, event

    def note_replay_skip(self, k: int) -> None:
        """``k`` steps of a rollback replay were not re-dispatched (the
        offending data window) — counted as skipped, no loss recorded."""
        self.loop._m_skipped.inc(k)

    def drain(self) -> None:
        """Reads every pending dispatch (may raise
        :class:`_RollbackRequested`)."""
        while self.pending:
            self._drain_one()

    def _drain_one(self) -> None:
        first_iter, view, event = self.pending.popleft()
        if event is not None:
            event.synchronize()
        self._observe(first_iter, view.numpy())

    def _observe(self, first_iter: int, words) -> None:
        loop = self.loop
        for j, word in enumerate(words):
            f = int(word)
            self.epoch_flags.append(f)
            if f & anomaly.GRAD_CLIPPED:
                loop._m_clip.inc()
            kinds = anomaly.kinds_of(f)
            if not kinds:
                continue
            it = first_iter + j
            for kind in kinds:
                loop._m_anomaly[kind].inc()
            loop._registry.emit(
                "train.anomaly", iteration=it, epoch=self.epoch,
                kinds=",".join(kinds), mode=self.cfg.mode,
                action="skip" if self.cfg.mode == "recover" else "warn")
            if self.cfg.mode == "recover":
                loop._m_skipped.inc()
                loop._anomalous_steps.add(self.step_key(it))
                self.epoch_skips += 1
                log.warning(
                    "anomalous step at iteration %d (%s): update "
                    "discarded (%d/%d skips this epoch)", it,
                    ",".join(kinds), self.epoch_skips,
                    self.cfg.max_skips_per_epoch)
            else:
                log.warning(
                    "anomalous step at iteration %d (%s) — "
                    "zoo.train.sentinel=warn: update APPLIED", it,
                    ",".join(kinds))
        if (self.cfg.mode == "recover"
                and self.epoch_skips > self.cfg.max_skips_per_epoch):
            raise _RollbackRequested(self.epoch_skips, self.epoch)

    def loss_mask(self, n: int) -> np.ndarray:
        """Valid-loss mask over this epoch's ``n`` recorded losses: in
        recover mode an anomalous step's loss was never applied and is
        left out of the epoch mean."""
        mask = np.ones(n, bool)
        if self.cfg.mode == "recover":
            for i, f in enumerate(self.epoch_flags[:n]):
                if f & anomaly.ANOMALY_MASK:
                    mask[i] = False
        return mask


class TrainingLoop:
    """Owns the step of one (model, optimizer, loss, metrics) triple."""

    #: the labels of the most recent fused-CE gauge write in this process —
    #: a later non-fused (or differently-headed) loop zeroes the stale
    #: series so the scrape never claims fusion is active when it is not
    _last_fused_labels = None
    _FUSED_GAUGE_HELP = ("1 while the fused blockwise LM-head cross-entropy "
                         "is active for the current training loop")

    def __init__(self, model, optimizer: GradientTransformation,
                 loss: Callable, metrics: Sequence[Metric] = ()):
        self.model = model
        self.optimizer = optimizer
        self.loss = loss
        self.metrics = list(metrics)
        self._apply_loss = None
        #: the resolved ``zoo.train.remat`` (``None``, ``"dots"``,
        #: ``"full"``; :meth:`_resolve_remat`), once ``_remat_resolved``
        self.remat_mode: Optional[str] = None
        self._remat_resolved = False
        self._registry = default_registry()
        self._m_step_time = self._registry.histogram(
            "zoo_train_step_seconds",
            "optimizer-step wall time (amortized over the epoch)")
        self._m_throughput = self._registry.gauge(
            "zoo_train_records_per_sec", "training examples/sec, last epoch")
        self._m_steps = self._registry.counter(
            "zoo_train_steps_total", "optimizer steps run")
        self._m_examples = self._registry.counter(
            "zoo_train_examples_total", "training examples consumed")
        #: the step losses of the latest fit, one array an epoch
        self.step_losses: List[np.ndarray] = []
        self._noise_gen: Optional[torch.Generator] = None
        self._data = None      # (key, fs, dispatch.DeviceData): the latest set
        self._program = None   # (key, dispatch.StepProgram)
        #: the loop's mesh (``mesh_step.MeshStep``) when the global mesh
        #: has more than one rank
        self._mesh: Optional[MeshStep] = None
        #: compile(clip_norm=...): a global-norm clip inside the optimizer
        self.global_clip = False
        # durable checkpointing: the manager of the fit attempt in flight
        # (its async writer is joined by _close_active_ckpt_mgr), the
        # published state a retry falls back to, and the SIGTERM latch
        self._active_ckpt_mgr: Optional[CheckpointManager] = None
        self._published = None     # (tensor copies, count)
        self._preempted = threading.Event()
        # SIGTERM grace budget (zoo.checkpoint.sigterm_grace_s): the
        # in-flight dispatch segment's start stamp + EWMA duration
        # estimate, and — only when the estimate already exceeds the
        # budget — a copy of the last boundary state the handler cuts a
        # mid-epoch snapshot from
        self._sigterm_grace: Optional[float] = None
        self._segment_t0: Optional[float] = None
        self._segment_est: Optional[float] = None
        self._segment_count = 0     # loop-lifetime; first sample discarded
        self._boundary_ref = None
        # anomaly sentinels: resolved once per loop; the guarded step's
        # device state made once per loop; the per-fit recovery state
        # (flagged steps, rollback budget) reset at each fit() entry
        self._sentinel: Optional[anomaly.SentinelConfig] = None
        self._guard: Optional[dispatch.Guard] = None
        # kind iterates anomaly.KIND_BITS — a 3-entry module constant
        self._m_anomaly = {
            kind: self._registry.counter(  # zoolint: disable=ZL015 bounded label set
                "zoo_train_anomaly_total",
                "anomalous training steps detected by the sentinels, by "
                "kind (zoo.train.sentinel)", labels={"kind": kind})
            for _bit, kind in anomaly.KIND_BITS}
        self._m_skipped = self._registry.counter(
            "zoo_train_skipped_steps_total",
            "optimizer steps whose update was discarded (sentinel skip) "
            "or not re-dispatched on rollback replay")
        self._m_rollback = self._registry.counter(
            "zoo_train_rollback_total",
            "skip-budget escalations that reloaded the last good "
            "checkpoint and replayed past the offending window")
        self._m_clip = self._registry.counter(
            "zoo_train_grad_clip_engaged_total",
            "steps where zoo.train.grad_clip global-norm clipping "
            "actually rescaled the gradients")
        self._anomalous_steps: set = set()   # {(epoch, ordinal)} flagged
        self._rollback_budget: Optional[RetryBudget] = None
        self._rollback_pending = False
        # goodput/badput attribution: one ledger per fit
        self._goodput = None
        self._gp_restarting = False   # a retry attempt's resume pending

    # -- goodput attribution ------------------------------------------------
    def _gp_note(self, category: str) -> None:
        """Attribute wall clock since the ledger's mark to ``category``
        (no-op outside an accounted fit)."""
        if self._goodput is not None:
            self._goodput.note(category)

    # -- model plumbing -----------------------------------------------------
    def _ensure_weights(self) -> None:
        if not getattr(self.model, "built", True):
            self.model.init_weights()

    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _mesh_step(self) -> Optional[MeshStep]:
        """The loop's :class:`MeshStep` on the global mesh when that has
        more than one rank (placing the parameters on it at first use, and
        again when the global mesh changes), else None."""
        if not (dist.is_available() and dist.is_initialized()):
            return None
        mesh = global_mesh()
        if mesh.size == 1:
            return None
        if self._mesh is None or self._mesh.mesh is not mesh:
            self._ensure_weights()
            self._mesh = MeshStep(self, mesh)
            self._program = self._data = None
            self.model.opt_state = None
        return self._mesh

    def _params(self) -> Dict[str, torch.Tensor]:
        """The trained parameters under their JAX param-tree paths
        (dotted), so a name's first component is its layer's tree key, as
        ``multi_optimizer``'s routing reads it."""
        return {n: p for n, p in tree_module(self.model).named_parameters()
                if p.requires_grad}

    def _tree_params(self) -> Dict[str, torch.Tensor]:
        """Every parameter under its JAX param-tree path (dotted)."""
        return dict(tree_module(self.model).named_parameters())

    def _opt_state(self, params):
        """``{"count", "state"}``: the model's optimizer state and update
        count when this loop's optimizer made them (a later fit continues
        both), else fresh ones."""
        model = self.model
        if (model.opt_state is None
                or getattr(model, "_opt_state_owner", None)
                is not self.optimizer):
            views = (params if self._mesh is None
                     else self._mesh.zero_views(params))
            model.opt_state = {"count": 0,
                               "state": self.optimizer.init(views)}
            model._opt_state_owner = self.optimizer
        return model.opt_state

    # -- the step -------------------------------------------------------------
    def _fused_gauge(self, labels: Dict[str, str]):
        # head/vocab identify the fused head; bounded by the model
        # architectures built in-process
        return self._registry.gauge(  # zoolint: disable=ZL015 bounded label set
            "zoo_train_fused_ce", self._FUSED_GAUGE_HELP, labels=labels)

    def _loss_application(self):
        """``fn(x, y, generator) -> loss`` — the forward and loss of every
        step. Resolves the fused LM-head cross-entropy
        (``fused_loss.resolve_fused_loss``, ``zoo.train.fused_ce``) ONCE per
        loop: a big-vocab Dense head with a sparse-CE loss streams through
        ``ops/fused_cross_entropy`` so the ``(B·T, V)`` logits tensor is
        never formed; everything else runs the plain forward and
        objective."""
        if self._apply_loss is not None:
            return self._apply_loss
        from .fused_loss import resolve_fused_loss
        from .seq_pipe import (pipe_intercept, resolve_pipe_spec,
                               resolve_seq_attention, seq_attention_scope)
        from .sharded_embed import resolve_sharded_embeddings
        model, loss_fn = self.model, self.loss
        # plain embeddings onto the row-sharded lookup on a model axis
        resolve_sharded_embeddings(model)
        spec = resolve_fused_loss(model, loss_fn)
        prev = TrainingLoop._last_fused_labels
        if spec is None:
            if prev is not None:
                self._fused_gauge(prev).set(0)
                TrainingLoop._last_fused_labels = None

            def apply_loss(x, y, generator):
                return loss_fn(y, model(x, training=True,
                                        generator=generator))
        else:
            log.info("fused LM-head cross-entropy engaged: head=%s vocab=%d "
                     "(zoo.train.fused_ce; the (N, V) logits tensor is never "
                     "formed)%s", spec.head.name, spec.head.output_dim,
                     "; VOCAB-SHARDED over the model axis" if spec.sharded
                     else "")
            labels = {"head": spec.head.name,
                      "vocab": str(spec.head.output_dim),
                      "sharded": "1" if spec.sharded else "0"}
            if prev is not None and prev != labels:
                self._fused_gauge(prev).set(0)
            self._fused_gauge(labels).set(1)
            TrainingLoop._last_fused_labels = labels

            def apply_loss(x, y, generator):
                return spec.apply_and_loss(model, x, y, generator=generator)
        # sequence and pipeline parallelism (``seq_pipe.py``), resolved
        # once per loop as the fused loss is
        seq_mode, pipe = resolve_seq_attention(), resolve_pipe_spec(model)
        if seq_mode is not None or pipe is not None:
            plain = apply_loss

            def apply_loss(x, y, generator):
                with seq_attention_scope(seq_mode), \
                        pipe_intercept(pipe, True):
                    return plain(x, y, generator)
        self._apply_loss = apply_loss
        return apply_loss

    def _sentinel_config(self) -> anomaly.SentinelConfig:
        """Resolve the anomaly-sentinel/grad-clip knobs ONCE per loop:
        every step of a loop must agree, and with ``sentinel=off`` and no
        clipping the loop runs the plain step exactly — no sentinel op,
        the same bits."""
        if self._sentinel is None:
            self._sentinel = anomaly.resolve_config()
            cfg = self._sentinel
            if cfg.sentinel:
                log.info(
                    "anomaly sentinels armed (zoo.train.sentinel=%s): "
                    "nan-loss/nan-grad checks + grad-norm spike at %gx "
                    "EWMA%s%s", cfg.mode, cfg.spike_factor,
                    "; updates from anomalous steps are DISCARDED, "
                    "escalating to checkpoint rollback past "
                    f"{cfg.max_skips_per_epoch} skips/epoch"
                    if cfg.mode == "recover" else "",
                    "; train.grads fault injection in the step"
                    if cfg.faults else "")
        return self._sentinel

    def _resolve_remat(self) -> Optional[str]:
        """``zoo.train.remat`` resolved ONCE per loop (:func:`remat_mode`)
        into ``remat_mode``, which it returns."""
        if not self._remat_resolved:
            mode = self.remat_mode = remat_mode()
            self._remat_resolved = True
            if mode is not None:
                log.info("zoo.train.remat=%s: the backward recomputes the "
                         "step's forward%s", mode,
                         " but its dense products" if mode == "dots" else "")
        return self.remat_mode

    def _grads(self, x, y, generator, params):
        """Forward, loss and backward: ``(loss, {name: grad})``; the
        forward's new model state is dropped (:meth:`_step_grads` keeps
        it)."""
        return self._step_grads(x, y, generator, params)[:2]

    def _step_grads(self, x, y, generator, params):
        """Forward, loss and backward: ``(loss, {name: grad}, new
        state)``, the new state being what the forward handed over for the
        state the step writes (``engine.collect_state``; BatchNorm's
        moving statistics), for the step to commit after its update. Under
        ``zoo.train.remat`` the forward and loss run through :func:`remat`;
        off, the step is the historical one, op for op."""
        for p in params.values():
            p.grad = None
        apply_loss, mode = self._loss_application(), self._resolve_remat()
        if mode is not None:
            apply_loss = remat(apply_loss, mode)
        with collect_state() as new_state, collect_aux_losses() as aux:
            loss = apply_loss(x, y, generator)
        for a in aux:
            # layers' auxiliary losses (SparseMoE's load balance) are part
            # of the differentiated loss, as the JAX step adds them
            loss = loss + a
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        for p in params.values():
            p.grad = None
        loss = loss.detach()
        if self._mesh is not None:
            # the global batch's loss and gradients (averaged over data)
            loss = self._mesh.sync(loss, grads)
        return loss, grads, new_state

    def _update(self, grads, opt_state, params, row) -> None:
        """The optimizer update and its application (ZeRO-1's sliced form
        on a mesh that splits the moments)."""
        if self._mesh is not None:
            self._mesh.update(self.optimizer, grads, opt_state, params, row)
            return
        updates, _ = self.optimizer.update(grads, opt_state, params, row)
        apply_updates(params, updates)

    def train_step(self, x, y, generator: Optional[torch.Generator],
                   params: Dict[str, torch.Tensor], opt_state,
                   scalars: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Forward, loss, backward, optimizer update (the JAX plain step):
        the step every dispatch path runs with the sentinel off and no
        clipping. ``opt_state`` is the optimizer's state, ``scalars`` the
        step's row of its per-step values. The forward's new model state
        is committed after the update, once. Returns the loss as a device
        scalar; nothing syncs."""
        loss, grads, new_state = self._step_grads(x, y, generator,
                                                   params)
        self._update(grads, opt_state, params, scalars)
        commit_state(new_state)
        return loss

    def guarded_step(self, x, y, generator: Optional[torch.Generator],
                     params: Dict[str, torch.Tensor], opt_state,
                     table: Optional[torch.Tensor], base: torch.Tensor,
                     fault: Optional[torch.Tensor] = None,
                     flags_out: Optional[torch.Tensor] = None):
        """The JAX guarded step: :meth:`train_step` with, on the device,
        the ``train.grads`` poison (``fault``, ``[code, scale]``, when the
        loop's sentinel takes faults), the global gradient norm, the
        sentinel's flag word and EWMA update, the global-norm clip, and in
        ``recover`` mode the discard of an anomalous step's update and of
        its new model state (the JAX step keeps the pre-step ``net_state``).
        The step's per-step values are row ``count - base`` of ``table``
        (the guard's device count). On the card the flag word, EWMA, clip
        scale, row, count and pre-step copies (for a bad step only) are one
        kernel (G2, ``ops/guard.py``) and the discard another (G1). On a
        mesh the norm is the global gradient's (``MeshStep.global_norm``).
        Returns ``(loss, flags)``, device scalars (``flags`` written into
        ``flags_out`` when given); nothing syncs."""
        guard = self._guard
        cfg = guard.cfg
        loss, grads, new_state = self._step_grads(x, y, generator,
                                                   params)
        gl = list(grads.values())
        if cfg.faults:
            loss = anomaly.inject_grads(loss, gl, fault[0], fault[1])
        # off a mesh G2 takes the norm of the per-tensor norms itself
        gnorm = norms = None
        if self._mesh is None:
            norms = anomaly.tensor_norms(gl)
        else:
            gnorm = self._mesh.global_norm(grads)
        recover = cfg.mode == "recover"
        state = keep = None
        if recover:
            state = (list(params.values()) + dispatch._leaves(opt_state)
                     + self._written_state())
            with torch.no_grad():
                keep = guard.keep(state)
        flags, bad, row, scale = guard_check(
            loss, gnorm, guard.ewma, guard.obs, guard.count, base, table,
            sentinel=cfg.sentinel, spike_factor=cfg.spike_factor,
            grad_clip=cfg.grad_clip, recover=recover, flags_out=flags_out,
            keep=keep, norms=norms)
        if scale is not None:
            anomaly._scale(gl, scale)
        with torch.no_grad():
            self._update(grads, opt_state, params, row)
            commit_state(new_state)
            if recover:
                guard.commit(state, bad)
        return loss, flags

    def _guard_state(self, device: torch.device) -> dispatch.Guard:
        if self._guard is None or self._guard.device != device:
            self._guard = dispatch.Guard(self._sentinel_config(), device)
            self._program = None
        return self._guard

    def _noise(self, seed: int, iteration: int, device: torch.device):
        """The eager step's generator: a CPU one on the CPU; on CUDA the
        loop's device generator, seeded as a replayed step's is."""
        if device.type != "cuda":
            return step_generator(seed, iteration)
        if self._noise_gen is None:
            self._noise_gen = torch.Generator(device=device)
        return self._noise_gen.manual_seed(step_seed(seed, iteration))

    def _fault_input(self) -> np.ndarray:
        """Host-side ``train.grads`` fault scheduling: one site call per
        dispatched optimizer step. Returns the ``[code, scale]`` pair the
        step consumes (``anomaly.inject_grads``) — zeros unless an active
        plan fires a nan_loss/nan_grad/spike spec at this call index."""
        spec = faults.inject("train.grads")
        if spec is None:
            return _NO_FAULT
        code = anomaly.FAULT_CODES.get(spec.kind)
        if code is None:        # e.g. a latency spec: already applied
            return _NO_FAULT
        return np.asarray([code, spec.scale], np.float32)

    # -- checkpoint plumbing ------------------------------------------------
    def _ckpt_manager(self) -> Optional[CheckpointManager]:
        spec = getattr(self.model, "_checkpoint", None)
        if spec is None:
            return None
        ctx = get_zoo_context()
        keep = spec.get("keep")
        if keep is None:  # keep=0 means keep-all, so no falsy check
            keep = int(ctx.get("zoo.checkpoint.keep", 3))
        return CheckpointManager(spec["path"], keep=keep,
                                 registry=self._registry,
                                 ledger=self._goodput)

    def _checkpointing(self) -> bool:
        return getattr(self.model, "_checkpoint", None) is not None

    def _ckpt_trigger(self) -> Trigger:
        spec = getattr(self.model, "_checkpoint", None) or {}
        return spec.get("trigger") or EveryEpoch()

    def _count_now(self, opt) -> int:
        """The optimizer count as the device has it: with the sentinel
        active a discarded step did not advance it (a read of the
        device); else the host's."""
        if self._guard is not None and self._sentinel_config().active:
            return int(self._guard.count)
        return int(opt["count"])

    def _checkpoint_trees(self, named: Dict[str, torch.Tensor], opt_state,
                          count: int, state: Dict[str, Any]):
        """``(trees, meta)`` of a snapshot in the JAX format: the param tree
        (nested dicts), the optimizer state as optax's leaves (the port's
        own order, said so in ``meta``, when it has no optax layout) and
        the net state tree of the model state (``state``, dotted
        paths)."""
        names = list(self._params())
        opt_leaves = optax_leaves(self.optimizer, opt_state, count, names)
        meta = {}
        if opt_leaves is None:
            opt_leaves = ([np.int64(count)]
                          + dispatch._leaves(opt_state))
            meta[OPT_STATE_ORDER[0]] = OPT_STATE_ORDER[1]
        return ({"params": _param_tree(named), "opt_state": opt_leaves,
                 "net_state": _param_tree(state)}, meta)

    def _tree_state(self) -> Dict[str, torch.Tensor]:
        """The model state (constant and written) under its JAX net-state path."""
        return named_state(tree_module(self.model))

    def _save_checkpoint(self, mgr: CheckpointManager, loop_state, params,
                         opt, sync: bool = False) -> None:
        """Cut a snapshot. Async by default: the step path pays one
        batched device-to-host copy and the serialization/commit rides the
        manager's writer thread; ``sync=True`` (the SIGTERM path) blocks
        until committed."""
        named, opt_state = self._tree_params(), opt["state"]
        plan = self._mesh
        if plan is not None:
            # whole arrays on every rank (collectives); rank 0 writes
            ids = plan.leaf_params(self.optimizer, opt_state,
                                   list(self._params()))
            named = {n: plan.full(t) for n, t in named.items()}
            opt_state = _map_leaves(opt_state, lambda t: plan.full(
                t, ids[id(t)], moment=True) if id(t) in ids else t)
        trees, extra = self._checkpoint_trees(
            named, opt_state, self._count_now(opt), self._tree_state())
        if plan is not None and not plan.rank0:
            return
        mgr.save(loop_state.iteration, trees,
                 meta={"epoch": loop_state.epoch,
                       "iteration": loop_state.iteration,
                       "epoch_finished": loop_state.epoch_finished,
                       **extra},
                 sync=sync, mesh=self._mesh_meta())

    def _mesh_meta(self) -> dict:
        """The live mesh's ``mesh_metadata`` (a one-device block without
        a mesh), which a snapshot's manifest records."""
        return mesh_metadata(self._mesh.mesh if self._mesh is not None
                             else global_mesh())

    def _close_active_ckpt_mgr(self, surface: bool) -> None:
        """Join the active manager's in-flight save. ``surface=True``
        re-raises a background save failure (the end-of-fit surfacing
        point); ``surface=False`` is exception-path cleanup."""
        mgr, self._active_ckpt_mgr = self._active_ckpt_mgr, None
        if mgr is not None:
            mgr.close(raise_pending=surface)

    def _try_resume(self, mgr: CheckpointManager, params, opt,
                    allow_regress: bool = False):
        """Restore the newest VALID snapshot into the live parameter and
        optimizer tensors, in place (a captured step keeps reading them):
        a corrupt or uncommitted snapshot is quarantined and the restore
        falls back to the next one that verifies. Returns the snapshot's
        meta, or None when nothing at or past the model's progress
        verifies (``allow_regress``, the rollback path, may go back past
        it). A snapshot of the JAX package restores here: the same leaves
        in the same order."""
        named = self._tree_params()
        count = int(opt["count"])
        plan = self._mesh
        ids = ({} if plan is None else plan.leaf_params(
            self.optimizer, opt["state"], list(params)))

        def whole(t):
            # a template of the whole array (a split leaf's too)
            name = ids.get(id(t))
            return np.broadcast_to(np.zeros((), np.float32), _full_shape(
                t if name is None else params[name]))
        templates, extra = self._checkpoint_trees(
            {n: whole(p) for n, p in named.items()}, opt["state"],
            count, {n: _shape_of(t) for n, t in self._tree_state().items()})
        live_leaves = templates["opt_state"]
        templates["opt_state"] = [
            t if not isinstance(t, torch.Tensor) else whole(t)
            for t in live_leaves]
        out = mgr.restore_latest(
            templates,
            min_step=None if allow_regress
            else self.model.finished_iterations)
        if out is None:
            return None
        step, trees, meta = out
        port_order = meta.get(OPT_STATE_ORDER[0]) == OPT_STATE_ORDER[1]
        if port_order != bool(extra):
            raise CheckpointArchitectureError(
                f"ckpt-{step}: its optimizer state is in "
                f"{'this package' if port_order else 'optax'}'s leaf "
                f"order, and this loop's optimizer "
                f"{'has no optax layout' if extra else 'reads optax order'}"
                f" — a snapshot of an optimizer without an optax layout "
                f"restores only in the package that wrote it, under the "
                f"same optimizer")
        saved_mesh, live_mesh = meta.get("mesh"), self._mesh_meta()
        if saved_mesh is not None and saved_mesh != live_mesh:
            # elastic restore: whole host leaves, re-placed under the live
            # mesh (each rank keeps its slices; ZeRO moments re-split)
            log.warning(
                "elastic restore: ckpt-%d was saved under mesh %s (%s "
                "device(s)) and is restoring under mesh %s (%d device(s)) "
                "— host leaves re-placed under the current shardings, "
                "optimizer state re-sharded", step, format_mesh(saved_mesh),
                saved_mesh.get("devices", "?"), format_mesh(live_mesh),
                live_mesh["devices"])
            self._registry.emit("ckpt.elastic_restore", step=step,
                                saved=format_mesh(saved_mesh),
                                restored=format_mesh(live_mesh))
        leaves = trees["opt_state"]
        if plan is not None:
            leaves = [plan.local_moment(a, ids[id(t)])
                      if id(t) in ids else a
                      for a, t in zip(leaves, live_leaves)]
        # whole host leaves; a placed parameter takes its rank's slice
        load_param_tree(tree_module(self.model), trees["params"],
                        trees["net_state"])
        with torch.no_grad():
            if extra:
                restored = int(np.asarray(leaves[0]))
                for t, a in zip(dispatch._leaves(opt["state"]), leaves[1:]):
                    t.copy_(torch.as_tensor(np.asarray(a)))
            else:
                restored = load_optax_leaves(
                    self.optimizer, opt["state"], leaves, list(params))
        opt["count"] = (restored if restored is not None
                        else int(meta.get("iteration", count)))
        log.info("resumed from checkpoint ckpt-%d (epoch %s)", step,
                 meta.get("epoch"))
        return meta

    def _written_state(self) -> List[torch.Tensor]:
        """The model state the step writes (BatchNorm's moving
        statistics), in a fixed order."""
        return list(written_state(tree_module(self.model)).values())

    def _state_tensors(self, params, opt) -> List[torch.Tensor]:
        return (list(params.values()) + dispatch._leaves(opt["state"])
                + self._written_state())

    def _publish(self, params, opt, fresh: bool = False) -> None:
        """Keep a device copy of the live state as the model's published
        state — what a retry falls back to when no snapshot at or past
        the model's progress verifies (the JAX loop's per-epoch
        ``model.params`` clone)."""
        state = self._state_tensors(params, opt)
        if fresh or self._published is None:
            with torch.no_grad():
                copies = [t.detach().clone() for t in state]
        else:
            copies = self._published[0]
            torch._foreach_copy_(copies, state)
        self._published = (copies, int(opt["count"]))

    def _restore_published(self, params, opt) -> None:
        if self._published is None:
            return
        copies, count = self._published
        with torch.no_grad():
            torch._foreach_copy_(self._state_tensors(params, opt), copies)
        opt["count"] = count

    # -- SIGTERM ------------------------------------------------------------
    def _maybe_preempt(self, mgr, loop_state, params, opt) -> None:
        """SIGTERM arrived (``zoo.checkpoint.on_sigterm``): cut one final
        SYNCHRONOUS checkpoint at this step boundary, publish in-memory
        state, and exit cleanly via :class:`TrainingPreempted`."""
        if mgr is None or not self._preempted.is_set():
            return
        log.warning("SIGTERM: cutting a final synchronous checkpoint at "
                    "iteration %d before exiting", loop_state.iteration)
        try:
            self._save_checkpoint(mgr, loop_state, params, opt, sync=True)
        except Exception:
            # the process is going down either way; the newest previous
            # snapshot (already committed) remains the resume point
            log.exception("final preemption checkpoint failed")
        opt["count"] = self._count_now(opt)
        self.model.finished_iterations = loop_state.iteration
        raise TrainingPreempted(
            f"training preempted by SIGTERM; final checkpoint cut at "
            f"iteration {loop_state.iteration}")

    def _on_sigterm(self, signum, frame) -> None:
        grace = self._sigterm_grace
        if grace is not None:
            self._try_grace_cut(grace)      # raises when it cuts
        log.warning("SIGTERM received; requesting a final checkpoint at "
                    "the next step boundary")
        self._preempted.set()

    def _segment_begin(self, mgr, loop_state, params, opt) -> None:
        """A dispatch segment is about to run. When the running duration
        estimate already exceeds the grace budget, copy the boundary
        state NOW — the handler cuts its mid-epoch snapshot from it; a
        segment estimated to finish within the budget skips the copy."""
        if self._sigterm_grace is None or mgr is None:
            return
        est = self._segment_est
        if est is not None and est > self._sigterm_grace:
            self._boundary_ref = (
                mgr, loop_state.iteration, loop_state.epoch,
                loop_state.epoch_finished,
                {n: p.detach().clone()
                 for n, p in self._tree_params().items()},
                _clone_tree(opt["state"]), self._count_now(opt), params,
                opt)
        else:
            self._boundary_ref = None
        self._segment_t0 = time.monotonic()

    def _segment_end(self) -> None:
        """Fold the finished segment's wall time into the EWMA estimate;
        the loop's first segment (its compile or capture) is left out."""
        if self._sigterm_grace is None:
            return
        t0 = self._segment_t0
        self._segment_t0 = None
        self._boundary_ref = None
        if t0 is None:
            return
        self._segment_count += 1
        if self._segment_count == 1:
            return                      # compile-contaminated sample
        dur = time.monotonic() - t0
        est = self._segment_est
        self._segment_est = dur if est is None else 0.5 * est + 0.5 * dur

    def _try_grace_cut(self, grace: float) -> None:
        """SIGTERM-handler path: when the estimated time to the next step
        boundary exceeds the grace budget, cut one synchronous snapshot of
        the LAST boundary's state immediately — mid-epoch — publish it and
        exit via :class:`TrainingPreempted`. No estimate, no boundary
        copy, or a near boundary → return and let the next-boundary path
        run."""
        t0, est, ref = self._segment_t0, self._segment_est, \
            self._boundary_ref
        if t0 is None or est is None or ref is None:
            return
        eta = est - (time.monotonic() - t0)
        if eta <= grace:
            return
        # de-arm BEFORE the synchronous save: a re-sent SIGTERM must fall
        # through to the boundary-latch path
        self._boundary_ref = None
        self._segment_t0 = None
        (mgr, iteration, epoch, epoch_finished, named, opt_state, count,
         params, opt) = ref
        log.warning("SIGTERM: estimated %.2fs to the next step boundary "
                    "exceeds the %.2fs grace budget; cutting a mid-epoch "
                    "snapshot at iteration %d now", eta, grace, iteration)
        trees, extra = self._checkpoint_trees(named, opt_state, count,
                                              self._tree_state())
        try:
            mgr.save(iteration, trees,
                     meta={"epoch": epoch, "iteration": iteration,
                           "epoch_finished": epoch_finished, **extra},
                     sync=True, mesh=self._mesh_meta())
        except Exception:
            log.exception("grace-budget preemption checkpoint failed")
        live = self._tree_params()
        with torch.no_grad():
            for n, t in named.items():
                live[n].copy_(t)
            torch._foreach_copy_(dispatch._leaves(opt["state"]),
                                 dispatch._leaves(opt_state))
        opt["count"] = count
        self.model.finished_iterations = iteration
        raise TrainingPreempted(
            f"training preempted by SIGTERM; grace budget {grace:g}s is "
            f"shorter than the ~{eta:.2f}s to the next step boundary — "
            f"mid-epoch checkpoint cut at iteration {iteration}")

    # -- fit ------------------------------------------------------------------
    def fit(self, x, y, *, batch_size: int, nb_epoch: int,
            validation_data=None, shuffle: bool = True,
            callbacks: Sequence[Callable[[Dict[str, Any]], None]] = (),
            end_trigger: Optional[Trigger] = None,
            ) -> Dict[str, List[float]]:
        fs = FeatureSet.array(x, y, shuffle=shuffle,
                              seed=get_zoo_context().seed)
        return self.fit_feature_set(fs, batch_size=batch_size,
                                    nb_epoch=nb_epoch,
                                    validation_data=validation_data,
                                    callbacks=callbacks,
                                    end_trigger=end_trigger)

    def fit_feature_set(self, fs: FeatureSet, *, batch_size: int,
                        nb_epoch: int, validation_data=None,
                        callbacks: Sequence[Callable] = (),
                        end_trigger: Optional[Trigger] = None,
                        ) -> Dict[str, List[float]]:
        """Train on a FeatureSet with retry-on-failure semantics: a step
        failure reloads the latest checkpoint (when ``set_checkpoint`` is
        configured) and retries, at most ``zoo.failure.retry_times``
        times per ``zoo.failure.retry_window_sec`` window."""
        # a disk set's y would gather the whole label file
        if (fs.file_y if hasattr(fs, "file_y") else fs.y) is None:
            raise ValueError("fit needs labels")
        ctx = get_zoo_context()
        # fail now, not after an epoch: a multi-step chunk stacks batches of
        # one shape, and validation needs one dense array
        if getattr(fs, "ragged", False) and train_dispatch()[0] > 1:
            raise ValueError(
                "bucketed (ragged) datasets cannot use "
                "zoo.train.scan_steps > 1 — fused chunks stack same-shape "
                "batches; set scan_steps=1")
        if getattr(validation_data, "ragged", False):
            raise ValueError(
                "bucketed validation_data is not supported — evaluate per "
                "bucket (validation_data.buckets) instead")
        retry_times = int(ctx.get("zoo.failure.retry_times", 5))
        window_sec = float(ctx.get("zoo.failure.retry_window_sec", 3600))
        # per-fit self-healing state (zoo.train.sentinel=recover): the
        # flagged-step set survives rollback attempts within this fit,
        # and the rollback RetryBudget bounds escalations
        sen = self._sentinel_config()
        self._anomalous_steps = set()
        self._rollback_pending = False
        self._gp_restarting = False
        self._rollback_budget = (
            RetryBudget(capacity=sen.max_rollbacks, deposit=0.0,
                        name="train.rollback", registry=self._registry)
            if sen.mode == "recover" else None)
        # the epoch target is fixed once, after any checkpoint resume
        # inside the first attempt — retries must not extend it
        target_holder: Dict[str, int] = {}
        # preemption-safe shutdown (zoo.checkpoint.on_sigterm, opt-in);
        # signal handlers only install on the main thread
        self._preempted.clear()
        sig_installed = False
        prev_handler = None
        self._sigterm_grace = None
        self._segment_t0 = self._segment_est = None
        self._boundary_ref = None
        if (bool(ctx.get("zoo.checkpoint.on_sigterm", False))
                and getattr(self.model, "_checkpoint", None) is not None):
            if threading.current_thread() is threading.main_thread():
                prev_handler = signal.signal(signal.SIGTERM,
                                             self._on_sigterm)
                sig_installed = True
                grace = float(ctx.get("zoo.checkpoint.sigterm_grace_s", 0)
                              or 0)
                self._sigterm_grace = grace if grace > 0 else None
            else:
                log.warning("zoo.checkpoint.on_sigterm is set but fit() "
                            "is not on the main thread; SIGTERM "
                            "checkpointing disabled for this fit")
        # goodput/badput ledger for this fit (zoo.goodput.enabled)
        from ....observability.goodput import GoodputLedger, goodput_enabled
        self._goodput = (GoodputLedger("train", registry=self._registry)
                         if goodput_enabled() else None)
        if self._goodput is not None:
            self._goodput.open()
        try:
            with span("train.fit", registry=self._registry):
                return self._fit_with_retry(
                    fs, batch_size=batch_size, nb_epoch=nb_epoch,
                    target_holder=target_holder,
                    validation_data=validation_data, callbacks=callbacks,
                    end_trigger=end_trigger, retry_times=retry_times,
                    window_sec=window_sec)
        finally:
            # close the ledger's last open interval — teardown is idle
            self._gp_note("idle")
            self._boundary_ref = None
            self._segment_t0 = None
            self._published = None
            if sig_installed:
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None
                              else signal.SIG_DFL)

    def _fit_with_retry(self, fs, *, batch_size, nb_epoch, target_holder,
                        validation_data, callbacks, end_trigger,
                        retry_times, window_sec):
        attempts = 0
        window_start = time.time()
        first = True
        while True:
            try:
                history = self._fit_impl(
                    fs, batch_size=batch_size, nb_epoch=nb_epoch,
                    target_holder=target_holder,
                    validation_data=validation_data, callbacks=callbacks,
                    end_trigger=end_trigger, first=first)
                # end-of-fit join of the async checkpoint writer: a
                # background save failure surfaces HERE (and is re-cut
                # through the retry path below)
                self._close_active_ckpt_mgr(surface=True)
                if self._mesh is not None and self._checkpointing():
                    # rank 0's snapshot committed before any rank goes on
                    dist.barrier()
                return history
            except KeyboardInterrupt:
                self._close_active_ckpt_mgr(surface=False)
                raise
            except _RollbackRequested as rb:
                self._close_active_ckpt_mgr(surface=False)
                mgr = self._ckpt_manager()
                if mgr is None or mgr.latest() is None:
                    self._restore_published_on_exit()
                    raise TrainingDiverged(
                        f"{rb} — and no checkpoint is configured/"
                        f"committed to roll back to "
                        f"(model.set_checkpoint enables recovery)") from rb
                budget = self._rollback_budget
                if budget is None or not budget.withdraw():
                    self._restore_published_on_exit()
                    raise TrainingDiverged(
                        f"{rb} — rollback budget exhausted "
                        f"(zoo.train.max_rollbacks); the model holds the "
                        f"last known-good state") from rb
                self._gp_note("rollback_replay")
                self._m_rollback.inc()
                self._registry.emit("train.rollback", epoch=rb.epoch,
                                    skips=rb.skips,
                                    restore_step=mgr.latest(),
                                    skipped_iters=len(self._anomalous_steps))
                log.warning(
                    "training diverging (%s); rolling back to ckpt-%s and "
                    "replaying with %d flagged step(s) skipped", rb,
                    mgr.latest(), len(self._anomalous_steps))
                self._rollback_pending = True
            except (ValueError, TypeError):
                # user/config errors are not transient
                self._close_active_ckpt_mgr(surface=False)
                raise
            except Exception:
                self._close_active_ckpt_mgr(surface=False)
                mgr = self._ckpt_manager()
                if mgr is None or mgr.latest() is None:
                    raise  # nothing to recover from
                if time.time() - window_start > window_sec:
                    attempts = 0
                    window_start = time.time()
                attempts += 1
                if attempts > retry_times:
                    log.exception("giving up after %d failed attempts",
                                  attempts)
                    raise
                log.warning("training step failed (attempt %d/%d); reloading "
                            "latest checkpoint and retrying", attempts,
                            retry_times, exc_info=True)
                self._gp_note("restart")
                self._gp_restarting = True
            except BaseException:
                # TrainingPreempted (SystemExit): the final sync snapshot is
                # already committed — just release the writer and exit
                self._close_active_ckpt_mgr(surface=False)
                raise
            first = False

    def _restore_published_on_exit(self) -> None:
        """A fit that gives up leaves the model at its published state."""
        if self._published is not None:
            params = self._params()
            self._restore_published(params, self._opt_state(params))

    def _fit_impl(self, fs: FeatureSet, *, batch_size: int, nb_epoch: int,
                  target_holder: Dict[str, int], validation_data=None,
                  callbacks: Sequence[Callable] = (),
                  end_trigger: Optional[Trigger] = None,
                  first: bool = True) -> Dict[str, List[float]]:
        ctx = get_zoo_context()
        scan_steps, device_cache, fuse = train_dispatch()
        sen = self._sentinel_config()
        monitor = _SentinelMonitor(self, sen) if sen.active else None
        model = self.model
        self._ensure_weights()
        device = self._device()
        plan = self._mesh_step()
        if plan is not None and (scan_steps > 1 or device_cache):
            plan.check_capturable(device)
        params = self._params()
        opt = self._opt_state(params)
        guard = self._guard_state(device) if sen.active else None
        if guard is not None:
            # fresh EWMA each attempt: after a rollback the restored
            # params' gradient scale is the baseline worth learning
            guard.reset()

        mgr = self._ckpt_manager()
        self._active_ckpt_mgr = mgr
        ckpt_trigger = self._ckpt_trigger()
        if mgr is not None:
            if first:
                self._publish(params, opt, fresh=True)
            else:
                self._restore_published(params, opt)
            rollback = self._rollback_pending
            self._rollback_pending = False
            meta = self._try_resume(mgr, params, opt,
                                    allow_regress=rollback)
            self._gp_note("rollback_replay" if rollback
                          else "restart" if self._gp_restarting
                          else "idle")
            self._gp_restarting = False
            if meta is not None and meta.get("epoch") is not None:
                resumed_epoch = int(meta["epoch"]) - (
                    0 if meta.get("epoch_finished") else 1)
                if rollback or resumed_epoch > model.finished_epochs:
                    model.finished_epochs = resumed_epoch
                model.finished_iterations = int(meta.get(
                    "iteration", model.finished_iterations))
            elif rollback:
                log.warning("rollback requested but no snapshot could be "
                            "restored; continuing from the in-memory "
                            "state (further anomalies will re-escalate "
                            "within the rollback budget)")
        # the sliced disk tier: one loop epoch is one slice pass; nb_epoch
        # and EveryEpoch/MaxEpoch count full passes of num_of_slice slices
        n_slices = int(getattr(fs, "num_of_slice", 1) or 1)
        if n_slices > 1:
            def slice_aware(trig):
                if isinstance(trig, EveryEpoch):
                    return _FullPassEveryEpoch(n_slices)
                if isinstance(trig, MaxEpoch):
                    return MaxEpoch(trig.max_epoch * n_slices)
                if trig is not None and not isinstance(
                        trig, (SeveralIteration, _FullPassEveryEpoch)):
                    log.warning("trigger %s under a %d-slice DiskFeatureSet "
                                "observes SLICE passes as epochs, not full "
                                "passes", type(trig).__name__, n_slices)
                return trig
            ckpt_trigger = slice_aware(ckpt_trigger)
            end_trigger = slice_aware(end_trigger)
        if "target" not in target_holder:
            target_holder["target"] = (model.finished_epochs
                                       + nb_epoch * n_slices)
        target = target_holder["target"]

        if device_cache and sen.active:
            log.warning(
                "zoo.train.device_cache disabled for this fit: the "
                "anomaly-sentinel/grad-clip layer is active "
                "(zoo.train.sentinel=%s, zoo.train.grad_clip=%g); using "
                "the streamed dispatch path", sen.mode, sen.grad_clip)
            device_cache = False
        # a sliced set has no one array to keep on the device
        cached = (device_cache and n_slices <= 1
                  and getattr(fs, "device_cacheable", True))
        n_steps = fs.steps_per_epoch(batch_size, drop_last=True)
        if cached:
            for trig, role in ((ckpt_trigger if mgr is not None else None,
                                "checkpoint"), (end_trigger, "end")):
                if (isinstance(trig, SeveralIteration)
                        and trig.interval < n_steps):
                    log.warning(
                        "device_cache runs one dispatch per epoch, so the %s "
                        "trigger SeveralIteration(%d) is only observed at "
                        "epoch boundaries (%d steps) — up to %d steps late",
                        role, trig.interval, n_steps,
                        n_steps - trig.interval)
            self._device_data(fs, scan_steps, batch_size, device)
        history: Dict[str, List[float]] = {"loss": []}
        self.step_losses = []
        # fused blocks: only when nothing needs the host between epochs
        if (cached and fuse > 1 and mgr is None
                and validation_data is None and end_trigger is None):
            return self._fused_blocks(fs, batch_size, target, fuse,
                                      scan_steps, n_steps, params, opt,
                                      callbacks, history)

        loop_state = TrainLoopState(iteration=model.finished_iterations,
                                    epoch=model.finished_epochs + 1)
        stop = False
        for epoch in range(model.finished_epochs + 1, target + 1):
            # epoch-boundary overhead since the last step lands on idle
            self._gp_note("idle")
            t0 = time.time()
            loop_state.epoch = epoch
            # mid-epoch trigger checks must not see the previous epoch's
            # boundary flag
            loop_state.epoch_finished = False
            if monitor is not None:
                monitor.begin_epoch(epoch, loop_state.iteration)
            rows = (scalar_rows(self.optimizer, opt["count"], n_steps,
                                device) if n_steps else None)
            if guard is not None:
                guard.start_block(opt["count"])
            if cached:
                dispatches = self._cached_dispatches(
                    fs, epoch, ctx.seed, loop_state.iteration, batch_size,
                    params, opt, rows, scan_steps)
            elif scan_steps > 1:
                dispatches = self._chunk_dispatches(
                    fs, epoch, ctx.seed, loop_state.iteration, batch_size,
                    params, opt, rows, scan_steps, guard)
            else:
                dispatches = self._eager_dispatches(
                    fs, epoch, ctx.seed, loop_state.iteration, batch_size,
                    params, opt, rows, guard)
            losses = []
            n_seen = 0
            # closed on every exit: the prefetch thread ends with it
            with contextlib.closing(dispatches):
                for k, run in dispatches:
                    # host batch assembly since the last dispatch
                    self._gp_note("data_wait")
                    prev_iter = loop_state.iteration
                    if (monitor is not None and self._anomalous_steps
                            and any(monitor.step_key(prev_iter + j)
                                    in self._anomalous_steps
                                    for j in range(k))):
                        # rollback replay: the offending data window is NOT
                        # re-dispatched; the iteration still advances so the
                        # noise schedule and trigger windows stay aligned
                        loop_state.iteration += k
                        monitor.note_replay_skip(k)
                        self._gp_note("anomaly_skip")
                    else:
                        self._segment_begin(mgr, loop_state, params, opt)
                        step_l, step_f = run()
                        self._segment_end()
                        self._gp_note("device_step")
                        losses.append(step_l)
                        if monitor is not None:
                            monitor.push(prev_iter, step_f)
                        if guard is None:
                            opt["count"] += k
                        loop_state.iteration += k
                        n_seen += k * batch_size
                    if mgr is not None and _fired_within(
                            ckpt_trigger, loop_state, prev_iter):
                        self._save_checkpoint(mgr, loop_state, params, opt)
                    self._maybe_preempt(mgr, loop_state, params, opt)
                    if _fired_within(end_trigger, loop_state, prev_iter):
                        stop = True
                        break
            completed = not stop  # stop=True means the epoch was cut short
            # the epoch's one read of the device: losses (and the device
            # count; the flag words of the last dispatches first)
            if monitor is not None:
                # escalation may raise here, before the boundary snapshot
                monitor.drain()
                parts = [torch.cat(losses).double()] if losses else []
                host = torch.cat(parts + [guard.count.double().view(1)]
                                 ).cpu().numpy()
                lv = host[:-1].astype(np.float32)
                opt["count"] = int(host[-1])
                lmask = monitor.loss_mask(len(lv))
                epoch_loss = (float(lv[lmask].mean()) if lmask.any()
                              else float("nan"))
            else:
                lv = (torch.cat(losses).float().cpu().numpy() if losses
                      else np.zeros(0, np.float32))
                epoch_loss = float(lv.mean()) if len(lv) else float("nan")
            dt = time.time() - t0
            self._observe_fit_metrics(n_seen // batch_size, dt, n_seen)
            self.step_losses.append(lv)
            history["loss"].append(epoch_loss)
            loop_state.epoch_finished = completed
            if hasattr(end_trigger, "record"):
                end_trigger.record(epoch_loss)
            # cut a snapshot at the trigger, or unconditionally on a
            # mid-epoch stop so the truncated epoch's progress survives
            if mgr is not None and (stop or ckpt_trigger(loop_state)):
                self._save_checkpoint(mgr, loop_state, params, opt)
            # publish progress every epoch: what a retry attempt falls
            # back to when the newest snapshot is older
            if mgr is not None:
                self._publish(params, opt)
            if completed:
                model.finished_epochs = epoch
            model.finished_iterations = loop_state.iteration
            record = {"epoch": epoch, "loss": epoch_loss,
                      "iteration": loop_state.iteration,
                      "throughput": n_seen / dt if dt > 0 else 0.0}
            if validation_data is not None:
                val = self._validate(validation_data, batch_size)
                for key, v in val.items():
                    history.setdefault("val_" + key, []).append(v)
                record.update({"val_" + key: v for key, v in val.items()})
            log.info("Epoch %d%s: loss=%.6f (%.1f ex/s)", epoch,
                     "" if completed else " (stopped mid-epoch)",
                     epoch_loss, record["throughput"])
            for cb in callbacks:
                cb(record)
            # epoch_finished stays True through this boundary check:
            # MaxEpoch must see the finished count
            if stop or (end_trigger is not None and end_trigger(loop_state)):
                break
        return history

    def _validate(self, validation_data, batch_size: int):
        if isinstance(validation_data, FeatureSet):
            return self.evaluate(validation_data, batch_size=batch_size)
        vx, vy = validation_data
        return self.evaluate(vx, vy, batch_size=batch_size)

    def _fused_blocks(self, fs, batch_size, target, fuse, scan_steps,
                      n_steps, params, opt, callbacks, history):
        """``zoo.train.fuse_epochs`` epochs a block on the device-cached
        path, with one read of the device a block."""
        ctx = get_zoo_context()
        model = self.model
        device = self._device()
        epoch = model.finished_epochs
        while epoch < target:
            g = min(fuse, target - epoch)
            t0 = time.time()
            rows = (scalar_rows(self.optimizer, opt["count"], g * n_steps,
                                device) if n_steps else None)
            losses = []
            for j in range(g):
                it0 = model.finished_iterations + j * n_steps
                for _k, run in self._cached_dispatches(
                        fs, epoch + 1 + j, ctx.seed, it0, batch_size,
                        params, opt, None if rows is None
                        else rows[j * n_steps:(j + 1) * n_steps],
                        scan_steps):
                    losses.append(run()[0])
                opt["count"] += n_steps
            # the block's one read of the device
            block_losses = torch.stack(losses).float().cpu().numpy()
            self._gp_note("device_step")
            dt = (time.time() - t0) / g
            self._observe_fit_metrics(g * n_steps, dt * g,
                                      g * n_steps * batch_size)
            for j in range(g):
                e = epoch + 1 + j
                step_l = block_losses[j]
                epoch_loss = (float(step_l.mean()) if n_steps
                              else float("nan"))
                self.step_losses.append(step_l)
                history["loss"].append(epoch_loss)
                model.finished_epochs = e
                record = {"epoch": e, "loss": epoch_loss,
                          "iteration": (model.finished_iterations
                                        + (j + 1) * n_steps),
                          "throughput": (n_steps * batch_size / dt
                                         if dt > 0 else 0.0)}
                log.info("Epoch %d: loss=%.6f (%.1f ex/s)", e, epoch_loss,
                         record["throughput"])
                for cb in callbacks:
                    cb(record)
            model.finished_iterations += g * n_steps
            epoch += g
        return history

    # -- the dispatch paths: each yields ``(k, run)`` per dispatch of k
    #    steps; ``run()`` dispatches them and returns their losses (and,
    #    guarded, their flag words) on the device ----------------------
    def _eager_dispatches(self, fs, epoch, seed, it0, batch_size, params,
                          opt, rows, guard):
        """One step a dispatch, the batches streamed to the device through
        :func:`prefetch_to_device` (assembled on its thread, copied ahead
        on its stream), as the JAX loop streams them."""
        device = self._device()
        faults_on = guard is not None and guard.cfg.faults
        batches = fs.iter_batches(batch_size, epoch=seed + epoch,
                                  drop_last=True)
        if self._mesh is not None:
            # each data rank streams its rows of every batch
            batches = self._mesh.host_batches(batches)
        stream = prefetch_to_device(batches, device, ledger=self._goodput)
        for i, (x, y) in enumerate(stream):
            def run(i=i, x=x, y=y):
                gen = self._noise(seed, it0 + i, device)
                if guard is None:
                    return self.train_step(x, y, gen, params, opt["state"],
                                           rows[i]).view(1), None
                fault = (_to_device(self._fault_input(), device)
                         if faults_on else None)
                loss, flags = self.guarded_step(
                    x, y, gen, params, opt["state"], rows, guard.base, fault)
                return loss.view(1), flags.view(1)
            yield 1, run

    def _chunk_dispatches(self, fs, epoch, seed, it0, batch_size, params,
                          opt, rows, k_max, guard):
        """``k_max`` steps a dispatch: the FeatureSet's batches stacked K
        to a chunk (the last shorter), copied into the program's
        buffers."""
        device = self._device()
        faults_on = guard is not None and guard.cfg.faults
        # only the host assembly runs ahead, on a thread: the copy into the
        # captured program's static buffers (fill) stays on the compute
        # stream after the previous replay, which reads them
        batches = fs.iter_batches(batch_size, epoch=seed + epoch,
                                  drop_last=True)
        local_bs = batch_size
        if self._mesh is not None:
            batches = self._mesh.host_batches(batches)
            local_bs = self._mesh.local_batch(batch_size)
        src = _ThreadedIterator(chunked(batches, k_max), buffer_size=2)
        try:
            done = 0
            for chunk in src:
                k = chunk[1].shape[0]
                # one step's arrays of the chunk: the buffers' dtypes and
                # shapes
                step_xs = [a[0] for a in _as_list(chunk[0])]
                step_y = chunk[1][0]

                def run(chunk=chunk, done=done, k=k, step_xs=step_xs,
                        step_y=step_y):
                    program = self._step_program(
                        ("chunks", batch_size, k_max,
                         tuple((a.dtype.str, a.shape[1:]) for a in step_xs),
                         (step_y.dtype.str, step_y.shape[1:])),
                        lambda: dispatch.HostChunks(step_xs, step_y, k_max,
                                                    local_bs, device),
                        params, opt, k_max, guard, "train.scan_chunk")
                    program.inputs.fill(chunk)
                    if guard is None:
                        return program.run(k, seed, it0 + done,
                                           rows[done:done + k]), None
                    fault = (np.stack([self._fault_input()
                                       for _ in range(k)])
                             if faults_on else None)
                    return program.run(k, seed, it0 + done, rows, fault)
                yield k, run
                done += k
        finally:
            src.close()

    def _device_data(self, fs, k_max, batch_size, device):
        """The device-resident copy of ``fs``, uploaded once and kept while
        ``fs`` is the latest set (device memory is the scarce resource;
        switching sets back and forth uploads again)."""
        key = (id(fs), len(fs), k_max, batch_size, str(device))
        if self._data is None or self._data[0] != key:
            self._data = self._program = None
            arrays = fs.xs + ([fs.y] if fs.y is not None else [])
            on_device = all(isinstance(a, torch.Tensor)
                            and a.device == device for a in arrays)
            # a set of tensors on the device stays there (the JAX loop
            # relayouts device arrays on the device); else one upload
            xs, y = (fs.xs, fs.y) if on_device else fs._host_view()
            # holding ``fs`` keeps its id from naming another set
            local_bs = (batch_size if self._mesh is None
                        else self._mesh.local_batch(batch_size))
            self._data = (key, fs, dispatch.DeviceData(
                xs, y, k_max, local_bs, device))
        return self._data[2]

    def _cached_dispatches(self, fs, epoch, seed, it0, batch_size, params,
                           opt, rows, k_max):
        """The device-resident set in the epoch's order (a permutation drawn
        on the device, the first ``n_steps x batch`` rows), gathered on the
        device ``k_max`` steps a replay: the whole epoch is one segment, as
        the JAX loop's one dispatch an epoch."""
        device = self._device()
        n_steps = fs.steps_per_epoch(batch_size, drop_last=True)

        def run():
            data = self._device_data(fs, k_max, batch_size, device)
            n = len(fs)
            order = (dispatch.device_permutation(n, fs.seed + seed + epoch,
                                                 device)
                     if fs.shuffle else torch.arange(n, device=device))
            order = order[:n_steps * batch_size].reshape(n_steps, batch_size)
            if self._mesh is not None:
                order = self._mesh.take(order, 1).contiguous()
            program = self._step_program(("cached", self._data[0]),
                                         lambda: data, params, opt, k_max,
                                         None, "train.epoch")
            losses = []
            for done in range(0, n_steps, k_max):
                k = data.fill(order[done:done + k_max])
                losses.append(program.run(k, seed, it0 + done,
                                          rows[done:done + k]))
            return (torch.cat(losses) if losses
                    else torch.zeros(0, device=device)), None
        yield n_steps, run

    def _step_program(self, key, make_inputs, params, opt, k_max, guard,
                      name):
        """The loop's program for ``key``, made (with ``make_inputs()``'s
        buffers) on first use and kept over fits while the parameters and
        the optimizer state are the same tensors."""
        key = (key, id(opt["state"]), id(guard),
               tuple(p.data_ptr() for p in params.values()))
        if self._program is None or self._program[0] != key:
            self._program = None
            self._program = (key, dispatch.StepProgram(
                self, params, opt["state"], make_inputs(), k_max, guard,
                name))
        return self._program[1]

    def _observe_fit_metrics(self, steps: int, dt: float,
                             n_examples: int) -> None:
        if steps <= 0 or dt <= 0:
            return
        self._m_step_time.observe(dt / steps, n=steps)
        self._m_throughput.set(n_examples / dt)
        self._m_steps.inc(steps)
        self._m_examples.inc(n_examples)

    # -- evaluate / predict -------------------------------------------------
    def _local_rows(self, batch_size: int):
        """Under data parallelism, this rank's rows of each padded batch
        (``evaluate``/``predict`` split a batch over ``data`` and combine
        their results), else None."""
        plan = self._mesh_step()
        if plan is None or plan.dp == 1 or batch_size % plan.dp:
            return None
        return plan

    def evaluate(self, x, y=None, *, batch_size: int = 32
                 ) -> Dict[str, float]:
        x, y = _host_arrays(x, y)
        self._ensure_weights()
        device = self._device()
        plan = self._local_rows(batch_size)
        pe_loss = objectives.per_example_loss(self.loss)
        totals: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        with torch.no_grad():
            # streamed through the training loop's prefetch pipeline; the
            # running totals stay on the device
            for bx_d, by_d, mask_d, _ in prefetch_to_device(
                    _padded_batches(x, y, batch_size), device):
                if plan is not None:
                    bx_d, by_d, mask_d = (plan.take(a)
                                          for a in (bx_d, by_d, mask_d))
                y_pred = self.model(bx_d, training=False)
                stats = {m.name: m.update(by_d, y_pred, mask_d)
                         for m in self.metrics}
                if pe_loss is not None:
                    stats["loss"] = {
                        "sum": torch.sum(pe_loss(by_d, y_pred) * mask_d),
                        "count": torch.sum(mask_d)}
                else:
                    # a cross-batch loss has no per-example form: the
                    # whole-batch value, weighted by the real rows
                    stats["loss"] = {
                        "sum": self.loss(by_d, y_pred) * torch.sum(mask_d),
                        "count": torch.sum(mask_d)}
                totals = stats if totals is None else {
                    k: {s: totals[k][s] + v for s, v in d.items()}
                    for k, d in stats.items()}
        if totals is None:
            return {}
        if plan is not None:
            # every rank's sums, on every rank
            totals = {k: {s: all_reduce(v, plan.data) for s, v in d.items()}
                      for k, d in totals.items()}
        host = {k: {s: (v.item() if v.dim() == 0 else v.cpu())
                    for s, v in d.items()}
                for k, d in totals.items()}
        out = {m.name: float(m.finalize(host[m.name])) for m in self.metrics}
        out["loss"] = host["loss"]["sum"] / max(host["loss"]["count"], 1.0)
        return out

    def predict(self, x, *, batch_size: int = 32):
        x, _ = _host_arrays(x, None)
        self._ensure_weights()
        device = self._device()
        plan = self._local_rows(batch_size)
        outs = []
        with torch.no_grad():
            for bx_d, _, _, real in prefetch_to_device(
                    _padded_batches(x, None, batch_size), device):
                if plan is None:
                    y_pred = self.model(bx_d, training=False)
                else:
                    # each rank's rows, gathered in order
                    y_pred = all_gather(self.model(
                        plan.take(bx_d), training=False), plan.data, 0)
                outs.append(y_pred[:real])
        if not outs:
            return None
        return torch.cat(outs).float().cpu().numpy()
