"""TrainingLoop — port of ``analytics_zoo_tpu/pipeline/api/keras/
training.py``: ``fit`` → ``fit_feature_set`` → the step loop, the plain
step of ``_make_step_core`` (forward, loss, backward, optimizer update),
``evaluate`` with masked padded tails, and ``predict``.

What the JAX loop does and this one keeps:

* batch order: ``FeatureSet(seed=zoo.seed)`` walked with ``epoch =
  zoo.seed + epoch`` (epochs count from ``finished_epochs + 1``), drop-last;
* ``nb_epoch`` is additive over fit calls; the epoch loss is the mean of
  the step losses; ``history["loss"]`` holds one value per epoch and
  every callback gets ``{"epoch", "loss", "iteration", "throughput"}``;
* the dispatch paths (``dispatch.py``): one step at a time by default;
  ``zoo.train.scan_steps = K`` steps a dispatch over chunks of K
  FeatureSet batches; ``zoo.train.device_cache`` the dataset resident on
  the device, each epoch's order a permutation drawn there (seeded from
  ``fs.seed + zoo.seed + epoch``), drop-last, batches gathered on the
  device; with it, ``zoo.train.fuse_epochs = g`` runs g epochs a block
  when there is no validation, with one read of the device a block. On
  CUDA a multi-step dispatch is the replay of a captured CUDA graph;
* no host sync inside an epoch (or a fused block): batches go to the
  device through pinned memory without blocking, step losses stay on the
  device and are read once at the epoch's (the block's) end;
* the optimizer's count and per-step values: the count is kept beside
  the optimizer state (``model.opt_state``) and continues over fits; the
  host computes each step's scalars and every path's update reads them
  from a device row (``optimizers.step_scalars``);
* the ``zoo_train_*`` step-time, throughput, step and example metrics in
  the process registry.

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
loop too; on the port's one device it declines. Integer inputs (ids)
stay integer from the ``FeatureSet`` to the model.

Not ported yet, with their seams left where the JAX loop has them:
anomaly sentinels and gradient clipping in the step, checkpoints and
resume, retry on failure, SIGTERM snapshots, goodput accounting, remat
and the sequence/pipeline scopes.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ....common.context import get_zoo_context, train_dispatch
from ....common.noise import step_seed
from ....feature.feature_set import FeatureSet, chunked
from ....observability import default_registry
from . import dispatch, objectives
from .metrics import Metric
from .optimizers import GradientTransformation, apply_updates, scalar_rows

log = logging.getLogger("analytics_zoo_tpu_torch")


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


def step_generator(seed: int, iteration: int) -> torch.Generator:
    """The CPU generator of one training step's noise."""
    return torch.Generator().manual_seed(step_seed(seed, iteration))


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

    # -- model plumbing -----------------------------------------------------
    def _ensure_weights(self) -> None:
        if not getattr(self.model, "built", True):
            self.model.init_weights()

    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _params(self) -> Dict[str, torch.Tensor]:
        return {n: p for n, p in self.model.named_parameters()
                if p.requires_grad}

    def _opt_state(self, params):
        """``{"count", "state"}``: the model's optimizer state and update
        count when this loop's optimizer made them (a later fit continues
        both), else fresh ones."""
        model = self.model
        if (model.opt_state is None
                or getattr(model, "_opt_state_owner", None)
                is not self.optimizer):
            model.opt_state = {"count": 0,
                               "state": self.optimizer.init(params)}
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
        from .sharded_embed import resolve_sharded_embeddings
        model, loss_fn = self.model, self.loss
        # declines on one device (it raises where the JAX package would
        # row-shard the plain embeddings)
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
                     "formed)", spec.head.name, spec.head.output_dim)
            labels = {"head": spec.head.name,
                      "vocab": str(spec.head.output_dim),
                      "sharded": "1" if spec.sharded else "0"}
            if prev is not None and prev != labels:
                self._fused_gauge(prev).set(0)
            self._fused_gauge(labels).set(1)
            TrainingLoop._last_fused_labels = labels

            def apply_loss(x, y, generator):
                return spec.apply_and_loss(model, x, y, generator=generator)
        self._apply_loss = apply_loss
        return apply_loss

    def train_step(self, x, y, generator: Optional[torch.Generator],
                   params: Dict[str, torch.Tensor], opt_state,
                   scalars: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Forward, loss, backward, optimizer update (the JAX plain step):
        the step every dispatch path runs. ``opt_state`` is the
        optimizer's state, ``scalars`` the step's row of its per-step
        values. Returns the loss as a device scalar; nothing syncs."""
        for p in params.values():
            p.grad = None
        loss = self._loss_application()(x, y, generator)
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        for p in params.values():
            p.grad = None
        updates, _ = self.optimizer.update(grads, opt_state, params,
                                           scalars)
        apply_updates(params, updates)
        return loss.detach()

    def _noise(self, seed: int, iteration: int, device: torch.device):
        """The eager step's generator: a CPU one on the CPU; on CUDA the
        loop's device generator, seeded as a replayed step's is."""
        if device.type != "cuda":
            return step_generator(seed, iteration)
        if self._noise_gen is None:
            self._noise_gen = torch.Generator(device=device)
        return self._noise_gen.manual_seed(step_seed(seed, iteration))

    # -- fit ------------------------------------------------------------------
    def fit(self, x, y, *, batch_size: int, nb_epoch: int,
            validation_data=None, shuffle: bool = True,
            callbacks: Sequence[Callable[[Dict[str, Any]], None]] = (),
            ) -> Dict[str, List[float]]:
        fs = FeatureSet.array(x, y, shuffle=shuffle,
                              seed=get_zoo_context().seed)
        return self.fit_feature_set(fs, batch_size=batch_size,
                                    nb_epoch=nb_epoch,
                                    validation_data=validation_data,
                                    callbacks=callbacks)

    def fit_feature_set(self, fs: FeatureSet, *, batch_size: int,
                        nb_epoch: int, validation_data=None,
                        callbacks: Sequence[Callable] = (),
                        ) -> Dict[str, List[float]]:
        if fs.y is None:
            raise ValueError("fit needs labels")
        ctx = get_zoo_context()
        scan_steps, device_cache, fuse = train_dispatch()
        model = self.model
        self._ensure_weights()
        device = self._device()
        params = self._params()
        opt = self._opt_state(params)
        # the JAX loop turns device_cache off while an anomaly sentinel is
        # active (training.py:1650-1661); the port has no sentinel yet,
        # and that rule goes here when it lands
        cached = device_cache and getattr(fs, "device_cacheable", True)
        if cached:
            self._device_data(fs, scan_steps, batch_size, device)
        # epochs a block: the fused path only without validation (no
        # checkpoint manager or end trigger is ported to need the host)
        block = fuse if cached and validation_data is None else 1
        n_steps = fs.steps_per_epoch(batch_size, drop_last=True)
        history: Dict[str, List[float]] = {"loss": []}
        self.step_losses = []
        epoch, target = model.finished_epochs, model.finished_epochs + nb_epoch
        while epoch < target:
            g = min(block, target - epoch)
            t0 = time.time()
            rows = (scalar_rows(self.optimizer, opt["count"], g * n_steps,
                                device) if n_steps else None)
            losses = []
            for j in range(g):
                args = (fs, epoch + 1 + j, ctx.seed,
                        model.finished_iterations + j * n_steps, batch_size,
                        params, opt,
                        None if rows is None else rows[j * n_steps:
                                                       (j + 1) * n_steps])
                if cached:
                    losses.append(self._cached_epoch(*args, scan_steps))
                elif scan_steps > 1:
                    losses.append(self._chunked_epoch(*args, scan_steps))
                else:
                    losses.append(self._eager_epoch(*args))
            # the block's one read of the device
            block_losses = torch.stack(losses).float().cpu()
            dt = (time.time() - t0) / g
            self._observe_fit_metrics(g * n_steps, dt * g,
                                      g * n_steps * batch_size)
            for j in range(g):
                e = epoch + 1 + j
                step_l = block_losses[j]
                epoch_loss = (float(step_l.mean()) if n_steps
                              else float("nan"))
                self.step_losses.append(step_l.numpy())
                history["loss"].append(epoch_loss)
                model.finished_epochs = e
                record = {"epoch": e, "loss": epoch_loss,
                          "iteration": (model.finished_iterations
                                        + (j + 1) * n_steps),
                          "throughput": (n_steps * batch_size / dt
                                         if dt > 0 else 0.0)}
                if validation_data is not None:
                    vx, vy = ((validation_data.x, validation_data.y)
                              if isinstance(validation_data, FeatureSet)
                              else validation_data)
                    val = self.evaluate(vx, vy, batch_size=batch_size)
                    for k, v in val.items():
                        history.setdefault("val_" + k, []).append(v)
                    record.update({"val_" + k: v for k, v in val.items()})
                log.info("Epoch %d: loss=%.6f (%.1f ex/s)", e, epoch_loss,
                         record["throughput"])
                for cb in callbacks:
                    cb(record)
            model.finished_iterations += g * n_steps
            epoch += g
        return history

    # -- the dispatch paths (each returns one epoch's step losses, on the
    #    device) ----------------------------------------------------------
    def _eager_epoch(self, fs, epoch, seed, it0, batch_size, params, opt,
                     rows):
        """One step a dispatch, each batch copied to the device."""
        device = self._device()
        losses = []
        for i, (bx, by) in enumerate(fs.iter_batches(
                batch_size, epoch=seed + epoch, drop_last=True)):
            losses.append(self.train_step(
                _to_device(bx, device), _to_device(by, device),
                self._noise(seed, it0 + i, device), params, opt["state"],
                rows[i]))
            opt["count"] += 1
        return (torch.stack(losses) if losses
                else torch.zeros(0, device=device))

    def _chunked_epoch(self, fs, epoch, seed, it0, batch_size, params, opt,
                       rows, k_max):
        """``k_max`` steps a dispatch: the FeatureSet's batches stacked K to
        a chunk (the last shorter), copied into the program's buffers."""
        device = self._device()
        losses, done = [], 0
        for chunk in chunked(fs.iter_batches(batch_size, epoch=seed + epoch,
                                             drop_last=True), k_max):
            program = self._step_program(
                ("chunks", batch_size, k_max,
                 tuple((a.dtype.str, a.shape[1:]) for a in fs.xs),
                 (fs.y.dtype.str, fs.y.shape[1:])),
                lambda: dispatch.HostChunks(fs.xs, fs.y, k_max, batch_size,
                                            device),
                params, opt, k_max)
            k = program.inputs.fill(chunk)
            losses.append(program.run(k, seed, it0 + done,
                                      rows[done:done + k]))
            opt["count"] += k
            done += k
        return (torch.cat(losses) if losses
                else torch.zeros(0, device=device))

    def _device_data(self, fs, k_max, batch_size, device):
        """The device-resident copy of ``fs``, uploaded once and kept while
        ``fs`` is the latest set (device memory is the scarce resource;
        switching sets back and forth uploads again)."""
        key = (id(fs), len(fs), k_max, batch_size, str(device))
        if self._data is None or self._data[0] != key:
            self._data = self._program = None
            # holding ``fs`` keeps its id from naming another set
            self._data = (key, fs, dispatch.DeviceData(
                fs.xs, fs.y, k_max, batch_size, device))
        return self._data[2]

    def _cached_epoch(self, fs, epoch, seed, it0, batch_size, params, opt,
                      rows, k_max):
        """The device-resident set in the epoch's order (a permutation drawn
        on the device, the first ``n_steps x batch`` rows), gathered on the
        device ``k_max`` steps a dispatch."""
        device = self._device()
        data = self._device_data(fs, k_max, batch_size, device)
        n_steps = fs.steps_per_epoch(batch_size, drop_last=True)
        n = len(fs)
        order = (dispatch.device_permutation(n, fs.seed + seed + epoch,
                                             device)
                 if fs.shuffle else torch.arange(n, device=device))
        order = order[:n_steps * batch_size].reshape(n_steps, batch_size)
        program = self._step_program(("cached", self._data[0]),
                                     lambda: data, params, opt, k_max)
        losses = []
        for done in range(0, n_steps, k_max):
            k = data.fill(order[done:done + k_max])
            losses.append(program.run(k, seed, it0 + done,
                                      rows[done:done + k]))
            opt["count"] += k
        return (torch.cat(losses) if losses
                else torch.zeros(0, device=device))

    def _step_program(self, key, make_inputs, params, opt, k_max):
        """The loop's program for ``key``, made (with ``make_inputs()``'s
        buffers) on first use and kept over fits while the parameters and
        the optimizer state are the same tensors."""
        key = (key, id(opt["state"]),
               tuple(p.data_ptr() for p in params.values()))
        if self._program is None or self._program[0] != key:
            self._program = None
            self._program = (key, dispatch.StepProgram(
                self, params, opt["state"], make_inputs(), k_max))
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
    def evaluate(self, x, y=None, *, batch_size: int = 32
                 ) -> Dict[str, float]:
        if isinstance(x, FeatureSet):
            x, y = x.x, x.y
        self._ensure_weights()
        device = self._device()
        pe_loss = objectives.per_example_loss(self.loss)
        totals: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        with torch.no_grad():
            for bx, by, mask, _ in _padded_batches(x, y, batch_size):
                by_d = _to_device(by, device)
                mask_d = _to_device(mask, device)
                y_pred = self.model(_to_device(bx, device), training=False)
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
        host = {k: {s: (v.item() if v.dim() == 0 else v.cpu())
                    for s, v in d.items()}
                for k, d in totals.items()}
        out = {m.name: float(m.finalize(host[m.name])) for m in self.metrics}
        out["loss"] = host["loss"]["sum"] / max(host["loss"]["count"], 1.0)
        return out

    def predict(self, x, *, batch_size: int = 32):
        if isinstance(x, FeatureSet):
            x = x.x
        self._ensure_weights()
        device = self._device()
        outs = []
        with torch.no_grad():
            for bx, _, _, real in _padded_batches(x, None, batch_size):
                y_pred = self.model(_to_device(bx, device), training=False)
                outs.append(y_pred[:real])
        if not outs:
            return None
        return torch.cat(outs).float().cpu().numpy()
