"""Anomaly sentinels — port of ``analytics_zoo_tpu/common/anomaly.py``:
on-device divergence detection for the training step.

One poison batch or an overflow NaNs the parameters and every later step
trains garbage. The step detects the bad step on the device, contains it
(the update is discarded) and the loop escalates to a rollback when
skipping is not enough (``pipeline/api/keras/training.py``).

Kept from the JAX module, letter for letter: the packed flag word
(:data:`NAN_LOSS`, :data:`NAN_GRAD`, :data:`SPIKE`, :data:`GRAD_CLIPPED`),
the fault codes, the EWMA constants, the knobs and their validation, and
the classification rules. Each on-device piece is a plain function on
device tensors that returns device tensors and never reads a value back
to the host (no ``.item()``), so it runs inside a captured CUDA graph as
it runs eagerly. The EWMA state is two device scalars, a pure function
of the observed norms: the flagged set is deterministic.

Knobs: ``zoo.train.sentinel`` (``off|warn|recover``),
``zoo.train.spike_factor``, ``zoo.train.grad_clip``,
``zoo.train.max_skips_per_epoch``, ``zoo.train.max_rollbacks``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from .context import FALSE_FLAG_SPELLINGS, get_zoo_context

__all__ = ["NAN_LOSS", "NAN_GRAD", "SPIKE", "ANOMALY_MASK", "GRAD_CLIPPED",
           "SentinelConfig", "resolve_config", "init_state", "check",
           "global_norm", "tensor_norms", "norm_of_norms", "clip_scale",
           "clip_by_global_norm", "inject_grads",
           "kinds_of", "FAULT_CODES", "EWMA_ALPHA", "WARMUP_STEPS",
           "EWMA_FLOOR", "KIND_BITS"]

# -- the packed per-step flag word -------------------------------------------
#: loss came back non-finite (NaN/inf)
NAN_LOSS = 1
#: loss finite but the global gradient norm is non-finite
NAN_GRAD = 2
#: finite gradient norm spiked past spike_factor x its EWMA baseline
SPIKE = 4
#: any bit in here marks the step anomalous (recover mode discards it)
ANOMALY_MASK = NAN_LOSS | NAN_GRAD | SPIKE
#: informational: global-norm gradient clipping engaged this step
#: (zoo.train.grad_clip) — NOT an anomaly, never triggers a skip
GRAD_CLIPPED = 8

#: bit → metric label for zoo_train_anomaly_total{kind=}
KIND_BITS: Tuple[Tuple[int, str], ...] = (
    (NAN_LOSS, "nan_loss"), (NAN_GRAD, "nan_grad"), (SPIKE, "spike"))

#: ``train.grads`` fault-plan kind → the on-device poison code the host
#: feeds the step (0 = no fault); see :func:`inject_grads`
FAULT_CODES = {"nan_loss": 1, "nan_grad": 2, "spike": 3}

#: EWMA smoothing for the gradient-norm baseline: norm_t contributes
#: alpha, history (1-alpha)
EWMA_ALPHA = 0.1
#: observed (non-anomalous) steps before the spike check engages
WARMUP_STEPS = 5
#: the spike check also needs the baseline above this floor: a
#: (near-)zero EWMA makes the relative test meaningless (a healthy run
#: would flag its first real gradient and livelock into rollbacks)
EWMA_FLOOR = 1e-8


@dataclasses.dataclass(frozen=True)
class SentinelConfig:
    """The sentinel/clipping knobs, resolved once per training loop so
    every step of the loop agrees, and a ``sentinel=off`` loop with no
    clipping builds steps with no sentinel op in them."""

    mode: str            # off | warn | recover
    spike_factor: float
    grad_clip: float     # 0 = off
    faults: bool         # step accepts per-step train.grads poison codes
    max_skips_per_epoch: int
    max_rollbacks: int

    @property
    def sentinel(self) -> bool:
        return self.mode != "off"

    @property
    def active(self) -> bool:
        """Whether the step carries the sentinel state and/or the packed
        flag output."""
        return self.sentinel or self.grad_clip > 0


def resolve_config() -> SentinelConfig:
    """Read and validate the ``zoo.train.*`` sentinel knobs."""
    ctx = get_zoo_context()
    raw = ctx.get("zoo.train.sentinel", "off")
    mode = str(raw).strip().lower() if raw is not None else "off"
    if mode in FALSE_FLAG_SPELLINGS:
        mode = "off"
    if mode not in ("off", "warn", "recover"):
        raise ValueError(f"zoo.train.sentinel must be off|warn|recover, "
                         f"got {raw!r}")
    spike_factor = float(ctx.get("zoo.train.spike_factor", 10.0))
    # the sentinel-only knobs are validated only when the sentinel is
    # on: a value for a disabled feature must not abort training that
    # never reads it (grad_clip stands alone)
    if mode != "off" and spike_factor <= 1.0:
        raise ValueError(f"zoo.train.spike_factor must be > 1 "
                         f"({spike_factor})")
    grad_clip = float(ctx.get("zoo.train.grad_clip", 0.0) or 0.0)
    if grad_clip < 0:
        raise ValueError(f"zoo.train.grad_clip must be >= 0 ({grad_clip})")
    max_skips = int(ctx.get("zoo.train.max_skips_per_epoch", 8))
    if mode != "off" and max_skips < 0:
        raise ValueError(f"zoo.train.max_skips_per_epoch must be >= 0 "
                         f"({max_skips})")
    max_rollbacks = int(ctx.get("zoo.train.max_rollbacks", 3))
    if mode != "off" and max_rollbacks < 1:
        raise ValueError(f"zoo.train.max_rollbacks must be >= 1 "
                         f"({max_rollbacks})")
    faults = bool(ctx.get("zoo.faults.enabled", False))
    return SentinelConfig(mode=mode, spike_factor=spike_factor,
                          grad_clip=grad_clip,
                          faults=faults and mode != "off",
                          max_skips_per_epoch=max_skips,
                          max_rollbacks=max_rollbacks)


# ---------------------------------------------------------------------------
# on-device pieces (called from inside the step, eager or captured)
# ---------------------------------------------------------------------------

def init_state(device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Fresh EWMA state ``(baseline_norm, observed_count)``: two f32
    device scalars."""
    return (torch.zeros((), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.float32, device=device))


def tensor_norms(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each gradient's L2 norm in f32, whatever the compute dtype: one
    fused per-tensor norm pass (one-element tensors)."""
    if not grads:
        return []
    return list(torch._foreach_norm([g.float() if g.dtype != torch.float32
                                     else g for g in grads]))


def norm_of_norms(norms: Sequence[torch.Tensor], device="cpu"
                  ) -> torch.Tensor:
    """The L2 norm of the per-tensor norms (a device scalar; zero for
    none)."""
    if not norms:
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.linalg.vector_norm(torch.stack(list(norms)))


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm of the gradients, accumulated in f32 whatever the
    compute dtype: the per-tensor norms (:func:`tensor_norms`), then the
    norm of the norms (:func:`norm_of_norms`)."""
    return norm_of_norms(tensor_norms(list(grads)))


def check(loss: torch.Tensor, gnorm: torch.Tensor, state,
          spike_factor: float):
    """Classify one step: returns ``(flags, new_state)``, ``flags`` an
    int32 device scalar. The three kinds are mutually exclusive (checked
    in severity order); an anomalous step never updates the EWMA
    baseline."""
    ewma, count = state
    loss32 = loss.float()
    finite_loss = torch.isfinite(loss32)
    finite_norm = torch.isfinite(gnorm)
    nan_loss = ~finite_loss
    nan_grad = finite_loss & ~finite_norm
    warmed = (count >= WARMUP_STEPS) & (ewma >= EWMA_FLOOR)
    spike = finite_loss & finite_norm & warmed & (gnorm > spike_factor * ewma)
    flags = (nan_loss.to(torch.int32) * NAN_LOSS
             | nan_grad.to(torch.int32) * NAN_GRAD
             | spike.to(torch.int32) * SPIKE)
    anomalous = flags > 0
    seeded = torch.where(count > 0,
                         (1.0 - EWMA_ALPHA) * ewma + EWMA_ALPHA * gnorm,
                         gnorm)
    new_ewma = torch.where(anomalous, ewma, seeded)
    new_count = torch.where(anomalous, count, count + 1.0)
    return flags, (new_ewma, new_count)


def _scale(grads: Sequence[torch.Tensor], factor: torch.Tensor) -> None:
    """``g *= factor`` in place, the factor cast to each gradient's dtype
    (as ``g * factor.astype(g.dtype)`` in the JAX module)."""
    cast: Dict[torch.dtype, torch.Tensor] = {}
    for g in grads:
        if g.dtype not in cast:
            cast[g.dtype] = factor.to(g.dtype)
        g.mul_(cast[g.dtype])


def clip_scale(gnorm: torch.Tensor, clip: float):
    """``(scale, engaged)`` of the global-norm clip at ``clip``: the
    factor that brings the norm to at most ``clip`` (1 for a non-finite
    norm) and whether it rescales (a bool device scalar)."""
    finite = torch.isfinite(gnorm)
    scale = torch.where(finite,
                        torch.clamp(clip / torch.clamp(gnorm, min=1e-16),
                                    max=1.0),
                        torch.ones_like(gnorm))
    return scale, finite & (gnorm > clip)


def clip_by_global_norm(grads: Sequence[torch.Tensor], gnorm: torch.Tensor,
                        clip: float) -> torch.Tensor:
    """Scale ``grads`` in place so their global norm is at most ``clip``;
    returns ``engaged`` (a bool device scalar). A non-finite norm leaves
    the gradients untouched and ``engaged`` false: the divergence stays
    visible (and flagged) instead of being zeroed by the clipper."""
    scale, engaged = clip_scale(gnorm, clip)
    _scale(grads, scale)
    return engaged


def inject_grads(loss: torch.Tensor, grads: Sequence[torch.Tensor],
                 code: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Apply a ``train.grads`` fault-plan entry on the device (chaos only:
    in the step only when ``zoo.faults.enabled`` was set when the loop
    resolved its sentinel). ``code`` follows :data:`FAULT_CODES` and
    ``scale`` is the spike multiplier, both f32 device scalars; the
    gradients are poisoned in place and the loss is returned. ``code ==
    0`` leaves every value's bits as they were (a multiply by 1)."""
    loss = torch.where(code == FAULT_CODES["nan_loss"],
                       torch.full_like(loss, float("nan")), loss)
    f = torch.where(code == FAULT_CODES["nan_grad"],
                    torch.full_like(scale, float("nan")),
                    torch.ones_like(scale))
    f = torch.where(code == FAULT_CODES["spike"], scale, f)
    _scale(grads, f)
    return loss


# ---------------------------------------------------------------------------
# host-side decode
# ---------------------------------------------------------------------------

def kinds_of(flags: int) -> List[str]:
    """Metric labels for a packed flag word (empty when healthy)."""
    return [kind for bit, kind in KIND_BITS if flags & bit]
