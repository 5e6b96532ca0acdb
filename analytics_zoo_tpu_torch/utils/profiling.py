"""Profiling and performance accounting — port of ``analytics_zoo_tpu/
utils/profiling.py`` for torch on NVIDIA cards: the replacement for the
reference's scoped timers (``Utils.timeIt``, ``EstimateSupportive``) with
``torch.profiler`` trace capture and achieved-MFU accounting.

* :func:`device_peak_flops`: the card's published dense peak for a dtype,
  by ``torch.cuda.get_device_name`` (``None`` on the CPU or another
  card).
* :func:`compiled_flops`: the FLOPs of one call, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` (matmuls, convolutions and
  attention, forward and backward as the call runs them; XLA's cost
  analysis, which the JAX package reads, also counts elementwise work).
* :func:`mfu`, :func:`trace` and :class:`Timer`.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Dict, Optional

import torch

log = logging.getLogger("analytics_zoo_tpu_torch.profiling")

#: Published dense peaks (FLOP/s, without sparsity) by
#: ``torch.cuda.get_device_name`` and dtype: the H100 SXM's (NVIDIA's data
#: sheet, at 700 W), the card the port runs on. Any other card reads None.
PEAK_FLOPS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "float16": 989e12,
                              "float32": 67e12, "tf32": 495e12,
                              "int8": 1979e12},
}

_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.float32: "float32", torch.int8: "int8"}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return _DTYPE_NAMES.get(dtype, str(dtype))
    return str(dtype)


def device_peak_flops(device=None, dtype="bfloat16") -> Optional[float]:
    """The card's published dense peak FLOP/s for ``dtype`` (a name or a
    torch dtype; float32 with TF32 on reads the TF32 peak); None on the
    CPU, without CUDA, or for a card not in :data:`PEAK_FLOPS`."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    kind = _dtype_name(dtype)
    if kind == "float32" and torch.backends.cuda.matmul.allow_tf32:
        kind = "tf32"
    return PEAK_FLOPS.get(torch.cuda.get_device_name(device), {}).get(kind)


def compiled_flops(fn: Callable, *args, **kwargs) -> Optional[float]:
    """The FLOPs of one call ``fn(*args, **kwargs)``, as
    ``FlopCounterMode`` counts them while it runs; None when it counted
    nothing or the call failed."""
    from torch.utils.flop_counter import FlopCounterMode
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
    except Exception:   # never fail a caller for an accounting pass
        log.debug("FLOP count failed", exc_info=True)
        return None
    flops = counter.get_total_flops()
    return float(flops) if flops > 0 else None


def mfu(flops_per_sec: float, n_devices: Optional[int] = None,
        dtype="bfloat16") -> Optional[float]:
    """Achieved model-FLOPs utilization of sustained ``flops_per_sec``
    across ``n_devices`` cards (default: every visible card) against the
    published peak for ``dtype``. None where the peak is unknown."""
    peak = device_peak_flops(dtype=dtype)
    if peak is None:
        return None
    n = n_devices if n_devices is not None else torch.cuda.device_count()
    return flops_per_sec / (peak * n)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the block (CPU, and CUDA where there is
    a card) written to ``log_dir`` as a Chrome trace for TensorBoard's
    profile plugin; no-op when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
    log.info("profiler trace written to %s", log_dir)


class Timer:
    """Scoped wall-clock timer with named laps — the ``timeIt`` role."""

    def __init__(self):
        self.laps: Dict[str, float] = {}

    @contextlib.contextmanager
    def lap(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.laps[name] = self.laps.get(name, 0.0) + time.perf_counter() - t0
