"""Compilation observability — the port's counterpart of
``analytics_zoo_tpu/observability/compile.py``, under the same metric
and event names: the answer to "why did this step suddenly take 40x
longer?".

The port has no jit. What compiles here, and what these series count:

* each CUDA-graph capture of a training ``StepProgram``
  (``pipeline/api/keras/dispatch.py``): ``fn="train.scan_chunk"`` on the
  streamed path, ``fn="train.epoch"`` on the device-cached path. A
  capture for a new ``k`` (steps a replay) of a program that already
  captured one counts as a retrace, as the JAX loop's short tail chunk
  recompiles its scan;
* each kernel library build by ``nvcc`` (``ops/cuda_build.py``;
  ``fn=<library>``).

Every compile counts in ``zoo_jit_compile_total`` (process-wide), its
wall time goes into ``zoo_jit_compile_seconds{fn=...}`` with a
``jit.compile`` event; a compile under a NEW signature of a tracker that
had compiled before adds ``zoo_jit_retrace_total{fn=...}`` and a
``jit.retrace`` event.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from .metrics import MetricsRegistry, default_registry

__all__ = ["CompileTracker", "record_compile"]


class CompileTracker:
    """The compile accounting of one compiled entry point (``name``): the
    signatures it compiled under so far. ``registry=None`` resolves the
    default registry at each compile (a test's reset is honored)."""

    def __init__(self, name: str, registry: Optional[MetricsRegistry] = None):
        self.name = name
        self._registry = registry
        self._seen: set = set()
        self._lock = threading.Lock()

    def record(self, signature: Any, dur: float) -> None:
        """One compile under ``signature`` that took ``dur`` seconds."""
        with self._lock:
            fresh = signature not in self._seen
            if fresh:
                self._seen.add(signature)
            n_sigs = len(self._seen)
        reg = (self._registry if self._registry is not None
               else default_registry())
        reg.counter(
            "zoo_jit_compile_total",
            "XLA compilations across all instrumented entry points").inc()
        # fn = a compiled entry point's constant name (a handful)
        reg.histogram(  # zoolint: disable=ZL015 bounded label set
            "zoo_jit_compile_seconds",
            "first-dispatch wall time per compilation "
            "(trace+compile dominated)",
            labels={"fn": self.name}).observe(dur)
        reg.emit("jit.compile", fn=self.name, dur_s=dur, n_signatures=n_sigs)
        if fresh and n_sigs > 1:
            # fn = a compiled entry point's constant name (a handful)
            reg.counter(  # zoolint: disable=ZL015 bounded label set
                "zoo_jit_retrace_total",
                "recompilations of an already-compiled function under a "
                "new abstract signature",
                labels={"fn": self.name}).inc()
            reg.emit("jit.retrace", fn=self.name, dur_s=dur,
                     n_signatures=n_sigs)


def record_compile(name: str, dur: float, signature: Any = None,
                   registry: Optional[MetricsRegistry] = None) -> None:
    """A one-off compile (a kernel library build): counted, timed and
    emitted under ``fn=name``; never a retrace."""
    CompileTracker(name, registry).record(signature, dur)
