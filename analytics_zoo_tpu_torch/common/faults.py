"""Deterministic fault injection — a copy of
``analytics_zoo_tpu/common/faults.py`` (pure Python; the port cannot
import the JAX package, whose ``__init__`` loads jax).

A test (or a staging run) declares a **seeded, deterministic plan** of
faults to fire at named sites, then reconciles the recovery metrics
*exactly* against what the plan actually fired:

>>> plan = FaultPlan(seed=7)
>>> plan.add("profiler.capture", "error", at=(0,))
>>> with faults.activate(plan):
...     arm_and_assert_degraded()
>>> assert len(plan.fired) == 1

Fault kinds:

* ``error``      — raise (``exc`` or :class:`FaultError`),
* ``disconnect`` — raise ``ConnectionError`` (what a dropped Redis/TCP
  connection surfaces as),
* ``latency``    — sleep ``delay_s`` then proceed,
* ``partial_write`` / ``nan_loss`` / ``nan_grad`` / ``spike`` — no raise
  here; the SITE receives the spec back and applies its own semantics.

Sites are plain strings. The port's catalog so far (grep
``faults.inject``):

* ``LocalBackend``'s ``backend.xadd`` / ``backend.xread`` (fired by
  ``xread`` AND ``xreadgroup``: one site per serve-loop read in either
  mode) / ``backend.xack`` / ``backend.xclaim`` / ``backend.stream_len``
  / ``backend.set_result`` / ``backend.set_results`` (which also applies
  ``partial_write``),
* the serve loop's ``serving.loop`` (top of each iteration),
  ``serving.dispatch`` (before every model call, solo retries included)
  and ``serving.publish`` (one per published result batch, on the
  publisher thread: unlike ``backend.set_results`` it never hits the
  shed or error-record writes),
* the profiler trigger's ``profiler.capture``
  (``observability/profiler.py``: one fire per capture-arm attempt,
  before the trace starts — a capture failure degrades to a counter
  bump + event and must never kill the serve loop hosting the trigger).

The JAX package's RESP, checkpoint and training sites arrive with the
modules that hold them.

Determinism: each site keeps a 0-based call counter; a spec fires when
its site's counter is in ``at`` (or, for rate-based specs, when the
plan's seeded RNG draws below ``p`` — same seed, same draws). Every
firing is appended to ``plan.fired`` as ``(site, kind, call_index)``, the
ground truth chaos tests reconcile metrics against.

Activation is deliberately explicit: :func:`activate` refuses unless the
``zoo.faults.enabled`` context flag is set (``init_zoo_context(
faults_enabled=True)`` / ``ZOO_TPU_FAULTS_ENABLED=1``) — a production
process can never be chaos-injected by an import side effect. With no
plan active, :func:`inject` is one global read and a None test.
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from typing import List, Optional, Tuple

__all__ = ["FaultError", "FaultSpec", "FaultPlan", "activate", "inject",
           "active_plan", "KINDS"]

KINDS = ("error", "disconnect", "latency", "partial_write",
         "nan_loss", "nan_grad", "spike")


class FaultError(RuntimeError):
    """The default injected exception for ``kind="error"``."""


class FaultSpec:
    """One fault recipe bound to a site.

    ``at`` — iterable of 0-based call indices that fire (exact,
    deterministic). ``p`` — alternative rate-based trigger drawn from the
    plan's seeded RNG (deterministic given the seed and call order).
    ``delay_s`` — sleep for ``latency``. ``exc`` — exception INSTANCE to
    raise for ``error`` (a fresh ``FaultError`` per firing otherwise).
    ``fraction`` — for ``partial_write``, how much of the batch the site
    applies before failing. ``scale`` — for ``spike``, the gradient
    multiplier the ``train.grads`` site applies on device."""

    __slots__ = ("site", "kind", "at", "p", "delay_s", "exc", "fraction",
                 "scale")

    def __init__(self, site: str, kind: str, at=(), p: float = 0.0,
                 delay_s: float = 0.0, exc: Optional[BaseException] = None,
                 fraction: float = 0.5, scale: float = 1e4):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; one of {KINDS}")
        if not at and not p:
            raise ValueError(f"spec for {site!r} fires never: give at= "
                             f"call indices or a p= rate")
        self.site = site
        self.kind = kind
        self.at = frozenset(int(i) for i in at)
        self.p = float(p)
        self.delay_s = float(delay_s)
        self.exc = exc
        self.fraction = float(fraction)
        self.scale = float(scale)

    def __repr__(self) -> str:
        trig = f"at={sorted(self.at)}" if self.at else f"p={self.p}"
        return f"FaultSpec({self.site!r}, {self.kind!r}, {trig})"


class FaultPlan:
    """A seeded set of :class:`FaultSpec`\\ s plus the per-site call
    counters and the ``fired`` log. Thread-safe — sites fire from the
    serve loop, the publisher, and producer threads concurrently."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._specs: List[FaultSpec] = []
        self._calls: dict = {}
        self._lock = threading.Lock()
        #: ground truth for reconciliation: (site, kind, call_index)
        self.fired: List[Tuple[str, str, int]] = []

    def add(self, site: str, kind: str, **kw) -> "FaultPlan":
        self._specs.append(FaultSpec(site, kind, **kw))
        return self

    def calls(self, site: str) -> int:
        """How many times ``site`` has been reached so far."""
        with self._lock:
            return self._calls.get(site, 0)

    def fired_at(self, site: str) -> List[Tuple[str, str, int]]:
        with self._lock:
            return [f for f in self.fired if f[0] == site]

    def on_call(self, site: str) -> Optional[FaultSpec]:
        """Advance ``site``'s call counter; return the spec that fires at
        this call, if any (first match wins), recording it in ``fired``."""
        with self._lock:
            idx = self._calls.get(site, 0)
            self._calls[site] = idx + 1
            for spec in self._specs:
                if spec.site != site:
                    continue
                hit = idx in spec.at
                if not hit and spec.p:
                    hit = self._rng.random() < spec.p
                if hit:
                    self.fired.append((site, spec.kind, idx))
                    return spec
            return None


_PLAN: Optional[FaultPlan] = None
_ACTIVATE_LOCK = threading.Lock()


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


@contextmanager
def activate(plan: FaultPlan):
    """Install ``plan`` as the process-wide active plan for the block.
    Requires the ``zoo.faults.enabled`` context flag — fault injection
    must be an explicit deployment decision, never ambient."""
    from .context import get_zoo_context
    if not get_zoo_context().get("zoo.faults.enabled"):
        raise RuntimeError(
            "fault injection is disabled: set the zoo.faults.enabled "
            "context flag first (init_zoo_context(faults_enabled=True) "
            "or ZOO_TPU_FAULTS_ENABLED=1)")
    global _PLAN
    with _ACTIVATE_LOCK:
        if _PLAN is not None:
            raise RuntimeError("a fault plan is already active")
        _PLAN = plan
    try:
        yield plan
    finally:
        _PLAN = None


def inject(site: str) -> Optional[FaultSpec]:
    """The hook instrumented sites call. No-op (None) without an active
    plan or when no spec fires at this call. ``error``/``disconnect``
    raise; ``latency`` sleeps then returns None; ``partial_write``
    returns the spec for the site to interpret."""
    plan = _PLAN
    if plan is None:
        return None
    spec = plan.on_call(site)
    if spec is None:
        return None
    if spec.kind == "latency":
        time.sleep(spec.delay_s)
        return None
    if spec.kind == "error":
        raise spec.exc if spec.exc is not None \
            else FaultError(f"injected error at {site}")
    if spec.kind == "disconnect":
        raise ConnectionError(f"injected disconnect at {site}")
    # partial_write / nan_loss / nan_grad / spike: site-applied semantics
    return spec
