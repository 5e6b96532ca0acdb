"""Goodput/badput accounting — where the wall clock of a run went; a
copy of ``analytics_zoo_tpu/observability/goodput.py`` (pure Python).

The registry answers "what is happening"; this module answers "what it
costs": a :class:`GoodputLedger` attributes **every
second** of a training run or a serving replica's lane loop to exactly
one category, so ``goodput + Σ badput == wall time`` holds by
construction (the acceptance tests reconcile it exactly under injected
fault plans).

Categories are role-scoped and exclusive:

* ``train`` — ``device_step`` (goodput) vs ``data_wait`` / ``compile``
  / ``ckpt_stall`` / ``rollback_replay`` / ``restart`` /
  ``anomaly_skip`` / ``idle``,
* ``serve`` — ``device_dispatch`` (goodput) vs ``host_decode`` /
  ``publish`` / ``shed`` / ``idle``.

The accounting model is **interval attribution**: the ledger keeps one
monotonic mark; ``note(category)`` attributes the interval since the
mark to that category and advances the mark. Because every interval is
attributed exactly once and intervals tile the open→last-note span,
exclusivity and the wall-time invariant cannot drift — there is no
"unaccounted" bucket to leak into. Instrumentation therefore only has
to call ``note`` at phase boundaries on the loop thread (training:
the prefetch stream wrapper, the checkpoint manager's synchronous
window, the retry/rollback handlers; serving: the lane loop's
read/shed/route/pump seams).

Exported metric families: ``zoo_goodput_ratio``,
``zoo_goodput_seconds_total``, ``zoo_badput_seconds_total{category=}``.
The :class:`~.timeseries.RegistrySampler` picks the counters up like
any family, so windowed rates/slopes per category come for free in the
:class:`~.timeseries.TimeSeriesStore`; ``/statusz`` surfaces the same
numbers in its ``performance`` block.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from .metrics import MetricsRegistry, default_registry

__all__ = ["GoodputLedger", "TRAIN_CATEGORIES", "SERVE_CATEGORIES",
           "GOOD_CATEGORY", "goodput_enabled", "registry_snapshot"]

#: exclusive wall-time categories per role; the FIRST entry is goodput
TRAIN_CATEGORIES = ("device_step", "data_wait", "compile", "ckpt_stall",
                    "rollback_replay", "restart", "anomaly_skip", "idle")
SERVE_CATEGORIES = ("device_dispatch", "host_decode", "publish", "shed",
                    "idle")
GOOD_CATEGORY = {"train": "device_step", "serve": "device_dispatch"}


def _conf(key: str, default):
    """Config read through the zoo context when one is live; the default
    otherwise (keeps this module importable without the context)."""
    try:
        from ..common.context import get_zoo_context
        return get_zoo_context().get(key, default)
    except Exception:
        return default


def goodput_enabled() -> bool:
    """Whether the instrumented loops should keep a ledger
    (``zoo.goodput.enabled``, default on — the accounting is a handful
    of ``perf_counter`` reads per step)."""
    return bool(_conf("zoo.goodput.enabled", True))


class GoodputLedger:
    """Attributes wall-clock intervals to exclusive categories.

    ``note(category)`` charges everything since the previous note (or
    :meth:`open`) to ``category``. All notes must come from the loop
    thread being accounted; readers (``/statusz``, tests) may call the
    query methods from any thread. ``clock`` is injectable so tests
    drive the ledger tick by tick and reconcile exactly.
    """

    def __init__(self, role: str = "train",
                 registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.perf_counter):
        if role not in GOOD_CATEGORY:
            raise ValueError(f"role must be 'train' or 'serve', got {role!r}")
        self.role = role
        self.categories = (TRAIN_CATEGORIES if role == "train"
                           else SERVE_CATEGORIES)
        self.good = GOOD_CATEGORY[role]
        self.registry = registry if registry is not None \
            else default_registry()
        self._clock = clock
        self._lock = threading.Lock()
        self._mark: Optional[float] = None
        self._opened: Optional[float] = None
        self._seconds: Dict[str, float] = {c: 0.0 for c in self.categories}
        self._m_ratio = self.registry.gauge(
            "zoo_goodput_ratio",
            "goodput seconds / attributed wall seconds of the accounted "
            "loop (train: device_step; serve: device_dispatch)")
        self._m_good = self.registry.counter(
            "zoo_goodput_seconds_total",
            "wall-clock seconds attributed to the goodput category "
            "(goodput + sum of zoo_badput_seconds_total == wall time)")
        self._m_badput: Dict[str, object] = {}
        for cat in ("data_wait", "compile", "ckpt_stall", "rollback_replay",
                    "restart", "anomaly_skip", "idle", "host_decode",
                    "publish", "shed"):
            if cat in self._seconds and cat != self.good:
                self._m_badput[cat] = self.registry.counter(
                    "zoo_badput_seconds_total",
                    "wall-clock seconds attributed to a non-goodput "
                    "category; exclusive — every accounted second lands "
                    "in exactly one category",
                    labels={"category": cat})

    # -- accounting ----------------------------------------------------------
    def open(self, now: Optional[float] = None) -> None:
        """(Re)start attribution at ``now`` — the next :meth:`note`
        charges from here. Accumulated seconds are kept (a retry
        attempt continues the same run's ledger)."""
        now = self._clock() if now is None else now
        with self._lock:
            self._mark = now
            if self._opened is None:
                self._opened = now

    def note(self, category: str, now: Optional[float] = None) -> float:
        """Attribute ``[mark, now)`` to ``category``, advance the mark,
        and update the exported metrics. Returns the seconds attributed
        (0.0 on the first note of an unopened ledger, which just arms
        the mark)."""
        if category not in self._seconds:
            raise ValueError(
                f"unknown category {category!r} for role {self.role!r} "
                f"(one of {self.categories})")
        now = self._clock() if now is None else now
        with self._lock:
            if self._mark is None:
                self._mark = now
                if self._opened is None:
                    self._opened = now
                return 0.0
            dt = max(now - self._mark, 0.0)
            self._mark = now
            self._seconds[category] += dt
            if category == self.good:
                self._m_good.inc(dt)
            else:
                self._m_badput[category].inc(dt)
            wall = sum(self._seconds.values())
            if wall > 0:
                self._m_ratio.set(self._seconds[self.good] / wall)
            return dt

    # -- queries -------------------------------------------------------------
    def seconds(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._seconds)

    def wall(self) -> float:
        """Total attributed seconds — equals the open→last-note span."""
        with self._lock:
            return sum(self._seconds.values())

    def goodput_seconds(self) -> float:
        with self._lock:
            return self._seconds[self.good]

    def badput_seconds(self) -> Dict[str, float]:
        with self._lock:
            return {c: s for c, s in self._seconds.items()
                    if c != self.good}

    def ratio(self) -> float:
        with self._lock:
            wall = sum(self._seconds.values())
            return self._seconds[self.good] / wall if wall > 0 else 0.0

    def snapshot(self) -> Dict[str, object]:
        """The JSON-able block ``/statusz`` and a benchmark record embed."""
        with self._lock:
            wall = sum(self._seconds.values())
            return {
                "role": self.role,
                "ratio": (self._seconds[self.good] / wall
                          if wall > 0 else None),
                "wall_s": wall,
                "seconds": dict(self._seconds),
            }


def registry_snapshot(registry: Optional[MetricsRegistry] = None
                      ) -> Dict[str, object]:
    """Goodput families read back off a registry — for consumers that
    see only the metrics (``/statusz`` of another process, benchmark
    rounds) rather than the ledger object. Returns ``{"ratio",
    "goodput_s", "badput_s": {category: seconds}}``; ratio is ``None``
    when no ledger ever exported. Several ledgers may export into one
    registry (a benchmark round runs a fit loop AND serving replicas), so
    the ratio is recomputed from the summed seconds — the per-ledger
    ``zoo_goodput_ratio`` gauge is last-writer-wins and would misstate
    the aggregate; it is used only before any seconds accumulate."""
    reg = registry if registry is not None else default_registry()
    ratio = None
    good = 0.0
    bad: Dict[str, float] = {}
    seen = False
    for m in reg.metrics():
        if m.name == "zoo_goodput_ratio":
            ratio = m.value
            seen = True
        elif m.name == "zoo_goodput_seconds_total":
            good += m.value
            seen = True
        elif m.name == "zoo_badput_seconds_total":
            cat = dict(m.labels).get("category", "")
            bad[cat] = bad.get(cat, 0.0) + m.value
            seen = True
    if not seen:
        return {"ratio": None, "goodput_s": 0.0, "badput_s": {}}
    wall = good + sum(bad.values())
    if wall > 0:
        ratio = good / wall
    return {"ratio": ratio, "goodput_s": good, "badput_s": bad}
