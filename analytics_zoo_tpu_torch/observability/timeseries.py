"""Bounded in-process time series — the telemetry plane's storage; a
copy of ``analytics_zoo_tpu/observability/timeseries.py`` (pure Python).

Everything upstream of alerting needs history: a scrape is a point, but
``rate()``, burn rates, and saturation trends are functions of a window.
This module keeps that window in a **fixed-capacity ring buffer per
series** — O(1) append, retention = ``capacity × sample interval``, and
no unbounded growth no matter how long the process lives (the same
bounded-queue discipline zoolint's ZL011 enforces on work queues).

Three layers:

* :class:`RingBuffer` — the storage primitive: a preallocated circular
  array of ``(ts, value)`` points.
* :class:`TimeSeriesStore` — series keyed by the same
  ``name{k="v",...}`` strings :meth:`MetricsRegistry.snapshot` emits,
  each carrying its family kind, with the derived-signal queries:
  :meth:`~TimeSeriesStore.rate` (counter-reset aware),
  :meth:`~TimeSeriesStore.avg`/``max``/``min`` over a window for
  gauges, :meth:`~TimeSeriesStore.slope` (the depth-trend signal the
  autoscaler wants), and :meth:`~TimeSeriesStore.quantile` —
  quantile-over-window by rehydrating each scrape's quantile points
  into a :class:`QuantileDigest` weighted by its count **delta** and
  merging (so the window distribution weights each scrape by the
  traffic it actually saw).
* :class:`RegistrySampler` — a daemon thread snapshotting a local
  :class:`MetricsRegistry` into a store on a cadence
  (``zoo.telemetry.sample_interval_s``).

Samples are scalars for counters/gauges, ``(count, sum)`` pairs for
histograms, and :class:`SummarySample` (cumulative count/sum + the
scrape-time quantile points) for summaries.

``rehydrate_digest`` — the fleet-rollup rehydration that turns scraped
``(quantile, value)`` points back into a mergeable digest — lives here
(the status CLI, ``serving/status.py``, imports it through
``collector``), because quantile-over-window is the same operation as
the fleet quantile merge: weight points by mass, merge.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .metrics import MetricsRegistry, QuantileDigest

log = logging.getLogger("analytics_zoo_tpu_torch.observability")

__all__ = [
    "RingBuffer", "SummarySample", "TimeSeriesStore", "RegistrySampler",
    "rehydrate_digest", "family_of",
]


def _conf(key: str, default):
    """Config read through the zoo context when one is live; the default
    otherwise (keeps this module importable without the context)."""
    try:
        from ..common.context import get_zoo_context
        return get_zoo_context().get(key, default)
    except Exception:
        return default


def family_of(key: str) -> str:
    """The metric family of a series key: ``name{k="v"}`` → ``name``."""
    return key.split("{", 1)[0]


def rehydrate_digest(qs: Dict[str, float], count: float,
                     budget: int = 64) -> QuantileDigest:
    """An approximate :class:`QuantileDigest` from scraped quantile
    points ``{quantile_str: value}``: each (q, v) point carries the
    probability mass between the midpoints of its neighboring
    quantiles, scaled by ``count``. Merging these weights every
    source by its actual traffic — the property a naive percentile
    average lacks.
    """
    d = QuantileDigest(budget)
    pts = sorted((float(q), v) for q, v in qs.items() if v == v)
    if not pts or count <= 0:
        return d
    mids = [(pts[i][0] + pts[i + 1][0]) / 2.0 for i in range(len(pts) - 1)]
    bounds = [0.0] + mids + [1.0]
    for (q, v), lo, hi in zip(pts, bounds, bounds[1:]):
        w = (hi - lo) * count
        if w > 0:
            d.add(v, w)
    return d


class RingBuffer:
    """Fixed-capacity circular buffer of ``(ts, value)`` points.

    Preallocated; :meth:`append` is O(1) and overwrites the oldest
    point once full. Not thread-safe on its own — the store serializes
    access under its lock.
    """

    __slots__ = ("_ts", "_vals", "_cap", "_head", "_len")

    def __init__(self, capacity: int):
        if capacity < 2:
            raise ValueError("RingBuffer capacity must be >= 2 "
                             "(rates need two points)")
        self._cap = int(capacity)
        self._ts: List[float] = [0.0] * self._cap
        self._vals: List[Any] = [None] * self._cap
        self._head = 0          # next write slot
        self._len = 0

    def __len__(self) -> int:
        return self._len

    @property
    def capacity(self) -> int:
        return self._cap

    def append(self, ts: float, value: Any) -> None:
        self._ts[self._head] = ts
        self._vals[self._head] = value
        self._head = (self._head + 1) % self._cap
        if self._len < self._cap:
            self._len += 1

    def last(self) -> Optional[Tuple[float, Any]]:
        if not self._len:
            return None
        i = (self._head - 1) % self._cap
        return self._ts[i], self._vals[i]

    def items(self) -> List[Tuple[float, Any]]:
        """Chronological ``[(ts, value), ...]`` (oldest first)."""
        if self._len < self._cap:
            idx = range(self._len)
        else:
            idx = ((self._head + i) % self._cap for i in range(self._cap))
        return [(self._ts[i], self._vals[i]) for i in idx]

    def since(self, t0: float) -> List[Tuple[float, Any]]:
        """Chronological points with ``ts >= t0``."""
        return [(t, v) for t, v in self.items() if t >= t0]


class SummarySample:
    """One scrape of a summary family: cumulative ``count``/``sum`` and
    the scrape-time quantile points ``{quantile_str: value}``."""

    __slots__ = ("count", "sum", "points")

    def __init__(self, count: float, sum: float,
                 points: Dict[str, float]):
        self.count = float(count)
        self.sum = float(sum)
        self.points = dict(points)

    def __repr__(self):
        return (f"SummarySample(count={self.count:g}, sum={self.sum:g}, "
                f"points={self.points})")


#: sentinel kinds a series can carry (mirrors the registry kinds)
_KINDS = ("counter", "gauge", "histogram", "summary")


class TimeSeriesStore:
    """Bounded per-series history plus the derived-signal queries.

    Series keys are the ``name`` / ``name{k="v",...}`` strings
    :meth:`MetricsRegistry.snapshot` emits, so a sampler can feed a
    snapshot straight in; the collector uses the same keys with a
    ``replica=`` label prepended for per-replica series.

    Retention is ``capacity`` points per series; with the default
    cadence (``zoo.telemetry.sample_interval_s``) the defaults hold
    ``zoo.telemetry.retention_s`` of history. The series *map* is
    bounded by the metric catalog (families × bounded label sets), the
    same cardinality discipline ZL015 enforces at registration sites.
    """

    def __init__(self, retention_s: Optional[float] = None,
                 sample_interval_s: Optional[float] = None,
                 capacity: Optional[int] = None):
        interval = float(sample_interval_s if sample_interval_s is not None
                         else _conf("zoo.telemetry.sample_interval_s", 1.0))
        retention = float(retention_s if retention_s is not None
                          else _conf("zoo.telemetry.retention_s", 900.0))
        if capacity is None:
            capacity = max(2, int(round(retention / max(interval, 1e-6))) + 1)
        self.capacity = int(capacity)
        self.sample_interval_s = interval
        self.retention_s = retention
        self._lock = threading.Lock()
        self._series: Dict[str, RingBuffer] = {}
        self._kinds: Dict[str, str] = {}

    # -- ingest --------------------------------------------------------------
    def record(self, key: str, kind: str, ts: float, value: Any) -> None:
        """O(1) append of one point to one series (created on first
        touch)."""
        if kind not in _KINDS:
            raise ValueError(f"unknown series kind {kind!r}")
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                ring = self._series[key] = RingBuffer(self.capacity)
                self._kinds[key] = kind
            ring.append(ts, value)

    def ingest_snapshot(self, snapshot: Dict[str, Any], ts: float) -> int:
        """Feed one :meth:`MetricsRegistry.snapshot` dict in; returns
        the number of series touched."""
        n = 0
        for key, entry in snapshot.items():
            kind = entry.get("type")
            if kind in ("counter", "gauge"):
                self.record(key, kind, ts, float(entry["value"]))
            elif kind == "histogram":
                self.record(key, kind, ts,
                            (float(entry.get("count", 0)),
                             float(entry.get("sum", 0.0))))
            elif kind == "summary":
                self.record(key, kind, ts, SummarySample(
                    entry.get("count", 0), entry.get("sum", 0.0),
                    entry.get("quantiles", {})))
            else:
                continue
            n += 1
        return n

    # -- introspection -------------------------------------------------------
    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def kind(self, key: str) -> Optional[str]:
        with self._lock:
            return self._kinds.get(key)

    def series_for(self, family: str) -> List[str]:
        """Every series key of one family (``name`` or
        ``name{...}``)."""
        with self._lock:
            return sorted(k for k in self._series
                          if family_of(k) == family)

    def latest(self, key: str) -> Optional[Tuple[float, Any]]:
        with self._lock:
            ring = self._series.get(key)
            return ring.last() if ring is not None else None

    def window(self, key: str, window_s: float,
               now: Optional[float] = None) -> List[Tuple[float, Any]]:
        """Chronological points of one series within the last
        ``window_s`` seconds (anchored at ``now`` or the newest
        point)."""
        with self._lock:
            ring = self._series.get(key)
            if ring is None or not len(ring):
                return []
            if now is None:
                now = ring.last()[0]
            return ring.since(now - window_s)

    # -- derived signals -----------------------------------------------------
    def rate(self, key: str, window_s: float,
             now: Optional[float] = None) -> Optional[float]:
        """Per-second increase of a counter over the window,
        counter-reset aware: negative deltas (a restarted replica)
        contribute the post-reset value instead of going negative —
        the Prometheus ``rate()`` convention. Histogram series rate
        their count. ``None`` until two points span the window."""
        pts = self.window(key, window_s, now)
        if len(pts) < 2:
            return None
        vals = [p[1][0] if isinstance(p[1], tuple) else float(p[1])
                for p in pts]
        span = pts[-1][0] - pts[0][0]
        if span <= 0:
            return None
        inc = 0.0
        for a, b in zip(vals, vals[1:]):
            inc += (b - a) if b >= a else b     # reset: restart from 0
        return inc / span

    def _gauge_vals(self, key: str, window_s: float,
                    now: Optional[float]) -> List[float]:
        return [float(v) for _, v in self.window(key, window_s, now)
                if isinstance(v, (int, float))]

    def avg(self, key: str, window_s: float,
            now: Optional[float] = None) -> Optional[float]:
        vals = self._gauge_vals(key, window_s, now)
        return sum(vals) / len(vals) if vals else None

    def max(self, key: str, window_s: float,
            now: Optional[float] = None) -> Optional[float]:
        vals = self._gauge_vals(key, window_s, now)
        return max(vals) if vals else None

    def min(self, key: str, window_s: float,
            now: Optional[float] = None) -> Optional[float]:
        vals = self._gauge_vals(key, window_s, now)
        return min(vals) if vals else None

    def slope(self, key: str, window_s: float,
              now: Optional[float] = None) -> Optional[float]:
        """Least-squares slope (units/second) of a gauge over the
        window — the depth/backlog *trend* an autoscaler acts on
        (a positive depth slope under full utilization means falling
        behind; the level alone cannot say that)."""
        pts = [(t, float(v)) for t, v in self.window(key, window_s, now)
               if isinstance(v, (int, float))]
        if len(pts) < 2:
            return None
        t0 = pts[0][0]
        xs = [t - t0 for t, _ in pts]
        ys = [v for _, v in pts]
        n = float(len(pts))
        sx, sy = sum(xs), sum(ys)
        sxx = sum(x * x for x in xs)
        sxy = sum(x * y for x, y in zip(xs, ys))
        denom = n * sxx - sx * sx
        if denom <= 0:
            return None
        return (n * sxy - sx * sy) / denom

    def quantile(self, key: str, q: float, window_s: float,
                 now: Optional[float] = None) -> Optional[float]:
        """Quantile of a summary series **over the window**: each
        consecutive scrape pair contributes the newer scrape's quantile
        points weighted by the count delta between them (the traffic
        that arrived in that interval), rehydrated and merged. Falls
        back to the lifetime distribution of the newest scrape when the
        window saw no traffic. ``None`` with no data at all."""
        pts = [(t, v) for t, v in self.window(key, window_s, now)
               if isinstance(v, SummarySample)]
        if not pts:
            return None
        d = QuantileDigest(64)
        for (_, a), (_, b) in zip(pts, pts[1:]):
            delta = b.count - a.count
            if delta < 0:               # reset: the whole new count
                delta = b.count
            if delta > 0:
                d.merge(rehydrate_digest(b.points, delta))
        if not d.count:                 # no traffic in window: lifetime
            last = pts[-1][1]
            if not last.count:
                return None
            d = rehydrate_digest(last.points, last.count)
        if not d.count:
            return None
        return d.quantile(q)


class RegistrySampler:
    """Daemon thread snapshotting one :class:`MetricsRegistry` into a
    :class:`TimeSeriesStore` on a cadence — the local half of the
    telemetry plane (the collector is the fleet half).

    ``interval_s`` defaults to ``zoo.telemetry.sample_interval_s``;
    ``clock`` is injectable so tests drive deterministic timestamps via
    :meth:`sample_once`.
    """

    def __init__(self, registry: MetricsRegistry,
                 store: Optional[TimeSeriesStore] = None,
                 interval_s: Optional[float] = None,
                 clock=None):
        import time as _time
        self.registry = registry
        self.store = store if store is not None else TimeSeriesStore(
            sample_interval_s=interval_s)
        self.interval_s = float(
            interval_s if interval_s is not None
            else _conf("zoo.telemetry.sample_interval_s", 1.0))
        self._clock = clock if clock is not None else _time.time
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples_taken = 0

    def sample_once(self, now: Optional[float] = None) -> int:
        """One synchronous snapshot→store pass; returns series
        touched."""
        ts = self._clock() if now is None else now
        n = self.store.ingest_snapshot(
            self.registry.snapshot(compact=True), ts)
        self.samples_taken += 1
        return n

    def start(self) -> "RegistrySampler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="zoo-telemetry-sampler", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:           # never kill the sampler thread
                log.exception("registry sampler tick failed")

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
