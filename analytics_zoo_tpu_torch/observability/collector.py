"""Fleet collector — port of ``analytics_zoo_tpu/observability/
collector.py``, the continuous half of fleet observability (pure Python).

``python -m analytics_zoo_tpu_torch.serving.status`` answers "how is the
fleet right now" when an operator runs it; :class:`FleetCollector` asks
the same question on a cadence and remembers the answers. It discovers
replicas from the fleet registry (each heartbeat carries the replica's
scrape ``endpoint``; explicit endpoints work without a registry),
scrapes every ``/metrics`` and ``/statusz`` under a per-target
:class:`~..common.reliability.RetryPolicy` and
:class:`~..common.reliability.CircuitBreaker`, and ingests into two
:class:`~.timeseries.TimeSeriesStore`\\ s: per-replica series (the
series key with a ``replica=`` label) and fleet-aggregated series.

Aggregation per metric kind:

* **counters** — summed over every replica ever scraped, each at its
  last known value, so a replica that drops out never makes a fleet
  total dip;
* **gauges** — summed over the healthy replicas, except the
  enumerated-state gauges of :data:`GAUGE_MAX`, which take the worst;
* **summaries** — merged count-weighted through
  :func:`~.timeseries.rehydrate_digest` + ``QuantileDigest.merge``;
* **histograms** — counts and sums summed.

Every scrape attempt passes the ``collector.scrape`` fault site. The
aggregate serves over HTTP (:class:`FleetzServer`): ``/fleetz`` (the
JSON fleet page: per-replica health, fleet totals, windowed rates,
quantiles, alert states and the ``saturation`` block an autoscaler
reads), ``/metrics`` (the aggregated ``zoo_*`` families) and
``/healthz``. The collector's own metrics are
``zoo_collector_scrapes_total{outcome=}`` and
``zoo_collector_replicas_live``.

:func:`base_url`, :func:`summary_points`, :func:`fleet_rows` and
:func:`endpoint_rows` are the fleet rollup the status CLI
(``serving/status.py``) stands on.
"""

from __future__ import annotations

import http.server
import json
import logging
import threading
import time
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..common import faults
from ..common.reliability import CircuitBreaker, RetryPolicy
from .alerts import AlertEngine, AlertRule, StoreSignals
from .export import _fmt, parse_prometheus
from .metrics import MetricsRegistry, default_registry
from .timeseries import (SummarySample, TimeSeriesStore, family_of,
                         rehydrate_digest)

log = logging.getLogger("analytics_zoo_tpu_torch.observability")

__all__ = [
    "FleetCollector", "FleetSignals", "FleetzServer", "GAUGE_MAX",
    "base_url", "summary_points", "fleet_rows", "endpoint_rows",
    "collector_counter", "collector_gauge",
]

#: enumerated-state gauge families aggregated by max (worst state wins
#: fleet-wide); every other gauge family sums
GAUGE_MAX = frozenset({"zoo_breaker_state", "zoo_alert_state"})

#: counter families the ``/fleetz`` ``rates`` block reports
RATE_FAMILIES = ("zoo_serving_records_total", "zoo_serving_shed_total",
                 "zoo_serving_failure_errors_total",
                 "zoo_serving_dlq_spilled_total")


def collector_counter(registry: MetricsRegistry, name: str,
                      help: str = "",
                      labels: Optional[Dict[str, str]] = None):
    """Register/fetch a counter for the collector plane."""
    return registry.counter(name, help, labels=labels)


def collector_gauge(registry: MetricsRegistry, name: str,
                    help: str = "",
                    labels: Optional[Dict[str, str]] = None):
    """Register/fetch a gauge for the collector plane (see
    :func:`collector_counter`)."""
    return registry.gauge(name, help, labels=labels)


def base_url(arg: str) -> str:
    """``host:port`` / bare port / URL → a scrapable base URL."""
    if arg.startswith("http://") or arg.startswith("https://"):
        return arg.rstrip("/").rsplit("/metrics", 1)[0]
    if ":" not in arg:                      # bare port
        arg = f"127.0.0.1:{arg}"
    return f"http://{arg}"


# ---------------------------------------------------------------------------
# fleet rollup helpers (the status CLI imports them)
# ---------------------------------------------------------------------------

def summary_points(families: Dict[str, Any],
                   name: str) -> Tuple[Dict[str, float], float]:
    """``({quantile_str: value}, count)`` for one scraped summary
    family."""
    samples = families[name]["samples"]
    qs = {lab["quantile"]: v for s_name, lab, v in samples
          if s_name == name and "quantile" in lab}
    count = next((v for s_name, _, v in samples
                  if s_name == name + "_count"), 0)
    return qs, count


def fleet_rows(scraped: Sequence[Tuple[Any, ...]]):
    """Roll several replicas' scrapes into fleet-wide
    ``(quantile_rows, scalar_rows)``: summaries merge through
    ``QuantileDigest`` (count-weighted rehydration), counters/gauges
    sum per labeled series, histograms report the mean of the summed
    sums/counts. ``scraped`` rows are ``(base, health, status,
    families)`` — the CLI's scrape tuple."""
    merged: Dict[str, list] = {}    # family -> [digest, count]
    sums: Dict[str, float] = {}     # scalar series -> value
    hist: Dict[str, list] = {}      # family -> [count, sum]
    for _base, _health, _status, families in scraped:
        for name in families:
            fam = families[name]
            if fam["type"] == "summary":
                qs, count = summary_points(families, name)
                if not count:
                    continue
                d = rehydrate_digest(qs, count)
                if name in merged:
                    merged[name][0].merge(d)
                    merged[name][1] += count
                else:
                    merged[name] = [d, count]
            elif fam["type"] in ("counter", "gauge"):
                for s_name, lab, v in fam["samples"]:
                    suffix = ("{" + ",".join(
                        f"{k}={vv}" for k, vv in lab.items()) + "}") \
                        if lab else ""
                    key = s_name + suffix
                    sums[key] = sums.get(key, 0.0) + v
            elif fam["type"] == "histogram":
                count = next((v for s_name, _, v in fam["samples"]
                              if s_name == name + "_count"), 0)
                total = next((v for s_name, _, v in fam["samples"]
                              if s_name == name + "_sum"), 0.0)
                h = hist.setdefault(name, [0, 0.0])
                h[0] += count
                h[1] += total
    quantile_rows = [
        (name, count, *(d.quantile(q) * 1000.0 for q in (0.5, 0.95, 0.99)))
        for name, (d, count) in sorted(merged.items())]
    scalar_rows = sorted(sums.items())
    scalar_rows += [(name + " (mean)", h[1] / h[0])
                    for name, h in sorted(hist.items()) if h[0]]
    return quantile_rows, scalar_rows


def endpoint_rows(families: Dict[str, Any]):
    """One endpoint's ``(quantile_rows, scalar_rows)`` — exact
    quantile values straight off the scrape, no rehydration."""
    quantile_rows = []
    scalar_rows = []
    for name in sorted(families):
        fam = families[name]
        samples = fam["samples"]
        if fam["type"] == "summary":
            qs, count = summary_points(families, name)
            if count:
                quantile_rows.append(
                    (name, count, *(qs.get(k, float("nan")) * 1000.0
                                    for k in ("0.5", "0.95", "0.99"))))
        elif fam["type"] in ("counter", "gauge"):
            for s_name, lab, v in samples:
                suffix = ("{" + ",".join(f"{k}={vv}"
                                         for k, vv in lab.items())
                          + "}") if lab else ""
                scalar_rows.append((s_name + suffix, v))
        elif fam["type"] == "histogram":
            count = next((v for s_name, _, v in samples
                          if s_name == name + "_count"), 0)
            total = next((v for s_name, _, v in samples
                          if s_name == name + "_sum"), 0.0)
            if count:
                scalar_rows.append((name + " (mean)", total / count))
    return quantile_rows, scalar_rows


def _series_key(name: str, labels: Dict[str, str]) -> str:
    """The store key for one labeled sample — same format as
    ``MetricsRegistry.snapshot`` (labels sorted)."""
    if not labels:
        return name
    return name + "{" + ",".join(
        f'{k}="{v}"' for k, v in sorted(labels.items())) + "}"


class _Target:
    """Per-replica scrape state."""

    def __init__(self, endpoint: str, base: str,
                 breaker: CircuitBreaker):
        self.endpoint = endpoint
        self.base = base
        self.breaker = breaker
        self.healthy = False
        self.last_ok_ts: Optional[float] = None
        self.last_error: Optional[str] = None
        self.source = "static"          # or "registry"


class FleetSignals(StoreSignals):
    """The alert-rule signals view for fleet scope: the fleet store's
    derived signals plus replica health from the collector."""

    def __init__(self, collector: "FleetCollector"):
        super().__init__(collector.fleet_store, clock=collector._clock)
        self._collector = collector

    def replicas_down(self) -> Optional[float]:
        return float(self._collector.replicas_down())

    def replicas_live(self) -> Optional[float]:
        return float(self._collector.replicas_live())

    def saturated_fraction(self) -> Optional[float]:
        live = self._collector.replica_saturation()
        if not live:
            return None
        return sum(1.0 for sat in live.values() if sat) / len(live)


class FleetCollector:
    """The scrape→aggregate→alert loop. Construct, then either
    :meth:`start` the daemon thread or drive :meth:`poll` by hand
    (tests, the one-shot CLI)."""

    def __init__(self,
                 endpoints: Sequence[str] = (),
                 backend=None, stream: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 interval_s: Optional[float] = None,
                 retention_s: Optional[float] = None,
                 timeout_s: float = 5.0,
                 retry: Optional[RetryPolicy] = None,
                 breaker_threshold: int = 3,
                 breaker_reset_s: float = 5.0,
                 registry_ttl_s: Optional[float] = None,
                 rules: Optional[Sequence[AlertRule]] = None,
                 clock=time.time):
        from .timeseries import _conf
        self.registry = registry if registry is not None \
            else default_registry()
        self.interval_s = float(
            interval_s if interval_s is not None
            else _conf("zoo.telemetry.sample_interval_s", 1.0))
        self.timeout_s = float(timeout_s)
        self.backend = backend
        self.stream = stream
        self.registry_ttl_s = registry_ttl_s
        self._clock = clock
        self.retry = retry if retry is not None else RetryPolicy(
            max_attempts=2, base_delay=0.05, max_delay=0.5)
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_reset_s = float(breaker_reset_s)
        store_kw = dict(retention_s=retention_s,
                        sample_interval_s=self.interval_s)
        #: per-replica series (``replica=`` label on every key)
        self.replica_store = TimeSeriesStore(**store_kw)
        #: fleet-aggregated series (original keys)
        self.fleet_store = TimeSeriesStore(**store_kw)
        self._lock = threading.Lock()
        self._targets: Dict[str, _Target] = {}
        for ep in endpoints:
            self._ensure_target(ep, source="static")
        #: last-known good scrape per endpoint:
        #: ep -> (ts, families, status)
        self._last: Dict[str, Tuple[float, dict, dict]] = {}
        self._fleet_latest: Dict[str, Tuple[str, Any]] = {}
        self.signals = FleetSignals(self)
        self.alerts: Optional[AlertEngine] = None
        if rules:
            self.alerts = AlertEngine(rules, registry=self.registry,
                                      clock=clock)
        #: recent alert transitions, oldest first (bounded)
        self.transitions_log: List[dict] = []
        self.polls = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- target management ---------------------------------------------------
    def _ensure_target(self, endpoint: str, source: str) -> _Target:
        t = self._targets.get(endpoint)
        if t is None:
            t = _Target(endpoint, base_url(endpoint), CircuitBreaker(
                name=f"collector.{endpoint}",
                failure_threshold=self._breaker_threshold,
                reset_timeout=self._breaker_reset_s,
                registry=self.registry))
            self._targets[endpoint] = t
        t.source = source
        return t

    def _discover(self) -> List[_Target]:
        """Current targets: static endpoints plus live fleet-registry
        members advertising a scrape ``endpoint`` in their
        heartbeat."""
        if self.backend is not None and self.stream is not None:
            try:
                from ..serving.fleet import DEFAULT_TTL_S, live_members
                ttl = self.registry_ttl_s if self.registry_ttl_s \
                    is not None else DEFAULT_TTL_S
                members = live_members(self.backend, self.stream,
                                       ttl_s=ttl)
                for member in members.values():
                    ep = member.get("endpoint")
                    if ep:
                        with self._lock:
                            self._ensure_target(str(ep),
                                                source="registry")
            except Exception:   # a dead registry must not stop the scrape
                log.exception("fleet-registry discovery failed")
        with self._lock:
            return [self._targets[ep] for ep in sorted(self._targets)]

    # -- scraping ------------------------------------------------------------
    def _get(self, url: str) -> str:
        with urllib.request.urlopen(url, timeout=self.timeout_s) as r:
            return r.read().decode("utf-8")

    def _fetch(self, t: _Target) -> Tuple[dict, dict]:
        """One scrape attempt: the fault gate, then /metrics +
        /statusz. Runs inside the retry policy, so every attempt
        passes ``collector.scrape``."""
        faults.inject("collector.scrape")
        families = parse_prometheus(self._get(t.base + "/metrics"))
        status = json.loads(self._get(t.base + "/statusz"))
        return families, status

    def _scrape_target(self, t: _Target, now: float) -> bool:
        if not t.breaker.allow():
            collector_counter(   # bounded label set
                self.registry, "zoo_collector_scrapes_total",
                "fleet-collector scrape attempts per outcome",
                labels={"outcome": "breaker_open"}).inc()
            t.healthy = False
            return False
        try:
            families, status = self.retry.call(
                lambda: self._fetch(t), op="collector.scrape",
                registry=self.registry,
                classify=lambda e: isinstance(
                    e, (ConnectionError, OSError, ValueError)))
        except Exception as e:
            t.breaker.record_failure()
            t.healthy = False
            t.last_error = f"{type(e).__name__}: {e}"
            collector_counter(   # bounded label set
                self.registry, "zoo_collector_scrapes_total",
                "fleet-collector scrape attempts per outcome",
                labels={"outcome": "error"}).inc()
            return False
        t.breaker.record_success()
        t.healthy = True
        t.last_ok_ts = now
        t.last_error = None
        collector_counter(   # bounded label set
            self.registry, "zoo_collector_scrapes_total",
            "fleet-collector scrape attempts per outcome",
            labels={"outcome": "ok"}).inc()
        with self._lock:
            self._last[t.endpoint] = (now, families, status)
        self._ingest_replica(t.endpoint, families, status, now)
        return True

    def _ingest_replica(self, ep: str, families: dict, status: dict,
                        now: float) -> None:
        store = self.replica_store
        for name, fam in families.items():
            kind = fam["type"]
            if kind in ("counter", "gauge"):
                for s_name, lab, v in fam["samples"]:
                    labels = dict(lab)
                    labels["replica"] = ep
                    store.record(_series_key(s_name, labels), kind,
                                 now, v)
            elif kind == "summary":
                qs, count = summary_points(families, name)
                total = next((v for s_name, _, v in fam["samples"]
                              if s_name == name + "_sum"), 0.0)
                store.record(_series_key(name, {"replica": ep}),
                             "summary", now,
                             SummarySample(count, total, qs))
            elif kind == "histogram":
                count = next((v for s_name, _, v in fam["samples"]
                              if s_name == name + "_count"), 0)
                total = next((v for s_name, _, v in fam["samples"]
                              if s_name == name + "_sum"), 0.0)
                store.record(_series_key(name, {"replica": ep}),
                             "histogram", now, (count, total))
        # statusz-derived operational series (store-only: these are
        # /statusz facts, not catalog metric families, and the fleet
        # re-export page filters to zoo_* — see render_fleet_prometheus)
        sc = (status.get("serving") or {}).get("scaling") or {}
        for field, key in (("utilization", "statusz_utilization"),
                           ("stream_depth", "statusz_depth"),
                           ("pending_entries", "statusz_pending")):
            v = sc.get(field)
            if isinstance(v, (int, float)):
                store.record(_series_key(key, {"replica": ep}),
                             "gauge", now, float(v))

    # -- aggregation ---------------------------------------------------------
    def _aggregate(self, now: float) -> None:
        with self._lock:
            last = dict(self._last)
            healthy = {ep for ep, t in self._targets.items()
                       if t.healthy}
        sums: Dict[str, Tuple[str, float]] = {}
        maxes: Dict[str, float] = {}
        merged: Dict[str, list] = {}    # key -> [digest, count, sum]
        hist: Dict[str, list] = {}
        for ep, (_ts, families, status) in last.items():
            for name, fam in families.items():
                kind = fam["type"]
                if kind == "counter":
                    for s_name, lab, v in fam["samples"]:
                        key = _series_key(s_name, lab)
                        sums[key] = ("counter",
                                     sums.get(key, ("", 0.0))[1] + v)
                elif kind == "gauge":
                    if ep not in healthy:
                        continue        # stale gauges drop out
                    for s_name, lab, v in fam["samples"]:
                        key = _series_key(s_name, lab)
                        if family_of(key) in GAUGE_MAX:
                            maxes[key] = max(maxes.get(key, v), v)
                        else:
                            sums[key] = ("gauge",
                                         sums.get(key, ("", 0.0))[1] + v)
                elif kind == "summary":
                    qs, count = summary_points(families, name)
                    if not count:
                        continue
                    total = next((v for s_name, _, v in fam["samples"]
                                  if s_name == name + "_sum"), 0.0)
                    d = rehydrate_digest(qs, count)
                    if name in merged:
                        merged[name][0].merge(d)
                        merged[name][1] += count
                        merged[name][2] += total
                    else:
                        merged[name] = [d, count, total]
                elif kind == "histogram":
                    count = next((v for s_name, _, v in fam["samples"]
                                  if s_name == name + "_count"), 0)
                    total = next((v for s_name, _, v in fam["samples"]
                                  if s_name == name + "_sum"), 0.0)
                    h = hist.setdefault(name, [0, 0.0])
                    h[0] += count
                    h[1] += total
        latest: Dict[str, Tuple[str, Any]] = {}
        for key, (kind, v) in sums.items():
            latest[key] = (kind, v)
            self.fleet_store.record(key, kind, now, v)
        for key, v in maxes.items():
            latest[key] = ("gauge", v)
            self.fleet_store.record(key, "gauge", now, v)
        for name, (d, count, total) in merged.items():
            sample = SummarySample(count, total, {
                repr(q): d.quantile(q) for q in (0.5, 0.95, 0.99)
                if d.count})
            latest[name] = ("summary", sample)
            self.fleet_store.record(name, "summary", now, sample)
        for name, (count, total) in hist.items():
            latest[name] = ("histogram", (count, total))
            self.fleet_store.record(name, "histogram", now,
                                    (count, total))
        # fleet depth (statusz-derived, healthy replicas): the series
        # the saturation block's depth slope reads
        depth = self._healthy_scaling_sum("stream_depth")
        if depth is not None:
            latest["statusz_depth"] = ("gauge", depth)
            self.fleet_store.record("statusz_depth", "gauge", now,
                                    depth)
        with self._lock:
            self._fleet_latest = latest

    def _healthy_scaling_sum(self, field: str) -> Optional[float]:
        vals = []
        with self._lock:
            for ep, t in self._targets.items():
                if not t.healthy or ep not in self._last:
                    continue
                sc = (self._last[ep][2].get("serving") or {}) \
                    .get("scaling") or {}
                v = sc.get(field)
                if isinstance(v, (int, float)):
                    vals.append(float(v))
        return sum(vals) if vals else None

    # -- the loop ------------------------------------------------------------
    def poll(self, now: Optional[float] = None) -> int:
        """One synchronous discover→scrape→aggregate→alert pass;
        returns the number of healthy replicas."""
        now = self._clock() if now is None else now
        targets = self._discover()
        ok = 0
        for t in targets:
            if self._scrape_target(t, now):
                ok += 1
        collector_gauge(
            self.registry, "zoo_collector_replicas_live",
            "fleet replicas the collector scraped successfully on its "
            "latest pass").set(float(ok))
        self._aggregate(now)
        if self.alerts is not None:
            transitions = self.alerts.evaluate(self.signals, now=now)
            if transitions:
                self.transitions_log.extend(transitions)
                del self.transitions_log[:-256]     # bounded log
        self.polls += 1
        return ok

    def start(self) -> "FleetCollector":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="zoo-fleet-collector", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll()
            except Exception:       # the loop outlives any bad scrape
                log.exception("collector poll failed")

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    # -- introspection -------------------------------------------------------
    def replicas_live(self) -> int:
        with self._lock:
            return sum(1 for t in self._targets.values() if t.healthy)

    def replicas_down(self) -> int:
        with self._lock:
            return sum(1 for t in self._targets.values()
                       if not t.healthy)

    def replica_saturation(self) -> Dict[str, bool]:
        """``{endpoint: saturated}`` for healthy replicas, derived
        from the ``/statusz`` overload block (backlog at or past the
        shed watermark)."""
        out: Dict[str, bool] = {}
        with self._lock:
            for ep, t in self._targets.items():
                if not t.healthy or ep not in self._last:
                    continue
                ov = (self._last[ep][2].get("serving") or {}) \
                    .get("overload") or {}
                wm = ov.get("shed_watermark") or 0
                depth = ov.get("stream_depth") or 0
                out[ep] = bool(wm) and depth >= wm
        return out

    def fleet_totals(self) -> Dict[str, float]:
        """Latest fleet-aggregated scalar series (counters + gauges):
        ``{series_key: value}``."""
        with self._lock:
            return {k: v for k, (kind, v) in self._fleet_latest.items()
                    if kind in ("counter", "gauge")}

    def fleetz(self, window_s: float = 60.0) -> Dict[str, Any]:
        """The aggregated fleet page — see the module docstring for
        the stable-surface contract."""
        now = self._clock()
        with self._lock:
            targets = dict(self._targets)
            last = dict(self._last)
            latest = dict(self._fleet_latest)
        replicas: Dict[str, Any] = {}
        for ep, t in sorted(targets.items()):
            entry: Dict[str, Any] = {
                "healthy": t.healthy,
                "breaker": t.breaker.state,
                "source": t.source,
                "age_s": (now - t.last_ok_ts)
                if t.last_ok_ts is not None else None,
            }
            if t.last_error:
                entry["error"] = t.last_error
            if ep in last:
                sc = (last[ep][2].get("serving") or {}) \
                    .get("scaling") or {}
                entry["scaling"] = {k: sc.get(k) for k in (
                    "consumer", "stream_depth", "pending_entries",
                    "utilization", "batch_size_target", "goodput")}
            replicas[ep] = entry
        quantiles = {
            fam: {"count": s.count,
                  "quantiles": dict(s.points)}
            for fam, (kind, s) in sorted(latest.items())
            if kind == "summary"}
        rates = {fam: self.signals.rate(fam, window_s)
                 for fam in RATE_FAMILIES}
        saturation = self._saturation_block(window_s)
        out: Dict[str, Any] = {
            "ts": now,
            "window_s": window_s,
            "replicas": replicas,
            "fleet": {
                "replicas_live": self.replicas_live(),
                "replicas_down": self.replicas_down(),
                "replicas_seen": len(last),
                "totals": self.fleet_totals(),
                "quantiles": quantiles,
            },
            "rates": rates,
            "saturation": saturation,
            "alerts": self.alerts.states()
            if self.alerts is not None else {},
        }
        return out

    def _saturation_block(self, window_s: float) -> Dict[str, Any]:
        """The autoscaler input: per-replica utilization level +
        trend, fleet depth + windowed slope, saturation verdict."""
        sat = self.replica_saturation()
        util: Dict[str, Optional[float]] = {}
        trend: Dict[str, Optional[float]] = {}
        with self._lock:
            healthy = [ep for ep, t in self._targets.items()
                       if t.healthy]
        for ep in healthy:
            key = _series_key("statusz_utilization", {"replica": ep})
            got = self.replica_store.latest(key)
            util[ep] = float(got[1]) if got is not None else None
            trend[ep] = self.replica_store.slope(key, window_s)
        known = [u for u in util.values() if u is not None]
        util_mean = sum(known) / len(known) if known else None
        depth_got = self.fleet_store.latest("statusz_depth")
        depth = float(depth_got[1]) if depth_got is not None else None
        depth_slope = self.fleet_store.slope("statusz_depth", window_s)
        live = len(healthy)
        saturated = live > 0 and sat and all(sat.values())
        if saturated or (util_mean is not None and util_mean > 0.8
                         and (depth_slope or 0.0) > 0):
            verdict = "scale_up"
        elif util_mean is not None and util_mean < 0.3 \
                and (depth or 0.0) <= 0 and (depth_slope or 0.0) <= 0:
            verdict = "scale_down"
        else:
            verdict = "steady"
        return {
            "verdict": verdict,
            "saturated": bool(saturated),
            "saturated_replicas": sum(1 for v in sat.values() if v),
            "replicas_live": live,
            "utilization": util,
            "utilization_mean": util_mean,
            "utilization_trend": trend,
            "depth": depth,
            "depth_slope": depth_slope,
        }

    # -- fleet re-export -----------------------------------------------------
    def render_fleet_prometheus(self) -> str:
        """The aggregated ``zoo_*`` families as Prometheus text
        exposition — the fleet-level twin of a replica's
        ``/metrics``."""
        with self._lock:
            latest = dict(self._fleet_latest)
        lines: List[str] = []
        typed = set()
        for key in sorted(latest):
            fam = family_of(key)
            if not fam.startswith("zoo_"):
                continue            # statusz-derived series stay internal
            kind, val = latest[key]
            if fam not in typed:
                typed.add(fam)
                lines.append(f"# TYPE {fam} {kind}")
            braces = key[len(fam):]
            if kind in ("counter", "gauge"):
                lines.append(f"{key} {_fmt(float(val))}")
            elif kind == "summary":
                for q in sorted(val.points, key=float):
                    inner = (braces[:-1] + "," if braces else "{") \
                        + f'quantile="{q}"' + "}"
                    lines.append(f"{fam}{inner} "
                                 f"{_fmt(float(val.points[q]))}")
                lines.append(f"{fam}_sum{braces} {_fmt(val.sum)}")
                lines.append(f"{fam}_count{braces} "
                             f"{_fmt(float(val.count))}")
            elif kind == "histogram":
                count, total = val
                lines.append(f"{fam}_sum{braces} {_fmt(float(total))}")
                lines.append(f"{fam}_count{braces} "
                             f"{_fmt(float(count))}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# the /fleetz HTTP endpoint
# ---------------------------------------------------------------------------

class _FleetzHandler(http.server.BaseHTTPRequestHandler):
    collector: FleetCollector = None    # type: ignore[assignment]

    def _send(self, body: bytes, content_type: str,
              code: int = 200) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
        path = self.path.split("?", 1)[0]
        c = type(self).collector
        if path in ("/", "/fleetz"):
            self._send(json.dumps(c.fleetz(), indent=2,
                                  default=str).encode("utf-8"),
                       "application/json")
        elif path == "/metrics":
            self._send(c.render_fleet_prometheus().encode("utf-8"),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            self._send(json.dumps({
                "status": "ok",
                "replicas_live": c.replicas_live(),
                "replicas_down": c.replicas_down(),
                "polls": c.polls,
            }).encode("utf-8"), "application/json")
        else:
            self.send_error(404)

    def log_message(self, *args):   # scrapes must not spam stderr
        pass


class FleetzServer:
    """HTTP front for one :class:`FleetCollector`: ``/fleetz`` (JSON
    aggregate), ``/metrics`` (fleet Prometheus re-export), and
    ``/healthz``. ``port=0`` picks a free port."""

    def __init__(self, collector: FleetCollector, port: int = 0,
                 host: str = "127.0.0.1"):
        handler = type("Handler", (_FleetzHandler,),
                       {"collector": collector})
        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="zoo-fleetz",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/fleetz"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
