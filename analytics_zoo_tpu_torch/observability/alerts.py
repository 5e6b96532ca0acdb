"""Declarative alerting over derived telemetry signals — port of
``analytics_zoo_tpu/observability/alerts.py`` (pure Python).

An alert rule is ``(expr, threshold, for_s)``: ``expr`` is a callable
over a **signals view** (duck-typed — :class:`StoreSignals` for a local
:class:`~.timeseries.TimeSeriesStore`, the fleet collector for fleet
scope) returning the measured value or ``None`` for no data;
``threshold``/``cmp`` decide a breach; ``for_s`` is the hold the breach
must sustain before the alert fires (Prometheus's ``for:``).

The :class:`AlertEngine` runs a deterministic state machine per rule —
inactive → pending → firing → resolved — under an injectable clock.
Every state entered bumps ``zoo_alert_transitions_total{alert=,state=}``
(``pending``, ``firing``, ``resolved``; a pending that recovers before
``for_s`` goes quietly back to inactive), the current state is exported
as ``zoo_alert_state{alert=}`` (0 inactive, 1 pending, 2 firing), and
firing and resolving emit ``alert.fire`` / ``alert.resolve`` events on
the engine's registry. Transition hooks (:meth:`AlertEngine.
add_transition_hook`) take each transition; ``ProfilerTrigger.on_alert``
is one.

SLO burn-rate rules (:func:`burn_rate_rule`, :func:`quantile_burn_rule`)
are multi-window: the fast 5 m and slow 1 h pair, alerting on the
minimum of the two burns. Burn rate is ``(bad / total) / (1 - slo)``;
the default threshold 14.4 is the "2% of a 30-day budget in one hour"
page. :func:`default_ruleset` covers the known failure modes: publish
breaker open, DLQ growth, shed rate, replica down, clock skew, fleet
saturation, device memory, and the e2e failure burn rate.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from .metrics import MetricsRegistry, default_registry
from .timeseries import TimeSeriesStore, family_of

__all__ = [
    "AlertRule", "AlertEngine", "StoreSignals",
    "alert_gauge", "alert_counter",
    "burn_rate_rule", "quantile_burn_rule", "default_ruleset",
    "INACTIVE", "PENDING", "FIRING",
]

INACTIVE, PENDING, FIRING = "inactive", "pending", "firing"

#: gauge encoding of the state machine
_STATE_VALUE = {INACTIVE: 0.0, PENDING: 1.0, FIRING: 2.0}

#: fast/slow window pair for the multi-window burn rules (seconds)
FAST_WINDOW_S, SLOW_WINDOW_S = 300.0, 3600.0


def alert_gauge(registry: MetricsRegistry, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None):
    """Register/fetch a gauge for the alert plane."""
    return registry.gauge(name, help, labels=labels)


def alert_counter(registry: MetricsRegistry, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None):
    """Register/fetch a counter for the alert plane (see
    :func:`alert_gauge`)."""
    return registry.counter(name, help, labels=labels)


class AlertRule:
    """One declarative rule: ``expr(signals) -> Optional[float]``
    measured against ``threshold`` under ``cmp`` (``">"`` or ``"<"``),
    breaching for ``for_s`` seconds before firing. ``None`` from
    ``expr`` means no data — never a breach (rules for which *absence*
    is the failure encode it as a count, e.g. replicas down)."""

    def __init__(self, name: str,
                 expr: Callable[[object], Optional[float]],
                 threshold: float, for_s: float = 0.0,
                 cmp: str = ">", severity: str = "page",
                 summary: str = ""):
        if cmp not in (">", "<"):
            raise ValueError(f"cmp must be '>' or '<', got {cmp!r}")
        self.name = name
        self.expr = expr
        self.threshold = float(threshold)
        self.for_s = float(for_s)
        self.cmp = cmp
        self.severity = severity
        self.summary = summary

    def breached(self, value: Optional[float]) -> bool:
        if value is None or value != value:
            return False
        return value > self.threshold if self.cmp == ">" \
            else value < self.threshold


class AlertEngine:
    """The pending→firing→resolved state machine over a rule set.

    ``clock`` is injectable (defaults to ``time.time``); tests call
    :meth:`evaluate` with explicit ``now`` values for fully
    deterministic transitions. :meth:`evaluate` returns the transition
    records of that tick — ``{"alert", "state", "value", "ts"}`` — the
    same records the transition counter and events reflect, so a test
    can reconcile all three exactly.
    """

    def __init__(self, rules: Sequence[AlertRule],
                 registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.time):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError("duplicate alert rule names")
        self.rules = list(rules)
        self.registry = registry if registry is not None \
            else default_registry()
        self._clock = clock
        self._lock = threading.Lock()
        self._state: Dict[str, str] = {}
        self._since: Dict[str, float] = {}       # pending start ts
        self._value: Dict[str, Optional[float]] = {}
        self._hooks: List[Callable[[dict], None]] = []
        for r in self.rules:
            self._state[r.name] = INACTIVE
            alert_gauge(   # bounded label set —
                # alert names come from the declared ruleset
                self.registry, "zoo_alert_state",
                "alert state machine: 0 inactive, 1 pending, 2 firing",
                labels={"alert": r.name}).set(0.0)

    def add_transition_hook(self, fn: Callable[[dict], None]) -> None:
        """Register ``fn(transition)`` to run for every transition
        record :meth:`evaluate` produces (e.g.
        :meth:`~.profiler.ProfilerTrigger.on_alert` auto-captures a
        trace when a rule fires). Hooks run after the evaluation lock
        is released; a raising hook is logged-equivalent swallowed —
        it can never wedge the alert plane."""
        self._hooks.append(fn)

    # -- state machine -------------------------------------------------------
    def _enter(self, rule: AlertRule, state: str,
               value: Optional[float], now: float,
               transitions: List[dict]) -> None:
        self._state[rule.name] = state if state != "resolved" \
            else INACTIVE
        alert_gauge(   # bounded label set —
            # alert names come from the declared ruleset
            self.registry, "zoo_alert_state",
            "alert state machine: 0 inactive, 1 pending, 2 firing",
            labels={"alert": rule.name}).set(
                _STATE_VALUE[self._state[rule.name]])
        alert_counter(   # bounded label set —
            # alert names from the ruleset; state from a closed set
            self.registry, "zoo_alert_transitions_total",
            "alert state-machine transitions, by state entered",
            labels={"alert": rule.name, "state": state}).inc()
        transitions.append({"alert": rule.name, "state": state,
                            "value": value, "ts": now})
        if state == FIRING:
            self.registry.emit("alert.fire", alert=rule.name,
                               value=value, threshold=rule.threshold,
                               severity=rule.severity,
                               summary=rule.summary)
        elif state == "resolved":
            self.registry.emit("alert.resolve", alert=rule.name,
                               value=value)

    def evaluate(self, signals: object,
                 now: Optional[float] = None) -> List[dict]:
        """One tick: evaluate every rule against ``signals``, advance
        the state machines, return this tick's transition records."""
        now = self._clock() if now is None else now
        transitions: List[dict] = []
        with self._lock:
            for rule in self.rules:
                try:
                    value = rule.expr(signals)
                except Exception:
                    value = None        # a broken expr is no-data
                self._value[rule.name] = value
                breached = rule.breached(value)
                state = self._state[rule.name]
                if state == INACTIVE and breached:
                    if rule.for_s <= 0:
                        self._enter(rule, FIRING, value, now,
                                    transitions)
                    else:
                        self._since[rule.name] = now
                        self._enter(rule, PENDING, value, now,
                                    transitions)
                elif state == PENDING:
                    if not breached:
                        # never fired: back to inactive, no "resolved"
                        self._state[rule.name] = INACTIVE
                        alert_gauge(  # bounded label set
                            self.registry, "zoo_alert_state",
                            "alert state machine: 0 inactive, "
                            "1 pending, 2 firing",
                            labels={"alert": rule.name}).set(0.0)
                    elif now - self._since[rule.name] >= rule.for_s:
                        self._enter(rule, FIRING, value, now,
                                    transitions)
                elif state == FIRING and not breached:
                    self._enter(rule, "resolved", value, now,
                                transitions)
        for tr in transitions:      # outside the lock: hooks may call
            for hook in self._hooks:            # back into the engine
                try:
                    hook(tr)
                except Exception:   # a hook failure never wedges alerts
                    logging.getLogger(
                        "analytics_zoo_tpu_torch.observability").warning(
                        "alert transition hook failed for %r",
                        tr.get("alert"), exc_info=True)
        return transitions

    # -- introspection -------------------------------------------------------
    def state(self, name: str) -> str:
        with self._lock:
            return self._state[name]

    def value(self, name: str) -> Optional[float]:
        with self._lock:
            return self._value.get(name)

    def firing(self) -> List[str]:
        with self._lock:
            return sorted(n for n, s in self._state.items()
                          if s == FIRING)

    def states(self) -> Dict[str, dict]:
        """``{alert: {"state", "value", "threshold", "severity",
        "summary"}}`` — the ``/fleetz`` alerts block and the CLI
        table."""
        with self._lock:
            return {r.name: {"state": self._state[r.name],
                             "value": self._value.get(r.name),
                             "threshold": r.threshold,
                             "for_s": r.for_s,
                             "severity": r.severity,
                             "summary": r.summary}
                    for r in self.rules}


class StoreSignals:
    """Signals view over one :class:`TimeSeriesStore` — family-level
    queries that sum/max across the family's labeled series. The fleet
    collector layers replica-health methods on top of this shape; any
    object with these methods satisfies a rule expr."""

    def __init__(self, store: TimeSeriesStore,
                 clock: Callable[[], float] = time.time):
        self.store = store
        self._clock = clock

    def _keys(self, family: str,
              labels: Optional[Dict[str, str]] = None) -> List[str]:
        keys = self.store.series_for(family)
        if labels:
            need = [f'{k}="{v}"' for k, v in labels.items()]
            keys = [k for k in keys if all(n in k for n in need)]
        return keys

    def rate(self, family: str, window_s: float,
             labels: Optional[Dict[str, str]] = None) -> Optional[float]:
        """Summed per-second rate across the family's series."""
        rates = [self.store.rate(k, window_s, now=self._clock())
                 for k in self._keys(family, labels)]
        rates = [r for r in rates if r is not None]
        return sum(rates) if rates else None

    def gauge_sum(self, family: str,
                  labels: Optional[Dict[str, str]] = None
                  ) -> Optional[float]:
        vals = [self.store.latest(k) for k in self._keys(family, labels)]
        vals = [v for _, v in filter(None, vals)
                if isinstance(v, (int, float))]
        return sum(vals) if vals else None

    def gauge_max(self, family: str,
                  labels: Optional[Dict[str, str]] = None
                  ) -> Optional[float]:
        vals = [self.store.latest(k) for k in self._keys(family, labels)]
        vals = [v for _, v in filter(None, vals)
                if isinstance(v, (int, float))]
        return max(vals) if vals else None

    def slope(self, family: str, window_s: float,
              labels: Optional[Dict[str, str]] = None) -> Optional[float]:
        """Summed least-squares slope across the family's series."""
        slopes = [self.store.slope(k, window_s, now=self._clock())
                  for k in self._keys(family, labels)]
        slopes = [s for s in slopes if s is not None]
        return sum(slopes) if slopes else None

    def quantile(self, family: str, q: float, window_s: float,
                 labels: Optional[Dict[str, str]] = None
                 ) -> Optional[float]:
        """Worst (max) windowed quantile across the family's series —
        conservative for alerting."""
        qs = [self.store.quantile(k, q, window_s, now=self._clock())
              for k in self._keys(family, labels)]
        qs = [v for v in qs if v is not None]
        return max(qs) if qs else None

    # replica-health hooks the fleet collector overrides; a local store
    # has no fleet, so these read as no-data
    def replicas_down(self) -> Optional[float]:
        return None

    def replicas_live(self) -> Optional[float]:
        return None

    def saturated_fraction(self) -> Optional[float]:
        return None


# -- rule constructors -------------------------------------------------------

def burn_rate_rule(name: str, bad_family: str, good_family: str,
                   slo: float = 0.99, threshold: float = 14.4,
                   fast_s: float = FAST_WINDOW_S,
                   slow_s: float = SLOW_WINDOW_S,
                   for_s: float = 0.0,
                   severity: str = "page") -> AlertRule:
    """Multi-window failure-ratio burn rate: over each window the
    failure ratio is ``bad / (bad + good)`` (rates of the two counter
    families), burn is ``ratio / (1 - slo)``, and the rule's value is
    ``min(burn_fast, burn_slow)`` — both windows must breach."""
    budget = max(1.0 - float(slo), 1e-9)

    def expr(s) -> Optional[float]:
        burns = []
        for window in (fast_s, slow_s):
            bad = s.rate(bad_family, window)
            good = s.rate(good_family, window)
            if bad is None and good is None:
                return None
            bad = bad or 0.0
            good = good or 0.0
            total = bad + good
            ratio = (bad / total) if total > 0 else 0.0
            burns.append(ratio / budget)
        return min(burns)

    return AlertRule(
        name, expr, threshold=threshold, for_s=for_s,
        severity=severity,
        summary=f"error-budget burn (slo={slo:g}) over "
                f"{fast_s:g}s and {slow_s:g}s windows")


def quantile_burn_rule(name: str, family: str, q: float,
                       target_s: float,
                       fast_s: float = FAST_WINDOW_S,
                       slow_s: float = SLOW_WINDOW_S,
                       for_s: float = 0.0,
                       severity: str = "page") -> AlertRule:
    """Multi-window latency-SLO burn over a quantile summary family:
    value is ``min(q_fast, q_slow) / target_s`` — fires past 1.0 only
    when BOTH windows' quantile sits above the target."""

    def expr(s) -> Optional[float]:
        vals = []
        for window in (fast_s, slow_s):
            v = s.quantile(family, q, window)
            if v is None:
                return None
            vals.append(v)
        return min(vals) / float(target_s)

    return AlertRule(
        name, expr, threshold=1.0, for_s=for_s, severity=severity,
        summary=f"p{q * 100:g} of {family} vs {target_s:g}s target, "
                f"both windows")


def _hbm_in_use_fraction(s) -> Optional[float]:
    """in_use / limit over the ``zoo_device_hbm_bytes`` gauge family
    (PR 17's device-memory telemetry); no-data until both kinds have
    been sampled, and a zero limit (CPU hosts) reads as no-data too."""
    used = s.gauge_sum("zoo_device_hbm_bytes", labels={"kind": "in_use"})
    limit = s.gauge_sum("zoo_device_hbm_bytes", labels={"kind": "limit"})
    if used is None or not limit:
        return None
    return used / limit


def default_ruleset(for_s: float = 30.0,
                    shed_rate_threshold: float = 0.0,
                    replica_down_for_s: float = 10.0) -> List[AlertRule]:
    """The known-failure-mode rules (docs/guides/OBSERVABILITY.md
    "Default ruleset" table stays in lockstep with this list)."""
    return [
        AlertRule(
            "publish_breaker_open",
            lambda s: s.gauge_max("zoo_breaker_state",
                                  labels={"breaker": "serving.publish"}),
            threshold=0.5, for_s=0.0, severity="page",
            summary="result-publish circuit not closed on >=1 replica"),
        AlertRule(
            "dlq_growth",
            lambda s: s.rate("zoo_serving_dlq_spilled_total",
                             FAST_WINDOW_S),
            threshold=0.0, for_s=for_s, severity="warn",
            summary="records spilling to the dead-letter queue"),
        AlertRule(
            "shed_rate",
            lambda s: s.rate("zoo_serving_shed_total", FAST_WINDOW_S),
            threshold=shed_rate_threshold, for_s=for_s,
            severity="warn",
            summary="admission control shedding records"),
        AlertRule(
            "replica_down",
            lambda s: s.replicas_down(),
            threshold=0.5, for_s=replica_down_for_s, severity="page",
            summary="collector cannot scrape >=1 fleet replica"),
        AlertRule(
            "clock_skew",
            lambda s: s.rate("zoo_serving_clock_skew_total",
                             FAST_WINDOW_S),
            threshold=0.0, for_s=for_s, severity="warn",
            summary="client clocks running ahead of the server"),
        AlertRule(
            "fleet_saturated",
            lambda s: s.saturated_fraction(),
            threshold=0.99, for_s=for_s, severity="page",
            summary="every live replica reports saturated"),
        AlertRule(
            "hbm_high_watermark",
            _hbm_in_use_fraction,
            threshold=0.92, for_s=for_s, severity="page",
            summary="device HBM in_use above 92% of limit — next "
                    "compile or batch-size step likely OOMs"),
        burn_rate_rule(
            "e2e_burn_rate", "zoo_serving_failure_errors_total",
            "zoo_serving_records_total", slo=0.99, for_s=for_s),
    ]
