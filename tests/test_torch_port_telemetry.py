"""The fleet telemetry plane of the port — the alert engine, the fleet
collector with ``/fleetz`` and the ``fleet_cli`` — held against the JAX
package's (``tests/test_telemetry.py:170-706``), and the port's
``predict_classes`` against JAX's.

Each alert scenario drives both engines tick by tick under one fake
clock and compares the transitions, the transition counters, the
``alert.fire``/``alert.resolve`` events and the state gauges. The
collector scenarios run both packages' collectors over the same replica
endpoints at the same fake times and compare the ``/fleetz`` documents
and the fleet re-export; the end-to-end run has three port replicas on
one stream discovered from the fleet registry. The CLI runs as ``python
-m analytics_zoo_tpu_torch.observability.fleet_cli`` for its exit codes
and in-process beside the JAX script for its output.
"""

import contextlib
import io
import json
import os
import re
import runpy
import subprocess
import sys
import time
import types
import urllib.request

import jax
import numpy as np
import pytest

from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.common import faults as jfaults
from analytics_zoo_tpu.common import reliability as jrel
from analytics_zoo_tpu.observability import alerts as jalerts
from analytics_zoo_tpu.observability import collector as jcollector
from analytics_zoo_tpu.pipeline.api.keras.engine import \
    Sequential as JaxSequential
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JaxDense
from analytics_zoo_tpu.pipeline.inference import InferenceModel as JaxIM
from analytics_zoo_tpu.utils import prediction as jprediction
from analytics_zoo_tpu_torch import observability as pobs
from analytics_zoo_tpu_torch import serving as pserving
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.common import faults as pfaults
from analytics_zoo_tpu_torch.common import reliability as prel
from analytics_zoo_tpu_torch.observability import alerts as palerts
from analytics_zoo_tpu_torch.observability import collector as pcollector
from analytics_zoo_tpu_torch.observability import fleet_cli
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
from analytics_zoo_tpu_torch.serving.client import INPUT_STREAM
from analytics_zoo_tpu_torch.utils import prediction as pprediction

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FLEET_CLI = os.path.join(REPO, "scripts", "zoo-fleet")

PORT = types.SimpleNamespace(name="port", obs=pobs, alerts=palerts,
                             collector=pcollector, Retry=prel.RetryPolicy,
                             faults=pfaults, ctx=pctx)
JAX = types.SimpleNamespace(name="jax", obs=jobs, alerts=jalerts,
                            collector=jcollector, Retry=jrel.RetryPolicy,
                            faults=jfaults, ctx=jctx)
BOTH = (PORT, JAX)

#: the modules this slice adds to the port
NEW_MODULES = (
    "analytics_zoo_tpu_torch.serving.fleet",
    "analytics_zoo_tpu_torch.serving.resp",
    "analytics_zoo_tpu_torch.serving.backend",
    "analytics_zoo_tpu_torch.serving.dlq_cli",
    "analytics_zoo_tpu_torch.serving.server",
    "analytics_zoo_tpu_torch.serving.client",
    "analytics_zoo_tpu_torch.observability.alerts",
    "analytics_zoo_tpu_torch.observability.collector",
    "analytics_zoo_tpu_torch.observability.fleet_cli",
    "analytics_zoo_tpu_torch.utils.prediction",
)


@pytest.fixture(autouse=True)
def contexts():
    pctx.reset_zoo_context()
    peng.reset_uids()
    yield
    pctx.reset_zoo_context()
    jctx.init_zoo_context(conf={"zoo.faults.enabled": False})


class Sink:
    def __init__(self):
        self.events = []

    def write(self, event):
        self.events.append(event)


class Value:
    """A signals stub: every expr here reads ``.v``."""

    def __init__(self, v=None):
        self.v = v


def transition_counts(reg, alert):
    out = {}
    for key, entry in reg.snapshot(compact=True).items():
        if key.startswith("zoo_alert_transitions_total{") \
                and f'alert="{alert}"' in key:
            state = key.split('state="', 1)[1].split('"', 1)[0]
            out[state] = entry["value"]
    return out


def events(sink, *kinds):
    """Events of ``kinds`` with the wall-clock fields set aside."""
    return [{k: v for k, v in e.items() if k not in ("ts", "time")}
            for e in sink.events if e["kind"] in kinds]


# ---------------------------------------------------------------------------
# the alert engine
# ---------------------------------------------------------------------------

def state_machine(pkg):
    reg = pkg.obs.MetricsRegistry()
    sink = Sink()
    reg.add_event_sink(sink)
    rule = pkg.alerts.AlertRule("depth_high", lambda s: s.v, threshold=10.0,
                                for_s=10.0, severity="page",
                                summary="backlog")
    eng = pkg.alerts.AlertEngine([rule], registry=reg, clock=lambda: 0.0)
    hooked = []
    eng.add_transition_hook(hooked.append)
    eng.add_transition_hook(lambda tr: 1 / 0)     # a failing hook is logged
    sig = Value()
    trail = []
    for v, now in ((5.0, 0.0), (50.0, 0.0), (50.0, 5.0), (50.0, 12.0),
                   (1.0, 20.0)):
        sig.v = v
        trs = eng.evaluate(sig, now=now)
        trail.append((eng.state("depth_high"), eng.firing(), eng.value(
            "depth_high"), [(t["state"], t["ts"], t.get("value"))
                            for t in trs]))
    snap = reg.snapshot(compact=True)
    return (trail, transition_counts(reg, "depth_high"),
            events(sink, "alert.fire", "alert.resolve"),
            snap['zoo_alert_state{alert="depth_high"}']["value"],
            len(hooked), eng.states())


def test_alert_state_machine_matches_jax():
    port, jax_ = state_machine(PORT), state_machine(JAX)
    assert port == jax_
    trail, counts, evs, gauge, hooked, _ = port
    assert [t[0] for t in trail] == ["inactive", "pending", "pending",
                                     "firing", "inactive"]
    assert [x for t in trail for x in t[3]] == [
        ("pending", 0.0, 50.0), ("firing", 12.0, 50.0),
        ("resolved", 20.0, 1.0)]
    assert counts == {"pending": 1.0, "firing": 1.0, "resolved": 1.0}
    assert [e["kind"] for e in evs] == ["alert.fire", "alert.resolve"]
    assert evs[0]["alert"] == "depth_high" and evs[0]["value"] == 50.0
    assert evs[0]["threshold"] == 10.0 and evs[0]["severity"] == "page"
    assert gauge == 0.0 and hooked == 3


def quiet_cases(pkg):
    reg = pkg.obs.MetricsRegistry()
    rule = pkg.alerts.AlertRule("blip", lambda s: s.v, threshold=1.0,
                                for_s=30.0)
    eng = pkg.alerts.AlertEngine([rule], registry=reg, clock=lambda: 0.0)
    t1 = eng.evaluate(Value(5.0), now=0.0)
    t2 = eng.evaluate(Value(0.0), now=10.0)
    out = [[t["state"] for t in t1], t2, eng.state("blip"),
           transition_counts(reg, "blip")]

    def boom(s):
        raise RuntimeError("expr blew up")

    eng = pkg.alerts.AlertEngine([
        pkg.alerts.AlertRule("no_data", lambda s: None, threshold=0.0),
        pkg.alerts.AlertRule("nan", lambda s: float("nan"), threshold=0.0),
        pkg.alerts.AlertRule("broken", boom, threshold=0.0),
        pkg.alerts.AlertRule("low", lambda s: 1.0, threshold=5.0, cmp="<"),
    ], registry=pkg.obs.MetricsRegistry(), clock=lambda: 0.0)
    trs = eng.evaluate(Value(), now=0.0)
    out += [[t["alert"] for t in trs],
            [eng.state(n) for n in ("no_data", "nan", "broken", "low")]]
    with pytest.raises(ValueError) as e:
        pkg.alerts.AlertEngine(
            [pkg.alerts.AlertRule("x", lambda s: 0.0, 1.0),
             pkg.alerts.AlertRule("x", lambda s: 0.0, 2.0)],
            registry=pkg.obs.MetricsRegistry())
    out.append(str(e.value))
    with pytest.raises(ValueError) as e:
        pkg.alerts.AlertRule("bad", lambda s: 0.0, 1.0, cmp="!=")
    out.append(str(e.value))
    return out


def test_pending_recovery_no_data_and_bad_rules_match_jax():
    port, jax_ = quiet_cases(PORT), quiet_cases(JAX)
    assert port == jax_
    assert port[:4] == [["pending"], [], "inactive", {"pending": 1.0}]
    # a rule with no hold (for_s 0) fires on its first breach
    assert port[4:6] == [["low"], ["inactive", "inactive", "inactive",
                                   "firing"]]


class CannedRates:
    def __init__(self, table):
        self.table = table

    def rate(self, family, window):
        return self.table.get((family, window))

    def quantile(self, family, q, window):
        return self.table.get((family, q, window))


def burn_rates(pkg):
    rule = pkg.alerts.burn_rate_rule("burn", "bad", "good", slo=0.99,
                                     fast_s=300.0, slow_s=3600.0)
    out = []
    for table in ({("bad", 300.0): 1.0, ("good", 300.0): 1.0,
                   ("bad", 3600.0): 0.001, ("good", 3600.0): 0.999},
                  {("bad", 300.0): 1.0, ("good", 300.0): 1.0,
                   ("bad", 3600.0): 0.5, ("good", 3600.0): 0.5}, {}):
        v = rule.expr(CannedRates(table))
        out.append((None if v is None else round(v, 9), rule.breached(v)))
    q = pkg.alerts.quantile_burn_rule("p99", "lat", 0.99, target_s=0.5,
                                      fast_s=300.0, slow_s=3600.0)
    for table in ({("lat", 0.99, 300.0): 2.0, ("lat", 0.99, 3600.0): 0.75},
                  {("lat", 0.99, 300.0): 0.1, ("lat", 0.99, 3600.0): 0.2},
                  {}):
        v = q.expr(CannedRates(table))
        out.append((None if v is None else round(v, 9), q.breached(v)))
    return out, (rule.threshold, rule.for_s, rule.severity, rule.cmp,
                 q.threshold, q.for_s, q.severity, q.cmp)


def test_burn_rate_rules_match_jax():
    port, jax_ = burn_rates(PORT), burn_rates(JAX)
    assert port == jax_
    assert port[0][:3] == [(0.1, False), (50.0, True), (None, False)]


def ruleset(pkg):
    rules = pkg.alerts.default_ruleset()
    desc = [(r.name, r.threshold, r.for_s, r.severity, r.cmp, r.summary)
            for r in rules]
    eng = pkg.alerts.AlertEngine(rules, registry=pkg.obs.MetricsRegistry(),
                                 clock=lambda: 0.0)
    store = pkg.obs.TimeSeriesStore(retention_s=10.0, sample_interval_s=1.0)
    eng.evaluate(pkg.alerts.StoreSignals(store, clock=lambda: 0.0), now=0.0)
    tuned = [(r.name, r.for_s) for r in pkg.alerts.default_ruleset(
        for_s=0.0, replica_down_for_s=0.0)]
    return desc, eng.firing(), tuned


def test_default_ruleset_matches_jax():
    port, jax_ = ruleset(PORT), ruleset(JAX)
    assert port == jax_
    assert {d[0] for d in port[0]} == {
        "publish_breaker_open", "dlq_growth", "shed_rate", "replica_down",
        "clock_skew", "fleet_saturated", "hbm_high_watermark",
        "e2e_burn_rate"}
    assert port[1] == []
    assert palerts.__all__ == jalerts.__all__
    assert pcollector.__all__ == jcollector.__all__
    assert pcollector.GAUGE_MAX == jcollector.GAUGE_MAX
    assert pcollector.RATE_FAMILIES == jcollector.RATE_FAMILIES


def store_signals(pkg):
    """StoreSignals over one recorded store: rates, gauge sums and maxes,
    slope and a windowed quantile, as each package derives them."""
    store = pkg.obs.TimeSeriesStore(retention_s=100.0, sample_interval_s=1.0)
    for t in range(6):
        store.record('zoo_serving_records_total{model="a"}', "counter",
                     float(t), 10.0 * t)
        store.record('zoo_serving_records_total{model="b"}', "counter",
                     float(t), 4.0 * t)
        store.record('zoo_breaker_state{breaker="x"}', "gauge", float(t),
                     float(t % 3))
        store.record("zoo_serving_e2e_quantiles_seconds", "summary",
                     float(t), pkg.obs.SummarySample(
                         10 * (t + 1), 0.1 * t,
                         {"0.5": 0.01 * (t + 1), "0.99": 0.02 * (t + 1)}))
    sig = pkg.alerts.StoreSignals(store, clock=lambda: 5.0)
    return (sig.rate("zoo_serving_records_total", 5.0),
            sig.gauge_sum("zoo_breaker_state"),
            sig.gauge_max("zoo_breaker_state"),
            sig.slope("zoo_breaker_state", 5.0),
            round(sig.quantile("zoo_serving_e2e_quantiles_seconds", 0.5,
                               5.0), 9),
            sig.replicas_down(), sig.replicas_live(),
            sig.saturated_fraction())


def test_store_signals_match_jax():
    assert store_signals(PORT) == store_signals(JAX)


# ---------------------------------------------------------------------------
# the collector over fixed replicas, both packages at the same fake times
# ---------------------------------------------------------------------------

def replica_registries():
    """Two scraped replica registries (the port's) with deterministic
    series."""
    regs = []
    for i, n in enumerate((100, 40)):
        reg = pobs.MetricsRegistry()
        reg.counter("zoo_serving_records_total", "t").inc(n)
        reg.counter("zoo_serving_shed_total", "t",
                    labels={"reason": "depth"}).inc(i)
        reg.gauge("zoo_serving_stream_depth", "t").set(3 + i)
        reg.gauge("zoo_breaker_state", "t",
                  labels={"breaker": "serving.publish"}).set(i)
        s = reg.summary("zoo_serving_e2e_quantiles_seconds", "t")
        for k in range(n):
            s.observe(0.001 * (k % 17 + 1) * (i + 1))
        reg.histogram("zoo_serving_batch_size", "t").observe(8.0 + i)
        regs.append(reg)
    return regs


def statusz(i, util):
    return {"serving": {
        "scaling": {"consumer": f"rep{i}", "group": "serving",
                    "stream_depth": 3 + i, "pending_entries": i,
                    "utilization": util, "batch_size_target": 32,
                    "goodput": 0.5},
        "overload": {"shed_watermark": 4, "stream_depth": 3 + i}}}


def test_collector_fleetz_and_reexport_match_jax():
    """Both collectors scrape the same two replica endpoints (the port's
    ``ScrapeServer`` over port registries) at the same fake times: the
    ``/fleetz`` documents, fleet totals and the Prometheus re-export are
    equal, and the saturation block reads the ``/statusz`` it scraped."""
    regs = replica_registries()
    utils = [0.9, 0.7]
    scrapes = [pobs.ScrapeServer(reg, port=0,
                                 health_fn=lambda i=i: statusz(i, utils[i]))
               for i, reg in enumerate(regs)]
    endpoints = [f"{s.host}:{s.port}" for s in scrapes]
    clock = [1000.0]
    try:
        cols = {pkg.name: pkg.obs.FleetCollector(
            endpoints=endpoints, registry=pkg.obs.MetricsRegistry(),
            interval_s=30.0, clock=lambda: clock[0],
            rules=pkg.alerts.default_ruleset(for_s=0.0,
                                             replica_down_for_s=0.0))
            for pkg in BOTH}
        pages = {}
        for step in range(3):
            regs[0].counter("zoo_serving_records_total", "t").inc(30)
            regs[1].counter("zoo_serving_records_total", "t").inc(10)
            clock[0] += 30.0
            for name, col in cols.items():
                assert col.poll() == 2
        for name, col in cols.items():
            page = col.fleetz(window_s=60.0)
            pages[name] = (page, col.render_fleet_prometheus(),
                           col.fleet_totals(), col.replica_saturation(),
                           col.transitions_log)
        # the collector's page for a replica that stops answering
        scrapes[1].close()
        clock[0] += 30.0
        for name, col in cols.items():
            col.retry = (prel if name == "port" else jrel).RetryPolicy(
                max_attempts=1)
            assert col.poll() == 1
        down = {name: col.fleetz(window_s=60.0)
                for name, col in cols.items()}
    finally:
        for s in scrapes:
            s.close()
    port, jax_ = pages["port"], pages["jax"]
    assert port[0] == jax_[0]
    assert port[1:4] == jax_[1:4]
    assert [(t["alert"], t["state"], t["ts"]) for t in port[4]] == \
        [(t["alert"], t["state"], t["ts"]) for t in jax_[4]]
    page = port[0]
    assert set(page) == {"ts", "window_s", "replicas", "fleet", "rates",
                         "saturation", "alerts"}
    assert page["fleet"]["replicas_live"] == 2
    assert page["fleet"]["totals"]["zoo_serving_records_total"] == 260.0
    assert page["rates"]["zoo_serving_records_total"] == \
        pytest.approx(80.0 / 60.0)
    assert page["saturation"]["utilization_mean"] == pytest.approx(0.8)
    assert page["saturation"]["saturated"] is False
    assert set(page["replicas"][endpoints[0]]["scaling"]) == {
        "consumer", "stream_depth", "pending_entries", "utilization",
        "batch_size_target", "goodput"}
    assert "# TYPE zoo_serving_records_total counter" in port[1]
    for doc in down.values():
        doc["replicas"][endpoints[1]].pop("error")
    assert down["port"] == down["jax"]
    assert down["port"]["fleet"]["replicas_down"] == 1
    # the counter total holds the dark replica's last value
    assert down["port"]["fleet"]["totals"]["zoo_serving_records_total"] \
        == 260.0


def burn_lifecycle(pkg):
    reg = pkg.obs.MetricsRegistry()
    records = reg.counter("zoo_serving_records_total", "t")
    failures = reg.counter("zoo_serving_failure_errors_total", "t",
                           labels={"error": "result publish failed"})
    scrape = pkg.obs.ScrapeServer(reg, port=0)
    collector = None
    try:
        creg = pkg.obs.MetricsRegistry()
        sink = Sink()
        creg.add_event_sink(sink)
        now = [0.0]
        collector = pkg.obs.FleetCollector(
            endpoints=[f"{scrape.host}:{scrape.port}"], registry=creg,
            interval_s=30.0, clock=lambda: now[0],
            rules=[pkg.alerts.burn_rate_rule(
                "e2e_burn_rate", "zoo_serving_failure_errors_total",
                "zoo_serving_records_total", slo=0.99, for_s=60.0,
                fast_s=300.0, slow_s=3600.0)])
        states = []

        def step(dt, d_records, d_failures):
            records.inc(d_records)
            failures.inc(d_failures)
            now[0] += dt
            collector.poll()
            states.append((now[0], collector.alerts.state("e2e_burn_rate")))

        step(0.0, 100, 0)
        step(30.0, 100, 0)
        for _ in range(5):
            step(30.0, 50, 50)
        for _ in range(10):
            step(30.0, 100, 0)
        fire = [e for e in sink.events if e["kind"] == "alert.fire"]
        return (states, transition_counts(creg, "e2e_burn_rate"),
                [(t["state"], t["ts"]) for t in collector.transitions_log],
                [round(e["value"], 6) for e in fire])
    finally:
        if collector is not None:
            collector.close()
        scrape.close()


def test_burn_rate_alert_lifecycle_over_publish_outage_matches_jax():
    port, jax_ = burn_lifecycle(PORT), burn_lifecycle(JAX)
    assert port == jax_
    states = dict(port[0])
    assert (states[30.0], states[60.0], states[90.0], states[120.0],
            states[180.0], states[480.0]) == (
        "inactive", "pending", "pending", "firing", "firing", "inactive")
    assert port[1] == {"pending": 1.0, "firing": 1.0, "resolved": 1.0}
    assert [s for s, _ in port[2]] == ["pending", "firing", "resolved"]
    assert port[3][0] > 14.4


def replica_loss(pkg):
    pkg.ctx.init_zoo_context(conf={"zoo.faults.enabled": True})
    rega, regb = pkg.obs.MetricsRegistry(), pkg.obs.MetricsRegistry()
    ca = rega.counter("zoo_serving_records_total", "t")
    cb = regb.counter("zoo_serving_records_total", "t")
    ca.inc(100)
    cb.inc(100)
    sa = pkg.obs.ScrapeServer(rega, port=0)
    sb = pkg.obs.ScrapeServer(regb, port=0)
    ep_a, ep_b = f"{sa.host}:{sa.port}", f"{sb.host}:{sb.port}"
    idx_b = sorted([ep_a, ep_b]).index(ep_b)
    collector = None
    try:
        creg = pkg.obs.MetricsRegistry()
        now = [0.0]
        collector = pkg.obs.FleetCollector(
            endpoints=[ep_a, ep_b], registry=creg, interval_s=30.0,
            clock=lambda: now[0], retry=pkg.Retry(max_attempts=1),
            breaker_threshold=3, breaker_reset_s=0.5,
            rules=[pkg.alerts.AlertRule("replica_down",
                                        lambda s: s.replicas_down(),
                                        threshold=0.5, for_s=60.0)])
        target_b = collector._targets[ep_b]
        plan = pkg.faults.FaultPlan().add(
            "collector.scrape", "disconnect",
            at=(2 + idx_b, 4 + idx_b, 6 + idx_b))
        totals = []

        def poll():
            ca.inc(10)
            now[0] += 30.0
            collector.poll()
            totals.append(
                collector.fleet_totals()["zoo_serving_records_total"])

        trail = []
        with pkg.faults.activate(plan):
            poll()
            trail.append(collector.replicas_live())
            for _ in range(3):
                poll()
            trail.append((target_b.breaker.state, target_b.healthy,
                          collector.alerts.state("replica_down")))
            poll()
            time.sleep(0.6)
            poll()
        trail.append((target_b.healthy, target_b.breaker.state,
                      collector.alerts.state("replica_down")))
        snap = creg.snapshot(compact=True)
        outcomes = {o: snap.get(
            f'zoo_collector_scrapes_total{{outcome="{o}"}}',
            {"value": 0.0})["value"] for o in ("ok", "error",
                                               "breaker_open")}
        fired = [(site, kind, i - idx_b) for site, kind, i
                 in plan.fired_at("collector.scrape")]
        return (trail, fired, plan.calls("collector.scrape"), outcomes,
                snap["zoo_collector_replicas_live"]["value"], totals,
                [(t["state"], t["ts"]) for t in collector.transitions_log],
                transition_counts(creg, "replica_down"))
    finally:
        if collector is not None:
            collector.close()
        sa.close()
        sb.close()


def test_collector_replica_loss_reconciles_against_the_plan_as_jax():
    port, jax_ = replica_loss(PORT), replica_loss(JAX)
    assert port == jax_
    assert port[0] == [2, ("open", False, "firing"),
                       (True, "closed", "inactive")]
    assert port[1] == [("collector.scrape", "disconnect", k)
                       for k in (2, 4, 6)]
    assert port[2] == 11
    assert port[3] == {"ok": 8.0, "error": 3.0, "breaker_open": 1.0}
    assert port[5] == [210.0, 220.0, 230.0, 240.0, 250.0, 260.0]
    assert port[6] == [("pending", 60.0), ("firing", 120.0),
                       ("resolved", 180.0)]


# ---------------------------------------------------------------------------
# end to end: three port replicas discovered from the fleet registry
# ---------------------------------------------------------------------------

class Double:
    def predict(self, x):
        return np.asarray(x) * 2.0


def get_json(url):
    with urllib.request.urlopen(url, timeout=10.0) as r:
        return json.loads(r.read().decode("utf-8"))


def get_text(url):
    with urllib.request.urlopen(url, timeout=10.0) as r:
        return r.read().decode("utf-8")


def family_total(families, name):
    fam = families.get(name)
    if not fam:
        return 0.0
    return sum(v for s_name, _lab, v in fam["samples"] if s_name == name)


def wait_until(pred, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def test_fleet_collector_end_to_end_reconciles_exactly():
    """Three port replicas on one stream, each with ``serve_metrics``,
    and the port's collector discovering them from the fleet registry:
    fleet-summed answered + shed + dead-lettered from ``/fleetz`` equals
    the per-replica scrapes' and the produced count at every sample; the
    windowed rate matches the counter math; the re-export holds only
    ``zoo_*`` families; after one replica is killed ``/fleetz`` lists it
    down within the TTL plus one poll."""
    pctx.init_zoo_context()
    backend = pserving.LocalBackend()
    regs = [pobs.MetricsRegistry() for _ in range(3)]
    servers = [pserving.ClusterServing(
        Double(), backend=backend, registry=regs[i], batch_size=4,
        block_ms=20, consumer_name=f"tele-{i}", heartbeat_s=0.05,
        fleet_ttl_s=0.5) for i in range(3)]
    scrapes = [srv.serve_metrics(port=0) for srv in servers]
    endpoints = [f"{sc.host}:{sc.port}" for sc in scrapes]
    collector = fz = None
    try:
        for srv in servers:
            srv.start()
        now = [1000.0]
        collector = pobs.FleetCollector(
            backend=backend, stream=INPUT_STREAM,
            registry=pobs.MetricsRegistry(), interval_s=1.0,
            registry_ttl_s=0.5, clock=lambda: now[0],
            retry=prel.RetryPolicy(max_attempts=1))
        fz = pobs.FleetzServer(collector, port=0)

        def discovered():
            now[0] += 1.0
            return collector.poll() == 3

        wait_until(discovered, msg="collector discovered 3 replicas")
        page = get_json(fz.url)
        assert set(page["replicas"]) == set(endpoints)
        assert all(r["source"] == "registry"
                   for r in page["replicas"].values())
        inq, outq = pserving.InputQueue(backend), pserving.OutputQueue(backend)
        rng = np.random.default_rng(23)
        produced, totals_seen = 0, []
        for round_no in range(3):
            for i in range(12):
                inq.enqueue(f"t{round_no}-{i}",
                            rng.normal(size=(6,)).astype(np.float32))
            for i in range(12):
                assert outq.query(f"t{round_no}-{i}",
                                  timeout=30.0) is not None
            produced += 12

            def scrape_all():
                return [pobs.parse_prometheus(
                    get_text(f"http://{ep}/metrics")) for ep in endpoints]

            def answered(fams_list):
                return sum(family_total(f, "zoo_serving_records_total")
                           + family_total(f, "zoo_serving_shed_total")
                           + family_total(f, "zoo_serving_dead_letter_total")
                           for f in fams_list)

            wait_until(lambda: answered(scrape_all()) == produced,
                       msg="per-replica counters settled")
            now[0] += 30.0
            assert collector.poll() == 3
            page = get_json(fz.url)
            totals = page["fleet"]["totals"]
            fleet_answered = (
                totals.get("zoo_serving_records_total", 0.0)
                + sum(v for k, v in totals.items()
                      if k.startswith("zoo_serving_shed_total"))
                + totals.get("zoo_serving_dead_letter_total", 0.0))
            assert fleet_answered == answered(scrape_all()) == produced
            assert page["fleet"]["replicas_live"] == 3
            totals_seen.append(totals["zoo_serving_records_total"])
        assert totals_seen == sorted(totals_seen)
        expected = (totals_seen[-1] - totals_seen[0]) / 60.0
        assert page["rates"]["zoo_serving_records_total"] == \
            pytest.approx(expected, rel=1e-6)
        sat = page["saturation"]
        assert sat["replicas_live"] == 3
        assert set(sat["utilization"]) == set(endpoints)
        assert sat["verdict"] in ("scale_up", "steady", "scale_down")
        q = page["fleet"]["quantiles"]["zoo_serving_e2e_quantiles_seconds"]
        assert q["count"] == produced
        refams = pobs.parse_prometheus(
            get_text(f"http://{fz.host}:{fz.port}/metrics"))
        assert family_total(refams, "zoo_serving_records_total") == produced
        assert not [f for f in refams if not f.startswith("zoo_")]
        assert get_json(f"http://{fz.host}:{fz.port}/healthz")[
            "replicas_live"] == 3
        # the fleet_cli check reads the healthy fleet (exit 0)
        rc, out, err = port_cli(["check"] + endpoints)
        assert rc == 0, err
        assert "3 live" in out and "all inactive" in out
        # a killed replica: its scrape endpoint and heartbeat die
        servers[2].kill()
        t_kill = time.monotonic()
        wait_until(lambda: (collector.poll() or True) and get_json(
            fz.url)["fleet"]["replicas_down"] == 1, timeout=10.0,
            msg="the killed replica listed down")
        assert time.monotonic() - t_kill <= 0.5 + 5.0
        page = get_json(fz.url)
        assert page["fleet"]["replicas_live"] == 2
        assert not page["replicas"][endpoints[2]]["healthy"]
    finally:
        if fz is not None:
            fz.close()
        if collector is not None:
            collector.close()
        for srv in servers:
            srv.stop(drain=False)


# ---------------------------------------------------------------------------
# fleet_cli (tests/test_telemetry.py:650-706)
# ---------------------------------------------------------------------------

def port_cli(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fleet_cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def jax_cli(argv):
    out, err = io.StringIO(), io.StringIO()
    old = sys.argv
    sys.argv = [JAX_FLEET_CLI] + list(argv)
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            ns = runpy.run_path(JAX_FLEET_CLI, run_name="zoo_fleet_cli")
            rc = ns["main"]()
    finally:
        sys.argv = old
    return rc, out.getvalue(), err.getvalue()


def strip_clock(text):
    text = re.sub(r"at [0-9.]+", "at _", text)
    text = re.sub(r"== poll (\d+) @ [0-9:]+ ==", r"== poll \1 ==", text)
    return re.sub(r"\(URLError: [^)]*\)\)?", "(URLError)", text)


def test_fleet_cli_output_matches_the_jax_script():
    reg = pobs.MetricsRegistry()
    reg.counter("zoo_serving_records_total", "t").inc(5)
    scrape = pobs.ScrapeServer(reg, port=0,
                               health_fn=lambda: statusz(0, 0.25))
    live = f"{scrape.host}:{scrape.port}"
    try:
        for argv in (["check", live], ["check", live, "127.0.0.1:59997"],
                     ["watch", live, "--iterations", "2", "--interval",
                      "0.05"]):
            p, j = port_cli(argv), jax_cli(argv)
            assert p[0] == j[0], argv
            assert strip_clock(p[1]) == strip_clock(j[1]), argv
            assert strip_clock(p[2]) == strip_clock(j[2]), argv
        p = port_cli(["check", live, "--json"])
        j = jax_cli(["check", live, "--json"])
        pd, jd = json.loads(p[1]), json.loads(j[1])
        for doc in (pd, jd):
            doc.pop("ts")
            for r in doc["replicas"].values():
                r.pop("age_s")
        assert pd == jd
    finally:
        scrape.close()


def test_fleet_cli_check_exit_codes_through_python_m():
    """``check``: 0 against a healthy replica, 3 once a dead second
    endpoint makes ``replica_down`` fire, 1 with nothing reachable."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    reg = pobs.MetricsRegistry()
    reg.counter("zoo_serving_records_total", "t").inc(5)
    scrape = pobs.ScrapeServer(reg, port=0)

    def run(*argv):
        return subprocess.run(
            [sys.executable, "-m",
             "analytics_zoo_tpu_torch.observability.fleet_cli", *argv],
            capture_output=True, text=True, env=env, cwd=REPO, timeout=120)

    live = f"{scrape.host}:{scrape.port}"
    try:
        r = run("check", live)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "1 live" in r.stdout and "all inactive" in r.stdout
        r = run("check", live, "127.0.0.1:59997")
        assert r.returncode == 3, r.stderr[-2000:]
        assert "replica_down" in r.stderr
    finally:
        scrape.close()
    r = run("check", live)
    assert r.returncode == 1
    assert "no replica reachable" in r.stderr


# ---------------------------------------------------------------------------
# predict_classes, and the import guard
# ---------------------------------------------------------------------------

def test_predict_classes_matches_jax():
    jm = JaxSequential([JaxDense(8, activation="relu", input_shape=(6,)),
                        JaxDense(3, activation="softmax")])
    jm.init_weights(rng=jax.random.key(5))
    pm = peng.Sequential([Dense(8, activation="relu", input_shape=(6,)),
                          Dense(3, activation="softmax")], device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
    x = np.random.default_rng(1).normal(size=(13, 6)).astype(np.float32)
    jim = JaxIM().from_keras(jm)
    pim = InferenceModel(device="cpu").from_keras(pm)
    for zero_based in (True, False):
        got = pim.predict_classes(x, zero_based=zero_based)
        want = np.asarray(jim.predict_classes(x, zero_based=zero_based))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
    np.testing.assert_array_equal(pm.predict_classes(x),
                                  np.asarray(jm.predict_classes(x)))
    for probs in (np.array([[0.2], [0.7], [0.5]]), np.array([0.1, 0.9]),
                  np.array([[0.1, 0.6, 0.3], [0.5, 0.2, 0.3]])):
        for kw in ({}, {"zero_based": False}, {"threshold": 0.15}):
            np.testing.assert_array_equal(
                pprediction.probs_to_classes(probs, **kw),
                jprediction.probs_to_classes(probs, **kw))


def test_the_fleet_modules_import_no_jax():
    """Each module this slice adds or extends, alone in a fresh
    interpreter, leaves jax and the JAX package out of ``sys.modules``;
    both CLIs answer ``--help``."""
    code = (
        "import importlib, sys\n"
        f"for name in {NEW_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'analytics_zoo_tpu' or "
        "n.startswith('analytics_zoo_tpu.'))\n"
        "assert not bad, bad\n"
        "from analytics_zoo_tpu_torch.serving import dlq_cli\n"
        "from analytics_zoo_tpu_torch.observability import fleet_cli\n"
        "for cli in (dlq_cli, fleet_cli):\n"
        "    try:\n"
        "        cli.main(['--help'])\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
    assert "replay" in proc.stdout and "check" in proc.stdout
