"""Fleet serving: the port's consumer-group reclaim, fleet heartbeats and
backpressure held against the JAX package on the same scenarios.

Every scenario of the JAX fleet chaos harness (``tests/test_fleet_chaos.
py``) and the fleet-registry contracts of ``tests/test_consumer_group.
py`` run through both packages the same way — the same doubling model
(every replica, original or reclaimer, answers ``x * 2``), the same
pre-enqueued records, a dispatch held by a ``threading.Event`` so the
kill window is the same batch in both — and their outcomes are compared:
answered, shed and dead-lettered counts, ``zoo_serving_reclaimed_total``
and its labels, acks, the pending-entries list, duplicate result writes,
``serving.reclaim`` and ``request`` events, the mixed-mode refusal, the
fleet backpressure refusals and the ``/statusz`` ``scaling`` block.
Nothing timing-dependent is compared: which survivor takes which
reclaimed entry varies, only the totals may not.

Timers are short (``claim_idle_ms`` at most 200, ``heartbeat_s`` 0.05 or
less) and every wait is bounded.
"""

import collections
import json
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu import serving as jserving
from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.common import faults as jfaults
from analytics_zoo_tpu.serving import fleet as jfleet
from analytics_zoo_tpu_torch import observability as pobs
from analytics_zoo_tpu_torch import serving as pserving
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.common import faults as pfaults
from analytics_zoo_tpu_torch.serving import fleet as pfleet
from analytics_zoo_tpu_torch.serving import server as pserver
from analytics_zoo_tpu_torch.serving.client import INPUT_STREAM as STREAM

GROUP = "serving"

PORT = types.SimpleNamespace(
    name="port", Serving=pserving.ClusterServing,
    Backend=pserving.LocalBackend, InputQueue=pserving.InputQueue,
    OutputQueue=pserving.OutputQueue, FleetView=pserving.FleetView,
    FleetSaturatedError=pserving.FleetSaturatedError,
    Registry=pobs.MetricsRegistry, read_events=pobs.read_events,
    faults=pfaults, fleet=pfleet, ctx=pctx)
JAX = types.SimpleNamespace(
    name="jax", Serving=jserving.ClusterServing,
    Backend=jserving.LocalBackend, InputQueue=jserving.InputQueue,
    OutputQueue=jserving.OutputQueue, FleetView=jserving.FleetView,
    FleetSaturatedError=jserving.FleetSaturatedError,
    Registry=jobs.MetricsRegistry, read_events=jobs.read_events,
    faults=jfaults, fleet=jfleet, ctx=jctx)
BOTH = (PORT, JAX)


@pytest.fixture(autouse=True)
def contexts():
    pctx.reset_zoo_context()
    yield
    pctx.reset_zoo_context()
    pctx.init_zoo_context()
    pctx.reset_zoo_context()
    jctx.init_zoo_context(conf={"zoo.faults.enabled": False})


class Double:
    """Every replica answers ``x * 2``: a record served by any replica,
    original or reclaimer, gives the same answer."""

    def predict(self, x):
        return np.asarray(x) * 2.0


class Blocking(Double):
    """A model whose first dispatch waits until released: the replica
    holds its read entries in flight for as long as the test wants."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def predict(self, x):
        self.entered.set()
        assert self.release.wait(timeout=30.0), "model never released"
        return super().predict(x)


def counting_backend(pkg):
    """The package's ``LocalBackend`` counting result writes per uri —
    the ground truth for "no duplicate writes"."""
    class Counting(pkg.Backend):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.writes = collections.Counter()

        def set_result(self, uri, fields):
            self.writes[uri] += 1
            super().set_result(uri, fields)

        def set_results(self, results):
            for uri in results:
                self.writes[uri] += 1
            super().set_results(results)
    return Counting()


def server(pkg, model, backend, reg, **kw):
    kw.setdefault("batch_size", 4)
    kw.setdefault("block_ms", 20)
    kw.setdefault("claim_idle_ms", 200)
    kw.setdefault("claim_sweep_s", 0.03)
    kw.setdefault("heartbeat_s", 0.05)
    return pkg.Serving(model, backend=backend, registry=reg, **kw)


def enqueue(pkg, backend, n, prefix="f", **kw):
    inq = pkg.InputQueue(backend, **kw)
    rng = np.random.default_rng(17)
    xs = {f"{prefix}-{i}": rng.normal(size=(6,)).astype(np.float32)
          for i in range(n)}
    for uri, x in xs.items():
        inq.enqueue(uri, x)
    return xs


def total(snaps, name):
    """One counter family summed over registries and label sets."""
    return sum(v["value"] for snap in snaps for k, v in snap.items()
               if k.split("{", 1)[0] == name)


def labelled(snaps, name):
    """``{series key: value}`` of one family over registries."""
    out = collections.Counter()
    for snap in snaps:
        for k, v in snap.items():
            if k.split("{", 1)[0] == name:
                out[k] += v["value"]
    return dict(out)


def wait_until(pred, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


# ---------------------------------------------------------------------------
# the fleet registry (tests/test_consumer_group.py:119-176)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p.name)
def test_fleet_membership_ttl_and_clean_removal(pkg):
    b = pkg.Backend()
    pkg.fleet.publish_member(b, "s", "r1", {"mode": "group:g",
                                            "saturated": False})
    pkg.fleet.publish_member(b, "s", "r2", {"mode": "group:g",
                                            "saturated": True})
    members = pkg.fleet.live_members(b, "s", ttl_s=5.0)
    assert set(members) == {"r1", "r2"}
    assert members["r2"]["saturated"] is True and "ts" in members["r1"]
    assert pkg.fleet.live_members(b, "s", ttl_s=0.0) == {}
    pkg.fleet.remove_member(b, "s", "r1")
    assert set(pkg.fleet.live_members(b, "s", ttl_s=5.0)) == {"r2"}
    # malformed payloads (a half-written heartbeat, a JSON non-object)
    # are skipped and reaped
    b.fleet_set("s", "broken", "{not json")
    b.fleet_set("s", "scalar", "123")
    assert set(pkg.fleet.live_members(b, "s", ttl_s=5.0)) == {"r2"}
    assert set(b.fleet_all("s")) == {"r2"}
    # a heartbeat dead for well past the TTL is reaped from the hash
    stale = json.dumps({"mode": "single", "ts": time.time() - 60.0})
    b.fleet_set("s", "ghost", stale)
    assert "ghost" not in pkg.fleet.live_members(b, "s", ttl_s=1.0)
    assert "ghost" not in b.fleet_all("s")


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p.name)
def test_fleet_view_saturation_rule_and_cache(pkg):
    b = pkg.Backend()
    view = pkg.FleetView(b, "s", cache_s=10.0, ttl_s=5.0)
    # no live member: open
    assert view.saturated() is False
    pkg.fleet.publish_member(b, "s", "r1", {"saturated": True})
    pkg.fleet.publish_member(b, "s", "r2", {"saturated": False})
    view = pkg.FleetView(b, "s", cache_s=10.0, ttl_s=5.0)
    # one replica with headroom keeps the fleet open
    assert view.saturated() is False
    pkg.fleet.publish_member(b, "s", "r2", {"saturated": True})
    # the cached view holds its answer; a fresh one sees saturation
    assert view.saturated() is False
    assert pkg.FleetView(b, "s", cache_s=0.0, ttl_s=5.0).saturated() is True


def test_mode_conflict_detection_matches_jax():
    msgs = {}
    for pkg in BOTH:
        b = pkg.Backend()
        pkg.fleet.publish_member(b, "s", "old", {"mode": "single"})
        with pytest.raises(RuntimeError, match="mode conflict") as e:
            pkg.fleet.check_mode_conflict(b, "s", "new", "group:serving")
        # the heartbeat's age is the one timing-dependent part
        msgs[pkg.name] = e.value.args[0].split("(heartbeat")[0]
        pkg.fleet.check_mode_conflict(b, "s", "peer", "single")
        pkg.fleet.check_mode_conflict(b, "s", "old", "group:serving")
        pkg.fleet.publish_member(b, "s2", "a", {"mode": "group:g1"})
        with pytest.raises(RuntimeError, match="mode conflict"):
            pkg.fleet.check_mode_conflict(b, "s2", "b", "group:g2")
        pkg.fleet.check_mode_conflict(b, "s", "new", "group:serving",
                                      ttl_s=0.0)
    assert msgs["port"] == msgs["jax"]
    assert pfleet.DEFAULT_TTL_S == jfleet.DEFAULT_TTL_S == 3.0
    assert pfleet.__all__ == jfleet.__all__


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p.name)
def test_foreign_backend_without_fleet_surface_opts_out(pkg):
    class Minimal:
        pass

    pkg.fleet.publish_member(Minimal(), "s", "r", {"mode": "single"})
    assert pkg.fleet.live_members(Minimal(), "s") == {}
    pkg.fleet.check_mode_conflict(Minimal(), "s", "r", "group:g")
    assert pkg.FleetView(Minimal(), "s").saturated() is False


def test_fleet_conf_keys_match_jax():
    for k in ("zoo.serving.claim_idle_ms", "zoo.serving.max_deliveries",
              "zoo.serving.fleet_backpressure",
              "zoo.serving.consumer_group"):
        assert pctx.DEFAULT_CONF[k] == jctx.DEFAULT_CONF[k], k
        assert type(pctx.DEFAULT_CONF[k]) is type(jctx.DEFAULT_CONF[k]), k


def test_server_fleet_knobs_default_as_jax():
    """claim_idle_ms, claim_sweep_s, max_deliveries, heartbeat_s and
    fleet_ttl_s default (from the conf) as the JAX server's, and a
    non-positive claim_idle_ms is refused with the same message."""
    pctx.init_zoo_context(conf={"zoo.serving.claim_idle_ms": 800,
                                "zoo.serving.max_deliveries": 3})
    jctx.init_zoo_context(conf={"zoo.serving.claim_idle_ms": 800,
                                "zoo.serving.max_deliveries": 3})
    got = {}
    for pkg in BOTH:
        s = pkg.Serving(Double(), backend=pkg.Backend(),
                        registry=pkg.Registry(), consumer_name="k")
        got[pkg.name] = (s.claim_idle_ms, s.claim_sweep_s, s.max_deliveries,
                         s.heartbeat_s, s.fleet_ttl_s, s._mode)
        legacy = pkg.Serving(Double(), backend=pkg.Backend(),
                             registry=pkg.Registry(), consumer_group="")
        got[pkg.name] += (legacy._mode,)
        with pytest.raises(ValueError) as e:
            pkg.Serving(Double(), backend=pkg.Backend(),
                        registry=pkg.Registry(), claim_idle_ms=0)
        got[pkg.name] += (str(e.value),)
    assert got["port"] == got["jax"] == (
        800.0, 0.4, 3, 1.0, 3.0, "group:serving", "single",
        "claim_idle_ms must be > 0")
    jctx.init_zoo_context(conf={"zoo.serving.claim_idle_ms": 30000,
                                "zoo.serving.max_deliveries": 5})


def test_group_mode_needs_xautoclaim():
    """A backend without ``xautoclaim`` serves consume-on-read in both."""
    modes = {}
    for pkg in BOTH:
        class Bare:
            def __init__(self, inner):
                self._inner = inner

            def __getattr__(self, name):
                if name == "xautoclaim":
                    raise AttributeError(name)
                return getattr(self._inner, name)

        s = pkg.Serving(Double(), backend=Bare(pkg.Backend()),
                        registry=pkg.Registry())
        modes[pkg.name] = (s._group_mode, s._mode)
    assert modes["port"] == modes["jax"] == (False, "single")


# ---------------------------------------------------------------------------
# the chaos scenarios (tests/test_fleet_chaos.py)
# ---------------------------------------------------------------------------

def kill_mid_stream(pkg, tmp):
    """Three replicas, one killed after ``xreadgroup`` and before its
    publish; returns what the JAX test reconciles."""
    pkg.ctx.init_zoo_context(conf={"zoo.faults.enabled": False})
    backend = counting_backend(pkg)
    xs = enqueue(pkg, backend, 24)
    vm = Blocking()
    vreg = pkg.Registry()
    victim = server(pkg, vm, backend, vreg, consumer_name="victim",
                    claim_idle_ms=60000)
    victim.set_json_events(str(tmp / f"{pkg.name}-victim.jsonl"))
    victim.start()
    assert vm.entered.wait(10.0)
    kill_window = backend.xpending(STREAM, GROUP)
    regs = [pkg.Registry() for _ in range(2)]
    survivors = []
    for i, reg in enumerate(regs):
        s = server(pkg, Double(), backend, reg, consumer_name=f"s{i}")
        s.set_json_events(str(tmp / f"{pkg.name}-s{i}.jsonl"))
        survivors.append(s.start())
    victim.kill(join=False)
    vm.release.set()
    victim.kill()
    outq = pkg.OutputQueue(backend)
    got = {uri: outq.query(uri, timeout=20.0) for uri in xs}
    for s in survivors:
        s.stop()
    for uri, x in xs.items():
        assert got[uri] is not None, f"{pkg.name}: lost record {uri}"
        np.testing.assert_allclose(got[uri], x * 2.0, rtol=1e-6)
    snaps = [r.snapshot() for r in regs]
    reclaims = []
    for i in range(2):
        reclaims += pkg.read_events(str(tmp / f"{pkg.name}-s{i}.jsonl"),
                                    kind="serving.reclaim")
    events = []
    for name in ("victim", "s0", "s1"):
        events += pkg.read_events(str(tmp / f"{pkg.name}-{name}.jsonl"),
                                  kind="request")
    phases = collections.defaultdict(list)
    for e in events:
        phases[e["trace"]].append(e["phase"])
    return {
        "kill_window": kill_window,
        "answered_shed_dead": tuple(total(snaps, n) for n in (
            "zoo_serving_records_total", "zoo_serving_shed_total",
            "zoo_serving_dead_letter_total")),
        "victim_served": victim.served,
        "victim_records": vreg.snapshot().get(
            "zoo_serving_records_total", {"value": 0.0})["value"],
        "reclaimed": labelled(snaps, "zoo_serving_reclaimed_total"),
        "acks": total(snaps, "zoo_serving_acks_total"),
        "pel": backend.pending_len(STREAM, GROUP),
        "duplicates": {u: c for u, c in backend.writes.items() if c != 1},
        "writes": sum(backend.writes.values()),
        "reclaim_events": len(reclaims),
        "reclaim_prev": sorted({e["prev_consumer"] for e in reclaims}),
        "reclaim_deliveries": sorted({e["deliveries"] for e in reclaims}),
        "reclaim_uris_known": {e["uri"] for e in reclaims} <= set(xs),
        "traces": len(phases),
        "one_publish_each": all(p.count("publish") == 1
                                for p in phases.values()),
        "no_failed": all("failed" not in p for p in phases.values()),
        # a reclaimed record's queue wait is not observed: 20 of the 24
        # records were read fresh by a survivor
        "queue_wait_count": sum(
            s["zoo_serving_queue_wait_seconds"]["count"] for s in snaps),
    }


def test_replica_killed_mid_stream_reconciles_exactly_as_jax(tmp_path):
    port = kill_mid_stream(PORT, tmp_path)
    jax_ = kill_mid_stream(JAX, tmp_path)
    assert port == jax_
    assert port["kill_window"] == {"victim": 4}
    assert port["answered_shed_dead"] == (24, 0, 0)
    assert port["victim_served"] == 0 and port["victim_records"] == 0
    assert port["reclaimed"] == {
        'zoo_serving_reclaimed_total{from="victim"}': 4.0}
    assert port["acks"] == 24 and port["pel"] == 0
    assert port["duplicates"] == {} and port["writes"] == 24
    assert port["reclaim_events"] == 4
    assert port["reclaim_prev"] == ["victim"]
    assert port["reclaim_deliveries"] == [2]
    assert port["traces"] == 24
    assert port["one_publish_each"] and port["no_failed"]
    assert port["queue_wait_count"] == 20


def ack_lost(pkg):
    pkg.ctx.init_zoo_context(conf={"zoo.faults.enabled": True})
    backend = pkg.Backend()
    xs = enqueue(pkg, backend, 4, prefix="ack")
    reg = pkg.Registry()
    plan = pkg.faults.FaultPlan(seed=5).add("backend.xack", "disconnect",
                                            at=(0,))
    serving = server(pkg, Double(), backend, reg, consumer_name="solo",
                     claim_idle_ms=100, claim_sweep_s=0.02)
    with pkg.faults.activate(plan):
        serving.start()
        try:
            wait_until(lambda: reg.snapshot().get(
                "zoo_serving_acks_total", {"value": 0})["value"] >= 4,
                msg="4 acks")
            outq = pkg.OutputQueue(backend)
            got = {uri: outq.query(uri, timeout=10.0) for uri in xs}
        finally:
            serving.stop(drain=False)
    for uri, x in xs.items():
        np.testing.assert_allclose(got[uri], x * 2.0, rtol=1e-6)
    snap = reg.snapshot()
    return (plan.fired, snap["zoo_serving_records_total"]["value"],
            labelled([snap], "zoo_serving_reclaimed_total"),
            snap["zoo_serving_acks_total"]["value"],
            snap["zoo_serving_failures_total"]["value"],
            backend.pending_len(STREAM, GROUP))


def test_ack_lost_after_publish_reanswers_idempotently_as_jax():
    port, jax_ = ack_lost(PORT), ack_lost(JAX)
    assert port == jax_
    assert port == ([("backend.xack", "disconnect", 0)], 8.0,
                    {'zoo_serving_reclaimed_total{from="solo"}': 4.0},
                    4.0, 0.0, 0)


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p.name)
def test_claim_race_two_survivors_exactly_one_wins(pkg):
    backend = pkg.Backend()
    backend.xgroup_create("race", "g")
    for i in range(64):
        backend.xadd("race", {"uri": f"r{i}"})
    delivered = backend.xreadgroup("race", "g", "dead", 64, block_ms=10)
    assert len(delivered) == 64
    time.sleep(0.03)
    results = {}
    barrier = threading.Barrier(2)

    def claim(name):
        barrier.wait()
        results[name] = backend.xautoclaim("race", "g", name, 20.0,
                                           count=64)

    threads = [threading.Thread(target=claim, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    ids_a = {eid for eid, *_ in results["a"]}
    ids_b = {eid for eid, *_ in results["b"]}
    assert ids_a | ids_b == {eid for eid, _ in delivered}
    assert ids_a & ids_b == set()
    for claimed in results.values():
        assert all(prev == "dead" and times == 2
                   for _eid, _f, prev, times in claimed)


def claim_disconnect(pkg):
    pkg.ctx.init_zoo_context(conf={"zoo.faults.enabled": True})
    backend = pkg.Backend()
    xs = enqueue(pkg, backend, 4, prefix="cl")
    backend.xgroup_create(STREAM, GROUP)
    assert len(backend.xreadgroup(STREAM, GROUP, "dead", 4,
                                  block_ms=10)) == 4
    time.sleep(0.03)
    reg = pkg.Registry()
    plan = pkg.faults.FaultPlan(seed=9).add("backend.xclaim", "disconnect",
                                            at=(0,))
    serving = server(pkg, Double(), backend, reg, consumer_name="survivor",
                     claim_idle_ms=20, claim_sweep_s=0.02)
    with pkg.faults.activate(plan):
        serving.start()
        try:
            outq = pkg.OutputQueue(backend)
            got = {uri: outq.query(uri, timeout=10.0) for uri in xs}
        finally:
            serving.stop(drain=False)
    assert all(v is not None for v in got.values())
    snap = reg.snapshot()
    return (plan.fired,
            snap['zoo_serving_loop_restarts_total{loop="serve"}']["value"],
            labelled([snap], "zoo_serving_reclaimed_total"))


def test_claim_disconnect_absorbed_without_loop_restart_as_jax():
    port, jax_ = claim_disconnect(PORT), claim_disconnect(JAX)
    assert port == jax_ == (
        [("backend.xclaim", "disconnect", 0)], 0.0,
        {'zoo_serving_reclaimed_total{from="dead"}': 4.0})


def max_deliveries(pkg):
    """An entry re-delivered past ``max_deliveries`` is answered with
    the dead-letter error and settled, not reclaimed forever."""
    pkg.ctx.init_zoo_context(conf={"zoo.faults.enabled": False})
    backend = pkg.Backend()
    enqueue(pkg, backend, 2, prefix="md")
    backend.xgroup_create(STREAM, GROUP)
    backend.xreadgroup(STREAM, GROUP, "dead", 2, block_ms=10)
    for _ in range(2):      # two more deliveries to dead peers
        time.sleep(0.03)
        backend.xautoclaim(STREAM, GROUP, "dead", 20.0, count=10)
    time.sleep(0.03)
    reg = pkg.Registry()
    serving = server(pkg, Double(), backend, reg, consumer_name="s",
                     claim_idle_ms=20, claim_sweep_s=0.02,
                     max_deliveries=3)
    serving.start()
    outq = pkg.OutputQueue(backend)
    errors = []
    try:
        for uri in ("md-0", "md-1"):
            with pytest.raises(Exception) as e:
                outq.query(uri, timeout=10.0)
            errors.append(str(e.value))
    finally:
        serving.stop(drain=False)
    snap = reg.snapshot()
    return (errors, labelled([snap], "zoo_serving_reclaimed_total"),
            snap["zoo_serving_dead_letter_total"]["value"],
            labelled([snap], "zoo_serving_failure_errors_total"),
            snap["zoo_serving_acks_total"]["value"],
            backend.pending_len(STREAM, GROUP))


def test_max_deliveries_dead_letters_as_jax():
    port, jax_ = max_deliveries(PORT), max_deliveries(JAX)
    assert port == jax_
    assert port[0] == ["md-0: dead-lettered: exceeded max deliveries",
                       "md-1: dead-lettered: exceeded max deliveries"]
    assert port[2:] == (2.0, {
        'zoo_serving_failure_errors_total{error="dead-lettered: exceeded '
        'max deliveries"}': 2.0}, 2.0, 0)


def mixed_mode(pkg):
    pkg.ctx.init_zoo_context(conf={"zoo.faults.enabled": False})
    backend = pkg.Backend()
    out = []
    legacy = pkg.Serving(Double(), backend=backend, consumer_group="",
                         consumer_name="old", registry=pkg.Registry(),
                         heartbeat_s=0.05).start()
    try:
        grouped = pkg.Serving(Double(), backend=backend,
                              consumer_name="new", registry=pkg.Registry())
        with pytest.raises(RuntimeError, match="mode conflict") as e:
            grouped.start()
        out.append(e.value.args[0].split("(heartbeat")[0])
        # the loser deregistered
        out.append(sorted(backend.fleet_all(STREAM)))
    finally:
        legacy.stop(drain=False)
    out.append(sorted(backend.fleet_all(STREAM)))
    grouped = pkg.Serving(Double(), backend=backend, consumer_name="new",
                          registry=pkg.Registry(), heartbeat_s=0.05).start()
    try:
        with pytest.raises(RuntimeError, match="mode conflict") as e:
            pkg.Serving(Double(), backend=backend, consumer_group="",
                        consumer_name="old-2",
                        registry=pkg.Registry()).start()
        out.append(e.value.args[0].split("(heartbeat")[0])
        payload = json.loads(backend.fleet_all(STREAM)["new"])
        out.append(sorted(payload))
        out.append({k: payload[k] for k in ("mode", "depth", "pending",
                                            "watermark", "saturated",
                                            "batch_target", "endpoint")})
    finally:
        grouped.stop(drain=False)
    out.append(sorted(backend.fleet_all(STREAM)))
    return out


def test_mixed_mode_fleet_fails_loudly_at_start_as_jax():
    port, jax_ = mixed_mode(PORT), mixed_mode(JAX)
    assert port == jax_
    assert port[1] == ["old"] and port[2] == [] and port[-1] == []
    assert port[4] == ["batch_target", "depth", "endpoint", "mode",
                       "pending", "saturated", "ts", "utilization",
                       "watermark"]
    assert port[5] == {"mode": "group:serving", "depth": 0, "pending": 0,
                       "watermark": 0, "saturated": False,
                       "batch_target": 32, "endpoint": None}


def backpressure(pkg):
    """The JAX test's control (blind producers: the replica sheds) and
    treatment (fleet-aware producers refused upstream, no shed)."""
    pkg.ctx.init_zoo_context(conf={"zoo.faults.enabled": False})

    def saturated_setup(n_preload):
        backend = pkg.Backend()
        xs = enqueue(pkg, backend, n_preload, prefix="bp")
        model = Blocking()
        reg = pkg.Registry()
        serving = server(pkg, model, backend, reg, consumer_name="rep",
                         shed_watermark=6, heartbeat_s=0.01,
                         fleet_ttl_s=30.0)
        serving.start()
        assert model.entered.wait(10.0)
        return backend, xs, model, reg, serving

    backend, xs, model, reg, serving = saturated_setup(16)
    inq = pkg.InputQueue(backend, fleet_backpressure=False)
    rng = np.random.default_rng(3)
    extra = {f"bp-x{i}": rng.normal(size=(6,)).astype(np.float32)
             for i in range(5)}
    for uri, x in extra.items():
        inq.enqueue(uri, x)
    model.release.set()
    outq = pkg.OutputQueue(backend)
    answered, errors = {}, {}
    for uri in list(xs) + list(extra):
        try:
            answered[uri] = outq.query(uri, timeout=15.0)
        except Exception as e:
            errors[uri] = str(e)
    serving.stop(drain=False)
    control_shed = total([reg.snapshot()], "zoo_serving_shed_total")
    assert control_shed > 0 and len(errors) == control_shed

    backend, xs, model, reg, serving = saturated_setup(10)
    view = pkg.FleetView(backend, STREAM, cache_s=0.005, ttl_s=30.0)
    inq = pkg.InputQueue(backend, fleet_backpressure=True,
                         fleet_wait_s=0.05, fleet_view=view)
    refusals = []
    for uri, x in extra.items():
        with pytest.raises(pkg.FleetSaturatedError) as e:
            inq.enqueue(uri, x)
        refusals.append(str(e.value))
    model.release.set()
    deadline = time.monotonic() + 15.0
    remaining = dict(extra)
    while remaining and time.monotonic() < deadline:
        for uri, x in list(remaining.items()):
            try:
                inq.enqueue(uri, x)
                del remaining[uri]
            except pkg.FleetSaturatedError:
                time.sleep(0.02)
    assert not remaining
    outq = pkg.OutputQueue(backend)
    got = {uri: outq.query(uri, timeout=15.0)
           for uri in list(xs) + list(extra)}
    serving.stop()
    assert all(v is not None for v in got.values())
    snap = reg.snapshot()
    # the held batch may also be re-answered by the replica's own sweep
    # (its entries idle past claim_idle_ms), so records_total is 15 or
    # more — at least every record once
    assert snap["zoo_serving_records_total"]["value"] >= 15
    return (sorted(errors.values()), len(refusals), sorted(set(refusals)),
            total([snap], "zoo_serving_shed_total"),
            snap["zoo_serving_failures_total"]["value"])


def test_fleet_backpressure_refuses_where_jax_does():
    port, jax_ = backpressure(PORT), backpressure(JAX)
    assert port[1:] == jax_[1:]
    # the control sheds in both; each shed record is answered with the
    # same error (how many shed is a matter of the loop's timing)
    for errors in (port[0], jax_[0]):
        assert errors and all(e.endswith(": shed: server overloaded")
                              for e in errors)
    assert port[1] == 5 and port[3:] == (0, 0.0)
    assert port[2] == [
        "fleet serving stream 'tensor_stream' is saturated (every live "
        "replica above its shed watermark for 0.1s); enqueue refused — "
        "retry with backoff or scale the fleet"]


def scaling_block(pkg):
    pkg.ctx.init_zoo_context(conf={"zoo.faults.enabled": False})
    backend = pkg.Backend()
    reg = pkg.Registry()
    serving = server(pkg, Double(), backend, reg, consumer_name="scale-me")
    srv = serving.serve_metrics(port=0)
    serving.start()
    try:
        xs = enqueue(pkg, backend, 12, prefix="st")
        outq = pkg.OutputQueue(backend)
        got = {uri: outq.query(uri, timeout=10.0) for uri in xs}
        assert all(v is not None for v in got.values())
        wait_until(lambda: reg.snapshot()["zoo_serving_acks_total"][
            "value"] == 12, msg="12 acks")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/statusz", timeout=10) as r:
            status = json.loads(r.read().decode())
        wait_until(lambda: reg.snapshot()["zoo_serving_pending_entries"][
            "value"] == 0, msg="the pending gauge at 0")
        snap = reg.snapshot()
    finally:
        serving.stop(drain=False)
    scaling = dict(status["serving"]["scaling"])
    util = scaling.pop("utilization")
    goodput = scaling.pop("goodput")
    assert 0.0 <= util <= 1.0
    assert goodput is None or 0.0 <= goodput <= 1.0
    assert 0.0 <= snap["zoo_serving_utilization"]["value"] <= 1.0
    return (scaling, snap["zoo_serving_pending_entries"]["value"],
            snap["zoo_serving_acks_total"]["value"],
            sorted(status["serving"]))


def test_statusz_scaling_block_has_the_jax_keys_and_values():
    port, jax_ = scaling_block(PORT), scaling_block(JAX)
    assert port == jax_
    assert port[0] == {"consumer": "scale-me", "group": GROUP,
                       "stream_depth": 0, "pending_entries": 0,
                       "batch_size_target": 4}
    assert port[1:3] == (0.0, 12.0)
    assert "scaling" in port[3]
    assert pserver.HEALTH_NOT_PORTED == {"serving": (), "models": ()}


def test_heartbeat_thread_beats_while_the_loop_is_held():
    """The heartbeat thread keeps a replica's entry fresh while its
    serve loop sits in a long dispatch (both packages); a kill stops the
    beats and leaves the entry to age out."""
    ages = {}
    for pkg in BOTH:
        pkg.ctx.init_zoo_context(conf={"zoo.faults.enabled": False})
        backend = pkg.Backend()
        enqueue(pkg, backend, 4, prefix="hb")
        model = Blocking()
        s = server(pkg, model, backend, pkg.Registry(), consumer_name="hb",
                   heartbeat_s=0.02)
        s.start()
        assert model.entered.wait(10.0)
        time.sleep(0.4)
        # without the thread the newest beat would be the loop's last
        # one, from before the held dispatch: at least 0.4 s old
        ts = json.loads(backend.fleet_all(STREAM)["hb"])["ts"]
        fresh = time.time() - ts
        s.kill(join=False)
        model.release.set()
        s.kill()
        time.sleep(0.2)
        ts2 = json.loads(backend.fleet_all(STREAM)["hb"])["ts"]
        ages[pkg.name] = (fresh < 0.3, time.time() - ts2 >= 0.2,
                          pkg.fleet.live_members(backend, STREAM,
                                                 ttl_s=0.05) == {})
    assert ages["port"] == ages["jax"] == (True, True, True)
