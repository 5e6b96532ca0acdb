"""Overload and reliability of the port's ``ClusterServing`` held against
the JAX server on the same traffic: depth shedding, deadline admission
(expired and doomed), the AIMD batch target's trajectory, publish
outages spilled to the dead-letter queue and replayed, the publish
breaker, dispatch poison isolated record by record, the shared retry
budget, supervised loop restarts and the ``/statusz`` overload block —
plus ``RetryBudget`` and ``AIMDController`` against the JAX classes on
the same sequences.

Both servers serve a small ``Sequential`` whose weights are carried
across from the JAX tree (or the same plain ``predict`` object); records
are pre-enqueued so reads, batches and outcomes are deterministic. Fault
plans run in each package's own ``common.faults`` under
``zoo.faults.enabled``. The p99 comparison of shed and unshedded runs
is timed, so it runs on the port alone, as in the JAX test."""

import json
import time
import types
import urllib.request

import jax
import numpy as np
import pytest

from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu import serving as jserving
from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.common import faults as jfaults
from analytics_zoo_tpu.common import reliability as jrel
from analytics_zoo_tpu.observability import read_events
from analytics_zoo_tpu.pipeline.api.keras.engine import \
    Sequential as JaxSequential
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JaxDense
from analytics_zoo_tpu.pipeline.inference import InferenceModel as JaxIM
from analytics_zoo_tpu_torch import observability as pobs
from analytics_zoo_tpu_torch import serving as pserving
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.common import faults as pfaults
from analytics_zoo_tpu_torch.common import reliability as prel
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

SHED_ERR = "shed: server overloaded"
PUB_ERR = "result publish failed"

PORT = types.SimpleNamespace(
    name="port", Serving=pserving.ClusterServing,
    Backend=pserving.LocalBackend, InputQueue=pserving.InputQueue,
    OutputQueue=pserving.OutputQueue, ServingError=pserving.ServingError,
    DLQ=pserving.DeadLetterQueue, Registry=pobs.MetricsRegistry,
    rel=prel, faults=pfaults, ctx=pctx)
JAX = types.SimpleNamespace(
    name="jax", Serving=jserving.ClusterServing,
    Backend=jserving.LocalBackend, InputQueue=jserving.InputQueue,
    OutputQueue=jserving.OutputQueue, ServingError=jserving.ServingError,
    DLQ=jserving.DeadLetterQueue, Registry=jobs.MetricsRegistry,
    rel=jrel, faults=jfaults, ctx=jctx)
PKGS = (PORT, JAX)


@pytest.fixture(autouse=True)
def contexts():
    pctx.init_zoo_context(faults_enabled=True)
    jctx.init_zoo_context(faults_enabled=True)
    peng.reset_uids()
    yield
    pctx.reset_zoo_context()
    jctx.init_zoo_context(faults_enabled=False)


@pytest.fixture(scope="module")
def models():
    """``{"port": InferenceModel, "jax": InferenceModel}`` on the same
    weights (a JAX Sequential's carried across)."""
    jm = JaxSequential([JaxDense(4, activation="relu", input_shape=(6,)),
                        JaxDense(3, activation="softmax")])
    jm.init_weights(rng=jax.random.key(17))
    pm = peng.Sequential([Dense(4, activation="relu", input_shape=(6,)),
                          Dense(3, activation="softmax")], device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
    return {"port": InferenceModel(device="cpu").from_keras(pm),
            "jax": JaxIM().from_keras(jm)}


def _xs(n, prefix="o", seed=17):
    rng = np.random.default_rng(seed)
    return {f"{prefix}-{i}": rng.normal(size=(6,)).astype(np.float32)
            for i in range(n)}


def _enqueue(pkg, backend, xs, deadline_ms=None):
    inq = pkg.InputQueue(backend)
    for uri, x in xs.items():
        inq.enqueue(uri, x, deadline_ms=deadline_ms)


def _query_all(pkg, backend, uris, timeout=30.0):
    outq = pkg.OutputQueue(backend)
    out = {}
    for uri in uris:
        try:
            out[uri] = ("value", outq.query(uri, timeout=timeout))
        except pkg.ServingError as e:
            out[uri] = ("error", str(e))
    return out


def _run(pkg, model, xs, plan=None, events=None, live=None, **kw):
    """Pre-enqueue ``xs``, serve them to the end under ``plan``, stop.
    Returns the answers, the snapshot, the stopped server and what
    ``live(server)`` returned while it served."""
    reg = kw.pop("registry", None) or pkg.Registry()
    backend = kw.pop("backend", None) or pkg.Backend()
    _enqueue(pkg, backend, xs, kw.pop("deadline_ms", None))
    kw.setdefault("batch_size", 4)
    kw.setdefault("block_ms", 20)
    server = pkg.Serving(model, backend=backend, registry=reg, **kw)
    if events is not None:
        server.set_json_events(events)
    seen = None
    ctx = pkg.faults.activate(plan) if plan is not None else _nothing()
    with ctx:
        server.start()
        try:
            got = _query_all(pkg, backend, list(xs))
            if live is not None:
                seen = live(server)
        finally:
            server.stop(drain=False)
    return got, reg.snapshot(), server, seen


class _Scale:
    """A sync model: x * factor."""

    def __init__(self, factor):
        self.factor = factor

    def predict(self, x):
        return np.asarray(x) * self.factor


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def _same_answers(a, b, atol=1e-5):
    assert a.keys() == b.keys()
    for uri in a:
        assert a[uri][0] == b[uri][0], (uri, a[uri], b[uri])
        if a[uri][0] == "value":
            np.testing.assert_allclose(a[uri][1], b[uri][1], atol=atol,
                                       rtol=0)
        else:
            assert a[uri][1] == b[uri][1]


def _values(snap, *families):
    return {k: v["value"] for k, v in snap.items()
            if k.split("{", 1)[0] in families}


def _phases(path):
    by_trace = {}
    for e in read_events(path, kind="request"):
        by_trace.setdefault(e["uri"], []).append(e["phase"])
    return by_trace


# ---------------------------------------------------------------------------
# admission control + load shedding
# ---------------------------------------------------------------------------

def test_depth_shedding_reconciles_exactly(models, tmp_path):
    """40 pre-enqueued records against watermark 8, batch 4: the first
    window admits its oldest 4 and sheds its newest 28; 12 serve. The
    answers, counters, ``/statusz``'s overload block, ``/healthz`` (up)
    and the traces equal the JAX server's."""
    xs = _xs(40)
    runs = {}
    for pkg in PKGS:
        def live(server):
            return server._health_info()
        got, snap, server, health = _run(
            pkg, models[pkg.name], xs, shed_watermark=8,
            events=str(tmp_path / f"{pkg.name}.jsonl"), live=live)
        runs[pkg.name] = (got, snap, health,
                          _phases(str(tmp_path / f"{pkg.name}.jsonl")))
    p, j = runs["port"], runs["jax"]
    _same_answers(p[0], j[0])
    shed = {u for u, (k, v) in p[0].items() if k == "error"}
    assert len(shed) == 28 and {f"o-{i}" for i in range(4)}.isdisjoint(shed)
    assert all(p[0][u][1] == f"{u}: {SHED_ERR}" for u in shed)
    fams = ("zoo_serving_shed_total", "zoo_serving_failure_errors_total",
            "zoo_serving_records_total", "zoo_serving_failures_total")
    assert _values(p[1], *fams) == _values(j[1], *fams)
    assert p[2].get("status") != "down"
    assert p[2]["serving"]["overload"] == j[2]["serving"]["overload"]
    assert p[2]["serving"]["overload"]["shed_depth_total"] == 28
    assert p[3] == j[3] and len(p[3]) == 12
    assert all(ph.count("publish") == 1 for ph in p[3].values())


def test_deadline_doomed_records_shed_before_dispatch(models):
    """A record whose headroom is below the dispatch median (seeded past
    the warm-up) is answered ``deadline exceeded`` and counted as a
    deadline shed; one with headroom serves."""
    x = np.random.default_rng(4).normal(size=(6,)).astype(np.float32)
    runs = []
    for pkg in PKGS:
        reg = pkg.Registry()
        backend = pkg.Backend()
        now_ms = int(time.time() * 1000)
        inq = pkg.InputQueue(backend)
        inq.enqueue("doomed", x, deadline_ms=now_ms + 2_000)
        inq.enqueue("fine", x, deadline_ms=now_ms + 60_000_000)
        server = pkg.Serving(models[pkg.name], backend=backend, registry=reg,
                             batch_size=4, block_ms=20)
        server._q_dispatch.observe(10.0, n=16)
        server.start()
        try:
            got = _query_all(pkg, backend, ["doomed", "fine"])
        finally:
            server.stop(drain=False)
        runs.append((got, _values(reg.snapshot(), "zoo_serving_shed_total",
                                  "zoo_serving_deadline_exceeded_total",
                                  "zoo_serving_records_total")))
    _same_answers(runs[0][0], runs[1][0])
    assert runs[0][0]["doomed"] == ("error", "doomed: deadline exceeded")
    assert runs[0][1] == runs[1][1]
    assert runs[0][1]['zoo_serving_shed_total{reason="deadline"}'] == 1


def test_deadline_admission_waits_out_cold_start(models):
    """One cold-start-sized dispatch observation (below the warm-up
    count) does not refuse a record with 5 s of headroom."""
    x = np.random.default_rng(5).normal(size=(6,)).astype(np.float32)
    for pkg in PKGS:
        reg = pkg.Registry()
        backend = pkg.Backend()
        pkg.InputQueue(backend).enqueue(
            "cold", x, deadline_ms=int(time.time() * 1000) + 5_000)
        server = pkg.Serving(models[pkg.name], backend=backend, registry=reg,
                             batch_size=4, block_ms=20)
        server._q_dispatch.observe(30.0)
        server.start()
        try:
            assert pkg.OutputQueue(backend).query("cold",
                                                  timeout=30.0) is not None
        finally:
            server.stop(drain=False)
        assert reg.snapshot()['zoo_serving_shed_total{reason="deadline"}'][
            "value"] == 0


def test_expired_deadline_is_answered_before_any_dispatch():
    """Records whose ``deadline_ms`` already passed are answered
    ``deadline exceeded`` and never reach the model; the rest serve."""
    runs = []
    for pkg in PKGS:
        class Seen:
            rows = []

            def predict(self, x):
                self.rows.extend(np.asarray(x).tolist())
                return np.asarray(x) * 2.0
        late = _xs(6, prefix="late")
        ok = _xs(3, prefix="ok", seed=3)
        backend = pkg.Backend()
        _enqueue(pkg, backend, late, deadline_ms=int(time.time() * 1000) - 1)
        model = Seen()
        got, snap, _, _ = _run(pkg, model, ok, backend=backend)
        got.update(_query_all(pkg, backend, list(late), timeout=1.0))
        # the model saw only the live records (padding repeats them)
        assert {tuple(r) for r in model.rows} == {
            tuple(x.tolist()) for x in ok.values()}
        runs.append((got, len(model.rows),
                     _values(snap, "zoo_serving_deadline_exceeded_total",
                             "zoo_serving_shed_total",
                             "zoo_serving_failure_errors_total")))
    _same_answers(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]
    assert runs[0][2] == runs[1][2]
    assert runs[0][2]["zoo_serving_deadline_exceeded_total"] == 6


# ---------------------------------------------------------------------------
# adaptive batch sizing (AIMD)
# ---------------------------------------------------------------------------

def _trajectory(server):
    """Wrap the primary lane's controller to record every target."""
    ctl = server._lanes[server._primary].batch_ctl
    seen = []
    update = ctl.update

    def recording(breach):
        seen.append(update(breach))
        return seen[-1]
    ctl.update = recording
    return seen


@pytest.mark.parametrize("case", ["backoff", "grow"])
def test_adaptive_batch_trajectory_matches_jax(models, case):
    """With the queue-wait target below any wait every read breaches and
    the target halves to the floor (4 → 2 → 1); with it above any wait it
    grows by one a read to the ceiling (2, 3, …, 8). The whole trajectory,
    read by read, and the gauges equal the JAX server's."""
    n, kw = ((24, dict(batch_size=4, queue_wait_target_s=-1.0))
             if case == "backoff" else
             (40, dict(batch_size=8, queue_wait_target_s=1e9)))
    runs = {}
    for pkg in PKGS:
        if case == "grow":
            kw["batch_controller"] = pkg.rel.AIMDController(
                floor=1, ceiling=8, initial=2)
        reg = pkg.Registry()
        backend = pkg.Backend()
        xs = _xs(n, prefix="ab")
        _enqueue(pkg, backend, xs)
        # a publish queue deeper than any backlog here: the breach is the
        # queue wait alone
        server = pkg.Serving(models[pkg.name], backend=backend, registry=reg,
                             block_ms=20, adaptive_batch=True,
                             publish_queue=256, **kw)
        seen = _trajectory(server)
        server.start()
        try:
            got = _query_all(pkg, backend, list(xs))
        finally:
            server.stop(drain=False)
        snap = reg.snapshot()
        runs[pkg.name] = (got, seen, _values(
            snap, "zoo_serving_batch_size_target",
            "zoo_serving_model_batch_target", "zoo_serving_records_total"),
            server._health_info()["serving"]["overload"][
                "batch_size_target"])
    _same_answers(runs["port"][0], runs["jax"][0])
    assert runs["port"][1:] == runs["jax"][1:]
    seen = runs["port"][1]
    if case == "backoff":
        assert seen[:3] == [2, 1, 1] and set(seen[2:]) == {1}
        assert runs["port"][2]["zoo_serving_batch_size_target"] == 1
    else:
        assert seen[:7] == [3, 4, 5, 6, 7, 8, 8]
        assert runs["port"][2]["zoo_serving_batch_size_target"] == 8
    assert all(1 <= t <= kw["batch_size"] for t in seen)


@pytest.mark.parametrize("seq", [
    [True] * 7, [False] * 12, [True, False] * 6,
    [False, False, True, False, True, True, False, False, False]])
@pytest.mark.parametrize("params", [
    dict(floor=1, ceiling=32), dict(floor=2, ceiling=9, initial=3, add=2.5,
                                    backoff=0.7)])
def test_aimd_controller_matches_jax(seq, params):
    ps, js = prel.AIMDController(**params), jrel.AIMDController(**params)
    assert [ps.update(b) for b in seq] == [js.update(b) for b in seq]
    assert ps.value == js.value


@pytest.mark.parametrize("bad", [dict(floor=0), dict(floor=4, ceiling=2),
                                 dict(add=0), dict(backoff=1.0),
                                 dict(initial=64)])
def test_aimd_controller_refuses_as_jax(bad):
    msgs = []
    for rel in (prel, jrel):
        with pytest.raises(ValueError) as e:
            rel.AIMDController(**bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("ops", [
    "w" * 5, "wwsws" * 3, "s" * 4 + "w" * 8, "wswswwwwsss" * 2])
def test_retry_budget_matches_jax(ops):
    """The same withdraw (w) / success (s) sequence gives the same
    answers, tokens and exhausted count."""
    out = []
    for rel, reg in ((prel, pobs.MetricsRegistry()),
                     (jrel, jobs.MetricsRegistry())):
        b = rel.RetryBudget(capacity=3, deposit=0.5, name="t", registry=reg)
        got = [b.withdraw() if op == "w" else b.on_success() for op in ops]
        out.append((got, b.tokens, reg.snapshot()[
            'zoo_retry_budget_exhausted_total{budget="t"}']["value"]))
    assert out[0] == out[1]
    with pytest.raises(ValueError):
        prel.RetryBudget(capacity=0.5)


# ---------------------------------------------------------------------------
# durable DLQ: publish outage → spill → replay
# ---------------------------------------------------------------------------

def test_publish_outage_spills_to_dlq_and_replay_serves_exactly_once(
        models, tmp_path):
    """The first 3 result writes die: those 12 records are answered with
    the publish error and spill to the DLQ, the other 12 serve; replayed
    after recovery, every dead letter serves exactly once under a fresh
    trace — the same sets and counts as the JAX server."""
    xs = _xs(24, prefix="po")
    runs = {}
    for pkg in PKGS:
        reg = pkg.Registry()
        dlq = pkg.DLQ(str(tmp_path / f"dlq-{pkg.name}"), registry=reg)
        plan = pkg.faults.FaultPlan(seed=6).add(
            "backend.set_results", "disconnect", at=(0, 1, 2))
        backend = pkg.Backend()
        ev1 = str(tmp_path / f"{pkg.name}-1.jsonl")
        got, snap, server, _ = _run(
            pkg, models[pkg.name], xs, plan=plan, events=ev1,
            registry=reg, backend=backend, dlq=dlq,
            publish_breaker=pkg.rel.CircuitBreaker(
                "serving.publish", failure_threshold=100,
                reset_timeout=0.05, registry=reg))
        failed = sorted(u for u, (k, v) in got.items()
                        if k == "error" and PUB_ERR in v)
        spilled = sorted(r["uri"] for _s, r in dlq.scan())
        counts = _values(snap, "zoo_serving_dlq_spilled_total",
                         "zoo_serving_failure_errors_total",
                         "zoo_serving_records_total")
        phases1 = _phases(ev1)
        assert dlq.replay(backend) == 12 and dlq.depth == 0
        ev2 = str(tmp_path / f"{pkg.name}-2.jsonl")
        server.set_json_events(ev2)
        server.start()
        try:
            again = _query_all(pkg, backend, failed)
        finally:
            server.stop(drain=False)
        runs[pkg.name] = dict(got=got, fired=plan.fired, failed=failed,
                              spilled=spilled, counts=counts,
                              phases1=phases1, again=again,
                              second=dlq.replay(backend),
                              phases2=_phases(ev2),
                              replayed=reg.snapshot()[
                                  "zoo_serving_dlq_replayed_total"]["value"])
    p, j = runs["port"], runs["jax"]
    _same_answers(p["got"], j["got"])
    _same_answers(p["again"], j["again"])
    for key in ("fired", "failed", "spilled", "counts", "phases1",
                "second", "phases2", "replayed"):
        assert p[key] == j[key], key
    assert p["fired"] == [("backend.set_results", "disconnect", i)
                          for i in range(3)]
    assert p["failed"] == p["spilled"] and len(p["failed"]) == 12
    assert all(k == "value" for k, _v in p["again"].values())
    assert p["second"] == 0 and p["replayed"] == 12


def test_publish_breaker_trips_and_fast_fails_to_dlq(models, tmp_path):
    """A sustained outage: the publish breaker opens after 2 attempts and
    later batches spill without touching the store."""
    xs = _xs(24, prefix="br")
    runs = []
    for pkg in PKGS:
        reg = pkg.Registry()
        dlq = pkg.DLQ(str(tmp_path / f"dlq-{pkg.name}"), registry=reg)
        plan = pkg.faults.FaultPlan(seed=9).add(
            "backend.set_results", "disconnect", at=tuple(range(100)))
        got, snap, _, _ = _run(
            pkg, models[pkg.name], xs, plan=plan, registry=reg, dlq=dlq,
            publish_breaker=pkg.rel.CircuitBreaker(
                "serving.publish", failure_threshold=2,
                reset_timeout=10.0, registry=reg))
        runs.append((got, len(plan.fired), dlq.depth,
                     _values(snap, "zoo_breaker_transitions_total",
                             "zoo_breaker_state",
                             "zoo_serving_dlq_spilled_total")))
    _same_answers(runs[0][0], runs[1][0])
    assert runs[0][1:] == runs[1][1:]
    assert runs[0][1] == 2 and runs[0][2] == 24
    assert all(v == (f"{u}: {PUB_ERR}") for u, (_k, v) in runs[0][0].items())


def test_dispatch_poison_dead_letters_into_dlq(models, tmp_path):
    """Every dispatch crashes (the ``serving.dispatch`` site): each record
    is retried alone, dead-lettered and spilled with its original bytes."""
    import base64
    xs = _xs(2, prefix="px")
    runs = []
    for pkg in PKGS:
        reg = pkg.Registry()
        dlq = pkg.DLQ(str(tmp_path / f"dlq-{pkg.name}"), registry=reg)
        plan = pkg.faults.FaultPlan(seed=2).add(
            "serving.dispatch", "error", at=tuple(range(32)))
        got, snap, _, _ = _run(pkg, models[pkg.name], xs, plan=plan,
                               registry=reg, dlq=dlq)
        recs = {r["uri"]: r for _s, r in dlq.scan()}
        for uri, rec in recs.items():
            arr = np.frombuffer(base64.b64decode(rec["data"]),
                                dtype=rec["dtype"]).reshape(6)
            np.testing.assert_array_equal(arr, xs[uri])
        runs.append((got, plan.fired,
                     {u: (r["reason"], r["model"]) for u, r in recs.items()},
                     _values(snap, "zoo_serving_dlq_spilled_total",
                             "zoo_serving_dead_letter_total",
                             "zoo_retry_attempts_total")))
    _same_answers(runs[0][0], runs[1][0])
    assert runs[0][1:] == runs[1][1:]
    assert all("dead-lettered" in v for _k, v in runs[0][0].values())
    assert len(runs[0][1]) == 3          # the batch + one solo each


def test_drained_retry_budget_dead_letters_without_solo_retries(tmp_path):
    """A shared ``RetryBudget`` with one token: after a poison batch the
    first record gets its solo retry, the rest are dead-lettered without
    one — the same answers and counts as the JAX server."""
    class Poison:
        def predict(self, x):
            if np.any(np.asarray(x) < -1.0):
                raise RuntimeError("poison")
            return np.asarray(x) * 2.0
    xs = {f"rb-{i}": np.full(6, v, np.float32)
          for i, v in enumerate((0.5, -2.0, 0.25, 0.75))}
    runs = []
    for pkg in PKGS:
        reg = pkg.Registry()
        budget = pkg.rel.RetryBudget(capacity=1, deposit=0.0, name="s",
                                     registry=reg)
        got, snap, _, _ = _run(pkg, Poison(), xs, registry=reg,
                               retry_budget=budget)
        runs.append((got, _values(snap, "zoo_retry_budget_exhausted_total",
                                  "zoo_serving_dead_letter_total",
                                  "zoo_retry_attempts_total")))
    _same_answers(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]
    assert runs[0][0]["rb-0"][0] == "value"
    assert [runs[0][0][f"rb-{i}"][0] for i in (1, 2, 3)] == ["error"] * 3


# ---------------------------------------------------------------------------
# supervised restarts
# ---------------------------------------------------------------------------

def test_a_loop_fault_restarts_the_serve_loop_and_loses_nothing(models):
    """``serving.loop`` fires once: the supervisor restarts the loop
    (``zoo_serving_loop_restarts_total{loop="serve"}`` = 1), /healthz
    stays up and every record is answered."""
    xs = _xs(10, prefix="rs")
    runs = []
    for pkg in PKGS:
        plan = pkg.faults.FaultPlan(seed=1).add("serving.loop", "error",
                                                at=(2,))
        got, snap, server, _ = _run(pkg, models[pkg.name], xs, plan=plan)
        runs.append((got, plan.fired, _values(
            snap, "zoo_serving_loop_restarts_total",
            "zoo_serving_records_total"),
            server._health_info().get("status"),
            "FaultError" in server._health_info()["serving"]["last_crash"][
                "serve"]))
    _same_answers(runs[0][0], runs[1][0])
    assert runs[0][1:] == runs[1][1:]
    assert runs[0][2]['zoo_serving_loop_restarts_total{loop="serve"}'] == 1
    assert runs[0][3] is None and runs[0][4] is True


def test_the_supervisor_gives_up_after_max_loop_restarts(models):
    """A loop that crashes every iteration is restarted
    ``max_loop_restarts`` times, then /healthz reads down with the
    traceback."""
    for pkg in PKGS:
        plan = pkg.faults.FaultPlan(seed=1).add("serving.loop", "error",
                                                at=tuple(range(100)))
        reg = pkg.Registry()
        server = pkg.Serving(
            models[pkg.name], backend=pkg.Backend(), registry=reg,
            max_loop_restarts=2,
            restart_backoff=pkg.rel.RetryPolicy(max_attempts=3,
                                                base_delay=0.001,
                                                max_delay=0.002))
        with pkg.faults.activate(plan):
            server.start()
            server._thread.join(timeout=30)
        info = server._health_info()
        server.stop(drain=False)
        assert info["status"] == "down", pkg.name
        assert info["serving"]["loops_down"] == ["serve"]
        assert len(plan.fired) == 3
        assert reg.snapshot()['zoo_serving_loop_restarts_total{loop="serve"}'
                              ]["value"] == 2


# ---------------------------------------------------------------------------
# the /statusz overload block
# ---------------------------------------------------------------------------

def test_statusz_overload_block_with_a_dlq_matches_jax(models, tmp_path):
    """With a DLQ and AIMD on, ``/statusz``'s overload block — the
    watermark, both shed totals, the batch target, the publish breaker,
    the DLQ's records and bytes — equals the JAX server's."""
    xs = _xs(12, prefix="ov")
    blocks = []
    for pkg in PKGS:
        reg = pkg.Registry()
        dlq = pkg.DLQ(str(tmp_path / f"dlq-{pkg.name}"), registry=reg)
        dlq.append("old", np.zeros(3, np.float32), reason="publish",
                   trace="0" * 16, error="x")

        def live(server):
            scrape = server.serve_metrics(0)
            url = f"http://{scrape.host}:{scrape.port}/statusz"
            with urllib.request.urlopen(url, timeout=10) as r:
                return json.loads(r.read())["serving"]["overload"]
        got, _, _, block = _run(
            pkg, models[pkg.name], xs, registry=reg, dlq=dlq,
            shed_watermark=64, adaptive_batch=True,
            queue_wait_target_s=1e9, live=live)
        assert all(k == "value" for k, _v in got.values())
        blocks.append(block)
    assert blocks[0] == blocks[1]
    assert blocks[0]["dlq_records"] == 1 and blocks[0]["dlq_bytes"] > 0
    assert blocks[0]["shed_watermark"] == 64


# ---------------------------------------------------------------------------
# acceptance: shedding bounds admitted p99 (port; timed)
# ---------------------------------------------------------------------------

class _SlowModel:
    """A sync model with 20 ms a dispatch: queueing delay rules the
    latency, so the comparison is about the backlog, not CPU noise."""

    def __init__(self, im, delay_s):
        self._im = im
        self.delay_s = delay_s

    def predict(self, x):
        time.sleep(self.delay_s)
        return np.asarray(self._im.predict(x))


def _p99(models, n, watermark):
    im = models["port"]
    im.predict(np.zeros((4, 6), np.float32))
    got, _, server, families = _run(
        PORT, _SlowModel(im, 0.02), _xs(n, prefix=f"p{watermark}"),
        shed_watermark=watermark,
        live=lambda s: pobs.parse_prometheus(
            pobs.render_prometheus(s.metrics)))
    fam = families["zoo_serving_e2e_quantiles_seconds"]
    p99 = next(v for _name, lab, v in fam["samples"]
               if lab.get("quantile") == "0.99")
    return p99, got


def test_shedding_bounds_admitted_p99_vs_unshedded_control(models):
    """The unshedded control's p99 grows with the backlog (60 records
    wait longer than 30 at the tail); with the watermark on, the admitted
    records' p99 stays well under the control's while the overflow is
    shed."""
    p99_small, a_small = _p99(models, 30, 0)
    p99_big, a_big = _p99(models, 60, 0)
    p99_shed, a_shed = _p99(models, 60, 8)
    assert all(k == "value" for k, _ in a_small.values())
    assert all(k == "value" for k, _ in a_big.values())
    assert p99_big > p99_small * 1.4, (p99_small, p99_big)
    shed = sum(1 for k, v in a_shed.values() if k == "error" and SHED_ERR in v)
    served = sum(1 for k, _ in a_shed.values() if k == "value")
    assert shed > 0 and shed + served == 60
    assert p99_shed * 2 < p99_big, (p99_shed, p99_big)


# ---------------------------------------------------------------------------
# conf keys
# ---------------------------------------------------------------------------

SERVING_KEYS = ("zoo.serving.shed_watermark", "zoo.serving.adaptive_batch",
                "zoo.serving.queue_wait_target_ms",
                "zoo.serving.shape_buckets", "zoo.serving.lane_max_inflight",
                "zoo.serving.lane_batch_size", "zoo.serving.dlq_dir",
                "zoo.serving.dlq_max_bytes", "zoo.serving.consumer_group")


def test_serving_conf_defaults_match_jax():
    for k in SERVING_KEYS:
        assert pctx.DEFAULT_CONF[k] == jctx.DEFAULT_CONF[k], k
        assert type(pctx.DEFAULT_CONF[k]) is type(jctx.DEFAULT_CONF[k]), k


@pytest.mark.parametrize("conf", [
    {"zoo.serving.shed_watermark": 7, "zoo.serving.adaptive_batch": True,
     "zoo.serving.queue_wait_target_ms": 120},
    {"zoo.serving.shape_buckets": "2,8", "zoo.serving.consumer_group": ""},
    {"zoo.serving.dlq_dir": "DLQ", "zoo.serving.dlq_max_bytes": 4096}])
def test_the_server_reads_its_serving_conf_as_jax(tmp_path, conf):
    """Knobs left to the conf are read from it the same way."""
    conf = {k: (str(tmp_path / v) if k.endswith("dlq_dir") else v)
            for k, v in conf.items()}
    got = []
    for pkg in PKGS:
        pkg.ctx.init_zoo_context(conf=conf)
        s = pkg.Serving(_Scale(1.0), backend=pkg.Backend(), batch_size=8,
                        registry=pkg.Registry())
        got.append((s.shed_watermark, s.adaptive_batch,
                    s.queue_wait_target_s, s.shape_buckets,
                    s.consumer_group, s._group_mode,
                    None if s._dlq is None else
                    (s._dlq.directory == conf["zoo.serving.dlq_dir"],
                     s._dlq.max_bytes)))
    jctx.init_zoo_context(conf={k: jctx.DEFAULT_CONF[k]
                                for k in SERVING_KEYS})
    assert got[0] == got[1]



def test_kill_abandons_read_records_pending_as_jax():
    """``kill()`` dies like a SIGKILL: a batch in the model's hands is
    neither published nor answered nor acked — its entries stay pending
    under this consumer — in both packages."""
    import threading
    out = []
    for pkg in PKGS:
        entered, release = threading.Event(), threading.Event()

        class Blocking:
            def predict(self, x):
                entered.set()
                release.wait(30)
                return np.asarray(x)

        backend = pkg.Backend()
        _enqueue(pkg, backend, _xs(4, prefix="k"))
        server = pkg.Serving(Blocking(), backend=backend, batch_size=4,
                             registry=pkg.Registry(),
                             consumer_name="victim").start()
        assert entered.wait(30)
        server.kill(join=False)
        release.set()
        server.kill()
        out.append((backend.xpending("tensor_stream", "serving"),
                    [backend.pop_result(f"k-{i}", timeout=0.05)
                     for i in range(4)], server.served))
    assert out[0] == out[1] == ({"victim": 4}, [None] * 4, 0)
