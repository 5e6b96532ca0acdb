"""Multi-model serving lanes, shape buckets and batch arenas: the port's
``ClusterServing`` held against the JAX server on the same traffic.

Each scenario runs through both packages — the same models (plain
``predict`` objects shared by both, or a small ``Sequential`` whose
weights are carried across from the JAX tree), the same records — and
compares what can be compared exactly: answers, the lane and the bucket
of every record, per-model counters, pad rows, breaker states, the
``/statusz`` ``models`` rows and the status CLIs' tables, and the
configuration errors letter for letter. The JAX test of compiles per
bucket becomes here "the model saw only bucket-sized batches", counted
by a recording model (the port has no jit to count)."""

import contextlib
import io
import json
import os
import re
import runpy
import sys
import time
import types
import urllib.request

import jax
import numpy as np
import pytest

from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.common import reliability as jrel
from analytics_zoo_tpu.observability import read_events
from analytics_zoo_tpu.pipeline.api.keras.engine import \
    Sequential as JaxSequential
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JaxDense
from analytics_zoo_tpu.pipeline.inference import InferenceModel as JaxIM
from analytics_zoo_tpu import serving as jserving
from analytics_zoo_tpu.serving import server as jserver
from analytics_zoo_tpu_torch import observability as pobs
from analytics_zoo_tpu_torch import serving as pserving
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.common import reliability as prel
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
from analytics_zoo_tpu_torch.serving import server as pserver
from analytics_zoo_tpu_torch.serving import status as pstatus

JAX_STATUS_CLI = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "cluster-serving-status")

PORT = types.SimpleNamespace(
    name="port", Serving=pserving.ClusterServing,
    Backend=pserving.LocalBackend, InputQueue=pserving.InputQueue,
    OutputQueue=pserving.OutputQueue, ServingError=pserving.ServingError,
    DLQ=pserving.DeadLetterQueue, Registry=pobs.MetricsRegistry,
    Breaker=prel.CircuitBreaker, server=pserver, ctx=pctx)
JAX = types.SimpleNamespace(
    name="jax", Serving=jserving.ClusterServing,
    Backend=jserving.LocalBackend, InputQueue=jserving.InputQueue,
    OutputQueue=jserving.OutputQueue, ServingError=jserving.ServingError,
    DLQ=jserving.DeadLetterQueue, Registry=jobs.MetricsRegistry,
    Breaker=jrel.CircuitBreaker, server=jserver, ctx=jctx)
PKGS = (PORT, JAX)


@pytest.fixture(autouse=True)
def contexts():
    pctx.reset_zoo_context()
    peng.reset_uids()
    yield
    pctx.reset_zoo_context()
    jctx.init_zoo_context(conf={"zoo.serving.lane_batch_size": "",
                                "zoo.serving.lane_max_inflight": ""})


class _Scale:
    """A sync model: x * factor — an answer names the lane that made it.
    ``calls`` records each dispatch's row count."""

    def __init__(self, factor):
        self.factor = float(factor)
        self.calls = []

    def predict(self, x):
        self.calls.append(len(x))
        return np.asarray(x) * self.factor


class _Boom:
    """A model whose every dispatch raises in Python: the poison lane."""

    def predict(self, x):
        raise RuntimeError("boom")


class _Recording:
    """An async model wrapper that records the batch rows it is handed."""

    def __init__(self, model):
        self.model = model
        self.rows = []

    def predict_async(self, x, block=True):
        collect = self.model.predict_async(x, block=block)
        if collect is not None:
            self.rows.append(len(x))
        return collect


def _nets():
    """A JAX Sequential and the port's on the same weights."""
    jm = JaxSequential([JaxDense(4, activation="relu", input_shape=(6,)),
                        JaxDense(3, activation="softmax")])
    jm.init_weights(rng=jax.random.key(11))
    pm = peng.Sequential([Dense(4, activation="relu", input_shape=(6,)),
                          Dense(3, activation="softmax")], device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
    return jm, pm


def _query_all(pkg, backend, uris, timeout=30.0):
    outq = pkg.OutputQueue(backend)
    out = {}
    for uri in uris:
        try:
            out[uri] = ("value", outq.query(uri, timeout=timeout))
        except pkg.ServingError as e:
            out[uri] = ("error", str(e))
    return out


def _enqueue(pkg, backend, records):
    """``records``: ``[(uri, array, model or None)]``."""
    inq = pkg.InputQueue(backend)
    for uri, x, model in records:
        inq.enqueue(uri, x, model=model)


def _serve(pkg, model, records, pre=True, events=None, **kw):
    """Serve ``records`` (pre-enqueued before the start unless ``pre`` is
    false) to the end; returns the answers, the snapshot and the stopped
    server."""
    reg = pkg.Registry()
    backend = pkg.Backend()
    if pre:
        _enqueue(pkg, backend, records)
    kw.setdefault("batch_size", 4)
    server = pkg.Serving(model, backend=backend, registry=reg, **kw)
    if events is not None:
        server.set_json_events(events)
    server.start()
    try:
        if not pre:
            _enqueue(pkg, backend, records)
        got = _query_all(pkg, backend, [r[0] for r in records])
    finally:
        server.stop(drain=False)
    return got, reg.snapshot(), server


def _same_answers(a, b, atol=0.0):
    assert a.keys() == b.keys()
    for uri in a:
        assert a[uri][0] == b[uri][0], (uri, a[uri], b[uri])
        if a[uri][0] == "value":
            np.testing.assert_allclose(a[uri][1], b[uri][1], atol=atol,
                                       rtol=1e-6)
        else:
            assert a[uri][1] == b[uri][1]


def _values(snap, *families):
    return {k: v["value"] for k, v in snap.items()
            if k.split("{", 1)[0] in families}


def _records(n_per_lane, lanes, seed, d=6):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_per_lane):
        for name in lanes:
            out.append((f"{name or 'p'}-{i}",
                        rng.normal(size=(d,)).astype(np.float32), name))
    return out


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_multimodel_routing_round_trip():
    """Two lanes on one stream: a record with a ``model`` field gets THAT
    lane's prediction, one without goes to the primary lane; the
    per-model counters split the total — in both packages alike."""
    recs = _records(6, ("double", "triple"), 1) + _records(4, (None,), 2)
    runs = {}
    for pkg in PKGS:
        got, snap, _ = _serve(pkg, {"double": _Scale(2.0),
                                    "triple": _Scale(3.0)}, recs, pre=False)
        runs[pkg.name] = (got, snap)
    _same_answers(runs["port"][0], runs["jax"][0])
    for uri, x, model in recs:
        factor = 3.0 if model == "triple" else 2.0
        np.testing.assert_allclose(runs["port"][0][uri][1], x * factor,
                                   rtol=1e-6)
    fams = ("zoo_serving_records_total", "zoo_serving_model_records_total",
            "zoo_serving_failures_total")
    assert _values(runs["port"][1], *fams) == _values(runs["jax"][1], *fams)
    assert runs["port"][1]['zoo_serving_model_records_total{model="double"}'
                           ]["value"] == 10


def test_unknown_model_answered_addressably():
    """A record naming a lane the server does not host is answered
    ``unknown model`` at routing, and the loop keeps serving."""
    recs = [("nope", np.zeros(6, np.float32), "no-such-model"),
            ("ok", np.ones(6, np.float32), None)]
    runs = [_serve(pkg, _Scale(2.0), recs) for pkg in PKGS]
    _same_answers(runs[0][0], runs[1][0])
    assert runs[0][0]["nope"] == ("error", "nope: unknown model")
    fams = ("zoo_serving_failure_errors_total", "zoo_serving_failures_total",
            "zoo_serving_records_total")
    assert _values(runs[0][1], *fams) == _values(runs[1][1], *fams)


# ---------------------------------------------------------------------------
# per-lane isolation
# ---------------------------------------------------------------------------

def test_lane_poison_isolated_and_reconciles(tmp_path):
    """One lane's model raises on every dispatch: its first batch is
    retried record by record and dead-lettered (the retries open its
    breaker), its next batch fast-fails ``model unavailable``, every
    failed record spills to the DLQ with its lane; the other lane answers
    all of its records. The same answers, counters, DLQ records and
    traces in both packages."""
    recs = []
    rng = np.random.default_rng(2)
    for i in range(8):
        recs.append((f"g-{i}", rng.normal(size=(6,)).astype(np.float32),
                     "good"))
        recs.append((f"b-{i}", rng.normal(size=(6,)).astype(np.float32),
                     "bad"))
    runs = {}
    for pkg in PKGS:
        reg = pkg.Registry()
        dlq = pkg.DLQ(str(tmp_path / f"dlq-{pkg.name}"), registry=reg)
        backend = pkg.Backend()
        _enqueue(pkg, backend, recs)
        events = str(tmp_path / f"events-{pkg.name}.jsonl")
        server = pkg.Serving(
            {"good": _Scale(2.0), "bad": _Boom()}, backend=backend,
            batch_size=4, registry=reg, dlq=dlq,
            dispatch_breakers={"bad": pkg.Breaker(
                "serving.dispatch.bad", failure_threshold=2,
                reset_timeout=60.0, registry=reg)})
        server.set_json_events(events)
        server.start()
        try:
            got = _query_all(pkg, backend, [r[0] for r in recs])
        finally:
            server.stop(drain=False)
        phases = {}
        for e in read_events(events, kind="request"):
            phases.setdefault(e["uri"], []).append(e["phase"])
        runs[pkg.name] = dict(
            got=got, snap=reg.snapshot(),
            models=server._health_info()["serving"]["models"],
            dlq=sorted((r["uri"], r["reason"], r["error"], r.get("model"))
                       for _s, r in dlq.scan()),
            depth=dlq.depth, phases=phases)
    p, j = runs["port"], runs["jax"]
    _same_answers(p["got"], j["got"])
    errors = {v for k, v in p["got"].values() if k == "error"}
    assert errors == {"b-0: dead-lettered: dispatch crashed repeatedly",
                      "b-1: dead-lettered: dispatch crashed repeatedly",
                      "b-2: dead-lettered: dispatch crashed repeatedly",
                      "b-3: dead-lettered: dispatch crashed repeatedly",
                      "b-4: model unavailable", "b-5: model unavailable",
                      "b-6: model unavailable", "b-7: model unavailable"}
    fams = ("zoo_serving_records_total", "zoo_serving_failures_total",
            "zoo_serving_model_records_total",
            "zoo_serving_failure_errors_total",
            "zoo_serving_dead_letter_total", "zoo_serving_dlq_spilled_total",
            "zoo_retry_attempts_total")
    assert _values(p["snap"], *fams) == _values(j["snap"], *fams)
    assert p["snap"]["zoo_serving_records_total"]["value"] == 8
    assert p["dlq"] == j["dlq"] and p["depth"] == j["depth"] == 8
    assert {m for *_r, m in p["dlq"]} == {"bad"}
    assert p["models"]["bad"]["breaker"] == "open"
    assert p["models"] == j["models"]
    assert p["phases"] == j["phases"] and len(p["phases"]) == 16
    assert all(ph[-1] in ("publish", "failed")
               for ph in p["phases"].values())


def test_lane_breaker_recovers_via_half_open_probe():
    """A lane whose model was down and comes back: its open breaker's
    half-open probe dispatches a real batch after the reset window, the
    readback closes it and the lane serves again."""
    for pkg in PKGS:
        class Gated:
            broken = True

            def predict(self, x):
                if self.broken:
                    raise RuntimeError("model down")
                return np.asarray(x) * 2.0

        reg = pkg.Registry()
        backend = pkg.Backend()
        gated = Gated()
        server = pkg.Serving(
            {"m": gated}, backend=backend, batch_size=4, registry=reg,
            dispatch_retries=0,
            dispatch_breakers={"m": pkg.Breaker(
                "serving.dispatch.m", failure_threshold=2,
                reset_timeout=0.1, registry=reg)}).start()
        inq, outq = pkg.InputQueue(backend), pkg.OutputQueue(backend)
        try:
            for i in range(8):
                inq.enqueue(f"down-{i}", np.ones(6, np.float32), model="m")
            for i in range(8):
                with pytest.raises(pkg.ServingError):
                    outq.query(f"down-{i}", timeout=30.0)
            key = ('zoo_breaker_transitions_total'
                   '{breaker="serving.dispatch.m",state="open"}')
            assert reg.snapshot()[key]["value"] >= 1, pkg.name
            gated.broken = False
            time.sleep(0.15)
            for i in range(8):
                inq.enqueue(f"up-{i}", np.ones(6, np.float32), model="m")
            for i in range(8):
                np.testing.assert_allclose(
                    outq.query(f"up-{i}", timeout=30.0), np.ones(6) * 2.0)
            assert server._lanes["m"].breaker.state == "closed", pkg.name
        finally:
            server.stop(drain=False)


@pytest.mark.parametrize("kw", [{"weights": {"b": 2.0}},
                                {"dispatch_breakers": {"b": None}}])
def test_weights_for_unknown_lane_rejected(kw):
    """A typo'd ``weights=`` / ``dispatch_breakers=`` key is refused with
    JAX's message."""
    msgs = []
    for pkg in PKGS:
        with pytest.raises(ValueError, match="unknown lane") as e:
            pkg.Serving({"a": _Scale(1.0)}, backend=pkg.Backend(),
                        registry=pkg.Registry(), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_dlq_replay_restamps_model_field(tmp_path):
    """A replayed dead letter re-enqueues with its ``model`` field, and a
    multi-model server routes it back to that lane."""
    for pkg in PKGS:
        dlq = pkg.DLQ(str(tmp_path / pkg.name))
        x = np.arange(6, dtype=np.float32)
        dlq.append("u-1", x, reason="dispatch", trace="abcdef0123456789",
                   error="boom", model="triple")
        backend = pkg.Backend()
        assert dlq.replay(backend, stream="replay_stream") == 1
        (entry,) = backend.xread("replay_stream", 10, block_ms=100)
        assert entry[1]["model"] == "triple"
        assert entry[1]["replay_of"] == "abcdef0123456789"
        assert dlq.replay(backend) == 0
        backend.xadd("tensor_stream", entry[1])
        server = pkg.Serving({"double": _Scale(2.0), "triple": _Scale(3.0)},
                             backend=backend, batch_size=4,
                             registry=pkg.Registry()).start()
        try:
            got = pkg.OutputQueue(backend).query("u-1", timeout=30.0)
        finally:
            server.stop(drain=False)
        np.testing.assert_allclose(got, x * 3.0)


# ---------------------------------------------------------------------------
# weighted-fair admission under shed pressure
# ---------------------------------------------------------------------------

def test_weighted_fair_admission_under_shed():
    """Backlog above the watermark: each lane keeps a share of the
    admission window proportional to its weight (3:1), filled
    oldest-first; the rest shed — the same records admitted and shed in
    both packages."""
    recs = _records(20, ("a", "b"), 3)
    runs = []
    for pkg in PKGS:
        got, snap, _ = _serve(
            pkg, {"a": {"model": _Scale(2.0), "weight": 3.0},
                  "b": {"model": _Scale(3.0), "weight": 1.0}}, recs,
            block_ms=20, shed_watermark=4)
        runs.append((got, snap))
    _same_answers(runs[0][0], runs[1][0])
    served = {u for u, (k, _v) in runs[0][0].items() if k == "value"}
    assert {f"a-{i}" for i in range(6)} <= served
    assert {"b-0", "b-1"} <= served and len(served) == 12
    fams = ("zoo_serving_shed_total", "zoo_serving_model_records_total",
            "zoo_serving_failure_errors_total")
    assert _values(runs[0][1], *fams) == _values(runs[1][1], *fams)
    assert runs[0][1]['zoo_serving_shed_total{reason="depth"}'][
        "value"] == 28


# ---------------------------------------------------------------------------
# buckets and arenas
# ---------------------------------------------------------------------------

def test_ragged_traffic_reaches_the_model_only_at_bucket_sizes():
    """Ragged traffic against buckets {4, 16}: every batch the model sees
    has 4 or 16 rows (in JAX: compiles once a bucket); the pad-row
    counter is the rows seen less the records; the answers are the
    unpadded predict's and the JAX server's, and the accounting counts
    real records only."""
    jm, pm = _nets()
    models = {"port": _Recording(InferenceModel(device="cpu").from_keras(pm)),
              "jax": _Recording(JaxIM().from_keras(jm))}
    oracle = InferenceModel(device="cpu").from_keras(pm)
    rng = np.random.default_rng(4)
    waves = [("full", 16)] + [(f"w{i}", k)
                              for i, k in enumerate((1, 3, 2, 3, 1))]
    xs = {f"{tag}-{i}": rng.normal(size=(6,)).astype(np.float32)
          for tag, k in waves for i in range(k)}
    runs = {}
    for pkg in PKGS:
        reg = pkg.Registry()
        backend = pkg.Backend()
        server = pkg.Serving(models[pkg.name], backend=backend,
                             batch_size=16, registry=reg,
                             shape_buckets="4,16").start()
        got = {}
        try:
            for tag, k in waves:
                wave = [(f"{tag}-{i}", xs[f"{tag}-{i}"], None)
                        for i in range(k)]
                _enqueue(pkg, backend, wave)
                got.update(_query_all(pkg, backend, [w[0] for w in wave]))
        finally:
            server.stop(drain=False)
        runs[pkg.name] = (got, reg.snapshot())
    _same_answers(runs["port"][0], runs["jax"][0], atol=1e-5)
    for uri, x in xs.items():
        np.testing.assert_allclose(runs["port"][0][uri][1],
                                   oracle.predict(x[None])[0], rtol=1e-6,
                                   atol=1e-7)
    n = len(xs)
    for pkg in PKGS:
        rows = models[pkg.name].rows
        snap = runs[pkg.name][1]
        assert set(rows) <= {4, 16}, (pkg.name, rows)
        assert snap['zoo_serving_bucket_pad_rows_total{model="default"}'][
            "value"] == sum(rows) - n > 0
        assert snap["zoo_serving_records_total"]["value"] == n
        assert snap["zoo_serving_batch_size"]["sum"] == n


def test_each_record_rides_the_same_lane_and_bucket_as_in_jax():
    """Pre-enqueued mixed traffic of three lanes with buckets {2, 4, 8}:
    every dispatch each lane's model sees (its row count and the records
    in it), the pad rows and the hit rates equal the JAX server's."""
    recs = _records(7, ("a", "b", None), 9)[:-2]
    runs = {}
    for pkg in PKGS:
        lanes = {"p": _Scale(1.0), "a": _Scale(2.0),
                 "b": {"model": _Scale(3.0), "batch_size": 4}}
        recs_p = [(u, x, m or "p") for u, x, m in recs]
        got, snap, server = _serve(pkg, lanes, recs_p, batch_size=8,
                                   shape_buckets=[2, 4])
        runs[pkg.name] = (
            got, {n: (lane.model.calls, lane.dispatches, lane.bucket_hits,
                      lane.buckets) for n, lane in server._lanes.items()},
            _values(snap, "zoo_serving_bucket_pad_rows_total",
                    "zoo_serving_model_dispatches_total",
                    "zoo_serving_model_records_total"),
            {n: (r["bucket_hit_rate"], r["pad_rows"], r["buckets"])
             for n, r in server._health_info()["serving"][
                 "models"].items()})
    _same_answers(runs["port"][0], runs["jax"][0])
    assert runs["port"][1:] == runs["jax"][1:]
    calls = runs["port"][1]
    assert calls["a"][0] == [8] and calls["b"][3] == (2, 4)
    assert all(c in (2, 4, 8) for n in calls for c in calls[n][0])


@pytest.mark.parametrize("spec,batch", [
    ("", 32), ("4,16", 16), ([8], 12), ((3, 3, 1), 5), (None, 1),
    ("0,4", 8), ("64", 32), (3.5, 8), ("4,x", 8)])
def test_bucket_spec_parses_as_jax(spec, batch):
    """``_parse_buckets`` gives JAX's tuple, or raises JAX's error."""
    out = []
    for pkg in PKGS:
        try:
            out.append(("ok", pkg.server._parse_buckets(spec, batch)))
        except ValueError as e:
            out.append(("error", str(e)))
    assert out[0] == out[1]


def test_bucket_outside_the_batch_is_refused_by_the_server():
    msgs = []
    for pkg in PKGS:
        with pytest.raises(ValueError) as e:
            pkg.Serving(_Scale(1.0), backend=pkg.Backend(), batch_size=8,
                        registry=pkg.Registry(), shape_buckets="9")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "shape bucket 9 outside [1, batch_size=8]"


def test_arena_pool_reuses_and_bounds_its_buffers():
    """``_ArenaPool``: a released buffer comes back for its key, at most
    ``cap`` are kept a key, and past ``max_bytes`` the least recently
    used shapes go — the same bookkeeping as JAX's pool."""
    states = []
    for pkg in PKGS:
        pool = pkg.server._ArenaPool(4, cap=2, max_bytes=3 * 4 * 6 * 4)
        a = pool.acquire((6,), np.float32)
        b = pool.acquire((6,), np.float32)
        c = pool.acquire((6,), np.float32)
        d = pool.acquire((3,), np.int32)
        for arena in (a, b, c, d):
            pool.release(arena)
        again = pool.acquire((6,), np.float32)
        states.append((a.shape, d.shape, again is b or again is a,
                       pool._bytes,
                       [(k, len(v)) for k, v in pool._free.items()]))
    assert states[0] == states[1]
    assert states[0][2] is True


# ---------------------------------------------------------------------------
# serving dtypes
# ---------------------------------------------------------------------------

def test_int8_lane_wraps_kerasnet_and_serves_fp32_wire():
    """A lane spec naming a bare KerasNet with ``dtype="int8"`` is wrapped
    in an InferenceModel on the int8 weight-only path; requests and
    results stay fp32 on the wire; the answers are the JAX int8 lane's
    (1e-5) and near the fp32 oracle (0.05)."""
    jm, pm = _nets()
    recs = [(f"q-{i}", x, "q") for i, (_u, x, _m)
            in enumerate(_records(8, ("q",), 5))]
    got = {}
    for pkg, net in ((PORT, pm), (JAX, jm)):
        answers, _, server = _serve(pkg, {"q": {"model": net,
                                                "dtype": "int8"}}, recs)
        assert server._health_info()["serving"]["models"]["q"][
            "dtype"] == "int8"
        got[pkg.name] = (answers, server._lanes["q"].model)
    assert got["port"][1]._quantize == "int8"
    assert got["jax"][1]._scales is not None
    _same_answers(got["port"][0], got["jax"][0], atol=1e-5)
    oracle = InferenceModel(device="cpu").from_keras(pm)
    for uri, x, _m in recs:
        val = got["port"][0][uri][1]
        assert val.dtype == np.float32
        np.testing.assert_allclose(val, oracle.predict(x[None])[0],
                                   atol=0.05)


@pytest.mark.parametrize("lanes", ["bare", "spec"])
def test_bad_dtype_rejected(lanes):
    msgs = []
    for pkg in PKGS:
        with pytest.raises(ValueError, match="dtype") as e:
            if lanes == "bare":
                pkg.Serving(_Scale(1.0), backend=pkg.Backend(),
                            registry=pkg.Registry(), dtype="fp17")
            else:
                pkg.Serving({"a": {"model": _Scale(1.0), "dtype": "fp17"}},
                            backend=pkg.Backend(), registry=pkg.Registry())
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# /statusz models block + CLI rendering
# ---------------------------------------------------------------------------

def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        code = main(argv)
    return code, out.getvalue()


def _jax_cli(argv):
    old = sys.argv
    sys.argv = [JAX_STATUS_CLI] + list(argv)
    try:
        return runpy.run_path(JAX_STATUS_CLI,
                              run_name="zoo_status_cli")["main"]()
    finally:
        sys.argv = old


def _unclock(text):
    text = re.sub(r"\(up [0-9.]+s\)", "(up _)", text)
    return re.sub(r"last flush [0-9.]+s ago", "last flush _", text)


def test_statusz_models_block_and_cli_rendering():
    """Two port replicas of two lanes each: the ``/statusz`` models rows
    equal the JAX server's on the same traffic, and the port's status CLI
    renders them per replica and as the fleet roll-up exactly as the JAX
    script does on the same endpoints."""
    scrapes, endpoints, models = [], [], {}
    try:
        for r in range(2):
            recs = [(f"m{r}-{i}", x, ("double", "triple")[i % 2])
                    for i, (_u, x, _m) in enumerate(_records(6, ("x",),
                                                             10 + r))]
            for pkg in PKGS:
                reg = pkg.Registry()
                backend = pkg.Backend()
                _enqueue(pkg, backend, recs)
                server = pkg.Serving(
                    {"double": _Scale(2.0), "triple": _Scale(3.0)},
                    backend=backend, batch_size=4, registry=reg)
                scrape = server.serve_metrics(port=0)
                scrapes.append(scrape)
                server.start()
                got = _query_all(pkg, backend, [x[0] for x in recs])
                assert all(k == "value" for k, _v in got.values())
                # stopped with the endpoint kept up: both CLIs below read
                # the same frozen state
                server._scrape = None
                server.stop(drain=False)
                with urllib.request.urlopen(
                        f"http://{scrape.host}:{scrape.port}/statusz",
                        timeout=10) as resp:
                    models[(pkg.name, r)] = json.loads(
                        resp.read())["serving"]["models"]
                if pkg is PORT:
                    endpoints.append(f"{scrape.host}:{scrape.port}")
        for r in range(2):
            assert models[("port", r)] == models[("jax", r)]
            assert set(models[("port", r)]) == {"double", "triple"}
        for eps in (endpoints[:1], endpoints):
            pcode, ptext = _cli(pstatus.main, eps)
            jcode, jtext = _cli(_jax_cli, eps)
            assert pcode == jcode == 0
            assert _unclock(ptext) == _unclock(jtext)
        assert "breaker" in ptext and "double" in ptext
        assert "fleet roll-up across 2 replica(s)" in ptext
        rollup = [ln for ln in ptext.splitlines()
                  if ln.startswith(("double", "triple"))]
        assert len(rollup) == 2 and all(ln.split()[-1] == "6"
                                        for ln in rollup)
    finally:
        for scrape in scrapes:
            scrape.close()


def test_zero_size_tensor_row_cannot_kill_loop():
    """A validated v2 record of shape "0" rides the arena copy without
    crashing a decode worker, and the loop keeps serving."""
    for pkg in PKGS:
        backend = pkg.Backend()
        server = pkg.Serving(_Scale(2.0), backend=backend, batch_size=4,
                             registry=pkg.Registry()).start()
        inq, outq = pkg.InputQueue(backend), pkg.OutputQueue(backend)
        try:
            backend.xadd("tensor_stream", {"uri": "empty", "data": b"",
                                           "dtype": "<f4", "shape": "0",
                                           "v": "2"})
            res = outq.query("empty", timeout=30.0)
            assert res is not None and res.shape == (0,)
            inq.enqueue("after", np.ones(6, np.float32))
            np.testing.assert_allclose(outq.query("after", timeout=30.0),
                                       np.ones(6) * 2.0)
            assert server._thread.is_alive()
        finally:
            server.stop(drain=False)


def test_buffered_records_ride_next_dispatch_not_lost():
    """A model that refuses the non-blocking probe (one permit, in
    flight) leaves records buffered; they ride a later step — none
    dropped, no deadlock — in both packages."""

    class OnePermit:
        def __init__(self):
            self._busy = False

        def predict_async(self, batch, block=True):
            if self._busy and not block:
                return None
            self._busy = True
            preds = np.asarray(batch) * 5.0

            def collect():
                self._busy = False
                return preds
            return collect

    recs = [(u, x, None) for u, x, _m in _records(12, ("c",), 6)]
    runs = [_serve(pkg, OnePermit(), recs, batch_size=2) for pkg in PKGS]
    _same_answers(runs[0][0], runs[1][0])
    for uri, x, _m in recs:
        np.testing.assert_allclose(runs[0][0][uri][1], x * 5.0, rtol=1e-6)
    assert runs[0][2].served == runs[1][2].served == 12


# ---------------------------------------------------------------------------
# per-lane ceilings
# ---------------------------------------------------------------------------

def test_per_lane_ceilings_cap_dispatch_and_window():
    """``zoo.serving.lane_max_inflight`` / ``lane_batch_size``: the conf
    override beats the spec entry, the big lane dispatches at most its
    own ceiling and the statusz rows show it — the same ceilings,
    buckets, answers and dispatch counts as JAX on pre-enqueued
    traffic."""
    conf = {"zoo.serving.lane_max_inflight": "big:1",
            "zoo.serving.lane_batch_size": "big:2"}
    pctx.init_zoo_context(conf=conf)
    jctx.init_zoo_context(conf=conf)
    recs = [(f"cap-{i}", np.full((3,), float(i), np.float32),
             "big" if i % 2 == 0 else "small") for i in range(10)]
    runs = {}
    for pkg in PKGS:
        got, snap, server = _serve(
            pkg, {"big": {"model": _Scale(2.0), "batch_size": 4},
                  "small": _Scale(3.0)}, recs,
            batch_size=8, max_inflight=4, block_ms=5)
        big, small = server._lanes["big"], server._lanes["small"]
        runs[pkg.name] = (got, (big.batch_size, big.max_inflight,
                                big.buckets, small.batch_size,
                                small.max_inflight, small.buckets,
                                server._lane_target(big)),
                          _values(snap, "zoo_serving_model_dispatches_total"),
                          big.model.calls,
                          {n: (r["batch_ceiling"], r["max_inflight"])
                           for n, r in server._health_info()["serving"][
                               "models"].items()})
    _same_answers(runs["port"][0], runs["jax"][0])
    assert runs["port"][1:] == runs["jax"][1:]
    assert runs["port"][1] == (2, 1, (1, 2), 8, 4, (1, 2, 4, 8), 2)
    assert max(runs["port"][3]) <= 2 and len(runs["port"][3]) >= 3


@pytest.mark.parametrize("case", ["batch", "inflight", "ghost", "syntax"])
def test_per_lane_ceiling_validation(case):
    """Ceilings outside [1, server ceiling] are refused with JAX's
    message; a conf override naming a lane this server lacks is ignored
    (conf is process-global); a malformed override is refused."""
    out = []
    for pkg in PKGS:
        try:
            if case == "batch":
                pkg.Serving({"m": {"model": _Scale(1.0), "batch_size": 64}},
                            backend=pkg.Backend(), batch_size=8,
                            registry=pkg.Registry())
            elif case == "inflight":
                pkg.Serving({"m": {"model": _Scale(1.0), "max_inflight": 0}},
                            backend=pkg.Backend(), batch_size=8,
                            registry=pkg.Registry())
            elif case == "ghost":
                pkg.ctx.init_zoo_context(
                    conf={"zoo.serving.lane_batch_size": "ghost:4"})
                s = pkg.Serving({"m": _Scale(1.0)}, backend=pkg.Backend(),
                                batch_size=8, registry=pkg.Registry())
                out.append(("ok", s._lanes["m"].batch_size))
                continue
            else:
                pkg.server._parse_lane_overrides(
                    "big=2", "zoo.serving.lane_batch_size")
            out.append(("ok", None))
        except ValueError as e:
            out.append(("error", str(e)))
    assert out[0] == out[1]
    assert out[0][0] == ("ok" if case == "ghost" else "error")
