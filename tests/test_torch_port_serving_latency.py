"""Per-record serving latency: the port's ClusterServing held against the
JAX server on the same pre-enqueued records and weights.

A small ``Sequential`` of ``Dense`` layers (weights moved across from the
JAX tree) serves v2 and v1 records, one undecodable, one without a trace;
other runs serve a model whose predict raises and one whose readback
raises. Both servers must give the same records, batches, undecodable,
failure and failure-breakdown counters, the same queue-wait, e2e and
dispatch counts, and the same per-trace phase chains and parents. The
``/healthz`` and ``/statusz`` payloads have the same fields and types
(``server.HEALTH_NOT_PORTED`` is empty: the fleet's ``scaling`` block is
ported), and the port's status CLI gives what the JAX script gives on
the same endpoint. Both servers run with ``dispatch_retries=0``,
so a failed batch fails whole in both (the solo retries are held to JAX
in ``tests/test_torch_port_serving_overload.py``).

Nothing here sleeps to wait: results are awaited through ``query``
timeouts, and counters and events are read after ``stop()``, which joins
the publisher before it closes the sinks.
"""

import contextlib
import io
import json
import os
import runpy
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu.pipeline.api.keras.engine import \
    Sequential as JaxSequential
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JaxDense
from analytics_zoo_tpu.pipeline.inference import InferenceModel as JaxIM
from analytics_zoo_tpu.serving import ClusterServing as JaxServing
from analytics_zoo_tpu.serving import LocalBackend as JaxBackend
from analytics_zoo_tpu.serving import client as jclient
from analytics_zoo_tpu_torch import observability as pobs
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import Dense
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
from analytics_zoo_tpu_torch.serving import ClusterServing, LocalBackend
from analytics_zoo_tpu_torch.serving import client as pclient
from analytics_zoo_tpu_torch.serving import server as pserver
from analytics_zoo_tpu_torch.serving import status as pstatus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_STATUS_CLI = os.path.join(REPO, "scripts", "cluster-serving-status")
STREAM = pclient.INPUT_STREAM
PHASES = ("enqueue", "dequeue", "dispatch", "publish")
PARENT = {"enqueue": None, "dequeue": "enqueue", "dispatch": "dequeue",
          "publish": "dispatch"}


@pytest.fixture(autouse=True)
def port_context():
    pctx.reset_zoo_context()
    peng.reset_uids()
    yield
    pctx.reset_zoo_context()


def _models():
    jm = JaxSequential([JaxDense(8, activation="relu", input_shape=(6,)),
                        JaxDense(3, activation="softmax")])
    jm.init_weights(rng=jax.random.key(3))
    pm = peng.Sequential([Dense(8, activation="relu", input_shape=(6,)),
                          Dense(3, activation="softmax")], device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
    return jm, pm


def _records(n=13, seed=0):
    """``[(fields_kind, uri, array, trace)]``: v2 records, every fourth
    one v1, one undecodable and one without a trace."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = rng.normal(size=(6,)).astype(np.float32)
        kind = "v1" if i % 4 == 3 else "v2"
        out.append((kind, f"r-{i}", x, f"{i + 1:016x}"))
    out.insert(5, ("bad", "bad", None, f"{999:016x}"))
    out.insert(9, ("v2", "untraced", out[2][2], None))
    return out


def _fields(client, kind, uri, x, trace):
    if kind == "bad":
        fields = {"uri": uri, "data": "!!notb64!!"}
    elif kind == "v1":
        fields = {"uri": uri, "data": client.encode_array(x)}
    else:
        fields = dict(client.encode_tensor(x), uri=uri)
    if trace is not None:
        fields["trace"] = trace
    return fields


class BoomModel:
    """A model whose predict raises: every record fails."""

    def predict(self, x):
        raise RuntimeError("boom")


class ReadbackBoom:
    """An async model whose readback raises for batches holding more
    than one record (the failure surfaces at ``collect``)."""

    def __init__(self, predict):
        self._predict = predict

    def predict_async(self, x, block=True):
        def collect():
            if len(x) > 1:
                raise RuntimeError("readback boom")
            return np.asarray(self._predict(x))
        return collect


def _serve(make_server, backend, client, recs, registry, tmp_path,
           name, scrape_cb=None):
    """Pre-enqueue ``recs``, serve them to the end, stop; returns the
    answers, the events and the registry snapshot. ``scrape_cb(base)``
    runs while the server is live, after every answer arrived."""
    for rec in recs:
        backend.xadd(STREAM, _fields(client, *rec))
    events = str(tmp_path / f"{name}.jsonl")
    server = make_server(backend, registry)
    server.set_json_events(events)
    scrape = server.serve_metrics(port=0)
    base = f"http://{scrape.host}:{scrape.port}"
    server.start()
    answers = {}
    try:
        for _kind, uri, _x, _trace in recs:
            res = backend.pop_result(uri, timeout=60)
            assert res is not None, uri
            answers[uri] = res.get("error") or "value"
        live = scrape_cb(base) if scrape_cb else None
    finally:
        server._scrape = None          # keep the endpoint past stop()
        server.stop()
    return (answers, pobs.read_events(events), registry.snapshot(), scrape,
            live)


def _counts(snap):
    """The counters and counts both servers must agree on."""
    out = {}
    for key, v in snap.items():
        fam = key.split("{", 1)[0]
        if fam in ("zoo_serving_records_total", "zoo_serving_batches_total",
                   "zoo_serving_undecodable_total",
                   "zoo_serving_failures_total",
                   "zoo_serving_failure_errors_total",
                   "zoo_serving_clock_skew_total"):
            out[key] = v["value"]
        elif fam in ("zoo_serving_queue_wait_quantiles_seconds",
                     "zoo_serving_e2e_quantiles_seconds",
                     "zoo_serving_dispatch_quantiles_seconds",
                     "zoo_serving_queue_wait_seconds",
                     "zoo_serving_dispatch_seconds",
                     "zoo_serving_batch_size"):
            out[key] = v["count"]
    return out


def _chains(events):
    """``{trace: [(phase, parent, uri, batch, error)]}`` in emit order,
    and the per-kind counts of the other events."""
    chains = {}
    kinds = {}
    for e in events:
        if e["kind"] == "request":
            chains.setdefault(e["trace"], []).append(
                (e["phase"], e["parent"], e["uri"], e.get("batch"),
                 e.get("error")))
        else:
            key = (e["kind"], e.get("name"), e.get("records"),
                   e.get("error"))
            kinds[key] = kinds.get(key, 0) + 1
    return chains, kinds


def _jax_server(model, **kw):
    return lambda backend, reg: JaxServing(
        model, backend=backend, batch_size=4, registry=reg,
        dispatch_retries=0, **kw)


def _port_server(model, **kw):
    return lambda backend, reg: ClusterServing(
        model, backend=backend, batch_size=4, registry=reg,
        dispatch_retries=0, **kw)


def _pair(kind):
    """The JAX and the port server factories for one model kind."""
    jm, pm = _models()
    if kind == "model":
        return (_jax_server(JaxIM().from_keras(jm)),
                _port_server(InferenceModel(device="cpu").from_keras(pm)))
    if kind == "predict_raises":
        return _jax_server(BoomModel()), _port_server(BoomModel())
    return (_jax_server(ReadbackBoom(JaxIM().from_keras(jm).predict)),
            _port_server(ReadbackBoom(
                InferenceModel(device="cpu").from_keras(pm).predict)))


@pytest.mark.parametrize("kind", ["model", "predict_raises",
                                  "readback_raises"])
def test_serving_counters_and_traces_match_jax(tmp_path, kind):
    recs = _records()
    make_j, make_p = _pair(kind)
    jreg, preg = jobs.MetricsRegistry(), pobs.MetricsRegistry()
    ja, jev, jsnap, jscrape, _ = _serve(make_j, JaxBackend(), jclient, recs,
                                        jreg, tmp_path, "j")
    pa, pev, psnap, pscrape, _ = _serve(make_p, LocalBackend(), pclient,
                                        recs, preg, tmp_path, "p")
    jscrape.close()
    pscrape.close()
    assert pa == ja
    assert _counts(psnap) == _counts(jsnap)
    jchains, jkinds = _chains(jev)
    pchains, pkinds = _chains(pev)
    assert pchains == jchains
    assert pkinds == jkinds
    n_ok = sum(v == "value" for v in pa.values())
    n = len(recs)
    assert pa["bad"] == "undecodable payload"
    assert psnap["zoo_serving_undecodable_total"]["value"] == 1
    # every entry's wait is observed, the undecodable one's too
    assert psnap["zoo_serving_queue_wait_quantiles_seconds"]["count"] == n
    assert psnap["zoo_serving_e2e_quantiles_seconds"]["count"] == n_ok
    assert psnap["zoo_serving_dispatch_quantiles_seconds"]["count"] == \
        psnap["zoo_serving_batches_total"]["value"]
    assert "untraced" not in {c[0][2] for c in pchains.values()}
    assert len(pchains) == n - 2      # no chain for the bad or untraced
    for trace, chain in pchains.items():
        phases = [c[0] for c in chain]
        if kind == "model":
            assert phases == list(PHASES), trace
        else:
            assert phases[-1] == "failed" and "publish" not in phases
        for phase, parent, *_ in chain:
            if phase in PARENT:
                assert parent == PARENT[phase]
    if kind == "model":
        assert n_ok == n - 1
        pub = [e for e in pev if e.get("phase") == "publish"]
        assert all(e["e2e_s"] >= e["dur_s"] - 1e-3 for e in pub)
        assert sum(e["records"] for e in pev
                   if e["kind"] == "serving.flush") == n_ok
    else:
        assert n_ok == 0
        key = 'zoo_serving_failure_errors_total{error="inference failed"}'
        assert psnap[key]["value"] == n - 1
        parent = "dequeue" if kind == "predict_raises" else "dispatch"
        assert {c[-1][1] for c in pchains.values()} == {parent}


@pytest.mark.parametrize("entry_id,wait,skew", [
    ("ahead", 0.0, 1), ("behind", 1.0, 0), ("garbage-id", None, 0)])
def test_queue_wait_clamps_a_future_entry_id_as_jax_does(entry_id, wait,
                                                         skew):
    now = time.time()
    ids = {"ahead": f"{int((now + 5.0) * 1000)}-0",
           "behind": f"{int((now - 1.0) * 1000)}-1"}
    got = []
    for obs, cls in ((jobs, JaxServing), (pobs, ClusterServing)):
        reg = obs.MetricsRegistry()
        server = cls(object(), backend=(JaxBackend if cls is JaxServing
                                        else LocalBackend)(), registry=reg)
        w, t_enq = server._observe_queue_wait(ids.get(entry_id, entry_id),
                                              now)
        snap = reg.snapshot()
        got.append((w if w is None else round(w, 2),
                    None if t_enq is None else round(t_enq - now, 2),
                    snap["zoo_serving_clock_skew_total"]["value"],
                    snap["zoo_serving_queue_wait_seconds"]["count"],
                    snap["zoo_serving_queue_wait_quantiles_seconds"][
                        "count"]))
    assert got[1] == got[0]
    assert got[1][0] == wait and got[1][2] == skew
    if entry_id == "ahead":
        assert got[1][1] == 5.0


def _get_json(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _type_diff(j, p, path=""):
    """``(keys JAX has that the port lacks, port-only keys, type
    mismatches)`` of two JSON payloads, recursively."""
    missing, extra, types = set(), set(), []
    if isinstance(j, dict) and isinstance(p, dict):
        missing |= {path + k for k in set(j) - set(p)}
        extra |= {path + k for k in set(p) - set(j)}
        for k in set(j) & set(p):
            m, e, t = _type_diff(j[k], p[k], path + k + ".")
            missing |= m
            extra |= e
            types += t
    elif j is not None and p is not None and type(j) is not type(p):
        types.append((path, type(j).__name__, type(p).__name__))
    return missing, extra, types


def test_healthz_statusz_match_jax_but_for_the_declared_fields(tmp_path):
    recs = _records(n=6)
    make_j, make_p = _pair("model")

    def live(base):
        return (_get_json(base + "/healthz"), _get_json(base + "/statusz"))

    _, _, _, jscrape, (jh, js) = _serve(make_j, JaxBackend(), jclient, recs,
                                        jobs.MetricsRegistry(), tmp_path,
                                        "j", live)
    _, _, psnap, pscrape, (ph, ps) = _serve(make_p, LocalBackend(), pclient,
                                            recs, pobs.MetricsRegistry(),
                                            tmp_path, "p", live)
    try:
        pbase = f"http://{pscrape.host}:{pscrape.port}"
        after = _get_json(pbase + "/healthz")
        codes = []
        for method, path in (("GET", "/nope"), ("POST", "/nope")):
            req = urllib.request.Request(
                pbase + path, method=method,
                data=b"" if method == "POST" else None)
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=10)
            codes.append(e.value.code)
    finally:
        jscrape.close()
        pscrape.close()
    # nothing is left to port: the overload and scaling blocks and every
    # field of a models row match JAX's
    assert pserver.HEALTH_NOT_PORTED == {"serving": (), "models": ()}
    declared = {f"serving.{k}" for k in pserver.HEALTH_NOT_PORTED["serving"]}
    declared |= {f"serving.models.default.{k}"
                 for k in pserver.HEALTH_NOT_PORTED["models"]}
    assert declared == set()
    for j, p in ((jh, ph), (js, ps)):
        assert p["serving"]["overload"] == j["serving"]["overload"]
        jsc, psc = j["serving"]["scaling"], p["serving"]["scaling"]
        assert set(psc) == set(jsc)
        for key in ("group", "stream_depth", "pending_entries",
                    "batch_size_target"):
            assert psc[key] == jsc[key], key
        jrow = dict(j["serving"]["models"]["default"])
        prow = dict(p["serving"]["models"]["default"])
        assert set(prow) == set(jrow)
        # one 6-record read: buckets, hit rate, padding as JAX's
        for key in ("weight", "dtype", "batch_target", "batch_ceiling",
                    "max_inflight", "buckets", "bucket_hit_rate",
                    "breaker", "pad_rows"):
            assert prow[key] == jrow[key], key
    for j, p in ((jh, ph), (js, ps)):
        missing, extra, types = _type_diff(j, p)
        assert missing == declared
        assert not extra and not types, (extra, types)
    assert ph["status"] == "ok" and ph["serving"]["running"] is True
    assert after["serving"]["running"] is False
    # read after stop(): the publisher's bookkeeping trails the answers
    assert after["serving"]["served"] == len(recs) - 1
    assert after["serving"]["models"]["default"]["records"] == len(recs) - 1
    assert ps["device"]["platform"] in ("cpu", "gpu")
    perf = ps["performance"]
    assert set(perf["badput_s"]) == {"host_decode", "publish", "shed",
                                     "idle"}
    assert perf["profiler"]["in_flight"] is None
    assert codes == [404, 404]
    assert psnap["zoo_serving_queue_wait_seconds"]["count"] == len(recs)


def _run_cli(main, argv):
    """One in-process CLI run: ``(exit code, its standard output)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        code = main(argv)
    return code, out.getvalue()


def _jax_cli(argv):
    """``scripts/cluster-serving-status`` in this process."""
    old = sys.argv
    sys.argv = [JAX_STATUS_CLI] + list(argv)
    try:
        ns = runpy.run_path(JAX_STATUS_CLI, run_name="zoo_status_cli")
        return ns["main"]()
    finally:
        sys.argv = old


def _strip_clock_text(text):
    import re
    text = re.sub(r"\(up [0-9.]+s\)", "(up _)", text)
    return re.sub(r"last flush [0-9.]+s ago", "last flush _", text)


def _strip_clocks(doc):
    for ep in doc["endpoints"].values():
        for block in (ep["health"], ep["status"]):
            block.pop("uptime_s", None)
            block.get("serving", {}).pop("last_flush_age_s", None)
    return doc


@pytest.mark.parametrize("args,code", [
    ([], 0), (["--slo-p99-ms", "0.001"], 2),
    (["--slo-p99-ms", "dispatch=1e9", "--slo-p99-ms", "queue_wait=1e9"], 0),
    (["--slo-p99-ms", "zoo_missing_quantiles_seconds=5"], 2)])
def test_status_cli_json_matches_the_jax_script(tmp_path, args, code):
    """On the port's endpoints (one, then two as a fleet), the port's CLI
    gives the JAX script's JSON (clock fields set aside) and exit code."""
    make_j, make_p = _pair("model")
    scrapes = []
    try:
        for r in range(2):
            _, _, _, scrape, _ = _serve(make_p, LocalBackend(), pclient,
                                        _records(n=5 + 3 * r, seed=r),
                                        pobs.MetricsRegistry(), tmp_path,
                                        f"p{r}")
            scrapes.append(f"{scrape.host}:{scrape.port}")
            scrapes.append(scrape)
        eps = scrapes[0::2]
        for endpoints in (eps[:1], eps):
            pcode, ptext = _run_cli(pstatus.main, endpoints + args)
            jcode, jtext = _run_cli(lambda a: _jax_cli(a), endpoints + args)
            jcode2, jout = _run_cli(lambda a: _jax_cli(a),
                                    endpoints + args + ["--json"])
            pcode2, pout = _run_cli(pstatus.main,
                                    endpoints + args + ["--json"])
            jdoc, pdoc2 = json.loads(jout), json.loads(pout)
            assert pcode == pcode2 == jcode == jcode2 == code == \
                pdoc2["exit"]
            # the tables but for the uptime and last-flush clocks
            assert _strip_clock_text(ptext) == _strip_clock_text(jtext)
            assert _strip_clocks(pdoc2) == _strip_clocks(jdoc)
            assert pdoc2["fleet"] == (len(endpoints) > 1)
            fams = {q["family"] for q in pdoc2["quantiles"]}
            assert {"zoo_serving_e2e_quantiles_seconds",
                    "zoo_serving_queue_wait_quantiles_seconds",
                    "zoo_serving_dispatch_quantiles_seconds"} <= fams
    finally:
        for s in scrapes[1::2]:
            s.close()


def test_status_cli_human_output_and_unreachable_exit():
    """The human tables on a live port endpoint name the serve loop, the
    goodput line and the quantile table; a dead port exits 1 in both
    CLIs (the port's as ``python -m``, where jax is not needed)."""
    make_j, make_p = _pair("model")
    backend = LocalBackend()
    server = make_p(backend, pobs.MetricsRegistry())
    scrape = server.serve_metrics(port=0)
    server.start()
    try:
        inq = pclient.InputQueue(backend)
        for i in range(5):
            inq.enqueue(f"h-{i}", np.zeros(6, np.float32))
        out = pclient.OutputQueue(backend)
        for i in range(5):
            assert out.query(f"h-{i}", timeout=60) is not None
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = pstatus.main([f"{scrape.host}:{scrape.port}"])
        text = buf.getvalue()
    finally:
        server.stop()
    assert code == 0
    assert ": ok" in text and "running" in text and "performance" in text
    assert "latency quantiles (ms)" in text and "p99" in text
    dead = str(scrape.port)            # closed by stop()
    proc = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.status",
         dead, "--json"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 1, proc.stderr
    assert json.loads(proc.stdout)["unreachable"] == [
        f"http://127.0.0.1:{dead}"]
    assert _run_cli(lambda a: _jax_cli(a), [dead])[0] == 1


def test_a_crashed_serve_loop_reads_down_and_the_cli_exits_1(tmp_path):
    """An escaped exception in the serve loop flips /healthz to down with
    the traceback on /statusz once the supervisor gives up (here at the
    first crash, ``max_loop_restarts=0``), as the JAX server reads; both
    CLIs then exit 1."""

    class BrokenBackend(LocalBackend):
        def backlog_len(self, stream, group=None):
            raise ValueError("backend wedged")

    _, pm = _models()
    backend = BrokenBackend()
    server = _port_server(InferenceModel(device="cpu").from_keras(pm),
                          max_loop_restarts=0)(backend,
                                               pobs.MetricsRegistry())
    events = str(tmp_path / "crash.jsonl")
    server.set_json_events(events)
    scrape = server.serve_metrics(port=0)
    server.start()
    pclient.InputQueue(backend).enqueue("c-0", np.zeros(6, np.float32))
    try:
        server._thread.join(timeout=60)
        assert not server._thread.is_alive()
        base = f"http://{scrape.host}:{scrape.port}"
        health = _get_json(base + "/healthz")
        status = _get_json(base + "/statusz")
        ep = f"{scrape.host}:{scrape.port}"
        pcode, _ = _run_cli(pstatus.main, [ep, "--json"])
        jcode, _ = _run_cli(lambda a: _jax_cli(a), [ep, "--json"])
    finally:
        server.stop(drain=False)
    assert health["status"] == "down"
    assert health["serving"]["running"] is False
    assert health["serving"]["loops_down"] == ["serve"]
    assert "backend wedged" in status["serving"]["last_crash"]["serve"]
    assert pcode == jcode == 1
    assert [e["loop"] for e in pobs.read_events(events,
                                                kind="serving.loop_crash")] \
        == ["serve"]


@pytest.mark.parametrize("enabled", [True, False])
def test_goodput_seams_account_the_serve_loop(tmp_path, enabled):
    pctx.init_zoo_context(conf={"zoo.goodput.enabled": enabled})
    make_j, make_p = _pair("model")
    reg = pobs.MetricsRegistry()
    _, _, snap, scrape, _ = _serve(make_p, LocalBackend(), pclient,
                                   _records(n=9), reg, tmp_path, "g")
    scrape.close()
    gp = pobs.goodput_snapshot(reg)
    if not enabled:
        assert gp == {"ratio": None, "goodput_s": 0.0, "badput_s": {}}
        return
    assert gp["goodput_s"] > 0 and gp["badput_s"]["host_decode"] > 0
    assert gp["badput_s"]["shed"] == 0.0
    assert 0 < gp["ratio"] < 1
