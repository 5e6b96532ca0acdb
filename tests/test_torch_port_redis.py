"""``RedisBackend`` and the RESP client of the port held against the JAX
package's over a real socket.

Both packages' backends talk to the JAX test's RESP fake
(``_MiniRedisServer``, and ``_FlakyHandler`` for scripted connection
drops, from ``tests/test_serving_redis.py``), each to a fresh server of
its own, and run the contracts of that test file: streams and results
with binary payloads, the consumer group (exactly-one delivery, XACK
with XDEL, reclaim with the previous owner), the fleet registry hash,
backpressure, the full serving flow (a small ``BERTClassifier`` on
transferred weights), transparent reconnect of idempotent commands,
XADD at most once, pipeline retry as a unit, fault sites, the chaos
scenario against the live backend, a fleet killed and reclaimed over
the wire, and the DLQ replayed over RESP by the port's ``dlq_cli``. The
outcomes of the two packages must agree. ``chip_smoke.MiniResp`` (the
fleet phase's broker) and the JAX fake answer one command script with
the same bytes.
"""

import collections
import contextlib
import io
import os
import re
import runpy
import socket
import subprocess
import sys
import threading
import time
import types

import jax
import numpy as np
import pytest

from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu import serving as jserving
from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.common import faults as jfaults
from analytics_zoo_tpu.common import reliability as jrel
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.inference import InferenceModel as JaxIM
from analytics_zoo_tpu.serving import backend as jbackend
from analytics_zoo_tpu.serving import fleet as jfleet
from analytics_zoo_tpu.serving import resp as jresp
from analytics_zoo_tpu.serving.dlq import DeadLetterQueue as JaxDLQ
from analytics_zoo_tpu.tfpark.bert_classifier import \
    BERTClassifier as JaxBERTClassifier
from analytics_zoo_tpu_torch import observability as pobs
from analytics_zoo_tpu_torch import serving as pserving
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.common import faults as pfaults
from analytics_zoo_tpu_torch.common import reliability as prel
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
from analytics_zoo_tpu_torch.serving import backend as pbackend
from analytics_zoo_tpu_torch.serving import dlq_cli
from analytics_zoo_tpu_torch.serving import fleet as pfleet
from analytics_zoo_tpu_torch.serving import resp as presp
from analytics_zoo_tpu_torch.serving.dlq import DeadLetterQueue
from analytics_zoo_tpu_torch.tfpark.bert_classifier import (
    BERTClassifier, load_jax_params, make_bert_inputs)
from test_serving_redis import _FlakyHandler, _MiniRedisServer

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DLQ_CLI = os.path.join(REPO, "scripts", "zoo-dlq")
STREAM = "tensor_stream"
GROUP = "serving"

PORT = types.SimpleNamespace(
    name="port", Redis=pbackend.RedisBackend, QueueFull=pbackend.QueueFullError,
    Resp=presp.RespClient, Serving=pserving.ClusterServing,
    InputQueue=pserving.InputQueue, OutputQueue=pserving.OutputQueue,
    ServingError=pserving.ServingError, Registry=pobs.MetricsRegistry,
    read_events=pobs.read_events, Retry=prel.RetryPolicy, faults=pfaults,
    fleet=pfleet, ctx=pctx)
JAX = types.SimpleNamespace(
    name="jax", Redis=jbackend.RedisBackend, QueueFull=jbackend.QueueFullError,
    Resp=jresp.RespClient, Serving=jserving.ClusterServing,
    InputQueue=jserving.InputQueue, OutputQueue=jserving.OutputQueue,
    ServingError=jserving.client.ServingError, Registry=jobs.MetricsRegistry,
    read_events=jobs.read_events, Retry=jrel.RetryPolicy, faults=jfaults,
    fleet=jfleet, ctx=jctx)
BOTH = (PORT, JAX)


@pytest.fixture(autouse=True)
def contexts():
    pctx.reset_zoo_context()
    yield
    pctx.reset_zoo_context()
    jctx.init_zoo_context(conf={"zoo.faults.enabled": False,
                                "zoo.pallas.attention": "auto"})
    jeng.set_policy()


class _CountedFlakyHandler(_FlakyHandler):
    """The flaky fake's handler, counting the connections it has served
    to their end (``state.handled``) so a test can wait for a connection
    that the client dropped to be drained."""

    def handle(self):
        try:
            super().handle()
        finally:
            st = self.server.state
            with st.lock:
                st.handled += 1
                st.lock.notify_all()


def wait_handled(srv, n, deadline_s=5.0):
    """Block until the server has served ``n`` connections to their end.
    A command sent on a connection the client then dropped is applied
    (or refused) by that connection's handler thread, which may run after
    the client's next command on a fresh connection."""
    st = srv.state
    with st.lock:
        assert st.lock.wait_for(lambda: st.handled >= n, deadline_s), (
            f"the server handled {st.handled} of {n} connections "
            f"within {deadline_s} s")


@pytest.fixture()
def servers():
    """``start(flaky=False)`` → a fresh RESP fake on a free port; all are
    shut down after the test."""
    live = []

    def start(flaky=False):
        srv = _MiniRedisServer(("127.0.0.1", 0))
        if flaky:
            srv.RequestHandlerClass = _CountedFlakyHandler
            srv.state.fault_script = {}
            srv.state.handled = 0
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        live.append(srv)
        return srv

    yield start
    for srv in live:
        srv.shutdown()
        srv.server_close()


def port_of(srv):
    return srv.server_address[1]


class Double:
    def predict(self, x):
        return np.asarray(x) * 2.0


class Blocking(Double):
    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def predict(self, x):
        self.entered.set()
        assert self.release.wait(timeout=30.0), "model never released"
        return super().predict(x)


# ---------------------------------------------------------------------------
# the wire contracts (tests/test_serving_redis.py:399-475)
# ---------------------------------------------------------------------------

def stream_and_results(pkg, port):
    b = pkg.Redis(port=port, maxlen=100)
    out = []
    eid = b.xadd("serving_stream", {"uri": "a", "data": b"\x00raw\xff"})
    out.append(isinstance(eid, str) and "-" in eid)
    out.append(b.stream_len("serving_stream"))
    out.append(b.xread("serving_stream", 10, block_ms=100)[0][1])
    out.append(b.stream_len("serving_stream"))
    b.set_result("a", {"value": "42", "dtype": "<f4"})
    out.append(b.pop_result("a", timeout=1.0))
    out.append(b.pop_result("a", timeout=0.05))
    b.set_results({"x": {"value": "1"}, "y": {"value": "2"}})
    out.append(b.pop_all_results())
    return out


def test_stream_and_result_contract_matches_jax(servers):
    got = [stream_and_results(pkg, port_of(servers())) for pkg in BOTH]
    assert got[0] == got[1] == [
        True, 1, {"uri": "a", "data": b"\x00raw\xff"}, 0,
        {"value": b"42", "dtype": "<f4"}, None,
        {"x": {"value": b"1"}, "y": {"value": b"2"}}]


def consumer_group(pkg, port):
    b = pkg.Redis(port=port, maxlen=100)
    out = []
    b.xgroup_create("grp_stream", "g")
    b.xgroup_create("grp_stream", "g")      # BUSYGROUP swallowed
    for i in range(4):
        b.xadd("grp_stream", {"uri": f"u{i}", "data": b"\x00\xff"})
    e1 = b.xreadgroup("grp_stream", "g", "c1", 2, block_ms=100)
    e2 = b.xreadgroup("grp_stream", "g", "c2", 2, block_ms=100)
    out += [[f["uri"] for _, f in e1], [f["uri"] for _, f in e2],
            e1[0][1]["data"], b.backlog_len("grp_stream", "g"),
            b.xpending("grp_stream", "g")]
    out += [b.xack("grp_stream", "g", e1[0][0]),
            b.pending_len("grp_stream", "g"), b.stream_len("grp_stream"),
            b.xack("grp_stream", "g", e1[0][0])]
    time.sleep(0.05)
    claimed = b.xautoclaim("grp_stream", "g", "c1", 30, count=10)
    out += [sorted(f["uri"] for _e, f, _p, _t in claimed),
            sorted({p for _e, _f, p, _t in claimed}),
            sorted({t for _e, _f, _p, t in claimed}),
            b.xautoclaim("grp_stream", "g", "c3", 30, count=10),
            b.xpending("grp_stream", "g")]
    # a tombstone: an entry deleted from the stream while still pending
    # is settled by the next sweep, not re-claimed forever
    b.xadd("grp_stream", {"uri": "gone"})
    (eid, _), = b.xreadgroup("grp_stream", "g", "c4", 1, block_ms=100)
    b._r.xdel("grp_stream", eid)
    time.sleep(0.05)
    again = b.xautoclaim("grp_stream", "g", "c1", 30, count=10)
    out += [sorted((f["uri"], p, t) for _e, f, p, t in again),
            b.xpending("grp_stream", "g")]
    return out


def test_consumer_group_contract_matches_jax(servers):
    got = [consumer_group(pkg, port_of(servers())) for pkg in BOTH]
    assert got[0] == got[1]
    assert got[0] == [
        ["u0", "u1"], ["u2", "u3"], b"\x00\xff", 0, {"c1": 2, "c2": 2},
        1, 3, 3, 0, ["u1", "u2", "u3"], ["c1", "c2"], [2], [],
        {"c1": 3}, [("u1", "c1", 3), ("u2", "c1", 3), ("u3", "c1", 3)],
        {"c1": 3}]


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p.name)
def test_fleet_registry_round_trip(servers, pkg):
    b = pkg.Redis(port=port_of(servers()))
    b.fleet_set("fs", "r1", '{"mode": "group:g", "ts": 1}')
    b.fleet_set("fs", "r2", '{"mode": "group:g", "ts": 2}')
    assert b.fleet_all("fs") == {"r1": '{"mode": "group:g", "ts": 1}',
                                 "r2": '{"mode": "group:g", "ts": 2}'}
    b.fleet_del("fs", "r1")
    assert set(b.fleet_all("fs")) == {"r2"}
    # the registry is the fleet:<stream> hash on the wire
    assert b._r.hgetall("fleet:fs") == {b"r2": b'{"mode": "group:g", "ts": 2}'}


def backpressure(pkg, port):
    b = pkg.Redis(port=port, maxlen=3)
    for i in range(3):
        b.xadd("bp_stream", {"i": str(i)})
    with pytest.raises(pkg.QueueFull) as e:
        b.xadd("bp_stream", {"i": "overflow"}, timeout=0.2)
    b.xread("bp_stream", 2, block_ms=100)
    b.xadd("bp_stream", {"i": "fits-now"}, timeout=1.0)
    return str(e.value), b.stream_len("bp_stream")


def test_backpressure_matches_jax(servers):
    got = [backpressure(pkg, port_of(servers())) for pkg in BOTH]
    assert got[0] == got[1] == (
        "stream 'bp_stream' full (3); inference is not keeping up — "
        "dequeue or raise maxlen", 2)


def test_driver_transport_errors_normalize_to_builtin(servers):
    b = pbackend.RedisBackend(port=port_of(servers()), maxlen=10)

    class FakeDriverError(Exception):
        pass

    b._driver_errors = (FakeDriverError,)

    def boom():
        raise FakeDriverError("driver-specific transport loss")

    with pytest.raises(ConnectionError, match="FakeDriverError"):
        b._call(boom)
    assert b._call(lambda: 7) == 7
    b2 = pbackend.RedisBackend(port=port_of(servers()))
    assert b2._driver_errors == () and b2._is_resp
    assert isinstance(b2._r, presp.RespClient)


def test_module_surfaces_match_jax():
    assert presp.__all__ == jresp.__all__
    assert presp._NON_IDEMPOTENT == jresp._NON_IDEMPOTENT
    assert pbackend._BINARY_FIELDS == jbackend._BINARY_FIELDS
    for name in jresp.__all__:
        j, p = getattr(jresp, name), getattr(presp, name)
        assert sorted(n for n in vars(p) if not n.startswith("__")) == \
            sorted(n for n in vars(j) if not n.startswith("__")), name
    j, p = jbackend.RedisBackend, pbackend.RedisBackend
    assert sorted(n for n in vars(p) if not n.startswith("__")) == \
        sorted(n for n in vars(j) if not n.startswith("__"))


# ---------------------------------------------------------------------------
# RESP reconnect semantics (tests/test_serving_redis.py:528-718)
# ---------------------------------------------------------------------------

def client(pkg, srv, **kw):
    reg = pkg.Registry()
    kw.setdefault("retry", pkg.Retry(max_attempts=3, base_delay=0.001,
                                     max_delay=0.005, seed=4))
    return pkg.Resp(port=port_of(srv), timeout=5.0, registry=reg, **kw), reg


def reconnects(reg):
    return reg.snapshot()[
        'zoo_backend_reconnects_total{backend="resp"}']["value"]


def resp_script(pkg, start):
    """Every reconnect scenario of the JAX file, one fresh flaky server
    each; returns the observable outcome of each."""
    out = []
    srv = start(flaky=True)
    c, reg = client(pkg, srv)
    c.xadd("s", {"k": "v"})
    srv.state.fault_script["XLEN"] = ["before"]
    out.append(("reconnect", c.xlen("s"), reconnects(reg), c.ping(),
                reconnects(reg)))

    srv = start(flaky=True)
    c, _ = client(pkg, srv)
    srv.state.fault_script["XADD"] = ["after"]
    with pytest.raises((ConnectionError, OSError)):
        c.xadd("once", {"uri": "a"})
    n1 = c.xlen("once")
    srv.state.fault_script["XADD"] = ["before"]
    with pytest.raises((ConnectionError, OSError)):
        c.xadd("once", {"uri": "b"})
    out.append(("xadd at most once", n1, c.xlen("once")))

    srv = start(flaky=True)
    c, reg = client(pkg, srv)
    srv.state.fault_script["HSET"] = ["after"]
    pipe = c.pipeline()
    pipe.hset("result:a", {"value": "1"})
    pipe.hset("result:b", {"value": "2"})
    replies = pipe.execute()
    out.append(("pipeline retry", len(replies), c.hgetall("result:a"),
                c.hgetall("result:b"), reconnects(reg)))

    srv = start(flaky=True)
    c, _ = client(pkg, srv)
    srv.state.fault_script["XADD"] = ["after"]
    with pytest.raises((ConnectionError, OSError)):
        c.execute_many([("XADD", "mixed", "*", "uri", "x"),
                        ("HSET", "result:x", "value", "1")])
    out.append(("mixed pipeline", c.xlen("mixed")))

    srv = start(flaky=True)
    c, reg = client(pkg, srv)
    assert c.ping()
    srv.state.fault_script["XLEN"] = ["before"] * 3
    with pytest.raises((ConnectionError, OSError)):
        c.xlen("s")
    out.append(("bounded attempts", reconnects(reg)))

    srv = start(flaky=True)
    c, _ = client(pkg, srv)
    with pytest.raises(Exception) as e:
        c.command("NOSUCH")
    out.append(("error reply", type(e.value).__name__, str(e.value),
                c.ping()))
    c.close()
    with pytest.raises(RuntimeError) as e:
        c.ping()
    out.append(("closed", str(e.value)))
    return out


def test_resp_reconnect_semantics_match_jax(servers):
    port = resp_script(PORT, servers)
    jax_ = resp_script(JAX, servers)
    assert port == jax_
    assert port == [
        ("reconnect", 1, 1.0, True, 1.0),
        ("xadd at most once", 1, 1),
        ("pipeline retry", 2, {b"value": b"1"}, {b"value": b"2"}, 1.0),
        ("mixed pipeline", 1),
        ("bounded attempts", 2.0),
        ("error reply", "RespError", "ERR unknown command 'NOSUCH'", True),
        ("closed", "RespClient is closed")]


def fault_sites(pkg, start):
    pkg.ctx.init_zoo_context(conf={"zoo.faults.enabled": True})
    out = []
    c, reg = client(pkg, start(flaky=True))
    plan = pkg.faults.FaultPlan(seed=13).add("resp.send", "disconnect",
                                             at=(2,))
    with pkg.faults.activate(plan):
        assert c.ping()
        c.xadd("s", {"k": "v"})
        out.append(c.xlen("s"))
    out += [plan.fired, reconnects(reg)]
    srv = start(flaky=True)
    c, reg = client(pkg, srv)
    plan = pkg.faults.FaultPlan(seed=14).add("resp.recv", "disconnect",
                                             at=(1,))
    with pkg.faults.activate(plan):
        assert c.ping()
        with pytest.raises((ConnectionError, OSError)):
            c.xadd("once-chaos", {"uri": "a"})
        # the XADD went out on the connection the fault dropped: wait for
        # its handler to apply it before reading on a fresh connection
        wait_handled(srv, 1)
        out.append(c.xlen("once-chaos"))
    out += [plan.fired, reconnects(reg)]
    return out


def test_resp_fault_sites_match_jax(servers):
    port, jax_ = fault_sites(PORT, servers), fault_sites(JAX, servers)
    assert port == jax_ == [
        1, [("resp.send", "disconnect", 2)], 1.0,
        1, [("resp.recv", "disconnect", 1)], 0.0]


def chaos_live(pkg, port):
    """A planned ``backend.xadd`` disconnect hits the producer mid-enqueue
    (at most once: the producer re-enqueues); every record the stream
    took is served."""
    pkg.ctx.init_zoo_context(conf={"zoo.faults.enabled": True})
    backend = pkg.Redis(port=port, maxlen=50)
    serving = pkg.Serving(Double(), backend=backend, batch_size=4,
                          registry=pkg.Registry(), heartbeat_s=0.05)
    plan = pkg.faults.FaultPlan(seed=21).add("backend.xadd", "disconnect",
                                             at=(2,))
    inq, outq = pkg.InputQueue(backend=backend), pkg.OutputQueue(backend)
    rng = np.random.default_rng(3)
    xs = {f"cx{i}": rng.normal(size=(4,)).astype(np.float32)
          for i in range(6)}
    dropped = []
    with pkg.faults.activate(plan):
        serving.start()
        try:
            for uri, arr in xs.items():
                try:
                    inq.enqueue(uri, arr)
                except ConnectionError:
                    dropped.append(uri)
                    inq.enqueue(uri, arr)
            got = {uri: outq.query(uri, timeout=30.0) for uri in xs}
        finally:
            serving.stop(drain=False)
    for uri, x in xs.items():
        np.testing.assert_allclose(got[uri], x * 2.0, rtol=1e-6)
    if pkg is JAX:
        # the JAX backend caches a heartbeat's depth probe whose XPENDING
        # was answered before the last batch's ack and came back after it;
        # its serve loop's threads are joined, so read the group's PEL as
        # it stands. The port's backend drops such a count itself, so its
        # half reads through its cache
        backend.pending_cache_s = 0.0
    return plan.fired, dropped, backend.pending_len(STREAM, GROUP)


def test_chaos_scenario_runs_against_live_backend_as_jax(servers):
    got = [chaos_live(pkg, port_of(servers())) for pkg in BOTH]
    assert got[0] == got[1] == (
        [("backend.xadd", "disconnect", 2)], ["cx2"], 0)


def test_pending_probe_overlapping_an_ack_caches_no_stale_count(servers):
    """A depth probe whose XPENDING went out before an ack and came back
    after it does not cache its pre-ack count: the next ``pending_len``
    within the cache window reads the settled PEL."""
    backend = PORT.Redis(port=port_of(servers()))
    backend.xgroup_create(STREAM, GROUP)
    backend.xadd(STREAM, {"uri": "a"})
    (eid, _), = backend.xreadgroup(STREAM, GROUP, "c0", 1)
    real = backend.xpending
    answered, acked = threading.Event(), threading.Event()

    def slow(stream, group):
        out = real(stream, group)       # the count before the ack
        answered.set()
        acked.wait(5.0)
        return out

    backend.xpending = slow
    probe = threading.Thread(target=backend.pending_len,
                             args=(STREAM, GROUP))
    probe.start()
    assert answered.wait(5.0)
    assert backend.xack(STREAM, GROUP, eid) == 1
    acked.set()
    probe.join(5.0)
    backend.xpending = real
    assert backend.pending_len(STREAM, GROUP) == 0


# ---------------------------------------------------------------------------
# serving over the wire
# ---------------------------------------------------------------------------

CFG = dict(vocab=99, hidden_size=64, n_block=2, n_head=4, seq_len=16,
           intermediate_size=128)


class BertAdapter:
    """A served record is a ``(T,)`` int32 token row, pad id 0."""

    def __init__(self, im):
        self.im = im

    def predict_async(self, ids, block=True):
        return self.im.predict_async(
            make_bert_inputs(ids, attention_mask=(ids != 0)), block=block)


def test_full_serving_flow_over_redis_matches_jax(servers):
    """A small BERTClassifier (hidden 64, two blocks) on transferred
    weights, served by each package's server over its ``RedisBackend``
    on a RESP socket: the answers agree within f32's 1e-5 and every
    entry is settled."""
    jctx.init_zoo_context(conf={"zoo.pallas.attention": True})
    pctx.init_zoo_context(conf={"zoo.pallas.attention": True})
    jm = JaxBERTClassifier(3, **CFG)
    jm.init_weights(rng=jax.random.key(7))
    pm = BERTClassifier(3, **CFG, device="cpu")
    load_jax_params(pm, jax.tree.map(np.asarray, jm.params))
    rng = np.random.default_rng(0)
    ids = rng.integers(1, CFG["vocab"], (20, 16)).astype(np.int32)
    lens = rng.integers(3, 17, 20)
    ids[np.arange(16)[None, :] >= lens[:, None]] = 0
    answers, pels = {}, {}
    for pkg, im in ((PORT, InferenceModel(concurrent_num=2, device="cpu")
                     .from_keras(pm)),
                    (JAX, JaxIM(concurrent_num=2).from_keras(jm))):
        backend = pkg.Redis(port=port_of(servers()), maxlen=50)
        serving = pkg.Serving(BertAdapter(im), backend=backend, batch_size=8,
                              registry=pkg.Registry(), heartbeat_s=0.05)
        inq = pkg.InputQueue(backend=backend)
        for i in range(len(ids)):
            inq.enqueue(f"img{i}", ids[i])
        serving.start()
        try:
            outq = pkg.OutputQueue(backend=backend)
            answers[pkg.name] = np.stack([outq.query(f"img{i}", timeout=60)
                                          for i in range(len(ids))])
        finally:
            serving.stop()
        pels[pkg.name] = (backend.pending_len(STREAM, GROUP),
                          backend.stream_len(STREAM), serving.served)
    np.testing.assert_allclose(answers["port"], answers["jax"], atol=1e-5,
                               rtol=0)
    assert answers["port"].shape == (20, 3)
    assert pels["port"] == pels["jax"] == (0, 0, 20)


def fleet_over_resp(pkg, port, tmp):
    """The kill-and-reclaim scenario with every replica on its own
    ``RedisBackend`` (its own connection pool) on one RESP server."""
    pkg.ctx.init_zoo_context(conf={"zoo.faults.enabled": False})

    def backend():
        return pkg.Redis(port=port, maxlen=100)

    xs = {}
    inq = pkg.InputQueue(backend())
    rng = np.random.default_rng(17)
    for i in range(16):
        xs[f"w-{i}"] = rng.normal(size=(6,)).astype(np.float32)
        inq.enqueue(f"w-{i}", xs[f"w-{i}"])
    vm = Blocking()
    common = dict(batch_size=4, block_ms=20, claim_sweep_s=0.03,
                  heartbeat_s=0.05)
    victim = pkg.Serving(vm, backend=backend(), registry=pkg.Registry(),
                         consumer_name="victim", claim_idle_ms=60000,
                         **common).start()
    assert vm.entered.wait(10.0)
    probe = backend()
    window = probe.xpending(STREAM, GROUP)
    regs = [pkg.Registry() for _ in range(2)]
    survivors = [pkg.Serving(Double(), backend=backend(), registry=reg,
                             consumer_name=f"s{i}", claim_idle_ms=150,
                             **common) for i, reg in enumerate(regs)]
    for i, s in enumerate(survivors):
        s.set_json_events(str(tmp / f"{pkg.name}-resp-s{i}.jsonl"))
        s.start()
    live = sorted(pkg.fleet.live_members(probe, STREAM, ttl_s=5.0))
    victim.kill(join=False)
    vm.release.set()
    victim.kill()
    outq = pkg.OutputQueue(backend())
    got = {uri: outq.query(uri, timeout=20.0) for uri in xs}
    for s in survivors:
        s.stop()
    for uri, x in xs.items():
        np.testing.assert_allclose(got[uri], x * 2.0, rtol=1e-6)
    snaps = [r.snapshot() for r in regs]

    def total(name):
        return sum(v["value"] for snap in snaps for k, v in snap.items()
                   if k.split("{", 1)[0] == name)

    reclaimed = collections.Counter()
    for snap in snaps:
        for k, v in snap.items():
            if k.startswith("zoo_serving_reclaimed_total"):
                reclaimed[k] += v["value"]
    events = []
    for i in range(2):
        events += pkg.read_events(str(tmp / f"{pkg.name}-resp-s{i}.jsonl"),
                                  kind="serving.reclaim")
    return {"window": window, "live": live,
            "answered": total("zoo_serving_records_total"),
            "acks": total("zoo_serving_acks_total"),
            "reclaimed": dict(reclaimed), "reclaim_events": len(events),
            "victim_served": victim.served,
            "pel": probe.pending_len(STREAM, GROUP),
            "stream": probe.stream_len(STREAM),
            "fleet_after": sorted(probe.fleet_all(STREAM))}


def test_fleet_killed_and_reclaimed_over_resp_as_jax(servers, tmp_path):
    got = [fleet_over_resp(pkg, port_of(servers()), tmp_path)
           for pkg in BOTH]
    assert got[0] == got[1]
    assert got[0] == {
        "window": {"victim": 4}, "live": ["s0", "s1", "victim"],
        "answered": 16.0, "acks": 16.0,
        "reclaimed": {'zoo_serving_reclaimed_total{from="victim"}': 4.0},
        "reclaim_events": 4, "victim_served": 0, "pel": 0, "stream": 0,
        # the survivors deregistered; the killed replica's heartbeat
        # stays until the TTL reaps it
        "fleet_after": ["victim"]}


# ---------------------------------------------------------------------------
# the DLQ over RESP and the dlq_cli (tests/test_serving_redis.py:796-874,
# tests/test_serving_dlq.py:283-321)
# ---------------------------------------------------------------------------

def spill(q, n, prefix="cli", reason="dispatch"):
    rng = np.random.default_rng(3)
    xs = {}
    for i in range(n):
        xs[f"{prefix}-{i}"] = rng.normal(size=(4,)).astype(np.float32)
        q.append(f"{prefix}-{i}", xs[f"{prefix}-{i}"], reason=reason,
                 trace=f"{i:016x}", error="boom")
    q.close()
    return xs


def port_cli(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = dlq_cli.main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def jax_cli(argv):
    out, err = io.StringIO(), io.StringIO()
    old = sys.argv
    sys.argv = [JAX_DLQ_CLI] + list(argv)
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            try:
                ns = runpy.run_path(JAX_DLQ_CLI, run_name="zoo_dlq_cli")
                rc = ns["main"]()
            except SystemExit as e:
                rc = e.code
    finally:
        sys.argv = old
    return rc, out.getvalue(), err.getvalue()


def strip_ages(text):
    return re.sub(r"age=[0-9]+s", "age=_", text)


def test_dlq_cli_list_inspect_purge_match_the_jax_script(tmp_path):
    spill(DeadLetterQueue(str(tmp_path / "d"), registry=pobs.MetricsRegistry()),
          3)
    for argv in (["list"], ["inspect"], ["inspect", "--replayed"]):
        p = port_cli(argv + [str(tmp_path / "d")])
        j = jax_cli(argv + [str(tmp_path / "d")])
        assert (p[0], strip_ages(p[1]), p[2]) == \
            (j[0], strip_ages(j[1]), j[2]), argv
        assert p[0] == 0
    rc, out, _ = port_cli(["list", str(tmp_path / "d")])
    assert "sealed" in out and "replayable: 3 record(s)" in out
    rc, out, _ = port_cli(["inspect", str(tmp_path / "d")])
    assert "cli-0" in out and "reason=dispatch" in out
    assert "error: boom" in out
    # purge --all without --yes refuses; with --yes it drops the work
    p = port_cli(["purge", str(tmp_path / "d"), "--all"])
    j = jax_cli(["purge", str(tmp_path / "d"), "--all"])
    assert p == j and p[0] == 1 and "--yes" in p[2]
    rc, out, _ = port_cli(["purge", str(tmp_path / "d"), "--all", "--yes"])
    assert rc == 0 and "3 unreplayed record(s) dropped" in out
    assert DeadLetterQueue(str(tmp_path / "d"),
                           registry=pobs.MetricsRegistry()).depth == 0


def test_dlq_cli_empty_bad_dir_and_empty_replay_exit_codes(tmp_path):
    os.makedirs(tmp_path / "empty")
    os.makedirs(tmp_path / "d")
    for argv in (["list", str(tmp_path / "missing")],
                 ["list", str(tmp_path / "empty")],
                 ["replay", str(tmp_path / "d"), "--port", "1"],
                 ["replay", str(tmp_path / "d"), "--rate", "0"],
                 ["purge", str(tmp_path / "d")]):
        assert port_cli(argv) == jax_cli(argv), argv
    assert port_cli(["list", str(tmp_path / "missing")])[0] == 1
    rc, out, _ = port_cli(["list", str(tmp_path / "empty")])
    assert rc == 0 and "no segments" in out
    rc, _, err = port_cli(["replay", str(tmp_path / "d"), "--port", "1"])
    assert rc == 2 and "nothing replayed" in err


def test_dlq_replay_over_resp_serves_end_to_end(servers, tmp_path):
    """Spill records, replay them through ``python -m ...dlq_cli replay``
    (a subprocess: real RESP round trips) onto a live RESP server, and
    serve them with the port's server: every record answered under a
    fresh trace id; a second replay is empty (exit 2). A directory the
    JAX package wrote replays the same way."""
    port = port_of(servers())
    xs = spill(DeadLetterQueue(str(tmp_path / "dlq"),
                               registry=pobs.MetricsRegistry()), 3,
               prefix="rp", reason="publish")
    xs.update(spill(JaxDLQ(str(tmp_path / "jdlq"),
                           registry=jobs.MetricsRegistry()), 2,
                    prefix="jrp", reason="publish"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO

    def replay(d):
        return subprocess.run(
            [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.dlq_cli",
             "replay", str(tmp_path / d), "--port", str(port), "--host",
             "127.0.0.1"], capture_output=True, text=True, env=env,
            timeout=120, cwd=REPO)

    r = replay("dlq")
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"replayed 3 record(s) onto 'tensor_stream' at 127.0.0.1:{port}" \
        in r.stdout
    r = replay("jdlq")
    assert r.returncode == 0 and "replayed 2 record(s)" in r.stdout
    backend = pbackend.RedisBackend(port=port, maxlen=50)
    assert backend.stream_len(STREAM) == 5
    serving = pserving.ClusterServing(Double(), backend=backend, batch_size=4,
                                      registry=pobs.MetricsRegistry(),
                                      heartbeat_s=0.05)
    serving.set_json_events(str(tmp_path / "events.jsonl"))
    serving.start()
    try:
        outq = pserving.OutputQueue(backend=backend)
        got = {uri: outq.query(uri, timeout=30.0) for uri in xs}
    finally:
        serving.stop()
    for uri, x in xs.items():
        np.testing.assert_allclose(got[uri], x * 2.0, rtol=1e-6)
    by_trace = collections.defaultdict(list)
    for e in pobs.read_events(str(tmp_path / "events.jsonl"),
                              kind="request"):
        by_trace[e["trace"]].append(e["phase"])
    assert len(by_trace) == 5
    assert not set(by_trace) & {f"{i:016x}" for i in range(3)}
    assert all(p.count("publish") == 1 for p in by_trace.values())
    r = replay("dlq")
    assert r.returncode == 2 and "nothing replayed" in r.stderr


# ---------------------------------------------------------------------------
# chip_smoke's broker against the JAX fake
# ---------------------------------------------------------------------------

def replies(port, commands):
    """Each command's parsed reply (RespError as its text)."""
    conn = presp._Conn("127.0.0.1", port, 5.0)
    out = []
    try:
        for parts in commands:
            conn.send(*parts)
            try:
                out.append(conn.read_reply())
            except presp.RespError as e:
                out.append(("error", str(e)))
    finally:
        conn.close()
    return out


SCRIPT = [
    ("PING",),
    ("XADD", "s", "*", "uri", "a", "data", b"\x00\xff"),
    ("XADD", "s", "*", "uri", "b"),
    ("XADD", "s", "*", "uri", "c"),
    ("XLEN", "s"),
    ("XREAD", "COUNT", 2, "STREAMS", "s", "0"),
    ("XGROUP", "CREATE", "s", "g", "0", "MKSTREAM"),
    ("XGROUP", "CREATE", "s", "g", "0", "MKSTREAM"),
    ("XGROUP", "DESTROY", "s", "g"),
    ("XREADGROUP", "GROUP", "g", "c1", "COUNT", 2, "BLOCK", 10,
     "STREAMS", "s", ">"),
    ("XREADGROUP", "GROUP", "g", "c2", "COUNT", 5, "STREAMS", "s", ">"),
    ("XREADGROUP", "GROUP", "g", "c2", "COUNT", 5, "BLOCK", 10,
     "STREAMS", "s", ">"),
    ("XPENDING", "s", "g"),
    ("XPENDING", "s", "g", "IDLE", 0, "-", "+", 10),
    ("XPENDING", "s", "g", "IDLE", 60000, "-", "+", 10),
    ("XCLAIM", "s", "g", "c3", 60000, "1-1"),
    ("XACK", "s", "g", "nope-0"),
    ("XPENDING", "s", "nogroup"),
    ("HSET", "result:a", "value", b"\x01\x02", "dtype", "<f4"),
    ("HSET", "result:a", "value", b"\x03"),
    ("HSET", "fleet:s", "r1", '{"ts": 1}'),
    ("HGETALL", "result:a"),
    ("HGETALL", "result:none"),
    ("KEYS", "result:*"),
    ("HDEL", "fleet:s", "r1", "r2"),
    ("DEL", "result:a", "result:none"),
    ("KEYS", "*"),
    ("XREAD", "COUNT", 1, "BLOCK", 10, "STREAMS", "empty", "0"),
    ("NOSUCH", "x"),
]


#: the script's XPENDING range with IDLE 0: its rows carry each entry's
#: idle milliseconds, a clock reading
IDLE_ROWS = SCRIPT.index(("XPENDING", "s", "g", "IDLE", 0, "-", "+", 10))


def normalise(replies_):
    """Entry ids carry the server's clock and sequence: replace each by
    its position of first appearance; drop the idle times."""
    replies_ = list(replies_)
    replies_[IDLE_ROWS] = [row[:2] + row[3:] for row in replies_[IDLE_ROWS]]
    ids = {}

    def walk(v):
        if isinstance(v, list):
            return [walk(x) for x in v]
        if isinstance(v, bytes) and v.count(b"-") == 1 \
                and v.split(b"-")[0].isdigit() and len(v) > 10:
            return ids.setdefault(v, f"id{len(ids)}")
        return v
    return walk(replies_)


def test_chip_smoke_mini_resp_answers_as_the_jax_fake(servers):
    jax_srv = servers()
    mini = chip_smoke.MiniResp()
    threading.Thread(target=mini.serve_forever, daemon=True).start()
    try:
        want = replies(port_of(jax_srv), SCRIPT)
        got = replies(mini.port, SCRIPT)
        counts = replies(mini.port, [("ZOOWRITES",)])[0]
    finally:
        mini.close()
    assert normalise(got) == normalise(want)
    assert got[0] == b"PONG" and got[-1][0] == "error"
    # the broker counts HSETs a key
    assert counts == [b"result:a", b"2", b"fleet:s", b"1"]


def test_chip_smoke_mini_resp_serves_a_port_fleet():
    """The fleet phase's broker under two port replicas on RedisBackend:
    every record answered once, by the result-write count."""
    pctx.init_zoo_context()
    mini = chip_smoke.MiniResp()
    threading.Thread(target=mini.serve_forever, daemon=True).start()
    servers_ = []
    try:
        inq = pserving.InputQueue(pbackend.RedisBackend(port=mini.port))
        rng = np.random.default_rng(2)
        xs = {f"m-{i}": rng.normal(size=(5,)).astype(np.float32)
              for i in range(24)}
        for uri, x in xs.items():
            inq.enqueue(uri, x)
        for i in range(2):
            servers_.append(pserving.ClusterServing(
                Double(), backend=pbackend.RedisBackend(port=mini.port),
                batch_size=4, registry=pobs.MetricsRegistry(),
                consumer_name=f"rep{i}", heartbeat_s=0.05).start())
        outq = pserving.OutputQueue(pbackend.RedisBackend(port=mini.port))
        got = {uri: outq.query(uri, timeout=30.0) for uri in xs}
    finally:
        for s in servers_:
            s.stop()
        counts = replies(mini.port, [("ZOOWRITES",)])[0]
        mini.close()
    for uri, x in xs.items():
        np.testing.assert_allclose(got[uri], x * 2.0, rtol=1e-6)
    writes = dict(zip(counts[::2], counts[1::2]))
    results = {k: v for k, v in writes.items() if k.startswith(b"result:")}
    assert results == {f"result:{u}".encode(): b"1" for u in xs}
    assert sum(s.served for s in servers_) == 24


def test_chip_smoke_mini_resp_child_prints_its_port():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; "
         "chip_smoke.mini_resp_child()"], cwd=REPO, env=env,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        port = int(proc.stdout.readline())
        assert replies(port, [("PING",)]) == [b"PONG"]
    finally:
        proc.stdin.close()
        assert proc.wait(timeout=30) == 0
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=1.0).close()
