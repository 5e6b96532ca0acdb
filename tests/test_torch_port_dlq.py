"""The port's durable dead-letter queue (``serving/dlq.py``) held against
the JAX package's on the same spills: the on-disk format (CRC framing,
the same bytes for the same records), torn-tail tolerance, the segment
lifecycle (open → sealed → replayed), the byte bound with oldest-first
eviction, at-most-once replay with fresh traces and the ``model`` field,
pacing, purge, and a directory written by either package scanned and
replayed by the other. Each scenario runs on both packages and the
outcomes must agree."""

import base64
import os
import types
import zlib

import numpy as np
import pytest

from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu.serving import LocalBackend as JaxBackend
from analytics_zoo_tpu.serving import client as jclient
from analytics_zoo_tpu.serving import dlq as jdlq
from analytics_zoo_tpu_torch import observability as pobs
from analytics_zoo_tpu_torch.serving import LocalBackend
from analytics_zoo_tpu_torch.serving import client as pclient
from analytics_zoo_tpu_torch.serving import dlq as pdlq

PORT = types.SimpleNamespace(name="port", DLQ=pdlq.DeadLetterQueue,
                             Registry=pobs.MetricsRegistry,
                             Backend=LocalBackend, client=pclient)
JAX = types.SimpleNamespace(name="jax", DLQ=jdlq.DeadLetterQueue,
                            Registry=jobs.MetricsRegistry,
                            Backend=JaxBackend, client=jclient)


def _spill(q, n, reason="dispatch", prefix="u", model=None):
    rng = np.random.default_rng(3)
    tensors = {}
    for i in range(n):
        t = rng.normal(size=(4,)).astype(np.float32)
        tensors[f"{prefix}-{i}"] = t
        q.append(f"{prefix}-{i}", t, reason=reason, trace=f"{i:016x}",
                 error="boom", model=model)
    return tensors


def _arr(rec):
    return np.frombuffer(base64.b64decode(rec["data"]),
                         dtype=rec["dtype"]).reshape(
        tuple(int(d) for d in rec["shape"].split(",")))


def _both(scenario, tmp_path):
    """``scenario(pkg, dir)`` on the port and on JAX; returns both
    outcomes after asserting they agree."""
    got = scenario(PORT, str(tmp_path / "port"))
    want = scenario(JAX, str(tmp_path / "jax"))
    assert got == want
    return got


def test_append_scan_roundtrip_and_gauges(tmp_path):
    """Appended records come back bit-exact from scan (uri, trace,
    reason, payload); the depth/bytes gauges track the directory."""
    def run(pkg, d):
        reg = pkg.Registry()
        q = pkg.DLQ(d, registry=reg)
        tensors = _spill(q, 5)
        got = {rec["uri"]: rec for _seg, rec in q.scan()}
        assert set(got) == set(tensors)
        for uri, rec in got.items():
            assert rec["reason"] == "dispatch" and rec["error"] == "boom"
            np.testing.assert_array_equal(_arr(rec), tensors[uri])
        snap = reg.snapshot()
        assert snap["zoo_serving_dlq_bytes"]["value"] == q.total_bytes > 0
        out = (q.depth, snap["zoo_serving_dlq_records"]["value"],
               snap['zoo_serving_dlq_spilled_total{reason="dispatch"}'][
                   "value"], q.total_bytes)
        q.close()
        q2 = pkg.DLQ(d, registry=pkg.Registry())
        return out + (q2.depth, [s["state"] for s in q2.segments()])
    got = _both(run, tmp_path)
    assert got[:3] == (5, 5, 5) and got[4:] == (5, ["sealed"])


def test_torn_tail_line_is_skipped_and_counted(tmp_path):
    """A torn final append fails its CRC frame: skipped and counted, every
    earlier record still reads; a flipped byte inside a committed frame
    is caught the same way."""
    def run(pkg, d):
        reg = pkg.Registry()
        q = pkg.DLQ(d, registry=reg)
        _spill(q, 3)
        q.close()
        seg = os.path.join(d, q.segments()[0]["name"])
        with open(seg, "ab") as f:
            f.write(b"deadbeef {\"uri\": \"torn")
        q2 = pkg.DLQ(d, registry=reg)
        recs = [rec["uri"] for _s, rec in q2.scan()]
        corrupt = reg.snapshot()["zoo_serving_dlq_corrupt_total"]["value"]
        data = open(seg, "rb").read()
        open(seg, "wb").write(data[:10] + bytes([data[10] ^ 0xFF])
                              + data[11:])
        q3 = pkg.DLQ(d, registry=pkg.Registry())
        return recs, corrupt >= 1, len([r for _s, r in q3.scan()])
    assert _both(run, tmp_path) == (["u-0", "u-1", "u-2"], True, 2)


def test_rotation_and_bounded_bytes_evict_oldest(tmp_path):
    """Segments rotate at segment_bytes; past max_bytes the OLDEST sealed
    segment goes first and every dropped record is counted — the same
    survivors in both packages."""
    def run(pkg, d):
        reg = pkg.Registry()
        q = pkg.DLQ(d, registry=reg, max_bytes=4096, segment_bytes=1024)
        _spill(q, 40, prefix="e")
        q.close()
        assert len(q.segments()) > 1
        assert q.total_bytes <= 4096 + 1024
        evicted = reg.snapshot()["zoo_serving_dlq_evicted_total"]["value"]
        survivors = {rec["uri"] for _s, rec in q.scan()}
        assert len(survivors) == 40 - evicted > 0
        assert "e-39" in survivors and "e-0" not in survivors
        return evicted, sorted(survivors), len(q.segments())
    _both(run, tmp_path)


def test_replay_is_at_most_once_with_fresh_traces(tmp_path):
    """replay() renames the segment .replayed BEFORE re-enqueueing,
    stamps fresh trace ids linked by replay_of, re-stamps ``model``, and
    a second replay is a no-op."""
    def run(pkg, d):
        q = pkg.DLQ(d, registry=pkg.Registry())
        tensors = _spill(q, 4, reason="publish", model="int8")
        q.close()
        backend = pkg.Backend()
        n = q.replay(backend)
        states = {s["state"] for s in q.segments()}
        entries = backend.xread("tensor_stream", 100, block_ms=50)
        for _eid, fields in entries:
            np.testing.assert_array_equal(
                pkg.client.decode_payload(fields), tensors[fields["uri"]])
            assert len(fields["trace"]) == 16
            assert fields["replay_of"] != fields["trace"]
        linked = sorted((f["uri"], f["replay_of"], f["model"])
                        for _e, f in entries)
        again = q.replay(backend)
        return (n, states, q.depth, linked, again,
                backend.xread("tensor_stream", 100, block_ms=50))
    got = _both(run, tmp_path)
    assert got[0] == 4 and got[2] == 0 and got[4] == 0
    assert got[3][0] == ("u-0", f"{0:016x}", "int8")


def test_replay_skips_foreign_open_segment_unless_told(tmp_path):
    """A foreign .open segment (a live writer's) is skipped by default;
    the owner replays its own; include_open seals and replays a crashed
    writer's leftover."""
    def run(pkg, d):
        backend = pkg.Backend()
        q = pkg.DLQ(os.path.join(d, "live"), registry=pkg.Registry())
        _spill(q, 2)
        foreign = pkg.DLQ(os.path.join(d, "live"), registry=pkg.Registry())
        out = [foreign.replay(backend), q.replay(backend)]
        crashed = pkg.DLQ(os.path.join(d, "crashed"),
                          registry=pkg.Registry())
        _spill(crashed, 3, prefix="c")
        after = pkg.DLQ(os.path.join(d, "crashed"),
                        registry=pkg.Registry())
        out += [after.replay(backend),
                after.replay(backend, include_open=True)]
        return out
    assert _both(run, tmp_path) == [0, 2, 0, 3]


def test_purge_receipts_and_all(tmp_path):
    def run(pkg, d):
        q = pkg.DLQ(d, registry=pkg.Registry())
        _spill(q, 3)
        q.close()
        q.replay(pkg.Backend())
        _spill(q, 2, prefix="w")
        q.close()
        return [q.purge(), q.depth, q.purge(replayed_only=False), q.depth]
    assert _both(run, tmp_path) == [1, 2, 1, 0]


def test_purge_all_never_touches_foreign_open_segment(tmp_path):
    """purge(all) from a second handle must not unlink the live writer's
    .open segment."""
    def run(pkg, d):
        owner = pkg.DLQ(d, registry=pkg.Registry())
        _spill(owner, 2, prefix="live")
        cli_view = pkg.DLQ(d, registry=pkg.Registry())
        purged = cli_view.purge(replayed_only=False)
        _spill(owner, 1, prefix="live2")
        owner.close()
        return purged, owner.depth
    assert _both(run, tmp_path) == (0, 3)


def test_uri_filter_retires_whole_segment(tmp_path):
    def run(pkg, d):
        q = pkg.DLQ(d, registry=pkg.Registry())
        _spill(q, 3, prefix="f")
        q.close()
        backend = pkg.Backend()
        return [q.replay(backend, uris=["f-1"]), q.depth, q.replay(backend)]
    assert _both(run, tmp_path) == [1, 0, 0]


def test_replay_rate_pacing_schedule_and_validation(tmp_path):
    """``rate`` follows a fixed schedule (record i due at i/rate after
    the first); a non-positive rate is refused before anything is
    retired."""
    def run(pkg, d):
        q = pkg.DLQ(d, registry=pkg.Registry())
        _spill(q, 5, prefix="r")
        q.close()
        with pytest.raises(ValueError, match="rate"):
            q.replay(pkg.Backend(), rate=0)
        depth = q.depth
        slept = []
        n = q.replay(pkg.Backend(), rate=100.0, sleep=slept.append)
        assert all(0 < s <= (i + 1) / 100.0 + 0.01
                   for i, s in enumerate(slept))
        return depth, n, len(slept)
    assert _both(run, tmp_path) == (5, 5, 4)


def test_paced_replay_stays_under_shed_watermark(tmp_path):
    """Replaying a DLQ bigger than the shed watermark into the port's
    live shedding server, paced, re-triggers no shedding: every replayed
    record serves."""
    from analytics_zoo_tpu_torch.common import context as pctx
    from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import (ClusterServing, InputQueue,
                                                 OutputQueue)
    pctx.reset_zoo_context()
    m = peng.Sequential([Dense(2, activation="softmax", input_shape=(4,))],
                        device="cpu").init_weights()
    im = InferenceModel(device="cpu").from_keras(m)
    reg = pobs.MetricsRegistry()
    backend = LocalBackend()
    q = pdlq.DeadLetterQueue(str(tmp_path), registry=pobs.MetricsRegistry())
    tensors = _spill(q, 12, prefix="p")
    q.close()
    serving = ClusterServing(im, backend=backend, registry=reg,
                             batch_size=4, block_ms=10, shed_watermark=4)
    serving.start()
    try:
        inq, outq = InputQueue(backend), OutputQueue(backend)
        inq.enqueue("warm-0", np.zeros(4, np.float32))
        outq.query("warm-0", timeout=60.0)
        assert q.replay(backend, rate=25.0) == 12
        answered = {uri: outq.query(uri, timeout=30.0) for uri in tensors}
    finally:
        serving.stop(drain=False)
    want = im.predict(np.stack([tensors[u] for u in answered]))
    np.testing.assert_allclose(np.stack(list(answered.values())), want,
                               rtol=1e-6, atol=1e-7)
    snap = reg.snapshot()
    assert snap['zoo_serving_shed_total{reason="depth"}']["value"] == 0
    assert snap["zoo_serving_records_total"]["value"] == 13


@pytest.mark.parametrize("model", [None, "int8"])
@pytest.mark.parametrize("dtype", ["float32", "int32", "float16"])
def test_segment_bytes_match_jax_byte_for_byte(tmp_path, monkeypatch, model,
                                               dtype):
    """With the clock held, the same appends give the same segment name
    and the same bytes in both packages; each line is ``<crc32 hex8>
    <json>`` over the JSON bytes."""
    for mod in (pdlq, jdlq):
        monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.25)
    files = []
    for pkg in (PORT, JAX):
        q = pkg.DLQ(str(tmp_path / pkg.name), registry=pkg.Registry())
        for i in range(3):
            q.append(f"b-{i}", np.arange(6, dtype=dtype).reshape(2, 3) + i,
                     reason=("dispatch", "publish", "other")[i],
                     trace=None if i == 2 else f"{i:016x}",
                     error=f"err {i}", model=model)
        q.close()
        (name,) = os.listdir(tmp_path / pkg.name)
        files.append((name, open(tmp_path / pkg.name / name, "rb").read()))
    assert files[0] == files[1]
    name, data = files[0]
    assert name == "dlq-1700000000250-0001.jsonl"
    for line in data.splitlines():
        crc, payload = line.split(b" ", 1)
        assert int(crc, 16) == zlib.crc32(payload) & 0xFFFFFFFF


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_a_directory_written_by_one_package_replays_through_the_other(
        tmp_path, writer, reader):
    """A DLQ directory spilled by one package is surveyed, scanned and
    replayed by the other: the same records, traces, reasons, errors and
    lanes, re-enqueued with fresh traces linked by ``replay_of``."""
    d = str(tmp_path / "dlq")
    w = writer.DLQ(d, registry=writer.Registry())
    tensors = _spill(w, 3, reason="dispatch", prefix="d", model="bert")
    tensors.update(_spill(w, 2, reason="publish", prefix="p"))
    w.close()
    r = reader.DLQ(d, registry=reader.Registry())
    assert r.depth == 5
    assert [s["state"] for s in r.segments()] == ["sealed"]
    recs = {rec["uri"]: rec for _s, rec in r.scan()}
    assert {u: (rec["trace"], rec["reason"], rec["error"], rec.get("model"))
            for u, rec in recs.items()} == {
        **{f"d-{i}": (f"{i:016x}", "dispatch", "boom", "bert")
           for i in range(3)},
        **{f"p-{i}": (f"{i:016x}", "publish", "boom", None)
           for i in range(2)}}
    for uri, rec in recs.items():
        np.testing.assert_array_equal(_arr(rec), tensors[uri])
    backend = reader.Backend()
    assert r.replay(backend) == 5
    entries = backend.xread("tensor_stream", 100, block_ms=50)
    for _eid, fields in entries:
        np.testing.assert_array_equal(
            reader.client.decode_payload(fields), tensors[fields["uri"]])
        assert fields["replay_of"] == recs[fields["uri"]]["trace"]
        assert fields["replay_of"] != fields["trace"]
        assert fields.get("model") == recs[fields["uri"]].get("model")
    # the writer's own handle sees the replay's receipts
    assert writer.DLQ(d, registry=writer.Registry()).depth == 0


def test_the_serving_modules_import_no_jax():
    """The DLQ, the server and the reliability primitives, each alone in a
    fresh interpreter, leave jax and the JAX package out of
    ``sys.modules``."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib, sys\n"
        "for name in ('analytics_zoo_tpu_torch.serving.dlq',\n"
        "             'analytics_zoo_tpu_torch.serving.server',\n"
        "             'analytics_zoo_tpu_torch.common.reliability'):\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'analytics_zoo_tpu' or "
        "n.startswith('analytics_zoo_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = repo
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
