"""The port's runtime utilities held to the JAX package on the CPU: the
copies of ``utils/{tensorboard,proto,tensor_bundle}.py`` and
``ray/raycontext.py`` through the cases of ``tests/test_tensorboard.py``
and ``tests/test_ray_runtime.py``; the TensorBoard sink; the TensorBoard
hooks of training (``set_tensorboard``, ``get_train_summary``,
``get_validation_summary``, ``set_profile``) and of serving
(``ClusterServing.set_tensorboard``), their event files read back by the
JAX reader and holding what the JAX fit writes; and ``utils/profiling.py``
with the ``zoo_train_mfu`` gauge.

The module imports no jax at the top: the ray cases' task functions live
here, and the runtime's ``spawn``ed workers import this module to find
them. Each JAX comparison imports the JAX package inside its test.
"""

import glob
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from analytics_zoo_tpu_torch.ray import ObjectRef, RayContext, RayTaskError
from analytics_zoo_tpu_torch.utils.tensorboard import (EventFileWriter,
                                                       TrainSummary,
                                                       read_histograms,
                                                       read_scalars)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dense_net(in_dim=8, hidden=16, classes=2, names=(None, None)):
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    return Sequential([
        Dense(hidden, input_shape=(in_dim,), activation="relu",
              name=names[0]),
        Dense(classes, activation="softmax", name=names[1])],
        device="cpu").init_weights()


@pytest.fixture
def port_context():
    from analytics_zoo_tpu_torch.common import context as pctx
    from analytics_zoo_tpu_torch.observability import reset_default_registry
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import reset_uids
    pctx.reset_zoo_context()
    reset_default_registry()
    reset_uids()
    yield pctx
    pctx.reset_zoo_context()


# ---------------------------------------------------------------------------
# tests/test_tensorboard.py's cases
# ---------------------------------------------------------------------------

def test_writer_roundtrip_own_reader(tmp_path):
    w = EventFileWriter(str(tmp_path))
    w.add_scalar("Loss", 1.5, 1, wall_time=100.0)
    w.add_scalar("Loss", 0.75, 2, wall_time=101.0)
    w.add_scalar("Throughput", 1e4, 2, wall_time=101.5)
    w.close()
    pts = read_scalars(str(tmp_path), "Loss")
    assert [(s, round(v, 4)) for s, v, _, _ in pts] == [(1, 1.5), (2, 0.75)]
    thr = read_scalars(str(tmp_path), "Throughput")
    assert len(thr) == 1 and abs(thr[0][1] - 1e4) < 1


def test_writer_files_readable_by_tensorboard(tmp_path):
    ea_mod = pytest.importorskip(
        "tensorboard.backend.event_processing.event_accumulator")
    w = EventFileWriter(str(tmp_path))
    for i, v in enumerate([3.0, 2.0, 1.0]):
        w.add_scalar("Loss", v, i + 1, wall_time=50.0 + i)
    w.close()
    acc = ea_mod.EventAccumulator(str(tmp_path))
    acc.Reload()
    assert "Loss" in acc.Tags()["scalars"]
    events = acc.Scalars("Loss")
    assert [e.step for e in events] == [1, 2, 3]
    np.testing.assert_allclose([e.value for e in events], [3.0, 2.0, 1.0])


def test_reader_parses_torch_written_files(tmp_path):
    tb = pytest.importorskip("torch.utils.tensorboard")
    w = tb.SummaryWriter(log_dir=str(tmp_path))
    w.add_scalar("acc", 0.25, 7)
    w.add_scalar("acc", 0.5, 8)
    w.close()
    pts = read_scalars(str(tmp_path), "acc")
    assert [(s, round(v, 4)) for s, v, _, _ in pts] == [(7, 0.25), (8, 0.5)]


def test_corrupt_record_detected(tmp_path):
    w = EventFileWriter(str(tmp_path))
    w.add_scalar("Loss", 1.0, 1)
    w.close()
    with open(w.path, "r+b") as f:
        f.seek(-3, 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(IOError):
        read_scalars(str(tmp_path))


def test_resolve_lr_matches_actual_schedule():
    from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers
    sched = optimizers.resolve_lr("sgd", lr=0.1, decay=0.01)
    assert callable(sched)
    np.testing.assert_allclose(sched(10), 0.1 / (1 + 0.01 * 10))
    assert optimizers.resolve_lr("adam") == 0.001
    assert optimizers.resolve_lr(optimizers.get_optimizer("sgd")) is None


def test_fit_writes_summaries_and_reads_back(tmp_path, port_context):
    port_context.init_zoo_context()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 8)).astype(np.float32)
    yc = (x.sum(axis=1) > 0).astype(np.int32)
    m = _dense_net()
    m.compile(optimizer="adam", loss="scce", metrics=["accuracy"], lr=0.01)
    assert m.set_tensorboard(str(tmp_path), "app") is m
    m.fit(x, yc, batch_size=32, nb_epoch=3, validation_data=(x, yc))
    loss = m.get_train_summary("Loss")
    steps = 256 // 32
    assert loss.shape == (3 * steps, 3)
    assert list(loss[:, 0]) == list(range(1, 3 * steps + 1))
    assert loss[-steps:, 1].mean() < loss[:steps, 1].mean()
    thr = m.get_train_summary("Throughput")
    assert thr.shape[0] == 3 and (thr[:, 1] > 0).all()
    lr = m.get_train_summary("LearningRate")
    assert lr.shape[0] == 3 and np.allclose(lr[:, 1], 0.01)
    vacc = m.get_validation_summary("accuracy")
    assert vacc.shape[0] == 3
    assert (vacc[:, 1] >= 0).all() and (vacc[:, 1] <= 1).all()
    assert (tmp_path / "app" / "train").is_dir()
    assert (tmp_path / "app" / "validation").is_dir()


def test_set_profile_captures_trace(tmp_path, port_context):
    """``set_profile(dir)`` traces the next fit (one-shot) with
    ``torch.profiler`` into a trace TensorBoard's profile plugin reads."""
    port_context.init_zoo_context()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int32)
    m = _dense_net(4, 8)
    m.compile(optimizer="adam", loss="scce")
    assert m.set_profile(str(tmp_path / "prof")) is m
    m.fit(x, y, batch_size=16, nb_epoch=1)
    traces = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert traces, "no profiler trace written"
    assert m._profile_dir is None
    m.fit(x, y, batch_size=16, nb_epoch=1)
    assert glob.glob(str(tmp_path / "prof" / "*.pt.trace.json")) == traces


def test_histogram_roundtrip_own_reader(tmp_path):
    w = EventFileWriter(str(tmp_path))
    rng = np.random.default_rng(0)
    vals = rng.normal(2.0, 3.0, 1000)
    w.add_histogram("weights/W", vals, step=7)
    w.add_histogram("weights/W", vals * 2, step=8)
    w.close()
    pts = read_histograms(str(tmp_path), "weights/W")
    assert [p[0] for p in pts] == [7, 8]
    st = pts[0][1]
    assert st["num"] == 1000
    np.testing.assert_allclose(st["min"], vals.min())
    np.testing.assert_allclose(st["max"], vals.max())
    np.testing.assert_allclose(st["sum"], vals.sum())
    np.testing.assert_allclose(st["sum_squares"], (vals * vals).sum())
    assert len(st["bucket"]) == len(st["bucket_limit"]) == 30
    assert sum(st["bucket"]) == 1000
    w2 = EventFileWriter(str(tmp_path / "c"))
    w2.add_histogram("b", np.full(5, 3.5), step=1)
    w2.close()
    st2 = read_histograms(str(tmp_path / "c"), "b")[0][1]
    assert st2["bucket"] == [5.0] and st2["bucket_limit"] == [3.5]


def test_histograms_readable_by_tensorboard(tmp_path):
    tbe = pytest.importorskip("tensorboard.backend.event_processing"
                              ".event_accumulator")
    w = EventFileWriter(str(tmp_path))
    w.add_histogram("h", np.arange(100, dtype=np.float64), step=3)
    w.close()
    acc = tbe.EventAccumulator(str(tmp_path),
                               size_guidance={tbe.HISTOGRAMS: 0})
    acc.Reload()
    hists = acc.Histograms("h")
    assert len(hists) == 1 and hists[0].step == 3
    assert hists[0].histogram_value.num == 100


def test_fit_writes_parameter_histograms(tmp_path, port_context):
    """``parameters_every_epochs=1``: per-layer weight histograms under the
    JAX tree's tags, one an epoch; under fused-epoch dispatch at each
    block's end."""
    port_context.init_zoo_context()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int32)
    m = _dense_net(4, 8, names=("d1", "d2"))
    m.compile(optimizer="adam", loss="scce")
    m.set_tensorboard(str(tmp_path), "app", parameters_every_epochs=1)
    m.fit(x, y, batch_size=16, nb_epoch=2)
    pts = read_histograms(str(tmp_path / "app" / "train"))
    tags = {t for _, _, _, t in pts}
    assert tags == {"Parameters/d1/W", "Parameters/d1/b",
                    "Parameters/d2/W", "Parameters/d2/b"}
    w_pts = [p for p in pts if p[3] == "Parameters/d1/W"]
    assert len(w_pts) == 2 and w_pts[0][1]["num"] == 4 * 8

    port_context.reset_zoo_context()
    port_context.init_zoo_context(conf={"zoo.train.fuse_epochs": 3,
                                        "zoo.train.device_cache": True})
    m2 = _dense_net(4, 8, names=("d1", "d2"))
    m2.compile(optimizer="adam", loss="scce")
    m2.set_tensorboard(str(tmp_path / "fused"), "app",
                       parameters_every_epochs=1)
    m2.fit(x, y, batch_size=16, nb_epoch=3)
    pts2 = read_histograms(str(tmp_path / "fused" / "app" / "train"))
    assert {p[0] for p in pts2} == {12}     # the block's last iteration
    assert len(m2.get_train_summary("Loss")) == 12


def test_histogram_nonfinite_weights_do_not_crash(tmp_path):
    w = EventFileWriter(str(tmp_path))
    w.add_histogram("n", np.array([1.0, np.nan, 2.0, np.inf]), step=1)
    w.add_histogram("all_bad", np.array([np.nan, np.inf]), step=1)
    w.close()
    st = read_histograms(str(tmp_path), "n")[0][1]
    assert st["num"] == 2 and st["min"] == 1.0 and st["max"] == 2.0
    st2 = read_histograms(str(tmp_path), "all_bad")[0][1]
    assert st2["num"] == 1 and sum(st2["bucket"]) == 1


def test_set_summary_trigger_accepts_trigger_objects(tmp_path):
    from analytics_zoo_tpu_torch.common.triggers import EveryEpoch
    ts = TrainSummary(str(tmp_path), "app")
    try:
        assert ts.set_summary_trigger("Parameters", 2) is ts
        assert ts.parameters_every_epochs == 2
        assert ts.parameters_trigger is None
        trig = EveryEpoch()
        ts.set_summary_trigger("Parameters", trig)
        assert ts.parameters_trigger is trig
        assert ts.parameters_every_epochs is None
        assert ts.set_summary_trigger("LearningRate", EveryEpoch()) is ts
        assert ts.set_summary_trigger("Loss", 3) is ts
        with pytest.raises(TypeError):
            ts.set_summary_trigger("Loss", "weekly")
        with pytest.raises(TypeError):
            ts.set_summary_trigger("Throughput", EveryEpoch)
        with pytest.raises(ValueError):
            ts.set_summary_trigger("LearningRate", 0)
        assert ts.set_summary_trigger("Parameters", every_epochs=4) is ts
        assert ts.parameters_every_epochs == 4
        assert ts.parameters_trigger is None
        with pytest.raises(ValueError):
            ts.set_summary_trigger("NoSuchFamily", 1)
        with pytest.raises(ValueError):
            ts.set_summary_trigger("Parameters", 0)
        with pytest.raises(TypeError):
            ts.set_summary_trigger("Parameters", "weekly")
        with pytest.raises(TypeError):
            ts.set_summary_trigger("Parameters", 1, every_epochs=2)
        with pytest.raises(TypeError):
            ts.set_summary_trigger("Parameters")
    finally:
        ts.close()


def _write_hists(ts, params, epochs, iteration, n_steps=0):
    from analytics_zoo_tpu_torch.pipeline.api.keras.training import \
        _write_param_histograms
    _write_param_histograms(ts, params, epochs, iteration, n_steps=n_steps)


def test_parameter_histograms_honor_trigger_object(tmp_path):
    from analytics_zoo_tpu_torch.common.triggers import SeveralIteration
    ts = TrainSummary(str(tmp_path), "app")
    params = {"d1": {"W": np.ones((4, 8), np.float32)}}
    ts.set_summary_trigger("Parameters", SeveralIteration(10))
    _write_hists(ts, params, (1,), 5)
    _write_hists(ts, params, (2,), 10)
    ts.close()
    pts = read_histograms(str(tmp_path / "app" / "train"))
    assert len(pts) == 1 and pts[0][3] == "Parameters/d1/W"


def test_fused_block_trigger_sees_per_epoch_iterations(tmp_path):
    from analytics_zoo_tpu_torch.common.triggers import SeveralIteration
    params = {"d1": {"W": np.ones((4, 8), np.float32)}}
    ts = TrainSummary(str(tmp_path), "app")
    ts.set_summary_trigger("Parameters", SeveralIteration(10))
    _write_hists(ts, params, (1, 2, 3), 15, n_steps=5)
    ts.close()
    assert len(read_histograms(str(tmp_path / "app" / "train"))) == 1
    ts2 = TrainSummary(str(tmp_path / "b2"), "app")
    ts2.set_summary_trigger("Parameters", SeveralIteration(100))
    _write_hists(ts2, params, (1, 2, 3), 15, n_steps=5)
    ts2.close()
    assert not read_histograms(str(tmp_path / "b2" / "app" / "train"))


def test_trigger_fire_landing_mid_epoch_is_not_dropped(tmp_path):
    from analytics_zoo_tpu_torch.common.triggers import SeveralIteration
    params = {"d1": {"W": np.ones((4, 8), np.float32)}}
    ts = TrainSummary(str(tmp_path), "app")
    ts.set_summary_trigger("Parameters", SeveralIteration(7))
    _write_hists(ts, params, (1,), 5, n_steps=5)
    _write_hists(ts, params, (2,), 10, n_steps=5)
    _write_hists(ts, params, (3,), 15, n_steps=5)
    ts.close()
    steps = sorted(s for s, _, _, _ in
                   read_histograms(str(tmp_path / "app" / "train")))
    assert steps == [10, 15], steps


def test_set_summary_trigger_numeric_coercion(tmp_path):
    ts = TrainSummary(str(tmp_path), "app")
    try:
        ts.set_summary_trigger("Parameters", np.int64(2))
        assert ts.parameters_every_epochs == 2
        ts.set_summary_trigger("Parameters", 3.0)
        assert ts.parameters_every_epochs == 3
        with pytest.raises(TypeError):
            ts.set_summary_trigger("Parameters", True)
    finally:
        ts.close()


# ---------------------------------------------------------------------------
# the copies against the JAX modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", ["proto", "tensor_bundle", "tensorboard"])
def test_copies_keep_the_jax_code(module):
    """Each copy is the JAX module's code: the same public names, and the
    same source once the docstrings are set aside."""
    import ast
    import importlib

    def code(path):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if (isinstance(body, list) and body
                    and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
        return ast.dump(tree)

    mine = importlib.import_module(f"analytics_zoo_tpu_torch.utils.{module}")
    theirs = importlib.import_module(f"analytics_zoo_tpu.utils.{module}")
    assert mine.__all__ == theirs.__all__ if hasattr(theirs, "__all__") \
        else True
    assert code(mine.__file__) == code(theirs.__file__)


def test_event_files_match_the_jax_writer_byte_for_byte(tmp_path):
    from analytics_zoo_tpu.utils import tensorboard as jtb
    files = []
    for mod, sub in ((jtb, "jax"), (sys.modules[EventFileWriter.__module__],
                                    "port")):
        w = mod.EventFileWriter(str(tmp_path / sub))
        w.add_scalar("Loss", 0.5, 3, wall_time=10.0)
        w.add_histogram("h", np.linspace(-1, 2, 50), step=4, wall_time=11.0)
        w.close()
        # past the first record, the file version stamped with the time
        # the writer opened
        files.append(list(mod._read_records(w.path))[1:])
    assert len(files[0]) == 2 and files[0] == files[1]


def test_proto_and_tensor_bundle_read_what_jax_reads(tmp_path):
    """The wire codec round-trips the JAX encoder's bytes, and a
    TensorFlow checkpoint (written by TensorFlow where it is installed)
    reads the same in both copies."""
    from analytics_zoo_tpu.utils import proto as jproto
    from analytics_zoo_tpu_torch.utils import proto, tensor_bundle
    blob = (jproto.field_varint(1, 300) + jproto.field_bytes(2, b"xyz")
            + jproto.field_double(3, 2.5) + jproto.field_float(4, -1.0))
    assert blob == (proto.field_varint(1, 300) + proto.field_bytes(2, b"xyz")
                    + proto.field_double(3, 2.5) + proto.field_float(4, -1.0))
    assert list(proto.parse_fields(blob)) == list(jproto.parse_fields(blob))
    tf = pytest.importorskip("tensorflow")
    from analytics_zoo_tpu.utils import tensor_bundle as jbundle
    want = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "step": np.array(7, np.int64),
            "b": np.linspace(-1, 1, 5).astype(np.float64)}
    prefix = str(tmp_path / "ckpt")
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=sorted(want),
                      shape_and_slices=[""] * len(want),
                      tensors=[want[k] for k in sorted(want)])
    mine, theirs = (mod.read_tensor_bundle(prefix)
                    for mod in (tensor_bundle, jbundle))
    assert sorted(mine) == sorted(theirs) == sorted(want)
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])
        np.testing.assert_array_equal(mine[k], want[k])


def test_fit_summaries_match_the_jax_fit(tmp_path, port_context):
    """The same Dense fit in both packages from the same weights and
    batches: the same tags, iterations and learning rates, the step
    losses within 1e-5, and the same histogram tags."""
    import jax

    from analytics_zoo_tpu.common.context import (init_zoo_context,
                                                  reset_zoo_context)
    from analytics_zoo_tpu.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu.pipeline.api.keras.engine import \
        reset_uids as jreset
    port_context.init_zoo_context()
    reset_zoo_context()
    init_zoo_context()
    jreset()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int32)
    jm = Sequential([Dense(16, input_shape=(8,), activation="relu",
                           name="d1"),
                     Dense(2, activation="softmax", name="d2")])
    jm.init_weights(sample_input=x[:8])
    pm = _dense_net(names=("d1", "d2"))
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
    for m, sub in ((jm, "jax"), (pm, "port")):
        m.compile(optimizer="sgd", loss="scce", lr=0.1, decay=0.01)
        m.set_tensorboard(str(tmp_path / sub), "app",
                          parameters_every_epochs=1)
        m.fit(x, y, batch_size=16, nb_epoch=2, shuffle=False,
              validation_data=(x, y))
    for tag in ("Loss", "LearningRate"):
        got, want = pm.get_train_summary(tag), jm.get_train_summary(tag)
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(pm.get_train_summary("Throughput")[:, 0],
                                  jm.get_train_summary("Throughput")[:, 0])
    np.testing.assert_array_equal(pm.get_validation_summary("loss")[:, 0],
                                  jm.get_validation_summary("loss")[:, 0])
    tags = [{(s, t) for s, _, _, t in read_histograms(
        str(tmp_path / sub / "app" / "train"))} for sub in ("jax", "port")]
    assert tags[0] == tags[1]
    reset_zoo_context()


def test_tensorboard_sink_exports_the_registry(tmp_path):
    """Counters and gauges as scalars, histograms as count/sum/mean,
    summaries as count/sum and quantiles, labels in the tag — the JAX
    sink's tags and values for the same registry."""
    from analytics_zoo_tpu.observability import MetricsRegistry as JReg
    from analytics_zoo_tpu.observability import TensorBoardSink as JSink
    from analytics_zoo_tpu_torch.observability import (MetricsRegistry,
                                                       TensorBoardSink)
    out = []
    for reg_cls, sink_cls, sub in ((MetricsRegistry, TensorBoardSink,
                                    "port"), (JReg, JSink, "jax")):
        reg = reg_cls()
        reg.counter("zoo_c_total", "c").inc(3)
        reg.gauge("zoo_g", "g", labels={"lane": "a"}).set(2.5)
        h = reg.histogram("zoo_h", "h")
        for v in (0.1, 0.2, 0.3):
            h.observe(v)
        s = reg.summary("zoo_s_quantiles_seconds", "s")
        for v in range(1, 101):
            s.observe(float(v))
        sink = sink_cls(str(tmp_path / sub))
        sink.export(reg, step=5)
        sink.close()
        out.append(sorted((t, s_, round(v, 5)) for s_, v, _, t in
                          read_scalars(str(tmp_path / sub))))
    assert out[0] == out[1]
    tags = {t for t, _, _ in out[0]}
    assert {"zoo_c_total", "zoo_g/a", "zoo_h_count", "zoo_h_mean",
            "zoo_s_quantiles_seconds_p50"} <= tags


def test_serving_writes_tensorboard_scalars(tmp_path, port_context):
    """``ClusterServing.set_tensorboard``: per-batch "Serving Throughput"
    and "Serving Records" (JAX ``test_serving_tensorboard``)."""
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import (ClusterServing, InputQueue,
                                                 LocalBackend, OutputQueue)
    port_context.init_zoo_context()
    im = InferenceModel(device="cpu").from_keras(_dense_net(6, 8))
    backend = LocalBackend()
    serving = (ClusterServing(im, backend=backend, batch_size=4)
               .set_tensorboard(str(tmp_path), "app").start())
    try:
        inq, outq = InputQueue(backend), OutputQueue(backend)
        rng = np.random.default_rng(2)
        for i in range(12):
            inq.enqueue(f"s-{i}", rng.normal(size=(6,)).astype(np.float32))
        for i in range(12):
            assert outq.query(f"s-{i}", timeout=30.0) is not None
    finally:
        serving.stop()
    pts = read_scalars(str(tmp_path / "app"), "Serving Throughput")
    assert len(pts) >= 1 and all(v > 0 for _, v, _, _ in pts)
    recs = read_scalars(str(tmp_path / "app"), "Serving Records")
    assert max(v for _, v, _, _ in recs) == 12


def test_serving_set_tensorboard_after_start_raises(tmp_path, port_context):
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import ClusterServing, LocalBackend
    port_context.init_zoo_context()
    im = InferenceModel(device="cpu").from_keras(_dense_net(6, 8))
    serving = ClusterServing(im, backend=LocalBackend(), batch_size=4)
    serving.start()
    try:
        with pytest.raises(RuntimeError, match="already started"):
            serving.set_tensorboard(str(tmp_path), "app")
    finally:
        serving.stop()
    serving.set_tensorboard(str(tmp_path), "app")   # fine once stopped
    serving._close_sinks()


def test_profiling_peaks_flops_and_mfu(monkeypatch):
    """No peak on the CPU; the H100's published peaks by its name; one
    Dense step's FLOPs as ``FlopCounterMode`` counts them (forward 2 M K
    N, backward twice that); MFU against the peak."""
    import torch

    from analytics_zoo_tpu_torch.utils import profiling
    assert profiling.device_peak_flops("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert profiling.device_peak_flops(dtype=torch.bfloat16) == 989e12
    assert profiling.device_peak_flops(dtype="int8") == 1979e12
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    assert profiling.device_peak_flops(dtype=torch.float32) == 67e12
    assert profiling.mfu(989e12 / 4) == 0.25
    a = torch.randn(32, 64, requires_grad=True)
    w = torch.randn(64, 16, requires_grad=True)
    assert profiling.compiled_flops(
        lambda: (a @ w).sum().backward()) == 3 * 2 * 32 * 64 * 16
    assert profiling.compiled_flops(lambda: a + 1) is None
    t = profiling.Timer()
    with t.lap("x"):
        pass
    with t.lap("x"):
        pass
    assert set(t.laps) == {"x"} and t.laps["x"] >= 0


def test_fit_sets_the_mfu_gauge_when_flops_are_on(monkeypatch,
                                                   port_context):
    """``zoo.metrics.flops``: the fit counts one step's FLOPs once, before
    its timed window, and sets ``zoo_train_mfu`` where the card's peak is
    known; off, nothing is counted."""
    from analytics_zoo_tpu_torch.observability import default_registry
    from analytics_zoo_tpu_torch.utils import profiling
    rng = np.random.default_rng(4)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int32)
    port_context.init_zoo_context()
    m = _dense_net()
    m.compile(optimizer="adam", loss="scce")
    m.fit(x, y, batch_size=16, nb_epoch=1)
    assert m._loop._flops_per_example is None
    port_context.reset_zoo_context()
    port_context.init_zoo_context(conf={"zoo.metrics.flops": True})
    monkeypatch.setattr(profiling, "device_peak_flops",
                        lambda *a, **k: 1e12)
    m.fit(x, y, batch_size=16, nb_epoch=2)
    # a row: Dense(8->16) forward and its weight gradient (the input
    # needs none), Dense(16->2) forward and both its gradients
    assert m._loop._flops_per_example == 2 * (2 * 8 * 16 + 3 * 16 * 2)
    snap = default_registry().snapshot()
    mfu = [v["value"] for k, v in snap.items()
           if k.startswith("zoo_train_mfu")]
    assert mfu and 0 < mfu[0] < 1


# ---------------------------------------------------------------------------
# tests/test_ray_runtime.py's cases (task functions here: the spawned
# workers import this module by name)
# ---------------------------------------------------------------------------

def _square(x):
    return x * x


def _boom():
    raise ValueError("intentional")


class Counter:
    def __init__(self, start=0):
        self.v = start

    def add(self, k):
        self.v += k
        return self.v

    def value(self):
        return self.v


class BadActor:
    def __init__(self):
        raise RuntimeError("no")


class _BoomInit:
    def __init__(self):
        raise RuntimeError("boom at init")


class _Counter2:
    def __init__(self):
        self.n = 0

    def bump(self):
        self.n += 1
        return self.n


class _ExitInit:
    def __init__(self):
        os._exit(7)


@pytest.fixture
def ctx():
    c = RayContext(num_workers=2).init()
    yield c
    c.stop()


def test_remote_tasks_parallel_map(ctx):
    refs = [ctx.remote(_square, i) for i in range(20)]
    assert all(isinstance(r, ObjectRef) for r in refs)
    assert ctx.get(refs) == [i * i for i in range(20)]
    a, b = ctx.remote(_square, 7), ctx.remote(_square, 8)
    assert ctx.get(b) == 64 and ctx.get(a) == 49


def test_task_error_propagates(ctx):
    with pytest.raises(RayTaskError, match="intentional"):
        ctx.get(ctx.remote(_boom))
    assert ctx.get(ctx.remote(_square, 3)) == 9


def test_actor_keeps_state(ctx):
    c = ctx.actor(Counter, 10)
    refs = [c.add.remote(1) for _ in range(5)]
    assert ctx.get(refs) == [11, 12, 13, 14, 15]
    assert ctx.get(c.value.remote()) == 15


def test_actor_construction_failure_is_loud(ctx):
    with pytest.raises(RayTaskError, match="construction failed"):
        ctx.actor(BadActor)


def test_uninitialized_context_raises():
    c = RayContext(2)
    with pytest.raises(RuntimeError, match="init"):
        c.remote(_square, 1)


def test_workers_die_with_parent():
    script = textwrap.dedent("""
        import sys, time
        sys.path.insert(0, %r)
        from analytics_zoo_tpu_torch.ray import RayContext
        ctx = RayContext(2).init()
        print(" ".join(str(p.pid) for p in ctx._procs), flush=True)
        time.sleep(60)
    """) % (REPO,)
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, text=True)
    pids = [int(p) for p in proc.stdout.readline().split()]
    assert pids
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait()
    deadline = time.time() + 10
    while time.time() < deadline:
        alive = []
        for p in pids:
            try:
                os.kill(p, 0)
                alive.append(p)
            except OSError:
                pass
        if not alive:
            break
        time.sleep(0.3)
    assert not alive, f"orphaned workers survived driver kill: {alive}"


def test_get_twice_returns_cached_result(ctx):
    ref = ctx.remote(_square, 6)
    assert ctx.get(ref) == 36
    assert ctx.get(ref) == 36


def test_unpicklable_task_fails_at_submission(ctx):
    with pytest.raises(RayTaskError, match="picklable"):
        ctx.remote(lambda: 1)


def test_crashed_worker_raises_instead_of_hanging(ctx):
    ref = ctx.remote(os._exit, 0)
    with pytest.raises(RayTaskError, match="died"):
        ctx.get(ref)


def test_timeout_raises_timeout_error_and_is_global(ctx):
    refs = [ctx.remote(time.sleep, 5) for _ in range(4)]
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        ctx.get(refs, timeout=0.5)
    assert time.monotonic() - t0 < 2.0


def test_numpy_payloads(ctx):
    a = np.arange(6).reshape(2, 3)
    ref = ctx.remote(np.dot, a, a.T)
    np.testing.assert_array_equal(ctx.get(ref), a @ a.T)


def test_second_actor_init_failure_not_masked():
    c = RayContext(num_workers=1).init()
    try:
        ok = c.actor(_Counter2)
        assert c.get(ok.bump.remote()) == 1
        with pytest.raises(RayTaskError, match="boom at init"):
            c.actor(_BoomInit)
        assert c.get(ok.bump.remote()) == 2
    finally:
        c.stop()


def test_actor_dying_without_ack_raises_not_hangs():
    c = RayContext(num_workers=1).init()
    try:
        t0 = time.monotonic()
        with pytest.raises(RayTaskError, match="died"):
            c.actor(_ExitInit)
        assert time.monotonic() - t0 < 30
    finally:
        c.stop()


def test_runtime_modules_import_no_jax():
    """Importing the runtime modules, starting a ``RayContext`` and writing
    a summary leaves jax and the JAX package out of ``sys.modules``."""
    code = (
        "import sys\n"
        "import analytics_zoo_tpu_torch.utils.profiling\n"
        "import analytics_zoo_tpu_torch.utils.tensor_bundle\n"
        "from analytics_zoo_tpu_torch.observability import TensorBoardSink\n"
        "from analytics_zoo_tpu_torch.ray import RayContext\n"
        "import tempfile\n"
        "TensorBoardSink(tempfile.mkdtemp()).export()\n"
        "c = RayContext(1).init(); assert c.get(c.remote(abs, -2)) == 2\n"
        "c.stop()\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'analytics_zoo_tpu' or "
        "n.startswith('analytics_zoo_tpu.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
