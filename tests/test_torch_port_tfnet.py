"""The port's TFNet (frozen GraphDef import) against the JAX package's.

The same hand-encoded ``.pb`` files (the GraphDef encoder of
``tests/test_tfnet.py``) and the same seeded numpy inputs go through
``analytics_zoo_tpu.pipeline.api.tfnet`` and
``analytics_zoo_tpu_torch.pipeline.api.tfnet``; outputs are held at the
JAX tests' tolerances, fine-tuned parameters after the same batches, and
every refusal by its exception type.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.models.common import zoo_model as jzoo
from analytics_zoo_tpu.pipeline.api import tfnet as jtf
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.net import Net as JNet
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.models.common import zoo_model as pzoo
from analytics_zoo_tpu_torch.pipeline.api import tfnet as ptf
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras import Input as PInput
from analytics_zoo_tpu_torch.pipeline.api.keras import Model as PModel
from analytics_zoo_tpu_torch.pipeline.api.keras import \
    Sequential as PSequential
from analytics_zoo_tpu_torch.pipeline.api.keras.training import _param_tree
from analytics_zoo_tpu_torch.pipeline.api.net import Net as PNet
from analytics_zoo_tpu_torch.utils.proto import (field_bytes, field_varint,
                                                 varint)
from test_tfnet import (_shape_proto, _tensor_proto_typed, attr_b, attr_f,
                        attr_i, attr_ints, attr_s, const, node, write_graph)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def port_context():
    pctx.reset_zoo_context()
    yield
    pctx.reset_zoo_context()


def _np(t):
    return t.detach().numpy()


def _run_both(pb, x, **kw):
    """(port output, JAX output, port net, JAX net) of the graph at ``pb``
    on ``x`` (an array or a list of arrays)."""
    jnet = jtf.load_tf(pb, **kw)
    pnet = ptf.load_tf(pb, device="cpu", **kw)
    want = jnet.call(jnet.build(None), x)
    xs = [torch.from_numpy(np.asarray(a)) for a in
          (x if isinstance(x, list) else [x])]
    got = pnet(xs if isinstance(x, list) else xs[0])
    return got, want, pnet, jnet


def _mlp_graph(path, tm):
    return write_graph(
        path,
        node("input", "Placeholder"),
        const("w1", _np(tm[0].weight).T),
        const("b1", _np(tm[0].bias)),
        const("w2", _np(tm[2].weight).T),
        const("b2", _np(tm[2].bias)),
        node("mm1", "MatMul", ("input", "w1")),
        node("h1", "BiasAdd", ("mm1", "b1")),
        node("r1", "Relu", ("h1",)),
        node("mm2", "MatMul", ("r1", "w2")),
        node("h2", "BiasAdd", ("mm2", "b2")),
        node("probs", "Softmax", ("h2",)),
    )


def test_mlp_matches_jax(tmp_path):
    torch.manual_seed(0)
    tm = nn.Sequential(nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 4))
    x = np.random.default_rng(0).normal(size=(5, 6)).astype(np.float32)
    pb = _mlp_graph(tmp_path / "mlp.pb", tm)
    pnet, jnet = PNet.load_tf(pb, device="cpu"), JNet.load_tf(pb)
    assert pnet.feed_names == jnet.feed_names == ["input"]
    assert pnet.output_names == jnet.output_names == ["probs"]
    got = pnet(torch.from_numpy(x))
    want = jnet.call(jnet.build(None), x)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-4,
                               atol=2e-5)
    assert sorted(peng.tree_key(pnet, n)[0]
                  for n, _ in pnet.named_parameters()) == \
        sorted(jnet.build(None)) == ["b1", "b2", "w1", "w2"]


def test_cnn_matches_jax(tmp_path):
    torch.manual_seed(1)
    conv = nn.Conv2d(3, 8, 3, stride=1, padding=1)
    fc = nn.Linear(8, 5)
    x = np.random.default_rng(1).normal(size=(2, 9, 9, 3)).astype(np.float32)
    pb = write_graph(
        tmp_path / "cnn.pb",
        node("input", "Placeholder"),
        const("k", _np(conv.weight).transpose(2, 3, 1, 0)),
        const("kb", _np(conv.bias)),
        const("axes", np.asarray([1, 2], np.int32)),
        const("fw", _np(fc.weight).T),
        const("fb", _np(fc.bias)),
        node("c1", "Conv2D", ("input", "k"),
             attr_ints("strides", [1, 1, 1, 1]), attr_s("padding", "SAME"),
             attr_s("data_format", "NHWC")),
        node("cb", "BiasAdd", ("c1", "kb")),
        node("r", "Relu", ("cb",)),
        node("p", "MaxPool", ("r",),
             attr_ints("ksize", [1, 2, 2, 1]),
             attr_ints("strides", [1, 2, 2, 1]), attr_s("padding", "VALID")),
        node("gap", "Mean", ("p", "axes")),
        node("mm", "MatMul", ("gap", "fw")),
        node("out", "BiasAdd", ("mm", "fb")),
    )
    got, want, _, _ = _run_both(pb, x)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=5e-4,
                               atol=5e-4)


def test_fused_batchnorm_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 5, 4)).astype(np.float32)
    stats = [rng.uniform(0.5, 1.5, 4), rng.uniform(-0.5, 0.5, 4),
             rng.uniform(-1, 1, 4), rng.uniform(0.5, 2.0, 4)]
    pb = write_graph(
        tmp_path / "bn.pb",
        node("input", "Placeholder"),
        *(const(n, s.astype(np.float32)) for n, s in
          zip(("scale", "offset", "mean", "var"), stats)),
        node("y", "FusedBatchNormV3",
             ("input", "scale", "offset", "mean", "var"),
             attr_f("epsilon", 1e-5), attr_b("is_training", False)),
    )
    got, want, pnet, jnet = _run_both(pb, x)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    # the moving statistics are frozen on both sides; scale/offset train
    assert sorted(jnet.build(None)) == ["offset", "scale"]
    assert sorted(pnet._tree_keys.values()) == ["offset", "scale"]


def test_shape_ops_and_structural_consts_match_jax(tmp_path):
    x = np.arange(24, dtype=np.float32).reshape(2, 12)
    pb = write_graph(
        tmp_path / "shapes.pb",
        node("input", "Placeholder"),
        const("shp", np.asarray([2, 3, 4], np.int32)),
        const("perm", np.asarray([0, 2, 1], np.int32)),
        const("b0", np.asarray([0, 0, 0], np.int32)),
        const("e0", np.asarray([2, 2, 3], np.int32)),
        const("s0", np.asarray([1, 1, 1], np.int32)),
        const("cax", np.asarray(2, np.int32)),
        node("r", "Reshape", ("input", "shp")),
        node("t", "Transpose", ("r", "perm")),
        node("sl", "StridedSlice", ("t", "b0", "e0", "s0"),
             attr_i("begin_mask", 0), attr_i("end_mask", 0),
             attr_i("shrink_axis_mask", 0)),
        node("c", "ConcatV2", ("sl", "sl", "cax")),
    )
    got, want, pnet, _ = _run_both(pb, x)
    assert list(pnet.parameters()) == []
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_finetune_matches_jax(tmp_path):
    """The same 8 epochs of Adam on the same shuffled batches (zoo.seed +
    epoch): the JAX fit's losses and moved weight, from the weights the
    JAX network holds at the start (moved across by load_jax_params)."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(6, 4)).astype(np.float32) * 0.1
    pb = write_graph(
        tmp_path / "lin.pb",
        node("input", "Placeholder"),
        const("w", w),
        node("mm", "MatMul", ("input", "w")),
        node("probs", "Softmax", ("mm",)),
    )
    x = rng.normal(size=(256, 6)).astype(np.float32)
    y = np.argmax(x @ rng.normal(size=(6, 4)).astype(np.float32), 1) \
        .astype(np.int32)
    jctx.init_zoo_context(conf={"zoo.seed": 0})
    pctx.init_zoo_context(conf={"zoo.seed": 0})
    jm = JSequential([jtf.load_tf(pb)], name="tf_import")
    pm = PSequential([ptf.load_tf(pb, device="cpu")], name="tf_import",
                     device="cpu")
    jm.init_weights(sample_input=x[:2])
    pm.init_weights(sample_input=x[:2])
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
    jm.compile(optimizer="adam", loss="scce", lr=0.05)
    pm.compile(optimizer="adam", loss="scce", lr=0.05)
    want = jm.fit(x, y, batch_size=64, nb_epoch=8)["loss"]
    got = pm.fit(x, y, batch_size=64, nb_epoch=8)["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert got[-1] < got[0] * 0.7
    moved = np.asarray(jm.params["tfnet_0"]["w"])
    assert not np.allclose(moved, w)
    np.testing.assert_allclose(_np(pm.layers[0].param("w")), moved,
                               rtol=1e-4, atol=1e-5)


def test_frozen_mode_matches_jax(tmp_path):
    pb = write_graph(
        tmp_path / "lin2.pb",
        node("input", "Placeholder"),
        const("w", np.eye(4, dtype=np.float32)),
        node("mm", "MatMul", ("input", "w")),
    )
    x = np.random.default_rng(4).normal(size=(3, 4)).astype(np.float32)
    got, want, pnet, jnet = _run_both(pb, x, trainable=False)
    assert jnet.build(None) == {} and list(pnet.parameters()) == []
    assert "w" in pnet.consts and "w" in jnet.consts
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("case", ["unknown_op", "secondary_output",
                                  "unknown_tensor", "cycle"])
def test_load_time_refusals_match_jax(tmp_path, case):
    nodes = {
        "unknown_op": (node("input", "Placeholder"),
                       node("q", "SparseTensorDenseMatMul",
                            ("input", "input"))),
        "secondary_output": (node("input", "Placeholder"),
                             node("bn", "FusedBatchNormV3",
                                  ("input",) * 5),
                             node("use", "Relu", ("bn:1",))),
        "unknown_tensor": (node("input", "Placeholder"),
                           node("y", "Relu", ("nope",))),
        "cycle": (node("input", "Placeholder"),
                  node("a", "Relu", ("b",)), node("b", "Relu", ("a",))),
    }[case]
    pb = write_graph(tmp_path / f"{case}.pb", *nodes)
    with pytest.raises(Exception) as jerr:
        jtf.load_tf(pb)
    with pytest.raises(type(jerr.value)) as perr:
        ptf.load_tf(pb, device="cpu")
    assert str(perr.value) == str(jerr.value)


def test_typed_value_fields_decode_like_jax():
    """float_val/int_val/int64_val/double_val TensorProtos and a bfloat16
    tensor_content decode to the JAX decoder's arrays."""
    bufs = [
        _tensor_proto_typed(np.asarray([1.5, -2.25, 3.0], np.float32), 5,
                            lambda n, a: field_bytes(n, a.tobytes())),
        _tensor_proto_typed(np.asarray([2, 3, 4], np.int32), 7,
                            lambda n, a: field_bytes(n, b"".join(
                                varint(int(v)) for v in a))),
        _tensor_proto_typed(np.asarray([7, -1], np.int64), 10,
                            lambda n, a: field_bytes(n, b"".join(
                                varint(int(v) & 0xFFFFFFFFFFFFFFFF)
                                for v in a))),
    ]
    d = np.asarray([0.5, 0.25], np.float64)
    buf = _tensor_proto_typed(d, 6, lambda n, a: field_bytes(n, a.tobytes()))
    bufs.append(field_varint(1, 2) + buf[len(field_varint(1, 1)):])
    bf = np.asarray([1.0, -2.0, 0.5, 3.0], np.float32)
    bufs.append(field_varint(1, 14) + field_bytes(2, _shape_proto((4,)))
                + field_bytes(4, (bf.view(np.uint32) >> 16).astype(
                    np.uint16).tobytes()))
    for buf in bufs:
        got, want = ptf._decode_tensor(buf), jtf._decode_tensor(buf)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_out_of_order_graphdef_matches_jax(tmp_path):
    x = np.random.default_rng(6).normal(size=(3, 4)).astype(np.float32)
    pb = write_graph(
        tmp_path / "ooo.pb",
        node("out", "Relu", ("mm",)),
        node("mm", "MatMul", ("input", "w")),
        const("w", np.eye(4, dtype=np.float32) * 2),
        node("input", "Placeholder"),
    )
    got, want, _, _ = _run_both(pb, x)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)


def test_placeholder_with_default_matches_jax(tmp_path):
    x = np.ones((2, 3), np.float32)
    pb = write_graph(
        tmp_path / "pwd.pb",
        node("input", "Placeholder"),
        const("scale_default", np.asarray(2.0, np.float32)),
        node("scale", "PlaceholderWithDefault", ("scale_default",)),
        node("y", "Mul", ("input", "scale")),
    )
    got, want, pnet, jnet = _run_both(pb, x)
    assert pnet.feed_names == jnet.feed_names == ["input"]
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    fed = [x, np.asarray(3.0, np.float32)]
    got, want, _, _ = _run_both(pb, fed, inputs=["input", "scale"])
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(got), x * 3.0)

    pb2 = write_graph(
        tmp_path / "pwd2.pb",
        const("input_default", np.zeros((1, 3), np.float32)),
        node("input", "PlaceholderWithDefault", ("input_default",)),
        node("y", "Relu", ("input",)),
    )
    x2 = np.asarray([[-1.0, 2.0, -3.0]], np.float32)
    got, want, pnet, jnet = _run_both(pb2, x2)
    assert pnet.feed_names == jnet.feed_names == ["input"]
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_nchw_batchnorm_refused_like_jax(tmp_path):
    pb = write_graph(
        tmp_path / "nchw.pb",
        node("input", "Placeholder"),
        const("s", np.ones(4, np.float32)),
        node("y", "FusedBatchNormV3", ("input", "s", "s", "s", "s"),
             attr_s("data_format", "NCHW")),
    )
    x = np.ones((1, 4, 5, 5), np.float32)
    with pytest.raises(NotImplementedError, match="NHWC"):
        _run_both(pb, x)
    with pytest.raises(NotImplementedError, match="NHWC"):
        ptf.load_tf(pb, device="cpu")(torch.from_numpy(x))


@pytest.mark.parametrize("mult", [1, 2])
def test_depthwise_conv_matches_jax(tmp_path, mult):
    """HWCM kernels: output channel ``c * M + m``, as the JAX reshape to
    ``(H, W, 1, C*M)`` with ``C`` groups gives."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 7, 7, 4)).astype(np.float32)
    pb = write_graph(
        tmp_path / "dw.pb",
        node("input", "Placeholder"),
        const("k", rng.normal(size=(3, 3, 4, mult)).astype(np.float32)),
        const("kb", rng.normal(size=(4 * mult,)).astype(np.float32)),
        node("c", "DepthwiseConv2dNative", ("input", "k"),
             attr_ints("strides", [1, 2, 2, 1]), attr_s("padding", "SAME")),
        node("y", "BiasAdd", ("c", "kb")),
    )
    got, want, _, _ = _run_both(pb, x)
    assert got.shape == (2, 4, 4, 4 * mult)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=5e-4,
                               atol=5e-4)


@pytest.mark.parametrize("op", ["MaxPool", "AvgPool"])
@pytest.mark.parametrize("hw,k,s", [(7, 3, 2), (8, 2, 3), (5, 4, 1)])
def test_same_pooling_matches_jax(tmp_path, op, hw, k, s):
    """XLA's SAME pads, the smaller half low: MaxPool pads with -inf,
    AvgPool divides by the cells of each window inside the input."""
    x = np.random.default_rng(hw + k).normal(
        size=(2, hw, hw + 1, 3)).astype(np.float32) - 3.0
    pb = write_graph(
        tmp_path / "pool.pb",
        node("input", "Placeholder"),
        node("p", op, ("input",), attr_ints("ksize", [1, k, k, 1]),
             attr_ints("strides", [1, s, s, 1]), attr_s("padding", "SAME")),
    )
    got, want, _, _ = _run_both(pb, x)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_elementwise_semantics_match_jax(tmp_path):
    """Mod/FloorMod (jnp.mod, not fmod), FloorDiv, Round half to even,
    Gather's fill rule, Cast/ArgMax to int64 (values), Shape/Rank and a
    rank-1 f32 MatMul product."""
    a = np.asarray([[-7.5, 7.0, 2.5, -0.5], [0.5, 1.5, -2.5, 3.0]],
                   np.float32)
    pb = write_graph(
        tmp_path / "ew.pb",
        node("input", "Placeholder"),
        const("two", np.asarray(2.0, np.float32)),
        const("mtwo", np.asarray(-2.0, np.float32)),
        const("idx", np.asarray([0, -1, -4, 3, 5], np.int32)),
        const("ax", np.asarray(1, np.int32)),
        const("w", np.arange(8, dtype=np.float32).reshape(4, 2)),
        node("mod", "FloorMod", ("input", "two")),
        node("mod2", "Mod", ("input", "mtwo")),
        node("fdiv", "FloorDiv", ("input", "mtwo")),
        node("rnd", "Round", ("input",)),
        node("gat", "GatherV2", ("input", "idx", "ax")),
        node("cst", "Cast", ("input",), _dtype_attr("DstT", 9)),
        node("am", "ArgMax", ("input", "ax")),
        node("shp", "Shape", ("input",)),
        node("rk", "Rank", ("input",)),
        node("mm", "MatMul", ("input", "w")),
    )
    outs = ["mod", "mod2", "fdiv", "rnd", "gat", "cst", "am", "shp", "rk",
            "mm"]
    got, want, _, _ = _run_both(pb, a, outputs=outs)
    for name, g, w in zip(outs, got, want):
        g = _np(g) if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    assert got[5].dtype == got[6].dtype == torch.int64


def _dtype_attr(key, code):
    from test_tfnet import _attr
    return _attr(key, field_varint(6, code))


@pytest.mark.parametrize("op", ["Reshape", "Pad"])
def test_computed_structural_input_refused_like_jax(tmp_path, op):
    """A Reshape shape or a Pad table computed by the graph: both
    packages refuse it with NotImplementedError."""
    x = np.ones((2, 6), np.float32)
    if op == "Reshape":
        table = np.asarray([3, 4], np.int32)
    else:
        table = np.asarray([[1, 1], [0, 2]], np.int32)
    pb = write_graph(
        tmp_path / "computed.pb",
        node("input", "Placeholder"),
        const("t0", table),
        const("zero", np.zeros_like(table)),
        node("t", "Add", ("t0", "zero")),
        node("y", op, ("input", "t")),
    )
    with pytest.raises(NotImplementedError, match="graph constant"):
        _run_both(pb, x)
    with pytest.raises(NotImplementedError, match="graph constant"):
        ptf.load_tf(pb, device="cpu")(torch.from_numpy(x))


def test_tfnet_stacks_in_a_graph_model(tmp_path):
    """TFNet's output shape comes from a forward on the meta device, so a
    graph Model and a Sequential can stack it (fault u's lesson)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    torch.manual_seed(7)
    tm = nn.Sequential(nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 4))
    pb = _mlp_graph(tmp_path / "mlp.pb", tm)
    net = ptf.load_tf(pb, device="cpu")
    assert net.compute_output_shape((None, 6)) == (None, 4)
    inp = PInput(shape=(6,))
    m = PModel(inp, Dense(3, name="head")(net(inp)), device="cpu")
    m.init_weights()
    x = np.random.default_rng(7).normal(size=(5, 6)).astype(np.float32)
    got = m.predict(x)
    assert got.shape == (5, 3)
    probs = _np(net(torch.from_numpy(x)))
    want = probs @ _np(m.head.W) + _np(m.head.b)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("how", ["tfnet.load_tf", "Net.load_tf"])
def test_tf_loaders_run_on_cuda_unless_told(tmp_path, monkeypatch, how):
    """No device given and no card: the loaders raise, as every entry
    point of the port does; they never fall back to the CPU."""
    torch.manual_seed(8)
    pb = _mlp_graph(tmp_path / "mlp.pb", nn.Sequential(
        nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 4)))
    load = ptf.load_tf if how == "tfnet.load_tf" else PNet.load_tf
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(pb)


@pytest.mark.parametrize("trainable", [True, False],
                         ids=["params", "frozen"])
def test_tfnet_keeps_weights_on_its_device(tmp_path, trainable):
    """The weights and the non-structural Consts' copies sit on the
    layer's device from load, follow ``.to``, and an input on another
    device is refused rather than the weights copied to it; a numpy input
    is made on the layer's device."""
    torch.manual_seed(9)
    pb = _mlp_graph(tmp_path / "mlp.pb", nn.Sequential(
        nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 4)))
    net = ptf.load_tf(pb, device="cpu", trainable=trainable)
    cpu = torch.device("cpu")
    assert net.device == cpu
    assert all(p.device == cpu for p in net.parameters())
    assert len(net._placed) == (0 if trainable else 4)
    assert all(set(c.tensors) == {cpu} for c in net._placed)
    x = np.random.default_rng(9).normal(size=(3, 6)).astype(np.float32)
    np.testing.assert_array_equal(_np(net(x)),
                                  _np(net(torch.from_numpy(x))))
    net.to("meta")
    meta = torch.device("meta")
    assert net.device == meta
    assert all(p.device == meta for p in net.parameters())
    assert all(set(c.tensors) == {meta} for c in net._placed)
    with pytest.raises(ValueError, match="input on cpu, weights on meta"):
        net(torch.from_numpy(x))
    assert net(x).device == meta
    assert net.compute_output_shape((None, 6)) == (None, 4)


def test_fit_reads_no_sample_of_a_built_model(tmp_path, monkeypatch):
    """``fit`` takes a sample of the data for the input shape only while
    the model has no weights."""
    from analytics_zoo_tpu_torch.feature import feature_set
    calls = []
    real = feature_set.FeatureSet.sample

    def counted(self, n):
        calls.append(n)
        return real(self, n)

    monkeypatch.setattr(feature_set.FeatureSet, "sample", counted)
    torch.manual_seed(10)
    pb = _mlp_graph(tmp_path / "mlp.pb", nn.Sequential(
        nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 4)))
    rng = np.random.default_rng(10)
    x = rng.normal(size=(16, 6)).astype(np.float32)
    y = rng.integers(0, 4, size=16).astype(np.int32)
    pm = PSequential([ptf.load_tf(pb, device="cpu")], device="cpu")
    pm.compile(optimizer="adam", loss="scce", lr=0.01)
    pm.fit(x, y, batch_size=8, nb_epoch=1)
    assert calls == [1] and pm.built
    pm.fit(x, y, batch_size=8, nb_epoch=1)
    assert calls == [1]


def test_layer_tree_key_default_is_read_only():
    """The class-wide default of ``Layer._tree_keys`` cannot be written
    through: a layer with stand-in names assigns its own map."""
    with pytest.raises(TypeError):
        peng.Layer._tree_keys["W"] = "kernel"
    assert dict(peng.Layer._tree_keys) == {}


def _graph_zoo(zoo, seq, tf):
    """A ZooModel class named ``TFGraphZoo`` (one name in both packages'
    registries) whose network is ``Sequential([TFNet(graph at pb)])`` on
    4 features."""
    def __init__(self, pb, **kwargs):
        self.pb = pb
        zoo.ZooModel.__init__(self, **kwargs)

    def build_model(self):
        kw = {"device": self.device} if hasattr(self, "device") else {}
        with open(self.pb, "rb") as f:
            nodes = tf._decode_graph(f.read())
        return seq([tf.TFNet(nodes, input_shape=(4,), **kw)], **kw)

    cls = type("TFGraphZoo", (zoo.ZooModel,), {
        "__init__": __init__, "build_model": build_model,
        "get_config": lambda self: {"pb": self.pb}})
    return zoo.register_model(cls)


def test_dot_named_const_round_trips(tmp_path):
    """A Const named like ``dense.1/kernel`` (register_parameter refuses
    the ``.``) keeps its node name as its JAX tree key: load_jax_params,
    the checkpoint tree, the tree order and the ``.npz`` both ways."""
    rng = np.random.default_rng(8)
    k1 = rng.normal(size=(4, 5)).astype(np.float32)
    k0 = rng.normal(size=(5, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    pb = write_graph(
        tmp_path / "dots.pb",
        node("input", "Placeholder"),
        const("dense.1/kernel", k1),
        const("dense/kernel", k0),
        const("dense/bias", b),
        node("h", "MatMul", ("input", "dense.1/kernel")),
        node("o", "MatMul", ("h", "dense/kernel")),
        node("y", "BiasAdd", ("o", "dense/bias")),
    )
    x = rng.normal(size=(3, 4)).astype(np.float32)
    jm = JSequential([jtf.load_tf(pb)])
    jm.init_weights(sample_input=x)
    tree = jax.tree.map(lambda a: np.asarray(a) * 2.0, jm.params)
    jm.params = jax.tree.map(jax.numpy.asarray, tree)
    pm = PSequential([ptf.load_tf(pb, device="cpu")], device="cpu")
    pm.init_weights(sample_input=x)
    pm.load_jax_params(tree)
    np.testing.assert_allclose(pm.predict(x), np.asarray(jm.predict(x)),
                               rtol=1e-5, atol=1e-5)
    assert sorted(tree["tfnet_0"]) == sorted(
        pm.layers[0]._tree_keys.values())
    named = dict(pm.named_parameters())
    assert jax.tree.structure(_param_tree(named, pm)) == \
        jax.tree.structure(tree)
    order = [_np(t) for _, t in peng.tree_order(named)]
    for got, want in zip(order, jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got, want)

    jzm = _graph_zoo(jzoo, JSequential, jtf)(str(pb))
    jzm.init_weights(sample_input=x)
    jzm.params = jax.tree.map(jax.numpy.asarray, tree)
    _graph_zoo(pzoo, PSequential, ptf)
    pz = pzoo.load_model(jzm.save(str(tmp_path / "jax_saved")),
                         device="cpu")
    np.testing.assert_allclose(pz.predict(x), np.asarray(jm.predict(x)),
                               rtol=1e-5, atol=1e-5)
    jz = jzoo.load_model(pz.save(str(tmp_path / "port_saved")))
    np.testing.assert_allclose(np.asarray(jz.predict(x)), pz.predict(x),
                               rtol=1e-5, atol=1e-5)


def _dotted_graph(path, rng):
    return write_graph(
        path,
        node("input", "Placeholder"),
        const("dense.1/kernel", rng.normal(size=(4, 5)).astype(np.float32)),
        const("dense/kernel", rng.normal(size=(5, 3)).astype(np.float32)),
        node("h", "MatMul", ("input", "dense.1/kernel")),
        node("o", "MatMul", ("h", "dense/kernel")),
        node("y", "Softmax", ("o",)),
    )


def test_dot_named_const_through_checkpoints_both_ways(tmp_path):
    """The port's snapshot of a TFNet with a ``.``-named Const restores
    in the JAX manager against the JAX model's templates (params and
    Adam's moments under the node names); a JAX snapshot resumes the
    port's fit."""
    from analytics_zoo_tpu.observability import MetricsRegistry as JReg
    from analytics_zoo_tpu.utils.checkpoint import CheckpointManager as JCM
    rng = np.random.default_rng(9)
    pb = _dotted_graph(tmp_path / "dots.pb", rng)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = rng.integers(0, 3, 64).astype(np.int32)
    jctx.init_zoo_context(conf={"zoo.seed": 0})
    pctx.init_zoo_context(conf={"zoo.seed": 0})
    jm = JSequential([jtf.load_tf(pb)])
    pm = PSequential([ptf.load_tf(pb, device="cpu")], device="cpu")
    for m in (jm, pm):
        m.compile(optimizer="adam", loss="scce", lr=0.05)
    pm.set_checkpoint(str(tmp_path / "p"))
    pm.fit(x, y, batch_size=16, nb_epoch=1)
    jm.fit(x, y, batch_size=16, nb_epoch=0)
    _, trees, _ = JCM(str(tmp_path / "p"), registry=JReg()).restore_latest(
        {"params": jm.params,
         "opt_state": jm._loop.optimizer.init(jm.params),
         "net_state": jm.net_state})
    net = pm.layers[0]
    for key in ("dense.1/kernel", "dense/kernel"):
        np.testing.assert_array_equal(
            np.asarray(trees["params"]["tfnet_0"][key]),
            _np(net.param(key)))

    jm2 = JSequential([jtf.load_tf(pb)])
    jm2.compile(optimizer="adam", loss="scce", lr=0.05)
    jm2.set_checkpoint(str(tmp_path / "j"))
    jm2.fit(x, y, batch_size=16, nb_epoch=2)
    pm.set_checkpoint(str(tmp_path / "j"))
    pm.fit(x, y, batch_size=16, nb_epoch=0)              # resume only
    for key in ("dense.1/kernel", "dense/kernel"):
        np.testing.assert_array_equal(
            _np(net.param(key)), np.asarray(jm2.params["tfnet_0"][key]))


def test_tfnet_module_imports_no_jax():
    code = (
        "import sys\n"
        "import analytics_zoo_tpu_torch.pipeline.api.tfnet\n"
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
