"""The port's model-import facade (``Net``, ``TorchNet``, TorchScript
files, ``TorchCriterion`` and ``install_imported_weights``) against the
JAX package's.

The same torch modules, TorchScript files and seeded numpy inputs go
through ``analytics_zoo_tpu.pipeline.api.net`` and
``analytics_zoo_tpu_torch.pipeline.api.net``: outputs at the JAX tests'
tolerances (``tests/test_torch_net.py``, ``tests/test_torchscript.py``),
fine-tuned parameters after the same batches from the JAX network's
weights (moved across by ``load_jax_params``), and every refusal by its
exception type and message.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.pipeline.api import net as jnet
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.pipeline.api import net as pnet
from analytics_zoo_tpu_torch.pipeline.api.keras import \
    Sequential as PSequential
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense as PDense

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def port_context():
    pctx.reset_zoo_context()
    yield
    pctx.reset_zoo_context()


def _jax_run(model, x):
    return np.asarray(model.apply(model.params, model.net_state,
                                  jnp.asarray(x), training=False,
                                  rng=None)[0])


def _port_run(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(np.asarray(x))).numpy()


def _both(tm, input_shape):
    """(port model, JAX model) of the torch module ``tm``."""
    return (pnet.Net.load_torch(tm, input_shape=input_shape, device="cpu"),
            jnet.Net.load_torch(tm, input_shape=input_shape))


def _params(model):
    return {k: np.asarray(v) for k, v in peng.flatten_tree(
        jax.tree.map(np.asarray, model.params)).items()}


def _port_params(model):
    return {"/".join(peng.tree_key(model, n)): p.detach().numpy()
            for n, p in model.named_parameters()}


def test_mlp_matches_jax():
    torch.manual_seed(0)
    tm = nn.Sequential(nn.Linear(8, 32), nn.ReLU(), nn.Dropout(0.2),
                       nn.Linear(32, 16), nn.Tanh(), nn.Linear(16, 3),
                       nn.Softmax(dim=-1)).eval()
    x = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
    pm, jm = _both(tm, (8,))
    jp, pp = _params(jm), _port_params(pm)
    assert sorted(jp) == sorted(pp)
    for k in jp:
        np.testing.assert_array_equal(pp[k], jp[k], err_msg=k)
    np.testing.assert_allclose(_port_run(pm, x), _jax_run(jm, x), rtol=1e-5,
                               atol=1e-6)


def test_cnn_matches_jax():
    """Conv/BN/pool/flatten with the NCHW flatten-order adapter."""
    torch.manual_seed(1)
    tm = nn.Sequential(
        nn.Conv2d(3, 8, 3, stride=1, padding=1), nn.BatchNorm2d(8),
        nn.ReLU(), nn.MaxPool2d(2, 2),
        nn.Conv2d(8, 4, 3), nn.ReLU(), nn.AvgPool2d(2, 2),
        nn.Flatten(), nn.Linear(4 * 3 * 3, 5)).eval()
    tm[1].running_mean.normal_()
    tm[1].running_var.uniform_(0.5, 2.0)
    x = np.random.default_rng(1).normal(size=(2, 3, 16, 16)) \
        .astype(np.float32).transpose(0, 2, 3, 1)
    pm, jm = _both(tm, (3, 16, 16))
    state = {"/".join(peng.tree_key(pm, n)): t.numpy()
             for n, t in peng.named_state(pm).items()}
    jstate = peng.flatten_tree(jax.tree.map(np.asarray, jm.net_state))
    assert sorted(state) == sorted(jstate)
    for k in state:
        np.testing.assert_array_equal(state[k], jstate[k])
    np.testing.assert_allclose(_port_run(pm, x), _jax_run(jm, x), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("approximate", ["none", "tanh"])
def test_gap_layernorm_gelu_match_jax(approximate):
    torch.manual_seed(2)
    tm = nn.Sequential(nn.Conv2d(2, 6, 1), nn.GELU(approximate=approximate),
                       nn.AdaptiveAvgPool2d(1), nn.Flatten(),
                       nn.LayerNorm(6), nn.Linear(6, 2)).eval()
    x = np.random.default_rng(2).normal(size=(3, 2, 5, 5)) \
        .astype(np.float32).transpose(0, 2, 3, 1)
    pm, jm = _both(tm, (2, 5, 5))
    got = _port_run(pm, x)
    np.testing.assert_allclose(got, _jax_run(jm, x), rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        want = tm(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _fit_both(pm, jm, x, y, compile_kw, fit_kw):
    """Fit both from the JAX network's weights on the same shuffled
    batches; returns (port losses, JAX losses)."""
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params),
                       jax.tree.map(np.asarray, jm.net_state))
    pm.compile(**compile_kw)
    jm.compile(**compile_kw)
    return (pm.fit(x, y, **fit_kw)["loss"], jm.fit(x, y, **fit_kw)["loss"])


def _assert_params_match(pm, jm, tol):
    jp, pp = _params(jm), _port_params(pm)
    assert sorted(jp) == sorted(pp)
    for k in jp:
        np.testing.assert_allclose(pp[k], jp[k], atol=tol, rtol=0,
                                   err_msg=k)


def test_imported_model_fine_tunes_like_jax():
    jctx.init_zoo_context(conf={"zoo.seed": 0})
    pctx.init_zoo_context(conf={"zoo.seed": 0})
    torch.manual_seed(3)
    tm = nn.Sequential(nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 2))
    pm, jm = _both(tm, (6,))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(256, 6)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int32)
    got, want = _fit_both(
        pm, jm, x, y, dict(optimizer="adam", loss="scce_with_logits",
                           metrics=["accuracy"], lr=5e-3),
        dict(batch_size=32, nb_epoch=8))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert got[-1] < got[0]
    _assert_params_match(pm, jm, 1e-4)
    pe, je = (m.evaluate(x, y, batch_size=32) for m in (pm, jm))
    assert pe["accuracy"] == pytest.approx(float(je["accuracy"]))
    assert pe["accuracy"] > 0.9


def test_embedding_batchnorm1d_and_padded_avgpool_match_jax():
    torch.manual_seed(4)
    tm = nn.Sequential(nn.Embedding(30, 8), nn.LayerNorm(8)).eval()
    ids = np.random.default_rng(4).integers(0, 30, size=(3, 7)) \
        .astype(np.int32)
    pm, jm = _both(tm, (7,))
    np.testing.assert_allclose(_port_run(pm, ids), _jax_run(jm, ids),
                               rtol=1e-4, atol=1e-5)

    bn = nn.Sequential(nn.BatchNorm1d(4)).eval()
    bn[0].running_mean.normal_()
    bn[0].running_var.uniform_(0.5, 2.0)
    x = np.random.default_rng(5).normal(size=(2, 4, 9)).astype(np.float32)
    pm, jm = _both(bn, (4, 9))
    np.testing.assert_allclose(_port_run(pm, x), _jax_run(jm, x),
                               rtol=1e-4, atol=1e-5)

    ap = nn.Sequential(nn.AvgPool2d(3, 2, padding=1)).eval()
    xi = np.random.default_rng(6).normal(size=(1, 2, 7, 7)) \
        .astype(np.float32).transpose(0, 2, 3, 1)
    pm, jm = _both(ap, (2, 7, 7))
    np.testing.assert_allclose(_port_run(pm, xi), _jax_run(jm, xi),
                               rtol=1e-4, atol=1e-5)


_REFUSED = {
    "padding_mode": (lambda: nn.Conv2d(1, 1, 3, padding=1,
                                       padding_mode="reflect"), (1, 8, 8)),
    "grouped_conv": (lambda: nn.Conv2d(2, 2, 3, groups=2), (2, 8, 8)),
    "string_padding": (lambda: nn.Conv2d(1, 1, 3, padding="same"),
                       (1, 8, 8)),
    "softmax_axis": (lambda: nn.Softmax(dim=1), (3, 5)),
    "partial_flatten": (lambda: nn.Flatten(start_dim=2), (2, 3, 4)),
    "count_include_pad": (lambda: nn.AvgPool2d(2, 2, padding=1,
                                               count_include_pad=False),
                          (1, 8, 8)),
    "ceil_mode": (lambda: nn.MaxPool2d(2, ceil_mode=True), (1, 7, 7)),
    "dilated_pool": (lambda: nn.MaxPool2d(2, dilation=2), (1, 8, 8)),
    "return_indices": (lambda: nn.MaxPool2d(2, return_indices=True),
                       (1, 8, 8)),
    "adaptive_to_2": (lambda: nn.AdaptiveAvgPool2d(2), (1, 8, 8)),
    "untracked_bn": (lambda: nn.BatchNorm2d(1, track_running_stats=False),
                     (1, 8, 8)),
    "lstm": (lambda: nn.LSTM(4, 4), (4,)),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_loud_refusals_match_jax(case):
    make, shape = _REFUSED[case]
    module = nn.Sequential(make())
    with pytest.raises(Exception) as jerr:
        jnet.TorchNet.from_module(module, input_shape=shape)
    with pytest.raises(type(jerr.value)) as perr:
        pnet.TorchNet.from_module(module, input_shape=shape, device="cpu")
    assert isinstance(jerr.value, NotImplementedError)
    assert str(perr.value) == str(jerr.value)


def test_net_load_reads_the_jax_zoo_npz(tmp_path):
    from analytics_zoo_tpu.models.recommendation import NeuralCF as JNCF
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    jm = JNCF(50, 60, 5)
    jm.init_weights()
    path = jm.save(str(tmp_path / "ncf"))
    back = pnet.Net.load(path, device="cpu")
    assert isinstance(back, NeuralCF)
    pairs = np.random.default_rng(7).integers(1, 50, size=(9, 2)) \
        .astype(np.int32)
    np.testing.assert_allclose(back.predict(pairs),
                               np.asarray(jm.predict(pairs)), rtol=1e-5,
                               atol=1e-6)


def test_facade_refusals():
    with pytest.raises(TypeError) as jerr:
        jnet.Net.load_tf(__file__, signature="x")
    with pytest.raises(TypeError) as perr:
        pnet.Net.load_tf(__file__, signature="x")
    assert str(perr.value) == str(jerr.value)
    for load in (pnet.Net.load_caffe, pnet.Net.load_onnx):
        with pytest.raises(NotImplementedError, match="10f"):
            load("model")


@pytest.mark.parametrize("case", ["unknown_layer", "unknown_param",
                                  "bad_shape"])
def test_installer_refusals_match_jax(case):
    w = np.zeros((4, 3), np.float32)
    weights = {"unknown_layer": {"nope": {"W": w}},
               "unknown_param": {"head": {"V": w}},
               "bad_shape": {"head": {"W": np.zeros((3, 4), np.float32)}},
               }[case]
    jm = JSequential([JDense(3, name="head", input_shape=(4,))])
    pm = PSequential([PDense(3, name="head", input_shape=(4,))],
                     device="cpu")
    with pytest.raises(ValueError) as jerr:
        jeng.install_imported_weights(jm, weights, source="caffe")
    with pytest.raises(ValueError) as perr:
        peng.install_imported_weights(pm, weights, source="caffe")
    assert str(perr.value) == str(jerr.value)


def test_installer_writes_params_and_state_like_jax():
    from analytics_zoo_tpu.pipeline.api.keras.layers import \
        BatchNormalization as JBN
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
        BatchNormalization as PBN
    rng = np.random.default_rng(8)
    weights = {"bn": {"gamma": rng.normal(size=4).astype(np.float32),
                      "beta": rng.normal(size=4).astype(np.float32)}}
    states = {"bn": {"moving_mean": rng.normal(size=4).astype(np.float32),
                     "moving_var": rng.uniform(0.5, 2, 4).astype(
                         np.float32)}}
    jm = jeng.install_imported_weights(
        JSequential([JBN(name="bn", input_shape=(4,))]), weights, states)
    pm = peng.install_imported_weights(
        PSequential([PBN(name="bn", input_shape=(4,))], device="cpu"),
        weights, states)
    x = rng.normal(size=(5, 4)).astype(np.float32)
    np.testing.assert_allclose(pm.predict(x), np.asarray(jm.predict(x)),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# TorchScript files
# ---------------------------------------------------------------------------

def _mlp():
    return nn.Sequential(nn.Linear(6, 16), nn.ReLU(),
                         nn.Linear(16, 4), nn.Softmax(dim=-1))


def test_scripted_file_matches_jax(tmp_path):
    torch.manual_seed(9)
    tm = _mlp()
    path = str(tmp_path / "mlp.pt")
    torch.jit.save(torch.jit.script(tm), path)
    x = np.random.default_rng(0).normal(size=(5, 6)).astype(np.float32)
    pm = pnet.Net.load_torch(path, input_shape=(6,), device="cpu")
    jm = jnet.Net.load_torch(path, input_shape=(6,))
    np.testing.assert_allclose(pm.predict(x, batch_size=5),
                               np.asarray(jm.predict(x, batch_size=5)),
                               rtol=2e-4, atol=2e-5)
    # the file and the live module give the same bits
    live = pnet.Net.load_torch(tm, input_shape=(6,), device="cpu")
    np.testing.assert_array_equal(live.predict(x), pm.predict(x))


def test_scripted_cnn_matches_jax(tmp_path):
    torch.manual_seed(10)
    tm = nn.Sequential(
        nn.Conv2d(3, 8, 3, stride=1, padding=1), nn.BatchNorm2d(8),
        nn.ReLU(), nn.MaxPool2d(2), nn.Flatten(), nn.Linear(8 * 4 * 4, 5))
    tm.eval()
    path = str(tmp_path / "cnn.pt")
    torch.jit.save(torch.jit.script(tm), path)
    x = np.random.default_rng(1).normal(size=(3, 3, 8, 8)) \
        .astype(np.float32).transpose(0, 2, 3, 1)
    pm = pnet.Net.load_torch(path, input_shape=(3, 8, 8), device="cpu")
    jm = jnet.Net.load_torch(path, input_shape=(3, 8, 8))
    np.testing.assert_allclose(pm.predict(x, batch_size=4),
                               np.asarray(jm.predict(x, batch_size=4)),
                               rtol=1e-3, atol=1e-4)


def test_traced_module_refused_like_jax(tmp_path):
    path = str(tmp_path / "traced.pt")
    torch.jit.save(torch.jit.trace(_mlp(), torch.zeros(1, 6)), path)
    with pytest.raises(NotImplementedError) as jerr:
        jnet.Net.load_torch(path, input_shape=(6,))
    with pytest.raises(NotImplementedError) as perr:
        pnet.Net.load_torch(path, input_shape=(6,), device="cpu")
    assert str(perr.value) == str(jerr.value)
    assert "torch.jit.script" in str(perr.value)


def test_scripted_file_fine_tunes_like_jax(tmp_path):
    jctx.init_zoo_context(conf={"zoo.seed": 0})
    pctx.init_zoo_context(conf={"zoo.seed": 0})
    torch.manual_seed(11)
    path = str(tmp_path / "ft.pt")
    torch.jit.save(torch.jit.script(_mlp()), path)
    pm = pnet.Net.load_torch(path, input_shape=(6,), device="cpu")
    jm = jnet.Net.load_torch(path, input_shape=(6,))
    rng = np.random.default_rng(2)
    w = rng.normal(size=(6, 4))
    x = rng.normal(size=(256, 6)).astype(np.float32)
    y = (x @ w).argmax(1).astype(np.int32)
    got, want = _fit_both(pm, jm, x, y,
                          dict(optimizer="adam", loss="scce", lr=1e-2),
                          dict(batch_size=32, nb_epoch=5))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert got[-1] < got[0]
    _assert_params_match(pm, jm, 1e-4)


# ---------------------------------------------------------------------------
# TorchCriterion
# ---------------------------------------------------------------------------

def _crit_both(loss):
    return pnet.TorchCriterion(loss), jnet.TorchCriterion(loss)


@pytest.mark.parametrize("loss_cls,pred_kind", [
    (nn.MSELoss, "float"), (nn.L1Loss, "float"),
    (nn.SmoothL1Loss, "float"), (nn.BCELoss, "prob"),
    (nn.BCEWithLogitsLoss, "float"),
])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_elementwise_criteria_match_jax(loss_cls, pred_kind, reduction):
    rng = np.random.default_rng(3)
    yp = rng.normal(size=(8, 5)).astype(np.float32)
    if pred_kind == "prob":
        yp = 1 / (1 + np.exp(-yp))
    yt = (rng.random((8, 5)) > 0.5).astype(np.float32)
    pc, jc = _crit_both(loss_cls(reduction=reduction))
    got = float(pc(torch.from_numpy(yt), torch.from_numpy(yp)))
    want = float(jc(jnp.asarray(yt), jnp.asarray(yp)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        pc.per_example(torch.from_numpy(yt), torch.from_numpy(yp)).numpy(),
        np.asarray(jc.per_example(jnp.asarray(yt), jnp.asarray(yp))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_smooth_l1_beta_matches_jax(beta):
    rng = np.random.default_rng(12)
    yp = rng.normal(size=(6, 3)).astype(np.float32)
    yt = rng.normal(size=(6, 3)).astype(np.float32)
    pc, jc = _crit_both(nn.SmoothL1Loss(beta=beta))
    np.testing.assert_allclose(
        float(pc(torch.from_numpy(yt), torch.from_numpy(yp))),
        float(jc(jnp.asarray(yt), jnp.asarray(yp))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_class_criteria_match_jax(reduction):
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(8, 5)).astype(np.float32)
    y = rng.integers(0, 5, 8)
    pc, jc = _crit_both(nn.CrossEntropyLoss(reduction=reduction))
    np.testing.assert_allclose(
        float(pc(torch.from_numpy(y), torch.from_numpy(logits))),
        float(jc(jnp.asarray(y), jnp.asarray(logits))), rtol=1e-5,
        atol=1e-6)
    logp = F.log_softmax(torch.from_numpy(logits), dim=-1)
    pc, jc = _crit_both(nn.NLLLoss(reduction=reduction))
    np.testing.assert_allclose(
        float(pc(torch.from_numpy(y), logp)),
        float(jc(jnp.asarray(y), jnp.asarray(logp.numpy()))), rtol=1e-5,
        atol=1e-6)


def test_criterion_out_of_range_label_is_nan_like_jax():
    logits = np.zeros((2, 3), np.float32)
    y = np.asarray([1, 7])
    pc, jc = _crit_both(nn.CrossEntropyLoss())
    got = pc.per_example(torch.from_numpy(y), torch.from_numpy(logits))
    want = jc.per_example(jnp.asarray(y), jnp.asarray(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isnan(got.numpy()[1])


def _dense_model(pkg):
    if pkg == "port":
        return PSequential([PDense(8, activation="relu", input_shape=(6,)),
                            PDense(1)], device="cpu")
    return JSequential([JDense(8, activation="relu", input_shape=(6,)),
                        JDense(1)])


def test_criterion_in_compile_fit_matches_jax():
    jctx.init_zoo_context(conf={"zoo.seed": 0})
    pctx.init_zoo_context(conf={"zoo.seed": 0})
    rng = np.random.default_rng(5)
    x = rng.normal(size=(128, 6)).astype(np.float32)
    yt = (x @ rng.normal(size=(6, 1))).astype(np.float32)
    jm, pm = _dense_model("jax"), _dense_model("port")
    jm.init_weights()
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
    pm.compile(optimizer="adam", lr=1e-2,
               loss=pnet.TorchCriterion(nn.SmoothL1Loss()))
    jm.compile(optimizer="adam", lr=1e-2,
               loss=jnet.TorchCriterion(nn.SmoothL1Loss()))
    got = pm.fit(x, yt, batch_size=32, nb_epoch=6)["loss"]
    want = jm.fit(x, yt, batch_size=32, nb_epoch=6)["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert got[-1] < got[0] * 0.6
    _assert_params_match(pm, jm, 1e-4)
    # evaluate masks the padded tail through the per_example form
    pe = pm.evaluate(x[:100], yt[:100], batch_size=32)
    je = jm.evaluate(x[:100], yt[:100], batch_size=32)
    np.testing.assert_allclose(pe["loss"], float(je["loss"]), rtol=1e-5)


def test_criterion_runs_inside_a_scan_step():
    """Under ``zoo.train.scan_steps`` (the fused, capturable dispatch) the
    translated loss gives the eager fit's losses and weights."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(128, 6)).astype(np.float32)
    yt = rng.integers(0, 2, (128, 1)).astype(np.float32)
    runs = []
    for conf in ({}, {"zoo.train.scan_steps": 4}):
        pctx.init_zoo_context(conf={"zoo.seed": 0, **conf})
        pm = _dense_model("port")
        pm.init_weights(torch.Generator().manual_seed(0))
        pm.compile(optimizer="sgd", lr=0.1,
                   loss=pnet.TorchCriterion(nn.BCEWithLogitsLoss()))
        runs.append((pm.fit(x, yt, batch_size=16, nb_epoch=1)["loss"],
                     _port_params(pm)))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-6)
    for k in runs[0][1]:
        np.testing.assert_allclose(runs[1][1][k], runs[0][1][k], rtol=1e-6,
                                   atol=1e-7)


def test_criterion_scripted_loss_file_like_jax(tmp_path):
    path = str(tmp_path / "loss.pt")
    torch.jit.save(torch.jit.script(nn.MSELoss()), path)
    pc, jc = pnet.TorchCriterion(path), jnet.TorchCriterion(path)
    assert pc.name == jc.name == "MSELoss"
    yp, yt = np.asarray([[1.0, 2.0]], np.float32), np.zeros((1, 2),
                                                             np.float32)
    assert float(pc(torch.from_numpy(yt), torch.from_numpy(yp))) == \
        float(jc(jnp.asarray(yt), jnp.asarray(yp))) == 2.5


_CRIT_REFUSED = {
    "unknown": lambda: nn.KLDivLoss(),
    "reduction_none": lambda: nn.MSELoss(reduction="none"),
    "weight": lambda: nn.CrossEntropyLoss(weight=torch.ones(3)),
    "pos_weight": lambda: nn.BCEWithLogitsLoss(pos_weight=torch.ones(3)),
    "ignore_index": lambda: nn.NLLLoss(ignore_index=0),
    "label_smoothing": lambda: nn.CrossEntropyLoss(label_smoothing=0.1),
}


@pytest.mark.parametrize("case", sorted(_CRIT_REFUSED))
def test_criterion_refusals_match_jax(case):
    loss = _CRIT_REFUSED[case]()
    with pytest.raises(NotImplementedError) as jerr:
        jnet.TorchCriterion(loss)
    with pytest.raises(NotImplementedError) as perr:
        pnet.TorchCriterion(loss)
    assert str(perr.value) == str(jerr.value)


def test_net_module_imports_no_jax():
    code = (
        "import sys\n"
        "import analytics_zoo_tpu_torch.pipeline.api.net\n"
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
