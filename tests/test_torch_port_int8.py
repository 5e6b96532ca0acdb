"""int8 inference and serving in the port, held against the JAX package on
the same numpy-seeded inputs and transferred weights.

* K6's plain version against the JAX ``int8_matmul`` in interpret mode
  (as ``tests/test_pallas.py`` runs it): f32 within 1e-4 of the case's
  largest value (summation order only), bf16 within one bf16 step there.
* ``quantize_int8`` and ``_quantize_layer_entry`` bit for bit.
* K6's dequantize-first mode, which the port's ``dense`` uses for an int8
  weight, against the JAX weight-only predict's arithmetic
  (``dequantize_int8`` in the compute dtype, then the matmul), with scales
  that bf16 rounds by nearly half a step (0.49 of one): in bf16 at most 1%
  of the outputs may differ from JAX's, each by at most one bf16 step at
  the case's largest value (only the f32 summation order differs, so an
  output moves only where the two sums straddle a rounding boundary). The
  Pallas contract's order (the f32 scale after the product, K6's default)
  moves about two thirds of them and fails this; in f32 within 1e-6 of
  the largest value (rounding only).
* Weight-only int8 ``InferenceModel``: f32 within 1e-5 (rounding only);
  bf16 within 2e-2 (the two packages' bf16 layers round activations at
  other points).
* Static int8: the first layer's ``x_scale`` and every int8 weight bit for
  bit, deeper ``x_scale`` within 1e-6 relative (the calibration forward's
  summation order), outputs within 1e-4.
* The ``.npz`` format both ways, ``ClusterServing``'s serving dtype and
  ``_wrap_model``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.common.zoo_model import \
    load_model as jax_load_model
from analytics_zoo_tpu.models.recommendation import NeuralCF as JaxNeuralCF
from analytics_zoo_tpu.ops.pallas.quantized import \
    int8_matmul as jax_int8_matmul
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JaxSequential
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.inference import InferenceModel as JaxIM
from analytics_zoo_tpu.pipeline.inference import inference_model as jim
from analytics_zoo_tpu.serving import ClusterServing as JaxClusterServing
from analytics_zoo_tpu.serving import InputQueue as JaxInputQueue
from analytics_zoo_tpu.serving import LocalBackend as JaxLocalBackend
from analytics_zoo_tpu.serving import OutputQueue as JaxOutputQueue
from analytics_zoo_tpu.tfpark.bert_classifier import \
    BERTClassifier as JaxBERTClassifier
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.models.common.zoo_model import load_model
from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
from analytics_zoo_tpu_torch.observability import reset_default_registry
from analytics_zoo_tpu_torch.ops.pallas import quantized as pq
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import core as pcore
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.self_attention \
    import DenseParams
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
from analytics_zoo_tpu_torch.pipeline.inference import inference_model as pim
from analytics_zoo_tpu_torch.serving import (ClusterServing, InputQueue,
                                             LocalBackend, OutputQueue)
from analytics_zoo_tpu_torch.tfpark.bert_classifier import (
    BERTClassifier, load_jax_params, make_bert_inputs)

#: hidden 256 so that BERT's Dense(2) head (512 weights) is quantized too
BERT_CFG = dict(vocab=99, hidden_size=256, n_block=1, n_head=4, seq_len=16,
                intermediate_size=512)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def port_context():
    pctx.reset_zoo_context()
    peng.reset_uids()
    jeng.reset_uids()
    yield
    pctx.reset_zoo_context()
    jeng.set_policy()
    # the servers here count into the port's process-wide registry; later
    # tests in this process read it from zero
    reset_default_registry()


def _policy(dtype):
    """Both packages' compute policy: ``dtype`` compute, f32 params."""
    if dtype == "bfloat16":
        jeng.set_policy(compute_dtype=jnp.bfloat16)
        peng.set_policy(compute_dtype=torch.bfloat16)


def _bf16_step(v: float) -> float:
    """One bf16 step (unit in the last place) at magnitude ``v``."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


# ---------------------------------------------------------------------------
# K6's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 17, 64])
@pytest.mark.parametrize("n", [2, 8, 130])
def test_int8_matmul_plain_version_matches_jax_kernel(dtype, m, n):
    rng = np.random.default_rng(m * 131 + n)
    k = 100
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, n).astype(np.float32)
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jax_int8_matmul(jnp.asarray(x, jd), jnp.asarray(w),
                                      jnp.asarray(s), interpret=True)
                      .astype(jnp.float32))
    got = pq.int8_matmul(torch.from_numpy(x).to(td), torch.from_numpy(w),
                         torch.from_numpy(s))
    assert got.dtype == td and got.shape == (m, n)
    top = np.abs(want).max()
    tol = 1e-4 * top if dtype == "float32" else _bf16_step(top)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_int8_matmul_shape_error_matches_jax():
    x, w, s = np.zeros((4, 3), np.float32), np.zeros((5, 2), np.int8), \
        np.zeros(2, np.float32)
    with pytest.raises(ValueError) as want:
        jax_int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s))
    with pytest.raises(ValueError) as got:
        pq.int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(s))
    assert str(got.value) == str(want.value)


def test_dense_refuses_an_int8_weight_without_its_scale():
    x = torch.ones(2, 4)
    w = torch.ones(4, 3, dtype=torch.int8)
    with pytest.raises(ValueError, match="scale"):
        pcore.dense(x, w, None, torch.float32)
    y = pcore.dense(x, w, torch.ones(3), torch.float32,
                    torch.full((3,), 0.5))
    np.testing.assert_array_equal(y.numpy(), np.full((2, 3), 3.0))


def _near_half_step_scales(rng, n):
    """Per-column scales that bf16 rounds down by 0.49 of a bf16 step:
    ``2^e (1 + i/128)`` plus 0.49 of that binade's step."""
    e = rng.integers(-9, -5, n)
    return (2.0 ** e * (1 + rng.integers(0, 20, n) / 128.0)
            + 0.49 * 2.0 ** (e - 7)).astype(np.float32)


def _jax_weight_only(x, q, s, dtype):
    """The JAX weight-only predict's product: ``dequantize_int8`` in the
    compute dtype, then the matmul."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    w = jim.dequantize_int8({"W": jnp.asarray(q)}, {"W": s}, jd)["W"]
    return np.asarray(jnp.matmul(jnp.asarray(x, jd), w).astype(jnp.float32))


def _hold_to_jax_predict(got, want, dtype):
    top = np.abs(want).max()
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= 1e-6 * top, diff.max() / top
        return
    assert diff.max() <= _bf16_step(top), (diff.max(), _bf16_step(top))
    assert (diff > 0).mean() <= 0.01, f"{(diff > 0).mean():.1%} differ"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 17, 64])
@pytest.mark.parametrize("n", [2, 8, 130])
def test_int8_matmul_dequantize_first_matches_jax_predict(dtype, m, n):
    rng = np.random.default_rng(m * 7 + n)
    k = 256
    x = rng.normal(size=(m, k)).astype(np.float32)
    q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = _near_half_step_scales(rng, n)
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got = pq.int8_matmul(torch.from_numpy(x).to(td), torch.from_numpy(q),
                         torch.from_numpy(s), dequantize_first=True)
    assert got.dtype == td and got.shape == (m, n)
    _hold_to_jax_predict(got.float().numpy(),
                         _jax_weight_only(x, q, s, dtype), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_only_dense_rounds_weights_as_the_jax_predict(dtype):
    """``dense`` on an int8 W forms each weight as the JAX predict does
    (bf16(q) * bf16(s), rounded to bf16, before the product); scaling the
    f32 product after the reduction instead fails the bf16 case."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 40, 256)).astype(np.float32)
    q = rng.integers(-127, 128, (256, 96)).astype(np.int8)
    s = _near_half_step_scales(rng, 96)
    cd = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got = pcore.dense(torch.from_numpy(x), torch.from_numpy(q), None, cd,
                      torch.from_numpy(s))
    assert got.dtype == cd and got.shape == (3, 40, 96)
    want = _jax_weight_only(x.reshape(-1, 256), q, s, dtype)
    _hold_to_jax_predict(got.float().reshape(-1, 96).numpy(), want, dtype)


# ---------------------------------------------------------------------------
# quantize_int8, _quantize_layer_entry
# ---------------------------------------------------------------------------

def _leaves():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(40, 64)).astype(np.float32)
    w[:, 5] = 0.0                                  # a zero column: scale 1
    return {
        "dense": {"W": w, "b": rng.normal(size=(64,)).astype(np.float32)},
        "w511": {"W": rng.normal(size=(7, 73)).astype(np.float32)},
        "w512": {"W": rng.normal(size=(8, 64)).astype(np.float32)},
        "bias512": rng.normal(size=(512,)).astype(np.float32),
        "bias511": rng.normal(size=(511,)).astype(np.float32),
        "cube": rng.normal(size=(4, 8, 16)).astype(np.float32),
        "ids": rng.integers(0, 9, (600,)).astype(np.int32),
        "table": (rng.normal(size=(99, 32)) * 0.02).astype(np.float32),
    }


def _assert_same_bits(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same_bits(got[k], want[k], f"{path}/{k}")
        return
    if want is None:
        assert got is None, path
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert got.tobytes() == want.tobytes(), path


def test_quantize_int8_is_bit_equal_to_jax():
    tree = _leaves()
    q_jax, s_jax = jim.quantize_int8(tree)
    q, s = pim.quantize_int8(tree)
    _assert_same_bits(q, q_jax)
    _assert_same_bits(s, s_jax)
    # the 512 threshold: 511 entries stay float, 512 quantize
    assert s["w511"]["W"] is None and s["bias511"] is None
    assert q["w512"]["W"].dtype == np.int8 and s["w512"]["W"].shape == (64,)
    assert s["bias512"].shape == (1,)             # 1-D: one scale, (1,)
    assert s["dense"]["W"][5] == 1.0
    for dtype, jd in ((torch.float32, jnp.float32),
                      (torch.bfloat16, jnp.bfloat16)):
        want = jim.dequantize_int8({"t": q_jax["table"]},
                                   {"t": s_jax["table"]}, jd)["t"]
        got = pim.dequantize_int8({"t": q["table"]}, {"t": s["table"]},
                                  dtype)["t"]
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_quantize_layer_entry_is_bit_equal_to_jax():
    sub = _leaves()["dense"]
    _assert_same_bits(pim._quantize_layer_entry(sub, 0.0123),
                      jim._quantize_layer_entry(sub, 0.0123))


# ---------------------------------------------------------------------------
# InferenceModel: weight-only int8
# ---------------------------------------------------------------------------

def _head_pair(d_in=48):
    """A small Sequential head in both packages on the same weights: a
    quantized W (48 x 600) and bias (600), a quantized W (600 x 8) and a
    W under the 512 threshold (8 x 5)."""
    jm = JaxSequential([jl.Dense(600, activation="relu", input_shape=(d_in,)),
                        jl.Dense(8, activation="relu"),
                        jl.Dense(5, activation="softmax")])
    jm.init_weights(rng=jax.random.key(4))
    pm = Sequential([Dense(600, activation="relu", input_shape=(d_in,)),
                     Dense(8, activation="relu"),
                     Dense(5, activation="softmax")], device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
    return jm, pm


def _bert_pair(num_classes=2):
    jm = JaxBERTClassifier(num_classes, **BERT_CFG)
    jm.init_weights(rng=jax.random.key(11))
    pm = BERTClassifier(num_classes, **BERT_CFG, device="cpu")
    load_jax_params(pm, jax.tree.map(np.asarray, jm.params))
    return jm, pm


def _bert_rows(n, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, BERT_CFG["vocab"], (n, BERT_CFG["seq_len"])
                       ).astype(np.int32)
    lens = rng.integers(3, BERT_CFG["seq_len"] + 1, n)
    ids[np.arange(BERT_CFG["seq_len"])[None, :] >= lens[:, None]] = 0
    return make_bert_inputs(ids, attention_mask=(ids != 0))


def _count_k6(monkeypatch, epilogues=None):
    """Count ``dense``'s calls of K6 (on the CPU, its plain version): each
    call's weight shape, and into ``epilogues`` (a list, if given) whether
    it carried a bias and ``relu``."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[1].shape)
        if epilogues is not None:
            epilogues.append((kwargs.get("bias") is not None,
                              kwargs.get("relu", False)))
        return pq.int8_matmul(*args, **kwargs)
    monkeypatch.setattr(pcore, "int8_matmul", counted)
    return calls


@pytest.mark.parametrize("policy,runtime", [("float32", "float32"),
                                            ("float32", "bfloat16"),
                                            ("bfloat16", "float32")])
def test_weight_only_head_matches_jax(policy, runtime, monkeypatch):
    _policy(policy)
    jm, pm = _head_pair()
    x = np.random.default_rng(1).normal(size=(11, 48)).astype(np.float32)
    want = np.asarray(JaxIM().from_keras(jm, dtype=runtime,
                                         quantize="int8").predict(x))
    im = InferenceModel(device="cpu").from_keras(pm, dtype=runtime,
                                                 quantize="int8")
    calls = _count_k6(monkeypatch)
    got = im.predict(x)
    tol = TOL["bfloat16" if "bfloat16" in (policy, runtime) else "float32"]
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    # the two quantized kernels stay int8 and run K6; the 8 x 5 one is float
    assert calls == [(48, 600), (600, 8)]
    net = im._model
    assert net.dense_0.W.dtype == torch.int8
    assert net.dense_0.w_scale.dtype == torch.float32
    assert net.dense_2.W.dtype == (torch.bfloat16 if runtime == "bfloat16"
                                   else torch.float32)
    # the caller's model is untouched
    assert pm.dense_0.W.dtype == torch.float32
    # int8 W plus one f32 scale per column against the f32 weights
    assert im.memory_bytes() < 0.3 * InferenceModel(
        device="cpu").from_keras(pm).memory_bytes()


@pytest.mark.parametrize("policy,runtime", [("float32", "float32"),
                                            ("float32", "bfloat16"),
                                            ("bfloat16", "float32")])
def test_weight_only_bert_matches_jax(policy, runtime, monkeypatch):
    """Every encoder product and the pooler and head run K6; the tables,
    LayerNorms and large biases are dequantized once at load, to the bits
    the JAX package's predict computes."""
    _policy(policy)
    jm, pm = _bert_pair()
    x = _bert_rows(10)
    jax_im = JaxIM().from_keras(jm, dtype=runtime, quantize="int8")
    want = np.asarray(jax_im.predict(x))
    im = InferenceModel(device="cpu").from_keras(pm, dtype=runtime,
                                                 quantize="int8")
    calls = _count_k6(monkeypatch)
    got = im.predict(x)
    tol = TOL["bfloat16" if "bfloat16" in (policy, runtime) else "float32"]
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert len(calls) == 4 * BERT_CFG["n_block"] + 2    # + pooler + head
    deq = jim.dequantize_int8(jax_im._params, jax_im._scales,
                              jnp.bfloat16 if runtime == "bfloat16"
                              else jnp.float32)
    bert = im._model.model.bert
    for name in ("word", "position"):
        np.testing.assert_array_equal(
            getattr(bert, name).float().numpy(),
            np.asarray(deq["bert"][name], np.float32))
    np.testing.assert_array_equal(
        bert.block0.ln1.gamma.float().numpy(),
        np.asarray(deq["bert"]["block0"]["ln1"]["gamma"], np.float32))
    assert bert.block0.attn.qkv.W.dtype == torch.int8


# ---------------------------------------------------------------------------
# InferenceModel: static int8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_static_int8_head_matches_jax(policy):
    _policy(policy)
    jm, pm = _head_pair()
    x = np.random.default_rng(2).normal(size=(13, 48)).astype(np.float32)
    jax_im = JaxIM().from_keras(jm, quantize="int8", calibrate=x[:8])
    im = InferenceModel(device="cpu").from_keras(pm, quantize="int8",
                                                 calibrate=x[:8])
    assert set(im._act_scales) == set(jax_im._act_scales) \
        == {"dense_0", "dense_1", "dense_2"}
    assert im._act_scales["dense_0"] == jax_im._act_scales["dense_0"]
    for name, (scale, shape) in jax_im._act_scales.items():
        assert im._act_scales[name][1] == shape
        np.testing.assert_allclose(im._act_scales[name][0], scale,
                                   rtol=1e-6, atol=0)
        layer = getattr(im._model, name)
        want = jax_im._params[name]
        for key in ("W", "w_scale"):
            got = getattr(layer, key).numpy()
            assert got.dtype == np.asarray(want[key]).dtype
            np.testing.assert_array_equal(got, np.asarray(want[key]))
        assert layer.x_scale.dtype == torch.float32
    np.testing.assert_allclose(im.predict(x), np.asarray(jax_im.predict(x)),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(im.predict(x),
                               InferenceModel(device="cpu").from_keras(
                                   pm).predict(x), atol=0.05, rtol=0)


def test_static_int8_on_bert_calibrates_only_the_head_as_jax_does():
    """DenseParams has no ``quantized_call`` and is not a dispatched layer,
    so calibration records only the ``cls`` Dense. In both packages the
    rewrite then matches the param tree's key ``cls`` against the layer's
    name ``<model>_net_cls``, which differ, so no weight is rewritten and
    the output is the float model's."""
    jm, pm = _bert_pair()
    x = _bert_rows(8, seed=5)
    jax_im = JaxIM().from_keras(jm, quantize="int8", calibrate=x)
    im = InferenceModel(device="cpu").from_keras(pm, quantize="int8",
                                                 calibrate=x)
    assert len(im._act_scales) == len(jax_im._act_scales) == 1
    (name, (scale, shape)), = im._act_scales.items()
    (jname, (jscale, jshape)), = jax_im._act_scales.items()
    assert name.endswith("_net_cls") and jname.endswith("_net_cls")
    assert shape == jshape == (BERT_CFG["hidden_size"], 2)
    np.testing.assert_allclose(scale, jscale, rtol=1e-6, atol=0)
    assert not InferenceModel._quantizable(DenseParams(4, 4))
    assert InferenceModel._quantizable(Dense(4))
    assert not any(b.dtype == torch.int8 for b in im._model.buffers())
    np.testing.assert_allclose(im.predict(x), np.asarray(jax_im.predict(x)),
                               atol=1e-5, rtol=0)


def test_from_keras_refusals_match_jax():
    jm, pm = _head_pair()
    x = np.ones((4, 48), np.float32)
    for im, model in ((JaxIM(), jm), (InferenceModel(device="cpu"), pm)):
        with pytest.raises(ValueError, match="requires quantize"):
            im.from_keras(model, calibrate=x)
        with pytest.raises(ValueError, match="unknown quantize mode"):
            im.from_keras(model, quantize="int4")
    for im, model in ((JaxIM(), JaxSequential([jl.Activation(
            "relu", input_shape=(4,))])),
            (InferenceModel(device="cpu"), Sequential(
                [pcore.Activation("relu", input_shape=(4,))],
                device="cpu"))):
        with pytest.raises(ValueError, match="no quantizable layer"):
            im.from_keras(model, quantize="int8",
                          calibrate=np.ones((2, 4), np.float32))


# ---------------------------------------------------------------------------
# the ZooModel .npz format, both ways
# ---------------------------------------------------------------------------

def _ncf_pair():
    jm = JaxNeuralCF(30, 40, 5, user_embed=8, item_embed=8,
                     hidden_layers=(16, 8), mf_embed=8)
    jm.init_weights(rng=jax.random.key(2))
    pm = NeuralCF(30, 40, 5, user_embed=8, item_embed=8,
                  hidden_layers=(16, 8), mf_embed=8, device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
    pairs = np.stack([np.arange(1, 21), np.arange(5, 25)], 1).astype(np.int32)
    return jm, pm, pairs


@pytest.mark.parametrize("kind", ["bert", "ncf"])
def test_npz_written_by_jax_loads_into_the_port(kind, tmp_path):
    if kind == "bert":
        jm, _ = _bert_pair()
        x = _bert_rows(6, seed=7)
    else:
        jm, _, x = _ncf_pair()
    want = np.asarray(JaxIM().from_keras(jm).predict(x))
    path = jm.save(str(tmp_path / "jax_model"))
    pm = load_model(path, device="cpu")
    assert type(pm).__name__ == type(jm).__name__
    assert pm.get_config() == jm.get_config()
    np.testing.assert_allclose(InferenceModel(device="cpu").from_keras(
        pm).predict(x), want, atol=1e-5, rtol=0)
    # and straight into the runtime, on the int8 path
    got = InferenceModel(device="cpu").load(path, quantize="int8").predict(x)
    np.testing.assert_allclose(got, np.asarray(JaxIM().load(
        path, quantize="int8").predict(x)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["bert", "ncf"])
def test_npz_written_by_the_port_loads_into_jax(kind, tmp_path):
    if kind == "bert":
        _, pm = _bert_pair()
        x = _bert_rows(6, seed=8)
    else:
        _, pm, x = _ncf_pair()
    with torch.no_grad():                 # weights the JAX init cannot have
        for p in pm.parameters():
            p.add_(0.01)
    want = InferenceModel(device="cpu").from_keras(pm).predict(x)
    path = pm.save(str(tmp_path / "port_model"))
    with pytest.raises(FileExistsError):
        pm.save(path, over_write=False)
    jm = jax_load_model(path)
    assert jm.get_config() == pm.get_config()
    np.testing.assert_allclose(np.asarray(JaxIM().from_keras(jm).predict(x)),
                               want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# ClusterServing: the serving dtype and _wrap_model
# ---------------------------------------------------------------------------

def _serve(server_cls, inq_cls, outq_cls, backend, model, rows, **kw):
    server = server_cls(model, backend=backend, batch_size=4, **kw).start()
    try:
        q = inq_cls(backend)
        for i, r in enumerate(rows):
            q.enqueue(f"r-{i}", r)
        out = outq_cls(backend)
        got = np.stack([out.query(f"r-{i}", timeout=60)
                        for i in range(len(rows))])
    finally:
        server.stop()
    return server, got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_bare_model_is_served_on_the_serving_dtype_like_jax(dtype):
    jm, pm = _head_pair()
    rows = np.random.default_rng(9).normal(size=(10, 48)).astype(np.float32)
    _, want = _serve(JaxClusterServing, JaxInputQueue, JaxOutputQueue,
                     JaxLocalBackend(), jm, rows, dtype=dtype)
    server, got = _serve(ClusterServing, InputQueue, OutputQueue,
                         LocalBackend(), pm, rows, dtype=dtype)
    assert isinstance(server.model, InferenceModel)
    assert server.model._quantize == ("int8" if dtype == "int8" else None)
    assert server.model._dtype == (torch.bfloat16 if dtype == "bfloat16"
                                   else torch.float32)
    assert server.served == len(rows)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL[
        "bfloat16" if dtype == "bfloat16" else "float32"], rtol=0)


def test_serving_dtype_comes_from_the_conf_key():
    _, pm = _head_pair()
    assert ClusterServing(pm, backend=LocalBackend()).dtype == "float32"
    pctx.init_zoo_context(conf={"zoo.serving.dtype": "int8"})
    server = ClusterServing(pm, backend=LocalBackend())
    assert server.dtype == "int8" and server.model._quantize == "int8"
    # an explicit dtype= wins over the conf key
    assert ClusterServing(pm, backend=LocalBackend(),
                          dtype="bf16").model._dtype == torch.bfloat16


def test_wrap_model_passes_other_models_through():
    _, pm = _head_pair()
    im = InferenceModel(device="cpu").from_keras(pm)

    class PredictOnly:
        def predict(self, x):
            return x

    plain = PredictOnly()
    for dtype in ("float32", "int8"):
        assert ClusterServing._wrap_model(im, dtype) is im
        assert ClusterServing._wrap_model(plain, dtype) is plain
        assert JaxClusterServing._wrap_model(plain, dtype) is plain


def _serve_lanes(server_cls, inq_cls, outq_cls, backend, lanes, rows):
    """``rows`` alternate between the lanes ``"f"`` and ``"q"``; returns
    the server and the answers in row order."""
    server = server_cls(lanes, backend=backend, batch_size=4).start()
    try:
        q = inq_cls(backend)
        for i, r in enumerate(rows):
            q.enqueue(f"r-{i}", r, model="fq"[i % 2])
        out = outq_cls(backend)
        got = np.stack([out.query(f"r-{i}", timeout=60)
                        for i in range(len(rows))])
    finally:
        server.stop()
    return server, got


def test_unknown_serving_dtype_is_refused_and_a_lane_dict_serves():
    """The dtype refusal with JAX's message, and a lane dict — a float32
    lane and an int8 lane on the same head — serving each record on its
    own lane's path as the JAX server does."""
    jm, pm = _head_pair()
    with pytest.raises(ValueError, match="unknown serving dtype") as got:
        ClusterServing(pm, backend=LocalBackend(), dtype="fp17")
    with pytest.raises(ValueError, match="unknown serving dtype") as want:
        JaxClusterServing(pm, backend=JaxLocalBackend(), dtype="fp17")
    assert str(got.value) == str(want.value)
    rows = np.random.default_rng(12).normal(size=(10, 48)).astype(
        np.float32)
    _, want = _serve_lanes(JaxClusterServing, JaxInputQueue, JaxOutputQueue,
                           JaxLocalBackend(), {
                               "f": jm, "q": {"model": jm, "dtype": "int8"}},
                           rows)
    server, got = _serve_lanes(ClusterServing, InputQueue, OutputQueue,
                               LocalBackend(), {
                                   "f": pm,
                                   "q": {"model": pm, "dtype": "int8"}},
                               rows)
    assert server._lanes["f"].model._quantize is None
    assert server._lanes["q"].model._quantize == "int8"
    assert server.served == len(rows)
    np.testing.assert_allclose(got, want, atol=TOL["float32"], rtol=0)
    # the lanes differ: the int8 lane answers on its own weights
    f_only = InferenceModel(device="cpu").from_keras(pm).predict(rows[1::2])
    assert np.abs(got[1::2] - f_only).max() > TOL["float32"]


# ---------------------------------------------------------------------------
# K6's fused epilogue (bias, ReLU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("m", [1, 7, 32])
@pytest.mark.parametrize("n", [2, 8, 130])
def test_int8_matmul_epilogue_is_dense_bias_then_relu_bit_for_bit(
        dtype, first, m, n):
    """K6's plain version with ``bias``/``relu`` gives the bits of the
    unfused sequence the port ran before the fusion: the product, then
    ``dense``'s bias add in the compute dtype, then ``Dense``'s ReLU (and
    ``dense(..., relu=True)`` the bits of ``dense`` followed by it)."""
    rng = np.random.default_rng(m * 1000 + n * 10 + first)
    k = 96
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(td)
    q = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    s = torch.from_numpy(_near_half_step_scales(rng, n))
    b = torch.from_numpy(rng.normal(size=n).astype(np.float32) * 3.0)
    bits = torch.int16 if td == torch.bfloat16 else torch.int32
    relu = pcore.ACTIVATIONS["relu"]
    for bias, with_relu in ((b, False), (None, True), (b, True)):
        got = pq.int8_matmul(x, q, s, first, bias=bias, relu=with_relu)
        want = pq.int8_matmul(x, q, s, first)
        if bias is not None:
            want = want + bias.to(td)
        if with_relu:
            want = relu(want)
        assert got.dtype == td and got.shape == (m, n)
        assert torch.equal(got.view(bits), want.view(bits))
    fused = pcore.dense(x, q, b, td, s, relu=True)
    unfused = relu(pcore.dense(x, q, b, td, s))
    assert torch.equal(fused.view(bits), unfused.view(bits))


def _relu_head_pair(d_in=48):
    """Two weight-only quantized Dense(relu) layers and a quantized
    Dense(softmax) head (64 x 8 = 512 weights) in both packages."""
    jm = JaxSequential([jl.Dense(600, activation="relu", input_shape=(d_in,)),
                        jl.Dense(64, activation="relu"),
                        jl.Dense(8, activation="softmax")])
    jm.init_weights(rng=jax.random.key(6))
    pm = Sequential([Dense(600, activation="relu", input_shape=(d_in,)),
                     Dense(64, activation="relu"),
                     Dense(8, activation="softmax")], device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
    return jm, pm


@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("policy,runtime", [("float32", "float32"),
                                            ("float32", "bfloat16")])
def test_weight_only_relu_head_fuses_its_epilogue_and_matches_jax(
        batch, policy, runtime, monkeypatch):
    """A weight-only int8 Sequential of Dense(relu) layers and a
    Dense(softmax) head at batch 1 and 32: the predict still matches the
    JAX weight-only predict (the file's tolerances), each Dense(relu)
    hands its bias and ReLU to K6, and the softmax head only its bias."""
    _policy(policy)
    jm, pm = _relu_head_pair()
    x = np.random.default_rng(batch).normal(size=(batch, 48)).astype(
        np.float32)
    want = np.asarray(JaxIM().from_keras(jm, dtype=runtime,
                                         quantize="int8").predict(x))
    im = InferenceModel(device="cpu").from_keras(pm, dtype=runtime,
                                                 quantize="int8")
    epilogues = []
    calls = _count_k6(monkeypatch, epilogues)
    got = im.predict(x)
    tol = TOL["bfloat16" if "bfloat16" in (policy, runtime) else "float32"]
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert calls == [(48, 600), (600, 64), (64, 8)]
    assert epilogues == [(True, True), (True, True), (True, False)]


# ---------------------------------------------------------------------------
# Q8: the static int8 dense layer (fault j)
# ---------------------------------------------------------------------------

def _static_case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, k)) * 3.0).astype(np.float32)
    # x / x_scale lands exactly on .5 for some entries: round half to even
    x[0, :4] = np.array([0.125, -0.375, 0.625, 6.4], np.float32)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    ws = rng.uniform(0.001, 0.02, n).astype(np.float32)
    b = (rng.normal(size=n) * 2.0).astype(np.float32)
    return x, np.float32(0.05), w, ws, b


def _torch_static(x, xs, w, ws, b):
    return (torch.from_numpy(x), torch.tensor(xs), torch.from_numpy(w),
            torch.from_numpy(ws), None if b is None else torch.from_numpy(b))


@pytest.mark.parametrize("bias,relu", [(False, False), (True, False),
                                       (True, True), (False, True)])
@pytest.mark.parametrize("m,k,n", [(1, 96, 8), (7, 96, 130), (32, 64, 8),
                                   (33, 96, 130), (5, 100, 130)])
def test_static_int8_plain_version_is_jax_quantized_call_bit_for_bit(
        m, k, n, bias, relu):
    """Q8's plain version (the static path's torch ops) against the JAX
    ``Dense.quantized_call`` on the same inputs: the same bits (an exact
    int32 product, IEEE division, round half to even, one f32 rescale,
    the f32 bias). K = 100 is not a multiple of 32 or of 8."""
    x, xs, w, ws, b = _static_case(m, k, n, m * 1000 + k + n)
    b = b if bias else None
    layer = jl.Dense(n, activation="relu" if relu else None, bias=bias)
    qp = {"W": jnp.asarray(w), "w_scale": jnp.asarray(ws),
          "x_scale": jnp.asarray(xs)}
    if bias:
        qp["b"] = jnp.asarray(b)
    want = np.asarray(layer.quantized_call(qp, jnp.asarray(x)))
    got = pq.static_int8_dense_reference(*_torch_static(x, xs, w, ws, b),
                                         relu=relu)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    # the wrapper on CPU tensors is its plain version (and refuses nothing
    # above 32 rows there)
    wrapped = pq.static_int8_dense(*_torch_static(x, xs, w, ws, b),
                                   relu=relu)
    assert torch.equal(wrapped.view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("act", ["relu", "softmax", None])
@pytest.mark.parametrize("m", [1, 7, 32, 33, 64])
def test_quantized_call_routes_to_q8_up_to_32_rows(m, act, monkeypatch):
    """``Dense.quantized_call`` hands at most 32 rows to Q8's wrapper (the
    ReLU with them; another activation after it) and more rows to the
    padded ``torch._int_mm`` path; both give the JAX layer's bits."""
    x, xs, w, ws, b = _static_case(m, 48, 8, m)
    calls = {"q8": 0, "plain": 0, "int8_product": 0}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(pcore, "static_int8_dense",
                        counted("q8", pcore.static_int8_dense))
    monkeypatch.setattr(pcore, "static_int8_dense_reference",
                        counted("plain", pcore.static_int8_dense_reference))
    monkeypatch.setattr(pq, "int8_product",
                        counted("int8_product", pq.int8_product))
    layer = Dense(8, activation=act)
    tx, txs, tw, tws, tb = _torch_static(x, xs, w, ws, b)
    layer.W, layer.x_scale, layer.w_scale, layer.b = tw, txs, tws, tb
    got = layer.quantized_call(tx)
    assert calls == {"q8": int(m <= 32), "plain": int(m > 32),
                     "int8_product": 1}
    jlayer = jl.Dense(8, activation=act)
    want = np.asarray(jlayer.quantized_call(
        {"W": jnp.asarray(w), "w_scale": jnp.asarray(ws),
         "x_scale": jnp.asarray(xs), "b": jnp.asarray(b)}, jnp.asarray(x)))
    if act == "softmax":   # two softmax implementations: rounding only
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))


def test_static_int8_dense_refuses_what_q8_does_not_take():
    x, xs, w, ws, b = _torch_static(*_static_case(2, 16, 4, 0))
    with pytest.raises(ValueError, match="shape mismatch"):
        pq.static_int8_dense(x, xs, w[:8], ws, b)
    with pytest.raises(ValueError, match="shape mismatch"):
        pq.static_int8_dense(x, xs, w, ws[:2], b)
    with pytest.raises(ValueError, match="shape mismatch"):
        pq.static_int8_dense(x, torch.ones(2), w, ws, b)
    with pytest.raises(TypeError, match="int8"):
        pq.static_int8_dense(x, xs, w.float(), ws, b)
    with pytest.raises(TypeError, match="float"):
        pq.static_int8_dense(w, xs, torch.ones(4, 4, dtype=torch.int8),
                             torch.ones(4), None)
    assert pq.KERNEL_INT8_STATIC.launches == 0   # CPU: no launch counted


# ---------------------------------------------------------------------------
# Q8's launch plan and its K-major weight
# ---------------------------------------------------------------------------

#: ``chip_smoke.py``'s Q8 cases (``STATIC_CASES``) and VGG-16's fc6 and fc8
#: at 1 and 32 rows: the plan on the H100's 132 SMs, (route, K splits, per)
Q8_PLANS = {
    (1, 4096, 4096): ("q8_dp4a", 16, 256),
    (7, 4096, 4096): ("q8_wgmma_xq", 4, 8),
    (32, 4096, 4096): ("q8_wgmma_xq", 4, 8),
    (1, 4096, 8): ("q8_dp4a", 64, 64),
    (32, 4096, 8): ("q8_wgmma_xq", 8, 4),
    (5, 1000, 4096): ("q8_dp4a", 16, 64),
    (32, 256, 128): ("q8_wgmma_xq", 1, 2),
    (32, 128, 20): ("q8_wgmma_xq", 1, 1),
    (1, 25088, 4096): ("q8_dp4a", 49, 512),
    (32, 25088, 4096): ("q8_wgmma_xq", 4, 49),
    (1, 4096, 1000): ("q8_dp4a", 64, 64),
    (32, 4096, 1000): ("q8_wgmma_xq", 8, 4),
}


@pytest.mark.parametrize("shape", list(Q8_PLANS), ids=str)
def test_q8_plan_routes_by_work(shape):
    """The route and K splits Q8's host plan picks for each case, and what
    holds for any plan: the splits cover K and none is empty, the dp4a
    slices are whole 64-row steps of at most 512, the tensor-core route
    takes K % 16 == 0 from ``STATIC_WGMMA_MIN_M`` rows in at most
    ``STATIC_WGMMA_MAX_SPLITS`` splits (one cluster), and only dp4a's
    splits and the quantize pass take a workspace."""
    m, k, n = shape
    route, splits, per = pq.static_plan(m, k, n, 132)
    assert (route, splits, per) == Q8_PLANS[shape]
    if route == "q8_dp4a":
        assert per % 64 == 0 and 64 <= per <= 512
        assert splits == -(-k // per)
    else:
        steps = -(-k // 128)
        assert (splits - 1) * per < steps <= splits * per
        assert splits <= pq.STATIC_WGMMA_MAX_SPLITS
        assert m >= pq.STATIC_WGMMA_MIN_M and pq.static_takes_wgmma(k)
    ints = pq.static_workspace(m, k, n, route, splits, per)
    want = {"q8_dp4a": splits * m * -(-n // 128) * 128 if splits > 1 else 0,
            "q8_wgmma_xq": m * k // 4}[route]
    assert ints == want


def test_q8_plan_crosses_to_the_tensor_cores_at_its_row_and_k_limits():
    """The plan's two edges: ``q8_dp4a`` up to one row under
    ``STATIC_WGMMA_MIN_M``, ``q8_wgmma_xq`` from it, and a K that x's
    quantized rows cannot fill in whole 16-byte chunks stays on dp4a at
    any row count; each route's own plan is the one the rule returns."""
    edge = pq.STATIC_WGMMA_MIN_M
    assert pq.static_plan(edge - 1, 4096, 4096, 132)[0] == "q8_dp4a"
    assert pq.static_plan(edge, 4096, 4096, 132)[0] == "q8_wgmma_xq"
    assert pq._plan_dp4a(32, 4096, 4096, 132) == ("q8_dp4a", 8, 512)
    assert pq._plan_wgmma(4, 4096, 4096, 132) == ("q8_wgmma_xq", 4, 8)
    assert pq.static_plan(32, 1000, 4096, 132)[0] == "q8_dp4a"
    assert pq.static_plan(32, 4104, 4096, 132)[0] == "q8_dp4a"
    assert pq.static_plan(32, 4112, 4096, 132)[0] == "q8_wgmma_xq"
    assert not pq.static_takes_wgmma(0) and pq.static_takes_wgmma(16)


def test_q8_on_the_cpu_is_its_plain_version_on_any_route(monkeypatch):
    """On CPU tensors the wrapper is its plain version whatever route the
    plan names (the plan forced to each in turn), and launches nothing."""
    x, xs, w, ws, b = _torch_static(*_static_case(9, 32, 24, 3))
    want = pq.static_int8_dense_reference(x, xs, w, ws, b, relu=True)
    plans = [None, pq._plan_dp4a(9, 32, 24, 132),
             pq._plan_wgmma(9, 32, 24, 132)]
    assert {p[0] for p in plans[1:]} == set(pq.STATIC_ROUTES)
    for plan in plans:
        with monkeypatch.context() as mp:
            if plan is not None:
                mp.setattr(pq, "static_plan", lambda *a, plan=plan: plan)
            got = pq.static_int8_dense(x, xs, w, ws, b, True)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert pq.KERNEL_INT8_STATIC.launches == 0
    assert all(c.launches == 0 for c in pq.KERNEL_INT8_STATIC_ROUTES.values())


def _static_text_classifier():
    from analytics_zoo_tpu_torch.models.textclassification import \
        TextClassifier
    pctx.init_zoo_context(conf={"zoo.seed": 0})
    m = TextClassifier(5, 16, sequence_length=12, encoder="cnn",
                       encoder_output_dim=32, vocab_size=40, device="cpu")
    m.init_weights(torch.Generator().manual_seed(0))
    x = np.random.default_rng(1).integers(1, 40, (16, 12)).astype(np.int32)
    return m, x


def test_static_int8_sequential_npz_is_the_same_before_and_after_install(
        tmp_path):
    """A static int8 ``Sequential`` (TextClassifier's: Dense(128) on 32
    inputs, Dense(5) on 128): the model's ``.npz`` holds the same arrays
    before and after the install; the served copy holds each Dense's int8
    ``W`` as (K, N) and no second copy of it (Q8's tensor-core routes read
    that layout), and its predict runs Q8 (the plain version here) on
    both layers and leaves the weights as they were."""
    m, x = _static_text_classifier()
    first = m.save(str(tmp_path / "a.npz"))
    im = InferenceModel(device="cpu").from_keras(m, quantize="int8",
                                                 calibrate=x[:8])
    second = m.save(str(tmp_path / "b.npz"))
    with np.load(first) as a, np.load(second) as b:
        assert a.files == b.files
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    dense = [layer for layer in im._model.model.layers
             if type(layer) is Dense]
    assert [tuple(d.W.shape) for d in dense] == [(32, 128), (128, 5)]
    int8 = [n for n, t in im._model.named_buffers() if t.dtype == torch.int8]
    assert len(int8) == 2 and all(n.endswith(".W") for n in int8)
    kept = [d.W.clone() for d in dense]
    calls = []
    real = pcore.static_int8_dense

    def counted(*args, **kwargs):
        calls.append(tuple(args[2].shape))
        return real(*args, **kwargs)
    pcore.static_int8_dense = counted
    try:
        y = im.predict(x)
    finally:
        pcore.static_int8_dense = real
    assert y.shape == (16, 5) and calls == [(32, 128), (128, 5)]
    for d, w in zip(dense, kept):
        assert torch.equal(d.W, w)
