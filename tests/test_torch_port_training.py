"""The port's training path held to the JAX package on numpy-seeded inputs
and transferred weights: the flash-attention backward, every loss, the
optimizers, the FeatureSet batch order, and a whole ``BERTClassifier``
``compile``/``fit``/``evaluate``.

Tolerances, each with its reason:
* flash gradients, f32: 1e-5 absolute (both sides rebuild P from the lse
  and accumulate in f32; only summation order differs); bf16: 2e-2 of
  the case's largest gradient (P and dS round to bf16 at the same points,
  but the forward's bf16 output and lse come from other summation orders,
  so a value near a rounding boundary moves by one bf16 step, 2^-8);
* losses: 1e-6 relative (same f32 formulas);
* optimizers: 1e-6 relative, 1e-7 absolute after several updates (same
  f32 update rules; torch may fuse a multiply-add where XLA rounds twice);
* the BERT fit (``FIT_TOL``): in f32, losses and parameters 1e-5 (the
  same arithmetic in another summation order); in bf16, losses 5e-3 and
  parameters 2e-2 with each leaf's update within 35% (bf16 rounds at
  other places in the two frameworks, so activations differ by bf16
  steps, and AdamW turns every small gradient difference into a move of
  up to ``lr``).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.feature import FeatureSet as JaxFeatureSet
from analytics_zoo_tpu.ops.pallas import flash_attention as jax_flash
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.tfpark.bert_classifier import \
    BERTClassifier as JaxBERTClassifier
from analytics_zoo_tpu.tfpark.bert_classifier import \
    bert_params_from_torch as jax_bert_params_from_torch
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.feature import FeatureSet
from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
    flash_attention, flash_attention_bwd_reference, flash_attention_reference)
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras import metrics as pmet
from analytics_zoo_tpu_torch.pipeline.api.keras import objectives as pobj
from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as popt
from analytics_zoo_tpu_torch.tfpark.bert_classifier import (
    BERTClassifier, bert_params_from_torch, load_jax_params, make_bert_inputs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab=99, hidden_size=32, n_block=2, n_head=4, seq_len=16,
           intermediate_size=64, hidden_drop=0.0, attn_drop=0.0)
BLOCKS = dict(block_q=16, block_k=128)


@pytest.fixture(autouse=True)
def port_context():
    pctx.reset_zoo_context()
    yield
    pctx.reset_zoo_context()
    jeng.set_policy()


# ---------------------------------------------------------------------------
# (a) flash-attention backward
# ---------------------------------------------------------------------------

def _attn_inputs(b, h, tq, tk, d, seed, empty_row=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d)))
    do = rng.normal(size=(b, h, tq, d)).astype(np.float32)
    lens = rng.integers(tk // 3, tk + 1, b)
    mask = (np.arange(tk)[None, :] < lens[:, None]).astype(np.float32)
    if empty_row:
        mask[0] = 0.0
    return q, k, v, do, mask


def _jax_grads(q, k, v, do, mask, causal, dtype=jnp.float32):
    def f(q, k, v):
        out = jax_flash(q, k, v, mask=jnp.asarray(mask), causal=causal,
                        interpret=True, **BLOCKS)
        return jnp.sum(out.astype(jnp.float32)
                       * jnp.asarray(do, dtype).astype(jnp.float32))
    grads = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(a, dtype) for a in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(q, k, v, do, mask, causal, dtype=torch.float32):
    qt, kt, vt = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    out = flash_attention(qt, kt, vt, mask=torch.from_numpy(mask),
                          causal=causal)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (qt, kt, vt),
                                torch.from_numpy(do).to(dtype))
    return [g.float().numpy() for g in grads]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(50, 200), (150, 40), (20, 150)])
def test_flash_grads_match_jax_f32(causal, tq, tk):
    """Several q blocks (block_q=16) and k blocks (block_k=128), key
    padding, causal and both cross lengths."""
    q, k, v, do, mask = _attn_inputs(2, 2, tq, tk, 8, seed=tq + tk)
    for got, want in zip(_port_grads(q, k, v, do, mask, causal),
                         _jax_grads(q, k, v, do, mask, causal)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_grads_of_a_fully_masked_row_are_zero(causal):
    """lse = +inf on the empty batch row: exact zeros, no NaN, on both
    sides; the other row matches JAX."""
    q, k, v, do, mask = _attn_inputs(2, 2, 40, 140, 8, seed=7,
                                     empty_row=True)
    got = _port_grads(q, k, v, do, mask, causal)
    want = _jax_grads(q, k, v, do, mask, causal)
    for g, w in zip(got, want):
        assert np.all(g[0] == 0.0) and np.all(w[0] == 0.0)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_grads_match_jax_bf16(causal):
    q, k, v, do, mask = _attn_inputs(2, 2, 48, 160, 16, seed=5)
    got = _port_grads(q, k, v, do, mask, causal, torch.bfloat16)
    want = _jax_grads(q, k, v, do, mask, causal, jnp.bfloat16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-2 * np.abs(w).max(),
                                   rtol=0)


@pytest.mark.parametrize("causal,tq,tk", [(False, 24, 40), (True, 40, 24),
                                          (True, 24, 40)])
def test_plain_backward_matches_autograd_of_plain_forward(causal, tq, tk):
    q, k, v, do, mask = _attn_inputs(2, 3, tq, tk, 8, seed=tq, empty_row=True)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    m = torch.from_numpy(mask)
    out, lse = flash_attention_reference(qt, kt, vt, m, causal,
                                         want_lse=True)
    want = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    got = flash_attention_bwd_reference(qt.detach(), kt.detach(),
                                        vt.detach(), m, out.detach(),
                                        lse.detach(), torch.from_numpy(do),
                                        causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0)


def test_flash_without_autograd_is_one_forward():
    """No grad recorded: no autograd node, the forward alone."""
    q, k, v, _, mask = _attn_inputs(1, 2, 16, 16, 8, seed=1)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    assert flash_attention(qt, kt, vt, mask=torch.from_numpy(mask)
                           ).grad_fn is None
    with torch.no_grad():
        assert flash_attention(qt.requires_grad_(), kt, vt).grad_fn is None


# ---------------------------------------------------------------------------
# (b) losses
# ---------------------------------------------------------------------------

def _loss_inputs(name, rng):
    b, c = 6, 4
    logits = rng.normal(size=(b, c)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    onehot = np.eye(c, dtype=np.float32)[rng.integers(0, c, b)]
    if name in ("scce", "sparse_categorical_crossentropy"):
        return np.array([0, 3, -1, 4, -5, 2], np.int32), probs
    if name == "scce_with_logits":
        return np.array([1, -4, 2, 7, 0, 3], np.int32), logits
    if name in ("cce", "categorical_crossentropy", "kld",
                "kullback_leibler_divergence"):
        return onehot, probs
    if name == "cce_with_logits":
        return onehot, logits
    if name in ("bce", "binary_crossentropy"):
        return (rng.random((b, 1)) > 0.5).astype(np.float32), \
            1 / (1 + np.exp(-logits[:, :1]))
    if name == "bce_with_logits":
        return (rng.random((b, 1)) > 0.5).astype(np.float32), logits[:, :1]
    if name in ("hinge", "squared_hinge"):
        return np.sign(rng.normal(size=(b, c))).astype(np.float32), logits
    if name == "poisson":
        return rng.random((b, c)).astype(np.float32), probs
    return rng.normal(size=(b, c)).astype(np.float32) ** 2, \
        np.abs(logits)


@pytest.mark.parametrize("name", sorted(pobj.LOSSES))
def test_loss_matches_jax(name):
    """Every loss and its per-example form; sparse labels out of range
    follow JAX's gather (wrap once below 0, NaN beyond)."""
    assert sorted(pobj.LOSSES) == sorted(jobj.LOSSES)
    y_true, y_pred = _loss_inputs(name, np.random.default_rng(len(name)))
    want = np.asarray(jobj.get_loss(name)(jnp.asarray(y_true),
                                          jnp.asarray(y_pred)))
    got = pobj.get_loss(name)(torch.from_numpy(y_true),
                              torch.from_numpy(y_pred)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    pe_j = jobj.per_example_loss(name)
    pe_p = pobj.per_example_loss(name)
    assert (pe_j is None) == (pe_p is None)
    if pe_p is not None:
        np.testing.assert_allclose(
            pe_p(torch.from_numpy(y_true), torch.from_numpy(y_pred)).numpy(),
            np.asarray(pe_j(jnp.asarray(y_true), jnp.asarray(y_pred))),
            rtol=1e-6, atol=1e-7)


def test_unknown_loss_and_unported_pieces_raise():
    with pytest.raises(ValueError, match="unknown loss"):
        pobj.get_loss("nope")
    with pytest.raises(NotImplementedError, match="not ported"):
        popt.get_optimizer("rmsprop")
    with pytest.raises(NotImplementedError, match="not ported"):
        pmet.get_metric("auc")


def test_accuracy_masks_padded_rows():
    acc = pmet.get_metric("accuracy")
    y = torch.tensor([0, 1, 1, 0])
    yp = torch.tensor([[0.9, 0.1], [0.2, 0.8], [0.7, 0.3], [0.1, 0.9]])
    s = acc.update(y, yp, torch.tensor([1.0, 1.0, 1.0, 0.0]))
    assert float(s["correct"]) == 2.0 and float(s["count"]) == 3.0
    assert acc.finalize({k: float(v) for k, v in s.items()}) == 2.0 / 3.0


# ---------------------------------------------------------------------------
# (c) optimizers
# ---------------------------------------------------------------------------

_OPT_CASES = {
    "sgd": lambda m: m.sgd(lr=0.1),
    "sgd_momentum": lambda m: m.sgd(lr=0.05, momentum=0.9),
    "sgd_nesterov_decay": lambda m: m.sgd(lr=0.05, momentum=0.8,
                                          nesterov=True, decay=0.1),
    "adam": lambda m: m.adam(lr=0.01),
    "adam_poly": lambda m: m.adam(lr=0.01, schedule="poly",
                                  max_iterations=4, power=0.5),
    "adam_warmup_linear": lambda m: m.adam(lr=0.01, schedule="warmup_linear",
                                           warmup_steps=2, total_steps=5),
    "adamw": lambda m: m.get_optimizer("adamw", lr=0.01),
    "adamw_warmup": lambda m: m.adam_weight_decay(
        lr=0.01, warmup_portion=0.4, total=5, weight_decay=0.1),
    "adamw_clipped": lambda m: m.with_clipping(
        m.adam_weight_decay(lr=0.01), clip_norm=0.5, clip_value=0.3),
    "sgd_clip_norm_high": lambda m: m.with_clipping(m.sgd(lr=0.1),
                                                    clip_norm=100.0),
}


@pytest.mark.parametrize("case", sorted(_OPT_CASES))
def test_optimizer_matches_optax(case):
    """Six updates on the same params and gradients as the JAX package's
    optax transformation."""
    rng = np.random.default_rng(len(case))
    shapes = {"W": (5, 3), "b": (3,), "emb": (7, 2)}
    params = {n: rng.normal(size=s).astype(np.float32)
              for n, s in shapes.items()}
    grads = [{n: rng.normal(size=s).astype(np.float32)
              for n, s in shapes.items()} for _ in range(6)]
    jo = _OPT_CASES[case](jopt)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    js = jo.init(jp)
    po = _OPT_CASES[case](popt)
    pp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    ps = po.init(pp)
    for g, jg in zip(grads, jax.tree.map(jnp.asarray, grads)):
        upd, js = jo.update(jg, js, jp)
        jp = optax.apply_updates(jp, upd)
        pu, _ = po.update({n: torch.from_numpy(a.copy())
                           for n, a in g.items()}, ps, pp)
        popt.apply_updates(pp, pu)
    for n in shapes:
        np.testing.assert_allclose(pp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


# ---------------------------------------------------------------------------
# (d) FeatureSet batch order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shuffle", [True, False])
def test_feature_set_batch_order_matches_jax(shuffle):
    rng = np.random.default_rng(0)
    x = [rng.normal(size=(37, 3)).astype(np.float32),
         np.arange(37, dtype=np.int32)]
    y = rng.integers(0, 2, 37).astype(np.int32)
    pfs = FeatureSet.array(x, y, shuffle=shuffle, seed=3)
    jfs = JaxFeatureSet.array(x, y, shuffle=shuffle, seed=3)
    assert pfs.steps_per_epoch(8) == jfs.steps_per_epoch(8) == 4
    for epoch in range(1, 4):
        got = list(pfs.iter_batches(8, epoch=epoch))
        want = list(jfs.iter_batches(8, epoch=epoch))
        assert len(got) == len(want) == 4
        for (gx, gy), (wx, wy) in zip(got, want):
            for a, b in zip(gx, wx):
                np.testing.assert_array_equal(a, np.asarray(b))
            np.testing.assert_array_equal(gy, np.asarray(wy))


# ---------------------------------------------------------------------------
# (e) the slice: BERTClassifier compile/fit/evaluate against the JAX fit
# ---------------------------------------------------------------------------

def _data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, CFG["vocab"], (n, CFG["seq_len"])).astype(np.int32)
    lens = rng.integers(5, CFG["seq_len"] + 1, n)
    ids[np.arange(CFG["seq_len"])[None, :] >= lens[:, None]] = 0
    y = rng.integers(0, 3, n).astype(np.int32)
    return make_bert_inputs(ids, attention_mask=(ids != 0)), y


def _np_params(module):
    return {n.replace(".", "/"): p.detach().float().numpy()
            for n, p in module.named_parameters()}


#: per-dtype bounds of the BERT fit (see the module docstring): on the
#: per-epoch and evaluate losses, on every parameter (absolute), on each
#: leaf's update p_final - p_init (norm of the difference over the norm
#: of JAX's update), and on the evaluate accuracy (fraction of records)
FIT_TOL = {
    "float32": dict(loss=1e-5, param=1e-5, update=1e-3, acc=0.0),
    "bfloat16": dict(loss=5e-3, param=2e-2, update=0.35, acc=1.0 / 16),
}
#: the key third of each fused qkv bias has an exact gradient of zero
#: (softmax ignores a score shift shared by every key), so both sides
#: compute rounding noise there, which AdamW (eps 1e-6) turns into moves
#: of up to about lr per step in either direction on each side: held at
#: 2 x 8 steps x lr instead
KEY_BIAS_TOL = 2 * 8 * 1e-3


def _split_key_bias(name, a):
    """``(rest, key_bias)`` of a leaf: the key third of a ``qkv/b``."""
    if not name.endswith("qkv/b"):
        return a, None
    h = a.shape[-1] // 3
    return np.concatenate([a[:h], a[2 * h:]]), a[h:2 * h]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_fit_matches_jax(dtype):
    """Same weights, same shuffled batch order (zoo.seed + epoch), AdamW,
    two epochs of four steps; then evaluate with a padded tail batch."""
    tol = FIT_TOL[dtype]
    conf = {"zoo.pallas.attention": True, "zoo.seed": 0}
    jctx.init_zoo_context(conf=conf)
    pctx.init_zoo_context(conf=conf)
    if dtype == "bfloat16":
        jeng.set_policy(compute_dtype=jnp.bfloat16)
        peng.set_policy(compute_dtype=torch.bfloat16)
    jm = JaxBERTClassifier(3, **CFG)
    jm.init_weights(rng=jax.random.key(11))
    p0 = peng.flatten_tree(jax.tree.map(np.asarray, jm.params))
    pm = BERTClassifier(3, **CFG, device="cpu")
    load_jax_params(pm, jax.tree.map(np.asarray, jm.params))
    x, y = _data()
    jm.compile(optimizer="adamw", loss="scce", metrics=["accuracy"], lr=1e-3)
    pm.compile(optimizer="adamw", loss="scce", metrics=["accuracy"], lr=1e-3)
    want = jm.fit(x, y, batch_size=8, nb_epoch=2)["loss"]
    records = []
    got = pm.fit(x, y, batch_size=8, nb_epoch=2,
                 callbacks=[records.append])["loss"]
    assert [r["epoch"] for r in records] == [1, 2]
    assert [r["iteration"] for r in records] == [4, 8]
    np.testing.assert_allclose(got, want, atol=tol["loss"], rtol=0)
    jp = peng.flatten_tree(jax.tree.map(np.asarray, jm.params))
    pp = _np_params(pm.model)
    assert sorted(jp) == sorted(pp)
    for name in jp:
        (g, g_kb), (w, w_kb), (w0, _) = (_split_key_bias(name, a) for a in
                                         (pp[name], jp[name], p0[name]))
        np.testing.assert_allclose(g, w, atol=tol["param"], rtol=0,
                                   err_msg=name)
        if g_kb is not None:
            np.testing.assert_allclose(g_kb, w_kb, atol=KEY_BIAS_TOL,
                                       rtol=0, err_msg=name)
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w - w0), 1e-12)
        assert rel <= tol["update"], f"{name}: update off by {rel}"
    jev = jm.evaluate(x, y, batch_size=8)
    pev = pm.evaluate(x, y, batch_size=12)        # tail of 8 padded to 12
    assert sorted(pev) == sorted(jev) == ["accuracy", "loss"]
    assert abs(pev["accuracy"] - jev["accuracy"]) <= tol["acc"] + 1e-6
    assert pev["loss"] == pytest.approx(jev["loss"], abs=tol["loss"])
    probs = pm.predict(x, batch_size=12)
    assert probs.shape == (32, 3) and np.isfinite(probs).all()
    np.testing.assert_array_equal(pm.predict_classes(x, batch_size=12),
                                  probs.argmax(-1))


def test_fit_continues_epochs_and_optimizer_state():
    """nb_epoch is additive over fit calls and the optimizer state carries
    on, as in the JAX loop: 1 + 1 epochs equal 2 epochs."""
    pctx.init_zoo_context(conf={"zoo.pallas.attention": True})
    x, y = _data(16, seed=2)
    losses = []
    for splits in ((2,), (1, 1)):
        pm = BERTClassifier(3, **CFG, device="cpu").init_weights()
        pm.compile(optimizer="adam", loss="scce", lr=1e-2)
        losses.append([l for n in splits
                       for l in pm.fit(x, y, batch_size=8,
                                       nb_epoch=n)["loss"]])
        assert pm.finished_epochs == 2 and pm.finished_iterations == 4
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)


def test_training_dropout_draws_from_the_step_generator():
    """Dropout on: two fits from the same weights and seed agree exactly,
    and differ from the dropout-free fit."""
    pctx.init_zoo_context(conf={"zoo.pallas.attention": True})
    x, y = _data(16, seed=3)
    runs = []
    for drop in (0.1, 0.1, 0.0):
        cfg = {**CFG, "hidden_drop": drop}
        pm = BERTClassifier(3, **cfg, device="cpu").init_weights(
            torch.Generator().manual_seed(5))
        pm.compile(optimizer="sgd", loss="scce", lr=0.1)
        runs.append(pm.fit(x, y, batch_size=8, nb_epoch=1)["loss"][0])
    assert runs[0] == runs[1] != runs[2]


def test_a_fitted_model_serves_through_inference_model():
    """InferenceModel copies a fitted model for bf16; the copy carries the
    weights but not the training loop or the optimizer state, and the
    original goes on training."""
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    pctx.init_zoo_context(conf={"zoo.pallas.attention": True})
    x, y = _data(16, seed=4)
    pm = BERTClassifier(3, **CFG, device="cpu")
    pm.compile(optimizer="adamw", loss="scce", lr=1e-3)
    pm.fit(x, y, batch_size=8, nb_epoch=1)
    im = InferenceModel(device="cpu").from_keras(pm, dtype="bfloat16")
    assert im._model._loop is None and im._model.opt_state is None
    np.testing.assert_allclose(im.predict(x), pm.predict(x), atol=2e-2)
    pm.fit(x, y, batch_size=8, nb_epoch=1)
    assert pm.finished_epochs == 2


def test_unported_train_conf_raises():
    with pytest.raises(NotImplementedError, match="not ported"):
        pctx.init_zoo_context(conf={"zoo.train.scan_steps": 4})
    with pytest.raises(NotImplementedError, match="not ported"):
        pctx.init_zoo_context(conf={"zoo.train.device_cache": "true"})
    pctx.init_zoo_context(conf={"zoo.train.scan_steps": 1,
                                "zoo.train.device_cache": "false"})


def test_fit_before_compile_raises():
    pm = BERTClassifier(3, **CFG, device="cpu").init_weights()
    x, y = _data(8)
    with pytest.raises(RuntimeError, match="compile"):
        pm.fit(x, y)


def test_pretrained_bert_mapping_matches_jax():
    """A transformers-style state_dict maps onto the same tree as the JAX
    importer's, and installs into the encoder (the head keeps its init)."""
    rng = np.random.default_rng(4)
    h, i = CFG["hidden_size"], CFG["intermediate_size"]
    sd = {"embeddings.word_embeddings.weight": (CFG["vocab"], h),
          "embeddings.position_embeddings.weight": (CFG["seq_len"], h),
          "embeddings.token_type_embeddings.weight": (2, h),
          "embeddings.LayerNorm.weight": (h,),
          "embeddings.LayerNorm.bias": (h,),
          "pooler.dense.weight": (h, h), "pooler.dense.bias": (h,)}
    for b in range(CFG["n_block"]):
        p = f"encoder.layer.{b}"
        for m in ("query", "key", "value"):
            sd[f"{p}.attention.self.{m}.weight"] = (h, h)
            sd[f"{p}.attention.self.{m}.bias"] = (h,)
        sd.update({f"{p}.attention.output.dense.weight": (h, h),
                   f"{p}.attention.output.dense.bias": (h,),
                   f"{p}.attention.output.LayerNorm.weight": (h,),
                   f"{p}.attention.output.LayerNorm.bias": (h,),
                   f"{p}.intermediate.dense.weight": (i, h),
                   f"{p}.intermediate.dense.bias": (i,),
                   f"{p}.output.dense.weight": (h, i),
                   f"{p}.output.dense.bias": (h,),
                   f"{p}.output.LayerNorm.weight": (h,),
                   f"{p}.output.LayerNorm.bias": (h,)})
    sd = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for k, s in sd.items()}
    got = peng.flatten_tree(bert_params_from_torch(sd, CFG["n_block"]))
    want = peng.flatten_tree(jax_bert_params_from_torch(sd, CFG["n_block"]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    pm = BERTClassifier(3, **CFG, device="cpu").init_weights()
    head = pm.model.cls.W.detach().clone()
    pm.load_pretrained(sd)
    enc = _np_params(pm.model.bert)
    for k in want:
        np.testing.assert_array_equal(enc[k], want[k])
    assert torch.equal(pm.model.cls.W, head)


def test_training_imports_no_jax():
    """A CPU fit through the port's facade leaves jax and the JAX package
    out of sys.modules (a fresh interpreter)."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from analytics_zoo_tpu_torch.common.context import "
        "init_zoo_context\n"
        "from analytics_zoo_tpu_torch.tfpark.bert_classifier import "
        "BERTClassifier, make_bert_inputs\n"
        "init_zoo_context(conf={'zoo.pallas.attention': True})\n"
        "m = BERTClassifier(2, vocab=50, hidden_size=16, n_block=1, "
        "n_head=2, seq_len=8, intermediate_size=32, device='cpu')\n"
        "m.compile(optimizer='adamw', loss='scce', metrics=['accuracy'])\n"
        "ids = np.random.default_rng(0).integers(1, 50, (8, 8))\n"
        "x = make_bert_inputs(ids)\n"
        "y = np.zeros(8, np.int32)\n"
        "m.fit(x, y, batch_size=4, nb_epoch=1)\n"
        "m.evaluate(x, y, batch_size=4)\n"
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
