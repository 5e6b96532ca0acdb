"""The port's causal-LM slice held to the JAX package on numpy-seeded
inputs and transferred weights: the fused LM-head cross-entropy (op,
autograd, label semantics, memory), its resolution in the training loop,
``TransformerLayer`` and a whole ``Sequential([TransformerLayer,
Dense(V)])`` ``compile``/``fit``/``evaluate``.

The JAX side runs its Pallas kernels as its own tests do on the CPU
(interpret mode); the port's side runs the kernels' plain versions (CPU
tensors) or the chunked route (``zoo.pallas.cross_entropy=false``).

Tolerances, each with its reason:
* fused CE in f32: loss 1e-6, gradients rtol 1e-4 / atol 1e-5 — the JAX
  package's own ``tests/test_fused_ce.py`` bounds (the same f32 formulas
  in another summation order);
* fused CE in bf16: loss 1e-3 absolute, gradients 2e-2 of the largest
  entry — logits round to bf16 at the same points on both sides, but an
  f32 product that the two summation orders leave on either side of a
  bf16 rounding boundary moves that logit by one bf16 step (2^-8
  relative), and dl enters the products rounded to bf16;
* ``TransformerLayer`` forward: f32 1e-5 (summation order), bf16 5e-2
  (bf16 activations round at other places in the two frameworks, over two
  blocks: up to three bf16 steps at the LayerNorm outputs' magnitudes of
  up to 4);
* the LM fit (``FIT_TOL``): f32 losses 1e-5 and parameters 1e-5 absolute
  (the same arithmetic in another order, through Adam); bf16 losses 2e-2
  and each leaf's update within 35% of JAX's (bf16 rounding differences
  that Adam's normalised steps turn into moves of up to lr). The key
  third of each fused qkv bias has an exact gradient of zero (softmax
  ignores a score shift shared by every key), so both sides compute
  rounding noise there, which Adam turns into moves of up to lr per step
  either way: it is held at ``KEY_BIAS_TOL`` = 2 x steps x lr instead.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.ops import fused_cross_entropy as jfce
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JaxSequential
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.observability import default_registry
from analytics_zoo_tpu_torch.ops import fused_cross_entropy as pfce
from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import (
    fused_ce_backward, fused_ce_backward_reference, fused_ce_forward,
    fused_ce_forward_reference)
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras import objectives as pobj
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras.fused_loss import (
    find_head, resolve_fused_loss)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    Dense, Dropout, TransformerLayer)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
LM = dict(vocab=130, seq_len=16, n_block=2, hidden_size=32, n_head=4,
          hidden_drop=0.0, attn_drop=0.0, embedding_drop=0.0,
          bidirectional=False)


@pytest.fixture(autouse=True)
def contexts():
    pctx.reset_zoo_context()
    yield
    pctx.reset_zoo_context()
    jctx.reset_zoo_context()
    jeng.set_policy()


def _setup(n=37, h=24, v=130, seed=0):
    rng = np.random.default_rng(seed)
    hid = rng.normal(size=(n, h)).astype(np.float32)
    w = (rng.normal(size=(h, v)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(v,)) * 0.1).astype(np.float32)
    y = rng.integers(0, v, n).astype(np.int32)
    return hid, w, b, y


def _jax_loss_and_grads(y, hid, w, b, dtype=jnp.float32, chunk=8,
                        use_pallas=True):
    def f(hid, w, b):
        return jfce.fused_sparse_cross_entropy(
            jnp.asarray(y), hid.astype(dtype), w, b, chunk=chunk,
            use_pallas=use_pallas, interpret=True)
    args = [jnp.asarray(a) for a in (hid, w)] + [
        None if b is None else jnp.asarray(b)]
    argnums = (0, 1) if b is None else (0, 1, 2)
    loss, grads = jax.value_and_grad(f, argnums=argnums)(*args)
    return float(loss), [np.asarray(g, np.float32) for g in grads]


def _port_loss_and_grads(y, hid, w, b, dtype=torch.float32, chunk=8,
                         use_pallas=True):
    ts = [torch.from_numpy(a).requires_grad_() for a in
          ((hid, w) if b is None else (hid, w, b))]
    loss = pfce.fused_sparse_cross_entropy(
        torch.from_numpy(np.asarray(y)), ts[0].to(dtype), ts[1],
        None if b is None else ts[2], chunk=chunk, use_pallas=use_pallas)
    grads = torch.autograd.grad(loss, ts)
    return float(loss.detach()), [g.float().numpy() for g in grads]


def _oracle_loss_and_grads(y, hid, w, b):
    """The JAX full-logits objective."""
    from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj

    def f(hid, w, b):
        logits = hid @ w + (0.0 if b is None else b)
        return jobj.sparse_categorical_crossentropy_from_logits(
            jnp.asarray(y), logits)
    args = [jnp.asarray(a) for a in (hid, w)] + [
        None if b is None else jnp.asarray(b)]
    loss, grads = jax.value_and_grad(
        f, argnums=(0, 1) if b is None else (0, 1, 2))(*args)
    return float(loss), [np.asarray(g) for g in grads]


# ---------------------------------------------------------------------------
# (a) the op against the JAX op (interpret-mode Pallas) and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("port_kernels", [True, False])
def test_fused_ce_f32_matches_jax_op_and_oracle(port_kernels):
    """N=37 (ragged against chunk 8 and the kernels' row tiles), V=130
    (ragged against every vocab tile); the port's kernel plain version and
    its chunked route, against the JAX Pallas op and the full-logits
    oracle."""
    hid, w, b, y = _setup()
    got, g_got = _port_loss_and_grads(y, hid, w, b, use_pallas=port_kernels)
    for want, g_want in (_jax_loss_and_grads(y, hid, w, b),
                         _oracle_loss_and_grads(y, hid, w, b)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        for a, c in zip(g_got, g_want):
            np.testing.assert_allclose(a, c, rtol=RTOL, atol=ATOL)


def _strided_views(seed=6, n=37, h=24, v=130):
    """A tied head's operands as views: ``hidden`` a column slice of a
    wider array and ``w`` the transpose of a ``(V, H)`` embedding."""
    rng = np.random.default_rng(seed)
    wide = rng.normal(size=(n, h + 7)).astype(np.float32)
    emb = (rng.normal(size=(v, h)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(v,)) * 0.1).astype(np.float32)
    y = rng.integers(-1, v, n).astype(np.int32)
    return wide, emb, b, y, slice(3, 3 + h)


@pytest.mark.parametrize("port_kernels", [True, False])
def test_fused_ce_rows_take_a_transposed_w_and_a_sliced_hidden(
        port_kernels):
    """Fault l: ``fused_cross_entropy_rows`` with ``w = emb.T`` and a
    column-sliced ``hidden`` (views the kernels do not take as they lie)
    against the JAX op on the same views: the loss and the gradients of
    the wide array, the embedding and the bias, each in the caller's
    layout."""
    wide, emb, b, y, cols = _strided_views()

    def jax_f(wide, emb, b):
        rows = jfce.fused_cross_entropy_rows(
            wide[:, cols], emb.T, b, jnp.asarray(y), chunk=8,
            use_pallas=True, interpret=True)
        return jnp.sum(rows)
    want, g_want = jax.value_and_grad(jax_f, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (wide, emb, b)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (wide, emb, b)]
    h, w = ts[0][:, cols], ts[1].T
    assert not h.is_contiguous() and not w.is_contiguous()
    rows = pfce.fused_cross_entropy_rows(h, w, ts[2], torch.from_numpy(y),
                                         chunk=8, use_pallas=port_kernels)
    got = rows.sum()
    grads = torch.autograd.grad(got, ts)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                               atol=1e-6)
    for a, c, t in zip(grads, g_want, ts):
        assert a.shape == t.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=RTOL,
                                   atol=ATOL)


def test_fused_ce_bf16_matches_jax_op():
    hid, w, b, y = _setup(n=64, h=16, v=256, seed=4)
    got, g_got = _port_loss_and_grads(y, hid, w, b, dtype=torch.bfloat16,
                                      chunk=16)
    want, g_want = _jax_loss_and_grads(y, hid, w, b, dtype=jnp.bfloat16,
                                       chunk=16)
    assert abs(got - want) <= 1e-3
    for a, c in zip(g_got, g_want):
        assert np.abs(a - c).max() <= 2e-2 * np.abs(c).max()


def test_kernel_plain_versions_match_jax_kernels():
    """The port's plain versions of K4 and K5a/K5b against the JAX Pallas
    kernels in interpret mode, output for output."""
    from analytics_zoo_tpu.ops.pallas import cross_entropy as jce
    hid, w, b, y = _setup()
    y[::3] = -1
    y[[4, 10]] = [130, 999]                       # over-range: no hit
    lse, ll = fused_ce_forward_reference(*map(torch.from_numpy,
                                              (hid, w, b, y)))
    jlse, jll = jce.fused_ce_forward(*map(jnp.asarray, (hid, w, b, y)),
                                     interpret=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=1e-6,
                               atol=1e-6)
    scale = np.where(y >= 0, 0.5, 0.0).astype(np.float32)
    got = fused_ce_backward_reference(
        *map(torch.from_numpy, (hid, w, b, y)), lse, torch.from_numpy(scale))
    want = jce.fused_ce_backward(*map(jnp.asarray, (hid, w, b, y)), jlse,
                                 jnp.asarray(scale), interpret=True)
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# (b) label semantics, no bias, padded rows under a huge bias
# ---------------------------------------------------------------------------

def test_masked_labels_give_zero_loss_and_exact_zero_grads():
    hid, w, b, y = _setup()
    y[::3] = -1
    got, g_got = _port_loss_and_grads(y, hid, w, b)
    want, g_want = _jax_loss_and_grads(y, hid, w, b)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(g_got[0][::3], 0.0)
    for a, c in zip(g_got, g_want):
        np.testing.assert_allclose(a, c, rtol=RTOL, atol=ATOL)
    rows = pfce.fused_cross_entropy_rows(*map(torch.from_numpy,
                                              (hid, w, b, y)))
    np.testing.assert_array_equal(rows.numpy()[::3], 0.0)


@pytest.mark.parametrize("port_kernels", [True, False])
def test_over_range_labels_poison_rows_and_dw(port_kernels):
    hid, w, b, _ = _setup(n=24, h=8, v=48, seed=6)
    y = np.arange(24, dtype=np.int32)
    y[[5, 11, 17]] = [48, 49, 1000]
    rows = pfce.fused_cross_entropy_rows(
        *map(torch.from_numpy, (hid, w, b, y)), chunk=8,
        use_pallas=port_kernels).numpy()
    jrows = np.asarray(jfce.fused_cross_entropy_rows(
        *map(jnp.asarray, (hid, w, b, y)), chunk=8, use_pallas=True,
        interpret=True))
    assert np.isnan(rows[[5, 11, 17]]).all()
    np.testing.assert_allclose(np.delete(rows, [5, 11, 17]),
                               np.delete(jrows, [5, 11, 17]), rtol=1e-6,
                               atol=1e-6)
    loss, grads = _port_loss_and_grads(y, hid, w, b,
                                       use_pallas=port_kernels)
    assert np.isnan(loss)
    dh, dw = grads[0], grads[1]
    assert np.isnan(dh[[5, 11, 17]]).all()
    assert np.isfinite(np.delete(dh, [5, 11, 17], axis=0)).all()
    assert np.isnan(dw).all()          # every column of dW is poisoned


def test_no_bias_grads_match_jax():
    hid, w, _, y = _setup()
    got, g_got = _port_loss_and_grads(y, hid, w, None, chunk=16)
    want, g_want = _jax_loss_and_grads(y, hid, w, None, chunk=16)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert len(g_got) == 2
    for a, c in zip(g_got, g_want):
        np.testing.assert_allclose(a, c, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("port_kernels", [True, False])
def test_padded_rows_stay_inert_under_a_huge_bias(port_kernels):
    """N=10 against chunk 8 and a bias entry of 100: pad rows (h = 0) see
    logits = bias, and lse = +inf on them keeps exp(bias - lse) at 0."""
    hid, w, b, y = _setup(n=10, h=6, v=32, seed=8)
    b[3] = 100.0
    got, g_got = _port_loss_and_grads(y, hid, w, b, use_pallas=port_kernels)
    want, g_want = _oracle_loss_and_grads(y, hid, w, b)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for a, c in zip(g_got, g_want):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, c, rtol=RTOL, atol=ATOL)


def test_chunk_validation_and_row_count_check():
    hid, w, b, y = _setup(n=32, h=8, v=64, seed=5)
    t = [torch.from_numpy(a) for a in (hid, w, b, y)]
    l1 = pfce.fused_sparse_cross_entropy(t[3], *t[:3], chunk=5,
                                         use_pallas=False)
    l2 = pfce.fused_sparse_cross_entropy(t[3], *t[:3], chunk=999,
                                         use_pallas=False)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    with pytest.raises(ValueError):
        pfce.fused_sparse_cross_entropy(t[3], *t[:3], chunk=0)
    with pytest.raises(ValueError):
        pfce.fused_cross_entropy_rows(*t[:3], t[3][:-1])


# ---------------------------------------------------------------------------
# (c) no (N, V) tensor is saved for the backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("port_kernels", [True, False])
def test_no_full_logits_tensor_saved_for_backward(port_kernels):
    n, h, v = 4096, 64, 8192
    hid = torch.zeros(n, h, requires_grad=True)
    w = torch.zeros(h, v, requires_grad=True)
    b = torch.zeros(v, requires_grad=True)
    y = torch.zeros(n, dtype=torch.int32)
    biggest = 0

    def pack(t):
        nonlocal biggest
        biggest = max(biggest, t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = pfce.fused_sparse_cross_entropy(y, hid, w, b, chunk=128,
                                               use_pallas=port_kernels)
    loss.backward()
    # the largest saved tensor is the (H, V) weight, nowhere near (N, V)
    assert 0 < biggest < n * v // 8, f"(N, V)-scale tensor saved: {biggest}"
    assert hid.grad.shape == (n, h) and w.grad.shape == (h, v)


# ---------------------------------------------------------------------------
# (d) resolution engages and declines as the JAX package's does
# ---------------------------------------------------------------------------

def _seq(*layers):
    return Sequential(list(layers), device="cpu")


def test_resolution_declines_non_matching_patterns():
    logits_loss = pobj.sparse_categorical_crossentropy_from_logits
    pctx.init_zoo_context(conf={"zoo.train.fused_ce": True})
    big = _seq(Dense(8, input_shape=(4,)), Dense(2048))
    spec = resolve_fused_loss(big, logits_loss)
    assert spec is not None and spec.param_path == ("dense_1",)
    soft = _seq(Dense(8, input_shape=(4,)), Dense(2048, activation="softmax"))
    assert resolve_fused_loss(soft, pobj.sparse_categorical_crossentropy)
    lin = _seq(Dense(8, input_shape=(4,)), Dense(2048, activation="linear"))
    assert resolve_fused_loss(lin, logits_loss)
    relu = _seq(Dense(8, input_shape=(4,)), Dense(2048, activation="relu"))
    assert resolve_fused_loss(relu, logits_loss) is None
    assert resolve_fused_loss(big, pobj.mean_squared_error) is None
    assert resolve_fused_loss(big, lambda y, yp: yp.mean()) is None
    drop = _seq(Dense(2048, input_shape=(4,)), Dropout(0.1))
    assert resolve_fused_loss(drop, logits_loss) is None
    pctx.reset_zoo_context()
    pctx.init_zoo_context(conf={"zoo.train.fused_ce": "auto"})
    # the probability form is never an auto substitution
    assert resolve_fused_loss(soft, pobj.sparse_categorical_crossentropy) \
        is None


def test_auto_threshold_and_off_switch_match_jax():
    loss_p = pobj.sparse_categorical_crossentropy_from_logits
    from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj
    from analytics_zoo_tpu.pipeline.api.keras.fused_loss import \
        resolve_fused_loss as jresolve
    for flag, v, engaged in (("auto", 1023, False), ("auto", 1024, True),
                             (True, 5, True), (False, 2048, False)):
        for ctx in (pctx, jctx):
            ctx.reset_zoo_context()
            ctx.init_zoo_context(conf={"zoo.train.fused_ce": flag})
        port = _seq(Dense(8, input_shape=(4,)), Dense(v))
        ref = JaxSequential([jl.Dense(8, input_shape=(4,)), jl.Dense(v)])
        assert (resolve_fused_loss(port, loss_p) is not None) == engaged
        assert (jresolve(ref, jobj.sparse_categorical_crossentropy_from_logits)
                is not None) == engaged


def test_bert_classifier_head_resolves_through_fused_head():
    from analytics_zoo_tpu_torch.tfpark.bert_classifier import (
        BERTClassifier, make_bert_inputs)
    rng = np.random.default_rng(11)
    ids = rng.integers(1, 50, (16, 8)).astype(np.int32)
    y = rng.integers(0, 2, 16).astype(np.int32)
    losses = []
    for fused in (False, True):
        pctx.reset_zoo_context()
        pctx.init_zoo_context(conf={"zoo.train.fused_ce": fused})
        clf = BERTClassifier(2, vocab=64, hidden_size=16, n_block=1,
                             n_head=2, seq_len=8, intermediate_size=32,
                             hidden_drop=0.0, attn_drop=0.0, device="cpu")
        clf.init_weights(torch.Generator().manual_seed(3))
        head = find_head(clf)
        assert head is not None and head[0] is clf.model.cls
        assert head[1] == ("cls",)
        assert (resolve_fused_loss(clf, pobj.sparse_categorical_crossentropy)
                is not None) == fused
        clf.compile(optimizer="adam", loss="scce", lr=1e-3)
        losses.append(clf.fit(make_bert_inputs(ids), y, batch_size=8,
                              nb_epoch=1)["loss"])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# (e) TransformerLayer against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 5e-2)])
@pytest.mark.parametrize("flash", [True, False])
def test_transformer_layer_matches_jax(dtype, tol, flash):
    """Causal, both attention routes; the embedding sum is taken in the
    param dtype and cast afterwards, as the JAX layer does."""
    conf = {"zoo.pallas.attention": flash}
    jctx.init_zoo_context(conf=conf)
    pctx.init_zoo_context(conf=conf)
    if dtype == "bfloat16":
        jeng.set_policy(compute_dtype=jnp.bfloat16)
        peng.set_policy(compute_dtype=torch.bfloat16)
    jlayer = jl.TransformerLayer(**LM)
    params = jlayer.build(jax.random.key(5), (None, LM["seq_len"]))
    layer = TransformerLayer(**LM)
    layer.build(generator=torch.Generator().manual_seed(0))
    peng.load_param_tree(layer, jax.tree.map(np.asarray, params))
    ids = np.random.default_rng(2).integers(
        0, LM["vocab"], (3, LM["seq_len"])).astype(np.int32)
    want = np.asarray(jlayer.call(params, jnp.asarray(ids)), np.float32)
    with torch.no_grad():
        got = layer(torch.from_numpy(ids))
    assert got.dtype == peng.as_torch_dtype(dtype)
    assert got.shape == (3, LM["seq_len"], LM["hidden_size"])
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_transformer_layer_embedding_cast_order():
    """bf16 compute: wte[ids] + wpe is summed in f32 and rounded once —
    not two bf16 tables summed in bf16 (BERT's order)."""
    peng.set_policy(compute_dtype=torch.bfloat16)
    layer = TransformerLayer(**{**LM, "n_block": 0})
    layer.build(generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.wte.fill_(1.0)
        layer.wpe.fill_(2.0 ** -9)   # vanishes if rounded to bf16 first
    ids = torch.zeros(1, 4, dtype=torch.int32)
    with torch.no_grad():
        out = layer(ids)
    assert out.dtype == torch.bfloat16
    want = torch.tensor(1.0 + 2.0 ** -9).to(torch.bfloat16)
    assert torch.all(out == want)
    jl_ = jl.TransformerLayer(**{**LM, "n_block": 0})
    jeng.set_policy(compute_dtype=jnp.bfloat16)
    p = {"wte": jnp.ones((LM["vocab"], LM["hidden_size"])),
         "wpe": jnp.full((LM["seq_len"], LM["hidden_size"]), 2.0 ** -9)}
    jout = np.asarray(jl_.call(p, jnp.zeros((1, 4), jnp.int32)), np.float32)
    np.testing.assert_array_equal(out.float().numpy(), jout)


# ---------------------------------------------------------------------------
# (f) the slice: Sequential LM compile/fit/evaluate against the JAX fit
# ---------------------------------------------------------------------------

def _lm_data(n=16, v=LM["vocab"], seed=7, neg_every=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, v, (n, LM["seq_len"])).astype(np.int32)
    y = ((7 * x + 13) % v).astype(np.int32)
    if neg_every:
        y.reshape(-1)[::neg_every] = -1
    return x, y


def _port_lm(v=LM["vocab"], tree=None):
    m = Sequential([TransformerLayer(**{**LM, "vocab": v},
                                     input_shape=(LM["seq_len"],)),
                    Dense(v)], device="cpu")
    if tree is not None:
        m.load_jax_params(tree)
    else:
        m.init_weights(torch.Generator().manual_seed(1))
    return m


#: per-dtype bounds of the LM fit (module docstring)
FIT_TOL = {"float32": dict(loss=1e-5, param=1e-5, update=1e-3),
           "bfloat16": dict(loss=2e-2, param=None, update=0.35)}
#: 2 x 4 Adam steps x lr 1e-2 (module docstring)
KEY_BIAS_TOL = 2 * 4 * 1e-2


def _split_key_bias(name, a):
    """``(rest, key_bias)`` of a leaf: the key third of a ``qkv/b``."""
    if not name.endswith("qkv/b"):
        return a, None
    h = a.shape[-1] // 3
    return np.concatenate([a[:h], a[2 * h:]]), a[h:2 * h]


def _np_params(module):
    return {n.replace(".", "/"): p.detach().float().numpy().copy()
            for n, p in module.named_parameters()}


def _assert_updates_close(got, want, start, rel_tol):
    """Each leaf's update ``got - start`` within ``rel_tol`` of ``want -
    start`` (norm of the difference over the norm of the update); the key
    third of a qkv bias within ``KEY_BIAS_TOL``."""
    for name in want:
        (g, g_kb), (w, w_kb), (w0, _) = (_split_key_bias(name, a) for a in
                                         (got[name], want[name],
                                          start[name]))
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w - w0), 1e-12)
        assert rel <= rel_tol, f"{name}: update off by {rel}"
        if g_kb is not None:
            np.testing.assert_allclose(g_kb, w_kb, atol=KEY_BIAS_TOL,
                                       rtol=0, err_msg=name)


def _assert_params_close(got, want, atol, rtol=0.0):
    for name in want:
        (g, g_kb), (w, w_kb) = (_split_key_bias(name, a)
                                for a in (got[name], want[name]))
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=name)
        if g_kb is not None:
            np.testing.assert_allclose(g_kb, w_kb, atol=KEY_BIAS_TOL,
                                       rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_fit_matches_jax(dtype):
    """Same weights, same shuffled batch order (zoo.seed + epoch), Adam,
    two epochs of two steps of 8 sequences, the Pallas flags on both
    sides (fused CE through the kernels' plain versions here, the
    interpret-mode Pallas kernels there), then evaluate."""
    tol = FIT_TOL[dtype]
    conf = {"zoo.pallas.attention": True, "zoo.pallas.cross_entropy": True,
            "zoo.train.fused_ce": True, "zoo.seed": 0}
    jctx.init_zoo_context(conf=conf)
    pctx.init_zoo_context(conf=conf)
    if dtype == "bfloat16":
        jeng.set_policy(compute_dtype=jnp.bfloat16)
        peng.set_policy(compute_dtype=torch.bfloat16)
    jm = JaxSequential([jl.TransformerLayer(**LM,
                                            input_shape=(LM["seq_len"],)),
                        jl.Dense(LM["vocab"])])
    jm.init_weights(rng=jax.random.key(3))
    tree = jax.tree.map(np.asarray, jm.params)
    p0 = peng.flatten_tree(tree)
    pm = _port_lm(tree=tree)
    x, y = _lm_data()
    jm.compile(optimizer="adam", loss="scce_with_logits", lr=1e-2)
    pm.compile(optimizer="adam", loss="scce_with_logits", lr=1e-2)
    want = jm.fit(x, y, batch_size=8, nb_epoch=2)["loss"]
    got = pm.fit(x, y, batch_size=8, nb_epoch=2)["loss"]
    np.testing.assert_allclose(got, want, atol=tol["loss"], rtol=0)
    jp = peng.flatten_tree(jax.tree.map(np.asarray, jm.params))
    pp = _np_params(pm)
    assert sorted(jp) == sorted(pp)
    if tol["param"] is not None:
        _assert_params_close(pp, jp, tol["param"])
    _assert_updates_close(pp, jp, p0, tol["update"])
    jev = jm.evaluate(x, y, batch_size=8)
    pev = pm.evaluate(x, y, batch_size=8)
    assert pev["loss"] == pytest.approx(jev["loss"], abs=tol["loss"])
    assert pm.predict(x[:3]).shape == (3, LM["seq_len"], LM["vocab"])


@pytest.mark.parametrize("neg_every", [0, 5])
def test_lm_fused_on_and_off_give_the_same_fit(neg_every):
    """Toggling zoo.train.fused_ce never changes a run's losses, negative
    labels included (the oracle wraps them; so does the substitution)."""
    x, y = _lm_data(neg_every=neg_every)
    runs = []
    for fused in (False, True):
        pctx.reset_zoo_context()
        pctx.init_zoo_context(conf={"zoo.train.fused_ce": fused,
                                    "zoo.pallas.attention": True})
        m = _port_lm()
        p0 = _np_params(m)
        m.compile(optimizer="adam", loss="scce_with_logits", lr=1e-2)
        runs.append((m.fit(x, y, batch_size=8, nb_epoch=2)["loss"],
                     _np_params(m)))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-5, atol=1e-6)
    # Adam moves an element whose gradient is rounding noise by up to lr
    # either way, so the parameters are held leaf by leaf on their update
    _assert_updates_close(runs[1][1], runs[0][1], p0, 1e-3)


def test_lm_auto_engages_at_vocab_1024_and_sets_the_gauge():
    """auto engages at exactly V = AUTO_MIN_VOCAB; the gauge reads 1, and a
    later non-fused loop zeroes it."""
    x, y = _lm_data(v=1024)
    pctx.init_zoo_context(conf={"zoo.train.fused_ce": "auto",
                                "zoo.pallas.attention": True})
    m = _port_lm(v=1024)
    m.compile(optimizer="adam", loss="scce_with_logits", lr=1e-2)
    m.fit(x, y, batch_size=8, nb_epoch=1)
    key = 'zoo_train_fused_ce{head="dense_1",sharded="0",vocab="1024"}'
    snap = default_registry().snapshot()
    assert snap[key]["value"] == 1, sorted(snap)
    pctx.reset_zoo_context()
    pctx.init_zoo_context(conf={"zoo.train.fused_ce": False,
                                "zoo.pallas.attention": True})
    m.compile(optimizer="adam", loss="scce_with_logits", lr=1e-2)
    m.fit(x, y, batch_size=8, nb_epoch=1)
    assert default_registry().snapshot()[key]["value"] == 0


def test_sequential_names_shapes_and_device():
    m = Sequential([TransformerLayer(**LM, input_shape=(LM["seq_len"],)),
                    Dense(LM["vocab"], name="head")], device="cpu")
    assert [l.name for l in m.layers] == ["transformerlayer_0", "head"]
    assert m.compute_output_shape(m.input_shape) == (
        None, LM["seq_len"], LM["vocab"])
    with pytest.raises(ValueError, match="duplicate"):
        m.add(Dense(3, name="head"))
    with pytest.raises(RuntimeError, match="init_weights"):
        m(torch.zeros(1, LM["seq_len"], dtype=torch.int32))
    m.init_weights()
    with pytest.raises(KeyError):
        m.load_jax_params({"head": {"W": np.zeros((32, 130))}})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Sequential([Dense(3, input_shape=(4,))])


# ---------------------------------------------------------------------------
# (g) no jax on the LM path
# ---------------------------------------------------------------------------

def test_lm_path_imports_no_jax():
    """A CPU LM fit through the new modules leaves jax and the JAX package
    out of sys.modules (a fresh interpreter)."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import analytics_zoo_tpu_torch.ops.fused_cross_entropy\n"
        "import analytics_zoo_tpu_torch.ops.pallas.cross_entropy\n"
        "import analytics_zoo_tpu_torch.ops.pallas.common\n"
        "import analytics_zoo_tpu_torch.pipeline.api.keras.fused_loss\n"
        "from analytics_zoo_tpu_torch.common.context import "
        "init_zoo_context\n"
        "from analytics_zoo_tpu_torch.pipeline.api.keras.engine import "
        "Sequential\n"
        "from analytics_zoo_tpu_torch.pipeline.api.keras.layers import "
        "Dense, TransformerLayer\n"
        "init_zoo_context(conf={'zoo.train.fused_ce': True})\n"
        "m = Sequential([TransformerLayer(vocab=40, seq_len=8, n_block=1, "
        "hidden_size=16, n_head=2, input_shape=(8,)), Dense(40)], "
        "device='cpu')\n"
        "m.compile(optimizer='adam', loss='scce_with_logits')\n"
        "x = np.random.default_rng(0).integers(0, 40, (8, 8))\n"
        "m.fit(x, (x + 1) % 40, batch_size=4, nb_epoch=1)\n"
        "m.evaluate(x, (x + 1) % 40, batch_size=4)\n"
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


def test_kernel_wrappers_take_the_plain_version_on_cpu_only():
    """A CPU tensor runs the plain version; the wrappers' checks hold."""
    hid, w, b, y = (torch.from_numpy(a) for a in _setup())
    lse, ll = fused_ce_forward(hid, w, b, y)
    want = fused_ce_forward_reference(hid, w, b, y)
    assert torch.equal(lse, want[0]) and torch.equal(ll, want[1])
    dh, dw, db = fused_ce_backward(hid, w, None, y, lse, torch.ones(37))
    assert db is None and dh.shape == hid.shape and dw.shape == w.shape
    with pytest.raises(TypeError):
        fused_ce_forward(hid, w.double(), b, y)
    with pytest.raises(ValueError):
        fused_ce_forward(hid, w.T.contiguous(), b, y)
