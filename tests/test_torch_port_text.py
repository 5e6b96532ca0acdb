"""The port's text slice held to the JAX package on numpy-seeded inputs
and transferred weights: the advanced activation layers, BERT NER and
SQuAD (losses, heads, fits, span decoding, the ``.npz`` both ways, the
torch ``state_dict`` import), ``TextSet`` and the relations data path
(the cases of ``tests/test_text.py`` and ``tests/test_relations.py`` but
``TextClassifier``'s, run through both packages), and ``KNRM`` (both
target modes, a frozen ``WordEmbedding``, a ranking fit, ``RankerMixin``
evaluation, the ``.npz`` both ways).

Tolerances, each with its reason:
* f32 forwards and gradients: rtol 1e-5, atol 1e-6 (the same formulas in
  another summation order);
* the BERT heads' and KNRM's fits: losses 1e-5 absolute, each leaf's
  update within 1e-3 of JAX's, the key third of each fused qkv bias at
  ``KEY_BIAS_TOL`` — ``tests/test_torch_port_training.py``'s f32 bounds
  and reasons (the same arithmetic in another order through Adam; that
  bias has an exact gradient of zero, so both sides move it by rounding
  noise times lr); each parameter 1e-4 absolute for the BERT heads (an
  element whose gradient nearly cancels takes Adam's normalised step
  from rounding noise, as ``tests/test_torch_port_widedeep.py`` found;
  one qkv weight of 12,288 moved 1.03e-5 apart here) and 1e-5 for KNRM;
* KNRM's forward 1e-4 relative: its kernel pooling sums 21 exponentials
  of squared products over 40 doc positions and then logs, which
  amplifies the products' last-bit differences;
* text preprocessing and relations: exact.
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
from analytics_zoo_tpu.feature import text as jtext
from analytics_zoo_tpu.models.common.zoo_model import \
    load_model as j_load_model
from analytics_zoo_tpu.models.textmatching import KNRM as JaxKNRM
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras.layers import \
    advanced_activations as jaa
from analytics_zoo_tpu.tfpark import bert_ner as jner
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.feature import BucketedFeatureSet
from analytics_zoo_tpu_torch.feature import text as ptext
from analytics_zoo_tpu_torch.models.common.zoo_model import \
    load_model as p_load_model
from analytics_zoo_tpu_torch.models.textmatching import KNRM
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as pl
from analytics_zoo_tpu_torch.tfpark import (BERTNER, BERTSQuAD,
                                            masked_token_scce,
                                            squad_span_loss)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
BERT = dict(vocab=60, hidden_size=64, n_block=2, n_head=4, seq_len=16,
            intermediate_size=128, hidden_drop=0.0, attn_drop=0.0)
KEY_BIAS_TOL = 2 * 8 * 1e-3


@pytest.fixture(autouse=True)
def contexts():
    pctx.reset_zoo_context()
    peng.reset_uids()
    jeng.reset_uids()
    yield
    pctx.reset_zoo_context()
    jctx.reset_zoo_context()


# ---------------------------------------------------------------------------
# advanced activations
# ---------------------------------------------------------------------------

ACTIVATIONS = [
    ("LeakyReLU", dict(alpha=0.2)), ("ELU", dict(alpha=0.7)),
    ("PReLU", {}), ("SReLU", {}), ("ThresholdedReLU", dict(theta=0.3)),
    ("RReLU", dict(lower=0.1, upper=0.4)), ("Softmax", {}),
    ("HardTanh", dict(min_value=-0.8, max_value=0.6)),
    ("HardShrink", dict(value=0.4)), ("SoftShrink", dict(value=0.3)),
    ("Threshold", dict(th=0.1, v=-2.0)), ("BinaryThreshold", dict(th=0.2)),
]


def _activation_params(name, ch, rng):
    """Random per-channel parameters for the learnable layers (their
    initial values would leave whole branches untested)."""
    if name == "PReLU":
        return {"alpha": rng.uniform(-0.5, 0.5, ch).astype(np.float32)}
    if name == "SReLU":
        return {"t_left": rng.uniform(-1.0, -0.2, ch).astype(np.float32),
                "a_left": rng.uniform(0.0, 0.5, ch).astype(np.float32),
                "t_right": rng.uniform(0.2, 1.0, ch).astype(np.float32),
                "a_right": rng.uniform(0.5, 1.5, ch).astype(np.float32)}
    return {}


@pytest.mark.parametrize("name,kwargs", ACTIVATIONS,
                         ids=[a[0] for a in ACTIVATIONS])
def test_advanced_activation_matches_jax(name, kwargs):
    """Forward (at inference for RReLU) and the gradient of ``sum(y *
    dy)`` in x and in the layer's parameters, on inputs kept off each
    layer's break points."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-2.0, 2.0, (4, 6, 8)).astype(np.float32)
    x[np.abs(x) < 0.05] = 0.5
    dy = rng.normal(size=x.shape).astype(np.float32)
    params = _activation_params(name, 8, rng)
    jlayer = getattr(jaa, name)(**kwargs)
    jp = jlayer.build(jax.random.key(0), (None, 6, 8))
    assert sorted(jp) == sorted(params)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    player = getattr(pl, name)(**kwargs)
    player.build((None, 6, 8), generator=torch.Generator().manual_seed(0))
    assert sorted(n for n, _ in player.named_parameters()) == sorted(params)
    peng.load_param_tree(player, params)
    assert player.compute_output_shape((None, 6, 8)) == (None, 6, 8)

    def jfn(p, xx):
        return jnp.sum(jlayer.call(p, xx) * dy)
    want_y = np.asarray(jlayer.call(jp, jnp.asarray(x)))
    want_gp, want_gx = jax.grad(jfn, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = player(xt)
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=RTOL,
                               atol=ATOL)
    if not y.requires_grad:          # BinaryThreshold: a step, gradient 0
        assert not np.asarray(want_gx).any()
        return
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx),
                               rtol=RTOL, atol=ATOL)
    for key, p in player.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(want_gp[key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)


def test_rrelu_training_slopes():
    """In training, RReLU's negative slopes come from the step's
    generator: within [lower, upper], the same for the same seed, others
    for another; positives pass through; no generator means the mean
    slope, as JAX's call without an rng."""
    layer = pl.RReLU(lower=0.1, upper=0.3)
    x = -torch.ones(64, 32)
    a = layer(x, training=True, generator=torch.Generator().manual_seed(4))
    b = layer(x, training=True, generator=torch.Generator().manual_seed(4))
    c = layer(x, training=True, generator=torch.Generator().manual_seed(5))
    slopes = -a
    assert float(slopes.min()) >= 0.1 and float(slopes.max()) <= 0.3
    assert slopes.std() > 0.03        # drawn, not one value
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(layer(-x, training=True,
                             generator=torch.Generator().manual_seed(4)),
                       -x)
    mean = jaa.RReLU(lower=0.1, upper=0.3).call({}, jnp.asarray(x.numpy()),
                                                 training=True, rng=None)
    np.testing.assert_allclose(layer(x, training=True).numpy(),
                               np.asarray(mean), rtol=RTOL, atol=ATOL)


def test_activations_stack_in_a_sequential_fit():
    """PReLU and SReLU train as weights of a Sequential, RReLU draws from
    the step's generator, and the tree keys are the JAX ones."""
    pctx.init_zoo_context(conf={"zoo.seed": 0})
    m = peng.Sequential([pl.Dense(8, input_shape=(5,)), pl.PReLU(),
                         pl.Dense(8), pl.SReLU(), pl.RReLU(), pl.Dense(3),
                         pl.Softmax()], device="cpu").init_weights()
    assert {n.split(".")[0] + "/" + n.split(".")[-1]
            for n, _ in m.named_parameters() if "relu" in n} == {
        "prelu_1/alpha", "srelu_3/t_left", "srelu_3/a_left",
        "srelu_3/t_right", "srelu_3/a_right"}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 5)).astype(np.float32)
    y = rng.integers(0, 3, 64).astype(np.int32)
    start = m.layers[1].alpha.detach().clone()
    m.compile(optimizer="adam", loss="scce", lr=1e-2)
    h = m.fit(x, y, batch_size=16, nb_epoch=3)["loss"]
    assert np.isfinite(h).all() and h[-1] < h[0]
    assert not torch.equal(m.layers[1].alpha, start)


# ---------------------------------------------------------------------------
# BERT NER and SQuAD
# ---------------------------------------------------------------------------

def test_masked_token_scce_matches_jax_and_masks():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 7, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, (3, 7)).astype(np.int32)
    labels[0, 4:] = -1
    labels[2] = -1                          # an all-masked row
    want = float(jner.masked_token_scce(labels, logits))
    got = masked_token_scce(torch.from_numpy(labels),
                            torch.from_numpy(logits))
    assert float(got) == pytest.approx(want, rel=RTOL, abs=ATOL)
    # gradients in the logits
    lt = torch.from_numpy(logits).requires_grad_()
    masked_token_scce(torch.from_numpy(labels), lt).backward()
    jg = jax.grad(lambda lg: jner.masked_token_scce(labels, lg))(logits)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=ATOL)
    assert not lt.grad[2].any() and not lt.grad[0, 4:].any()
    # every token masked: 0, as in JAX
    none = -np.ones((2, 7), np.int32)
    assert float(masked_token_scce(torch.from_numpy(none),
                                   torch.from_numpy(logits[:2]))) == 0.0
    assert float(jner.masked_token_scce(none, logits[:2])) == 0.0


def test_squad_span_loss_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(4, 9, 2)).astype(np.float32) * 2
    spans = np.stack([rng.integers(0, 5, 4), rng.integers(4, 9, 4)],
                     axis=1).astype(np.int32)
    want = float(jner.squad_span_loss(spans, logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = squad_span_loss(torch.from_numpy(spans), lt)
    assert float(got) == pytest.approx(want, rel=RTOL, abs=ATOL)
    got.backward()
    jg = jax.grad(lambda lg: jner.squad_span_loss(spans, lg))(logits)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=ATOL)


def _ner_data(n=16, seed=0, num=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, BERT["vocab"], (n, BERT["seq_len"])).astype(
        np.int32)
    lens = rng.integers(6, BERT["seq_len"] + 1, n)
    pad = np.arange(BERT["seq_len"])[None, :] >= lens[:, None]
    ids[pad] = 0
    tags = (ids % num).astype(np.int32)
    tags[pad] = -1
    spans = np.stack([rng.integers(0, 6, n), rng.integers(6, 12, n)],
                     axis=1).astype(np.int32)
    return ids, (~pad).astype(np.float32), tags, spans


def _pair(kind):
    """The JAX model, the port's with its weights, and their ``params``
    tree."""
    if kind == "ner":
        jm = jner.BERTNER(num_entities=5, **BERT)
        pm = BERTNER(num_entities=5, **BERT, device="cpu")
    else:
        jm = jner.BERTSQuAD(**BERT)
        pm = BERTSQuAD(**BERT, device="cpu")
    jm.init_weights(rng=jax.random.key(7))
    tree = jax.tree.map(np.asarray, jm.params)
    pm.load_jax_params(tree)
    return jm, pm, tree


def _np_params(module):
    return {n.replace(".", "/"): p.detach().float().numpy().copy()
            for n, p in module.named_parameters()}


def _split_key_bias(name, a):
    if not name.endswith("qkv/b"):
        return a, None
    h = a.shape[-1] // 3
    return np.concatenate([a[:h], a[2 * h:]]), a[h:2 * h]


def _assert_fit_close(pp, jp, p0, zero_grad=()):
    """The fit's parameters against JAX's; the ``zero_grad`` leaves, whose
    exact gradient is zero, at ``KEY_BIAS_TOL`` as the key bias."""
    for name in jp:
        if name in zero_grad:
            np.testing.assert_allclose(pp[name], jp[name],
                                       atol=KEY_BIAS_TOL, rtol=0,
                                       err_msg=name)
            continue
        (g, g_kb), (w, w_kb), (w0, _) = (_split_key_bias(name, a) for a in
                                         (pp[name], jp[name], p0[name]))
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=name)
        if g_kb is not None:
            np.testing.assert_allclose(g_kb, w_kb, atol=KEY_BIAS_TOL,
                                       rtol=0, err_msg=name)
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w - w0), 1e-12)
        assert rel <= 1e-3, f"{name}: update off by {rel}"


@pytest.mark.parametrize("kind", ["ner", "squad"])
def test_bert_token_heads_match_jax(kind):
    """Names and the param tree ``{"bert", "head"}``, the forward on
    transferred weights, then a fit of two epochs of two steps (Adam)
    against the JAX fit, and the decoded tags or spans."""
    conf = {"zoo.pallas.attention": True, "zoo.seed": 0}
    jctx.init_zoo_context(conf=conf)
    pctx.init_zoo_context(conf=conf)
    jm, pm, tree = _pair(kind)
    assert sorted(tree) == ["bert", "head"]
    net = pm.model
    assert (net.bert.name, net.drop.name, net.head.name) == tuple(
        f"{pm.name}_net_{s}" for s in ("bert", "drop", "head"))
    ids, mask, tags, spans = _ner_data()
    x = pm.make_inputs(ids, attention_mask=mask)
    y = tags if kind == "ner" else spans
    want = np.asarray(jm.predict(x, batch_size=8))
    got = pm.predict(x, batch_size=8)
    assert got.shape == (16, BERT["seq_len"], 5 if kind == "ner" else 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    if kind == "ner":
        np.testing.assert_array_equal(pm.predict_tags(x, batch_size=8),
                                      got.argmax(-1))
        np.testing.assert_array_equal(pm.predict_tags(x, batch_size=8),
                                      jm.predict_tags(x, batch_size=8))
    else:
        got_spans = pm.predict_spans(x, batch_size=8)
        np.testing.assert_array_equal(got_spans,
                                      jm.predict_spans(x, batch_size=8))
        assert (got_spans[:, 1] >= got_spans[:, 0]).all()
    p0 = peng.flatten_tree(tree)
    jm.compile(optimizer="adam", lr=1e-3)
    pm.compile(optimizer="adam", lr=1e-3)
    want_l = jm.fit(x, y, batch_size=8, nb_epoch=2)["loss"]
    got_l = pm.fit(x, y, batch_size=8, nb_epoch=2)["loss"]
    np.testing.assert_allclose(got_l, want_l, atol=1e-5, rtol=0)
    # SQuAD's span softmax runs over positions, so a shift shared by every
    # position (the head's bias, the last LayerNorm's beta) has an exact
    # gradient of zero there
    last = f"bert/block{BERT['n_block'] - 1}/ln2/beta"
    _assert_fit_close(_np_params(pm.model),
                      peng.flatten_tree(jax.tree.map(np.asarray, jm.params)),
                      p0, () if kind == "ner" else ("head/b", last))


def test_bert_ner_ignores_padded_positions():
    """Other ids past each row's valid length change no loss bit."""
    pctx.init_zoo_context(conf={"zoo.pallas.attention": True})
    pm = BERTNER(num_entities=5, **BERT, device="cpu").init_weights()
    pm.compile(optimizer="adam", lr=1e-3)
    ids, mask, tags, _ = _ner_data()
    other = ids.copy()
    other[mask == 0] = 7
    losses = [pm._loop.loss(torch.from_numpy(tags), pm(
        [torch.from_numpy(a) for a in pm.make_inputs(r, attention_mask=mask)]))
        for r in (ids, other)]
    assert torch.equal(losses[0], losses[1])


@pytest.mark.parametrize("kind", ["ner", "squad"])
def test_bert_token_heads_npz_both_ways(kind, tmp_path):
    jctx.init_zoo_context(conf={"zoo.pallas.attention": True})
    pctx.init_zoo_context(conf={"zoo.pallas.attention": True})
    jm, pm, _ = _pair(kind)
    ids, mask, _, _ = _ner_data(8)
    x = pm.make_inputs(ids, attention_mask=mask)
    want = np.asarray(jm.predict(x, batch_size=8))
    got = p_load_model(jm.save(str(tmp_path / "j.npz")), device="cpu")
    assert type(got) is type(pm) and got.get_config() == pm.get_config()
    np.testing.assert_allclose(got.predict(x, batch_size=8), want,
                               rtol=1e-4, atol=1e-5)
    back = j_load_model(pm.save(str(tmp_path / "p.npz")))
    assert type(back).__name__ == type(pm).__name__
    np.testing.assert_allclose(np.asarray(back.predict(x, batch_size=8)),
                               want, rtol=1e-4, atol=1e-5)


def test_bert_ner_load_pretrained_from_a_torch_state_dict():
    """A transformers-style state_dict fills the encoder as the JAX
    importer does; the head keeps its fresh init."""
    rng = np.random.default_rng(4)
    h, i = BERT["hidden_size"], BERT["intermediate_size"]
    shapes = {"embeddings.word_embeddings.weight": (BERT["vocab"], h),
              "embeddings.position_embeddings.weight": (BERT["seq_len"], h),
              "embeddings.token_type_embeddings.weight": (2, h),
              "embeddings.LayerNorm.weight": (h,),
              "embeddings.LayerNorm.bias": (h,),
              "pooler.dense.weight": (h, h), "pooler.dense.bias": (h,)}
    for b in range(BERT["n_block"]):
        p = f"encoder.layer.{b}"
        for m in ("query", "key", "value"):
            shapes[f"{p}.attention.self.{m}.weight"] = (h, h)
            shapes[f"{p}.attention.self.{m}.bias"] = (h,)
        shapes.update({f"{p}.attention.output.dense.weight": (h, h),
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
          for k, s in shapes.items()}
    jm = jner.BERTNER(num_entities=5, **BERT)
    jm.init_weights(rng=jax.random.key(1))
    jm.load_pretrained(sd)
    pm = BERTNER(num_entities=5, **BERT, device="cpu").init_weights()
    head = pm.model.head.W.detach().clone()
    pm.load_pretrained(sd)
    want = peng.flatten_tree(jax.tree.map(np.asarray, jm.params["bert"]))
    got = _np_params(pm.model.bert)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert torch.equal(pm.model.head.W, head)


# ---------------------------------------------------------------------------
# TextSet and relations: the JAX package's cases through both packages
# ---------------------------------------------------------------------------

def _both(fn):
    """``fn(text_module)`` for the JAX and the port's ``feature.text``."""
    return fn(jtext), fn(ptext)


def _features(ts):
    return [(f.text, f.label, f.uri, f.tokens,
             None if f.indices is None else f.indices.tolist())
            for f in ts.features]


def test_tokenize_word2idx_shape_match_jax():
    def run(t):
        ts = t.TextSet.from_texts(["Hello, World! Hello...", "world again",
                                   "A b; c -- d e f g h"], [0, 1, 0])
        ts.tokenize().word2idx().shape_sequence(5)
        x, y = ts.to_arrays()
        return _features(ts), ts.get_word_index(), x, y
    (jf, jw, jx, jy), (pf, pw, px, py) = _both(run)
    assert pf == jf and pw == jw
    np.testing.assert_array_equal(px, jx)
    np.testing.assert_array_equal(py, jy)
    assert px.dtype == np.int32 and pw["hello"] == 1


def test_word2idx_remove_top_and_cap_match_jax():
    def run(t):
        ts = t.TextSet.from_texts(["a a a b b c d", "d e e f"]).tokenize()
        ts.word2idx(remove_top_n=1, max_words_num=3)
        return _features(ts), ts.get_word_index()
    j, p = _both(run)
    assert p == j and "a" not in p[1] and len(p[1]) == 3


@pytest.mark.parametrize("trunc_mode", ["pre", "post"])
def test_shape_sequence_trunc_modes_match_jax(trunc_mode):
    def run(t):
        base = t.TextSet.from_texts(["one two three four five six"])
        base.tokenize().word2idx()
        ts = t.TextSet.from_texts(["one two three four five", "six one"])
        ts.tokenize().word2idx(existing_map=base.get_word_index())
        ts.shape_sequence(3, trunc_mode=trunc_mode, pad_element=9)
        return _features(ts)
    j, p = _both(run)
    assert p == j
    with pytest.raises(ValueError, match="trunc_mode"):
        ptext.TextSet.from_texts(["a"]).tokenize().word2idx() \
            .shape_sequence(2, trunc_mode="middle")


def test_read_folder_and_csv_match_jax(tmp_path):
    (tmp_path / "pos").mkdir()
    (tmp_path / "neg").mkdir()
    (tmp_path / "pos" / "a.txt").write_text("good great fine")
    (tmp_path / "pos" / "b.txt").write_text("nice and fine")
    (tmp_path / "neg" / "c.txt").write_text("bad awful poor")
    csvp = tmp_path / "data.csv"
    csvp.write_text("text,label\nhello world,1\nbye now,0\nno label,\n")

    def run(t):
        ts = t.TextSet.read(str(tmp_path))
        c = t.TextSet.from_csv(str(csvp))
        return _features(ts), ts.label_map, _features(c), c.labels
    (jf, jl_, jc, jy), (pf, pl_, pc, py) = _both(run)
    assert (pf, pl_, pc) == (jf, jl_, jc) and py is None and jy is None
    assert pl_ == {"neg": 0, "pos": 1}
    with pytest.raises(ValueError, match="subdirectories"):
        ptext.TextSet.read(str(tmp_path / "pos"))


def test_from_parquet_matches_jax(tmp_path):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq
    path = str(tmp_path / "corpus.parquet")
    pq.write_table(pa.table({"text": ["good film", "bad film", "fine"],
                             "label": [1, 0, 1]}), path)

    def run(t):
        ts = t.TextSet.from_parquet(path)
        x, y = ts.tokenize().word2idx().shape_sequence(4).to_arrays()
        return _features(ts), x.tolist(), y.tolist()
    j, p = _both(run)
    assert p == j
    with pytest.raises(ValueError, match="no column"):
        ptext.TextSet.from_parquet(path, text_col="nope")


def test_to_bucketed_matches_jax():
    texts = ["good fun " * 2, "bad sad " * 2] * 6 + [
        "good fun nice day " * 5, "bad sad poor day " * 5] * 6
    labels = np.asarray([1, 0] * 12, np.int32)

    def run(t):
        fs = t.TextSet.from_texts(texts, labels).tokenize().word2idx() \
            .to_bucketed([8, 24], seed=1)
        return [(bx.tolist(), by.tolist())
                for bx, by in fs.iter_batches(4, epoch=0)], len(fs)
    j, p = _both(run)
    assert p == j and p[1] == 24
    fs = ptext.TextSet.from_texts(texts, labels).tokenize().word2idx() \
        .to_bucketed([8, 24])
    assert isinstance(fs, BucketedFeatureSet)
    assert {b.x.shape[1] for b in fs.buckets} == {8, 24}


RELS = [("q1", "a1", 1), ("q1", "a2", 0), ("q1", "a3", 0), ("q2", "a2", 1),
        ("q2", "a4", 1), ("q2", "a1", 0), ("q3", "a3", 1)]
CORPUS_Q = {"q1": "what is tpu", "q2": "how fast is ici", "q3": "what is xla"}
CORPUS_A = {"a1": "a tensor processing unit", "a2": "an accelerator chip",
            "a3": "a compiler for linear algebra", "a4": "very fast links"}


def _corpora(t):
    c1 = t.TextSet.from_corpus(CORPUS_Q).tokenize()
    c1.word2idx()
    c1.shape_sequence(4)
    c2 = t.TextSet.from_corpus(CORPUS_A).tokenize()
    c2.word2idx(existing_map=c1.get_word_index())
    c2.shape_sequence(6)
    return c1, c2


def test_relations_match_jax(tmp_path):
    p = tmp_path / "rel.csv"
    p.write_text("".join(f"{a},{b},{c}\n" for a, b, c in RELS) + "\n")

    def run(t):
        rels = t.read_relations(str(p))
        c1, c2 = _corpora(t)
        x, y = t.relation_pairs_to_arrays(rels, c1, c2)
        groups = t.relation_lists_to_groups(rels, c1, c2)
        return ([tuple(r) for r in rels],
                [tuple(r) for r in t.generate_relation_pairs(rels)],
                x.tolist(), y.tolist(),
                [(gx.tolist(), gy.tolist()) for gx, gy in groups],
                {k: v.tolist() for k, v in c1.indices_by_id().items()})
    j, pr = _both(run)
    assert pr == j
    assert len(pr[1]) == 4 and len(pr[2]) == 8 and len(pr[4]) == 3


def test_relations_errors_match_jax(tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text("q1,a1\n")
    c1, c2 = _corpora(ptext)
    with pytest.raises(ValueError, match="bad relation line"):
        ptext.read_relations(str(bad))
    with pytest.raises(KeyError, match="corpus2"):
        ptext.relation_pairs_to_arrays([ptext.Relation("q1", "zzz", 1),
                                        ptext.Relation("q1", "a1", 0)],
                                       c1, c2)
    with pytest.raises(ValueError, match="no relation pairs"):
        ptext.relation_pairs_to_arrays([ptext.Relation("q3", "a3", 1)],
                                       c1, c2)
    with pytest.raises(RuntimeError, match="uris"):
        ptext.TextSet.from_texts(["a b"]).tokenize().word2idx() \
            .shape_sequence(2).indices_by_id()


# ---------------------------------------------------------------------------
# KNRM
# ---------------------------------------------------------------------------

def _knrm_pair(**kwargs):
    """The JAX KNRM and the port's with its weights (and state), built
    after a reset of both packages' name counters."""
    jeng.reset_uids()
    jm = JaxKNRM(**kwargs)
    jm.init_weights(rng=jax.random.key(5))
    peng.reset_uids()
    pm = KNRM(**kwargs, device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params),
                       jax.tree.map(np.asarray, jm.net_state))
    return jm, pm


def _knrm_x(n=16, t1=4, t2=6, vocab=30, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.integers(1, vocab, (n, t1))
    d = rng.integers(1, vocab, (n, t2))
    d[::2, :2] = q[::2, :2]               # half the docs share query words
    return np.concatenate([q, d], axis=1).astype(np.int32)


@pytest.mark.parametrize("case", ["ranking", "classification", "frozen"])
def test_knrm_forward_and_gradient_match_jax(case):
    """The topology's names, the forward on transferred weights and the
    gradient of ``sum(y * dy)`` in every weight."""
    rng = np.random.default_rng(6)
    kwargs = dict(text1_length=4, text2_length=6, vocab_size=30,
                  embed_size=8, kernel_num=5)
    if case == "classification":
        kwargs["target_mode"] = "classification"
    if case == "frozen":
        kwargs.update(embed_weights=rng.normal(size=(30, 8)).astype(
            np.float32) * 0.3, train_embed=False)
    jm, pm = _knrm_pair(**kwargs)
    assert [n.name for n in pm.model._topo] == [
        n.name for n in jm.model._topo]
    x = _knrm_x()
    want = np.asarray(jm.predict(x, batch_size=16))
    got = pm.predict(x, batch_size=16)
    assert got.shape == (16, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    dy = rng.normal(size=(16, 1)).astype(np.float32)

    def jloss(p):
        out, _ = jm.model.apply(p, jm.net_state, jnp.asarray(x))
        return jnp.sum(out * dy)
    jg = peng.flatten_tree(jax.tree.map(np.asarray,
                                        jax.grad(jloss)(jm.params)))
    out = pm(torch.from_numpy(x))
    (out * torch.from_numpy(dy)).sum().backward()
    pg = {n.replace(".", "/"): p.grad.numpy()
          for n, p in pm.model.named_parameters()}
    assert sorted(pg) == sorted(jg)
    for n in jg:
        np.testing.assert_allclose(pg[n], jg[n], rtol=1e-4, atol=1e-6,
                                   err_msg=n)
    if case == "frozen":
        assert "embeddings" in dict(peng.named_state(pm.model)).__repr__()


def test_knrm_ranking_fit_matches_jax_and_evaluates():
    """rank_hinge on relation pairs, unshuffled, Adam: the port's fit
    against the JAX fit, then NDCG@k/MAP through ``RankerMixin`` on both
    from the same weights."""
    conf = {"zoo.seed": 0}
    jctx.init_zoo_context(conf=conf)
    pctx.init_zoo_context(conf=conf)
    kwargs = dict(text1_length=4, text2_length=6, vocab_size=30,
                  embed_size=8, kernel_num=5)
    jm, pm = _knrm_pair(**kwargs)
    p0 = peng.flatten_tree(jax.tree.map(np.asarray, jm.params))
    x = _knrm_x(32)
    y = np.tile(np.asarray([1, 0], np.float32), 16)
    jm.compile(optimizer="adam", loss="rank_hinge", lr=1e-2)
    pm.compile(optimizer="adam", loss="rank_hinge", lr=1e-2)
    want = jm.fit(x, y, batch_size=8, nb_epoch=2, shuffle=False)["loss"]
    got = pm.fit(x, y, batch_size=8, nb_epoch=2, shuffle=False)["loss"]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    jp = peng.flatten_tree(jax.tree.map(np.asarray, jm.params))
    pp = _np_params(pm.model)
    for name in jp:
        np.testing.assert_allclose(pp[name], jp[name], atol=1e-5, rtol=0,
                                   err_msg=name)
        rel = (np.linalg.norm(pp[name] - jp[name])
               / max(np.linalg.norm(jp[name] - p0[name]), 1e-12))
        assert rel <= 1e-3, f"{name}: update off by {rel}"
    groups = [(x[i:i + 4], np.asarray([1, 0, 0, 1], np.float32))
              for i in range(0, 32, 4)]
    for k in (1, 3):
        assert pm.evaluate_ndcg(groups, k=k) == pytest.approx(
            jm.evaluate_ndcg(groups, k=k), abs=1e-6)
    assert pm.evaluate_map(groups) == pytest.approx(jm.evaluate_map(groups),
                                                    abs=1e-6)


@pytest.mark.parametrize("frozen", [False, True])
def test_knrm_npz_both_ways(frozen, tmp_path):
    rng = np.random.default_rng(8)
    kwargs = dict(text1_length=4, text2_length=6, vocab_size=30,
                  embed_size=8, kernel_num=5)
    if frozen:
        kwargs.update(embed_weights=rng.normal(size=(30, 8)).astype(
            np.float32), train_embed=False)
    jm, pm = _knrm_pair(**kwargs)
    x = _knrm_x()
    want = np.asarray(jm.predict(x, batch_size=16))
    got = p_load_model(jm.save(str(tmp_path / "j.npz")), device="cpu")
    assert type(got) is KNRM
    np.testing.assert_allclose(got.predict(x, batch_size=16), want,
                               rtol=1e-4, atol=1e-6)
    back = j_load_model(pm.save(str(tmp_path / "p.npz")))
    np.testing.assert_allclose(np.asarray(back.predict(x, batch_size=16)),
                               want, rtol=1e-4, atol=1e-6)


def test_knrm_argument_errors_match_jax():
    for bad, match in ((dict(kernel_num=1), "kernel_num"),
                       (dict(target_mode="pairs"), "target_mode")):
        kwargs = dict(text1_length=2, text2_length=3, vocab_size=5, **bad)
        with pytest.raises(ValueError, match=match):
            JaxKNRM(**kwargs)
        with pytest.raises(ValueError, match=match):
            KNRM(**kwargs, device="cpu")


@pytest.mark.parametrize("module", [
    "analytics_zoo_tpu_torch.pipeline.api.keras.layers.advanced_activations",
    "analytics_zoo_tpu_torch.tfpark.bert_ner",
    "analytics_zoo_tpu_torch.feature.text",
    "analytics_zoo_tpu_torch.models.textmatching",
])
def test_text_modules_import_no_jax(module):
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "from analytics_zoo_tpu_torch.models.textmatching import KNRM\n"
        "m = KNRM(3, 4, vocab_size=9, embed_size=4, kernel_num=3, "
        "device='cpu').init_weights()\n"
        "import numpy as np\n"
        "assert m.predict(np.ones((2, 7), np.int32)).shape == (2, 1)\n"
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
