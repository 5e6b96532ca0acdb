"""The port's zoo models on the recurrent layers held to the JAX package
on numpy-seeded inputs and transferred weights: ``TextClassifier`` (cnn,
lstm, gru; a trainable ``Embedding`` and a frozen ``WordEmbedding``;
weight-only and static int8 serving, raw texts through ``TextSet``),
``AnomalyDetector`` (``unroll``, ``detect_anomalies``),
``SessionRecommender`` (with and without history,
``recommend_for_session``) and ``Seq2seq`` (every bridge, one and two
layers, ``infer`` with a stop sign): each forward, a training step and
the ``.npz`` both ways; then ``NNImageReader``. The layers themselves are
held to JAX in ``tests/test_torch_port_recurrent.py``.

Tolerances, each with its reason:
* f32 outputs 1e-5 (the same formulas, the sums in another order);
* a training step's loss 1e-5 and parameters 1e-4 absolute (Adam's
  normalised step on gradients that agree to rounding);
* bf16 2e-2 (the compute dtype's rounding of the same f32 sums);
* static int8 1e-4 (exact int8 products, the f32 rescale in the JAX
  order, f32 softmax after);
* numpy helpers, ``recommend_for_session``'s ranking, ``infer``'s stop
  and the reader's table exact.

Dropout in a training step draws no mask here: both packages' ``Dropout``
are given the same fixed keep pattern (:func:`fixed_dropout`).
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
from analytics_zoo_tpu.models.anomalydetection import \
    AnomalyDetector as JAnomalyDetector
from analytics_zoo_tpu.models.anomalydetection import \
    detect_anomalies as j_detect_anomalies
from analytics_zoo_tpu.models.anomalydetection import unroll as j_unroll
from analytics_zoo_tpu.models.common.zoo_model import \
    load_model as j_load_model
from analytics_zoo_tpu.models.recommendation import \
    SessionRecommender as JSessionRecommender
from analytics_zoo_tpu.models.seq2seq import Seq2seq as JSeq2seq
from analytics_zoo_tpu.models.textclassification import \
    TextClassifier as JTextClassifier
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras.layers import core as jcore
from analytics_zoo_tpu.pipeline.inference import InferenceModel as JaxIM
from analytics_zoo_tpu.pipeline.nnframes import \
    NNImageReader as JNNImageReader
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.feature import text as ptext
from analytics_zoo_tpu_torch.models.anomalydetection import (
    AnomalyDetector, detect_anomalies, unroll)
from analytics_zoo_tpu_torch.models.common.zoo_model import \
    load_model as p_load_model
from analytics_zoo_tpu_torch.models.recommendation import SessionRecommender
from analytics_zoo_tpu_torch.models.seq2seq import Seq2seq
from analytics_zoo_tpu_torch.models.textclassification import TextClassifier
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import core as pcore
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
from analytics_zoo_tpu_torch.pipeline.nnframes import NNImageReader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_OUT, STEP_PARAM, STEP_LOSS, BF16, STATIC = 1e-5, 1e-4, 1e-5, 2e-2, 1e-4


@pytest.fixture(autouse=True)
def contexts():
    pctx.reset_zoo_context()
    peng.reset_uids()
    jeng.reset_uids()
    conf = {"zoo.seed": 0}
    jctx.init_zoo_context(conf=conf)
    pctx.init_zoo_context(conf=conf)
    yield
    pctx.reset_zoo_context()
    jctx.reset_zoo_context()
    peng.set_policy()
    jeng.set_policy()


def _keep(shape, p):
    """A fixed keep pattern of ``shape`` dropping about ``p`` of it."""
    idx = np.arange(int(np.prod(shape)), dtype=np.int64).reshape(shape)
    return ((idx * 2654435761) % 1000) / 1000.0 >= p


@pytest.fixture()
def fixed_dropout(monkeypatch):
    """Both packages' ``Dropout`` in training apply the same fixed keep
    pattern (inverted scaling, the layers' own formula)."""
    def jcall(self, params, x, *, training=False, rng=None):
        if not training or self.p <= 0.0:
            return x
        keep = jnp.asarray(_keep(x.shape, self.p))
        return jnp.where(keep, x / (1.0 - self.p), 0.0).astype(x.dtype)

    def pcall(self, x, *, training=False, generator=None):
        if not training or self.p <= 0.0:
            return x
        keep = torch.from_numpy(_keep(tuple(x.shape), self.p)).to(x.device)
        return torch.where(keep, x / (1.0 - self.p),
                           torch.zeros((), dtype=x.dtype)).to(x.dtype)

    monkeypatch.setattr(jcore.Dropout, "call", jcall)
    monkeypatch.setattr(pcore.Dropout, "call", pcall)


def _trees(jm):
    return (jax.tree.map(np.asarray, jm.params),
            jax.tree.map(np.asarray, jm.net_state))


def _pair(jcls, pcls, seed=5, **kwargs):
    """The JAX model on its seeded init and the port's with its weights
    and state, built after a reset of both packages' name counters."""
    jeng.reset_uids()
    jm = jcls(**kwargs)
    jm.init_weights(rng=jax.random.key(seed))
    peng.reset_uids()
    pm = pcls(**kwargs, device="cpu")
    pm.load_jax_params(*_trees(jm))
    return jm, pm


def _assert_step(jm, pm, x, y, loss, batch=16, lr=1e-2):
    """One epoch of ``len(x) / batch`` Adam steps, unshuffled, on both:
    the losses and every parameter."""
    jm.compile(optimizer="adam", loss=loss, lr=lr)
    pm.compile(optimizer="adam", loss=loss, lr=lr)
    want = jm.fit(x, y, batch_size=batch, nb_epoch=1, shuffle=False)["loss"]
    got = pm.fit(x, y, batch_size=batch, nb_epoch=1, shuffle=False)["loss"]
    np.testing.assert_allclose(got, want, atol=STEP_LOSS, rtol=0)
    jp = peng.flatten_tree(jax.tree.map(np.asarray, jm.params))
    pp = {n.replace(".", "/"): p.detach().numpy()
          for n, p in pm.model.named_parameters()}
    assert sorted(pp) == sorted(jp)
    for n in jp:
        np.testing.assert_allclose(pp[n], jp[n], atol=STEP_PARAM, rtol=0,
                                   err_msg=n)


def _assert_npz_both_ways(jm, pm, x, tmp_path, cls):
    want = np.asarray(jm.predict(x, batch_size=8))
    got = p_load_model(jm.save(str(tmp_path / "j.npz")), device="cpu")
    assert type(got) is cls
    np.testing.assert_allclose(got.predict(x, batch_size=8), want,
                               atol=F32_OUT, rtol=F32_OUT)
    back = j_load_model(pm.save(str(tmp_path / "p.npz")))
    np.testing.assert_allclose(np.asarray(back.predict(x, batch_size=8)),
                               want, atol=F32_OUT, rtol=F32_OUT)


# ---------------------------------------------------------------------------
# TextClassifier
# ---------------------------------------------------------------------------

def _tc_kwargs(encoder, frozen, vocab=40, seq=12):
    kw = dict(class_num=3, token_length=8, sequence_length=seq,
              encoder=encoder, encoder_output_dim=8)
    if frozen:
        kw["embedding_weights"] = (np.random.default_rng(4).normal(
            size=(vocab, 8)) * 0.5).astype(np.float32)
    else:
        kw["vocab_size"] = vocab
    return kw


def _tc_ids(n=32, seq=12, vocab=40, seed=1):
    return np.random.default_rng(seed).integers(1, vocab, (n, seq)).astype(
        np.int32)


TC_CASES = [("cnn", False), ("cnn", True), ("lstm", True), ("lstm", False),
            ("gru", False)]


@pytest.mark.parametrize("encoder,frozen", TC_CASES)
def test_text_classifier_forward_matches_jax(encoder, frozen):
    """The layer names, the forward on transferred weights; a frozen
    table is model state, never a parameter."""
    jm, pm = _pair(JTextClassifier, TextClassifier,
                   **_tc_kwargs(encoder, frozen))
    assert [l.name for l in pm.model.layers] == [
        l.name for l in jm.model.layers]
    names = [n for n, _ in pm.model.named_parameters()]
    assert any("embeddings" in n for n in names) is not frozen
    x = _tc_ids()
    got = pm.predict(x, batch_size=16)
    assert got.shape == (32, 3)
    np.testing.assert_allclose(got, np.asarray(jm.predict(x, batch_size=16)),
                               atol=F32_OUT, rtol=F32_OUT)


@pytest.mark.parametrize("encoder", ["cnn", "lstm", "gru"])
def test_text_classifier_training_step_matches_jax(encoder, fixed_dropout):
    jm, pm = _pair(JTextClassifier, TextClassifier,
                   **_tc_kwargs(encoder, encoder == "lstm"))
    x = _tc_ids()
    y = (x[:, 0] % 3).astype(np.int32)
    _assert_step(jm, pm, x, y, "scce")


@pytest.mark.parametrize("frozen", [False, True])
def test_text_classifier_npz_both_ways(frozen, tmp_path):
    jm, pm = _pair(JTextClassifier, TextClassifier,
                   **_tc_kwargs("gru", frozen))
    _assert_npz_both_ways(jm, pm, _tc_ids(8), tmp_path, TextClassifier)


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, counted)
    return calls


def test_text_classifier_weight_only_int8_bf16_matches_jax(monkeypatch):
    """Weight-only int8 quantizes every float leaf of 512 entries or more:
    the LSTM's ``W`` and ``U`` and the table are dequantized once, at
    load, as ``bf16(q) * bf16(s)`` (fault k's rounding), and the two
    ``Dense`` layers (128 x 5 is 640 entries) run K6 (its plain version
    here) on the int8 weight.
    The predictions against the JAX int8 predict in bf16."""
    kw = _tc_kwargs("lstm", False, vocab=80)
    kw.update(token_length=32, encoder_output_dim=32, class_num=5)
    jm, pm = _pair(JTextClassifier, TextClassifier, **kw)
    x = _tc_ids(16, vocab=80)
    want = np.asarray(JaxIM().from_keras(jm, dtype="bfloat16",
                                         quantize="int8").predict(x))
    im = InferenceModel(device="cpu").from_keras(pm, dtype="bfloat16",
                                                 quantize="int8")
    lstm = im._model.model.layers[1]
    assert lstm.W.dtype == torch.bfloat16
    w = pm.model.layers[1].W.detach().numpy()
    amax = np.abs(w).max(axis=0)
    s = np.where(amax / 127.0 == 0, 1.0, amax / 127.0).astype(np.float32)
    q = np.clip(np.round(w / s), -127, 127)
    assert torch.equal(lstm.W, torch.from_numpy(q).to(torch.bfloat16)
                       * torch.from_numpy(s).to(torch.bfloat16))
    dense = [m for m in im._model.model.layers if type(m) is pcore.Dense]
    assert [d.W.dtype for d in dense] == [torch.int8, torch.int8]
    calls = _count_calls(monkeypatch, pcore, "int8_matmul")
    got = im.predict(x)
    assert len(calls) == 2
    np.testing.assert_allclose(got, want, atol=BF16, rtol=0)


@pytest.mark.parametrize("encoder", ["cnn", "lstm"])
def test_text_classifier_static_int8_matches_jax(encoder, monkeypatch):
    """Static int8 calibrates the two ``Dense`` layers (``Convolution1D``
    and the RNNs have no ``quantized_call``, as in JAX); up to 32 rows both
    run Q8 (its plain version here)."""
    jm, pm = _pair(JTextClassifier, TextClassifier,
                   **_tc_kwargs(encoder, True))
    x = _tc_ids(16)
    jim = JaxIM().from_keras(jm, quantize="int8", calibrate=x)
    im = InferenceModel(device="cpu").from_keras(pm, quantize="int8",
                                                 calibrate=x)
    assert sorted(im._act_scales) == sorted(
        l.name for l in pm.model.layers if type(l) is pcore.Dense)
    calls = _count_calls(monkeypatch, pcore, "static_int8_dense")
    got = im.predict(x)
    assert len(calls) == 2
    np.testing.assert_allclose(got, np.asarray(jim.predict(x)),
                               atol=STATIC, rtol=0)


def test_raw_texts_through_textset_train_a_text_classifier():
    """``tests/test_text.py``'s raw-text path: both packages' ``TextSet``
    give the same ids, and a cnn ``TextClassifier`` fits them as the JAX
    one does."""
    texts = [f"good movie {i} fun" if i % 2 else f"bad film {i} dull"
             for i in range(32)]
    labels = [i % 2 for i in range(32)]

    def ids(pkg):
        ts = (pkg.TextSet.from_texts(texts, labels).tokenize().word2idx()
              .shape_sequence(12))
        return ts.to_arrays(), len(ts.get_word_index()) + 1

    (jx, jy), jv = ids(jtext)
    (px, py), pv = ids(ptext)
    np.testing.assert_array_equal(px, jx)
    np.testing.assert_array_equal(py, jy)
    assert pv == jv
    kw = dict(class_num=2, token_length=16, sequence_length=12,
              encoder="cnn", encoder_output_dim=16, vocab_size=pv)
    jm, pm = _pair(JTextClassifier, TextClassifier, **kw)
    for m in (jm.model, pm.model):
        m.layers[-2].p = 0.0          # the fit below draws no dropout mask
    _assert_step(jm, pm, px, py.astype(np.int32), "scce")


# ---------------------------------------------------------------------------
# AnomalyDetector
# ---------------------------------------------------------------------------

def test_unroll_and_detect_anomalies_match_jax():
    t = np.arange(300, dtype=np.float32)
    series = np.stack([np.sin(t * 0.1), np.cos(t * 0.05)], 1)
    series[200, 0] = 5.0
    for step in (1, 3):
        for got, want in zip(unroll(series, 10, step),
                             j_unroll(series, 10, step)):
            np.testing.assert_array_equal(got, np.asarray(want))
    x, y, _ = unroll(series[:, 0], 10)
    pred = y + np.random.default_rng(0).normal(size=y.shape).astype(
        np.float32) * 0.01
    for k in (1, 3, 7):
        np.testing.assert_array_equal(detect_anomalies(y, pred, k),
                                      j_detect_anomalies(y, pred, k))
    with pytest.raises(ValueError, match="too short"):
        unroll(series[:5], 10)


def test_anomaly_detector_forward_step_and_npz(fixed_dropout, tmp_path):
    kw = dict(feature_shape=(10, 2), hidden_layers=(6, 8, 4),
              dropouts=(0.2, 0.2, 0.2))
    jm, pm = _pair(JAnomalyDetector, AnomalyDetector, **kw)
    x = np.random.default_rng(3).normal(size=(32, 10, 2)).astype(np.float32)
    y = x[:, -1, :1] * 0.5
    np.testing.assert_allclose(pm.predict(x), np.asarray(jm.predict(x)),
                               atol=F32_OUT, rtol=F32_OUT)
    _assert_step(jm, pm, x, y, "mse")
    _assert_npz_both_ways(jm, pm, x[:8], tmp_path, AnomalyDetector)
    with pytest.raises(ValueError, match="align"):
        AnomalyDetector((4, 1), (3, 2), (0.1,), device="cpu")


# ---------------------------------------------------------------------------
# SessionRecommender
# ---------------------------------------------------------------------------

def _session_data(n=32, sess=6, hist=5, items=20, seed=7):
    rng = np.random.default_rng(seed)
    xs = rng.integers(1, items + 1, (n, sess)).astype(np.int32)
    xh = rng.integers(1, items + 1, (n, hist)).astype(np.int32)
    return xs, xh, (xs[:, -1] - 1).astype(np.int32)


@pytest.mark.parametrize("history", [False, True])
def test_session_recommender_matches_jax(history, tmp_path):
    """Forward (the graph's positional names), one Adam epoch, then
    ``recommend_for_session`` from the trained weights and the ``.npz``
    both ways."""
    kw = dict(item_count=20, item_embed=8, rnn_hidden_layers=(8, 6),
              session_length=6)
    if history:
        kw.update(include_history=True, mlp_hidden_layers=(8,),
                  history_length=5)
    jm, pm = _pair(JSessionRecommender, SessionRecommender, **kw)
    assert [n.name for n in pm.model._topo] == [
        n.name for n in jm.model._topo]
    xs, xh, y = _session_data()
    x = [xs, xh] if history else xs
    np.testing.assert_allclose(pm.predict(x), np.asarray(jm.predict(x)),
                               atol=F32_OUT, rtol=F32_OUT)
    _assert_step(jm, pm, x, y, "scce")
    for zero_based in (True, False):
        got = pm.recommend_for_session(x, max_items=4,
                                       zero_based_label=zero_based)
        want = jm.recommend_for_session(x, max_items=4,
                                        zero_based_label=zero_based)
        assert [[i for i, _ in r] for r in got] == [
            [i for i, _ in r] for r in want]
        np.testing.assert_allclose([[p for _, p in r] for r in got],
                                   [[p for _, p in r] for r in want],
                                   atol=F32_OUT, rtol=0)
    xi = [xs[:8], xh[:8]] if history else xs[:8]
    _assert_npz_both_ways(jm, pm, xi, tmp_path, SessionRecommender)


# ---------------------------------------------------------------------------
# Seq2seq
# ---------------------------------------------------------------------------

S2S_CASES = {
    "lstm_dense_1": dict(rnn_type="lstm", num_layers=1, bridge="dense"),
    "gru_densenonlinear_2": dict(rnn_type="gru", num_layers=2,
                                 bridge="densenonlinear"),
    "lstm_passthrough_2": dict(rnn_type="lstm", num_layers=2,
                               bridge="passthrough",
                               generator_activation="tanh"),
}


def _s2s_pair(case, d=3):
    return _pair(JSeq2seq, Seq2seq, hidden_size=8, input_dim=d,
                 generator_dim=d, **S2S_CASES[case])


def _s2s_data(n=32, te=5, td=4, d=3, seed=6):
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(n, te, d)).astype(np.float32)
    dec = np.concatenate([np.zeros((n, 1, d), np.float32),
                          enc[:, :td - 1]], axis=1)
    return enc, dec, enc[:, :td]


@pytest.mark.parametrize("case", sorted(S2S_CASES))
def test_seq2seq_forward_step_and_npz_match_jax(case, tmp_path):
    jm, pm = _s2s_pair(case)
    assert sorted(n for n, _ in pm.model.named_parameters()) == sorted(
        k.replace("/", ".") for k in peng.flatten_tree(_trees(jm)[0]))
    enc, dec, target = _s2s_data()
    np.testing.assert_allclose(pm.predict([enc, dec]),
                               np.asarray(jm.predict([enc, dec])),
                               atol=F32_OUT, rtol=F32_OUT)
    _assert_step(jm, pm, [enc, dec], target, "mse")
    _assert_npz_both_ways(jm, pm, [enc[:8], dec[:8]], tmp_path, Seq2seq)


@pytest.mark.parametrize("case", sorted(S2S_CASES))
def test_seq2seq_infer_with_a_stop_sign_matches_jax(case):
    """``infer`` without a stop sign, then with one that the first row
    meets at its third step (its later outputs repeat it; the other rows
    run on), and a stop sign every row meets at once (one step)."""
    jm, pm = _s2s_pair(case)
    enc = np.random.default_rng(9).normal(size=(4, 5, 3)).astype(np.float32)
    start = np.zeros((4, 3), np.float32)
    want = jm.infer(enc, start_sign=start, max_seq_len=6)
    got = pm.infer(enc, start_sign=start, max_seq_len=6)
    assert got.shape == (4, 6, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_OUT, rtol=0)
    stop = np.asarray(want)[0, 2]
    want = np.asarray(jm.infer(enc, start_sign=start, max_seq_len=6,
                               stop_sign=stop))
    got = pm.infer(enc, start_sign=start, max_seq_len=6, stop_sign=stop)
    np.testing.assert_allclose(got, want, atol=F32_OUT, rtol=0)
    np.testing.assert_array_equal(got[0, 3:], np.broadcast_to(
        got[0, 2], got[0, 3:].shape))
    every = np.asarray(jm.infer(enc[:1], start_sign=start[0], max_seq_len=6))
    one = pm.infer(enc[:1], start_sign=start[0], max_seq_len=6,
                   stop_sign=every[0, 0])
    assert one.shape == (1, 1, 3)


def test_seq2seq_errors_match_jax():
    for bad, match in ((dict(rnn_type="rnn"), "rnn_type"),
                       (dict(bridge="sum"), "bridge")):
        with pytest.raises(ValueError, match=match):
            JSeq2seq(**bad)
        with pytest.raises(ValueError, match=match):
            Seq2seq(**bad, device="cpu")
    m = Seq2seq(device="cpu")
    with pytest.raises(RuntimeError, match="no weights"):
        m.infer(np.zeros((1, 2, 32), np.float32),
                np.zeros((32,), np.float32))


# ---------------------------------------------------------------------------
# NNImageReader
# ---------------------------------------------------------------------------

def test_nn_image_reader_table_matches_jax_and_trains(tmp_path):
    """The table of a per-class directory tree (images resized, paths,
    labels) equals the JAX reader's; an ``NNClassifier`` fits it."""
    from PIL import Image

    from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Convolution2D, Dense, Flatten)
    from analytics_zoo_tpu_torch.pipeline.nnframes import NNClassifier
    rng = np.random.default_rng(0)
    for cls, lo, hi in (("dark", 0, 80), ("bright", 170, 255)):
        d = tmp_path / cls
        d.mkdir()
        for i in range(8):
            Image.fromarray(rng.integers(lo, hi, (14, 12, 3)).astype(
                np.uint8)).save(d / f"{i}.png")
    for path, with_label in ((tmp_path / "dark", False), (tmp_path, True)):
        got = NNImageReader.read_images(str(path), 8, 8,
                                        with_label=with_label)
        want = JNNImageReader.read_images(str(path), 8, 8,
                                          with_label=with_label)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    model = Sequential([Convolution2D(4, 3, 3, activation="relu",
                                      input_shape=(8, 8, 3)),
                        Flatten(), Dense(2, activation="softmax")],
                       device="cpu")
    clf = (NNClassifier(model, feature_preprocessing=lambda t:
                        t["image"].astype(np.float32) / 255.0)
           .set_optim_method(optimizers.adam(0.01))
           .set_batch_size(8).set_max_epoch(10))
    out = clf.fit(got).transform(got)
    assert (out["prediction"] == got["label"]).mean() > 0.9


MODULES = [
    "analytics_zoo_tpu_torch.pipeline.api.keras.layers.recurrent",
    "analytics_zoo_tpu_torch.models.textclassification",
    "analytics_zoo_tpu_torch.models.anomalydetection",
    "analytics_zoo_tpu_torch.models.seq2seq",
    "analytics_zoo_tpu_torch.models.recommendation.session_recommender",
    "analytics_zoo_tpu_torch.pipeline.nnframes.nn_image_reader",
]


def test_recurrent_modules_import_no_jax():
    """Importing the slice's modules and fitting a small LSTM
    TextClassifier and a Seq2seq leaves jax and the JAX package out of
    ``sys.modules``."""
    code = (
        "import sys, importlib, numpy as np\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from analytics_zoo_tpu_torch.models.textclassification import "
        "TextClassifier\n"
        "from analytics_zoo_tpu_torch.models.seq2seq import Seq2seq\n"
        "m = TextClassifier(2, 4, 6, 'lstm', 4, vocab_size=9, "
        "device='cpu')\n"
        "m.compile(optimizer='adam', loss='scce')\n"
        "m.fit(np.ones((8, 6), np.int32), np.zeros(8, np.int32), "
        "batch_size=8, nb_epoch=1)\n"
        "s = Seq2seq(hidden_size=4, input_dim=3, generator_dim=3, "
        "device='cpu').init_weights()\n"
        "assert s.infer(np.ones((2, 3, 3), np.float32), "
        "np.zeros((2, 3), np.float32), 2).shape == (2, 2, 3)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'analytics_zoo_tpu' or "
        "n.startswith('analytics_zoo_tpu.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
