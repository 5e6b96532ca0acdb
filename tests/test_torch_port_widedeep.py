"""``WideAndDeep`` and the pipeline surface it trains through —
``Estimator``, ``LocalEstimator``, ``NNEstimator``/``NNModel``,
``NNClassifier``/``NNClassifierModel`` — held to the JAX package's on the
same numpy inputs (the Census-like tables of the JAX package's own tests),
with weights moved across.

Tolerances, each with its reason:
* forwards in f32: rtol 1e-5, atol 1e-6 (the same f32 arithmetic, other
  summation orders); out-of-range ids give NaN at the same places;
* fits (the JAX side runs on conftest's 8-device CPU mesh, so its
  gradients add in another order, then the optimizer): per-epoch losses
  and parameters 1e-4 (after 3 epochs of the 12-epoch fits); argmax
  predictions identical. At the end of the 12-epoch (96-step) Adam fits
  the parameters are held to 1e-3: Adam divides by the root of a
  weight's second moment, so where a weight's gradient is a sum that
  nearly cancels, its last bits move that weight by a fraction of a step
  — measured here, one weight of ``deep``'s first Dense moved 1.1e-4
  between epochs 9 and 10 while every other stayed within 4e-6 and the
  losses within 1e-6;
* a model saved and loaded (``.npz``, ``NNModel`` file): bit for bit.
Batches are multiples of 8 (the JAX mesh).
"""

import functools
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.common import triggers as jtriggers
from analytics_zoo_tpu.feature import FeatureSet as JFeatureSet
from analytics_zoo_tpu.models.common.zoo_model import \
    load_model as jload_model
from analytics_zoo_tpu.models.recommendation import WideAndDeep as JWide
from analytics_zoo_tpu.models.recommendation.wide_and_deep import \
    ColumnFeatureInfo as JInfo
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.estimator import Estimator as JEstimator
from analytics_zoo_tpu.pipeline.estimator import \
    LocalEstimator as JLocalEstimator
from analytics_zoo_tpu.pipeline.nnframes import NNClassifier as JNNClassifier
from analytics_zoo_tpu.pipeline.nnframes import NNEstimator as JNNEstimator
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.common import triggers as ptriggers
from analytics_zoo_tpu_torch.feature import FeatureSet as PFeatureSet
from analytics_zoo_tpu_torch.models.common.zoo_model import \
    load_model as pload_model
from analytics_zoo_tpu_torch.models.recommendation import (
    ColumnFeatureInfo as PInfo, WideAndDeep as PWide)
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as pl
from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as popt
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import \
    Sequential as PSequential
from analytics_zoo_tpu_torch.pipeline.estimator import (
    Estimator as PEstimator, LocalEstimator as PLocalEstimator)
from analytics_zoo_tpu_torch.pipeline.nnframes import (
    NNClassifier as PNNClassifier, NNClassifierModel, NNEstimator as
    PNNEstimator, NNModel)
from analytics_zoo_tpu_torch.utils.checkpoint import CheckpointManager
from analytics_zoo_tpu_torch.utils.prediction import probs_to_classes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
FIT_TOL = 1e-4
LONG_FIT_TOL = 1e-3
MODEL_TYPES = ["wide", "deep", "wide_n_deep"]


@pytest.fixture(autouse=True)
def contexts():
    pctx.reset_zoo_context()
    peng.reset_uids()
    jeng.reset_uids()
    yield
    pctx.reset_zoo_context()
    jctx.reset_zoo_context()


def _both_contexts(conf=None):
    conf = {"zoo.seed": 0, **(conf or {})}
    jctx.init_zoo_context(conf=conf)
    pctx.init_zoo_context(conf=conf)
    peng.reset_uids()
    jeng.reset_uids()


def _census_like(n=512, seed=0):
    """``tests/test_model_zoo.py``'s table (with the label as a column, as
    ``tests/test_estimator.py`` has it) and its column settings."""
    rng = np.random.default_rng(seed)
    table = {
        "gender": rng.integers(0, 2, n),
        "occupation": rng.integers(0, 10, n),
        "education": rng.integers(0, 5, n),
        "age_bucket": rng.integers(0, 8, n),
        "hours": rng.normal(size=n).astype(np.float32),
    }
    table["gender_x_occupation"] = table["gender"] * 10 + table["occupation"]
    table["label"] = ((table["occupation"] + table["education"]) % 2
                      ).astype(np.int32)
    cols = dict(
        wide_base_cols=["gender", "occupation"], wide_base_dims=[2, 10],
        wide_cross_cols=["gender_x_occupation"], wide_cross_dims=[20],
        indicator_cols=["education"], indicator_dims=[5],
        embed_cols=["occupation", "age_bucket"], embed_in_dims=[10, 8],
        embed_out_dims=[8, 8], continuous_cols=["hours"])
    return table, cols


def _pair(model_type, hidden=(16, 8), seed=1):
    """A JAX WideAndDeep with its own weights and the port's carrying
    them, built alike."""
    _, cols = _census_like()
    jm = JWide(model_type, 2, JInfo(**cols), hidden_layers=hidden)
    jm.init_weights(rng=jax.random.key(seed))
    pm = PWide(model_type, 2, PInfo(**cols), hidden_layers=hidden,
               device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
    return jm, pm


def _inputs(table, cols, model_type):
    x = PInfo(**cols).input_arrays(table, model_type)
    return x if len(x) > 1 else x[0]


def _jax_flat(jm):
    return peng.flatten_tree(jax.tree.map(np.asarray, jm.params))


def _port_flat(model):
    net = getattr(model, "model", model)
    return {n.replace(".", "/"): p.detach().numpy().copy()
            for n, p in net.named_parameters()}


def _assert_params_close(pm, jm, tol=FIT_TOL):
    want, got = _jax_flat(jm), _port_flat(pm)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=tol, atol=tol,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# WideAndDeep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_wide_and_deep_trees_and_forward_match_jax(model_type):
    """The param trees agree key for key and shape for shape (the
    ``_WideLinear``, indicator and softmax names, the positional names),
    the topo names agree, and so does the forward."""
    _both_contexts()
    jm, pm = _pair(model_type)
    want = {k: v.shape for k, v in _jax_flat(jm).items()}
    assert {k: v.shape for k, v in _port_flat(pm).items()} == want
    assert [n.name for n in pm.model._topo] == [n.name for n in
                                                jm.model._topo]
    table, cols = _census_like(64)
    x = _inputs(table, cols, model_type)
    np.testing.assert_allclose(pm.predict(x, batch_size=32),
                               np.asarray(jm.predict(x, batch_size=32)),
                               rtol=RTOL, atol=ATOL)
    assert pm.get_config() == jm.get_config()


def test_out_of_range_ids_follow_the_jax_rules():
    """Ids -1 and d in every lookup: the indicator one-hot wraps -1 and
    clamps d (``jnp.eye(d)[x]``); the wide table and the deep embeddings
    read NaN rows for ids outside (``jnp.take``'s fill) — the same
    outputs, NaN at the same places."""
    _both_contexts()
    jm, pm = _pair("wide_n_deep")
    table, cols = _census_like(16)
    table["education"][:4] = [-1, 5, -5, 6]          # indicator, d = 5
    table["age_bucket"][4:6] = [-1, 8]               # embed, d = 8
    table["gender_x_occupation"][6:8] = [-1, 20]     # wide cross, d = 20
    x = _inputs(table, cols, "wide_n_deep")
    want = np.asarray(jm.predict(x, batch_size=16))
    got = pm.predict(x, batch_size=16)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.isnan(got).any() and not np.isnan(got[:4]).any()
    # the pieces one at a time
    from analytics_zoo_tpu_torch.models.recommendation.wide_and_deep import \
        _IndicatorOneHot
    ids = np.array([[-1], [5], [-5], [6], [-6], [2]], np.int32)
    np.testing.assert_array_equal(
        _IndicatorOneHot([5])(torch.from_numpy(ids)).numpy(),
        np.asarray(jax.numpy.eye(5)[jax.numpy.asarray(ids[:, 0])]))


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_wide_and_deep_fit_matches_jax(model_type):
    """12 epochs at batch 64 on the Census-like data with Adam (the JAX
    model-zoo test, as 3 + 9 epochs: ``nb_epoch`` adds up): the same
    per-epoch losses, parameters (after 3 epochs and at the end), argmax
    predictions and accuracy."""
    _both_contexts()
    jm, pm = _pair(model_type)
    table, cols = _census_like()
    x, y = _inputs(table, cols, model_type), table["label"]
    for m in (jm, pm):
        m.compile(optimizer="adam", loss="scce", metrics=["accuracy"],
                  lr=0.01)
    hj = jm.fit(x, y, batch_size=64, nb_epoch=3)["loss"]
    hp = pm.fit(x, y, batch_size=64, nb_epoch=3)["loss"]
    _assert_params_close(pm, jm)
    hj += jm.fit(x, y, batch_size=64, nb_epoch=9)["loss"]
    hp += pm.fit(x, y, batch_size=64, nb_epoch=9)["loss"]
    np.testing.assert_allclose(hp, hj, rtol=FIT_TOL)
    assert hp[-1] < hp[0]
    _assert_params_close(pm, jm, tol=LONG_FIT_TOL)
    np.testing.assert_array_equal(pm.predict_classes(x, batch_size=64),
                                  jm.predict_classes(x, batch_size=64))
    assert pm.evaluate(x, y, batch_size=64)["accuracy"] == pytest.approx(
        jm.evaluate(x, y, batch_size=64)["accuracy"])


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_wide_and_deep_npz_loads_both_ways(tmp_path, model_type):
    _both_contexts()
    jm, pm = _pair(model_type, seed=3)
    table, cols = _census_like(64)
    x = _inputs(table, cols, model_type)
    p = pload_model(jm.save(str(tmp_path / "jax.npz")), device="cpu")
    assert isinstance(p, PWide)
    np.testing.assert_array_equal(p.predict(x, batch_size=32),
                                  pm.predict(x, batch_size=32))
    for key, a in _jax_flat(jm).items():
        np.testing.assert_array_equal(_port_flat(p)[key], a)
    pm2 = PWide(model_type, 2, PInfo(**cols), hidden_layers=(16, 8),
                device="cpu").init_weights(torch.Generator().manual_seed(5))
    j = jload_model(pm2.save(str(tmp_path / "port.npz")))
    for key, a in _port_flat(pm2).items():
        np.testing.assert_array_equal(_jax_flat(j)[key], a)
    np.testing.assert_allclose(np.asarray(j.predict(x, batch_size=32)),
                               pm2.predict(x, batch_size=32),
                               rtol=RTOL, atol=ATOL)


def test_wide_and_deep_refuses_bad_configs_as_jax():
    _, cols = _census_like()
    for Wide, Info in ((JWide, JInfo), (PWide, PInfo)):
        kw = {} if Wide is JWide else {"device": "cpu"}
        with pytest.raises(ValueError, match="model_type must be"):
            Wide("both", 2, Info(**cols), **kw)
        with pytest.raises(ValueError, match="wide model needs"):
            Wide("wide", 2, Info(indicator_cols=["a"], indicator_dims=[2]),
                 **kw)
        with pytest.raises(ValueError, match="deep model needs"):
            Wide("deep", 2, Info(wide_base_cols=["a"], wide_base_dims=[2]),
                 **kw)


# ---------------------------------------------------------------------------
# Estimator / LocalEstimator
# ---------------------------------------------------------------------------

def _mlp_data(n=512, d=8, classes=3, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, classes)).astype(np.float32)
    return x, np.argmax(x @ w, axis=1).astype(np.int32)


def _mlp_pair(d=8, classes=3, names=(None, None)):
    jm = JSequential([jl.Dense(32, activation="relu", input_shape=(d,),
                               name=names[0]),
                      jl.Dense(classes, activation="softmax",
                               name=names[1])])
    jm.init_weights(rng=jax.random.key(7))
    pm = PSequential([pl.Dense(32, activation="relu", input_shape=(d,),
                               name=names[0]),
                      pl.Dense(classes, activation="softmax",
                               name=names[1])], device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
    return jm, pm


@pytest.mark.parametrize("clip", ["none", "constant", "l2"])
def test_estimator_train_and_clipping_match_jax(clip):
    """``Estimator.train`` on a FeatureSet with validation, without
    clipping and with each clipping, as the JAX Estimator trains."""
    _both_contexts()
    x, y = _mlp_data()
    jm, pm = _mlp_pair()
    je = JEstimator(jm, optim_methods=optax.adam(0.01))
    pe = PEstimator(pm, optim_methods=popt.adam(0.01))
    for est in (je, pe):
        if clip == "constant":
            est.set_constant_gradient_clipping(-0.05, 0.02)
        elif clip == "l2":
            est.set_gradient_clipping_by_l2_norm(0.5)
    hj = je.train(JFeatureSet.array(x, y), "scce", batch_size=64,
                  nb_epoch=4, validation_set=JFeatureSet.array(x, y),
                  validation_methods=["accuracy"])
    hp = pe.train(PFeatureSet.array(x, y), "scce", batch_size=64,
                  nb_epoch=4, validation_set=PFeatureSet.array(x, y),
                  validation_methods=["accuracy"])
    np.testing.assert_allclose(hp["loss"], hj["loss"], rtol=FIT_TOL)
    np.testing.assert_allclose(hp["val_accuracy"], hj["val_accuracy"])
    _assert_params_close(pm, jm)
    rj = je.evaluate(JFeatureSet.array(x, y), ["accuracy"])
    rp = pe.evaluate(PFeatureSet.array(x, y), ["accuracy"])
    assert rp["accuracy"] == pytest.approx(rj["accuracy"])
    assert rp["loss"] == pytest.approx(rj["loss"], rel=FIT_TOL)


def test_estimator_per_submodule_optimizers_match_jax(tmp_path):
    """A dict of optim_methods is ``multi_optimizer``: a frozen backbone
    (sgd lr 0) keeps its bits while the head trains as JAX's does; the
    snapshots in ``model_dir`` hold the optimizer state in optax's leaf
    order."""
    _both_contexts()
    x, y = _mlp_data()
    jm, pm = _mlp_pair(names=("backbone", "head"))
    frozen = {k: v for k, v in _port_flat(pm).items()
              if k.startswith("backbone")}
    je = JEstimator(jm, optim_methods={"backbone": optax.sgd(0.0),
                                       "head": optax.adam(0.01)})
    pe = PEstimator(pm, optim_methods={"backbone": popt.sgd(0.0),
                                       "head": popt.adam(0.01)},
                    model_dir=str(tmp_path / "ck"))
    hj = je.train(JFeatureSet.array(x, y), "scce", batch_size=64,
                  nb_epoch=3)
    hp = pe.train(PFeatureSet.array(x, y), "scce", batch_size=64,
                  nb_epoch=3)
    np.testing.assert_allclose(hp["loss"], hj["loss"], rtol=FIT_TOL)
    _assert_params_close(pm, jm)
    for k, v in frozen.items():
        np.testing.assert_array_equal(_port_flat(pm)[k], v)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    meta = mgr.verify(mgr.latest())
    assert meta[0] == "ok" and mgr.latest() == 24


def test_estimator_triggers_and_checkpoint_keep_as_jax(tmp_path):
    """end_trigger MaxIteration(10) with checkpoint_trigger
    SeveralIteration(4): both stop at iteration 10 with the same losses
    and snapshots at the same steps; checkpoint_keep bounds retention."""
    _both_contexts()
    x, y = _mlp_data()
    out = {}
    for name, Est, FS, trig, Pair in (
            ("jax", JEstimator, JFeatureSet, jtriggers, 0),
            ("port", PEstimator, PFeatureSet, ptriggers, 1)):
        m = _mlp_pair()[Pair]
        est = Est(m, optim_methods="adam", model_dir=str(tmp_path / name))
        est.set_gradient_clipping_by_l2_norm(1.0)
        h = est.train(FS.array(x, y), "scce", batch_size=64, nb_epoch=3,
                      end_trigger=trig.MaxIteration(10),
                      checkpoint_trigger=trig.SeveralIteration(4),
                      checkpoint_keep=2)
        out[name] = (m.finished_iterations, h["loss"],
                     CheckpointManager(str(tmp_path / name)).steps())
    assert out["port"][0] == out["jax"][0] == 10
    np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=FIT_TOL)
    assert out["port"][2] == out["jax"][2] and len(out["port"][2]) == 2


def test_estimator_loop_reuse_and_clipping_reset():
    """The loop is reused for the same (criterion, validation methods) —
    the optimizer state continues — and rebuilt when either changes or
    the clipping changes."""
    pctx.init_zoo_context()
    x, y = _mlp_data(n=128)
    _, pm = _mlp_pair()
    est = PEstimator(pm, optim_methods=popt.adam(0.01))
    fs = PFeatureSet.array(x, y)
    est.train(fs, "scce", batch_size=64, nb_epoch=1)
    loop = est._loop
    est.train(fs, "scce", batch_size=64, nb_epoch=1)
    assert est._loop is loop and pm.opt_state["count"] == 4
    est.evaluate(fs, ["accuracy"])
    assert est._loop is not loop and est._last_criterion == "scce"
    loop = est._loop
    est.set_gradient_clipping_by_l2_norm(1.0)
    assert est._loop is None
    h = est.train(fs, "scce", batch_size=64, nb_epoch=1,
                  validation_methods=["accuracy"])
    assert est._loop is not loop and np.isfinite(h["loss"][-1])


def test_estimator_checkpoint_trigger_without_model_dir_warns(caplog):
    import logging
    pctx.init_zoo_context()
    x, y = _mlp_data(n=64)
    _, pm = _mlp_pair()
    est = PEstimator(pm, optim_methods="adam")
    with caplog.at_level(logging.WARNING,
                         logger="analytics_zoo_tpu_torch.estimator"):
        h = est.train(PFeatureSet.array(x, y), criterion="scce",
                      batch_size=32, nb_epoch=1,
                      checkpoint_trigger=ptriggers.SeveralIteration(1))
    assert any("no model_dir" in r.message for r in caplog.records)
    assert len(h["loss"]) == 1 and np.isfinite(h["loss"][0])
    with pytest.raises(TypeError, match="FeatureSet"):
        est.train((x, y))


def test_local_estimator_matches_jax():
    _both_contexts()
    x, y = _mlp_data(n=256, d=6, classes=2, seed=11)
    jm, pm = _mlp_pair(d=6, classes=2)
    hj = JLocalEstimator(jm, criterion="scce", optim_method="adam").fit(
        x, y, batch_size=32, nb_epoch=3, validation_data=(x, y),
        validation_methods=["accuracy"])
    hp = PLocalEstimator(pm, criterion="scce", optim_method="adam").fit(
        x, y, batch_size=32, nb_epoch=3, validation_data=(x, y),
        validation_methods=["accuracy"])
    np.testing.assert_allclose(hp["loss"], hj["loss"], rtol=FIT_TOL)
    np.testing.assert_allclose(hp["val_accuracy"], hj["val_accuracy"])
    _assert_params_close(pm, jm)


# ---------------------------------------------------------------------------
# NNEstimator / NNClassifier
# ---------------------------------------------------------------------------

def test_nnestimator_assembled_columns_match_jax():
    """Scalar and array columns assembled into one float matrix; a
    sigmoid head trained on them as JAX's, its ``transform`` appending
    the same predictions."""
    _both_contexts()
    x, y = _mlp_data(d=6, classes=2)
    table = {"f_a": x[:, :3], "f_b": x[:, 3:5], "f_c": x[:, 5],
             "label": y.astype(np.float32)}
    jm = JSequential([jl.Dense(16, activation="relu", input_shape=(6,)),
                      jl.Dense(1, activation="sigmoid")])
    jm.init_weights(rng=jax.random.key(2))
    pm = PSequential([pl.Dense(16, activation="relu", input_shape=(6,)),
                      pl.Dense(1, activation="sigmoid")], device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
    outs = []
    for Est, m, opt in ((JNNEstimator, jm, optax.adam(0.01)),
                        (PNNEstimator, pm, popt.adam(0.01))):
        nne = (Est(m, "binary_crossentropy")
               .set_features_col("f_a", "f_b", "f_c").set_optim_method(opt)
               .set_batch_size(64).set_max_epoch(5))
        outs.append(nne.fit(table).transform(table))
    assert outs[1]["prediction"].shape == (len(y), 1)
    np.testing.assert_allclose(outs[1]["prediction"],
                               np.asarray(outs[0]["prediction"]),
                               rtol=FIT_TOL, atol=FIT_TOL)
    assert set(outs[1]) == set(table) | {"prediction"}


def test_nnclassifier_argmax_and_missing_column():
    """``NNClassifierModel.transform``'s prediction is the argmax of the
    model's predict, int32; a missing feature or label column raises."""
    pctx.init_zoo_context()
    x, y = _mlp_data()
    _, pm = _mlp_pair()
    model = (PNNClassifier(pm).set_optim_method(popt.adam(0.01))
             .set_batch_size(64).set_max_epoch(5)).fit(
        {"features": x, "label": y})
    assert isinstance(model, NNClassifierModel)
    out = model.transform({"features": x})
    assert out["prediction"].dtype == np.int32
    np.testing.assert_array_equal(
        out["prediction"], probs_to_classes(pm.predict(x, batch_size=32)))
    assert (out["prediction"] == y).mean() > 0.8
    with pytest.raises(KeyError):
        PNNEstimator(pm).set_features_col("nope").fit(
            {"features": x, "label": y.astype(np.float32)})
    with pytest.raises(KeyError, match="label column"):
        PNNEstimator(pm).fit({"features": x})


def _wd_classifiers(info_p, info_j):
    jm, pm = _pair("wide_n_deep", seed=4)
    jclf = (JNNClassifier(jm, feature_preprocessing=functools.partial(
        info_j.input_arrays, model_type="wide_n_deep"))
        .set_optim_method(optax.adam(0.01)).set_batch_size(64)
        .set_max_epoch(12))
    pclf = (PNNClassifier(pm, feature_preprocessing=functools.partial(
        info_p.input_arrays, model_type="wide_n_deep"))
        .set_optim_method(popt.adam(0.01)).set_batch_size(64)
        .set_max_epoch(12))
    return jclf, pclf


def test_nnclassifier_wide_and_deep_census_matches_jax(tmp_path):
    """The Census-like W&D through NNClassifier with a multi-input
    ``feature_preprocessing`` (the JAX test's path): the same parameters
    and predictions as the JAX pipeline, training accuracy above 0.8."""
    _both_contexts()
    table, cols = _census_like()
    jclf, pclf = _wd_classifiers(PInfo(**cols), JInfo(**cols))
    jmodel, pmodel = jclf.fit(table), pclf.fit(table)
    _assert_params_close(pclf.model, jclf.model, tol=LONG_FIT_TOL)
    got = pmodel.transform(table)["prediction"]
    np.testing.assert_array_equal(got, jmodel.transform(table)["prediction"])
    assert (got == table["label"]).mean() > 0.8


def test_nnmodel_save_load_in_a_fresh_process(tmp_path):
    """A fitted W&D NNClassifierModel saved (one pickle file, weights on
    the host, no loop or optimizer state) and loaded in a fresh process
    on the CPU gives the same predictions bit for bit."""
    pctx.init_zoo_context()
    table, cols = _census_like(256)
    _, pclf = _wd_classifiers(PInfo(**cols), JInfo(**cols))
    pclf.set_max_epoch(2)
    model = pclf.fit(table)
    preds = model.transform(table)["prediction"]
    path = str(tmp_path / "sub" / "fitted.nnmodel")
    assert model.save(path) == path
    assert not os.path.exists(path + ".tmp")
    assert pclf.model._loop is not None       # the original keeps its loop
    with pytest.raises(FileExistsError):
        model.save(path, over_write=False)
    np.save(tmp_path / "preds.npy", preds)
    np.savez(tmp_path / "table.npz", **table)
    code = (
        "import sys, numpy as np\n"
        "from analytics_zoo_tpu_torch.pipeline.nnframes import NNModel, "
        "NNClassifierModel\n"
        f"m = NNModel.load({path!r}, device='cpu')\n"
        "assert isinstance(m, NNClassifierModel), type(m).__name__\n"
        "assert m.model._loop is None and m.model.opt_state is None\n"
        f"t = dict(np.load({str(tmp_path / 'table.npz')!r}))\n"
        "out = m.transform(t)['prediction']\n"
        f"np.testing.assert_array_equal(out, np.load("
        f"{str(tmp_path / 'preds.npy')!r}))\n"
        "bad = [n for n in sys.modules if n == 'jax' or "
        "n.startswith('analytics_zoo_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ROUNDTRIP_OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert "ROUNDTRIP_OK" in proc.stdout, proc.stdout + proc.stderr


def test_nnmodel_save_refuses_a_lambda_preprocessing(tmp_path):
    pctx.init_zoo_context()
    x, y = _mlp_data(n=64)
    _, pm = _mlp_pair()
    model = (PNNClassifier(pm, feature_preprocessing=lambda t: t["features"])
             .set_optim_method(popt.adam(0.01)).set_batch_size(32)
             .set_max_epoch(1)).fit({"features": x, "label": y})
    with pytest.raises(ValueError, match="picklable"):
        model.save(str(tmp_path / "nope.nnmodel"))
    assert not os.path.exists(str(tmp_path / "nope.nnmodel"))


# ---------------------------------------------------------------------------
# no jax in the port's new modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", [
    "analytics_zoo_tpu_torch.models.recommendation.wide_and_deep",
    "analytics_zoo_tpu_torch.pipeline.estimator.estimator",
    "analytics_zoo_tpu_torch.pipeline.nnframes.nn_estimator",
])
def test_widedeep_modules_import_no_jax(module):
    """Importing the module and fitting a tiny W&D through NNClassifier
    leaves jax and the JAX package out of ``sys.modules``."""
    code = (
        "import sys, importlib, functools, numpy as np\n"
        f"importlib.import_module({module!r})\n"
        "from analytics_zoo_tpu_torch.models.recommendation import "
        "WideAndDeep, ColumnFeatureInfo\n"
        "from analytics_zoo_tpu_torch.pipeline.nnframes import NNClassifier\n"
        "info = ColumnFeatureInfo(wide_base_cols=['a'], wide_base_dims=[3],"
        " indicator_cols=['a'], indicator_dims=[3], continuous_cols=['c'])\n"
        "t = {'a': np.arange(16) % 3, 'c': np.ones(16, np.float32), "
        "'label': np.arange(16) % 2}\n"
        "m = WideAndDeep('wide_n_deep', 2, info, (4,), device='cpu')\n"
        "clf = NNClassifier(m, feature_preprocessing=functools.partial("
        "info.input_arrays, model_type='wide_n_deep')).set_batch_size(8)\n"
        "clf.fit(t).transform(t)\n"
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
