"""The rest of the port's optimizers and metrics held to the JAX package:
rmsprop, adagrad, adadelta, adamax and ``multi_optimizer`` against the
optax transformations the JAX constructors build, the per-step values
every update reads against ``_bias_correction`` and the schedules,
``resolve_lr``, and top-5 accuracy, MAE, MSE and AUC against JAX
``metrics.py`` (padded tails masked) and through ``evaluate``.

Tolerances, each with its reason:
* optimizers: 1e-6 relative, 1e-7 absolute after six updates (the same
  f32 rules; torch may fuse a multiply-add where XLA rounds twice, and
  ``rsqrt`` may differ in its last bit);
* per-step values: the bits of ``_bias_correction`` and of the schedule
  rounded to f32;
* metrics: 1e-6 relative (f32 sums in another order); top-5 counts
  exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JaxSequential
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras import metrics as jmet
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as pl
from analytics_zoo_tpu_torch.pipeline.api.keras import metrics as pmet
from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as popt
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential


@pytest.fixture(autouse=True)
def contexts():
    pctx.reset_zoo_context()
    peng.reset_uids()
    jeng.reset_uids()
    yield
    pctx.reset_zoo_context()
    jctx.reset_zoo_context()


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

_CASES = {
    "rmsprop": lambda m: m.rmsprop(),
    "rmsprop_args": lambda m: m.rmsprop(lr=0.01, rho=0.8, epsilon=1e-6),
    "rmsprop_schedule": lambda m: m.rmsprop(
        lr=m.linear_schedule(0.02, 0.0, 5)
        if m is popt else optax.linear_schedule(0.02, 0.0, 5)),
    "adagrad": lambda m: m.adagrad(),
    "adagrad_lr": lambda m: m.adagrad(lr=0.1),
    "adadelta": lambda m: m.adadelta(),
    "adadelta_args": lambda m: m.adadelta(lr=0.5, rho=0.9, epsilon=1e-6),
    "adamax": lambda m: m.adamax(),
    "adamax_args": lambda m: m.adamax(lr=0.01, beta_1=0.8, beta_2=0.99,
                                      epsilon=1e-7),
    "adamax_by_name": lambda m: m.get_optimizer("adamax", lr=0.05),
    "rmsprop_clipped": lambda m: m.with_clipping(m.rmsprop(lr=0.01),
                                                 clip_norm=0.5),
}

_SHAPES = {"dense_0": {"W": (5, 3), "b": (3,)},
           "dense_1": {"W": (3, 2)},
           "embedding_2": {"E": (7, 2)}}


def _tree_data(seed, steps=6):
    rng = np.random.default_rng(seed)

    def tree():
        return {layer: {n: rng.normal(size=s).astype(np.float32)
                        for n, s in leaves.items()}
                for layer, leaves in _SHAPES.items()}
    return tree(), [tree() for _ in range(steps)]


def _flat(tree):
    """The port's parameter names: ``layer.leaf``."""
    return {f"{layer}.{n}": torch.from_numpy(a.copy())
            for layer, leaves in tree.items() for n, a in leaves.items()}


def _run_both(jo, po, seed):
    params, grads = _tree_data(seed)
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    pp = _flat(params)
    ps = po.init(pp)
    rows = popt.scalar_rows(po, 0, len(grads), "cpu")
    for g, row in zip(grads, rows):
        upd, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        pu, _ = po.update(_flat(g), ps, pp, row)
        popt.apply_updates(pp, pu)
    for layer, leaves in jp.items():
        for n, a in leaves.items():
            np.testing.assert_allclose(pp[f"{layer}.{n}"].numpy(),
                                       np.asarray(a), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{layer}.{n}")


@pytest.mark.parametrize("case", sorted(_CASES))
def test_optimizer_matches_optax(case):
    """Six updates on the same params and gradients as the JAX package's
    optax transformation."""
    _run_both(_CASES[case](jopt), _CASES[case](popt), seed=len(case))


@pytest.mark.parametrize("rules,default", [
    ({"dense": "sgd"}, "adam"),
    ({"dense_1": "adamax", "embedding": "adagrad"}, "rmsprop"),
    ({"dense_0": "adam", "__default__": "sgd"}, "adamax"),
])
def test_multi_optimizer_matches_optax_multi_transform(rules, default):
    """Parameters routed by their layer's name prefix; the first matching
    rule wins, ``__default__`` over ``default``."""
    _run_both(jopt.multi_optimizer(rules, default),
              popt.multi_optimizer(rules, default), seed=11)


@pytest.mark.parametrize("name,kw", [
    ("adam", {}), ("adam", {"beta_1": 0.8, "beta_2": 0.95}),
    ("adamax", {}), ("adamw", {"warmup_portion": 0.2, "total": 50}),
    ("sgd", {"decay": 0.1}), ("adam", {"schedule": "poly",
                                      "max_iterations": 40}),
])
def test_per_step_values_are_the_host_values_in_f32(name, kw):
    """``step_scalars`` over a block: Adam's and Adamax's bias corrections
    are ``_bias_correction``'s bits for count + 1, and a schedule's value
    is ``-lr(count)`` rounded to f32, for every step of the block."""
    opt = popt.get_optimizer(name, lr=0.01, **kw)
    rows = popt.step_scalars(opt, 7, 30)
    assert rows.dtype == np.float32 and rows.shape[0] == 30
    lr = popt.resolve_lr(name, lr=0.01, **kw)
    for j, row in enumerate(rows):
        count = 7 + j
        want = []
        if name in ("adam", "adamw"):
            b1, b2 = kw.get("beta_1", 0.9), kw.get("beta_2", 0.999)
            want += [popt._bias_correction(b1, count + 1),
                     popt._bias_correction(b2, count + 1)]
        elif name == "adamax":
            want += [popt._bias_correction(0.9, count + 1)]
        if callable(lr):
            want += [-lr(count)]
        np.testing.assert_array_equal(row, np.asarray(want, np.float32))
    # the block's rows are the rows of one step at a time
    np.testing.assert_array_equal(
        rows[4], popt.step_scalars(opt, 11, 1)[0])


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"decay": 0.5}), ("adam", {"lr": 0.02}),
    ("adam", {"schedule": "warmup_linear", "warmup_steps": 3,
              "total_steps": 9}),
    ("adamw", {"lr": 1e-3, "warmup_portion": 0.25, "total": 8}),
    ("rmsprop", {}), ("adagrad", {"lr": 0.3}), ("adadelta", {}),
    ("adamax", {"lr": 0.004}),
])
def test_resolve_lr_matches_jax(name, kw):
    want, got = jopt.resolve_lr(name, **kw), popt.resolve_lr(name, **kw)
    assert callable(want) == callable(got)
    if callable(want):
        for step in (0, 1, 2, 3, 5, 8, 20):
            assert got(step) == pytest.approx(float(want(step)), rel=1e-6)
    else:
        assert got == want
    assert popt.resolve_lr(popt.sgd()) is None


def test_multi_optimizer_fit_matches_jax():
    """A ``Sequential`` compiled with ``multi_optimizer`` (the first Dense
    on sgd, the rest on adam) fitted two epochs, eager and four steps a
    dispatch, against the JAX fit."""
    x = np.random.default_rng(0).normal(size=(48, 6)).astype(np.float32)
    y = (np.abs(x[:, 0]) * 2 % 3).astype(np.int32)
    for conf in ({}, {"zoo.train.scan_steps": 4}):
        jctx.init_zoo_context(conf=conf)
        pctx.reset_zoo_context()
        pctx.init_zoo_context(conf=conf)
        jeng.reset_uids()
        peng.reset_uids()
        jm = JaxSequential([jl.Dense(8, activation="relu",
                                     input_shape=(6,)),
                            jl.Dense(3, activation="softmax")])
        jm.init_weights(rng=jax.random.key(2))
        pm = Sequential([pl.Dense(8, activation="relu", input_shape=(6,)),
                         pl.Dense(3, activation="softmax")], device="cpu")
        pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
        rules = {"dense_0": "sgd"}
        jm.compile(optimizer=jopt.multi_optimizer(rules, "adam"),
                   loss="scce")
        pm.compile(optimizer=popt.multi_optimizer(rules, "adam"),
                   loss="scce")
        want = jm.fit(x, y, batch_size=8, nb_epoch=2)["loss"]
        got = pm.fit(x, y, batch_size=8, nb_epoch=2)["loss"]
        np.testing.assert_allclose(got, want, rtol=1e-5)
        jp = peng.flatten_tree(jax.tree.map(np.asarray, jm.params))
        for n, p in pm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       jp[n.replace(".", "/")], rtol=1e-4,
                                       atol=1e-5, err_msg=n)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _metric_inputs(kind, seed, b=12, c=9):
    rng = np.random.default_rng(seed)
    mask = np.ones(b, np.float32)
    mask[-3:] = 0.0      # a padded tail
    if kind == "top5":
        logits = rng.normal(size=(b, c)).astype(np.float32)
        logits[0, :6] = 1.0                   # ties among the top five
        return rng.integers(0, c, b).astype(np.int32), logits, mask
    if kind == "auc":
        return (rng.integers(0, 2, (b, 1)).astype(np.float32),
                rng.uniform(size=(b, 1)).astype(np.float32), mask)
    return (rng.normal(size=(b, 3)).astype(np.float32),
            rng.normal(size=(b, 3)).astype(np.float32), mask)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("name", ["top5", "top5_accuracy", "mae", "mse",
                                  "auc"])
def test_metric_matches_jax(name, masked):
    kind = "top5" if name.startswith("top5") else (
        "auc" if name == "auc" else "err")
    jm_, pm_ = jmet.get_metric(name), pmet.get_metric(name)
    assert pm_.name == jm_.name
    stats_j, stats_p = None, None
    # two batches, summed as evaluate sums them
    batches = [_metric_inputs(kind, seed) for seed in (1, 2)]
    for (y, yp, mask), (jy, jyp, jmask) in zip(
            batches, jax.tree.map(jnp.asarray, batches)):
        sj = jm_.update(jy, jyp, jmask if masked else None)
        sp = pm_.update(torch.from_numpy(y), torch.from_numpy(yp),
                        torch.from_numpy(mask) if masked else None)
        stats_j = sj if stats_j is None else jax.tree.map(
            lambda a, b: a + b, stats_j, sj)
        stats_p = sp if stats_p is None else {
            k: stats_p[k] + v for k, v in sp.items()}
    for k in stats_j:
        np.testing.assert_allclose(stats_p[k].numpy(),
                                   np.asarray(stats_j[k]), rtol=1e-6,
                                   err_msg=k)
    host = {k: (v.item() if v.dim() == 0 else v) for k, v in stats_p.items()}
    assert pm_.finalize(host) == pytest.approx(
        float(jm_.finalize(stats_j)), rel=1e-6)


def _evaluate_both(out, act, loss, metrics, y, seed):
    """The JAX and port evaluate of one ``Dense(out, act)`` on the same
    weights, over 50 rows at batch 16 (a padded tail of 14 rows)."""
    x = np.random.default_rng(5).normal(size=(50, 6)).astype(np.float32)
    jeng.reset_uids()
    peng.reset_uids()
    jm = JaxSequential([jl.Dense(out, activation=act, input_shape=(6,))])
    jm.init_weights(rng=jax.random.key(seed))
    pm = Sequential([pl.Dense(out, activation=act, input_shape=(6,))],
                    device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
    jm.compile(optimizer="sgd", loss=loss, metrics=metrics)
    pm.compile(optimizer="sgd", loss=loss, metrics=metrics)
    want = jm.evaluate(x, y(x), batch_size=16)
    got = pm.evaluate(x, y(x), batch_size=16)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-5), k


def test_evaluate_resolves_every_metric_and_masks_the_padded_tail():
    """``evaluate`` with every metric by name, against the JAX evaluate:
    accuracy and top-5 on a 7-way softmax head, MAE and MSE on a linear
    3-wide regression head, AUC on a sigmoid head."""
    jctx.init_zoo_context()
    pctx.init_zoo_context()
    _evaluate_both(7, "softmax", "scce", ["accuracy", "top5"],
                   lambda x: (np.abs(x[:, 0]) * 5 % 7).astype(np.int32), 0)
    _evaluate_both(3, None, "mse", ["mae", "mse"],
                   lambda x: x[:, :3] * 2.0, 1)
    _evaluate_both(1, "sigmoid", "bce", ["auc"],
                   lambda x: (x[:, :1] > 0).astype(np.float32), 2)
