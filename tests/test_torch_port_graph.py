"""The rest of the port's graph engine held to the JAX package's on the
same numpy inputs, with weights moved across: ``Lambda`` and the
``Variable`` operators (names, shapes, values, gradients), the autograd
op library and ``CustomLoss`` (values, and a fit eager and on the
multi-step program), the core layers added with this slice (output, shape
rule; the noise layers by their statistics and the identity at
inference), ``L2Normalize``, ``SparseEmbedding``'s combiners, and
``WordEmbedding`` frozen (constant model state, through a checkpoint and
the ``.npz`` both ways) and trainable.

Tolerances, each with its reason:
* forwards in f32: rtol 1e-5, atol 1e-6 (the same f32 arithmetic, other
  summation orders); a gather, a reshape or a select: bit for bit;
* gradients: 1e-5;
* small fits (the JAX side sums over conftest's 8-device CPU mesh, so its
  gradients add in another order, then Adam): per-epoch losses and final
  parameters 1e-4;
* the noise layers: their draws differ between torch and JAX, so they
  are held to the distribution (mean and standard deviation of 200,000
  draws within 0.01 of the law's), and to the identity at inference.
Batches are multiples of 8 (the JAX mesh).
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.pipeline.api.autograd as JA
import analytics_zoo_tpu_torch.pipeline.api.autograd as PA
from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.models.common import zoo_model as jzoo
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.utils.checkpoint import \
    CheckpointManager as JCheckpointManager
from analytics_zoo_tpu.observability import MetricsRegistry as JRegistry
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.models.common import zoo_model as pzoo
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as pl
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import \
    Sequential as PSequential

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5
FIT_TOL = 1e-4


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


def _x(shape, seed=0, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _graphs(expr_fn, arrays):
    """The same expression built with each package's functional API on
    Inputs of the arrays' shapes: (JAX model, its params, port model)."""
    peng.reset_uids()
    jeng.reset_uids()
    jins = [jeng.Input(shape=a.shape[1:]) for a in arrays]
    jm = jeng.Model(jins if len(jins) > 1 else jins[0],
                    expr_fn(JA, *jins))
    jp = jm.build(jax.random.key(0), None)
    pins = [peng.Input(shape=a.shape[1:]) for a in arrays]
    pm = peng.Model(pins if len(pins) > 1 else pins[0],
                    expr_fn(PA, *pins), device="cpu").init_weights()
    return jm, jp, pm


def _run_both(expr_fn, *arrays, grads=False):
    """Outputs (and with ``grads``, the gradients of a weighted sum of the
    output with respect to each input) of both graphs."""
    jm, jp, pm = _graphs(expr_fn, arrays)
    assert [n.name for n in pm._topo] == [n.name for n in jm._topo]
    jx = [jnp.asarray(a) for a in arrays]
    want = np.asarray(jm.call(jp, jx if len(jx) > 1 else jx[0]))
    px = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = pm(px if len(px) > 1 else px[0])
    got = out.detach().numpy()
    assert pm.compute_output_shape(pm.input_shape) == \
        jm._built_output_shape[0]
    if not grads:
        return want, got
    w = _x(want.shape, seed=99)
    jg = jax.grad(lambda xs: jnp.sum(jm.call(
        jp, xs if len(xs) > 1 else xs[0]) * w))(jx)
    (out * torch.from_numpy(w)).sum().backward()
    # an input the output does not use gets no gradient (JAX: zeros)
    return want, got, [np.asarray(g) for g in jg], [
        np.zeros_like(a) if t.grad is None else t.grad.numpy()
        for t, a in zip(px, arrays)]


def _assert_close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Variable operators and slicing
# ---------------------------------------------------------------------------

_A = _x((8, 4), 1)
_B = _x((8, 4), 2, lo=0.5, hi=2.0)

BINARY_CASES = {
    "add": lambda A, a, b: a + b,
    "add_const": lambda A, a, b: a + 2.0,
    "radd": lambda A, a, b: 2.0 + a,
    "sub": lambda A, a, b: a - b,
    "rsub": lambda A, a, b: 3.0 - b,
    "mul": lambda A, a, b: a * b,
    "rmul": lambda A, a, b: 0.5 * a,
    "div": lambda A, a, b: a / b,
    "rdiv": lambda A, a, b: 2.0 / b,
    "pow": lambda A, a, b: b ** 2.5,
    "neg": lambda A, a, b: -a + b,
    "array_const": lambda A, a, b: a * np.arange(4, dtype=np.float32),
    "chain": lambda A, a, b: (a - b) * (a + 1.0) / (b ** 2.0),
}


@pytest.mark.parametrize("case", sorted(BINARY_CASES))
def test_variable_operators_match_jax(case):
    """Each operator is a Lambda node with the JAX name prefix: the same
    topo names, output shape, values and input gradients."""
    fn = BINARY_CASES[case]
    want, got, jg, pg = _run_both(fn, _A, _B, grads=True)
    _assert_close(got, want)
    for g, w in zip(pg, jg):
        _assert_close(g, w, rtol=GRAD_TOL, atol=GRAD_TOL)


SLICE_CASES = {
    "getitem_slice": lambda v: v[:, 1:3],
    "getitem_int": lambda v: v[:, 0],
    "getitem_ellipsis": lambda v: v[..., -1],
    "slice": lambda v: v.slice(1, 1, 2),
    "index_select": lambda v: v.index_select(1, 2),
    "index_select_negative": lambda v: v.index_select(1, -1),
    "index_select_out_of_range": lambda v: v.index_select(1, 7),
    "squeeze": lambda v: v.slice(1, 2, 1).squeeze(1),
}


@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_variable_slicing_matches_jax(case):
    """Slices are bit for bit; ``index_select`` is ``jnp.take``: a
    negative index wraps, an index past the end reads NaN."""
    fn = SLICE_CASES[case]
    want, got = _run_both(lambda A, v: fn(v), _A)
    np.testing.assert_array_equal(got, want)
    if case == "index_select_out_of_range":
        assert np.isnan(got).all()


def test_variable_names_use_the_jax_prefixes():
    peng.reset_uids()
    a, b = peng.Input(shape=(4,)), peng.Input(shape=(4,))
    outs = [a + b, a - 1.0, 2.0 * a, a / b, a ** 2.0, -a, a[:, 0],
            a.slice(1, 0, 2), a.index_select(1, 0), a.slice(1, 0, 1)]
    outs.append(outs[-1].squeeze(1))
    assert [v.name for v in outs] == [
        "add_1", "sub_1", "mul_1", "div_1", "pow_1", "neg_1", "slice_1",
        "slice_2", "indexselect_1", "slice_3", "squeeze_1"]


def test_squeeze_refuses_a_dimension_that_is_not_one():
    a = peng.Input(shape=(4,))
    m = peng.Model(a, a.squeeze(1), device="cpu")
    with pytest.raises(ValueError, match="cannot squeeze"):
        m.init_weights()        # the meta-device shape probe raises


def test_lambda_shapes_are_probed_on_the_meta_device():
    """A Lambda's shape comes from its function on meta tensors (no data
    is computed), and ``in_shape_probe()`` is true only meanwhile."""
    seen = []

    def f(x):
        seen.append((x.device.type, peng.in_shape_probe()))
        return torch.cat([x, x * 2], dim=-1)[:, :5]

    m = PSequential([pl.Dense(4, input_shape=(3,)), pl.Lambda(f),
                     pl.Dense(2)], device="cpu").init_weights()
    assert seen == [("meta", True)]
    assert m.compute_output_shape((None, 3)) == (None, 2)
    assert not peng.in_shape_probe()
    out = m(torch.ones(8, 3))
    assert out.shape == (8, 2) and seen[-1] == ("cpu", False)


def test_lambda_in_a_sequential_matches_jax():
    _both_contexts()
    jm = JSequential([jl.Dense(6, input_shape=(3,)),
                      jeng.Lambda(lambda x: jnp.tanh(x[:, :4]) * 2.0),
                      jl.Dense(2)])
    jm.init_weights(rng=jax.random.key(2))
    pm = PSequential([pl.Dense(6, input_shape=(3,)),
                      pl.Lambda(lambda x: torch.tanh(x[:, :4]) * 2.0),
                      pl.Dense(2)], device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
    x = _x((16, 3), 4)
    _assert_close(pm.predict(x, batch_size=8),
                  np.asarray(jm.predict(x, batch_size=8)))


# ---------------------------------------------------------------------------
# the autograd op library
# ---------------------------------------------------------------------------

_X = _x((8, 4), 0)
_POS = _x((8, 4), 1, lo=0.1, hi=2.0)
_Q = _x((8, 4, 5), 3)
_D = _x((8, 6, 5), 4)
_M1 = _x((8, 3, 4), 5)
_M2 = _x((8, 4, 5), 6)

UNARY_CASES = {
    "abs": (lambda A, v: A.abs(v), _X),
    "square": (lambda A, v: A.square(v), _X),
    "exp": (lambda A, v: A.exp(v), _X),
    "log": (lambda A, v: A.log(v), _POS),
    "sqrt": (lambda A, v: A.sqrt(v), _POS),
    "erf": (lambda A, v: A.erf(v), _X),
    "clip": (lambda A, v: A.clip(v, -0.5, 0.5), _X),
    "sum": (lambda A, v: A.sum(v, axis=1), _X),
    "sum_batch_axis": (lambda A, v: A.sum(v, axis=0, keep_dims=True), _X),
    "mean": (lambda A, v: A.mean(v, axis=1, keep_dims=True), _X),
    "softsign": (lambda A, v: A.softsign(v), _X),
    "softplus": (lambda A, v: A.softplus(v), _X),
    "pow": (lambda A, v: A.pow(v, 3.0), _X),
    "expand_dims": (lambda A, v: A.expand_dims(v, 1), _X),
    "contiguous": (lambda A, v: A.contiguous(v), _X),
    "maximum_const": (lambda A, v: A.maximum(v, 0.0), _X),
    "l2_normalize": (lambda A, v: A.l2_normalize(v, axis=2), _Q),
}

BINARY_OPS = {
    "maximum": (lambda A, a, b: A.maximum(a, b) + a * 2.0 - b / 2.0,
                _X, _POS),
    "mm": (lambda A, a, b: A.mm(a, b), _M1, _M2),
    "mm_axes": (lambda A, a, b: A.mm(a, b, axes=(2, 1)), _M1, _M2),
    "batch_dot": (lambda A, a, b: A.batch_dot(a, b, axes=(2, 2)), _Q, _D),
    "batch_dot_normalize": (lambda A, a, b: A.batch_dot(
        a, b, axes=(2, 2), normalize=True), _Q, _D),
    "batch_dot_axes_1": (lambda A, a, b: A.batch_dot(a, b, axes=(1, 1)),
                         _M2, _x((8, 4, 2), 7)),
    "stack": (lambda A, a, b: A.stack([a, b], axis=1), _X, _POS),
}


@pytest.mark.parametrize("case", sorted(UNARY_CASES))
def test_autograd_unary_ops_match_jax(case):
    fn, arr = UNARY_CASES[case]
    want, got, jg, pg = _run_both(fn, arr, grads=True)
    _assert_close(got, want)
    _assert_close(pg[0], jg[0], rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("case", sorted(BINARY_OPS))
def test_autograd_binary_ops_match_jax(case):
    fn, a, b = BINARY_OPS[case]
    want, got, jg, pg = _run_both(fn, a, b, grads=True)
    _assert_close(got, want)
    for g, w in zip(pg, jg):
        _assert_close(g, w, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_autograd_epsilon_and_names():
    assert PA.epsilon() == JA.epsilon() == 1e-7
    assert PA.__all__ == JA.__all__
    peng.reset_uids()
    v, w = peng.Input(shape=(4,)), peng.Input(shape=(4,))
    outs = [PA.abs(v), PA.expand_dims(v, 1), PA.l2_normalize(v, 1),
            PA.batch_dot(PA.expand_dims(v, 1), PA.expand_dims(w, 1)),
            PA.stack([v, w]), PA.mm(v, w, axes=(1, 1))]
    assert [o.name for o in outs] == ["abs_1", "expanddims_1",
                                      "l2normalize_1", "batchdot_1",
                                      "stack_1", "mm_1"]


# ---------------------------------------------------------------------------
# CustomLoss
# ---------------------------------------------------------------------------

def _rmse(A):
    return lambda yt, yp: A.sqrt(A.mean(A.square(yt - yp), axis=1))


def test_custom_loss_values_match_jax():
    yt = np.zeros((8, 3), np.float32)
    yp = _x((8, 3), 9)
    want = float(JA.CustomLoss(_rmse(JA), (3,))(jnp.asarray(yt),
                                                jnp.asarray(yp)))
    got = PA.CustomLoss(_rmse(PA), (3,))(torch.from_numpy(yt),
                                         torch.from_numpy(yp))
    assert got.dim() == 0
    assert float(got) == pytest.approx(want, rel=RTOL)
    with pytest.raises(TypeError):
        PA.CustomLoss(lambda yt, yp: 3.0, (1,))


@pytest.mark.parametrize("scan_steps", [1, 4])
def test_custom_loss_fit_matches_jax(scan_steps):
    """``compile(loss=CustomLoss(mae))`` trains a Dense(1) as the JAX
    package does, on the eager loop and on the multi-step program (the
    loss runs inside the step, reading nothing back); evaluate takes the
    whole-batch path of a loss without a per-example form."""
    _both_contexts({"zoo.train.scan_steps": scan_steps})
    r = np.random.default_rng(5)
    x = r.normal(size=(256, 6)).astype(np.float32)
    y = (x @ r.normal(size=(6, 1))).astype(np.float32)
    jm = JSequential([jl.Dense(1, input_shape=(6,))])
    jm.init_weights(rng=jax.random.key(3))
    pm = PSequential([pl.Dense(1, input_shape=(6,))], device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))

    def mae(A):
        return lambda yt, yp: A.mean(A.abs(yt - yp), axis=1)

    jm.compile(optimizer="adam", loss=JA.CustomLoss(mae(JA), (1,)), lr=0.05)
    pm.compile(optimizer="adam", loss=PA.CustomLoss(mae(PA), (1,)), lr=0.05)
    hj = jm.fit(x, y, batch_size=64, nb_epoch=4)["loss"]
    hp = pm.fit(x, y, batch_size=64, nb_epoch=4)["loss"]
    np.testing.assert_allclose(hp, hj, rtol=FIT_TOL)
    assert hp[-1] < hp[0]
    for key, a in peng.flatten_tree(jax.tree.map(np.asarray,
                                                 jm.params)).items():
        np.testing.assert_allclose(
            dict(pm.named_parameters())[key.replace("/", ".")]
            .detach().numpy(), a, rtol=FIT_TOL, atol=FIT_TOL, err_msg=key)
    assert pm.evaluate(x, y, batch_size=64)["loss"] == pytest.approx(
        jm.evaluate(x, y, batch_size=64)["loss"], rel=FIT_TOL)


# ---------------------------------------------------------------------------
# core layers
# ---------------------------------------------------------------------------

def _layer_pair(make, in_shape, seed=0):
    """A JAX layer built on ``in_shape`` and the port's built the same
    way with the JAX weights loaded."""
    peng.reset_uids()
    jeng.reset_uids()
    jlayer = make(jl)
    params = jlayer.build(jax.random.key(seed), in_shape)
    state = jlayer.initial_state(in_shape)
    player = make(pl)
    player.build(in_shape, generator=torch.Generator().manual_seed(0))
    peng.load_param_tree(player, jax.tree.map(np.asarray, params))
    return jlayer, params, state, player


def _multi_hot(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < 0.3).astype(np.float32) * rng.integers(
        1, 4, shape).astype(np.float32)


def _masked_steps(seed=0):
    x = _x((8, 5, 3), seed)
    x[:, 1] = 0.0
    x[3, 4] = 0.0
    return x


CORE_CASES = {
    "flatten": (lambda L: L.Flatten(), _x((8, 3, 4))),
    "reshape": (lambda L: L.Reshape((2, 6)), _x((8, 3, 4))),
    "reshape_infer": (lambda L: L.Reshape((-1, 3)), _x((8, 3, 4))),
    "permute": (lambda L: L.Permute((2, 1)), _x((8, 3, 4))),
    "permute_3d": (lambda L: L.Permute((3, 1, 2)), _x((8, 2, 3, 4))),
    "repeat_vector": (lambda L: L.RepeatVector(3), _x((8, 4))),
    "squeeze": (lambda L: L.Squeeze(1), _x((8, 1, 4))),
    "expand_dim": (lambda L: L.ExpandDim(1), _x((8, 4))),
    "expand_dim_last": (lambda L: L.ExpandDim(-1), _x((8, 4))),
    "narrow": (lambda L: L.Narrow(1, 1, 2), _x((8, 5, 3))),
    "narrow_last": (lambda L: L.Narrow(2, 0, 3), _x((8, 5, 3))),
    "masking": (lambda L: L.Masking(0.0), _masked_steps()),
    "gaussian_noise": (lambda L: L.GaussianNoise(0.3), _x((8, 4))),
    "gaussian_dropout": (lambda L: L.GaussianDropout(0.4), _x((8, 4))),
    "time_distributed": (lambda L: L.TimeDistributed(L.Dense(5)),
                         _x((8, 3, 4))),
    "highway": (lambda L: L.Highway(), _x((8, 6))),
    "highway_relu_no_bias": (lambda L: L.Highway(activation="relu",
                                                 bias=False), _x((8, 6))),
    "sparse_dense": (lambda L: L.SparseDense(5, activation="relu"),
                     _multi_hot((8, 10))),
    "l2_normalize": (lambda L: L.L2Normalize(), _x((8, 6))),
    "l2_normalize_axis1": (lambda L: L.L2Normalize(axis=1), _x((8, 3, 4))),
}


@pytest.mark.parametrize("case", sorted(CORE_CASES))
def test_core_layer_matches_jax(case):
    """Output (inference) and the shape rule against ``output_shape_for``;
    the weights' keys and shapes agree (``load_param_tree`` checks them)."""
    make, x = CORE_CASES[case]
    in_shape = (None,) + x.shape[1:]
    jlayer, params, state, player = _layer_pair(make, in_shape)
    want, _ = jlayer.apply(params, state, jnp.asarray(x), training=False)
    got = player(torch.from_numpy(x)).detach().numpy()
    _assert_close(got, np.asarray(want))
    assert player.compute_output_shape(in_shape) == \
        jlayer.output_shape_for(params, state, in_shape)


def test_time_distributed_nests_the_inner_layer_under_its_name():
    _, params, _, player = _layer_pair(
        lambda L: L.TimeDistributed(L.Dense(5)), (None, 3, 4))
    assert sorted(peng.flatten_tree(jax.tree.map(np.asarray, params))) == \
        sorted(n.replace(".", "/") for n, _ in player.named_parameters())
    assert [n for n, _ in player.named_parameters()] == ["dense_1.W",
                                                         "dense_1.b"]


@pytest.mark.parametrize("kind", ["noise", "dropout"])
def test_noise_layers_by_statistics_and_identity(kind):
    """In training the noise follows its law — GaussianNoise adds
    N(0, sigma^2), GaussianDropout multiplies by N(1, p / (1 - p)) —
    drawn from the step's generator (the same seed, the same draw); at
    inference both are the identity."""
    layer = pl.GaussianNoise(0.3) if kind == "noise" else \
        pl.GaussianDropout(0.4)
    base = np.zeros if kind == "noise" else np.ones
    x = torch.from_numpy(base((400, 500), np.float32))
    y = layer(x, training=True,
              generator=torch.Generator().manual_seed(1)).numpy()
    mean, std = (0.0, 0.3) if kind == "noise" else (1.0, (0.4 / 0.6) ** .5)
    assert abs(y.mean() - mean) < 0.01 and abs(y.std() - std) < 0.01
    again = layer(x, training=True,
                  generator=torch.Generator().manual_seed(1)).numpy()
    np.testing.assert_array_equal(again, y)
    assert layer(x, training=False) is x
    with pytest.raises(ValueError, match="generator"):
        layer(x, training=True)


# ---------------------------------------------------------------------------
# SparseEmbedding and WordEmbedding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_sparse_embedding_combiners_match_jax(combiner):
    """A weighted multi-hot row times the table; ``mean``/``sqrtn``
    divide by the row's sum / root sum of squares, at least 1 (an empty
    row stays zero)."""
    x = _multi_hot((8, 12), 3)
    x[2] = 0.0
    jlayer, params, state, player = _layer_pair(
        lambda L: L.SparseEmbedding(12, 5, combiner=combiner), (None, 12))
    want, _ = jlayer.apply(params, state, jnp.asarray(x))
    got = player(torch.from_numpy(x)).detach().numpy()
    _assert_close(got, np.asarray(want))
    assert player.compute_output_shape((None, 12)) == (None, 5)
    assert np.all(got[2] == 0)


def _glove(v=11, d=4, seed=8):
    return _x((v, d), seed)


def _word_models(trainable, table=None):
    table = _glove() if table is None else table
    jm = JSequential([jl.WordEmbedding(table, trainable=trainable,
                                       input_shape=(5,)),
                      jl.Flatten(), jl.Dense(3, activation="softmax")])
    jm.init_weights(rng=jax.random.key(4))
    pm = PSequential([pl.WordEmbedding(table, trainable=trainable,
                                       input_shape=(5,)),
                      pl.Flatten(), pl.Dense(3, activation="softmax")],
                     device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params),
                       jax.tree.map(np.asarray, jm.net_state))
    return jm, pm


def _ids(n=64, v=11, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, v, (n, 5)).astype(np.int32)
    return x, (x.sum(axis=1) % 3).astype(np.int32)


@pytest.mark.parametrize("trainable", [False, True])
def test_word_embedding_frozen_and_trainable_fit_as_jax(trainable):
    """Frozen, the table is constant state (a buffer under the JAX
    net-state key, never given to the optimizer, unchanged by a fit);
    trainable, it is a weight that trains as JAX's does. Ids out of range
    gather NaN rows, as ``jnp.take`` does."""
    _both_contexts()
    jm, pm = _word_models(trainable)
    layer = pm.layers[0]
    assert ("embeddings" in dict(layer.named_parameters())) == trainable
    assert sorted(peng.named_state(pm)) == (
        [] if trainable else ["wordembedding_0.embeddings"])
    x, y = _ids()
    for m in (jm, pm):
        m.compile(optimizer="adam", loss="scce", lr=0.05)
    hj = jm.fit(x, y, batch_size=16, nb_epoch=3)["loss"]
    hp = pm.fit(x, y, batch_size=16, nb_epoch=3)["loss"]
    np.testing.assert_allclose(hp, hj, rtol=FIT_TOL)
    jp = peng.flatten_tree(jax.tree.map(np.asarray, jm.params))
    for key, a in jp.items():
        np.testing.assert_allclose(
            dict(pm.named_parameters())[key.replace("/", ".")]
            .detach().numpy(), a, rtol=FIT_TOL, atol=FIT_TOL, err_msg=key)
    if not trainable:
        np.testing.assert_array_equal(layer.embeddings.numpy(), _glove())
    ids = torch.tensor([[-1, 10, 11, -12, 0]])
    table = layer.embeddings.detach().numpy()
    want = np.asarray(jl.WordEmbedding(table).apply(
        {}, {"embeddings": jnp.asarray(table)},
        jnp.asarray(ids.numpy()))[0])
    np.testing.assert_array_equal(layer(ids).detach().numpy(), want)


def test_word_embedding_state_through_checkpoints_both_ways(tmp_path):
    """A frozen table rides a snapshot's net_state in the JAX tree's
    order: the port's snapshot restores in the JAX manager against the
    JAX model's templates; a JAX snapshot restores the port's table."""
    _both_contexts()
    jm, pm = _word_models(False)
    x, y = _ids()
    for m in (jm, pm):
        m.compile(optimizer="adam", loss="scce", lr=0.05)
    pm.set_checkpoint(str(tmp_path / "p"))
    pm.fit(x, y, batch_size=16, nb_epoch=1)
    jm.fit(x, y, batch_size=16, nb_epoch=0)
    mgr = JCheckpointManager(str(tmp_path / "p"), registry=JRegistry())
    _, trees, _ = mgr.restore_latest(
        {"params": jm.params,
         "opt_state": jm._loop.optimizer.init(jm.params),
         "net_state": jm.net_state})
    np.testing.assert_array_equal(
        np.asarray(trees["net_state"]["wordembedding_0"]["embeddings"]),
        _glove())

    other = _glove(seed=9)
    jm2 = JSequential([jl.WordEmbedding(other, input_shape=(5,)),
                       jl.Flatten(), jl.Dense(3, activation="softmax")])
    jm2.init_weights(rng=jax.random.key(6))
    jm2.compile(optimizer="adam", loss="scce", lr=0.05)
    jm2.set_checkpoint(str(tmp_path / "j"))
    jm2.fit(x, y, batch_size=16, nb_epoch=1)
    pm.set_checkpoint(str(tmp_path / "j"))
    pm.fit(x, y, batch_size=16, nb_epoch=0)              # resume only
    np.testing.assert_array_equal(pm.layers[0].embeddings.numpy(), other)


def _tiny_word_classes():
    """One ZooModel holding a frozen WordEmbedding, registered under the
    same name in both packages (the ``.npz`` header names the class)."""

    class JTiny(jzoo.ZooModel):
        def __init__(self, weights, classes=3, name=None):
            self.weights, self.classes = np.asarray(weights), classes
            super().__init__(name=name)

        def build_model(self):
            return JSequential([jl.WordEmbedding(self.weights,
                                                 input_shape=(5,)),
                                jl.Flatten(),
                                jl.Dense(self.classes,
                                         activation="softmax")])

        def get_config(self):
            return {"classes": self.classes}

        def extra_arrays(self):
            return {"weights": self.weights}

    class PTiny(pzoo.ZooModel):
        def __init__(self, weights, classes=3, name=None, device=None):
            self.weights, self.classes = np.asarray(weights), classes
            super().__init__(name=name, device=device)

        def build_model(self):
            return PSequential([pl.WordEmbedding(self.weights,
                                                 input_shape=(5,)),
                                pl.Flatten(),
                                pl.Dense(self.classes,
                                         activation="softmax")],
                               device=self.device)

        def get_config(self):
            return {"classes": self.classes}

        def extra_arrays(self):
            return {"weights": self.weights}

    for cls, reg in ((JTiny, jzoo.register_model),
                     (PTiny, pzoo.register_model)):
        cls.__name__ = cls.__qualname__ = "TinyWordClassifier"
        reg(cls)
    return JTiny, PTiny


def test_word_embedding_state_through_the_npz_both_ways(tmp_path):
    """The ``.npz`` holds the table once, as ``s_0`` (the constructor's
    ``weights`` refer to it): a JAX file loads into the port with its
    state and predictions, and a port file into the JAX package."""
    _both_contexts()
    JTiny, PTiny = _tiny_word_classes()
    jm = JTiny(_glove())
    jm.init_weights(rng=jax.random.key(2))
    jpath = jm.save(str(tmp_path / "jax.npz"))
    with np.load(jpath) as data:
        header = bytes(data["__zoo_header__"]).decode()
        assert '"n_state": 1' in header and '"weights": "s_0"' in header
    pm = pzoo.load_model(jpath, device="cpu")
    assert type(pm).__name__ == "TinyWordClassifier"
    x, _ = _ids(16)
    np.testing.assert_allclose(pm.predict(x, batch_size=8),
                               np.asarray(jm.predict(x, batch_size=8)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        peng.named_state(pm.model)["wordembedding_0.embeddings"].numpy(),
        _glove())

    p2 = PTiny(_glove(seed=10), device="cpu").init_weights()
    ppath = p2.save(str(tmp_path / "port.npz"))
    with np.load(ppath) as data:
        header = bytes(data["__zoo_header__"]).decode()
        assert '"n_state": 1' in header and '"weights": "s_0"' in header
    j2 = jzoo.load_model(ppath)
    np.testing.assert_array_equal(
        np.asarray(j2.net_state["wordembedding_0"]["embeddings"]),
        _glove(seed=10))
    np.testing.assert_allclose(np.asarray(j2.predict(x, batch_size=8)),
                               p2.predict(x, batch_size=8),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# no jax in the port's new modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", [
    "analytics_zoo_tpu_torch.pipeline.api.autograd",
    "analytics_zoo_tpu_torch.pipeline.api.keras.engine",
    "analytics_zoo_tpu_torch.pipeline.api.keras.layers.core",
    "analytics_zoo_tpu_torch.pipeline.api.keras.layers.embeddings",
    "analytics_zoo_tpu_torch.pipeline.api.keras.layers.normalization",
    "analytics_zoo_tpu_torch.feature.common",
])
def test_graph_modules_import_no_jax(module):
    """Importing the module and building a small graph of Lambdas,
    autograd ops and the new layers leaves jax and the JAX package out of
    ``sys.modules``."""
    code = (
        "import sys, importlib, torch\n"
        f"importlib.import_module({module!r})\n"
        "import analytics_zoo_tpu_torch.pipeline.api.autograd as A\n"
        "from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L\n"
        "from analytics_zoo_tpu_torch.pipeline.api.keras.engine import "
        "Input, Model\n"
        "a = Input(shape=(3, 4))\n"
        "h = L.TimeDistributed(L.Dense(4))(a)\n"
        "o = A.sum(A.square(L.Flatten()(h) * 2.0 - 1.0), axis=1)\n"
        "m = Model(a, o, device='cpu').init_weights()\n"
        "assert m(torch.ones(2, 3, 4)).shape == (2,)\n"
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
