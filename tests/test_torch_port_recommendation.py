"""The port's recommender slice held to the JAX package on numpy-seeded
inputs and transferred weights: the dedup'd embedding engine (capacity,
fixed-size unique, the plain versions of K1 and SA, the lookup and its
gradients), ``Embedding``/``ShardedEmbedding``, the graph ``Model`` with
``Select``/``Merge``/``Dense``/``Activation``, the sharded-embedding
resolution, and ``NeuralCF`` (and the same graph on ``ShardedEmbedding``)
through ``compile``/``fit``/``predict``/``recommend_for_user``; also the
padding that lets the fused-CE kernels take any hidden width.

The JAX side runs its Pallas kernel as its own tests do on the CPU
(interpret mode, ``zoo.pallas.embed_gather: true``); the port's side runs
the kernels' plain versions (CPU tensors).

Tolerances, each with its reason:
* forward gathers, the fixed-size unique and K1's plain version: bit for
  bit (a gather moves bits; the JAX package's own tests claim it);
* lookup gradients: a row hit once is the cotangent itself, bit for bit;
  every row within 1e-6 of the largest entry (rows hit several times are
  sums taken in position order on both sides);
* ``Model`` forward: 1e-6 (the same f32 products in another order);
* fits: losses rtol 1e-5, parameters rtol 1e-4 / atol 1e-5 — the bounds of
  ``tests/test_sharded_embedding.py``'s NCF parity test (the JAX fit runs
  on conftest's 8-device CPU mesh, so its gradients are summed across
  devices in another order, then Adam).
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
from analytics_zoo_tpu.models.recommendation import NeuralCF as JaxNeuralCF
from analytics_zoo_tpu.ops import sharded_embedding as jse
from analytics_zoo_tpu.ops.pallas import embedding as jpe
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.models.common.ranker import (
    hit_rate, mean_average_precision, ndcg)
from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
from analytics_zoo_tpu_torch.ops import sharded_embedding as pse
from analytics_zoo_tpu_torch.ops.pallas.common import pad_to_multiple
from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import (
    fused_ce_backward_reference, fused_ce_forward_reference)
from analytics_zoo_tpu_torch.ops.pallas.embedding import (
    KERNEL_EMBED_EXPAND, KERNEL_SCATTER_ADD, dedup_scatter_add,
    dedup_scatter_add_reference, embed_expand, embed_expand_reference,
    pallas_embed_gather_enabled)
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as pl
from analytics_zoo_tpu_torch.pipeline.api.keras.fused_loss import find_head
from analytics_zoo_tpu_torch.pipeline.api.keras.sharded_embed import (
    find_embeddings, resolve_sharded_embeddings)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5
NCF_SMALL = dict(user_embed=8, item_embed=8, hidden_layers=(16,),
                 include_mf=True)


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


def _table_ids(v=96, d=16, n=(4, 7), seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(dtype)
    ids = rng.integers(0, v, size=n).astype(np.int32)
    ids[:, :3] = ids[0, 0]                  # repeated ids in every row
    return table, ids


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# the dedup'd engine
# ---------------------------------------------------------------------------

_CAPACITY_CASES = [(1, 10), (100, 50), (100, 1000), (1000, 1000), (520, 512),
                   (1000, 512)] + [(n, v) for n in (1, 7, 65, 513, 4097)
                                   for v in (8, 100, 8192)]


@pytest.mark.parametrize("n,v", _CAPACITY_CASES)
def test_dedup_capacity_matches_jax(n, v):
    got = pse.dedup_capacity(n, v)
    assert got == jse.dedup_capacity(n, v)
    assert got >= min(n, v)


@pytest.mark.parametrize("capacity", [16, 32, 4])
def test_fixed_size_unique_matches_jnp_unique(capacity):
    """uniq padded with the fill (or truncated) and inv, bit-equal."""
    ids = np.random.default_rng(capacity).integers(0, 12, 23).astype(
        np.int32)
    want_u, want_i = jnp.unique(jnp.asarray(ids), size=capacity,
                                fill_value=12, return_inverse=True)
    got_u, got_i = pse._unique_ids(torch.from_numpy(ids), capacity, fill=12)
    assert got_u.dtype == torch.int32 and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    np.testing.assert_array_equal(got_i.numpy(),
                                  np.asarray(want_i).reshape(-1))


@pytest.mark.parametrize("capacity", [16, 32, 4])
def test_dedup_sort_hands_over_the_stable_sort_of_inv(capacity):
    """``_dedup_sort`` gives ``_unique_ids``' uniq and inv bit for bit and
    beside them the arrays SA reads: ``order`` and ``slot`` equal
    ``torch.sort(inv, stable=True)``'s indices and values (int64)."""
    ids = np.random.default_rng(capacity + 1).integers(0, 12, 23).astype(
        np.int32)
    t = torch.from_numpy(ids)
    uniq, inv, order, slot = pse._dedup_sort(t, capacity, fill=12)
    want_u, want_i = pse._unique_ids(t, capacity, fill=12)
    assert torch.equal(uniq, want_u) and torch.equal(inv, want_i)
    key, idx = torch.sort(inv.long(), stable=True)
    assert order.dtype == torch.int64 and slot.dtype == torch.int64
    assert torch.equal(order, idx) and torch.equal(slot, key)


def test_dedup_lookup_backward_hands_sa_the_forward_sort(monkeypatch):
    """The lookup's backward calls SA with the forward's ``order`` and
    ``sorted_slot`` (the stable sort of inv by slot), and its gradient
    still matches ``jax.vjp`` as in the test above."""
    _both_contexts()
    table, ids = _table_ids()
    seen = []
    real = pse.dedup_scatter_add

    def record(g, inv, capacity, **kw):
        seen.append((inv, kw))
        return real(g, inv, capacity, **kw)
    monkeypatch.setattr(pse, "dedup_scatter_add", record)
    g = np.random.default_rng(2).normal(size=ids.shape + (16,)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda t: jse.dedup_embedding_lookup(
        t, jnp.asarray(ids), use_pallas=True, interpret=True),
        jnp.asarray(table))
    (want_dw,) = vjp(jnp.asarray(g))
    tt = torch.from_numpy(table).requires_grad_()
    pse.dedup_embedding_lookup(tt, torch.from_numpy(ids)).backward(
        torch.from_numpy(g))
    (inv, kw), = seen
    key, idx = torch.sort(inv.long(), stable=True)
    assert torch.equal(kw["order"], idx) and torch.equal(kw["sorted_slot"],
                                                         key)
    want_dw = np.asarray(want_dw)
    np.testing.assert_allclose(tt.grad.numpy(), want_dw, rtol=0,
                               atol=1e-6 * np.abs(want_dw).max())


def test_dedup_scatter_add_checks_the_sort_it_is_handed():
    """On the CPU the handed sort leaves the plain version's result as it
    is; ``order`` without ``sorted_slot``, or either of another shape or
    dtype, is refused."""
    g = torch.randn(5, 3)
    inv = torch.tensor([2, 0, 2, 1, 0], dtype=torch.int32)
    key, idx = torch.sort(inv.long(), stable=True)
    want = dedup_scatter_add_reference(g, inv, 4)
    assert torch.equal(dedup_scatter_add(g, inv, 4, order=idx,
                                         sorted_slot=key), want)
    with pytest.raises(ValueError, match="together"):
        dedup_scatter_add(g, inv, 4, order=idx)
    with pytest.raises(ValueError, match="int64"):
        dedup_scatter_add(g, inv, 4, order=idx.int(), sorted_slot=key)
    with pytest.raises(ValueError, match="int64"):
        dedup_scatter_add(g, inv, 4, order=idx[:4], sorted_slot=key[:4])


@pytest.mark.parametrize("wrong", ["unstable", "other_slots", "reversed"])
def test_dedup_scatter_add_refuses_a_sort_that_is_not_invs(wrong):
    """The kernel trusts the sort it is handed; on the CPU the op checks
    that it is ``inv``'s stable sort, so a caller handing another one
    fails here instead of summing other rows on the card."""
    g = torch.randn(5, 3)
    inv = torch.tensor([2, 0, 2, 1, 0], dtype=torch.int32)
    key, idx = torch.sort(inv.long(), stable=True)   # idx 1 4 3 0 2
    if wrong == "unstable":        # slot 0's positions out of order
        idx = idx[[1, 0, 2, 3, 4]]
    elif wrong == "other_slots":
        key = key.clamp(max=1)
    else:
        key, idx = key.flip(0), idx.flip(0)
    with pytest.raises(ValueError, match="stable sort of inv"):
        dedup_scatter_add(g, inv, 4, order=idx, sorted_slot=key)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_embed_expand_plain_version_matches_jax_kernel(dtype):
    """K1's plain version against the interpret-mode Pallas kernel, D=24."""
    rng = np.random.default_rng(17)
    rows32 = rng.normal(size=(64, 24)).astype(np.float32)
    inv = rng.integers(0, 64, size=(50,)).astype(np.int32)
    want = jpe.embed_expand(jnp.asarray(rows32).astype(dtype),
                            jnp.asarray(inv), interpret=True)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = embed_expand(torch.from_numpy(rows32).to(tdt),
                       torch.from_numpy(inv))
    assert got.dtype == tdt
    np.testing.assert_array_equal(_bits(got.float().numpy()),
                                  _bits(np.asarray(want, np.float32)))


def test_dedup_scatter_add_plain_version_adds_in_position_order():
    """SA's plain version: each slot's rows summed one after the other in
    position order from 0 (written out here as a loop)."""
    rng = np.random.default_rng(5)
    g = (rng.normal(size=(40, 6)) * 10.0 ** rng.integers(-4, 4, (40, 1))
         ).astype(np.float32)
    inv = rng.integers(0, 9, 40).astype(np.int32)
    want = np.zeros((12, 6), np.float32)
    for i in range(40):
        want[inv[i]] = want[inv[i]] + g[i]
    got = dedup_scatter_add(torch.from_numpy(g), torch.from_numpy(inv), 12)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    bf = dedup_scatter_add(torch.from_numpy(g).bfloat16(),
                           torch.from_numpy(inv), 12)
    assert torch.equal(bf, dedup_scatter_add_reference(
        torch.from_numpy(g).bfloat16(), torch.from_numpy(inv), 12))


def test_kernel_wrappers_take_the_plain_version_on_cpu_only():
    """CPU tensors run the plain versions and count no launch; the checks
    hold; auto engages the expand kernel only for a CUDA device."""
    rows = torch.randn(8, 4)
    inv = torch.tensor([3, 1, 3], dtype=torch.int32)
    before = (KERNEL_EMBED_EXPAND.launches, KERNEL_SCATTER_ADD.launches)
    assert torch.equal(embed_expand(rows, inv),
                       embed_expand_reference(rows, inv))
    dedup_scatter_add(torch.randn(3, 4), inv, 8)
    assert (KERNEL_EMBED_EXPAND.launches,
            KERNEL_SCATTER_ADD.launches) == before
    with pytest.raises(TypeError):
        embed_expand(rows.double(), inv)
    with pytest.raises(ValueError):
        dedup_scatter_add(torch.randn(2, 4), inv, 8)
    pctx.init_zoo_context()
    assert pallas_embed_gather_enabled("cuda")
    assert not pallas_embed_gather_enabled("cpu")
    pctx.init_zoo_context(conf={"zoo.pallas.embed_gather": True})
    assert pallas_embed_gather_enabled("cpu")


@pytest.mark.parametrize("use_kernel", [True, False])
def test_dedup_lookup_forward_and_grads_match_jax(use_kernel):
    """Forward bit-equal; gradients against jax.grad through the
    interpret-mode K1 path, for one seeded cotangent: rows hit once
    bit-equal, every row within 1e-6 of the largest entry, untouched rows
    exactly 0."""
    _both_contexts()
    table, ids = _table_ids()
    g = np.random.default_rng(1).normal(size=ids.shape + (16,)).astype(
        np.float32)
    jt = jnp.asarray(table)
    want, vjp = jax.vjp(lambda t: jse.dedup_embedding_lookup(
        t, jnp.asarray(ids), use_pallas=True, interpret=True), jt)
    (want_dw,) = vjp(jnp.asarray(g))
    tt = torch.from_numpy(table).requires_grad_()
    got = pse.dedup_embedding_lookup(tt, torch.from_numpy(ids),
                                     use_kernel=use_kernel)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(_bits(got.detach().numpy()), _bits(want))
    dw, want_dw = tt.grad.numpy(), np.asarray(want_dw)
    hits = np.bincount(ids.reshape(-1), minlength=table.shape[0])
    np.testing.assert_array_equal(_bits(dw[hits == 1]),
                                  _bits(want_dw[hits == 1]))
    np.testing.assert_allclose(dw, want_dw, rtol=0,
                               atol=1e-6 * np.abs(want_dw).max())
    assert np.all(dw[hits == 0] == 0.0) and (hits == 0).any()


def test_dedup_lookup_clamps_out_of_range_ids_as_jax():
    _both_contexts()
    table, _ = _table_ids(v=31)
    ids = np.asarray([-5, 0, 30, 31, 1000], np.int32)
    want = jse.dedup_embedding_lookup(jnp.asarray(table), jnp.asarray(ids))
    got = pse.sharded_embedding_lookup(torch.from_numpy(table),
                                       torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), table[np.clip(ids, 0, 30)])


def test_sharded_lookup_dedup_off_and_a_model_axis():
    """zoo.embed.dedup=false keeps the result; a model axis above 1 (the
    row-sharded form) is refused."""
    table, ids = _table_ids()
    pctx.init_zoo_context(conf={"zoo.embed.dedup": False})
    got = pse.sharded_embedding_lookup(torch.from_numpy(table),
                                       torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), table[ids])
    assert pse.model_row_shard_count() == 1
    with pytest.raises(NotImplementedError, match="row-sharded"):
        pse.sharded_embedding_lookup(torch.from_numpy(table),
                                     torch.from_numpy(ids),
                                     mesh={"data": 1, "model": 2})


def test_embedding_fills_nan_where_sharded_embedding_clamps():
    """Each layer keeps its JAX counterpart's rule for ids outside [0, V):
    Embedding reads NaN rows (jnp.take's fill; [-V, 0) wraps), and
    ShardedEmbedding clamps."""
    _both_contexts()
    ids = np.asarray([[-3, 0, 9], [10, 12, -20]], np.int32)
    table = np.random.default_rng(2).normal(size=(10, 4)).astype(np.float32)
    for jcls, pcls in ((jl.Embedding, pl.Embedding),
                       (jl.ShardedEmbedding, pl.ShardedEmbedding)):
        want = jcls(10, 4).call({"embeddings": jnp.asarray(table)},
                                jnp.asarray(ids))
        layer = pcls(10, 4)
        layer.build((None, 3), generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            layer.embeddings.copy_(torch.from_numpy(table))
        got = layer(torch.from_numpy(ids)).detach().numpy()
        np.testing.assert_array_equal(got, np.asarray(want))
    assert np.isnan(got).sum() == 0
    assert np.isnan(pl.take_rows(torch.from_numpy(table),
                                 torch.from_numpy(ids)).numpy()).any()


# ---------------------------------------------------------------------------
# the graph Model and its layers
# ---------------------------------------------------------------------------

def _graph(engine, layers, sharded=False, users=63, items=127, embed=8,
           hidden=(16,), classes=5, **model_kw):
    """NeuralCF's graph, built with either package's functional API;
    ``sharded`` puts every table on ``ShardedEmbedding``."""
    emb = layers.ShardedEmbedding if sharded else layers.Embedding
    inp = engine.Input(shape=(2,))
    user = layers.Select(1, 0)(inp)
    item = layers.Select(1, 1)(inp)
    h = layers.Merge(mode="concat")([emb(users + 1, embed, init="normal")(user),
                                     emb(items + 1, embed, init="normal")(item)])
    for units in hidden:
        h = layers.Dense(units, activation="relu")(h)
    mf = layers.Merge(mode="mul")([emb(users + 1, embed, init="normal")(user),
                                   emb(items + 1, embed, init="normal")(item)])
    h = layers.Merge(mode="concat", concat_axis=-1)([h, mf])
    out = layers.Dense(classes, activation="softmax")(h)
    return engine.Model(inp, out, **model_kw)


def _ncf_data(n=96, users=63, items=127, seed=3):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(1, users + 1, n),
                  rng.integers(1, items + 1, n)], axis=1).astype(np.int32)
    return x, ((x[:, 0] + x[:, 1]) % 5).astype(np.int32)


def _jax_tree(model):
    return jax.tree.map(np.asarray, model.params)


def _port_params(net):
    return {n.replace(".", "/"): p.detach().float().numpy()
            for n, p in net.named_parameters()}


def test_model_graph_forward_names_and_shapes_match_jax():
    """Select / Merge(concat, mul) / Dense(relu, softmax): the same
    positional names (the param tree moves across), output shape and
    forward."""
    _both_contexts()
    jm = _graph(jeng, jl)
    jm.init_weights(rng=jax.random.key(1))
    pm = _graph(peng, pl, device="cpu").load_jax_params(_jax_tree(jm))
    assert [n.name for n in pm._topo] == [n.name for n in jm._topo]
    assert pm.compute_output_shape((None, 2)) == (None, 5)
    x, _ = _ncf_data(20)
    want = np.asarray(jm.predict(x, batch_size=8))
    got = pm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert find_head(pm)[0] is pm._topo[-1].layer
    assert [l.name for l in find_embeddings(pm)] == [
        n.name for n in pm._topo if isinstance(n.layer, pl.Embedding)]


@pytest.mark.parametrize("mode", ["sum", "mul", "ave", "max", "min",
                                  "concat", "dot", "cos"])
def test_merge_modes_match_jax(mode):
    rng = np.random.default_rng(4)
    xs = [rng.normal(size=(3, 5)).astype(np.float32) for _ in range(2)]
    want = jl.Merge(mode=mode).call({}, [jnp.asarray(a) for a in xs])
    layer = pl.Merge(mode=mode)
    got = layer([torch.from_numpy(a) for a in xs]).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)
    assert layer.compute_output_shape([(None, 5), (None, 5)]) == \
        (None,) + tuple(got.shape[1:])


@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid", "softmax"])
def test_activation_and_select_match_jax(act):
    x = np.random.default_rng(6).normal(size=(4, 3, 5)).astype(np.float32)
    want = jl.Activation(act).call({}, jnp.asarray(x))
    got = pl.Activation(act)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)
    ids = np.arange(12, dtype=np.int32).reshape(4, 3)
    sel = pl.Select(1, -1)(torch.from_numpy(ids))
    assert sel.dtype == torch.int32
    np.testing.assert_array_equal(
        sel.numpy(), np.asarray(jl.Select(1, -1).call({}, jnp.asarray(ids))))


def test_model_refuses_colliding_names_and_wrong_input_count():
    inp = peng.Input(shape=(2,))
    a = pl.Dense(3, name="same")(inp)
    b = pl.Dense(3, name="same")(inp)
    with pytest.raises(ValueError, match="two different layers"):
        peng.Model(inp, pl.Merge()([a, b]), device="cpu")
    m = peng.Model(inp, a, device="cpu").init_weights()
    with pytest.raises(ValueError, match="expects 1 inputs"):
        m([torch.zeros(1, 2), torch.zeros(1, 2)])


def test_resolve_sharded_embeddings_declines_on_one_device():
    """None on one device, as in the JAX package (where the model axis is
    1), for the stock NeuralCF's plain tables and for a ShardedEmbedding
    graph (no plain tables), whatever zoo.embed.sharded says."""
    for flag in ("auto", True, False):
        _both_contexts({"zoo.embed.sharded": flag})
        jm = JaxNeuralCF(63, 127, 5, **NCF_SMALL)
        pm = NeuralCF(63, 127, 5, **NCF_SMALL, device="cpu")
        assert len(find_embeddings(pm)) == 4
        assert resolve_sharded_embeddings(pm) is None
        from analytics_zoo_tpu.pipeline.api.keras.sharded_embed import \
            resolve_sharded_embeddings as jax_resolve
        assert jax_resolve(jm) is None
        assert find_embeddings(_graph(peng, pl, sharded=True,
                                      device="cpu")) == []


# ---------------------------------------------------------------------------
# NeuralCF and its ShardedEmbedding graph, fitted against the JAX fit
# ---------------------------------------------------------------------------

def _assert_fit_close(jm, pnet, want, got):
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jp = peng.flatten_tree(_jax_tree(jm))
    pp = _port_params(pnet)
    assert sorted(jp) == sorted(pp)
    for key in jp:
        np.testing.assert_allclose(pp[key], jp[key], rtol=FIT_RTOL,
                                   atol=FIT_ATOL, err_msg=key)


def test_neural_cf_fit_matches_jax():
    """NeuralCF(63, 127, 5) with the MF tower, Adam, 2 epochs of 3 steps
    of 32, then predict, evaluate and recommend_for_user."""
    _both_contexts()
    jm = JaxNeuralCF(63, 127, 5, **NCF_SMALL)
    jm.init_weights(rng=jax.random.key(3))
    pm = NeuralCF(63, 127, 5, **NCF_SMALL, device="cpu")
    pm.load_jax_params(_jax_tree(jm))
    x, y = _ncf_data()
    for m in (jm, pm):
        m.compile(optimizer="adam", loss="scce", metrics=["accuracy"],
                  lr=0.01)
    want = jm.fit(x, y, batch_size=32, nb_epoch=2)["loss"]
    got = pm.fit(x, y, batch_size=32, nb_epoch=2)["loss"]
    _assert_fit_close(jm, pm.model, want, got)
    np.testing.assert_allclose(pm.predict(x[:10]),
                               np.asarray(jm.predict(x[:10])), atol=1e-5)
    jev, pev = jm.evaluate(x, y, batch_size=32), pm.evaluate(x, y,
                                                            batch_size=32)
    assert pev["loss"] == pytest.approx(jev["loss"], rel=1e-5)
    assert pev["accuracy"] == pytest.approx(jev["accuracy"])
    items = np.arange(1, 128)
    for user in (1, 17, 63):
        np.testing.assert_array_equal(pm.recommend_for_user(user, items, 10),
                                      jm.recommend_for_user(user, items, 10))
    np.testing.assert_array_equal(pm.recommend_for_item(5, np.arange(1, 64)),
                                  jm.recommend_for_item(5, np.arange(1, 64)))


def test_sharded_embedding_graph_fit_matches_jax():
    """The same graph on ShardedEmbedding tables: the port's dedup'd
    engine (plain K1 and SA) against the JAX engine with its Pallas
    expand kernel in interpret mode."""
    _both_contexts({"zoo.pallas.embed_gather": True})
    jm = _graph(jeng, jl, sharded=True)
    jm.init_weights(rng=jax.random.key(5))
    pm = _graph(peng, pl, sharded=True,
                device="cpu").load_jax_params(_jax_tree(jm))
    x, y = _ncf_data()
    for m in (jm, pm):
        m.compile(optimizer="adam", loss="scce", lr=0.01)
    want = jm.fit(x, y, batch_size=32, nb_epoch=2)["loss"]
    got = pm.fit(x, y, batch_size=32, nb_epoch=2)["loss"]
    _assert_fit_close(jm, pm, want, got)


def test_plain_and_sharded_graphs_take_the_same_step():
    """One step of the stock NeuralCF and of its ShardedEmbedding graph
    from the same weights: same loss, and gradients within 1e-6 (the two
    backward routes sum repeated ids in the same position order)."""
    pctx.init_zoo_context()
    x, y = _ncf_data(32)
    grads = []
    for sharded in (False, True):
        net = _graph(peng, pl, sharded=sharded, device="cpu").init_weights(
            torch.Generator().manual_seed(0))
        out = net(torch.from_numpy(x), training=True)
        loss = torch.nn.functional.nll_loss(torch.log(out),
                                            torch.from_numpy(y).long())
        loss.backward()
        grads.append([p.grad for p in net.parameters()])
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=1e-6 * a.abs().max().item())


def test_ranker_metrics_are_the_jax_package_s():
    from analytics_zoo_tpu.models.common import ranker as jr
    rng = np.random.default_rng(9)
    p, y = rng.random(20), rng.integers(0, 3, 20)
    assert ndcg(p, y, 5) == jr.ndcg(p, y, 5)
    assert mean_average_precision(p, y) == jr.mean_average_precision(p, y)
    assert hit_rate(p, y, 3) == jr.hit_rate(p, y, 3)


# ---------------------------------------------------------------------------
# fused CE at any hidden width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_plain_versions_are_unchanged_by_hidden_padding(dtype):
    """The CUDA wrappers pad H with zero columns of h and zero rows of w to
    a multiple of 64; on padded operands the plain versions give the
    unpadded results bit for bit (H = 100), and the pad's dh/dW are 0."""
    g = torch.Generator().manual_seed(0)
    n, hidden, v = 70, 100, 300
    h = torch.randn(n, hidden, generator=g).to(dtype)
    w = (torch.randn(hidden, v, generator=g) * 0.1).to(dtype)
    b = torch.randn(v, generator=g)
    labels = torch.randint(0, v, (n,), generator=g, dtype=torch.int32)
    labels[::3] = -1
    hp, wp = pad_to_multiple(h, 1, 64), pad_to_multiple(w, 0, 64)
    assert hp.shape[1] == 128
    fwd, fwd_p = (fused_ce_forward_reference(hh, ww, b, labels)
                  for hh, ww in ((h, w), (hp, wp)))
    for a, c in zip(fwd, fwd_p):
        assert torch.equal(a, c)
    scale = torch.full((n,), 1.0 / n)
    dh, dw, db = fused_ce_backward_reference(h, w, b, labels, fwd[0], scale)
    dhp, dwp, dbp = fused_ce_backward_reference(hp, wp, b, labels, fwd[0],
                                                scale)
    assert torch.equal(dh, dhp[:, :hidden]) and torch.equal(dw, dwp[:hidden])
    assert torch.equal(db, dbp)
    assert bool((dhp[:, hidden:] == 0).all() and (dwp[hidden:] == 0).all())


def test_recommendation_path_imports_no_jax():
    """A CPU NeuralCF fit and a ShardedEmbedding lookup through the new
    modules leave jax and the JAX package out of sys.modules."""
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "from analytics_zoo_tpu_torch.models.recommendation import "
        "NeuralCF\n"
        "from analytics_zoo_tpu_torch.pipeline.api.keras.layers import "
        "ShardedEmbedding\n"
        "m = NeuralCF(20, 30, 5, hidden_layers=(8,), device='cpu')\n"
        "m.compile(optimizer='adam', loss='scce', lr=1e-3)\n"
        "x = np.random.default_rng(0).integers(1, 20, (16, 2))"
        ".astype(np.int32)\n"
        "m.fit(x, x[:, 0] % 5, batch_size=8, nb_epoch=1)\n"
        "m.recommend_for_user(3, np.arange(1, 30))\n"
        "e = ShardedEmbedding(10, 4)\n"
        "e.build((None,), generator=torch.Generator().manual_seed(0))\n"
        "e(torch.tensor([1, 1, 3])).sum().backward()\n"
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
