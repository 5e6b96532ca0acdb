"""The row-sharded embedding lookup (``ops/sharded_embedding.py``
``sharded_embedding_lookup`` on a ``model`` axis above 1), the
``ShardedEmbedding`` layer's row placement and the ``zoo.embed.sharded``
resolution (``keras/sharded_embed.py``), held to the JAX package's
row-sharded cases (``tests/test_sharded_embedding.py``).

The torch side runs as 4 gloo ranks on the CPU (one process group for the
file; ``file://`` store under ``tmp_path``); the workers import this
module, which imports no ``jax`` at the top. On the CPU K1 and SA run
their plain versions (on each rank's row block on the card:
``chip_smoke.py``'s mesh phase).

Tolerances: the forward is a select — bit for bit (non-owners add exact
zeros); gradients 1e-6 relative, 1e-5 absolute (the JAX test's GTOL: the
same scatter-adds in another order); bf16 gradients 5e-2 (f32
accumulation against the oracle's bf16 scatter); fits 1e-5 on losses and
1e-4 on parameters after Adam, as the JAX test.
"""

import logging

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.ops import sharded_embedding as pse
from analytics_zoo_tpu_torch.parallel import mesh as pmesh
from analytics_zoo_tpu_torch.parallel.launch import run_ranks

WORLD = 4
GTOL = dict(rtol=1e-6, atol=1e-5)
MESHES = {"model2": {"data": 2, "model": 2}, "model4": {"model": 4}}


def _table_ids(v=96, d=16, n=(4, 7), seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(dtype)
    ids = rng.integers(0, v, size=n).astype(np.int32)
    ids[:, :3] = ids[0, 0]
    return table, ids


def _context(axes, **conf):
    pctx.reset_zoo_context()
    pctx.init_zoo_context(conf={**conf, **{f"zoo.mesh.{k}": v
                                           for k, v in axes.items()}})


def _lookup_and_grad(table, ids, fn, dtype=torch.float32):
    t = torch.tensor(table, dtype=dtype, requires_grad=True)
    out = fn(t, torch.from_numpy(ids))
    torch.sin(out.float()).sum().backward()
    return out.float().detach().numpy(), t.grad.float().numpy()


def _take(t, i):
    return t[i.long()]


def _lookup_case(axes, table, ids, dtype=torch.float32):
    _context(axes)
    got = _lookup_and_grad(table, ids, pse.sharded_embedding_lookup, dtype)
    return got, _lookup_and_grad(table, ids, _take, dtype)


def _layer_case():
    """A ShardedEmbedding placed on {data:2, model:2}: half of the rows a
    rank, the lookup the whole table's."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
        Sequential, reset_uids)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
        ShardedEmbedding
    _context({"data": 2, "model": 2})
    reset_uids()
    layer = ShardedEmbedding(64, 8, input_shape=(5,))
    m = Sequential([layer], device="cpu").init_weights()
    whole = layer.embeddings.detach().clone()
    spec = layer.param_sharding(pmesh.global_mesh())
    pmesh.place_params(m, pmesh.global_mesh())
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, size=(4, 5)).astype(np.int32))
    return {"spec": spec, "local": tuple(layer.embeddings.shape),
            "same": bool(torch.equal(m(ids), whole[ids.long()]))}


def _fallback_case():
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
        Sequential, reset_uids)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Embedding
    _context({"data": 2, "model": 2})
    records = []

    class Catch(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    log = logging.getLogger("analytics_zoo_tpu_torch.mesh")
    handler = Catch(logging.WARNING)
    log.addHandler(handler)
    try:
        out = []
        for d in (7, 8):
            reset_uids()
            m = Sequential([Embedding(50, d, input_shape=(4,))],
                           device="cpu").init_weights()
            records.clear()
            pmesh.param_shardings(m, dict(m.named_parameters()),
                                  pmesh.global_mesh())
            out.append(list(records))
    finally:
        log.removeHandler(handler)
    return out


def _resolve_case():
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Embedding
    from analytics_zoo_tpu_torch.pipeline.api.keras.sharded_embed import \
        resolve_sharded_embeddings

    def models():
        even = Embedding(64, 8, input_shape=(4,))
        odd = Embedding(97, 8, input_shape=(4,))
        return (even, odd, Sequential([even], device="cpu"),
                Sequential([odd], device="cpu"))
    out = {}
    _context({"data": 2, "model": 2}, **{"zoo.embed.sharded": "auto"})
    even, odd, m_even, m_odd = models()
    out["auto"] = (resolve_sharded_embeddings(m_even) is not None,
                   even._row_shard, resolve_sharded_embeddings(m_odd),
                   odd._lookup_sharded)
    _context({"data": 2, "model": 2}, **{"zoo.embed.sharded": True})
    even, odd, m_even, m_odd = models()
    out["on"] = (resolve_sharded_embeddings(m_odd) is not None,
                 odd._row_shard, odd._lookup_sharded)
    _context({"data": 2, "model": 2}, **{"zoo.embed.sharded": False})
    out["off"] = resolve_sharded_embeddings(models()[2])
    _context({"data": 4}, **{"zoo.embed.sharded": True})
    out["model1"] = resolve_sharded_embeddings(models()[2])
    return out


def _ncf_fit(sharded, tree):
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import reset_uids
    from analytics_zoo_tpu_torch.pipeline.api.keras.training import \
        tree_module
    _context({"data": 2, "model": 2}, **{"zoo.embed.sharded": sharded})
    reset_uids()
    rng = np.random.default_rng(3)
    x = np.stack([rng.integers(1, 63, 96),
                  rng.integers(1, 127, 96)], axis=1).astype(np.int32)
    y = ((x[:, 0] + x[:, 1]) % 5).astype(np.int32)
    m = NeuralCF(user_count=63, item_count=127, class_num=5, user_embed=8,
                 item_embed=8, hidden_layers=(16,), include_mf=False,
                 device="cpu")
    m.init_weights().load_jax_params(tree)
    m.compile(optimizer="adam", loss="scce", lr=0.01)
    records = []

    class Catch(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    log = logging.getLogger("analytics_zoo_tpu_torch.training")
    handler = Catch(logging.INFO)
    log.addHandler(handler)
    try:
        hist = m.fit(x, y, batch_size=32, nb_epoch=2, shuffle=False)
    finally:
        log.removeHandler(handler)
    named = dict(tree_module(m).named_parameters())
    return {"loss": hist["loss"], "log": records,
            "local": {n: tuple(p.shape) for n, p in named.items()},
            "params": {n: pmesh.full_tensor(p).detach().numpy()
                       for n, p in named.items()}}


def _torch_side(rank, world, tree):
    table, ids = _table_ids()
    out = {f"lookup_{k}": _lookup_case(axes, table, ids)
           for k, axes in MESHES.items()}
    t97, _ = _table_ids(v=97, seed=3)
    ids97 = np.random.default_rng(3).integers(0, 97, size=(30,)).astype(
        np.int32)
    out["v97"] = _lookup_case({"data": 2, "model": 2}, t97, ids97)
    out["bf16"] = _lookup_case({"data": 2, "model": 2}, table, ids,
                               torch.bfloat16)
    _context({"data": 2, "model": 2}, **{"zoo.embed.dedup": False})
    out["dedup_off"] = pse.sharded_embedding_lookup(
        torch.from_numpy(table), torch.from_numpy(ids)).numpy()
    try:
        pse.sharded_embedding_lookup(torch.from_numpy(table),
                                     torch.from_numpy(ids), capacity=4)
        out["guard"] = None
    except ValueError as e:
        out["guard"] = str(e)
    out["layer"] = _layer_case()
    out["fallback"] = _fallback_case()
    out["resolve"] = _resolve_case()
    out["ncf_off"] = _ncf_fit(False, tree)
    out["ncf_on"] = _ncf_fit(True, tree)
    return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_side():
    import jax
    import jax.numpy as jnp

    from analytics_zoo_tpu.common.context import (init_zoo_context,
                                                  reset_zoo_context)
    from analytics_zoo_tpu.models.recommendation import NeuralCF
    from analytics_zoo_tpu.ops.sharded_embedding import \
        sharded_embedding_lookup
    from analytics_zoo_tpu.parallel import mesh as jmesh
    from analytics_zoo_tpu.pipeline.api.keras.engine import reset_uids
    out = {}
    table, ids = (jnp.asarray(a) for a in _table_ids())
    for name, axes in MESHES.items():
        reset_zoo_context()
        init_zoo_context()
        jmesh.set_global_mesh(jmesh.create_mesh(devices=jax.devices()[:4],
                                                **axes))
        fwd = np.asarray(sharded_embedding_lookup(table, ids))
        grad = np.asarray(jax.grad(lambda t: jnp.sum(jnp.sin(
            sharded_embedding_lookup(t, ids))))(table))
        out[name] = (fwd, grad)
    reset_zoo_context()
    init_zoo_context(conf={"zoo.embed.sharded": True})
    jmesh.set_global_mesh(jmesh.create_mesh(data=2, model=2,
                                            devices=jax.devices()[:4]))
    reset_uids()
    rng = np.random.default_rng(3)
    x = np.stack([rng.integers(1, 63, 96),
                  rng.integers(1, 127, 96)], axis=1).astype(np.int32)
    y = ((x[:, 0] + x[:, 1]) % 5).astype(np.int32)
    m = NeuralCF(user_count=63, item_count=127, class_num=5, user_embed=8,
                 item_embed=8, hidden_layers=(16,), include_mf=False)
    m.compile(optimizer="adam", loss="scce", lr=0.01)
    m.init_weights(sample_input=x[:8])
    tree = jax.tree.map(np.asarray, m.params)
    out["fit"] = m.fit(x, y, batch_size=32, nb_epoch=2, shuffle=False)["loss"]
    reset_zoo_context()
    return tree, out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tree, want = _jax_side()
    store = tmp_path_factory.mktemp("gloo") / "store"
    return want, run_ranks(_torch_side, WORLD, str(store), args=(tree,))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_lookup_matches_take_and_jax(results, mesh):
    """The forward a select, bit for bit the whole table's rows and the
    JAX row-sharded lookup's; the gradient the dense transpose's and
    JAX's (repeated ids in every row)."""
    fwd_j, grad_j = results[0][mesh]
    for r in results[1]:
        (fwd, grad), (fwd_t, grad_t) = r[f"lookup_{mesh}"]
        np.testing.assert_array_equal(fwd, fwd_t)
        np.testing.assert_array_equal(fwd, fwd_j)
        np.testing.assert_allclose(grad, grad_t, **GTOL)
        np.testing.assert_allclose(grad, grad_j, **GTOL)


def test_sharded_lookup_indivisible_vocab_pads(results):
    """V=97 under model 2: the table pads internally; pad rows are never
    gathered, their gradient slots sliced off."""
    for r in results[1]:
        (fwd, grad), (fwd_t, grad_t) = r["v97"]
        np.testing.assert_array_equal(fwd, fwd_t)
        np.testing.assert_allclose(grad, grad_t, **GTOL)
        assert grad.shape == (97, 16)


def test_sharded_lookup_bf16(results):
    for r in results[1]:
        (fwd, grad), (fwd_t, grad_t) = r["bf16"]
        np.testing.assert_array_equal(fwd, fwd_t)
        np.testing.assert_allclose(grad, grad_t, rtol=5e-2, atol=5e-2)


def test_sharded_lookup_dedup_off_and_capacity_guard(results):
    table, ids = _table_ids()
    for r in results[1]:
        np.testing.assert_array_equal(r["dedup_off"], table[ids])
        assert r["guard"] and "silently truncate" in r["guard"]


def test_sharded_embedding_layer_rows_split(results):
    for r in results[1]:
        assert r["layer"]["spec"] == {"embeddings": ("model", None)}
        assert r["layer"]["local"] == (32, 8)
        assert r["layer"]["same"]


def test_embedding_replicated_fallback_warning(results):
    """D=7 under model 2 warns in one line; D=8 splits silently."""
    for r in results[1]:
        odd, even = r["fallback"]
        assert len(odd) == 1 and "replicated instead of model-sharded" \
            in odd[0]
        assert even == []


def test_resolve_sharded_embeddings_modes(results):
    """auto engages row-divisible tables only; true every table (97 rows:
    the lookup on the engine, the table whole); false and a model axis of
    1 decline."""
    for r in results[1]:
        res = r["resolve"]
        assert res["auto"] == (True, True, None, False)
        assert res["on"] == (True, False, True)
        assert res["off"] is None and res["model1"] is None


def test_ncf_fit_sharded_embedding_parity(results):
    """NeuralCF under {data:2, model:2} with ``zoo.embed.sharded`` on: the
    engine engages for both tables (each rank holds half of their rows),
    and the fit is the plain lookup's and the JAX row-sharded fit's."""
    for r in results[1]:
        on, off = r["ncf_on"], r["ncf_off"]
        assert any("sharded embedding engine engaged for 2 table(s)" in m
                   for m in on["log"])
        tables = {n: s for n, s in on["local"].items()
                  if n.endswith("embeddings")}
        assert sorted(s[0] for s in tables.values()) == [32, 64]
        np.testing.assert_allclose(on["loss"], off["loss"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(on["loss"], results[0]["fit"],
                                   rtol=1e-5, atol=1e-6)
        for n, a in on["params"].items():
            np.testing.assert_allclose(a, off["params"][n], rtol=1e-4,
                                       atol=1e-5)
