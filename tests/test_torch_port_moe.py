"""``SparseMoE`` (``pipeline/api/keras/layers/moe.py``) and expert
parallelism, held to the JAX package (``tests/test_moe.py``): the routing
and forward on transferred weights, capacity drops, 3-D inputs, the aux
loss reaching the router, the load balance, and fits over data, expert
and expert x model meshes against the JAX fits on the same meshes.

The mesh cases run as 4 gloo ranks on the CPU (one process group for the
file; ``file://`` store under ``tmp_path``); the workers import this
module, which imports no ``jax`` at the top.

Tolerances: the forward 1e-5 relative, 1e-6 absolute against the JAX
layer (f32, the same einsums) and the JAX test's 2e-4 / 2e-5 against the
dense-mixture oracle; fits 1e-5 on losses (collective order) and 1e-4
relative, 1e-5 absolute on the predictions after the 12 Adam steps (the
order's last-bit differences in the gradients move each step's update a
little; the JAX test allows 1e-3).
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.parallel.launch import run_ranks

WORLD = 4
MESHES = {"dp": {"data": 4}, "ep": {"data": 2, "expert": 2},
          "ep_tp": {"expert": 2, "model": 2}}


def _data(n=256, d=8, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, classes)).astype(np.float32)
    return x, np.argmax(x @ w, axis=1).astype(np.int32)


def _port_net(weight=1e-2, top_k=2, capacity=2.0):
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
        Sequential, reset_uids)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense, SparseMoE)
    reset_uids()
    return Sequential([
        Dense(16, activation="relu", input_shape=(8,)),
        SparseMoE(4, 32, top_k=top_k, capacity_factor=capacity,
                  aux_loss_weight=weight, name="moe"),
        Dense(4, activation="softmax")], device="cpu")


def _fit_port(axes, tree):
    pctx.reset_zoo_context()
    pctx.init_zoo_context(conf={f"zoo.mesh.{k}": v for k, v in axes.items()})
    m = _port_net().init_weights()
    m.load_jax_params(tree)
    wg = m.layers[1].Wg.detach().clone()
    m.compile(optimizer="adam", loss="scce", lr=0.01)
    x, y = _data()
    h = m.fit(x, y, batch_size=64, nb_epoch=3, shuffle=False)
    return {"loss": h["loss"], "pred": m.predict(x, batch_size=64),
            "wg_moved": not torch.equal(wg, m.layers[1].Wg.detach()),
            "w1": tuple(m.layers[1].W1.shape),
            "w2": tuple(m.layers[1].W2.shape)}


def _torch_side(rank, world, tree):
    return {name: _fit_port(axes, tree) for name, axes in MESHES.items()}


def _jax_net():
    from analytics_zoo_tpu.pipeline.api.keras import Sequential
    from analytics_zoo_tpu.pipeline.api.keras.layers import Dense, SparseMoE
    return Sequential([
        Dense(16, activation="relu", input_shape=(8,)),
        SparseMoE(4, 32, top_k=2, capacity_factor=2.0, name="moe"),
        Dense(4, activation="softmax")])


def _jax_side():
    import jax
    import optax

    from analytics_zoo_tpu.common.context import (init_zoo_context,
                                                  reset_zoo_context)
    from analytics_zoo_tpu.parallel import mesh as jmesh
    from analytics_zoo_tpu.pipeline.api.keras.engine import reset_uids
    x, y = _data()
    out, tree = {}, None
    for name, axes in MESHES.items():
        reset_zoo_context()
        init_zoo_context()
        jmesh.set_global_mesh(jmesh.create_mesh(devices=jax.devices()[:4],
                                                **axes))
        reset_uids()
        m = _jax_net()
        m.compile(optimizer=optax.adam(0.01), loss="scce")
        if tree is None:
            m.init_weights(sample_input=x[:2])
            tree = jax.tree.map(np.asarray, m.params)
        else:
            m.init_weights(sample_input=x[:2])
            m.params = jax.tree.map(jax.numpy.asarray, tree)
        h = m.fit(x, y, batch_size=64, nb_epoch=3, shuffle=False)
        out[name] = {"loss": h["loss"],
                     "pred": np.asarray(m.predict(x, batch_size=64))}
    reset_zoo_context()
    return tree, out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tree, want = _jax_side()
    store = tmp_path_factory.mktemp("gloo") / "store"
    return want, run_ranks(_torch_side, WORLD, str(store), args=(tree,))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_fit_matches_jax_on_the_mesh(results, mesh):
    """DP over 4 ranks, data 2 x expert 2 (EP, the two all-to-alls) and
    expert 2 x model 2 (EP x TP): every rank's losses and predictions the
    JAX fit's on the same mesh; the router weight moves."""
    want = results[0][mesh]
    for r in results[1]:
        got = r[mesh]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["pred"], want["pred"], rtol=1e-4,
                                   atol=1e-5)
        assert got["wg_moved"]


def test_ep_params_actually_sharded(results):
    for r in results[1]:
        assert r["dp"]["w1"] == (4, 16, 32)
        assert r["ep"]["w1"] == (2, 16, 32)
        assert r["ep_tp"]["w1"] == (2, 16, 16)
        assert r["ep_tp"]["w2"] == (2, 16, 16)


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def _layer_pair(e, h, d, **kw):
    import jax

    from analytics_zoo_tpu.pipeline.api.keras.layers import \
        SparseMoE as JaxMoE
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import SparseMoE
    jl = JaxMoE(e, h, **kw)
    params = jl.build(jax.random.key(0), (None, d))
    pl = SparseMoE(e, h, **kw)
    pl.build((None, d), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for k, v in params.items():
            getattr(pl, k).copy_(torch.from_numpy(np.asarray(v)))
    return jl, params, pl


def test_moe_matches_jax_and_the_dense_mixture_when_nothing_drops():
    import jax
    pctx.reset_zoo_context()
    pctx.init_zoo_context()
    rng = np.random.default_rng(0)
    e, d, h = 4, 8, 16
    jl, params, pl = _layer_pair(e, h, d, top_k=e, capacity_factor=float(e))
    x = rng.normal(size=(12, d)).astype(np.float32)
    y_j, st = jl.apply(params, jl.initial_state((None, d)),
                       jax.numpy.asarray(x))
    y_p = pl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(y_p, np.asarray(y_j), rtol=1e-5, atol=1e-6)
    pn = {k: np.asarray(v) for k, v in params.items()}
    logits = x @ pn["Wg"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    hid = np.maximum(np.einsum("nd,edh->enh", x, pn["W1"])
                     + pn["b1"][:, None, :], 0.0)
    out = np.einsum("enh,eho->eno", hid, pn["W2"]) + pn["b2"][:, None, :]
    np.testing.assert_allclose(y_p, np.einsum("ne,eno->no", probs, out),
                               rtol=2e-4, atol=2e-5)
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import \
        collect_aux_losses
    with collect_aux_losses() as aux:
        pl(torch.from_numpy(x), training=True)
    np.testing.assert_allclose(float(aux[0]), float(st["aux_loss"]),
                               rtol=1e-6)


def test_moe_capacity_overflow_drops_tokens():
    """A capacity of 1 a expert with top-1: at most E tokens served, the
    rest exactly zero, as the JAX layer."""
    import jax
    pctx.reset_zoo_context()
    pctx.init_zoo_context()
    jl, params, pl = _layer_pair(2, 8, 4, top_k=1, capacity_factor=1e-9)
    x = np.random.default_rng(1).normal(size=(10, 4)).astype(np.float32)
    y = pl(torch.from_numpy(x)).detach().numpy()
    assert np.sum(np.all(y == 0.0, axis=-1)) >= 10 - 2
    y_j, _ = jl.apply(params, jl.initial_state((None, 4)),
                      jax.numpy.asarray(x))
    np.testing.assert_allclose(y, np.asarray(y_j), rtol=1e-5, atol=1e-6)


def test_moe_3d_input_and_output_dim():
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import SparseMoE
    layer = SparseMoE(2, 8, output_dim=5)
    layer.build((None, 6, 4), generator=torch.Generator().manual_seed(0))
    assert layer(torch.randn(3, 6, 4)).shape == (3, 6, 5)
    assert layer.compute_output_shape((None, 6, 4)) == (None, 6, 5)


def test_moe_aux_loss_balances_experts():
    """With a strong balance weight the load after training is no more
    skewed than without one, and bounded (the aux loss reaches the
    router through the step)."""
    def primary_fracs(weight):
        pctx.reset_zoo_context()
        pctx.init_zoo_context()
        x, y = _data(seed=3)
        m = _port_net(weight=weight, top_k=1, capacity=4.0).init_weights(
            torch.Generator().manual_seed(3))
        m.compile(optimizer="adam", loss="scce", lr=0.02)
        m.fit(x, y, batch_size=64, nb_epoch=8, shuffle=False)
        d0 = m.layers[0]
        hidden = np.maximum(x @ d0.W.detach().numpy()
                            + d0.b.detach().numpy(), 0.0)
        logits = hidden @ m.layers[1].Wg.detach().numpy()
        counts = np.bincount(np.argmax(logits, -1), minlength=4)
        return counts / counts.sum()
    f_bal, f_raw = primary_fracs(0.5), primary_fracs(0.0)
    assert f_bal.max() < 0.90, f_bal
    assert f_bal.max() <= f_raw.max() + 0.05, (f_bal, f_raw)
