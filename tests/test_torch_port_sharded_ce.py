"""The vocab-sharded fused LM-head cross-entropy
(``ops/fused_cross_entropy.py`` ``sharded_fused_cross_entropy_rows``,
``sharded_fused_sparse_cross_entropy``, ``vocab_shard_count``) and its
routing in the training loop (``keras/fused_loss.py``), held to the JAX
package's sharded op on the same mesh and to the port's unsharded op.

The torch side runs as 4 gloo ranks on the CPU (one process group for the
file; ``file://`` store under ``tmp_path``); the workers import this
module, which imports no ``jax`` at the top. On the CPU the kernels' plain
versions run (K4, K5a, K5b on each rank's ``(chunk, V/n)`` tiles on the
card: ``chip_smoke.py``'s mesh phase).

Tolerances: rows and gradients against the JAX sharded op and the
unsharded op 1e-5 relative, 1e-6 absolute (f32; only the cross-shard sum
re-associates); training losses 1e-5, parameters 1e-4 after Adam, as the
JAX test allows.
"""

import logging

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.ops import fused_cross_entropy as pfce
from analytics_zoo_tpu_torch.parallel import mesh as pmesh
from analytics_zoo_tpu_torch.parallel.launch import run_ranks

WORLD = 4
MESHES = {"model2": {"data": 2, "model": 2}, "model4": {"model": 4}}


def _setup(n=37, h=24, v=130, seed=0):
    """Odd N (37) over chunks of 8, V=130 (not divisible by 4: the padded
    shard path), every fifth label masked."""
    rng = np.random.default_rng(seed)
    hid = rng.normal(size=(n, h)).astype(np.float32)
    w = (rng.normal(size=(h, v)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(v,)) * 0.1).astype(np.float32)
    y = rng.integers(0, v, n).astype(np.int32)
    y[::5] = -1
    return hid, w, b, y


def _grads(fn, hid, w, b, y):
    ht, wt, bt = (torch.tensor(a, requires_grad=True) for a in (hid, w, b))
    loss = fn(torch.from_numpy(y), ht, wt, bt)
    loss.backward()
    return float(loss), ht.grad.numpy(), wt.grad.numpy(), bt.grad.numpy()


def _op_case(axes, bias=True, bf16=False, over_range=False):
    pctx.reset_zoo_context()
    pctx.init_zoo_context(conf={f"zoo.mesh.{k}": v for k, v in axes.items()})
    hid, w, b, y = _setup()
    if over_range:
        y = np.where(np.arange(37) == 3, 500, np.maximum(y, 0)).astype(
            np.int32)
    b = b if bias else None
    rows = pfce.sharded_fused_cross_entropy_rows(
        torch.from_numpy(hid), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), torch.from_numpy(y),
        chunk=8).numpy()
    out = {"rows": rows, "count": pfce.vocab_shard_count()}
    if bias and not bf16:
        out["grads"] = _grads(
            lambda yy, h, ww, bb: pfce.sharded_fused_sparse_cross_entropy(
                yy, h, ww, bb, chunk=8), hid, w, b, y)
        out["plain_grads"] = _grads(
            lambda yy, h, ww, bb: pfce.fused_sparse_cross_entropy(
                yy, h, ww, bb, chunk=8), hid, w, b, y)
    out["plain_rows"] = pfce.fused_cross_entropy_rows(
        torch.from_numpy(hid), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), torch.from_numpy(y),
        chunk=8).numpy()
    if bf16:
        hb = torch.from_numpy(hid).to(torch.bfloat16)
        wb = torch.from_numpy(w).to(torch.bfloat16)
        out["bf16"] = (
            float(pfce.sharded_fused_sparse_cross_entropy(
                torch.from_numpy(y), hb, wb, torch.from_numpy(b), chunk=16)),
            float(pfce.fused_sparse_cross_entropy(
                torch.from_numpy(y), hb, wb, torch.from_numpy(b), chunk=16)))
    return out


def _tiles_case():
    """The largest logits tile each rank forms on the LM-head shape
    (N=4096, H=64, V=8192, chunk 128, model 2), and dW's shape."""
    from analytics_zoo_tpu_torch.ops.pallas import cross_entropy as pce
    pctx.reset_zoo_context()
    pctx.init_zoo_context(conf={"zoo.mesh.model": 2})
    seen = []
    orig = pce._chunk_logits

    def spy(h, w, b):
        out = orig(h, w, b)
        seen.append(out.numel())
        return out
    pce._chunk_logits = spy
    try:
        n, h, v = 4096, 64, 8192
        hid = torch.zeros(n, h, requires_grad=True)
        w = torch.zeros(h, v, requires_grad=True)
        pfce.sharded_fused_sparse_cross_entropy(
            torch.zeros(n, dtype=torch.int32), hid, w,
            torch.zeros(v), chunk=128).backward()
    finally:
        pce._chunk_logits = orig
    return {"largest": max(seen), "dw": tuple(w.grad.shape)}


def _fit_case(conf, tree, v=2048):
    from analytics_zoo_tpu_torch.observability import default_registry
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
        Sequential, reset_uids)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    pctx.reset_zoo_context()
    pctx.init_zoo_context(conf=conf)
    reset_uids()
    rng = np.random.default_rng(7)
    x = rng.normal(size=(192, 12)).astype(np.float32)
    y = rng.integers(0, v, 192).astype(np.int32)
    m = Sequential([Dense(16, activation="relu", input_shape=(12,)),
                    Dense(v)], device="cpu")
    m.init_weights().load_jax_params(tree)
    m.compile(optimizer="adam", loss="scce_with_logits", lr=1e-2)
    records = []

    class Catch(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    log = logging.getLogger("analytics_zoo_tpu_torch")
    handler = Catch(logging.INFO)
    log.addHandler(handler)
    try:
        hist = m.fit(x, y, batch_size=64, nb_epoch=2, shuffle=False)
    finally:
        log.removeHandler(handler)
    snap = default_registry().snapshot()
    gauge = [k for k, val in snap.items()
             if k.startswith("zoo_train_fused_ce") and 'sharded="1"' in k
             and (val["value"] if isinstance(val, dict) else val) == 1]
    return {"loss": hist["loss"], "log": records, "gauge": gauge,
            "params": {n: pmesh.full_tensor(p).detach().numpy()
                       for n, p in m.named_parameters()},
            "local_head": tuple(m.layers[1].W.shape)}


def _resolution_case():
    from analytics_zoo_tpu_torch.pipeline.api.keras import objectives
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
        Sequential, reset_uids)
    from analytics_zoo_tpu_torch.pipeline.api.keras.fused_loss import \
        resolve_fused_loss
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    pctx.reset_zoo_context()
    pctx.init_zoo_context(conf={"zoo.train.fused_ce": True,
                                "zoo.mesh.model": 2})
    out = []
    for v in (2049, 2048):
        reset_uids()
        m = Sequential([Dense(8, input_shape=(4,)), Dense(v)], device="cpu")
        spec = resolve_fused_loss(
            m, objectives.sparse_categorical_crossentropy_from_logits)
        out.append(spec is not None and spec.sharded)
    return out


def _torch_side(rank, world, tree):
    out = {f"op_{name}": _op_case(axes) for name, axes in MESHES.items()}
    out["over_range"] = _op_case({"model": 2, "data": 2}, over_range=True)
    out["no_bias"] = _op_case({"model": 2, "data": 2}, bias=False)
    out["model1"] = _op_case({"data": 4}, bias=False)
    out["bf16"] = _op_case({"model": 2, "data": 2}, bf16=True)
    out["tiles"] = _tiles_case()
    out["fit_full"] = _fit_case({"zoo.train.fused_ce": False,
                                 "zoo.mesh.data": 4}, tree)
    out["fit_sharded"] = _fit_case({"zoo.train.fused_ce": True,
                                    "zoo.mesh.model": 2}, tree)
    out["resolution"] = _resolution_case()
    return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_ops():
    import jax
    import jax.numpy as jnp

    from analytics_zoo_tpu.common.context import (init_zoo_context,
                                                  reset_zoo_context)
    from analytics_zoo_tpu.ops.fused_cross_entropy import (
        sharded_fused_cross_entropy_rows, sharded_fused_sparse_cross_entropy)
    from analytics_zoo_tpu.parallel import mesh as jmesh
    out = {}
    hid, w, b, y = (jnp.asarray(a) for a in _setup())
    for name, axes in MESHES.items():
        reset_zoo_context()
        init_zoo_context()
        jmesh.set_global_mesh(jmesh.create_mesh(devices=jax.devices()[:4],
                                                **axes))
        rows = np.asarray(sharded_fused_cross_entropy_rows(
            hid, w, b, y, chunk=8, use_pallas=False))
        loss, grads = jax.value_and_grad(
            lambda h, ww, bb: sharded_fused_sparse_cross_entropy(
                y, h, ww, bb, chunk=8, use_pallas=False),
            argnums=(0, 1, 2))(hid, w, b)
        out[name] = (rows, float(loss), [np.asarray(g) for g in grads])
    reset_zoo_context()
    return out


def _jax_fit():
    import jax
    import optax

    from analytics_zoo_tpu.common.context import (init_zoo_context,
                                                  reset_zoo_context)
    from analytics_zoo_tpu.parallel import mesh as jmesh
    from analytics_zoo_tpu.pipeline.api.keras import Sequential
    from analytics_zoo_tpu.pipeline.api.keras.engine import reset_uids
    from analytics_zoo_tpu.pipeline.api.keras.layers import Dense
    reset_zoo_context()
    init_zoo_context(conf={"zoo.train.fused_ce": True})
    jmesh.set_global_mesh(jmesh.create_mesh(data=2, model=2,
                                            devices=jax.devices()[:4]))
    reset_uids()
    rng = np.random.default_rng(7)
    x = rng.normal(size=(192, 12)).astype(np.float32)
    y = rng.integers(0, 2048, 192).astype(np.int32)
    m = Sequential([Dense(16, activation="relu", input_shape=(12,)),
                    Dense(2048)])
    m.compile(optimizer=optax.adam(1e-2), loss="scce_with_logits")
    m.init_weights(sample_input=x[:8])
    tree = jax.tree.map(np.asarray, m.params)
    hist = m.fit(x, y, batch_size=64, nb_epoch=2, shuffle=False)
    after = {f"{layer}/{k}": np.asarray(v)
             for layer, d in m.params.items() for k, v in d.items()}
    reset_zoo_context()
    return tree, {"loss": hist["loss"], "params": after}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ops = _jax_ops()
    tree, fit = _jax_fit()
    store = tmp_path_factory.mktemp("gloo") / "store"
    return ops, fit, run_ranks(_torch_side, WORLD, str(store), args=(tree,))


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_matches_jax_and_the_unsharded_op(results, mesh):
    """Loss rows and dh/dW/db on {data:2, model:2} and {model:4} (V=130:
    the padded shards), masked labels and N % chunk != 0 included: the
    JAX sharded op's and the port's unsharded op's; masked rows' dh
    exactly 0."""
    rows_j, loss_j, grads_j = results[0][mesh]
    for r in results[2]:
        got = r[f"op_{mesh}"]
        _close(got["rows"], rows_j)
        _close(got["rows"], got["plain_rows"])
        loss, *grads = got["grads"]
        _close(loss, loss_j)
        for a, b, c in zip(grads, grads_j, got["plain_grads"][1:]):
            _close(a, b)
            _close(a, c)
        np.testing.assert_array_equal(grads[0][::5], 0.0)
        assert got["count"] == (2 if mesh == "model2" else 4)


def test_sharded_over_range_labels_poison_all_shards(results):
    """A label >= V NaNs its row and dW on every shard's columns."""
    for r in results[2]:
        got = r["over_range"]
        assert np.isnan(got["rows"][3])
        assert np.isfinite(np.delete(got["rows"], 3)).all()
        gw = got["grads"][2]
        assert np.isnan(gw[:, :65]).any() and np.isnan(gw[:, 65:]).any()


def test_sharded_no_bias_and_model1_fallback(results):
    """No bias: the unsharded op's rows; a model axis of 1: the unsharded
    op itself, bit for bit."""
    for r in results[2]:
        _close(r["no_bias"]["rows"], r["no_bias"]["plain_rows"])
        assert r["model1"]["count"] == 1
        np.testing.assert_array_equal(r["model1"]["rows"],
                                      r["model1"]["plain_rows"])


def test_sharded_bf16_matches_unsharded(results):
    for r in results[2]:
        got, want = r["bf16"]["bf16"]
        _close(got, want)


def test_sharded_backward_no_full_vocab_per_rank(results):
    """At the LM-head shape every logits tile a rank forms is (chunk,
    V/n) and dW stays (H, V/n) (JAX's jaxpr gate, read from the tiles)."""
    for r in results[2]:
        assert r["tiles"]["largest"] == 128 * 8192 // 2
        assert r["tiles"]["dw"] == (64, 8192)


def test_sharded_training_loop_matches_jax_and_unsharded(results):
    """A 2048-wide head under {data:2, model:2}: the vocab-sharded fused
    CE engages (log line, ``sharded="1"`` gauge, the head's columns
    halved), and the losses are the JAX sharded fit's and the port's
    full-logits DP fit's."""
    fit = results[1]
    for r in results[2]:
        got = r["fit_sharded"]
        assert any("VOCAB-SHARDED" in m for m in got["log"])
        assert got["gauge"]
        assert got["local_head"] == (16, 1024)
        _close(got["loss"], fit["loss"])
        _close(got["loss"], r["fit_full"]["loss"])
        for n, a in got["params"].items():
            _close(a, fit["params"][n.replace(".", "/")], rtol=1e-4,
                   atol=1e-5)


def test_sharded_resolution_respects_divisibility(results):
    """A head the model axis does not divide (2049) takes the unsharded
    fused loss; 2048 the sharded one."""
    for r in results[2]:
        assert r["resolution"] == [False, True]
