"""ZeRO-1 in the port's training loop (``zoo.train.zero_sharding``,
``pipeline/api/keras/mesh_step.py``): each Adam moment keeps only its
``data`` rank's slice, the update runs on the slices and the parameters
are gathered back. Held to plain data parallelism bit for bit (the update
is elementwise; JAX ``test_zero_sharding_matches_plain_dp_exactly``), to
the JAX package's ZeRO-1 fit on the same mesh (1e-5 relative, 1e-6
absolute: collective order), and through an elastic restore to a
narrower data axis (1e-4, as the JAX test: the resumed epoch reduces over
another number of ranks).

The torch side runs as 4 gloo ranks on the CPU, one process group for the
file (module-scoped fixture, ``file://`` store under ``tmp_path``); the
workers import this module, which imports no ``jax`` at the top.
"""

import numpy as np
import pytest

from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.parallel import mesh as pmesh
from analytics_zoo_tpu_torch.parallel.launch import run_ranks

WORLD = 4


def _data(n=256, d=16, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d, 2))
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x, (x @ w).argmax(1).astype(np.int32)


def _port_fit(axes, zero, tree, epochs=3, ckpt=None):
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
        Sequential, reset_uids)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    pctx.reset_zoo_context()
    pctx.init_zoo_context(conf={"zoo.train.zero_sharding": zero,
                                **{f"zoo.mesh.{k}": v
                                   for k, v in axes.items()}})
    reset_uids()
    m = Sequential([Dense(32, activation="relu", input_shape=(16,)),
                    Dense(2, activation="softmax")], device="cpu")
    m.init_weights().load_jax_params(tree)
    m.compile(optimizer="adam", loss="scce", lr=0.01)
    if ckpt:
        m.set_checkpoint(ckpt)
    x, y = _data()
    return m, m.fit(x, y, batch_size=64, nb_epoch=epochs, shuffle=False)


def _moment_shapes(m):
    from analytics_zoo_tpu_torch.pipeline.api.keras import dispatch
    return [tuple(t.shape) for t in dispatch._leaves(m.opt_state["state"])
            if t.dim() > 0]


def _full(m):
    return {n: pmesh.full_tensor(p).detach().numpy()
            for n, p in m.named_parameters()}


def _torch_side(rank, world, tree, ckpt):
    out = {}
    for name, axes, zero in (("plain", {"data": 4}, False),
                             ("zero", {"data": 4}, True),
                             ("tp", {"data": 2, "model": 2}, False),
                             ("zero_tp", {"data": 2, "model": 2}, True)):
        m, h = _port_fit(axes, zero, tree)
        out[name] = {"loss": h["loss"], "params": _full(m),
                     "moments": _moment_shapes(m)}
    # elastic: 2 epochs at data 4 with snapshots, the third resumed on
    # data 2 x model 2 from the snapshot
    _port_fit({"data": 4}, True, tree, epochs=2, ckpt=ckpt)
    m, h = _port_fit({"data": 2, "model": 2}, True, tree, epochs=1,
                     ckpt=ckpt)
    out["resumed"] = {"loss": h["loss"], "epochs": m.finished_epochs,
                      "moments": _moment_shapes(m)}
    return out


def _jax_fit():
    import jax

    from analytics_zoo_tpu.common.context import (init_zoo_context,
                                                  reset_zoo_context)
    from analytics_zoo_tpu.parallel import mesh as jmesh
    from analytics_zoo_tpu.pipeline.api.keras import Sequential
    from analytics_zoo_tpu.pipeline.api.keras.engine import reset_uids
    from analytics_zoo_tpu.pipeline.api.keras.layers import Dense
    reset_zoo_context()
    init_zoo_context(conf={"zoo.train.zero_sharding": True})
    jmesh.set_global_mesh(jmesh.create_mesh(data=4,
                                            devices=jax.devices()[:4]))
    reset_uids()
    m = Sequential([Dense(32, activation="relu", input_shape=(16,)),
                    Dense(2, activation="softmax")])
    m.compile(optimizer="adam", loss="scce", lr=0.01)
    x, y = _data()
    m.init_weights(sample_input=x[:8])
    tree = jax.tree.map(np.asarray, m.params)
    h = m.fit(x, y, batch_size=64, nb_epoch=3, shuffle=False)
    after = {f"{layer}/{k}": np.asarray(v)
             for layer, d in m.params.items() for k, v in d.items()}
    reset_zoo_context()
    return tree, {"loss": h["loss"], "params": after}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tree, want = _jax_fit()
    tmp = tmp_path_factory.mktemp("zero")
    ranks = run_ranks(_torch_side, WORLD, str(tmp / "store"),
                      args=(tree, str(tmp / "ckpt")))
    return want, ranks


def test_zero_sharding_matches_plain_dp_exactly(results):
    """Losses and parameters the plain DP fit's, bit for bit, at data 4
    and at data 2 x model 2."""
    for r in results[1]:
        for plain, zero in (("plain", "zero"), ("tp", "zero_tp")):
            np.testing.assert_array_equal(r[zero]["loss"], r[plain]["loss"])
            for n, a in r[plain]["params"].items():
                np.testing.assert_array_equal(r[zero]["params"][n], a)


def test_zero_sharding_actually_shards_moments(results):
    """Every moment of a leaf with a dimension the data axis divides keeps
    a quarter of it (mu and nu of the 16x32 and 32x2 kernels and the
    32-bias; the 2-bias stays whole): at least 4, as the JAX test asks."""
    for r in results[1]:
        plain, zero = r["plain"]["moments"], r["zero"]["moments"]
        split = [(a, b) for a, b in zip(plain, zero) if a != b]
        assert len(split) >= 4, zero
        for full, part in split:
            assert np.prod(part) * 4 == np.prod(full)
        assert (2,) in zero


def test_zero_fit_matches_jax(results):
    want = results[0]
    for r in results[1]:
        np.testing.assert_allclose(r["zero"]["loss"], want["loss"],
                                   rtol=1e-5, atol=1e-6)
        for n, a in r["zero"]["params"].items():
            np.testing.assert_allclose(a, want["params"][n.replace(".", "/")],
                                       rtol=1e-5, atol=1e-6)


def test_zero_sharding_elastic_restore_across_dp(results):
    """A snapshot cut at data 4 with split moments resumes at data 2 x
    model 2: the moments re-split over the narrower data axis, and the
    resumed epoch's loss is the uninterrupted fit's third (JAX
    ``test_zero_sharding_elastic_restore_across_dp``, which narrows the
    data axis from 8 to 4 devices; here 4 ranks stay, 2 of them now on
    the model axis)."""
    for r in results[1]:
        assert r["resumed"]["epochs"] == 3
        np.testing.assert_allclose(r["resumed"]["loss"],
                                   r["zero"]["loss"][2:], rtol=1e-4,
                                   atol=1e-6)
        # the kernels' model halves (16 x 16, 32 x 1), each split again
        # over data 2; the biases are split over model alone
        halves = [s for s in r["resumed"]["moments"]
                  if s in ((8, 16), (16, 1))]
        assert len(halves) == 4, r["resumed"]["moments"]
