"""The elastic re-mesh restore (``TrainingLoop._try_resume``,
``mesh_step.py``): snapshots record the live ``mesh_metadata`` and keep
whole host leaves; a snapshot cut under one mesh restores under another
with the values bit for bit, each rank keeping its slices of the live
placement, and the change is logged and emitted as
``ckpt.elastic_restore`` (the JAX package's
``tests/test_checkpoint_chaos.py`` elastic cases and
``test_zero_sharding_elastic_restore_across_dp``).

Snapshots are cut by 2 or 4 gloo ranks on the CPU (one process group
each; ``file://`` stores under ``tmp_path``; the workers import this
module, which imports no ``jax`` at the top) and restored there or in
the test process on one rank. The JAX fit saves and restores on the
same topologies for the control losses.

Tolerances: restored values bit for bit (the JAX test's claim); resumed
losses 1e-4 relative, 1e-6 absolute against the uninterrupted fit (the
JAX test's: the resumed epoch reduces over another number of ranks).
"""

import json
import logging
import os

import numpy as np
import pytest

from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.parallel import mesh as pmesh
from analytics_zoo_tpu_torch.parallel.launch import run_ranks


def _data(n=256, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    w = rng.normal(size=(4, 1)).astype(np.float32)
    return x, (x @ w).astype(np.float32)


def _model(tree, ckpt=None):
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
        Sequential, reset_uids)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    reset_uids()
    m = Sequential([Dense(8, activation="relu", input_shape=(4,)),
                    Dense(1)], device="cpu").init_weights()
    m.load_jax_params(tree)
    m.compile(optimizer="adam", loss="mse", lr=0.05)
    if ckpt:
        m.set_checkpoint(ckpt, keep=None)
    return m


def _context(**axes):
    pctx.reset_zoo_context()
    pctx.init_zoo_context(conf={f"zoo.mesh.{k}": v for k, v in axes.items()})


def _full_state(m):
    from analytics_zoo_tpu_torch.pipeline.api.keras import dispatch
    plan = m._loop._mesh
    params = {n: pmesh.full_tensor(p).detach().numpy().copy()
              for n, p in m.named_parameters()}
    if plan is None:
        moments = [t.detach().numpy().copy()
                   for t in dispatch._leaves(m.opt_state["state"])]
    else:
        ids = plan.leaf_params(m._loop.optimizer, m.opt_state["state"],
                               list(m._loop._params()))
        moments = [plan.full(t, ids.get(id(t)), moment=id(t) in ids)
                   .numpy().copy()
                   for t in dispatch._leaves(m.opt_state["state"])]
    return params, moments


def _save(rank, world, tree, root, axes, epochs):
    """``epochs`` epochs under ``axes`` with a snapshot each; the whole
    state after."""
    _context(**axes)
    m = _model(tree, os.path.join(root, "ckpt"))
    x, y = _data()
    h = m.fit(x, y, batch_size=32, nb_epoch=epochs, shuffle=False)
    return {"loss": h["loss"], "state": _full_state(m)}


def _restore_case(m, events):
    """``_try_resume`` on a fresh model's live tensors, as fit does."""
    from analytics_zoo_tpu_torch.observability import default_registry
    loop = m._loop
    loop._mesh_step()
    params = loop._params()
    opt = loop._opt_state(params)
    default_registry().add_event_sink(events)
    try:
        meta = loop._try_resume(loop._ckpt_manager(), params, opt)
    finally:
        default_registry().remove_event_sink(events)
    return meta


class Events:
    def __init__(self):
        self.records = []

    def write(self, event):
        self.records.append(event)


def _reshard(rank, world, tree, root):
    """A {data:4} snapshot restored under {data:2, model:2}: bit-identical
    values, the Dense kernels split over model; then the third epoch
    resumed there."""
    _context(data=2, model=2)
    m = _model(tree, os.path.join(root, "ckpt"))
    events = Events()
    meta = _restore_case(m, events)
    local = {n: tuple(p.shape) for n, p in m.named_parameters()}
    state = _full_state(m)
    _context(data=2, model=2)
    m2 = _model(tree, os.path.join(root, "ckpt"))
    x, y = _data()
    h = m2.fit(x, y, batch_size=32, nb_epoch=1, shuffle=False)
    return {"meta_mesh": meta["mesh"], "events": events.records,
            "local": local, "state": state, "resumed": h["loss"],
            "epochs": m2.finished_epochs}


def _jax_tree():
    import jax

    from analytics_zoo_tpu.common.context import (init_zoo_context,
                                                  reset_zoo_context)
    from analytics_zoo_tpu.pipeline.api.keras import Sequential
    from analytics_zoo_tpu.pipeline.api.keras.engine import reset_uids
    from analytics_zoo_tpu.pipeline.api.keras.layers import Dense
    reset_zoo_context()
    init_zoo_context()
    reset_uids()
    m = Sequential([Dense(8, activation="relu", input_shape=(4,)),
                    Dense(1)])
    m.compile(optimizer="adam", loss="mse", lr=0.05)
    m.init_weights(sample_input=_data()[0][:8])
    tree = jax.tree.map(np.asarray, m.params)
    reset_zoo_context()
    return tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tree = _jax_tree()
    root = tmp_path_factory.mktemp("elastic")
    out = {"tree": tree}
    # the uninterrupted control: 3 epochs on 2 ranks
    out["control"] = run_ranks(_save, 2, str(root / "s0"),
                               args=(tree, str(root / "control"),
                                     {"data": 2}, 3))[0]
    # 2 epochs on 2 ranks; the third resumed on 1 (the test process)
    out["two"] = run_ranks(_save, 2, str(root / "s1"),
                           args=(tree, str(root / "two"), {"data": 2},
                                 2))[0]
    out["two_root"] = str(root / "two")
    # 2 epochs on 4 ranks, restored under {data:2, model:2}
    out["four"] = run_ranks(_save, 4, str(root / "s2"),
                            args=(tree, str(root / "four"), {"data": 4},
                                  2))[0]
    out["reshard"] = run_ranks(_reshard, 4, str(root / "s3"),
                               args=(tree, str(root / "four")))
    return out


def test_snapshot_records_the_live_mesh(runs):
    """Every manifest of the 2-rank fit names its mesh; rank 0 wrote it."""
    root = os.path.join(runs["two_root"], "ckpt")
    steps = sorted(d for d in os.listdir(root) if d.startswith("ckpt-"))
    assert len(steps) == 2
    for d in steps:
        with open(os.path.join(root, d, "manifest.json")) as f:
            mesh = json.load(f)["mesh"]
        assert mesh == {"axes": {"data": 2, "pipe": 1, "seq": 1,
                                 "expert": 1, "model": 1}, "devices": 2}


def test_elastic_restore_bit_identical_values_on_one_rank(runs, caplog):
    """A {data:2} snapshot restores on one rank: the parameters and the
    Adam moments bit for bit, the topology change logged and emitted."""
    pctx.reset_zoo_context()
    pctx.init_zoo_context()
    m = _model(runs["tree"], os.path.join(runs["two_root"], "ckpt"))
    events = Events()
    with caplog.at_level(logging.WARNING,
                         logger="analytics_zoo_tpu_torch"):
        meta = _restore_case(m, events)
    assert meta["mesh"]["axes"]["data"] == 2
    assert any("elastic restore" in r.message for r in caplog.records)
    assert [e for e in events.records
            if e["kind"] == "ckpt.elastic_restore"] == [
        {**events.records[0], "saved": "{data:2}", "restored": "{}"}]
    params, moments = _full_state(m)
    want_p, want_m = runs["two"]["state"]
    for n, a in want_p.items():
        np.testing.assert_array_equal(params[n], a)
    for a, b in zip(moments, want_m):
        np.testing.assert_array_equal(a, b)


def test_elastic_resume_on_one_rank_matches_uninterrupted_control(runs):
    """2 epochs on 2 ranks, the third resumed on one: the uninterrupted
    2-rank fit's third epoch."""
    pctx.reset_zoo_context()
    pctx.init_zoo_context()
    m = _model(runs["tree"], os.path.join(runs["two_root"], "ckpt"))
    x, y = _data()
    h = m.fit(x, y, batch_size=32, nb_epoch=1, shuffle=False)
    assert m.finished_epochs == 3
    np.testing.assert_allclose(h["loss"], runs["control"]["loss"][2:],
                               rtol=1e-4, atol=1e-6)


def test_elastic_model_axis_reshard_shards_restored_params(runs):
    """A pure-DP {data:4} snapshot restored under {data:2, model:2}: the
    values bit for bit, the divisible Dense kernel split over model, the
    event emitted; the resumed third epoch the uninterrupted fit's (the
    2-rank control: data parallelism over the same global batches).
    (JAX ``test_elastic_model_axis_reshard_shards_restored_params`` and
    the ``{data:4, model:2}`` cell of
    ``test_elastic_resume_matches_uninterrupted_control``.)"""
    want_p, want_m = runs["four"]["state"]
    for r in runs["reshard"]:
        assert r["meta_mesh"]["axes"]["data"] == 4
        assert any(e["kind"] == "ckpt.elastic_restore"
                   and e["restored"] == "{data:2, model:2}"
                   for e in r["events"])
        assert r["local"]["dense_0.W"] == (4, 4)
        params, moments = r["state"]
        for n, a in want_p.items():
            np.testing.assert_array_equal(params[n], a)
        for a, b in zip(moments, want_m):
            np.testing.assert_array_equal(a, b)
        assert r["epochs"] == 3
        np.testing.assert_allclose(r["resumed"], runs["control"]["loss"][2:],
                                   rtol=1e-4, atol=1e-6)
