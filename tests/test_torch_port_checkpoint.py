"""The port's checkpoints held to the JAX package's (``utils/
checkpoint.py``, ``scripts/zoo-ckpt``): the on-disk format, verified
restore with quarantine and fallback, the writer's fault sites, resume,
retry and SIGTERM through ``fit``, the operator CLI, and snapshots that
restore across the two packages.

Every scenario of ``tests/test_checkpoint.py`` and of
``tests/test_checkpoint_chaos.py`` (bar the elastic re-mesh ones, which
need more than one device) runs here against the port; where the JAX
package can run the same thing it does, and the results are compared:
the manifests of the same trees (equal but for nothing: the ``.npz``
bytes and so the CRC32s are the same), the CLIs' output and exit codes
on the same directory, and the fits that resume from each other's
snapshots.

Tolerances: snapshots and restores are bit for bit. A fit resumed in the
port against the same resume in the JAX package: 1e-5 absolute on the
losses and parameters (the same f32 arithmetic in other summation
orders; the JAX side runs on conftest's 8-device CPU mesh), except the
key third of BERT's fused qkv bias, whose exact gradient is zero, held at
2 x steps x lr as in ``tests/test_torch_port_training.py``. A port fit
resumed from a snapshot against the uninterrupted port fit: 1e-5
relative, as the JAX test holds its own.
"""

import contextlib
import io
import json
import os
import runpy
import shutil
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.models.recommendation import NeuralCF as JNeuralCF
from analytics_zoo_tpu.observability import MetricsRegistry as JRegistry
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.tfpark.bert_classifier import \
    BERTClassifier as JBERTClassifier
from analytics_zoo_tpu.utils.checkpoint import \
    CheckpointManager as JCheckpointManager
from analytics_zoo_tpu_torch import observability as pobs
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.common import faults
from analytics_zoo_tpu_torch.common.faults import FaultPlan
from analytics_zoo_tpu_torch.common.triggers import SeveralIteration, Trigger
from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
from analytics_zoo_tpu_torch.observability import (MetricsRegistry,
                                                   default_registry)
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as pl
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import \
    multi_optimizer
from analytics_zoo_tpu_torch.pipeline.api.keras.training import \
    TrainingPreempted
from analytics_zoo_tpu_torch.pipeline.inference.inference_model import \
    InferenceModel
from analytics_zoo_tpu_torch.tfpark.bert_classifier import (
    BERTClassifier, make_bert_inputs)
from analytics_zoo_tpu_torch.utils import ckpt_cli
from analytics_zoo_tpu_torch.utils.checkpoint import (
    MESH_ONE_DEVICE, CheckpointArchitectureError, CheckpointCorruptError,
    CheckpointManager, CheckpointSaveError, tree_leaves)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CKPT_CLI = os.path.join(REPO, "scripts", "zoo-ckpt")


@pytest.fixture(autouse=True)
def contexts():
    pctx.reset_zoo_context()
    pobs.reset_default_registry()
    peng.reset_uids()
    yield
    pctx.reset_zoo_context()
    jctx.reset_zoo_context()
    jeng.set_policy()


def _data(n=256, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    w = rng.normal(size=(4, 1)).astype(np.float32)
    return x, (x @ w).astype(np.float32)


def _model():
    m = Sequential([pl.Dense(8, activation="relu", input_shape=(4,),
                             name="d0"), pl.Dense(1, name="d1")],
                   device="cpu")
    m.init_weights(torch.Generator().manual_seed(0))
    m.compile(optimizer="adam", loss="mse", lr=0.05)
    return m


def _tree(seed=3):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 8)).astype(np.float32),
            "b": {"c": rng.normal(size=(8,)).astype(np.float32)}}


def _template():
    return {"w": np.zeros((4, 8), np.float32),
            "b": {"c": np.zeros((8,), np.float32)}}


def _counters(*names):
    snap = default_registry().snapshot()
    out = {}
    for n in names:
        e = snap.get(n, {})
        out[n] = e.get("value", e.get("count", 0))
    return out


def _flip_byte(path, offset_frac=0.5):
    b = bytearray(open(path, "rb").read())
    b[int(len(b) * offset_frac)] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(b))


def _params(m):
    return {n: p.detach().numpy().copy() for n, p in m.named_parameters()}


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py
# ---------------------------------------------------------------------------

def test_checkpoint_manager_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.ones(4)}}
    mgr.save(1, {"t": tree}, meta={"epoch": 1})
    mgr.save(5, {"t": tree}, meta={"epoch": 2})
    mgr.save(9, {"t": tree}, meta={"epoch": 3})
    assert mgr.steps() == [5, 9]  # pruned to keep=2
    assert mgr.latest() == 9
    template = {"a": np.zeros((2, 3), np.float32), "b": {"c": np.zeros(4)}}
    trees, meta = mgr.restore(9, {"t": template})
    np.testing.assert_array_equal(trees["t"]["a"], tree["a"])
    assert meta["epoch"] == 3


def test_checkpoint_restore_rejects_mismatched_template(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"t": {"a": np.ones(3)}})
    with pytest.raises(ValueError, match="architecture mismatch"):
        mgr.restore(1, {"t": {"a": np.ones(3), "b": np.ones(2)}})


def test_fit_writes_epoch_checkpoints(tmp_path):
    pctx.init_zoo_context()
    x, y = _data()
    m = _model()
    m.set_checkpoint(str(tmp_path / "ckpt"))
    m.fit(x, y, batch_size=32, nb_epoch=3)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert len(mgr.steps()) == 3  # one per epoch (keep default 3)


def test_fit_iteration_trigger_checkpoints(tmp_path):
    pctx.init_zoo_context()
    x, y = _data()
    m = _model()
    m.set_checkpoint(str(tmp_path / "ckpt"), trigger=SeveralIteration(4),
                     keep=100)
    m.fit(x, y, batch_size=32, nb_epoch=2)  # 8 iterations/epoch
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.steps() == [4, 8, 12, 16]


def test_resume_after_process_death(tmp_path):
    """A fresh model object on the directory resumes from epoch 2 and
    ends on the uninterrupted 3-epoch run's parameters."""
    pctx.init_zoo_context()
    x, y = _data()
    m = _model()
    m.set_checkpoint(str(tmp_path / "ckpt"))
    m.fit(x, y, batch_size=32, nb_epoch=2)
    m2 = Sequential([pl.Dense(8, activation="relu", input_shape=(4,),
                              name="d0"), pl.Dense(1, name="d1")],
                    device="cpu")
    m2.init_weights(torch.Generator().manual_seed(99))   # other weights
    m2.compile(optimizer="adam", loss="mse", lr=0.05)
    m2.set_checkpoint(str(tmp_path / "ckpt"))
    history = m2.fit(x, y, batch_size=32, nb_epoch=1)
    assert m2.finished_epochs == 3 and m2.finished_iterations == 24
    assert len(history["loss"]) == 1
    control = _model()                                    # no snapshots
    control.fit(x, y, batch_size=32, nb_epoch=3)
    for name, a in _params(control).items():
        np.testing.assert_array_equal(_params(m2)[name], a)
    assert m2.opt_state["count"] == control.opt_state["count"] == 24


def test_retry_reloads_checkpoint_on_failure(tmp_path):
    pctx.init_zoo_context(failure_retry_times=3)
    x, y = _data()
    m = _model()
    m.set_checkpoint(str(tmp_path / "ckpt"))
    m.fit(x, y, batch_size=32, nb_epoch=1)  # cut an initial snapshot
    control = _model()
    control.fit(x, y, batch_size=32, nb_epoch=3)

    loop = m._loop
    real_step = loop.train_step
    calls = {"n": 0}

    def flaky_step(*args):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected step failure")
        return real_step(*args)

    loop.train_step = flaky_step
    history = m.fit(x, y, batch_size=32, nb_epoch=2)
    assert calls["n"] > 3  # retried past the failure
    assert m.finished_epochs == 3
    assert np.isfinite(history["loss"][-1])
    # the retry restarted from the snapshot: the uninterrupted run's bits
    for name, a in _params(control).items():
        np.testing.assert_array_equal(_params(m)[name], a)


def test_retry_exhaustion_raises(tmp_path):
    pctx.init_zoo_context(failure_retry_times=2)
    x, y = _data()
    m = _model()
    m.set_checkpoint(str(tmp_path / "ckpt"))
    m.fit(x, y, batch_size=32, nb_epoch=1)

    def always_fail(*args):
        raise RuntimeError("permanent failure")

    m._loop.train_step = always_fail
    with pytest.raises(RuntimeError, match="permanent failure"):
        m.fit(x, y, batch_size=32, nb_epoch=1)


def test_failure_without_checkpoint_raises_immediately():
    pctx.init_zoo_context()
    x, y = _data()
    m = _model()
    m.fit(x, y, batch_size=32, nb_epoch=1)
    m._loop.train_step = lambda *a: (_ for _ in ()).throw(
        RuntimeError("no checkpoint to recover from"))
    with pytest.raises(RuntimeError):
        m.fit(x, y, batch_size=32, nb_epoch=1)


def test_keep_validation_and_keep_zero_retains_all(tmp_path):
    with pytest.raises(ValueError, match="keep"):
        CheckpointManager(str(tmp_path), keep=-1)
    mgr = CheckpointManager(str(tmp_path), keep=0)
    tree = {"a": np.ones(3, np.float32)}
    for step in (1, 2, 3, 4, 5):
        mgr.save(step, {"t": tree}, sync=True)
    assert mgr.steps() == [1, 2, 3, 4, 5]     # nothing pruned


def test_zero_size_leaf_roundtrips(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"empty": np.zeros((0, 3), np.float32),
            "scalar": np.float32(2.5),
            "normal": np.arange(4, dtype=np.int32)}
    mgr.save(7, {"t": tree}, sync=True)
    assert mgr.verify(7)[0] == "ok"
    template = {"empty": np.ones((0, 3), np.float32),
                "scalar": np.float32(0.0),
                "normal": np.zeros(4, np.int32)}
    trees, meta = mgr.restore(7, {"t": template})
    assert trees["t"]["empty"].shape == (0, 3)
    assert float(trees["t"]["scalar"]) == 2.5
    np.testing.assert_array_equal(trees["t"]["normal"], tree["normal"])
    assert meta["step"] == 7


def test_manifest_is_the_commit_marker(tmp_path):
    """The manifest's schema — and, for the same trees, the JAX manager's
    manifest itself (the .npz bytes and so the CRC32s are the same)."""
    mgr = CheckpointManager(str(tmp_path / "port"))
    trees = {"params": {"w": np.ones((2, 2), np.float32),
                        "a": {"b": np.arange(3, dtype=np.int32)}},
             "opt_state": [np.int32(3), np.zeros(2, np.float32)]}
    mgr.save(3, trees, sync=True, mesh=MESH_ONE_DEVICE)
    manifest = _manifest(str(tmp_path / "port" / "ckpt-3"))
    entry = manifest["trees"]["params"]
    assert entry["file"] == "params.npz"
    assert entry["leaves"] == [{"shape": [3], "dtype": "int32"},
                               {"shape": [2, 2], "dtype": "float32"}]
    assert entry["bytes"] > 0 and 0 <= entry["crc32"] <= 0xFFFFFFFF
    assert manifest["meta"]["step"] == 3
    JCheckpointManager(str(tmp_path / "jax"), registry=JRegistry()).save(
        3, trees, sync=True, mesh=MESH_ONE_DEVICE)
    assert manifest == _manifest(str(tmp_path / "jax" / "ckpt-3"))


def _port_cli(*args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = ckpt_cli.main(list(args))
    return rc, out.getvalue(), err.getvalue()


def _jax_cli(*args):
    out, err = io.StringIO(), io.StringIO()
    old = sys.argv
    sys.argv = ["zoo-ckpt", *args]
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            ns = runpy.run_path(JAX_CKPT_CLI, run_name="zoo_ckpt_cli")
            rc = ns["main"]()
    finally:
        sys.argv = old
    return rc, out.getvalue(), err.getvalue()


def test_zoo_ckpt_cli_list_verify_prune(tmp_path):
    """The port's CLI gives the JAX script's output and exit codes on the
    same directory (a corrupt middle snapshot): list 0, verify 2, prune
    refusing --keep 0 with 1, prune --keep 2, a missing directory 1; and
    it runs as ``python -m``."""
    tree = {"w": np.arange(8, dtype=np.float32)}
    for name in ("port", "jax"):
        mgr = CheckpointManager(str(tmp_path / name), keep=0)
        for step in (4, 8, 12):
            mgr.save(step, {"params": tree}, meta={"epoch": step // 4},
                     sync=True)
        _flip_byte(str(tmp_path / name / "ckpt-8" / "params.npz"))
    for args in (("list",), ("verify",), ("prune", "--keep", "0")):
        got = _port_cli(*args, str(tmp_path / "port"))
        want = _jax_cli(*args, str(tmp_path / "jax"))
        assert got[0] == want[0]
        assert got[1].replace("port", "jax") == want[1]
        assert got[2].replace("port", "jax") == want[2]
    rc, out, _ = _port_cli("list", str(tmp_path / "port"))
    assert rc == 0 and "ckpt-4" in out and "committed" in out
    rc, out, err = _port_cli("verify", str(tmp_path / "port"))
    assert rc == 2 and "CRC32" in out and "FAILED" in err

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    def run(*args):
        return subprocess.run(
            [sys.executable, "-m", "analytics_zoo_tpu_torch.utils.ckpt_cli",
             *args], capture_output=True, text=True, env=env, timeout=120)

    r = run("prune", "--keep", "2", str(tmp_path / "port"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert _jax_cli("prune", "--keep", "2", str(tmp_path / "jax"))[1] \
        == r.stdout
    assert sorted(os.listdir(str(tmp_path / "port"))) == ["ckpt-12",
                                                          "ckpt-8"]
    r = run("list", str(tmp_path / "nope"))
    assert r.returncode == 1 and "not a directory" in r.stderr


# ---------------------------------------------------------------------------
# tests/test_checkpoint_chaos.py: manager-level scenarios
# ---------------------------------------------------------------------------

def test_kill_mid_write_is_never_committed_and_falls_back(tmp_path):
    pctx.init_zoo_context(faults_enabled=True)
    reg = MetricsRegistry()
    mgr = CheckpointManager(str(tmp_path), keep=0, registry=reg)
    good = _tree(seed=1)
    mgr.save(8, {"params": good}, meta={"epoch": 1}, sync=True)
    plan = FaultPlan(seed=7).add("ckpt.write", "error", at=(0,))
    with faults.activate(plan):
        with pytest.raises(CheckpointSaveError):
            mgr.save(16, {"params": _tree(seed=2)}, meta={"epoch": 2},
                     sync=True)
    assert plan.fired == [("ckpt.write", "error", 0)]
    assert mgr.latest() == 8
    out = mgr.restore_latest({"params": _template()})
    assert out is not None
    step, trees, meta = out
    assert step == 8 and meta["epoch"] == 1
    np.testing.assert_array_equal(trees["params"]["w"], good["w"])
    np.testing.assert_array_equal(trees["params"]["b"]["c"], good["b"]["c"])
    assert os.path.isdir(str(tmp_path / "ckpt-16.corrupt"))
    snap = reg.snapshot()
    assert snap["zoo_ckpt_save_failures_total"]["value"] == 1
    assert snap["zoo_ckpt_corrupt_total"]["value"] == 1
    assert snap["zoo_ckpt_restore_fallback_total"]["value"] == 1


def test_manifest_write_crash_never_commits(tmp_path):
    pctx.init_zoo_context(faults_enabled=True)
    reg = MetricsRegistry()
    mgr = CheckpointManager(str(tmp_path), keep=0, registry=reg)
    plan = FaultPlan(seed=21).add("ckpt.manifest", "error", at=(0,))
    with faults.activate(plan):
        with pytest.raises(CheckpointSaveError):
            mgr.save(4, {"params": _tree()}, sync=True)
    assert plan.fired == [("ckpt.manifest", "error", 0)]
    assert not os.path.exists(str(tmp_path / "ckpt-4" / "manifest.json"))
    assert mgr.latest() is None
    assert reg.snapshot()["zoo_ckpt_save_failures_total"]["value"] == 1


def test_manifest_commit_crash_never_commits(tmp_path):
    pctx.init_zoo_context(faults_enabled=True)
    reg = MetricsRegistry()
    mgr = CheckpointManager(str(tmp_path), keep=0, registry=reg)
    plan = FaultPlan(seed=9).add("ckpt.rename", "error", at=(0,))
    with faults.activate(plan):
        with pytest.raises(CheckpointSaveError):
            mgr.save(4, {"params": _tree()}, sync=True)
    assert plan.fired == [("ckpt.rename", "error", 0)]
    assert os.path.exists(str(tmp_path / "ckpt-4" / "manifest.json.tmp"))
    assert not os.path.exists(str(tmp_path / "ckpt-4" / "manifest.json"))
    assert mgr.latest() is None
    status, reason = mgr.verify(4)
    assert status == "uncommitted" and "never committed" in reason


def test_async_save_failure_surfaces_on_next_save(tmp_path):
    pctx.init_zoo_context(faults_enabled=True)
    reg = MetricsRegistry()
    mgr = CheckpointManager(str(tmp_path), keep=0, registry=reg)
    plan = FaultPlan(seed=5).add("ckpt.write", "error", at=(0,))
    with faults.activate(plan):
        mgr.save(8, {"params": _tree()})          # async; fails in background
        with pytest.raises(CheckpointSaveError, match="ckpt-8"):
            mgr.save(16, {"params": _tree()})
        mgr.save(16, {"params": _tree()})
        mgr.close()
    assert plan.fired == [("ckpt.write", "error", 0)]
    assert mgr.latest() == 16
    assert reg.snapshot()["zoo_ckpt_save_failures_total"]["value"] == 1


def test_flipped_byte_fails_crc_and_quarantines(tmp_path):
    reg = MetricsRegistry()
    mgr = CheckpointManager(str(tmp_path), keep=0, registry=reg)
    mgr.save(8, {"params": _tree(seed=1)}, sync=True)
    mgr.save(16, {"params": _tree(seed=2)}, sync=True)
    _flip_byte(str(tmp_path / "ckpt-16" / "params.npz"))
    status, reason = mgr.verify(16)
    assert status == "corrupt" and "CRC32" in reason
    out = mgr.restore_latest({"params": _template()})
    assert out is not None and out[0] == 8
    assert os.path.isdir(str(tmp_path / "ckpt-16.corrupt"))
    snap = reg.snapshot()
    assert snap["zoo_ckpt_corrupt_total"]["value"] == 1
    assert snap["zoo_ckpt_restore_fallback_total"]["value"] == 1


def test_truncated_npz_fails_verification(tmp_path):
    reg = MetricsRegistry()
    mgr = CheckpointManager(str(tmp_path), keep=0, registry=reg)
    mgr.save(8, {"params": _tree(seed=1)}, sync=True)
    mgr.save(16, {"params": _tree(seed=2)}, sync=True)
    p = str(tmp_path / "ckpt-16" / "params.npz")
    data = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(data[:len(data) // 2])
    status, reason = mgr.verify(16)
    assert status == "corrupt" and "truncated" in reason
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(16, {"params": _template()})
    assert os.path.isdir(str(tmp_path / "ckpt-16.corrupt"))
    assert reg.snapshot()["zoo_ckpt_corrupt_total"]["value"] == 1


def test_missing_manifest_is_uncommitted_and_falls_back(tmp_path):
    reg = MetricsRegistry()
    mgr = CheckpointManager(str(tmp_path), keep=0, registry=reg)
    mgr.save(8, {"params": _tree(seed=1)}, sync=True)
    mgr.save(16, {"params": _tree(seed=2)}, sync=True)
    os.remove(str(tmp_path / "ckpt-16" / "manifest.json"))
    out = mgr.restore_latest({"params": _template()})
    assert out is not None and out[0] == 8
    assert os.path.isdir(str(tmp_path / "ckpt-16.corrupt"))
    snap = reg.snapshot()
    assert snap["zoo_ckpt_corrupt_total"]["value"] == 1
    assert snap["zoo_ckpt_restore_fallback_total"]["value"] == 1


def test_legacy_snapshot_without_manifest_restores_with_warning(tmp_path,
                                                                caplog):
    import logging
    reg = MetricsRegistry()
    d = tmp_path / "ckpt-12"
    d.mkdir()
    tree = _tree(seed=4)
    leaves = jax.tree_util.tree_leaves(tree)
    assert all(a is b for a, b in zip(leaves, tree_leaves(tree)))
    np.savez(str(d / "params.npz"),
             **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    with open(str(d / "meta.json"), "w") as f:
        json.dump({"step": 12, "epoch": 3}, f)
    mgr = CheckpointManager(str(tmp_path), keep=0, registry=reg)
    assert mgr.verify(12) == ("legacy", None)
    with caplog.at_level(logging.WARNING,
                         logger="analytics_zoo_tpu_torch.checkpoint"):
        out = mgr.restore_latest({"params": _template()})
    assert out is not None
    step, trees, meta = out
    assert step == 12 and meta["epoch"] == 3
    np.testing.assert_array_equal(trees["params"]["w"], tree["w"])
    assert any("WITHOUT checksum verification" in r.message
               for r in caplog.records)
    assert reg.snapshot()["zoo_ckpt_corrupt_total"]["value"] == 0


def test_architecture_mismatch_is_not_corruption(tmp_path):
    reg = MetricsRegistry()
    mgr = CheckpointManager(str(tmp_path), keep=0, registry=reg)
    mgr.save(8, {"params": _tree()}, sync=True)
    with pytest.raises(ValueError, match="architecture mismatch"):
        mgr.restore_latest({"params": {"w": np.zeros((9, 9), np.float32)}})
    assert os.path.isdir(str(tmp_path / "ckpt-8"))      # untouched
    assert reg.snapshot()["zoo_ckpt_corrupt_total"]["value"] == 0


def test_read_only_restore_skips_without_quarantining(tmp_path):
    reg = MetricsRegistry()
    mgr = CheckpointManager(str(tmp_path), keep=0, registry=reg)
    mgr.save(8, {"params": _tree(seed=1)}, sync=True)
    d = tmp_path / "ckpt-16"
    d.mkdir()
    np.savez(str(d / "params.npz"), leaf_0=np.ones(3, np.float32))
    out = mgr.restore_latest({"params": _template()}, quarantine=False)
    assert out is not None and out[0] == 8
    assert os.path.isdir(str(d))
    assert not os.path.exists(str(tmp_path / "ckpt-16.corrupt"))
    snap = reg.snapshot()
    assert snap["zoo_ckpt_corrupt_total"]["value"] == 0
    assert snap["zoo_ckpt_restore_fallback_total"]["value"] == 1


def test_manifest_records_mesh_metadata_and_restore_surfaces_it(tmp_path):
    """A fit's snapshots carry the JAX package's one-device mesh block
    (the JAX loop's on a one-device mesh), surfaced through the restore
    meta."""
    from analytics_zoo_tpu.parallel import mesh as mesh_lib
    assert MESH_ONE_DEVICE == mesh_lib.mesh_metadata(
        mesh_lib.create_mesh(devices=jax.devices()[:1]))
    pctx.init_zoo_context()
    x, y = _data(n=64)
    m = _model()
    m.set_checkpoint(str(tmp_path))
    m.fit(x, y, batch_size=32, nb_epoch=1)
    mgr = CheckpointManager(str(tmp_path), keep=0, registry=MetricsRegistry())
    assert mgr.verify(2)[0] == "ok"
    assert _manifest(str(tmp_path / "ckpt-2"))["mesh"] == MESH_ONE_DEVICE
    trees = {"params": {"d0": {"W": np.zeros((4, 8), np.float32),
                               "b": np.zeros(8, np.float32)},
                        "d1": {"W": np.zeros((8, 1), np.float32),
                               "b": np.zeros(1, np.float32)}}}
    out = mgr.restore_latest(trees)
    assert out is not None
    _step, _trees, meta = out
    assert meta["mesh"] == MESH_ONE_DEVICE and meta["epoch"] == 1
    assert meta["epoch_finished"] is True and meta["iteration"] == 2


def test_corrupt_mesh_metadata_falls_back_like_any_corruption(tmp_path):
    reg = MetricsRegistry()
    mgr = CheckpointManager(str(tmp_path), keep=0, registry=reg)
    mgr.save(8, {"params": _tree(seed=1)}, sync=True, mesh=MESH_ONE_DEVICE)
    mgr.save(16, {"params": _tree(seed=2)}, sync=True, mesh=MESH_ONE_DEVICE)
    man = str(tmp_path / "ckpt-16" / "manifest.json")
    manifest = _manifest(str(tmp_path / "ckpt-16"))
    manifest["mesh"] = {"axes": "garbage"}
    with open(man, "w") as f:
        json.dump(manifest, f)
    status, reason = mgr.verify(16)
    assert status == "corrupt" and "mesh metadata" in reason
    out = mgr.restore_latest({"params": _template()})
    assert out is not None and out[0] == 8
    assert os.path.isdir(str(tmp_path / "ckpt-16.corrupt"))
    assert reg.snapshot()["zoo_ckpt_corrupt_total"]["value"] == 1


def test_malformed_manifest_schema_is_corrupt_not_a_crash(tmp_path):
    reg = MetricsRegistry()
    mgr = CheckpointManager(str(tmp_path), keep=0, registry=reg)
    mgr.save(8, {"params": _tree(seed=1)}, sync=True)
    mgr.save(16, {"params": _tree(seed=2)}, sync=True)
    man = str(tmp_path / "ckpt-16" / "manifest.json")
    with open(man, "w") as f:
        json.dump({"version": 1, "step": 16, "meta": {"step": 16},
                   "trees": {"params": {"nope": True}}}, f)
    status, reason = mgr.verify(16)
    assert status == "corrupt" and "malformed" in reason
    by_name = {e["name"]: e for e in mgr.survey(verify=True)}
    assert by_name["ckpt-16"]["status"] == "corrupt"
    out = mgr.restore_latest({"params": _template()})
    assert out is not None and out[0] == 8
    assert reg.snapshot()["zoo_ckpt_corrupt_total"]["value"] == 1


# ---------------------------------------------------------------------------
# fit-level scenarios: resume through the training loop
# ---------------------------------------------------------------------------

def _fit_control(tmp_path, nb_epoch=3):
    pctx.init_zoo_context(faults_enabled=True)
    x, y = _data()
    m = _model()
    m.set_checkpoint(str(tmp_path / "control"), keep=None)
    h = m.fit(x, y, batch_size=32, nb_epoch=nb_epoch)
    return x, y, m, h


@pytest.mark.parametrize("corruption", ["flip", "truncate", "rm_manifest"])
def test_resume_after_corruption_matches_uninterrupted_run(tmp_path,
                                                           corruption):
    x, y, control, h_control = _fit_control(tmp_path, nb_epoch=3)
    m = _model()
    m.set_checkpoint(str(tmp_path / "ckpt"))
    m.fit(x, y, batch_size=32, nb_epoch=2)      # snapshots at steps 8, 16
    newest = str(tmp_path / "ckpt" / "ckpt-16")
    if corruption == "flip":
        _flip_byte(os.path.join(newest, "params.npz"))
    elif corruption == "truncate":
        p = os.path.join(newest, "opt_state.npz")
        data = open(p, "rb").read()
        with open(p, "wb") as f:
            f.write(data[: len(data) // 3])
    else:
        os.remove(os.path.join(newest, "manifest.json"))
    before = _counters("zoo_ckpt_corrupt_total",
                       "zoo_ckpt_restore_fallback_total")
    m2 = _model()
    m2.set_checkpoint(str(tmp_path / "ckpt"))
    h = m2.fit(x, y, batch_size=32, nb_epoch=2)  # resumes epoch 1 → 2, 3
    after = _counters("zoo_ckpt_corrupt_total",
                      "zoo_ckpt_restore_fallback_total")
    assert m2.finished_epochs == 3
    assert os.path.isdir(newest + ".corrupt")
    assert after["zoo_ckpt_corrupt_total"] \
        - before["zoo_ckpt_corrupt_total"] == 1
    assert after["zoo_ckpt_restore_fallback_total"] \
        - before["zoo_ckpt_restore_fallback_total"] == 1
    np.testing.assert_allclose(h["loss"], h_control["loss"][1:3],
                               rtol=1e-5, atol=1e-7)
    for name, a in _params(control).items():
        np.testing.assert_array_equal(_params(m2)[name], a)


def test_fit_retry_resumes_past_save_killed_mid_write(tmp_path):
    x, y, _, h_control = _fit_control(tmp_path, nb_epoch=3)
    m = _model()
    m.set_checkpoint(str(tmp_path / "ckpt"))
    m.fit(x, y, batch_size=32, nb_epoch=1)      # clean ckpt-8
    before = _counters("zoo_ckpt_corrupt_total",
                       "zoo_ckpt_save_failures_total")
    plan = FaultPlan(seed=11).add("ckpt.write", "error", at=(0,))
    with faults.activate(plan):
        h = m.fit(x, y, batch_size=32, nb_epoch=2)
    after = _counters("zoo_ckpt_corrupt_total",
                      "zoo_ckpt_save_failures_total")
    assert plan.fired == [("ckpt.write", "error", 0)]
    assert after["zoo_ckpt_save_failures_total"] \
        - before["zoo_ckpt_save_failures_total"] == 1
    assert after["zoo_ckpt_corrupt_total"] \
        - before["zoo_ckpt_corrupt_total"] == 1
    assert m.finished_epochs == 3
    assert os.path.isdir(str(tmp_path / "ckpt" / "ckpt-16.corrupt"))
    mgr = CheckpointManager(str(tmp_path / "ckpt"),
                            registry=MetricsRegistry())
    assert mgr.steps() == [8, 24]
    assert all(mgr.verify(s)[0] == "ok" for s in mgr.steps())
    np.testing.assert_allclose(h["loss"][-1], h_control["loss"][2],
                               rtol=1e-5, atol=1e-7)
    m3 = _model()
    m3.set_checkpoint(str(tmp_path / "ckpt"))
    h3 = m3.fit(x, y, batch_size=32, nb_epoch=1)
    assert m3.finished_epochs == 4 and len(h3["loss"]) == 1


class _OnceAt(Trigger):
    def __init__(self, iteration):
        self.iteration = iteration

    def __call__(self, state):
        return state.iteration == self.iteration


def test_async_save_is_off_the_step_path(tmp_path):
    pctx.init_zoo_context(faults_enabled=True)
    x, y = _data()
    m = _model()
    m.set_checkpoint(str(tmp_path / "ckpt"), trigger=_OnceAt(4))
    before = _counters("zoo_ckpt_save_seconds")
    plan = FaultPlan(seed=2).add("ckpt.write", "latency", at=(0,),
                                 delay_s=0.6)
    observed = []

    def spy(record):
        mgr = m._loop._active_ckpt_mgr
        observed.append((record["iteration"], mgr.save_in_flight()))

    with faults.activate(plan):
        m.fit(x, y, batch_size=32, nb_epoch=2, callbacks=[spy])
    assert plan.fired == [("ckpt.write", "latency", 0)]
    assert observed[0][0] == 8 and observed[0][1] is True, observed
    mgr = CheckpointManager(str(tmp_path / "ckpt"),
                            registry=MetricsRegistry())
    assert mgr.steps() == [4] and mgr.verify(4)[0] == "ok"
    after = _counters("zoo_ckpt_save_seconds")
    assert after["zoo_ckpt_save_seconds"] \
        - before["zoo_ckpt_save_seconds"] == 1


# ---------------------------------------------------------------------------
# preemption-safe shutdown (zoo.checkpoint.on_sigterm)
# ---------------------------------------------------------------------------

def test_sigterm_cuts_final_checkpoint_and_exits_cleanly(tmp_path):
    pctx.init_zoo_context(checkpoint_on_sigterm=True)
    x, y = _data()
    m = _model()
    m.set_checkpoint(str(tmp_path / "ckpt"))

    def cb(record):
        if record["epoch"] == 1:    # end of epoch 1 (iteration 8)
            os.kill(os.getpid(), signal.SIGTERM)

    prev = signal.getsignal(signal.SIGTERM)
    with pytest.raises(TrainingPreempted):
        m.fit(x, y, batch_size=32, nb_epoch=5, callbacks=[cb])
    assert signal.getsignal(signal.SIGTERM) is prev
    mgr = CheckpointManager(str(tmp_path / "ckpt"),
                            registry=MetricsRegistry())
    assert mgr.latest() == 9
    assert mgr.verify(9)[0] == "ok"
    assert m.finished_iterations == 9
    m2 = _model()
    m2.set_checkpoint(str(tmp_path / "ckpt"))
    h = m2.fit(x, y, batch_size=32, nb_epoch=1)
    assert m2.finished_epochs == 2 and len(h["loss"]) == 1
    assert np.isfinite(h["loss"][0])


def test_sigterm_grace_budget_cuts_mid_epoch_immediately(tmp_path):
    pctx.init_zoo_context(checkpoint_on_sigterm=True,
                          checkpoint_sigterm_grace_s=0.05)
    assert pctx.get_zoo_context().get(
        "zoo.checkpoint.sigterm_grace_s") == 0.05
    x, y = _data(n=64)                    # 2 steps/epoch at batch 32
    m = _model()
    m.set_checkpoint(str(tmp_path / "ckpt"))
    m.fit(x, y, batch_size=32, nb_epoch=1)  # ckpt-2
    loop = m._loop
    orig = loop.train_step
    calls = []

    def slow_step(*args):
        calls.append(1)
        if len(calls) == 2:
            threading.Timer(
                0.05, lambda: os.kill(os.getpid(), signal.SIGTERM)).start()
            time.sleep(30.0)
            pytest.fail("SIGTERM handler did not preempt the slow step")
        time.sleep(0.5)                  # teach the estimate a slow step
        return orig(*args)

    loop.train_step = slow_step
    t0 = time.monotonic()
    with pytest.raises(TrainingPreempted, match="grace budget"):
        m.fit(x, y, batch_size=32, nb_epoch=1)
    assert time.monotonic() - t0 < 10.0
    mgr = CheckpointManager(str(tmp_path / "ckpt"),
                            registry=MetricsRegistry())
    assert mgr.latest() == 3
    assert mgr.verify(3)[0] == "ok"
    assert m.finished_iterations == 3
    loop.train_step = orig
    m2 = _model()
    m2.set_checkpoint(str(tmp_path / "ckpt"))
    h = m2.fit(x, y, batch_size=32, nb_epoch=1)
    assert np.isfinite(h["loss"][0])


def test_sigterm_flag_off_keeps_default_behavior(tmp_path):
    pctx.init_zoo_context(checkpoint_on_sigterm=False)
    x, y = _data()
    m = _model()
    m.set_checkpoint(str(tmp_path / "ckpt"))
    seen = []
    m.fit(x, y, batch_size=32, nb_epoch=1,
          callbacks=[lambda r: seen.append(signal.getsignal(signal.SIGTERM))])
    assert seen == [signal.getsignal(signal.SIGTERM)]


# ---------------------------------------------------------------------------
# snapshots across the two packages
# ---------------------------------------------------------------------------

BERT_CFG = dict(vocab=99, hidden_size=64, n_block=2, n_head=4, seq_len=16,
                intermediate_size=128, hidden_drop=0.0, attn_drop=0.0)
NCF_CFG = dict(user_embed=8, item_embed=8, hidden_layers=(16,),
               include_mf=True)
KEY_BIAS_TOL = 2 * 8 * 1e-3


def _bert_data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, BERT_CFG["vocab"],
                       (n, BERT_CFG["seq_len"])).astype(np.int32)
    lens = rng.integers(5, BERT_CFG["seq_len"] + 1, n)
    ids[np.arange(BERT_CFG["seq_len"])[None, :] >= lens[:, None]] = 0
    y = rng.integers(0, 3, n).astype(np.int32)
    return make_bert_inputs(ids, attention_mask=(ids != 0)), y


def _ncf_data(n=96, users=63, items=127, seed=3):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(1, users + 1, n),
                  rng.integers(1, items + 1, n)], axis=1).astype(np.int32)
    return x, ((x[:, 0] + x[:, 1]) % 5).astype(np.int32)


def _pair(kind, opt, seed):
    """A JAX model and the port's, each with its own fresh weights (the
    resume must overwrite them), compiled alike; and data."""
    conf = {"zoo.pallas.attention": True, "zoo.seed": 0}
    jctx.init_zoo_context(conf=conf)
    pctx.init_zoo_context(conf=conf)
    kw = dict(lr=1e-3)
    if kind == "bert":
        jm = JBERTClassifier(3, **BERT_CFG)
        pm = BERTClassifier(3, **BERT_CFG, device="cpu")
        data, loss = _bert_data(), "scce"
    else:
        jm = JNeuralCF(63, 127, 5, **NCF_CFG)
        pm = NeuralCF(63, 127, 5, **NCF_CFG, device="cpu")
        data, loss = _ncf_data(), "scce"
    jm.init_weights(rng=jax.random.key(seed))
    pm.init_weights(torch.Generator().manual_seed(seed))
    jm.compile(optimizer=opt, loss=loss, **kw)
    pm.compile(optimizer=opt, loss=loss, **kw)
    return jm, pm, data


def _jax_flat(jm):
    return peng.flatten_tree(jax.tree.map(np.asarray, jm.params))


def _port_flat(pm):
    return {n.replace(".", "/"): p.detach().numpy().copy()
            for n, p in pm.model.named_parameters()}


def _assert_fit_close(got, want, steps, lr=1e-3):
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = got[name], want[name]
        if name.endswith("qkv/b"):
            h = w.shape[-1] // 3
            np.testing.assert_allclose(g[h:2 * h], w[h:2 * h],
                                       atol=2 * steps * lr, rtol=0,
                                       err_msg=name)
            g = np.concatenate([g[:h], g[2 * h:]])
            w = np.concatenate([w[:h], w[2 * h:]])
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("kind,opt", [("bert", "adamw"), ("bert", "sgd"),
                                      ("ncf", "adam")])
def test_a_jax_snapshot_resumes_in_the_port(tmp_path, kind, opt):
    """The JAX package trains an epoch with ``set_checkpoint``; a port
    model (other weights) on a copy of the directory resumes from its
    snapshot — the parameters the JAX snapshot's bits, the optimizer
    count JAX's — and the port's next epoch matches the JAX model's
    resumed on the other copy."""
    jm, pm, (x, y) = _pair(kind, opt, 11)
    bs = 8 if kind == "bert" else 16
    steps = len(y) // bs
    jm.set_checkpoint(str(tmp_path / "a"))
    jm.fit(x, y, batch_size=bs, nb_epoch=1)
    shutil.copytree(str(tmp_path / "a"), str(tmp_path / "b"))
    snapshot = _jax_flat(jm)
    pm.set_checkpoint(str(tmp_path / "a"))
    pm.fit(x, y, batch_size=bs, nb_epoch=0)              # resume only
    assert pm.finished_epochs == 1 and pm.finished_iterations == steps
    for name, a in _port_flat(pm).items():
        np.testing.assert_array_equal(a, snapshot[name], err_msg=name)
    assert pm.opt_state["count"] == steps
    if opt != "sgd":
        mu = pm.opt_state["state"][0]["mu"]
        jmu = jm.opt_state[0].mu
        names = [n for n, _ in pm.named_parameters()]
        jflat = peng.flatten_tree(jax.tree.map(np.asarray, jmu))
        for n, t in zip(names, mu):
            np.testing.assert_array_equal(
                t.numpy(), jflat[n[len("model."):].replace(".", "/")])

    jm2, _, _ = _pair(kind, opt, 12)
    jm2.set_checkpoint(str(tmp_path / "b"))
    hj = jm2.fit(x, y, batch_size=bs, nb_epoch=1)
    hp = pm.fit(x, y, batch_size=bs, nb_epoch=1)
    assert pm.finished_epochs == jm2.finished_epochs == 2
    np.testing.assert_allclose(hp["loss"], hj["loss"], atol=1e-5, rtol=0)
    _assert_fit_close(_port_flat(pm), _jax_flat(jm2), steps)


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_a_port_snapshot_restores_in_the_jax_package(tmp_path, opt):
    """A port fit's snapshot restores in the JAX manager against the JAX
    model's own templates, leaf for leaf and bit for bit (params, the
    optimizer state in optax's order, the empty net state), and a JAX
    model resumed from it continues as the port does."""
    jm, pm, (x, y) = _pair("bert", opt, 11)
    pm.set_checkpoint(str(tmp_path / "p"))
    pm.fit(x, y, batch_size=8, nb_epoch=1)
    jm.fit(x, y, batch_size=8, nb_epoch=0)        # builds the JAX state
    opt_template = jm._loop.optimizer.init(jm.params)
    mgr = JCheckpointManager(str(tmp_path / "p"), registry=JRegistry())
    step, trees, meta = mgr.restore_latest(
        {"params": jm.params, "opt_state": opt_template,
         "net_state": jm.net_state})
    assert step == 4 and meta["epoch"] == 1 and meta["epoch_finished"]
    for name, a in _port_flat(pm).items():
        np.testing.assert_array_equal(
            a, peng.flatten_tree(jax.tree.map(np.asarray,
                                              trees["params"]))[name])
    leaves = jax.tree_util.tree_leaves(trees["opt_state"])
    assert len(leaves) == len(jax.tree_util.tree_leaves(opt_template))
    if opt == "adamw":
        assert int(leaves[0]) == 4
        names = sorted((n[len("model."):] for n, _ in
                        pm.named_parameters()), key=lambda n: n.split("."))
        by_name = dict(pm.named_parameters())
        mu = dict(zip([n for n, _ in pm.named_parameters()],
                      pm.opt_state["state"][0]["mu"]))
        for n, leaf in zip(names, leaves[1:1 + len(names)]):
            np.testing.assert_array_equal(np.asarray(leaf),
                                          mu["model." + n].numpy())
        assert set(by_name) == {"model." + n for n in names}

    jm2, _, _ = _pair("bert", opt, 12)
    jm2.set_checkpoint(str(tmp_path / "p"))
    hj = jm2.fit(x, y, batch_size=8, nb_epoch=1)
    pm.set_checkpoint(str(tmp_path / "q"))
    hp = pm.fit(x, y, batch_size=8, nb_epoch=1)
    np.testing.assert_allclose(hp["loss"], hj["loss"], atol=1e-5, rtol=0)
    _assert_fit_close(_port_flat(pm), _jax_flat(jm2), 4)


def _multi_pair(seed):
    """``Dense(8, relu) -> Dense(1)`` named d0/d1 in both packages, each
    with its own weights, under ``multi_optimizer({"d0": sgd with
    momentum}, "adam")``."""
    import optax
    from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
    from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as popt
    jctx.init_zoo_context(conf={"zoo.seed": 0})
    pctx.init_zoo_context(conf={"zoo.seed": 0})
    jm = JSequential([jl.Dense(8, activation="relu", input_shape=(4,),
                               name="d0"), jl.Dense(1, name="d1")])
    jm.init_weights(rng=jax.random.key(seed))
    jm.compile(optimizer=jopt.multi_optimizer(
        {"d0": optax.sgd(0.05, momentum=0.9)}, "adam"), loss="mse")
    pm = Sequential([pl.Dense(8, activation="relu", input_shape=(4,),
                              name="d0"), pl.Dense(1, name="d1")],
                    device="cpu")
    pm.init_weights(torch.Generator().manual_seed(seed))
    pm.compile(optimizer=multi_optimizer(
        {"d0": popt.sgd(0.05, momentum=0.9)}, "adam"), loss="mse")
    return jm, pm


def _port_opt_leaves(pm):
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import \
        optax_leaves
    names = [n for n, _ in pm.named_parameters()]
    return [np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor)
                       else t)
            for t in optax_leaves(pm._loop.optimizer,
                                  pm.opt_state["state"],
                                  pm.opt_state["count"], names)]


def test_multi_optimizer_snapshot_resumes_across_packages(tmp_path):
    """``multi_optimizer``'s state checkpoints in
    ``optax.multi_transform``'s leaf order (the order taken from
    ``jax.tree_util.tree_flatten`` of the JAX state): a JAX snapshot
    resumes in the port with the same leaves, bit for bit; the port's next
    snapshot restores in the JAX manager against the JAX state's template
    with the port's leaves; the port's next epoch matches the JAX model
    resumed on a copy of the first snapshot."""
    x, y = _data()
    jm, pm = _multi_pair(3)
    jm.set_checkpoint(str(tmp_path / "a"))
    jm.fit(x, y, batch_size=32, nb_epoch=1)
    shutil.copytree(str(tmp_path / "a"), str(tmp_path / "b"))
    meta = _manifest(str(tmp_path / "a" / "ckpt-8"))["meta"]
    assert "opt_state_order" not in meta
    pm.set_checkpoint(str(tmp_path / "a"))
    pm.fit(x, y, batch_size=32, nb_epoch=0)                # resume only
    assert pm.opt_state["count"] == 8
    for name, a in _params(pm).items():
        np.testing.assert_array_equal(
            a, peng.flatten_tree(jax.tree.map(np.asarray, jm.params))[
                name.replace(".", "/")])
    want = [np.asarray(l) for l in jax.tree_util.tree_leaves(jm.opt_state)]
    got = _port_opt_leaves(pm)
    assert [a.shape for a in got] == [a.shape for a in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)

    hp = pm.fit(x, y, batch_size=32, nb_epoch=1)
    assert "opt_state_order" not in _manifest(
        str(tmp_path / "a" / "ckpt-16"))["meta"]
    jm2, _ = _multi_pair(4)
    jm2.set_checkpoint(str(tmp_path / "b"))
    hj = jm2.fit(x, y, batch_size=32, nb_epoch=1)
    np.testing.assert_allclose(hp["loss"], hj["loss"], atol=1e-5, rtol=0)
    mgr = JCheckpointManager(str(tmp_path / "a"), registry=JRegistry())
    step, trees, _ = mgr.restore_latest(
        {"params": jm2.params,
         "opt_state": jm2._loop.optimizer.init(jm2.params),
         "net_state": jm2.net_state})
    assert step == 16
    for a, b in zip(_port_opt_leaves(pm),
                    jax.tree_util.tree_leaves(trees["opt_state"])):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(_port_opt_leaves(pm),
                    jax.tree_util.tree_leaves(jm2.opt_state)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)


def test_an_optimizer_without_slots_restores_only_in_the_port(tmp_path):
    """A transform without an optax layout (``slots=None``) writes the
    port's own order, says so in the manifest's meta, restores in the
    port, and refuses a snapshot in optax's order and the other way round
    (CheckpointArchitectureError — never a scrambled state)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as popt
    pctx.init_zoo_context()
    x, y = _data()

    def slotless():
        return popt.GradientTransformation(*popt.adam(0.05)[:3], None)

    def build(opt):
        m = Sequential([pl.Dense(8, activation="relu", input_shape=(4,),
                                 name="d0"), pl.Dense(1, name="d1")],
                       device="cpu")
        m.init_weights(torch.Generator().manual_seed(0))
        m.compile(optimizer=opt, loss="mse")
        return m

    m = build(slotless())
    m.set_checkpoint(str(tmp_path / "own"))
    m.fit(x, y, batch_size=32, nb_epoch=1)
    meta = _manifest(str(tmp_path / "own" / "ckpt-8"))["meta"]
    assert meta["opt_state_order"] == "analytics_zoo_tpu_torch"
    m2 = build(slotless())
    m2.set_checkpoint(str(tmp_path / "own"))
    m2.fit(x, y, batch_size=32, nb_epoch=0)
    for name, a in _params(m).items():
        np.testing.assert_array_equal(_params(m2)[name], a)
    assert m2.opt_state["count"] == 8
    adam = build("adam")
    adam.set_checkpoint(str(tmp_path / "adam"))
    adam.fit(x, y, batch_size=32, nb_epoch=1)
    m3 = build(slotless())
    m3.set_checkpoint(str(tmp_path / "adam"))
    with pytest.raises(CheckpointArchitectureError):
        m3.fit(x, y, batch_size=32, nb_epoch=1)
    m4 = build("adam")
    m4.set_checkpoint(str(tmp_path / "own"))
    with pytest.raises(CheckpointArchitectureError):
        m4.fit(x, y, batch_size=32, nb_epoch=1)


def test_load_checkpoint_serves_the_newest_valid_snapshot(tmp_path):
    """``InferenceModel.load_checkpoint`` restores params READ-ONLY (an
    uncommitted newer snapshot is skipped, not quarantined) and answers
    as the trained model does — from a port snapshot and a JAX one."""
    jm, pm, (x, y) = _pair("bert", "adamw", 11)
    pm.set_checkpoint(str(tmp_path / "p"))
    pm.fit(x, y, batch_size=8, nb_epoch=1)
    os.makedirs(str(tmp_path / "p" / "ckpt-99"))      # a save in flight
    fresh = BERTClassifier(3, **BERT_CFG, device="cpu").init_weights(
        torch.Generator().manual_seed(5))
    im = InferenceModel(device="cpu").load_checkpoint(fresh,
                                                      str(tmp_path / "p"))
    np.testing.assert_allclose(im.predict(x), pm.predict(x), atol=1e-6)
    assert os.path.isdir(str(tmp_path / "p" / "ckpt-99"))
    jm.set_checkpoint(str(tmp_path / "j"))
    jm.fit(x, y, batch_size=8, nb_epoch=1)
    fresh = BERTClassifier(3, **BERT_CFG, device="cpu").init_weights(
        torch.Generator().manual_seed(6))
    im = InferenceModel(device="cpu").load_checkpoint(fresh,
                                                      str(tmp_path / "j"))
    np.testing.assert_allclose(im.predict(x), np.asarray(jm.predict(x)),
                               atol=1e-5)
    with pytest.raises(FileNotFoundError):
        InferenceModel(device="cpu").load_checkpoint(
            fresh, str(tmp_path / "empty"))


# ---------------------------------------------------------------------------
# triggers on the fit: end_trigger, and the device-cached path's rules
# ---------------------------------------------------------------------------

def _jax_model():
    m = JSequential([jl.Dense(8, activation="relu", input_shape=(4,),
                              name="d0"), jl.Dense(1, name="d1")])
    m.init_weights(rng=jax.random.key(0))
    m.compile(optimizer="adam", loss="mse", lr=0.05)
    return m


def _port_like(jm):
    m = Sequential([pl.Dense(8, activation="relu", input_shape=(4,),
                             name="d0"), pl.Dense(1, name="d1")],
                   device="cpu")
    m.load_jax_params(jax.tree.map(np.asarray, jm.params))
    m.compile(optimizer="adam", loss="mse", lr=0.05)
    return m


def test_end_trigger_stops_mid_epoch_and_snapshots_as_jax(tmp_path):
    """``fit(end_trigger=MaxIteration(12))`` stops in epoch 2 at iteration
    12 in both packages: the truncated epoch's snapshot (``epoch_finished``
    false), the same history length, finished counts and parameters."""
    from analytics_zoo_tpu.common import triggers as jtriggers
    from analytics_zoo_tpu_torch.common import triggers as ptriggers
    jctx.init_zoo_context()
    pctx.init_zoo_context()
    x, y = _data()
    jm = _jax_model()
    pm = _port_like(jm)
    jm.set_checkpoint(str(tmp_path / "jax"))
    pm.set_checkpoint(str(tmp_path / "port"))
    hj = jm.fit(x, y, batch_size=32, nb_epoch=5,
                end_trigger=jtriggers.MaxIteration(12))
    hp = pm.fit(x, y, batch_size=32, nb_epoch=5,
                end_trigger=ptriggers.MaxIteration(12))
    assert len(hp["loss"]) == len(hj["loss"]) == 2
    assert (pm.finished_epochs, pm.finished_iterations) \
        == (jm.finished_epochs, jm.finished_iterations) == (1, 12)
    np.testing.assert_allclose(hp["loss"], hj["loss"], rtol=1e-5)
    for name in ("port", "jax"):
        meta = _manifest(str(tmp_path / name / "ckpt-12"))["meta"]
        assert meta["epoch"] == 2 and meta["epoch_finished"] is False
    want = _jax_flat(jm)
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[n.replace(".", "/")], rtol=1e-5,
                                   atol=1e-5)


def test_device_cache_observes_iteration_triggers_at_epoch_ends(tmp_path,
                                                               caplog):
    """Under ``device_cache`` (with ``fuse_epochs`` 2, which a checkpoint
    manager turns off) a ``SeveralIteration(4)`` trigger is observed at
    epoch boundaries, with the JAX warning: snapshots at 8 and 16, as the
    JAX loop cuts them."""
    import logging
    conf = {"zoo.train.device_cache": True, "zoo.train.fuse_epochs": 2}
    jctx.init_zoo_context(conf=conf)
    pctx.init_zoo_context(conf=conf)
    x, y = _data()
    jm = _jax_model()
    pm = _port_like(jm)
    from analytics_zoo_tpu.common import triggers as jtriggers
    jm.set_checkpoint(str(tmp_path / "jax"),
                      trigger=jtriggers.SeveralIteration(4), keep=0)
    pm.set_checkpoint(str(tmp_path / "port"), trigger=SeveralIteration(4),
                      keep=0)
    jm.fit(x, y, batch_size=32, nb_epoch=2)
    with caplog.at_level(logging.WARNING, logger="analytics_zoo_tpu_torch"):
        pm.fit(x, y, batch_size=32, nb_epoch=2)
    assert any("only observed at epoch boundaries" in r.message
               for r in caplog.records)
    for name in ("jax", "port"):
        mgr = CheckpointManager(str(tmp_path / name),
                                registry=MetricsRegistry())
        assert mgr.steps() == [8, 16], name
