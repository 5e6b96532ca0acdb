"""The port's data path held to the JAX package on the same numpy-seeded
inputs: the FeatureSet family (batch order bit for bit, ``transform``,
``infinite_batches``, ``sample``, ``from_iterable``), the prefetch
pipeline (the stream kept, errors passed on, its thread released, the
goodput notes), the native IO reader and ``DiskFeatureSet`` (slices,
rotation, full-pass triggers, a fit against the JAX fit and against the
in-RAM fit over the same slices), ``BucketedFeatureSet``'s interleave, and
the out-of-core embedding cache (plan, rows and counters bit for bit, the
gradient at the JAX tests' ``GTOL``, the fault drills).

Tolerances, each with its reason:
* fits against JAX (``LOSS_RTOL``, ``FIT_RTOL``/``FIT_ATOL``, the
  dispatch tests'): the same f32 arithmetic in other summation orders,
  amplified by Adam over a dozen steps;
* the port's disk fit against its in-RAM fit over the same slices: the
  same bits (the same batches through the same steps);
* the oocore gradient: ``GTOL`` (JAX ``test_sharded_embedding.py``), the
  scatter-add's summation order; rows and counters exact.
Batch sizes are multiples of 8 (the JAX side runs on conftest's 8-device
CPU mesh).
"""

import itertools
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.common import faults as jfaults
from analytics_zoo_tpu.common.triggers import EveryEpoch as JaxEveryEpoch
from analytics_zoo_tpu.common.triggers import MaxEpoch as JaxMaxEpoch
from analytics_zoo_tpu.feature import feature_set as jfs
from analytics_zoo_tpu.native import NativeArrayFile as JaxNativeArrayFile
from analytics_zoo_tpu.observability import MetricsRegistry as JaxRegistry
from analytics_zoo_tpu.ops import sharded_embedding as jse
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JaxSequential
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.utils.checkpoint import \
    CheckpointManager as JaxCheckpointManager
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.common import faults as pfaults
from analytics_zoo_tpu_torch.common.triggers import EveryEpoch, MaxEpoch
from analytics_zoo_tpu_torch.feature import (FeatureLabelPreprocessing,
                                             FnPreprocessing, Normalize)
from analytics_zoo_tpu_torch.feature import feature_set as pfs
from analytics_zoo_tpu_torch.native import _loader as ploader
from analytics_zoo_tpu_torch.native import (NativeArrayFile,
                                            native_io_available)
from analytics_zoo_tpu_torch.observability import MetricsRegistry
from analytics_zoo_tpu_torch.observability.goodput import GoodputLedger
from analytics_zoo_tpu_torch.ops import sharded_embedding as pse
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as pl
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
from analytics_zoo_tpu_torch.utils.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5
GTOL = dict(rtol=1e-6, atol=1e-5)


@pytest.fixture(autouse=True)
def contexts():
    pctx.reset_zoo_context()
    peng.reset_uids()
    jeng.reset_uids()
    yield
    pctx.reset_zoo_context()
    jctx.reset_zoo_context()


def _both_contexts(conf=None, **kw):
    conf = {"zoo.seed": 0, **(conf or {})}
    jctx.init_zoo_context(conf=conf, **kw)
    pctx.init_zoo_context(conf=conf, **kw)


def _data(n=64, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(n, 1)).astype(np.float32))


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# FeatureSet (tests/test_feature_set.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_batch_order_matches_jax(shuffle, drop_last):
    x, y = _data(n=40)
    for epoch in (0, 1, 7):
        _assert_batches_equal(
            pfs.FeatureSet.array(x, y, shuffle=shuffle, seed=7).iter_batches(
                16, epoch=epoch, drop_last=drop_last),
            jfs.FeatureSet.array(x, y, shuffle=shuffle, seed=7).iter_batches(
                16, epoch=epoch, drop_last=drop_last))
    fs = pfs.FeatureSet.array(x, y, shuffle=shuffle, seed=7)
    assert fs.steps_per_epoch(16, drop_last) == \
        jfs.FeatureSet.array(x, y).steps_per_epoch(16, drop_last)


def test_multi_input_batches_and_infinite_loop_match_jax():
    rng = np.random.default_rng(0)
    xa = rng.normal(size=(32, 2)).astype(np.float32)
    xb = rng.integers(0, 9, size=(32, 5)).astype(np.int32)
    y = rng.integers(0, 3, 32).astype(np.int32)
    port = pfs.FeatureSet.array([xa, xb], y, seed=3)
    jax_ = jfs.FeatureSet.array([xa, xb], y, seed=3)
    _assert_batches_equal(itertools.islice(port.infinite_batches(8), 9),
                          itertools.islice(jax_.infinite_batches(8), 9))
    _assert_batches_equal(
        itertools.islice(port.infinite_batches(16, start_epoch=4), 5),
        itertools.islice(jax_.infinite_batches(16, start_epoch=4), 5))


def test_transform_preprocessing_chain_matches_jax():
    x, y = _data()
    from analytics_zoo_tpu.feature import (
        FeatureLabelPreprocessing as JFLP, FnPreprocessing as JFn,
        Normalize as JNorm)
    pre = FeatureLabelPreprocessing(
        Normalize(mean=x.mean(0), std=x.std(0) + 1e-6)
        >> FnPreprocessing(lambda a: a * 2.0))
    jpre = JFLP(JNorm(mean=x.mean(0), std=x.std(0) + 1e-6)
                >> JFn(lambda a: a * 2.0))
    got = pfs.FeatureSet.array(x, y, seed=2).transform(pre)
    want = jfs.FeatureSet.array(x, y, seed=2).transform(jpre)
    np.testing.assert_array_equal(got.x, np.asarray(want.x))
    np.testing.assert_array_equal(got.y, np.asarray(want.y))
    assert (got.shuffle, got.seed) == (True, 2)
    _assert_batches_equal(got.iter_batches(16, epoch=1),
                          want.iter_batches(16, epoch=1))


def test_from_iterable_and_sample_match_jax():
    rng = np.random.default_rng(4)
    recs = [(rng.normal(size=3).astype(np.float32), np.int32(i % 3))
            for i in range(24)]
    got = pfs.FeatureSet.from_iterable(recs, seed=5)
    want = jfs.FeatureSet.from_iterable(recs, seed=5)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.y, want.y)
    _assert_batches_equal(got.iter_batches(8, epoch=2),
                          want.iter_batches(8, epoch=2))
    np.testing.assert_array_equal(got.sample(5), want.sample(5))
    bare = pfs.FeatureSet.from_iterable([r[0] for r in recs])
    assert bare.y is None and bare.x.shape == (24, 3)


def test_a_tensor_set_stays_a_tensor_and_slices_from_one_host_view():
    x, y = _data(n=32)
    fs = pfs.FeatureSet.array(torch.from_numpy(x), torch.from_numpy(y),
                              seed=1)
    assert isinstance(fs.xs[0], torch.Tensor)
    _assert_batches_equal(fs.iter_batches(8, epoch=3),
                          jfs.FeatureSet.array(x, y, seed=1).iter_batches(
                              8, epoch=3))
    first = fs._host_view()[0][0]
    assert fs._host_view()[0][0] is first       # read back once
    assert isinstance(fs.sample(2), np.ndarray)


# ---------------------------------------------------------------------------
# the prefetch pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("threaded", [True, False])
def test_prefetch_keeps_the_stream_as_jax_does(threaded):
    _both_contexts()
    x, y = _data(n=64)
    fs = pfs.FeatureSet.array(x, y, seed=7)
    got = list(pfs.prefetch_to_device(fs.iter_batches(16, epoch=0), "cpu",
                                      threaded=threaded))
    want = list(jfs.prefetch_to_device(
        jfs.FeatureSet.array(x, y, seed=7).iter_batches(16, epoch=0),
        threaded=threaded))
    assert all(isinstance(a, torch.Tensor) for b in got for a in b)
    _assert_batches_equal(got, [jax.tree.map(np.asarray, b) for b in want])


def test_prefetch_passes_none_and_counts_through():
    items = [(np.ones((8, 2), np.float32), None, 3),
             ([np.zeros((8, 1), np.int32), np.ones((8, 4))], {"m": None}, 8)]
    got = list(pfs.prefetch_to_device(iter(items), "cpu", buffer_size=1))
    assert got[0][1] is None and got[0][2] == 3
    assert isinstance(got[1][0], list) and got[1][1] == {"m": None}
    np.testing.assert_array_equal(got[1][0][1].numpy(), np.ones((8, 4)))


def test_prefetch_passes_errors_on_as_jax_does():
    def bad_iter():
        yield np.zeros((8, 2), np.float32)
        raise RuntimeError("boom")

    _both_contexts()
    for it in (pfs.prefetch_to_device(bad_iter(), "cpu"),
               jfs.prefetch_to_device(bad_iter())):
        with pytest.raises(RuntimeError, match="boom"):
            list(it)


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "zoo-prefetch"]


def test_closing_the_pipeline_releases_its_thread():
    """An endless source, one batch read, the generator closed: the
    producer blocked on the full queue sees the stop flag and ends (the
    JAX pipeline's contract)."""
    before = len(_prefetch_threads())
    gen = pfs.prefetch_to_device(
        (np.full((8, 2), i, np.float32) for i in itertools.count()), "cpu")
    assert float(next(gen)[0, 0]) == 0.0
    assert len(_prefetch_threads()) == before + 1
    gen.close()
    deadline = time.monotonic() + 5.0
    while len(_prefetch_threads()) > before and time.monotonic() < deadline:
        time.sleep(0.02)
    assert len(_prefetch_threads()) == before


def test_threaded_iterator_close_matches_jax():
    for cls in (pfs._ThreadedIterator, jfs._ThreadedIterator):
        it = cls(itertools.count(), buffer_size=2)
        assert next(it) == 0
        it.close()
        it._t.join(timeout=5.0)
        assert not it._t.is_alive()


def test_prefetch_notes_the_goodput_seams():
    ledger = GoodputLedger("train", registry=MetricsRegistry())
    x, y = _data(n=32)
    fs = pfs.FeatureSet.array(x, y)
    for _ in pfs.prefetch_to_device(fs.iter_batches(8), "cpu",
                                    ledger=ledger):
        time.sleep(0.01)
    sec = ledger.seconds()
    assert sec["device_step"] >= 0.03
    assert sec["data_wait"] > 0.0


def test_fit_evaluate_predict_under_prefetch_match_jax():
    """The eager loop, ``evaluate`` and ``predict`` stream through the
    pipeline; a small ``Dense`` fit against the JAX fit."""
    _both_contexts()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(96, 4)).astype(np.float32)
    y = (x @ rng.normal(size=(4, 1))).astype(np.float32)
    jm = JaxSequential([jl.Dense(1, input_shape=(4,))])
    jm.init_weights(rng=jax.random.key(1))
    pm = Sequential([pl.Dense(1, input_shape=(4,))], device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
    for m in (jm, pm):
        m.compile(optimizer="adam", loss="mse", lr=0.05)
    want = jm.fit(jfs.FeatureSet.array(x, y), batch_size=16,
                  nb_epoch=3)["loss"]
    got = pm.fit(pfs.FeatureSet.array(x, y), batch_size=16,
                 nb_epoch=3)["loss"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    ev_p = pm.evaluate(pfs.FeatureSet.array(x, y), batch_size=40)
    ev_j = jm.evaluate(jfs.FeatureSet.array(x, y), batch_size=40)
    np.testing.assert_allclose(ev_p["loss"], ev_j["loss"], rtol=FIT_RTOL)
    np.testing.assert_allclose(pm.predict(x, batch_size=40),
                               np.asarray(jm.predict(x, batch_size=40)),
                               rtol=FIT_RTOL, atol=FIT_ATOL)


# ---------------------------------------------------------------------------
# native IO and DiskFeatureSet (tests/test_disk_feature_set.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def npy_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("disk_fs")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1000, 6)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int32)
    xp, yp = str(d / "x.npy"), str(d / "y.npy")
    np.save(xp, x)
    np.save(yp, y)
    return xp, yp, x, y


def _native_listing():
    d = os.path.join(REPO, "native")
    return sorted((n, os.path.getmtime(os.path.join(d, n)))
                  for n in os.listdir(d))


def test_native_io_builds_under_build_never_native():
    before = _native_listing()
    assert native_io_available(), "g++ is in the image: the library builds"
    so = ploader.library_path("zoo_io", "zoo_io.cc")
    assert so.exists() and so.parent == ploader.BUILD_DIR
    assert os.path.relpath(str(so), REPO).startswith("build" + os.sep)
    assert _native_listing() == before


def test_gather_matches_numpy_and_jax(npy_pair):
    xp, yp, x, y = npy_pair
    f, jf = NativeArrayFile(xp), JaxNativeArrayFile(xp)
    assert f.io_path == "native"
    assert (f.n, f.record_shape, f.dtype) == (jf.n, jf.record_shape,
                                              jf.dtype)
    idx = np.array([0, 999, 3, 3, 500], np.int64)
    np.testing.assert_array_equal(f.gather(idx), x[idx])
    np.testing.assert_array_equal(f.gather(idx), jf.gather(idx))
    fy = NativeArrayFile(yp)
    np.testing.assert_array_equal(fy.gather(idx), y[idx])
    for bad in ([1000], [-1]):
        with pytest.raises(IndexError):
            f.gather(np.array(bad))
    f.prefetch(0, 1000)
    f.prefetch_wait()
    np.testing.assert_array_equal(f.gather(idx), x[idx])
    for h in (f, fy, jf):
        h.close()


def test_memmap_path_when_the_library_is_unavailable(npy_pair, monkeypatch):
    from analytics_zoo_tpu_torch.native import io as pio
    monkeypatch.setattr(pio, "load_native_io", lambda: None)
    xp, _, x, _ = npy_pair
    f = pio.NativeArrayFile(xp)
    assert f.io_path == "memmap"
    idx = np.array([5, 0, 999], np.int64)
    np.testing.assert_array_equal(f.gather(idx), x[idx])
    with pytest.raises(IndexError):
        f.gather(np.array([1000]))
    f.prefetch(0, 10)   # nothing on this path
    f.close()


@pytest.mark.parametrize("shuffle", [True, False])
def test_disk_slices_match_jax(npy_pair, shuffle):
    xp, yp, x, y = npy_pair
    fs = pfs.DiskFeatureSet(xp, yp, num_slices=4, shuffle=shuffle, seed=1)
    jfs_ = jfs.DiskFeatureSet(xp, yp, num_slices=4, shuffle=shuffle, seed=1)
    assert fs.num_of_slice == 4 and len(fs) == 250
    assert fs.steps_per_epoch(50) == 5 and fs.io_path == "native"
    for epoch in (0, 1, 5):
        np.testing.assert_array_equal(fs._slice_indices(epoch),
                                      jfs_._slice_indices(epoch))
        _assert_batches_equal(fs.iter_batches(50, epoch=epoch),
                              jfs_.iter_batches(50, epoch=epoch))
    np.testing.assert_array_equal(fs.sample(3), x[:3])
    fs.close()
    jfs_.close()


def test_disk_validations_and_eval_only_set(npy_pair):
    xp, yp, x, y = npy_pair
    with pytest.raises(ValueError, match="num_slices"):
        pfs.DiskFeatureSet(xp, yp, num_slices=1)
    ev = pfs.DiskFeatureSet(xp, yp, num_slices=0)
    np.testing.assert_array_equal(ev.x, x)
    np.testing.assert_array_equal(ev.y, y)
    with pytest.raises(ValueError, match="evaluation-only"):
        next(ev.iter_batches(10))
    ev.close()


def test_rotation_mode_covers_tail_records(tmp_path):
    x = np.arange(10, dtype=np.float32).reshape(10, 1)
    xp = str(tmp_path / "x10.npy")
    np.save(xp, x)
    fs = pfs.DiskFeatureSet(xp, num_slices=3, shuffle=False)
    jfs_ = jfs.DiskFeatureSet(xp, num_slices=3, shuffle=False)
    seen = set()
    for p in range(10):
        got = list(fs.iter_batches(1, epoch=p, drop_last=False))
        _assert_batches_equal(got, jfs_.iter_batches(1, epoch=p,
                                                     drop_last=False))
        seen.update(float(bx[0, 0]) for bx, _ in got)
    assert seen == set(range(10))
    fs.close()
    jfs_.close()


def _mlp_pair(hidden=16):
    jm = JaxSequential([jl.Dense(hidden, activation="relu",
                                 input_shape=(6,)),
                        jl.Dense(2, activation="softmax")])
    jm.init_weights(rng=jax.random.key(2))
    pm = Sequential([pl.Dense(hidden, activation="relu", input_shape=(6,)),
                     pl.Dense(2, activation="softmax")], device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
    for m in (jm, pm):
        m.compile(optimizer="adam", loss="scce", lr=5e-3)
    return jm, pm


def test_disk_fit_matches_jax_and_counts_full_passes(npy_pair):
    """``nb_epoch`` counts full passes: 2 of 4 slices is 8 slice passes,
    in both packages, with the JAX fit's losses and parameters."""
    _both_contexts()
    xp, yp, x, y = npy_pair
    jm, pm = _mlp_pair()
    jd = jfs.DiskFeatureSet(xp, yp, num_slices=4, seed=2)
    pd = pfs.DiskFeatureSet(xp, yp, num_slices=4, seed=2)
    want = jm.fit(jd, batch_size=48, nb_epoch=2)["loss"]
    got = pm.fit(pd, batch_size=48, nb_epoch=2)["loss"]
    assert len(got) == len(want) == 8
    assert pm.finished_epochs == jm.finished_epochs == 8
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    jp = peng.flatten_tree(jax.tree.map(np.asarray, jm.params))
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   jp[name.replace(".", "/")],
                                   rtol=FIT_RTOL, atol=FIT_ATOL)
    np.testing.assert_allclose(
        pm.evaluate(x, y, batch_size=200)["loss"],
        jm.evaluate(x, y, batch_size=200)["loss"], rtol=FIT_RTOL)
    jd.close()
    pd.close()


@pytest.mark.parametrize("conf", [{}, {"zoo.train.scan_steps": 2},
                                  {"zoo.train.device_cache": True}])
def test_disk_fit_has_the_bits_of_the_in_ram_fit_over_its_slices(
        npy_pair, conf):
    """Each slice pass against a fit of one epoch on a ``FeatureSet.array``
    of that slice (the loop's epoch numbers line up): the same bits. A
    sliced set declines ``device_cache`` (the in-RAM fits here stream
    too)."""
    xp, yp, x, y = npy_pair
    pctx.init_zoo_context(conf={"zoo.seed": 0, **conf})
    _, disk_m = _mlp_pair(hidden=8)
    peng.reset_uids()
    jeng.reset_uids()
    _, ram_m = _mlp_pair(hidden=8)
    pd = pfs.DiskFeatureSet(xp, yp, num_slices=2, shuffle=False, seed=3)
    got = disk_m.fit(pd, batch_size=40, nb_epoch=2)["loss"]
    pctx.init_zoo_context(conf={"zoo.seed": 0,
                                "zoo.train.scan_steps":
                                    conf.get("zoo.train.scan_steps", 1)})
    want = []
    for e in range(1, 5):
        idx = pd._slice_indices(0 + e)
        ram = pfs.FeatureSet.array(x[idx], y[idx], shuffle=False, seed=3)
        want += ram_m.fit(ram, batch_size=40, nb_epoch=1)["loss"]
    assert got == want
    for (n, a), (_, b) in zip(disk_m.named_parameters(),
                              ram_m.named_parameters()):
        assert torch.equal(a, b), n
    pd.close()


def test_max_epoch_end_trigger_counts_full_passes_as_jax(npy_pair):
    _both_contexts()
    xp, yp, _, _ = npy_pair
    jm, pm = _mlp_pair(hidden=4)
    jd = jfs.DiskFeatureSet(xp, yp, num_slices=4, seed=5)
    pd = pfs.DiskFeatureSet(xp, yp, num_slices=4, seed=5)
    want = jm.fit(jd, batch_size=56, nb_epoch=3,
                  end_trigger=JaxMaxEpoch(1))["loss"]
    got = pm.fit(pd, batch_size=56, nb_epoch=3,
                 end_trigger=MaxEpoch(1))["loss"]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    jd.close()
    pd.close()


def test_every_epoch_checkpoints_on_full_passes_as_jax(npy_pair, tmp_path):
    _both_contexts()
    xp, yp, _, _ = npy_pair
    jm, pm = _mlp_pair(hidden=4)
    jm.set_checkpoint(str(tmp_path / "jck"), trigger=JaxEveryEpoch())
    pm.set_checkpoint(str(tmp_path / "pck"), trigger=EveryEpoch())
    jd = jfs.DiskFeatureSet(xp, yp, num_slices=4, seed=3)
    pd = pfs.DiskFeatureSet(xp, yp, num_slices=4, seed=3)
    jm.fit(jd, batch_size=48, nb_epoch=2)
    pm.fit(pd, batch_size=48, nb_epoch=2)
    want = JaxCheckpointManager(str(tmp_path / "jck")).steps()
    got = CheckpointManager(str(tmp_path / "pck")).steps()
    assert got == want and len(got) == 2
    jd.close()
    pd.close()


def test_a_slice_unaware_trigger_warns(npy_pair, caplog):
    from analytics_zoo_tpu_torch.common.triggers import SeveralIteration
    from analytics_zoo_tpu_torch.common.triggers import Trigger

    class EveryTwo(Trigger):
        def __call__(self, state):
            return state.epoch_finished and state.epoch % 2 == 0

    pctx.init_zoo_context(conf={"zoo.seed": 0})
    xp, yp, _, _ = npy_pair
    _, pm = _mlp_pair(hidden=4)
    pd = pfs.DiskFeatureSet(xp, yp, num_slices=2, seed=3)
    with caplog.at_level("WARNING"):
        pm.fit(pd, batch_size=100, nb_epoch=2, end_trigger=EveryTwo())
    assert "observes SLICE passes" in caplog.text
    assert pm.finished_epochs == 2
    caplog.clear()
    with caplog.at_level("WARNING"):
        pm.fit(pd, batch_size=100, nb_epoch=1,
               end_trigger=SeveralIteration(100))
    assert "observes SLICE passes" not in caplog.text
    pd.close()


# ---------------------------------------------------------------------------
# BucketedFeatureSet
# ---------------------------------------------------------------------------

def _buckets(pkg):
    rng = np.random.default_rng(8)
    return [pkg.FeatureSet.array(
        rng.integers(0, 50, size=(n, t)).astype(np.int32),
        rng.integers(0, 2, n).astype(np.int32), seed=4)
        for n, t in ((24, 4), (16, 8), (0, 2), (40, 16))]


def test_bucket_interleave_matches_jax():
    got = pfs.BucketedFeatureSet(_buckets(pfs), seed=6)
    want = jfs.BucketedFeatureSet(_buckets(jfs), seed=6)
    assert len(got) == len(want) == 80 and len(got.buckets) == 3
    assert got.steps_per_epoch(8) == want.steps_per_epoch(8) == 10
    for epoch in (0, 1, 2):
        _assert_batches_equal(got.iter_batches(8, epoch=epoch),
                              want.iter_batches(8, epoch=epoch))
    assert not got.device_cacheable and got.ragged
    np.testing.assert_array_equal(got.y, want.y)
    with pytest.raises(ValueError, match="ragged"):
        got.x
    with pytest.raises(ValueError, match="non-empty"):
        pfs.BucketedFeatureSet([])


def test_bucketed_sets_refuse_chunks_and_dense_evaluation():
    pctx.init_zoo_context(conf={"zoo.train.scan_steps": 2})
    m = Sequential([pl.Embedding(50, 4, input_shape=(4,)), pl.Flatten(),
                    pl.Dense(2, activation="softmax")], device="cpu")
    m.compile(optimizer="adam", loss="scce")
    bfs = pfs.BucketedFeatureSet(_buckets(pfs)[:1])
    with pytest.raises(ValueError, match="scan_steps"):
        m.fit(bfs, batch_size=8, nb_epoch=1)
    with pytest.raises(ValueError, match="ragged"):
        m.evaluate(bfs)


# ---------------------------------------------------------------------------
# the out-of-core embedding cache (tests/test_sharded_embedding.py:195-317)
# ---------------------------------------------------------------------------

def _fams(reg):
    out = {}
    for m in reg.metrics():
        out[m.name] = out.get(m.name, 0.0) + m.value
    return out


def _caches(v=200, d=8, hot_rows=64, seed=5, **kw):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    preg, jreg = MetricsRegistry(), JaxRegistry()
    pc = pse.OutOfCoreEmbeddingCache(table, hot_rows=hot_rows,
                                     registry=preg, device="cpu", **kw)
    jc = jse.OutOfCoreEmbeddingCache(table, hot_rows=hot_rows,
                                     registry=jreg, **kw)
    return table, pc, jc, preg, jreg


def test_oocore_plan_rows_and_counters_match_jax():
    table, pc, jc, preg, jreg = _caches()
    ids = np.array([0, 3, 3, 63, 64, 150, 150, 199, 400, -2])
    for _ in range(2):   # the replay is all hits: the staged LRU
        p, jp = pc.plan(ids), jc.plan(ids)
        np.testing.assert_array_equal(p.remap, jp.remap)
        np.testing.assert_array_equal(p.cold, jp.cold)
        np.testing.assert_array_equal(p.cold_ids, jp.cold_ids)
        rows = pc.rows(p)
        np.testing.assert_array_equal(rows.numpy(),
                                      table[np.clip(ids, 0, 199)])
        np.testing.assert_array_equal(rows.numpy(),
                                      np.asarray(jc.rows(jp)))
        assert _fams(preg) == _fams(jreg)
    assert _fams(preg)["zoo_embed_cache_misses_total"] == 3
    assert pc.hot_rows == jc.hot_rows == 64


def test_oocore_host_tier_only_and_budgeted_hot_rows_match_jax():
    table, pc, jc, _, _ = _caches()
    ids = np.arange(64, 128).reshape(8, 8)
    np.testing.assert_array_equal(pc.rows(pc.plan(ids)).numpy(),
                                  np.asarray(jc.rows(jc.plan(ids))))
    table0, pc0, jc0, _, _ = _caches(hot_rows=0)
    assert pc0.hot.shape[0] == jc0.hot.shape[0] == 0
    np.testing.assert_array_equal(pc0.rows(pc0.plan(ids)).numpy(),
                                  table0[ids])
    _both_contexts({"zoo.embed.hot_rows_budget_mb": 0.0001})
    _, pcb, jcb, _, _ = _caches(v=300, d=4, hot_rows=None)
    assert pcb.hot_rows == jcb.hot_rows == 6    # 104 bytes of 16-byte rows
    assert pcb.prefetch_depth == jcb.prefetch_depth == 2


@pytest.mark.parametrize("hot_rows", [0, 64, 200])
def test_oocore_grad_reconstruction_matches_jax(hot_rows):
    table, pc, jc, _, _ = _caches(hot_rows=hot_rows)
    ids = np.random.default_rng(9).integers(0, 200, size=(64,))
    p, jp = pc.plan(ids), jc.plan(ids)
    hot = pc.hot.clone().requires_grad_()
    cold = torch.from_numpy(p.cold.copy()).requires_grad_()
    torch.sin(pc.rows(p, hot=hot, cold=cold)).sum().backward()
    dw = p.scatter_grad(hot.grad, cold.grad)
    gh, gc = jax.grad(
        lambda h, c: jnp.sum(jnp.sin(
            jse.oocore_gather(h, c, jnp.asarray(jp.remap)))),
        argnums=(0, 1))(jc.hot, jnp.asarray(jp.cold))
    np.testing.assert_allclose(dw, jp.scatter_grad(gh, gc), **GTOL)
    # torch's own backward of the plain gather agrees too
    hot2 = pc.hot.clone().requires_grad_()
    cold2 = torch.from_numpy(p.cold.copy()).requires_grad_()
    torch.sin(pse.oocore_gather(hot2, cold2, torch.from_numpy(p.remap))
              ).sum().backward()
    np.testing.assert_allclose(p.scatter_grad(hot2.grad, cold2.grad), dw,
                               **GTOL)


def test_oocore_stream_prefetches_and_counts_as_jax():
    table, pc, jc, preg, jreg = _caches()
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, 40, size=(128,)) for _ in range(6)]
    seen = 0
    for (ids, p), (jids, jp) in zip(pc.stream(iter(batches)),
                                    jc.stream(iter(batches))):
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(pc.rows(p).numpy(),
                                      table[np.clip(ids, 0, 199)])
        seen += 1
    assert seen == len(batches)
    assert _fams(preg) == _fams(jreg)
    assert _fams(preg)["zoo_embed_dedup_saved_rows_total"] > 0
    assert _fams(preg)["zoo_embed_prefetch_errors_total"] == 0


def test_fault_host_fetch_latency_charged_to_data_wait():
    _both_contexts(faults_enabled=True)
    delay = 0.4
    table, pc, _, reg, _ = _caches()
    ledger = GoodputLedger("train", registry=reg)
    plan = pfaults.FaultPlan(seed=7).add("embed.host_fetch", "latency",
                                         at=(0,), delay_s=delay)
    batches = [np.arange(64, 128), np.arange(100, 160)]
    with pfaults.activate(plan):
        for ids, p in pc.stream(iter(batches), ledger=ledger):
            np.testing.assert_array_equal(pc.rows(p).numpy(), table[ids])
    assert plan.fired_at("embed.host_fetch") == \
        [("embed.host_fetch", "latency", 0)]
    assert ledger.seconds()["data_wait"] >= 0.5 * delay


def test_fault_prefetch_error_degrades_as_jax_does():
    _both_contexts(faults_enabled=True)
    table, pc, jc, preg, jreg = _caches()
    rng = np.random.default_rng(13)
    batches = [rng.integers(0, 200, size=(64,)) for _ in range(5)]
    fired = {}
    for name, cache, faults in (("port", pc, pfaults), ("jax", jc, jfaults)):
        plan = faults.FaultPlan(seed=7).add("embed.prefetch", "error",
                                            at=(0, 2))
        with faults.activate(plan):
            got = [(ids, np.asarray(cache.rows(p)))
                   for ids, p in cache.stream(iter(batches))]
        assert len(got) == len(batches)
        for ids, rows in got:
            np.testing.assert_array_equal(rows, table[np.clip(ids, 0, 199)])
        fired[name] = [f[2] for f in plan.fired_at("embed.prefetch")]
    assert fired["port"] == fired["jax"] == [0, 2]
    assert _fams(preg)["zoo_embed_prefetch_errors_total"] == \
        _fams(jreg)["zoo_embed_prefetch_errors_total"] == 2


def test_oocore_gradient_is_the_same_bits_twice_and_sa_sorted():
    """The SA route reads the plan's stable sort of ``inv`` (the CPU path
    checks it against ``inv``) and gives the same bits on a second
    backward."""
    table, pc, _, _, _ = _caches()
    ids = np.random.default_rng(2).integers(0, 200, size=(8, 16))
    p = pc.plan(ids)
    np.testing.assert_array_equal(p.order, np.argsort(p.inv, kind="stable"))
    np.testing.assert_array_equal(p.sorted_slot, p.inv[p.order])
    grads = []
    for _ in range(2):
        hot = pc.hot.clone().requires_grad_()
        cold = torch.from_numpy(p.cold.copy()).requires_grad_()
        out = pc.rows(p, hot=hot, cold=cold)
        assert out.shape == (8, 16, 8)
        (out * torch.arange(8.0)).sum().backward()
        grads.append((hot.grad, cold.grad))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# ---------------------------------------------------------------------------
# no jax in the port's new modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", [
    "analytics_zoo_tpu_torch.feature.feature_set",
    "analytics_zoo_tpu_torch.native",
    "analytics_zoo_tpu_torch.native.io",
    "analytics_zoo_tpu_torch.native._loader",
    "analytics_zoo_tpu_torch.ops.sharded_embedding",
    "analytics_zoo_tpu_torch.ops.pallas.quantized",
    "analytics_zoo_tpu_torch.pipeline.api.keras.training",
])
def test_data_modules_import_no_jax(module, tmp_path):
    """Importing the module, streaming a disk set through the prefetch
    pipeline and one oocore plan leave jax and the JAX package out of
    ``sys.modules``."""
    np.save(str(tmp_path / "x.npy"), np.arange(24, dtype=np.float32
                                               ).reshape(12, 2))
    code = (
        "import sys, importlib, numpy as np\n"
        f"importlib.import_module({module!r})\n"
        "from analytics_zoo_tpu_torch.feature import (DiskFeatureSet, "
        "prefetch_to_device)\n"
        "from analytics_zoo_tpu_torch.ops.sharded_embedding import "
        "OutOfCoreEmbeddingCache\n"
        f"fs = DiskFeatureSet({str(tmp_path / 'x.npy')!r}, num_slices=2)\n"
        "assert len(list(prefetch_to_device(fs.iter_batches(2), 'cpu'))) "
        "== 3\n"
        "c = OutOfCoreEmbeddingCache(np.ones((9, 2), np.float32), "
        "hot_rows=3, device='cpu')\n"
        "assert c.rows(c.plan(np.arange(9))).shape == (9, 2)\n"
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
