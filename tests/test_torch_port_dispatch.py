"""The port's fused training dispatch held to the JAX loop on transferred
weights: ``zoo.train.scan_steps`` (K steps a dispatch over stacked
FeatureSet batches, the last chunk shorter), ``zoo.train.device_cache``
(the dataset on the device, each epoch's permutation handed across from
``jax.random.permutation``, batches gathered there) and
``zoo.train.fuse_epochs`` (epochs a block). On the CPU the port runs the
same steps it captures on CUDA, with a loop in place of the replay.

Tolerances, each with its reason:
* against JAX (``FIT_RTOL``/``FIT_ATOL``, the recommender fit tests'):
  epoch losses 1e-5 relative and parameters 1e-4 relative / 1e-5
  absolute after the fit: the same f32 arithmetic in other summation
  orders, amplified by Adam over a dozen steps;
* the port's dispatch paths against one another: the same bits (the
  same ops on the same values in the same order);
* records: epoch and iteration exact, the loss as the epoch loss.
Batch sizes are multiples of 8 (the JAX side runs on conftest's 8-device
CPU mesh).
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.models.recommendation import NeuralCF as JaxNeuralCF
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JaxSequential
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.feature.feature_set import (FeatureSet,
                                                         chunked,
                                                         stack_batches)
from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
from analytics_zoo_tpu_torch.pipeline.api.keras import dispatch
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as pl
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential

FIT_RTOL, FIT_ATOL = 1e-4, 1e-5
LOSS_RTOL = 1e-5
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
    jeng.set_policy()


def _both_contexts(conf=None):
    conf = {"zoo.seed": 0, **(conf or {})}
    jctx.init_zoo_context(conf=conf)
    pctx.init_zoo_context(conf=conf)


def _jax_order(monkeypatch):
    """The port's device permutation replaced by the JAX loop's
    ``jax.random.permutation(jax.random.key(seed), n)``."""
    def perm(n, seed, device):
        order = jax.random.permutation(jax.random.key(seed), n)
        return torch.from_numpy(np.asarray(order).astype(np.int64)).to(
            device)
    monkeypatch.setattr(dispatch, "device_permutation", perm)


def _feature_set_order(monkeypatch):
    """The port's device permutation replaced by the FeatureSet's own
    order for that epoch (``default_rng(fs.seed + zoo.seed + epoch)``)."""
    def perm(n, seed, device):
        return torch.from_numpy(
            np.random.default_rng(seed).permutation(n)).to(device)
    monkeypatch.setattr(dispatch, "device_permutation", perm)


def _mlp_data(n=72, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    return x, (np.abs(x[:, 0] * 3 + x[:, 1]) % 3).astype(np.int32)


def _ncf_data(n=96, users=63, items=127, seed=3):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(1, users + 1, n),
                  rng.integers(1, items + 1, n)], axis=1).astype(np.int32)
    return x, ((x[:, 0] + x[:, 1]) % 5).astype(np.int32)


def _jax_tree(model):
    return jax.tree.map(np.asarray, model.params)


def _models(kind):
    """A JAX model and the port's with its weights, and data: a small
    ``Sequential`` of ``Dense`` layers (72 rows, batch 8: 9 steps an
    epoch) or a small NeuralCF (96 rows, batch 16: 6 steps)."""
    if kind == "mlp":
        jm = JaxSequential([jl.Dense(8, activation="relu", input_shape=(6,)),
                            jl.Dense(3, activation="softmax")])
        jm.init_weights(rng=jax.random.key(1))
        pm = Sequential([pl.Dense(8, activation="relu", input_shape=(6,)),
                         pl.Dense(3, activation="softmax")], device="cpu")
        pm.load_jax_params(_jax_tree(jm))
        return jm, pm, pm, _mlp_data(), 8
    jm = JaxNeuralCF(63, 127, 5, **NCF_SMALL)
    jm.init_weights(rng=jax.random.key(3))
    pm = NeuralCF(63, 127, 5, **NCF_SMALL, device="cpu")
    pm.load_jax_params(_jax_tree(jm))
    return jm, pm, pm.model, _ncf_data(), 16


def _port_params(net):
    return {n.replace(".", "/"): p.detach().float().numpy()
            for n, p in net.named_parameters()}


def _assert_fit_close(jm, pnet, want, got):
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    jp = peng.flatten_tree(_jax_tree(jm))
    pp = _port_params(pnet)
    assert sorted(jp) == sorted(pp)
    for key in jp:
        np.testing.assert_allclose(pp[key], jp[key], rtol=FIT_RTOL,
                                   atol=FIT_ATOL, err_msg=key)


def _fit_both(kind, conf, nb_epoch=2, monkeypatch=None):
    _both_contexts(conf)
    if monkeypatch is not None:
        _jax_order(monkeypatch)
    jm, pm, pnet, (x, y), batch = _models(kind)
    for m in (jm, pm):
        m.compile(optimizer="adam", loss="scce", lr=0.01)
    jrec, prec = [], []
    want = jm.fit(x, y, batch_size=batch, nb_epoch=nb_epoch,
                  callbacks=[jrec.append])["loss"]
    got = pm.fit(x, y, batch_size=batch, nb_epoch=nb_epoch,
                 callbacks=[prec.append])["loss"]
    return jm, pm, pnet, want, got, jrec, prec


def _bits(net):
    return {n: p.detach().clone() for n, p in net.named_parameters()}


def _assert_same_bits(a, b):
    assert a.keys() == b.keys()
    for n in a:
        assert torch.equal(a[n], b[n]), n


# ---------------------------------------------------------------------------
# the dispatch paths against the JAX loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mlp", "ncf"])
def test_scan_steps_fit_matches_jax_scan_path(kind):
    """``scan_steps=4``: 9 steps an epoch (mlp: chunks of 4, 4 and a short
    1) or 6 (ncf: 4 and a short 2), two epochs, against the JAX loop's
    chunked ``lax.scan`` dispatch."""
    jm, pm, pnet, want, got, _, _ = _fit_both(
        kind, {"zoo.train.scan_steps": 4})
    _assert_fit_close(jm, pnet, want, got)
    assert pm.finished_iterations == jm.finished_iterations


@pytest.mark.parametrize("scan_steps", [1, 4])
@pytest.mark.parametrize("kind", ["mlp", "ncf"])
def test_device_cache_fit_matches_jax_epoch_fn(kind, scan_steps,
                                               monkeypatch):
    """``device_cache``: the JAX loop's whole-epoch dispatch
    (``build_epoch_fn``), its permutation handed across; the port gathers
    each step's batch from the device-resident set, one step or four a
    dispatch."""
    jm, pm, pnet, want, got, _, _ = _fit_both(
        kind, {"zoo.train.device_cache": True,
               "zoo.train.scan_steps": scan_steps},
        monkeypatch=monkeypatch)
    _assert_fit_close(jm, pnet, want, got)


@pytest.mark.parametrize("fuse,nb_epoch", [(2, 3), (3, 3), (2, 4)])
@pytest.mark.parametrize("kind", ["mlp", "ncf"])
def test_fuse_epochs_matches_jax_multi_epoch_block(kind, fuse, nb_epoch,
                                                   monkeypatch):
    """``fuse_epochs`` on the device-cached path: blocks of ``fuse`` epochs
    (the last one shorter where ``nb_epoch`` says so) against JAX's
    multi-epoch dispatch: history, each epoch's record (epoch, iteration,
    loss) and the finished epochs and iterations."""
    jm, pm, pnet, want, got, jrec, prec = _fit_both(
        kind, {"zoo.train.device_cache": True, "zoo.train.scan_steps": 4,
               "zoo.train.fuse_epochs": fuse},
        nb_epoch=nb_epoch, monkeypatch=monkeypatch)
    _assert_fit_close(jm, pnet, want, got)
    assert [(r["epoch"], r["iteration"]) for r in prec] == \
        [(r["epoch"], r["iteration"]) for r in jrec]
    np.testing.assert_allclose([r["loss"] for r in prec],
                               [r["loss"] for r in jrec], rtol=LOSS_RTOL)
    assert (pm.finished_epochs, pm.finished_iterations) == \
        (jm.finished_epochs, jm.finished_iterations)


# ---------------------------------------------------------------------------
# the port's paths against one another
# ---------------------------------------------------------------------------

def _port_fit(kind, conf, nb_epochs=(2,), monkeypatch=None, seed=0):
    pctx.reset_zoo_context()
    pctx.init_zoo_context(conf={"zoo.seed": seed, **conf})
    peng.reset_uids()
    if kind == "mlp":
        pm = Sequential([pl.Dense(8, activation="relu", input_shape=(6,)),
                         pl.Dense(3, activation="softmax")], device="cpu")
        (x, y), batch, net = _mlp_data(), 8, pm
        pm.init_weights(torch.Generator().manual_seed(4))
    else:
        pm = NeuralCF(63, 127, 5, **NCF_SMALL, device="cpu")
        (x, y), batch = _ncf_data(), 16
        pm.init_weights(torch.Generator().manual_seed(4))
        net = pm.model
    pm.compile(optimizer="adam", loss="scce", lr=0.01)
    losses, steps = [], []
    for n in nb_epochs:
        losses += pm.fit(x, y, batch_size=batch, nb_epoch=n)["loss"]
        steps += pm._loop.step_losses
    return losses, np.stack(steps), _bits(net), pm


@pytest.mark.parametrize("conf", [
    {"zoo.train.scan_steps": 4},
    {"zoo.train.device_cache": True},
    {"zoo.train.device_cache": True, "zoo.train.scan_steps": 4,
     "zoo.train.fuse_epochs": 2},
], ids=["scan4", "cache", "cache_scan4_fuse2"])
@pytest.mark.parametrize("kind", ["mlp", "ncf"])
def test_keyed_loop_gives_the_eager_loops_bits_in_the_same_order(
        kind, conf, monkeypatch):
    """With the FeatureSet's own batch order, each keyed path's step
    losses, epoch losses and final parameters are the eager loop's bits."""
    _feature_set_order(monkeypatch)
    want = _port_fit(kind, {})
    got = _port_fit(kind, conf, monkeypatch=monkeypatch)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    _assert_same_bits(got[2], want[2])


@pytest.mark.parametrize("conf", [
    {},
    {"zoo.train.scan_steps": 4},
    {"zoo.train.device_cache": True, "zoo.train.scan_steps": 4,
     "zoo.train.fuse_epochs": 2},
], ids=["eager", "scan4", "cache_scan4_fuse2"])
def test_a_second_fit_continues_the_optimizer_count(conf):
    """1 + 2 epochs in two fits are 3 epochs in one, bit for bit: Adam's
    bias corrections read the count the first fit left, and the count is
    every step taken."""
    one = _port_fit("ncf", conf, nb_epochs=(3,))
    two = _port_fit("ncf", conf, nb_epochs=(1, 2))
    assert two[0] == one[0]
    _assert_same_bits(two[2], one[2])
    assert two[3].opt_state["count"] == 18 == two[3].finished_iterations


def test_fuse_epochs_acts_only_on_the_device_cached_path():
    """As in JAX: ``fuse_epochs`` without ``device_cache`` changes
    nothing, and with validation data the cached path runs epoch by
    epoch, evaluating after each."""
    eager = _port_fit("mlp", {})
    fused_off = _port_fit("mlp", {"zoo.train.fuse_epochs": 3,
                                  "zoo.train.scan_steps": 4})
    assert fused_off[0] == eager[0]
    _assert_same_bits(fused_off[2], eager[2])
    pctx.reset_zoo_context()
    pctx.init_zoo_context(conf={"zoo.train.device_cache": True,
                                "zoo.train.fuse_epochs": 3})
    pm = Sequential([pl.Dense(3, activation="softmax", input_shape=(6,))],
                    device="cpu").init_weights()
    pm.compile(optimizer="adam", loss="scce", metrics=["accuracy"])
    x, y = _mlp_data()
    hist = pm.fit(x, y, batch_size=8, nb_epoch=3,
                  validation_data=(x[:16], y[:16]))
    assert len(hist["val_loss"]) == len(hist["val_accuracy"]) == 3


def test_context_takes_the_dispatch_keys_with_jax_defaults():
    pctx.init_zoo_context()
    assert pctx.train_dispatch() == (1, False, 1)
    assert (jctx.DEFAULT_CONF["zoo.train.scan_steps"],
            jctx.DEFAULT_CONF["zoo.train.device_cache"],
            jctx.DEFAULT_CONF["zoo.train.fuse_epochs"]) == (1, False, 1)
    pctx.init_zoo_context(train_scan_steps=16, train_device_cache="true",
                          train_fuse_epochs=12)
    assert pctx.train_dispatch() == (16, True, 12)


def test_chunks_stack_feature_set_batches_in_order():
    """``chunked`` stacks K batches of the FeatureSet's order, the last
    chunk holding the rest; a list of features stacks feature by
    feature."""
    x, y = _ncf_data(40)
    fs = FeatureSet.array([x, x[:, :1]], y, seed=3)
    batches = list(fs.iter_batches(8, epoch=2))
    chunks = list(chunked(iter(batches), 2))
    assert [c[1].shape for c in chunks] == [(2, 8), (2, 8), (1, 8)]
    flat = [b for c in chunks for b in zip(*[iter(a) for a in
                                            (c[0][0], c[0][1], c[1])])]
    for (bx, by), (a, b, c) in zip(batches, flat):
        np.testing.assert_array_equal(a, bx[0])
        np.testing.assert_array_equal(b, bx[1])
        np.testing.assert_array_equal(c, by)
    sx, sy = stack_batches([(x[:2], None), (x[2:4], None)])
    assert sx.shape == (2, 2, 2) and sy is None
    assert FeatureSet.device_cacheable


def test_device_permutation_is_a_permutation_from_the_seed():
    a = dispatch.device_permutation(50, 7, "cpu")
    assert sorted(a.tolist()) == list(range(50))
    assert torch.equal(a, dispatch.device_permutation(50, 7, "cpu"))
    assert not torch.equal(a, dispatch.device_permutation(50, 8, "cpu"))


def test_dispatch_imports_no_jax():
    """The dispatch path's modules import torch, never jax (checked in a
    fresh interpreter)."""
    import subprocess
    import sys
    code = ("import sys; import analytics_zoo_tpu_torch.pipeline.api.keras."
            "dispatch, analytics_zoo_tpu_torch.ops.launch_count; "
            "sys.exit(int(any(m == 'jax' or m.startswith('jax.') or "
            "m.startswith('analytics_zoo_tpu.') for m in sys.modules)))")
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0
