"""``BatchNormalization`` in the port, and the model state its training
step writes, held to the JAX package and to the port itself.

* The layer against JAX ``apply`` for ``axis`` -1 and 1, f32 and bf16,
  training (the output and the new moving statistics) and inference: f32
  1e-5 (the same sums in another order), bf16 2e-2 (one bf16 rounding).
* Two fit steps of a small conv + BN net against the JAX fit (batch 8,
  a multiple of conftest's 8 CPU devices): the first step's loss and
  gradients, then the losses, parameters and moving statistics after the
  fit (1e-5; Adam on the same arithmetic in another order).
* The port against itself, bit for bit: the training forward writes no
  buffer; under every ``zoo.train.remat`` mode the statistics are those
  of the fit without remat; under ``zoo.train.scan_steps`` those of the
  eager fit; a ``recover`` skip leaves them at their pre-step bits.
* The statistics through a snapshot and a ZooModel ``.npz``, both ways,
  and through a resume, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.models.image.imageclassification import \
    ImageClassifier as JImageClassifier
from analytics_zoo_tpu.models.common import zoo_model as jzoo
from analytics_zoo_tpu.observability import MetricsRegistry as JRegistry
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.utils.checkpoint import \
    CheckpointManager as JCheckpointManager
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.common import faults as pfaults
from analytics_zoo_tpu_torch.models.common import zoo_model as pzoo
from analytics_zoo_tpu_torch.models.image.imageclassification import \
    ImageClassifier as PImageClassifier
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as pl
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import \
    Sequential as PSequential

FIT_TOL = 1e-5
BATCH = 8


@pytest.fixture(autouse=True)
def contexts():
    pctx.reset_zoo_context()
    peng.reset_uids()
    jeng.reset_uids()
    yield
    pctx.reset_zoo_context()
    jctx.reset_zoo_context()
    jeng.set_policy()
    peng.set_policy()


def _both_contexts(conf=None):
    conf = {"zoo.seed": 0, **(conf or {})}
    jctx.init_zoo_context(conf=conf)
    pctx.init_zoo_context(conf=conf)
    peng.reset_uids()
    jeng.reset_uids()


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [-1, 1])
@pytest.mark.parametrize("training", [True, False])
def test_batchnorm_forward_and_state_match_jax_apply(axis, dtype,
                                                     training):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 5, 6, 3)) * 2 + 1).astype(np.float32)
    d = x.shape[axis]
    params = {"gamma": rng.normal(size=d).astype(np.float32),
              "beta": rng.normal(size=d).astype(np.float32)}
    state = {"moving_mean": rng.normal(size=d).astype(np.float32),
             "moving_var": rng.random(d).astype(np.float32) + 0.5}
    jb = jl.BatchNormalization(axis=axis)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    want, want_state = jb.apply({k: jnp.asarray(v) for k, v in
                                 params.items()},
                                {k: jnp.asarray(v) for k, v in
                                 state.items()}, xj, training=training)
    pb = pl.BatchNormalization(axis=axis)
    pb.build((None,) + x.shape[1:], generator=torch.Generator())
    peng.load_param_tree(pb, params, state)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    with peng.collect_state() as sink:
        got = pb(xt, training=training)
    assert got.dtype == xt.dtype
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol * 4, rtol=tol)
    # nothing is written by the forward itself
    np.testing.assert_array_equal(pb.moving_mean.numpy(),
                                  state["moving_mean"])
    assert len(sink) == (2 if training else 0)
    peng.commit_state(sink)
    for key in state:
        assert getattr(pb, key).dtype == torch.float32
        np.testing.assert_allclose(getattr(pb, key).numpy(),
                                   np.asarray(want_state[key]), atol=1e-6,
                                   rtol=1e-5, err_msg=key)


def test_batchnorm_variance_is_biased_and_momentum_is_the_jax_rule():
    """The moving variance takes the biased batch variance with weight
    ``1 - m``: what ``nn.BatchNorm2d`` would write differs."""
    x = torch.tensor([[1.0], [3.0]])
    pb = pl.BatchNormalization()
    pb.build((None, 1), generator=torch.Generator())
    with peng.collect_state() as sink:
        pb(x, training=True)
    peng.commit_state(sink)
    assert pb.moving_var.item() == pytest.approx(0.99 + 0.01 * 1.0)
    assert pb.moving_mean.item() == pytest.approx(0.01 * 2.0)
    assert peng.written_state(pb).keys() == {"moving_mean", "moving_var"}


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def _conv_bn(pkg_layers, seq, device=None):
    # no conv bias before the BatchNorm, as the topologies build it: its
    # gradient is zero up to rounding, which Adam would blow up to full
    # steps in different directions in the two packages
    layers = [pkg_layers.Convolution2D(4, 3, 3, border_mode="same",
                                       subsample=(2, 2), bias=False,
                                       input_shape=(8, 8, 3)),
              pkg_layers.BatchNormalization(),
              pkg_layers.Activation("relu"),
              pkg_layers.MaxPooling2D((2, 2)),
              pkg_layers.Flatten(),
              pkg_layers.Dense(3, activation="softmax")]
    return seq(layers) if device is None else seq(layers, device=device)


def _data(n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 8, 8, 3)) * 1.5 + 0.5).astype(np.float32)
    return x, (np.arange(n) % 3).astype(np.int32)


def _pair():
    jm = _conv_bn(jl, JSequential)
    jm.init_weights(rng=jax.random.key(1))
    pm = _conv_bn(pl, PSequential, device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params),
                       jax.tree.map(np.asarray, jm.net_state))
    return jm, pm


def _port_state(pm):
    return {k.replace(".", "/"): v.detach().numpy().copy()
            for k, v in peng.named_state(pm).items()}


def _port_params(pm):
    return {k.replace(".", "/"): v.detach().numpy().copy()
            for k, v in pm.named_parameters()}


def test_conv_bn_first_step_loss_and_gradients_match_jax():
    _both_contexts()
    jm, pm = _pair()
    x, y = _data(BATCH)

    def loss(params):
        out, state = jm.apply(params, jm.net_state, jnp.asarray(x),
                              training=True)
        onehot = jax.nn.one_hot(y, 3)
        return -jnp.mean(jnp.sum(onehot * jnp.log(out), -1)), state

    (want, _), grads = jax.value_and_grad(loss, has_aux=True)(jm.params)
    out = pm(torch.from_numpy(x), training=True)
    got = -torch.log(out[torch.arange(BATCH), torch.from_numpy(y).long()]
                     ).mean()
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    for key, g in peng.flatten_tree(jax.tree.map(np.asarray,
                                                 grads)).items():
        np.testing.assert_allclose(
            dict(pm.named_parameters())[key.replace("/", ".")].grad.numpy(),
            g, atol=1e-5, rtol=1e-4, err_msg=key)


def test_conv_bn_fit_matches_jax_losses_params_and_moving_statistics():
    _both_contexts()
    jm, pm = _pair()
    x, y = _data()
    for m in (jm, pm):
        m.compile(optimizer="adam", loss="scce", lr=0.01)
    hj = jm.fit(x, y, batch_size=BATCH, nb_epoch=1, shuffle=False)["loss"]
    hp = pm.fit(x, y, batch_size=BATCH, nb_epoch=1, shuffle=False)["loss"]
    np.testing.assert_allclose(hp, hj, rtol=FIT_TOL)
    for want, got in ((peng.flatten_tree(jax.tree.map(np.asarray,
                                                      jm.params)),
                       _port_params(pm)),
                      (peng.flatten_tree(jax.tree.map(np.asarray,
                                                      jm.net_state)),
                       _port_state(pm))):
        assert sorted(want) == sorted(got)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=FIT_TOL,
                                       atol=FIT_TOL, err_msg=key)
    # the statistics moved: two steps of 0.99 * old + 0.01 * batch
    assert not np.allclose(_port_state(pm)["batchnormalization_1/"
                                           "moving_var"], 1.0)
    np.testing.assert_allclose(
        pm.predict(x, batch_size=BATCH),
        np.asarray(jm.predict(x, batch_size=BATCH)), atol=1e-5, rtol=1e-4)


def _port_fit(conf, plan=None, epochs=1):
    pctx.init_zoo_context(conf={"zoo.seed": 0, **conf})
    peng.reset_uids()
    jeng.reset_uids()
    _, pm = _pair()
    x, y = _data(32)
    pm.compile(optimizer="adam", loss="scce", lr=0.01)
    if plan is None:
        h = pm.fit(x, y, batch_size=BATCH, nb_epoch=epochs, shuffle=False)
    else:
        with pfaults.activate(plan):
            h = pm.fit(x, y, batch_size=BATCH, nb_epoch=epochs,
                       shuffle=False)
    return pm, h["loss"]


def _assert_same_bits(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("mode", ["true", "dots", "full"])
def test_remat_writes_the_statistics_once(mode):
    """The recompute runs the forward again and hands its state to no
    one: every remat mode leaves the moving statistics (and the losses)
    the bits of the fit without remat."""
    base, base_loss = _port_fit({})
    pm, loss = _port_fit({"zoo.train.remat": mode})
    _assert_same_bits(_port_state(pm), _port_state(base))
    np.testing.assert_array_equal(loss, base_loss)


@pytest.mark.parametrize("conf", [{"zoo.train.scan_steps": 3},
                                  {"zoo.train.scan_steps": 2,
                                   "zoo.train.device_cache": True}])
def test_multi_step_program_commits_the_statistics_as_eager(conf):
    base, base_loss = _port_fit({}, epochs=2)
    pm, loss = _port_fit(conf, epochs=2)
    _assert_same_bits(_port_state(pm), _port_state(base))
    _assert_same_bits(_port_params(pm), _port_params(base))
    np.testing.assert_array_equal(loss, base_loss)


@pytest.mark.parametrize("scan_steps", [1, 2])
def test_recover_skip_keeps_the_pre_step_statistics(scan_steps):
    """Under ``recover`` a poisoned step's update is discarded, its new
    moving statistics with it (the JAX step keeps the pre-step
    ``net_state``): a fit poisoned at its last step ends with the
    statistics of the fit that stopped one step before."""
    conf = {"zoo.faults.enabled": True, "zoo.train.sentinel": "recover",
            "zoo.train.scan_steps": scan_steps}
    plan = pfaults.FaultPlan(seed=1).add("train.grads", "nan_grad", at=(3,))
    pm, _ = _port_fit(conf, plan)
    pctx.init_zoo_context(conf={"zoo.seed": 0, **conf})
    peng.reset_uids()
    _, ref = _pair()
    x, y = _data(32)
    ref.compile(optimizer="adam", loss="scce", lr=0.01)
    ref.fit(x[:24], y[:24], batch_size=BATCH, nb_epoch=1, shuffle=False)
    _assert_same_bits(_port_state(pm), _port_state(ref))
    _assert_same_bits(_port_params(pm), _port_params(ref))


def test_eval_and_predict_read_and_keep_the_statistics():
    _both_contexts()
    _, pm = _pair()
    x, y = _data()
    pm.compile(optimizer="adam", loss="scce", lr=0.01)
    before = _port_state(pm)
    pm.evaluate(x, y, batch_size=BATCH)
    pm.predict(x, batch_size=BATCH)
    pm(torch.from_numpy(x), training=True)        # no collecting step
    _assert_same_bits(_port_state(pm), before)


# ---------------------------------------------------------------------------
# checkpoints and the .npz
# ---------------------------------------------------------------------------

def test_statistics_through_checkpoints_both_ways(tmp_path):
    """The port's snapshot restores the JAX model's moving statistics
    through the JAX manager; a JAX snapshot restores the port's, bit for
    bit; a resume restores them bit for bit."""
    _both_contexts()
    jm, pm = _pair()
    x, y = _data()
    for m in (jm, pm):
        m.compile(optimizer="adam", loss="scce", lr=0.01)
    pm.set_checkpoint(str(tmp_path / "p"))
    pm.fit(x, y, batch_size=BATCH, nb_epoch=1, shuffle=False)
    jm.fit(x, y, batch_size=BATCH, nb_epoch=0)
    mgr = JCheckpointManager(str(tmp_path / "p"), registry=JRegistry())
    _, trees, _ = mgr.restore_latest(
        {"params": jm.params,
         "opt_state": jm._loop.optimizer.init(jm.params),
         "net_state": jm.net_state})
    _assert_same_bits(
        peng.flatten_tree(jax.tree.map(np.asarray, trees["net_state"])),
        _port_state(pm))

    jm2, pm2 = _pair()
    jm2.compile(optimizer="adam", loss="scce", lr=0.01)
    jm2.set_checkpoint(str(tmp_path / "j"))
    jm2.fit(x, y, batch_size=BATCH, nb_epoch=1, shuffle=False)
    pm2.compile(optimizer="adam", loss="scce", lr=0.01)
    pm2.set_checkpoint(str(tmp_path / "j"))
    pm2.fit(x, y, batch_size=BATCH, nb_epoch=0)           # resume only
    _assert_same_bits(
        _port_state(pm2),
        peng.flatten_tree(jax.tree.map(np.asarray, jm2.net_state)))


def test_resume_restores_the_statistics_bit_for_bit(tmp_path):
    """A fit stopped after one epoch and resumed by a second model object
    from its snapshot ends on the bits (statistics and params) of the fit
    that ran both epochs at once."""
    x, y = _data(32)

    def fitted(epochs, path=None):
        pctx.init_zoo_context(conf={"zoo.seed": 0})
        peng.reset_uids()
        jeng.reset_uids()
        _, pm = _pair()
        pm.compile(optimizer="adam", loss="scce", lr=0.01)
        if path is not None:
            pm.set_checkpoint(path)
        pm.fit(x, y, batch_size=BATCH, nb_epoch=epochs, shuffle=False)
        return pm

    straight = fitted(2)
    fitted(1, str(tmp_path / "ckpt"))
    # resumes at epoch 1, then ``nb_epoch`` more (the JAX convention)
    resumed = fitted(1, str(tmp_path / "ckpt"))
    assert resumed.finished_epochs == 2
    _assert_same_bits(_port_state(resumed), _port_state(straight))
    _assert_same_bits(_port_params(resumed), _port_params(straight))


def test_statistics_through_the_npz_both_ways(tmp_path):
    """A JAX image classifier with BatchNorm saves its moving statistics
    as ``s_i`` in its ``.npz``; the port loads them, predicts as JAX
    does, and its own ``.npz`` loads in the JAX package."""
    _both_contexts()
    kw = dict(num_classes=3, input_shape=(32, 32, 3))
    jm = JImageClassifier("mobilenet-v2", **kw)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    jm.init_weights(sample_input=x[:2])
    jm.net_state = jax.tree.map(
        lambda a: jnp.asarray(rng.random(a.shape).astype(np.float32) + 0.5),
        jm.net_state)
    jpath = jm.save(str(tmp_path / "jax.npz"))
    pm = pzoo.load_model(jpath, device="cpu")
    assert type(pm) is PImageClassifier
    _assert_same_bits(_port_state(pm.model), peng.flatten_tree(
        jax.tree.map(np.asarray, jm.net_state)))
    np.testing.assert_allclose(pm.predict(x, batch_size=8),
                               np.asarray(jm.predict(x, batch_size=8)),
                               atol=1e-5, rtol=1e-4)
    ppath = pm.save(str(tmp_path / "port.npz"))
    j2 = jzoo.load_model(ppath)
    _assert_same_bits(peng.flatten_tree(jax.tree.map(np.asarray,
                                                     j2.net_state)),
                      _port_state(pm.model))
