"""The port's 3D convolution family, element-wise layers and
``feature/image3d`` held to the JAX package on numpy-seeded inputs and
transferred weights.

Every layer runs as a case of one parametrised test per property: the
forward in f32, the gradients of ``sum(y * r)`` with respect to the input
and every weight in f32, and the forward in bf16. Weights come from the
JAX layer's ``build`` with every leaf redrawn from a numpy seed, moved
across with ``load_param_tree``. The cases include XLA's asymmetric
``SAME`` pads (a 3x3x3 conv at stride 2, the ConvLSTMs' even kernel,
``WithinChannelLRN``'s even window), ``ResizeBilinear`` up and down (the
antialiased triangle), broadcast ``CAdd``/``CMul`` and both ConvLSTMs with
and without ``return_sequences``.

Tolerances, each with its reason:
* f32 forwards 1e-5 (the same formulas, the sums in another order);
* f32 gradients 1e-4 of the largest value (the same, in the backward);
* bf16 forwards 2e-2 relative, and of the largest value where values
  are small (the compute dtype's rounding of the same sums; the
  ConvLSTMs round their carry at every step in both packages);
* the image3d transforms bit for bit (the same numpy code);
* spatial dropout and ``GaussianSampler`` against JAX on the same masks
  and noise (fed to both), 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.feature import image3d as jimage3d
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.feature import image3d as pimage3d
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as pl
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.elementwise import \
    resize_weights

F32_OUT, F32_GRAD, BF16 = 1e-5, 1e-4, 2e-2


def _positive(x):
    return np.abs(x) + 0.1


CASES = {
    # name: (constructor, args, kwargs, input shape[, input map])
    "conv3d_valid": ("Convolution3D", (4, 2, 3, 3), {}, (2, 6, 7, 8, 3)),
    "conv3d_same_s2": ("Convolution3D", (4, 3, 3, 3),
                       dict(border_mode="same", subsample=(2, 2, 2),
                            activation="relu"), (2, 5, 6, 7, 2)),
    "zeropad3d": ("ZeroPadding3D", ((1, 2, 1),), {}, (2, 3, 4, 2, 2)),
    "crop3d": ("Cropping3D", (((1, 0), (0, 2), (1, 1)),), {},
               (2, 4, 5, 6, 2)),
    "upsample3d": ("UpSampling3D", ((2, 1, 3),), {}, (2, 2, 3, 2, 2)),
    "convlstm2d_seq": ("ConvLSTM2D", (3, 3), dict(return_sequences=True),
                       (2, 3, 5, 5, 2)),
    "convlstm2d_k2_last": ("ConvLSTM2D", (2, 2), {}, (2, 3, 4, 5, 1)),
    "convlstm3d_seq": ("ConvLSTM3D", (2, 3), dict(return_sequences=True),
                       (2, 2, 3, 4, 4, 1)),
    "convlstm3d_last": ("ConvLSTM3D", (2, 2), {}, (1, 2, 3, 3, 2, 2)),
    "locally2d_s21": ("LocallyConnected2D", (3, 2, 2),
                      dict(subsample=(2, 1), activation="tanh"),
                      (2, 5, 6, 2)),
    "maxout": ("MaxoutDense", (4, 3), {}, (3, 5)),
    "lrn2d": ("LRN2D", (), dict(alpha=1e-3, k=2.0, beta=0.75, n=5),
              (2, 5, 5, 8)),
    "within_lrn": ("WithinChannelLRN", (3, 0.8, 0.75), {}, (2, 7, 7, 3)),
    "within_lrn_even": ("WithinChannelLRN", (4,), {}, (2, 6, 5, 2)),
    "add_constant": ("AddConstant", (1.5,), {}, (2, 3, 4)),
    "mul_constant": ("MulConstant", (-2.0,), {}, (2, 3, 4)),
    "negative": ("Negative", (), {}, (2, 3, 4)),
    "power": ("Power", (2.0, 0.5, 1.0), {}, (2, 3, 4)),
    "power_sqrt": ("Power", (0.5, 1.0, 3.0), {}, (2, 3, 4)),
    "exp": ("Exp", (), {}, (2, 3, 4)),
    "log": ("Log", (), {}, (2, 3, 4), _positive),
    "sqrt": ("Sqrt", (), {}, (2, 3, 4), _positive),
    "square": ("Square", (), {}, (2, 3, 4)),
    "mul": ("Mul", (), {}, (2, 3, 4)),
    "cadd": ("CAdd", ((1, 4),), {}, (2, 3, 4)),
    "cmul": ("CMul", ((3, 1),), {}, (2, 3, 4)),
    "scale": ("Scale", ((4,),), dict(init_weight=2.0), (2, 3, 4)),
    "max_1": ("Max", (1,), {}, (2, 3, 4)),
    "max_last": ("Max", (-1,), {}, (2, 3, 4)),
    "expand": ("Expand", ((3, 4),), {}, (2, 1, 4)),
    "resize_up": ("ResizeBilinear", (6, 7), {}, (2, 3, 4, 2)),
    "resize_down": ("ResizeBilinear", (4, 3), {}, (2, 9, 10, 2)),
    "resize_mixed": ("ResizeBilinear", (5, 12), {}, (2, 5, 7, 3)),
}


@pytest.fixture(autouse=True)
def policies():
    pctx.reset_zoo_context()
    yield
    pctx.reset_zoo_context()
    peng.set_policy()
    jeng.set_policy()


def _pair(name):
    cls, args, kwargs, shape, *fn = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    jlayer = getattr(jl, cls)(*args, **kwargs)
    tree = jlayer.build(jax.random.key(0), (None,) + shape[1:]) or {}
    tree = {k: (rng.normal(size=np.shape(v)) * 0.5).astype(np.float32)
            for k, v in tree.items()}
    player = getattr(pl, cls)(*args, **kwargs)
    player.build((None,) + shape[1:], generator=torch.Generator())
    peng.load_param_tree(player, tree)
    x = rng.normal(size=shape).astype(np.float32)
    if fn:
        x = fn[0](x).astype(np.float32)
    return jlayer, player, tree, x


def _jcall(jlayer, tree, x):
    return jax.jit(jlayer.call)({k: jnp.asarray(v) for k, v in tree.items()},
                                x)


def _close(got, want, tol, scaled=False):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    atol = tol * max(1.0, float(np.abs(want).max())) if scaled else tol
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=atol,
                               rtol=tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_f32_matches_jax(name):
    jlayer, player, tree, x = _pair(name)
    want = np.asarray(_jcall(jlayer, tree, jnp.asarray(x)))
    got = player(torch.from_numpy(x)).detach()
    _close(got.numpy(), want, F32_OUT)
    shape = player.compute_output_shape((None,) + x.shape[1:])
    assert tuple(shape[1:]) == want.shape[1:]


#: layers with a gradient worth holding (a weight, or a non-trivial
#: input gradient)
GRAD_CASES = sorted(set(CASES) - {"zeropad3d", "crop3d", "negative",
                                  "add_constant", "mul_constant", "expand"})


@pytest.mark.parametrize("name", GRAD_CASES)
def test_gradients_f32_match_jax(name):
    jlayer, player, tree, x = _pair(name)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = player(xt)
    r = np.random.default_rng(7).normal(size=tuple(yt.shape)).astype(
        np.float32)
    (yt * torch.from_numpy(r)).sum().backward()

    def f(params, xx):
        return jnp.sum(jlayer.call(params, xx) * r)

    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x))
    _close(xt.grad.numpy(), gx, F32_GRAD, scaled=True)
    for k in tree:
        _close(getattr(player, k).grad.numpy(), gp[k], F32_GRAD, scaled=True)


#: JAX's CPU backend has no bf16 x bf16 -> f32 dot, which the JAX
#: LocallyConnected2D's and MaxoutDense's products ask for
BF16_CASES = sorted(set(CASES) - {"locally2d_s21", "maxout"})


@pytest.mark.parametrize("name", BF16_CASES)
def test_forward_bf16_matches_jax(name):
    jlayer, player, tree, x = _pair(name)
    jeng.set_policy(compute_dtype=jnp.bfloat16)
    peng.set_policy(compute_dtype=torch.bfloat16)
    want = np.asarray(_jcall(jlayer, tree, jnp.asarray(x).astype(
        jnp.bfloat16)).astype(jnp.float32))
    got = player(torch.from_numpy(x).to(torch.bfloat16)).detach()
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, BF16, scaled=True)


def test_resize_weights_are_jax_image_resizes():
    """Each axis's weights: resizing a one-hot column with
    ``jax.image.resize`` reads its row (up and down, odd and even)."""
    for n_in, n_out in ((3, 6), (9, 4), (10, 3), (5, 5), (7, 12), (4, 1)):
        eye = jnp.eye(n_in, dtype=jnp.float32)[:, :, None, None]
        want = np.asarray(jax.image.resize(eye, (n_in, n_out, 1, 1),
                                           "bilinear"))[:, :, 0, 0]
        np.testing.assert_allclose(resize_weights(n_in, n_out), want,
                                   atol=1e-7, rtol=0)


@pytest.mark.parametrize("cls,shape", [
    ("SpatialDropout1D", (4, 10, 3)), ("SpatialDropout2D", (3, 4, 5, 2)),
    ("SpatialDropout3D", (2, 3, 4, 2, 3))])
def test_spatial_dropout_matches_jax_on_the_same_mask(cls, shape,
                                                      monkeypatch):
    """One keep bit per (sample, channel), fed to both packages: the
    outputs agree; every (sample, channel) column is all zero or all
    scaled; inference and p = 0 are the identity."""
    p = 0.4
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    mshape = (shape[0],) + (1,) * (len(shape) - 2) + (shape[-1],)
    keep = np.random.default_rng(2).random(mshape) >= p
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda rng, q, s: jnp.asarray(keep))
    want = np.asarray(getattr(jl, cls)(p).call(
        {}, jnp.asarray(x), training=True, rng=jax.random.key(0)))
    real_rand = torch.rand

    def rand(size, generator=None, device=None, **kw):
        assert tuple(size) == mshape
        return torch.where(torch.from_numpy(keep), 0.0, 1.0)
    layer = getattr(pl, cls)(p)
    monkeypatch.setattr(torch, "rand", rand)
    got = layer(torch.from_numpy(x), training=True,
                generator=torch.Generator()).numpy()
    monkeypatch.setattr(torch, "rand", real_rand)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    axes = tuple(range(1, len(shape) - 1))
    np.testing.assert_array_equal(np.all(got == 0, axis=axes),
                                  ~keep.reshape(shape[0], shape[-1]))
    real = layer(torch.from_numpy(x), training=True,
                 generator=torch.Generator().manual_seed(3)).numpy()
    assert np.all((real == 0) | np.isclose(real, x / (1 - p)), axis=axes).all()
    np.testing.assert_array_equal(layer(torch.from_numpy(x)).numpy(), x)
    np.testing.assert_array_equal(getattr(pl, cls)(0.0)(
        torch.from_numpy(x), training=True,
        generator=torch.Generator()).numpy(), x)


def test_gaussian_sampler_matches_jax_on_the_same_noise(monkeypatch):
    """``mean + exp(log_var / 2) eps`` with the same ``eps`` fed to both;
    the mean without a generator (rng)."""
    rng = np.random.default_rng(4)
    mean, lv = (rng.normal(size=(3, 5)).astype(np.float32) for _ in "ab")
    eps = rng.normal(size=(3, 5)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(eps))
    want = np.asarray(jl.GaussianSampler().call(
        {}, [jnp.asarray(mean), jnp.asarray(lv)], rng=jax.random.key(0)))
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
        elementwise
    monkeypatch.setattr(elementwise, "_normal_noise",
                        lambda x, g, name: torch.from_numpy(eps))
    layer = pl.GaussianSampler()
    got = layer([torch.from_numpy(mean), torch.from_numpy(lv)],
                training=True, generator=torch.Generator()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        layer([torch.from_numpy(mean), torch.from_numpy(lv)]).numpy(), mean)
    assert layer.compute_output_shape([(None, 5), (None, 5)]) == (None, 5)


def test_convlstm_trains_in_a_sequential_as_jax_does():
    """``test_layers_extended.py``'s ConvLSTM2D task from the same
    weights: a ``Sequential`` of ``ConvLSTM2D``, ``GlobalAveragePooling2D``
    and ``Dense`` fits two Adam steps as the JAX one does."""
    from analytics_zoo_tpu.common import context as jctx
    jctx.init_zoo_context(conf={"zoo.seed": 0})
    pctx.init_zoo_context(conf={"zoo.seed": 0})
    rng = np.random.default_rng(7)
    x = rng.normal(size=(16, 3, 5, 5, 1)).astype(np.float32)
    y = rng.integers(0, 2, 16).astype(np.int32)

    def layers(L):
        return [L.ConvLSTM2D(3, 3, input_shape=(3, 5, 5, 1)),
                L.GlobalAveragePooling2D(), L.Dense(2, activation="softmax")]
    jm = jeng.Sequential(layers(jl))
    jm.init_weights(rng=jax.random.key(1))
    pm = peng.Sequential(layers(pl), device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
    jm.compile(optimizer="adam", loss="scce", lr=0.01)
    pm.compile(optimizer="adam", loss="scce", lr=0.01)
    want = jm.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)["loss"]
    got = pm.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)["loss"]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    jp = peng.flatten_tree(jax.tree.map(np.asarray, jm.params))
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   jp[n.replace(".", "/")], atol=1e-4,
                                   rtol=0, err_msg=n)
    jctx.reset_zoo_context()


# ---------------------------------------------------------------------------
# feature/image3d
# ---------------------------------------------------------------------------

def _vol(shape=(5, 6, 7, 2), seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(fn):
    """``fn(package)`` for the JAX package's image3d and the port's."""
    return fn(jimage3d), fn(pimage3d)


def _flow(seed=3):
    return np.random.default_rng(seed).normal(size=(3, 4, 5, 6)) * 1.5


TRANSFORMS = {
    "crop": lambda m: m.Crop3D((1, 1, 1), (3, 3, 4)),
    "center_crop": lambda m: m.CenterCrop3D(2, 4, 5),
    "random_crop": lambda m: m.RandomCrop3D(3, 3, 3, seed=1),
    "affine_clamp": lambda m: m.AffineTransform3D(
        np.asarray([[1.0, 0.1, 0.0], [0.0, 0.9, 0.2], [0.1, 0.0, 1.1]]),
        translation=(0.5, -1.0, 0.25)),
    "affine_padding": lambda m: m.AffineTransform3D(
        np.eye(3) * 1.3, translation=(1.0, 0.0, -2.0),
        clamp_mode="padding", pad_val=-7.0),
    "rotate": lambda m: m.Rotate3D([0.3, -0.2, math.pi / 3]),
    "rotate_padding": lambda m: m.Rotate3D([0.0, 0.5, 0.0],
                                           clamp_mode="padding"),
    "warp_offset": lambda m: m.Warp3D(_flow()),
    "warp_absolute_padding": lambda m: m.Warp3D(
        np.abs(_flow()) * 2 + 1, offset=False, clamp_mode="padding",
        pad_val=3.0),
    "chain": lambda m: m.CenterCrop3D(4, 4, 4) >> m.Rotate3D(
        [0.0, 0.0, 0.4]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_image3d_transforms_match_jax(name):
    """One volume (4, 5, 6, 2), a batch of three, a channel-less volume
    and a uint8 volume (rounded and clipped) through both packages'
    transform, bit for bit."""
    inputs = [_vol((4, 5, 6, 2)), _vol((3, 4, 5, 6, 1), seed=1),
              _vol((4, 5, 6), seed=2),
              (np.abs(_vol((4, 5, 6, 1), seed=3)) * 60).astype(np.uint8)]
    for v in inputs:
        want, got = _both(lambda m: TRANSFORMS[name](m).apply(v))
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_image3d_errors_and_lists_match_jax():
    v = _vol((6, 8, 10, 2))
    for m in (jimage3d, pimage3d):
        with pytest.raises(ValueError, match="exceeds"):
            m.CenterCrop3D(7, 4, 4).apply(v)
        with pytest.raises(ValueError, match="clamp_mode"):
            m.Warp3D(np.zeros((3, 4, 4, 4)), clamp_mode="pad")
        with pytest.raises(ValueError, match="flow shape"):
            m.Warp3D(np.zeros((3, 2, 2, 2))).apply(v)
    vols = [np.zeros((5, 5, 5), np.float32), np.ones((5, 5, 5), np.float32)]
    want, got = _both(lambda m: m.AffineTransform3D(np.eye(3)).apply(vols))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_image3d_imports_no_jax():
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, numpy as np\n"
        "import analytics_zoo_tpu_torch.feature.image3d as m\n"
        "import analytics_zoo_tpu_torch.pipeline.api.keras.layers."
        "convolution3d\n"
        "import analytics_zoo_tpu_torch.pipeline.api.keras.layers."
        "elementwise\n"
        "m.Rotate3D([0.1, 0.2, 0.3]).apply(np.ones((3, 3, 3, 1)))\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'analytics_zoo_tpu' or "
        "n.startswith('analytics_zoo_tpu.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = repo
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
