"""The port's convolution, padding, cropping, upsampling and pooling
layers against the JAX package's on the same weights and inputs.

Every layer runs as a case of one parametrised test per property: the
forward in f32 (1e-5: both sides sum in f32, in another order), the
gradients of ``sum(y * r)`` with respect to the input and every weight in
f32 (1e-4 of the largest value: the same sums in another order), and the
forward in bf16 (2e-2 relative, and of the largest value where values are
small: one bf16 rounding of the f32 sum). Weights come from the JAX
layer's ``build`` with every leaf redrawn from a numpy seed (biases too),
moved across with ``load_param_tree``. The cases include XLA's asymmetric
``SAME`` padding at stride 2 (the 7x7/2 stem pads (2, 3), the 3x3/2 pool
(0, 1)), dilation, ``depth_multiplier`` 2, ``Deconvolution2D`` with a
non-symmetric kernel and a stride above the kernel, the average pools'
true window counts and ``KMaxPooling`` with ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as pl

CASES = {
    # name: (constructor name, args, kwargs, input shape)
    "conv1d_same_s2": ("Convolution1D", (4, 3),
                       dict(border_mode="same", subsample_length=2),
                       (2, 9, 3)),
    "atrous1d": ("AtrousConvolution1D", (4, 3),
                 dict(atrous_rate=2, border_mode="same", activation="relu"),
                 (2, 10, 3)),
    "conv2d_valid": ("Convolution2D", (5, 3, 2), dict(), (2, 7, 6, 3)),
    "conv2d_same_s2": ("Convolution2D", (5, 3, 3),
                       dict(border_mode="same", subsample=(2, 2)),
                       (2, 9, 8, 3)),
    "stem_7x7_s2": ("Convolution2D", (4, 7, 7),
                    dict(border_mode="same", subsample=(2, 2),
                         activation="relu"), (2, 12, 12, 3)),
    "atrous2d": ("AtrousConvolution2D", (4, 3, 3),
                 dict(atrous_rate=(2, 2), border_mode="same"),
                 (2, 9, 9, 3)),
    "separable2d_dm2": ("SeparableConvolution2D", (6, 3, 3),
                        dict(depth_multiplier=2, border_mode="same",
                             subsample=(2, 2)), (2, 9, 8, 3)),
    "separable1d_dm2": ("SeparableConvolution1D", (5, 3),
                        dict(depth_multiplier=2, border_mode="same"),
                        (2, 9, 3)),
    "depthwise_dm2": ("DepthwiseConvolution2D", (3, 3),
                      dict(depth_multiplier=2, border_mode="same",
                           subsample=(2, 2)), (2, 9, 8, 3)),
    "deconv_3x2_s2": ("Deconvolution2D", (4, 3, 2),
                      dict(subsample=(2, 2)), (2, 5, 4, 3)),
    "deconv_2x1_s3": ("Deconvolution2D", (3, 2, 1),
                      dict(subsample=(3, 3), activation="tanh"),
                      (2, 4, 3, 2)),
    "zeropad1d": ("ZeroPadding1D", ((1, 2),), dict(), (2, 5, 3)),
    "zeropad2d": ("ZeroPadding2D", ((1, 2),), dict(), (2, 4, 5, 3)),
    "crop1d": ("Cropping1D", ((1, 2),), dict(), (2, 7, 3)),
    "crop2d": ("Cropping2D", (((1, 0), (0, 2)),), dict(), (2, 6, 7, 3)),
    "upsample1d": ("UpSampling1D", (3,), dict(), (2, 4, 3)),
    "upsample2d": ("UpSampling2D", ((2, 3),), dict(), (2, 3, 4, 2)),
    "locally1d": ("LocallyConnected1D", (4, 3),
                  dict(subsample_length=2), (2, 9, 3)),
    "share2d": ("ShareConvolution2D", (4, 3, 3),
                dict(pad_h=1, pad_w=2), (2, 6, 5, 3)),
    "maxpool1d_same": ("MaxPooling1D", (3, 2), dict(border_mode="same"),
                       (2, 8, 3)),
    "avgpool1d_same": ("AveragePooling1D", (3, 2),
                       dict(border_mode="same"), (2, 8, 3)),
    "maxpool2d_3x3_s2_same": ("MaxPooling2D", ((3, 3), (2, 2)),
                              dict(border_mode="same"), (2, 8, 8, 3)),
    "maxpool2d_valid": ("MaxPooling2D", ((2, 2),), dict(), (2, 7, 6, 3)),
    "avgpool2d_3x3_s1_same": ("AveragePooling2D", ((3, 3), (1, 1)),
                              dict(border_mode="same"), (2, 6, 5, 3)),
    "avgpool2d_3x3_s2_same": ("AveragePooling2D", ((3, 3), (2, 2)),
                              dict(border_mode="same"), (2, 8, 7, 3)),
    "avgpool2d_valid": ("AveragePooling2D", ((2, 2),), dict(),
                        (2, 6, 6, 3)),
    "maxpool3d_same": ("MaxPooling3D", ((2, 2, 2), (2, 2, 2)),
                       dict(border_mode="same"), (2, 5, 4, 3, 2)),
    "avgpool3d_same": ("AveragePooling3D", ((3, 3, 3), (2, 2, 2)),
                       dict(border_mode="same"), (2, 5, 4, 3, 2)),
    "gmax1d": ("GlobalMaxPooling1D", (), dict(), (2, 5, 3)),
    "gavg1d": ("GlobalAveragePooling1D", (), dict(), (2, 5, 3)),
    "gmax2d": ("GlobalMaxPooling2D", (), dict(), (2, 4, 5, 3)),
    "gavg2d": ("GlobalAveragePooling2D", (), dict(), (2, 4, 5, 3)),
    "gmax3d": ("GlobalMaxPooling3D", (), dict(), (2, 3, 4, 2, 3)),
    "gavg3d": ("GlobalAveragePooling3D", (), dict(), (2, 3, 4, 2, 3)),
    "kmax": ("KMaxPooling", (3,), dict(), (2, 7, 4)),
}


@pytest.fixture(autouse=True)
def policies():
    pctx.reset_zoo_context()
    yield
    pctx.reset_zoo_context()
    peng.set_policy()
    jeng.set_policy()


def _pair(name, dtype="float32"):
    """The JAX layer with redrawn weights, the port layer loaded with
    them, the input, and the weights."""
    cls, args, kwargs, shape = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    jlayer = getattr(jl, cls)(*args, **kwargs)
    tree = jlayer.build(jax.random.key(0), (None,) + shape[1:]) or {}
    tree = {k: rng.normal(size=np.shape(v)).astype(np.float32) * 0.5
            for k, v in tree.items()}
    player = getattr(pl, cls)(*args, **kwargs)
    player.build((None,) + shape[1:], generator=torch.Generator())
    peng.load_param_tree(player, tree)
    x = rng.normal(size=shape).astype(np.float32)
    return jlayer, player, tree, x


def _set_bf16():
    jeng.set_policy(compute_dtype=jnp.bfloat16)
    peng.set_policy(compute_dtype=torch.bfloat16)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_f32_matches_jax(name):
    jlayer, player, tree, x = _pair(name)
    want = np.asarray(jlayer.call(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x)))
    got = player(torch.from_numpy(x)).detach()
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    shape = player.compute_output_shape((None,) + x.shape[1:])
    assert tuple(shape[1:]) == want.shape[1:]


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_f32_match_jax(name):
    jlayer, player, tree, x = _pair(name)
    r = np.random.default_rng(7).normal(
        size=np.asarray(jlayer.call({k: jnp.asarray(v) for k, v
                                     in tree.items()}, jnp.asarray(x))
                        ).shape).astype(np.float32)

    def f(params, xx):
        return jnp.sum(jlayer.call(params, xx) * r)

    gp, gx = jax.grad(f, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (player(xt) * torch.from_numpy(r)).sum().backward()
    pairs = [(xt.grad, gx)] + [(getattr(player, k).grad, gp[k])
                               for k in tree]
    for got, want in pairs:
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * scale,
                                   rtol=1e-4)


#: JAX's CPU backend has no bf16 x bf16 -> f32 dot, which the JAX
#: LocallyConnected1D's einsum asks for, so that layer has no bf16 case
BF16_CASES = sorted(set(CASES) - {"locally1d"})


@pytest.mark.parametrize("name", BF16_CASES)
def test_forward_bf16_matches_jax(name):
    jlayer, player, tree, x = _pair(name)
    _set_bf16()
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jlayer.call({k: jnp.asarray(v) for k, v
                                   in tree.items()}, xb).astype(jnp.float32))
    got = player(torch.from_numpy(x).to(torch.bfloat16)).detach()
    assert got.dtype == torch.bfloat16
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2e-2 * scale, rtol=2e-2)


def test_same_padding_is_xla_asymmetric_split():
    """The pads the layers use are XLA's: the 7x7/2 stem at 112 pixels
    pads (2, 3), a 3x3/2 pool at 56 pads (0, 1), and stride 1 is
    symmetric."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.convolution \
        import same_pads
    assert same_pads(112, 7, 2) == (2, 3)
    assert same_pads(56, 3, 2) == (0, 1)
    assert same_pads(56, 3, 1) == (1, 1)
    assert same_pads(9, 3, 1, 2) == (2, 2)


def test_average_pool_divides_by_the_true_window_population():
    """A constant input stays constant under a SAME average pool only if
    every edge window divides by its own population, as the JAX layer
    does (``F.avg_pool2d``'s ``count_include_pad`` would give less at the
    edges)."""
    x = torch.full((1, 5, 6, 2), 3.0)
    y = pl.AveragePooling2D((3, 3), (2, 2), border_mode="same")(x)
    torch.testing.assert_close(y, torch.full_like(y, 3.0), rtol=0, atol=0)


def test_kmax_pooling_keeps_the_lower_index_among_ties():
    """``lax.top_k`` keeps the lower index among equal values; the port
    does too, and returns the kept values in their original order."""
    x = np.array([[[1.0], [5.0], [2.0], [5.0], [2.0], [5.0], [0.0]]],
                 np.float32)
    want = np.asarray(jl.KMaxPooling(4).call({}, jnp.asarray(x)))
    got = pl.KMaxPooling(4)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    # the three 5.0s and the first of the tied 2.0s (index 2, not 4), in
    # their original order
    np.testing.assert_array_equal(got[0, :, 0], [5.0, 2.0, 5.0, 5.0])
    xi = torch.from_numpy(x)
    xi[0, 4, 0] = 2.0 - 1e-6           # only the later 2.0 now loses
    np.testing.assert_array_equal(pl.KMaxPooling(4)(xi).numpy(), got)


def test_conv_kernels_are_channels_last_for_cudnn():
    """Each conv kernel is HWIO at the API and O-major in memory, so the
    OIHW view handed to cuDNN is ``channels_last`` and no layout copy runs
    per call; the values load from the JAX tree unchanged."""
    layer = pl.Convolution2D(8, 3, 3)
    layer.build((None, 9, 9, 4), generator=torch.Generator())
    w = layer.W
    assert tuple(w.shape) == (3, 3, 4, 8)
    assert w.permute(3, 2, 0, 1).is_contiguous(
        memory_format=torch.channels_last)
    tree = {"W": np.arange(3 * 3 * 4 * 8, dtype=np.float32).reshape(
        3, 3, 4, 8), "b": np.zeros(8, np.float32)}
    peng.load_param_tree(layer, tree)
    np.testing.assert_array_equal(layer.W.detach().numpy(), tree["W"])
    assert layer.W.permute(3, 2, 0, 1).is_contiguous(
        memory_format=torch.channels_last)


def test_conv_pool_stack_states_its_shapes_in_a_sequential():
    """A ``Sequential`` of the new layers builds from the first layer's
    ``input_shape`` and states every output shape without a forward."""
    net = peng.Sequential([
        pl.Convolution2D(4, 7, 7, subsample=(2, 2), border_mode="same",
                         input_shape=(20, 20, 3)),
        pl.BatchNormalization(),
        pl.MaxPooling2D((3, 3), (2, 2), border_mode="same"),
        pl.DepthwiseConvolution2D(3, 3, depth_multiplier=2,
                                  border_mode="same"),
        pl.AveragePooling2D((2, 2)),
        pl.Flatten(), pl.Dense(3)], device="cpu")
    net.init_weights(torch.Generator().manual_seed(0))
    want = net.compute_output_shape((None, 20, 20, 3))
    y = net(torch.zeros(2, 20, 20, 3))
    assert tuple(y.shape[1:]) == tuple(want[1:]) == (3,)
