"""Element-wise and tensor-op layers — port of ``analytics_zoo_tpu/
pipeline/api/keras/layers/elementwise.py``: ``AddConstant``,
``MulConstant``, ``Negative``, ``Power``, ``Exp``, ``Log``, ``Sqrt``,
``Square``, ``Mul``, ``CAdd``, ``CMul``, ``Scale``, ``Max``, ``Expand``,
``GaussianSampler`` and ``ResizeBilinear``. Each computes in its input's
dtype, as the JAX layers do; dims count the batch as 0.

``ResizeBilinear`` is ``jax.image.resize(..., "bilinear")``, whose
``antialias`` is on: downsampling widens the triangle filter by the
scale. The port writes JAX's interpolation weights out per resized axis
(:func:`resize_weights`, the formula of ``jax.image``'s
``compute_weight_mat``) and applies them as one product per axis.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from ..engine import Layer, param_dtype
from .core import _normal_noise

__all__ = ["AddConstant", "MulConstant", "Negative", "Power", "Exp", "Log",
           "Sqrt", "Square", "Mul", "CAdd", "CMul", "Scale", "Max",
           "Expand", "GaussianSampler", "ResizeBilinear", "resize_weights"]


class _SameShape(Layer):
    def compute_output_shape(self, input_shape):
        return input_shape


class AddConstant(_SameShape):
    def __init__(self, constant: float, **kwargs):
        super().__init__(**kwargs)
        self.constant = float(constant)

    def call(self, x, *, training=False, generator=None):
        return x + self.constant


class MulConstant(_SameShape):
    def __init__(self, constant: float, **kwargs):
        super().__init__(**kwargs)
        self.constant = float(constant)

    def call(self, x, *, training=False, generator=None):
        return x * self.constant


class Negative(_SameShape):
    def call(self, x, *, training=False, generator=None):
        return -x


class Power(_SameShape):
    """``Power(power, scale, shift)``: ``(shift + scale x) ** power``."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0,
                 **kwargs):
        super().__init__(**kwargs)
        self.power, self.scale, self.shift = (float(power), float(scale),
                                              float(shift))

    def call(self, x, *, training=False, generator=None):
        return torch.pow(self.shift + self.scale * x, self.power)


class Exp(_SameShape):
    def call(self, x, *, training=False, generator=None):
        return torch.exp(x)


class Log(_SameShape):
    def call(self, x, *, training=False, generator=None):
        return torch.log(x)


class Sqrt(_SameShape):
    def call(self, x, *, training=False, generator=None):
        return torch.sqrt(x)


class Square(_SameShape):
    def call(self, x, *, training=False, generator=None):
        return torch.square(x)


class Mul(_SameShape):
    """``Mul.scala``: one learnable scalar multiplier ``w``."""

    def build(self, input_shape, *, generator):
        self.add_weight("w", torch.ones(1, dtype=param_dtype()))

    def call(self, x, *, training=False, generator=None):
        return x * self.w.to(x.dtype)


class CAdd(_SameShape):
    """``CAdd(size)``: a learnable ``bias`` of ``size``, broadcast-added."""

    def __init__(self, size: Sequence[int], **kwargs):
        super().__init__(**kwargs)
        self.size = tuple(int(s) for s in size)

    def build(self, input_shape, *, generator):
        self.add_weight("bias", torch.zeros(self.size, dtype=param_dtype()))

    def call(self, x, *, training=False, generator=None):
        return x + self.bias.to(x.dtype)


class CMul(_SameShape):
    """``CMul(size)``: a learnable ``weight`` of ``size``,
    broadcast-multiplied."""

    def __init__(self, size: Sequence[int], **kwargs):
        super().__init__(**kwargs)
        self.size = tuple(int(s) for s in size)

    def build(self, input_shape, *, generator):
        self.add_weight("weight", torch.ones(self.size, dtype=param_dtype()))

    def call(self, x, *, training=False, generator=None):
        return x * self.weight.to(x.dtype)


class Scale(_SameShape):
    """``Scale(size)``: ``CMul`` then ``CAdd``; ``init_weight`` is the
    multiplier's start (SSD's conv4_3 norm starts at 20)."""

    def __init__(self, size: Sequence[int], init_weight: float = 1.0,
                 **kwargs):
        super().__init__(**kwargs)
        self.size = tuple(int(s) for s in size)
        self.init_weight = float(init_weight)

    def build(self, input_shape, *, generator):
        self.add_weight("weight", torch.full(self.size, self.init_weight,
                                             dtype=param_dtype()))
        self.add_weight("bias", torch.zeros(self.size, dtype=param_dtype()))

    def call(self, x, *, training=False, generator=None):
        return x * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class Max(Layer):
    """``Max(dim)``: the maximum over dimension ``dim`` (0 = batch)."""

    def __init__(self, dim: int, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        del shape[self.dim]
        return tuple(shape)

    def call(self, x, *, training=False, generator=None):
        return torch.amax(x, dim=self.dim)


class Expand(Layer):
    """``Expand``: singleton dims broadcast up to ``shape`` (without the
    batch dim)."""

    def __init__(self, shape: Sequence[int], **kwargs):
        super().__init__(**kwargs)
        self.shape = tuple(int(s) for s in shape)

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + self.shape

    def call(self, x, *, training=False, generator=None):
        return x.expand((x.shape[0],) + self.shape)


class GaussianSampler(Layer):
    """``GaussianSampler.scala``, the VAE reparameterisation: ``[mean,
    log_var]`` → ``mean + exp(log_var / 2) eps``, ``eps`` drawn on the
    input's device from the step's generator; ``mean`` when no generator
    is given (inference)."""

    def compute_output_shape(self, input_shape):
        return input_shape[0]

    def call(self, x, *, training=False, generator=None):
        mean, log_var = x
        if generator is None:
            return mean
        eps = _normal_noise(mean, generator, self.name)
        return mean + torch.exp(0.5 * log_var) * eps


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """The ``(n_in, n_out)`` f32 weights that ``jax.image.resize``'s
    antialiased triangle kernel gives one axis (``compute_weight_mat`` at
    scale ``n_out / n_in``, no translation): half-pixel sample centres,
    the kernel widened by ``1 / scale`` when downsampling, each output's
    weights normalised to sum to 1."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = np.maximum(inv_scale, f32(1.0))
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.0) - f32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
         / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


class ResizeBilinear(Layer):
    """``ResizeBilinear(output_height, output_width)``: a channels-last
    bilinear resize, ``jax.image.resize(x, ..., "bilinear")`` (half-pixel
    centres, antialiased when downsampling): one product with
    :func:`resize_weights` for each axis whose size changes, in the
    input's (floating) dtype."""

    def __init__(self, output_height: int, output_width: int, **kwargs):
        super().__init__(**kwargs)
        self.output_height = int(output_height)
        self.output_width = int(output_width)
        self._weights: Dict[Tuple[Any, ...], torch.Tensor] = {}

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self.output_height, self.output_width,
                input_shape[3])

    def _axis_weights(self, n_in, n_out, like):
        key = (n_in, n_out, like.device, like.dtype)
        w = self._weights.get(key)
        if w is None:
            w = self._weights[key] = torch.from_numpy(
                resize_weights(n_in, n_out)).to(like.device, like.dtype)
        return w

    def call(self, x, *, training=False, generator=None):
        if not x.is_floating_point():
            x = x.float()
        h, w = x.shape[1], x.shape[2]
        if h != self.output_height:
            x = torch.einsum("bhwc,hk->bkwc", x, self._axis_weights(
                h, self.output_height, x))
        if w != self.output_width:
            x = torch.einsum("bhwc,wk->bhkc", x, self._axis_weights(
                w, self.output_width, x))
        return x
