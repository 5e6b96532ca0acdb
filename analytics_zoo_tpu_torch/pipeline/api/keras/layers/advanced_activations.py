"""Advanced activation layers — port of ``analytics_zoo_tpu/pipeline/api/
keras/layers/advanced_activations.py`` (the reference's
``keras/layers/{LeakyReLU,ELU,PReLU,SReLU,ThresholdedReLU,RReLU,Softmax,
HardTanh,HardShrink,SoftShrink,Threshold,BinaryThreshold}.scala``): each
is one elementwise expression in the JAX package's form.

The learnable ones (``PReLU``, ``SReLU``) keep per-channel parameters
under the JAX keys (``alpha``; ``t_left``, ``a_left``, ``t_right``,
``a_right``), so ``load_jax_params`` fills them name for name. ``RReLU``
draws its training slopes from the step's generator on the input's
device, as dropout does (``common/noise.py``), and uses the mean slope at
inference.
"""

from __future__ import annotations

import torch

from .....common.noise import noise_generator
from ..engine import Layer, param_dtype

__all__ = ["LeakyReLU", "ELU", "PReLU", "SReLU", "ThresholdedReLU", "RReLU",
           "Softmax", "HardTanh", "HardShrink", "SoftShrink", "Threshold",
           "BinaryThreshold"]


class _Elementwise(Layer):
    """A layer whose output has its input's shape."""

    def compute_output_shape(self, input_shape):
        return input_shape


class LeakyReLU(_Elementwise):
    """``LeakyReLU(alpha)``: x if x > 0 else alpha*x."""

    def __init__(self, alpha: float = 0.01, **kwargs):
        super().__init__(**kwargs)
        self.alpha = float(alpha)

    def call(self, x, *, training=False, generator=None):
        return torch.where(x > 0, x, self.alpha * x)


class ELU(_Elementwise):
    """``ELU(alpha)``: x if x > 0 else alpha*(exp(x)-1)."""

    def __init__(self, alpha: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.alpha = float(alpha)

    def call(self, x, *, training=False, generator=None):
        return torch.where(x > 0, x, self.alpha * torch.expm1(x))


class PReLU(_Elementwise):
    """``PReLU.scala`` — learnable per-channel negative slope (init 0.25)."""

    def build(self, input_shape, *, generator):
        ch = input_shape[-1]
        self.add_weight("alpha", torch.full((ch,), 0.25,
                                            dtype=param_dtype()))

    def call(self, x, *, training=False, generator=None):
        a = self.alpha.to(x.dtype)
        return torch.where(x > 0, x, a * x)


class SReLU(_Elementwise):
    """``SReLU.scala`` — s-shaped ReLU with 4 learnable per-channel params:
    y = t_r + a_r(x - t_r) for x >= t_r; x in between; t_l + a_l(x - t_l)
    for x <= t_l."""

    def build(self, input_shape, *, generator):
        ch = input_shape[-1]
        for key, fill in (("t_left", 0.0), ("a_left", 0.0),
                          ("t_right", 1.0), ("a_right", 1.0)):
            self.add_weight(key, torch.full((ch,), fill,
                                            dtype=param_dtype()))

    def call(self, x, *, training=False, generator=None):
        tl, al, tr, ar = (p.to(x.dtype) for p in (
            self.t_left, self.a_left, self.t_right, self.a_right))
        y = torch.where(x >= tr, tr + ar * (x - tr), x)
        return torch.where(x <= tl, tl + al * (x - tl), y)


class ThresholdedReLU(_Elementwise):
    """``ThresholdedReLU(theta)``: x if x > theta else 0."""

    def __init__(self, theta: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.theta = float(theta)

    def call(self, x, *, training=False, generator=None):
        return torch.where(x > self.theta, x, torch.zeros_like(x))


class RReLU(_Elementwise):
    """``RReLU(lower, upper)`` — randomized leaky: training samples the
    negative slope ~ U(lower, upper) per element from the step's
    generator; inference (or no generator) uses the mean."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 **kwargs):
        super().__init__(**kwargs)
        self.lower, self.upper = float(lower), float(upper)

    def call(self, x, *, training=False, generator=None):
        if training and generator is not None:
            u = torch.rand(x.shape, generator=noise_generator(generator,
                                                              x.device),
                           device=x.device, dtype=x.dtype)
            a = self.lower + (self.upper - self.lower) * u
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, a * x)


class Softmax(_Elementwise):
    """``Softmax.scala`` as a standalone layer (last axis)."""

    def call(self, x, *, training=False, generator=None):
        return torch.softmax(x, dim=-1)


class HardTanh(_Elementwise):
    """``HardTanh(min_value, max_value)``: clip."""

    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 **kwargs):
        super().__init__(**kwargs)
        self.min_value, self.max_value = float(min_value), float(max_value)

    def call(self, x, *, training=False, generator=None):
        return torch.clamp(x, self.min_value, self.max_value)


class HardShrink(_Elementwise):
    """``HardShrink(value)``: x if |x| > value else 0."""

    def __init__(self, value: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.value = float(value)

    def call(self, x, *, training=False, generator=None):
        return torch.where(torch.abs(x) > self.value, x, torch.zeros_like(x))


class SoftShrink(_Elementwise):
    """``SoftShrink(value)``: x -/+ value outside the band, 0 inside."""

    def __init__(self, value: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.value = float(value)

    def call(self, x, *, training=False, generator=None):
        return torch.where(x > self.value, x - self.value,
                           torch.where(x < -self.value, x + self.value,
                                       torch.zeros_like(x)))


class Threshold(_Elementwise):
    """``Threshold(th, v)``: x if x > th else v."""

    def __init__(self, th: float = 1e-6, v: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.th, self.v = float(th), float(v)

    def call(self, x, *, training=False, generator=None):
        return torch.where(x > self.th, x, torch.full_like(x, self.v))


class BinaryThreshold(_Elementwise):
    """``BinaryThreshold(th)``: 1 where x > th else 0."""

    def __init__(self, th: float = 1e-6, **kwargs):
        super().__init__(**kwargs)
        self.th = float(th)

    def call(self, x, *, training=False, generator=None):
        return (x > self.th).to(x.dtype)
