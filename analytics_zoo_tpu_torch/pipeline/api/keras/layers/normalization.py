"""Normalization — port of ``LayerNorm`` and ``L2Normalize`` from
``analytics_zoo_tpu/pipeline/api/keras/layers/normalization.py``
(``BatchNormalization``, whose state the step updates, is not ported
yet)."""

from __future__ import annotations

import torch

from ..engine import Layer, param_dtype


class LayerNorm(Layer):
    """Normalize over the last axis: f32 statistics, result cast back to
    the input dtype."""

    def __init__(self, epsilon: float = 1e-5, **kwargs):
        super().__init__(**kwargs)
        self.epsilon = epsilon

    def build(self, input_shape, *, generator):
        d = input_shape[-1]
        self.add_weight("gamma", torch.ones(d, dtype=param_dtype()))
        self.add_weight("beta", torch.zeros(d, dtype=param_dtype()))

    def compute_output_shape(self, input_shape):
        return input_shape

    def call(self, x, *, training=False, generator=None):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.gamma + self.beta).to(x.dtype)


class L2Normalize(Layer):
    """autograd ``l2Normalize`` as a layer: ``x / sqrt(sum(x^2) + eps)``
    along ``axis``."""

    def __init__(self, axis: int = -1, epsilon: float = 1e-12, **kwargs):
        super().__init__(**kwargs)
        self.axis, self.epsilon = axis, epsilon

    def compute_output_shape(self, input_shape):
        return input_shape

    def call(self, x, *, training=False, generator=None):
        norm = torch.sqrt(torch.sum(x * x, dim=self.axis, keepdim=True)
                          + self.epsilon)
        return x / norm
