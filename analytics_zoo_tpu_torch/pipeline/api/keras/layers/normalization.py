"""Normalization — port of ``analytics_zoo_tpu/pipeline/api/keras/layers/
normalization.py``: ``BatchNormalization``, ``LayerNorm`` and
``L2Normalize``."""

from __future__ import annotations

import torch

from ..engine import Layer, emit_state, param_dtype


class BatchNormalization(Layer):
    """``BatchNormalization(epsilon, momentum, axis, scale, center)``
    (``BatchNormalization.scala``) over the channel axis (the last by
    default: NHWC). Its moving statistics are model state the training
    step writes, under the JAX ``net_state`` keys ``moving_mean`` and
    ``moving_var`` (f32 buffers, :meth:`Layer.add_state` with
    ``written``).

    The JAX rule, not PyTorch's: in training the batch mean and the
    **biased** variance (f32) normalise, and the new moving statistics
    ``m * moving + (1 - m) * batch`` (``m = momentum``, 0.99) go to the
    step (:func:`emit_state`), which commits them after its update; at
    inference the moving statistics normalise. The output is
    ``(x - mean) * rsqrt(var + eps) * gamma + beta`` with each factor cast
    to ``x``'s dtype first, as the JAX layer computes it.
    ``nn.BatchNorm2d`` would update with the unbiased variance, and in
    place during the forward."""

    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 axis: int = -1, scale: bool = True, center: bool = True,
                 **kwargs):
        super().__init__(**kwargs)
        self.epsilon = epsilon
        self.momentum = momentum
        self.axis = axis
        self.scale = scale
        self.center = center

    def build(self, input_shape, *, generator):
        d = input_shape[self.axis]
        if self.scale:
            self.add_weight("gamma", torch.ones(d, dtype=param_dtype()))
        if self.center:
            self.add_weight("beta", torch.zeros(d, dtype=param_dtype()))
        self.add_state("moving_mean", torch.zeros(d), written=True)
        self.add_state("moving_var", torch.ones(d), written=True)

    def compute_output_shape(self, input_shape):
        return input_shape

    def call(self, x, *, training=False, generator=None):
        axis = self.axis % x.dim()
        reduce = tuple(i for i in range(x.dim()) if i != axis)
        bshape = tuple(x.shape[axis] if i == axis else 1
                       for i in range(x.dim()))
        if training:
            xf = x.float()
            mean = xf.mean(dim=reduce)
            var = xf.var(dim=reduce, unbiased=False)
            m = self.momentum
            emit_state(self, "moving_mean",
                       m * self.moving_mean + (1 - m) * mean)
            emit_state(self, "moving_var",
                       m * self.moving_var + (1 - m) * var)
        else:
            mean, var = self.moving_mean, self.moving_var
        inv = torch.rsqrt(var + self.epsilon)
        y = ((x - mean.to(x.dtype).reshape(bshape))
             * inv.to(x.dtype).reshape(bshape))
        if self.scale:
            y = y * self.gamma.to(x.dtype).reshape(bshape)
        if self.center:
            y = y + self.beta.to(x.dtype).reshape(bshape)
        return y


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
