"""Core layers — port of ``analytics_zoo_tpu/pipeline/api/keras/layers/
core.py``: ``Activation``, ``Dense`` (with the static-int8
``quantized_call``), ``Dropout``, ``Flatten``, ``Reshape``, ``Permute``,
``RepeatVector``, ``Merge``/``merge``, ``Select``, ``Squeeze``,
``ExpandDim``, ``Narrow``, ``Masking``, ``GaussianNoise``,
``GaussianDropout``, ``TimeDistributed``, ``Highway`` and
``SparseDense``. Each states its output-shape rule. The noise layers draw
on the input's device from the step's generator (``common/noise.py``);
at inference they are the identity."""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .....common.noise import noise_generator
from .....ops.pallas.quantized import (STATIC_MAX_M, int8_matmul,
                                       static_int8_dense,
                                       static_int8_dense_reference)
from ..engine import (Layer, compute_dtype, get_initializer, param_dtype,
                      squeeze_dim)


def _hard_sigmoid(x):
    # Keras-1's clip(0.2 x + 0.5, 0, 1), not jax.nn's relu6(x + 3) / 6
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def _softplus(x):
    # jax.nn.softplus: logaddexp(x, 0)
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


ACTIVATIONS: Dict[str, Callable] = {
    "relu": torch.relu,
    "relu6": F.relu6,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": _hard_sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    "softplus": _softplus,
    "softsign": lambda x: x / (1 + torch.abs(x)),
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu default
    "swish": F.silu,
    "silu": F.silu,
    "linear": lambda x: x,
    "exp": torch.exp,
}


def get_activation(act: Union[str, Callable, None]) -> Optional[Callable]:
    if act is None or callable(act):
        return act
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation: {act}")
    return ACTIVATIONS[act]


def dense(x: torch.Tensor, W: torch.Tensor, b: Optional[torch.Tensor],
          cd: torch.dtype, scale: Optional[torch.Tensor] = None,
          relu: bool = False) -> torch.Tensor:
    """``x @ W`` accumulated in f32 and rounded to ``cd``, THEN the bias
    added in ``cd`` — the JAX package's rounding order — then, with
    ``relu``, ``torch.relu``. ``F.linear`` with a bias would add it to the
    f32 accumulator before the one rounding, which differs in bf16.

    An int8 ``W`` (weight-only int8 inference) comes with its per-column
    f32 ``scale`` and goes through K6, :func:`int8_matmul`, in its
    dequantize-first mode: each weight ``q * s`` is formed in ``cd`` (``s``
    rounded to ``cd`` first) before the f32 product rounds once to ``cd``,
    which is what the JAX predict's ``dequantize_int8`` followed by the
    matmul computes. (K6's default, the Pallas contract, scales after the
    reduction; in bf16 that differs by up to half a step per column.) The
    bias and the ReLU go to K6 too, which adds them in the same order (in
    its kernel for at most 32 rows, the JAX predict's XLA fusion; as torch
    ops after its other kernels). An int8 ``W`` without a scale raises:
    read as a float it would be the unscaled integers."""
    if W.dtype == torch.int8:
        if scale is None:
            raise ValueError("dense: an int8 W needs its per-column scale")
        lead = x.shape[:-1]
        y = int8_matmul(x.to(cd).reshape(-1, x.shape[-1]), W, scale,
                        True, bias=b, relu=relu)   # dequantize first
        return y.reshape(*lead, W.shape[1])
    y = torch.matmul(x.to(cd), W.to(cd))
    if b is not None:
        y = y + b.to(cd)
    if relu:
        y = torch.relu(y)
    return y


class Activation(Layer):
    """``keras/layers/Activation.scala``: ``activation`` by name (or a
    callable) on the input."""

    def __init__(self, activation: Union[str, Callable], **kwargs):
        super().__init__(**kwargs)
        self.fn = get_activation(activation)

    def compute_output_shape(self, input_shape):
        return input_shape

    def call(self, x, *, training=False, generator=None):
        return self.fn(x)


class Dense(Layer):
    """Fully connected — ``Dense(output_dim, init, activation, bias)``.
    ``W`` is ``(d_in, d_out)`` as in the JAX package."""

    def __init__(self, output_dim: int, init: str = "glorot_uniform",
                 activation=None, bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.output_dim = output_dim
        self.init = init
        self.activation = get_activation(activation)
        self.bias = bias

    def build(self, input_shape, *, generator):
        shape = (input_shape[-1], self.output_dim)
        self.add_weight("W", get_initializer(self.init)(
            generator, shape, param_dtype()))
        if self.bias:
            self.add_weight("b", torch.zeros(self.output_dim,
                                             dtype=param_dtype()))

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)

    def call(self, x, *, training=False, generator=None):
        # an int8 W hands its ReLU to K6 with the bias (the fused epilogue)
        fused = (self.activation is ACTIVATIONS["relu"]
                 and self.W.dtype == torch.int8)
        y = dense(x, self.W, self.b if self.bias else None, compute_dtype(),
                  getattr(self, "w_scale", None), relu=fused)
        if self.activation is not None and not fused:
            y = self.activation(y)
        return y

    def quantized_call(self, x):
        """Static int8 path (the inference runtime installs ``W`` as int8
        beside ``w_scale`` and the calibrated ``x_scale``): the activations
        quantize to ``x_scale`` (a division, round half to even, clip to
        +-127), the int8 x int8 product is exact in int32, and one f32
        rescale by ``x_scale * w_scale`` restores float before the f32
        bias and the activation — the JAX package's order. Up to
        ``STATIC_MAX_M`` rows all of it but an activation other than ReLU
        runs in Q8 (:func:`static_int8_dense`; its plain version on the
        CPU); more rows take the plain version, whose product is the
        padded ``torch._int_mm``."""
        relu = self.activation is ACTIVATIONS["relu"]
        b = self.b if self.bias else None
        rows = math.prod(x.shape[:-1])
        op = (static_int8_dense if rows <= STATIC_MAX_M
              else static_int8_dense_reference)
        y = op(x, self.x_scale, self.W, self.w_scale, b, relu)
        if self.activation is not None and not relu:
            y = self.activation(y)
        return y


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], training: bool):
    """Inverted dropout drawn from ``generator`` (the step's generator,
    ``common/noise.py``; the mask is drawn on ``x``'s device); identity at
    inference."""
    if not training or rate <= 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=noise_generator(generator,
                                                         x.device),
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device)
                       ).to(x.dtype)


class Dropout(Layer):
    """Inverted dropout, active only in training."""

    def __init__(self, p: float, **kwargs):
        super().__init__(**kwargs)
        self.p = p

    def compute_output_shape(self, input_shape):
        return input_shape

    def call(self, x, *, training=False, generator=None):
        if training and self.p > 0.0 and generator is None:
            raise ValueError(f"{self.name}: training dropout needs a "
                             f"generator")
        return dropout(x, self.p, generator, training)


def _fold(fn, xs):
    out = xs[0]
    for x in xs[1:]:
        out = fn(out, x)
    return out


def _unit_rows(a):
    return a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-8)


#: Merge modes, the JAX package's formulas and orders of operation
MERGE_MODES: Dict[str, Callable] = {
    "sum": lambda xs: _fold(torch.add, xs),
    "mul": lambda xs: _fold(torch.mul, xs),
    "ave": lambda xs: sum(xs) / len(xs),
    "max": lambda xs: _fold(torch.maximum, xs),
    "min": lambda xs: _fold(torch.minimum, xs),
    "dot": lambda xs: torch.sum(xs[0] * xs[1], dim=-1, keepdim=True),
    "cos": lambda xs: torch.sum(_unit_rows(xs[0]) * _unit_rows(xs[1]),
                                dim=-1, keepdim=True),
}


class Merge(Layer):
    """``keras/layers/Merge.scala``: combines a list of inputs. Modes:
    sum, mul, ave, max, min, concat, dot, cos."""

    def __init__(self, mode: str = "sum", concat_axis: int = -1, **kwargs):
        super().__init__(**kwargs)
        if mode != "concat" and mode not in MERGE_MODES:
            raise ValueError(f"unknown merge mode {mode}")
        self.mode = mode
        self.concat_axis = concat_axis

    def compute_output_shape(self, input_shape):
        first = tuple(input_shape[0])
        if self.mode == "concat":
            axis = self.concat_axis % len(first)
            return first[:axis] + (sum(s[axis] for s in input_shape),) \
                + first[axis + 1:]
        if self.mode in ("dot", "cos"):
            return first[:-1] + (1,)
        return first

    def call(self, xs, *, training=False, generator=None):
        if not isinstance(xs, (list, tuple)):
            raise ValueError(f"{self.name}: Merge expects a list of inputs")
        if self.mode == "concat":
            return torch.cat(list(xs), dim=self.concat_axis)
        return MERGE_MODES[self.mode](list(xs))


def merge(inputs, mode: str = "sum", concat_axis: int = -1, name=None):
    """Functional helper mirroring pyzoo's ``merge``."""
    return Merge(mode=mode, concat_axis=concat_axis, name=name)(inputs)


class Select(Layer):
    """``keras/layers/Select.scala``: index ``index`` of dimension ``dim``
    (0 = batch, negatives allowed), which drops that dimension. Integer
    inputs stay integer."""

    def __init__(self, dim: int, index: int, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
        self.index = index

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        del shape[self.dim]
        return tuple(shape)

    def call(self, x, *, training=False, generator=None):
        return torch.select(x, self.dim, self.index)


def _axis(dim: int, ndim: int) -> int:
    return dim + ndim if dim < 0 else dim


class Flatten(Layer):
    """``keras/layers/Flatten.scala``: ``(B, ...)`` to ``(B, prod)``."""

    def compute_output_shape(self, input_shape):
        return (input_shape[0], math.prod(input_shape[1:]))

    def call(self, x, *, training=False, generator=None):
        return x.reshape(x.shape[0], -1)


class Reshape(Layer):
    """``keras/layers/Reshape.scala``: ``target_shape`` excludes the batch
    dim (one ``-1`` allowed)."""

    def __init__(self, target_shape: Tuple[int, ...], **kwargs):
        super().__init__(**kwargs)
        self.target_shape = tuple(target_shape)

    def compute_output_shape(self, input_shape):
        target = list(self.target_shape)
        if -1 in target:
            known = math.prod(d for d in target if d != -1)
            target[target.index(-1)] = math.prod(input_shape[1:]) // known
        return (input_shape[0],) + tuple(target)

    def call(self, x, *, training=False, generator=None):
        return x.reshape((x.shape[0],) + self.target_shape)


class Permute(Layer):
    """``keras/layers/Permute.scala``: ``dims`` are the non-batch axes in
    their new order, counted from 1 (the batch axis stays first)."""

    def __init__(self, dims: Tuple[int, ...], **kwargs):
        super().__init__(**kwargs)
        self.dims = tuple(dims)

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + tuple(input_shape[d] for d in self.dims)

    def call(self, x, *, training=False, generator=None):
        return x.permute((0,) + self.dims)


class RepeatVector(Layer):
    """``keras/layers/RepeatVector.scala``: ``(B, D)`` to ``(B, n, D)``."""

    def __init__(self, n: int, **kwargs):
        super().__init__(**kwargs)
        self.n = n

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self.n) + tuple(input_shape[1:])

    def call(self, x, *, training=False, generator=None):
        return x.unsqueeze(1).repeat(1, self.n, *([1] * (x.dim() - 1)))


class Squeeze(Layer):
    """Drops dimension ``dim``, which must be 1 (``jnp.squeeze``)."""

    def __init__(self, dim: int, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        del shape[self.dim]
        return tuple(shape)

    def call(self, x, *, training=False, generator=None):
        return squeeze_dim(x, self.dim)


class ExpandDim(Layer):
    """Inserts a dimension of 1 at ``dim`` (``jnp.expand_dims``)."""

    def __init__(self, dim: int, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        shape.insert(_axis(self.dim, len(shape) + 1), 1)
        return tuple(shape)

    def call(self, x, *, training=False, generator=None):
        return x.unsqueeze(self.dim)


class Narrow(Layer):
    """``keras/layers/Narrow.scala``: ``length`` entries from ``offset``
    along ``dim`` (Python slice rules)."""

    def __init__(self, dim: int, offset: int, length: int = 1, **kwargs):
        super().__init__(**kwargs)
        self.dim, self.offset, self.length = dim, offset, length

    def _slice(self) -> slice:
        return slice(self.offset, self.offset + self.length)

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        axis = _axis(self.dim, len(shape))
        if shape[axis] is not None:
            shape[axis] = len(range(shape[axis])[self._slice()])
        return tuple(shape)

    def call(self, x, *, training=False, generator=None):
        sl = [slice(None)] * x.dim()
        sl[self.dim] = self._slice()
        return x[tuple(sl)]


class Masking(Layer):
    """``keras/layers/Masking.scala``: zeroes the timesteps whose every
    feature equals ``mask_value`` (soft masking, no ragged shapes)."""

    def __init__(self, mask_value: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.mask_value = mask_value

    def compute_output_shape(self, input_shape):
        return input_shape

    def call(self, x, *, training=False, generator=None):
        keep = torch.any(x != self.mask_value, dim=-1, keepdim=True)
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


def _normal_noise(x: torch.Tensor, generator: torch.Generator,
                  name: str) -> torch.Tensor:
    if generator is None:
        raise ValueError(f"{name}: training noise needs a generator")
    return torch.randn(x.shape, generator=noise_generator(generator,
                                                          x.device),
                       device=x.device, dtype=x.dtype)


class GaussianNoise(Layer):
    """``keras/layers/GaussianNoise.scala``: adds ``sigma`` times unit
    normal noise in training; the identity at inference."""

    def __init__(self, sigma: float, **kwargs):
        super().__init__(**kwargs)
        self.sigma = sigma

    def compute_output_shape(self, input_shape):
        return input_shape

    def call(self, x, *, training=False, generator=None):
        if not training:
            return x
        return x + self.sigma * _normal_noise(x, generator, self.name)


class GaussianDropout(Layer):
    """``keras/layers/GaussianDropout.scala``: multiplies by ``1 + s n``,
    ``s = sqrt(p / (1 - p))``, in training; the identity at inference."""

    def __init__(self, p: float, **kwargs):
        super().__init__(**kwargs)
        self.p = p

    def compute_output_shape(self, input_shape):
        return input_shape

    def call(self, x, *, training=False, generator=None):
        if not training or self.p <= 0:
            return x
        stddev = (self.p / (1.0 - self.p)) ** 0.5
        return x * (1.0 + stddev * _normal_noise(x, generator, self.name))


class TimeDistributed(Layer):
    """``keras/layers/TimeDistributed.scala``: the inner layer on every
    timestep, by folding time into the batch. The inner layer's weights
    and state nest under its name, as in the JAX param and state trees."""

    def __init__(self, layer: Layer, **kwargs):
        super().__init__(**kwargs)
        self._inner_name = layer.name
        self.add_module(layer.name, layer)

    @property
    def layer(self) -> Layer:
        return self._modules[self._inner_name]

    @staticmethod
    def _inner(input_shape):
        return (input_shape[0],) + tuple(input_shape[2:])

    def build(self, input_shape, *, generator):
        self.layer.build(self._inner(input_shape), generator=generator)

    def compute_output_shape(self, input_shape):
        out = self.layer.compute_output_shape(self._inner(input_shape))
        return (input_shape[0], input_shape[1]) + tuple(out[1:])

    def call(self, x, *, training=False, generator=None):
        b, t = x.shape[0], x.shape[1]
        y = self.layer(x.reshape((b * t,) + tuple(x.shape[2:])),
                       training=training, generator=generator)
        return y.reshape((b, t) + tuple(y.shape[1:]))


def _promoted_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype, as jnp's ``@`` computes it."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


class Highway(Layer):
    """``keras/layers/Highway.scala``: ``t h + (1 - t) x`` with the
    transform gate ``t = sigmoid(x W_t + b_t)`` (``b_t`` starts at -2)
    and ``h = activation(x W + b)``."""

    def __init__(self, activation="tanh", bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.activation = get_activation(activation)
        self.bias = bias

    def build(self, input_shape, *, generator):
        d = input_shape[-1]
        init = get_initializer("glorot_uniform")
        self.add_weight("W", init(generator, (d, d), param_dtype()))
        self.add_weight("W_t", init(generator, (d, d), param_dtype()))
        if self.bias:
            self.add_weight("b", torch.zeros(d, dtype=param_dtype()))
            self.add_weight("b_t", torch.full((d,), -2.0,
                                              dtype=param_dtype()))

    def compute_output_shape(self, input_shape):
        return input_shape

    def call(self, x, *, training=False, generator=None):
        t = _promoted_matmul(x, self.W_t)
        h = _promoted_matmul(x, self.W)
        if self.bias:
            t = t + self.b_t
            h = h + self.b
        t = torch.sigmoid(t)
        if self.activation is not None:
            h = self.activation(h)
        return t * h + (1.0 - t) * x


class SparseDense(Layer):
    """``keras/layers/SparseDense.scala``: a dense layer on one-hot or
    multi-hot rows given as a dense 0/1 matrix — ``Dense``'s weights
    (``W``, ``b``) and product."""

    def __init__(self, output_dim: int, init="glorot_uniform",
                 activation=None, bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.output_dim, self.init = output_dim, init
        self.activation = get_activation(activation)
        self.bias = bias

    def build(self, input_shape, *, generator):
        self.add_weight("W", get_initializer(self.init)(
            generator, (input_shape[-1], self.output_dim), param_dtype()))
        if self.bias:
            self.add_weight("b", torch.zeros(self.output_dim,
                                             dtype=param_dtype()))

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)

    def call(self, x, *, training=False, generator=None):
        y = dense(x, self.W, self.b if self.bias else None, compute_dtype())
        return y if self.activation is None else self.activation(y)
