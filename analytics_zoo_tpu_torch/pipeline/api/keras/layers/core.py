"""Core layers — port of ``analytics_zoo_tpu/pipeline/api/keras/layers/
core.py``: ``Activation``, ``Dense`` (with the static-int8
``quantized_call``), ``Dropout``, ``Merge``/``merge`` and ``Select``."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch
import torch.nn.functional as F

from .....common.noise import noise_generator
from .....ops.pallas.quantized import int8_matmul
from ..engine import Layer, compute_dtype, get_initializer, param_dtype

ACTIVATIONS: Dict[str, Callable] = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu default
    "linear": lambda x: x,
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


def int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 ``xq (..., K)`` and ``wq (K, N)``
    through ``torch._int_mm`` (the JAX package leaves this product to XLA,
    not to a Pallas kernel). On CUDA ``_int_mm`` takes only M > 16 and K,
    N multiples of 8: rows and columns are zero-padded to that, which adds
    exact zeros, and the result is sliced back."""
    lead, k, n = xq.shape[:-1], xq.shape[-1], wq.shape[1]
    a = xq.reshape(-1, k)
    m = a.shape[0]
    if xq.device.type == "cuda":
        pk, pn = -k % 8, -n % 8
        pm = max(17 - m, 0)
        if pm or pk:
            a = F.pad(a, (0, pk, 0, pm))
        if pk or pn:
            wq = F.pad(wq, (0, pn, 0, pk))
    y = torch._int_mm(a.contiguous(), wq.contiguous())
    return y[:m, :n].reshape(*lead, n)


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
        bias and the activation — the JAX package's order."""
        xq = torch.clamp(torch.round(x.float() / self.x_scale), -127, 127
                         ).to(torch.int8)
        y = int8_product(xq, self.W).float() * (self.x_scale * self.w_scale)
        if self.bias:
            y = y + self.b
        if self.activation is not None:
            y = self.activation(y)
        return y


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], training: bool):
    """Inverted dropout drawn from ``generator`` (a CPU generator; the mask
    is drawn on ``x``'s device); identity at inference."""
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
