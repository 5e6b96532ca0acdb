"""Autograd op library and ``CustomLoss`` — port of ``analytics_zoo_tpu/
pipeline/api/autograd.py`` (``pipeline/api/autograd/math.scala:32-365``
and ``CustomLoss.scala`` of the reference).

Each op is a ``Lambda`` graph node over ``Variable`` handles, named by the
JAX package's prefix (``abs_``, ``sum_``, ``mm_``, ...), so an autograd
expression is a graph like any other. Ops take ``Variable``s or plain
constants. The functions are torch ops on the node's input tensors; they
read nothing back to the host, so a ``CustomLoss`` runs inside a captured
training step (``zoo.train.scan_steps``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .keras.engine import (Input, Lambda, Model, Variable, graph_op,
                           unique_name)

__all__ = ["abs", "sum", "clip", "square", "sqrt", "maximum", "mean", "log",
           "epsilon", "exp", "pow", "softsign", "softplus", "stack",
           "expand_dims", "contiguous", "mm", "l2_normalize", "batch_dot",
           "erf", "CustomLoss"]


def _unary(v: Variable, fn: Callable, name: str) -> Variable:
    return Lambda(fn, name=unique_name(name + "_"))(v)


def _full_like(value, like: torch.Tensor):
    if isinstance(value, torch.Tensor):
        return value
    return torch.full((), value, dtype=like.dtype, device=like.device)


def abs(v):  # noqa: A001 — mirrors the reference's op name
    return _unary(v, torch.abs, "abs")


def sum(v, axis: int = 0, keep_dims: bool = False):  # noqa: A001
    return _unary(v, lambda a: torch.sum(a, dim=axis, keepdim=keep_dims),
                  "sum")


def mean(v, axis: int = 0, keep_dims: bool = False):
    return _unary(v, lambda a: torch.mean(a, dim=axis, keepdim=keep_dims),
                  "mean")


def clip(v, min: float, max: float):  # noqa: A002
    return _unary(v, lambda a: torch.clamp(a, min, max), "clip")


def square(v):
    return _unary(v, torch.square, "square")


def sqrt(v):
    return _unary(v, torch.sqrt, "sqrt")


def log(v):
    return _unary(v, torch.log, "log")


def exp(v):
    return _unary(v, torch.exp, "exp")


def erf(v):
    return _unary(v, torch.special.erf, "erf")


def softsign(v):
    return _unary(v, lambda a: a / (1.0 + torch.abs(a)), "softsign")


def _softplus(a):
    # jax.nn.softplus: logaddexp(a, 0)
    return torch.clamp_min(a, 0) + torch.log1p(torch.exp(-torch.abs(a)))


def softplus(v):
    return _unary(v, _softplus, "softplus")


def maximum(a, b):
    return graph_op(a, b, lambda x, y: torch.maximum(
        _full_like(x, y), _full_like(y, x)), "maximum")


def pow(v, a: float):  # noqa: A001
    return _unary(v, lambda x: torch.pow(x, a), "pow")


def epsilon() -> float:
    """``AutoGrad.epsilon`` — the fuzz constant."""
    return 1e-7


def stack(inputs: Sequence[Variable], axis: int = 1) -> Variable:
    """``stack(inputs, axis)``: join along a new axis (default 1, after
    the batch)."""
    return Lambda(lambda *xs: torch.stack(xs, dim=axis),
                  name=unique_name("stack_"))(list(inputs))


def expand_dims(v, axis: int):
    return _unary(v, lambda a: torch.unsqueeze(a, axis), "expanddims")


def contiguous(v):
    """A layout no-op, kept for the API."""
    return _unary(v, lambda a: a.contiguous(), "contiguous")


def _dims(axis) -> list:
    return [int(a) for a in np.atleast_1d(axis)]


def mm(x, y, axes: Optional[Tuple[int, int]] = None):
    """``mm(x, y, axes)``: a matmul (default: x's last axis with y's
    first non-batch one), or a tensordot over ``axes``; f32 products
    rounded to x's dtype."""
    if axes is None:
        return graph_op(x, y, lambda a, b: torch.matmul(
            a.float(), b.float()).to(a.dtype), "mm")

    def f(a, b):
        return torch.tensordot(a.float(), b.float(),
                               dims=(_dims(axes[0]), _dims(axes[1]))
                               ).to(a.dtype)
    return graph_op(x, y, f, "mm")


def _unit(a: torch.Tensor, axis: int) -> torch.Tensor:
    return a / torch.clamp_min(
        torch.linalg.vector_norm(a, dim=axis, keepdim=True), 1e-12)


def batch_dot(x, y, axes: Tuple[int, int] = (2, 2), normalize: bool = False):
    """``batchDot(x, y, axes, normalize)``: per sample, x's axis
    ``axes[0]`` contracted with y's ``axes[1]`` (axes count the batch
    dim); ``normalize`` l2-normalizes along them first (cosine
    similarity). The result's dims are x's others, then y's."""

    def f(a, b):
        if normalize:
            a, b = _unit(a, axes[0]), _unit(b, axes[1])
        n = a.shape[0]
        am = torch.movedim(a.float(), axes[0], -1)    # (B, ..., K)
        bm = torch.movedim(b.float(), axes[1], 1)     # (B, K, ...)
        rest_a, rest_b = am.shape[1:-1], bm.shape[2:]
        out = torch.bmm(am.reshape(n, -1, am.shape[-1]),
                        bm.reshape(n, bm.shape[1], -1))
        return out.reshape((n,) + tuple(rest_a) + tuple(rest_b)).to(a.dtype)

    return graph_op(x, y, f, "batchdot")


def l2_normalize(v, axis: int):
    return _unary(v, lambda a: _unit(a, axis), "l2normalize")


class CustomLoss:
    """``CustomLoss.scala``: a loss defined as an autograd expression.

    >>> def rmse(y_true, y_pred):
    ...     return A.sqrt(A.mean(A.square(y_true - y_pred), axis=1))
    >>> model.compile(optimizer="adam", loss=CustomLoss(rmse, (1,)))

    ``loss_fn(y_true, y_pred)`` receives Variables of shape ``(batch,) +
    y_shape`` and returns a per-sample (or scalar) Variable; the loss is
    its mean. The expression is a graph ``Model`` run inside the step,
    on the device of its inputs."""

    def __init__(self, loss_fn: Callable[[Variable, Variable], Variable],
                 y_pred_shape: Tuple[int, ...],
                 y_true_shape: Optional[Tuple[int, ...]] = None):
        yt = Input(shape=tuple(y_true_shape or y_pred_shape))
        yp = Input(shape=tuple(y_pred_shape))
        out = loss_fn(yt, yp)
        if not isinstance(out, Variable):
            raise TypeError("loss_fn must return an autograd Variable")
        # the expression's nodes hold no weights: the graph is built (its
        # shapes walked) on the CPU and runs wherever its inputs are
        self._graph = Model([yt, yp], out, device="cpu")
        self._graph.init_weights(torch.Generator().manual_seed(0))

    def __call__(self, y_true, y_pred):
        return torch.mean(self._graph([y_true, y_pred]))
