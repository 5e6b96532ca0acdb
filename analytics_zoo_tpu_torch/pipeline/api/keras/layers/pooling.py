"""Pooling layers — port of ``analytics_zoo_tpu/pipeline/api/keras/layers/
pooling.py``: the 1D, 2D and 3D max and average pools, their global forms
and ``KMaxPooling``. Each states its output-shape rule.

Channels-last at the API, as in the JAX package; each window runs through
``F.max_poolNd``/``F.avg_poolNd`` on the ``channels_last`` view of the
input (a 1D pool is the 2D one on a unit height). ``same`` padding is
XLA's ``reduce_window`` padding, asymmetric where the total is odd (``lo
= total // 2``, :func:`~.convolution.same_pads`), so it is padded
explicitly: ``-inf`` for the max pools, zeros for the sums. An average
pool divides the window's f32 sum by its true population, a sum pool over
ones on the same padding, as the JAX layers do: edge windows are smaller.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..engine import Layer
from ._shapes import pair as _pair
from ._shapes import triple as _triple
from .convolution import window_out, window_pads

_MAX = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pad_flat(pads):
    """``[(lo, hi)]`` in spatial order → ``F.pad``'s flat list (last dim
    first)."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


def _channels_first(x):
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _channels_last(y):
    return y.permute(0, *range(2, y.dim()), 1)


def _pool(x, window, strides, border_mode, kind):
    """``lax.reduce_window`` of max (``kind="max"``) or add (``"sum"``)
    over ``x (B, *spatial, C)``, ``window``/``strides`` per spatial dim."""
    flat = len(window) == 1
    if flat:      # 1D: the 2D pool on a unit height
        x, window, strides = x.unsqueeze(1), (1,) + window, (1,) + strides
    n = len(window)
    pads = window_pads(x.shape[1:1 + n], window, strides, border_mode)
    xc = _channels_first(x)
    if any(lo or hi for lo, hi in pads):
        xc = F.pad(xc, _pad_flat(pads),
                   value=float("-inf") if kind == "max" else 0.0)
    if kind == "max":
        y = _MAX[n](xc, window, strides)
    else:
        y = _AVG[n](xc, window, strides, divisor_override=1)
    y = _channels_last(y)
    return y.squeeze(1) if flat else y


def _avg(x, window, strides, border_mode):
    """The f32 window sums over the true window populations, in ``x``'s
    dtype."""
    s = _pool(x.float(), window, strides, border_mode, "sum")
    ones = torch.ones((1,) + tuple(x.shape[1:-1]) + (1,),
                      dtype=torch.float32, device=x.device)
    n = _pool(ones, window, strides, border_mode, "sum")
    return (s / n).to(x.dtype)


def _pooled_shape(input_shape, window, strides, border_mode):
    spatial = input_shape[1:1 + len(window)]
    return (input_shape[0],) + tuple(
        window_out(d, k, s, border_mode)
        for d, k, s in zip(spatial, window, strides)) + (input_shape[-1],)


class _Pool(Layer):
    """A window pool of ``pool_size`` and ``strides`` (default: the
    window) in ``border_mode``."""

    kind = "max"
    _norm = staticmethod(_pair)

    def __init__(self, pool_size=2, strides=None,
                 border_mode: str = "valid", **kwargs):
        super().__init__(**kwargs)
        self.pool_size = self._norm(pool_size)
        self.strides = (self._norm(strides) if strides is not None
                        else self.pool_size)
        self.border_mode = border_mode.upper()

    def compute_output_shape(self, input_shape):
        return _pooled_shape(input_shape, self.pool_size, self.strides,
                             self.border_mode)

    def call(self, x, *, training=False, generator=None):
        if self.kind == "max":
            return _pool(x, self.pool_size, self.strides, self.border_mode,
                         "max")
        return _avg(x, self.pool_size, self.strides, self.border_mode)


def _single(v) -> Tuple[int]:
    return (int(v),)


class _Pool1D(_Pool):
    _norm = staticmethod(_single)

    def __init__(self, pool_length: int = 2, stride: Optional[int] = None,
                 border_mode: str = "valid", **kwargs):
        super().__init__(pool_length, stride, border_mode, **kwargs)


class MaxPooling1D(_Pool1D):
    """``MaxPooling1D(pool_length, stride, border_mode)``."""


class AveragePooling1D(_Pool1D):
    """``AveragePooling1D(pool_length, stride, border_mode)``."""
    kind = "avg"


class MaxPooling2D(_Pool):
    """``MaxPooling2D(pool_size, strides, border_mode)`` —
    channels-last."""

    def __init__(self, pool_size: Tuple[int, int] = (2, 2),
                 strides: Optional[Tuple[int, int]] = None,
                 border_mode: str = "valid", **kwargs):
        super().__init__(pool_size, strides, border_mode, **kwargs)


class AveragePooling2D(MaxPooling2D):
    """``AveragePooling2D(pool_size, strides, border_mode)``."""
    kind = "avg"


class MaxPooling3D(_Pool):
    """``MaxPooling3D(pool_size, strides, border_mode)`` — (B, D, H, W,
    C)."""
    _norm = staticmethod(_triple)

    def __init__(self, pool_size: Tuple[int, int, int] = (2, 2, 2),
                 strides: Optional[Tuple[int, int, int]] = None,
                 border_mode: str = "valid", **kwargs):
        super().__init__(pool_size, strides, border_mode, **kwargs)


class AveragePooling3D(MaxPooling3D):
    """``AveragePooling3D(pool_size, strides, border_mode)``."""
    kind = "avg"


class _GlobalPool(Layer):
    """Max or mean over the ``ndim`` spatial axes."""

    ndim = 1
    kind = "max"

    def compute_output_shape(self, input_shape):
        return (input_shape[0], input_shape[-1])

    def call(self, x, *, training=False, generator=None):
        dims = tuple(range(1, 1 + self.ndim))
        if self.kind == "max":
            return torch.amax(x, dim=dims)
        return torch.mean(x, dim=dims)


class GlobalMaxPooling1D(_GlobalPool):
    pass


class GlobalAveragePooling1D(_GlobalPool):
    kind = "avg"


class GlobalMaxPooling2D(_GlobalPool):
    ndim = 2


class GlobalAveragePooling2D(_GlobalPool):
    ndim, kind = 2, "avg"


class GlobalMaxPooling3D(_GlobalPool):
    ndim = 3


class GlobalAveragePooling3D(_GlobalPool):
    ndim, kind = 3, "avg"


class KMaxPooling(Layer):
    """``KMaxPooling(k, dim)`` (``KMaxPooling.scala``) — the k largest
    values along ``dim`` (default: the time axis 1) in their original
    order. ``lax.top_k`` keeps the lower index among equal values, so the
    top k come from a stable descending sort; then they are re-sorted by
    index. Input (B, T, C) → (B, k, C)."""

    def __init__(self, k: int, dim: int = 1, **kwargs):
        super().__init__(**kwargs)
        if k < 1:
            raise ValueError(f"KMaxPooling needs k >= 1, got {k}")
        self.k = int(k)
        self.dim = int(dim)

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        shape[self.dim % len(shape)] = self.k
        return tuple(shape)

    def call(self, x, *, training=False, generator=None):
        axis = self.dim % x.dim()
        if x.shape[axis] < self.k:
            raise ValueError(f"KMaxPooling k={self.k} exceeds dim size "
                             f"{x.shape[axis]}")
        moved = x.movedim(axis, -1)
        idx = torch.sort(moved, dim=-1, descending=True,
                         stable=True).indices[..., :self.k]
        idx = torch.sort(idx, dim=-1).values
        return torch.gather(moved, -1, idx).movedim(-1, axis)
