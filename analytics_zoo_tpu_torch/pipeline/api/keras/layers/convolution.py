"""Convolution layers — port of ``analytics_zoo_tpu/pipeline/api/keras/
layers/convolution.py``: ``Convolution1D``, ``AtrousConvolution1D``,
``Convolution2D`` (with the static-int8 ``quantized_call``),
``AtrousConvolution2D``, ``SeparableConvolution1D``/``2D``,
``DepthwiseConvolution2D``, ``Deconvolution2D``, ``ZeroPadding1D``/``2D``,
``Cropping1D``/``2D``, ``UpSampling1D``/``2D``, ``LocallyConnected1D`` and
``ShareConvolution2D``. Each states its output-shape rule.

The layout at the API is the JAX package's: channels-last activations
(NWC, NHWC) and HWIO (WIO) kernels, so ``load_jax_params`` moves the tree
as it is. The products run on cuDNN through ``F.conv2d`` (the JAX package
leaves them to XLA): the NHWC input is handed over as its
``permute(0, 3, 1, 2)`` view, which is ``channels_last`` memory, and each
kernel is created with its output channel outermost in memory (shape HWIO,
strides O-major, :func:`o_major`), so that its ``permute(3, 2, 0, 1)`` is a
``channels_last`` OIHW view too and cuDNN copies neither per call. A 1D
conv is the 2D conv on a unit height.

Products run in ``compute_dtype()`` with f32 accumulation, rounded to it,
and the bias is added after that rounding (the JAX order). ``same``
padding is XLA's, which is asymmetric where the total is odd: ``lo = total
// 2`` and ``hi = total - lo``, with ``total = max((ceil(n / s) - 1) s +
(k - 1) d + 1 - n, 0)`` (:func:`same_pads`); the symmetric part goes to the
conv as its ``padding`` and the extra row or column is padded with zeros
first.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .....ops.pallas.quantized import static_int8_conv2d
from ..engine import Layer, compute_dtype, get_initializer, param_dtype
from ._shapes import pair as _pair
from .core import ACTIVATIONS, get_activation


def _padding(border_mode: str) -> str:
    if border_mode not in ("valid", "same"):
        raise ValueError(f"border_mode must be 'valid' or 'same', got "
                         f"{border_mode!r}")
    return border_mode


def same_pads(size: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """XLA's ``SAME`` padding ``(lo, hi)`` of one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def window_pads(spatial: Sequence[int], window: Sequence[int],
                strides: Sequence[int], border_mode: str,
                dilation: Sequence[int] = None):
    """``[(lo, hi)]`` per spatial dim for ``border_mode``."""
    dilation = dilation or (1,) * len(window)
    if border_mode.lower() == "valid":
        return [(0, 0)] * len(window)
    return [same_pads(n, k, s, d) for n, k, s, d
            in zip(spatial, window, strides, dilation)]


def window_out(size, k: int, s: int, border_mode: str, d: int = 1):
    """The output length of a window over ``size`` (None stays None)."""
    if size is None:
        return None
    if border_mode.lower() == "same":
        return -(-size // s)
    return (size - (k - 1) * d - 1) // s + 1


def o_major(w: torch.Tensor) -> torch.Tensor:
    """``w`` (``(*k, I, O)``) with its values unchanged and the output
    channel outermost in memory: ``w.permute(3, 2, 0, 1)`` of a 2D kernel
    is then a ``channels_last`` OIHW tensor."""
    return w.movedim(-1, 0).contiguous().movedim(0, -1)


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int],
              pads, dilation: Sequence[int] = (1, 1),
              groups: int = 1) -> torch.Tensor:
    """XLA's ``conv_general_dilated`` with ``("NHWC", "HWIO", "NHWC")``
    (a cross-correlation) on cuDNN: ``x (B, H, W, C)``, ``w (kh, kw, C /
    groups, O)``, ``pads`` ``[(lo, hi)] * 2`` → ``(B, H', W', O)`` in
    ``x``'s dtype."""
    (lh, hh), (lw, hw) = pads
    if hh != lh or hw != lw:      # the asymmetric extra, on the high side
        x = F.pad(x, (0, 0, 0, hw - lw, 0, hh - lh))
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=tuple(strides), padding=(lh, lw),
                 dilation=tuple(dilation), groups=groups)
    return y.permute(0, 2, 3, 1)


def conv_nwc(x, w, stride: int, pads, dilation: int = 1, groups: int = 1):
    """The 1D conv (``("NWC", "WIO", "NWC")``) as the 2D one on a unit
    height."""
    y = conv_nhwc(x.unsqueeze(1), w.unsqueeze(0), (1, stride),
                  [(0, 0), pads], (1, dilation), groups)
    return y.squeeze(1)


def _epilogue(layer, y, cd):
    if layer.bias:
        y = y + layer.b.to(cd)
    if layer.activation is not None:
        y = layer.activation(y)
    return y


class Convolution1D(Layer):
    """``Convolution1D(nb_filter, filter_length, activation, border_mode,
    subsample_length)`` — Convolution1D.scala. Input (B, T, C) → (B, T',
    F)."""

    def __init__(self, nb_filter: int, filter_length: int,
                 init: str = "glorot_uniform", activation=None,
                 border_mode: str = "valid", subsample_length: int = 1,
                 dilation_rate: int = 1, bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = nb_filter
        self.filter_length = filter_length
        self.init = init
        self.activation = get_activation(activation)
        self.border_mode = _padding(border_mode)
        self.subsample_length = subsample_length
        self.dilation_rate = dilation_rate
        self.bias = bias

    def build(self, input_shape, *, generator):
        self.add_weight("W", o_major(get_initializer(self.init)(
            generator, (self.filter_length, input_shape[-1],
                        self.nb_filter), param_dtype())))
        if self.bias:
            self.add_weight("b", torch.zeros(self.nb_filter,
                                             dtype=param_dtype()))

    def compute_output_shape(self, input_shape):
        return (input_shape[0], window_out(
            input_shape[1], self.filter_length, self.subsample_length,
            self.border_mode, self.dilation_rate), self.nb_filter)

    def call(self, x, *, training=False, generator=None):
        cd = compute_dtype()
        pads = window_pads(x.shape[1:2], (self.filter_length,),
                           (self.subsample_length,), self.border_mode,
                           (self.dilation_rate,))[0]
        y = conv_nwc(x.to(cd), self.W.to(cd), self.subsample_length, pads,
                     self.dilation_rate)
        return _epilogue(self, y, cd)


class AtrousConvolution1D(Convolution1D):
    """``AtrousConvolution1D.scala`` — dilated 1D conv."""

    def __init__(self, nb_filter: int, filter_length: int,
                 atrous_rate: int = 1, **kwargs):
        super().__init__(nb_filter, filter_length,
                         dilation_rate=atrous_rate, **kwargs)


class Convolution2D(Layer):
    """``Convolution2D(nb_filter, nb_row, nb_col, activation, border_mode,
    subsample)`` — Convolution2D.scala. Input (B, H, W, C) → (B, H', W',
    F)."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 init: str = "glorot_uniform", activation=None,
                 border_mode: str = "valid",
                 subsample: Tuple[int, int] = (1, 1),
                 dilation: Tuple[int, int] = (1, 1), bias: bool = True,
                 **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = nb_filter
        self.nb_row = nb_row
        self.nb_col = nb_col
        self.init = init
        self.activation = get_activation(activation)
        self.border_mode = _padding(border_mode)
        self.subsample = _pair(subsample)
        self.dilation = _pair(dilation)
        self.bias = bias

    def build(self, input_shape, *, generator):
        self.add_weight("W", o_major(get_initializer(self.init)(
            generator, (self.nb_row, self.nb_col, input_shape[-1],
                        self.nb_filter), param_dtype())))
        if self.bias:
            self.add_weight("b", torch.zeros(self.nb_filter,
                                             dtype=param_dtype()))

    def compute_output_shape(self, input_shape):
        k = (self.nb_row, self.nb_col)
        return (input_shape[0],) + tuple(
            window_out(n, k[i], self.subsample[i], self.border_mode,
                       self.dilation[i])
            for i, n in enumerate(input_shape[1:3])) + (self.nb_filter,)

    def _pads(self, x):
        return window_pads(x.shape[1:3], (self.nb_row, self.nb_col),
                           self.subsample, self.border_mode, self.dilation)

    def call(self, x, *, training=False, generator=None):
        cd = compute_dtype()
        y = conv_nhwc(x.to(cd), self.W.to(cd), self.subsample,
                      self._pads(x), self.dilation)
        return _epilogue(self, y, cd)

    def quantized_call(self, x):
        """Static int8 conv (the inference runtime installs ``W`` as int8
        beside ``w_scale`` and the calibrated ``x_scale``): ``x``
        quantized to ``x_scale`` (a division, round half to even, clip to
        +-127), the int8 x int8 conv exact in int32, one f32 rescale by
        ``x_scale * w_scale``, then the f32 bias and the activation — the
        JAX order. All of it but an activation other than ReLU runs in
        kernel C8 (:func:`static_int8_conv2d`; its plain version on the
        CPU), on the K-major repack of ``W`` that the runtime made at
        install (``W_kmajor``, a buffer kept out of every saved format)
        where C8's route reads it."""
        relu = self.activation is ACTIVATIONS["relu"]
        y = static_int8_conv2d(x, self.x_scale, self.W, self.w_scale,
                               self.b if self.bias else None, relu,
                               self.subsample, self.dilation,
                               self._pads(x),
                               w_kmajor=getattr(self, "W_kmajor", None))
        if self.activation is not None and not relu:
            y = self.activation(y)
        return y


class AtrousConvolution2D(Convolution2D):
    """``AtrousConvolution2D.scala`` — dilated 2D conv."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 atrous_rate: Tuple[int, int] = (1, 1), **kwargs):
        super().__init__(nb_filter, nb_row, nb_col, dilation=atrous_rate,
                         **kwargs)


class _Depthwise(Layer):
    """Shared configuration of the depthwise layers."""

    def __init__(self, nb_row: int, nb_col: int,
                 init: str = "glorot_uniform", activation=None,
                 border_mode: str = "valid",
                 subsample: Tuple[int, int] = (1, 1),
                 depth_multiplier: int = 1, bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.nb_row, self.nb_col = nb_row, nb_col
        self.init = init
        self.activation = get_activation(activation)
        self.border_mode = _padding(border_mode)
        self.subsample = _pair(subsample)
        self.depth_multiplier = depth_multiplier
        self.bias = bias

    def _spatial_shape(self, input_shape):
        k = (self.nb_row, self.nb_col)
        return tuple(window_out(n, k[i], self.subsample[i], self.border_mode)
                     for i, n in enumerate(input_shape[1:3]))

    def _depthwise(self, x, cd):
        """The per-channel conv (``feature_group_count = C``; with a
        depth multiplier the output features of channel c are ``c m ..
        c m + m - 1``, XLA's order and torch's alike)."""
        pads = window_pads(x.shape[1:3], (self.nb_row, self.nb_col),
                           self.subsample, self.border_mode)
        return conv_nhwc(x.to(cd), self.depthwise.to(cd), self.subsample,
                         pads, groups=x.shape[-1])


class SeparableConvolution2D(_Depthwise):
    """``SeparableConvolution2D.scala`` — depthwise conv (per channel)
    followed by a 1x1 pointwise conv."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int, **kwargs):
        super().__init__(nb_row, nb_col, **kwargs)
        self.nb_filter = nb_filter

    def build(self, input_shape, *, generator):
        c = input_shape[-1] * self.depth_multiplier
        ini = get_initializer(self.init)
        self.add_weight("depthwise", o_major(ini(
            generator, (self.nb_row, self.nb_col, 1, c), param_dtype())))
        self.add_weight("pointwise", o_major(ini(
            generator, (1, 1, c, self.nb_filter), param_dtype())))
        if self.bias:
            self.add_weight("b", torch.zeros(self.nb_filter,
                                             dtype=param_dtype()))

    def compute_output_shape(self, input_shape):
        return ((input_shape[0],) + self._spatial_shape(input_shape)
                + (self.nb_filter,))

    def call(self, x, *, training=False, generator=None):
        cd = compute_dtype()
        y = self._depthwise(x, cd)
        y = conv_nhwc(y, self.pointwise.to(cd), (1, 1), [(0, 0), (0, 0)])
        return _epilogue(self, y, cd)


class DepthwiseConvolution2D(_Depthwise):
    """Standalone depthwise conv (one filter stack per input channel) —
    the MobileNet building block interleaved with BatchNorm."""

    def build(self, input_shape, *, generator):
        c = input_shape[-1] * self.depth_multiplier
        self.add_weight("depthwise", o_major(get_initializer(self.init)(
            generator, (self.nb_row, self.nb_col, 1, c), param_dtype())))
        if self.bias:
            self.add_weight("b", torch.zeros(c, dtype=param_dtype()))

    def compute_output_shape(self, input_shape):
        return ((input_shape[0],) + self._spatial_shape(input_shape)
                + (input_shape[-1] * self.depth_multiplier,))

    def call(self, x, *, training=False, generator=None):
        cd = compute_dtype()
        return _epilogue(self, self._depthwise(x, cd), cd)


class Deconvolution2D(Layer):
    """``Deconvolution2D.scala`` — the JAX ``lax.conv_transpose(...,
    padding="VALID")`` with the kernel as stored (``transpose_kernel``
    false): a conv of the stride-dilated input, padded ``(k - 1, s - 1 +
    max(k - s, 0))``, with ``W`` unflipped, so out = in s + max(k - s, 0).
    That is ``F.conv_transpose2d`` with ``W`` flipped in space and its I/O
    axes swapped, and ``output_padding`` the ``max(s - k, 0)`` zero rows
    past its ``(in - 1) s + k``."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 init: str = "glorot_uniform", activation=None,
                 subsample: Tuple[int, int] = (1, 1), bias: bool = True,
                 **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = nb_filter
        self.nb_row, self.nb_col = nb_row, nb_col
        self.init = init
        self.activation = get_activation(activation)
        self.subsample = _pair(subsample)
        self.bias = bias

    def build(self, input_shape, *, generator):
        self.add_weight("W", get_initializer(self.init)(
            generator, (self.nb_row, self.nb_col, input_shape[-1],
                        self.nb_filter), param_dtype()))
        if self.bias:
            self.add_weight("b", torch.zeros(self.nb_filter,
                                             dtype=param_dtype()))

    def compute_output_shape(self, input_shape):
        k = (self.nb_row, self.nb_col)
        return (input_shape[0],) + tuple(
            None if n is None else n * s + max(kk - s, 0)
            for n, kk, s in zip(input_shape[1:3], k, self.subsample)) + (
            self.nb_filter,)

    def call(self, x, *, training=False, generator=None):
        cd = compute_dtype()
        k = (self.nb_row, self.nb_col)
        w = self.W.to(cd).flip(0, 1).permute(2, 3, 0, 1)   # (I, O, kh, kw)
        y = F.conv_transpose2d(
            x.to(cd).permute(0, 3, 1, 2), w, stride=self.subsample,
            output_padding=tuple(max(s - kk, 0)
                                 for kk, s in zip(k, self.subsample)))
        return _epilogue(self, y.permute(0, 2, 3, 1), cd)


class ZeroPadding1D(Layer):
    """``ZeroPadding1D.scala`` — pad the time axis."""

    def __init__(self, padding: Union[int, Tuple[int, int]] = 1, **kwargs):
        super().__init__(**kwargs)
        self.padding = _pair(padding)

    def compute_output_shape(self, input_shape):
        t = input_shape[1]
        return (input_shape[0], None if t is None else t + sum(self.padding),
                input_shape[2])

    def call(self, x, *, training=False, generator=None):
        return F.pad(x, (0, 0) + self.padding)


class ZeroPadding2D(Layer):
    """``ZeroPadding2D.scala`` — pad height/width."""

    def __init__(self, padding: Tuple[int, int] = (1, 1), **kwargs):
        super().__init__(**kwargs)
        self.padding = _pair(padding)

    def compute_output_shape(self, input_shape):
        h, w = input_shape[1:3]
        ph, pw = self.padding
        return (input_shape[0], h + 2 * ph, w + 2 * pw, input_shape[3])

    def call(self, x, *, training=False, generator=None):
        ph, pw = self.padding
        return F.pad(x, (0, 0, pw, pw, ph, ph))


class Cropping1D(Layer):
    """``Cropping1D.scala``."""

    def __init__(self, cropping: Tuple[int, int] = (1, 1), **kwargs):
        super().__init__(**kwargs)
        self.cropping = _pair(cropping)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], input_shape[1] - sum(self.cropping),
                input_shape[2])

    def call(self, x, *, training=False, generator=None):
        a, b = self.cropping
        return x[:, a:x.shape[1] - b, :]


class Cropping2D(Layer):
    """``Cropping2D.scala``."""

    def __init__(self, cropping=((0, 0), (0, 0)), **kwargs):
        super().__init__(**kwargs)
        self.cropping = (tuple(cropping[0]), tuple(cropping[1]))

    def compute_output_shape(self, input_shape):
        (t, b), (l, r) = self.cropping
        return (input_shape[0], input_shape[1] - t - b,
                input_shape[2] - l - r, input_shape[3])

    def call(self, x, *, training=False, generator=None):
        (t, b), (l, r) = self.cropping
        return x[:, t:x.shape[1] - b, l:x.shape[2] - r, :]


class UpSampling1D(Layer):
    """``UpSampling1D.scala`` — repeat timesteps."""

    def __init__(self, length: int = 2, **kwargs):
        super().__init__(**kwargs)
        self.length = length

    def compute_output_shape(self, input_shape):
        return (input_shape[0], input_shape[1] * self.length,
                input_shape[2])

    def call(self, x, *, training=False, generator=None):
        return torch.repeat_interleave(x, self.length, dim=1)


class UpSampling2D(Layer):
    """``UpSampling2D.scala`` — nearest-neighbour spatial upsampling."""

    def __init__(self, size: Tuple[int, int] = (2, 2), **kwargs):
        super().__init__(**kwargs)
        self.size = _pair(size)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], input_shape[1] * self.size[0],
                input_shape[2] * self.size[1], input_shape[3])

    def call(self, x, *, training=False, generator=None):
        y = torch.repeat_interleave(x, self.size[0], dim=1)
        return torch.repeat_interleave(y, self.size[1], dim=2)


class LocallyConnected1D(Layer):
    """``LocallyConnected1D.scala`` — unshared conv: one filter per output
    position, a batched product over unfolded patches."""

    def __init__(self, nb_filter: int, filter_length: int,
                 init: str = "glorot_uniform", activation=None,
                 subsample_length: int = 1, bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = nb_filter
        self.filter_length = filter_length
        self.init = init
        self.activation = get_activation(activation)
        self.subsample_length = subsample_length
        self.bias = bias

    def _out_len(self, t: int) -> int:
        return (t - self.filter_length) // self.subsample_length + 1

    def build(self, input_shape, *, generator):
        t, c = input_shape[1], input_shape[2]
        out_t = self._out_len(t)
        self.add_weight("W", get_initializer(self.init)(
            generator, (out_t, self.filter_length * c, self.nb_filter),
            param_dtype()))
        if self.bias:
            self.add_weight("b", torch.zeros(out_t, self.nb_filter,
                                             dtype=param_dtype()))

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self._out_len(input_shape[1]),
                self.nb_filter)

    def call(self, x, *, training=False, generator=None):
        cd = compute_dtype()
        # (B, out_t, C, filter_length) -> (B, out_t, filter_length * C),
        # the JAX unfold's order
        patches = x.unfold(1, self.filter_length, self.subsample_length)
        patches = patches.transpose(2, 3).reshape(
            x.shape[0], patches.shape[1], -1)
        y = torch.einsum("btk,tkf->btf", patches.to(cd), self.W.to(cd))
        return _epilogue(self, y, cd)


class ShareConvolution2D(Convolution2D):
    """``ShareConvolution2D.scala`` — a ``Convolution2D`` with explicit
    ``pad_h``/``pad_w`` zeros before it (the reference's shared buffers are
    a JVM memory concern). Its own ``call`` means the static int8 runtime
    leaves it float, as the JAX package does."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 pad_h: int = 0, pad_w: int = 0, **kwargs):
        super().__init__(nb_filter, nb_row, nb_col, **kwargs)
        self.pad_h, self.pad_w = int(pad_h), int(pad_w)

    def compute_output_shape(self, input_shape):
        b, h, w, c = input_shape
        return super().compute_output_shape(
            (b, h + 2 * self.pad_h, w + 2 * self.pad_w, c))

    def call(self, x, *, training=False, generator=None):
        if self.pad_h or self.pad_w:
            x = F.pad(x, (0, 0, self.pad_w, self.pad_w, self.pad_h,
                          self.pad_h))
        return super().call(x, training=training, generator=generator)


class SeparableConvolution1D(Layer):
    """``SeparableConvolution1D.scala`` — depthwise temporal conv (per
    channel) followed by a pointwise 1x1 over (B, T, C)."""

    def __init__(self, nb_filter: int, filter_length: int,
                 init: str = "glorot_uniform", activation=None,
                 border_mode: str = "valid", subsample_length: int = 1,
                 depth_multiplier: int = 1, bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = nb_filter
        self.filter_length = int(filter_length)
        self.init = init
        self.activation = get_activation(activation)
        self.border_mode = _padding(border_mode)
        self.subsample_length = int(subsample_length)
        self.depth_multiplier = int(depth_multiplier)
        self.bias = bias

    def build(self, input_shape, *, generator):
        c = input_shape[-1] * self.depth_multiplier
        ini = get_initializer(self.init)
        self.add_weight("depthwise", o_major(ini(
            generator, (self.filter_length, 1, c), param_dtype())))
        self.add_weight("pointwise", o_major(ini(
            generator, (1, c, self.nb_filter), param_dtype())))
        if self.bias:
            self.add_weight("b", torch.zeros(self.nb_filter,
                                             dtype=param_dtype()))

    def compute_output_shape(self, input_shape):
        return (input_shape[0], window_out(
            input_shape[1], self.filter_length, self.subsample_length,
            self.border_mode), self.nb_filter)

    def call(self, x, *, training=False, generator=None):
        cd = compute_dtype()
        pads = window_pads(x.shape[1:2], (self.filter_length,),
                           (self.subsample_length,), self.border_mode)[0]
        y = conv_nwc(x.to(cd), self.depthwise.to(cd), self.subsample_length,
                     pads, groups=x.shape[-1])
        y = conv_nwc(y, self.pointwise.to(cd), 1, (0, 0))
        return _epilogue(self, y, cd)
