"""The 3D convolution family and the structured-conv extras — port of
``analytics_zoo_tpu/pipeline/api/keras/layers/convolution3d.py``:
``Convolution3D``, ``ZeroPadding3D``, ``Cropping3D``, ``UpSampling3D``,
``SpatialDropout1D``/``2D``/``3D``, ``ConvLSTM2D``, ``ConvLSTM3D``,
``LocallyConnected2D``, ``MaxoutDense``, ``LRN2D`` and
``WithinChannelLRN``. Each states its output-shape rule.

Channels-last at the API, as in the JAX package (NDHWC activations, DHWIO
kernels), so ``load_jax_params`` moves the trees as they are. The 3D
convs run ``F.conv3d`` on cuDNN, the input handed over as its
``channels_last_3d`` NCDHW view and the kernel kept output-channel-major
in memory (``o_major``), with XLA's ``SAME`` pads per axis (``same_pads``:
the odd extra on the high side). Products run in the compute dtype and are
rounded to it; the bias is added after that rounding (the JAX order).

The ConvLSTMs' gates are ``SAME`` convs of the step's input and of the
previous hidden state; the loop runs one time step at a time, its carry
in the compute dtype, as the JAX ``lax.scan`` carries it. Spatial dropout
draws one keep bit per (sample, channel) on the input's device from the
step's generator.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .....common.noise import noise_generator
from ..engine import Layer, compute_dtype, get_initializer, param_dtype
from ._shapes import triple as _triple
from .convolution import conv_nhwc, o_major, same_pads, window_out
from .core import get_activation


def _border(mode: str) -> str:
    mode = mode.lower()
    if mode not in ("valid", "same"):
        raise ValueError(f"border_mode must be 'valid' or 'same', got "
                         f"{mode!r}")
    return mode


def conv_ndhwc(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int],
               border_mode: str) -> torch.Tensor:
    """XLA's ``conv_general_dilated`` with ``("NDHWC", "DHWIO",
    "NDHWC")`` on cuDNN: ``x (B, D, H, W, C)``, ``w (kd, kh, kw, C, O)``
    → ``(B, D', H', W', O)`` in ``x``'s dtype."""
    pads = ([same_pads(n, k, s) for n, k, s in zip(
        x.shape[1:4], w.shape[:3], strides)] if border_mode == "same"
        else [(0, 0)] * 3)
    extra = [hi - lo for lo, hi in pads]
    if any(extra):          # the asymmetric extra, on the high side
        x = F.pad(x, (0, 0, 0, extra[2], 0, extra[1], 0, extra[0]))
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                 stride=tuple(strides), padding=tuple(p[0] for p in pads))
    return y.permute(0, 2, 3, 4, 1)


class Convolution3D(Layer):
    """``Convolution3D(nb_filter, kernel_dim1, kernel_dim2, kernel_dim3)``:
    input (B, D, H, W, C) → (B, D', H', W', F)."""

    def __init__(self, nb_filter: int, kernel_dim1: int, kernel_dim2: int,
                 kernel_dim3: int, init: str = "glorot_uniform",
                 activation=None, border_mode: str = "valid",
                 subsample: Tuple[int, int, int] = (1, 1, 1),
                 bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = nb_filter
        self.kernel = (kernel_dim1, kernel_dim2, kernel_dim3)
        self.init = init
        self.activation = get_activation(activation)
        self.border_mode = _border(border_mode)
        self.subsample = _triple(subsample)
        self.bias = bias

    def build(self, input_shape, *, generator):
        self.add_weight("W", o_major(get_initializer(self.init)(
            generator, self.kernel + (input_shape[-1], self.nb_filter),
            param_dtype())))
        if self.bias:
            self.add_weight("b", torch.zeros(self.nb_filter,
                                             dtype=param_dtype()))

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + tuple(
            window_out(n, k, s, self.border_mode) for n, k, s in zip(
                input_shape[1:4], self.kernel, self.subsample)) + (
            self.nb_filter,)

    def call(self, x, *, training=False, generator=None):
        cd = compute_dtype()
        y = conv_ndhwc(x.to(cd), self.W.to(cd), self.subsample,
                       self.border_mode)
        if self.bias:
            y = y + self.b.to(cd)
        if self.activation is not None:
            y = self.activation(y)
        return y


class ZeroPadding3D(Layer):
    def __init__(self, padding: Tuple[int, int, int] = (1, 1, 1), **kwargs):
        super().__init__(**kwargs)
        self.padding = _triple(padding)

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + tuple(
            n + 2 * p for n, p in zip(input_shape[1:4], self.padding)) + (
            input_shape[4],)

    def call(self, x, *, training=False, generator=None):
        pd, ph, pw = self.padding
        return F.pad(x, (0, 0, pw, pw, ph, ph, pd, pd))


class Cropping3D(Layer):
    def __init__(self, cropping=((1, 1), (1, 1), (1, 1)), **kwargs):
        super().__init__(**kwargs)
        self.cropping = tuple((int(a), int(b)) for a, b in cropping)

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + tuple(
            n - a - b for n, (a, b) in zip(input_shape[1:4],
                                           self.cropping)) + (input_shape[4],)

    def call(self, x, *, training=False, generator=None):
        (d0, d1), (h0, h1), (w0, w1) = self.cropping
        return x[:, d0:x.shape[1] - d1, h0:x.shape[2] - h1,
                 w0:x.shape[3] - w1, :]


class UpSampling3D(Layer):
    def __init__(self, size: Tuple[int, int, int] = (2, 2, 2), **kwargs):
        super().__init__(**kwargs)
        self.size = _triple(size)

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + tuple(
            n * r for n, r in zip(input_shape[1:4], self.size)) + (
            input_shape[4],)

    def call(self, x, *, training=False, generator=None):
        for axis, r in zip((1, 2, 3), self.size):
            x = torch.repeat_interleave(x, r, dim=axis)
        return x


class _SpatialDropoutBase(Layer):
    """Drops whole channels: one keep bit per (sample, channel),
    broadcast over every spatial dim; the identity at inference."""

    ndim_spatial = 1

    def __init__(self, p: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.p = float(p)

    def compute_output_shape(self, input_shape):
        return input_shape

    def call(self, x, *, training=False, generator=None):
        if not training or generator is None or self.p <= 0.0:
            return x
        shape = (x.shape[0],) + (1,) * self.ndim_spatial + (x.shape[-1],)
        keep = torch.rand(shape, generator=noise_generator(generator,
                                                           x.device),
                          device=x.device) < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p),
                           torch.zeros((), dtype=x.dtype, device=x.device))


class SpatialDropout1D(_SpatialDropoutBase):
    ndim_spatial = 1


class SpatialDropout2D(_SpatialDropoutBase):
    ndim_spatial = 2


class SpatialDropout3D(_SpatialDropoutBase):
    ndim_spatial = 3


class _ConvLSTMBase(Layer):
    """An LSTM whose gates are ``SAME`` convs (stride 1) of the step's
    input (``Wx``) and of the previous hidden state (``Wh``), plus ``b``:
    ``z = conv(x_t, Wx) + conv(h', Wh) + b``, each conv rounded to the
    compute dtype first; gates (i, f, c, o) as the LSTM's. Input (B, T,
    *spatial, C) → the last hidden state, or every one with
    ``return_sequences``."""

    n_spatial = 2

    def __init__(self, nb_filter: int, nb_kernel: int,
                 init: str = "glorot_uniform",
                 inner_activation="hard_sigmoid", activation="tanh",
                 return_sequences: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = nb_filter
        self.nb_kernel = int(nb_kernel)
        self.init = init
        self.inner_activation = get_activation(inner_activation)
        self.activation = get_activation(activation)
        self.return_sequences = return_sequences

    def build(self, input_shape, *, generator):
        k = (self.nb_kernel,) * self.n_spatial
        init = get_initializer(self.init)
        self.add_weight("Wx", o_major(init(
            generator, k + (input_shape[-1], 4 * self.nb_filter),
            param_dtype())))
        self.add_weight("Wh", o_major(init(
            generator, k + (self.nb_filter, 4 * self.nb_filter),
            param_dtype())))
        self.add_weight("b", torch.zeros(4 * self.nb_filter,
                                         dtype=param_dtype()))

    def compute_output_shape(self, input_shape):
        spatial = tuple(input_shape[2:2 + self.n_spatial])
        if self.return_sequences:
            return (input_shape[0], input_shape[1]) + spatial + (
                self.nb_filter,)
        return (input_shape[0],) + spatial + (self.nb_filter,)

    def _conv(self, x, w):
        raise NotImplementedError

    def call(self, x, *, training=False, generator=None):
        cd = compute_dtype()
        wx, wh, bias = self.Wx.to(cd), self.Wh.to(cd), self.b.to(cd)
        f = self.nb_filter
        xs = x.to(cd).unbind(1)
        h = torch.zeros(x.shape[:1] + x.shape[2:-1] + (f,), dtype=cd,
                        device=x.device)
        c = h
        hs = []
        for x_t in xs:
            z = self._conv(x_t, wx) + self._conv(h, wh) + bias
            i, fg, g, o = torch.split(z, f, dim=-1)
            i = self.inner_activation(i)
            fg = self.inner_activation(fg)
            o = self.inner_activation(o)
            c = fg * c + i * self.activation(g)
            h = o * self.activation(c)
            hs.append(h)
        return torch.stack(hs, 1) if self.return_sequences else h


class ConvLSTM2D(_ConvLSTMBase):
    """``ConvLSTM2D(nb_filter, nb_kernel)``: input (B, T, H, W, C) → (B,
    H, W, F), or (B, T, H, W, F) with ``return_sequences``."""

    n_spatial = 2

    def _conv(self, x, w):
        k = self.nb_kernel
        pads = [same_pads(n, k, 1) for n in x.shape[1:3]]
        return conv_nhwc(x, w, (1, 1), pads)


class ConvLSTM3D(_ConvLSTMBase):
    """``ConvLSTM3D(nb_filter, nb_kernel)`` (``ConvLSTM3D.scala``): input
    (B, T, D, H, W, C) → (B, D, H, W, F), or the whole sequence with
    ``return_sequences``."""

    n_spatial = 3

    def _conv(self, x, w):
        return conv_ndhwc(x, w, (1, 1, 1), "same")


class LocallyConnected2D(Layer):
    """``LocallyConnected2D.scala``: a conv with a filter of its own at
    each output position (``W`` ``(H'·W', kh·kw·C, F)``, ``b`` ``(H', W',
    F)``): one batched product over the unfolded (kh, kw, C) patches."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, subsample: Tuple[int, int] = (1, 1),
                 bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = nb_filter
        self.nb_row, self.nb_col = int(nb_row), int(nb_col)
        self.activation = get_activation(activation)
        self.subsample = (tuple(int(s) for s in subsample)
                          if isinstance(subsample, (tuple, list))
                          else (int(subsample),) * 2)
        self.bias = bias

    def _out_hw(self, h, w):
        return ((h - self.nb_row) // self.subsample[0] + 1,
                (w - self.nb_col) // self.subsample[1] + 1)

    def build(self, input_shape, *, generator):
        _, h, w, c = input_shape
        oh, ow = self._out_hw(h, w)
        self.add_weight("W", get_initializer("glorot_uniform")(
            generator, (oh * ow, self.nb_row * self.nb_col * c,
                        self.nb_filter), param_dtype()))
        if self.bias:
            self.add_weight("b", torch.zeros(oh, ow, self.nb_filter,
                                             dtype=param_dtype()))

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + self._out_hw(*input_shape[1:3]) + (
            self.nb_filter,)

    def call(self, x, *, training=False, generator=None):
        cd = compute_dtype()
        b = x.shape[0]
        oh, ow = self._out_hw(x.shape[1], x.shape[2])
        # (B, oh, ow, C, kh, kw) -> (B, oh * ow, kh * kw * C)
        patches = x.to(cd).unfold(1, self.nb_row, self.subsample[0]).unfold(
            2, self.nb_col, self.subsample[1])
        patches = patches.permute(0, 1, 2, 4, 5, 3).reshape(b, oh * ow, -1)
        y = torch.einsum("bpk,pkf->bpf", patches, self.W.to(cd))
        y = y.reshape(b, oh, ow, self.nb_filter)
        if self.bias:
            y = y + self.b.to(cd)
        if self.activation is not None:
            y = self.activation(y)
        return y


class MaxoutDense(Layer):
    """``MaxoutDense(output_dim, nb_feature)``: the maximum over
    ``nb_feature`` linear pieces."""

    def __init__(self, output_dim: int, nb_feature: int = 4,
                 bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.output_dim = int(output_dim)
        self.nb_feature = int(nb_feature)
        self.bias = bias

    def build(self, input_shape, *, generator):
        n = self.nb_feature * self.output_dim
        self.add_weight("W", get_initializer("glorot_uniform")(
            generator, (input_shape[-1], n), param_dtype()))
        if self.bias:
            self.add_weight("b", torch.zeros(n, dtype=param_dtype()))

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)

    def call(self, x, *, training=False, generator=None):
        cd = compute_dtype()
        y = torch.matmul(x.to(cd), self.W.to(cd))
        if self.bias:
            y = y + self.b.to(cd)
        y = y.reshape(tuple(x.shape[:-1]) + (self.nb_feature,
                                             self.output_dim))
        return torch.amax(y, dim=-2)


class LRN2D(Layer):
    """``LRN2D(alpha, k, beta, n)``: cross-channel local response norm,
    ``x / (k + alpha / n * sum_window(x^2)) ** beta`` over a window of
    ``n`` channels (zero-padded at the ends), summed in f32 in the JAX
    order and cast back to the input's dtype."""

    def __init__(self, alpha: float = 1e-4, k: float = 1.0,
                 beta: float = 0.75, n: int = 5, **kwargs):
        super().__init__(**kwargs)
        self.alpha, self.k, self.beta, self.n = (float(alpha), float(k),
                                                 float(beta), int(n))

    def compute_output_shape(self, input_shape):
        return input_shape

    def call(self, x, *, training=False, generator=None):
        half, ch = self.n // 2, x.shape[-1]
        xf = x.float()
        pad = F.pad(torch.square(xf), (half, half))
        win = sum(pad[..., i:i + ch] for i in range(self.n))
        denom = torch.pow(self.k + self.alpha / self.n * win, self.beta)
        return (xf / denom).to(x.dtype)


class WithinChannelLRN(Layer):
    """``WithinChannelLRN2D.scala`` (caffe's WITHIN_CHANNEL LRN): ``x /
    (1 + alpha * avg(x^2)) ** beta``, the average over a ``size`` x
    ``size`` spatial window inside each channel (``SAME``, zeros outside,
    divided by the whole window), in f32, cast back."""

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75, **kwargs):
        super().__init__(**kwargs)
        self.size, self.alpha, self.beta = int(size), float(alpha), float(beta)

    def compute_output_shape(self, input_shape):
        return input_shape

    def call(self, x, *, training=False, generator=None):
        xf = x.float()
        (th, bh), (lw, rw) = (same_pads(n, self.size, 1)
                              for n in x.shape[1:3])
        sq = F.pad(torch.square(xf), (0, 0, lw, rw, th, bh))
        win = F.avg_pool2d(sq.permute(0, 3, 1, 2), self.size, stride=1,
                           divisor_override=1).permute(0, 2, 3, 1)
        avg = win / float(self.size * self.size)
        denom = torch.pow(1.0 + self.alpha * avg, self.beta)
        return (xf / denom).to(x.dtype)
