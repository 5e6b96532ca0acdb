"""Int8 weight-only dequant-matmul — the Hopper counterpart of
``analytics_zoo_tpu/ops/pallas/quantized.py`` (kernel K6).

:func:`int8_matmul` computes ``x (M, K) @ (w_q (K, N) int8 as f32) *
scales (N,)`` with f32 accumulation and the per-column scale applied after
the reduction, rounded once to ``x``'s dtype (float32 or bfloat16). The
int8 weights stay int8 in device memory; the kernel widens them on their
way to the products (``csrc/quantized.cu``). In the JAX package K6 is a
standalone API and weight-only int8 inference dequantizes inside the jitted
predict, leaving the fusion to XLA; eager PyTorch has no such fusion, so in
the port K6 itself is that fused program: every ``dense`` over an int8
weight runs it (``pipeline/api/keras/layers/core.py``).

That program computes what the JAX predict computes, which is not the
Pallas kernel's formula: ``dequantize_int8`` forms each weight in the
compute dtype first, ``w = q.astype(dtype) * s.astype(dtype)`` (in bf16
both ``s`` and ``q * s`` round to bf16), and the product then rounds once.
``dequantize_first=True`` selects that order (the kernel scales each weight
where it widens it); the default keeps the Pallas contract. In f32 the two
differ by rounding only; in bf16 by up to half a bf16 step per column.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs :func:`int8_matmul_reference`, the TPU kernel's own arithmetic.
The C entry point picks one of four hand-written kernels by shape and
reports it: ``skinny`` (M <= 32: every weight byte read once, the K range
split over blocks whose partial sums a second kernel adds in a fixed
order; the C side picks the K slices from the card's SM count and sizes
the workspace, ``int8_matmul_plan``), ``wgmma`` (bf16, M > 32, K % 8 == 0 and N % 16 == 0 with 16-byte
aligned operands: the rows TMA can address; every BERT product), ``mma``
(the other bf16 shapes) and ``fma`` (f32, M > 32).
:data:`KERNEL_INT8_MATMUL` counts every launch and
:data:`KERNEL_INT8_ROUTES` each route's; :data:`LAST_LAUNCH` holds the
route and the K slices the entry point reported for the latest one.

``bias`` and ``relu`` are the dense layer's epilogue, ``relu(round(y +
round(bias)))`` in ``x``'s dtype after the product's rounding (what
``dense`` and ``Dense``'s ReLU compute, and what the JAX predict leaves
XLA to fuse). The skinny kernel applies them itself; after the other
routes the wrapper applies them with two torch ops (``add_``, ``relu_``),
the same numbers as the separate layer ops.
The JAX wrapper's ``block_m``/``block_n``/``interpret`` arguments are TPU
tiling and the Pallas interpreter; they are not carried over (the CUDA
kernels pick their own tiles and take any M, K and N).

Beside K6, :func:`static_int8_dense` (kernel Q8) is the static int8 dense
layer at most 32 rows deep, ``Dense.quantized_call``'s whole arithmetic in
one kernel and its split-K reduce: ``x`` quantized to the calibrated
``x_scale`` (an IEEE division, round half to even, clipped to +-127), the
int8 x int8 product exact in int32, one f32 rescale by ``x_scale *
w_scale``, the f32 bias and the ReLU. It replaces no TPU kernel: the JAX
package leaves that product to XLA's ``dot_general``.
:func:`static_int8_dense_reference` is its plain version, the static
path's torch ops, with the int8 product on :func:`int8_product` (the
padded ``torch._int_mm``), which ``quantized_call`` keeps for more than 32
rows. ``x_scale`` stays on the device: the kernel reads it there, so a
captured graph bakes no host value. :data:`KERNEL_INT8_STATIC` counts Q8's
launches.

:func:`static_int8_conv2d` (kernel C8, ``csrc/conv_int8.cu``, its own
library :data:`LIBRARY_CONV`) is the conv counterpart of Q8: the static
int8 ``Convolution2D`` forward (the JAX ``quantized_call``, whose int8
conv the JAX package leaves to XLA) as an implicit GEMM with the same
epilogue. PyTorch has no int8 conv on CUDA; its only library route,
im2col and the padded ``_int_mm``, writes each activation ``kh · kw``
times. :func:`conv_plan` picks C8's route by shape: ``c8_wgmma`` and
``c8_split`` (``C % 16 == 0``) run the quantize pass
(:func:`static_int8_quantize`, each activation divided once, written as
int8) and then ``wgmma`` s8 tiles over the weight repacked K-major
(:func:`repack_conv_weight`, made once where a static model is
installed), ``c8_split`` splitting K where the output tiles are few;
``c8_small_c`` (the 3-channel stems) quantizes on load into ``mma.sync``
tiles. :func:`static_int8_conv2d_reference` is its plain version;
:data:`KERNEL_INT8_CONV` counts the GEMM's launches,
:data:`KERNEL_INT8_CONV_ROUTES` each route's,
:data:`KERNEL_INT8_CONV_QUANTIZE` and :data:`KERNEL_INT8_CONV_REPACK` the
two passes'.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..cuda_build import CudaLibrary, launch
from .cross_entropy import _raise_on
from .flash_attention import _LaunchCount

__all__ = ["conv_plan", "int8_matmul", "int8_matmul_reference",
           "int8_product", "repack_conv_weight",
           "repack_conv_weight_reference", "static_int8_conv2d",
           "static_int8_conv2d_reference", "static_int8_dense",
           "static_int8_dense_reference", "static_int8_quantize"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.int8_matmul.argtypes = [p, p, p, p, i, p, ll, p, i, i, i, i, i,
                                ctypes.POINTER(i), p]
    lib.int8_matmul.restype = ctypes.c_int
    lib.int8_matmul_plan.argtypes = [i, i, i, i, i, ctypes.POINTER(ll)]
    lib.int8_matmul_plan.restype = ctypes.c_int
    lib.int8_static_matmul.argtypes = [p, p, p, p, p, i, p, ll, p, i, i, i,
                                       ctypes.POINTER(i), p]
    lib.int8_static_matmul.restype = ctypes.c_int
    lib.int8_static_plan.argtypes = [i, i, i, i, ctypes.POINTER(ll)]
    lib.int8_static_plan.restype = ctypes.c_int


LIBRARY = CudaLibrary("quantized", ["quantized.cu"], _bind)

KERNEL_INT8_MATMUL = _LaunchCount()   # K6, every route
#: the kernel the C entry point took, by the code it reports
ROUTES = ("wgmma", "mma", "skinny", "fma")
KERNEL_INT8_ROUTES = {name: _LaunchCount() for name in ROUTES}
KERNEL_INT8_STATIC = _LaunchCount()   # Q8
#: the most rows Q8 takes (K6's skinny bound)
STATIC_MAX_M = 32


class _Launched:
    """The latest K6 launch as its C entry point reported it: the route's
    name and the K slices it ran (1 off the skinny route)."""

    __slots__ = ("route", "splits")

    def __init__(self):
        self.route, self.splits = None, 0


LAST_LAUNCH = _Launched()
_INFO = ctypes.c_int * 2   # the entry point's report: route, K slices


@functools.lru_cache(maxsize=4096)
def _plan(m: int, k: int, n: int, code: int, index: int):
    """``(fused, floats)`` for ``(m, k) @ (k, n)`` in dtype ``code`` on
    CUDA device ``index``, from the C side, which owns the skinny route's
    K slicing: whether the kernel applies the epilogue itself (the skinny
    route), and the f32 workspace its split-K partial sums need."""
    floats = ctypes.c_longlong(0)
    fused = LIBRARY.entry("int8_matmul_plan")(m, k, n, code, index,
                                              ctypes.byref(floats))
    if fused < 0:
        raise RuntimeError(f"int8_matmul: cannot read CUDA device {index}")
    return bool(fused), floats.value


def _check(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor,
           bias: Optional[torch.Tensor]) -> None:
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0] \
            or tuple(scales.shape) != (w_q.shape[1],):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}, scales {tuple(scales.shape)}")
    if bias is not None and tuple(bias.shape) != (w_q.shape[1],):
        raise ValueError(f"shape mismatch: bias {tuple(bias.shape)} for "
                         f"{w_q.shape[1]} columns")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_matmul takes float32 or bfloat16 x; got "
                        f"{x.dtype}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 w_q; got {w_q.dtype}")
    if not (x.device == w_q.device == scales.device) or (
            bias is not None and bias.device != x.device):
        raise ValueError("int8_matmul operands lie on different devices")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"int8_matmul runs on cuda or cpu, not "
                         f"{x.device.type}")


def _epilogue(y: torch.Tensor, bias: Optional[torch.Tensor],
              relu: bool) -> torch.Tensor:
    """``dense``'s bias (in ``y``'s dtype, after the product's rounding)
    and ``Dense``'s ReLU, as separate torch ops, in place."""
    if bias is not None:
        y.add_(bias.to(y.dtype))
    if relu:
        y.relu_()
    return y


def int8_matmul_reference(x: torch.Tensor, w_q: torch.Tensor,
                          scales: torch.Tensor,
                          dequantize_first: bool = False,
                          bias: Optional[torch.Tensor] = None,
                          relu: bool = False) -> torch.Tensor:
    """Plain version of K6. By default the TPU kernel's arithmetic: the f32
    product, then the per-column scale, then one rounding to ``x``'s
    dtype. ``dequantize_first``: the JAX weight-only predict's, each
    weight ``q * s`` formed in ``x``'s dtype (``s`` rounded to it first),
    then the f32 product rounded once. Then ``bias`` added in ``x``'s
    dtype and ``relu``, as ``dense`` and ``Dense`` apply them."""
    if dequantize_first:
        w = w_q.to(x.dtype) * scales.to(x.dtype)
        y = (x.float() @ w.float()).to(x.dtype)
    else:
        y = ((x.float() @ w_q.float()) * scales.float()).to(x.dtype)
    return _epilogue(y, bias, relu)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor,
                dequantize_first: bool = False,
                bias: Optional[torch.Tensor] = None,
                relu: bool = False) -> torch.Tensor:
    """K6: ``x (M, K) @ dequant(w_q (K, N) int8, scales (N,))`` → ``(M, N)``
    in ``x.dtype``; by default ``(x @ w_q.float()) * scales``, the Pallas
    contract, with ``dequantize_first`` ``x @ (w_q.to(x.dtype) *
    scales.to(x.dtype))``, the JAX predict's (see the module docstring);
    then ``bias (N,)`` added and ``relu`` applied in ``x.dtype`` (fused
    into the skinny kernel, torch ops after the others). CUDA tensors
    launch the kernel (or raise); CPU tensors run
    :func:`int8_matmul_reference`."""
    _check(x, w_q, scales, bias)
    if not x.is_cuda:
        return int8_matmul_reference(x, w_q, scales, dequantize_first, bias,
                                     relu)
    (m, k), n = x.shape, w_q.shape[1]
    out = x.new_empty((m, n))
    if m == 0 or n == 0:
        return out
    x, w_q = x.contiguous(), w_q.contiguous()
    if scales.dtype != torch.float32 or not scales.is_contiguous():
        scales = scales.to(torch.float32).contiguous()
    code = _DTYPE_CODES[x.dtype]
    fused, floats = _plan(m, k, n, code, x.get_device())
    ws = torch.empty(floats, dtype=torch.float32, device=x.device) \
        if floats else None
    b = bias.to(torch.float32).contiguous() \
        if fused and bias is not None else None
    info = _INFO()
    err = launch(LIBRARY.entry("int8_matmul"), x, x.data_ptr(),
                 w_q.data_ptr(), scales.data_ptr(),
                 None if b is None else b.data_ptr(), int(fused and relu),
                 None if ws is None else ws.data_ptr(), floats,
                 out.data_ptr(), m, k, n, code, int(dequantize_first), info)
    _raise_on(err, "int8_matmul")
    route = ROUTES[info[0]]
    KERNEL_INT8_MATMUL.launches += 1
    KERNEL_INT8_ROUTES[route].launches += 1
    LAST_LAUNCH.route, LAST_LAUNCH.splits = route, info[1]
    return out if fused else _epilogue(out, bias, relu)


# ---------------------------------------------------------------------------
# Q8: the static int8 dense layer
# ---------------------------------------------------------------------------

def int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 ``xq (..., K)`` and ``wq (K, N)``
    through ``torch._int_mm`` (the JAX package leaves this product to XLA,
    not to a Pallas kernel). On CUDA ``_int_mm`` takes only M > 16 and K,
    N multiples of 8, and on the H100 cuBLASLt refuses K under 128 at up to
    40 rows: rows, the reduction and columns are zero-padded to that, which
    adds exact zeros, and the result is sliced back."""
    lead, k, n = xq.shape[:-1], xq.shape[-1], wq.shape[1]
    a = xq.reshape(-1, k)
    m = a.shape[0]
    if xq.device.type == "cuda":
        pk, pn = max(128, k + -k % 8) - k, -n % 8
        pm = max(17 - m, 0)
        if pm or pk:
            a = F.pad(a, (0, pk, 0, pm))
        if pk or pn:
            wq = F.pad(wq, (0, pn, 0, pk))
    y = torch._int_mm(a.contiguous(), wq.contiguous())
    return y[:m, :n].reshape(*lead, n)


def quantize_static(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """``x`` quantized to ``x_scale`` as the static path does: an f32
    division, round half to even, clipped to +-127, as int8."""
    return torch.clamp(torch.round(x.float() / x_scale), -127, 127
                       ).to(torch.int8)


def static_int8_dense_reference(x: torch.Tensor, x_scale: torch.Tensor,
                                w_q: torch.Tensor, w_scale: torch.Tensor,
                                bias: Optional[torch.Tensor] = None,
                                relu: bool = False) -> torch.Tensor:
    """Plain version of Q8, the static path as torch ops (the JAX
    ``quantized_call``'s order): ``x`` quantizes to ``x_scale`` (a
    division, round half to even, clip to +-127), the int8 x int8 product
    is exact in int32 (:func:`int8_product`), one f32 rescale by ``x_scale
    * w_scale`` restores float, then the f32 ``bias`` and ``relu``."""
    y = int8_product(quantize_static(x, x_scale), w_q).float() * (
        x_scale * w_scale)
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.relu(y)
    return y


def _check_static(x, x_scale, w_q, w_scale, bias) -> None:
    k, n = w_q.shape if w_q.dim() == 2 else (None, None)
    if (w_q.dim() != 2 or x.dim() < 1 or x.shape[-1] != k
            or x_scale.numel() != 1 or tuple(w_scale.shape) != (n,)
            or (bias is not None and tuple(bias.shape) != (n,))):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, x_scale "
            f"{tuple(x_scale.shape)}, w_q {tuple(w_q.shape)}, w_scale "
            f"{tuple(w_scale.shape)}, bias "
            f"{None if bias is None else tuple(bias.shape)}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"static_int8_dense takes int8 w_q; got {w_q.dtype}")
    if not x.is_floating_point():
        raise TypeError(f"static_int8_dense takes a float x; got {x.dtype}")
    if any(t.device != x.device for t in (x_scale, w_q, w_scale)) or (
            bias is not None and bias.device != x.device):
        raise ValueError("static_int8_dense operands lie on different "
                         "devices")


@functools.lru_cache(maxsize=4096)
def _static_plan(m: int, k: int, n: int, index: int) -> int:
    """The int32 workspace Q8's split-K partial sums need for ``(m, k) @
    (k, n)`` on CUDA device ``index``, from the C side (which owns the
    K slicing)."""
    ints = ctypes.c_longlong(0)
    if LIBRARY.entry("int8_static_plan")(m, k, n, index,
                                         ctypes.byref(ints)) < 0:
        raise RuntimeError(f"static_int8_dense: no plan for M={m} on CUDA "
                           f"device {index}")
    return ints.value


LAST_STATIC_LAUNCH = _Launched()   # Q8's latest launch (route "q8")


def static_int8_dense(x: torch.Tensor, x_scale: torch.Tensor,
                      w_q: torch.Tensor, w_scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      relu: bool = False) -> torch.Tensor:
    """Q8: ``relu(float(quantize(x, x_scale) @ w_q) * (x_scale * w_scale)
    + bias)`` for ``x (..., K)`` with at most :data:`STATIC_MAX_M` rows,
    ``x_scale`` one f32, ``w_q (K, N)`` int8, ``w_scale (N,)`` and ``bias
    (N,)`` f32 → ``(..., N)`` f32, bit for bit
    :func:`static_int8_dense_reference`. CUDA tensors launch the kernel
    (or raise, also above 32 rows); CPU tensors run the plain version."""
    _check_static(x, x_scale, w_q, w_scale, bias)
    if not x.is_cuda:
        return static_int8_dense_reference(x, x_scale, w_q, w_scale, bias,
                                           relu)
    lead, (k, n) = x.shape[:-1], w_q.shape
    m = math.prod(lead)
    x2 = x.reshape(m, k).float().contiguous()
    if m > STATIC_MAX_M:
        raise ValueError(f"static_int8_dense takes at most {STATIC_MAX_M} "
                         f"rows on CUDA; got {m}")
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out.reshape(*lead, n)
    xs = x_scale.reshape(1).float().contiguous()
    w_q = w_q.contiguous()
    s = w_scale.float().contiguous()
    b = None if bias is None else bias.float().contiguous()
    ints = _static_plan(m, k, n, x.get_device())
    ws = (torch.empty(ints, dtype=torch.int32, device=x.device)
          if ints else None)
    splits = ctypes.c_int(0)
    err = launch(LIBRARY.entry("int8_static_matmul"), x2, x2.data_ptr(),
                 xs.data_ptr(), w_q.data_ptr(), s.data_ptr(),
                 None if b is None else b.data_ptr(), int(relu),
                 None if ws is None else ws.data_ptr(), ints,
                 out.data_ptr(), m, k, n, ctypes.byref(splits))
    _raise_on(err, "static_int8_dense")
    KERNEL_INT8_STATIC.launches += 1
    LAST_STATIC_LAUNCH.route, LAST_STATIC_LAUNCH.splits = "q8", splits.value
    return out.reshape(*lead, n)


# ---------------------------------------------------------------------------
# C8: the static int8 conv layer
# ---------------------------------------------------------------------------

def _bind_conv(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.int8_static_conv2d.argtypes = ([p, p, p, p, p, i, p, p, ll]
                                       + [i] * 19 + [p])
    lib.int8_static_conv2d.restype = ctypes.c_int
    lib.int8_conv_quantize.argtypes = [p, p, p, ll, p]
    lib.int8_conv_quantize.restype = ctypes.c_int
    lib.int8_conv_repack.argtypes = [p, p, i, i, p]
    lib.int8_conv_repack.restype = ctypes.c_int


LIBRARY_CONV = CudaLibrary("conv_int8", ["conv_int8.cu"], _bind_conv)
KERNEL_INT8_CONV = _LaunchCount()     # C8's GEMM, every route
#: C8's routes: the name the wrapper records, the code the C side takes
CONV_ROUTES = {"c8_small_c": 0, "c8_wgmma": 1, "c8_split": 1}
KERNEL_INT8_CONV_ROUTES = {name: _LaunchCount() for name in CONV_ROUTES}
KERNEL_INT8_CONV_QUANTIZE = _LaunchCount()   # C8's quantize pass
KERNEL_INT8_CONV_REPACK = _LaunchCount()     # C8's weight repack
#: C8's latest launch: its route and the K splits it ran
LAST_CONV_LAUNCH = _Launched()

#: c8_small_c: 64 x 64 tiles, 32 k a step, about 4 blocks an SM when split
SMALL_C_TILE, SMALL_C_STEP, SMALL_C_BLOCKS_PER_SM = 64, 32, 4
#: c8_wgmma/c8_split: 128 pixels a tile, 128 k a step, 2 blocks an SM
WGMMA_TILE_M, WGMMA_STEP, WGMMA_BLOCKS_PER_SM = 128, 128, 2
#: the fewest K steps a split takes (small_c, wgmma)
MIN_SPLIT_STEPS = {"small_c": 4, "wgmma": 2}


def conv_takes_kmajor(c: int) -> bool:
    """Whether C8 runs a conv of ``c`` input channels on its wgmma routes,
    which read the quantize pass's int8 input and the repacked (F, K)
    weight: a filter tap's ``c`` bytes must be whole 16-byte chunks."""
    return c % 16 == 0


def _split(tiles: int, steps: int, want: int, least: int):
    """``(splits, per)``: ``steps`` K steps cut into ``splits`` slices of
    ``per`` steps, enough for ``tiles`` output tiles to make about
    ``want`` blocks, each slice at least ``least`` steps."""
    splits = max(1, min(-(-want // tiles), steps // least, 65535))
    per = -(-steps // splits)
    return -(-steps // per), per


@functools.lru_cache(maxsize=4096)
def conv_plan(m: int, f: int, k: int, c: int, sms: int):
    """C8's launch for an ``(m, f, k)`` implicit GEMM over ``c`` input
    channels on a card of ``sms`` SMs: ``(route, tile_n, splits, per)``.
    ``c8_small_c`` where ``c % 16 != 0`` (64 x 64 tiles; K split when the
    tiles fill fewer than 4 blocks an SM), else ``c8_wgmma`` (128 pixels
    by 64 filters where ``f <= 64``, else 128) or, where those tiles fill
    less than half the SMs, ``c8_split`` (K split for about 2 blocks an
    SM, at least 2 steps of 128 k a split). ``per`` is the K steps a
    split takes."""
    if not conv_takes_kmajor(c):
        tiles = -(-m // SMALL_C_TILE) * -(-f // SMALL_C_TILE)
        steps = -(-k // SMALL_C_STEP)
        least = MIN_SPLIT_STEPS["small_c"]
        want = sms * SMALL_C_BLOCKS_PER_SM
        if tiles >= want or steps < 2 * least:
            return "c8_small_c", SMALL_C_TILE, 1, steps
        return ("c8_small_c", SMALL_C_TILE,
                *_split(tiles, steps, want, least))
    tn = 64 if f <= 64 else 128
    tiles = -(-m // WGMMA_TILE_M) * -(-f // tn)
    steps = -(-k // WGMMA_STEP)
    least = MIN_SPLIT_STEPS["wgmma"]
    if 2 * tiles > sms or steps < 2 * least:
        return "c8_wgmma", tn, 1, steps
    splits, per = _split(tiles, steps, sms * WGMMA_BLOCKS_PER_SM, least)
    return ("c8_split" if splits > 1 else "c8_wgmma"), tn, splits, per


@functools.lru_cache(maxsize=64)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def repack_conv_weight_reference(w_q: torch.Tensor) -> torch.Tensor:
    """Plain version of C8's weight repack: the HWIO ``w_q (kh, kw, C,
    F)`` read as ``(K, F)`` and transposed to ``(F, K)``, K contiguous."""
    return w_q.reshape(-1, w_q.shape[-1]).t().contiguous()


def repack_conv_weight(w_q: torch.Tensor) -> torch.Tensor:
    """C8's weight repack, ``(kh, kw, C, F)`` int8 -> ``(F, kh·kw·C)``
    int8 with K contiguous, the layout its wgmma routes read (``wgmma``
    takes s8 operands only K-major). A static model makes it once, where
    it is installed; :func:`static_int8_conv2d` makes it per call when it
    is not given. CUDA tensors launch the kernel (or raise); CPU tensors
    run :func:`repack_conv_weight_reference`."""
    if w_q.dim() != 4 or w_q.dtype != torch.int8:
        raise ValueError(f"repack_conv_weight takes an int8 HWIO weight; "
                         f"got {w_q.dtype} {tuple(w_q.shape)}")
    if not w_q.is_cuda:
        return repack_conv_weight_reference(w_q)
    f = w_q.shape[-1]
    k = w_q.numel() // f if f else 0
    w_q = w_q.contiguous()
    wk = torch.empty(f, k, dtype=torch.int8, device=w_q.device)
    if wk.numel() == 0:
        return wk
    err = launch(LIBRARY_CONV.entry("int8_conv_repack"), w_q,
                 w_q.data_ptr(), wk.data_ptr(), k, f)
    _raise_on(err, "repack_conv_weight")
    KERNEL_INT8_CONV_REPACK.launches += 1
    return wk


def static_int8_quantize(x: torch.Tensor,
                         x_scale: torch.Tensor) -> torch.Tensor:
    """C8's quantize pass: ``x`` (any shape, float) quantized to the one
    f32 ``x_scale`` (on the device) as int8 of the same shape, bit for bit
    :func:`quantize_static`: an IEEE division, round half to even,
    clipped to +-127. CUDA tensors launch the kernel (or raise); CPU
    tensors run :func:`quantize_static`."""
    if x_scale.numel() != 1 or x_scale.device != x.device:
        raise ValueError(f"static_int8_quantize takes one x_scale on x's "
                         f"device; got {tuple(x_scale.shape)} on "
                         f"{x_scale.device}")
    if not x.is_cuda:
        return quantize_static(x, x_scale)
    x = x.float().contiguous()
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel() == 0:
        return xq
    xs = x_scale.reshape(1).float().contiguous()
    err = launch(LIBRARY_CONV.entry("int8_conv_quantize"), x, x.data_ptr(),
                 xs.data_ptr(), xq.data_ptr(), x.numel())
    _raise_on(err, "static_int8_quantize")
    KERNEL_INT8_CONV_QUANTIZE.launches += 1
    return xq


def _conv_geometry(x_shape, w_shape, strides, dilation, pads):
    """``(Ho, Wo)`` of the conv of ``x (B, H, W, C)`` with ``w (kh, kw, C,
    F)``."""
    (_, h, w, _), (kh, kw) = x_shape, w_shape[:2]
    (sh, sw), (dh, dw) = strides, dilation
    (lh, hh), (lw, hw) = pads
    return ((h + lh + hh - (kh - 1) * dh - 1) // sh + 1,
            (w + lw + hw - (kw - 1) * dw - 1) // sw + 1)


def _check_conv(x, x_scale, w_q, w_scale, bias) -> None:
    if (x.dim() != 4 or w_q.dim() != 4 or x.shape[3] != w_q.shape[2]
            or x_scale.numel() != 1 or tuple(w_scale.shape) != (w_q.shape[3],)
            or (bias is not None and tuple(bias.shape) != (w_q.shape[3],))):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)} (NHWC), x_scale "
            f"{tuple(x_scale.shape)}, w_q {tuple(w_q.shape)} (HWIO), "
            f"w_scale {tuple(w_scale.shape)}, bias "
            f"{None if bias is None else tuple(bias.shape)}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"static_int8_conv2d takes int8 w_q; got "
                        f"{w_q.dtype}")
    if not x.is_floating_point():
        raise TypeError(f"static_int8_conv2d takes a float x; got "
                        f"{x.dtype}")
    if any(t.device != x.device for t in (x_scale, w_q, w_scale)) or (
            bias is not None and bias.device != x.device):
        raise ValueError("static_int8_conv2d operands lie on different "
                         "devices")


def static_int8_conv2d_reference(x, x_scale, w_q, w_scale, bias=None,
                                 relu=False, strides=(1, 1),
                                 dilation=(1, 1),
                                 pads=((0, 0), (0, 0))) -> torch.Tensor:
    """Plain version of C8, the JAX ``Convolution2D.quantized_call``'s
    order: ``x (B, H, W, C)`` quantized to ``x_scale``, zero-padded by
    ``pads`` ``((lo, hi), (lo, hi))`` (zeros are exact after quantizing),
    the int8 conv with ``w_q (kh, kw, C, F)`` exact (``F.conv2d`` in
    float64 on the int8 values: every partial sum is an integer below
    127² · K < 2⁵³), then ``float(acc) * (x_scale * w_scale)``, the f32
    ``bias`` and ``relu`` → ``(B, Ho, Wo, F)`` f32."""
    (lh, hh), (lw, hw) = pads
    xq = F.pad(quantize_static(x, x_scale), (0, 0, lw, hw, lh, hh))
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                   w_q.permute(3, 2, 0, 1).double(), stride=tuple(strides),
                   dilation=tuple(dilation))
    y = (acc.permute(0, 2, 3, 1).to(torch.int32).float()
         * (x_scale.float() * w_scale.float()))
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.relu(y)
    return y


def static_int8_conv2d(x: torch.Tensor, x_scale: torch.Tensor,
                       w_q: torch.Tensor, w_scale: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       relu: bool = False, strides=(1, 1), dilation=(1, 1),
                       pads=((0, 0), (0, 0)),
                       w_kmajor: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """C8: the static int8 ``Convolution2D`` forward as an implicit GEMM
    (``csrc/conv_int8.cu``): ``x (B, H, W, C)`` quantized to ``x_scale``,
    any stride, dilation and ``(lo, hi)`` zero padding, the int8 x int8
    products exact in int32, and the f32 epilogue (rescale, bias, ReLU)
    per output channel → ``(B, Ho, Wo, F)`` f32, bit for bit
    :func:`static_int8_conv2d_reference`. The route follows the shape
    (:func:`conv_plan`): where ``C % 16 == 0`` the quantize pass
    (:func:`static_int8_quantize`) and ``wgmma`` s8 tiles over the
    repacked ``(F, K)`` weight, ``w_kmajor`` (:func:`repack_conv_weight`
    of ``w_q``; repacked here when not given), with K split over blocks
    where the output tiles are few; else the quantize-on-load
    ``mma.sync`` kernel. :data:`KERNEL_INT8_CONV` counts the GEMM's
    launches, :data:`KERNEL_INT8_CONV_ROUTES` each route's and
    :data:`LAST_CONV_LAUNCH` holds the latest route and K splits. CUDA
    tensors launch the kernels (or raise); CPU tensors run the plain
    version."""
    _check_conv(x, x_scale, w_q, w_scale, bias)
    (b, h, w, c), (kh, kw, _, f) = x.shape, w_q.shape
    if w_kmajor is not None and (
            w_kmajor.dtype != torch.int8 or w_kmajor.device != x.device
            or tuple(w_kmajor.shape) != (f, kh * kw * c)):
        raise ValueError(f"static_int8_conv2d: w_kmajor must be the "
                         f"({f}, {kh * kw * c}) int8 repack of w_q on "
                         f"{x.device}; got {w_kmajor.dtype} "
                         f"{tuple(w_kmajor.shape)} on {w_kmajor.device}")
    if not x.is_cuda:
        return static_int8_conv2d_reference(x, x_scale, w_q, w_scale, bias,
                                            relu, strides, dilation, pads)
    return _launch_conv(x, x_scale, w_q, w_scale, bias, relu, strides,
                        dilation, pads, w_kmajor)


def _launch_conv(x, x_scale, w_q, w_scale, bias, relu, strides, dilation,
                 pads, w_kmajor) -> torch.Tensor:
    """C8 on checked operands: the plan, then the quantize pass and the
    repack where the route reads them, and the GEMM's launch, counted."""
    (b, h, w, c), (kh, kw, _, f) = x.shape, w_q.shape
    ho, wo = _conv_geometry(x.shape, w_q.shape, strides, dilation, pads)
    if ho < 1 or wo < 1 or min(*strides, *dilation) < 1 or min(
            p for pair in pads for p in pair) < 0:
        raise ValueError(f"static_int8_conv2d: no output for x "
                         f"{tuple(x.shape)}, w {tuple(w_q.shape)}, strides "
                         f"{strides}, dilation {dilation}, pads {pads}")
    if b * ho * wo >= 2 ** 31 or b * h * w * c >= 2 ** 31:
        raise ValueError("static_int8_conv2d: more than 2**31 elements")
    m = b * ho * wo
    route, tn, splits, per = conv_plan(m, f, kh * kw * c, c,
                                       _sm_count(x.get_device()))
    out = torch.empty(b, ho, wo, f, dtype=torch.float32, device=x.device)
    xs = x_scale.reshape(1).float().contiguous()
    if route == "c8_small_c":
        src, wsrc = x.float().contiguous(), w_q.contiguous()
    else:
        src = static_int8_quantize(x, xs)
        wsrc = (w_kmajor.contiguous() if w_kmajor is not None
                else repack_conv_weight(w_q))
    s = w_scale.float().contiguous()
    bb = None if bias is None else bias.float().contiguous()
    (sh, sw), (dh, dw), ((lh, _), (lw, _)) = strides, dilation, pads
    ints = m * f if splits > 1 else 0
    ws = (torch.empty(ints, dtype=torch.int32, device=x.device)
          if ints else None)
    err = launch(LIBRARY_CONV.entry("int8_static_conv2d"), out,
                 src.data_ptr(), xs.data_ptr(), wsrc.data_ptr(),
                 s.data_ptr(), None if bb is None else bb.data_ptr(),
                 int(relu), out.data_ptr(),
                 None if ws is None else ws.data_ptr(), ints, b, h, w, c,
                 kh, kw, f, ho, wo, sh, sw, dh, dw, lh, lw,
                 CONV_ROUTES[route], tn, splits, per)
    _raise_on(err, "static_int8_conv2d")
    KERNEL_INT8_CONV.launches += 1
    KERNEL_INT8_CONV_ROUTES[route].launches += 1
    LAST_CONV_LAUNCH.route, LAST_CONV_LAUNCH.splits = route, splits
    return out
