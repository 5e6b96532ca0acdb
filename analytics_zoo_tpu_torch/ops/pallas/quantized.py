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
reports it: ``skinny`` (M <= 32), ``wgmma`` (bf16, M > 32, K % 8 == 0 and
N % 16 == 0 with 16-byte aligned operands: the rows TMA can address;
every BERT product), ``mma`` (the other bf16 shapes) and ``fma`` (f32,
M > 32). :data:`KERNEL_INT8_MATMUL` counts every launch and
:data:`KERNEL_INT8_ROUTES` each route's.
The JAX wrapper's ``block_m``/``block_n``/``interpret`` arguments are TPU
tiling and the Pallas interpreter; they are not carried over (the CUDA
kernels pick their own tiles and take any M, K and N).
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda_build import CudaLibrary
from .cross_entropy import _raise_on
from .flash_attention import _LaunchCount

__all__ = ["int8_matmul", "int8_matmul_reference"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int8_matmul.argtypes = [p, p, p, p, i, i, i, i, i, p,
                                ctypes.POINTER(i)]
    lib.int8_matmul.restype = ctypes.c_int


LIBRARY = CudaLibrary("quantized", ["quantized.cu"], _bind)

KERNEL_INT8_MATMUL = _LaunchCount()   # K6, every route
#: the kernel the C entry point took, by the code it reports
ROUTES = ("wgmma", "mma", "skinny", "fma")
KERNEL_INT8_ROUTES = {name: _LaunchCount() for name in ROUTES}


def _check(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor) -> None:
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0] \
            or tuple(scales.shape) != (w_q.shape[1],):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}, scales {tuple(scales.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_matmul takes float32 or bfloat16 x; got "
                        f"{x.dtype}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 w_q; got {w_q.dtype}")
    if not (x.device == w_q.device == scales.device):
        raise ValueError("int8_matmul operands lie on different devices")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"int8_matmul runs on cuda or cpu, not "
                         f"{x.device.type}")


def int8_matmul_reference(x: torch.Tensor, w_q: torch.Tensor,
                          scales: torch.Tensor,
                          dequantize_first: bool = False) -> torch.Tensor:
    """Plain version of K6. By default the TPU kernel's arithmetic: the f32
    product, then the per-column scale, then one rounding to ``x``'s
    dtype. ``dequantize_first``: the JAX weight-only predict's, each
    weight ``q * s`` formed in ``x``'s dtype (``s`` rounded to it first),
    then the f32 product rounded once."""
    if dequantize_first:
        w = w_q.to(x.dtype) * scales.to(x.dtype)
        return (x.float() @ w.float()).to(x.dtype)
    return ((x.float() @ w_q.float()) * scales.float()).to(x.dtype)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor,
                dequantize_first: bool = False) -> torch.Tensor:
    """K6: ``x (M, K) @ dequant(w_q (K, N) int8, scales (N,))`` → ``(M, N)``
    in ``x.dtype``; by default ``(x @ w_q.float()) * scales``, the Pallas
    contract, with ``dequantize_first`` ``x @ (w_q.to(x.dtype) *
    scales.to(x.dtype))``, the JAX predict's (see the module docstring).
    CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`int8_matmul_reference`."""
    _check(x, w_q, scales)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q, scales, dequantize_first)
    (m, k), n = x.shape, w_q.shape[1]
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    x, w_q = x.contiguous(), w_q.contiguous()
    scales = scales.to(torch.float32).contiguous()
    route = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        err = LIBRARY.get().int8_matmul(
            x.data_ptr(), w_q.data_ptr(), scales.data_ptr(), out.data_ptr(),
            m, k, n, _DTYPE_CODES[x.dtype], int(dequantize_first),
            torch.cuda.current_stream(x.device).cuda_stream,
            ctypes.byref(route))
    _raise_on(err, "int8_matmul")
    KERNEL_INT8_MATMUL.launches += 1
    KERNEL_INT8_ROUTES[ROUTES[route.value]].launches += 1
    return out
