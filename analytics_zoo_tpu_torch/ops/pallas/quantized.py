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

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs :func:`int8_matmul_reference`, the TPU kernel's own arithmetic.
The JAX wrapper's ``block_m``/``block_n``/``interpret`` arguments are TPU
tiling and the Pallas interpreter; they are not carried over (the CUDA
kernel picks its own tiles and takes any M, K and N).
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
    lib.int8_matmul.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.int8_matmul.restype = ctypes.c_int


LIBRARY = CudaLibrary("quantized", ["quantized.cu"], _bind)

KERNEL_INT8_MATMUL = _LaunchCount()   # K6


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
                          scales: torch.Tensor) -> torch.Tensor:
    """Plain version of K6, the TPU kernel's arithmetic: the f32 product,
    then the per-column scale, then one rounding to ``x``'s dtype."""
    return ((x.float() @ w_q.float()) * scales.float()).to(x.dtype)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scales: torch.Tensor) -> torch.Tensor:
    """K6: ``x (M, K) @ dequant(w_q (K, N) int8, scales (N,))`` → ``(M, N)``
    in ``x.dtype``; equivalent to ``x @ (w_q.float() * scales)``. CUDA
    tensors launch the kernel (or raise); CPU tensors run
    :func:`int8_matmul_reference`."""
    _check(x, w_q, scales)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q, scales)
    (m, k), n = x.shape, w_q.shape[1]
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    x, w_q = x.contiguous(), w_q.contiguous()
    scales = scales.to(torch.float32).contiguous()
    with torch.cuda.device(x.device):
        err = LIBRARY.get().int8_matmul(
            x.data_ptr(), w_q.data_ptr(), scales.data_ptr(), out.data_ptr(),
            m, k, n, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "int8_matmul")
    KERNEL_INT8_MATMUL.launches += 1
    return out
