"""Flash attention — the Hopper counterpart of
``analytics_zoo_tpu/ops/pallas/flash_attention.py``: the forward (kernel
K2) and the two-kernel backward (K3a dq, K3b dk/dv).

:func:`flash_attention` keeps the JAX package's contract: q ``(B, H, Tq,
D)``, k/v ``(B, H, Tk, D)`` in float32 or bfloat16; ``mask`` an optional
``(B, Tk)`` keep-mask where values ``>= 1.0`` attend; causal masking is
bottom-right aligned (``offset = Tk - Tq``); a query row that sees no key
returns zeros (the oracle ``dot_product_attention`` returns uniform
weights there instead); accumulation is f32; the output keeps the input
dtype. ``want_lse=True`` also returns the f32 row log-sum-exp ``(B, H,
Tq)``, ``+inf`` for empty rows.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/flash_attention_fwd.cu`` (bf16: ``wgmma`` on TMA-fed tiles; f32:
CUDA-core FMAs) or raises; on a CPU tensor it runs
:func:`flash_attention_reference`, the plain PyTorch version with the same
semantics. Tile sizes are the kernel's own; the TPU block selection and
sweep do not carry over.

Gradients: when autograd records (grad enabled and q, k or v requires
grad), :func:`flash_attention` goes through :class:`_FlashAttention`, the
counterpart of the JAX ``custom_vjp``. Its forward runs K2 with the lse;
its backward computes ``delta = rowsum(dO * O)`` in f32 as plain torch (the
JAX package computes it in XLA too) and launches K3a and K3b from
``csrc/flash_attention_bwd.cu``, which rebuild each probability tile from
the lse. On CPU tensors the backward is
:func:`flash_attention_bwd_reference`. The mask gets no gradient (the JAX VJP gives it zeros).
Without autograd the call stays one K2 launch without the lse write.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..cuda_build import CudaLibrary, launch

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                        i, ctypes.c_float, p]
    lib.flash_attention_fwd.restype = ctypes.c_int


def _bind_bwd(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, n_out in ((lib.flash_attention_bwd_dq, 1),
                      (lib.flash_attention_bwd_dkv, 2)):
        fn.argtypes = ([p] * (7 + n_out) + [i] * 7
                       + [ctypes.c_float, p])
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("flash_attention_fwd", ["flash_attention_fwd.cu"],
                      _bind)
LIBRARY_BWD = CudaLibrary("flash_attention_bwd", ["flash_attention_bwd.cu"],
                          _bind_bwd)


class _LaunchCount:
    """Kernel launches made through :func:`flash_attention` (incremented
    exactly where the kernel is launched)."""

    def __init__(self):
        self.launches = 0

    def reset(self) -> None:
        self.launches = 0


KERNEL = _LaunchCount()            # K2, the forward
KERNEL_BWD_DQ = _LaunchCount()     # K3a
KERNEL_BWD_DKV = _LaunchCount()    # K3b


def _visible(t_q: int, t_kv: int, mask: Optional[torch.Tensor],
             causal: bool, device) -> torch.Tensor:
    """The kernels' visibility rule as a ``(B or 1, 1, Tq, Tk)`` bool:
    bottom-right causal alignment and the ``>= 1.0`` key-padding rule."""
    ok = torch.ones(t_q, t_kv, dtype=torch.bool, device=device)
    if causal:
        q_pos = torch.arange(t_q, device=device)[:, None]
        k_pos = torch.arange(t_kv, device=device)[None, :]
        ok = k_pos <= q_pos + (t_kv - t_q)
    ok = ok[None, None]
    if mask is not None:
        ok = ok & (mask.float() >= 1.0)[:, None, None, :]
    return ok


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              mask: Optional[torch.Tensor] = None,
                              causal: bool = False, want_lse: bool = False):
    """Plain PyTorch version of the kernel: the whole score matrix at
    once, with the kernel's rules for masks, causal alignment, empty rows
    and the lse. Probabilities enter the second product in the operand
    dtype, as the TPU kernel's ``p.astype(v.dtype)`` does."""
    scale = 1.0 / float(q.shape[3]) ** 0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    ok = _visible(q.shape[2], k.shape[2], mask, causal, q.device)
    s = s.masked_fill(~ok, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.where(ok, torch.exp(s - m_safe), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    empty = l == 0.0
    denom = torch.where(empty, torch.ones_like(l), l)
    out = (torch.matmul(p.to(v.dtype).float(), v.float()) / denom
           ).to(q.dtype)
    if not want_lse:
        return out
    lse = torch.where(empty, torch.full_like(l, math.inf),
                      m + torch.log(denom))
    return out, lse[..., 0]


def _delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * O)`` in f32 from both in their dtype, ``(B, H, Tq)``."""
    return (do.float() * out.float()).sum(dim=-1)


def _p_and_ds(q, k, v, mask, lse, delta, do, causal: bool):
    """The probability tile rebuilt from the lse (``+inf`` rows give exact
    zeros) and ``dS = P * (dP - delta)``, both f32, as each backward
    kernel recomputes them."""
    scale = 1.0 / float(q.shape[3]) ** 0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    ok = _visible(q.shape[2], k.shape[2], mask, causal, q.device)
    p = torch.where(ok, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=q.device))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def bwd_dq_reference(q, k, v, mask, lse, delta, do, causal: bool = False):
    """Plain version of K3a: ``dq = scale * (dS in K's dtype) K``, the scale
    applied to the f32 product."""
    _, ds = _p_and_ds(q, k, v, mask, lse, delta, do, causal)
    scale = 1.0 / float(q.shape[3]) ** 0.5
    return (torch.matmul(ds.to(k.dtype).float(), k.float()) * scale
            ).to(q.dtype)


def bwd_dkv_reference(q, k, v, mask, lse, delta, do, causal: bool = False):
    """Plain version of K3b: ``dk = scale * (dS in Q's dtype)^T Q`` and
    ``dv = (P in dO's dtype)^T dO``."""
    p, ds = _p_and_ds(q, k, v, mask, lse, delta, do, causal)
    scale = 1.0 / float(q.shape[3]) ** 0.5
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()) * scale
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, mask, out, lse, do,
                                  causal: bool = False):
    """Plain PyTorch version of K3a + K3b: ``(dq, dk, dv)`` in the input
    dtype, with ``delta = rowsum(dO * O)`` computed in f32 from both in
    their dtype. The kernels' rounding points are kept: P enters the dv
    product in dO's dtype, dS enters the dq and dk products in K's and Q's
    dtype, and the softmax scale multiplies the f32 product after it."""
    delta = _delta(do, out)
    dq = bwd_dq_reference(q, k, v, mask, lse, delta, do, causal)
    return (dq, *bwd_dkv_reference(q, k, v, mask, lse, delta, do, causal))


def _check(q, k, v, mask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, H, T, D) q/k/v")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} "
                         f"does not fit q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q/k/v must share float32 or bfloat16; got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v lie on different devices")
    if mask is not None:
        if isinstance(mask, bool):
            raise TypeError("the 4th argument is the key-padding mask; "
                            "pass causal=... by keyword")
        if mask.shape != (b, k.shape[2]):
            raise ValueError(f"mask must be (B, Tk) = {(b, k.shape[2])}; "
                             f"got {tuple(mask.shape)} — reduce broadcast "
                             f"masks at the layer level")
        if mask.device != q.device:
            raise ValueError("mask lies on another device than q")


def _check_operands(d: int, **tensors) -> None:
    """What the CUDA kernels need of their operands: a head dim they are
    built for, and each tensor contiguous from a 16-byte boundary (the f32
    kernels read 16-byte vectors; the bf16 forward reads q, k and v, and the
    bf16 backward q, k, v, dO, lse and delta, through TMA, whose tensor maps
    take only 16-byte aligned bases, rows of D * 2 bytes being multiples of
    16 for every head dim here). An operand that breaks this is refused
    before any launch, never handed to another route."""
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dim {HEAD_DIMS}; "
                         f"got {d}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA "
                             f"kernel")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"for the CUDA kernel")


def _launch(q, k, v, mask, causal: bool, want_lse: bool):
    b, h, t_q, d = q.shape
    t_kv = k.shape[2]
    _check_operands(d, q=q, k=k, v=v)
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if out.numel() == 0:
        return (out, lse) if want_lse else out
    err = launch(
        LIBRARY.entry("flash_attention_fwd"), q, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), b, h, t_q,
        t_kv, d, int(causal), _DTYPE_CODES[q.dtype], 1.0 / float(d) ** 0.5)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA "
                           f"error {err}")
    KERNEL.launches += 1
    return (out, lse) if want_lse else out


def _launch_bwd_kernel(name: str, counter: _LaunchCount, q, k, v, mask,
                       lse, delta, do, causal: bool, outs):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device.type}")
    b, h, t_q, d = q.shape
    for t in (lse, delta):
        if t.dtype != torch.float32 or t.shape != (b, h, t_q) \
                or not t.is_contiguous():
            raise ValueError("lse/delta must be contiguous f32 (B, H, Tq)")
    _check_operands(d, q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    if outs[0].numel() == 0:
        return
    err = launch(
        LIBRARY_BWD.entry(name), q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        None if mask is None else mask.data_ptr(),
        *(t.data_ptr() for t in outs), b, h, t_q, k.shape[2], d,
        int(causal), _DTYPE_CODES[q.dtype], 1.0 / float(d) ** 0.5)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    counter.launches += 1


def bwd_dq(q, k, v, mask, lse, delta, do, causal: bool = False):
    """K3a: ``dq`` from ``delta = rowsum(dO * O)``. CUDA tensors launch the
    kernel (or raise); CPU tensors run :func:`bwd_dq_reference`."""
    if q.device.type == "cpu":
        return bwd_dq_reference(q, k, v, mask, lse, delta, do, causal)
    dq = torch.empty_like(q)
    _launch_bwd_kernel("flash_attention_bwd_dq", KERNEL_BWD_DQ, q, k, v,
                       mask, lse, delta, do, causal, (dq,))
    return dq


def bwd_dkv(q, k, v, mask, lse, delta, do, causal: bool = False):
    """K3b: ``(dk, dv)``. CUDA tensors launch the kernel (or raise); CPU
    tensors run :func:`bwd_dkv_reference`."""
    if q.device.type == "cpu":
        return bwd_dkv_reference(q, k, v, mask, lse, delta, do, causal)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd_kernel("flash_attention_bwd_dkv", KERNEL_BWD_DKV, q, k, v,
                       mask, lse, delta, do, causal, (dk, dv))
    return dk, dv


def flash_attention_bwd(q, k, v, mask, out, lse, do, causal: bool = False):
    """``(dq, dk, dv)`` of :func:`flash_attention` from the forward's
    ``out``/``lse`` and the output gradient ``do``: ``delta`` in f32 as
    plain torch (the JAX package computes it in XLA), then K3a and K3b on
    CUDA tensors (or a raise), their plain versions on CPU tensors."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device.type}")
    do = do.contiguous()
    delta = _delta(do, out)
    dq = bwd_dq(q, k, v, mask, lse, delta, do, causal)
    return (dq, *bwd_dkv(q, k, v, mask, lse, delta, do, causal))


def _forward(q, k, v, mask, causal: bool, want_lse: bool):
    if q.device.type == "cuda":
        return _launch(q, k, v, mask, causal, want_lse)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, mask, causal, want_lse)
    raise ValueError(f"flash_attention runs on cuda or cpu, not "
                     f"{q.device.type}")


class _FlashAttention(torch.autograd.Function):
    """The JAX ``custom_vjp`` (``_vjp_fwd``/``_vjp_bwd``): K2 with the lse
    forward, K3a + K3b backward. The mask, the flag and the lse get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        out, lse = _forward(q, k, v, mask, causal, want_lse=True)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.causal = causal
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, lse, do,
                                         ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    causal: bool = False, want_lse: bool = False):
    """Blockwise-softmax attention ``(B, H, Tq, D)`` — see the module
    docstring for the contract. CUDA tensors run the kernels (or raise);
    CPU tensors run the plain versions. Differentiable in q, k and v."""
    _check(q, k, v, mask)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = _FlashAttention.apply(q, k, v, mask, causal)
        return (out, lse) if want_lse else out
    return _forward(q, k, v, mask, causal, want_lse)
