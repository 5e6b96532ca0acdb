"""Fused LM-head cross-entropy kernels — the Hopper counterpart of
``analytics_zoo_tpu/ops/pallas/cross_entropy.py``: the forward (kernel K4)
and the two-kernel backward (K5a dh, K5b dW/db), behind
``ops/fused_cross_entropy.py``.

:func:`fused_ce_forward` returns, per row of ``h @ w [+ b]``, the f32
``logsumexp`` and the label's logit without ever writing a logits tile to
device memory. :func:`fused_ce_backward` re-forms each probability tile
from the saved lse and folds ``dl = (p - onehot) * scale`` straight into
``dh = dl Wᵀ`` (K5a) and ``dW = hᵀ dl``, ``db = Σ_rows dl`` (K5b).

Contracts, as in the JAX package: ``h`` (N, H) in the compute dtype
(float32 or bfloat16), ``w`` (H, V) already cast to it, ``b`` (V,) or None
(added in the compute dtype after the product is rounded to it: Dense's
rounding), ``labels`` (N,) int — a label outside ``[0, V)`` hits no column
(label logit 0, no onehot); ``lse`` and ``scale`` f32 (N,). The backward
returns ``dh`` in ``dh_dtype`` (default ``h.dtype``) and ``dW``/``db`` in
f32; ``dl`` enters both products rounded to the compute dtype, ``db`` sums
it in f32 before the rounding.

On a CUDA tensor each wrapper launches the kernels in
``csrc/fused_cross_entropy.cu`` or raises, for any hidden width: ``h``'s
columns and ``w``'s rows are padded with zeros to a multiple of 64 (the
pad adds exact zeros to every logit, as the JAX wrapper's
``pad_to_multiple`` does) and ``dh``/``dW`` are sliced back; the kernels
stage H in slices of at most 1024. Each kernel's C entry point picks its
kernel by shape and reports it (:data:`KERNEL_CE_FWD_ROUTES`,
:data:`KERNEL_CE_BWD_DH_ROUTES`, :data:`KERNEL_CE_BWD_DW_ROUTES`;
:data:`LAST_FWD_LAUNCH`, :data:`LAST_DH_LAUNCH`, :data:`LAST_DW_LAUNCH`):
in bf16 a ``wgmma`` kernel fed by TMA where TMA can address the operands
(the LM path), an ``mma.sync`` one elsewhere, FMAs in f32.
On a CPU tensor it runs the plain version
(:func:`fused_ce_forward_reference`,
:func:`fused_ce_backward_reference`), which follows the kernels' rounding
points and walks the rows in chunks, so it never forms an ``(N, V)``
tensor either; ``zoo.pallas.cross_entropy=false`` routes the fused loss
through it on any device (the JAX package's XLA scan route). The TPU
block selection and sweep do not carry over: the tiles are the kernels'
own.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..cuda_build import CudaLibrary, launch
from .common import pad_to_multiple
from .flash_attention import _LaunchCount

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels take a hidden width that is a multiple of this; the
#: wrappers pad to it
HIDDEN_ALIGN = 64
#: rows per streamed logits tile of the plain versions (512·V·4 bytes of
#: transient f32 per tile); ``zoo.train.fused_ce_chunk`` overrides it on
#: the fused loss's plain route
DEFAULT_CHUNK = 512


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    route = ctypes.POINTER(i)
    lib.fused_ce_fwd.argtypes = [p] * 6 + [i] * 4 + [route, p]
    lib.fused_ce_bwd_dh.argtypes = [p] * 7 + [i] * 5 + [route, p]
    lib.fused_ce_bwd_dw.argtypes = [p] * 8 + [i] * 4 + [route, p]
    for fn in (lib.fused_ce_fwd, lib.fused_ce_bwd_dh, lib.fused_ce_bwd_dw):
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("fused_cross_entropy", ["fused_cross_entropy.cu"],
                      _bind)

KERNEL_CE_FWD = _LaunchCount()      # K4
KERNEL_CE_BWD_DH = _LaunchCount()   # K5a
KERNEL_CE_BWD_DW = _LaunchCount()   # K5b
#: each kernel's routes, by the code its C entry point reports: ``wgmma``
#: (bf16 where TMA can address the operands: padded H <= 512, V % 8 == 0,
#: h and w 16-byte aligned — the LM path), ``mma`` (the other bf16
#: shapes), ``fma`` (f32)
ROUTES = ("wgmma", "mma", "fma")
KERNEL_CE_FWD_ROUTES = {name: _LaunchCount() for name in ROUTES}
KERNEL_CE_BWD_DH_ROUTES = {name: _LaunchCount() for name in ROUTES}
KERNEL_CE_BWD_DW_ROUTES = {name: _LaunchCount() for name in ROUTES}


class _Launch:
    """The route of a kernel's latest launch, as its C entry point
    reported it (None before the first)."""

    __slots__ = ("route",)

    def __init__(self):
        self.route = None


LAST_FWD_LAUNCH = _Launch()
LAST_DH_LAUNCH = _Launch()
LAST_DW_LAUNCH = _Launch()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _chunk_logits(hc: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor]) -> torch.Tensor:
    """One (chunk, V) f32 logits tile with Dense's rounding: the f32
    product rounded to the compute dtype, the bias added in it, then
    upcast (the kernels' ``logits_tile`` + finish)."""
    cd = hc.dtype
    logits = torch.matmul(hc.float(), w.float()).to(cd)
    if b is not None:
        logits = logits + b.to(cd)
    return logits.float()


def _hits(labels: torch.Tensor, v: int) -> torch.Tensor:
    """``(rows, V)`` bool onehot of the labels that hit a column."""
    cols = torch.arange(v, device=labels.device)
    return cols[None, :] == labels.long()[:, None]


def _chunks(n: int, chunk: int):
    for i in range(0, n, chunk):
        yield slice(i, i + chunk)


def fused_ce_forward_reference(h: torch.Tensor, w: torch.Tensor,
                               b: Optional[torch.Tensor],
                               labels: torch.Tensor,
                               chunk: int = DEFAULT_CHUNK
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: per-row ``(lse, label_logit)`` over row
    chunks of ``chunk`` (the largest live tensor is one ``(chunk, V)``
    tile). Rows are padded to the chunk with zeros and label -1 and the
    pad is sliced off, as the kernel and the JAX scan pad."""
    n = h.shape[0]
    hp = pad_to_multiple(h, 0, chunk)
    lp = pad_to_multiple(labels.to(torch.int32), 0, chunk, value=-1)
    lse = torch.empty(hp.shape[0], dtype=torch.float32, device=h.device)
    ll = torch.empty_like(lse)
    for sl in _chunks(hp.shape[0], chunk):
        logits = _chunk_logits(hp[sl], w, b)
        m = logits.amax(dim=-1)
        lse[sl] = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
        ll[sl] = torch.where(_hits(lp[sl], w.shape[1]), logits,
                             torch.zeros((), device=h.device)).sum(dim=-1)
    return lse[:n], ll[:n]


def fused_ce_backward_reference(h: torch.Tensor, w: torch.Tensor,
                                b: Optional[torch.Tensor],
                                labels: torch.Tensor, lse: torch.Tensor,
                                scale: torch.Tensor, dh_dtype=None,
                                chunk: int = DEFAULT_CHUNK):
    """Plain version of K5a + K5b: ``(dh, dW, db)`` over row chunks, with
    the kernels' rounding points (dl rounded to the compute dtype before
    both products, db summed from the f32 dl). Pad rows carry lse = +inf
    and scale 0, so a large bias can never turn them into ``inf * 0``."""
    n, hidden = h.shape
    v = w.shape[1]
    cd = h.dtype
    hp = pad_to_multiple(h, 0, chunk)
    lp = pad_to_multiple(labels.to(torch.int32), 0, chunk, value=-1)
    lsep = pad_to_multiple(lse.float(), 0, chunk, value=math.inf)
    sp = pad_to_multiple(scale.float(), 0, chunk)
    wf = w.float()
    dh = torch.empty(hp.shape[0], hidden, dtype=dh_dtype or cd,
                     device=h.device)
    dw = torch.zeros(hidden, v, dtype=torch.float32, device=h.device)
    db = (torch.zeros(v, dtype=torch.float32, device=h.device)
          if b is not None else None)
    for sl in _chunks(hp.shape[0], chunk):
        logits = _chunk_logits(hp[sl], w, b)
        p = torch.exp(logits - lsep[sl, None])
        dl = (p - _hits(lp[sl], v).float()) * sp[sl, None]
        dlc = dl.to(cd).float()
        dh[sl] = torch.matmul(dlc, wf.T).to(dh.dtype)
        dw += torch.matmul(hp[sl].float().T, dlc)
        if db is not None:
            db += dl.sum(dim=0)
    return dh[:n], dw, db


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(h, w, b, labels) -> None:
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[0]:
        raise ValueError(f"fused CE takes h (N, H) and w (H, V); got "
                         f"{tuple(h.shape)} and {tuple(w.shape)}")
    if h.dtype != w.dtype or h.dtype not in _DTYPE_CODES:
        raise TypeError(f"h and w must share float32 or bfloat16; got "
                        f"{h.dtype}/{w.dtype}")
    if labels.shape != (h.shape[0],):
        raise ValueError(f"labels must be (N,) = ({h.shape[0]},); got "
                         f"{tuple(labels.shape)}")
    if b is not None and b.shape != (w.shape[1],):
        raise ValueError(f"b must be (V,) = ({w.shape[1]},); got "
                         f"{tuple(b.shape)}")
    for t in (w, labels) + ((b,) if b is not None else ()):
        if t.device != h.device:
            raise ValueError("fused CE operands lie on different devices")
    if h.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused CE runs on cuda or cpu, not "
                         f"{h.device.type}")


def _kernel_operands(h, w, b, labels):
    """``(h, w, b, labels)`` as the kernels take them: h and w contiguous
    (checked), H zero-padded to a multiple of ``HIDDEN_ALIGN``, h 16-byte
    aligned (its bf16 rows are read as 16-byte vectors); bias f32, labels
    int32."""
    for name, t in (("h", h), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA "
                             f"kernels")
    h = pad_to_multiple(h, 1, HIDDEN_ALIGN)
    w = pad_to_multiple(w, 0, HIDDEN_ALIGN)
    if h.data_ptr() % 16:
        raise ValueError("h must start on a 16-byte boundary for the CUDA "
                         "kernels")
    b = None if b is None else b.to(torch.float32).contiguous()
    return h, w, b, labels.to(torch.int32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _launch_routed(name: str, total: _LaunchCount, by_route: dict,
                   last: _Launch, h: torch.Tensor, *args) -> None:
    """Launches entry point ``name`` (its route pointer last before the
    stream), raises on a failed launch, and counts the launch in all and
    under the route the C side reported."""
    route = ctypes.c_int(-1)
    err = launch(LIBRARY.entry(name), h, *args, ctypes.byref(route))
    _raise_on(err, name)
    taken = ROUTES[route.value]
    total.launches += 1
    by_route[taken].launches += 1
    last.route = taken


def fused_ce_forward(h: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor], labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: per-row f32 ``(lse, label_logit)`` of ``h @ w [+ b]``. CUDA
    tensors launch the kernel (or raise); CPU tensors run
    :func:`fused_ce_forward_reference`."""
    _check(h, w, b, labels)
    if h.device.type == "cpu":
        return fused_ce_forward_reference(h, w, b, labels)
    n = h.shape[0]
    if n == 0:
        lse = torch.empty(0, dtype=torch.float32, device=h.device)
        return lse, torch.empty_like(lse)
    return _launch_fwd(*_kernel_operands(h, w, b, labels))


def _launch_fwd(h, w, b, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on checked operands (``_kernel_operands``): ``(lse, ll)``."""
    n = h.shape[0]
    lse = torch.empty(n, dtype=torch.float32, device=h.device)
    ll = torch.empty_like(lse)
    _launch_routed("fused_ce_fwd", KERNEL_CE_FWD, KERNEL_CE_FWD_ROUTES,
                   LAST_FWD_LAUNCH, h, h.data_ptr(), w.data_ptr(), _ptr(b),
                   labels.data_ptr(), lse.data_ptr(), ll.data_ptr(), n,
                   h.shape[1], w.shape[1], _DTYPE_CODES[h.dtype])
    return lse, ll


def _backward_operands(h, w, b, labels, lse, scale):
    """The six inputs of K5a/K5b as the kernels take them (tensors, kept
    alive by the caller until the launch; H padded)."""
    return (*_kernel_operands(h, w, b, labels),
            lse.to(torch.float32).contiguous(),
            scale.to(torch.float32).contiguous())


def _dh_dtype(h, dh_dtype):
    dh_dtype = dh_dtype or h.dtype
    if dh_dtype not in _DTYPE_CODES:
        raise TypeError(f"dh_dtype must be float32 or bfloat16; got "
                        f"{dh_dtype}")
    return dh_dtype


def _launch_dh(ops, dh_dtype, hidden: int) -> torch.Tensor:
    """K5a on checked operands (``_backward_operands``); ``dh`` sliced
    back to the unpadded ``hidden``."""
    h, w = ops[0], ops[1]
    n, hp = h.shape
    dh = torch.empty(n, hp, dtype=dh_dtype, device=h.device)
    if n > 0:
        _launch_routed("fused_ce_bwd_dh", KERNEL_CE_BWD_DH,
                       KERNEL_CE_BWD_DH_ROUTES, LAST_DH_LAUNCH, h,
                       *(_ptr(t) for t in ops), dh.data_ptr(), n, hp,
                       w.shape[1], _DTYPE_CODES[h.dtype],
                       _DTYPE_CODES[dh_dtype])
    return dh if hp == hidden else dh[:, :hidden].contiguous()


def _launch_dw(ops, with_bias: bool, hidden: int):
    """K5b on checked operands (``_backward_operands``); ``dW`` sliced
    back to the unpadded ``hidden`` rows."""
    h, w = ops[0], ops[1]
    n, hp = h.shape
    v = w.shape[1]
    # every kernel writes all of dW and db; with no rows they are zeros
    alloc = torch.empty if n > 0 else torch.zeros
    dw = alloc(hp, v, dtype=torch.float32, device=h.device)
    db = alloc(v, dtype=torch.float32, device=h.device) if with_bias else None
    if n > 0:
        _launch_routed("fused_ce_bwd_dw", KERNEL_CE_BWD_DW,
                       KERNEL_CE_BWD_DW_ROUTES, LAST_DW_LAUNCH, h,
                       *(_ptr(t) for t in ops), dw.data_ptr(), _ptr(db), n,
                       hp, v, _DTYPE_CODES[h.dtype])
    return dw[:hidden], db


def fused_ce_backward_dh(h, w, b, labels, lse, scale,
                         dh_dtype=None) -> torch.Tensor:
    """K5a: ``dh`` in ``dh_dtype`` (default ``h.dtype``). CUDA tensors
    launch the kernel (or raise); CPU tensors take the plain version's
    ``dh``."""
    _check(h, w, b, labels)
    dh_dtype = _dh_dtype(h, dh_dtype)
    if h.device.type == "cpu":
        return fused_ce_backward_reference(h, w, b, labels, lse, scale,
                                           dh_dtype)[0]
    return _launch_dh(_backward_operands(h, w, b, labels, lse, scale),
                      dh_dtype, h.shape[1])


def fused_ce_backward_dw(h, w, b, labels, lse, scale):
    """K5b: f32 ``(dW, db)``, ``db`` None without a bias. CUDA tensors
    launch the kernel (or raise); CPU tensors take the plain version's."""
    _check(h, w, b, labels)
    if h.device.type == "cpu":
        return fused_ce_backward_reference(h, w, b, labels, lse, scale)[1:]
    return _launch_dw(_backward_operands(h, w, b, labels, lse, scale),
                      b is not None, h.shape[1])


def fused_ce_backward(h: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor], labels: torch.Tensor,
                      lse: torch.Tensor, scale: torch.Tensor, dh_dtype=None):
    """K5a + K5b: ``(dh, dW, db)`` from the saved ``lse`` and the per-row
    ``scale`` (the cotangent, 0 on masked rows, NaN on over-range rows).
    ``db`` is None without a bias. CUDA tensors launch the kernels (or
    raise); CPU tensors run :func:`fused_ce_backward_reference`."""
    _check(h, w, b, labels)
    dh_dtype = _dh_dtype(h, dh_dtype)
    if h.device.type == "cpu":
        return fused_ce_backward_reference(h, w, b, labels, lse, scale,
                                           dh_dtype)
    ops = _backward_operands(h, w, b, labels, lse, scale)
    return (_launch_dh(ops, dh_dtype, h.shape[1]),
            *_launch_dw(ops, b is not None, h.shape[1]))
