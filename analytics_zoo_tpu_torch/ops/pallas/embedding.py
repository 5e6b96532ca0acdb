"""Dedup'd-embedding kernels — the Hopper counterpart of
``analytics_zoo_tpu/ops/pallas/embedding.py`` (kernel K1) and of the
scatter-add in the dedup'd lookup's backward (kernel SA), behind
``ops/sharded_embedding.py``.

:func:`embed_expand` (K1) expands the ``(capacity, D)`` block of unique
rows to the ``(N, D)`` row stream by the inverse ids: ``rows[inv]``, bit
for bit in every dtype. The TPU kernel does it as a one-hot MXU product;
on the card it is a row gather (``csrc/embedding.cu``).

:func:`dedup_scatter_add` (SA) is the first half of the lookup's
backward: the row cotangents ``g (N, D)`` summed per slot of ``inv`` into
a ``(capacity, D)`` f32 block, each slot's rows in ascending position
order from 0 — the order of the JAX package's CPU scatter. It has no
Pallas counterpart (the JAX backward is an XLA scatter); it exists
because ``index_add_`` on CUDA adds with float atomics in an order that
changes from run to run. The kernel reads the positions sorted stably by
slot and each sorted position's slot: the lookup's forward hands over the
arrays its unique already made (``order``, ``sorted_slot``), so the
backward launches the kernel alone; called without them, the op sorts
``inv`` itself first.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version (:func:`embed_expand_reference`,
:func:`dedup_scatter_add_reference`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..cuda_build import CudaLibrary, launch
from .cross_entropy import _raise_on
from .flash_attention import _LaunchCount

__all__ = ["embed_expand", "embed_expand_reference", "dedup_scatter_add",
           "dedup_scatter_add_reference", "pallas_embed_gather_enabled"]

_DTYPES = (torch.float32, torch.bfloat16)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.embed_expand.argtypes = [p, p, p, i, i, i, p]
    lib.dedup_scatter_add.argtypes = [p, p, p, p, i, i, i, i, p]
    for fn in (lib.embed_expand, lib.dedup_scatter_add):
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("embedding", ["embedding.cu"], _bind)

KERNEL_EMBED_EXPAND = _LaunchCount()   # K1
KERNEL_SCATTER_ADD = _LaunchCount()    # SA


def pallas_embed_gather_enabled(device) -> bool:
    """``zoo.pallas.embed_gather``: auto | true | false. ``auto`` engages
    the expand kernel for tensors on a CUDA ``device`` (the convention of
    ``pallas_ce_enabled``); ``true`` on the CPU runs its plain version."""
    from ...common.context import tri_state_conf
    flag = tri_state_conf("zoo.pallas.embed_gather")
    if flag == "auto":
        return torch.device(device).type == "cuda"
    return flag


def _check(x: torch.Tensor, inv: torch.Tensor, what: str) -> None:
    if x.dim() != 2 or inv.dim() != 1:
        raise ValueError(f"{what} takes a 2-D tensor and (N,) ids; got "
                         f"{tuple(x.shape)} and {tuple(inv.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16; got {x.dtype}")
    if inv.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{what} takes int32 or int64 ids; got {inv.dtype}")
    if x.is_cuda and inv.is_cuda:
        if inv.get_device() != x.get_device():
            raise ValueError(f"{what} operands lie on different devices")
    elif inv.device != x.device:
        raise ValueError(f"{what} operands lie on different devices")
    elif x.device.type != "cpu":
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device.type}")


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def embed_expand_reference(rows: torch.Tensor,
                           inv: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: ``rows[inv]``."""
    return rows[inv.long()]


def embed_expand(rows: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """K1: ``rows[inv]`` for ``rows (capacity, D)`` and ``inv (N,)`` ids in
    ``[0, capacity)``. CUDA tensors launch the kernel (or raise); CPU
    tensors run :func:`embed_expand_reference`."""
    _check(rows, inv, "embed_expand")
    if not rows.is_cuda:
        return embed_expand_reference(rows, inv)
    n, (capacity, d) = inv.shape[0], rows.shape
    out = rows.new_empty((n, d))
    if n == 0 or d == 0:
        return out
    if capacity == 0:
        raise ValueError("embed_expand: no rows to gather from")
    if not rows.is_contiguous():
        rows = rows.contiguous()
    if inv.dtype != torch.int32 or not inv.is_contiguous():
        inv = inv.to(torch.int32).contiguous()
    err = launch(LIBRARY.entry("embed_expand"), rows, rows.data_ptr(),
                 inv.data_ptr(), out.data_ptr(), n, capacity,
                 d * rows.element_size())
    _raise_on(err, "embed_expand")
    KERNEL_EMBED_EXPAND.launches += 1
    return out


# ---------------------------------------------------------------------------
# SA
# ---------------------------------------------------------------------------

def dedup_scatter_add_reference(g: torch.Tensor, inv: torch.Tensor,
                                capacity: int) -> torch.Tensor:
    """Plain version of SA: ``zeros(capacity, D).index_add_(0, inv, g)``
    in f32 — on the CPU, ``index_add_`` adds the rows one after the other
    in position order."""
    out = torch.zeros(capacity, g.shape[1], dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, inv.long(), g.float())


def _check_sorted(order, sorted_slot, g: torch.Tensor,
                  inv: torch.Tensor) -> None:
    """Shape, dtype and device of a handed sort; on the CPU, where the
    plain version reads ``inv`` alone, also that it is ``inv``'s stable
    sort, so a caller handing a wrong one fails there rather than summing
    other rows on the card (which trusts it)."""
    if (order is None) != (sorted_slot is None):
        raise ValueError("dedup_scatter_add takes order and sorted_slot "
                         "together")
    for name, t in (("order", order), ("sorted_slot", sorted_slot)):
        if t.shape != (g.shape[0],) or t.dtype != torch.int64:
            raise ValueError(f"dedup_scatter_add: {name} must be "
                             f"({g.shape[0]},) torch.int64; got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != g.device:
            raise ValueError("dedup_scatter_add operands lie on different "
                             "devices")
    if not g.is_cuda:
        key, idx = torch.sort(inv.long(), stable=True)
        if not (torch.equal(order, idx) and torch.equal(sorted_slot, key)):
            raise ValueError("dedup_scatter_add: order and sorted_slot are "
                             "not the stable sort of inv")


def dedup_scatter_add(g: torch.Tensor, inv: torch.Tensor, capacity: int, *,
                      order: Optional[torch.Tensor] = None,
                      sorted_slot: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """SA: the ``(capacity, D)`` f32 sums of ``g (N, D)``'s rows per slot
    of ``inv (N,)`` (ids in ``[0, capacity)``), each slot's rows added in
    ascending position order from 0. ``order`` and ``sorted_slot``, both
    ``(N,)`` int64, when given, are the positions sorted stably by slot
    and the slot of each of them, as the dedup'd lookup's forward made
    them; then a CUDA tensor launches the kernel and nothing else. The
    kernel trusts them (the CPU path checks them against ``inv``).
    Without them the op sorts ``inv`` itself. CUDA tensors launch
    the kernel (or raise); CPU tensors run
    :func:`dedup_scatter_add_reference`."""
    _check(g, inv, "dedup_scatter_add")
    if g.shape[0] != inv.shape[0]:
        raise ValueError(f"dedup_scatter_add: {g.shape[0]} rows of g for "
                         f"{inv.shape[0]} ids")
    if order is not None or sorted_slot is not None:
        _check_sorted(order, sorted_slot, g, inv)
    if not g.is_cuda:
        return dedup_scatter_add_reference(g, inv, capacity)
    n, d = g.shape
    out = torch.empty(capacity, d, dtype=torch.float32, device=g.device)
    if capacity == 0 or d == 0:
        return out
    if order is None:
        # the positions sorted stably by slot (a fixed-shape sort, no host
        # synchronisation)
        sorted_slot, order = torch.sort(inv.long(), stable=True)
    g, order = g.contiguous(), order.contiguous()
    sorted_slot = sorted_slot.contiguous()
    err = launch(LIBRARY.entry("dedup_scatter_add"), g, g.data_ptr(),
                 order.data_ptr(), sorted_slot.data_ptr(), out.data_ptr(), n,
                 capacity, d, _DTYPES.index(g.dtype))
    _raise_on(err, "dedup_scatter_add")
    KERNEL_SCATTER_ADD.launches += 1
    return out
