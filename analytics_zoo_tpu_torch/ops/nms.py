"""N1, the batched greedy NMS keep-mask (``csrc/nms.cu``).

It has no Pallas counterpart: the JAX package's ``nms_mask``
(``models/image/objectdetection/bbox.py``) is an XLA ``fori_loop`` over
the IoU matrix, run under a ``vmap`` over the images and one over the
classes. As torch ops that loop is some five launches a step, K steps a
call; N1 takes every (image, class) row in one launch, a block a row: the
upper triangle's ``iou > threshold`` bits as 32 x 32 tiles, decided by
the sign of two FMAs wherever that is exact (the division only within an
ulp of the threshold), then a greedy scan a word of 32 boxes at a time.

:func:`nms_keep_mask` launches N1 on a CUDA tensor (or raises) and runs
its plain version, :func:`nms_keep_mask_reference` (the loop in torch
ops, the JAX order), on a CPU tensor. The kernel gives the plain
version's bits for finite boxes: its IoU rounds each operation as the
torch ops do, and its division-free test gives the division's answer.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary, launch
from .launch_count import LaunchCount

__all__ = ["nms_keep_mask", "nms_keep_mask_reference", "pairwise_iou",
           "LIBRARY", "KERNEL_NMS", "NMS_MAX_K"]

#: the most boxes a row N1 takes (``MAX_K`` in ``nms.cu``: the removed set
#: is one warp's 32 words)
NMS_MAX_K = 1024


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.nms_keep.argtypes = [p, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_float, p, p]
    lib.nms_keep.restype = ctypes.c_int


LIBRARY = CudaLibrary("nms", ["nms.cu"], _bind)
KERNEL_NMS = LaunchCount()    # N1


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of every box of ``a (..., N, 4)`` with every box of ``b (...,
    M, 4)``, corner form -> ``(..., N, M)`` f32 (JAX ``bbox_iou``'s
    operations in its order)."""
    a, b = a.float(), b.float()
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]).clamp(min=0.0)
              * (a[..., 3] - a[..., 1]).clamp(min=0.0))
    area_b = ((b[..., 2] - b[..., 0]).clamp(min=0.0)
              * (b[..., 3] - b[..., 1]).clamp(min=0.0))
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms_keep_mask_reference(boxes: torch.Tensor,
                            iou_threshold: float = 0.45) -> torch.Tensor:
    """Plain version of N1: ``boxes (..., K, 4)``, each row sorted by
    score descending -> the bool ``(..., K)`` keep-mask of greedy NMS, by
    the JAX loop: for each i in order, a kept i drops every j > i whose
    IoU with it is above ``iou_threshold``."""
    k = boxes.shape[-2]
    iou = pairwise_iou(boxes, boxes) > float(iou_threshold)
    later = torch.ones(k, k, dtype=torch.bool,
                       device=boxes.device).triu(diagonal=1)
    over = iou & later
    keep = torch.ones(boxes.shape[:-1], dtype=torch.bool,
                      device=boxes.device)
    for i in range(k):
        keep &= ~(over[..., i, :] & keep[..., i:i + 1])
    return keep


def nms_keep_mask(boxes: torch.Tensor,
                  iou_threshold: float = 0.45) -> torch.Tensor:
    """N1: the greedy NMS keep-mask of every row of ``boxes (..., K, 4)``
    (f32 corner form, each row sorted by score descending) -> bool
    ``(..., K)``, bit for bit :func:`nms_keep_mask_reference`. One launch
    for all rows, a block a row; ``K <= NMS_MAX_K``. CUDA tensors launch
    the kernel (or raise); CPU tensors run the plain version."""
    if boxes.dim() < 2 or boxes.shape[-1] != 4:
        raise ValueError(f"nms_keep_mask takes (..., K, 4) boxes; got "
                         f"{tuple(boxes.shape)}")
    if not boxes.is_cuda:
        return nms_keep_mask_reference(boxes, iou_threshold)
    k = boxes.shape[-2]
    keep = torch.empty(boxes.shape[:-1], dtype=torch.bool,
                       device=boxes.device)
    if keep.numel() == 0:
        return keep
    if k > NMS_MAX_K:
        raise ValueError(f"nms_keep_mask: {k} boxes a row; N1 takes at "
                         f"most {NMS_MAX_K}")
    src = boxes.float().contiguous()
    err = launch(LIBRARY.entry("nms_keep"), src, src.data_ptr(),
                 keep.numel() // k, k, float(iou_threshold),
                 keep.data_ptr())
    if err != 0:
        raise RuntimeError(f"nms_keep_mask launch failed: CUDA error {err}")
    KERNEL_NMS.launches += 1
    return keep
