"""Box utilities — port of ``analytics_zoo_tpu/models/image/
objectdetection/bbox.py``; parity with ``objectdetection/common/
BboxUtil.scala``: IoU, the Caffe-SSD center-offset encode/decode with
variances, per-class NMS, and the decode -> NMS -> keep-topk detection
output of ``Postprocessor.scala``.

Every function takes tensors on one device and keeps static shapes, as
the JAX functions do. The JAX package's ``vmap`` over the images and over
the classes becomes one batched ``(B·C, K)`` computation: the per-class
candidates of every image in one stable sort, and their NMS keep-masks in
one launch of N1 (``ops/nms.py``; its plain version on the CPU). The
detection output is a fixed ``(keep_topk, 6)`` table padded with label
``-1``.

Ties. ``lax.top_k`` puts the lower index first among equal scores, and
below ``conf_thresh`` every score is 0, so ties are the rule and the
padded rows' boxes depend on them; ``torch.topk`` promises no order for
ties, so the top-k here is a stable descending sort and a slice.

Boxes are corner-format ``(x1, y1, x2, y2)``, normalized to [0, 1].
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ....ops.nms import nms_keep_mask, pairwise_iou

__all__ = ["bbox_iou", "encode_boxes", "decode_boxes", "nms_mask",
           "detection_output", "batched_detection_output"]

VARIANCES = (0.1, 0.1, 0.2, 0.2)


def _f32(t, device=None) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.to(device=device or t.device, dtype=torch.float32)
    return torch.tensor(np.asarray(t, np.float32), device=device)


def bbox_iou(a, b) -> torch.Tensor:
    """Pairwise IoU. a: (N, 4), b: (M, 4) -> (N, M)."""
    a = _f32(a)
    return pairwise_iou(a, _f32(b, a.device))


def _center_form(boxes):
    wh = boxes[..., 2:] - boxes[..., :2]
    return (boxes[..., :2] + boxes[..., 2:]) * 0.5, wh


def encode_boxes(gt, priors, variances: Sequence[float] = VARIANCES
                 ) -> torch.Tensor:
    """Caffe-SSD regression targets (``BboxUtil.encodeBoxes``): center
    offsets scaled by prior size / variance, log-space sizes. ``priors``
    and ``variances`` may be tensors on ``gt``'s device (nothing is then
    copied from the host)."""
    gt = _f32(gt)
    g_c, g_wh = _center_form(gt)
    p_c, p_wh = _center_form(_f32(priors, gt.device))
    v = _f32(variances, gt.device)
    p_wh = p_wh.clamp(min=1e-8)
    g_wh = g_wh.clamp(min=1e-8)
    d_c = (g_c - p_c) / (p_wh * v[:2])
    d_wh = torch.log(g_wh / p_wh) / v[2:]
    return torch.cat([d_c, d_wh], dim=-1)


def decode_boxes(loc, priors, variances: Sequence[float] = VARIANCES
                 ) -> torch.Tensor:
    """Inverse of :func:`encode_boxes` (``BboxUtil.decodeBoxes``)."""
    loc = _f32(loc)
    p_c, p_wh = _center_form(_f32(priors, loc.device))
    v = _f32(variances, loc.device)
    c = loc[..., :2] * v[:2] * p_wh + p_c
    wh = torch.exp(loc[..., 2:] * v[2:]) * p_wh
    return torch.cat([c - wh * 0.5, c + wh * 0.5], dim=-1)


def nms_mask(boxes, iou_threshold: float = 0.45) -> torch.Tensor:
    """Greedy NMS as a keep-mask over score-DESCENDING-sorted boxes:
    ``(..., N, 4)`` -> bool ``(..., N)``, True where the box survives.
    The caller sorts (row order IS the suppression priority). Every row
    of the leading dimensions in one launch of N1 on CUDA tensors."""
    return nms_keep_mask(_f32(boxes), iou_threshold)


def _top(scores: torch.Tensor, k: int):
    """The top ``k`` of the last dimension, descending, the lower index
    first among equal scores (``lax.top_k``'s order): ``(values,
    indices)``."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def detection_candidates(loc, conf, priors, *, num_classes: int,
                         conf_thresh: float = 0.01, nms_topk: int = 400,
                         variances: Sequence[float] = VARIANCES):
    """Each image's and class's NMS candidates: the decoded boxes (clipped
    to [0, 1]) of its ``min(nms_topk, P)`` best scores at or above
    ``conf_thresh`` (0 below), in the stable top-k order -> ``(scores (B,
    C, K), boxes (B, C, K, 4))``."""
    loc = _f32(loc)
    dev = loc.device
    conf = _f32(conf, dev)
    b, p = loc.shape[0], loc.shape[1]
    boxes = decode_boxes(loc, _f32(priors, dev), variances).clamp(0.0, 1.0)
    # (B, C, P): each class's scores over the priors, 0 below the threshold
    s = conf[..., :num_classes].transpose(1, 2)
    s = torch.where(s >= conf_thresh, s, torch.zeros_like(s))
    k = min(nms_topk, p)
    cand_scores, cand_idx = _top(s, k)                       # (B, C, K)
    cand_boxes = torch.gather(
        boxes[:, None].expand(b, num_classes, p, 4), 2,
        cand_idx[..., None].expand(b, num_classes, k, 4))    # (B, C, K, 4)
    return cand_scores, cand_boxes


def batched_detection_output(loc, conf, priors, *, num_classes: int,
                             conf_thresh: float = 0.01,
                             nms_thresh: float = 0.45, nms_topk: int = 400,
                             keep_topk: int = 200, bg_label: int = 0,
                             variances: Sequence[float] = VARIANCES
                             ) -> torch.Tensor:
    """(B, n_priors, 4) loc + (B, n_priors, C) scores -> fixed ``(B,
    keep_topk, 6)`` detections ``[label, score, x1, y1, x2, y2]`` sorted
    by score, padded with label -1 (``Postprocessor.scala`` semantics:
    per-class conf-threshold -> per-class NMS -> global keep-topk)."""
    cand_scores, cand_boxes = detection_candidates(
        loc, conf, priors, num_classes=num_classes, conf_thresh=conf_thresh,
        nms_topk=nms_topk, variances=variances)
    b, k, dev = cand_scores.shape[0], cand_scores.shape[2], cand_scores.device
    keep = nms_mask(cand_boxes, nms_thresh)
    scores = torch.where(keep, cand_scores, torch.zeros_like(cand_scores))
    # background contributes nothing
    classes = torch.arange(num_classes, device=dev)
    scores = torch.where((classes == bg_label)[None, :, None],
                         torch.zeros_like(scores), scores)
    flat_scores = scores.reshape(b, -1)
    flat_boxes = cand_boxes.reshape(b, -1, 4)
    flat_labels = classes.repeat_interleave(k).to(torch.float32)
    top_scores, top_idx = _top(flat_scores, min(keep_topk,
                                                flat_scores.shape[1]))
    out_label = torch.where(top_scores > 0, flat_labels[top_idx],
                            torch.full_like(top_scores, -1.0))
    det = torch.cat([out_label[..., None], top_scores[..., None],
                     torch.gather(flat_boxes, 1,
                                  top_idx[..., None].expand(-1, -1, 4))],
                    dim=-1)
    if det.shape[1] < keep_topk:  # pad when total candidates < keep_topk
        pad = torch.zeros(b, keep_topk - det.shape[1], 6, device=dev)
        pad[..., 0] = -1.0
        det = torch.cat([det, pad], dim=1)
    return det


def detection_output(loc, conf, priors, **kw) -> torch.Tensor:
    """One image: (n_priors, 4) loc + (n_priors, C) scores -> ``(keep_topk,
    6)`` (:func:`batched_detection_output` of a batch of one)."""
    return batched_detection_output(_f32(loc)[None], _f32(conf)[None],
                                    priors, **kw)[0]
