"""MultiBoxLoss — port of ``analytics_zoo_tpu/models/image/
objectdetection/multibox_loss.py``; parity with ``objectdetection/common/
loss/MultiBoxLoss.scala``: prior<->gt matching with a forced
best-prior-per-gt assignment, smooth-L1 localization loss on encoded
offsets, softmax confidence loss with 3:1 hard negative mining,
normalized by the positive count.

The whole loss, matching included, is torch ops over fixed shapes on the
predictions' device, batched over the images (the JAX ``vmap``), with no
read of the device: it runs inside a step captured in a CUDA graph
(``zoo.train.scan_steps``). Ground truth arrives as a padded ``(B,
max_gt, 5)`` tensor ``[label, x1, y1, x2, y2]``, label ``-1`` marking
padding.

Where the JAX function relies on XLA's rules, the port keeps them:

* ``.at[...].set(mode="drop")`` sends padding rows out of range; here
  they scatter into a row ``P`` past the priors, sliced off after.
* Two ground-truth boxes can share one best prior. XLA's CPU scatter
  applies the updates in order, so the later gt wins; here the winner is
  the largest gt index that names the prior (``scatter_reduce`` with
  ``amax``), the same rule and deterministic on the card, where
  ``index_put_`` with repeated indices is not.
* ``argmax`` returns the first maximal index in both frameworks, and
  ``jnp.argsort`` is stable, so the hard negatives are ranked by
  ``torch.argsort(stable=True)``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .bbox import VARIANCES, bbox_iou, encode_boxes

__all__ = ["MultiBoxLoss", "match_priors", "hard_negatives"]


def _match(gt: torch.Tensor, priors: torch.Tensor, iou_threshold: float
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`match_priors` over a batch: gt ``(B, G, 5)`` -> gt_idx and
    pos, each ``(B, P)``."""
    b, g = gt.shape[0], gt.shape[1]
    p = priors.shape[0]
    valid = gt[..., 0] >= 0                                   # (B, G)
    iou = bbox_iou(priors, gt[..., 1:5].reshape(-1, 4)).reshape(
        p, b, g).permute(1, 0, 2) * valid[:, None, :]        # (B, P, G)
    best_gt = iou.argmax(dim=2)                               # (B, P)
    best_gt_iou = iou.amax(dim=2)
    # forced: for each valid gt its best prior; padding rows go to row P
    best_prior = iou.argmax(dim=1)                            # (B, G)
    scatter_to = torch.where(valid, best_prior,
                             torch.full_like(best_prior, p))
    gts = torch.arange(g, device=gt.device).expand(b, g)
    winner = torch.full((b, p + 1), -1, dtype=torch.long,
                        device=gt.device).scatter_reduce(
        1, scatter_to, gts, reduce="amax")[:, :p]
    forced = winner >= 0
    gt_idx = torch.where(forced, winner, best_gt)
    pos = (best_gt_iou > iou_threshold) | forced
    return gt_idx, pos


def match_priors(gt, priors, iou_threshold: float = 0.5
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image. gt: (max_gt, 5) padded with label -1; priors (P, 4).

    Returns (matched_gt_idx (P,), positive mask (P,)):
    * a prior is positive when its best gt IoU > threshold, OR when it is
      the single best prior for some valid gt (the forced assignment that
      guarantees every object gets at least one prior);
    * matched_gt_idx points each prior at its assigned gt row.
    """
    gt = torch.as_tensor(gt, dtype=torch.float32)
    priors = torch.as_tensor(priors, dtype=torch.float32, device=gt.device)
    gt_idx, pos = _match(gt[None], priors, iou_threshold)
    return gt_idx[0], pos[0]


def hard_negatives(ce: torch.Tensor, pos: torch.Tensor,
                   neg_pos_ratio: float = 3.0) -> torch.Tensor:
    """Hard negative mining over ``(B, P)``: the ``neg_pos_ratio * npos``
    negatives of highest CE in each image (a stable rank, so among equal
    CEs the lower prior comes first, as ``jnp.argsort``'s) -> bool ``(B,
    P)``."""
    neg_ce = torch.where(pos, torch.full_like(ce, -float("inf")), ce)
    order = torch.argsort(-neg_ce, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=order.device)
        .expand_as(order))
    n_neg = torch.minimum(neg_pos_ratio * pos.float().sum(dim=1),
                          (~pos).sum(dim=1).float())
    return (rank < n_neg[:, None]) & ~pos


def _smooth_l1(x):
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


class MultiBoxLoss:
    """Callable loss for ``compile(loss=MultiBoxLoss(...))``. The model
    output is the concatenated ``(B, P, 4 + num_classes)`` loc‖conf-logits
    tensor; targets are padded ``(B, max_gt, 5)`` boxes. ``device`` puts
    the priors where the model runs at once (a step captured in a CUDA
    graph may copy nothing from the host); they move on first use to any
    other device."""

    def __init__(self, num_classes: int, priors: np.ndarray,
                 iou_threshold: float = 0.5, neg_pos_ratio: float = 3.0,
                 bg_label: int = 0,
                 variances: Sequence[float] = VARIANCES, device=None):
        self.num_classes = int(num_classes)
        self.priors = torch.as_tensor(np.asarray(priors, np.float32))
        self.iou_threshold = float(iou_threshold)
        self.neg_pos_ratio = float(neg_pos_ratio)
        self.bg_label = int(bg_label)
        self.variances = tuple(variances)
        self.__name__ = "multibox_loss"
        self._placed: Dict[torch.device, Tuple[torch.Tensor,
                                               torch.Tensor]] = {}
        if device is not None:
            self._priors_on(torch.device(device))

    def _priors_on(self, device: torch.device):
        """The priors and the variances on ``device``: placed once, as a
        captured step may copy nothing from the host."""
        t = self._placed.get(device)
        if t is None:
            t = (self.priors.to(device),
                 torch.tensor(self.variances, dtype=torch.float32,
                              device=device))
            # keyed by the placed tensor's device: "cuda" is "cuda:0" there
            self._placed[device] = self._placed[t[0].device] = t
        return t

    def __call__(self, y_true, y_pred):
        gt = torch.as_tensor(y_true, device=y_pred.device).float()  # (B, G, 5)
        priors, variances = self._priors_on(y_pred.device)
        loc = y_pred[..., :4]                                       # (B, P, 4)
        logits = y_pred[..., 4:]                                    # (B, P, C)
        gt_idx, pos = _match(gt, priors, self.iou_threshold)
        posf = pos.float()
        npos = posf.sum(dim=1)                                      # (B,)
        matched = torch.gather(gt, 1, gt_idx[..., None].expand(
            -1, -1, 5))                                             # (B, P, 5)

        # localization: smooth-L1 on encoded offsets, positives only
        target = encode_boxes(matched[..., 1:5], priors, variances)
        loc_loss = (_smooth_l1(loc - target).sum(-1) * posf).sum(dim=1)

        # confidence: CE against the matched label (bg for negatives); the
        # per-prior CE is reused for hard-negative mining
        labels = torch.where(pos, matched[..., 0].to(torch.int32),
                             torch.full_like(gt_idx, self.bg_label,
                                             dtype=torch.int32))
        logp = F.log_softmax(logits, dim=-1)
        ce = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]

        neg = hard_negatives(ce.detach(), pos, self.neg_pos_ratio)
        conf_loss = (ce * posf).sum(dim=1) + (ce * neg.float()).sum(dim=1)
        return ((loc_loss + conf_loss) / npos.clamp(min=1.0)).mean()
