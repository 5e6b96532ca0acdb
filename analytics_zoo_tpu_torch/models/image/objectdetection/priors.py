"""SSD prior (anchor) boxes — a copy of ``analytics_zoo_tpu/models/image/
objectdetection/priors.py`` (numpy only); parity with the Caffe-SSD ``PriorBox``
conventions the reference wires up in ``ssd/SSD.scala`` (min/max sizes per
feature map, aspect ratios with flip, offset 0.5, variances
(0.1, 0.1, 0.2, 0.2), optional clip).

Priors are data-independent, so they're generated once on the host in
numpy at model-build time; the loss and the postprocess keep a copy on the
model's device.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["PriorBox", "ssd_priors", "SSD300_PASCAL_SIZES"]

# min/max size division boundaries for 300x300 pascal (SSD.scala:116)
SSD300_PASCAL_SIZES = (30.0, 60.0, 111.0, 162.0, 213.0, 264.0, 315.0)


class PriorBox:
    """Priors for ONE feature map."""

    def __init__(self, min_size: float, max_size: Optional[float] = None,
                 aspect_ratios: Sequence[float] = (2.0,), flip: bool = True,
                 clip: bool = False, step: Optional[float] = None,
                 offset: float = 0.5,
                 variances: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)):
        self.min_size = float(min_size)
        self.max_size = None if max_size is None else float(max_size)
        ars = [1.0]
        for ar in aspect_ratios:
            if any(abs(ar - a) < 1e-6 for a in ars):
                continue
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
        self.aspect_ratios = ars
        self.clip = clip
        self.step = step
        self.offset = offset
        self.variances = tuple(variances)

    @property
    def num_priors(self) -> int:
        # one per aspect ratio + the sqrt(min*max) box when max_size is set
        return len(self.aspect_ratios) + (1 if self.max_size else 0)

    def generate(self, feat_h: int, feat_w: int,
                 img_size: float) -> np.ndarray:
        """(feat_h * feat_w * num_priors, 4) corner-form normalized."""
        step_w = self.step or img_size / feat_w
        step_h = self.step or img_size / feat_h
        whs: List[Tuple[float, float]] = []
        s = self.min_size
        whs.append((s, s))
        if self.max_size:
            sp = math.sqrt(s * self.max_size)
            whs.append((sp, sp))
        for ar in self.aspect_ratios:
            if abs(ar - 1.0) < 1e-6:
                continue
            whs.append((s * math.sqrt(ar), s / math.sqrt(ar)))
        whs_a = np.asarray(whs, np.float32)  # (K, 2) in pixels

        xs = (np.arange(feat_w, dtype=np.float32) + self.offset) * step_w
        ys = (np.arange(feat_h, dtype=np.float32) + self.offset) * step_h
        cx, cy = np.meshgrid(xs, ys)  # (H, W)
        centers = np.stack([cx, cy], axis=-1).reshape(-1, 1, 2)  # (HW, 1, 2)
        half = whs_a[None, :, :] * 0.5
        boxes = np.concatenate([centers - half, centers + half], axis=-1)
        boxes = boxes.reshape(-1, 4) / img_size
        if self.clip:
            boxes = np.clip(boxes, 0.0, 1.0)
        return boxes.astype(np.float32)


def ssd_priors(feature_shapes: Sequence[Tuple[int, int]],
               prior_boxes: Sequence[PriorBox],
               img_size: float) -> np.ndarray:
    """Stack per-feature-map priors in head order → (n_priors_total, 4)."""
    if len(feature_shapes) != len(prior_boxes):
        raise ValueError(f"{len(feature_shapes)} feature maps vs "
                         f"{len(prior_boxes)} PriorBox specs")
    return np.concatenate([pb.generate(h, w, img_size)
                           for (h, w), pb in zip(feature_shapes, prior_boxes)],
                          axis=0)
