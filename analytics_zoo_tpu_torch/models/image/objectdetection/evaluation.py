"""Detection evaluation — a copy of ``analytics_zoo_tpu/models/image/
objectdetection/evaluation.py`` (numpy only): Pascal-VOC mean average
precision (parity with
``objectdetection/common/evaluation/MeanAveragePrecision.scala`` +
``EvalUtil``/``PascalVocEvaluator``: greedy score-ordered matching at IoU
0.5, optional VOC-2007 11-point interpolation, per-class AP then mean over
non-background classes).

Host-side numpy: evaluation is a once-per-epoch ragged reduction — the
wrong shape for the accelerator, the right shape for the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["average_precision", "MeanAveragePrecision"]


def _voc_ap(recall: np.ndarray, precision: np.ndarray,
            use_07_metric: bool = False) -> float:
    if use_07_metric:  # 11-point interpolation
        ap = 0.0
        for t in np.arange(0.0, 1.01, 0.1):
            p = precision[recall >= t].max() if np.any(recall >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    # integral AP: precision envelope over recall steps
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def average_precision(scores: np.ndarray, tp: np.ndarray, n_gt: int,
                      use_07_metric: bool = False) -> float:
    """AP from per-detection (score, is-true-positive) pairs for one
    class. ``n_gt`` is the number of ground-truth boxes of that class."""
    if n_gt == 0:
        return 0.0
    order = np.argsort(-np.asarray(scores))
    tp_s = np.asarray(tp, np.float64)[order]
    fp_s = 1.0 - tp_s
    tp_cum = np.cumsum(tp_s)
    fp_cum = np.cumsum(fp_s)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    return _voc_ap(recall, precision, use_07_metric)


def _match_detections(dets: np.ndarray, gts: np.ndarray,
                      iou_thresh: float) -> np.ndarray:
    """Greedy match for one image+class: dets (D, 5) [score, box] sorted by
    score desc, gts (G, 4). Returns tp flags (D,). Each gt matches at most
    one detection (VOC rule)."""
    tp = np.zeros(len(dets))
    if len(gts) == 0:
        return tp
    taken = np.zeros(len(gts), bool)
    for i, d in enumerate(dets):
        box = d[1:5]
        lt = np.maximum(box[:2], gts[:, :2])
        rb = np.minimum(box[2:4], gts[:, 2:4])
        wh = np.clip(rb - lt, 0.0, None)
        inter = wh[:, 0] * wh[:, 1]
        area_d = max((box[2] - box[0]) * (box[3] - box[1]), 0.0)
        area_g = np.clip(gts[:, 2] - gts[:, 0], 0, None) * \
            np.clip(gts[:, 3] - gts[:, 1], 0, None)
        iou = inter / np.maximum(area_d + area_g - inter, 1e-12)
        j = int(np.argmax(iou))
        if iou[j] >= iou_thresh and not taken[j]:
            tp[i] = 1.0
            taken[j] = True
    return tp


class MeanAveragePrecision:
    """Streaming VOC mAP. Feed per-batch ``(detections, ground_truth)``
    with ``update``; ``result()`` returns (mAP, per-class AP dict).

    * detections: (B, K, 6) ``[label, score, x1, y1, x2, y2]``, label -1 =
      padding (the :func:`~.bbox.batched_detection_output` format);
    * ground truth: (B, G, 5) ``[label, x1, y1, x2, y2]``, label -1 =
      padding (the :class:`~.multibox_loss.MultiBoxLoss` target format).
    """

    def __init__(self, num_classes: int, iou_thresh: float = 0.5,
                 use_07_metric: bool = False, bg_label: int = 0,
                 class_names: Optional[Sequence[str]] = None):
        self.num_classes = int(num_classes)
        self.iou_thresh = float(iou_thresh)
        self.use_07 = bool(use_07_metric)
        self.bg_label = int(bg_label)
        self.class_names = (list(class_names) if class_names else
                            [str(c) for c in range(num_classes)])
        self._scores: Dict[int, List[np.ndarray]] = {}
        self._tps: Dict[int, List[np.ndarray]] = {}
        self._n_gt = np.zeros(self.num_classes, np.int64)

    def update(self, detections: np.ndarray, ground_truth: np.ndarray):
        det = np.asarray(detections)
        gt = np.asarray(ground_truth)
        for b in range(det.shape[0]):
            d_img = det[b][det[b, :, 0] >= 0]
            g_img = gt[b][gt[b, :, 0] >= 0]
            for c in range(self.num_classes):
                if c == self.bg_label:
                    continue
                g_c = g_img[g_img[:, 0] == c][:, 1:5]
                self._n_gt[c] += len(g_c)
                d_c = d_img[d_img[:, 0] == c][:, 1:6]
                if len(d_c) == 0:
                    continue
                d_c = d_c[np.argsort(-d_c[:, 0])]
                tp = _match_detections(d_c, g_c, self.iou_thresh)
                self._scores.setdefault(c, []).append(d_c[:, 0])
                self._tps.setdefault(c, []).append(tp)

    def result(self) -> Tuple[float, Dict[str, float]]:
        aps = {}
        for c in range(self.num_classes):
            # VOC rule: classes absent from the eval set don't enter the mean
            if c == self.bg_label or self._n_gt[c] == 0:
                continue
            scores = (np.concatenate(self._scores[c]) if c in self._scores
                      else np.zeros(0))
            tps = (np.concatenate(self._tps[c]) if c in self._tps
                   else np.zeros(0))
            aps[self.class_names[c]] = average_precision(
                scores, tps, int(self._n_gt[c]), self.use_07)
        mean = float(np.mean(list(aps.values()))) if aps else 0.0
        return mean, aps
