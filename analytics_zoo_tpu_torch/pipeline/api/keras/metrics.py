"""Metrics — port of ``analytics_zoo_tpu/pipeline/api/keras/metrics.py``:
the ``Metric`` protocol, accuracy, top-5 accuracy, MAE, MSE and the
streaming AUC.

A metric is a pair of functions so evaluation streams over batches
without a host sync:

* ``update(y_true, y_pred, mask=None) -> stats`` — per-batch sufficient
  statistics as device tensors. ``mask`` is an optional ``(B,)`` 0/1
  weight that ``evaluate`` uses to exclude padded tail rows.
* ``finalize(stats) -> scalar`` — combine (stats are summed over batches
  in f32 on the device; ``evaluate`` hands them over as host values: a
  float for a scalar, a CPU tensor for AUC's per-threshold counts).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch


class Metric(NamedTuple):
    name: str
    update: Callable  # (y_true, y_pred, mask=None) -> {str: tensor}
    finalize: Callable  # stats -> scalar


def _example_weights(mask, shape, device) -> torch.Tensor:
    """Broadcast a per-example ``(B,)`` mask over an array of ``shape``
    whose leading axis is the batch."""
    if mask is None:
        w = torch.ones(shape[0], device=device)
    else:
        w = torch.as_tensor(mask, device=device).float().reshape(-1)
    return w.reshape((shape[0],) + (1,) * (len(shape) - 1)).expand(shape)


def _binary_or_top1(y_true, y_pred, mask=None):
    y_pred = torch.as_tensor(y_pred)
    y_true = torch.as_tensor(y_true, device=y_pred.device)
    if y_pred.dim() > 1 and y_pred.shape[-1] > 1:
        pred = torch.argmax(y_pred, dim=-1)
        true = (torch.argmax(y_true, dim=-1)
                if y_true.dim() == y_pred.dim()
                else y_true.reshape(pred.shape))
        correct = pred == true.to(pred.dtype)
    else:
        # keep the batch axis leading so masking stays per example
        correct = (y_pred > 0.5) == (y_true.reshape(y_pred.shape) > 0.5)
    w = _example_weights(mask, correct.shape, correct.device)
    return {"correct": torch.sum(correct.float() * w),
            "count": torch.sum(w)}


def _rate(s) -> float:
    return float(s["correct"]) / max(float(s["count"]), 1.0)


def accuracy() -> Metric:
    """Top-1 / binary accuracy (``metrics/Accuracy.scala``)."""
    return Metric("accuracy", _binary_or_top1, _rate)


def top5_accuracy() -> Metric:
    """The label among the five highest scores (ties broken as
    ``jnp.argsort``'s stable order breaks them)."""
    def update(y_true, y_pred, mask=None):
        y_pred = torch.as_tensor(y_pred)
        y_true = torch.as_tensor(y_true, device=y_pred.device)
        true = (torch.argmax(y_true, dim=-1) if y_true.dim() == y_pred.dim()
                else y_true.reshape(y_pred.shape[:-1])).long()
        top5 = torch.argsort(y_pred, dim=-1, stable=True)[..., -5:]
        correct = torch.any(top5 == true[..., None], dim=-1)
        w = _example_weights(mask, correct.shape, correct.device)
        return {"correct": torch.sum(correct.float() * w),
                "count": torch.sum(w)}
    return Metric("top5_accuracy", update, _rate)


def _error_metric(name: str, fn) -> Metric:
    """Mean of ``fn(pred - true)`` over every element, each example's
    elements weighted by its mask entry."""
    def update(y_true, y_pred, mask=None):
        y_pred = torch.as_tensor(y_pred).float()
        y_true = torch.as_tensor(y_true, device=y_pred.device).float()
        err = fn(y_pred - y_true.reshape(y_pred.shape))
        w = _example_weights(mask, err.shape, err.device)
        return {"sum": torch.sum(err * w), "count": torch.sum(w)}
    return Metric(name, update, lambda s: float(s["sum"])
                  / max(float(s["count"]), 1.0))


def mae() -> Metric:
    return _error_metric("mae", torch.abs)


def mse() -> Metric:
    return _error_metric("mse", torch.square)


def auc(n_thresholds: int = 200) -> Metric:
    """Streaming AUC over ``n_thresholds`` fixed thresholds in [0, 1]
    (``metrics/AUC.scala``): per-threshold true/false positive sums, no
    sort; the trapezoid over the ROC points in f32."""
    def update(y_true, y_pred, mask=None):
        y_pred = torch.as_tensor(y_pred).float()
        dev = y_pred.device
        # weight per element before flattening, so a (B,) mask covers
        # outputs like (B, T, 1)
        w = _example_weights(mask, y_pred.shape, dev).reshape(-1)
        scores = y_pred.reshape(-1)
        labels = torch.as_tensor(y_true, device=dev).float().reshape(-1)
        thresholds = torch.linspace(0.0, 1.0, n_thresholds, device=dev)
        pred_pos = (scores[None, :] >= thresholds[:, None]).float()
        return {"tp": torch.sum(pred_pos * (labels * w)[None, :], dim=1),
                "fp": torch.sum(pred_pos * ((1.0 - labels) * w)[None, :],
                                dim=1),
                "pos": torch.sum(labels * w),
                "neg": torch.sum((1.0 - labels) * w)}

    def finalize(s):
        s = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in s.items()}
        tpr = s["tp"] / torch.clamp(s["pos"], min=1.0)
        fpr = s["fp"] / torch.clamp(s["neg"], min=1.0)
        # thresholds ascend, so fpr descends: |d fpr| * mean tpr
        return float(torch.sum((fpr[:-1] - fpr[1:]) * 0.5
                               * (tpr[:-1] + tpr[1:])))
    return Metric("auc", update, finalize)


METRICS = {
    "accuracy": accuracy,
    "acc": accuracy,
    "top5": top5_accuracy,
    "top5_accuracy": top5_accuracy,
    "mae": mae,
    "mse": mse,
    "auc": auc,
}


def get_metric(m: Union[str, Metric]) -> Metric:
    if isinstance(m, Metric):
        return m
    if m not in METRICS:
        raise ValueError(f"unknown metric {m!r}; available: "
                         f"{sorted(METRICS)}")
    return METRICS[m]()
