"""Metrics — port of ``analytics_zoo_tpu/pipeline/api/keras/metrics.py``
(the ``Metric`` protocol and accuracy).

A metric is a pair of functions so evaluation streams over batches
without a host sync:

* ``update(y_true, y_pred, mask=None) -> stats`` — per-batch sufficient
  statistics as device tensors. ``mask`` is an optional ``(B,)`` 0/1
  weight that ``evaluate`` uses to exclude padded tail rows.
* ``finalize(stats) -> scalar`` — combine (stats are summed over batches).

top5, mae, mse and auc are not ported yet.
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


def accuracy() -> Metric:
    """Top-1 / binary accuracy (``metrics/Accuracy.scala``)."""
    return Metric("accuracy", _binary_or_top1,
                  lambda s: s["correct"] / max(float(s["count"]), 1.0))


def _not_ported(name: str):
    def ctor():
        raise NotImplementedError(f"metric {name!r} is not ported yet (the "
                                  f"port has accuracy)")
    return ctor


METRICS = {
    "accuracy": accuracy,
    "acc": accuracy,
    "top5": _not_ported("top5"),
    "top5_accuracy": _not_ported("top5_accuracy"),
    "mae": _not_ported("mae"),
    "mse": _not_ported("mse"),
    "auc": _not_ported("auc"),
}


def get_metric(m: Union[str, Metric]) -> Metric:
    if isinstance(m, Metric):
        return m
    if m not in METRICS:
        raise ValueError(f"unknown metric {m!r}; available: "
                         f"{sorted(METRICS)}")
    return METRICS[m]()
