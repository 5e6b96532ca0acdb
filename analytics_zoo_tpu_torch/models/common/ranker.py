"""Ranking metrics and the Ranker evaluation mixin — a copy of
``analytics_zoo_tpu/models/common/ranker.py`` (plain numpy on predicted
scores, so nothing changes in the port). Parity with
``models/common/Ranker.scala:33-160`` (NDCG@k and MAP over per-query record
groups) plus the HitRate@k the reference's NCF example reports.

The reference wraps each query's candidate batch in one Sample and maps a
metric closure over an RDD; here a "group" is one (x, y) pair of arrays for
a single query/user, metrics are pure numpy on the predicted scores, and the
model forward for ALL groups goes through the normal batched ``predict``.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np

__all__ = ["ndcg", "mean_average_precision", "hit_rate", "RankerMixin"]


def ndcg(y_pred: np.ndarray, y_true: np.ndarray, k: int,
         threshold: float = 0.0) -> float:
    """NDCG@k for ONE query: gain ``2^label / ln(2 + rank)`` over the top-k
    by predicted score, normalized by the ideal ordering
    (``Ranker.scala:113-146`` exactly, including the natural log)."""
    if k <= 0:
        raise ValueError(f"k must be a positive integer, got {k}")
    g = np.asarray(y_true, np.float64).reshape(-1)
    p = np.asarray(y_pred, np.float64).reshape(-1)

    def _dcg(order):
        total = 0.0
        for i, idx in enumerate(order[:k]):
            if g[idx] > threshold:
                total += (2.0 ** g[idx]) / np.log(2.0 + i)
        return total

    idcg = _dcg(np.argsort(-g, kind="stable"))
    dcg = _dcg(np.argsort(-p, kind="stable"))
    return 0.0 if idcg == 0.0 else dcg / idcg


def mean_average_precision(y_pred: np.ndarray, y_true: np.ndarray,
                           threshold: float = 0.0) -> float:
    """Average precision for ONE query (``Ranker.scala:149-168``): mean over
    positives of (positives seen so far / rank)."""
    g = np.asarray(y_true, np.float64).reshape(-1)
    p = np.asarray(y_pred, np.float64).reshape(-1)
    order = np.argsort(-p, kind="stable")
    hits, total = 0, 0.0
    for i, idx in enumerate(order):
        if g[idx] > threshold:
            hits += 1
            total += hits / (i + 1.0)
    return 0.0 if hits == 0 else total / hits


def hit_rate(y_pred: np.ndarray, y_true: np.ndarray, k: int,
             threshold: float = 0.0) -> float:
    """HitRate@k for ONE query: 1.0 if any positive lands in the top-k by
    score (the NCF example's HR metric)."""
    g = np.asarray(y_true, np.float64).reshape(-1)
    p = np.asarray(y_pred, np.float64).reshape(-1)
    top = np.argsort(-p, kind="stable")[:k]
    return float((g[top] > threshold).any())


class RankerMixin:
    """Adds ``evaluate_ndcg`` / ``evaluate_map`` / ``evaluate_hit_rate`` to a
    model with ``predict``. ``groups`` is an iterable of per-query (x, y)
    pairs — the analogue of the reference's one-Sample-per-query TextSet."""

    def _scores(self, groups: Iterable[Tuple[np.ndarray, np.ndarray]],
                batch_size: int):
        for x, y in groups:
            yield np.asarray(self.predict(x, batch_size=batch_size)), y

    def evaluate_ndcg(self, groups: Sequence[Tuple[np.ndarray, np.ndarray]],
                      k: int, threshold: float = 0.0,
                      batch_size: int = 1024) -> float:
        vals = [ndcg(p, y, k, threshold)
                for p, y in self._scores(groups, batch_size)]
        return float(np.mean(vals))

    def evaluate_map(self, groups: Sequence[Tuple[np.ndarray, np.ndarray]],
                     threshold: float = 0.0, batch_size: int = 1024) -> float:
        vals = [mean_average_precision(p, y, threshold)
                for p, y in self._scores(groups, batch_size)]
        return float(np.mean(vals))

    def evaluate_hit_rate(self, groups: Sequence[Tuple[np.ndarray, np.ndarray]],
                          k: int, threshold: float = 0.0,
                          batch_size: int = 1024) -> float:
        vals = [hit_rate(p, y, k, threshold)
                for p, y in self._scores(groups, batch_size)]
        return float(np.mean(vals))
