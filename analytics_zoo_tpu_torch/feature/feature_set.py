"""FeatureSet — port of the in-memory part of ``analytics_zoo_tpu/feature/
feature_set.py``: a host-RAM (numpy) cached dataset of ``x`` (an array or
a list of arrays) and optional ``y``, with a per-epoch reshuffled order.

The permutation is the JAX package's bit for bit:
``np.random.default_rng(seed + epoch).permutation(n)``, and the training
loop passes ``epoch = zoo.seed + epoch`` as the JAX loop does, so both
packages see the same batches in the same order. Device prefetch, disk
slices and transforms are not ported yet; the training loop copies each
batch to the device itself.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Tuple

import numpy as np


def _as_list(x) -> List[np.ndarray]:
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class FeatureSet:
    """In-memory cached dataset (``CachedDistributedFeatureSet``'s role)."""

    def __init__(self, x, y=None, shuffle: bool = True, seed: int = 0):
        self.xs = [np.asarray(a) for a in _as_list(x)]
        if not self.xs:
            raise ValueError("FeatureSet needs at least one feature array")
        n = self.xs[0].shape[0]
        for a in self.xs:
            if a.shape[0] != n:
                raise ValueError("feature arrays disagree on leading dim")
        self.y = None if y is None else np.asarray(y)
        if self.y is not None and self.y.shape[0] != n:
            raise ValueError("labels disagree with features on leading dim")
        self.shuffle = shuffle
        self.seed = seed

    @staticmethod
    def array(x, y=None, *, shuffle: bool = True,
              seed: int = 0) -> "FeatureSet":
        return FeatureSet(x, y, shuffle=shuffle, seed=seed)

    def __len__(self) -> int:
        return self.xs[0].shape[0]

    @property
    def x(self):
        return self.xs if len(self.xs) > 1 else self.xs[0]

    def _order(self, epoch: int) -> np.ndarray:
        n = len(self)
        if not self.shuffle:
            return np.arange(n)
        return np.random.default_rng(self.seed + epoch).permutation(n)

    def _slice(self, idx) -> Tuple[Any, Any]:
        bx = [a[idx] for a in self.xs]
        bx = bx if len(bx) > 1 else bx[0]
        return bx, None if self.y is None else self.y[idx]

    def iter_batches(self, batch_size: int, *, epoch: int = 0,
                     drop_last: bool = True) -> Iterator[Tuple[Any, Any]]:
        """One pass (one epoch), reshuffled by ``epoch`` number."""
        order = self._order(epoch)
        n = len(self)
        end = n - (n % batch_size) if drop_last else n
        for i in range(0, end, batch_size):
            yield self._slice(order[i:i + batch_size])

    def steps_per_epoch(self, batch_size: int,
                        drop_last: bool = True) -> int:
        n = len(self)
        return (n // batch_size if drop_last
                else (n + batch_size - 1) // batch_size)
