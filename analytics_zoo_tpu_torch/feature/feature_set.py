"""FeatureSet — port of the in-memory part of ``analytics_zoo_tpu/feature/
feature_set.py``: a host-RAM (numpy) cached dataset of ``x`` (an array or
a list of arrays) and optional ``y``, with a per-epoch reshuffled order.

The permutation is the JAX package's bit for bit:
``np.random.default_rng(seed + epoch).permutation(n)``, and the training
loop passes ``epoch = zoo.seed + epoch`` as the JAX loop does, so both
packages see the same batches in the same order. :func:`chunked` stacks
K batches into one ``(K, batch, ...)`` chunk for the multi-step dispatch
(``zoo.train.scan_steps``), the last chunk of an epoch shorter; a set
whose batches can be gathered from a copy on the device says so with
``device_cacheable`` (``zoo.train.device_cache``). Device prefetch, disk
slices and transforms are not ported yet; the training loop copies each
batch or chunk to the device itself.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, List, Tuple

import numpy as np


def _as_list(x) -> List[np.ndarray]:
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def stack_batches(items: List[Tuple[Any, Any]]) -> Tuple[Any, Any]:
    """K ``(x, y)`` batches stacked into one ``(K, batch, ...)`` chunk (an
    ``x`` list stacks feature by feature; None labels stay None)."""
    def stack(parts):
        if parts[0] is None:
            return None
        if isinstance(parts[0], (list, tuple)):
            return [np.stack(group) for group in zip(*parts)]
        return np.stack(parts)
    xs, ys = zip(*items)
    return stack(list(xs)), stack(list(ys))


def chunked(batches: Iterable[Tuple[Any, Any]], k: int
            ) -> Iterator[Tuple[Any, Any]]:
    """The batches in order, ``k`` to a chunk; the last chunk holds what
    is left (JAX ``training.py`` ``_chunked``)."""
    buf = []
    for item in batches:
        buf.append(item)
        if len(buf) == k:
            yield stack_batches(buf)
            buf = []
    if buf:
        yield stack_batches(buf)


class FeatureSet:
    """In-memory cached dataset (``CachedDistributedFeatureSet``'s role)."""

    #: its arrays can be copied to the device once and each epoch's
    #: batches gathered there (a bucketed set of ragged batches cannot)
    device_cacheable = True

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
