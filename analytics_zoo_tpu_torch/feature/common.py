"""Chainable preprocessing combinators — a copy of ``analytics_zoo_tpu/
feature/common.py`` (plain numpy, so nothing changes in the port): the
reference's ``Preprocessing`` family (``feature/common/Preprocessing.scala``
and the adapters in ``feature/common/*.scala``: SeqToTensor, ArrayToTensor,
ScalarToTensor, FeatureLabelPreprocessing, ...).

A ``Preprocessing`` is a vectorized function over a whole numpy batch,
chained with ``>>`` (the reference's ``->``). Its stages are picklable, so
a fitted ``NNModel`` (``pipeline/nnframes``) saves with its chain.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np


class Preprocessing:
    """A composable transformation. Subclasses override ``apply``; chaining
    uses ``a >> b`` (the reference's ``a -> b``,
    ``feature/common/Preprocessing.scala``)."""

    def apply(self, data: Any) -> Any:
        raise NotImplementedError(type(self).__name__)

    def __call__(self, data: Any) -> Any:
        return self.apply(data)

    def __rshift__(self, other: "Preprocessing") -> "ChainedPreprocessing":
        return ChainedPreprocessing([self, other])


class ChainedPreprocessing(Preprocessing):
    """``ChainedPreprocessing`` — function composition."""

    def __init__(self, stages: Sequence[Preprocessing]):
        flat = []
        for s in stages:
            if isinstance(s, ChainedPreprocessing):
                flat.extend(s.stages)
            else:
                flat.append(s)
        self.stages = flat

    def apply(self, data):
        for s in self.stages:
            data = s(data)
        return data

    def __rshift__(self, other: Preprocessing) -> "ChainedPreprocessing":
        return ChainedPreprocessing(self.stages + [other])


class FnPreprocessing(Preprocessing):
    """Wrap a plain function (the reference's ``BigDLAdapter`` role)."""

    def __init__(self, fn: Callable[[Any], Any], name: Optional[str] = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "fn")

    def apply(self, data):
        return self.fn(data)


class SeqToTensor(Preprocessing):
    """``SeqToTensor.scala`` — number sequence → float array, optionally
    reshaped to ``size`` (per example)."""

    def __init__(self, size: Optional[Tuple[int, ...]] = None,
                 dtype: Any = np.float32):
        self.size = tuple(size) if size is not None else None
        self.dtype = dtype

    def apply(self, data):
        a = np.asarray(data, self.dtype)
        if self.size is not None:
            a = a.reshape((a.shape[0],) + self.size)
        return a


class ArrayToTensor(Preprocessing):
    """``ArrayToTensor.scala`` — stack a list of per-example arrays."""

    def __init__(self, dtype: Any = np.float32):
        self.dtype = dtype

    def apply(self, data):
        return np.stack([np.asarray(d, self.dtype) for d in data])


class ScalarToTensor(Preprocessing):
    """``ScalarToTensor.scala`` — scalars → (N, 1) array."""

    def __init__(self, dtype: Any = np.float32):
        self.dtype = dtype

    def apply(self, data):
        return np.asarray(data, self.dtype).reshape(-1, 1)


class Normalize(Preprocessing):
    """Feature scaling: ``(x - mean) / std`` (vectorized; the image pipeline
    has its own channel-wise variant)."""

    def __init__(self, mean: Any, std: Any):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def apply(self, data):
        return (np.asarray(data, np.float32) - self.mean) / self.std


class FeatureLabelPreprocessing(Preprocessing):
    """``FeatureLabelPreprocessing.scala`` — apply one chain to features and
    another to labels of an ``(x, y)`` pair."""

    def __init__(self, feature: Preprocessing, label: Optional[Preprocessing] = None):
        self.feature = feature
        self.label = label

    def apply(self, data):
        x, y = data
        fx = self.feature(x)
        fy = self.label(y) if (self.label is not None and y is not None) else y
        return fx, fy
