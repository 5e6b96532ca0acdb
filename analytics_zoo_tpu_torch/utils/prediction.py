"""Shared prediction post-processing — port of ``analytics_zoo_tpu/utils/
prediction.py``: the ``predictClass`` decode rule, one implementation for
``KerasNet.predict_classes`` and ``InferenceModel.predict_classes``."""

from __future__ import annotations

import numpy as np

__all__ = ["probs_to_classes"]


def probs_to_classes(probs: np.ndarray, zero_based: bool = True,
                     threshold: float = 0.5) -> np.ndarray:
    """Multi-class: argmax over the last axis. Binary (one column or 1-D):
    threshold at ``threshold``."""
    probs = np.asarray(probs)
    if probs.ndim > 1 and probs.shape[-1] > 1:
        cls = np.argmax(probs, axis=-1).astype(np.int32)
    else:
        cls = (probs.reshape(-1) > threshold).astype(np.int32)
    return cls if zero_based else cls + 1
