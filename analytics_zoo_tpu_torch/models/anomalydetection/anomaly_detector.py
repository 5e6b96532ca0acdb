"""AnomalyDetector — port of ``analytics_zoo_tpu/models/anomalydetection/
anomaly_detector.py`` (``models/anomalydetection/AnomalyDetector.scala:
40,65`` of the reference).

Stacked ``LSTM``s that return sequences, each followed by a ``Dropout``,
then a last ``LSTM`` and its ``Dropout`` and a ``Dense(1)`` regressor.
:func:`unroll` windows a series into training tensors and
:func:`detect_anomalies` ranks the prediction errors; both are numpy,
copies of the JAX package's functions.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ...pipeline.api.keras.engine import Sequential
from ...pipeline.api.keras.layers import LSTM, Dense, Dropout
from ..common.zoo_model import ZooModel, register_model


@register_model
class AnomalyDetector(ZooModel):
    """``AnomalyDetector(featureShape, hiddenLayers, dropouts)``;
    ``device`` is where the weights live (``cuda`` unless given)."""

    def __init__(self, feature_shape: Sequence[int],
                 hidden_layers: Sequence[int] = (8, 32, 15),
                 dropouts: Sequence[float] = (0.2, 0.2, 0.2),
                 name: Optional[str] = None, device=None):
        if len(hidden_layers) != len(dropouts):
            raise ValueError("hidden_layers and dropouts must align")
        self.feature_shape = tuple(int(d) for d in feature_shape)
        self.hidden_layers = tuple(int(h) for h in hidden_layers)
        self.dropouts = tuple(float(d) for d in dropouts)
        super().__init__(name=name, device=device)

    def build_model(self) -> Sequential:
        m = Sequential(device=self.device)
        first = {"input_shape": self.feature_shape}
        for units, drop in zip(self.hidden_layers[:-1], self.dropouts[:-1]):
            m.add(LSTM(units, return_sequences=True, **first))
            m.add(Dropout(drop))
            first = {}
        m.add(LSTM(self.hidden_layers[-1], return_sequences=False, **first))
        m.add(Dropout(self.dropouts[-1]))
        m.add(Dense(1))
        return m

    def get_config(self) -> Dict[str, Any]:
        return {"feature_shape": list(self.feature_shape),
                "hidden_layers": list(self.hidden_layers),
                "dropouts": list(self.dropouts)}


def unroll(data: np.ndarray, unroll_length: int,
           predict_step: int = 1) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Windows of a series — ``AnomalyDetector.unroll``: (features
    ``(N, unroll_length, D)``, labels ``(N,)``, indices ``(N,)``). The
    label is the first feature ``predict_step`` after the window."""
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[:, None]
    n = data.shape[0] - unroll_length - predict_step + 1
    if n <= 0:
        raise ValueError("series too short for the requested unroll_length")
    idx = np.arange(unroll_length)[None, :] + np.arange(n)[:, None]
    x = data[idx]
    y = data[np.arange(n) + unroll_length + predict_step - 1, 0]
    return x, y, np.arange(n)


def detect_anomalies(y_truth: np.ndarray, y_predict: np.ndarray,
                     anomaly_size: int = 5) -> np.ndarray:
    """``detectAnomalies``: the ``anomaly_size`` points farthest from
    their prediction keep their true value, every other point is NaN
    (shaped like ``y_truth``, flattened)."""
    t = np.asarray(y_truth, np.float32).reshape(-1)
    p = np.asarray(y_predict, np.float32).reshape(-1)
    dist = np.abs(t - p)
    thresh_idx = np.argsort(-dist)[:anomaly_size]
    out = np.full_like(t, np.nan)
    out[thresh_idx] = t[thresh_idx]
    return out
