"""NNFrames — port of ``analytics_zoo_tpu/pipeline/nnframes/
nn_estimator.py``, the DataFrame-pipeline adapter (``NNEstimator.scala`` /
``NNClassifier.scala`` of the reference).

The "DataFrame" is a columnar table — a dict of column name → numpy array.
``NNEstimator.fit(table)`` trains through the ``Estimator`` and returns an
``NNModel`` transformer; ``NNModel.transform(table)`` appends a prediction
column; ``NNClassifier``'s model appends the argmax class.

``NNModel.save`` writes one pickle file (through a ``.tmp`` and
``os.replace``): the fitted transformer with its weights on the host, its
preprocessing and its column settings, without the training loop or the
optimizer state; activations are stored by name. The file pickles this
package's classes, so it loads only here; the ZooModel ``.npz``
(``ZooModel.save``) is the format that crosses packages.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ...common.triggers import Trigger
from ...feature.feature_set import FeatureSet
from ..api.keras.engine import KerasNet
from ..estimator.estimator import Estimator

__all__ = ["NNEstimator", "NNModel", "NNClassifier", "NNClassifierModel"]

Table = Dict[str, np.ndarray]


def _assemble(table: Table, cols: Sequence[str]) -> np.ndarray:
    """VectorAssembler role: concatenate columns into one float feature
    matrix. Scalar columns become width-1; array columns keep their width
    (``NNEstimator.scala:385-403`` unwraps ML vectors the same way)."""
    parts = []
    for c in cols:
        if c not in table:
            raise KeyError(f"column {c!r} not in table; have {sorted(table)}")
        a = np.asarray(table[c])
        parts.append(a[:, None] if a.ndim == 1 else a.reshape(a.shape[0], -1))
    return np.concatenate(parts, axis=1).astype(np.float32)


class NNEstimator:
    """``NNEstimator(model, criterion, samplePreprocessing)``
    (``NNEstimator.scala:160-209``). ``feature_preprocessing`` maps the
    table to the model's input array(s) — pass a callable for multi-input
    models (e.g. ``ColumnFeatureInfo.input_arrays``); by default the
    ``features_col`` columns are assembled into one float matrix."""

    def __init__(self, model: KerasNet, criterion: Any = "mse",
                 feature_preprocessing: Optional[Callable[[Table], Any]] = None):
        self.model = model
        self.criterion = criterion
        self.feature_preprocessing = feature_preprocessing
        self.features_col: List[str] = ["features"]
        self.label_col = "label"
        self.prediction_col = "prediction"
        self.batch_size = 32
        self.max_epoch = 1
        self.optim_method: Any = "adam"
        self.end_trigger: Optional[Trigger] = None
        self.checkpoint_trigger: Optional[Trigger] = None
        self.model_dir: Optional[str] = None
        self.label_dtype = np.float32

    # ---- Spark-ML-style param setters (NNEstimator.scala param surface) ---
    def set_features_col(self, *cols: str) -> "NNEstimator":
        self.features_col = list(cols)
        return self

    def set_label_col(self, col: str) -> "NNEstimator":
        self.label_col = col
        return self

    def set_prediction_col(self, col: str) -> "NNEstimator":
        self.prediction_col = col
        return self

    def set_batch_size(self, bs: int) -> "NNEstimator":
        self.batch_size = int(bs)
        return self

    def set_max_epoch(self, n: int) -> "NNEstimator":
        self.max_epoch = int(n)
        return self

    def set_optim_method(self, opt: Any) -> "NNEstimator":
        self.optim_method = opt
        return self

    def set_end_when(self, trigger: Trigger) -> "NNEstimator":
        self.end_trigger = trigger
        return self

    def set_checkpoint(self, path: str,
                       trigger: Optional[Trigger] = None) -> "NNEstimator":
        """``setCheckpoint`` (``NNEstimator.scala:131-140``)."""
        self.model_dir = path
        self.checkpoint_trigger = trigger
        return self

    # ---- fit (NNEstimator.scala:414-479) ----------------------------------
    def _features(self, table: Table):
        if self.feature_preprocessing is not None:
            return self.feature_preprocessing(table)
        return _assemble(table, self.features_col)

    def _label(self, table: Table) -> np.ndarray:
        if self.label_col not in table:
            raise KeyError(f"label column {self.label_col!r} not in table")
        y = np.asarray(table[self.label_col])
        y = y.astype(self.label_dtype)
        return y[:, None] if y.ndim == 1 and self.label_dtype == np.float32 else y

    def fit(self, table: Table, validation_table: Optional[Table] = None,
            ) -> "NNModel":
        x = self._features(table)
        y = self._label(table)
        fs = FeatureSet.array(x, y)
        est = Estimator(self.model, optim_methods=self.optim_method,
                        model_dir=self.model_dir)
        val = None
        if validation_table is not None:
            val = FeatureSet.array(self._features(validation_table),
                                   self._label(validation_table))
        est.train(fs, self.criterion, batch_size=self.batch_size,
                  nb_epoch=self.max_epoch, end_trigger=self.end_trigger,
                  checkpoint_trigger=self.checkpoint_trigger,
                  validation_set=val)
        return self._wrap_model()

    def _wrap_model(self) -> "NNModel":
        return NNModel(self.model,
                       feature_preprocessing=self.feature_preprocessing,
                       features_col=self.features_col,
                       prediction_col=self.prediction_col,
                       batch_size=self.batch_size)


def _place(model: KerasNet, device: torch.device) -> None:
    """Moves ``model``'s weights and state to ``device`` and records it as
    the device of every network in it (a ZooModel and its inner graph)."""
    model.to(device)
    for m in model.modules():
        if isinstance(m, KerasNet) and hasattr(m, "device"):
            m.device = device


class _ZooPickler:
    """Pickle helpers that serialize REGISTRY objects by name: layers store
    resolved activation callables (several ``ACTIVATIONS`` entries are
    lambdas, which do not pickle), so identity-match them back to their
    ``ACTIVATIONS`` key and re-resolve on load."""

    @staticmethod
    def dumps(obj) -> bytes:
        import io
        import pickle

        from ..api.keras.layers.core import ACTIVATIONS

        class P(pickle.Pickler):
            def persistent_id(self, o):
                for name, fn in ACTIVATIONS.items():
                    if o is fn:
                        return ("zoo_activation", name)
                return None

        buf = io.BytesIO()
        P(buf).dump(obj)
        return buf.getvalue()

    @staticmethod
    def load(f):
        import pickle

        class U(pickle.Unpickler):
            def persistent_load(self, pid):
                kind, name = pid
                if kind == "zoo_activation":
                    from ..api.keras.layers.core import ACTIVATIONS
                    return ACTIVATIONS[name]
                raise pickle.UnpicklingError(f"unknown persistent id {pid}")

        return U(f).load()


class NNModel:
    """Transformer: appends ``prediction_col`` to the table
    (``NNModel.transform`` → ``Predictor.scala:136-208``)."""

    def __init__(self, model: KerasNet, *,
                 feature_preprocessing: Optional[Callable] = None,
                 features_col: Sequence[str] = ("features",),
                 prediction_col: str = "prediction",
                 batch_size: int = 32):
        self.model = model
        self.feature_preprocessing = feature_preprocessing
        self.features_col = list(features_col)
        self.prediction_col = prediction_col
        self.batch_size = batch_size

    def _features(self, table: Table):
        if self.feature_preprocessing is not None:
            return self.feature_preprocessing(table)
        return _assemble(table, self.features_col)

    def transform(self, table: Table) -> Table:
        preds = self.model.predict(self._features(table),
                                   batch_size=self.batch_size)
        out = dict(table)
        out[self.prediction_col] = self._postprocess(np.asarray(preds))
        return out

    def _postprocess(self, preds: np.ndarray) -> np.ndarray:
        return preds

    # ---- persistence (NNEstimator.scala:60-72 read/write region,
    # DefaultParamsWriterWrapper.scala) ------------------------------------
    def save(self, path: str, over_write: bool = True) -> str:
        """Persist the FITTED transformer — weights, architecture,
        preprocessing chain, and column config — as one file, the role of
        the reference's ML-pipeline ``NNModel.write`` (params +
        serialized module + sample preprocessing). A fresh process
        ``NNModel.load(path).transform(table)``s without re-fitting.

        The preprocessing callable must be picklable (a ``Preprocessing``
        instance, named function, or functools.partial — the same
        serializable-stages contract Spark ML imposes); lambdas raise with
        that guidance."""
        import copy
        import os
        import pickle

        if os.path.exists(path) and not over_write:
            raise FileExistsError(f"{path} exists and over_write=False")
        clean = copy.copy(self)
        # the copy leaves the training loop and the optimizer state behind
        # (KerasNet.__getstate__): the reference's saved NNModel likewise
        # carries weights, not optimizer state; the weights go to the host
        model = copy.deepcopy(self.model)
        _place(model, torch.device("cpu"))
        clean.model = model
        try:
            blob = _ZooPickler.dumps(clean)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            raise ValueError(
                f"NNModel.save: the transformer is not picklable ({e}) — "
                f"feature_preprocessing must be a Preprocessing instance, "
                f"a module-level function, or a functools.partial, not a "
                f"lambda/closure") from e
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
        return path

    @staticmethod
    def load(path: str, device=None) -> "NNModel":
        """``NNModel.read.load`` — restores the fitted transformer (the
        concrete subclass, e.g. ``NNClassifierModel``, round-trips via the
        pickle class tag) with its weights on ``device`` (``cuda`` unless
        given; raises without a GPU)."""
        from ...common.context import resolve_device
        with open(path, "rb") as f:
            obj = _ZooPickler.load(f)
        if not isinstance(obj, NNModel):
            raise ValueError(f"{path} does not contain an NNModel "
                             f"(got {type(obj).__name__})")
        _place(obj.model, resolve_device(device))
        return obj


class NNClassifier(NNEstimator):
    """``NNClassifier`` (``NNClassifier.scala``): integer labels, argmax
    predictions."""

    def __init__(self, model: KerasNet,
                 criterion: Any = "sparse_categorical_crossentropy",
                 feature_preprocessing: Optional[Callable] = None):
        super().__init__(model, criterion, feature_preprocessing)
        self.label_dtype = np.int32

    def _wrap_model(self) -> "NNClassifierModel":
        return NNClassifierModel(
            self.model, feature_preprocessing=self.feature_preprocessing,
            features_col=self.features_col,
            prediction_col=self.prediction_col, batch_size=self.batch_size)


class NNClassifierModel(NNModel):
    def _postprocess(self, preds: np.ndarray) -> np.ndarray:
        from ...utils.prediction import probs_to_classes
        return probs_to_classes(preds)
