"""Estimator — port of ``analytics_zoo_tpu/pipeline/estimator/
estimator.py`` (the reference's ``pipeline/estimator/Estimator.scala:
33-183``): a model + per-submodule optimizers + gradient clipping, driving
the shared training engine on a ``FeatureSet``, with checkpoint/end
triggers and validation.

It delegates to the ``TrainingLoop`` that backs ``KerasNet.fit`` — one
engine, two facades — and takes the port's ``GradientTransformation``s
(``keras/optimizers.py``) where the JAX package takes optax's. A dict of
``optim_methods`` becomes ``multi_optimizer``, whose state checkpoints in
optax's leaf order, so a ``model_dir`` snapshot resumes across packages.

``LocalEstimator`` (``LocalEstimator.scala:39-48``) keeps the array-based
``fit(x, y)`` surface over the same loop.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from ...common.triggers import Trigger
from ...feature.feature_set import FeatureSet
from ..api.keras import metrics as metrics_lib
from ..api.keras import objectives
from ..api.keras import optimizers as optim_lib
from ..api.keras.engine import KerasNet
from ..api.keras.training import TrainingLoop

__all__ = ["Estimator", "LocalEstimator"]


class Estimator:
    """``Estimator(model, optimMethods, modelDir)``
    (``Estimator.scala:65-68``). ``optim_methods`` is a single optimizer
    spec (name / ``GradientTransformation``) or a dict mapping a
    layer-name prefix to one — the per-submodule split of
    ``Topology.scala:1122-1143``."""

    def __init__(self, model: KerasNet,
                 optim_methods: Union[str, optim_lib.GradientTransformation,
                                      Dict[str, Any], None] = "adam",
                 model_dir: Optional[str] = None):
        self.model = model
        self.model_dir = model_dir
        self._optim_methods = optim_methods
        self._clip_value: Optional[float] = None
        self._clip_norm: Optional[float] = None
        self._loop: Optional[TrainingLoop] = None
        self._loop_key = None  # (criterion, validation_methods) the loop was built for
        self._last_criterion: Any = None

    # ---- clipping (Estimator.scala:75-100) --------------------------------
    def set_constant_gradient_clipping(self, min_v: float, max_v: float):
        """Symmetric constant clipping; the engine clips by absolute value so
        the bound is ``max(|min|, |max|)`` (``optax.clip`` semantics)."""
        self._clip_value = max(abs(min_v), abs(max_v))
        self._loop = None
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float):
        self._clip_norm = clip_norm
        self._loop = None
        return self

    def clear_gradient_clipping(self):
        self._clip_value = self._clip_norm = None
        self._loop = None
        return self

    # ---- engine assembly --------------------------------------------------
    def _build_optimizer(self) -> optim_lib.GradientTransformation:
        om = self._optim_methods
        if isinstance(om, dict):
            opt = optim_lib.multi_optimizer(om)
        else:
            opt = optim_lib.get_optimizer(om if om is not None else "adam")
        return optim_lib.with_clipping(opt, clip_norm=self._clip_norm,
                                      clip_value=self._clip_value)

    def _get_loop(self, criterion, validation_methods) -> TrainingLoop:
        """Build (or reuse) the engine loop. Reuse requires the SAME
        (criterion, validation_methods) specs — rebuilding needlessly would
        discard optimizer state across incremental ``train`` calls, while
        reusing across a criterion change would silently train on the old
        loss."""
        key = (criterion if isinstance(criterion, str) else id(criterion),
               tuple(m if isinstance(m, str) else id(m)
                     for m in (validation_methods or [])))
        if self._loop is not None and self._loop_key == key:
            return self._loop
        loss_fn = objectives.get_loss(criterion)
        ms = [metrics_lib.get_metric(m) for m in (validation_methods or [])]
        loop = TrainingLoop(self.model, self._build_optimizer(), loss_fn, ms)
        self._loop, self._loop_key = loop, key
        self.model._loop = loop  # evaluate/predict facades reuse it
        return loop

    # ---- train / evaluate (Estimator.scala:118-176) -----------------------
    def train(self, train_set: FeatureSet, criterion: Any = "mse", *,
              batch_size: int = 32, nb_epoch: int = 1,
              end_trigger: Optional[Trigger] = None,
              checkpoint_trigger: Optional[Trigger] = None,
              checkpoint_keep: Optional[int] = None,
              validation_set: Optional[FeatureSet] = None,
              validation_methods: Optional[Sequence[Any]] = None,
              callbacks: Sequence[Callable] = ()) -> Dict[str, List[float]]:
        """Train on a FeatureSet. Checkpoints go to ``model_dir`` on
        ``checkpoint_trigger`` (``Estimator.scala:118-155``) through the
        durable async checkpoint subsystem (``utils/checkpoint.py``:
        manifest-committed snapshots, verified resume with corruption
        fallback), with the engine's retry-on-failure semantics. ``checkpoint_keep`` bounds retention
        (default: the ``zoo.checkpoint.keep`` conf; 0 keeps every
        snapshot)."""
        if not isinstance(train_set, FeatureSet):
            raise TypeError("train expects a FeatureSet; build one with "
                            "FeatureSet.array(...)")
        self._get_loop(criterion, validation_methods)
        self._last_criterion = criterion
        if self.model_dir is not None:
            self.model.set_checkpoint(self.model_dir,
                                      trigger=checkpoint_trigger,
                                      keep=checkpoint_keep)
        elif checkpoint_trigger is not None:
            import logging
            logging.getLogger("analytics_zoo_tpu_torch.estimator").warning(
                "checkpoint_trigger given but Estimator has no model_dir — "
                "no snapshots will be written and a failure cannot resume")
        val = None
        if validation_set is not None:
            val = (validation_set.x, validation_set.y)
        return self._loop.fit_feature_set(
            train_set, batch_size=batch_size, nb_epoch=nb_epoch,
            validation_data=val, end_trigger=end_trigger, callbacks=callbacks)

    def evaluate(self, validation_set: FeatureSet,
                 validation_methods: Optional[Sequence[Any]] = None, *,
                 criterion: Any = None,
                 batch_size: int = 32) -> Dict[str, float]:
        """``criterion`` defaults to whatever ``train`` last used, so the
        reported loss matches the trained objective."""
        if criterion is None:
            criterion = (self._last_criterion
                         if self._last_criterion is not None else "mse")
        loop = self._get_loop(criterion, validation_methods)
        return loop.evaluate(validation_set.x, validation_set.y,
                             batch_size=batch_size)


class LocalEstimator(Estimator):
    """``LocalEstimator(model, criterion, optimMethod).fit(data, ...)``
    (``LocalEstimator.scala:39-48,89``) — the array-based single-host
    surface: the ``fit(x, y)`` facade over :class:`Estimator`."""

    def __init__(self, model: KerasNet, criterion: Any = "mse",
                 optim_method: Union[str, optim_lib.GradientTransformation,
                                     None] = "adam"):
        super().__init__(model, optim_methods=optim_method)
        self.criterion = criterion

    def fit(self, x, y, *, batch_size: int = 32, nb_epoch: int = 1,
            validation_data=None,
            validation_methods: Optional[Sequence[Any]] = None,
            callbacks: Sequence[Callable] = ()) -> Dict[str, List[float]]:
        val = (FeatureSet.array(*validation_data)
               if (validation_data is not None
                   and not isinstance(validation_data, FeatureSet))
               else validation_data)
        return self.train(FeatureSet.array(x, y),
                          criterion=self.criterion, batch_size=batch_size,
                          nb_epoch=nb_epoch, validation_set=val,
                          validation_methods=validation_methods,
                          callbacks=callbacks)
