"""Port of ``analytics_zoo_tpu/models/recommendation``: ``NeuralCF``,
``WideAndDeep`` (with ``ColumnFeatureInfo``) and the ``Recommender``
base. ``SessionRecommender`` is not ported yet."""

from .neural_cf import NeuralCF, Recommender  # noqa: F401
from .wide_and_deep import ColumnFeatureInfo, WideAndDeep  # noqa: F401
