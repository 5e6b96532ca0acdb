"""Port of ``analytics_zoo_tpu/models/recommendation``: ``NeuralCF``,
``SessionRecommender``, ``WideAndDeep`` (with ``ColumnFeatureInfo``) and
the ``Recommender`` base."""

from .neural_cf import NeuralCF, Recommender  # noqa: F401
from .session_recommender import SessionRecommender  # noqa: F401
from .wide_and_deep import ColumnFeatureInfo, WideAndDeep  # noqa: F401
