"""Port of ``analytics_zoo_tpu/models/recommendation``: ``NeuralCF`` and
the ``Recommender`` base. ``WideAndDeep`` (it needs ``nnframes``) and
``SessionRecommender`` are not ported yet."""

from .neural_cf import NeuralCF, Recommender  # noqa: F401
