"""Port of ``analytics_zoo_tpu/pipeline/nnframes``: the columnar-table ML
pipeline (``NNEstimator``, ``NNModel``, ``NNClassifier``,
``NNClassifierModel``). ``NNImageReader`` waits for the image features,
which are not ported yet."""

from .nn_estimator import NNClassifier, NNClassifierModel, NNEstimator, NNModel

__all__ = ["NNEstimator", "NNModel", "NNClassifier", "NNClassifierModel"]
