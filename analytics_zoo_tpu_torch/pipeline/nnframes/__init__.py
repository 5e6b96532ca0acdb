"""Port of ``analytics_zoo_tpu/pipeline/nnframes``: the columnar-table ML
pipeline (``NNEstimator``, ``NNModel``, ``NNClassifier``,
``NNClassifierModel``) and ``NNImageReader``."""

from .nn_estimator import NNClassifier, NNClassifierModel, NNEstimator, NNModel
from .nn_image_reader import NNImageReader

__all__ = ["NNEstimator", "NNModel", "NNClassifier", "NNClassifierModel",
           "NNImageReader"]
