"""Vision model zoo — port of ``analytics_zoo_tpu/models/image`` (image
classification; object detection lives in ``objectdetection``)."""

from .common.image_model import ImageModel
from .imageclassification.image_classifier import ImageClassifier, inception_v1

__all__ = ["ImageModel", "ImageClassifier", "inception_v1"]
