"""Port of ``analytics_zoo_tpu/models/textclassification``:
``TextClassifier``."""

from .text_classifier import TextClassifier  # noqa: F401
