from .image_classifier import ImageClassifier, inception_v1

__all__ = ["ImageClassifier", "inception_v1"]
