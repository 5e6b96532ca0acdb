"""Port of ``analytics_zoo_tpu/feature`` (the in-memory FeatureSet and the
preprocessing combinators)."""

from .common import (ArrayToTensor, ChainedPreprocessing,
                     FeatureLabelPreprocessing, FnPreprocessing, Normalize,
                     Preprocessing, ScalarToTensor, SeqToTensor)
from .feature_set import FeatureSet

__all__ = ["ArrayToTensor", "ChainedPreprocessing", "FeatureLabelPreprocessing",
           "FeatureSet", "FnPreprocessing", "Normalize", "Preprocessing",
           "ScalarToTensor", "SeqToTensor"]
