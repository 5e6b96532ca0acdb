"""Port of ``analytics_zoo_tpu/feature``: the FeatureSet family (in-memory,
disk slices, buckets), device prefetch and the preprocessing combinators."""

from .common import (ArrayToTensor, ChainedPreprocessing,
                     FeatureLabelPreprocessing, FnPreprocessing, Normalize,
                     Preprocessing, ScalarToTensor, SeqToTensor)
from .feature_set import (BucketedFeatureSet, DiskFeatureSet, FeatureSet,
                          prefetch_to_device)

__all__ = ["ArrayToTensor", "BucketedFeatureSet", "ChainedPreprocessing",
           "DiskFeatureSet", "FeatureLabelPreprocessing", "FeatureSet",
           "FnPreprocessing", "Normalize", "Preprocessing",
           "ScalarToTensor", "SeqToTensor", "prefetch_to_device"]
