"""Port of ``analytics_zoo_tpu/feature`` (the in-memory FeatureSet)."""

from .feature_set import FeatureSet

__all__ = ["FeatureSet"]
