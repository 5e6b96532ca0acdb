"""Port of ``analytics_zoo_tpu/pipeline/estimator``: the Estimator facade."""

from .estimator import Estimator, LocalEstimator  # noqa: F401

__all__ = ["Estimator", "LocalEstimator"]
