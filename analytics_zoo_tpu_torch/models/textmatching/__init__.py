"""Port of ``analytics_zoo_tpu/models/textmatching``: ``KNRM``."""

from .knrm import KNRM  # noqa: F401
