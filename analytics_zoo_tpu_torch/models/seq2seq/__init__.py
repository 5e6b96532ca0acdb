"""Port of ``analytics_zoo_tpu/models/seq2seq``: ``Seq2seq``."""

from .seq2seq import Seq2seq  # noqa: F401
