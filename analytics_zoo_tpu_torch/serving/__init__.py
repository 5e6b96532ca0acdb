"""Cluster Serving — port of ``analytics_zoo_tpu/serving`` (multi-model
lanes, the dead-letter queue, ``LocalBackend``)."""

from .backend import LocalBackend, QueueFullError
from .client import InputQueue, OutputQueue, ServingError
from .dlq import DeadLetterQueue
from .server import ClusterServing

__all__ = ["ClusterServing", "DeadLetterQueue", "InputQueue", "LocalBackend",
           "OutputQueue", "QueueFullError", "ServingError"]
