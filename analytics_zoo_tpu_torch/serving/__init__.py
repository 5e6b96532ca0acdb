"""Cluster Serving — port of ``analytics_zoo_tpu/serving`` (multi-model
lanes, the dead-letter queue, fleet serving on ``LocalBackend`` or on
``RedisBackend`` over the RESP wire)."""

from .backend import (LocalBackend, QueueFullError, RedisBackend,
                      default_backend)
from .client import InputQueue, OutputQueue, ServingError
from .dlq import DeadLetterQueue
from .fleet import FleetSaturatedError, FleetView
from .server import ClusterServing

__all__ = ["ClusterServing", "DeadLetterQueue", "FleetSaturatedError",
           "FleetView", "InputQueue", "LocalBackend", "OutputQueue",
           "QueueFullError", "RedisBackend", "ServingError",
           "default_backend"]
