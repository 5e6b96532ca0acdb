"""Observability — port of ``analytics_zoo_tpu/observability``, under the
JAX package's names: the metrics registry (same ``zoo_*`` metric names),
span tracing and trace ids, the Prometheus / JSON-lines exports with the
``/metrics``, ``/healthz``, ``/statusz`` and ``POST /profilez`` endpoint,
ring-buffer time series, the alert engine, the fleet collector with its
``/fleetz`` endpoint (and the fleet rollup the status CLI uses), device
memory from ``torch.cuda``, goodput accounting, the profiler trigger
on ``torch.profiler``, and compile accounting (``compile.py``: CUDA-graph
captures and kernel library builds under the ``zoo_jit_*`` names; the
port has no jit, so ``instrument_jit`` itself has no counterpart), and the
TensorBoard sink over ``utils/tensorboard.py``.
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      QuantileDigest, Summary, default_registry,
                      reset_default_registry)
from .tracing import current_span, new_trace_id, span
from .export import (JsonEventSink, ScrapeServer, TensorBoardSink, dump,
                     parse_prometheus, read_events, render_prometheus)
from .timeseries import (RegistrySampler, RingBuffer, SummarySample,
                         TimeSeriesStore, rehydrate_digest)
from .device import (DeviceMemorySampler, device_memory_stats,
                     sample_device_memory)
from .alerts import (AlertEngine, AlertRule, StoreSignals,
                     burn_rate_rule, default_ruleset,
                     quantile_burn_rule)
from .collector import (FleetCollector, FleetSignals, FleetzServer,
                        base_url, endpoint_rows, fleet_rows,
                        summary_points)
from .goodput import (GOOD_CATEGORY, SERVE_CATEGORIES, TRAIN_CATEGORIES,
                      GoodputLedger, goodput_enabled)
from .goodput import registry_snapshot as goodput_snapshot
from .profiler import ProfilerTrigger
from .compile import CompileTracker, record_compile

__all__ = [
    "Counter", "Gauge", "Histogram", "QuantileDigest", "Summary",
    "MetricsRegistry", "default_registry", "reset_default_registry",
    "span", "current_span", "new_trace_id",
    "JsonEventSink", "ScrapeServer", "TensorBoardSink",
    "dump", "parse_prometheus", "read_events", "render_prometheus",
    "RingBuffer", "SummarySample", "TimeSeriesStore", "RegistrySampler",
    "rehydrate_digest",
    "DeviceMemorySampler", "device_memory_stats", "sample_device_memory",
    "AlertEngine", "AlertRule", "StoreSignals", "burn_rate_rule",
    "quantile_burn_rule", "default_ruleset",
    "FleetCollector", "FleetSignals", "FleetzServer",
    "summary_points", "fleet_rows", "endpoint_rows", "base_url",
    "GoodputLedger", "GOOD_CATEGORY", "TRAIN_CATEGORIES",
    "SERVE_CATEGORIES", "goodput_enabled", "goodput_snapshot",
    "ProfilerTrigger", "CompileTracker", "record_compile",
]
