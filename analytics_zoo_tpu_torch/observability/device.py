"""Device memory telemetry — HBM headroom as first-class gauges; the
port of ``analytics_zoo_tpu/observability/device.py`` on ``torch.cuda``.

Where the JAX package reads ``jax.Device.memory_stats()``, this module
reads the CUDA caching allocator and ``cudaMemGetInfo``:

* ``in_use`` — ``torch.cuda.memory_stats()["allocated_bytes.all.current"]``,
* ``peak`` — ``...["allocated_bytes.all.peak"]``,
* ``limit`` — ``torch.cuda.mem_get_info()[1]`` (the card's total bytes),

and polls them into

    ``zoo_device_hbm_bytes{device=,kind=in_use|peak|limit}``

with the device labelled ``gpu:<index>``, as jax names a GPU. Without a
CUDA device every entry point is a graceful no-op — the gauges simply
never appear, as the JAX module behaves off-TPU.

Entry points:

* :func:`device_memory_stats` — one poll, plain dicts (the ``/statusz``
  block).
* :func:`sample_device_memory` — one poll **into a registry**.
* :class:`DeviceMemorySampler` — daemon thread sampling on the
  ``zoo.telemetry.sample_interval_s`` cadence for long-running servers.
"""

from __future__ import annotations

import logging
import sys
import threading
from typing import Dict, List, Optional

from .metrics import MetricsRegistry, default_registry

log = logging.getLogger("analytics_zoo_tpu_torch.observability")

__all__ = ["device_memory_stats", "sample_device_memory",
           "DeviceMemorySampler"]

#: memory_stats() key per exported ``kind=`` label value (``limit`` comes
#: from ``mem_get_info``)
_KIND_KEYS = (("in_use", "allocated_bytes.all.current"),
              ("peak", "allocated_bytes.all.peak"),
              ("limit", None))


def device_memory_stats() -> List[Dict[str, float]]:
    """One poll of every visible CUDA device's allocator stats:
    ``[{"device": "gpu:0", "in_use": ..., "peak": ..., "limit": ...},
    ...]``. Without a CUDA device it returns ``[]``. A device the
    allocator has not touched yet reports 0 in use; polling never
    initialises CUDA on a host whose process has not, and never imports
    torch into one that has not (the operator CLIs start without it)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return []
    try:
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return []
        n = torch.cuda.device_count()
    except Exception:
        return []
    out: List[Dict[str, float]] = []
    for i in range(n):
        try:
            stats = torch.cuda.memory_stats(i)
            limit = torch.cuda.mem_get_info(i)[1]
        except Exception:
            continue
        entry: Dict[str, float] = {"device": f"gpu:{i}"}
        for kind, key in _KIND_KEYS:
            if key is None:
                entry[kind] = float(limit)
            elif key in stats:
                entry[kind] = float(stats[key])
            else:
                entry[kind] = 0.0
        out.append(entry)
    return out


def sample_device_memory(
        registry: Optional[MetricsRegistry] = None
) -> List[Dict[str, float]]:
    """Poll once and set the ``zoo_device_hbm_bytes`` gauges; returns
    the polled stats (empty off-device, in which case no gauge is
    registered — absent beats lying zero)."""
    stats = device_memory_stats()
    if not stats:
        return stats
    reg = registry if registry is not None else default_registry()
    for entry in stats:
        device = entry["device"]
        for kind, _key in _KIND_KEYS:
            if kind not in entry:
                continue
            reg.gauge(
                "zoo_device_hbm_bytes",
                "device allocator bytes per local device "
                "(kind=in_use|peak|limit)",
                labels={"device": device, "kind": kind},
            ).set(entry[kind])
    return stats


class DeviceMemorySampler:
    """Daemon thread calling :func:`sample_device_memory` on a cadence
    (``zoo.telemetry.sample_interval_s`` by default). Safe to start
    off-device: each tick is a no-op."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 interval_s: Optional[float] = None):
        if interval_s is None:
            from .timeseries import _conf
            interval_s = _conf("zoo.telemetry.sample_interval_s", 1.0)
        self.registry = registry if registry is not None \
            else default_registry()
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "DeviceMemorySampler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="zoo-device-memory-sampler",
            daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                sample_device_memory(self.registry)
            except Exception:       # telemetry must never kill a host
                log.exception("device memory sample failed")

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
