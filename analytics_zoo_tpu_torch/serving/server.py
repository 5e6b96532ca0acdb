"""Cluster Serving — port of ``analytics_zoo_tpu/serving/server.py``: read →
route → batch assembly → ``predict_async`` with a bounded dispatch window →
readback → async publish → ack, organised as per-model lanes.

* **Lanes.** One ``ClusterServing`` hosts one model or several
  (``{name: model | spec}``, a spec dict naming ``model`` and optionally
  ``weight``, ``dtype``, ``batch_size`` and ``max_inflight``). Records
  are routed by the ``model`` wire field (none → the primary, first
  lane; an unknown name → the ``unknown model`` error). Each lane owns
  its admitted-record buffer, dispatch window, pooled batch arenas, AIMD
  batch target and dispatch circuit breaker: a model that keeps crashing
  fast-fails its own records (``model unavailable``, spilled to the DLQ)
  while the other lanes serve. Per-lane ceilings come from the spec or
  ``zoo.serving.lane_{batch_size,max_inflight}``.
* **Buckets and arenas.** A lane pads each batch up to the smallest of a
  small set of row counts (``shape_buckets`` / ``zoo.serving.
  shape_buckets``; powers of two up to ``batch_size`` by default) by
  repeating its last real row, so the model — and the kernels it
  launches — see only those batch shapes; the padding is sliced off
  before publish (``zoo_serving_bucket_pad_rows_total{model=}``). v2
  records are validated on the loop and copied straight into a row of a
  pooled, preallocated batch buffer by a small decode-worker pool; an
  arena stays checked out until its batch's readback.
* **The dispatch window.** Up to ``max_inflight`` batches a lane are
  dispatched with the readback deferred. A dispatch first tries a
  non-blocking permit and flushes the lane's oldest batch when the model
  is busy, then every lane's window (lanes may alias one model's
  permits) before a blocking one. With the stream empty the window
  drains, so a trickle is answered at once.
* **Admission under overload.** Above ``shed_watermark`` each read takes
  the window's overage too, up to ``_SHED_MAX_PER_READ``, and sheds it
  with ``shed: server overloaded`` (``zoo_serving_shed_total{reason=
  "depth"}``): FIFO for one lane, weighted-fair quotas across lanes.
  Records stamped with a passed ``deadline_ms`` are answered ``deadline
  exceeded`` before any dispatch, and, past ``_DOOMED_MIN_OBS`` batches,
  those the dispatch median cannot meet are shed as ``reason=
  "deadline"``. ``adaptive_batch`` drives each lane's target by AIMD
  from the publish backlog and each read's queue waits.
* **Reliability.** A crashed batch is retried one record at a time
  (``dispatch_retries``, withdrawing from an optional shared
  ``RetryBudget``); a record that keeps crashing is dead-lettered
  (``dead-lettered: dispatch crashed repeatedly``) and spilled to the
  DLQ. The publisher writes under its own breaker and spills what it
  gives up on (``result publish failed``). Both loops run under a
  supervisor that restarts them with backoff
  (``zoo_serving_loop_restarts_total{loop=}``) and, after
  ``max_loop_restarts`` crashes, gives up: ``/healthz`` reads ``down``
  with the traceback on ``/statusz``. The fault sites
  ``serving.loop``, ``serving.dispatch`` and ``serving.publish`` sit
  where the JAX server has them. The retry path retries the model call
  only: a model that raises on the host is isolated record by record,
  while an error the CUDA context keeps (an illegal address, a device
  assert) fails every retry too and opens the lane's breaker.

A bare ``KerasNet`` (``ZooModel``s included) is wrapped, as the JAX
package wraps it, in an ``InferenceModel(concurrent_num=2)`` on the
lane's serving dtype (``dtype=`` or ``zoo.serving.dtype``): float32,
bfloat16 or int8 weight-only; anything with ``predict_async`` passes
through.

Observability keeps the JAX package's names, letter for letter: the
``zoo_serving_*`` counters, gauges, histograms and p50/p95/p99 summaries
of queue wait, dispatch and end to end; the per-lane
``zoo_serving_model_*`` families; ``request`` phase events for traced
records and ``serving.*`` events and spans on the registry's sinks
(:meth:`ClusterServing.set_json_events`); ``/metrics``, ``/healthz``,
``/statusz`` (with the ``overload`` block and a ``models`` row per lane)
and ``POST /profilez`` (:meth:`serve_metrics`), which ``python -m
analytics_zoo_tpu_torch.serving.status`` reads. With
``zoo.goodput.enabled`` the loop attributes its wall clock to ``idle``,
``shed``, ``host_decode``, ``device_dispatch`` and ``publish``.

**Fleet.** Replicas scale out on one stream, on ``LocalBackend`` in one
process or on ``RedisBackend`` across processes and hosts. Each joins
the stream's consumer group under a unique ``consumer_name``: a read
delivers an entry to one replica, which acks it only once its outcome
landed (a result, an error answer, a shed answer or a DLQ spill). A
replica that dies between read and publish loses nothing: a survivor's
reclaim sweep, run ahead of each read every ``claim_sweep_s``, takes
over the dead peer's entries idle past ``claim_idle_ms``
(``zoo_serving_reclaimed_total{from=}``, ``serving.reclaim`` events) and
serves them again; an entry delivered more than ``max_deliveries`` times
is dead-lettered. Reclaimed entries report no queue wait. Each replica
heartbeats its mode, depth, pending entries, saturation, utilization
and scrape endpoint into the fleet registry (``serving/fleet.py``) from
a thread of its own that touches no device: ``start()`` registers, then
refuses a stream a live peer serves in another mode; producers read the
registry for fleet backpressure; the fleet collector finds its targets
there; ``/statusz`` carries it as the ``scaling`` block.
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import queue
import socket
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..common import faults
from ..common.reliability import (AIMDController, CircuitBreaker,
                                  RetryBudget, RetryPolicy)
from ..observability import default_registry, span
from . import fleet as fleet_lib
from .backend import LocalBackend, default_backend
from .client import (INPUT_STREAM, decode_payload, encode_array,
                     encode_tensor, is_v2, validate_v2)
from .dlq import DeadLetterQueue

log = logging.getLogger("analytics_zoo_tpu_torch.serving")

__all__ = ["ClusterServing", "HEALTH_NOT_PORTED"]

#: per-request carry-through from read to publish. ``t_enq`` is WALL
#: epoch seconds (parsed from the ``<epoch_ms>-<seq>`` entry id, the only
#: clock the producer and server share; None on a foreign id scheme);
#: ``t_deq`` is this process's ``perf_counter`` at read time (monotonic —
#: server-side phase durations must not jump on an NTP step). ``v2``
#: selects the answer's wire version, ``eid`` is the stream entry id the
#: post-settlement ack needs (None in consume-on-read mode)
_Rec = collections.namedtuple("_Rec", ("uri", "trace", "t_enq", "t_deq",
                                       "v2", "eid"))

#: a dispatched batch whose readback is deferred: ``lane`` owns the window
#: and arena pool, ``collect`` blocks on the readback, ``arena`` (may be
#: None) returns to the lane's pool after it. ``recs`` are the REAL
#: records — the batch may be bucket-padded past ``len(recs)``. ``inputs``
#: is a copy of the real rows kept only with a DLQ attached, so a publish
#: give-up can spill the original payloads
_Pending = collections.namedtuple("_Pending", ("lane", "recs", "collect",
                                               "t0", "arena", "inputs"))

#: one admitted record: the record, its raw fields, its queue wait and
#: its tensor — a validated v2 ``(payload, dtype, shape)`` header
#: (``hdr``) or, for a legacy v1 record, the decoded array (``arr``)
_Item = collections.namedtuple("_Item", ("rec", "fields", "wait", "hdr",
                                         "arr"))

_PUB_STOP = object()    # publisher-queue sentinel: drain, then exit

_CONSUMER_SEQ = itertools.count()

#: arena ceiling: a pool preallocates ``batch_size`` rows from ONE
#: validated header, so one max-size hostile record would otherwise drive
#: a batch_size-times-larger allocation; reads past it assemble by
#: ``np.stack`` (allocation proportional to the bytes received)
_MAX_ARENA_BYTES = 1 << 31

#: ceiling on EXTRA entries read a loop iteration just to be shed: the
#: loop still touches the stream and the scrape at a bounded cadence
#: under a flood; the rest sheds on the next iterations
_SHED_MAX_PER_READ = 256

#: bound on the serve loop's publisher-queue puts: a publisher wedged on
#: a stalled result store surfaces as addressable failures (and DLQ
#: spills), not as a serve loop parked on an unbounded put
_PUB_PUT_TIMEOUT_S = 30.0

#: deadline-aware admission engages only once this many batches were
#: dispatched: before that the dispatch median is ruled by the cold start
#: (here the kernels' ``nvcc`` build at their first launch, in the JAX
#: package the jit compile), and refused records add no observations, so
#: an inflated estimate would refuse deadline traffic for good
_DOOMED_MIN_OBS = 16

#: while any lane has work in flight the read is a 1 ms poll, so records
#: that arrive during a device step join the next dispatch (0 would mean
#: "block forever" to a Redis XREAD)
_BUSY_POLL_MS = 1

#: serving dtype paths for a model the server wraps (conf
#: ``zoo.serving.dtype``); models with their own predict surface carry
#: their own precision and pass through untouched
_LANE_DTYPES = ("float32", "bfloat16", "bf16", "int8")

#: the JAX server's ``/healthz`` / ``/statusz`` fields the port lacks:
#: none left, every block (``scaling`` included) has the JAX keys
HEALTH_NOT_PORTED = {"serving": (), "models": ()}


def _parse_buckets(spec, batch_size: int):
    """The lane's dispatch buckets: a sorted tuple of batch row counts,
    always topped by ``batch_size`` (a full read must fit a bucket).
    Empty/0/None = powers of two up to ``batch_size``; a comma-joined
    string or an int sequence names explicit buckets, each in
    [1, batch_size]."""
    sizes = []
    if spec:
        if isinstance(spec, str):
            sizes = [int(s) for s in spec.split(",") if s.strip()]
        elif isinstance(spec, (list, tuple)):
            sizes = [int(s) for s in spec]
        else:
            raise ValueError(f"shape_buckets must be a comma-joined "
                             f"string or int sequence, got {spec!r}")
        for s in sizes:
            if not 1 <= s <= batch_size:
                raise ValueError(
                    f"shape bucket {s} outside [1, batch_size={batch_size}]")
    if not sizes:
        b = 1
        while b < batch_size:
            sizes.append(b)
            b *= 2
    sizes.append(batch_size)
    return tuple(sorted(set(sizes)))


def _parse_lane_overrides(spec, what: str):
    """Per-lane integer overrides out of a ``"lane:value,lane:value"``
    conf string (or a ``{lane: value}`` mapping) — the
    ``zoo.serving.lane_max_inflight`` / ``lane_batch_size`` form. Empty
    spec = no overrides."""
    if not spec:
        return {}
    if isinstance(spec, dict):
        return {str(k): int(v) for k, v in spec.items()}
    if not isinstance(spec, str):
        raise ValueError(f"{what} must be a 'lane:value' comma-joined "
                         f"string or a mapping, got {spec!r}")
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, val = part.rpartition(":")
        if not sep or not name.strip():
            raise ValueError(f"{what}: entry {part!r} is not 'lane:value'")
        out[name.strip()] = int(val)
    return out


class _ArenaPool:
    """Reusable preallocated batch buffers keyed by (shape, dtype). A
    buffer stays checked out for its whole dispatch and returns after
    the readback. Doubly bounded: at most ``cap`` free buffers a key and
    ``max_bytes`` in all (least recently used shapes evicted first)."""

    def __init__(self, batch_size: int, cap: int = 4,
                 max_bytes: int = None):
        self.batch_size = int(batch_size)
        self.cap = int(cap)
        self.max_bytes = (_MAX_ARENA_BYTES if max_bytes is None
                          else int(max_bytes))
        self._free: "collections.OrderedDict[Tuple, List[np.ndarray]]" \
            = collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    def acquire(self, shape: Tuple[int, ...], dtype) -> np.ndarray:
        key = (tuple(shape), np.dtype(dtype).str)
        with self._lock:
            free = self._free.get(key)
            if free:
                arena = free.pop()
                self._bytes -= arena.nbytes
                if free:
                    self._free.move_to_end(key)
                else:
                    del self._free[key]
                return arena
        return np.empty((self.batch_size,) + tuple(shape), np.dtype(dtype))

    def release(self, arena: Optional[np.ndarray]) -> None:
        if arena is None:
            return
        key = (arena.shape[1:], arena.dtype.str)
        with self._lock:
            free = self._free.setdefault(key, [])
            if len(free) >= self.cap:
                return
            free.append(arena)
            self._bytes += arena.nbytes
            self._free.move_to_end(key)
            while self._bytes > self.max_bytes:
                k, lst = next(iter(self._free.items()))
                self._bytes -= lst.pop().nbytes
                if not lst:
                    del self._free[k]


class _Lane:
    """One model's serving lane: the admitted-record buffer, the dispatch
    window (``pendings``), pooled batch arenas, the AIMD batch target,
    the dispatch circuit breaker and the per-model accounting behind
    ``/statusz``'s ``models`` block."""

    def __init__(self, name: str, model, weight: float, dtype: str,
                 buckets, batch_size: int, max_inflight: int,
                 batch_ctl: Optional[AIMDController],
                 breaker: Optional[CircuitBreaker], metrics,
                 initial_target: int):
        self.name = name
        self.model = model
        self.weight = float(weight)
        if self.weight <= 0:
            raise ValueError(f"lane {name!r}: admission weight must be > 0")
        self.dtype = dtype or "float32"
        #: per-lane ceilings: a big model's lane caps its dispatch size
        #: and window so it cannot starve the lanes beside it
        self.batch_size = int(batch_size)
        if self.batch_size < 1:
            raise ValueError(f"lane {name!r}: batch_size must be >= 1")
        self.max_inflight = max(int(max_inflight), 1)
        # the shared ladder capped to this lane's ceiling
        self.buckets = tuple(sorted({min(b, self.batch_size)
                                     for b in buckets}))
        self.pendings: "collections.deque[_Pending]" = collections.deque()
        self.buffer: "collections.deque[_Item]" = collections.deque()
        self.arena_pool = _ArenaPool(self.batch_size,
                                     cap=self.max_inflight + 2)
        self.batch_ctl = batch_ctl if batch_ctl is not None \
            else AIMDController(floor=1, ceiling=self.batch_size)
        #: guards THIS model's dispatches; the default threshold sits
        #: above the poison-isolation retries, so one poison batch never
        #: trips a healthy model's lane
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            name=f"serving.dispatch.{name}", failure_threshold=16,
            reset_timeout=2.0, registry=metrics)
        self.last_read_waits: List[float] = []
        self.dispatches = 0      # assembled batches (bucket hit-rate base)
        self.bucket_hits = 0     # assembled with no padding rows
        labels = {"model": name}
        self.m_records = metrics.counter(
            "zoo_serving_model_records_total",
            "records answered with a prediction, per model lane",
            labels=labels)
        self.m_dispatches = metrics.counter(
            "zoo_serving_model_dispatches_total",
            "batches dispatched to the device, per model lane",
            labels=labels)
        self.m_pad_rows = metrics.counter(
            "zoo_serving_bucket_pad_rows_total",
            "padding rows added to reach a compiled bucket shape "
            "(sliced off before publish, never answered), per model lane",
            labels=labels)
        self.m_target = metrics.gauge(
            "zoo_serving_model_batch_target",
            "per-model adaptive batch target (AIMD; equals batch_size "
            "when adaptive_batch is off)", labels=labels)
        self.m_target.set(initial_target)

    def bucket_for(self, k: int) -> int:
        """The smallest bucket holding ``k`` rows."""
        for b in self.buckets:
            if b >= k:
                return b
        return self.buckets[-1]

    def bucket_hit_rate(self) -> Optional[float]:
        """Share of assembled batches that needed no padding rows; None
        before the first dispatch."""
        if not self.dispatches:
            return None
        return self.bucket_hits / self.dispatches


class ClusterServing:
    """Owns the serve loop: read → routed, bucketed batches → result
    writes. ``model`` is one model (anything with ``predict_async`` like
    :class:`InferenceModel`, a bare ``KerasNet``, or a plain ``predict``)
    or ``{name: model | spec}``."""

    def __init__(self, model, backend: Optional[LocalBackend] = None,
                 batch_size: int = 32, stream: str = INPUT_STREAM,
                 block_ms: int = 50, registry=None, decode_workers: int = 2,
                 max_inflight: int = 2, publish_queue: int = 8,
                 max_loop_restarts: int = 5,
                 restart_backoff: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 dispatch_retries: int = 1,
                 retry_budget: Optional[RetryBudget] = None,
                 shed_watermark: Optional[int] = None,
                 adaptive_batch: Optional[bool] = None,
                 queue_wait_target_s: Optional[float] = None,
                 batch_controller: Optional[AIMDController] = None,
                 weights: Optional[Dict[str, float]] = None,
                 dtype: Optional[str] = None,
                 shape_buckets=None,
                 dispatch_breakers: Optional[Dict[str,
                                                  CircuitBreaker]] = None,
                 publish_breaker: Optional[CircuitBreaker] = None,
                 dlq: Optional[DeadLetterQueue] = None,
                 dlq_dir: Optional[str] = None,
                 consumer_group: Optional[str] = None,
                 consumer_name: Optional[str] = None,
                 claim_idle_ms: Optional[float] = None,
                 claim_sweep_s: Optional[float] = None,
                 max_deliveries: Optional[int] = None,
                 heartbeat_s: float = 1.0,
                 fleet_ttl_s: float = fleet_lib.DEFAULT_TTL_S):
        self.backend = backend if backend is not None else default_backend()
        self.batch_size = int(batch_size)
        self.stream = stream
        self.block_ms = int(block_ms)
        #: decode workers for batch assembly (0 = inline on the loop);
        #: they touch numpy only — v1 decodes and arena memcpys, which
        #: release the GIL
        self.decode_workers = max(int(decode_workers), 0)
        self.max_inflight = max(int(max_inflight), 1)
        self._pub_maxsize = max(int(publish_queue), 1)
        self._pub_queue: Optional["queue.Queue"] = None
        self._pub_thread: Optional[threading.Thread] = None
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.served = 0
        self._batches = 0
        self.metrics = registry if registry is not None else default_registry()
        m = self.metrics
        self._m_records = m.counter(
            "zoo_serving_records_total", "records answered with a prediction")
        self._m_batches = m.counter(
            "zoo_serving_batches_total", "batches published")
        self._m_undecodable = m.counter(
            "zoo_serving_undecodable_total",
            "records dropped with an undecodable-payload error")
        self._m_failures = m.counter(
            "zoo_serving_failures_total",
            "records answered with a failure error, all kinds (see "
            "zoo_serving_failure_errors_total for the breakdown)")
        self._m_depth = m.gauge(
            "zoo_serving_stream_depth", "input-stream backlog after a read")
        self._m_backlog = m.gauge(
            "zoo_serving_publish_backlog",
            "batches queued for the async publisher (encode + result "
            "writes pending)")
        self._m_batch_size = m.histogram(
            "zoo_serving_batch_size", "records per published batch")
        self._m_queue_wait = m.histogram(
            "zoo_serving_queue_wait_seconds",
            "enqueue to read-off-the-stream wait per record")
        self._m_decode = m.histogram(
            "zoo_serving_decode_seconds",
            "payload decode + batch assembly wall time per read "
            "(across all decode workers)")
        self._m_encode = m.histogram(
            "zoo_serving_encode_seconds",
            "result encode wall time per published batch (publisher "
            "thread)")
        self._m_dispatch = m.histogram(
            "zoo_serving_dispatch_seconds",
            "dispatch to publish latency per batch")
        self._m_skew = m.counter(
            "zoo_serving_clock_skew_total",
            "queue-wait observations clamped to zero because the client "
            "clock ran ahead of the server's")
        # quantile digests beside the histograms: the octave buckets keep
        # the shape, the summaries answer "what IS p99" closely enough to
        # hold an SLO against (and merge across replicas)
        self._q_queue_wait = m.summary(
            "zoo_serving_queue_wait_quantiles_seconds",
            "queue-wait p50/p95/p99 per record (quantile digest)")
        self._q_dispatch = m.summary(
            "zoo_serving_dispatch_quantiles_seconds",
            "dispatch to publish p50/p95/p99 per batch (quantile digest)")
        self._q_e2e = m.summary(
            "zoo_serving_e2e_quantiles_seconds",
            "enqueue to publish end-to-end p50/p95/p99 per record "
            "(quantile digest)")
        self._last_flush_wall = None   # epoch s of the newest publish
        self._events = None            # JsonEventSink (set_json_events)
        self._summary = None           # InferenceSummary role (TB scalars)
        self._t_last_flush: Optional[float] = None
        self._scrape = None            # ScrapeServer (serve_metrics)
        self._profiler = None          # ProfilerTrigger (serve_metrics)
        # -- reliability --------------------------------------------------
        #: crashes each supervised loop survives a start() before the
        #: supervisor gives up and /healthz reads down
        self.max_loop_restarts = max(int(max_loop_restarts), 0)
        self._restart_policy = restart_backoff if restart_backoff \
            is not None else RetryPolicy(
                max_attempts=self.max_loop_restarts + 1,
                base_delay=0.05, max_delay=1.0)
        #: guards the loop's backend reads: consecutive transport failures
        #: open it, so a down backend gets probes, not a poll storm
        self._breaker = breaker if breaker is not None else CircuitBreaker(
            name="serving.backend", failure_threshold=3, reset_timeout=1.0,
            registry=m)
        #: solo re-dispatches per record after its batch crashed (0 =
        #: fail the whole batch); beyond this the record is dead-lettered
        self.dispatch_retries = max(int(dispatch_retries), 0)
        #: optional SHARED budget: solo re-dispatches withdraw, successful
        #: dispatches deposit
        self._retry_budget = retry_budget
        self._m_restarts = {
            name: m.counter(
                "zoo_serving_loop_restarts_total",
                "supervised loop restarts after an escaped exception",
                labels={"loop": name})
            for name in ("serve", "publish")}
        self._m_deadline = m.counter(
            "zoo_serving_deadline_exceeded_total",
            "records answered with a deadline-exceeded error before "
            "dispatch")
        self._m_dead_letter = m.counter(
            "zoo_serving_dead_letter_total",
            "records dead-lettered after repeated dispatch crashes")
        self._crash_info: Dict[str, str] = {}   # loop -> last traceback
        self._loop_down: set = set()            # loops the supervisor gave up
        # -- overload -----------------------------------------------------
        #: stream-depth watermark: >0 sheds the newest remainder of each
        #: admission window once the backlog exceeds it (0 = off)
        self.shed_watermark = int(self._conf("zoo.serving.shed_watermark", 0)
                                  if shed_watermark is None
                                  else shed_watermark)
        self._m_shed = {
            reason: m.counter(
                "zoo_serving_shed_total",
                "records shed by admission control, by reason: depth = "
                "backlog above the watermark, deadline = cannot meet its "
                "producer-stamped deadline",
                labels={"reason": reason})
            for reason in ("depth", "deadline")}
        # goodput attribution: the loop notes its read / shed / route /
        # pump seams so every second of its wall clock lands in exactly
        # one category
        from ..observability.goodput import GoodputLedger, goodput_enabled
        self._goodput = (GoodputLedger("serve", registry=m)
                         if goodput_enabled() else None)
        #: AIMD batch-size control, off by default: ``batch_size`` is the
        #: ceiling, the publish backlog and queue waits drive the target
        self.adaptive_batch = bool(
            self._conf("zoo.serving.adaptive_batch", False)
            if adaptive_batch is None else adaptive_batch)
        self.queue_wait_target_s = float(
            self._conf("zoo.serving.queue_wait_target_ms", 500) / 1000.0
            if queue_wait_target_s is None else queue_wait_target_s)
        # -- lanes --------------------------------------------------------
        self.dtype = str(self._conf("zoo.serving.dtype", "float32")
                         if dtype is None else dtype)
        if self.dtype not in _LANE_DTYPES:
            raise ValueError(f"unknown serving dtype {self.dtype!r}; "
                             f"use one of {_LANE_DTYPES}")
        #: dispatch buckets shared by every lane (conf
        #: ``zoo.serving.shape_buckets``; "" = powers of two)
        self.shape_buckets = _parse_buckets(
            self._conf("zoo.serving.shape_buckets", "")
            if shape_buckets is None else shape_buckets, self.batch_size)
        specs = (model if isinstance(model, dict) else {"default": model})
        if not specs:
            raise ValueError("ClusterServing needs at least one model")
        names = sorted(str(n) for n in specs)
        weights = dict(weights or {})
        dispatch_breakers = dict(dispatch_breakers or {})
        for param, keys in (("weights", weights),
                            ("dispatch_breakers", dispatch_breakers)):
            unknown = set(keys) - set(names)
            if unknown:
                # a typo would silently flatten the intended admission
                # ratio (or swap in the default breaker)
                raise ValueError(
                    f"{param} names unknown lane(s) {sorted(unknown)}; "
                    f"configured lanes: {names}")
        # conf overrides win over lane-spec entries; both sit under the
        # server-wide values
        lane_inflight = _parse_lane_overrides(
            self._conf("zoo.serving.lane_max_inflight", ""),
            "zoo.serving.lane_max_inflight")
        lane_batch = _parse_lane_overrides(
            self._conf("zoo.serving.lane_batch_size", ""),
            "zoo.serving.lane_batch_size")
        for key, overrides in (
                ("zoo.serving.lane_max_inflight", lane_inflight),
                ("zoo.serving.lane_batch_size", lane_batch)):
            unknown = set(overrides) - set(names)
            if unknown:
                # conf is process-global (another server may own those
                # lanes): warn, don't refuse
                log.warning("%s names lane(s) %s not configured on this "
                            "server (lanes: %s) — ignored here", key,
                            sorted(unknown), names)
        self._lanes: "collections.OrderedDict[str, _Lane]" = \
            collections.OrderedDict()
        for i, (name, spec) in enumerate(specs.items()):
            name = str(name)
            if not name:
                raise ValueError("lane names must be non-empty strings")
            opts = dict(spec) if isinstance(spec, dict) else {"model": spec}
            if "model" not in opts:
                raise ValueError(f"lane {name!r}: spec dict needs a "
                                 f"'model' entry")
            lane_dtype = str(opts.get("dtype") or self.dtype)
            if lane_dtype not in _LANE_DTYPES:
                raise ValueError(f"lane {name!r}: unknown dtype "
                                 f"{lane_dtype!r}; use one of {_LANE_DTYPES}")
            lane_bs = int(lane_batch.get(
                name, opts.get("batch_size", self.batch_size)))
            lane_mi = int(lane_inflight.get(
                name, opts.get("max_inflight", self.max_inflight)))
            if not 1 <= lane_bs <= self.batch_size:
                raise ValueError(
                    f"lane {name!r}: batch_size ceiling {lane_bs} outside "
                    f"[1, batch_size={self.batch_size}]")
            if not 1 <= lane_mi <= self.max_inflight:
                raise ValueError(
                    f"lane {name!r}: max_inflight {lane_mi} outside "
                    f"[1, max_inflight={self.max_inflight}]")
            self._lanes[name] = _Lane(
                name=name,
                model=self._wrap_model(opts["model"], lane_dtype),
                weight=weights.get(name, opts.get("weight", 1.0)),
                dtype=lane_dtype,
                buckets=self.shape_buckets,
                batch_size=lane_bs,
                max_inflight=lane_mi,
                # ``batch_controller`` names the primary lane's
                batch_ctl=(batch_controller if i == 0 else None),
                breaker=dispatch_breakers.get(name),
                metrics=m,
                initial_target=lane_bs)
        #: the primary lane: takes records without a ``model`` field
        self._primary = next(iter(self._lanes))
        primary = self._lanes[self._primary]
        self.model = primary.model
        self._batch_ctl = primary.batch_ctl
        self._m_batch_target = m.gauge(
            "zoo_serving_batch_size_target",
            "adaptive per-read batch target of the primary lane (AIMD; "
            "equals batch_size when adaptive_batch is off; per-lane "
            "targets in zoo_serving_model_batch_target)")
        self._m_batch_target.set(self._batch_ctl.value if self.adaptive_batch
                                 else self.batch_size)
        for lane in self._lanes.values():
            lane.m_target.set(lane.batch_ctl.value if self.adaptive_batch
                              else self.batch_size)
        #: guards publisher writes: repeated failures trip it, so an
        #: outage fast-fails to the DLQ instead of a write timeout a batch
        self._pub_breaker = publish_breaker if publish_breaker is not None \
            else CircuitBreaker(name="serving.publish", failure_threshold=3,
                                reset_timeout=5.0, registry=m)
        #: durable dead letters (dispatch poison, publish give-up)
        if dlq is not None:
            self._dlq: Optional[DeadLetterQueue] = dlq
        else:
            if dlq_dir is None:
                dlq_dir = str(self._conf("zoo.serving.dlq_dir", "") or "")
            self._dlq = DeadLetterQueue(
                dlq_dir,
                max_bytes=int(self._conf("zoo.serving.dlq_max_bytes",
                                         64 << 20)),
                registry=m) if dlq_dir else None
        # -- consumer group -----------------------------------------------
        #: the group this server consumes under; "" = consume-on-read
        if consumer_group is None:
            consumer_group = str(self._conf("zoo.serving.consumer_group",
                                            "serving"))
        self.consumer_group = consumer_group
        self._group_mode = bool(consumer_group) and all(
            hasattr(self.backend, meth)
            for meth in ("xgroup_create", "xreadgroup", "xack",
                         "xautoclaim"))
        if consumer_group and not self._group_mode:
            log.info("backend %s has no consumer-group surface; serving "
                     "in legacy single-consumer mode",
                     type(self.backend).__name__)
        #: this replica's identity in the group and the fleet registry,
        #: stable across supervisor restarts
        self.consumer_name = consumer_name if consumer_name else (
            f"{socket.gethostname()}-{os.getpid()}-{next(_CONSUMER_SEQ)}")
        #: pending entries idle past this are reclaimable by a survivor
        self.claim_idle_ms = float(
            self._conf("zoo.serving.claim_idle_ms", 30000)
            if claim_idle_ms is None else claim_idle_ms)
        if self.claim_idle_ms <= 0:
            raise ValueError("claim_idle_ms must be > 0")
        #: the reclaim sweep's cadence: half the idle threshold by
        #: default, so a dead peer's entries wait at most ~1.5x
        #: claim_idle_ms
        self.claim_sweep_s = float(
            max(self.claim_idle_ms / 2000.0, 0.01)
            if claim_sweep_s is None else claim_sweep_s)
        #: an entry delivered (read + reclaims) more than this many times
        #: is poison hopping replica to replica: dead-lettered
        self.max_deliveries = int(
            self._conf("zoo.serving.max_deliveries", 5)
            if max_deliveries is None else max_deliveries)
        self.heartbeat_s = float(heartbeat_s)
        self.fleet_ttl_s = float(fleet_ttl_s)
        self._m_acks = m.counter(
            "zoo_serving_acks_total",
            "stream entries acked (settled) out of the consumer group's "
            "pending-entries set")
        self._m_pending = m.gauge(
            "zoo_serving_pending_entries",
            "entries delivered to THIS consumer and not yet acked")
        self._m_util = m.gauge(
            "zoo_serving_utilization",
            "busy-dispatch fraction of the serve loop between heartbeats "
            "(0 = idle poll, 1 = saturated) — the autoscaler signal")
        self._last_sweep = 0.0
        self._last_hb = 0.0
        self._busy_s = 0.0
        self._util_anchors: Dict[str, Tuple[float, float]] = {}
        self._killed = False

    @property
    def _mode(self) -> str:
        """The fleet registry's mode string, which the mode guard
        compares: ``group:<name>`` or ``single``."""
        return (f"group:{self.consumer_group}" if self._group_mode
                else "single")

    @staticmethod
    def _conf(key: str, default):
        from ..common.context import get_zoo_context
        return get_zoo_context().get(key, default)

    @staticmethod
    def _wrap_model(model, dtype: str):
        """The int8/bf16 serving wiring: a bare ``KerasNet`` (a layer graph
        with ``apply`` and its own weights, ``ZooModel``s included) is
        wrapped in an ``InferenceModel`` on its own device and the serving
        dtype — ``"int8"`` loads the int8 weight-only path (int8 weights on
        the device, fp32 activations and fp32 results on the wire).
        Anything already exposing ``predict_async`` carries its own
        precision and passes through, as does any other object with only a
        ``predict``. (The port's ``KerasNet`` has a ``predict`` of its own,
        so the test is the class, not the absence of ``predict_async``.)"""
        if hasattr(model, "predict_async"):
            return model
        from ..pipeline.api.keras.engine import KerasNet
        if isinstance(model, KerasNet):
            from ..pipeline.inference import InferenceModel
            im = InferenceModel(concurrent_num=2,
                                device=getattr(model, "device", None))
            if dtype == "int8":
                return im.from_keras(model, quantize="int8")
            if dtype in ("bfloat16", "bf16"):
                return im.from_keras(model, dtype="bfloat16")
            return im.from_keras(model)
        return model

    def _lane_target(self, lane: _Lane) -> int:
        """The lane's per-dispatch batch target, capped by its ceiling."""
        target = (lane.batch_ctl.value if self.adaptive_batch
                  else self.batch_size)
        return min(target, lane.batch_size)

    def _lane_name(self, fields) -> Optional[str]:
        """The lane a record's ``model`` field routes it to; no field →
        the primary lane; an unconfigured name → None."""
        name = fields.get("model")
        if not name:
            return self._primary
        name = str(name)
        return name if name in self._lanes else None

    # -- observability surface ----------------------------------------------
    def set_tensorboard(self, log_dir: str,
                        app_name: str = "serving") -> "ClusterServing":
        """Write per-batch "Serving Throughput" / "Serving Records" scalars
        to ``<log_dir>/<app_name>`` (``ClusterServing.scala:291-317`` +
        ``InferenceSummary.scala``). Call before ``start()``: swapping the
        writer under a running publisher would race its bookkeeping on
        the closed file."""
        from ..utils.tensorboard import EventFileWriter
        if self._thread is not None:    # start()'s double-start guard
            raise RuntimeError(
                "serving already started; call set_tensorboard() before "
                "start() (or after stop())")
        if self._summary is not None:   # redirecting: release the old file
            self._summary.close()
        self._summary = EventFileWriter(os.path.join(log_dir, app_name))
        return self

    def set_json_events(self, path: str) -> "ClusterServing":
        """Log one structured JSON event per published batch / error record
        and, for every traced record, its phase events to ``path`` (JSON
        lines). The sink is attached to this server's registry, so spans
        emit there too. Call before ``start()``."""
        from ..observability import JsonEventSink
        if self._thread is not None:
            raise RuntimeError(
                "serving already started; call set_json_events() before "
                "start() (or after stop())")
        if self._events is not None:
            self.metrics.remove_event_sink(self._events)
            self._events.close()
        self._events = JsonEventSink(path)
        self.metrics.add_event_sink(self._events)
        return self

    def serve_metrics(self, port: int = 0, host: str = "127.0.0.1"):
        """Mount the observability HTTP endpoint over this server's
        registry — ``/metrics`` (Prometheus exposition), ``/healthz``
        (liveness + serve-loop state), ``/statusz`` (operator page:
        uptime, stream depth, last-flush age, the ``overload`` block and
        the per-lane ``models`` rows, device info and memory, the goodput
        ``performance`` block) and ``POST /profilez`` (arm a bounded
        ``torch.profiler`` capture of this process). Returns the
        :class:`ScrapeServer` (bound port on ``.port``); closed by
        :meth:`stop`. ``host="0.0.0.0"`` exposes it to an off-host
        scraper (the default binds loopback only)."""
        from ..observability import ProfilerTrigger, ScrapeServer
        if self._scrape is not None:
            self._scrape.close()
        if self._profiler is None:
            self._profiler = ProfilerTrigger(registry=self.metrics)
        self._scrape = ScrapeServer(self.metrics, port=port, host=host,
                                    health_fn=self._health_info,
                                    profiler=self._profiler)
        return self._scrape

    def _health_info(self) -> dict:
        """Serve-loop introspection for /healthz and /statusz. Runs on
        the scrape thread: reads only cheap fields and the backend's
        backlog (its lock is held per operation, never across a
        dispatch). A loop the supervisor gave up on flips the payload's
        ``status`` to ``down``, with its last traceback. Shedding and
        dead letters are degradation, not failure: they show in the
        ``overload`` block while the status stays up."""
        age = (None if self._last_flush_wall is None
               else max(time.time() - self._last_flush_wall, 0.0))
        thread = self._thread
        pub = self._pub_queue
        try:
            if self._group_mode and hasattr(self.backend, "backlog_len"):
                depth = self.backend.backlog_len(self.stream,
                                                 self.consumer_group)
            else:
                depth = self.backend.stream_len(self.stream)
        except Exception as e:      # a dead backend must not 500 /healthz
            depth = None
            log.debug("stream depth failed on the scrape thread: %s", e)
        down = sorted(self._loop_down)
        info = {"serving": {
            "running": (thread is not None and thread.is_alive()
                        and "serve" not in self._loop_down),
            "stream_depth": depth,
            "served": self.served,
            "batches": self._batches,
            "publish_backlog": 0 if pub is None else pub.qsize(),
            "last_flush_age_s": age,
            "backend_breaker": self._breaker.state,
            "loops_down": down,
        }}
        overload = {
            "stream_depth": depth,
            "shed_watermark": self.shed_watermark,
            "shed_depth_total": self._m_shed["depth"].value,
            "shed_deadline_total": self._m_shed["deadline"].value,
            "adaptive_batch": self.adaptive_batch,
            "batch_size_target": (self._batch_ctl.value
                                  if self.adaptive_batch
                                  else self.batch_size),
            "publish_breaker": self._pub_breaker.state,
        }
        if self._dlq is not None:
            overload["dlq_records"] = self._dlq._m_records.value
            overload["dlq_bytes"] = self._dlq._m_bytes.value
        info["serving"]["overload"] = overload
        # the autoscaler's block: this replica's backlog view, its own
        # in-flight pending entries and the busy-dispatch fraction since
        # the last scrape
        info["serving"]["scaling"] = {
            "consumer": self.consumer_name,
            "group": self.consumer_group if self._group_mode else None,
            "stream_depth": depth,
            "pending_entries": self._own_pending(),
            "utilization": round(self._utilization("health"), 4),
            "batch_size_target": overload["batch_size_target"],
            "goodput": (None if self._goodput is None
                        or self._goodput.wall() <= 0
                        else round(self._goodput.ratio(), 4)),
        }
        models = {}
        for name, lane in self._lanes.items():
            hit = lane.bucket_hit_rate()
            models[name] = {
                "weight": lane.weight,
                "dtype": lane.dtype,
                "batch_target": self._lane_target(lane),
                "batch_ceiling": lane.batch_size,
                "max_inflight": lane.max_inflight,
                "buckets": list(lane.buckets),
                "bucket_hit_rate": None if hit is None else round(hit, 4),
                "breaker": lane.breaker.state,
                "records": lane.m_records.value,
                "pad_rows": lane.m_pad_rows.value,
                "buffered": len(lane.buffer),
                "inflight": len(lane.pendings),
            }
        info["serving"]["models"] = models
        if self._crash_info:
            info["serving"]["last_crash"] = dict(self._crash_info)
        if down:
            info["status"] = "down"
        return info

    def _own_pending(self) -> Optional[int]:
        """This consumer's pending-entry count (delivered, unacked); None
        in consume-on-read mode or when the backend cannot answer."""
        if not self._group_mode:
            return None
        try:
            return int(self.backend.xpending(
                self.stream, self.consumer_group).get(self.consumer_name, 0))
        except Exception as e:
            log.debug("xpending failed: %s", e)
            return None

    def _utilization(self, anchor: str) -> float:
        """Busy-dispatch fraction of the serve loop since this anchor's
        last reading (the ``/statusz`` scrapes and the heartbeats each
        keep their own window). The loop adds to ``_busy_s`` everything
        it does between blocking reads."""
        now = time.perf_counter()
        busy = self._busy_s
        prev = self._util_anchors.get(anchor)
        self._util_anchors[anchor] = (now, busy)
        if prev is None or now - prev[0] <= 1e-6:
            return 0.0
        return min(max((busy - prev[1]) / (now - prev[0]), 0.0), 1.0)

    def _heartbeat_loop(self) -> None:
        """The heartbeat thread: keeps this replica's registry entry
        fresh while the serve loop sits in a long dispatch (the loop also
        beats each iteration; ``_last_hb`` bounds the combined cadence).
        It touches the backend only, never the device. Exits with
        ``_stop``; a kill flips ``_killed`` first, so the corpse stops
        beating at once."""
        while not self._stop.wait(self.heartbeat_s):
            try:
                self._heartbeat()
            except Exception as e:
                log.debug("background heartbeat failed: %s", e)

    def _heartbeat(self, force: bool = False) -> None:
        """Publish this replica's state into the fleet registry (at most
        once a ``heartbeat_s``) and refresh the pending and utilization
        gauges. The loop and the heartbeat thread both call it;
        ``_hb_lock`` keeps two beats from passing the cadence check
        together (the second would read the utilization anchor the first
        just wrote and publish 0.0 for a busy replica). Failures log and
        drop."""
        if self._killed:
            return      # a corpse must not refresh its own heartbeat
        with self._hb_lock:
            now = time.monotonic()
            if not force and now - self._last_hb < self.heartbeat_s:
                return
            self._last_hb = now
            self._publish_heartbeat()

    def _publish_heartbeat(self) -> None:
        """One registry write and gauge refresh; the caller holds
        ``_hb_lock`` and passed the cadence check."""
        try:
            depth = self._stream_depth()
        except Exception:
            depth = 0
        pending = self._own_pending()
        if pending is not None:
            self._m_pending.set(pending)
        util = self._utilization("heartbeat")
        self._m_util.set(util)
        fleet_lib.publish_member(self.backend, self.stream,
                                 self.consumer_name, {
            "mode": self._mode,
            "depth": depth,
            "pending": pending,
            "watermark": self.shed_watermark,
            # the replica's own saturation verdict, which fleet
            # backpressure aggregates: live work is the backlog plus its
            # own in-flight (delivered, unacked) entries
            "saturated": bool(self.shed_watermark > 0
                              and depth + (pending or 0)
                              > self.shed_watermark),
            "utilization": round(util, 4),
            "batch_target": (self._batch_ctl.value if self.adaptive_batch
                             else self.batch_size),
            # the scrape address (serve_metrics), where the fleet
            # collector finds its targets; None until mounted
            "endpoint": (f"{self._scrape.host}:{self._scrape.port}"
                         if self._scrape is not None else None),
        })

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ClusterServing":
        if self._thread is not None:
            raise RuntimeError("serving already started")
        self._killed = False
        self._busy_s = 0.0
        self._util_anchors = {}
        self._last_hb = 0.0
        # the mixed-mode guard, before the first read can take an entry
        # out from under the other mode's accounting. Register first,
        # then check: two incompatible replicas starting together then
        # see at least one of each other and refuse; the loser
        # deregisters so it does not haunt the registry for a TTL
        self._heartbeat(force=True)     # registration: mode + first state
        try:
            fleet_lib.check_mode_conflict(self.backend, self.stream,
                                          self.consumer_name, self._mode,
                                          ttl_s=self.fleet_ttl_s)
            if self._group_mode:
                try:
                    self.backend.xgroup_create(self.stream,
                                               self.consumer_group)
                except (ConnectionError, OSError) as e:
                    raise RuntimeError(
                        f"cannot create consumer group "
                        f"{self.consumer_group!r} on stream "
                        f"{self.stream!r}: {e}") from e
        except Exception:
            fleet_lib.remove_member(self.backend, self.stream,
                                    self.consumer_name)
            raise
        self._stop.clear()
        self._crash_info = {}
        self._loop_down = set()
        if self.decode_workers > 0:
            self._pool = ThreadPoolExecutor(
                max_workers=self.decode_workers,
                thread_name_prefix="serving-decode")
        self._pub_queue = queue.Queue(maxsize=self._pub_maxsize)
        self._pub_thread = threading.Thread(
            target=self._supervised, args=("publish", self._publisher_loop),
            daemon=True, name="cluster-serving-publish")
        self._pub_thread.start()
        self._thread = threading.Thread(
            target=self._supervised, args=("serve", self._loop),
            daemon=True, name="cluster-serving")
        self._thread.start()
        # liveness must not ride the serve loop's progress: a first
        # dispatch (the kernels' build) or a long one would age the
        # heartbeat past the TTL, and peers would take a busy replica
        # for dead
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name="cluster-serving-heartbeat")
        self._hb_thread.start()
        return self

    def _supervised(self, name: str, body) -> None:
        """Run a loop body under restart supervision: an escaped exception
        logs, keeps its traceback for /statusz, counts in
        ``zoo_serving_loop_restarts_total{loop=name}`` and re-enters the
        body after a bounded backoff, on the same thread (a CUDA kernel
        launched there after a restart goes through ``launch``'s
        once-a-thread context rule like any other). After
        ``max_loop_restarts`` crashes the supervisor gives up: the loop
        lands in ``_loop_down`` and /healthz reads ``down``. A clean
        return (stop, the publisher's sentinel) ends supervision."""
        delays = self._restart_policy.delays()
        crashes = 0
        while True:
            try:
                body()
                return
            except Exception:
                tb = traceback.format_exc()
                # each loop writes its own key, read only for display
                self._crash_info[name] = tb
                if self._stop.is_set():
                    return              # crashed into shutdown: just exit
                crashes += 1
                self.metrics.emit("serving.loop_crash", loop=name,
                                  crashes=crashes, traceback=tb)
                if crashes > self.max_loop_restarts:
                    log.error("%s loop crashed %d times; supervisor giving "
                              "up — /healthz now reads down:\n%s",
                              name, crashes, tb)
                    self._loop_down.add(name)
                    return
                delay = next(delays, self._restart_policy.max_delay)
                log.exception("%s loop crashed (%d/%d); restarting in "
                              "%.3fs", name, crashes,
                              self.max_loop_restarts, delay)
                self._m_restarts[name].inc()
                if self._stop.wait(delay):
                    return

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the loop; with ``drain`` first wait (up to ``timeout``)
        for the stream to empty. Every batch already read is dispatched
        and published before the publisher exits, and the sinks (events,
        the scrape endpoint, a running profiler capture, the DLQ's active
        segment) close only after that. A backend that is already down
        cannot veto shutdown."""
        if self._thread is None:
            self._shutdown_workers(timeout)
            self._close_sinks()
            return
        if drain:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                try:
                    if self.backend.stream_len(self.stream) <= 0:
                        break
                except Exception as e:
                    log.warning("stop(drain=True): backend unavailable "
                                "(%s: %s); skipping the drain",
                                type(e).__name__, e)
                    break
                time.sleep(0.01)
        self._stop.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            # keep the handle: a discarded live thread would let a second
            # start() race two consumers on the same stream
            raise TimeoutError(
                f"serve loop still running after {timeout}s (model dispatch "
                f"in flight?); call stop() again to re-join")
        self._thread = None
        self._shutdown_workers(timeout)
        self._close_sinks()
        # clean deregistration; a crash skips it and the TTL reaps the
        # stale heartbeat instead
        fleet_lib.remove_member(self.backend, self.stream,
                                self.consumer_name)

    def kill(self, join: bool = True) -> None:
        """Die like a SIGKILL: stop both loops WITHOUT settling anything —
        no drain, no publishes, no error answers, no acks, no fleet
        deregistration (the heartbeat goes stale past the TTL); in-flight
        device work is abandoned. In consumer-group mode every entry read
        but not acked stays pending under this consumer until a
        survivor's reclaim sweep takes it over. With ``join`` the threads
        are joined and the sinks closed, so the process stays clean;
        ``join=False`` only flips the switch (a test whose model still
        holds the loop releases it, then calls ``kill()`` again).
        Idempotent."""
        self._killed = True
        self._stop.set()
        if not join:
            return
        t = self._thread
        if t is not None:
            t.join(timeout=30.0)
            if t.is_alive():
                raise TimeoutError(
                    "killed serve loop still running after 30s (model "
                    "dispatch still blocked?); unblock it and call "
                    "kill() again")
            self._thread = None
        self._shutdown_workers()
        self._close_sinks()

    def _shutdown_workers(self, timeout: float = 30.0) -> None:
        """Join the decode pool and the publisher (after a
        drain-everything sentinel). Safe when neither was started."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        hb = self._hb_thread
        if hb is not None:
            hb.join(timeout=timeout)    # exits on _stop; beats are short
            self._hb_thread = None
        t, q = self._pub_thread, self._pub_queue
        if t is None:
            return
        try:
            q.put(_PUB_STOP, timeout=timeout)
        except queue.Full:
            raise TimeoutError(
                f"publisher still draining after {timeout}s (result "
                f"backend stalled?); call stop() again to re-join")
        t.join(timeout=timeout)
        if t.is_alive():
            raise TimeoutError(
                f"publisher still draining after {timeout}s (result "
                f"backend stalled?); call stop() again to re-join")
        self._pub_thread = None
        self._pub_queue = None

    def _close_sinks(self) -> None:
        if self._summary is not None:
            self._summary.close()
            self._summary = None
        if self._scrape is not None:
            self._scrape.close()
            self._scrape = None
        if self._profiler is not None:
            self._profiler.close()   # stop an in-flight capture cleanly
            self._profiler = None
        if self._events is not None:
            self.metrics.remove_event_sink(self._events)
            self._events.close()
            self._events = None
        if self._dlq is not None:
            # seal, don't discard: the active segment becomes replayable
            self._dlq.close()

    # -- the loop -----------------------------------------------------------
    def _gp_note(self, category: str) -> None:
        """Attribute wall clock since the ledger's mark to ``category``
        (no-op when goodput accounting is off)."""
        if self._goodput is not None:
            self._goodput.note(category)

    def _loop(self) -> None:
        """The continuous dispatch pipeline: per lane, up to
        ``max_inflight`` batches run on the device while the next read is
        routed and assembled. While any lane has work in flight (or
        records buffered behind a half-open probe or a restart) the read
        is a 1 ms poll, so the device idles only when the stream is
        empty. The reclaim sweep runs ahead of each read, and each
        iteration adds its time outside the blocking read to the
        utilization the heartbeat publishes."""
        lanes = self._lanes
        if self._goodput is not None:
            self._goodput.open()
        try:
            while not self._stop.is_set():
                it0 = time.perf_counter()
                idle_s = 0.0
                try:
                    faults.inject("serving.loop")
                    busy = any(lane.pendings or lane.buffer
                               for lane in lanes.values())
                    # admission window: ``want`` records are admitted
                    # (oldest first; weighted-fair across lanes under
                    # shed pressure); above the watermark the read also
                    # pulls the window's newest remainder, to shed it
                    want = sum(self._lane_target(lane)
                               for lane in lanes.values())
                    # a dead peer's entries are the oldest work there is:
                    # they take this read's admission slots first
                    reclaimed = self._reclaim_sweep()
                    buffered = sum(len(lane.buffer)
                                   for lane in lanes.values())
                    want_read = max(want - len(reclaimed) - buffered, 0)
                    extra = 0
                    if want_read > 0 and self.shed_watermark > 0 \
                            and self._breaker.state == CircuitBreaker.CLOSED:
                        # the depth probe respects the read breaker: an
                        # open backend gets its probe read only
                        overage = (self._stream_depth() - want_read
                                   - self.shed_watermark)
                        if overage > 0:
                            extra = min(overage, _SHED_MAX_PER_READ)
                    if want_read + extra > 0:
                        t_read = time.perf_counter()
                        entries = self._read_entries(
                            want_read + extra,
                            block_ms=_BUSY_POLL_MS if busy else None)
                        idle_s = time.perf_counter() - t_read
                    else:
                        entries = []
                    # read wait (and the sweep before it) is idle time:
                    # the device had nothing admitted to chew on
                    self._gp_note("idle")
                    if not entries and not reclaimed and not buffered:
                        self._drain_all()
                        self._gp_note("publish")
                        continue
                    if len(entries) > want_read:
                        entries, shed = self._admit_fair(entries, want_read)
                        self._shed(shed, reason="depth")
                        self._gp_note("shed")
                    entries = reclaimed + entries
                    # one depth probe a read feeds the gauge and the
                    # drain checks
                    depth = self._stream_depth()
                    self._m_depth.set(depth)
                    routed = self._route(entries,
                                         n_reclaimed=len(reclaimed))
                    self._gp_note("host_decode")
                    for name, items in routed.items():
                        lane = lanes[name]
                        lane.buffer.extend(items)
                        lane.last_read_waits = [
                            i.wait for i in items if i.wait is not None]
                        if self.adaptive_batch and items:
                            self._update_batch_target(lane)
                    for lane in lanes.values():
                        self._pump(lane, depth)
                    self._gp_note("device_dispatch")
                finally:
                    # everything but the blocking read counts as busy;
                    # the heartbeat publishes it (at its own cadence)
                    self._busy_s += max(
                        time.perf_counter() - it0 - idle_s, 0.0)
                    self._heartbeat()
                    # residual per-iteration overhead lands on idle, so
                    # no interval is left unattributed
                    self._gp_note("idle")
        finally:
            # clean stop or crash (the supervisor may restart us):
            # dispatch what was admitted, then flush every in-flight
            # batch; a kill abandons instead, and a failing final pump
            # must not mask the original exception
            for lane in lanes.values():
                if not self._killed:
                    try:
                        self._pump(lane, 0)
                    except Exception:
                        log.exception("final pump of lane %r failed",
                                      lane.name)
                self._drain(lane.pendings)

    def _drain(self, pendings) -> None:
        """Flush every pending batch, oldest first."""
        while pendings:
            self._flush(pendings.popleft())

    def _drain_all(self) -> None:
        """Flush every lane's dispatch window."""
        for lane in self._lanes.values():
            self._drain(lane.pendings)

    def _admit_fair(self, entries, want_read: int):
        """Split an over-watermark read into ``(admitted, shed)``. One
        lane: FIFO — the oldest ``want_read`` admitted. Several lanes:
        each keeps a quota of the window proportional to its weight
        (largest-remainder rounding, so the quotas sum to ``want_read``),
        filled oldest-first from its own records; quota a lane leaves
        unused goes to the remaining records in global FIFO order.
        Records addressed to no lane ride free (one error write)."""
        if len(self._lanes) == 1:
            return entries[:want_read], entries[want_read:]
        names = [self._lane_name(fields) for _eid, fields in entries]
        by_lane: Dict[str, List[int]] = {}
        for idx, name in enumerate(names):
            if name is not None:
                by_lane.setdefault(name, []).append(idx)
        total_w = sum(lane.weight for lane in self._lanes.values())
        shares = {n: want_read * lane.weight / total_w
                  for n, lane in self._lanes.items()}
        quota = {n: int(s) for n, s in shares.items()}
        rem = want_read - sum(quota.values())
        for n in sorted(shares, key=lambda n: (-(shares[n] - quota[n]), n)):
            if rem <= 0:
                break
            quota[n] += 1
            rem -= 1
        admitted = {idx for idx, name in enumerate(names) if name is None}
        taken = 0
        for n, idxs in by_lane.items():
            keep = idxs[:quota.get(n, 0)]
            admitted.update(keep)
            taken += len(keep)
        leftover = want_read - taken
        if leftover > 0:
            for idx, name in enumerate(names):
                if leftover <= 0:
                    break
                if name is not None and idx not in admitted:
                    admitted.add(idx)
                    leftover -= 1
        keep_list = [e for i, e in enumerate(entries) if i in admitted]
        shed_list = [e for i, e in enumerate(entries) if i not in admitted]
        return keep_list, shed_list

    def _read_entries(self, count: Optional[int] = None,
                      block_ms: Optional[int] = None):
        """One breaker-guarded read of up to ``count`` entries. Transport
        errors (``ConnectionError``/``OSError``) count against the
        breaker and read as empty; while it is open the backend is left
        alone until the next probe window. Anything else escapes to the
        supervisor."""
        if count is None:
            count = self.batch_size
        if block_ms is None:
            block_ms = self.block_ms
        if not self._breaker.allow():
            self._stop.wait(min(max(self._breaker.probe_in(), 0.001),
                                self.block_ms / 1000.0))
            return []
        try:
            if self._group_mode:
                entries = self.backend.xreadgroup(
                    self.stream, self.consumer_group, self.consumer_name,
                    count, block_ms=block_ms)
            else:
                entries = self.backend.xread(self.stream, count,
                                             block_ms=block_ms)
        except (ConnectionError, OSError) as e:
            self._breaker.record_failure()
            log.warning("input-stream read failed (%s: %s); breaker %s",
                        type(e).__name__, e, self._breaker.state)
            self.metrics.emit("serving.backend_error", op="xread",
                              error=f"{type(e).__name__}: {e}",
                              breaker=self._breaker.state)
            return []
        except Exception:
            # resolve the admitted call before the supervisor takes
            # over: a half-open probe left in flight would refuse every
            # later allow()
            self._breaker.record_failure()
            raise
        self._breaker.record_success()
        return entries

    def _stream_depth(self) -> int:
        """The undelivered backlog for the gauge, the drain checks and
        the shed overage; a transport failure reads as 0, which errs
        toward flushing and never sheds on a missing reading."""
        try:
            if self._group_mode and hasattr(self.backend, "backlog_len"):
                return self.backend.backlog_len(self.stream,
                                                self.consumer_group)
            return self.backend.stream_len(self.stream)
        except (ConnectionError, OSError) as e:
            log.debug("stream depth failed after a read: %s", e)
            return 0

    def _reclaim_sweep(self) -> List[Tuple[str, dict]]:
        """Take over pending entries whose owner went quiet
        (``claim_idle_ms``): a dead peer's reads, or this replica's own
        whose reply was lost. At most once a ``claim_sweep_s`` and
        ``batch_size`` entries. Reclaimed entries go through the normal
        pipeline, so one the dead peer had in fact answered answers again
        with the same prediction. Entries past ``max_deliveries`` are
        answered with an error and settled instead. A transport failure
        logs and waits for the next sweep."""
        if not self._group_mode:
            return []
        now = time.monotonic()
        if now - self._last_sweep < self.claim_sweep_s:
            return []
        self._last_sweep = now
        try:
            claimed = self.backend.xautoclaim(
                self.stream, self.consumer_group, self.consumer_name,
                self.claim_idle_ms, count=self.batch_size)
        except (ConnectionError, OSError) as e:
            log.warning("reclaim sweep failed (%s: %s); retrying next "
                        "interval", type(e).__name__, e)
            return []
        out: List[Tuple[str, dict]] = []
        for eid, fields, prev, deliveries in claimed:
            # from = the previous owner's consumer name: bounded by the
            # fleet's membership, not by request data
            self.metrics.counter(
                "zoo_serving_reclaimed_total",
                "pending entries taken over from an idle consumer, by "
                "previous owner",
                labels={"from": prev}).inc()
            self.metrics.emit("serving.reclaim", entry=eid,
                              uri=fields.get("uri"),
                              trace=fields.get("trace"),
                              prev_consumer=prev, deliveries=deliveries)
            if deliveries > self.max_deliveries:
                log.error("entry %s (uri=%r) delivered %d times (max "
                          "%d); dead-lettering instead of reclaiming "
                          "forever", eid, fields.get("uri"), deliveries,
                          self.max_deliveries)
                self._m_dead_letter.inc()
                self.metrics.emit("serving.dead_letter",
                                  uri=fields.get("uri"),
                                  trace=fields.get("trace"),
                                  error="exceeded max deliveries")
                self._settle_drop(
                    fields, eid,
                    error="dead-lettered: exceeded max deliveries")
                continue
            out.append((eid, fields))
        return out

    def _settle_drop(self, fields: dict, eid: Optional[str],
                     error: str) -> None:
        """Answer a record with an addressable error and ack it — the
        settlement of a record given up on at read time. The ack lands
        only once the answer did (or when there is no uri to answer): an
        unanswered drop stays pending for a later reclaim."""
        self._m_failures.inc()
        self.metrics.counter(
            "zoo_serving_failure_errors_total",
            "failed records by error kind (model vs result-store)",
            labels={"error": error}).inc()
        uri = fields.get("uri")
        if not uri:
            self._ack([eid])
            return
        try:
            self.backend.set_result(uri, {"error": error})
        except Exception:
            log.exception("error record for %r could not be written "
                          "(backend down?); entry stays pending", uri)
            return
        self._ack([eid])

    def _ack(self, eids) -> None:
        """Settle entries out of the group's pending list — only after the
        producer-visible outcome landed (a result, an error answer, a
        shed answer or a durable DLQ spill). A failed ack leaves them
        pending."""
        if not self._group_mode:
            return
        eids = [e for e in eids if e]
        if not eids:
            return
        try:
            n = self.backend.xack(self.stream, self.consumer_group, *eids)
        except Exception as e:
            log.warning("ack of %d entries failed (%s: %s); they stay "
                        "pending", len(eids), type(e).__name__, e)
            self.metrics.emit("serving.ack_failed", entries=len(eids),
                              error=f"{type(e).__name__}: {e}")
            return
        if n:
            self._m_acks.inc(n)

    # -- overload: shedding + adaptive batch ---------------------------------
    def _shed(self, entries, reason: str) -> None:
        """Answer shed records with ``shed: server overloaded`` — no
        decode, no dispatch, one batched error write for the set, before
        any trace event (a shed record leaves no dangling trace)."""
        n = len(entries)
        self._m_shed[reason].inc(n)
        self._m_failures.inc(n)
        self.metrics.counter(
            "zoo_serving_failure_errors_total",
            "failed records by error kind (model vs result-store)",
            labels={"error": "shed: server overloaded"}).inc(n)
        results = {}
        addressable_eids = []
        orphan_eids = []
        for eid, fields in entries:
            uri = fields.get("uri")
            self.metrics.emit("serving.shed", reason=reason, uri=uri,
                              trace=fields.get("trace"))
            if uri:
                results[uri] = {"error": "shed: server overloaded"}
                addressable_eids.append(eid)
            else:
                orphan_eids.append(eid)
        self._ack(orphan_eids)
        if not results:
            return
        try:
            self.backend.set_results(results)
        except Exception:
            log.exception("shed-error records for %d record(s) could not "
                          "be written (backend down?); entries stay "
                          "pending", len(results))
            return
        self._ack(addressable_eids)

    def _update_batch_target(self, lane: _Lane) -> None:
        """One AIMD step for a lane a non-empty read. Breach = the publish
        backlog above half its bound, or this read's p95 queue wait for
        the lane's records above target — a live signal, and a pure
        function of the traffic."""
        backlog = 0 if self._pub_queue is None else self._pub_queue.qsize()
        breach = backlog > self._pub_maxsize // 2
        waits = lane.last_read_waits
        if not breach and waits:
            w = sorted(waits)
            breach = w[-(-len(w) * 95 // 100) - 1] > self.queue_wait_target_s
        target = lane.batch_ctl.update(breach)
        lane.m_target.set(target)
        if lane.name == self._primary:
            self._m_batch_target.set(target)

    # -- routing + batch assembly --------------------------------------------
    def _route(self, entries, n_reclaimed: int = 0):
        """Validate one read and route each record to its lane:
        ``{lane_name: [_Item, ...]}`` in read order. The first
        ``n_reclaimed`` entries came from the reclaim sweep: they serve
        as any other but give no queue wait (``_observe_queue_wait``).
        Per record: queue wait observed, then the cheap drops — no uri, unknown ``model``,
        an expired or doomed deadline, an undecodable payload — answered
        before any trace event. v2 headers are validated here (the arena
        copy after it cannot fail); v1 payloads decode on the worker
        pool. The enqueue and dequeue phase events follow."""
        now_s = time.time()
        now_p = time.perf_counter()
        staged: List[Tuple[str, _Item]] = []
        v1_idx: List[int] = []
        for idx, (eid, fields) in enumerate(entries):
            wait, t_enq = self._observe_queue_wait(
                eid, now_s, reclaimed=idx < n_reclaimed)
            uri = fields.get("uri")
            if not uri:
                log.error("record with no uri dropped (entry id %s)", eid)
                self._drop_undecodable(fields, eid)
                continue
            lane_name = self._lane_name(fields)
            if lane_name is None:
                self._drop_unknown_model(fields, eid)
                continue
            verdict = self._deadline_verdict(fields, now_s)
            if verdict is not None:
                self._drop_expired(fields, doomed=(verdict == "doomed"),
                                   eid=eid)
                continue
            hdr = None
            if is_v2(fields):
                try:
                    hdr = validate_v2(fields)
                except Exception:
                    log.exception("undecodable record (uri=%r)", uri)
                    self._drop_undecodable(fields, eid)
                    continue
            else:
                v1_idx.append(len(staged))
            staged.append((lane_name, _Item(
                _Rec(uri, fields.get("trace"), t_enq, now_p,
                     hdr is not None, eid if self._group_mode else None),
                fields, wait, hdr, None)))
        if v1_idx:
            def decode_one(i):
                name, item = staged[i]
                try:
                    arr = np.asarray(decode_payload(item.fields))
                except Exception:
                    log.exception("undecodable record (uri=%r)",
                                  item.rec.uri)
                    self._drop_undecodable(item.fields, item.rec.eid)
                    return None
                return (name, item._replace(arr=arr))

            if self._pool is not None and len(v1_idx) > 1:
                decoded = list(self._pool.map(decode_one, v1_idx))
            else:
                decoded = [decode_one(i) for i in v1_idx]
            for i, repl in zip(v1_idx, decoded):
                staged[i] = repl
        routed: "collections.OrderedDict[str, List[_Item]]" = \
            collections.OrderedDict((n, []) for n in self._lanes)
        for pair in staged:
            if pair is None:
                continue        # a v1 record that failed its decode
            name, item = pair
            routed[name].append(item)
        self._emit_read_events(
            [i for items in routed.values() for i in items])
        self._m_decode.observe(time.perf_counter() - now_p)
        return routed

    def _take_run(self, lane: _Lane) -> List[_Item]:
        """Pop the lane's front run of same-(shape, dtype) records, up to
        its batch target — one dispatchable batch."""
        target = max(self._lane_target(lane), 1)
        items: List[_Item] = []
        key0 = None
        while lane.buffer and len(items) < target:
            item = lane.buffer[0]
            if item.hdr is not None:
                key = (item.hdr[2], item.hdr[1].str)
            else:
                key = (item.arr.shape, item.arr.dtype.str)
            if key0 is None:
                key0 = key
            elif key != key0:
                break
            items.append(lane.buffer.popleft())
        return items

    @staticmethod
    def _item_array(item: _Item) -> np.ndarray:
        """One admitted record's tensor (a zero-copy view for v2)."""
        if item.arr is not None:
            return item.arr
        payload, dt, shape = item.hdr
        return np.frombuffer(payload, dtype=dt).reshape(shape)

    def _lane_assemble(self, lane: _Lane, items: List[_Item]):
        """One uniform run as ``(recs, batch, arena)``: a pooled arena row
        a record, padded up to the lane's smallest bucket holding the run
        by repeating the last real row (``zoo_serving_bucket_pad_rows_
        total``). Rows whose ``batch_size`` would pass ``_MAX_ARENA_BYTES``
        assemble by ``np.stack`` with no arena and no padding."""
        t0 = time.perf_counter()
        first = items[0]
        if first.hdr is not None:
            _, dt, shape = first.hdr
            rowbytes = len(first.hdr[0])
        else:
            dt, shape = first.arr.dtype, first.arr.shape
            rowbytes = first.arr.nbytes
        k = len(items)
        recs = [i.rec for i in items]
        if rowbytes * lane.batch_size > _MAX_ARENA_BYTES:
            batch = np.stack([self._item_array(i) for i in items])
            lane.dispatches += 1
            lane.bucket_hits += 1   # no padding on the fallback path
            self._m_decode.observe(time.perf_counter() - t0)
            return recs, batch, None
        bucket = lane.bucket_for(k)
        arena = lane.arena_pool.acquire(shape, dt)
        self._copy_rows(arena, items)
        if bucket > k:
            arena[k:bucket] = arena[k - 1]
            lane.m_pad_rows.inc(bucket - k)
        else:
            lane.bucket_hits += 1
        lane.dispatches += 1
        self._m_decode.observe(time.perf_counter() - t0)
        return recs, arena[:bucket], arena

    def _copy_rows(self, arena: np.ndarray, items: List[_Item]) -> None:
        """Copy each record's tensor into its arena row, split across the
        decode workers in contiguous slices; consecutive v2 payloads in a
        slice are joined and copied with one ``np.copyto`` (one
        GIL-releasing memcpy)."""
        k = len(items)
        # an explicit row element count, never reshape(-1): a zero-size
        # row ("0" validates) makes -1 ambiguous
        row_elems = int(np.prod(arena.shape[1:], dtype=np.int64))
        flat = arena.reshape(arena.shape[0], row_elems)

        def copy_slice(lo: int, hi: int) -> None:
            i = lo
            while i < hi:
                item = items[i]
                if item.hdr is None:
                    np.copyto(arena[i], item.arr)
                    i += 1
                    continue
                j = i + 1
                while j < hi and items[j].hdr is not None:
                    j += 1
                buf = (items[i].hdr[0] if j == i + 1
                       else b"".join(items[m].hdr[0] for m in range(i, j)))
                src = np.frombuffer(buf, dtype=arena.dtype)
                np.copyto(flat[i:j], src.reshape(j - i, row_elems))
                i = j

        if self._pool is not None and self.decode_workers > 1 \
                and k >= 2 * self.decode_workers:
            step = -(-k // self.decode_workers)
            futs = [self._pool.submit(copy_slice, lo, min(lo + step, k))
                    for lo in range(0, k, step)]
            for f in futs:
                f.result()
        else:
            copy_slice(0, k)

    def _pump(self, lane: _Lane, depth: int) -> None:
        """Dispatch a lane's admitted records in bucket-shaped batches.
        The lane's breaker gates the model: OPEN fast-fails the buffer
        (``_lane_fail_fast``); while the HALF-OPEN probe is in flight the
        records wait buffered for its verdict. With the stream empty and
        nothing left to overlap, the window drains."""
        if self._killed:
            return
        blocked = False
        while lane.buffer:
            if not lane.breaker.allow():
                if lane.breaker.state == CircuitBreaker.OPEN:
                    self._lane_fail_fast(lane)
                else:
                    blocked = True
                break
            items = self._take_run(lane)
            if not items:
                break
            recs, batch, arena = self._lane_assemble(lane, items)
            self._dispatch(lane, recs, batch, arena)
            while len(lane.pendings) >= lane.max_inflight:
                self._flush(lane.pendings.popleft())
        if lane.pendings and (blocked
                              or (depth == 0 and not lane.buffer)):
            # no next batch to overlap with (the stream is empty), or the
            # half-open probe's verdict is what the buffer waits on
            self._drain(lane.pendings)

    def _lane_fail_fast(self, lane: _Lane) -> None:
        """The lane's dispatch breaker is open: answer everything it has
        admitted with ``model unavailable``, spilled to the DLQ first
        when one is attached (reason ``dispatch``, with the lane's name,
        so a replay routes them back to it)."""
        items = list(lane.buffer)
        lane.buffer.clear()
        if not items:
            return
        recs = [i.rec for i in items]
        self.metrics.emit("serving.lane_fail_fast", model=lane.name,
                          records=len(recs), breaker=lane.breaker.state)
        if self._dlq is not None:
            spilled = []
            for item in items:
                try:
                    self._dlq.append(item.rec.uri, self._item_array(item),
                                     reason="dispatch",
                                     trace=item.rec.trace,
                                     error="model unavailable",
                                     model=lane.name)
                except Exception:
                    log.exception("DLQ spill failed for fast-failed "
                                  "record %r", item.rec.uri)
                    continue
                spilled.append(item.rec.eid)
            self._ack(spilled)
        self._record_failure(recs, parent="dequeue",
                             error="model unavailable")

    def _deadline_verdict(self, fields, now_s: float) -> Optional[str]:
        """``"expired"`` when the record's ``deadline_ms`` (absolute epoch
        ms) has passed; ``"doomed"`` when the dispatch median says no
        dispatch could answer it in time (only past ``_DOOMED_MIN_OBS``
        dispatched batches); None serves. A malformed stamp serves."""
        dl = fields.get("deadline_ms")
        if dl is None:
            return None
        try:
            dl_ms = float(str(dl))
        except (TypeError, ValueError):
            log.warning("unparseable deadline_ms %r; serving the record "
                        "without a deadline", dl)
            return None
        if now_s * 1000.0 > dl_ms:
            return "expired"
        if self._q_dispatch.count >= _DOOMED_MIN_OBS \
                and (now_s + self._q_dispatch.quantile(0.5)) * 1000.0 > dl_ms:
            return "doomed"
        return None

    def _drop_expired(self, fields, doomed: bool = False,
                      eid: Optional[str] = None) -> None:
        """Answer an expired (or doomed) record with ``deadline exceeded``,
        counted in its own family and the failure breakdown; a doomed one
        also counts as a shed (``reason="deadline"``)."""
        self._m_deadline.inc()
        if doomed:
            self._m_shed["deadline"].inc()
        self._m_failures.inc()
        self.metrics.counter(
            "zoo_serving_failure_errors_total",
            "failed records by error kind (model vs result-store)",
            labels={"error": "deadline exceeded"}).inc()
        self.metrics.emit("serving.deadline", uri=fields.get("uri"),
                          trace=fields.get("trace"),
                          deadline_ms=fields.get("deadline_ms"),
                          shed=doomed)
        try:
            self.backend.set_result(fields["uri"],
                                    {"error": "deadline exceeded"})
        except Exception:
            log.exception("deadline-error record for %r could not be "
                          "written (backend down?); entry stays pending",
                          fields.get("uri"))
            return
        self._ack([eid])

    def _drop_undecodable(self, fields, eid: Optional[str] = None) -> None:
        """Count, log an event and (when addressable) answer with an
        error record — before any phase event, so a dropped record leaves
        no dangling trace. The ack lands only once the answer did."""
        self._m_undecodable.inc()
        self.metrics.emit("serving.undecodable", uri=fields.get("uri"),
                          trace=fields.get("trace"))
        if fields.get("uri"):
            try:
                self.backend.set_result(fields["uri"],
                                        {"error": "undecodable payload"})
            except Exception:
                log.exception("undecodable-error record for %r could not "
                              "be written (backend down?); entry stays "
                              "pending", fields["uri"])
                return
        self._ack([eid])

    def _drop_unknown_model(self, fields, eid: Optional[str] = None) -> None:
        """Answer a record routed to no configured lane with ``unknown
        model``; the requested name goes to the log and event only."""
        self._m_failures.inc()
        self.metrics.counter(
            "zoo_serving_failure_errors_total",
            "failed records by error kind (model vs result-store)",
            labels={"error": "unknown model"}).inc()
        log.error("record %r names unknown model %r (lanes: %s)",
                  fields.get("uri"), fields.get("model"),
                  ", ".join(self._lanes))
        self.metrics.emit("serving.unknown_model", uri=fields.get("uri"),
                          trace=fields.get("trace"),
                          model=fields.get("model"))
        if fields.get("uri"):
            try:
                self.backend.set_result(fields["uri"],
                                        {"error": "unknown model"})
            except Exception:
                log.exception("unknown-model error record for %r could "
                              "not be written (backend down?); entry "
                              "stays pending", fields["uri"])
                return
        self._ack([eid])

    def _emit_read_events(self, items) -> None:
        """The first two phase events per traced record; later phases
        (dispatch, publish) link back via the trace id + parent field."""
        for item in items:
            rec = item.rec
            if rec.trace is not None:
                self.metrics.emit("request", phase="enqueue",
                                  trace=rec.trace, uri=rec.uri,
                                  parent=None, at_s=rec.t_enq)
                self.metrics.emit("request", phase="dequeue",
                                  trace=rec.trace, uri=rec.uri,
                                  parent="enqueue", dur_s=item.wait)

    def _observe_queue_wait(self, entry_id, now_s: float,
                            reclaimed: bool = False):
        """Enqueue→read wait from the stream entry id (both backends
        stamp ids as ``<epoch_ms>-<seq>``, the Redis-stream convention).
        Returns ``(wait_s, enqueue_epoch_s)`` for the per-request trace
        events, ``(None, None)`` on a foreign id scheme. A negative wait
        (client clock ahead of the server) clamps to zero and counts in
        ``zoo_serving_clock_skew_total`` instead of polluting the
        distribution with a bogus sample. A ``reclaimed`` entry gives
        ``(None, t_enq)``: its age is the dead peer's ``claim_idle_ms``,
        not this replica's admission, and observing it would hand the
        quantiles an outlier and the AIMD controller a breach just when
        the survivor must take the dead peer's load (the
        ``serving.reclaim`` event keeps the entry id)."""
        try:
            enq_ms = int(str(entry_id).split("-", 1)[0])
        except (TypeError, ValueError):
            return None, None   # foreign id scheme: skip, never break loop
        t_enq = enq_ms / 1000.0
        if reclaimed:
            return None, t_enq
        wait = now_s - t_enq
        if wait < 0:
            self._m_skew.inc()
            wait = 0.0
        self._m_queue_wait.observe(wait)
        self._q_queue_wait.observe(wait)
        return wait, t_enq

    # -- dispatch ------------------------------------------------------------
    def _dispatch(self, lane: _Lane, recs, batch, arena=None) -> None:
        """Enqueue the device work on the lane's model; appends a
        ``_Pending`` to the lane's window (async models) or publishes at
        once (sync models). A non-blocking dispatch is tried first: on a
        busy model the lane's oldest batches are flushed (releasing their
        permits) and the dispatch retried, then every lane's window —
        lane specs may alias one model's permits — before a blocking
        dispatch. A sync model drains the window before its predict.
        Outcomes feed the lane's dispatch breaker; a crash is retried
        record by record (``_retry_or_dead_letter``)."""
        t0 = time.perf_counter()
        pendings = lane.pendings
        arena_owned = True
        # a publish give-up spills the ORIGINAL payloads, but the arena
        # is recycled after readback: one copy a dispatch, with a DLQ only
        inputs = (np.array(batch[:len(recs)]) if self._dlq is not None
                  and batch is not None else None)
        try:
            faults.inject("serving.dispatch")
            async_fn = getattr(lane.model, "predict_async", None)
            if async_fn is not None:
                collect = self._probe_dispatch(async_fn, batch, len(recs))
                while collect is None and pendings:
                    self._flush(pendings.popleft())
                    collect = self._probe_dispatch(async_fn, batch,
                                                   len(recs))
                if collect is None:
                    self._drain_all()
                    collect = self._probe_dispatch(async_fn, batch,
                                                   len(recs))
                if collect is None:
                    with span("serving.dispatch", registry=self.metrics,
                              records=len(recs)):
                        collect = async_fn(batch)
                # breaker success is recorded at the readback (_flush):
                # an async model's failures surface at collect()
                lane.m_dispatches.inc()
                self._emit_dispatch(recs, t0)
                arena_owned = False
                pendings.append(_Pending(lane, recs, collect, t0, arena,
                                         inputs))
                return
            self._drain(pendings)
            with span("serving.dispatch", registry=self.metrics,
                      records=len(recs)):
                preds = lane.model.predict(batch)
            lane.m_dispatches.inc()
            self._emit_dispatch(recs, t0)
            arena_owned = False
            self._flush(_Pending(lane, recs, (lambda: preds), t0, arena,
                                 inputs))
        except Exception as e:
            lane.breaker.record_failure()
            log.exception("inference dispatch failed for %d records "
                          "(model %r); retrying one record at a time",
                          len(recs), lane.name)
            # copy each record's input out BEFORE the arena goes back to
            # the pool — a later read may overwrite it mid-retry
            rows = None
            if batch is not None and self.dispatch_retries > 0:
                rows = [np.array(batch[i:i + 1]) for i in range(len(recs))]
            if arena_owned:
                lane.arena_pool.release(arena)
            self._retry_or_dead_letter(lane, recs, rows, cause=e)

    @staticmethod
    def _predict_once(model, batch):
        """One synchronous model call for the retry path."""
        predict = getattr(model, "predict", None)
        if predict is not None:
            return predict(batch)
        return model.predict_async(batch)()

    def _retry_or_dead_letter(self, lane: _Lane, recs, rows,
                              cause: Optional[BaseException] = None) -> None:
        """After a batch dispatch crash: re-dispatch each record ALONE, up
        to ``dispatch_retries`` times, so one poison record does not fail
        its batch-mates; a record that keeps crashing is dead-lettered
        (counted, spilled to the DLQ, answered). ``cause`` stays the
        reported error when a drained retry budget refuses the retries.
        It retries the model call on the lane's own model and device;
        it never switches route."""
        if self._killed:
            return
        if rows is None:
            self._record_failure(recs, parent="dequeue")
            return
        # release every window's permits before a blocking solo predict
        self._drain_all()
        retry_counter = self.metrics.counter(
            "zoo_retry_attempts_total",
            "retries performed by reliability.RetryPolicy, by operation",
            labels={"op": "serving.dispatch"})
        for rec, row in zip(recs, rows):
            err = None
            budget_refused = False
            for attempt in range(self.dispatch_retries):
                if (self._retry_budget is not None
                        and not self._retry_budget.withdraw()):
                    budget_refused = True
                    err = cause if cause is not None else RuntimeError(
                        "retry budget exhausted")
                    break
                retry_counter.inc()
                t1 = time.perf_counter()
                try:
                    faults.inject("serving.dispatch")
                    with span("serving.dispatch", registry=self.metrics,
                              records=1):
                        preds = np.asarray(self._predict_once(lane.model,
                                                              row))
                except Exception as e:
                    lane.breaker.record_failure()
                    err = e
                    log.warning("solo re-dispatch of %r failed "
                                "(attempt %d/%d): %s", rec.uri, attempt + 1,
                                self.dispatch_retries, e)
                    continue
                lane.breaker.record_success()
                self._emit_dispatch([rec], t1)
                self._pub_put(lane, [rec], preds, t1, row)
                err = None
                break
            if err is not None:
                if budget_refused:
                    log.error("record %r: batch dispatch crashed and the "
                              "retry budget is exhausted; dead-lettering "
                              "without a solo retry", rec.uri)
                else:
                    log.error("record %r crashed dispatch %d time(s); "
                              "dead-lettering", rec.uri,
                              self.dispatch_retries + 1)
                self._m_dead_letter.inc()
                self.metrics.emit("serving.dead_letter", uri=rec.uri,
                                  trace=rec.trace, error=str(err),
                                  model=lane.name)
                # the spill is the work, the answer its receipt: spill
                # first
                if self._dlq is not None:
                    try:
                        self._dlq.append(rec.uri, row[0], reason="dispatch",
                                         trace=rec.trace, error=str(err),
                                         model=lane.name)
                    except Exception:
                        log.exception("DLQ spill failed for dead-lettered "
                                      "record %r", rec.uri)
                    else:
                        self._ack([rec.eid])
                self._record_failure(
                    [rec], parent="dequeue",
                    error="dead-lettered: dispatch crashed repeatedly")

    def _probe_dispatch(self, async_fn, batch, n: int):
        """Non-blocking dispatch probe; a refused probe's span is
        discarded so its ~zero duration does not skew the distribution."""
        with span("serving.dispatch", registry=self.metrics,
                  records=n) as sp:
            collect = async_fn(batch, block=False)
            if collect is None:
                sp.discard()
        return collect

    def _emit_dispatch(self, recs, t0: float) -> None:
        """Per-request dispatch phase events: ``dur_s`` runs from the
        record's dequeue to the moment its batch entered the model
        (``t0``), ``batch`` is the co-dispatched record count. Every
        successful dispatch deposits into the shared retry budget."""
        if self._killed:
            return
        if self._retry_budget is not None:
            self._retry_budget.on_success()
        n = len(recs)
        for rec in recs:
            if rec.trace is not None:
                self.metrics.emit("request", phase="dispatch",
                                  trace=rec.trace, uri=rec.uri,
                                  parent="dequeue",
                                  dur_s=max(t0 - rec.t_deq, 0.0), batch=n)

    def _record_failure(self, recs, parent: str = "dequeue",
                        error: str = "inference failed") -> None:
        """Registry + event + addressable error records for a failed
        batch. Every traced record gets a terminal ``failed`` phase event
        (``parent`` = the last phase that completed), emitted before the
        error write. ``error`` is what the producer's ``query()`` sees
        and the ``error=`` label of the breakdown. Each record whose
        answer landed is acked."""
        if self._killed:
            return
        self._m_failures.inc(len(recs))
        # the breakdown lives in its own family: a labeled series under
        # zoo_serving_failures_total would double-count in a sum()
        self.metrics.counter(
            "zoo_serving_failure_errors_total",
            "failed records by error kind (model vs result-store)",
            labels={"error": error}).inc(len(recs))
        self.metrics.emit("serving.failure", records=len(recs), error=error)
        answered = []
        for rec in recs:
            if rec.trace is not None:
                self.metrics.emit("request", phase="failed", trace=rec.trace,
                                  uri=rec.uri, parent=parent, error=error)
            try:
                self.backend.set_result(rec.uri, {"error": error})
            except Exception:
                log.exception("error record for %r could not be written",
                              rec.uri)
                continue
            answered.append(rec.eid)
        self._ack(answered)

    # -- readback + publish --------------------------------------------------
    def _flush(self, pending: _Pending) -> None:
        """Read a dispatched batch back, slice the bucket padding off and
        hand it to the publisher. The arena returns to its lane's pool
        only here, after the readback: ``InferenceModel._run`` uploads
        straight from the arena view (no pinned copy; a pageable source
        is staged before the copy call returns), and a model may read
        its input later still (a sync model's view, a deferred
        ``collect``). Predictions that alias the arena are copied out
        first."""
        lane, recs, collect, t0, arena, inputs = pending
        if self._killed:
            # simulated crash: abandon the readback
            lane.arena_pool.release(arena)
            return
        try:
            with span("serving.flush", registry=self.metrics,
                      records=len(recs)):
                preds = np.asarray(collect())[:len(recs)]
            if arena is not None and np.may_share_memory(preds, arena):
                preds = preds.copy()
        except Exception:
            lane.breaker.record_failure()
            log.exception("inference failed for %d records", len(recs))
            self._record_failure(recs, parent="dispatch")
            return
        finally:
            lane.arena_pool.release(arena)
        # the breaker's success signal: the readback landed
        lane.breaker.record_success()
        self._pub_put(lane, recs, preds, t0, inputs)

    def _pub_put(self, lane: _Lane, recs, preds, t0: float, inputs) -> None:
        """Hand one batch to the publisher, bounded: a publisher wedged
        on a stalled result store surfaces as addressable failures (and
        DLQ spills) after ``_PUB_PUT_TIMEOUT_S``."""
        try:
            self._pub_queue.put((lane, recs, preds, t0, inputs),
                                timeout=_PUB_PUT_TIMEOUT_S)
        except queue.Full:
            log.error("publisher queue still full after %.0fs; failing %d "
                      "record(s)", _PUB_PUT_TIMEOUT_S, len(recs))
            self._spill_publish(recs, inputs, error="publish queue full",
                                model=lane.name)
            self._record_failure(recs, parent="dispatch",
                                 error="result publish failed")
            return
        self._m_backlog.set(self._pub_queue.qsize())

    def _spill_publish(self, recs, inputs, error: str,
                       model: Optional[str] = None) -> List[str]:
        """Spill a batch the publisher gave up on to the DLQ (reason
        ``publish``): the original payloads, for replay after the result
        store recovers. A landed spill is settlement: those entries are
        acked here. No-op without a DLQ."""
        if self._dlq is None or inputs is None:
            return []
        spilled = []
        for i, rec in enumerate(recs):
            try:
                self._dlq.append(rec.uri, inputs[i], reason="publish",
                                 trace=rec.trace, error=error, model=model)
            except Exception:
                log.exception("DLQ spill failed for %r", rec.uri)
                continue
            spilled.append(rec.eid)
        self._ack(spilled)
        return spilled

    def _publisher_loop(self) -> None:
        """Drain the publish queue in order until the stop sentinel, which
        ``stop()`` enqueues after the serve loop flushed every batch.
        Writes run under the publish breaker: a failure spills the batch
        and answers it ``result publish failed``; once the breaker is
        open queued batches go straight to the DLQ until its half-open
        probe publishes a real batch."""
        q = self._pub_queue
        while True:
            item = q.get()
            if item is _PUB_STOP:
                return
            lane, recs, preds, t0, inputs = item
            if self._killed:
                self._m_backlog.set(q.qsize())
                continue
            if not self._pub_breaker.allow():
                self._spill_publish(recs, inputs,
                                    error="publish breaker open",
                                    model=lane.name)
                self._record_failure(recs, parent="dispatch",
                                     error="result publish failed")
                self._m_backlog.set(q.qsize())
                continue
            try:
                self._publish(lane, recs, preds, t0)
            except Exception as e:
                self._pub_breaker.record_failure()
                log.exception("publish failed for %d records", len(recs))
                self._spill_publish(recs, inputs,
                                    error=f"{type(e).__name__}: {e}",
                                    model=lane.name)
                self._record_failure(recs, parent="dispatch",
                                     error="result publish failed")
            else:
                self._pub_breaker.record_success()
            self._m_backlog.set(q.qsize())

    def _publish(self, lane: _Lane, recs, preds, t0: float) -> None:
        """Encode + write one batch's results, ack them, and do the
        publish-side bookkeeping: counters (the lane's too), the encode
        and dispatch histograms, the e2e quantiles, a ``publish`` phase
        event per traced record and one ``serving.flush`` event."""
        # publisher-only fault site: a plan here hits exactly the result
        # publishes, never the shed or error-record writes
        faults.inject("serving.publish")
        t_enc = time.perf_counter()
        results = {}
        for i, rec in enumerate(recs):
            if rec.v2:
                results[rec.uri] = encode_tensor(preds[i], key="value")
            else:
                results[rec.uri] = {"value": encode_array(preds[i])}
        self._m_encode.observe(time.perf_counter() - t_enc)
        self.backend.set_results(results)
        self._ack([rec.eid for rec in recs])
        self.served += len(recs)
        self._batches += 1
        now = time.perf_counter()
        now_wall = time.time()
        self._last_flush_wall = now_wall
        latency = max(now - t0, 0.0)
        self._m_records.inc(len(recs))
        lane.m_records.inc(len(recs))
        self._m_batches.inc()
        self._m_batch_size.observe(len(recs))
        self._m_dispatch.observe(latency)
        self._q_dispatch.observe(latency)
        for rec in recs:
            e2e = (max(now_wall - rec.t_enq, 0.0)
                   if rec.t_enq is not None else None)
            if e2e is not None:
                # clamped: the skew was counted once, at the queue wait
                self._q_e2e.observe(e2e)
            if rec.trace is not None:
                self.metrics.emit(
                    "request", phase="publish", trace=rec.trace,
                    uri=rec.uri, parent="dispatch", dur_s=latency,
                    e2e_s=e2e)
        self.metrics.emit("serving.flush", records=len(recs),
                          batch=self._batches, latency_s=latency,
                          model=lane.name)
        if self._summary is not None:
            t_prev = self._t_last_flush
            self._t_last_flush = now
            # from the later of the previous flush and this batch's
            # dispatch: the inter-flush interval under load, this batch's
            # own dispatch-to-publish after an idle gap
            start = t0 if t_prev is None else max(t_prev, t0)
            dt = max(now - start, 1e-9)
            self._summary.add_scalar("Serving Throughput", len(recs) / dt,
                                     self._batches)
            self._summary.add_scalar("Serving Records", self.served,
                                     self._batches)
            self._summary.flush()
