"""Cluster Serving — port of the core of ``analytics_zoo_tpu/serving/
server.py`` for one lane: read → decode → batch assembly → ``predict_async``
with a bounded dispatch window → readback → async publish → ack.

* The serve loop reads up to ``batch_size`` entries from the input stream
  as a member of a consumer group (entries stay pending until acked), or
  consume-on-read when ``consumer_group=""``. Reads go through a circuit
  breaker: transport errors count against it instead of killing the loop.
* Records decode from wire format v2 (or legacy v1) and assemble into
  uniform ``(shape, dtype)`` batches. Undecodable records are answered
  with an addressable error.
* Up to ``max_inflight`` batches are dispatched with their readback
  deferred, so a batch's device time overlaps the next batch's read and
  decode. A dispatch first tries a non-blocking permit
  (``predict_async(block=False)``) and flushes the oldest batch when the
  model is busy — a single-threaded pipeline must not block on a permit
  its own pending batch holds.
* A publisher thread encodes results (in the request's wire version),
  writes them in one ``set_results`` call, and acks the entries only
  after the results landed.

A bare model (a ``KerasNet`` or ``ZooModel``) is wrapped, as the JAX
package wraps it, in an ``InferenceModel(concurrent_num=2)`` on the
serving dtype (``dtype=`` or ``zoo.serving.dtype``): float32, bfloat16 or
int8 weight-only; anything with ``predict_async`` passes through.

Observability keeps the JAX package's names, letter for letter: the
``zoo_serving_*`` counters (records, batches, undecodable, failures and
their ``error=`` breakdown, clock skew), the stream-depth and
publish-backlog gauges, the batch-size, queue-wait, decode, encode and
dispatch histograms, and p50/p95/p99 summaries of queue wait, dispatch
and end to end. Queue wait and end to end run from the ``<epoch_ms>-<seq>``
stream entry id (wall clock, the only one producer and server share);
phase durations on this process's ``perf_counter``. Every record the
client stamped with a trace id gets parent-linked ``request`` events
(enqueue → dequeue → dispatch → publish, or a terminal ``failed``), and
each batch a ``serving.flush`` event and ``serving.dispatch`` /
``serving.flush`` spans, on the sinks of the server's registry
(:meth:`ClusterServing.set_json_events`). :meth:`serve_metrics` mounts
``/metrics``, ``/healthz``, ``/statusz`` and ``POST /profilez``;
``python -m analytics_zoo_tpu_torch.serving.status`` reads them. With
``zoo.goodput.enabled`` the loop attributes its wall clock to ``idle``,
``host_decode``, ``device_dispatch`` and ``publish``.

Not ported yet: multi-model lanes, shape buckets, load shedding and
deadlines, adaptive batching, the DLQ, dispatch retries and supervised
restarts, fleet heartbeats and reclaim, and the fault sites. The
``/statusz`` fields that come with them are listed in
:data:`HEALTH_NOT_PORTED`.
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
from typing import List, Optional

import numpy as np

from ..common.reliability import CircuitBreaker
from ..observability import default_registry, span
from .backend import LocalBackend, default_backend
from .client import (INPUT_STREAM, decode_payload, encode_array,
                     encode_tensor, is_v2)

log = logging.getLogger("analytics_zoo_tpu_torch.serving")

__all__ = ["ClusterServing", "HEALTH_NOT_PORTED"]

#: per-request carry-through from read to publish. ``t_enq`` is WALL
#: epoch seconds (parsed from the ``<epoch_ms>-<seq>`` entry id, the only
#: clock the producer and server share; None on a foreign id scheme);
#: ``t_deq`` is this process's ``perf_counter`` at read time (monotonic —
#: server-side phase durations must not jump on an NTP step). ``v2``
#: selects the answer's wire version, ``eid`` is the stream entry id the
#: post-publish ack needs (None in consume-on-read mode)
_Rec = collections.namedtuple("_Rec", ("uri", "trace", "t_enq", "t_deq",
                                       "v2", "eid"))

#: a dispatched batch whose readback is deferred
_Pending = collections.namedtuple("_Pending", ("recs", "collect", "t0"))

_PUB_STOP = object()    # publisher-queue sentinel: drain, then exit

#: bound on the serve loop's publisher-queue puts
_PUB_PUT_TIMEOUT_S = 30.0

#: while batches are in flight the read is a 1 ms poll, so records that
#: arrive during a device step join the next dispatch
_BUSY_POLL_MS = 1

_CONSUMER_SEQ = itertools.count()

#: serving dtype paths for a model the server wraps (conf
#: ``zoo.serving.dtype``); models with their own predict surface carry
#: their own precision and pass through untouched
_LANE_DTYPES = ("float32", "bfloat16", "bf16", "int8")

#: the one lane's name (the JAX server's name for a single model)
_LANE = "default"

#: the JAX server's ``/healthz`` / ``/statusz`` fields that arrive with
#: later serving items: under ``serving``, the ``overload`` block
#: (shedding, AIMD, DLQ) and the ``scaling`` block (fleet); in a
#: ``models`` row, admission weights, the AIMD target, shape buckets and
#: the lane's dispatch breaker
HEALTH_NOT_PORTED = {
    "serving": ("overload", "scaling"),
    "models": ("weight", "batch_target", "buckets", "bucket_hit_rate",
               "breaker", "pad_rows"),
}


class ClusterServing:
    """Owns the serve loop for one model: anything with ``predict_async``
    like :class:`InferenceModel`, a bare ``KerasNet`` (wrapped on the
    serving dtype), or a plain ``predict``."""

    def __init__(self, model, backend: Optional[LocalBackend] = None,
                 batch_size: int = 32, stream: str = INPUT_STREAM,
                 block_ms: int = 50, registry=None, max_inflight: int = 2,
                 publish_queue: int = 8,
                 breaker: Optional[CircuitBreaker] = None,
                 consumer_group: str = "serving",
                 consumer_name: Optional[str] = None,
                 dtype: Optional[str] = None):
        if isinstance(model, dict):
            raise NotImplementedError(
                "multi-model lanes are not ported yet; serve one model")
        if dtype is None:
            from ..common.context import get_zoo_context
            dtype = get_zoo_context().get("zoo.serving.dtype", "float32")
        #: serving dtype path for a model the server wraps
        self.dtype = str(dtype)
        if self.dtype not in _LANE_DTYPES:
            raise ValueError(f"unknown serving dtype {self.dtype!r}; "
                             f"use one of {_LANE_DTYPES}")
        self.model = self._wrap_model(model, self.dtype)
        self.backend = backend if backend is not None else default_backend()
        self.batch_size = int(batch_size)
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.stream = stream
        self.block_ms = int(block_ms)
        self.max_inflight = max(int(max_inflight), 1)
        self._pub_maxsize = max(int(publish_queue), 1)
        self._pub_queue: Optional["queue.Queue"] = None
        self._pub_thread: Optional[threading.Thread] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._buffer: "collections.deque" = collections.deque()
        self._pendings: "collections.deque[_Pending]" = collections.deque()
        self.served = 0
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
        self._m_acks = m.counter(
            "zoo_serving_acks_total",
            "stream entries acked (settled) out of the consumer group's "
            "pending-entries set")
        self._breaker = breaker if breaker is not None else CircuitBreaker(
            name="serving.backend", failure_threshold=3, reset_timeout=1.0,
            registry=m)
        self.consumer_group = consumer_group
        self.consumer_name = consumer_name or (
            f"{socket.gethostname()}-{os.getpid()}-{next(_CONSUMER_SEQ)}")
        self._batches = 0
        self._last_flush_wall = None   # epoch s of the newest publish
        self._events = None            # JsonEventSink (set_json_events)
        self._scrape = None            # ScrapeServer (serve_metrics)
        self._profiler = None          # ProfilerTrigger (serve_metrics)
        self._crash_info = {}          # loop -> traceback of its crash
        self._loop_down: set = set()   # loops an escaped exception ended
        # goodput attribution: the loop notes its read / decode / dispatch
        # / publish seams so every second of its wall clock lands in
        # exactly one category
        from ..observability.goodput import GoodputLedger, goodput_enabled
        self._goodput = (GoodputLedger("serve", registry=m)
                         if goodput_enabled() else None)

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

    # -- observability surface ----------------------------------------------
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
        uptime, stream depth, last-flush age, device info and memory, the
        goodput ``performance`` block) and ``POST /profilez`` (arm a
        bounded ``torch.profiler`` capture of this process). Returns the
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
        dispatch). A loop that an escaped exception ended flips the
        payload's ``status`` to ``down``, with its traceback."""
        age = (None if self._last_flush_wall is None
               else max(time.time() - self._last_flush_wall, 0.0))
        thread = self._thread
        pub = self._pub_queue
        try:
            depth = self.backend.backlog_len(self.stream)
        except Exception as e:      # a dead backend must not 500 /healthz
            depth = None
            log.debug("backlog_len failed on the scrape thread: %s", e)
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
            "models": {_LANE: {
                "dtype": self.dtype,
                "batch_ceiling": self.batch_size,
                "max_inflight": self.max_inflight,
                "records": self._m_records.value,
                "buffered": len(self._buffer),
                "inflight": len(self._pendings),
            }},
        }}
        if self._crash_info:
            info["serving"]["last_crash"] = dict(self._crash_info)
        if down:
            info["status"] = "down"
        return info

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ClusterServing":
        if self._thread is not None:
            raise RuntimeError("serving already started")
        if self.consumer_group:
            self.backend.xgroup_create(self.stream, self.consumer_group)
        self._stop.clear()
        self._crash_info = {}
        self._loop_down = set()
        self._pub_queue = queue.Queue(maxsize=self._pub_maxsize)
        self._pub_thread = threading.Thread(
            target=self._guarded, args=("publish", self._publisher_loop),
            daemon=True, name="cluster-serving-publish")
        self._pub_thread.start()
        self._thread = threading.Thread(
            target=self._guarded, args=("serve", self._loop), daemon=True,
            name="cluster-serving")
        self._thread.start()
        return self

    def _guarded(self, name: str, body) -> None:
        """Run a loop body; an escaped exception is logged, kept for
        ``/statusz`` (``last_crash``) and marks the loop down, so
        ``/healthz`` reads ``down`` instead of ok over a dead loop."""
        try:
            body()
        except Exception:
            tb = traceback.format_exc()
            # each loop writes its own key, read only for display
            self._crash_info[name] = tb
            self._loop_down.add(name)
            self.metrics.emit("serving.loop_crash", loop=name, crashes=1,
                              traceback=tb)
            log.error("%s loop crashed; /healthz now reads down:\n%s",
                      name, tb)

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the loop; with ``drain`` first wait (up to ``timeout``)
        for the stream to empty. Every batch already read is dispatched
        and published before the publisher exits, and the sinks (events,
        the scrape endpoint, a running profiler capture) close only after
        that, so the last publish events land."""
        if self._thread is None:
            self._shutdown_publisher(timeout)
            self._close_sinks()
            return
        if drain:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline \
                    and self.backend.stream_len(self.stream) > 0:
                time.sleep(0.01)
        self._stop.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"serve loop still running after {timeout}s "
                               f"(model dispatch in flight?)")
        self._thread = None
        self._shutdown_publisher(timeout)
        self._close_sinks()

    def _shutdown_publisher(self, timeout: float) -> None:
        """Join the publisher after a drain-everything sentinel. Safe to
        call when it was never started."""
        t, q = self._pub_thread, self._pub_queue
        if t is None:
            return
        try:
            q.put(_PUB_STOP, timeout=timeout)
        except queue.Full:
            raise TimeoutError(f"publisher still draining after {timeout}s")
        t.join(timeout=timeout)
        if t.is_alive():
            raise TimeoutError(f"publisher still draining after {timeout}s")
        self._pub_thread = None
        self._pub_queue = None

    def _close_sinks(self) -> None:
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

    # -- the loop -----------------------------------------------------------
    def _gp_note(self, category: str) -> None:
        """Attribute wall clock since the ledger's mark to ``category``
        (no-op when goodput accounting is off)."""
        if self._goodput is not None:
            self._goodput.note(category)

    def _loop(self) -> None:
        if self._goodput is not None:
            self._goodput.open()
        try:
            while not self._stop.is_set():
                try:
                    busy = bool(self._pendings or self._buffer)
                    want = self.batch_size - len(self._buffer)
                    entries = self._read_entries(
                        want, _BUSY_POLL_MS if busy else self.block_ms) \
                        if want > 0 else []
                    # read wait is idle time: the device had nothing
                    # admitted to chew on
                    self._gp_note("idle")
                    if not entries and not self._buffer:
                        self._drain()
                        self._gp_note("publish")
                        continue
                    # one depth probe per read feeds the gauge and the
                    # drain check
                    depth = self.backend.backlog_len(self.stream)
                    self._m_depth.set(depth)
                    self._buffer.extend(self._decode(entries))
                    self._gp_note("host_decode")
                    self._pump(depth)
                    self._gp_note("device_dispatch")
                finally:
                    # residual per-iteration overhead lands on idle, so
                    # no interval is left unattributed
                    self._gp_note("idle")
        finally:
            # records already read are dispatched and published, not lost
            self._pump(0)
            self._drain()

    def _read_entries(self, count: int, block_ms: int):
        """One breaker-guarded read. Transport errors count against the
        breaker and read as empty; while it is open the backend is left
        alone until the next probe window."""
        if not self._breaker.allow():
            self._stop.wait(min(max(self._breaker.probe_in(), 0.001),
                                self.block_ms / 1000.0))
            return []
        try:
            if self.consumer_group:
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
            return []
        except Exception:
            self._breaker.record_failure()
            raise
        self._breaker.record_success()
        return entries

    def _decode(self, entries):
        """``[(rec, array)]`` for the decodable records of one read; the
        rest are answered with ``undecodable payload``. Every entry's
        queue wait is observed first, before any drop; the enqueue and
        dequeue phase events of the admitted traced records follow."""
        now_s = time.time()
        now_p = time.perf_counter()
        out = []
        waits = []
        for entry_id, fields in entries:
            wait, t_enq = self._observe_queue_wait(entry_id, now_s)
            eid = entry_id if self.consumer_group else None
            uri = fields.get("uri")
            try:
                if not uri:
                    raise ValueError("record has no uri")
                arr = np.asarray(decode_payload(fields))
            except Exception:
                log.exception("undecodable record (uri=%r)", uri)
                self._drop_undecodable(fields, eid)
                continue
            out.append((_Rec(uri, fields.get("trace"), t_enq, now_p,
                             is_v2(fields), eid), arr))
            waits.append(wait)
        self._emit_read_events([rec for rec, _ in out], waits)
        self._m_decode.observe(time.perf_counter() - now_p)
        return out

    def _emit_read_events(self, recs, waits) -> None:
        """The first two phase events per traced record; later phases
        (dispatch, publish) link back via the trace id + parent field."""
        for rec, wait in zip(recs, waits):
            if rec.trace is not None:
                self.metrics.emit("request", phase="enqueue",
                                  trace=rec.trace, uri=rec.uri,
                                  parent=None, at_s=rec.t_enq)
                self.metrics.emit("request", phase="dequeue",
                                  trace=rec.trace, uri=rec.uri,
                                  parent="enqueue", dur_s=wait)

    def _observe_queue_wait(self, entry_id, now_s: float):
        """Enqueue→read wait from the stream entry id (``LocalBackend``
        stamps ids as ``<epoch_ms>-<seq>``, the Redis-stream convention).
        Returns ``(wait_s, enqueue_epoch_s)`` for the per-request trace
        events, ``(None, None)`` on a foreign id scheme. A negative wait
        (client clock ahead of the server) clamps to zero and counts in
        ``zoo_serving_clock_skew_total`` instead of polluting the
        distribution with a bogus sample."""
        try:
            enq_ms = int(str(entry_id).split("-", 1)[0])
        except (TypeError, ValueError):
            return None, None   # foreign id scheme: skip, never break loop
        t_enq = enq_ms / 1000.0
        wait = now_s - t_enq
        if wait < 0:
            self._m_skew.inc()
            wait = 0.0
        self._m_queue_wait.observe(wait)
        self._q_queue_wait.observe(wait)
        return wait, t_enq

    def _take_run(self):
        """Pop the buffer's front run of same-(shape, dtype) records, up
        to ``batch_size`` — one dispatchable batch."""
        items = []
        key0 = None
        while self._buffer and len(items) < self.batch_size:
            arr = self._buffer[0][1]
            key = (arr.shape, arr.dtype.str)
            if key0 is None:
                key0 = key
            elif key != key0:
                break
            items.append(self._buffer.popleft())
        return items

    def _pump(self, depth: int) -> None:
        """Dispatch everything buffered; keep at most ``max_inflight``
        batches unread. With the stream empty, flush the window so a
        trickle of records is answered without waiting for more."""
        while self._buffer:
            items = self._take_run()
            self._dispatch([r for r, _ in items],
                           np.stack([a for _, a in items]))
            while len(self._pendings) >= self.max_inflight:
                self._flush(self._pendings.popleft())
        if depth == 0:
            self._drain()

    def _drain(self) -> None:
        while self._pendings:
            self._flush(self._pendings.popleft())

    def _dispatch(self, recs: List[_Rec], batch: np.ndarray) -> None:
        """Enqueue the device work; ``serving.dispatch`` spans cover the
        model calls only (a refused non-blocking probe is discarded)."""
        t0 = time.perf_counter()
        try:
            async_fn = getattr(self.model, "predict_async", None)
            if async_fn is None:
                self._drain()
                with span("serving.dispatch", registry=self.metrics,
                          records=len(recs)):
                    preds = self.model.predict(batch)
                self._emit_dispatch(recs, t0)
                self._flush(_Pending(recs, lambda: preds, t0))
                return
            collect = self._probe_dispatch(async_fn, batch, len(recs))
            while collect is None and self._pendings:
                # every permit is held by our own pending batches:
                # publish the oldest (releasing its permit) and retry
                self._flush(self._pendings.popleft())
                collect = self._probe_dispatch(async_fn, batch, len(recs))
            if collect is None:
                with span("serving.dispatch", registry=self.metrics,
                          records=len(recs)):
                    collect = async_fn(batch)
        except Exception:
            log.exception("inference dispatch failed for %d records",
                          len(recs))
            self._record_failure(recs, parent="dequeue")
            return
        self._emit_dispatch(recs, t0)
        self._pendings.append(_Pending(recs, collect, t0))

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
        (``t0``), ``batch`` is the co-dispatched record count."""
        n = len(recs)
        for rec in recs:
            if rec.trace is not None:
                self.metrics.emit("request", phase="dispatch",
                                  trace=rec.trace, uri=rec.uri,
                                  parent="dequeue",
                                  dur_s=max(t0 - rec.t_deq, 0.0), batch=n)

    def _flush(self, pending: _Pending) -> None:
        """Read a dispatched batch back and hand it to the publisher."""
        recs, collect, t0 = pending
        try:
            with span("serving.flush", registry=self.metrics,
                      records=len(recs)):
                preds = np.asarray(collect())[:len(recs)]
        except Exception:
            log.exception("inference failed for %d records", len(recs))
            self._record_failure(recs, parent="dispatch")
            return
        try:
            self._pub_queue.put((recs, preds, t0),
                                timeout=_PUB_PUT_TIMEOUT_S)
        except queue.Full:
            log.error("publisher queue still full after %.0fs; failing %d "
                      "record(s)", _PUB_PUT_TIMEOUT_S, len(recs))
            self._record_failure(recs, parent="dispatch",
                                 error="result publish failed")
            return
        self._m_backlog.set(self._pub_queue.qsize())

    # -- answers + settlement -------------------------------------------------
    def _ack(self, eids) -> None:
        """Settle entries out of the group's pending list — only after the
        producer-visible answer landed. A failed ack leaves them pending."""
        eids = [e for e in eids if e]
        if not eids or not self.consumer_group:
            return
        try:
            n = self.backend.xack(self.stream, self.consumer_group, *eids)
        except Exception as e:
            log.warning("ack of %d entries failed (%s: %s)", len(eids),
                        type(e).__name__, e)
            return
        self._m_acks.inc(n)

    def _drop_undecodable(self, fields, eid) -> None:
        """Count, log an event and (when addressable) answer with an
        error record — before any phase event, so a dropped record leaves
        no dangling trace."""
        self._m_undecodable.inc()
        uri = fields.get("uri")
        self.metrics.emit("serving.undecodable", uri=uri,
                          trace=fields.get("trace"))
        if uri:
            try:
                self.backend.set_result(uri, {"error": "undecodable payload"})
            except Exception:
                log.exception("undecodable-error record for %r could not "
                              "be written", uri)
                return
        self._ack([eid])

    def _record_failure(self, recs, parent: str = "dequeue",
                        error: str = "inference failed") -> None:
        """Registry + event + addressable error records for a failed
        batch. Every traced record gets a terminal ``failed`` phase event
        (``parent`` = the last phase that completed), emitted before the
        error write, so a by-trace reconstruction never shows a failed
        request as in flight. ``error`` is what the producer's
        ``query()`` sees and the ``error=`` label of the breakdown."""
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

    def _publisher_loop(self) -> None:
        """Drain the publish queue in order until the stop sentinel, which
        ``stop()`` enqueues after the serve loop flushed every batch."""
        q = self._pub_queue
        while True:
            item = q.get()
            if item is _PUB_STOP:
                return
            recs, preds, t0 = item
            try:
                self._publish(recs, preds, t0)
            except Exception:
                log.exception("publish failed for %d records", len(recs))
                self._record_failure(recs, parent="dispatch",
                                     error="result publish failed")
            self._m_backlog.set(q.qsize())

    def _publish(self, recs, preds, t0: float) -> None:
        """Encode + write one batch's results, ack them, and do the
        publish-side bookkeeping: counters, the encode and dispatch
        histograms, the e2e quantiles, a ``publish`` phase event per
        traced record and one ``serving.flush`` event."""
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
                          model=_LANE)
