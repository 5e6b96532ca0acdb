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

Metrics keep the JAX package's names: ``zoo_serving_records_total``,
``zoo_serving_batches_total``, ``zoo_serving_dispatch_seconds`` (and the
failure/undecodable counters). Multi-model lanes, shape buckets, load
shedding, adaptive batching, fleet heartbeats and reclaim, the DLQ, fault
sites, spans, JSON events and the HTTP endpoints are not ported yet.
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
from typing import List, Optional

import numpy as np

from ..common.reliability import CircuitBreaker
from ..observability import default_registry
from .backend import LocalBackend, default_backend
from .client import (INPUT_STREAM, decode_payload, encode_array,
                     encode_tensor, is_v2)

log = logging.getLogger("analytics_zoo_tpu_torch.serving")

__all__ = ["ClusterServing"]

#: per-request carry-through from read to publish: ``v2`` selects the
#: answer's wire version, ``eid`` is the stream entry id the post-publish
#: ack needs (None in consume-on-read mode)
_Rec = collections.namedtuple("_Rec", ("uri", "trace", "v2", "eid"))

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
            "records answered with a failure error, all kinds")
        self._m_depth = m.gauge(
            "zoo_serving_stream_depth", "input-stream backlog after a read")
        self._m_batch_size = m.histogram(
            "zoo_serving_batch_size", "records per published batch")
        self._m_dispatch = m.histogram(
            "zoo_serving_dispatch_seconds",
            "dispatch to publish latency per batch")
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

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ClusterServing":
        if self._thread is not None:
            raise RuntimeError("serving already started")
        if self.consumer_group:
            self.backend.xgroup_create(self.stream, self.consumer_group)
        self._stop.clear()
        self._pub_queue = queue.Queue(maxsize=self._pub_maxsize)
        self._pub_thread = threading.Thread(
            target=self._publisher_loop, daemon=True,
            name="cluster-serving-publish")
        self._pub_thread.start()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cluster-serving")
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the loop; with ``drain`` first wait (up to ``timeout``)
        for the stream to empty. Every batch already read is dispatched
        and published before the publisher exits."""
        if self._thread is None:
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
        try:
            self._pub_queue.put(_PUB_STOP, timeout=timeout)
        except queue.Full:
            raise TimeoutError(f"publisher still draining after {timeout}s")
        self._pub_thread.join(timeout=timeout)
        if self._pub_thread.is_alive():
            raise TimeoutError(f"publisher still draining after {timeout}s")
        self._pub_thread = None
        self._pub_queue = None

    # -- the loop -----------------------------------------------------------
    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                busy = bool(self._pendings or self._buffer)
                want = self.batch_size - len(self._buffer)
                entries = self._read_entries(
                    want, _BUSY_POLL_MS if busy else self.block_ms) \
                    if want > 0 else []
                if not entries and not self._buffer:
                    self._drain()
                    continue
                self._buffer.extend(self._decode(entries))
                depth = self.backend.backlog_len(self.stream)
                self._m_depth.set(depth)
                self._pump(depth)
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
        rest are answered with ``undecodable payload``."""
        out = []
        for eid, fields in entries:
            eid = eid if self.consumer_group else None
            uri = fields.get("uri")
            try:
                if not uri:
                    raise ValueError("record has no uri")
                arr = np.asarray(decode_payload(fields))
            except Exception:
                log.exception("undecodable record (uri=%r)", uri)
                self._drop_undecodable(uri, eid)
                continue
            out.append((_Rec(uri, fields.get("trace"), is_v2(fields), eid),
                        arr))
        return out

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
        t0 = time.perf_counter()
        try:
            async_fn = getattr(self.model, "predict_async", None)
            if async_fn is None:
                self._drain()
                preds = self.model.predict(batch)
                self._flush(_Pending(recs, lambda: preds, t0))
                return
            collect = async_fn(batch, block=False)
            while collect is None and self._pendings:
                # every permit is held by our own pending batches:
                # publish the oldest (releasing its permit) and retry
                self._flush(self._pendings.popleft())
                collect = async_fn(batch, block=False)
            if collect is None:
                collect = async_fn(batch)
        except Exception:
            log.exception("inference dispatch failed for %d records",
                          len(recs))
            self._record_failure(recs)
            return
        self._pendings.append(_Pending(recs, collect, t0))

    def _flush(self, pending: _Pending) -> None:
        """Read a dispatched batch back and hand it to the publisher."""
        recs, collect, t0 = pending
        try:
            preds = np.asarray(collect())[:len(recs)]
        except Exception:
            log.exception("inference failed for %d records", len(recs))
            self._record_failure(recs)
            return
        try:
            self._pub_queue.put((recs, preds, t0),
                                timeout=_PUB_PUT_TIMEOUT_S)
        except queue.Full:
            log.error("publisher queue still full after %.0fs; failing %d "
                      "record(s)", _PUB_PUT_TIMEOUT_S, len(recs))
            self._record_failure(recs, error="result publish failed")

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

    def _drop_undecodable(self, uri, eid) -> None:
        self._m_undecodable.inc()
        if uri:
            try:
                self.backend.set_result(uri, {"error": "undecodable payload"})
            except Exception:
                log.exception("undecodable-error record for %r could not "
                              "be written", uri)
                return
        self._ack([eid])

    def _record_failure(self, recs, error: str = "inference failed") -> None:
        self._m_failures.inc(len(recs))
        answered = []
        for rec in recs:
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
                self._record_failure(recs, error="result publish failed")

    def _publish(self, recs, preds, t0: float) -> None:
        results = {}
        for i, rec in enumerate(recs):
            if rec.v2:
                results[rec.uri] = encode_tensor(preds[i], key="value")
            else:
                results[rec.uri] = {"value": encode_array(preds[i])}
        self.backend.set_results(results)
        self._ack([rec.eid for rec in recs])
        self.served += len(recs)
        self._m_records.inc(len(recs))
        self._m_batches.inc()
        self._m_batch_size.observe(len(recs))
        self._m_dispatch.observe(max(time.perf_counter() - t0, 0.0))
