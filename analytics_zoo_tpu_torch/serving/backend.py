"""Serving queue backend — port of ``LocalBackend`` from
``analytics_zoo_tpu/serving/backend.py``: an in-process, thread-safe,
bounded stream + result store with Redis-stream semantics (xadd/xread,
consumer groups with a pending-entries list, xack, xautoclaim), with the
JAX package's fault-injection sites (``backend.xadd``, ``backend.xread``
— ``xread`` and ``xreadgroup`` —, ``backend.xack``, ``backend.xclaim``,
``backend.stream_len``, ``backend.set_result``, ``backend.set_results``,
which also takes ``partial_write``). Pure Python and threads.
``RedisBackend`` is not ported yet.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..common import faults

__all__ = ["LocalBackend", "QueueFullError", "default_backend"]

#: bound applied when a caller passes ``timeout=None`` — an unbounded
#: producer/consumer wait turns a dead serve loop into a hung client
_DEFAULT_TIMEOUT = 30.0


class QueueFullError(RuntimeError):
    """Input stream at capacity and the enqueue timeout elapsed."""


class _PendingEntry:
    """One delivered-but-unacked entry in a group's PEL: who owns it,
    since when (monotonic), and how many times it has been delivered
    (first read + every reclaim)."""

    __slots__ = ("fields", "consumer", "delivered_at", "delivery_count")

    def __init__(self, fields: dict, consumer: str):
        self.fields = fields
        self.consumer = consumer
        self.delivered_at = time.monotonic()
        self.delivery_count = 1


_DEFAULT: Optional["LocalBackend"] = None
_DEFAULT_LOCK = threading.Lock()


def default_backend() -> "LocalBackend":
    """The process-wide LocalBackend that default-constructed InputQueue /
    OutputQueue / ClusterServing share — so the no-args client API actually
    communicates (mirroring the reference, where 'default' means the one
    local Redis)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = LocalBackend()
        return _DEFAULT


class LocalBackend:
    """In-process stream + result store with Redis-stream-like semantics.

    Waits are condition-based (no polling) and BOUNDED: ``timeout=None``
    means ``default_timeout``, not forever — ``xadd`` raises
    ``QueueFullError`` and ``pop_result`` returns None once it elapses.
    """

    def __init__(self, maxlen: int = 10000,
                 default_timeout: float = _DEFAULT_TIMEOUT):
        self.maxlen = maxlen
        self.default_timeout = default_timeout
        self._streams: Dict[str, List[Tuple[str, dict]]] = {}
        self._results: Dict[str, dict] = {}
        #: (stream, group) -> ordered PEL: entry id -> _PendingEntry
        self._pending: Dict[Tuple[str, str],
                            "collections.OrderedDict[str, _PendingEntry]"] \
            = {}
        self._lock = threading.Condition()
        self._seq = itertools.count()

    # -- stream ------------------------------------------------------------
    def _outstanding(self, stream: str, entries: List) -> int:
        """Total live work for one stream: undelivered backlog plus
        every group's delivered-but-unacked entries. This is what
        ``maxlen`` bounds — on real Redis XLEN counts in-flight entries
        too, so a consumer that reads but never settles (result store
        down) must still backpressure producers rather than let the PEL
        grow without bound. Caller holds the lock."""
        return len(entries) + sum(len(pel)
                                  for (s, _), pel in self._pending.items()
                                  if s == stream)

    def xadd(self, stream: str, fields: dict,
             timeout: Optional[float] = None) -> str:
        """Append; blocks while the stream holds ``maxlen`` unsettled
        entries (unread backlog + in-flight PEL, matching XLEN)."""
        faults.inject("backend.xadd")
        timeout = self.default_timeout if timeout is None else timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            entries = self._streams.setdefault(stream, [])
            while self._outstanding(stream, entries) >= self.maxlen:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise QueueFullError(
                        f"stream {stream!r} full ({self.maxlen}); inference "
                        f"is not keeping up — dequeue or raise maxlen")
                self._lock.wait(remaining)
            entry_id = f"{int(time.time() * 1000)}-{next(self._seq)}"
            entries.append((entry_id, dict(fields)))
            self._lock.notify_all()
            return entry_id

    def xread(self, stream: str, count: int,
              block_ms: int = 100) -> List[Tuple[str, dict]]:
        """Pop up to ``count`` entries, waiting up to ``block_ms`` for the
        first (consume-on-read: the serving loop is the only consumer group)."""
        faults.inject("backend.xread")
        deadline = time.monotonic() + block_ms / 1000.0
        with self._lock:
            entries = self._streams.setdefault(stream, [])
            while not entries:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._lock.wait(remaining)
            out = entries[:count]
            del entries[:count]
            self._lock.notify_all()  # wake blocked producers
            return out

    # -- consumer groups ----------------------------------------------------
    def xgroup_create(self, stream: str, group: str) -> None:
        """Idempotent: creating a group that exists is a no-op (the Redis
        BUSYGROUP reply is likewise swallowed by a Redis backend)."""
        with self._lock:
            self._pending.setdefault((stream, group), collections.OrderedDict())
            self._streams.setdefault(stream, [])

    def xreadgroup(self, stream: str, group: str, consumer: str, count: int,
                   block_ms: int = 100) -> List[Tuple[str, dict]]:
        """Deliver up to ``count`` undelivered entries to ``consumer``,
        tracking each in the group's PEL until :meth:`xack`. Fires the
        same ``backend.xread`` fault site as :meth:`xread` — one site per
        loop read, whichever mode the server runs in."""
        faults.inject("backend.xread")
        deadline = time.monotonic() + block_ms / 1000.0
        with self._lock:
            pel = self._pending.setdefault((stream, group),
                                           collections.OrderedDict())
            entries = self._streams.setdefault(stream, [])
            while not entries:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._lock.wait(remaining)
            out = entries[:count]
            del entries[:count]
            for eid, fields in out:
                pel[eid] = _PendingEntry(fields, consumer)
            self._lock.notify_all()  # wake blocked producers
            return out

    def xack(self, stream: str, group: str, *entry_ids: str) -> int:
        """Settle delivered entries: remove them from the group's PEL.
        Idempotent — acking a gone id counts 0. Returns how many were
        actually removed."""
        faults.inject("backend.xack")
        removed = 0
        with self._lock:
            pel = self._pending.get((stream, group))
            if pel:
                for eid in entry_ids:
                    removed += pel.pop(eid, None) is not None
            if removed:
                self._lock.notify_all()  # settlement frees xadd capacity
        return removed

    def xautoclaim(self, stream: str, group: str, consumer: str,
                   min_idle_ms: float, count: int = 100
                   ) -> List[Tuple[str, dict, str, int]]:
        """Transfer ownership of up to ``count`` pending entries whose
        idle time passed ``min_idle_ms`` to ``consumer`` (oldest first;
        redis XAUTOCLAIM semantics: the claimer may be the current owner
        — a replica re-claims its OWN entries after a lost reply). The
        claim resets the idle clock and bumps the delivery count, so two
        racing survivors can never both win one entry. Returns
        ``[(entry_id, fields, previous_consumer, delivery_count), ...]``."""
        faults.inject("backend.xclaim")
        now = time.monotonic()
        claimed = []
        with self._lock:
            pel = self._pending.get((stream, group))
            if pel:
                for eid, pe in pel.items():
                    if len(claimed) >= count:
                        break
                    if (now - pe.delivered_at) * 1000.0 < min_idle_ms:
                        continue
                    prev = pe.consumer
                    pe.consumer = consumer
                    pe.delivered_at = now
                    pe.delivery_count += 1
                    claimed.append((eid, pe.fields, prev, pe.delivery_count))
        return claimed

    def xpending(self, stream: str, group: str) -> Dict[str, int]:
        """Per-consumer pending-entry counts for one group (the scaling
        signal on /statusz and the chaos tests' kill-window census)."""
        out: Dict[str, int] = {}
        with self._lock:
            for pe in self._pending.get((stream, group), {}).values():
                out[pe.consumer] = out.get(pe.consumer, 0) + 1
        return out

    def pending_len(self, stream: str, group: str) -> int:
        with self._lock:
            return len(self._pending.get((stream, group), {}))

    def backlog_len(self, stream: str, group: Optional[str] = None) -> int:
        """Entries a new read would see (undelivered backlog). For
        ``LocalBackend`` this equals :meth:`stream_len` — delivered
        entries left the stream list for the PEL; the ``group`` arg
        exists for signature parity with a Redis backend, where XLEN
        still counts delivered-but-unacked entries."""
        with self._lock:
            return len(self._streams.get(stream, []))

    def stream_len(self, stream: str) -> int:
        faults.inject("backend.stream_len")
        with self._lock:
            return len(self._streams.get(stream, []))

    # -- results -----------------------------------------------------------
    def set_result(self, uri: str, fields: dict) -> None:
        faults.inject("backend.set_result")
        with self._lock:
            self._results[uri] = dict(fields)
            self._lock.notify_all()

    def set_results(self, results: Dict[str, dict]) -> None:
        """Publish a whole batch of result records under ONE lock
        acquisition / wakeup — the async publisher's batched write path
        (per-record ``set_result`` costs a lock round-trip and a
        ``notify_all`` each)."""
        if not results:
            return
        spec = faults.inject("backend.set_results")
        if spec is not None and spec.kind == "partial_write":
            # the injected mid-write crash: apply a prefix of the batch,
            # then fail like a dropped connection would
            uris = list(results)
            keep = uris[:max(int(len(uris) * spec.fraction), 0)]
            with self._lock:
                for uri in keep:
                    self._results[uri] = dict(results[uri])
                self._lock.notify_all()
            raise ConnectionError(
                f"injected partial write: {len(keep)}/{len(uris)} applied")
        with self._lock:
            for uri, fields in results.items():
                self._results[uri] = dict(fields)
            self._lock.notify_all()

    def pop_result(self, uri: str,
                   timeout: Optional[float] = None) -> Optional[dict]:
        timeout = self.default_timeout if timeout is None else timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while uri not in self._results:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return None
                self._lock.wait(remaining)
            return self._results.pop(uri)

    def pop_all_results(self) -> Dict[str, dict]:
        with self._lock:
            out, self._results = self._results, {}
            return out
