"""Serving queue backends — port of ``analytics_zoo_tpu/serving/
backend.py``, the transport under Cluster Serving (pure Python):

* ``LocalBackend`` — an in-process, thread-safe, bounded stream + result
  store with Redis-stream semantics (xadd/xread, consumer groups with a
  pending-entries list, xack, xautoclaim) and the fleet key-value surface
  (``fleet_set``/``fleet_all``/``fleet_del``) the replica heartbeats use;
* ``RedisBackend`` — the same contract against a Redis server: input
  stream entries and ``result:<uri>`` hashes, the group commands (XGROUP
  / XREADGROUP / XACK / XPENDING / XCLAIM) and the ``fleet:<stream>``
  hash, through redis-py when it is installed and otherwise through the
  in-repo RESP client (``serving/resp.py``).

The JAX package's fault-injection sites sit where it has them:
``backend.xadd``, ``backend.xread`` (at ``xreadgroup``), ``backend.xack``
and ``backend.xclaim`` on both backends; on ``LocalBackend`` also
``backend.xread`` at ``xread``, ``backend.stream_len``,
``backend.set_result`` and ``backend.set_results`` (which also takes
``partial_write``). Every wait is bounded: ``timeout=None`` means the
backend's ``default_timeout``, and ``RedisBackend``'s polls back off
through ``poll_policy``.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..common import faults
from ..common.reliability import RetryPolicy

__all__ = ["LocalBackend", "RedisBackend", "QueueFullError",
           "default_backend"]

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


def _invalidate_pending(backend: "RedisBackend", stream: str,
                        group: str) -> None:
    """Drop ``backend``'s cached PEL count of ``(stream, group)`` and count
    the invalidation, so a probe already on the wire does not cache its
    stale count (``RedisBackend.pending_len``)."""
    key = (stream, group)
    with backend._pending_lock:
        backend._pending_cache.pop(key, None)
        backend._pending_gen[key] = backend._pending_gen.get(key, 0) + 1


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
        #: stream -> {consumer: json payload} — replica heartbeats
        self._fleet: Dict[str, Dict[str, str]] = {}
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
        BUSYGROUP reply is likewise swallowed in ``RedisBackend``)."""
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
        exists for signature parity with ``RedisBackend``, where XLEN
        still counts delivered-but-unacked entries."""
        with self._lock:
            return len(self._streams.get(stream, []))

    # -- fleet key-value (replica heartbeats, serving/fleet.py) -------------
    def fleet_set(self, stream: str, consumer: str, payload: str) -> None:
        with self._lock:
            self._fleet.setdefault(stream, {})[consumer] = str(payload)

    def fleet_all(self, stream: str) -> Dict[str, str]:
        with self._lock:
            return dict(self._fleet.get(stream, {}))

    def fleet_del(self, stream: str, consumer: str) -> None:
        with self._lock:
            self._fleet.get(stream, {}).pop(consumer, None)

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


#: wire fields carried as binary end to end (Redis streams/hashes are
#: binary-safe): the v2 tensor payloads. Every other field (uri, trace,
#: dtype, shape, error text) is utf-8 text.
_BINARY_FIELDS = frozenset({"data", "value"})


class RedisBackend:
    """Same contract against a real Redis; keys match the reference: input
    stream entries + ``result:<uri>`` hashes
    (``serving/ClusterServing.scala:103-134``). Uses the redis-py client
    when installed, otherwise the in-repo RESP wire client
    (``serving/resp.py``) — no package dependency to talk to a real
    server. The ``data``/``value`` payload fields round-trip as raw
    bytes (wire-format v2); all other fields are text.

    The full-stream and result waits poll with jittered backoff through
    ``poll_policy`` (no fixed-interval spin hammering the server) and
    are bounded by ``default_timeout`` when the caller passes no
    timeout. Transport-level reconnects live one layer down, in the
    RESP client (``serving/resp.py``)."""

    def __init__(self, host: str = "localhost", port: int = 6379,
                 maxlen: int = 10000,
                 default_timeout: float = _DEFAULT_TIMEOUT,
                 poll_policy: Optional[RetryPolicy] = None):
        try:
            import redis
            self._r = redis.Redis(host=host, port=port)
            # redis-py's transport errors subclass RedisError, NOT the
            # builtin ConnectionError — normalize them (see _call) or the
            # breaker/retry classification upstream never engages
            self._driver_errors: Tuple[type, ...] = (
                redis.exceptions.ConnectionError,
                redis.exceptions.TimeoutError)
            self._is_resp = False
        except ImportError:
            from .resp import RespClient
            self._r = RespClient(host=host, port=port)
            self._driver_errors = ()    # RespClient raises builtins already
            self._is_resp = True
        self.maxlen = maxlen
        self.default_timeout = default_timeout
        #: backoff for the client-side polls (full stream, result wait):
        #: starts near the old 10 ms spin, backs off to 50 ms so a long
        #: wait costs dozens of round trips, not thousands
        self.poll_policy = poll_policy if poll_policy is not None \
            else RetryPolicy(base_delay=0.005, max_delay=0.05)
        self._last_id: Dict[str, str] = {}
        #: (stream, group) -> (monotonic, total) — bounds the XPENDING
        #: summaries behind the serve loop's depth probes (pre-read shed
        #: check, post-read gauge, heartbeat — each would otherwise be
        #: its own round trip). Invalidated on this instance's own
        #: reads/acks/claims, so local accounting stays exact; other
        #: replicas' settlements surface within the window
        self._pending_cache: Dict[Tuple[str, str], Tuple[float, int]] = {}
        self.pending_cache_s = 0.25
        #: (stream, group) -> invalidations so far: a probe caches its
        #: count only if none came while its XPENDING was on the wire
        #: (an ack racing a heartbeat's probe would otherwise leave the
        #: pre-ack count cached for the whole window)
        self._pending_gen: Dict[Tuple[str, str], int] = {}
        self._pending_lock = threading.Lock()

    def _call(self, fn, *args, **kwargs):
        """One driver call with driver-specific transport exceptions
        normalized to the builtin ``ConnectionError`` the reliability
        layer (serve-loop breaker, retry classification) keys on."""
        try:
            return fn(*args, **kwargs)
        except self._driver_errors as e:
            raise ConnectionError(f"{type(e).__name__}: {e}") from e

    def xadd(self, stream: str, fields: dict,
             timeout: Optional[float] = None) -> str:
        # same named fault site as LocalBackend.xadd, so the chaos
        # scenarios in test_chaos.py can also run against a live Redis
        faults.inject("backend.xadd")
        timeout = self.default_timeout if timeout is None else timeout
        if not self.poll_policy.wait_for(
                lambda: self._call(self._r.xlen, stream) < self.maxlen,
                timeout=timeout):
            raise QueueFullError(
                f"stream {stream!r} full ({self.maxlen}); inference is "
                f"not keeping up — dequeue or raise maxlen")
        return self._call(self._r.xadd, stream, fields).decode()

    def xread(self, stream: str, count: int,
              block_ms: int = 100) -> List[Tuple[str, dict]]:
        last = self._last_id.get(stream, "0")
        resp = self._call(self._r.xread, {stream: last}, count=count,
                          block=block_ms)
        out = []
        for _, entries in resp or []:
            for eid, fields in entries:
                eid = eid.decode()
                out.append((eid, self._decode_fields(fields)))
                self._last_id[stream] = eid
                self._call(self._r.xdel, stream, eid)
        return out

    # -- consumer groups ----------------------------------------------------
    def xgroup_create(self, stream: str, group: str) -> None:
        """XGROUP CREATE (from id 0, MKSTREAM); an already-existing
        group's BUSYGROUP reply is swallowed — creation is idempotent."""
        try:
            if self._is_resp:
                self._call(self._r.xgroup_create, stream, group)
            else:
                self._call(self._r.xgroup_create, stream, group, id="0",
                           mkstream=True)
        except ConnectionError:
            raise
        except Exception as e:
            if "BUSYGROUP" not in str(e):
                raise

    def xreadgroup(self, stream: str, group: str, consumer: str, count: int,
                   block_ms: int = 100) -> List[Tuple[str, dict]]:
        """XREADGROUP ``>``: deliver new entries to this consumer, into
        the group's PEL. Entries stay in the stream until the post-
        settlement :meth:`xack` deletes them. Same fault site as
        :meth:`xread` — one ``backend.xread`` per loop read."""
        faults.inject("backend.xread")
        resp = self._call(self._r.xreadgroup, group, consumer,
                          {stream: ">"}, count=count, block=block_ms)
        out = []
        for _, entries in resp or []:
            for eid, fields in entries:
                out.append((eid.decode() if isinstance(eid, bytes) else eid,
                            self._decode_fields(fields)))
        if out:
            _invalidate_pending(self, stream, group)
        return out

    def xack(self, stream: str, group: str, *entry_ids: str) -> int:
        """XDEL + XACK: settle the entries AND delete them from the
        stream, so XLEN tracks live work (undelivered + in-flight), not
        history. Both halves are idempotent — a re-ack counts 0.

        XDEL runs FIRST: a connection dropped between the two commands
        then leaves a stream-deleted entry still pending, which the next
        reclaim sweep finds and settles (:meth:`xautoclaim` acks
        nil-field tombstones). The reverse order would leak permanently
        — an acked-but-undeleted entry has left the PEL, is never
        redelivered (the group's last-delivered id already passed it),
        and occupies XLEN/maxlen capacity forever."""
        faults.inject("backend.xack")
        if not entry_ids:
            return 0
        self._call(self._r.xdel, stream, *entry_ids)
        n = int(self._call(self._r.xack, stream, group, *entry_ids))
        _invalidate_pending(self, stream, group)
        return n

    def xautoclaim(self, stream: str, group: str, consumer: str,
                   min_idle_ms: float, count: int = 100
                   ) -> List[Tuple[str, dict, str, int]]:
        """Survivor-side reclaim: XPENDING (idle-filtered, with owner and
        delivery count) then XCLAIM the candidate ids. XCLAIM only
        returns entries actually transferred — a racing survivor's claim
        reset their idle clock, so exactly one claimer wins each entry.
        Returns ``[(id, fields, previous_consumer, delivery_count)]``."""
        faults.inject("backend.xclaim")
        min_idle = int(min_idle_ms)
        if self._is_resp:
            pend = self._call(self._r.xpending_range, stream, group,
                              min_idle, count)
        else:
            pend = [(p["message_id"], p["consumer"], p["times_delivered"])
                    for p in self._call(
                        self._r.xpending_range, stream, group, min="-",
                        max="+", count=count, idle=min_idle)]
        if not pend:
            return []
        owners = {self._as_text(eid): (self._as_text(owner), int(times))
                  for eid, owner, times in pend}
        claimed = self._call(self._r.xclaim, stream, group, consumer,
                             min_idle, list(owners))
        _invalidate_pending(self, stream, group)
        out = []
        tombstones = []
        for eid, fields in claimed or []:
            eid = self._as_text(eid)
            if fields is None:
                # the message is gone from the stream (an ack whose
                # connection dropped between XDEL and XACK, or trimming):
                # nothing is left to re-answer, so settle the dangling
                # PEL entry instead of re-claiming it every sweep
                tombstones.append(eid)
                continue
            prev, times = owners.get(eid, ("?", 0))
            out.append((eid, self._decode_fields(fields), prev, times + 1))
        if tombstones:
            try:
                self._call(self._r.xack, stream, group, *tombstones)
            except (ConnectionError, OSError):
                pass            # the next sweep retries the settlement
        return out

    def xpending(self, stream: str, group: str) -> Dict[str, int]:
        """Per-consumer pending counts from the XPENDING summary form."""
        if self._is_resp:
            return self._call(self._r.xpending_summary, stream, group)
        info = self._call(self._r.xpending, stream, group)
        return {self._as_text(c["name"]): int(c["pending"])
                for c in (info.get("consumers") or [])}

    def pending_len(self, stream: str, group: str) -> int:
        """Total PEL size, cached for ``pending_cache_s`` (the depth
        probes behind shed checks / gauges / heartbeats call this up to
        several times per serve-loop iteration; each miss is an XPENDING
        round trip). This instance's own reads/acks/claims invalidate
        the cache, so the staleness window only covers OTHER replicas'
        activity: their reads move entries from backlog into the PEL (a
        stale low count overestimates backlog — errs toward shedding),
        their acks shrink XLEN and PEL together (the derived backlog
        clamps at 0 — errs toward flushing). Neither direction parks
        records, and both converge within the window."""
        key = (stream, group)
        now = time.monotonic()
        with self._pending_lock:
            hit = self._pending_cache.get(key)
            gen = self._pending_gen.get(key, 0)
        if hit is not None and now - hit[0] < self.pending_cache_s:
            return hit[1]
        n = sum(self.xpending(stream, group).values())
        with self._pending_lock:
            if self._pending_gen.get(key, 0) == gen:
                self._pending_cache[key] = (now, n)
        return n

    def backlog_len(self, stream: str, group: Optional[str] = None) -> int:
        """Undelivered backlog: XLEN minus the group's PEL (on real
        Redis, delivered-but-unacked entries still count in XLEN)."""
        n = int(self._call(self._r.xlen, stream))
        if group:
            n -= self.pending_len(stream, group)
        return max(n, 0)

    @staticmethod
    def _as_text(v) -> str:
        return v.decode() if isinstance(v, bytes) else str(v)

    # -- fleet key-value (replica heartbeats, serving/fleet.py) -------------
    def fleet_set(self, stream: str, consumer: str, payload: str) -> None:
        self._call(self._r.hset, f"fleet:{stream}",
                   mapping={consumer: payload})

    def fleet_all(self, stream: str) -> Dict[str, str]:
        vals = self._call(self._r.hgetall, f"fleet:{stream}")
        return {self._as_text(k): self._as_text(v)
                for k, v in (vals or {}).items()}

    def fleet_del(self, stream: str, consumer: str) -> None:
        self._call(self._r.hdel, f"fleet:{stream}", consumer)

    @staticmethod
    def _decode_fields(fields: Dict[bytes, bytes]) -> dict:
        """Field decode for stream entries / result hashes: keys are
        always text; payload fields stay bytes (see ``_BINARY_FIELDS``)."""
        out = {}
        for k, v in fields.items():
            key = k.decode()
            out[key] = v if key in _BINARY_FIELDS else v.decode()
        return out

    def stream_len(self, stream: str) -> int:
        return int(self._call(self._r.xlen, stream))

    def set_result(self, uri: str, fields: dict) -> None:
        self._call(self._r.hset, f"result:{uri}", mapping=fields)

    def set_results(self, results: Dict[str, dict]) -> None:
        """Batched result publish: ONE pipelined round trip for the whole
        batch (both redis-py and the in-repo RESP client expose the
        ``pipeline()`` surface) instead of one HSET round trip per
        record — the async publisher's write path."""
        if not results:
            return
        pipe = self._r.pipeline()
        for uri, fields in results.items():
            pipe.hset(f"result:{uri}", mapping=fields)
        self._call(pipe.execute)

    def pop_result(self, uri: str,
                   timeout: Optional[float] = None) -> Optional[dict]:
        timeout = self.default_timeout if timeout is None else timeout
        key = f"result:{uri}"
        found: List[Dict[bytes, bytes]] = []

        def check() -> bool:
            vals = self._call(self._r.hgetall, key)
            if vals:
                found.append(vals)
                return True
            return False

        if not self.poll_policy.wait_for(check, timeout=timeout):
            return None
        self._call(self._r.delete, key)
        return self._decode_fields(found[0])

    def pop_all_results(self) -> Dict[str, dict]:
        out = {}
        for key in self._call(self._r.keys, "result:*"):
            uri = key.decode().split(":", 1)[1]
            res = self.pop_result(uri, timeout=0)
            if res is not None:
                out[uri] = res
        return out
