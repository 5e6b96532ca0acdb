"""Durable dead-letter queue — port of ``analytics_zoo_tpu/serving/
dlq.py``, the same on-disk format byte for byte, so either package reads
and replays the other's directory.

The serve loop and the publisher spill records serving gives up on (a
dispatch poison record, a lane whose breaker opened, a batch the
publisher could not write) with their full request — uri, trace, reason,
error, lane and the v2 tensor payload — and an operator replays them
onto the input stream after the outage clears.

On-disk format:

* one directory per queue; records append to **segments** named
  ``dlq-<epoch_ms>-<seq>.jsonl`` (``.open`` while the writer owns it;
  sealed, by an atomic rename, on rotation or close),
* each line is **CRC-framed**: ``<crc32 hex8> <json>`` over the JSON
  bytes — a torn tail write fails its frame and is skipped and counted,
* appends are **fsynced**,
* total bytes are **bounded** (``max_bytes``): the oldest non-active
  segment is evicted first (``.replayed`` receipts before work), each
  dropped record counted in ``zoo_serving_dlq_evicted_total``.

Replay is **at-most-once** per segment: the segment is renamed
``*.replayed`` before any record is re-enqueued. Re-enqueued records
carry fresh trace ids, the original kept as ``replay_of``, and their
``model`` field, so a multi-model server routes them back to their lane.

Metrics: ``zoo_serving_dlq_records`` / ``zoo_serving_dlq_bytes`` gauges,
``zoo_serving_dlq_spilled_total{reason=}``,
``zoo_serving_dlq_evicted_total``, ``zoo_serving_dlq_corrupt_total``,
``zoo_serving_dlq_replayed_total``. The operator CLI, ``python -m
analytics_zoo_tpu_torch.serving.dlq_cli`` (the port of ``zoo-dlq``),
lists, inspects, purges and replays a directory over RESP.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import threading
import time
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..observability import default_registry, new_trace_id
from .client import INPUT_STREAM, encode_tensor

log = logging.getLogger("analytics_zoo_tpu_torch.serving.dlq")

__all__ = ["DeadLetterQueue", "SEGMENT_PREFIX"]

SEGMENT_PREFIX = "dlq-"
_OPEN, _SEALED, _REPLAYED = "open", "sealed", "replayed"

#: sort/evict/replay order is the segment's name (epoch ms + a process
#: sequence number) — append order, oldest first
_SUFFIXES = {".jsonl.open": _OPEN, ".jsonl.replayed": _REPLAYED,
             ".jsonl": _SEALED}


def _segment_state(name: str) -> Optional[str]:
    if not name.startswith(SEGMENT_PREFIX):
        return None
    for suffix, state in _SUFFIXES.items():
        if name.endswith(suffix):
            return state
    return None


def _base_name(name: str) -> str:
    """Segment identity independent of its lifecycle suffix."""
    for suffix in (".open", ".replayed"):
        if name.endswith(suffix):
            return name[:-len(suffix)]
    return name


class DeadLetterQueue:
    """One durable dead-letter directory: thread-safe appends from the
    serve loop and the publisher, segment lifecycle (open → sealed →
    replayed), bounded total bytes, and the replay/purge surface the
    ``zoo-dlq`` CLI wraps."""

    def __init__(self, directory: str, max_bytes: int = 64 << 20,
                 segment_bytes: int = 8 << 20, registry=None,
                 fsync: bool = True):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1 ({max_bytes})")
        self.directory = directory
        self.max_bytes = int(max_bytes)
        self.segment_bytes = int(segment_bytes)
        self.fsync = bool(fsync)
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._seq = 0
        self._active: Optional[str] = None      # active segment file name
        self._active_f = None
        self._active_bytes = 0
        self._active_records = 0
        m = registry if registry is not None else default_registry()
        self.metrics = m
        self._m_records = m.gauge(
            "zoo_serving_dlq_records",
            "replayable dead-lettered records on disk (open + sealed "
            "segments)")
        self._m_bytes = m.gauge(
            "zoo_serving_dlq_bytes",
            "total dead-letter-queue bytes on disk, replayed receipts "
            "included")
        self._m_evicted = m.counter(
            "zoo_serving_dlq_evicted_total",
            "dead-lettered records dropped by oldest-segment eviction "
            "(the DLQ hit its disk bound)")
        self._m_corrupt = m.counter(
            "zoo_serving_dlq_corrupt_total",
            "DLQ lines skipped for a CRC/JSON frame failure (torn tail "
            "writes)")
        self._m_replayed = m.counter(
            "zoo_serving_dlq_replayed_total",
            "dead-lettered records re-enqueued onto the input stream")
        # the dead-letter reasons are a closed label set; pre-creating
        # the counters keeps the spill path allocation-free and the
        # label values statically enumerable. "other"
        # absorbs foreign reason strings a future caller might pass —
        # never misattributed to a real category, and the spilled
        # record itself keeps the exact string
        self._spilled = {
            reason: m.counter(
                "zoo_serving_dlq_spilled_total",
                "records spilled to the on-disk dead-letter queue, by "
                "dead-letter reason",
                labels={"reason": reason})
            for reason in ("dispatch", "publish", "other")}
        # incrementally-maintained totals: the append path must stay
        # O(1) — a full directory rescan per spill would go quadratic
        # during the very outage the DLQ exists to absorb. One scan at
        # construction seeds them; append/evict/replay/purge adjust.
        # They are PER-INSTANCE: a zoo-dlq CLI mutating this directory
        # from another process is folded back in lazily — the byte total
        # re-seeds from the filesystem before any eviction decision
        # (never evict on a phantom count), and the record gauge
        # self-corrects at the next construction/replay of this handle.
        self._disk_bytes = 0
        self._replayable = 0
        for s in self.segments():
            self._disk_bytes += s["bytes"]
            if s["state"] != _REPLAYED:
                self._replayable += s["records"]
        self._refresh_gauges()

    # -- survey --------------------------------------------------------------
    def segments(self) -> List[Dict[str, object]]:
        """Oldest-first inventory: ``{"name", "state", "bytes",
        "records", "corrupt"}`` per segment. Counting records reads each
        file once — cheap for an operator surface, not a hot path."""
        out = []
        for name in sorted(os.listdir(self.directory), key=_base_name):
            state = _segment_state(name)
            if state is None:
                continue
            path = os.path.join(self.directory, name)
            records = corrupt = 0
            for rec in self._scan_file(path, count_corrupt=False):
                if rec is None:
                    corrupt += 1
                else:
                    records += 1
            out.append({"name": name, "state": state,
                        "bytes": os.path.getsize(path),
                        "records": records, "corrupt": corrupt})
        return out

    @property
    def depth(self) -> int:
        """Replayable records (open + sealed segments)."""
        return sum(s["records"] for s in self.segments()
                   if s["state"] != _REPLAYED)

    @property
    def total_bytes(self) -> int:
        return sum(s["bytes"] for s in self.segments())

    # -- append --------------------------------------------------------------
    def append(self, uri: str, tensor, reason: str,
               trace: Optional[str] = None,
               error: Optional[str] = None,
               model: Optional[str] = None) -> None:
        """Spill one dead-lettered record durably. ``tensor`` is the
        original request payload (any ndarray-like); ``reason`` labels
        the spill counter (``dispatch`` / ``publish``); ``model`` is the
        lane the record was routed to on a multiplexed server — replay
        re-stamps it so the record goes back to the SAME model. Raises
        on an unwritable directory — the CALLER decides whether losing
        the record is acceptable (the serve loop logs and answers the
        producer either way)."""
        fields = encode_tensor(np.asarray(tensor))
        rec = {
            "uri": uri,
            "trace": trace,
            "reason": reason,
            "error": error,
            "ts_ms": int(time.time() * 1000),
            "data": base64.b64encode(fields["data"]).decode("ascii"),
            "dtype": fields["dtype"],
            "shape": fields["shape"],
            "v": fields["v"],
        }
        if model:
            rec["model"] = str(model)
        payload = json.dumps(rec, separators=(",", ":")).encode("utf-8")
        line = b"%08x " % (zlib.crc32(payload) & 0xFFFFFFFF) + payload + b"\n"
        with self._lock:
            f = self._writer(len(line))
            f.write(line)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
            self._active_bytes += len(line)
            self._active_records += 1
            self._disk_bytes += len(line)
            self._replayable += 1
            if self._disk_bytes > self.max_bytes:
                self._evict_over_bound()
        self._spilled.get(reason, self._spilled["other"]).inc()
        self._refresh_gauges()
        self.metrics.emit("serving.dlq_spill", uri=uri, trace=trace,
                          reason=reason, error=error)

    def _writer(self, incoming: int):
        """The active segment's file handle, rotating first when the
        incoming line would push it past ``segment_bytes``. Call under
        the lock."""
        if (self._active_f is not None
                and self._active_bytes + incoming > self.segment_bytes):
            self._seal_active_locked()
        if self._active_f is None:
            self._seq += 1
            name = (f"{SEGMENT_PREFIX}{int(time.time() * 1000)}"
                    f"-{self._seq:04d}.jsonl.open")
            self._active = name
            self._active_f = open(os.path.join(self.directory, name), "ab")
            self._active_bytes = 0
            self._active_records = 0
        return self._active_f

    def _seal_active_locked(self) -> None:
        """open → sealed: close the handle and atomically drop the
        ``.open`` suffix — the rename publishes "no writer owns this
        segment anymore" to replaying readers."""
        if self._active_f is None:
            return
        self._active_f.close()
        path = os.path.join(self.directory, self._active)
        os.replace(path, path[:-len(".open")])
        self._active = None
        self._active_f = None
        self._active_bytes = 0
        self._active_records = 0

    def _evict_over_bound(self) -> None:
        """Drop oldest non-active segments until the directory fits
        ``max_bytes``: ``.replayed`` receipts first (they hold no work),
        then the oldest sealed work. Call under the lock; the append
        path only enters here once ``_disk_bytes`` crossed the bound, so
        the directory walk is paid on overflow, never per spill.

        The walk also RE-SEEDS ``_disk_bytes`` from the filesystem
        before deciding anything: the ``zoo-dlq`` CLI may have replayed
        or purged segments out from under this instance's incremental
        counter, and evicting live work off a phantom total would
        destroy exactly the dead letters the bound exists to protect."""
        entries = []
        fresh_bytes = self._active_bytes if self._active_f is not None else 0
        for name in os.listdir(self.directory):
            state = _segment_state(name)
            if state is None:
                continue
            size = os.path.getsize(os.path.join(self.directory, name))
            fresh_bytes += 0 if name == self._active else size
            if state == _OPEN or name == self._active:
                # a foreign live writer may own a non-active .open (two
                # servers sharing a DLQ dir is a misconfiguration, but
                # unlinking its inode would silently swallow its future
                # spills) — leave it; the bytes gauge shows the overshoot
                continue
            entries.append((state != _REPLAYED, _base_name(name),
                            name, size, state))
        self._disk_bytes = fresh_bytes
        entries.sort()      # replayed receipts first, then oldest work
        for _work, _base, name, size, state in entries:
            if self._disk_bytes <= self.max_bytes:
                break
            path = os.path.join(self.directory, name)
            dropped = 0
            if state != _REPLAYED:
                dropped = sum(1 for r in self._scan_file(
                    path, count_corrupt=False) if r is not None)
                log.warning("DLQ over its %d-byte bound; evicting oldest "
                            "segment %s (%d records lost)", self.max_bytes,
                            name, dropped)
                self._m_evicted.inc(dropped)
            os.unlink(path)
            self._disk_bytes -= size
            self._replayable -= dropped
            if dropped:
                self.metrics.emit("serving.dlq_evict", segment=name,
                                  records=dropped)

    def _refresh_gauges(self) -> None:
        self._m_records.set(max(self._replayable, 0))
        self._m_bytes.set(max(self._disk_bytes, 0))

    # -- read ----------------------------------------------------------------
    def _scan_file(self, path: str,
                   count_corrupt: bool = True) -> Iterator[Optional[dict]]:
        """Yield each frame's record dict, or None for a line that fails
        its CRC/JSON frame (torn tail append)."""
        try:
            with open(path, "rb") as f:
                for raw in f:
                    rec = self._parse_line(raw)
                    if rec is None and count_corrupt:
                        self._m_corrupt.inc()
                    yield rec
        except FileNotFoundError:
            return

    @staticmethod
    def _parse_line(raw: bytes) -> Optional[dict]:
        raw = raw.rstrip(b"\n")
        if not raw:
            return None
        try:
            crc_hex, payload = raw.split(b" ", 1)
            if int(crc_hex, 16) != zlib.crc32(payload) & 0xFFFFFFFF:
                return None
            return json.loads(payload)
        except (ValueError, json.JSONDecodeError):
            return None

    def scan(self, segment: Optional[str] = None,
             include_replayed: bool = False
             ) -> Iterator[Tuple[str, dict]]:
        """Yield ``(segment_name, record)`` oldest-first across the
        queue (or one ``segment``). Corrupt frames are counted and
        skipped."""
        for s in self.segments():
            if segment is not None and s["name"] != segment \
                    and _base_name(s["name"]) != _base_name(segment):
                continue
            if s["state"] == _REPLAYED and not include_replayed:
                continue
            path = os.path.join(self.directory, s["name"])
            for rec in self._scan_file(path):
                if rec is not None:
                    yield s["name"], rec

    # -- replay / purge ------------------------------------------------------
    def replay(self, backend, stream: str = INPUT_STREAM,
               segment: Optional[str] = None,
               uris: Optional[List[str]] = None,
               include_open: bool = False,
               rate: Optional[float] = None,
               sleep=time.sleep) -> int:
        """Re-enqueue dead-lettered records onto the input stream with
        FRESH trace ids (``replay_of`` carries the original id so the
        event log links both lifetimes). At-most-once: each segment is
        renamed ``*.replayed`` BEFORE its first record is re-enqueued —
        a crash mid-replay under-delivers, never double-delivers.

        ``rate`` (records/second, ``zoo-dlq replay --rate N``) paces the
        re-enqueues on a fixed schedule (record i is enqueued no earlier
        than ``i/rate`` seconds after the first) so a large replay
        cannot itself stand the backlog above the server's shed
        watermark and re-dead-letter the very records being recovered.
        Unpaced replay (the default) is the drain-at-full-speed mode
        for a server with shedding off or ample headroom.

        This instance's OWN active segment is sealed first (it holds the
        writer, so that is always safe); other ``.open`` segments on
        disk belong to some other process's writer and are skipped
        unless ``include_open`` (which seals them too — only safe when
        the owning server is stopped; the CLI makes the operator say so
        explicitly). A ``uris`` filter
        re-enqueues only matching records but still retires the whole
        segment — the skipped records are abandoned, and the count is
        logged loudly. Returns the number of records re-enqueued."""
        if rate is not None and rate <= 0:
            # validated before ANY side effect: sealing/renaming happens
            # below, and a rejected argument must leave the directory
            # exactly as it found it
            raise ValueError(f"replay rate must be > 0 records/s ({rate})")
        with self._lock:
            self._seal_active_locked()
            targets = []
            for s in self.segments():
                if segment is not None \
                        and _base_name(s["name"]) != _base_name(segment):
                    continue
                if s["state"] == _REPLAYED:
                    continue
                if s["state"] == _OPEN:
                    if not include_open:
                        log.warning("skipping open segment %s (a live "
                                    "server may still be appending; pass "
                                    "include_open once it is stopped)",
                                    s["name"])
                        continue
                    path = os.path.join(self.directory, s["name"])
                    sealed = path[:-len(".open")]
                    os.replace(path, sealed)
                    s = dict(s, name=os.path.basename(sealed))
                targets.append(s["name"])
        replayed = skipped = 0
        t0 = time.monotonic()
        for name in targets:
            path = os.path.join(self.directory, name)
            done = path + ".replayed"
            # the commit marker: rename BEFORE any re-enqueue
            os.replace(path, done)
            for rec in self._scan_file(done):
                if rec is None:
                    continue
                with self._lock:
                    self._replayable -= 1   # retired, replayed or not
                if uris is not None and rec.get("uri") not in uris:
                    skipped += 1
                    continue
                fields = {
                    "data": base64.b64decode(rec["data"]),
                    "dtype": rec["dtype"],
                    "shape": rec["shape"],
                    "v": rec.get("v", "2"),
                    "uri": rec["uri"],
                    "trace": new_trace_id(),
                }
                if rec.get("trace"):
                    fields["replay_of"] = rec["trace"]
                if rec.get("model"):
                    # multiplexed servers route by this field: the
                    # replayed record must land on the SAME lane
                    fields["model"] = rec["model"]
                if rate is not None and replayed:
                    # fixed schedule, not inter-record gaps: a slow xadd
                    # does not compound the pace, and the total duration
                    # is deterministic at (n-1)/rate from the first send
                    due = t0 + replayed / rate
                    delay = due - time.monotonic()
                    if delay > 0:
                        sleep(delay)
                backend.xadd(stream, fields)
                replayed += 1
        if skipped:
            log.warning("replay retired %d record(s) without re-enqueueing "
                        "them (uri filter): their segments are marked "
                        ".replayed and they will never be served", skipped)
        if replayed:
            self._m_replayed.inc(replayed)
            self.metrics.emit("serving.dlq_replay", records=replayed,
                              segments=len(targets), skipped=skipped)
        self._refresh_gauges()
        return replayed

    def purge(self, replayed_only: bool = True) -> int:
        """Delete segments; by default only ``.replayed`` receipts.
        ``replayed_only=False`` deletes UNREPLAYED work too (the
        operator's explicit give-up). FOREIGN ``.open`` segments are
        never touched: another process's live writer keeps its fd, so
        an unlink would silently sink every spill it makes until its
        next rotation — not just drop existing work. Returns segments
        removed."""
        removed = 0
        with self._lock:
            if not replayed_only:
                self._seal_active_locked()
            for s in self.segments():
                if replayed_only and s["state"] != _REPLAYED:
                    continue
                if s["name"] == self._active:
                    continue
                if s["state"] == _OPEN:
                    log.warning(
                        "purge: skipping open segment %s — a live server "
                        "may own its writer (an unlinked inode would "
                        "swallow its future spills); stop the server and "
                        "replay/purge again", s["name"])
                    continue
                os.unlink(os.path.join(self.directory, s["name"]))
                removed += 1
                self._disk_bytes -= s["bytes"]
                if s["state"] != _REPLAYED:
                    self._replayable -= s["records"]
        self._refresh_gauges()
        return removed

    def close(self) -> None:
        """Seal the active segment (making it replayable) and release
        the handle. Idempotent."""
        with self._lock:
            self._seal_active_locked()
        self._refresh_gauges()
