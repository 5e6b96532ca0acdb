"""TensorBoard event-file writer/reader — a copy of ``analytics_zoo_tpu/
utils/tensorboard.py`` (numpy only); parity with the reference's
``zoo/common/tensorboard/FileWriter.scala`` + ``EventWriter.scala`` (which
wrap TF's Java proto classes) and the ``setTensorBoard`` / ``getTrainSummary``
/ ``getValidationSummary`` surface of ``keras/engine/Topology.scala:204-236``.

Re-designed dependency-free: TensorBoard's on-disk format is just a TFRecord
stream of serialized ``tensorflow.Event`` protos, and the two messages we need
(Event{wall_time, step, file_version | summary{value{tag, simple_value}}})
are small enough to encode by hand — so this module writes bytes directly:

* TFRecord framing: ``uint64 len | masked_crc32c(len) | data |
  masked_crc32c(data)`` with the Castagnoli CRC and TF's mask rotation.
* Proto wire format: field tags ``(num << 3) | wire_type`` with varint (0),
  64-bit (1), length-delimited (2), 32-bit (5) payloads.

The reader side parses the same framing back (verifying both CRCs), which is
what ``get_train_summary`` uses — and doubles as proof the files are
TensorBoard-readable.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .proto import (field_bytes as _field_bytes,
                    field_double as _field_double,
                    field_float as _field_float,
                    field_varint as _field_varint,
                    parse_fields as _parse_fields,
                    parse_varint as _parse_varint)

__all__ = ["EventFileWriter", "TrainSummary", "ValidationSummary",
           "read_scalars", "read_histograms"]


# ---------------------------------------------------------------------------
# crc32c (Castagnoli, table-driven) + TF's masking
# ---------------------------------------------------------------------------

def _make_crc32c_table() -> List[int]:
    poly = 0x82F63B78  # reversed Castagnoli polynomial
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table.append(crc)
    return table


_CRC_TABLE = _make_crc32c_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal proto encoding (event.proto / summary.proto subset)
# ---------------------------------------------------------------------------

def _scalar_event(wall_time: float, step: int, tag: str,
                  value: float) -> bytes:
    # Summary.Value{ tag=1, simple_value=2 } inside Summary{ value=1 }
    sv = _field_bytes(1, tag.encode("utf-8")) + _field_float(2, float(value))
    summary = _field_bytes(1, sv)
    # Event{ wall_time=1, step=2, summary=5 }
    return (_field_double(1, wall_time) + _field_varint(2, int(step))
            + _field_bytes(5, summary))


def _version_event(wall_time: float) -> bytes:
    # Event{ wall_time=1, file_version=3 }
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


def _packed_doubles(xs) -> bytes:
    return b"".join(struct.pack("<d", float(x)) for x in xs)


def _histogram_event(wall_time: float, step: int, tag: str,
                     values: np.ndarray) -> bytes:
    """Event carrying a HistogramProto (the reference writes these for
    weight/gradient distributions — ``Summary.scala`` histogram path,
    enabled via ``setSummaryTrigger("Parameters", ...)``)."""
    raw = np.asarray(values, np.float64).ravel()
    # stats cover FINITE values only: np.histogram raises on NaN/inf, and
    # a diverged run is exactly when the user needs the diagnostics — so
    # non-finite weights degrade to a degenerate histogram rather than
    # crash fit() from the logging path
    v = raw[np.isfinite(raw)]
    if v.size == 0:
        v = np.zeros(1)
    vmin, vmax = float(v.min()), float(v.max())
    if vmin == vmax:
        limits, counts = [vmax], [float(v.size)]
    else:
        c, edges = np.histogram(v, bins=30)
        limits, counts = edges[1:].tolist(), c.astype(np.float64).tolist()
    # HistogramProto{ min=1 max=2 num=3 sum=4 sum_squares=5
    #                 bucket_limit=6 packed, bucket=7 packed }
    histo = (_field_double(1, vmin) + _field_double(2, vmax)
             + _field_double(3, float(v.size))
             + _field_double(4, float(v.sum()))
             + _field_double(5, float((v * v).sum()))
             + _field_bytes(6, _packed_doubles(limits))
             + _field_bytes(7, _packed_doubles(counts)))
    # Summary.Value{ tag=1, histo=5 }
    sv = _field_bytes(1, tag.encode("utf-8")) + _field_bytes(5, histo)
    summary = _field_bytes(1, sv)
    return (_field_double(1, wall_time) + _field_varint(2, int(step))
            + _field_bytes(5, summary))


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class EventFileWriter:
    """Appends TFRecord-framed Event protos to one
    ``events.out.tfevents.<ts>.<host>`` file (``EventWriter.scala``
    equivalent; thread-safe, explicit ``flush``)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._lock = threading.Lock()
        self._write(_version_event(time.time()))

    def _write(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        rec = (header + struct.pack("<I", _masked_crc(header))
               + event + struct.pack("<I", _masked_crc(event)))
        with self._lock:
            self._f.write(rec)

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        self._write(_scalar_event(wall_time if wall_time is not None
                                  else time.time(), step, tag, value))

    def add_histogram(self, tag: str, values, step: int,
                      wall_time: Optional[float] = None) -> None:
        self._write(_histogram_event(wall_time if wall_time is not None
                                     else time.time(), step, tag,
                                     np.asarray(values)))

    def flush(self) -> None:
        with self._lock:
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._f.flush()
            self._f.close()


# ---------------------------------------------------------------------------
# reader (used by get_train_summary / get_validation_summary)
# ---------------------------------------------------------------------------

def _read_records(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != _masked_crc(header):
                raise IOError(f"corrupt record header in {path}")
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if dcrc != _masked_crc(data):
                raise IOError(f"corrupt record payload in {path}")
            yield data


def _iter_summary_values(log_dir: str):
    """Yield ``(step, wall_time, value_payload)`` for every Summary.Value
    in every event file under ``log_dir`` — the Event-envelope decoding
    shared by :func:`read_scalars` and :func:`read_histograms` (one place
    owns the TFRecord/Event framing rules)."""
    for fname in sorted(os.listdir(log_dir)):
        if "tfevents" not in fname:
            continue
        for rec in _read_records(os.path.join(log_dir, fname)):
            wall, step, summary = 0.0, 0, None
            for num, wt, payload in _parse_fields(rec):
                if num == 1 and wt == 1:
                    (wall,) = struct.unpack("<d", payload)
                elif num == 2 and wt == 0:
                    step, _ = _parse_varint(payload, 0)
                elif num == 5 and wt == 2:
                    summary = payload
            if summary is None:
                continue
            for num, wt, val in _parse_fields(summary):
                if num == 1 and wt == 2:
                    yield step, wall, val


def read_scalars(log_dir: str, tag: Optional[str] = None
                 ) -> List[Tuple[int, float, float, str]]:
    """All scalar points under ``log_dir`` as ``(step, value, wall_time,
    tag)``, sorted by step — the ``readScalar`` analogue."""
    points = []
    for step, wall, val in _iter_summary_values(log_dir):
        vtag, simple = "", None
        for n2, w2, p2 in _parse_fields(val):
            if n2 == 1 and w2 == 2:
                vtag = p2.decode("utf-8")
            elif n2 == 2 and w2 == 5:
                (simple,) = struct.unpack("<f", p2)
        if simple is not None and (tag is None or vtag == tag):
            points.append((step, simple, wall, vtag))
    points.sort(key=lambda p: (p[0], p[2]))
    return points


def _unpack_doubles(payload: bytes) -> List[float]:
    return [x[0] for x in struct.iter_unpack("<d", payload)]


def read_histograms(log_dir: str, tag: Optional[str] = None
                    ) -> List[Tuple[int, dict, float, str]]:
    """All histogram points under ``log_dir`` as ``(step, stats, wall_time,
    tag)`` where ``stats`` has min/max/num/sum/sum_squares/bucket_limit/
    bucket — the histogram-side ``readScalar`` analogue."""
    points = []
    for step, wall, val in _iter_summary_values(log_dir):
        vtag, histo = "", None
        for n2, w2, p2 in _parse_fields(val):
            if n2 == 1 and w2 == 2:
                vtag = p2.decode("utf-8")
            elif n2 == 5 and w2 == 2:
                histo = p2
        if histo is None or (tag is not None and vtag != tag):
            continue
        stats = {"min": 0.0, "max": 0.0, "num": 0.0, "sum": 0.0,
                 "sum_squares": 0.0, "bucket_limit": [], "bucket": []}
        keys = {1: "min", 2: "max", 3: "num", 4: "sum", 5: "sum_squares"}
        for n3, w3, p3 in _parse_fields(histo):
            if n3 in keys and w3 == 1:
                (stats[keys[n3]],) = struct.unpack("<d", p3)
            elif n3 == 6 and w3 == 2:
                stats["bucket_limit"] = _unpack_doubles(p3)
            elif n3 == 7 and w3 == 2:
                stats["bucket"] = _unpack_doubles(p3)
        points.append((step, stats, wall, vtag))
    points.sort(key=lambda p: (p[0], p[2]))
    return points


# ---------------------------------------------------------------------------
# TrainSummary / ValidationSummary (Topology.scala:204-236 surface)
# ---------------------------------------------------------------------------

class _Summary:
    sub_dir = ""

    def __init__(self, log_dir: str, app_name: str):
        self.log_dir = os.path.join(log_dir, app_name, self.sub_dir)
        self.writer = EventFileWriter(self.log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.writer.add_scalar(tag, value, step)

    def add_histogram(self, tag: str, values, step: int) -> None:
        self.writer.add_histogram(tag, values, step)

    def read_scalar(self, tag: str) -> np.ndarray:
        """(n, 3) array of ``[step, value, wall_time]`` rows for ``tag``."""
        self.writer.flush()
        pts = read_scalars(self.log_dir, tag)
        if not pts:
            return np.zeros((0, 3), np.float64)
        return np.asarray([[s, v, w] for s, v, w, _ in pts], np.float64)

    def read_histogram(self, tag: str):
        """``(step, stats)`` pairs for ``tag`` (see :func:`read_histograms`)."""
        self.writer.flush()
        return [(s, st) for s, st, _, t in read_histograms(self.log_dir, tag)]

    def close(self) -> None:
        self.writer.close()


class TrainSummary(_Summary):
    """Per-iteration Loss/Throughput (+ LearningRate when known) scalars,
    written by ``fit`` when ``set_tensorboard`` is configured. Weight
    histograms opt in via :meth:`set_summary_trigger` — the reference's
    ``TrainSummary.setSummaryTrigger("Parameters", ...)`` surface."""
    sub_dir = "train"
    parameters_every_epochs: Optional[int] = None
    parameters_trigger = None   # Trigger-like alternative to the int form

    # families the reference's ``setSummaryTrigger`` also accepts
    # (``TrainSummary.scala``); Loss/Throughput/LearningRate are written
    # unconditionally per iteration here, so their triggers are a no-op —
    # accepted for reference-API portability instead of raising
    _ALWAYS_ON_FAMILIES = ("Loss", "Throughput", "LearningRate")

    def set_summary_trigger(self, name: str, trigger=None, *,
                            every_epochs=None) -> "TrainSummary":
        """Enable an optional summary family, reference-style.

        ``"Parameters"`` — per-layer weight histograms. ``trigger`` is
        either the ``every_epochs`` int shorthand (also accepted under
        its pre-Trigger keyword spelling ``every_epochs=``) or a
        Trigger-like callable (``common.triggers``: ``EveryEpoch()``,
        ``SeveralIteration(n)``, ...) evaluated at epoch boundaries, where
        the params are host-visible; under fused-epoch dispatch that is
        the final epoch of each fused block. The reference's always-on
        scalar families (``Loss``/``Throughput``/``LearningRate``) accept
        any trigger as a no-op."""
        if every_epochs is not None:
            if trigger is not None:
                raise TypeError(
                    "pass either trigger or every_epochs, not both")
            trigger = every_epochs
        if trigger is None:
            raise TypeError("a trigger (or every_epochs=) is required")
        if name != "Parameters" and name not in self._ALWAYS_ON_FAMILIES:
            raise ValueError(
                f"unknown summary family {name!r}; supported: 'Parameters' "
                f"(+ no-op {'/'.join(self._ALWAYS_ON_FAMILIES)})")
        # validate BEFORE the always-on no-op return: a malformed trigger
        # must raise identically for every accepted family, or the typo
        # only surfaces when the call is later copied onto "Parameters"
        if callable(trigger) and not isinstance(trigger, type):
            every = None
        else:
            # the every-N-epochs shorthand: any real number (incl.
            # np.int64 / a float epoch count, as the pre-Trigger
            # signature coerced)
            if isinstance(trigger, bool) or isinstance(trigger, str):
                raise TypeError(
                    f"trigger must be an int (every N epochs) or a "
                    f"Trigger-like callable, got {trigger!r}")
            try:
                every = int(trigger)
            except (TypeError, ValueError):
                raise TypeError(
                    f"trigger must be an int (every N epochs) or a "
                    f"Trigger-like callable, got {type(trigger).__name__}")
            if every < 1:
                raise ValueError("every_epochs must be >= 1")
        if name in self._ALWAYS_ON_FAMILIES:
            return self
        if every is None:
            self.parameters_trigger = trigger
            self.parameters_every_epochs = None
        else:
            self.parameters_every_epochs = every
            self.parameters_trigger = None
        return self


class ValidationSummary(_Summary):
    """Per-epoch validation metrics, tagged by metric name."""
    sub_dir = "validation"
