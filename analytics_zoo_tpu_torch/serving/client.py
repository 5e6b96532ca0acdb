"""Cluster Serving client — port of ``analytics_zoo_tpu/serving/client.py``:
the wire codec (v2: raw little-endian tensor bytes plus ``dtype``/``shape``
fields, decoded as a zero-copy view; v1: base64 ``.npy``, still accepted)
and the ``InputQueue``/``OutputQueue`` producer and consumer, with the
``deadline_ms`` and ``model`` wire fields, and fleet backpressure: a
producer slowed, then refused, when every live replica reports itself
saturated. Numpy and threads only; any backend with the stream/result
contract (``LocalBackend``, ``RedisBackend``) carries it.
"""

from __future__ import annotations

import base64
import io
from typing import Dict, Optional

import numpy as np

from ..observability import new_trace_id
from .backend import LocalBackend, default_backend

INPUT_STREAM = "tensor_stream"

#: wire-format version stamped into v2 records; detection keys off the
#: ``dtype``/``shape`` fields (a v1 record has neither), the ``v`` field
#: is there for humans reading a stream dump and for future versions
WIRE_VERSION = "2"

#: hard ceiling on the payload bytes (and on any single dimension) a v2
#: header may describe — headers are attacker-controlled strings, and
#: arrays get allocated from them, so a bound must hold BEFORE anything
#: is allocated; 2 GiB is far above any real serving tensor (the server
#: additionally bounds its batch-arena preallocation, which multiplies
#: the row size by ``batch_size``)
MAX_PAYLOAD_BYTES = 1 << 31

#: ceiling on the number of dimensions a v2 header may describe — numpy
#: refuses ndarrays beyond 64 dims, and the server's batch arena (and
#: the ragged one-by-one path) prepend a batch dimension, so an
#: unbounded ndim would turn np.empty/reshape into a loop-killing raise;
#: 32 is far above any real tensor rank
MAX_DIMS = 32

__all__ = ["InputQueue", "OutputQueue", "ServingError", "encode_array",
           "decode_array", "encode_tensor", "decode_payload", "is_v2",
           "validate_v2", "new_trace_id", "WIRE_VERSION",
           "MAX_PAYLOAD_BYTES", "MAX_DIMS"]


class ServingError(RuntimeError):
    """The server wrote an error record for this uri (failed inference or
    undecodable request payload)."""


# ---------------------------------------------------------------------------
# v1 codec (legacy): base64-wrapped .npy string
# ---------------------------------------------------------------------------

def encode_array(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _check_header_bounds(dt: np.dtype, shape) -> int:
    """Shared bound checks for ANY attacker-controlled tensor header —
    v2 ``dtype``/``shape`` fields or a v1 ``.npy`` header: every
    dimension in range, rank capped at :data:`MAX_DIMS`, total bytes
    capped at :data:`MAX_PAYLOAD_BYTES`. Returns the expected payload
    byte count, computed with Python ints — ``np.prod`` would wrap
    silently on overflow, and a wrapped 0 validates a huge-shape header
    against an empty payload."""
    if len(shape) > MAX_DIMS:
        raise ValueError(
            f"tensor header has {len(shape)} dimensions (max {MAX_DIMS})")
    expect = dt.itemsize
    for d in shape:
        if d < 0 or d > MAX_PAYLOAD_BYTES:
            raise ValueError(f"tensor shape {tuple(shape)} has an "
                             f"out-of-range dimension {d}")
        expect *= d
    if expect > MAX_PAYLOAD_BYTES:
        raise ValueError(f"tensor header describes {expect} payload "
                         f"bytes (max {MAX_PAYLOAD_BYTES})")
    return expect


def decode_array(payload) -> np.ndarray:
    # b64decode accepts str or bytes — a binary-safe backend hands the
    # legacy field back as bytes, a text transport as str
    buf = io.BytesIO(base64.b64decode(payload))
    # the .npy header is attacker-controlled like a v2 header, and
    # np.load preallocates the FULL array from it before reading any
    # payload bytes — bound it the same way first (tiny records
    # claiming multi-GiB shapes are a memory-pressure DoS otherwise)
    version = np.lib.format.read_magic(buf)
    read_header = getattr(
        np.lib.format, "read_array_header_%d_%d" % version, None)
    if read_header is not None:
        shape, _, dt = read_header(buf)
    else:
        # no public reader for this version (3.0: utf-8 field names);
        # np.load accepts it, so the bounds check must too
        shape, _, dt = np.lib.format._read_array_header(buf, version)
    expect = _check_header_bounds(np.dtype(dt), shape)
    present = buf.getbuffer().nbytes - buf.tell()
    if present != expect:
        # np.load would preallocate the CLAIMED size before noticing the
        # payload is short — a 100-byte record claiming a (capped but
        # still multi-GiB) shape must be rejected before any allocation
        raise ValueError(f".npy payload is {present} bytes but its "
                         f"header claims {expect}")
    buf.seek(0)
    return np.load(buf, allow_pickle=False)


# ---------------------------------------------------------------------------
# v2 codec: raw little-endian bytes + dtype/shape fields
# ---------------------------------------------------------------------------

def encode_tensor(arr: np.ndarray, key: str = "data") -> Dict[str, object]:
    """Wire-format v2 fields for one tensor: ``{key: <raw bytes>,
    "dtype": "<f4", "shape": "3,224,224", "v": "2"}``.

    Bytes are C-contiguous little-endian (big-endian inputs are byte-
    swapped once here so the decode side is always a straight view);
    ``dtype`` is the numpy dtype spec string, ``shape`` comma-joined.
    ``key`` selects the payload field name — ``data`` on the request
    stream, ``value`` on result hashes."""
    a = np.asarray(arr)
    if not a.flags.c_contiguous:
        # ascontiguousarray unconditionally would also promote 0-d
        # arrays to 1-d and lose the scalar shape on the wire
        a = np.ascontiguousarray(a)
    if a.dtype.hasobject:
        raise ValueError(
            f"cannot encode dtype {a.dtype} — object arrays have no raw "
            f"byte representation (and never decoded under v1 either: "
            f"np.save(allow_pickle=False) rejects them)")
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return {key: a.tobytes(), "dtype": a.dtype.str,
            "shape": ",".join(str(d) for d in a.shape), "v": WIRE_VERSION}


def is_v2(fields: Dict) -> bool:
    """True when a stream/result record carries the v2 header fields."""
    return "dtype" in fields and "shape" in fields


def parse_v2_header(fields: Dict):
    """``(np.dtype, shape_tuple, payload_bytes)`` from a v2 record's
    header fields. Raises on malformed specs, including any dimension
    that is negative or above :data:`MAX_PAYLOAD_BYTES` — np.empty on
    such a shape raises (or allocates absurdly), and the server's arena
    path relies on a validated header never failing allocation."""
    dt = np.dtype(str(fields["dtype"]))
    if dt.subdtype is not None:
        # "(2,2)<f4" would smuggle extra dims past every shape check:
        # frombuffer expands them and the reshape/arena paths blow up
        raise ValueError(
            f"v2 dtype {fields['dtype']!r} is a subarray dtype — dims "
            f"belong in the shape field")
    shape = tuple(int(s) for s in str(fields["shape"]).split(",") if s)
    return dt, shape, _check_header_bounds(dt, shape)


def validate_v2(fields: Dict, key: str = "data"):
    """Fully validate a v2 record WITHOUT touching the payload bytes:
    ``(payload_bytes, np.dtype, shape)``. Parses the header, normalizes a
    text-transport payload, and rejects dtypes with no raw byte
    representation (object, zero-itemsize flexible types) and
    header/byte-length mismatches — after this, ``np.frombuffer`` cannot
    fail. The ONE definition of what the wire accepts: both
    :func:`decode_payload` and the server's cheap pre-copy check use it,
    so the accept rule cannot diverge between client and server."""
    dt, shape, expect = parse_v2_header(fields)
    if dt.hasobject or dt.itemsize == 0:
        raise ValueError(
            f"v2 dtype {dt.str} has no raw byte representation")
    payload = fields[key]
    if isinstance(payload, str):
        # a text-only transport: latin-1 is the lossless byte<->str map
        payload = payload.encode("latin-1")
    if len(payload) != expect:
        raise ValueError(
            f"v2 payload is {len(payload)} bytes but dtype={dt.str} "
            f"shape={shape} needs {expect}")
    return payload, dt, shape


def decode_payload(fields: Dict, key: str = "data") -> np.ndarray:
    """Decode one record's tensor payload, v2 or v1.

    v2 (``dtype``/``shape`` fields present) returns a ZERO-COPY read-only
    ``np.frombuffer`` view over the wire bytes; v1 falls back to the
    base64 ``.npy`` decode. Raises on malformed payloads (bad base64,
    unrepresentable dtype, header/byte-length mismatch) — the server
    converts that into an addressable error record."""
    if is_v2(fields):
        payload, dt, shape = validate_v2(fields, key)
        return np.frombuffer(payload, dtype=dt).reshape(shape)
    return decode_array(fields[key])


class InputQueue:
    """Producer side: ``enqueue(uri, tensor)``. Blocks (up to ``timeout``)
    when the stream is at capacity.

    With ``fleet_backpressure`` on (or conf
    ``zoo.serving.fleet_backpressure``), enqueue also consults the fleet
    registry (``serving/fleet.py``; a cached :class:`FleetView`): when
    every live replica reports itself saturated the producer is first
    slowed (a backed-off wait up to ``fleet_wait_s``), then refused with
    :class:`~analytics_zoo_tpu_torch.serving.fleet.FleetSaturatedError`
    — backpressure upstream of the stream, so a replica's own shedding
    becomes the backstop."""

    def __init__(self, backend: Optional[LocalBackend] = None,
                 stream: str = INPUT_STREAM, timeout: float = 30.0,
                 fleet_backpressure: Optional[bool] = None,
                 fleet_wait_s: float = 1.0,
                 fleet_view=None):
        self.backend = backend if backend is not None else default_backend()
        self.stream = stream
        self.timeout = timeout
        if fleet_backpressure is None:
            from ..common.context import get_zoo_context
            fleet_backpressure = bool(get_zoo_context().get(
                "zoo.serving.fleet_backpressure", False))
        self.fleet_backpressure = bool(fleet_backpressure)
        self.fleet_wait_s = float(fleet_wait_s)
        self._fleet_view = fleet_view
        if self.fleet_backpressure and self._fleet_view is None:
            from .fleet import FleetView
            self._fleet_view = FleetView(self.backend, self.stream)

    def _check_fleet(self) -> None:
        """Slow, then refuse: wait (backed off) up to ``fleet_wait_s``
        for the fleet to report headroom; raise once the budget is spent.
        The cached view bounds the backend reads underneath."""
        if not self.fleet_backpressure or self._fleet_view is None:
            return
        if not self._fleet_view.saturated():
            return
        from ..common.reliability import RetryPolicy
        from .fleet import FleetSaturatedError
        wait = RetryPolicy(base_delay=0.02, max_delay=0.2)
        if not wait.wait_for(lambda: not self._fleet_view.saturated(),
                             timeout=self.fleet_wait_s):
            raise FleetSaturatedError(
                f"fleet serving stream {self.stream!r} is saturated "
                f"(every live replica above its shed watermark for "
                f"{self.fleet_wait_s:.1f}s); enqueue refused — retry "
                f"with backoff or scale the fleet")

    def enqueue(self, uri: str, data: np.ndarray,
                trace: Optional[str] = None,
                deadline_ms: Optional[int] = None,
                model: Optional[str] = None) -> str:
        """Enqueue one record in wire format v2, stamped with a 16-hex
        ``trace`` id (``trace=`` adopts a caller's id).

        ``deadline_ms`` stamps an absolute epoch-millisecond deadline (the
        clock the stream entry ids share): a server reading the record
        after it passed answers ``deadline exceeded`` instead of
        dispatching it. ``model`` routes the record to one named lane of
        a multi-model server; without it the record goes to the primary
        lane, and a name the server does not host is answered ``unknown
        model``. With fleet backpressure on, a saturated fleet slows and
        then refuses the call (``FleetSaturatedError``)."""
        self._check_fleet()
        fields = encode_tensor(np.asarray(data))
        fields["uri"] = uri
        # a falsy trace ("" from an unset upstream header) mints one too
        fields["trace"] = trace or new_trace_id()
        if deadline_ms is not None:
            fields["deadline_ms"] = str(int(deadline_ms))
        if model:
            fields["model"] = str(model)
        return self.backend.xadd(self.stream, fields, timeout=self.timeout)


class OutputQueue:
    """Consumer side: ``query(uri)`` one result (raises ``ServingError``
    when the server answered with an error), ``dequeue()`` every
    successful result (failures land in ``last_errors``)."""

    def __init__(self, backend: Optional[LocalBackend] = None):
        self.backend = backend if backend is not None else default_backend()
        self.last_errors: Dict[str, str] = {}

    def query(self, uri: str, timeout: Optional[float] = None
              ) -> Optional[np.ndarray]:
        res = self.backend.pop_result(uri, timeout=timeout)
        if res is None:
            return None
        if "value" not in res:
            raise ServingError(f"{uri}: {res.get('error', 'unknown error')}")
        return decode_payload(res, "value")

    def dequeue(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        self.last_errors = {}
        for uri, res in self.backend.pop_all_results().items():
            if "value" in res:
                out[uri] = decode_payload(res, "value")
            else:
                self.last_errors[uri] = res.get("error", "unknown error")
        return out
