"""Export sinks for the metrics registry — the port of
``analytics_zoo_tpu/observability/export.py``.

Three ways out of the process, matching how their audiences read:

* :func:`render_prometheus` / :class:`ScrapeServer` — text exposition for
  a scraper (or a human with ``curl``); the serving backend mounts this
  via ``ClusterServing.serve_metrics()``.
* :class:`JsonEventSink` — append-only JSON-lines event log (spans,
  per-batch serving events, per-request phase events, error records);
  schema-stable under concurrent writers because each event is one
  ``json.dumps`` appended under a lock.
* :class:`TensorBoardSink` — adapter over ``utils.tensorboard.
  EventFileWriter`` so registry snapshots land in the same event files
  the training and serving scalars use.

The exposition text, the event lines and the endpoints' JSON keys are
the JAX package's, letter for letter; ``/statusz``'s ``device`` block
reads torch (``{"platform": "gpu", "device_count": ...}`` plus the
allocator's ``memory`` rows) where the JAX one reads jax.

:func:`parse_prometheus` is the deliberately minimal reader used by the
round-trip tests — names, types, labels, values, enough to reconcile a
scrape against ground truth without a client library.
"""

from __future__ import annotations

import http.server
import json
import math
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .metrics import Histogram, MetricsRegistry, Summary, default_registry

__all__ = ["render_prometheus", "parse_prometheus", "dump",
           "JsonEventSink", "read_events", "ScrapeServer", "TensorBoardSink"]


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _sanitize(name: str) -> str:
    if _NAME_OK.match(name):
        return name
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    return out if _NAME_OK.match(out) else "_" + out


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_text(labels, extra: Optional[Dict[str, str]] = None) -> str:
    pairs = list(labels) + sorted((extra or {}).items())
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(str(v))}"'
                          for k, v in pairs) + "}"


def _fmt(v: float) -> str:
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """The registry as Prometheus text exposition format (one ``# TYPE``
    per family; histograms as cumulative ``_bucket{le=...}`` + ``_sum`` /
    ``_count``; summaries as ``{quantile=...}`` series + ``_sum`` /
    ``_count``)."""
    reg = registry if registry is not None else default_registry()
    lines: List[str] = []
    typed = set()
    for m in reg.metrics():
        name = _sanitize(m.name)
        if name not in typed:
            typed.add(name)
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
        if isinstance(m, Histogram):
            # one locked snapshot: the +Inf bucket must equal _count even
            # when a producer observes mid-render
            buckets, count, total = m.stats()
            for le, c in buckets:
                lines.append(f"{name}_bucket"
                             f"{_labels_text(m.labels, {'le': _fmt(le)})}"
                             f" {c}")
            lines.append(f"{name}_sum{_labels_text(m.labels)} {_fmt(total)}")
            lines.append(f"{name}_count{_labels_text(m.labels)} {count}")
        elif isinstance(m, Summary):
            # one locked pass per summary: p99 >= p50 must hold in every
            # scrape even while producers observe concurrently
            qs, count, total = m.stats()
            for q, v in qs:
                lines.append(f"{name}"
                             f"{_labels_text(m.labels, {'quantile': repr(q)})}"
                             f" {_fmt(v)}")
            lines.append(f"{name}_sum{_labels_text(m.labels)} {_fmt(total)}")
            lines.append(f"{name}_count{_labels_text(m.labels)} {count}")
        else:
            lines.append(f"{name}{_labels_text(m.labels)} {_fmt(m.value)}")
    return "\n".join(lines) + "\n"


def dump(registry: Optional[MetricsRegistry] = None,
         compact: bool = False) -> Dict[str, Any]:
    """Plain-dict snapshot of the registry (see
    ``MetricsRegistry.snapshot``) — what a benchmark record embeds."""
    reg = registry if registry is not None else default_registry()
    return reg.snapshot(compact=compact)


# the label block matches quoted values char-by-char (escapes allowed), so
# a '}' INSIDE a label value does not terminate the block early
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r'(?:\{(?P<labels>(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"\s*,?\s*)*)\})?'
    r"\s+(?P<value>\S+)\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_value(s: str) -> float:
    return {"+Inf": math.inf, "-Inf": -math.inf}.get(s) or float(s)


def parse_prometheus(text: str) -> Dict[str, Dict[str, Any]]:
    """Minimal exposition-format reader: ``{family: {"type": ...,
    "samples": [(name, labels_dict, value), ...]}}``. Raises ValueError
    on lines that are neither comments nor well-formed samples — the
    round-trip tests lean on that strictness."""
    out: Dict[str, Dict[str, Any]] = {}
    last_family = None
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                last_family = parts[2]
                out[last_family] = {"type": parts[3].strip(), "samples": []}
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name = m.group("name")
        labels = {k: re.sub(r"\\(.)", lambda g: {"n": "\n"}.get(
            g.group(1), g.group(1)), v)
            for k, v in _LABEL_RE.findall(m.group("labels") or "")}
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[:-len(suffix)] if name.endswith(suffix) else None
            if base and base in out and out[base]["type"] in ("histogram",
                                                              "summary"):
                family = base
                break
        if family not in out:
            # sample with no TYPE line: tolerated as untyped
            out[family] = {"type": "untyped", "samples": []}
        out[family]["samples"].append(
            (name, labels, _parse_value(m.group("value"))))
    return out


# ---------------------------------------------------------------------------
# JSON event sink
# ---------------------------------------------------------------------------

class JsonEventSink:
    """Append-only JSON-lines writer for structured event records.

    Every line is one complete JSON object with at least ``ts`` (epoch
    seconds) and ``kind``; producers add flat payload fields. Writes are
    serialized under a lock so concurrent writers (serving loop + span
    exits on producer threads) can never interleave bytes — the schema
    stability the exposition tests assert.

    ``max_bytes`` > 0 switches on size-based rotation: when the active
    file reaches the limit it is atomically renamed to ``path.1``
    (``os.replace``, the DLQ segments' crash-safe idiom — readers see
    either the old name or the new, never a torn file), older segments
    shift up, and at most ``keep`` rotated segments survive (oldest
    dropped). :func:`read_events` reads across the whole chain, oldest
    first."""

    def __init__(self, path: str, max_bytes: int = 0, keep: int = 3):
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self.path = path
        self.max_bytes = int(max_bytes)
        self.keep = max(int(keep), 1)
        # line-buffered: each event reaches the OS as it happens, so a
        # crash loses at most the in-flight line — the events nearest a
        # failure are exactly the ones diagnosis needs
        self._f = open(path, "a", encoding="utf-8", buffering=1)
        self._size = os.path.getsize(path) if os.path.exists(path) else 0
        self._lock = threading.Lock()

    def _rotate_locked(self) -> None:
        self._f.flush()
        self._f.close()
        oldest = f"{self.path}.{self.keep}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._f = open(self.path, "a", encoding="utf-8", buffering=1)
        self._size = 0

    def write(self, event: Dict[str, Any]) -> None:
        line = json.dumps(event, sort_keys=True, default=str)
        with self._lock:
            if self._f.closed:
                # a concurrent emitter may race close() (the registry's
                # sink snapshot is taken before removal); dropping the
                # event beats crashing the instrumented thread
                return
            self._f.write(line + "\n")
            self._size += len(line) + 1
            if self.max_bytes > 0 and self._size >= self.max_bytes:
                self._rotate_locked()

    def flush(self) -> None:
        with self._lock:
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


def read_events(path: str, kind: Optional[str] = None) -> List[Dict[str, Any]]:
    """Parse a JSON-lines event log back, optionally filtered by kind.
    Rotated segments (``path.N`` … ``path.1``, highest = oldest) are
    read before the active file, so the result is one chronological
    stream regardless of how many rotations happened."""
    chain: List[str] = []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        chain.append(f"{path}.{i}")
        i += 1
    chain.reverse()                      # oldest segment first
    chain.append(path)
    out: List[Dict[str, Any]] = []
    for seg in chain:
        with open(seg, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                event = json.loads(line)
                if kind is None or event.get("kind") == kind:
                    out.append(event)
    return out


# ---------------------------------------------------------------------------
# scrape endpoint
# ---------------------------------------------------------------------------

def _registry_value(reg: MetricsRegistry, name: str) -> float:
    """Sum of a counter/gauge family's values across its label series —
    the cheap way /statusz reads totals without a full exposition pass."""
    total = 0.0
    for m in reg.metrics():
        if m.name == name and not isinstance(m, (Histogram, Summary)):
            total += m.value
    return total


class _ScrapeHandler(http.server.BaseHTTPRequestHandler):
    registry: MetricsRegistry = None  # type: ignore[assignment]
    health_fn: Optional[Callable[[], Dict[str, Any]]] = None
    profiler: Optional[Any] = None     # a ProfilerTrigger, when mounted
    started_at: float = 0.0

    def _send(self, body: bytes, content_type: str, code: int = 200) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _health_payload(self) -> Dict[str, Any]:
        info: Dict[str, Any] = {"status": "ok",
                                "uptime_s": time.time() - self.started_at}
        fn = type(self).health_fn
        if fn is not None:
            try:
                info.update(fn())
            except Exception as e:     # a dead backend must not 500 /healthz
                info["status"] = "degraded"
                info["error"] = f"{type(e).__name__}: {e}"
        return info

    def _status_payload(self) -> Dict[str, Any]:
        info = self._health_payload()
        reg = self.registry
        info["jit"] = {
            "compile_total": _registry_value(reg, "zoo_jit_compile_total"),
            "retrace_total": _registry_value(reg, "zoo_jit_retrace_total"),
        }
        try:
            import torch
            info["device"] = (
                {"platform": "gpu",
                 "device_count": torch.cuda.device_count()}
                if torch.cuda.is_available()
                else {"platform": "cpu", "device_count": 1})
        except Exception as e:          # a broken CUDA setup: still report
            info["device"] = {"platform": "unavailable",
                              "error": f"{type(e).__name__}: {e}"}
        if self._device_memory_enabled():
            from .device import device_memory_stats
            mem = device_memory_stats()
            if mem:                     # off-GPU: absent beats lying zero
                info["device"]["memory"] = mem
        info["performance"] = self._performance_payload()
        return info

    def _performance_payload(self) -> Dict[str, Any]:
        """The goodput/attribution block: ratio + per-category badput
        read back off the registry (so it works whether the ledger
        lives in this process's fit loop or serve loop), plus the
        in-flight profiler capture when one is mounted."""
        from .goodput import registry_snapshot
        perf: Dict[str, Any] = registry_snapshot(self.registry)
        prof = type(self).profiler
        if prof is not None:
            perf["profiler"] = {"in_flight": prof.in_flight(),
                                "trace_dir": prof.trace_dir}
        return perf

    @staticmethod
    def _device_memory_enabled() -> bool:
        try:
            from ..common.context import get_zoo_context
            return bool(get_zoo_context().get(
                "zoo.telemetry.device_memory", True))
        except Exception:               # no context: default on
            return True

    def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
        path = self.path.split("?", 1)[0]
        if path in ("/", "/metrics"):
            self._send(render_prometheus(self.registry).encode("utf-8"),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            self._send(json.dumps(self._health_payload()).encode("utf-8"),
                       "application/json")
        elif path == "/statusz":
            self._send(json.dumps(self._status_payload(), indent=2,
                                  default=str).encode("utf-8"),
                       "application/json")
        else:
            self.send_error(404)

    def do_POST(self):  # noqa: N802 (BaseHTTPRequestHandler API)
        path = self.path.split("?", 1)[0]
        if path != "/profilez":
            self.send_error(404)
            return
        prof = type(self).profiler
        if prof is None:
            self._send(json.dumps(
                {"armed": False, "error": "no profiler mounted"}
            ).encode("utf-8"), "application/json", code=404)
            return
        cap_dir = prof.arm(trigger="http", reason="POST /profilez")
        body = {"armed": cap_dir is not None, "dir": cap_dir,
                "in_flight": prof.in_flight()}
        self._send(json.dumps(body).encode("utf-8"), "application/json",
                   code=200 if cap_dir is not None else 409)

    def log_message(self, *args):  # scrapes must not spam stderr
        pass


class ScrapeServer:
    """A tiny HTTP endpoint over one registry: ``/metrics`` (Prometheus
    text exposition), ``/healthz`` (liveness: status + uptime + whatever
    ``health_fn`` reports), and ``/statusz`` (the operator page: health
    plus jit-compile totals and device/platform info). ``port=0`` picks a
    free port; the bound one is on ``self.port``.

    ``health_fn`` is an optional zero-arg callable returning a JSON-able
    dict merged into both payloads — ``ClusterServing.serve_metrics``
    passes its serve-loop introspection (stream depth, last-flush age)
    this way. It runs on the scrape thread, so it must be cheap and must
    not take locks the serve loop holds across dispatches.

    ``/statusz`` additionally carries a ``performance`` block (goodput
    ratio + per-category badput seconds read off the registry), and
    passing ``profiler=`` (a :class:`~.profiler.ProfilerTrigger`)
    mounts ``POST /profilez`` — arm a bounded trace capture over HTTP;
    200 with the capture dir on success, 409 when one is already in
    flight (or the start failed and degraded)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 port: int = 0, host: str = "127.0.0.1",
                 health_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 profiler: Optional[Any] = None):
        attrs: Dict[str, Any] = {
            "registry": registry if registry is not None
            else default_registry(),
            "started_at": time.time(),
        }
        if health_fn is not None:
            attrs["health_fn"] = staticmethod(health_fn)
        if profiler is not None:
            attrs["profiler"] = profiler
        handler = type("Handler", (_ScrapeHandler,), attrs)
        self._httpd = http.server.ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="zoo-metrics-scrape",
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


# ---------------------------------------------------------------------------
# TensorBoard sink (reuses the event-file writer)
# ---------------------------------------------------------------------------

class TensorBoardSink:
    """Export registry snapshots into TensorBoard event files through the
    in-repo ``EventFileWriter`` — counters/gauges as scalars, histograms
    as ``_count``/``_sum``/``_mean`` scalars (bucket shapes live in the
    Prometheus/JSON channels; TB scalars are for trend lines)."""

    def __init__(self, log_dir: str):
        from ..utils.tensorboard import EventFileWriter
        self.writer = EventFileWriter(log_dir)

    def export(self, registry: Optional[MetricsRegistry] = None,
               step: int = 0) -> None:
        reg = registry if registry is not None else default_registry()
        for m in reg.metrics():
            tag = m.name
            if m.labels:
                tag += "/" + "/".join(v for _, v in m.labels)
            if isinstance(m, Histogram):
                _, count, total = m.stats()   # one locked snapshot
                self.writer.add_scalar(tag + "_count", float(count), step)
                self.writer.add_scalar(tag + "_sum", float(total), step)
                if count:
                    self.writer.add_scalar(tag + "_mean",
                                           float(total / count), step)
            elif isinstance(m, Summary):
                qs, count, total = m.stats()
                self.writer.add_scalar(tag + "_count", float(count), step)
                self.writer.add_scalar(tag + "_sum", float(total), step)
                for q, v in qs:
                    if v == v:     # empty digests yield NaN — skip those
                        self.writer.add_scalar(
                            tag + f"_p{int(round(q * 100))}", float(v), step)
            else:
                self.writer.add_scalar(tag, float(m.value), step)
        self.writer.flush()

    def close(self) -> None:
        self.writer.close()
