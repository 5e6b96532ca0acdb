"""Span-based tracing over the metrics registry — a copy of
``analytics_zoo_tpu/observability/tracing.py`` (pure Python).

``with trace.span("serving.dispatch"): ...`` records the block's wall
duration into the ``zoo_span_seconds{span=...}`` histogram and — when the
registry has event sinks attached — emits one structured span event with
the parent span name, so the JSON log reconstructs nesting without a
separate trace-file format. Nesting is tracked per thread; a span opened
on one thread never becomes the parent of a span on another (the serving
loop, producers, and the training loop each own their stack).

Spans are phase-level ("which phase of the request spent the time" — the
reference's scoped ``timeIt`` role): per-thread nesting, no sampling, no
cross-process context. REQUEST-level tracing is the thin Dapper-style
layer on top: :func:`new_trace_id` mints the 64-bit hex id the serving
client stamps on each enqueued record, and the serve loop emits
parent-linked per-request phase events (enqueue → dequeue → dispatch →
publish) carrying that id into the JSON event log — the id is the join
key, the log is the trace store, and there is still no in-band context
to thread through the hot path.
"""

from __future__ import annotations

import contextlib
import secrets
import threading
import time
import weakref
from typing import Dict, Iterator, Optional

from .metrics import Histogram, MetricsRegistry, default_registry

__all__ = ["span", "current_span", "SpanHandle", "new_trace_id"]


def new_trace_id() -> str:
    """A fresh Dapper-style trace id: 16 lowercase hex chars (64 random
    bits — collision-free at any realistic request volume). This exact
    format is the serving wire contract: the
    client stamps it into the stream record's ``trace`` field and every
    per-request event carries it verbatim."""
    return secrets.token_hex(8)

_state = threading.local()

# per-(registry, span-name) histogram cache: a span exit must not take the
# registry lock (which a concurrent scrape holds while rendering) — the
# lock is paid once per new span name, then exits are lock-free dict reads
_hist_cache: "weakref.WeakKeyDictionary[MetricsRegistry, Dict[str, Histogram]]" \
    = weakref.WeakKeyDictionary()


def _span_histogram(reg: MetricsRegistry, name: str) -> Histogram:
    per_reg = _hist_cache.get(reg)
    if per_reg is None:
        per_reg = _hist_cache.setdefault(reg, {})
    h = per_reg.get(name)
    if h is None:
        # span names are code-defined constants (obs.span("...")),
        # one series per instrumented phase
        h = per_reg[name] = reg.histogram(  # zoolint: disable=ZL015 bounded label set
            "zoo_span_seconds", "wall seconds per traced span",
            labels={"span": name})
    return h


def _stack() -> list:
    st = getattr(_state, "stack", None)
    if st is None:
        st = _state.stack = []
    return st


def current_span() -> Optional[str]:
    """Name of the innermost open span on this thread, or None."""
    st = _stack()
    return st[-1] if st else None


class SpanHandle:
    """Yielded by :func:`span`; :meth:`discard` cancels recording — for
    blocks that turn out to be no-ops (e.g. a refused non-blocking
    dispatch probe) whose ~zero durations would skew the distribution."""

    __slots__ = ("discarded",)

    def __init__(self):
        self.discarded = False

    def discard(self) -> None:
        self.discarded = True


@contextlib.contextmanager
def span(name: str, registry: Optional[MetricsRegistry] = None,
         **attrs) -> Iterator[SpanHandle]:
    """Time a block as a named span.

    * duration → ``zoo_span_seconds{span=name}`` histogram in ``registry``
      (default: the process-wide registry),
    * one ``{"kind": "span", "name", "parent", "dur_s", **attrs}`` event
      to the registry's sinks (no-op when none are attached),
    * ``attrs`` ride along on the event only — keep them small and
      JSON-serializable (batch sizes, record counts),
    * yields a :class:`SpanHandle`; ``handle.discard()`` suppresses the
      histogram observation and event for a block that did no real work.
    """
    reg = registry if registry is not None else default_registry()
    st = _stack()
    parent = st[-1] if st else None
    st.append(name)
    handle = SpanHandle()
    t0 = time.perf_counter()
    try:
        yield handle
    finally:
        dur = time.perf_counter() - t0
        st.pop()
        if not handle.discarded:
            _span_histogram(reg, name).observe(dur)
            reg.emit("span", name=name, parent=parent, dur_s=dur, **attrs)
