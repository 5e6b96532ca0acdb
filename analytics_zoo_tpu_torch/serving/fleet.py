"""Fleet coordination — port of ``analytics_zoo_tpu/serving/fleet.py``,
the shared replica registry under one stream (pure Python).

Every ``ClusterServing`` replica heartbeats a small JSON payload into its
backend's fleet hash (``fleet:<stream>`` on Redis, an in-process dict on
``LocalBackend``): its serving mode (consumer group or consume-on-read),
stream depth, pending entries, shed watermark, utilization, its scrape
``endpoint`` and a wall-clock stamp. Three things read it back:

* **the mode guard** — ``ClusterServing.start()`` refuses to join a
  stream that a live peer serves in another mode
  (:func:`check_mode_conflict`),
* **fleet backpressure** — ``InputQueue.enqueue`` consults a cached
  :class:`FleetView`: when every live replica reports itself saturated
  the producer is slowed, then refused with :class:`FleetSaturatedError`,
* **the fleet collector** (``observability/collector.py``) discovers its
  scrape targets from the heartbeats' endpoints.

A member whose heartbeat is older than ``ttl_s`` is dead, and the
producer's view re-reads the backend at most once per ``cache_s``.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Dict, Optional

log = logging.getLogger("analytics_zoo_tpu_torch.serving.fleet")

__all__ = ["FleetView", "FleetSaturatedError", "publish_member",
           "remove_member", "live_members", "check_mode_conflict",
           "DEFAULT_TTL_S"]

#: a member heartbeat older than this is dead (its replica crashed or
#: was killed without a clean stop) — 3x the default 1 s heartbeat, so
#: one dropped beat never flaps membership
DEFAULT_TTL_S = 3.0


class FleetSaturatedError(RuntimeError):
    """Every live replica reported itself saturated and the enqueue-side
    wait budget elapsed — the fleet-level backpressure refusal."""


def _fleet_surface(backend) -> bool:
    """Duck-typed: a backend participates when it exposes the fleet
    key-value surface (both in-repo backends do; a foreign minimal
    backend silently opts the whole feature out)."""
    return all(hasattr(backend, m)
               for m in ("fleet_set", "fleet_all", "fleet_del"))


def publish_member(backend, stream: str, consumer: str,
                   info: Dict) -> None:
    """One heartbeat: merge ``info`` with a fresh wall-clock stamp and
    write it under this consumer's field. Failures log and drop — a
    backend blip must not crash the serve loop over telemetry."""
    if not _fleet_surface(backend):
        return
    payload = dict(info)
    payload["ts"] = time.time()
    try:
        backend.fleet_set(stream, consumer, json.dumps(payload))
    except Exception as e:
        log.debug("fleet heartbeat for %r failed: %s", consumer, e)


def remove_member(backend, stream: str, consumer: str) -> None:
    """Clean deregistration on stop(); a crash skips this and the TTL
    reaps the stale entry instead."""
    if not _fleet_surface(backend):
        return
    try:
        backend.fleet_del(stream, consumer)
    except Exception as e:
        log.debug("fleet deregistration for %r failed: %s", consumer, e)


def live_members(backend, stream: str,
                 ttl_s: float = DEFAULT_TTL_S) -> Dict[str, Dict]:
    """Members whose heartbeat is fresher than ``ttl_s``; malformed
    payloads are skipped (a half-written heartbeat must not poison the
    view). Entries dead for well past any caller's TTL are reaped from
    the registry here — consumer names are unique per process, so a
    crash-looping replica would otherwise grow the fleet hash by one
    never-deleted field per restart, unbounded (a clean ``stop()``
    deregisters; a crash cannot). Reaping is best-effort and generous
    (``3x max(ttl_s, DEFAULT_TTL_S)``): a replica merely paused never
    loses its slot to a racing reader, and re-registers on its next
    heartbeat even if it does."""
    if not _fleet_surface(backend):
        return {}
    now = time.time()
    reap_after = 3.0 * max(ttl_s, DEFAULT_TTL_S)
    out: Dict[str, Dict] = {}
    reap = []
    for consumer, raw in backend.fleet_all(stream).items():
        try:
            info = json.loads(raw)
            # a JSON-valid non-object (`123`, `"x"` — a foreign writer)
            # is garbage too: .get would raise AttributeError and take
            # every start() on the stream down with it
            if not isinstance(info, dict):
                raise TypeError("heartbeat payload is not an object")
            ts = float(info.get("ts", 0.0))
        except (ValueError, TypeError):
            reap.append(consumer)   # garbage never refreshes itself
            continue
        if now - ts <= ttl_s:
            out[consumer] = info
        elif now - ts > reap_after:
            reap.append(consumer)
    for consumer in reap:
        try:
            backend.fleet_del(stream, consumer)
        except Exception as e:
            log.debug("fleet reap of %r failed: %s", consumer, e)
    return out


def check_mode_conflict(backend, stream: str, consumer: str, mode: str,
                        ttl_s: float = DEFAULT_TTL_S) -> None:
    """Fail LOUDLY when a live peer serves ``stream`` in an incompatible
    mode. ``mode`` is ``"single"`` (legacy consume-on-read) or
    ``"group:<name>"``; any mismatch conflicts — single vs group
    double-serves (the legacy reader pops entries out from under the
    group's delivery accounting), and two different group names would
    compete for pops while each believes it owns a complete PEL. Raised
    at ``start()``, before the first read can do damage (the
    mixed-version fleet guard, docs/guides/SERVING.md rollout
    runbook)."""
    for peer, info in live_members(backend, stream, ttl_s).items():
        if peer == consumer:
            continue
        peer_mode = str(info.get("mode", ""))
        if peer_mode and peer_mode != mode:
            raise RuntimeError(
                f"serving mode conflict on stream {stream!r}: this "
                f"replica ({consumer!r}) would serve in mode {mode!r} but "
                f"live replica {peer!r} serves in mode {peer_mode!r} "
                f"(heartbeat {time.time() - float(info.get('ts', 0.0)):.1f}s "
                f"old). A consume-on-read server and a consumer-group "
                f"server on one stream double-serve or starve each other — "
                f"finish the rollout one mode at a time "
                f"(docs/guides/SERVING.md, fleet rollout runbook)")


class FleetView:
    """Producer-side cached read of the fleet registry.

    ``saturated()`` answers "should this producer back off?": True when
    there is at least one live member AND every live member reports
    ``saturated`` (each replica computes that itself — backlog plus its
    own in-flight pending above its shed watermark). One replica with
    headroom keeps the fleet
    open; zero live members keeps it open too (nothing is served, but
    refusing enqueues on an empty registry would break every
    pre-fleet deployment and test).

    Reads are cached for ``cache_s`` — bounded staleness, not a read
    per enqueue. A backend error reads as "not saturated" (producers
    must never be refused on a telemetry blip; the bounded ``xadd``
    itself still backpressures)."""

    def __init__(self, backend, stream: str, cache_s: float = 0.25,
                 ttl_s: float = DEFAULT_TTL_S):
        self.backend = backend
        self.stream = stream
        self.cache_s = float(cache_s)
        self.ttl_s = float(ttl_s)
        self._cached_at: Optional[float] = None
        self._members: Dict[str, Dict] = {}

    def members(self) -> Dict[str, Dict]:
        now = time.monotonic()
        if self._cached_at is None or now - self._cached_at >= self.cache_s:
            try:
                self._members = live_members(self.backend, self.stream,
                                             self.ttl_s)
            except Exception as e:
                log.debug("fleet read failed (treating as open): %s", e)
                self._members = {}
            self._cached_at = now
        return self._members

    def saturated(self) -> bool:
        members = self.members()
        return bool(members) and all(m.get("saturated")
                                     for m in members.values())
