"""Alert-triggered profiler capture — the port of
``analytics_zoo_tpu/observability/profiler.py`` on ``torch.profiler``.

A :class:`ProfilerTrigger` arms a **bounded** capture: at most one in
flight, each capture stopped after ``duration_s`` seconds (a daemon
timer) or ``steps`` step notifications (whichever bound is configured),
trace directories retention-capped to the newest ``keep``. Ways to fire
it:

* **http** — ``POST /profilez`` on a :class:`~.export.ScrapeServer`
  built with ``profiler=``,
* **alert** — register :meth:`on_alert` with
  :meth:`AlertEngine.add_transition_hook`: a rule entering ``firing``
  arms a capture,
* **manual** — call :meth:`arm` from code or a debugger.

The default start/stop run ``torch.profiler.profile`` over the CPU and,
when a card is present, CUDA activity (CUPTI records every kernel of
the process, whichever thread launched it; CPU ops of every thread
where the build supports ``profile_all_threads``); stop writes a Chrome
trace, ``trace.json``, into the capture's directory. Kineto runs one
profiler a process: a start while another capture runs fails and
degrades like any other failure.

Failure is not an option we pass on: capture start runs under the
``profiler.capture`` fault site and every exception (profiler busy,
unwritable trace dir, injected chaos) degrades to a counter bump +
``profile.capture`` event — a profiler problem must never kill the serve
loop that hosts it. Exported families:
``zoo_profile_captures_total{trigger=}``,
``zoo_profile_capture_failures_total``.
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import shutil
import threading
import time
from typing import Callable, Dict, Optional

from ..common import faults
from .metrics import MetricsRegistry, default_registry

__all__ = ["ProfilerTrigger"]

log = logging.getLogger(__name__)

#: recognized arm() sources; anything else is folded into "manual"
TRIGGERS = ("alert", "http", "manual")


def _conf(key: str, default):
    """Config read through the zoo context when one is live; the default
    otherwise (keeps this module importable without the context)."""
    try:
        from ..common.context import get_zoo_context
        return get_zoo_context().get(key, default)
    except Exception:
        return default


#: the Chrome trace the default stop writes into each capture dir
TRACE_FILE = "trace.json"

#: the process's running default capture: ``(profile, trace_dir)``
_running: Dict[str, object] = {}
#: one thread runs every default start and stop: Kineto wants a capture
#: started and stopped on the same thread, and the arming HTTP request's
#: thread and the stop timer's are two short-lived others
_profiler_thread = concurrent.futures.ThreadPoolExecutor(
    max_workers=1, thread_name_prefix="zoo-profiler")


def _start(trace_dir: str) -> None:
    import torch
    if _running:
        raise RuntimeError("a torch.profiler capture is already running in "
                           "this process")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    kw = {}
    try:     # CPU ops of the serve loop too, not only the arming thread's
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        pass
    prof = torch.profiler.profile(activities=acts, **kw)
    prof.start()
    _running.update(prof=prof, dir=trace_dir)


def _stop() -> None:
    prof, trace_dir = _running.pop("prof", None), _running.pop("dir", "")
    if prof is not None:
        prof.stop()
        prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


def _default_start(trace_dir: str) -> None:
    _profiler_thread.submit(_start, trace_dir).result()


def _default_stop() -> None:
    _profiler_thread.submit(_stop).result()


class ProfilerTrigger:
    """Arms bounded, retention-capped ``torch.profiler`` captures.

    ``start_fn(trace_dir)`` / ``stop_fn()`` default to a
    ``torch.profiler.profile`` started and stopped (its Chrome trace
    exported into ``trace_dir``) and are injectable so tests run the full
    lifecycle without a real profiler. All public methods are safe to
    call from alert-evaluation or HTTP threads; the lock is never held
    across ``start_fn`` / ``stop_fn`` re-entry hazards because both are
    invoked with it held only briefly and are themselves non-reentrant
    by the in-flight guard.
    """

    def __init__(self, trace_dir: Optional[str] = None, *,
                 registry: Optional[MetricsRegistry] = None,
                 keep: Optional[int] = None,
                 duration_s: Optional[float] = None,
                 steps: Optional[int] = None,
                 start_fn: Optional[Callable[[str], None]] = None,
                 stop_fn: Optional[Callable[[], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.trace_dir = str(trace_dir if trace_dir is not None
                             else _conf("zoo.profiler.dir", "")) \
            or os.path.join(os.getcwd(), "zoo-profiles")
        self.keep = int(keep if keep is not None
                        else _conf("zoo.profiler.keep", 3))
        self.duration_s = float(duration_s if duration_s is not None
                                else _conf("zoo.profiler.duration_s", 10.0))
        self.steps = int(steps if steps is not None
                         else _conf("zoo.profiler.steps", 0))
        self.registry = registry if registry is not None \
            else default_registry()
        self._start_fn = start_fn or _default_start
        self._stop_fn = stop_fn or _default_stop
        self._clock = clock
        self._lock = threading.Lock()
        self._active: Optional[Dict[str, object]] = None
        self._timer: Optional[threading.Timer] = None
        self._seq = 0
        self._m_captures = {}
        for trig in ("alert", "http", "manual"):
            self._m_captures[trig] = self.registry.counter(
                "zoo_profile_captures_total",
                "profiler captures successfully started, by what armed "
                "them (ProfilerTrigger)",
                labels={"trigger": trig})
        self._m_failures = self.registry.counter(
            "zoo_profile_capture_failures_total",
            "capture starts that failed (profiler unavailable, trace dir "
            "unwritable, injected fault) — always degrades gracefully, "
            "never raises into the host loop")

    # -- lifecycle -----------------------------------------------------------
    def arm(self, trigger: str = "manual", reason: str = "") -> Optional[str]:
        """Start a bounded capture; returns its trace directory, or
        ``None`` when one is already in flight or the start failed.
        Never raises."""
        trig = trigger if trigger in TRIGGERS else "manual"
        with self._lock:
            if self._active is not None:
                self.registry.emit("profile.capture", phase="skipped",
                                   trigger=trig, reason="in_flight")
                return None
            self._seq += 1
            cap_dir = os.path.join(
                self.trace_dir, f"capture-{self._seq:04d}-{trig}")
            try:
                faults.inject("profiler.capture")
                os.makedirs(cap_dir, exist_ok=True)
                self._start_fn(cap_dir)
            except Exception as exc:
                self._m_failures.inc()
                self.registry.emit("profile.capture", phase="failed",
                                   trigger=trig, dir=cap_dir,
                                   error=f"{type(exc).__name__}: {exc}")
                log.warning("profiler capture start failed (%s): %s",
                            trig, exc)
                return None
            self._active = {"dir": cap_dir, "trigger": trig,
                            "t0": self._clock(), "steps_left": self.steps}
            self._m_captures[trig].inc()
            self.registry.emit("profile.capture", phase="start",
                               trigger=trig, dir=cap_dir, reason=reason,
                               duration_s=self.duration_s,
                               steps=self.steps)
            if self.steps <= 0 and self.duration_s > 0:
                self._timer = threading.Timer(self.duration_s, self.stop)
                self._timer.daemon = True
                self._timer.start()
        self._evict()
        return cap_dir

    def step(self) -> None:
        """Step notification from the hosting loop; stops a
        step-bounded capture once its budget is spent. No-op (one lock
        probe) otherwise."""
        with self._lock:
            act = self._active
            if act is None or act["steps_left"] <= 0:
                return
            act["steps_left"] -= 1
            if act["steps_left"] > 0:
                return
        self.stop()

    def stop(self) -> Optional[str]:
        """Stop the in-flight capture (idempotent); returns its trace
        directory, or ``None`` if nothing was running. Never raises."""
        with self._lock:
            act, self._active = self._active, None
            timer, self._timer = self._timer, None
        if act is None:
            return None
        if timer is not None:
            timer.cancel()
        try:
            self._stop_fn()
        except Exception as exc:
            log.warning("profiler capture stop failed: %s", exc)
        self.registry.emit("profile.capture", phase="stop",
                           trigger=act["trigger"], dir=act["dir"],
                           duration_s=round(self._clock() - act["t0"], 6))
        return act["dir"]

    def close(self) -> None:
        self.stop()

    # -- integration ---------------------------------------------------------
    def on_alert(self, transition: Dict[str, object]) -> None:
        """``AlertEngine.add_transition_hook`` target: a rule entering
        ``firing`` arms an alert-triggered capture."""
        if transition.get("state") == "firing":
            self.arm(trigger="alert",
                     reason=str(transition.get("alert", "")))

    def in_flight(self) -> Optional[Dict[str, object]]:
        """``{"dir", "trigger", "age_s"}`` of the active capture, else
        ``None`` — the ``/statusz`` ``performance`` block's view."""
        with self._lock:
            act = self._active
            if act is None:
                return None
            return {"dir": act["dir"], "trigger": act["trigger"],
                    "age_s": round(self._clock() - act["t0"], 6)}

    # -- retention -----------------------------------------------------------
    def _evict(self) -> None:
        """Keep only the newest ``keep`` capture dirs (by sequence name,
        which is creation order); never evicts the active capture."""
        if self.keep <= 0:
            return
        try:
            names = sorted(n for n in os.listdir(self.trace_dir)
                           if n.startswith("capture-"))
        except OSError:
            return
        with self._lock:
            active = self._active["dir"] if self._active else None
        for name in names[:-self.keep] if len(names) > self.keep else []:
            path = os.path.join(self.trace_dir, name)
            if path == active:
                continue
            shutil.rmtree(path, ignore_errors=True)
            self.registry.emit("profile.capture", phase="evicted",
                               dir=path)
