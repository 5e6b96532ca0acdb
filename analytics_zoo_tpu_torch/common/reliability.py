"""Reliability primitives — port of ``analytics_zoo_tpu/common/
reliability.py``, pure Python:

* :class:`RetryPolicy` — exponential backoff with full jitter, bounded
  attempts, a deadline cap and error classification;
* :class:`CircuitBreaker` — closed → open → half-open with single-probe
  admission (``zoo_breaker_state{breaker=}``,
  ``zoo_breaker_transitions_total{breaker=,state=}``);
* :class:`RetryBudget` — a shared deterministic token bucket: retries
  withdraw, successes deposit, an empty bucket refuses
  (``zoo_retry_budget_exhausted_total{budget=}``);
* :class:`AIMDController` — bounded additive-increase /
  multiplicative-decrease control, deterministic (no clock, no RNG).

Consumers: the serving loop (supervised loops, breaker-guarded reads,
dispatch breakers, retries, the adaptive batch target) and the inference
runtime (chunk readback retries), as in the JAX package.
"""

from __future__ import annotations

import itertools
import logging
import random
import threading
import time
from typing import Callable, Iterator, Optional, Tuple, Type

log = logging.getLogger("analytics_zoo_tpu_torch.reliability")

__all__ = ["RetryPolicy", "RetryBudget", "CircuitBreaker",
           "CircuitOpenError", "AIMDController"]

#: default transient-transport classification: connection drops, socket
#: errors and timeouts retry; everything else (protocol errors, bugs)
#: propagates immediately
DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (
    ConnectionError, OSError, TimeoutError)


class CircuitOpenError(RuntimeError):
    """The breaker is open: the protected resource failed repeatedly and
    the cool-down window has not elapsed — fail fast instead of adding
    load to a struggling backend. ``retry_in`` is the seconds until the
    next half-open probe is admitted."""

    def __init__(self, name: str, retry_in: float):
        super().__init__(f"circuit {name!r} is open; next probe in "
                         f"{retry_in:.3f}s")
        self.breaker = name
        self.retry_in = retry_in


class RetryBudget:
    """Global retry token bucket — the fleet-wide brake on correlated
    retries (the classic Finagle/SRE "retry budget": per-op backoff
    bounds ONE caller, but when a whole backend goes down every caller
    retries ``max_attempts`` times at once and the retry storm multiplies
    the outage load).

    Semantics (deterministic — no RNG, so chaos tests reconcile exactly):

    * each **retry** withdraws one token (``withdraw()`` → False once the
      bucket is empty; the caller must NOT retry, counting the refusal in
      ``zoo_retry_budget_exhausted_total{budget=...}``),
    * each **success** deposits ``deposit`` tokens (capped at
      ``capacity``), so the sustained retry rate is bounded at roughly
      ``deposit`` retries per success — a healthy system earns its retry
      allowance, a broken one drains the bucket once and then fails fast.

    One budget is meant to be SHARED across every caller of a protected
    resource (pass the same instance to each ``RetryPolicy.call`` /
    ``ClusterServing(retry_budget=...)``); all methods are thread-safe.
    """

    def __init__(self, capacity: float = 100.0, deposit: float = 0.1,
                 name: str = "default", registry=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1 ({capacity})")
        if deposit < 0:
            raise ValueError(f"deposit must be >= 0 ({deposit})")
        self.capacity = float(capacity)
        self.deposit = float(deposit)
        self.name = name
        self._tokens = float(capacity)
        self._lock = threading.Lock()
        self._m_exhausted = None
        if registry is not None:
            # budget names are operator-chosen code identifiers (a
            # handful per process), not request data
            self._m_exhausted = registry.counter(  # zoolint: disable=ZL015 bounded label set
                "zoo_retry_budget_exhausted_total",
                "retries refused because the shared retry budget was "
                "empty (a correlated outage draining the bucket)",
                labels={"budget": name})

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def withdraw(self) -> bool:
        """Take one token for a retry. False (and a count in the
        exhausted metric) when the bucket is empty — the caller must not
        retry."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
        if self._m_exhausted is not None:
            self._m_exhausted.inc()
        log.warning("retry budget %r exhausted; refusing retry", self.name)
        return False

    def on_success(self) -> None:
        """Deposit after a successful call (retried or not)."""
        with self._lock:
            self._tokens = min(self.capacity, self._tokens + self.deposit)


class RetryPolicy:
    """Exponential backoff with full jitter, bounded attempts, a deadline
    cap, and error classification.

    * ``max_attempts`` — total tries (1 = no retry). :meth:`delays`
      yields at most ``max_attempts - 1`` backoff values.
    * ``base_delay`` / ``max_delay`` — the k-th retry waits
      ``U[0, min(max_delay, base_delay * 2**k)]`` seconds (full jitter;
      ``jitter=False`` uses the envelope itself, for tests that need
      exact wall bounds).
    * ``deadline`` — optional RELATIVE seconds budget applied per
      :meth:`call`/:meth:`wait_for` invocation; a per-call ``timeout``
      overrides it. Delays are trimmed to the remaining budget and the
      sequence stops once it is exhausted — a retried operation can
      never overshoot its caller's deadline by more than one attempt.
    * ``retryable`` / per-call ``classify`` — which exceptions retry.
      Idempotent reads retry by default; non-idempotent writes must be
      classified per-op by the caller (cf. ``serving/resp.py``: XADD
      never retries, a duplicate stream entry is worse than an error).
    * ``seed`` — deterministic jitter: the same seed yields the same
      delay sequence on every call (chaos tests depend on this).

    Policies are immutable and thread-safe; generators returned by
    :meth:`delays` are single-use like any generator.
    """

    def __init__(self, max_attempts: int = 5, base_delay: float = 0.05,
                 max_delay: float = 2.0, deadline: Optional[float] = None,
                 retryable: Tuple[Type[BaseException], ...] = DEFAULT_RETRYABLE,
                 jitter: bool = True, seed: Optional[int] = None):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1 ({max_attempts})")
        if base_delay < 0 or max_delay < 0:
            raise ValueError("delays must be >= 0")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.deadline = deadline
        self.retryable = tuple(retryable)
        self.jitter = bool(jitter)
        self.seed = seed

    def __repr__(self) -> str:
        return (f"RetryPolicy(max_attempts={self.max_attempts}, "
                f"base_delay={self.base_delay}, max_delay={self.max_delay}, "
                f"deadline={self.deadline}, seed={self.seed})")

    # -- the backoff sequence ------------------------------------------------
    def _rng(self):
        # a FRESH generator per sequence: a seeded policy must produce the
        # same delays every time it is consulted, not a continuation
        return random.Random(self.seed) if self.seed is not None else random

    def _envelope(self, k: int) -> float:
        # cap the doubling exponent: 2.0**k overflows a float past ~1024
        # rounds, and the envelope saturates at max_delay long before —
        # a long-lived wait_for poll must not crash at poll 1025
        return min(self.max_delay, self.base_delay * (2.0 ** min(k, 64)))

    def delays(self, deadline: Optional[float] = None) -> Iterator[float]:
        """Yield the sleep before each retry (so ``max_attempts - 1``
        values at most). ``deadline`` is an ABSOLUTE ``time.monotonic()``
        stamp (defaults to now + ``self.deadline`` when the policy has
        one); each delay is trimmed to the remaining budget and the
        sequence ends once the budget is spent."""
        if deadline is None and self.deadline is not None:
            deadline = time.monotonic() + self.deadline
        rng = self._rng()
        start = time.monotonic()
        yielded = 0.0
        for k in range(self.max_attempts - 1):
            env = self._envelope(k)
            d = rng.uniform(0.0, env) if self.jitter else env
            if deadline is not None:
                # budget spent = real elapsed OR the delays already
                # handed out, whichever is larger — so the cap holds both
                # for real sleepers and for test consumers with a no-op
                # sleep (deterministic truncation)
                spent = max(time.monotonic() - start, yielded)
                remaining = (deadline - start) - spent
                if remaining <= 0:
                    return
                d = min(d, remaining)
            yield d
            yielded += d

    # -- classification ------------------------------------------------------
    def should_retry(self, exc: BaseException,
                     classify: Optional[Callable[[BaseException], bool]]
                     = None) -> bool:
        if classify is not None:
            return bool(classify(exc))
        return isinstance(exc, self.retryable)

    # -- wrappers ------------------------------------------------------------
    def call(self, fn: Callable, *, op: str = "op",
             classify: Optional[Callable[[BaseException], bool]] = None,
             sleep: Callable[[float], None] = time.sleep,
             timeout: Optional[float] = None, registry=None,
             budget: Optional["RetryBudget"] = None):
        """Run ``fn()`` with retries. Non-retryable errors propagate
        immediately; retryable ones back off and re-run until attempts or
        the deadline run out, then the LAST error propagates. Each retry
        increments ``zoo_retry_attempts_total{op=...}`` in ``registry``
        (when given) and logs at warning level — silent retries hide a
        dying backend until it is fully dead.

        ``budget`` (a shared :class:`RetryBudget`) additionally gates
        every retry on the GLOBAL token bucket — an exhausted budget
        raises the last error immediately instead of piling this caller's
        retries onto a correlated outage; successes deposit back."""
        deadline = None
        time_budget = self.deadline if timeout is None else timeout
        if time_budget is not None:
            deadline = time.monotonic() + time_budget
        last: Optional[BaseException] = None
        counter = None
        if registry is not None:
            # op names are call-site string constants (one per
            # retried operation), not request data
            counter = registry.counter(  # zoolint: disable=ZL015 bounded label set
                "zoo_retry_attempts_total",
                "retries performed by reliability.RetryPolicy, by operation",
                labels={"op": op})
        for d in itertools.chain((None,), self.delays(deadline)):
            if d is not None:
                if budget is not None and not budget.withdraw():
                    log.warning("%s: retry budget exhausted after (%s); "
                                "not retrying", op, last)
                    break
                if counter is not None:
                    counter.inc()
                log.warning("%s failed (%s); retry in %.3fs", op, last, d)
                if d > 0:
                    sleep(d)
            try:
                result = fn()
            except Exception as e:
                if not self.should_retry(e, classify):
                    raise
                last = e
            else:
                if budget is not None:
                    budget.on_success()
                return result
        assert last is not None
        raise last

    def wait_for(self, predicate: Callable[[], bool], *,
                 timeout: Optional[float] = None,
                 sleep: Callable[[float], None] = time.sleep) -> bool:
        """Poll ``predicate`` with backoff until it is truthy (→ True) or
        the deadline passes (→ False). Unlike :meth:`call`, attempts are
        unbounded — the deadline is the bound (``timeout`` falls back to
        the policy's ``deadline``; with neither, polls forever — give
        long-lived pollers a default timeout, cf. the serving backends).
        The first check is immediate; delays then follow the jittered
        envelope, trimmed so the final sleep lands on the deadline."""
        deadline = None
        budget = self.deadline if timeout is None else timeout
        if budget is not None:
            deadline = time.monotonic() + budget
        rng = self._rng()
        for k in itertools.count():
            if predicate():
                return True
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
            env = self._envelope(k)
            d = rng.uniform(0.0, env) if self.jitter else env
            if deadline is not None:
                d = min(d, max(deadline - time.monotonic(), 0.0))
            if d > 0:
                sleep(d)
        return False    # unreachable (itertools.count never ends)


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

#: gauge encoding of breaker state — documented in OBSERVABILITY.md
_STATE_VALUE = {"closed": 0, "open": 1, "half_open": 2}


class CircuitBreaker:
    """Closed → open → half-open breaker with single-probe admission.

    * **closed** — calls flow; ``failure_threshold`` CONSECUTIVE
      failures (any success resets the count) trip it open.
    * **open** — :meth:`allow` refuses (callers fail fast / back off
      instead of hammering a down backend) until ``reset_timeout``
      seconds have passed.
    * **half-open** — exactly ONE probe call is admitted; its success
      closes the breaker, its failure re-opens it with a fresh window.
      Further :meth:`allow` calls while the probe is in flight refuse.

    Use either the low-level surface (``allow`` / ``record_success`` /
    ``record_failure`` — how the serve loop wraps its stream reads, so a
    refused read can *wait* instead of raising) or :meth:`call`, which
    raises :class:`CircuitOpenError` when refused.

    ``clock`` is injectable for deterministic tests. All methods are
    thread-safe. State is exported on every transition:
    ``zoo_breaker_state{breaker=name}`` (0 closed / 1 open / 2
    half-open) and ``zoo_breaker_transitions_total{breaker=,state=}``.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, name: str = "breaker", failure_threshold: int = 5,
                 reset_timeout: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if reset_timeout <= 0:
            raise ValueError("reset_timeout must be > 0")
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout = float(reset_timeout)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._probe_inflight = False
        self._registry = registry
        self._gauge = None
        if registry is not None:
            # breaker names are code-defined identifiers, one per
            # guarded dependency
            self._gauge = registry.gauge(  # zoolint: disable=ZL015 bounded label set
                "zoo_breaker_state",
                "circuit state: 0 closed, 1 open, 2 half-open",
                labels={"breaker": name})
            self._gauge.set(_STATE_VALUE[self.CLOSED])

    # -- state machine (call under self._lock) -------------------------------
    def _transition(self, new_state: str) -> None:
        if new_state == self._state:
            return
        self._state = new_state
        if self._gauge is not None:
            self._gauge.set(_STATE_VALUE[new_state])
        if self._registry is not None:
            # breaker = code identifier, state = the 3-value enum
            self._registry.counter(  # zoolint: disable=ZL015 bounded label set
                "zoo_breaker_transitions_total",
                "circuit state transitions, labeled by the state entered",
                labels={"breaker": self.name, "state": new_state}).inc()
            self._registry.emit("breaker.transition", breaker=self.name,
                                state=new_state)
        log.info("circuit %r -> %s", self.name, new_state)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def probe_in(self) -> float:
        """Seconds until the next probe would be admitted (0 when calls
        are currently allowed)."""
        with self._lock:
            if self._state == self.CLOSED:
                return 0.0
            if self._state == self.HALF_OPEN:
                return 0.0 if not self._probe_inflight else self.reset_timeout
            assert self._opened_at is not None
            return max(self._opened_at + self.reset_timeout - self._clock(),
                       0.0)

    def allow(self) -> bool:
        """Whether a call may proceed now. In half-open, admits exactly
        one probe — the caller MUST resolve it with ``record_success`` /
        ``record_failure`` (or further probes stay refused until the
        reset window elapses again)."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                assert self._opened_at is not None
                if self._clock() - self._opened_at < self.reset_timeout:
                    return False
                self._transition(self.HALF_OPEN)
                self._probe_inflight = False
            # half-open: one probe only
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            self._transition(self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == self.HALF_OPEN:
                # the probe failed: back to open with a fresh window
                self._probe_inflight = False
                self._opened_at = self._clock()
                self._transition(self.OPEN)
                return
            self._failures += 1
            if self._state == self.CLOSED \
                    and self._failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._transition(self.OPEN)

    # -- wrapper -------------------------------------------------------------
    def call(self, fn: Callable, *args, **kwargs):
        """Run ``fn`` under the breaker: raises :class:`CircuitOpenError`
        when refused; otherwise records the outcome and re-raises any
        failure."""
        if not self.allow():
            raise CircuitOpenError(self.name, self.probe_in())
        try:
            result = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result


# ---------------------------------------------------------------------------
# AIMD controller
# ---------------------------------------------------------------------------

class AIMDController:
    """Bounded additive-increase / multiplicative-decrease controller.

    The control shape TCP congestion avoidance (and Clipper-style
    adaptive batching) uses: while the observed signal is healthy the
    value climbs ``add`` per update toward ``ceiling``; one breach backs
    it off by ``backoff`` (multiplicative), never below ``floor``. The
    asymmetry is the point — growth probes capacity slowly, a breach
    sheds it immediately, and the loop converges instead of oscillating
    wall to wall.

    Deterministic: no RNG, no clock — the value after N updates is a
    pure function of the breach sequence, so tests reconcile the target
    trajectory exactly. Thread-safe; ``value`` reads the current target
    without updating it."""

    def __init__(self, floor: int = 1, ceiling: int = 32,
                 initial: Optional[int] = None, add: float = 1.0,
                 backoff: float = 0.5):
        if floor < 1:
            raise ValueError(f"floor must be >= 1 ({floor})")
        if ceiling < floor:
            raise ValueError(f"ceiling {ceiling} < floor {floor}")
        if add <= 0:
            raise ValueError(f"add must be > 0 ({add})")
        if not 0.0 < backoff < 1.0:
            raise ValueError(f"backoff must be in (0, 1) ({backoff})")
        self.floor = int(floor)
        self.ceiling = int(ceiling)
        self.add = float(add)
        self.backoff = float(backoff)
        v = ceiling if initial is None else initial
        if not floor <= v <= ceiling:
            raise ValueError(f"initial {v} outside [{floor}, {ceiling}]")
        self._value = float(v)
        self._lock = threading.Lock()

    @property
    def value(self) -> int:
        with self._lock:
            return int(self._value)

    def update(self, overloaded: bool) -> int:
        """One control step: ``overloaded=True`` backs off
        multiplicatively, ``False`` grows additively. Returns the new
        integer target."""
        with self._lock:
            if overloaded:
                self._value = max(float(self.floor),
                                  self._value * self.backoff)
            else:
                self._value = min(float(self.ceiling), self._value + self.add)
            return int(self._value)
