"""Circuit breaker for the serving path: shed instead of thrash.

When the engine fails repeatedly (a CUDA out-of-memory that will recur
on every dispatch, a lost card, a watchdog-detected stall), admitting more work only queues more clients behind a broken
engine. The breaker turns that into the standard closed → open →
half-open machine:

- **closed** — healthy. Engine-scoped failures count; ``threshold``
  CONSECUTIVE ones (any successful step resets the streak) trip it open.
- **open** — ``/health`` reports unhealthy (load balancers route away)
  and ``submit()`` sheds new work with a typed
  :class:`~.qos.AdmissionRejected` (HTTP 503 + Retry-After). Work
  already admitted keeps running — the breaker gates admission, never
  execution. After ``cooldown_s`` the next ``allow()`` transitions to
  half-open and admits that caller as the probe.
- **half-open** — one probe request per cooldown window; a successful
  engine step closes the breaker (``recovered``), another engine-scoped
  failure re-opens it and restarts the cooldown.

The scheduler owns the one breaker instance and drives it from the
supervised loop (runtime/scheduler.py): ``record_engine_failure`` from
the containment path, ``record_success`` from every completed engine
step, ``trip`` from the watchdog. ``stats()`` feeds ``/stats`` and —
bridged like every other field — the ``dllama_breaker_state`` gauge and
``dllama_engine_failures_total{failure_class}`` counter on ``/metrics``
(telemetry/hub.bridge_stats, delta-fed so counter semantics survive
window resets).

Thread-safe; pure counter math under one lock, monotonic clocks only.
"""

from __future__ import annotations

import time

from ..lockcheck import make_lock

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"

# numeric encoding for the /metrics gauge (and the /stats twin field):
# gauges can't carry strings, and alert rules want `> 0` to mean unhealthy
STATE_CODES = {STATE_CLOSED: 0, STATE_HALF_OPEN: 1, STATE_OPEN: 2}


class CircuitBreaker:
    """``threshold`` consecutive engine-scoped failures open the circuit;
    ``cooldown_s`` later a single probe is allowed through (half-open);
    its success closes, its failure re-opens."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 5.0):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        if cooldown_s <= 0:
            raise ValueError("breaker cooldown must be positive")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._lock = make_lock("CircuitBreaker._lock")
        self._state = STATE_CLOSED
        self._consecutive = 0  # engine failures since the last success
        self._opened_at = 0.0  # monotonic stamp of the last open
        self._last_probe_at = 0.0
        # failure accounting by class — the dllama_engine_failures_total
        # label vocabulary ("engine", "request", "watchdog")
        self._failures: dict[str, int] = {}
        self._trips = 0  # closed/half-open -> open transitions
        self._shed = 0  # allow() == False decisions (submissions refused)
        self._probes = 0  # half-open probes admitted
        self._last_error = ""
        self._last_recovery_s: float | None = None  # open -> closed span

    # -- admission gate ------------------------------------------------------

    def allow(self) -> bool:
        """May a new request be admitted right now? Open + cooldown
        elapsed transitions to half-open and admits THIS caller as the
        probe; half-open admits one probe per cooldown window."""
        now = time.monotonic()
        with self._lock:
            if self._state == STATE_CLOSED:
                return True
            if self._state == STATE_OPEN:
                if now - self._opened_at < self.cooldown_s:
                    self._shed += 1
                    return False
                self._state = STATE_HALF_OPEN
                self._last_probe_at = now
                self._probes += 1
                return True
            # half-open: one probe per cooldown window
            if now - self._last_probe_at >= self.cooldown_s:
                self._last_probe_at = now
                self._probes += 1
                return True
            self._shed += 1
            return False

    def retry_after_s(self) -> float:
        """Retry-After hint for shed submissions: the remaining cooldown,
        floored at 1s (a client retrying sooner meets the same open
        circuit)."""
        now = time.monotonic()
        with self._lock:
            if self._state == STATE_CLOSED:
                return 1.0
            remaining = self.cooldown_s - (now - self._opened_at)
        return max(1.0, remaining)

    # -- scheduler feedback --------------------------------------------------

    def record_engine_failure(self, error: str = "",
                              failure_class: str = "engine") -> str:
        """One engine-scoped failure (containment path). Returns the
        post-transition state for the caller's log line."""
        with self._lock:
            self._failures[failure_class] = (
                self._failures.get(failure_class, 0) + 1
            )
            self._last_error = error[:200]
            self._consecutive += 1
            if self._state == STATE_HALF_OPEN or (
                self._state == STATE_CLOSED
                and self._consecutive >= self.threshold
            ):
                self._state = STATE_OPEN
                self._opened_at = time.monotonic()
                self._trips += 1
            return self._state

    def record_request_failure(self) -> None:
        """Class accounting only: a request-scoped failure (bad prompt,
        tokenizer error) says nothing about engine health and never moves
        the state machine."""
        with self._lock:
            self._failures["request"] = self._failures.get("request", 0) + 1

    def record_success(self) -> None:
        """One successful engine step: the failure streak resets; a
        half-open probe's success closes the circuit. From OPEN, a
        success (work admitted before the trip, still being served)
        closes only once the cooldown has held — the circuit stays open
        at least ``cooldown_s`` after a trip, so a watchdog trip or a
        failure burst cannot flap closed off one lucky step."""
        now = time.monotonic()
        with self._lock:
            self._consecutive = 0
            if self._state == STATE_HALF_OPEN or (
                self._state == STATE_OPEN
                and now - self._opened_at >= self.cooldown_s
            ):
                self._last_recovery_s = now - self._opened_at
                self._state = STATE_CLOSED

    def trip(self, error: str = "watchdog",
             failure_class: str = "watchdog") -> None:
        """Force the circuit open regardless of the streak — the watchdog
        path (a stalled step is worse evidence than N failed ones)."""
        with self._lock:
            self._failures[failure_class] = (
                self._failures.get(failure_class, 0) + 1
            )
            self._last_error = error[:200]
            if self._state != STATE_OPEN:
                self._trips += 1
            self._state = STATE_OPEN
            self._opened_at = time.monotonic()

    # -- exposition ----------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def stats(self) -> dict:
        """Point-in-time snapshot for /stats (one lock hold). The
        ``breaker_state_code`` / ``engine_failures`` fields are the ones
        telemetry/hub.bridge_stats feeds the native metrics from."""
        with self._lock:
            return {
                "breaker_state": self._state,
                "breaker_state_code": STATE_CODES[self._state],
                "breaker_threshold": self.threshold,
                "breaker_consecutive_failures": self._consecutive,
                "breaker_trips": self._trips,
                "breaker_shed": self._shed,
                "breaker_probes": self._probes,
                "breaker_last_error": self._last_error,
                "breaker_last_recovery_s": (
                    None if self._last_recovery_s is None
                    else round(self._last_recovery_s, 3)
                ),
                "engine_failures": dict(self._failures),
                "engine_failures_total": sum(self._failures.values()),
            }
