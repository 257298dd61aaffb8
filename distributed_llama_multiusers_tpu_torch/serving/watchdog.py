"""Step watchdog: a hung step must become a signal, not a hang.

A step that never returns (a kernel that never finishes, a host thread
blocked in a readback of a lost card) blocks the batching-loop thread:
every future hangs and ``/health`` keeps reporting healthy.

The watchdog is a monitor thread fed from the scheduler's blocking
engine-call sites: ``begin_step()`` right before the host blocks on the
device (sync decode, prefill chunk, lagged pipeline consume),
``step_done()`` when the call returns. If an armed step makes no
progress within ``deadline_s`` the watchdog trips ONCE for that step and
invokes ``on_trip``: the scheduler trips the circuit breaker (``/health``
flips, new work sheds with 503) and flags the pipelined chain to abort at
the next opportunity. The blocked thread itself cannot be unblocked from
here, and a kernel on the card cannot be cancelled; the point is that the
OUTSIDE of the process finds out (clients get 503s and the HTTP layer's
bounded waits, operators get the log line and metrics) instead of a
silent wedge.

``fatal=True`` (a pod root, parallel/multihost.py, as in the JAX package)
also ends the process after the trip, so that its peers see a dead process
rather than a silent one: a root whose worker died waits in a ring step
that never completes.

Off by default: ``deadline_s <= 0`` never constructs one. The CLI
surface is ``--step-deadline`` / ``DLLAMA_STEP_DEADLINE`` (seconds).
Monotonic clocks only; no imports from runtime/ or server/.
"""

from __future__ import annotations

import os
import threading
import time

from ..lockcheck import make_lock
from ..telemetry.logs import log_event

WATCHDOG_EXIT_CODE = 17  # distinctive: "killed by own watchdog, on purpose"


class StepWatchdog:
    """Trips when an armed step shows no progress for ``deadline_s``.

    ``on_trip(waited_s)`` runs on the watchdog thread, OUTSIDE the
    watchdog lock (it takes the breaker's and telemetry's locks; holding
    ours across that would put an edge in the lock-order graph for no
    reason). One trip per armed step: the trip disarms, and only the
    next ``begin_step()`` re-arms.
    """

    def __init__(self, deadline_s: float, on_trip=None, fatal: bool = False):
        if deadline_s <= 0:
            raise ValueError("watchdog deadline must be positive (use no "
                             "watchdog at all to disable)")
        self.deadline_s = float(deadline_s)
        self.fatal = bool(fatal)
        self._trip_fn = on_trip
        self._lock = make_lock("StepWatchdog._lock")
        self._cond = threading.Condition(self._lock)
        self._armed_at: float | None = None
        self._running = False
        self._wd_trips = 0
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        with self._cond:
            if self._running:
                return
            self._running = True
        self._thread = threading.Thread(
            target=self._run, name="step-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        with self._cond:
            self._running = False
            self._armed_at = None
            self._cond.notify_all()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5)
            self._thread = None

    # -- scheduler feed ------------------------------------------------------

    def begin_step(self) -> None:
        """The host is about to block on the device: arm the deadline."""
        with self._cond:
            self._armed_at = time.monotonic()
            self._cond.notify_all()

    def step_done(self) -> None:
        """The blocking call returned (success OR exception — a raised
        step is the containment layer's business, not a stall): disarm."""
        with self._cond:
            self._armed_at = None
            self._cond.notify_all()

    # -- exposition ----------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "watchdog_deadline_s": self.deadline_s,
                "watchdog_trips": self._wd_trips,
            }

    # -- monitor thread ------------------------------------------------------

    def _run(self) -> None:
        while True:
            waited = 0.0
            with self._cond:
                while self._running:
                    t0 = self._armed_at
                    if t0 is None:
                        self._cond.wait()
                        continue
                    now = time.monotonic()
                    if now - t0 > self.deadline_s:
                        # trip: disarm so one stall fires exactly once
                        waited = now - t0
                        self._armed_at = None
                        self._wd_trips += 1
                        break
                    self._cond.wait(self.deadline_s - (now - t0) + 0.001)
                if not self._running:
                    return
            # outside the lock: the callback takes breaker/telemetry locks
            self._fire(waited)

    def _fire(self, waited_s: float) -> None:
        log_event(
            "watchdog_trip",
            waited_s=round(waited_s, 3),
            deadline_s=self.deadline_s,
            fatal=self.fatal,
        )
        if self._trip_fn is not None:
            try:
                self._trip_fn(waited_s)
            except Exception:  # noqa: BLE001 — a fatal trip must still exit
                pass
        if self.fatal:
            # multi-process mode: deliberate process death, which peers
            # detect, where a silent hang would wedge them all
            os._exit(WATCHDOG_EXIT_CODE)


def deadline_from_env(flag_value: float | None = None) -> float:
    """Resolve the step deadline: explicit flag wins, then
    ``DLLAMA_STEP_DEADLINE``, else 0 (off)."""
    if flag_value is not None:
        return max(0.0, float(flag_value))
    env = os.environ.get("DLLAMA_STEP_DEADLINE")
    if not env:
        return 0.0
    try:
        return max(0.0, float(env))
    except ValueError:
        return 0.0
