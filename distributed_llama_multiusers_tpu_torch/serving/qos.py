"""Bounded admission + per-user fair scheduling for the serving queue.

The port's copy of the JAX package's ``serving/qos.py``, the scheduler's
queue (runtime/scheduler.py). Production continuous-batching servers (Orca-style iteration-level scheduling, vLLM's
scheduler) all pair the batching loop with an admission/QoS layer; this is
that layer. Three properties a bare FIFO lacks:

- **bounded admission** — at most ``capacity`` queued requests; overflow
  raises the typed :class:`AdmissionRejected` (the HTTP layer maps it to
  429 + ``Retry-After``) instead of growing an unbounded backlog that melts
  the server under overload.
- **priority classes** — strict ``HIGH > NORMAL > LOW`` between classes: a
  lower class pops only when every higher class is empty. Priority orders
  *service*, not admission: at capacity ``push`` sheds regardless of class
  (no eviction), so a full LOW backlog does lock HIGH out until it drains —
  pair ``capacity`` with queue timeouts (deadlines.py) to bound that window.
  Sustained HIGH floods can starve LOW by design.
- **deficit round robin** keyed by ``user_id`` within a class (Shreedhar &
  Varghese, SIGCOMM '95): each user in the rotation earns ``quantum`` cost
  credit per visit and a request pops only when its user's credit covers its
  cost (``max_tokens``), so one user's burst of large requests cannot starve
  other users' small ones. Unserved credit accumulates (a big request
  eventually goes); post-service carryover is capped at one quantum so a
  cheap-request user cannot bank unbounded credit while backlogged.

Thread-safe. Requests are duck-typed (``user_id`` / ``priority`` / ``max_tokens`` / ``submitted_at``
attributes, all optional).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from enum import IntEnum
from typing import Callable

from ..lockcheck import make_lock


class Priority(IntEnum):
    """Strict admission classes; lower value pops first."""

    HIGH = 0
    NORMAL = 1
    LOW = 2

    @staticmethod
    def parse(value) -> "Priority":
        """Accept ``"high"/"normal"/"low"`` (HTTP bodies) or the int value."""
        if isinstance(value, Priority):
            return value
        if isinstance(value, str):
            try:
                return Priority[value.strip().upper()]
            except KeyError:
                raise ValueError(
                    f"unknown priority {value!r} (expected high, normal, or low)"
                ) from None
        try:
            return Priority(int(value))
        except (TypeError, ValueError):
            raise ValueError(
                f"unknown priority {value!r} (expected high, normal, or low)"
            ) from None


class AdmissionRejected(RuntimeError):
    """Typed load-shed signal: the request never entered the queue.

    ``reason`` is ``"queue_full"`` (bounded admission, HTTP 429),
    ``"draining"`` (graceful shutdown in progress, HTTP 503),
    ``"breaker_open"`` (the engine circuit breaker is shedding while the
    engine is unhealthy, HTTP 503 — serving/breaker.py), or
    ``"pool_exhausted"`` (the paged KV pool is pinned by active lanes,
    HTTP 429) or ``"host_tier_full"`` (the same, with the host swap tier
    at its byte budget, HTTP 429); all carry a ``retry_after_s`` hint
    for the ``Retry-After`` header."""

    def __init__(
        self,
        reason: str,
        capacity: int = 0,
        queue_depth: int = 0,
        retry_after_s: float = 1.0,
    ):
        self.reason = reason
        self.capacity = capacity
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s
        self.http_status = (
            503 if reason in ("draining", "breaker_open") else 429
        )
        if reason == "draining":
            msg = "server is draining; not admitting new requests"
        elif reason == "breaker_open":
            msg = (
                "engine circuit breaker open (repeated engine failures); "
                f"retry in ~{retry_after_s:.0f}s"
            )
        elif reason == "pool_exhausted":
            msg = (
                "kv page pool exhausted (pinned by active requests; "
                "see --kv-pool-pages/--kv-max-parked); "
                f"retry in ~{retry_after_s:.0f}s"
            )
        elif reason == "host_tier_full":
            msg = (
                "kv page pool exhausted with the host swap tier at its "
                "budget (see --kv-host-bytes/--kv-pool-pages); "
                f"retry in ~{retry_after_s:.0f}s"
            )
        else:
            msg = (
                f"queue full ({queue_depth}/{capacity} waiting); "
                f"retry in ~{retry_after_s:.0f}s"
            )
        super().__init__(msg)


def _default_cost(req) -> float:
    """DRR cost of a request: its token demand (the decode-lane time it will
    hold), never below one so zero/absent max_tokens still consumes credit."""
    return float(max(1, getattr(req, "max_tokens", 1) or 1))


def page_cost(page_size: int) -> Callable[[object], float]:
    """DRR cost in KV PAGES for paged engines (the contiguous layout
    charges tokens; ``app/runtime_setup.make_scheduler`` wires it): the
    pages this request's admission will reserve — prompt + max_tokens
    (+1 for the boundary token's KV write), rounded up to page granularity.

    On the contiguous layout every admission costs one identical lane, so
    token demand (decode time) is the only axis users can differ on. The
    paged pool makes HBM itself the contended resource — a 10-page
    admission displaces ten times the parked sessions a 1-page one does —
    so fair share must charge what admission actually takes from the
    pool, or one user's long-context requests would evict every other
    user's parked prefixes at the same DRR price as a one-liner.

    Cost is evaluated at POP time on queued requests, before
    tokenization: ``n_prompt_tokens`` is used when a recovery replay or
    an earlier pass already resolved it, otherwise the prompt's token
    count is estimated at ~4 chars/token (the usual BPE density; the
    estimate only orders the DRR rotation, admission itself charges the
    exact reservation)."""
    page_size = max(1, int(page_size))

    def _cost(req) -> float:
        prompt = int(getattr(req, "n_prompt_tokens", 0) or 0)
        if prompt <= 0:
            prompt = len(getattr(req, "prompt", "") or "") // 4 + 1
        tokens = prompt + int(max(1, getattr(req, "max_tokens", 1) or 1)) + 1
        return float(max(1, -(-tokens // page_size)))

    return _cost


def jittered_retry_after(seconds: float, key: int,
                         spread: float = 0.2) -> float:
    """``seconds`` with deterministic ±``spread`` jitter, floored at 1s.

    Every shed path (breaker open, queue full, stalled-503) hands clients
    a Retry-After; when a replica trips, it sheds a BURST of clients with
    the SAME hint, and their synchronized retries land as a thundering
    herd on the exact second the replica reopens — re-tripping it. The
    jitter de-synchronizes the herd. Deterministic by design (a pure
    splitmix64 hash of ``key`` — use the request id; the same finalizer
    the fault plan's Bernoulli trigger uses): the same shed decision
    always renders the same header, so tests and log correlation stay
    exact, while distinct requests spread across the ±20% band."""
    from ..utils.faults import _mix64

    u = (_mix64(int(key) * 0x9E3779B97F4A7C15) >> 11) / float(1 << 53)
    return max(1.0, float(seconds) * (1.0 - spread + 2.0 * spread * u))


class QosQueue:
    """Priority + deficit-round-robin request queue with bounded admission.

    ``capacity`` 0 means unbounded (library default — the serving entry point
    passes ``--max-queue``). ``quantum`` is the per-visit credit in cost
    units (tokens); it sets the interleave grain — a user must wait roughly
    ``cost/quantum`` rotation visits before a request that large pops.
    """

    def __init__(
        self,
        capacity: int = 0,
        quantum: float = 128.0,
        cost: Callable[[object], float] | None = None,
    ):
        if quantum <= 0:
            raise ValueError("quantum must be positive")
        self.capacity = max(0, int(capacity))
        self.quantum = float(quantum)
        self._cost = cost or _default_cost
        # built via make_lock so the runtime lock-order witness
        # (DLLAMA_LOCKCHECK=1, lockcheck.py) can wrap it; every queue and
        # counter field below moves under it (or its condition)
        self._lock = make_lock("QosQueue._lock")
        self._not_empty = threading.Condition(self._lock)
        # priority -> (user_id -> FIFO of that user's requests); the
        # OrderedDict order IS the DRR rotation for that class
        self._levels: dict[int, OrderedDict[str, deque]] = {}
        self._deficit: dict[tuple[int, str], float] = {}
        self._depth = 0
        # counters (exposed via stats(), surfaced on /stats)
        self._admitted = 0
        self._popped = 0
        self._rejected: dict[str, int] = {"queue_full": 0, "draining": 0}
        self._removed = 0  # taken out by remove_if/drain, never popped
        self._wait_s_total = 0.0
        self._recent_waits: deque[float] = deque(maxlen=64)
        self._max_depth = 0
        # optional pop-time wait observer (telemetry queue-wait histogram);
        # set once before serving via set_wait_observer, invoked OUTSIDE
        # the queue lock by design
        self._on_pop_wait: Callable[[float], None] | None = None

    # -- queue surface ------------------------------------------------------

    def push(self, request) -> None:
        """Admit or shed: raises :class:`AdmissionRejected` at capacity —
        the caller (HTTP layer) turns that into a 429, so overload degrades
        into fast rejections instead of unbounded queueing."""
        with self._not_empty:
            if self.capacity and self._depth >= self.capacity:
                self._rejected["queue_full"] += 1
                raise AdmissionRejected(
                    "queue_full",
                    capacity=self.capacity,
                    queue_depth=self._depth,
                    retry_after_s=self._retry_after_locked(),
                )
            if getattr(request, "submitted_at", None) is None:
                request.submitted_at = time.monotonic()
            prio = int(getattr(request, "priority", Priority.NORMAL))
            user = str(getattr(request, "user_id", "") or "")
            level = self._levels.setdefault(prio, OrderedDict())
            dq = level.get(user)
            if dq is None:
                level[user] = dq = deque()
            dq.append(request)
            self._depth += 1
            self._admitted += 1
            self._max_depth = max(self._max_depth, self._depth)
            self._not_empty.notify()

    def pop(self, timeout: float | None = None):
        """Next request by (priority, per-user DRR); ``None`` on timeout.
        ``timeout=None`` blocks until a request arrives (Queue semantics);
        the scheduler's idle loop parks here instead of spinning."""
        wait = None
        with self._not_empty:
            if self._depth == 0 and timeout is not None:
                deadline = time.monotonic() + timeout
                while self._depth == 0:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._not_empty.wait(remaining)
            while self._depth == 0:
                self._not_empty.wait()
            req = self._pop_drr_locked()
            self._depth -= 1
            self._popped += 1
            t0 = getattr(req, "submitted_at", None)
            if t0 is not None:
                wait = max(0.0, time.monotonic() - t0)
                self._wait_s_total += wait
                self._recent_waits.append(wait)
        # observer runs OUTSIDE the queue lock: a histogram bump must never
        # extend the critical section every submit()/pop() contends on
        observer = self._on_pop_wait
        if wait is not None and observer is not None:
            observer(wait)
        return req

    def set_wait_observer(self, observer: Callable[[float], None] | None) -> None:
        """Install a callback invoked with each popped request's queue
        wait (seconds) — the telemetry queue-wait histogram feed, so the
        histogram's count reconciles with ``queue_popped`` exactly. Call
        before serving starts; the callback runs on the scheduler thread,
        outside the queue lock, and must not touch the queue."""
        self._on_pop_wait = observer

    def empty(self) -> bool:
        """Advisory emptiness (racy by nature, same contract as the FIFO)."""
        return self._depth == 0

    def drain(self) -> list:
        """Remove and return everything queued (shutdown path). Drained
        requests count as removed so the stats reconciliation (admitted =
        popped + removed + depth) survives a stop()/start() cycle."""
        with self._not_empty:
            out = []
            for level in self._levels.values():
                for dq in level.values():
                    out.extend(dq)
            self._levels.clear()
            self._deficit.clear()
            self._depth = 0
            self._removed += len(out)
            return out

    # -- QoS surface ---------------------------------------------------------

    def depth(self) -> int:
        return self._depth

    def remove_if(self, predicate) -> list:
        """Remove and return every queued request matching ``predicate`` —
        the scheduler's deadline sweep, so queue-wait timeouts fire even
        while all lanes stay saturated and nothing is being popped."""
        out = []
        with self._not_empty:
            for prio in list(self._levels):
                level = self._levels[prio]
                for user in list(level):
                    matched = []
                    kept = deque()
                    for r in level[user]:  # evaluate predicate exactly once
                        (matched if predicate(r) else kept).append(r)
                    if not matched:
                        continue  # common case: leave the deque untouched
                    out.extend(matched)
                    if kept:
                        level[user] = kept
                    else:
                        del level[user]
                        self._deficit.pop((prio, user), None)
                if not level:
                    del self._levels[prio]
            self._depth -= len(out)
            self._removed += len(out)
        return out

    def note_rejection(self, reason: str) -> None:
        """Count a rejection decided outside the queue (e.g. the scheduler
        shedding submissions during drain) so /stats sees all shed load."""
        with self._lock:
            self._rejected[reason] = self._rejected.get(reason, 0) + 1

    def stats(self) -> dict:
        """Point-in-time counter snapshot (single lock hold)."""
        with self._lock:
            avg = self._wait_s_total / self._popped if self._popped else 0.0
            return {
                "queue_depth": self._depth,
                "queue_capacity": self.capacity,
                "queue_admitted": self._admitted,
                "queue_popped": self._popped,
                "queue_rejected_full": self._rejected.get("queue_full", 0),
                "queue_rejected_draining": self._rejected.get("draining", 0),
                "queue_rejected_breaker": self._rejected.get("breaker_open", 0),
                # admitted = popped + removed + depth always reconciles
                "queue_removed": self._removed,
                "queue_wait_s_total": round(self._wait_s_total, 6),
                "queue_wait_avg_s": round(avg, 6),
                "queue_max_depth": self._max_depth,
            }

    # -- internals -----------------------------------------------------------

    def _retry_after_locked(self) -> float:
        # two congestion signals, floored at 1s: the average queue wait over
        # the last few dozen pops (a lifetime average would let one past
        # overload era inflate the hint forever), and the age of the oldest
        # request still waiting — during full saturation nothing pops, so
        # the pop-time average alone would tell clients to hammer a stuck
        # server with ~1s retries. Each per-user deque is FIFO, so only the
        # fronts need checking (O(waiting users), only paid on rejection).
        hint = 1.0
        if self._recent_waits:
            hint = max(hint, sum(self._recent_waits) / len(self._recent_waits))
        now = time.monotonic()
        for level in self._levels.values():
            for dq in level.values():
                t0 = getattr(dq[0], "submitted_at", None)
                if t0 is not None:
                    hint = max(hint, now - t0)
        return hint

    def _pop_drr_locked(self):
        for prio in sorted(self._levels):
            level = self._levels[prio]
            while level:
                # one full rotation: visit each user once, crediting a quantum
                min_rounds = None
                for user in list(level):
                    dq = level[user]
                    key = (prio, user)
                    cost = self._cost(dq[0])
                    credit = self._deficit.get(key, 0.0) + self.quantum
                    level.move_to_end(user)  # visited: back of the rotation
                    if credit >= cost:
                        req = dq.popleft()
                        if dq:
                            # cap carryover at one quantum: a backlogged
                            # cheap-request user must not bank unbounded
                            # credit (see module doc)
                            self._deficit[key] = min(credit - cost, self.quantum)
                        else:
                            del level[user]
                            self._deficit.pop(key, None)
                            if not level:
                                del self._levels[prio]
                        return req
                    # not enough credit yet: bank it; rounds = how many more
                    # full rotations until this user's head request pops
                    self._deficit[key] = credit
                    rounds = int(-(-(cost - credit) // self.quantum))
                    if min_rounds is None or rounds < min_rounds:
                        min_rounds = rounds
                # nobody could afford its head request this rotation: advance
                # the rotation clock arithmetically — every user earns one
                # quantum per silent rotation, so handing out min_rounds-1
                # quanta at once and letting the next real rotation add the
                # last one yields deficits identical to spinning, in O(users)
                # instead of O(cost/quantum) iterations under the queue lock
                # (one request with a huge max_tokens must not stall every
                # push/pop/stats caller while credit trickles in)
                if min_rounds > 1:
                    for user in level:
                        self._deficit[(prio, user)] += (min_rounds - 1) * self.quantum
        raise RuntimeError("pop on empty queue (caller must hold depth > 0)")
