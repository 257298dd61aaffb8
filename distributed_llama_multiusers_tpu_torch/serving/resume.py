"""Resumable SSE streams: bounded per-request delta buffers + reattach (the
port's copy of the JAX package's ``serving/resume.py``).

The transport half of crash-durable serving (serving/journal.py,
serving/recovery.py). Every streamed delta carries a TOKEN INDEX (the
count of consumed tokens when the delta was produced — the SSE ``id:``
line), and a :class:`StreamRelay` buffers the ``(index, delta)`` pairs
between the scheduler's emit and the HTTP pump. That one indirection
buys both halves of resumption:

- **live reconnect** — a client that lost its connection re-attaches
  within the ``--reconnect-grace`` window (``GET /v1/stream/<id>`` with
  ``Last-Event-ID``); the relay replays the buffered deltas with index >
  Last-Event-ID and continues live. The request keeps generating while
  detached (today's cancel-on-disconnect applies only when the grace
  window is 0, the default); the grace reaper cancels it if nobody
  returns.
- **crash recovery** — recovery re-admits the request and registers a
  fresh relay: the ENTIRE regenerated stream buffers (``base=0``) and
  the reconnecting client's ``Last-Event-ID`` picks the resume point,
  so the resumed stream is byte-identical — zero lost, zero duplicated
  tokens. The journaled watermark is deliberately NOT used to
  fast-forward: it trails the dead server's transport writes, and a
  delta written to a socket send buffer the moment of the crash never
  reached the client — discarding up to the watermark would turn that
  client's honest reattach into a gap. (``base`` still serves relays
  built over an explicitly known-delivered prefix, e.g. in tests.)

The buffer is BOUNDED (``capacity`` deltas) — but eviction only ever
reclaims DELIVERED deltas (kept past delivery so a reconnect at a lower
``Last-Event-ID`` can replay them). An undelivered delta is never
evicted out from under a slow-but-connected client: past capacity the
undelivered tail backpressures into memory exactly like the unbounded
(capacity 0) form, bounded by ``max_tokens`` and the registry's grace
reaper. A client reattaching behind the evicted (delivered) horizon
gets a typed ``("gap", ...)`` item — the server fails the resume closed
with a restart-required error instead of silently skipping tokens.
"""

from __future__ import annotations

import bisect
import threading
import time

from ..analysis import leakcheck
from ..lockcheck import make_lock

DEFAULT_RELAY_CAPACITY = 4096


class StreamRelay:
    """One request's resumable delta buffer.

    Producer: the scheduler thread (``Request.on_delta`` wrapper pushes
    ``(token_index, text)``; the future's done-callback pushes the finish
    signal). Consumer: at most one HTTP pump at a time — ``attach()``
    hands out a generation token and supersedes the previous consumer,
    so a reconnect cleanly kicks a zombie socket still blocked in
    ``next_after``.
    """


    def __init__(self, request_id: int, base: int = 0,
                 capacity: int = DEFAULT_RELAY_CAPACITY):
        """``capacity`` <= 0 keeps NO replay window — the no-reconnect
        default path uses that to match the plain delta queue it
        replaced (delivered deltas freed immediately; reattach is
        impossible there anyway); ``capacity`` > 0 is for
        registry-managed relays, where it caps the DELIVERED replay
        window kept around for reconnects. Undelivered deltas are exempt
        either way — a slow-but-connected client backpressures into
        memory, nothing it has not seen is ever dropped."""
        self.request_id = int(request_id)
        self.base = int(base)  # indices <= base were already delivered
        self.capacity = int(capacity)
        self._lock = make_lock("StreamRelay._lock")
        self._cv = threading.Condition(self._lock)
        # parallel ascending lists (indices pushed in consume order):
        # bisect over _rl_index finds a consumer's next delta in O(log n)
        # instead of rescanning the buffer per delta
        self._rl_index: list[int] = []
        self._rl_deltas: list[str] = []
        # highest index ever evicted from the buffer (base counts: deltas
        # <= base are never buffered — they were delivered pre-crash)
        self._rl_evicted_to = int(base)
        # highest index handed to a consumer (base counts: pre-crash
        # tokens were delivered) — the eviction floor
        self._rl_sent = int(base)
        self._rl_done = False
        self._rl_gen = 0  # consumer generation (reconnect supersedes)
        self._rl_pushed = 0  # deltas accepted (fast-forwarded ones excluded)

    # -- producer side (scheduler thread) ------------------------------------

    def push(self, index: int, text: str) -> None:
        """One emitted delta. Indices <= base are dropped — that is the
        crash-recovery fast-forward: the regenerated stream re-produces
        the delivered prefix and the relay swallows it."""
        if index <= self.base:
            return
        with self._cv:
            self._rl_index.append(int(index))
            self._rl_deltas.append(text)
            self._rl_pushed += 1
            if self.capacity > 0 and len(self._rl_index) > self.capacity:
                # reclaim DELIVERED deltas only (<= _rl_sent): the
                # capacity bound is on the reconnect-replay window, never
                # on the undelivered tail a slow-but-connected client is
                # still owed. Batch slice-del with capacity//4 slack so
                # the amortized per-push cost stays O(1) on the scheduler
                # thread (a pop(0) per token would memmove the whole
                # buffer every push once full).
                k = min(
                    bisect.bisect_right(self._rl_index, self._rl_sent),
                    len(self._rl_index) - self.capacity + self.capacity // 4,
                )
            elif self.capacity <= 0:
                # no replay window at all (the default no-reconnect
                # path): a delivered delta can never be asked for again,
                # so free it now — the buffer holds only the undelivered
                # backlog, like the plain delta queue this replaced
                k = bisect.bisect_right(self._rl_index, self._rl_sent)
            else:
                k = 0
            if k > 0:
                if self._rl_index[k - 1] > self._rl_evicted_to:
                    self._rl_evicted_to = self._rl_index[k - 1]
                del self._rl_index[:k]
                del self._rl_deltas[:k]
            self._cv.notify_all()

    def finish(self) -> None:
        """The request's future resolved (any outcome); wake consumers.
        Idempotent — safe as a done-callback plus explicit calls."""
        with self._cv:
            self._rl_done = True
            self._cv.notify_all()

    # -- consumer side (HTTP pump threads) -----------------------------------

    def attach(self) -> int:
        """Claim the consumer slot; the previous consumer's next
        ``next_after`` returns ``("superseded",)`` and it unwinds."""
        with self._cv:
            self._rl_gen += 1
            self._cv.notify_all()
            return self._rl_gen

    def next_after(self, last_index: int, timeout: float, gen: int):
        """The next item for a consumer that has seen deltas up to
        ``last_index``:

        - ``("delta", index, text)`` — the next buffered delta;
        - ``("gap", evicted_to)`` — deltas after ``last_index`` were
          evicted; byte-identical resumption is impossible, fail closed;
        - ``("done",)`` — no more deltas will come (future resolved);
        - ``("superseded",)`` — another consumer attached; unwind;
        - ``None`` — nothing within ``timeout`` (stall signal).
        """
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                if gen != self._rl_gen:
                    return ("superseded",)
                if last_index < self._rl_evicted_to:
                    return ("gap", self._rl_evicted_to)
                i = bisect.bisect_right(self._rl_index, last_index)
                if i < len(self._rl_index):
                    idx = self._rl_index[i]
                    if idx > self._rl_sent:
                        self._rl_sent = idx
                    return ("delta", idx, self._rl_deltas[i])
                if self._rl_done:
                    return ("done",)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cv.wait(remaining)

    def counts(self) -> tuple[int, int]:
        """(deltas accepted, buffered now) — test/stats surface."""
        with self._lock:
            return self._rl_pushed, len(self._rl_index)


class _Entry:
    __slots__ = ("req", "relay", "kind", "detached_at", "finished_at")

    def __init__(self, req, relay, kind):
        self.req = req
        self.relay = relay
        self.kind = kind  # "chat" | "completion" | None
        self.detached_at: float | None = None  # client gone since (monotonic)
        self.finished_at: float | None = None  # future done since (monotonic)


class StreamRegistry:
    """request_id -> live :class:`StreamRelay` map with the grace reaper.

    Entries survive a client disconnect for ``grace_s`` seconds (the
    ``--reconnect-grace`` window): while detached the request keeps
    generating into its bounded relay; a reattach clears the timer; an
    expiry cancels the request (freeing its lane) and drops the relay.
    Finished entries linger the same window so a client that lost its
    connection just before the terminal chunk can still fetch the tail.
    """



    def __init__(self, grace_s: float, relay_capacity: int = DEFAULT_RELAY_CAPACITY):
        if grace_s <= 0:
            raise ValueError("StreamRegistry needs a positive grace window")
        self.grace_s = float(grace_s)
        self.relay_capacity = int(relay_capacity)
        self._lock = make_lock("StreamRegistry._lock")
        self._cv = threading.Condition(self._lock)
        self._rg_entries: dict[int, _Entry] = {}
        self._rg_closed = False
        self._rg_expired_cancels = 0  # grace expiries that cancelled work
        self._rg_reattaches = 0
        self._thread = threading.Thread(
            target=self._reaper, name="resume-reaper", daemon=True
        )
        self._thread.start()

    # -- registration --------------------------------------------------------

    def register(self, req, kind: str | None = None,
                 base: int = 0) -> StreamRelay:
        """Create and index the request's relay (base = journal watermark
        for recovered requests, 0 for fresh streams) and hook the
        future's done-callback to the finish signal."""
        relay = StreamRelay(req.id, base=base, capacity=self.relay_capacity)
        with self._cv:
            self._rg_entries[int(req.id)] = _Entry(req, relay, kind)
        req.future.add_done_callback(lambda _f: relay.finish())
        return relay

    def attach(self, request_id: int):
        """Reattach a reconnecting client: returns ``(req, relay, kind,
        gen)`` — gen already claimed — or ``None`` for an unknown/expired
        stream. Clears the detach timer."""
        with self._cv:
            entry = self._rg_entries.get(int(request_id))
            if entry is None:
                return None
            entry.detached_at = None
            self._rg_reattaches += 1
            req, relay, kind = entry.req, entry.relay, entry.kind
        return req, relay, kind, relay.attach()

    def detach(self, request_id: int) -> None:
        """The consumer disconnected: start the grace timer (the request
        keeps generating; the reaper cancels on expiry)."""
        with self._cv:
            entry = self._rg_entries.get(int(request_id))
            if entry is not None and entry.detached_at is None:
                entry.detached_at = time.monotonic()
                self._cv.notify_all()

    def discard(self, request_id: int) -> None:
        """Drop an entry whose request never entered service (shed at
        submit, abandoned by the recovery replay): nothing will ever
        resolve its future or detach it, so the sweep's done/detached
        rules alone would leak it forever."""
        with self._cv:
            self._rg_entries.pop(int(request_id), None)

    def contains(self, request_id: int) -> bool:
        """Whether ``request_id`` has an entry, without touching its timer
        (the migration route's id-collision check)."""
        with self._lock:
            return int(request_id) in self._rg_entries

    def depth(self) -> int:
        with self._lock:
            return len(self._rg_entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "resume_streams_live": len(self._rg_entries),
                "resume_reattaches": self._rg_reattaches,
                "resume_expired_cancels": self._rg_expired_cancels,
            }

    # -- reaper --------------------------------------------------------------

    def _sweep(self, now: float) -> list:
        """Collect expired entries under the lock; cancellation happens
        OUTSIDE it (never invoke request machinery under a registry
        lock)."""
        to_cancel = []
        with self._cv:
            for rid in list(self._rg_entries):
                entry = self._rg_entries[rid]
                done = entry.req.future.done()
                if done and entry.finished_at is None:
                    entry.finished_at = now
                if done and now - entry.finished_at > self.grace_s:
                    del self._rg_entries[rid]
                elif (
                    not done
                    and entry.detached_at is not None
                    and now - entry.detached_at > self.grace_s
                ):
                    del self._rg_entries[rid]
                    to_cancel.append(entry.req)
                    self._rg_expired_cancels += 1
        return to_cancel

    def _reaper(self) -> None:
        interval = max(0.05, min(self.grace_s / 4.0, 1.0))
        while True:
            with self._cv:
                if self._rg_closed:
                    return
                self._cv.wait(interval)
                if self._rg_closed:
                    return
            for req in self._sweep(time.monotonic()):
                req.cancel()

    def close(self, timeout: float | None = 5.0) -> None:
        # resource-leak witness (analysis/leakcheck.py): close runs after
        # the scheduler stopped, and a stopped scheduler resolved every
        # future it ever saw — an entry whose future is still pending
        # belongs to a request that NEVER entered service and was never
        # discarded (a shed path that lost its discard); no reaper rule can
        # ever collect it. Live attached/finished streams all have done
        # futures by now and are NOT orphans.
        with self._cv:
            orphans = sum(
                1
                for e in self._rg_entries.values()
                if not e.req.future.done()
            )
            self._rg_closed = True
            self._cv.notify_all()
        self._thread.join(timeout)
        leakcheck.check_drained(
            "stream registry close", {"stream_entries": orphans}
        )
