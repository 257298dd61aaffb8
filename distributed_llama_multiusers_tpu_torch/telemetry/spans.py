"""Span tracer: a bounded ring of lifecycle/step events, host-side only.

The scheduler stamps what it already knows from its own host metadata —
request lifecycle transitions (submitted → queued → admitted → prefill
chunks → pipelined dispatch/consume pairs → finish/cancel/timeout) and
per-dispatch step slices — into a fixed-capacity ring. Nothing in here
ever reads a device value (no numpy, no torch), and nothing in here is
called from
the pipelined DISPATCH half: step slices are recorded at CONSUME time,
one step behind, where the host is already blocking on the lagged
readback — so tracing adds zero syncs and zero locks to the hot
dispatch path (``decode_pipelined`` / ``decode_prefill_fused`` /
``_pipeline_dispatch``).

Timestamps are ``time.perf_counter()`` relative to the tracer's origin —
monotonic by construction, and
exactly the timebase Chrome trace events want (µs offsets, not wall
time). The ring evicts oldest-first under overflow and counts what it
dropped, so a trace pulled from a long-lived server is the most recent
window, honestly labelled.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, replace

from ..lockcheck import make_lock
from .tracectx import trace_id_of


# span/instant names, for reference (docs/OBSERVABILITY.md lists them all):
#   queued          X  submit -> admit (or -> unadmitted resolution)
#   generate        X  admit -> finish, on the lane's track
#   prefill.sync    X  one synchronous prompt chunk on a lane
#   prefill.fused   X  one fused-dispatch prompt chunk on a lane
#   step.sync/spec/multi  X  one synchronous engine dispatch
#   step.pipelined  X  pipelined step, dispatch -> lagged consume
#   step.fused      X  fused prefill+decode step, dispatch -> lagged consume
#   submitted / admitted / finish.<reason> / pipeline.flush   i  instants


@dataclass(frozen=True)
class SpanEvent:
    """One trace event. ``ts``/``dur`` are seconds on the tracer's
    monotonic timebase; ``ph`` is the Chrome phase ("X" slice, "i"
    instant); ``track`` names the Perfetto row it lands on."""

    name: str
    ph: str
    ts: float
    dur: float
    track: str
    req_id: int | None = None
    args: dict | None = None
    # monotone per-tracer event cursor (assigned at append): pollers pass
    # the last seq they saw as /trace's `since=` param and stop
    # re-downloading the whole ring every scrape
    seq: int = 0


class SpanTracer:
    """Bounded, thread-safe event ring (oldest evicted first)."""

    def __init__(self, capacity: int = 16384):
        self.capacity = max(1, int(capacity))
        # perf_counter origin: every event's ts is relative to this, so a
        # trace's µs timestamps start near 0 regardless of process uptime
        self.origin = time.perf_counter()
        # witness-wrappable (DLLAMA_LOCKCHECK=1); the ring state below
        # moves only under it
        self._trace_lock = make_lock("SpanTracer._trace_lock")
        # eviction is explicit (not deque maxlen) so drops attribute to
        # the track they truncated — a silently shortened lane track is
        # the failure mode per-track counts exist to make visible
        self._trace_ring: deque[SpanEvent] = deque()
        self._trace_dropped = 0
        self._trace_dropped_by_track: dict[str, int] = {}
        self._trace_total = 0
        self._trace_seq = 0

    def now(self) -> float:
        return time.perf_counter()

    def _append(self, ev: SpanEvent) -> None:
        with self._trace_lock:
            self._trace_seq += 1
            ev = replace(ev, seq=self._trace_seq)
            if len(self._trace_ring) >= self.capacity:
                old = self._trace_ring.popleft()
                self._trace_dropped += 1
                self._trace_dropped_by_track[old.track] = (
                    self._trace_dropped_by_track.get(old.track, 0) + 1
                )
            self._trace_ring.append(ev)
            self._trace_total += 1

    def slice(self, name: str, track: str, t0: float, t1: float | None = None,
              req_id: int | None = None, args: dict | None = None) -> None:
        """Record a complete span [t0, t1] (t1 defaults to now)."""
        if t1 is None:
            t1 = time.perf_counter()
        self._append(SpanEvent(
            name, "X", t0, max(0.0, t1 - t0), track, req_id, args
        ))

    def instant(self, name: str, track: str, ts: float | None = None,
                req_id: int | None = None, args: dict | None = None) -> None:
        if ts is None:
            ts = time.perf_counter()
        self._append(SpanEvent(name, "i", ts, 0.0, track, req_id, args))

    def snapshot(self, since: int = 0,
                 trace_id: str | None = None) -> list[SpanEvent]:
        """Point-in-time copy of the ring, oldest first.

        ``since`` keeps only events with ``seq`` strictly greater (the
        /trace poller cursor); ``trace_id`` keeps only events whose args
        carry that trace id (the cross-replica merge filter)."""
        with self._trace_lock:
            events = list(self._trace_ring)
        if since:
            events = [e for e in events if e.seq > since]
        if trace_id is not None:
            events = [
                e for e in events
                if e.args is not None and e.args.get("trace_id") == trace_id
            ]
        return events

    def counts(self) -> dict:
        """{recorded, dropped, buffered, cursor, per-track drops} —
        surfaced on /stats so an evicting ring is visible, not silent,
        and a truncated track is attributable (dict-valued: the stats
        bridge republishes it as ``{key="..."}``-labelled gauges)."""
        with self._trace_lock:
            return {
                "trace_events_recorded": self._trace_total,
                "trace_events_dropped": self._trace_dropped,
                "trace_events_buffered": len(self._trace_ring),
                "trace_events_cursor": self._trace_seq,
                "trace_events_dropped_by_track": dict(
                    self._trace_dropped_by_track
                ),
            }


class RequestTrace:
    """Per-request latency record, attached to a ``Request`` at submit.

    NOT thread-safe by design: only the scheduler loop writes it (token
    stamps), and readers (summary in the HTTP response, the per-request
    log line) run after the request's future resolves, which the Future
    machinery orders after the scheduler's last write."""

    __slots__ = (
        "submitted_at", "admitted_at", "first_token_at", "last_token_at",
        "gaps", "n_tokens", "fused_admitted", "prefix_saved",
        "span_t0", "lane", "swap_in_s",
    )

    def __init__(self, submitted_at: float | None = None):
        # monotonic request clock (time.monotonic, the deadline timebase)
        self.submitted_at = (
            time.monotonic() if submitted_at is None else submitted_at
        )
        self.admitted_at: float | None = None
        self.first_token_at: float | None = None
        self.last_token_at: float | None = None
        self.gaps: list[float] = []  # inter-token gaps, seconds
        self.n_tokens = 0
        self.fused_admitted = False
        self.prefix_saved = 0
        # span clock (perf_counter) for the lifecycle slices
        self.span_t0 = time.perf_counter()
        self.lane: int | None = None
        # host time the paged admission spent swapping this request's
        # pages back from the host tier
        self.swap_in_s = 0.0

    def on_token(self, now: float) -> None:
        """Stamp one consumed token (``now`` = time.monotonic())."""
        if self.first_token_at is None:
            self.first_token_at = now
        else:
            self.gaps.append(max(0.0, now - self.last_token_at))
        self.last_token_at = now
        self.n_tokens += 1

    @property
    def ttft_s(self) -> float | None:
        if self.first_token_at is None:
            return None
        return max(0.0, self.first_token_at - self.submitted_at)

    @property
    def queued_s(self) -> float | None:
        if self.admitted_at is None:
            return None
        return max(0.0, self.admitted_at - self.submitted_at)

    def tbt_quantile(self, q: float) -> float | None:
        """Exact per-request inter-token-gap quantile (nearest-rank) —
        raw gaps, not the bucketed registry histogram (a single request
        has few enough gaps to keep them all)."""
        if not self.gaps:
            return None
        ordered = sorted(self.gaps)
        idx = min(len(ordered) - 1, int(round(q * (len(ordered) - 1))))
        return ordered[idx]

    def phases(self) -> dict:
        """Per-request phase attribution (milliseconds): where this
        request's wall time went, phase by phase. Attached to completion
        responses, with the JAX package's keys.

        ``swap_in_ms`` is the paged admission's host-tier swap-in time
        (0 on the contiguous layout). ``migration_gap_ms`` and ``sync_ms``
        are 0 in the port: it has no migration and no measured collective
        time per request."""
        ms = lambda v: 0.0 if v is None else round(max(0.0, v) * 1e3, 3)
        prefill_s = None
        if self.admitted_at is not None and self.first_token_at is not None:
            prefill_s = self.first_token_at - self.admitted_at
        decode_s = None
        if self.first_token_at is not None and self.last_token_at is not None:
            decode_s = self.last_token_at - self.first_token_at
        total_s = None
        if self.last_token_at is not None:
            total_s = self.last_token_at - self.submitted_at
        return {
            "queue_wait_ms": ms(self.queued_s),
            "prefill_ms": ms(prefill_s),
            "decode_ms": ms(decode_s),
            "itl_p50_ms": ms(self.tbt_quantile(0.50)),
            "itl_p99_ms": ms(self.tbt_quantile(0.99)),
            "migration_gap_ms": 0.0,
            "swap_in_ms": ms(self.swap_in_s),
            "sync_ms": 0.0,
            "ttft_ms": ms(self.ttft_s),
            "total_ms": ms(total_s),
        }

    def summary(self, req, finish_reason: str | None) -> dict:
        """The per-request summary attached to completion responses and
        emitted as the request's JSON log line — identical between the
        stream and non-stream paths by construction (one producer)."""
        rnd = lambda v: None if v is None else round(v, 6)
        out = {
            "request_id": req.id,
            "finish_reason": finish_reason,
            "queued_s": rnd(self.queued_s),
            "ttft_s": rnd(self.ttft_s),
            "tbt_p50_s": rnd(self.tbt_quantile(0.50)),
            "tbt_p95_s": rnd(self.tbt_quantile(0.95)),
            "n_prompt_tokens": req.n_prompt_tokens,
            "n_generated_tokens": len(req.generated_tokens),
            "prefix_tokens_saved": self.prefix_saved,
            "fused_admitted": self.fused_admitted,
            "phases": self.phases(),
        }
        # requests carry the wire-form context ("<trace>-<span>", the
        # X-DLlama-Trace value); the summary surfaces just the trace id,
        # the key clients correlate on
        trace_id = trace_id_of(getattr(req, "trace", None))
        if trace_id:
            out["trace_id"] = trace_id
        return out
