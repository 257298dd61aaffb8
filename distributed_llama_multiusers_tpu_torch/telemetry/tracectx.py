"""Trace context: one id per request, carried across every hop.

A ``TraceContext`` is a 128-bit trace id plus the 64-bit span id of the
hop that forwarded the request, accepted from a client's
``X-DLlama-Trace`` header (or minted by a front end). The server stamps
the trace id on every span the request emits, so ``/trace?trace_id=``
returns one request's events and traces from several processes can be
merged on it. The port's copy of the JAX package's ``tracectx.py``: the
same wire format, so a header minted by one package parses in the other.

Wire format (the ``X-DLlama-Trace`` header value)::

    <32 lowercase hex chars trace id>-<16 lowercase hex chars span id>

shaped like W3C traceparent's id fields without the version/flags
framing. Invalid headers are *ignored* (a fresh context is minted, or
none is kept), never answered with 400: tracing must not be able to fail
a request. Ids come from ``os.urandom``; no wall-clock reads.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

from ..lockcheck import make_lock


TRACE_HEADER = "X-DLlama-Trace"

_WIRE_RE = re.compile(r"^([0-9a-f]{32})-([0-9a-f]{16})$")

# an all-zero id is the W3C-traceparent "invalid" convention; refuse it
_ZERO_TRACE = "0" * 32
_ZERO_SPAN = "0" * 16


@dataclass(frozen=True)
class TraceContext:
    """One request's identity across processes: ``trace_id`` names the
    request for its whole life, ``span_id``
    names the hop that forwarded it (re-minted per hop via ``child()``,
    so a replica can tell a retry from the original attempt)."""

    trace_id: str
    span_id: str

    @staticmethod
    def mint() -> "TraceContext":
        """A fresh context: 128-bit trace id, 64-bit span id, both from
        ``os.urandom`` (no wall clock, no PRNG state to guard)."""
        return TraceContext(
            trace_id=os.urandom(16).hex(), span_id=os.urandom(8).hex()
        )

    def child(self) -> "TraceContext":
        """Same trace, fresh span id — stamp one per forwarding hop
        (route attempt, retry, hand-off) so the
        merged timeline attributes each hop distinctly."""
        return TraceContext(trace_id=self.trace_id, span_id=os.urandom(8).hex())

    def to_header(self) -> str:
        return f"{self.trace_id}-{self.span_id}"

    @staticmethod
    def parse(value: str | None) -> "TraceContext | None":
        """Parse a wire value; ``None`` on anything malformed (callers
        mint a fresh context instead — tracing never fails a request)."""
        if not value or not isinstance(value, str):
            return None
        m = _WIRE_RE.match(value.strip().lower())
        if m is None:
            return None
        trace_id, span_id = m.group(1), m.group(2)
        if trace_id == _ZERO_TRACE or span_id == _ZERO_SPAN:
            return None
        return TraceContext(trace_id=trace_id, span_id=span_id)

    @staticmethod
    def accept(value: str | None) -> "TraceContext":
        """A front end's ingress rule (the fleet router's): honour a valid
        client header, mint otherwise."""
        ctx = TraceContext.parse(value)
        return ctx if ctx is not None else TraceContext.mint()


def trace_id_of(wire: str | None) -> str | None:
    """The trace id of a wire value, or None — the one-liner span
    emitters use to stamp ``trace_id`` args without caring whether the
    request carried a context at all."""
    ctx = TraceContext.parse(wire)
    return None if ctx is None else ctx.trace_id


# phase keys every producer emits, in display order. ``sync_ms`` is only
# non-zero when the mesh reports measured collective time; off-mesh it
# stays 0 rather than absent so consumers need no key probing.
PHASE_KEYS = (
    "queue_wait_ms", "prefill_ms", "decode_ms", "itl_p50_ms", "itl_p99_ms",
    "migration_gap_ms", "swap_in_ms", "sync_ms", "ttft_ms", "total_ms",
)


class PhaseAccumulator:
    """Router-side aggregation of per-request ``phases`` records.

    The router sees every completion's terminal payload (streaming
    terminal chunk or non-streaming body); folding the ``phases`` record
    there gives fleet-wide TTFT/ITL/phase distributions measured at the
    one vantage point that also knows about migrations. Kept deliberately
    small: per-phase count/sum under one short lock; the bucketed
    distribution lives in the caller's ``MetricsRegistry`` histogram
    (``dllama_request_phase_seconds``), fed from the same observe call.
    """


    def __init__(self):
        # witness-wrappable (DLLAMA_LOCKCHECK=1); the aggregation state
        # moves only under it
        self._phase_lock = make_lock("PhaseAccumulator._phase_lock")
        self._phase_counts: dict[str, int] = {}
        self._phase_sums_ms: dict[str, float] = {}
        self._phase_records = 0

    def observe(self, phases: dict | None) -> dict | None:
        """Fold one ``phases`` record; returns the cleaned record (only
        known keys, numeric values) or None if there was nothing usable.
        Callers feed the same cleaned record into their histogram so the
        accumulator and ``/metrics`` cannot drift."""
        if not isinstance(phases, dict):
            return None
        clean = {}
        for key in PHASE_KEYS:
            v = phases.get(key)
            if isinstance(v, (int, float)) and v >= 0:
                clean[key] = float(v)
        if not clean:
            return None
        with self._phase_lock:
            self._phase_records += 1
            for key, v in clean.items():
                self._phase_counts[key] = self._phase_counts.get(key, 0) + 1
                self._phase_sums_ms[key] = (
                    self._phase_sums_ms.get(key, 0.0) + v
                )
        return clean

    def snapshot(self) -> dict:
        """{records, per-phase count + sum_ms} for /stats — dict-valued,
        so the stats bridge republishes it as labelled gauges."""
        with self._phase_lock:
            return {
                "phase_records": self._phase_records,
                "phase_counts": dict(self._phase_counts),
                "phase_sum_ms": {
                    k: round(v, 3) for k, v in self._phase_sums_ms.items()
                },
            }
