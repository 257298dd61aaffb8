"""``dllama-router``: the fleet front-end above N engine replicas.

One process, pure stdlib, no model state: the router owns client
connections and steers requests across replicas using only the surfaces
the serving stack already exposes —

- **placement** (fleet/balancer.py): prefix-affine consistent hashing
  steers same-leading-prompt sessions to the replica whose paged KV pool
  already holds the warm prefix pages; keyless requests go least-loaded
  by the queue-depth/free-lane fields scraped from each replica's
  ``GET /load``.
- **typed shed handling**: a replica's 429/503 (queue full, breaker
  open, draining, pool exhausted) is honored — its jittered Retry-After
  becomes a routing backoff — and the request is retried on the next
  eligible replica. Only when EVERY replica is shedding or unreachable
  does the client see a failure: one aggregate 503 whose Retry-After is
  the smallest outstanding hint in the fleet.
- **disaggregated prefill** (disagg/): requests classified **long** by
  prompt length (``--disagg-threshold`` chars) route to a replica
  advertising ``role: prefill`` on its ``/load``; once the first delta
  proves the prompt's KV pages are committed there, the router moves
  the session to a decode replica — KV-page bundle first
  (``/admin/kvpages`` → ``/admin/kvimport``, integrity-hashed), then
  the migration ticket, then reattach — so long prompts stop taxing
  co-resident decode TBT. Any hand-off failure (including the prefill
  replica dying mid-transfer) degrades to the monolithic path: the
  router keeps pumping whatever stream it has, typed fallback counters
  record why.
- **live migration** (fleet/migrate.py): the router caches each
  stream's migration ticket (the session's exported journal admit
  record) at stream start; when the serving replica dies mid-stream, is
  drain-flushed, or sheds the stream, the router injects the ticket
  into another replica (``POST /admin/migrate`` — deterministic replay
  through normal breaker-gated admission), reattaches via
  ``GET /v1/stream/<id>``, skips exactly the characters its client
  already received, and keeps pumping on the SAME client socket. The
  client sees one uninterrupted, byte-identical stream: drains, rolling
  restarts and replica death shed zero requests.

The router re-stamps SSE ``id:`` lines with its own delta counter (it —
not any single replica — owns the client's stream position across
migrations); the ``id`` field inside each chunk keeps the original
request id end-to-end.

Observability mirrors a replica's: ``GET /stats`` (routing table +
counters), ``GET /metrics`` (Prometheus text via telemetry/metrics.py:
per-replica route counts, shed retries, the migration latency
histogram), ``GET /health`` (200 while at least one replica is
eligible).

Fleet-wide distributed tracing (telemetry/tracectx.py,
the JAX package's docs/OBSERVABILITY.md): the router MINTS a trace context per request
(or accepts a valid client ``X-DLlama-Trace``) and propagates it on
every hop — forwards, retries, redispatches, migration ticket
fetch/inject, disagg hand-off — so one request's spans share one trace
id across every process that touched it. The router keeps its OWN span
ring (route/queue-wait slices, migration gaps, hand-off windows) and
merges it with the replicas' rings on ``GET /trace/<trace_id>``:
per-replica clock offsets estimated from the ``/load`` scrape
(offset = local scrape midpoint − the replica's ``trace_clock_us``
stamp, uncertainty = RTT/2) align every ring onto the router's
timebase — applied, and stamped visibly onto every migrated event.
Replica-reported per-request ``phases`` records aggregate into the
``dllama_request_phase_seconds{phase=...}`` histogram on ``/metrics``.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..disagg.prefill import (
    DEFAULT_LONG_PROMPT_CHARS,
    HandoffAborted,
    classify_prompt,
    hand_off,
)
from ..lockcheck import make_lock
from ..telemetry.metrics import MetricsRegistry, log_buckets
from ..telemetry.spans import SpanTracer
from ..telemetry.trace import merge_chrome_traces, tracer_chrome_trace
from ..telemetry.tracectx import TRACE_HEADER, PhaseAccumulator, TraceContext
from .balancer import (
    DEFAULT_AFFINITY_BLOCKS,
    DEFAULT_BLOCK_CHARS,
    FleetBalancer,
    ReplicaState,
    prefix_key,
)
from .migrate import (
    MigrationShed,
    _request_json,
    fetch_ticket,
    inject_session,
    open_stream,
)

DEFAULT_SCRAPE_INTERVAL_S = 0.5
DEFAULT_CONNECT_TIMEOUT_S = 5.0
# streaming reads wait on generation; mirror the replica's own bound
DEFAULT_READ_TIMEOUT_S = 600.0
# migration latency is sub-second locally, seconds cross-rack
MIGRATION_BUCKETS_S = log_buckets(1e-3, 100.0, per_decade=4)

_TRANSPORT_ERRORS = (OSError, http.client.HTTPException)


class _ClientGone(Exception):
    """The router's OWN client dropped the connection — unwind quietly
    (closing the upstream socket lets the replica's cancel-on-disconnect
    / reconnect-grace semantics apply there)."""


class _StreamSession:
    """Router-side state for one proxied SSE stream: what the client has
    received (the char-exact dedup floor migrations resume against), the
    cached migration ticket, and any replica-side failure payload held
    while a migration is attempted."""

    __slots__ = ("key", "request_id", "ticket", "deltas_out",
                 "chars_out", "terminal_seen", "pending_error",
                 "migrations", "handoff_due", "trace", "gap_ms")

    def __init__(self, key):
        self.key = key  # affinity key (None = keyless)
        self.request_id = None
        self.ticket = None
        self.deltas_out = 0  # the router's own SSE id counter
        self.chars_out = 0  # delta chars delivered to the client
        self.terminal_seen = False
        self.pending_error = None
        self.migrations = 0
        # disagg: True while a prefill→decode hand-off is owed — armed
        # when the stream lands on a prefill-role replica, cleared at
        # the (single) attempt so a fallback never retries forever
        self.handoff_due = False
        # fleet trace context (wire form): rides every hop this stream
        # takes as X-DLlama-Trace; the ticket's own trace field re-joins
        # migrated regenerations to the same trace id
        self.trace = None
        # client-visible dead air accumulated across migrations/hand-offs
        # (break detected -> first resumed byte): the router — the only
        # process that saw the whole gap — stamps it into the terminal
        # phases record it forwards
        self.gap_ms = 0.0


class FleetRouter:
    """The routing core + HTTP front-end. ``serve()`` mirrors
    :class:`~..server.http.ApiServer.serve` (returns the bound
    ``ThreadingHTTPServer``; the caller runs ``serve_forever``). The
    port's copy of the JAX package's ``fleet/router.py``: the same
    routing, the same wire, so either router fronts either package's
    replicas.

    The per-replica clock-offset table is written by concurrent scrape
    probe threads and read by /trace/<id> merges, only under
    ``_clock_lock``."""

    def __init__(self, replicas, balancer: FleetBalancer | None = None,
                 affinity_block_chars: int = DEFAULT_BLOCK_CHARS,
                 affinity_blocks: int = DEFAULT_AFFINITY_BLOCKS,
                 scrape_interval_s: float = DEFAULT_SCRAPE_INTERVAL_S,
                 migration: bool = True,
                 connect_timeout_s: float = DEFAULT_CONNECT_TIMEOUT_S,
                 read_timeout_s: float = DEFAULT_READ_TIMEOUT_S,
                 disagg: bool = True,
                 long_prompt_chars: int = DEFAULT_LONG_PROMPT_CHARS):
        self.balancer = balancer or FleetBalancer(replicas)
        self.affinity_block_chars = int(affinity_block_chars)
        self.affinity_blocks = int(affinity_blocks)
        self.scrape_interval_s = float(scrape_interval_s)
        self.migration = bool(migration)
        self.connect_timeout_s = float(connect_timeout_s)
        self.read_timeout_s = float(read_timeout_s)
        # disaggregated prefill: classify by prompt length and steer
        # long prompts to prefill-role replicas; <=0 threshold (or
        # disagg=False) turns the whole policy off — everything
        # classifies "short" and no hand-offs are armed
        self.disagg = bool(disagg)
        self.long_prompt_chars = int(long_prompt_chars)
        # plain counters for /stats (single GIL-atomic int bumps, the
        # scheduler-counter pattern); the registry carries the same
        # signals as native Prometheus series for /metrics
        self.routed_total = 0
        self.shed_retries = 0
        self.giveups = 0
        self.migrations_ok = 0
        self.migrations_failed = 0
        self.redispatches = 0
        self.disagg_handoffs_ok = 0
        self.disagg_fallbacks = 0
        self.disagg_pages_moved = 0  # pages adopted by decode replicas
        self.disagg_pages_fresh = 0  # ...whose payload actually shipped
        self.registry = MetricsRegistry()
        self._m_routed = self.registry.counter(
            "dllama_router_requests_total",
            "requests routed, by replica and placement mode",
        )
        self._m_sheds = self.registry.counter(
            "dllama_router_replica_sheds_total",
            "typed replica sheds observed (reason label)",
        )
        self._m_retries = self.registry.counter(
            "dllama_router_shed_retries_total",
            "requests retried on another replica after a shed",
        )
        self._m_giveups = self.registry.counter(
            "dllama_router_giveups_total",
            "requests failed because every replica shed or was down",
        )
        self._m_migrations = self.registry.counter(
            "dllama_router_migrations_total",
            "live stream migrations, by outcome",
        )
        self._m_migration_s = self.registry.histogram(
            "dllama_router_migration_seconds",
            "stream break detected -> first resumed byte forwarded",
            buckets=MIGRATION_BUCKETS_S,
        )
        self._m_disagg = self.registry.counter(
            "dllama_router_disagg_handoffs_total",
            "prefill->decode hand-offs, by outcome "
            "(fallbacks carry the typed abort reason)",
        )
        self._m_disagg_pages = self.registry.counter(
            "dllama_router_disagg_pages_total",
            "KV pages adopted across replicas, by kind (fresh/reused)",
        )
        self._m_handoff_s = self.registry.histogram(
            "dllama_router_disagg_handoff_seconds",
            "first prefill delta -> decode stream reattached",
            buckets=MIGRATION_BUCKETS_S,
        )
        # fleet tracing: the router's own span ring (route/queue-wait
        # slices, migration gaps, hand-off windows — the rows the merged
        # /trace/<id> timeline leads with), the per-request phase
        # aggregation fed from replica-reported `phases` records, and
        # the per-replica clock-offset table the merge aligns with
        self.tracer = SpanTracer()
        self.phase_acc = PhaseAccumulator()
        self._m_phase_s = self.registry.labelled_histogram(
            "dllama_request_phase_seconds",
            "per-request phase attribution (seconds; phase label is the "
            "phases-record key, ms fields observed /1000) aggregated "
            "router-side from replica-reported phase records",
        )
        self._clock_lock = make_lock("FleetRouter._clock_lock")
        # rid -> (offset_us, uncertainty_us): what to ADD to that
        # replica's /trace timestamps to land them on the router's
        # timebase, and the RTT/2 error bound of the estimate
        self._clock_offsets: dict[str, tuple[float, float]] = {}
        self._stop_evt = threading.Event()
        self._scrape_thread: threading.Thread | None = None
        self._httpd: ThreadingHTTPServer | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FleetRouter":
        """Start the /load scrape loop (idempotent)."""
        if self._scrape_thread is None or not self._scrape_thread.is_alive():
            self._stop_evt.clear()
            self._scrape_thread = threading.Thread(
                target=self._scrape_loop, name="fleet-scrape", daemon=True
            )
            self._scrape_thread.start()
        return self

    def close(self, timeout: float | None = 5.0) -> None:
        self._stop_evt.set()
        if self._scrape_thread is not None and self._scrape_thread.is_alive():
            self._scrape_thread.join(timeout)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None

    def scrape_once(self) -> None:
        """One scrape pass over every replica (the loop's body; also the
        tests' lever for deterministic state). Replicas are scraped
        CONCURRENTLY: a blackholed host (no RST — each attempt eats the
        full 2s timeout) must not stall the healthy replicas' load and
        draining freshness behind it, so a pass costs max(one probe),
        never sum."""
        threads = [
            threading.Thread(
                target=self._probe_load, args=(s,), daemon=True
            )
            for s in self.balancer.replicas()
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(3.0)  # bounded by the probe's own 2s timeout

    def _probe_load(self, state: ReplicaState) -> None:
        """One /load probe: balancer freshness plus the clock-offset
        estimate the fleet trace merge needs. The probe is bracketed
        with local ``perf_counter`` stamps; the replica's ``/load``
        carries ``trace_clock_us`` (its CURRENT position on its /trace
        timebase), so offset = local scrape midpoint (on the router's
        trace timebase) − that stamp, with RTT/2 as the error bound —
        perf_counter origins are per-process, there is no shared clock
        to read."""
        host, port = state.host_port()
        t0 = time.perf_counter()
        try:
            status, body, _ = _request_json(
                host, port, "GET", "/load", timeout=2.0
            )
        except _TRANSPORT_ERRORS:
            self.balancer.note_scrape_failed(state.rid)
            return
        t1 = time.perf_counter()
        if status == 200 and "queue_depth" in body:
            self.balancer.update_load(state.rid, body)
            clock = body.get("trace_clock_us")
            if isinstance(clock, (int, float)):
                mid_us = ((t0 + t1) / 2 - self.tracer.origin) * 1e6
                with self._clock_lock:
                    self._clock_offsets[state.rid] = (
                        mid_us - float(clock), (t1 - t0) / 2 * 1e6,
                    )
        else:
            self.balancer.note_scrape_failed(state.rid)

    def clock_offset(self, rid: str) -> tuple[float, float] | None:
        """The latest (offset_us, uncertainty_us) estimate for ``rid``,
        or None before its first successful scrape."""
        with self._clock_lock:
            return self._clock_offsets.get(rid)

    def merged_trace(self, trace_id: str) -> dict:
        """``GET /trace/<trace_id>``: ONE Perfetto timeline for a fleet
        trace. Fans ``/trace?trace_id=`` out to every replica, aligns
        each ring onto the router's timebase with the scraped clock
        offsets (replicas with no estimate yet get one probed inline —
        this is a debug surface, an extra RTT is fine), and merges with
        the router's own spans at offset 0. A dead replica contributes
        nothing — its ring died with it; the merge is every ring still
        reachable, honestly labelled via per-event ``span_source``."""
        parts = [(
            "router",
            tracer_chrome_trace(self.tracer, trace_id=trace_id),
            0.0, 0.0,
        )]
        for state in self.balancer.replicas():
            if self.clock_offset(state.rid) is None:
                self._probe_load(state)
            host, port = state.host_port()
            try:
                status, doc, _ = _request_json(
                    host, port, "GET", f"/trace?trace_id={trace_id}",
                    timeout=self.connect_timeout_s,
                )
            except _TRANSPORT_ERRORS:
                continue
            if status != 200 or not isinstance(doc, dict):
                continue
            off = self.clock_offset(state.rid) or (0.0, 0.0)
            parts.append((state.rid, doc, off[0], off[1]))
        return merge_chrome_traces(parts)

    def observe_phases(self, phases) -> None:
        """Fold one replica-reported ``phases`` record into the fleet
        aggregation: the /stats counts/sums (PhaseAccumulator validates
        and filters) and the ``dllama_request_phase_seconds{phase=...}``
        histogram (ms fields observed as seconds)."""
        rec = self.phase_acc.observe(phases)
        if not rec:
            return
        for k, v in rec.items():
            self._m_phase_s.observe(v / 1e3, phase=k)

    def _harvest_phases(self, data: bytes) -> None:
        """Pull the ``summary.phases`` record off a buffered completion
        body the router just proxied. Best-effort by design — tracing
        and attribution never fail a response."""
        try:
            body = json.loads(data)
            phases = body["summary"]["phases"]
        except (ValueError, TypeError, KeyError):
            return
        if isinstance(phases, dict):
            self.observe_phases(phases)

    def _scrape_loop(self) -> None:
        while not self._stop_evt.wait(self.scrape_interval_s):
            self.scrape_once()

    # -- placement -----------------------------------------------------------

    def affinity_key(self, body: dict) -> int | None:
        """The request's affinity key: the content-hash chain over the
        prompt text's leading blocks. Chat requests key on the
        concatenated message contents (the leading system prompt
        dominates, which is exactly the sharable part)."""
        if "prompt" in body:
            prompt = body.get("prompt")
            if isinstance(prompt, list):
                prompt = prompt[0] if prompt else ""
            text = prompt if isinstance(prompt, str) else ""
        else:
            parts = []
            for m in body.get("messages") or []:
                if isinstance(m, dict):
                    c = m.get("content")
                    if isinstance(c, str):
                        parts.append(c)
            text = "\n".join(parts)
        return prefix_key(
            text, self.affinity_block_chars, self.affinity_blocks
        )

    # -- surfaces ------------------------------------------------------------

    def handle_stats(self) -> dict:
        out = {
            "router_routed_total": self.routed_total,
            "router_shed_retries": self.shed_retries,
            "router_giveups": self.giveups,
            "router_migrations_ok": self.migrations_ok,
            "router_migrations_failed": self.migrations_failed,
            "router_redispatches": self.redispatches,
            "router_disagg_handoffs_ok": self.disagg_handoffs_ok,
            "router_disagg_fallbacks": self.disagg_fallbacks,
            "router_disagg_pages_moved": self.disagg_pages_moved,
            "router_disagg_pages_fresh": self.disagg_pages_fresh,
            "router_long_prompt_chars": (
                self.long_prompt_chars if self.disagg else 0
            ),
        }
        out.update(self.balancer.stats())
        # fleet tracing surfaces: the router's own ring occupancy (an
        # evicting ring is visible, not silent), the per-replica clock
        # offsets behind /trace/<id>'s alignment, and the aggregated
        # phase-attribution counts/sums
        out.update(self.tracer.counts())
        with self._clock_lock:
            out["clock_offset_us"] = {
                rid: round(v[0], 1) for rid, v in self._clock_offsets.items()
            }
            out["clock_uncertainty_us"] = {
                rid: round(v[1], 1) for rid, v in self._clock_offsets.items()
            }
        out.update(self.phase_acc.snapshot())
        return out

    def handle_metrics(self) -> str:
        return self.registry.render()

    def any_eligible(self) -> bool:
        return self.balancer.any_eligible()

    # -- proxying ------------------------------------------------------------

    def _shed_info(self, body: dict, headers: dict) -> tuple[str, float]:
        reason = str(body.get("reason", "shed"))
        try:
            retry = float(headers.get("Retry-After", 1.0))
        except (TypeError, ValueError):
            retry = 1.0
        return reason, retry

    def _forward_once(self, state: ReplicaState, path: str,
                      body_bytes: bytes, streaming: bool,
                      trace: str | None = None):
        """POST to one replica. Returns ``("ok", conn, resp)`` for a
        streaming 200 (caller owns the connection), ``("done", status,
        data, content_type)`` for a buffered answer, or ``("shed",
        reason, retry_s)`` / ``("dead", None, None)``. ``trace`` (wire
        form) rides as ``X-DLlama-Trace`` — the replica stamps it onto
        the request's spans and journal admit record."""
        host, port = state.host_port()
        # two-phase timeout: a SHORT connect bound (a dead replica whose
        # listener socket lingers — SIGKILL mid-accept-backlog — must
        # fail the route in seconds, not hold the client for the whole
        # generation window), then the generation-length read bound once
        # the connection is up
        conn = http.client.HTTPConnection(
            host, port, timeout=self.connect_timeout_s
        )
        headers = {"Content-Type": "application/json"}
        if trace:
            headers[TRACE_HEADER] = trace
        try:
            conn.connect()
            conn.sock.settimeout(self.read_timeout_s)
            conn.request("POST", path, body=body_bytes, headers=headers)
            resp = conn.getresponse()
        except _TRANSPORT_ERRORS:
            conn.close()
            return ("dead", None, None, None)
        if resp.status in (429, 503):
            try:
                raw = resp.read()
                parsed = json.loads(raw) if raw else {}
            except (ValueError, *_TRANSPORT_ERRORS):
                parsed = {}
            headers = dict(resp.getheaders())
            conn.close()
            reason, retry = self._shed_info(parsed, headers)
            return ("shed", reason, retry, None)
        if streaming and resp.status == 200:
            return ("ok", conn, resp, None)
        try:
            data = resp.read()
        except _TRANSPORT_ERRORS:
            conn.close()
            return ("dead", None, None, None)
        ctype = resp.getheader("Content-Type", "application/json")
        served_by = resp.getheader("X-DLlama-Replica")
        conn.close()
        return ("done", resp.status, data, (ctype, served_by))

    def route(self, path: str, body: dict, sse,
              trace_header: str | None = None):
        """Route one POST. ``sse`` is the client-side SSE surface (a
        ``_SseClient``) for streaming requests, ``None`` otherwise.
        Returns ``(status, data, content_type)`` for buffered answers,
        or ``None`` when the stream was fully handled (headers/chunks
        already written).

        ``trace_header`` is the client's raw ``X-DLlama-Trace`` (or
        None): a valid value is adopted, anything else is replaced by a
        freshly MINTED context — every routed request has a fleet trace
        id from here on, and every hop below carries it."""
        streaming = sse is not None
        ctx = TraceContext.accept(trace_header)
        t_recv = time.perf_counter()
        key = self.affinity_key(body)
        # prompt-length class: "long" routes to a prefill-role replica
        # (disagg); short traffic keeps today's affinity/least-loaded
        len_class = (
            classify_prompt(body, self.long_prompt_chars)
            if self.disagg else "short"
        )
        body_bytes = json.dumps(body).encode()
        tried: set[str] = set()
        sheds: dict[str, dict] = {}
        attempts = 0
        while True:
            state = None
            if len_class == "long":
                # least-loaded among prefill-role replicas (keyless on
                # purpose: a long prompt's pages will MOVE, so pinning
                # it to the affinity ring owner buys nothing); when no
                # prefill replica is eligible the normal pick below is
                # the monolithic fallback
                state = self.balancer.pick(exclude=tried, role="prefill")
            if state is None:
                state = self.balancer.pick(key, exclude=tried)
            if state is None:
                break
            tried.add(state.rid)
            attempts += 1
            # fresh child span id per hop, SAME trace id: each forward
            # is its own hop in the trace, all correlated by trace_id
            verdict, a, b, c = self._forward_once(
                state, path, body_bytes, streaming,
                trace=ctx.child().to_header(),
            )
            if verdict == "dead":
                self.balancer.note_dead(state.rid)
                sheds[state.rid] = {"reason": "unreachable"}
                continue
            if verdict == "shed":
                reason, retry = a, b
                self.balancer.note_shed(
                    state.rid, retry, draining=(reason == "draining")
                )
                self._m_sheds.inc(reason=reason)
                self.shed_retries += 1
                self._m_retries.inc()
                sheds[state.rid] = {
                    "reason": reason, "retry_after_s": retry,
                }
                continue
            # routed (served or a non-shed error the client should see)
            self.routed_total += 1
            # the per-request routing decision, attributable in one
            # scrape: which replica, which placement mode, the prompt's
            # length class and the serving replica's advertised role
            self._m_routed.inc(
                replica=state.rid,
                mode="affinity" if key is not None else "load",
                len_class=len_class,
                role=state.role,
            )
            # the router's own span: client request received -> a
            # replica accepted it (the fleet timeline's queue-wait row;
            # shed/dead retries are inside this window by construction)
            self.tracer.slice(
                "route", "router", t_recv, args={
                    "trace_id": ctx.trace_id, "replica": state.rid,
                    "attempts": attempts, "len_class": len_class,
                },
            )
            if verdict == "ok":
                self._pump_stream(
                    sse, a, b, state, key, path, body_bytes,
                    handoff=(
                        self.disagg and self.migration
                        and len_class == "long"
                        and state.role == "prefill"
                    ),
                    ctx=ctx,
                )
                return None
            status, data, (ctype, served_by) = a, b, c
            if status == 200:
                # per-request phase attribution: buffered completion
                # bodies carry summary.phases — fold it into the fleet
                # histogram the same way streamed terminals are
                self._harvest_phases(data)
            # the replica's attribution header passes through, so fleet
            # clients see WHO served them even behind the router; the
            # trace context goes back too — the client's key into
            # GET /trace/<trace_id>
            extra = {TRACE_HEADER: ctx.to_header()}
            if served_by:
                extra["X-DLlama-Replica"] = served_by
            return (status, data, ctype, extra)
        # every replica shed or unreachable: ONE aggregate failure with
        # the smallest outstanding hint — the router's own typed shed
        self.giveups += 1
        self._m_giveups.inc()
        retry = self.balancer.min_retry_after_s()
        # streams included: SSE headers only commit on an upstream 200,
        # so a total give-up still gets a proper 503 status line
        payload = json.dumps({
            "error": "no replica available (all shedding or unreachable)",
            "reason": "fleet_exhausted",
            "replicas_tried": attempts,
            "sheds": sheds,
        }).encode()
        return (503, payload, "application/json",
                {"Retry-After": str(max(1, round(retry)))})

    # -- streaming pump + migration ------------------------------------------

    def _pump_stream(self, sse, conn, resp, state, key, path,
                     body_bytes, handoff: bool = False,
                     ctx: TraceContext | None = None) -> None:
        """Own a streaming request end-to-end: commit the client SSE
        headers, pump the upstream body through, and on a mid-stream
        failure migrate to another replica and keep pumping — same
        client socket, zero lost/duplicated output. With ``handoff``
        (a long prompt landed on a prefill-role replica) the pump
        pauses after the FIRST forwarded delta — the proof that
        prefill committed its pages — and tries the disagg hand-off;
        a failed hand-off simply resumes the same upstream stream (the
        monolithic fallback, the source never stopped decoding)."""
        st = _StreamSession(key)
        st.handoff_due = handoff
        if ctx is not None:
            st.trace = ctx.to_header()
        tried = {state.rid}
        sse.headers(state.rid, trace=st.trace)
        skip_chars = 0
        while True:
            try:
                outcome = self._pump_upstream(
                    sse, st, conn, resp, state, skip_chars
                )
            except _ClientGone:
                # our client left: closing upstream lets the replica's
                # own disconnect semantics (cancel / grace) apply
                conn.close()
                return
            if outcome == "handoff":
                t_gap = time.perf_counter()
                nxt = self._hand_off(st, state)
                if nxt is None:
                    # typed fallback (counted in _hand_off): the source
                    # stream is still live and still ours — keep
                    # pumping it. skip_chars resets: the SAME response
                    # body continues, nothing replays.
                    skip_chars = 0
                    continue
                # the decode replica replays from 0; close the source
                # only now, after the reattach succeeded (closing it
                # earlier would burn the fallback path)
                conn.close()
                from_rid = state.rid
                conn, resp, state = nxt
                tried.add(state.rid)
                skip_chars = st.chars_out  # char-exact dedup floor
                st.pending_error = None
                st.terminal_seen = False
                # the hand-off window is NOT client-visible dead air the
                # way a migration gap is (the source kept streaming until
                # the reattach), but the transfer is a trace row: the
                # fleet timeline shows prefill ending and decode starting
                # across it
                self.tracer.slice(
                    "disagg.handoff", "disagg", t_gap, args={
                        "trace_id": _ctx_trace_id(ctx),
                        "from": from_rid, "to": state.rid,
                        "request_id": st.request_id,
                    },
                )
                continue
            conn.close()
            tried.add(state.rid)
            if outcome == "done":
                sse.done()
                return
            # outcome == "migrate": the source died / shed / cancelled
            t0 = time.perf_counter()
            nxt = self._migrate(st, state)
            migrated = nxt is not None
            if nxt is None and st.chars_out == 0:
                # nothing was delivered yet (the queued-at-kill window:
                # a request the dead replica never admitted exports no
                # ticket) — a fresh re-dispatch elsewhere is lossless
                # by definition. Counted as a redispatch, NOT a
                # migration: no ticket, no deterministic replay, and
                # the migration latency histogram must not absorb it.
                nxt = self._redispatch(path, body_bytes, key, tried,
                                       trace=st.trace)
                if nxt is not None:
                    st.request_id = None
                    st.ticket = None
                    self.redispatches += 1
                    self._m_migrations.inc(outcome="redispatch")
            if nxt is None:
                self.migrations_failed += 1
                self._m_migrations.inc(outcome="failed")
                try:
                    err = st.pending_error or {
                        "error": "replica lost mid-stream and no "
                                 "migration target accepted the session",
                        "reason": "migration_failed",
                    }
                    err.setdefault("request_id", st.request_id)
                    sse.chunk(err)
                    sse.done()
                except _ClientGone:
                    pass
                return
            from_rid = state.rid
            conn, resp, state = nxt
            tried.add(state.rid)
            skip_chars = st.chars_out  # char-exact dedup floor
            st.pending_error = None
            st.terminal_seen = False
            gap_s = time.perf_counter() - t0
            # the migration gap: break detected -> resumed stream in
            # hand. Client-visible dead air only the ROUTER saw whole —
            # a span on the fleet timeline AND an accumulated phases
            # field stamped into the terminal record (redispatches
            # count too: the client's stall is the same either way)
            st.gap_ms += gap_s * 1e3
            self.tracer.slice(
                "migration.gap", "migrate", t0, args={
                    "trace_id": _ctx_trace_id(ctx),
                    "from": from_rid, "to": state.rid,
                    "request_id": st.request_id,
                    "kind": "migration" if migrated else "redispatch",
                },
            )
            if migrated:
                st.migrations += 1
                self.migrations_ok += 1
                self._m_migrations.inc(outcome="ok")
                self._m_migration_s.observe(gap_s)

    def _redispatch(self, path, body_bytes, key, tried,
                    trace: str | None = None):
        """Re-send the ORIGINAL request to a replica not yet tried (only
        ever called with zero delivered output — a fresh request id and
        a fresh seed are invisible to the client). Returns ``(conn,
        resp, state)`` or ``None``. The original trace context rides
        along: the re-dispatched request is the SAME client request,
        so it keeps the same trace id."""
        while True:
            state = self.balancer.pick(key, exclude=tried)
            if state is None:
                return None
            tried.add(state.rid)
            verdict, a, b, _c = self._forward_once(
                state, path, body_bytes, True, trace=trace
            )
            if verdict == "ok":
                return a, b, state
            if verdict == "shed":
                self.balancer.note_shed(
                    state.rid, b, draining=(a == "draining")
                )
                self._m_sheds.inc(reason=a)
            elif verdict == "dead":
                self.balancer.note_dead(state.rid)
            else:
                # a buffered non-200: the SSE headers are already out,
                # so it cannot be relayed as a status line — give up
                return None

    def _pump_upstream(self, sse, st, conn, resp, state,
                       skip_chars: int) -> str:
        """Forward one upstream SSE body. Returns ``"done"`` (terminal +
        [DONE] forwarded) or ``"migrate"`` (source broke / shed / was
        force-cancelled mid-flight). Raises :class:`_ClientGone` when
        the router's own client disappears."""
        if st.request_id is None:
            rid_hdr = resp.getheader("X-DLlama-Request")
            if rid_hdr is not None:
                try:
                    st.request_id = int(rid_hdr)
                except ValueError:
                    pass
        self._ensure_ticket(st, state)
        skip = skip_chars
        try:
            for raw in resp:
                line = raw.decode("utf-8", "replace").rstrip("\r\n")
                if not line.startswith("data: "):
                    continue  # upstream ids are re-stamped by the router
                data = line[len("data: "):]
                if data == "[DONE]":
                    # a clean upstream end without a terminal chunk is a
                    # break (e.g. the handler died): migrate
                    return "done" if st.terminal_seen else "migrate"
                try:
                    payload = json.loads(data)
                except ValueError:
                    continue
                if st.request_id is None:
                    st.request_id = _rid_from_payload(payload)
                    self._ensure_ticket(st, state)
                if "error" in payload:
                    # typed mid-stream failure (drain flush, pool shed,
                    # engine error): try to move the session instead of
                    # passing the failure through
                    st.pending_error = payload
                    return "migrate"
                choices = payload.get("choices") or [{}]
                choice = choices[0] if isinstance(choices[0], dict) else {}
                fin = choice.get("finish_reason")
                if fin is None:
                    text = _delta_text(choice)
                    if skip:
                        if len(text) <= skip:
                            skip -= len(text)
                            continue
                        text = text[skip:]
                        skip = 0
                        _set_delta_text(choice, text)
                    if not text:
                        continue
                    if st.ticket is None and st.deltas_out == 0:
                        # the stream-start fetch can race admission (a
                        # queued request exports nothing); the first
                        # delta PROVES admission, so one retry here
                        # makes the ticket reliable before any output
                        # is at stake
                        self._ensure_ticket(st, state)
                    st.deltas_out += 1
                    st.chars_out += len(text)
                    sse.chunk(payload, event_id=st.deltas_out)
                    if st.handoff_due:
                        # disagg: the first delta PROVES the prompt's
                        # blocks are committed to the prefill replica's
                        # pool — pause here and try the hand-off (the
                        # caller resumes this same stream on fallback)
                        return "handoff"
                    continue
                if fin in ("cancelled", "error"):
                    # the source gave the request up mid-flight (drain
                    # force-cancel, contained failure): migratable
                    st.pending_error = payload
                    return "migrate"
                # natural ending (stop/length/timeout): pass through —
                # after stamping the router-owned attribution into the
                # phases record and folding it into the fleet histogram
                self._finish_phases(st, payload)
                st.terminal_seen = True
                sse.chunk(payload, event_id=st.deltas_out)
        except _TRANSPORT_ERRORS:
            return "migrate"  # the source replica died mid-stream
        return "done" if st.terminal_seen else "migrate"

    def _finish_phases(self, st: _StreamSession, payload: dict) -> None:
        """Stamp router-owned attribution into a terminal chunk's
        ``summary.phases`` record — ``migration_gap_ms`` is dead air
        only the ROUTER saw whole (the replica that finished the stream
        never knew the break happened) — then fold the record into the
        fleet aggregation. Best-effort: attribution never breaks a
        stream."""
        summ = payload.get("summary")
        if not isinstance(summ, dict):
            return
        phases = summ.get("phases")
        if not isinstance(phases, dict):
            return
        if st.gap_ms:
            phases["migration_gap_ms"] = round(st.gap_ms, 3)
        self.observe_phases(phases)

    def _ensure_ticket(self, st: _StreamSession, state: ReplicaState) -> None:
        """Cache the session's migration ticket (fleet/migrate.py) the
        moment the request id is known — while the SOURCE is still
        alive, so its later death is still migratable. A miss (not yet
        admitted, export raced the finish) retries on the next call."""
        if not self.migration or st.ticket is not None or st.request_id is None:
            return
        host, port = state.host_port()
        try:
            st.ticket = fetch_ticket(
                host, port, st.request_id, timeout=self.connect_timeout_s,
                trace=st.trace,
            )
        except _TRANSPORT_ERRORS:
            st.ticket = None

    def _hand_off(self, st: _StreamSession, src: ReplicaState):
        """Disagg prefill→decode hand-off (disagg/prefill.py): page
        bundle, then ticket, then reattach. Returns ``(conn, resp,
        state)`` on the decode replica or ``None`` — and ``None`` is
        ALWAYS safe: the session is still streaming on ``src``, the
        caller just keeps pumping it (typed fallback, never a hung
        stream). One attempt per stream: ``handoff_due`` clears here."""
        st.handoff_due = False

        def fallback(reason: str):
            self.disagg_fallbacks += 1
            self._m_disagg.inc(outcome="fallback", reason=reason)
            return None

        if st.request_id is None:
            return fallback("no_request_id")
        tried = {src.rid}
        # decode-role replicas first; a mixed fleet (no explicit decode
        # role) falls back to any eligible non-source replica
        state = self.balancer.pick(exclude=tried, role="decode")
        if state is None:
            state = self.balancer.pick(st.key, exclude=tried)
        if state is None:
            return fallback("no_decode_replica")
        src_host, src_port = src.host_port()
        dst_host, dst_port = state.host_port()
        t0 = time.perf_counter()
        try:
            conn, resp, new_rid, receipt = hand_off(
                src_host, src_port, st.request_id, dst_host, dst_port,
                timeout=self.connect_timeout_s,
                read_timeout=self.read_timeout_s,
                trace=st.trace,
            )
        except HandoffAborted as e:
            # covers the prefill replica dying mid-transfer (ticket or
            # page fetch fails → no_ticket / transport reasons): the
            # caller's next pump pass hits the broken source and takes
            # the NORMAL migration path off the cached ticket
            return fallback(e.reason)
        st.request_id = new_rid
        self.disagg_handoffs_ok += 1
        self.disagg_pages_moved += int(receipt.get("pages", 0) or 0)
        self.disagg_pages_fresh += int(receipt.get("fresh", 0) or 0)
        self._m_disagg.inc(outcome="ok")
        self._m_disagg_pages.inc(
            float(receipt.get("fresh", 0) or 0), kind="fresh")
        self._m_disagg_pages.inc(
            float(receipt.get("reused", 0) or 0), kind="reused")
        self._m_handoff_s.observe(time.perf_counter() - t0)
        return conn, resp, state

    def _migrate(self, st: _StreamSession, failed: ReplicaState):
        """Move a broken stream: inject the cached ticket into the next
        eligible replica and reattach from 0 (the caller's char-skip
        dedups the replay). Returns ``(conn, resp, state)`` or ``None``
        when no target accepted."""
        if not self.migration:
            return None
        if st.ticket is None and st.request_id is not None:
            # last chance: the source may still be alive (drain window)
            self._ensure_ticket(st, failed)
        if st.ticket is None or st.request_id is None:
            return None
        tried = {failed.rid}
        while True:
            state = self.balancer.pick(st.key, exclude=tried)
            if state is None:
                return None
            tried.add(state.rid)
            host, port = state.host_port()
            try:
                injected = inject_session(
                    host, port, st.ticket, timeout=self.connect_timeout_s,
                    trace=st.trace,
                )
            except MigrationShed as e:
                self.balancer.note_shed(state.rid, e.retry_after_s)
                self._m_sheds.inc(reason=e.reason)
                continue
            except ValueError:
                continue  # refused (config): try the next replica
            except _TRANSPORT_ERRORS:
                self.balancer.note_dead(state.rid)
                continue
            # the response's request_id is authoritative: the target
            # REMAPS an id that collides with one of its own live
            # requests (replicas all number from 1), and the reattach —
            # plus any later re-export for a second migration — must
            # use the id the session actually lives under there
            try:
                new_rid = int(injected.get("request_id", st.request_id))
            except (TypeError, ValueError):
                new_rid = st.request_id
            try:
                conn, resp = open_stream(
                    host, port, new_rid, last_event_id=0,
                    timeout=self.read_timeout_s,
                    connect_timeout=self.connect_timeout_s,
                )
            except (ValueError, *_TRANSPORT_ERRORS):
                self.balancer.note_dead(state.rid)
                continue
            st.request_id = new_rid
            return conn, resp, state

    # -- HTTP front-end ------------------------------------------------------

    def serve(self, host: str = "0.0.0.0", port: int = 9980) -> ThreadingHTTPServer:
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _json_raw(self, code: int, data: bytes,
                          content_type: str = "application/json",
                          headers: dict | None = None):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def _json(self, code: int, payload: dict,
                      headers: dict | None = None):
                self._json_raw(code, json.dumps(payload).encode(),
                               headers=headers)

            def do_GET(self):
                if self.path in ("/", "/health"):
                    if router.any_eligible():
                        self._json(200, {
                            "status": "ok",
                            **router.balancer.stats(),
                        })
                    else:
                        self._json(503, {
                            "status": "unhealthy",
                            "error": "no eligible replica",
                        }, headers={"Retry-After": str(max(
                            1, round(router.balancer.min_retry_after_s())
                        ))})
                elif self.path == "/stats":
                    self._json(200, router.handle_stats())
                elif self.path == "/metrics":
                    self._json_raw(
                        200, router.handle_metrics().encode(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                elif self.path == "/trace":
                    # the router's OWN span ring (route slices,
                    # migration gaps, hand-off windows)
                    self._json(200, tracer_chrome_trace(router.tracer))
                elif self.path.startswith("/trace/"):
                    # cross-replica merge: ONE Perfetto timeline for a
                    # fleet trace id — router rows at offset 0, every
                    # reachable replica's matching events aligned by the
                    # scraped clock-offset estimates (stamped per event)
                    tid = self.path.rsplit("/", 1)[1].lower()
                    if len(tid) != 32 or any(
                        c not in "0123456789abcdef" for c in tid
                    ):
                        self._json(400, {
                            "error": "bad trace id (want 32 lowercase "
                                     "hex chars)",
                        })
                        return
                    self._json(200, router.merged_trace(tid))
                elif self.path == "/v1/models":
                    self._proxy_get("/v1/models")
                else:
                    self._json(404, {"error": "not found"})

            def _proxy_get(self, path):
                state = router.balancer.pick()
                if state is None:
                    self._json(503, {"error": "no eligible replica"})
                    return
                host_, port_ = state.host_port()
                try:
                    status, body, _ = _request_json(
                        host_, port_, "GET", path,
                        timeout=router.connect_timeout_s,
                    )
                except _TRANSPORT_ERRORS:
                    router.balancer.note_dead(state.rid)
                    self._json(502, {"error": "replica unreachable"})
                    return
                self._json(status, body)

            def do_POST(self):
                if self.path not in ("/v1/chat/completions",
                                     "/v1/completions"):
                    self._json(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": f"bad request: {e}"})
                    return
                sse = _SseClient(self) if body.get("stream") else None
                try:
                    out = router.route(
                        self.path, body, sse,
                        trace_header=self.headers.get(TRACE_HEADER),
                    )
                except _ClientGone:
                    return
                if out is None:
                    return  # stream fully handled
                status, data, ctype, *extra = out
                self._json_raw(status, data, ctype,
                               headers=extra[0] if extra else None)

        httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd = httpd
        return httpd


class _SseClient:
    """The router's client-facing SSE surface: headers, chunks with the
    router's own ``id:`` stamps, the terminal [DONE]. Client-socket
    failures become :class:`_ClientGone` so the pump can distinguish
    them from upstream (replica-side) breaks."""

    def __init__(self, handler):
        self._h = handler

    def headers(self, replica_id: str | None = None,
                trace: str | None = None) -> None:
        try:
            h = self._h
            h.send_response(200)
            h.send_header("Content-Type", "text/event-stream")
            h.send_header("Cache-Control", "no-cache")
            h.send_header("Connection", "close")
            if replica_id:
                # first-serving replica: attribution for fleet traces
                # (migrations are counted on the router's own /metrics)
                h.send_header("X-DLlama-Replica", replica_id)
            if trace:
                # the stream's fleet trace context (minted if the client
                # sent none): the key into GET /trace/<trace_id>
                h.send_header(TRACE_HEADER, trace)
            h.end_headers()
        except (BrokenPipeError, ConnectionError, OSError) as e:
            raise _ClientGone from e

    def chunk(self, payload: dict, event_id=None) -> None:
        try:
            buf = b""
            if event_id is not None:
                buf += f"id: {event_id}\n".encode()
            buf += b"data: " + json.dumps(payload).encode() + b"\n\n"
            self._h.wfile.write(buf)
            self._h.wfile.flush()
        except (BrokenPipeError, ConnectionError, OSError) as e:
            raise _ClientGone from e

    def done(self) -> None:
        try:
            self._h.wfile.write(b"data: [DONE]\n\n")
            self._h.wfile.flush()
        except (BrokenPipeError, ConnectionError, OSError) as e:
            raise _ClientGone from e


def _ctx_trace_id(ctx: TraceContext | None) -> str | None:
    """The span-args trace id off an optional context (spans whose
    request had no context simply omit the arg)."""
    return ctx.trace_id if ctx is not None else None


def _rid_from_payload(payload: dict) -> int | None:
    """The request id from a chunk's ``id`` field (``chatcmpl-<n>`` /
    ``cmpl-<n>`` — api_types.py's shapes)."""
    rid = payload.get("id")
    if isinstance(rid, str) and "-" in rid:
        try:
            return int(rid.rsplit("-", 1)[1])
        except ValueError:
            return None
    if isinstance(payload.get("request_id"), int):
        return payload["request_id"]
    return None


def _delta_text(choice: dict) -> str:
    """Delta text from either chunk shape: chat (``delta.content``) or
    completion (``text``)."""
    if "delta" in choice:
        d = choice.get("delta")
        return d.get("content", "") if isinstance(d, dict) else ""
    return choice.get("text", "") or ""


def _set_delta_text(choice: dict, text: str) -> None:
    if "delta" in choice and isinstance(choice.get("delta"), dict):
        choice["delta"]["content"] = text
    else:
        choice["text"] = text
