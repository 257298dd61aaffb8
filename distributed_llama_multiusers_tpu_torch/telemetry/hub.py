"""Telemetry hub: the one object the scheduler and the server share.

Bundles the span tracer (spans.py), the metrics registry (metrics.py)
with the standard serving instruments pre-registered, and the JSON
logger (logs.py), and exposes the lifecycle hooks the scheduler calls:

    submit -> on_submit          (queued instant, RequestTrace attached)
    admit  -> on_admit           (queued slice, queue-wait histogram)
    chunk  -> on_prefill_chunk   (lane slice, step-duration histogram)
    token  -> on_token           (TTFT on first, inter-token gaps after)
    step   -> on_step / on_pipelined_step  (pipeline-track slices)
    end    -> on_finish / on_unadmitted / on_error  (summary, counters,
              one JSON log line, finish instant)

Design constraint, inherited from the async pipeline: NO hook runs
inside the pipelined dispatch half. Dispatch→consume step slices are
recorded by ``on_pipelined_step`` from the scheduler's consume half, one
step behind, where the host is already blocking on the lagged readback;
the dispatch half never calls in here, and no hook reads a tensor.

Exposition: ``render_prometheus(bridge=stats_dict)`` re-publishes the
``/stats`` payload as ``dllama_stats_*`` gauges next to the native
histograms/counters, sampled from the SAME snapshot the JSON endpoint
serves — so ``/metrics`` and ``/stats`` reconcile by construction.

The port's copy of the JAX package's hub. Where the port measures
something else than the JAX package under a metric's name, the help text
says so: ``dllama_jit_compiles_total`` counts CUDA-graph captures after
warmup (``runtime/graphs.py``), ``dllama_sync_bytes_total`` the bytes the
ring hop kernel moved (``ops/ring_collective.py``).
"""

from __future__ import annotations

import time

from .logs import JsonLogger, default_logger
from .metrics import LATENCY_BUCKETS_S, MetricsRegistry
from .spans import RequestTrace, SpanTracer
from .trace import dump_chrome_trace, tracer_chrome_trace
from .tracectx import trace_id_of

STATS_PREFIX = "dllama_stats_"


class Telemetry:
    def __init__(
        self,
        tracer: SpanTracer | None = None,
        registry: MetricsRegistry | None = None,
        logger: JsonLogger | None = None,
        trace_capacity: int = 16384,
    ):
        self.tracer = tracer or SpanTracer(capacity=trace_capacity)
        self.registry = registry or MetricsRegistry()
        self.logger = logger or default_logger()
        reg = self.registry
        self.ttft = reg.histogram(
            "dllama_ttft_seconds",
            "submit -> first consumed token, per request",
            LATENCY_BUCKETS_S,
        )
        self.tbt = reg.histogram(
            "dllama_time_between_tokens_seconds",
            "gap between consecutive consumed tokens, per lane",
            LATENCY_BUCKETS_S,
        )
        self.queue_wait = reg.histogram(
            "dllama_queue_wait_seconds",
            "submit -> queue pop, per popped request (pops that resolve "
            "cancelled/expired without claiming a lane included)",
            LATENCY_BUCKETS_S,
        )
        self.step_duration = reg.histogram(
            "dllama_step_duration_seconds",
            "one engine dispatch: prefill chunk, decode step (sync/spec/"
            "multi horizon), or pipelined dispatch->lagged-consume span",
            LATENCY_BUCKETS_S,
        )
        self.requests_finished = reg.counter(
            "dllama_requests_finished_total",
            "finished requests by finish_reason (shed = drain-flushed, "
            "error = failed before generating)",
        )
        self.tokens_generated = reg.counter(
            "dllama_tokens_generated_total", "tokens consumed across lanes"
        )
        self.overlap_fraction = reg.gauge(
            "dllama_overlap_fraction",
            "overlap_s / (overlap_s + decode_s): fraction of engine decode "
            "wall-time the async pipeline hid behind device execution",
        )
        # tensor-parallel sync cost next to TTFT/TBT: the bytes the ring
        # hop kernel moved, delta-fed from the /stats ring_hop_bytes field
        self.sync_bytes = reg.counter(
            "dllama_sync_bytes_total",
            "bytes the ring hop kernel moved for tensor-parallel sync and "
            "logits gathers (the /stats ring_hop_bytes field, delta-fed; "
            "0 on one rank)",
        )
        # failure containment (serving/breaker.py, runtime/scheduler.py):
        # the breaker state machine as a gauge and classified failures as
        # a labelled counter — both reconciled with the /stats twins via
        # bridge_stats (the state gauge is set from breaker_state_code,
        # the counter delta-fed from the engine_failures dict, so counter
        # semantics survive window resets like dllama_sync_bytes_total)
        self.breaker_state = reg.gauge(
            "dllama_breaker_state",
            "serving circuit breaker: 0 closed, 1 half-open, 2 open "
            "(anything > 0 means /health is reporting unhealthy)",
        )
        self.engine_failures = reg.counter(
            "dllama_engine_failures_total",
            "classified serving failures by failure_class label: engine "
            "(dispatch/consume/transfer raise, contained), request "
            "(per-request input error), watchdog (stalled step)",
        )
        # zero-flush serving: speculation acceptance as a native counter
        # next to the dllama_stats_spec_* gauges the bridge republishes —
        # delta-fed from the /stats spec_emitted field (same recipe as
        # dllama_sync_bytes_total) so counter semantics survive
        # engine.stats.reset() windows
        self.spec_accepted = reg.counter(
            "dllama_spec_accepted_total",
            "tokens consumed from speculative verify steps on DRAFTED "
            "lanes (the /stats spec_emitted field, delta-fed)",
        )
        # capture stability: CUDA-graph captures after warmup as the JAX
        # package's post-warmup compile counter, delta-fed from the /stats
        # jit_compiles_after_warmup field; MUST stay flat in steady
        # serving (every decode-family graph is captured at warmup)
        self.jit_compiles = reg.counter(
            "dllama_jit_compiles_total",
            "CUDA-graph captures after warmup (runtime/graphs.py; the /stats "
            "jit_compiles_after_warmup field, delta-fed) — non-zero means a "
            "step captured mid-serving",
        )
        # crash durability (serving/journal.py, serving/recovery.py) and
        # resource lifecycles (analysis/leakcheck.py): native counters
        # beside the dllama_stats_* gauges, delta-fed from /stats
        self.journal_records = reg.counter(
            "dllama_journal_records_total",
            "request-journal records durably written (the /stats "
            "journal_records field, delta-fed)",
        )
        self.recovered_requests = reg.counter(
            "dllama_recovered_requests_total",
            "crashed requests re-admitted by journal replay (the /stats "
            "recovered_requests field, delta-fed)",
        )
        self.resource_leaks = reg.counter(
            "dllama_resource_leaks_total",
            "resources found still held at a drain point: scheduler stop, "
            "stream-registry close (the /stats resource_leaks_total "
            "field, delta-fed); non-zero means a lifecycle leak",
        )
        self._sync_bytes_seen = 0.0
        self._jit_compiles_seen = 0.0
        self._spec_emitted_seen = 0.0
        self._journal_records_seen = 0.0
        self._recovered_seen = 0.0
        self._resource_leaks_seen = 0.0
        self._failures_seen: dict[str, float] = {}

    # -- request lifecycle hooks --------------------------------------------

    @staticmethod
    def trace_of(req) -> RequestTrace:
        tel = getattr(req, "tel", None)
        if tel is None:
            tel = req.tel = RequestTrace(getattr(req, "submitted_at", None))
        return tel

    def span_args(self, req=None, extra: dict | None = None) -> dict | None:
        """The args every span carries: the request's ``trace_id`` (when
        it carried an ``X-DLlama-Trace`` context), what ``/trace?trace_id=``
        filters by."""
        args = dict(extra) if extra else {}
        if req is not None:
            tid = trace_id_of(getattr(req, "trace", None))
            if tid:
                args["trace_id"] = tid
        return args or None

    def on_submit(self, req) -> None:
        tel = self.trace_of(req)
        self.tracer.instant("submitted", "queue", ts=tel.span_t0,
                            req_id=req.id, args=self.span_args(req))

    def on_admit(self, req, lane: int) -> None:
        tel = self.trace_of(req)
        tel.admitted_at = req.admitted_at
        tel.lane = lane
        now_pc = self.tracer.now()
        self.tracer.slice("queued", "queue", tel.span_t0, now_pc,
                          req_id=req.id,
                          args=self.span_args(req, {"lane": lane}))
        tel.span_t0 = now_pc  # the generate slice starts here

    def on_prefix_hit(self, req, tokens_saved: int) -> None:
        self.trace_of(req).prefix_saved = int(tokens_saved)

    def on_fused_admit(self, req) -> None:
        """The request's prompt chunks are riding fused dispatches inside
        the live chain (claimed in-chain, or joined the chain with chunks
        still pending)."""
        self.trace_of(req).fused_admitted = True

    def on_prefill_chunk(self, req, lane: int, t0: float, n_tokens: int,
                         fused: bool = False) -> None:
        now_pc = self.tracer.now()
        self.tracer.slice(
            "prefill.fused" if fused else "prefill.sync", f"lane{lane}",
            t0, now_pc, req_id=req.id,
            args=self.span_args(req, {"tokens": n_tokens}),
        )
        if not fused:
            # fused chunks ride a pipelined dispatch that on_pipelined_step
            # already times; observing both would double-count the span
            self.step_duration.observe(max(0.0, now_pc - t0))

    def on_token(self, req, now: float | None = None) -> None:
        """One consumed token (``now`` = time.monotonic()). First token
        observes TTFT; every later one observes the inter-token gap."""
        tel = self.trace_of(req)
        if now is None:
            now = time.monotonic()
        first = tel.first_token_at is None
        tel.on_token(now)
        self.tokens_generated.inc()
        if first:
            if tel.ttft_s is not None:
                self.ttft.observe(tel.ttft_s)
        else:
            self.tbt.observe(tel.gaps[-1])

    # -- step hooks ----------------------------------------------------------

    def on_step(self, kind: str, t0: float, args: dict | None = None) -> None:
        """One synchronous engine dispatch (kind: sync/spec/multi)."""
        now_pc = self.tracer.now()
        self.tracer.slice(f"step.{kind}", "pipeline", t0, now_pc,
                          args=self.span_args(extra=args))
        self.step_duration.observe(max(0.0, now_pc - t0))

    def on_pipelined_step(self, t_dispatch: float, fused_info=None,
                          kind: str = "pipelined") -> None:
        """One pipelined step, recorded at CONSUME time (one step behind):
        the slice spans dispatch -> lagged readback completion. ``kind``
        distinguishes the in-chain spec verify steps
        (``"spec_pipelined"`` — the zero-flush speculation path) from
        plain pipelined decodes on the trace. For a fused prefill+decode
        step, ``fused_info`` is the scheduler's
        ``(lane_idx, lane, final, n_chunk)`` and the admitting lane also
        gets a ``prefill.fused`` slice on its own track."""
        now_pc = self.tracer.now()
        if fused_info is None:
            self.tracer.slice(f"step.{kind}", "pipeline", t_dispatch,
                              now_pc, args=self.span_args())
        else:
            lane_idx, lane, final, n_chunk = fused_info
            req = lane.request
            req_id = getattr(req, "id", None)
            # a verify step that ALSO carries a chunk keeps its spec
            # identity on the trace — the composition the zero-flush
            # chain exists for must be countable, not folded into plain
            # fused slices
            name = "step.fused" if kind == "pipelined" else "step.spec_fused"
            self.tracer.slice(
                name, "pipeline", t_dispatch, now_pc, req_id=req_id,
                args=self.span_args(req, {"chunk": n_chunk, "final": final}),
            )
            if req is not None:
                self.on_prefill_chunk(req, lane_idx, t_dispatch, n_chunk,
                                      fused=True)
        self.step_duration.observe(max(0.0, now_pc - t_dispatch))

    def on_flush(self, live: int, admitting: int) -> None:
        self.tracer.instant(
            "pipeline.flush", "pipeline",
            args=self.span_args(extra={"live": live, "admitting": admitting}),
        )

    # -- failure containment -------------------------------------------------

    def on_engine_failure(self, error: str, lanes_failed: int,
                          breaker_state: str) -> None:
        """One engine-scoped containment round (runtime/scheduler.py's
        supervised loop): the loop caught an engine raise, failed the
        affected lanes, and kept serving. One trace instant + one
        structured log line — the event operators grep for when error-rate
        alarms fire."""
        self.tracer.instant(
            "engine.failure", "pipeline",
            args=self.span_args(extra={
                "error": error[:200],
                "lanes_failed": lanes_failed,
                "breaker_state": breaker_state,
            }),
        )
        self.logger.emit(
            "engine_failure",
            error=error[:200],
            lanes_failed=lanes_failed,
            breaker_state=breaker_state,
        )

    def on_watchdog_trip(self, waited_s: float, fatal: bool) -> None:
        """The step watchdog (serving/watchdog.py) found a dispatched step
        with no progress past its deadline. The watchdog emits its own
        log line before any fatal exit; this is the scheduler-side trace
        instant tying the trip to the pipeline track."""
        self.tracer.instant(
            "watchdog.trip", "pipeline",
            args=self.span_args(
                extra={"waited_s": round(waited_s, 3), "fatal": fatal}
            ),
        )

    # -- request endings -----------------------------------------------------

    def _summarize(self, req, reason: str | None,
                   error: str | None = None) -> dict:
        tel = self.trace_of(req)
        summary = tel.summary(req, reason)
        if error is not None:
            summary["error"] = error
        req.summary = summary
        self.logger.emit("request", **summary)
        return summary

    def on_finish(self, req, lane: int, reason: str | None) -> None:
        """A request that held a lane ended (stop/length/cancel/timeout)."""
        tel = self.trace_of(req)
        track = f"lane{lane}"
        self.tracer.slice("generate", track, tel.span_t0, req_id=req.id,
                          args=self.span_args(req,
                                              {"finish_reason": reason}))
        self.tracer.instant(f"finish.{reason}", track, req_id=req.id,
                            args=self.span_args(req))
        self.requests_finished.inc(finish_reason=str(reason))
        self._summarize(req, reason)

    def on_unadmitted(self, req, reason: str) -> None:
        """A request resolved without ever claiming a lane (queue timeout,
        cancel while queued, drain shed)."""
        tel = self.trace_of(req)
        self.tracer.slice("queued", "queue", tel.span_t0, req_id=req.id,
                          args=self.span_args(req,
                                              {"finish_reason": reason}))
        self.tracer.instant(f"finish.{reason}", "queue", req_id=req.id,
                            args=self.span_args(req))
        self.requests_finished.inc(finish_reason=reason)
        self._summarize(req, reason)

    def on_error(self, req, lane: int | None, error: str) -> None:
        """A request failed before generating (tokenization/engine error).
        The error string rides the summary BEFORE the log line is emitted,
        so the request's log record carries the reason the 500 names."""
        track = "queue" if lane is None else f"lane{lane}"
        self.tracer.instant("finish.error", track, req_id=req.id,
                            args=self.span_args(req,
                                                {"error": error[:200]}))
        self.requests_finished.inc(finish_reason="error")
        self._summarize(req, "error", error=error[:200])

    # -- startup -------------------------------------------------------------

    def startup_log(self, event: str, **fields) -> None:
        """One structured line deployments verify config from (satellite:
        mesh shape / buckets / pipeline depth / fused on-off in logs)."""
        self.logger.emit(event, **fields)

    # -- exposition ----------------------------------------------------------

    def bridge_stats(self, stats: dict) -> None:
        """Republish a ``/stats`` payload as ``dllama_stats_*`` gauges
        (dict-valued histogram counters become labelled gauges), plus the
        derived overlap-fraction gauge. Values land verbatim, so a scrape
        reconciles with the JSON endpoint field-for-field."""
        reg = self.registry
        for key, value in stats.items():
            if value is None:
                continue
            name = STATS_PREFIX + key
            if isinstance(value, bool):
                reg.gauge(name).set(1.0 if value else 0.0)
            elif isinstance(value, (int, float)):
                reg.gauge(name).set(float(value))
            elif isinstance(value, dict):
                g = reg.gauge(name)
                for k, v in value.items():
                    if isinstance(v, (int, float)):
                        g.set(float(v), key=str(k))
        overlap = float(stats.get("overlap_s") or 0.0)
        decode = float(stats.get("decode_s") or 0.0)
        if overlap + decode > 0:
            self.overlap_fraction.set(overlap / (overlap + decode))
        # the native sync-bytes counter tracks the ring hop's byte count
        # the dllama_stats_ring_hop_bytes gauge republishes, delta-fed so it
        # keeps Prometheus counter semantics across counter resets (the
        # gauge resets with the kernels' counters; the counter never goes
        # back)
        total = stats.get("ring_hop_bytes")
        if isinstance(total, (int, float)) and not isinstance(total, bool):
            if total > self._sync_bytes_seen:
                self.sync_bytes.inc(float(total - self._sync_bytes_seen))
            # a drop means the counts were reset: re-baseline, counter keeps
            self._sync_bytes_seen = float(total)
        # speculation acceptance: delta-fed like the sync-bytes counter,
        # keeping the high-water mark and re-baselining only on a drop to 0
        # (engine.stats.reset()), so the counter stays monotone
        emitted = stats.get("spec_emitted")
        if isinstance(emitted, (int, float)) and not isinstance(emitted, bool):
            if emitted > self._spec_emitted_seen:
                self.spec_accepted.inc(float(emitted - self._spec_emitted_seen))
                self._spec_emitted_seen = float(emitted)
            elif emitted == 0:
                self._spec_emitted_seen = 0.0
        # graph captures after warmup never reset within a process, nor do
        # journal records, recovered requests and leaks (a drop means the
        # journal or coordinator was swapped: re-baseline, the counter keeps)
        for fld, ctr, seen_attr in (
                ("jit_compiles_after_warmup", self.jit_compiles, "_jit_compiles_seen"),
                ("journal_records", self.journal_records, "_journal_records_seen"),
                ("recovered_requests", self.recovered_requests, "_recovered_seen"),
                ("resource_leaks_total", self.resource_leaks, "_resource_leaks_seen")):
            v = stats.get(fld)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                seen = getattr(self, seen_attr)
                if v > seen:
                    ctr.inc(float(v - seen))
                setattr(self, seen_attr, float(v))
        # breaker exposition (serving/breaker.py): the state gauge tracks
        # breaker_state_code verbatim; the classified-failure counter is
        # delta-fed from the engine_failures dict, same recipe as above
        code = stats.get("breaker_state_code")
        if isinstance(code, (int, float)) and not isinstance(code, bool):
            self.breaker_state.set(float(code))
        fails = stats.get("engine_failures")
        if isinstance(fails, dict):
            for cls, v in fails.items():
                if not isinstance(v, (int, float)):
                    continue
                seen = self._failures_seen.get(cls, 0.0)
                if v > seen:
                    self.engine_failures.inc(
                        float(v - seen), failure_class=str(cls)
                    )
                self._failures_seen[cls] = float(v)

    def render_prometheus(self, bridge: dict | None = None) -> str:
        if bridge:
            self.bridge_stats(bridge)
        return self.registry.render()

    def chrome_trace(self, since: int = 0,
                     trace_id: str | None = None) -> dict:
        return tracer_chrome_trace(self.tracer, since=since,
                                   trace_id=trace_id)

    def dump_trace(self, path: str) -> dict:
        doc = dump_chrome_trace(self.tracer, path)
        self.logger.emit("trace_dump", path=path,
                         events=len(doc["traceEvents"]))
        return doc
