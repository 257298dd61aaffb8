"""Multi-user request queue + continuous-batching scheduler.

N concurrent requests join and leave one shared batched decode loop. HTTP
threads push ``Request`` objects into the queue; the scheduler thread
admits them into free lanes, interleaves at most one prompt chunk per
iteration with a batched decode step over every generating lane, streams
each lane's text through its own UTF-8 stream decoder and stop-string
detector, and fulfils each request's future on EOS, a stop string or
max_tokens.

Steady-state decode takes the JAX scheduler's default paths: the async
pipeline (step k+1 dispatched from the engine's on-device token carry while
step k's tokens are consumed one step behind), admissions fused into it
(a queued request claims a free lane inside the live chain and its prompt
chunks ride fused prefill+decode dispatches, so the chain never flushes
for them), prompt-lookup speculation inside it (a greedy lane whose
history drafts, ``runtime/spec.py``, ships its candidates with the
dispatch and commits the verified prefix one step behind), and, with
pipelining off, the synchronous verify step and multi-step horizons (up to
``multi_step`` chained steps in one dispatch). Every path emits the
synchronous plain path's token streams; stops, EOS and cancels found a
step (or a horizon, or a verify window) late discard the overshoot, whose
junk KV lies above the committed tokens.

Around the loop sit the JAX scheduler's always-on multi-user layers
(``serving/``, ``telemetry/``): a ``QosQueue`` (bounded admission,
priority classes, per-user deficit-round-robin fair share, which also
orders the lanes claimed inside the live chain), queue-wait and generation
deadlines, graceful drain, a circuit breaker fed by failure containment
(an engine raise fails the lanes it hit, aborts the chain and the loop
serves on; ``/health`` turns 503 while the breaker is open), an optional
step watchdog, request-lifecycle telemetry (stamped on the host, never in
the pipelined dispatch half and never reading a tensor), and the per-lane
prefix cache (an admission whose prompt shares whole prompt chunks with
the prompt KV resident in some lane copies that lane's KV,
``engine.copy_lane``, and prefills only the tail; ``_start_request`` says
what it reuses). With a ``journal`` (``serving/journal.py``) every
admission writes an admit record with the resolved seed and every ending a
finish record, so ``serving/recovery.py`` can regenerate the in-flight set
after a crash through ``build_recovered_request``; ``stop()`` witnesses
that no session record or journal mark outlived the loop
(``analysis/leakcheck.py``). Grammar and paged KV are later work.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable

import numpy as np

from ..analysis import jitcheck, leakcheck
from ..serving import (
    AdmissionRejected,
    CircuitBreaker,
    DeadlinePolicy,
    Priority,
    QosQueue,
    RequestJournal,
    StepWatchdog,
    admit_record,
    budget_expired,
    drain_scheduler,
    queue_expired,
)
from ..serving.watchdog import deadline_from_env
from ..telemetry import Telemetry
from ..tokenizer import EosDetector, EosResult, Tokenizer, TokenizerChatStops
from ..utils import faults
from ..utils.seeds import fresh_seed
from .engine import DEFAULT_TOPP
from .spec import NgramDraftIndex, pow2_floor


class EngineFailure(RuntimeError):
    """Engine-scoped serving failure, resolved onto a request's future by
    the containment layer. Carries the ``request_id`` so the HTTP 500 body
    or the terminal SSE error chunk can name it."""

    def __init__(self, message: str, request_id: int | None = None):
        self.request_id = request_id
        super().__init__(message)


def classify_failure(e: BaseException) -> str:
    """The supervised loop's rule (the JAX scheduler's): ``"request"`` for
    per-request input errors (the ``ValueError`` family: tokenization,
    empty prompts, chunk validation; and ``AdmissionRejected``, which is
    load, not failure), which fail only that request; ``"engine"`` for
    everything a dispatch or consume can raise (CUDA errors, injected
    faults), which the containment layer handles."""
    if isinstance(e, AdmissionRejected):
        return "request"
    return "request" if isinstance(e, ValueError) else "engine"


class RequestState(Enum):
    QUEUED = 0
    PROMPT_PROCESSING = 1
    GENERATING = 2
    DONE = 3
    FAILED = 4


_req_ids = itertools.count(1)
_req_ids_lock = threading.Lock()


def _next_request_id() -> int:
    with _req_ids_lock:
        return next(_req_ids)


def ensure_request_id_floor(min_used_id: int) -> None:
    """Advance the shared request-id counter past ``min_used_id``: recovery
    re-admits crashed requests under their original ids (the SSE reattach
    key), and requests admitted after it must never collide with them."""
    global _req_ids
    with _req_ids_lock:
        nxt = next(_req_ids)
        _req_ids = itertools.count(max(nxt, int(min_used_id) + 1))


@dataclass
class Request:
    """One generation request."""

    prompt: str
    max_tokens: int = 128
    temperature: float = 0.0
    topp: float = DEFAULT_TOPP
    seed: int | None = None
    stop: list[str] = field(default_factory=list)
    add_bos: bool = True
    add_special_tokens: bool = True
    # QoS identity (serving/qos.py): fair-share key and admission class
    user_id: str = ""
    priority: int = Priority.NORMAL
    # per-request deadline overrides (serving/deadlines.py); None = policy
    queue_timeout_s: float | None = None
    budget_s: float | None = None
    # trace context (telemetry/tracectx.py), "tid-sid" wire form, from the
    # X-DLlama-Trace header: every span of this request carries its trace id
    # (journaled, so a recovered stream rejoins its trace)
    trace: str | None = None
    # crash-durable serving (serving/journal.py): which API route built
    # this request ("chat" | "completion" | None), journaled so a recovered
    # stream reattaches with the right SSE chunk shape, and whether this
    # request is a journal replay (its original id and resolved seed)
    api_kind: str | None = None
    recovered: bool = False
    id: int = field(default_factory=_next_request_id)
    state: RequestState = RequestState.QUEUED
    future: Future = field(default_factory=Future)
    on_delta: Callable[[str], None] | None = None  # streaming callback
    # filled by the scheduler
    generated_text: str = ""
    generated_tokens: list[int] = field(default_factory=list)
    n_prompt_tokens: int = 0
    error: str | None = None
    # "stop" | "length" | "cancelled" | "timeout" | "error"
    finish_reason: str | None = None
    submitted_at: float | None = None  # monotonic, stamped by submit()/push()
    admitted_at: float | None = None  # monotonic, stamped at lane claim
    # telemetry: the per-request latency record attached at submit, and
    # the summary (ttft_s, tbt p50/p95, queued_s, phases, ...) made at the
    # end, served with the response and logged as one JSON line
    tel: object = None
    summary: dict | None = None
    _cancelled: threading.Event = field(default_factory=threading.Event)

    def cancel(self) -> None:
        """Stop generating (e.g. the client went away); the lane frees at
        the next loop iteration."""
        self._cancelled.set()


def _common_prefix_len(a, b) -> int:
    """Length of the longest common leading run of two token lists."""
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


@dataclass
class _Lane:
    request: Request | None = None
    pos: int = 0  # next write position
    next_token: int = 0  # token to feed at pos
    eos: EosDetector | None = None
    decoder: object = None
    pending: list[int] = field(default_factory=list)  # unprocessed prompt tail
    seed: int = 0
    # committed (prompt + consumed) tokens and their draft index
    drafter: NgramDraftIndex = field(default_factory=NgramDraftIndex)


class ContinuousBatchingScheduler:
    def __init__(self, engine, tokenizer: Tokenizer, queue_: QosQueue | None = None,
                 eos_padding: tuple[int, int] = (2, 2), multi_step: int = 8,
                 fused_prefill: bool = True, speculative: bool = True,
                 prefix_min_tokens: int = 16, deadlines: DeadlinePolicy | None = None,
                 telemetry: Telemetry | None = None, breaker: CircuitBreaker | None = None,
                 step_deadline_s: float | None = None,
                 journal: RequestJournal | None = None):
        """``speculative``: prompt-lookup speculative decoding of greedy
        lanes, wherever the engine has the verify families (inside the
        pipelined chain, else the synchronous verify step); False turns it
        off. ``multi_step``: in steady-state decode (no prompt chunk pending,
        nothing queued) run up to this many decode steps in one dispatch
        (``engine.decode_multi``); 0 or 1 disables. An engine with
        ``pipeline_depth`` >= 2 pipelines: step k+1 is dispatched from the
        device token carry while step k's tokens are consumed one step
        behind. ``fused_prefill`` (with pipelining): admissions claim lanes inside
        the live chain and their chunks ride fused prefill+decode
        dispatches; off, an admission exits the chain to the synchronous
        admit+prefill path. Streams are the synchronous path's on every
        path.

        The JAX scheduler's serving layers, with its defaults:
        ``queue_`` (default an unbounded ``QosQueue``; the server passes one
        bounded at ``--max-queue``); ``prefix_min_tokens``: an admission
        whose prompt shares at least this many leading tokens, in whole
        prompt chunks, with the prompt KV resident in some lane (finished
        lanes included: their KV stays until overwritten) copies that
        lane's KV and prefills only the tail (``_start_request``), 0
        disables; ``deadlines``: the server-wide queue-wait timeout
        and generation budget (off by default; per-request overrides
        apply either way); ``telemetry``: the span tracer, metrics and
        JSON logger hub (a default one is built); ``breaker``: the circuit
        breaker the containment layer feeds (a default one is built);
        ``step_deadline_s``: the step watchdog's deadline, None reads
        ``DLLAMA_STEP_DEADLINE``, 0 disables (a trip never ends the
        process: the port has no multi-process mesh); ``journal``: the
        crash-durable request journal (``--journal-path``; None, the
        default, journals nothing). Its creator closes it; ``stop()``
        only flushes it."""
        self.engine = engine
        self.tokenizer = tokenizer
        self.queue = queue_ if queue_ is not None else QosQueue()
        self.deadlines = deadlines or DeadlinePolicy()
        self.telemetry = telemetry or Telemetry()
        # the queue-wait histogram takes the queue's own pop-time waits, so
        # its count reconciles with queue_popped
        self.queue.set_wait_observer(self.telemetry.queue_wait.observe)
        self.eos_padding = eos_padding
        self.multi_step = multi_step
        self.fused_prefill = fused_prefill
        self.speculative = speculative
        self.prefix_min_tokens = prefix_min_tokens
        self._lanes = [_Lane() for _ in range(engine.n_lanes)]
        # the prompt tokens whose KV each lane holds at slots [0, len),
        # written by prompt chunks (or copied from such): kept after a
        # request finishes (the KV stays), reset when a request claims the
        # lane, discarded after a failed step
        self._lane_kv: list[list[int]] = [[] for _ in range(engine.n_lanes)]
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._thread: threading.Thread | None = None
        self._chat_stops = TokenizerChatStops(tokenizer)
        self._prefill_rr = 0  # round-robin cursor over admitting lanes
        self.breaker = breaker or CircuitBreaker()
        deadline = deadline_from_env(step_deadline_s)
        self.watchdog = (StepWatchdog(deadline, on_trip=self._on_watchdog_trip)
                         if deadline > 0 else None)
        # watchdog -> loop: abort the pipelined chain at the next host-side
        # opportunity (a slow step returns eventually; the chain must not
        # keep extending behind it)
        self._wd_abort = threading.Event()
        # loop-thread counters read by /stats: containment rounds and
        # deadline expiries
        self.engine_failures = 0
        self.queue_timeouts = 0
        self.budget_timeouts = 0
        self._last_sweep = 0.0
        # crash durability: the journal (None = off) and, after a
        # --recover-journal restart, the replay coordinator whose counters
        # /stats merges
        self.journal = journal
        self.recovery = None
        # the live-session mirror: each admitted request's admit wire
        # record (GET /admin/session/<id>), built whole on the loop thread
        # and assigned or popped with single-key dict ops; one entry per
        # request holding a lane
        self._session_records: dict[int, tuple[dict, Request]] = {}

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        self._draining.clear()
        self._wd_abort.clear()
        # DLLAMA_FAULTS arms the process-wide fault plan (utils/faults.py)
        faults.maybe_arm_from_env()
        if self.watchdog is not None:
            self.watchdog.start()
        self._thread = threading.Thread(target=self._run, name="batching-loop",
                                        daemon=True)
        self._thread.start()
        engine = self.engine
        self.telemetry.startup_log(
            "scheduler_start",
            n_lanes=engine.n_lanes,
            pipeline_depth=getattr(engine, "pipeline_depth", 0),
            fused_prefill=self._fused_ok(),
            multi_step=self.multi_step,
            speculative=self.speculative,
            prefix_min_tokens=self.prefix_min_tokens,
            # True once warmup armed the recompile witness
            # (analysis/jitcheck.py, StepGraphs.mark_warm): False means
            # this scheduler serves steps whose graphs capture mid-request
            jitcheck_armed=jitcheck.armed(),
            queue_capacity=self.queue.capacity,
            queue_timeout_s=self.deadlines.queue_timeout_s,
            request_budget_s=self.deadlines.request_budget_s,
            breaker_threshold=self.breaker.threshold,
            step_deadline_s=self.watchdog.deadline_s if self.watchdog is not None else 0,
            faults_armed=faults.armed(),
        )

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=30)
            if thread.is_alive():
                raise RuntimeError("batching loop failed to stop within 30s")
            self._thread = None
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.journal is not None:
            # a barrier, not close: the journal's creator closes it
            self.journal.flush()
        # the loop joined and _resolve_exit settled every lane, so every
        # count is zero on a clean stop; raises under DLLAMA_LEAKCHECK=1
        leakcheck.check_drained("scheduler stop", self.leak_counts())

    def leak_counts(self) -> dict[str, int]:
        """Live counts of every resource this scheduler owns, the leak
        witness's drain snapshot (also ``resources_live`` on /stats between
        drains): session-mirror records and open journal marks. The port
        has no page pool and no admin device-op queue, so the JAX
        scheduler's ``kv_lane_pages``, ``kv_swap_pending`` and
        ``device_ops`` kinds do not arise."""
        counts = {"session_records": len(self._session_records)}
        if self.journal is not None:
            counts["journal_marks"] = int(self.journal.stats().get("journal_open_marks", 0))
        return counts

    def drain(self, timeout: float | None = None) -> bool:
        """Graceful shutdown (serving/drain.py): stop admitting (submit
        sheds with AdmissionRejected("draining"), /health 503), let queued
        and active work finish or hit its deadline, then join the loop;
        past ``timeout`` the rest is cancelled. True on a clean drain."""
        return drain_scheduler(self, timeout)

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def submit(self, request: Request) -> Request:
        if self._draining.is_set():
            self._shed_draining()
        if not self.breaker.allow():
            # an open circuit sheds before the queue: a broken engine gives
            # fast 503s with Retry-After, not a backlog (half-open probes
            # pass through here)
            self.queue.note_rejection("breaker_open")
            raise AdmissionRejected("breaker_open",
                                    retry_after_s=self.breaker.retry_after_s())
        if request.submitted_at is None:
            request.submitted_at = time.monotonic()
        # the lifecycle record before the push: the loop may admit the
        # request before push() returns
        self.telemetry.on_submit(request)
        try:
            self.queue.push(request)
        except AdmissionRejected:
            request.submitted_at = None  # never entered the queue
            raise
        if self._draining.is_set():
            # raced with drain(): pull it back out and shed, unless the
            # loop already popped it (then it is served)
            if self.queue.remove_if(lambda r: r is request):
                request.submitted_at = None
                self._shed_draining()
        return request

    def _shed_draining(self) -> None:
        self.queue.note_rejection("draining")
        raise AdmissionRejected("draining", retry_after_s=5.0)

    def build_recovered_request(self, entry) -> Request:
        """A journal entry (``serving/journal.JournalEntry``) as a Request for
        deterministic replay (``serving/recovery.py`` calls it and stays
        free of runtime/). The original id is kept (the SSE reattach key)
        and the id counter moves past it; the journaled resolved seed
        rides in ``seed``, so the lane draws the crashed process's
        ``fold_in(seed, pos)`` stream."""
        ensure_request_id_floor(entry.request_id)
        return Request(
            prompt=entry.prompt,
            max_tokens=entry.max_tokens,
            temperature=entry.temperature,
            topp=entry.topp,
            seed=entry.seed,
            stop=list(entry.stop),
            add_bos=entry.add_bos,
            add_special_tokens=entry.add_special_tokens,
            user_id=entry.user,
            priority=entry.priority,
            queue_timeout_s=entry.queue_timeout_s,
            budget_s=entry.budget_s,
            trace=entry.trace,
            api_kind=entry.kind,
            recovered=True,
            id=entry.request_id,
        )

    def export_session(self, request_id: int) -> dict | None:
        """A live session's admit wire record (``serving/journal.admit_record``:
        prompt tokens, sampler params with the resolved seed, QoS class,
        deadlines) plus a ``watermark``, the tokens consumed so far
        (informational: a replay re-buffers from 0 and the client's
        ``Last-Event-ID`` picks the resume point). None for unknown or
        finished requests and for queued ones (only an admitted request
        has a resolved seed)."""
        got = self._session_records.get(int(request_id))
        if got is None:
            return None
        rec, req = got
        out = dict(rec)
        out["watermark"] = len(req.generated_tokens)
        return out

    def occupancy(self) -> tuple[int, int]:
        """(busy lanes, total lanes)."""
        return sum(1 for l in self._lanes if l.request is not None), len(self._lanes)

    def qos_stats(self) -> dict:
        """The JAX scheduler's QoS fields for /stats: drain state, deadline
        expiries, containment rounds, the breaker's and the watchdog's
        state, and the queue's depth, wait and rejection counters."""
        out = {
            "draining": self.draining,
            "queue_timeouts": self.queue_timeouts,
            "budget_timeouts": self.budget_timeouts,
            "engine_failure_rounds": self.engine_failures,
        }
        out.update(self.breaker.stats())
        if self.watchdog is not None:
            out.update(self.watchdog.stats())
        # crash durability: the journal's write accounting and, after a
        # --recover-journal restart, the replay counters (bridged to
        # /metrics like every field)
        if self.journal is not None:
            out.update(self.journal.stats())
        if self.recovery is not None:
            out.update(self.recovery.stats())
        out.update(self.queue.stats())
        return out

    def _on_watchdog_trip(self, waited_s: float) -> None:
        """Watchdog callback (on the watchdog thread): a step made no
        progress within the deadline. Trip the breaker (/health 503, new
        work sheds) and flag the pipelined chain to abort at its next
        host-side opportunity. A kernel on the card cannot be cancelled;
        the blocked step returns when it returns."""
        self.breaker.trip(f"watchdog: no step progress within {waited_s:.1f}s")
        self._wd_abort.set()
        self.telemetry.on_watchdog_trip(waited_s, fatal=False)

    # -- internals ----------------------------------------------------------

    def _resolve_unadmitted(self, req: Request, reason: str) -> None:
        """Finish a request that never claimed a lane (queue timeout, cancel
        while queued): empty text, typed finish_reason."""
        req.state = RequestState.DONE
        req.finish_reason = reason
        self.telemetry.on_unadmitted(req, reason)
        if not req.future.done():
            req.future.set_result(req.generated_text)

    def _shed_unadmitted(self, req: Request) -> None:
        """Fail a request the drain flushed before it claimed a lane: a
        retryable 503 (AdmissionRejected), not an empty answer."""
        req.state = RequestState.FAILED
        req.finish_reason = "cancelled"
        self.telemetry.on_unadmitted(req, "shed")
        if not req.future.done():
            req.future.set_exception(AdmissionRejected("draining", retry_after_s=5.0))

    def _fail_request(self, lane_idx: int, req: Request, error: str,
                      exc: BaseException | None = None) -> None:
        """Fail ONE request with finish_reason "error" and reclaim its lane.
        The lane's resident-KV map is discarded: after a failed step its
        cache holds unknown contents, which prefix reuse must never read.
        The future carries ``exc`` (a tokenizer ValueError maps to a 400)
        or an EngineFailure naming the request."""
        req.state = RequestState.FAILED
        req.error = error
        req.finish_reason = "error"
        self._session_records.pop(req.id, None)
        self._lanes[lane_idx] = _Lane()
        self._lane_kv[lane_idx] = []
        try:
            self.engine.reset_lane(lane_idx)
        except Exception:  # noqa: BLE001 — containment must not throw
            pass
        self.telemetry.on_error(req, lane_idx, error)
        if not req.future.done():
            req.future.set_exception(exc if exc is not None
                                     else EngineFailure(error, request_id=req.id))
        if self.journal is not None:
            # after the future, as in _finish: a lost "error" finish record
            # only re-runs the request on recovery, which is always safe
            self.journal.record_finish(req.id, "error",
                                       phases=(req.summary or {}).get("phases"))

    def _free_lanes(self) -> list[int]:
        return [i for i, l in enumerate(self._lanes) if l.request is None]

    def _sweep_queue(self, now: float) -> None:
        """Resolve queued requests that expired or were cancelled while
        waiting, so a saturated server (no lane frees, nothing pops) still
        times out its backlog. Throttled to ~20 Hz: the walk holds the
        queue lock for O(depth)."""
        if self.queue.empty() or now - self._last_sweep < 0.05:
            return
        self._last_sweep = now
        for req in self.queue.remove_if(lambda r: r._cancelled.is_set()
                                        or queue_expired(r, self.deadlines, now)):
            if req._cancelled.is_set():
                self._resolve_unadmitted(req, "cancelled")
            else:
                self.queue_timeouts += 1
                self._resolve_unadmitted(req, "timeout")

    def _claim_next(self, free: list[int], wait_s: float = 0.0):
        """Pop one request (the queue's order: priority, then per-user
        fair share) into the first free lane: its index, -1 when the
        popped request resolved without a lane (cancelled, expired, or it
        failed tokenization), None when the queue is empty. The shared
        body of the synchronous admit and the in-chain claim."""
        req = self.queue.pop(timeout=wait_s)
        if req is None:
            return None
        now = time.monotonic()
        if req._cancelled.is_set():
            self._resolve_unadmitted(req, "cancelled")
            return -1
        if queue_expired(req, self.deadlines, now):
            self.queue_timeouts += 1
            self._resolve_unadmitted(req, "timeout")
            return -1
        req.admitted_at = now
        lane_idx = free.pop(0)
        self.telemetry.on_admit(req, lane_idx)
        try:
            self._start_request(lane_idx, req)
        except Exception as e:
            # tokenization/validation fails this request only; a raise of
            # the prefix copy (a device op) fails it too, then goes to the
            # containment boundary
            self._fail_request(lane_idx, req, str(e), exc=e)
            if classify_failure(e) == "engine":
                raise
            self.breaker.record_request_failure()
            return -1
        return lane_idx

    def _admit(self, wait_s: float = 0.0) -> None:
        free = self._free_lanes()
        while free:
            if self._claim_next(free, wait_s) is None:
                return
            wait_s = 0.0  # only the first pop may park; the rest are polls

    def _start_request(self, lane_idx: int, req: Request) -> None:
        """Tokenize and claim a lane; the prompt runs one bucket per loop
        iteration in ``_prefill_step`` (or the fused dispatches).

        The prefix cache reuses whole prompt chunks: a prompt whose first
        ``start`` tokens, ``start`` a multiple of the largest prefill
        bucket (``engine.max_chunk()``) and at least ``prefix_min_tokens``,
        equal the prompt KV resident in some lane starts at ``start``:
        that lane's slots [0, start) are copied in (``engine.copy_lane``;
        a no-op from the lane itself) and the tail is prefilled. The tail
        then runs the very chunks a cold prefill of this prompt runs, and
        the copied slots hold the bits a cold prefill writes (prompt
        chunks of the same tokens, shapes and positions), so the stream is
        the cold one's in every dequant mode. The JAX scheduler reuses the
        whole common prefix, generated tokens included; on the card a
        tail chunk of another shape runs other products (another k-split
        plan, under ``auto`` another kernel with Q80 activations) and its
        greedy stream can part from the cold one (PERF.md §7). At least
        one token is left to prefill, whose logits pick the first
        generated token."""
        req.state = RequestState.PROMPT_PROCESSING
        tokens = self.tokenizer.encode(
            req.prompt, add_bos=req.add_bos, add_special_tokens=req.add_special_tokens
        )
        if not tokens:
            raise ValueError("prefill needs at least one token (empty prompt)")
        max_ctx = self.engine.config.seq_len
        if len(tokens) >= max_ctx:
            # keep the tail
            tokens = (tokens[-(max_ctx - req.max_tokens - 1):]
                      if max_ctx > req.max_tokens + 1 else tokens[-max_ctx + 1:])
        req.n_prompt_tokens = len(tokens)
        start = 0
        if self.prefix_min_tokens > 0 and getattr(self.engine, "copy_lane", None) is not None:
            best_lane, best_lcp = -1, 0
            for j, kv in enumerate(self._lane_kv):
                if kv:  # an empty map: a never-used lane or a failed one
                    lcp = _common_prefix_len(tokens, kv)
                    if lcp > best_lcp:
                        best_lane, best_lcp = j, lcp
            best_lcp = min(best_lcp, len(tokens) - 1)  # >= 1 token to prefill
            best_lcp -= best_lcp % self.engine.max_chunk()  # whole chunks
            if best_lcp > 0 and best_lcp >= self.prefix_min_tokens:
                self.engine.copy_lane(best_lane, lane_idx, prefix_len=best_lcp)
                start = best_lcp
        if start > 0:
            self.telemetry.on_prefix_hit(req, start)
            with self.engine.stats.lock:
                self.engine.stats.prefix_hits += 1
                self.engine.stats.prefix_tokens_saved += start
        self._lane_kv[lane_idx] = list(tokens[:start])
        lane = self._lanes[lane_idx]
        lane.request = req
        lane.pos = start
        lane.pending = list(tokens[start:])
        lane.drafter = NgramDraftIndex(tokens)  # seeded with the prompt
        lane.seed = (req.seed if req.seed is not None else fresh_seed()) & 0xFFFFFFFF
        stops = list(req.stop) or self._chat_stops.stops
        lane.eos = EosDetector(self.tokenizer.eos_token_ids, stops,
                               self.eos_padding[0], self.eos_padding[1])
        lane.decoder = self.tokenizer.make_stream_decoder()
        # the admit record last, with the resolved seed: nothing is recorded
        # for a request that failed above. One kwargs set feeds the journal
        # and the live-session mirror, so the two cannot drift
        admit_kw = dict(
            request_id=req.id, prompt=req.prompt, tokens=list(tokens),
            max_tokens=req.max_tokens, temperature=req.temperature,
            topp=req.topp, seed=int(lane.seed), stop=list(req.stop),
            add_bos=req.add_bos, add_special_tokens=req.add_special_tokens,
            user=req.user_id, priority=int(req.priority),
            queue_timeout_s=req.queue_timeout_s, budget_s=req.budget_s,
            stream=req.on_delta is not None, kind=req.api_kind,
            response_format=None, trace=req.trace,
        )
        self._session_records[req.id] = (admit_record(**admit_kw), req)
        if self.journal is not None:
            # only enqueues: the journal's writer thread does the file I/O
            self.journal.record_admit(**admit_kw)

    def _prefill_step(self) -> bool:
        """Advance ONE admitting lane by one prompt bucket (round-robin).
        Returns True when a chunk was processed."""
        n = len(self._lanes)
        admitting = [i for i in range(n)
                     if self._lanes[i].request is not None and self._lanes[i].pending]
        if not admitting:
            return False
        lane_idx = min(admitting, key=lambda i: (i - self._prefill_rr) % n)
        self._prefill_rr = (lane_idx + 1) % n
        lane = self._lanes[lane_idx]
        req = lane.request
        chunk = lane.pending[: self.engine.max_chunk()]
        t_chunk = time.perf_counter()
        wd = self.watchdog
        if wd is not None:
            wd.begin_step()
        try:
            _, greedy, sampled = self.engine.prefill_chunk(
                lane_idx, chunk, lane.pos, temp=req.temperature, topp=req.topp,
                seed=lane.seed,
            )
        except Exception as e:
            # an engine raise goes to the containment boundary (which fails
            # this lane too); chunk validation fails this request only
            if classify_failure(e) == "engine":
                raise
            self._fail_request(lane_idx, req, str(e), exc=e)
            self.breaker.record_request_failure()
            return True
        finally:
            if wd is not None:
                wd.step_done()
        self.breaker.record_success()
        self.telemetry.on_prefill_chunk(req, lane_idx, t_chunk, len(chunk))
        lane.pos += len(chunk)
        lane.pending = lane.pending[len(chunk):]
        self._lane_kv[lane_idx].extend(chunk)  # committed: prefix-cacheable
        if lane.pending:
            return True
        lane.next_token = int(greedy) if req.temperature == 0.0 else int(sampled)
        req.state = RequestState.GENERATING
        return True

    def _consume(self, lane_idx: int, lane: _Lane, tok: int) -> bool:
        """Emit one generated token on a lane: stream-decode, EOS/stop
        detection, delta callback, position advance, length check. Returns
        False when the lane finished (or failed: a raise here is this
        request's alone)."""
        req = lane.request
        try:
            return self._consume_inner(lane_idx, lane, req, tok)
        except Exception as e:  # noqa: BLE001 — request-scoped host work
            self._fail_request(lane_idx, req, str(e), exc=e)
            self.breaker.record_request_failure()
            return False

    def _consume_inner(self, lane_idx: int, lane: _Lane, req: Request, tok: int) -> bool:
        req.generated_tokens.append(tok)
        # first token: TTFT; later ones: the inter-token gap
        self.telemetry.on_token(req)
        lane.drafter.append(tok)
        piece = lane.decoder.decode(tok)
        result = lane.eos.append(tok, piece)
        if result == EosResult.EOS:
            self._finish(lane_idx, req)
            return False
        if result == EosResult.NOT_EOS:
            delta = lane.eos.get_delta()
            if delta:
                req.generated_text += delta
                if req.on_delta:
                    req.on_delta(delta)
            lane.eos.reset()
        # MAYBE_EOS: hold back
        lane.pos += 1
        if (len(req.generated_tokens) >= req.max_tokens
                or lane.pos >= self.engine.config.seq_len):
            self._finish(lane_idx, req, reason="length")
            return False
        return True

    def _finish(self, lane_idx: int, req: Request, reason: str = "stop") -> None:
        req.state = RequestState.DONE
        req.finish_reason = reason
        self._session_records.pop(req.id, None)
        delta = self._lanes[lane_idx].eos.get_delta()
        if delta:
            req.generated_text += delta
            if req.on_delta:
                req.on_delta(delta)
        self._lanes[lane_idx] = _Lane()
        self.engine.reset_lane(lane_idx)
        # summary, spans and the log line before the future resolves: the
        # HTTP thread reads req.summary the moment result() returns
        self.telemetry.on_finish(req, lane_idx, reason)
        if not req.future.done():
            req.future.set_result(req.generated_text)
        if self.journal is not None:
            # a deliberate ending is final: the finish record keeps a later
            # --recover-journal restart from resurrecting the request (a
            # crash writes none; that absence is the in-flight set).
            # Recorded last, after the held-back tail delta and the future:
            # a finish record that never lands only re-runs the request
            # (the client's Last-Event-ID dedups), one durable before the
            # tail reached the transport would lose the tail
            self.journal.record_finish(req.id, reason,
                                       phases=(req.summary or {}).get("phases"))

    def _run(self) -> None:
        """The serving loop inside a containment boundary: an engine
        exception is contained (``_contain_engine_failure``) and the loop
        keeps serving behind the circuit breaker; on exit, even a fatal
        one, every lane and queued request resolves."""
        try:
            while True:
                try:
                    self._serve_loop()
                    break
                except Exception as e:  # noqa: BLE001 — containment boundary
                    self._contain_engine_failure(e)
                    if self._stop.is_set():
                        break
        finally:
            self._resolve_exit()

    def _contain_engine_failure(self, e: BaseException) -> None:
        """Engine-scoped containment: count the failure (the breaker's
        streak), abort the pipeline ring without reading it back, fail
        every occupied lane with finish_reason "error" (their KV maps are
        discarded) and leave the lanes fresh. The abort drops the host's
        in-flight records and the carry flag only: the decode graphs'
        static inputs, carry buffers and KV planes stay where they were
        captured, so the next chain reseeds from host tokens and replays
        the same graphs. Never raises."""
        err = f"{type(e).__name__}: {e}"
        self.engine_failures += 1
        state = self.breaker.record_engine_failure(err)
        busy = [(i, l.request) for i, l in enumerate(self._lanes) if l.request is not None]
        self.telemetry.on_engine_failure(err, lanes_failed=len(busy), breaker_state=state)
        try:
            self.engine.pipeline_abort()
        except Exception:  # noqa: BLE001 — containment must not throw
            pass
        for i, req in busy:
            try:
                self._fail_request(i, req, err)
            except Exception:  # noqa: BLE001 — containment must not throw
                pass

    def _resolve_exit(self) -> None:
        """stop()/drain() cleanup: in-flight lanes resolve as cancelled,
        queued requests are shed (drain) or failed (stop)."""
        for i, lane in enumerate(self._lanes):
            if lane.request is not None:
                self._finish(i, lane.request, reason="cancelled")
        draining = self._draining.is_set()
        for req in self.queue.drain():
            if draining:
                self._shed_unadmitted(req)
            else:
                req.state = RequestState.FAILED
                self.telemetry.on_error(req, None, "scheduler stopped")
                if not req.future.done():
                    req.future.set_exception(RuntimeError("scheduler stopped"))

    # -- path choice (the JAX scheduler's) -----------------------------------

    def _generating(self) -> list:
        return [(i, l) for i, l in enumerate(self._lanes)
                if l.request is not None and l.request.state == RequestState.GENERATING]

    def _pipelines(self) -> bool:
        """The engine has the pipelined family and a ring depth that buys a
        lag (--pipeline-depth 0 or 1 turns the pipelined path off)."""
        return (getattr(self.engine, "supports_pipelined", False)
                and getattr(self.engine, "pipeline_depth", 0) >= 2)

    def horizons_reachable(self) -> bool:
        """Whether serving can pick a multi-step horizon: only on an engine
        that does not pipeline. With pipelining, every decode step that no
        prompt step preceded in its iteration is pipelined, and a step
        after a prompt step chains no horizon."""
        return (self.multi_step > 1 and not self._pipelines()
                and getattr(self.engine, "supports_multi_step", False))

    def _multi_horizon(self, active, prefilled: bool) -> int:
        """How many decode steps to chain in one dispatch (0 = one plain
        step): only in steady state (no chunk processed this iteration,
        nothing queued), capped by the longest-remaining lane, in powers of
        two."""
        if self.multi_step <= 1 or prefilled:
            return 0
        if not getattr(self.engine, "supports_multi_step", False):
            return 0
        if not self.queue.empty():
            return 0
        rem = 0
        for _, lane in active:
            req = lane.request
            rem = max(rem, min(req.max_tokens - len(req.generated_tokens),
                               self.engine.config.seq_len - lane.pos))
        p = pow2_floor(min(self.multi_step, rem))
        return p if p > 1 else 0

    def _fused_ok(self) -> bool:
        """Fused prefill+decode admissions available: the flag is on, the
        engine has the fused family, and pipelining is live."""
        return (self.fused_prefill and self._pipelines()
                and getattr(self.engine, "supports_fused_prefill", False))

    def _spec_k(self) -> int:
        """Drafts per verify step: 0 with speculation off or on an engine
        without the verify step."""
        if not (self.speculative and getattr(self.engine, "supports_speculative", False)):
            return 0
        return getattr(self.engine, "SPEC_DRAFT", 0)

    def _spec_pl_ok(self) -> bool:
        """Speculation rides the pipelined chain: it is on and the engine
        has the in-chain verify family. Otherwise a draft hit takes the
        loop out of the chain to the synchronous verify step."""
        return self._spec_k() > 0 and getattr(self.engine, "supports_spec_pipelined", False)

    def _drafts_pending(self, live: dict) -> bool:
        """Whether a generating greedy lane's history drafts (a host-side
        probe; lanes mid-admission have no next token yet)."""
        spec_k = self._spec_k()
        if spec_k <= 0:
            return False
        seq_len = self.engine.config.seq_len
        return any(lane.request.state == RequestState.GENERATING
                   and lane.request.temperature == 0.0
                   and seq_len - lane.pos - 1 > 0
                   and lane.drafter.draft(lane.next_token, spec_k)
                   for lane in live.values())

    def _pipeline_ok(self, active, prefilled: bool = False) -> bool:
        """Gate for the pipelined path: engine support and a ring depth that
        buys a lag; with fused prefill a queued admission or a pending
        chunk rides the chain, without it they keep the loop synchronous."""
        if prefilled or not self._pipelines():
            return False
        if self._fused_ok():
            return True
        if not self.queue.empty():
            return False
        return not any(l.request is not None and l.pending for l in self._lanes)

    # -- the pipelined path ---------------------------------------------------

    def _claim_admissions(self, admitting: dict) -> None:
        """Claim queued requests into free lanes without leaving the chain
        (host work only); their chunks ride the dispatch half's fused
        steps. Claim time counts as an admission stall only when the ring
        is empty (nothing in flight for the card meanwhile)."""
        free = self._free_lanes()
        if not free or self.queue.empty():
            return
        stalled = self.engine.pipeline_inflight() == 0
        t0 = time.perf_counter()
        while free:
            claimed = self._claim_next(free)
            if claimed is None:
                break
            if claimed >= 0:
                admitting[claimed] = self._lanes[claimed]
                self.telemetry.on_fused_admit(self._lanes[claimed].request)
        if stalled:
            with self.engine.stats.lock:
                self.engine.stats.admission_stall_s += time.perf_counter() - t0

    def _pipeline_dispatch(self, live: dict, admitting: dict, feed, spec_ok: bool = False):
        """Dispatch half: queue the next step from host-side lane metadata
        only (live lanes read their positions from the device carry, -1,
        except on a reseed: a verify step advances each lane by its own
        accept count, which the host learns one step behind; idle and
        admitting lanes park at seq_len), plus ONE chunk for ONE admitting
        lane (round-robin) in the same fused dispatch. With ``spec_ok`` each
        generating greedy lane's draft index is probed (host work only) and
        a lane that drafts ships up to SPEC_DRAFT + 1 candidates with the
        dispatch, which becomes a verify step: candidate 0 is the guess at
        the carry token (the index is one step behind; on a reseed it is
        the known feed), checked on the device, so a stale probe costs
        acceptance, never correctness. Nothing here reads a device value
        back. Returns ``(fused_info, spec_drafted)``: ``(lane_idx, lane,
        final, n_chunk)`` for a chunk-carrying step, else None; the lanes
        whose candidates can accept ({lane: True}) for a verify step, else
        None. The chunk's bookkeeping commits here, since its KV writes run
        whether or not the step is ever consumed."""
        engine = self.engine
        n_lanes = engine.n_lanes
        seq_len = engine.config.seq_len
        reseed = feed is not None
        positions = np.full(n_lanes, seq_len, np.int64)
        temps = np.zeros(n_lanes, np.float32)
        topps = np.full(n_lanes, DEFAULT_TOPP, np.float32)
        seeds = np.zeros(n_lanes, np.uint32)
        for i, lane in live.items():
            positions[i] = min(lane.pos, seq_len) if reseed else -1
            temps[i] = lane.request.temperature
            topps[i] = lane.request.topp
            seeds[i] = lane.seed
        drafts = draft_len = None
        drafted: dict[int, bool] = {}
        if spec_ok:
            spec_k = engine.SPEC_DRAFT
            for i, lane in live.items():
                req = lane.request
                if (req.state != RequestState.GENERATING or req.temperature != 0.0
                        or seq_len - lane.pos - 1 <= 0):
                    continue
                nt = lane.next_token
                # on a reseed nt is this dispatch's feed; else it fed the
                # step in flight, whose output the first continuation guesses
                d = ([nt] + lane.drafter.draft(nt, spec_k) if reseed
                     else lane.drafter.draft(nt, spec_k + 1))
                if len(d) >= 2:  # candidate 0 alone cannot accept anything
                    if drafts is None:
                        drafts = np.zeros((n_lanes, spec_k + 1), np.int64)
                        draft_len = np.zeros(n_lanes, np.int64)
                    drafts[i, :len(d)] = d
                    draft_len[i] = len(d)
                    drafted[i] = True
        spec_drafted = drafted if drafts is not None else None
        if not admitting:
            if drafts is None:
                engine.decode_pipelined(positions, temps, topps, seeds, tokens=feed)
            else:
                engine.decode_spec_pipelined(positions, drafts, draft_len, temps, topps, seeds,
                                             tokens=feed)
            return None, spec_drafted
        target = min(admitting, key=lambda i: (i - self._prefill_rr) % n_lanes)
        self._prefill_rr = (target + 1) % n_lanes
        lane = admitting[target]
        req = lane.request
        chunk = lane.pending[: engine.max_chunk()]
        prompt = dict(p_lane=target, chunk=chunk, p_start=lane.pos, p_temp=req.temperature,
                      p_topp=req.topp, p_seed=lane.seed, tokens=feed)
        if drafts is None:
            engine.decode_prefill_fused(positions, temps, topps, seeds, **prompt)
        else:  # an admitting chunk and a verify step share the dispatch
            engine.decode_spec_prefill_fused(positions, drafts, draft_len, temps, topps,
                                             seeds, **prompt)
        lane.pos += len(chunk)
        lane.pending = lane.pending[len(chunk):]
        self._lane_kv[target].extend(chunk)  # committed: prefix-cacheable
        return (target, lane, not lane.pending, len(chunk)), spec_drafted

    def _commit_window(self, i: int, lane: _Lane, emitted, cnt: int, drafted: bool) -> bool:
        """A verify step's commit for one lane: next_token and the accepted
        tokens (the plain-decode stream, by the verification identity),
        then the model's token after them becomes the next token. Drafted
        lanes that consumed anything feed the acceptance counters. Returns
        False when the lane finished."""
        seq = [lane.next_token] + [int(t) for t in emitted[:cnt - 1]]
        n_fed = 0
        alive = True
        for t in seq:
            n_fed += 1  # consumed, the finishing token included
            if not self._consume(i, lane, t):
                alive = False
                break
        if drafted:
            with self.engine.stats.lock:
                self.engine.stats.spec_lane_steps += 1
                self.engine.stats.spec_emitted += n_fed
        if alive:
            lane.next_token = int(emitted[cnt - 1])
        return alive

    def _pipeline_consume(self, live: dict, entry: tuple) -> None:
        """Consume half, one step behind: read the oldest step back and do
        the synchronous loop's host work (stream decode, EOS/stop, cancel,
        budget expiry). ``entry`` is ``(step_lanes, fused, t_dispatch,
        spec_drafted)`` recorded at dispatch time: a column whose lane
        finished at an earlier step, or
        whose lane a new request reclaimed meanwhile, is junk and skipped.
        A fused step's extra column (row, for a verify pack) carries its
        chunk's boundary pair; on the final chunk that is the request's
        first generated token. ``spec_drafted`` (None for a plain step)
        marks a verify step: each live lane commits a window of its own
        length, and drafted lanes add their device accept count to the
        histogram. The step's trace slice (dispatch to this readback) is
        stamped here, so the dispatch half stays free of telemetry."""
        wd = self.watchdog
        if wd is not None:
            wd.begin_step()
        try:
            out_a, out_b = self.engine.pipeline_consume()
        finally:
            if wd is not None:
                wd.step_done()
        self.breaker.record_success()
        now = time.monotonic()
        step_lanes, fused, t_dispatch, spec_drafted = entry
        is_spec = spec_drafted is not None
        self.telemetry.on_pipelined_step(
            t_dispatch, fused, kind="spec_pipelined" if is_spec else "pipelined")
        for i, lane in step_lanes:
            if live.get(i) is not lane:
                continue
            req = lane.request
            if req._cancelled.is_set():
                self._finish(i, req, reason="cancelled")
                live.pop(i)
                continue
            if budget_expired(req, self.deadlines, now):
                self.budget_timeouts += 1
                self._finish(i, req, reason="timeout")
                live.pop(i)
                continue
            if is_spec:
                cnt = int(out_b[i])
                drafted = bool(spec_drafted.get(i))
                if drafted:
                    with self.engine.stats.lock:
                        hist = self.engine.stats.spec_accept_hist
                        hist[cnt - 1] = hist.get(cnt - 1, 0) + 1
                if not self._commit_window(i, lane, out_a[i], cnt, drafted):
                    live.pop(i)
                continue
            if not self._consume(i, lane, lane.next_token):
                live.pop(i)
                continue
            # the token this lane fed into the next in-flight step
            lane.next_token = int(out_a[i]) if req.temperature == 0.0 else int(out_b[i])
        if fused is not None:
            i, lane, final, _ = fused
            if final and live.get(i) is lane:
                req = lane.request
                # a verify pack's extra row, a plain step's extra column
                greedy, sampled = ((int(out_a[-1, 0]), int(out_a[-1, 1])) if is_spec
                                   else (int(out_a[-1]), int(out_b[-1])))
                lane.next_token = greedy if req.temperature == 0.0 else sampled
                req.state = RequestState.GENERATING

    def _run_pipelined(self, active) -> None:
        """Steady-state pipelined decode: keep ``pipeline_depth`` steps in
        flight and consume the oldest one step behind. With fused prefill,
        queued requests claim lanes in-chain and stream their chunks
        through fused dispatches; a lane whose final chunk went out joins
        the decode half from the next dispatch, fed by the device carry.
        Speculation rides the chain (``_spec_pl_ok``): a greedy lane whose
        history drafts ships its candidates with a dispatch, probed only
        where the ring lag is at most 1 with no other verify step in
        flight (past that the host's carry candidate cannot line up).
        Queued requests' cancels and expiries are swept, and admitting
        lanes' budgets checked, on the host between steps. Exits by
        draining the in-flight steps through the consume path when stop()
        is set, the watchdog tripped, an admission arrives with fused
        prefill off, a draft hit on an engine without the in-chain verify
        family, or every lane finished; an exit with lanes still live
        counts as a pipeline flush."""
        engine = self.engine
        depth = max(2, int(getattr(engine, "pipeline_depth", 2)))
        fused = self._fused_ok()
        spec_chain = self._spec_pl_ok()
        live: dict[int, _Lane] = dict(active)
        admitting: dict[int, _Lane] = {}
        if fused:
            admitting = {i: l for i, l in enumerate(self._lanes)
                         if l.request is not None and l.pending and i not in live}
            for lane in admitting.values():
                # synchronously admitted, its remaining chunks ride the chain
                self.telemetry.on_fused_admit(lane.request)
        feed = np.zeros(engine.n_lanes, np.int64)
        for i, lane in live.items():
            feed[i] = lane.next_token
        # (live lanes, fused info, dispatch stamp, spec-drafted lanes) per
        # dispatch
        meta: deque = deque()
        host_feed = True  # the first dispatch reseeds the chain
        dispatched_any = False
        probe_drafts = False  # the entry gates just probed the drafters
        while True:
            now = time.monotonic()
            self._sweep_queue(now)
            # an admitting request cancelled or expired mid-prompt: stop
            # streaming its chunks (the in-flight ones write junk-safe KV)
            for i in [j for j, l in admitting.items()
                      if l.request._cancelled.is_set()
                      or budget_expired(l.request, self.deadlines, now)]:
                req = admitting.pop(i).request
                if req._cancelled.is_set():
                    self._finish(i, req, reason="cancelled")
                else:
                    self.budget_timeouts += 1
                    self._finish(i, req, reason="timeout")
            flush = (self._stop.is_set() or self._wd_abort.is_set()
                     or (not live and not admitting))
            if not flush and not self.queue.empty():
                if fused:
                    self._claim_admissions(admitting)
                else:
                    flush = True
            if not flush and probe_drafts and not spec_chain:
                # an engine without the in-chain verify family: a draft hit
                # leaves the chain for the synchronous verify step
                flush = self._drafts_pending(live)
            probe_drafts = True
            while not flush and engine.pipeline_inflight() < depth:
                # the dispatch stamp is taken here; the consume half pairs
                # it with the readback into the step's trace slice
                t_d = time.perf_counter()
                spec_ok = (spec_chain and engine.pipeline_inflight() <= 1
                           and not any(m[3] is not None for m in meta))
                fused_info, spec_drafted = self._pipeline_dispatch(
                    live, admitting, feed if host_feed else None, spec_ok)
                host_feed = False
                dispatched_any = True
                meta.append((tuple(live.items()), fused_info, t_d, spec_drafted))
                if fused_info is not None and fused_info[2]:
                    # final chunk out: the lane decodes from the next
                    # dispatch, its first token and position on the carry
                    i, lane, _, _ = fused_info
                    admitting.pop(i)
                    live[i] = lane
            if engine.pipeline_inflight() == 0:
                break
            self._pipeline_consume(live, meta.popleft())
        if (live or admitting) and dispatched_any:
            self.telemetry.on_flush(len(live), len(admitting))
            with engine.stats.lock:
                engine.stats.pipeline_flushes += 1
        engine.pipeline_flush()  # the ring is drained; this drops the carry

    def _serve_loop(self) -> None:
        n_lanes = self.engine.n_lanes
        cfg = self.engine.config
        while not self._stop.is_set():
            if self._wd_abort.is_set():
                # the watchdog tripped and the step returned (slow, not
                # dead): the chain was drained; serve on (the breaker stays
                # open until its cooldown and a probe)
                self._wd_abort.clear()
            idle = all(l.request is None for l in self._lanes)
            self._admit(wait_s=0.25 if idle else 0.0)
            now = time.monotonic()
            self._sweep_queue(now)
            if (self._draining.is_set() and self.queue.empty()
                    and all(l.request is None for l in self._lanes)):
                break
            occupied = [(i, l) for i, l in enumerate(self._lanes) if l.request is not None]
            if not occupied:
                continue
            # cancelled or over-budget requests free their lanes before a
            # step is spent on them
            for i, lane in occupied:
                if lane.request._cancelled.is_set():
                    self._finish(i, lane.request, reason="cancelled")
                elif budget_expired(lane.request, self.deadlines, now):
                    self.budget_timeouts += 1
                    self._finish(i, lane.request, reason="timeout")

            # with fused prefill the chain is entered before the synchronous
            # prompt step: pending chunks and queued admissions ride it
            if self._fused_ok():
                active = self._generating()
                if (active and self._pipeline_ok(active)
                        and (self._spec_pl_ok() or not self._drafts_pending(dict(active)))):
                    self._run_pipelined(active)
                    continue

            # at most ONE prompt bucket per iteration: decoding lanes stall
            # no longer than one bucket while admissions stream in
            had_generating = any(l.request is not None
                                 and l.request.state == RequestState.GENERATING
                                 for l in self._lanes)
            t_pf = time.perf_counter()
            prefilled = self._prefill_step()
            if prefilled and had_generating:
                with self.engine.stats.lock:
                    self.engine.stats.admission_stall_s += time.perf_counter() - t_pf

            active = self._generating()
            if not active:
                continue
            if self._spec_pl_ok() and self._pipeline_ok(active, prefilled):
                self._run_pipelined(active)
                continue
            # the synchronous verify step, gated per lane: a lane drafts at
            # most the slots it has left before seq_len
            spec_k = self._spec_k()
            drafts = draft_len = None
            if spec_k > 0:
                drafts = np.zeros((n_lanes, spec_k), np.int64)
                draft_len = np.zeros(n_lanes, np.int64)
                for i, lane in active:
                    d_max = min(spec_k, cfg.seq_len - lane.pos - 1)
                    if lane.request.temperature == 0.0 and d_max > 0:
                        d = lane.drafter.draft(lane.next_token, spec_k)[:d_max]
                        drafts[i, :len(d)] = d
                        draft_len[i] = len(d)
                if not draft_len.any():
                    draft_len = None  # nothing to verify: a plain step
            if draft_len is None and self._pipeline_ok(active, prefilled):
                self._run_pipelined(active)
                continue
            tokens = np.zeros(n_lanes, np.int64)
            # idle lanes write their junk KV to the scratch slot at seq_len;
            # lanes mid-prefill write their next unwritten slot, which the
            # next prompt chunk rewrites before any query reads it
            positions = np.full(n_lanes, cfg.seq_len, np.int64)
            temps = np.zeros(n_lanes, np.float32)
            topps = np.full(n_lanes, DEFAULT_TOPP, np.float32)
            seeds = np.zeros(n_lanes, np.uint32)
            for i, lane in enumerate(self._lanes):
                if lane.request is not None and lane.pending:
                    positions[i] = lane.pos
            for i, lane in active:
                tokens[i] = lane.next_token
                positions[i] = lane.pos
                temps[i] = lane.request.temperature
                topps[i] = lane.request.topp
                seeds[i] = lane.seed
            h = 0 if draft_len is not None else self._multi_horizon(active, prefilled)
            wd = self.watchdog
            if wd is not None:
                wd.begin_step()
            t_step = time.perf_counter()
            try:
                if draft_len is not None:
                    _, emitted, n_emit = self.engine.decode_spec(
                        tokens, drafts, draft_len, positions, temps, topps, seeds,
                        want_logits=False)
                elif h > 1:
                    chosen = self.engine.decode_multi(tokens, positions, temps, topps,
                                                      seeds, h)
                else:
                    _, greedy, sampled = self.engine.decode(
                        tokens, positions, temps, topps, seeds, want_logits=False)
            finally:
                # a raised step is the containment layer's, not a stall
                if wd is not None:
                    wd.step_done()
            self.breaker.record_success()
            self.telemetry.on_step("spec" if draft_len is not None
                                   else ("multi" if h > 1 else "sync"),
                                   t_step, args={"h": h} if h > 1 else None)
            if draft_len is not None:
                for i, lane in active:
                    # a sampled lane emits its one draw (its draft_len is 0)
                    self._commit_window(i, lane, emitted[i], int(n_emit[i]),
                                        bool(draft_len[i] > 0))
                continue
            if h > 1:
                for i, lane in active:
                    # next_token + the first h-1 chained choices; the last
                    # becomes the pending token; tokens past a stop are
                    # discarded (their junk KV is rewritten before any read)
                    seq = [lane.next_token] + [int(chosen[j, i]) for j in range(h - 1)]
                    if all(self._consume(i, lane, t) for t in seq):
                        lane.next_token = int(chosen[h - 1, i])
                continue
            for i, lane in active:
                req = lane.request
                if not self._consume(i, lane, lane.next_token):
                    continue
                lane.next_token = int(greedy[i]) if req.temperature == 0.0 else int(sampled[i])
