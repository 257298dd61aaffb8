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
junk KV lies above the committed tokens. Grammar, paged KV, the QoS queue,
circuit breaker, watchdog, journal, telemetry and prefix cache are later
work.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable

import numpy as np

from ..tokenizer import EosDetector, EosResult, Tokenizer, TokenizerChatStops
from .engine import DEFAULT_TOPP
from .spec import NgramDraftIndex, pow2_floor


class AdmissionRejected(RuntimeError):
    """A request shed before it took a lane (the server is draining)."""

    def __init__(self, reason: str, retry_after_s: float = 5.0):
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.http_status = 503
        super().__init__(f"request rejected: {reason}")


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


def fresh_seed() -> int:
    """A sampling seed from OS entropy for requests that name none."""
    return int.from_bytes(os.urandom(4), "little")


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
    id: int = field(default_factory=_next_request_id)
    state: RequestState = RequestState.QUEUED
    future: Future = field(default_factory=Future)
    on_delta: Callable[[str], None] | None = None  # streaming callback
    # filled by the scheduler
    generated_text: str = ""
    generated_tokens: list[int] = field(default_factory=list)
    n_prompt_tokens: int = 0
    error: str | None = None
    finish_reason: str | None = None  # "stop" | "length" | "cancelled" | "error"
    submitted_at: float | None = None  # monotonic
    admitted_at: float | None = None
    first_token_at: float | None = None
    finished_at: float | None = None
    summary: dict | None = None
    _cancelled: threading.Event = field(default_factory=threading.Event)

    def cancel(self) -> None:
        """Stop generating (e.g. the client went away); the lane frees at
        the next loop iteration."""
        self._cancelled.set()


class RequestQueue:
    """Thread-safe FIFO handoff."""

    def __init__(self):
        self._q: "queue.Queue[Request]" = queue.Queue()

    def push(self, request: Request) -> None:
        self._q.put(request)

    def pop(self, timeout: float | None = None) -> Request | None:
        try:
            if timeout:
                return self._q.get(timeout=timeout)
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def empty(self) -> bool:
        return self._q.empty()

    def depth(self) -> int:
        return self._q.qsize()

    def drain(self) -> list[Request]:
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out


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


def _summary(req: Request) -> dict:
    """Per-request latency record served with the response."""
    end = req.finished_at or time.monotonic()
    out = {"n_tokens": len(req.generated_tokens)}
    if req.submitted_at is not None:
        out["total_s"] = round(end - req.submitted_at, 6)
        if req.admitted_at is not None:
            out["queued_s"] = round(req.admitted_at - req.submitted_at, 6)
        if req.first_token_at is not None:
            out["ttft_s"] = round(req.first_token_at - req.submitted_at, 6)
            n = len(req.generated_tokens)
            if n > 1 and end > req.first_token_at:
                out["decode_tok_s"] = round((n - 1) / (end - req.first_token_at), 3)
    return out


class ContinuousBatchingScheduler:
    def __init__(self, engine, tokenizer: Tokenizer, queue_: RequestQueue | None = None,
                 eos_padding: tuple[int, int] = (2, 2), multi_step: int = 8,
                 fused_prefill: bool = True, speculative: bool = True):
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
        path."""
        self.engine = engine
        self.tokenizer = tokenizer
        self.queue = queue_ or RequestQueue()
        self.eos_padding = eos_padding
        self.multi_step = multi_step
        self.fused_prefill = fused_prefill
        self.speculative = speculative
        self._lanes = [_Lane() for _ in range(engine.n_lanes)]
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._thread: threading.Thread | None = None
        self._chat_stops = TokenizerChatStops(tokenizer)
        self._prefill_rr = 0  # round-robin cursor over admitting lanes
        self.engine_failures = 0

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        self._draining.clear()
        self._thread = threading.Thread(target=self._run, name="batching-loop",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=30)
            if thread.is_alive():
                raise RuntimeError("batching loop failed to stop within 30s")
            self._thread = None

    def drain(self, timeout: float | None = None) -> bool:
        """Stop admitting (submit sheds, /health 503), let queued and active
        work finish, then join the loop; past ``timeout`` the rest is
        cancelled. Returns True on a clean drain."""
        self._draining.set()
        thread = self._thread
        clean = True
        if thread is not None:
            thread.join(timeout=timeout)
            clean = not thread.is_alive()
        self.stop()
        return clean

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def submit(self, request: Request) -> Request:
        if self._draining.is_set():
            raise AdmissionRejected("draining", retry_after_s=5.0)
        if request.submitted_at is None:
            request.submitted_at = time.monotonic()
        self.queue.push(request)
        return request

    def occupancy(self) -> tuple[int, int]:
        """(busy lanes, total lanes)."""
        return sum(1 for l in self._lanes if l.request is not None), len(self._lanes)

    # -- internals ----------------------------------------------------------

    def _fail_request(self, lane_idx: int | None, req: Request, error: str,
                      exc: BaseException | None = None) -> None:
        req.state = RequestState.FAILED
        req.error = error
        req.finish_reason = "error"
        req.finished_at = time.monotonic()
        if lane_idx is not None:
            self._lanes[lane_idx] = _Lane()
            self.engine.reset_lane(lane_idx)
        if not req.future.done():
            req.future.set_exception(exc if exc is not None else RuntimeError(error))

    def _free_lanes(self) -> list[int]:
        return [i for i, l in enumerate(self._lanes) if l.request is None]

    def _claim_next(self, free: list[int], wait_s: float = 0.0):
        """Pop one request into the first free lane: its index, -1 when the
        popped request resolved without a lane (cancelled, or it failed
        tokenization), None when the queue is empty."""
        req = self.queue.pop(timeout=wait_s)
        if req is None:
            return None
        if req._cancelled.is_set():
            self._resolve_unadmitted(req, "cancelled")
            return -1
        req.admitted_at = time.monotonic()
        lane_idx = free.pop(0)
        try:
            self._start_request(lane_idx, req)
        except Exception as e:  # tokenization/validation: this request only
            self._fail_request(lane_idx, req, str(e), exc=e)
            return -1
        return lane_idx

    def _admit(self, wait_s: float = 0.0) -> None:
        free = self._free_lanes()
        while free:
            if self._claim_next(free, wait_s) is None:
                return
            wait_s = 0.0  # only the first pop may park; the rest are polls

    def _resolve_unadmitted(self, req: Request, reason: str) -> None:
        req.state = RequestState.DONE
        req.finish_reason = reason
        if not req.future.done():
            req.future.set_result(req.generated_text)

    def _start_request(self, lane_idx: int, req: Request) -> None:
        """Tokenize and claim a lane; the prompt runs one bucket per loop
        iteration in ``_prefill_step``."""
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
        lane = self._lanes[lane_idx]
        lane.request = req
        lane.pos = 0
        lane.pending = list(tokens)
        lane.drafter = NgramDraftIndex(tokens)  # seeded with the prompt
        lane.seed = (req.seed if req.seed is not None else fresh_seed()) & 0xFFFFFFFF
        stops = list(req.stop) or self._chat_stops.stops
        lane.eos = EosDetector(self.tokenizer.eos_token_ids, stops,
                               self.eos_padding[0], self.eos_padding[1])
        lane.decoder = self.tokenizer.make_stream_decoder()

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
        try:
            _, greedy, sampled = self.engine.prefill_chunk(
                lane_idx, chunk, lane.pos, temp=req.temperature, topp=req.topp,
                seed=lane.seed,
            )
        except ValueError as e:  # chunk validation: this request only
            self._fail_request(lane_idx, req, str(e), exc=e)
            return True
        lane.pos += len(chunk)
        lane.pending = lane.pending[len(chunk):]
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
            return False

    def _consume_inner(self, lane_idx: int, lane: _Lane, req: Request, tok: int) -> bool:
        req.generated_tokens.append(tok)
        if req.first_token_at is None:
            req.first_token_at = time.monotonic()
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
        delta = self._lanes[lane_idx].eos.get_delta()
        if delta:
            req.generated_text += delta
            if req.on_delta:
                req.on_delta(delta)
        self._lanes[lane_idx] = _Lane()
        self.engine.reset_lane(lane_idx)
        req.finished_at = time.monotonic()
        req.summary = _summary(req)
        if not req.future.done():
            req.future.set_result(req.generated_text)

    def _run(self) -> None:
        """The serving loop inside a containment boundary: an engine
        exception fails the requests on lanes and the loop keeps serving;
        on exit every lane and queued request resolves."""
        try:
            while True:
                try:
                    self._serve_loop()
                    break
                except Exception as e:  # noqa: BLE001 — containment boundary
                    self.engine_failures += 1
                    err = f"{type(e).__name__}: {e}"
                    # the chain's in-flight steps and carry go with it
                    self.engine.pipeline_abort()
                    for i, lane in enumerate(self._lanes):
                        if lane.request is not None:
                            self._fail_request(i, lane.request, err)
                    if self._stop.is_set():
                        break
        finally:
            for i, lane in enumerate(self._lanes):
                if lane.request is not None:
                    self._finish(i, lane.request, reason="cancelled")
            for req in self.queue.drain():
                req.state = RequestState.FAILED
                if not req.future.done():
                    req.future.set_exception(
                        AdmissionRejected("draining") if self._draining.is_set()
                        else RuntimeError("scheduler stopped"))

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
        the synchronous loop's host work (stream decode, EOS/stop, cancel).
        ``entry`` is ``(step_lanes, fused, spec_drafted)`` recorded at
        dispatch time: a column whose lane finished at an earlier step, or
        whose lane a new request reclaimed meanwhile, is junk and skipped.
        A fused step's extra column (row, for a verify pack) carries its
        chunk's boundary pair; on the final chunk that is the request's
        first generated token. ``spec_drafted`` (None for a plain step)
        marks a verify step: each live lane commits a window of its own
        length, and drafted lanes add their device accept count to the
        histogram."""
        out_a, out_b = self.engine.pipeline_consume()
        step_lanes, fused, spec_drafted = entry
        is_spec = spec_drafted is not None
        for i, lane in step_lanes:
            if live.get(i) is not lane:
                continue
            req = lane.request
            if req._cancelled.is_set():
                self._finish(i, req, reason="cancelled")
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
        Exits by draining the in-flight steps through the consume path when
        stop() is set, an admission arrives with fused prefill off, a draft
        hit on an engine without the in-chain verify family, or every lane
        finished; an exit with lanes still live counts as a pipeline
        flush."""
        engine = self.engine
        depth = max(2, int(getattr(engine, "pipeline_depth", 2)))
        fused = self._fused_ok()
        spec_chain = self._spec_pl_ok()
        live: dict[int, _Lane] = dict(active)
        admitting: dict[int, _Lane] = {}
        if fused:
            admitting = {i: l for i, l in enumerate(self._lanes)
                         if l.request is not None and l.pending and i not in live}
        feed = np.zeros(engine.n_lanes, np.int64)
        for i, lane in live.items():
            feed[i] = lane.next_token
        # (live lanes, fused info, spec-drafted lanes) per dispatch
        meta: deque = deque()
        host_feed = True  # the first dispatch reseeds the chain
        dispatched_any = False
        probe_drafts = False  # the entry gates just probed the drafters
        while True:
            # an admitting request cancelled mid-prompt: stop streaming its
            # chunks (the in-flight ones write junk-safe KV)
            for i in [j for j, l in admitting.items() if l.request._cancelled.is_set()]:
                self._finish(i, admitting.pop(i).request, reason="cancelled")
            flush = self._stop.is_set() or (not live and not admitting)
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
                spec_ok = (spec_chain and engine.pipeline_inflight() <= 1
                           and not any(m[2] is not None for m in meta))
                fused_info, spec_drafted = self._pipeline_dispatch(
                    live, admitting, feed if host_feed else None, spec_ok)
                host_feed = False
                dispatched_any = True
                meta.append((tuple(live.items()), fused_info, spec_drafted))
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
            with engine.stats.lock:
                engine.stats.pipeline_flushes += 1
        engine.pipeline_flush()  # the ring is drained; this drops the carry

    def _serve_loop(self) -> None:
        n_lanes = self.engine.n_lanes
        cfg = self.engine.config
        while not self._stop.is_set():
            idle = all(l.request is None for l in self._lanes)
            self._admit(wait_s=0.25 if idle else 0.0)
            if (self._draining.is_set() and self.queue.empty()
                    and all(l.request is None for l in self._lanes)):
                break
            occupied = [(i, l) for i, l in enumerate(self._lanes) if l.request is not None]
            if not occupied:
                continue
            for i, lane in occupied:
                if lane.request._cancelled.is_set():
                    self._finish(i, lane.request, reason="cancelled")

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
            if draft_len is not None:
                _, emitted, n_emit = self.engine.decode_spec(
                    tokens, drafts, draft_len, positions, temps, topps, seeds,
                    want_logits=False)
                for i, lane in active:
                    # a sampled lane emits its one draw (its draft_len is 0)
                    self._commit_window(i, lane, emitted[i], int(n_emit[i]),
                                        bool(draft_len[i] > 0))
                continue
            h = self._multi_horizon(active, prefilled)
            if h > 1:
                chosen = self.engine.decode_multi(tokens, positions, temps, topps, seeds, h)
                for i, lane in active:
                    # next_token + the first h-1 chained choices; the last
                    # becomes the pending token; tokens past a stop are
                    # discarded (their junk KV is rewritten before any read)
                    seq = [lane.next_token] + [int(chosen[j, i]) for j in range(h - 1)]
                    if all(self._consume(i, lane, t) for t in seq):
                        lane.next_token = int(chosen[h - 1, i])
                continue
            _, greedy, sampled = self.engine.decode(
                tokens, positions, temps, topps, seeds, want_logits=False)
            for i, lane in active:
                req = lane.request
                if not self._consume(i, lane, lane.next_token):
                    continue
                lane.next_token = int(greedy[i]) if req.temperature == 0.0 else int(sampled[i])
