"""Multi-user HTTP API server.

Routes: POST /v1/chat/completions and POST /v1/completions (JSON, or SSE
with ``"stream": true``), GET /v1/models, GET /health, GET /load, GET
/stats, GET /metrics, GET /trace, and the CORS preflight. A
ThreadingHTTPServer gives every connection its own thread; all of them
submit into the scheduler's queue, and their generations proceed together
in the continuous batch.

The JAX server's serving surface: a shed request (queue full: 429;
draining or breaker open: 503) gets a typed JSON body and a ``Retry-After``
with a deterministic +-20% jitter per request (``serving/qos.py``), so a
burst of sheds does not retry in step. ``/health`` answers 503 while the
server drains or the circuit breaker is open or half-open, with ``/load``'s
body (queue depth, free lanes, breaker, draining); ``/load`` always
answers 200. ``/metrics`` is Prometheus text (0.0.4) bridged from the same
snapshot ``/stats`` serves, so the two reconcile; ``/trace?since=&trace_id=``
serves the span ring as Chrome trace JSON. A valid ``X-DLlama-Trace``
header on a POST is kept on the request and stamped on its spans.

Every streamed delta carries its token index as the SSE ``id:`` line, the
terminal chunk carries the finish reason and the request's latency
summary, and the stream ends with ``data: [DONE]``. A stream's deltas pass
through a ``StreamRelay`` (``serving/resume.py``); with a resume registry
(``--reconnect-grace`` > 0) a client that lost its connection reattaches
within the grace window with ``GET /v1/stream/<id>`` and ``Last-Event-ID``
(live or journal-recovered streams alike) while the request keeps
generating, and each delta written to the transport advances the
journal's delivery watermark. ``GET /admin/session/<id>`` serves a live
request's admit record (``serving/journal.admit_record``) and watermark.

The fleet surface (``fleet/``, ``disagg/``; the JAX server's): every
response names its replica in ``X-DLlama-Replica`` (``--replica-id``,
default host:port), as do SSE terminal chunks and shed chunks
(``replica``); ``/load`` carries the replica's ``role`` (``--role``:
mixed, prefill or decode). ``POST /admin/migrate`` takes another replica's
admit record and regenerates the session here through normal admission
(deterministic replay; the client reattaches with ``GET /v1/stream/<id>``).
``GET /admin/kvpages/<id>`` exports a live session's committed KV pages as
an integrity-hashed bundle and ``POST /admin/kvimport`` verifies and adopts
one (``disagg/kvtransfer.py``); both run their device work on the
scheduler's loop thread (``run_device_op``). A bad bundle (a hash, a page
size, a cache dtype) answers a typed 422 and leaves the pool as it was; an
exhausted pool a 429.
``/stats`` serves the engine counters, lane occupancy, the dequant mode
and each Q40 kernel's launch count (``kernel_launches``; ``kernel_plain_calls`` counts the
plain-version calls of a CPU run), the sampler kernel's
(``gumbel_sample_launches``), the attention kernel's
(``decode_attn_launches``) and an MoE model's router's
(``moe_route_launches``), the serving paths' counters (multi-step
dispatches, the pipeline's dispatches, flushes and depth histogram, fused
admissions), the decode graphs captured and their replays since warmup,
and on a tensor-parallel mesh its shape, the ring hop's launches, plain
calls and bytes, and the hop bytes of the last decode step
(``sync_bytes_per_decode``); and the JAX server's QoS fields (the queue's
depth, waits and rejections, deadline expiries, the breaker and the
watchdog), the prefix cache's hits and tokens saved, the decode graphs
captured after warmup (``jit_compiles_after_warmup``, the JAX server's
post-warmup compile count), the journal's and recovery's counters, the
leak witness's (``resource_leaks_total``, ``resources_live``) and the span
ring's counts.
"""

from __future__ import annotations

import itertools
import json
import socket
import time
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from ..analysis import leakcheck
from ..ops import all_kernel_counts
from ..ops.dequant_select import dequant_stats
from ..runtime.scheduler import Request, fresh_request_id
from ..serving import AdmissionRejected, StreamRelay, jittered_retry_after
from ..serving.journal import entry_from_admit_record
from ..serving.recovery import attach_recovered_stream
from ..telemetry import TRACE_HEADER, Telemetry, TraceContext
from ..telemetry.logs import log_event
from ..tokenizer import ChatItem, TemplateType, chat_generator_for
from . import api_types

# bound on how long an HTTP thread waits on the scheduler (seconds)
DEFAULT_RESULT_TIMEOUT_S = 600.0

# Retry-After jitter keys for sheds with no request yet
_shed_keys = itertools.count(1)


class SchedulerStalled(RuntimeError):
    """No progress on a request within the wait bound: a 503."""

    def __init__(self, request_id: int, waited_s: float):
        self.request_id = request_id
        super().__init__(f"no scheduler progress on request {request_id} within "
                         f"{waited_s:.0f}s")


class ApiServer:
    def __init__(self, scheduler, tokenizer, model_name: str = "dllama",
                 template_type: TemplateType = TemplateType.UNKNOWN,
                 result_timeout_s: float = DEFAULT_RESULT_TIMEOUT_S, resume=None,
                 replica_id: str | None = None, role: str = "mixed"):
        """``resume``: the ``StreamRegistry`` of resumable streams
        (``--reconnect-grace`` > 0), or None: a client that disconnects
        then cancels its request.

        ``replica_id`` (``--replica-id``; None: host:port at ``serve()``)
        names this replica in a fleet: the ``X-DLlama-Replica`` header on
        every response and ``replica`` on SSE terminal and shed chunks.
        ``role`` (``--role``): ``prefill`` replicas take long prompts and
        hand their sessions off after the first token, ``decode`` and
        ``mixed`` ones take the decode side; ``/load`` carries it."""
        self.scheduler = scheduler
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.chat_template = chat_generator_for(tokenizer, template_type)
        self.result_timeout_s = result_timeout_s
        self.resume = resume
        self.replica_id = replica_id
        self.role = str(role or "mixed")
        self._httpd: ThreadingHTTPServer | None = None
        self._fallback_tel: Telemetry | None = None

    # -- request handling ---------------------------------------------------

    def _make_request(self, prompt: str, body: dict, streaming: bool,
                      kind: str | None = None,
                      trace: str | None = None) -> tuple[Request, StreamRelay | None]:
        """The body -> Request mapping of both routes. A streamed request
        gets a ``StreamRelay`` buffering each delta with its token index
        (the SSE ``id:`` line), which is what makes the stream resumable;
        with a resume registry it is registered there. ``kind`` names the
        route (journaled); ``trace`` is the validated X-DLlama-Trace."""
        params = api_types.InferenceParams.from_body(body)
        req = Request(prompt=prompt, max_tokens=params.max_tokens,
                      temperature=params.temperature, topp=params.top_p,
                      seed=params.seed, stop=params.stop, user_id=params.user,
                      priority=params.priority, response_format=params.response_format,
                      trace=trace, api_kind=kind)
        relay = None
        if streaming:
            if self.resume is not None:
                relay = self.resume.register(req, kind=kind)
            else:
                # no reconnects: capacity 0 keeps no replay window (a slow
                # but connected client backpressures into memory)
                relay = StreamRelay(req.id, capacity=0)
                req.future.add_done_callback(lambda _f: relay.finish())
            # on_delta runs on the scheduler thread right after the token
            # was consumed, so len(generated_tokens) is the delta's index
            req.on_delta = lambda d: relay.push(len(req.generated_tokens), d)
        return req, relay

    def build_request(self, body: dict, streaming: bool, trace: str | None = None):
        """/v1/chat/completions: messages through the chat template. Raises
        ValueError on bad input, before any response header goes out."""
        messages = api_types.parse_chat_messages(body)
        chat = self.chat_template.generate(
            [ChatItem(m.role, m.content) for m in messages], append_generation_prompt=True
        )
        return self._make_request(chat.content, body, streaming, kind="chat", trace=trace)

    def build_completion_request(self, body: dict, streaming: bool,
                                 trace: str | None = None):
        """/v1/completions: the raw prompt, no chat template."""
        prompt = api_types.parse_completion_prompt(body)
        return self._make_request(prompt, body, streaming, kind="completion", trace=trace)

    def run_request(self, req: Request, relay, send_chunk, chunk_fn, response_fn):
        """Wait for a submitted request; stream it through ``send_chunk``
        when given, else return the JSON response. A stream whose client
        goes away keeps generating within the reconnect grace (the
        registry's reaper cancels it when nobody returns); without a
        registry it is cancelled, freeing the lane."""
        if send_chunk is None:
            try:
                text = req.future.result(timeout=self.result_timeout_s)
            except FutureTimeout:
                req.cancel()
                raise SchedulerStalled(req.id, self.result_timeout_s) from None
            return response_fn(self.model_name, req.id, text, req.n_prompt_tokens,
                               len(req.generated_tokens), req.finish_reason or "stop",
                               summary=req.summary)
        try:
            self._pump(req, relay, relay.attach(), 0, send_chunk, chunk_fn)
        except (BrokenPipeError, ConnectionError, OSError):
            if self.resume is not None:
                self.resume.detach(req.id)  # the grace clock starts
            else:
                req.cancel()  # the client went away: free the lane
            raise
        return {}

    def _pump(self, req, relay, gen: int, after: int, send_chunk, chunk_fn) -> bool:
        """Drain a stream's relay to one SSE consumer from token index
        ``after`` (0 for a fresh stream, the client's Last-Event-ID on a
        reconnect). Each delta goes out with its index as the ``id:`` line
        and then advances the journal's delivery watermark (a socket write,
        not client receipt: recovery never discards by it). Returns True
        when the terminal chunk went out, False on a quiet end (another
        consumer took the stream over, or a resume gap the client must
        restart from)."""
        journal = getattr(self.scheduler, "journal", None)
        while True:
            item = relay.next_after(after, timeout=self.result_timeout_s, gen=gen)
            if item is None:
                # the gap between deltas is the stream's liveness bound
                req.cancel()
                raise SchedulerStalled(req.id, self.result_timeout_s)
            tag = item[0]
            if tag == "delta":
                _, idx, text = item
                send_chunk(chunk_fn(self.model_name, req.id, text, False), event_id=idx)
                after = idx
                if journal is not None:
                    journal.note_progress(req.id, idx)
                continue
            if tag == "superseded":
                return False
            if tag == "gap":
                # deltas past this consumer's position were evicted: fail
                # closed rather than skip tokens
                send_chunk({"error": "resume window exceeded; restart the request",
                            "reason": "resume_gap", "request_id": req.id})
                if self.resume is not None:
                    # a client that closes cleanly after this chunk raises
                    # nothing, so start the grace clock here
                    self.resume.detach(req.id)
                return False
            break  # ("done",): the future resolved
        try:
            req.future.result()  # re-raise a failure
        except AdmissionRejected as e:
            # shed after the SSE headers went out (a drain flush): the typed
            # shed goes out as an error chunk with its Retry-After hint
            shed = {"error": str(e), "reason": e.reason, "request_id": req.id,
                    "retry_after_s": round(jittered_retry_after(e.retry_after_s, req.id), 2)}
            if self.replica_id:
                shed["replica"] = self.replica_id
            send_chunk(shed)
            req.finish_reason = "cancelled"
        # the terminal chunk names the replica too, so a router can
        # attribute the stream when an intermediary consumed the headers
        term = chunk_fn(self.model_name, req.id, None, True, req.finish_reason or "stop",
                        summary=req.summary)
        if self.replica_id:
            term["replica"] = self.replica_id
        send_chunk(term, event_id=len(req.generated_tokens))
        return True

    def handle_models(self) -> dict:
        return api_types.models_response(self.model_name)

    def handle_stats(self) -> dict:
        """Engine counters, occupancy, dequant mode, mesh, kernel counts,
        the QoS state and the span ring's counts."""
        sched = self.scheduler
        engine = sched.engine
        stats = engine.stats.snapshot()
        busy, total = sched.occupancy()
        out = {
            "prefill_tokens": stats["prefill_tokens"],
            "prefill_s": round(stats["prefill_s"], 6),
            "decode_steps": stats["decode_steps"],
            "decode_s": round(stats["decode_s"], 6),
            "host_bytes_in": stats["host_bytes_in"],
            "lanes_total": total,
            "lanes_busy": busy,
            "queue_depth": sched.queue.depth(),
            "device": str(engine.device),
            "mesh": None if engine.mesh is None else {
                **engine.mesh.shape, "devices": [str(d) for d in engine.mesh.devices],
                "processes": engine.mesh.num_processes},
            "sync_bytes_per_decode": stats["sync_bytes_per_decode"],
            # multi-step horizons taken (each several decode steps in one
            # dispatch; decode_steps counts the chained steps)
            "multi_dispatches": stats["multi_dispatches"],
            # speculative verify steps (each lane's next token and its drafts
            # in one forward), the tokens drafted lanes consumed from them
            # and their (lane, step) pairs: tokens per lane step is the
            # acceptance, 1.0 none accepted, SPEC_DRAFT + 1 all; verify
            # steps inside the pipelined ring; the drafted lanes' device
            # accept counts
            "spec_steps": stats["spec_steps"],
            "spec_emitted": stats["spec_emitted"],
            "spec_lane_steps": stats["spec_lane_steps"],
            "spec_tokens_per_lane_step": (
                round(stats["spec_emitted"] / stats["spec_lane_steps"], 3)
                if stats["spec_lane_steps"] else None),
            "spec_pipelined_steps": stats["spec_pipelined_steps"],
            "spec_accept_hist": {
                str(k): v for k, v in sorted(stats["spec_accept_hist"].items())},
            # async decode pipeline: host consume time hidden behind the
            # card's execution, steps dispatched device-fed, chains cut
            # short before their lanes finished, and ring occupancy right
            # after each dispatch
            "overlap_s": round(stats["overlap_s"], 3),
            "pipeline_dispatches": stats["pipeline_dispatches"],
            "pipeline_flushes": stats["pipeline_flushes"],
            "pipeline_depth_hist": {
                str(k): v for k, v in sorted(stats["pipeline_depth_hist"].items())},
            # stall-free admissions: fused prefill+decode dispatches, host
            # time decoding lanes waited behind admission work, and the
            # prefill bucket each fused dispatch carried
            "fused_steps": stats["fused_steps"],
            "admission_stall_s": round(stats["admission_stall_s"], 6),
            "fused_bucket_hist": {
                str(k): v for k, v in sorted(stats["fused_bucket_hist"].items())},
            "decode_graphs": 0 if engine.graphs is None else len(engine.graphs),
            "decode_graph_replays": 0 if engine.graphs is None else engine.graphs.replays,
            # per-lane prefix cache: admissions that copied a resident
            # prefix and the prompt tokens they did not prefill
            "prefix_hits": stats["prefix_hits"],
            "prefix_tokens_saved": stats["prefix_tokens_saved"],
            # structured output: admissions that attached an automaton and
            # dispatches that carried a constrained lane (the slab's gauges
            # ride qos_stats)
            "grammar_lanes": stats["grammar_lanes"],
            "grammar_masked_steps": stats["grammar_masked_steps"],
            # the JAX server's post-warmup compile count; here the decode
            # graphs captured after warmup, 0 in steady serving
            "jit_compiles_after_warmup": (0 if engine.graphs is None
                                          else engine.graphs.captures_after_warmup),
        }
        # the leak witness's counters, then this scheduler's live ownership
        # (busy serving holds records and marks; only a drain asserts 0)
        out.update(leakcheck.stats())
        out["resources_live"] = sched.leak_counts()
        out.update(dequant_stats())
        out.update(all_kernel_counts())
        # the paged pool's pressure (occupancy, sharing, COW, parking,
        # evictions, sheds) and swap traffic; a contiguous engine has none
        pool = getattr(engine, "pool_stats", None)
        if callable(pool):
            out.update(pool())
        # a pod root: its control packets, its windows' ring steps and the
        # eager step it timed at startup (pod_step_*)
        pod = getattr(engine, "pod_stats", None)
        if callable(pod):
            out.update(pod())
        qos = getattr(sched, "qos_stats", None)
        if callable(qos):  # queue depth/wait/rejections, timeouts, breaker
            out.update(qos())
        if self.resume is not None:  # the SSE reattach registry
            out.update(self.resume.stats())
        out.update(self._telemetry().tracer.counts())
        return out

    def handle_load(self) -> dict:
        """``GET /load``: one cheap JSON with what a router needs per
        decision (queue depth, free lanes, breaker state, draining); always
        200. ``/health`` serves the same body with readiness codes."""
        sched = self.scheduler
        busy, total = sched.occupancy()
        breaker = getattr(sched, "breaker", None)
        draining = bool(getattr(sched, "draining", False))
        state = breaker.state if breaker is not None else "closed"
        out = {
            "status": "draining" if draining else ("unhealthy" if state != "closed" else "ok"),
            "replica": self.replica_id,
            "model": self.model_name,
            "role": self.role,
            "queue_depth": sched.queue.depth(),
            "lanes_free": total - busy,
            "lanes_total": total,
            "breaker": state,
            "draining": draining,
        }
        pool = getattr(sched.engine, "pool_stats", None)
        ps = pool() if callable(pool) else {}
        if ps:  # paged engines only: contiguous ones omit the fields (a
            # literal 0 pages free would read as a full pool)
            out["pool_pages_free"] = ps.get("pool_pages_free", 0)
            out["pool_pages_total"] = ps.get("pool_pages_total", 0)
            out["pool_parked_pages"] = ps.get("pool_parked_pages", 0)
        # this process's position on the /trace timebase (µs since the span
        # tracer's origin): the anchor for merging traces
        out["trace_clock_us"] = round(
            (time.perf_counter() - self._telemetry().tracer.origin) * 1e6, 1)
        return out

    def handle_health(self) -> tuple[int, dict, dict | None]:
        """(status, body, headers): 503 while draining or while the breaker
        is open or half-open, with Retry-After."""
        load = self.handle_load()
        if load["draining"]:
            return 503, load, {"Retry-After": "5"}
        if load["breaker"] != "closed":
            retry = self.scheduler.breaker.retry_after_s()
            return 503, load, {"Retry-After": str(max(1, round(retry)))}
        return 200, load, None

    def _telemetry(self) -> Telemetry:
        """The scheduler's telemetry hub, or a standalone one for a
        scheduler without it (/metrics then serves the bridged gauges)."""
        tel = getattr(self.scheduler, "telemetry", None)
        if tel is None:
            if self._fallback_tel is None:
                self._fallback_tel = Telemetry()
            tel = self._fallback_tel
        return tel

    def handle_metrics(self) -> str:
        """Prometheus text: the native latency histograms and counters plus
        every /stats field bridged as a ``dllama_stats_*`` gauge, from one
        snapshot, so the two endpoints reconcile."""
        return self._telemetry().render_prometheus(bridge=self.handle_stats())

    def handle_trace(self, since: int = 0, trace_id: str | None = None) -> dict:
        """The span ring as Chrome trace-event JSON; ``since`` (a previous
        pull's ``cursor``) returns only newer events, ``trace_id`` one
        request's."""
        return self._telemetry().chrome_trace(since=since, trace_id=trace_id)

    # -- plumbing -----------------------------------------------------------

    def serve(self, host: str = "0.0.0.0", port: int = 9990) -> ThreadingHTTPServer:
        api = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _cors(self):
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")
                self.send_header("Access-Control-Allow-Headers", "Content-Type, Authorization")

            def _json(self, code: int, payload: dict, headers: dict | None = None):
                self._raw(code, json.dumps(payload).encode(), "application/json", headers)

            def _raw(self, code: int, data: bytes, content_type: str,
                     headers: dict | None = None):
                self.send_response(code)
                self._cors()
                self._replica()
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def _reject(self, e: AdmissionRejected, key: int | None = None):
                # 429 (queue full) or 503 (draining, breaker), Retry-After
                # jittered per request so a shed burst does not retry in step
                retry = jittered_retry_after(
                    e.retry_after_s, key if key is not None else next(_shed_keys))
                self._json(e.http_status, {"error": str(e), "reason": e.reason},
                           headers={"Retry-After": str(max(1, round(retry)))})

            def _replica(self):
                # fleet attribution: every response names its replica
                if api.replica_id:
                    self.send_header("X-DLlama-Replica", api.replica_id)

            def _sse_headers(self, request_id: int):
                self.send_response(200)
                self._cors()
                self._replica()
                self.send_header("X-DLlama-Request", str(request_id))
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()

            def _sse_chunk(self, payload: dict, event_id=None):
                buf = b""
                if event_id is not None:
                    buf += f"id: {event_id}\n".encode()
                buf += b"data: " + json.dumps(payload).encode() + b"\n\n"
                self.wfile.write(buf)
                self.wfile.flush()

            def do_OPTIONS(self):  # CORS preflight
                self.send_response(204)
                self._cors()
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/v1/models":
                    self._json(200, api.handle_models())
                elif path.startswith("/v1/stream/"):
                    self._resume_stream()
                elif path.startswith("/admin/session/"):
                    self._export_session()
                elif path.startswith("/admin/kvpages/"):
                    self._export_pages()
                elif path == "/stats":
                    self._json(200, api.handle_stats())
                elif path == "/load":
                    self._json(200, api.handle_load())
                elif path == "/metrics":
                    self._raw(200, api.handle_metrics().encode(),
                              "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/trace":
                    q = parse_qs(urlsplit(self.path).query)
                    try:
                        since = int(q.get("since", ["0"])[0])
                    except ValueError:
                        self._json(400, {"error": "bad since cursor"})
                        return
                    self._json(200, api.handle_trace(since=since,
                                                     trace_id=q.get("trace_id", [None])[0]))
                elif path in ("/", "/health"):
                    self._json(*api.handle_health())
                else:
                    self._json(404, {"error": "not found"})

            def _export_session(self):
                """``GET /admin/session/<id>``: a live request's admit wire
                record and watermark; 404 for unknown, queued or finished
                requests."""
                try:
                    rid = int(self.path.split("?", 1)[0].rsplit("/", 1)[1])
                except ValueError:
                    self._json(400, {"error": "bad session id"})
                    return
                rec = api.scheduler.export_session(rid)
                if rec is None:
                    self._json(404, {"error": "unknown or finished session (only "
                                              "admitted, in-flight requests export one)",
                                     "request_id": rid})
                    return
                self._json(200, rec)

            def _export_pages(self):
                """``GET /admin/kvpages/<id>``: a live session's committed
                KV pages as a transfer bundle (``disagg/kvtransfer.py``).
                404 for unknown or finished requests and on a contiguous
                engine (the router then migrates by ticket alone, which
                prefills again); 503 when the export failed."""
                try:
                    rid = int(self.path.split("?", 1)[0].rsplit("/", 1)[1])
                except ValueError:
                    self._json(400, {"error": "bad session id"})
                    return
                try:
                    bundle = api.scheduler.export_session_pages(rid)
                except Exception as e:  # noqa: BLE001 — the admin plane answers JSON
                    self._json(503, {"error": f"kv page export failed: {e}",
                                     "reason": "export_failed", "request_id": rid})
                    return
                if bundle is None:
                    self._json(404, {"error": "no exportable kv pages (unknown or finished "
                                              "session, or a contiguous kv cache)",
                                     "request_id": rid})
                    return
                self._json(200, bundle)

            def _admin_kvimport(self, body: dict):
                """``POST /admin/kvimport``: verify and adopt a bundle from
                another replica's ``/admin/kvpages/<id>``. Every hash and
                page size is checked before the pool changes (a bad bundle:
                422, typed); the adoption pins the chain like a parked
                session, so the following ``/admin/migrate`` of the same
                session shares its prompt's whole chunks. An exhausted pool
                sheds with the typed 429."""
                from ..disagg.kvtransfer import KVTransferError, adopt_bundle
                from ..runtime.kvpool import PoolExhausted

                engine = api.scheduler.engine
                pool = getattr(engine, "kvpool", None)
                if pool is None:
                    self._json(409, {"error": "kv import needs a paged engine "
                                              "(--paged-kv on) on this replica"})
                    return
                try:
                    # on the loop thread: the adoption changes the pool and
                    # writes pages the steps read
                    receipt = api.scheduler.run_device_op(
                        lambda: adopt_bundle(pool, engine, body))
                except KVTransferError as e:
                    # the bundle itself is bad: not retryable against it
                    self._json(422, {"error": str(e), "reason": e.reason})
                    return
                except PoolExhausted:
                    self._reject(AdmissionRejected("pool_exhausted", retry_after_s=2.0))
                    return
                except Exception as e:  # noqa: BLE001 — the admin plane answers JSON
                    # the caller sees only the status (disagg.prefill's
                    # import_rejected): the log keeps the cause
                    log_event("kvimport_failed", error=f"{type(e).__name__}: {e}")
                    self._json(500, {"error": str(e)})
                    return
                receipt["replica"] = api.replica_id
                self._json(200, receipt)

            def _admin_migrate(self, body: dict):
                """``POST /admin/migrate``: take a session exported by
                another replica (``/admin/session/<id>``'s admit record) and
                regenerate it here through normal admission, byte for byte
                (deterministic replay, as journal recovery does). The client
                reattaches with ``GET /v1/stream/<id>``: the relay holds the
                whole regenerated stream from index 0. A shed answers the
                typed 429/503 with Retry-After."""
                try:
                    entry = entry_from_admit_record(body)
                except ValueError as e:
                    self._json(400, {"error": f"bad migration record: {e}"})
                    return
                if entry.stream and api.resume is None:
                    self._json(409, {"error": "stream migration needs --reconnect-grace > 0 "
                                              "on the target replica (no resume registry)"})
                    return
                # every replica numbers requests from 1: an injected id that
                # names a live request here is re-admitted under a fresh
                # one (the response's request_id is what the router
                # reattaches by)
                if (api.scheduler.export_session(entry.request_id) is not None
                        or (api.resume is not None
                            and api.resume.contains(entry.request_id))):
                    entry.request_id = fresh_request_id()
                req, registered = attach_recovered_stream(api.scheduler, entry, api.resume)
                try:
                    api.scheduler.submit(req)
                except AdmissionRejected as e:
                    if registered:
                        api.resume.discard(req.id)  # nothing will resolve it
                    self._reject(e, key=req.id)
                    return
                except Exception as e:  # noqa: BLE001 — the admin plane answers JSON
                    if registered:
                        api.resume.discard(req.id)
                    self._json(500, {"error": str(e), "request_id": req.id})
                    return
                self._json(200, {"request_id": req.id, "stream_path": f"/v1/stream/{req.id}",
                                 "watermark": entry.watermark, "replica": api.replica_id})

            def _resume_stream(self):
                """``GET /v1/stream/<id>`` with ``Last-Event-ID``: reattach to a
                live or journal-recovered stream and replay from there. 404
                when resumption is off (--reconnect-grace 0), the id is
                unknown or its grace window passed."""
                if api.resume is None:
                    self._json(404, {"error": "stream resumption disabled "
                                              "(--reconnect-grace is 0)"})
                    return
                try:
                    rid = int(self.path.split("?", 1)[0].rsplit("/", 1)[1])
                except ValueError:
                    self._json(400, {"error": "bad stream id"})
                    return
                raw = self.headers.get("Last-Event-ID")
                try:
                    # none: from the relay's base (0 for a recovered stream:
                    # without the client's position the whole stream replays)
                    after = None if raw is None else int(raw)
                except ValueError:
                    self._json(400, {"error": f"bad Last-Event-ID {raw!r}"})
                    return
                entry = api.resume.attach(rid)
                if entry is None:
                    self._json(404, {"error": "unknown or expired stream (reconnect-grace "
                                              "window passed?)", "request_id": rid})
                    return
                req, relay, kind, gen = entry
                chunk_fn = (api_types.completion_chunk_response if kind == "completion"
                            else api_types.chat_chunk_response)
                self._sse_headers(req.id)
                try:
                    api._pump(req, relay, gen, relay.base if after is None else after,
                              self._sse_chunk, chunk_fn)
                    self.wfile.write(b"data: [DONE]\n\n")
                except (BrokenPipeError, ConnectionError, OSError):
                    api.resume.detach(rid)  # gone again: the grace clock restarts
                except Exception as e:  # headers already out: an SSE error event
                    self._sse_chunk({"error": str(e), "request_id": rid})
                    self.wfile.write(b"data: [DONE]\n\n")

            def do_POST(self):
                routes = {
                    "/v1/chat/completions": (
                        api.build_request, api_types.chat_chunk_response,
                        api_types.chat_completion_response,
                    ),
                    "/v1/completions": (
                        api.build_completion_request, api_types.completion_chunk_response,
                        api_types.completion_response,
                    ),
                }
                route = routes.get(self.path)
                admin = {"/admin/migrate": self._admin_migrate,
                         "/admin/kvimport": self._admin_kvimport}.get(self.path)
                if route is None and admin is None:
                    self._json(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": f"bad request: {e}"})
                    return
                if admin is not None:
                    admin(body)
                    return
                build_fn, chunk_fn, response_fn = route
                # a valid X-DLlama-Trace rides the request; a malformed one
                # is dropped (tracing never fails a request)
                ctx = TraceContext.parse(self.headers.get(TRACE_HEADER))
                trace = ctx.to_header() if ctx is not None else None
                req = None

                def err(payload: dict) -> dict:
                    if req is not None:
                        payload["request_id"] = req.id
                    return payload

                try:
                    streaming = bool(body.get("stream"))
                    # validate AND submit before any header goes out, so bad
                    # input gets a 400 and a shed request a 503
                    req, relay = build_fn(body, streaming=streaming, trace=trace)
                    try:
                        api.scheduler.submit(req)
                    except BaseException:
                        # shed: nothing will resolve this future or detach
                        # it, so its registry entry must go
                        if relay is not None and api.resume is not None:
                            api.resume.discard(req.id)
                        raise
                    if not streaming:
                        self._json(200, api.run_request(req, None, None, chunk_fn,
                                                        response_fn))
                        return
                    try:
                        self._sse_headers(req.id)
                    except BaseException:
                        req.cancel()
                        raise
                    try:
                        api.run_request(req, relay, self._sse_chunk, chunk_fn, response_fn)
                        self.wfile.write(b"data: [DONE]\n\n")
                    except (BrokenPipeError, ConnectionError, OSError):
                        return
                    except Exception as e:  # headers already sent: SSE error event
                        self._sse_chunk(err({"error": str(e)}))
                        self.wfile.write(b"data: [DONE]\n\n")
                except AdmissionRejected as e:  # shed before any header
                    self._reject(e, key=req.id if req is not None else None)
                except SchedulerStalled as e:
                    retry = jittered_retry_after(
                        30.0, req.id if req is not None else next(_shed_keys))
                    self._json(503, err({"error": str(e), "reason": "stalled"}),
                               headers={"Retry-After": str(max(1, round(retry)))})
                except ValueError as e:
                    self._json(400, err({"error": str(e)}))
                except Exception as e:  # generation failure
                    self._json(500, err({"error": str(e)}))

        httpd = ThreadingHTTPServer((host, port), Handler)
        httpd.daemon_threads = True
        if self.replica_id is None:
            # where this replica listens (the bound port, so port 0
            # resolves); a wildcard bind takes the machine's name, or every
            # replica would default to the same 0.0.0.0:port
            id_host = host
            if id_host in ("", "0.0.0.0", "::"):
                id_host = socket.gethostname()
            self.replica_id = f"{id_host}:{httpd.server_address[1]}"
        self._httpd = httpd
        return httpd

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
