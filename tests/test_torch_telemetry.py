"""The port's telemetry (``telemetry/``) against the JAX package's, and its
wiring through the port's scheduler and HTTP server on the tiny model (CPU).

Mirrors the JAX package's ``tests/test_telemetry.py`` and
``tests/test_tracectx.py``: ``MetricsRegistry.render()`` gives the same
Prometheus text in both packages for the same observations; a Chrome trace
of the same events is the same valid JSON; a trace header minted by one
package parses in the other; a request's summary has the JAX summary's
keys; lifecycle spans are complete for stop, cancel, timeout and a
queued timeout; ``/metrics`` parses and reconciles with ``/stats`` (both
read with the loop idle, so no step lands between them); ``/trace`` is
loadable Chrome JSON and filters by trace id.
"""

import io
import json
import re
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from distributed_llama_multiusers_tpu import telemetry as jtel
from distributed_llama_multiusers_tpu.telemetry import tracectx as j_tracectx
from distributed_llama_multiusers_tpu_torch import telemetry as ptel
from distributed_llama_multiusers_tpu_torch.formats import load_model_header
from distributed_llama_multiusers_tpu_torch.models import load_params_from_m_quantized
from distributed_llama_multiusers_tpu_torch.runtime import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
)
from distributed_llama_multiusers_tpu_torch.server import ApiServer
from distributed_llama_multiusers_tpu_torch.serving import DeadlinePolicy
from distributed_llama_multiusers_tpu_torch.telemetry import (
    TRACE_HEADER,
    JsonLogger,
    Telemetry,
    TraceContext,
)
from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer

_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})?'
    r' (-?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|Inf)|NaN)$')


def parse_prometheus(text: str) -> dict:
    """{(name, labels): value}; every non-comment line must parse."""
    samples = {}
    assert text.endswith("\n")
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            assert re.match(r"^# (HELP|TYPE) ", line), line
            continue
        m = _SAMPLE_RE.match(line)
        assert m, f"unparseable exposition line: {line!r}"
        samples[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return samples


# ---------------------------------------------------------------------------
# parity of the instruments
# ---------------------------------------------------------------------------


def _observe(pkg, seed: int) -> str:
    rng = np.random.default_rng(seed)
    reg = pkg.MetricsRegistry()
    c = reg.counter("dllama_x_total", "a counter")
    g = reg.gauge("dllama_depth", "a gauge")
    h = reg.histogram("dllama_lat_seconds", "latency", pkg.LATENCY_BUCKETS_S)
    ph = reg.histogram("dllama_phase_seconds", "coarse grid", pkg.log_buckets(1e-3, 10.0, 3))
    for _ in range(300):
        v = float(10 ** rng.uniform(-5, 2.5))
        h.observe(v)
        ph.observe(v)
        c.inc(float(rng.integers(1, 4)), reason=str(rng.choice(["stop", "length"])))
        g.set(float(rng.integers(0, 9)), key=str(rng.integers(0, 3)))
    c.inc()
    assert h.quantile(0.5) == pytest.approx(h.quantile(0.5))
    return reg.render()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_render_equal_jax(seed):
    got, want = _observe(ptel, seed), _observe(jtel, seed)
    assert got == want
    samples = parse_prometheus(got)
    assert samples[("dllama_lat_seconds_count", "")] == 300
    assert ptel.LATENCY_BUCKETS_S == jtel.LATENCY_BUCKETS_S


def _trace_doc(pkg):
    tr = pkg.SpanTracer(capacity=64)
    t0 = tr.origin + 0.5
    tr.slice("generate", "lane0", t0, t0 + 0.01, req_id=7,
             args={"finish_reason": "stop", "trace_id": "ab" * 16})
    tr.slice("step.pipelined", "pipeline", t0, t0 + 0.002)
    tr.slice("queued", "queue", t0 - 0.1, t0, req_id=7)
    tr.instant("finish.stop", "lane0", ts=t0 + 0.01, req_id=7)
    tr.instant("pipeline.flush", "pipeline", ts=t0 + 0.02, args={"live": 1})
    for i in range(100):  # overflow: the ring keeps the newest window
        tr.instant(f"ev{i}", "lane1", ts=t0 + 0.03 + i * 1e-4)
    return tr, pkg.tracer_chrome_trace(tr), pkg.tracer_chrome_trace(tr, since=60)


def test_chrome_trace_equal_jax_and_valid():
    tr, doc, later = _trace_doc(ptel)
    jtr, jdoc, jlater = _trace_doc(jtel)
    assert json.loads(json.dumps(doc)) == json.loads(json.dumps(jdoc))
    assert later == jlater and tr.counts() == jtr.counts()
    assert tr.counts()["trace_events_dropped"] == 41
    tids_named = {e["tid"] for e in doc["traceEvents"]
                  if e["ph"] == "M" and e["name"] == "thread_name"}
    for e in doc["traceEvents"]:
        assert {"name", "ph", "pid", "tid", "ts"} <= set(e)
        if e["ph"] in ("X", "i"):
            assert e["tid"] in tids_named
    assert later["cursor"] == doc["cursor"] == 105
    assert all(e["args"]["seq"] > 60 for e in later["traceEvents"] if e["ph"] != "M")


def test_trace_header_crosses_packages():
    for mint, parse in ((TraceContext.mint, j_tracectx.TraceContext.parse),
                        (j_tracectx.TraceContext.mint, TraceContext.parse)):
        ctx = mint()
        back = parse(ctx.to_header())
        assert (back.trace_id, back.span_id) == (ctx.trace_id, ctx.span_id)
        assert parse(ctx.child().to_header()).trace_id == ctx.trace_id
    assert TRACE_HEADER == j_tracectx.TRACE_HEADER
    for bad in (None, "", "nope", "0" * 32 + "-" + "1" * 16, "a" * 32 + "-" + "0" * 16,
                "A" * 31 + "-" + "b" * 16, "a" * 32 + "b" * 16):
        assert TraceContext.parse(bad) is None and j_tracectx.TraceContext.parse(bad) is None
    assert TraceContext.parse(" " + "AB" * 16 + "-" + "cd" * 8 + " ").trace_id == "ab" * 16


def test_hub_bridge_is_delta_fed_and_names_the_ports_sources():
    tel = Telemetry(logger=JsonLogger(io.StringIO()))
    for hop_bytes, captures in ((1000, 0), (1500, 0), (200, 1), (700, 1)):
        tel.bridge_stats({"ring_hop_bytes": hop_bytes, "jit_compiles_after_warmup": captures,
                          "breaker_state_code": 0, "engine_failures": {"engine": 1}})
    assert tel.sync_bytes.value() == 2000  # 1000 + 500, re-baselined at 200, + 500
    assert tel.jit_compiles.value() == 1
    assert tel.engine_failures.value(failure_class="engine") == 1
    text = tel.render_prometheus()
    assert "CUDA-graph captures after warmup" in text
    assert "ring hop kernel" in text


# ---------------------------------------------------------------------------
# the scheduler's lifecycle spans (tiny model, CPU)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loaded(tiny_model):
    path = tiny_model["model"]
    config, params = load_params_from_m_quantized(path, load_model_header(path),
                                                  dtype=torch.float32, device="cpu")
    return config, params, Tokenizer(tiny_model["tokenizer"])


def _stack(loaded, n_lanes=2, sink=None, **kw):
    config, params, tok = loaded
    engine = InferenceEngine(config, params, n_lanes=n_lanes, prefill_buckets=(8,),
                             device="cpu")
    tel = Telemetry(logger=JsonLogger(sink if sink is not None else io.StringIO()))
    kw.setdefault("speculative", False)
    return engine, ContinuousBatchingScheduler(engine, tok, telemetry=tel, **kw), tel


def _slow_steps(engine, delay: float = 0.005):
    """Stretch each lagged readback: the tiny model reaches its 64-slot
    context in well under a deadline otherwise."""
    real = engine.pipeline_consume

    def slowed():
        time.sleep(delay)
        return real()

    engine.pipeline_consume = slowed


def _wait(pred, timeout=60):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.002)


def test_summary_log_line_and_spans_for_a_normal_finish(loaded):
    from distributed_llama_multiusers_tpu.telemetry.spans import RequestTrace as JaxTrace

    sink = io.StringIO()
    _, sched, tel = _stack(loaded, sink=sink)
    req = Request(prompt="hello world", max_tokens=6)
    sched.start()
    try:
        sched.submit(req)
        req.future.result(timeout=60)
    finally:
        sched.stop()
    s = req.summary
    want_keys = set(JaxTrace(0.0).summary(req, "length"))
    assert set(s) == want_keys
    assert set(s["phases"]) == set(JaxTrace(0.0).phases())
    assert s["finish_reason"] == req.finish_reason
    assert s["n_generated_tokens"] == len(req.generated_tokens) and s["ttft_s"] > 0
    lines = [json.loads(line) for line in sink.getvalue().splitlines()]
    assert [line for line in lines if line["event"] == "request"][0]["request_id"] == req.id
    mine = [e for e in tel.tracer.snapshot() if e.req_id == req.id]
    names = [e.name for e in mine]
    for expected in ("submitted", "queued", "generate", f"finish.{req.finish_reason}"):
        assert expected in names, names
    gen = [e for e in mine if e.name == "generate"][0]
    assert gen.track.startswith("lane") and gen.ph == "X"
    assert tel.ttft.count == 1 and tel.tokens_generated.value() == len(req.generated_tokens)


def test_span_endings_cancel_and_timeout(loaded):
    engine, sched, tel = _stack(loaded)
    _slow_steps(engine)
    cancelled = Request(prompt="hello world", max_tokens=10_000)
    timed_out = Request(prompt="hello world", max_tokens=10_000, budget_s=0.05)
    sched.start()
    try:
        sched.submit(cancelled)
        sched.submit(timed_out)
        _wait(lambda: len(cancelled.generated_tokens) > 2)
        cancelled.cancel()
        cancelled.future.result(timeout=30)
        timed_out.future.result(timeout=30)
    finally:
        sched.stop()
    assert cancelled.finish_reason == "cancelled" and timed_out.finish_reason == "timeout"
    names = {(e.req_id, e.name) for e in tel.tracer.snapshot()}
    for r in (cancelled, timed_out):
        assert (r.id, f"finish.{r.finish_reason}") in names
        assert (r.id, "generate") in names
        assert r.summary["finish_reason"] == r.finish_reason
    assert tel.requests_finished.value(finish_reason="cancelled") == 1
    assert tel.requests_finished.value(finish_reason="timeout") == 1


def test_span_ending_for_a_queued_timeout(loaded):
    engine, sched, tel = _stack(loaded, deadlines=DeadlinePolicy(queue_timeout_s=0.05))
    _slow_steps(engine)
    blockers = [Request(prompt="hello world", max_tokens=10_000) for _ in range(engine.n_lanes)]
    starved = Request(prompt="hello world", max_tokens=4)
    sched.start()
    try:
        for r in blockers:
            sched.submit(r)
        _wait(lambda: all(len(r.generated_tokens) > 0 for r in blockers))
        sched.submit(starved)
        starved.future.result(timeout=30)
    finally:
        for r in blockers:
            r.cancel()
        sched.stop()
    assert starved.finish_reason == "timeout"
    s = starved.summary
    assert s["ttft_s"] is None and s["queued_s"] is None and s["n_generated_tokens"] == 0
    mine = [e for e in tel.tracer.snapshot() if e.req_id == starved.id]
    assert {"queued", "finish.timeout"} <= {e.name for e in mine}
    assert all(e.track == "queue" for e in mine)


def test_fused_admission_spans_and_queue_wait_reconcile(loaded):
    """A request admitted into the live chain rides fused dispatches (its
    summary says so, the trace has step.fused slices); the queue-wait
    histogram counts every pop."""
    _, sched, tel = _stack(loaded)
    a = Request(prompt="hello world", max_tokens=40)
    b = Request(prompt="another prompt here", max_tokens=4)
    sched.start()
    try:
        sched.submit(a)
        _wait(lambda: len(a.generated_tokens) > 3)
        sched.submit(b)
        b.future.result(timeout=30)
        a.future.result(timeout=30)
    finally:
        sched.stop()
    assert a.summary["fused_admitted"] is False and b.summary["fused_admitted"] is True
    events = tel.tracer.snapshot()
    assert any(e.name == "step.fused" for e in events)
    assert any(e.name == "step.pipelined" for e in events)
    assert tel.queue_wait.count == sched.queue.stats()["queue_popped"] == 2


# ---------------------------------------------------------------------------
# HTTP: /metrics, /trace, the trace header
# ---------------------------------------------------------------------------


@pytest.fixture()
def server(loaded):
    engine, sched, tel = _stack(loaded)
    sched.start()
    api = ApiServer(sched, loaded[2], model_name="tel-test")
    httpd = api.serve(host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", sched, tel
    httpd.shutdown()
    sched.stop()


def _post(base, body, headers=None):
    req = urllib.request.Request(base + "/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return r.headers, r.read()


def _idle(sched):
    _wait(lambda: sched.occupancy()[0] == 0 and sched.queue.empty())


def test_metrics_parse_and_reconcile_with_stats(server):
    base, sched, tel = server
    out = _post(base, {"prompt": "hello world", "max_tokens": 5, "temperature": 0})
    assert out["summary"]["n_generated_tokens"] == out["usage"]["completion_tokens"]
    _idle(sched)
    stats = json.loads(_get(base, "/stats")[1])
    headers, raw = _get(base, "/metrics")
    assert headers["Content-Type"].startswith("text/plain; version=0.0.4")
    samples = parse_prometheus(raw.decode())
    for key in ("decode_steps", "pipeline_dispatches", "fused_steps", "queue_popped",
                "prefill_tokens", "lanes_total", "prefix_hits", "jit_compiles_after_warmup",
                "breaker_state_code", "queue_capacity"):
        assert samples[(f"dllama_stats_{key}", "")] == stats[key], key
    for depth, n in stats["pipeline_depth_hist"].items():
        assert samples[("dllama_stats_pipeline_depth_hist", f'{{key="{depth}"}}')] == n
    assert samples[("dllama_ttft_seconds_count", "")] >= 1
    assert samples[("dllama_requests_finished_total", '{finish_reason="length"}')] >= 1
    assert samples[("dllama_jit_compiles_total", "")] == 0
    assert samples[("dllama_breaker_state", "")] == 0
    assert stats["trace_events_recorded"] > 0 and stats["breaker_state"] == "closed"


def test_trace_endpoint_and_header(server):
    base, sched, tel = server
    ctx = TraceContext.mint()
    _post(base, {"prompt": "hello world", "max_tokens": 4, "temperature": 0},
          headers={TRACE_HEADER: ctx.to_header()})
    out = _post(base, {"prompt": "other", "max_tokens": 3}, headers={TRACE_HEADER: "junk"})
    assert "trace_id" not in out["summary"]
    _idle(sched)
    doc = json.loads(_get(base, "/trace")[1])
    events = doc["traceEvents"]
    for e in events:
        assert {"name", "ph", "pid", "tid", "ts"} <= set(e)
    assert any(e["name"] == "generate" and e["ph"] == "X" for e in events)
    mine = json.loads(_get(base, f"/trace?trace_id={ctx.trace_id}")[1])["traceEvents"]
    named = [e for e in mine if e["ph"] != "M"]
    assert named and all(e["args"]["trace_id"] == ctx.trace_id for e in named)
    assert {"submitted", "queued", "generate"} <= {e["name"] for e in named}
    newer = json.loads(_get(base, f"/trace?since={doc['cursor']}")[1])
    assert [e for e in newer["traceEvents"] if e["ph"] != "M"] == []
