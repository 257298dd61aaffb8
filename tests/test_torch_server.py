"""The port's HTTP server on the CPU against the JAX package's, on the tiny
model: the same greedy bodies, sent concurrently, give byte-identical text;
SSE deltas concatenate to the same text; a seeded sampled request
reproduces and its tokens lie in the exact nucleus; ``/stats`` counts the
Q40 kernel wrappers' calls.

The port serves packed Q40 weights (its kernels' plain versions on the
CPU, exact f32 dot) under its serving defaults (pipelined decode, fused
admissions, multi-step horizons); the JAX server runs its synchronous
path (``speculative=False``, ``pipelined=False``, ``fused_prefill=False``,
``multi_step=1``) on dense f32 weights.
"""

import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_multiusers_tpu.formats import load_model_header as j_load_header
from distributed_llama_multiusers_tpu.models import load_params_from_m as j_load_params
from distributed_llama_multiusers_tpu.runtime import (
    ContinuousBatchingScheduler as JaxScheduler,
    InferenceEngine as JaxEngine,
)
from distributed_llama_multiusers_tpu.server import ApiServer as JaxApiServer
from distributed_llama_multiusers_tpu.tokenizer import Tokenizer as JaxTokenizer
from distributed_llama_multiusers_tpu_torch.formats import load_model_header
from distributed_llama_multiusers_tpu_torch.models import load_params_from_m_quantized
from distributed_llama_multiusers_tpu_torch.ops import cuda_q40
from distributed_llama_multiusers_tpu_torch.runtime import (
    ContinuousBatchingScheduler,
    InferenceEngine,
)
from distributed_llama_multiusers_tpu_torch.server import ApiServer
from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer

GREEDY_BODIES = [
    ("/v1/completions", {"prompt": "hello world", "max_tokens": 12, "temperature": 0}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi there"}],
                              "max_tokens": 10, "temperature": 0}),
    ("/v1/completions", {"prompt": "the quick brown fox", "max_tokens": 9,
                         "temperature": 0, "stop": ["zz"]}),
]


def _serve(api):
    httpd = api.serve(host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def servers(tiny_model):
    path = tiny_model["model"]
    config, params = load_params_from_m_quantized(path, load_model_header(path),
                                                  dtype=torch.float32, device="cpu")
    tok = Tokenizer(tiny_model["tokenizer"])
    engine = InferenceEngine(config, params, n_lanes=4, prefill_buckets=(16, 32),
                             device="cpu")
    sched = ContinuousBatchingScheduler(engine, tok)
    sched.start()
    httpd, url = _serve(ApiServer(sched, tok, model_name="tiny-test"))

    jconfig, jparams = j_load_params(path, j_load_header(path), dtype=jnp.float32)
    jtok = JaxTokenizer(tiny_model["tokenizer"])
    jengine = JaxEngine(jconfig, jparams, n_lanes=4, prefill_buckets=(16, 32))
    jsched = JaxScheduler(jengine, jtok, speculative=False, pipelined=False,
                          fused_prefill=False, multi_step=1)
    jsched.start()
    jhttpd, jurl = _serve(JaxApiServer(jsched, jtok, model_name="tiny-test"))
    yield {"port": url, "jax": jurl, "engine": engine, "tokenizer": tok}
    for h in (httpd, jhttpd):
        h.shutdown()
    sched.stop()
    jsched.stop()


def post(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def stream(url, body, timeout=120):
    """(concatenated delta text, terminal chunk) of one SSE response."""
    req = urllib.request.Request(url, data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    text, last = "", None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            chunk = json.loads(line[6:])
            choice = chunk["choices"][0]
            text += (choice.get("text") or choice.get("delta", {}).get("content") or "")
            last = chunk
    return text, last


def _concurrent(base, bodies):
    out = [None] * len(bodies)
    errors = []

    def worker(i, route, body):
        try:
            out[i] = post(base + route, body)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i, r, b))
               for i, (r, b) in enumerate(bodies)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not errors, errors
    return out


def _text(body):
    choice = body["choices"][0]
    return choice["text"] if "text" in choice else choice["message"]["content"]


def test_concurrent_greedy_byte_identical_to_jax(servers):
    got = _concurrent(servers["port"], GREEDY_BODIES)
    ref = _concurrent(servers["jax"], GREEDY_BODIES)
    assert any(_text(body) for _, body in got)
    for (status, body), (jstatus, jbody) in zip(got, ref):
        assert status == jstatus == 200
        assert _text(body) == _text(jbody) == body["generated_text"]
        assert body["choices"][0]["finish_reason"] == jbody["choices"][0]["finish_reason"]
        assert body["usage"] == jbody["usage"]
        assert body["object"] == jbody["object"]


@pytest.mark.parametrize("i", range(len(GREEDY_BODIES)))
def test_sse_deltas_concatenate_to_same_text(servers, i):
    route, body = GREEDY_BODIES[i]
    _, ref = post(servers["jax"] + route, body)
    text, last = stream(servers["port"] + route, body)
    jtext, jlast = stream(servers["jax"] + route, body)
    assert text == jtext == _text(ref)
    assert last["choices"][0]["finish_reason"] == jlast["choices"][0]["finish_reason"]


def test_stop_string_cuts_the_same_text(servers):
    """A stop string taken from the middle of the greedy text, past its
    first special-token piece (both servers leave a stop inside such a
    piece uncut), ends both answers at the same byte with finish "stop"."""
    route, body = GREEDY_BODIES[0]
    full = _text(post(servers["jax"] + route, body)[1])
    at = full.find("|>") + 2
    assert len(full) >= at + 2, full
    stopped = {**body, "stop": [full[at:at + 2]]}
    got = post(servers["port"] + route, stopped)[1]
    ref = post(servers["jax"] + route, stopped)[1]
    assert _text(got) == _text(ref) and len(_text(got)) <= at
    assert got["choices"][0]["finish_reason"] == ref["choices"][0]["finish_reason"] == "stop"
    assert got["usage"] == ref["usage"]


def test_sampled_request_reproducible(servers):
    body = {"prompt": "hello", "max_tokens": 10, "temperature": 0.9, "top_p": 0.8,
            "seed": 42}
    a = post(servers["port"] + "/v1/completions", body)[1]
    b = post(servers["port"] + "/v1/completions", body)[1]
    assert _text(a) == _text(b)
    assert a["usage"] == b["usage"]


def _nucleus(logits, temp, topp):
    """The exact nucleus of the JAX engine's sampler: sorted softmax at
    max(temp, 1e-6), keep while (csum - p) < topp (topp <= 0 or >= 1: all)."""
    x = logits.astype(np.float64) / max(temp, 1e-6)
    order = np.argsort(-x, kind="stable")
    p = np.exp(x[order] - x[order].max())
    p /= p.sum()
    csum = np.cumsum(p)
    topp = 1.0 if topp <= 0 or topp >= 1 else topp
    return set(order[(csum - p) < topp].tolist())


@pytest.mark.parametrize("temp,topp", [(0.9, 0.8), (1.5, 0.5), (0.7, 1.0)])
def test_sampled_tokens_lie_in_the_nucleus(servers, temp, topp):
    engine = servers["engine"]
    lane = engine.n_lanes - 1  # the server's requests are done; lanes idle
    prompt = [1, 5, 9, 3]
    n = engine.n_lanes
    seeds = np.full(n, 1234, np.uint32)
    temps = np.zeros(n, np.float32)
    topps = np.full(n, topp, np.float32)
    temps[lane] = temp
    with engine.stats.preserved():
        logits, _, pos = engine.prefill(lane, prompt)
        tok = engine.sample_token(logits, temp, topp, 1234, pos - 1)
        assert tok in _nucleus(logits.numpy(), temp, topp)
        draws = []
        for _ in range(12):
            tokens = np.zeros(n, np.int64)
            positions = np.full(n, engine.config.seq_len, np.int64)
            tokens[lane], positions[lane] = tok, pos
            step, _, sampled = engine.decode(tokens, positions, temps, topps, seeds)
            tok = int(sampled[lane])
            assert tok in _nucleus(step[lane].numpy(), temp, topp)
            draws.append(tok)
            pos += 1
    assert len(draws) == 12


def test_sampler_rules():
    """Temperature floor, the top-p clamp and the (csum - p) < topp rule
    on a hand-made row: the nucleus keeps exactly the expected tokens
    (finite log p), and seeded draws land inside it."""
    from distributed_llama_multiusers_tpu_torch.runtime.sampling import (
        nucleus_logp,
        sample_lanes,
    )

    row = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]]))

    def kept(t, p):
        logp, idx = nucleus_logp(row, torch.tensor([t]), torch.tensor([p]))
        return set(idx[0][torch.isfinite(logp[0])].tolist())

    assert kept(1.0, 0.5) == {0}  # 0.5 crosses 0.5: nucleus {0}
    assert kept(1.0, 0.6) == {0, 1}  # (0.8 - 0.3) < 0.6: nucleus {0, 1}
    assert kept(1.0, 0.0) == {0, 1, 2, 3}  # topp <= 0 keeps every token
    assert kept(1.0, 1.0) == {0, 1, 2, 3}
    assert kept(0.0, 1.0) == {0}  # temperature floor: one-hot on the max
    n = 64
    draws = sample_lanes(row.expand(n, 4), torch.ones(n), torch.full((n,), 0.6),
                         torch.arange(n), torch.full((n,), 3), torch.zeros(n, dtype=torch.int64))
    assert set(draws.tolist()) == {0, 1}


def test_stats_health_models(servers):
    cuda_q40.reset_counts()
    post(servers["port"] + "/v1/completions", {"prompt": "hi", "max_tokens": 3,
                                               "temperature": 0})
    status, stats = get(servers["port"] + "/stats")
    assert status == 200
    assert stats["kernel_launches"] == {k: 0 for k in cuda_q40.KERNELS}
    assert stats["kernel_plain_calls"]["q40_slab"] > 0  # f32 dot on the CPU: v4
    assert stats["dequant_mode"] == "v4"
    assert stats["decode_steps"] > 0 and stats["prefill_tokens"] > 0
    assert stats["device"] == "cpu"
    status, health = get(servers["port"] + "/health")
    assert status == 200 and health["status"] == "ok" and health["lanes_total"] == 4
    status, models = get(servers["port"] + "/v1/models")
    assert models["data"][0]["id"] == "tiny-test"


def test_bad_request_and_unknown_route(servers):
    req = urllib.request.Request(servers["port"] + "/v1/chat/completions",
                                 data=b'{"messages": []}',
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(servers["port"] + "/nope", timeout=30)
    assert e.value.code == 404


COMPAT_ARGV = ["--model", "m.m", "--tokenizer", "t.t", "--nthreads", "4", "--gpu-index", "0",
               "--gpu-segments", "0:1", "--net-turbo", "0", "--temperature", "0.7",
               "--topp", "0.8", "--seed", "42", "--max-seq-len", "64", "--port", "9991",
               "--max-queue", "7", "--queue-timeout", "3", "--request-budget", "9",
               "--step-deadline", "2", "--prefix-min-tokens", "32", "--trace-path", "t.json"]


@pytest.mark.parametrize("extra", [[], ["--no-spec"]])
def test_jax_command_line_parses_with_both_parsers(extra):
    """The JAX ``dllama-api`` command line, the reference's compat flags
    and the serving layers' flags included, parses with the port's parser
    as with the JAX one (the port ignores the compat flags); --no-spec
    reaches both."""
    from distributed_llama_multiusers_tpu.app.args import build_parser as jax_parser
    from distributed_llama_multiusers_tpu_torch.app.args import build_parser

    argv = COMPAT_ARGV + extra
    got = build_parser("dllama-api").parse_args(argv)
    want = jax_parser("dllama-api", api=True).parse_args(argv)
    for key in ("model", "tokenizer", "nthreads", "gpu_index", "gpu_segments", "net_turbo",
                "temperature", "topp", "seed", "max_seq_len", "port", "no_spec", "max_queue",
                "queue_timeout", "request_budget", "step_deadline", "prefix_min_tokens",
                "trace_path"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.no_spec is bool(extra)
    help_text = build_parser("dllama-api").format_help()
    assert "--no-spec" in help_text and "--nthreads" not in help_text


@pytest.mark.parametrize("priority,ok", [
    ("high", True), ("NORMAL", True), (" low ", True), (0, True), (2, True), ("2", False),
    ("urgent", False), (7, False), ([1], False), ("", False)])
def test_priority_validated_like_jax(priority, ok):
    """``priority`` parses to the JAX package's class or raises its
    ValueError; ``user`` is kept."""
    from distributed_llama_multiusers_tpu.server.api_types import (
        InferenceParams as JaxParams,
    )
    from distributed_llama_multiusers_tpu_torch.server.api_types import InferenceParams

    body = {"priority": priority, "user": "u1", "max_tokens": 2}
    if not ok:
        for cls in (InferenceParams, JaxParams):
            with pytest.raises(ValueError, match="unknown priority"):
                cls.from_body(body)
        return
    got, want = InferenceParams.from_body(body), JaxParams.from_body(body)
    assert int(got.priority) == int(want.priority) and got.user == want.user == "u1"


@pytest.mark.parametrize("route", ["/v1/completions", "/v1/chat/completions"])
def test_bad_priority_is_the_jax_servers_400(servers, route):
    """A bad priority gets the JAX server's typed 400, before admission;
    a good one is served."""
    body = {"prompt": "hi", "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 2, "temperature": 0}
    answers = []
    for base in (servers["port"], servers["jax"]):
        req = urllib.request.Request(base + route,
                                     data=json.dumps({**body, "priority": "urgent"}).encode(),
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        answers.append((e.value.code, json.loads(e.value.read())))
    assert answers[0] == answers[1] and answers[0][0] == 400
    status, out = post(servers["port"] + route, {**body, "priority": "low", "user": "u1"})
    assert status == 200 and out["usage"]["completion_tokens"] >= 1


def test_stats_carry_the_spec_counters(servers):
    """/stats carries the JAX server's speculation keys."""
    post(servers["port"] + "/v1/completions", {"prompt": "hello world hello world hello",
                                               "max_tokens": 16, "temperature": 0})
    _, stats = get(servers["port"] + "/stats")
    for key in ("spec_steps", "spec_emitted", "spec_lane_steps", "spec_tokens_per_lane_step",
                "spec_pipelined_steps", "spec_accept_hist"):
        assert key in stats, key
    assert stats["spec_steps"] > 0 and stats["spec_tokens_per_lane_step"] >= 1.0
