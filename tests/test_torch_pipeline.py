"""The port's serving loop families on the CPU: multi-step decode, the
async decode pipeline and fused prefill admissions, against single steps,
against each other and against the JAX package.

The serving invariant is stream identity: ``decode_multi``, the pipelined
chain (step k+1 dispatched from the device token carry while step k is
read back one step behind) and fused admissions emit the synchronous
path's token streams, for greedy and seeded sampled lanes alike, with
stops, EOS and cancels found one step late. Tolerance: none; tokens are
compared for equality (the CPU runs every step eagerly, so the eager
bodies the card captures as graphs are what these tests hold).
"""

import json
import threading
import time
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
from distributed_llama_multiusers_tpu_torch.runtime import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
    RequestState,
)
from distributed_llama_multiusers_tpu_torch.runtime.engine import (
    DEFAULT_TOPP,
    EngineStats,
    attn_buckets,
    pow2_floor,
    warmup_engine,
)
from distributed_llama_multiusers_tpu_torch.server import ApiServer
from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer


@pytest.fixture(scope="module")
def loaded(tiny_model):
    path = tiny_model["model"]
    config, params = load_params_from_m_quantized(path, load_model_header(path),
                                                  dtype=torch.float32, device="cpu")
    return config, params, Tokenizer(tiny_model["tokenizer"])


@pytest.fixture(scope="module")
def jax_loaded(tiny_model):
    path = tiny_model["model"]
    return j_load_params(path, j_load_header(path), dtype=jnp.float32)


def _engine(config, params, n_lanes=2, **kw):
    return InferenceEngine(config, params, n_lanes=n_lanes, prefill_buckets=(4,),
                           device="cpu", **kw)


TEMPS = np.asarray([0.0, 0.8], np.float32)
TOPPS = np.full(2, DEFAULT_TOPP, np.float32)
SEEDS = np.asarray([0, 123], np.uint32)


def _prefilled(engine, prompt=(5, 9, 3)):
    _, g0, pos = engine.prefill(0, list(prompt))
    _, g1, _ = engine.prefill(1, list(prompt))
    return np.asarray([g0, g1], np.int64), np.asarray([pos, pos], np.int64)


def _sync_chain(engine, n_steps):
    toks, positions = _prefilled(engine)
    out = []
    for _ in range(n_steps):
        _, greedy, sampled = engine.decode(toks, positions, TEMPS, TOPPS, SEEDS)
        toks = np.where(TEMPS == 0.0, greedy, sampled).astype(np.int64)
        out.append(toks.copy())
        positions = positions + 1
    return np.stack(out)


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h", [2, 4, 8])
def test_decode_multi_matches_single_steps_and_jax(loaded, jax_loaded, h):
    """h chained steps (a greedy and a seeded sampled lane) equal h single
    steps of the port and the JAX engine's ``decode_multi``."""
    config, params, _ = loaded
    single = _sync_chain(_engine(config, params), h)
    engine = _engine(config, params)
    toks, positions = _prefilled(engine)
    chosen = engine.decode_multi(toks, positions, TEMPS, TOPPS, SEEDS, h=h)
    np.testing.assert_array_equal(chosen, single)
    jengine = JaxEngine(*jax_loaded, n_lanes=2, prefill_buckets=(4,))
    jt, jp = _prefilled(jengine)
    jchosen = jengine.decode_multi(jt.astype(np.int32), jp.astype(np.int32), TEMPS, TOPPS,
                                   SEEDS, h=h)
    np.testing.assert_array_equal(chosen, jchosen)
    snap = engine.stats.snapshot()
    assert snap["multi_dispatches"] == 1 and snap["decode_steps"] == h


def test_engine_pipelined_matches_single_steps(loaded):
    """A depth-2 pipelined chain fed by the device carry emits the
    synchronous loop's tokens, greedy and seeded lanes together."""
    config, params, _ = loaded
    single = _sync_chain(_engine(config, params), 8)
    engine = _engine(config, params)
    toks, positions = _prefilled(engine)
    out = []
    dispatched = 0
    while len(out) < 8:
        while dispatched - len(out) < engine.pipeline_depth and dispatched < 8:
            engine.decode_pipelined(positions, TEMPS, TOPPS, SEEDS,
                                    tokens=toks if dispatched == 0 else None)
            dispatched += 1
            positions = positions + 1
        greedy, sampled = engine.pipeline_consume()
        out.append(np.where(TEMPS == 0.0, greedy, sampled))
    assert engine.pipeline_flush() == 0
    np.testing.assert_array_equal(np.stack(out), single)
    # chained dispatches read the carried positions (-1) just as well
    engine = _engine(config, params)
    toks, positions = _prefilled(engine)
    engine.decode_pipelined(positions, TEMPS, TOPPS, SEEDS, tokens=toks)
    out = []
    for _ in range(7):
        engine.decode_pipelined(np.full(2, -1), TEMPS, TOPPS, SEEDS)
        g, s = engine.pipeline_consume()
        out.append(np.where(TEMPS == 0.0, g, s))
    g, s = engine.pipeline_consume()
    out.append(np.where(TEMPS == 0.0, g, s))
    engine.pipeline_flush()
    np.testing.assert_array_equal(np.stack(out), single)


def test_engine_pipeline_ring_discipline(loaded):
    """The ring is bounded at pipeline_depth; consuming an empty ring, a
    carry-less chained dispatch and a reseed with -1 positions are caller
    bugs; a flush counts only when it discards in-flight steps; a
    synchronous step refuses to run over a live chain."""
    config, params, _ = loaded
    engine = _engine(config, params, pipeline_depth=2)
    z = np.zeros(2, np.int64)
    with pytest.raises(RuntimeError, match="carry"):
        engine.decode_pipelined(z)
    with pytest.raises(RuntimeError, match="empty"):
        engine.pipeline_consume()
    with pytest.raises(ValueError, match="-1"):
        engine.decode_pipelined(np.full(2, -1), tokens=z)
    engine.decode_pipelined(z, tokens=z)
    engine.decode_pipelined(z)
    assert engine.pipeline_inflight() == 2
    with pytest.raises(RuntimeError, match="ring full"):
        engine.decode_pipelined(z)
    with pytest.raises(RuntimeError, match="flush"):
        engine.decode(z, z)
    assert engine.pipeline_active
    assert engine.pipeline_flush() == 2
    assert not engine.pipeline_active
    snap = engine.stats.snapshot()
    assert snap["pipeline_dispatches"] == 2
    assert snap["pipeline_flushes"] == 1
    assert snap["pipeline_depth_hist"] == {1: 1, 2: 1}
    assert engine.pipeline_flush() == 0
    engine.decode_pipelined(z, tokens=z)
    assert engine.pipeline_abort() == 1 and not engine.pipeline_active
    assert engine.stats.snapshot()["pipeline_flushes"] == 2
    # a verify step is an entry of the same ring: it fills it, and each
    # entry comes back in its own kind ([2, n] rows, or the [n, K + 2] pack)
    k1 = engine.SPEC_DRAFT + 1
    drafts = np.zeros((2, k1), np.int64)
    engine.decode_spec_pipelined(z, drafts, z, tokens=z)
    engine.decode_pipelined(np.full(2, -1))
    with pytest.raises(RuntimeError, match="ring full"):
        engine.decode_spec_pipelined(np.full(2, -1), drafts, z)
    emitted, n_emit = engine.pipeline_consume()
    assert emitted.shape == (2, k1) and list(n_emit) == [1, 1]
    g, s = engine.pipeline_consume()
    assert g.shape == s.shape == (2,)
    assert engine.pipeline_flush() == 0
    snap = engine.stats.snapshot()
    assert snap["spec_pipelined_steps"] == 1 and snap["pipeline_dispatches"] == 5


def test_engine_plain_step_reads_the_carry_a_verify_step_advanced(loaded):
    """After an in-chain verify step that accepts a lane's drafts, the next
    plain pipelined step (position -1) runs at pos + accepted + 1, the
    carried position, and continues the synchronous stream."""
    config, params, _ = loaded
    single = _sync_chain(_engine(config, params), 8)
    engine = _engine(config, params)
    toks, positions = _prefilled(engine)
    k1 = engine.SPEC_DRAFT + 1
    drafts = np.zeros((2, k1), np.int64)
    drafts[0] = [toks[0]] + list(single[:k1 - 1, 0])  # lane 0: the right drafts
    engine.decode_spec_pipelined(positions, drafts, np.asarray([k1, 0]), TEMPS, TOPPS, SEEDS,
                                 tokens=toks)
    engine.decode_pipelined(np.full(2, -1), TEMPS, TOPPS, SEEDS)
    emitted, n_emit = engine.pipeline_consume()
    assert list(n_emit) == [k1, 1]
    assert list(emitted[0]) == list(single[:k1, 0])
    assert int(emitted[1, 0]) == single[0, 1]
    g, s = engine.pipeline_consume()
    engine.pipeline_flush()
    assert int(g[0]) == single[k1, 0]  # lane 0 stepped at the carried pos + k1
    assert int(s[1]) == single[1, 1]  # lane 1 at pos + 1


def test_engine_fused_step_matches_unfused(loaded):
    """A fused dispatch's decode half equals the pipelined chain's, its
    boundary token equals ``prefill_chunk``'s, and the admitted lane then
    continues from the device carry with the synchronous stream."""
    config, params, _ = loaded
    prompt0, prompt1 = [5, 9, 3], [7, 2, 8, 1]
    seq_len = config.seq_len
    ref = _engine(config, params)
    _, g0, pos0 = ref.prefill(0, prompt0)
    _, _, s1 = ref.prefill_chunk(1, prompt1, 0, temp=0.8, topp=DEFAULT_TOPP, seed=123)
    ref_stream = {0: [g0], 1: [s1]}
    toks = np.asarray([g0, s1])
    poss = np.asarray([pos0, len(prompt1)])
    for _ in range(5):
        _, greedy, sampled = ref.decode(toks, poss, TEMPS, TOPPS, SEEDS)
        toks = np.where(TEMPS == 0.0, greedy, sampled)
        poss = poss + 1
        ref_stream[0].append(int(toks[0]))
        ref_stream[1].append(int(toks[1]))

    eng = _engine(config, params)
    _, f0, fpos = eng.prefill(0, prompt0)
    positions = np.asarray([fpos, seq_len])
    eng.decode_pipelined(positions.copy(), TEMPS, TOPPS, SEEDS, tokens=np.asarray([f0, 0]))
    eng.decode_prefill_fused(np.asarray([-1, seq_len]), TEMPS, TOPPS, SEEDS, p_lane=1,
                             chunk=prompt1, p_start=0, p_temp=0.8, p_topp=DEFAULT_TOPP,
                             p_seed=123)
    out = {0: [f0], 1: []}
    g, _ = eng.pipeline_consume()
    assert g.shape == (2,)
    out[0].append(int(g[0]))
    for _ in range(3):
        eng.decode_pipelined(np.full(2, -1), TEMPS, TOPPS, SEEDS)
        g, s = eng.pipeline_consume()
        out[0].append(int(g[0]))
        out[1].append(int(s[2]) if g.shape == (3,) else int(s[1]))
    g, s = eng.pipeline_consume()
    out[0].append(int(g[0]))
    out[1].append(int(s[1]))
    eng.pipeline_flush()
    assert out[0] == ref_stream[0][: len(out[0])] and len(out[0]) == 6
    assert out[1] == ref_stream[1][: len(out[1])] and len(out[1]) == 4
    snap = eng.stats.snapshot()
    assert snap["fused_steps"] == 1 and snap["fused_bucket_hist"] == {4: 1}
    assert snap["pipeline_flushes"] == 0


def test_engine_fused_step_validation(loaded):
    config, params, _ = loaded
    eng = _engine(config, params)
    z = np.zeros(2, np.int64)
    with pytest.raises(ValueError, match="non-empty"):
        eng.decode_prefill_fused(z, chunk=[], tokens=z)
    with pytest.raises(ValueError, match="exceeds bucket"):
        eng.decode_prefill_fused(z, chunk=[1] * 5, tokens=z)
    with pytest.raises(ValueError, match="seq_len"):
        eng.decode_prefill_fused(z, chunk=[1], p_start=config.seq_len, tokens=z)
    with pytest.raises(RuntimeError, match="carry"):
        eng.decode_prefill_fused(z, chunk=[1])


def test_attention_buckets_and_lane_independence(loaded):
    """Prompt chunks attend over powers of two from 64, then seq_len; the
    decode families attend over the whole cache, so a lane's step is the
    same bits whatever the other lanes hold (parked, mid-prompt, or a
    finished lane read one step late at the top position), and a horizon
    runs up to seq_len."""
    config, params, _ = loaded
    assert attn_buckets(2048) == (64, 128, 256, 512, 1024, 2048)
    assert attn_buckets(100) == (64, 100) and attn_buckets(48) == (48,)
    assert [pow2_floor(h) for h in (0, 1, 2, 3, 8, 9)] == [0, 1, 2, 2, 8, 8]
    seq = config.seq_len
    rows = []
    for other in (seq, 0, seq - 1):
        eng = _engine(config, params)
        toks, positions = _prefilled(eng)
        logits, greedy, sampled = eng.decode(toks, [positions[0], other], TEMPS, TOPPS, SEEDS)
        rows.append((logits[0].clone(), greedy[0], sampled[0]))
    for logits, greedy, sampled in rows[1:]:
        assert torch.equal(logits, rows[0][0])
        assert (greedy, sampled) == rows[0][1:]
    eng = _engine(config, params)
    toks, _ = _prefilled(eng)
    chosen = eng.decode_multi(toks, np.asarray([seq - 2, seq]), TEMPS, TOPPS, SEEDS, h=4)
    assert chosen.shape == (4, 2)


def test_warmup_runs_every_family_and_restores_stats(loaded):
    """warmup_engine drives every prefill bucket, both decode variants,
    every multi-step horizon, the pipelined step and the fused step per
    bucket (the card captures their graphs), then restores the counters
    and leaves no chain behind."""
    config, params, _ = loaded
    eng = InferenceEngine(config, params, n_lanes=2, prefill_buckets=(4, 8), device="cpu")
    seen = []
    for name in ("decode_multi", "decode_pipelined", "decode_prefill_fused"):
        fn = getattr(eng, name)
        setattr(eng, name, lambda *a, _fn=fn, _n=name, **k: (seen.append(_n), _fn(*a, **k))[1])
    warmup_engine(eng, multi_step=8)
    assert seen.count("decode_multi") == 3  # h = 8, 4, 2
    assert seen.count("decode_pipelined") == 2  # reseed and chained
    assert seen.count("decode_prefill_fused") == 4  # two forms per bucket
    assert not eng.pipeline_active
    assert eng.stats.snapshot() == EngineStats()._counters()
    assert eng.graphs is None  # the CPU runs the bodies eagerly


@pytest.mark.parametrize("depth,multi_step,reachable", [
    (None, 8, False), (2, 8, False), (1, 8, True), (0, 8, True), (0, 1, False)])
def test_scheduler_horizons_reachable_only_without_pipelining(loaded, depth, multi_step,
                                                              reachable):
    """The scheduler chains multi-step horizons only on an engine that does
    not pipeline (depth 0 or 1), so that is where the server's warmup
    captures them."""
    config, params, tok = loaded
    sched = ContinuousBatchingScheduler(_engine(config, params, pipeline_depth=depth), tok,
                                        multi_step=multi_step)
    assert sched.horizons_reachable() is reachable


def test_stats_depth_hist_snapshot_isolation():
    stats = EngineStats()
    stats.pipeline_depth_hist[1] = 1
    snap = stats.snapshot()
    stats.pipeline_depth_hist[2] = 5
    assert snap["pipeline_depth_hist"] == {1: 1}
    old = stats.reset()
    assert old.pipeline_depth_hist == {1: 1, 2: 5} and stats.pipeline_depth_hist == {}


# ---------------------------------------------------------------------------
# scheduler level
# ---------------------------------------------------------------------------


def _run(loaded, reqs, n_lanes=2, stagger=(), pipeline_depth=None, **kw):
    """Serve ``reqs`` (the ``stagger`` ones submitted once the first has
    emitted two tokens); returns (token streams, engine stats)."""
    config, params, tok = loaded
    engine = InferenceEngine(config, params, n_lanes=n_lanes, prefill_buckets=(4,),
                             device="cpu", pipeline_depth=pipeline_depth)
    sched = ContinuousBatchingScheduler(engine, tok, **kw)
    sched.start()
    try:
        for r in reqs:
            sched.submit(r)
        deadline = time.monotonic() + 120
        while stagger and len(reqs[0].generated_tokens) < 2 and not reqs[0].future.done():
            assert time.monotonic() < deadline
            time.sleep(0.001)
        for r in stagger:
            sched.submit(r)
        for r in list(reqs) + list(stagger):
            r.future.result(timeout=300)
    finally:
        sched.stop()
    everything = list(reqs) + list(stagger)
    assert all(r.error is None for r in everything), [r.error for r in everything]
    return [list(r.generated_tokens) for r in everything], engine.stats.snapshot()


SYNC = {"multi_step": 0, "pipeline_depth": 0, "fused_prefill": False}


def _churn():
    """One request, then three more once it decodes (the chain is live by
    then): four requests on three lanes, so one waits for a lane."""
    first = [Request(prompt="hello world", max_tokens=24, temperature=0.0)]
    late = [Request(prompt="other prompt", max_tokens=13, temperature=0.8, seed=42),
            Request(prompt="a late arrival with a long prompt", max_tokens=18,
                    temperature=0.9, topp=0.8, seed=5),
            Request(prompt="x y z", max_tokens=9, temperature=0.0)]
    return first, late


@pytest.mark.parametrize("mode", ["defaults", "pipelined_unfused", "multi_step"])
def test_scheduler_stream_identity_under_churn(loaded, mode):
    """Four requests on three lanes, three of them arriving while the
    first decodes: every serving path emits the synchronous path's
    streams; the default path carries the late admissions in fused steps
    and never flushes."""
    kw = {"defaults": {}, "pipelined_unfused": {"fused_prefill": False},
          "multi_step": {"pipeline_depth": 0}}[mode]
    first, late = _churn()
    base, _ = _run(loaded, first, n_lanes=3, stagger=late, **SYNC)
    first, late = _churn()
    got, stats = _run(loaded, first, n_lanes=3, stagger=late, **kw)
    assert got == base
    if mode == "defaults":
        assert stats["pipeline_dispatches"] > 0 and stats["fused_steps"] > 0
        assert stats["pipeline_flushes"] == 0
        assert stats["overlap_s"] > 0
    elif mode == "multi_step":
        assert stats["multi_dispatches"] > 0 and stats["pipeline_dispatches"] == 0


def test_scheduler_pipelined_stop_string_mid_flight(loaded):
    """A stop string found one step late: the in-flight junk step is
    discarded and the stream equals the synchronous path's."""
    config, params, tok = loaded
    probe = Request(prompt="hello world", max_tokens=24, temperature=0.0)
    _run(loaded, [probe], **SYNC)
    dec = tok.make_stream_decoder()
    pieces = [dec.decode(t) for t in probe.generated_tokens]
    stop = next((p for i, p in enumerate(pieces)
                 if 3 <= i <= len(pieces) - 6 and p and p.strip()), None)
    assert stop is not None, pieces

    def stopped():
        return [Request(prompt="hello world", max_tokens=24, temperature=0.0, stop=[stop])]

    base, base_stats = _run(loaded, stopped(), **SYNC)
    reqs = stopped()
    got, stats = _run(loaded, reqs)
    assert got == base and reqs[0].finish_reason == "stop" and len(got[0]) < 24
    assert stats["pipeline_dispatches"] > 0
    assert base_stats["decode_steps"] == len(base[0])
    assert stats["decode_steps"] > len(got[0])  # the junk step past the stop ran


def test_scheduler_pipelined_cancel_mid_stream(loaded):
    """A cancel while steps are in flight: the lane ends as cancelled with
    a prefix of the synchronous stream; the other lane is untouched."""
    base, _ = _run(loaded, [Request(prompt="hello world", max_tokens=40, temperature=0.0),
                            Request(prompt="other prompt", max_tokens=16, temperature=0.8,
                                    seed=7)], **SYNC)
    deltas = []
    victim = Request(prompt="hello world", max_tokens=40, temperature=0.0)

    def on_delta(piece):
        deltas.append(piece)
        if len(deltas) == 3:
            victim.cancel()

    victim.on_delta = on_delta
    other = Request(prompt="other prompt", max_tokens=16, temperature=0.8, seed=7)
    got, _ = _run(loaded, [victim, other])
    assert victim.finish_reason == "cancelled"
    assert len(got[0]) < 40 and got[0] == base[0][: len(got[0])]
    assert got[1] == base[1]


def test_scheduler_fused_cancel_mid_admission(loaded):
    """A cancel while the admission's chunks ride the chain: the request
    ends as cancelled and the decoding lane's stream is untouched."""
    config, params, tok = loaded
    base, _ = _run(loaded, [Request(prompt="hello world", max_tokens=28)], **SYNC)
    engine = InferenceEngine(config, params, n_lanes=2, prefill_buckets=(4,), device="cpu")
    sched = ContinuousBatchingScheduler(engine, tok, multi_step=0)
    survivor = Request(prompt="hello world", max_tokens=28)
    victim = Request(prompt="a much longer prompt that spans several prefill buckets for "
                            "sure", max_tokens=8)
    sched.start()
    try:
        sched.submit(survivor)
        deadline = time.monotonic() + 120
        while len(survivor.generated_tokens) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        sched.submit(victim)
        while victim.state == RequestState.QUEUED:
            assert time.monotonic() < deadline
            time.sleep(0.0005)
        victim.cancel()
        survivor.future.result(timeout=300)
        victim.future.result(timeout=300)
    finally:
        sched.stop()
    assert survivor.error is None and victim.error is None
    assert victim.finish_reason == "cancelled"
    assert survivor.generated_tokens == base[0]
    assert engine.stats.snapshot()["pipeline_flushes"] == 0


def test_scheduler_fused_off_admission_flushes(loaded):
    """With fused prefill off an admission exits the chain (a counted
    flush) and the streams still equal the synchronous path's."""
    first, late = _churn()
    base, _ = _run(loaded, first, n_lanes=3, stagger=late, **SYNC)
    first, late = _churn()
    got, stats = _run(loaded, first, n_lanes=3, stagger=late, fused_prefill=False,
                      multi_step=0)
    assert got == base
    assert stats["fused_steps"] == 0 and stats["pipeline_flushes"] > 0


# ---------------------------------------------------------------------------
# the servers
# ---------------------------------------------------------------------------


def _serve(api):
    httpd = api.serve(host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def servers(loaded, jax_loaded, tiny_model):
    """The port's server under its defaults (warmed as dllama_api warms it)
    beside the JAX server under the JAX scheduler's defaults."""
    config, params, tok = loaded
    engine = InferenceEngine(config, params, n_lanes=3, prefill_buckets=(16, 32),
                             device="cpu")
    sched = ContinuousBatchingScheduler(engine, tok)
    warmup_engine(engine, multi_step=sched.multi_step)
    sched.start()
    httpd, url = _serve(ApiServer(sched, tok, model_name="tiny-test"))
    jtok = JaxTokenizer(tiny_model["tokenizer"])
    jengine = JaxEngine(*jax_loaded, n_lanes=3, prefill_buckets=(16, 32))
    jsched = JaxScheduler(jengine, jtok)
    jsched.start()
    jhttpd, jurl = _serve(JaxApiServer(jsched, jtok, model_name="tiny-test"))
    yield {"port": url, "jax": jurl, "sched": sched}
    for h in (httpd, jhttpd):
        h.shutdown()
    sched.stop()
    jsched.stop()


def _sse(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    text, finish = "", None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            choice = json.loads(line[6:])["choices"][0]
            text += choice.get("text") or (choice.get("delta") or {}).get("content") or ""
            finish = choice.get("finish_reason") or finish
    return text, finish


SSE_BODIES = [
    ("/v1/completions", {"prompt": "hello world", "max_tokens": 14, "temperature": 0}),
    ("/v1/completions", {"prompt": "once upon a time", "max_tokens": 16, "temperature": 0.9,
                         "top_p": 0.9, "seed": 7}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "tell me"}],
                              "max_tokens": 12, "temperature": 0.9, "seed": 11}),
]


@pytest.mark.parametrize("i", range(len(SSE_BODIES)))
def test_server_defaults_sse_identical_to_jax(servers, i):
    """Greedy and seeded (temperature 0.9) SSE streams of the port's server
    under its defaults equal the JAX server's, byte for byte."""
    route, body = SSE_BODIES[i]
    got = _sse(servers["port"] + route, body)
    want = _sse(servers["jax"] + route, body)
    assert got == want and got[0]


def test_server_concurrent_sampled_identical_to_jax(servers):
    """The three bodies at once (a fused admission rides the live chain):
    every stream still equals the JAX server's; /stats carries the
    pipeline counters under the JAX keys."""
    out = {}

    def worker(key, base, i):
        out[key, i] = _sse(base + SSE_BODIES[i][0], SSE_BODIES[i][1])

    for key in ("port", "jax"):
        threads = [threading.Thread(target=worker, args=(key, servers[key], i))
                   for i in range(len(SSE_BODIES))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
    for i in range(len(SSE_BODIES)):
        assert out["port", i] == out["jax", i]
    with urllib.request.urlopen(servers["port"] + "/stats", timeout=30) as r:
        stats = json.loads(r.read())
    for k in ("pipeline_dispatches", "pipeline_flushes", "pipeline_depth_hist",
              "multi_dispatches", "fused_steps", "gumbel_sample_launches",
              "gumbel_sample_plain_calls", "decode_graphs", "decode_graph_replays"):
        assert k in stats
    assert stats["pipeline_dispatches"] > 0 and stats["pipeline_flushes"] == 0
    assert stats["gumbel_sample_launches"] == 0 and stats["decode_graphs"] == 0
    assert stats["decode_graph_replays"] == 0
