"""The port's prompt-lookup speculative decoding on the CPU, against the JAX
package: the copied draft index, the three verify families
(``decode_spec``, ``decode_spec_pipelined``, ``decode_spec_prefill_fused``)
and their packs, the scheduler's streams with speculation on and off, and
the verify window's attention (``ops/cuda_attn.py``'s plain version, which
the CPU runs) against the JAX package's dense attention.

The invariant is the speculative-verification identity: greedy lanes emit
exactly the plain-decode stream, seeded lanes their plain draws; drafts
change only how many forwards the stream costs. Tolerance: none for tokens
and packs (compared for equality); 1e-5 of max|y| for the attention (f32,
XLA and PyTorch order the sums differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_multiusers_tpu.formats import load_model_header as j_load_header
from distributed_llama_multiusers_tpu.models import load_params_from_m as j_load_params
from distributed_llama_multiusers_tpu.models.llama import _dense_attention as jax_attention
from distributed_llama_multiusers_tpu.runtime import (
    ContinuousBatchingScheduler as JaxScheduler,
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from distributed_llama_multiusers_tpu.runtime.spec import NgramDraftIndex as JaxDraftIndex
from distributed_llama_multiusers_tpu.tokenizer import Tokenizer as JaxTokenizer
from distributed_llama_multiusers_tpu_torch.formats import load_model_header
from distributed_llama_multiusers_tpu_torch.models import load_params_from_m_quantized
from distributed_llama_multiusers_tpu_torch.ops import cuda_attn
from distributed_llama_multiusers_tpu_torch.runtime import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
)
from distributed_llama_multiusers_tpu_torch.runtime.engine import warmup_engine
from distributed_llama_multiusers_tpu_torch.runtime.spec import SPEC_DRAFT, NgramDraftIndex
from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer

K = SPEC_DRAFT


@pytest.fixture(scope="module")
def loaded(tiny_model):
    path = tiny_model["model"]
    config, params = load_params_from_m_quantized(path, load_model_header(path),
                                                  dtype=torch.float32, device="cpu")
    return config, params, Tokenizer(tiny_model["tokenizer"])


@pytest.fixture(scope="module")
def jax_loaded(tiny_model):
    path = tiny_model["model"]
    config, params = j_load_params(path, j_load_header(path), dtype=jnp.float32)
    return config, params, JaxTokenizer(tiny_model["tokenizer"])


def _engine(loaded, n_lanes=2, **kw):
    config, params, _ = loaded
    return InferenceEngine(config, params, n_lanes=n_lanes, prefill_buckets=(4,),
                           device="cpu", **kw)


def _jengine(jax_loaded, n_lanes=2):
    config, params, _ = jax_loaded
    return JaxEngine(config, params, n_lanes=n_lanes, prefill_buckets=(4,))


def _rollout(engine, prompt, n):
    """Plain greedy decode of n tokens on lane 0 (the others idle)."""
    _, g, pos = engine.prefill(0, list(prompt))
    toks = [int(g)]
    tokens = np.zeros(engine.n_lanes, np.int64)
    positions = np.full(engine.n_lanes, engine.config.seq_len, np.int64)
    for _ in range(n - 1):
        tokens[0], positions[0] = toks[-1], pos
        _, greedy, _ = engine.decode(tokens, positions)
        toks.append(int(greedy[0]))
        pos += 1
    return toks


# ---------------------------------------------------------------------------
# the draft index
# ---------------------------------------------------------------------------


def _histories():
    rng = np.random.default_rng(0)
    out = [list(rng.integers(0, 6, 40)) for _ in range(4)]  # few symbols: many grams
    out += [[7, 8] * 10, [1, 2, 3] * 7, [5] * 9, [4, 4, 9, 4, 4, 9, 4]]  # short periods
    out += [list(rng.integers(0, 1000, 30)), []]
    return out


@pytest.mark.parametrize("i", range(len(_histories())))
def test_draft_index_drafts_what_jax_drafts(i):
    """The copied index proposes the JAX index's drafts for every next
    token and draft length over seeded histories, built at once and token
    by token, short-period streams included."""
    hist = [int(t) for t in _histories()[i]]
    port, ref = NgramDraftIndex(hist), JaxDraftIndex(hist)
    grown, grown_ref = NgramDraftIndex(), JaxDraftIndex()
    for t in hist:
        grown.append(t)
        grown_ref.append(t)
        for k in (1, K, K + 1):
            assert grown.draft(t, k) == grown_ref.draft(t, k)
    for nt in sorted(set(hist) | {0, 9999}):
        for k in (0, 1, K, K + 1, 8):
            assert port.draft(nt, k) == ref.draft(nt, k)
    if hist in ([7, 8] * 10, [1, 2, 3] * 7):
        assert len(port.draft(hist[-len(set(hist))], K + 1)) == K + 1  # the virtual re-probe


# ---------------------------------------------------------------------------
# the synchronous verify step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["correct", "wrong"])
def test_decode_spec_accepts_and_rejects_like_jax(loaded, jax_loaded, case):
    """Right drafts are all accepted (K + 1 tokens, the plain stream) and
    the cache then decodes on identically; wrong ones yield the plain
    token alone. The pack equals the JAX engine's."""
    prompt = [5, 9, 3]
    ref = _rollout(_engine(loaded), prompt, K + 3)
    packs = []
    for eng in (_engine(loaded), _jengine(jax_loaded)):
        _, g0, pos = eng.prefill(0, prompt)
        assert int(g0) == ref[0]
        tokens = np.asarray([ref[0], 0], np.int32)
        positions = np.asarray([pos, eng.config.seq_len], np.int32)
        drafts = np.zeros((2, K), np.int32)
        drafts[0] = ref[1:1 + K]
        if case == "wrong":
            drafts[0] = (drafts[0] + 1) % eng.config.vocab_size
        dlen = np.asarray([K, 0], np.int32)
        _, emitted, n_emit = eng.decode_spec(tokens, drafts, dlen, positions)
        packs.append((np.asarray(emitted), np.asarray(n_emit)))
        if case == "correct":
            assert int(n_emit[0]) == K + 1
            assert [int(t) for t in emitted[0]] == ref[1:K + 2]
            tokens[0], positions[0] = ref[K + 1], pos + K + 1
            _, greedy, _ = eng.decode(tokens, positions)
            assert int(greedy[0]) == ref[K + 2]
        else:
            assert int(n_emit[0]) == 1 and int(emitted[0, 0]) == ref[1]
    np.testing.assert_array_equal(packs[0][0][0], packs[1][0][0])
    np.testing.assert_array_equal(packs[0][1], packs[1][1])


def test_verify_rows_past_seq_len_leave_the_scratch_slot_zero(loaded):
    """Rows at or past seq_len (a parked lane's four, and a lane two short
    of the end) all land in their lane's scratch slot; they write zeros
    there, so the cache is the same whichever of them a scatter keeps, and
    no slot a query reads changes."""
    eng = _engine(loaded)
    seq_len = eng.config.seq_len
    _, g0, _ = eng.prefill(0, [5, 9, 3])
    before = eng.cache.k[:, :, :seq_len].clone()
    tokens = np.asarray([int(g0), 0], np.int32)
    drafts = np.tile(tokens[:, None], (1, K))
    eng.decode_spec(tokens, drafts, np.asarray([K, 0], np.int32),
                    np.asarray([seq_len - 2, seq_len], np.int32))
    for c in (eng.cache.k, eng.cache.v):
        assert not bool(c[:, :, seq_len].any())
    assert torch.equal(eng.cache.k[:, 1, :seq_len], before[:, 1])
    assert not torch.equal(eng.cache.k[:, 0, seq_len - 2:seq_len], before[:, 0, -2:])


def test_decode_spec_sampled_lane_draws_like_a_plain_step(loaded):
    """A sampled lane (draft_len 0) emits the plain step's seeded draw."""
    eng, ref = _engine(loaded), _engine(loaded)
    out = []
    for e in (eng, ref):
        _, g0, pos = e.prefill(0, [5, 9, 3])
        _, _, s1 = e.prefill_chunk(1, [7, 2], 0, temp=0.8, seed=123)
        out.append((np.asarray([g0, s1]), np.asarray([pos, 2])))
    temps, seeds = np.asarray([0.0, 0.8], np.float32), np.asarray([0, 123])
    (toks, poss), _ = out
    _, emitted, n_emit = eng.decode_spec(toks, np.zeros((2, K), np.int64), [0, 0], poss,
                                         temps, seeds=seeds)
    _, greedy, sampled = ref.decode(toks, poss, temps, seeds=seeds)
    assert list(n_emit) == [1, 1]
    assert [int(emitted[0, 0]), int(emitted[1, 0])] == [int(greedy[0]), int(sampled[1])]
    assert eng.stats.snapshot()["spec_steps"] == 1


def test_decode_spec_validates_and_refuses_a_live_chain(loaded):
    eng = _engine(loaded)
    z = np.zeros(2, np.int64)
    with pytest.raises(ValueError, match="drafts shape"):
        eng.decode_spec(z, np.zeros((2, K + 1), np.int64), z, z)
    eng.decode_pipelined(z, tokens=z)
    with pytest.raises(RuntimeError, match="flush"):
        eng.decode_spec(z, np.zeros((2, K), np.int64), z, z)
    eng.pipeline_flush()


# ---------------------------------------------------------------------------
# the in-chain verify step
# ---------------------------------------------------------------------------


def _chain_identity(eng, ref):
    """The JAX test's chain: a reseed verify step, a chained plain step,
    then a plain step in flight behind which a chained verify step guesses
    the carry. Returns (tokens, packs)."""
    prompt = [5, 9, 3, 5, 9, 3, 5, 9]
    _, g0, pos = eng.prefill(0, prompt)
    assert int(g0) == ref[0]
    seq_len = eng.config.seq_len
    out, packs = [int(g0)], []
    drafts = np.zeros((2, K + 1), np.int32)
    dlen = np.zeros(2, np.int32)
    drafts[0] = [ref[0]] + ref[1:1 + K]
    dlen[0] = K + 1
    eng.decode_spec_pipelined(np.asarray([pos, seq_len], np.int32), drafts, dlen,
                              tokens=np.asarray([g0, 0], np.int32))
    neg = np.asarray([-1, seq_len], np.int32)
    eng.decode_pipelined(neg)
    emitted, n_emit = eng.pipeline_consume()
    packs.append((np.asarray(emitted), np.asarray(n_emit)))
    cnt = int(n_emit[0])
    assert cnt == K + 1
    out.extend(int(t) for t in emitted[0, :cnt])
    g, _ = eng.pipeline_consume()
    out.append(int(g[0]))
    eng.decode_pipelined(neg)
    i = len(out)
    drafts2 = np.zeros((2, K + 1), np.int32)
    drafts2[0] = ref[i:i + K + 1]
    eng.decode_spec_pipelined(neg, drafts2, dlen)
    g, _ = eng.pipeline_consume()
    out.append(int(g[0]))
    emitted, n_emit = eng.pipeline_consume()
    packs.append((np.asarray(emitted), np.asarray(n_emit)))
    cnt = int(n_emit[0])
    assert cnt == K + 1
    out.extend(int(t) for t in emitted[0, :cnt])
    eng.pipeline_flush()
    return out, packs


def test_spec_pipelined_chain_identity_and_jax_packs(loaded, jax_loaded):
    """Verify steps inside the chain (reseed-aligned and one step behind)
    mixed with plain steps emit the plain greedy stream with full
    acceptance; the packs equal the JAX engine's on the same chain."""
    ref = _rollout(_engine(loaded), [5, 9, 3, 5, 9, 3, 5, 9], 16)
    eng = _engine(loaded)
    out, packs = _chain_identity(eng, ref)
    assert out == ref[:len(out)]
    jout, jpacks = _chain_identity(_jengine(jax_loaded), ref)
    assert out == jout
    for (e, n), (je, jn) in zip(packs, jpacks):
        np.testing.assert_array_equal(e[0], je[0])
        np.testing.assert_array_equal(n, jn)
    snap = eng.stats.snapshot()
    assert snap["spec_steps"] == 2 and snap["spec_pipelined_steps"] == 2
    assert snap["pipeline_dispatches"] == 4 and snap["pipeline_flushes"] == 0


def test_spec_pipelined_wrong_carry_candidate_is_safe(loaded):
    """A wrong candidate 0 with right continuations: nothing is accepted
    and the plain token comes out."""
    ref = _rollout(_engine(loaded), [5, 9, 3, 5, 9, 3, 5, 9], 4)
    eng = _engine(loaded)
    _, g0, pos = eng.prefill(0, [5, 9, 3, 5, 9, 3, 5, 9])
    drafts = np.zeros((2, K + 1), np.int64)
    drafts[0] = [(ref[0] + 1) % eng.config.vocab_size] + ref[1:1 + K]
    eng.decode_spec_pipelined(np.asarray([pos, eng.config.seq_len]), drafts, [K + 1, 0],
                              tokens=np.asarray([g0, 0]))
    emitted, n_emit = eng.pipeline_consume()
    eng.pipeline_flush()
    assert int(n_emit[0]) == 1 and int(emitted[0, 0]) == ref[1]


@pytest.mark.parametrize("left", [1, 2, 3])
def test_spec_pipelined_clamps_on_device_near_seq_len(loaded, jax_loaded, left):
    """A lane ``left`` slots short of seq_len accepts at most left - 1
    candidates, whatever matched, and the carry stops at seq_len; the pack
    equals the JAX engine's."""
    packs = []
    for eng in (_engine(loaded), _jengine(jax_loaded)):
        seq_len = eng.config.seq_len
        _, g0, _ = eng.prefill(0, [5, 9, 3])
        drafts = np.full((2, K + 1), int(g0), np.int32)
        eng.decode_spec_pipelined(np.asarray([seq_len - left, seq_len], np.int32), drafts,
                                  np.asarray([K + 1, 0], np.int32),
                                  tokens=np.asarray([g0, 0], np.int32))
        emitted, n_emit = eng.pipeline_consume()
        eng.pipeline_flush()
        assert 1 <= int(n_emit[0]) <= left
        packs.append((np.asarray(emitted)[0], int(n_emit[0])))
    assert packs[0][1] == packs[1][1]
    np.testing.assert_array_equal(packs[0][0][:packs[0][1]], packs[1][0][:packs[1][1]])


def test_spec_drafts_shape_validated(loaded):
    eng = _engine(loaded)
    z = np.zeros(2, np.int64)
    bad = np.zeros((2, K), np.int64)  # K, not K + 1
    with pytest.raises(ValueError, match="drafts shape"):
        eng.decode_spec_pipelined(z, bad, z, tokens=z)
    with pytest.raises(ValueError, match="drafts shape"):
        eng.decode_spec_prefill_fused(z, bad, z, chunk=[1, 2], tokens=z)
    assert not eng.pipeline_active


def test_spec_prefill_fused_pack(loaded, jax_loaded):
    """The chunk and a verify step in one dispatch: the pack is [n + 1,
    K + 2] with the boundary pair in the extra row, equal to the JAX
    engine's; the admitted lane then continues from the device carry."""
    prompt = [5, 9, 3, 7]
    ref = _rollout(_engine(loaded), prompt, 4)
    packs = []
    for eng in (_engine(loaded), _jengine(jax_loaded)):
        seq_len = eng.config.seq_len
        drafts = np.zeros((2, K + 1), np.int32)
        dlen = np.zeros(2, np.int32)
        eng.decode_spec_prefill_fused(np.full(2, seq_len, np.int32), drafts, dlen, p_lane=1,
                                      chunk=prompt, p_start=0, tokens=np.zeros(2, np.int32))
        emitted, n_emit = eng.pipeline_consume()
        assert emitted.shape == (3, K + 1) and n_emit.shape == (3,)
        assert int(emitted[-1, 0]) == ref[0]
        packs.append(np.asarray(emitted)[-1, :2])
        eng.decode_pipelined(np.asarray([seq_len, -1], np.int32))
        g, _ = eng.pipeline_consume()
        eng.pipeline_flush()
        assert int(g[1]) == ref[1]
    np.testing.assert_array_equal(packs[0], packs[1])


def test_warmup_runs_the_verify_families(loaded):
    """warmup_engine drives the synchronous, in-chain and fused verify
    steps (the card captures the verify graphs) and leaves no trace."""
    eng = _engine(loaded, n_lanes=2)
    seen = []
    for name in ("decode_spec", "decode_spec_pipelined", "decode_spec_prefill_fused"):
        fn = getattr(eng, name)
        setattr(eng, name, lambda *a, _fn=fn, _n=name, **k: (seen.append(_n), _fn(*a, **k))[1])
    warmup_engine(eng, spec=True)
    assert seen == ["decode_spec"] + ["decode_spec_pipelined"] * 2 \
        + ["decode_spec_prefill_fused"] * 2
    assert not eng.pipeline_active and eng.stats.snapshot()["spec_steps"] == 0
    seen.clear()
    warmup_engine(eng, spec=False)
    assert seen == []


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


def _serve(sched, reqs, timeout=300):
    sched.start()
    try:
        for r in reqs:
            sched.submit(r)
        for r in reqs:
            r.future.result(timeout=timeout)
    finally:
        sched.stop()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return [list(r.generated_tokens) for r in reqs]


def _mixed(cls):
    return [cls(prompt="hello world hello world hello", max_tokens=12, temperature=0.0),
            cls(prompt="aa bb aa bb aa", max_tokens=10, temperature=0.0),
            cls(prompt="sampled one", max_tokens=8, temperature=0.8, seed=123)]


@pytest.mark.parametrize("loop", ["defaults", "sync"])
def test_scheduler_spec_streams_equal_jax_and_no_spec(loaded, jax_loaded, loop):
    """Greedy and seeded streams with speculation on equal the JAX
    scheduler's (speculative=True) and the port's with it off; under the
    defaults the verify steps ride the chain with no flush."""
    kw = {} if loop == "defaults" else {"multi_step": 0}
    depth = None if loop == "defaults" else 0
    eng = _engine(loaded, n_lanes=4, pipeline_depth=depth)
    got = _serve(ContinuousBatchingScheduler(eng, loaded[2], **kw), _mixed(Request))
    stats = eng.stats.snapshot()
    assert stats["spec_steps"] > 0 and stats["spec_lane_steps"] > 0
    assert stats["spec_emitted"] > stats["spec_lane_steps"]  # drafts were accepted
    if loop == "defaults":
        assert stats["spec_pipelined_steps"] > 0 and stats["pipeline_flushes"] == 0
        assert sum(stats["spec_accept_hist"].values()) > 0
    else:
        assert stats["pipeline_dispatches"] == 0 and stats["spec_pipelined_steps"] == 0
    plain = _engine(loaded, n_lanes=4, pipeline_depth=depth)
    want = _serve(ContinuousBatchingScheduler(plain, loaded[2], speculative=False, **kw),
                  _mixed(Request))
    assert plain.stats.snapshot()["spec_steps"] == 0
    assert got == want
    jeng = _jengine(jax_loaded, n_lanes=4)
    jgot = _serve(JaxScheduler(jeng, jax_loaded[2], speculative=True, prefix_min_tokens=0,
                               pipelined=loop == "defaults", **kw), _mixed(JaxRequest))
    assert got == jgot


def test_scheduler_spec_near_seq_len(loaded, jax_loaded):
    """A drafting lane that runs to seq_len finishes cleanly at the length
    cap with the JAX scheduler's stream."""
    seq_len = loaded[0].seq_len
    eng = _engine(loaded, n_lanes=2)
    got = _serve(ContinuousBatchingScheduler(eng, loaded[2]),
                 [Request(prompt="aa bb aa bb", max_tokens=seq_len, temperature=0.0)])
    jgot = _serve(JaxScheduler(_jengine(jax_loaded), jax_loaded[2], prefix_min_tokens=0),
                  [JaxRequest(prompt="aa bb aa bb", max_tokens=seq_len, temperature=0.0)])
    assert got == jgot and 1 <= len(got[0])
    assert eng.stats.snapshot()["spec_steps"] > 0


def test_scheduler_spec_gates_per_lane(loaded):
    """On the synchronous verify step a lane near seq_len drafts only the
    slots it has left, and the other lane keeps drafting meanwhile; the
    streams equal the no-spec ones."""
    config, _, tok = loaded
    long_prompt = "a" * (config.seq_len - 3)
    assert config.seq_len - K <= len(tok.encode(long_prompt)) <= config.seq_len - 2

    def reqs():
        return [Request(prompt=long_prompt, max_tokens=8, temperature=0.0),
                Request(prompt="aa bb aa bb aa bb aa bb aa", max_tokens=50, temperature=0.0)]

    eng = _engine(loaded, pipeline_depth=0)
    calls = []
    real = eng.decode_spec

    def spy(tokens, drafts, draft_len, positions, *a, **kw):
        calls.append((np.array(positions), np.array(draft_len)))
        return real(tokens, drafts, draft_len, positions, *a, **kw)

    eng.decode_spec = spy
    got = _serve(ContinuousBatchingScheduler(eng, tok, multi_step=0), reqs())
    near_end = [(p, d) for p, d in calls if p[0] >= config.seq_len - K]
    assert near_end, "no verify step ran while lane 0 was near seq_len"
    for pos, dlen in calls:
        for lane in range(2):
            assert dlen[lane] <= max(0, config.seq_len - pos[lane] - 1)
    assert any(d[1] > 0 for _, d in near_end)
    want = _serve(ContinuousBatchingScheduler(_engine(loaded, pipeline_depth=0), tok,
                                              multi_step=0, speculative=False), reqs())
    assert got == want


def test_scheduler_spec_stop_string_mid_chain(loaded):
    """A stop string met while verify steps ride the chain ends the stream
    where the plain loop ends it; the rest of its window is discarded."""
    _, _, tok = loaded
    prompt = "hello world hello world hello"
    probe = [Request(prompt=prompt, max_tokens=24, temperature=0.0)]
    _serve(ContinuousBatchingScheduler(_engine(loaded), tok, speculative=False), probe)
    dec = tok.make_stream_decoder()
    pieces = [dec.decode(t) or "" for t in probe[0].generated_tokens]
    # two pieces past the first verify steps that the text before lacks
    stop = next((pieces[i] + pieces[i + 1] for i in range(10, len(pieces) - 4)
                 if pieces[i].strip() and pieces[i + 1].strip()
                 and pieces[i] + pieces[i + 1] not in "".join(pieces[:i + 1])), None)
    assert stop is not None, pieces

    def reqs():
        return [Request(prompt=prompt, max_tokens=24, temperature=0.0, stop=[stop])]

    eng = _engine(loaded)
    got_reqs = reqs()
    got = _serve(ContinuousBatchingScheduler(eng, tok), got_reqs)
    want = _serve(ContinuousBatchingScheduler(_engine(loaded, pipeline_depth=0), tok,
                                              multi_step=0, speculative=False), reqs())
    assert got == want and got_reqs[0].finish_reason == "stop" and len(got[0]) < 24
    assert eng.stats.snapshot()["spec_pipelined_steps"] > 0


def test_scheduler_spec_cancel_mid_draft(loaded):
    """A cancel while verify steps are in flight: the lane ends cancelled
    with a prefix of its plain stream, the other lane is untouched, and a
    lane step with nothing consumed is not counted."""
    _, _, tok = loaded

    def reqs():
        return [Request(prompt="aa bb aa bb aa", max_tokens=40, temperature=0.0),
                Request(prompt="hello world hello world", max_tokens=16, temperature=0.0)]

    base = _serve(ContinuousBatchingScheduler(_engine(loaded), tok, speculative=False), reqs())
    victim, other = reqs()
    deltas = []

    def on_delta(piece):
        deltas.append(piece)
        if len(deltas) == 3:
            victim.cancel()

    victim.on_delta = on_delta
    eng = _engine(loaded)
    got = _serve(ContinuousBatchingScheduler(eng, tok), [victim, other])
    assert victim.finish_reason == "cancelled"
    assert len(got[0]) < 40 and got[0] == base[0][:len(got[0])]
    assert got[1] == base[1]
    stats = eng.stats.snapshot()
    assert stats["spec_lane_steps"] > 0 and stats["spec_emitted"] >= stats["spec_lane_steps"]


def test_scheduler_spec_off_never_verifies(loaded):
    """speculative=False: no verify step on any loop, and no draft probe
    ever flushes the chain."""
    _, _, tok = loaded
    eng = _engine(loaded)
    sched = ContinuousBatchingScheduler(eng, tok, speculative=False)
    assert not sched._spec_pl_ok() and sched._spec_k() == 0
    _serve(sched, _mixed(Request)[:2])
    stats = eng.stats.snapshot()
    assert stats["spec_steps"] == 0 and stats["pipeline_flushes"] == 0


# ---------------------------------------------------------------------------
# the verify window's attention
# ---------------------------------------------------------------------------


def _window_inputs(seed, lanes, t, n_kv, group, hd, slots):
    rng = np.random.default_rng(seed)
    qf = rng.standard_normal((lanes, t, n_kv, group, hd)).astype(np.float32)
    k = rng.standard_normal((lanes, slots + 1, n_kv, hd)).astype(np.float32)
    v = rng.standard_normal((lanes, slots + 1, n_kv, hd)).astype(np.float32)
    return qf, k, v


L = cuda_attn.SPLIT


@pytest.mark.parametrize("t,lanes,n_kv,group,hd,s_len,starts", [
    (4, 8, 8, 4, 64, 2048, [40, 63, 64, 100, 2045, 2048, 0, 1000]),  # the 1B verify step
    (4, 4, 2, 2, 16, 3 * L + 44, [L - 2, 2 * L - 1, 3 * L + 41, 5]),  # rows across splits
    (2, 3, 1, 7, 32, L, [L - 2, 0, 10**6]),
    (3, 2, 2, 8, 128, 2 * L, [2 * L - 1, L - 1])])
def test_window_plain_matches_jax_and_one_row_calls(t, lanes, n_kv, group, hd, s_len, starts):
    """T rows per lane at consecutive positions (some past s_len - 1, which
    read at most s_len - 1): the wrapper's plain version against the JAX
    dense attention under the same window mask, max|d| <= 1e-5 max|y|, and
    each row against a T = 1 call at that row's position, within 1e-6 of
    max|y| (the plain einsums may order their sums by shape; the kernel's
    rows are held bit-equal on the card, tests/test_torch_gpu.py)."""
    qf, k, v = _window_inputs(t + lanes, lanes, t, n_kv, group, hd, s_len)
    pos = np.asarray(starts, np.int64)[:, None] + np.arange(t)[None, :]
    scale = 1.0 / hd ** 0.5
    cuda_attn.reset_counts()
    got = cuda_attn.decode_attention(torch.from_numpy(qf), torch.from_numpy(k),
                                     torch.from_numpy(v), torch.from_numpy(pos), scale, s_len)
    assert cuda_attn.COUNTS == {"launches": 0, "window_launches": 0, "plain_calls": 1}
    mask = np.arange(s_len)[None, None, :] <= pos[:, :, None]
    want = np.asarray(jax_attention(jnp.asarray(qf), jnp.asarray(k[:, :s_len]),
                                    jnp.asarray(v[:, :s_len]), jnp.asarray(mask), scale))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    for row in range(t):
        one = cuda_attn.decode_attention(torch.from_numpy(qf[:, row:row + 1].copy()),
                                         torch.from_numpy(k), torch.from_numpy(v),
                                         torch.from_numpy(pos[:, row:row + 1].copy()), scale,
                                         s_len)
        np.testing.assert_allclose(got[:, row].numpy(), one[:, 0].numpy(), rtol=0,
                                   atol=1e-6 * float(one.abs().max()))


def test_window_validates_rows():
    qf, k, v = (torch.from_numpy(a) for a in _window_inputs(0, 2, cuda_attn.WINDOW + 1, 2, 2,
                                                              16, 8))
    pos = torch.zeros((2, cuda_attn.WINDOW + 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="qf"):
        cuda_attn.decode_attention(qf, k, v, pos, 1.0, 8)
    with pytest.raises(ValueError, match="positions"):
        cuda_attn.decode_attention(qf[:, :2], k, v, pos[:, :3], 1.0, 8)
    assert cuda_attn.WINDOW == SPEC_DRAFT + 1


def test_verify_forward_uses_the_window(loaded):
    """The verify step's forward attends through decode_attention (one
    call a layer), a prompt chunk through the dense attention."""
    eng = _engine(loaded)
    _, g0, pos = eng.prefill(0, [5, 9, 3])
    cuda_attn.reset_counts()
    eng.decode_spec(np.asarray([g0, 0]), np.zeros((2, K), np.int64), [0, 0],
                    np.asarray([pos, eng.config.seq_len]))
    assert cuda_attn.COUNTS["plain_calls"] == eng.config.n_layers
    cuda_attn.reset_counts()
    eng.prefill_chunk(1, [1, 2, 3, 4], 0)
    assert cuda_attn.COUNTS["plain_calls"] == 0


def test_scheduler_without_the_in_chain_family_flushes_to_the_sync_verify(loaded):
    """An engine with the verify step but not its in-chain family: a draft
    hit leaves the chain (a counted flush) for the synchronous verify step,
    and the streams still equal the no-spec ones."""
    _, _, tok = loaded
    eng = _engine(loaded, n_lanes=4)
    eng.supports_spec_pipelined = False
    sched = ContinuousBatchingScheduler(eng, tok)
    assert not sched._spec_pl_ok() and sched._spec_k() == K
    got = _serve(sched, _mixed(Request))
    stats = eng.stats.snapshot()
    assert stats["spec_steps"] > 0 and stats["spec_pipelined_steps"] == 0
    assert stats["pipeline_flushes"] > 0 and stats["pipeline_dispatches"] > 0
    want = _serve(ContinuousBatchingScheduler(_engine(loaded, n_lanes=4), tok,
                                              speculative=False), _mixed(Request))
    assert got == want
