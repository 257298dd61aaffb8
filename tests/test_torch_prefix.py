"""The port's per-lane prefix cache (``engine.copy_lane`` and the
scheduler's resident-prefix scan) against cold prefill and against the
JAX package, on the tiny model (CPU).

Mirrors the JAX package's ``tests/test_prefix_cache.py`` (:46, :80, :134,
:907): ``copy_lane`` followed by a tail prefill gives the cold prefill's
logits (within the 1e-4 x max|logit| the port's model tests hold against
the JAX package; bit for bit where both runs take the same chunk shapes)
and the same greedy token, under one rank and under tp=2 (one copy per K
and V plane of each rank, into the same cache tensors); a scheduler
prefix hit skips the shared prefill and keeps the stream, which equals
the JAX scheduler's for the same requests, with ``prefix_hits`` equal
across packages; ``--prefix-min-tokens 0`` hits nothing; a finished
lane's prefix survives other lanes' decode steps.

One difference is by design: the port reuses whole prompt chunks (its
``prefix_tokens_saved`` per hit is the JAX scheduler's rounded down to a
multiple of the largest prefill bucket), so that the tail runs a cold
prefill's chunks and its bits are the cold ones on the card too, where a
chunk's shape picks its products' plans (``_start_request``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_multiusers_tpu.formats import load_model_header as j_load_header
from distributed_llama_multiusers_tpu.models import load_params_from_m as j_load_params
from distributed_llama_multiusers_tpu.runtime import (
    ContinuousBatchingScheduler as JaxScheduler,
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from distributed_llama_multiusers_tpu.tokenizer import Tokenizer as JaxTokenizer
from distributed_llama_multiusers_tpu_torch.formats import load_model_header
from distributed_llama_multiusers_tpu_torch.models import (
    load_params_from_m,
    load_params_from_m_quantized,
)
from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
from distributed_llama_multiusers_tpu_torch.parallel.sharding import shard_params
from distributed_llama_multiusers_tpu_torch.runtime import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
)
from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer

BUCKETS = (8,)
LOGIT_TOL = 1e-4  # x max|logit|, the port's model tolerance against the JAX package
SYSTEM = "aa bb cc dd ee ff gg hh "  # a long shared prefix (27 tokens with a tail)


@pytest.fixture(scope="module")
def loaded(tiny_model):
    path = tiny_model["model"]
    config, params = load_params_from_m_quantized(path, load_model_header(path),
                                                  dtype=torch.float32, device="cpu")
    return config, params, Tokenizer(tiny_model["tokenizer"])


@pytest.fixture(scope="module")
def jax_loaded(tiny_model):
    path = tiny_model["model"]
    jconfig, jparams = j_load_params(path, j_load_header(path), dtype=jnp.float32)
    return jconfig, jparams, JaxTokenizer(tiny_model["tokenizer"])


def _engine(config, params, n_lanes=2, **kw):
    return InferenceEngine(config, params, n_lanes=n_lanes, prefill_buckets=BUCKETS,
                           device="cpu", **kw)


FULL = [5, 9, 3, 17, 2, 11, 7, 4, 13, 6, 21, 8, 30, 1]


@pytest.mark.parametrize("split", [8, 5, 13])
def test_copy_lane_then_tail_prefill_matches_cold_prefill(loaded, jax_loaded, split):
    config, params, _ = loaded
    cold = _engine(config, params)
    logits_cold, greedy_cold, _ = cold.prefill(1, FULL)

    warm = _engine(config, params)
    warm.prefill(0, FULL[:split])  # the prefix resident in lane 0
    k_before = warm.cache.k.data_ptr()
    warm.copy_lane(0, 1, prefix_len=split)
    assert warm.cache.k.data_ptr() == k_before  # in place: the planes stay
    assert torch.equal(warm.cache.k[:, 1, :split], warm.cache.k[:, 0, :split])
    logits_warm, greedy_warm, _ = warm.prefill(1, FULL[split:], start_pos=split)

    assert int(greedy_warm) == int(greedy_cold)
    a, b = logits_warm.numpy(), logits_cold.numpy()
    assert np.max(np.abs(a - b)) <= LOGIT_TOL * np.max(np.abs(b))
    if split % BUCKETS[0] == 0:  # the same chunks as the cold prefill: same bits
        np.testing.assert_array_equal(a, b)

    jconfig, jparams, _ = jax_loaded
    jengine = JaxEngine(jconfig, jparams, n_lanes=2, prefill_buckets=BUCKETS)
    jengine.prefill(0, FULL[:split])
    jengine.copy_lane(0, 1)
    jlogits, jgreedy, _ = jengine.prefill(1, FULL[split:], start_pos=split)
    assert int(jgreedy) == int(greedy_warm)
    j = np.asarray(jlogits)
    assert np.max(np.abs(a - j)) <= LOGIT_TOL * np.max(np.abs(j))


def test_copy_lane_edges(loaded):
    config, params, _ = loaded
    engine = _engine(config, params, n_lanes=3)
    engine.prefill(0, FULL)
    before = engine.cache.k.clone()
    engine.copy_lane(0, 0, prefix_len=8)  # onto itself: nothing moves
    engine.copy_lane(0, 2, prefix_len=0)
    assert torch.equal(engine.cache.k, before)
    engine.copy_lane(0, 2)  # None: every slot
    assert torch.equal(engine.cache.v[:, 2], engine.cache.v[:, 0])
    with pytest.raises(ValueError):
        engine.copy_lane(0, 3, prefix_len=4)


def test_copy_lane_on_a_tp2_mesh(tiny_model):
    """Under tensor parallelism each rank's K and V planes copy in place,
    and the tail prefill gives the cold prefill's logits and token."""
    path = tiny_model["model"]
    config, dense = load_params_from_m(path, load_model_header(path), dtype=torch.float32,
                                       device="cpu")
    mesh = make_mesh(MeshPlan(tp=2), ["cpu", "cpu"])
    sharded = shard_params(dense, mesh)

    def engine():
        return InferenceEngine(config, sharded, n_lanes=2, prefill_buckets=BUCKETS, mesh=mesh)

    cold = engine()
    logits_cold, greedy_cold, _ = cold.prefill(1, FULL)
    warm = engine()
    warm.prefill(0, FULL[:8])
    ptrs = [(c.k.data_ptr(), c.v.data_ptr()) for c in warm.cache]
    warm.copy_lane(0, 1, prefix_len=8)
    assert [(c.k.data_ptr(), c.v.data_ptr()) for c in warm.cache] == ptrs
    for c in warm.cache:
        assert torch.equal(c.k[:, 1, :8], c.k[:, 0, :8])
        assert torch.equal(c.v[:, 1, :8], c.v[:, 0, :8])
    logits_warm, greedy_warm, _ = warm.prefill(1, FULL[8:], start_pos=8)
    assert int(greedy_warm) == int(greedy_cold)
    np.testing.assert_array_equal(logits_warm.numpy(), logits_cold.numpy())


def _sequential(sched, make_reqs):
    """Serve requests one after another (each admitted after the previous
    finished: its lane's KV is resident). Returns the token streams and
    each request's prompt tokens taken from a resident lane."""
    sched.start()
    out, saved = [], []
    try:
        for r in make_reqs():
            sched.submit(r)
            r.future.result(timeout=300)
            assert r.error is None, r.error
            out.append(list(r.generated_tokens))
            saved.append(r.summary["prefix_tokens_saved"])
    finally:
        sched.stop()
    return out, saved


PROMPTS = ["zz unrelated", SYSTEM + "11", SYSTEM + "22", SYSTEM + "11 and more"]


@pytest.mark.parametrize("pipelined", [False, True])
def test_scheduler_prefix_hit_equals_jax(loaded, jax_loaded, pipelined):
    """Sequential requests sharing a long system prefix: later admissions
    copy a resident lane's KV and prefill only their tail (no chunk of the
    two hits starts at position 0); the streams equal a
    prefix-disabled scheduler's and the JAX scheduler's; the hits are the
    JAX scheduler's, each saving its tokens rounded down to whole chunks."""
    config, params, tok = loaded
    jconfig, jparams, jtok = jax_loaded

    def reqs(cls):
        return lambda: [cls(prompt=p, max_tokens=8, temperature=0.0) for p in PROMPTS]

    engine = _engine(config, params, pipeline_depth=None if pipelined else 0)
    chunks = []
    real = engine.prefill_chunk

    def spy(lane, chunk, start_pos, **kw):
        chunks.append((lane, len(chunk), start_pos))
        return real(lane, chunk, start_pos, **kw)

    engine.prefill_chunk = spy
    got, saved = _sequential(ContinuousBatchingScheduler(engine, tok, speculative=False),
                             reqs(Request))
    stats = engine.stats.snapshot()

    plain_engine = _engine(config, params)
    plain, _ = _sequential(ContinuousBatchingScheduler(plain_engine, tok, speculative=False,
                                                       prefix_min_tokens=0), reqs(Request))
    assert got == plain
    assert plain_engine.stats.snapshot()["prefix_hits"] == 0
    assert stats["prefill_tokens"] < plain_engine.stats.snapshot()["prefill_tokens"]

    jengine = JaxEngine(jconfig, jparams, n_lanes=2, prefill_buckets=BUCKETS)
    want, jsaved = _sequential(JaxScheduler(jengine, jtok, speculative=False, pipelined=False,
                                            fused_prefill=False, multi_step=1),
                               reqs(JaxRequest))
    assert got == want
    assert stats["prefix_hits"] == jengine.stats.prefix_hits == 2
    assert saved == [n - n % BUCKETS[0] for n in jsaved] and sum(saved) > 0
    assert stats["prefix_tokens_saved"] == sum(saved)
    first = sum(-(-len(tok.encode(p)) // BUCKETS[0]) for p in PROMPTS[:2])
    if not pipelined:  # the synchronous loop prefills through prefill_chunk
        assert len(chunks) > first and all(c[2] > 0 for c in chunks[first:]), chunks


def test_prefix_reuse_survives_other_lanes_decode_steps(loaded):
    """A finishes, B keeps decoding (every step writes each lane's KV: an
    idle lane's lands in the scratch slot), then C reuses A's prefix; C's
    stream equals a cold run's."""
    config, params, tok = loaded

    def run(**kw):
        engine = _engine(config, params)
        sched = ContinuousBatchingScheduler(engine, tok, speculative=False, **kw)
        sched.start()
        try:
            a = sched.submit(Request(prompt=SYSTEM + "11", max_tokens=2))
            b = sched.submit(Request(prompt=SYSTEM + "22", max_tokens=30))
            a.future.result(timeout=300)
            c = sched.submit(Request(prompt=SYSTEM + "11", max_tokens=8))
            c.future.result(timeout=300)
            b.future.result(timeout=300)
            assert all(r.error is None for r in (a, b, c))
            return list(c.generated_tokens), engine.stats.snapshot()["prefix_hits"]
        finally:
            sched.stop()

    got, hits = run()
    assert hits >= 1
    cold, cold_hits = run(prefix_min_tokens=0)
    assert got == cold and cold_hits == 0


def test_reuse_is_whole_prompt_chunks(loaded):
    """A lane's reusable KV is its prompt's (the chunks that wrote it), not
    its generated tokens', and a hit starts at a multiple of the largest
    prefill bucket."""
    config, params, tok = loaded
    engine = _engine(config, params)
    sched = ContinuousBatchingScheduler(engine, tok, speculative=False, prefix_min_tokens=8)
    first = Request(prompt=SYSTEM + "11", max_tokens=8)
    longer = Request(prompt=SYSTEM + "11 and a longer tail", max_tokens=4)
    sched.start()
    try:
        sched.submit(first)
        first.future.result(timeout=300)
        assert sched._lane_kv[0] == tok.encode(SYSTEM + "11")  # no generated token
        sched.submit(longer)
        longer.future.result(timeout=300)
    finally:
        sched.stop()
    lcp = len(tok.encode(SYSTEM + "11"))  # 27: the whole first prompt
    assert longer.summary["prefix_tokens_saved"] == lcp - lcp % BUCKETS[0] == 24
    assert engine.stats.snapshot()["prefix_hits"] == 1
