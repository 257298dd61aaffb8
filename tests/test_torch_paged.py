"""The port's paged KV layout (``--paged-kv on``) on the tiny model (CPU),
against its contiguous layout and against the JAX package's paged engine.

- Forward: the paged ``llama_forward`` equals the contiguous one bit for
  bit (prompt chunks through the gathered view, decode and verify rows
  through the attention kernel's plain version) and the JAX paged forward
  within the 1e-4 x max|logit| the port's model tests hold, with the same
  page table.
- Page bytes: ``export_kv_page`` from the port imports into the JAX engine
  and the other way round, byte for byte, and both then compute the same
  next-step logits within that tolerance.
- Scheduler: paged streams equal contiguous ones under churn (greedy and
  seeded, on every serving path) and the JAX paged scheduler's greedy
  streams; a hit shares the JAX hit's tokens rounded down to whole prompt
  chunks (the port's share quantum, ROADMAP C3); an exhausted pool sheds a
  typed 429; finished sessions park beyond the lane count; a dropped
  parked session rebuilds from the journal with the same bytes, as does
  one swapped to the host tier; the leak witness counts lane pages; the
  pool's gauges reach ``/stats``, ``/load`` and ``/metrics``.
- Refusals and flags: ``copy_lane`` on a paged engine, ``--paged-kv`` on a
  dp or sp mesh, the flags' JAX defaults.
"""

import argparse
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_multiusers_tpu.app.args import build_parser as j_build_parser
from distributed_llama_multiusers_tpu.formats import load_model_header as j_load_header
from distributed_llama_multiusers_tpu.models import load_params_from_m as j_load_params
from distributed_llama_multiusers_tpu.models.llama import (
    init_paged_kv_cache as j_init_paged,
    llama_forward as j_forward,
)
from distributed_llama_multiusers_tpu.runtime import (
    ContinuousBatchingScheduler as JaxScheduler,
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from distributed_llama_multiusers_tpu.tokenizer import Tokenizer as JaxTokenizer
from distributed_llama_multiusers_tpu_torch.analysis import leakcheck
from distributed_llama_multiusers_tpu_torch.app.args import build_parser
from distributed_llama_multiusers_tpu_torch.app.runtime_setup import paged_kwargs
from distributed_llama_multiusers_tpu_torch.formats import load_model_header
from distributed_llama_multiusers_tpu_torch.models import (
    load_params_from_m,
    load_params_from_m_quantized,
)
from distributed_llama_multiusers_tpu_torch.models.llama import (
    PagedKVCache,
    init_kv_cache,
    init_paged_kv_cache,
    llama_forward,
)
from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
from distributed_llama_multiusers_tpu_torch.parallel.mesh import Mesh
from distributed_llama_multiusers_tpu_torch.parallel.sharding import shard_params
from distributed_llama_multiusers_tpu_torch.runtime import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
)
from distributed_llama_multiusers_tpu_torch.server import ApiServer
from distributed_llama_multiusers_tpu_torch.serving import (
    AdmissionRejected,
    RequestJournal,
    read_journal,
)
from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer

BUCKETS = (8,)
LOGIT_TOL = 1e-4  # x max|logit|, the port's model tolerance against the JAX package
SYSTEM = "aa bb cc dd ee ff gg hh "  # a long shared prefix (27 tokens with a tail)
FULL = [5, 9, 3, 17, 2, 11, 7, 4, 13, 6, 21, 8, 30, 1]


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


def _engine(config, params, n_lanes=2, paged=True, page=4, **kw):
    if paged:
        kw = dict(paged_kv=True, kv_page_size=page, **kw)
    return InferenceEngine(config, params, n_lanes=n_lanes, prefill_buckets=BUCKETS,
                           device="cpu", **kw)


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert np.max(np.abs(a - b)) <= LOGIT_TOL * np.max(np.abs(b))


# -- the forward ---------------------------------------------------------------


def _random_table(n_lanes, n_blocks, n_pages, seed):
    perm = np.random.default_rng(seed).permutation(n_pages)[:n_lanes * n_blocks]
    return perm.reshape(n_lanes, n_blocks).astype(np.int32)


@pytest.mark.parametrize("page", [4, 16, 64])
def test_paged_forward_equals_contiguous_and_jax(loaded, jax_loaded, page):
    """Two lanes over pages permuted at random: a prompt chunk of 8 rows,
    a verify window of 4 and a decode step. Every output and every
    written slot equals the contiguous forward's bit for bit, and the
    logits equal the JAX paged forward's with the same table within
    LOGIT_TOL."""
    config, params, _ = loaded
    jconfig, jparams, _ = jax_loaded
    b, n_blocks = 2, config.seq_len // page
    n_pages = b * n_blocks + 3
    table = _random_table(b, n_blocks, n_pages, seed=page)
    paged = init_paged_kv_cache(config, b, n_pages, page, dtype=torch.float32, device="cpu")
    paged.table.copy_(torch.from_numpy(table))
    contiguous = init_kv_cache(config, b, dtype=torch.float32, device="cpu")
    jcache = j_init_paged(jconfig, b, n_pages, page, dtype=jnp.float32)._replace(
        table=jnp.asarray(table))
    rng = np.random.default_rng(page)
    steps = [(rng.integers(1, 100, size=(b, 8)), np.tile(np.arange(8), (b, 1))),
             (rng.integers(1, 100, size=(b, 4)), np.array([[8, 9, 10, 11], [8, 9, 10, 11]])),
             (rng.integers(1, 100, size=(b, 1)), np.array([[12], [9]]))]
    for tokens, positions in steps:
        tt, pp = torch.from_numpy(tokens), torch.from_numpy(positions)
        got, _ = llama_forward(config, params, tt, pp, paged)
        want, _ = llama_forward(config, params, tt, pp, contiguous)
        assert torch.equal(got, want)
        jlogits, jcache = j_forward(jconfig, jparams, jnp.asarray(tokens, jnp.int32),
                                    jnp.asarray(positions, jnp.int32), jcache)
        _close(got.numpy(), jlogits)
    # the pool holds the contiguous cache's slots at the table's pages
    for lane in range(b):
        view = paged.k[:, table[lane]].reshape(config.n_layers, -1, config.n_kv_heads,
                                               config.head_size)
        assert torch.equal(view[:, :12], contiguous.k[:, lane, :12])


def test_paged_writes_at_or_past_seq_len_and_unmapped_land_in_the_scratch_page(loaded):
    """Positions at or past seq_len and blocks the table leaves unmapped
    write the scratch page (index n_pages); several rows of a lane write
    zeros there, as the contiguous layout's scratch slot takes them."""
    config, params, _ = loaded
    page, n_pages = 16, 6
    cache = init_paged_kv_cache(config, 2, n_pages, page, dtype=torch.float32, device="cpu")
    assert int(cache.table.max()) == n_pages and cache.k.shape[1] == n_pages + 1
    cache.table[0, 0] = 2  # lane 0 maps block 0 only
    tokens = torch.tensor([[3, 4, 5, 6], [7, 8, 9, 10]])
    positions = torch.tensor([[14, 15, 16, 17], [64, 65, 66, 67]])
    llama_forward(config, params, tokens, positions, cache)
    assert bool(cache.k[:, 2, 14:16].abs().sum() > 0)  # the mapped rows
    assert not bool(cache.k[:, n_pages].abs().sum())  # the rest: zeros
    llama_forward(config, params, torch.tensor([[3], [4]]), torch.tensor([[20], [64]]), cache)
    assert bool(cache.k[:, n_pages].abs().sum() > 0)  # one row a lane: the row itself
    others = torch.ones(n_pages + 1, dtype=torch.bool)
    others[[2, n_pages]] = False
    assert not bool(cache.k[:, others].abs().sum())


def test_paged_tp2_engine_equals_one_rank(tiny_model):
    """At tp=2 each rank holds half the pool's kv heads and one table
    serves both; prefill and decode equal the one-rank paged engine."""
    path = tiny_model["model"]
    config, dense = load_params_from_m(path, load_model_header(path), dtype=torch.float32,
                                       device="cpu")
    mesh = make_mesh(MeshPlan(tp=2), ["cpu", "cpu"])
    tp = InferenceEngine(config, shard_params(dense, mesh), n_lanes=2, prefill_buckets=BUCKETS,
                         mesh=mesh, paged_kv=True, kv_page_size=8)
    one = InferenceEngine(config, dense, n_lanes=2, prefill_buckets=BUCKETS, device="cpu",
                          paged_kv=True, kv_page_size=8)
    assert tp.cache[0].table is tp.cache[1].table
    assert tp.cache[0].k.shape[3] == config.n_kv_heads // 2
    outs = []
    for eng in (tp, one):
        eng.paged_admit(1, FULL, 24)
        logits, greedy, _ = eng.prefill(1, FULL)
        step, g, _ = eng.decode(np.array([0, greedy]), np.array([64, len(FULL)]))
        outs.append((logits, step[1], eng.export_kv_page(eng.kvpool.lane_blocks(1)[0])))
    _close(outs[0][0].numpy(), outs[1][0].numpy())
    _close(outs[0][1].numpy(), outs[1][1].numpy())
    assert len(outs[0][2]) == len(outs[1][2])


# -- page bytes ----------------------------------------------------------------


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_kv_page_bytes_carry_across_packages(loaded, jax_loaded, direction):
    """A prompt's pages exported from one package import into the other's
    same pages; a re-export gives the same bytes, and the next decode step
    computes the exporter's logits within LOGIT_TOL."""
    config, params, _ = loaded
    jconfig, jparams, _ = jax_loaded
    port = _engine(config, params, page=16)
    jax_eng = JaxEngine(jconfig, jparams, n_lanes=2, prefill_buckets=BUCKETS, paged_kv=True,
                        kv_page_size=16)
    tokens = FULL + [12, 14, 19, 23, 25]  # 19 tokens: a full page and a part
    assert port.paged_admit(0, tokens, 24) == jax_eng.paged_admit(0, tokens, 24) == 0
    pages = port.kvpool.lane_blocks(0)
    assert pages == jax_eng.kvpool.lane_blocks(0)
    src, dst = (port, jax_eng) if direction == "port_to_jax" else (jax_eng, port)
    _, greedy, _ = src.prefill(0, tokens)
    payloads = [bytes(src.export_kv_page(p)) for p in pages[:2]]
    assert len(payloads[0]) == 2 * config.n_layers * 16 * config.n_kv_heads \
        * config.head_size * 4
    for p, data in zip(pages, payloads):
        dst.import_kv_page(p, data)
    assert [bytes(dst.export_kv_page(p)) for p in pages[:2]] == payloads
    feed, pos = np.array([int(greedy), 0]), np.array([len(tokens), 64])
    want = src.decode(feed, pos)[0]
    got = dst.decode(feed, pos)[0]
    _close(np.asarray(got)[0], np.asarray(want)[0])
    with pytest.raises(ValueError, match="bytes"):
        port.import_kv_page(pages[0], payloads[0][:-4])


# -- the scheduler ---------------------------------------------------------------


def _serve_streams(sched, batches):
    """Serve request batches one after another (each batch concurrent);
    returns each request's tokens and its summary."""
    sched.start()
    out = []
    try:
        for batch in batches:
            reqs = [sched.submit(r) for r in batch]
            for r in reqs:
                r.future.result(timeout=300)
                assert r.error is None, r.error
                out.append((list(r.generated_tokens), r.summary))
    finally:
        sched.stop()
    return out


def _churn(cls):
    """Sequential shared-prefix requests, then a concurrent mixed batch of
    greedy and seeded ones (more than the lanes)."""
    return [
        [cls(prompt=SYSTEM + "11", max_tokens=8, temperature=0.0)],
        [cls(prompt=SYSTEM + "22", max_tokens=8, temperature=0.0)],
        [cls(prompt=SYSTEM + "33", max_tokens=8, temperature=0.0),
         cls(prompt="zz unrelated", max_tokens=6, temperature=0.8, seed=7),
         cls(prompt=SYSTEM + "44 and then some", max_tokens=10, temperature=0.0),
         cls(prompt=SYSTEM + "11", max_tokens=5, temperature=0.9, seed=3)],
    ]


@pytest.mark.parametrize("path", ["default", "sync", "no_fused", "multi_step"])
def test_paged_streams_byte_identical_vs_contiguous_churn(loaded, path):
    """The same churn over a paged engine and a contiguous one gives the
    same streams on every serving path, the paged run sharing the prefix
    through the tree (copy-free, no copy-on-write block)."""
    config, params, tok = loaded
    eng_kw = {"default": {}, "sync": {"pipeline_depth": 0}, "no_fused": {},
              "multi_step": {"pipeline_depth": 0}}[path]
    sched_kw = {"default": {}, "sync": {"speculative": False}, "no_fused": {
        "fused_prefill": False}, "multi_step": {"multi_step": 4, "speculative": False}}[path]
    cont = _serve_streams(ContinuousBatchingScheduler(
        _engine(config, params, paged=False, **eng_kw), tok, **sched_kw), _churn(Request))
    paged_eng = _engine(config, params, **eng_kw)
    paged = _serve_streams(ContinuousBatchingScheduler(paged_eng, tok, **sched_kw),
                           _churn(Request))
    assert [t for t, _ in paged] == [t for t, _ in cont]
    assert [s["prefix_tokens_saved"] for _, s in paged] == \
        [s["prefix_tokens_saved"] for _, s in cont]
    s = paged_eng.pool_stats()
    assert s["pool_prefix_admits"] >= 2 and s["pool_cow_copies"] == 0
    assert s["pool_exhausted_sheds"] == 0 and s["pool_pages_in_use"] == 0
    assert paged_eng.stats.snapshot()["prefix_hits"] == s["pool_prefix_admits"]


def test_paged_greedy_streams_equal_jax_paged_scheduler(loaded, jax_loaded):
    """Greedy requests served one after another: the port's paged streams
    equal the JAX paged scheduler's, and each hit saves the JAX hit's
    tokens rounded down to whole prompt chunks."""
    config, params, tok = loaded
    jconfig, jparams, jtok = jax_loaded
    prompts = ["zz unrelated", SYSTEM + "11", SYSTEM + "22", SYSTEM + "11 and more"]
    got = _serve_streams(ContinuousBatchingScheduler(_engine(config, params), tok,
                                                     speculative=False),
                         [[Request(prompt=p, max_tokens=8)] for p in prompts])
    jengine = JaxEngine(jconfig, jparams, n_lanes=2, prefill_buckets=BUCKETS, paged_kv=True,
                        kv_page_size=4)
    want = _serve_streams(JaxScheduler(jengine, jtok, speculative=False, pipelined=False,
                                       fused_prefill=False, multi_step=1),
                          [[JaxRequest(prompt=p, max_tokens=8)] for p in prompts])
    assert [t for t, _ in got] == [t for t, _ in want]
    saved = [s["prefix_tokens_saved"] for _, s in got]
    jsaved = [s["prefix_tokens_saved"] for _, s in want]
    assert saved == [n - n % BUCKETS[0] for n in jsaved] and sum(saved) > 0
    assert jengine.kvpool.stats()["pool_cow_copies"] >= 1  # JAX shared a part block


def test_paged_pool_exhaustion_sheds_typed_429(loaded):
    """A request whose reservation the pool cannot serve while another
    lane pins it sheds with AdmissionRejected("pool_exhausted"): HTTP 429
    with a retry hint, request-scoped (the other request completes)."""
    config, params, tok = loaded
    engine = _engine(config, params, page=16, kv_pool_pages=4, kv_max_parked=0)
    sched = ContinuousBatchingScheduler(engine, tok, speculative=False)
    a = Request(prompt="x" * 21, max_tokens=40, temperature=0.0)
    b = Request(prompt="y" * 21, max_tokens=40, temperature=0.0)
    sched.start()
    try:
        sched.submit(a)
        sched.submit(b)
        with pytest.raises(AdmissionRejected) as ei:
            b.future.result(timeout=300)
        assert (ei.value.reason, ei.value.http_status) == ("pool_exhausted", 429)
        assert ei.value.retry_after_s > 0
        a.future.result(timeout=300)
        assert a.error is None and len(a.generated_tokens) == 40
    finally:
        sched.stop()
    assert engine.pool_stats()["pool_exhausted_sheds"] == 1
    assert sched.queue._rejected.get("pool_exhausted") == 1  # note_rejection
    assert sched.breaker.state == "closed"


def test_paged_oversubscription_parks_sessions_beyond_lanes(loaded):
    """Six sessions over two lanes with a shared system prompt: the
    streams equal the contiguous engine's, later admissions share the
    prefix, and the finished sessions park: more resident sessions than
    lanes, and no lane page held at rest (the leak witness's count)."""
    config, params, tok = loaded
    prompts = [[Request(prompt=SYSTEM + f"user {i} asks {i}", max_tokens=6)]
               for i in range(6)]
    want = _serve_streams(ContinuousBatchingScheduler(_engine(config, params, paged=False),
                                                      tok), prompts)
    engine = _engine(config, params)
    sched = ContinuousBatchingScheduler(engine, tok)
    got = _serve_streams(sched, [[Request(prompt=r[0].prompt, max_tokens=6)]
                                 for r in prompts])
    assert [t for t, _ in got] == [t for t, _ in want]
    s = engine.pool_stats()
    assert s["pool_prefix_admits"] >= 5 and s["pool_parked_sessions"] >= 4
    assert sched.leak_counts()["kv_lane_pages"] == 0
    assert sched.leak_counts()["kv_swap_pending"] == 0


def _one(sched, prompt="aa bb cc dd ee ff gg hh 11", seed=1234):
    r = Request(prompt=prompt, max_tokens=8, temperature=0.8, seed=seed)
    sched.submit(r)
    r.future.result(timeout=300)
    assert r.error is None, r.error
    return list(r.generated_tokens)


def test_paged_park_drop_journal_rebuild_byte_identical(loaded, tmp_path):
    """A finished session's pages dropped under pressure rebuild by
    re-prefilling the journaled prompt with its resolved seed: the same
    bytes as the never-dropped run."""
    config, params, tok = loaded
    sched = ContinuousBatchingScheduler(_engine(config, params, paged=False), tok)
    sched.start()
    try:
        ref = _one(sched)
    finally:
        sched.stop()
    jpath = str(tmp_path / "journal.bin")
    journal = RequestJournal(jpath, fsync=False)
    engine = _engine(config, params)
    sched = ContinuousBatchingScheduler(engine, tok, journal=journal)
    sched.start()
    try:
        assert _one(sched) == ref
        assert engine.kvpool.parked_sessions() >= 1
        assert engine.kvpool.drop_parked() >= 1
        assert engine.pool_stats()["pool_parked_evicted"] >= 1
        assert _one(sched) == ref
    finally:
        sched.stop()
        journal.close()
    entries = list(read_journal(jpath).entries.values())
    assert len(entries) == 2
    assert all(e.tokens == tok.encode("aa bb cc dd ee ff gg hh 11") and e.seed == 1234
               and e.finished for e in entries)


def test_paged_three_tier_residency_byte_identical(loaded):
    """One seeded request replayed with its prefix parked in the pool, swapped
    to the host tier and back, and dropped: the same bytes each time, the
    contiguous engine's. The swap counters move, and the admission that
    swapped in carries its swap time."""
    config, params, tok = loaded
    prompt = SYSTEM + "11 and a tail"  # 36 tokens: whole chunks to share
    sched = ContinuousBatchingScheduler(_engine(config, params, paged=False), tok)
    sched.start()
    try:
        ref = _one(sched, prompt)
    finally:
        sched.stop()
    engine = _engine(config, params, kv_host_bytes=64 << 20)
    sched = ContinuousBatchingScheduler(engine, tok)
    sched.start()
    try:
        assert _one(sched, prompt) == ref  # cold; the session parks
        assert _one(sched, prompt) == ref  # resident in the pool
        assert engine.pool_stats()["pool_prefix_admits"] == 1
        assert engine.swap_out_parked() >= 1  # the loop is idle between requests
        s = engine.pool_stats()
        assert s["swap_outs"] >= 1 and s["pool_host_pages"] >= 1
        r = Request(prompt=prompt, max_tokens=8, temperature=0.8, seed=1234)
        sched.submit(r)
        r.future.result(timeout=300)
        assert list(r.generated_tokens) == ref  # swapped back in
        s = engine.pool_stats()
        assert s["swap_ins"] >= 1 and s["pool_swap_in_admits"] == 1
        assert r.summary["phases"]["swap_in_ms"] > 0
        engine.kvpool.drop_parked()
        engine.kvpool.host_tier.clear()
        assert _one(sched, prompt) == ref  # rebuilt
    finally:
        sched.stop()


def test_corrupt_host_tier_page_fails_the_request_not_the_tree(loaded):
    """A swapped page whose bytes changed behind its hash fails its
    admission with HostTierCorrupt, a request-scoped ValueError, before
    any pool mutation; the retry re-prefills and streams the same bytes."""
    config, params, tok = loaded
    prompt = SYSTEM + "11 and a tail"
    engine = _engine(config, params, kv_host_bytes=64 << 20)
    sched = ContinuousBatchingScheduler(engine, tok)
    sched.start()
    try:
        ref = _one(sched, prompt)
        engine.swap_out_parked()
        tier = engine.kvpool.host_tier
        with tier._lock:
            for key in list(tier._swapped):
                data, h = tier._swapped[key]
                tier._swapped[key] = (bytes(len(data)), h)
        nodes = dict(engine.kvpool._nodes)
        r = Request(prompt=prompt, max_tokens=8, temperature=0.8, seed=1234)
        sched.submit(r)
        with pytest.raises(ValueError, match="integrity"):
            r.future.result(timeout=300)
        assert engine.kvpool._nodes == nodes
        assert sched.breaker.state == "closed"
        assert _one(sched, prompt) == ref
    finally:
        sched.stop()


def test_paged_pool_gauges_on_stats_load_and_metrics(loaded):
    """The pool's fields reach /stats (and /metrics through the bridge,
    with the swap counter by direction) and /load; a contiguous engine's
    /load omits them."""
    config, params, tok = loaded
    engine = _engine(config, params, kv_host_bytes=1 << 20)
    sched = ContinuousBatchingScheduler(engine, tok)
    api = ApiServer(sched, tok, model_name="tiny-test")
    _serve_streams(sched, [[Request(prompt=SYSTEM + "11 and a tail", max_tokens=4)]])
    engine.swap_out_parked()
    stats = api.handle_stats()
    for key in ("pool_pages_total", "pool_pages_free", "pool_pages_in_use",
                "pool_prefix_tokens_shared", "pool_cow_copies", "pool_parked_sessions",
                "pool_parked_evicted", "pool_exhausted_sheds", "swap_ins", "swap_outs",
                "swap_in_ms", "pool_host_pages"):
        assert key in stats, key
    assert stats["swap_outs"] >= 1
    load = api.handle_load()
    assert load["pool_pages_total"] == engine.kvpool.n_pages
    assert load["pool_pages_free"] == stats["pool_pages_free"]
    text = api.handle_metrics()
    assert f'dllama_kv_swap_total{{direction="out"}} {stats["swap_outs"]}\n' in text
    assert "dllama_stats_pool_pages_free" in text
    cont = ApiServer(ContinuousBatchingScheduler(_engine(config, params, paged=False), tok),
                     tok, model_name="tiny-test")
    assert not any(k.startswith("pool_") for k in cont.handle_load())
    assert "swap_ins" not in cont.handle_stats()


def test_paged_pool_shed_over_http_is_429_with_retry_after(loaded):
    """Through the HTTP server a pool shed answers 429 with Retry-After and
    the typed reason."""
    config, params, tok = loaded
    engine = _engine(config, params, page=16, kv_pool_pages=4, kv_max_parked=0)
    sched = ContinuousBatchingScheduler(engine, tok, speculative=False)
    sched.start()
    httpd = ApiServer(sched, tok, model_name="tiny-test").serve(host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/completions"
    try:
        long = Request(prompt="x" * 21, max_tokens=40, temperature=0.0)
        sched.submit(long)  # pins the whole pool
        body = json.dumps({"prompt": "y" * 21, "max_tokens": 40, "temperature": 0}).encode()
        req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=120)
        assert ei.value.code == 429 and int(ei.value.headers["Retry-After"]) >= 1
        assert json.loads(ei.value.read())["reason"] == "pool_exhausted"
        long.future.result(timeout=300)
    finally:
        httpd.shutdown()
        sched.stop()


def test_leak_witness_counts_lane_pages(loaded):
    """A paged scheduler's drain snapshot carries the lane-held pages and
    the staged swap-outs; both read 0 after a clean stop, with parked
    sessions still resident."""
    config, params, tok = loaded
    engine = _engine(config, params)
    sched = ContinuousBatchingScheduler(engine, tok)
    leakcheck.force(True)
    try:
        _serve_streams(sched, [[Request(prompt=SYSTEM + "11", max_tokens=4)]])
        assert leakcheck.live_counts()["kv_lane_pages"] == 0
        assert leakcheck.live_counts()["kv_swap_pending"] == 0
    finally:
        leakcheck.force(None)
    assert engine.kvpool.parked_sessions() == 1
    engine.paged_admit(0, FULL, 20)
    assert sched.leak_counts()["kv_lane_pages"] == engine.kvpool.stats()["pool_pages_in_use"] > 0


# -- refusals and flags --------------------------------------------------------


def test_paged_engine_refuses_copy_lane(loaded):
    config, params, _ = loaded
    with pytest.raises(RuntimeError, match="paged"):
        _engine(config, params).copy_lane(0, 1)
    with pytest.raises(RuntimeError, match="paged engine"):
        _engine(config, params, paged=False).export_kv_page(0)


@pytest.mark.parametrize("axis", ["dp", "sp"])
def test_paged_kv_refused_on_a_dp_or_sp_mesh(loaded, axis):
    config, params, _ = loaded
    shape = {"dp": 1, "pp": 1, "tp": 1, "sp": 1, "ep": 1, axis: 2}
    mesh = Mesh(devices=[torch.device("cpu")] * 2, shape=shape)
    with pytest.raises(ValueError, match="pure-TP mesh"):
        InferenceEngine(config, [params, params], n_lanes=2, prefill_buckets=BUCKETS,
                        mesh=mesh, paged_kv=True)


def test_paged_flags_parse_with_jax_defaults(loaded):
    for argv in ([], ["--paged-kv", "on", "--kv-page-size", "16", "--kv-pool-pages", "9",
                      "--kv-max-parked", "3", "--kv-host-bytes", "4096"]):
        base = ["--model", "m", "--tokenizer", "t"]
        got = build_parser("dllama-api", api=True).parse_args(base + argv)
        want = j_build_parser("dllama-api", api=True).parse_args(base + argv)
        for key in ("paged_kv", "kv_page_size", "kv_pool_pages", "kv_max_parked",
                    "kv_host_bytes"):
            assert getattr(got, key) == getattr(want, key), key
    kw = paged_kwargs(argparse.Namespace(paged_kv="on", kv_page_size=None, kv_pool_pages=None,
                                         kv_max_parked=None, kv_host_bytes=None))
    assert kw == {"paged_kv": True, "kv_page_size": 64, "kv_pool_pages": None,
                  "kv_max_parked": 64, "kv_host_bytes": 0}
    config, params, _ = loaded
    with pytest.raises(ValueError, match="power of two"):
        InferenceEngine(config, params, n_lanes=2, device="cpu", paged_kv=True, kv_page_size=24)
    engine = InferenceEngine(config, params, n_lanes=2, device="cpu", paged_kv=True)
    assert engine.kvpool.page_size == 64 and isinstance(engine.cache, PagedKVCache)
    # the default pool is the contiguous layout's footprint: a lane each
    assert engine.kvpool.n_pages == 2 and engine.kvpool.blocks_per_lane == 1
