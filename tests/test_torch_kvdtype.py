"""The port's f8 KV cache on the CPU (``--kv-dtype f8``: a
``torch.float8_e4m3fn`` cache written through ``models/llama._to_cache_dtype``
and read by the attention's e4m3 form), held against the JAX package's
f8 engine on the tiny model (packed Q40, the kernels' plain versions).

Tolerances:

- the cast (``_to_cache_dtype``) on the same f32 input: the JAX package's
  bytes exactly, saturation included;
- the plain attention on an e4m3 cache: exactly the plain attention on the
  cache widened to f32, and the JAX dense attention within 1e-5 of
  max|y| (f32 summation order);
- the engines: the greedy tokens equal, and the cache bytes equal except
  at rounding ties: the two forwards' f32 K/V differ in their last bits
  (within the port's forward tolerance against the JAX package), so a
  value that lies within that noise of the midpoint between two e4m3 codes
  may round to the neighbouring code in one package. Every differing byte
  must be such a neighbour, and they must be rare (at most 1e-3 of the
  written bytes); on this seed one V byte of 2,560 differs, its port value
  0.066406280 against the midpoint 0.06640625. A tie moves one cache
  value by an e4m3 step, which moves the logits of every call that reads
  it by more than the forward's tolerance, so the logits are held within
  ``LOGIT_TOL`` x max|logit| in lockstep: before every call the port's
  cache is set to the JAX engine's bytes, and every call that writes no
  tie (all but at most one of the nine; on this seed the prefill, which
  writes the tie and reads it in the same forward, is the one) must be
  within it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_llama_multiusers_tpu.formats import load_model_header as j_load_header
from distributed_llama_multiusers_tpu.models import load_params_from_m as j_load_params
from distributed_llama_multiusers_tpu.models.llama import _dense_attention as jax_attention
from distributed_llama_multiusers_tpu.models.llama import _to_cache_dtype as j_to_cache_dtype
from distributed_llama_multiusers_tpu.runtime import InferenceEngine as JaxEngine
from distributed_llama_multiusers_tpu_torch.app.args import build_parser
from distributed_llama_multiusers_tpu_torch.app.runtime_setup import load_stack
from distributed_llama_multiusers_tpu_torch.formats import load_model_header
from distributed_llama_multiusers_tpu_torch.models import (
    load_params_from_m,
    load_params_from_m_quantized,
)
from distributed_llama_multiusers_tpu_torch.models.llama import F8, _to_cache_dtype
from distributed_llama_multiusers_tpu_torch.ops import cuda_attn
from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
from distributed_llama_multiusers_tpu_torch.parallel.sharding import shard_params
from distributed_llama_multiusers_tpu_torch.runtime import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
)
from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer

LOGIT_TOL = 1e-4  # x max|logit|, the port's model tolerance against the JAX package
PROMPT = [5, 9, 3, 17, 2, 11, 7, 4, 13, 6, 21]
BUCKETS = (8,)


@pytest.fixture(scope="module")
def loaded(tiny_model):
    path = tiny_model["model"]
    config, params = load_params_from_m_quantized(path, load_model_header(path),
                                                  dtype=torch.float32, device="cpu")
    return config, params


@pytest.fixture(scope="module")
def jax_loaded(tiny_model):
    path = tiny_model["model"]
    return j_load_params(path, j_load_header(path), dtype=jnp.float32)


def _bits(x) -> np.ndarray:
    """An e4m3 tensor or array as its bytes."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


# -- the cast ------------------------------------------------------------------


def test_cast_saturates_like_jax():
    """Outliers clip to +-448 (no NaN: e4m3 has no inf), every finite
    f32 value rounds to the JAX package's code, eager and jitted."""
    rng = np.random.default_rng(0)
    special = np.array([448.0, 449.0, 464.0, 465.0, 500.0, 1e6, 3e38, -448.0, -500.0, -1e6,
                        0.0, -0.0, 2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -11, 1e-30, 0.06640625,
                        0.066406250001, 0.066406249999], np.float32)
    x = np.concatenate([special, rng.standard_normal(4096).astype(np.float32) * 30,
                        rng.standard_normal(1024).astype(np.float32) * 1e-3,
                        np.float32(2.0) ** rng.integers(-12, 10, 512).astype(np.float32)])
    got = _to_cache_dtype(torch.from_numpy(x), F8)
    assert got.dtype == F8
    want = _bits(j_to_cache_dtype(jnp.asarray(x), jnp.float8_e4m3fn))
    assert np.array_equal(_bits(got), want)
    jitted = jax.jit(lambda a: j_to_cache_dtype(a, jnp.float8_e4m3fn))(jnp.asarray(x))
    assert np.array_equal(_bits(got), _bits(jitted))
    assert np.array_equal(_bits(got), x.clip(-448, 448).astype(ml_dtypes.float8_e4m3fn)
                          .view(np.uint8))
    assert float(got.to(torch.float32).abs().max()) == 448.0
    assert not torch.isnan(got.to(torch.float32)).any()
    # other dtypes pass through a plain cast
    assert torch.equal(_to_cache_dtype(torch.from_numpy(x), torch.bfloat16),
                       torch.from_numpy(x).to(torch.bfloat16))


# -- the plain attention ---------------------------------------------------------


@pytest.mark.parametrize("lanes,n_kv,group,hd,s_len,t", [
    (2, 2, 2, 16, 64, 1), (4, 4, 4, 64, 300, 1), (3, 2, 4, 32, 200, 4), (2, 1, 8, 128, 129, 2)])
def test_f8_plain_attention_is_the_upcast_attention(lanes, n_kv, group, hd, s_len, t):
    """The e4m3 plain version (contiguous and paged) equals the plain
    attention on the cache widened to f32 bit for bit, and the JAX dense
    attention on the same widened cache within 1e-5 of max|y|. The cache
    holds values past +-448, written through ``_to_cache_dtype``."""
    rng = np.random.default_rng(lanes * 100 + s_len)
    qf = torch.from_numpy(rng.standard_normal((lanes, t, n_kv, group, hd)).astype(np.float32))
    raw = rng.standard_normal((2, lanes, s_len + 1, n_kv, hd)).astype(np.float32) * 100
    k, v = (_to_cache_dtype(torch.from_numpy(a), F8) for a in raw)
    pos = torch.from_numpy(rng.integers(0, s_len + 2, (lanes, t)))
    scale = 1.0 / hd ** 0.5
    cuda_attn.reset_counts()
    got = cuda_attn.decode_attention(qf, k, v, pos, scale, s_len)
    assert cuda_attn.F8_COUNTS == {"launches": 0}  # the CPU runs the plain version
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    assert torch.equal(got, cuda_attn.decode_attention(qf, kf, vf, pos, scale, s_len))
    mask = np.arange(s_len)[None, None, :] <= pos.numpy()[:, :, None]
    want = np.asarray(jax_attention(jnp.asarray(qf.numpy()), jnp.asarray(kf[:, :s_len].numpy()),
                                    jnp.asarray(vf[:, :s_len].numpy()), jnp.asarray(mask), scale))
    assert np.max(np.abs(got.numpy() - want)) <= 1e-5 * np.max(np.abs(want))
    # the paged form: the same slots scattered over a permuted pool
    page = 16
    nb = -(-(s_len + 1) // page)
    perm = rng.permutation(lanes * nb + 3)[:lanes * nb].reshape(lanes, nb)
    kp = torch.zeros((lanes * nb + 3, page, n_kv, hd), dtype=F8)
    vp = torch.zeros_like(kp)
    for b in range(lanes):
        for j in range(nb):
            n = min(page, s_len + 1 - j * page)
            kp[perm[b, j], :n] = k[b, j * page:j * page + n]
            vp[perm[b, j], :n] = v[b, j * page:j * page + n]
    table = torch.from_numpy(perm.astype(np.int32))
    paged = cuda_attn.decode_attention_paged(qf, kp, vp, table, pos, scale, s_len)
    assert torch.equal(paged, got)


# -- the engines -----------------------------------------------------------------


def _run(engine, paged: bool):
    """A prefill of PROMPT on lane 0 (lane 1 idle), then 8 greedy decode
    steps: the tokens and every step's logits."""
    if paged:
        engine.paged_admit(0, PROMPT, 40)
    logits, g, _ = engine.prefill(0, PROMPT)
    toks, outs = [int(g)], [np.asarray(logits)]
    for i in range(8):
        step, greedy, _ = engine.decode(np.array([toks[-1], 0]), np.array([len(PROMPT) + i, 64]))
        toks.append(int(np.asarray(greedy)[0]))
        outs.append(np.asarray(step)[0])
    return toks, outs


def _planes(port, jeng, paged):
    """Both engines' K and V planes as bytes, the port's cut to the JAX
    layout (it keeps one scratch slot, or page, more)."""
    out = []
    for plane in ("k", "v"):
        jb = _bits(getattr(jeng.cache, plane))
        pt = getattr(port.cache, plane).view(torch.uint8)
        pt = pt[:, :, :jb.shape[2]] if not paged else pt[:, :jb.shape[1]]
        out.append((pt, jb))
    return out


def _ties_only(pb: np.ndarray, jb: np.ndarray) -> int:
    """Bytes differ only at rounding ties (the neighbouring code of the
    same sign); returns how many."""
    diff = pb != jb
    pj, jj = pb[diff].astype(np.int16), jb[diff].astype(np.int16)
    assert np.all(np.abs(pj - jj) == 1) and np.all((pj & 0x80) == (jj & 0x80))
    return int(diff.sum())


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_f8_engine_cache_bytes_and_tokens_equal_jax(loaded, jax_loaded, paged):
    """Free running, a prefill and 8 greedy decode steps give the JAX f8
    engine's tokens, and the caches differ only at rare rounding ties. In
    lockstep (the port's cache set to the JAX engine's bytes before every
    call, so both start each call from the same state) every call's
    logits are within LOGIT_TOL and its writes are the JAX bytes up to
    ties."""
    config, params = loaded
    jconfig, jparams = jax_loaded
    kw = dict(paged_kv=True, kv_page_size=16) if paged else {}

    def engines():
        port = InferenceEngine(config, params, n_lanes=2, prefill_buckets=BUCKETS,
                               device="cpu", cache_dtype=F8, **kw)
        jeng = JaxEngine(jconfig, jparams, n_lanes=2, prefill_buckets=BUCKETS,
                         cache_dtype=jnp.float8_e4m3fn, **kw)
        return port, jeng

    port, jeng = engines()
    assert port.cache.k.dtype == F8 and port.cache.k.element_size() == 1
    p_toks, _ = _run(port, paged)
    j_toks, _ = _run(jeng, paged)
    assert p_toks == j_toks
    written = ties = 0
    for pt, jb in _planes(port, jeng, paged):
        written += int((jb != 0).sum())
        ties += _ties_only(pt.numpy(), jb)
    assert written > 1000 and ties <= 1e-3 * written, (ties, written)

    port, jeng = engines()
    if paged:
        assert port.paged_admit(0, PROMPT, 40) == jeng.paged_admit(0, PROMPT, 40) == 0
        assert port.kvpool.lane_blocks(0) == jeng.kvpool.lane_blocks(0)
    calls = [lambda e: e.prefill(0, PROMPT)]
    toks = list(j_toks)
    for i in range(8):
        calls.append(lambda e, i=i: e.decode(np.array([toks[i], 0]),
                                             np.array([len(PROMPT) + i, 64])))
    clean = 0
    for n, call in enumerate(calls):
        for pt, jb in _planes(port, jeng, paged):
            pt.copy_(torch.from_numpy(jb.copy()))
        got, want = call(port), call(jeng)
        assert int(np.asarray(got[1]).reshape(-1)[0]) == int(np.asarray(want[1]).reshape(-1)[0])
        call_ties = sum(_ties_only(pt.numpy(), jb) for pt, jb in _planes(port, jeng, paged))
        assert call_ties <= 2
        if call_ties == 0:
            # a call that wrote no tie read the same cache in both
            a, b = np.asarray(got[0]), np.asarray(want[0])
            a, b = (a, b) if n == 0 else (a[0], b[0])
            assert np.max(np.abs(a - b)) <= LOGIT_TOL * np.max(np.abs(b))
            clean += 1
    assert clean >= len(calls) - 1


def test_f8_halves_bf16_and_quarters_f32(loaded):
    config, params = loaded
    sizes = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16), ("f8", F8)):
        eng = InferenceEngine(config, params, n_lanes=2, prefill_buckets=BUCKETS,
                              device="cpu", cache_dtype=dt, paged_kv=True, kv_page_size=16)
        sizes[name] = (eng.kv_page_bytes(), eng.cache.k.nbytes)
    assert sizes["f8"][0] * 2 == sizes["bf16"][0] and sizes["f8"][0] * 4 == sizes["f32"][0]
    assert sizes["f8"][0] == 2 * config.n_layers * 16 * config.n_kv_heads * config.head_size
    assert sizes["f8"][1] * 4 == sizes["f32"][1]


def test_f8_page_ops_copy_lane_and_swap_tier(loaded):
    """Export, import, swap out and in move e4m3 pages as their bytes; the
    host tier budgets them at their size; copy_lane copies e4m3 slots."""
    config, params = loaded
    eng = InferenceEngine(config, params, n_lanes=2, prefill_buckets=BUCKETS, device="cpu",
                          cache_dtype=F8, paged_kv=True, kv_page_size=4, kv_pool_pages=40,
                          kv_host_bytes=1 << 20)
    eng.paged_admit(0, PROMPT + [8, 30], 14)
    eng.prefill(0, PROMPT + [8, 30])
    pages = eng.kvpool.lane_blocks(0)[:3]
    payloads = [eng.export_kv_page(p) for p in pages]
    assert all(len(p) == eng.kv_page_bytes() and any(p) for p in payloads)
    spare = [eng.kvpool.n_pages - 1 - i for i in range(3)]
    eng.import_kv_page(spare[0], payloads[0])
    assert eng.export_kv_page(spare[0]) == payloads[0]
    out = eng.swap_out_pages(pages)
    assert out == payloads
    eng.swap_in_pages(spare, out)
    assert [eng.export_kv_page(p) for p in spare] == payloads
    assert eng.swap_in_bytes == 3 * eng.kv_page_bytes()
    tier = eng.kvpool.host_tier
    assert tier.put(("k",), PROMPT[:4], payloads[0])
    assert tier.stats()["pool_host_bytes"] == eng.kv_page_bytes()
    with pytest.raises(ValueError, match="bytes"):
        eng.import_kv_page(spare[1], payloads[0] + b"\0")
    # the contiguous layout's prefix copy
    flat = InferenceEngine(config, params, n_lanes=2, prefill_buckets=BUCKETS, device="cpu",
                           cache_dtype=F8)
    flat.prefill(0, PROMPT)
    flat.copy_lane(0, 1, len(PROMPT))
    assert torch.equal(flat.cache.k.view(torch.uint8)[:, 1, :len(PROMPT)],
                       flat.cache.k.view(torch.uint8)[:, 0, :len(PROMPT)])


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_f8_tp2_engine_gives_tp1_tokens(tiny_model, paged):
    """Each rank holds its kv heads' e4m3 shard; greedy tokens equal the
    one-rank f8 engine's, and copy_lane composes on the mesh."""
    path = tiny_model["model"]
    config, dense = load_params_from_m(path, load_model_header(path), dtype=torch.float32,
                                       device="cpu")
    mesh = make_mesh(MeshPlan(tp=2), ["cpu", "cpu"])
    kw = dict(paged_kv=True, kv_page_size=16) if paged else {}
    tp = InferenceEngine(config, shard_params(dense, mesh), n_lanes=2, prefill_buckets=BUCKETS,
                         mesh=mesh, cache_dtype=F8, **kw)
    one = InferenceEngine(config, dense, n_lanes=2, prefill_buckets=BUCKETS, device="cpu",
                          cache_dtype=F8, **kw)
    assert all(c.k.dtype == F8 and c.k.shape[3] == config.n_kv_heads // 2 for c in tp.cache)
    t_toks, t_logits = _run(tp, paged)
    o_toks, o_logits = _run(one, paged)
    assert t_toks == o_toks
    for a, b in zip(t_logits, o_logits):
        assert np.all(np.isfinite(a))
        assert np.max(np.abs(a - b)) <= LOGIT_TOL * np.max(np.abs(b))
    if paged:
        page = tp.kvpool.lane_blocks(0)[0]
        assert tp.export_kv_page(page) == one.export_kv_page(page)
    else:
        tp.copy_lane(0, 1)
        logits, _, _ = tp.prefill(1, [7], start_pos=len(PROMPT))
        assert np.all(np.isfinite(np.asarray(logits)))


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_f8_serving_streams_alone_equal_concurrent(tiny_model, paged):
    """``dllama_api --kv-dtype f8`` (its own parser and stack, on the CPU):
    four requests, two greedy and two seeded, each alone and the four
    concurrent, give the same text byte for byte; ``dllama`` takes the flag
    too."""
    argv = ["--model", tiny_model["model"], "--tokenizer", tiny_model["tokenizer"],
            "--device", "cpu", "--max-lanes", "4", "--kv-dtype", "f8",
            "--paged-kv", "on" if paged else "off"]
    args = build_parser("dllama-api").parse_args(argv)
    _, _, tok, engine = load_stack(args)
    assert engine.cache_dtype == F8 and (engine.kvpool is not None) == paged
    assert build_parser("dllama").parse_args(["inference", *argv[:4], "--kv-dtype",
                                              "f8"]).kv_dtype == "f8"

    def reqs():
        return [Request(prompt=f"f8 stream {i} text", max_tokens=24,
                        temperature=0.0 if i % 2 == 0 else 0.8,
                        seed=None if i % 2 == 0 else 11 + i) for i in range(4)]

    sched = ContinuousBatchingScheduler(engine, tok)
    sched.start()
    try:
        alone = []
        for r in reqs():
            sched.submit(r)
            alone.append(r.future.result(timeout=120))
        batch = reqs()
        for r in batch:
            sched.submit(r)
        together = [r.future.result(timeout=120) for r in batch]
    finally:
        sched.stop()
    assert together == alone and all(alone)
