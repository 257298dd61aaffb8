"""The port's dp, sp and ep serving meshes against the JAX package's on the
same mesh: the rank order and groups, the shards, sequence-parallel
attention's stats and combine, the forward's logits, the engine's greedy
tokens, the ep path's packed experts, the hop bytes of a decode step, the
server, and what stays refused.

Ranks are CPU "devices" (every rank on ``cpu``), the counterpart of the JAX
package's 8 virtual CPU devices (tests/conftest.py); the JAX forward runs
its Q40 products through their plain reference (``q40_matmul_xla``), the
port the kernels' plain versions, the ring hop's and the attention stats'.

Tolerances: logits within atol 2e-4 of the JAX forward on the same mesh,
the JAX package's own bound for its sp and ep parity tests
(tests/test_ring_attention.py, tests/test_moe.py); under the Q80 casts 2e-2
of max|logits| (the Q80 class of tests/test_torch_tp.py). Attention alone
within 1e-5, as tests/test_ring_attention.py holds JAX's.
"""

import json
import re
import threading
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_multiusers_tpu.formats import load_model_header as j_load_header
from distributed_llama_multiusers_tpu.formats import synthetic as j_syn
from distributed_llama_multiusers_tpu.models import init_kv_cache as j_init_cache
from distributed_llama_multiusers_tpu.models import llama_forward as j_forward
from distributed_llama_multiusers_tpu.models import loader as j_loader
from distributed_llama_multiusers_tpu.models.llama import KVCache as JKVCache
from distributed_llama_multiusers_tpu.parallel import MeshPlan as JaxPlan
from distributed_llama_multiusers_tpu.parallel import make_mesh as j_make_mesh
from distributed_llama_multiusers_tpu.parallel.ring_attention import sp_attention as j_sp_attention
from distributed_llama_multiusers_tpu.parallel.sharding import cache_shardings as j_cache_shardings
from distributed_llama_multiusers_tpu.parallel.sharding import shard_params as j_shard
from distributed_llama_multiusers_tpu.runtime import InferenceEngine as JaxEngine
from distributed_llama_multiusers_tpu_torch.app import runtime_setup
from distributed_llama_multiusers_tpu_torch.models import (
    init_kv_cache,
    llama as t_llama,
    llama_forward,
    params_from_jax_numpy,
)
from distributed_llama_multiusers_tpu_torch.models.config import LlamaConfig
from distributed_llama_multiusers_tpu_torch.models.llama import KVCache
from distributed_llama_multiusers_tpu_torch.ops import cuda_attn
from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc
from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
from distributed_llama_multiusers_tpu_torch.parallel.ring_attention import (
    combine_stats,
    sp_attention,
)
from distributed_llama_multiusers_tpu_torch.parallel.sharding import (
    shard_kv_cache,
    shard_params,
)
from distributed_llama_multiusers_tpu_torch.quants import packed as t_packed
from distributed_llama_multiusers_tpu_torch.quants.packed import PackedQ40
from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine

PLANS = {"dp2tp2sp2": dict(dp=2, tp=2, sp=2), "tp2sp4": dict(tp=2, sp=4),
         "tp2ep2": dict(tp=2, ep=2)}
PROMPT = [5, 9, 3, 17, 2, 44, 101]
ATOL = 2e-4


def _meshes(name):
    plan = PLANS[name]
    n = int(np.prod(list(plan.values())))
    return make_mesh(MeshPlan(**plan), ["cpu"] * n), j_make_mesh(JaxPlan(**plan))


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _port_params(jp, vocab):
    """The port's params with the JAX params' values (the packed wcls's
    TPU tile padding trimmed, as the port's loader does not pad)."""
    t = params_from_jax_numpy(_np_tree(jp), device="cpu")
    if isinstance(t.wcls, PackedQ40):
        t.wcls = PackedQ40(t.wcls.packed[..., :vocab].contiguous(),
                           t.wcls.scales[..., :vocab].contiguous())
    return t


def _port_config(jcfg):
    return LlamaConfig(**{k: getattr(jcfg, k) for k in LlamaConfig.__dataclass_fields__})


@pytest.fixture(scope="module")
def models(tiny_model, tmp_path_factory):
    """(JAX config, JAX params, port config, port params) of the tiny model
    and of the Mixtral-shaped tiny model (4 experts, 2 active, seed 3: the
    JAX MoE tests' file), each dense and packed."""
    d = tmp_path_factory.mktemp("mesh_moe")
    moe_path = str(d / "moe.m")
    j_syn.write_synthetic_model(moe_path, j_syn.tiny_header(n_experts=4, n_active_experts=2),
                                seed=3)
    out = {}
    for name, path in (("tiny", tiny_model["model"]), ("moe", moe_path)):
        h = j_load_header(path)
        for kind, load in (("dense", j_loader.load_params_from_m),
                           ("packed", j_loader.load_params_from_m_quantized)):
            jcfg, jp = load(path, h, dtype=jnp.float32)
            out[name, kind] = (jcfg, jp, _port_config(jcfg), _port_params(jp, jcfg.vocab_size))
    return out


# -- the mesh: rank order and groups ------------------------------------------


@pytest.mark.parametrize("name", sorted(PLANS))
def test_rank_order_and_groups_follow_the_jax_device_grid(name):
    """Rank r is the JAX mesh's r-th device: its coordinates are that
    device's place in the (dp, pp, tp, sp, ep) grid, and each group is the
    grid's line or plane through it."""
    mesh, jmesh = _meshes(name)
    grid = np.vectorize(lambda d: d.id)(jmesh.devices)
    ids = [d.id for d in jax.devices()[:mesh.n_ranks]]
    assert mesh.n_ranks == grid.size == len(mesh.devices)
    for r in range(mesh.n_ranks):
        (at,) = np.argwhere(grid == ids[r])
        assert tuple(at) == tuple(mesh.coords(r)[ax] for ax in ("dp", "pp", "tp", "sp", "ep"))
        assert mesh.rank(**mesh.coords(r)) == r

    def lines(axes):
        keep = [i for i, ax in enumerate(("dp", "pp", "tp", "sp", "ep")) if ax not in axes]
        moved = np.moveaxis(grid, keep, list(range(len(keep))))
        flat = moved.reshape(int(np.prod([grid.shape[i] for i in keep])), -1)
        return sorted(sorted(ids.index(i) for i in row) for row in flat)

    assert mesh.tp_groups() == lines(("tp",))
    assert mesh.sp_groups() == lines(("sp",))
    assert mesh.ep_tp_groups() == lines(("ep", "tp"))
    assert all(len(g) == mesh.shape["tp"] for g in mesh.tp_groups())


# -- the shards -----------------------------------------------------------------


def _planes(w):
    """A weight's planes (either package's PackedQ40, or a dense tensor)."""
    return (w.packed, w.scales) if hasattr(w, "packed") else (w,)


def _jax_shard(leaf, device):
    (shard,) = [s for s in leaf.addressable_shards if s.device == device]
    return np.asarray(shard.data)


def _same(port_plane, jax_plane):
    a = port_plane.numpy()
    if a.dtype == np.float16 or str(port_plane.dtype) == "torch.float16":
        np.testing.assert_array_equal(a.view(np.uint16), jax_plane.view(np.uint16))
    else:
        np.testing.assert_array_equal(a, jax_plane)


@pytest.mark.parametrize("name,model", [("dp2tp2sp2", "tiny"), ("tp2sp4", "tiny"),
                                        ("tp2ep2", "moe")])
@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_shards_equal_the_jax_shardings_shards(models, name, model, kind):
    """Every rank's parameter planes and KV cache share equal, byte for
    byte, the JAX shardings' shard on the rank's device (col-sliced wo/w2
    through their column-chunk stacks; the cache's slot block besides the
    port's scratch slot)."""
    jcfg, jp, cfg, tparams = models[model, kind]
    mesh, jmesh = _meshes(name)
    shards = shard_params(tparams, mesh)
    jshard = j_shard(jp, jmesh)
    devices = jax.devices()
    moe = cfg.n_experts > 0
    for r, s in enumerate(shards):
        dev = devices[r]
        for key in ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "rms_att", "rms_ffn"):
            for port, jx in zip(_planes(getattr(s.layers, key)),
                                _planes(getattr(jshard.layers, key))):
                want = _jax_shard(jx, dev)
                if key == "wo" or (key == "w2" and not moe):  # [L, n, rows, c] -> [L, rows, d_out]
                    port = torch.cat(list(port.unbind(1)), dim=-1)
                _same(port, want)
        if moe:
            _same(s.layers.moe_gate, _jax_shard(jshard.layers.moe_gate, dev))
        for key in ("embedding", "rms_final", "rope_cos", "rope_sin"):
            _same(getattr(s, key), _jax_shard(getattr(jshard, key), dev))
        if kind == "dense":
            _same(s.wcls, _jax_shard(jshard.wcls, dev))
    # the KV cache: random contents, lanes over dp, slots over sp, heads over tp
    rng = np.random.default_rng(0)
    full = rng.standard_normal((2, cfg.n_layers, 4, cfg.seq_len + 1, cfg.n_kv_heads,
                                cfg.head_size)).astype(np.float32)
    caches = shard_kv_cache(KVCache(k=torch.from_numpy(full[0]), v=torch.from_numpy(full[1])),
                            mesh)
    jc = jax.device_put(JKVCache(k=jnp.asarray(full[0][:, :, :-1]),
                                 v=jnp.asarray(full[1][:, :, :-1])), j_cache_shardings(jmesh))
    for r, c in enumerate(caches):
        for port, jx, whole in ((c.k, jc.k, full[0]), (c.v, jc.v, full[1])):
            want = _jax_shard(jx, devices[r])
            np.testing.assert_array_equal(port[:, :, :-1].numpy(), want)
            t = mesh.coords(r)["tp"]
            h = cfg.n_kv_heads // mesh.tp
            d = mesh.coords(r)["dp"]
            bl = 4 // mesh.shape["dp"]
            np.testing.assert_array_equal(  # the scratch slot: the full cache's
                port[:, :, -1].numpy(), whole[:, d * bl:(d + 1) * bl, -1, t * h:(t + 1) * h])


# -- sequence-parallel attention -----------------------------------------------


def _sp_case(t, seed, s=64):
    rng = np.random.default_rng(seed)
    b, n_kv, g, hd = 4, 2, 2, 8
    q = rng.standard_normal((b, t, n_kv, g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, n_kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, n_kv, hd)).astype(np.float32)
    # lane 0's rows lie in block 0 only; the others reach further blocks
    pos = np.asarray([[0], [13], [40], [63]], np.int64) + np.arange(t)[None, :] * (
        np.asarray([[0], [1], [2], [0]]))
    return q, k, v, np.minimum(pos, s - 1), 1.0 / hd ** 0.5


@pytest.mark.parametrize("t", [1, 4, 16])
def test_sp_stats_and_combine_match_jax_sp_attention(t):
    """Per-lane positions, one lane's rows in block 0 only (its other blocks
    empty: l = 0): the port's block stats on each sp rank (the stats form's
    plain version for T = 1 and the window, ``block_stats`` for a prompt
    chunk) combined by ``sp_attention`` over the sp groups equal JAX
    ``sp_attention`` on MeshPlan(dp=2, tp=2, sp=2) within 1e-5."""
    q, k, v, pos, scale = _sp_case(t, seed=t)
    jmesh = j_make_mesh(JaxPlan(dp=2, tp=2, sp=2))
    want = np.asarray(j_sp_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(pos, jnp.int32), jmesh, scale))
    sp, blk = 2, k.shape[1] // 2
    mesh = make_mesh(MeshPlan(sp=sp), ["cpu"] * sp)
    stats = []
    for r in range(sp):
        kb, vb = (torch.from_numpy(x[:, r * blk:(r + 1) * blk].copy()) for x in (k, v))
        local = torch.from_numpy(pos) - r * blk
        qf = torch.from_numpy(q)
        if t <= cuda_attn.WINDOW:
            stats.append(cuda_attn.decode_attention_stats(qf, kb, vb, local, scale, blk))
        else:
            mask = torch.arange(blk)[None, None, :] <= local[:, :, None]
            stats.append(cuda_attn.block_stats(qf, kb, vb, mask, scale))
    if t == 1:
        o, l, m = stats[1]
        assert (l[0] == 0).all() and torch.isinf(m[0]).all() and (o[0] == 0).all()
    rc.reset_counts()
    got = sp_attention(stats, mesh.sp_groups())
    assert rc.ring_counts()["ring_hop_plain_calls"] == sp * (sp - 1)
    assert torch.equal(got[0], got[1])  # every sp rank holds the same output
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-5, rtol=1e-5)
    # a rank with no slot adds nothing: dropping its empty stats changes no bit
    if t == 1:
        assert torch.equal(combine_stats([(o[:1], l[:1], m[:1]) for o, l, m in stats[:1]]),
                           got[0][:1])


def test_stats_form_plain_is_block_stats_with_shifted_positions():
    """The stats form's plain version over a block equals ``block_stats``
    under the shifted mask; its output is the dense attention's over the
    same slots, normalised."""
    q, k, v, pos, scale = _sp_case(4, seed=9)
    qf, kf, vf = (torch.from_numpy(x) for x in (q, k, v))
    o, l, m = cuda_attn.decode_attention_stats(qf, kf, vf, torch.from_numpy(pos), scale, 64)
    dense = cuda_attn.decode_attention_plain(qf, kf, vf, torch.from_numpy(pos), scale, 64)
    np.testing.assert_allclose(o.numpy(), dense.numpy(), atol=1e-6)
    assert (l >= 1).all() and torch.isfinite(m).all()


# -- the forward ----------------------------------------------------------------


def _steps(cfg):
    """A 7-token prompt chunk on 4 lanes at different offsets (one lane near
    seq_len's second half), two decode steps and a verify window."""
    tokens = np.asarray([PROMPT, PROMPT[::-1], PROMPT, PROMPT[1:] + [7]], np.int64)
    base = np.asarray([0, 3, cfg.seq_len // 2 - 4, cfg.seq_len - 12], np.int64)[:, None]
    positions = base + np.arange(7)
    yield tokens, positions
    last = positions[:, -1:]
    yield np.asarray([[11], [40], [7], [90]], np.int64), last + 1
    yield np.asarray([[12], [41], [8], [91]], np.int64), last + 2
    yield (np.asarray([[1, 2, 3, 4]] * 4, np.int64), last + 3 + np.arange(4))


def _jax_logits(jcfg, jp, jmesh, q80):
    sp = j_shard(jp, jmesh)
    cache = jax.device_put(j_init_cache(jcfg, 4), j_cache_shardings(jmesh))
    fwd = jax.jit(lambda p, t, q, c: j_forward(jcfg, p, t, q, c, mesh=jmesh, q80_sync=q80,
                                                emulate_q80_activations=q80))
    out = []
    for tokens, positions in _steps(jcfg):
        logits, cache = fwd(sp, jnp.asarray(tokens, jnp.int32),
                            jnp.asarray(positions, jnp.int32), cache)
        out.append(np.asarray(logits))
    return out


def _port_logits(cfg, params, mesh=None, **kw):
    if mesh is None:
        cache = init_kv_cache(cfg, 4, device="cpu")
    else:
        params = shard_params(params, mesh)
        cache = shard_kv_cache(init_kv_cache(cfg, 4, device="cpu"), mesh)
    out = []
    for tokens, positions in _steps(cfg):
        logits, _ = llama_forward(cfg, params, torch.from_numpy(tokens),
                                  torch.from_numpy(positions), cache, mesh=mesh, **kw)
        out.append(logits.numpy())
    return out


@pytest.mark.parametrize("name,model,kind,q80", [
    ("dp2tp2sp2", "tiny", "packed", False), ("dp2tp2sp2", "tiny", "packed", True),
    ("dp2tp2sp2", "tiny", "dense", False), ("tp2sp4", "tiny", "packed", False),
    ("tp2sp4", "tiny", "packed", True), ("tp2ep2", "moe", "dense", False),
    ("tp2ep2", "moe", "packed", False), ("tp2ep2", "moe", "packed", True)])
def test_forward_matches_jax_on_the_same_mesh(models, name, model, kind, q80):
    """Prompt-chunk, decode and verify-window logits of the port's forward on
    the mesh against the JAX forward on the same mesh: within atol 2e-4, or
    under --buffer-float-type q80 within 2e-2 of max|logits|."""
    jcfg, jp, cfg, tparams = models[model, kind]
    mesh, jmesh = _meshes(name)
    want = _jax_logits(jcfg, jp, jmesh, q80)
    rc.reset_counts()
    got = _port_logits(cfg, tparams, mesh, q80_sync=q80, emulate_q80_activations=q80)
    assert rc.ring_counts()["ring_hop_plain_calls"] > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if q80:
            assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max()
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["packed", "dense"])
def test_dp2_tp2_logits_bit_equal_to_tp2(models, kind):
    """dp2 x tp2 runs each dp group's lanes as tp2 runs them: the same bits."""
    _, _, cfg, tparams = models["tiny", kind]
    dp = _port_logits(cfg, tparams, make_mesh(MeshPlan(dp=2, tp=2), ["cpu"] * 4))
    tp = _port_logits(cfg, tparams, make_mesh(MeshPlan(tp=2), ["cpu"] * 2))
    for a, b in zip(dp, tp):
        assert np.array_equal(a, b)


def test_ep_path_never_unpacks_q40(models, monkeypatch):
    """tp2 x ep2 over packed experts, a decode-shaped and a 64-row chunk:
    every rank loops over its own two experts' packed planes (the JAX ep
    branch at every T), never ``unpack_q40``."""
    _, _, cfg, tparams = models["moe", "packed"]
    mesh = make_mesh(MeshPlan(tp=2, ep=2), ["cpu"] * 4)
    params = shard_params(tparams, mesh)
    assert all(p.layers.w1.packed.shape[1] == cfg.n_experts // 2 for p in params)

    def boom(*a, **k):
        raise AssertionError("unpack_q40 called on the ep path")

    loops = []
    loop = t_llama._moe_ffn_loop
    monkeypatch.setattr(t_llama, "unpack_q40", boom)
    monkeypatch.setattr(t_packed, "unpack_q40", boom)
    monkeypatch.setattr(t_llama, "_moe_ffn_loop",
                        lambda *a, **k: loops.append(k.get("first")) or loop(*a, **k))
    for t in (1, 64):
        cache = shard_kv_cache(init_kv_cache(cfg, 1, device="cpu"), mesh)
        tokens = torch.arange(t)[None] % cfg.vocab_size
        logits, _ = llama_forward(cfg, params, tokens, torch.arange(t)[None], cache, mesh=mesh)
        assert torch.isfinite(logits).all()
    # every layer, every rank: first expert 0 on ep rank 0, 2 on ep rank 1
    assert sorted(set(loops)) == [0, 2] and len(loops) == 2 * cfg.n_layers * mesh.n_ranks


# -- the engine -------------------------------------------------------------------


def _lane_rollout(engine, lane, prompt, n):
    _, g, pos = engine.prefill(lane, prompt)
    toks = [int(g)]
    tokens = np.zeros(engine.n_lanes, np.int32)
    positions = np.full(engine.n_lanes, engine.config.seq_len, np.int32)
    for _ in range(n - 1):
        tokens[lane], positions[lane] = toks[-1], pos
        _, greedy, _ = engine.decode(tokens, positions)
        toks.append(int(greedy[lane]))
        pos += 1
    return toks


def test_greedy_engine_dp2_tp2_sp2_matches_the_jax_engine(models):
    """Greedy tokens of the port engine on dp2 x tp2 x sp2, on a lane of each
    dp group (the stream crossing the sp blocks' boundary at slot 32), equal
    the JAX engine's on the same mesh (JAX tests/test_ring_attention.py's
    engine check) and the port's one-device engine's."""
    jcfg, jp, cfg, tparams = models["tiny", "packed"]
    mesh, jmesh = _meshes("dp2tp2sp2")
    engine = InferenceEngine(cfg, shard_params(tparams, mesh), n_lanes=4,
                             prefill_buckets=(8, 16), mesh=mesh)
    jengine = JaxEngine(jcfg, j_shard(jp, jmesh), n_lanes=4, prefill_buckets=(8, 16),
                        mesh=jmesh)
    single = InferenceEngine(cfg, tparams, n_lanes=4, prefill_buckets=(8, 16), device="cpu")
    prompt = PROMPT * 3  # 21 tokens: the stream crosses slot 32
    for lane in (0, 3):
        got = _lane_rollout(engine, lane, prompt, 20)
        assert got == _lane_rollout(jengine, lane, prompt, 20)
        assert got == _lane_rollout(single, lane, prompt, 20)
    # a prefix copied across dp groups (lane 3 -> lane 1) reads back the same
    engine.copy_lane(3, 1, len(prompt))
    held = dict(zip(mesh.local_ranks, engine.cache))
    for r, c in held.items():
        co = mesh.coords(r)
        if co["dp"] == 0:
            src = held[mesh.rank(**{**co, "dp": 1})]
            m = max(0, min(32, len(prompt) - co["sp"] * 32))
            assert torch.equal(c.k[:, 1, :m], src.k[:, 1, :m])


def test_sync_bytes_per_decode_is_what_the_shapes_reckon(models):
    """One decode step of dp2 x tp2 x sp2 moves, per tp group (dp x sp of
    them, B/dp lanes each), the wo/w2 all-reduces' (n-1) * 4 * b * 4 * L *
    dim bytes; per sp group (dp x tp), each rank's [b, n_kv/tp, G, hd + 2]
    f32 stats to the other sp rank each layer; per dp group, the logits
    gather's (n-1) * 4 * b * vocab."""
    _, _, cfg, tparams = models["tiny", "packed"]
    mesh, _ = _meshes("dp2tp2sp2")
    lanes = 4
    engine = InferenceEngine(cfg, shard_params(tparams, mesh), n_lanes=lanes, mesh=mesh)
    engine.prefill(0, PROMPT)
    rc.reset_counts()
    engine.decode(np.zeros(lanes, np.int64), np.asarray([7, cfg.seq_len, 33, cfg.seq_len]))
    dp, n, sp = 2, 2, 2
    b = lanes // dp
    group = cfg.n_heads // cfg.n_kv_heads
    tp_sync = dp * sp * (n - 1) * 4 * b * 4 * cfg.n_layers * cfg.dim
    sp_stats = dp * n * sp * (sp - 1) * 4 * b * (cfg.n_kv_heads // n) * group * (
        cfg.head_size + 2) * cfg.n_layers
    logits = dp * (n - 1) * 4 * b * cfg.vocab_size
    want = tp_sync + sp_stats + logits
    assert engine.stats.sync_bytes_per_decode == want == rc.ring_counts()["ring_hop_bytes"]


# -- the server and the refusals -------------------------------------------------

BODIES = [
    ("/v1/completions", {"prompt": "hello world", "max_tokens": 12, "temperature": 0}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi there"}],
                              "max_tokens": 10, "temperature": 0}),
    ("/v1/completions", {"prompt": "the quick brown fox", "max_tokens": 9,
                         "temperature": 0, "stream": True}),
    ("/v1/completions", {"prompt": "a b c d e f g h i j k l m n", "max_tokens": 24,
                         "temperature": 0.8, "seed": 5}),
]


def _serve(tiny_model, *extra):
    from distributed_llama_multiusers_tpu_torch.app.args import build_parser
    from distributed_llama_multiusers_tpu_torch.server import ApiServer

    args = build_parser("dllama-api").parse_args(
        ["--model", tiny_model["model"], "--tokenizer", tiny_model["tokenizer"],
         "--device", "cpu", "--max-lanes", "4", *extra])
    _, _, tok, engine = runtime_setup.load_stack(args)
    sched = runtime_setup.make_scheduler(engine, tok)
    httpd = ApiServer(sched, tok, model_name="tiny").serve(host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return sched, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def _concurrent(base, bodies):
    out, errors = [None] * len(bodies), []

    def worker(i, route, body):
        try:
            raw = _post(base + route, body).decode()
            if body.get("stream"):  # the streamed deltas' text, byte for byte
                raw = "".join(json.loads(line[6:])["choices"][0].get("text") or ""
                              for line in raw.splitlines() if line.startswith("data: {"))
            else:
                raw = json.dumps(json.loads(raw)["choices"])
            out[i] = raw
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


def test_server_dp2_tp2_sp2_byte_identical_to_one_device(tiny_model, capsys):
    """Four concurrent requests (greedy, chat, streamed, seeded sampled)
    through ``dllama_api --workers dp2,tp2,sp2 --device cpu`` give the
    one-device server's bytes; the log says which sync runs."""
    servers = [_serve(tiny_model, "--workers", "dp2,tp2,sp2"), _serve(tiny_model)]
    log = capsys.readouterr().out
    assert "Mesh: dp=2 pp=1 tp=2 sp=2 ep=1" in log and "Ring TP sync" not in log
    assert "ring all-reduce within each tp group" in log and "sp=2: each rank holds" in log
    try:
        mesh_out = _concurrent(servers[0][2], BODIES)
        single = _concurrent(servers[1][2], BODIES)
        assert mesh_out == single and all(mesh_out)
        with urllib.request.urlopen(servers[0][2] + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["mesh"]["sp"] == 2 and len(stats["mesh"]["devices"]) == 8
        assert stats["ring_hop_plain_calls"] > 0 and stats["sync_bytes_per_decode"] > 0
    finally:
        for sched, httpd, _ in servers:
            httpd.shutdown()
            sched.stop()


def test_paged_pages_on_an_ep_mesh_equal_tp2(models):
    """A paged engine on tp2 x ep2 (each tp slice's pool held by both ep
    ranks): a prompt's prefill logits and its exported page bytes equal the
    tp2 paged engine's; an imported page lands in every ep copy."""
    _, _, cfg, tparams = models["moe", "dense"]
    prompt = PROMPT * 3
    out = []
    for plan in (MeshPlan(tp=2), MeshPlan(tp=2, ep=2)):
        mesh = make_mesh(plan, ["cpu"] * plan.n_devices)
        eng = InferenceEngine(cfg, shard_params(tparams, mesh), n_lanes=2,
                              prefill_buckets=(8, 16), mesh=mesh, paged_kv=True,
                              kv_page_size=8)
        eng.paged_admit(0, prompt, 24)
        logits, _, _ = eng.prefill(0, prompt)
        pages = eng.kvpool.lane_blocks(0)
        out.append((eng, logits, [bytes(eng.export_kv_page(p)) for p in pages], pages))
    (tp, want, data, pages), (ep, got, ep_data, _) = out
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    assert len(ep_data[0]) == len(data[0]) and all(ep_data)
    ep.import_kv_page(pages[0], data[1])
    assert bytes(ep.export_kv_page(pages[0])) == data[1]
    copies = [c.k[:, pages[0]] for r, c in zip(ep.mesh.local_ranks, ep.cache)
              if ep.mesh.coords(r)["tp"] == 1]
    assert torch.equal(copies[0], copies[1])


def _cli_text(argv, capsys) -> str:
    from distributed_llama_multiusers_tpu_torch.app import dllama

    capsys.readouterr()
    dllama.main(argv)
    out = capsys.readouterr().out
    body = out.split("🔷 Eval", 1)[1].split("\n", 1)[1].split("\n⏱ Evaluation", 1)[0]
    return out, re.sub(r"🔶 Pred [^\n]*\n", "", body)


@pytest.mark.parametrize("workers", ["dp2,tp2,sp2", "tp2,sp4"])
def test_cli_inference_on_a_mesh_equals_one_rank(tiny_model, capsys, workers):
    """``dllama inference --workers ... --device cpu`` (speculation on, its
    one lane beside a parked lane a dp group): the one-rank greedy text,
    every Pred line with the Sync readout of the mesh's hop bytes."""
    common = ["inference", "--model", tiny_model["model"], "--tokenizer",
              tiny_model["tokenizer"], "--prompt", "hello world hello world hello",
              "--steps", "40", "--benchmark", "--temperature", "0", "--device", "cpu"]
    _, one = _cli_text(common, capsys)
    out, got = _cli_text(common + ["--workers", workers], capsys)
    assert got == one and got.strip()
    assert re.search(r"Sync +[0-9.]+ kB/chip \(\d+ collectives\)", out)


def test_refusals(models, tiny_model, capsys):
    """Paged KV on dp and sp meshes, pp anywhere, dp/sp/ep in a pod, and lanes
    that do not split over dp are refused, naming their ROADMAP items."""
    _, _, cfg, tparams = models["tiny", "packed"]
    for plan in (MeshPlan(dp=2, tp=2), MeshPlan(tp=2, sp=2)):
        mesh = make_mesh(plan, ["cpu"] * plan.n_devices)
        with pytest.raises(ValueError, match="paged_kv requires a pure-TP mesh"):
            InferenceEngine(cfg, shard_params(tparams, mesh), n_lanes=4, mesh=mesh,
                            paged_kv=True)
    mesh = make_mesh(MeshPlan(dp=2, tp=2), ["cpu"] * 4)
    with pytest.raises(ValueError, match="do not split over dp=2"):
        InferenceEngine(cfg, shard_params(tparams, mesh), n_lanes=3, mesh=mesh)
    with pytest.raises(ValueError, match="ROADMAP A9.2"):
        make_mesh(MeshPlan(pp=2, tp=2), ["cpu"] * 4)
    with pytest.raises(ValueError, match="ROADMAP A9.1"):
        make_mesh(MeshPlan(dp=2, tp=2), ["cpu"] * 2, process_index=0, num_processes=2)
    args = types.SimpleNamespace(workers=["dp2,tp2"], coordinator="127.0.0.1:1",
                                 num_processes=2, process_id=0)
    with pytest.raises(SystemExit) as e:
        runtime_setup.join_pod(args)
    assert e.value.code == 2 and "ROADMAP A9.1" in capsys.readouterr().err
