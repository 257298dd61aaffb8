"""The port's tensor-parallel path against the JAX package's mesh path and
against its own single-device path: sharding, the TP forward (ring sync on
and off, f32 and Q80 wire), the Q80 activation emulation, a greedy stream
through the TP engine, and the server with ``--workers 2``.

Ranks are CPU "devices" (every rank on ``cpu``), the counterpart of the JAX
package's 8 virtual CPU devices (tests/conftest.py). The JAX forward runs its
Q40 products through their plain reference (``q40_matmul_xla``: the weight
dequantized in f32, one exact f32 product; tests/test_torch_q40.py holds the
port's kernels to the Pallas kernel in interpret mode); the port runs the
kernels' plain versions and the ring hop's plain version.

Tolerances: f32 paths agree to atol 1e-4 of the logits (f32 summation order
of the Q40 partials). Q80 paths to 2e-2 of max|logits|: an input that differs
by 1e-7 can flip one Q80 rounding, one step of a block's scale, and the layers
carry it on (the Q80 class).
"""

import json
import threading
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
from distributed_llama_multiusers_tpu.models.config import LlamaConfig as JaxConfig
from distributed_llama_multiusers_tpu.ops import ring_collective as jrc
from distributed_llama_multiusers_tpu.parallel import MeshPlan as JaxPlan
from distributed_llama_multiusers_tpu.parallel import make_mesh as j_make_mesh
from distributed_llama_multiusers_tpu.parallel.sharding import shard_params as j_shard
from distributed_llama_multiusers_tpu.runtime import InferenceEngine as JaxEngine
from distributed_llama_multiusers_tpu.utils.testing import greedy_rollout
from distributed_llama_multiusers_tpu_torch.app import dllama_api
from distributed_llama_multiusers_tpu_torch.models import (
    init_kv_cache,
    llama_forward,
    params_from_jax_numpy,
)
from distributed_llama_multiusers_tpu_torch.models.config import LlamaConfig
from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc
from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
from distributed_llama_multiusers_tpu_torch.parallel.sharding import (
    shard_kv_cache,
    shard_params,
)
from distributed_llama_multiusers_tpu_torch.quants.packed import PackedQ40
from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine

PROMPT = [5, 9, 3, 17, 2, 44, 101]
TP4_CONFIG = dict(dim=256, hidden_dim=512, n_heads=8, n_kv_heads=4, n_layers=2,
                  vocab_size=128, seq_len=32)


def _trim_wcls(params, vocab: int):
    """The JAX loader pads the packed wcls to a TPU tile width; the port's
    loader does not."""
    w = params.wcls
    if isinstance(w, PackedQ40):
        params.wcls = PackedQ40(w.packed[..., :vocab].contiguous(),
                                w.scales[..., :vocab].contiguous())
    return params


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def models(tiny_model, tmp_path_factory):
    """Packed f32 parameters of both packages, same values: the tiny model
    (tp=2), a wider random model quantized to Q40 (tp=4) and the tiny
    Qwen2-family model with q/k/v biases (tp=2, key "2-qkv_bias")."""
    h = j_load_header(tiny_model["model"])
    jcfg, jtiny = j_loader.load_params_from_m_quantized(tiny_model["model"], h,
                                                        dtype=jnp.float32)
    jcfg4 = JaxConfig(**TP4_CONFIG)
    jwide = j_loader.quantize_params(
        j_loader.params_from_random(jcfg4, seed=0, dtype=jnp.float32, to_device=False,
                                    scale=0.05), to_device=False)
    bias_path = str(tmp_path_factory.mktemp("qkv_bias") / "qwen2.m")
    j_syn.write_synthetic_model(bias_path, j_syn.tiny_header(qkv_bias=1), seed=3)
    jcfgb, jbias = j_loader.load_params_from_m_quantized(bias_path, j_load_header(bias_path),
                                                         dtype=jnp.float32)
    out = {}
    for tp, cfg, jp in ((2, jcfg, jtiny), (4, jcfg4, jwide), ("2-qkv_bias", jcfgb, jbias)):
        tparams = _trim_wcls(params_from_jax_numpy(_np_tree(jp), device="cpu"), cfg.vocab_size)
        out[tp] = (cfg, jp, LlamaConfig(**{k: getattr(cfg, k) for k in
                                           LlamaConfig.__dataclass_fields__}), tparams)
    return out


def _ranks(tp) -> int:
    """The rank count of a ``models`` key (2, 4, or "2-qkv_bias")."""
    return int(str(tp).split("-")[0])


def _mesh(tp):
    return make_mesh(MeshPlan(tp=_ranks(tp)), ["cpu"] * _ranks(tp))


def _steps():
    """Prefill of 7 tokens on both lanes of a 2-lane batch at different
    positions, then one decode step."""
    tokens = np.asarray([PROMPT, PROMPT[::-1]], np.int64)
    positions = np.asarray([np.arange(7), np.arange(7) + 3], np.int64)
    yield tokens, positions
    yield np.asarray([[11], [40]], np.int64), positions[:, -1:] + 1


def _jax_tp_logits(jcfg, jp, tp, ring, q80):
    jmesh = j_make_mesh(JaxPlan(tp=_ranks(tp)))
    sp = j_shard(jp, jmesh)
    cache = j_init_cache(jcfg, 2)
    prev = jrc.ring_sync_enabled()
    jrc.set_ring_sync(ring)
    try:
        fwd = jax.jit(lambda p, t, q, c: j_forward(jcfg, p, t, q, c, mesh=jmesh,
                                                    q80_sync=q80,
                                                    emulate_q80_activations=q80))
        out = []
        for tokens, positions in _steps():
            logits, cache = fwd(sp, jnp.asarray(tokens, jnp.int32),
                                jnp.asarray(positions, jnp.int32), cache)
            out.append(np.asarray(logits))
        return out
    finally:
        jrc.set_ring_sync(prev)


def _port_logits(cfg, params, mesh=None, **kw):
    if mesh is None:
        cache = init_kv_cache(cfg, 2, device="cpu")
    else:
        params = shard_params(params, mesh)
        cache = shard_kv_cache(init_kv_cache(cfg, 2, device="cpu"), mesh)
    out = []
    for tokens, positions in _steps():
        logits, _ = llama_forward(cfg, params, torch.from_numpy(tokens),
                                  torch.from_numpy(positions), cache, mesh=mesh, **kw)
        out.append(logits.numpy())
    return out


@pytest.mark.parametrize("tp", [2, 4, "2-qkv_bias"])
@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("q80", [False, True])
def test_tp_forward_matches_jax_mesh(models, tp, ring, q80):
    """Prefill and decode logits of the port's TP forward against the JAX
    package's llama_forward(mesh=make_mesh(MeshPlan(tp))); "2-qkv_bias" is
    the Qwen2 family at tp=2, its bq/bk/bv row-sliced with wq/wk/wv (the
    JAX package's tests/test_qwen2.py model)."""
    jcfg, jp, cfg, tparams = models[tp]
    if tp == "2-qkv_bias":
        assert tparams.layers.bq is not None and jcfg.qkv_bias
    want = _jax_tp_logits(jcfg, jp, tp, ring, q80)
    rc.reset_counts()
    got = _port_logits(cfg, tparams, _mesh(tp), ring_sync=ring, q80_sync=q80,
                       emulate_q80_activations=q80)
    assert rc.ring_counts()["ring_hop_plain_calls"] > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, w.shape[1], cfg.vocab_size)
        if q80:
            assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max()
        else:
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_forward_matches_single_device(models, tp):
    """The port against itself: the TP forward on tp CPU ranks and the
    single-device forward, f32 wire, within 1e-4."""
    _, _, cfg, tparams = models[tp]
    for g, w in zip(_port_logits(cfg, tparams, _mesh(tp)), _port_logits(cfg, tparams)):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


def test_q80_emulation_single_device_matches_jax(models):
    """--buffer-float-type q80 on one device: the qdq sites of the JAX
    forward, in the Q80 class."""
    jcfg, jp, cfg, tparams = models[2]
    fwd = jax.jit(lambda p, t, q, c: j_forward(jcfg, p, t, q, c,
                                                emulate_q80_activations=True))
    cache = j_init_cache(jcfg, 2)
    want = []
    for tokens, positions in _steps():
        logits, cache = fwd(jp, jnp.asarray(tokens, jnp.int32),
                            jnp.asarray(positions, jnp.int32), cache)
        want.append(np.asarray(logits))
    got = _port_logits(cfg, tparams, emulate_q80_activations=True)
    plain = _port_logits(cfg, tparams)
    for g, w, p in zip(got, want, plain):
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max()
        assert not np.array_equal(g, p)  # the emulation really quantized


@pytest.mark.parametrize("kind", ["packed", "dense"])
def test_shard_params_round_trip(models, kind):
    """Concatenating the shards rebuilds every full plane: row-sliced on
    d_out, col-sliced from the chunk stacks on d_in, replicated as is."""
    _, _, cfg, tparams = models[4]
    if kind == "dense":
        from distributed_llama_multiusers_tpu_torch.models import params_from_random

        tparams = params_from_random(cfg, seed=1, dtype=torch.float32, device="cpu")
    shards = shard_params(tparams, _mesh(4))

    def planes(w):
        return (w.packed, w.scales) if isinstance(w, PackedQ40) else (w,)

    for key in ("wq", "wk", "wv", "w1", "w3"):
        for i, full in enumerate(planes(getattr(tparams.layers, key))):
            got = torch.cat([planes(getattr(s.layers, key))[i] for s in shards], dim=-1)
            assert torch.equal(got, full)
    for key in ("wo", "w2"):
        for i, full in enumerate(planes(getattr(tparams.layers, key))):
            per_rank = [torch.cat(list(planes(getattr(s.layers, key))[i].unbind(1)), dim=-1)
                        for s in shards]  # [L, n, rows/n, c] -> [L, rows/n, d_out]
            assert all(planes(getattr(s.layers, key))[i].is_contiguous() for s in shards)
            assert torch.equal(torch.cat(per_rank, dim=-2), full)
    for i, full in enumerate(planes(tparams.wcls)):
        assert torch.equal(torch.cat([planes(s.wcls)[i] for s in shards], dim=-1), full)
    for s in shards:
        assert torch.equal(s.embedding, tparams.embedding)
        assert torch.equal(s.layers.rms_ffn, tparams.layers.rms_ffn)


def test_shard_params_refuses_split_quant_blocks(models):
    _, _, cfg, tparams = models[2]  # wo d_in 64: 64 / 4 = 16 splits a block
    with pytest.raises(ValueError, match="quant blocks"):
        shard_params(tparams, _mesh(4))


def test_greedy_stream_tp_matches_single_and_jax_mesh(models):
    """16 greedy tokens on the tiny model: the port's TP engine (tp=2, f32
    wire), its single-device engine and the JAX mesh engine agree token for
    token."""
    jcfg, jp, cfg, tparams = models[2]
    mesh = _mesh(2)
    engine = InferenceEngine(cfg, shard_params(tparams, mesh), n_lanes=2,
                             prefill_buckets=(8, 16), mesh=mesh)
    got, _ = greedy_rollout(engine, PROMPT, 16)
    single = InferenceEngine(cfg, tparams, n_lanes=2, prefill_buckets=(8, 16),
                             device="cpu")
    assert got == greedy_rollout(single, PROMPT, 16)[0]
    jmesh = j_make_mesh(JaxPlan(tp=2))
    jengine = JaxEngine(jcfg, j_shard(jp, jmesh), n_lanes=2, prefill_buckets=(8, 16),
                        mesh=jmesh)
    assert got == greedy_rollout(jengine, PROMPT, 16)[0]


def test_sync_bytes_per_decode_is_what_the_shapes_reckon(models):
    """One decode step of a tp=n engine moves, per wo/w2 sync, n-1 hops of
    every rank's reduce chunk and n-1 of its gather chunk, and for the logits
    n-1 hops of every rank's shard: (n-1) * 4 * B * (4 * L * dim + vocab)
    bytes on the f32 wire."""
    _, _, cfg, tparams = models[4]
    n, b = 4, 3
    mesh = _mesh(n)
    engine = InferenceEngine(cfg, shard_params(tparams, mesh), n_lanes=b, mesh=mesh)
    engine.prefill(0, PROMPT)
    rc.reset_counts()
    engine.decode(np.zeros(b, np.int64), np.asarray([7, cfg.seq_len, cfg.seq_len]))
    want = (n - 1) * 4 * b * (4 * cfg.n_layers * cfg.dim + cfg.vocab_size)
    assert engine.stats.sync_bytes_per_decode == want == rc.ring_counts()["ring_hop_bytes"]
    assert rc.ring_counts()["ring_hop_plain_calls"] == n * (n - 1) * (4 * cfg.n_layers + 1)


# -- the server with --workers ------------------------------------------------

BODIES = [
    ("/v1/completions", {"prompt": "hello world", "max_tokens": 12, "temperature": 0}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi there"}],
                              "max_tokens": 10, "temperature": 0}),
    ("/v1/completions", {"prompt": "the quick brown fox", "max_tokens": 9,
                         "temperature": 0, "stream": True}),
]


def _serve(tiny_model, *extra):
    """``dllama_api``'s own stack on the CPU, served from a thread."""
    from distributed_llama_multiusers_tpu_torch.app.args import build_parser
    from distributed_llama_multiusers_tpu_torch.app.runtime_setup import (
        load_stack,
        make_scheduler,
    )
    from distributed_llama_multiusers_tpu_torch.server import ApiServer

    args = build_parser("dllama-api").parse_args(
        ["--model", tiny_model["model"], "--tokenizer", tiny_model["tokenizer"],
         "--device", "cpu", "--max-lanes", "4", *extra])
    _, _, tok, engine = load_stack(args)
    sched = make_scheduler(engine, tok)
    httpd = ApiServer(sched, tok, model_name="tiny").serve(host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return sched, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        raw = r.read().decode()
    if not body.get("stream"):
        return json.loads(raw)["generated_text"] if "generated_text" in raw else raw
    text = ""
    for line in raw.splitlines():
        if line.startswith("data: {"):
            c = json.loads(line[6:])["choices"][0]
            text += c.get("text") or (c.get("delta") or {}).get("content") or ""
    return text


def _concurrent(base, bodies):
    out, errors = [None] * len(bodies), []

    def worker(i, route, body):
        try:
            out[i] = _post(base + route, body)
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


def test_server_workers_2_byte_identical_to_single_device(tiny_model, capsys):
    """Three concurrent greedy requests (one chat, one streamed) through
    ``--workers 2 --device cpu`` give the single-device server's text; /stats
    shows the mesh, the ring hop's calls and the decode step's hop bytes."""
    servers = [_serve(tiny_model, "--workers", "2"), _serve(tiny_model)]
    log = capsys.readouterr().out
    assert "Mesh: dp=1 pp=1 tp=2" in log and "Ring TP sync" in log
    try:
        tp_text = _concurrent(servers[0][2], BODIES)
        single = _concurrent(servers[1][2], BODIES)
        assert tp_text == single and all(tp_text)
        with urllib.request.urlopen(servers[0][2] + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["mesh"]["tp"] == 2 and stats["mesh"]["devices"] == ["cpu", "cpu"]
        assert stats["ring_hop_plain_calls"] > 0 and stats["ring_hop_launches"] == 0
        assert stats["sync_bytes_per_decode"] > 0
        with urllib.request.urlopen(servers[1][2] + "/stats", timeout=30) as r:
            assert json.loads(r.read())["mesh"] is None
    finally:
        for sched, httpd, _ in servers:
            httpd.shutdown()
            sched.stop()


def test_q80_server_announces_the_wire(tiny_model, capsys):
    sched, httpd, _ = _serve(tiny_model, "--workers", "2", "--buffer-float-type", "q80")
    try:
        log = capsys.readouterr().out
        assert "Q80 sync transport" in log and "(Q80 wire)" in log
    finally:
        httpd.shutdown()
        sched.stop()


def test_workers_cli_refuses_what_it_cannot_serve(tiny_model):
    base = ["--model", tiny_model["model"], "--tokenizer", tiny_model["tokenizer"],
            "--port", "0"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dllama_api.main(base + ["--workers", "2", "--device", "cuda"])
    with pytest.raises(ValueError, match="n_kv_heads"):  # tiny: 2 kv heads
        dllama_api.main(base + ["--workers", "3", "--device", "cpu"])
    with pytest.raises(ValueError, match="ROADMAP"):
        dllama_api.main(base + ["--workers", "pp2", "--device", "cpu"])
    with pytest.raises(ValueError, match="one device per rank|list one device"):
        dllama_api.main(base + ["--workers", "2", "--device", "cuda:0"])
    with pytest.raises(ValueError, match="3 devices for 2 ranks"):
        dllama_api.main(base + ["--workers", "2", "--device", "cpu,cpu,cpu"])
