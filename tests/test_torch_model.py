"""The port's model path against the JAX package on the tiny model: codec,
file writers, parameter carry-over, llama_forward logits (packed and dense
weights, prefill and decode) and a greedy stream through both engines and
the numpy oracle.

The JAX forward runs its Pallas kernel in interpret mode with the exact f32
dot; the port on the CPU runs the kernels' plain versions, also with an
exact f32 dot. Logits agree to atol 1e-4 (f32 summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_multiusers_tpu.formats import load_model_header as j_load_header
from distributed_llama_multiusers_tpu.formats import synthetic as j_syn
from distributed_llama_multiusers_tpu.formats.model_file import RopeType
from distributed_llama_multiusers_tpu.models import init_kv_cache as j_init_cache
from distributed_llama_multiusers_tpu.models import llama_forward as j_forward
from distributed_llama_multiusers_tpu.models import loader as j_loader
from distributed_llama_multiusers_tpu.models.oracle import OracleLlama, oracle_weights_from_m
from distributed_llama_multiusers_tpu.ops import linear as j_linear
from distributed_llama_multiusers_tpu.ops import rope as j_rope
from distributed_llama_multiusers_tpu.quants import codec as j_codec
from distributed_llama_multiusers_tpu.runtime import InferenceEngine as JaxEngine
from distributed_llama_multiusers_tpu.utils.testing import greedy_rollout
from distributed_llama_multiusers_tpu_torch.formats import load_model_header
from distributed_llama_multiusers_tpu_torch.formats import synthetic as t_syn
from distributed_llama_multiusers_tpu_torch.models import (
    init_kv_cache,
    llama_forward,
    load_params_from_m,
    load_params_from_m_quantized,
    params_from_jax_numpy,
    params_from_random,
)
from distributed_llama_multiusers_tpu_torch.models.config import LlamaConfig
from distributed_llama_multiusers_tpu_torch.ops import cuda_q40
from distributed_llama_multiusers_tpu_torch.ops import rope as t_rope
from distributed_llama_multiusers_tpu_torch.quants import codec as t_codec
from distributed_llama_multiusers_tpu_torch.quants.packed import PackedQ40
from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine

PROMPT = [5, 9, 3, 17, 2, 44, 101]


def _seeded(n, seed=123):
    rng = np.random.default_rng(seed)
    return (rng.random(n, dtype=np.float32) * 2 - 1).astype(np.float32)


# -- codec and files ---------------------------------------------------------


@pytest.mark.parametrize("seed", [7, 11, 123])
def test_codec_bit_exact(seed):
    """The port's numpy codec gives the JAX package's bytes: Q40, and Q80
    in both rounding modes (runtime: half away from zero; converter: ties
    to even), on the JAX package's quant-test vectors and on exact ties."""
    x = _seeded(32 * 64, seed)
    assert t_codec.quantize_q40(x).tobytes() == j_codec.quantize_q40(x).tobytes()
    for mode in ("runtime", "converter"):
        assert (t_codec.quantize_q80(x, mode=mode).tobytes()
                == j_codec.quantize_q80(x, mode=mode).tobytes())
    ties = np.zeros(32, np.float32)
    ties[:4] = [127.0, 0.5, -0.5, 1.5]
    vr, _ = t_codec.q80_to_planar(t_codec.quantize_q80(ties, mode="runtime"))
    vc, _ = t_codec.q80_to_planar(t_codec.quantize_q80(ties, mode="converter"))
    assert list(vr[0, 1:4]) == [1, -1, 2] and list(vc[0, 1:4]) == [0, 0, 2]
    blocks = j_codec.quantize_q40(x)
    np.testing.assert_array_equal(t_codec.dequantize_q40(blocks), j_codec.dequantize_q40(blocks))


@pytest.mark.parametrize("kind", ["tiny", "llama31", "qkv_bias"])
def test_written_files_byte_identical(kind, tmp_path):
    """The port's .m/.t writers produce the JAX writers' bytes."""
    kw = {"tiny": {}, "llama31": {"rope_type": RopeType.LLAMA3_1, "dim": 128,
                                   "n_heads": 4, "n_kv_heads": 1},
          "qkv_bias": {"qkv_bias": 1}}[kind]
    jh = j_syn.tiny_header(**kw)
    th = t_syn.tiny_header(**kw)
    j_syn.write_synthetic_model(str(tmp_path / "j.m"), jh, seed=3)
    t_syn.write_synthetic_model(str(tmp_path / "t.m"), th, seed=3)
    j_syn.write_synthetic_tokenizer(str(tmp_path / "j.t"), vocab_size=jh.vocab_size)
    t_syn.write_synthetic_tokenizer(str(tmp_path / "t.t"), vocab_size=th.vocab_size)
    for ext in ("m", "t"):
        assert (tmp_path / f"j.{ext}").read_bytes() == (tmp_path / f"t.{ext}").read_bytes()
    assert vars(load_model_header(str(tmp_path / "j.m"))) == vars(
        j_load_header(str(tmp_path / "j.m")))


def test_packed_planes_byte_equal():
    """pack_q40_planar and pack_q40_from_blocks (the loader's repack of the
    file's block bytes) give the JAX packers' planes byte for byte."""
    from distributed_llama_multiusers_tpu.quants.packed import pack_q40_planar as j_pack
    from distributed_llama_multiusers_tpu_torch.quants.packed import (
        pack_q40_from_blocks,
        pack_q40_planar,
        unpack_q40,
    )

    d_out, d_in = 48, 96
    w = _seeded(d_out * d_in, seed=5).reshape(d_out, d_in)
    blocks = j_codec.quantize_q40(w.reshape(-1))
    values, scales = j_codec.q40_to_planar(blocks)
    values, scales = values.reshape(d_out, d_in), scales.reshape(d_out, d_in // 32)
    jp, js = j_pack(values, scales)
    tp, ts = pack_q40_planar(values, scales)
    np.testing.assert_array_equal(tp, np.asarray(jp))
    np.testing.assert_array_equal(ts.view(np.uint16), np.asarray(js).view(np.uint16))
    bp, bs = pack_q40_from_blocks(blocks, (d_out, d_in), device="cpu")
    np.testing.assert_array_equal(bp.numpy(), tp)
    np.testing.assert_array_equal(bs.numpy().view(np.uint16), ts.view(np.uint16))
    dense = unpack_q40(PackedQ40(bp, bs)).numpy()
    np.testing.assert_array_equal(dense, j_codec.dequantize_q40(blocks).reshape(d_out, d_in).T)


def test_rope_cache_llama31_scaling_matches():
    """Llama-3.1 frequency scaling at the 1B's settings (factor 32, low 1,
    high 4, original length 8192)."""
    args = (2048, 64, 500000.0, 32.0, 1.0, 4.0, 8192)
    jc, js = j_rope.build_rope_cache(*args)
    tc, ts = t_rope.build_rope_cache(*args)
    np.testing.assert_array_equal(np.asarray(tc), np.asarray(jc))
    np.testing.assert_array_equal(np.asarray(ts), np.asarray(js))


def test_rope_clamps_out_of_range_positions():
    cos, sin = t_rope.build_rope_cache(8, 4, 10000.0)
    cos, sin = torch.from_numpy(cos), torch.from_numpy(sin)
    x = torch.ones(1, 2, 1, 4)
    pos = torch.tensor([[7, 9]])  # 9 is past the table: JAX clamps the gather
    y = t_rope.apply_rope(x, cos, sin, pos)
    torch.testing.assert_close(y[:, 1], y[:, 0])


# -- parameters and forward --------------------------------------------------


@pytest.fixture(scope="module")
def jax_params(tiny_model):
    h = j_load_header(tiny_model["model"])
    config, dense = j_loader.load_params_from_m(tiny_model["model"], h, dtype=jnp.float32)
    _, packed = j_loader.load_params_from_m_quantized(tiny_model["model"], h,
                                                      dtype=jnp.float32)
    return config, {"dense": dense, "packed": packed}


@pytest.fixture(scope="module")
def torch_params(tiny_model):
    h = load_model_header(tiny_model["model"])
    config, dense = load_params_from_m(tiny_model["model"], h, dtype=torch.float32,
                                       device="cpu")
    _, packed = load_params_from_m_quantized(tiny_model["model"], h, dtype=torch.float32,
                                             device="cpu")
    assert isinstance(packed.layers.wq, PackedQ40) and isinstance(packed.wcls, PackedQ40)
    return config, {"dense": dense, "packed": packed}


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_params_from_jax_numpy_round_trip(kind, jax_params, torch_params):
    """The JAX tree with numpy leaves carries over unchanged, and equals the
    port's own loader on the same file (the JAX packed wcls is padded to a
    TPU tile width; the port's is not)."""
    _, jp = jax_params
    _, tp = torch_params
    got = params_from_jax_numpy(_np_tree(jp[kind]), device="cpu")
    mine = tp[kind]

    def same(a, b):
        if isinstance(b, PackedQ40):
            assert isinstance(a, PackedQ40)
            d_out = b.d_out
            assert torch.equal(a.packed[..., :d_out], b.packed)
            assert torch.equal(a.scales[..., :d_out], b.scales)
        elif b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)

    for key in ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "rms_att", "rms_ffn", "bq"):
        same(getattr(got.layers, key), getattr(mine.layers, key))
    for key in ("embedding", "rms_final", "wcls", "rope_cos", "rope_sin"):
        same(getattr(got, key), getattr(mine, key))


def _jax_logits(config, params, tokens, positions, cache):
    j_linear.set_pallas_interpret(True)
    try:
        logits, cache = j_forward(config, params, jnp.asarray(tokens, jnp.int32),
                                  jnp.asarray(positions, jnp.int32), cache)
    finally:
        j_linear.set_pallas_interpret(False)
    return np.asarray(logits), cache


@pytest.mark.parametrize("kind", ["packed", "dense"])
def test_forward_logits_match_jax(kind, jax_params, torch_params):
    """Prefill of a 7-token prompt, then two decode steps, on both lanes of
    a 2-lane batch at different positions."""
    jconfig, jp = jax_params
    config, tp = torch_params
    jcache = j_init_cache(jconfig, 2)
    tcache = init_kv_cache(config, 2, device="cpu")
    tokens = np.asarray([PROMPT, PROMPT[::-1]], np.int64)
    positions = np.asarray([np.arange(7), np.arange(7) + 3], np.int64)
    cuda_q40.reset_counts()
    for step in range(3):
        if step:
            tokens = np.asarray([[11 + step], [40 + step]], np.int64)
            positions = positions[:, -1:] + 1
        ref, jcache = _jax_logits(jconfig, jp[kind], tokens, positions, jcache)
        got, _ = llama_forward(config, tp[kind], torch.from_numpy(tokens),
                               torch.from_numpy(positions), tcache)
        assert got.shape == ref.shape == (2, tokens.shape[1], config.vocab_size)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)
    plain = cuda_q40.kernel_counts()["kernel_plain_calls"]["q40_slab"]
    assert plain == (3 * (7 * config.n_layers + 1) if kind == "packed" else 0)


def test_shared_acts_per_layer(torch_params, monkeypatch):
    """One operand build feeds wq/wk/wv and one feeds w1/w3 in every layer;
    wo, w2 and wcls build their own."""
    from distributed_llama_multiusers_tpu_torch.ops import linear

    config, tp = torch_params
    builds, prebuilt = [], []
    init = cuda_q40.Q80Acts.__init__

    def counting_init(self, x):
        builds.append(x.shape[-1])
        init(self, x)

    def spy_matmul(x, w, w_dtype=None):
        prebuilt.append(isinstance(x, cuda_q40.Q80Acts))
        return cuda_q40.q40_matmul(x, w, w_dtype)

    monkeypatch.setattr(cuda_q40.Q80Acts, "__init__", counting_init)
    monkeypatch.setattr(linear, "q40_matmul", spy_matmul)
    llama_forward(config, tp["packed"], torch.tensor([[3, 9, 27]]),
                  torch.tensor([[0, 1, 2]]), init_kv_cache(config, 1, device="cpu"))
    L = config.n_layers
    assert len(builds) == L * 2 + L * 2 + 1
    assert len(prebuilt) == 7 * L + 1
    assert sum(prebuilt) == 5 * L  # wq, wk, wv, w1, w3 take a shared bundle


def test_params_from_random_shapes():
    h = t_syn.tiny_header()
    config = LlamaConfig.from_header(h)
    p = params_from_random(config, seed=0, dtype=torch.float32, device="cpu")
    assert tuple(p.layers.w1.shape) == (2, 64, 128)
    assert tuple(p.wcls.shape) == (64, 128)
    logits, _ = llama_forward(config, p, torch.tensor([[1, 2]]), torch.tensor([[0, 1]]),
                              init_kv_cache(config, 1, device="cpu"))
    assert torch.isfinite(logits).all()


# -- greedy streams -----------------------------------------------------------


@pytest.mark.parametrize("kind", ["packed", "dense"])
def test_greedy_stream_matches_jax_engine_and_oracle(kind, tiny_model, jax_params,
                                                     torch_params):
    jconfig, jp = jax_params
    config, tp = torch_params
    engine = InferenceEngine(config, tp[kind], n_lanes=2, prefill_buckets=(8, 16),
                             device="cpu")
    got, _ = greedy_rollout(engine, PROMPT, 16)
    j_linear.set_pallas_interpret(True)
    try:
        jengine = JaxEngine(jconfig, jp[kind], n_lanes=2, prefill_buckets=(8, 16))
        ref, _ = greedy_rollout(jengine, PROMPT, 16)
    finally:
        j_linear.set_pallas_interpret(False)
    assert got == ref
    h = j_load_header(tiny_model["model"])
    oracle = OracleLlama(jconfig, oracle_weights_from_m(tiny_model["model"], h),
                         emulate_q80=False)
    assert got == oracle.generate_greedy(PROMPT, 16)


def test_engine_prefill_chunks_match_one_shot(torch_params):
    """A prompt longer than the largest bucket runs in chunks and lands on
    the same logits as one chunk."""
    config, tp = torch_params
    prompt = [(7 * i + 3) % config.vocab_size for i in range(20)]
    one = InferenceEngine(config, tp["packed"], n_lanes=1, prefill_buckets=(32,),
                          device="cpu")
    chunked = InferenceEngine(config, tp["packed"], n_lanes=1, prefill_buckets=(4, 8),
                              device="cpu")
    a, ga, pa = one.prefill(0, prompt)
    b, gb, pb = chunked.prefill(0, prompt)
    assert (ga, pa) == (gb, pb) == (ga, 20)
    torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def test_engine_rejects_cuda_without_card(torch_params):
    config, tp = torch_params
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(config, tp["packed"])
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(config, tp["packed"], device="cuda")



# -- host tokenizer, chat, EOS and sampler -----------------------------------

TEXTS = ["hello world", "<|begin_of_text|>hello <|eot_id|> world", "zz\tq\n~!", ""]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_matches_jax(tiny_model, text):
    from distributed_llama_multiusers_tpu.tokenizer import Tokenizer as JaxTokenizer
    from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer

    jt, tt = JaxTokenizer(tiny_model["tokenizer"]), Tokenizer(tiny_model["tokenizer"])
    for kw in ({}, {"add_bos": False}, {"add_special_tokens": False}):
        ids = tt.encode(text, **kw)
        assert ids == jt.encode(text, **kw)
    jd, td = jt.make_stream_decoder(), tt.make_stream_decoder()
    assert [td.decode(i) for i in ids] == [jd.decode(i) for i in ids]


def test_chat_templates_and_eos_match_jax(tiny_model):
    from distributed_llama_multiusers_tpu import tokenizer as jtok
    from distributed_llama_multiusers_tpu_torch import tokenizer as ttok

    items = [("system", "be brief"), ("user", "hi"), ("assistant", "yo"), ("user", "more")]
    for kind in ("LLAMA2", "LLAMA3", "DEEP_SEEK3", "CHATML"):
        jg = jtok.ChatTemplateGenerator(getattr(jtok.TemplateType, kind), None, "<eos>")
        tg = ttok.ChatTemplateGenerator(getattr(ttok.TemplateType, kind), None, "<eos>")
        for gen_prompt in (True, False):
            j = jg.generate([jtok.ChatItem(*i) for i in items], gen_prompt)
            t = tg.generate([ttok.ChatItem(*i) for i in items], gen_prompt)
            assert (t.content, t.public_prompt) == (j.content, j.public_prompt)
    pieces = [(5, "he"), (9, "llo <"), (3, "eo"), (17, "s> and"), (2, "x")]
    jd = jtok.EosDetector([99], ["<eos>"], 1, 1)
    td = ttok.EosDetector([99], ["<eos>"], 1, 1)
    for tok, piece in pieces + [(99, None)]:
        jr, tr = jd.append(tok, piece), td.append(tok, piece)
        assert int(tr) == int(jr)
        assert td.get_delta() == jd.get_delta()
        if int(tr) == int(ttok.EosResult.NOT_EOS):
            jd.reset()
            td.reset()


@pytest.mark.parametrize("temp,topp", [(0.0, 0.9), (0.8, 0.9), (1.2, 1.0)])
def test_host_sampler_matches_jax(temp, topp):
    from distributed_llama_multiusers_tpu.tokenizer import Sampler as JaxSampler
    from distributed_llama_multiusers_tpu_torch.tokenizer import Sampler

    rng = np.random.default_rng(9)
    js, ts = JaxSampler(64, temp, topp, 1234), Sampler(64, temp, topp, 1234)
    for _ in range(20):
        logits = rng.standard_normal(64).astype(np.float32) * 3
        assert ts.sample(logits.copy()) == js.sample(logits.copy())
