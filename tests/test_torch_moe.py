"""The port's mixture-of-experts models (the JAX package's Mixtral family)
against the JAX package on the CPU: the loaders byte for byte (dense and
Q40, ``params_from_jax_numpy``, ``params_from_random``,
``quantize_params``), the router (``ops/cuda_moe.moe_route``'s plain
version) against ``_moe_topk`` / ``_moe_router_weights``, ``_moe_ffn`` and
which branch of the JAX dispatch each call takes, ``llama_forward`` and
greedy streams, tensor parallelism at tp = 2, and serving (speculation,
the paged KV cache, a grammar-constrained request, ``--workers 2``).

The model is the JAX MoE tests' tiny file (``tests/test_moe.py``: 4
experts, 2 active, seed 3). The JAX side runs as those tests run it: its
Pallas kernel in interpret mode for the packed loop, plain XLA for the
sparse dispatch; the port on the CPU runs its kernels' plain versions.

Tolerance: max|d| <= 1e-4 * max|y| (f32 summation order only: the plain
versions against interpret mode, the class the ROADMAP sets) wherever both
sides run f32; the Q80 activation emulation and the Q80 wire are held to
2e-2 * max|y| (an input 1e-7 apart can flip one Q80 rounding, one step of a
block's scale, which the layers carry on; tests/test_torch_tp.py's class).
"""

import json
import re
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_multiusers_tpu.app import dllama as j_dllama
from distributed_llama_multiusers_tpu.app.args import build_parser as j_build_parser
from distributed_llama_multiusers_tpu.formats import load_model_header as j_load_header
from distributed_llama_multiusers_tpu.formats import synthetic as j_syn
from distributed_llama_multiusers_tpu.models import init_kv_cache as j_init_cache
from distributed_llama_multiusers_tpu.models import llama_forward as j_forward
from distributed_llama_multiusers_tpu.models import llama as j_llama
from distributed_llama_multiusers_tpu.models import loader as j_loader
from distributed_llama_multiusers_tpu.models.config import LlamaConfig as JaxConfig
from distributed_llama_multiusers_tpu.ops import linear as j_linear
from distributed_llama_multiusers_tpu.ops import ring_collective as jrc
from distributed_llama_multiusers_tpu.ops.activations import silu as j_silu
from distributed_llama_multiusers_tpu.parallel import MeshPlan as JaxPlan
from distributed_llama_multiusers_tpu.parallel import make_mesh as j_make_mesh
from distributed_llama_multiusers_tpu.parallel.sharding import shard_params as j_shard
from distributed_llama_multiusers_tpu.quants import packed as j_packed
from distributed_llama_multiusers_tpu.runtime import (
    ContinuousBatchingScheduler as JaxScheduler,
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from distributed_llama_multiusers_tpu.tokenizer import Tokenizer as JaxTokenizer
from distributed_llama_multiusers_tpu.utils.testing import ByteJsonTokenizer as JaxByteTokenizer
from distributed_llama_multiusers_tpu.utils.testing import greedy_rollout
from distributed_llama_multiusers_tpu_torch.app import dllama
from distributed_llama_multiusers_tpu_torch.formats import load_model_header
from distributed_llama_multiusers_tpu_torch.models import (
    init_kv_cache,
    llama_forward,
    load_params_from_m,
    load_params_from_m_quantized,
    params_from_jax_numpy,
    params_from_random,
    quantize_params,
)
from distributed_llama_multiusers_tpu_torch.models import llama as t_llama
from distributed_llama_multiusers_tpu_torch.models import loader as t_loader
from distributed_llama_multiusers_tpu_torch.models.config import LlamaConfig
from distributed_llama_multiusers_tpu_torch.ops import cuda_moe, cuda_q40
from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc
from distributed_llama_multiusers_tpu_torch.ops.activations import silu
from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
from distributed_llama_multiusers_tpu_torch.parallel.sharding import (
    shard_kv_cache,
    shard_params,
)
from distributed_llama_multiusers_tpu_torch.quants import packed as t_packed
from distributed_llama_multiusers_tpu_torch.quants.packed import PackedQ40
from distributed_llama_multiusers_tpu_torch.runtime import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
)
from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer
from distributed_llama_multiusers_tpu_torch.utils.testing import ByteJsonTokenizer

PROMPT = [5, 9, 21, 3, 17]
DECODE_STEPS = 8
TOL = 1e-4  # max|d| <= TOL * max|y|: f32 summation order
Q80_TOL = 2e-2  # the Q80 class (see the module docstring)
E2K1 = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=96,
            seq_len=16, n_experts=2, n_active_experts=1)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, (err, scale)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def moe_model(tmp_path_factory):
    """The JAX MoE tests' tiny file (4 experts, 2 active, seed 3) and a
    tokenizer for it."""
    d = tmp_path_factory.mktemp("moe")
    header = j_syn.tiny_header(n_experts=4, n_active_experts=2)
    path, tok = str(d / "moe.m"), str(d / "moe.t")
    j_syn.write_synthetic_model(path, header, seed=3)
    j_syn.write_synthetic_tokenizer(tok, vocab_size=header.vocab_size)
    return {"model": path, "tokenizer": tok}


@pytest.fixture(scope="module")
def jax_params(moe_model):
    path = moe_model["model"]
    h = j_load_header(path)
    config, dense = j_loader.load_params_from_m(path, h, dtype=jnp.float32)
    _, packed = j_loader.load_params_from_m_quantized(path, h, dtype=jnp.float32)
    return config, {"dense": dense, "packed": packed}


@pytest.fixture(scope="module")
def torch_params(moe_model):
    path = moe_model["model"]
    h = load_model_header(path)
    config, dense = load_params_from_m(path, h, dtype=torch.float32, device="cpu")
    _, packed = load_params_from_m_quantized(path, h, dtype=torch.float32, device="cpu")
    return config, {"dense": dense, "packed": packed}


def _same(a, b):
    """Equal byte for byte: dense leaves (dtype and bits) or packed planes."""
    if isinstance(b, PackedQ40) or hasattr(b, "packed"):
        assert isinstance(a, PackedQ40), type(a)
        np.testing.assert_array_equal(a.packed.numpy(), np.asarray(b.packed))
        np.testing.assert_array_equal(a.scales.numpy().view(np.uint16),
                                      np.asarray(b.scales).view(np.uint16))
    elif b is None:
        assert a is None
    else:
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a.numpy(), b)


_LAYER = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "rms_att", "rms_ffn", "moe_gate")
_TOP = ("embedding", "rms_final", "wcls", "rope_cos", "rope_sin")


def _all_equal(tp, jp):
    for key in _LAYER:
        _same(getattr(tp.layers, key), getattr(jp.layers, key))
    for key in _TOP:
        _same(getattr(tp, key), getattr(jp, key))


# -- loaders -----------------------------------------------------------------


def test_read_m_tensors_equal_jax(moe_model):
    path = moe_model["model"]
    want = j_loader.read_m_tensors(path, j_load_header(path))
    got = t_loader.read_m_tensors(path, load_model_header(path))
    assert sorted(got) == sorted(want)
    for key in want:
        w, g = want[key], got[key]
        if isinstance(w, list):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(g, w)
    assert got["w1"][0].shape == (4, 128, 64) and got["moe_gate"][0].shape == (4, 64)


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_loaders_equal_jax_byte_for_byte(kind, jax_params, torch_params):
    """The dense load ([L, E, d_in, d_out] f32 stacks, the [L, dim, E]
    router) and the Q40 load (planes [L, E, d_in/2, d_out] repacked from the
    file's blocks) equal the JAX loaders' arrays."""
    _, jp = jax_params
    config, tp = torch_params
    _all_equal(tp[kind], jp[kind])
    w1 = tp[kind].layers.w1
    if kind == "packed":
        assert tuple(w1.packed.shape) == (2, 4, 32, 128)
        assert tuple(w1.scales.shape) == (2, 4, 2, 128)
    else:
        assert tuple(w1.shape) == (2, 4, 64, 128)
    assert tuple(tp[kind].layers.moe_gate.shape) == (2, 64, 4)
    assert tp[kind].layers.moe_gate.dtype == torch.float32


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_params_from_jax_numpy_round_trip(kind, jax_params, torch_params):
    _, jp = jax_params
    _, tp = torch_params
    got = params_from_jax_numpy(_np_tree(jp[kind]), device="cpu")
    _all_equal(got, jp[kind])
    _all_equal(got, _np_tree(jp[kind]))
    for key in _LAYER:
        a, b = getattr(got.layers, key), getattr(tp[kind].layers, key)
        if isinstance(a, PackedQ40):
            assert torch.equal(a.packed, b.packed) and torch.equal(a.scales, b.scales)
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("cfg", ["dense", "moe", "moe_e2k1"])
def test_params_from_random_equal_jax(cfg):
    """One seed, the JAX package's draws in its order (the router after
    w3, in f32), the same shapes."""
    kw = {"dense": dict(E2K1, n_experts=0, n_active_experts=0),
          "moe": dict(E2K1, n_experts=4, n_active_experts=2), "moe_e2k1": E2K1}[cfg]
    jp = j_loader.params_from_random(JaxConfig(**kw), seed=5, dtype=jnp.float32,
                                     to_device=False)
    tp = params_from_random(LlamaConfig(**kw), seed=5, dtype=torch.float32, device="cpu")
    _all_equal(tp, jp)
    lead = (2, kw["n_experts"]) if kw["n_experts"] else (2,)
    assert tuple(tp.layers.w1.shape) == (*lead, 64, 128)
    assert tuple(tp.layers.w2.shape) == (*lead, 128, 64)


@pytest.mark.parametrize("cfg", ["dense", "moe", "moe_e2k1", "padded_vocab"])
def test_quantize_params_equal_jax(cfg):
    """quantize_params: the packed layer matmuls (expert stacks included)
    and the padded wcls equal the JAX package's planes byte for byte; the
    rest carries over."""
    kw = {"dense": dict(E2K1, n_experts=0, n_active_experts=0),
          "moe": dict(E2K1, n_experts=4, n_active_experts=2), "moe_e2k1": E2K1,
          # 16256 = 128 x 127: no wide tile divides it, so wcls pads to 16384
          "padded_vocab": dict(E2K1, vocab_size=16256, n_layers=1)}[cfg]
    jp = j_loader.params_from_random(JaxConfig(**kw), seed=2, dtype=jnp.float32,
                                     to_device=False)
    tp = params_from_random(LlamaConfig(**kw), seed=2, dtype=torch.float32, device="cpu")
    jq = j_loader.quantize_params(jp, to_device=False)
    tq = quantize_params(tp)
    _all_equal(tq, jq)
    assert isinstance(tq.layers.w2, PackedQ40) and isinstance(tq.wcls, PackedQ40)
    want_vocab = 16384 if cfg == "padded_vocab" else kw["vocab_size"]
    assert tq.wcls.d_out == want_vocab
    tokens, positions = torch.tensor([[1, 2, 3]]), torch.tensor([[0, 1, 2]])
    logits, _ = llama_forward(LlamaConfig(**kw), tq, tokens, positions,
                              init_kv_cache(LlamaConfig(**kw), 1, device="cpu"))
    assert logits.shape == (1, 3, kw["vocab_size"]) and logits.is_contiguous()
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("d_out", [96, 128, 4100, 8192, 8320, 9216, 12416, 16256, 128256,
                                   151936])
def test_padded_d_out_equals_jax(d_out):
    assert t_packed.padded_d_out(d_out) == j_packed.padded_d_out(d_out)


# -- the router --------------------------------------------------------------


@pytest.mark.parametrize("n,dim,e,k", [(1, 64, 4, 2), (7, 64, 4, 2), (33, 64, 2, 1),
                                       (16, 256, 8, 2), (5, 64, 8, 8)])
def test_router_plain_equals_jax(n, dim, e, k):
    """moe_route's plain version against _moe_topk and _moe_router_weights:
    expert ids equal, weights within 1e-6."""
    rng = np.random.default_rng(n * 100 + e)
    y = rng.standard_normal((1, n, dim), dtype=np.float32)
    gate = rng.standard_normal((dim, e), dtype=np.float32) * 0.1
    jw, ji = j_llama._moe_topk(jnp.asarray(y), jnp.asarray(gate), k)
    jrw = j_llama._moe_router_weights(jnp.asarray(y), jnp.asarray(gate), k)
    cuda_moe.reset_counts()
    topw, topi, rw = cuda_moe.moe_route(torch.from_numpy(y[0]), torch.from_numpy(gate), k)
    assert cuda_moe.COUNTS == {"launches": 0, "plain_calls": 1}
    assert topi.dtype == torch.int32 and topw.dtype == rw.dtype == torch.float32
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ji)[0])
    np.testing.assert_allclose(topw.numpy(), np.asarray(jw)[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(rw.numpy(), np.asarray(jrw)[0], atol=1e-6, rtol=0)
    assert np.count_nonzero(rw.numpy(), axis=-1).max() <= k


def test_router_ties_take_lax_order():
    """Equal logits: the lower expert index first, as lax.top_k orders
    them (gate columns repeated, so ties are exact)."""
    rng = np.random.default_rng(9)
    y = rng.standard_normal((1, 6, 32), dtype=np.float32)
    col = rng.standard_normal((32, 1), dtype=np.float32)
    other = rng.standard_normal((32, 1), dtype=np.float32)
    gate = np.concatenate([other, col, col, other * 0.5, col, other], axis=1)  # E = 6
    for k in (1, 2, 3, 4):
        _, ji = j_llama._moe_topk(jnp.asarray(y), jnp.asarray(gate), k)
        _, topi, _ = cuda_moe.moe_route(torch.from_numpy(y[0]), torch.from_numpy(gate), k)
        np.testing.assert_array_equal(topi.numpy(), np.asarray(ji)[0])
    zero = np.zeros((1, 2, 32), np.float32)  # every logit 0: experts 0..k-1
    _, ji = j_llama._moe_topk(jnp.asarray(zero), jnp.asarray(gate), 3)
    _, topi, rw = cuda_moe.moe_route(torch.from_numpy(zero[0]), torch.from_numpy(gate), 3)
    assert topi.tolist() == np.asarray(ji)[0].tolist() == [[0, 1, 2], [0, 1, 2]]
    np.testing.assert_allclose(rw.numpy()[:, :3], 1.0 / 3.0, atol=1e-7)


def test_router_refuses_bad_shapes():
    y, gate = torch.zeros(3, 8), torch.zeros(8, 4)
    with pytest.raises(ValueError, match="experts"):
        cuda_moe.moe_route(y, gate, 5)
    with pytest.raises(ValueError, match="gate"):
        cuda_moe.moe_route(y, torch.zeros(6, 4), 2)


# -- the router kernel's launch plan (ops/cuda_moe.route_plan) ---------------
# the kernel runs only on the card (tests/test_torch_gpu.py); what it is
# launched with, and its fold order, are checked here

ROUTE_DIMS = (1, 7, 64, 96, 100, 128, 4096, 5120, 14336)
ROUTE_NS = (1, 8, 32, cuda_moe.TILE_MIN_ROWS - 1, cuda_moe.TILE_MIN_ROWS, 1024, 4096)


def _cu_constant(name: str) -> int:
    """An ``int`` constant of csrc/moe_route.cu (a literal or a product)."""
    with open(cuda_moe.KERNEL_SOURCE) as f:
        m = re.search(rf"constexpr int {name} = ([\d\s*]+);", f.read())
    assert m, f"{name} not found in {cuda_moe.KERNEL_SOURCE}"
    return int(np.prod([int(x) for x in m.group(1).split("*")]))


@pytest.mark.parametrize("dim", ROUTE_DIMS)
def test_route_slices_cover_the_dim_once_in_one_order(dim):
    """The SLICES slices cover [0, dim) once, in increasing order, each
    starting on a VEC boundary; the lanes' vectors cover each slice once;
    and every plan at every N and dtype launches with the slice length the
    dim sets (the kernel refuses any other), so a row's fold order is the
    same at every N and under both plans."""
    sl = cuda_moe.slices(dim)
    length = cuda_moe.slice_len(dim)
    assert len(sl) == cuda_moe.SLICES and length % cuda_moe.VEC == 0
    assert length * cuda_moe.SLICES >= dim > (length - cuda_moe.VEC) * cuda_moe.SLICES
    covered = np.zeros(dim, dtype=np.int64)
    end = 0
    for lo, hi in sl:
        assert lo == end and (lo % cuda_moe.VEC == 0 or lo == dim) and hi >= lo
        end = hi
        covered[lo:hi] += 1
        lanes = np.zeros(dim, dtype=np.int64)
        for lane in range(cuda_moe.LANES):
            vecs = cuda_moe.lane_vectors(lo, hi, lane)
            assert [d0 for d0, _ in vecs] == sorted(d0 for d0, _ in vecs)
            for d0, d1 in vecs:
                assert d0 % cuda_moe.VEC == 0 and lo <= d0 < d1 <= hi
                lanes[d0:d1] += 1
        assert (lanes[lo:hi] == 1).all() and lanes.sum() == hi - lo
    assert end == dim and (covered == 1).all()
    for n in ROUTE_NS:
        for dtype in (torch.bfloat16, torch.float32):
            for tile_min_rows in (1, cuda_moe.TILE_MIN_ROWS, 1 << 30):
                plan = cuda_moe.route_plan(n, dim, 8, 2, dtype, tile_min_rows=tile_min_rows)
                assert plan.slice_len == length


@pytest.mark.parametrize("n_exp,k", [(8, 2), (40, 40), (6, 3), (256, 8), (257, 8),
                                     (4096, 4096)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_plan_switches_over_and_fits(n_exp, k, dtype):
    """The cluster plan below TILE_MIN_ROWS rows while rank 0's shared
    memory holds the experts' slice sums (beside its warps' staged gate
    quads), tiles otherwise; a tile holds at
    most TILE_ROWS rows of the dtype, as many as spread the
    rows over the card's SMs, within TILE_MAX_SMEM beside the warps' staged
    gate quads, and the tiles cover the rows once."""
    for n in ROUTE_NS:
        plan = cuda_moe.route_plan(n, 4096, n_exp, k, dtype)
        assert plan.cluster == (n < cuda_moe.TILE_MIN_ROWS
                                and n_exp <= cuda_moe.CLUSTER_MAX_EXPERTS)
        assert 0 < plan.smem_bytes <= cuda_moe.TILE_MAX_SMEM
        if plan.cluster:
            assert plan.blocks == n
            assert plan.smem_bytes == (cuda_moe.CLUSTER_THREADS // 32 * cuda_moe.STAGE_FLOATS
                                       + (cuda_moe.SLICES + 1) * n_exp) * 4
            continue
        rows = plan.tile_rows
        assert 1 <= rows <= cuda_moe.TILE_ROWS[dtype]
        assert (plan.blocks - 1) * rows < n <= plan.blocks * rows
        assert rows <= max(1, -(-n // cuda_moe.H100_SMS))
        chunk = min(n_exp, cuda_moe.EXPERT_CHUNK)
        assert plan.smem_bytes == (cuda_moe.SLICES * cuda_moe.STAGE_FLOATS
                                   + rows * (cuda_moe.SLICES * chunk + n_exp)) * 4
    big = cuda_moe.route_plan(1024, 4096, 8, 2, dtype)
    assert big.tile_rows == cuda_moe.TILE_ROWS[dtype]  # 1,024 rows fill the card


@pytest.mark.parametrize("n,dim,n_exp,k,dtype", [
    (0, 64, 8, 2, torch.bfloat16), (4, 0, 8, 2, torch.bfloat16), (4, 64, 8, 0, torch.float32),
    (4, 64, 8, 9, torch.float32), (4, 64, 0, 1, torch.bfloat16),
    (4, 64, cuda_moe.MAX_EXPERTS + 1, 2, torch.bfloat16), (4, 64, 8, 2, torch.float16)])
def test_route_plan_refuses_what_the_kernel_cannot_take(n, dim, n_exp, k, dtype):
    with pytest.raises(ValueError):
        cuda_moe.route_plan(n, dim, n_exp, k, dtype)


@pytest.mark.parametrize("name,cu_name", [
    ("SLICES", "kSlices"), ("VEC", "kVec"), ("CLUSTER_THREADS", "kClusterThreads"),
    ("CLUSTER_MAX_EXPERTS", "kClusterMaxExperts"), ("EXPERT_CHUNK", "kExpertChunk"),
    ("MAX_EXPERTS", "kMaxExperts"), ("TILE_MAX_SMEM", "kTileMaxSmem")])
def test_route_launch_constants_match_the_kernel(name, cu_name):
    """The plan's constants are the kernel's (its launch refuses a plan
    made with others)."""
    assert getattr(cuda_moe, name) == _cu_constant(cu_name)
    assert cuda_moe.TILE_ROWS == {torch.bfloat16: _cu_constant("kTileRowsBf16"),
                                  torch.float32: _cu_constant("kTileRowsF32")}
    assert cuda_moe.TILE_THREADS == cuda_moe.SLICES * cuda_moe.LANES
    with open(cuda_moe.KERNEL_SOURCE) as f:
        src = f.read()
    # a tile warp's staged quad: a vector a lane, 4 floats a row, a pad of 4
    # every VEC rows
    assert "constexpr int kRound = 32 * kVec;" in src
    assert "constexpr int kStage = (kRound + kRound / kVec) * 4;" in src
    assert cuda_moe.STAGE_FLOATS == (32 * cuda_moe.VEC + 32 * cuda_moe.VEC // cuda_moe.VEC) * 4


def _xor_tree(a: np.ndarray) -> np.ndarray:
    """The plain xor tree over 32 lanes of a [32, 4] float32: at each
    offset 16 .. 1 lane i adds lane i ^ off's value to its own."""
    a = a.copy()
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        a = a + a[lanes ^ off]
    return a


def _quad_reduce(a: np.ndarray) -> np.ndarray:
    """csrc/moe_route.cu's quad_reduce, lane by lane in float32: each lane's
    result (expert (lane >> 3) & 3's sum)."""
    lanes = np.arange(32)
    b4, b3 = (lanes & 16) > 0, (lanes & 8) > 0
    shfl = lambda v, off: v[lanes ^ off]  # noqa: E731
    k0 = np.where(b4, a[:, 2], a[:, 0]) + shfl(np.where(b4, a[:, 0], a[:, 2]), 16)
    k1 = np.where(b4, a[:, 3], a[:, 1]) + shfl(np.where(b4, a[:, 1], a[:, 3]), 16)
    v = np.where(b3, k1, k0) + shfl(np.where(b3, k0, k1), 8)
    for off in (4, 2, 1):
        v = v + shfl(v, off)
    return v


@pytest.mark.parametrize("seed", range(4))
def test_transposed_reduce_is_the_xor_tree_bit_for_bit(seed):
    """The kernel's transposed warp reduce gives each expert the plain xor
    tree's sum bit for bit (values of mixed magnitudes and signs, where
    another tree would round differently), in lane 8j for expert j."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((32, 4)) * 10.0 ** rng.integers(-6, 6, (32, 4))).astype(np.float32)
    want = _xor_tree(a)
    got = _quad_reduce(a)
    lanes = np.arange(32)
    assert (got.view(np.int32) == want[lanes, (lanes >> 3) & 3].view(np.int32)).all()
    assert [float(got[8 * j]) for j in range(4)] == [float(want[0, j]) for j in range(4)]


# -- _moe_ffn and its dispatch ----------------------------------------------


def _j_layer(jp, l: int = 0):
    """Layer l of a JAX params tree as its LlamaLayerParams."""
    lay = jp.layers

    def pick(w):
        if w is None:
            return None
        if isinstance(w, j_packed.PackedQ40):
            return j_packed.PackedQ40(w.packed[l], w.scales[l])
        return w[l]

    return j_llama.LlamaLayerParams(**{k: pick(getattr(lay, k)) for k in lay._fields})


@pytest.fixture
def spies(monkeypatch):
    """Counts of the port's per-expert loop and of its expert unpacks."""
    calls = {"loop": 0, "unpack": 0}
    loop, unpack = t_llama._moe_ffn_loop, t_llama.unpack_q40

    def spy_loop(*a, **k):
        calls["loop"] += 1
        return loop(*a, **k)

    def spy_unpack(*a, **k):
        calls["unpack"] += 1
        return unpack(*a, **k)

    monkeypatch.setattr(t_llama, "_moe_ffn_loop", spy_loop)
    monkeypatch.setattr(t_llama, "unpack_q40", spy_unpack)
    return calls


@pytest.mark.parametrize("kind", ["packed", "dense"])
@pytest.mark.parametrize("t", [1, 4, 32, 64])
def test_moe_ffn_matches_jax_and_takes_its_branch(kind, t, jax_params, torch_params, spies):
    """One layer's mixture on random rows at T = 1 and 4 (the loop, for
    packed experts) and 32 and 64 (the sparse dispatch, each expert
    unpacked once), and dense experts (the sparse dispatch at every T),
    against the JAX package's _moe_ffn on the same weights."""
    _, jp = jax_params
    config, tp = torch_params
    rng = np.random.default_rng(t)
    y = rng.standard_normal((2, t, config.dim), dtype=np.float32)
    j_linear.set_pallas_interpret(True)
    try:
        want = j_llama._moe_ffn(jnp.asarray(y), jnp.asarray(y), _j_layer(jp[kind]), j_silu,
                                config.n_active_experts, lambda v: v)
    finally:
        j_linear.set_pallas_interpret(False)
    cuda_moe.reset_counts()
    yt = torch.from_numpy(y)
    got = t_llama._moe_ffn(yt, yt, tp[kind].layers.layer(0), silu, config.n_active_experts,
                           lambda v: v)
    _close(got.numpy(), np.asarray(want))
    loop = kind == "packed" and t < t_llama.MOE_PACKED_SPARSE_MIN_TOKENS
    assert spies["loop"] == int(loop)
    # the sparse dispatch of packed experts unpacks each chosen expert's
    # three weights once; the loop and dense experts unpack nothing
    e_used = len(set(torch.topk(yt.reshape(-1, config.dim) @ tp[kind].layers.moe_gate[0],
                                config.n_active_experts).indices.flatten().tolist()))
    want_unpack = 3 * e_used if kind == "packed" and not loop else 0
    assert spies["unpack"] == want_unpack
    assert cuda_moe.COUNTS["plain_calls"] == 1  # one router call a layer
    assert t_llama.MOE_PACKED_SPARSE_MIN_TOKENS == j_llama.MOE_PACKED_SPARSE_MIN_TOKENS


def test_sparse_dispatch_equals_the_loop(torch_params, monkeypatch):
    """Both branches are one mixture: the same rows through the sparse
    dispatch and through the loop (packed experts) agree to f32 order."""
    config, tp = torch_params
    y = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 40, config.dim),
                                                                 dtype=np.float32))
    lp = tp["packed"].layers.layer(1)
    sparse = t_llama._moe_ffn(y, y, lp, silu, config.n_active_experts, lambda v: v)
    monkeypatch.setattr(t_llama, "MOE_PACKED_SPARSE_MIN_TOKENS", 10 ** 9)
    loop = t_llama._moe_ffn(y, y, lp, silu, config.n_active_experts, lambda v: v)
    _close(sparse.numpy(), loop.numpy())


def test_loop_shares_one_operand_build(torch_params, monkeypatch):
    """One Q80Acts build feeds wq/wk/wv and one feeds all 2E w1/w3 products
    of a layer (a function of yq alone); wo, each w2 and wcls build their
    own."""
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
    llama_forward(config, tp["packed"], torch.tensor([[3, 9, 27]]), torch.tensor([[0, 1, 2]]),
                  init_kv_cache(config, 1, device="cpu"))
    L, E = config.n_layers, config.n_experts
    assert len(builds) == L * (1 + 1 + 1 + E) + 1  # attention, wo, w1/w3, each w2; wcls
    assert len(prebuilt) == L * (3 + 1 + 3 * E) + 1
    assert sum(prebuilt) == L * (3 + 2 * E)  # wq, wk, wv and every w1, w3


# -- the forward and greedy streams -------------------------------------------


def _jax_fwd(jconfig, q80):
    return jax.jit(lambda p, t, q, c: j_forward(jconfig, p, t, q, c,
                                                emulate_q80_activations=q80))


@pytest.mark.parametrize("q80", [False, True])
@pytest.mark.parametrize("kind", ["packed", "dense"])
def test_forward_and_greedy_decode_match_jax(kind, q80, jax_params, torch_params):
    """A 5-token prefill, then 8 greedy decode steps, each side feeding its
    own argmax: the same tokens, the logits within the tolerance."""
    jconfig, jp = jax_params
    config, tp = torch_params
    j_linear.set_pallas_interpret(True)
    try:
        fwd = _jax_fwd(jconfig, q80)
        jcache = j_init_cache(jconfig, 1)
        tcache = init_kv_cache(config, 1, device="cpu")
        tokens = np.asarray([PROMPT], np.int64)
        positions = np.arange(len(PROMPT), dtype=np.int64)[None]
        jtoks, ttoks = [], []
        for _ in range(DECODE_STEPS + 1):
            ref, jcache = fwd(jp[kind], jnp.asarray(tokens, jnp.int32),
                              jnp.asarray(positions, jnp.int32), jcache)
            got, _ = llama_forward(config, tp[kind], torch.from_numpy(tokens),
                                   torch.from_numpy(positions), tcache,
                                   emulate_q80_activations=q80)
            ref = np.asarray(ref)
            _close(got.numpy(), ref, Q80_TOL if q80 else TOL)
            jtoks.append(int(ref[0, -1].argmax()))
            ttoks.append(int(got[0, -1].argmax()))
            tokens = np.asarray([[ttoks[-1]]], np.int64)
            positions = positions[:, -1:] + 1
    finally:
        j_linear.set_pallas_interpret(False)
    assert ttoks == jtoks


@pytest.mark.parametrize("kind", ["packed", "dense"])
def test_greedy_stream_matches_jax_engine(kind, jax_params, torch_params):
    """16 greedy tokens through both engines (prefill chunks, the decode
    step)."""
    jconfig, jp = jax_params
    config, tp = torch_params
    engine = InferenceEngine(config, tp[kind], n_lanes=2, prefill_buckets=(8, 16),
                             device="cpu")
    got, _ = greedy_rollout(engine, PROMPT, 16)
    j_linear.set_pallas_interpret(True)
    try:
        jengine = JaxEngine(jconfig, jp[kind], n_lanes=2, prefill_buckets=(8, 16))
        want, _ = greedy_rollout(jengine, PROMPT, 16)
    finally:
        j_linear.set_pallas_interpret(False)
    assert got == want


# -- tensor parallelism -------------------------------------------------------


def _steps():
    tokens = np.asarray([PROMPT, PROMPT[::-1]], np.int64)
    positions = np.asarray([np.arange(5), np.arange(5) + 3], np.int64)
    yield tokens, positions
    yield np.asarray([[11], [40]], np.int64), positions[:, -1:] + 1


def _mesh(tp=2):
    return make_mesh(MeshPlan(tp=tp), ["cpu"] * tp)


def _port_logits(config, params, mesh=None, **kw):
    if mesh is None:
        cache = init_kv_cache(config, 2, device="cpu")
    else:
        params = shard_params(params, mesh)
        cache = shard_kv_cache(init_kv_cache(config, 2, device="cpu"), mesh)
    return [llama_forward(config, params, torch.from_numpy(t), torch.from_numpy(p), cache,
                          mesh=mesh, **kw)[0].numpy() for t, p in _steps()]


@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("q80", [False, True])
def test_tp2_forward_matches_jax_mesh_and_one_device(ring, q80, jax_params, torch_params):
    """tp = 2 on CPU ranks against the JAX tp = 2 mesh and against the
    port's one device: prefill and decode logits; the routed partials meet
    in one f32 all-reduce a layer, on both wires."""
    jconfig, jp = jax_params
    config, tp = torch_params
    jmesh = j_make_mesh(JaxPlan(tp=2))
    sp = j_shard(jp["packed"], jmesh)
    prev = jrc.ring_sync_enabled()
    jrc.set_ring_sync(ring)
    try:
        fwd = jax.jit(lambda p, t, q, c: j_forward(jconfig, p, t, q, c, mesh=jmesh,
                                                    q80_sync=q80, emulate_q80_activations=q80))
        cache, want = j_init_cache(jconfig, 2), []
        for tokens, positions in _steps():
            logits, cache = fwd(sp, jnp.asarray(tokens, jnp.int32),
                                jnp.asarray(positions, jnp.int32), cache)
            want.append(np.asarray(logits))
    finally:
        jrc.set_ring_sync(prev)
    rc.reset_counts()
    got = _port_logits(config, tp["packed"], _mesh(), ring_sync=ring, q80_sync=q80,
                       emulate_q80_activations=q80)
    assert rc.ring_counts()["ring_hop_plain_calls"] > 0
    one = _port_logits(config, tp["packed"], emulate_q80_activations=q80)
    for g, w, o in zip(got, want, one):
        _close(g, w, Q80_TOL if q80 else TOL)
        _close(g, o, Q80_TOL if q80 else TOL)


def test_tp2_sync_bytes_reckon_the_moe_all_reduce(torch_params):
    """A tp = 2 decode step moves, per layer, wo's ring sync and the MoE
    output's f32 all-reduce (each n-1 reduce and n-1 gather hops of every
    rank's chunk), then the logits: the dense model's count."""
    config, tp = torch_params
    n, b = 2, 3
    mesh = _mesh(n)
    engine = InferenceEngine(config, shard_params(tp["packed"], mesh), n_lanes=b, mesh=mesh)
    engine.prefill(0, PROMPT)
    rc.reset_counts()
    engine.decode(np.zeros(b, np.int64), np.asarray([7, config.seq_len, config.seq_len]))
    want = (n - 1) * 4 * b * (4 * config.n_layers * config.dim + config.vocab_size)
    assert engine.stats.sync_bytes_per_decode == want == rc.ring_counts()["ring_hop_bytes"]


@pytest.mark.parametrize("kind", ["packed", "dense"])
def test_shard_params_moe_round_trip(kind, torch_params):
    """w1/w3 row-sliced on hidden for every expert, w2 split on its input
    rows as a plain stack, the router replicated: the shards rebuild every
    plane."""
    _, tp = torch_params
    params = tp[kind]
    shards = shard_params(params, _mesh())

    def planes(w):
        return (w.packed, w.scales) if isinstance(w, PackedQ40) else (w,)

    for key, dim in (("w1", -1), ("w3", -1), ("w2", -2)):
        for i, full in enumerate(planes(getattr(params.layers, key))):
            parts = [planes(getattr(s.layers, key))[i] for s in shards]
            assert all(p.is_contiguous() and p.dim() == 4 for p in parts)
            assert torch.equal(torch.cat(parts, dim=dim), full)
    for s in shards:
        assert torch.equal(s.layers.moe_gate, params.layers.moe_gate)


def test_shard_params_refuses_a_split_quant_block():
    """An MoE w2 whose hidden / tp is no whole number of 32-value blocks."""
    cfg = LlamaConfig(**dict(E2K1, hidden_dim=96))
    params = quantize_params(params_from_random(cfg, seed=0, dtype=torch.float32,
                                                device="cpu"))
    with pytest.raises(ValueError, match="w2.*quant blocks"):
        shard_params(params, _mesh())


# -- serving ------------------------------------------------------------------


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


def _requests(cls):
    return [cls(prompt="ab ab ab ab ab", max_tokens=10, temperature=0.0),
            cls(prompt="hello world hello world hello", max_tokens=12, temperature=0.0),
            cls(prompt="sampled one", max_tokens=8, temperature=0.8, seed=123)]


@pytest.fixture(scope="module")
def jax_stream(moe_model, jax_params):
    """The JAX scheduler's streams (speculation on) on the dense MoE
    params, as tests/test_moe.py serves them."""
    jconfig, jp = jax_params
    jengine = JaxEngine(jconfig, jp["dense"], n_lanes=4, prefill_buckets=(8,))
    return _serve(JaxScheduler(jengine, JaxTokenizer(moe_model["tokenizer"]), speculative=True,
                               prefix_min_tokens=0), _requests(JaxRequest))


@pytest.mark.parametrize("paged", [False, True])
def test_scheduler_spec_equals_no_spec_and_jax(paged, moe_model, torch_params, jax_stream):
    """The speculative-verification identity on an MoE model (the verify
    window runs the per-expert loop): streams with speculation on equal
    those with it off and the JAX scheduler's, on contiguous planes and
    with the paged KV cache."""
    config, tp = torch_params
    tok = Tokenizer(moe_model["tokenizer"])
    kw = {"paged_kv": True, "kv_page_size": 4} if paged else {}

    def run(spec):
        eng = InferenceEngine(config, tp["packed"], n_lanes=4, prefill_buckets=(8,),
                              device="cpu", **kw)
        got = _serve(ContinuousBatchingScheduler(eng, tok, speculative=spec,
                                                 prefix_min_tokens=0), _requests(Request))
        return got, eng.stats.snapshot()

    (spec, stats), (plain, _) = run(True), run(False)
    assert stats["spec_steps"] > 0 and stats["spec_emitted"] > stats["spec_lane_steps"]
    assert spec == plain == jax_stream


FLAGS_RF = {"type": "json_schema", "json_schema": {"schema": {
    "type": "object",
    "properties": {"ok": {"type": "boolean"}, "mood": {"enum": ["a", "b"]},
                   "n": {"type": "null"}},
    "required": ["ok", "mood", "n"]}}}


def test_grammar_constrained_request_on_moe(tmp_path):
    """A json_schema request on an MoE model (320 entries, the byte
    tokenizer) parses and conforms, and equals the JAX scheduler's answer,
    beside a plain request."""
    path = str(tmp_path / "moe_g.m")
    j_syn.write_synthetic_model(path, j_syn.tiny_header(vocab_size=320, seq_len=256,
                                                        n_experts=4, n_active_experts=2),
                                seed=3)
    config, params = load_params_from_m_quantized(path, load_model_header(path),
                                                  dtype=torch.float32, device="cpu")
    jconfig, jparams = j_loader.load_params_from_m(path, j_load_header(path),
                                                   dtype=jnp.float32)
    reqs = [("the flags", 80, 0.0, None, FLAGS_RF), ("plain greedy", 16, 0.0, None, None)]

    def answers(sched, make):
        sched.start()
        try:
            out = [sched.submit(make(prompt=p, max_tokens=m, temperature=t, seed=s,
                                     response_format=rf)) for p, m, t, s, rf in reqs]
            for r in out:
                r.future.result(timeout=300)
        finally:
            sched.stop()
        return [(r.finish_reason, list(r.generated_tokens), r.generated_text) for r in out]

    eng = InferenceEngine(config, params, n_lanes=4, prefill_buckets=(8, 16), device="cpu")
    tok = ByteJsonTokenizer()
    eng.grammar_init(tok.token_table(), tok.eos_token_ids)
    got = answers(ContinuousBatchingScheduler(eng, tok, prefix_min_tokens=0), Request)
    jeng = JaxEngine(jconfig, jparams, n_lanes=4, prefill_buckets=(8, 16))
    jtok = JaxByteTokenizer()
    jeng.grammar_init(jtok.token_table(), jtok.eos_token_ids)
    want = answers(JaxScheduler(jeng, jtok, prefix_min_tokens=0), JaxRequest)
    assert got == want
    reason, _, text = got[0]
    assert reason == "stop"
    obj = json.loads(text)
    assert set(obj) == {"ok", "mood", "n"} and obj["mood"] in ("a", "b") and obj["n"] is None
    assert eng.stats.snapshot()["grammar_masked_steps"] > 0


BODIES = [
    ("/v1/completions", {"prompt": "hello world", "max_tokens": 12, "temperature": 0}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi there"}],
                              "max_tokens": 10, "temperature": 0}),
    ("/v1/completions", {"prompt": "ab ab ab ab ab", "max_tokens": 9, "temperature": 0,
                         "stream": True}),
]


def _api(model, *extra):
    """``dllama_api``'s own stack on the CPU, served from a thread."""
    from distributed_llama_multiusers_tpu_torch.app.args import build_parser
    from distributed_llama_multiusers_tpu_torch.app.runtime_setup import (
        load_stack,
        make_scheduler,
    )
    from distributed_llama_multiusers_tpu_torch.server import ApiServer

    args = build_parser("dllama-api").parse_args(
        ["--model", model["model"], "--tokenizer", model["tokenizer"], "--device", "cpu",
         "--max-lanes", "4", "--weights", "packed", *extra])
    _, _, tok, engine = load_stack(args)
    sched = make_scheduler(engine, tok)
    httpd = ApiServer(sched, tok, model_name="moe").serve(host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return sched, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        raw = r.read().decode()
    if not body.get("stream"):
        return json.loads(raw)["choices"][0]
    text = ""
    for line in raw.splitlines():
        if line.startswith("data: {"):
            c = json.loads(line[6:])["choices"][0]
            text += c.get("text") or (c.get("delta") or {}).get("content") or ""
    return text


def _concurrent(base):
    out, errors = [None] * len(BODIES), []

    def worker(i, route, body):
        try:
            out[i] = _post(base + route, body)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i, r, b))
               for i, (r, b) in enumerate(BODIES)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not errors, errors
    return out


def test_server_workers_2_byte_identical_to_one_device(moe_model, capsys):
    """Three concurrent greedy requests through ``dllama_api --workers 2``
    on the MoE file give the one-device server's answers; the startup log
    names the experts and syncs only wo on the ring; the router ran
    (plain calls on the CPU) on both."""
    servers = [_api(moe_model, "--workers", "2"), _api(moe_model)]
    log = capsys.readouterr().out
    assert "Experts: 4  Active: 2" in log
    assert "Ring TP sync: wo activation sync" in log and "wo/w2" not in log
    try:
        cuda_moe.reset_counts()
        tp_out = _concurrent(servers[0][2])
        single = _concurrent(servers[1][2])
        assert tp_out == single and all(tp_out)
        with urllib.request.urlopen(servers[0][2] + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["mesh"]["tp"] == 2 and stats["ring_hop_plain_calls"] > 0
        assert stats["moe_route_plain_calls"] > 0 and stats["moe_route_launches"] == 0
    finally:
        for sched, httpd, _ in servers:
            httpd.shutdown()
            sched.stop()


# -- the dllama CLI -----------------------------------------------------------


def _cli(main_fn, argv, capsys) -> str:
    capsys.readouterr()
    main_fn(argv)
    return capsys.readouterr().out


def _jax_cli(argv):
    """The JAX dllama's ``main`` past its platform setup."""
    args = j_build_parser("dllama").parse_args(argv)
    j_dllama.run_inference(args)


def _generated(out: str) -> tuple[str, list]:
    """(the generated text, the Pred lines) of an inference run."""
    body = out.split("🔷 Eval", 1)[1].split("\n", 1)[1].split("\n⏱ Evaluation", 1)[0]
    return re.sub(r"🔶 Pred [^\n]*\n", "", body), re.findall(r"🔶 Pred [^\n]*", body)


@pytest.mark.parametrize("flags", [["--temperature", "0"],
                                   ["--temperature", "0.8", "--seed", "7"]])
def test_cli_inference_equals_jax(moe_model, capsys, flags):
    """``dllama inference --benchmark`` on the MoE file: the text and the
    number of Pred lines equal the JAX CLI's (greedy with speculation, and
    seeded)."""
    argv = ["inference", "--model", moe_model["model"], "--tokenizer", moe_model["tokenizer"],
            "--prompt", "ab ab ab ab ab", "--steps", "16", "--benchmark", *flags]
    got = _generated(_cli(dllama.main, argv + ["--device", "cpu"], capsys))
    want = _generated(_cli(_jax_cli, argv, capsys))
    assert got[0] == want[0] and got[0].strip()
    assert len(got[1]) == len(want[1])


def test_cli_tp2_sync_readout_counts_the_moe_all_reduce(moe_model, capsys):
    """``--workers 2``: the one-rank text, and each Pred line's Sync readout
    (a decode step's hop bytes a rank) counts wo's ring sync and the MoE
    output's f32 all-reduce in every layer (each n - 1 reduce and n - 1
    gather hops of every rank's chunk), then the logits' gather:
    (n - 1) 4 B (4 L dim + vocab) bytes over n ranks, the dense model's
    reckoning (tests/test_torch_tp.py)."""
    argv = ["inference", "--model", moe_model["model"], "--tokenizer", moe_model["tokenizer"],
            "--prompt", "hello world", "--steps", "8", "--benchmark", "--temperature", "0",
            "--no-spec", "--multi-step", "0", "--device", "cpu"]
    one = _cli(dllama.main, argv, capsys)
    two = _cli(dllama.main, argv + ["--workers", "2"], capsys)
    assert _generated(two)[0] == _generated(one)[0]
    n, layers, dim, vocab = 2, 2, 64, 128
    kb = (n - 1) * 4 * 1 * (4 * layers * dim + vocab) / 1024 / n
    preds = _generated(two)[1]
    assert len(preds) == 8
    assert all(f"Sync {kb:8.1f} kB/chip" in p for p in preds), preds
