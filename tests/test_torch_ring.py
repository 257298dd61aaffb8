"""The port's ring collectives and Q80 codec against the JAX package's.

The JAX functions run shard-locally inside ``shard_map`` on the virtual CPU
mesh (tests/conftest.py), each device returning its own result; the port's
take the list of per-rank CPU tensors, where every hop is the hop kernel's
plain version. Copies are exact and the hop order and arrival bookkeeping are
the same, so the collectives agree bit for bit. The fused matmuls run the JAX
Q40 kernel in interpret mode with the exact f32 dot and the port's plain
versions; their tolerances are stated where they are used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_llama_multiusers_tpu.jax_compat import shard_map
from distributed_llama_multiusers_tpu.models.config import LlamaConfig as JaxConfig
from distributed_llama_multiusers_tpu.ops import linear as j_linear
from distributed_llama_multiusers_tpu.ops import ring_collective as jrc
from distributed_llama_multiusers_tpu.parallel import MeshPlan as JaxPlan
from distributed_llama_multiusers_tpu.parallel import collectives as jcoll
from distributed_llama_multiusers_tpu.parallel import make_mesh as j_make_mesh
from distributed_llama_multiusers_tpu.quants import jax_codec
from distributed_llama_multiusers_tpu.quants.packed import PackedQ40 as JaxPacked
from distributed_llama_multiusers_tpu.quants.packed import pack_q40_host
from distributed_llama_multiusers_tpu_torch.models.config import LlamaConfig
from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc
from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
from distributed_llama_multiusers_tpu_torch.parallel import collectives as coll
from distributed_llama_multiusers_tpu_torch.parallel.sharding import col_shards
from distributed_llama_multiusers_tpu_torch.quants import torch_codec
from distributed_llama_multiusers_tpu_torch.quants.packed import PackedQ40

TPS = [2, 4]


def _per_device(fn, x: np.ndarray, tp: int) -> np.ndarray:
    """Device r runs ``fn`` on x[r]; returns [tp, ...] of the devices' results."""
    mesh = j_make_mesh(JaxPlan(tp=tp))
    spec = P("tp", *([None] * (x.ndim - 1)))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
    out = jax.jit(shard_map(lambda xl: fn(xl[0])[None], mesh=mesh, in_specs=(spec,),
                            out_specs=P("tp"), check_vma=False))(xs)
    return np.asarray(out)


def _ranks(x: np.ndarray) -> list:
    return [torch.from_numpy(np.array(a)) for a in x]


def _same(got: list, want: np.ndarray) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.array(w)).dtype
        np.testing.assert_array_equal(g.numpy(), w)


def _random(tp, *shape, seed=0):
    return np.random.default_rng(seed).standard_normal((tp, *shape)).astype(np.float32)


@pytest.mark.parametrize("tp", TPS)
def test_ring_shift_plain_matches_ppermute(tp):
    x = _random(tp, 3, 40, seed=tp)
    want = _per_device(lambda a: jax.lax.ppermute(a, "tp", jrc._ring_perm(tp)), x, tp)
    _same(rc.ring_shift_plain(_ranks(x)), want)
    rc.reset_counts()
    _same(rc.ring_shift(_ranks(x)), want)
    assert rc.ring_counts() == {"ring_hop_launches": 0, "ring_hop_plain_calls": tp,
                                "ring_hop_bytes": tp * x[0].nbytes}


def test_ring_shift_rejects_what_the_kernel_does_not_take():
    a = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="disagree"):
        rc.ring_shift([a, torch.zeros(2, 4)])
    with pytest.raises(ValueError, match="disagree"):
        rc.ring_shift([a, torch.zeros(2, 8, dtype=torch.float64)])
    with pytest.raises(ValueError, match="contiguous"):
        rc.ring_shift([a, torch.zeros(8, 2).t()])
    with pytest.raises(ValueError, match="empty"):
        rc.ring_shift([torch.zeros(2, 0), torch.zeros(2, 0)])


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("name", ["reduce_scatter", "all_gather", "all_gather_q80",
                                  "all_reduce"])
def test_ring_collectives_bit_exact(tp, name):
    """The same inputs through the JAX shard-local collective and the port's
    list form: every rank's result bit for bit."""
    x = _random(tp, 2, 3, 64 * tp, seed=11 + tp)
    jfn = getattr(jrc, f"ring_{name}")
    want = _per_device(lambda a: jfn(a, "tp", tp), x, tp)
    _same(getattr(rc, f"ring_{name}")(_ranks(x)), want)


@pytest.mark.parametrize("tp", TPS)
def test_ring_all_reduce_fallback_matches_psum(tp):
    """A width the ring cannot chunk: every rank gathers every partial and
    adds them in rank order, the same bits on every rank. It replaces
    lax.psum, whose add order is XLA's: one add at tp=2 (bit-exact), within
    1e-6 relative at tp=4."""
    x = _random(tp, 2, 30 + 1, seed=5)
    want = _per_device(lambda a: jax.lax.psum(a, "tp"), x, tp)
    got = rc.ring_all_reduce(_ranks(x))
    for g in got[1:]:
        assert torch.equal(g, got[0])
    if tp == 2:
        _same(got, want)
    else:
        np.testing.assert_allclose(np.stack([g.numpy() for g in got]), want,
                                   rtol=1e-6, atol=1e-6 * np.abs(want).max())


# (destination dtype, addend dtype): the ring step's add forms
ADD_FORMS = [("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "bfloat16")]
_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _recv_add(src: list, add: list, dst: list) -> list:
    n = len(src)
    return [[rc.Seg(src[(r - 1) % n], dst[r], add[r])] for r in range(n)]


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("dst_dtype,add_dtype", ADD_FORMS)
def test_ring_step_add_matches_ppermute_then_add(tp, dst_dtype, add_dtype):
    """The fused hop's add form, the received operand on the left: bit for
    bit the JAX package's ppermute followed by the add (f32 + f32, f32 +
    bf16 widened, bf16 + bf16 rounded once), through ring_step_plain and
    through ring_step (one plain call per receiving rank)."""
    x = _random(tp, 2, 2, 3, 40, seed=40 + tp)  # [tp, (src, addend), ...]
    want = _per_device(lambda a: jax.lax.ppermute(a[0].astype(_J[dst_dtype]), "tp",
                                                  jrc._ring_perm(tp))
                       + a[1].astype(_J[add_dtype]), x, tp)
    src = [torch.from_numpy(a[0]).to(_T[dst_dtype]) for a in x]
    add = [torch.from_numpy(a[1]).to(_T[add_dtype]) for a in x]
    for step in (rc.ring_step_plain, rc.ring_step):
        rc.reset_counts()
        dst = [torch.full_like(t, float("nan")) for t in src]
        step(_recv_add(src, add, dst))
        assert all(d.dtype == _T[dst_dtype] for d in dst)
        np.testing.assert_array_equal(np.stack([d.float().numpy() for d in dst]),
                                      np.asarray(want, np.float32))
    assert rc.ring_counts() == {"ring_hop_launches": 0, "ring_hop_plain_calls": tp,
                                "ring_hop_bytes": tp * src[0].numel() * src[0].element_size()}


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("add", [False, True])
def test_ring_step_slot_destination(tp, add):
    """A hop (and a hop with its add) landing in column slot k of a wider
    [..., n*C] output: the slot equals the JAX ppermute (then add), and no
    other column of the output is written."""
    c = 24
    x = _random(tp, 2, 2, 3, c, seed=50 + tp)
    want = _per_device(lambda a: jax.lax.ppermute(a[0], "tp", jrc._ring_perm(tp))
                       + (a[1] if add else 0), x, tp)
    src = [torch.from_numpy(a[0]) for a in x]
    addend = [torch.from_numpy(a[1]) for a in x]
    for k in range(tp):
        outs = [torch.full((2, 3, tp * c), -7.0) for _ in range(tp)]
        dst = [o[..., k * c:(k + 1) * c] for o in outs]
        rc.ring_step([[rc.Seg(src[(r - 1) % tp], dst[r], addend[r] if add else None)]
                      for r in range(tp)])
        for r, o in enumerate(outs):
            np.testing.assert_array_equal(o[..., k * c:(k + 1) * c].numpy(), want[r])
            rest = torch.cat([o[..., :k * c], o[..., (k + 1) * c:]], dim=-1)
            assert bool((rest == -7.0).all())


@pytest.mark.parametrize("tp", TPS)
def test_ring_step_two_segments_match_two_ppermutes(tp):
    """The Q80 wire's step: int8 values and f16 scales, two segments of one
    launch per rank, each bit for bit its own ppermute; one plain call per
    rank, the bytes of both."""
    rng = np.random.default_rng(60 + tp)
    q = rng.integers(-127, 128, (tp, 3, 2, 32)).astype(np.int8)
    s = rng.standard_normal((tp, 3, 2, 1)).astype(np.float16)
    perm = jrc._ring_perm(tp)
    want_q = _per_device(lambda a: jax.lax.ppermute(a, "tp", perm), q, tp)
    want_s = _per_device(lambda a: jax.lax.ppermute(a, "tp", perm), s, tp)
    qs, ss = _ranks(q), _ranks(s)
    dq, ds = [torch.empty_like(t) for t in qs], [torch.empty_like(t) for t in ss]
    rc.reset_counts()
    rc.ring_step([[rc.Seg(qs[(r - 1) % tp], dq[r]), rc.Seg(ss[(r - 1) % tp], ds[r])]
                  for r in range(tp)])
    _same(dq, want_q)
    np.testing.assert_array_equal(np.stack([d.numpy() for d in ds]).view(np.uint16),
                                  np.asarray(want_s).view(np.uint16))
    assert rc.ring_counts() == {"ring_hop_launches": 0, "ring_hop_plain_calls": tp,
                                "ring_hop_bytes": tp * (q[0].nbytes + s[0].nbytes)}


def test_ring_step_rejects_what_the_kernel_does_not_take():
    a, b = torch.zeros(2, 8), torch.zeros(2, 8)
    with pytest.raises(ValueError, match="does not match"):
        rc.ring_step([[rc.Seg(a, torch.zeros(2, 4))]])
    with pytest.raises(ValueError, match="adds f32 or bf16"):
        rc.ring_step([[rc.Seg(a, b, torch.zeros(2, 8, dtype=torch.float16))]])
    with pytest.raises(ValueError, match="segments"):
        rc.ring_step([[rc.Seg(a, b)] * 3])
    with pytest.raises(ValueError, match="row pitch"):
        rc.ring_step([[rc.Seg(torch.zeros(4, 3, 8)[:, :2], torch.zeros(4, 2, 8))]])
    with pytest.raises(ValueError, match="rows must be contiguous"):
        rc.ring_step([[rc.Seg(torch.zeros(8, 2).t(), b)]])


# one decode step of the full-width 1B model at tp=2 and 8 lanes: per layer
# two syncs of d_out = dim, then the logits gather of [8, 1, vocab / 2]
_STEP_1B = dict(dim=2048, layers=16, vocab=128256, lanes=8)


@pytest.mark.parametrize("q80_wire", [False, True])
def test_ring_step_counts_per_tp2_decode_step(q80_wire):
    """The ring's launches (plain calls here) and wire bytes per tp=2 decode
    step of the 1B model, from one wo/w2 sync at its real width and one
    logits gather: one launch per receiving rank per ring step, so 130 on
    both wires (the Q80 wire's values and scales ride one launch: 194
    separate hops before), and the bytes sync_bytes_per_decode reports."""
    g, n = _STEP_1B, 2
    mesh = make_mesh(MeshPlan(tp=n), ["cpu"] * n)
    ws = col_shards(torch.zeros(g["dim"], g["dim"]), mesh)
    xs = [torch.zeros(g["lanes"], 1, g["dim"] // n) for _ in range(n)]
    rc.reset_counts()
    rc.ring_sync_matmul(xs, ws, q80_wire=q80_wire)
    sync = rc.ring_counts()
    per_sync = 2 * n * (n - 1)  # n-1 reduce steps and n-1 gather steps, every rank
    assert sync["ring_hop_plain_calls"] == per_sync
    rc.reset_counts()
    rc.ring_all_gather([torch.zeros(g["lanes"], 1, g["vocab"] // n) for _ in range(n)])
    logits = rc.ring_counts()
    assert logits["ring_hop_plain_calls"] == n * (n - 1)
    syncs = 2 * g["layers"]
    calls = syncs * sync["ring_hop_plain_calls"] + logits["ring_hop_plain_calls"]
    nbytes = syncs * sync["ring_hop_bytes"] + logits["ring_hop_bytes"]
    assert calls == 130
    assert nbytes == (6_758_400 if q80_wire else 8_298_496)
    if q80_wire:  # separate value and scale hops: one more step per rank per sync
        assert calls + syncs * n * (n - 1) == 194


def _codec_inputs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 96)).astype(np.float32) * 3
    x[1, 32:64] = 0.0  # an all-zero block: scale 0, values 0
    # exact ties: amax 15.875 makes d32 = 1/8 exactly, so x = (j + 0.5)/8
    # scales to j + 0.5 and the two modes part
    ties = (np.arange(32, dtype=np.float32) - 16 + 0.5) / 8
    ties[0] = 15.875
    x[2, :32] = ties
    x[3, 64:] = -ties
    return x


@pytest.mark.parametrize("mode", ["runtime", "converter"])
def test_torch_codec_bit_exact(mode):
    x = _codec_inputs()
    jq, js = jax_codec.q80_encode_blocks(jnp.asarray(x), mode=mode)
    tq, ts = torch_codec.q80_encode_blocks(torch.from_numpy(x), mode=mode)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint16), np.asarray(js).view(np.uint16))
    np.testing.assert_array_equal(
        torch_codec.q80_decode_blocks(tq, ts, x.shape).numpy(),
        np.asarray(jax_codec.q80_decode_blocks(jq, js, x.shape)))
    np.testing.assert_array_equal(torch_codec.qdq_q80(torch.from_numpy(x), mode).numpy(),
                                  np.asarray(jax_codec.qdq_q80(jnp.asarray(x), mode)))
    assert not tq[1, 1].any() and float(ts[1, 1]) == 0.0


def test_codec_modes_part_on_ties():
    x = torch.from_numpy(_codec_inputs())
    runtime, _ = torch_codec.q80_encode_blocks(x, "runtime")
    converter, _ = torch_codec.q80_encode_blocks(x, "converter")
    assert (runtime != converter).sum() > 0
    assert int(runtime[2, 0, 16]) == 1 and int(converter[2, 0, 16]) == 0  # 0.5


def _weight(kind: str, d_in: int, d_out: int, seed: int):
    """(JAX weight, the port's) from one numpy draw."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d_out, d_in)).astype(np.float32) * 0.1
    if kind == "dense":
        return jnp.asarray(w.T), torch.from_numpy(np.ascontiguousarray(w.T))
    packed, scales = pack_q40_host(w)
    return (JaxPacked(jnp.asarray(packed), jnp.asarray(scales)),
            PackedQ40(torch.from_numpy(np.asarray(packed)),
                      torch.from_numpy(np.asarray(scales))))


def _jax_interpret(fn, *args):
    """``fn(*args)`` jitted afresh (the interpret flag is read at trace
    time) with the JAX Q40 kernel in interpret mode."""
    j_linear.set_pallas_interpret(True)
    try:
        return np.asarray(jax.jit(fn)(*args))
    finally:
        j_linear.set_pallas_interpret(False)


def _sync_case(tp, kind, d_in, d_out, seed):
    mesh = make_mesh(MeshPlan(tp=tp), ["cpu"] * tp)
    x = np.random.default_rng(seed).standard_normal((2, 3, d_in)).astype(np.float32)
    jw, tw = _weight(kind, d_in, d_out, seed)
    xs = [torch.from_numpy(np.ascontiguousarray(a)) for a in np.split(x, tp, axis=-1)]
    return j_make_mesh(JaxPlan(tp=tp)), x, jw, xs, col_shards(tw, mesh)


def _close(got: list, want: np.ndarray, rel: float) -> None:
    scale = np.abs(want).max()
    for g in got:
        assert g.shape == want.shape
        assert np.abs(g.numpy() - want).max() <= rel * scale
    for g in got[1:]:  # the gather leaves the same bits on every rank
        assert torch.equal(g, got[0])


# f32 wire: the reduce order is the same, so only the Q40 partials' own
# summation order parts the two (the JAX kernel's tiles against the plain
# version's matmul): 1e-4 of max|y|. Q80 wire: an input that differs by 1e-7
# can flip one Q80 rounding, one step of a block's scale: the Q80 class,
# 2e-2 of max|y|.
F32_REL, Q80_REL = 1e-4, 2e-2


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("kind", ["dense", "packed"])
@pytest.mark.parametrize("q80_wire", [False, True])
def test_ring_sync_matmul_matches_jax(tp, kind, q80_wire):
    jmesh, x, jw, xs, ws = _sync_case(tp, kind, 64 * tp, 64 * tp, seed=20 + tp)
    want = _jax_interpret(lambda a, b: jrc.ring_sync_matmul(a, b, jmesh, q80_wire=q80_wire),
                          jnp.asarray(x), jw)
    _close(rc.ring_sync_matmul(xs, ws, q80_wire=q80_wire), want,
           Q80_REL if q80_wire else F32_REL)


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_q80_sync_matmul_matches_jax(tp, kind):
    jmesh, x, jw, xs, ws = _sync_case(tp, kind, 64 * tp, 32 * tp, seed=30 + tp)
    want = _jax_interpret(lambda a, b: jcoll.q80_sync_matmul(a, b, jmesh), jnp.asarray(x), jw)
    _close(coll.q80_sync_matmul(xs, ws), want, Q80_REL)


def test_ring_sync_matmul_rejects_indivisible():
    mesh = make_mesh(MeshPlan(tp=4), ["cpu"] * 4)
    x = [torch.zeros(2, 32)] * 4
    ws = col_shards(torch.zeros(128, 96), mesh)  # chunks of 24: not whole Q80 blocks
    with pytest.raises(ValueError, match="whole Q80 blocks"):
        rc.ring_sync_matmul(x, ws, q80_wire=True)
    assert rc.ring_sync_supported(96, 4) and not rc.ring_sync_supported(96, 4, True)
    with pytest.raises(ValueError, match="divisible"):
        coll.q80_sync_matmul(x, ws)


MESH_SHAPES = [{"tp": 1}, {"tp": 2}, {"tp": 4}, {"tp": 8}, {"tp": 2, "sp": 2},
               {"tp": 2, "dp": 2}, {"tp": 4, "pp": 2}, {"tp": 2, "ep": 2}]
CONFIGS = [dict(dim=64, hidden_dim=128, n_layers=1, n_heads=4, n_kv_heads=4,
                vocab_size=64, seq_len=16),
           dict(dim=256, hidden_dim=512, n_layers=2, n_heads=8, n_kv_heads=4,
                vocab_size=128, seq_len=32),
           dict(dim=2048, hidden_dim=8192, n_layers=16, n_heads=32, n_kv_heads=8,
                vocab_size=128256, seq_len=2048),
           dict(dim=96, hidden_dim=200, n_layers=1, n_heads=4, n_kv_heads=4,
                vocab_size=64, seq_len=16)]


@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_engagement_predicates_match_jax(ci):
    """ring_sync_engages and q80_sync_engages give the JAX package's answers
    (its ring flag at its default, on); with --ring-sync off the ring never
    engages."""
    cfg, jcfg = LlamaConfig(**CONFIGS[ci]), JaxConfig(**CONFIGS[ci])
    assert jrc.ring_sync_enabled()
    for shape in MESH_SHAPES:
        assert rc.ring_sync_engages(cfg, shape) == jrc.ring_sync_engages(jcfg, shape)
        assert not rc.ring_sync_engages(cfg, shape, enabled=False)
        assert coll.q80_sync_engages(cfg, shape) == jcoll.q80_sync_engages(jcfg, shape)
        tp = shape["tp"]
        for d in (cfg.dim, cfg.hidden_dim, 60, 96):
            assert rc.ring_sync_supported(d, tp) == jrc.ring_sync_supported(d, tp)
            assert (rc.ring_sync_supported(d, tp, True)
                    == jrc.ring_sync_supported(d, tp, True))
            assert coll.q80_sync_supported(d, tp) == jcoll.q80_sync_supported(d, tp)
