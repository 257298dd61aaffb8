"""The port on a CUDA card: each Q40 kernel against its plain version (the
tensor-core kernels at their fragment edges), the dispatch's mode routing
at the m = 32/33 boundary, a tiny model served by the engine on the card,
the ring-step kernel's forms against its plain version, the tensor-parallel
forward with two ranks on one card, the sampler and attention kernels
against their plain versions and the decode graphs against the eager
bodies. Marked ``gpu``; without a card every test skips.

This file imports neither jax nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -m gpu -q

``chip_smoke.py`` runs the same comparisons at the full-width sites.
"""

import numpy as np
import pytest
import torch

from distributed_llama_multiusers_tpu_torch.ops import cuda_q40 as q
from distributed_llama_multiusers_tpu_torch.quants.codec import q40_to_planar, quantize_q40
from distributed_llama_multiusers_tpu_torch.quants.packed import PackedQ40, pack_q40_planar

TOL = 1e-4  # max|kernel - plain| <= TOL * max|plain|, f32 outputs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weight(rng, d_out, d_in, device, scale=0.1):
    w = rng.standard_normal((d_out, d_in), dtype=np.float32) * scale
    values, scales = q40_to_planar(quantize_q40(w.reshape(-1)))
    packed, s = pack_q40_planar(values.reshape(d_out, d_in),
                                scales.reshape(d_out, d_in // 32))
    return PackedQ40(torch.from_numpy(packed).to(device), torch.from_numpy(s).to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("m,d_in,d_out", [(1, 1376, 128), (5, 256, 5504), (8, 2048, 512),
                                          (32, 256, 11008), (33, 1376, 128), (300, 64, 256)])
def test_kernels_match_plain(cuda, m, d_in, d_out):
    rng = np.random.default_rng(m + d_in + d_out)
    w = _weight(rng, d_out, d_in, cuda)
    acts = q.make_q80_acts(torch.from_numpy(
        rng.standard_normal((m, d_in), dtype=np.float32)).to(cuda))
    pairs = [(q.q40_slab(acts, w, dt, mode),
              q.q40_slab_plain(acts.x2, w, dt, mode, bsum=acts.bsum))
             for mode in ("v4", "bf16chain") for dt in (torch.bfloat16, torch.float32)]
    if m <= q.BLOCKDOT_MAX_M:
        pairs.append((q.q40_blockdot(acts, w), q.q40_blockdot_plain(acts.x2, w, bsum=acts.bsum)))
        pairs.append((q.q40_i8blockdot(acts, w), q.q40_i8blockdot_plain(acts, w)))
    torch.cuda.synchronize()
    for got, ref in pairs:
        assert got.shape == ref.shape == (m, d_out)
        assert float((got - ref).abs().max()) <= TOL * float(ref.abs().max())


_PLAIN_OF = {
    "q40_slab": lambda a, w, mode: q.q40_slab_plain(a.x2, w, torch.bfloat16, mode, bsum=a.bsum),
    "q40_blockdot": lambda a, w, mode: q.q40_blockdot_plain(a.x2, w, bsum=a.bsum),
    "q40_i8blockdot": lambda a, w, mode: q.q40_i8blockdot_plain(a, w),
}


@pytest.mark.gpu
@pytest.mark.parametrize("d_out", [6, 520, 1026])
@pytest.mark.parametrize("m", [1, 8, 33])
def test_any_width_matches_plain(cuda, m, d_out):
    """Q40 products of any width: d_out = 6 and 1026 (d_out % 4 == 2: the
    column-tail instantiation of every kernel) and 520 (d_out % 16 == 8:
    the slab's plain-load stage). Each kernel through its wrapper, then
    every mode through the dispatch (``auto`` included), against its plain
    version; d_in = 1376 (43 quant blocks) leaves a ragged last split."""
    d_in = 1376
    rng = np.random.default_rng(m * 7 + d_out)
    w = _weight(rng, d_out, d_in, cuda)
    acts = q.make_q80_acts(torch.from_numpy(
        rng.standard_normal((m, d_in), dtype=np.float32)).to(cuda))
    pairs = [(q.q40_slab(acts, w, dt, mode),
              q.q40_slab_plain(acts.x2, w, dt, mode, bsum=acts.bsum))
             for mode in ("v4", "bf16chain") for dt in (torch.bfloat16, torch.float32)]
    if m <= q.BLOCKDOT_MAX_M:
        pairs.append((q.q40_blockdot(acts, w), q.q40_blockdot_plain(acts.x2, w, bsum=acts.bsum)))
        pairs.append((q.q40_i8blockdot(acts, w), q.q40_i8blockdot_plain(acts, w)))
    for mode in ("v4", "bf16chain", "blockdot", "i8blockdot", "auto"):
        q.set_dequant_mode(mode)
        try:
            run = q.resolve_kernel_mode(m, d_in, d_out, torch.bfloat16)
            kernel = {"blockdot": "q40_blockdot", "i8blockdot": "q40_i8blockdot"}.get(
                run, "q40_slab")
            before = dict(q.LAUNCHES)
            pairs.append((q.q40_matmul(acts, w), _PLAIN_OF[kernel](acts, w, run)))
            assert [k for k in q.KERNELS if q.LAUNCHES[k] != before[k]] == [kernel]
        finally:
            q.set_dequant_mode(None)
    torch.cuda.synchronize()
    for got, ref in pairs:
        assert got.shape == ref.shape == (m, d_out)
        assert bool(torch.isfinite(got).all())
        assert float((got - ref).abs().max()) <= TOL * float(ref.abs().max())


def _random_planes(rng, d_in, d_out, device, scales=None):
    """Random packed bytes and f16 scales (N(0, 0.01) unless given)."""
    packed = rng.integers(0, 256, (d_in // 2, d_out), dtype=np.uint8)
    if scales is None:
        scales = (rng.standard_normal((d_in // 32, d_out)) * 0.01).astype(np.float16)
    return PackedQ40(torch.from_numpy(packed).to(device), torch.from_numpy(scales).to(device))


def _assert_close(got, ref, dtype):
    """f32 outputs within TOL of max|plain|; bf16 outputs also within one
    bf16 rounding step of each value (both sides round an f32 result)."""
    assert got.shape == ref.shape and got.dtype == ref.dtype == dtype
    got, ref = got.float(), ref.float()
    assert bool(torch.isfinite(got).all())
    err = (got - ref).abs()
    tol = TOL * float(ref.abs().max())
    if dtype == torch.float32:
        assert float(err.max()) <= tol, (float(err.max()), tol)
    else:
        assert bool((err <= tol + 2.0 ** -7 * ref.abs()).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_out", [16, 48, 520, 1026, 8192])
@pytest.mark.parametrize("d_in", [32, 64, 2048])
@pytest.mark.parametrize("m", [1, 7, 8, 9, 16, 17, 32])
def test_blockdot_tensor_core_edges(cuda, m, d_in, d_out, dtype):
    """The tensor-core blockdot kernel against its plain version at the
    edges of its fragments: m = 1 (N padded to 8), 7/9/17 (partial N-tiles
    and m-tiles), 16 and 32 (two N-tiles); one quant block (no split: the
    kernel writes the output), two, and many (split-K planes summed by
    reduce_splits); d_out = 16 (one M-tile), 48 (a partial 512 tile), 520
    and 1026 (the plain-load stage, 1026 with a column tail), 8192 (many
    column tiles)."""
    rng = np.random.default_rng(m * 1000 + d_in + d_out)
    w = _random_planes(rng, d_in, d_out, cuda)
    x = torch.from_numpy(rng.standard_normal((m, d_in), dtype=np.float32)).to(cuda, dtype)
    acts = q.make_q80_acts(x)
    before = q.LAUNCHES["q40_blockdot"]
    got = q.q40_blockdot(acts, w)
    ref = q.q40_blockdot_plain(acts.x2, w, bsum=acts.bsum)
    torch.cuda.synchronize()
    assert q.LAUNCHES["q40_blockdot"] == before + 1
    _assert_close(got, ref, dtype)


@pytest.mark.gpu
def test_blockdot_extreme_scales_and_activations(cuda):
    """f16-extreme scales (65504 and the smallest subnormal, 2^-24) and x
    spanning 1e-3..1e3 in magnitude, at a split plan and a single one."""
    rng = np.random.default_rng(7)
    for m, d_in, d_out in ((8, 2048, 1024), (1, 32, 48)):
        scales = np.where(rng.random((d_in // 32, d_out)) < 0.5, 65504.0,
                          2.0 ** -24).astype(np.float16)
        scales *= np.where(rng.random(scales.shape) < 0.5, -1, 1).astype(np.float16)
        w = _random_planes(rng, d_in, d_out, cuda, scales)
        mag = 10.0 ** rng.uniform(-3, 3, (m, d_in))
        x = (mag * np.sign(rng.standard_normal((m, d_in)))).astype(np.float32)
        acts = q.make_q80_acts(torch.from_numpy(x).to(cuda))
        got = q.q40_blockdot(acts, w)
        ref = q.q40_blockdot_plain(acts.x2, w, bsum=acts.bsum)
        torch.cuda.synchronize()
        _assert_close(got, ref, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("mt", [1, 8, 16])
def test_blockdot_info_reports_ring_and_no_spills(cuda, mt):
    info = q.blockdot_info(mt)
    assert info["stages"] == 3
    assert info["local_bytes"] == 0, info
    assert 0 < info["registers"] <= 255 and info["smem_bytes"] <= 48 * 1024, info


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_out", [16, 48, 520, 1026, 8192])
@pytest.mark.parametrize("d_in", [32, 64, 2048])
@pytest.mark.parametrize("m", [1, 7, 8, 9, 16, 17, 32])
def test_i8blockdot_tensor_core_edges(cuda, m, d_in, d_out, dtype):
    """The tensor-core i8blockdot kernel (int8 mma.sync m16n8k32) against its
    plain version at the edges of its fragments, as blockdot's: m around
    its N-tiles and m-tiles, one, two and many quant blocks, one M-tile, a
    partial 512 tile, the plain-load stage and a column tail, many tiles."""
    rng = np.random.default_rng(m * 1000 + d_in + d_out + 7)
    w = _random_planes(rng, d_in, d_out, cuda)
    x = torch.from_numpy(rng.standard_normal((m, d_in), dtype=np.float32)).to(cuda, dtype)
    acts = q.make_q80_acts(x)
    before = q.LAUNCHES["q40_i8blockdot"]
    got = q.q40_i8blockdot(acts, w)
    ref = q.q40_i8blockdot_plain(acts, w)
    torch.cuda.synchronize()
    assert q.LAUNCHES["q40_i8blockdot"] == before + 1
    _assert_close(got, ref, dtype)


@pytest.mark.gpu
def test_i8blockdot_extreme_scales_and_saturation(cuda):
    """f16-extreme scales (+-65504 and the smallest subnormal, 2^-24) with x
    spanning 1e-3..1e3; x whose int8 values saturate at +-127 against
    all-15 nibbles (block dots of +-60,960, the int32 extreme); all-zero
    blocks, where sx = 1e-8/127 and bsum = 0; at a split plan and a single
    one."""
    rng = np.random.default_rng(8)
    for m, d_in, d_out in ((8, 2048, 1024), (1, 32, 48), (17, 64, 48)):
        scales = np.where(rng.random((d_in // 32, d_out)) < 0.5, 65504.0,
                          2.0 ** -24).astype(np.float16)
        scales *= np.where(rng.random(scales.shape) < 0.5, -1, 1).astype(np.float16)
        w = _random_planes(rng, d_in, d_out, cuda, scales)
        mag = 10.0 ** rng.uniform(-3, 3, (m, d_in))
        x = (mag * np.sign(rng.standard_normal((m, d_in)))).astype(np.float32)
        acts = q.make_q80_acts(torch.from_numpy(x).to(cuda))
        got = q.q40_i8blockdot(acts, w)
        ref = q.q40_i8blockdot_plain(acts, w)
        torch.cuda.synchronize()
        _assert_close(got, ref, torch.float32)
    for m, d_in, d_out in ((8, 2048, 1024), (17, 64, 48)):
        packed = rng.integers(0, 256, (d_in // 2, d_out), dtype=np.uint8)
        packed[:, : d_out // 2] = 0xFF
        w = _random_planes(rng, d_in, d_out, cuda)
        w = PackedQ40(torch.from_numpy(packed).to(cuda), w.scales)
        sign = np.where(rng.random((m, d_in // 32, 1)) < 0.5, -1.0, 1.0)
        x = np.broadcast_to(sign * 3.0, (m, d_in // 32, 32)).reshape(m, d_in).copy()
        x[::2, : d_in // 2] = 0.0
        acts = q.make_q80_acts(torch.from_numpy(x.astype(np.float32)).to(cuda))
        assert int(acts.xq.abs().max()) == 127
        assert float(acts.sx.min()) == pytest.approx(1e-8 / 127)
        got = q.q40_i8blockdot(acts, w)
        ref = q.q40_i8blockdot_plain(acts, w)
        torch.cuda.synchronize()
        _assert_close(got, ref, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("mt", [1, 8, 16])
def test_i8blockdot_info_reports_ring_and_no_spills(cuda, mt):
    info = q.i8blockdot_info(mt)
    assert info["stages"] == 3
    assert info["local_bytes"] == 0, info
    assert 0 < info["registers"] <= 255 and info["smem_bytes"] <= 48 * 1024, info


@pytest.mark.gpu
@pytest.mark.parametrize("mode,at32", [("auto", "q40_i8blockdot"), ("blockdot", "q40_blockdot"),
                                       ("v4", "q40_slab")])
def test_dispatch_routes_at_the_boundary(cuda, mode, at32):
    rng = np.random.default_rng(4)
    w = _weight(rng, 256, 128, cuda)
    q.set_dequant_mode(mode)
    try:
        for m, expect in ((32, at32), (33, "q40_slab")):
            before = dict(q.LAUNCHES)
            y = q.q40_matmul(torch.randn(m, 128, device=cuda, dtype=torch.bfloat16), w)
            torch.cuda.synchronize()
            assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())
            assert [k for k in q.KERNELS if q.LAUNCHES[k] != before[k]] == [expect]
    finally:
        q.set_dequant_mode(None)


@pytest.mark.gpu
def test_engine_serves_tiny_model_on_card(cuda, tmp_path):
    from distributed_llama_multiusers_tpu_torch.formats import load_model_header
    from distributed_llama_multiusers_tpu_torch.formats.synthetic import (
        tiny_header,
        write_synthetic_model,
    )
    from distributed_llama_multiusers_tpu_torch.models import load_params_from_m_quantized
    from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine

    path = str(tmp_path / "m.m")
    write_synthetic_model(path, tiny_header(), seed=0)
    config, params = load_params_from_m_quantized(path, load_model_header(path),
                                                  dtype=torch.bfloat16, device=cuda)
    engine = InferenceEngine(config, params, n_lanes=2, prefill_buckets=(8,))
    assert engine.device.type == "cuda" and engine.cache_dtype == torch.bfloat16
    q.reset_counts()
    logits, tok, pos = engine.prefill(0, [5, 9, 3, 17, 2])
    tokens = np.asarray([tok, 0])
    positions = np.asarray([pos, config.seq_len])
    step, greedy, _ = engine.decode(tokens, positions)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step).all())
    assert 0 <= int(greedy[0]) < config.vocab_size
    assert q.LAUNCHES["q40_slab"] == 2 * (7 * config.n_layers + 1)
    assert q.PLAIN_CALLS == {k: 0 for k in q.KERNELS}


def _offset_tensors(cuda, shape, dtype, offset, n=3, scale=50):
    """n tensors of ``shape``, each an element ``offset`` into its buffer
    (offset 1 leaves the data off 16-byte alignment)."""
    size = int(np.prod(shape))
    return [(torch.randn(size + offset, device=cuda) * scale).to(dtype)[offset:].view(shape)
            for _ in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,offset", [((8, 1024), torch.float32, 0),
                                                 ((8, 32, 1), torch.float16, 0),
                                                 ((3, 37), torch.int8, 0),
                                                 ((5, 33), torch.float32, 1),
                                                 ((8, 1024), torch.bfloat16, 0),
                                                 ((5, 33), torch.bfloat16, 1)])
def test_ring_hop_matches_plain(cuda, shape, dtype, offset):
    """The ring-step kernel bit for bit against its plain version: the bare
    hop (16-byte vector copies with a byte tail, int8 [3, 37]: 111 bytes,
    and the element path for a source that is not 16-byte aligned); the add
    form (f32 and bf16 addends into f32, bf16 into bf16, rounded once);
    the slot form (into column slot 1 of a [..., 3 * C] output, the rest of
    which stays as it was); two segments in one launch (the payload and an
    f16 side payload, as the Q80 wire's values and scales ride)."""
    from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc

    n = 3
    xs = _offset_tensors(cuda, shape, dtype, offset, n)
    rc.reset_counts()
    got, ref = rc.ring_shift(xs), rc.ring_shift_plain(xs)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, ref))
    assert rc.COUNTS["launches"] == n and rc.COUNTS["plain_calls"] == 0
    assert rc.COUNTS["bytes"] == n * xs[0].numel() * xs[0].element_size()

    def both(build):
        """The same step through the kernel and the plain version, on
        destinations that start equal."""
        outs_k, outs_p = build(), build()
        for a, b in zip(outs_k[0], outs_p[0]):
            b.copy_(a)
        rc.ring_step(outs_k[1])
        rc.ring_step_plain(outs_p[1])
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs_k[0], outs_p[0]))

    adds = {torch.float32: (torch.float32, torch.bfloat16),
            torch.bfloat16: (torch.bfloat16,)}.get(dtype, ())
    for add_dtype in adds:
        addend = _offset_tensors(cuda, shape, add_dtype, offset, n)

        def add_form(addend=addend):
            dst = [torch.full_like(x, 3) for x in xs]
            return dst, [[rc.Seg(xs[(r - 1) % n], dst[r], addend[r])] for r in range(n)]

        both(add_form)
    c = shape[-1]

    def slot_form():
        outs = [(torch.randn(*shape[:-1], n * c, device=cuda) * 9).to(dtype) for _ in range(n)]
        return outs, [[rc.Seg(xs[(r - 1) % n], outs[r][..., c:2 * c])] for r in range(n)]

    side = [torch.randn(shape[0], 2, device=cuda).to(torch.float16) for _ in range(n)]

    def two_segments():
        dst = [torch.empty_like(x) for x in xs]
        sdst = [torch.empty_like(t) for t in side]
        return dst + sdst, [[rc.Seg(xs[(r - 1) % n], dst[r]), rc.Seg(side[(r - 1) % n], sdst[r])]
                            for r in range(n)]

    both(slot_form)
    both(two_segments)
    if dtype == torch.float32:  # a slot form with its add: the last reduce hop
        addend = [torch.randn(shape, device=cuda).to(torch.bfloat16) for _ in range(n)]

        def add_slot():
            outs = [torch.zeros(*shape[:-1], n * c, device=cuda) for _ in range(n)]
            return outs, [[rc.Seg(xs[(r - 1) % n], outs[r][..., 2 * c:], addend[r])]
                          for r in range(n)]

        both(add_slot)


@pytest.mark.gpu
def test_tp_engine_on_one_card_matches_single_device(cuda, tmp_path):
    """--workers 2 with both ranks on one card (cuda:0,cuda:0): the f32 TP
    forward against the single-device forward, and the ring hop launched."""
    from distributed_llama_multiusers_tpu_torch.formats import load_model_header
    from distributed_llama_multiusers_tpu_torch.formats.synthetic import (
        tiny_header,
        write_synthetic_model,
    )
    from distributed_llama_multiusers_tpu_torch.models import (
        init_kv_cache,
        llama_forward,
        load_params_from_m_quantized,
    )
    from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc
    from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
    from distributed_llama_multiusers_tpu_torch.parallel.sharding import (
        shard_kv_cache,
        shard_params,
    )

    path = str(tmp_path / "m.m")
    write_synthetic_model(path, tiny_header(), seed=0)
    config, params = load_params_from_m_quantized(path, load_model_header(path),
                                                  dtype=torch.float32, device=cuda)
    mesh = make_mesh(MeshPlan(tp=2), ["cuda:0", "cuda:0"])
    tokens = torch.tensor([[5, 9, 3, 17, 2]], device=cuda)
    positions = torch.arange(5, device=cuda)[None]
    rc.reset_counts()
    got, _ = llama_forward(config, shard_params(params, mesh), tokens, positions,
                           shard_kv_cache(init_kv_cache(config, 1, device=cuda), mesh),
                           mesh=mesh)
    ref, _ = llama_forward(config, params, tokens, positions,
                           init_kv_cache(config, 1, device=cuda))
    torch.cuda.synchronize()
    assert rc.COUNTS["launches"] == 2 * (4 * config.n_layers + 1)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


# ---------------------------------------------------------------------------
# The kernel lab's kernels (ops/cuda_lab.py) against their plain versions
# ---------------------------------------------------------------------------


def _lab_planes(cuda, shape, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    packed = torch.randint(0, 256, shape, dtype=torch.uint8, device=cuda, generator=g)
    sshape = (*shape[:-2], shape[-2] // 16, shape[-1])
    scales = (torch.rand(sshape, device=cuda, generator=g) * 0.01 + 1e-3).to(torch.float16)
    return packed, scales


@pytest.mark.gpu
@pytest.mark.parametrize("shape,tile_rows", [((2, 64, 1024), None), ((3, 2, 96, 512), None),
                                             ((2, 128, 1040), 32), ((1, 1024, 14336), 256)])
def test_lab_probe_matches_plain(cuda, shape, tile_rows):
    """Every stage bit for bit (integer sums are exact in f32; the dma row
    is a copy), the scale stage within TOL; u8 bytes and u32 words; the
    row-major, slab and wide layouts, a ragged last column block."""
    from distributed_llama_multiusers_tpu_torch.ops import cuda_lab as lab

    packed, scales = _lab_planes(cuda, shape, sum(shape))
    lab.reset_counts()
    cases = [(packed, st, scales if st == "scale" else None) for st in lab.STAGES]
    if shape[-1] % 4 == 0:
        cases += [(packed.view(torch.int32), st, None) for st in lab.U32_STAGES]
    for p, stage, sc in cases:
        got = lab.q40_probe(p, stage, sc, tile_rows)
        ref = lab.q40_probe_plain(p, stage, sc, tile_rows)
        torch.cuda.synchronize()
        assert got.shape == ref.shape
        if stage == "scale":
            assert float((got - ref).abs().max()) <= TOL * float(ref.abs().max())
        else:
            assert torch.equal(got, ref), (p.dtype, stage)
    assert lab.LAUNCHES["q40_probe"] == len(cases) and lab.PLAIN_CALLS["q40_probe"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("m,d_in,d_out,tile", [(1, 4096, 1536, 512), (8, 2048, 1024, 256),
                                               (13, 256, 2048, 2048)])
def test_lab_twodot_matches_plain(cuda, m, d_in, d_out, tile):
    from distributed_llama_multiusers_tpu_torch.ops import cuda_lab as lab

    packed, scales = _lab_planes(cuda, (d_in // 2, d_out), m + d_in)
    tiled = lab.retile(packed, scales, tile)
    x = torch.randn(m, d_in, device=cuda)
    for p, s in ((packed, scales), tiled):
        for w_round in lab.W_ROUNDS:
            for x_round in (False, True):
                for corr in (True, False):
                    got = lab.q40_lab_twodot(x, p, s, w_round, x_round, corr)
                    ref = lab.q40_lab_twodot_plain(x, p, s, w_round, x_round, corr)
                    torch.cuda.synchronize()
                    assert got.shape == ref.shape == (m, d_out)
                    assert float((got - ref).abs().max()) <= TOL * float(ref.abs().max())
    got = lab.q40_lab_twodot(x, packed, scales, k_chunk=256)  # a pinned split-K range
    ref = lab.q40_lab_twodot_plain(x, packed, scales)
    assert float((got - ref).abs().max()) <= TOL * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 32])
def test_dense_dot_matches_plain(cuda, m):
    from distributed_llama_multiusers_tpu_torch.ops import cuda_lab as lab

    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(m, 2048, device=cuda).to(dt)
        w = torch.randn(2048, 1000, device=cuda).to(dt)
        got, ref = lab.dense_dot(x, w), lab.dense_dot_plain(x, w)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= TOL * float(ref.abs().max())


@pytest.mark.gpu
def test_lab_probe_dma_moves_its_bytes(cuda):
    """A dma stage whose copies were dropped would run far faster than the
    byte-sum stage over the same 235 MB stack and beat the card's memory
    rate; this one moves the bytes."""
    from distributed_llama_multiusers_tpu_torch.lab.timing import HBM_BYTES_S, pass_ms
    from distributed_llama_multiusers_tpu_torch.ops import cuda_lab as lab

    packed, _ = _lab_planes(cuda, (8, 2048, 14336), 0)
    dma = pass_ms(lambda: lab.q40_probe(packed, "dma"), cuda)
    sums = pass_ms(lambda: lab.q40_probe(packed, "bytes"), cuda)
    nbytes = packed.numel()
    assert dma >= 0.5 * sums, (dma, sums)
    assert nbytes / (dma * 1e-3) <= 1.1 * HBM_BYTES_S, dma


@pytest.mark.gpu
def test_lab_runs_on_card(cuda, tmp_path):
    """kernel_lab3 --check on the card, each lab module at a small shape,
    and --adopt into a table file of the test's own."""
    import json

    from distributed_llama_multiusers_tpu_torch.lab import (
        kernel_lab,
        kernel_lab3,
        stage_probe,
        stage_probe2,
    )

    assert all(r["ok"] for r in kernel_lab3.check("cuda"))
    lines = []
    kernel_lab.run(2, 1024, 2048, 2, "cuda", reps=2, plain=True, out=lines.append)
    stage_probe.run(2048, 2048, 2, 2, "cuda", plain=True, out=lines.append)
    stage_probe2.run(2048, 2048, 2, 2, "cuda", plain=True, out=lines.append)
    rows, times = kernel_lab3.run(1024, 2048, 2, 2, "cuda", plain=True, out=lines.append)
    assert not any("FAILED" in ln for ln in lines)
    assert all(r["ms"] > 0 and r["gb_s"] > 0 for r in rows)
    path = str(tmp_path / "table.json")
    mode, _ = kernel_lab3.adopt(times, 1024, 2048, "cuda", path=path, out=lines.append)
    rule = json.load(open(path))["rules"][0]
    assert (rule["d_in"], rule["d_out"], rule["m_class"], rule["mode"]) == (1024, 2048,
                                                                           "decode", mode)


# ---------------------------------------------------------------------------
# The sampler kernel and the decode families' CUDA graphs
# ---------------------------------------------------------------------------

# the kernel and the plain version both run -log(-log(u)) with the
# full-precision logf: at most a few ulps apart at |g| ~ 1
GUMBEL_ATOL = 2.0 ** -20


def _sampler_rows(cuda, vocab, temp, topp, seed):
    """8 lanes of sorted nucleus log-probabilities, the last two replaced by
    edge rows: every entry masked, and only the last entry finite."""
    from distributed_llama_multiusers_tpu_torch.runtime import sampling as S

    n = 8
    gen = torch.Generator(device=cuda).manual_seed(seed)
    rows = torch.randn((n, vocab), device=cuda, generator=gen) * 3
    logp, _ = S.nucleus_logp(rows, torch.full((n,), temp, device=cuda),
                             torch.full((n,), topp, device=cuda))
    logp[6:] = float("-inf")
    logp[7, -1] = 0.0
    seeds = torch.arange(n, device=cuda) * 7919 + 3
    positions = torch.arange(n, device=cuda) * 131 + 40
    return logp, seeds, positions


@pytest.mark.gpu
@pytest.mark.parametrize("vocab", [1, 31, 4097, 128256, 151936])
@pytest.mark.parametrize("temp,topp", [(0.8, 0.9), (1.0, 1.0), (0.3, 0.5)])
def test_gumbel_sample_matches_plain(cuda, temp, topp, vocab):
    """8 lanes over vocabularies from 1 to 151,936 (one chunk, across
    chunks, no multiple of the chunk; 128,256 is the 1B vocabulary): the
    kernel's choices equal the plain version's, an all -inf row picks 0, a
    row whose only finite entry is its last picks it, and the noise lies
    within GUMBEL_ATOL of the plain version's at every unmasked entry."""
    from distributed_llama_multiusers_tpu_torch.ops import cuda_sample
    from distributed_llama_multiusers_tpu_torch.runtime import sampling as S

    logp, seeds, positions = _sampler_rows(cuda, vocab, temp, topp,
                                           int(temp * 10 + topp * 100) + vocab)
    noise = torch.full(logp.shape, float("nan"), device=cuda)
    cuda_sample.reset_counts()
    got = cuda_sample.gumbel_argmax(logp, seeds, positions, noise_out=noise)
    want = S.gumbel_argmax_plain(logp, seeds, positions)
    k0, k1 = S.fold_in_keys(seeds, positions)
    ref = S.gumbel_noise(k0, k1, vocab)
    torch.cuda.synchronize()
    assert cuda_sample.COUNTS == {"launches": 1, "plain_calls": 0}
    assert torch.equal(got, want)
    assert got[6:].tolist() == [0, vocab - 1]
    kept = torch.isfinite(logp)
    assert bool(kept[:6].any(dim=-1).all())
    assert float((noise[kept] - ref[kept]).abs().max()) <= GUMBEL_ATOL


def _graph_replay_equals_eager(calls):
    """Two kernel calls captured in one CUDA graph, replayed twice: each
    replay's outputs equal the eager calls' bit for bit (the per-call
    scratch and tickets start fresh on every replay)."""
    eager = [c() for c in calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = [c() for c in calls]
    for _ in range(2):
        for o in outs:
            o.fill_(-1)
        g.replay()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e)


@pytest.mark.gpu
def test_gumbel_sample_graph_replay_equals_eager(cuda):
    from distributed_llama_multiusers_tpu_torch.ops import cuda_sample

    a = _sampler_rows(cuda, 128256, 0.8, 0.9, seed=1)
    b = _sampler_rows(cuda, 4097, 1.0, 1.0, seed=2)
    _graph_replay_equals_eager([lambda: cuda_sample.gumbel_argmax(*a),
                                lambda: cuda_sample.gumbel_argmax(*b)])


# the kernel sums the slots in another order than the plain version's two
# passes (per split of 128, the splits folded): f32 rounding over up to 2048
# slots
ATTN_TOL = 2e-5  # max|kernel - plain| <= ATTN_TOL * max|plain|


def _attn_inputs(cuda, lanes, n_kv, group, hd, slots, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    qf = torch.randn((lanes, 1, n_kv, group, hd), device=cuda, generator=gen)
    k = torch.randn((lanes, slots + 1, n_kv, hd), device=cuda, generator=gen).to(dtype)
    v = torch.randn((lanes, slots + 1, n_kv, hd), device=cuda, generator=gen).to(dtype)
    return qf, k, v


def _attn_positions(rule, s_len, split):
    """8 lanes' positions: spanning the cache (the first slot, the middle,
    the last slot and a parked lane past it, which attends every slot), on
    and beside the kernel's split boundaries, or every lane parked."""
    if rule == "spread":
        pos = [0, 1, s_len // 2, s_len - 2, s_len - 1, s_len, 7, s_len // 3]
    elif rule == "boundaries":
        pos = [split - 1, split, split + 1, 2 * split - 1, 2 * split, 2 * split + 1,
               3 * split, s_len - 1]
    else:
        pos = [s_len] * 8
    return torch.tensor([[p] for p in pos])


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["spread", "boundaries", "parked"])
@pytest.mark.parametrize("n_kv,group,hd,dtype,s_len", [
    (8, 4, 64, torch.bfloat16, 2048),  # Llama-3.2-1B at the smoke's seq_len
    (4, 4, 64, torch.bfloat16, 2048),  # one rank of it at tp=2
    (2, 2, 16, torch.float32, 64),  # the tiny test model
    (4, 7, 128, torch.bfloat16, 300),  # no multiple of the split
    (2, 1, 96, torch.float32, 100),
    (3, 8, 128, torch.float32, 1000),
    (2, 3, 36, torch.bfloat16, 777)])  # a head of no whole 16-byte chunks
def test_decode_attn_matches_plain(cuda, n_kv, group, hd, dtype, s_len, rule):
    """The attention kernel against its plain version at 8 lanes whose
    positions follow ``rule`` (``_attn_positions``)."""
    from distributed_llama_multiusers_tpu_torch.ops import cuda_attn

    qf, k, v = _attn_inputs(cuda, 8, n_kv, group, hd, s_len, dtype, seed=hd + group)
    positions = _attn_positions(rule, s_len, cuda_attn.SPLIT).to(cuda)
    scale = 1.0 / hd ** 0.5
    cuda_attn.reset_counts()
    got = cuda_attn.decode_attention(qf, k, v, positions, scale, s_len)
    want = cuda_attn.decode_attention_plain(qf, k, v, positions, scale, s_len)
    torch.cuda.synchronize()
    assert cuda_attn.COUNTS == {"launches": 1, "window_launches": 0, "plain_calls": 0}
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATTN_TOL * float(want.abs().max())


@pytest.mark.gpu
def test_decode_attn_lane_bits_independent_of_the_batch(cuda):
    """A lane's output is the same bits whatever the other lanes hold and
    whatever s_len is past its position: the property that keeps a stream
    the same under every serving loop."""
    from distributed_llama_multiusers_tpu_torch.ops import cuda_attn

    qf, k, v = _attn_inputs(cuda, 8, 8, 4, 64, 2048, torch.bfloat16, seed=3)
    scale = 0.125
    base = cuda_attn.decode_attention(qf, k, v, torch.full((8, 1), 100, device=cuda), scale,
                                      2048)
    other = torch.tensor([[100], [2048], [0], [1500], [5], [2047], [64], [900]], device=cuda)
    k2, v2 = k.clone(), v.clone()
    k2[1:], v2[1:] = k2[1:].flip(0), v2[1:].flip(0)
    for pos, kk, vv, s_len in ((other, k, v, 2048), (other, k2, v2, 2048),
                               (other, k, v, 128), (other, k, v, 101)):
        got = cuda_attn.decode_attention(qf, kk, vv, pos, scale, s_len)
        assert torch.equal(got[0], base[0])
    # lane 0 on a split boundary (its last slot opens a split, or closes one)
    for p0 in (cuda_attn.SPLIT, cuda_attn.SPLIT - 1, 2 * cuda_attn.SPLIT):
        alone = cuda_attn.decode_attention(qf, k, v, torch.full((8, 1), p0, device=cuda),
                                           scale, 2048)
        for pos, kk, vv, s_len in ((other, k, v, 2048), (other, k2, v2, 2048),
                                   (other, k, v, p0 + 1)):
            pos = pos.clone()
            pos[0] = p0
            got = cuda_attn.decode_attention(qf, kk, vv, pos, scale, s_len)
            assert torch.equal(got[0], alone[0])


@pytest.mark.gpu
def test_decode_attn_graph_replay_equals_eager(cuda):
    from distributed_llama_multiusers_tpu_torch.ops import cuda_attn

    qf, k, v = _attn_inputs(cuda, 8, 8, 4, 64, 2048, torch.bfloat16, seed=5)
    serving = torch.tensor([[40], [63], [64], [100]] + [[2048]] * 4, device=cuda)
    boundaries = _attn_positions("boundaries", 2048, cuda_attn.SPLIT).to(cuda)
    _graph_replay_equals_eager(
        [lambda: cuda_attn.decode_attention(qf, k, v, serving, 0.125, 2048),
         lambda: cuda_attn.decode_attention(qf, k, v, boundaries, 0.125, 2048)])


@pytest.mark.gpu
def test_decode_attn_rejects_shapes_out_of_range(cuda):
    from distributed_llama_multiusers_tpu_torch.ops import cuda_attn

    pos = torch.zeros((2, 1), dtype=torch.int64, device=cuda)
    qf, k, v = _attn_inputs(cuda, 2, 1, 1, 160, 8, torch.float32, seed=1)
    with pytest.raises(ValueError, match="head size"):
        cuda_attn.decode_attention(qf, k, v, pos, 1.0, 8)
    qf, k, v = _attn_inputs(cuda, 2, 1, 9, 64, 8, torch.float32, seed=1)
    with pytest.raises(ValueError, match="group"):
        cuda_attn.decode_attention(qf, k, v, pos, 1.0, 8)


def _window_positions(rule, lanes, t, s_len, split):
    """Each lane's first row; the rows sit at consecutive positions. The
    serving step's (4 lanes at 40-100, 4 parked), rows across the split
    boundaries, or every lane's rows at and past 2047 (which read at most
    s_len - 1)."""
    if rule == "serving":
        first = [40, 63, 64, 100] + [s_len] * (lanes - 4)
    elif rule == "boundaries":
        first = [split - t, split - 2, split - 1, split, 2 * split - 3, 2 * split - 1,
                 3 * split - 2, s_len - t][:lanes]
    else:
        first = [s_len - 1] * lanes
    return torch.tensor(first)[:, None] + torch.arange(t)[None, :]


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["serving", "boundaries", "at_2047"])
@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("n_kv,group,hd,dtype,s_len", [
    (8, 4, 64, torch.bfloat16, 2048),  # Llama-3.2-1B at the smoke's seq_len
    (4, 4, 64, torch.bfloat16, 2048),  # one rank of it at tp=2
    (3, 8, 128, torch.float32, 1000),  # the largest head and group, f32 slots
    (2, 3, 36, torch.bfloat16, 777)])  # a head of no whole 16-byte chunks
def test_decode_attn_window_matches_plain_and_one_row_calls(cuda, n_kv, group, hd, dtype,
                                                            s_len, t, rule):
    """The verify window (t rows per lane) against its plain version, and
    each row's bits against a T = 1 call at that row's position."""
    from distributed_llama_multiusers_tpu_torch.ops import cuda_attn

    qf, k, v = _attn_inputs(cuda, 8 * t, n_kv, group, hd, s_len, dtype, seed=hd + t)
    qf = qf.reshape(8, t, n_kv, group, hd)
    k, v = k[:8], v[:8]
    positions = _window_positions(rule, 8, t, s_len, cuda_attn.SPLIT).to(cuda)
    scale = 1.0 / hd ** 0.5
    cuda_attn.reset_counts()
    got = cuda_attn.decode_attention(qf, k, v, positions, scale, s_len)
    want = cuda_attn.decode_attention_plain(qf, k, v, positions, scale, s_len)
    torch.cuda.synchronize()
    assert cuda_attn.COUNTS == {"launches": 1, "window_launches": 1, "plain_calls": 0}
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATTN_TOL * float(want.abs().max())
    for row in range(t):
        one = cuda_attn.decode_attention(qf[:, row:row + 1].contiguous(), k, v,
                                         positions[:, row:row + 1].contiguous(), scale, s_len)
        assert torch.equal(got[:, row], one[:, 0]), row


@pytest.mark.gpu
def test_decode_attn_window_runs_on_every_device(cuda):
    """The window at the 1B shape on every card of the host in turn, against
    its plain version: a tensor-parallel mesh runs it on each rank's card,
    so no state of the launch (a function attribute, say) may be set on
    one card only."""
    from distributed_llama_multiusers_tpu_torch.ops import cuda_attn

    for index in range(torch.cuda.device_count()):
        dev = torch.device("cuda", index)
        qf, k, v = _attn_inputs(dev, 32, 8, 4, 64, 2048, torch.bfloat16, seed=7)
        qf, k, v = qf.reshape(8, 4, 8, 4, 64), k[:8], v[:8]
        positions = _window_positions("serving", 8, 4, 2048, cuda_attn.SPLIT).to(dev)
        got = cuda_attn.decode_attention(qf, k, v, positions, 0.125, 2048)
        want = cuda_attn.decode_attention_plain(qf, k, v, positions, 0.125, 2048)
        torch.cuda.synchronize(dev)
        assert got.device == dev and bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= ATTN_TOL * float(want.abs().max()), index


@pytest.mark.gpu
def test_decode_attn_window_graph_replay_equals_eager(cuda):
    from distributed_llama_multiusers_tpu_torch.ops import cuda_attn

    qf, k, v = _attn_inputs(cuda, 32, 8, 4, 64, 2048, torch.bfloat16, seed=6)
    qf, k, v = qf.reshape(8, 4, 8, 4, 64), k[:8], v[:8]
    serving = _window_positions("serving", 8, 4, 2048, cuda_attn.SPLIT).to(cuda)
    boundaries = _window_positions("boundaries", 8, 4, 2048, cuda_attn.SPLIT).to(cuda)
    _graph_replay_equals_eager(
        [lambda: cuda_attn.decode_attention(qf, k, v, serving, 0.125, 2048),
         lambda: cuda_attn.decode_attention(qf, k, v, boundaries, 0.125, 2048)])


def _graph_engines(cuda, tmp_path, mesh_devices=None, n_lanes=3):
    """Two engines on one tiny model on the card: the first replays its
    decode families as CUDA graphs, the second runs the same bodies
    eagerly (its graphs set aside: a test's comparison only)."""
    from distributed_llama_multiusers_tpu_torch.formats import load_model_header
    from distributed_llama_multiusers_tpu_torch.formats.synthetic import (
        tiny_header,
        write_synthetic_model,
    )
    from distributed_llama_multiusers_tpu_torch.models import load_params_from_m_quantized
    from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
    from distributed_llama_multiusers_tpu_torch.parallel.sharding import shard_params
    from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine

    path = str(tmp_path / "m.m")
    write_synthetic_model(path, tiny_header(seq_len=256), seed=0)
    config, params = load_params_from_m_quantized(path, load_model_header(path),
                                                  dtype=torch.bfloat16, device=cuda)
    out = []
    for _ in range(2):
        mesh = None
        p = params
        if mesh_devices is not None:
            mesh = make_mesh(MeshPlan(tp=len(mesh_devices)), mesh_devices)
            p = shard_params(params, mesh)
        out.append(InferenceEngine(config, p, n_lanes=n_lanes, prefill_buckets=(8,),
                                   mesh=mesh))
    out[1].graphs = None
    return config, out


def _launch_counts():
    from distributed_llama_multiusers_tpu_torch.ops import cuda_attn, cuda_sample
    from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc

    return {**q.LAUNCHES, "ring_hop": rc.COUNTS["launches"],
            "ring_bytes": rc.COUNTS["bytes"], "gumbel_sample": cuda_sample.COUNTS["launches"],
            "decode_attn": cuda_attn.COUNTS["launches"]}


def _family_run(engine, config, family):
    """Prefill three lanes, then one family's dispatches (each family's
    first dispatch captures its graph, the later ones replay it); returns
    (tokens, launch counts of the decode dispatches)."""
    temps = np.asarray([0.0, 0.8, 1.1], np.float32)
    topps = np.asarray([0.9, 0.9, 1.0], np.float32)
    seeds = np.asarray([1, 2, 3], np.int64)
    toks, pos = [], []
    for lane, prompt in enumerate(([5, 9, 3], [7, 2, 8, 1, 4], [11, 6])):
        _, g, s = engine.prefill_chunk(lane, prompt, 0, temp=float(temps[lane]),
                                       topp=float(topps[lane]), seed=int(seeds[lane]))
        toks.append(g if temps[lane] == 0 else s)
        pos.append(len(prompt))
    toks, pos = np.asarray(toks), np.asarray(pos)
    out = []
    torch.cuda.synchronize()
    before = _launch_counts()
    if family in ("step", "step_greedy"):
        t = temps if family == "step" else np.zeros(3, np.float32)
        for _ in range(4):
            _, g, s = engine.decode(toks, pos, t, topps, seeds, want_logits=False)
            toks = np.where(t == 0, g, s)
            pos = pos + 1
            out.append(toks)
    elif family == "multi":
        for _ in range(2):
            chosen = engine.decode_multi(toks, pos, temps, topps, seeds, h=4)
            toks, pos = chosen[-1], pos + 4
            out.append(chosen)
    elif family == "pipelined":
        engine.decode_pipelined(pos, temps, topps, seeds, tokens=toks)
        for _ in range(3):
            engine.decode_pipelined(np.full(3, -1), temps, topps, seeds)
            out.append(np.stack(engine.pipeline_consume()))
        out.append(np.stack(engine.pipeline_consume()))
        engine.pipeline_flush()
    elif family == "spec":
        # the synchronous verify step, then verify steps in the chain (a
        # reseed, a chained one behind a plain step) and a fused one; lane
        # 0's candidates repeat its token, which a tiny random model may or
        # may not follow
        k = engine.SPEC_DRAFT
        _, em, ne = engine.decode_spec(toks, np.tile(toks[:, None], (1, k)),
                                       np.asarray([k, 0, 0]), pos, temps, topps, seeds)
        out += [em, ne]
        nxt = em[np.arange(3), ne - 1]
        pos = pos + ne
        drafts = np.tile(nxt[:, None], (1, k + 1))
        dlen = np.asarray([k + 1, 0, 0])
        engine.decode_spec_pipelined(pos, drafts, dlen, temps, topps, seeds, tokens=nxt)
        engine.decode_pipelined(np.full(3, -1), temps, topps, seeds)
        out += list(engine.pipeline_consume())
        engine.decode_spec_pipelined(np.full(3, -1), drafts, dlen, temps, topps, seeds)
        out.append(np.stack(engine.pipeline_consume()))
        out += list(engine.pipeline_consume())
        engine.decode_spec_prefill_fused(np.asarray([-1, -1, config.seq_len]), drafts, dlen,
                                         temps, topps, seeds, p_lane=2, chunk=[4, 4, 4],
                                         p_start=int(pos[2]), p_temp=1.1, p_topp=1.0,
                                         p_seed=3)
        out += list(engine.pipeline_consume())
        engine.pipeline_flush()
    else:  # fused: lane 2 re-admits a chunk while lanes 0 and 1 decode
        park = pos.copy()
        park[2] = config.seq_len
        engine.decode_pipelined(park, temps, topps, seeds, tokens=toks)
        engine.decode_prefill_fused(np.asarray([-1, -1, config.seq_len]), temps, topps,
                                    seeds, p_lane=2, chunk=[4, 4, 4], p_start=pos[2],
                                    p_temp=1.1, p_topp=1.0, p_seed=3)
        out.append(np.stack(engine.pipeline_consume()))
        engine.decode_pipelined(np.full(3, -1), temps, topps, seeds)
        out.append(np.stack(engine.pipeline_consume()))
        out.append(np.stack(engine.pipeline_consume()))
        engine.pipeline_flush()
    torch.cuda.synchronize()
    after = _launch_counts()
    return np.concatenate([np.asarray(o).reshape(-1) for o in out]), {
        k: after[k] - before[k] for k in after}


def _caches(engine):
    caches = [engine.cache] if engine.mesh is None else engine.cache
    return [t for c in caches for t in (c.k, c.v)]


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["step_greedy", "step", "multi", "pipelined", "fused",
                                    "spec"])
def test_graph_replay_matches_eager(cuda, tmp_path, family):
    """Each decode family replayed from its CUDA graph gives the eager
    bodies' tokens and KV cache bit for bit, and its launch counters (the
    graph's recorded deltas) equal the eager run's counts."""
    config, (graphed, eager) = _graph_engines(cuda, tmp_path)
    got, got_counts = _family_run(graphed, config, family)
    want, want_counts = _family_run(eager, config, family)
    assert len(graphed.graphs) > 0 and graphed.graphs.replays > 0
    np.testing.assert_array_equal(got, want)
    for a, b in zip(_caches(graphed), _caches(eager)):
        assert torch.equal(a, b)
    assert got_counts == want_counts and got_counts["decode_attn"] > 0
    if family != "step_greedy":
        assert got_counts["gumbel_sample"] > 0


@pytest.mark.gpu
def test_graph_replay_tp_mesh_on_one_card(cuda, tmp_path):
    """tp2 with both ranks on the one card: the pipelined family captured
    (ring steps inside the graph) equals the eager run, ring-hop launches
    and bytes included."""
    config, (graphed, eager) = _graph_engines(cuda, tmp_path, ["cuda:0", "cuda:0"])
    got, got_counts = _family_run(graphed, config, "pipelined")
    want, want_counts = _family_run(eager, config, "pipelined")
    assert graphed.graphs.replays > 0
    np.testing.assert_array_equal(got, want)
    for a, b in zip(_caches(graphed), _caches(eager)):
        assert torch.equal(a, b)
    assert got_counts == want_counts and got_counts["ring_hop"] > 0


@pytest.mark.gpu
def test_warmup_captures_every_decode_graph(cuda, tmp_path):
    """warmup_engine captures the step, the verify step and each horizon,
    greedy and sampled; serving then captures nothing new and replays
    them. Without speculation the verify step is not captured."""
    from distributed_llama_multiusers_tpu_torch.runtime.engine import warmup_engine

    config, (engine, _) = _graph_engines(cuda, tmp_path)
    warmup_engine(engine, multi_step=8)
    assert len(engine.graphs) == 2 * (1 + 1 + 3)  # step, verify and h = 8, 4, 2
    before = len(engine.graphs), engine.graphs.replays
    _family_run(engine, config, "fused")
    _family_run(engine, config, "multi")
    _family_run(engine, config, "spec")
    assert len(engine.graphs) == before[0] and engine.graphs.replays >= before[1] + 4
    (tmp_path / "plain").mkdir()
    config, (plain, _) = _graph_engines(cuda, tmp_path / "plain")
    warmup_engine(plain, spec=False, multi_step=8)
    assert len(plain.graphs) == 2 * (1 + 3)


def _one_lane_run(engine, config):
    """The CLI's decode families on a one-lane engine: plain steps, an
    8-step horizon and verify steps (candidates repeating the fed token);
    returns every token read back."""
    _, tok, pos = engine.prefill(0, [5, 9, 3, 17, 2])
    out = [tok]
    one = np.zeros(1, np.int64)
    for _ in range(3):
        _, g, _ = engine.decode(one + tok, one + pos, want_logits=False)
        tok, pos = int(g[0]), pos + 1
        out.append(tok)
    chosen = engine.decode_multi(one + tok, one + pos, h=8)
    out += [int(t) for t in chosen[:, 0]]
    tok, pos = int(chosen[-1, 0]), pos + 8
    k = engine.SPEC_DRAFT
    for _ in range(2):
        _, em, ne = engine.decode_spec(one + tok, np.full((1, k), tok), one + k, one + pos)
        out += [int(t) for t in em[0, :int(ne[0])]]
        tok, pos = int(em[0, int(ne[0]) - 1]), pos + int(ne[0])
    return out


@pytest.mark.gpu
def test_one_lane_graph_replay_equals_eager(cuda, tmp_path):
    """The one-lane engine of ``dllama``: its step, 8-step horizon and verify
    step, captured at warmup (``warm_engine``) and replayed, give the eager
    bodies' tokens and KV cache bit for bit, with no capture after warmup."""
    from distributed_llama_multiusers_tpu_torch.app.runtime_setup import warm_engine

    config, (graphed, eager) = _graph_engines(cuda, tmp_path, n_lanes=1)
    warm_engine(graphed, spec=True, multi_step=8, pipeline=False)
    assert len(graphed.graphs) == 2 * (1 + 1 + 3)
    got = _one_lane_run(graphed, config)
    want = _one_lane_run(eager, config)
    assert got == want
    for a, b in zip(_caches(graphed), _caches(eager)):
        assert torch.equal(a, b)
    assert graphed.graphs.replays >= 6 and graphed.graphs.captures_after_warmup == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["v4", "auto"])
def test_one_lane_stream_equals_eight_lane(cuda, tmp_path, mode):
    """The CLI's greedy stream (one lane, speculation and horizons through
    ``SpecStream``, replayed graphs) equals an 8-lane engine's plain decode
    of the same prompt on lane 3 with the other lanes busy, in each mode."""
    from distributed_llama_multiusers_tpu_torch.app.runtime_setup import warm_engine
    from distributed_llama_multiusers_tpu_torch.runtime.spec import SpecStream

    saved = q.DEQUANT_MODE
    q.set_dequant_mode(mode)
    try:
        config, (one, _) = _graph_engines(cuda, tmp_path, n_lanes=1)
        (tmp_path / "eight").mkdir()
        _, (eight, _) = _graph_engines(cuda, tmp_path / "eight", n_lanes=8)
        prompt = [5, 9, 3, 17, 2, 5, 9, 3, 17, 2, 5, 9]
        n = 48
        spec = SpecStream(one, config, enabled=True, prompt_tokens=prompt, multi_h=8)
        warm_engine(one, spec=True, multi_step=8, pipeline=False)
        _, cur, pos = one.prefill(0, prompt)
        got = [cur]
        while len(got) < n:
            cur, _ = spec.advance(cur, pos)
            pos += 1
            got.append(cur)
        toks = np.zeros(8, np.int64)
        poss = np.zeros(8, np.int64)
        for lane in range(8):
            p = prompt if lane == 3 else [lane + 1, 7, lane + 2]
            _, toks[lane], poss[lane] = eight.prefill(lane, p)
        want = [int(toks[3])]
        while len(want) < n:
            _, g, _ = eight.decode(toks, poss, want_logits=False)
            toks, poss = g.astype(np.int64), poss + 1
            want.append(int(g[3]))
    finally:
        q.set_dequant_mode(saved)
    assert got == want
    assert one.stats.spec_steps + one.stats.multi_dispatches > 0


@pytest.mark.gpu
def test_capture_after_warmup_raises_under_jitcheck(cuda, tmp_path):
    """Under DLLAMA_JITCHECK a decode family warmup did not capture (here an
    8-step horizon) raises RecompileAfterWarmup at its first step, and the
    capture counts as one after warmup."""
    from distributed_llama_multiusers_tpu_torch.analysis import jitcheck
    from distributed_llama_multiusers_tpu_torch.app.runtime_setup import warm_engine

    config, (engine, _) = _graph_engines(cuda, tmp_path, n_lanes=1)
    warm_engine(engine, spec=False, multi_step=0, pipeline=False)
    jitcheck.force(True, fresh=True)
    try:
        engine.graphs.mark_warm()
        one = np.zeros(1, np.int64)
        engine.decode(one, one + 4, want_logits=False)  # warmed: replays
        with pytest.raises(jitcheck.RecompileAfterWarmup):
            engine.decode_multi(one, one + 5, h=8)
    finally:
        jitcheck.force(None, fresh=True)
    assert engine.graphs.captures_after_warmup == 1
