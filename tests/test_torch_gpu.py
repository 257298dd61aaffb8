"""The port on a CUDA card: each Q40 kernel against its plain version, the
dispatch's mode routing at the m = 32/33 boundary, a tiny model served by
the engine on the card, the ring hop against its plain version and the
tensor-parallel forward with two ranks on one card. Marked ``gpu``; without
a card every test skips.

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


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,offset", [((8, 1024), torch.float32, 0),
                                                 ((8, 32, 1), torch.float16, 0),
                                                 ((3, 37), torch.int8, 0),
                                                 ((5, 33), torch.float32, 1)])
def test_ring_hop_matches_plain(cuda, shape, dtype, offset):
    """The hop kernel bit for bit against its plain version: 16-byte vector
    copies with a byte tail (int8 [3, 37]: 111 bytes), and the byte path for
    a source that is not 16-byte aligned (an element offset into a buffer)."""
    from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc

    n = int(np.prod(shape))
    xs = []
    for r in range(3):
        base = (torch.randn(n + offset, device=cuda) * 50).to(dtype)
        xs.append(base[offset:].view(shape))
    rc.reset_counts()
    got, ref = rc.ring_shift(xs), rc.ring_shift_plain(xs)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, ref))
    assert rc.COUNTS["launches"] == 3 and rc.COUNTS["plain_calls"] == 0
    assert rc.COUNTS["bytes"] == 3 * xs[0].numel() * xs[0].element_size()


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
