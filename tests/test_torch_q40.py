"""The port's Q40 dequant-in-matmul (ops/cuda_q40.py) against the JAX
package's Pallas kernel in interpret mode.

On the CPU each wrapper runs its kernel's plain PyTorch version, which
rounds the operands exactly as the CUDA kernel does, so these tests pin the
arithmetic the kernels implement; ``chip_smoke.py`` holds each kernel
against the same plain version on the card. Inputs come from numpy with a
seed and go through both packages.

Tolerances:
- v4 with an exact f32 dot: atol = rtol = 2e-4, as the JAX package's own
  kernel-vs-XLA test; only the summation order differs.
- A bf16 mode against the same JAX mode: max|d| <= 1e-4 * max|y_jax|. The
  operand roundings are identical, so only the f32 summation order
  differs; a rounding in the wrong place shows at about 1e-3.
- Against exact f32: 1e-2 of max|y| for the bf16 chains (x and W each
  rounded to bf16, at most 2^-9 relative apiece: the JAX kernel itself
  sits at 4e-3 to 1e-2 on these inputs), 2e-2 for i8blockdot (activations
  quantized to Q80), as the JAX package's parity grid.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distributed_llama_multiusers_tpu.ops import pallas_q40 as jq
from distributed_llama_multiusers_tpu.quants.packed import (
    PackedQ40 as JaxPackedQ40,
    pack_q40_host,
)
from distributed_llama_multiusers_tpu_torch.ops import cuda_q40 as tq
from distributed_llama_multiusers_tpu_torch.ops import dequant_select as tsel
from distributed_llama_multiusers_tpu_torch.quants.packed import (
    PackedQ40,
    q40_matmul_dense,
)

# (m, d_in, d_out): the odd widths of the JAX kernel tests (1376 = 43*32,
# 5504 and 11008 with no 512-multiple divisor) across the decode class and
# the m = 32/33 boundary, plus a prefill-shaped m
A = (1, 1376, 128)
B = (5, 256, 5504)
C = (8, 2048, 512)
D = (32, 256, 11008)
E = (33, 1376, 128)
F = (300, 64, 256)
# widths no kernel can read or write as vectors (d_out % 4 == 2): the
# card's column-tail instantiations hold against these plain versions.
# d_in = 1376 keeps enough terms per output that 1e-2 of max|y| against
# exact f32 measures the bf16 roundings (at d_in = 256 and 18 outputs
# max|y| itself is small: JAX's kernel sits at 1.5e-2 there)
G = (5, 1376, 6)
H = (8, 1376, 1026)

CASES = (
    [("v4", s) for s in (A, B, C, D, E, F)]
    + [("bf16chain", s) for s in (A, B, C, D, E, F)]
    + [("repeat", A), ("repeat", F), ("u8chain", B), ("u8chain", E)]
    + [("blockdot", s) for s in (A, B, C, D, E)]
    + [("i8blockdot", s) for s in (A, B, C, D, E, F)]
    + [(mode, s) for mode in ("v4", "bf16chain", "blockdot", "i8blockdot") for s in (G, H)]
)


def _weights(rng, d_out, d_in, scale=0.1):
    w = rng.standard_normal((d_out, d_in), dtype=np.float32) * scale
    packed, scales = pack_q40_host(w)
    return (JaxPackedQ40(jnp.asarray(packed), jnp.asarray(scales)),
            PackedQ40(torch.from_numpy(packed), torch.from_numpy(scales)))


def _jax_mode(mode, x, jw, w_dtype):
    jq.set_dequant_mode(mode)
    try:
        return np.asarray(jq.q40_matmul_pallas(jnp.asarray(x), jw, interpret=True,
                                               w_dtype=w_dtype))
    finally:
        jq.set_dequant_mode(None)


def _torch_mode(mode, x, tw, w_dtype):
    tq.set_dequant_mode(mode)
    try:
        return tq.q40_matmul(torch.from_numpy(x), tw, w_dtype=w_dtype).numpy()
    finally:
        tq.set_dequant_mode(None)


@pytest.mark.parametrize("m,d_in,d_out", [A, B, C, D, E, F, G, H])
def test_v4_f32_matches_jax(m, d_in, d_out):
    rng = np.random.default_rng(d_in + d_out + m)
    jw, tw = _weights(rng, d_out, d_in)
    x = rng.standard_normal((m, d_in), dtype=np.float32)
    ref = _jax_mode("v4", x, jw, None)  # interpret: exact f32 dot
    got = _torch_mode("v4", x, tw, torch.float32)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("mode,shape", CASES,
                         ids=[f"{m}-{s[0]}x{s[1]}x{s[2]}" for m, s in CASES])
def test_bf16_modes_match_jax(mode, shape):
    m, d_in, d_out = shape
    rng = np.random.default_rng(d_in * 3 + d_out + m)
    jw, tw = _weights(rng, d_out, d_in)
    x = rng.standard_normal((m, d_in), dtype=np.float32)
    ref = _jax_mode(mode, x, jw, jnp.bfloat16)
    got = _torch_mode(mode, x, tw, torch.bfloat16)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-4 * scale, (
        f"{mode} {shape}: max|d| {np.abs(got - ref).max():.3e} vs max|y| {scale:.3e}")
    exact = q40_matmul_dense(torch.from_numpy(x), tw).numpy()
    bound = 2e-2 if mode == "i8blockdot" and m <= tq.BLOCKDOT_MAX_M else 1e-2
    rel = np.abs(got - exact).max() / np.abs(exact).max()
    assert rel <= bound, f"{mode} {shape} vs exact f32: {rel:.3e}"


@pytest.mark.parametrize("mode", ["v4", "bf16chain", "blockdot", "i8blockdot"])
def test_extreme_scales(mode):
    """Denormal f16 scales convert exactly (the JAX package's
    test_pallas_extreme_scales case, every kernel family)."""
    rng = np.random.default_rng(1)
    jw, tw = _weights(rng, 128, 64, scale=1e-7)
    assert (np.abs(tw.scales.numpy()) < 6.1e-5).any()  # f16 denormals present
    x = rng.standard_normal((4, 64), dtype=np.float32)
    if mode == "v4":
        ref = _jax_mode("v4", x, jw, None)
        got = _torch_mode("v4", x, tw, torch.float32)
        np.testing.assert_allclose(got, ref, atol=1e-10)
    ref = _jax_mode(mode, x, jw, jnp.bfloat16)
    got = _torch_mode(mode, x, tw, torch.bfloat16)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("m,d_in", [(1, 64), (5, 256), (33, 1376), (300, 64)])
def test_make_q80_acts_bit_equal(m, d_in):
    """int8 values, sx and bsum equal the JAX bundle's bit for bit: round
    half to even, the 1e-8 floor, and bsum summed in index order over the
    unrounded f32 x."""
    rng = np.random.default_rng(m * 1000 + d_in)
    x = rng.standard_normal((m, d_in), dtype=np.float32) * np.float32(3.7)
    x[0, :32] = 0.0  # an all-zero block: sx takes the 1e-8 floor
    ja = jq.make_q80_acts(jnp.asarray(x))
    n_blk = d_in // 32
    aux = np.asarray(ja.aux_t).T.reshape(-1, n_blk, 2)[:m]
    j_xq = np.concatenate([np.asarray(ja.xq_lo_t).T[:m].reshape(m, n_blk, 16),
                           np.asarray(ja.xq_hi_t).T[:m].reshape(m, n_blk, 16)], axis=2)
    ta = tq.make_q80_acts(torch.from_numpy(x))
    np.testing.assert_array_equal(ta.xq.numpy().reshape(m, n_blk, 32), j_xq)
    np.testing.assert_array_equal(ta.sx.numpy(), aux[..., 1])
    np.testing.assert_array_equal(ta.bsum.numpy(), aux[..., 0])
    np.testing.assert_array_equal(ta.bsum.numpy(), np.asarray(ja.bsum_t).T[:m])


@pytest.mark.parametrize("mode", list(tq.SELECTABLE_MODES))
def test_mode_resolution_matches_jax(mode, monkeypatch):
    """The mode each product runs, across the m = 32/33 boundary, agrees
    with q40_matmul_pallas's resolution (observed at its impl, which the
    spy stands in for), for a bf16 dot and for the f32 dot that always
    runs v4."""
    rng = np.random.default_rng(11)
    jw, _ = _weights(rng, 128, 64)
    seen = []

    def spy(x_, w_, interpret_, w_dtype_, mode_):
        seen.append(mode_)
        return jnp.zeros((x_.shape[0], w_.d_out), x_.dtype)

    monkeypatch.setattr(jq, "_q40_matmul_pallas_impl", spy)
    tsel._reset_for_tests()
    jq.set_dequant_mode(mode)
    tq.set_dequant_mode(mode)
    try:
        for m in (1, tq.BLOCKDOT_MAX_M, tq.BLOCKDOT_MAX_M + 1, 300):
            for jd, td in ((jnp.bfloat16, torch.bfloat16), (None, torch.float32)):
                seen.clear()
                jq.q40_matmul_pallas(jnp.zeros((m, 64), jnp.float32), jw,
                                     interpret=True, w_dtype=jd)
                assert tq.resolve_kernel_mode(m, 64, 128, td) == seen[0], (mode, m, jd)
    finally:
        jq.set_dequant_mode(None)
        tq.set_dequant_mode(None)
        tsel._reset_for_tests()
    assert tq.BLOCKDOT_MAX_M == jq.BLOCKDOT_MAX_M == 32


def test_auto_resolution_and_sites():
    tsel._reset_for_tests()
    tq.set_dequant_mode("auto")
    try:
        assert tq.resolve_kernel_mode(32, 2048, 512, torch.bfloat16) == "i8blockdot"
        assert tq.resolve_kernel_mode(33, 2048, 512, torch.bfloat16) == "bf16chain"
        assert tq.resolve_kernel_mode(1, 2048, 512, torch.float32) == "v4"
        stats = tsel.dequant_stats()
        assert stats["dequant_mode"] == "auto"
        assert stats["dequant_sites"] == {"2048x512/decode": "i8blockdot",
                                          "2048x512/prefill": "bf16chain"}
        assert stats["dequant_table"]["path"] == tsel._DEFAULT_TABLE
        assert stats["dequant_table"] == tsel.table_provenance()
    finally:
        tq.set_dequant_mode(None)
        tsel._reset_for_tests()


def test_dequant_table_rules_match_jax():
    import json

    from distributed_llama_multiusers_tpu.ops import dequant_select as jsel

    def rules(path):
        with open(path) as f:
            return [{k: r[k] for k in ("d_in", "d_out", "m_class", "mode")}
                    for r in json.load(f)["rules"]]

    assert rules(tsel._DEFAULT_TABLE) == rules(jsel._DEFAULT_TABLE)


def test_unknown_mode_rejected(monkeypatch):
    with pytest.raises(ValueError, match="unknown dequant mode"):
        tq.set_dequant_mode("q31wizard")
    monkeypatch.setenv("DLLAMA_DEQUANT", "q31wizard")
    with pytest.raises(ValueError, match="not a known dequant mode"):
        tq.set_dequant_mode(None)


def test_cpu_wrappers_count_plain_calls_not_launches():
    rng = np.random.default_rng(2)
    _, tw = _weights(rng, 256, 128)
    x = torch.from_numpy(rng.standard_normal((4, 128), dtype=np.float32))
    tq.reset_counts()
    acts = tq.make_q80_acts(x)
    assert tq.make_q80_acts(acts) is acts
    tq.q40_slab(acts, tw, torch.bfloat16, "bf16chain")
    tq.q40_blockdot(acts, tw)
    tq.q40_i8blockdot(acts, tw)
    tq.q40_matmul(acts, tw)
    counts = tq.kernel_counts()
    assert counts["kernel_launches"] == {k: 0 for k in tq.KERNELS}
    assert counts["kernel_plain_calls"] == {"q40_slab": 2, "q40_blockdot": 1,
                                            "q40_i8blockdot": 1}
    tq.reset_counts()


def test_leading_batch_dims():
    rng = np.random.default_rng(0)
    jw, tw = _weights(rng, 256, 128)
    x = rng.standard_normal((2, 3, 128), dtype=np.float32)
    ref = _jax_mode("v4", x, jw, None)
    got = _torch_mode("v4", x, tw, None)  # None: exact f32 on the CPU
    assert got.shape == (2, 3, 256)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)


def test_launch_plan_covers_every_block():
    for m in (1, 8, 32, 33, 512):
        for d_in, d_out in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
                            (2048, 128256)):
            mt, splits, per = tq.launch_plan(m, d_in, d_out, 132)
            n_blk = d_in // 32
            assert mt in (1, 8, 16)
            assert (splits - 1) * per < n_blk <= splits * per


@pytest.mark.parametrize("d_in,d_out", [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
                                        (2048, 128256), (64, 6)])
def test_launch_plan_splits_decode_shapes_alike(d_in, d_out):
    """Every decode-shaped product (m <= BLOCKDOT_MAX_M: a decode step's m =
    lanes and a verify step's m = 4 x lanes) takes one k-split plan, so a
    row's partials sum in one order whatever m is."""
    plans = {tq.launch_plan(m, d_in, d_out, 132)[1:] for m in range(1, tq.BLOCKDOT_MAX_M + 1)}
    assert len(plans) == 1


@pytest.mark.parametrize("d_out", [6, 520, 1026])
def test_check_weight_accepts_any_width(d_out):
    """The wrappers take any output width (the card's kernels have a column
    tail); a scale plane that does not match still raises."""
    _, tw = _weights(np.random.default_rng(d_out), d_out, 64)
    tw = PackedQ40(tw.packed.contiguous(), tw.scales.contiguous())
    tq._check_weight(tw, torch.device("cpu"))
    bad = PackedQ40(tw.packed, tw.scales[:, :-1].contiguous())
    with pytest.raises(ValueError, match="do not match"):
        tq._check_weight(bad, torch.device("cpu"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No CUDA toolkit: building the kernels raises; nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("DLLAMA_KERNEL_BUILD_DIR", str(tmp_path / "build"))
    if tq.os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tq.build_kernels()



# ---------------------------------------------------------------------------
# The tensor-core i8blockdot kernel's fragment mapping, modelled in numpy
# ---------------------------------------------------------------------------

ROW_PITCH = 528  # bytes per staged packed row (csrc/q40_common.cuh, kRowPitch)


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: byte j of the result is byte (s >> 4j) & 7 of
    the 8 bytes of (y, x)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(s >> (4 * j)) & 7] << (8 * j) for j in range(4))


def _words(b: np.ndarray) -> list:
    return [int.from_bytes(b[4 * q:4 * q + 4].tobytes(), "little") for q in range(len(b) // 4)]


def _s8(word: int) -> list:
    return [int(np.int8(np.uint8((word >> (8 * i)) & 0xFF))) for i in range(4)]


def _load_row(t: int, r: int) -> int:
    """The staged row thread (g, t) reads in its 16-byte load r."""
    return 4 * t + (r ^ (t & 2))


def _i8_fragment_model(xq, sx, bsum, packed, scales, m):
    """csrc/q40_i8blockdot.cu at one m-tile of NT N-tiles, one split, as its
    threads compute it: the transposing reads of the staged rows, the
    m16n8k32 s8 A/B/C fragments as PTX lays them out, the f32 epilogue.
    Returns (y [m, d_out] f32, the int32 block dots [n_blk, 8*NT, d_out])."""
    d_in, d_out = 2 * packed.shape[0], packed.shape[1]
    n_blk, nt_count = d_in // 32, (m + 7) // 8
    xs = np.zeros((8 * nt_count, d_in), np.int8)
    xs[:m] = xq
    acc = np.zeros((8 * nt_count, d_out), np.float32)
    dots = np.zeros((n_blk, 8 * nt_count, d_out), np.int64)
    for b in range(n_blk):
        stage = packed[16 * b:16 * b + 16]
        for w in range(d_out // 128):
            for nt in range(nt_count):
                for i in range(8):  # M-tile i of the warp's fragments
                    a = np.zeros((16, 32), np.int64)
                    bm = np.zeros((32, 8), np.int64)
                    cols = {}
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        cw = w * 128 + g * 16
                        loads = [_words(stage[_load_row(t, r), cw:cw + 16]) for r in range(4)]
                        sel = (0x1054, 0x3276) if t & 2 else (0x5410, 0x7632)
                        q, h = i // 2, i % 2
                        u0 = _byte_perm(loads[0][q], loads[1][q], 0x5140)
                        u1 = _byte_perm(loads[2][q], loads[3][q], 0x5140)
                        u2 = _byte_perm(loads[0][q], loads[1][q], 0x7362)
                        u3 = _byte_perm(loads[2][q], loads[3][q], 0x7362)
                        col = [_byte_perm(u0, u1, sel[0]), _byte_perm(u0, u1, sel[1]),
                               _byte_perm(u2, u3, sel[0]), _byte_perm(u2, u3, sel[1])]
                        ca, cb = col[2 * h], col[2 * h + 1]
                        regs = [ca & 0x0F0F0F0F, cb & 0x0F0F0F0F, (ca >> 4) & 0x0F0F0F0F,
                                (cb >> 4) & 0x0F0F0F0F]
                        # a0: row g, k 4t+j; a1: row g+8; a2/a3: k 16+4t+j
                        for reg, (row, k0) in zip(regs, ((g, 4 * t), (g + 8, 4 * t),
                                                         (g, 16 + 4 * t), (g + 8, 16 + 4 * t))):
                            a[row, k0:k0 + 4] = _s8(reg)
                        xrow = xs[8 * nt + g, 32 * b:32 * b + 32]
                        bm[4 * t:4 * t + 4, g] = _s8(_words(xrow[4 * t:4 * t + 4])[0])
                        bm[16 + 4 * t:20 + 4 * t, g] = _s8(_words(xrow[16 + 4 * t:20 + 4 * t])[0])
                        cols[g], cols[g + 8] = cw + 2 * i, cw + 2 * i + 1
                    d = a @ bm  # [16 fragment rows, 8 activation rows]
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        for e, (row, n) in enumerate(((g, 2 * t), (g, 2 * t + 1),
                                                      (g + 8, 2 * t), (g + 8, 2 * t + 1))):
                            col, r = cols[row], 8 * nt + n
                            dots[b, r, col] = d[row, n]
                            sxv = sx[r, b] if r < m else np.float32(0)
                            corr = np.float32(8) * (bsum[r, b] if r < m else np.float32(0))
                            inner = np.float32(np.float64(sxv) * d[row, n] - np.float64(corr))
                            acc[r, col] = np.float32(np.float64(inner) * np.float64(
                                np.float32(scales[b, col])) + np.float64(acc[r, col]))
    return acc[:m], dots


@pytest.mark.parametrize("m", [1, 5, 16])
def test_i8blockdot_fragment_model_matches_plain(m):
    """A numpy model of the tensor-core kernel's fragment gather and
    epilogue on a tiny weight (two quant blocks, two warps of columns): its
    int32 block dots equal the exact integer dots of the packed layout, and
    its output equals ``q40_i8blockdot_plain`` within 1e-4 of max|y| (the
    f32 summation order over blocks differs)."""
    rng = np.random.default_rng(90 + m)
    d_in, d_out = 64, 256
    packed = rng.integers(0, 256, (d_in // 2, d_out), dtype=np.uint8)
    scales = (rng.standard_normal((d_in // 32, d_out)) * 0.05).astype(np.float16)
    x = rng.standard_normal((m, d_in)).astype(np.float32)
    acts = tq.make_q80_acts(torch.from_numpy(x))
    xq, sx, bsum = acts.xq.numpy(), acts.sx.numpy(), acts.bsum.numpy()
    y, dots = _i8_fragment_model(xq, sx, bsum, packed, scales, m)
    lo = (packed & 0x0F).astype(np.int64).reshape(d_in // 32, 16, d_out)
    hi = (packed >> 4).astype(np.int64).reshape(d_in // 32, 16, d_out)
    xb = xq.astype(np.int64).reshape(m, d_in // 32, 2, 16)
    exact = (np.einsum("mbj,bjo->bmo", xb[:, :, 0], lo)
             + np.einsum("mbj,bjo->bmo", xb[:, :, 1], hi))
    np.testing.assert_array_equal(dots[:, :m], exact)
    assert not dots[:, m:].any()  # the zero-padded rows of the N-tile
    ref = tq.q40_i8blockdot_plain(acts, PackedQ40(torch.from_numpy(packed),
                                                  torch.from_numpy(scales))).numpy()
    assert np.abs(y - ref).max() <= 1e-4 * np.abs(ref).max()


def _banks(rows_of, lanes) -> list:
    """Per lane of a quarter-warp, the 4 banks its 16-byte load of the
    staged row rows_of(t) at column g * 16 touches."""
    out = []
    for lane in lanes:
        g, t = lane // 4, lane % 4
        word = (rows_of(t) * ROW_PITCH + g * 16) // 4
        out += [(word + j) % 32 for j in range(4)]
    return out


def test_i8blockdot_transposing_reads_are_free_of_bank_conflicts():
    """Each of a thread's four 16-byte loads, quarter-warp by quarter-warp,
    touches every bank of the 528-byte-pitch stage once; reading rows
    4t..4t+3 in plain order would put rows 8 apart (t = 0 and 2) on the
    same banks."""
    for r in range(4):
        for quarter in range(4):
            lanes = range(8 * quarter, 8 * quarter + 8)
            assert sorted(_banks(lambda t: _load_row(t, r), lanes)) == list(range(32))
    plain = _banks(lambda t: 4 * t, range(8))
    assert len(set(plain)) < 32
