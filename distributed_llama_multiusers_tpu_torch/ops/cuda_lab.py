"""The kernel lab's kernels on Hopper, with their plain PyTorch versions.

The JAX package's lab scripts (``scripts/kernel_lab.py``,
``kernel_lab3.py``, ``stage_probe.py``, ``stage_probe2.py``) measure Q40
kernel variants with Pallas TPU kernels. Their port is the package ``lab/``;
its kernels are three hand-written CUDA C++ kernels under ``csrc/`` (built
and bound as ``ops/cuda_q40.py``'s: ``nvcc`` for ``sm_90a`` at first use,
``ctypes``), and the serving Q40 kernels where a lab kernel computes the
same function (kernel_lab3's product variants; ``tests/test_torch_lab.py``
shows it):

- ``q40_probe`` (``csrc/q40_probe.cu``): the read and stage probes. A stack
  of packed planes [L, J, R, C] (uint8; or int32 words of 4 byte columns,
  the lab's u32 lanes) reduced over all L*R rows per column, at one stage:
  ``dma`` (every tile staged in shared memory by ``cp.async``; one row
  written), ``bytes``, ``nibbles``, ``convert_f32``, ``convert_bf16``,
  ``scale``. Layouts: row-major [L, half, d_out] (J = 1), the slab
  [L, J, half, T], and full-width row blocks (the row-major stack with the
  dma stage's ``tile_rows``).
- ``q40_lab_twodot`` (``csrc/q40_lab_twodot.cu``): the lab's two-dot Q40
  product with the W rounding (``f32``, ``product_bf16``, ``chain_bf16``),
  the x rounding and the −8 correction as options, on the row-major plane
  [half, d_out] or the pre-tiled [J, half, T].
- ``dense_dot`` (``csrc/dense_dot.cu``): x [m ≤ 32, d_in] @ w [d_in, d_out],
  bf16 or f32, accumulated in f32.

Where the JAX probes overwrite their output on each step of an "arbitrary"
grid axis (they keep the last step), these reductions sum the whole stack,
so that every byte read counts; the two agree on one plane read in one
step along each such axis, which is what the tests compare.

A wrapper runs its plain version only for a tensor on the CPU; for a CUDA
tensor it launches its kernel or raises. ``LAUNCHES`` counts launches,
``PLAIN_CALLS`` the plain calls. Beside them: the lab's helpers ``retile``,
``split_x``, ``quantize_x_blocks`` / ``lab_acts`` (kernel_lab3's Q80
operands for ``q40_i8blockdot``) and ``ref_dequant`` (its numpy oracle).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .cuda_q40 import (
    COLS_PER_THREAD,
    THREADS_PER_BLOCK,
    Q80Acts,
    _block_sums,
    _halves,
    _raise_on,
    _round,
    _sm_count,
    launch_plan,
    load_kernel,
)

KERNELS = ("q40_probe", "q40_lab_twodot", "dense_dot")
KERNEL_SOURCES = {k: f"distributed_llama_multiusers_tpu_torch/csrc/{k}.cu" for k in KERNELS}
# the lab's pl.pallas_call sites each kernel replaces (file:line of the call)
KERNEL_REPLACES = {
    "q40_probe": ("scripts/kernel_lab.py:287", "scripts/stage_probe.py:208",
                  "scripts/stage_probe.py:248", "scripts/stage_probe2.py:107",
                  "scripts/stage_probe2.py:129", "scripts/stage_probe2.py:196"),
    "q40_lab_twodot": ("scripts/kernel_lab.py:127", "scripts/kernel_lab.py:234",
                       "scripts/stage_probe.py:309", "scripts/stage_probe2.py:165"),
    "dense_dot": ("scripts/stage_probe.py:279",),
}
LAUNCHES = {k: 0 for k in KERNELS}
PLAIN_CALLS = {k: 0 for k in KERNELS}
_counts_lock = threading.Lock()

STAGES = ("dma", "bytes", "nibbles", "convert_f32", "convert_bf16", "scale")
U32_STAGES = ("nibbles", "convert_f32", "convert_bf16")
W_ROUNDS = ("f32", "product_bf16", "chain_bf16")
STAGE_ROWS = 32  # rows of the dma stage's shared-memory tile (csrc/q40_probe.cu)
PROBE_BLOCKS_PER_SM = 8

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # packed, scales, out, part, stage, u32, L, J, R, Cw, splits,
    # rows_per_split, tile_row, stream
    "q40_probe": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, bsum, packed, scales, out, part, m, d_in, d_out, tile, mt, splits,
    # blocks_per_split, w_round, x_round, correction, stream
    "q40_lab_twodot": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, x_bf16, w, w_bf16, out, part, m, d_in, d_out, mt, splits,
    # blocks_per_split, stream
    "dense_dot": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}


def reset_counts() -> None:
    with _counts_lock:
        for d in (LAUNCHES, PLAIN_CALLS):
            for k in d:
                d[k] = 0


def _bump(table: dict, key: str) -> None:
    with _counts_lock:
        table[key] += 1


def _kernel(name: str):
    return load_kernel(name, _ARGTYPES[name])


# ---------------------------------------------------------------------------
# The lab's helpers
# ---------------------------------------------------------------------------


def retile(packed: torch.Tensor, scales: torch.Tensor, tile: int = 512):
    """Pre-tiled planes (kernel_lab.py:163): packed [..., half, d_out] ->
    [..., J, half, tile] and scales [..., n_blk, d_out] -> [..., J, n_blk,
    tile], J = d_out // tile, each output tile one contiguous slab (copies,
    never views)."""
    def one(t):
        *lead, rows, d_out = t.shape
        if d_out % tile:
            raise ValueError(f"d_out={d_out} is not a multiple of the tile {tile}")
        return t.reshape(*lead, rows, d_out // tile, tile).movedim(-2, -3).contiguous()

    return one(packed), one(scales)


def split_x(xf: torch.Tensor):
    """kernel_lab3.py:324: x [m, d_in] -> (x_lo, x_hi [m, d_in/2], bsum_t
    [d_in/32, m])."""
    m, d_in = xf.shape
    x_lo, x_hi = _halves(xf)
    return x_lo, x_hi, xf.reshape(m, d_in // 32, 32).sum(dim=2).t()


def quantize_x_blocks(xf: torch.Tensor):
    """kernel_lab3.py:217, the lab's Q80 activation operands: per 32-block
    sx = max|x| / 127 (a zero block gets 1e-8), xq = clip(rint(x / sx)).
    Returns (xq int8 [m, d_in], sx f32 [m, d_in/32]). The serving
    ``Q80Acts`` clamps max|x| at 1e-8 before dividing instead; on a zero
    block xq is 0 either way."""
    m, d_in = xf.shape
    xb = xf.to(torch.float32).reshape(m, d_in // 32, 32)
    sx = xb.abs().amax(dim=2) / 127.0
    sx = torch.where(sx == 0, torch.full_like(sx, 1e-8), sx)
    xq = torch.round(xb / sx[:, :, None]).clamp(-127, 127).to(torch.int8)
    return xq.reshape(m, d_in), sx


def lab_acts(xf: torch.Tensor) -> Q80Acts:
    """An operand bundle for the serving kernels carrying the lab's Q80
    quantization (``quantize_x_blocks``), as kernel_lab3 feeds
    ``_k_i8blockdot``."""
    return Q80Acts(xf, q80=quantize_x_blocks(xf))


def ref_dequant(packed, scales) -> np.ndarray:
    """kernel_lab3.py:309, the numpy oracle: dense f32 weights [d_in, d_out]
    of one packed plane (scales as f16 or f32 values)."""
    half, d_out = packed.shape
    n_blk = half // 16
    p = np.asarray(packed).astype(np.int32)
    s = np.asarray(scales).astype(np.float32)
    lo = (p & 0x0F).reshape(n_blk, 16, d_out)
    hi = (p >> 4).reshape(n_blk, 16, d_out)
    w = np.zeros((half * 2, d_out), np.float32)
    wb = w.reshape(n_blk, 32, d_out)
    wb[:, :16] = (lo - 8) * s[:, None, :]
    wb[:, 16:] = (hi - 8) * s[:, None, :]
    return w


# ---------------------------------------------------------------------------
# q40_probe
# ---------------------------------------------------------------------------


def _stack4(t: torch.Tensor) -> torch.Tensor:
    if t.dim() == 3:
        return t.unsqueeze(1)
    if t.dim() != 4:
        raise ValueError(f"expected a [L, R, C] or [L, J, R, C] stack, got {tuple(t.shape)}")
    return t


def _dma_row(rows: int, tile_rows: int | None) -> int:
    tile_rows = tile_rows or rows
    if tile_rows <= 0 or tile_rows > rows:
        raise ValueError(f"tile_rows={tile_rows} does not fit {rows} rows")
    return (rows // tile_rows - 1) * tile_rows


def q40_probe_plain(packed: torch.Tensor, stage: str, scales: torch.Tensor | None = None,
                    tile_rows: int | None = None) -> torch.Tensor:
    """The probe's arithmetic: f32 [J * columns] (see the module doc)."""
    p4 = _stack4(packed)
    L, J, R, C = p4.shape
    if stage == "dma":
        return p4[L - 1, :, _dma_row(R, tile_rows), :].to(torch.float32).reshape(-1)
    p = p4.to(torch.int32)
    if packed.dtype == torch.int32:  # u32 words: 8 nibbles each
        nibs = [(p >> sh) & 0x0F for sh in range(0, 32, 4)]
        if stage == "nibbles":
            v = sum(nibs)
        elif stage == "convert_f32":
            v = nibs[0].to(torch.float32)
            for n in nibs[1:]:
                v = v + n.to(torch.float32)
        elif stage == "convert_bf16":
            v = nibs[0].to(torch.bfloat16)
            for n in nibs[1:]:
                v = v + n.to(torch.bfloat16)
        else:
            raise ValueError(f"u32 words run {U32_STAGES}, not {stage!r}")
    else:
        lo, hi = p & 0x0F, p >> 4
        if stage == "bytes":
            v = p
        elif stage == "nibbles":
            v = lo + hi
        elif stage == "convert_f32":
            v = lo.to(torch.float32) + hi.to(torch.float32)
        elif stage == "convert_bf16":
            v = lo.to(torch.bfloat16) + hi.to(torch.bfloat16)
        elif stage == "scale":
            s = _stack4(scales).to(torch.float32).repeat_interleave(16, dim=2)
            v = lo.to(torch.float32) * s + hi.to(torch.float32) * s
        else:
            raise ValueError(f"unknown probe stage {stage!r}; one of {STAGES}")
    if v.dtype in (torch.int32, torch.int64):
        out = v.sum(dim=(0, 2), dtype=torch.int64).to(torch.float32)
    else:
        out = v.to(torch.float32).sum(dim=(0, 2))
    return out.reshape(-1)


def probe_plan(rows: int, blocks_xy: int, n_sm: int) -> tuple[int, int]:
    """(splits, rows per split) for a probe over ``rows`` stacked rows: the
    rows split across thread blocks until about PROBE_BLOCKS_PER_SM blocks
    per SM are in flight, each split a whole number of dma tiles."""
    want = max(1, -(-PROBE_BLOCKS_PER_SM * n_sm // blocks_xy))
    per = -(-rows // want)
    per = -(-per // STAGE_ROWS) * STAGE_ROWS
    return -(-rows // per), per


def _check_probe(packed: torch.Tensor, stage: str, scales, u32: bool) -> None:
    if packed.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"packed must be uint8 or int32 words, got {packed.dtype}")
    if stage not in (U32_STAGES if u32 else STAGES):
        raise ValueError(f"stage {stage!r} is not one of "
                         f"{U32_STAGES if u32 else STAGES} for {packed.dtype}")
    if not packed.is_contiguous() or packed.data_ptr() % 16:
        raise ValueError("packed must be contiguous and 16-byte aligned")
    L, J, R, C = _stack4(packed).shape
    cols = C if u32 else C // COLS_PER_THREAD
    if not u32 and C % (16 if stage == "dma" else COLS_PER_THREAD):
        raise ValueError(f"{C} byte columns do not split into the kernel's words")
    if L * R >= 2 ** 31 or cols == 0:
        raise ValueError(f"stack {tuple(packed.shape)} is out of the kernel's range")
    if stage == "scale":
        if R % 16:
            raise ValueError(f"{R} rows do not cover whole quant blocks")
        if scales is None or scales.dtype != torch.float16 or not scales.is_contiguous() \
                or tuple(_stack4(scales).shape) != (L, J, R // 16, C) \
                or scales.device != packed.device:
            raise ValueError(f"scales must be contiguous float16 [{L}, {J}, {R // 16}, {C}] "
                             f"on {packed.device}")


def q40_probe(packed: torch.Tensor, stage: str, scales: torch.Tensor | None = None,
              tile_rows: int | None = None) -> torch.Tensor:
    """One probe pass over the stack ``packed`` ([L, R, C] or [L, J, R, C];
    uint8, or int32 u32 words) at ``stage``; f32 [J * columns]. ``scales``
    (f16 [L, (J,) R/16, C]) for the scale stage; ``tile_rows`` picks the
    row the dma stage writes (row (R/tile_rows - 1)*tile_rows of plane L-1,
    default row 0)."""
    u32 = packed.dtype == torch.int32
    if packed.device.type == "cpu":
        _bump(PLAIN_CALLS, "q40_probe")
        return q40_probe_plain(packed, stage, scales, tile_rows)
    _check_probe(packed, stage, scales, u32)
    L, J, R, C = _stack4(packed).shape
    cw = C if u32 else C // COLS_PER_THREAD  # 32-bit words per row
    n_out = J * C
    if stage == "dma":  # a thread block stages 512 byte columns
        col_blocks = -(-C // (THREADS_PER_BLOCK * COLS_PER_THREAD))
    else:  # a thread owns one word column
        col_blocks = -(-cw // THREADS_PER_BLOCK)
    splits, per = probe_plan(L * R, col_blocks * J, _sm_count(packed.device))
    row = _dma_row(R, tile_rows)
    out = torch.empty(n_out, dtype=torch.float32, device=packed.device)
    part = (torch.empty(splits, n_out, dtype=torch.float32, device=packed.device)
            if splits > 1 and stage != "dma" else out)
    with torch.cuda.device(packed.device):
        err = _kernel("q40_probe")(
            packed.data_ptr(), scales.data_ptr() if stage == "scale" else None,
            out.data_ptr(), part.data_ptr(), STAGES.index(stage), int(u32), L, J, R, cw,
            splits, per, row, torch.cuda.current_stream(packed.device).cuda_stream)
    _raise_on(err, "q40_probe")
    _bump(LAUNCHES, "q40_probe")
    return out


def probe_bytes(packed: torch.Tensor, stage: str) -> int:
    """Bytes one probe pass must move: the stack (and the scale stage's
    scales) read once, the f32 output written once."""
    L, J, R, C = _stack4(packed).shape
    n = packed.numel() * packed.element_size()
    if stage == "scale":
        n += L * J * (R // 16) * C * 2
    return n + J * C * 4


def probe_ops(packed: torch.Tensor, stage: str) -> int:
    """f32 operations of a float stage (two adds per byte to convert, two
    products and two adds per byte to scale); the byte and nibble stages
    are integer work, counted as none."""
    per_byte = {"convert_f32": 2, "convert_bf16": 2, "scale": 4}.get(stage, 0)
    return per_byte * packed.numel() * packed.element_size()


# ---------------------------------------------------------------------------
# q40_lab_twodot
# ---------------------------------------------------------------------------


def _untile(t: torch.Tensor) -> torch.Tensor:
    """[J, rows, T] -> [rows, J*T] (a 2D plane is returned as it is)."""
    if t.dim() == 2:
        return t
    J, rows, T = t.shape
    return t.permute(1, 0, 2).reshape(rows, J * T)


def q40_lab_twodot_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                         w_round: str = "f32", x_round: bool = False, correction: bool = True,
                         bsum: torch.Tensor | None = None) -> torch.Tensor:
    """The two-dot kernel's arithmetic (see csrc/q40_lab_twodot.cu); f32
    [m, d_out]."""
    if w_round not in W_ROUNDS:
        raise ValueError(f"unknown W rounding {w_round!r}; one of {W_ROUNDS}")
    xf = x.to(torch.float32)
    p = _untile(packed)
    s = _untile(scales).to(torch.float32)
    lo, hi = (p & 0x0F).to(torch.float32), (p >> 4).to(torch.float32)
    if w_round == "chain_bf16":
        s_rows = _round(s, torch.bfloat16).repeat_interleave(16, dim=0)
    else:
        s_rows = s.repeat_interleave(16, dim=0)
    w_lo, w_hi = lo * s_rows, hi * s_rows
    if w_round != "f32":
        w_lo, w_hi = _round(w_lo, torch.bfloat16), _round(w_hi, torch.bfloat16)
    x_lo, x_hi, _ = split_x(_round(xf, torch.bfloat16) if x_round else xf)
    y = x_lo @ w_lo + x_hi @ w_hi
    if correction:
        y = y - 8.0 * ((_block_sums(xf) if bsum is None else bsum) @ s)
    return y


def q40_lab_twodot(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                   w_round: str = "f32", x_round: bool = False, correction: bool = True,
                   bsum: torch.Tensor | None = None, k_chunk: int | None = None) -> torch.Tensor:
    """The lab's two-dot product: x f32 [m, d_in] against the packed plane
    [half, d_out] (scales f16 [n_blk, d_out]) or the pre-tiled [J, half, T]
    (scales [J, n_blk, T]); f32 [m, d_out]. ``bsum`` (f32 [m, d_in/32],
    the correction's block sums) is built when not given; ``k_chunk`` pins
    the d_in range of one thread block (default: ``launch_plan``)."""
    if x.device.type == "cpu":
        _bump(PLAIN_CALLS, "q40_lab_twodot")
        return q40_lab_twodot_plain(x, packed, scales, w_round, x_round, correction, bsum)
    if w_round not in W_ROUNDS:
        raise ValueError(f"unknown W rounding {w_round!r}; one of {W_ROUNDS}")
    if packed.dim() == 2:
        J, (half, tile) = 1, packed.shape
    elif packed.dim() == 3:
        J, half, tile = packed.shape
    else:
        raise ValueError(f"expected a [half, d_out] or [J, half, T] plane, "
                         f"got {tuple(packed.shape)}")
    d_in, d_out, n_blk = 2 * half, J * tile, half // 16
    if packed.dtype != torch.uint8 or scales.dtype != torch.float16:
        raise TypeError(f"packed must be uint8 and scales float16, got {packed.dtype}, "
                        f"{scales.dtype}")
    expect = (n_blk, tile) if J == 1 and packed.dim() == 2 else (J, n_blk, tile)
    if tuple(scales.shape) != expect or half % 16 or tile % COLS_PER_THREAD:
        raise ValueError(f"scales {tuple(scales.shape)} do not match packed {tuple(packed.shape)}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != d_in:
        raise ValueError(f"x must be float32 [m, {d_in}], got {x.dtype} {tuple(x.shape)}")
    for t in (x, packed, scales):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("operands must be contiguous and on one device")
    m = x.shape[0]
    if bsum is None and correction:
        bsum = _block_sums(x)
    if bsum is not None and (bsum.dtype != torch.float32 or tuple(bsum.shape) != (m, n_blk)
                             or not bsum.is_contiguous() or bsum.device != x.device):
        raise ValueError(f"bsum must be contiguous float32 [{m}, {n_blk}]")
    mt, splits, per = launch_plan(m, d_in, d_out, _sm_count(x.device))
    if k_chunk is not None:
        if k_chunk % 32 or d_in % k_chunk:
            raise ValueError(f"k_chunk={k_chunk} must be a multiple of 32 dividing {d_in}")
        per = k_chunk // 32
        splits = n_blk // per
    out = torch.empty(m, d_out, dtype=torch.float32, device=x.device)
    part = (torch.empty(splits, m, d_out, dtype=torch.float32, device=x.device)
            if splits > 1 else out)
    with torch.cuda.device(x.device):
        err = _kernel("q40_lab_twodot")(
            x.data_ptr(), bsum.data_ptr() if bsum is not None else None, packed.data_ptr(),
            scales.data_ptr(), out.data_ptr(), part.data_ptr(), m, d_in, d_out, tile, mt,
            splits, per, W_ROUNDS.index(w_round), int(x_round), int(correction),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "q40_lab_twodot")
    _bump(LAUNCHES, "q40_lab_twodot")
    return out


def twodot_bytes(m: int, d_in: int, d_out: int, correction: bool) -> int:
    """Bytes a two-dot product must move: packed weight and scales, x (f32),
    the correction's block sums, the f32 output."""
    weight = d_in * d_out // 2 + (d_in // 32) * d_out * 2
    return weight + 4 * m * d_in + (4 * m * (d_in // 32) if correction else 0) + 4 * m * d_out


# ---------------------------------------------------------------------------
# dense_dot
# ---------------------------------------------------------------------------

DENSE_MAX_M = 32


def dense_dot_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [m, d_in] @ w [d_in, d_out] in f32 (bf16 operands are exact in
    f32); f32 [m, d_out]."""
    return x.to(torch.float32) @ w.to(torch.float32)


def dense_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The dense dot kernel: x [m <= 32, d_in] and w [d_in, d_out], each
    bf16 or f32; f32 [m, d_out]."""
    if x.device.type == "cpu":
        _bump(PLAIN_CALLS, "dense_dot")
        return dense_dot_plain(x, w)
    for t, name in ((x, "x"), (w, "w")):
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dim() != 2:
            raise TypeError(f"{name} must be a 2D float32 or bfloat16 tensor")
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be contiguous on {x.device}")
    (m, d_in), d_out = x.shape, w.shape[1]
    if w.shape[0] != d_in or d_in % 32 or d_out % COLS_PER_THREAD or not 0 < m <= DENSE_MAX_M:
        raise ValueError(f"x {tuple(x.shape)} @ w {tuple(w.shape)} is outside the kernel's "
                         f"shapes (m <= {DENSE_MAX_M}, d_in % 32 == 0, d_out % 4 == 0)")
    mt, splits, per = launch_plan(m, d_in, d_out, _sm_count(x.device))
    out = torch.empty(m, d_out, dtype=torch.float32, device=x.device)
    part = (torch.empty(splits, m, d_out, dtype=torch.float32, device=x.device)
            if splits > 1 else out)
    with torch.cuda.device(x.device):
        err = _kernel("dense_dot")(
            x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
            int(w.dtype == torch.bfloat16), out.data_ptr(), part.data_ptr(), m, d_in, d_out,
            mt, splits, per, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "dense_dot")
    _bump(LAUNCHES, "dense_dot")
    return out


def dense_bytes(m: int, d_in: int, d_out: int, w_bytes: int, x_bytes: int) -> int:
    return d_in * d_out * w_bytes + m * d_in * x_bytes + 4 * m * d_out
