"""Packed Q40 weights resident on the card: int4 nibbles + f16 block scales.

Layout (block-local nibble halves, the same as the JAX package's device
layout and the ``.m`` Q40 block itself):

    packed: uint8 [..., d_in//2, d_out]
        row r = (b, j) with b = r // 16, j = r % 16:
        packed[r, o] = (v[32b + j, o] + 8) | ((v[32b + j + 16, o] + 8) << 4)
    scales: float16 [..., d_in//32, d_out]
        scales[b, o] covers input rows i in [32b, 32b+32)

The weight is stored transposed ([d_in, d_out], ready for y = x @ W). Each
32-input quant block is 16 consecutive packed rows plus one scale row, so a
range of whole blocks covers the same inputs in ``packed``, ``scales`` and
``x``. Dequantization is (nibble - 8) * f16(scale).

A ``.m`` Q40 block stores byte j as ``q[j] | q[j + 16] << 4`` with
``q = v + 8``, which is exactly ``packed[16b + j, o]`` above: loading a file
tensor is a byte transpose, done on the target device
(``pack_q40_from_blocks``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .codec import Q40_BLOCK_BYTES, Q40_BLOCK_SIZE


@dataclass
class PackedQ40:
    """A Q40-quantized matmul weight, logical shape [..., d_in, d_out]."""

    packed: torch.Tensor  # uint8 [..., d_in//2, d_out]
    scales: torch.Tensor  # float16 [..., d_in//32, d_out]

    @property
    def d_in(self) -> int:
        return self.packed.shape[-2] * 2

    @property
    def d_out(self) -> int:
        return self.packed.shape[-1]

    def __getitem__(self, i) -> "PackedQ40":
        """Index the leading (layer) axis: ``w[l]`` is layer l's weight."""
        return PackedQ40(packed=self.packed[i], scales=self.scales[i])

    def to(self, device) -> "PackedQ40":
        return PackedQ40(self.packed.to(device), self.scales.to(device))


def pack_q40_planar(values: np.ndarray, scales: np.ndarray):
    """Planar int8 values [..., d_out, d_in] (centered at 0, file
    orientation) + f16-exact scales [..., d_out, d_in//32] -> the device
    layout as numpy (packed uint8 [..., d_in//2, d_out], scales f16
    [..., d_in//32, d_out])."""
    d_in = values.shape[-1]
    assert d_in % Q40_BLOCK_SIZE == 0, values.shape
    lead = values.shape[:-2]
    d_out = values.shape[-2]
    n_blk = d_in // Q40_BLOCK_SIZE
    half = Q40_BLOCK_SIZE // 2
    v = np.swapaxes(values, -1, -2)  # [..., d_in, d_out]
    vb = v.reshape(*lead, n_blk, Q40_BLOCK_SIZE, d_out)
    lo = (vb[..., :half, :].astype(np.int16) + 8).astype(np.uint8)
    hi = (vb[..., half:, :].astype(np.int16) + 8).astype(np.uint8)
    packed = ((lo & 0x0F) | ((hi & 0x0F) << 4)).reshape(*lead, d_in // 2, d_out)
    scales_t = np.swapaxes(scales, -1, -2).astype(np.float16)
    # row-major, as the kernels read them (the swaps above leave strided views)
    return np.ascontiguousarray(packed), np.ascontiguousarray(scales_t)


def pack_q40_from_blocks(raw_blocks, shape: tuple[int, int], *, device):
    """Packed ``.m`` Q40 block bytes (row-major over [d_out, d_in], blocks
    along d_in) -> (packed uint8 [d_in//2, d_out], scales f16 [d_in//32,
    d_out]) on ``device``, without dequantizing: the 16 nibble bytes of
    block (o, b) are packed rows 16b..16b+15 of column o verbatim, so the
    repack is a transpose of the raw bytes."""
    d_out, d_in = shape
    n_blk = d_in // Q40_BLOCK_SIZE
    raw = np.asarray(raw_blocks, np.uint8)
    if not raw.flags.writeable:  # a view into the model file's mmap
        raw = raw.copy()
    raw = torch.from_numpy(raw).to(device)
    raw = raw.view(d_out, n_blk, Q40_BLOCK_BYTES)
    packed = raw[:, :, 2:].reshape(d_out, d_in // 2).t().contiguous()
    scales = raw[:, :, :2].contiguous().view(torch.float16)
    return packed, scales.reshape(d_out, n_blk).t().contiguous()


def unpack_q40(w: PackedQ40, dtype=torch.float32) -> torch.Tensor:
    """Dequantize to a dense [..., d_in, d_out] tensor: (nibble - 8) * scale
    in f32, then cast to ``dtype``."""
    lead = w.packed.shape[:-2]
    d_in, d_out = w.d_in, w.d_out
    n_blk = d_in // Q40_BLOCK_SIZE
    half = Q40_BLOCK_SIZE // 2
    pb = w.packed.reshape(*lead, n_blk, half, d_out)
    lo = (pb & 0x0F).to(torch.float32) - 8.0
    hi = (pb >> 4).to(torch.float32) - 8.0
    vals = torch.cat([lo, hi], dim=-2)  # [..., n_blk, 32, d_out]
    out = vals * w.scales.to(torch.float32).unsqueeze(-2)
    return out.reshape(*lead, d_in, d_out).to(dtype)


def q40_matmul_dense(x: torch.Tensor, w: PackedQ40) -> torch.Tensor:
    """y = x @ dequant(w) by dequantizing the whole weight to x's dtype
    first, then one product accumulated in f32; the counterpart of the JAX
    package's ``q40_matmul_xla``. Output in x's dtype."""
    wd = unpack_q40(w, x.dtype).to(torch.float32)
    return torch.matmul(x.to(torch.float32), wd).to(x.dtype)
