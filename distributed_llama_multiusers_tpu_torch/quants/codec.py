"""Block-quantization codecs, bit-exact with the reference formats.

Reference semantics (cited file:line are into the C++ distributed-llama sources):

- Q40: 32-element blocks, one fp16 scale ``d = signed_absmax / -8`` and 16
  packed nibble bytes; encode is ``clip(trunc(x/d + 8.5), 0, 15)``
  (converter/writer.py:29-53, src/nn/nn-quants.cpp:193-227); decode is
  ``(nibble - 8) * d`` with the low nibbles holding elements [0,16) and the
  high nibbles elements [16,32) (src/nn/nn-quants.cpp:229-246).
- Q80: 32-element blocks, fp16 scale ``d = absmax / 127``, 32 int8 values
  ``round(x/d)`` (converter/writer.py:55-74, src/nn/nn-quants.cpp:154-172).
  NOTE: the reference converter rounds ties-to-even (np.round) while the
  C++ runtime quantizer rounds ties-away-from-zero (roundf); both are
  provided here via ``mode`` so each call site can match its counterpart.
- F16 scale conversion is IEEE half round-to-nearest-even, which numpy's
  float16 cast implements (matches src/nn/nn-quants.cpp:35-65).

All functions are vectorized numpy; these are the host-side codecs used by
the synthetic-model writer and the weight loader.
"""

from __future__ import annotations

import numpy as np

Q40_BLOCK_SIZE = 32
Q80_BLOCK_SIZE = 32
Q40_BLOCK_BYTES = 2 + Q40_BLOCK_SIZE // 2  # fp16 scale + 16 nibble bytes
Q80_BLOCK_BYTES = 2 + Q80_BLOCK_SIZE  # fp16 scale + 32 int8


class FloatType:
    """Tensor element-type ids used by the .m format (src/nn/nn-quants.hpp:56-62)."""

    F32 = 0
    F16 = 1
    Q40 = 2
    Q80 = 3


_FLOAT_TYPE_NAMES = {
    FloatType.F32: "f32",
    FloatType.F16: "f16",
    FloatType.Q40: "q40",
    FloatType.Q80: "q80",
}


def float_type_name(float_type: int) -> str:
    return _FLOAT_TYPE_NAMES[float_type]


def tensor_bytes(float_type: int, n_elements: int) -> int:
    """On-disk byte size of a flat tensor (src/nn/nn-core.cpp getBytes)."""
    if float_type == FloatType.F32:
        return 4 * n_elements
    if float_type == FloatType.F16:
        return 2 * n_elements
    if float_type == FloatType.Q40:
        assert n_elements % Q40_BLOCK_SIZE == 0
        return (n_elements // Q40_BLOCK_SIZE) * Q40_BLOCK_BYTES
    if float_type == FloatType.Q80:
        assert n_elements % Q80_BLOCK_SIZE == 0
        return (n_elements // Q80_BLOCK_SIZE) * Q80_BLOCK_BYTES
    raise ValueError(f"unsupported float type {float_type}")


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """C roundf: round half away from zero (vs np.round's ties-to-even)."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def quantize_q40(x: np.ndarray) -> np.ndarray:
    """Quantize float32 array (flat, multiple of 32) to packed Q40 bytes.

    Returns a uint8 array of shape [nBlocks, 18]: bytes 0:2 are the fp16
    scale (little-endian), bytes 2:18 the packed nibbles. Bit-exact with
    converter/writer.py:29-53 (the producer of .m files) which itself matches
    src/nn/nn-quants.cpp:193-227 for all inputs (both truncate toward zero
    after the +8.5 offset; values are always positive there).
    """
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    assert x.size % Q40_BLOCK_SIZE == 0, x.size
    groups = x.reshape(-1, Q40_BLOCK_SIZE)
    gmax = groups.max(axis=1)
    gmin = groups.min(axis=1)
    deltas = np.where(-gmin > gmax, gmin, gmax) / -8.0
    deltas16 = deltas.astype(np.float16)
    ids = np.where(deltas != 0, np.divide(1.0, deltas, where=deltas != 0), 0.0)
    q = groups * ids[:, None] + 8.5
    q = np.clip(q, 0, 15).astype(np.int64)  # trunc toward zero; q >= 0
    half = Q40_BLOCK_SIZE // 2
    packed = (q[:, :half] & 0xF) | ((q[:, half:] & 0xF) << 4)
    out = np.empty((groups.shape[0], Q40_BLOCK_BYTES), dtype=np.uint8)
    out[:, 0:2] = deltas16.view(np.uint16).astype("<u2").view(np.uint8).reshape(-1, 2)
    out[:, 2:] = packed.astype(np.uint8)
    return out


def dequantize_q40(blocks: np.ndarray) -> np.ndarray:
    """Packed Q40 bytes [nBlocks, 18] -> float32 flat array.

    Matches src/nn/nn-quants.cpp:229-246: low nibbles are elements [0,16),
    high nibbles elements [16,32) of each block.
    """
    values, scales = q40_to_planar(blocks)
    return (values.astype(np.float32) * scales[:, None].astype(np.float32)).reshape(-1)


def q40_to_planar(blocks: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Packed Q40 -> (int8 values [nBlocks, 32] centered at 0, f32 scales [nBlocks]).

    The planar layout feeds the on-device dequant-matmul path.
    """
    blocks = np.asarray(blocks, dtype=np.uint8).reshape(-1, Q40_BLOCK_BYTES)
    scales = blocks[:, 0:2].copy().view("<u2").view(np.float16).astype(np.float32).reshape(-1)
    qs = blocks[:, 2:]
    low = (qs & 0x0F).astype(np.int8) - 8
    high = (qs >> 4).astype(np.int8) - 8
    values = np.concatenate([low, high], axis=1)
    return values, scales


def quantize_q80(x: np.ndarray, mode: str = "runtime") -> np.ndarray:
    """Quantize float32 (flat, multiple of 32) to packed Q80 bytes [nBlocks, 34].

    mode="runtime" rounds half away from zero (src/nn/nn-quants.cpp:169
    roundf); mode="converter" rounds ties-to-even (converter/writer.py:67
    np.round). The two differ only on exact .5 scaled values.
    """
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    assert x.size % Q80_BLOCK_SIZE == 0
    groups = x.reshape(-1, Q80_BLOCK_SIZE)
    amax = np.abs(groups).max(axis=1)
    deltas = amax / 127.0
    deltas16 = deltas.astype(np.float16)
    ids = np.where(deltas != 0, np.divide(1.0, deltas, where=deltas != 0), 0.0)
    scaled = groups * ids[:, None]
    if mode == "runtime":
        q = _round_half_away(scaled)
    elif mode == "converter":
        q = np.round(scaled)
    else:
        raise ValueError(mode)
    q = q.astype(np.int8)
    out = np.empty((groups.shape[0], Q80_BLOCK_BYTES), dtype=np.uint8)
    out[:, 0:2] = deltas16.view(np.uint16).astype("<u2").view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out


def dequantize_q80(blocks: np.ndarray) -> np.ndarray:
    """Packed Q80 bytes [nBlocks, 34] -> float32 flat (src/nn/nn-quants.cpp:175-191)."""
    values, scales = q80_to_planar(blocks)
    return (values.astype(np.float32) * scales[:, None].astype(np.float32)).reshape(-1)


def q80_to_planar(blocks: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Packed Q80 -> (int8 values [nBlocks, 32], f32 scales [nBlocks])."""
    blocks = np.asarray(blocks, dtype=np.uint8).reshape(-1, Q80_BLOCK_BYTES)
    scales = blocks[:, 0:2].copy().view("<u2").view(np.float16).astype(np.float32).reshape(-1)
    values = blocks[:, 2:].copy().view(np.int8)
    return values, scales


def quantize_dequantize_q80(x: np.ndarray, mode: str = "runtime") -> np.ndarray:
    """Round-trip through Q80 — emulates the reference's activation-sync
    quantization (cast F32->Q80 before every TP sync, src/llm.cpp:150)."""
    return dequantize_q80(quantize_q80(x, mode=mode)).reshape(x.shape)
