"""On-device Q80 block codec in PyTorch: the one definition the activation
emulation (``--buffer-float-type q80``, models/llama.py) and the Q80 wire of
the TP collectives (ops/ring_collective.py, parallel/collectives.py) share.

The same formula as the host codec (quants/codec.py) and the JAX package's
device codec:

- ``d32 = amax / 127`` in f32, ``inv = 1 / d32`` (0 for an all-zero block),
  and the values are ``x * inv``: multiplied by the inverse, not divided;
- ``mode="runtime"`` rounds half away from zero (``sign * floor(|s| + 0.5)``,
  the reference runtime's roundf); ``mode="converter"`` rounds ties to even
  (``torch.round``, the converter's np.round);
- values clip to [-128, 127]; the scale is stored as f16, and decoding
  multiplies by that f16-rounded scale. The f32 ``d32`` quantizes, the f16
  one dequantizes.
"""

from __future__ import annotations

import torch

Q80_BLOCK = 32


def q80_encode_blocks(x: torch.Tensor, mode: str = "runtime", out: tuple | None = None):
    """x [..., n] with n % 32 == 0 -> (q int8 [..., n/32, 32], scales f16
    [..., n/32, 1]). ``out``: an (int8, f16) pair of those shapes, possibly
    views into wider buffers, written in place and returned."""
    shape = x.shape
    if shape[-1] % Q80_BLOCK:
        raise ValueError(f"last dim {shape[-1]} is not a whole number of "
                         f"{Q80_BLOCK}-value Q80 blocks")
    xf = x.to(torch.float32).reshape(*shape[:-1], shape[-1] // Q80_BLOCK, Q80_BLOCK)
    d32 = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    nonzero = d32 != 0
    inv = torch.where(nonzero, 1.0 / torch.where(nonzero, d32, torch.ones_like(d32)),
                      torch.zeros_like(d32))
    scaled = xf * inv
    if mode == "runtime":
        q = torch.sign(scaled) * torch.floor(scaled.abs() + 0.5)
    elif mode == "converter":
        q = torch.round(scaled)
    else:
        raise ValueError(f"unknown Q80 rounding mode {mode!r}")
    if out is None:
        return q.clamp(-128, 127).to(torch.int8), d32.to(torch.float16)
    out[0].copy_(q.clamp(-128, 127))
    out[1].copy_(d32)
    return out


def q80_decode_blocks(q: torch.Tensor, scales: torch.Tensor, out_shape) -> torch.Tensor:
    """Inverse of ``q80_encode_blocks`` in f32, at the f16-rounded scales."""
    return (q.to(torch.float32) * scales.to(torch.float32)).reshape(out_shape)


def qdq_q80(x: torch.Tensor, mode: str = "runtime") -> torch.Tensor:
    """Quantize-dequantize round trip along the last axis, in x's dtype."""
    q, s = q80_encode_blocks(x, mode=mode)
    return q80_decode_blocks(q, s, x.shape).to(x.dtype)
