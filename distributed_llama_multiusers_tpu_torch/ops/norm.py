"""RMS norm: 1/sqrt(mean(x^2) + eps) per row in f32, times the weight."""

from __future__ import annotations

import torch

# the sum of squares runs as sums of this many values, then their sum
_NORM_CHUNK = 128


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: [..., dim]; weight: [dim]. Reduction in float32 regardless of x dtype.

    Where dim is a multiple of 128 the sum of squares is taken in two
    stages, sums of 128 values then their sum: on the card each stage's
    reduction then adds a row's values in one order whatever the number of
    rows, so a row gets the same bits in a decode step and in a verify
    step of four rows a lane (one reduction over the whole row changes its
    thread layout with the row count)."""
    xf = x.to(torch.float32)
    sq = xf * xf
    dim = x.shape[-1]
    if dim % _NORM_CHUNK == 0:
        parts = sq.reshape(-1, _NORM_CHUNK).sum(dim=-1)
        ss = parts.reshape(*x.shape[:-1], dim // _NORM_CHUNK).sum(dim=-1, keepdim=True)
        mean = ss / dim
    else:
        mean = torch.mean(sq, dim=-1, keepdim=True)
    inv = torch.rsqrt(mean + eps)
    return (xf * inv * weight.to(torch.float32)).to(x.dtype)
