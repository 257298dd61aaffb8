"""RMS norm: 1/sqrt(mean(x^2) + eps) per row in f32, times the weight."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: [..., dim]; weight: [dim]. Reduction in float32 regardless of x dtype."""
    xf = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * weight.to(torch.float32)).to(x.dtype)
