"""Hidden activations, computed in f32."""

from __future__ import annotations

import torch


def silu(x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    return (xf / (1.0 + torch.exp(-xf))).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # tanh approximation
    xf = x.to(torch.float32)
    inner = 0.797884560802865 * xf * (1.0 + 0.044715 * xf * xf)
    return (0.5 * xf * (1.0 + torch.tanh(inner))).to(x.dtype)
