"""Rotary position embeddings, interleaved-pair convention.

The `.m` format stores Q/K weights pre-permuted to the interleaved-rotary
layout, and each head rotates adjacent pairs (x[2i], x[2i+1]) with a
precomputed cos/sin cache, including Llama-3.1 frequency scaling.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _scale_frequency_llama3(
    freq: float,
    scaling_factor: float,
    low_freq_factor: float,
    high_freq_factor: float,
    orig_max_seq_len: int,
) -> float:
    wave_len = 2.0 * math.pi / freq
    high_freq_wavelen = orig_max_seq_len / high_freq_factor
    if wave_len < high_freq_wavelen:
        return freq
    low_freq_wavelen = orig_max_seq_len / low_freq_factor
    if wave_len > low_freq_wavelen:
        return freq / scaling_factor
    smooth = (orig_max_seq_len / wave_len - low_freq_factor) / (high_freq_factor - low_freq_factor)
    return (1 - smooth) * freq / scaling_factor + smooth * freq


def build_rope_cache(
    seq_len: int,
    head_size: int,
    rope_theta: float = 10000.0,
    scaling_factor: float = 1.0,
    low_freq_factor: float = 0.0,
    high_freq_factor: float = 0.0,
    orig_max_seq_len: int = 0,
    dtype=np.float32,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (cos, sin) as numpy, each [seq_len, head_size // 2], float32.
    Pair p (elements 2p, 2p+1 of a head) uses theta^(-2p/head_size)."""
    half = head_size // 2
    freqs = np.empty(half, dtype=np.float64)
    apply_scaling = scaling_factor != 1.0
    for p in range(half):
        freq = 1.0 / (rope_theta ** ((2 * p) / head_size))
        if apply_scaling:
            freq = _scale_frequency_llama3(
                freq, scaling_factor, low_freq_factor, high_freq_factor, orig_max_seq_len
            )
        freqs[p] = freq
    t = np.arange(seq_len, dtype=np.float64)[:, None] * freqs[None, :]
    return np.cos(t).astype(dtype), np.sin(t).astype(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs.

    x: [B, T, n_heads, head_size]; cos/sin: [seq_len, head_size//2] f32;
    positions: [B, T] int. Positions past the cache (idle lanes parked at
    seq_len) are clamped to its last row, as the JAX gather clamps; their
    results are never read. Returns same shape/dtype as x."""
    b, t, h, d = x.shape
    xf = x.to(torch.float32).reshape(b, t, h, d // 2, 2)
    x0 = xf[..., 0]
    x1 = xf[..., 1]
    pos = positions.clamp(0, cos.shape[0] - 1)
    c = cos[pos][:, :, None, :]  # [B, T, 1, d/2]
    s = sin[pos][:, :, None, :]
    r0 = x0 * c - x1 * s
    r1 = x0 * s + x1 * c
    return torch.stack([r0, r1], dim=-1).reshape(b, t, h, d).to(x.dtype)
