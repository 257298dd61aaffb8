"""The JAX engine's on-device sampler, in PyTorch.

The JAX package samples one lane (``_sample_lane``) as an exact full-vocab
nucleus followed by ``jax.random.categorical`` under
``fold_in(PRNGKey(seed), pos)``:

    vals, idx = top_k(row, vocab)                 # a total descending sort
    p = softmax(vals / max(temp, 1e-6))
    keep = (cumsum(p) - p) < topp_eff             # topp <= 0 or >= 1: all
    choice = argmax(gumbel(key, [vocab]) + log(where(keep, p, 0)))
    token = idx[choice]

This module is that computation with JAX's own random bits: threefry2x32
(20 rounds, the key schedule of ``jax._src.prng``), ``fold_in`` as one
threefry of the counter pair (0, pos) under the key (0, seed), the
partitionable bit layout (element i hashes the counter pair (0, i) and
keeps the XOR of the two output words), the mantissa-fill uniform on
[tiny, 1) and ``gumbel``'s default low-range mode, -log(-log(u)). The
uniforms are bit-identical to ``jax.random.uniform``'s; the noise agrees
to the ulps of ``log`` between libraries, so a seeded request draws the
same tokens on both packages.

uint32 arithmetic runs on int64 tensors masked to 32 bits. The Gumbel
argmax is the sampler's hot part: on a CUDA tensor ``ops/cuda_sample.py``
runs it as one kernel launch, on a CPU tensor its plain version below.
The sort stays ``torch.sort``, stable and on total-order keys, so that
equal logits keep ``lax.top_k``'s lower-index-first order and -0.0 sorts
below +0.0 as there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda_sample import gumbel_argmax

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = float(np.finfo(np.float32).tiny)  # gumbel's minval (finfo.tiny)
TEMP_FLOOR = 1e-6
_SCALE = float(np.float32(1.0) - np.float32(TINY))  # maxval - minval in f32: 1.0


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of counter words (x0, x1) under key (k0, k1):
    int64 tensors (or ints) holding uint32 values, broadcast together.
    Five groups of four rounds, a key injection after each, as
    ``jax._src.prng._threefry2x32_lowering``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def fold_in_keys(seeds: torch.Tensor, positions: torch.Tensor):
    """Per lane, the key data of ``fold_in(PRNGKey(seed), pos)``: a uint32
    seed makes the key (0, seed), and folding in pos hashes the counter
    pair (0, pos) under it. Returns (k0, k1), int64 [n]."""
    seeds = seeds.to(torch.int64) & MASK32
    zero = torch.zeros_like(seeds)
    return threefry2x32(zero, seeds, zero, positions.to(torch.int64) & MASK32)


def random_bits(k0: torch.Tensor, k1: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` per lane under the
    partitionable layout: element i is the XOR of threefry's two words
    for the counter pair (0, i). k0, k1: int64 [lanes] -> int64 [lanes, n]."""
    i = torch.arange(n, dtype=torch.int64, device=k0.device)[None, :]
    b0, b1 = threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(i), i)
    return b0 ^ b1


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(minval=tiny, maxval=1)`` from 32 random bits:
    the top 23 bits fill the mantissa of a float in [1, 2), minus 1, then
    scaled by float32(1 - tiny) (which is 1.0), shifted by tiny and held
    at or above tiny."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = fbits.view(torch.float32) - 1.0
    return torch.clamp(f * _SCALE + TINY, min=TINY)


def gumbel_noise(k0: torch.Tensor, k1: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` in its default low-range mode,
    per lane: -log(-log(u)) with u the uniforms above. f32 [lanes, n]."""
    u = uniform_from_bits(random_bits(k0, k1, n))
    return -torch.log(-torch.log(u))


def gumbel_argmax_plain(logp: torch.Tensor, seeds: torch.Tensor,
                        positions: torch.Tensor) -> torch.Tensor:
    """The sampler kernel's plain version: per lane, the first index of
    the largest gumbel(fold_in(seed, pos)) + logp. logp: f32 [n, vocab];
    seeds, positions: int [n]. Returns int64 [n]."""
    k0, k1 = fold_in_keys(seeds, positions)
    g = gumbel_noise(k0, k1, logp.shape[-1])
    return torch.argmax(g + logp, dim=-1)


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys that order f32 values as ``lax.top_k`` does: by their
    IEEE total order, so -0.0 sorts below +0.0 (a comparison of floats
    would tie them)."""
    bits = x.view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def nucleus_logp(rows: torch.Tensor, temps: torch.Tensor, topps: torch.Tensor):
    """The exact nucleus of each row [n, vocab]: a stable descending sort
    (in the total order of ``total_order_key``),
    softmax at max(temp, 1e-6), every token up to and including the one
    whose cumulative probability crosses top-p kept (top-p <= 0 or >= 1
    keeps all), and log p of the kept mass (-inf elsewhere). Returns
    (logp f32 [n, vocab] in sorted order, sorted token ids int64)."""
    rows = rows.to(torch.float32).contiguous()
    _, idx = torch.sort(total_order_key(rows), dim=-1, descending=True, stable=True)
    vals = torch.gather(rows, -1, idx)
    t = torch.clamp(temps.to(torch.float32), min=TEMP_FLOOR)[:, None]
    p = torch.softmax(vals / t, dim=-1)
    csum = torch.cumsum(p, dim=-1)
    topps = topps.to(torch.float32)
    topp_eff = torch.where((topps <= 0.0) | (topps >= 1.0), torch.ones_like(topps), topps)
    keep = (csum - p) < topp_eff[:, None]
    return torch.log(torch.where(keep, p, torch.zeros_like(p))), idx


def sample_lanes(rows: torch.Tensor, temps: torch.Tensor, topps: torch.Tensor,
                 seeds: torch.Tensor, positions: torch.Tensor,
                 greedy: torch.Tensor) -> torch.Tensor:
    """One nucleus draw per lane under fold_in(seed, pos); lanes at
    temperature 0 keep their greedy token. All arguments are tensors on
    the rows' device; returns int64 [n]."""
    logp, idx = nucleus_logp(rows, temps, topps)
    choice = gumbel_argmax(logp, seeds, positions)
    token = torch.gather(idx, 1, choice[:, None])[:, 0]
    return torch.where(temps == 0.0, greedy.to(torch.int64), token)
