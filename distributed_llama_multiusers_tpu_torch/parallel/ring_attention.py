"""Sequence-parallel attention over a cache whose slots are split over the
sp ranks: the JAX package's ``parallel/ring_attention.sp_attention``.

Each sp rank holds one block of every lane's cache slots
(parallel/sharding.py) and computes flash partial stats over it: the
softmax max m of its scaled scores, their sum l after m, and the
normalised weighted V o, masked to the slots at or below each query's
position (``ops/cuda_attn.decode_attention_stats`` for a decode step or a
verify window, the kernel with positions shifted by the block's start;
``ops/cuda_attn.block_stats``, the plain version, for a prompt chunk).
Then the ranks' stats are gathered over the sp group by the ring hop
(``ring_all_gather``, one [..., hd + 2] wire tensor a rank) and every rank
combines them in sp-rank order: M = max m, w = l exp(m - M) where l > 0,
out = sum w o / sum w. Every sp rank then holds the same output, as the
JAX ``out_specs`` replicate it over sp. The JAX combine is a pmax and two
psums of the unnormalised stats; the order here is fixed by the sp ranks,
so every rank's bits agree.

JAX's ``ring_attention`` (sequence-sharded queries) serves only its
training forward and waits for the training slice (ROADMAP A9.2).
"""

from __future__ import annotations

import torch

from ..ops.ring_collective import held, ring_all_gather


def combine_stats(parts: list) -> torch.Tensor:
    """The attention output from every sp rank's (o, l, m), in sp-rank order
    (the JAX ``_merge_stats`` over the ranks, then ``_finalize``)."""
    m_all = torch.stack([m for _, _, m in parts])
    big = m_all.amax(dim=0)
    big = torch.where(torch.isfinite(big), big, torch.zeros_like(big))
    num = den = None
    for o, l, m in parts:
        w = torch.where(l > 0, l * torch.exp(torch.where(torch.isfinite(m), m,
                                                         torch.zeros_like(m)) - big),
                        torch.zeros_like(l))
        term = o * w[..., None]
        num = term if num is None else num + term
        den = w if den is None else den + w
    return num / den.clamp_min(1e-30)[..., None]


def _pack(stats) -> torch.Tensor:
    o, l, m = stats
    return torch.cat([o, l[..., None], m[..., None]], dim=-1).contiguous()


def _unpack(wire: torch.Tensor, n: int) -> list:
    """The n ranks' (o, l, m) from a gathered [..., n * (hd + 2)] tensor."""
    w = wire.view(*wire.shape[:-1], n, wire.shape[-1] // n)
    return [(w[..., i, :-2], w[..., i, -2], w[..., i, -1]) for i in range(n)]


def sp_attention(stats: list, groups: list) -> list:
    """Per-rank attention outputs [B, T, K, G, H] from per-rank flash stats
    (None where this process does not hold the rank): each sp group's stats
    gathered through the ring hop, then combined on every rank in sp
    order."""
    out = [None] * len(stats)
    for g in groups:
        mine = [stats[r] for r in g]
        if not held(mine):
            continue
        gathered = ring_all_gather([None if st is None else _pack(st) for st in mine])
        for r, wire in zip(g, gathered):
            if wire is not None:
                out[r] = combine_stats(_unpack(wire, len(g)))
    return out
