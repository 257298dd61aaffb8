"""The Q80-compressed TP sync: the reference's default transport (int8
values + f16 block scales instead of f32 on the wire), for a mesh served
with ``--buffer-float-type q80 --ring-sync off``. Both halves run on the
ring hop (ops/ring_collective.py), across a pod's processes too."""

from __future__ import annotations

from ..ops.ring_collective import (
    per_rank,
    held,
    chunk_d_out,
    local_matmul,
    ring_all_gather_q80,
    ring_reduce_scatter,
)
from ..quants.torch_codec import Q80_BLOCK


def q80_sync_supported(dim: int, tp: int) -> bool:
    """Whether a tp-sharded output of width ``dim`` can ship as Q80: each
    rank's slice must be whole 32-value blocks."""
    return tp > 1 and dim % (Q80_BLOCK * tp) == 0


def q80_sync_engages(config, mesh_shape: dict) -> bool:
    """Whether the Q80 sync transport engages: the one predicate that
    ``llama_forward`` and the startup log both read, so that what is
    announced is what runs. Needs a pure-TP mesh and whole Q80 blocks per
    tp shard of every synced output (wo: dim; the dense FFN's w2: also
    hidden_dim)."""
    tp = mesh_shape.get("tp", 1)
    if tp <= 1:
        return False
    if any(mesh_shape.get(ax, 1) > 1 for ax in ("dp", "sp", "ep", "pp")):
        return False
    return q80_sync_supported(config.dim, tp) and (
        config.n_experts > 0 or q80_sync_supported(config.hidden_dim, tp)
    )


def q80_sync_matmul(xs: list, ws: list) -> list:
    """Row-parallel matmul whose sync ships Q80: each rank's partial (in x's
    dtype), a ring reduce-scatter, then a Q80-wire ring all-gather. xs:
    per-rank [..., d_in/n]; ws: per-rank column-chunk stacks. Returns the
    full [..., d_out] on every rank, in x's dtype; d_out % (32 * n) == 0. In a
    pod the lists hold None for the ranks of other processes."""
    n = len(xs)
    d_out = chunk_d_out(held(ws)[0])
    if d_out % (Q80_BLOCK * n) != 0:
        raise ValueError(f"q80_sync_matmul needs d_out ({d_out}) divisible by "
                         f"{Q80_BLOCK} * tp ({n})")
    parts = per_rank(local_matmul, xs, ws)
    out = ring_all_gather_q80(ring_reduce_scatter(parts))
    return per_rank(lambda o, p: o.to(p.dtype), out, parts)
