"""Tensor-parallel sharding of the parameters and the KV cache: the JAX
package's ``param_shardings``/``cache_shardings`` (the reference's slicers)
as per-rank copies.

    row-sliced (split d_out):  wq, wk, wv, w1, w3, wcls, and the q/k/v biases
    col-sliced (split d_in):   wo, w2
    replicated:                embedding, norms, RoPE tables, the MoE router
    KV cache:                  split on the kv heads
    paged KV pool:             split on the kv heads; one page table for
                               every rank (``paged_cache_shardings`` in
                               the JAX package)

A col-sliced rank's weight is stored as its column-chunk stack
[n, d_in/n, d_out/n] (packed: [n, d_in/2/n, d_out/n] nibbles and [n,
d_in/32/n, d_out/n] scales, the same input range): the ring sync multiplies
one output chunk per hop, and a column slice of a [d_in/2, d_out] plane is
not contiguous, which the kernels refuse. Splitting once here costs nothing
per call.

In a pod (``mesh.is_pod``) a process keeps only its local ranks' shards:
every list here holds ``mesh.local_ranks``' entries, in order.

MoE expert stacks shard as the JAX package's shardings do (experts on
``ep``, which stays 1; the d axis on tp): w1/w3 [L, E, dim, hidden] row-
sliced on hidden for every expert, w2 [L, E, hidden, dim] split on its input
rows as a plain [L, E, hidden/tp, dim] stack (its partials meet in one
all-reduce, never in ``ring_sync_matmul``, so it needs no column chunks).
"""

from __future__ import annotations

import torch

from ..models.llama import KVCache, LlamaLayerParams, LlamaParams, PagedKVCache
from ..quants.packed import PackedQ40
from .mesh import Mesh

_ROW_SLICED = ("wq", "wk", "wv", "w1", "w3", "bq", "bk", "bv")
_COL_SLICED = ("wo", "w2")


def _ranks(mesh: Mesh):
    """(global rank, device) of the ranks this process holds."""
    return zip(mesh.local_ranks, mesh.devices)


def _map(w, fn):
    if w is None:
        return None
    if isinstance(w, PackedQ40):
        return PackedQ40(fn(w.packed), fn(w.scales))
    return fn(w)


def _out_slice(t: torch.Tensor, r: int, n: int) -> torch.Tensor:
    c = t.shape[-1] // n
    return t[..., r * c:(r + 1) * c]


def _col_chunks(t: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """Rows (inputs) shard r of [..., rows, d_out], as its n column chunks
    stacked before the rows: [..., n, rows/n, d_out/n]."""
    rows = t.shape[-2] // n
    s = t[..., r * rows:(r + 1) * rows, :]
    return torch.stack([_out_slice(s, k, n) for k in range(n)], dim=-3)


def row_shards(w, mesh: Mesh) -> list:
    """A row-sliced weight (or bias) split on d_out: rank r's slice on its
    device."""
    n = mesh.tp
    return [_map(w, lambda t: _out_slice(t, r, n).contiguous().to(dev))
            for r, dev in _ranks(mesh)]


def in_shards(w, mesh: Mesh) -> list:
    """A weight split on d_in (its input rows): rank r's slice on its
    device."""
    n = mesh.tp

    def rows(t, r):
        c = t.shape[-2] // n
        return t[..., r * c:(r + 1) * c, :].contiguous()

    return [_map(w, lambda t: rows(t, r).to(dev)) for r, dev in _ranks(mesh)]


def col_shards(w, mesh: Mesh) -> list:
    """A col-sliced weight split on d_in: rank r's column-chunk stack on its
    device."""
    n = mesh.tp
    return [_map(w, lambda t: _col_chunks(t, r, n).to(dev))
            for r, dev in _ranks(mesh)]


def shard_params(params: LlamaParams, mesh: Mesh) -> list:
    """Each held rank's parameters on its device, one LlamaParams per rank.
    Raises where a col-sliced packed weight's shard (an MoE w2's included)
    would split a quant block (d_in / tp % 32 != 0)."""
    n = mesh.tp
    lp = params.layers
    for key in _COL_SLICED:
        w = getattr(lp, key)
        if isinstance(w, PackedQ40) and (w.d_in // n) % 32:
            raise ValueError(f"{key}: d_in={w.d_in} / tp={n} is not a whole number "
                             "of 32-value quant blocks")
    split = {key: row_shards(getattr(lp, key), mesh) for key in _ROW_SLICED}
    moe = lp.moe_gate is not None
    split.update({key: (in_shards if moe and key == "w2" else col_shards)(getattr(lp, key), mesh)
                  for key in _COL_SLICED})
    wcls = row_shards(params.wcls, mesh)
    return [LlamaParams(
        embedding=params.embedding.to(dev),
        layers=LlamaLayerParams(**{k: v[i] for k, v in split.items()},
                                rms_att=lp.rms_att.to(dev), rms_ffn=lp.rms_ffn.to(dev),
                                moe_gate=lp.moe_gate.to(dev) if moe else None),
        rms_final=params.rms_final.to(dev),
        wcls=wcls[i],
        rope_cos=params.rope_cos.to(dev),
        rope_sin=params.rope_sin.to(dev),
    ) for i, dev in enumerate(mesh.devices)]


def shard_kv_cache(cache: KVCache, mesh: Mesh) -> list:
    """Rank r's share of a [L, B, S, n_kv, hd] cache: kv heads r*n_kv/tp ..
    (r+1)*n_kv/tp, on rank r's device."""
    n = mesh.tp
    h = cache.k.shape[3] // n
    return [KVCache(k=cache.k[:, :, :, r * h:(r + 1) * h].contiguous().to(dev),
                    v=cache.v[:, :, :, r * h:(r + 1) * h].contiguous().to(dev))
            for r, dev in _ranks(mesh)]


def shard_paged_kv_cache(cache: PagedKVCache, mesh: Mesh) -> list:
    """Rank r's share of a paged pool [L, P, page, n_kv, hd]: kv heads
    r*n_kv/tp .. (r+1)*n_kv/tp, on rank r's device. The page table is the
    same for every rank: ranks on one device share one table tensor (read
    only inside a step; the engine rewrites it between steps), others hold
    a copy on their own device."""
    n = mesh.tp
    h = cache.k.shape[3] // n
    tables: dict = {}
    out = []
    for r, dev in _ranks(mesh):
        if dev not in tables:
            tables[dev] = cache.table.to(dev, copy=True)
        out.append(PagedKVCache(k=cache.k[:, :, :, r * h:(r + 1) * h].contiguous().to(dev),
                                v=cache.v[:, :, :, r * h:(r + 1) * h].contiguous().to(dev),
                                table=tables[dev]))
    return out
