"""Sharding of the parameters and the KV cache over a mesh: the JAX
package's ``param_shardings``/``cache_shardings`` (the reference's slicers)
as per-rank copies.

    row-sliced (split d_out on tp):  wq, wk, wv, w1, w3, wcls, the q/k/v biases
    col-sliced (split d_in on tp):   wo, w2
    replicated:                      embedding, norms, RoPE tables, the MoE router
    over dp and sp:                  every weight replicated
    KV cache:                        lanes over dp, slots over sp, kv heads over tp
    paged KV pool:                   split on the kv heads; one page table for
                                     every rank (``paged_cache_shardings`` in
                                     the JAX package; dp and sp refuse it)

A col-sliced rank's weight is stored as its column-chunk stack
[n, d_in/n, d_out/n] (packed: [n, d_in/2/n, d_out/n] nibbles and [n,
d_in/32/n, d_out/n] scales, the same input range): the ring sync multiplies
one output chunk per hop, and a column slice of a [d_in/2, d_out] plane is
not contiguous, which the kernels refuse. Splitting once here costs nothing
per call.

A rank takes its tp slice by its tp coordinate (parallel/mesh.py). Ranks on
one device share one tensor for each piece they hold alike (a replicated
weight, or the same tp slice of a dp or sp copy): the forward only reads
them.

In a pod (``mesh.is_pod``) a process keeps only its local ranks' shards:
every list here holds ``mesh.local_ranks``' entries, in order.

MoE expert stacks shard as the JAX package's shardings do
(``("pp", "ep", None, "tp")`` / ``("pp", "ep", "tp", None)``): E/ep experts a
rank on the expert axis, by its ep coordinate, and the d axis on tp: w1/w3
[L, E, dim, hidden] row-sliced on hidden for every expert, w2 [L, E, hidden,
dim] split on its input rows as a plain [L, E/ep, hidden/tp, dim] stack (its
partials meet in one all-reduce, never in ``ring_sync_matmul``, so it needs
no column chunks).
"""

from __future__ import annotations

import torch

from ..models.llama import KVCache, LlamaLayerParams, LlamaParams, PagedKVCache
from ..quants.packed import PackedQ40
from .mesh import Mesh

_ROW_SLICED = ("wq", "wk", "wv", "w1", "w3", "bq", "bk", "bv")
_COL_SLICED = ("wo", "w2")
_EXPERT = ("w1", "w2", "w3")


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


def _in_rows(t: torch.Tensor, r: int, n: int) -> torch.Tensor:
    c = t.shape[-2] // n
    return t[..., r * c:(r + 1) * c, :].contiguous()


def _experts(t: torch.Tensor, e: int, n: int) -> torch.Tensor:
    """Expert shard e of n of an [L, E, ...] stack."""
    c = t.shape[1] // n
    return t[:, e * c:(e + 1) * c]


def _shards(w, mesh: Mesh, fn, memo: dict | None = None, key=None,
            by_ep: bool = False) -> list:
    """``fn(plane, tp coordinate, ep coordinate)`` of each held rank, on its
    device; ranks on one device with the same tp (and, ``by_ep``, ep)
    coordinate share one tensor (``memo``, keyed by ``key``)."""
    memo = {} if memo is None else memo
    out = []
    for r, dev in _ranks(mesh):
        c = mesh.coords(r)
        k = (key, c["tp"], c["ep"] if by_ep else 0, str(dev))
        if key is None or k not in memo:
            shard = _map(w, lambda t: fn(t, c["tp"], c["ep"]).to(dev))
            if key is None:
                out.append(shard)
                continue
            memo[k] = shard
        out.append(memo[k])
    return out


def row_shards(w, mesh: Mesh, memo=None, key=None) -> list:
    """A row-sliced weight (or bias) split on d_out: each rank's tp slice on
    its device."""
    return _shards(w, mesh, lambda t, r, _: _out_slice(t, r, mesh.tp).contiguous(), memo, key)


def in_shards(w, mesh: Mesh, memo=None, key=None) -> list:
    """A weight split on d_in (its input rows): each rank's tp slice on its
    device."""
    return _shards(w, mesh, lambda t, r, _: _in_rows(t, r, mesh.tp), memo, key)


def col_shards(w, mesh: Mesh, memo=None, key=None) -> list:
    """A col-sliced weight split on d_in: each rank's column-chunk stack on
    its device."""
    return _shards(w, mesh, lambda t, r, _: _col_chunks(t, r, mesh.tp), memo, key)


def expert_shards(w, mesh: Mesh, rows: bool, memo=None, key=None) -> list:
    """An MoE stack [L, E, d_in, d_out]: each rank's E/ep experts, split on
    d_out (``rows`` False: w1, w3) or on d_in (``rows``: w2) by tp."""
    ep, tp = mesh.shape["ep"], mesh.tp
    if rows:
        return _shards(w, mesh, lambda t, r, e: _in_rows(_experts(t, e, ep), r, tp), memo, key,
                       by_ep=True)
    return _shards(w, mesh, lambda t, r, e: _out_slice(_experts(t, e, ep), r, tp).contiguous(),
                   memo, key, by_ep=True)


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
    memo: dict = {}
    moe = lp.moe_gate is not None
    split = {}
    for key in _ROW_SLICED + _COL_SLICED:
        w = getattr(lp, key)
        if moe and key in _EXPERT:
            split[key] = expert_shards(w, mesh, key == "w2", memo, key)
        else:
            split[key] = (row_shards if key in _ROW_SLICED else col_shards)(w, mesh, memo, key)
    wcls = row_shards(params.wcls, mesh, memo, "wcls")

    def rep(name: str, t: torch.Tensor, dev) -> torch.Tensor:
        return memo.setdefault((name, str(dev)), t.to(dev))

    return [LlamaParams(
        embedding=rep("embedding", params.embedding, dev),
        layers=LlamaLayerParams(**{k: v[i] for k, v in split.items()},
                                rms_att=rep("rms_att", lp.rms_att, dev),
                                rms_ffn=rep("rms_ffn", lp.rms_ffn, dev),
                                moe_gate=rep("moe_gate", lp.moe_gate, dev) if moe else None),
        rms_final=rep("rms_final", params.rms_final, dev),
        wcls=wcls[i],
        rope_cos=rep("rope_cos", params.rope_cos, dev),
        rope_sin=rep("rope_sin", params.rope_sin, dev),
    ) for i, dev in enumerate(mesh.devices)]


def shard_kv_cache(cache: KVCache, mesh: Mesh) -> list:
    """Rank (d, t, s)'s share of a [L, B, S + 1, n_kv, hd] cache (slot S the
    scratch slot): lanes d*B/dp .. (d+1)*B/dp, slots s*S/sp .. (s+1)*S/sp
    and a scratch slot of its own, kv heads t*n_kv/tp .. (t+1)*n_kv/tp, on
    its device: [L, B/dp, S/sp + 1, n_kv/tp, hd]."""
    n_lanes, s_len = cache.k.shape[1], cache.k.shape[2] - 1
    dp = mesh.shape["dp"]
    if n_lanes % dp:
        raise ValueError(f"{n_lanes} lanes do not split over dp={dp}: each dp group holds "
                         "the same number of lanes")
    bl, blk = n_lanes // dp, s_len // mesh.shape["sp"]
    h = cache.k.shape[3] // mesh.tp
    out = []
    for r, dev in _ranks(mesh):
        c = mesh.coords(r)
        d, s, t = c["dp"], c["sp"], c["tp"]

        def part(x):
            x = x[:, d * bl:(d + 1) * bl, :, t * h:(t + 1) * h]
            if mesh.shape["sp"] > 1:
                x = torch.cat([x[:, :, s * blk:(s + 1) * blk], x[:, :, s_len:]], dim=2)
            return x.contiguous().to(dev)

        out.append(KVCache(k=part(cache.k), v=part(cache.v)))
    return out


def shard_paged_kv_cache(cache: PagedKVCache, mesh: Mesh) -> list:
    """Rank r's share of a paged pool [L, P, page, n_kv, hd]: kv heads
    t*n_kv/tp .. (t+1)*n_kv/tp by its tp coordinate t, on rank r's device.
    The page table is the same for every rank: ranks on one device share
    one table tensor (read only inside a step; the engine rewrites it
    between steps), others hold a copy on their own device."""
    n = mesh.tp
    h = cache.k.shape[3] // n
    tables: dict = {}
    out = []
    for r, dev in _ranks(mesh):
        t = mesh.coords(r)["tp"]
        if dev not in tables:
            tables[dev] = cache.table.to(dev, copy=True)
        out.append(PagedKVCache(k=cache.k[:, :, :, t * h:(t + 1) * h].contiguous().to(dev),
                                v=cache.v[:, :, :, t * h:(t + 1) * h].contiguous().to(dev),
                                table=tables[dev]))
    return out
