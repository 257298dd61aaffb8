"""Llama forward pass over a contiguous per-lane or a paged KV cache, in
PyTorch.

Layer math (the JAX package's ``llama_forward``):
    x += attn(rms_norm(x)) ; x += ffn(rms_norm(x))
with GQA attention over a pre-allocated per-lane KV cache, interleaved RoPE
and a SiLU/GELU gated FFN. Reductions and attention run in float32;
matmuls run in the params' dtype (bf16 on the card) with f32 accumulation;
packed Q40 weights go through the dequant-in-matmul kernels (ops/linear.py).

The layers run as a plain Python loop. The KV cache is updated in place
(the JAX version returns a new cache): it holds ``seq_len + 1`` slots per
lane, the last one a scratch slot that takes the writes the JAX scatter
drops (positions at or past ``seq_len``: idle lanes parked there, padded
prefill tails near the end of the context; a forward of several rows a lane
writes zeros there). Attention never reads it for a real query, whose mask
is s <= pos < seq_len. An e4m3 cache (``--kv-dtype f8``) takes each write
through ``_to_cache_dtype`` (clipped at +-448, then cast) and is widened to
f32 where attention reads it.

The paged layout (``PagedKVCache``, the JAX package's): one pool of
fixed-size pages shared by every lane and a per-lane page table (block i of
lane b in page ``table[b, i]``). The pool holds one page more than the
table addresses, the scratch page at index ``n_pages``: the JAX sentinel
``n_pages`` marks an unmapped block and indexes it directly, so writes
through an unmapped entry or at a position at or past seq_len land there
(with T > 1, as zeros, as on the contiguous layout). Attention reads each
lane's slots through the table: the attention kernel in place for decode
and verify rows, a gather of the lane's view into the dense attention for
a prompt chunk. A lane's results equal the contiguous layout's on the same
slot contents, bit for bit.

Mixture-of-experts models (``config.n_experts`` > 0, the JAX package's
Mixtral family): each layer's FFN is E gated experts behind a router
(``moe_gate``), the top k of them mixed by the softmax of their logits. The
router runs as one kernel a layer (``ops/cuda_moe.moe_route``); the experts
take the JAX package's dispatch (``_moe_ffn``).

A mesh (``mesh``, parallel/mesh.py: dp, tp, sp and ep axes): one process
drives its ranks, every rank as the JAX package's single controller does,
or in a pod (parallel/multihost.py, tp only) the block of ranks it holds.
Each layer runs rank by rank on local shards (head-sharded attention,
row-sliced wq/wk/wv/w1/w3), the replicated parts (embedding, norms, RoPE,
the router) on every rank; the wo/w2 outputs sync within each tp group
through the ring collectives (ops/ring_collective.py, across processes
through the pod's windows), an MoE layer's routed partials through one f32
ring all-reduce over each ep x tp group, and the logits shards gather over
each tp group. Per axis:

- dp: the lanes split over the dp groups, each group running its own rows
  (a lane-addressed call, ``dp_group``, runs that lane's group alone);
- sp: each sp rank holds one block of every lane's slots and its own
  scratch slot; it writes only the positions in its block (the others go
  to its scratch slot, as the JAX scatter drops them) and attends through
  its block's flash stats, combined over the sp group
  (parallel/ring_attention.py);
- ep: each rank holds E/ep experts and runs the per-expert loop over them
  at every T, with the router weights' columns for those experts (the JAX
  package's ``_moe_ffn_ep_packed``).

The caller gets the dp groups' logits rows assembled on this process's
first rank's device: in a pod each process holds the whole logits, so the
sampler, the grammar mask and the pipelined carry run identically in every
process (the JAX package's replicated outputs).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..formats.model_file import HiddenAct
from ..ops.activations import gelu, silu
from ..ops.cuda_attn import (
    WINDOW,
    block_stats,
    decode_attention,
    decode_attention_paged,
    decode_attention_stats,
    dense_attention,
    paged_gather_index,
    paged_view,
)
from ..ops.cuda_moe import moe_route
from ..ops.linear import matmul, shared_q80_acts
from ..ops.norm import rms_norm
from ..ops.ring_collective import (
    chunk_d_out,
    held,
    local_matmul,
    over_groups,
    per_rank,
    ring_all_gather,
    ring_all_reduce,
    ring_sync_engages,
    ring_sync_matmul,
    ring_sync_supported,
)
from ..ops.rope import apply_rope
from ..quants.packed import PackedQ40, unpack_q40
from ..parallel.collectives import q80_sync_engages, q80_sync_matmul
from ..parallel.ring_attention import sp_attention
from ..quants.torch_codec import qdq_q80
from .config import LlamaConfig

_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "rms_att", "rms_ffn")


@dataclass
class LlamaLayerParams:
    """Per-layer weights stacked along a leading [n_layers] axis. Matmul
    weights are [L, d_in, d_out] (y = x @ W) dense tensors or PackedQ40
    planes ([L, d_in/2, d_out] + [L, d_in/32, d_out]). A tensor-parallel
    rank's wo/w2 are column-chunk stacks [L, tp, d_in/tp, d_out/tp]
    (parallel/sharding.py).

    MoE models: w1/w2/w3 gain an expert axis after the layer's, [L, E, d_in,
    d_out] (packed: [L, E, d_in/2, d_out] nibbles and [L, E, d_in/32, d_out]
    scales), and ``moe_gate`` holds the router [L, dim, E] f32; expert e of
    layer l is ``layer(l).w1[e]``. A rank's MoE w2 is its input-row slice
    [L, E, hidden/tp, dim], no column-chunk stack."""

    wq: object  # [L, dim, dim]
    wk: object  # [L, dim, kv_dim]
    wv: object  # [L, dim, kv_dim]
    wo: object  # [L, dim, dim]
    w1: object  # [L, dim, hidden]  gate  (MoE: [L, E, dim, hidden])
    w2: object  # [L, hidden, dim]  down  (MoE: [L, E, hidden, dim])
    w3: object  # [L, dim, hidden]  up    (MoE: [L, E, dim, hidden])
    rms_att: torch.Tensor  # [L, dim] f32
    rms_ffn: torch.Tensor  # [L, dim] f32
    moe_gate: torch.Tensor | None = None  # [L, dim, E] f32 router; None for dense models
    # Qwen2-family q/k/v biases; None for the Llama family
    bq: torch.Tensor | None = None  # [L, dim]
    bk: torch.Tensor | None = None  # [L, kv_dim]
    bv: torch.Tensor | None = None  # [L, kv_dim]

    def layer(self, l: int) -> "LlamaLayerParams":
        """Layer l's weights (views, no copies)."""
        return LlamaLayerParams(**{
            f.name: (None if getattr(self, f.name) is None else getattr(self, f.name)[l])
            for f in fields(self)
        })


@dataclass
class LlamaParams:
    embedding: torch.Tensor  # [vocab, dim]
    layers: LlamaLayerParams
    rms_final: torch.Tensor  # [dim] f32
    wcls: object  # [dim, vocab] dense or PackedQ40
    rope_cos: torch.Tensor  # [seq_len, head_size//2] f32
    rope_sin: torch.Tensor  # [seq_len, head_size//2] f32

    @property
    def device(self) -> torch.device:
        return self.embedding.device


@dataclass
class KVCache:
    k: torch.Tensor  # [L, B, seq_len + 1, n_kv_heads, head_size]
    v: torch.Tensor

    def lane(self, lane: int) -> "KVCache":
        """One lane's cache as a batch-of-1 view: writes land in this cache."""
        return KVCache(k=self.k[:, lane:lane + 1], v=self.v[:, lane:lane + 1])


@dataclass
class PagedKVCache:
    """The paged layout: pool planes [L, n_pages + 1, page, n_kv, hd] (page
    ``n_pages`` the scratch page) and the page table [B, blocks_per_lane]
    int32, whose ``n_pages`` entries are unmapped. Every layer's K/V of a
    token lie at the same (page, slot), so one table drives all layers."""

    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor

    @property
    def n_pages(self) -> int:
        return self.k.shape[1] - 1

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    def lane(self, lane: int) -> "PagedKVCache":
        """One lane as a batch of 1: the pool and that lane's table row."""
        return PagedKVCache(k=self.k, v=self.v, table=self.table[lane:lane + 1])


def init_paged_kv_cache(config: LlamaConfig, n_lanes: int, n_pages: int, page_size: int,
                        n_blocks: int | None = None, dtype=torch.float32,
                        device=DEFAULT_DEVICE) -> PagedKVCache:
    """A zero-filled pool (the scratch page included: a masked slot's V is
    weighted by 0 and must not be NaN) and all-unmapped tables. ``n_blocks``
    is the table width, the pool's ``blocks_per_lane`` (default: enough
    blocks for seq_len)."""
    device = resolve_device(device)
    if page_size < 1 or page_size & (page_size - 1):
        raise ValueError(f"page_size must be a power of two, got {page_size}")
    blocks = n_blocks if n_blocks is not None else -(-config.seq_len // page_size)
    shape = (config.n_layers, n_pages + 1, page_size, config.n_kv_heads, config.head_size)
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                        v=torch.zeros(shape, dtype=dtype, device=device),
                        table=torch.full((n_lanes, blocks), n_pages, dtype=torch.int32,
                                         device=device))


def init_kv_cache(config: LlamaConfig, n_lanes: int, dtype=torch.float32,
                  device=DEFAULT_DEVICE) -> KVCache:
    device = resolve_device(device)
    shape = (config.n_layers, n_lanes, config.seq_len + 1, config.n_kv_heads,
             config.head_size)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


F8 = torch.float8_e4m3fn  # --kv-dtype f8: the JAX package's float8_e4m3fn


def _to_cache_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Fresh K/V rows in the cache's storage dtype (the JAX package's
    ``_to_cache_dtype``). e4m3 has no inf: an outlier clips to +-448, the
    format's finite max, where a plain cast could give NaN. The clamp is
    explicit, as in JAX, so both packages and both devices agree by
    construction; the cast is straight from ``x``'s dtype."""
    if dtype == F8:
        lim = float(torch.finfo(F8).max)
        x = x.clamp(-lim, lim)
    return x.to(dtype)


def cache_bits(t: torch.Tensor) -> torch.Tensor:
    """An e4m3 plane as a uint8 view of the same storage (other dtypes as
    they are): indexed copies and scatters lack Float8 kernels on some
    backends, and moving the bits moves the values."""
    return t.view(torch.uint8) if t.dtype == F8 else t


def _maybe_bias(y: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    return y if b is None else y + b.to(y.dtype)


def _qdq(y: torch.Tensor) -> torch.Tensor:
    """The reference runtime's F32 -> Q80 activation casts, emulated
    (``--buffer-float-type q80``): runtime rounding, half away from zero."""
    return qdq_q80(y, mode="runtime")


# the JAX package's MOE_PACKED_SPARSE_MIN_TOKENS, gated on a call's rows a
# lane (T), as there: below it (decode, the verify window, decode_multi,
# the pipelined and fused steps' decode rows, short prompt chunks) packed
# experts take the per-expert loop, bound by every expert's packed bytes,
# which it reads once; at or above it (prompt chunks of 64 rows and more)
# each expert is dequantized once and multiplies only its own rows
MOE_PACKED_SPARSE_MIN_TOKENS = 32


def _moe_topk(y: torch.Tensor, moe_gate: torch.Tensor, n_active: int):
    """The router's top k (weights [B, T, k] f32, softmax over the k chosen
    logits; expert ids [B, T, k] int32), from the unquantized normed rows."""
    b, t, d = y.shape
    topw, topi, _ = moe_route(y.reshape(b * t, d), moe_gate, n_active)
    return topw.view(b, t, -1), topi.view(b, t, -1)


def _moe_router_weights(y: torch.Tensor, moe_gate: torch.Tensor, n_active: int):
    """Dense routing weights [B, T, E]: the top-k weights over the expert
    axis, zero for the experts not chosen."""
    b, t, d = y.shape
    return moe_route(y.reshape(b * t, d), moe_gate, n_active)[2].view(b, t, -1)


def _n_experts(w) -> int:
    return (w.packed if isinstance(w, PackedQ40) else w).shape[0]


def _expert(w, e: int, dtype: torch.dtype) -> torch.Tensor:
    """Expert e's dense [d_in, d_out] weight in ``dtype``: a packed stack is
    dequantized one expert at a time (the values of the whole stack's
    ``unpack_q40``), never as a whole stack."""
    return unpack_q40(w[e], dtype) if isinstance(w, PackedQ40) else w[e].to(dtype)


def _moe_ffn_sparse(yq, topw, topi, w1, w2, w3, act_fn, maybe_qdq) -> torch.Tensor:
    """The exact top-k dispatch: the B*T*k (token, expert) assignments
    stably sorted by expert, each expert multiplying its own rows, the
    contributions added back in token order, expert by expert in ascending
    order (the JAX scatter-add's order). Reads the group sizes on the host,
    so it runs outside a captured step only."""
    b, t, d = yq.shape
    k = topi.shape[-1]
    n = b * t
    x_flat = yq.reshape(n, d)
    expert_flat = topi.reshape(n * k).to(torch.int64)
    token_flat = torch.arange(n, device=yq.device).repeat_interleave(k)
    weight_flat = topw.reshape(n * k)
    order = torch.sort(expert_flat, stable=True).indices
    sizes = torch.bincount(expert_flat, minlength=_n_experts(w1)).tolist()
    out = torch.zeros((n, d), dtype=yq.dtype, device=yq.device)
    start = 0
    for e, size in enumerate(sizes):
        if size == 0:
            continue
        rows = order[start:start + size]
        start += size
        tok = token_flat[rows]  # distinct within a group: no add collides
        xs = x_flat[tok]
        g = act_fn(torch.matmul(xs, _expert(w1, e, xs.dtype)))
        u = torch.matmul(xs, _expert(w3, e, xs.dtype))
        ds = torch.matmul(maybe_qdq(g * u), _expert(w2, e, xs.dtype))
        out.index_add_(0, tok, ds * weight_flat[rows][:, None].to(ds.dtype))
    return out.view(b, t, d)


def _moe_ffn_loop(y, yq, lp: LlamaLayerParams, act_fn, n_active: int, maybe_qdq,
                  first: int = 0):
    """Every expert on every row, mixed by the dense routing weights (zero
    for the experts a row did not choose): the JAX package's static
    per-expert loop. No host read and no data-dependent shape, so a
    captured step holds it. ``first``: the global index of the stack's
    expert 0 (an ep rank's E/ep experts read their own router columns)."""
    rw = _moe_router_weights(y, lp.moe_gate, n_active)
    # the w1/w3 operand is a function of yq alone: one build feeds all 2E
    # of the layer's w1/w3 products (JAX builds it for each)
    ys = shared_q80_acts(yq) if isinstance(lp.w1, PackedQ40) else yq
    out = None
    for e in range(_n_experts(lp.w1)):
        g = act_fn(matmul(ys, lp.w1[e]))
        u = matmul(ys, lp.w3[e])
        d = matmul(maybe_qdq(g * u), lp.w2[e])
        term = d * rw[..., first + e:first + e + 1].to(d.dtype)
        out = term if out is None else out + term
    return out


def _moe_ffn(y, yq, lp: LlamaLayerParams, act_fn, n_active: int, maybe_qdq) -> torch.Tensor:
    """The gated-FFN mixture of one rank, with the JAX package's dispatch
    (its ``_moe_ffn`` on one shard):

    - packed experts and T < MOE_PACKED_SPARSE_MIN_TOKENS: the per-expert
      loop on the packed planes (``_moe_ffn_loop``);
    - packed experts and T at or above it: one expert dequantized at a
      time, the sparse dispatch (``_moe_ffn_sparse``);
    - dense experts: the sparse dispatch, except on the card below the
      threshold, where a step may be captured into a CUDA graph and cannot
      read the group sizes back: there the loop, the same mixture (the
      experts a row did not choose weigh exactly 0).

    The router reads the unquantized normed ``y``, the experts ``yq``. On a
    mesh the result is the rank's partial over its hidden slice."""
    packed = isinstance(lp.w1, PackedQ40)
    if y.shape[1] < MOE_PACKED_SPARSE_MIN_TOKENS and (packed or y.device.type == "cuda"):
        return _moe_ffn_loop(y, yq, lp, act_fn, n_active, maybe_qdq)
    topw, topi = _moe_topk(y, lp.moe_gate, n_active)
    return _moe_ffn_sparse(yq, topw, topi, lp.w1, lp.w2, lp.w3, act_fn, maybe_qdq)


def llama_forward(
    config: LlamaConfig,
    params,
    tokens: torch.Tensor,  # [B, T] int64
    positions: torch.Tensor,  # [B, T] int64, per-lane positions
    cache,
    attn_len: int | None = None,
    logit_rows: torch.Tensor | None = None,
    emulate_q80_activations: bool = False,
    mesh=None,
    q80_sync: bool = False,
    ring_sync: bool = True,
    dp_group: int | None = None,
):
    """Returns (logits [B, T', vocab] float32, cache), for prefill (T > 1)
    and decode (T = 1) alike; ``cache`` is updated in place.

    ``attn_len`` (optional) bounds the cache slots attention reads to the
    first ``attn_len``: every real query position must be below it. The
    slots past it are masked out in any case, so the result is the same
    up to f32 summation order; a prompt chunk passes it and attends through
    the dense f32 attention. A decode step (T = 1) and, without it, a
    forward of at most ``ops.cuda_attn.WINDOW`` rows per lane (the
    speculative verify window) attend through
    ``ops.cuda_attn.decode_attention``: on the card a kernel that reads each
    lane's own slots only, in an order each row's position fixes.
    ``logit_rows`` (optional) selects the T positions whose logits are
    computed (T' = len(logit_rows)); None computes all T.

    ``cache`` may be a ``PagedKVCache`` (per rank on a mesh): the KV append
    goes through the table to (page, slot), and attention reads through it.

    ``emulate_q80_activations``: Q80 quantize-dequantize at the reference's
    activation casts (before wq/wk/wv, wo, w1/w3, w2 and wcls, and on the
    wo/w2 outputs unless the Q80 wire quantizes them; on an MoE layer's
    output after its all-reduce).

    ``mesh`` (parallel/mesh.Mesh): ``params`` and ``cache`` are the per-rank
    lists of parallel/sharding.py (this process's ranks in a pod); the B
    rows split over the dp groups in order, or with ``dp_group`` all B rows
    are lanes of that dp group, which runs alone (the other groups' cache
    entries may be None); the logits come back on this process's first
    rank's device. On a pure-TP mesh the wo/w2 outputs sync through the ring
    (``ring_sync``, the default) with the f32 wire, or the Q80 wire when
    ``q80_sync`` engages (parallel/collectives.q80_sync_engages); with
    ``ring_sync`` off, through ``q80_sync_matmul`` when q80 engages, else a
    ring all-reduce of the local partials, which is also every dp, sp or ep
    mesh's sync, within each tp group."""
    b, t = tokens.shape
    cfg = config
    # per-rank lists over every global rank, None where another process of
    # a pod holds it, or where its dp group does not run
    n_all = 1 if mesh is None else mesh.n_ranks
    ranks, caches = [None] * n_all, [None] * n_all
    for i, r in enumerate([0] if mesh is None else mesh.local_ranks):
        ranks[r] = params if mesh is None else params[i]
        caches[r] = cache if mesh is None else cache[i]
    shape = dict.fromkeys(("dp", "tp", "sp", "ep"), 1) if mesh is None else mesh.shape
    coords = [mesh.coords(r) if mesh is not None else dict.fromkeys(shape, 0)
              for r in range(n_all)]
    groups = ({k: [[0]] for k in ("tp", "sp", "ep_tp")} if mesh is None else
              {"tp": mesh.tp_groups(), "sp": mesh.sp_groups(), "ep_tp": mesh.ep_tp_groups()})
    active = list(range(shape["dp"])) if dp_group is None else [dp_group]
    if b % len(active):
        raise ValueError(f"{b} rows do not split over {len(active)} dp groups")
    b //= len(active)  # rows a rank runs
    row0 = {d: i * b for i, d in enumerate(active)}
    for r in range(n_all):
        if coords[r]["dp"] not in row0:
            ranks[r] = caches[r] = None
    first = held(ranks)[0]
    n = shape["tp"]
    n_heads, n_kv, hd = cfg.n_heads // n, cfg.n_kv_heads // n, cfg.head_size
    eps = cfg.norm_epsilon
    act_fn = silu if cfg.hidden_act == HiddenAct.SILU else gelu
    s_len = cfg.seq_len if attn_len is None else max(1, min(cfg.seq_len, attn_len))
    maybe_qdq = _qdq if emulate_q80_activations else (lambda y: y)

    use_q80_sync = use_ring_sync = False
    if mesh is not None:
        if emulate_q80_activations and (cfg.dim // n % 32 or cfg.hidden_dim // n % 32):
            raise ValueError("Q80 activation emulation on a mesh needs whole 32-value "
                             f"blocks per rank (dim {cfg.dim}, hidden {cfg.hidden_dim}, "
                             f"tp {n})")
        # the predicates the startup log reads too (pure TP only)
        use_q80_sync = q80_sync and q80_sync_engages(cfg, mesh.shape)
        use_ring_sync = ring_sync_engages(cfg, mesh.shape, ring_sync)
    # sp: each rank's block of slots; ep: each rank's first expert
    blk = cfg.seq_len // shape["sp"]
    s0 = [c["sp"] * blk for c in coords]
    ep_first = [c["ep"] * (cfg.n_experts // shape["ep"]) for c in coords]

    def synced_matmul(ys: list, ws: list) -> list:
        """A row-parallel (col-sliced) wo/w2 product and its TP sync."""
        if mesh is None:
            return [maybe_qdq(matmul(ys[0], ws[0]))]
        if use_ring_sync and ring_sync_supported(chunk_d_out(held(ws)[0]), n, use_q80_sync):
            out = ring_sync_matmul(ys, ws, q80_wire=use_q80_sync)
            # the Q80 wire quantizes on the wire; the f32 wire keeps the
            # output-side cast
            return out if use_q80_sync else per_rank(maybe_qdq, out)
        if use_q80_sync:
            return q80_sync_matmul(ys, ws)
        return per_rank(maybe_qdq, over_groups(ring_all_reduce, per_rank(local_matmul, ys, ws),
                                               groups["tp"]))

    def each(fn) -> list:
        """``fn(r)`` for each held rank r, None for the others."""
        return [None if ranks[r] is None else fn(r) for r in range(n_all)]

    # packed weights: one activation-operand build feeds wq/wk/wv, one w1/w3
    share = isinstance(first.layers.wq, PackedQ40)
    share_q80 = shared_q80_acts if share else (lambda y: y)
    group = n_heads // n_kv
    scale = 1.0 / float(hd) ** 0.5

    # per rank: its dp group's tokens, positions and masks on its own device
    devs = each(lambda r: ranks[r].device)
    rows = each(lambda r: slice(row0[coords[r]["dp"]], row0[coords[r]["dp"]] + b))
    poss = each(lambda r: positions[rows[r]].to(devs[r]))
    xs = each(lambda r: ranks[r].embedding[tokens[rows[r]].to(devs[r])])  # [B, T, dim]
    paged = isinstance(held(caches)[0], PagedKVCache)
    use_sp = shape["sp"] > 1
    if use_sp and paged:
        raise ValueError("the paged KV cache does not shard over sp (use --paged-kv off)")
    if paged:
        # the table is the same for every layer: the write targets and
        # the prompt chunk's gather index are computed once a call. A
        # sentinel entry or a position at or past seq_len writes the
        # scratch page (the JAX scatter drops such writes)
        page, n_pages = held(caches)[0].page_size, held(caches)[0].n_pages
        tables = each(lambda r: caches[r].table)

        def write_page(r):
            blk = (poss[r] // page).clamp(0, tables[r].shape[1] - 1)
            pg = torch.gather(tables[r].to(torch.int64), 1, blk)
            return torch.where(poss[r] < cfg.seq_len, pg, n_pages)

        w_page = each(write_page)
        w_idx = each(lambda r: (w_page[r], poss[r] % page))
        unmapped = each(lambda r: w_page[r] == n_pages)
    elif not use_sp:
        # writes at or past seq_len land in the scratch slot (the JAX
        # scatter drops them)
        w_idx = each(lambda r: (torch.arange(b, device=devs[r])[:, None].expand(b, t),
                                poss[r].clamp(0, cfg.seq_len)))
        unmapped = each(lambda r: poss[r] >= cfg.seq_len)
    else:
        # an sp rank's writes outside its block (another rank holds them)
        # land in its scratch slot, the block's last, at blk
        inb = each(lambda r: (poss[r] >= s0[r]) & (poss[r] < s0[r] + blk))
        w_idx = each(lambda r: (torch.arange(b, device=devs[r])[:, None].expand(b, t),
                                torch.where(inb[r], poss[r] - s0[r], blk)))
        unmapped = each(lambda r: ~inb[r])
    # with T > 1 several rows of a lane may land in the scratch slot or
    # page, and a scatter leaves any one of them, so they all write zeros:
    # the cache stays a function of the inputs
    dropped = None if t == 1 else each(lambda r: unmapped[r][:, :, None, None])
    # a decode step or a verify window runs the attention kernel, which masks
    # each row by its position; a prompt chunk the dense attention
    windowed = t == 1 or (attn_len is None and t <= WINDOW)
    masks = None if windowed or use_sp else each(
        lambda r: torch.arange(s_len, device=devs[r])[None, None, :] <= poss[r][:, :, None])
    # a prompt chunk over the paged layout gathers each lane's [S] view
    gather = each(lambda r: paged_gather_index(tables[r], page, s_len)) \
        if paged and not windowed else None

    def block_attention(r: int, qf, k_cache, v_cache):
        """An sp rank's flash stats over its block's first slots that
        attention may read (those below ``s_len``)."""
        n_loc = max(0, min(blk, s_len - s0[r]))
        local = poss[r] - s0[r]
        if n_loc == 0:  # the whole block lies past the attention length
            stat = torch.zeros(qf.shape[:4], dtype=torch.float32, device=qf.device)
            return torch.zeros_like(qf), stat, torch.full_like(stat, float("-inf"))
        if windowed:
            return decode_attention_stats(qf, k_cache, v_cache, local, scale, n_loc)
        mask = torch.arange(n_loc, device=devs[r])[None, None, :] <= local[:, :, None]
        return block_stats(qf, k_cache[:, :n_loc].to(torch.float32),
                           v_cache[:, :n_loc].to(torch.float32), mask, scale)

    def attention(r: int, lp: LlamaLayerParams, l: int):
        """Rank r's q/k/v, its cache writes and its attention output [B, T,
        n_kv, G, hd] f32 (an sp rank: its block's flash stats)."""
        x, pos, p = xs[r], poss[r], ranks[r]
        # contiguous [B, S+1, n_kv, hd]; paged [n_pages+1, page, n_kv, hd]
        k_cache, v_cache = caches[r].k[l], caches[r].v[l]
        y = rms_norm(x, lp.rms_att, eps)
        yq = share_q80(maybe_qdq(y))
        q = _maybe_bias(matmul(yq, lp.wq), lp.bq).reshape(b, t, n_heads, hd)
        k = _maybe_bias(matmul(yq, lp.wk), lp.bk).reshape(b, t, n_kv, hd)
        v = _maybe_bias(matmul(yq, lp.wv), lp.bv).reshape(b, t, n_kv, hd)

        q = apply_rope(q, p.rope_cos, p.rope_sin, pos)
        k = apply_rope(k, p.rope_cos, p.rope_sin, pos)

        if dropped is not None:
            k, v = (torch.where(dropped[r], 0.0, x) for x in (k, v))
        cache_bits(k_cache)[w_idx[r]] = cache_bits(_to_cache_dtype(k, k_cache.dtype))
        cache_bits(v_cache)[w_idx[r]] = cache_bits(_to_cache_dtype(v, v_cache.dtype))

        qf = q.to(torch.float32).reshape(b, t, n_kv, group, hd)
        if use_sp:
            return block_attention(r, qf, k_cache, v_cache)
        if windowed and paged:
            attn = decode_attention_paged(qf, k_cache, v_cache, tables[r], pos, scale, s_len)
        elif windowed:
            attn = decode_attention(qf, k_cache, v_cache, pos, scale, s_len)
        elif paged:
            attn = dense_attention(
                qf, paged_view(k_cache, gather[r]).to(torch.float32),
                paged_view(v_cache, gather[r]).to(torch.float32), masks[r], scale,
            )
        else:
            attn = dense_attention(
                qf, k_cache[:, :s_len].to(torch.float32),
                v_cache[:, :s_len].to(torch.float32), masks[r], scale,
            )
        return attn

    def ffn_in(r: int, lp: LlamaLayerParams) -> torch.Tensor:
        yqs = share_q80(maybe_qdq(rms_norm(xs[r], lp.rms_ffn, eps)))
        g = act_fn(matmul(yqs, lp.w1))
        u = matmul(yqs, lp.w3)
        return maybe_qdq(g * u)

    def moe(r: int, lp: LlamaLayerParams) -> torch.Tensor:
        y = rms_norm(xs[r], lp.rms_ffn, eps)
        if shape["ep"] > 1:
            # the JAX ep branch at every T: the loop over this rank's experts
            return _moe_ffn_loop(y, maybe_qdq(y), lp, act_fn, cfg.n_active_experts, maybe_qdq,
                                 first=ep_first[r])
        return _moe_ffn(y, maybe_qdq(y), lp, act_fn, cfg.n_active_experts, maybe_qdq)

    def attn_out(r: int, attn) -> torch.Tensor:
        return maybe_qdq(attn[r].reshape(b, t, n_heads * hd).to(xs[r].dtype))

    add = lambda x, o: x + o  # noqa: E731
    for l in range(cfg.n_layers):
        lps = each(lambda r: ranks[r].layers.layer(l))
        attn = each(lambda r: attention(r, lps[r], l))
        if use_sp:
            attn = sp_attention(attn, groups["sp"])
        attn = each(lambda r: attn_out(r, attn))
        xs = per_rank(add, xs, synced_matmul(attn, per_rank(lambda lp: lp.wo, lps)))
        if cfg.n_experts > 0:
            ds = each(lambda r: moe(r, lps[r]))
            if mesh is not None:
                # the routed partials over each rank's hidden slice (and its
                # experts) meet in one f32 ring all-reduce over the ep x tp
                # group (never the Q80 wire: the JAX package's MoE output is
                # a psum)
                ds = over_groups(ring_all_reduce, per_rank(lambda d: d.to(torch.float32), ds),
                                 groups["ep_tp"])
            xs = per_rank(lambda x, d: x + maybe_qdq(d).to(x.dtype), xs, ds)
        else:
            hs = each(lambda r: ffn_in(r, lps[r]))
            xs = per_rank(add, xs, synced_matmul(hs, per_rank(lambda lp: lp.w2, lps)))

    def head(r: int) -> torch.Tensor:
        x = xs[r] if logit_rows is None else xs[r][:, logit_rows.to(devs[r])]
        y = maybe_qdq(rms_norm(x, ranks[r].rms_final, eps))
        return matmul(y, ranks[r].wcls).to(torch.float32)

    if mesh is None:
        out = head(0)
    else:
        # each dp group's first tp group (sp and ep coordinates 0: the
        # others hold the same activations) computes its [B, T', vocab/tp]
        # shards, gathered over the group; the dp groups' rows, in order, on
        # this process's first rank's device (the engine's, whichever dp
        # group ran)
        logits = each(lambda r: head(r) if coords[r]["sp"] == coords[r]["ep"] == 0 else None)
        gathered = over_groups(ring_all_gather, logits, groups["tp"])
        dev = mesh.devices[0]
        parts = []
        for d in active:
            g = next(g for g in groups["tp"] if coords[g[0]]["dp"] == d
                     and coords[g[0]]["sp"] == coords[g[0]]["ep"] == 0)
            parts.append(held([gathered[r] for r in g])[0].to(dev))
        out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
    # a packed wcls may be padded past the vocabulary (quantize_params)
    return out[..., : cfg.vocab_size].contiguous(), cache
