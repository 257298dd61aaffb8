"""Llama forward pass over a contiguous per-lane KV cache, in PyTorch.

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
is s <= pos < seq_len.

Tensor parallelism (``mesh``): one process drives every rank, as the JAX
package's single controller does. Each layer runs rank by rank on local
shards (head-sharded attention, row-sliced wq/wk/wv/w1/w3), the replicated
parts (embedding, norms, RoPE) on every rank; the wo/w2 outputs sync through
the ring collectives (ops/ring_collective.py), and the logits shards gather
onto rank 0.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..formats.model_file import HiddenAct
from ..ops.activations import gelu, silu
from ..ops.cuda_attn import WINDOW, decode_attention, dense_attention
from ..ops.linear import matmul, shared_q80_acts
from ..ops.norm import rms_norm
from ..ops.ring_collective import (
    chunk_d_out,
    local_matmul,
    ring_all_gather,
    ring_all_reduce,
    ring_sync_engages,
    ring_sync_matmul,
    ring_sync_supported,
)
from ..ops.rope import apply_rope
from ..quants.packed import PackedQ40
from ..parallel.collectives import q80_sync_engages, q80_sync_matmul
from ..quants.torch_codec import qdq_q80
from .config import LlamaConfig

_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "rms_att", "rms_ffn")


@dataclass
class LlamaLayerParams:
    """Per-layer weights stacked along a leading [n_layers] axis. Matmul
    weights are [L, d_in, d_out] (y = x @ W) dense tensors or PackedQ40
    planes ([L, d_in/2, d_out] + [L, d_in/32, d_out]). A tensor-parallel
    rank's wo/w2 are column-chunk stacks [L, tp, d_in/tp, d_out/tp]
    (parallel/sharding.py)."""

    wq: object  # [L, dim, dim]
    wk: object  # [L, dim, kv_dim]
    wv: object  # [L, dim, kv_dim]
    wo: object  # [L, dim, dim]
    w1: object  # [L, dim, hidden]  gate
    w2: object  # [L, hidden, dim]  down
    w3: object  # [L, dim, hidden]  up
    rms_att: torch.Tensor  # [L, dim] f32
    rms_ffn: torch.Tensor  # [L, dim] f32
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


def init_kv_cache(config: LlamaConfig, n_lanes: int, dtype=torch.float32,
                  device=DEFAULT_DEVICE) -> KVCache:
    device = resolve_device(device)
    shape = (config.n_layers, n_lanes, config.seq_len + 1, config.n_kv_heads,
             config.head_size)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _maybe_bias(y: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    return y if b is None else y + b.to(y.dtype)


def _qdq(y: torch.Tensor) -> torch.Tensor:
    """The reference runtime's F32 -> Q80 activation casts, emulated
    (``--buffer-float-type q80``): runtime rounding, half away from zero."""
    return qdq_q80(y, mode="runtime")


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

    ``emulate_q80_activations``: Q80 quantize-dequantize at the reference's
    activation casts (before wq/wk/wv, wo, w1/w3, w2 and wcls, and on the
    wo/w2 outputs unless the Q80 wire quantizes them).

    ``mesh`` (parallel/mesh.Mesh, pure TP): ``params`` and ``cache`` are the
    per-rank lists of parallel/sharding.py; the logits come back on rank 0's
    device. The wo/w2 outputs sync through the ring (``ring_sync``, the
    default) with the f32 wire, or the Q80 wire when ``q80_sync`` engages
    (parallel/collectives.q80_sync_engages); with ``ring_sync`` off, through
    ``q80_sync_matmul`` when q80 engages, else a ring all-reduce of the
    local partials."""
    b, t = tokens.shape
    cfg = config
    ranks = [params] if mesh is None else list(params)
    caches = [cache] if mesh is None else list(cache)
    n = len(ranks)
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
        # the predicates the startup log reads too
        use_q80_sync = q80_sync and q80_sync_engages(cfg, mesh.shape)
        use_ring_sync = ring_sync_engages(cfg, mesh.shape, ring_sync)

    def synced_matmul(ys: list, ws: list) -> list:
        """A row-parallel (col-sliced) wo/w2 product and its TP sync."""
        if mesh is None:
            return [maybe_qdq(matmul(ys[0], ws[0]))]
        if use_ring_sync and ring_sync_supported(chunk_d_out(ws[0]), n, use_q80_sync):
            out = ring_sync_matmul(ys, ws, q80_wire=use_q80_sync)
            # the Q80 wire quantizes on the wire; the f32 wire keeps the
            # output-side cast
            return out if use_q80_sync else [maybe_qdq(o) for o in out]
        if use_q80_sync:
            return q80_sync_matmul(ys, ws)
        parts = ring_all_reduce([local_matmul(y, w) for y, w in zip(ys, ws)])
        return [maybe_qdq(o) for o in parts]

    # packed weights: one activation-operand build feeds wq/wk/wv, one w1/w3
    share = isinstance(ranks[0].layers.wq, PackedQ40)
    share_q80 = shared_q80_acts if share else (lambda y: y)
    group = n_heads // n_kv
    scale = 1.0 / float(hd) ** 0.5

    # per rank: its tokens, positions and masks on its own device
    devs = [p.device for p in ranks]
    poss = [positions.to(d) for d in devs]
    xs = [p.embedding[tokens.to(d)] for p, d in zip(ranks, devs)]  # [B, T, dim]
    lane_idx = [torch.arange(b, device=d)[:, None].expand(b, t) for d in devs]
    # writes at or past seq_len land in the scratch slot (the JAX scatter
    # drops them); with T > 1 several rows of a lane may land there, and a
    # scatter leaves any one of them, so they all write zeros: the cache
    # stays a function of the inputs
    w_pos = [p.clamp(0, cfg.seq_len) for p in poss]
    dropped = None if t == 1 else [(p >= cfg.seq_len)[:, :, None, None] for p in poss]
    # a decode step or a verify window runs the attention kernel, which masks
    # each row by its position; a prompt chunk the dense attention
    windowed = t == 1 or (attn_len is None and t <= WINDOW)
    masks = None if windowed else [
        torch.arange(s_len, device=d)[None, None, :] <= p[:, :, None]  # [B, T, S]
        for d, p in zip(devs, poss)]

    def attention(r: int, lp: LlamaLayerParams, l: int) -> torch.Tensor:
        x, pos, p = xs[r], poss[r], ranks[r]
        k_cache, v_cache = caches[r].k[l], caches[r].v[l]  # [B, S+1, n_kv, hd]
        y = rms_norm(x, lp.rms_att, eps)
        yq = share_q80(maybe_qdq(y))
        q = _maybe_bias(matmul(yq, lp.wq), lp.bq).reshape(b, t, n_heads, hd)
        k = _maybe_bias(matmul(yq, lp.wk), lp.bk).reshape(b, t, n_kv, hd)
        v = _maybe_bias(matmul(yq, lp.wv), lp.bv).reshape(b, t, n_kv, hd)

        q = apply_rope(q, p.rope_cos, p.rope_sin, pos)
        k = apply_rope(k, p.rope_cos, p.rope_sin, pos)

        if dropped is not None:
            k, v = (torch.where(dropped[r], 0.0, x) for x in (k, v))
        k_cache[lane_idx[r], w_pos[r]] = k.to(k_cache.dtype)
        v_cache[lane_idx[r], w_pos[r]] = v.to(v_cache.dtype)

        qf = q.to(torch.float32).reshape(b, t, n_kv, group, hd)
        if windowed:
            attn = decode_attention(qf, k_cache, v_cache, pos, scale, s_len)
        else:
            attn = dense_attention(
                qf, k_cache[:, :s_len].to(torch.float32),
                v_cache[:, :s_len].to(torch.float32), masks[r], scale,
            )
        return maybe_qdq(attn.reshape(b, t, n_heads * hd).to(x.dtype))

    def ffn_in(r: int, lp: LlamaLayerParams) -> torch.Tensor:
        yqs = share_q80(maybe_qdq(rms_norm(xs[r], lp.rms_ffn, eps)))
        g = act_fn(matmul(yqs, lp.w1))
        u = matmul(yqs, lp.w3)
        return maybe_qdq(g * u)

    for l in range(cfg.n_layers):
        lps = [p.layers.layer(l) for p in ranks]
        attn = [attention(r, lps[r], l) for r in range(n)]
        xs = [x + o for x, o in zip(xs, synced_matmul(attn, [lp.wo for lp in lps]))]
        hs = [ffn_in(r, lps[r]) for r in range(n)]
        xs = [x + o for x, o in zip(xs, synced_matmul(hs, [lp.w2 for lp in lps]))]

    logits = []
    for x, p in zip(xs, ranks):
        if logit_rows is not None:
            x = x[:, logit_rows.to(x.device)]
        y = maybe_qdq(rms_norm(x, p.rms_final, eps))
        logits.append(matmul(y, p.wcls).to(torch.float32))
    # each rank's [B, T', vocab/tp] shard, gathered onto rank 0
    out = logits[0] if mesh is None else ring_all_gather(logits)[0]
    return out[..., : cfg.vocab_size], cache
