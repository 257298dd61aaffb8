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
prefill tails near the end of the context). Attention never reads it for a
real query, whose mask is s <= pos < seq_len.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from ..formats.model_file import HiddenAct
from ..ops.activations import gelu, silu
from ..ops.linear import matmul, shared_q80_acts
from ..ops.norm import rms_norm
from ..ops.rope import apply_rope
from ..quants.packed import PackedQ40
from .config import LlamaConfig

_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "rms_att", "rms_ffn")


@dataclass
class LlamaLayerParams:
    """Per-layer weights stacked along a leading [n_layers] axis. Matmul
    weights are [L, d_in, d_out] (y = x @ W) dense tensors or PackedQ40
    planes ([L, d_in/2, d_out] + [L, d_in/32, d_out])."""

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
                  device="cpu") -> KVCache:
    shape = (config.n_layers, n_lanes, config.seq_len + 1, config.n_kv_heads,
             config.head_size)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _maybe_bias(y: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    return y if b is None else y + b.to(y.dtype)


def _dense_attention(qf, kf, vf, mask, scale):
    """GQA attention with materialized scores in f32. qf: [B,T,K,G,H];
    kf/vf: [B,S,K,H]; mask: [B,T,S] bool."""
    scores = torch.einsum("btkgh,bskh->btkgs", qf * scale, kf)
    scores = scores.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("btkgs,bskh->btkgh", probs, vf)


def llama_forward(
    config: LlamaConfig,
    params: LlamaParams,
    tokens: torch.Tensor,  # [B, T] int64
    positions: torch.Tensor,  # [B, T] int64, per-lane positions
    cache: KVCache,
    attn_len: int | None = None,
    logit_rows: torch.Tensor | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """Returns (logits [B, T', vocab] float32, cache), for prefill (T > 1)
    and decode (T = 1) alike; ``cache`` is updated in place.

    ``attn_len`` (optional) bounds the cache slots attention reads to the
    first ``attn_len``: every real query position must be below it. The
    slots past it are masked out in any case, so the result is the same
    up to f32 summation order. ``logit_rows`` (optional) selects the T
    positions whose logits are computed (T' = len(logit_rows)); None
    computes all T."""
    b, t = tokens.shape
    cfg = config
    n_heads, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_size
    eps = cfg.norm_epsilon
    act_fn = silu if cfg.hidden_act == HiddenAct.SILU else gelu
    device = tokens.device
    s_len = cfg.seq_len if attn_len is None else max(1, min(cfg.seq_len, attn_len))

    # packed weights: one activation-operand build feeds wq/wk/wv, one w1/w3
    share = isinstance(params.layers.wq, PackedQ40)
    share_q80 = shared_q80_acts if share else (lambda y: y)

    x = params.embedding[tokens]  # [B, T, dim]
    lane_idx = torch.arange(b, device=device)[:, None].expand(b, t)
    # writes at or past seq_len land in the scratch slot (the JAX scatter
    # drops them)
    w_pos = positions.clamp(0, cfg.seq_len)
    s_idx = torch.arange(s_len, device=device)
    attn_mask = s_idx[None, None, :] <= positions[:, :, None]  # [B, T, S]
    group = n_heads // n_kv
    scale = 1.0 / float(hd) ** 0.5

    for l in range(cfg.n_layers):
        lp = params.layers.layer(l)
        k_cache, v_cache = cache.k[l], cache.v[l]  # [B, S+1, n_kv, hd]
        dtype = x.dtype

        y = rms_norm(x, lp.rms_att, eps)
        yq = share_q80(y)
        q = _maybe_bias(matmul(yq, lp.wq), lp.bq).reshape(b, t, n_heads, hd)
        k = _maybe_bias(matmul(yq, lp.wk), lp.bk).reshape(b, t, n_kv, hd)
        v = _maybe_bias(matmul(yq, lp.wv), lp.bv).reshape(b, t, n_kv, hd)

        q = apply_rope(q, params.rope_cos, params.rope_sin, positions)
        k = apply_rope(k, params.rope_cos, params.rope_sin, positions)

        k_cache[lane_idx, w_pos] = k.to(k_cache.dtype)
        v_cache[lane_idx, w_pos] = v.to(v_cache.dtype)

        qf = q.to(torch.float32).reshape(b, t, n_kv, group, hd)
        attn = _dense_attention(
            qf, k_cache[:, :s_len].to(torch.float32),
            v_cache[:, :s_len].to(torch.float32), attn_mask, scale,
        )
        attn = attn.reshape(b, t, n_heads * hd).to(dtype)
        x = x + matmul(attn, lp.wo)

        y = rms_norm(x, lp.rms_ffn, eps)
        yqs = share_q80(y)
        g = act_fn(matmul(yqs, lp.w1))
        u = matmul(yqs, lp.w3)
        x = x + matmul(g * u, lp.w2)

    if logit_rows is not None:
        x = x[:, logit_rows]
    y = rms_norm(x, params.rms_final, eps)
    logits = matmul(y, params.wcls).to(torch.float32)
    return logits[..., : cfg.vocab_size], cache
