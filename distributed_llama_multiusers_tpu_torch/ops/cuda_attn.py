"""Attention of a decode or verify step as a hand-written CUDA kernel, and
the plain masked attention it is held against.

``decode_attention(qf, k_cache, v_cache, positions, scale, s_len)``: T
query rows per lane (T = 1, a decode step, or up to ``WINDOW``, the
speculative verify step's window), row t over that lane's cache slots
0 .. min(positions[b, t], s_len - 1), grouped query heads, in f32. It is
the counterpart of the masked softmax attention inside the JAX engine's
compiled decode and verify steps (XLA ``_dense_attention``; there is no
Pallas site). On a CUDA tensor the wrapper launches
``csrc/decode_attn.cu`` (built with ``nvcc`` for ``sm_90a`` at first use,
like the Q40 kernels) on the current stream, or raises; on a CPU tensor it
runs the plain version, ``dense_attention`` under the position mask.
A lane's result from the kernel depends only on its own query, position
and slots (the slots it reads and the order it sums them in follow from
its position), so a stream's tokens do not depend on the lanes beside it.
The kernel cuts a lane's slots into splits of ``SPLIT`` slots, one thread
block each (split j holds slots [j * SPLIT, (j + 1) * SPLIT), so a lane's
splits follow from its position alone), and folds their partial states in
split order inside the same launch; the wrapper allocates the partials and
the arrival tickets per call. A window runs the same kernel with a row a
lane (one launch over the B * T rows, row r reading cache lane r // T), so
row t gives the bits of a T = 1 call at positions[b, t].

``decode_attention_paged(qf, k_pool, v_pool, table, positions, scale,
s_len)`` is the same attention over the paged KV layout (one pool of
fixed-size pages, a per-lane page table; ``models/llama.PagedKVCache``),
the counterpart of the JAX forward's gather through the table before its
dense attention. The kernel reads the pool in place through the table,
with the contiguous kernel's split plan and summation order, so a paged
lane's result is bit-equal to the contiguous kernel's on the same slot
contents; on a CPU tensor the wrapper runs ``decode_attention_paged_plain``
(the gather, then the plain version).

Both forms read a bf16, f32 or e4m3 cache (``--kv-dtype f8``, the JAX
package's float8_e4m3fn). The e4m3 instantiation widens what it loads
exactly and keeps the bf16 instantiation's thread plan and summation order,
so its result equals the bf16 kernel's on the cache widened to bf16; its
plain version widens the cache to f32 before the plain attention, as the
JAX forward does.

``decode_attention_stats(qf, k_block, v_block, positions, scale, s_len)``
is the partial-stats form, what a sequence-parallel rank runs over its
block of the cache (parallel/ring_attention.py, the counterpart of the JAX
package's ``sp_attention``): positions are shifted by the block's start, so
a row may have no slot in the block (a negative position), and each row
comes back as its flash state: the normalised output o beside the max m of
its scaled scores and the sum l of their exponentials (an empty row: o = 0,
l = 0, m = -inf). On the card it is the same kernel with a stats pointer;
its plain version, ``decode_attention_stats_plain``, is ``block_stats``,
the counterpart of the JAX ``_block_stats``, over the same block.

``COUNTS`` holds the launches (one a call, whatever T, layout, form or
dtype), the window launches among them and the plain calls;
``PAGED_COUNTS`` the launches of the paged form, ``STATS_COUNTS`` those of
the stats form and ``F8_COUNTS`` those over an e4m3 cache (all counted in
``COUNTS`` too).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .cuda_q40 import load_kernel

KERNEL = "decode_attn"
KERNEL_SOURCE = "distributed_llama_multiusers_tpu_torch/csrc/decode_attn.cu"
# no Pallas site: the XLA computation it replaces
KERNEL_REPLACES = "distributed_llama_multiusers_tpu/models/llama.py:336"
MAX_HEAD_SIZE = 128
MAX_GROUP = 8
SPLIT = 128  # slots per split: kSplit in csrc/decode_attn.cu
WINDOW = 4  # query rows per lane at most: kWindow (runtime/spec.SPEC_DRAFT + 1)
# launches (every call on the card), those of them with T > 1 rows a lane
# (verify windows), and plain calls (CPU tensors)
COUNTS = {"launches": 0, "window_launches": 0, "plain_calls": 0}
# the launches through a page table
PAGED_COUNTS = {"launches": 0}
# the launches of the partial-stats form
STATS_COUNTS = {"launches": 0}
# the launches over an e4m3 cache
F8_COUNTS = {"launches": 0}
_counts_lock = threading.Lock()
# the cache dtypes the kernel reads, by their code in csrc/decode_attn.cu
KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
# q, k, v, pos, out, part, tickets, stats, lane_stride, lanes, rows, n_kv,
# group, head_size, s_len, split, kv_dtype, scale, stream
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])
# q, k, v, pos, out, part, tickets, table, nb, log2_page, lanes, rows, n_kv,
# group, head_size, s_len, split, kv_dtype, scale, stream
_PAGED_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])


def reset_counts() -> None:
    with _counts_lock:
        for table in (COUNTS, PAGED_COUNTS, STATS_COUNTS, F8_COUNTS):
            for k in table:
                table[k] = 0


def attn_counts() -> dict:
    """The kernel's counters, for ``/stats``."""
    with _counts_lock:
        return {**{f"{KERNEL}_{k}": v for k, v in COUNTS.items()},
                f"{KERNEL}_paged_launches": PAGED_COUNTS["launches"],
                f"{KERNEL}_stats_launches": STATS_COUNTS["launches"],
                f"{KERNEL}_f8_launches": F8_COUNTS["launches"]}


def add_counts(delta: dict) -> None:
    """Add a recorded delta (a CUDA graph's launches, on each replay)."""
    with _counts_lock:
        for k, v in delta.items():
            COUNTS[k] += v


def add_paged_counts(delta: dict) -> None:
    """``add_counts`` for the paged launches."""
    with _counts_lock:
        for k, v in delta.items():
            PAGED_COUNTS[k] += v


def add_stats_counts(delta: dict) -> None:
    """``add_counts`` for the stats form's launches."""
    with _counts_lock:
        for k, v in delta.items():
            STATS_COUNTS[k] += v


def add_f8_counts(delta: dict) -> None:
    """``add_counts`` for the e4m3 launches."""
    with _counts_lock:
        for k, v in delta.items():
            F8_COUNTS[k] += v


def _bump(key: str, table: dict = COUNTS) -> None:
    with _counts_lock:
        table[key] += 1


def _bump_launch(t: int, dtype: torch.dtype) -> None:
    _bump("launches")
    if t > 1:
        _bump("window_launches")
    if dtype == torch.float8_e4m3fn:
        _bump("launches", F8_COUNTS)


def launch_grid(lanes: int, n_kv: int, s_len: int) -> tuple[int, int, int]:
    """The kernel's grid: (kv head, lane, split), a window's rows each taking
    a lane's place (lanes x T of them); blocks past a row's last split
    return at once."""
    return n_kv, lanes, -(-s_len // SPLIT)


def dense_attention(qf, kf, vf, mask, scale):
    """GQA attention with materialized scores in f32. qf: [B,T,K,G,H];
    kf/vf: [B,S,K,H]; mask: [B,T,S] bool."""
    scores = torch.einsum("btkgh,bskh->btkgs", qf * scale, kf)
    scores = scores.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("btkgs,bskh->btkgh", probs, vf)


def decode_attention_plain(qf, k_cache, v_cache, positions, scale: float, s_len: int):
    """The plain version: ``dense_attention`` over the first ``s_len``
    slots, each row masked to the slots at or below its position."""
    mask = torch.arange(s_len, device=qf.device)[None, None, :] <= positions[:, :, None]
    return dense_attention(qf, k_cache[:, :s_len].to(torch.float32),
                           v_cache[:, :s_len].to(torch.float32), mask, scale)


def block_stats(qf, kf, vf, mask, scale):
    """Flash partial stats of one KV block (the JAX package's
    ``parallel/ring_attention._block_stats``), with the output normalised:
    (o [B,T,K,G,H], l [B,T,K,G], m [B,T,K,G]), m the max of the scaled
    scores, l the sum of their exponentials after m, o the softmax-weighted
    V (o = l = 0 and m = -inf for a row with no slot). qf: [B,T,K,G,H];
    kf/vf: [B,S,K,H] f32; mask: [B,T,S] bool."""
    scores = torch.einsum("btkgh,bskh->btkgs", qf * scale, kf)
    scores = scores.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    m = scores.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m_safe[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("btkgs,bskh->btkgh", p, vf)
    o = torch.where(l[..., None] > 0, o / l.clamp_min(1e-30)[..., None], torch.zeros_like(o))
    return o, l, m


def decode_attention_stats_plain(qf, k_block, v_block, positions, scale: float, s_len: int):
    """The stats form's plain version: ``block_stats`` over the block's first
    ``s_len`` slots, each row masked to the slots at or below its (shifted)
    position."""
    mask = torch.arange(s_len, device=qf.device)[None, None, :] <= positions[:, :, None]
    return block_stats(qf, k_block[:, :s_len].to(torch.float32),
                       v_block[:, :s_len].to(torch.float32), mask, scale)


def paged_gather_index(table: torch.Tensor, page_size: int, s_len: int) -> torch.Tensor:
    """The flat pool slot of each lane's logical slots 0 .. s_len - 1
    through its page-table row: int64 [B, s_len] (the JAX forward's
    ``gather_idx``)."""
    s = torch.arange(s_len, device=table.device)
    return table.to(torch.int64)[:, s // page_size] * page_size + s % page_size


def paged_view(pool: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """One layer's pool [P, page, n_kv, H] gathered at ``index`` [B, S]:
    each lane's logical [B, S, n_kv, H] view (an e4m3 pool gathered as its
    bytes)."""
    if pool.dtype == torch.float8_e4m3fn:
        return paged_view(pool.view(torch.uint8), index).view(pool.dtype)
    return pool.reshape(-1, *pool.shape[2:])[index]


def decode_attention_paged_plain(qf, k_pool, v_pool, table, positions, scale: float,
                                 s_len: int):
    """The paged plain version: each lane's first ``s_len`` slots gathered
    through its table row, then ``decode_attention_plain``."""
    index = paged_gather_index(table, k_pool.shape[1], s_len)
    return decode_attention_plain(qf, paged_view(k_pool, index), paged_view(v_pool, index),
                                  positions, scale, s_len)


def _check_q(qf: torch.Tensor, positions: torch.Tensor) -> None:
    if qf.dim() != 5 or not 1 <= qf.shape[1] <= WINDOW:
        raise ValueError(f"qf must be [lanes, 1..{WINDOW}, n_kv, group, head], got "
                         f"{tuple(qf.shape)}")
    b, t = qf.shape[:2]
    if tuple(positions.shape) != (b, t):
        raise ValueError(f"positions {tuple(positions.shape)} must be [{b}, {t}]")


def _check_card(qf: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The kernel's range and the caches' dtypes and devices."""
    group, hd = qf.shape[3:]
    if qf.device.type != "cuda":
        raise ValueError(f"the attention kernel runs on CUDA or CPU tensors, not {qf.device}")
    if hd > MAX_HEAD_SIZE or group > MAX_GROUP:
        raise ValueError(f"head size {hd} (at most {MAX_HEAD_SIZE}) or group {group} (at "
                         f"most {MAX_GROUP}) out of the kernel's range")
    if k.dtype not in KV_CODES or v.dtype != k.dtype:
        raise ValueError(f"caches must be bf16, f32 or e4m3, got {k.dtype} / {v.dtype}")
    for name, cache in (("k", k), ("v", v)):
        if cache.device != qf.device:
            raise ValueError(f"{name} cache on {cache.device}, qf on {qf.device}")


def _scratch(qf: torch.Tensor, s_len: int):
    """Per-call partial states and zeroed arrival tickets (None, None for
    one split)."""
    b, t, n_kv, group, hd = qf.shape
    splits = launch_grid(b, n_kv, s_len)[2]
    if splits == 1:
        return None, None
    part = torch.empty(b * t * n_kv * splits * group * (hd + 2), dtype=torch.float32,
                       device=qf.device)
    tickets = torch.zeros(b * t * n_kv, dtype=torch.int32, device=qf.device)
    return part, tickets


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def decode_attention_paged(qf: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           table: torch.Tensor, positions: torch.Tensor, scale: float,
                           s_len: int) -> torch.Tensor:
    """``decode_attention`` over the paged layout. k_pool, v_pool: one
    layer's pool [P, page, n_kv, H] (bf16, f32 or e4m3; page a power of two);
    table: int32 [B, nb] page ids (< P) with nb * page >= s_len; slot s of
    lane b is slot s % page of page table[b, s // page]. Returns f32 [B, T,
    n_kv, G, H], bit-equal to ``decode_attention`` on a contiguous cache
    that holds the same slot contents."""
    _check_q(qf, positions)
    b, t, n_kv, group, hd = qf.shape
    page = k_pool.shape[1] if k_pool.dim() == 4 else 0
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4 \
            or tuple(k_pool.shape[2:]) != (n_kv, hd) or page & (page - 1) or page < 1:
        raise ValueError(f"pools {tuple(k_pool.shape)} / {tuple(v_pool.shape)} do not hold "
                         f"[pages, 2^k, {n_kv}, {hd}]")
    if table.dim() != 2 or table.shape[0] != b or not 1 <= s_len <= table.shape[1] * page:
        raise ValueError(f"table {tuple(table.shape)} does not map [{b}, >= {s_len} / {page}] "
                         "blocks")
    if qf.device.type == "cpu":
        _bump("plain_calls")
        return decode_attention_paged_plain(qf, k_pool, v_pool, table, positions, scale, s_len)
    _check_card(qf, k_pool, v_pool)
    if table.dtype != torch.int32 or table.device != qf.device:
        raise ValueError(f"table must be int32 on {qf.device}, got {table.dtype} on "
                         f"{table.device}")
    for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
        if not pool.is_contiguous():
            raise ValueError(f"{name} must be dense, strides {pool.stride()}")
    q = qf.to(torch.float32).contiguous()
    pos = positions.to(device=qf.device, dtype=torch.int64).reshape(b * t).contiguous()
    tbl = table.contiguous()
    out = torch.empty_like(q)
    part, tickets = _scratch(qf, s_len)
    with torch.cuda.device(qf.device):
        err = load_kernel(KERNEL, _PAGED_ARGTYPES, "decode_attn_paged_launch")(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pos.data_ptr(),
            out.data_ptr(), _ptr(part), _ptr(tickets), tbl.data_ptr(), tbl.shape[1],
            page.bit_length() - 1, b, t, n_kv, group, hd, s_len, SPLIT,
            KV_CODES[k_pool.dtype], float(scale),
            torch.cuda.current_stream(qf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} (paged) launch failed: CUDA error {err}")
    _bump_launch(t, k_pool.dtype)
    _bump("launches", PAGED_COUNTS)
    return out


def _check_cache(qf: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 positions: torch.Tensor, s_len: int) -> None:
    _check_q(qf, positions)
    b, _, n_kv, _, hd = qf.shape
    if k_cache.shape != v_cache.shape or k_cache.dim() != 4 or k_cache.shape[0] != b \
            or tuple(k_cache.shape[2:]) != (n_kv, hd) or not 1 <= s_len <= k_cache.shape[1]:
        raise ValueError(f"caches {tuple(k_cache.shape)} / {tuple(v_cache.shape)} do not "
                         f"hold [{b}, >= {s_len}, {n_kv}, {hd}]")


def _launch(qf, k_cache, v_cache, positions, scale: float, s_len: int, stats=None):
    """One launch of the contiguous kernel (``stats``: the stats form's
    [B, T, K, G, 2] output, or None)."""
    _check_card(qf, k_cache, v_cache)
    b, t, n_kv, group, hd = qf.shape
    slot = n_kv * hd
    for name, cache in (("k_cache", k_cache), ("v_cache", v_cache)):
        if cache.stride()[1:] != (slot, hd, 1) or cache.stride(0) != k_cache.stride(0):
            raise ValueError(f"{name}'s slots must be dense, strides {cache.stride()}")
    q = qf.to(torch.float32).contiguous()
    pos = positions.to(device=qf.device, dtype=torch.int64).reshape(b * t).contiguous()
    out = torch.empty_like(q)
    part, tickets = _scratch(qf, s_len)
    with torch.cuda.device(qf.device):
        err = load_kernel(KERNEL, _ARGTYPES)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
            out.data_ptr(), _ptr(part), _ptr(tickets), _ptr(stats), k_cache.stride(0), b, t,
            n_kv, group, hd, s_len, SPLIT, KV_CODES[k_cache.dtype], float(scale),
            torch.cuda.current_stream(qf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    _bump_launch(t, k_cache.dtype)
    return out


def decode_attention(qf: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     positions: torch.Tensor, scale: float, s_len: int) -> torch.Tensor:
    """qf: f32 [B, T, n_kv, G, H], 1 <= T <= WINDOW; k_cache, v_cache: one
    layer's cache [B, S, n_kv, H] (bf16, f32 or e4m3; S >= s_len); positions: int
    [B, T] on the same device. Returns f32 [B, T, n_kv, G, H]."""
    _check_cache(qf, k_cache, v_cache, positions, s_len)
    if qf.device.type == "cpu":
        _bump("plain_calls")
        return decode_attention_plain(qf, k_cache, v_cache, positions, scale, s_len)
    return _launch(qf, k_cache, v_cache, positions, scale, s_len)


def decode_attention_stats(qf: torch.Tensor, k_block: torch.Tensor, v_block: torch.Tensor,
                           positions: torch.Tensor, scale: float, s_len: int):
    """The partial-stats form over one sp rank's block: ``decode_attention``'s
    arguments with the block as the cache and positions shifted by its start
    (any int64, negative for a row with no slot in the block). Returns (o f32
    [B, T, n_kv, G, H] normalised, l and m f32 [B, T, n_kv, G]); a row with
    no slot gives o = 0, l = 0, m = -inf."""
    _check_cache(qf, k_block, v_block, positions, s_len)
    if qf.device.type == "cpu":
        _bump("plain_calls")
        return decode_attention_stats_plain(qf, k_block, v_block, positions, scale, s_len)
    stats = torch.empty((*qf.shape[:4], 2), dtype=torch.float32, device=qf.device)
    out = _launch(qf, k_block, v_block, positions, scale, s_len, stats)
    _bump("launches", STATS_COUNTS)
    return out, stats[..., 1], stats[..., 0]
