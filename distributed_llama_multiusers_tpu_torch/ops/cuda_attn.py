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
row t gives the bits of a T = 1 call at positions[b, t]. ``COUNTS`` holds
the launches (one a call, whatever T), the window launches among them and
the plain calls.
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
_counts_lock = threading.Lock()
# q, k, v, pos, out, part, tickets, lane_stride, lanes, rows, n_kv, group,
# head_size, s_len, split, kv_bf16, scale, stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])


def reset_counts() -> None:
    with _counts_lock:
        for k in COUNTS:
            COUNTS[k] = 0


def attn_counts() -> dict:
    """The kernel's counters, for ``/stats``."""
    with _counts_lock:
        return {f"{KERNEL}_{k}": v for k, v in COUNTS.items()}


def add_counts(delta: dict) -> None:
    """Add a recorded delta (a CUDA graph's launches, on each replay)."""
    with _counts_lock:
        for k, v in delta.items():
            COUNTS[k] += v


def _bump(key: str) -> None:
    with _counts_lock:
        COUNTS[key] += 1


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


def decode_attention(qf: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     positions: torch.Tensor, scale: float, s_len: int) -> torch.Tensor:
    """qf: f32 [B, T, n_kv, G, H], 1 <= T <= WINDOW; k_cache, v_cache: one
    layer's cache [B, S, n_kv, H] (bf16 or f32; S >= s_len); positions: int
    [B, T] on the same device. Returns f32 [B, T, n_kv, G, H]."""
    if qf.dim() != 5 or not 1 <= qf.shape[1] <= WINDOW:
        raise ValueError(f"qf must be [lanes, 1..{WINDOW}, n_kv, group, head], got "
                         f"{tuple(qf.shape)}")
    b, t, n_kv, group, hd = qf.shape
    if k_cache.shape != v_cache.shape or k_cache.dim() != 4 or k_cache.shape[0] != b \
            or tuple(k_cache.shape[2:]) != (n_kv, hd) or not 1 <= s_len <= k_cache.shape[1]:
        raise ValueError(f"caches {tuple(k_cache.shape)} / {tuple(v_cache.shape)} do not "
                         f"hold [{b}, >= {s_len}, {n_kv}, {hd}]")
    if tuple(positions.shape) != (b, t):
        raise ValueError(f"positions {tuple(positions.shape)} must be [{b}, {t}]")
    if qf.device.type == "cpu":
        _bump("plain_calls")
        return decode_attention_plain(qf, k_cache, v_cache, positions, scale, s_len)
    if qf.device.type != "cuda":
        raise ValueError(f"the attention kernel runs on CUDA or CPU tensors, not {qf.device}")
    if hd > MAX_HEAD_SIZE or group > MAX_GROUP:
        raise ValueError(f"head size {hd} (at most {MAX_HEAD_SIZE}) or group {group} (at "
                         f"most {MAX_GROUP}) out of the kernel's range")
    if k_cache.dtype not in (torch.bfloat16, torch.float32) or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"caches must be bf16 or f32, got {k_cache.dtype} / {v_cache.dtype}")
    slot = n_kv * hd
    for name, cache in (("k_cache", k_cache), ("v_cache", v_cache)):
        if cache.device != qf.device:
            raise ValueError(f"{name} on {cache.device}, qf on {qf.device}")
        if cache.stride()[1:] != (slot, hd, 1) or cache.stride(0) != k_cache.stride(0):
            raise ValueError(f"{name}'s slots must be dense, strides {cache.stride()}")
    q = qf.to(torch.float32).contiguous()
    pos = positions.to(device=qf.device, dtype=torch.int64).reshape(b * t).contiguous()
    out = torch.empty_like(q)
    splits = launch_grid(b, n_kv, s_len)[2]
    part = tickets = None
    if splits > 1:  # per-call scratch: each row's partial states, the arrival tickets
        part = torch.empty(b * t * n_kv * splits * group * (hd + 2), dtype=torch.float32,
                           device=qf.device)
        tickets = torch.zeros(b * t * n_kv, dtype=torch.int32, device=qf.device)
    with torch.cuda.device(qf.device):
        err = load_kernel(KERNEL, _ARGTYPES)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            None if tickets is None else tickets.data_ptr(), k_cache.stride(0), b, t, n_kv,
            group, hd, s_len, SPLIT, int(k_cache.dtype == torch.bfloat16), float(scale),
            torch.cuda.current_stream(qf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    _bump("launches")
    if t > 1:
        _bump("window_launches")
    return out
