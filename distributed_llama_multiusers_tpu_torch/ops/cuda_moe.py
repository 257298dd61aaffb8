"""The mixture-of-experts router as a hand-written CUDA kernel.

``moe_route(y, gate, k)``: per token row of ``y`` [N, dim] (f32 or bf16),
the logits ``y.f32 @ gate`` over the E experts (gate [dim, E] f32), the top
k of them in ``lax.top_k``'s order (value descending, the lower index first
on a tie), the softmax over those k values (their largest subtracted, as
``jax.nn.softmax``) and the dense routing weights [N, E] (zero for the
experts not taken). It is the counterpart of the JAX package's
``_moe_topk`` and ``_moe_router_weights`` (XLA code inside its compiled
step; there is no Pallas site). On a CUDA tensor the wrapper launches
``csrc/moe_route.cu`` (built with ``nvcc`` for ``sm_90a`` at first use, like
the Q40 kernels) on the current stream, or raises; on a CPU tensor it runs
the plain version, ``moe_route_plain``. ``COUNTS`` holds the launches and
the plain calls.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .cuda_q40 import load_kernel

KERNEL = "moe_route"
KERNEL_SOURCE = "distributed_llama_multiusers_tpu_torch/csrc/moe_route.cu"
# no Pallas site: the XLA computation it replaces (_moe_topk, :171-188 with
# _moe_router_weights)
KERNEL_REPLACES = "distributed_llama_multiusers_tpu/models/llama.py:171"
MAX_EXPERTS = 4096  # the kernel keeps a row's logits in shared memory
COUNTS = {"launches": 0, "plain_calls": 0}
_counts_lock = threading.Lock()
# y, y_bf16, gate, topw, topi, rw, n, dim, n_exp, k, stream
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def reset_counts() -> None:
    with _counts_lock:
        for k in COUNTS:
            COUNTS[k] = 0


def moe_counts() -> dict:
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


def moe_route_plain(y: torch.Tensor, gate: torch.Tensor, k: int):
    """The router in plain PyTorch: an f32 product, a stable descending sort
    (lax.top_k's tie order; ``torch.topk``'s is unspecified), the softmax of
    the first k and their scatter over the experts."""
    logits = torch.matmul(y.to(torch.float32), gate.to(torch.float32))
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    topw = torch.softmax(vals[:, :k], dim=-1)
    topi = idx[:, :k]
    rw = torch.zeros_like(logits).scatter_(-1, topi, topw)
    return topw, topi.to(torch.int32), rw


def moe_route(y: torch.Tensor, gate: torch.Tensor, k: int):
    """y: [N, dim] f32 or bf16; gate: [dim, E] f32 on y's device; 1 <= k <=
    E. Returns (topw [N, k] f32, topi [N, k] int32, rw [N, E] f32)."""
    if y.dim() != 2 or gate.dim() != 2 or gate.shape[0] != y.shape[1]:
        raise ValueError(f"moe_route takes y [N, dim] and gate [dim, E], got "
                         f"{tuple(y.shape)} and {tuple(gate.shape)}")
    n, dim = y.shape
    n_exp = gate.shape[1]
    if not 1 <= k <= n_exp:
        raise ValueError(f"k={k} experts of {n_exp}")
    if y.device.type == "cpu":
        _bump("plain_calls")
        return moe_route_plain(y, gate, k)
    if y.device.type != "cuda":
        raise ValueError(f"the router kernel runs on CUDA or CPU tensors, not {y.device}")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"y must be float32 or bfloat16, got {y.dtype}")
    if gate.dtype != torch.float32 or gate.device != y.device:
        raise ValueError(f"gate must be float32 on {y.device}, got {gate.dtype} on "
                         f"{gate.device}")
    if n_exp > MAX_EXPERTS:
        raise ValueError(f"{n_exp} experts: the kernel takes at most {MAX_EXPERTS}")
    y = y.contiguous()
    gate = gate.contiguous()
    topw = torch.empty((n, k), dtype=torch.float32, device=y.device)
    topi = torch.empty((n, k), dtype=torch.int32, device=y.device)
    rw = torch.empty((n, n_exp), dtype=torch.float32, device=y.device)
    if n == 0:
        return topw, topi, rw
    with torch.cuda.device(y.device):
        err = load_kernel(KERNEL, _ARGTYPES)(
            y.data_ptr(), int(y.dtype == torch.bfloat16), gate.data_ptr(), topw.data_ptr(),
            topi.data_ptr(), rw.data_ptr(), n, dim, n_exp, k,
            torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    _bump("launches")
    return topw, topi, rw
