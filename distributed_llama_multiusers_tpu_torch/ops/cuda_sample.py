"""The sampler's Gumbel-max draw as a hand-written CUDA kernel.

``gumbel_argmax(logp, seeds, positions)``: per lane, the first index of the
largest gumbel(fold_in(PRNGKey(seed), pos)) + logp over the sorted
vocabulary, with JAX's threefry2x32 bits (``runtime/sampling.py`` explains
the layout). It is the counterpart of XLA's ``jax.random.categorical``
inside the JAX engine's compiled step; there is no Pallas site. On a CUDA
tensor the wrapper launches ``csrc/gumbel_sample.cu`` (built with ``nvcc``
for ``sm_90a`` at first use, like the Q40 kernels) on the current stream,
or raises; on a CPU tensor it runs the plain version,
``sampling.gumbel_argmax_plain``. The kernel cuts each lane's row into
chunks of ``CHUNK`` entries, one thread block each, and
reduces the chunks' (value, index) pairs inside the same launch; the
wrapper allocates their scratch and the arrival tickets per call.
``COUNTS`` holds the launches and the plain calls.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .cuda_q40 import load_kernel

KERNEL = "gumbel_sample"
KERNEL_SOURCE = "distributed_llama_multiusers_tpu_torch/csrc/gumbel_sample.cu"
# no Pallas site: the XLA computation it replaces
KERNEL_REPLACES = "distributed_llama_multiusers_tpu/runtime/engine.py:576"
CHUNK = 2048  # entries per thread block: kChunk in csrc/gumbel_sample.cu
COUNTS = {"launches": 0, "plain_calls": 0}
_counts_lock = threading.Lock()
# logp, seeds, positions, out, noise, scratch, lanes, vocab, chunk, stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def reset_counts() -> None:
    with _counts_lock:
        for k in COUNTS:
            COUNTS[k] = 0


def sample_counts() -> dict:
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


def gumbel_argmax(logp: torch.Tensor, seeds: torch.Tensor, positions: torch.Tensor,
                  noise_out: torch.Tensor | None = None) -> torch.Tensor:
    """logp: f32 [n, vocab] (-inf outside the nucleus); seeds, positions:
    int [n] on the same device. Returns int64 [n], the chosen sorted index
    per lane. ``noise_out`` (CUDA only; f32 [n, vocab]) takes the kernel's
    Gumbel noise at every unmasked entry, for the tests."""
    if logp.dim() != 2:
        raise ValueError(f"logp must be [lanes, vocab], got {tuple(logp.shape)}")
    n, vocab = logp.shape
    if tuple(seeds.shape) != (n,) or tuple(positions.shape) != (n,):
        raise ValueError(f"seeds {tuple(seeds.shape)} and positions "
                         f"{tuple(positions.shape)} must be [{n}]")
    if logp.device.type == "cpu":
        # imported here: runtime.sampling imports this module
        from ..runtime.sampling import gumbel_argmax_plain

        _bump("plain_calls")
        return gumbel_argmax_plain(logp, seeds, positions)
    if logp.device.type != "cuda":
        raise ValueError(f"the sampler kernel runs on CUDA or CPU tensors, not {logp.device}")
    if logp.dtype != torch.float32 or not logp.is_contiguous():
        raise ValueError("logp must be contiguous float32")
    for name, t in (("seeds", seeds), ("positions", positions)):
        if t.device != logp.device:
            raise ValueError(f"{name} on {t.device}, logp on {logp.device}")
    if noise_out is not None and (noise_out.dtype != torch.float32 or noise_out.shape != logp.shape
                                  or noise_out.device != logp.device
                                  or not noise_out.is_contiguous()):
        raise ValueError(f"noise_out must be contiguous float32 {tuple(logp.shape)}")
    seeds = seeds.to(torch.int64).contiguous()
    positions = positions.to(torch.int64).contiguous()
    out = torch.empty(n, dtype=torch.int64, device=logp.device)
    chunks = -(-vocab // CHUNK)  # the grid is (chunks, lanes)
    # per-call scratch: each chunk's (value, index) pair and the lanes' tickets
    scratch = (torch.zeros(n * (2 * chunks + 1), dtype=torch.int32, device=logp.device)
               if chunks > 1 else None)
    with torch.cuda.device(logp.device):
        err = load_kernel(KERNEL, _ARGTYPES)(
            logp.data_ptr(), seeds.data_ptr(), positions.data_ptr(), out.data_ptr(),
            None if noise_out is None else noise_out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), n, vocab, CHUNK,
            torch.cuda.current_stream(logp.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    _bump("launches")
    return out
