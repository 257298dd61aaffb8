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

The launch plan is computed here (``route_plan``): the dim's SLICES slices,
which the dim alone sets, so that a row's bits do not depend on N or the
plan; then one cluster of SLICES blocks a row below TILE_MIN_ROWS rows
(E up to CLUSTER_MAX_EXPERTS), else one block a tile of rows. The first
launch on a card raises when it cannot schedule such a cluster
(``active_clusters``); nothing falls back to another plan.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import torch

from .cuda_q40 import load_kernel

KERNEL = "moe_route"
KERNEL_SOURCE = "distributed_llama_multiusers_tpu_torch/csrc/moe_route.cu"
# no Pallas site: the XLA computation it replaces (_moe_topk, :171-188 with
# _moe_router_weights)
KERNEL_REPLACES = "distributed_llama_multiusers_tpu/models/llama.py:171"
# the launch constants of csrc/moe_route.cu (tests/test_torch_moe.py holds
# them against the source)
MAX_EXPERTS = 4096         # kMaxExperts: a tile keeps its rows' logits in shared memory
SLICES = 16                # kSlices: the dim's slices, a cluster's blocks, a tile's warps
VEC = 8                    # kVec: the elements a lane loads at once
LANES = 32
CLUSTER_THREADS = 128      # kClusterThreads
TILE_THREADS = SLICES * LANES
TILE_ROWS = {torch.bfloat16: 8, torch.float32: 4}  # kTileRowsBf16, kTileRowsF32
CLUSTER_MAX_EXPERTS = 256  # kClusterMaxExperts
EXPERT_CHUNK = 64          # kExpertChunk
TILE_MAX_SMEM = 200 * 1024  # kTileMaxSmem: a tile block's shared memory (opted in)
# kStage: the floats of a tile warp's staged gate quad (LANES * VEC rows of
# 4, 4 of pad every VEC rows)
STAGE_FLOATS = (LANES * VEC + LANES) * 4
# the fewest rows the tile plan takes; fewer run the cluster plan (both
# give the same bits). Chosen on the H100 (PERF.md, chip_smoke.py's moe
# phase sweeps both plans over N)
TILE_MIN_ROWS = 64
H100_SMS = 132
COUNTS = {"launches": 0, "plain_calls": 0}
_counts_lock = threading.Lock()
_P, _I = ctypes.c_void_p, ctypes.c_int
# y, y_bf16, gate, topw, topi, rw, n, dim, n_exp, k, slice_len, tile_rows,
# vec_y, vec_g, stream
_ARGTYPES = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
_active_clusters: dict = {}  # device index -> clusters of SLICES the card holds at once
_sms: dict = {}  # device index -> multiprocessors


@dataclass(frozen=True)
class RoutePlan:
    """A ``moe_route`` launch: ``slice_len`` (the dim's slices, slice s
    [s * slice_len, min((s + 1) * slice_len, dim)), the same for every N
    and plan), and ``tile_rows``: 0 for the cluster plan (grid (SLICES, N),
    a cluster of SLICES blocks a row), else the rows of a tile block (grid
    ``blocks``); ``smem_bytes``: a block's dynamic shared memory."""

    slice_len: int
    tile_rows: int
    blocks: int
    smem_bytes: int

    @property
    def cluster(self) -> bool:
        return self.tile_rows == 0


def slice_len(dim: int) -> int:
    """The elements of each of the dim's SLICES slices: the fewest, a
    multiple of VEC, that cover the dim (trailing slices may be short or
    empty). The dim alone sets it."""
    return -(-dim // (SLICES * VEC)) * VEC


def slices(dim: int) -> list[tuple[int, int]]:
    """The SLICES slices [lo, hi) of the dim, in fold order."""
    length = slice_len(dim)
    return [(min(s * length, dim), min((s + 1) * length, dim)) for s in range(SLICES)]


def lane_vectors(lo: int, hi: int, lane: int) -> list[tuple[int, int]]:
    """The elements [d0, d1) lane ``lane`` sums in slice [lo, hi), in its
    order: vectors lane, lane + LANES, ... of VEC elements."""
    return [(d0, min(d0 + VEC, hi)) for d0 in range(lo + lane * VEC, hi, LANES * VEC)]


def route_plan(n: int, dim: int, n_exp: int, k: int, dtype=torch.bfloat16,
               n_sms: int = H100_SMS, tile_min_rows: int = TILE_MIN_ROWS) -> RoutePlan:
    """The launch for ``n`` rows of ``dim`` over ``n_exp`` experts, ``k``
    active: the cluster plan when n < ``tile_min_rows`` and the experts fit
    rank 0's shared memory, else tiles of as many rows as fill the card's
    ``n_sms`` at one tile an SM, at most TILE_ROWS of the dtype and
    TILE_MAX_SMEM of shared memory. Raises ValueError on what the kernel
    cannot take."""
    if n < 1 or dim < 1:
        raise ValueError(f"moe_route takes at least one row and one dim, got {n} x {dim}")
    if not 1 <= n_exp <= MAX_EXPERTS:
        raise ValueError(f"{n_exp} experts: the kernel takes 1 to {MAX_EXPERTS}")
    if not 1 <= k <= n_exp:
        raise ValueError(f"k={k} experts of {n_exp}")
    if dtype not in TILE_ROWS:
        raise ValueError(f"y must be float32 or bfloat16, got {dtype}")
    length = slice_len(dim)
    if n < tile_min_rows and n_exp <= CLUSTER_MAX_EXPERTS and n <= 65535:
        return RoutePlan(length, 0, n,
                         (CLUSTER_THREADS // LANES * STAGE_FLOATS + (SLICES + 1) * n_exp) * 4)
    stage_bytes = SLICES * STAGE_FLOATS * 4
    row_bytes = (SLICES * min(n_exp, EXPERT_CHUNK) + n_exp) * 4
    rows = max(1, min(TILE_ROWS[dtype], (TILE_MAX_SMEM - stage_bytes) // row_bytes,
                      -(-n // max(1, n_sms))))
    return RoutePlan(length, rows, -(-n // rows), stage_bytes + rows * row_bytes)


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
    y = y.contiguous()
    gate = gate.contiguous()
    if n == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=y.device),
                torch.empty((0, k), dtype=torch.int32, device=y.device),
                torch.empty((0, n_exp), dtype=torch.float32, device=y.device))
    return launch_plan(y, gate, k, route_plan(n, dim, n_exp, k, y.dtype, n_sms(y.device)))


def n_sms(device) -> int:
    """The card's multiprocessors, asked once a device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def active_clusters(device) -> int:
    """The clusters of SLICES blocks of the cluster plan the card holds at
    once (the fewer of its two instantiations'), asked of the card once
    before its first launch (which also allows a cluster size above 8 and
    the tile plan's TILE_MAX_SMEM there). Raises when it holds none: the
    rows that plan takes have no other launch."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _active_clusters:
        fn = load_kernel(KERNEL, [], "moe_route_prepare")
        with torch.cuda.device(idx):
            got = fn()
        if got <= 0:
            raise RuntimeError(f"moe_route: clusters of {SLICES} blocks cannot be scheduled on "
                               f"cuda:{idx} (cudaOccupancyMaxActiveClusters: {got})")
        _active_clusters[idx] = got
    return _active_clusters[idx]


def launch_plan(y: torch.Tensor, gate: torch.Tensor, k: int, plan: RoutePlan):
    """One launch of the kernel under ``plan`` (``route_plan``'s for these
    shapes, or another valid one: every plan gives the same bits) on
    contiguous CUDA tensors; raises if the card refuses it."""
    n, dim = y.shape
    n_exp = gate.shape[1]
    topw = torch.empty((n, k), dtype=torch.float32, device=y.device)
    topi = torch.empty((n, k), dtype=torch.int32, device=y.device)
    rw = torch.empty((n, n_exp), dtype=torch.float32, device=y.device)
    vec_y = y.data_ptr() % 16 == 0 and dim * y.element_size() % 16 == 0
    vec_g = gate.data_ptr() % 16 == 0 and n_exp % 4 == 0
    with torch.cuda.device(y.device):
        active_clusters(y.device)
        err = load_kernel(KERNEL, _ARGTYPES)(
            y.data_ptr(), int(y.dtype == torch.bfloat16), gate.data_ptr(), topw.data_ptr(),
            topi.data_ptr(), rw.data_ptr(), n, dim, n_exp, k, plan.slice_len, plan.tile_rows,
            int(vec_y), int(vec_g), torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    _bump("launches")
    return topw, topi, rw
