"""Ring collectives over tensor-parallel ranks, and the hop kernel under them.

The JAX package syncs the row-parallel wo/w2 outputs of a TP mesh with ring
collectives written shard-locally inside ``shard_map``; every hop of every
ring is ``_shift``, which on a TPU pod is the Pallas kernel ``_rdma_shift``
(one ``make_async_remote_copy`` to the right neighbour). The port runs the
mesh from one process (parallel/mesh.py), so each collective here takes the
list of per-rank tensors and returns the list of per-rank results, and every
hop is ``ring_shift``: one launch of ``csrc/ring_hop.cu`` per receiving rank.

- ``ring_reduce_scatter`` / ``ring_all_gather`` / ``ring_all_gather_q80`` /
  ``ring_all_reduce``: the JAX functions' hop order and arrival bookkeeping,
  kept exactly, so that the f32 partials are added in the same order and the
  results are bit-equal to the JAX package's on the same inputs.
- ``ring_sync_matmul``: a row-parallel (d_in-sharded) product whose output is
  reduced chunk by chunk around the ring, then gathered (f32 or the Q80 wire).

``ring_shift`` launches the kernel for CUDA tensors and runs its plain
version (``ring_shift_plain``) only for CPU tensors; ``COUNTS`` holds the
kernel's launches, the plain version's calls and the bytes either moved.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..quants.packed import PackedQ40
from ..quants.torch_codec import Q80_BLOCK, q80_decode_blocks, q80_encode_blocks
from .cuda_q40 import load_kernel
from .linear import matmul

KERNEL = "ring_hop"
KERNEL_SOURCE = "distributed_llama_multiusers_tpu_torch/csrc/ring_hop.cu"
KERNEL_REPLACES = "distributed_llama_multiusers_tpu/ops/ring_collective.py:130"
COUNTS = {"launches": 0, "plain_calls": 0, "bytes": 0}
_counts_lock = threading.Lock()
_peers: set = set()  # (receiver, sender) device indices with peer access on
# ring_hop_launch(src, dst, nbytes, stream); ring_hop_enable_peer(device, peer)
_HOP_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
_PEER_ARGTYPES = [ctypes.c_int, ctypes.c_int]


def reset_counts() -> None:
    with _counts_lock:
        for k in COUNTS:
            COUNTS[k] = 0


def ring_counts() -> dict:
    """The hop's counters, for ``/stats``."""
    with _counts_lock:
        return {f"ring_hop_{k}": v for k, v in COUNTS.items()}


def _bump(key: str, nbytes: int, n: int = 1) -> None:
    with _counts_lock:
        COUNTS[key] += n
        COUNTS["bytes"] += nbytes * n


# ---------------------------------------------------------------------------
# The hop: rank r receives rank r-1's buffer
# ---------------------------------------------------------------------------


def ring_shift_plain(xs: list) -> list:
    """The hop's plain version: rank r gets a copy of rank (r-1) mod n's
    tensor on its own device."""
    n = len(xs)
    return [xs[(r - 1) % n].to(xs[r].device, copy=True) for r in range(n)]


def _check_ring(xs: list) -> None:
    if not xs:
        raise ValueError("a ring needs at least one rank")
    x0 = xs[0]
    for x in xs:
        if x.dtype != x0.dtype or x.shape != x0.shape:
            raise ValueError(f"ring ranks disagree: {x.dtype} {tuple(x.shape)} against "
                             f"{x0.dtype} {tuple(x0.shape)}")
        if not x.is_contiguous():
            raise ValueError("ring hop payloads must be contiguous")
        if x.device.type != x0.device.type:
            raise ValueError(f"ring ranks mix {x.device} and {x0.device}")
    if x0.numel() == 0:
        raise ValueError("empty ring hop payload")


def _enable_peer(receiver: torch.device, sender: torch.device) -> None:
    key = (receiver.index, sender.index)
    if key in _peers:
        return
    if not torch.cuda.can_device_access_peer(receiver, sender):
        raise RuntimeError(f"{receiver} cannot read {sender}'s memory (no peer access); "
                           "the ring hop has no host-staged path")
    err = load_kernel(KERNEL, _PEER_ARGTYPES, "ring_hop_enable_peer")(
        receiver.index, sender.index)
    if err != 0:
        raise RuntimeError(f"enabling peer access {receiver} <- {sender}: CUDA error {err}")
    _peers.add(key)


def _hop(src: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One launch: ``device`` pulls a copy of ``src`` on its current stream."""
    nbytes = src.numel() * src.element_size()
    dst = torch.empty(src.shape, dtype=src.dtype, device=device)
    stream = torch.cuda.current_stream(device)
    if src.device != device:
        _enable_peer(device, src.device)
        # the TPU kernel's semaphores as stream order: the receiver waits for
        # the work that produced src, and the allocator keeps src's block
        # until the receiver's read is done
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(src.device))
        stream.wait_event(ready)
        src.record_stream(stream)
    with torch.cuda.device(device):
        err = load_kernel(KERNEL, _HOP_ARGTYPES)(src.data_ptr(), dst.data_ptr(), nbytes,
                                                 stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_hop launch failed: CUDA error {err}")
    _bump("launches", nbytes)
    return dst


def ring_shift(xs: list, chan: int = 0) -> list:
    """Rotate one hop rightward around the ring: rank r's result is a fresh
    copy of rank (r-1) mod n's tensor on rank r's device. ``chan`` names the
    hop chain as the JAX kernel's ``collective_id`` does (the Q80 wire's
    values run on 0, its scales on 1); both chains are ordered on each
    rank's current stream (csrc/ring_hop.cu says why)."""
    _check_ring(xs)
    if chan not in (0, 1):
        raise ValueError(f"ring hop channel {chan} is not 0 or 1")
    nbytes = xs[0].numel() * xs[0].element_size()
    if xs[0].device.type == "cpu":
        _bump("plain_calls", nbytes, len(xs))
        return ring_shift_plain(xs)
    if xs[0].device.type != "cuda":
        raise ValueError(f"the ring hop runs on CUDA or CPU tensors, not {xs[0].device}")
    n = len(xs)
    return [_hop(xs[(r - 1) % n], xs[r].device) for r in range(n)]


# ---------------------------------------------------------------------------
# Ring collectives over the per-rank lists
# ---------------------------------------------------------------------------


def _chunks(x: torch.Tensor, n: int) -> list:
    c = x.shape[-1] // n
    return [x[..., k * c:(k + 1) * c] for k in range(n)]


def ring_reduce_scatter(xs: list) -> list:
    """Every rank holds a full-width partial [..., D]; rank r returns the
    reduced chunk r [..., D/n]. n-1 hops of D/n elements. After hop s, rank r
    holds the sum over ranks r-s..r of chunk (r-1-s) mod n, the received
    partial first. D % n == 0."""
    n = len(xs)
    if n <= 1:
        return list(xs)
    chunks = [_chunks(x, n) for x in xs]
    acc = [chunks[r][(r - 1) % n].contiguous() for r in range(n)]
    for s in range(1, n):
        acc = ring_shift(acc)
        acc = [(acc[r] + chunks[r][(r - 1 - s) % n]).contiguous() for r in range(n)]
    return acc


def _arrivals_in_rank_order(xs: list, chan: int = 0) -> list:
    """n-1 hops of every rank's tensor; per rank, the n tensors in the order
    of the ranks they came from. Arrival j on rank r came from rank (r-j)
    mod n, so rank k's tensor is arrival (r-k) mod n."""
    n = len(xs)
    arrivals = [[x] for x in xs]
    cur = [x.contiguous() for x in xs]
    for _ in range(1, n):
        cur = ring_shift(cur, chan)
        for r in range(n):
            arrivals[r].append(cur[r])
    return [[arrivals[r][(r - k) % n] for k in range(n)] for r in range(n)]


def ring_all_gather(xs: list) -> list:
    """Rank r holds chunk r [..., C]; every rank returns [..., n*C] with
    chunk k = rank k's data."""
    if len(xs) <= 1:
        return list(xs)
    return [torch.cat(parts, dim=-1) for parts in _arrivals_in_rank_order(xs)]


def ring_all_gather_q80(xs: list) -> list:
    """``ring_all_gather`` shipping the Q80 wire: each rank encodes its chunk
    once (converter rounding: ties to even), the int8 values and f16 scales
    ride the hops on their two channels, and every arrival is decoded where
    it lands. The local chunk passes through the codec too, so every rank
    holds the same values. C % 32 == 0."""
    n = len(xs)
    if n <= 1:
        return list(xs)
    enc = [q80_encode_blocks(x.to(torch.float32), mode="converter") for x in xs]
    qs = _arrivals_in_rank_order([q for q, _ in enc], chan=0)
    ss = _arrivals_in_rank_order([s for _, s in enc], chan=1)
    x0 = xs[0]
    return [torch.cat([q80_decode_blocks(q, s, x0.shape).to(x0.dtype)
                       for q, s in zip(qs[r], ss[r])], dim=-1) for r in range(n)]


def ring_all_reduce(xs: list) -> list:
    """Ring all-reduce (reduce-scatter, then all-gather) of full-width
    partials. Where n does not divide the last dim, every rank gathers every
    partial and adds them in rank order, so all ranks hold the same sum."""
    n = len(xs)
    if n <= 1:
        return list(xs)
    if xs[0].shape[-1] % n == 0:
        return ring_all_gather(ring_reduce_scatter(xs))
    out = []
    for parts in _arrivals_in_rank_order(xs):
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        out.append(acc)
    return out


# ---------------------------------------------------------------------------
# The fused form: row-parallel matmul with the ring interleaved per chunk
# ---------------------------------------------------------------------------


def ring_sync_supported(d_out: int, tp: int, q80_wire: bool = False) -> bool:
    """Whether a row-parallel output of width ``d_out`` can sync through the
    ring: whole chunks per hop, and whole Q80 blocks per chunk on the Q80
    wire."""
    if tp <= 1 or d_out % tp != 0:
        return False
    return not q80_wire or (d_out // tp) % Q80_BLOCK == 0


def ring_sync_engages(config, mesh_shape: dict, enabled: bool = True) -> bool:
    """Whether ``llama_forward`` syncs wo/w2 through the ring (``enabled`` is
    ``--ring-sync``): a pure-TP mesh with tp > 1 whose ``dim`` splits into
    whole chunks."""
    if not enabled:
        return False
    tp = mesh_shape.get("tp", 1)
    if tp <= 1:
        return False
    if any(mesh_shape.get(ax, 1) > 1 for ax in ("dp", "sp", "ep", "pp")):
        return False
    return config.dim % tp == 0


def _stack(w) -> torch.Tensor:
    return w.packed if isinstance(w, PackedQ40) else w


def chunk_d_out(w) -> int:
    """Full output width of a column-chunk stack [n, d_in/n, d_out/n]."""
    return _stack(w).shape[0] * _stack(w).shape[-1]


def local_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """One rank's full-width partial x @ w for a column-chunk stack w: the
    chunks' products side by side, in x's dtype."""
    return torch.cat([matmul(x, w[k]) for k in range(_stack(w).shape[0])], dim=-1)


def ring_sync_matmul(xs: list, ws: list, q80_wire: bool = False) -> list:
    """y = x @ w for a d_in-sharded weight, the sync interleaved with the
    product: rank r's partial for output chunk (r-1-s) mod n is computed
    with the local weight's column chunk and added to the accumulator that
    just arrived (partials in f32), then the reduced chunks are gathered
    (Q80 wire when ``q80_wire``). xs: per-rank [..., d_in/n]; ws: per-rank
    column-chunk stacks [n, d_in/n, d_out/n] (parallel/sharding.py).
    Returns the full [..., d_out] on every rank, in x's dtype."""
    n = len(xs)
    d_out = chunk_d_out(ws[0])
    if not ring_sync_supported(d_out, n, q80_wire):
        raise ValueError(
            f"ring_sync_matmul needs d_out ({d_out}) divisible by tp ({n})"
            + (" with whole Q80 blocks per chunk" if q80_wire else "")
        )

    def part(r: int, k: int) -> torch.Tensor:
        return matmul(xs[r], ws[r][k]).to(torch.float32)

    acc = [part(r, (r - 1) % n) for r in range(n)]
    for s in range(1, n):
        acc = ring_shift(acc)
        acc = [acc[r] + part(r, (r - 1 - s) % n) for r in range(n)]
    out = ring_all_gather_q80(acc) if q80_wire else ring_all_gather(acc)
    return [o.to(x.dtype) for o, x in zip(out, xs)]
