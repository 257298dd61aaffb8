"""Ring collectives over tensor-parallel ranks, and the ring-step kernel under them.

The JAX package syncs the row-parallel wo/w2 outputs of a TP mesh with ring
collectives written shard-locally inside ``shard_map``; every hop of every
ring is ``_shift``, which on a TPU pod is the Pallas kernel ``_rdma_shift``
(one ``make_async_remote_copy`` to the right neighbour), and XLA fuses the
add after each reduce hop and the concatenate of the gather's arrivals into
their consumers. The port runs the mesh from one process
(parallel/mesh.py), so each collective here takes the list of per-rank
tensors and returns the list of per-rank results, and every ring step is
``ring_step``: one launch of ``csrc/ring_hop.cu`` per receiving rank, which
moves that rank's arrivals (up to two segments) and does the step's add
and gather-slot write in the same launch.

- ``ring_reduce_scatter`` / ``ring_all_gather`` / ``ring_all_gather_q80`` /
  ``ring_all_reduce``: the JAX functions' hop order and arrival bookkeeping,
  kept exactly, so that the f32 partials are added in the same order and the
  results are bit-equal to the JAX package's on the same inputs. Reduce
  hops add on arrival; gather hops land in their column slot of the output.
- ``ring_sync_matmul``: a row-parallel (d_in-sharded) product whose output is
  reduced chunk by chunk around the ring, then gathered (f32 or the Q80 wire).

``ring_step`` launches the kernel for CUDA tensors and runs its plain
version (``ring_step_plain``) only for CPU tensors; ``ring_shift`` is the
bare hop (one copy segment per rank) over it. ``COUNTS`` holds the kernel's
launches, the plain version's calls (each one per receiving rank per step)
and the wire bytes either moved.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple

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
MAX_SEGMENTS = 2


class _HopSeg(ctypes.Structure):
    """csrc/ring_hop.cu's HopSeg."""
    _fields_ = [("src", ctypes.c_void_p), ("add", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("src_pitch", ctypes.c_longlong), ("add_pitch", ctypes.c_longlong),
                ("dst_pitch", ctypes.c_longlong), ("row_bytes", ctypes.c_longlong),
                ("rows", ctypes.c_int), ("kind", ctypes.c_int), ("per", ctypes.c_int)]


class _HopStep(ctypes.Structure):
    _fields_ = [("seg", _HopSeg * MAX_SEGMENTS), ("nseg", ctypes.c_int)]


# ring_hop_launch(const HopStep*, stream); ring_hop_enable_peer(device, peer)
_STEP_ARGTYPES = [ctypes.POINTER(_HopStep), ctypes.c_void_p]
_PEER_ARGTYPES = [ctypes.c_int, ctypes.c_int]
# the kernel's segment kinds: (destination/source dtype, addend dtype) -> kind
_COPY = 0
_ADD_KINDS = {(torch.float32, torch.float32): 1, (torch.float32, torch.bfloat16): 2,
              (torch.bfloat16, torch.bfloat16): 3}


def reset_counts() -> None:
    with _counts_lock:
        for k in COUNTS:
            COUNTS[k] = 0


def ring_counts() -> dict:
    """The ring step's counters, for ``/stats``."""
    with _counts_lock:
        return {f"ring_hop_{k}": v for k, v in COUNTS.items()}


def add_counts(delta: dict) -> None:
    """Add a recorded delta of launches and bytes (a CUDA graph's, on each
    replay)."""
    with _counts_lock:
        for k, v in delta.items():
            COUNTS[k] += v


def _bump(key: str, nbytes: int, n: int = 1) -> None:
    with _counts_lock:
        COUNTS[key] += n
        COUNTS["bytes"] += nbytes


# ---------------------------------------------------------------------------
# One ring step: what each receiving rank gets, in one launch per rank
# ---------------------------------------------------------------------------


class Seg(NamedTuple):
    """One segment of a ring step: ``dst = src`` or ``dst = src + add``.
    ``src`` may be another rank's tensor (the received operand, the left one
    of the add); ``dst`` and ``add`` are the receiver's. Each may be a view
    whose rows step by one pitch (a column slot of a wider tensor). ``wire``
    is False for a rank's own chunk placed into its gather output: it moves
    no wire bytes."""
    src: torch.Tensor
    dst: torch.Tensor
    add: torch.Tensor | None = None
    wire: bool = True


def _rows(t: torch.Tensor, name: str) -> tuple[int, int, int]:
    """(rows, elements per row, row pitch in elements) of a tensor whose
    last dim is contiguous and whose leading dims step by one row pitch."""
    if t.dim() == 0 or t.numel() == 0:
        raise ValueError(f"ring step {name} is empty")
    cols = t.shape[-1]
    if cols > 1 and t.stride(-1) != 1:
        raise ValueError(f"ring step {name} rows must be contiguous")
    lead = [(n, st) for n, st in zip(t.shape[:-1], t.stride()[:-1]) if n != 1]
    if not lead:
        return 1, cols, cols
    pitch = lead[-1][1]
    want = pitch
    for n, st in reversed(lead):
        if st != want:
            raise ValueError(f"ring step {name}: leading dims do not step by one row pitch")
        want = st * n
    return math.prod(n for n, _ in lead), cols, pitch


def _check_seg(seg: Seg) -> _HopSeg:
    """The segment as the kernel takes it (kind, rows, pitches and row bytes;
    a contiguous one as a single row), after the checks it relies on."""
    src, dst, add = seg.src, seg.dst, seg.add
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise ValueError(f"ring step source {src.dtype} {tuple(src.shape)} does not match "
                         f"destination {dst.dtype} {tuple(dst.shape)}")
    kind = _COPY
    if add is not None:
        if add.shape != dst.shape:
            raise ValueError(f"ring step addend {tuple(add.shape)} does not match "
                             f"destination {tuple(dst.shape)}")
        kind = _ADD_KINDS.get((dst.dtype, add.dtype))
        if kind is None:
            raise ValueError(f"ring step adds f32 or bf16 addends into f32, or bf16 into "
                             f"bf16, not {add.dtype} into {dst.dtype}")
        if add.device != dst.device:
            raise ValueError(f"ring step addend on {add.device}, destination on {dst.device}")
    rows, cols, src_pitch = _rows(src, "source")
    dst_pitch = _rows(dst, "destination")[2]
    add_pitch = _rows(add, "addend")[2] if add is not None else cols
    if rows > 1 and src_pitch == dst_pitch == add_pitch == cols:
        rows, cols = 1, rows * cols  # contiguous: one row
    size = dst.element_size()
    add_size = add.element_size() if add is not None else 0
    return _HopSeg(src.data_ptr(), add.data_ptr() if add is not None else None,
                   dst.data_ptr(), src_pitch * size, add_pitch * add_size, dst_pitch * size,
                   cols * size, rows, kind, 0)


def ring_step_plain(recv: list) -> None:
    """The ring step's plain version: per receiving rank, per segment, copy
    the source to the receiver's device, add the addend (torch's ``+``: f32,
    or bf16 rounded once) and write it into the destination."""
    for segs in recv:
        for seg in segs:
            got = seg.src.to(seg.dst.device)
            seg.dst.copy_(got if seg.add is None else got + seg.add)


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


def _launch(segs: list, descs: list) -> None:
    """One launch: the receiver (every destination's device) pulls its
    segments on its current stream."""
    device = segs[0].dst.device
    stream = torch.cuda.current_stream(device)
    step = _HopStep()
    step.nseg = len(descs)
    for i, d in enumerate(descs):
        step.seg[i] = d
    for sender in {seg.src.device for seg in segs} - {device}:
        _enable_peer(device, sender)
        # the TPU kernel's semaphores as stream order: the receiver waits for
        # the work that produced the source, and the allocator keeps the
        # source's block until the receiver's read is done
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(sender))
        stream.wait_event(ready)
    for seg in segs:
        if seg.src.device != device:
            seg.src.record_stream(stream)
    with torch.cuda.device(device):
        err = load_kernel(KERNEL, _STEP_ARGTYPES)(ctypes.byref(step), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_hop launch failed: CUDA error {err}")


def ring_step(recv: list) -> None:
    """One ring step: ``recv[r]`` is receiving rank r's list of at most two
    segments (``Seg``), all landing on that rank's device. One launch of the
    ring-step kernel per rank for CUDA tensors; the plain version for CPU
    tensors. Counts one launch (or plain call) per rank and the wire bytes."""
    if not recv:
        raise ValueError("a ring step needs at least one receiving rank")
    descs = []
    nbytes = 0
    dev_type = recv[0][0].dst.device.type if recv[0] else None
    for segs in recv:
        if not 1 <= len(segs) <= MAX_SEGMENTS:
            raise ValueError(f"a rank receives 1 to {MAX_SEGMENTS} segments a step, "
                             f"not {len(segs)}")
        descs.append([_check_seg(s) for s in segs])
        for s in segs:
            if s.dst.device != segs[0].dst.device:
                raise ValueError("one rank's segments land on one device")
            if s.src.device.type != dev_type or s.dst.device.type != dev_type:
                raise ValueError(f"ring step mixes {s.src.device} and {s.dst.device} "
                                 f"with {dev_type}")
            if s.wire:
                nbytes += s.src.numel() * s.src.element_size()
    if dev_type == "cpu":
        _bump("plain_calls", nbytes, len(recv))
        ring_step_plain(recv)
        return
    if dev_type != "cuda":
        raise ValueError(f"the ring step runs on CUDA or CPU tensors, not {dev_type}")
    for segs, ds in zip(recv, descs):
        _launch(segs, ds)
    _bump("launches", nbytes, len(recv))


# ---------------------------------------------------------------------------
# The bare hop: rank r receives rank r-1's buffer
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


def ring_shift(xs: list) -> list:
    """Rotate one hop rightward around the ring: rank r's result is a fresh
    copy of rank (r-1) mod n's tensor on rank r's device, one copy segment
    of a ring step."""
    _check_ring(xs)
    n = len(xs)
    out = [torch.empty_like(x) for x in xs]
    ring_step([[Seg(xs[(r - 1) % n], out[r])] for r in range(n)])
    return out


# ---------------------------------------------------------------------------
# Ring collectives over the per-rank lists
# ---------------------------------------------------------------------------


def _slot(x: torch.Tensor, k: int, c: int) -> torch.Tensor:
    """Chunk k of width c along the last dim (a view)."""
    return x[..., k * c:(k + 1) * c]


def ring_reduce_scatter(xs: list, out: list | None = None) -> list:
    """Every rank holds a full-width partial [..., D]; rank r returns the
    reduced chunk r [..., D/n]. n-1 steps of D/n elements, each adding the
    arrival to the receiver's own chunk in the hop. After step s, rank r
    holds the sum over ranks r-s..r of chunk (r-1-s) mod n, the received
    partial first. ``out``: per-rank destinations of the reduced chunk (a
    gather output's slot r); fresh tensors by default. D % n == 0."""
    n = len(xs)
    if n <= 1:
        return list(xs)
    c = xs[0].shape[-1] // n
    acc = [_slot(x, (r - 1) % n, c) for r, x in enumerate(xs)]
    for s in range(1, n):
        dst = out if s == n - 1 and out is not None else [torch.empty_like(a) for a in acc]
        ring_step([[Seg(acc[(r - 1) % n], dst[r], _slot(xs[r], (r - 1 - s) % n, c))]
                   for r in range(n)])
        acc = dst
    return acc


def _gather_steps(outs: list, c: int, local: list | None = None) -> None:
    """The all-gather's n-1 steps into per-rank outputs [..., n*c]: at step
    j rank r receives, into slot (r-j) mod n, the chunk that rank r-1 holds
    there. ``local``: each rank's own chunk, read by the first step straight
    from it and placed into slot r by the same launch; else slot r already
    holds it."""
    n = len(outs)
    for j in range(1, n):
        recv = []
        for r in range(n):
            k = (r - j) % n
            src = local[(r - 1) % n] if j == 1 and local is not None else _slot(
                outs[(r - 1) % n], k, c)
            segs = [Seg(src, _slot(outs[r], k, c))]
            if j == 1 and local is not None:
                segs.append(Seg(local[r], _slot(outs[r], r, c), wire=False))
            recv.append(segs)
        ring_step(recv)


def _gather_outputs(xs: list, width: int, dtype) -> list:
    return [torch.empty(*x.shape[:-1], width, dtype=dtype, device=x.device) for x in xs]


def ring_all_gather(xs: list) -> list:
    """Rank r holds chunk r [..., C]; every rank returns [..., n*C] with
    chunk k = rank k's data, each arrival written into its slot."""
    n = len(xs)
    if n <= 1:
        return list(xs)
    c = xs[0].shape[-1]
    outs = _gather_outputs(xs, n * c, xs[0].dtype)
    _gather_steps(outs, c, local=xs)
    return outs


def ring_all_gather_q80(xs: list) -> list:
    """``ring_all_gather`` shipping the Q80 wire: each rank encodes its chunk
    once (converter rounding: ties to even) into its slot of its wire
    buffers, the int8 values and f16 scales of each step ride one launch as
    two segments into their slots, and each rank decodes its buffers where
    they landed. The local chunk passes through the codec too, so every rank
    holds the same values. C % 32 == 0."""
    n = len(xs)
    if n <= 1:
        return list(xs)
    x0 = xs[0]
    lead, c = x0.shape[:-1], x0.shape[-1]
    cb = c // Q80_BLOCK
    qs = _gather_outputs(xs, n * c, torch.int8)
    ss = _gather_outputs(xs, n * cb, torch.float16)
    for r, x in enumerate(xs):
        q80_encode_blocks(x.to(torch.float32), mode="converter",
                          out=(_slot(qs[r], r, c).view(*lead, cb, Q80_BLOCK),
                               _slot(ss[r], r, cb).unsqueeze(-1)))
    for j in range(1, n):
        ring_step([[Seg(_slot(qs[(r - 1) % n], (r - j) % n, c), _slot(qs[r], (r - j) % n, c)),
                    Seg(_slot(ss[(r - 1) % n], (r - j) % n, cb), _slot(ss[r], (r - j) % n, cb))]
                   for r in range(n)])
    return [q80_decode_blocks(q.view(*lead, n * cb, Q80_BLOCK), s.unsqueeze(-1),
                              (*lead, n * c)).to(x0.dtype) for q, s in zip(qs, ss)]


def _arrivals_in_rank_order(xs: list) -> list:
    """n-1 hops of every rank's tensor; per rank, the n tensors in the order
    of the ranks they came from. Arrival j on rank r came from rank (r-j)
    mod n, so rank k's tensor is arrival (r-k) mod n."""
    n = len(xs)
    arrivals = [[x] for x in xs]
    cur = [x.contiguous() for x in xs]
    for _ in range(1, n):
        cur = ring_shift(cur)
        for r in range(n):
            arrivals[r].append(cur[r])
    return [[arrivals[r][(r - k) % n] for k in range(n)] for r in range(n)]


def ring_all_reduce(xs: list) -> list:
    """Ring all-reduce (reduce-scatter, then all-gather) of full-width
    partials; the last reduce step writes each rank's reduced chunk into its
    slot of the output. Where n does not divide the last dim, every rank
    gathers every partial and adds them in rank order, so all ranks hold the
    same sum."""
    n = len(xs)
    if n <= 1:
        return list(xs)
    if xs[0].shape[-1] % n == 0:
        c = xs[0].shape[-1] // n
        outs = [torch.empty_like(x) for x in xs]
        ring_reduce_scatter(xs, out=[_slot(o, r, c) for r, o in enumerate(outs)])
        _gather_steps(outs, c)
        return outs
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
    with the local weight's column chunk and added, in the hop, to the f32
    accumulator arriving from rank r-1; the last step writes rank r's
    reduced chunk into slot r of its output, then the reduced chunks are
    gathered (Q80 wire when ``q80_wire``). xs: per-rank [..., d_in/n]; ws: per-rank
    column-chunk stacks [n, d_in/n, d_out/n] (parallel/sharding.py).
    Returns the full [..., d_out] on every rank, in x's dtype."""
    n = len(xs)
    d_out = chunk_d_out(ws[0])
    if not ring_sync_supported(d_out, n, q80_wire):
        raise ValueError(
            f"ring_sync_matmul needs d_out ({d_out}) divisible by tp ({n})"
            + (" with whole Q80 blocks per chunk" if q80_wire else "")
        )
    c = d_out // n
    # the first partial is the chunk that leaves each rank: cast to f32 once,
    # as the wire carries it; every later partial is added in the hop, in
    # x's dtype, widened exactly
    acc = [matmul(xs[r], ws[r][(r - 1) % n]).to(torch.float32) for r in range(n)]
    outs = None if q80_wire else _gather_outputs(xs, d_out, torch.float32)
    for s in range(1, n):
        last = s == n - 1
        parts = [matmul(xs[r], ws[r][(r - 1 - s) % n]) for r in range(n)]
        dst = ([_slot(o, r, c) for r, o in enumerate(outs)] if last and outs is not None
               else [torch.empty_like(a) for a in acc])
        ring_step([[Seg(acc[(r - 1) % n], dst[r], parts[r])] for r in range(n)])
        acc = dst
    if q80_wire:
        out = ring_all_gather_q80(acc)
    else:
        _gather_steps(outs, c)
        out = outs
    return [o.to(x.dtype) for o, x in zip(out, xs)]
