"""Grammar-constrained decoding's two device operations as hand-written CUDA
kernels (``csrc/grammar.cu``).

- ``mask_argmax(rows, states, masks)``: per row, the first index of the
  largest entry of the row masked by its automaton state (an entry whose
  packed legal bit ``(masks[g][t >> 5] >> (t & 31)) & 1`` is 0 counts as
  -inf), in ``torch.argmax``'s order (a NaN wins at its first index, ties
  go to the lower index, an all -inf row gives 0); optionally it writes
  the masked rows for the nucleus sampler. The JAX engine's
  ``_g_mask_row`` + ``jnp.argmax``.
- ``grammar_next(states, tokens, keys, targets, defaults, vocab)``: per
  row, the state after each of its tokens: a lower-bound search of
  ``state * vocab + token`` over the sorted edge keys, clipped to the last
  key; the edge's target on a hit, else the state's default. The JAX
  engine's ``_g_next1``, walked over a verify window as
  ``_g_walk_greedy`` walks it.

State 0 is the FREE state (every bit set, a self-loop): an unconstrained
row's masked row is the row itself and its index ``torch.argmax``'s. States
are int64 on the engine's device (the carry's dtype), clamped to the table
as the JAX gathers clamp. The mask table is ``[S, ceil(V/32)]`` 32-bit
words (the slab's uint32 masks viewed as int32), the edge keys, targets
and defaults int32, all on the rows' device.

On a CUDA tensor each wrapper launches its kernel (built with ``nvcc`` for
``sm_90a`` at first use, like the other kernels) on the current stream, or
raises; on a CPU tensor it runs its plain version below. The launch plans
are computed here: ``mask_plan`` (each cluster block's slice of a row, and
whether the loads are 16 bytes wide) and ``search_rounds`` (the step's
probe rounds). ``mask_argmax`` launches one cluster of CLUSTER blocks a
row and raises at first use on a card that cannot schedule such a
cluster (``active_clusters``). ``COUNTS`` holds the launches and the
plain calls; ``add_counts`` adds a CUDA graph's recorded launches on each
replay.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .cuda_q40 import load_kernel

KERNEL = "grammar"  # csrc/grammar.cu holds both kernels
KERNELS = ("grammar_mask_argmax", "grammar_next")
KERNEL_SOURCE = "distributed_llama_multiusers_tpu_torch/csrc/grammar.cu"
# no Pallas site: the XLA computations they replace
KERNEL_REPLACES = {
    "grammar_mask_argmax": "distributed_llama_multiusers_tpu/runtime/engine.py:493",
    "grammar_next": "distributed_llama_multiusers_tpu/runtime/engine.py:507",
}
# grammar_mask_argmax: the thread blocks of a row's cluster (kMaxCluster in
# csrc/grammar.cu; above 8 is Hopper's non-portable size), chosen against 8
# on the H100 (PERF.md)
CLUSTER = 16
THREADS = 256  # a cluster block's threads: kThreads
# grammar_next: the keys one search round probes, one a thread (kNextThreads)
SEARCH_FAN = 256
COUNTS = {"mask_argmax_launches": 0, "mask_argmax_plain_calls": 0,
          "next_launches": 0, "next_plain_calls": 0}
_counts_lock = threading.Lock()
_P, _I = ctypes.c_void_p, ctypes.c_int
# rows, states, masks, out, masked, masked_every, n_rows, vocab, words,
# n_states, cluster, slice, vec, stream
_MASK_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
# states, tokens, tok_stride, steps, keys, targets, defaults, n_edges,
# n_states, vocab, rounds, walk, walk_stride, final, n_rows, stream
_NEXT_ARGTYPES = [_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _P]
_active_clusters: dict = {}  # device index -> clusters of CLUSTER the card holds at once


def reset_counts() -> None:
    with _counts_lock:
        for k in COUNTS:
            COUNTS[k] = 0


def grammar_counts() -> dict:
    """The kernels' counters, for ``/stats``."""
    with _counts_lock:
        return {f"grammar_{k}": v for k, v in COUNTS.items()}


def add_counts(delta: dict) -> None:
    """Add a recorded delta (a CUDA graph's launches, on each replay)."""
    with _counts_lock:
        for k, v in delta.items():
            COUNTS[k] += v


def _bump(key: str) -> None:
    with _counts_lock:
        COUNTS[key] += 1


def mask_plan(vocab: int, aligned: bool) -> tuple[bool, int]:
    """(vec, slice): whether ``grammar_mask_argmax`` takes 16-byte loads (a
    vocabulary of a multiple of 4 entries and 16-byte aligned row pointers,
    ``aligned``), and the entries of each of a row's CLUSTER blocks'
    contiguous slice: block c takes [c * slice, min((c + 1) * slice, vocab)),
    a multiple of 4 entries with 16-byte loads. Blocks past the row's end
    take none."""
    vec = aligned and vocab % 4 == 0
    if vec:
        return True, -(-vocab // (4 * CLUSTER)) * 4
    return False, -(-vocab // CLUSTER)


def search_rounds(n_edges: int) -> int:
    """``grammar_next``'s probe rounds a step over ``n_edges`` sorted keys:
    the fewest R >= 1 with SEARCH_FAN ** R >= n_edges (two up to 65,536
    keys)."""
    rounds = 1
    while SEARCH_FAN ** rounds < n_edges:
        rounds += 1
    return rounds


def active_clusters(device) -> int:
    """The clusters of CLUSTER blocks of ``grammar_mask_argmax`` the card
    holds at once (the fewer of its two instantiations'), asked of the card
    once (which also allows a size above 8 there). Raises when it holds
    none: there is no other launch shape."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _active_clusters:
        fn = load_kernel(KERNEL, [_I, _I], "grammar_mask_argmax_clusters")
        with torch.cuda.device(idx):
            got = min(fn(CLUSTER, vec) for vec in (1, 0))
        if got <= 0:
            raise RuntimeError(f"grammar_mask_argmax: clusters of {CLUSTER} blocks cannot be "
                               f"scheduled on cuda:{idx} (cudaOccupancyMaxActiveClusters: "
                               f"{got})")
        _active_clusters[idx] = got
    return _active_clusters[idx]


def _clamped(states: torch.Tensor, n_states: int) -> torch.Tensor:
    return torch.clamp(states.to(torch.int64), 0, n_states - 1)


def mask_argmax_plain(rows: torch.Tensor, states: torch.Tensor, masks: torch.Tensor):
    """``mask_argmax``'s plain version: (index int64 [R], masked rows f32
    [R, V]): the JAX engine's ``where(bits, row, -inf)`` and ``argmax``."""
    vocab = rows.shape[-1]
    ids = torch.arange(vocab, device=rows.device)
    words = masks[_clamped(states, masks.shape[0])][:, ids >> 5]  # [R, V] int32
    bits = ((words >> (ids & 31).to(torch.int32)) & 1).to(torch.bool)
    masked = torch.where(bits, rows, torch.full_like(rows, float("-inf")))
    return torch.argmax(masked, dim=-1), masked


def mask_argmax(rows: torch.Tensor, states: torch.Tensor, masks: torch.Tensor,
                masked_out: torch.Tensor | None = None, masked_every: int = 1) -> torch.Tensor:
    """rows: f32 [R, V]; states: int [R]; masks: int32 [S, ceil(V/32)].
    Returns int64 [R], each row's masked argmax. ``masked_out`` (f32
    [ceil(R / masked_every), V]) takes row r's masked values at row
    r / masked_every, for the rows r with r % masked_every == 0 (a verify
    window samples its first row a lane)."""
    if rows.dim() != 2:
        raise ValueError(f"rows must be [R, vocab], got {tuple(rows.shape)}")
    n, vocab = rows.shape
    words = -(-vocab // 32)
    if tuple(states.shape) != (n,):
        raise ValueError(f"states {tuple(states.shape)} must be [{n}]")
    if masks.dim() != 2 or masks.shape[1] != words or masks.dtype != torch.int32:
        raise ValueError(f"masks must be int32 [S, {words}], got {masks.dtype} "
                         f"{tuple(masks.shape)}")
    if masked_every < 1:
        raise ValueError(f"masked_every {masked_every} < 1")
    m_rows = -(-n // masked_every)
    if masked_out is not None and (tuple(masked_out.shape) != (m_rows, vocab)
                                   or masked_out.dtype != torch.float32
                                   or masked_out.device != rows.device):
        raise ValueError(f"masked_out must be float32 [{m_rows}, {vocab}] on {rows.device}")
    if rows.device.type == "cpu":
        _bump("mask_argmax_plain_calls")
        idx, masked = mask_argmax_plain(rows, states, masks)
        if masked_out is not None:
            masked_out.copy_(masked[::masked_every])
        return idx
    if rows.device.type != "cuda":
        raise ValueError(f"the grammar kernels run on CUDA or CPU tensors, not {rows.device}")
    if rows.dtype != torch.float32 or not rows.is_contiguous():
        raise ValueError("rows must be contiguous float32")
    if masked_out is not None and not masked_out.is_contiguous():
        raise ValueError("masked_out must be contiguous")
    for name, t in (("states", states), ("masks", masks)):
        if t.device != rows.device:
            raise ValueError(f"{name} on {t.device}, rows on {rows.device}")
    if not masks.is_contiguous():
        raise ValueError("masks must be contiguous")
    states = states.to(torch.int64).contiguous()
    aligned = rows.data_ptr() % 16 == 0 and (masked_out is None
                                             or masked_out.data_ptr() % 16 == 0)
    vec, slice_ = mask_plan(vocab, aligned)
    out = torch.empty(n, dtype=torch.int64, device=rows.device)
    with torch.cuda.device(rows.device):
        active_clusters(rows.device)
        err = load_kernel(KERNEL, _MASK_ARGTYPES, "grammar_mask_argmax_launch")(
            rows.data_ptr(), states.data_ptr(), masks.data_ptr(), out.data_ptr(),
            None if masked_out is None else masked_out.data_ptr(), masked_every, n, vocab,
            masks.shape[1], masks.shape[0], CLUSTER, slice_, int(vec),
            torch.cuda.current_stream(rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grammar_mask_argmax launch failed: CUDA error {err}")
    _bump("mask_argmax_launches")
    return out


def grammar_next_plain(states: torch.Tensor, tokens: torch.Tensor, keys: torch.Tensor,
                       targets: torch.Tensor, defaults: torch.Tensor, vocab: int) -> torch.Tensor:
    """``grammar_next``'s plain version with ``walk``: int64 [R, T + 1], column
    t the state after tokens[:, :t] (``torch.searchsorted`` + gather +
    ``where``, the JAX ``_g_next1`` step by step)."""
    keys64 = keys.to(torch.int64)
    last = keys.shape[0] - 1
    s = _clamped(states, defaults.shape[0])
    cols = [s]
    for t in range(tokens.shape[1]):
        key = s * vocab + tokens[:, t].to(torch.int64)
        j = torch.clamp(torch.searchsorted(keys64, key), 0, last)
        s = torch.where(keys64[j] == key, targets[j].to(torch.int64),
                        defaults[s].to(torch.int64))
        cols.append(s)
    return torch.stack(cols, dim=1)


def grammar_next(states: torch.Tensor, tokens: torch.Tensor, keys: torch.Tensor,
                 targets: torch.Tensor, defaults: torch.Tensor, vocab: int,
                 walk: bool = False, out: torch.Tensor | None = None) -> torch.Tensor:
    """states: int [R]; tokens: int [R, T] (rows of any stride, columns
    contiguous); keys, targets: int32 [E], the keys sorted; defaults: int32
    [S]. Returns int64 [R], the state after all T tokens, or with ``walk``
    int64 [R, T + 1], column t the state after the first t. ``out`` (int64,
    that shape, contiguous) is written in place of a new tensor."""
    if tokens.dim() != 2 or tokens.shape[0] != states.shape[0] or states.dim() != 1:
        raise ValueError(f"tokens {tuple(tokens.shape)} must be [{states.shape[0]}, T] "
                         f"for states {tuple(states.shape)}")
    n, steps = tokens.shape
    shape = (n, steps + 1) if walk else (n,)
    if out is not None and (tuple(out.shape) != shape or out.dtype != torch.int64
                            or not out.is_contiguous() or out.device != states.device):
        raise ValueError(f"out must be contiguous int64 {shape} on {states.device}")
    if keys.shape != targets.shape or keys.dim() != 1 or keys.numel() < 1:
        raise ValueError("keys and targets must be non-empty [E]")
    if states.device.type == "cpu":
        _bump("next_plain_calls")
        res = grammar_next_plain(states, tokens, keys, targets, defaults, vocab)
        res = res if walk else res[:, -1]
        if out is None:
            return res
        out.copy_(res)
        return out
    if states.device.type != "cuda":
        raise ValueError(f"the grammar kernels run on CUDA or CPU tensors, not {states.device}")
    for name, t in (("tokens", tokens), ("keys", keys), ("targets", targets),
                    ("defaults", defaults)):
        if t.device != states.device:
            raise ValueError(f"{name} on {t.device}, states on {states.device}")
    for name, t in (("keys", keys), ("targets", targets), ("defaults", defaults)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")
    states = states.to(torch.int64).contiguous()
    tokens = tokens.to(torch.int64)
    if steps > 1 and tokens.stride(1) != 1:
        tokens = tokens.contiguous()
    if out is None:
        out = torch.empty(shape, dtype=torch.int64, device=states.device)
    with torch.cuda.device(states.device):
        err = load_kernel(KERNEL, _NEXT_ARGTYPES, "grammar_next_launch")(
            states.data_ptr(), tokens.data_ptr(), tokens.stride(0), steps, keys.data_ptr(),
            targets.data_ptr(), defaults.data_ptr(), keys.shape[0], defaults.shape[0],
            vocab, search_rounds(keys.shape[0]), out.data_ptr() if walk else None, steps + 1,
            None if walk else out.data_ptr(), n,
            torch.cuda.current_stream(states.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grammar_next launch failed: CUDA error {err}")
    _bump("next_launches")
    return out
