"""Inference engine: prefill and decode step families over a lane-based KV
cache, the JAX engine's serving programs.

- ``decode``: one token for every lane at its own position — the whole
  continuous batch advances in one step;
- ``decode_multi(h)``: h chained decode steps in one dispatch, each lane
  fed its own choice on the device;
- ``decode_pipelined`` / ``pipeline_consume``: a ring of at most
  ``pipeline_depth`` dispatched steps fed by the on-device token and
  position carry, read back one step behind;
- ``decode_prefill_fused``: one prompt chunk for an admitting lane plus one
  pipelined decode step for every other lane, in the same ring;
- ``decode_spec`` / ``decode_spec_pipelined`` / ``decode_spec_prefill_fused``:
  the speculative verify step (prompt-lookup drafts, ``runtime/spec.py``),
  synchronous, inside the pipelined ring, and fused with a prompt chunk:
  each lane's next token plus up to ``SPEC_DRAFT`` drafts verified in one
  forward of ``SPEC_DRAFT + 1`` rows, the accepted prefix and the model's
  own next token emitted, the position carry advanced by each lane's
  count;
- ``prefill_chunk`` / ``prefill``: a bucketed prompt chunk for ONE lane,
  on that lane's slice of the cache;
- ``copy_lane``: one lane's leading KV slots into another's, in place (the
  scheduler's per-lane prefix cache on the contiguous layout).

With ``paged_kv`` the KV cache is the JAX engine's paged layout
(``models/llama.PagedKVCache``): one device pool of fixed-size pages, a
per-lane page table, and the host bookkeeping of ``runtime/kvpool.py``
(the ref-counted prefix tree, parking, the host swap tier). ``paged_admit``
maps a lane's pages (shared prefix pages by refcount, a copy-on-write page,
pages swapped back in from the host tier), ``paged_commit`` registers its
prompt blocks, ``paged_finish`` parks or frees them; ``export_kv_page`` and
``import_kv_page`` carry one page's bytes (K then V, row-major, in the
cache dtype: the JAX engine's bytes at the same geometry; an e4m3 page,
``cache_dtype=torch.float8_e4m3fn``, is half a bf16 page). Every table
write, page copy and swap-in is an in-place op on the compute stream from
pinned host memory: ordered after every step dispatched before it and
before every step after it, so an in-flight pipelined chain never sees a
half-written row. The decode graphs read the table as a static input.

Prompt chunks are padded to the same buckets as the JAX engine, so a chunk
runs the same product shapes there and here; a chunk's attention reads the
first ``attn_len`` cache slots of its own lane, a power of two of at least
64 (or ``seq_len``) past the chunk. A decode step attends over the whole
cache, as the JAX engine's compiled step does, through the attention
kernel (``ops/cuda_attn.py``), which reads each lane's own slots in an
order its position fixes: a lane's result never depends on which other
lanes share the step (a lane finished but read one step late, an
admission mid-prompt), so a stream is the same whichever family steps it
and whoever else is served. Sampling is the JAX engine's, on the device (``runtime/sampling.py``): the exact
full-vocab nucleus and a Gumbel-max draw with JAX's threefry bits under
``fold_in(PRNGKey(seed), pos)``, so seeded streams equal the JAX
package's. A sampled step's greedy/sampled pair comes back as one [2, n]
readback.

On a CUDA device the decode families run as CUDA graphs
(``runtime/graphs.py``), one per family (the step, the verify step and each
multi-step horizon) and whether a lane samples, captured at warmup (or at a
key's first use) from the same step bodies the CPU runs eagerly. Host inputs reach the card by non-blocking
copies from pinned memory and a pipelined step's tokens come back the same
way behind an event, so nothing in a pipelined dispatch waits on the card.
The prompt-chunk and fused families run eagerly on the stream, as does a
tensor-parallel mesh across cards or processes; a one-process mesh whose
ranks share one card is captured.

With a ``mesh`` (tp, dp, sp, ep; parallel/mesh.py) the engine holds
per-rank parameters and KV caches; sampling and the returned logits stay
on its first rank's device, so the scheduler sees one engine either way.
On a dp mesh lane b lives in dp group b // (n_lanes / dp): a lane-addressed
operation (a prompt chunk, ``copy_lane``) runs on that group's ranks only,
a decode family on every group, each over its own lanes. On a pod mesh
(parallel/multihost.py) the engine holds this process's ranks and opens the
pod's windows (parallel/window.py) at construction: every process runs the
same calls (the root's through ``RootControlEngine``, a worker's replayed
from its packets), takes the same ring steps, gets the whole logits and so
samples, masks and carries the same tokens.

Every dispatch family and the lagged consume fire the seeded fault plan
(``utils/faults.py``: ``engine.dispatch``, ``engine.consume``) after their
argument checks and before any device work; an unarmed process pays one
global read.

Grammar-constrained decoding (``grammar/``, the JAX engine's) runs inside
every step family, on every lane, every step: each lane carries an
automaton state (0 is FREE: an all-ones mask and a self-loop, so an
unconstrained lane's tokens are the plain ones bit for bit), its row is
masked by that state before the argmax and the nucleus sort
(``ops/cuda_grammar.mask_argmax``), and the state advances on the card by
the chosen token (``grammar_next``) like the position carry: a host state
of -1 reads the carry, >= 0 overrides it. The slab's tables live on rank
0's device in tensors of fixed shape and address, rewritten in place from
pinned memory when an admission changes the slab, so a new schema captures
no graph.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..analysis import jitcheck
from ..device import resolve_device
from ..grammar.slab import DEFAULT_SLAB_STATES, GrammarSlab
from ..models.config import LlamaConfig
from ..models.llama import (
    F8,
    LlamaParams,
    cache_bits,
    init_kv_cache,
    init_paged_kv_cache,
    llama_forward,
)
from ..ops import cuda_grammar
from ..ops.ring_collective import pod_installed, ring_counts, set_pod
from ..parallel.sharding import shard_kv_cache, shard_paged_kv_cache
from ..utils import faults
from .graphs import StepGraphs
from .kvpool import DEFAULT_MAX_PARKED, DEFAULT_PAGE_SIZE, KVPagePool
from .sampling import MASK32, sample_lanes
from .spec import SPEC_DRAFT, pow2_floor

DEFAULT_PREFILL_BUCKETS = (16, 64, 256, 1024)
DEFAULT_TOPP = 0.9
# bounded in-flight ring of the async decode pipeline (--pipeline-depth):
# 2 = consume step k while step k+1 runs; 0 or 1 disables pipelining
DEFAULT_PIPELINE_DEPTH = 2
ATTN_BUCKET_FLOOR = 64
# pages a swap gather or scatter moves at once
_SWAP_BATCH = 8


def attn_buckets(seq_len: int) -> tuple[int, ...]:
    """The attention lengths a prompt chunk may run: powers of two from 64
    below ``seq_len``, then ``seq_len``."""
    out = []
    b = ATTN_BUCKET_FLOOR
    while b < seq_len:
        out.append(b)
        b *= 2
    return tuple(out) + (seq_len,)


def _hist_bump(hist: dict, key) -> None:
    hist[key] = hist.get(key, 0) + 1


@dataclass
class EngineStats:
    """Per-call timing and transfer counters."""

    prefill_s: float = 0.0
    decode_s: float = 0.0
    prefill_tokens: int = 0
    decode_steps: int = 0
    host_bytes_in: int = 0  # device->host token/logit traffic
    multi_dispatches: int = 0  # decode_multi calls (h decode steps each)
    # speculative verify steps (one a dispatch, in the ring or not) and,
    # from the scheduler, which alone knows what it consumed: tokens
    # consumed from verify steps and (lane, step) pairs of lanes that
    # drafted, so emitted / lane_steps is the acceptance in [1, K + 1]
    spec_steps: int = 0
    spec_emitted: int = 0
    spec_lane_steps: int = 0
    spec_pipelined_steps: int = 0  # verify steps dispatched inside the ring
    spec_accept_hist: dict = field(default_factory=dict)  # drafted lanes' accept counts
    # async decode pipeline: host time between a step's dispatch and the
    # start of its readback (work the card's execution hid), steps
    # dispatched, chains cut short with lanes still live (an admission
    # with fused prefill is not one, so steady serving reads 0), and the
    # ring depth right after each dispatch
    overlap_s: float = 0.0
    pipeline_dispatches: int = 0
    pipeline_flushes: int = 0
    pipeline_depth_hist: dict = field(default_factory=dict)
    # stall-free admissions: fused prefill+decode dispatches, host time
    # decoding lanes waited behind admission work, and the prefill bucket
    # of each fused dispatch
    fused_steps: int = 0
    admission_stall_s: float = 0.0
    fused_bucket_hist: dict = field(default_factory=dict)
    # bytes the ring hop moved in the last decode step (a mesh's TP sync and
    # logits gather; 0 off-mesh), counted by the hop, not reckoned
    sync_bytes_per_decode: int = 0
    # per-lane prefix cache: admissions that copied another lane's KV
    # prefix, and the prompt tokens they did not prefill
    prefix_hits: int = 0
    prefix_tokens_saved: int = 0
    # grammar-constrained decoding: admissions that attached an automaton,
    # and dispatches that carried at least one constrained lane
    grammar_lanes: int = 0
    grammar_masked_steps: int = 0
    # a pod worker's supervised restarts and classified packet errors
    # (parallel/multihost.worker_serve)
    worker_restarts: int = 0
    worker_replay_errors: int = 0
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False,
                                 compare=False)

    def _counters(self) -> dict:
        # the histograms are copied: a snapshot must not change under its reader
        return {k: (dict(v) if isinstance(v, dict) else v)
                for k, v in self.__dict__.items() if k != "lock"}

    def snapshot(self) -> dict:
        with self.lock:
            return self._counters()

    def reset(self) -> "EngineStats":
        """Zero the window's counters and return what they held;
        ``sync_bytes_per_decode`` describes the step, not a window."""
        with self.lock:
            snap = EngineStats(**self._counters())
            keep = self.sync_bytes_per_decode
            self.__dict__.update(EngineStats()._counters())
            self.sync_bytes_per_decode = keep
        return snap

    @contextlib.contextmanager
    def preserved(self):
        """Restore every counter on exit (warmup traffic is not serving)."""
        snap = self.snapshot()
        try:
            yield self
        finally:
            with self.lock:
                self.__dict__.update(snap)


class InferenceEngine:
    # the scheduler reads these to pick its paths
    supports_pipelined = True
    supports_fused_prefill = True
    supports_multi_step = True
    supports_speculative = True
    supports_spec_pipelined = True
    # drafts per verify step (SPEC_DRAFT + 1 rows a lane)
    SPEC_DRAFT = SPEC_DRAFT

    def __init__(
        self,
        config: LlamaConfig,
        params: LlamaParams,
        n_lanes: int = 8,
        prefill_buckets: tuple[int, ...] = DEFAULT_PREFILL_BUCKETS,
        cache_dtype: torch.dtype | None = None,
        device="cuda",
        mesh=None,
        emulate_q80_activations: bool = False,
        q80_sync: bool = False,
        ring_sync: bool = True,
        pipeline_depth: int | None = None,
        paged_kv: bool = False,
        kv_page_size: int = DEFAULT_PAGE_SIZE,
        kv_pool_pages: int | None = None,
        kv_max_parked: int = DEFAULT_MAX_PARKED,
        kv_host_bytes: int = 0,
        grammar_slab_states: int | None = None,
    ):
        """``device`` defaults to CUDA and raises where there is none; tests
        pass ``device="cpu"``. The parameters must already live there.
        ``cache_dtype`` None: bf16 KV on the card, f32 on the CPU;
        ``torch.float8_e4m3fn`` (``--kv-dtype f8``) stores e4m3, written
        through ``_to_cache_dtype`` and read by the attention kernel's e4m3
        instantiation.

        With ``mesh`` (tensor parallel), ``params`` is the per-rank list of
        ``parallel.sharding.shard_params`` and the device is rank 0's, where
        sampling runs and logits land; the KV cache is split on kv heads.
        ``emulate_q80_activations``, ``q80_sync`` and ``ring_sync`` go to
        ``llama_forward``. ``pipeline_depth`` bounds the pipelined ring
        (None: 2; 0 or 1 turns the scheduler's pipelined path off).

        On a dp mesh ``n_lanes`` must split evenly over the dp groups.

        ``paged_kv`` (the JAX engine's ``--paged-kv on``): the KV cache is a
        pool of ``kv_page_size``-token pages (a power of two, shrunk to fit
        short contexts) behind per-lane page tables; ``kv_pool_pages``
        sizes the pool (None: the contiguous layout's footprint),
        ``kv_max_parked`` bounds parked sessions and ``kv_host_bytes``
        budgets the host swap tier (0 disables it). A dp or sp mesh
        refuses it.

        ``grammar_slab_states`` sizes the grammar slab (None: 1024 states;
        its edge capacity is the slab's default); structured output is off
        until ``grammar_init`` registers the tokenizer's pieces."""
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.devices[0])
        self.devices = [self.device] if mesh is None else list(mesh.devices)
        ranks = [params] if mesh is None else params
        for p in ranks:
            if p.device.type != self.device.type:
                raise ValueError(f"params on {p.device}, engine on {self.device}")
        self.config = config
        self.params = params
        self.n_lanes = n_lanes
        self.prefill_buckets = tuple(
            b for b in sorted(prefill_buckets) if b <= config.seq_len
        ) or (min(16, config.seq_len),)
        self.attn_buckets = attn_buckets(config.seq_len)
        if cache_dtype is None:
            cache_dtype = torch.float32 if self.device.type == "cpu" else torch.bfloat16
        self.cache_dtype = cache_dtype
        self.kvpool = None
        if paged_kv:
            if mesh is not None and (mesh.shape.get("dp", 1) > 1
                                     or mesh.shape.get("sp", 1) > 1):
                raise ValueError(
                    "paged_kv requires a pure-TP mesh (dp=1, sp=1): the "
                    "page pool replicates over dp and cannot shard over "
                    "sp — use --paged-kv off on dp/sp meshes"
                )
            self.kvpool = KVPagePool.for_seq_len(
                config.seq_len, n_lanes, page_size=kv_page_size, pool_pages=kv_pool_pages,
                max_parked=kv_max_parked, host_bytes=kv_host_bytes)
            # swap traffic, written on the scheduler loop thread only
            self.reset_swap_stats()
            pool = self.kvpool
            self._host_tables = np.asarray([pool.table_row([])] * n_lanes, np.int32)
            self.cache = init_paged_kv_cache(config, n_lanes, pool.n_pages, pool.page_size,
                                             n_blocks=pool.blocks_per_lane, dtype=cache_dtype,
                                             device=self.device)
            if mesh is not None:
                self.cache = shard_paged_kv_cache(self.cache, mesh)
        else:
            self.cache = init_kv_cache(config, n_lanes, dtype=cache_dtype, device=self.device)
            if mesh is not None:
                self.cache = shard_kv_cache(self.cache, mesh)
        self._forward_flags = {"emulate_q80_activations": emulate_q80_activations,
                               "mesh": mesh, "q80_sync": q80_sync, "ring_sync": ring_sync}
        self.stats = EngineStats()
        self.pipeline_depth = (DEFAULT_PIPELINE_DEPTH if pipeline_depth is None
                               else max(0, pipeline_depth))

        # the step families' static inputs: host tokens, host positions (-1
        # reads the carried position), seeds and grammar states (-1 reads
        # the carried state); temperatures and top-p; the verify step's
        # candidates and their counts; the pipeline's token, position and
        # grammar-state carry
        n = n_lanes
        self._in_i = torch.zeros((4, n), dtype=torch.int64, device=self.device)
        self._in_f = torch.zeros((2, n), dtype=torch.float32, device=self.device)
        self._drafts = torch.zeros((n, SPEC_DRAFT + 1), dtype=torch.int64, device=self.device)
        self._dlen = torch.zeros(n, dtype=torch.int64, device=self.device)
        self._feed = torch.zeros(n, dtype=torch.int64, device=self.device)
        self._cpos = torch.zeros(n, dtype=torch.int64, device=self.device)
        self._cg = torch.zeros(n, dtype=torch.int64, device=self.device)
        # the grammar slab (grammar/slab.py) and its tables on the device:
        # masks [S, ceil(V/32)] (uint32 words as int32), edge keys and
        # targets [E], default targets [S]; rewritten in place when the
        # slab's version moves, never reallocated (the graphs read them)
        self.grammar_slab = GrammarSlab(config.vocab_size,
                                        n_states=grammar_slab_states or DEFAULT_SLAB_STATES)
        self._g_vocab = None  # the tokenizer's piece table (grammar_init)
        self._g_vocab_key = None
        self._g_eos: tuple = ()
        self._g_tabs = tuple(torch.from_numpy(self._g_host_arrays()[i].copy()).to(self.device)
                             for i in range(4))
        self._g_version = self.grammar_slab.version
        # the masked rows the sampler sorts
        self._g_rows = torch.zeros((n, config.vocab_size), dtype=torch.float32,
                                   device=self.device)
        # a mesh across cards stays eager (its ranks' streams would join
        # the capture through events), as does a pod (its ring steps'
        # epochs change every step); one card, ranks on it included, is
        # captured
        one_card = self.device.type == "cuda" and all(d == self.device for d in self.devices)
        pod = mesh is not None and mesh.is_pod
        self.graphs = (StepGraphs(self.device, [self._feed, self._cpos, self._cg])
                       if one_card and not pod else None)
        self.pod = None
        self.kvshare = None
        self._page_writes = 0  # imports, swap-in batches and page copies made
        if pod:
            from ..parallel.kvshare import open_pool_share
            from ..parallel.multihost import agree, pod_store
            from ..parallel.window import open_windows

            # a process whose KV layout differs from its peers' stops here,
            # before either side waits for the other's pool planes
            agree("pod/kv_layout", self._kv_layout())
            local = dict(zip(mesh.local_ranks, mesh.devices))
            self.pod = open_windows(mesh.n_ranks, local, self.pod_slot_bytes(), pod_store())
            set_pod(self.pod)
            if self.kvpool is not None:
                # the pool planes shared with the peers: the root reads
                # their heads of the pages it exports or swaps out
                c0 = self.cache[0]
                self.kvshare = open_pool_share(mesh.n_ranks, local, tuple(c0.k.shape), c0.k.dtype,
                                               pod_store())
                for r, c in zip(mesh.local_ranks, self.cache):
                    c.k, c.v = self.kvshare.planes[r]
        elif mesh is not None and pod_installed():
            raise RuntimeError("this process runs a pod's ring steps: a mesh engine beside "
                               "it would take them through the pod's windows")
        # pipelined ring: (kind "tok" or "spec", host readback, ready event
        # or None, t_dispatch)
        self._pl_inflight: deque = deque()
        self._pl_seeded = False  # the device carry holds a chain's feed

    # -- helpers --------------------------------------------------------------

    def _staged(self, a, dtype=torch.int64) -> torch.Tensor:
        """A host array as a tensor to copy from: pinned on the card, so
        that the copy does not wait (a dispatch behind an in-flight step
        must not stall the host; the pinned block outlives the copy)."""
        t = torch.as_tensor(np.asarray(a)).to(dtype)
        return t if self.device.type == "cpu" else t.pin_memory()

    def _upload(self, a, dtype=torch.int64) -> torch.Tensor:
        """A host array on the engine's device, without waiting."""
        return self._staged(a, dtype).to(self.device, non_blocking=True)

    def pod_slot_bytes(self) -> int:
        """The largest ring step's wire bytes a pod window slot must hold:
        a prompt chunk's (or a verify window's) f32 wo/w2 chunk, or the
        verify step's f32 logits shard (the fused steps run their prompt
        chunk and their decode rows as two forwards)."""
        from ..quants.packed import PackedQ40

        rows = max(self.max_chunk(), self.n_lanes * (SPEC_DRAFT + 1))
        wcls = (self.params[0] if self.mesh is not None else self.params).wcls
        shard = (wcls.packed if isinstance(wcls, PackedQ40) else wcls).shape[-1]
        tp = 1 if self.mesh is None else self.mesh.tp
        return 4 * max(rows * (self.config.dim // tp), self.n_lanes * (SPEC_DRAFT + 1) * shard)

    def release_pod(self) -> None:
        """Take this engine's windows out of the ring steps (at the pod's
        stop); their memory goes with the process."""
        if self.pod is not None:
            set_pod(None)

    def _kv_layout(self) -> str:
        """The KV cache's layout as every process of a pod must share it."""
        if self.kvpool is None:
            return f"contiguous {self.cache_dtype}"
        pool = self.kvpool
        return (f"paged {pool.n_pages} pages x {pool.page_size} tokens, "
                f"{pool.blocks_per_lane} blocks/lane, {self.cache_dtype}")

    def pod_stats(self) -> dict:
        """A pod process's transport and window counters: ring steps,
        staging copies and pulls, waits and (when timed) the ms its streams
        waited; {} off a pod."""
        if self.pod is None:
            return {}
        return {"pod_transport": self.pod.transport,
                **{f"pod_ring_{k}": v for k, v in self.pod.stats.items()}}

    def _lane_group(self, lane: int) -> tuple[int | None, int]:
        """(the lane's dp group, None off a mesh; its index among the
        group's lanes)."""
        if self.mesh is None:
            return None, lane
        return divmod(lane, self.n_lanes // self.mesh.shape["dp"])

    def _lane_cache(self, lane: int):
        """One lane's cache as a batch of 1: on a mesh, a view on each rank
        of the lane's dp group, None on the other groups' ranks."""
        if self.mesh is None:
            return self.cache.lane(lane)
        d, local = self._lane_group(lane)
        return [c.lane(local) if self.mesh.coords(r)["dp"] == d else None
                for r, c in zip(self.mesh.local_ranks, self.cache)]

    def _chunk_attn(self, end: int) -> int:
        """The attention bucket of a prompt chunk ending at ``end``: the
        least bucket at or past it."""
        return next(b for b in self.attn_buckets if b >= end)

    def _fill(self, tokens, positions, temps, topps, seeds, g_states) -> None:
        """Host metadata into the static inputs (tokens None: keep the
        carry; else they reseed it: the JAX engine's ``_pl_feed``), after
        the grammar tables are brought up to the slab."""
        self._sync_gtab()
        n = self.n_lanes
        ints = np.empty((4, n), np.int64)
        ints[0] = 0 if tokens is None else np.asarray(tokens, np.int64)
        ints[1] = np.asarray(positions, np.int64)
        ints[2] = np.asarray(seeds, np.int64) & MASK32
        ints[3] = np.asarray(g_states, np.int64)
        self._in_i.copy_(self._staged(ints), non_blocking=True)
        self._in_f.copy_(self._staged(np.stack([temps, topps]), torch.float32),
                         non_blocking=True)
        if tokens is not None:
            self._feed.copy_(self._in_i[0])

    def _fill_drafts(self, drafts, draft_len) -> None:
        """The verify step's candidates [n, SPEC_DRAFT + 1] (column 0 the
        guess at the fed token) and counts into the static inputs."""
        self._drafts.copy_(self._staged(drafts), non_blocking=True)
        self._dlen.copy_(self._staged(draft_len), non_blocking=True)

    def _g_host_arrays(self) -> tuple:
        """The slab's arrays as the device tables hold them (the masks'
        uint32 words viewed as int32)."""
        masks, keys, targets, defaults = self.grammar_slab.arrays()
        return masks.view(np.int32), keys, targets, defaults

    def _sync_gtab(self) -> None:
        """Rewrite the device tables from the slab when its version moved
        (an admission installed a schema or evicted one; the JAX engine's
        ``_gtab``): one non-blocking copy a table from pinned memory on the
        stream, in place, so it is ordered after every step dispatched
        before it and before the dispatch that needs it, and the captured
        graphs keep their pointers."""
        if self._g_version == self.grammar_slab.version:
            return
        for dst, src in zip(self._g_tabs, self._g_host_arrays()):
            dst.copy_(self._staged(src, torch.int32), non_blocking=True)
        self._g_version = self.grammar_slab.version

    def _g_vec(self, g_states, reseed: bool) -> np.ndarray:
        """The grammar states of a pipelined dispatch: as given, else FREE
        on a reseed (there is no carry) and -1 (the carry) when chained, so
        an engine serving no constrained lane steps as before."""
        if g_states is not None:
            return np.asarray(g_states, np.int64)
        return np.full(self.n_lanes, 0 if reseed else -1, np.int64)

    def _defaults(self, temps, topps, seeds):
        n = self.n_lanes
        temps = np.zeros(n, np.float32) if temps is None else np.asarray(temps, np.float32)
        topps = (np.full(n, DEFAULT_TOPP, np.float32) if topps is None
                 else np.asarray(topps, np.float32))
        seeds = np.zeros(n, np.int64) if seeds is None else np.asarray(seeds, np.int64)
        return temps, topps, seeds

    # -- step bodies (captured as CUDA graphs on the card, eager on the CPU) --

    def _forward(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        logits, _ = llama_forward(
            self.config, self.params, tokens[:, None], positions[:, None], self.cache,
            **self._forward_flags,
        )
        return logits[:, 0, :]

    def _pick(self, step, positions, states, sample: bool):
        """(greedy, sampled) per lane: the argmax of the row masked by the
        lane's grammar state, and the nucleus draw from the masked row
        where ``sample`` (the host's "some lane samples"; the twin of the
        JAX engine's ``lax.cond``; the JAX engine masks before both)."""
        greedy = cuda_grammar.mask_argmax(
            step.contiguous(), states, self._g_tabs[0],
            masked_out=self._g_rows if sample else None)
        if not sample:
            return greedy, greedy
        temps, topps = self._in_f[0], self._in_f[1]
        return greedy, sample_lanes(self._g_rows, temps, topps, self._in_i[2], positions, greedy)

    def _g_next(self, states, tokens, walk: bool = False, out=None):
        """The grammar states after ``tokens`` [R, T] (``grammar_next``)."""
        _, keys, targets, defaults = self._g_tabs
        return cuda_grammar.grammar_next(states, tokens, keys, targets, defaults,
                                         self.config.vocab_size, walk=walk, out=out)

    def _step_body(self, sample: bool):
        """One decode step from the static inputs: positions and grammar
        states are the host's where >= 0, else the carry; the chosen
        tokens, the next positions and the states the chosen tokens lead to
        become the carry. Returns (logits [n, vocab], [2, n] int32 greedy
        and sampled rows)."""
        pos = torch.where(self._in_i[1] < 0, self._cpos, self._in_i[1])
        gs = torch.where(self._in_i[3] < 0, self._cg, self._in_i[3])
        step = self._forward(self._feed, pos)
        greedy, sampled = self._pick(step, pos, gs, sample)
        chosen = torch.where(self._in_f[0] == 0.0, greedy, sampled)
        self._feed.copy_(chosen)
        self._g_next(gs, chosen[:, None], out=self._cg)
        self._cpos.copy_(torch.clamp(pos + 1, max=self.config.seq_len))
        return step, torch.stack([greedy, sampled]).to(torch.int32)

    def _verify_body(self, sample: bool):
        """One speculative verify step from the static inputs (the JAX
        engine's ``_spec_verify_core``): the fed token and candidates 1..K
        at positions pos .. pos + K in one forward. Candidate 0 is the
        host's guess at the fed token; the others count only where it is
        right (on a reseed or a synchronous step it is the fed token), and
        only as many as leave every emitted token's row below seq_len.
        Acceptance is the leading run of candidates equal to the greedy
        token before them; row 0 samples where a lane's temperature is
        above 0 (its draft count is 0). The carry becomes the token after
        the accepted prefix and pos + emitted. Returns (row 0's logits
        [n, vocab], pack [n, K + 2] int32: the emitted tokens, then their
        count).

        Grammar (the JAX engine's ``_g_walk_greedy``): row t's state is the
        lane's state advanced by the fed tokens full[:, 1..t], which do not
        depend on the logits, so one ``grammar_next`` walk gives every
        row's state and one masked argmax takes all n x (K + 1) rows. Along
        the accepted prefix the fed tokens are the masked greedy ones, so
        the walk is exact; past it the states are junk nothing reads (an
        illegal candidate takes its state's default target, as in JAX). The
        state carry becomes the accepted prefix's state advanced by the
        token after it."""
        seq_len = self.config.seq_len
        k1 = SPEC_DRAFT + 1
        n = self.n_lanes
        pos = torch.where(self._in_i[1] < 0, self._cpos, self._in_i[1])
        gs = torch.where(self._in_i[3] < 0, self._cg, self._in_i[3])
        feed, drafts = self._feed, self._drafts
        hit0 = (drafts[:, 0] == feed) & (self._dlen > 0)
        eff = torch.where(hit0, self._dlen - 1, torch.zeros_like(self._dlen))
        eff = torch.minimum(eff, torch.clamp(seq_len - pos - 1, min=0))
        full = torch.cat([feed[:, None], drafts[:, 1:]], dim=1)
        steps = torch.arange(k1, device=pos.device)
        logits, _ = llama_forward(self.config, self.params, full, pos[:, None] + steps,
                                  self.cache, **self._forward_flags)
        gst = self._g_next(gs, full[:, 1:], walk=True)  # [n, K + 1]: row t's state
        greedy = cuda_grammar.mask_argmax(
            logits.reshape(n * k1, -1).contiguous(), gst.reshape(-1), self._g_tabs[0],
            masked_out=self._g_rows if sample else None, masked_every=k1).view(n, k1)
        match = (full[:, 1:] == greedy[:, :-1]).to(torch.int64)
        lead = torch.cumprod(match, dim=1)
        accepted = (lead * (steps[None, :-1] < eff[:, None])).sum(dim=1)
        n_emit = accepted + 1
        row0 = logits[:, 0, :]
        sampled0 = greedy[:, 0]
        if sample:  # row 0's masked rows, written by the masked argmax
            sampled0 = sample_lanes(self._g_rows, self._in_f[0], self._in_f[1], self._in_i[2],
                                    pos, greedy[:, 0])
        emitted = torch.cat([torch.where(self._in_f[0] > 0.0, sampled0, greedy[:, 0])[:, None],
                             greedy[:, 1:]], dim=1)
        nxt = emitted.gather(1, (n_emit - 1)[:, None])
        self._feed.copy_(nxt[:, 0])
        self._g_next(gst.gather(1, accepted[:, None])[:, 0], nxt, out=self._cg)
        self._cpos.copy_(torch.clamp(pos + n_emit, max=seq_len))
        return row0, torch.cat([emitted, n_emit[:, None]], dim=1).to(torch.int32)

    def _multi_body(self, h: int, sample: bool):
        """h chained steps: each lane feeds its greedy token at temperature
        0, else its draw, at position + 1, its grammar state advanced by
        it. Returns chosen [h, n] int32."""
        tok, pos, g = self._feed, self._in_i[1], self._in_i[3]
        chosen = []
        for _ in range(h):
            step = self._forward(tok, pos)
            greedy, sampled = self._pick(step, pos, g, sample)
            tok = torch.where(self._in_f[0] == 0.0, greedy, sampled)
            chosen.append(tok)
            g = self._g_next(g, tok[:, None])
            pos = pos + 1
        return torch.stack(chosen).to(torch.int32)

    def _run_step(self, sample: bool):
        body = lambda: self._step_body(sample)  # noqa: E731
        if self.graphs is None:
            return body()
        return self.graphs.run(("step", sample), body, ("step", sample))

    def _run_verify(self, sample: bool):
        body = lambda: self._verify_body(sample)  # noqa: E731
        if self.graphs is None:
            return body()
        return self.graphs.run(("spec", sample), body, ("spec", sample))

    def _run_multi(self, h: int, sample: bool):
        body = lambda: self._multi_body(h, sample)  # noqa: E731
        if self.graphs is None:
            return body()
        return self.graphs.run(("multi", h, sample), body, ("multi", sample))

    def capture_graphs(self, multi_step: int = 0, spec: bool = False) -> None:
        """Capture every decode-family graph serving can replay: the step,
        the verify step where ``spec`` and each multi-step horizon (powers
        of two from ``multi_step`` down to 2), with and without sampling.
        Nothing to do where the engine runs eagerly."""
        if self.graphs is None:
            return
        h = pow2_floor(multi_step)
        for sample in (False, True):
            self.graphs.ensure(("step", sample), lambda s=sample: self._step_body(s),
                               ("step", sample))
            if spec:
                self.graphs.ensure(("spec", sample), lambda s=sample: self._verify_body(s),
                                   ("spec", sample))
            for k in range(h.bit_length() - 1):
                hk = h >> k
                self.graphs.ensure(("multi", hk, sample),
                                   lambda hk=hk, s=sample: self._multi_body(hk, s),
                                   ("multi", sample))

    def _prefill_half(self, lane: int, chunk: list[int], start_pos: int,
                      temp: float, topp: float, seed: int, g_state: int):
        """One bucketed prompt chunk on one lane's cache, and its boundary
        token, picked from the last row masked by grammar state
        ``g_state`` (the admitting request's start state; 0 = FREE):
        (last logits [vocab], greedy, sampled) as device tensors."""
        n = len(chunk)
        bucket = self.bucket_for(n)
        padded = np.zeros(bucket, np.int64)
        padded[:n] = chunk
        positions = start_pos + np.arange(bucket, dtype=np.int64)
        logits, _ = llama_forward(
            self.config, self.params, self._upload(padded)[None, :],
            self._upload(positions)[None, :], self._lane_cache(lane),
            attn_len=self._chunk_attn(start_pos + n),
            logit_rows=self._upload([n - 1]), dp_group=self._lane_group(lane)[0],
            **self._forward_flags,
        )
        last = logits[0, 0]
        self._sync_gtab()
        masked = (torch.empty((1, last.shape[0]), dtype=torch.float32, device=last.device)
                  if temp > 0.0 else None)
        greedy = cuda_grammar.mask_argmax(last[None].contiguous(), self._upload([g_state]),
                                          self._g_tabs[0], masked_out=masked)
        sampled = greedy
        if temp > 0.0:  # a greedy admission skips the sampler
            sampled = sample_lanes(
                masked, self._upload([temp], torch.float32),
                self._upload([topp], torch.float32), self._upload([seed & MASK32]),
                self._upload([start_pos + n - 1]), greedy)
        return last, greedy[0], sampled[0]

    def _validate_chunk(self, chunk, start_pos: int) -> None:
        if not chunk:
            raise ValueError("prefill needs a non-empty prompt chunk")
        if len(chunk) > self.max_chunk():
            raise ValueError(f"chunk of {len(chunk)} exceeds bucket {self.max_chunk()}")
        if start_pos + len(chunk) > self.config.seq_len:
            raise ValueError(
                f"chunk of {len(chunk)} tokens at pos {start_pos} exceeds "
                f"seq_len {self.config.seq_len}"
            )

    # -- public API ---------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.prefill_buckets[-1]

    def max_chunk(self) -> int:
        return self.prefill_buckets[-1]

    @torch.inference_mode()
    def prefill_chunk(self, lane: int, chunk: list[int], start_pos: int,
                      temp: float = 0.0, topp: float = DEFAULT_TOPP, seed: int = 0,
                      g_state: int = 0):
        """One bucketed prompt chunk for one lane. Returns (last_logits
        [vocab] device tensor, greedy_token int, sampled_token int — equals
        greedy at temp 0); both tokens are picked under grammar state
        ``g_state`` (the request's start state on its final chunk)."""
        self._validate_chunk(chunk, start_pos)
        if not 0 <= lane < self.n_lanes:
            raise ValueError(f"lane {lane} out of range")
        faults.fire("engine.dispatch")
        t0 = time.perf_counter()
        last, greedy, sampled = self._prefill_half(lane, chunk, start_pos, temp, topp, seed,
                                                   g_state)
        toks = torch.stack([greedy, sampled]).to(torch.int32).cpu()
        with self.stats.lock:
            self.stats.host_bytes_in += toks.numel() * 4
            self.stats.prefill_s += time.perf_counter() - t0
            self.stats.prefill_tokens += len(chunk)
        return last, int(toks[0]), int(toks[1])

    def prefill(self, lane: int, tokens: list[int], start_pos: int = 0,
                temp: float = 0.0, topp: float = DEFAULT_TOPP, seed: int = 0,
                g_state: int = 0):
        """A whole prompt on one lane in bucketed chunks. Returns
        (last_logits [vocab], greedy_token int, total_positions)."""
        if not tokens:
            raise ValueError("prefill needs at least one token (empty prompt)")
        pos = start_pos
        remaining = list(tokens)
        last = greedy = None
        while remaining:
            chunk = remaining[: self.max_chunk()]
            remaining = remaining[len(chunk):]
            last, greedy, _ = self.prefill_chunk(
                lane, chunk, pos, temp=temp, topp=topp, seed=seed, g_state=g_state)
            pos += len(chunk)
        return last, greedy, pos

    def _check_sync(self) -> None:
        if self.pipeline_active:
            raise RuntimeError("a pipelined chain holds the token carry: flush it "
                               "(pipeline_flush) before a synchronous step")

    @torch.inference_mode()
    def decode(self, tokens, positions, temps=None, topps=None, seeds=None,
               want_logits: bool = True, g_states=None):
        """One decode step for all lanes. tokens/positions: int [n_lanes]
        (idle lanes at seq_len: their KV write lands in the scratch slot);
        ``g_states``: each lane's grammar state (None: all FREE).
        Returns (logits [n_lanes, vocab] device tensor or None, the unmasked
        rows; greedy np[n_lanes], sampled np[n_lanes] — equals greedy where
        temp 0), the pair in one [2, n] readback."""
        self._check_sync()
        temps, topps, seeds = self._defaults(temps, topps, seeds)
        positions = np.asarray(positions, np.int64)
        if positions.min() < 0:
            raise ValueError("decode positions must be >= 0")
        faults.fire("engine.dispatch")
        t0 = time.perf_counter()
        hop_bytes = ring_counts()["ring_hop_bytes"]
        self._fill(tokens, positions, temps, topps, seeds, self._g_vec(g_states, True))
        step, packed = self._run_step(bool(np.any(temps > 0)))
        toks = packed.cpu().numpy()
        with self.stats.lock:
            self.stats.host_bytes_in += toks.nbytes
            self.stats.decode_s += time.perf_counter() - t0
            self.stats.decode_steps += 1
            self.stats.sync_bytes_per_decode = ring_counts()["ring_hop_bytes"] - hop_bytes
        return (step.clone() if want_logits else None), toks[0], toks[1]

    @torch.inference_mode()
    def decode_multi(self, tokens, positions, temps=None, topps=None, seeds=None,
                     h: int = 8, g_states=None) -> np.ndarray:
        """``h`` chained decode steps for all lanes in one dispatch. Per
        lane and step the feed is its greedy token at temperature 0, else
        its draw (the same fold_in(seed, pos) draw h single steps make), at
        position + 1. Returns ``chosen`` np[h, n]: the token each lane feeds
        after step j. The caller consumes its next token plus chosen[:h-1]
        and adopts chosen[h-1]; steps past a lane's stop write junk KV above
        its committed tokens, rewritten before any query reads it; steps
        past seq_len write the scratch slot. ``g_states`` (None: all FREE)
        thread the steps as the position does."""
        self._check_sync()
        if h < 1:
            raise ValueError(f"horizon {h} < 1")
        temps, topps, seeds = self._defaults(temps, topps, seeds)
        positions = np.asarray(positions, np.int64)
        if positions.min() < 0:
            raise ValueError("decode positions must be >= 0")
        faults.fire("engine.dispatch")
        t0 = time.perf_counter()
        hop_bytes = ring_counts()["ring_hop_bytes"]
        self._fill(tokens, positions, temps, topps, seeds, self._g_vec(g_states, True))
        chosen = self._run_multi(h, bool(np.any(temps > 0))).cpu().numpy()
        with self.stats.lock:
            self.stats.host_bytes_in += chosen.nbytes
            self.stats.decode_s += time.perf_counter() - t0
            self.stats.decode_steps += h
            self.stats.multi_dispatches += 1
            self.stats.sync_bytes_per_decode = (ring_counts()["ring_hop_bytes"]
                                                - hop_bytes) // h
        return chosen

    @torch.inference_mode()
    def decode_spec(self, tokens, drafts, draft_len, positions, temps=None, topps=None,
                    seeds=None, want_logits: bool = True, g_states=None):
        """One speculative verify step for all lanes: each lane's next token
        plus up to SPEC_DRAFT drafted continuations in one forward.
        tokens/positions/draft_len: int [n_lanes]; drafts: [n_lanes,
        SPEC_DRAFT] (junk past draft_len). Greedy lanes emit their
        plain-decode stream exactly (the speculative-verification
        identity); temp > 0 lanes pass draft_len 0 and emit one sampled
        token. Per lane, draft_len <= seq_len - positions - 1 (the step
        clamps it there too). Returns (logits [n, vocab] of each lane's
        first row, device tensor, or None; emitted np[n, K + 1]; n_emit
        np[n]), the pack in one readback. ``g_states`` (None: all FREE)
        walk the window: each row's greedy is the masked one."""
        self._check_sync()
        temps, topps, seeds = self._defaults(temps, topps, seeds)
        n = self.n_lanes
        drafts = np.asarray(drafts, np.int64)
        if drafts.shape != (n, SPEC_DRAFT):
            raise ValueError(f"spec drafts shape {drafts.shape} != {(n, SPEC_DRAFT)}")
        positions = np.asarray(positions, np.int64)
        if positions.min() < 0:
            raise ValueError("decode positions must be >= 0")
        draft_len = np.asarray(draft_len, np.int64)
        faults.fire("engine.dispatch")
        t0 = time.perf_counter()
        hop_bytes = ring_counts()["ring_hop_bytes"]
        self._fill(tokens, positions, temps, topps, seeds, self._g_vec(g_states, True))
        # the synchronous form of the in-chain step: candidate 0 is the fed token
        self._fill_drafts(np.concatenate([np.asarray(tokens, np.int64)[:, None], drafts], 1),
                          np.where(draft_len > 0, draft_len + 1, 0))
        step, packed = self._run_verify(bool(np.any(temps > 0)))
        out = packed.cpu().numpy()
        with self.stats.lock:
            self.stats.host_bytes_in += out.nbytes
            self.stats.decode_s += time.perf_counter() - t0
            self.stats.decode_steps += 1
            self.stats.spec_steps += 1
            self.stats.sync_bytes_per_decode = ring_counts()["ring_hop_bytes"] - hop_bytes
        return (step.clone() if want_logits else None), out[:, :-1], out[:, -1]

    # -- the pipelined family -------------------------------------------------

    def pipeline_inflight(self) -> int:
        """Dispatched-but-unconsumed pipelined steps (ring occupancy)."""
        return len(self._pl_inflight)

    @property
    def pipeline_active(self) -> bool:
        """True while a chain holds state (in-flight steps or a device token
        carry): direct decode callers must flush first."""
        return len(self._pl_inflight) > 0 or self._pl_seeded

    def check_pipelined_dispatch(self, reseed: bool, positions=None, g_states=None) -> None:
        """Raise every host-side error a pipelined dispatch would, without
        dispatching."""
        if reseed and positions is not None and int(np.min(positions)) < 0:
            raise ValueError(
                "reseed dispatch with a -1 position: the carried-position "
                "select has no carry to read on a reseed — pass real "
                "positions for every lane"
            )
        if reseed and g_states is not None and int(np.min(g_states)) < 0:
            raise ValueError(
                "reseed dispatch with a -1 grammar state: the carried-"
                "state select has no carry to read on a reseed — pass "
                "real states (0 = unconstrained) for every lane"
            )
        if len(self._pl_inflight) >= max(1, self.pipeline_depth):
            raise RuntimeError(
                f"pipeline ring full (depth {self.pipeline_depth}): consume "
                "the oldest in-flight step before dispatching another"
            )
        if not reseed and not self._pl_seeded:
            raise RuntimeError(
                "no device token carry: seed the chain with tokens= "
                "(first dispatch after construction or a flush)"
            )

    def check_fused_dispatch(self, chunk, p_start: int, reseed: bool,
                             positions=None, g_states=None) -> None:
        """``check_pipelined_dispatch`` plus the prompt chunk's bounds."""
        if not chunk:
            raise ValueError("fused prefill needs a non-empty prompt chunk")
        self._validate_chunk(chunk, p_start)
        self.check_pipelined_dispatch(reseed, positions, g_states)

    def check_spec_drafts(self, drafts) -> None:
        """The in-chain verify step's draft shape, in one place."""
        shape = getattr(drafts, "shape", None)
        want = (self.n_lanes, SPEC_DRAFT + 1)
        if shape != want:
            raise ValueError(f"spec drafts shape {shape} != {want} (SPEC_DRAFT + 1 columns: "
                             "candidate 0 is the host's guess at the carry token itself)")

    def check_spec_pipelined_dispatch(self, drafts, reseed: bool, positions=None,
                                      g_states=None) -> None:
        """``check_pipelined_dispatch`` plus the draft shape."""
        self.check_spec_drafts(drafts)
        self.check_pipelined_dispatch(reseed, positions, g_states)

    def _dispatch_step(self, positions, temps, topps, seeds, tokens, g_states, drafts=None,
                       draft_len=None):
        """Fill the static inputs and run one step of the chain (the verify
        step where ``drafts`` are given); returns the step's int32 output,
        [2, n] or the [n, K + 2] pack (static on the card: read it before
        the next replay)."""
        hop_bytes = ring_counts()["ring_hop_bytes"]
        self._fill(tokens, positions, temps, topps, seeds,
                   self._g_vec(g_states, tokens is not None))
        sample = bool(np.any(temps > 0))
        if drafts is None:
            _, packed = self._run_step(sample)
        else:
            self._fill_drafts(drafts, draft_len)
            _, packed = self._run_verify(sample)
        self._pl_seeded = True
        with self.stats.lock:
            self.stats.sync_bytes_per_decode = ring_counts()["ring_hop_bytes"] - hop_bytes
        return packed

    def _enqueue(self, packed: torch.Tensor, kind: str = "tok") -> None:
        """The step's tokens into a pinned host buffer of their own without
        waiting (the card's copy is ordered behind the step), and the step
        into the ring, with its kind: "tok" for a [2, n(+1)] step, "spec"
        for an [n(+1), K + 2] verify pack."""
        if self.device.type == "cpu":
            self._pl_inflight.append((kind, packed.numpy().copy(), None, time.perf_counter()))
        else:
            host = torch.empty(tuple(packed.shape), dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            self._pl_inflight.append((kind, host, ready, time.perf_counter()))
        with self.stats.lock:
            self.stats.pipeline_dispatches += 1
            _hist_bump(self.stats.pipeline_depth_hist, len(self._pl_inflight))
            if kind == "spec":
                self.stats.spec_steps += 1
                self.stats.spec_pipelined_steps += 1

    @torch.inference_mode()
    def decode_pipelined(self, positions, temps=None, topps=None, seeds=None,
                         tokens=None, g_states=None) -> None:
        """Dispatch ONE pipelined decode step and return without reading
        anything back. ``tokens=None`` feeds the device carry (the previous
        step's where(temp == 0, greedy, sampled)); host ``tokens`` reseed
        it. A position of -1 reads the carried position, >= 0 overrides it
        (parked or admitting lanes at seq_len, every lane on a reseed).
        The ring holds at most ``pipeline_depth`` steps: consume the oldest
        before dispatching past it. Steps dispatched after a lane's
        not-yet-read stop write junk KV above its committed tokens.
        ``g_states`` follow the positions' rule (-1 reads the state carry;
        None: FREE on a reseed, the carry when chained)."""
        temps, topps, seeds = self._defaults(temps, topps, seeds)
        self.check_pipelined_dispatch(tokens is not None, positions, g_states)
        faults.fire("engine.dispatch")
        self._enqueue(self._dispatch_step(positions, temps, topps, seeds, tokens, g_states))

    @torch.inference_mode()
    def decode_prefill_fused(self, positions, temps=None, topps=None, seeds=None,
                             p_lane: int = 0, chunk: list[int] | None = None,
                             p_start: int = 0, p_temp: float = 0.0,
                             p_topp: float = DEFAULT_TOPP, p_seed: int = 0,
                             tokens=None, g_states=None, p_g: int = 0) -> None:
        """Dispatch one fused step into the ring: lane ``p_lane`` takes one
        prompt chunk (``prefill_chunk``'s math, its boundary token picked
        under grammar state ``p_g``) and every lane takes one pipelined
        decode step (``decode_pipelined``'s, with the admitting lane parked
        at seq_len by the caller). The carry slot of ``p_lane`` becomes the
        chunk's boundary token, its position the chunk's end and its
        grammar state ``p_g`` advanced by the boundary token, so after the
        final chunk the next dispatch feeds the admitted lane from the
        device. The readback is [2, n+1], the extra column the boundary
        greedy/sampled pair."""
        temps, topps, seeds = self._defaults(temps, topps, seeds)
        self.check_fused_dispatch(chunk, p_start, tokens is not None, positions, g_states)
        faults.fire("engine.dispatch")
        self._fused(positions, temps, topps, seeds, p_lane, chunk, p_start, p_temp, p_topp,
                    p_seed, tokens, g_states, p_g)

    def _fused(self, positions, temps, topps, seeds, p_lane, chunk, p_start, p_temp,
               p_topp, p_seed, tokens, g_states, p_g, drafts=None, draft_len=None) -> None:
        """A fused dispatch: the prompt chunk, then the chain's step (the
        verify step where ``drafts`` are given); the admitting lane's carry
        becomes the chunk's boundary token at the chunk's end with grammar
        state ``p_g`` advanced by it, and the boundary greedy/sampled pair
        rides the readback (an extra column of a [2, n] step, an extra row
        of a verify pack)."""
        _, p_greedy, p_sampled = self._prefill_half(p_lane, chunk, p_start, p_temp,
                                                    p_topp, p_seed, p_g)
        packed = self._dispatch_step(positions, temps, topps, seeds, tokens, g_states, drafts,
                                     draft_len)
        end = p_start + len(chunk)
        p_first = (p_greedy if p_temp == 0.0 else p_sampled)[None]
        self._feed[p_lane:p_lane + 1].copy_(p_first)
        self._g_next(self._upload([p_g]), p_first[:, None], out=self._cg[p_lane:p_lane + 1])
        self._cpos[p_lane:p_lane + 1].fill_(end)
        pair = torch.stack([p_greedy, p_sampled]).to(torch.int32)
        if drafts is None:
            self._enqueue(torch.cat([packed, pair[:, None]], dim=1))
        else:
            row = torch.cat([pair, pair.new_zeros(packed.shape[1] - 2)])
            self._enqueue(torch.cat([packed, row[None]], dim=0), kind="spec")
        bucket = self.bucket_for(len(chunk))
        with self.stats.lock:
            self.stats.fused_steps += 1
            self.stats.prefill_tokens += len(chunk)
            _hist_bump(self.stats.fused_bucket_hist, bucket)

    @torch.inference_mode()
    def decode_spec_pipelined(self, positions, drafts, draft_len, temps=None, topps=None,
                              seeds=None, tokens=None, g_states=None) -> None:
        """Dispatch ONE speculative verify step into the pipelined ring (the
        JAX engine's zero-flush composition of ``decode_spec`` and
        ``decode_pipelined``): the drafts are verified against the device's
        own token carry, each lane's accept count advances the position
        carry (pos + accepted + 1), and the readback is ``decode_spec``'s
        [n, K + 2] pack. ``drafts`` [n, SPEC_DRAFT + 1]: column 0 is the
        host's guess at the carry token (its index is one step behind the
        device; on a reseed it ships the feed), checked on the device
        before the rest count; ``draft_len`` counts the candidates with
        column 0, so a lane needs 2 or more to accept anything. Positions
        as in ``decode_pipelined`` (-1 reads the carry), grammar states too;
        the draft clamp near seq_len is on the device, from the carried
        positions."""
        temps, topps, seeds = self._defaults(temps, topps, seeds)
        self.check_spec_pipelined_dispatch(drafts, tokens is not None, positions, g_states)
        faults.fire("engine.dispatch")
        packed = self._dispatch_step(positions, temps, topps, seeds, tokens, g_states, drafts,
                                     draft_len)
        self._enqueue(packed, kind="spec")

    @torch.inference_mode()
    def decode_spec_prefill_fused(self, positions, drafts, draft_len, temps=None, topps=None,
                                  seeds=None, p_lane: int = 0, chunk: list[int] | None = None,
                                  p_start: int = 0, p_temp: float = 0.0,
                                  p_topp: float = DEFAULT_TOPP, p_seed: int = 0,
                                  tokens=None, g_states=None, p_g: int = 0) -> None:
        """``decode_spec_pipelined`` that also takes one prompt chunk for lane
        ``p_lane`` (``decode_prefill_fused``'s contract, ``p_g`` included).
        The readback is [n + 1, K + 2], the boundary greedy/sampled pair in
        the extra row's first two columns."""
        temps, topps, seeds = self._defaults(temps, topps, seeds)
        self.check_spec_drafts(drafts)
        self.check_fused_dispatch(chunk, p_start, tokens is not None, positions, g_states)
        faults.fire("engine.dispatch")
        self._fused(positions, temps, topps, seeds, p_lane, chunk, p_start, p_temp, p_topp,
                    p_seed, tokens, g_states, p_g, drafts, draft_len)

    def pipeline_consume(self):
        """Blocking readback of the OLDEST in-flight step, waiting on its
        event only. A plain or fused step returns (greedy np[n|n+1], sampled
        np[n|n+1]), a fused step's extra column the chunk's boundary pair;
        a verify step returns (emitted np[n(+1), K + 1], n_emit np[n(+1)]),
        ``decode_spec``'s readback, a fused one's boundary pair in
        emitted[-1, :2]. The caller knows which it dispatched."""
        if not self._pl_inflight:
            raise RuntimeError("pipeline ring empty: nothing to consume")
        faults.fire("engine.consume")
        kind, host, ready, dispatched_at = self._pl_inflight.popleft()
        t0 = time.perf_counter()
        if ready is not None:
            ready.synchronize()
            host = host.numpy().copy()
        t1 = time.perf_counter()
        with self.stats.lock:
            self.stats.host_bytes_in += host.nbytes
            self.stats.decode_s += t1 - t0
            self.stats.decode_steps += 1
            self.stats.overlap_s += max(0.0, t0 - dispatched_at)
        if kind == "spec":
            return host[:, :-1], host[:, -1]
        return host[0], host[1]

    def pipeline_flush(self, count: bool = True) -> int:
        """Drain every in-flight step (discarding its tokens) and drop the
        carry; the next dispatch reseeds. Returns how many steps were
        discarded; a non-zero drain counts as a flush unless ``count`` is
        False."""
        n = len(self._pl_inflight)
        while self._pl_inflight:
            self.pipeline_consume()
        self._pl_seeded = False
        if n and count:
            with self.stats.lock:
                self.stats.pipeline_flushes += 1
        return n

    def pipeline_abort(self) -> int:
        """Drop every in-flight step without reading it back, and the carry
        (the containment path after an engine failure). Counts a flush
        when steps were dropped."""
        n = len(self._pl_inflight)
        self._pl_inflight.clear()
        self._pl_seeded = False
        if n:
            with self.stats.lock:
                self.stats.pipeline_flushes += 1
        return n

    def lane_logits(self, logits, lane: int) -> np.ndarray:
        """One lane's row of a step's logits on the host, as f32 numpy (the
        host sampler's input; counted in ``host_bytes_in``)."""
        faults.fire("engine.transfer")
        out = logits[lane].float().cpu().numpy()
        with self.stats.lock:
            self.stats.host_bytes_in += out.nbytes
        return out

    @torch.inference_mode()
    def measured_sync_stats(self, steps: int = 4) -> dict:
        """A decode step's time split, measured: wall ms per step (host
        clock), device busy ms and the ring hop's device ms per step
        (``torch.profiler``, kernels on every rank), and the hop's share of
        the busy time. The JAX engine reads the same split from an XLA
        trace. Every lane steps at ``seq_len``, so the steps write only the
        scratch slot and no committed KV; the counters are restored. Off a
        mesh, or where the profiler records no device time (the CPU), the
        split is None and only ``step_ms`` is measured."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        park = np.full(self.n_lanes, self.config.seq_len, np.int64)
        z = np.zeros(self.n_lanes, np.int64)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with self.stats.preserved():
            self.decode(z, park, want_logits=False)
            t0 = time.perf_counter()
            for _ in range(steps):
                self.decode(z, park, want_logits=False)  # reads back: synchronized
            out = {"step_ms": (time.perf_counter() - t0) * 1e3 / steps}
            with profile(activities=activities) as prof:
                for _ in range(steps):
                    self.decode(z, park, want_logits=False)
        busy = hop = 0.0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0.0) or 0.0
            if e.device_type == DeviceType.CPU or us <= 0:
                continue
            busy += us
            if "ring_seg_kernel" in e.key or "ring_step2_kernel" in e.key:
                hop += us
        if busy <= 0 or self.mesh is None:
            out.update(device_busy_ms=None, sync_ms=None, sync_frac=None,
                       source="wall-only")
            return out
        out.update(device_busy_ms=busy / 1e3 / steps, sync_ms=hop / 1e3 / steps,
                   sync_frac=hop / busy, source="torch.profiler")
        return out

    @torch.inference_mode()
    def sample_token(self, logits_row, temp: float, topp: float, seed: int,
                     pos: int) -> int:
        """Sample from one [vocab] logits row with the decode sampler."""
        row = torch.as_tensor(logits_row, dtype=torch.float32).to(self.device)
        greedy = torch.argmax(row)[None]
        tok = greedy
        if temp > 0.0:
            tok = sample_lanes(row[None], self._upload([temp], torch.float32),
                               self._upload([topp], torch.float32),
                               self._upload([seed & MASK32]), self._upload([pos]), greedy)
        with self.stats.lock:
            self.stats.host_bytes_in += 4
        return int(tok[0])

    # -- grammar-constrained decoding (grammar/) -------------------------------

    @property
    def supports_grammar(self) -> bool:
        """True once ``grammar_init`` registered a piece table: the scheduler
        gates ``response_format`` requests on it."""
        return self._g_vocab is not None

    def grammar_init(self, token_table, eos_ids) -> None:
        """Register the tokenizer's piece table (raw bytes per token id, None
        for special tokens) and EOS ids, what the automaton compiler walks.
        Model vocab padding beyond the table compiles as illegal everywhere.
        Without this call ``response_format`` requests are refused (the
        --grammar off escape hatch)."""
        from ..grammar.automaton import vocab_fingerprint

        table = list(token_table)[: self.config.vocab_size]
        table += [None] * (self.config.vocab_size - len(table))
        self._g_vocab = table
        self._g_vocab_key = vocab_fingerprint(table)
        self._g_eos = tuple(int(e) for e in eos_ids)

    def grammar_attach(self, rf: dict):
        """Compile ``response_format`` (cached per vocab and schema) and
        install it into the slab; returns the ``SlabHandle`` whose
        ``start_state`` seeds the lane's state. Raises ``GrammarError`` (a
        ``ValueError``: a 400) on a bad schema or when structured output is
        off, and ``GrammarSlabFull`` when live schemas fill the slab (load:
        the scheduler sheds it retryably). The device tables follow at the
        next dispatch."""
        if self._g_vocab is None:
            raise ValueError(
                "structured output is disabled on this engine "
                "(--grammar off, or no tokenizer vocab registered)"
            )
        from ..grammar.automaton import compile_automaton

        auto = compile_automaton(rf, self._g_vocab, self._g_eos, vocab_key=self._g_vocab_key)
        handle = self.grammar_slab.attach(auto)
        with self.stats.lock:
            self.stats.grammar_lanes += 1
        return handle

    def grammar_detach(self, key: str) -> None:
        """Release one attach reference (the tables park for the next
        same-schema admission; evicted only under slab pressure)."""
        self.grammar_slab.detach(key)

    def grammar_stats(self) -> dict:
        """The slab's pressure for /stats; {} when structured output is off."""
        return self.grammar_slab.stats() if self._g_vocab is not None else {}

    def reset_lane(self, lane: int) -> None:
        """Nothing to clear: a new request's prefill rewrites the lane from
        its first unshared position, and reads are masked to s <= pos."""

    @torch.inference_mode()
    def copy_lane(self, src: int, dst: int, prefix_len: int | None = None) -> None:
        """Copy lane ``src``'s KV slots [0, prefix_len) (all of them where
        None) into lane ``dst`` (the per-lane prefix cache: an admission
        sharing a prompt prefix with tokens resident in ``src`` prefills
        only its tail). An in-place copy on the stream, one per K and V
        plane of each rank, into the planes the decode graphs captured:
        ordered after every step dispatched before it and before every
        step after it. ``src == dst`` or a zero length moves nothing."""
        if self.kvpool is not None:
            raise RuntimeError(
                "copy_lane is the contiguous layout's primitive; a paged "
                "engine shares prefix pages by refcount via paged_admit"
            )
        if not (0 <= src < self.n_lanes and 0 <= dst < self.n_lanes):
            raise ValueError(f"copy_lane({src}, {dst}) outside {self.n_lanes} lanes")
        n = self.config.seq_len if prefix_len is None else int(prefix_len)
        if src == dst or n <= 0:
            return
        if self.mesh is None:
            for plane in (self.cache.k, self.cache.v):
                plane = cache_bits(plane)
                plane[:, dst, :n].copy_(plane[:, src, :n])
            return
        # each rank of dst's dp group takes its block's share of the slots
        # from the rank of src's group at the same tp, sp and ep coordinates
        mesh = self.mesh
        (ds, ls), (dd, ld) = self._lane_group(src), self._lane_group(dst)
        held = dict(zip(mesh.local_ranks, self.cache))
        blk = self.config.seq_len // mesh.shape["sp"]
        for r, c in held.items():
            co = mesh.coords(r)
            if co["dp"] != dd:
                continue
            m = min(blk, n - co["sp"] * blk)
            if m <= 0:
                continue
            sc = held[mesh.rank(**{**co, "dp": ds})]
            for to, frm in ((c.k, sc.k), (c.v, sc.v)):
                cache_bits(to)[:, ld, :m].copy_(cache_bits(frm)[:, ls, :m])

    # -- the paged KV pool (runtime/kvpool.py): the host/device seam ----------

    def _caches(self) -> list:
        """This process's ranks' caches (a pod's other ranks' are not
        here)."""
        return [self.cache] if self.mesh is None else list(self.cache)

    def _ranks(self) -> list:
        """The global rank of each of ``_caches()``."""
        return [0] if self.mesh is None else list(self.mesh.local_ranks)

    def _head_caches(self) -> list:
        """Each tp slice's cache once, in tp order (on an ep mesh its ep 0
        copy: the others hold the same heads): a page's heads in order."""
        return [c for r, c in zip(self._ranks(), self._caches())
                if self.mesh is None or self.mesh.coords(r)["ep"] == 0]

    def _need_paged(self, what: str) -> None:
        if self.kvpool is None:
            raise RuntimeError(f"{what} needs a paged engine")

    @torch.inference_mode()
    def _write_tables(self) -> None:
        """The host table mirror into this process's ranks' device tables,
        in place (the graphs captured these tensors): one non-blocking copy
        from pinned memory on each table's stream, ordered between the
        steps around it. Ranks on one device share their table."""
        tables = {id(c.table): c.table for c in self._caches()}
        for tb in tables.values():
            tb.copy_(self._staged(self._host_tables, torch.int32), non_blocking=True)

    @torch.inference_mode()
    def _copy_page(self, src: int, dst: int) -> None:
        """One page's K and V, every layer and this process's ranks, from
        ``src`` to ``dst``: the copy-on-write unit (the JAX engine's
        ``_copy_page``). Slots past the divergence point carry the source's
        content, which the tail prefill rewrites before any query reads
        them."""
        for c in self._caches():
            for plane in (c.k, c.v):
                plane = cache_bits(plane)
                plane[:, dst].copy_(plane[:, src])
        self._wrote_pages()

    def _wrote_pages(self) -> None:
        """Count a page write; on a pod, tell the peers (their reads of this
        process's heads wait for it: parallel/kvshare.py)."""
        self._page_writes += 1
        if self.kvshare is not None:
            self.kvshare.post(self._page_writes)

    def apply_paged_admit(self, lane: int, row, copies) -> None:
        """Device half of a paged admission (or release): the COW page
        ``copies``, then lane ``lane``'s new table ``row``, each ordered
        before any later-dispatched prefill or step."""
        self._need_paged("apply_paged_admit")
        for src, dst in copies:
            self._copy_page(int(src), int(dst))
        self._host_tables[lane] = row
        self._write_tables()

    def paged_admit(self, lane: int, tokens, reserve_tokens: int, min_share_tokens: int = 1,
                    share_quantum: int = 1) -> int:
        """Reserve lane ``lane``'s pages for a request (prompt ``tokens``,
        whole potential range ``reserve_tokens``) and apply the device
        half. Returns ``start``, the prompt tokens already resident through
        the prefix tree (``KVPagePool.admit``; ``share_quantum`` cuts it to
        whole quanta); the caller prefills ``tokens[start:]``. Raises
        ``PoolExhausted`` when the pool cannot serve the reservation even
        after evicting parked sessions. Order: (1) the admission may evict
        parked pages and stage them for swap-out; (2) those drain (device
        read, host tier) before anything writes; (3) host-tier hits swap
        back in; (4) the COW copy and the table row apply."""
        self._need_paged("paged_admit")
        start, blocks, copies, swapins = self.kvpool.admit(
            lane, list(tokens), reserve_tokens, min_share_tokens, share_quantum)
        self.drain_kv_swapouts()
        if swapins:
            self.swap_in_pages([p for p, _ in swapins], [b for _, b in swapins])
        self.apply_paged_admit(lane, self.kvpool.table_row(blocks), copies)
        return start

    def paged_commit(self, lane: int, tokens) -> None:
        """Register lane ``lane``'s committed tokens' full blocks into the
        prefix tree (host bookkeeping: the KV is on the card already)."""
        self._need_paged("paged_commit")
        self.kvpool.commit(lane, list(tokens))

    def paged_finish(self, lane: int, park: bool = True) -> None:
        """Release lane ``lane``'s pages at request end: ``park`` keeps its
        tree-registered blocks resident for later sharing, else all free
        (the failure path). The lane's row goes all-unmapped, skipped when
        the lane held nothing (a shed admission). Parking may overflow the
        LRU bound and stage swap-outs, drained here before the unmap."""
        self._need_paged("paged_finish")
        held = self.kvpool.finish(lane, park=park)
        self.drain_kv_swapouts()
        if held:
            self.apply_paged_admit(lane, self.kvpool.table_row([]), [])

    def paged_unmap_all(self) -> None:
        """Every lane's table row all-unmapped (this process's tables)."""
        self._need_paged("paged_unmap_all")
        self._host_tables[:] = self.kvpool.table_row([])
        self._write_tables()

    def paged_reset(self) -> None:
        """Containment: after an engine-scoped failure the pool's contents
        are not trusted: drop every mapping, parked session and tree node,
        and unmap every lane."""
        self._need_paged("paged_reset")
        self.kvpool.reset()
        self.paged_unmap_all()

    def pool_stats(self) -> dict:
        """The pool's pressure snapshot for /stats (bridged to /metrics)
        with the engine's swap traffic beside it; ``{}`` on a contiguous
        engine."""
        if self.kvpool is None:
            return {}
        out = self.kvpool.stats()
        out.update({
            "swap_ins": self.swap_ins,
            "swap_outs": self.swap_outs,
            "swap_in_bytes": self.swap_in_bytes,
            "swap_out_bytes": self.swap_out_bytes,
            "swap_in_ms": round(self.swap_in_ms, 3),
            "kv_exports": self.kv_exports,
            "kv_export_ms": round(self.kv_export_ms, 3),
            # imports, swap-in batches and page copies: a pod's worker
            # makes the same ones (its worker_exit line)
            "kv_page_writes": self._page_writes,
        })
        return out

    def _page_geometry(self) -> tuple[tuple, torch.dtype, int]:
        """One page's K (or V) shape [L, page, n_kv, hd] (all ranks' heads),
        dtype and byte size."""
        k = self._caches()[0].k
        shape = (k.shape[0], k.shape[2], self.config.n_kv_heads, k.shape[4])
        return shape, k.dtype, int(np.prod(shape)) * k.element_size()

    def kv_page_bytes(self) -> int:
        """One page's payload size (K then V, every layer and kv head, in
        the cache dtype): what ``export_kv_page`` gives and
        ``import_kv_page`` takes."""
        self._need_paged("kv_page_bytes")
        return 2 * self._page_geometry()[2]

    def _read_pages(self, pages: list[int]) -> list[bytes]:
        """Pages' K then V bytes, each [L, page, n_kv, hd] row-major, every
        rank's heads joined in rank order (on a pod the peers' through the
        pool share's read, parallel/kvshare.py, once they have made every
        page write this process made): one gather a plane and rank on the
        card, one copy into pinned host memory (a host sync, after every
        step before it). A pod's read whose peer died raises."""
        idx = torch.as_tensor(pages, dtype=torch.int64)
        if self.kvshare is not None:
            heads = self.kvshare.read(idx, self._page_writes)
        else:
            heads = [tuple(cache_bits(p).index_select(1, idx.to(p.device)) for p in (c.k, c.v))
                     for c in self._head_caches()]
        # [L, n, page, n_kv, hd] a plane
        planes = [torch.cat([kv[j].to(self.device) for kv in heads], dim=3) for j in (0, 1)]
        # [n, K/V, L, page, n_kv, hd]: each page's K then V, contiguous
        joined = torch.stack(planes).permute(2, 0, 1, 3, 4, 5).contiguous()
        host = torch.empty(joined.shape, dtype=joined.dtype,
                           pin_memory=self.device.type == "cuda")
        host.copy_(joined)
        if self.kvshare is not None:
            self.kvshare.check_peers()
        raw = host.view(torch.uint8).reshape(len(pages), -1).numpy()
        return [raw[i].tobytes() for i in range(len(pages))]

    @torch.inference_mode()
    def _write_pages(self, pages: list[int], payloads: list[bytes]) -> None:
        """Write pages' K then V bytes (``_read_pages``' encoding, every
        rank's heads) into this process's ranks' planes, in place, each
        rank its own heads by its tp coordinate: one non-blocking copy from
        pinned memory a device, then one indexed copy a plane and rank,
        ordered before every later dispatch."""
        shape, dtype, _ = self._page_geometry()
        raw = torch.frombuffer(bytearray().join(payloads), dtype=torch.uint8)
        # an e4m3 page moves as its bytes (cache_bits)
        host = (raw if dtype == F8 else raw.view(dtype)).reshape((len(pages), 2) + shape)
        if self.device.type == "cuda":
            host = host.pin_memory()
        heads = self._caches()[0].k.shape[3]
        on_device: dict = {}
        for r, c in zip(self._ranks(), self._caches()):
            if c.k.device not in on_device:
                on_device[c.k.device] = host.to(c.k.device, non_blocking=True)
            t = r if self.mesh is None else self.mesh.coords(r)["tp"]
            src = on_device[c.k.device][..., t * heads:(t + 1) * heads, :]
            idx = torch.as_tensor(pages, dtype=torch.int64).to(c.k.device)
            for j, plane in enumerate((c.k, c.v)):
                # [n, L, page, heads, hd] -> [L, n, page, heads, hd]
                cache_bits(plane).index_copy_(1, idx, src[:, j].transpose(0, 1))
        self._wrote_pages()

    def _check_payloads(self, payloads) -> None:
        shape, dtype, half = self._page_geometry()
        for i, data in enumerate(payloads):
            if len(data) != 2 * half:
                raise ValueError(f"kv page payload {i} is {len(data)} bytes, expected "
                                 f"{2 * half} for page geometry {shape} {dtype}")

    def export_kv_page(self, page: int) -> bytes:
        """Physical page ``page``'s K then V bytes, raw row-major [L, page,
        n_kv, hd] in the cache dtype (the JAX engine's encoding). A host
        sync: it runs on committed pages, whose bytes are stable."""
        self._need_paged("export_kv_page")
        t0 = time.perf_counter()
        out = self._read_pages([int(page)])[0]
        self.kv_exports += 1
        self.kv_export_ms += (time.perf_counter() - t0) * 1000.0
        return out

    def import_kv_page(self, page: int, payload: bytes) -> None:
        """Write a page's K then V bytes (``export_kv_page``'s encoding)
        into physical page ``page``, ordered before every later dispatch.
        Raises ``ValueError`` on a size mismatch before touching the card."""
        self._need_paged("import_kv_page")
        self._check_payloads([payload])
        self._write_pages([int(page)], [bytes(payload)])

    def swap_out_pages(self, pages) -> list:
        """Pages' bytes for the host swap tier (``export_kv_page``'s
        encoding), ``_SWAP_BATCH`` pages a gather. A host sync by design:
        the pages just left the pool, their bytes are stable."""
        self._need_paged("swap_out_pages")
        pages = [int(p) for p in pages]
        out: list = []
        for off in range(0, len(pages), _SWAP_BATCH):
            out.extend(self._read_pages(pages[off:off + _SWAP_BATCH]))
        return out

    def swap_in_pages(self, pages, payloads) -> None:
        """Write swapped pages back (the inverse of ``swap_out_pages``):
        every payload is size-checked before anything is written, then
        ``_SWAP_BATCH`` pages a scatter, ordered before the tail prefill.
        Raises ``ValueError`` on a size or count mismatch."""
        self._need_paged("swap_in_pages")
        if len(pages) != len(payloads):
            raise ValueError(f"swap_in_pages: {len(pages)} pages vs {len(payloads)} payloads")
        if not pages:
            return
        self._check_payloads(payloads)
        t0 = time.perf_counter()
        pages = [int(p) for p in pages]
        for off in range(0, len(pages), _SWAP_BATCH):
            self._write_pages(pages[off:off + _SWAP_BATCH],
                              list(payloads[off:off + _SWAP_BATCH]))
        self.swap_ins += len(pages)
        self.swap_in_bytes += sum(len(b) for b in payloads)
        self.swap_in_ms += (time.perf_counter() - t0) * 1000.0

    def drain_kv_swapouts(self) -> int:
        """Move the pool's staged swap-outs into the host tier: take the
        pending (node key, block, page) triples, read the pages and store
        each payload under its chain key, before any write that could
        reuse the pages. A failed read discards the batch and re-raises (the
        sessions then rebuild from the journal); an over-budget put drops.
        Returns how many pages the tier stored."""
        if self.kvpool is None or not self.kvpool.host_tier.enabled:
            return 0
        tier = self.kvpool.host_tier
        pending = self.kvpool.take_pending_swapouts()
        if not pending:
            return 0
        try:
            payloads = self.swap_out_pages([p for _, _, p in pending])
        except BaseException:
            for node_key, _blk, _page in pending:
                tier.discard(node_key)
            raise
        stored = sum(1 for (node_key, blk, _), payload in zip(pending, payloads)
                     if tier.put(node_key, blk, payload))
        self.swap_outs += len(pending)
        self.swap_out_bytes += sum(len(b) for b in payloads)
        return stored

    def swap_out_parked(self) -> int:
        """Evict every parked session into the host tier (the swap tier's
        lever; pressure eviction takes the same path). Returns how many
        sessions were evicted."""
        if self.kvpool is None:
            return 0
        n = self.kvpool.swap_out_parked()
        self.drain_kv_swapouts()
        return n

    def reset_swap_stats(self) -> None:
        """Zero the swap-traffic and page-export counters."""
        self.swap_ins = 0
        self.swap_outs = 0
        self.swap_in_bytes = 0
        self.swap_out_bytes = 0
        self.swap_in_ms = 0.0
        self.kv_exports = 0  # export_kv_page calls and their host ms
        self.kv_export_ms = 0.0


def parked_step_ms(engine, steps: int = 8, timer=None) -> float:
    """Host ms of an eager decode step with every lane parked at seq_len
    (the scratch slot), greedy, no logits kept, each step read back: one
    untimed step, then ``steps`` timed. ``timer`` (a pod's windows) starts
    timing its ring waits before the timed steps. The engine's counters are
    restored; the kernel counters are not."""
    n = engine.n_lanes
    park = np.full(n, engine.config.seq_len, np.int64)
    z = np.zeros(n, np.int64)
    with engine.stats.preserved():
        engine.decode(z, park, want_logits=False)
        if timer is not None:
            timer.start_timing()
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.decode(z, park, want_logits=False)
        return (time.perf_counter() - t0) * 1e3 / steps


def warmup_engine(engine: InferenceEngine, spec: bool = True, multi_step: int = 0,
                  pipeline: bool = True) -> None:
    """Run every serving program once before serving, so that no request
    pays a kernel build or a graph capture: each prefill bucket, every
    decode-family graph (the step, the verify step where ``spec`` and each
    multi-step horizon from ``multi_step`` down to 2, greedy and sampled),
    the synchronous verify step, the pipelined step and verify step in
    their reseed and chained forms and the fused steps per prefill bucket.
    The counters are restored afterwards; the junk KV lands in slots
    admission rewrites. Captures here never count against the recompile
    witness (``analysis/jitcheck.py``)."""
    n = engine.n_lanes
    z = np.zeros(n, np.int64)
    spec = spec and getattr(engine, "supports_speculative", False)
    spec_pl = spec and getattr(engine, "supports_spec_pipelined", False)
    with jitcheck.warming(), engine.stats.preserved():
        for bucket in engine.prefill_buckets:
            engine.prefill_chunk(0, [0] * bucket, 0)
        multi = multi_step if getattr(engine, "supports_multi_step", False) else 0
        engine.capture_graphs(multi, spec=spec)
        engine.decode(z, z)
        engine.decode(z, z, temps=np.full(n, 0.7, np.float32), seeds=np.ones(n, np.int64))
        if spec:
            engine.decode_spec(z, np.zeros((n, engine.SPEC_DRAFT), np.int64), z, z)
        h = pow2_floor(multi)
        while h > 1:
            engine.decode_multi(z, z, h=h)
            h //= 2
        if pipeline and engine.supports_pipelined and engine.pipeline_depth > 1:
            neg = np.full(n, -1, np.int64)
            engine.decode_pipelined(z, tokens=z)
            engine.decode_pipelined(neg)
            engine.pipeline_flush()
            k1 = engine.SPEC_DRAFT + 1
            if spec_pl:
                engine.decode_spec_pipelined(z, np.zeros((n, k1), np.int64), z, tokens=z)
                engine.decode_spec_pipelined(neg, np.zeros((n, k1), np.int64), z)
                engine.pipeline_flush()
            if engine.supports_fused_prefill:
                park = np.full(n, engine.config.seq_len, np.int64)
                for bucket in engine.prefill_buckets:
                    engine.decode_prefill_fused(park, p_lane=0, chunk=[0] * bucket, tokens=z)
                    engine.decode_prefill_fused(neg, p_lane=0, chunk=[0] * bucket)
                    engine.pipeline_flush()
                    if spec_pl:
                        engine.decode_spec_prefill_fused(
                            park, np.zeros((n, k1), np.int64), z, p_lane=0,
                            chunk=[0] * bucket, tokens=z)
                        engine.decode_spec_prefill_fused(
                            neg, np.zeros((n, k1), np.int64), z, p_lane=0, chunk=[0] * bucket)
                        engine.pipeline_flush()
    # a pod root: its eager step timed through the proxy (the workers
    # replay it), then the workers drop the replayed warmup traffic and the
    # probe's from their counters too
    reset_workers = getattr(engine, "reset_worker_stats", None)
    if reset_workers is not None:
        engine.measure_pod_step()
        reset_workers()
