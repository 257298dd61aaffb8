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
  scheduler's per-lane prefix cache).

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
tensor-parallel mesh across cards; a mesh whose ranks share one card is
captured.

With a tensor-parallel ``mesh`` the engine holds per-rank parameters and
KV caches; sampling and the returned logits stay on rank 0's device, so the
scheduler sees one engine either way.

Every dispatch family and the lagged consume fire the seeded fault plan
(``utils/faults.py``: ``engine.dispatch``, ``engine.consume``) after their
argument checks and before any device work; an unarmed process pays one
global read.

The paged and grammar families are later work, which the ``supports_*``
flags say to the scheduler.
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
from ..models.config import LlamaConfig
from ..models.llama import LlamaParams, init_kv_cache, llama_forward
from ..ops.ring_collective import ring_counts
from ..parallel.sharding import shard_kv_cache
from ..utils import faults
from .graphs import StepGraphs
from .sampling import MASK32, sample_lanes
from .spec import SPEC_DRAFT, pow2_floor

DEFAULT_PREFILL_BUCKETS = (16, 64, 256, 1024)
DEFAULT_TOPP = 0.9
# bounded in-flight ring of the async decode pipeline (--pipeline-depth):
# 2 = consume step k while step k+1 runs; 0 or 1 disables pipelining
DEFAULT_PIPELINE_DEPTH = 2
ATTN_BUCKET_FLOOR = 64


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
    supports_grammar = False
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
    ):
        """``device`` defaults to CUDA and raises where there is none; tests
        pass ``device="cpu"``. The parameters must already live there.
        ``cache_dtype`` None: bf16 KV on the card, f32 on the CPU.

        With ``mesh`` (tensor parallel), ``params`` is the per-rank list of
        ``parallel.sharding.shard_params`` and the device is rank 0's, where
        sampling runs and logits land; the KV cache is split on kv heads.
        ``emulate_q80_activations``, ``q80_sync`` and ``ring_sync`` go to
        ``llama_forward``. ``pipeline_depth`` bounds the pipelined ring
        (None: 2; 0 or 1 turns the scheduler's pipelined path off)."""
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
        self.cache = init_kv_cache(config, n_lanes, dtype=cache_dtype, device=self.device)
        if mesh is not None:
            self.cache = shard_kv_cache(self.cache, mesh)
        self._forward_flags = {"emulate_q80_activations": emulate_q80_activations,
                               "mesh": mesh, "q80_sync": q80_sync, "ring_sync": ring_sync}
        self.stats = EngineStats()
        self.pipeline_depth = (DEFAULT_PIPELINE_DEPTH if pipeline_depth is None
                               else max(0, pipeline_depth))

        # the step families' static inputs: host tokens, host positions (-1
        # reads the carried position) and seeds; temperatures and top-p;
        # the verify step's candidates and their counts; the pipeline's
        # token and position carry
        n = n_lanes
        self._in_i = torch.zeros((3, n), dtype=torch.int64, device=self.device)
        self._in_f = torch.zeros((2, n), dtype=torch.float32, device=self.device)
        self._drafts = torch.zeros((n, SPEC_DRAFT + 1), dtype=torch.int64, device=self.device)
        self._dlen = torch.zeros(n, dtype=torch.int64, device=self.device)
        self._feed = torch.zeros(n, dtype=torch.int64, device=self.device)
        self._cpos = torch.zeros(n, dtype=torch.int64, device=self.device)
        # a mesh across cards stays eager (its ranks' streams would join
        # the capture through events); one card, ranks on it included, is
        # captured
        one_card = self.device.type == "cuda" and all(d == self.device for d in self.devices)
        self.graphs = StepGraphs(self.device, [self._feed, self._cpos]) if one_card else None
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

    def _lane_cache(self, lane: int):
        if self.mesh is None:
            return self.cache.lane(lane)
        return [c.lane(lane) for c in self.cache]

    def _chunk_attn(self, end: int) -> int:
        """The attention bucket of a prompt chunk ending at ``end``: the
        least bucket at or past it."""
        return next(b for b in self.attn_buckets if b >= end)

    def _fill(self, tokens, positions, temps, topps, seeds) -> None:
        """Host metadata into the static inputs (tokens None: keep the
        carry; else they reseed it: the JAX engine's ``_pl_feed``)."""
        n = self.n_lanes
        ints = np.empty((3, n), np.int64)
        ints[0] = 0 if tokens is None else np.asarray(tokens, np.int64)
        ints[1] = np.asarray(positions, np.int64)
        ints[2] = np.asarray(seeds, np.int64) & MASK32
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

    def _pick(self, step, positions, sample: bool):
        """(greedy, sampled) per lane: argmax, and the nucleus draw where
        ``sample`` (the host's "some lane samples"; the twin of the JAX
        engine's ``lax.cond``)."""
        greedy = torch.argmax(step, dim=-1)
        if not sample:
            return greedy, greedy
        temps, topps = self._in_f[0], self._in_f[1]
        return greedy, sample_lanes(step, temps, topps, self._in_i[2], positions, greedy)

    def _step_body(self, sample: bool):
        """One decode step from the static inputs: positions are the host's
        where >= 0, else the carry; the chosen tokens and next positions
        become the carry. Returns (logits [n, vocab], [2, n] int32 greedy
        and sampled rows)."""
        pos = torch.where(self._in_i[1] < 0, self._cpos, self._in_i[1])
        step = self._forward(self._feed, pos)
        greedy, sampled = self._pick(step, pos, sample)
        self._feed.copy_(torch.where(self._in_f[0] == 0.0, greedy, sampled))
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
        count)."""
        seq_len = self.config.seq_len
        k1 = SPEC_DRAFT + 1
        pos = torch.where(self._in_i[1] < 0, self._cpos, self._in_i[1])
        feed, drafts = self._feed, self._drafts
        hit0 = (drafts[:, 0] == feed) & (self._dlen > 0)
        eff = torch.where(hit0, self._dlen - 1, torch.zeros_like(self._dlen))
        eff = torch.minimum(eff, torch.clamp(seq_len - pos - 1, min=0))
        full = torch.cat([feed[:, None], drafts[:, 1:]], dim=1)
        steps = torch.arange(k1, device=pos.device)
        logits, _ = llama_forward(self.config, self.params, full, pos[:, None] + steps,
                                  self.cache, **self._forward_flags)
        greedy = torch.argmax(logits, dim=-1)  # [n, K + 1]
        match = (full[:, 1:] == greedy[:, :-1]).to(torch.int64)
        lead = torch.cumprod(match, dim=1)
        accepted = (lead * (steps[None, :-1] < eff[:, None])).sum(dim=1)
        n_emit = accepted + 1
        row0 = logits[:, 0, :]
        _, sampled0 = self._pick(row0, pos, sample)
        emitted = torch.cat([torch.where(self._in_f[0] > 0.0, sampled0, greedy[:, 0])[:, None],
                             greedy[:, 1:]], dim=1)
        self._feed.copy_(emitted.gather(1, (n_emit - 1)[:, None])[:, 0])
        self._cpos.copy_(torch.clamp(pos + n_emit, max=seq_len))
        return row0, torch.cat([emitted, n_emit[:, None]], dim=1).to(torch.int32)

    def _multi_body(self, h: int, sample: bool):
        """h chained steps: each lane feeds its greedy token at temperature
        0, else its draw, at position + 1. Returns chosen [h, n] int32."""
        tok, pos = self._feed, self._in_i[1]
        chosen = []
        for _ in range(h):
            step = self._forward(tok, pos)
            greedy, sampled = self._pick(step, pos, sample)
            tok = torch.where(self._in_f[0] == 0.0, greedy, sampled)
            chosen.append(tok)
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
                      temp: float, topp: float, seed: int):
        """One bucketed prompt chunk on one lane's cache, and its boundary
        token: (last logits [vocab], greedy, sampled) as device tensors."""
        n = len(chunk)
        bucket = self.bucket_for(n)
        padded = np.zeros(bucket, np.int64)
        padded[:n] = chunk
        positions = start_pos + np.arange(bucket, dtype=np.int64)
        logits, _ = llama_forward(
            self.config, self.params, self._upload(padded)[None, :],
            self._upload(positions)[None, :], self._lane_cache(lane),
            attn_len=self._chunk_attn(start_pos + n),
            logit_rows=self._upload([n - 1]), **self._forward_flags,
        )
        last = logits[0, 0]
        greedy = torch.argmax(last)
        sampled = greedy
        if temp > 0.0:  # a greedy admission skips the sampler
            sampled = sample_lanes(
                last[None], self._upload([temp], torch.float32),
                self._upload([topp], torch.float32), self._upload([seed & MASK32]),
                self._upload([start_pos + n - 1]), greedy[None])[0]
        return last, greedy, sampled

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
                      temp: float = 0.0, topp: float = DEFAULT_TOPP, seed: int = 0):
        """One bucketed prompt chunk for one lane. Returns (last_logits
        [vocab] device tensor, greedy_token int, sampled_token int — equals
        greedy at temp 0)."""
        self._validate_chunk(chunk, start_pos)
        if not 0 <= lane < self.n_lanes:
            raise ValueError(f"lane {lane} out of range")
        faults.fire("engine.dispatch")
        t0 = time.perf_counter()
        last, greedy, sampled = self._prefill_half(lane, chunk, start_pos, temp, topp, seed)
        toks = torch.stack([greedy, sampled]).to(torch.int32).cpu()
        with self.stats.lock:
            self.stats.host_bytes_in += toks.numel() * 4
            self.stats.prefill_s += time.perf_counter() - t0
            self.stats.prefill_tokens += len(chunk)
        return last, int(toks[0]), int(toks[1])

    def prefill(self, lane: int, tokens: list[int], start_pos: int = 0,
                temp: float = 0.0, topp: float = DEFAULT_TOPP, seed: int = 0):
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
                lane, chunk, pos, temp=temp, topp=topp, seed=seed)
            pos += len(chunk)
        return last, greedy, pos

    def _check_sync(self) -> None:
        if self.pipeline_active:
            raise RuntimeError("a pipelined chain holds the token carry: flush it "
                               "(pipeline_flush) before a synchronous step")

    @torch.inference_mode()
    def decode(self, tokens, positions, temps=None, topps=None, seeds=None,
               want_logits: bool = True):
        """One decode step for all lanes. tokens/positions: int [n_lanes]
        (idle lanes at seq_len: their KV write lands in the scratch slot).
        Returns (logits [n_lanes, vocab] device tensor or None, greedy
        np[n_lanes], sampled np[n_lanes] — equals greedy where temp 0), the
        pair in one [2, n] readback."""
        self._check_sync()
        temps, topps, seeds = self._defaults(temps, topps, seeds)
        positions = np.asarray(positions, np.int64)
        if positions.min() < 0:
            raise ValueError("decode positions must be >= 0")
        faults.fire("engine.dispatch")
        t0 = time.perf_counter()
        hop_bytes = ring_counts()["ring_hop_bytes"]
        self._fill(tokens, positions, temps, topps, seeds)
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
                     h: int = 8) -> np.ndarray:
        """``h`` chained decode steps for all lanes in one dispatch. Per
        lane and step the feed is its greedy token at temperature 0, else
        its draw (the same fold_in(seed, pos) draw h single steps make), at
        position + 1. Returns ``chosen`` np[h, n]: the token each lane feeds
        after step j. The caller consumes its next token plus chosen[:h-1]
        and adopts chosen[h-1]; steps past a lane's stop write junk KV above
        its committed tokens, rewritten before any query reads it; steps
        past seq_len write the scratch slot."""
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
        self._fill(tokens, positions, temps, topps, seeds)
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
                    seeds=None, want_logits: bool = True):
        """One speculative verify step for all lanes: each lane's next token
        plus up to SPEC_DRAFT drafted continuations in one forward.
        tokens/positions/draft_len: int [n_lanes]; drafts: [n_lanes,
        SPEC_DRAFT] (junk past draft_len). Greedy lanes emit their
        plain-decode stream exactly (the speculative-verification
        identity); temp > 0 lanes pass draft_len 0 and emit one sampled
        token. Per lane, draft_len <= seq_len - positions - 1 (the step
        clamps it there too). Returns (logits [n, vocab] of each lane's
        first row, device tensor, or None; emitted np[n, K + 1]; n_emit
        np[n]), the pack in one readback."""
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
        self._fill(tokens, positions, temps, topps, seeds)
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

    def check_pipelined_dispatch(self, reseed: bool, positions=None) -> None:
        """Raise every host-side error a pipelined dispatch would, without
        dispatching."""
        if reseed and positions is not None and int(np.min(positions)) < 0:
            raise ValueError(
                "reseed dispatch with a -1 position: the carried-position "
                "select has no carry to read on a reseed — pass real "
                "positions for every lane"
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
                             positions=None) -> None:
        """``check_pipelined_dispatch`` plus the prompt chunk's bounds."""
        if not chunk:
            raise ValueError("fused prefill needs a non-empty prompt chunk")
        self._validate_chunk(chunk, p_start)
        self.check_pipelined_dispatch(reseed, positions)

    def check_spec_drafts(self, drafts) -> None:
        """The in-chain verify step's draft shape, in one place."""
        shape = getattr(drafts, "shape", None)
        want = (self.n_lanes, SPEC_DRAFT + 1)
        if shape != want:
            raise ValueError(f"spec drafts shape {shape} != {want} (SPEC_DRAFT + 1 columns: "
                             "candidate 0 is the host's guess at the carry token itself)")

    def check_spec_pipelined_dispatch(self, drafts, reseed: bool, positions=None) -> None:
        """``check_pipelined_dispatch`` plus the draft shape."""
        self.check_spec_drafts(drafts)
        self.check_pipelined_dispatch(reseed, positions)

    def _dispatch_step(self, positions, temps, topps, seeds, tokens, drafts=None,
                       draft_len=None):
        """Fill the static inputs and run one step of the chain (the verify
        step where ``drafts`` are given); returns the step's int32 output,
        [2, n] or the [n, K + 2] pack (static on the card: read it before
        the next replay)."""
        hop_bytes = ring_counts()["ring_hop_bytes"]
        self._fill(tokens, positions, temps, topps, seeds)
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
                         tokens=None) -> None:
        """Dispatch ONE pipelined decode step and return without reading
        anything back. ``tokens=None`` feeds the device carry (the previous
        step's where(temp == 0, greedy, sampled)); host ``tokens`` reseed
        it. A position of -1 reads the carried position, >= 0 overrides it
        (parked or admitting lanes at seq_len, every lane on a reseed).
        The ring holds at most ``pipeline_depth`` steps: consume the oldest
        before dispatching past it. Steps dispatched after a lane's
        not-yet-read stop write junk KV above its committed tokens."""
        temps, topps, seeds = self._defaults(temps, topps, seeds)
        self.check_pipelined_dispatch(tokens is not None, positions)
        faults.fire("engine.dispatch")
        self._enqueue(self._dispatch_step(positions, temps, topps, seeds, tokens))

    @torch.inference_mode()
    def decode_prefill_fused(self, positions, temps=None, topps=None, seeds=None,
                             p_lane: int = 0, chunk: list[int] | None = None,
                             p_start: int = 0, p_temp: float = 0.0,
                             p_topp: float = DEFAULT_TOPP, p_seed: int = 0,
                             tokens=None) -> None:
        """Dispatch one fused step into the ring: lane ``p_lane`` takes one
        prompt chunk (``prefill_chunk``'s math) and every lane takes one
        pipelined decode step (``decode_pipelined``'s, with the admitting
        lane parked at seq_len by the caller). The carry slot of ``p_lane``
        becomes the chunk's boundary token and its position the chunk's
        end, so after the final chunk the next dispatch feeds the admitted
        lane from the device. The readback is [2, n+1], the extra column
        the boundary greedy/sampled pair."""
        temps, topps, seeds = self._defaults(temps, topps, seeds)
        self.check_fused_dispatch(chunk, p_start, tokens is not None, positions)
        faults.fire("engine.dispatch")
        self._fused(positions, temps, topps, seeds, p_lane, chunk, p_start, p_temp, p_topp,
                    p_seed, tokens)

    def _fused(self, positions, temps, topps, seeds, p_lane, chunk, p_start, p_temp,
               p_topp, p_seed, tokens, drafts=None, draft_len=None) -> None:
        """A fused dispatch: the prompt chunk, then the chain's step (the
        verify step where ``drafts`` are given); the admitting lane's carry
        becomes the chunk's boundary token at the chunk's end, and the
        boundary greedy/sampled pair rides the readback (an extra column of
        a [2, n] step, an extra row of a verify pack)."""
        _, p_greedy, p_sampled = self._prefill_half(p_lane, chunk, p_start, p_temp,
                                                    p_topp, p_seed)
        packed = self._dispatch_step(positions, temps, topps, seeds, tokens, drafts, draft_len)
        end = p_start + len(chunk)
        self._feed[p_lane:p_lane + 1].copy_((p_greedy if p_temp == 0.0 else p_sampled)[None])
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
                              seeds=None, tokens=None) -> None:
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
        as in ``decode_pipelined`` (-1 reads the carry); the draft clamp
        near seq_len is on the device, from the carried positions."""
        temps, topps, seeds = self._defaults(temps, topps, seeds)
        self.check_spec_pipelined_dispatch(drafts, tokens is not None, positions)
        faults.fire("engine.dispatch")
        packed = self._dispatch_step(positions, temps, topps, seeds, tokens, drafts, draft_len)
        self._enqueue(packed, kind="spec")

    @torch.inference_mode()
    def decode_spec_prefill_fused(self, positions, drafts, draft_len, temps=None, topps=None,
                                  seeds=None, p_lane: int = 0, chunk: list[int] | None = None,
                                  p_start: int = 0, p_temp: float = 0.0,
                                  p_topp: float = DEFAULT_TOPP, p_seed: int = 0,
                                  tokens=None) -> None:
        """``decode_spec_pipelined`` that also takes one prompt chunk for lane
        ``p_lane`` (``decode_prefill_fused``'s contract). The readback is
        [n + 1, K + 2], the boundary greedy/sampled pair in the extra
        row's first two columns."""
        temps, topps, seeds = self._defaults(temps, topps, seeds)
        self.check_spec_drafts(drafts)
        self.check_fused_dispatch(chunk, p_start, tokens is not None, positions)
        faults.fire("engine.dispatch")
        self._fused(positions, temps, topps, seeds, p_lane, chunk, p_start, p_temp, p_topp,
                    p_seed, tokens, drafts, draft_len)

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
        if not (0 <= src < self.n_lanes and 0 <= dst < self.n_lanes):
            raise ValueError(f"copy_lane({src}, {dst}) outside {self.n_lanes} lanes")
        n = self.config.seq_len if prefix_len is None else int(prefix_len)
        if src == dst or n <= 0:
            return
        for c in ([self.cache] if self.mesh is None else self.cache):
            for plane in (c.k, c.v):
                plane[:, dst, :n].copy_(plane[:, src, :n])


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
