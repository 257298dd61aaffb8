"""Inference engine: prefill and decode steps over a lane-based KV cache.

- ``decode``: one token for every lane at its own position — the whole
  continuous batch advances in one step;
- ``prefill_chunk`` / ``prefill``: a bucketed prompt chunk for ONE lane,
  on that lane's slice of the cache.

Prompt chunks are padded to the same buckets as the JAX engine, so a chunk
runs the same product shapes (and so the same dequant mode per site) there
and here. Sampling runs on the device: an exact full-vocab nucleus
(sort -> softmax -> cumulative sum -> keep up to and including the token
that crosses top-p) and one uniform draw per lane from a ``torch.Generator``
seeded by (seed, position), so a seeded request reproduces. The JAX engine
draws with ``fold_in(PRNGKey(seed), pos)``, which torch cannot reproduce:
sampled streams agree with it in support only; greedy streams are
identical.

With a tensor-parallel ``mesh`` the engine holds per-rank parameters and
KV caches; sampling and the returned logits stay on rank 0's device, so the
scheduler sees one engine either way.

The port runs the synchronous path only; the pipelined, fused,
speculative, multi-step, paged and grammar families are later work, which
the ``supports_*`` flags say to the scheduler.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import LlamaConfig
from ..models.llama import LlamaParams, init_kv_cache, llama_forward
from ..ops.ring_collective import ring_counts
from ..parallel.sharding import shard_kv_cache

DEFAULT_PREFILL_BUCKETS = (16, 64, 256, 1024)
DEFAULT_TOPP = 0.9
_SEED_MIX = 0x9E3779B97F4A7C15
_U64 = (1 << 64) - 1


@dataclass
class EngineStats:
    """Per-call timing and transfer counters."""

    prefill_s: float = 0.0
    decode_s: float = 0.0
    prefill_tokens: int = 0
    decode_steps: int = 0
    host_bytes_in: int = 0  # device->host token/logit traffic
    # bytes the ring hop moved in the last decode step (a mesh's TP sync and
    # logits gather; 0 off-mesh), counted by the hop, not reckoned
    sync_bytes_per_decode: int = 0
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False,
                                 compare=False)

    def _counters(self) -> dict:
        return {k: v for k, v in self.__dict__.items() if k != "lock"}

    def snapshot(self) -> dict:
        with self.lock:
            return self._counters()

    def reset(self) -> "EngineStats":
        with self.lock:
            snap = EngineStats(**self._counters())
            self.prefill_s = self.decode_s = 0.0
            self.prefill_tokens = self.decode_steps = self.host_bytes_in = 0
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


def _lane_uniforms(seeds, positions) -> torch.Tensor:
    """One U[0, 1) draw per lane from a CPU generator seeded by (seed, pos)."""
    out = torch.empty(len(seeds), dtype=torch.float32)
    g = torch.Generator()
    for i, (s, p) in enumerate(zip(seeds, positions)):
        g.manual_seed((int(s) * _SEED_MIX + int(p)) & _U64)
        out[i] = torch.rand((), generator=g)
    return out


def sample_rows(rows: torch.Tensor, temps: torch.Tensor, topps: torch.Tensor,
                uniforms: torch.Tensor) -> torch.Tensor:
    """Exact nucleus samples for rows [n, vocab] (f32): full-vocab sort,
    softmax at temperature max(temp, 1e-6), keep every token up to and
    including the one whose cumulative probability crosses top-p (top-p
    <= 0 or >= 1 keeps all), then inverse-CDF of the kept mass at the
    lane's uniform. Returns token ids [n] (int64)."""
    vals, idx = torch.sort(rows, dim=-1, descending=True)
    t = torch.clamp(temps, min=1e-6)[:, None]
    p = torch.softmax(vals / t, dim=-1)
    csum = torch.cumsum(p, dim=-1)
    topp_eff = torch.where((topps <= 0.0) | (topps >= 1.0),
                           torch.ones_like(topps), topps)[:, None]
    keep = (csum - p) < topp_eff
    kept = torch.where(keep, p, torch.zeros_like(p))
    kcum = torch.cumsum(kept, dim=-1)
    r = uniforms.to(rows.device)[:, None] * kcum[:, -1:]
    choice = torch.searchsorted(kcum, r, right=True)
    n_kept = keep.sum(dim=-1, keepdim=True)
    choice = torch.minimum(choice, n_kept - 1)
    return torch.gather(idx, 1, choice)[:, 0]


class InferenceEngine:
    # later slices: the scheduler reads these to pick its paths
    supports_pipelined = False
    supports_fused_prefill = False
    supports_speculative = False
    supports_spec_pipelined = False
    supports_multi_step = False
    supports_grammar = False

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
    ):
        """``device`` defaults to CUDA and raises where there is none; tests
        pass ``device="cpu"``. The parameters must already live there.
        ``cache_dtype`` None: bf16 KV on the card, f32 on the CPU.

        With ``mesh`` (tensor parallel), ``params`` is the per-rank list of
        ``parallel.sharding.shard_params`` and the device is rank 0's, where
        sampling runs and logits land; the KV cache is split on kv heads.
        ``emulate_q80_activations``, ``q80_sync`` and ``ring_sync`` go to
        ``llama_forward``."""
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
        if cache_dtype is None:
            cache_dtype = torch.float32 if self.device.type == "cpu" else torch.bfloat16
        self.cache_dtype = cache_dtype
        self.cache = init_kv_cache(config, n_lanes, dtype=cache_dtype, device=self.device)
        if mesh is not None:
            self.cache = shard_kv_cache(self.cache, mesh)
        self._forward_flags = {"emulate_q80_activations": emulate_q80_activations,
                               "mesh": mesh, "q80_sync": q80_sync, "ring_sync": ring_sync}
        self.stats = EngineStats()

    # -- helpers --------------------------------------------------------------

    def _tensor(self, a, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _lane_cache(self, lane: int):
        if self.mesh is None:
            return self.cache.lane(lane)
        return [c.lane(lane) for c in self.cache]

    def _attn_len(self, ends) -> int:
        """Cache slots attention must read: past the highest real position,
        rounded up to 64 (idle lanes sit at seq_len and are left out)."""
        real = [int(e) for e in ends if int(e) <= self.config.seq_len]
        top = max(real) if real else self.config.seq_len
        return min(self.config.seq_len, -(-top // 64) * 64)

    def _sample(self, rows, temps, topps, seeds, positions, greedy) -> torch.Tensor:
        if not np.any(np.asarray(temps) > 0.0):
            return greedy
        u = _lane_uniforms(seeds, positions)
        tt = self._tensor(temps, torch.float32)
        sampled = sample_rows(rows.to(torch.float32), tt,
                              self._tensor(topps, torch.float32), u)
        return torch.where(tt == 0.0, greedy, sampled)

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
        if len(chunk) > self.max_chunk():
            raise ValueError(f"chunk of {len(chunk)} exceeds bucket {self.max_chunk()}")
        if start_pos + len(chunk) > self.config.seq_len:
            raise ValueError(
                f"chunk of {len(chunk)} tokens at pos {start_pos} exceeds "
                f"seq_len {self.config.seq_len}"
            )
        if not 0 <= lane < self.n_lanes:
            raise ValueError(f"lane {lane} out of range")
        t0 = time.perf_counter()
        n = len(chunk)
        bucket = self.bucket_for(n)
        padded = np.zeros(bucket, np.int64)
        padded[:n] = chunk
        positions = start_pos + np.arange(bucket, dtype=np.int64)
        logits, _ = llama_forward(
            self.config, self.params, self._tensor(padded)[None, :],
            self._tensor(positions)[None, :], self._lane_cache(lane),
            attn_len=self._attn_len([start_pos + n]),
            logit_rows=self._tensor([n - 1]), **self._forward_flags,
        )
        last = logits[0, 0]
        greedy = torch.argmax(last)
        sampled = self._sample(last[None], [temp], [topp], [seed & 0xFFFFFFFF],
                               [start_pos + n - 1], greedy[None])
        toks = torch.stack([greedy, sampled[0]]).cpu()
        with self.stats.lock:
            self.stats.host_bytes_in += toks.numel() * 4
            self.stats.prefill_s += time.perf_counter() - t0
            self.stats.prefill_tokens += n
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

    @torch.inference_mode()
    def decode(self, tokens, positions, temps=None, topps=None, seeds=None,
               want_logits: bool = True):
        """One decode step for all lanes. tokens/positions: int [n_lanes]
        (idle lanes at seq_len: their KV write lands in the scratch slot).
        Returns (logits [n_lanes, vocab] device tensor or None, greedy
        np[n_lanes], sampled np[n_lanes] — equals greedy where temp 0)."""
        n = self.n_lanes
        temps = np.zeros(n, np.float32) if temps is None else np.asarray(temps, np.float32)
        topps = (np.full(n, DEFAULT_TOPP, np.float32) if topps is None
                 else np.asarray(topps, np.float32))
        seeds = np.zeros(n, np.uint32) if seeds is None else np.asarray(seeds)
        positions = np.asarray(positions, np.int64)
        t0 = time.perf_counter()
        hop_bytes = ring_counts()["ring_hop_bytes"]
        logits, _ = llama_forward(
            self.config, self.params, self._tensor(tokens)[:, None],
            self._tensor(positions)[:, None], self.cache,
            attn_len=self._attn_len(positions + 1), **self._forward_flags,
        )
        step = logits[:, 0, :]
        greedy = torch.argmax(step, dim=-1)
        sampled = self._sample(step, temps, topps, seeds, positions, greedy)
        toks = torch.stack([greedy, sampled]).cpu().numpy().astype(np.int32)
        with self.stats.lock:
            self.stats.host_bytes_in += toks.nbytes
            self.stats.decode_s += time.perf_counter() - t0
            self.stats.decode_steps += 1
            self.stats.sync_bytes_per_decode = ring_counts()["ring_hop_bytes"] - hop_bytes
        return (step if want_logits else None), toks[0], toks[1]

    @torch.inference_mode()
    def sample_token(self, logits_row, temp: float, topp: float, seed: int,
                     pos: int) -> int:
        """Sample from one [vocab] logits row with the decode sampler."""
        row = torch.as_tensor(logits_row, dtype=torch.float32).to(self.device)
        greedy = torch.argmax(row)[None]
        tok = self._sample(row[None], [temp], [topp], [seed & 0xFFFFFFFF], [pos], greedy)
        with self.stats.lock:
            self.stats.host_bytes_in += 4
        return int(tok[0])

    def reset_lane(self, lane: int) -> None:
        """Nothing to clear: a new request's prefill rewrites the lane from
        position 0, and reads are masked to s <= pos."""


def warmup_engine(engine: InferenceEngine) -> None:
    """Run one prefill chunk per bucket and one decode step before serving,
    so the first request pays no kernel build; the counters are restored
    afterwards. The junk KV lands in slots admission rewrites."""
    z = np.zeros(engine.n_lanes, np.int64)
    with engine.stats.preserved():
        for bucket in engine.prefill_buckets:
            engine.prefill_chunk(0, [0] * bucket, 0)
        engine.decode(z, z)
        engine.decode(z, z, temps=np.full(engine.n_lanes, 0.7, np.float32),
                      seeds=np.ones(engine.n_lanes, np.uint32))
