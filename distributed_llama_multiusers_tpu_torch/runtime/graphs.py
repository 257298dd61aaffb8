"""CUDA graphs of the engine's decode step families.

The JAX engine's steps are compiled programs: one dispatch per step,
whatever the model's depth. A step of the port run eagerly is ~1,500-9,400
launches from Python, and the host, not the card, sets the step time. A
CUDA graph is the compiled step's twin: the step body runs once under
capture, and every later step is one ``replay`` of the recorded launches.

``StepGraphs`` keeps one graph per key, the engine's family (and
multi-step horizon) and whether some lane samples, all in one memory pool.
A body reads its inputs from static buffers the engine fills with ``copy_``
before each replay and returns static outputs, which replays overwrite, so
callers copy what they keep on the stream right after the replay. The
launch counters the kernels' wrappers bump in Python (Q40 kernels, the
ring step, the sampler, the attention) do not move under a replay, so
each graph records its body's deltas at capture and adds them on every
replay: the counts
stay those of the launches the card ran.

A key's first step runs its body eagerly and then captures it, so every
kernel library is loaded before a capture meets it; the capture stream's
library handles (cuBLAS and its workspace) are made before the first
capture. After ``mark_warm`` every new capture counts in
``captures_after_warmup``: serving replays what warmup captured, and a
capture mid-serving stalls a step (the JAX package's post-warmup compile
counter, ``dllama_jit_compiles_total`` on ``/metrics``); every capture is
reported to the recompile witness (``analysis/jitcheck.py``), which
``mark_warm`` arms and which raises under ``DLLAMA_JITCHECK=1``. Warmup captures
keys ahead of their first step: there a family's
body runs once eagerly on the capture stream first, the engine's carried
buffers are restored after that run, and the run's cache writes are the
replay's own, so it leaves no trace. A capture that fails raises: there
is no eager fallback.
"""

from __future__ import annotations

import time

import torch

from ..analysis import jitcheck
from ..ops import cuda_attn, cuda_q40, cuda_sample, ring_collective


def _counters() -> dict:
    """Every launch counter a replay must advance."""
    return {
        "q40": dict(cuda_q40.LAUNCHES),
        "ring": {k: ring_collective.COUNTS[k] for k in ("launches", "bytes")},
        "sample": {"launches": cuda_sample.COUNTS["launches"]},
        "attn": {k: cuda_attn.COUNTS[k] for k in ("launches", "window_launches")},
    }


_ADD = {"q40": cuda_q40.add_launches, "ring": ring_collective.add_counts,
        "sample": cuda_sample.add_counts, "attn": cuda_attn.add_counts}


def _delta(after: dict, before: dict) -> dict:
    return {t: {k: after[t][k] - before[t][k] for k in after[t]} for t in after}


def add_deltas(delta: dict, sign: int = 1) -> None:
    for table, d in delta.items():
        _ADD[table]({k: sign * v for k, v in d.items()})


class StepGraphs:
    """Captured step graphs of one engine on one CUDA device."""

    def __init__(self, device: torch.device, carried: list):
        """``carried``: the static buffers a body updates in place (the
        pipeline's token and position carry), saved and restored around
        the eager run before a family's first capture."""
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self._carried = carried
        self._graphs: dict = {}
        self._warm: set = set()
        self._stream_ready = False
        self.capture_s = 0.0
        self.replays = 0
        self._warm_count: int | None = None

    def mark_warm(self) -> None:
        """Warmup is over: count replays, and captures, from here (and arm
        the recompile witness for these graphs)."""
        self._warm_count = len(self._graphs)
        self.replays = 0
        jitcheck.arm(self)

    @property
    def captures_after_warmup(self) -> int:
        return 0 if self._warm_count is None else len(self._graphs) - self._warm_count

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, key, body, family):
        """Replay the graph of ``key`` and return its static outputs. A new
        key's first step runs ``body`` eagerly (that run is the step, and
        warms ``family``), then captures it for the steps after."""
        entry = self._graphs.get(key)
        if entry is None:
            out = body()
            self._warm.add(family)
            self.ensure(key, body, family)
            return out
        graph, out, delta = entry
        graph.replay()
        add_deltas(delta)
        self.replays += 1
        return out

    def ensure(self, key, body, family):
        """The (graph, static outputs, launch deltas) of ``key``, captured
        from ``body`` unless it already was."""
        entry = self._graphs.get(key)
        if entry is not None:
            return entry
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        if not self._stream_ready:
            # the library handles a capture meets (cuBLAS and its workspace)
            # exist per stream: make them on the capture stream first
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                a = torch.ones((8, 8), device=self.device)
                for dtype in (torch.float32, torch.bfloat16):
                    b = a.to(dtype)
                    torch.matmul(b, b)
                    torch.matmul(b[None].expand(2, 8, 8), b)
            current.wait_stream(self.stream)
            self._stream_ready = True
        if family not in self._warm:
            saved = [t.clone() for t in self._carried]
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                body()
                for t, s in zip(self._carried, saved):
                    t.copy_(s)
            current.wait_stream(self.stream)
            self._warm.add(family)
        before = _counters()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            out = body()
        delta = _delta(_counters(), before)
        add_deltas(delta, -1)  # the capture itself launched nothing
        self._graphs[key] = entry = (graph, out, delta)
        self.capture_s += time.perf_counter() - t0
        jitcheck.note_capture(self)
        return entry
