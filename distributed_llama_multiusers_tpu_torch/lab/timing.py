"""The lab's harness (in place of the JAX lab's ``bench_chain``, ``timeit``
and ``_report``).

A variant is one pass over the stack of L planes. On the card the pass is
captured once in a CUDA graph and replayed ``reps`` times between two CUDA
events, best of three rounds: nothing is hoisted or cached between replays,
so the JAX lab's carry operand ``t`` has no counterpart. The stack exceeds
the 50 MB L2 at the lab's default shapes (8 planes of 29.4 MB packed), so
a pass streams from device memory. Each result carries the bytes the pass
must move (inputs read once, outputs written once), the rate those bytes
make in that time, and the share of the H100 SXM's 3.35 TB/s; its bound is
the larger of those bytes over 3.35 TB/s and its operations over the peak
for their type. On the CPU (``--device cpu``, the plain versions) a pass is
timed by the host clock and no device rate is printed.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from ..ops import cuda_lab, cuda_q40
from ..device import resolve_device

# H100 SXM (NVIDIA data sheet; dense, at the full 700 W limit)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def parser(description: str, positional: list) -> argparse.ArgumentParser:
    """The lab CLIs' arguments: the JAX scripts' positional shape arguments
    (name, default) and ``--device``."""
    p = argparse.ArgumentParser(description=description)
    for name, default in positional:
        p.add_argument(name, type=int, nargs="?", default=default)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu: the plain versions, timed by the host clock (no device rate)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[(device.index or 0)]


def q40_planes(L: int, d_in: int, d_out: int, device, seed: int = 0):
    """A stack of L random Q40 planes drawn on the device from ``seed``
    (as kernel_lab3.py and stage_probe.py draw theirs): packed uint8
    [L, d_in/2, d_out] and scales float16 [L, d_in/32, d_out] in
    [0.001, 0.011)."""
    g = torch.Generator(device=device).manual_seed(seed)
    packed = torch.randint(0, 256, (L, d_in // 2, d_out), dtype=torch.uint8, device=device,
                           generator=g)
    scales = torch.rand((L, d_in // 32, d_out), device=device, generator=g) * 0.01 + 0.001
    return packed, scales.to(torch.float16)


def randn(shape, device, seed: int, dtype=torch.float32) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, device=device, generator=g).to(dtype)


def pass_ms(fn, device, reps: int = 5, rounds: int = 3) -> float:
    """Time of one pass ``fn()``: a CUDA graph of it replayed ``reps`` times
    between CUDA events, best of ``rounds`` (the card); the host clock
    around ``reps`` calls, best of ``rounds`` (the CPU)."""
    if device.type != "cuda":
        fn()
        best = float("inf")
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            best = min(best, (time.perf_counter() - t0) * 1e3 / reps)
        return best
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        fn()  # builds the kernels and warms the allocator outside the graph
    cur.wait_stream(side)
    torch.cuda.synchronize(device)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(rounds):
        start.record()
        for _ in range(reps):
            g.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    del g
    return best


def eager_ms(fn, device) -> float:
    """One eager call (the plain versions: no yardstick of speed)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def bound(nbytes: int, ops: int = 0, kind: str = "f32") -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the bytes over 3.35 TB/s and the
    operations over the peak for their type."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[kind]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _launches() -> int:
    return sum(cuda_lab.LAUNCHES.values()) + sum(cuda_q40.LAUNCHES.values())


class Lab:
    """One lab run: prints its header, measures variants, keeps the rows."""

    def __init__(self, title: str, device, reps: int, plain: bool = False, out=print):
        self.device = resolve_device(device)
        self.reps = reps
        self.plain = plain
        self.out = out
        self.rows: list = []
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.card = card_line(self.device)
        self.out(self.card)
        name = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                else "cpu")
        self.out(f"{title}  device={name}")

    def measure(self, name: str, fn, nbytes: int, kernel: str | None = None,
                site: str | None = None, ops: int = 0, kind: str = "f32", plain_fn=None,
                library_fn=None, library: str | None = None, note: str | None = None) -> dict:
        """Time ``fn`` (one pass), and beside it the plain version's pass
        (when the run asks for plain times) and the library call's; print
        and keep the row."""
        before = _launches()
        ms = pass_ms(fn, self.device, self.reps)
        launches = _launches() - before
        plain_ms = eager_ms(plain_fn, self.device) if self.plain and plain_fn else None
        library_ms = pass_ms(library_fn, self.device, self.reps) if library_fn else None
        b_ms, b_by = bound(nbytes, ops, kind)
        row = {"name": name, "kernel": kernel, "site": site, "ms": ms, "bytes": nbytes,
               "launches": launches, "bound_ms": b_ms, "bound_by": b_by, "plain_ms": plain_ms,
               "library": library, "library_ms": library_ms, "note": note,
               "device": self.device.type}
        if self.device.type == "cuda":
            gbs = nbytes / ms / 1e6
            row.update(gb_s=gbs, hbm_share=gbs * 1e9 / HBM_BYTES_S)
            rate = f"{gbs:8.1f} GB/s ({row['hbm_share'] * 100:5.1f}% of 3.35 TB/s)"
        else:
            rate = "(cpu host clock)"
        lib = f"  {library} {library_ms:.4f} ms" if library_ms is not None else ""
        self.out(f"{name:30s} {ms:9.4f} ms {rate}  working set {nbytes:,} B  "
                 f"bound {b_ms:.4f} ms ({b_by}){lib}" + (f"  [{note}]" if note else ""))
        self.rows.append(row)
        return row
