#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card and the
CUDA toolkit (``nvcc``). Phases, each of which fails the run:

1. Setup: print the card's name and power limit (``nvidia-smi``), build the
   Q40 kernels, the ring hop and the lab's kernels from ``distributed_llama_multiusers_tpu_torch/
   csrc`` (one ``nvcc`` per source, all at once) and print the build time.
2. Kernels: at the Llama-3.2-1B matmul sites (2048->2048, 2048->512,
   2048->8192, 8192->2048, 2048->128256) hold every Q40 kernel and mode
   against its plain PyTorch version on the card (m = 1, 8, 32 for all three
   kernels; m = 33 and 512 for the slab kernel; f16-denormal scales; the
   m = 32/33 mode-routing boundary), then time each kernel, its plain
   version and ``torch.matmul`` on the pre-dequantized bf16 weight. The ring
   hop bit for bit against its plain version on each tensor-parallel payload
   (f32 ring chunks at tp=2 and 4, the Q80 wire's values and scales, logits
   shards, a prefill chunk), timed beside ``dst.copy_(src)`` and its bound;
   the ring collectives at tp=2 and tp=4 against themselves on the plain hop.
3. Serving: write a full-width Llama-3.2-1B-shaped synthetic Q40 model (16
   layers, seed 0) into ``build/synthetic`` (reused while header and seed
   match), start ``python -m distributed_llama_multiusers_tpu_torch.app.
   dllama_api`` once per dequant mode (default v4, ``auto``, ``blockdot``)
   and twice with ``--workers 2`` (defaults; ``--buffer-float-type q80
   --dequant auto``) on the host's cards (one card named twice where there
   is one), send 4 concurrent requests (greedy and sampled, completion and
   chat, one streamed), check the answers, the startup log and the kernels'
   launch counts on ``/stats``, print TTFT and decode tok/s, and SIGTERM the
   server.
4. Decode step: the engine in this process on the same model, host clock
   per step, launches per step and device time by kernel (torch.profiler)
   in v4, ``auto`` and ``blockdot``, and at tp=2 on the f32 and the Q80
   wire (with the ring hop's launches and bytes per step); the TP prefill
   logits against one device's; the ring hops of one TP decode step timed;
   then each Q40 kernel, its plain version and ``torch.matmul`` timed over
   the 113 products of one decode step.
5. Kernel lab: the lab's three kernels (``q40_probe``, ``q40_lab_twodot``,
   ``dense_dot``) against their plain versions at a small shape and at the
   lab's default shape (d_in 4096, d_out 14336, 8 stacked planes) for every
   stage, layout and rounding flag; kernel_lab3's ``--check`` on the card;
   then the four lab modules (``distributed_llama_multiusers_tpu_torch/lab``)
   at their default shapes, every variant timed beside its bound, its plain
   version and its library call, with the lab kernels' launches counted
   over that run (``build/chip_smoke/chip_smoke_lab.json``).

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the port's package beside this file, it exits non-zero and prints
no result. Detail goes to ``build/chip_smoke/`` (JSON and server logs).
"""

from __future__ import annotations

import json
import math
import os
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "distributed_llama_multiusers_tpu_torch"
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet; dense, at the full 700 W limit)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12}

# Llama-3.2-1B: (site, d_in, d_out, launches per decode step over 16 layers)
SITES = [
    ("wq/wo", 2048, 2048, 32),
    ("wk/wv", 2048, 512, 32),
    ("w1/w3", 2048, 8192, 32),
    ("w2", 8192, 2048, 16),
    ("wcls", 2048, 128256, 1),
]
DECODE_M = 8  # the server's default lanes: every decode step is an 8-row product
TOL = 1e-4  # max|kernel - plain| <= TOL * max|plain| (f32 outputs)
GEN_TOKENS = 64


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions, and their times
# ---------------------------------------------------------------------------


def _weight(torch, q, d_in, d_out, gen, scale=6e-3):
    from distributed_llama_multiusers_tpu_torch.quants.packed import PackedQ40

    packed = torch.randint(0, 256, (d_in // 2, d_out), dtype=torch.uint8, device="cuda",
                           generator=gen)
    scales = (torch.randn((d_in // 32, d_out), device="cuda", generator=gen) * scale)
    return PackedQ40(packed, scales.to(torch.float16))


def _acts(torch, q, m, d_in, gen, dtype):
    """x as the main path hands it over (bf16 values), in ``dtype``."""
    x = torch.randn((m, d_in), device="cuda", generator=gen).to(torch.bfloat16)
    return q.make_q80_acts(x.to(dtype))


def _run(q, kernel, mode, acts, w, w_dtype):
    if kernel == "q40_slab":
        return (q.q40_slab(acts, w, w_dtype, mode),
                q.q40_slab_plain(acts.x2, w, w_dtype, mode, bsum=acts.bsum))
    if kernel == "q40_blockdot":
        return q.q40_blockdot(acts, w), q.q40_blockdot_plain(acts.x2, w, bsum=acts.bsum)
    return q.q40_i8blockdot(acts, w), q.q40_i8blockdot_plain(acts, w)


def compare(torch, q, kernel, mode, m, d_in, d_out, w, gen, w_dtype, results):
    """The kernel against its plain version on the same inputs: f32 outputs
    within TOL of max|plain|; bf16 outputs (the serving dtype) within one
    bf16 rounding step besides."""
    for dtype in (torch.float32, torch.bfloat16):
        acts = _acts(torch, q, m, d_in, gen, dtype)
        got, ref = _run(q, kernel, mode, acts, w, w_dtype)
        torch.cuda.synchronize()
        got, ref = got.float(), ref.float()
        check(bool(torch.isfinite(got).all()), f"{kernel}/{mode} m={m}: non-finite output")
        err = (got - ref).abs()
        scale = float(ref.abs().max())
        if dtype == torch.float32:
            ok = float(err.max()) <= TOL * scale
        else:
            ok = bool((err <= TOL * scale + 2.0 ** -7 * ref.abs()).all())
        results.append({"kernel": kernel, "mode": mode, "m": m, "d_in": d_in, "d_out": d_out,
                        "io": "f32" if dtype == torch.float32 else "bf16",
                        "max_abs_err": float(err.max()), "max_abs_ref": scale,
                        "tol": TOL, "ok": ok})
        check(ok, f"{kernel}/{mode} {d_in}x{d_out} m={m} io={dtype}: max|d| "
                  f"{float(err.max()):.3e} vs max|y| {scale:.3e}")


def graph_ms(torch, calls, reps=5):
    """Device time per call: the calls captured back to back in one CUDA
    graph (no host launch overhead between them), replayed ``reps`` times
    between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls[:2]:
            c()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for c in calls:
            c()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def eager_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(q, kernel, mode, m, d_in, d_out):
    """(bound_ms, bound_by): the larger of the bytes the product must move
    over the memory rate and its operations over the peak for their type."""
    t_bytes = q.bound_bytes(m, d_in, d_out, mode) / HBM_BYTES_S
    kind = "int8" if kernel == "q40_i8blockdot" else "bf16"
    t_ops = q.bound_ops(m, d_in, d_out) / PEAK_OPS_S[kind]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def time_site(torch, q, kernel, mode, m, d_in, d_out, gen):
    """Kernel, plain and torch.matmul times at one site. Weights rotate
    over enough copies to exceed the 50 MB L2, as a decode step that
    streams ~700 MB of weights finds them."""
    from distributed_llama_multiusers_tpu_torch.quants.packed import unpack_q40

    wbytes = d_in * d_out // 2 + (d_in // 32) * d_out * 2
    n = max(1, min(48, math.ceil(120e6 / wbytes)))
    ws = [_weight(torch, q, d_in, d_out, gen) for _ in range(n)]
    acts = _acts(torch, q, m, d_in, gen, torch.bfloat16)
    if kernel == "q40_i8blockdot":
        acts.xq  # noqa: B018 — build the Q80 operands outside the timed calls
    calls = []
    for i in range(max(n, 8)):
        w = ws[i % n]
        if kernel == "q40_slab":
            calls.append(lambda w=w: q.q40_slab(acts, w, torch.bfloat16, mode))
        elif kernel == "q40_blockdot":
            calls.append(lambda w=w: q.q40_blockdot(acts, w))
        else:
            calls.append(lambda w=w: q.q40_i8blockdot(acts, w))
    ms = graph_ms(torch, calls)
    plain = {"q40_slab": lambda: q.q40_slab_plain(acts.x2, ws[0], torch.bfloat16, mode,
                                                  bsum=acts.bsum),
             "q40_blockdot": lambda: q.q40_blockdot_plain(acts.x2, ws[0], bsum=acts.bsum),
             "q40_i8blockdot": lambda: q.q40_i8blockdot_plain(acts, ws[0])}[kernel]
    plain_ms = eager_ms(torch, plain, 3)
    dense_bytes = d_in * d_out * 2
    nd = max(1, min(16, math.ceil(120e6 / dense_bytes)))
    dense = [unpack_q40(ws[i % n], torch.bfloat16) for i in range(nd)]
    x = acts.x2
    lib = [lambda w=w: torch.matmul(x, w) for w in dense] * max(1, 8 // nd)
    library_ms = graph_ms(torch, lib)
    del ws, dense
    b_ms, b_by = bound(q, kernel, mode, m, d_in, d_out)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def kernel_phase(torch, q) -> tuple[list, list]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks: list = []
    t0 = time.perf_counter()
    for site, d_in, d_out, _ in SITES:
        w = _weight(torch, q, d_in, d_out, gen)
        for m in (1, 8, 32, 33, 512):
            for mode in ("v4", "bf16chain"):
                compare(torch, q, "q40_slab", mode, m, d_in, d_out, w, gen,
                        torch.bfloat16, checks)
            if m <= q.BLOCKDOT_MAX_M:
                compare(torch, q, "q40_blockdot", "blockdot", m, d_in, d_out, w, gen,
                        torch.bfloat16, checks)
                compare(torch, q, "q40_i8blockdot", "i8blockdot", m, d_in, d_out, w, gen,
                        torch.bfloat16, checks)
        # an f32 dot always runs v4 without rounding the operands
        compare(torch, q, "q40_slab", "v4", 8, d_in, d_out, w, gen, torch.float32, checks)
        del w
    # repeat and u8chain run the slab kernel's bf16 chain
    w = _weight(torch, q, 2048, 512, gen)
    for mode in ("repeat", "u8chain"):
        compare(torch, q, "q40_slab", mode, 8, 2048, 512, w, gen, torch.bfloat16, checks)
    # f16-denormal scales (|s| < 6.1e-5) convert exactly in every kernel
    wd = _weight(torch, q, 2048, 512, gen, scale=2e-6)
    check(bool((wd.scales.abs() < 6.1e-5).any()), "no f16 denormal scales drawn")
    for m in (1, 32):
        for kernel, mode in (("q40_slab", "v4"), ("q40_slab", "bf16chain"),
                             ("q40_blockdot", "blockdot"), ("q40_i8blockdot", "i8blockdot")):
            compare(torch, q, kernel, mode, m, 2048, 512, wd, gen, torch.bfloat16, checks)
    compare(torch, q, "q40_slab", "bf16chain", 33, 2048, 512, wd, gen, torch.bfloat16, checks)
    # the m = 32/33 boundary through the dispatch: which kernel launches
    for mode, at32 in (("auto", "q40_i8blockdot"), ("i8blockdot", "q40_i8blockdot"),
                       ("blockdot", "q40_blockdot")):
        q.set_dequant_mode(mode)
        try:
            for m, expect in ((32, at32), (33, "q40_slab")):
                before = dict(q.LAUNCHES)
                acts = _acts(torch, q, m, 2048, gen, torch.float32)
                y = q.q40_matmul(acts, w)
                torch.cuda.synchronize()
                moved = [k for k in q.KERNELS if q.LAUNCHES[k] != before[k]]
                check(moved == [expect], f"{mode} m={m}: launched {moved}, expected {expect}")
                ref = _run(q, expect, q.resolve_kernel_mode(m, 2048, 512, torch.bfloat16),
                           acts, w, torch.bfloat16)[1]
                err = float((y.float() - ref.float()).abs().max())
                check(err <= TOL * float(ref.abs().max()), f"{mode} m={m}: max|d| {err:.3e}")
                checks.append({"kernel": expect, "mode": mode, "m": m, "d_in": 2048,
                               "d_out": 512, "io": "f32", "routing": True,
                               "max_abs_err": err, "max_abs_ref": float(ref.abs().max()),
                               "tol": TOL, "ok": True})
        finally:
            q.set_dequant_mode(None)
    log(f"kernel checks: {len(checks)} comparisons within tolerance "
        f"({time.perf_counter() - t0:.1f}s)")

    timings: list = []
    t0 = time.perf_counter()
    plan = [("q40_slab", "v4", ms) for ms in (1, DECODE_M, 512)]
    plan += [("q40_slab", "bf16chain", ms) for ms in (DECODE_M, 512)]
    plan += [("q40_blockdot", "blockdot", ms) for ms in (1, DECODE_M)]
    plan += [("q40_i8blockdot", "i8blockdot", ms) for ms in (1, DECODE_M)]
    for kernel, mode, m in plan:
        for site, d_in, d_out, per_step in SITES:
            t = time_site(torch, q, kernel, mode, m, d_in, d_out, gen)
            row = {"kernel": kernel, "mode": mode, "site": site, "m": m, "d_in": d_in,
                   "d_out": d_out, "per_decode_step": per_step, **t}
            timings.append(row)
            log("timing " + json.dumps(row))
    log(f"kernel timings: {len(timings)} sites ({time.perf_counter() - t0:.1f}s)")
    return checks, timings


# ---------------------------------------------------------------------------
# Phase 2b: the ring hop kernel and the ring collectives
# ---------------------------------------------------------------------------

NVLINK_BYTES_S = 450e9  # H100 SXM NVLink, each way (NVIDIA data sheet)
# the tensor-parallel path's hop payloads at the 1B geometry and 8 lanes
HOP_PAYLOADS = [
    ("f32 ring chunk, tp=2", 2, (8, 1024), "float32"),
    ("f32 ring chunk, tp=4", 4, (8, 512), "float32"),
    ("Q80 wire values, tp=2", 2, (8, 32, 32), "int8"),
    ("Q80 wire scales, tp=2", 2, (8, 32, 1), "float16"),
    ("f32 logits shard, tp=2", 2, (8, 64128), "float32"),
    ("f32 prefill chunk, tp=2", 2, (512, 1024), "float32"),
]


def rank_devices(torch, n: int) -> list:
    """One device per rank: distinct cards where the host has them, else the
    cards repeated (one card serves every rank)."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", r % count) for r in range(n)]


def _payload(torch, shape, dtype: str, gen):
    if dtype == "int8":
        return torch.randint(-128, 128, shape, dtype=torch.int8, device="cuda", generator=gen)
    return torch.randn(shape, device="cuda", generator=gen).to(getattr(torch, dtype))


def hop_bound_ms(nbytes: int, same_card: bool) -> float:
    """One card: the copy reads and writes device memory; across cards the
    bytes cross NVLink once."""
    return (2 * nbytes / HBM_BYTES_S if same_card else nbytes / NVLINK_BYTES_S) * 1e3


def time_hops(torch, rc, xs_sets: list, reps: int = 4) -> dict:
    """Per-set device time of ``ring_shift`` over every ranks list in
    ``xs_sets`` (the kernel, one CUDA graph where all ranks share one card,
    else eager between events), of ``dst.copy_(src)`` for the same hops (the
    library yardstick) and of the plain version (eager)."""
    srcs, dsts = [], []
    for xs in xs_sets:
        n = len(xs)
        srcs += [xs[(r - 1) % n] for r in range(n)]
        dsts += [torch.empty_like(x) for x in xs]
    one_card = len({x.device for xs in xs_sets for x in xs}) == 1
    hop = [lambda xs=xs: rc.ring_shift(xs) for xs in xs_sets]
    lib = [lambda d=d, s=s: d.copy_(s) for d, s in zip(dsts, srcs)]
    if one_card:
        ms = graph_ms(torch, hop * reps) * len(hop)
        library_ms = graph_ms(torch, lib * reps) * len(lib)
    else:
        ms = eager_ms(torch, lambda: [c() for c in hop], 20)
        library_ms = eager_ms(torch, lambda: [c() for c in lib], 20)
    plain_ms = eager_ms(torch, lambda: [rc.ring_shift_plain(xs) for xs in xs_sets], 5)
    nbytes = sum(s.numel() * s.element_size() for s in srcs)
    return {"ms": ms, "library_ms": library_ms, "plain_ms": plain_ms, "launches": len(srcs),
            "bytes": nbytes, "same_card": one_card,
            "bound_ms": hop_bound_ms(nbytes, one_card), "bound_by": "bytes"}


def hop_phase(torch, rc) -> list:
    """The hop kernel against its plain version, bit for bit, on each of the
    path's payloads, then its time per launch beside ``copy_`` and the
    bound."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for label, n, shape, dtype in HOP_PAYLOADS:
        devs = rank_devices(torch, n)
        xs = [_payload(torch, shape, dtype, gen).to(d) for d in devs]
        got, ref = rc.ring_shift(xs), rc.ring_shift_plain(xs)
        torch.cuda.synchronize()
        err = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
        check(all(torch.equal(g, r) and g.device == r.device for g, r in zip(got, ref)),
              f"ring_hop on {label}: differs from its plain version (max|d| {err:.3e})")
        t = time_hops(torch, rc, [xs])
        row = {"payload": label, "ranks": n, "shape": list(shape), "dtype": dtype,
               "placement": "same card" if t["same_card"] else "peer across cards",
               "max_abs_err": err, "ms_per_launch": t["ms"] / n,
               "library_ms_per_launch": t["library_ms"] / n,
               "plain_ms_per_launch": t["plain_ms"] / n,
               "bound_ms_per_launch": t["bound_ms"] / n, "bytes_per_launch": t["bytes"] // n}
        rows.append(row)
        log("hop " + json.dumps(row))
    return rows


def collectives_phase(torch, q, rc) -> list:
    """The ring collectives at tp=2 and tp=4 on the card, each against the
    same function run with the plain hop: bit for bit (the copies are exact
    and the kernels deterministic)."""
    from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
    from distributed_llama_multiusers_tpu_torch.parallel.sharding import col_shards

    gen = torch.Generator(device="cuda").manual_seed(3)
    w = _weight(torch, q, 2048, 2048, gen)
    out = []
    kernel_shift = rc.ring_shift
    for n in (2, 4):
        devs = rank_devices(torch, n)
        ws = col_shards(w, make_mesh(MeshPlan(tp=n), devs))
        parts = [torch.randn((8, 1, 2048), device="cuda", generator=gen).to(d) for d in devs]
        chunks = [p[..., : 2048 // n].contiguous() for p in parts]
        xs = [p[..., : 2048 // n].to(torch.bfloat16).contiguous() for p in parts]
        cases = {
            "ring_reduce_scatter": lambda: rc.ring_reduce_scatter(parts),
            "ring_all_gather": lambda: rc.ring_all_gather(chunks),
            "ring_all_gather_q80": lambda: rc.ring_all_gather_q80(chunks),
            "ring_sync_matmul": lambda: rc.ring_sync_matmul(xs, ws),
            "ring_sync_matmul_q80_wire": lambda: rc.ring_sync_matmul(xs, ws, q80_wire=True),
        }
        for name, fn in cases.items():
            got = fn()
            rc.ring_shift = lambda ys, chan=0: rc.ring_shift_plain(ys)
            try:
                ref = fn()
            finally:
                rc.ring_shift = kernel_shift
            torch.cuda.synchronize()
            same = all(torch.equal(g, r) for g, r in zip(got, ref))
            check(same, f"{name} tp={n}: the kernel hop and the plain hop disagree")
            out.append({"collective": name, "tp": n, "bit_exact": same,
                        "shape": list(got[0].shape)})
    log(f"ring collectives: {len(out)} checks bit-exact against the plain hop")
    return out


# ---------------------------------------------------------------------------
# Phase 3: serving the full-width model
# ---------------------------------------------------------------------------


def llama32_1b_header():
    from distributed_llama_multiusers_tpu_torch.formats.model_file import RopeType
    from distributed_llama_multiusers_tpu_torch.formats.synthetic import tiny_header

    h = tiny_header(dim=2048, hidden_dim=8192, n_layers=16, n_heads=32, n_kv_heads=8,
                    vocab_size=128256, seq_len=2048, rope_type=RopeType.LLAMA3_1,
                    rope_theta=500000.0)
    h.rope_scaling_factor = 32.0
    h.rope_scaling_low_freq_factor = 1.0
    h.rope_scaling_high_freq_factor = 4.0
    h.rope_scaling_orig_max_seq_len = 8192
    return h


def ensure_model(header, seed: int = 0, cache_dir: str | None = None) -> tuple[str, str]:
    """The synthetic .m/.t for ``header`` and ``seed`` in the cache
    directory, written anew unless a previous run left the same ones."""
    from distributed_llama_multiusers_tpu_torch.formats.synthetic import (
        write_synthetic_model,
        write_synthetic_tokenizer,
    )

    cache_dir = cache_dir or os.path.join(ROOT, "build", "synthetic")
    os.makedirs(cache_dir, exist_ok=True)
    key = {"kv": header.to_kv_pairs(), "seed": seed}
    stem = os.path.join(cache_dir, f"llama_d{header.dim}_l{header.n_layers}_s{seed}")
    model, tok, meta = stem + ".m", stem + ".t", stem + ".json"
    if os.path.exists(meta) and os.path.exists(model) and os.path.exists(tok):
        with open(meta) as f:
            if json.load(f) == json.loads(json.dumps(key)):
                log(f"model: reusing {model}")
                return model, tok
    t0 = time.perf_counter()
    write_synthetic_model(model, header, seed=seed)
    write_synthetic_tokenizer(tok, vocab_size=header.vocab_size)
    with open(meta, "w") as f:
        json.dump(key, f)
    log(f"model: wrote {model} ({os.path.getsize(model) / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f}s")
    return model, tok


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url, body=None, timeout=600):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _stream(url, body, timeout=600):
    req = urllib.request.Request(url, data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    text, last, n_deltas = "", None, 0
    with urllib.request.urlopen(req, timeout=timeout) as r:
        status = r.status
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            chunk = json.loads(line[6:])
            check("error" not in chunk, f"stream error: {chunk}")
            choice = chunk["choices"][0]
            piece = choice.get("text") or (choice.get("delta") or {}).get("content") or ""
            text += piece
            n_deltas += bool(piece)
            last = chunk
    return status, text, last, n_deltas


def _text(body):
    c = body["choices"][0]
    return c["text"] if "text" in c else c["message"]["content"]


def serve_pass(model: str, tok: str, mode: str | None, n_tokens: int,
               extra_args=(), log_dir: str = OUT_DIR, health_timeout: float = 900.0,
               name: str | None = None) -> dict:
    """One dllama_api process: 4 concurrent requests, checks, /stats,
    SIGTERM. Returns the pass's measurements, launch counts and startup log."""
    os.makedirs(log_dir, exist_ok=True)
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    name = name or mode or "default"
    cmd = [sys.executable, "-m", f"{PKG}.app.dllama_api", "--model", model,
           "--tokenizer", tok, "--host", "127.0.0.1", "--port", str(port),
           *(["--dequant", mode] if mode else []), *extra_args]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("DLLAMA_DEQUANT", None)
    log_path = os.path.join(log_dir, f"chip_smoke_server_{name}.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT)
    try:
        while True:
            check(proc.poll() is None, f"server ({name}) exited with {proc.returncode}; "
                                       f"see {log_path}")
            try:
                if _http(base + "/health", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            check(time.perf_counter() - t0 < health_timeout, f"server ({name}) not healthy")
            time.sleep(1.0)
        startup_s = time.perf_counter() - t0

        greedy = ("/v1/completions", {"prompt": "hello world, the quick brown fox",
                                      "max_tokens": n_tokens, "temperature": 0})
        bodies = [
            greedy,
            ("/v1/completions", {"prompt": "once upon a time", "max_tokens": n_tokens,
                                 "temperature": 0.8, "top_p": 0.9, "seed": 7}),
            ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hello"}],
                                      "max_tokens": n_tokens, "temperature": 0,
                                      "stream": True}),
            ("/v1/chat/completions", {"messages": [{"role": "user", "content": "tell me"}],
                                      "max_tokens": n_tokens, "temperature": 0.7,
                                      "top_p": 0.95, "seed": 11}),
        ]
        alone_before = json.loads(_http(base + greedy[0], greedy[1])[1])
        results: list = [None] * len(bodies)
        errors: list = []

        def worker(i, route, body):
            try:
                if body.get("stream"):
                    status, text, last, n_deltas = _stream(base + route, body)
                    results[i] = {"status": status, "text": text, "stream": True,
                                  "deltas": n_deltas, "finish": last["choices"][0].get(
                                      "finish_reason"), "summary": last.get("summary", {})}
                else:
                    status, raw = _http(base + route, body)
                    b = json.loads(raw)
                    results[i] = {"status": status, "text": _text(b),
                                  "finish": b["choices"][0]["finish_reason"],
                                  "completion_tokens": b["usage"]["completion_tokens"],
                                  "summary": b.get("summary", {})}
            except Exception as e:  # noqa: BLE001 — re-raised as a failure below
                errors.append(f"{route}: {type(e).__name__}: {e}")

        t_batch = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(i, r, b))
                   for i, (r, b) in enumerate(bodies)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        batch_s = time.perf_counter() - t_batch
        check(not errors, f"requests failed ({name}): {errors}")
        check(all(r is not None for r in results), f"a request did not finish ({name})")
        alone_after = json.loads(_http(base + greedy[0], greedy[1])[1])
        check(_text(alone_before) == _text(alone_after),
              f"repeated greedy request changed its text ({name})")
        check(alone_before["usage"]["completion_tokens"] >= 1, "greedy request made no tokens")

        for r in results:
            check(r["status"] == 200, f"status {r['status']} ({name})")
            if r.get("stream"):
                check(r["deltas"] >= 1, f"streamed request sent no deltas ({name})")
                n = r["summary"].get("n_tokens", 0)
            else:
                n = r["completion_tokens"]
            check(1 <= n <= n_tokens, f"{n} tokens for max_tokens {n_tokens} ({name})")
            check(n == n_tokens or r["finish"] == "stop",
                  f"{n} tokens, finish {r['finish']} ({name})")
            r["n_tokens"] = n
        stats = json.loads(_http(base + "/stats")[1])
        status, models = _http(base + "/v1/models")
        check(status == 200 and json.loads(models)["data"], "/v1/models")

        ttft = [r["summary"]["ttft_s"] * 1e3 for r in results if "ttft_s" in r["summary"]]
        per_req = [r["summary"]["decode_tok_s"] for r in results
                   if "decode_tok_s" in r["summary"]]
        total_tokens = sum(r["n_tokens"] for r in results)
        out = {"mode": name, "args": list(extra_args), "startup_s": startup_s,
               "batch_s": batch_s, "greedy_text": _text(alone_before),
               "ttft_ms": ttft, "ttft_ms_p50": statistics.median(ttft) if ttft else None,
               "decode_tok_s_per_request": per_req,
               "tokens_per_s_batch": total_tokens / batch_s,
               "n_tokens": [r["n_tokens"] for r in results],
               "kernel_launches": stats["kernel_launches"],
               "ring_hop_launches": stats["ring_hop_launches"],
               "ring_hop_bytes": stats["ring_hop_bytes"],
               "sync_bytes_per_decode": stats["sync_bytes_per_decode"],
               "mesh": stats["mesh"],
               "dequant_mode": stats["dequant_mode"],
               "dequant_sites": stats.get("dequant_sites", {}),
               "decode_steps": stats["decode_steps"], "device": stats["device"]}
        log(f"TTFT ms [{name}]: p50 {out['ttft_ms_p50']} per request {ttft}")
        log(f"decode tok/s [{name}]: per request {per_req}, batch of 4 "
            f"{out['tokens_per_s_batch']:.1f} tok/s ({total_tokens} tokens in {batch_s:.2f}s)")
        log(f"launches [{name}]: {stats['kernel_launches']}")

        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=90)
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"server ({name}) did not exit after SIGTERM") from None
        check(rc == 0, f"server ({name}) exited {rc} after SIGTERM; see {log_path}")
        with open(log_path, errors="replace") as f:
            out["log"] = f.read()
        return out
    except BaseException:
        with open(log_path, errors="replace") as f:
            tail = f.readlines()[-40:]
        print(f"--- last lines of {log_path}:\n" + "".join(tail), file=sys.stderr, flush=True)
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def serving_phase(torch, q) -> list:
    torch.cuda.empty_cache()  # the servers are other processes on this card
    model, tok = ensure_model(llama32_1b_header(), seed=0)
    passes = []
    # mode -> the kernels its run must have launched
    for mode, n_tokens, expect in ((None, GEN_TOKENS, ("q40_slab",)),
                                   ("auto", GEN_TOKENS, ("q40_i8blockdot", "q40_slab")),
                                   ("blockdot", 16, ("q40_blockdot", "q40_slab"))):
        p = serve_pass(model, tok, mode, n_tokens)
        check(p["device"].startswith("cuda"), f"server ran on {p['device']}")
        for k in expect:
            check(p["kernel_launches"][k] > 0, f"{p['mode']}: {k} never launched")
        passes.append(p)
    passes += tp_serving_passes(torch, model, tok, passes[0])
    return passes


def _common_prefix(a: list, b: list) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def tp_serving_passes(torch, model: str, tok: str, single: dict) -> list:
    """``dllama_api --workers 2`` at full width and depth on the host's
    cards (one card named twice where there is one): the defaults (v4, f32
    ring wire) and ``--buffer-float-type q80 --dequant auto`` (Q80 wire,
    i8blockdot decode). Each checks what ``serve_pass`` checks, the startup
    log's announcements and the ring hop's launches on /stats."""
    from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer

    devices = ",".join(str(d) for d in rank_devices(torch, 2))
    tokenizer = Tokenizer(tok)
    ref = tokenizer.encode(single["greedy_text"], add_bos=False)
    passes = []
    for name, mode, extra, expect, says in (
            ("tp2", None, (), ("q40_slab",), ("Ring TP sync",)),
            ("tp2-q80-auto", "auto", ("--buffer-float-type", "q80"),
             ("q40_i8blockdot", "q40_slab"), ("Ring TP sync", "(Q80 wire)",
                                              "Q80 sync transport"))):
        p = serve_pass(model, tok, mode, GEN_TOKENS, name=name,
                       extra_args=("--workers", "2", "--device", devices, *extra))
        check(p["mesh"] is not None and p["mesh"]["tp"] == 2, f"{name}: /stats mesh {p['mesh']}")
        check(p["ring_hop_launches"] > 0, f"{name}: ring_hop never launched")
        for k in expect:
            check(p["kernel_launches"][k] > 0, f"{name}: {k} never launched")
        for phrase in ("Mesh: dp=1 pp=1 tp=2",) + says:
            check(phrase in p["log"], f"{name}: the startup log does not say {phrase!r}")
        got = tokenizer.encode(p["greedy_text"], add_bos=False)
        p["greedy_tokens_matching_single_device"] = _common_prefix(got, ref)
        p["greedy_tokens"] = len(got)
        log(f"greedy tokens [{name}]: the first {_common_prefix(got, ref)} of {len(got)} "
            "match the single-device v4 pass (information only: bf16 sums in another "
            "order may part a random model's near-ties)")
        log(f"ring_hop [{name}]: {p['ring_hop_launches']} launches, {p['ring_hop_bytes']} "
            f"bytes; sync_bytes_per_decode {p['sync_bytes_per_decode']}")
        passes.append(p)
    return passes


STEP_WEIGHTS = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")
# the mode whose decode steps run each kernel (the default v4 runs the slab)
DECODE_MODE_OF = {"q40_slab": "v4", "q40_blockdot": "blockdot", "q40_i8blockdot": "auto"}


def step_products(params) -> list:
    """The packed weights of one decode step's Q40 products, in the order
    llama_forward runs them: 7 per layer, then wcls."""
    ws = []
    for layer in range(params.layers.wq.packed.shape[0]):
        lp = params.layers.layer(layer)
        ws += [getattr(lp, name) for name in STEP_WEIGHTS]
    return ws + [params.wcls]


def _kernel_of(name: str) -> str | None:
    """The port's kernel behind a profiler kernel name (reduce_splits is
    the split-K sum launch every Q40 wrapper may add)."""
    for tag, kernel in (("i8blockdot_kernel", "q40_i8blockdot"),
                        ("blockdot_kernel", "q40_blockdot"),
                        ("slab_kernel", "q40_slab"), ("reduce_splits", "reduce_splits"),
                        ("hop_vec16", "ring_hop"), ("hop_bytes", "ring_hop")):
        if tag in name:
            return kernel
    return None


def sync_all(torch) -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def step_breakdown(torch, q, rc, config, params, mode: str, lanes: int = 8, busy: int = 4,
                   steps: int = 10, mesh=None, q80: bool = False,
                   label: str | None = None) -> dict:
    """Where a serving decode step's time goes: the engine in this process
    on the full-width model, ``busy`` of ``lanes`` lanes decoding (the
    smoke's 4 concurrent requests on the server's 8 lanes); with ``mesh``,
    tensor parallel over its ranks (``q80``: the Q80 wire, as
    ``--buffer-float-type q80`` serves it). Host clock per synchronous step,
    the kernels' launch counters over those steps, the ring hop's bytes, and
    device time and launches by kernel from torch.profiler."""
    from distributed_llama_multiusers_tpu_torch.parallel.collectives import q80_sync_engages
    from distributed_llama_multiusers_tpu_torch.parallel.sharding import shard_params
    from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    label = label or mode
    q80_wire = q80 and mesh is not None and q80_sync_engages(config, mesh.shape)
    q.set_dequant_mode(mode)
    try:
        engine = InferenceEngine(
            config, params if mesh is None else shard_params(params, mesh), n_lanes=lanes,
            device="cuda", mesh=mesh, emulate_q80_activations=q80, q80_sync=q80_wire)
        tokens = np.zeros(lanes, np.int64)
        positions = np.full(lanes, config.seq_len, np.int64)
        temps = np.zeros(lanes, np.float32)
        prefill_logits = None
        for lane in range(busy):
            prompt = [(97 * lane + 13 * i) % 100 + 1 for i in range(40)]
            last, tokens[lane], positions[lane] = engine.prefill(lane, prompt)
            if prefill_logits is None:
                prefill_logits = last.float().cpu()
            temps[lane] = 0.8 if lane % 2 else 0.0  # half the lanes sample
        seeds = np.arange(lanes, dtype=np.uint32)

        def step():
            _, greedy, sampled = engine.decode(tokens, positions, temps, seeds=seeds,
                                               want_logits=False)
            tokens[:busy] = np.where(temps[:busy] > 0, sampled[:busy], greedy[:busy])
            positions[:busy] += 1

        for _ in range(3):
            step()
        sync_all(torch)
        wall = []
        before = dict(q.LAUNCHES)
        ring_before = rc.ring_counts()
        for _ in range(steps):
            t0 = time.perf_counter()
            step()  # decode reads the tokens back: each step ends synchronized
            wall.append((time.perf_counter() - t0) * 1e3)
        launches = {k: (q.LAUNCHES[k] - before[k]) / steps for k in q.KERNELS}
        ring = {k: (v - ring_before[k]) / steps for k, v in rc.ring_counts().items()}
        # per rank and layer: wq, wk, wv, w1, w3 and n column chunks each of
        # wo and w2; then wcls (n = 1: the 7 products of one device)
        n, n_layers = len(engine.devices), config.n_layers
        n_products = n * (n_layers * (5 + 2 * n) + 1)
        check(sum(launches.values()) == n_products,
              f"decode step [{label}]: {launches} Q40 launches per step, expected "
              f"{n_products} products")
        check(ring["ring_hop_bytes"] == engine.stats.sync_bytes_per_decode,
              f"decode step [{label}]: hop bytes {ring} against sync_bytes_per_decode "
              f"{engine.stats.sync_bytes_per_decode}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            sync_all(torch)
            prof_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        by_name: dict = {}
        host: dict = {}
        kernels: dict = {}  # kernel -> [device us per step, launches per step]
        for e in prof.key_averages():
            # kernels only: an aten op's own device time repeats its kernels'
            us = getattr(e, "self_device_time_total", 0.0) or 0.0
            if us > 0 and e.device_type != DeviceType.CPU:
                by_name[e.key] = by_name.get(e.key, 0.0) + us / steps
                kernel = _kernel_of(e.key)
                if kernel:
                    acc = kernels.setdefault(kernel, [0.0, 0.0])
                    acc[0] += us / steps
                    acc[1] += e.count / steps
            if e.self_cpu_time_total > 0:
                host[e.key] = (e.self_cpu_time_total / steps, e.count // steps)
        device_ms = sum(by_name.values()) / 1e3
        q40_ms = sum(v[0] for k, v in kernels.items() if k != "ring_hop") / 1e3
        hop_ms = kernels.get("ring_hop", [0.0, 0.0])[0] / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        out = {"mode": label, "dequant": mode, "ranks": [str(d) for d in engine.devices],
               "q80_wire": q80_wire,
               "lanes": lanes, "busy_lanes": busy,
               "step_ms_p50": statistics.median(wall), "step_ms": wall,
               "profiled_step_ms": prof_wall_ms, "device_ms_per_step": device_ms,
               # device time over the unprofiled step: the profiler slows the
               # host side, not the kernels
               "device_busy_share": device_ms / statistics.median(wall),
               "q40_kernels_ms_per_step": q40_ms,
               "ring_hop_ms_per_step": hop_ms,
               "launches_per_step": launches,
               "ring_hop_launches_per_step": ring["ring_hop_launches"],
               "sync_bytes_per_decode": engine.stats.sync_bytes_per_decode,
               "q40_profiled_us_launches_per_step": kernels,
               "top_device_us_per_step": [[k[:90], v] for k, v in top],
               "top_host_us_calls_per_step": [
                   [k[:60], us, n] for k, (us, n) in
                   sorted(host.items(), key=lambda kv: -kv[1][0])[:12]],
               "prefill_logits": prefill_logits}
        log(f"decode step [{label}]: p50 {out['step_ms_p50']:.2f} ms host clock, "
            f"device busy {device_ms:.2f} ms ({out['device_busy_share']:.3f} of the step), "
            f"Q40 kernels {q40_ms:.3f} ms, ring_hop {hop_ms:.3f} ms, launches per step "
            f"{launches}, ring_hop {ring['ring_hop_launches']}, sync_bytes_per_decode "
            f"{engine.stats.sync_bytes_per_decode}, profiled {kernels}")
        del engine
        torch.cuda.empty_cache()
        return out
    finally:
        q.set_dequant_mode(None)


def step_matmuls(torch, q, params, m: int = DECODE_M) -> dict:
    """Each kernel over the Q40 products of one decode step of the loaded
    model (16 layers x 7 + wcls) at m rows, on random bf16 activations:
    every output held against the plain version, then the kernel's time (the
    products back to back in one CUDA graph), the plain version's (eager)
    and torch.matmul's on the pre-dequantized bf16 weights (one CUDA graph),
    each per decode step."""
    from distributed_llama_multiusers_tpu_torch.quants.packed import unpack_q40

    gen = torch.Generator(device="cuda").manual_seed(1)
    ws = step_products(params)
    acts = {d: q.make_q80_acts(torch.randn((m, d), device="cuda", generator=gen)
                               .to(torch.bfloat16)) for d in sorted({w.d_in for w in ws})}
    for a in acts.values():
        a.xq  # noqa: B018 — build the Q80 operands outside the timed calls
    wrapper = {"q40_slab": lambda a, w: q.q40_slab(a, w, torch.bfloat16, "v4"),
               "q40_blockdot": q.q40_blockdot, "q40_i8blockdot": q.q40_i8blockdot}
    plain = {"q40_slab": lambda a, w: q.q40_slab_plain(a.x2, w, torch.bfloat16, "v4",
                                                       bsum=a.bsum),
             "q40_blockdot": lambda a, w: q.q40_blockdot_plain(a.x2, w, bsum=a.bsum),
             "q40_i8blockdot": q.q40_i8blockdot_plain}
    dense = [unpack_q40(w, torch.bfloat16) for w in ws]
    library_ms = graph_ms(torch, [lambda w=w: torch.matmul(acts[w.shape[0]].x2, w)
                                  for w in dense]) * len(dense)
    del dense
    torch.cuda.empty_cache()
    out = {}
    for kernel, run_mode in (("q40_slab", "v4"), ("q40_blockdot", "blockdot"),
                             ("q40_i8blockdot", "i8blockdot")):
        err = 0.0
        for w in ws:  # every product of the step against its plain version
            a = acts[w.d_in]
            got, ref = wrapper[kernel](a, w).float(), plain[kernel](a, w).float()
            d = (got - ref).abs()
            check(bool(torch.isfinite(got).all())
                  and bool((d <= TOL * float(ref.abs().max()) + 2.0 ** -7 * ref.abs()).all()),
                  f"{kernel} on the decode step's {w.d_in}x{w.d_out} product: max|d| "
                  f"{float(d.max()):.3e}")
            err = max(err, float(d.max()))
        ms = graph_ms(torch, [lambda w=w: wrapper[kernel](acts[w.d_in], w)
                              for w in ws]) * len(ws)
        plain_ms = eager_ms(torch, lambda: [plain[kernel](acts[w.d_in], w) for w in ws], 2)
        n_bytes = sum(q.bound_bytes(m, w.d_in, w.d_out, run_mode) for w in ws)
        n_ops = sum(q.bound_ops(m, w.d_in, w.d_out) for w in ws)
        t_bytes = n_bytes / HBM_BYTES_S
        t_ops = n_ops / PEAK_OPS_S["int8" if kernel == "q40_i8blockdot" else "bf16"]
        out[kernel] = {"mode": run_mode, "m": m, "products": len(ws), "ms": ms,
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": max(t_bytes, t_ops) * 1e3,
                       "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                       "bound_bytes": n_bytes, "bound_ops": n_ops, "max_abs_err_bf16_out": err}
        log(f"decode-step products [{kernel}, {run_mode}]: " + json.dumps(out[kernel]))
    return out


# TP prefill logits against one device's, on the card: the TP partials are
# rounded to bf16 before their f32 sum where one device rounds the whole sum
# once, and 16 layers of bf16 activations carry that difference to the logits
TP_LOGITS_TOL = 5e-2  # max|tp - single| <= TP_LOGITS_TOL * max|single|


def tp_step_hops(torch, config, devices, lanes: int = DECODE_M) -> list:
    """The ring hops of one tensor-parallel decode step on the f32 wire, as
    ranks lists: per wo/w2 sync n-1 hops of the reduce chunk and n-1 of the
    gather chunk [lanes, 1, dim/n] f32, then n-1 hops of the logits shards
    [lanes, 1, vocab/n] f32."""
    n = len(devices)
    chunk = [torch.randn((lanes, 1, config.dim // n)).to(d) for d in devices]
    logits = [torch.randn((lanes, 1, config.vocab_size // n)).to(d) for d in devices]
    return [chunk] * (2 * config.n_layers * 2 * (n - 1)) + [logits] * (n - 1)


def decode_phase(torch, q, rc, model: str):
    """Load the full-width model once; break a serving decode step down in
    each mode whose decode runs a different kernel, then tensor parallel at
    tp=2 (f32 and Q80 wire), hold the TP prefill logits against one
    device's, time the ring hops of one TP decode step, and time each Q40
    kernel over one decode step's products."""
    from distributed_llama_multiusers_tpu_torch.formats import load_model_header
    from distributed_llama_multiusers_tpu_torch.models import load_params_from_m_quantized
    from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh

    config, params = load_params_from_m_quantized(model, load_model_header(model),
                                                  dtype=torch.bfloat16, device="cuda")
    breakdown = [step_breakdown(torch, q, rc, config, params, mode)
                 for mode in dict.fromkeys(DECODE_MODE_OF.values())]
    devices = rank_devices(torch, 2)
    mesh = make_mesh(MeshPlan(tp=2), devices)
    tp = [step_breakdown(torch, q, rc, config, params, "v4", mesh=mesh,
                         label="tp2 v4, f32 wire"),
          step_breakdown(torch, q, rc, config, params, "auto", mesh=mesh, q80=True,
                         label="tp2 auto, Q80 wire")]
    ref, got = breakdown[0]["prefill_logits"], tp[0]["prefill_logits"]
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    check(bool(torch.isfinite(got).all()) and err <= TP_LOGITS_TOL * scale,
          f"tp2 prefill logits: max|tp - single| {err:.4e} against max|single| {scale:.4e}")
    tp_logits = {"max_abs_err": err, "max_abs_ref": scale, "tol": TP_LOGITS_TOL,
                 "argmax_equal": int(got.argmax()) == int(ref.argmax())}
    log("tp2 prefill logits against one device: " + json.dumps(tp_logits))
    hop_step = time_hops(torch, rc, tp_step_hops(torch, config, devices))
    check(hop_step["launches"] == tp[0]["ring_hop_launches_per_step"]
          and hop_step["bytes"] == tp[0]["sync_bytes_per_decode"],
          f"the timed hops ({hop_step['launches']}, {hop_step['bytes']} B) are not the "
          f"decode step's ({tp[0]['ring_hop_launches_per_step']}, "
          f"{tp[0]['sync_bytes_per_decode']} B)")
    log("ring hops of one tp2 decode step: " + json.dumps(hop_step))
    products = step_matmuls(torch, q, params)
    for b in breakdown + tp:
        del b["prefill_logits"]
    del params
    torch.cuda.empty_cache()
    return breakdown, tp, tp_logits, hop_step, products


# ---------------------------------------------------------------------------
# Phase 5: the kernel lab
# ---------------------------------------------------------------------------

# the lab's default shape: the Llama-3.1-8B w1/w3 site, 8 stacked planes
LAB_D_IN, LAB_D_OUT, LAB_L = 4096, 14336, 8
# (lab module, row) whose numbers stand for each lab kernel in the kernels line
LAB_LINE_ROWS = {"q40_probe": ("stage_probe", "u8 +unpack_i32"),
                 "q40_lab_twodot": ("kernel_lab", "v1_f32"),
                 "dense_dot": ("stage_probe", "dot_only bf16")}


def lab_checks(torch, lab) -> list:
    """Each lab kernel against its plain version on the card, at a small
    shape and at the lab's default shape: the probe at every stage, word
    and layout (bit for bit: integer sums and the dma row are exact; the
    scale stage within TOL), the two-dot product at every W rounding, x
    rounding and correction on both layouts, the dense dot in bf16 and f32
    (within TOL of max|plain|)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows: list = []

    def planes(shape):
        packed = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)
        sshape = (*shape[:-2], shape[-2] // 16, shape[-1])
        scales = torch.rand(sshape, device="cuda", generator=gen) * 0.01 + 1e-3
        return packed, scales.to(torch.float16)

    def record(kernel, case, got, ref, exact):
        torch.cuda.synchronize()
        check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
              f"{kernel} {case}: shape {tuple(got.shape)} or non-finite output")
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        ok = torch.equal(got, ref) if exact else err <= TOL * scale
        rows.append({"kernel": kernel, "case": case, "max_abs_err": err, "max_abs_ref": scale,
                     "rule": "bit-exact" if exact else f"max|d| <= {TOL} * max|plain|",
                     "ok": ok})
        check(ok, f"{kernel} {case}: max|d| {err:.3e} against max|plain| {scale:.3e}")

    half = LAB_D_IN // 2
    for label, shape, tile_rows, stages, words in (
            ("small", (2, 64, 1040), 32, lab.STAGES, True),
            ("row-major", (LAB_L, half, LAB_D_OUT), 1024, lab.STAGES, True),
            ("slab T=512", (LAB_L, LAB_D_OUT // 512, half, 512), None, lab.STAGES, True),
            ("wide rows=256", (LAB_L, half, LAB_D_OUT), 256, ("dma",), False)):
        packed, scales = planes(shape)
        cases = [(packed, st) for st in stages]
        cases += [(packed.view(torch.int32), st) for st in lab.U32_STAGES] if words else []
        for p, st in cases:
            sc = scales if st == "scale" else None
            record("q40_probe", f"{label} {tuple(p.shape)} {p.dtype} {st}",
                   lab.q40_probe(p, st, sc, tile_rows), lab.q40_probe_plain(p, st, sc, tile_rows),
                   exact=st != "scale")
        del packed, scales, cases
    for label, m, d_in, d_out, tile in (("small", 3, 512, 1536, 512),
                                        ("default", 1, LAB_D_IN, LAB_D_OUT, 512),
                                        ("default", 8, LAB_D_IN, LAB_D_OUT, 512)):
        packed, scales = planes((d_in // 2, d_out))
        x = torch.randn((m, d_in), device="cuda", generator=gen)
        for layout, (p, s) in (("row-major", (packed, scales)),
                               (f"tiled T={tile}", lab.retile(packed, scales, tile))):
            for w_round in lab.W_ROUNDS:
                for x_round in (False, True):
                    for corr in (True, False):
                        record("q40_lab_twodot", f"{label} m={m} {d_in}x{d_out} {layout} "
                               f"w={w_round} x_bf16={x_round} correction={corr}",
                               lab.q40_lab_twodot(x, p, s, w_round, x_round, corr),
                               lab.q40_lab_twodot_plain(x, p, s, w_round, x_round, corr),
                               exact=False)
    for label, m, d_in, d_out in (("small", 5, 256, 1000), ("default", 1, LAB_D_IN, LAB_D_OUT),
                                  ("default", 8, LAB_D_IN, LAB_D_OUT)):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((m, d_in), device="cuda", generator=gen).to(dt)
            w = torch.randn((d_in, d_out), device="cuda", generator=gen).to(dt)
            record("dense_dot", f"{label} m={m} {d_in}x{d_out} {dt}", lab.dense_dot(x, w),
                   lab.dense_dot_plain(x, w), exact=False)
    torch.cuda.empty_cache()
    log(f"lab kernel checks: {len(rows)} comparisons within tolerance")
    return rows


def lab_phase(torch, q, lab) -> dict:
    """The kernel lab on the card: each lab kernel against its plain
    version (``lab_checks``), kernel_lab3's ``--check``, then the four lab
    modules at their default shapes with plain and library times; the lab
    kernels' launch counts are read over the modules' runs."""
    from distributed_llama_multiusers_tpu_torch.lab import (
        kernel_lab,
        kernel_lab3,
        stage_probe,
        stage_probe2,
    )

    t0 = time.perf_counter()
    checks = lab_checks(torch, lab)
    try:
        check3 = kernel_lab3.check("cuda", out=log)
    except RuntimeError as e:
        raise SmokeFailure(str(e)) from e
    lab.reset_counts()
    q.reset_counts()
    try:
        runs = {"kernel_lab": kernel_lab.run(1, LAB_D_IN, LAB_D_OUT, LAB_L, "cuda", plain=True,
                                             out=log),
                "kernel_lab3": kernel_lab3.run(LAB_D_IN, LAB_D_OUT, LAB_L, 8, "cuda",
                                               plain=True, out=log)[0],
                "stage_probe": stage_probe.run(LAB_D_IN, LAB_D_OUT, LAB_L, 8, "cuda", plain=True,
                                               out=log),
                "stage_probe2": stage_probe2.run(LAB_D_IN, LAB_D_OUT, LAB_L, 8, "cuda",
                                                 plain=True, out=log)}
    except RuntimeError as e:
        raise SmokeFailure(f"lab: {e}") from e
    launches = dict(lab.LAUNCHES)
    serving = dict(q.LAUNCHES)
    for k in lab.KERNELS:
        check(launches[k] > 0, f"lab: {k} never launched on the lab path")
    for k in q.KERNELS:
        check(serving[k] > 0, f"lab: {k} never launched by kernel_lab/kernel_lab3")
    seconds = time.perf_counter() - t0
    log(f"lab: {sum(len(r) for r in runs.values())} variants, launches {launches}, serving "
        f"kernels {serving} ({seconds:.1f}s)")
    return {"checks": checks, "kernel_lab3_check": check3, "runs": runs, "launches": launches,
            "serving_launches": serving, "seconds": seconds}


def lab_line_entries(lab, lab_result) -> list:
    """The lab kernels' entries of the kernels line: ``launches`` counted
    over the lab modules' run, the times of the row named in
    LAB_LINE_ROWS, the errors of ``lab_checks``."""
    out = []
    for kernel, (module, name) in LAB_LINE_ROWS.items():
        row = next(r for r in lab_result["runs"][module] if r["name"] == name)
        mine = [c for c in lab_result["checks"] if c["kernel"] == kernel]
        out.append({
            "name": kernel, "route": "cuda", "source": lab.KERNEL_SOURCES[kernel],
            "replaces": lab.KERNEL_REPLACES[kernel][0],
            "replaces_all": list(lab.KERNEL_REPLACES[kernel]),
            "launches": lab_result["launches"][kernel],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "max_rel_err": max(c["max_abs_err"] / max(c["max_abs_ref"], 1e-30) for c in mine),
            "tol": TOL, "tol_rule": sorted({c["rule"] for c in mine}), "checks": len(mine),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": row["library"],
            "timed_as": f"{module} '{name}' at d_in {LAB_D_IN}, d_out {LAB_D_OUT}, "
                        f"{LAB_L} planes ({row['bytes']} bytes a pass): one pass in a CUDA "
                        "graph replayed between events, best of 3; plain eager",
            "lab_rows": {f"{m}/{r['name']}": r["ms"] for m, rs in lab_result["runs"].items()
                         for r in rs if r["kernel"] == kernel},
        })
    return out


# ---------------------------------------------------------------------------


def kernels_line(q, rc, checks, passes, breakdown, tp, hops, hop_step, products,
                 lab=None, lab_result=None) -> dict:
    """One entry per kernel. ``launches`` is the serving passes' count (the
    main path, each server counting from the end of its warmup). For a Q40
    kernel the times and the bound cover one decode step's products at the
    server's 8 lanes (``step_matmuls``); ``launches_per_decode_step`` and
    the profiled fields come from the engine's decode steps in the mode that
    runs the kernel (``step_breakdown``). For the ring hop they cover the
    hops of one tp=2 decode step on the f32 wire (``time_hops``) and the
    engine's TP decode steps."""
    out = []
    for kernel, mode in DECODE_MODE_OF.items():
        mine = [c for c in checks if c["kernel"] == kernel and c["io"] == "f32"]
        mine16 = [c for c in checks if c["kernel"] == kernel and c["io"] == "bf16"]
        p = products[kernel]
        step = next(b for b in breakdown if b["mode"] == mode)
        prof = step["q40_profiled_us_launches_per_step"]
        own, splits = prof.get(kernel, [0.0, 0.0]), prof.get("reduce_splits", [0.0, 0.0])
        out.append({
            "name": kernel, "route": "cuda", "source": q.KERNEL_SOURCES[kernel],
            "replaces": q.KERNEL_REPLACES[kernel],
            "launches": sum(p_["kernel_launches"][kernel] for p_ in passes),
            "launches_by_mode": {p_["mode"]: p_["kernel_launches"][kernel] for p_ in passes},
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "max_rel_err": max(c["max_abs_err"] / max(c["max_abs_ref"], 1e-30) for c in mine),
            "tol": TOL, "tol_rule": "f32 outputs: max|kernel - plain| <= tol * max|plain|",
            "checks": len(mine) + len(mine16),
            "max_abs_err_bf16_out": max([c["max_abs_err"] for c in mine16]
                                        + [p["max_abs_err_bf16_out"]]),
            "tol_rule_bf16_out": "bf16 outputs: |kernel - plain| <= tol * max|plain| "
                                 "+ 2^-7 * |plain| (one bf16 rounding step)",
            "ms": p["ms"], "plain_ms": p["plain_ms"], "library_ms": p["library_ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "timed_as": f"the {p['products']} Q40 products of one decode step of the "
                        f"loaded model at m={p['m']}, mode {p['mode']}: kernel and "
                        "torch.matmul in one CUDA graph each, plain eager",
            "launches_per_decode_step": step["launches_per_step"][kernel],
            "launches_per_tp2_decode_step": {b["mode"]: b["launches_per_step"][kernel]
                                             for b in tp},
            "profiled_in_mode": mode,
            "profiled_launches_per_decode_step": own[1],
            "profiled_reduce_splits_per_decode_step": splits[1],
            "profiled_ms_per_decode_step": own[0] / 1e3,
            "profiled_reduce_splits_ms_per_decode_step": splits[0] / 1e3,
            "launches_on_lab_path": lab_result["serving_launches"][kernel] if lab_result
            else None,
        })
    f32_step = tp[0]
    out.append({
        "name": rc.KERNEL, "route": "cuda", "source": rc.KERNEL_SOURCE,
        "replaces": rc.KERNEL_REPLACES,
        "launches": sum(p_["ring_hop_launches"] for p_ in passes),
        "launches_by_mode": {p_["mode"]: p_["ring_hop_launches"] for p_ in passes},
        "max_abs_err": max(h["max_abs_err"] for h in hops),
        "tol": 0.0, "tol_rule": "bit-exact against the plain version on every payload",
        "ms": hop_step["ms"], "plain_ms": hop_step["plain_ms"],
        "library_ms": hop_step["library_ms"], "bound_ms": hop_step["bound_ms"],
        "bound_by": hop_step["bound_by"],
        "placement": "same card" if hop_step["same_card"] else "peer across cards",
        "timed_as": f"the {hop_step['launches']} hops ({hop_step['bytes']} bytes) of one "
                    "tp=2 decode step at 8 lanes on the f32 wire: kernel and "
                    "dst.copy_(src) in one CUDA graph each where the ranks share a card, "
                    "plain eager",
        "launches_per_decode_step": f32_step["ring_hop_launches_per_step"],
        "launches_per_decode_step_by_mode": {b["mode"]: b["ring_hop_launches_per_step"]
                                             for b in tp},
        "sync_bytes_per_decode_by_mode": {b["mode"]: b["sync_bytes_per_decode"] for b in tp},
        "profiled_ms_per_decode_step": f32_step["ring_hop_ms_per_step"],
        "payloads": hops,
    })
    if lab_result:
        out += lab_line_entries(lab, lab_result)
    return {"kernels": out}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke.py: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; this script drives "
              "the port on a CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, PKG, "csrc")):
        print(f"chip_smoke.py: {PKG}/ is not beside this script; run it from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
        card = smi.stdout.strip().splitlines()[0]
        log(card)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

        from distributed_llama_multiusers_tpu_torch.ops import cuda_lab as lab
        from distributed_llama_multiusers_tpu_torch.ops import cuda_q40 as q
        from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc

        t0 = time.perf_counter()
        names = q.KERNELS + (rc.KERNEL,) + lab.KERNELS
        q.build_kernels(names)
        log(f"kernel build: {time.perf_counter() - t0:.1f}s ({', '.join(names)})")

        checks, timings = kernel_phase(torch, q)
        hops = hop_phase(torch, rc)
        collectives = collectives_phase(torch, q, rc)
        with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as f:
            json.dump({"card": card, "checks": checks, "timings": timings, "hops": hops,
                       "collectives": collectives}, f, indent=1)

        passes = serving_phase(torch, q)
        model, _ = ensure_model(llama32_1b_header(), seed=0)
        breakdown, tp, tp_logits, hop_step, products = decode_phase(torch, q, rc, model)
        with open(os.path.join(OUT_DIR, "chip_smoke_serving.json"), "w") as f:
            json.dump({"card": card,
                       "passes": [{k: v for k, v in p.items() if k != "log"} for p in passes],
                       "decode_step": breakdown, "tp_decode_step": tp,
                       "tp_prefill_logits": tp_logits, "tp_decode_step_hops": hop_step,
                       "decode_step_products": products}, f, indent=1)
        lab_result = lab_phase(torch, q, lab)
        with open(os.path.join(OUT_DIR, "chip_smoke_lab.json"), "w") as f:
            json.dump({"card": card, **lab_result}, f, indent=1)
        line = kernels_line(q, rc, checks, passes, breakdown, tp, hops, hop_step, products,
                            lab, lab_result)
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"total: {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
