#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card and the
CUDA toolkit (``nvcc``). Phases, each of which fails the run:

1. Setup: print the card's name and power limit (``nvidia-smi``), build the
   Q40 kernels, the ring step, the sampler, the decode attention and the
   lab's kernels from ``distributed_llama_multiusers_tpu_torch/
   csrc`` (one ``nvcc`` per source, all at once) and print the build time
   and the slab, blockdot and i8blockdot kernels' geometry (ring stages,
   shared memory per thread block, registers and spills, the plan at each
   1B site); count the tensor-core instructions in the tensor-core kernels'
   SASS (``cuobjdump -sass``: HMMA in blockdot, IMMA in i8blockdot),
   failing if a function has none, if either spills or has other than 3
   stages.
2. Kernels: at the Llama-3.2-1B matmul sites (2048->2048, 2048->512,
   2048->8192, 8192->2048, 2048->128256) hold every Q40 kernel and mode
   against its plain PyTorch version on the card (m = 1, 8, 32 for all three
   kernels; m = 33 and 512 for the slab kernel; f16-denormal scales; the
   m = 32/33 mode-routing boundary; the widths d_out = 6, 520 and 1026,
   which no kernel can read or write as vectors, in every mode and under
   ``auto`` through the dispatch; ``q40_blockdot`` and ``q40_i8blockdot``
   at their tensor-core fragment edges, m in 1..32, d_in 32, 64, 2048, d_out
   16..8192, with f16-extreme scales, and i8blockdot with its int8 values
   saturated at +-127 and all-zero blocks), then time each kernel, its
   plain version and ``torch.matmul`` on the pre-dequantized bf16 weight
   (i8blockdot at m = 1, 8 and 32). A speculative verify step's products
   (m = 32 at 8 lanes) row for row against the decode step's (m = 8) at
   the 1B sites in the three kernels, bit for bit under ``launch_plan``
   (recorded under two other k-split plans), each timed at m = 8 and 32
   under the three plans; under ``launch_plan`` also m = 4 x lanes against
   m = lanes for 1, 2 and 4 lanes. The ring step bit for bit against its
   plain version on each tensor-parallel payload (f32 ring chunks at tp=2
   and 4, the Q80 wire's values and scales, logits shards, a prefill
   chunk), timed beside ``dst.copy_(src)`` and its bound; each segment form
   (the bare hop, the add, the slot) at 32 KiB, 8 KiB and 2 MB, bit for bit,
   timed per hop beside its library call (``copy_``, ``torch.add(out=)``,
   the slot ``copy_``); the ring collectives at tp=2 and tp=4 against
   themselves on the plain ring step.
   The sampler kernel (``gumbel_sample``) against its plain version at the
   serving shape, 8 lanes x 128,256 sorted log-probabilities: choices
   equal, noise within 2^-20; timed beside its plain version and the
   library composition (``torch.rand``, -log(-log u), add, ``argmax``).
   The sampler also at vocabularies of 1 to 151,936 entries with an all
   -inf row and a row whose only finite entry is its last.
   The decode attention kernel (``decode_attn``) against its plain version
   at the 1B decode step's shapes (8 lanes, a bf16 cache of 2048 slots, the
   serving positions, positions across the cache, on and beside the
   kernel's split boundaries, and every lane live at 2047), a lane's bits
   (one of them on a split boundary) against another batch around it;
   timed beside its plain version and ``scaled_dot_product_attention``, and
   once more with every lane at 2047 (the long context). Its verify window
   (4 rows a lane from the serving positions, across the split boundaries,
   all at and past 2047) against its plain version and each row bit for
   bit against a one-row call; timed beside the same rows as four one-row
   calls, its plain version and ``scaled_dot_product_attention``.
3. Serving: write a full-width Llama-3.2-1B-shaped synthetic Q40 model (16
   layers, seed 0) into ``build/synthetic`` (reused while header and seed
   match), start ``python -m distributed_llama_multiusers_tpu_torch.app.
   dllama_api`` once per dequant mode (default v4, ``auto``, ``blockdot``)
   under the serving defaults (pipelined decode of depth 2, fused
   admissions, speculation inside the chain; the pipelined and verify steps
   replayed from CUDA graphs captured at warmup), once more in v4 with
   ``--pipeline-depth 0 --multi-step 0`` (the synchronous loop and verify
   step), once in v4 with ``--no-spec``, and twice with ``--workers 2``
   (defaults; ``--buffer-float-type q80 --dequant auto``) on the host's
   cards (one card named twice where there is one), send 4 concurrent
   requests (greedy and sampled, completion and chat, one streamed; the
   greedy completion's prompt built from a probe request so that its lane
   drafts, ``SPEC_RUN``), check the answers, the startup log (graph count
   and capture time), the kernels' launch counts and the serving paths'
   counters on ``/stats`` (pipelined dispatches, no flush, fused
   admissions, verify steps in the chain and drafted lanes, the window's
   launches, the sampler's launches, the graphs' replays), print TTFT,
   decode tok/s and tokens per drafted lane step, and SIGTERM the server.
   The default v4 pass, the synchronous pass and the ``--no-spec`` pass
   also stream each of the 4 requests alone; their texts, alone and
   concurrent, must be byte-identical, greedy and seeded.
   Then the serving layers, each server under the defaults (v4): (a) with
   ``--max-queue 4`` and 8 lanes, 16 concurrent requests (8 holding the
   lanes, then 8 at once): exactly 4 get 429 with ``Retry-After`` >= 1,
   every admitted one finishes, and a ``high`` request queued behind three
   ``normal`` ones takes the next lane (its queued slice on ``/trace``);
   (b) a request sharing the 1,900-token run with a finished lane takes its
   prefix from it (``prefix_hits``), and its greedy stream equals the same
   request's on a server with ``--prefix-min-tokens 0`` (both TTFTs
   printed); (c) with ``DLLAMA_FAULTS`` arming one dispatch fault, the
   default pass's 4 requests sent together end with an error where in
   flight, and each sent afterwards streams the default pass's text, the
   decode graphs replaying on with none captured after warmup; (d) with
   ``--step-deadline 1`` and one consume blackholed for 3 s, ``/health``
   turns 503, the request completes, a half-open probe after the breaker's
   cooldown turns it 200 and serving continues; (e) with the loop idle,
   ``/metrics`` parses and reconciles with ``/stats`` and ``/trace`` is
   Chrome trace JSON (``build/chip_smoke/chip_smoke_trace_layers.json``).
   Then the ``dllama`` CLI, each run through its entry point in this
   process (one lane, its decode, multi-step and verify graphs captured at
   startup): ``inference`` on the default pass's greedy prompt, 64 tokens,
   ``--benchmark``, in v4 and ``auto``, with and without ``--no-spec``, whose
   text must equal the server's greedy stream in that mode; a seeded run
   (``--temperature 0.8 --seed 7``) twice, equal; ``--workers 2`` in v4,
   the one-rank text with a Sync readout on every Pred line and a
   Measured/step line; ``chat`` with two turns on stdin twice, equal, the
   second turn at the carried position (its tokenizer also ends a turn on
   the top sixteenth of the vocabulary: a random model never emits the
   end-of-turn token). Eval and Pred tok/s and the verify steps are
   printed. Then crash durability: the default pass with and without
   ``--journal-path`` (batch tok/s and TTFT); 2 greedy and 2 seeded
   streamed requests of 256 tokens on a reference server, then on one
   with ``--journal-path --reconnect-grace 30`` that completes a fifth
   request first and is SIGKILLed once each stream holds 32 deltas;
   restarted with ``--recover-journal --max-lanes 4`` under
   ``DLLAMA_LEAKCHECK=1 DLLAMA_JITCHECK=1``, each client reattaches with
   ``GET /v1/stream/<id>`` and its Last-Event-ID: its text before the kill
   plus after equals the reference byte for byte, no index lost or
   repeated, the fifth request not resurrected, 4 recovered and 0 failed
   on ``/stats`` and ``/metrics``, no leak, no graph captured after warmup,
   the SIGTERM drain exits 0; the restart's time to the first reattached
   byte is printed.
4. Decode step: the engine in this process on the same model, its decode
   step replayed from its CUDA graph and then run eagerly (the bodies the
   graph captured), each with its host clock per step, launches per step
   (the graph's recorded counts held equal to the eager counts) and device
   time by kernel (torch.profiler), in v4, ``auto`` and ``blockdot``, and
   at tp=2 on the f32 and the Q80 wire (with the ring step's launches,
   checked against the reckoned 130 on both wires, its bytes, and the
   device operations per step), and the graphs' count and capture time;
   on one device the verify step's rows against one-row forwards at their
   positions, bit for bit, as batches of 1, 2, 4 and 8 lanes, and the
   verify step replayed from its graph (host clock, launches and device
   time as the decode step's); then an
   8-step ``decode_multi`` replayed from its graph against the
   eager bodies from the same cache (tokens, KV cache and counts); the TP
   prefill logits against one device's; the ring steps of one TP decode
   step, recorded from the collectives, timed; then each Q40 kernel, its
   plain version and ``torch.matmul`` timed over the 113 products of one
   decode step; then a prefix-cache hit's KV and logits against a cold
   prefill's, bit for bit (information; the copied slots must be equal),
   and the default v4 pass's batch tok/s and graph step p50 beside the
   numbers before the serving layers.
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

import ctypes
import json
import math
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
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
# output widths with no vector alignment: d_out % 4 == 2 and d_out % 16 == 8
ODD_WIDTHS = (6, 520, 1026)
KERNEL_OF_MODE = {"blockdot": "q40_blockdot", "i8blockdot": "q40_i8blockdot"}  # else slab
TOL = 1e-4  # max|kernel - plain| <= TOL * max|plain| (f32 outputs)
# i8blockdot's per-site times: one row, the server's 8 lanes, and the most
# rows auto sends it (BLOCKDOT_MAX_M)
I8_TIMED_M = (1, DECODE_M, 32)
# a speculative verify step's rows at the server's lanes: 8 x (SPEC_DRAFT + 1)
VERIFY_M = DECODE_M * 4
# fewer lanes (--max-lanes): their verify steps' rows against their decode steps'
FEW_LANES = (1, 2, 4)
GEN_TOKENS = 64
# the drafting request: a run of one token whose continuation a probe
# request reads first, then a prompt that holds that continuation ahead of
# the same run. A random model's greedy stream never repeats itself, so the
# prompt-lookup drafter has nothing to draft from in an ordinary prompt;
# this one ends where it began, so the drafter proposes the probe's tokens
# (and, as a long run's last rows hardly see the prefix, the model mostly
# continues with them)
SPEC_RUN = 1900
SPEC_PROBE_TOKENS = 16
MULTI_H = 8  # the scheduler's default multi-step horizon (--multi-step 8)
# the sampler's serving shape: the server's lanes over the 1B vocabulary
SAMPLE_VOCAB = 128256
# kernel and plain version both run -log(-log(u)) with the full-precision
# logf: at most a few ulps apart at |g| ~ 1
GUMBEL_ATOL = 2.0 ** -20
# the attention kernel sums the slots in another order than the plain
# version's two passes (per split of 128, the splits folded): f32 rounding
# over up to 2048 slots
ATTN_TOL = 2e-5  # max|kernel - plain| <= ATTN_TOL * max|plain|
ATTN_S_LEN = 2048  # the smoke model's seq_len: the attention's cache slots
F32_OPS_S = 67e12  # float32 outside the tensor cores
# one instruction per lane per clock at that rate (67e12 counts an FMA as two
# operations); Hopper's int32 units run at half of it, so a bound of integer
# work at this rate is low
LANE_OPS_S = F32_OPS_S / 2
# operations per kept entry of the sampler's draw, counted from
# csrc/gumbel_sample.cu: threefry2x32's 20 rounds of add, rotate and xor plus
# its 5 key injections and the first (77 32-bit integer operations), the
# uniform (xor, shift, or, subtract, multiply-add, max: 6), two full-precision
# logf (about 16 each in libdevice: range reduction and a polynomial), the
# negations, the add and the running-max compare (5)
GUMBEL_OPS_PER_DRAW = 120
# the sampler's edge vocabularies: one entry, one chunk, across chunks and no
# multiple of the chunk, the 1B and a 151,936-entry vocabulary
SAMPLE_EDGE_VOCABS = (1, 31, 4097, 128256, 151936)


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


def _run(q, kernel, mode, acts, w, w_dtype, plain=True):
    """(kernel, plain version) outputs; the kernel's alone without ``plain``."""
    if kernel == "q40_slab":
        got = q.q40_slab(acts, w, w_dtype, mode)
        return (got, q.q40_slab_plain(acts.x2, w, w_dtype, mode, bsum=acts.bsum)) if plain \
            else got
    if kernel == "q40_blockdot":
        got = q.q40_blockdot(acts, w)
        return (got, q.q40_blockdot_plain(acts.x2, w, bsum=acts.bsum)) if plain else got
    got = q.q40_i8blockdot(acts, w)
    return (got, q.q40_i8blockdot_plain(acts, w)) if plain else got


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


def dispatch_compare(torch, q, mode, m, w, gen, checks, expect=None) -> None:
    """``q40_matmul`` under ``mode`` on an f32 x: exactly one kernel
    launches (``expect`` where given, else the one the resolved mode
    names), and its output matches that kernel's plain version."""
    d_in, d_out = w.d_in, w.d_out
    q.set_dequant_mode(mode)
    try:
        run = q.resolve_kernel_mode(m, d_in, d_out, torch.bfloat16)
        kernel = expect or KERNEL_OF_MODE.get(run, "q40_slab")
        before = dict(q.LAUNCHES)
        acts = _acts(torch, q, m, d_in, gen, torch.float32)
        y = q.q40_matmul(acts, w)
        torch.cuda.synchronize()
        moved = [k for k in q.KERNELS if q.LAUNCHES[k] != before[k]]
        check(moved == [kernel], f"{mode} m={m}: launched {moved}, expected {kernel}")
        ref = _run(q, kernel, run, acts, w, torch.bfloat16)[1]
        err = float((y.float() - ref.float()).abs().max())
        check(bool(torch.isfinite(y).all()) and err <= TOL * float(ref.abs().max()),
              f"{mode} {d_in}x{d_out} m={m}: max|d| {err:.3e}")
        checks.append({"kernel": kernel, "mode": mode, "m": m, "d_in": d_in, "d_out": d_out,
                       "io": "f32", "routing": True, "max_abs_err": err,
                       "max_abs_ref": float(ref.abs().max()), "tol": TOL, "ok": True})
    finally:
        q.set_dequant_mode(None)


def kernel_geometry(torch, q, info_fn) -> dict:
    """A built Q40 kernel's ring stages, shared memory bytes per thread
    block, registers and spill bytes per m-tile (``info_fn``:
    ``q.slab_info``, ``q.blockdot_info`` or ``q.i8blockdot_info``), and the
    shared plan (m-tile,
    splits, quant blocks per split) at each Llama-3.2-1B site."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    info = {mt: info_fn(mt) for mt in (1, 8, 16)}
    return {"stages": info[1]["stages"],
            "smem_bytes_per_block": {str(mt): i["smem_bytes"] for mt, i in info.items()},
            "registers_per_thread": {str(mt): i["registers"] for mt, i in info.items()},
            "spill_bytes_per_thread": {str(mt): i["local_bytes"] for mt, i in info.items()},
            "sms": n_sm,
            "plan_mt_splits_per_by_site": {
                f"{site} {d_in}x{d_out}": {str(m): list(q.launch_plan(m, d_in, d_out, n_sm))
                                           for m in (1, DECODE_M, 512)}
                for site, d_in, d_out, _ in SITES}}


def sass_hmma(lib_path: str, tag: str = "blockdot_kernel", opcode: str = "HMMA") -> dict:
    """Tensor-core instructions (``opcode``: HMMA for bf16, IMMA for int8)
    in each function of a built kernel library whose name holds ``tag``,
    from the toolkit's ``cuobjdump -sass``. Fails unless every such
    function has some."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    r = subprocess.run([exe, "-sass", lib_path], capture_output=True, text=True, timeout=300)
    check(r.returncode == 0, f"cuobjdump -sass {lib_path} failed: {r.stderr.strip()[-500:]}")
    counts: dict = {}
    fn = None
    for line in r.stdout.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            fn = found.group(1) if tag in found.group(1) else None
            if fn:
                counts.setdefault(fn, 0)
        elif fn and re.search(rf"\b{opcode}\b", line):
            counts[fn] += 1
    check(bool(counts), f"no {tag} function in the SASS of {lib_path}")
    check(all(n > 0 for n in counts.values()), f"no {opcode} in some {tag} functions: {counts}")
    return counts


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


# the tensor-core kernels' fragment edges: m around their N-tiles of 8 rows
# and m-tiles of 1, 8 and 16; one, two and many quant blocks (no split, a
# split, many splits); one M-tile of 16 columns, a partial 512 tile, the
# plain-load stage (520, and 1026 with a column tail), many tiles
BLOCKDOT_EDGE_M = (1, 7, 8, 9, 16, 17, 32)
BLOCKDOT_EDGE_D_IN = (32, 64, 2048)
BLOCKDOT_EDGE_D_OUT = (16, 48, 520, 1026, 8192)
TENSOR_CORE_KERNELS = (("q40_blockdot", "blockdot"), ("q40_i8blockdot", "i8blockdot"))


def _extreme_check(torch, q, kernel, mode, acts, w, checks, case: str) -> None:
    got, ref = _run(q, kernel, mode, acts, w, torch.bfloat16)
    torch.cuda.synchronize()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= TOL * scale
    checks.append({"kernel": kernel, "mode": mode, "m": acts.m, "d_in": w.d_in,
                   "d_out": w.d_out, "io": "f32", "extreme": True, "case": case,
                   "max_abs_err": err, "max_abs_ref": scale, "tol": TOL, "ok": ok})
    check(ok, f"{kernel}, {case}, {w.d_in}x{w.d_out} m={acts.m}: max|d| {err:.3e} vs "
              f"max|y| {scale:.3e}")


def tensor_core_edges(torch, q, gen, checks) -> None:
    """``q40_blockdot`` and ``q40_i8blockdot`` against their plain versions
    at their fragment edges (f32 and bf16 x), then with f16-extreme scales
    (+-65504 and the subnormal 2^-24) and x spanning 1e-3..1e3 in
    magnitude; i8blockdot also with x that saturates its int8 values at
    +-127 against all-15 nibbles (block dots of +-60,960) and all-zero
    blocks (sx = 1e-8/127)."""
    from distributed_llama_multiusers_tpu_torch.quants.packed import PackedQ40

    for kernel, mode in TENSOR_CORE_KERNELS:
        for d_in in BLOCKDOT_EDGE_D_IN:
            for d_out in BLOCKDOT_EDGE_D_OUT:
                w = _weight(torch, q, d_in, d_out, gen)
                for m in BLOCKDOT_EDGE_M:
                    compare(torch, q, kernel, mode, m, d_in, d_out, w, gen, torch.bfloat16,
                            checks)
        for m, d_in, d_out in ((DECODE_M, 2048, 2048), (1, 32, 48)):
            w = _weight(torch, q, d_in, d_out, gen)
            pick = torch.rand(w.scales.shape, device="cuda", generator=gen)
            sign = torch.where(torch.rand(w.scales.shape, device="cuda", generator=gen) < 0.5,
                               -1.0, 1.0)
            scales = (torch.where(pick < 0.5, 65504.0, 2.0 ** -24) * sign).to(torch.float16)
            w = PackedQ40(w.packed, scales)
            mag = 10.0 ** (torch.rand((m, d_in), device="cuda", generator=gen) * 6 - 3)
            x = mag * torch.sign(torch.randn((m, d_in), device="cuda", generator=gen))
            _extreme_check(torch, q, kernel, mode, q.make_q80_acts(x), w, checks,
                           "f16-extreme scales and x")
    for m, d_in, d_out in ((DECODE_M, 2048, 1024), (17, 64, 48)):
        w = _weight(torch, q, d_in, d_out, gen)
        packed = w.packed.clone()
        packed[:, : d_out // 2] = 0xFF  # half the columns all-15 nibbles
        sign = torch.where(torch.rand((m, d_in // 32, 1), device="cuda", generator=gen) < 0.5,
                           -1.0, 1.0)
        x = (sign * torch.full((m, d_in // 32, 32), 3.0, device="cuda")).view(m, d_in)
        x[::2, : d_in // 2] = 0.0  # all-zero blocks on every other row
        acts = q.make_q80_acts(x)
        check(int(acts.xq.abs().max()) == 127, "the saturation case does not reach +-127")
        _extreme_check(torch, q, "q40_i8blockdot", "i8blockdot", acts, PackedQ40(packed, w.scales),
                       checks, "xq saturated at +-127, all-15 nibbles, all-zero blocks")


def _plan_tiles(q, tiles):
    """A k-split plan that counts ``tiles(m, mt)`` m-tiles where it spreads
    d_in over the card (``launch_plan`` counts 1 for every m <= 32)."""
    def plan(m, d_in, d_out, n_sm):
        mt = 1 if m == 1 else (8 if m <= 8 else 16)
        col_blocks = -(-d_out // q.COLS_PER_BLOCK)
        n_blk = d_in // 32
        want = max(1, -(-2 * n_sm // (col_blocks * tiles(m, mt))))
        per = -(-n_blk // min(n_blk, want))
        return mt, -(-n_blk // per), per
    return plan


def _rotating_ms(torch, q, kernel, mode, m, d_in, d_out, gen) -> float:
    """A kernel's time per call at one site, its weights rotating over
    enough copies to exceed the 50 MB L2 (``time_site``'s rule)."""
    wbytes = d_in * d_out // 2 + (d_in // 32) * d_out * 2
    n = max(1, min(48, math.ceil(120e6 / wbytes)))
    ws = [_weight(torch, q, d_in, d_out, gen) for _ in range(n)]
    acts = _acts(torch, q, m, d_in, gen, torch.bfloat16)
    acts.xq  # noqa: B018 — the Q80 operands outside the timed calls
    calls = [lambda w=ws[i % n]: _run(q, kernel, mode, acts, w, torch.bfloat16, plain=False)
             for i in range(max(n, 8))]
    ms = graph_ms(torch, calls)
    del ws
    return ms


def row_plan_phase(torch, q) -> list:
    """Row r of an m = 32 product (a verify step's rows at 8 lanes) against
    row r of the m = 8 products of the same rows (decode steps), bit for
    bit, at the 1B sites in the three kernels the serving modes run, under
    ``launch_plan`` (one plan for every m <= 32, as one m-tile splits) and
    two others: the plan before it (m-tiles counted at every m) and one
    plan for every m <= 32 as two m-tiles split (half the k-splits). The
    first must hold; the others are recorded. Under ``launch_plan`` also
    the rows of fewer lanes' verify products (m = 4 x lanes) against their
    decode products (m = lanes), for lanes in FEW_LANES. Then each kernel's
    m = 8 and m = 32 times under the three plans, in turns."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    now = q.launch_plan
    plans = {"now": now, "before": _plan_tiles(q, lambda m, mt: -(-m // mt)),
             "two_tiles": _plan_tiles(q, lambda m, mt: 2 if m <= q.BLOCKDOT_MAX_M
                                      else -(-m // mt))}
    order = ("now", "before", "two_tiles", "two_tiles", "before", "now")
    rows = []
    t0 = time.perf_counter()
    try:
        for site, d_in, d_out, per_step in SITES:
            w = _weight(torch, q, d_in, d_out, gen)
            x = torch.randn((VERIFY_M, d_in), device="cuda", generator=gen).to(torch.bfloat16)
            for kernel, mode in (("q40_slab", "v4"), ("q40_blockdot", "blockdot"),
                                 ("q40_i8blockdot", "i8blockdot")):
                row = {"site": site, "d_in": d_in, "d_out": d_out, "kernel": kernel,
                       "mode": mode, "per_decode_step": per_step}
                for name, plan in plans.items():
                    q.launch_plan = plan
                    full = _run(q, kernel, mode, q.make_q80_acts(x), w, torch.bfloat16,
                                plain=False)
                    parts = torch.cat([_run(q, kernel, mode,
                                            q.make_q80_acts(x[i:i + DECODE_M].contiguous()),
                                            w, torch.bfloat16, plain=False)
                                       for i in range(0, VERIFY_M, DECODE_M)])
                    row[f"rows_equal_{name}"] = bool(torch.equal(full, parts))
                    row[f"splits_m8_m32_{name}"] = [plan(m, d_in, d_out, n_sm)[1]
                                                    for m in (DECODE_M, VERIFY_M)]
                q.launch_plan = now
                check(row["rows_equal_now"], f"{kernel} {site}: a row of the m = {VERIFY_M} "
                                             f"product differs from the m = {DECODE_M} one")
                for n in FEW_LANES:
                    full = _run(q, kernel, mode, q.make_q80_acts(x[:4 * n].contiguous()), w,
                                torch.bfloat16, plain=False)
                    parts = torch.cat([_run(q, kernel, mode,
                                            q.make_q80_acts(x[i:i + n].contiguous()), w,
                                            torch.bfloat16, plain=False)
                                       for i in range(0, 4 * n, n)])
                    row[f"rows_equal_m{n}_m{4 * n}"] = bool(torch.equal(full, parts))
                for name in order:
                    q.launch_plan = plans[name]
                    for m in (DECODE_M, VERIFY_M):
                        row.setdefault(f"ms_m{m}_{name}", []).append(
                            _rotating_ms(torch, q, kernel, mode, m, d_in, d_out, gen))
                q.launch_plan = now
                rows.append(row)
            del w
    finally:
        q.launch_plan = now
    log(f"verify-shaped products: rows of m = {VERIFY_M} equal m = {DECODE_M} at "
        + ", ".join(f"{sum(r[f'rows_equal_{n}'] for r in rows)} under {n}" for n in plans)
        + f" of {len(rows)} (kernel, site) pairs ({time.perf_counter() - t0:.1f}s)")
    for r in rows:
        log("verify-shaped product " + json.dumps(r))
    for n in FEW_LANES:
        differ = [(r["kernel"], r["site"]) for r in rows if not r[f"rows_equal_m{n}_m{4 * n}"]]
        check(not differ, f"a row of the m = {4 * n} product differs from the m = {n} one at "
                          f"{differ}")
    return rows


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
        for m, expect in ((32, at32), (33, "q40_slab")):
            dispatch_compare(torch, q, mode, m, w, gen, checks, expect)
    # any width: d_out % 4 == 2 (every kernel's column tail) and d_out % 16
    # == 8 (the slab's plain-load stage), each mode, and auto through the
    # dispatch
    for d_out in ODD_WIDTHS:
        wo = _weight(torch, q, 2048, d_out, gen)
        for m in (1, DECODE_M, 33):
            for mode in ("v4", "bf16chain"):
                compare(torch, q, "q40_slab", mode, m, 2048, d_out, wo, gen, torch.bfloat16,
                        checks)
            if m <= q.BLOCKDOT_MAX_M:
                compare(torch, q, "q40_blockdot", "blockdot", m, 2048, d_out, wo, gen,
                        torch.bfloat16, checks)
                compare(torch, q, "q40_i8blockdot", "i8blockdot", m, 2048, d_out, wo, gen,
                        torch.bfloat16, checks)
            dispatch_compare(torch, q, "auto", m, wo, gen, checks)
        del wo
    tensor_core_edges(torch, q, gen, checks)
    log(f"kernel checks: {len(checks)} comparisons within tolerance "
        f"({time.perf_counter() - t0:.1f}s)")

    timings: list = []
    t0 = time.perf_counter()
    plan = [("q40_slab", "v4", ms) for ms in (1, DECODE_M, 512)]
    plan += [("q40_slab", "bf16chain", ms) for ms in (DECODE_M, 512)]
    plan += [("q40_blockdot", "blockdot", ms) for ms in (1, DECODE_M)]
    plan += [("q40_i8blockdot", "i8blockdot", ms) for ms in I8_TIMED_M]
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
    n_of = [len(xs) for xs in xs_sets]
    steps = [[[rc.Seg(xs[(r - 1) % n], torch.empty_like(xs[r]))] for r in range(n)]
             for xs, n in zip(xs_sets, n_of)]
    return time_steps(torch, rc, steps, reps)


def _library_call(torch, seg):
    """The one PyTorch call that computes a segment: ``copy_`` into the
    destination (a slot view included), or ``torch.add(..., out=)``."""
    if seg.add is None:
        return lambda: seg.dst.copy_(seg.src)
    return lambda: torch.add(seg.src, seg.add, out=seg.dst)


def time_steps(torch, rc, steps: list, reps: int = 4) -> dict:
    """Device time of ``rc.ring_step`` over ``steps`` (each a list of
    per-rank segment lists): one CUDA graph where every tensor is on one
    card (the median of three, alternating with the library's), else eager
    between events; beside it each segment's library call
    (``_library_call``) and the plain version (eager). ``launches`` and
    ``bytes`` are what the counters would add: one per receiving rank per
    step, the wire segments' source bytes. The graph replays the steps back
    to back, so each launch made as a programmatic dependent starts while
    the step before it runs: a best case. On the decode path a step follows
    kernels that do not trigger their dependents (``step_breakdown``'s
    profiled ``ring_hop`` time is that case)."""
    calls = [lambda st=st: rc.ring_step(st) for st in steps]
    lib = [_library_call(torch, seg) for st in steps for segs in st for seg in segs]
    devices = {t.device for st in steps for segs in st for seg in segs
               for t in (seg.src, seg.dst)}
    one_card = len(devices) == 1
    if one_card:  # the median of three graph timings each, in turns
        ms, library_ms = (statistics.median(v) for v in zip(*[
            (graph_ms(torch, calls * reps) * len(calls), graph_ms(torch, lib * reps) * len(lib))
            for _ in range(3)]))
    else:
        ms = eager_ms(torch, lambda: [c() for c in calls], 20)
        library_ms = eager_ms(torch, lambda: [c() for c in lib], 20)
    plain_ms = eager_ms(torch, lambda: [rc.ring_step_plain(st) for st in steps], 5)
    nbytes = sum(seg.src.numel() * seg.src.element_size() for st in steps for segs in st
                 for seg in segs if seg.wire)
    return {"ms": ms, "library_ms": library_ms, "plain_ms": plain_ms,
            "launches": sum(len(st) for st in steps), "library_calls": len(lib),
            "bytes": nbytes, "same_card": one_card,
            "bound_ms": hop_bound_ms(nbytes, one_card), "bound_by": "bytes"}


# the three forms of a ring step's segment at the decode payloads, per hop
# against its library call: 32 KiB (an 8-lane f32 ring chunk at tp=2),
# 8 KiB (the Q80 wire's values of that chunk) and 2 MB (an f32 logits shard)
HOP_FORM_BYTES = (32 * 1024, 8 * 1024, 8 * 64128 * 4)


def _form_steps(torch, rc, form: str, nbytes: int, gen, n: int = 2) -> list:
    """One ring step of ``form`` at tp=n on this card, destination rows of 8
    lanes: ``hop`` (f32 copy), ``add`` (f32 accumulator + bf16 partial, as
    ring_sync_matmul adds) or ``slot`` (f32 chunk into column slot 1 of an
    [8, n*C] output)."""
    c = nbytes // (8 * 4)
    xs = [torch.randn((8, c), device="cuda", generator=gen) for _ in range(n)]
    adds = [None] * n
    if form == "add":
        adds = [torch.randn((8, c), device="cuda", generator=gen).to(torch.bfloat16)
                for _ in range(n)]
    if form == "slot":
        dsts = [torch.empty((8, n * c), device="cuda")[:, c:2 * c] for _ in range(n)]
    else:
        dsts = [torch.empty_like(x) for x in xs]
    return [[[rc.Seg(xs[(r - 1) % n], dsts[r], adds[r])] for r in range(n)]]


def build_one_kernel(q, rc):
    """Start nvcc on ``csrc/ring_hop.cu`` with RING_HOP_ONE_KERNEL: every
    ring step through the two-segment kernel, one 16-byte unit a thread, the
    simpler design ``hop_forms`` times the built one against. Returns the
    process and the library's path."""
    os.makedirs(q.build_dir(), exist_ok=True)
    path = os.path.join(q.build_dir(), "ring_hop_one_kernel.so")
    cmd = [q._nvcc(), *q.NVCC_FLAGS, "-DRING_HOP_ONE_KERNEL", "-o", path,
           os.path.join(ROOT, rc.KERNEL_SOURCE)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), path


def one_kernel_launch(rc, build) -> object:
    """Wait for ``build_one_kernel``'s nvcc; its library's launch function."""
    proc, path = build
    out, _ = proc.communicate()
    check(proc.returncode == 0, f"nvcc -DRING_HOP_ONE_KERNEL failed:\n{out}")
    fn = ctypes.CDLL(path).ring_hop_launch
    fn.argtypes = rc._STEP_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def hop_forms(torch, q, rc, one_kernel) -> list:
    """Each segment form, bit for bit against the plain version, then its
    time per hop (launch) beside its library call's, in the same CUDA-graph
    harness, at each of HOP_FORM_BYTES; beside them the same steps through
    the RING_HOP_ONE_KERNEL build's launch function ``one_kernel``, also bit
    for bit."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    key = (rc.KERNEL, None)
    built = q.load_kernel(rc.KERNEL, rc._STEP_ARGTYPES)
    rows = []
    for form in ("hop", "add", "slot"):
        for nbytes in HOP_FORM_BYTES:
            steps = _form_steps(torch, rc, form, nbytes, gen)
            t = {}
            for label, fn in (("built", built), ("one kernel", one_kernel)):
                q._libs[key] = fn
                try:
                    ref = [[seg._replace(dst=seg.dst.clone()) for seg in segs]
                           for segs in steps[0]]
                    rc.ring_step(steps[0])
                    rc.ring_step_plain(ref)
                    torch.cuda.synchronize()
                    check(all(torch.equal(g.dst, r.dst) for gs, rs in zip(steps[0], ref)
                              for g, r in zip(gs, rs)),
                          f"ring step form {form} at {nbytes} B ({label}): differs from its "
                          "plain version")
                    t[label] = time_steps(torch, rc, steps, reps=8)
                finally:
                    q._libs[key] = built
            n = t["built"]["launches"]
            row = {"form": form, "bytes_per_hop": nbytes, "ranks": n,
                   "us_per_hop": t["built"]["ms"] / n * 1e3,
                   "library_us_per_hop": t["built"]["library_ms"] / n * 1e3,
                   "library": "torch.add(out=)" if form == "add" else "copy_",
                   "one_kernel_us_per_hop": t["one kernel"]["ms"] / n * 1e3,
                   "bound_us_per_hop": t["built"]["bound_ms"] / n * 1e3,
                   "kernel_over_library": t["built"]["ms"] / t["built"]["library_ms"]}
            rows.append(row)
            log("hop form " + json.dumps(row))
    return rows


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
    same function run with the plain ring step: bit for bit (the copies and
    the adds are exact or rounded once, and the kernels deterministic)."""
    from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
    from distributed_llama_multiusers_tpu_torch.parallel.sharding import col_shards

    gen = torch.Generator(device="cuda").manual_seed(3)
    w = _weight(torch, q, 2048, 2048, gen)
    out = []
    kernel_step = rc.ring_step
    for n in (2, 4):
        devs = rank_devices(torch, n)
        ws = col_shards(w, make_mesh(MeshPlan(tp=n), devs))
        parts = [torch.randn((8, 1, 2048), device="cuda", generator=gen).to(d) for d in devs]
        chunks = [p[..., : 2048 // n].contiguous() for p in parts]
        xs = [p[..., : 2048 // n].to(torch.bfloat16).contiguous() for p in parts]
        halves = [p.to(torch.bfloat16) for p in parts]
        cases = {
            "ring_reduce_scatter_bf16": lambda: rc.ring_reduce_scatter(halves),
            "ring_all_reduce": lambda: rc.ring_all_reduce(parts),
            "ring_reduce_scatter": lambda: rc.ring_reduce_scatter(parts),
            "ring_all_gather": lambda: rc.ring_all_gather(chunks),
            "ring_all_gather_q80": lambda: rc.ring_all_gather_q80(chunks),
            "ring_sync_matmul": lambda: rc.ring_sync_matmul(xs, ws),
            "ring_sync_matmul_q80_wire": lambda: rc.ring_sync_matmul(xs, ws, q80_wire=True),
        }
        for name, fn in cases.items():
            got = fn()
            rc.ring_step = rc.ring_step_plain
            try:
                ref = fn()
            finally:
                rc.ring_step = kernel_step
            torch.cuda.synchronize()
            same = all(torch.equal(g, r) for g, r in zip(got, ref))
            check(same, f"{name} tp={n}: the kernel hop and the plain hop disagree")
            out.append({"collective": name, "tp": n, "bit_exact": same,
                        "shape": list(got[0].shape)})
    log(f"ring collectives: {len(out)} checks bit-exact against the plain ring step")
    return out


# ---------------------------------------------------------------------------
# Phase 3: serving the full-width model
# ---------------------------------------------------------------------------


def sampler_phase(torch, cs) -> dict:
    """The sampler kernel at the serving shape (8 lanes x 128,256): the
    nucleus of random logits under 8 (temperature, top-p) settings,
    choices and noise against the plain version, then the kernel's time
    (launches back to back in one CUDA graph), the plain version's (eager)
    and the library composition's (``torch.rand`` + -log(-log u) + add +
    ``argmax``, one CUDA graph), with the bound: the larger of one f32 read
    of the sorted rows over the memory rate and the draw's operations on
    the kept entries over the f32 lane rate; then the edge rows
    (``sampler_edges``)."""
    from distributed_llama_multiusers_tpu_torch.runtime import sampling as S

    n, vocab = DECODE_M, SAMPLE_VOCAB
    logp, seeds, positions = sampler_inputs(torch, S)
    noise = torch.full((n, vocab), float("nan"), device="cuda")
    got = cs.gumbel_argmax(logp, seeds, positions, noise_out=noise)
    want = S.gumbel_argmax_plain(logp, seeds, positions)
    k0, k1 = S.fold_in_keys(seeds, positions)
    ref = S.gumbel_noise(k0, k1, vocab)
    kept = torch.isfinite(logp)
    err = float((noise[kept] - ref[kept]).abs().max())
    choice_err = int((got - want).abs().max())
    check(choice_err == 0, f"gumbel_sample chose {got.tolist()}, plain {want.tolist()}")
    check(err <= GUMBEL_ATOL, f"gumbel_sample noise max|d| {err:.3e} > {GUMBEL_ATOL:.3e}")

    edges = sampler_edges(torch, cs, S)

    def library():
        u = torch.rand((n, vocab), device="cuda")
        return torch.argmax(-torch.log(-torch.log(u)) + logp, dim=-1)

    reps = 20
    ms = graph_ms(torch, [lambda: cs.gumbel_argmax(logp, seeds, positions)] * reps)
    library_ms = graph_ms(torch, [library] * reps)
    plain_ms = eager_ms(torch, lambda: S.gumbel_argmax_plain(logp, seeds, positions), 3)
    kept_n = int(kept.sum())
    n_bytes, n_ops = n * vocab * 4, kept_n * GUMBEL_OPS_PER_DRAW
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / LANE_OPS_S
    out = {"lanes": n, "vocab": vocab, "kept_entries": kept_n,
           "chunk": cs.CHUNK, "grid": [-(-vocab // cs.CHUNK), n],
           "max_abs_err": choice_err, "noise_max_abs_err": err, "noise_tol": GUMBEL_ATOL,
           "edge_checks": edges, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_bytes": n_bytes, "bound_bytes_ms": t_bytes * 1e3,
           "bound_ops": n_ops, "bound_ops_ms": t_ops * 1e3}
    log("gumbel_sample: " + json.dumps(out))
    return out


def sampler_inputs(torch, S):
    """One sampled step at the serving shape: the nucleus log-probabilities
    of random logits under 8 (temperature, top-p) settings, seeds and
    positions."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = torch.randn((DECODE_M, SAMPLE_VOCAB), device="cuda", generator=gen) * 2
    temps = torch.tensor([0.7, 0.8, 0.9, 1.0, 1.2, 0.6, 1.0, 0.9], device="cuda")
    topps = torch.tensor([0.9, 0.95, 0.9, 1.0, 0.8, 0.5, 0.0, 0.99], device="cuda")
    logp, _ = S.nucleus_logp(rows, temps, topps)
    seeds = torch.arange(DECODE_M, device="cuda") * 7919 + 3
    positions = torch.arange(DECODE_M, device="cuda") * 131 + 40
    return logp, seeds, positions


def sampler_edges(torch, cs, S) -> list:
    """The sampler kernel's choices against the plain version's on the rows
    its chunking must get right, at vocabularies of one chunk, across chunks
    and no multiple of the chunk: 8 lanes of nuclei whose last two rows are
    every entry masked (picks 0) and only the last entry finite (picks it)."""
    out = []
    for vocab in SAMPLE_EDGE_VOCABS:
        gen = torch.Generator(device="cuda").manual_seed(vocab)
        rows = torch.randn((DECODE_M, vocab), device="cuda", generator=gen) * 3
        logp, _ = S.nucleus_logp(rows, torch.full((DECODE_M,), 0.8, device="cuda"),
                                 torch.full((DECODE_M,), 0.9, device="cuda"))
        logp[6:] = float("-inf")
        logp[7, -1] = 0.0
        seeds = torch.arange(DECODE_M, device="cuda") * 31 + 1
        positions = torch.arange(DECODE_M, device="cuda") * 257 + 5
        got = cs.gumbel_argmax(logp, seeds, positions)
        want = S.gumbel_argmax_plain(logp, seeds, positions)
        check(torch.equal(got, want) and got[6:].tolist() == [0, vocab - 1],
              f"gumbel_sample at vocab {vocab}: chose {got.tolist()}, plain {want.tolist()}")
        out.append({"vocab": vocab, "choices": got.tolist()})
    return out


def attn_inputs(torch, n_kv: int):
    """One layer of the serving decode step: 8 lanes' queries (f32, 4 query
    heads of 64 per kv head) and a bf16 cache of ATTN_S_LEN slots."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    shape = (DECODE_M, ATTN_S_LEN + 1, n_kv, 64)
    qf = torch.randn((DECODE_M, 1, n_kv, 4, 64), device="cuda", generator=gen)
    k = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
    return qf, k, v


def attn_serving_positions(torch):
    """The smoke's serving positions: 4 lanes at 40-100, 4 parked past the
    cache (they attend every slot)."""
    return torch.tensor([[40], [63], [64], [100]] + [[ATTN_S_LEN]] * 4, device="cuda")


def attn_phase(torch) -> dict:
    """The attention kernel at the serving decode step's shapes (8 lanes,
    8 kv heads of 4 query heads, head size 64, a bf16 cache of 2048 slots):
    against its plain version at the smoke's serving positions (4 lanes at
    40-100, 4 parked past the cache, which attend every slot) and at
    positions across the cache; a lane's bits against another batch around
    it and a shorter s_len; then the kernel's time (launches back to back in
    one CUDA graph), the plain version's (eager) and
    ``scaled_dot_product_attention``'s on the same f32 inputs (one CUDA
    graph), with the bound: the slots the lanes attend read once, q and the
    output, or the f32 operations of the dots, whichever is longer."""
    from distributed_llama_multiusers_tpu_torch.ops import cuda_attn as ca

    lanes, n_kv, group, hd, s_len = DECODE_M, 8, 4, 64, ATTN_S_LEN
    qf, k, v = attn_inputs(torch, n_kv)
    scale = 1.0 / hd ** 0.5
    serving = attn_serving_positions(torch)
    spread = torch.tensor([[0], [1], [63], [511], [1024], [2046], [2047], [2048]], device="cuda")
    split = ca.SPLIT
    boundaries = torch.tensor([[split - 1], [split], [split + 1], [2 * split - 1], [2 * split],
                               [2 * split + 1], [3 * split], [s_len - 1]], device="cuda")
    long_ctx = torch.full((lanes, 1), s_len - 1, device="cuda")  # every lane live at 2047
    err, ref_max = 0.0, 0.0
    for pos in (serving, spread, boundaries, long_ctx):
        got = ca.decode_attention(qf, k, v, pos, scale, s_len)
        want = ca.decode_attention_plain(qf, k, v, pos, scale, s_len)
        e, r = float((got - want).abs().max()), float(want.abs().max())
        check(bool(torch.isfinite(got).all()) and e <= ATTN_TOL * r,
              f"decode_attn: max|d| {e:.3e} > {ATTN_TOL:.1e} x {r:.3e}")
        err, ref_max = max(err, e), max(ref_max, r)
    base = ca.decode_attention(qf, k, v, serving, scale, s_len)
    for pos, sl in ((spread, s_len), (serving, 128)):
        got = ca.decode_attention(qf, k, v, torch.cat([serving[:1], pos[1:]]), scale, sl)
        check(torch.equal(got[0], base[0]), "decode_attn: lane 0's bits moved with the batch")
    on_split = ca.decode_attention(qf, k, v, torch.full_like(serving, split), scale, s_len)
    for pos, sl in ((spread, s_len), (serving, split + 1)):
        got = ca.decode_attention(qf, k, v, torch.cat([boundaries[1:2], pos[1:]]), scale, sl)
        check(torch.equal(got[0], on_split[0]),
              "decode_attn: a lane on a split boundary moved with the batch")

    # the library call on the same function: f32 q [B, heads, 1, H], k/v
    # [B, n_kv, S, H], a boolean mask of each lane's slots
    q_l = qf.reshape(lanes, n_kv * group, 1, hd)
    k_l = k[:, :s_len].permute(0, 2, 1, 3).float().contiguous()
    v_l = v[:, :s_len].permute(0, 2, 1, 3).float().contiguous()
    mask = (torch.arange(s_len, device="cuda")[None, :] <= serving)[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        library = lambda: sdpa(q_l, k_l, v_l, attn_mask=mask, scale=scale,  # noqa: E731
                               enable_gqa=True)
        lib_out = library()
    except TypeError:  # a torch without enable_gqa: the kv heads expanded first
        k_l, v_l = (t.repeat_interleave(group, dim=1) for t in (k_l, v_l))
        library = lambda: sdpa(q_l, k_l, v_l, attn_mask=mask, scale=scale)  # noqa: E731
        lib_out = library()
    lib_err = float((lib_out.reshape(base.shape) - base).abs().max())
    reps = 20

    def bound_of(pos):
        slots = int((pos.clamp(max=s_len - 1) + 1).sum())
        n_bytes = slots * n_kv * hd * 2 * 2 + 2 * qf.numel() * 4 + lanes * 8
        n_ops = slots * n_kv * group * hd * 4
        t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / F32_OPS_S
        return {"slots_read": slots, "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_bytes": n_bytes, "bound_ops": n_ops}

    ms = graph_ms(torch, [lambda: ca.decode_attention(qf, k, v, serving, scale, s_len)] * reps)
    library_ms = graph_ms(torch, [library] * reps)
    plain_ms = eager_ms(torch, lambda: ca.decode_attention_plain(qf, k, v, serving, scale,
                                                                 s_len), 3)
    long_ms = graph_ms(torch, [lambda: ca.decode_attention(qf, k, v, long_ctx, scale,
                                                           s_len)] * reps)
    window = window_phase(torch, ca, k, v, scale)
    out = {"lanes": lanes, "n_kv": n_kv, "group": group, "head_size": hd, "s_len": s_len,
           "positions": serving[:, 0].tolist(), "split": split,
           "grid": list(ca.launch_grid(lanes, n_kv, s_len)),
           "splits_per_lane": [-(-(min(int(p), s_len - 1) + 1) // split) for p in serving[:, 0]],
           "max_abs_err": err, "max_abs_ref": ref_max, "tol": ATTN_TOL,
           "library_max_abs_err": lib_err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, **bound_of(serving),
           "long_context": {"positions": long_ctx[:, 0].tolist(), "ms": long_ms,
                            **bound_of(long_ctx)}, "window": window}
    log("decode_attn: " + json.dumps({k: v for k, v in out.items() if k != "window"}))
    log("decode_attn window: " + json.dumps(window))
    return out


def window_rows(torch, first, t: int = 4):
    """Each lane's rows at consecutive positions from ``first``."""
    return torch.tensor(first, device="cuda")[:, None] + torch.arange(t, device="cuda")[None]


def window_phase(torch, ca, k, v, scale) -> dict:
    """The verify window (4 query rows a lane, the speculative verify step
    at 8 lanes) on ``attn_phase``'s cache: against its plain version and
    each row against a T = 1 call at its position, bit for bit, with the
    rows at the serving positions (4 lanes from 40-100, 4 parked), across
    the split boundaries and all at and past 2047; then one window call's
    time beside the same rows as four T = 1 calls and as one
    ``scaled_dot_product_attention`` (one CUDA graph each), and its bound:
    each lane's slots read once for all rows (its furthest row's), q and the
    output, or the rows' f32 operations."""
    lanes, t, s_len, split = DECODE_M, ca.WINDOW, ATTN_S_LEN, ca.SPLIT
    n_kv, hd = k.shape[2], k.shape[3]
    group = 4
    gen = torch.Generator(device="cuda").manual_seed(11)
    qw = torch.randn((lanes, t, n_kv, group, hd), device="cuda", generator=gen)
    serving = window_rows(torch, [40, 63, 64, 100] + [s_len] * 4)
    boundaries = window_rows(torch, [split - 4, split - 2, split - 1, split, 2 * split - 3,
                                     2 * split - 1, 3 * split - 2, s_len - 4])
    at_end = window_rows(torch, [s_len - 1] * lanes)
    err, ref_max, rows_checked = 0.0, 0.0, 0
    for pos in (serving, boundaries, at_end):
        got = ca.decode_attention(qw, k, v, pos, scale, s_len)
        want = ca.decode_attention_plain(qw, k, v, pos, scale, s_len)
        e, r = float((got - want).abs().max()), float(want.abs().max())
        check(bool(torch.isfinite(got).all()) and e <= ATTN_TOL * r,
              f"decode_attn window: max|d| {e:.3e} > {ATTN_TOL:.1e} x {r:.3e}")
        err, ref_max = max(err, e), max(ref_max, r)
        for row in range(t):
            one = ca.decode_attention(qw[:, row:row + 1].contiguous(), k, v,
                                      pos[:, row:row + 1].contiguous(), scale, s_len)
            check(torch.equal(got[:, row], one[:, 0]),
                  f"decode_attn window: row {row} differs from a T = 1 call at its position")
            rows_checked += lanes
    rows_q = [qw[:, row:row + 1].contiguous() for row in range(t)]
    rows_p = [serving[:, row:row + 1].contiguous() for row in range(t)]
    reps = 20
    ms = graph_ms(torch, [lambda: ca.decode_attention(qw, k, v, serving, scale, s_len)] * reps)
    ms_one_row_calls = graph_ms(torch, [
        lambda r=row: ca.decode_attention(rows_q[r], k, v, rows_p[r], scale, s_len)
        for row in range(t)] * reps) * t
    plain_ms = eager_ms(torch, lambda: ca.decode_attention_plain(qw, k, v, serving, scale,
                                                                 s_len), 3)
    # the library call on the same rows: q [B, heads, T, H], a mask per row
    q_l = qw.permute(0, 2, 3, 1, 4).reshape(lanes, n_kv * group, t, hd).contiguous()
    k_l = k[:, :s_len].permute(0, 2, 1, 3).float().contiguous()
    v_l = v[:, :s_len].permute(0, 2, 1, 3).float().contiguous()
    mask = (torch.arange(s_len, device="cuda")[None, None, :] <= serving[:, :, None])[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        library = lambda: sdpa(q_l, k_l, v_l, attn_mask=mask, scale=scale,  # noqa: E731
                               enable_gqa=True)
        lib_out = library()
    except TypeError:  # a torch without enable_gqa: the kv heads expanded first
        k_l, v_l = (x.repeat_interleave(group, dim=1) for x in (k_l, v_l))
        library = lambda: sdpa(q_l, k_l, v_l, attn_mask=mask, scale=scale)  # noqa: E731
        lib_out = library()
    base = ca.decode_attention(qw, k, v, serving, scale, s_len)
    lib_err = float((lib_out.reshape(lanes, n_kv, group, t, hd).permute(0, 3, 1, 2, 4)
                     - base).abs().max())
    library_ms = graph_ms(torch, [library] * reps)
    n_rows = (serving.clamp(max=s_len - 1) + 1)  # each row's slots
    slots_read = int(n_rows.max(dim=1).values.sum())  # once a lane, for all rows
    n_bytes = slots_read * n_kv * hd * 2 * 2 + 2 * qw.numel() * 4 + serving.numel() * 8
    n_ops = int(n_rows.sum()) * n_kv * group * hd * 4
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / F32_OPS_S
    return {"lanes": lanes, "rows": t, "first_positions": serving[:, 0].tolist(),
            "max_abs_err": err, "max_abs_ref": ref_max, "tol": ATTN_TOL,
            "rows_bit_equal_to_one_row_calls": rows_checked,
            "library_max_abs_err": lib_err, "ms": ms, "ms_as_one_row_calls": ms_one_row_calls,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "slots_read": slots_read, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops}


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


def _request(url, body=None, headers=None, timeout=600):
    """(status, headers, raw body) of one HTTP call; an error status is
    returned, not raised."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json",
                                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


class Server:
    """One ``dllama_api`` process on a free port, healthy on return.
    ``stop`` SIGTERMs it (a drain) and checks exit 0; ``kill`` ends it
    whatever its state; ``tail`` prints the end of its log."""

    def __init__(self, model: str, tok: str, name: str, args=(), env=None,
                 log_dir: str = OUT_DIR, health_timeout: float = 900.0):
        os.makedirs(log_dir, exist_ok=True)
        self.name = name
        self.base = f"http://127.0.0.1:{_free_port()}"
        cmd = [sys.executable, "-m", f"{PKG}.app.dllama_api", "--model", model,
               "--tokenizer", tok, "--host", "127.0.0.1",
               "--port", self.base.rsplit(":", 1)[1], *args]
        full_env = dict(os.environ, **(env or {}))
        full_env["PYTHONPATH"] = ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")
        full_env.pop("DLLAMA_DEQUANT", None)
        self.log_path = os.path.join(log_dir, f"chip_smoke_server_{name}.log")
        t0 = time.perf_counter()
        with open(self.log_path, "w") as logf:
            self.proc = subprocess.Popen(cmd, cwd=ROOT, env=full_env, stdout=logf,
                                         stderr=subprocess.STDOUT)
        try:
            while True:
                check(self.proc.poll() is None, f"server ({name}) exited with "
                                                f"{self.proc.returncode}; see {self.log_path}")
                try:
                    if _http(self.base + "/health", timeout=5)[0] == 200:
                        break
                except OSError:
                    pass
                check(time.perf_counter() - t0 < health_timeout, f"server ({name}) not healthy")
                time.sleep(1.0)
        except BaseException:
            self.tail()
            self.kill()
            raise
        self.startup_s = time.perf_counter() - t0

    def stats(self) -> dict:
        return json.loads(_http(self.base + "/stats")[1])

    def stop(self) -> str:
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=90)
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"server ({self.name}) did not exit after SIGTERM") from None
        check(rc == 0, f"server ({self.name}) exited {rc} after SIGTERM; see {self.log_path}")
        with open(self.log_path, errors="replace") as f:
            return f.read()

    def tail(self) -> None:
        with open(self.log_path, errors="replace") as f:
            lines = f.readlines()[-40:]
        print(f"--- last lines of {self.log_path}:\n" + "".join(lines), file=sys.stderr,
              flush=True)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def serve_pass(model: str, tok: str, mode: str | None, n_tokens: int,
               extra_args=(), log_dir: str = OUT_DIR, health_timeout: float = 900.0,
               name: str | None = None, alone: bool = False) -> dict:
    """One dllama_api process: 4 concurrent requests, checks, /stats,
    SIGTERM (``alone``: then each request streamed alone, its text kept).
    Returns the pass's measurements, launch counts, bodies and startup
    log."""
    name = name or mode or "default"
    srv = Server(model, tok, name, (*(["--dequant", mode] if mode else []), *extra_args),
                 log_dir=log_dir, health_timeout=health_timeout)
    base = srv.base
    try:
        startup_s = srv.startup_s

        probe = json.loads(_http(base + "/v1/completions", {
            "prompt": "a" * SPEC_RUN, "max_tokens": SPEC_PROBE_TOKENS, "temperature": 0})[1])
        greedy = ("/v1/completions", {"prompt": "a" + _text(probe) + "a" * SPEC_RUN,
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
                n = r["summary"].get("n_generated_tokens", 0)
            else:
                n = r["completion_tokens"]
            check(1 <= n <= n_tokens, f"{n} tokens for max_tokens {n_tokens} ({name})")
            check(n == n_tokens or r["finish"] == "stop",
                  f"{n} tokens, finish {r['finish']} ({name})")
            r["n_tokens"] = n
        stats = json.loads(_http(base + "/stats")[1])
        alone_texts = [_stream(base + route, body)[1] for route, body in bodies] if alone else None
        status, models = _http(base + "/v1/models")
        check(status == 200 and json.loads(models)["data"], "/v1/models")

        ttft = [r["summary"]["ttft_s"] * 1e3 for r in results
                if r["summary"].get("ttft_s") is not None]
        # decode tok/s a request: tokens after the first over first -> last
        per_req = [round((r["n_tokens"] - 1) / (r["summary"]["phases"]["decode_ms"] / 1e3), 3)
                   for r in results
                   if r["n_tokens"] > 1 and r["summary"]["phases"]["decode_ms"] > 0]
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
               "decode_steps": stats["decode_steps"], "device": stats["device"],
               "alone_texts": alone_texts, "bodies": bodies,
               "concurrent_texts": [r["text"] for r in results],
               "prefix_hits": stats["prefix_hits"],
               "prefix_tokens_saved": stats["prefix_tokens_saved"],
               "jit_compiles_after_warmup": stats["jit_compiles_after_warmup"],
               **{k: stats[k] for k in ("pipeline_dispatches", "pipeline_flushes",
                                        "pipeline_depth_hist", "multi_dispatches",
                                        "fused_steps", "fused_bucket_hist", "overlap_s",
                                        "decode_graphs", "decode_graph_replays",
                                        "gumbel_sample_launches", "decode_attn_launches",
                                        "decode_attn_window_launches", "spec_steps",
                                        "spec_pipelined_steps", "spec_lane_steps",
                                        "spec_emitted", "spec_tokens_per_lane_step",
                                        "spec_accept_hist")}}
        log(f"TTFT ms [{name}]: p50 {out['ttft_ms_p50']} per request {ttft}")
        log(f"decode tok/s [{name}]: per request {per_req}, batch of 4 "
            f"{out['tokens_per_s_batch']:.1f} tok/s ({total_tokens} tokens in {batch_s:.2f}s)")
        log(f"launches [{name}]: {stats['kernel_launches']}, gumbel_sample "
            f"{stats['gumbel_sample_launches']}, decode_attn {stats['decode_attn_launches']} "
            f"({stats['decode_attn_window_launches']} of them verify windows)")
        log(f"speculation [{name}]: {stats['spec_steps']} verify steps "
            f"({stats['spec_pipelined_steps']} in the chain), {stats['spec_lane_steps']} "
            f"drafted lane steps, spec_tokens_per_lane_step "
            f"{stats['spec_tokens_per_lane_step']}, accept counts {stats['spec_accept_hist']}; "
            f"batch {out['tokens_per_s_batch']:.1f} tok/s")
        log(f"serving paths [{name}]: pipelined {stats['pipeline_dispatches']} (depth "
            f"{stats['pipeline_depth_hist']}), flushes {stats['pipeline_flushes']}, fused "
            f"{stats['fused_steps']}, multi-step {stats['multi_dispatches']}, decode graphs "
            f"{stats['decode_graphs']} ({stats['decode_graph_replays']} replays)")

        out["log"] = srv.stop()
        warm = re.search(r"Warmup done in ([0-9.]+)s(?: \((\d+) decode graphs captured in "
                         r"([0-9.]+)s\))?", out["log"])
        check(warm is not None, f"server ({name}): no warmup line in the log")
        out["warmup_s"] = float(warm.group(1))
        out["graphs_captured"] = int(warm.group(2)) if warm.group(2) else 0
        out["graph_capture_s"] = float(warm.group(3)) if warm.group(3) else 0.0
        return out
    except BaseException:
        srv.tail()
        raise
    finally:
        srv.kill()


SYNC_ARGS = ("--pipeline-depth", "0", "--multi-step", "0")
NO_SPEC_ARGS = ("--no-spec",)


def check_serving_paths(p: dict, sync: bool = False, spec: bool = True) -> None:
    """The serving loop a pass ran: every pass steps from the graphs
    captured at warmup (the step and, with speculation, the verify step,
    greedy and sampled: no horizon, which neither loop picks) and samples
    through the kernel; with speculation the drafting request's lane
    drafted and verify steps ran through the window attention (inside the
    chain under the defaults); under the defaults pipelined dispatches,
    fused admissions (the 4 requests arrive together, so 3 join a live
    chain) and no flush; the synchronous pass none of those."""
    name = p["mode"]
    check(p["gumbel_sample_launches"] > 0, f"{name}: gumbel_sample never launched")
    check(p["decode_attn_launches"] > 0, f"{name}: decode_attn never launched")
    graphs = 4 if spec else 2
    check(p["decode_graphs"] == graphs and p["graphs_captured"] == p["decode_graphs"]
          and p["decode_graph_replays"] > 0,
          f"{name}: {p['decode_graphs']} decode graphs (expected {graphs}), "
          f"{p['graphs_captured']} at warmup, {p['decode_graph_replays']} replays")
    if spec:
        check(p["spec_steps"] > 0 and p["spec_lane_steps"] > 0
              and p["decode_attn_window_launches"] > 0,
              f"{name}: {p['spec_steps']} verify steps, {p['spec_lane_steps']} drafted lane "
              f"steps, {p['decode_attn_window_launches']} window launches")
    else:
        check(p["spec_steps"] == 0 and p["decode_attn_window_launches"] == 0,
              f"{name}: verify steps ran with --no-spec")
    if sync:
        check(p["pipeline_dispatches"] == 0 and p["multi_dispatches"] == 0
              and p["fused_steps"] == 0 and p["spec_pipelined_steps"] == 0,
              f"{name}: the synchronous pass pipelined")
        return
    check(p["pipeline_dispatches"] > 0 and p["fused_steps"] > 0,
          f"{name}: pipelined {p['pipeline_dispatches']}, fused {p['fused_steps']}")
    check(p["pipeline_flushes"] == 0, f"{name}: {p['pipeline_flushes']} pipeline flushes")
    if spec:
        check(p["spec_pipelined_steps"] > 0, f"{name}: no verify step inside the chain")


def serving_phase(torch, q) -> list:
    torch.cuda.empty_cache()  # the servers are other processes on this card
    model, tok = ensure_model(llama32_1b_header(), seed=0)
    passes = []
    # (mode, extra args, tokens, alone, the kernels its run must have launched)
    for mode, extra, n_tokens, alone, expect in (
            (None, (), GEN_TOKENS, True, ("q40_slab",)),
            (None, SYNC_ARGS, GEN_TOKENS, True, ("q40_slab",)),
            (None, NO_SPEC_ARGS, GEN_TOKENS, True, ("q40_slab",)),
            ("auto", (), GEN_TOKENS, False, ("q40_i8blockdot", "q40_slab")),
            ("blockdot", (), 16, False, ("q40_blockdot", "q40_slab"))):
        name = {SYNC_ARGS: "v4-sync", NO_SPEC_ARGS: "v4-no-spec"}.get(extra)
        p = serve_pass(model, tok, mode, n_tokens, extra_args=extra, alone=alone, name=name)
        check(p["device"].startswith("cuda"), f"server ran on {p['device']}")
        for k in expect:
            check(p["kernel_launches"][k] > 0, f"{p['mode']}: {k} never launched")
        check_serving_paths(p, sync=extra == SYNC_ARGS, spec=extra != NO_SPEC_ARGS)
        passes.append(p)
    default = passes[0]
    for other in passes[1:3]:
        for how in ("alone", "concurrent"):
            for i, (a, b) in enumerate(zip(default[f"{how}_texts"], other[f"{how}_texts"])):
                check(a == b, f"request {i} {how}: the default loop's stream differs from "
                              f"{other['mode']}'s:\n{a!r}\n{b!r}")
        check(default["greedy_text"] == other["greedy_text"],
              f"greedy text differs between the default loop and {other['mode']}")
    log(f"serving loops: {len(default['alone_texts'])} streams (2 greedy, 2 seeded), alone "
        "and concurrent, byte-identical between the defaults (speculation in the chain), "
        "--pipeline-depth 0 --multi-step 0 (the synchronous verify step) and --no-spec")
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
        check_serving_paths(p)
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


# ---------------------------------------------------------------------------
# Phase 3b: the serving layers (QoS admission, prefix cache, containment,
# watchdog, telemetry) on the card
# ---------------------------------------------------------------------------

LAYERS_QUEUE = 4  # --max-queue of the overload server
LAYERS_BURST = 16  # concurrent requests against 8 lanes and that queue
# tokens of a request that holds its lane through a burst: the first
# holder must still decode when the last one is admitted and the burst
# arrives (alone it runs ~200 tok/s), or a freed lane takes a burst request
LAYERS_LONG = 512
# the fault server's plan: one dispatch fault in the first concurrent batch
FAULT_SPEC = "engine.dispatch:@6:n=1"
# the watchdog server's: one consume blackholed for HANG_S, far past the
# deadline; the 60th consume lands in the long request after the prefix one
HANG_S = 3.0
STEP_DEADLINE_S = 1.0
HANG_SPEC = f"engine.consume:@60:n=1:kind=hang:hang={HANG_S}"
PREFIX_BODY = {"prompt": "a" * SPEC_RUN + " second", "max_tokens": 32, "temperature": 0}

_PROM_RE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})? '
                      r'(-?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|Inf)|NaN)$')


def _json_call(base: str, route: str, body=None, headers=None):
    status, hdrs, raw = _request(base + route, body, headers)
    return status, hdrs, json.loads(raw)


def _poll(pred, timeout: float, msg: str, every: float = 0.05):
    deadline = time.perf_counter() + timeout
    while True:
        got = pred()
        if got:
            return got
        check(time.perf_counter() < deadline, msg)
        time.sleep(every)


def _load(base: str) -> dict:
    return _json_call(base, "/load")[2]


def _concurrent(base: str, bodies: list, route: str = "/v1/completions") -> list:
    """POST every body at once (a barrier releases the threads together);
    returns (status, headers, json) per body."""
    out: list = [None] * len(bodies)
    gate = threading.Barrier(len(bodies))

    def worker(i, body):
        gate.wait()
        out[i] = _json_call(base, route, body)

    threads = [threading.Thread(target=worker, args=(i, b)) for i, b in enumerate(bodies)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(all(o is not None for o in out), "a concurrent request never returned")
    return out


def _fill_lanes(base: str, n: int, tag: str) -> tuple:
    """Start ``n`` long requests in threads, each once the one before holds
    a lane (a burst could overflow the small queue before the loop claims
    it), until no lane is free."""
    out: list = [None] * n

    def worker(i):
        out[i] = _json_call(base, "/v1/completions",
                            {"prompt": f"{tag} holder {i}", "max_tokens": LAYERS_LONG,
                             "temperature": 0})

    threads = []
    for i in range(n):
        threads.append(threading.Thread(target=worker, args=(i,)))
        threads[-1].start()
        _poll(lambda i=i: _load(base)["lanes_free"] <= n - 1 - i, 60,
              f"{tag}: holder {i} never took a lane")
    return threads, out


def overload_check(base: str) -> dict:
    """(a) 16 concurrent requests against 8 lanes and a queue of 4: the
    first 8 hold the lanes (long), then 8 short ones arrive together;
    exactly the overflow, 16 - 8 - 4, gets 429 with Retry-After >= 1 and
    every admitted request finishes. Then a ``high`` request queued after
    three ``normal`` ones takes the next lane (its queued slice on /trace
    ends first)."""
    lanes = _load(base)["lanes_total"]
    threads, held = _fill_lanes(base, lanes, "overload")
    # half of the burst samples (seeded), so the sampler serves under load too
    burst = _concurrent(base, [{"prompt": f"overload burst {i}", "max_tokens": 8,
                                "temperature": 0.8 * (i % 2), "seed": i}
                               for i in range(LAYERS_BURST - lanes)])
    for t in threads:
        t.join(timeout=600)
    shed = [r for r in burst if r[0] == 429]
    want = LAYERS_BURST - lanes - LAYERS_QUEUE
    check(len(shed) == want, f"overload: {len(shed)} of {LAYERS_BURST} got 429, expected {want} "
                             f"({lanes} lanes, queue {LAYERS_QUEUE}): "
                             f"{[r[0] for r in burst]}")
    for status, hdrs, body in shed:
        check(body.get("reason") == "queue_full" and int(hdrs.get("Retry-After", 0)) >= 1,
              f"overload: a 429 without its reason or Retry-After: {hdrs} {body}")
    served = [r for r in held + burst if r[0] != 429]
    for status, _, body in served:
        check(status == 200 and body["usage"]["completion_tokens"] >= 1
              and body["choices"][0]["finish_reason"] in ("stop", "length"),
              f"overload: an admitted request did not finish: {status} {body}")
    retry = sorted(int(h["Retry-After"]) for _, h, _ in shed)

    # priority: three normal requests queued, then a high one
    threads, held = _fill_lanes(base, lanes, "priority")
    queued: list = [None] * 4

    def post(i, prio):
        queued[i] = _json_call(base, "/v1/completions",
                               {"prompt": f"priority {prio} {i}", "max_tokens": 4,
                                "temperature": 0, "priority": prio, "user": f"u{i}"})

    waiters = []
    for i, prio in enumerate(("normal", "normal", "normal", "high")):
        t = threading.Thread(target=post, args=(i, prio))
        t.start()
        waiters.append(t)
        _poll(lambda i=i: _load(base)["queue_depth"] == i + 1, 30,
              f"priority: request {i} never queued")
    for t in waiters + threads:
        t.join(timeout=600)
    check(all(q is not None and q[0] == 200 for q in queued), f"priority: {queued}")
    ids = [int(q[2]["id"].rsplit("-", 1)[1]) for q in queued]
    trace = _json_call(base, "/trace")[2]["traceEvents"]
    admitted = {e["args"]["request_id"]: e["ts"] + e["dur"] for e in trace
                if e["name"] == "queued" and e["args"].get("request_id") in ids}
    check(len(admitted) == 4, f"priority: queued slices of {sorted(admitted)} of {ids}")
    check(admitted[ids[3]] < min(admitted[i] for i in ids[:3]),
          f"priority: the high request was not admitted first: {admitted}")
    log(f"serving layers (a): {len(shed)} of {LAYERS_BURST} shed with 429 (Retry-After "
        f"{retry} s), {len(served)} served; the high request took the next lane")
    return {"shed": len(shed), "served": len(served), "retry_after_s": retry,
            "priority_admit_order_us": [admitted[i] for i in ids]}


def prefix_request(base: str, label: str) -> dict:
    status, _, body = _json_call(base, "/v1/completions", PREFIX_BODY)
    check(status == 200, f"prefix [{label}]: status {status}: {body}")
    s = body["summary"]
    log(f"serving layers (b) [{label}]: TTFT {s['ttft_s'] * 1e3:.1f} ms, "
        f"{s['prefix_tokens_saved']} prompt tokens from a resident lane")
    return {"text": _text(body), "ttft_ms": s["ttft_s"] * 1e3,
            "prefix_tokens_saved": s["prefix_tokens_saved"]}


def prefix_check(base: str) -> dict:
    """(b) A request sharing the 1,900-token drafting run with a finished
    lane takes its prefix from that lane (prefix_hits >= 1): the whole
    prompt chunks of it, 1,024 tokens (the server's largest prefill
    bucket)."""
    from distributed_llama_multiusers_tpu_torch.runtime.engine import DEFAULT_PREFILL_BUCKETS

    status, _, body = _json_call(base, "/v1/completions",
                                 {**PREFIX_BODY, "prompt": "a" * SPEC_RUN + " first",
                                  "max_tokens": 8})
    check(status == 200, f"prefix: the first request failed: {body}")
    hits = _json_call(base, "/stats")[2]["prefix_hits"]
    warm = prefix_request(base, "resident prefix")
    after = _json_call(base, "/stats")[2]
    chunk = DEFAULT_PREFILL_BUCKETS[-1]
    check(after["prefix_hits"] >= hits + 1 and warm["prefix_tokens_saved"] >= chunk
          and warm["prefix_tokens_saved"] % chunk == 0,
          f"prefix: no hit ({hits} -> {after['prefix_hits']}, "
          f"{warm['prefix_tokens_saved']} tokens saved)")
    return warm


def _quiet_stats(base: str, label: str) -> dict:
    """/stats once the loop is idle: no lane busy, nothing queued, and the
    step counters still between two reads (the chain drains its last
    in-flight step after the last request resolves)."""
    _poll(lambda: (lambda ld: ld["lanes_free"] == ld["lanes_total"]
                   and ld["queue_depth"] == 0)(_load(base)), 60, f"{label}: never idle")
    keys = ("decode_steps", "pipeline_dispatches", "decode_graph_replays")
    prev = _json_call(base, "/stats")[2]

    def settled():
        nonlocal prev
        cur = _json_call(base, "/stats")[2]
        same = all(cur[k] == prev[k] for k in keys)
        prev = cur
        return cur if same else None

    return _poll(settled, 30, f"{label}: the step counters never settled", every=0.2)


def telemetry_check(base: str, label: str) -> dict:
    """(e) With the loop idle, /metrics parses, its bridged gauges equal
    /stats field for field, no graph was captured after warmup, and /trace
    is loadable Chrome JSON."""
    stats = _quiet_stats(base, label)
    status, hdrs, raw = _request(base + "/metrics")
    check(status == 200 and hdrs["Content-Type"].startswith("text/plain; version=0.0.4"),
          f"{label}: /metrics {status} {hdrs.get('Content-Type')}")
    samples = {}
    for line in raw.decode().splitlines():
        if not line or line.startswith("#"):
            continue
        m = _PROM_RE.match(line)
        check(m is not None, f"{label}: unparseable /metrics line {line!r}")
        samples[(m.group(1), m.group(2) or "")] = float(m.group(3))
    for key in ("decode_steps", "pipeline_dispatches", "fused_steps", "queue_popped",
                "queue_rejected_full", "prefill_tokens", "prefix_hits", "decode_graph_replays",
                "jit_compiles_after_warmup", "breaker_state_code", "gumbel_sample_launches",
                "decode_attn_launches"):
        check(samples.get((f"dllama_stats_{key}", "")) == stats[key],
              f"{label}: /metrics dllama_stats_{key} "
              f"{samples.get((f'dllama_stats_{key}', ''))} against /stats {stats[key]}")
    check(stats["jit_compiles_after_warmup"] == 0
          and samples[("dllama_jit_compiles_total", "")] == 0,
          f"{label}: {stats['jit_compiles_after_warmup']} decode graphs captured after warmup")
    check(samples[("dllama_ttft_seconds_count", "")] >= 1, f"{label}: no TTFT observed")
    status, _, raw = _request(base + "/trace")
    doc = json.loads(raw)
    with open(os.path.join(OUT_DIR, f"chip_smoke_trace_{label}.json"), "wb") as f:
        f.write(raw)
    events = doc["traceEvents"]
    check(status == 200 and all({"name", "ph", "pid", "tid", "ts"} <= set(e) for e in events)
          and any(e["name"] == "generate" and e["ph"] == "X" for e in events)
          and any(e["name"].startswith("step.") for e in events),
          f"{label}: /trace is not a Chrome trace of the served requests")
    log(f"serving layers (e) [{label}]: /metrics ({len(samples)} samples) reconciles with "
        f"/stats; /trace {len(events)} events; graphs captured after warmup 0")
    return {"metrics_samples": len(samples), "trace_events": len(events),
            "trace_recorded": stats["trace_events_recorded"]}


def _check_serving_kernels(stats: dict, label: str) -> None:
    """The server's run launched the serving kernels: the slab (v4), the
    decode attention, and the sampler (each server serves a sampled
    request)."""
    for k, n in (("q40_slab", stats["kernel_launches"]["q40_slab"]),
                 ("gumbel_sample", stats["gumbel_sample_launches"]),
                 ("decode_attn", stats["decode_attn_launches"])):
        check(n > 0, f"{label}: {k} never launched")


def fault_check(model: str, tok: str, clean: dict) -> dict:
    """(c) With ``DLLAMA_FAULTS`` set to one dispatch fault, the clean v4
    pass's 4 requests are sent together: the lanes in flight at the fault
    end with an error; each request sent afterwards, alone, streams the
    clean pass's text, and the decode graphs replay on with no capture."""
    srv = Server(model, tok, "faults", env={"DLLAMA_FAULTS": FAULT_SPEC})
    try:
        bodies = clean["bodies"]
        results = [None] * len(bodies)

        def worker(i, route, body):
            if body.get("stream"):
                try:
                    results[i] = ("stream", _stream(srv.base + route, body)[1])
                except SmokeFailure as e:  # the error chunk of a failed stream
                    results[i] = ("error", str(e))
            else:
                status, _, b = _json_call(srv.base, route, body)
                results[i] = ("ok", _text(b)) if status == 200 else ("error", b.get("error"))

        threads = [threading.Thread(target=worker, args=(i, r, b))
                   for i, (r, b) in enumerate(bodies)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        failed = [r for r in results if r[0] == "error"]
        check(failed and all("injected fault" in str(r[1]) for r in failed),
              f"faults: the injected fault failed no lane, or another error: {results}")
        mid = srv.stats()
        check(mid["engine_failure_rounds"] == 1 and mid["engine_failures"] == {"engine": 1},
              f"faults: {mid['engine_failure_rounds']} containment rounds, "
              f"{mid['engine_failures']}")
        t_after = time.perf_counter()
        later = [_stream(srv.base + route, body)[1] for route, body in bodies]
        recovery_s = time.perf_counter() - t_after
        for i, (got, want) in enumerate(zip(later, clean["alone_texts"])):
            check(got == want, f"faults: request {i} after the fault differs from the clean "
                               f"v4 pass:\n{got!r}\n{want!r}")
        end = srv.stats()
        # the decode graphs exist on a card only (a CPU run steps eagerly)
        check(not end["device"].startswith("cuda")
              or (end["decode_graph_replays"] > mid["decode_graph_replays"]
                  and end["jit_compiles_after_warmup"] == 0 and end["decode_graphs"] == 4),
              f"faults: graph replays {mid['decode_graph_replays']} -> "
              f"{end['decode_graph_replays']}, {end['decode_graphs']} graphs, "
              f"{end['jit_compiles_after_warmup']} captured after warmup")
        _check_serving_kernels(end, "faults")
        log(f"serving layers (c): {len(failed)} of {len(bodies)} in-flight requests failed on "
            f"the injected dispatch fault; the {len(later)} sent afterwards stream the clean "
            f"v4 pass's text ({recovery_s:.2f} s); decode graph replays "
            f"{mid['decode_graph_replays']} -> {end['decode_graph_replays']}, 0 captures "
            "after warmup")
        out = {"failed": len(failed), "requests": len(bodies),
               "replays_at_fault": mid["decode_graph_replays"],
               "replays_after": end["decode_graph_replays"], "later_s": recovery_s}
        srv.stop()
        return out
    except BaseException:
        srv.tail()
        raise
    finally:
        srv.kill()


def watchdog_check(model: str, tok: str, warm: dict) -> dict:
    """(b) cold half and (d): a server with the prefix cache off and the
    step watchdog on. The prefix request's stream equals the resident-
    prefix server's. Then a long request meets one blackholed consume:
    /health turns 503 within the deadline, the request still completes,
    and after the breaker's cooldown a probe request closes it (/health
    200); serving continues."""
    srv = Server(model, tok, "watchdog", ("--prefix-min-tokens", "0",
                                          "--step-deadline", str(STEP_DEADLINE_S)),
                 env={"DLLAMA_FAULTS": HANG_SPEC})
    try:
        cold = prefix_request(srv.base, "cold server")
        check(cold["prefix_tokens_saved"] == 0, "watchdog: a prefix hit with the cache off")
        check(cold["text"] == warm["text"],
              f"prefix: the resident-prefix stream differs from the cold server's:\n"
              f"{warm['text']!r}\n{cold['text']!r}")
        long_out: list = []
        t = threading.Thread(target=lambda: long_out.append(_json_call(
            srv.base, "/v1/completions", {"prompt": "tell me a long story", "max_tokens": 128,
                                          "temperature": 0})))
        t0 = time.perf_counter()
        t.start()
        _poll(lambda: _request(srv.base + "/health")[0] == 503, 60,
              "watchdog: /health never turned 503")
        tripped_s = time.perf_counter() - t0
        st = srv.stats()
        check(st["watchdog_trips"] == 1 and st["breaker_state"] == "open"
              and st["engine_failures"] == {"watchdog": 1},
              f"watchdog: trips {st['watchdog_trips']}, breaker {st['breaker_state']}, "
              f"{st['engine_failures']}")
        t.join(timeout=600)
        check(long_out and long_out[0][0] == 200
              and long_out[0][2]["usage"]["completion_tokens"] >= 1,
              f"watchdog: the long request did not complete: {long_out}")

        def probe():
            status, _, body = _json_call(srv.base, "/v1/completions",
                                         {"prompt": "probe", "max_tokens": 4, "temperature": 0})
            check(status in (200, 503), f"watchdog: probe {status} {body}")
            return status == 200

        _poll(probe, 60, "watchdog: the breaker never let a probe through", every=0.5)
        status, _, health = _json_call(srv.base, "/health")
        recovered_s = time.perf_counter() - t0
        st = srv.stats()
        check(status == 200 and st["breaker_state"] == "closed" and st["breaker_probes"] >= 1,
              f"watchdog: /health {status}, breaker {st['breaker_state']}, probes "
              f"{st['breaker_probes']}")
        status, _, body = _json_call(srv.base, "/v1/completions",
                                     {"prompt": "after", "max_tokens": 8, "temperature": 0.7,
                                      "seed": 1})
        check(status == 200, f"watchdog: serving did not continue: {status} {body}")
        _check_serving_kernels(srv.stats(), "watchdog")
        log(f"serving layers (d): /health 503 {tripped_s:.2f} s after the long request "
            f"started (deadline {STEP_DEADLINE_S} s, hang {HANG_S} s), 200 again "
            f"{recovered_s:.2f} s after it, after {st['breaker_probes']} half-open probe(s); "
            "serving continued")
        srv.stop()
        return {"cold": cold, "health_503_after_s": tripped_s, "recovered_after_s": recovered_s,
                "breaker_last_recovery_s": st["breaker_last_recovery_s"]}
    except BaseException:
        srv.tail()
        raise
    finally:
        srv.kill()


def serving_layers_phase(model: str, tok: str, clean: dict) -> dict:
    """The JAX server's always-on multi-user layers on the full-width
    model under the serving defaults (v4, speculation, pipelining, fused
    prefill): (a) bounded admission and priority, (b) the per-lane prefix
    cache against a cold server, (c) containment of an injected dispatch
    fault, (d) the step watchdog and the breaker's recovery, (e) /metrics
    and /trace."""
    srv = Server(model, tok, "layers", ("--max-queue", str(LAYERS_QUEUE)))
    try:
        out = {"overload": overload_check(srv.base)}
        out["prefix_warm"] = prefix_check(srv.base)
        out["telemetry"] = telemetry_check(srv.base, "layers")
        _check_serving_kernels(srv.stats(), "layers")
        srv.stop()
    except BaseException:
        srv.tail()
        raise
    finally:
        srv.kill()
    out["faults"] = fault_check(model, tok, clean)
    out["watchdog"] = watchdog_check(model, tok, out["prefix_warm"])
    w, c = out["prefix_warm"], out["watchdog"]["cold"]
    log(f"serving layers (b): TTFT {w['ttft_ms']:.1f} ms with the prefix resident against "
        f"{c['ttft_ms']:.1f} ms cold; greedy streams equal")
    return out


# ---------------------------------------------------------------------------
# Phase 3c: the dllama CLI (inference and chat) on the card
# ---------------------------------------------------------------------------

CLI_STEPS = GEN_TOKENS  # the serving passes' greedy request runs 64 tokens
# the chat check's tokenizer also ends a turn on the top sixteenth of the
# vocabulary (reserved tokens): a random model never emits the end-of-turn
# token, so without them the first reply would run to the end of the context
CHAT_STOP_FRACTION = 16


def _launch_counts() -> dict:
    """The kernels' launch counters, keyed as a serving pass's /stats."""
    from distributed_llama_multiusers_tpu_torch.ops import cuda_attn as ca
    from distributed_llama_multiusers_tpu_torch.ops import cuda_q40 as q
    from distributed_llama_multiusers_tpu_torch.ops import cuda_sample as cs
    from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc

    return {"kernel_launches": dict(q.LAUNCHES), "ring_hop_launches": rc.COUNTS["launches"],
            "ring_hop_bytes": rc.COUNTS["bytes"],
            "gumbel_sample_launches": cs.COUNTS["launches"],
            "decode_attn_launches": ca.COUNTS["launches"],
            "decode_attn_window_launches": ca.COUNTS["window_launches"]}


def run_cli(torch, name: str, argv: list, stdin: str | None = None) -> dict:
    """One ``dllama`` run through its entry point (``app.dllama.main``) in
    this process, stdout captured (and stdin given), the counters zeroed
    before it (the CLI zeroes them again after its warmup, as the server
    does): its output, seconds and the kernels' launches. The dequant mode
    it sets is restored after it."""
    import contextlib
    import gc
    import io

    from distributed_llama_multiusers_tpu_torch.app import dllama
    from distributed_llama_multiusers_tpu_torch.ops import cuda_attn as ca
    from distributed_llama_multiusers_tpu_torch.ops import cuda_q40 as q
    from distributed_llama_multiusers_tpu_torch.ops import cuda_sample as cs
    from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc

    for mod in (q, rc, cs, ca):
        mod.reset_counts()
    mode = q.DEQUANT_MODE
    buf, old_stdin = io.StringIO(), sys.stdin
    t0 = time.perf_counter()
    try:
        if stdin is not None:
            sys.stdin = io.StringIO(stdin)
        with contextlib.redirect_stdout(buf):
            dllama.main(argv)
    except SystemExit as e:
        raise SmokeFailure(f"dllama ({name}) exited {e.code}:\n{buf.getvalue()[-2000:]}") from None
    finally:
        sys.stdin = old_stdin
        q.set_dequant_mode(mode)
    seconds = time.perf_counter() - t0
    out = buf.getvalue()
    with open(os.path.join(OUT_DIR, f"chip_smoke_cli_{name}.log"), "w") as f:
        f.write(out)
    counts = _launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    return {"mode": f"cli-{name}", "argv": [a if len(a) < 200 else a[:40] + "..." for a in argv],
            "out": out, "seconds": seconds, **counts}


def _inference_readout(run: dict) -> dict:
    """The generated text (Pred lines taken out) and the readout numbers of
    a ``dllama inference --benchmark`` run."""
    out = run["out"]
    check("🔷 Eval" in out and "⏱ Prediction" in out,
          f"{run['mode']}: no Eval/Prediction readout:\n{out[-2000:]}")
    body = out.split("🔷 Eval", 1)[1].split("\n", 1)[1].split("\n⏱ Evaluation", 1)[0]
    preds = re.findall(r"🔶 Pred +([0-9.]+) ms[^\n]*\n", body)
    ev = re.search(r"Evaluation: ([0-9.]+) ms \(([0-9.]+) tok/s\)", out)
    pr = re.search(r"Prediction: ([0-9.]+) ms \(([0-9.]+) tok/s\)", out)
    spec = re.search(r"Speculation: (\d+) verify steps, (\d+) tokens \(([0-9.]+) a step\)", out)
    measured = re.search(r"Measured/step: [^\n]*", out)
    run.update(text=re.sub(r"🔶 Pred [^\n]*\n", "", body), pred_lines=len(preds),
               eval_ms=float(ev.group(1)), eval_tok_s=float(ev.group(2)),
               pred_ms=float(pr.group(1)), pred_tok_s=float(pr.group(2)),
               spec_verify_steps=int(spec.group(1)) if spec else 0,
               spec_tokens=int(spec.group(2)) if spec else 0,
               spec_tokens_per_step=float(spec.group(3)) if spec else None,
               sync_kb_per_chip=[float(x) for x in re.findall(r"Sync +([0-9.]+) kB/chip", body)],
               measured_step=measured.group(0) if measured else None)
    log(f"cli [{run['mode']}]: Eval {run['eval_ms']:.2f} ms ({run['eval_tok_s']:.1f} tok/s), "
        f"Prediction {run['pred_ms']:.2f} ms ({run['pred_tok_s']:.1f} tok/s), "
        f"{run['pred_lines']} Pred lines, spec {run['spec_verify_steps']} verify steps "
        f"{run['spec_tokens']} tokens ({run['spec_tokens_per_step']} a step); launches "
        f"{run['kernel_launches']}, decode_attn {run['decode_attn_launches']} "
        f"({run['decode_attn_window_launches']} windows), ring_hop {run['ring_hop_launches']}; "
        f"{run['seconds']:.1f}s with load and warmup")
    return run


def chat_tokenizer(tok: str) -> str:
    """The smoke tokenizer with the top 1/CHAT_STOP_FRACTION of the
    vocabulary (reserved tokens) also ending a turn."""
    from distributed_llama_multiusers_tpu_torch.formats.tokenizer_file import (
        load_tokenizer_file,
        write_tokenizer_file,
    )

    data = load_tokenizer_file(tok)
    first = len(data.vocab) - len(data.vocab) // CHAT_STOP_FRACTION
    data.eos_token_ids = list(data.eos_token_ids) + [
        i for i in range(first, len(data.vocab)) if data.vocab[i].startswith(b"<|reserved_")]
    path = os.path.join(OUT_DIR, "chip_smoke_chat.t")
    with open(path, "wb") as f:
        write_tokenizer_file(f, data)
    return path


def cli_phase(torch, model: str, tok: str, passes: list) -> list:
    """``dllama inference`` on the serving phase's greedy prompt, 64 tokens,
    ``--benchmark``, under v4 and ``auto``, with and without speculation:
    its text equals the server's greedy stream for that prompt in that mode
    (the one-lane engine against the 8-lane server); a seeded run
    (``--temperature 0.8 --seed 7``) twice, equal, a forward and a Pred line
    every token; ``--workers 2`` (both ranks on the host's cards) in v4:
    the single-rank text, a Sync readout on every Pred line, the
    Measured/step line; ``dllama chat`` with two turns on stdin, twice,
    equal, the second turn answered at the carried position. Returns the
    runs, shaped like serving passes for the kernels line."""
    by_mode = {p["mode"]: p for p in passes}
    base = ["--model", model, "--tokenizer", tok, "--steps", str(CLI_STEPS), "--benchmark"]
    runs = []
    for name, mode, extra in (("v4", "v4", ()), ("v4-no-spec", "v4", ("--no-spec",)),
                              ("auto", "auto", ()), ("auto-no-spec", "auto", ("--no-spec",))):
        # each pass built its greedy prompt from its own probe request
        server = by_mode["default" if mode == "v4" else mode]
        want = server["greedy_text"]
        r = _inference_readout(run_cli(torch, name, [
            "inference", *base, "--prompt", server["bodies"][0][1]["prompt"],
            "--temperature", "0", "--dequant", mode, *extra]))
        check(r["text"] == want, f"cli {name}: the greedy text differs from the {mode} "
                                 f"server's stream for the same prompt:\n{r['text']!r}\n{want!r}")
        kernels = ("q40_slab",) if mode == "v4" else ("q40_i8blockdot", "q40_slab")
        for k in kernels:
            check(r["kernel_launches"][k] > 0, f"cli {name}: {k} never launched")
        check(r["decode_attn_launches"] > 0, f"cli {name}: decode_attn never launched")
        if extra:
            check(r["spec_verify_steps"] == 0 and r["decode_attn_window_launches"] == 0,
                  f"cli {name}: verify steps ran with --no-spec")
        else:
            check(r["spec_verify_steps"] > 0 and r["decode_attn_window_launches"] > 0,
                  f"cli {name}: no verify step ran (the prompt drafts)")
        check(r["pred_lines"] < CLI_STEPS, f"cli {name}: every token took a forward")
        runs.append(r)
    seeded = [_inference_readout(run_cli(torch, f"seeded-{i}", [
        "inference", *base, "--prompt", "once upon a time", "--temperature", "0.8",
        "--seed", "7", "--dequant", "v4"])) for i in (1, 2)]
    check(seeded[0]["text"] == seeded[1]["text"] and seeded[0]["text"],
          f"cli seeded: two runs differ:\n{seeded[0]['text']!r}\n{seeded[1]['text']!r}")
    check(seeded[0]["pred_lines"] == CLI_STEPS,
          f"cli seeded: {seeded[0]['pred_lines']} Pred lines for {CLI_STEPS} tokens")
    runs += seeded
    devices = ",".join(str(d) for d in rank_devices(torch, 2))
    tp = _inference_readout(run_cli(torch, "tp2", [
        "inference", *base, "--prompt", passes[0]["bodies"][0][1]["prompt"],
        "--temperature", "0", "--dequant", "v4",
        "--workers", "2", "--device", devices]))
    check(tp["text"] == runs[0]["text"],
          f"cli tp2: the text differs from one rank's:\n{tp['text']!r}\n{runs[0]['text']!r}")
    check(tp["ring_hop_launches"] > 0, "cli tp2: ring_hop never launched")
    check(len(tp["sync_kb_per_chip"]) == tp["pred_lines"] > 0
          and all(kb > 0 for kb in tp["sync_kb_per_chip"]),
          f"cli tp2: Sync readouts {tp['sync_kb_per_chip'][:4]} on {tp['pred_lines']} Pred lines")
    check(tp["measured_step"] is not None, "cli tp2: no Measured/step line")
    log(f"cli [tp2]: {tp['measured_step']}")
    runs.append(tp)
    chat_tok = chat_tokenizer(tok)
    turns = "hello\ntell me more\n"
    chats = [run_cli(torch, f"chat-{i}", ["chat", "--model", model, "--tokenizer", chat_tok,
                                          "--chat-template", "llama3", "--temperature", "0",
                                          "--dequant", "v4"], stdin=turns) for i in (1, 2)]
    convs = [c["out"].split("💬 Chat mode. Ctrl-D to exit.", 1)[-1] for c in chats]
    check(convs[0] == convs[1], f"cli chat: two runs differ:\n{convs[0]!r}\n{convs[1]!r}")
    check(convs[0].count("\n> ") == 3 and "Context window full" not in convs[0],
          f"cli chat: the second turn did not run at the carried position:\n{convs[0]!r}")
    check(chats[0]["decode_attn_launches"] > 0, "cli chat: decode_attn never launched")
    replies = [t.split("\n", 1)[0] for t in convs[0].split("\n> ")[1:3]]
    log(f"cli [chat]: two turns, replies {[len(r) for r in replies]} characters, equal over "
        f"two runs; launches {chats[0]['kernel_launches']}")
    runs += chats
    for r in runs:
        r.pop("out")
    return runs


# ---------------------------------------------------------------------------
# Phase 3d: crash durability (journal, recovery, resumable streams) on the card
# ---------------------------------------------------------------------------

DUR_TOKENS = 256
DUR_MIN_EVENTS = 32  # deltas each stream holds before the kill
DUR_GRACE = "30"
DUR_BODIES = [
    ("/v1/completions", {"prompt": "once upon a time", "max_tokens": DUR_TOKENS,
                         "temperature": 0}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hello"}],
                              "max_tokens": DUR_TOKENS, "temperature": 0}),
    ("/v1/completions", {"prompt": "the quick brown fox", "max_tokens": DUR_TOKENS,
                         "temperature": 0.8, "top_p": 0.9, "seed": 7}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "tell me"}],
                              "max_tokens": DUR_TOKENS, "temperature": 0.7, "top_p": 0.95,
                              "seed": 11}),
]


class SseStream:
    """One SSE stream read on a thread: its request id (the
    ``X-DLlama-Request`` header), every delta as (event id, text), the
    finish reason, whether ``[DONE]`` came, and the first delta's clock."""

    def __init__(self, url: str, body: dict | None = None, headers: dict | None = None):
        self.rid = None
        self.events: list = []
        self.finish = None
        self.done = False
        self.error = None
        self.first_at = None
        self.thread = threading.Thread(target=self._read, args=(url, body, headers),
                                       daemon=True)
        self.thread.start()

    def _read(self, url, body, headers):
        data = None if body is None else json.dumps({**body, "stream": True}).encode()
        req = urllib.request.Request(url, data=data, headers={
            "Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                self.rid = int(r.headers["X-DLlama-Request"])
                event_id = None
                for line in r:
                    line = line.decode().strip()
                    if line.startswith("id: "):
                        event_id = int(line[4:])
                    elif line == "data: [DONE]":
                        self.done = True
                        return
                    elif line.startswith("data: "):
                        chunk = json.loads(line[6:])
                        if "error" in chunk:
                            self.error = chunk
                            continue
                        choice = chunk["choices"][0]
                        if choice.get("finish_reason") is not None:
                            self.finish = choice["finish_reason"]
                            continue
                        piece = choice.get("text") or (choice.get("delta") or {}).get(
                            "content") or ""
                        if self.first_at is None:
                            self.first_at = time.perf_counter()
                        self.events.append((event_id, piece))
        except (OSError, ValueError) as e:  # the kill ends the read
            self.error = self.error or f"{type(e).__name__}: {e}"

    def join(self, timeout: float = 600) -> "SseStream":
        self.thread.join(timeout)
        check(not self.thread.is_alive(), f"stream {self.rid} never ended")
        return self


def _metric(base: str, name: str) -> float | None:
    _, _, raw = _request(base + "/metrics")
    for line in raw.decode().splitlines():
        m = _PROM_RE.match(line)
        if m and m.group(1) == name and not m.group(2):
            return float(m.group(3))
    return None


def durability_phase(model: str, tok: str) -> dict:
    """The default serving pass with and without ``--journal-path`` (batch
    tok/s and TTFT: what the journal costs); then 2 greedy and 2 seeded
    streamed requests of 256 tokens on a server without a journal (the
    reference streams) and on one with ``--journal-path --reconnect-grace
    30``, which also completes a fifth request and is SIGKILLed once each
    stream holds 32 deltas; restarted with ``--recover-journal
    --reconnect-grace 30 --max-lanes 4`` under ``DLLAMA_LEAKCHECK=1
    DLLAMA_JITCHECK=1``, each client reattaches with ``GET /v1/stream/<id>``
    and its Last-Event-ID: the text before the kill plus the reattached
    text equals the reference stream byte for byte, no index lost or
    repeated, the completed request not resurrected, ``/stats`` and
    ``/metrics`` count 4 recovered and 0 failed, no leak and no capture
    after warmup, and the SIGTERM drain exits 0."""
    from distributed_llama_multiusers_tpu_torch.serving import read_journal

    out = {}
    jpath = os.path.join(OUT_DIR, "chip_smoke_journal_pass.bin")
    if os.path.exists(jpath):
        os.remove(jpath)
    plain = serve_pass(model, tok, None, GEN_TOKENS, name="journal-off")
    journaled = serve_pass(model, tok, None, GEN_TOKENS, name="journal-on",
                           extra_args=("--journal-path", jpath))
    img = read_journal(jpath)
    check(img.records >= 2 * 7 and not img.torn and not img.incomplete(),
          f"journal pass: {img.records} records, torn {img.torn}, "
          f"{len(img.incomplete())} incomplete")
    check(journaled["greedy_text"] == plain["greedy_text"],
          "journal pass: the greedy text differs from the pass without the journal")
    for p in (plain, journaled):
        check_serving_paths(p)
    out["journal_cost"] = {k: {"tokens_per_s_batch": p["tokens_per_s_batch"],
                               "ttft_ms_p50": p["ttft_ms_p50"], "ttft_ms": p["ttft_ms"],
                               "journal_records": img.records if p is journaled else 0}
                           for k, p in (("off", plain), ("on", journaled))}
    log(f"durability: the default pass without the journal: batch "
        f"{plain['tokens_per_s_batch']:.1f} tok/s, TTFT p50 {plain['ttft_ms_p50']:.1f} ms; "
        f"with --journal-path: {journaled['tokens_per_s_batch']:.1f} tok/s, TTFT p50 "
        f"{journaled['ttft_ms_p50']:.1f} ms ({img.records} records, fsync on)")

    ref_srv = Server(model, tok, "durability-ref")
    try:
        refs = [SseStream(ref_srv.base + route, body).join() for route, body in DUR_BODIES]
        for i, r in enumerate(refs):
            check(r.done and r.error is None and len(r.events) >= DUR_MIN_EVENTS + 8,
                  f"durability reference {i}: done {r.done}, error {r.error}, "
                  f"{len(r.events)} deltas")
        out["reference_stats"] = ref_srv.stats()
        ref_srv.stop()
    except BaseException:
        ref_srv.tail()
        raise
    finally:
        ref_srv.kill()

    jpath = os.path.join(OUT_DIR, "chip_smoke_journal.bin")
    if os.path.exists(jpath):
        os.remove(jpath)
    crash = Server(model, tok, "durability-crash",
                   ("--journal-path", jpath, "--reconnect-grace", DUR_GRACE))
    try:
        status, _, fifth = _json_call(crash.base, "/v1/completions",
                                      {"prompt": "a short one", "max_tokens": 8,
                                       "temperature": 0})
        check(status == 200, f"durability: the fifth request got {status}")
        fifth_id = int(fifth["id"].split("-")[1])
        streams = [SseStream(crash.base + route, body) for route, body in DUR_BODIES]
        _poll(lambda: all(len(s.events) >= DUR_MIN_EVENTS for s in streams), 300,
              "durability: the streams never reached 32 deltas before the kill", every=0.005)
        crash.proc.kill()  # SIGKILL: no drain, no finish record
        crash.proc.wait(timeout=60)
        for s in streams:
            s.join(60)
        for i, s in enumerate(streams):
            check(not s.done and s.rid is not None,
                  f"durability stream {i} finished before the kill ({len(s.events)} deltas)")
    except BaseException:
        crash.tail()
        raise
    finally:
        crash.kill()
    before = [list(s.events) for s in streams]
    img = read_journal(jpath)
    fifth_entry = img.entries.get(fifth_id)
    check([e.request_id for e in img.incomplete()] == [s.rid for s in streams]
          and fifth_entry is not None and fifth_entry.finished,
          f"durability: the journal's in-flight set {[e.request_id for e in img.incomplete()]} "
          f"is not the 4 streams {[s.rid for s in streams]} (fifth: {fifth_entry})")

    t_restart = time.perf_counter()
    rec = Server(model, tok, "durability-recover",
                 ("--journal-path", jpath, "--recover-journal", "--reconnect-grace", DUR_GRACE,
                  "--max-lanes", "4"),
                 env={"DLLAMA_LEAKCHECK": "1", "DLLAMA_JITCHECK": "1"})
    try:
        healthy_s = time.perf_counter() - t_restart
        again = [SseStream(rec.base + f"/v1/stream/{s.rid}",
                           headers={"Last-Event-ID": str(ev[-1][0])})
                 for s, ev in zip(streams, before)]
        for r in again:
            r.join()
        first_byte_s = min(r.first_at for r in again if r.first_at is not None) - t_restart
        lost = dup = 0
        for i, (ref, ev, r) in enumerate(zip(refs, before, again)):
            check(r.done and r.error is None, f"durability stream {i}: reattach ended with "
                                              f"done {r.done}, error {r.error}")
            seen = [idx for idx, _ in ev + r.events]
            dup += len(seen) - len(set(seen))
            lost += len({idx for idx, _ in ref.events} - set(seen))
            text = "".join(t for _, t in ev + r.events)
            want = "".join(t for _, t in ref.events)
            check(text == want, f"durability stream {i} ({DUR_BODIES[i][1].get('seed')}): "
                                f"the resumed text differs from the reference:\n{text!r}\n{want!r}")
            check(r.finish == ref.finish, f"durability stream {i}: finish {r.finish} "
                                          f"against {ref.finish}")
        check(lost == 0 and dup == 0, f"durability: {lost} indices lost, {dup} repeated")
        status, _, _ = _request(rec.base + f"/v1/stream/{fifth_id}")
        check(status == 404, f"durability: the completed request answers {status} on "
                             "/v1/stream (resurrected)")
        stats = _quiet_stats(rec.base, "durability")
        check(stats["recovered_requests"] == 4 and stats["recovery_failed"] == 0
              and stats["recovery_incomplete"] == 4 and stats["recovery_done"],
              f"durability: /stats recovered {stats['recovered_requests']}, failed "
              f"{stats['recovery_failed']}, incomplete {stats['recovery_incomplete']}")
        m_rec = _metric(rec.base, "dllama_recovered_requests_total")
        m_stats = _metric(rec.base, "dllama_stats_recovered_requests")
        check(m_rec == m_stats == 4, f"durability: /metrics recovered {m_rec} / {m_stats}")
        check(stats["jit_compiles_after_warmup"] == 0 and stats["resource_leaks_total"] == 0,
              f"durability: {stats['jit_compiles_after_warmup']} graph captures after warmup, "
              f"{stats['resource_leaks_total']} leaks")
        check(stats["gumbel_sample_launches"] > 0 and stats["kernel_launches"]["q40_slab"] > 0
              and stats["decode_attn_launches"] > 0,
              "durability: the recovered streams did not run the serving kernels")
        rec_log = rec.stop()  # SIGTERM: the drain, then the witnesses at stop and close
    except BaseException:
        rec.tail()
        raise
    finally:
        rec.kill()
    check("Journal recovery: 4 incomplete request(s) replaying" in rec_log
          and "ResourceLeak" not in rec_log and "RecompileAfterWarmup" not in rec_log,
          "durability: the recovery server's log lacks the recovery line or names a witness")
    out.update({
        "streams": [{"body": DUR_BODIES[i][1], "deltas_before_kill": len(ev),
                     "last_event_id_before_kill": ev[-1][0], "deltas_reattached": len(r.events),
                     "finish": r.finish} for i, (ev, r) in enumerate(zip(before, again))],
        "restart_to_healthy_s": healthy_s, "restart_to_first_reattached_byte_s": first_byte_s,
        "recovery": {k: stats[k] for k in ("recovered_requests", "recovery_failed",
                                           "recovery_retries", "recovery_replayed_tokens",
                                           "journal_records", "resource_leaks_total",
                                           "jit_compiles_after_warmup")},
        "passes": [plain, journaled, {"mode": "durability-recover", **{
            k: stats[k] for k in ("kernel_launches", "ring_hop_launches", "ring_hop_bytes",
                                  "gumbel_sample_launches", "decode_attn_launches",
                                  "decode_attn_window_launches")}}],
    })
    log(f"durability: 4 streams SIGKILLed after {[len(ev) for ev in before]} deltas, recovered "
        f"at 4 lanes and reattached at their Last-Event-ID: byte-identical to the reference, 0 "
        f"lost, 0 repeated; the completed request not resurrected; restart to healthy "
        f"{healthy_s:.1f}s, to the first reattached byte {first_byte_s:.1f}s; 0 leaks, 0 "
        "graph captures after warmup, drain exit 0")
    return out


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
                        ("ring_seg_kernel", "ring_hop"), ("ring_step2_kernel", "ring_hop"),
                        ("gumbel_sample_kernel", "gumbel_sample"),
                        ("decode_attn_kernel", "decode_attn")):
        if tag in name:
            return kernel
    return None


def sync_all(torch) -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _measure_steps(torch, q, rc, cs, step, steps: int, label: str) -> dict:
    """Host clock per synchronous step, the launch counters over those
    steps, and device time, launches and operations by kernel from
    torch.profiler over as many more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from distributed_llama_multiusers_tpu_torch.ops import cuda_attn as ca

    for _ in range(3):
        step()
    sync_all(torch)
    wall = []
    before = dict(q.LAUNCHES)
    ring_before = rc.ring_counts()
    sample_before = cs.COUNTS["launches"]
    attn_before = ca.COUNTS["launches"]
    window_before = ca.COUNTS["window_launches"]
    for _ in range(steps):
        t0 = time.perf_counter()
        step()  # decode reads the tokens back: each step ends synchronized
        wall.append((time.perf_counter() - t0) * 1e3)
    launches = {k: (q.LAUNCHES[k] - before[k]) / steps for k in q.KERNELS}
    launches["gumbel_sample"] = (cs.COUNTS["launches"] - sample_before) / steps
    launches["decode_attn"] = (ca.COUNTS["launches"] - attn_before) / steps
    launches["decode_attn_window"] = (ca.COUNTS["window_launches"] - window_before) / steps
    ring = {k: (v - ring_before[k]) / steps for k, v in rc.ring_counts().items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync_all(torch)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name: dict = {}
    host: dict = {}
    kernels: dict = {}  # kernel -> [device us per step, launches per step]
    device_ops = 0  # kernels, copies and fills the device ran
    fills = [0.0, 0.0]  # memsets and fill kernels (zeroed scratch): device us, count per step
    for e in prof.key_averages():
        # kernels only: an aten op's own device time repeats its kernels'
        us = getattr(e, "self_device_time_total", 0.0) or 0.0
        if e.device_type != DeviceType.CPU:
            device_ops += e.count
        if us > 0 and e.device_type != DeviceType.CPU:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / steps
            if "memset" in e.key.lower() or "FillFunctor" in e.key:
                fills[0] += us / steps
                fills[1] += e.count / steps
            kernel = _kernel_of(e.key)
            if kernel:
                acc = kernels.setdefault(kernel, [0.0, 0.0])
                acc[0] += us / steps
                acc[1] += e.count / steps
        if e.self_cpu_time_total > 0:
            host[e.key] = (e.self_cpu_time_total / steps, e.count // steps)
    device_ms = sum(by_name.values()) / 1e3
    q40_ms = sum(v[0] for k, v in kernels.items()
                 if k not in ("ring_hop", "gumbel_sample", "decode_attn")) / 1e3
    hop_ms = kernels.get("ring_hop", [0.0, 0.0])[0] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = {"step_ms_p50": statistics.median(wall), "step_ms": wall,
           "profiled_step_ms": prof_wall_ms, "device_ms_per_step": device_ms,
           # device time over the unprofiled step: the profiler slows the
           # host side, not the kernels
           "device_busy_share": device_ms / statistics.median(wall),
           "q40_kernels_ms_per_step": q40_ms,
           "ring_hop_ms_per_step": hop_ms,
           "gumbel_sample_ms_per_step": kernels.get("gumbel_sample", [0.0, 0.0])[0] / 1e3,
           "decode_attn_ms_per_step": kernels.get("decode_attn", [0.0, 0.0])[0] / 1e3,
           "launches_per_step": launches,
           "device_ops_per_step": device_ops / steps,
           "fill_ms_per_step": fills[0] / 1e3, "fills_per_step": fills[1],
           "ring_hop_launches_per_step": ring["ring_hop_launches"],
           "ring_hop_bytes_per_step": ring["ring_hop_bytes"],
           "q40_profiled_us_launches_per_step": kernels,
           "top_device_us_per_step": [[k[:90], v] for k, v in top],
           "top_host_us_calls_per_step": [
               [k[:60], us, n] for k, (us, n) in
               sorted(host.items(), key=lambda kv: -kv[1][0])[:12]]}
    log(f"decode step [{label}]: p50 {out['step_ms_p50']:.2f} ms host clock, "
        f"device busy {device_ms:.2f} ms ({out['device_busy_share']:.3f} of the step), "
        f"Q40 kernels {q40_ms:.3f} ms, ring_hop {hop_ms:.3f} ms, launches per step "
        f"{launches}, ring_hop {ring['ring_hop_launches']}, device ops "
        f"{device_ops / steps}, profiled {kernels}")
    return out


def _kv_state(engine) -> list:
    caches = [engine.cache] if engine.mesh is None else engine.cache
    return [t for c in caches for t in (c.k, c.v)]


def multi_replay_check(torch, q, rc, cs, engine, tokens, positions, temps, seeds, busy: int,
                       label: str, h: int = MULTI_H) -> dict:
    """An h-step ``decode_multi`` (the synchronous loop's chained steps)
    replayed from its CUDA graph against the eager bodies from the same
    cache: chosen tokens and the whole KV cache bit for bit, launch counts
    equal. The first call runs eagerly and captures; the second replays;
    then the cache is put back and the same call runs eagerly."""
    from distributed_llama_multiusers_tpu_torch.ops import cuda_attn as ca

    def counts():
        return {**q.LAUNCHES, **rc.ring_counts(), "gumbel_sample": cs.COUNTS["launches"],
                "decode_attn": ca.COUNTS["launches"]}

    def call():
        sync_all(torch)
        before = counts()
        chosen = engine.decode_multi(tokens, positions, temps, seeds=seeds, h=h)
        sync_all(torch)
        after = counts()
        return chosen, {k: after[k] - before[k] for k in after}

    first, _ = call()  # captures the key's graph
    tokens[:busy] = first[-1, :busy]
    positions[:busy] += h
    saved = [t.clone() for t in _kv_state(engine)]
    replays = engine.graphs.replays
    got, got_counts = call()
    check(engine.graphs.replays == replays + 1, f"decode_multi [{label}]: did not replay")
    got_kv = [t.clone() for t in _kv_state(engine)]
    for t, s_ in zip(_kv_state(engine), saved):
        t.copy_(s_)
    graphs, engine.graphs = engine.graphs, None
    try:
        want, want_counts = call()
    finally:
        engine.graphs = graphs
    kv_equal = all(torch.equal(a, b) for a, b in zip(got_kv, _kv_state(engine)))
    check(bool((got == want).all()), f"decode_multi [{label}]: replayed tokens differ from "
                                      f"the eager bodies'")
    check(kv_equal, f"decode_multi [{label}]: replayed KV cache differs from the eager one")
    check(got_counts == want_counts, f"decode_multi [{label}]: replayed counts {got_counts} "
                                     f"against eager {want_counts}")
    per_step = sum(v for k, v in got_counts.items() if k in q.KERNELS) / h
    log(f"decode_multi [{label}]: h={h} replay equals the eager bodies (tokens, KV, counts; "
        f"{per_step} Q40 launches per step, {got_counts['gumbel_sample']} gumbel_sample)")
    del saved, got_kv
    return {"h": h, "tokens_equal": True, "kv_equal": kv_equal, "counts": got_counts}


def verify_step(torch, q, rc, cs, engine, config, tokens, positions, temps, seeds,
                busy: int, steps: int, label: str, n_products: int) -> dict:
    """The speculative verify step beside the decode step: first its rows
    against decode steps, bit for bit (the verify forward of each lane's
    token and 3 candidates at positions pos .. pos + 3, then one-row
    forwards at each of those positions on the cache it wrote: every
    generating lane's logits must be the same bits, which is what keeps a
    stream the same with speculation on and off), as a batch of every lane
    and of the first 1, 2 and 4 lanes alone (``--max-lanes`` below 8: the
    products at m = lanes and 4 x lanes); then ``decode_spec``
    replayed from its graph, measured as ``_measure_steps`` measures the
    decode step (the greedy lanes' candidates repeat their token: how many
    are accepted does not change the step's work). A step launches each
    Q40 product once at m = 4 x lanes and one window attention a layer."""
    import numpy as np

    from distributed_llama_multiusers_tpu_torch.models.llama import KVCache, llama_forward

    k1 = engine.SPEC_DRAFT + 1
    dev = engine.device
    full = (torch.as_tensor(tokens, device=dev)[:, None]
            + 7919 * torch.arange(k1, device=dev)[None]) % config.vocab_size
    pos2d = torch.as_tensor(positions, device=dev)[:, None] + torch.arange(k1, device=dev)
    equal = {}
    with torch.inference_mode():
        for n in (*FEW_LANES, len(tokens)):
            cache = KVCache(k=engine.cache.k[:, :n], v=engine.cache.v[:, :n])  # a view
            window, _ = llama_forward(config, engine.params, full[:n], pos2d[:n], cache,
                                      **engine._forward_flags)
            live = min(n, busy)
            equal[n] = []
            for t in range(k1):
                one, _ = llama_forward(config, engine.params, full[:n, t:t + 1],
                                       pos2d[:n, t:t + 1], cache, **engine._forward_flags)
                equal[n].append(bool(torch.equal(window[:live, t], one[:live, 0])))
    check(all(all(e) for e in equal.values()),
          f"verify step [{label}]: rows {equal} (by lanes) of the verify forward against "
          "one-row forwards at their positions")
    drafts = np.zeros((len(tokens), engine.SPEC_DRAFT), np.int64)
    dlen = np.zeros(len(tokens), np.int64)
    dlen[:busy] = np.where(temps[:busy] == 0, engine.SPEC_DRAFT, 0)
    lanes = np.arange(busy)

    def step():
        drafts[:] = tokens[:, None]
        _, emitted, n_emit = engine.decode_spec(tokens, drafts, dlen, positions, temps,
                                                seeds=seeds, want_logits=False)
        tokens[:busy] = emitted[lanes, n_emit[:busy] - 1]
        positions[:busy] += n_emit[:busy]

    out = _measure_steps(torch, q, rc, cs, step, steps, f"{label}, verify graph")
    per_step = out["launches_per_step"]
    n_layers = config.n_layers * len(engine.devices)
    check(sum(v for k_, v in per_step.items() if k_ in q.KERNELS) == n_products
          and per_step["decode_attn"] == per_step["decode_attn_window"] == n_layers
          and per_step["gumbel_sample"] == 1,
          f"verify step [{label}]: launches per step {per_step}")
    out["rows_bit_equal_to_decode_steps"] = equal
    return out


def step_breakdown(torch, q, rc, cs, config, params, mode: str, lanes: int = 8,
                   busy: int = 4, steps: int = 10, mesh=None, q80: bool = False,
                   label: str | None = None) -> dict:
    """Where a serving decode step's time goes: the engine in this process
    on the full-width model, ``busy`` of ``lanes`` lanes decoding (the
    smoke's 4 concurrent requests on the server's 8 lanes, half of them
    sampling); with ``mesh``, tensor parallel over its ranks (``q80``: the
    Q80 wire, as ``--buffer-float-type q80`` serves it). The step graphs
    are captured first (greedy and sampled, timed); then the step is
    measured replayed from its graph (``engine.decode``, the serving path)
    and run eagerly (the same bodies, the engine's graphs set aside), each
    as ``_measure_steps`` does; the graph's launch counts per step must
    equal the eager step's. On one device then ``verify_step`` (the verify
    step's rows against decode steps, and its time). Last,
    ``multi_replay_check``."""
    from distributed_llama_multiusers_tpu_torch.parallel.collectives import q80_sync_engages
    from distributed_llama_multiusers_tpu_torch.parallel.sharding import shard_params
    from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine

    import numpy as np

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
        t0 = time.perf_counter()
        engine.capture_graphs()
        sync_all(torch)
        capture = {"graphs": len(engine.graphs), "capture_s": time.perf_counter() - t0,
                   "capture_s_in_graphs": engine.graphs.capture_s}

        def step():
            _, greedy, sampled = engine.decode(tokens, positions, temps, seeds=seeds,
                                               want_logits=False)
            tokens[:busy] = np.where(temps[:busy] > 0, sampled[:busy], greedy[:busy])
            positions[:busy] += 1

        graph = _measure_steps(torch, q, rc, cs, step, steps, f"{label}, graph")
        graphs, engine.graphs = engine.graphs, None  # the eager bodies the graph captured
        try:
            eager = _measure_steps(torch, q, rc, cs, step, steps, f"{label}, eager")
        finally:
            engine.graphs = graphs
        # per rank and layer: wq, wk, wv, w1, w3 and n column chunks each of
        # wo and w2; then wcls (n = 1: the 7 products of one device)
        n, n_layers = len(engine.devices), config.n_layers
        n_products = n * (n_layers * (5 + 2 * n) + 1)
        for run, name in ((graph, "graph"), (eager, "eager")):
            got = sum(v for k, v in run["launches_per_step"].items() if k in q.KERNELS)
            check(got == n_products, f"decode step [{label}, {name}]: "
                  f"{run['launches_per_step']} Q40 launches per step, expected "
                  f"{n_products} products")
            check(run["launches_per_step"]["gumbel_sample"] == 1,
                  f"decode step [{label}, {name}]: sampler launches "
                  f"{run['launches_per_step']['gumbel_sample']} per step")
            check(run["launches_per_step"]["decode_attn"] == n * n_layers,
                  f"decode step [{label}, {name}]: attention launches "
                  f"{run['launches_per_step']['decode_attn']} per step, expected "
                  f"{n * n_layers}")
        check(graph["launches_per_step"] == eager["launches_per_step"]
              and graph["ring_hop_launches_per_step"] == eager["ring_hop_launches_per_step"]
              and graph["ring_hop_bytes_per_step"] == eager["ring_hop_bytes_per_step"],
              f"decode step [{label}]: replayed counts {graph['launches_per_step']} "
              f"(ring {graph['ring_hop_launches_per_step']}) against eager "
              f"{eager['launches_per_step']} (ring {eager['ring_hop_launches_per_step']})")
        check(graph["ring_hop_bytes_per_step"] == engine.stats.sync_bytes_per_decode,
              f"decode step [{label}]: hop bytes {graph['ring_hop_bytes_per_step']} against "
              f"sync_bytes_per_decode {engine.stats.sync_bytes_per_decode}")
        # one device's verify step (the tp2 passes serve it too; their step
        # breakdown stays the decode step's)
        verify = None if mesh is not None else verify_step(
            torch, q, rc, cs, engine, config, tokens, positions, temps, seeds, busy, steps,
            label, n_products)
        multi = multi_replay_check(torch, q, rc, cs, engine, tokens, positions, temps, seeds,
                                   busy, label)
        log(f"decode graphs [{label}]: {capture['graphs']} captured in "
            f"{capture['capture_s']:.2f}s; step p50 graph {graph['step_ms_p50']:.2f} ms, "
            f"eager {eager['step_ms_p50']:.2f} ms"
            + ("" if verify is None else
               f"; verify step p50 graph {verify['step_ms_p50']:.2f} ms, device "
               f"{verify['device_ms_per_step']:.2f} ms against the decode step's "
               f"{graph['device_ms_per_step']:.2f} ms"))
        out = {"mode": label, "dequant": mode, "ranks": [str(d) for d in engine.devices],
               "q80_wire": q80_wire, "lanes": lanes, "busy_lanes": busy,
               **graph, "eager": eager, "graphs": capture, "multi_replay": multi,
               "verify": verify,
               "sync_bytes_per_decode": engine.stats.sync_bytes_per_decode,
               "prefill_logits": prefill_logits}
        del engine, graphs
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


def tp_step_hops(torch, rc, config, devices, lanes: int = DECODE_M) -> list:
    """The ring steps of one tensor-parallel decode step on the f32 wire,
    recorded from the collectives themselves at the model's widths: one
    wo/w2 ``ring_sync_matmul`` of bf16 partials (n-1 reduce steps, the last
    into the gather slots, then n-1 gather steps), repeated for the 2 syncs
    of every layer, then the gather of the [lanes, 1, vocab/n] f32 logits
    shards (its first step also places each rank's own shard)."""
    from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
    from distributed_llama_multiusers_tpu_torch.parallel.sharding import col_shards

    n = len(devices)
    mesh = make_mesh(MeshPlan(tp=n), devices)
    w = torch.randn((config.dim, config.dim), device=devices[0]).to(torch.bfloat16) * 0.02
    xs = [torch.randn((lanes, 1, config.dim // n), device=d).to(torch.bfloat16)
          for d in devices]
    logits = [torch.randn((lanes, 1, config.vocab_size // n), device=d) for d in devices]
    real = rc.ring_step
    sync, gather = [], []
    try:
        rc.ring_step = lambda recv: (sync.append(recv), real(recv))[1]
        rc.ring_sync_matmul(xs, col_shards(w, mesh))
        rc.ring_step = lambda recv: (gather.append(recv), real(recv))[1]
        rc.ring_all_gather(logits)
    finally:
        rc.ring_step = real
    return sync * (2 * config.n_layers) + gather


def decode_phase(torch, q, rc, cs, model: str):
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
    breakdown = [step_breakdown(torch, q, rc, cs, config, params, mode)
                 for mode in dict.fromkeys(DECODE_MODE_OF.values())]
    devices = rank_devices(torch, 2)
    mesh = make_mesh(MeshPlan(tp=2), devices)
    tp = [step_breakdown(torch, q, rc, cs, config, params, "v4", mesh=mesh,
                         label="tp2 v4, f32 wire"),
          step_breakdown(torch, q, rc, cs, config, params, "auto", mesh=mesh, q80=True,
                         label="tp2 auto, Q80 wire")]
    # one ring_hop launch per receiving rank per ring step: per layer two
    # syncs of n-1 reduce and n-1 gather steps, then n-1 logits steps; the
    # Q80 wire's values and scales share their step's launch. The counter
    # is exact; the profiler may miss an event now and then
    want = 2 * (2 - 1) * (4 * config.n_layers + 1)
    for b in tp:
        profiled = b["eager"]["q40_profiled_us_launches_per_step"].get("ring_hop", [0, 0])[1]
        check(b["ring_hop_launches_per_step"] == want and abs(profiled - want) < 1,
              f"{b['mode']}: {b['ring_hop_launches_per_step']} ring_hop launches per step "
              f"(profiled {profiled}), reckoned {want}")
    ref, got = breakdown[0]["prefill_logits"], tp[0]["prefill_logits"]
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    check(bool(torch.isfinite(got).all()) and err <= TP_LOGITS_TOL * scale,
          f"tp2 prefill logits: max|tp - single| {err:.4e} against max|single| {scale:.4e}")
    tp_logits = {"max_abs_err": err, "max_abs_ref": scale, "tol": TP_LOGITS_TOL,
                 "argmax_equal": int(got.argmax()) == int(ref.argmax())}
    log("tp2 prefill logits against one device: " + json.dumps(tp_logits))
    hop_step = time_steps(torch, rc, tp_step_hops(torch, rc, config, devices))
    check(hop_step["launches"] == tp[0]["ring_hop_launches_per_step"]
          and hop_step["bytes"] == tp[0]["sync_bytes_per_decode"],
          f"the timed ring steps ({hop_step['launches']}, {hop_step['bytes']} B) are not the "
          f"decode step's ({tp[0]['ring_hop_launches_per_step']}, "
          f"{tp[0]['sync_bytes_per_decode']} B)")
    log("ring steps of one tp2 decode step: " + json.dumps(hop_step))
    products = step_matmuls(torch, q, params)
    prefix_bits = prefix_bits_phase(torch, config, params)
    for b in breakdown + tp:
        del b["prefill_logits"]
    del params
    torch.cuda.empty_cache()
    return breakdown, tp, tp_logits, hop_step, products, prefix_bits


def prefix_bits_phase(torch, config, params, run: int = SPEC_RUN, tail: int = 18) -> dict:
    """A prefix-cache hit's bits against a cold prefill's on the card.
    Prompts A and B share ``run`` tokens; lane 0 prefills A, lane 1 copies
    its first ``shared`` slots and prefills the rest of B, against a cold
    prefill of B on lane 1 of a second engine. Two cases: ``shared`` =
    ``run`` (the whole common prefix: the tail is one chunk of ``tail``
    tokens where the cold prefill ran 1,024 and the rest, so its products
    take other k-split plans; information), and ``shared`` = 1,024 (whole
    chunks, the scheduler's rule: the tail runs the cold prefill's chunks,
    so the boundary logits and the tail's KV must equal the cold ones bit
    for bit). In both the copied slots must equal the cold ones."""
    from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine

    gen = torch.Generator().manual_seed(5)
    common = torch.randint(0, config.vocab_size, (run,), generator=gen).tolist()
    a = common + torch.randint(0, config.vocab_size, (tail,), generator=gen).tolist()
    b = common + torch.randint(0, config.vocab_size, (tail,), generator=gen).tolist()
    cold = InferenceEngine(config, params, n_lanes=2, device="cuda")
    c_logits, c_greedy, _ = cold.prefill(1, b)
    top2 = torch.topk(c_logits.float(), 2).values
    out = {"common_tokens": run, "tail_tokens": tail, "cold_top2_gap": float(top2[0] - top2[1]),
           "logits_max_abs": float(c_logits.float().abs().max())}
    n = len(b)
    for label, shared in (("whole_prefix", run), ("whole_chunks", cold.max_chunk())):
        warm = InferenceEngine(config, params, n_lanes=2, device="cuda")
        warm.prefill(0, a)
        warm.copy_lane(0, 1, prefix_len=shared)
        w_logits, w_greedy, _ = warm.prefill(1, b[shared:], start_pos=shared)
        sync_all(torch)
        kv = [(getattr(warm.cache, p)[:, 1, :n].float(), getattr(cold.cache, p)[:, 1, :n].float())
              for p in ("k", "v")]
        case = {
            "copied_kv_bit_equal": all(bool(torch.equal(w[:, :shared], c[:, :shared]))
                                       for w, c in kv),
            "tail_kv_bit_equal": all(bool(torch.equal(w[:, shared:], c[:, shared:]))
                                     for w, c in kv),
            "tail_kv_max_abs_diff": max(float((w[:, shared:] - c[:, shared:]).abs().max())
                                        for w, c in kv),
            "logits_bit_equal": bool(torch.equal(w_logits, c_logits)),
            "logits_max_abs_diff": float((w_logits.float() - c_logits.float()).abs().max()),
            "greedy_equal": int(w_greedy) == int(c_greedy)}
        out[label] = case
        check(case["copied_kv_bit_equal"], f"prefix bits [{label}]: the copied KV slots "
                                           "differ from a cold prefill's")
        del warm
    check(out["whole_chunks"]["logits_bit_equal"] and out["whole_chunks"]["tail_kv_bit_equal"],
          f"prefix bits: a whole-chunk hit is not a cold prefill's bits: {out['whole_chunks']}")
    log("prefix bits (v4; a hit against a cold prefill): " + json.dumps(out))
    del cold
    torch.cuda.empty_cache()
    return out


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


def kernels_line(q, rc, cs, checks, passes, breakdown, tp, hops, hop_step, products,
                 geometry, sampler, lab=None, lab_result=None, timings=(),
                 forms=(), attn=None, row_plans=()) -> dict:
    """One entry per kernel. ``launches`` is the main path's count: the
    serving passes, the CLI runs and the durability servers, each counting
    from the end of its warmup. For a Q40
    kernel the times and the bound cover one decode step's products at the
    server's 8 lanes (``step_matmuls``); ``launches_per_decode_step`` and
    the profiled fields come from the engine's decode steps in the mode that
    runs the kernel (``step_breakdown``). For the ring hop they cover the
    hops of one tp=2 decode step on the f32 wire (``time_hops``) and the
    engine's TP decode steps. The slab's and blockdot's entries carry their
    ring stages, shared memory, registers and spills per m-tile and the plan
    at each 1B site; blockdot's also its HMMA count in the SASS,
    i8blockdot's its IMMA count and its per-site times at m = 1, 8 and 32.
    The ring hop's entry carries each segment form's time per hop beside
    its library call and the launches per tp=2 step on both wires."""
    out = []
    for kernel, mode in DECODE_MODE_OF.items():
        mine = [c for c in checks if c["kernel"] == kernel and c["io"] == "f32"
                and not c.get("extreme")]
        extreme = [c for c in checks if c["kernel"] == kernel and c.get("extreme")]
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
            "checks": len(mine) + len(mine16) + len(extreme),
            **({"max_rel_err_extreme_scales": max(c["max_abs_err"] / c["max_abs_ref"]
                                                  for c in extreme)} if extreme else {}),
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
            "verify_shaped_rows": {r["site"]: {k_: v_ for k_, v_ in r.items() if k_.startswith(
                ("rows_equal_", "splits_", "ms_m"))} for r in row_plans if r["kernel"] == kernel},
            **({k: v for k, v in geometry[kernel].items() if k != "sms"}
               if kernel in geometry else {}),
            **({"site_ms_by_m": {str(m): {t["site"]: {k: t[k] for k in (
                "ms", "library_ms", "bound_ms")} for t in timings
                if t["kernel"] == kernel and t["m"] == m} for m in I8_TIMED_M},
                "edge_checks": sum(1 for c in checks if c["kernel"] == kernel
                                   and c["d_in"] in BLOCKDOT_EDGE_D_IN
                                   and c["d_out"] in BLOCKDOT_EDGE_D_OUT)}
               if kernel == "q40_i8blockdot" else {}),
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
        "timed_as": f"the {hop_step['launches']} ring-step launches ({hop_step['bytes']} "
                    "wire bytes) of one tp=2 decode step at 8 lanes on the f32 wire, recorded "
                    "from the collectives: kernel, and each segment's library call "
                    f"({hop_step['library_calls']} copy_ / torch.add(out=) calls), in one CUDA "
                    "graph each where the ranks share a card, back to back (a best case: each "
                    "dependent launch overlaps the step before it; on the decode path see "
                    "profiled_ms_per_decode_step); plain eager",
        "launches_per_decode_step": f32_step["ring_hop_launches_per_step"],
        "launches_per_decode_step_by_mode": {b["mode"]: b["ring_hop_launches_per_step"]
                                             for b in tp},
        "sync_bytes_per_decode_by_mode": {b["mode"]: b["sync_bytes_per_decode"] for b in tp},
        "profiled_ms_per_decode_step": f32_step["ring_hop_ms_per_step"],
        "device_ops_per_tp2_decode_step_by_mode": {b["mode"]: b["device_ops_per_step"]
                                                   for b in tp},
        "payloads": hops,
        "forms": list(forms),
    })
    out.append({
        "name": cs.KERNEL, "route": "cuda", "source": cs.KERNEL_SOURCE,
        "replaces": cs.KERNEL_REPLACES,
        "replaces_note": "counterpart of XLA's jax.random.categorical inside _sample_lane; "
                         "no Pallas site",
        "launches": sum(p_["gumbel_sample_launches"] for p_ in passes),
        "launches_by_mode": {p_["mode"]: p_["gumbel_sample_launches"] for p_ in passes},
        "max_abs_err": sampler["max_abs_err"], "tol": 0.0,
        "tol_rule": "choices equal to the plain version's; noise within "
                    f"{GUMBEL_ATOL:.3e} of it ({sampler['noise_max_abs_err']:.3e})",
        "ms": sampler["ms"], "plain_ms": sampler["plain_ms"],
        "library_ms": sampler["library_ms"], "bound_ms": sampler["bound_ms"],
        "bound_by": sampler["bound_by"],
        "timed_as": f"one sampled step's draw, {sampler['lanes']} lanes x {sampler['vocab']} "
                    f"sorted log-probabilities ({sampler['kept_entries']} in the nuclei): "
                    "kernel and the library composition (torch.rand, -log(-log u), add, "
                    "argmax) in one CUDA graph each; plain eager",
        "launches_per_decode_step": {b["mode"]: b["launches_per_step"]["gumbel_sample"]
                                     for b in breakdown + tp},
        "profiled_ms_per_decode_step": {b["mode"]: b["gumbel_sample_ms_per_step"]
                                        for b in breakdown + tp},
    })
    from distributed_llama_multiusers_tpu_torch.ops import cuda_attn as ca

    if attn is not None:
        out.append({
            "name": ca.KERNEL, "route": "cuda", "source": ca.KERNEL_SOURCE,
            "replaces": ca.KERNEL_REPLACES,
            "replaces_note": "counterpart of XLA's masked softmax attention (_dense_attention) "
                             "inside the decode step; no Pallas site",
            "launches": sum(p_["decode_attn_launches"] for p_ in passes),
            "launches_by_mode": {p_["mode"]: p_["decode_attn_launches"] for p_ in passes},
            "max_abs_err": attn["max_abs_err"], "tol": ATTN_TOL,
            "tol_rule": f"max|d| <= {ATTN_TOL:.0e} * max|plain| ({attn['max_abs_ref']:.3e})",
            "ms": attn["ms"], "plain_ms": attn["plain_ms"], "library_ms": attn["library_ms"],
            "library": "torch.nn.functional.scaled_dot_product_attention (f32, boolean mask)",
            "bound_ms": attn["bound_ms"], "bound_by": attn["bound_by"],
            "timed_as": f"one layer of a decode step: {attn['lanes']} lanes at positions "
                        f"{attn['positions']} ({attn['slots_read']} slots attended), "
                        f"{attn['n_kv']} kv heads x {attn['group']}, head size "
                        f"{attn['head_size']}, bf16 cache of {attn['s_len']} slots: kernel and "
                        "library call in one CUDA graph each; plain eager",
            "launches_per_decode_step": {b["mode"]: b["launches_per_step"]["decode_attn"]
                                         for b in breakdown + tp},
            "profiled_ms_per_decode_step": {b["mode"]: b["decode_attn_ms_per_step"]
                                            for b in breakdown + tp},
        })
    if attn is not None:
        w = attn["window"]
        out.append({
            "name": "decode_attn (verify window)", "route": "cuda", "source": ca.KERNEL_SOURCE,
            "replaces": ca.KERNEL_REPLACES,
            "replaces_note": "counterpart of XLA's _dense_attention inside the speculative "
                             "verify forward (T = SPEC_DRAFT + 1 rows a lane); no Pallas site",
            "launches": sum(p_["decode_attn_window_launches"] for p_ in passes),
            "launches_by_mode": {p_["mode"]: p_["decode_attn_window_launches"]
                                 for p_ in passes},
            "max_abs_err": w["max_abs_err"], "tol": ATTN_TOL,
            "tol_rule": f"max|d| <= {ATTN_TOL:.0e} * max|plain| ({w['max_abs_ref']:.3e}); "
                        f"each row bit-equal to a T = 1 call at its position "
                        f"({w['rows_bit_equal_to_one_row_calls']} rows)",
            "ms": w["ms"], "plain_ms": w["plain_ms"], "library_ms": w["library_ms"],
            "library": "torch.nn.functional.scaled_dot_product_attention (f32, boolean mask "
                       "per row)",
            "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
            "ms_as_one_row_calls": w["ms_as_one_row_calls"],
            "timed_as": f"one layer of a verify step: {w['lanes']} lanes x {w['rows']} rows "
                        f"from {w['first_positions']} (the bound: {w['slots_read']} slots "
                        "read once for all rows), the cache and heads of the decode_attn "
                        "entry: kernel (one launch, a row a lane), the rows as four T = 1 "
                        "calls, and the library call in one CUDA graph each; plain eager",
            "launches_per_verify_step": {b["mode"]: b["verify"]["launches_per_step"][
                "decode_attn_window"] for b in breakdown if b.get("verify")},
            "profiled_ms_per_verify_step": {b["mode"]: b["verify"]["decode_attn_ms_per_step"]
                                            for b in breakdown if b.get("verify")},
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
        from distributed_llama_multiusers_tpu_torch.ops import cuda_attn as ca
        from distributed_llama_multiusers_tpu_torch.ops import cuda_sample as cs
        from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc

        t0 = time.perf_counter()
        names = q.KERNELS + (rc.KERNEL, cs.KERNEL, ca.KERNEL) + lab.KERNELS
        one_kernel_build = build_one_kernel(q, rc)
        try:
            libs = q.build_kernels(names)
        finally:
            one_kernel = one_kernel_launch(rc, one_kernel_build)
        log(f"kernel build: {time.perf_counter() - t0:.1f}s ({', '.join(names)})")
        geometry = {"q40_slab": kernel_geometry(torch, q, q.slab_info),
                    "q40_blockdot": kernel_geometry(torch, q, q.blockdot_info),
                    "q40_i8blockdot": kernel_geometry(torch, q, q.i8blockdot_info)}
        for kernel, geo in geometry.items():
            log(f"{kernel} geometry: " + json.dumps(geo))
        for kernel, opcode in (("q40_blockdot", "HMMA"), ("q40_i8blockdot", "IMMA")):
            check(all(n == 0 for n in geometry[kernel]["spill_bytes_per_thread"].values()),
                  f"{kernel} spills registers")
            check(geometry[kernel]["stages"] == 3, f"{kernel}: {geometry[kernel]['stages']} "
                                                   "ring stages, expected 3")
            tag = kernel.removeprefix("q40_") + "_kernel"
            geometry[kernel][f"{opcode.lower()}_in_sass"] = sass_hmma(libs[kernel], tag, opcode)
            log(f"{kernel} {opcode} in SASS: "
                + json.dumps(geometry[kernel][f"{opcode.lower()}_in_sass"]))

        checks, timings = kernel_phase(torch, q)
        row_plans = row_plan_phase(torch, q)
        hops = hop_phase(torch, rc)
        forms = hop_forms(torch, q, rc, one_kernel)
        collectives = collectives_phase(torch, q, rc)
        sampler = sampler_phase(torch, cs)
        attn = attn_phase(torch)
        with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as f:
            json.dump({"card": card, "checks": checks, "timings": timings, "hops": hops,
                       "hop_forms": forms, "collectives": collectives, "geometry": geometry,
                       "sampler": sampler, "attn": attn, "verify_shaped_products": row_plans},
                      f, indent=1)

        passes = serving_phase(torch, q)
        model, tok = ensure_model(llama32_1b_header(), seed=0)
        layers = serving_layers_phase(model, tok, passes[0])
        cli = cli_phase(torch, model, tok, passes)
        durability = durability_phase(model, tok)
        breakdown, tp, tp_logits, hop_step, products, prefix_bits = decode_phase(
            torch, q, rc, cs, model)
        log(f"default v4 pass: batch {passes[0]['tokens_per_s_batch']:.1f} tok/s, graph step "
            f"p50 {breakdown[0]['step_ms_p50']:.2f} ms (before the serving layers, NVIDIA H100 "
            "80GB HBM3 at 700 W: 349.1 tok/s, 4.76 ms)")
        with open(os.path.join(OUT_DIR, "chip_smoke_serving.json"), "w") as f:
            json.dump({"card": card,
                       "passes": [{k: v for k, v in p.items() if k != "log"} for p in passes],
                       "serving_layers": layers, "cli": cli,
                       "durability": {k: v for k, v in durability.items() if k != "passes"},
                       "prefix_bits": prefix_bits,
                       "decode_step": breakdown, "tp_decode_step": tp,
                       "tp_prefill_logits": tp_logits, "tp_decode_step_hops": hop_step,
                       "decode_step_products": products}, f, indent=1)
        lab_result = lab_phase(torch, q, lab)
        with open(os.path.join(OUT_DIR, "chip_smoke_lab.json"), "w") as f:
            json.dump({"card": card, **lab_result}, f, indent=1)
        main_path = passes + cli + durability["passes"]
        line = kernels_line(q, rc, cs, checks, main_path, breakdown, tp, hops, hop_step,
                            products, geometry, sampler, lab, lab_result, timings, forms, attn,
                            row_plans)
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
