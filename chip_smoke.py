#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card and the
CUDA toolkit (``nvcc``). Phases, each of which fails the run:

1. Setup: print the card's name and power limit (``nvidia-smi``), start
   writing the two synthetic models (phases 3 and 4d) in a process each,
   build the Q40 kernels, the ring step, the sampler, the decode
   attention, the grammar kernels, the MoE router and the lab's kernels
   from ``distributed_llama_multiusers_tpu_torch/
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
   Its e4m3 instantiation (``--kv-dtype f8``) on the same shapes, the
   cache written through ``_to_cache_dtype`` from random K/V with values
   past +-448: T = 1, the 4-row window and 64-slot pages permuted at
   random against their plain versions (the cache widened to f32) within
   ATTN_TOL, bit for bit against the bf16 instantiation on the cache
   widened to bf16, a lane's bits against another batch around it, each
   window row against a one-row call, paged against contiguous; each form
   timed beside the bf16 instantiation, its plain version and
   ``scaled_dot_product_attention`` on the cache widened to f32, with its
   byte bound (the e4m3 slots, half of bf16's).
   Its partial-stats form (a sequence-parallel rank's block) at a tp2 x
   sp2 rank's 1B shapes: each sp rank's serving positions shifted by its
   block's start and rows at s0 - 1, s0, s0 + 1 against ``block_stats``
   (o, l, m within ATTN_TOL; a row with no slot exactly (0, 0, -inf); o
   bit-equal to the kernel without stats), timed beside its plain version
   and ``scaled_dot_product_attention`` over the same block.
3. Serving: wait for the full-width Llama-3.2-1B-shaped synthetic Q40
   model (16 layers, seed 0; written into ``build/synthetic`` since the
   setup and reused while header and seed match), start ``python -m distributed_llama_multiusers_tpu_torch.app.
   dllama_api`` once per dequant mode (default v4, ``auto``, ``blockdot``)
   under the serving defaults (pipelined decode of depth 2, fused
   admissions, speculation inside the chain; the pipelined and verify steps
   replayed from CUDA graphs captured at warmup), once more in v4 with
   ``--pipeline-depth 0 --multi-step 0`` (the synchronous loop and verify
   step), once in v4 with ``--no-spec``, and twice with ``--workers 2``
   (defaults; ``--buffer-float-type q80 --dequant auto``) on the host's
   cards (one card named twice where there is one), the seven servers
   started together and then driven one at a time, send 4 concurrent
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
   ``--journal-path`` (batch tok/s and TTFT; the two servers started
   together); 2 greedy and 2 seeded
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
   numbers before the serving layers. Then the dp and sp meshes' engines
   on one card, teacher-forced by the tp2 engine's greedy tokens over 4
   busy lanes of 8: dp2 x tp2's prefill and decode logits bit-equal to
   tp2's (bf16); tp2 x sp2 on the exact-f32 path (f32 activations, cache
   and Q40 dots) within 2e-5 of max|tp2| on the same path (its decode
   attention through the stats form).
4b. Paged KV (``--paged-kv on``): (a) the paged attention kernel at the
   decode step's shapes over 64-slot pages permuted at random, bit-equal to
   the contiguous kernel on the same slots (serving positions, split and
   page boundaries, the 4-row window) and within ATTN_TOL of its plain
   version, timed in turns beside the contiguous kernel; (b) a paged v4
   engine's prefill, decode steps (replayed from the graphs and eager) and
   verify steps against a contiguous engine's, logits bit-equal on every
   live lane, at one rank and at tp=2 on the host's cards, with both steps
   measured in turns (host clock, device time, device operations), and the
   swap tier's ms per page; an e4m3 engine's decode step (replayed from
   its graph, the e4m3 attention launched) against a bf16 engine's on the
   same prefilled lanes, logits within 0.5 + 0.1 x |bf16| (the JAX
   package's own f8 tolerance), its KV bytes a lane half of bf16's; (c) a
   ``dllama_api --paged-kv on`` default
   pass whose streams (alone and concurrent) equal the contiguous default
   pass's, with 0 graphs captured after warmup, and on it (d) a request on
   the 1,900-token run after a first one sharing 1,024 tokens from the
   prefix tree copy-free, its stream the cold one's; then a server with a
   40-page pool, 4 parked sessions and a 256 MiB host tier: (f) a parked
   session's pages swap to host under another's pressure and back on its
   readmission, byte-identical, the swap counters equal on /stats and
   /metrics; (e) a request the pool cannot hold beside a long one gets 429
   with Retry-After, and serving goes on. Then the f8 KV cache:
   ``dllama_api --kv-dtype f8`` under the defaults and with ``--paged-kv
   on`` (the two servers started together), each with the default
   pass's 4 requests: every stream alone
   equals the four concurrent byte for byte (greedy and seeded), the
   serving paths of the defaults, 0 graphs captured after warmup, every
   attention launch the e4m3 instantiation's, the KV bytes a token from the
   startup log (half of bf16's); nothing is compared with bf16 streams.
4c. Structured output: (a) the grammar kernels (``csrc/grammar.cu``; run
   after phase 2, while the models are written, on the 1B synthetic
   tokenizer written as the served model's) with
   five schemas compiled against the 1B synthetic tokenizer (their compile
   time, first and cached, printed), four in a default slab: the masked
   argmax at 8 and 32 x 128,256 rows on random states, 0 included, indices
   equal to its plain version's and masked rows bit-equal, FREE rows equal
   to ``torch.argmax``, and on rows off a 16-byte boundary (the scalar
   loads); at vocabularies of 1
   to 151,936 with ties, -inf, -0.0, all -inf and NaN rows, a one-token
   and an empty state; the automaton step on random (state, token) pairs,
   stepped and walked, and walked over edge tables of 1 to 65,537 keys
   (one to three search rounds), exact; each timed beside its plain
   version, its library calls (the torch pair where + argmax; searchsorted,
   the index and where) and its bound, beside the launch floor (a
   one-element op in the same CUDA-graph harness), with ``-Xptxas -v``'s registers and shared memory
   of both kernels (an ``nvcc`` beside the build); (b) the engine on
   the 1B model, 8 lanes, 4 constrained (json_object and a schema, greedy
   and seeded) and 4 free, through the step, multi-step, verify, pipelined
   and fused families: replays equal the eager bodies (tokens and launch
   counts), constrained tokens legal, the free lanes' tokens those of the
   same batch with no constrained lane; (c) ``dllama_api`` with its
   defaults: 4 constrained requests beside the default pass's 4, all at
   once, every constrained answer parsing and conforming, the plain texts
   the default pass's, the grammar fields on /stats, no flush and no graph
   captured after three schemas, 400 on a malformed schema; ``--workers
   2`` with a slab too small for two schemas: a 429 ``grammar_slab_full``
   with Retry-After beside a live one, whose answer at tp2 is its string;
   ``--grammar off``: 400 (the three servers started together); then the
   v4 decode step's device time and
   operations with the grammar kernels in it (phase 4).
4d. Mixture of experts (run after phase 5, while the 1B model is
   written): the router kernel (``csrc/moe_route.cu``) against its
   plain version at Mixtral's router (dim 4096, 8 experts, 2 active)
   on 8, 32 and 1,024 bf16 rows (expert ids equal on every row clear of a
   near tie, weights within 1e-6) and on exact ties (lax.top_k's order),
   each timed beside the library chain, the plain version and the launch
   floor; a row's outputs bit-equal alone and inside 8 to 1,024 rows, bf16
   and f32, on both sides of the switch from one cluster a row to tiles
   and under either plan forced; both plans timed over 32 to 256 rows;
   ``-Xptxas -v``'s registers and shared memory of both plans (an
   ``nvcc`` beside the build); a
   Mixtral-8x7B-width model (2 of its 32 layers, seq_len 2048, random Q40
   blocks of std 0.02 from seed 0, 2.23 GB): its forward on the card
   against the CPU's f32 forward on the same weights, a 64-row prompt
   chunk (the sparse dispatch) and 8 greedy steps (the per-expert loop),
   a run taking the other's experts only at a near tie that their logits'
   difference explains; its v4 decode and verify steps replayed from their
   graphs (launches, device time and operations, 57 Q40 products a step
   against the experts' 0.473 ms byte bound) and an 8-step
   ``decode_multi`` replay against its eager bodies; tp=2 (the host's
   cards, one card named twice where there is one) on the f32 wire and
   the Q80 wire, and tp=2 x ep=2 (each rank its own 4 experts) on the
   f32 wire, against tp=1 over 16 greedy tokens; the tp2 and tp2 x ep2 v4
   decode steps replayed from their graphs (device time, Q40 launches a
   rank: L x (3 + tp + 3 E / ep), wcls on the ep-0 ranks); the scheduler in this
   process, the drafting request's greedy stream with speculation equal
   to the one without; then ``dllama_api`` with its defaults: 4 requests
   at once (one a flags json_schema) finish, the constrained answer
   conforms, the greedy and the seeded completions are the in-process
   streams, no graph is captured after warmup, the router and the Q40
   kernels launched.
4e. Fleet: four ``dllama_api`` replicas started together and two
   ``python -m distributed_llama_multiusers_tpu_torch.app.dllama_router``
   processes. (a) A router over two paged replicas (``--replica-id r1``
   with 8 lanes and ``r2`` with 4, ``--reconnect-grace 30``, journal on):
   two requests on the 1,900-token run land on one replica, named in
   ``X-DLlama-Replica``, whose prefix tree gives the second 1,024 tokens.
   (b) The durability phase's 4 streamed requests (2 greedy, 2 seeded, 256
   tokens) through that router land on r1, which is SIGKILLed once each
   stream holds 32 deltas: the router migrates every one to r2, each
   client's text equals the durability reference byte for byte with the
   router's event ids 1..N (none lost or repeated); the time from the kill
   to the first migrated byte printed. (c) A ``--role prefill`` and a
   ``--role decode`` replica, both ``--kv-dtype f8 --paged-kv on``, behind
   a router with ``--disagg-threshold 1000``: the f8 paged pass's
   1,918-token greedy prompt, streamed, hands off at its first token
   (KV-page bundle, ticket, reattach); the client's text equals the
   monolithic f8 paged server's, the decode replica adopted the bundle and
   shared 1,024 prompt tokens, neither replica captured a graph after
   warmup; TTFT, the hand-off's ms and the bundle's bytes printed; a live
   f8 session's bundle pushed to the bf16 replica r2 gets a typed 422
   (``page_bytes``) and leaves its pool as it was.
4f. Pod (spawned before the f8 phase's servers, served after 4e): four
   two-process pods on ``cuda:0``, each ``dllama_api`` as the root
   (``--process-id 0``) beside ``dllama worker`` (``--process-id 1``), one
   rank of ``--workers 2`` a process, the ring steps between them through
   the windows (CUDA IPC memory, stream memory operations), or for the
   f32-wire pod and the killed pod over TCP links on loopback
   (``DLLAMA_POD_TRANSPORT=socket``, the transport of a pod across hosts:
   pinned host slots mapped into the card, the same stream memory
   operations on host-mapped words); the card's compute mode must let them
   share it. First ``tools/pod_hop.py --small --transport socket``: the
   collectives' bits equal over the links and over the IPC windows, the
   32 KiB hop's ms a step each way beside the socket hop's bound at a
   measured loopback bandwidth. The f32-wire pod and the
   ``--buffer-float-type q80 --dequant auto`` pod each serve the tp2
   passes' 4 concurrent requests: the bodies, the greedy text and the
   concurrent texts equal the one-process tp2 pass of the same wire byte
   for byte; ring_hop, the sampler, attention and grammar kernels launched
   in the root (``/stats``) and in the worker (its ``worker_exit`` line);
   the pipelined chain with fused admissions and verify steps, no flush,
   no graph; root and worker launched ring_hop equally often; the eager
   step the root timed at startup (``pod_step_*`` in ``/stats``: its ring
   waits and their share) and the packet broadcast's µs printed; both
   processes exit 0 on the root's SIGTERM. The paged IPC pod adds the
   swap tier, a page export and a hand-off from the fourth pod, a paged
   ``--role prefill`` socket pod (``--step-deadline 5``), whose export is
   then held against the one-process tp2 engine's pages and whose worker
   is SIGKILLed mid-stream: its root exits 18 within the deadline plus 30
   s. A summary line sets each pod's transport, eager step and batch tok/s
   side by side.
4g. Serving meshes (started beside the pods, served after 4e):
   ``dllama_api --workers dp2,tp2,sp2`` with its 8 ranks on ``cuda:0``
   serves the 4 requests of phase 3 with ``serve_pass``'s checks, its
   decode graphs captured at warmup, the ring hop and the stats form
   launched; its TTFT and batch tok/s beside the tp2 v4 pass's, the
   card's free memory before it starts and the weights its ranks share
   on the card.
5. Kernel lab (run after phase 4c's kernels, while the models are
   written): the lab's three kernels (``q40_probe``, ``q40_lab_twodot``,
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

import base64
import ctypes
import hashlib
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
    cmd = [q._nvcc(), *q.NVCC_FLAGS, *q.NVCC_EXTRA_FLAGS.get(rc.KERNEL, ()),
           "-DRING_HOP_ONE_KERNEL", "-o", path, os.path.join(ROOT, rc.KERNEL_SOURCE)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), path


def start_ptxas_report(q, source: str):
    """Start ``nvcc -Xptxas -v`` on ``source`` into a library nothing loads,
    beside the kernel build; ``ptxas_usage`` reads its report."""
    os.makedirs(q.build_dir(), exist_ok=True)
    name = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(q.build_dir(), f"ptxas_report_{name}.so")
    cmd = [q._nvcc(), *q.NVCC_FLAGS, "-Xptxas", "-v", "-o", path, os.path.join(ROOT, source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_usage(proc, kernels: tuple) -> dict:
    """{kernel: {registers, smem_bytes, spill_bytes}} from ``start_ptxas_report``'s
    compiler output for each of ``kernels`` (names in the source), a
    template's instantiations as ``name<true>`` and ``name<false>`` (a bool
    argument) or ``name<bf16>`` and ``name<f32>`` (the element type)."""
    out, _ = proc.communicate()
    check(proc.returncode == 0, f"nvcc -Xptxas -v failed:\n{out}")
    pattern = re.compile(r"(" + "|".join(kernels) + r")(I(Lb1|Lb0|13__nv_bfloat16|f)E)?")
    args = {"Lb1": "<true>", "Lb0": "<false>", "13__nv_bfloat16": "<bf16>", "f": "<f32>"}
    usage, fn = {}, None
    for line in out.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            m = pattern.search(line)
            fn = None if m is None else m.group(1) + ("" if m.group(2) is None
                                                      else args[m.group(3)])
            if fn is not None:
                usage.setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            usage[fn]["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", line)
            usage[fn].update(registers=int(m.group(1)),
                             smem_bytes=int(smem.group(1)) if smem else 0)
    check(all(any(k.startswith(n) for k in usage) for n in kernels)
          and all("registers" in u for u in usage.values()),
          f"no register counts for {kernels} in nvcc -Xptxas -v's output:\n{out}")
    return usage


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
    stats_form = attn_stats_phase(torch, ca)
    out = {"lanes": lanes, "n_kv": n_kv, "group": group, "head_size": hd, "s_len": s_len,
           "positions": serving[:, 0].tolist(), "split": split,
           "grid": list(ca.launch_grid(lanes, n_kv, s_len)),
           "splits_per_lane": [-(-(min(int(p), s_len - 1) + 1) // split) for p in serving[:, 0]],
           "max_abs_err": err, "max_abs_ref": ref_max, "tol": ATTN_TOL,
           "library_max_abs_err": lib_err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, **bound_of(serving),
           "long_context": {"positions": long_ctx[:, 0].tolist(), "ms": long_ms,
                            **bound_of(long_ctx)}, "window": window,
           "stats_form": stats_form}
    log("decode_attn: " + json.dumps({k: v for k, v in out.items()
                                      if k not in ("window", "stats_form")}))
    log("decode_attn window: " + json.dumps(window))
    return out


SP_BLOCK = ATTN_S_LEN // 2  # an sp = 2 rank's slots of the smoke model's cache


def attn_stats_phase(torch, ca) -> dict:
    """``decode_attn``'s partial-stats form at the 1B serving shapes of a
    tp2 x sp2 rank (8 lanes, 4 kv heads of 4 query heads, head size 64, a
    bf16 block of SP_BLOCK slots): each sp rank's call at the smoke's
    serving positions shifted by its block's start (rank 1: every live lane
    before its block, the empty state; the parked lanes attend every slot),
    and rows at s0 - 1, s0 and s0 + 1 of block 1, against the plain version
    (``block_stats``): o, l and m within ATTN_TOL, the empty rows exactly
    (0, 0, -inf), o bit-equal to the plain kernel's wherever a row has a
    slot. Then each rank's call timed (launches back to back in one CUDA
    graph), the plain version eager and ``scaled_dot_product_attention``
    over rank 0's block (one CUDA graph), with the bound: the slots the rows
    attend read once, q, the output and the stats, or the f32 operations of
    the dots."""
    lanes, n_kv, group, hd, blk = DECODE_M, 4, 4, 64, SP_BLOCK
    gen = torch.Generator(device="cuda").manual_seed(11)
    qf = torch.randn((lanes, 1, n_kv, group, hd), device="cuda", generator=gen)
    k, v = (torch.randn((lanes, blk + 1, n_kv, hd), device="cuda", generator=gen)
            .to(torch.bfloat16) for _ in range(2))
    scale = 1.0 / hd ** 0.5
    serving = attn_serving_positions(torch)
    edges = torch.tensor([[blk - 1], [blk], [blk + 1], [blk + ca.SPLIT - 1], [blk + ca.SPLIT],
                          [2 * blk - 1], [0], [ATTN_S_LEN]], device="cuda")
    cases = {"rank0": serving, "rank1": serving - blk, "rank1_edges": edges - blk}
    err, ref_max = 0.0, 0.0
    before = ca.STATS_COUNTS["launches"]
    for name, pos in cases.items():
        o, l, m = ca.decode_attention_stats(qf, k, v, pos, scale, blk)
        po, pl, pm = ca.decode_attention_stats_plain(qf, k, v, pos, scale, blk)
        empty = pos < 0
        check(bool(torch.isneginf(m[empty]).all() and l[empty].eq(0).all()
                   and o[empty].eq(0).all() and l[~empty].gt(0).all())
              and torch.equal(torch.isneginf(m), torch.isneginf(pm)),
              f"decode_attn stats [{name}]: the empty rows are not (0, 0, -inf)")
        fin = torch.isfinite(pm)
        for a, b in ((o, po), (l, pl), (m[fin], pm[fin])):
            e, r = float((a - b).abs().max()), float(b.abs().max())
            check(e <= ATTN_TOL * max(r, 1.0),
                  f"decode_attn stats [{name}]: max|d| {e:.3e} > {ATTN_TOL:.1e} x {r:.3e}")
            err, ref_max = max(err, e), max(ref_max, r)
        live = (pos >= 0).all(dim=1)
        check(torch.equal(o[live], ca.decode_attention(qf[live], k[live], v[live], pos[live],
                                                       scale, blk)),
              f"decode_attn stats [{name}]: o differs from the plain kernel's output")
    check(ca.STATS_COUNTS["launches"] - before == len(cases),
          f"decode_attn stats: {ca.STATS_COUNTS['launches'] - before} stats launches for "
          f"{len(cases)} calls")
    reps = 20

    def bound_of(pos):
        slots = int((pos.clamp(min=-1, max=blk - 1) + 1).sum())
        n_bytes = (slots * n_kv * hd * 2 * 2 + 2 * qf.numel() * 4 + lanes * 8
                   + lanes * n_kv * group * 2 * 4)
        n_ops = slots * n_kv * group * hd * 4
        t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / F32_OPS_S
        return {"slots_read": slots, "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_bytes": n_bytes, "bound_ops": n_ops}

    timed = {}
    for name in ("rank0", "rank1"):
        pos = cases[name]
        timed[name] = {"positions": pos[:, 0].tolist(), **bound_of(pos),
                       "ms": graph_ms(torch, [lambda pos=pos: ca.decode_attention_stats(
                           qf, k, v, pos, scale, blk)] * reps)}
    pos = cases["rank0"]
    plain_ms = eager_ms(torch, lambda: ca.decode_attention_stats_plain(qf, k, v, pos, scale,
                                                                      blk), 3)
    q_l = qf.reshape(lanes, n_kv * group, 1, hd)
    k_l, v_l = (t[:, :blk].permute(0, 2, 1, 3).float().repeat_interleave(group, dim=1)
                .contiguous() for t in (k, v))
    mask = (torch.arange(blk, device="cuda")[None, :] <= pos)[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = graph_ms(torch, [lambda: sdpa(q_l, k_l, v_l, attn_mask=mask, scale=scale)]
                          * reps)
    out = {"lanes": lanes, "n_kv": n_kv, "group": group, "head_size": hd, "block": blk,
           "max_abs_err": err, "max_abs_ref": ref_max, "tol": ATTN_TOL,
           "ms": timed["rank0"]["ms"], "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": timed["rank0"]["bound_ms"], "bound_by": timed["rank0"]["bound_by"],
           "slots_read": timed["rank0"]["slots_read"], "ranks": timed}
    log("decode_attn stats form: " + json.dumps(out))
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


def _f8_cache(torch, shape, gen, outliers: bool):
    """An e4m3 cache plane written as the engine writes one (through
    ``_to_cache_dtype``) from ``attn_inputs``' random K/V; with
    ``outliers`` one value in 64 is scaled past +-448, so that the clip is
    exercised."""
    from distributed_llama_multiusers_tpu_torch.models.llama import F8, _to_cache_dtype

    x = torch.randn(shape, device="cuda", generator=gen)
    if outliers:
        x = torch.where(torch.rand(shape, device="cuda", generator=gen) < 1 / 64, x * 1000, x)
    return _to_cache_dtype(x, F8)


def attn_f8_phase(torch, attn: dict) -> dict:
    """The attention kernel's e4m3 instantiation (``--kv-dtype f8``) at
    ``attn_phase``'s shapes: a cache of 2048 slots written through
    ``_to_cache_dtype`` from random K/V, V with values past +-448 (K's
    scores stay those of ``attn_phase``: outliers there put scores in the
    hundreds, where f32's exp carries a relative error of |score| x 2^-24
    in both versions, the plain one included). T = 1, the
    4-row window and the page-table form against their plain versions (the
    cache widened to f32) within ATTN_TOL, and bit for bit against the bf16
    instantiation on the cache widened to bf16 (every e4m3 value is one);
    a lane's bits against another batch around it; each window row against
    a one-row call; the paged form against the contiguous one. Each form
    timed (one CUDA graph) beside the bf16 instantiation on the same
    shapes, its plain version and ``scaled_dot_product_attention`` on the
    cache widened to f32 beforehand, with its bound: the e4m3 slots the
    rows read once, q and the output, or the f32 operations."""
    from distributed_llama_multiusers_tpu_torch.models.llama import F8
    from distributed_llama_multiusers_tpu_torch.ops import cuda_attn as ca

    lanes, n_kv, group, hd, s_len = DECODE_M, 8, 4, 64, ATTN_S_LEN
    gen = torch.Generator(device="cuda").manual_seed(21)
    shape = (lanes, s_len + 1, n_kv, hd)
    qf = torch.randn((lanes, 1, n_kv, group, hd), device="cuda", generator=gen)
    k, v = _f8_cache(torch, shape, gen, False), _f8_cache(torch, shape, gen, True)
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    check(float(v.float().abs().max()) == 448.0, "f8 cache: no value clipped at 448")
    scale = 1.0 / hd ** 0.5
    serving = attn_serving_positions(torch)
    split = ca.SPLIT
    spread = torch.tensor([[0], [1], [63], [511], [1024], [2046], [2047], [2048]], device="cuda")
    boundaries = torch.tensor([[split - 1], [split], [split + 1], [2 * split - 1], [2 * split],
                               [2 * split + 1], [3 * split], [s_len - 1]], device="cuda")
    long_ctx = torch.full((lanes, 1), s_len - 1, device="cuda")
    f8_before = ca.F8_COUNTS["launches"]
    err, ref_max = 0.0, 0.0
    for pos in (serving, spread, boundaries, long_ctx):
        got = ca.decode_attention(qf, k, v, pos, scale, s_len)
        want = ca.decode_attention_plain(qf, k, v, pos, scale, s_len)
        e, r = float((got - want).abs().max()), float(want.abs().max())
        check(bool(torch.isfinite(got).all()) and e <= ATTN_TOL * r,
              f"decode_attn f8: max|d| {e:.3e} > {ATTN_TOL:.1e} x {r:.3e}")
        check(torch.equal(got, ca.decode_attention(qf, kb, vb, pos, scale, s_len)),
              "decode_attn f8: differs from the bf16 instantiation on the widened cache")
        err, ref_max = max(err, e), max(ref_max, r)
    check(ca.F8_COUNTS["launches"] - f8_before == 4,
          f"decode_attn f8: {ca.F8_COUNTS['launches'] - f8_before} e4m3 launches, expected 4")
    base = ca.decode_attention(qf, k, v, serving, scale, s_len)
    for pos, sl in ((spread, s_len), (serving, 128)):
        got = ca.decode_attention(qf, k, v, torch.cat([serving[:1], pos[1:]]), scale, sl)
        check(torch.equal(got[0], base[0]), "decode_attn f8: lane 0's bits moved with the batch")
    on_split = ca.decode_attention(qf, k, v, torch.full_like(serving, split), scale, s_len)
    got = ca.decode_attention(qf, k, v, torch.cat([boundaries[1:2], spread[1:]]), scale, s_len)
    check(torch.equal(got[0], on_split[0]),
          "decode_attn f8: a lane on a split boundary moved with the batch")

    # the window: 4 rows a lane, each row against a one-row call
    t = ca.WINDOW
    qw = torch.randn((lanes, t, n_kv, group, hd), device="cuda", generator=gen)
    w_serving = window_rows(torch, [40, 63, 64, 100] + [s_len] * 4)
    w_bound = window_rows(torch, [split - 4, split - 2, split - 1, split, 2 * split - 3,
                                  2 * split - 1, 3 * split - 2, s_len - 4])
    w_err, w_ref, rows_checked = 0.0, 0.0, 0
    for pos in (w_serving, w_bound, window_rows(torch, [s_len - 1] * lanes)):
        got = ca.decode_attention(qw, k, v, pos, scale, s_len)
        want = ca.decode_attention_plain(qw, k, v, pos, scale, s_len)
        e, r = float((got - want).abs().max()), float(want.abs().max())
        check(bool(torch.isfinite(got).all()) and e <= ATTN_TOL * r,
              f"decode_attn f8 window: max|d| {e:.3e} > {ATTN_TOL:.1e} x {r:.3e}")
        w_err, w_ref = max(w_err, e), max(w_ref, r)
        check(torch.equal(got, ca.decode_attention(qw, kb, vb, pos, scale, s_len)),
              "decode_attn f8 window: differs from the bf16 instantiation")
        for row in range(t):
            one = ca.decode_attention(qw[:, row:row + 1].contiguous(), k, v,
                                      pos[:, row:row + 1].contiguous(), scale, s_len)
            check(torch.equal(got[:, row], one[:, 0]),
                  f"decode_attn f8 window: row {row} differs from a T = 1 call")
            rows_checked += lanes

    # the paged form: 64-slot pages permuted at random (laid out as bytes)
    page = 64
    kp, vp, table = paged_pool(torch, k.view(torch.uint8), v.view(torch.uint8), page, seed=5)
    kp, vp = kp.view(F8), vp.view(F8)
    p_err, p_ref = 0.0, 0.0
    for pos in (serving, boundaries, long_ctx):
        got = ca.decode_attention_paged(qf, kp, vp, table, pos, scale, s_len)
        check(torch.equal(got, ca.decode_attention(qf, k, v, pos, scale, s_len)),
              "decode_attn f8 paged: differs from the contiguous kernel on the same slots")
        want = ca.decode_attention_paged_plain(qf, kp, vp, table, pos, scale, s_len)
        e, r = float((got - want).abs().max()), float(want.abs().max())
        check(e <= ATTN_TOL * r, f"decode_attn f8 paged: max|d| {e:.3e} > {ATTN_TOL:.1e} x "
                                 f"{r:.3e}")
        p_err, p_ref = max(p_err, e), max(p_ref, r)
    gotw = ca.decode_attention_paged(qw, kp, vp, table, w_serving, scale, s_len)
    check(torch.equal(gotw, ca.decode_attention(qw, k, v, w_serving, scale, s_len)),
          "decode_attn f8 paged window: differs from the contiguous window")

    def bound_of(pos, n_q):
        rows = pos.clamp(max=s_len - 1) + 1
        slots = int(rows.max(dim=1).values.sum())  # once a lane, for all its rows
        n_bytes = slots * n_kv * hd * 1 * 2 + 2 * n_q * 4 + pos.numel() * 8
        n_ops = int(rows.sum()) * n_kv * group * hd * 4
        t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / F32_OPS_S
        return {"slots_read": slots, "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_bytes": n_bytes, "bound_ops": n_ops}

    def library_of(q_rows, pos):
        """sdpa on the cache widened to f32 and laid out beforehand."""
        b_, t_ = q_rows.shape[:2]
        q_l = q_rows.permute(0, 2, 3, 1, 4).reshape(b_, n_kv * group, t_, hd).contiguous()
        k_l = k[:, :s_len].float().permute(0, 2, 1, 3).contiguous()
        v_l = v[:, :s_len].float().permute(0, 2, 1, 3).contiguous()
        mask = (torch.arange(s_len, device="cuda")[None, None, :] <= pos[:, :, None])[:, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        try:
            sdpa(q_l, k_l, v_l, attn_mask=mask, scale=scale, enable_gqa=True)
            return lambda: sdpa(q_l, k_l, v_l, attn_mask=mask, scale=scale, enable_gqa=True)
        except TypeError:  # a torch without enable_gqa: the kv heads expanded first
            k_e, v_e = (x.repeat_interleave(group, dim=1) for x in (k_l, v_l))
            return lambda: sdpa(q_l, k_e, v_e, attn_mask=mask, scale=scale)

    reps = 20
    forms = {}
    for name, q_rows, pos, f8_call, bf16_call, plain_call in (
            ("t1", qf, serving,
             lambda: ca.decode_attention(qf, k, v, serving, scale, s_len),
             lambda: ca.decode_attention(qf, kb, vb, serving, scale, s_len),
             lambda: ca.decode_attention_plain(qf, k, v, serving, scale, s_len)),
            ("window", qw, w_serving,
             lambda: ca.decode_attention(qw, k, v, w_serving, scale, s_len),
             lambda: ca.decode_attention(qw, kb, vb, w_serving, scale, s_len),
             lambda: ca.decode_attention_plain(qw, k, v, w_serving, scale, s_len)),
            ("paged", qf, serving,
             lambda: ca.decode_attention_paged(qf, kp, vp, table, serving, scale, s_len),
             lambda: ca.decode_attention(qf, kb, vb, serving, scale, s_len),
             lambda: ca.decode_attention_paged_plain(qf, kp, vp, table, serving, scale,
                                                     s_len))):
        forms[name] = {"ms": graph_ms(torch, [f8_call] * reps),
                       "bf16_ms": graph_ms(torch, [bf16_call] * reps),
                       "plain_ms": eager_ms(torch, plain_call, 3),
                       "library_ms": graph_ms(torch, [library_of(q_rows, pos)] * reps),
                       **bound_of(pos, q_rows.numel())}
    out = {"lanes": lanes, "n_kv": n_kv, "group": group, "head_size": hd, "s_len": s_len,
           "positions": serving[:, 0].tolist(), "max_abs_err": max(err, w_err, p_err),
           "max_abs_ref": max(ref_max, w_ref, p_ref), "tol": ATTN_TOL,
           "t1_max_abs_err": err, "window_max_abs_err": w_err, "paged_max_abs_err": p_err,
           "rows_bit_equal_to_one_row_calls": rows_checked,
           "bf16_bound_ms": attn["bound_ms"], "forms": forms,
           "library": "scaled_dot_product_attention on the cache widened to f32 beforehand"}
    log("decode_attn f8: " + json.dumps(out))
    return out


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


def ensure_model(header, seed: int = 0, cache_dir: str | None = None,
                 write=None) -> tuple[str, str]:
    """The synthetic .m/.t for ``header`` and ``seed`` in the cache
    directory, written anew unless a previous run left the same ones;
    ``write(path, header, seed)`` writes the .m (default: through the
    quantizers, ``formats/synthetic.write_synthetic_model``)."""
    from distributed_llama_multiusers_tpu_torch.formats.synthetic import (
        write_synthetic_model,
        write_synthetic_tokenizer,
    )

    write = write or write_synthetic_model
    cache_dir = cache_dir or os.path.join(ROOT, "build", "synthetic")
    os.makedirs(cache_dir, exist_ok=True)
    key = {"kv": header.to_kv_pairs(), "seed": seed, "writer": write.__name__}
    experts = f"_e{header.n_experts}" if header.n_experts else ""
    stem = os.path.join(cache_dir, f"llama_d{header.dim}_l{header.n_layers}{experts}_s{seed}")
    model, tok, meta = stem + ".m", stem + ".t", stem + ".json"
    if os.path.exists(meta) and os.path.exists(model) and os.path.exists(tok):
        with open(meta) as f:
            if json.load(f) == json.loads(json.dumps(key)):
                log(f"model: reusing {model}")
                return model, tok
    t0 = time.perf_counter()
    write(model, header, seed=seed)
    write_synthetic_tokenizer(tok, vocab_size=header.vocab_size)
    with open(meta, "w") as f:
        json.dump(key, f)
    log(f"model: wrote {model} ({os.path.getsize(model) / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f}s")
    return model, tok


def write_model(name: str) -> None:
    """One synthetic model the phases load: "1b" (the numpy quantizers,
    about a minute) or "mixtral" (random Q40 blocks, ~10 s)."""
    if name == "1b":
        ensure_model(llama32_1b_header(), seed=0)
    else:
        ensure_model(mixtral_header(), seed=0, write=write_random_q40_model)


def start_model_writers() -> dict:
    """``write_model`` for each model in a process of its own, so that the
    host's numpy runs beside the kernels' build and the kernel phases;
    ``main`` waits for each before its first use and ends them on a
    failure."""
    procs = {}
    for name in ("1b", "mixtral"):
        code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
                f"chip_smoke.write_model({name!r})")
        procs[name] = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT)
    return procs


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
                time.sleep(0.1)
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


def pass_args(mode: str | None, extra_args=()) -> tuple:
    """A serving pass's ``dllama_api`` arguments."""
    return (*(["--dequant", mode] if mode else []), *extra_args)


def serve_pass(model: str, tok: str, mode: str | None, n_tokens: int,
               extra_args=(), log_dir: str = OUT_DIR, health_timeout: float = 900.0,
               name: str | None = None, alone: bool = False, extra=None,
               srv: "Server | None" = None) -> dict:
    """One dllama_api process: 4 concurrent requests, checks, /stats,
    SIGTERM (``alone``: then each request streamed alone, its text kept;
    ``extra``: then ``extra(base)`` runs on the server, its result kept as
    ``extra``). ``srv``: the pass's server, already started with
    ``pass_args(mode, extra_args)`` (``start_servers``), else started here.
    Returns the pass's measurements, launch counts, bodies and startup
    log."""
    name = name or mode or "default"
    if srv is None:
        srv = Server(model, tok, name, pass_args(mode, extra_args), log_dir=log_dir,
                     health_timeout=health_timeout)
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
        extra_out = extra(base) if extra is not None else None
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
               "decode_attn_paged_launches": stats["decode_attn_paged_launches"],
               "decode_attn_stats_launches": stats["decode_attn_stats_launches"],
               "decode_attn_f8_launches": stats["decode_attn_f8_launches"],
               "pool": {k: v for k, v in stats.items() if k.startswith(("pool_", "swap_"))},
               "extra": extra_out,
               **{k: stats[k] for k in ("pipeline_dispatches", "pipeline_flushes",
                                        "pipeline_depth_hist", "multi_dispatches",
                                        "fused_steps", "fused_bucket_hist", "overlap_s",
                                        "decode_graphs", "decode_graph_replays",
                                        "gumbel_sample_launches", "decode_attn_launches",
                                        "decode_attn_window_launches", "spec_steps",
                                        "spec_pipelined_steps", "spec_lane_steps",
                                        "spec_emitted", "spec_tokens_per_lane_step",
                                        "spec_accept_hist", "grammar_mask_argmax_launches",
                                        "grammar_next_launches", "grammar_lanes",
                                        "grammar_masked_steps")}}
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
    check(p["grammar_mask_argmax_launches"] > 0 and p["grammar_next_launches"] > 0,
          f"{name}: the grammar kernels never launched (mask "
          f"{p['grammar_mask_argmax_launches']}, step {p['grammar_next_launches']})")
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


# (name, mode, extra args, tokens, alone, the kernels its run must have
# launched) of the one-card serving passes
SERVING_PASSES = (
    ("default", None, (), GEN_TOKENS, True, ("q40_slab",)),
    ("v4-sync", None, SYNC_ARGS, GEN_TOKENS, True, ("q40_slab",)),
    ("v4-no-spec", None, NO_SPEC_ARGS, GEN_TOKENS, True, ("q40_slab",)),
    ("auto", "auto", (), GEN_TOKENS, False, ("q40_i8blockdot", "q40_slab")),
    ("blockdot", "blockdot", (), 16, False, ("q40_blockdot", "q40_slab")))


def serving_phase(torch, q) -> list:
    """The serving passes (``SERVING_PASSES``, then ``tp_serving_passes``),
    their servers all started together, then driven one at a time."""
    torch.cuda.empty_cache()  # the servers are other processes on this card
    model, tok = ensure_model(llama32_1b_header(), seed=0)
    devices = ",".join(str(d) for d in rank_devices(torch, 2))
    servers = start_servers(model, tok, [(s[0], pass_args(s[1], s[2])) for s in SERVING_PASSES]
                            + [(s[0], pass_args(s[1], s[2])) for s in tp_pass_specs(devices)])
    try:
        return _serving_passes(torch, model, tok, servers)
    finally:
        for srv in servers:
            srv.kill()


def _serving_passes(torch, model: str, tok: str, servers: list) -> list:
    passes = []
    for (name, mode, extra, n_tokens, alone, expect), srv in zip(SERVING_PASSES, servers):
        p = serve_pass(model, tok, mode, n_tokens, extra_args=extra, alone=alone, name=name,
                       srv=srv)
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
    passes += tp_serving_passes(torch, model, tok, passes[0], servers[len(SERVING_PASSES):])
    return passes


def _common_prefix(a: list, b: list) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def tp_pass_specs(devices: str) -> tuple:
    """(name, mode, extra args, the kernels its run must have launched, what
    its startup log must say) of the tp = 2 serving passes on ``devices``."""
    tp = ("--workers", "2", "--device", devices)
    return (("tp2", None, tp, ("q40_slab",), ("Ring TP sync",)),
            ("tp2-q80-auto", "auto", (*tp, "--buffer-float-type", "q80"),
             ("q40_i8blockdot", "q40_slab"), ("Ring TP sync", "(Q80 wire)",
                                              "Q80 sync transport")))


def tp_serving_passes(torch, model: str, tok: str, single: dict, servers: list) -> list:
    """``dllama_api --workers 2`` at full width and depth on the host's
    cards (one card named twice where there is one; ``servers``, started
    with ``tp_pass_specs``' arguments): the defaults (v4, f32 ring wire)
    and ``--buffer-float-type q80 --dequant auto`` (Q80 wire, i8blockdot
    decode). Each checks what ``serve_pass`` checks, the startup log's
    announcements and the ring hop's launches on /stats."""
    from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer

    devices = ",".join(str(d) for d in rank_devices(torch, 2))
    tokenizer = Tokenizer(tok)
    ref = tokenizer.encode(single["greedy_text"], add_bos=False)
    passes = []
    for (name, mode, extra, expect, says), srv in zip(tp_pass_specs(devices), servers):
        p = serve_pass(model, tok, mode, GEN_TOKENS, name=name, extra_args=extra, srv=srv)
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


MESH_SERVE_WORKERS = "dp2,tp2,sp2"
MESH_SERVE_RANKS = 8


def start_mesh_server(torch) -> dict:
    """``dllama_api --workers dp2,tp2,sp2`` with its 8 ranks on the host's
    first card, started in a thread (it loads and warms beside the phases
    before its pass); the card's free memory logged before it starts."""
    model, tok = ensure_model(llama32_1b_header(), seed=0)
    free, total = torch.cuda.mem_get_info(0)
    held = {"mem_before": {"free_bytes": free, "total_bytes": total}, "srv": None, "error": None}
    args = ("--workers", MESH_SERVE_WORKERS, "--device", ",".join(["cuda:0"] * MESH_SERVE_RANKS))

    def start():
        try:
            held["srv"] = Server(model, tok, "dp2tp2sp2", args)
        except BaseException as e:  # noqa: BLE001 — re-raised by mesh_serving_pass
            held["error"] = e

    held["thread"] = threading.Thread(target=start, daemon=True)
    held["thread"].start()
    log(f"dp2tp2sp2 server starting: card free {free / 2**30:.2f} of {total / 2**30:.2f} GiB")
    return held


def mesh_serving_pass(torch, passes: list, held: dict) -> dict:
    """The dp2 x tp2 x sp2 server's pass (``start_mesh_server``): the 4
    requests and every check of ``serve_pass``, the serving paths of a
    one-card mesh (its decode graphs captured at warmup), the startup log's
    mesh, sync and per-rank weight lines, the ring hop and the stats form
    launched; its TTFT and batch tok/s beside the tp2 v4 pass's and the
    greedy tokens it shares with it (information: bf16 sums in another
    order)."""
    from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer

    model, tok = ensure_model(llama32_1b_header(), seed=0)
    held["thread"].join()
    if held["error"] is not None:
        raise held["error"]
    free, total = torch.cuda.mem_get_info(0)
    p = serve_pass(model, tok, None, GEN_TOKENS, name="dp2tp2sp2",
                   extra_args=("--workers", MESH_SERVE_WORKERS), srv=held["srv"])
    mesh = p["mesh"] or {}
    check((mesh.get("dp"), mesh.get("tp"), mesh.get("sp")) == (2, 2, 2)
          and len(mesh.get("devices", ())) == MESH_SERVE_RANKS,
          f"dp2tp2sp2: /stats mesh {p['mesh']}")
    check(p["ring_hop_launches"] > 0 and p["decode_attn_stats_launches"] > 0,
          f"dp2tp2sp2: ring_hop {p['ring_hop_launches']}, stats form "
          f"{p['decode_attn_stats_launches']} launches")
    check(p["decode_attn_stats_launches"] == p["decode_attn_launches"],
          f"dp2tp2sp2: {p['decode_attn_stats_launches']} stats-form launches of "
          f"{p['decode_attn_launches']} attention launches (every one an sp rank's)")
    check_serving_paths(p)
    for phrase in ("Mesh: dp=2 pp=1 tp=2 sp=2 ep=1", "ring all-reduce within each tp group",
                   "sp=2: each rank holds"):
        check(phrase in p["log"], f"dp2tp2sp2: the startup log does not say {phrase!r}")
    weights = re.findall(r"cuda:0: (\d+) MiB of weights for (\d+) ranks", p["log"])
    check(bool(weights), "dp2tp2sp2: no per-card weights line in the startup log")
    tp2 = next(x for x in passes if x["mode"] == "tp2")
    tokenizer = Tokenizer(tok)
    ref = tokenizer.encode(tp2["greedy_text"], add_bos=False)
    got = tokenizer.encode(p["greedy_text"], add_bos=False)
    p["greedy_tokens_matching_tp2"] = _common_prefix(got, ref)
    p["greedy_tokens"] = len(got)
    p["memory"] = {"before": held["mem_before"],
                   "after_load": {"free_bytes": free, "total_bytes": total},
                   "weights_mib_on_card": int(weights[0][0])}
    p["beside_tp2"] = {"ttft_ms_p50": tp2["ttft_ms_p50"],
                       "tokens_per_s_batch": tp2["tokens_per_s_batch"]}
    log(f"dp2tp2sp2 pass: TTFT p50 {p['ttft_ms_p50']} ms, batch {p['tokens_per_s_batch']:.1f} "
        f"tok/s against tp2's {tp2['ttft_ms_p50']} ms and {tp2['tokens_per_s_batch']:.1f} "
        f"tok/s; greedy tokens: the first {p['greedy_tokens_matching_tp2']} of {len(got)} "
        f"match tp2's; stats-form launches {p['decode_attn_stats_launches']}; weights "
        f"{weights[0][0]} MiB on cuda:0 for 8 ranks; card free {free / 2**30:.2f} GiB after "
        f"its load (other servers of the run load beside it)")
    return p


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
                 ("decode_attn", stats["decode_attn_launches"]),
                 ("grammar_mask_argmax", stats["grammar_mask_argmax_launches"]),
                 ("grammar_next", stats["grammar_next_launches"])):
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
    from distributed_llama_multiusers_tpu_torch.ops import cuda_grammar as cg
    from distributed_llama_multiusers_tpu_torch.ops import cuda_moe as cm
    from distributed_llama_multiusers_tpu_torch.ops import cuda_q40 as q
    from distributed_llama_multiusers_tpu_torch.ops import cuda_sample as cs
    from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc

    return {"kernel_launches": dict(q.LAUNCHES), "ring_hop_launches": rc.COUNTS["launches"],
            "ring_hop_bytes": rc.COUNTS["bytes"],
            "gumbel_sample_launches": cs.COUNTS["launches"],
            "decode_attn_launches": ca.COUNTS["launches"],
            "decode_attn_window_launches": ca.COUNTS["window_launches"],
            "grammar_mask_argmax_launches": cg.COUNTS["mask_argmax_launches"],
            "grammar_next_launches": cg.COUNTS["next_launches"],
            "moe_route_launches": cm.COUNTS["launches"]}


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
    from distributed_llama_multiusers_tpu_torch.ops import cuda_grammar as cg
    from distributed_llama_multiusers_tpu_torch.ops import cuda_moe as cm
    from distributed_llama_multiusers_tpu_torch.ops import cuda_q40 as q
    from distributed_llama_multiusers_tpu_torch.ops import cuda_sample as cs
    from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc

    for mod in (q, rc, cs, ca, cg, cm):
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
        self.replica = None  # X-DLlama-Replica
        self.events: list = []
        self.stamps: list = []  # each delta's perf_counter
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
                rid = r.headers.get("X-DLlama-Request")  # a router's stream has none
                self.rid = int(rid) if rid is not None else None
                self.replica = r.headers.get("X-DLlama-Replica")
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
                        now = time.perf_counter()
                        if self.first_at is None:
                            self.first_at = now
                        self.events.append((event_id, piece))
                        self.stamps.append(now)
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
    journal_args = ("--journal-path", jpath)
    servers = start_servers(model, tok, [("journal-off", ()), ("journal-on", journal_args)])
    try:
        plain = serve_pass(model, tok, None, GEN_TOKENS, name="journal-off", srv=servers[0])
        journaled = serve_pass(model, tok, None, GEN_TOKENS, name="journal-on",
                               extra_args=journal_args, srv=servers[1])
    finally:
        for srv in servers:
            srv.kill()
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
    # the streams start together, so the server numbers them in arrival
    # order; the journal lists them by id
    check(sorted(e.request_id for e in img.incomplete()) == sorted(s.rid for s in streams)
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
        # the replay thread re-admits the 4 streams 20 ms apart after the
        # server listens, and a stream not yet re-admitted answers 404: wait
        # until every one is (or failed, which fails the check below)
        _poll(lambda: json.loads(_http(rec.base + "/stats")[1])["recovery_done"], 60,
              "durability: the journal's replay never finished", every=0.02)
        rstats = json.loads(_http(rec.base + "/stats")[1])
        check(rstats["recovered_requests"] == 4 and rstats["recovery_failed"] == 0,
              f"durability: recovery re-admitted {rstats['recovered_requests']}, failed "
              f"{rstats['recovery_failed']} (retries {rstats['recovery_retries']})")
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
        "reference": [{"text": "".join(t for _, t in r.events), "finish": r.finish,
                       "deltas": len(r.events)} for r in refs],
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
                                  "decode_attn_window_launches", "grammar_mask_argmax_launches",
                                  "grammar_next_launches")}}],
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
    llama_forward runs them: 7 per layer (an MoE layer: wq, wk, wv, wo,
    then w1, w3 and w2 of each expert), then wcls."""
    ws = []
    for layer in range(params.layers.wq.packed.shape[0]):
        lp = params.layers.layer(layer)
        if lp.moe_gate is None:
            ws += [getattr(lp, name) for name in STEP_WEIGHTS]
            continue
        ws += [getattr(lp, name) for name in STEP_WEIGHTS[:4]]
        for e in range(lp.moe_gate.shape[-1]):
            ws += [getattr(lp, name)[e] for name in STEP_WEIGHTS[4:]]
    return ws + [params.wcls]


def products_per_step(config, n: int, mesh=None) -> int:
    """Q40 products of one decode step over n ranks (of ``mesh``, tp = n
    without one): per rank and layer wq, wk, wv and tp column chunks of wo,
    then the FFN's (dense: w1, w3 and tp column chunks of w2; MoE: w1, w3
    and w2 of each of the rank's E/ep experts, its w2 a plain row slice);
    then wcls on the ranks whose sp and ep coordinates are 0 (the others
    hold the same activations)."""
    tp = n if mesh is None else mesh.tp
    sp, ep = (1, 1) if mesh is None else (mesh.shape["sp"], mesh.shape["ep"])
    ffn = 3 * config.n_experts // ep if config.n_experts > 0 else 2 + tp
    return n * config.n_layers * (3 + tp + ffn) + n // (sp * ep)


def _kernel_of(name: str) -> str | None:
    """The port's kernel behind a profiler kernel name (reduce_splits is
    the split-K sum launch every Q40 wrapper may add)."""
    for tag, kernel in (("i8blockdot_kernel", "q40_i8blockdot"),
                        ("blockdot_kernel", "q40_blockdot"),
                        ("slab_kernel", "q40_slab"), ("reduce_splits", "reduce_splits"),
                        ("ring_seg_kernel", "ring_hop"), ("ring_step2_kernel", "ring_hop"),
                        ("gumbel_sample_kernel", "gumbel_sample"),
                        ("decode_attn_kernel", "decode_attn"),
                        ("mask_argmax_kernel", "grammar_mask_argmax"),
                        ("grammar_next_kernel", "grammar_next"),
                        ("moe_route_kernel", "moe_route")):
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
    from distributed_llama_multiusers_tpu_torch.ops import cuda_grammar as cg
    from distributed_llama_multiusers_tpu_torch.ops import cuda_moe as cm

    for _ in range(3):
        step()
    sync_all(torch)
    wall = []
    moe_before = cm.COUNTS["launches"]
    grammar_before = dict(cg.COUNTS)
    before = dict(q.LAUNCHES)
    ring_before = rc.ring_counts()
    sample_before = cs.COUNTS["launches"]
    attn_before = ca.COUNTS["launches"]
    window_before = ca.COUNTS["window_launches"]
    paged_before = ca.PAGED_COUNTS["launches"]
    for _ in range(steps):
        t0 = time.perf_counter()
        step()  # decode reads the tokens back: each step ends synchronized
        wall.append((time.perf_counter() - t0) * 1e3)
    launches = {k: (q.LAUNCHES[k] - before[k]) / steps for k in q.KERNELS}
    launches["gumbel_sample"] = (cs.COUNTS["launches"] - sample_before) / steps
    launches["decode_attn"] = (ca.COUNTS["launches"] - attn_before) / steps
    launches["decode_attn_window"] = (ca.COUNTS["window_launches"] - window_before) / steps
    launches["decode_attn_paged"] = (ca.PAGED_COUNTS["launches"] - paged_before) / steps
    launches["moe_route"] = (cm.COUNTS["launches"] - moe_before) / steps
    for k in ("mask_argmax", "next"):
        launches[f"grammar_{k}"] = (cg.COUNTS[f"{k}_launches"]
                                    - grammar_before[f"{k}_launches"]) / steps
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
                 if k not in ("ring_hop", "gumbel_sample", "decode_attn", "grammar_mask_argmax",
                              "grammar_next", "moe_route")) / 1e3
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
           "moe_route_ms_per_step": kernels.get("moe_route", [0.0, 0.0])[0] / 1e3,
           "grammar_ms_per_step": {k: kernels.get(k, [0.0, 0.0])[0] / 1e3
                                   for k in ("grammar_mask_argmax", "grammar_next")},
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
    from distributed_llama_multiusers_tpu_torch.ops import cuda_grammar as cg
    from distributed_llama_multiusers_tpu_torch.ops import cuda_moe as cm

    def counts():
        return {**q.LAUNCHES, **rc.ring_counts(), "gumbel_sample": cs.COUNTS["launches"],
                "decode_attn": ca.COUNTS["launches"], "moe_route": cm.COUNTS["launches"],
                "grammar_mask_argmax": cg.COUNTS["mask_argmax_launches"],
                "grammar_next": cg.COUNTS["next_launches"]}

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
    check(got_counts == want_counts and got_counts["grammar_mask_argmax"] == h
          and got_counts["grammar_next"] == h,
          f"decode_multi [{label}]: replayed counts {got_counts} against eager {want_counts}")
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
          and per_step["gumbel_sample"] == 1
          # one masked argmax over the window's rows; the window's walk and
          # the carry's step
          and per_step["grammar_mask_argmax"] == 1 and per_step["grammar_next"] == 2
          and per_step["moe_route"] == (n_layers if config.n_experts > 0 else 0),
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
    from distributed_llama_multiusers_tpu_torch.runtime.engine import parked_step_ms

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
            parked = parked_step_ms(engine) if mesh is not None else None
        finally:
            engine.graphs = graphs
        n, n_layers = len(engine.devices), config.n_layers
        n_products = products_per_step(config, n, mesh)
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
            check(run["launches_per_step"]["moe_route"]
                  == (n * n_layers if config.n_experts > 0 else 0),
                  f"decode step [{label}, {name}]: router launches "
                  f"{run['launches_per_step']['moe_route']} per step")
            check(run["launches_per_step"]["grammar_mask_argmax"] == 1
                  and run["launches_per_step"]["grammar_next"] == 1,
                  f"decode step [{label}, {name}]: grammar launches "
                  f"{run['launches_per_step']['grammar_mask_argmax']} (mask) and "
                  f"{run['launches_per_step']['grammar_next']} (step) per step, expected 1 each")
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
               "verify": verify, "parked_eager_step_ms": parked,
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


MESH_STEPS = 4  # decode steps of each mesh engine the check compares
MESH_BUSY = (0, 3, 4, 7)  # busy lanes: two in each dp group of dp2 at 8 lanes
# tp2 x sp2 against tp2 on the exact-f32 path (f32 activations, cache and
# Q40 dots, as the CPU runs it): only the attention's f32 summation order
# differs (the blocks' flash stats combined, against one kernel over every
# slot), the stats form's own tolerance. With bf16 dots an f32 difference in
# the last bits may flip a bf16 rounding, which 16 layers carry on (the
# TP_LOGITS_TOL class)
SP_LOGITS_TOL = 2e-5


def _mesh_engine_steps(torch, config, params, plan, feed=None, cache_dtype=None) -> dict:
    """An engine on ``plan``'s ranks (the host's cards, one card named for
    every rank where there is one): the MESH_BUSY lanes of 8 prefilled with
    ``step_breakdown``'s prompts, then MESH_STEPS greedy decode steps (each
    busy lane fed ``feed``'s token of the step, else its own). Returns the
    prefill logits and each step's logits on the CPU and greedy tokens."""
    import numpy as np

    from distributed_llama_multiusers_tpu_torch.parallel import make_mesh
    from distributed_llama_multiusers_tpu_torch.parallel.sharding import shard_params
    from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine

    mesh = make_mesh(plan, rank_devices(torch, plan.n_devices))
    engine = InferenceEngine(config, shard_params(params, mesh), n_lanes=DECODE_M,
                             device="cuda", mesh=mesh, cache_dtype=cache_dtype)
    busy = list(MESH_BUSY)
    tokens = np.zeros(DECODE_M, np.int64)
    positions = np.full(DECODE_M, config.seq_len, np.int64)
    logits = []
    for lane in busy:
        prompt = [(97 * lane + 13 * i) % 100 + 1 for i in range(40)]
        last, tokens[lane], positions[lane] = engine.prefill(lane, prompt)
        logits.append(last.float().cpu()[None])
    logits = [torch.cat(logits)]
    chosen = []
    for step in range(MESH_STEPS):
        row, greedy, _ = engine.decode(tokens, positions)
        logits.append(row[busy].float().cpu())
        chosen.append(greedy[busy].copy())
        tokens[busy] = greedy[busy] if feed is None else feed[step]
        positions[busy] += 1
    out = {"plan": {k: getattr(plan, k) for k in ("dp", "tp", "sp", "ep")},
           "logits": logits, "tokens": chosen,
           "graphs": 0 if engine.graphs is None else len(engine.graphs),
           "sync_bytes_per_decode": engine.stats.sync_bytes_per_decode}
    del engine
    torch.cuda.empty_cache()
    return out


def mesh_step_check(torch, ca, config, params) -> dict:
    """The dp and sp meshes' engines on the full-width model against the tp2
    engine's, teacher-forced by its greedy tokens (``_mesh_engine_steps``):
    dp2 x tp2 in bf16, as it serves: the prefill and every step's logits
    bit-equal to tp2's; tp2 x sp2 on the exact-f32 path (f32 activations
    and cache, the embedding widened, the same packed weights, the Q40
    products' dots in f32: the CPU's parity path) beside tp2 on the same
    path: within SP_LOGITS_TOL of max|tp2|, the decode steps' attention
    through the stats form; the first step whose greedy token differs, with
    tp2's top-2 margin there, is printed."""
    import dataclasses

    from distributed_llama_multiusers_tpu_torch.ops import cuda_q40 as q
    from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan

    t0 = time.perf_counter()
    tp2 = _mesh_engine_steps(torch, config, params, MeshPlan(tp=2))
    feed = tp2["tokens"]
    dp = _mesh_engine_steps(torch, config, params, MeshPlan(dp=2, tp=2), feed=feed)
    for s, (a, b) in enumerate(zip(dp["logits"], tp2["logits"])):
        check(torch.equal(a, b), f"dp2 x tp2: logits of {'prefill' if s == 0 else f'step {s}'} "
                                 f"differ from tp2's (max|d| {float((a - b).abs().max()):.3e})")
    params32 = dataclasses.replace(params, embedding=params.embedding.float())
    dot_dtype = q.default_dot_dtype
    q.default_dot_dtype = lambda device: torch.float32  # the exact-f32 dots
    try:
        ref = _mesh_engine_steps(torch, config, params32, MeshPlan(tp=2), feed=feed,
                                 cache_dtype=torch.float32)
        before = ca.STATS_COUNTS["launches"]
        sp = _mesh_engine_steps(torch, config, params32, MeshPlan(tp=2, sp=2), feed=feed,
                                cache_dtype=torch.float32)
        stats_launches = ca.STATS_COUNTS["launches"] - before
    finally:
        q.default_dot_dtype = dot_dtype
    check(stats_launches == 2 * 2 * config.n_layers * MESH_STEPS,
          f"tp2 x sp2: {stats_launches} stats-form launches for {MESH_STEPS} steps, expected "
          f"{4 * config.n_layers * MESH_STEPS}")
    steps, first_diff = [], None
    for s, (a, b) in enumerate(zip(sp["logits"], ref["logits"])):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        steps.append({"max_abs_err": err, "max_abs_ref": scale})
        check(bool(torch.isfinite(a).all()) and err <= SP_LOGITS_TOL * scale,
              f"tp2 x sp2 (exact f32): {'prefill' if s == 0 else f'step {s}'} max|d| {err:.4e} "
              f"against {SP_LOGITS_TOL} x max|tp2| {scale:.4e}")
        if first_diff is None and not torch.equal(a.argmax(-1), b.argmax(-1)):
            top2 = torch.topk(b, 2, dim=-1).values
            lane = int((a.argmax(-1) != b.argmax(-1)).nonzero()[0])
            first_diff = {"step": s, "lane": MESH_BUSY[lane],
                          "top2_margin": float(top2[lane, 0] - top2[lane, 1])}
    out = {"steps": MESH_STEPS, "busy_lanes": list(MESH_BUSY),
           "dp2_tp2_bit_equal_tp2": True, "dp2_tp2_graphs": dp["graphs"],
           "sp_tol": SP_LOGITS_TOL, "sp_steps": steps,
           "sp_max_abs_err": max(x["max_abs_err"] for x in steps),
           "sp_first_greedy_difference": first_diff, "sp_stats_launches": stats_launches,
           "sp_graphs": sp["graphs"],
           "sync_bytes_per_decode": {"tp2": tp2["sync_bytes_per_decode"],
                                     "dp2_tp2": dp["sync_bytes_per_decode"],
                                     "tp2_sp2_f32": sp["sync_bytes_per_decode"]},
           "seconds": time.perf_counter() - t0}
    log("mesh decode steps: " + json.dumps(out))
    return out


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
    from distributed_llama_multiusers_tpu_torch.ops import cuda_attn as ca

    meshes = mesh_step_check(torch, ca, config, params)
    for b in breakdown + tp:
        del b["prefill_logits"]
    del params
    torch.cuda.empty_cache()
    return breakdown, tp, tp_logits, hop_step, products, prefix_bits, meshes


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
# Phase 4b: the paged KV cache (--paged-kv on)
# ---------------------------------------------------------------------------

PAGE = 64  # the pool's default page size (runtime/kvpool.DEFAULT_PAGE_SIZE)
PAGED_ARGS = ("--paged-kv", "on")
# the exhaustion and swap server: 40 pages (a request on a 1,900-token run
# reserves 30 to 32 pages of 64 slots), 4 parked sessions, a 256 MiB host tier
SWAP_POOL_PAGES = 40
SWAP_ARGS = (*PAGED_ARGS, "--kv-pool-pages", str(SWAP_POOL_PAGES), "--kv-max-parked", "4",
             "--kv-host-bytes", str(256 << 20))
PAGED_STEPS = 4  # decode and verify steps whose logits are compared


def paged_pool(torch, k, v, page: int, seed: int):
    """A contiguous cache [B, S, n_kv, hd] laid into a pool of ``page``-slot
    pages permuted at random from ``seed``, a page more for the scratch
    page: (k_pool, v_pool, int32 table [B, ceil(S / page)])."""
    b, slots = k.shape[:2]
    nb = -(-slots // page)
    perm = torch.randperm(b * nb, generator=torch.Generator().manual_seed(seed))
    table = perm.reshape(b, nb).to(device="cuda", dtype=torch.int32)
    pools = []
    for x in (k, v):
        rest = tuple(x.shape[2:])
        padded = torch.zeros((b, nb * page) + rest, dtype=x.dtype, device="cuda")
        padded[:, :slots] = x
        pool = torch.zeros((b * nb + 1, page) + rest, dtype=x.dtype, device="cuda")
        pool[table.reshape(-1).long()] = padded.reshape((b * nb, page) + rest)
        pools.append(pool)
    return pools[0], pools[1], table


def paged_attn_phase(torch, attn: dict) -> dict:
    """(a) The paged attention kernel at ``attn_phase``'s inputs (the
    serving decode step's shapes), the cache laid into 64-slot pages
    permuted at random: bit-equal to the contiguous kernel on the same slot
    contents at the serving positions, across the cache and the split and
    page boundaries, and for the 4-row verify window at the serving
    positions and at the cache's end; within ATTN_TOL of its plain version
    (the gather, then the plain attention). Then the paged and contiguous
    kernels timed in turns (contiguous, paged, paged, contiguous; one CUDA
    graph each), the plain version eager. The bound is the contiguous
    kernel's plus the table words the lanes' slots need; the library call
    is ``attn_phase``'s on the same slots."""
    from distributed_llama_multiusers_tpu_torch.ops import cuda_attn as ca

    lanes, n_kv, group, hd, s_len, split = DECODE_M, 8, 4, 64, ATTN_S_LEN, ca.SPLIT
    qf, k, v = attn_inputs(torch, n_kv)
    k_pool, v_pool, table = paged_pool(torch, k, v, PAGE, seed=5)
    scale = 1.0 / hd ** 0.5
    gen = torch.Generator(device="cuda").manual_seed(11)
    qw = torch.randn((lanes, ca.WINDOW, n_kv, group, hd), device="cuda", generator=gen)
    serving = attn_serving_positions(torch)
    serving_w = window_rows(torch, [40, 63, 64, 100] + [s_len] * 4)
    col = lambda xs: torch.tensor([[x] for x in xs], device="cuda")  # noqa: E731
    cases = {"serving": (qf, serving),
             "spread": (qf, col([0, 1, 63, 64, 1024, 2046, 2047, 2048])),
             "boundaries": (qf, col([split - 1, split, split + 1, PAGE - 1, PAGE, PAGE + 1,
                                     3 * split, s_len - 1])),
             "window_serving": (qw, serving_w),
             "window_at_end": (qw, window_rows(torch, [s_len - 1] * lanes))}
    ca.reset_counts()
    err, ref_max = 0.0, 0.0
    for name, (qq, pos) in cases.items():
        got = ca.decode_attention_paged(qq, k_pool, v_pool, table, pos, scale, s_len)
        check(torch.equal(got, ca.decode_attention(qq, k, v, pos, scale, s_len)),
              f"paged decode_attn [{name}]: differs from the contiguous kernel on the same slots")
        want = ca.decode_attention_paged_plain(qq, k_pool, v_pool, table, pos, scale, s_len)
        e, r = float((got - want).abs().max()), float(want.abs().max())
        check(bool(torch.isfinite(got).all()) and e <= ATTN_TOL * r,
              f"paged decode_attn [{name}]: max|d| {e:.3e} > {ATTN_TOL:.1e} x {r:.3e}")
        err, ref_max = max(err, e), max(ref_max, r)
    sync_all(torch)
    check(ca.PAGED_COUNTS["launches"] == len(cases),
          f"paged decode_attn: {ca.PAGED_COUNTS['launches']} paged launches for {len(cases)} calls")
    reps = 20
    calls = {
        "contiguous": lambda: ca.decode_attention(qf, k, v, serving, scale, s_len),
        "paged": lambda: ca.decode_attention_paged(qf, k_pool, v_pool, table, serving, scale,
                                                   s_len),
        "window_contiguous": lambda: ca.decode_attention(qw, k, v, serving_w, scale, s_len),
        "window_paged": lambda: ca.decode_attention_paged(qw, k_pool, v_pool, table, serving_w,
                                                          scale, s_len)}
    times: dict = {name: [] for name in calls}
    for kind in ("contiguous", "paged", "paged", "contiguous"):
        for prefix in ("", "window_"):
            times[prefix + kind].append(graph_ms(torch, [calls[prefix + kind]] * reps))
    ms = {name: statistics.mean(t) for name, t in times.items()}
    plain_ms = eager_ms(torch, lambda: ca.decode_attention_paged_plain(
        qf, k_pool, v_pool, table, serving, scale, s_len), 3)
    window_plain_ms = eager_ms(torch, lambda: ca.decode_attention_paged_plain(
        qw, k_pool, v_pool, table, serving_w, scale, s_len), 3)

    def table_bytes(pos):
        """The table words the lanes' slots lie in (each read once)."""
        last = pos.clamp(max=s_len - 1).max(dim=1).values  # a lane's furthest row
        return int((last // PAGE + 1).sum()) * 4

    def bound_of(base: dict, pos) -> dict:
        n_bytes = base["bound_bytes"] + table_bytes(pos)
        t_bytes, t_ops = n_bytes / HBM_BYTES_S, base["bound_ops"] / F32_OPS_S
        return {"bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_bytes": n_bytes, "bound_ops": base["bound_ops"]}

    w = attn["window"]
    out = {"page": PAGE, "pages": int(k_pool.shape[0]), "cases": list(cases),
           "max_abs_err": err, "max_abs_ref": ref_max, "tol": ATTN_TOL,
           "bit_equal_to_contiguous": True, "ms": ms["paged"],
           "contiguous_ms": ms["contiguous"], "ms_turns": times,
           "plain_ms": plain_ms, "library_ms": attn["library_ms"], **bound_of(attn, serving),
           "window": {"ms": ms["window_paged"], "contiguous_ms": ms["window_contiguous"],
                      "plain_ms": window_plain_ms, "library_ms": w["library_ms"],
                      **bound_of(w, serving_w)}}
    log("paged decode_attn: " + json.dumps(out))
    return out


def paged_step_check(torch, q, rc, cs, config, params, mesh=None, label: str = "v4",
                     steps: int = 10, export_tokens=None) -> dict:
    """(b) Two engines on the full-width model in v4, contiguous and
    ``paged_kv`` (the pool's default 64-slot pages; with ``mesh``, tensor
    parallel on its ranks), the same 4 of 8 lanes prefilled (each paged
    lane admitted first), the others parked past the cache: the prefill
    logits, then PAGED_STEPS decode steps replayed from the graphs, as many
    run eagerly, and as many verify steps (from their graphs) give the same
    bits on every live lane and the same tokens. Then each engine's decode
    step measured as ``step_breakdown`` measures it, in turns (contiguous,
    paged, paged, contiguous): host clock, device time and device
    operations per step. ``export_tokens``: then a free lane of the paged
    engine prefills them and its whole pages are exported (``export``: each
    page's sha256 and the ms an export takes), the reference of the paged
    pod's export (``pod_export_check``)."""
    import numpy as np

    from distributed_llama_multiusers_tpu_torch.parallel.sharding import shard_params
    from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine

    lanes, busy = DECODE_M, 4
    q.set_dequant_mode("v4")
    try:
        weights = params if mesh is None else shard_params(params, mesh)
        engines = {name: InferenceEngine(config, weights, n_lanes=lanes, device="cuda",
                                         mesh=mesh, paged_kv=name == "paged")
                   for name in ("contiguous", "paged")}
        temps = np.array([0.0, 0.8] * (lanes // 2), np.float32)
        temps[busy:] = 0.0
        seeds = np.arange(lanes, dtype=np.uint32)
        state, firsts = {}, {}
        for name, eng in engines.items():
            tokens = np.zeros(lanes, np.int64)
            positions = np.full(lanes, config.seq_len, np.int64)
            for lane in range(busy):
                prompt = [(97 * lane + 13 * i) % 100 + 1 for i in range(40)]
                if name == "paged":
                    eng.paged_admit(lane, prompt, config.seq_len)
                last, tokens[lane], positions[lane] = eng.prefill(lane, prompt)
                firsts.setdefault(name, []).append(last.float().clone())
            eng.capture_graphs(spec=True)
            state[name] = (tokens, positions)
        check(all(torch.equal(a, b) for a, b in zip(firsts["contiguous"], firsts["paged"])),
              f"paged step [{label}]: prefill logits differ from the contiguous engine's")

        def decode(name, want_logits=True):
            eng, (tokens, positions) = engines[name], state[name]
            logits, greedy, sampled = eng.decode(tokens, positions, temps, seeds=seeds,
                                                 want_logits=want_logits)
            tokens[:busy] = np.where(temps[:busy] > 0, sampled[:busy], greedy[:busy])
            positions[:busy] += 1
            return None if logits is None else logits[:busy], tokens[:busy].copy()

        def verify(name):
            eng, (tokens, positions) = engines[name], state[name]
            drafts = np.repeat(tokens[:, None], eng.SPEC_DRAFT, axis=1)
            dlen = np.where(temps == 0, eng.SPEC_DRAFT, 0)
            dlen[busy:] = 0
            logits, emitted, n_emit = eng.decode_spec(tokens, drafts, dlen, positions, temps,
                                                      seeds=seeds)
            idx = np.arange(busy)
            tokens[:busy] = emitted[idx, n_emit[:busy] - 1]
            positions[:busy] += n_emit[:busy]
            return logits[:busy], emitted[:busy].copy()

        compared = {}
        for how in ("graph", "eager", "verify"):
            saved = {}
            if how == "eager":  # the bodies the graphs captured
                saved = {n: e.graphs for n, e in engines.items()}
                for e in engines.values():
                    e.graphs = None
            try:
                for step in range(PAGED_STEPS):
                    run = verify if how == "verify" else decode
                    (la, ta), (lb, tb) = run("contiguous"), run("paged")
                    check(torch.equal(la, lb) and (ta == tb).all(),
                          f"paged step [{label}, {how}]: step {step}'s logits or tokens "
                          "differ from the contiguous engine's")
            finally:
                for n, g in saved.items():
                    engines[n].graphs = g
            compared[how] = PAGED_STEPS
        check(all(e.graphs is None or e.graphs.replays > 0 for e in engines.values()),
              f"paged step [{label}]: the graphs never replayed")
        runs: dict = {"contiguous": [], "paged": []}
        for name in ("contiguous", "paged", "paged", "contiguous"):
            runs[name].append(_measure_steps(torch, q, rc, cs, lambda n=name: decode(n, False),
                                             steps, f"{label}, {name}"))
        for name, measured in runs.items():
            paged_per_step = [m["launches_per_step"]["decode_attn_paged"] for m in measured]
            want = config.n_layers * len(engines[name].devices) if name == "paged" else 0
            check(all(n == want for n in paged_per_step),
                  f"paged step [{label}, {name}]: {paged_per_step} paged attention launches "
                  f"per step, expected {want}")
        keys = ("step_ms_p50", "device_ms_per_step", "device_ops_per_step",
                "decode_attn_ms_per_step", "q40_kernels_ms_per_step", "fill_ms_per_step")
        out = {"label": label, "ranks": [str(d) for d in engines["paged"].devices],
               "lanes": lanes, "busy_lanes": busy, "page": engines["paged"].kvpool.page_size,
               "steps_compared": compared, "logits_bit_equal": True,
               **{name: {k: statistics.mean(m[k] for m in measured) for k in keys}
                  for name, measured in runs.items()},
               "launches_per_step": {name: measured[0]["launches_per_step"]
                                     for name, measured in runs.items()},
               "turns": {name: [{k: m[k] for k in keys} for m in measured]
                         for name, measured in runs.items()}}
        log(f"paged step [{label}]: prefill, {PAGED_STEPS} graph, {PAGED_STEPS} eager and "
            f"{PAGED_STEPS} verify steps bit-equal to the contiguous engine's; "
            + json.dumps({k: out[k] for k in ("contiguous", "paged")}))
        if export_tokens is not None:
            eng = engines["paged"]
            lane = lanes - 1  # parked past the cache until now
            eng.paged_admit(lane, export_tokens, len(export_tokens) + 1)
            eng.prefill(lane, export_tokens)
            pages = eng.kvpool.lane_blocks(lane)[:len(export_tokens) // eng.kvpool.page_size]
            eng.export_kv_page(pages[0])
            sync_all(torch)
            t0 = time.perf_counter()
            payloads = [eng.export_kv_page(pg) for pg in pages]
            out["export"] = {"sha256": [hashlib.sha256(b).hexdigest() for b in payloads],
                             "page_bytes": len(payloads[0]),
                             "export_ms_per_page": (time.perf_counter() - t0) * 1e3 / len(pages)}
            log(f"paged step [{label}]: {len(pages)} pages of a {len(export_tokens)}-token "
                f"prompt exported, {out['export']['export_ms_per_page']:.3f} ms a page")
        del engines
        torch.cuda.empty_cache()
        return out
    finally:
        q.set_dequant_mode(None)


def paged_prefix_check(base: str) -> dict:
    """(d) On the paged default server: a request on the 1,900-token run
    after a first one takes 1,024 tokens (the largest prefill bucket's
    whole chunks, 16 pages) from the tree copy-free (no copy-on-write), and
    a request of the same length sharing nothing gives the cold TTFT."""
    from distributed_llama_multiusers_tpu_torch.runtime.engine import DEFAULT_PREFILL_BUCKETS

    status, _, body = _json_call(base, "/v1/completions",
                                 {**PREFIX_BODY, "prompt": "a" * SPEC_RUN + " first",
                                  "max_tokens": 8})
    check(status == 200, f"paged prefix: the first request failed: {body}")
    before = _json_call(base, "/stats")[2]
    warm = prefix_request(base, "paged tree")
    after = _json_call(base, "/stats")[2]
    # the same length on another run: nothing to share
    status, _, body = _json_call(base, "/v1/completions",
                                 {**PREFIX_BODY, "prompt": "b" * SPEC_RUN + " second"})
    check(status == 200 and body["summary"]["prefix_tokens_saved"] == 0,
          f"paged prefix: the cold request: {status} {body.get('summary')}")
    cold = {"ttft_ms": body["summary"]["ttft_s"] * 1e3}
    chunk = DEFAULT_PREFILL_BUCKETS[-1]
    check(warm["prefix_tokens_saved"] == chunk
          and after["pool_prefix_admits"] == before["pool_prefix_admits"] + 1
          and after["pool_cow_copies"] == 0,
          f"paged prefix: {warm['prefix_tokens_saved']} tokens shared (expected {chunk}), "
          f"prefix admits {before['pool_prefix_admits']} -> {after['pool_prefix_admits']}, "
          f"{after['pool_cow_copies']} copy-on-write pages")
    return {"warm": warm, "cold_same_length": cold,
            "shared_pages": warm["prefix_tokens_saved"] // PAGE,
            "pool_cow_copies": after["pool_cow_copies"]}


def _metric_value(base: str, name: str, labels: str) -> float | None:
    for line in _http(base + "/metrics")[1].decode().splitlines():
        if line.startswith(f"{name}{{{labels}}} "):
            return float(line.rsplit(" ", 1)[1])
    return None


def swap_exhaust_check(model: str, tok: str) -> dict:
    """(f) then (e) on one server with a pool of SWAP_POOL_PAGES pages, 4
    parked sessions and a 256 MiB host tier (v4 defaults otherwise). (f) X
    on the 1,900-token run parks its pages; Y on another run needs them, so
    X's pages swap to the host tier; X again swaps its whole chunks back in
    (Y's pages swapping out in turn), its stream byte-identical to the
    first X's, with its swap time on its summary; ``swap_ins`` and
    ``swap_outs`` on /stats equal ``dllama_kv_swap_total`` by direction.
    (e) A on a third run holds 32 pages decoding 256 tokens while B on a
    fourth asks for 30 of the 8 left: B gets 429 with ``Retry-After`` and
    reason ``pool_exhausted``; A finishes, and a request streamed after it
    completes."""
    srv = Server(model, tok, "paged-swap", SWAP_ARGS)
    base = srv.base
    try:
        def run(prompt, max_tokens=8):
            status, _, body = _json_call(base, "/v1/completions",
                                         {"prompt": prompt, "max_tokens": max_tokens,
                                          "temperature": 0})
            check(status == 200, f"paged swap: {status} {body}")
            return body

        x, y = "a" * SPEC_RUN + " first", "b" * SPEC_RUN + " other"
        first = run(x)
        s1 = srv.stats()
        run(y)
        s2 = srv.stats()
        again = run(x)
        s3 = srv.stats()
        check(_text(again) == _text(first),
              f"paged swap: the swapped-in stream differs:\n{_text(first)!r}\n{_text(again)!r}")
        check(s1["pool_parked_sessions"] == 1 and s2["swap_outs"] > 0
              and s3["swap_ins"] > 0 and s3["pool_swap_in_admits"] == 1
              and s3["swap_outs"] > s2["swap_outs"] and s3["pool_swap_pending"] == 0,
              f"paged swap: parked {s1['pool_parked_sessions']}, swap_outs "
              f"{s2['swap_outs']} -> {s3['swap_outs']}, swap_ins {s3['swap_ins']}, swap-in "
              f"admits {s3['pool_swap_in_admits']}")
        phases = again["summary"]["phases"]
        check(phases["swap_in_ms"] > 0 and again["summary"]["prefix_tokens_saved"] == 1024,
              f"paged swap: the swapped-in request's summary {again['summary']}")
        metric = {d: _metric_value(base, "dllama_kv_swap_total", f'direction="{d}"')
                  for d in ("in", "out")}
        check(metric == {"in": s3["swap_ins"], "out": s3["swap_outs"]},
              f"paged swap: dllama_kv_swap_total {metric} against /stats swap_ins "
              f"{s3['swap_ins']}, swap_outs {s3['swap_outs']}")
        page_bytes = s3["swap_out_bytes"] / s3["swap_outs"]

        # (e) exhaustion
        held: list = [None]

        def hold():
            held[0] = _json_call(base, "/v1/completions",
                                 {"prompt": "c" * SPEC_RUN, "max_tokens": 256,
                                  "temperature": 0})

        t = threading.Thread(target=hold)
        t.start()
        total = _load(base)["lanes_total"]
        _poll(lambda: _load(base)["lanes_free"] == total - 1, 60,
              "paged exhaustion: the holder never took a lane")
        load = _load(base)
        status, hdrs, body = _json_call(base, "/v1/completions",
                                        {"prompt": "d" * SPEC_RUN, "max_tokens": 8,
                                         "temperature": 0})
        t.join(timeout=600)
        check(status == 429 and body.get("reason") == "pool_exhausted"
              and int(hdrs.get("Retry-After", 0)) >= 1,
              f"paged exhaustion: {status} {hdrs.get('Retry-After')} {body}")
        check(held[0] is not None and held[0][0] == 200
              and held[0][2]["usage"]["completion_tokens"] >= 1,
              f"paged exhaustion: the holder did not finish: {held[0]}")
        sstatus, text, last, deltas = _stream(base + "/v1/completions",
                                              {"prompt": "after the shed", "max_tokens": 16,
                                               "temperature": 0})
        check(sstatus == 200 and deltas >= 1 and last["choices"][0].get("finish_reason"),
              f"paged exhaustion: the request after the shed: {sstatus} {deltas}")
        s4 = srv.stats()
        check(s4["pool_exhausted_sheds"] == 1 and load["pool_pages_total"] == SWAP_POOL_PAGES,
              f"paged exhaustion: {s4['pool_exhausted_sheds']} sheds, /load {load}")
        check("Paged KV: 40 pages x 64 tokens" in srv.stop(),
              "paged swap: the startup log does not announce the pool")
        out = {"swap_outs": s3["swap_outs"], "swap_ins": s3["swap_ins"],
               "swap_in_ms": s3["swap_in_ms"], "swap_out_bytes": s3["swap_out_bytes"],
               "page_bytes": page_bytes, "swap_in_ms_per_page": s3["swap_in_ms"] / s3["swap_ins"],
               "request_swap_in_ms": phases["swap_in_ms"],
               "ttft_ms_first": first["summary"]["ttft_s"] * 1e3,
               "ttft_ms_swapped_in": again["summary"]["ttft_s"] * 1e3,
               "kv_swap_total": metric, "shed": {"status": status, "reason": body.get("reason"),
                                                 "retry_after": hdrs.get("Retry-After")},
               "load_during_shed": load, "pool": {k: v for k, v in s4.items()
                                                  if k.startswith(("pool_", "swap_"))}}
        log("paged swap and exhaustion: " + json.dumps(
            {k: v for k, v in out.items() if k != "pool"}))
        return out
    except BaseException:
        srv.tail()
        raise
    finally:
        srv.kill()


def swap_page_ms(torch, config, params, pages: int = 16) -> dict:
    """Swap-out and swap-in ms per page on the card: ``pages`` pages of a
    paged engine on the full-width model read to host bytes
    (``swap_out_pages``, a host sync) and written back (``swap_in_pages``,
    synchronized), bytes equal after the round trip."""
    from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine

    eng = InferenceEngine(config, params, n_lanes=DECODE_M, device="cuda", paged_kv=True)
    ids = list(range(pages))
    for c in (eng.cache,):
        c.k[:, :pages].normal_()
        c.v[:, :pages].normal_()
    eng.swap_out_pages(ids)
    sync_all(torch)
    t0 = time.perf_counter()
    payloads = eng.swap_out_pages(ids)
    out_ms = (time.perf_counter() - t0) * 1e3 / pages
    eng.cache.k[:, :pages].zero_()
    eng.cache.v[:, :pages].zero_()
    sync_all(torch)
    t0 = time.perf_counter()
    eng.swap_in_pages(ids, payloads)
    sync_all(torch)
    in_ms = (time.perf_counter() - t0) * 1e3 / pages
    check(eng.swap_out_pages(ids) == payloads, "swap: the pages' bytes changed in a round trip")
    out = {"pages": pages, "page_bytes": len(payloads[0]), "swap_out_ms_per_page": out_ms,
           "swap_in_ms_per_page": in_ms}
    del eng
    torch.cuda.empty_cache()
    log("paged swap (engine, full width): " + json.dumps(out))
    return out


def paged_phase(torch, q, rc, cs, model: str, tok: str, default: dict, layers: dict,
                attn: dict) -> dict:
    """The paged KV cache on the card: (a) the paged attention kernel;
    (b) the paged decode and verify steps against the contiguous ones, at
    one rank and at tp=2 on the host's cards; the swap tier's ms per page;
    (c) a ``dllama_api --paged-kv on`` default pass, its streams (2 greedy, 2
    seeded, alone and concurrent) byte-identical to the contiguous default
    pass's, 0 graphs captured after warmup, with (d) the shared prompt;
    (e) and (f) on a server with a small pool and the host tier."""
    from distributed_llama_multiusers_tpu_torch.formats import load_model_header
    from distributed_llama_multiusers_tpu_torch.models import load_params_from_m_quantized
    from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh

    t0 = time.perf_counter()
    out = {"attn": paged_attn_phase(torch, attn)}
    config, params = load_params_from_m_quantized(model, load_model_header(model),
                                                  dtype=torch.bfloat16, device="cuda")
    out["step"] = paged_step_check(torch, q, rc, cs, config, params)
    from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer

    mesh = make_mesh(MeshPlan(tp=2), rank_devices(torch, 2))
    # the server's encoding of a completion prompt
    export_tokens = Tokenizer(tok).encode(POD_EXPORT_PROMPT, add_bos=True,
                                          add_special_tokens=True)
    out["tp2_step"] = paged_step_check(torch, q, rc, cs, config, params, mesh=mesh,
                                       label="tp2 v4", steps=5, export_tokens=export_tokens)
    out["swap_engine"] = swap_page_ms(torch, config, params)
    out["f8_step"] = f8_step_check(torch, q, config, params)
    del params
    torch.cuda.empty_cache()

    p = serve_pass(model, tok, None, GEN_TOKENS, extra_args=PAGED_ARGS, alone=True,
                   name="v4-paged", extra=paged_prefix_check)
    check_serving_paths(p)
    check(p["jit_compiles_after_warmup"] == 0 and p["decode_attn_paged_launches"] > 0
          and p["pool"].get("pool_pages_in_use") == 0,
          f"v4-paged: {p['jit_compiles_after_warmup']} graphs captured after warmup, "
          f"{p['decode_attn_paged_launches']} paged attention launches, pool {p['pool']}")
    check("Paged KV: 256 pages x 64 tokens" in p["log"],
          "v4-paged: the startup log does not announce the pool")
    for how in ("alone", "concurrent"):
        for i, (a, b) in enumerate(zip(default[f"{how}_texts"], p[f"{how}_texts"])):
            check(a == b, f"request {i} {how}: the paged stream differs from the contiguous "
                          f"default pass's:\n{a!r}\n{b!r}")
    check(default["greedy_text"] == p["greedy_text"], "v4-paged: greedy text differs")
    prefix = p["extra"]
    check(prefix["warm"]["text"] == layers["prefix_warm"]["text"]
          == layers["watchdog"]["cold"]["text"],
          "paged prefix: the tree hit's stream differs from the cold one")
    log(f"v4-paged pass: streams byte-identical to the contiguous default pass (alone and "
        f"concurrent); batch {p['tokens_per_s_batch']:.1f} tok/s against "
        f"{default['tokens_per_s_batch']:.1f}, TTFT p50 {p['ttft_ms_p50']:.1f} ms against "
        f"{default['ttft_ms_p50']:.1f} ms; tree hit TTFT {prefix['warm']['ttft_ms']:.1f} ms "
        f"against {prefix['cold_same_length']['ttft_ms']:.1f} ms cold")
    out["serving"] = p
    out["swap"] = swap_exhaust_check(model, tok)
    out["seconds"] = time.perf_counter() - t0
    log(f"paged phase: {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# The f8 KV cache (--kv-dtype f8) on the card
# ---------------------------------------------------------------------------

F8_ARGS = ("--kv-dtype", "f8")
# the JAX package's own tolerance for logits over an f8 cache against a
# full-precision one (its tests/test_engine.py): e4m3 keeps 3 mantissa bits,
# so every cached K and V value moves by up to 1/16 of itself, and the
# attention and the logits move with them
F8_LOGIT_ATOL, F8_LOGIT_RTOL = 0.5, 0.1


def kv_bytes_per_lane(config, itemsize: int) -> int:
    """A contiguous lane's K and V planes: every layer, seq_len + 1 slots."""
    return 2 * config.n_layers * (config.seq_len + 1) * config.n_kv_heads * config.head_size \
        * itemsize


def f8_step_check(torch, q, config, params) -> dict:
    """Two engines on the full-width model in v4, one with a bf16 cache and
    one with an e4m3 cache, the same 4 of 8 lanes prefilled (the others
    parked past the cache). First as they stand (each cache written by its
    own prefill): the logits of one decode step replayed from its graph
    are printed, not held (the e4m3 rounding of every cached value
    compounds over 16 layers). Then on the same state: both caches set to
    the bf16 engine's, rounded to e4m3 (``_to_cache_dtype``), so both
    attentions read the same values (the e4m3 kernel equals the bf16 one
    on a cache widened to bf16) and the steps differ only by the e4m3
    rounding of each layer's fresh K/V row: that step's logits within
    F8_LOGIT_ATOL + F8_LOGIT_RTOL x |bf16| on every live lane (the e4m3
    attention launched in it). The KV bytes a lane of each."""
    import numpy as np

    from distributed_llama_multiusers_tpu_torch.models.llama import F8, _to_cache_dtype, cache_bits
    from distributed_llama_multiusers_tpu_torch.ops import cuda_attn as ca
    from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine

    lanes, busy = DECODE_M, 4
    q.set_dequant_mode("v4")
    try:
        engines = {name: InferenceEngine(config, params, n_lanes=lanes, device="cuda",
                                         cache_dtype=dt)
                   for name, dt in (("bf16", torch.bfloat16), ("f8", F8))}
        tokens = np.zeros(lanes, np.int64)
        positions = np.full(lanes, config.seq_len, np.int64)
        for eng in engines.values():
            for lane in range(busy):
                prompt = [(97 * lane + 13 * i) % 100 + 1 for i in range(40)]
                _, tokens[lane], positions[lane] = eng.prefill(lane, prompt)
            eng.capture_graphs()

        def step() -> dict:
            out = {}
            for name, eng in engines.items():
                f8_before = ca.F8_COUNTS["launches"]
                logits, greedy, _ = eng.decode(tokens, positions)
                out[name] = (logits[:busy].float().cpu().numpy(), np.asarray(greedy)[:busy],
                             ca.F8_COUNTS["launches"] - f8_before)
            return out

        own = step()
        # the same state: both caches the bf16 engine's, rounded to e4m3
        # (the step above wrote only each lane's next slot, which the step
        # below writes again before it reads it)
        for plane in ("k", "v"):
            rounded = _to_cache_dtype(getattr(engines["bf16"].cache, plane), F8)
            cache_bits(getattr(engines["f8"].cache, plane)).copy_(cache_bits(rounded))
            getattr(engines["bf16"].cache, plane).copy_(rounded.to(torch.bfloat16))
        same = step()
        kv = {name: kv_bytes_per_lane(config, eng.cache.k.element_size())
              for name, eng in engines.items()}
        del engines
        torch.cuda.empty_cache()
    finally:
        q.set_dequant_mode(None)

    def diff(res):
        a, b = res["f8"][0], res["bf16"][0]
        return {"max_abs_diff": float(np.abs(a - b).max()), "max_abs_bf16": float(np.abs(b).max()),
                "rel_diff": float(np.abs(a - b).max() / np.abs(b).max()),
                "greedy_agree": int((res["f8"][1] == res["bf16"][1]).sum()),
                "f8_launches_in_step": res["f8"][2]}

    a, b = same["f8"][0], same["bf16"][0]
    check(bool(np.isfinite(a).all()), "f8 step: logits not finite")
    over = np.abs(a - b) > F8_LOGIT_ATOL + F8_LOGIT_RTOL * np.abs(b)
    check(not over.any(), f"f8 step (same state): {int(over.sum())} logits past "
                          f"{F8_LOGIT_ATOL} + {F8_LOGIT_RTOL} x |bf16| (max|d| "
                          f"{float(np.abs(a - b).max()):.4f})")
    check(same["f8"][2] > 0 and same["bf16"][2] == 0 and own["f8"][2] > 0,
          f"f8 step: {same['f8'][2]} e4m3 attention launches in the f8 step")
    check(kv["f8"] * 2 == kv["bf16"], "f8 step: an e4m3 lane is not half a bf16 lane")
    res = {"lanes_compared": busy, "same_state": diff(same), "own_prefill": diff(own),
           "tol": f"{F8_LOGIT_ATOL} + {F8_LOGIT_RTOL} x |bf16| (same state)",
           "kv_bytes_per_lane": kv}
    log("f8 step (engine, full width): " + json.dumps(res))
    return res


def f8_phase(model: str, tok: str) -> dict:
    """``dllama_api --kv-dtype f8`` under the defaults and once with
    ``--paged-kv on``, each with the default pass's 4 requests (2 greedy,
    2 seeded), concurrent and then each alone: the alone and the
    concurrent texts byte-identical, the serving paths of the defaults, 0
    graphs captured after warmup, every attention launch the e4m3
    instantiation's, the KV line of the startup log. Nothing is compared
    with a bf16 server's streams: an e4m3 cache may part from them."""
    t0 = time.perf_counter()
    specs = (("v4-f8", F8_ARGS), ("v4-f8-paged", F8_ARGS + PAGED_ARGS))
    servers = start_servers(model, tok, specs)
    try:
        passes = [_f8_pass(model, tok, name, extra, srv)
                  for (name, extra), srv in zip(specs, servers)]
    finally:
        for srv in servers:
            srv.kill()
    return {"passes": passes, "seconds": time.perf_counter() - t0}


def _f8_pass(model: str, tok: str, name: str, extra: tuple, srv) -> dict:
    """One f8 pass on ``srv`` (started with ``extra``), checked."""
    p = serve_pass(model, tok, None, GEN_TOKENS, extra_args=extra, alone=True, name=name,
                   srv=srv)
    check_serving_paths(p)
    for i, (a, b) in enumerate(zip(p["alone_texts"], p["concurrent_texts"])):
        check(a == b, f"{name}: request {i} alone differs from the 4 concurrent:\n"
                      f"{a!r}\n{b!r}")
    check(p["jit_compiles_after_warmup"] == 0, f"{name}: {p['jit_compiles_after_warmup']} "
                                               "graphs captured after warmup")
    check(p["decode_attn_f8_launches"] > 0
          and p["decode_attn_f8_launches"] == p["decode_attn_launches"],
          f"{name}: {p['decode_attn_f8_launches']} e4m3 attention launches of "
          f"{p['decode_attn_launches']}")
    kv = re.search(r"KV cache: f8 \(torch.float8_e4m3fn\), (\d+) bytes a token, "
                   r"([0-9.]+) MiB a lane", p["log"])
    check(kv is not None, f"{name}: the startup log lacks the KV cache line")
    p["kv_bytes_per_token"] = int(kv.group(1))
    if "paged" in name:
        check(p["decode_attn_paged_launches"] > 0, f"{name}: no paged attention launch")
    log(f"{name} pass: streams alone = concurrent (2 greedy, 2 seeded), "
        f"{p['decode_attn_f8_launches']} e4m3 attention launches, "
        f"{p['kv_bytes_per_token']} KV bytes a token ({kv.group(2)} MiB a lane; bf16: "
        f"{2 * p['kv_bytes_per_token']}), batch {p['tokens_per_s_batch']:.1f} tok/s, "
        f"TTFT p50 {p['ttft_ms_p50']:.1f} ms")
    return p


# ---------------------------------------------------------------------------
# Phase 4c: structured output (grammar-constrained decoding) on the card
# ---------------------------------------------------------------------------

G_OBJECT = {"type": "json_object"}
G_FLAGS = {"type": "json_schema", "json_schema": {"name": "flags", "schema": {
    "type": "object",
    "properties": {"ok": {"type": "boolean"}, "mood": {"enum": ["a", "b"]},
                   "n": {"type": "null"}},
    "required": ["ok", "mood", "n"]}}}
G_ENUM = {"type": "json_schema", "json_schema": {"schema": {"enum": ["happy", "sad", 3]}}}
G_PAIR = {"type": "json_schema", "json_schema": {"schema": {
    "type": "object",
    "properties": {"color": {"enum": ["red", "green", "blue"]}, "big": {"type": "boolean"}},
    "required": ["color", "big"]}}}
# one legal token a step for a few hundred steps, whatever the model: the
# request that holds its schema live in the small slab
G_LONG_TEXT = "structured output " * 4
G_LONG = {"type": "json_schema", "json_schema": {"schema": {"enum": [G_LONG_TEXT]}}}
G_SCHEMAS = {"json_object": G_OBJECT, "flags": G_FLAGS, "enum": G_ENUM, "pair": G_PAIR,
             "long": G_LONG}
# the masked argmax's edge vocabularies: one entry, under one word and just
# over it (fewer entries than 4 a cluster block: empty slices), a multiple
# of 4 in short slices, no multiple of 4 (the scalar loads), a
# 151,936-entry vocabulary
G_EDGE_VOCABS = (1, 31, 33, 1000, 2049, 151936)
# the automaton step's edge tables: one search round up to 256 keys, two up
# to 65,536, three past it
G_EDGE_COUNTS = (1, 255, 256, 257, 49152, 65537)
G_WINDOW = DECODE_M * 4  # a verify step's rows at 8 lanes (SPEC_DRAFT + 1 a lane)
# the engine check's lanes: json_object and flags, greedy and sampled, then
# four free lanes
G_LANE_RF = ("json_object", "json_object", "flags", "flags", None, None, None, None)
G_TEMPS = (0.0, 0.8, 0.0, 0.8, 0.0, 0.8, 0.0, 0.8)
G_SERVE_BODIES = [
    ("/v1/completions", {"prompt": "fill the flags", "max_tokens": 96, "temperature": 0,
                         "response_format": G_FLAGS}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "pick a mood"}],
                              "max_tokens": 96, "temperature": 0.8, "seed": 5,
                              "response_format": G_FLAGS}),
    ("/v1/completions", {"prompt": "one word", "max_tokens": 32, "temperature": 0,
                         "response_format": G_ENUM}),
    ("/v1/completions", {"prompt": "a color", "max_tokens": 96, "temperature": 0.7, "seed": 9,
                         "response_format": G_PAIR}),
]


def _conforms(rf: dict, obj) -> bool:
    """A parsed answer is what its schema allows."""
    if rf is G_FLAGS:
        return (isinstance(obj, dict) and set(obj) == {"ok", "mood", "n"}
                and isinstance(obj["ok"], bool) and obj["mood"] in ("a", "b")
                and obj["n"] is None)
    if rf is G_ENUM:
        return obj in ("happy", "sad") or (obj == 3 and not isinstance(obj, bool))
    if rf is G_PAIR:
        return (isinstance(obj, dict) and set(obj) == {"color", "big"}
                and obj["color"] in ("red", "green", "blue") and isinstance(obj["big"], bool))
    if rf is G_LONG:
        return obj == G_LONG_TEXT
    return isinstance(obj, dict)


def grammar_table(tok: str):
    """The tokenizer's piece table as ``runtime_setup`` registers it (special
    tokens, from bos_id up, None) and its EOS ids."""
    from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer

    t = Tokenizer(tok)
    return ([t.vocab[i] if i < t.bos_id else None for i in range(t.vocab_size)],
            list(t.eos_token_ids))


def grammar_tokenizer() -> str:
    """The 1B synthetic tokenizer, written as ``ensure_model`` writes the
    served model's (``write_synthetic_tokenizer`` at its vocabulary), beside
    the smoke's outputs: the grammar kernels' phase runs on it while the
    model's weights are still being written."""
    from distributed_llama_multiusers_tpu_torch.formats.synthetic import (
        write_synthetic_tokenizer,
    )

    path = os.path.join(OUT_DIR, "grammar_tokenizer.t")
    write_synthetic_tokenizer(path, vocab_size=llama32_1b_header().vocab_size)
    return path


def _bits_err(torch, got, want) -> float:
    """max |got - want| over the entries whose bits differ (inf where only
    one side is infinite or NaN); 0 when every bit agrees."""
    diff = got.view(torch.int32) != want.view(torch.int32)
    if not bool(diff.any()):
        return 0.0
    return float((got[diff] - want[diff]).abs().nan_to_num(nan=math.inf).max())


def _grammar_edge_tables(torch, vocab: int, seed: int):
    """Random mask words for 16 states: state 0 all ones (FREE), state 1 one
    legal token (the last), state 2 none."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = -(-vocab // 32)
    masks = rng.integers(0, 2**32, (16, words), dtype=np.uint64).astype(np.uint32)
    masks[0] = 0xFFFFFFFF
    masks[1:3] = 0
    masks[1, (vocab - 1) >> 5] = np.uint32(1 << ((vocab - 1) & 31))
    return torch.from_numpy(masks.view(np.int32)).cuda()


def grammar_kernel_phase(torch, cg, table, eos) -> dict:
    """The two grammar kernels on the card at the 1B vocabulary, with four
    schemas compiled against the 1B synthetic tokenizer and installed in a
    default slab (their compile time, first and cached, on this host):
    ``grammar_mask_argmax`` at 8 x 128,256 (a decode step) and 32 x 128,256
    (a verify window, the masked first row of each lane written) on random
    states, 0 included: indices equal to the plain version's and masked rows
    bit-equal; FREE rows' indices equal to ``torch.argmax``'s. At the edge
    vocabularies on tables with a one-token state and an empty one, with
    ties, -inf, -0.0, all -inf and NaN rows: the same, exactly.
    ``grammar_next`` on random (state, token) pairs (half legal, half not)
    one step and walked over 3 tokens, and walked over 4 tokens on edge
    tables of G_EDGE_COUNTS keys: the plain version's states exactly. The
    masked argmax's checks also run on rows off a 16-byte boundary (the
    scalar loads). Then each timed beside its plain version and its
    library calls (the torch pair where + argmax; searchsorted, the index
    and where), the masked argmax with and without the masked rows and on
    the verify window, the step at T = 1 and walked over T = 4, each beside
    its bound and the launch floor (a one-element op in the same
    harness)."""
    import numpy as np

    from distributed_llama_multiusers_tpu_torch.grammar import GrammarSlab, compile_automaton
    from distributed_llama_multiusers_tpu_torch.grammar.automaton import vocab_fingerprint

    vocab = len(table)
    # an admission compiles under the vocab key the engine took once at
    # grammar_init, as here
    t0 = time.perf_counter()
    key = vocab_fingerprint(table)
    compiles = {"vocab_fingerprint_s": time.perf_counter() - t0}
    autos = {}
    for name, rf in G_SCHEMAS.items():
        t0 = time.perf_counter()
        autos[name] = compile_automaton(rf, table, eos, vocab_key=key)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        compile_automaton(rf, table, eos, vocab_key=key)
        compiles[name] = {"states": autos[name].n_states, "edges": len(autos[name].edge_keys),
                          "first_s": first, "cached_s": time.perf_counter() - t0}
    log("grammar compiles at the 1B vocabulary (host): " + json.dumps(compiles))
    slab = GrammarSlab(vocab)
    handles = [slab.attach(autos[k]) for k in ("json_object", "flags", "enum", "pair")]
    masks_np, keys_np, nxt_np, dflt_np = slab.arrays()
    masks = torch.from_numpy(masks_np.view(np.int32)).cuda()
    keys, nxt, dflt = (torch.from_numpy(a).cuda() for a in (keys_np, nxt_np, dflt_np))
    words = masks.shape[1]
    rng = np.random.default_rng(15)
    pool = np.asarray([0] + [h.base + s for h in handles for s in range(h.automaton.n_states)])
    gen = torch.Generator(device="cuda").manual_seed(15)
    checks, inputs = [], {}
    a_err = 0.0  # the largest index or masked-row difference from the plain version
    for n, every in ((DECODE_M, 1), (G_WINDOW, 4)):
        x = torch.randn((n, vocab), device="cuda", generator=gen) * 3
        x[1, 5] = x[1, vocab - 9] = x[1].max() + 1.0  # a tie: the lower index wins
        st_np = rng.choice(pool, n)
        st_np[:3] = [0, 0, handles[1].start_state]
        st = torch.from_numpy(st_np).cuda()
        out = torch.empty((-(-n // every), vocab), device="cuda")
        want, wrows = cg.mask_argmax_plain(x, st, masks)
        free = st == 0
        out.fill_(7.0)
        got = cg.mask_argmax(x, st, masks, masked_out=out, masked_every=every)
        rows_eq = torch.equal(out.view(torch.int32), wrows[::every].view(torch.int32))
        a_err = max(a_err, float((got - want).abs().max()), _bits_err(torch, out,
                                                                       wrows[::every]))
        check(torch.equal(got, want) and rows_eq, f"grammar_mask_argmax [{n} x {vocab}]: "
              f"indices {got.tolist()} against plain {want.tolist()}, masked rows equal "
              f"{rows_eq}")
        check(torch.equal(got[free], torch.argmax(x[free], dim=-1)),
              f"grammar_mask_argmax [{n} x {vocab}]: FREE rows differ from torch.argmax")
        checks.append({"rows": n, "vocab": vocab, "masked_every": every,
                       "constrained_rows": int((~free).sum()), "equal": True})
        inputs[n] = (x, st, out, every, got)
    # rows 4 bytes off a 16-byte boundary: the scalar instantiation at 1B
    x8, st8 = inputs[DECODE_M][:2]
    off = torch.empty(x8.numel() + 1, device="cuda")[1:].view_as(x8)
    off.copy_(x8)
    off_out = torch.empty(x8.numel() + 1, device="cuda")[1:].view_as(x8)
    check(not cg.mask_plan(vocab, off.data_ptr() % 16 == 0)[0],
          "grammar_mask_argmax: the offset rows would take 16-byte loads")
    got = cg.mask_argmax(off, st8, masks, masked_out=off_out)
    want, wrows = cg.mask_argmax_plain(x8, st8, masks)
    a_err = max(a_err, float((got - want).abs().max()), _bits_err(torch, off_out, wrows))
    check(torch.equal(got, want) and torch.equal(off_out.view(torch.int32),
                                                 wrows.view(torch.int32)),
          f"grammar_mask_argmax [{DECODE_M} x {vocab}, rows off 16 bytes]: differs from plain")
    checks.append({"rows": DECODE_M, "vocab": vocab, "masked_every": 1,
                   "rows_off_16_bytes": True, "equal": True})
    edges = []
    for v in G_EDGE_VOCABS:
        t = _grammar_edge_tables(torch, v, seed=v)
        x = torch.randn((DECODE_M, v), device="cuda", generator=gen) * 3
        if v > 3:
            top = x.max(dim=-1).values + 1.0
            x[:, 1] = top
            x[:, v - 2] = top
            x[3, ::3] = float("-inf")
            x[4] = 0.0
            x[4, v // 2] = -0.0
            x[5] = float("-inf")
            x[6, v // 3] = float("nan")
            x[6, v - 1] = float("nan")
        st = torch.tensor([0, 1, 2, 0, 0, 0, 0, 5], device="cuda")
        out = torch.empty_like(x)
        got = cg.mask_argmax(x, st, t, masked_out=out)
        ref_rows = torch.zeros((DECODE_M, v))
        want = cg.mask_argmax(x.cpu(), st.cpu(), t.cpu(), masked_out=ref_rows)
        a_err = max(a_err, float((got.cpu() - want).abs().max()),
                    _bits_err(torch, out.cpu(), ref_rows))
        ok = (got.cpu().tolist() == want.tolist()
              and torch.equal(out.cpu().view(torch.int32), ref_rows.view(torch.int32))
              and int(got[1]) == v - 1 and int(got[2]) == 0
              and torch.equal(got[[0, 3, 4, 5, 6]], torch.argmax(x[[0, 3, 4, 5, 6]], dim=-1)))
        check(ok, f"grammar_mask_argmax edges at vocab {v}: {got.tolist()} against plain "
              f"{want.tolist()}")
        edges.append({"vocab": v, "indices": got.tolist(),
                      "plan": dict(zip(("vec", "slice"), cg.mask_plan(v, True)))})
    # the automaton step: random pairs, half of them legal
    n_pairs = 256
    st_np = rng.choice(pool, n_pairs)
    tok_np = rng.integers(0, vocab, (n_pairs, 3))
    for i in range(0, n_pairs, 2):
        s = int(st_np[i])
        for h in handles:
            if h.base <= s < h.base + h.automaton.n_states:
                for j in range(3):
                    legal = h.automaton.legal_ids(s - h.base)
                    tok_np[i, j] = int(legal[rng.integers(len(legal))])
                    s = h.next_state(s, int(tok_np[i, j]))
                break
    st, tk = torch.from_numpy(st_np).cuda(), torch.from_numpy(tok_np).cuda()
    got1 = cg.grammar_next(st, tk[:, :1], keys, nxt, dflt, vocab)
    gotw = cg.grammar_next(st, tk, keys, nxt, dflt, vocab, walk=True)
    want_w = cg.grammar_next_plain(st, tk, keys, nxt, dflt, vocab)
    b_err = max(float((got1 - want_w[:, 1]).abs().max()), float((gotw - want_w).abs().max()))
    check(torch.equal(got1, want_w[:, 1]) and torch.equal(gotw, want_w) and b_err == 0,
          "grammar_next: states differ from the plain version's")
    check(a_err == 0, f"grammar_mask_argmax: {a_err} from the plain version")

    def owner(s):
        return next((h for h in handles if h.base <= s < h.base + h.automaton.n_states), None)

    host = [0 if owner(int(st_np[i])) is None  # FREE loops on itself
            else owner(int(st_np[i])).next_state(int(st_np[i]), int(tok_np[i, 0]))
            for i in range(0, n_pairs, 2)]
    check(got1[::2].tolist() == host, "grammar_next: legal steps differ from the host mirror")
    # the search's round edges: sorted unique keys over 64 states at 1B,
    # pairs on every tenth edge, the first and last, below and past every key
    edge_tables = []
    for e in G_EDGE_COUNTS:
        erng = np.random.default_rng(e)
        ek = np.sort(erng.choice(64 * vocab, e, replace=False)).astype(np.int32)
        et = erng.integers(0, 64, e).astype(np.int32)
        ed = erng.integers(0, 64, 64).astype(np.int32)
        on = np.concatenate([ek[::10], ek[:1], ek[-1:]]).astype(np.int64)
        es = np.concatenate([on // vocab, [0, 63], erng.integers(0, 64, 16)])
        etk = erng.integers(0, vocab, (len(es), 4))
        etk[: len(on), 0] = on % vocab
        etk[len(on)] = 0
        etk[len(on) + 1] = vocab - 1
        tabs = [torch.from_numpy(a).cuda() for a in (ek, et, ed)]
        est, etkt = torch.from_numpy(es).cuda(), torch.from_numpy(etk).cuda()
        gw = cg.grammar_next(est, etkt, *tabs, vocab, walk=True)
        ww = cg.grammar_next_plain(est, etkt, *tabs, vocab)
        check(torch.equal(gw, ww), f"grammar_next over {e} edge keys "
              f"({cg.search_rounds(e)} rounds): walks differ from the plain version's")
        b_err = max(b_err, float((gw - ww).abs().max()))
        edge_tables.append({"edges": e, "rounds": cg.search_rounds(e), "rows": len(es),
                            "steps": 4, "equal": True})
    log("grammar_next edge tables: " + json.dumps(edge_tables))

    # times: the decode step's form (8 rows, no masked rows), with the
    # masked rows (a sampled step), the verify window; the plain versions
    # eagerly on the card; the library calls on precomputed legal bits (the
    # mask) and int64 tables (the step); the launch floor, a one-element op
    x8, st8, _, _, g8 = inputs[DECODE_M]
    x32, st32, o32, e32, _ = inputs[G_WINDOW]
    o8 = torch.empty_like(x8)
    ids = torch.arange(vocab, device="cuda")
    bits8 = ((masks[st8][:, ids >> 5] >> (ids & 31).to(torch.int32)) & 1).bool()
    ninf = torch.tensor(float("-inf"), device="cuda")
    reps = 20
    clusters = cg.active_clusters(torch.device("cuda"))
    log(f"grammar_mask_argmax: clusters of {cg.CLUSTER} the card holds at once: {clusters}")
    a_ms = graph_ms(torch, [lambda: cg.mask_argmax(x8, st8, masks)] * reps)
    a_masked_ms = graph_ms(torch, [lambda: cg.mask_argmax(x8, st8, masks, masked_out=o8)] * reps)
    a_window_ms = graph_ms(torch, [lambda: cg.mask_argmax(x32, st32, masks, masked_out=o32,
                                                          masked_every=e32)] * reps)
    a_library_ms = graph_ms(torch, [lambda: torch.argmax(torch.where(bits8, x8, ninf),
                                                         dim=-1)] * reps)
    argmax_ms = graph_ms(torch, [lambda: torch.argmax(x8, dim=-1)] * reps)
    one = torch.zeros(1, device="cuda")
    floor_ms = graph_ms(torch, [lambda: one.add_(1.0)] * reps)
    a_plain_ms = eager_ms(torch, lambda: cg.mask_argmax_plain(x8, st8, masks), 5)
    a_bytes = DECODE_M * vocab * 4 + DECODE_M * words * 4 + DECODE_M * 16
    a_ops = 2 * DECODE_M * vocab  # the bit test and the compare of each entry
    a_tb, a_to = a_bytes / HBM_BYTES_S, a_ops / LANE_OPS_S
    tok8 = g8[:, None]
    tok84 = torch.cat([tok8, tk[:DECODE_M, :3]], dim=1)  # a verify window's 4 fed tokens
    b_ms = graph_ms(torch, [lambda: cg.grammar_next(st8, tok8, keys, nxt, dflt, vocab)] * reps)
    b_walk_ms = graph_ms(torch, [lambda: cg.grammar_next(st8, tok84, keys, nxt, dflt, vocab,
                                                         walk=True)] * reps)
    keys64, nxt64, dflt64 = (t.to(torch.int64) for t in (keys, nxt, dflt))
    last = keys.shape[0] - 1

    def library_next():
        key = st8 * vocab + tok8[:, 0]
        j = torch.searchsorted(keys64, key).clamp_(max=last)
        return torch.where(keys64[j] == key, nxt64[j], dflt64[st8])

    check(torch.equal(library_next(), cg.grammar_next(st8, tok8, keys, nxt, dflt, vocab)),
          "grammar_next: the library composition differs from the kernel")
    b_library_ms = graph_ms(torch, [library_next] * reps)
    b_plain_ms = eager_ms(torch, lambda: cg.grammar_next_plain(st8, tok8, keys, nxt, dflt,
                                                               vocab), 5)
    probes = math.ceil(math.log2(keys.shape[0])) + 1  # the lower-bound search's key reads
    b_bytes = DECODE_M * (8 + 8 + 8 + probes * 4 + 4)
    b_ops = DECODE_M * probes * 3
    b_tb, b_to = b_bytes / HBM_BYTES_S, b_ops / LANE_OPS_S
    out = {
        "vocab_key": key, "compiles": compiles, "checks": checks, "edge_checks": edges,
        "launch_floor_ms": floor_ms,
        "grammar_mask_argmax": {
            "max_abs_err": a_err, "ms": a_ms,
            "ms_with_masked_rows": a_masked_ms, "ms_verify_window": a_window_ms,
            "plain_ms": a_plain_ms, "library_ms": a_library_ms,
            "kernel_over_library": a_ms / a_library_ms, "torch_argmax_ms": argmax_ms,
            "launch_floor_ms": floor_ms, "cluster": cg.CLUSTER, "active_clusters": clusters,
            "bound_ms": max(a_tb, a_to) * 1e3, "bound_by": "bytes" if a_tb >= a_to
            else "operations", "bound_bytes": a_bytes, "bound_ops": a_ops,
            "bound_ms_with_masked_rows": (a_bytes + DECODE_M * vocab * 4) / HBM_BYTES_S * 1e3,
            "rows": DECODE_M, "vocab": vocab, "words": words,
            "plan": dict(zip(("vec", "slice"), cg.mask_plan(vocab, True)))},
        "grammar_next": {
            "max_abs_err": b_err, "ms": b_ms, "ms_walk_t4": b_walk_ms, "plain_ms": b_plain_ms,
            "library_ms": b_library_ms, "launch_floor_ms": floor_ms,
            "bound_ms": max(b_tb, b_to) * 1e3, "bound_by": "bytes" if b_tb >= b_to
            else "operations", "bound_bytes": b_bytes, "bound_ops": b_ops, "rows": DECODE_M,
            "steps": 1, "edges": int(keys.shape[0]),
            "search_rounds": cg.search_rounds(keys.shape[0]), "pairs_checked": n_pairs,
            "edge_tables": edge_tables},
    }
    log("grammar kernels: " + json.dumps({k: out[k] for k in cg.KERNELS}))
    return out


def _grammar_engine_run(engine, config, family: str, constrain: bool, handles: list):
    """Prefill 8 lanes (lanes 0-3 constrained by json_object and flags where
    ``constrain``, greedy and sampled; 4-7 free), then one family's
    dispatches; every constrained token is checked legal on the host
    mirror (in the fused family, lane 3's from its readmission state on).
    Returns (per-lane streams, every token read back)."""
    import numpy as np

    n = engine.n_lanes
    temps = np.asarray(G_TEMPS, np.float32)
    topps = np.full(n, 0.9, np.float32)
    seeds = np.arange(n, dtype=np.int64) + 3
    hs = [handles[G_LANE_RF[i]] if constrain and G_LANE_RF[i] else None for i in range(n)]
    g = [h.start_state if h is not None else 0 for h in hs]
    streams = [[] for _ in range(n)]
    raw = []

    def adv(i, tok):
        tok = int(tok)
        streams[i].append(tok)
        if hs[i] is not None:
            check(hs[i].is_legal(g[i], tok), f"grammar engine [{family}]: lane {i} emitted "
                                              f"{tok}, illegal in state {g[i]}")
            g[i] = hs[i].next_state(g[i], tok)

    toks, pos = np.zeros(n, np.int64), np.zeros(n, np.int64)
    for lane in range(n):
        prompt = [(97 * lane + 13 * i) % 100 + 1 for i in range(40)]
        _, gr, sa = engine.prefill_chunk(lane, prompt, 0, temp=float(temps[lane]), topp=0.9,
                                         seed=int(seeds[lane]), g_state=g[lane])
        toks[lane], pos[lane] = (gr if temps[lane] == 0 else sa), len(prompt)
        adv(lane, toks[lane])
    if family == "step":
        for _ in range(4):
            _, gr, sa = engine.decode(toks, pos, temps, topps, seeds, want_logits=False,
                                      g_states=np.asarray(g))
            toks, pos = np.where(temps == 0, gr, sa), pos + 1
            raw.append(toks)
            for i in range(n):
                adv(i, toks[i])
    elif family == "multi":
        for _ in range(2):
            chosen = engine.decode_multi(toks, pos, temps, topps, seeds, h=4,
                                         g_states=np.asarray(g))
            raw.append(chosen)
            for i in range(n):
                for j in range(4):
                    adv(i, chosen[j, i])
            toks, pos = chosen[-1].astype(np.int64), pos + 4
    elif family == "verify":
        k = engine.SPEC_DRAFT
        for step in range(3):
            drafts, dlen = np.zeros((n, k), np.int64), np.zeros(n, np.int64)
            for i in range(n):
                if temps[i] != 0:
                    continue
                if hs[i] is not None and step != 1:  # legal candidates, then junk
                    s, d = g[i], []
                    for _ in range(k):
                        d.append(int(hs[i].automaton.legal_ids(s - hs[i].base)[0]))
                        s = hs[i].next_state(s, d[-1])
                else:
                    d = [int(toks[i])] * k
                drafts[i], dlen[i] = d, k
            _, em, ne = engine.decode_spec(toks, drafts, dlen, pos, temps, topps, seeds,
                                           want_logits=False, g_states=np.asarray(g))
            raw += [em, ne]
            for i in range(n):
                for t in em[i, :ne[i]]:
                    adv(i, t)
                toks[i] = em[i, ne[i] - 1]
            pos = pos + ne
    elif family == "pipelined":
        engine.decode_pipelined(pos, temps, topps, seeds, tokens=toks, g_states=np.asarray(g))
        for step in range(4):
            if step < 3:
                engine.decode_pipelined(np.full(n, -1), temps, topps, seeds)
            gr, sa = engine.pipeline_consume()
            raw.append(np.stack([gr, sa]))
            for i in range(n):
                adv(i, gr[i] if temps[i] == 0 else sa[i])
        engine.pipeline_flush()
    else:  # fused: lane 3 re-admits a prompt chunk under its start state
        park = pos.copy()
        park[3] = config.seq_len
        g0 = np.asarray(g)
        g0[3] = 0
        engine.decode_pipelined(park, temps, topps, seeds, tokens=toks, g_states=g0)
        chained = np.full(n, -1)
        chained[3] = config.seq_len
        engine.decode_prefill_fused(chained, temps, topps, seeds, p_lane=3, chunk=[4, 4, 4],
                                    p_start=int(pos[3]), p_temp=0.8, p_topp=0.9, p_seed=3,
                                    p_g=hs[3].start_state if hs[3] is not None else 0)
        raw.append(np.stack(engine.pipeline_consume()))
        engine.decode_pipelined(np.full(n, -1), temps, topps, seeds)
        raw.append(np.stack(engine.pipeline_consume()))
        raw.append(np.stack(engine.pipeline_consume()))
        engine.pipeline_flush()
        for i in range(n):
            if i != 3:
                for r in raw:
                    adv(i, r[0 if temps[i] == 0 else 1][i])
        # lane 3 from its readmission state: the boundary token (the extra
        # column, picked at p_temp 0.8), then the step fed from the carry
        # next(p_g, boundary); its column in the first readback is parked
        if hs[3] is not None:
            g[3] = hs[3].start_state
        adv(3, raw[1][1][n])
        adv(3, raw[2][0 if temps[3] == 0 else 1][3])
    return streams, np.concatenate([np.asarray(r).reshape(-1) for r in raw])


def grammar_engine_phase(torch, q, cg, model: str, table, eos) -> dict:
    """The engine on the 1B model with 8 lanes, 4 constrained (json_object
    and flags, greedy and seeded) and 4 free, through the step, multi-step,
    verify, pipelined and fused families: the replayed graphs' tokens and
    launch counts equal the eager bodies', every constrained token is legal
    in its automaton, and the free lanes' tokens equal those of the same
    batch with no constrained lane."""
    from distributed_llama_multiusers_tpu_torch.formats import load_model_header
    from distributed_llama_multiusers_tpu_torch.models import load_params_from_m_quantized
    from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine

    t0 = time.perf_counter()
    q.set_dequant_mode(None)
    config, params = load_params_from_m_quantized(model, load_model_header(model),
                                                  dtype=torch.bfloat16, device="cuda")
    engines = []
    for _ in range(2):
        e = InferenceEngine(config, params, n_lanes=DECODE_M, device="cuda")
        e.grammar_init(table, eos)
        engines.append(e)
    graphed, eager = engines
    eager.graphs = None
    handles = [{k: e.grammar_attach(G_SCHEMAS[k]) for k in ("json_object", "flags")}
               for e in engines]
    families = {}
    for family in ("step", "multi", "verify", "pipelined", "fused"):
        sync_all(torch)
        before = _launch_counts()
        got_streams, got = _grammar_engine_run(graphed, config, family, True, handles[0])
        sync_all(torch)
        mid = _launch_counts()
        _, want = _grammar_engine_run(eager, config, family, True, handles[1])
        sync_all(torch)
        after = _launch_counts()
        free_streams, _ = _grammar_engine_run(graphed, config, family, False, handles[0])
        counts = [{k: (b[k] - a[k]) for k in ("gumbel_sample_launches", "decode_attn_launches",
                                              "grammar_mask_argmax_launches",
                                              "grammar_next_launches")}
                  for a, b in ((before, mid), (mid, after))]
        check(got.tolist() == want.tolist(), f"grammar engine [{family}]: graph replays "
              "differ from the eager bodies")
        check(counts[0] == counts[1] and counts[0]["grammar_mask_argmax_launches"] > 0
              and counts[0]["grammar_next_launches"] > 0,
              f"grammar engine [{family}]: launches replayed {counts[0]}, eager {counts[1]}")
        check(got_streams[4:] == free_streams[4:], f"grammar engine [{family}]: free lanes "
              "changed beside constrained ones")
        families[family] = {"tokens": len(got), "launches": counts[0],
                            "constrained_streams": got_streams[:4]}
    graphs = graphed.graphs  # None only where the engine runs eagerly (a CPU rehearsal)
    captures = 0 if graphs is None else len(graphs)
    check(graphs is None or graphs.replays > 0, "grammar engine: no graph replayed")
    del engines, graphed, eager, params, graphs
    torch.cuda.empty_cache()
    out = {"families": families, "graphs": captures, "seconds": time.perf_counter() - t0}
    log(f"grammar engine: {list(families)} on 8 lanes (4 constrained): replays equal eager, "
        f"constrained tokens legal, free lanes unchanged; {captures} graphs "
        f"({out['seconds']:.1f}s)")
    return out


def _grammar_concurrent(base: str, bodies: list) -> list:
    """Every body at once; (status, text, finish) each."""
    results: list = [None] * len(bodies)

    def worker(i, route, body):
        try:
            if body.get("stream"):
                status, text, last, _ = _stream(base + route, body)
                results[i] = (status, text, last["choices"][0].get("finish_reason"))
                return
            status, _, raw = _request(base + route, body)
            b = json.loads(raw)
            results[i] = (status, _text(b) if status == 200 else b,
                          b["choices"][0]["finish_reason"] if status == 200 else None)
        except Exception as e:  # noqa: BLE001 — failed below
            results[i] = (None, f"{type(e).__name__}: {e}", None)

    threads = [threading.Thread(target=worker, args=(i, r, b))
               for i, (r, b) in enumerate(bodies)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return results


def _grammar_pass(name: str, stats: dict) -> dict:
    """A grammar server's launch counts, keyed as a serving pass's."""
    return {"mode": name, **{k: stats[k] for k in (
        "kernel_launches", "ring_hop_launches", "ring_hop_bytes", "gumbel_sample_launches",
        "decode_attn_launches", "decode_attn_window_launches", "decode_attn_paged_launches",
        "grammar_mask_argmax_launches", "grammar_next_launches", "grammar_lanes",
        "grammar_masked_steps")}}


def grammar_serving_phase(torch, model: str, tok: str, default: dict, compiles: dict) -> dict:
    """``dllama_api`` with its defaults serves 4 constrained requests (two
    schemas of flags, an enum and an object of an enum and a boolean;
    greedy and seeded; completion and chat) beside the default pass's 4
    plain ones, all at once: every constrained answer parses and conforms,
    the plain texts equal the default pass's, /stats shows the grammar
    fields with no flush and no graph captured after three schemas; a
    malformed schema gets 400. Then ``--workers 2`` with a slab that holds
    the long enum or flags but not both: flags beside the live long enum
    gets 429 ``grammar_slab_full`` with Retry-After, the long enum's answer
    at tp2 is its string, and flags is served after it. Then ``--grammar
    off``: a constrained request gets 400, a plain one 200. The three
    servers start together."""
    t0 = time.perf_counter()
    devices = ",".join(str(d) for d in rank_devices(torch, 2))
    slab = compiles["long"]["states"] + compiles["flags"]["states"]
    servers = start_servers(model, tok, [
        ("grammar", ()),
        ("grammar-tp2", ("--workers", "2", "--device", devices,
                         "--grammar-slab-states", str(slab))),
        ("grammar-off", ("--grammar", "off"))])
    try:
        out = _grammar_serving(servers, default, slab)
    finally:
        for srv in servers:
            srv.kill()
    out["seconds"] = time.perf_counter() - t0
    log(f"grammar serving: 4 constrained answers {out['default']['answers']} beside the "
        f"default pass's 4 (texts equal); 400 on malformed schemas; tp2 slab of {slab} "
        f"states: 429 grammar_slab_full, the long enum served; --grammar off: 400 "
        f"({out['seconds']:.1f}s)")
    return out


def _grammar_serving(servers: list, default: dict, slab: int) -> dict:
    passes = []
    srv = servers[0]
    try:
        bodies = G_SERVE_BODIES + list(default["bodies"])
        res = _grammar_concurrent(srv.base, bodies)
        answers = []
        for (route, body), (status, text, finish) in zip(G_SERVE_BODIES, res):
            check(status == 200 and finish == "stop", f"grammar server: {route} "
                  f"{body['response_format']} got {status}, finish {finish}: {text}")
            try:
                obj = json.loads(text)
            except ValueError:
                raise SmokeFailure(f"grammar server: {text!r} does not parse") from None
            check(_conforms(body["response_format"], obj), f"grammar server: {obj!r} does "
                  f"not conform to {body['response_format']}")
            answers.append(obj)
        plain = [r[1] for r in res[len(G_SERVE_BODIES):]]
        check(all(r[0] == 200 for r in res[len(G_SERVE_BODIES):])
              and plain == default["concurrent_texts"],
              "grammar server: the plain requests' texts beside constrained ones differ from "
              "the default pass's")
        for bad in ({"type": "yaml"}, {"type": "json_schema", "json_schema": {
                "schema": {"type": "object", "additionalProperties": True}}}):
            status, _, _ = _request(srv.base + "/v1/completions", {
                "prompt": "x", "max_tokens": 4, "response_format": bad})
            check(status == 400, f"grammar server: malformed {bad} got {status}")
        stats = srv.stats()
        check(stats["grammar_lanes"] == len(G_SERVE_BODIES)
              and stats["grammar_masked_steps"] > 0
              and stats["grammar_schemas_installed"] == 3
              and stats["grammar_schemas_live"] == 0
              and stats["pipeline_flushes"] == 0 and stats["jit_compiles_after_warmup"] == 0
              and stats["grammar_mask_argmax_launches"] > 0
              and stats["grammar_next_launches"] > 0,
              "grammar server /stats: " + json.dumps({k: v for k, v in stats.items()
                                                     if "grammar" in k or k in (
                                                         "pipeline_flushes",
                                                         "jit_compiles_after_warmup")}))
        passes.append(_grammar_pass("grammar", stats))
        log_text = srv.stop()
        check("Structured output: json_object / json_schema enabled" in log_text,
              "grammar server: the startup log does not announce structured output")
    except BaseException:
        srv.tail()
        raise
    finally:
        srv.kill()
    first = {"answers": answers, "stats": {k: v for k, v in stats.items()
                                          if k.startswith("grammar")}}
    srv = servers[1]
    try:
        long_body = {"prompt": "say it", "max_tokens": len(G_LONG_TEXT) + 16, "temperature": 0,
                     "response_format": G_LONG}
        held: list = []
        thread = threading.Thread(target=lambda: held.append(
            _request(srv.base + "/v1/completions", long_body)))
        thread.start()
        _poll(lambda: srv.stats()["grammar_schemas_live"] == 1, 120,
              "grammar-tp2: the long enum never went live")
        flags = {"prompt": "fill the flags", "max_tokens": 96, "temperature": 0,
                 "response_format": G_FLAGS}
        url = srv.base + "/v1/completions"
        status, headers, raw = _request(url, flags)
        shed = (status, headers, json.loads(raw))
        thread.join(timeout=600)
        check(shed[0] == 429 and shed[2].get("reason") == "grammar_slab_full"
              and int(shed[1].get("Retry-After", 0)) >= 1,
              f"grammar-tp2: flags beside the live long enum got {shed[0]} {shed[2]}")
        check(held and held[0][0] == 200, f"grammar-tp2: the long enum got {held}")
        long_text = _text(json.loads(held[0][2]))
        check(json.loads(long_text) == G_LONG_TEXT, f"grammar-tp2: {long_text!r}")
        status, _, raw = _request(url, flags)
        check(status == 200 and _conforms(G_FLAGS, json.loads(_text(json.loads(raw)))),
              f"grammar-tp2: flags after the long enum got {status} {raw[:200]!r}")
        stats = srv.stats()
        check(stats["mesh"] is not None and stats["mesh"]["tp"] == 2
              and stats["ring_hop_launches"] > 0 and stats["jit_compiles_after_warmup"] == 0
              and stats["grammar_mask_argmax_launches"] > 0,
              f"grammar-tp2 /stats: mesh {stats['mesh']}, ring hops "
              f"{stats['ring_hop_launches']}, captures {stats['jit_compiles_after_warmup']}")
        passes.append(_grammar_pass("grammar-tp2", stats))
        srv.stop()
    except BaseException:
        srv.tail()
        raise
    finally:
        srv.kill()
    tp2 = {"slab_states": slab, "shed": {"status": shed[0], "reason": shed[2].get("reason"),
                                         "retry_after": shed[1].get("Retry-After")},
           "long_answer_chars": len(long_text)}
    srv = servers[2]
    try:
        status, _, raw = _request(srv.base + "/v1/completions", {
            "prompt": "x", "max_tokens": 8, "response_format": G_FLAGS})
        check(status == 400 and b"structured output is disabled" in raw,
              f"--grammar off: a constrained request got {status} {raw[:200]!r}")
        status, _, _ = _request(srv.base + "/v1/completions", {"prompt": "x", "max_tokens": 8})
        check(status == 200, f"--grammar off: a plain request got {status}")
        passes.append(_grammar_pass("grammar-off", srv.stats()))
        srv.stop()
    except BaseException:
        srv.tail()
        raise
    finally:
        srv.kill()
    return {"default": first, "tp2_small_slab": tp2, "passes": passes}


def grammar_phase(torch, q, model: str, tok: str, default: dict, breakdown: list,
                  kernels: dict) -> dict:
    """Phase 4c: the engine's constrained families and the server's
    structured output beside the grammar kernels' phase (``kernels``, run
    before the model was written, on the same tokenizer), and the v4
    decode step's device time and operations with the grammar kernels in it
    (``step_breakdown``)."""
    from distributed_llama_multiusers_tpu_torch.grammar.automaton import vocab_fingerprint
    from distributed_llama_multiusers_tpu_torch.ops import cuda_grammar as cg

    t0 = time.perf_counter()
    table, eos = grammar_table(tok)
    check(vocab_fingerprint(table) == kernels["vocab_key"],
          "the grammar kernels' phase ran on another tokenizer than the served model's")
    engine = grammar_engine_phase(torch, q, cg, model, table, eos)
    serving = grammar_serving_phase(torch, model, tok, default, kernels["compiles"])
    v4 = next(b for b in breakdown if b["mode"] == "v4")
    step = {"device_ms_per_step": v4["device_ms_per_step"],
            "device_ops_per_step": v4["device_ops_per_step"],
            "step_ms_p50": v4["step_ms_p50"], "grammar_ms_per_step": v4["grammar_ms_per_step"],
            "launches_per_step": {k: v4["launches_per_step"][k]
                                  for k in ("grammar_mask_argmax", "grammar_next")}}
    log("v4 decode step with the grammar kernels: " + json.dumps(step))
    return {"kernels": kernels, "engine": engine, "serving": serving, "v4_step": step,
            "passes": serving["passes"], "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# Phase 4d: mixture of experts at Mixtral-8x7B's widths
# ---------------------------------------------------------------------------

# mistralai/Mixtral-8x7B-v0.1's config.json: dim 4096, hidden 14336, 32
# heads, 8 KV heads, vocab 32000, 8 experts, 2 active, rope theta 1e6; cut to
# 2 of its 32 layers and a seq_len of 2048 (its 32,768), for the phase's time
MOE_LAYERS = 2
MOE_SEQ_LEN = 2048
MOE_W_STD = 0.02  # the random Q40 weights' std (the f32 tensors' too)
# the router's rows: a decode step at 8 lanes, a verify step at 8 lanes
# (4 rows a lane), one 1,024-row prompt chunk (one lane)
MOE_ROUTE_ROWS = (DECODE_M, VERIFY_M, 1024)
# both router plans are timed over these rows (where they switch over)
MOE_SWEEP_ROWS = (32, 48, 64, 96, 128, 256)
MOE_TIME_CALLS = 20  # router calls captured back to back in one graph
# rows whose top k + 1 router logits lie closer than this share of the
# row's largest |logit| may take their experts in another order: the
# kernel's f32 product sums in another order than cuBLAS's
MOE_TIE_GAP = 1e-5
MOE_ROUTE_TOL = 1e-6  # the routing weights' max|kernel - plain| on the other rows
MOE_PREFILL_ROWS = 64  # the CPU check's prompt chunk: the sparse dispatch
MOE_DECODE_STEPS = 8
MOE_TP_PROMPT = 40
MOE_TP_TOKENS = 16
# the card (bf16 activations, the bf16 dot) against the CPU's f32 forward on
# the same weights and expert choices: max|d| <= tol * max|cpu| (2 layers of
# bf16 rounding, the class of TP_LOGITS_TOL)
MOE_CPU_TOL = 5e-2
# tp2 against tp1 with the Q80 casts on (and, at tp2, the Q80 wire): each
# of a layer's Q80 casts may round a value one step of its block's scale
# the other way, which the next layers carry; twice the f32 wire's class
MOE_TP_Q80_TOL = 2 * TP_LOGITS_TOL


def mixtral_header():
    from distributed_llama_multiusers_tpu_torch.formats.synthetic import tiny_header

    return tiny_header(dim=4096, hidden_dim=14336, n_layers=MOE_LAYERS, n_heads=32,
                       n_kv_heads=8, vocab_size=32000, seq_len=MOE_SEQ_LEN,
                       rope_theta=1000000.0, n_experts=8, n_active_experts=2)


def write_random_q40_model(path: str, header, seed: int) -> None:
    """A ``.m`` of ``header`` in the port's tensor order
    (``formats/model_file.model_tensor_specs``) with random weights drawn as
    the file holds them: each Q40 block 16 random nibble bytes and an f16
    scale of one magnitude and a random sign, so that a weight (nibble - 8,
    uniform on -8..7, std sqrt(255/12)) times its scale has std MOE_W_STD;
    the F32 tensors (embedding, router) N(0, MOE_W_STD), the norms 1 plus
    that. No quantizer runs: the 1B model's numpy quantizers took 60-66 s
    for 1.75 GB."""
    import numpy as np

    from distributed_llama_multiusers_tpu_torch.formats.model_file import (
        model_tensor_specs,
        write_model_header,
    )
    from distributed_llama_multiusers_tpu_torch.quants.codec import (
        Q40_BLOCK_BYTES,
        Q40_BLOCK_SIZE,
        FloatType,
    )

    rng = np.random.default_rng(seed)
    scale = MOE_W_STD / math.sqrt(255 / 12)
    plus, minus = (np.asarray([s], "<f2").view(np.uint8) for s in (scale, -scale))
    with open(path, "wb") as f:
        write_model_header(f, header)
        for spec in model_tensor_specs(header):
            n = spec.shape[0] * spec.shape[1]
            if spec.float_type == FloatType.Q40:
                blocks = rng.integers(0, 256, (n // Q40_BLOCK_SIZE, Q40_BLOCK_BYTES),
                                      dtype=np.uint8)
                sign = rng.integers(0, 2, n // Q40_BLOCK_SIZE, dtype=np.uint8).astype(bool)
                blocks[:, :2] = np.where(sign[:, None], plus, minus)
                f.write(blocks.tobytes())
            else:
                check(spec.float_type == FloatType.F32, f"{spec.name}: float type "
                                                         f"{spec.float_type}")
                x = rng.standard_normal(n, dtype=np.float32) * MOE_W_STD
                if "rms_norm" in spec.name:
                    x += 1.0
                f.write(x.astype("<f4").tobytes())


def _route_inputs(torch, n: int, dim: int, e: int, seed: int, ties: bool = False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    y = torch.randn((n, dim), device="cuda", generator=gen).to(torch.bfloat16)
    gate = torch.randn((dim, e), device="cuda", generator=gen) * MOE_W_STD
    if ties:  # experts 0, 1 and e-1 score the same on every row; some rows 0
        gate[:, 1] = gate[:, 0]
        gate[:, e - 1] = gate[:, 0]
        y[::3] = 0.0
    return y, gate


def moe_route_bound(n: int, dim: int, e: int, k: int, x_bytes: int = 2) -> tuple:
    """(bound ms, by): the rows, the gate and the three outputs moved once,
    against the product's 2 n dim e operations at the f32 rate."""
    n_bytes = n * dim * x_bytes + dim * e * 4 + n * k * 8 + n * e * 4
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, 2 * n * dim * e / F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def moe_route_compare(torch, cm, y, gate, k: int, label: str, ties: bool = False) -> dict:
    """The kernel against its plain version on the same card tensors:
    expert ids equal on every row clear of a near tie (MOE_TIE_GAP); with
    ``ties`` (experts 0, 1 and e-1 tie exactly on every row), those in index
    order (as lax.top_k takes them) in both; weights and dense weights
    within MOE_ROUTE_TOL wherever the chosen experts are the same."""
    got = cm.moe_route(y, gate, k)
    want = cm.moe_route_plain(y, gate, k)
    torch.cuda.synchronize()
    e = gate.shape[1]
    logits = y.float() @ gate
    srt = torch.sort(logits, dim=-1, descending=True).values
    gaps = (srt[:, :-1] - srt[:, 1:])[:, :k]
    clear = (gaps > MOE_TIE_GAP * logits.abs().amax(dim=-1, keepdim=True)).all(dim=-1)
    check(torch.equal(got[1][clear], want[1][clear]),
          f"moe_route [{label}]: expert ids differ from the plain version's on clear rows")
    same = (torch.sort(got[1], dim=-1).values == torch.sort(want[1], dim=-1).values).all(-1)
    err = max([float(d.abs().max()) for d in ((got[0] - want[0])[same],
                                               (got[2] - want[2])[same]) if d.numel()] + [0.0])
    check(err <= MOE_ROUTE_TOL and bool(torch.isfinite(got[2]).all()),
          f"moe_route [{label}]: weights max|kernel - plain| {err:.3e}")
    check(torch.equal((got[2] > 0).sum(-1), torch.full_like(got[2][:, 0], k, dtype=torch.int64)),
          f"moe_route [{label}]: a row's dense weights do not hold {k} experts")
    for ids in (got[1].tolist(), want[1].tolist()) if ties else ():
        for row in ids:
            tied = [i for i in row if i in (0, 1, e - 1)]
            check(tied == sorted(tied), f"moe_route [{label}]: tied experts {row} out of "
                                        "lax.top_k's order")
    return {"rows": int(y.shape[0]), "rows_clear": int(clear.sum()),
            "rows_same_experts": int(same.sum()), "max_abs_err": err}


def moe_route_bits_check(torch, cm) -> dict:
    """A row's ``moe_route`` outputs are the same bits alone and inside 8,
    32, TILE_MIN_ROWS - 1, TILE_MIN_ROWS and 1,024 random rows (the
    cluster plan below the switch-over, tiles at and above it), at the
    first, a middle and the last position, bf16 and f32, at Mixtral's
    router; and under either plan forced at 1, 8 and 1,024 rows."""
    dim, e, k = 4096, 8, 2
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        y, gate = _route_inputs(torch, 1024, dim, e, seed=19)
        y = y.to(dtype)
        probes = y[[5, 300, 1000]].clone()
        alone = [[t.view(torch.int32) for t in cm.moe_route(p[None], gate, k)] for p in probes]
        runs = []
        for n in (8, 32, cm.TILE_MIN_ROWS - 1, cm.TILE_MIN_ROWS, 1024):
            batch = y[:n].clone()
            at = (0, n // 2, n - 1)
            batch[list(at)] = probes
            got = [t.view(torch.int32) for t in cm.moe_route(batch, gate, k)]
            for i, pos in enumerate(at):
                check(all(torch.equal(a[pos], b[0]) for a, b in zip(got, alone[i])),
                      f"moe_route [{dtype}]: row {pos} of {n} differs from the row alone")
            plan = cm.route_plan(n, dim, e, k, dtype, cm.n_sms(gate.device))
            runs.append(f"{n}:{'cluster' if plan.cluster else 'tile'}")
        for n in (1, 8, 1024):
            for tile_min_rows in (1, 1 << 30):
                plan = cm.route_plan(n, dim, e, k, dtype, cm.n_sms(gate.device),
                                     tile_min_rows=tile_min_rows)
                batch = y[:n].clone()
                batch[n - 1] = probes[0]
                got = [t.view(torch.int32) for t in cm.launch_plan(batch, gate, k, plan)]
                check(all(torch.equal(a[n - 1], b[0]) for a, b in zip(got, alone[0])),
                      f"moe_route [{dtype}]: {plan} differs from the row alone")
                runs.append(f"{n}:{'cluster' if plan.cluster else 'tile'} forced")
        out[str(dtype).removeprefix("torch.")] = runs
    torch.cuda.synchronize()
    return {"bits_equal": True, "runs": out}


def moe_kernel_phase(torch, cm) -> dict:
    """``moe_route`` against its plain version at Mixtral's router (dim
    4096, 8 experts, 2 active) on N = 8, 32 and 1,024 bf16 rows, and on
    rows with exact ties; a row's bits across N and plans
    (``moe_route_bits_check``); each N timed (MOE_TIME_CALLS calls captured
    back to back in one CUDA graph) beside the library chain (the f32
    product, ``torch.topk``, ``softmax``, ``scatter_``), the plain version
    (eager), the bound and the launch floor (a one-element op in the same
    harness); and both plans forced over MOE_SWEEP_ROWS, where they switch
    over."""
    dim, e, k = 4096, 8, 2
    reps = MOE_TIME_CALLS
    out = {"by_rows": {}, "ties": None, "bits": moe_route_bits_check(torch, cm),
           "cluster": cm.SLICES, "tile_min_rows": cm.TILE_MIN_ROWS,
           "active_clusters": cm.active_clusters(torch.device("cuda"))}
    for n in MOE_ROUTE_ROWS:
        y, gate = _route_inputs(torch, n, dim, e, seed=n)
        cmp = moe_route_compare(torch, cm, y, gate, k, f"{n} rows")

        def library(y=y, gate=gate):
            logits = torch.matmul(y.float(), gate)
            v, i = torch.topk(logits, k)
            return torch.zeros_like(logits).scatter_(-1, i, torch.softmax(v, dim=-1))

        bound_ms, bound_by = moe_route_bound(n, dim, e, k)
        plan = cm.route_plan(n, dim, e, k, y.dtype, cm.n_sms(y.device))
        out["by_rows"][str(n)] = {
            **cmp, "ms": graph_ms(torch, [lambda y=y, gate=gate: cm.moe_route(y, gate, k)] * reps),
            "library_ms": graph_ms(torch, [library] * reps),
            "plain_ms": eager_ms(torch, lambda y=y, gate=gate: cm.moe_route_plain(y, gate, k),
                                 10),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "plan": "cluster" if plan.cluster else f"tiles of {plan.tile_rows}"}
    y, gate = _route_inputs(torch, 64, dim, e, seed=7, ties=True)
    out["ties"] = moe_route_compare(torch, cm, y, gate, 3, "ties", ties=True)
    check(out["ties"]["rows_same_experts"] == 64, "moe_route [ties]: the kernel's experts "
                                                  "differ from the plain version's")
    one = torch.zeros(1, device="cuda")
    out["launch_floor_ms"] = graph_ms(torch, [lambda: one.add_(1.0)] * reps)
    sweep = {}
    for n in MOE_SWEEP_ROWS:
        y, gate = _route_inputs(torch, n, dim, e, seed=n + 1)
        sweep[str(n)] = {}
        for name, tile_min_rows in (("cluster", 1 << 30), ("tile", 1)):
            plan = cm.route_plan(n, dim, e, k, y.dtype, cm.n_sms(y.device),
                                 tile_min_rows=tile_min_rows)
            sweep[str(n)][name] = graph_ms(
                torch, [lambda y=y, gate=gate, plan=plan: cm.launch_plan(y, gate, k, plan)] * reps)
    out["sweep_ms"] = sweep
    head = out["by_rows"][str(DECODE_M)]
    out.update({k_: head[k_] for k_ in ("ms", "library_ms", "plain_ms", "bound_ms",
                                         "bound_by")})
    out["max_abs_err"] = max([r["max_abs_err"] for r in out["by_rows"].values()]
                             + [out["ties"]["max_abs_err"]])
    log("moe_route: " + json.dumps(out))
    return out


class RouteLog:
    """Every ``moe_route`` call of the forwards run while it is installed
    (``models/llama.moe_route`` replaced): each row's experts and its router
    logits (the f32 product, recomputed). With ``follow`` (another run's
    log), each call's logits must lie within ``tol`` of max|logit| of that
    run's, and a row whose experts part from that run's takes them instead,
    weighed by its own logits, where the parting is a near tie the
    difference explains: for every expert i it chose and the other did not
    and every j the other chose and it did not, its own a_i - a_j is at most
    |a_i - b_i| + |a_j - b_j| (two runs of the same function on close
    inputs rank two experts apart only so). A parting it does not explain
    fails the check. ``stride`` maps this run's calls onto the other's (a
    tp = n forward calls the router once a rank)."""

    def __init__(self, torch, follow=None, tol: float = 0.0, stride: int = 1,
                 follow_stride: int = 1):
        self.torch, self.follow, self.tol = torch, follow, tol
        self.stride, self.follow_stride = stride, follow_stride
        self.calls, self.followed, self.max_logit_diff = [], 0, 0.0

    def __enter__(self):
        from distributed_llama_multiusers_tpu_torch.models import llama

        self._real, self._mod = llama.moe_route, llama
        llama.moe_route = self
        return self

    def __exit__(self, *exc):
        self._mod.moe_route = self._real

    def __call__(self, y, gate, k):
        torch = self.torch
        topw, topi, rw = self._real(y, gate, k)
        logits = y.float() @ gate.float()
        i = len(self.calls)
        self.calls.append((topi.cpu(), logits.cpu()))
        if self.follow is None:
            return topw, topi, rw
        ref_i, ref_l = self.follow[(i // self.stride) * self.follow_stride]
        own_i, own_l = self.calls[-1]
        delta = (own_l - ref_l).abs()
        scale = float(ref_l.abs().max())
        self.max_logit_diff = max(self.max_logit_diff, float(delta.max()) / max(scale, 1e-30))
        check(float(delta.max()) <= self.tol * scale,
              f"router call {i}: logits {float(delta.max()):.3e} from the other run's "
              f"(max {scale:.3e}, tol {self.tol})")
        parted = [r for r in range(own_i.shape[0])
                  if set(own_i[r].tolist()) != set(ref_i[r].tolist())]
        if not parted:
            return topw, topi, rw
        for r in parted:
            mine, theirs = set(own_i[r].tolist()), set(ref_i[r].tolist())
            for a in mine - theirs:
                for b in theirs - mine:
                    lead = float(own_l[r, a] - own_l[r, b])
                    check(lead <= float(delta[r, a] + delta[r, b]) + 2 * MOE_TIE_GAP * scale,
                          f"router call {i}, row {r}: expert {a} chosen over the other run's "
                          f"{b} by {lead:.3e}, more than the runs' difference on them "
                          f"({float(delta[r, a]):.3e}, {float(delta[r, b]):.3e})")
        self.followed += len(parted)
        ref = ref_i.to(topi.device)
        p = torch.zeros(topi.shape[0], 1, dtype=torch.bool)
        p[parted] = True
        p = p.to(topi.device)
        w = torch.softmax(logits.gather(-1, ref.long()), dim=-1)
        topi = torch.where(p, ref, topi)
        topw = torch.where(p, w, topw)
        rw = torch.where(p, torch.zeros_like(rw).scatter_(-1, ref.long(), w), rw)
        return topw, topi, rw


def moe_cpu_check(torch, config, params) -> dict:
    """The card's forward against the port's CPU forward on the same
    weights: one 64-row prompt chunk (the sparse dispatch) and 8 greedy
    decode steps (the per-expert loop), each step feeding the card's argmax
    to both. The CPU runs in f32 with every matmul dense (the planes'
    dequantized values, the same numbers), so its MoE layers take the
    sparse dispatch; it takes the card's experts where they part at a near
    tie (``RouteLog``). Logits within MOE_CPU_TOL of max|cpu| a step."""
    import numpy as np

    from distributed_llama_multiusers_tpu_torch.models.llama import (
        LlamaLayerParams,
        LlamaParams,
        init_kv_cache,
        llama_forward,
    )
    from distributed_llama_multiusers_tpu_torch.quants.packed import PackedQ40, unpack_q40

    t0 = time.perf_counter()
    dev = params.device
    prompt = np.random.default_rng(11).integers(0, config.vocab_size, MOE_PREFILL_ROWS)
    steps = [(prompt[None], np.arange(MOE_PREFILL_ROWS)[None])]
    card_logits = []
    with RouteLog(torch) as card_log, torch.inference_mode():
        cache = init_kv_cache(config, 1, dtype=torch.bfloat16, device=dev)
        for s in range(MOE_DECODE_STEPS + 1):
            toks, pos = steps[s]
            logits, _ = llama_forward(config, params, torch.as_tensor(toks, device=dev),
                                      torch.as_tensor(pos, device=dev), cache)
            card_logits.append(logits[0].float().cpu())  # reads back: synchronized
            if s < MOE_DECODE_STEPS:
                steps.append((np.asarray([[int(logits[0, -1].argmax())]]),
                              np.asarray([[MOE_PREFILL_ROWS + s]])))
    card_s = time.perf_counter() - t0
    del cache

    # the CPU's parameters: the card's values, every matmul dense f32 (each
    # packed plane unpacked on the card, one expert at a time, and copied:
    # (nibble - 8) times an f16 scale is exact in f32 on either device)
    t1 = time.perf_counter()

    def host(w):
        if not isinstance(w, PackedQ40):
            return w.to("cpu", torch.float32)
        out = torch.empty((*w.packed.shape[:-2], w.d_in, w.d_out), dtype=torch.float32)
        flat_p = w.packed.reshape(-1, *w.packed.shape[-2:])
        flat_s = w.scales.reshape(-1, *w.scales.shape[-2:])
        for i, o in enumerate(out.view(-1, w.d_in, w.d_out)):
            o.copy_(unpack_q40(PackedQ40(flat_p[i], flat_s[i])))
        return out

    lay = params.layers
    cpu = LlamaParams(
        embedding=host(params.embedding), rms_final=host(params.rms_final),
        wcls=host(params.wcls), rope_cos=host(params.rope_cos), rope_sin=host(params.rope_sin),
        layers=LlamaLayerParams(**{k: host(getattr(lay, k)) for k in (
            "wq", "wk", "wv", "wo", "w1", "w2", "w3", "rms_att", "rms_ffn", "moe_gate")}))
    unpack_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    errs = []
    with RouteLog(torch, follow=card_log.calls, tol=MOE_CPU_TOL) as cpu_log, \
            torch.inference_mode():
        cache = init_kv_cache(config, 1, dtype=torch.float32, device="cpu")
        for (toks, pos), want in zip(steps, card_logits):
            logits, _ = llama_forward(config, cpu, torch.as_tensor(toks),
                                      torch.as_tensor(pos), cache)
            ref = logits[0]
            err, scale = float((want - ref).abs().max()), float(ref.abs().max())
            check(bool(torch.isfinite(want).all()) and err <= MOE_CPU_TOL * scale,
                  f"moe forward, card against CPU, step {len(errs)}: max|d| {err:.4e} against "
                  f"max|cpu| {scale:.4e}")
            errs.append({"rows": int(ref.shape[0]), "max_abs_err": err, "max_abs_ref": scale,
                         "argmax_equal": int((want.argmax(-1) == ref.argmax(-1)).sum())})
    out = {"steps": errs, "tol": MOE_CPU_TOL, "router_calls": len(card_log.calls),
           "rows_following_the_card": cpu_log.followed,
           "max_router_logit_diff": cpu_log.max_logit_diff,
           "card_s": card_s, "cpu_unpack_s": unpack_s, "cpu_s": time.perf_counter() - t2}
    log("moe forward, card against CPU: " + json.dumps(out))
    del cpu, cache
    return out


def _greedy_forward(torch, config, params, prompt, n: int, mesh=None, follow=None,
                    feed=None, tol: float = TP_LOGITS_TOL, **flags):
    """A one-lane greedy run through ``llama_forward``: the prompt, then
    each step fed its argmax (or ``feed``'s tokens, teacher-forced), n
    forwards; returns (the n tokens chosen, each forward's last logits on
    the CPU, the run's RouteLog)."""
    import numpy as np

    from distributed_llama_multiusers_tpu_torch.models.llama import init_kv_cache, llama_forward
    from distributed_llama_multiusers_tpu_torch.parallel.sharding import shard_kv_cache

    dev = (params if mesh is None else params[0]).device
    cache = init_kv_cache(config, 1, dtype=torch.bfloat16, device=dev)
    if mesh is not None:
        cache = shard_kv_cache(cache, mesh)
    n_ranks = 1 if mesh is None else mesh.n_ranks
    toks, pos = np.asarray([prompt]), np.arange(len(prompt))[None]
    chosen, logits_all = [], []
    follow_stride = 1 if follow is None else follow.stride
    with RouteLog(torch, None if follow is None else follow.calls, tol=tol,
                  stride=n_ranks, follow_stride=follow_stride) as rlog, torch.inference_mode():
        for s in range(n):
            logits, _ = llama_forward(config, params, torch.as_tensor(toks, device=dev),
                                      torch.as_tensor(pos, device=dev), cache, mesh=mesh,
                                      logit_rows=torch.as_tensor([toks.shape[1] - 1]),
                                      **flags)
            row = logits[0, -1].float().cpu()
            logits_all.append(row)
            chosen.append(int(row.argmax()))
            nxt = chosen[-1] if feed is None else feed[s]
            toks, pos = np.asarray([[nxt]]), np.asarray([[len(prompt) + s]])
    return chosen, logits_all, rlog


def moe_tp_check(torch, config, params) -> list:
    """A tp = 2 decode (two ranks on the host's cards, one card named twice
    where there is one) on the f32 wire and on the Q80 wire (Q80 activation
    casts on, as ``--buffer-float-type q80`` serves it), and a tp = 2 x ep =
    2 decode (four ranks, each looping over its own E/ep experts, the routed
    partials in one f32 all-reduce over the four), against tp = 1: the mesh
    greedy for 16 tokens, then tp1 fed its tokens (taking the mesh's experts
    only at near ties, ``RouteLog``). Each step's logits within
    TP_LOGITS_TOL of max|tp1| (MOE_TP_Q80_TOL with the Q80 casts), and tp1's
    greedy token the mesh's wherever tp1's top two logits lie apart by more
    than twice that step's measured difference; tp1's own greedy stream's
    common prefix with the mesh's is printed."""
    import numpy as np

    from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
    from distributed_llama_multiusers_tpu_torch.parallel.collectives import q80_sync_engages
    from distributed_llama_multiusers_tpu_torch.parallel.sharding import shard_params

    tp2 = make_mesh(MeshPlan(tp=2), rank_devices(torch, 2))
    tp2_ep2 = make_mesh(MeshPlan(tp=2, ep=2), rank_devices(torch, 4))
    shards = {"tp2": shard_params(params, tp2), "tp2_ep2": shard_params(params, tp2_ep2)}
    prompt = [int(t) for t in np.random.default_rng(5).integers(0, config.vocab_size,
                                                              MOE_TP_PROMPT)]
    out = []
    for name, mesh, wire in (("tp2", tp2, "f32"), ("tp2", tp2, "q80"),
                             ("tp2_ep2", tp2_ep2, "f32")):
        q80 = wire == "q80"
        tol = MOE_TP_Q80_TOL if q80 else TP_LOGITS_TOL
        check(not q80 or q80_sync_engages(config, mesh.shape), "the Q80 wire does not engage")
        got, got_logits, tp2_log = _greedy_forward(
            torch, config, shards[name], prompt, MOE_TP_TOKENS, mesh=mesh, q80_sync=q80,
            emulate_q80_activations=q80)
        tp1_choice, ref_logits, tp1_log = _greedy_forward(
            torch, config, params, prompt, MOE_TP_TOKENS, follow=tp2_log, feed=got, tol=tol,
            emulate_q80_activations=q80)
        free, _, _ = _greedy_forward(torch, config, params, prompt, MOE_TP_TOKENS,
                                     emulate_q80_activations=q80)
        steps, excused = [], 0
        for s, (g, r) in enumerate(zip(got_logits, ref_logits)):
            err, scale = float((g - r).abs().max()), float(r.abs().max())
            check(bool(torch.isfinite(g).all()) and err <= tol * scale,
                  f"moe {name} [{wire} wire] step {s}: max|mesh - tp1| {err:.4e} against max|tp1| "
                  f"{scale:.4e} (tol {tol})")
            top2 = torch.topk(r, 2).values
            margin = float(top2[0] - top2[1])
            if tp1_choice[s] != got[s]:
                check(margin <= 2 * err, f"moe {name} [{wire} wire] step {s}: token {got[s]} "
                                         f"where tp1 takes {tp1_choice[s]} by a margin of "
                                         f"{margin:.4e} "
                                         f"(step difference {err:.4e})")
                excused += 1
            steps.append({"max_abs_err": err, "max_abs_ref": scale, "top2_margin": margin})
        prefix = next((i for i, (a, b) in enumerate(zip(free, got)) if a != b), len(got))
        res = {"mesh": name, "wire": wire, "tol": tol, "tokens": len(got),
               "tokens_equal_fed": len(got) - excused,
               "near_tie_tokens": excused, "free_run_common_prefix": prefix,
               "rows_following_tp2": tp1_log.followed,
               "max_router_logit_diff": tp1_log.max_logit_diff,
               "router_calls_tp2": len(tp2_log.calls), "router_calls_tp1": len(tp1_log.calls),
               "max_abs_err": max(x["max_abs_err"] for x in steps), "steps": steps}
        check(res["router_calls_tp2"] == mesh.n_ranks * res["router_calls_tp1"],
              f"moe {name} [{wire} wire]: {res['router_calls_tp2']} router calls, tp1 "
              f"{res['router_calls_tp1']}")
        log(f"moe {name} [{wire} wire]: {len(got) - excused} of {len(got)} greedy tokens tp1's "
            f"choice ({excused} at near ties), free-run common prefix {prefix}, "
            f"{tp1_log.followed} rows following tp2's experts, max|tp2 - tp1| "
            f"{res['max_abs_err']:.4e}")
        out.append(res)
    del shards
    return out


def moe_stream_check(torch, config, params, tok: str) -> dict:
    """In this process, the scheduler on the Mixtral-width engine: a probe
    (16 greedy tokens after SPEC_RUN 'a's), then the drafting request built
    from it (as ``serve_pass`` builds it) with speculation off and on: the
    two streams equal (the JAX package's MoE identity, tests/test_moe.py),
    verify steps run; and a seeded request. Returns the prompt and the
    streams the server must give."""
    from distributed_llama_multiusers_tpu_torch.runtime import (
        ContinuousBatchingScheduler,
        InferenceEngine,
        Request,
    )
    from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer

    tokenizer = Tokenizer(tok)

    def serve(spec: bool, reqs: list) -> dict:
        engine = InferenceEngine(config, params, n_lanes=DECODE_M, device=params.device)
        sched = ContinuousBatchingScheduler(engine, tokenizer, speculative=spec)
        sched.start()
        try:
            for r in reqs:
                sched.submit(r)
                r.future.result(timeout=600)
        finally:
            sched.stop()
        for r in reqs:
            check(r.error is None, f"moe in-process request failed: {r.error}")
        stats = engine.stats.snapshot()
        del engine
        return stats

    t0 = time.perf_counter()
    probe = Request(prompt="a" * SPEC_RUN, max_tokens=SPEC_PROBE_TOKENS, temperature=0.0)
    serve(False, [probe])
    prompt = "a" + probe.generated_text + "a" * SPEC_RUN
    plain = Request(prompt=prompt, max_tokens=GEN_TOKENS, temperature=0.0)
    # a seeded stream too: its draws follow every step's logits (the long
    # run of one token may settle the greedy stream on one token)
    seeded = Request(prompt="once upon a time", max_tokens=GEN_TOKENS, temperature=0.8,
                     topp=0.9, seed=7)
    serve(False, [plain, seeded])
    spec = Request(prompt=prompt, max_tokens=GEN_TOKENS, temperature=0.0)
    stats = serve(True, [spec])
    check(spec.generated_tokens == plain.generated_tokens,
          f"moe: the greedy stream with speculation parts from the one without at token "
          f"{_common_prefix(spec.generated_tokens, plain.generated_tokens)}")
    check(stats["spec_steps"] > 0, "moe: no verify step ran with speculation on")
    out = {"prompt": prompt, "text": plain.generated_text, "seeded_text": seeded.generated_text,
           "tokens": len(plain.generated_tokens),
           "distinct_tokens": {"greedy": len(set(plain.generated_tokens)),
                               "seeded": len(set(seeded.generated_tokens))},
           "spec_steps": stats["spec_steps"],
           "spec_lane_steps": stats["spec_lane_steps"], "spec_emitted": stats["spec_emitted"],
           "seconds": time.perf_counter() - t0}
    log("moe streams in process (speculation on equals off): "
        + json.dumps({k: v for k, v in out.items() if k not in ("prompt", "text",
                                                                 "seeded_text")}))
    return out


def moe_serving_check(model: str, tok: str, stream: dict) -> dict:
    """``dllama_api`` with its defaults (speculation and grammar on) on the
    Mixtral-width file: 4 requests at once on its 8 lanes (the drafting
    greedy completion, a seeded one, a streamed greedy chat and a flags
    json_schema): every stream finishes, the constrained answer parses and
    conforms, the greedy and the seeded completions are the in-process
    streams, no graph is captured after warmup, the router and the Q40
    kernels launched."""
    srv = Server(model, tok, "moe")
    try:
        bodies = [
            ("/v1/completions", {"prompt": stream["prompt"], "max_tokens": GEN_TOKENS,
                                 "temperature": 0}),
            ("/v1/completions", {"prompt": "once upon a time", "max_tokens": GEN_TOKENS,
                                 "temperature": 0.8, "top_p": 0.9, "seed": 7}),
            ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hello"}],
                                      "max_tokens": GEN_TOKENS, "temperature": 0,
                                      "stream": True}),
            ("/v1/completions", {"prompt": "fill the flags", "max_tokens": 96,
                                 "temperature": 0, "response_format": G_FLAGS}),
        ]
        t0 = time.perf_counter()
        results = _grammar_concurrent(srv.base, bodies)
        batch_s = time.perf_counter() - t0
        for (route, body), (status, text, finish) in zip(bodies, results):
            check(status == 200 and finish in ("stop", "length"),
                  f"moe server: {route} gave {status} {text!r} finish {finish}")
        for i, key in ((0, "text"), (1, "seeded_text")):
            check(results[i][1] == stream[key], f"moe server: completion {i} differs from "
                  f"the in-process stream:\n{results[i][1]!r}\n{stream[key]!r}")
        check(results[3][2] == "stop", f"moe server: the flags answer did not finish: "
                                       f"{results[3][1]!r}")
        try:
            obj = json.loads(results[3][1])
        except ValueError:
            obj = None
        check(_conforms(G_FLAGS, obj), f"moe server: the flags answer {results[3][1]!r}")
        stats = srv.stats()
        check(stats["jit_compiles_after_warmup"] == 0,
              f"moe server: {stats['jit_compiles_after_warmup']} graphs captured after warmup")
        check(stats["moe_route_launches"] > 0 and stats["kernel_launches"]["q40_slab"] > 0,
              f"moe server: moe_route {stats['moe_route_launches']}, Q40 "
              f"{stats['kernel_launches']}")
        check(stats["grammar_masked_steps"] > 0 and stats["spec_steps"] > 0,
              f"moe server: grammar masked steps {stats['grammar_masked_steps']}, verify "
              f"steps {stats['spec_steps']}")
        p = {**_grammar_pass("moe", stats), "moe_route_launches": stats["moe_route_launches"],
             "batch_s": batch_s, "startup_s": srv.startup_s,
             "spec_steps": stats["spec_steps"], "decode_graphs": stats["decode_graphs"],
             "decode_graph_replays": stats["decode_graph_replays"]}
        log_text = srv.stop()
        for phrase in ("Experts: 8  Active: 2", "Q40 weights resident"):
            check(phrase in log_text, f"moe server: the startup log does not say {phrase!r}")
        log(f"moe server: 4 streams in {batch_s:.2f}s (started in {srv.startup_s:.1f}s), "
            f"launches: moe_route {p['moe_route_launches']}, Q40 {p['kernel_launches']}, "
            f"decode_attn {p['decode_attn_launches']}; flags answer {obj}")
        return p
    except BaseException:
        srv.tail()
        raise
    finally:
        srv.kill()


def moe_mesh_steps(torch, q, rc, cs, config, params) -> dict:
    """The MoE v4 decode step at tp = 2 and tp = 2 x ep = 2 (the host's
    cards; one card named for every rank where there is one), replayed from
    its graph (``step_breakdown``, which holds the Q40 launches to
    ``products_per_step``): device time and Q40 launches a rank, L x (3 +
    tp + 3 E / ep) for the layers, each ep rank running only its own
    experts' products, and wcls on the ep-0 ranks."""
    from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh

    out = {}
    for name, plan in (("tp2", MeshPlan(tp=2)), ("tp2_ep2", MeshPlan(tp=2, ep=2))):
        mesh = make_mesh(plan, rank_devices(torch, plan.n_devices))
        b = step_breakdown(torch, q, rc, cs, config, params, "v4", mesh=mesh,
                           label=f"moe {name} v4", steps=5)
        q40 = sum(v for k, v in b["launches_per_step"].items() if k in q.KERNELS)
        # a rank's layer products; wcls on the ep-0 ranks only
        layers = config.n_layers * (3 + plan.tp + 3 * config.n_experts // plan.ep)
        check(q40 == layers * plan.n_devices + plan.n_devices // plan.ep,
              f"moe {name}: {q40} Q40 launches a step, {layers} a rank's layers expected")
        out[name] = {"ranks": plan.n_devices, "q40_launches_per_step": q40,
                     "q40_launches_per_rank": {"layers": layers, "ep0_with_wcls": layers + 1},
                     "device_ms_per_step": b["device_ms_per_step"],
                     "device_ops_per_step": b["device_ops_per_step"],
                     "step_ms_p50": b["step_ms_p50"],
                     "q40_kernels_ms_per_step": b["q40_kernels_ms_per_step"],
                     "ring_hop_launches_per_step": b["ring_hop_launches_per_step"],
                     "sync_bytes_per_decode": b["sync_bytes_per_decode"]}
    log("moe mesh decode steps: " + json.dumps(out))
    return out


def moe_phase(torch, q, rc, cs, cm) -> dict:
    """Phase 4d: the router kernel, then the Mixtral-width MoE model (2
    layers, random Q40 blocks) on the card: the forward against the CPU's,
    its v4 decode and verify steps replayed from their graphs
    (``step_breakdown``), tp = 2 on both wires against tp = 1, speculation
    on against off in process, and ``dllama_api`` serving it."""
    from distributed_llama_multiusers_tpu_torch.formats import load_model_header
    from distributed_llama_multiusers_tpu_torch.models import load_params_from_m_quantized

    t0 = time.perf_counter()
    kernel = moe_kernel_phase(torch, cm)
    model, tok = ensure_model(mixtral_header(), seed=0, write=write_random_q40_model)
    t_load = time.perf_counter()
    config, params = load_params_from_m_quantized(model, load_model_header(model),
                                                  dtype=torch.bfloat16, device="cuda")
    load_s = time.perf_counter() - t_load
    cpu = moe_cpu_check(torch, config, params)
    step = step_breakdown(torch, q, rc, cs, config, params, "v4", label="moe v4")
    # the expert stacks' packed planes, every expert read once a step
    expert_bytes = sum(w.packed.numel() + 2 * w.scales.numel()
                       for w in (params.layers.w1, params.layers.w2, params.layers.w3))
    all_bytes = sum(q.bound_bytes(DECODE_M, w.d_in, w.d_out, "v4")
                    for w in step_products(params))
    step["bound_ms_expert_bytes"] = expert_bytes / HBM_BYTES_S * 1e3
    step["bound_ms_products"] = all_bytes / HBM_BYTES_S * 1e3
    step["products_per_step"] = len(step_products(params))
    tp = moe_tp_check(torch, config, params)
    mesh_steps = moe_mesh_steps(torch, q, rc, cs, config, params)
    stream = moe_stream_check(torch, config, params, tok)
    del params
    torch.cuda.empty_cache()
    serving = moe_serving_check(model, tok, stream)
    out = {"kernel": kernel, "load_s": load_s, "cpu": cpu, "tp2": tp,
           "mesh_steps": mesh_steps,
           "stream": {k: v for k, v in stream.items() if k != "prompt"},
           "serving": serving,
           "step": {k: v for k, v in step.items() if k not in ("eager", "prefill_logits")},
           "seconds": time.perf_counter() - t0}
    log(f"moe phase: {out['seconds']:.1f}s; v4 decode step {step['device_ms_per_step']:.3f} ms "
        f"of device time ({step['device_ops_per_step']} operations, "
        f"{step['products_per_step']} products, Q40 kernels {step['q40_kernels_ms_per_step']:.3f} "
        f"ms against the expert bytes' {step['bound_ms_expert_bytes']:.3f} ms)")
    return out


# ---------------------------------------------------------------------------
# Phase 4e: the fleet (dllama_router over replicas) and disaggregated prefill
# ---------------------------------------------------------------------------

# the launch counters a replica's /stats carries, kept as a main-path pass
PASS_COUNTS = ("kernel_launches", "ring_hop_launches", "ring_hop_bytes",
               "gumbel_sample_launches", "decode_attn_launches", "decode_attn_window_launches",
               "decode_attn_paged_launches", "decode_attn_f8_launches",
               "grammar_mask_argmax_launches", "grammar_next_launches", "moe_route_launches")
# the disaggregation threshold of the fleet's router: below the default
# pass's greedy prompt (about 1,918 characters), far below the default 8,000
FLEET_DISAGG_CHARS = 1000


class Router:
    """One ``dllama_router`` process over ``replicas`` (``Server``s) on a
    free port, healthy on return (it scrapes every replica before it
    listens); ``stop`` SIGTERMs it and checks exit 0."""

    def __init__(self, replicas: list, name: str, args=()):
        self.name = name
        self.base = f"http://127.0.0.1:{_free_port()}"
        cmd = [sys.executable, "-m", f"{PKG}.app.dllama_router", "--replicas",
               *[r.base.removeprefix("http://") for r in replicas], "--host", "127.0.0.1",
               "--port", self.base.rsplit(":", 1)[1], *args]
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")
        self.log_path = os.path.join(OUT_DIR, f"chip_smoke_router_{name}.log")
        with open(self.log_path, "w") as logf:
            self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=logf,
                                         stderr=subprocess.STDOUT)
        t0 = time.perf_counter()
        while True:
            check(self.proc.poll() is None, f"router ({name}) exited {self.proc.returncode}; "
                                            f"see {self.log_path}")
            try:
                if _http(self.base + "/health", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            check(time.perf_counter() - t0 < 60, f"router ({name}) not healthy")
            time.sleep(0.2)

    def stats(self) -> dict:
        return json.loads(_http(self.base + "/stats")[1])

    def stop(self) -> None:
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"router ({self.name}) did not exit after SIGTERM") from None
        check(rc == 0, f"router ({self.name}) exited {rc} after SIGTERM")

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def start_servers(model: str, tok: str, specs: list) -> list:
    """``Server(model, tok, name, args)`` for each (name, args), all started
    together (each loads the model and captures its graphs beside the
    others; the kernels are already built); a failure ends them all."""
    out: list = [None] * len(specs)
    errors: list = []

    def start(i, name, args):
        try:
            out[i] = Server(model, tok, name, args)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=start, args=(i, n, a)) for i, (n, a) in enumerate(specs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        for srv in out:
            if srv is not None:
                srv.kill()
        raise errors[0]
    return out


def _counts_pass(mode: str, stats: dict) -> dict:
    """A replica's launch counters as a main-path pass."""
    return {"mode": mode, **{k: stats.get(k, 0) for k in PASS_COUNTS}}


def fleet_phase(model: str, tok: str, durability: dict, f8_paged: dict) -> dict:
    """The router over port replicas, four servers started together: (a)
    placement and affinity: ``dllama_router`` over two paged replicas (r1
    with 8 lanes, r2 with 4, ``--reconnect-grace 30``, journal on; the
    router scrapes once, so keyless requests go to the replica with more
    free lanes): two requests on the 1,900-token run land on one replica,
    which shares the second's first 1,024 tokens from its prefix tree;
    every response names its replica (``X-DLlama-Replica``). (b) Live
    migration: the durability phase's 4 streamed requests (2 greedy, 2
    seeded, 256 tokens) through the router land on r1, which is SIGKILLed
    once each stream holds 32 deltas; the router migrates each to r2, and
    each client's whole text equals the durability phase's reference
    stream of the same request on one server, its router event ids 1..N
    with none lost or repeated; the time from the kill to the first
    migrated byte. (c) Disaggregated prefill with the f8 KV cache: a
    ``--role prefill`` and a ``--role decode`` replica, both ``--kv-dtype
    f8 --paged-kv on``, behind a router with ``--disagg-threshold``
    FLEET_DISAGG_CHARS: the f8 paged pass's greedy prompt (1,918 tokens),
    streamed, hands off at its first token; the client's text equals that
    monolithic f8 paged server's, the decode replica adopted the pages and
    shared 1,024 prompt tokens, neither replica captured a graph after
    warmup; TTFT, the hand-off's ms and the bundle's bytes printed; then a
    live session's f8 bundle pushed to the bf16 replica r2 is refused with
    a typed 422 and r2's pool is unchanged."""
    t0 = time.perf_counter()
    out: dict = {}
    journals = [os.path.join(OUT_DIR, f"chip_smoke_fleet_{n}.bin") for n in ("r1", "r2")]
    for j in journals:
        if os.path.exists(j):
            os.remove(j)
    grace = ("--reconnect-grace", DUR_GRACE)
    r1, r2, pf, dc = start_servers(model, tok, [
        ("fleet-r1", PAGED_ARGS + grace + ("--replica-id", "r1", "--journal-path", journals[0])),
        ("fleet-r2", PAGED_ARGS + grace + ("--replica-id", "r2", "--journal-path", journals[1],
                                           "--max-lanes", "4")),
        ("fleet-prefill", F8_ARGS + PAGED_ARGS + ("--role", "prefill", "--replica-id", "p")),
        ("fleet-decode", F8_ARGS + PAGED_ARGS + grace + ("--role", "decode",
                                                          "--replica-id", "d"))])
    servers = [r1, r2, pf, dc]
    # a buffered answer carries the replica's own X-DLlama-Replica; a
    # router's stream names the replica by the address it routes to
    names = {}
    for srv, rid in zip(servers, ("r1", "r2", "p", "d")):
        names[rid] = names[srv.base.removeprefix("http://")] = rid
    routers: list = []
    out["startup_s"] = time.perf_counter() - t0
    try:
        # (a) placement and affinity
        router = Router([r1, r2], "fleet", ("--scrape-interval", "60"))
        routers.append(router)
        served, saved = [], []
        for tail in (" first", " second"):
            status, headers, raw = _request(router.base + "/v1/completions", {
                "prompt": "a" * SPEC_RUN + tail, "max_tokens": 8, "temperature": 0})
            check(status == 200, f"fleet (a): status {status}: {raw[:200]!r}")
            served.append(names.get(headers.get("X-DLlama-Replica")))
            saved.append(json.loads(raw)["summary"]["prefix_tokens_saved"])
        warm = {"r1": r1, "r2": r2}.get(served[0])
        check(warm is not None and served[1] == served[0],
              f"fleet (a): the shared run landed on {served}")
        wstats = warm.stats()
        check(saved == [0, 1024] and wstats["pool_prefix_admits"] >= 1,
              f"fleet (a): prompt tokens shared {saved}, prefix admits "
              f"{wstats['pool_prefix_admits']}")
        out["affinity"] = {"replica": served[0], "prefix_tokens_saved": saved}
        log(f"fleet (a): the 1,900-token run twice through the router, both on {served[0]} "
            f"(X-DLlama-Replica), the second sharing {saved[1]} tokens from its prefix tree")

        # (b) live migration off a SIGKILLed replica
        streams = [SseStream(router.base + route, body) for route, body in DUR_BODIES]
        _poll(lambda: all(len(st.events) >= DUR_MIN_EVENTS for st in streams)
              or any(st.done or st.error for st in streams), 300,
              "fleet (b): the streams never reached 32 deltas", every=0.005)
        check(all(not st.done and st.error is None for st in streams),
              "fleet (b): a stream ended before the kill")
        homes = {names.get(st.replica) for st in streams}
        check(homes == {"r1"}, f"fleet (b): the 4 streams are on {homes}, expected r1 (the "
                               "replica with more free lanes)")
        held = [len(st.events) for st in streams]
        t_kill = time.perf_counter()
        r1.proc.kill()  # SIGKILL: no drain
        r1.proc.wait(timeout=60)
        for st in streams:
            st.join()
        lost = dup = 0
        for i, (st, ref) in enumerate(zip(streams, durability["reference"])):
            check(st.done and st.error is None, f"fleet (b) stream {i}: done {st.done}, "
                                                f"error {st.error}")
            ids = [e for e, _ in st.events]
            dup += len(ids) - len(set(ids))
            lost += len(set(range(1, max(ids) + 1)) - set(ids))
            text = "".join(t for _, t in st.events)
            check(text == ref["text"], f"fleet (b) stream {i}: the migrated text differs from "
                                       f"the reference:\n{text!r}\n{ref['text']!r}")
            check(st.finish == ref["finish"], f"fleet (b) stream {i}: finish {st.finish}")
        check(lost == 0 and dup == 0, f"fleet (b): {lost} event ids lost, {dup} repeated")
        # deltas the router had read before the kill still arrive after it:
        # a stream's first migrated delta follows its longest silence
        firsts = []
        for st in streams:
            after = [i for i, t in enumerate(st.stamps) if t > t_kill]
            gaps = [(st.stamps[i] - st.stamps[i - 1], i) for i in after if i > 0]
            firsts.append(st.stamps[max(gaps)[1]] - t_kill)
        first_byte = min(firsts)
        mig_sum = _metric(router.base, "dllama_router_migration_seconds_sum")
        mig_n = _metric(router.base, "dllama_router_migration_seconds_count")
        rstats = router.stats()
        check(rstats["router_migrations_ok"] == 4 and rstats["router_migrations_failed"] == 0,
              f"fleet (b): router migrations ok {rstats['router_migrations_ok']}, failed "
              f"{rstats['router_migrations_failed']}")
        s2 = r2.stats()
        check(s2["jit_compiles_after_warmup"] == 0 and s2["decode_attn_launches"] > 0,
              f"fleet (b): r2 captured {s2['jit_compiles_after_warmup']} graphs after warmup")
        out["migration"] = {"deltas_before_kill": held, "kill_to_first_migrated_byte_s":
                            first_byte, "kill_to_first_migrated_byte_s_by_stream": firsts,
                            "router_break_to_resumed_byte_s_mean":
                                None if not mig_n else mig_sum / mig_n,
                            "router": {k: rstats[k] for k in (
                                "router_migrations_ok", "router_migrations_failed",
                                "router_routed_total", "fleet_affinity_hits")}}
        log(f"fleet (b): 4 streams (2 greedy, 2 seeded) on r1 SIGKILLed after {held} deltas, "
            f"migrated to r2 by the router: byte-identical to the reference, 0 ids lost, 0 "
            f"repeated; kill to the first migrated byte {first_byte * 1e3:.0f} ms (by stream "
            f"{[round(f * 1e3) for f in firsts]} ms), the router's break to resumed byte "
            f"{(mig_sum / mig_n * 1e3) if mig_n else float('nan'):.0f} ms on average")
        router.stop()

        # (c) disaggregated prefill over the f8 KV cache
        route_, body = f8_paged["bodies"][0]
        body = {**body, "stream": True}
        dis = Router([pf, dc], "disagg", ("--disagg-threshold", str(FLEET_DISAGG_CHARS)))
        routers.append(dis)
        check(len(body["prompt"]) >= FLEET_DISAGG_CHARS, "fleet (c): the prompt is short")
        t_req = time.perf_counter()
        st = SseStream(dis.base + route_, body).join()
        check(st.done and st.error is None, f"fleet (c): done {st.done}, error {st.error}")
        text = "".join(t for _, t in st.events)
        check(text == f8_paged["greedy_text"], "fleet (c): the disaggregated text differs from "
                                               "the monolithic f8 paged server's:\n"
                                               f"{text!r}\n{f8_paged['greedy_text']!r}")
        check(names.get(st.replica) == "p", f"fleet (c): served first by {st.replica}, not the "
                                            "prefill replica")
        ds = dis.stats()
        check(ds["router_disagg_handoffs_ok"] == 1 and ds["router_disagg_fallbacks"] == 0,
              f"fleet (c): hand-offs {ds['router_disagg_handoffs_ok']}, fallbacks "
              f"{ds['router_disagg_fallbacks']}")
        handoff_s = _metric(dis.base, "dllama_router_disagg_handoff_seconds_sum")
        sd, sp = dc.stats(), pf.stats()
        check(sd["pool_adopts"] >= 1 and sd["prefix_tokens_saved"] == 1024,
              f"fleet (c): the decode replica adopted {sd['pool_adopts']} bundles, shared "
              f"{sd['prefix_tokens_saved']} prompt tokens (expected 1024)")
        for name, st_ in (("prefill", sp), ("decode", sd)):
            check(st_["jit_compiles_after_warmup"] == 0 and st_["decode_attn_f8_launches"] > 0,
                  f"fleet (c): the {name} replica captured {st_['jit_compiles_after_warmup']} "
                  f"graphs after warmup, {st_['decode_attn_f8_launches']} e4m3 attention "
                  "launches")
        # a live f8 session's bundle, pushed to the bf16 replica r2
        live = SseStream(dc.base + route_, {**body, "max_tokens": DUR_TOKENS})
        _poll(lambda: len(live.events) >= 1 or live.done or live.error, 120,
              "fleet (c): the live f8 session never streamed")
        status, _, raw = _request(dc.base + f"/admin/kvpages/{live.rid}")
        check(status == 200, f"fleet (c): the decode replica's kvpages export: {status}")
        bundle = json.loads(raw)
        page_bytes = len(base64.b64decode(bundle["blocks"][0]["p"]))
        before = r2.stats()
        status, _, refusal = _request(r2.base + "/admin/kvimport", bundle)
        after = r2.stats()
        refusal = json.loads(refusal)
        check(status == 422 and refusal.get("reason") == "page_bytes",
              f"fleet (c): the bf16 replica answered {status} {refusal}")
        check(all(after[k] == before[k] for k in ("pool_pages_free", "pool_adopts",
                                                    "pool_pages_in_use")),
              "fleet (c): the refused bundle changed the bf16 replica's pool")
        live.join()
        out["disagg"] = {
            "prompt_chars": len(body["prompt"]), "ttft_ms": (st.first_at - t_req) * 1e3,
            "handoff_ms": None if handoff_s is None else handoff_s * 1e3,
            "pages_moved": ds["router_disagg_pages_moved"],
            "pages_fresh": ds["router_disagg_pages_fresh"], "page_bytes": page_bytes,
            "bundle_payload_bytes": ds["router_disagg_pages_moved"] * page_bytes,
            "bundle_json_bytes": len(raw), "decode_prefix_tokens_saved": sd["prefix_tokens_saved"],
            "refusal": {"status": status, "reason": refusal.get("reason")}}
        log("fleet (c): " + json.dumps(out["disagg"]))
        dis.stop()
        out["passes"] = [_counts_pass("fleet-r2", r2.stats()), _counts_pass(
            "fleet-prefill", pf.stats()), _counts_pass("fleet-decode", dc.stats())]
        for srv in (r2, pf, dc):
            srv.stop()
    except BaseException:
        for srv in servers:
            if srv.proc.poll() is None:
                srv.tail()
        raise
    finally:
        for r in routers:
            r.kill()
        for srv in servers:
            srv.kill()
    out["seconds"] = time.perf_counter() - t0
    log(f"fleet phase: {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# Phase 4f: the pod (tensor parallelism across two processes on the card)
# ---------------------------------------------------------------------------

POD_DEVICE = "cuda:0"  # both processes of a pod share the host's first card
POD_KILL_DEADLINE_S = 5.0  # --step-deadline of the pod whose worker is killed
POD_KILL_DELTAS = 3  # deltas the stream holds before the kill
# the paged pod: 48 pages of 64 tokens (a 1,900-token run reserves 30 and
# parks 29, so a second run's admission swaps the first's parked pages out
# to the host tier), 4 parked sessions, a 256 MiB host tier; the decode end
# of the pods' hand-off
POD_PAGED_POOL = 48
POD_PAGED_ARGS = (*PAGED_ARGS, "--kv-pool-pages", str(POD_PAGED_POOL), "--kv-max-parked", "4",
                  "--kv-host-bytes", str(256 << 20), "--role", "decode",
                  "--reconnect-grace", DUR_GRACE)
# the pods whose ring steps and page reads go over TCP links on loopback (the
# transport of a pod across hosts, DLLAMA_POD_TRANSPORT=socket); the other
# two keep CUDA IPC
POD_SOCKET = ("pod", "pod-kill")
# the pod whose worker is killed is paged too, and first the hand-off's
# prefill end
POD_PREFILL_ARGS = (*PAGED_ARGS, "--role", "prefill", "--step-deadline",
                    str(POD_KILL_DEADLINE_S))
# a prompt of 3 whole pages, exported from the paged pod's root and from the
# paged phase's one-process tp2 engine
POD_EXPORT_PROMPT = "e" * 200
# the hand-off's prompt: its first 1,024 tokens (16 pages) are shared on the
# decode pod after the adoption
HANDOFF_PROMPT = "c" * 1100 + " hand-off"
HANDOFF_TOKENS = 48


class PodServer:
    """A two-process pod on ``cuda:0``: ``dllama worker`` (process 1) and
    ``dllama_api`` as its root (process 0, serving HTTP), each holding one
    rank of ``--workers 2``, the ring steps between them through their
    windows. The processes start at once; ``wait`` returns when the root is
    healthy. ``stop`` SIGTERMs the root, checks that both exit 0 (the
    root's drain stops the worker) and returns the root's log; ``kill``
    ends both; ``worker_exit`` is the worker's counters as it logged them
    at its exit, ``idle_counters`` the root's ``/stats`` and the worker's
    counters (SIGUSR1) once the pod idles. With ``kill_at_stop`` set,
    ``stop`` runs ``pod_kill_check`` instead (its result in ``kill_out``)
    and returns the root's log. Serves ``serve_pass`` as a ``Server`` does.
    ``transport``: ``socket`` (both processes with
    ``DLLAMA_POD_TRANSPORT=socket``) or ``ipc``."""

    def __init__(self, model: str, tok: str, name: str, args=(), log_dir: str = OUT_DIR,
                 transport: str = "ipc"):
        os.makedirs(log_dir, exist_ok=True)
        self.name = name
        self.transport = transport
        self.kill_at_stop, self.kill_out = False, None
        port = _free_port()
        self.base = f"http://127.0.0.1:{port}"
        pod = ["--model", model, "--tokenizer", tok, "--workers", "2", "--device", POD_DEVICE,
               "--coordinator", f"127.0.0.1:{_free_port()}", "--num-processes", "2", *args]
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")
        env.pop("DLLAMA_DEQUANT", None)
        env.pop("DLLAMA_POD_TRANSPORT", None)
        if transport == "socket":
            env["DLLAMA_POD_TRANSPORT"] = "socket"
        self.log_path = os.path.join(log_dir, f"chip_smoke_pod_{name}_root.log")
        self.worker_log_path = os.path.join(log_dir, f"chip_smoke_pod_{name}_worker.log")
        self.t0 = time.perf_counter()
        with open(self.worker_log_path, "w") as logf:
            self.worker = subprocess.Popen(
                [sys.executable, "-m", f"{PKG}.app.dllama", "worker", *pod, "--process-id", "1"],
                cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT)
        with open(self.log_path, "w") as logf:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", f"{PKG}.app.dllama_api", *pod, "--process-id", "0",
                 "--host", "127.0.0.1", "--port", str(port)],
                cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT)
        self.startup_s = None

    def wait(self, timeout: float = 900.0) -> "PodServer":
        try:
            while True:
                for proc, what in ((self.proc, "root"), (self.worker, "worker")):
                    check(proc.poll() is None, f"pod ({self.name}): the {what} exited with "
                                               f"{proc.returncode}")
                try:
                    if _http(self.base + "/health", timeout=5)[0] == 200:
                        break
                except OSError:
                    pass
                check(time.perf_counter() - self.t0 < timeout, f"pod ({self.name}) not healthy")
                time.sleep(0.1)
        except BaseException:
            self.tail()
            self.kill()
            raise
        self.startup_s = time.perf_counter() - self.t0
        return self

    def stop(self) -> str:
        if self.kill_at_stop:
            self.kill_out = pod_kill_check(self)
            with open(self.log_path, errors="replace") as f:
                return f.read()
        self.proc.send_signal(signal.SIGTERM)
        for proc, what in ((self.proc, "root"), (self.worker, "worker")):
            try:
                rc = proc.wait(timeout=90)
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"pod ({self.name}): the {what} did not exit after the "
                                   "root's SIGTERM") from None
            check(rc == 0, f"pod ({self.name}): the {what} exited {rc} after the root's SIGTERM")
        with open(self.log_path, errors="replace") as f:
            return f.read()

    def worker_exit(self) -> dict:
        with open(self.worker_log_path, errors="replace") as f:
            lines = [ln for ln in f if ln.startswith('{"event": "worker_exit"')]
        check(bool(lines), f"pod ({self.name}): the worker logged no exit counters")
        return json.loads(lines[-1])

    def idle_counters(self, timeout: float = 60.0) -> tuple:
        """(the root's ``/stats``, the worker's counters) once the pod
        idles: the worker's ``worker_counters`` line (SIGUSR1; it stays
        up, its keys ``worker_exit``'s) shows the root's packets and ring
        steps in two rounds running."""
        def lines():
            with open(self.worker_log_path, errors="replace") as f:
                return [ln for ln in f if ln.startswith('{"event": "worker_counters"')]

        end, seen, last = time.perf_counter() + timeout, len(lines()), None
        while time.perf_counter() < end:
            stats = _json_call(self.base, "/stats")[2]
            self.worker.send_signal(signal.SIGUSR1)
            _poll(lambda: len(lines()) > seen, 30,
                  f"pod ({self.name}): the worker logged no counters on SIGUSR1")
            got = lines()
            seen, counters = len(got), json.loads(got[-1])
            now = tuple((stats[k], counters[k]) for k in ("pod_packets", "pod_ring_steps"))
            if all(a == b for a, b in now) and now == last:
                return stats, counters
            last = now
            time.sleep(0.2)
        raise SmokeFailure(f"pod ({self.name}) never idled: root and worker at {last}")

    def tail(self) -> None:
        for path in (self.log_path, self.worker_log_path):
            with open(path, errors="replace") as f:
                lines = f.readlines()[-30:]
            print(f"--- last lines of {path}:\n" + "".join(lines), file=sys.stderr, flush=True)

    def kill(self) -> None:
        for proc in (self.proc, self.worker):
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def pod_specs(devices: str) -> list:
    """(pod name, the tp=2 pass it must equal, its dequant mode, its
    arguments) of the two serving pods: the tp2 passes' modes and wires
    (``tp_pass_specs``), one rank a process."""
    out = []
    for (name, mode, extra, _, _), pod in zip(tp_pass_specs(devices), ("pod", "pod-q80-auto")):
        out.append((pod, name, mode, extra[4:]))  # past --workers 2 --device ...
    return out


def start_pods(torch, model: str, tok: str) -> tuple[dict, str, subprocess.Popen]:
    """The pod phase's four pods, spawned at once (they load and warm
    beside the phases before theirs): the two contiguous serving pods, the
    paged pod (``--role decode``) and a paged ``--role prefill`` pod with
    ``--step-deadline``, the hand-off's source, whose worker the phase then
    kills; the card's compute mode, which must let several processes share
    it; and the hop's processes (``start_pod_hop``)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    mode = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    check("Exclusive_Process" not in mode,
          f"the card's compute mode is {mode}: a pod's two processes cannot share it")
    devices = ",".join(str(d) for d in rank_devices(torch, 2))

    def transport(name):
        return "socket" if name in POD_SOCKET else "ipc"

    pods = {name: PodServer(model, tok, name, pass_args(mode_, extra), transport=transport(name))
            for name, _, mode_, extra in pod_specs(devices)}
    pods["pod-paged"] = PodServer(model, tok, "pod-paged", pass_args(None, POD_PAGED_ARGS),
                                  transport=transport("pod-paged"))
    pods["pod-kill"] = PodServer(model, tok, "pod-kill", POD_PREFILL_ARGS,
                                 transport=transport("pod-kill"))
    return pods, mode, start_pod_hop()


def _pod_pass(model: str, tok: str, pod: PodServer, mode, extra, tp: dict,
              checks=None, kill: bool = False) -> dict:
    """One serving pod: ``serve_pass``'s 4 concurrent requests and checks;
    its streams equal the tp=2 pass ``tp`` of the same wire, byte for byte
    (the bodies, the greedy text, the concurrent texts); the ring hop
    launched in the root and in the worker; the serving paths ran (the
    pipelined chain with fused admissions and verify steps, no flush, no
    decode graph); the root's and the worker's ring_hop launches equal (the
    same ring steps, nothing replayed outside the pod's requests after the
    warmup's counter reset); the eager step the root timed at startup and
    its ring waits (``pod_step_*`` in ``/stats``), the packet broadcast's
    microseconds. ``checks(base)`` (the paged pod's) runs after the pass,
    before the stop; its result is the pass's ``paged``, and the pod's
    launch counts are then those after it. ``kill``: after the checks,
    the idle worker's counters (SIGUSR1) stand for its exit line, and
    ``pod_kill_check`` kills it in place of the stop (the pass's
    ``kill``)."""
    def after(base):
        stats = json.loads(_http(base + "/stats")[1])
        found = checks(base) if checks is not None else None
        if kill:
            pod.kill_at_stop = True
            return stats, found, *pod.idle_counters()
        if checks is None:
            return stats, None, stats, None
        return stats, found, json.loads(_http(base + "/stats")[1]), None

    p = serve_pass(model, tok, mode, GEN_TOKENS, name=pod.name, extra_args=extra,
                   srv=pod.wait(), extra=after)
    stats, found, final, worker = p.pop("extra")
    killed = pod.kill_out
    launch_keys = ("ring_hop_launches", "ring_hop_bytes", "gumbel_sample_launches",
                   "decode_attn_launches", "decode_attn_window_launches",
                   "decode_attn_paged_launches", "grammar_mask_argmax_launches",
                   "grammar_next_launches")
    if found is not None:
        # the root's counts after every request the pod served, as the
        # worker's at its exit
        for k in (*launch_keys, "kernel_launches"):
            p[k] = final[k]
        p["paged"] = {**found, "root": {k: final[k] for k in ("swap_ins", "swap_in_bytes",
                                                             "kv_page_writes")}}
    step = {"step_ms": stats["pod_step_ms"], "wait_ms": stats["pod_step_wait_ms"],
            "wait_share": stats["pod_step_wait_share"]}
    if killed is None:
        worker = pod.worker_exit()
    else:
        p["kill"] = killed
    name = pod.name
    check(p["mesh"] is not None and p["mesh"]["tp"] == 2 and p["mesh"]["processes"] == 2,
          f"{name}: /stats mesh {p['mesh']}")
    for key in ("bodies", "greedy_text", "concurrent_texts"):
        check(p[key] == tp[key], f"{name}: {key} differs from the one-process {tp['mode']} "
                                 f"pass:\n{p[key]!r}\n{tp[key]!r}")
    check(p["ring_hop_launches"] > 0 and worker["ring_hop_launches"] == p["ring_hop_launches"],
          f"{name}: ring_hop launches root {p['ring_hop_launches']}, worker "
          f"{worker['ring_hop_launches']}")
    check(p["decode_graphs"] == 0 and p["graphs_captured"] == 0,
          f"{name}: {p['decode_graphs']} decode graphs on a pod")
    check(p["pipeline_dispatches"] > 0 and p["fused_steps"] > 0 and p["pipeline_flushes"] == 0
          and p["spec_pipelined_steps"] > 0,
          f"{name}: pipelined {p['pipeline_dispatches']}, fused {p['fused_steps']}, flushes "
          f"{p['pipeline_flushes']}, verify steps in the chain {p['spec_pipelined_steps']}")
    for k in ("gumbel_sample_launches", "decode_attn_launches", "grammar_mask_argmax_launches",
              "grammar_next_launches"):
        check(p[k] > 0 and worker[k] > 0, f"{name}: {k} root {p[k]}, worker {worker[k]}")
    for phrase in ("Pod root: control plane up", "no CUDA graphs on a pod",
                   *(("Pod workers sent stop",) if killed is None else ())):
        check(phrase in p["log"], f"{name}: the root's log does not say {phrase!r}")
    check(step["step_ms"] > 0 and 0 <= step["wait_share"] <= 1, f"{name}: pod step {step}")
    want = ("socket" if pod.transport == "socket" else
            "cuda-ipc" if POD_DEVICE.startswith("cuda") else "shared-memory files")
    check(stats["pod_transport"] == worker["pod_transport"] == want
          and f"ring steps across them over {want}" in p["log"],
          f"{name}: transport root {stats['pod_transport']}, worker {worker['pod_transport']}, "
          f"started as {pod.transport}")
    p["pod"] = {"transport": want, "step_ms": step["step_ms"], "wait_ms": step["wait_ms"],
                "wait_share": step["wait_share"],
                "broadcast_us": stats["pod_broadcast_us"], "packets": stats["pod_packets"],
                "ring_steps": stats["pod_ring_steps"], "root_ring_hop_launches":
                p["ring_hop_launches"], "worker": {k: v for k, v in worker.items()
                                                   if k not in ("event", "ts", "mono_s")}}
    # the main path's launches: the root's /stats and the worker's own
    for k in launch_keys:
        p[k] += worker[k]
    p["kernel_launches"] = {k: v + worker["kernel_launches"][k]
                            for k, v in p["kernel_launches"].items()}
    log(f"pod [{name}, {want}]: streams byte-identical to {tp['mode']}; ring_hop launches root "
        f"{p['pod']['root_ring_hop_launches']}, worker {worker['ring_hop_launches']}; eager step "
        f"(lanes parked, at the root's startup) {p['pod']['step_ms']:.2f} ms, ring waits "
        f"{p['pod']['wait_ms']:.2f} ms ({p['pod']['wait_share'] * 100:.1f}%); "
        f"{p['pod']['packets']} packets, "
        f"{p['pod']['broadcast_us']} us a broadcast; {p['pod']['ring_steps']} ring steps")
    return p


def _sse_text(resp) -> str:
    """The text of an SSE response's deltas (a reattached stream)."""
    text = ""
    for line in resp:
        line = line.decode().strip()
        if line.startswith("data: {"):
            chunk = json.loads(line[6:])
            check("error" not in chunk, f"stream error: {chunk}")
            for choice in chunk.get("choices") or ():
                text += choice.get("text") or ""
    return text


def pod_swap_check(base: str) -> dict:
    """On the paged pod (POD_PAGED_POOL pages, the host tier): X on the
    1,900-token run parks its pages, Y on another run needs them (X's swap
    out), X again comes back from the host tier: its stream X's, ``swap_ins``
    on the root's ``/stats``; the bytes the swap-in batch broadcast (whole
    pages in OP_KV_SWAP fragments of a packet slot each)."""
    from distributed_llama_multiusers_tpu_torch.parallel.multihost import ControlPlane

    def run(prompt):
        status, _, body = _json_call(base, "/v1/completions", {
            "prompt": prompt, "max_tokens": 8, "temperature": 0})
        check(status == 200, f"pod swap: {status} {body}")
        return body

    # runs no earlier request shares a chunk with: X's first admission is
    # cold, its second the one swap-in batch
    x, y = "x" * SPEC_RUN + " first", "y" * SPEC_RUN + " other"
    s1 = _json_call(base, "/stats")[2]
    first = run(x)
    run(y)
    s2 = _json_call(base, "/stats")[2]
    again = run(x)
    s3 = _json_call(base, "/stats")[2]
    check(_text(again) == _text(first), "pod swap: the swapped-in stream differs:\n"
                                        f"{_text(first)!r}\n{_text(again)!r}")
    pages = s3["swap_ins"] - s2["swap_ins"]
    check(s2["swap_outs"] > s1["swap_outs"] and s2["swap_ins"] == s1["swap_ins"]
          and pages > 0 and s3["pool_swap_in_admits"] == s1["pool_swap_in_admits"] + 1,
          f"pod swap: swap_outs {s1['swap_outs']} -> {s2['swap_outs']}, swap_ins "
          f"{s1['swap_ins']} -> {s2['swap_ins']} -> {s3['swap_ins']}")
    payload = s3["swap_in_bytes"] - s2["swap_in_bytes"]
    lanes = _load(base)["lanes_total"]
    plane = ControlPlane(lanes, chunk=1024)  # the server's: its largest prefill bucket
    packets = pages * -(-(payload // pages) // (plane.chunk * 4))
    out = {"swap_outs": s3["swap_outs"], "swap_ins": s3["swap_ins"], "batch_pages": pages,
           "batch_payload_bytes": payload, "batch_packets": packets,
           "batch_wire_bytes": packets * plane._size * 4,
           "request_swap_in_ms": again["summary"]["phases"]["swap_in_ms"],
           "ttft_ms_first": first["summary"]["ttft_s"] * 1e3,
           "ttft_ms_swapped_in": again["summary"]["ttft_s"] * 1e3}
    log("pod swap: " + json.dumps(out))
    return out


def pod_export_check(base: str, reference: dict) -> dict:
    """A live session of POD_EXPORT_PROMPT on the paged pod: its bundle
    (``GET /admin/kvpages/<id>``, the root reading the worker's heads of each
    page from its CUDA IPC region) holds the pages of the paged phase's
    one-process tp2 engine, byte for byte (sha256 of each payload); the
    route's ms and the root engine's export ms a page."""
    before = _json_call(base, "/stats")[2]
    live = SseStream(base + "/v1/completions", {"prompt": POD_EXPORT_PROMPT, "max_tokens": 48,
                                                "temperature": 0})
    _poll(lambda: len(live.events) >= 1 or live.done or live.error, 300,
          "pod export: the session never streamed")
    t0 = time.perf_counter()
    status, _, raw = _request(base + f"/admin/kvpages/{live.rid}")
    route_ms = (time.perf_counter() - t0) * 1e3
    check(status == 200, f"pod export: /admin/kvpages answered {status}: {raw[:200]!r}")
    blocks = json.loads(raw)["blocks"]
    got = [hashlib.sha256(base64.b64decode(b["p"])).hexdigest() for b in blocks]
    check(got == reference["sha256"],
          f"pod export: {len(got)} pages whose bytes differ from the one-process tp2 engine's "
          f"{len(reference['sha256'])}")
    live.join()
    after = _json_call(base, "/stats")[2]
    exports = after["kv_exports"] - before["kv_exports"]
    out = {"pages": len(got), "page_bytes": reference["page_bytes"], "route_ms": route_ms,
           "export_ms_per_page": (after["kv_export_ms"] - before["kv_export_ms"]) / exports,
           "one_process_tp2_export_ms_per_page": reference["export_ms_per_page"]}
    log("pod export: pages byte-equal to the one-process tp2 engine's; " + json.dumps(out))
    return out


def pod_handoff_check(prefill: PodServer, decode: PodServer) -> dict:
    """A disaggregated hand-off with a pod at each end: a live session on
    the paged ``--role prefill`` pod moves to the paged pod
    (``disagg.prefill.hand_off``: the ticket, the bundle read across the
    prefill pod's processes, its adoption through OP_KV_PAGES on both of the
    decode pod's, the session regenerated there); the decode pod's stream
    equals the prefill pod's own (the monolithic stream), byte for byte. A
    refused hand-off fails with the decode pod's logged cause
    (``kvimport_failed``) and both pods' last log lines."""
    from distributed_llama_multiusers_tpu_torch.disagg.prefill import HandoffAborted, hand_off

    decode_base = decode.base
    prefill.wait()
    before = _json_call(decode_base, "/stats")[2]
    src = SseStream(prefill.base + "/v1/completions", {"prompt": HANDOFF_PROMPT,
                                                       "max_tokens": HANDOFF_TOKENS,
                                                       "temperature": 0})
    _poll(lambda: len(src.events) >= 1 or src.done or src.error, 300,
          "pod hand-off: the prefill pod's session never streamed")
    host = "127.0.0.1"
    t0 = time.perf_counter()
    try:
        conn, resp, _, receipt = hand_off(host, int(prefill.base.rsplit(":", 1)[1]), src.rid,
                                          host, int(decode_base.rsplit(":", 1)[1]), timeout=120,
                                          read_timeout=600)
    except HandoffAborted as e:
        with open(decode.log_path, errors="replace") as f:
            causes = [ln.strip() for ln in f if ln.startswith('{"event": "kvimport_failed"')]
        prefill.tail()
        decode.tail()
        raise SmokeFailure(f"pod hand-off: {e}; the decode pod logged {causes}") from None
    handoff_ms = (time.perf_counter() - t0) * 1e3
    try:
        text = _sse_text(resp)
    finally:
        conn.close()
    src.join()
    check(src.done and src.error is None, f"pod hand-off: the prefill pod's stream: {src.error}")
    mono = "".join(t for _, t in src.events)
    check(text == mono, "pod hand-off: the decode pod's stream differs from the prefill pod's:"
                        f"\n{text!r}\n{mono!r}")
    after = _json_call(decode_base, "/stats")[2]
    check(receipt.get("fresh", 0) == receipt.get("pages", -1) > 0
          and after["pool_adopts"] == before["pool_adopts"] + 1
          and after["prefix_tokens_saved"] - before["prefix_tokens_saved"] == 1024,
          f"pod hand-off: receipt {receipt}, adopts {after['pool_adopts']}, tokens shared "
          f"{after['prefix_tokens_saved'] - before['prefix_tokens_saved']}")
    out = {"receipt": receipt, "handoff_ms": handoff_ms, "chars": len(text),
           "decode_kv_page_writes": after["kv_page_writes"] - before["kv_page_writes"]}
    log("pod hand-off (prefill pod -> paged pod): the stream byte-identical to the prefill "
        "pod's; " + json.dumps(out))
    return out


def pod_paged_checks(pods: dict, reference: dict):
    """The paged pod's checks after its pass: the swap tier, a page export
    against the one-process tp2 engine, the hand-off from the prefill pod."""
    def run(base):
        return {"swap": pod_swap_check(base), "export": pod_export_check(base, reference),
                "handoff": pod_handoff_check(pods["pod-kill"], pods["pod-paged"])}
    return run


def pod_kill_check(pod: PodServer) -> dict:
    """A pod whose worker is SIGKILLed mid-stream: the root, its stream
    waiting on the card for the dead worker's ring steps, exits with
    ``POD_LOST_EXIT_CODE`` (18) within ``POD_KILL_DEADLINE_S`` plus 30 s.
    Over CUDA IPC the pid watcher finds the lost worker; over sockets, with
    no pid watcher armed, a link does (or, either way, the control plane's
    broadcast); on ``pod-kill`` the step watchdog's deadline (exit 17) has
    not come. ``found_by``: the root's log line that named the loss."""
    from distributed_llama_multiusers_tpu_torch.parallel.multihost import POD_LOST_EXIT_CODE

    pod.wait()
    body = {"prompt": "a" * SPEC_RUN, "max_tokens": 256, "temperature": 0, "stream": True}
    req = urllib.request.Request(pod.base + "/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    deltas, t_kill = 0, None
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            for line in r:
                deltas += line.startswith(b"data: {")
                if deltas == POD_KILL_DELTAS:
                    pod.worker.kill()
                    t_kill = time.perf_counter()
                    pod.worker.wait(timeout=30)
                    break
    except OSError:
        pass
    check(t_kill is not None, f"pod-kill: the stream ended after {deltas} deltas")
    try:
        rc = pod.proc.wait(timeout=POD_KILL_DEADLINE_S + 30)
    except subprocess.TimeoutExpired:
        pod.tail()
        raise SmokeFailure("pod-kill: the root still runs "
                           f"{POD_KILL_DEADLINE_S + 30:.0f} s after its worker died") from None
    waited = time.perf_counter() - t_kill
    with open(pod.log_path, errors="replace") as f:
        lost = [json.loads(ln) for ln in f
                if ln.startswith(('{"event": "pod_peer_lost"', '{"event": "pod_lost"'))]
    check(rc == POD_LOST_EXIT_CODE, f"{pod.name}: the {pod.transport} pod's root exited {rc} "
                                    f"after its worker died, not {POD_LOST_EXIT_CODE}")
    found_by = ("none" if not lost else "control plane" if lost[-1]["event"] == "pod_lost"
                else "link" if "detail" in lost[-1] else "pid watcher")
    out = {"pod": pod.name, "transport": pod.transport, "root_exit": rc,
           "seconds_to_exit": waited, "found_by": found_by, "deadline_s": POD_KILL_DEADLINE_S,
           "deltas_before_kill": deltas}
    log("pod worker kill: " + json.dumps(out))
    return out


POD_HOP_GO = os.path.join(OUT_DIR, "pod_hop.go")


def start_pod_hop() -> subprocess.Popen:
    """``tools/pod_hop.py --small --transport socket`` started with the pods:
    its two processes join their pod and open their windows while the
    phases before the pod phase run, then wait for ``pod_hop_phase`` to
    create ``POD_HOP_GO``."""
    if os.path.exists(POD_HOP_GO):
        os.unlink(POD_HOP_GO)
    return subprocess.Popen([sys.executable, os.path.join(ROOT, "tools", "pod_hop.py"),
                             "--device", POD_DEVICE, "--small", "--transport", "socket",
                             "--go", POD_HOP_GO, "--timeout", "1200"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT)


def pod_hop_phase(hop: subprocess.Popen) -> dict:
    """The 32 KiB hop across two processes on the card over each transport
    (``start_pod_hop``'s processes, let go while the pods idle): every
    collective bit-equal to one process over the TCP links and over this
    host's CUDA IPC windows in the same processes, the two transports'
    digests equal; the hop's ms a step each way and the socket hop's bound
    (its wire bytes over one socket pair's loopback bandwidth)."""
    t0 = time.perf_counter()
    with open(POD_HOP_GO, "w"):
        pass
    try:
        stdout, stderr = hop.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        hop.kill()
        raise SmokeFailure("pod_hop --transport socket did not finish in 300 s") from None
    rows = [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]
    check(hop.returncode == 0 and len(rows) == 2,
          f"pod_hop --transport socket: exit {hop.returncode}\n{stdout[-2000:]}{stderr[-2000:]}")
    for row in rows:
        check(all(row["checks"].values()) and all(row["shared"]["checks"].values())
              and not row["failed"], f"pod_hop --transport socket: {row['failed']}")
        check(row["digests"] == row["shared"]["digests"],
              "pod_hop: the socket links' collectives differ from the shared windows'")
    out = {"hop_bytes": 32 * 1024,
           "socket_hop_ms": [r["pod_hop_us"] / 1e3 for r in rows],
           "ipc_hop_ms": [r["shared"]["pod_hop_us"] / 1e3 for r in rows],
           "one_process_hop_ms": [r["one_process_hop_us"] / 1e3 for r in rows],
           "socket_all_reduce_ms": [r["pod_all_reduce_us"] / 1e3 for r in rows],
           "ipc_all_reduce_ms": [r["shared"]["pod_all_reduce_us"] / 1e3 for r in rows],
           "socket_wait_ms": [r["pod_hop_wait_us"] / 1e3 for r in rows],
           "loopback_gbps": rows[0]["loopback_gbps"],
           "socket_hop_bound_ms": rows[0]["hop_bound_us"] / 1e3,
           "seconds": time.perf_counter() - t0}
    log(f"pod hop ({out['seconds']:.1f}s; 32 KiB, 2 processes, one card): socket "
        + json.dumps(out["socket_hop_ms"]) + " ms a step, IPC " + json.dumps(out["ipc_hop_ms"])
        + f" ms; socket bound {out['socket_hop_bound_ms']:.4f} ms at "
        f"{out['loopback_gbps']:.2f} GB/s loopback")
    return out


def pod_phase(model: str, tok: str, tp_passes: list, pods: dict, compute_mode: str,
              export_reference: dict, card: str, hop: subprocess.Popen) -> dict:
    """The pods started by ``start_pods``: the hop over both transports
    (``pod_hop_phase``), each contiguous serving pod's pass
    (``_pod_pass``) against the tp=2 pass of its wire, the paged pod's
    against the f32-wire one with its swap, export and hand-off checks
    (``pod_paged_checks``; the ring_hop launches of root and worker equal
    over all of it), then the paged pod's worker kill (over CUDA IPC), a
    page export from the socket prefill pod against the one-process tp2
    engine, then that pod's worker kill (over sockets). ``POD_SOCKET``'s
    pods run over TCP links, the others over CUDA IPC; the summary line
    sets each pod's eager step and batch tok/s beside the others', and the
    two kills' seconds to exit, with the card's name and power limit."""
    t0 = time.perf_counter()
    out = {"compute_mode": compute_mode, "passes": []}
    try:
        out["hop"] = pod_hop_phase(hop)
        by_mode = {p["mode"]: p for p in tp_passes}
        specs = pod_specs("cuda:0,cuda:0")
        for name, tp_name, mode, extra in specs:
            out["passes"].append(_pod_pass(model, tok, pods[name], mode, extra, by_mode[tp_name]))
        _, tp_name, _, _ = specs[0]
        paged = _pod_pass(model, tok, pods["pod-paged"], None, POD_PAGED_ARGS, by_mode[tp_name],
                          checks=pod_paged_checks(pods, export_reference), kill=True)
        # the worker replayed every swap-in batch and page write the root made
        worker, root = paged["pod"]["worker"], paged["paged"]["root"]
        check(all(worker[k] == root[k] for k in root) and root["swap_ins"] > 0
              and root["kv_page_writes"] >= paged["paged"]["handoff"]["receipt"]["fresh"],
              f"pod-paged: worker {[worker[k] for k in root]}, root {root}")
        out["passes"].append(paged)
        out["paged"] = {**paged["paged"], "tokens_per_s_batch": paged["tokens_per_s_batch"],
                        "contiguous_pod_tokens_per_s_batch":
                            out["passes"][0]["tokens_per_s_batch"]}
        log(f"pod-paged: batch {paged['tokens_per_s_batch']:.1f} tok/s against the contiguous "
            f"pod's {out['passes'][0]['tokens_per_s_batch']:.1f} in this run")
        # the socket prefill pod's root reads its worker's heads over TCP
        out["socket_export"] = pod_export_check(pods["pod-kill"].base, export_reference)
        out["kill"] = pod_kill_check(pods["pod-kill"])
        out["ipc_kill"] = paged["kill"]
        summary = {p["mode"]: {"transport": p["pod"]["transport"],
                               "eager_step_ms": p["pod"]["step_ms"],
                               "tokens_per_s_batch": p["tokens_per_s_batch"]}
                   for p in out["passes"]}
        log(f"pod transports ({card}): " + json.dumps(summary) + "; 32 KiB hop ms a step: "
            f"socket {json.dumps(out['hop']['socket_hop_ms'])}, IPC "
            f"{json.dumps(out['hop']['ipc_hop_ms'])} (socket bound "
            f"{out['hop']['socket_hop_bound_ms']:.4f}); kill to exit "
            + ", ".join(f"{k['seconds_to_exit']:.2f} s ({k['pod']}, {k['transport']}, exit "
                        f"{k['root_exit']}, found by {k['found_by']})"
                        for k in (out["ipc_kill"], out["kill"])))
    except BaseException:
        for pod in pods.values():
            if pod.proc.poll() is None or pod.worker.poll() is None:
                pod.tail()
        raise
    finally:
        for pod in pods.values():
            pod.kill()
    out["seconds"] = time.perf_counter() - t0
    log(f"pod phase: {out['seconds']:.1f}s")
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
                 forms=(), attn=None, row_plans=(), paged=None, grammar=None,
                 moe=None, pod=None) -> dict:
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
        **({"pod": {
            "note": "two processes on one card, one rank each: over CUDA IPC the receiver's "
                    "launch reads the sender's window after a stream wait on its epoch word; "
                    f"over sockets ({', '.join(POD_SOCKET)}) the sender's launch stages into "
                    "pinned host memory mapped into the card, a transport thread sends it on "
                    "a TCP link, and the receiver's launch reads the received slot after a "
                    "stream wait on a host-mapped word (launches above count both processes, "
                    "the staging copies included)",
            "by_pod": {p["mode"]: p["pod"] for p in pod["passes"]},
            "hop_by_transport": pod["hop"],
            "one_process_parked_eager_step_ms": {b["mode"]: b.get("parked_eager_step_ms")
                                                 for b in tp},
            "worker_kill": [pod["ipc_kill"], pod["kill"]]}} if pod is not None else {}),
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
        st = attn["stats_form"]
        out.append({
            "name": "decode_attn (partial-stats form)", "route": "cuda",
            "source": ca.KERNEL_SOURCE,
            "replaces": "distributed_llama_multiusers_tpu/parallel/ring_attention.py:67",
            "replaces_note": "counterpart of sp_attention's per-shard _block_stats (flash "
                             "stats over an sp rank's block of the cache) in decode and verify "
                             "steps; the stats pointer on the decode_attn kernel; no Pallas site",
            "launches": sum(p_.get("decode_attn_stats_launches", 0) for p_ in passes),
            "launches_by_mode": {p_["mode"]: p_.get("decode_attn_stats_launches", 0)
                                 for p_ in passes},
            "max_abs_err": st["max_abs_err"], "tol": ATTN_TOL,
            "tol_rule": f"o, l and m: max|d| <= {ATTN_TOL:.0e} * max(max|plain|, 1) "
                        f"({st['max_abs_ref']:.3e}); rows with no slot exactly (0, 0, -inf); o "
                        "bit-equal to the kernel without stats",
            "ms": st["ms"], "plain_ms": st["plain_ms"], "library_ms": st["library_ms"],
            "library": "torch.nn.functional.scaled_dot_product_attention over the same block "
                       "(f32, boolean mask; its output only, no stats)",
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            "ranks": st["ranks"],
            "timed_as": f"one layer of a tp2 x sp2 decode step on sp rank 0: {st['lanes']} "
                        f"lanes ({st['slots_read']} slots attended), {st['n_kv']} kv heads x "
                        f"{st['group']}, head size {st['head_size']}, a bf16 block of "
                        f"{st['block']} slots: kernel and library call in one CUDA graph "
                        "each; plain eager",
        })
    if paged is not None:
        pa, w = paged["attn"], paged["attn"]["window"]
        out.append({
            "name": "decode_attn (paged)", "route": "cuda", "source": ca.KERNEL_SOURCE,
            "replaces": "distributed_llama_multiusers_tpu/models/llama.py:512",
            "replaces_note": "counterpart of the paged forward's gather through the page table "
                             "(models/llama.py:512-521) and the _dense_attention after it, in "
                             "decode and verify steps; no Pallas site",
            "launches": sum(p_.get("decode_attn_paged_launches", 0) for p_ in passes),
            "launches_by_mode": {p_["mode"]: p_.get("decode_attn_paged_launches", 0)
                                 for p_ in passes},
            "max_abs_err": pa["max_abs_err"], "tol": ATTN_TOL,
            "tol_rule": f"max|d| <= {ATTN_TOL:.0e} * max|plain| ({pa['max_abs_ref']:.3e}); "
                        f"bit-equal to the contiguous kernel on the same slots ({pa['cases']})",
            "ms": pa["ms"], "contiguous_ms": pa["contiguous_ms"], "plain_ms": pa["plain_ms"],
            "library_ms": pa["library_ms"],
            "library": "torch.nn.functional.scaled_dot_product_attention (f32, boolean mask) "
                       "on the contiguous slots",
            "bound_ms": pa["bound_ms"], "bound_by": pa["bound_by"],
            "window": w,
            "timed_as": f"the decode_attn entry's layer with the cache in {pa['page']}-slot "
                        "pages permuted at random: paged and contiguous kernels in turns "
                        "(contiguous, paged, paged, contiguous), one CUDA graph each; plain "
                        "eager",
            "launches_per_decode_step": {
                s_["label"]: s_["launches_per_step"]["paged"]["decode_attn_paged"]
                for s_ in (paged["step"], paged["tp2_step"])},
            "profiled_ms_per_decode_step": {
                s_["label"]: s_["paged"]["decode_attn_ms_per_step"]
                for s_ in (paged["step"], paged["tp2_step"])},
        })
    if attn is not None and attn.get("f8") is not None:
        f8 = attn["f8"]
        forms = f8["forms"]
        out.append({
            "name": "decode_attn (e4m3)", "route": "cuda", "source": ca.KERNEL_SOURCE,
            "replaces": ca.KERNEL_REPLACES,
            "replaces_note": "counterpart of XLA's _dense_attention over the JAX package's "
                             "float8_e4m3fn cache (--kv-dtype f8; models/llama.py:132-140 "
                             "writes it, :527-531 widens it to f32), in decode steps, verify "
                             "windows and through the page table; no Pallas site",
            "launches": sum(p_.get("decode_attn_f8_launches", 0) for p_ in passes),
            "launches_by_mode": {p_["mode"]: p_.get("decode_attn_f8_launches", 0)
                                 for p_ in passes},
            "max_abs_err": f8["max_abs_err"], "tol": ATTN_TOL,
            "tol_rule": f"max|d| <= {ATTN_TOL:.0e} * max|plain| ({f8['max_abs_ref']:.3e}) at "
                        "T = 1, the window and paged; bit-equal to the bf16 instantiation on "
                        "the cache widened to bf16; each window row bit-equal to a T = 1 call "
                        f"({f8['rows_bit_equal_to_one_row_calls']} rows); paged bit-equal to "
                        "contiguous",
            "ms": forms["t1"]["ms"], "bf16_ms": forms["t1"]["bf16_ms"],
            "plain_ms": forms["t1"]["plain_ms"], "library_ms": forms["t1"]["library_ms"],
            "library": "torch.nn.functional.scaled_dot_product_attention (f32, boolean mask) on "
                       "the cache widened to f32 beforehand (sdpa takes no e4m3)",
            "bound_ms": forms["t1"]["bound_ms"], "bound_by": forms["t1"]["bound_by"],
            "forms": forms,
            "timed_as": f"the decode_attn entry's layer over an e4m3 cache: each form (T = 1, "
                        "the 4-row window, 64-slot pages) and the bf16 instantiation on the "
                        "same shapes in one CUDA graph each; plain eager",
            "step": attn.get("f8_step"),
        })
    if grammar is not None:
        from distributed_llama_multiusers_tpu_torch.ops import cuda_grammar as cg

        gk = grammar["kernels"]
        for name in cg.KERNELS:
            k = gk[name]
            key = f"{name}_launches"
            out.append({
                "name": name, "route": "cuda", "source": cg.KERNEL_SOURCE,
                "replaces": cg.KERNEL_REPLACES[name],
                "replaces_note": ("counterpart of XLA's _g_mask_row + jnp.argmax inside every "
                                  "decode step family (runtime/engine.py:493-505, 613-614); no "
                                  "Pallas site" if name == "grammar_mask_argmax" else
                                  "counterpart of XLA's _g_next1 (and the _g_walk_greedy walk "
                                  "of a verify window) inside every decode step family "
                                  "(runtime/engine.py:507-545); no Pallas site"),
                "launches": sum(p_.get(key, 0) for p_ in passes),
                "launches_by_mode": {p_["mode"]: p_.get(key, 0) for p_ in passes},
                "max_abs_err": k["max_abs_err"], "tol": 0.0,
                "tol_rule": ("indices equal to the plain version's and masked rows bit-equal "
                             "(8 and 32 x 128,256, the edge vocabularies); FREE rows equal "
                             "torch.argmax" if name == "grammar_mask_argmax" else
                             "states equal to the plain version's on "
                             f"{k['pairs_checked']} (state, token) pairs, stepped and walked"),
                "ms": k["ms"], "plain_ms": k["plain_ms"], "library_ms": k["library_ms"],
                "library": ("torch.argmax(torch.where(bits, rows, -inf)) on precomputed legal "
                            "bits (no one torch call computes the masked argmax)"
                            if name == "grammar_mask_argmax" else
                            "torch.searchsorted, the clip, the index and torch.where on int64 "
                            "tables (one step, no one torch call computes it)"),
                "launch_floor_ms": k["launch_floor_ms"],
                "ptxas": geometry.get("grammar", {}).get(
                    "mask_argmax_kernel" if name == "grammar_mask_argmax"
                    else "grammar_next_kernel"),
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "timed_as": (f"one decode step's masked argmax, {k['rows']} x {k['vocab']} f32 "
                             "rows on random states of a slab holding four schemas: kernel "
                             "and the torch pair in one CUDA graph each; plain eager"
                             if name == "grammar_mask_argmax" else
                             f"one decode step's automaton step, {k['rows']} rows over "
                             f"{k['edges']} edge keys ({k['search_rounds']} search rounds): "
                             "kernel and the library calls in one CUDA graph each; plain eager"),
                "launches_per_decode_step": {b["mode"]: b["launches_per_step"][name]
                                             for b in breakdown + tp},
                "profiled_ms_per_decode_step": {b["mode"]: b["grammar_ms_per_step"][name]
                                                for b in breakdown + tp},
                **({"ms_with_masked_rows": k["ms_with_masked_rows"],
                    "ms_verify_window": k["ms_verify_window"],
                    "torch_argmax_ms": k["torch_argmax_ms"],
                    "bound_ms_with_masked_rows": k["bound_ms_with_masked_rows"],
                    "kernel_over_library": k["kernel_over_library"], "cluster": k["cluster"],
                    "active_clusters": k["active_clusters"]}
                   if name == "grammar_mask_argmax" else
                   {"ms_walk_t4": k["ms_walk_t4"], "search_rounds": k["search_rounds"]}),
            })
    if moe is not None:
        from distributed_llama_multiusers_tpu_torch.ops import cuda_moe as cm

        k, st = moe["kernel"], moe["step"]
        out.append({
            "name": cm.KERNEL, "route": "cuda", "source": cm.KERNEL_SOURCE,
            "replaces": cm.KERNEL_REPLACES,
            "replaces_note": "counterpart of XLA's _moe_topk + _moe_router_weights (an f32 "
                             "einsum, lax.top_k, jax.nn.softmax, a one-hot einsum; "
                             "models/llama.py:171-188) inside every step family of an MoE "
                             "model; no Pallas site",
            "launches": sum(p_.get("moe_route_launches", 0) for p_ in passes),
            "launches_by_mode": {p_["mode"]: p_.get("moe_route_launches", 0) for p_ in passes},
            "max_abs_err": k["max_abs_err"], "tol": MOE_ROUTE_TOL,
            "tol_rule": f"expert ids equal to the plain version's on every row clear of a "
                        f"near tie ({MOE_TIE_GAP:.0e} of max|logit|), lax.top_k's order on "
                        "exact ties; weights within tol where the experts are the same",
            "ms": k["ms"], "plain_ms": k["plain_ms"], "library_ms": k["library_ms"],
            "library": "torch.matmul (f32) + torch.topk + torch.softmax + scatter_ in one "
                       "graph (topk's tie order is unspecified)",
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "by_rows": k["by_rows"], "launch_floor_ms": k["launch_floor_ms"],
            "bits_across_rows": k["bits"], "sweep_ms": k["sweep_ms"],
            "cluster": k["cluster"], "active_clusters": k["active_clusters"],
            "tile_min_rows": k["tile_min_rows"], "ptxas": geometry.get("moe_route"),
            "timed_as": f"one decode step's router call at {DECODE_M} lanes: {DECODE_M} bf16 "
                        "rows of 4096 over 8 experts, 2 active (Mixtral-8x7B): kernel and "
                        f"library chain, {MOE_TIME_CALLS} calls back to back in one CUDA graph "
                        f"each; plain eager; by_rows also {VERIFY_M} (a verify step) and 1024 "
                        "(a prompt chunk)",
            "launches_per_decode_step": st["launches_per_step"]["moe_route"],
            "launches_per_verify_step": st["verify"]["launches_per_step"]["moe_route"],
            "profiled_ms_per_decode_step": st["moe_route_ms_per_step"],
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
    writers = {}
    pods = {}
    hop = None
    mesh_srv = {}
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
        from distributed_llama_multiusers_tpu_torch.ops import cuda_grammar as cg
        from distributed_llama_multiusers_tpu_torch.ops import cuda_moe as cm
        from distributed_llama_multiusers_tpu_torch.ops import cuda_sample as cs
        from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc

        writers = start_model_writers()
        t0 = time.perf_counter()
        names = (q.KERNELS + (rc.KERNEL, cs.KERNEL, ca.KERNEL, cg.KERNEL, cm.KERNEL)
                 + lab.KERNELS)
        one_kernel_build = build_one_kernel(q, rc)
        grammar_ptxas = start_ptxas_report(q, cg.KERNEL_SOURCE)
        moe_ptxas = start_ptxas_report(q, cm.KERNEL_SOURCE)
        try:
            libs = q.build_kernels(names)
        finally:
            one_kernel = one_kernel_launch(rc, one_kernel_build)
            grammar_usage = ptxas_usage(grammar_ptxas,
                                        ("mask_argmax_kernel", "grammar_next_kernel"))
            moe_usage = ptxas_usage(moe_ptxas, ("moe_route_kernel_cluster",
                                                "moe_route_kernel_tile"))
        log(f"kernel build: {time.perf_counter() - t0:.1f}s ({', '.join(names)})")
        geometry = {"q40_slab": kernel_geometry(torch, q, q.slab_info),
                    "q40_blockdot": kernel_geometry(torch, q, q.blockdot_info),
                    "q40_i8blockdot": kernel_geometry(torch, q, q.i8blockdot_info)}
        for kernel, geo in geometry.items():
            log(f"{kernel} geometry: " + json.dumps(geo))
        # the grammar kernels' registers and shared memory (-Xptxas -v):
        # the masked argmax's two instantiations under one key
        geometry["grammar"] = {
            "mask_argmax_kernel": {k.removeprefix("mask_argmax_kernel"): v
                                   for k, v in grammar_usage.items()
                                   if k.startswith("mask_argmax_kernel")},
            "grammar_next_kernel": grammar_usage.get("grammar_next_kernel")}
        log("grammar kernels (-Xptxas -v): " + json.dumps(geometry["grammar"]))
        check(all(u.get("spill_bytes", 0) == 0 for u in grammar_usage.values()),
              f"a grammar kernel spills registers: {grammar_usage}")
        # the router's plans, each in its bf16 and f32 instantiation
        geometry["moe_route"] = moe_usage
        log("moe_route kernels (-Xptxas -v): " + json.dumps(moe_usage))
        check(len(moe_usage) == 4 and all(u.get("spill_bytes", 0) == 0
                                          for u in moe_usage.values()),
              f"moe_route: not four instantiations, or one spills registers: {moe_usage}")
        for kernel, opcode in (("q40_blockdot", "HMMA"), ("q40_i8blockdot", "IMMA")):
            check(all(n == 0 for n in geometry[kernel]["spill_bytes_per_thread"].values()),
                  f"{kernel} spills registers")
            check(geometry[kernel]["stages"] == 3, f"{kernel}: {geometry[kernel]['stages']} "
                                                   "ring stages, expected 3")
            tag = kernel.removeprefix("q40_") + "_kernel"
            geometry[kernel][f"{opcode.lower()}_in_sass"] = sass_hmma(libs[kernel], tag, opcode)
            log(f"{kernel} {opcode} in SASS: "
                + json.dumps(geometry[kernel][f"{opcode.lower()}_in_sass"]))

        seconds = {"setup": round(time.perf_counter() - t_start, 1)}  # the build included
        mark = [time.perf_counter()]

        def lap(name: str) -> None:
            """The seconds since the last lap, as phase ``name``."""
            now = time.perf_counter()
            seconds[name] = round(now - mark[0], 1)
            mark[0] = now

        checks, timings = kernel_phase(torch, q)
        row_plans = row_plan_phase(torch, q)
        hops = hop_phase(torch, rc)
        forms = hop_forms(torch, q, rc, one_kernel)
        collectives = collectives_phase(torch, q, rc)
        sampler = sampler_phase(torch, cs)
        attn = attn_phase(torch)
        attn["f8"] = attn_f8_phase(torch, attn)
        # phase 4c's kernel part needs only the tokenizer: it runs while the
        # model's weights are written
        grammar_kernels = grammar_kernel_phase(torch, cg, *grammar_table(grammar_tokenizer()))
        # as is phase 5, which needs no model
        lab_result = lab_phase(torch, q, lab)
        with open(os.path.join(OUT_DIR, "chip_smoke_lab.json"), "w") as f:
            json.dump({"card": card, **lab_result}, f, indent=1)
        with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as f:
            json.dump({"card": card, "checks": checks, "timings": timings, "hops": hops,
                       "hop_forms": forms, "collectives": collectives, "geometry": geometry,
                       "sampler": sampler, "attn": attn, "verify_shaped_products": row_plans},
                      f, indent=1)
        lap("kernels")
        # phase 4d needs only the Mixtral-width model, written in seconds:
        # it runs while the 1B model is written
        check(writers["mixtral"].wait() == 0,
              f"the Mixtral model's writer exited {writers['mixtral'].returncode}")
        moe = moe_phase(torch, q, rc, cs, cm)
        lap("moe")
        check(writers["1b"].wait() == 0,
              f"the 1B model's writer exited {writers['1b'].returncode}")
        lap("model_wait")
        passes = serving_phase(torch, q)
        lap("serving")
        model, tok = ensure_model(llama32_1b_header(), seed=0)
        layers = serving_layers_phase(model, tok, passes[0])
        lap("serving_layers")
        cli = cli_phase(torch, model, tok, passes)
        lap("cli")
        durability = durability_phase(model, tok)
        lap("durability")
        breakdown, tp, tp_logits, hop_step, products, prefix_bits, meshes = decode_phase(
            torch, q, rc, cs, model)
        lap("decode")
        paged = paged_phase(torch, q, rc, cs, model, tok, passes[0], layers, attn)
        attn["f8_step"] = paged["f8_step"]
        lap("paged")
        # the pods load and warm while the f8, grammar and fleet phases run
        pods, compute_mode, hop = start_pods(torch, model, tok)
        mesh_srv = start_mesh_server(torch)
        f8 = f8_phase(model, tok)
        lap("f8")
        grammar = grammar_phase(torch, q, model, tok, passes[0], breakdown, grammar_kernels)
        lap("grammar")
        fleet = fleet_phase(model, tok, durability, f8["passes"][1])
        lap("fleet")
        mesh_pass = mesh_serving_pass(torch, passes, mesh_srv)
        lap("mesh_serve")
        pod = pod_phase(model, tok, passes, pods, compute_mode, paged["tp2_step"]["export"],
                        card, hop)
        lap("pod")
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
                       "mesh_decode_steps": meshes,
                       "mesh_serving": {k: v for k, v in mesh_pass.items() if k != "log"},
                       "decode_step_products": products,
                       "paged": {**paged, "serving": {k: v for k, v in paged["serving"].items()
                                                      if k != "log"}},
                       "grammar": grammar, "moe": moe,
                       "pod": {**pod, "passes": [{k: v for k, v in p.items() if k != "log"}
                                                 for p in pod["passes"]]},
                       "f8": [{k: v for k, v in p.items() if k != "log"} for p in f8["passes"]],
                       "fleet": fleet}, f, indent=1)
        log("phase seconds: " + json.dumps(seconds))
        main_path = (passes + [paged["serving"]] + cli + durability["passes"]
                     + grammar["passes"] + [moe["serving"]] + f8["passes"] + fleet["passes"]
                     + [mesh_pass] + pod["passes"])
        line = kernels_line(q, rc, cs, checks, main_path, breakdown, tp, hops, hop_step,
                            products, geometry, sampler, lab, lab_result, timings, forms, attn,
                            row_plans, paged, grammar, moe, pod)
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        for writer in writers.values():
            if writer.poll() is None:
                writer.kill()
                writer.wait()
        for pod in pods.values():
            pod.kill()
        if hop is not None and hop.poll() is None:
            hop.kill()
            hop.wait()
        if mesh_srv.get("thread") is not None:
            mesh_srv["thread"].join(timeout=900)
            if mesh_srv.get("srv") is not None:
                mesh_srv["srv"].kill()
    log(f"total: {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
