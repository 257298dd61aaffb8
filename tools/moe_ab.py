#!/usr/bin/env python3
"""The MoE router kernel (``moe_route``) of several checkouts of the port on
one CUDA card, in turns, on the same inputs, timed as ``chip_smoke.py``'s
moe phase times it (the calls captured back to back in one CUDA graph):

    python3 tools/moe_ab.py [--sweep] TREE [TREE ...]

Give the trees in alternating order (parent, change, change, parent) to
compare them within one call. Each tree runs in a process of its own from
its root, through its own ``ops/cuda_moe.py`` (its kernel built from its
sources at first use). The inputs, made from seed 19 on the card, are
Mixtral-8x7B's router (dim 4096, 8 experts, 2 active): a [4096, 8] f32
gate of std 0.02 and 8, 32 and 1,024 bf16 rows of std 1. Each tree's
result is first held against its plain version (expert ids equal on
every row clear of a near tie, weights within 1e-6). Prints the card's
name and power limit, then one JSON line a tree: ms of the router at 8,
32 and 1,024 rows, of the library chain (f32 ``torch.matmul``,
``torch.topk``, ``softmax``, ``scatter_``) at each, and of a one-element
op, the launch floor. ``--sweep``: on trees whose ``cuda_moe`` has
``route_plan``, also both plans forced at N = 8 .. 1,024 (where they
switch over).
"""

import json
import os
import subprocess
import sys

CHILD = r'''
import json, sys
import torch
from distributed_llama_multiusers_tpu_torch.ops import cuda_moe as cm

DIM, E, K, REPS = 4096, 8, 2, 20
ROWS = (8, 32, 1024)
SWEEP = (8, 16, 32, 48, 64, 96, 128, 256, 512, 1024)


def graph_ms(call, reps=5):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
        call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(REPS):
            call()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * REPS)


gen = torch.Generator(device="cuda").manual_seed(19)
gate = torch.randn((DIM, E), device="cuda", generator=gen) * 0.02
ys = {n: torch.randn((n, DIM), device="cuda", generator=gen).to(torch.bfloat16)
      for n in SWEEP}


def check(y, out):
    want = cm.moe_route_plain(y, gate, K)
    logits = y.float() @ gate
    srt = torch.sort(logits, dim=-1, descending=True).values
    clear = ((srt[:, :K] - srt[:, 1:K + 1]) > 1e-5 * logits.abs().amax(-1, keepdim=True)).all(-1)
    assert torch.equal(out[1][clear], want[1][clear]), "expert ids differ from plain"
    assert float((out[2] - want[2])[clear].abs().max()) <= 1e-6, "weights differ from plain"


def library(y):
    logits = torch.matmul(y.float(), gate)
    v, i = torch.topk(logits, K)
    return torch.zeros_like(logits).scatter_(-1, i, torch.softmax(v, dim=-1))


times = {}
for n in ROWS:
    check(ys[n], cm.moe_route(ys[n], gate, K))
    times[f"ms_{n}"] = graph_ms(lambda n=n: cm.moe_route(ys[n], gate, K))
for n in ROWS:
    times[f"library_ms_{n}"] = graph_ms(lambda n=n: library(ys[n]))
one = torch.zeros(1, device="cuda")
times["launch_floor_ms"] = graph_ms(lambda: one.add_(1.0))
if "--sweep" in sys.argv and hasattr(cm, "route_plan"):
    times["default_plan"] = {n: ("cluster" if cm.route_plan(n, DIM, E, K).cluster else
                                 f"tile of {cm.route_plan(n, DIM, E, K).tile_rows}")
                             for n in SWEEP}
    sweep = {}
    for n in SWEEP:
        sweep[n] = {}
        for name, tmr in (("cluster", 1 << 30), ("tile", 1)):
            plan = cm.route_plan(n, DIM, E, K, n_sms=cm.n_sms(gate.device), tile_min_rows=tmr)
            check(ys[n], cm.launch_plan(ys[n], gate, K, plan))
            sweep[n][name] = graph_ms(lambda n=n, plan=plan: cm.launch_plan(ys[n], gate, K, plan))
    times["sweep_ms"] = sweep
torch.cuda.synchronize()
print(json.dumps(times))
'''


def main(argv: list) -> int:
    sweep = "--sweep" in argv
    trees = [a for a in argv if a != "--sweep"]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for i, tree in enumerate(trees):
        tree = os.path.abspath(tree)
        r = subprocess.run([sys.executable, "-c", CHILD] + (["--sweep"] if sweep else []),
                           cwd=tree, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            print(f"moe_ab.py: {tree} failed:\n{r.stdout}\n{r.stderr}", file=sys.stderr)
            return 1
        times = json.loads(r.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": i, "tree": os.path.relpath(tree), **times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
