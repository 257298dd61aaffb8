#!/usr/bin/env python3
"""The two grammar kernels (``grammar_mask_argmax``, ``grammar_next``) of
several checkouts of the port on one CUDA card, in turns, on the same
inputs, timed as ``chip_smoke.py``'s grammar phase times them (the calls
captured back to back in one CUDA graph):

    python3 tools/grammar_ab.py TREE [TREE ...]

Give the trees in alternating order (parent, change, change, parent) to
compare them within one call. Each tree runs in a process of its own from
its root, through its own ``ops/cuda_grammar.py`` (its kernels built from
its sources at first use; a tree whose ``mask_argmax`` takes a workspace
gets one). The inputs, made from seed 18 on the card: 64 states of random
mask words (state 0 FREE, all ones), 8 and 32 rows of 128,256 f32 values,
49,152 sorted edge keys over those states (the default slab's), random
tokens. Prints the card's name and power limit, then one JSON line a
tree: ms of the mask at 8 rows, with the masked rows, the 32-row verify
window (masked_every 4); of the step at 8 rows, T = 1, and walked over
T = 4; the library calls' (``where`` + ``argmax``; ``searchsorted``, the
index and ``where``) and a one-element op's, the launch floor.
"""

import json
import os
import subprocess
import sys

CHILD = r'''
import json, statistics
import numpy as np
import torch
from distributed_llama_multiusers_tpu_torch.ops import cuda_grammar as cg

V, S, E, REPS = 128256, 64, 49152, 20


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


rng = np.random.default_rng(18)
words = -(-V // 32)
masks_np = rng.integers(0, 2**32, (S, words), dtype=np.uint64).astype(np.uint32)
masks_np[0] = 0xFFFFFFFF
masks = torch.from_numpy(masks_np.view(np.int32)).cuda()
x = {n: torch.from_numpy(rng.standard_normal((n, V), dtype=np.float32)).cuda() for n in (8, 32)}
st = {n: torch.from_numpy(rng.integers(0, S, n)).cuda() for n in (8, 32)}
for n in (8, 32):
    st[n][0] = 0
keys = torch.from_numpy(np.sort(rng.choice(S * V, E, replace=False)).astype(np.int32)).cuda()
nxt = torch.from_numpy(rng.integers(0, S, E).astype(np.int32)).cuda()
dflt = torch.from_numpy(rng.integers(0, S, S).astype(np.int32)).cuda()
tok = torch.from_numpy(rng.integers(0, V, (8, 4))).cuda()
o8 = torch.empty((8, V), device="cuda")
o32 = torch.empty((8, V), device="cuda")
work = {}
if hasattr(cg, "workspace"):
    work = {n: {"work": cg.workspace(n, V, "cuda")} for n in (8, 32)}
else:
    work = {n: {} for n in (8, 32)}


def mask(n, out=None, every=1):
    return lambda: cg.mask_argmax(x[n], st[n], masks, masked_out=out, masked_every=every,
                                  **work[n])


for n, every, o in ((8, 1, o8), (32, 4, o32)):
    got = mask(n, o, every)()
    want, rows = cg.mask_argmax_plain(x[n], st[n], masks)
    assert torch.equal(got, want) and torch.equal(o.view(torch.int32),
                                                  rows[::every].view(torch.int32))
walk = cg.grammar_next(st[8], tok, keys, nxt, dflt, V, walk=True)
assert torch.equal(walk, cg.grammar_next_plain(st[8], tok, keys, nxt, dflt, V))
ids = torch.arange(V, device="cuda")
bits8 = ((masks[st[8]][:, ids >> 5] >> (ids & 31).to(torch.int32)) & 1).bool()
ninf = torch.tensor(float("-inf"), device="cuda")
keys64, nxt64, dflt64 = (t.to(torch.int64) for t in (keys, nxt, dflt))
t1 = tok[:, :1]


def library_next():
    key = st[8] * V + t1[:, 0]
    j = torch.searchsorted(keys64, key).clamp_(max=E - 1)
    return torch.where(keys64[j] == key, nxt64[j], dflt64[st[8]])


assert torch.equal(library_next(), walk[:, 1])
one = torch.zeros(1, device="cuda")
times = {
    "mask_ms": graph_ms(mask(8)),
    "mask_ms_with_masked_rows": graph_ms(mask(8, o8)),
    "mask_ms_verify_window": graph_ms(mask(32, o32, 4)),
    "next_ms": graph_ms(lambda: cg.grammar_next(st[8], t1, keys, nxt, dflt, V)),
    "next_ms_walk_t4": graph_ms(lambda: cg.grammar_next(st[8], tok, keys, nxt, dflt, V,
                                                        walk=True)),
    "mask_library_ms": graph_ms(lambda: torch.argmax(torch.where(bits8, x[8], ninf), dim=-1)),
    "next_library_ms": graph_ms(library_next),
    "launch_floor_ms": graph_ms(lambda: one.add_(1.0)),
}
print(json.dumps(times))
'''


def main(argv: list) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for i, tree in enumerate(argv):
        tree = os.path.abspath(tree)
        r = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, capture_output=True,
                           text=True, timeout=600)
        if r.returncode != 0:
            print(f"grammar_ab.py: {tree} failed:\n{r.stdout}\n{r.stderr}", file=sys.stderr)
            return 1
        times = json.loads(r.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": i, "tree": os.path.relpath(tree), **times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
