#!/usr/bin/env python3
"""A paged KV pool's pages read across a pod's processes, held against the
pages each process wrote, and a page read's time both ways.

    python3 tools/pod_pages.py [--device cuda:0] [--procs 2] [--tp 2] [--small]
                               [--dtypes bf16,e4m3] [--reps 20] [--transport ipc|socket]
                               [--out FILE]

Starts ``--procs`` processes of itself on one host (a gloo pod on a free
localhost port, parallel/multihost.py), each holding ``tp / procs`` ranks'
pool planes on ``--device`` in the pod's shared memory
(parallel/kvshare.py: CUDA IPC on the card, a shared-memory file on the
CPU; ``--transport socket``: each process's own, its peers' heads read
over TCP from its server thread), at the 1B geometry (16 layers, 64-token pages, 8 kv heads of 64 over
the ranks; ``--small``: 2 layers, 8-token pages, 2 heads of 16). Each
process fills its ranks' planes from a seed that every process knows,
posts its count of page writes, then reads random pages of every rank
through the share's read once every peer's count has reached its own, as
a pod root reads its peers' heads of a page it exports: each rank's slice
and the joined page must equal what the owner wrote, byte for byte (an e4m3
plane moves as its bytes). Then each process rewrites a page without
counting it, as a decode step writes its KV, on the card behind a kernel
that spins for about 0.1 s, runs a ring all-reduce across the pod through
its windows, as that step's ring steps, and reads the page at once: it
must read the new bytes (``<dtype>_after_step``; a read waits for the steps
its process dispatched, parallel/kvshare.py's Ordering). Then it times one page's read through the share
(every rank's heads, K and V, the peers' over the transport, a synchronize
after: ``peer``) and the gather of its own ranks' heads alone (``own``).
Prints the card's name and power limit where there is a
card, then one JSON line a process; exits nonzero if a process failed or
a check disagreed.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

from pod_hop import pod_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# layers, pages (+1 scratch), page tokens, kv heads, head size
GEOMETRY = {"full": (16, 17, 64, 8, 64), "small": (2, 7, 8, 2, 16)}
PAGES_READ = 3
SPIN_CYCLES = 200_000_000  # the kernel ahead of a step's page write (~0.1 s)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _planes(torch, shape, dtype, rank: int):
    """Rank ``rank``'s (K, V) as every process derives them (on the CPU)."""
    g = torch.Generator().manual_seed(1000 + rank)
    return tuple(torch.randn(shape, generator=g).to(dtype) for _ in range(2))


def _time_us(torch, cuda: bool, fn, reps: int) -> float:
    fn()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if cuda:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def child(args) -> int:
    sys.path.insert(0, ROOT)
    import torch

    from distributed_llama_multiusers_tpu_torch.models.llama import cache_bits
    from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc
    from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh, multihost
    from distributed_llama_multiusers_tpu_torch.parallel.kvshare import open_pool_share
    from distributed_llama_multiusers_tpu_torch.parallel.window import open_windows

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    n = multihost.maybe_initialize_distributed(argparse.Namespace(
        coordinator=f"127.0.0.1:{args.port}", num_processes=args.procs,
        process_id=args.rank))
    mesh = make_mesh(MeshPlan(tp=args.tp), [dev] * (args.tp // n), process_index=args.rank,
                     num_processes=n)
    layers, pages, page, heads, hd = GEOMETRY["small" if args.small else "full"]
    shape = (layers, pages, page, heads // args.tp, hd)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "e4m3": torch.float8_e4m3fn}
    out = {"rank": args.rank, "device": str(dev), "ranks": list(mesh.local_ranks),
           "transport": multihost.pod_transport(), "shape": list(shape), "checks": {},
           "read_us": {}}
    failed = []
    idx = torch.randperm(pages - 1, generator=torch.Generator().manual_seed(7))[:PAGES_READ]
    local = dict(zip(mesh.local_ranks, mesh.devices))
    windows = open_windows(args.tp, local, 4096, multihost.pod_store(), prefix="test/win")
    step_parts = [torch.ones((1, 1, 64), device=dev) if r in local else None
                  for r in range(args.tp)]
    for name in args.dtypes.split(","):
        dtype = dtypes[name]
        share = open_pool_share(args.tp, dict(zip(mesh.local_ranks, mesh.devices)), shape,
                                dtype, multihost.pod_store(), prefix=f"test/pool/{name}")
        want = {r: _planes(torch, shape, dtype, r) for r in range(args.tp)}
        for r in mesh.local_ranks:
            for plane, src in zip(share.planes[r], want[r]):
                cache_bits(plane).copy_(cache_bits(src).to(dev))
        # the engine's order: the writer posts its count of page writes,
        # the read waits for every peer's to reach the reader's
        share.post(1)
        heads = share.read(idx, 1)
        joined, whole = [], []
        for r in range(args.tp):
            for j in (0, 1):
                got = heads[r][j].cpu()
                ref = cache_bits(want[r][j]).index_select(1, idx)
                same = torch.equal(got, ref)
                out["checks"][f"{name}_rank{r}_{'kv'[j]}"] = same
                if not same:
                    failed.append(f"{name} rank {r}")
                joined.append(got)
                whole.append(ref)
        # the page as an export joins it: every rank's heads, in rank order
        out["checks"][f"{name}_joined"] = all(
            torch.equal(torch.cat(joined[j::2], dim=3), torch.cat(whole[j::2], dim=3))
            for j in (0, 1))
        share.check_peers()
        one = idx[:1]
        # a step's uncounted page write, its ring steps, then the read (once
        # every process has read the pages as first written)
        torch.distributed.barrier()
        fresh = {r: _planes(torch, shape, dtype, 100 + r) for r in range(args.tp)}
        staged = {r: [cache_bits(p).to(dev) for p in fresh[r]] for r in mesh.local_ranks}
        if cuda:
            torch.cuda._sleep(SPIN_CYCLES)
        for r in mesh.local_ranks:
            for plane, src in zip(share.planes[r], staged[r]):
                cache_bits(plane)[:, int(one)].copy_(src[:, int(one)])
        rc.set_pod(windows)
        rc.ring_all_reduce(step_parts)
        rc.set_pod(None)
        heads = share.read(one, 1)
        same = all(torch.equal(heads[r][j].cpu(), cache_bits(fresh[r][j]).index_select(1, one))
                   for r in range(args.tp) for j in (0, 1))
        out["checks"][f"{name}_after_step"] = same
        if not same:
            failed.append(f"{name} after a step")
        own = [p for r in mesh.local_ranks for p in share.planes[r]]
        out["read_us"][name] = {
            "peer": _time_us(torch, cuda, lambda: share.read(one, 1), args.reps),
            "own": _time_us(torch, cuda, lambda: [cache_bits(p).index_select(1, one.to(dev))
                                                  for p in own], args.reps)}
        torch.distributed.barrier()  # every process done reading before the next
        share.close()
    multihost.leave_pod()
    torch.distributed.barrier()
    windows.close()
    out["failed"] = failed
    print(json.dumps(out), flush=True)
    return 1 if failed or not all(out["checks"].values()) else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--tp", type=int, default=2)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--small", action="store_true")
    p.add_argument("--dtypes", default=None, help="default: bf16,e4m3 on a card, f32,e4m3 "
                                                  "on the CPU")
    p.add_argument("--transport", choices=("ipc", "socket"), default="ipc",
                   help="ipc: CUDA IPC on the card, shared-memory files on the CPU")
    p.add_argument("--out", default=None)
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.dtypes is None:
        args.dtypes = "f32,e4m3" if args.device == "cpu" else "bf16,e4m3"
    if args.child:
        return child(args)
    if args.device.startswith("cuda"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
    port = _free_port()
    env = pod_env(args.transport)
    if args.device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")  # processes sharing the host's cores
    cmd = [sys.executable, os.path.abspath(__file__), "--child", "--port", str(port),
           "--device", args.device, "--procs", str(args.procs), "--tp", str(args.tp),
           "--reps", str(args.reps), "--dtypes", args.dtypes] + (
        ["--small"] if args.small else [])
    procs = [subprocess.Popen(cmd + ["--rank", str(i)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for i in range(args.procs)]
    rows, ok = [], True
    try:
        for proc in procs:
            text, _ = proc.communicate(timeout=args.timeout)
            lines = [ln for ln in text.splitlines() if ln.startswith("{")]
            if proc.returncode != 0 or not lines:
                ok = False
                print(text[-3000:], file=sys.stderr, flush=True)
            if lines:
                rows.append(json.loads(lines[-1]))
                print(lines[-1], flush=True)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0 if ok and len(rows) == args.procs else 1


if __name__ == "__main__":
    sys.exit(main())
