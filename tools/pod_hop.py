#!/usr/bin/env python3
"""The ring collectives across a pod's processes, held against the same
collectives in one process, and a ring step's time both ways.

    python3 tools/pod_hop.py [--device cuda:0] [--procs 2] [--tp 2] [--reps 50]
                             [--transport ipc|socket] [--small] [--go FILE] [--out FILE]

Starts ``--procs`` processes of itself on one host (a gloo pod on a free
localhost port, parallel/multihost.py), each holding ``tp / procs`` ranks on
``--device``, with the pod's windows open (parallel/window.py). Each process
runs every ring collective of the tensor-parallel path on seeded inputs at
the 1B decode widths (``--small``: narrow ones), first across the pod, then
with every rank in itself, and checks its ranks' results bit for bit
(``digests``: a sha256 of each collective's results on its ranks). Then
it times a ring step (a 32 KiB f32 hop) and an f32 all-reduce of an 8-lane
[8, 2048] partial across the pod, with the windows' waits timed, and the
same calls with both ranks in one process. Prints the card's name and power
limit where there is a card, then one JSON line a process; exits nonzero if
a process failed or a check disagreed. ``--device cpu`` runs the plain ring
step over shared-memory windows.

``--transport socket`` runs the pod over TCP links on loopback (the
transport of a pod across hosts, parallel/window.py ``SocketWindows``;
``DLLAMA_POD_TRANSPORT=socket`` in each process) instead of CUDA IPC (or
files on the CPU), and then the same checks and times through this host's
shared windows in the same processes (``shared``: their digests must equal
the links'). Process 0's JSON line also carries the loopback bandwidth of
one TCP socket pair (``loopback_gbps``) and the hop's bound at it
(``hop_bound_us``: the hop's wire bytes over that bandwidth). ``--go
FILE`` starts the processes and opens the pod at once, then waits until
FILE exists before the checks and the timing (a caller hides the
processes' start behind other work).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the 1B decode widths (8 lanes, dim 2048, vocab 128,256) and narrow ones
WIDTHS = {"full": {"lanes": 8, "dim": 2048, "vocab": 128256},
          "small": {"lanes": 2, "dim": 256, "vocab": 512}}
HOP_BYTES = 32 * 1024  # the timed hop: an 8-lane f32 ring chunk at tp=2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def loopback_gbps(nbytes: int = 256 << 20, chunk: int = 1 << 20) -> float:
    """GB/s one TCP socket pair moves over loopback (``nbytes`` in
    ``chunk``-byte sends, TCP_NODELAY, one thread each end)."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    tx = socket.create_connection(listener.getsockname())
    rx, _ = listener.accept()
    listener.close()
    for s in (tx, rx):
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    buf = bytearray(chunk)

    def drain():
        view, left = memoryview(bytearray(chunk)), nbytes
        while left:
            left -= rx.recv_into(view[:min(chunk, left)])

    t = threading.Thread(target=drain)
    t0 = time.perf_counter()
    t.start()
    for _ in range(nbytes // chunk):
        tx.sendall(buf)
    t.join()
    seconds = time.perf_counter() - t0
    tx.close()
    rx.close()
    return nbytes / seconds / 1e9


def _cases(torch, rc, per_rank_inputs: dict) -> dict:
    """Each collective of the path as a function of the per-rank inputs."""
    from distributed_llama_multiusers_tpu_torch.parallel.collectives import q80_sync_matmul

    x = per_rank_inputs
    return {
        "ring_reduce_scatter": lambda: rc.ring_reduce_scatter(x["parts"]),
        "ring_reduce_scatter_bf16": lambda: rc.ring_reduce_scatter(x["halves"]),
        "ring_all_reduce": lambda: rc.ring_all_reduce(x["parts"]),
        "ring_all_gather": lambda: rc.ring_all_gather(x["chunks"]),
        "ring_all_gather_q80": lambda: rc.ring_all_gather_q80(x["chunks"]),
        "logits_gather": lambda: rc.ring_all_gather(x["logits"]),
        "ring_sync_matmul": lambda: rc.ring_sync_matmul(x["xs"], x["ws"]),
        "ring_sync_matmul_q80_wire": lambda: rc.ring_sync_matmul(x["xs"], x["ws"],
                                                                 q80_wire=True),
        "q80_sync_matmul": lambda: q80_sync_matmul(x["xs"], x["ws"]),
    }


def _inputs(torch, tp: int, dev, w: dict) -> dict:
    """Every rank's inputs, from one seed (the same in every process)."""
    from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
    from distributed_llama_multiusers_tpu_torch.parallel.sharding import col_shards

    g = torch.Generator().manual_seed(11)
    lanes, dim, vocab = w["lanes"], w["dim"], w["vocab"]
    parts = [torch.randn((lanes, 1, dim), generator=g) for _ in range(tp)]
    weight = (torch.randn((dim, dim), generator=g) * dim ** -0.5).to(torch.bfloat16)
    mesh = make_mesh(MeshPlan(tp=tp), [dev] * tp)
    return {
        "parts": [p.to(dev) for p in parts],
        "halves": [p.to(torch.bfloat16).to(dev) for p in parts],
        "chunks": [p[..., : dim // tp].contiguous().to(dev) for p in parts],
        "logits": [torch.randn((lanes, 1, vocab // tp), generator=g).to(dev)
                   for _ in range(tp)],
        "xs": [p[..., : dim // tp].to(torch.bfloat16).contiguous().to(dev) for p in parts],
        "ws": col_shards(weight, mesh),
    }


def _held(values: dict, ranks) -> dict:
    """The inputs as a pod process sees them: None for the other ranks."""
    return {k: [v if r in ranks else None for r, v in enumerate(vs)]
            for k, vs in values.items()}


def _time(torch, cuda: bool, fn, reps: int) -> float:
    """Microseconds a call, over ``reps`` back-to-back calls ending in a
    synchronize (the host clock)."""
    fn()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if cuda:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def _through(torch, rc, pod, cuda: bool, full: dict, mine: dict, ranks, reps: int) -> dict:
    """Every collective across the pod through windows ``pod`` against one
    process (checks, digests of its ranks' results), then the timed hop and
    all-reduce through them."""
    out = {"transport": pod.transport, "checks": {}, "digests": {}, "failed": []}
    for name in _cases(torch, rc, full):
        rc.set_pod(pod)
        got = _cases(torch, rc, mine)[name]()
        rc.set_pod(None)
        want = _cases(torch, rc, full)[name]()
        if cuda:
            torch.cuda.synchronize()
        same = all(torch.equal(got[r], want[r]) for r in ranks)
        out["checks"][name] = same
        # the pod's bits, to hold one transport's against another's
        out["digests"][name] = hashlib.sha256(b"".join(
            got[r].contiguous().view(torch.uint8).cpu().numpy().tobytes()
            for r in ranks)).hexdigest()
        if not same:
            out["failed"].append(name)
    # a ring step (one 32 KiB f32 hop) and an 8-lane f32 all-reduce
    hop = [torch.randn((8, HOP_BYTES // 32), generator=torch.Generator().manual_seed(r))
           for r in range(len(full["parts"]))]
    hop_mine = [h.to(full["parts"][r].device) if r in ranks else None
                for r, h in enumerate(hop)]
    rc.set_pod(pod)
    rc.reset_counts()
    steps0 = pod.stats["steps"]
    pod.start_timing()
    out["pod_hop_us"] = _time(torch, cuda, lambda: rc.ring_shift(hop_mine), reps)
    out["pod_hop_wait_us"] = pod.stop_timing() * 1e3 / (reps + 1)
    pod.start_timing()
    out["pod_all_reduce_us"] = _time(torch, cuda, lambda: rc.ring_all_reduce(mine["parts"]),
                                     reps)
    out["pod_all_reduce_wait_us"] = pod.stop_timing() * 1e3 / (reps + 1)
    out["pod_ring_steps"] = pod.stats["steps"] - steps0
    out["counts"] = rc.ring_counts()
    rc.set_pod(None)
    return out


def child(args) -> int:
    parent = os.getppid()
    sys.path.insert(0, ROOT)
    import torch

    from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc
    from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
    from distributed_llama_multiusers_tpu_torch.parallel import multihost
    from distributed_llama_multiusers_tpu_torch.parallel.window import (
        NSLOTS, CudaWindows, FileWindows, open_windows,
    )

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    n = multihost.maybe_initialize_distributed(argparse.Namespace(
        coordinator=f"127.0.0.1:{args.port}", num_processes=args.procs,
        process_id=args.rank))
    mesh = make_mesh(MeshPlan(tp=args.tp), [dev] * (args.tp // n), process_index=args.rank,
                     num_processes=n)
    w = WIDTHS["small" if args.small else "full"]
    # the largest step: a logits shard, an f32 partial's chunk or the
    # timed 32 KiB hop
    slot = max(4 * w["lanes"] * max(w["dim"], w["vocab"] // args.tp), HOP_BYTES)
    local = dict(zip(mesh.local_ranks, mesh.devices))
    pods = [open_windows(args.tp, local, slot, multihost.pod_store())]
    if pods[0].transport == "socket":
        # this host's shared windows beside the links: the same collectives
        # and the same hop through both, in one run
        pods.append((CudaWindows if cuda else FileWindows)(args.tp, local, slot,
                                                           multihost.pod_store(), "pod/shared"))
    full = _inputs(torch, args.tp, dev, w)
    mine = _held(full, set(mesh.local_ranks))
    while args.go and not os.path.exists(args.go):
        if os.getppid() != parent:
            return 1  # the caller that would let us go is gone
        time.sleep(0.1)
    bound = {}
    if pods[0].transport == "socket" and args.rank == 0:
        gbps = loopback_gbps()
        bound = {"loopback_gbps": gbps, "hop_bound_us": HOP_BYTES / (gbps * 1e9) * 1e6}
    runs = [_through(torch, rc, pod, cuda, full, mine, mesh.local_ranks, args.reps)
            for pod in pods]
    out = {"rank": args.rank, "device": str(dev), "ranks": list(mesh.local_ranks),
           "slots": NSLOTS, "slot_bytes": pods[0].slot_bytes, **bound, **runs[0]}
    if len(runs) > 1:
        out["shared"] = runs[1]
    failed = [f for run in runs for f in run["failed"]]
    hop = [torch.randn((8, HOP_BYTES // 32), generator=torch.Generator().manual_seed(r)).to(dev)
           for r in range(args.tp)]
    out["one_process_hop_us"] = _time(torch, cuda, lambda: rc.ring_shift(hop), args.reps)
    out["one_process_all_reduce_us"] = _time(torch, cuda, lambda: rc.ring_all_reduce(
        full["parts"]), args.reps)
    # every process is done reading every window before any frees its own,
    # and leaves on purpose: a peer's exit from here on is no failure
    multihost.leave_pod()
    torch.distributed.barrier()
    for pod in pods:
        pod.close()
    out["failed"] = failed
    print(json.dumps(out), flush=True)
    return 1 if failed else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--tp", type=int, default=2)
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--small", action="store_true")
    p.add_argument("--transport", choices=("ipc", "socket"), default="ipc",
                   help="ipc: CUDA IPC on the card, shared-memory files on the CPU")
    p.add_argument("--out", default=None)
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--go", default=None,
                   help="start the processes and open the pod, then wait until this file "
                        "exists before the checks and the timing")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
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
           "--reps", str(args.reps)] + (["--small"] if args.small else []) + (
        ["--go", args.go] if args.go else [])
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


def pod_env(transport: str) -> dict:
    """The child processes' environment: this repo on the path, the
    transport's variable set (``socket``) or cleared (``ipc``)."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("DLLAMA_POD_TRANSPORT", None)
    if transport == "socket":
        env["DLLAMA_POD_TRANSPORT"] = "socket"
    return env


if __name__ == "__main__":
    sys.exit(main())
