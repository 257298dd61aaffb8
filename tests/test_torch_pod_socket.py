"""The pod's socket transport on the CPU (parallel/window.py
``SocketWindows``, parallel/kvshare.py ``SocketPoolShare``): the data plane
of a pod whose processes run on different hosts, forced on one host with
``DLLAMA_POD_TRANSPORT=socket``.

- every ring collective of the path across two processes over TCP links, at
  tp2 and tp4, gives each process's ranks the one-process bits, and the same
  bits as the shared-memory windows (``tools/pod_hop.py``);
- a two-process socket pod's greedy stream equals the port's one-process
  tp2 engine's and the JAX package's engine's;
- a page read over sockets is byte-equal to the local read, bf16 and e4m3,
  and waits for the peer's count of page writes (in process, and across two
  processes with ``tools/pod_pages.py``);
- a killed worker ends its root with exit 18 through the links, the pid
  watcher unarmed (before it, the idle worker's counters on SIGUSR1 are the
  root's);
- ``join_pod`` with hostnames that differ takes the socket transport, and
  processes that disagree on the transport stop at startup (exit 2);
- a torn frame header is a ``PodPeerLost``.

Every pod process blocks jax and the JAX package from importing; every
subprocess runs under a timeout.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POD_TIMEOUT = 240  # seconds a pod process may run

BLOCKER = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = ("jax", "jaxlib", "distributed_llama_multiusers_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(transport: str | None = "socket") -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH", "DLLAMA_COORDINATOR",
                        "DLLAMA_NUM_PROCESSES", "DLLAMA_PROCESS_ID", "DLLAMA_POD_TRANSPORT")}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"  # the processes share the host's cores
    if transport:
        env["DLLAMA_POD_TRANSPORT"] = transport
    return env


def _tool(name: str, *args: str) -> list:
    """``tools/<name>.py --device cpu --small ...``'s JSON lines."""
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", name), "--device", "cpu",
                        "--small", "--timeout", "120", *args],
                       capture_output=True, text=True, timeout=180, env=_env(None), cwd=REPO)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]


# ---------------------------------------------------------------------------
# the ring collectives over sockets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_socket_collectives_match_one_process_and_files(tp):
    """Two processes, each holding tp/2 ranks, run every ring collective of
    the path over TCP links: each process's ranks get the one-process
    collective's bits, and the same bits (their digests) as the same
    processes over shared-memory files; the loopback bandwidth and the
    hop's bound at it ride the rows."""
    rows = _tool("pod_hop.py", "--tp", str(tp), "--reps", "3", "--transport", "socket")
    assert [row["ranks"] for row in rows] == [list(range(tp // 2)), list(range(tp // 2, tp))]
    for row in rows:
        twin = row["shared"]  # the same processes through shared-memory files
        assert row["transport"] == "socket" and twin["transport"] == "shared-memory files"
        assert all(row["checks"].values()) and all(twin["checks"].values()), row
        assert not row["failed"], row
        assert row["digests"] == twin["digests"]
        assert row["counts"]["ring_hop_plain_calls"] == twin["counts"]["ring_hop_plain_calls"]
        assert row["pod_ring_steps"] == twin["pod_ring_steps"] > 0
    assert rows[0]["loopback_gbps"] > 0 and rows[0]["hop_bound_us"] > 0


# ---------------------------------------------------------------------------
# a two-process pod's greedy stream
# ---------------------------------------------------------------------------

POD_SCRIPT = BLOCKER.replace("{", "{{").replace("}", "}}") + textwrap.dedent(
    """
    import json, os, sys, threading
    sys.path.insert(0, {repo!r})
    mode, tmp, port = sys.argv[1], sys.argv[2], sys.argv[3]

    import numpy as np
    import torch
    from distributed_llama_multiusers_tpu_torch.formats import load_model_header
    from distributed_llama_multiusers_tpu_torch.models import load_params_from_m
    from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
    from distributed_llama_multiusers_tpu_torch.parallel.multihost import (
        ControlPlane, RootControlEngine, maybe_initialize_distributed, pod_transport,
        worker_loop,
    )
    from distributed_llama_multiusers_tpu_torch.parallel.sharding import shard_params
    from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine
    from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer

    os.environ["DLLAMA_COORDINATOR"] = f"127.0.0.1:{{port}}"
    os.environ["DLLAMA_NUM_PROCESSES"] = "2"
    os.environ["DLLAMA_PROCESS_ID"] = "0" if mode == "root" else "1"
    assert maybe_initialize_distributed() == 2
    assert pod_transport() == "socket"
    # the links find a dead peer: no pid watcher
    assert not any(t.name == "pod-peers" for t in threading.enumerate())
    pid = 0 if mode == "root" else 1
    h = load_model_header(os.path.join(tmp, "m.m"))
    config, params = load_params_from_m(os.path.join(tmp, "m.m"), h, dtype=torch.float32,
                                        device="cpu")
    mesh = make_mesh(MeshPlan(tp=2), ["cpu"], process_index=pid, num_processes=2)
    engine = InferenceEngine(config, shard_params(params, mesh), n_lanes=2, device="cpu",
                             mesh=mesh)
    plane = ControlPlane(2, chunk=64)
    if mode == "root":
        eng = RootControlEngine(engine, plane)
        ids = Tokenizer(os.path.join(tmp, "t.t")).encode("hello world")
        _, cur, pos = eng.prefill(0, ids)
        out = [int(cur)]
        toks = np.zeros(2, np.int32); poss = np.zeros(2, np.int32)
        for _ in range(5):
            toks[0] = cur; poss[0] = pos
            _, g, _ = eng.decode(toks, poss)
            pos += 1
            cur = int(g[0])
            out.append(cur)
        eng.stop_workers()
        with open(os.path.join(tmp, "root_tokens.json"), "w") as f:
            json.dump({{"tokens": out, "pod": eng.pod_stats()}}, f)
    else:
        worker_loop(engine, plane)
    print(f"{{mode}} done", flush=True)
    """
)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from distributed_llama_multiusers_tpu.formats.synthetic import (
        tiny_header,
        write_synthetic_model,
        write_synthetic_tokenizer,
    )

    tmp = str(tmp_path_factory.mktemp("socket_pod_model"))
    header = tiny_header()
    write_synthetic_model(os.path.join(tmp, "m.m"), header, seed=7)
    write_synthetic_tokenizer(os.path.join(tmp, "t.t"), vocab_size=header.vocab_size)
    return tmp


def _run_pod(tmp: str, script_src: str, env: dict) -> list:
    """Root and worker of ``script_src`` against a free coordinator port;
    returns (exit code, output) of each."""
    script = os.path.join(tmp, "pod_script.py")
    with open(script, "w") as f:
        f.write(script_src.format(repo=REPO))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, script, mode, tmp, str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for mode in ("root", "worker")]
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=POD_TIMEOUT)[0]))
    finally:
        for p in procs:
            p.kill()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _greedy(engine, tokenizer) -> list:
    ids = tokenizer.encode("hello world")
    _, cur, pos = engine.prefill(0, ids)
    out = [int(cur)]
    toks = np.zeros(2, np.int32)
    poss = np.zeros(2, np.int32)
    for _ in range(5):
        toks[0] = cur
        poss[0] = pos
        _, g, _ = engine.decode(toks, poss)
        pos += 1
        cur = int(g[0])
        out.append(cur)
    return out


def test_socket_pod_greedy_matches_one_process_and_jax(model_dir, tmp_path):
    """A two-process pod over TCP links: its greedy tokens equal the port's
    one-process tp2 engine's and JAX's single-process engine's on the same
    files, every ring step staged, sent, received and pulled once a
    process."""
    import shutil

    import jax.numpy as jnp

    from distributed_llama_multiusers_tpu.formats.model_file import load_model_header
    from distributed_llama_multiusers_tpu.models.loader import load_params_from_m
    from distributed_llama_multiusers_tpu.runtime import InferenceEngine
    from distributed_llama_multiusers_tpu.tokenizer import Tokenizer
    from distributed_llama_multiusers_tpu_torch.formats import load_model_header as port_header
    from distributed_llama_multiusers_tpu_torch.models import load_params_from_m as port_load
    from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
    from distributed_llama_multiusers_tpu_torch.parallel.sharding import shard_params
    from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine as PortEngine
    from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer as PortTokenizer

    tmp = str(tmp_path)
    for name in ("m.m", "t.t"):
        shutil.copy(os.path.join(model_dir, name), os.path.join(tmp, name))
    for rc, out in _run_pod(tmp, POD_SCRIPT, _env()):
        assert rc == 0, f"pod process failed:\n{out[-3000:]}"
    with open(os.path.join(tmp, "root_tokens.json")) as f:
        got = json.load(f)
    assert got["pod"]["pod_transport"] == "socket"
    # one prefill and five decode steps, 9 ring steps each (2 layers x 2
    # syncs x 2 steps + the logits gather), each staged and pulled once
    assert got["pod"]["pod_ring_steps"] == 6 * 9
    assert got["pod"]["pod_ring_stages"] == got["pod"]["pod_ring_pulls"] == 6 * 9

    path = os.path.join(tmp, "m.m")
    config, params = load_params_from_m(path, load_model_header(path), dtype=jnp.float32)
    want = _greedy(InferenceEngine(config, params, n_lanes=2), Tokenizer(os.path.join(tmp, "t.t")))
    assert got["tokens"] == want
    config, params = port_load(path, port_header(path), dtype=torch.float32, device="cpu")
    mesh = make_mesh(MeshPlan(tp=2), ["cpu"] * 2)
    tp2 = PortEngine(config, shard_params(params, mesh), n_lanes=2, device="cpu", mesh=mesh)
    assert got["tokens"] == _greedy(tp2, PortTokenizer(os.path.join(tmp, "t.t")))


# ---------------------------------------------------------------------------
# page reads over sockets
# ---------------------------------------------------------------------------

def _open_pair(factory) -> dict:
    """Two ranks' halves of a collective constructor, each in a thread of
    its own over one store (each rank stands for a process)."""
    store = torch.distributed.HashStore()
    made: dict = {}
    errors: list = []

    def open_rank(r):
        try:
            made[r] = factory(r, store)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=open_rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and len(made) == 2, errors
    return made


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn], ids=["bf16", "e4m3"])
def test_socket_page_read_matches_local_and_waits_for_page_writes(dtype):
    """Two ranks' pool planes, each share serving its own over TCP: a
    read of pages waits until the peer has posted the reader's count of
    page writes, then every rank's heads equal what each owner wrote, byte
    for byte (an e4m3 plane as its bytes), as the local gather gives them
    and joined in rank order; a count the peer passed returns at once."""
    from distributed_llama_multiusers_tpu_torch.models.llama import cache_bits
    from distributed_llama_multiusers_tpu_torch.parallel.kvshare import SocketPoolShare

    shape = (2, 5, 4, 1, 8)
    shares = _open_pair(lambda r, store: SocketPoolShare(
        2, {r: torch.device("cpu")}, shape, dtype, store, "t"))
    reader, writer = shares[0], shares[1]
    try:
        g = torch.Generator().manual_seed(3)
        owned = {r: tuple(torch.randn(shape, generator=g).to(dtype) for _ in range(2))
                 for r in (0, 1)}
        for r, share in shares.items():
            for plane, src in zip(share.planes[r], owned[r]):
                cache_bits(plane).copy_(cache_bits(src))
        reader.post(1)
        idx = torch.tensor([3, 0, 2])
        got: list = []
        waiter = threading.Thread(target=lambda: got.append(reader.read(idx, 1)))
        waiter.start()
        time.sleep(0.3)
        assert waiter.is_alive()  # the peer has not posted its page write yet
        writer.post(1)
        waiter.join(timeout=30)
        assert got, "the read never returned after the peer's post"
        heads = got[0]
        for r in (0, 1):
            for j in (0, 1):
                want = cache_bits(owned[r][j]).index_select(1, idx)
                assert heads[r][j].dtype == want.dtype and torch.equal(heads[r][j], want)
        joined = torch.cat([heads[r][0] for r in (0, 1)], dim=3)
        assert joined.shape == (2, 3, 4, 2, 8)
        writer.post(5)
        again = reader.read(idx[:1], 2)  # a count the peer has passed
        assert torch.equal(again[1][1], cache_bits(owned[1][1]).index_select(1, idx[:1]))
        reader.check_peers()
    finally:
        for share in shares.values():
            share.close()


def test_socket_page_read_across_processes_matches_local():
    """``tools/pod_pages.py --transport socket``: two processes, each
    serving its rank's pool planes over TCP, read every rank's heads of
    random pages (f32 and the e4m3 bytes), equal to the pages each wrote."""
    rows = _tool("pod_pages.py", "--transport", "socket")
    assert [row["ranks"] for row in rows] == [[0], [1]]
    for row in rows:
        assert row["transport"] == "socket"
        assert row["checks"] and all(row["checks"].values()) and not row["failed"], row


# ---------------------------------------------------------------------------
# failure: a killed worker, a torn frame
# ---------------------------------------------------------------------------

def _entry(module: str, argv: list, log_path: str, env: dict) -> subprocess.Popen:
    """``python -m <module> argv`` with jax and the JAX package blocked."""
    code = BLOCKER + f"sys.path.insert(0, {REPO!r})\nimport runpy\n" \
        f"sys.argv = [{module!r}] + {argv!r}\nrunpy.run_module({module!r}, run_name='__main__')\n"
    with open(log_path, "w") as logf:
        return subprocess.Popen([sys.executable, "-c", code], stdout=logf,
                                stderr=subprocess.STDOUT, env=env, cwd=REPO)


def _idle_counters(base: str, worker: subprocess.Popen, worker_log: str) -> tuple:
    """(the root's ``/stats``, the worker's counters) once the pod idles:
    the worker's ``worker_counters`` line (SIGUSR1; it stays up) shows the
    root's packets and ring steps in two rounds running."""
    end, lines, last = time.monotonic() + 60, 0, None
    while time.monotonic() < end:
        with urllib.request.urlopen(base + "/stats", timeout=10) as r:
            stats = json.loads(r.read())
        worker.send_signal(signal.SIGUSR1)
        until = time.monotonic() + 10
        while time.monotonic() < until:
            got = [ln for ln in open(worker_log) if ln.startswith('{"event": "worker_counters"')]
            if len(got) > lines:
                break
            time.sleep(0.05)
        assert len(got) > lines, "the worker logged no counters on SIGUSR1"
        lines, counters = len(got), json.loads(got[-1])
        now = tuple((stats[k], counters[k]) for k in ("pod_packets", "pod_ring_steps"))
        if all(a == b for a, b in now) and now == last:
            return stats, counters
        last = now
        time.sleep(0.2)
    raise AssertionError(f"the pod never idled: root and worker at {last}")


def test_killed_worker_ends_the_root_with_exit_18(model_dir, tmp_path):
    """A socket pod (``dllama_api`` root, ``dllama worker``) that served a
    stream, whose worker is then SIGKILLed while the root idles (no packet,
    no ring step: only the links can see it): the root exits 18 (no
    ``--step-deadline``: not the watchdog), logging ``pod_peer_lost`` with
    the link's detail; no pid watcher was armed. Before the kill the
    worker's counters, read on SIGUSR1, are the root's: every packet and
    ring step replayed, so the pod idles."""
    tmp = str(tmp_path)
    coord, port = f"127.0.0.1:{_free_port()}", _free_port()
    common = ["--model", os.path.join(model_dir, "m.m"), "--tokenizer",
              os.path.join(model_dir, "t.t"), "--workers", "2", "--device", "cpu",
              "--coordinator", coord, "--num-processes", "2"]
    root_log, worker_log = os.path.join(tmp, "root.log"), os.path.join(tmp, "worker.log")
    env = _env()
    worker = _entry("distributed_llama_multiusers_tpu_torch.app.dllama",
                    ["worker", *common, "--process-id", "1"], worker_log, env)
    root = _entry("distributed_llama_multiusers_tpu_torch.app.dllama_api",
                  [*common, "--process-id", "0", "--host", "127.0.0.1", "--port", str(port)],
                  root_log, env)
    base = f"http://127.0.0.1:{port}"
    try:
        end = time.monotonic() + 120
        while True:
            assert root.poll() is None and worker.poll() is None, open(root_log).read()[-3000:]
            assert time.monotonic() < end, open(root_log).read()[-3000:]
            try:
                with urllib.request.urlopen(base + "/health", timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                time.sleep(0.1)
        body = {"prompt": "hello", "max_tokens": 60, "temperature": 0, "stream": True}
        req = urllib.request.Request(base + "/v1/completions", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            deltas = sum(line.startswith(b"data: {") for line in r)
        assert deltas > 3, open(root_log).read()[-3000:]
        stats, counters = _idle_counters(base, worker, worker_log)
        # on the CPU every ring step runs the plain version
        assert counters["ring_hop_plain_calls"] == stats["ring_hop_plain_calls"] > 0
        assert counters["ring_hop_launches"] == stats["ring_hop_launches"] == 0
        assert counters["pod_transport"] == stats["pod_transport"] == "socket"
        worker.kill()
        t_kill = time.monotonic()
        worker.wait(timeout=30)
        rc = root.wait(timeout=30)
        waited = time.monotonic() - t_kill
    finally:
        for p in (root, worker):
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    log = open(root_log).read()
    assert rc == 18, log[-3000:]
    assert waited < 30
    assert "Pod transport: socket" in log and "over socket" in log
    lost = [json.loads(ln) for ln in log.splitlines() if ln.startswith('{"event": "pod_peer_lost"')]
    # the link's report (its detail), not the pid watcher's (a pid)
    assert lost and "detail" in lost[0] and "pid" not in lost[0], log[-3000:]


def test_torn_frame_header_is_a_lost_peer():
    """A frame whose header is not the one a ring step expects (magic,
    epoch, slot, bytes) is never read into a slot: ``check_frame`` raises
    ``PodPeerLost`` for each torn field, and a receiver whose link
    delivers a torn header raises it from its ring step's wait."""
    from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc
    from distributed_llama_multiusers_tpu_torch.parallel.window import (
        FRAME, FRAME_MAGIC, PodPeerLost, SocketWindows, check_frame,
    )

    check_frame(FRAME.pack(FRAME_MAGIC, 7, 1, 64), 7, 1, 64)
    for torn in (FRAME.pack(FRAME_MAGIC ^ 1, 7, 1, 64), FRAME.pack(FRAME_MAGIC, 8, 1, 64),
                 FRAME.pack(FRAME_MAGIC, 7, 0, 64), FRAME.pack(FRAME_MAGIC, 7, 1, 60)):
        with pytest.raises(PodPeerLost):
            check_frame(torn, 7, 1, 64)

    wins = _open_pair(lambda r, store: SocketWindows(2, {r: torch.device("cpu")}, 4096, store,
                                                     "t"))
    try:
        # rank 0's end sends a frame of epoch 99 where rank 1 expects the
        # first step's (epoch 2) on the link into rank 1
        with wins[0].links[1].send_lock:
            wins[0].links[1].sock.sendall(FRAME.pack(FRAME_MAGIC, 99, 0, 64))
        x = torch.arange(16, dtype=torch.float32)
        out = torch.zeros(16)
        recv = [[rc.Seg(x.clone(), None)], [rc.Seg(None, out)]]
        with pytest.raises(PodPeerLost, match="frame header"):
            wins[1].step(recv)
        assert isinstance(wins[1].lost, PodPeerLost)
        assert torch.equal(out, torch.zeros(16))  # nothing of the torn frame landed
    finally:
        for w in wins.values():
            w.close()


# ---------------------------------------------------------------------------
# join_pod: the transport's selection
# ---------------------------------------------------------------------------

JOIN_SCRIPT = BLOCKER + textwrap.dedent(
    """
    import argparse, json, os, socket, sys, threading
    sys.path.insert(0, sys.argv[1])
    pid, port, hostname, routed = int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
    socket.gethostname = lambda: hostname  # this process's host, as the test names it
    from distributed_llama_multiusers_tpu_torch.app.runtime_setup import join_pod
    from distributed_llama_multiusers_tpu_torch.parallel import multihost
    from distributed_llama_multiusers_tpu_torch.parallel.multihost import (
        leave_pod, pod_address, pod_hostnames, pod_transport,
    )

    if routed != "-":  # this host's address on the route to the coordinator
        multihost.routed_address = lambda host, port: routed

    args = argparse.Namespace(coordinator=f"127.0.0.1:{port}", num_processes=2, process_id=pid,
                              workers="2")
    got = join_pod(args)
    watcher = any(t.name == "pod-peers" for t in threading.enumerate())
    print(json.dumps({"joined": list(got), "transport": pod_transport(),
                      "hosts": pod_hostnames(), "watcher": watcher,
                      "address": list(pod_address())}), flush=True)
    leave_pod()  # before the barrier: neither process's exit is a loss
    import torch
    torch.distributed.barrier()
    """
)


@pytest.mark.parametrize("hosts,transports,routed,want", [
    (("hostA", "hostB"), (None, None), ("10.0.0.1", "10.0.0.2"), "socket"),
    (("hostA", "hostB"), (None, None), ("-", "-"), None),
    (("hostA", "hostA"), ("socket", "socket"), ("-", "-"), "socket"),
    (("hostA", "hostA"), (None, None), ("-", "-"), "shared"),
    (("hostA", "hostA"), ("socket", None), ("-", "-"), None),
], ids=["hosts-differ", "hosts-differ-loopback", "forced", "one-host", "skewed"])
def test_join_pod_picks_the_transport(tmp_path, hosts, transports, routed, want):
    """``join_pod`` on two processes whose hostnames (and, where given,
    addresses on the route to the coordinator) the test sets: hosts that
    differ take the socket transport (no exit 2), arm no pid watcher, and
    listen on every interface at the address they publish; hosts that
    differ but would publish loopback (every process here reaches the
    coordinator at 127.0.0.1) both stop with exit 2, naming the address;
    ``DLLAMA_POD_TRANSPORT=socket`` forces sockets on one host, on its
    loopback address; one host otherwise keeps shared memory with its pid
    watcher; processes that disagree on the transport both stop with exit
    2."""
    script = tmp_path / "join.py"
    script.write_text(JOIN_SCRIPT)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(script), REPO, str(i), str(port), hosts[i],
                               routed[i]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=_env(transports[i]))
             for i in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        if want is None:
            assert p.returncode == 2, out[-3000:]
            why = ("disagree on pod/transport" if hosts[0] == hosts[1] else
                   "publishes 127.0.0.1, which resolves to loopback")
            assert why in out, out[-3000:]
            continue
        assert p.returncode == 0, out[-3000:]
        row = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
        assert row["joined"] == [i, 2] and row["transport"] == want
        assert row["hosts"] == list(hosts)
        assert row["watcher"] == (want == "shared")
        assert f"Pod transport: {want}" in out
        if want == "socket":
            assert row["address"] == (["0.0.0.0", routed[i]] if hosts[0] != hosts[1]
                                      else ["127.0.0.1", "127.0.0.1"])


def test_link_addresses_publish_an_address_other_hosts_reach():
    """The socket links' (listen, publish) addresses: on one host the
    route's; across hosts every interface, and a process whose route to the
    coordinator is loopback (the coordinator's own host, whose name may
    resolve to 127.0.1.1 there) publishes the coordinator as given, which
    its peers reached the store at. A literal loopback address is refused
    as a peer's (``_unreachable``), a routable one is not."""
    from distributed_llama_multiusers_tpu_torch.parallel.multihost import (
        _unreachable, link_addresses,
    )

    assert link_addresses("127.0.0.1", "127.0.0.1", False) == ("127.0.0.1", "127.0.0.1")
    assert link_addresses("hostA", "127.0.1.1", False) == ("127.0.1.1", "127.0.1.1")
    assert link_addresses("hostA", "127.0.1.1", True) == ("0.0.0.0", "hostA")
    assert link_addresses("hostA", "10.1.2.3", True) == ("0.0.0.0", "10.1.2.3")
    assert link_addresses("10.1.2.3", "10.1.2.3", True) == ("0.0.0.0", "10.1.2.3")
    assert _unreachable("127.0.1.1").startswith("loopback")
    assert _unreachable("10.1.2.3") == ""
