"""A pod's ring step on a CUDA card: the per-rank windows
(parallel/window.py) and their epoch waits, the ring collectives across
two processes against the same collectives in one, and a paged KV pool's
pages read across the two (parallel/kvshare.py), over CUDA IPC and over the
socket transport (``DLLAMA_POD_TRANSPORT=socket``: TCP links on loopback,
each end's slots and words in pinned host memory mapped into the card).
Marked ``gpu``; without a card every test skips. Imports neither jax nor
the JAX package:

    python -m pytest tests/test_torch_gpu_pod.py -m gpu -q
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _own_window(dev):
    """One rank's window in this process (a pod of one), its store a
    HashStore."""
    from distributed_llama_multiusers_tpu_torch.parallel.window import CudaWindows

    return CudaWindows(1, {0: dev}, 4096, torch.distributed.HashStore(), "test")


@pytest.mark.gpu
def test_stream_waits_until_the_word_is_written(cuda):
    """A stream that waits on a window word runs nothing behind the wait
    until another stream writes the word's value; then the work behind it
    runs. The words start at their slot's index."""
    from distributed_llama_multiusers_tpu_torch.parallel.window import READY_OFF

    pod = _own_window(cuda)
    try:
        waiter, writer = torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)
        out = torch.zeros(4, device=cuda)
        torch.cuda.synchronize()
        pod.wait(0, READY_OFF, 1, 9, waiter)
        with torch.cuda.stream(waiter):
            out.fill_(3.0)
            done = torch.cuda.Event()
            done.record(waiter)
        time.sleep(0.3)
        early = done.query()
        pod.post(0, READY_OFF, 1, 9, writer)
        assert _finishes(done), "the wait never saw the written word"
        assert not early, "the work behind the wait ran before the word was written"
        assert torch.equal(out, torch.full_like(out, 3.0))
        # slot 0's word read 0 from the start: a wait for it passes at once
        pod.wait(0, READY_OFF, 0, 0, waiter)
        passed = torch.cuda.Event()
        passed.record(waiter)
        assert _finishes(passed), "a wait for the word's first value blocked"
    finally:
        pod.close()


def _finishes(event, seconds: float = 10.0) -> bool:
    """Poll ``event`` instead of blocking on it: a wait that is never
    satisfied must fail the test, not hang the card's process."""
    end = time.monotonic() + seconds
    while not event.query():
        if time.monotonic() > end:
            return False
        time.sleep(0.001)
    return True


@pytest.mark.gpu
@pytest.mark.parametrize("tp,small", [(2, False), (2, True), (4, True)])
def test_pod_collectives_match_one_process(cuda, tp, small):
    """Two processes on the card, each holding tp/2 ranks: every ring
    collective of the path (reduce-scatter f32 and bf16, all-reduce, the f32
    and Q80 gathers, the logits gather, ring_sync_matmul on both wires,
    q80_sync_matmul) gives each process's ranks the bits the one-process
    collective gives them, through ring_hop launches in both processes."""
    cmd = [sys.executable, os.path.join(ROOT, "tools", "pod_hop.py"), "--device", "cuda:0",
           "--tp", str(tp), "--reps", "5", "--timeout", "240"] + (["--small"] if small else [])
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rows = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert len(rows) == 2
    for row in rows:
        assert all(row["checks"].values()) and not row["failed"], row
        assert row["counts"]["ring_hop_launches"] > 0, row
        assert row["pod_ring_steps"] > 0, row


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "e4m3"])
def test_ipc_page_read_matches_local(cuda, dtype):
    """A paged KV pool's pages across two processes on the card
    (``tools/pod_pages.py``, parallel/kvshare.py): each process's ranks'
    planes in a CUDA IPC region, the peer's opened; every rank's heads of
    random pages read through the share, after the peer's count of page
    writes, equal what the owner wrote, byte for byte, at the 1B geometry
    (an e4m3 plane as its bytes), and joined in rank order they are the
    whole page."""
    cmd = [sys.executable, os.path.join(ROOT, "tools", "pod_pages.py"), "--device", "cuda:0",
           "--dtypes", dtype, "--reps", "5", "--timeout", "240"]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rows = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert [row["ranks"] for row in rows] == [[0], [1]]
    for row in rows:
        assert row["checks"][f"{dtype}_joined"] and all(row["checks"].values()), row
        assert not row["failed"] and row["read_us"][dtype]["peer"] > 0, row


@pytest.mark.gpu
def test_stream_waits_on_a_host_mapped_word(cuda):
    """The socket transport's primitive: a stream memory wait on a word of
    pinned host memory mapped into the card (``ring_host_alloc``) holds
    the work behind it until a host thread writes the word; a stream's
    write of a word there is seen by ``ring_host_wait`` on the host. A
    CUDA library that refuses either is an error, never a fallback."""
    import ctypes

    import numpy as np

    from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc
    from distributed_llama_multiusers_tpu_torch.ops.cuda_q40 import load_kernel

    v = ctypes.c_void_p
    alloc = load_kernel(rc.KERNEL, [ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(v),
                                    ctypes.POINTER(v)], "ring_host_alloc")
    free = load_kernel(rc.KERNEL, [v], "ring_host_free")
    wait = load_kernel(rc.KERNEL, [v, v, ctypes.c_uint], "ring_wait_value")
    write = load_kernel(rc.KERNEL, [v, v, ctypes.c_uint], "ring_write_value")
    host_wait = load_kernel(rc.KERNEL, [v, ctypes.c_uint, ctypes.c_longlong], "ring_host_wait")
    host, dev = v(), v()
    assert alloc(cuda.index, 4096, ctypes.byref(host), ctypes.byref(dev)) == 0
    try:
        words = np.frombuffer((ctypes.c_uint8 * 8).from_address(host.value), np.uint32)
        assert words[0] == 0 and words[1] == 0  # zeroed
        stream = torch.cuda.Stream(cuda)
        out = torch.zeros(4, device=cuda)
        torch.cuda.synchronize()
        assert wait(stream.cuda_stream, dev.value, 7) == 0, "cuStreamWaitValue32 on mapped " \
            "host memory refused"
        with torch.cuda.stream(stream):
            out.fill_(5.0)
        done = stream.record_event()
        time.sleep(0.3)
        early = done.query()
        words[0] = 7
        assert _finishes(done), "the stream never saw the host's write"
        assert not early, "the work behind the wait ran before the host wrote the word"
        assert torch.equal(out, torch.full_like(out, 5.0))
        assert write(stream.cuda_stream, dev.value + 4, 11) == 0
        assert host_wait(host.value + 4, 11, 10_000_000) == 0, "the host never saw the write"
        assert host_wait(host.value + 4, 12, 1000) == 1  # a value never written times out
    finally:
        torch.cuda.synchronize()
        free(host.value)


def _tool_rows(name: str, *args: str) -> list:
    cmd = [sys.executable, os.path.join(ROOT, "tools", name), "--device", "cuda:0",
           "--timeout", "240", *args]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]


@pytest.mark.gpu
@pytest.mark.parametrize("tp,small", [(2, False), (2, True), (4, True)])
def test_socket_pod_collectives_match_one_process(cuda, tp, small):
    """The same collectives across two processes over TCP links: each
    process's ranks get the one-process bits, the same bits (digests) as
    the same processes through CUDA IPC windows, and both launch the ring
    step as often over either."""
    extra = ["--tp", str(tp), "--reps", "5"] + (["--small"] if small else [])
    rows = _tool_rows("pod_hop.py", *extra, "--transport", "socket")
    assert len(rows) == 2
    for row in rows:
        twin = row["shared"]  # the same processes through CUDA IPC windows
        assert row["transport"] == "socket" and twin["transport"] == "cuda-ipc"
        assert all(row["checks"].values()) and all(twin["checks"].values()), row
        assert not row["failed"], row
        assert row["digests"] == twin["digests"]
        assert row["counts"]["ring_hop_launches"] == twin["counts"]["ring_hop_launches"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "e4m3"])
def test_socket_page_read_matches_local(cuda, dtype):
    """``tools/pod_pages.py --transport socket`` on the card: each process
    serves its rank's heads over TCP; the random pages read through the
    share equal what each owner wrote, byte for byte, at the 1B geometry."""
    rows = _tool_rows("pod_pages.py", "--dtypes", dtype, "--reps", "5", "--transport", "socket")
    assert [row["ranks"] for row in rows] == [[0], [1]]
    for row in rows:
        assert row["transport"] == "socket"
        assert row["checks"][f"{dtype}_joined"] and all(row["checks"].values()), row
        assert not row["failed"] and row["read_us"][dtype]["peer"] > 0, row
