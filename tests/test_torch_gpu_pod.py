"""A pod's ring step on a CUDA card: the per-rank windows
(parallel/window.py) and their epoch waits, the ring collectives across
two processes against the same collectives in one, and a paged KV pool's
pages read across the two (parallel/kvshare.py). Marked ``gpu``; without
a card every test skips. Imports neither jax nor the JAX package:

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
