"""The port's paged KV cache on a pod, on the CPU, against the JAX package.

- The three paged ops (OP_KV_TABLE, OP_KV_PAGES, OP_KV_SWAP) put on the
  wire the packets the JAX package's ``ControlPlane`` puts for the same
  calls, from the plane and through the root proxy (captured at
  ``_bcast``); a proxied call that fails its checks sends nothing.
- The worker's three arms, fed the JAX package's packets, make the engine
  calls JAX's ``worker_loop`` makes; every skew (a contiguous worker, a
  table width, a page size) is a ``ReplayError`` that burns no restart.
- A two-process pod with ``paged_kv``: the worker holds rank 1 only and
  writes that rank's heads of an imported page; the root's export and a
  swap-out/swap-in round trip give whole pages (both ranks' heads, the
  peer's read from its shared-memory planes), byte-equal to the
  one-process tp2 engine's. Greedy streams through the root's scheduler,
  with a session swapped through the host tier and back, equal the
  port's one-process paged tp2 scheduler's and the JAX paged
  scheduler's, and the committed chain exports the same bytes.
- The page read across processes (``tools/pod_pages.py --device cpu``), and
  a read that waits for the peer's count of page writes.
- The entry points: ``dllama_api --paged-kv on`` as a pod's root answers
  like the one-process paged ``--workers 2`` server, with a swap-in
  replayed by the worker; a ``--role decode`` pod adopts a bundle and
  regenerates the session; a paged worker beside a contiguous CLI root
  stops at startup.

Every subprocess runs under a timeout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time
import urllib.request

import numpy as np
import pytest

from tests.test_torch_multihost import (
    API,
    BLOCKER,
    CLI,
    POD_TIMEOUT,
    REPO,
    _capture,
    _copy_model,
    _entry,
    _env,
    _free_port,
    _ScriptedPlane,
    _stop,
    _wait_healthy,
)

N_LANES = 3
CHUNK = 16
PAGE_WORDS = 48  # a stub page payload: 3 slot-sized fragments of CHUNK words


# ---------------------------------------------------------------------------
# packets, word for word against the JAX package's control plane
# ---------------------------------------------------------------------------


def _payload(nbytes: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, nbytes, dtype=np.uint8).tobytes()


_P1, _P2, _P3 = _payload(PAGE_WORDS * 4, 1), _payload(PAGE_WORDS * 4, 2), _payload(37, 3)

PAGED_PLANE_CALLS = [
    ("kv_table", "send_kv_table", (1, [4, 2, 9, 9], [(3, 4), (7, 2)]), {}),
    ("kv_table_no_copies", "send_kv_table", (0, [9] * 4, []), {}),
    ("kv_table_reset", "send_kv_table", (-1, [], []), {}),
    ("kv_pages_one", "send_kv_pages", ([(5, _P1)],), {}),
    ("kv_pages_short", "send_kv_pages", ([(0, _P3)],), {}),
    ("kv_pages_two", "send_kv_pages", ([(5, _P1), (2, _P2)],), {}),
    ("kv_swap_one", "send_kv_swap", ([(8, _P2)],), {}),
    ("kv_swap_batch", "send_kv_swap", ([(3, _P1), (1, _P3), (6, _P2)],), {}),
]


@pytest.mark.parametrize("name,method,args,kwargs", PAGED_PLANE_CALLS,
                         ids=[c[0] for c in PAGED_PLANE_CALLS])
def test_paged_plane_packets_match_jax(name, method, args, kwargs):
    """Each paged encoder's packets equal the JAX package's, word for word:
    the row and its copy pairs, the payload fragments of ``chunk * 4``
    bytes and their flags."""
    from distributed_llama_multiusers_tpu.parallel import multihost as J
    from distributed_llama_multiusers_tpu_torch.parallel import multihost as P

    jp, pp = J.ControlPlane(N_LANES, chunk=CHUNK), P.ControlPlane(N_LANES, chunk=CHUNK)
    got, want = _capture(pp), _capture(jp)
    getattr(pp, method)(*args, **kwargs)
    getattr(jp, method)(*args, **kwargs)
    assert len(got) == len(want) >= 1
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
    assert P.PROTOCOL_VERSION == J.PROTOCOL_VERSION == 6


POOL_PAGES = 12
PAGE_SIZE = 4
BLOCKS = 4  # blocks a lane: seq_len 16 over 4-token pages


class _PortStubEngine:
    """What the port's proxy reads of a paged engine: a real pool (the
    port's), the table row, the payload check; the calls record."""

    n_lanes = N_LANES

    def __init__(self, pages: int = POOL_PAGES):
        from distributed_llama_multiusers_tpu_torch.runtime.kvpool import KVPagePool

        self.kvpool = KVPagePool(pages, PAGE_SIZE, N_LANES, BLOCKS, host_bytes=1 << 20)
        self.calls: list = []

    def _check_payloads(self, payloads):
        for i, p in enumerate(payloads):
            if len(p) != PAGE_WORDS * 4:
                raise ValueError(f"kv page payload {i} is {len(p)} bytes")

    def __getattr__(self, name):
        return lambda *a, **k: self.calls.append((name, a, k))


class _JaxStubEngine:
    """The same for the JAX proxy: its pool, ``_paged_table_row`` and the
    page leaf's geometry (PAGE_WORDS float32 a half)."""

    n_lanes = N_LANES

    def __init__(self):
        from distributed_llama_multiusers_tpu.runtime.kvpool import KVPagePool

        self.kvpool = KVPagePool(POOL_PAGES, PAGE_SIZE, N_LANES, BLOCKS, host_bytes=1 << 20)
        self.calls: list = []

    def _paged_table_row(self, blocks):
        return self.kvpool.table_row(blocks)

    def _page_leaf_geometry(self):
        return (PAGE_WORDS // 2,), np.dtype(np.float32)

    def __getattr__(self, name):
        return lambda *a, **k: self.calls.append((name, a, k))


def _admit_then(method):
    """A paged call after one admission of 9 tokens on lane 1 (its pages
    reserved), so that the release has something to unmap."""
    def run(root):
        root.paged_admit(1, list(range(9)), 12)
        return getattr(root, method[0])(*method[1])
    return run


PAGED_ROOT_CALLS = [
    ("apply_paged_admit", lambda r: r.apply_paged_admit(2, [1, 0, 12, 12], [(5, 1)])),
    ("paged_admit", lambda r: r.paged_admit(0, list(range(10)), 14)),
    ("paged_finish", _admit_then(("paged_finish", (1,)))),
    ("paged_finish_free", _admit_then(("paged_finish", (1, False)))),
    ("paged_reset", lambda r: r.paged_reset()),
    ("import_kv_page", lambda r: r.import_kv_page(4, _P1)),
    ("swap_in_pages", lambda r: r.swap_in_pages([3, 7], [_P2, _P1])),
]


@pytest.mark.parametrize("name,call", PAGED_ROOT_CALLS, ids=[c[0] for c in PAGED_ROOT_CALLS])
def test_paged_root_proxy_packets_match_jax(name, call):
    """Each paged proxy call of the root puts the JAX package's packets on
    the wire (its pool bookkeeping, the table row it derives, the payload
    fragments), and both make the same engine calls."""
    from distributed_llama_multiusers_tpu.parallel import multihost as J
    from distributed_llama_multiusers_tpu_torch.parallel import multihost as P

    jp, pp = J.ControlPlane(N_LANES, chunk=CHUNK), P.ControlPlane(N_LANES, chunk=CHUNK)
    got, want = _capture(pp), _capture(jp)
    peng, jeng = _PortStubEngine(), _JaxStubEngine()
    call(P.RootControlEngine(peng, pp))
    call(J.RootControlEngine(jeng, jp))
    assert len(got) == len(want) >= 1
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
    names = {"apply_paged_admit", "paged_unmap_all", "import_kv_page", "swap_in_pages",
             "drain_kv_swapouts"}
    assert [(c[0], c[1]) for c in peng.calls if c[0] in names] == \
        [(c[0], c[1]) for c in jeng.calls if c[0] in names]


def test_root_proxy_verify_step_keeps_want_logits_on_the_root():
    """The scheduler's synchronous verify step asks for no logits: the
    proxy takes the flag to the root's engine and sends the JAX package's
    packet, whose verify step carries no such field."""
    from distributed_llama_multiusers_tpu.parallel import multihost as J
    from distributed_llama_multiusers_tpu_torch.parallel import multihost as P
    from tests.test_torch_multihost import _DLEN, _DRAFTS, _POS, _TOK, _StubEngine

    class Recording(_StubEngine):
        def decode_spec(self, *a, **k):
            self.got = k

    jp, pp = J.ControlPlane(3, chunk=CHUNK), P.ControlPlane(3, chunk=CHUNK)
    got, want = _capture(pp), _capture(jp)
    eng = Recording()
    P.RootControlEngine(eng, pp).decode_spec(_TOK, _DRAFTS, _DLEN, _POS, want_logits=False)
    J.RootControlEngine(_StubEngine(), jp).decode_spec(_TOK, _DRAFTS, _DLEN, _POS)
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want] and len(got) == 1
    assert eng.got["want_logits"] is False


def _exhaust(root):
    # a pool of 8 pages held by lanes 0 and 1: lane 2's cannot be served
    root.paged_admit(0, list(range(16)), 16)
    root.paged_admit(1, list(range(20, 36)), 16)
    return lambda: root.paged_admit(2, list(range(40, 56)), 16)


REFUSED_CALLS = [
    ("contiguous_admit", None, lambda r: r.paged_admit(0, [1, 2], 4), RuntimeError),
    ("contiguous_import", None, lambda r: r.import_kv_page(0, _P1), RuntimeError),
    ("contiguous_swap", None, lambda r: r.swap_in_pages([0], [_P1]), RuntimeError),
    ("contiguous_reset", None, lambda r: r.paged_reset(), RuntimeError),
    ("row_width", "paged", lambda r: r.apply_paged_admit(0, [1, 2], []), ValueError),
    ("lane", "paged", lambda r: r.apply_paged_admit(N_LANES, [12] * 4, []), ValueError),
    ("copy_page", "paged", lambda r: r.apply_paged_admit(0, [12] * 4, [(0, 99)]), ValueError),
    ("import_size", "paged", lambda r: r.import_kv_page(0, _P1[:-4]), ValueError),
    ("import_page", "paged", lambda r: r.import_kv_page(POOL_PAGES, _P1), ValueError),
    ("swap_count", "paged", lambda r: r.swap_in_pages([0, 1], [_P1]), ValueError),
    ("swap_size", "paged", lambda r: r.swap_in_pages([0, 1], [_P1, _P3]), ValueError),
    ("swap_empty", "paged", lambda r: r.swap_in_pages([], []), None),
    ("finish_unmapped", "paged", lambda r: r.paged_finish(2), None),
    ("copy_lane_paged", "paged", lambda r: r.copy_lane(0, 1), RuntimeError),
    ("exhausted", "exhaust", None, "PoolExhausted"),
]


@pytest.mark.parametrize("name,engine,call,err", REFUSED_CALLS,
                         ids=[c[0] for c in REFUSED_CALLS])
def test_paged_proxy_sends_nothing_on_a_refused_call(name, engine, call, err):
    """The pod-deadlock rule on the paged calls: each raises (or has
    nothing to do) before any packet goes out, and the root's engine does
    nothing either: a contiguous engine, a row of another width, a lane or
    page outside the pool, a payload of another size, a count mismatch, an
    empty batch, a release of a lane that mapped nothing, a prefix copy on
    a paged engine, an admission the exhausted pool sheds."""
    from distributed_llama_multiusers_tpu_torch.parallel import multihost as P
    from distributed_llama_multiusers_tpu_torch.runtime.kvpool import PoolExhausted

    pp = P.ControlPlane(N_LANES, chunk=CHUNK)
    eng = _PortStubEngine(pages=8 if engine == "exhaust" else POOL_PAGES)
    if engine is None:
        eng.kvpool = None
    root = P.RootControlEngine(eng, pp)
    sent = _capture(pp)
    if engine == "exhaust":
        go = _exhaust(root)
        call, err = (lambda r: go()), PoolExhausted
    sent.clear()
    eng.calls.clear()
    if err is None:
        call(root)
    else:
        with pytest.raises(err):
            call(root)
    assert sent == []
    assert [c for c in eng.calls if c[0] != "drain_kv_swapouts"] == []


# ---------------------------------------------------------------------------
# the worker's arms, fed the JAX package's packets
# ---------------------------------------------------------------------------


class _RecordingEngine:
    """A paged worker's engine as the replay loop sees it: a pool of
    BLOCKS blocks a lane, every call recorded; ``reject`` makes the payload
    calls raise the engine's ``ValueError``."""

    SPEC_DRAFT = 3

    def __init__(self, paged=True, blocks=BLOCKS, reject=False):
        from distributed_llama_multiusers_tpu_torch.runtime.engine import EngineStats

        self.kvpool = type("Pool", (), {"blocks_per_lane": blocks})() if paged else None
        self.calls: list = []
        self.reject = reject
        self.stats = EngineStats()

    def _payload_call(self, name, *a):
        if self.reject:
            raise ValueError("kv page payload 0 is 4 bytes, expected 8")
        self.calls.append((name, a))

    def apply_paged_admit(self, lane, row, copies):
        self.calls.append(("apply_paged_admit", (lane, [int(x) for x in row],
                                                  [tuple(c) for c in copies])))

    def paged_unmap_all(self):
        self.calls.append(("paged_unmap_all", ()))

    def import_kv_page(self, page, payload):
        self._payload_call("import_kv_page", int(page), bytes(payload))

    def swap_in_pages(self, pages, payloads):
        self._payload_call("swap_in_pages", [int(p) for p in pages],
                           [bytes(b) for b in payloads])

    def decode(self, *a, **k):
        self.calls.append(("decode", ()))


class _PacketPlane:
    """Replays captured packets through the port's validation gate."""

    HEADER = 6

    def __init__(self, pkts, chunk=CHUNK):
        from distributed_llama_multiusers_tpu_torch.parallel.multihost import ControlPlane

        self._pkts = list(pkts)
        self.chunk = chunk
        self._validate = ControlPlane.validate

    def recv(self):
        pkt = self._pkts.pop(0)
        self._validate(pkt)
        return pkt

    def slot(self, pkt, i, n):
        start = self.HEADER + i * self.chunk
        return pkt[start:start + n]


def _jax_packets(sends) -> list:
    """The JAX package's packets for ``sends`` (plane method, args), then a
    stop."""
    from distributed_llama_multiusers_tpu.parallel import multihost as J

    jp = J.ControlPlane(N_LANES, chunk=CHUNK)
    pkts = _capture(jp)
    for method, args in sends:
        getattr(jp, method)(*args)
    jp.send_stop()
    return pkts


WORKER_SCRIPTS = [
    ("table", [("send_kv_table", (1, [4, 2, 12, 12], [(3, 4), (7, 2)])),
               ("send_kv_table", (0, [12] * 4, []))]),
    ("reset", [("send_kv_table", (-1, [], []))]),
    ("pages", [("send_kv_pages", ([(5, _P1), (2, _P3)],))]),
    ("swap", [("send_kv_swap", ([(3, _P1), (1, _P3), (6, _P2)],)),
              ("send_kv_swap", ([(0, _P2)],))]),
    ("mixed", [("send_kv_swap", ([(9, _P3)],)), ("send_kv_table", (2, [9, 12, 12, 12], [])),
               ("send_kv_pages", ([(11, _P2)],))]),
]


class _JaxRecordingEngine(_RecordingEngine):
    pass


@pytest.mark.parametrize("name,sends", WORKER_SCRIPTS, ids=[s[0] for s in WORKER_SCRIPTS])
def test_worker_paged_arms_make_jax_calls(name, sends):
    """The port's ``worker_loop`` over the JAX package's packets makes the
    engine calls JAX's ``worker_loop`` makes over the same packets: the
    table row and pairs, the reset, each page reassembled from its
    fragments, one ``swap_in_pages`` call a batch."""
    from distributed_llama_multiusers_tpu.parallel import multihost as J
    from distributed_llama_multiusers_tpu_torch.parallel import multihost as P

    pkts = _jax_packets(sends)
    port, jax_eng = _RecordingEngine(), _JaxRecordingEngine()
    P.worker_loop(port, _PacketPlane([p.copy() for p in pkts]))
    J.worker_loop(jax_eng, _PacketPlane([p.copy() for p in pkts]))
    assert port.calls == jax_eng.calls and port.calls
    if name == "swap":
        assert [c[0] for c in port.calls] == ["swap_in_pages"] * 2
        assert port.calls[0][1][0] == [3, 1, 6]


SKEWS = [
    ("table_on_contiguous", {"paged": False}, ("send_kv_table", (1, [4, 2, 12, 12], [])),
     "OP_KV_TABLE on a non-paged engine"),
    ("pages_on_contiguous", {"paged": False}, ("send_kv_pages", ([(5, _P1)],)),
     "OP_KV_PAGES on a non-paged engine"),
    ("swap_on_contiguous", {"paged": False}, ("send_kv_swap", ([(3, _P1)],)),
     "OP_KV_SWAP on a non-paged engine"),
    ("table_width", {"blocks": BLOCKS + 1}, ("send_kv_table", (1, [4, 2, 12, 12], [])),
     "blocks/lane"),
    ("pages_size", {"reject": True}, ("send_kv_pages", ([(5, _P1)],)),
     "OP_KV_PAGES payload rejected"),
    ("swap_size", {"reject": True}, ("send_kv_swap", ([(3, _P1), (4, _P2)],)),
     "OP_KV_SWAP payload rejected"),
]


@pytest.mark.parametrize("name,engine_kw,send,what", SKEWS, ids=[s[0] for s in SKEWS])
def test_paged_skew_is_a_replay_error_that_burns_no_restart(name, engine_kw, send, what):
    """A paged packet that this worker's engine cannot take (its flags
    skewed against the root's) is a classified ``ReplayError`` before any
    dispatch: ``worker_serve`` resubscribes without spending its restart
    budget (max_restarts=0) and replays the next packet."""
    from distributed_llama_multiusers_tpu.parallel import multihost as J
    from distributed_llama_multiusers_tpu_torch.parallel.multihost import worker_serve

    jp = J.ControlPlane(N_LANES, chunk=CHUNK)
    pkts = _capture(jp)
    getattr(jp, send[0])(*send[1])
    jp.send_decode(np.zeros(N_LANES, np.int32), np.zeros(N_LANES, np.int32))
    jp.send_stop()
    engine = _RecordingEngine(**engine_kw)
    said = []
    worker_serve(engine, _PacketPlane(pkts), max_restarts=0, log=said.append)
    # a contiguous engine refuses each fragment's packet; a rejected
    # payload fails once, at the page's (or batch's) last fragment
    errors = len(pkts) - 2 if not engine_kw.get("reject") else 1
    assert engine.stats.worker_replay_errors == errors and engine.stats.worker_restarts == 0
    assert len(said) == errors and all(what in line for line in said)
    assert [c[0] for c in engine.calls] == ["decode"]


def test_scripted_paged_op_on_a_contiguous_engine_is_classified():
    """The scripted planes of the multi-process tests: an OP_KV_TABLE
    packet to a worker whose engine has no pool is a ``ReplayError``."""
    from distributed_llama_multiusers_tpu_torch.parallel.multihost import (
        OP_KV_TABLE,
        OP_STOP,
        ReplayError,
        worker_loop,
    )

    engine = _RecordingEngine(paged=False)
    with pytest.raises(ReplayError, match="--paged-kv flags are skewed"):
        worker_loop(engine, _ScriptedPlane([OP_KV_TABLE, OP_STOP]))


# ---------------------------------------------------------------------------
# a two-process paged pod (the engine, its page I/O and the scheduler)
# ---------------------------------------------------------------------------

POD_PAGE = 8
POD_POOL = 6
SYSTEM = "aa bb cc dd ee ff gg hh "
PROMPTS = ["zz unrelated", SYSTEM + "11", "the other long prompt runs past the pool",
           SYSTEM + "22", SYSTEM + "11 and more"]

PAGED_POD_DRIVER = BLOCKER.replace("{", "{{").replace("}", "}}") + textwrap.dedent(
    """
    import json, os, sys
    sys.path.insert(0, {repo!r})
    mode, tmp, port = sys.argv[1], sys.argv[2], sys.argv[3]

    import numpy as np
    import torch
    from distributed_llama_multiusers_tpu_torch.disagg.kvtransfer import export_bundle
    from distributed_llama_multiusers_tpu_torch.formats import load_model_header
    from distributed_llama_multiusers_tpu_torch.models import load_params_from_m
    from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
    from distributed_llama_multiusers_tpu_torch.parallel.multihost import (
        ControlPlane, RootControlEngine, maybe_initialize_distributed, pod_store, worker_serve,
    )
    from distributed_llama_multiusers_tpu_torch.parallel.sharding import shard_params
    from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine
    from distributed_llama_multiusers_tpu_torch.runtime.scheduler import (
        ContinuousBatchingScheduler, Request,
    )
    from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer

    os.environ["DLLAMA_COORDINATOR"] = f"127.0.0.1:{{port}}"
    os.environ["DLLAMA_NUM_PROCESSES"] = "2"
    os.environ["DLLAMA_PROCESS_ID"] = "0" if mode == "root" else "1"
    assert maybe_initialize_distributed() == 2
    pid = 0 if mode == "root" else 1

    h = load_model_header(os.path.join(tmp, "m.m"))
    config, params = load_params_from_m(os.path.join(tmp, "m.m"), h, dtype=torch.float32,
                                        device="cpu")
    mesh = make_mesh(MeshPlan(tp=2), ["cpu"], process_index=pid, num_processes=2)
    engine = InferenceEngine(config, shard_params(params, mesh), n_lanes=2, device="cpu",
                             mesh=mesh, prefill_buckets=(8,), paged_kv=True,
                             kv_page_size={page}, kv_pool_pages={pool},
                             kv_host_bytes=1 << 20)
    plane = ControlPlane(2, chunk=64)
    assert list(mesh.local_ranks) == [pid] and engine.kvshare is not None
    nbytes = engine.kv_page_bytes()
    payloads = [np.random.default_rng(s).standard_normal(nbytes // 4).astype(np.float32)
                .tobytes() for s in (1, 2)]
    store = pod_store()
    if mode == "root":
        eng = RootControlEngine(engine, plane)
        t = Tokenizer(os.path.join(tmp, "t.t"))
        out = {{}}
        try:
            # page I/O: an import on both processes, the whole page back
            eng.import_kv_page(3, payloads[0])
            out["export"] = eng.export_kv_page(3) == payloads[0]
            out["swap_out"] = eng.swap_out_pages([3]) == [payloads[0]]
            eng.swap_in_pages([5, 3], [payloads[1], payloads[0]])
            out["swap_round_trip"] = [eng.export_kv_page(p) for p in (5, 3)] == [
                payloads[1], payloads[0]]
            out["root_heads"] = engine.cache[0].k[:, 3].numpy().tobytes().hex()
            eng.paged_reset()
            sched = ContinuousBatchingScheduler(eng, t, speculative=False)
            sched.start()
            try:
                streams, saved = [], []
                for p in {prompts!r}:
                    r = Request(prompt=p, max_tokens=8, temperature=0.0)
                    sched.submit(r)
                    r.future.result(timeout=120)
                    assert r.error is None, r.error
                    streams.append(list(r.generated_tokens))
                    saved.append(r.summary["prefix_tokens_saved"])
            finally:
                sched.stop()
            out.update(streams=streams, saved=saved, pool=engine.pool_stats())
            chain = t.encode({prompts!r}[-1], add_bos=True, add_special_tokens=True)
            out["bundle"] = export_bundle(engine.kvpool, eng, chain)
            out["pod"] = eng.pod_stats()
        finally:
            eng.stop_workers()
        store.wait(["test/worker_done"])
        with open(os.path.join(tmp, "root_paged.json"), "w") as f:
            json.dump(out, f)
    else:
        got = {{}}
        replay_import = engine.import_kv_page

        def import_then_read(page, payload):
            # the worker's replay of the import: its own plane holds rank 1's
            # heads, and its read of the page is the whole page
            replay_import(page, payload)
            got["heads"] = engine.cache[0].k[:, 3].numpy().tobytes().hex()
            got["export"] = engine.export_kv_page(3) == payloads[0]

        engine.import_kv_page = import_then_read
        worker_serve(engine, plane, max_restarts=0)
        got["swap_ins"] = engine.swap_ins
        got["swap_in_bytes"] = engine.swap_in_bytes
        with open(os.path.join(tmp, "worker_paged.json"), "w") as f:
            json.dump(got, f)
        store.set("test/worker_done", "1")
    print(f"{{mode}} done", flush=True)
    """
)


def _run_paged_pod(tmp: str) -> tuple[dict, dict]:
    driver = os.path.join(tmp, "paged_driver.py")
    with open(driver, "w") as f:
        f.write(PAGED_POD_DRIVER.format(repo=REPO, page=POD_PAGE, pool=POD_POOL,
                                        prompts=PROMPTS))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, driver, mode, tmp, str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=_env()) for mode in ("root", "worker")]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=POD_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"pod process failed:\n{out[-3000:]}"
    with open(os.path.join(tmp, "root_paged.json")) as f:
        root = json.load(f)
    with open(os.path.join(tmp, "worker_paged.json")) as f:
        worker = json.load(f)
    return root, worker


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from distributed_llama_multiusers_tpu.formats.synthetic import (
        tiny_header,
        write_synthetic_model,
        write_synthetic_tokenizer,
    )

    tmp = str(tmp_path_factory.mktemp("pod_paged_model"))
    # 128 slots: prefill buckets 16 and 64, so a server shares a prompt's
    # first 64 tokens (its share quantum, the largest bucket)
    header = tiny_header(seq_len=128)
    write_synthetic_model(os.path.join(tmp, "m.m"), header, seed=7)
    write_synthetic_tokenizer(os.path.join(tmp, "t.t"), vocab_size=header.vocab_size)
    return tmp


def _one_process_tp2(tmp: str):
    import torch

    from distributed_llama_multiusers_tpu_torch.formats import load_model_header
    from distributed_llama_multiusers_tpu_torch.models import load_params_from_m
    from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
    from distributed_llama_multiusers_tpu_torch.parallel.sharding import shard_params
    from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine

    h = load_model_header(os.path.join(tmp, "m.m"))
    config, params = load_params_from_m(os.path.join(tmp, "m.m"), h, dtype=torch.float32,
                                        device="cpu")
    mesh = make_mesh(MeshPlan(tp=2), ["cpu", "cpu"])
    return InferenceEngine(config, shard_params(params, mesh), n_lanes=2, device="cpu",
                           mesh=mesh, prefill_buckets=(8,), paged_kv=True,
                           kv_page_size=POD_PAGE, kv_pool_pages=POD_POOL,
                           kv_host_bytes=1 << 20)


def test_paged_pod_page_io_and_streams_match_one_process_and_jax(model_dir, tmp_path):
    """A two-process paged pod (the worker holds rank 1 only): an imported
    page lands as rank 1's heads in the worker's plane and comes back
    whole from the root's export, its swap-out and a swap-in round trip,
    byte-equal to the one-process tp2 engine. The root's scheduler serves
    greedy requests through a pool of POD_POOL pages with the host tier:
    the streams, the tokens each shared and the swap counts equal the
    one-process paged tp2 scheduler's, the streams the JAX paged
    scheduler's; the worker replayed the swap-ins, and the last prompt's
    committed chain exports the one-process engine's bytes."""
    import jax.numpy as jnp

    from distributed_llama_multiusers_tpu.formats.model_file import load_model_header
    from distributed_llama_multiusers_tpu.models.loader import load_params_from_m
    from distributed_llama_multiusers_tpu.runtime import ContinuousBatchingScheduler as JSched
    from distributed_llama_multiusers_tpu.runtime import InferenceEngine as JEngine
    from distributed_llama_multiusers_tpu.runtime import Request as JRequest
    from distributed_llama_multiusers_tpu.tokenizer import Tokenizer as JTokenizer
    from distributed_llama_multiusers_tpu_torch.disagg.kvtransfer import export_bundle
    from distributed_llama_multiusers_tpu_torch.runtime.scheduler import (
        ContinuousBatchingScheduler,
        Request,
    )
    from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer

    tmp = _copy_model(model_dir, str(tmp_path))
    root, worker = _run_paged_pod(tmp)
    assert root["export"] and root["swap_out"] and root["swap_round_trip"]
    assert worker["export"]

    # the one-process tp2 engine, the same import: the pod's root holds
    # rank 0's heads of it, the worker rank 1's
    one = _one_process_tp2(tmp)
    nbytes = one.kv_page_bytes()
    payload = np.random.default_rng(1).standard_normal(nbytes // 4).astype(np.float32).tobytes()
    one.import_kv_page(3, payload)
    assert root["root_heads"] == one.cache[0].k[:, 3].numpy().tobytes().hex()
    assert worker["heads"] == one.cache[1].k[:, 3].numpy().tobytes().hex()
    assert root["root_heads"] != worker["heads"]
    one.paged_reset()

    tok = Tokenizer(os.path.join(tmp, "t.t"))
    sched = ContinuousBatchingScheduler(one, tok, speculative=False)
    sched.start()
    try:
        want, saved = [], []
        for p in PROMPTS:
            r = Request(prompt=p, max_tokens=8, temperature=0.0)
            sched.submit(r)
            r.future.result(timeout=120)
            assert r.error is None, r.error
            want.append(list(r.generated_tokens))
            saved.append(r.summary["prefix_tokens_saved"])
    finally:
        sched.stop()
    assert root["streams"] == want and root["saved"] == saved and sum(saved) > 0
    pool = one.pool_stats()
    # the root's counts hold the page check's two swap-ins too
    assert root["pool"]["swap_ins"] == pool["swap_ins"] + 2 and pool["swap_ins"] > 0
    assert root["pool"]["swap_outs"] == pool["swap_outs"] > 0
    assert worker["swap_ins"] == root["pool"]["swap_ins"]
    assert worker["swap_in_bytes"] == root["pool"]["swap_in_bytes"]
    chain = tok.encode(PROMPTS[-1], add_bos=True, add_special_tokens=True)
    bundle = export_bundle(one.kvpool, one, chain)
    assert bundle["blocks"] and root["bundle"] == bundle
    assert root["pod"]["pod_ring_pulls"] > 0

    h = load_model_header(os.path.join(tmp, "m.m"))
    jconfig, jparams = load_params_from_m(os.path.join(tmp, "m.m"), h, dtype=jnp.float32)
    jeng = JEngine(jconfig, jparams, n_lanes=2, prefill_buckets=(8,), paged_kv=True,
                   kv_page_size=POD_PAGE)
    jsched = JSched(jeng, JTokenizer(os.path.join(tmp, "t.t")), speculative=False,
                    pipelined=False, fused_prefill=False, multi_step=1)
    jsched.start()
    try:
        jstreams = []
        for p in PROMPTS:
            r = jsched.submit(JRequest(prompt=p, max_tokens=8))
            r.future.result(timeout=300)
            assert r.error is None, r.error
            jstreams.append(list(r.generated_tokens))
    finally:
        jsched.stop()
    assert root["streams"] == jstreams


def test_pool_share_read_waits_for_the_peers_page_writes(monkeypatch):
    """The share's ordering rule on the CPU (parallel/kvshare.py): two
    ranks' regions, each opened by its own holder over one store; a
    reader's ``wait`` for a count returns only once the peer has posted
    that count of page writes (or more), and then the peer's heads are
    read as written. A peer whose process is gone makes the wait raise."""
    import threading

    import torch

    from distributed_llama_multiusers_tpu_torch.parallel import kvshare
    from distributed_llama_multiusers_tpu_torch.parallel.window import PodPeerLost

    store = torch.distributed.HashStore()
    shape = (2, 3, 4, 1, 8)
    shares = {}

    def open_rank(r):
        shares[r] = kvshare.open_pool_share(2, {r: torch.device("cpu")}, shape,
                                            torch.float32, store, prefix="t")

    threads = [threading.Thread(target=open_rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    reader, writer = shares[0], shares[1]
    waited = threading.Event()
    waiter = threading.Thread(target=lambda: (reader.wait(1), waited.set()))
    waiter.start()
    writer.planes[1][0].fill_(3.0)  # the peer's page write ...
    time.sleep(0.3)
    assert not waited.is_set()  # ... not announced yet: the read waits
    writer.post(1)
    waiter.join(timeout=10)
    assert waited.is_set()
    assert torch.equal(reader.planes[1][0], torch.full(shape, 3.0))
    writer.post(5)
    reader.wait(2)  # a count the peer has passed returns at once
    reader.owner[1] = 2 ** 22 + 12345  # above any pid: no such process
    monkeypatch.setattr(kvshare, "_LIVENESS_S", 0.0)
    with pytest.raises(PodPeerLost):
        reader.wait(9)


def test_page_read_across_processes_matches_local():
    """``tools/pod_pages.py --device cpu``: two processes, each holding one
    rank's pool planes in shared memory, read every rank's heads of random
    pages (f32 and the e4m3 bytes), equal to the pages each wrote."""
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", "pod_pages.py"), "--device",
                        "cpu", "--small", "--timeout", "120"],
                       capture_output=True, text=True, timeout=180, env=_env(), cwd=REPO)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rows = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert [row["ranks"] for row in rows] == [[0], [1]]
    for row in rows:
        assert row["checks"] and all(row["checks"].values()) and not row["failed"], row


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

# 12 pages of 8 tokens: a ~69-token prompt reserves 10 and parks 8 (its
# whole 64-token chunk), so one parked session and another's admission do
# not fit together
SWAP_FLAGS = ["--paged-kv", "on", "--kv-page-size", "8", "--kv-pool-pages", "12",
              "--kv-max-parked", "4", "--kv-host-bytes", str(16 << 20)]
X_PROMPT = "hello world " * 17
Y_PROMPT = "once upon a time " * 4
HANDOFF_PROMPT = "the quick brown fox jumps " * 3  # 76 tokens


def _pod(tmp: str, extra: list, name: str):
    """A pod's root ``dllama_api`` and its ``dllama worker`` on the CPU."""
    coord = f"127.0.0.1:{_free_port()}"
    port = _free_port()
    common = ["--model", os.path.join(tmp, "m.m"), "--tokenizer", os.path.join(tmp, "t.t"),
              "--workers", "2", "--device", "cpu", "--coordinator", coord,
              "--num-processes", "2", *extra]
    root_log = os.path.join(tmp, f"{name}_root.log")
    worker_log = os.path.join(tmp, f"{name}_worker.log")
    worker = _entry(CLI, ["worker", *common, "--process-id", "1"], worker_log)
    root = _entry(API, [*common, "--process-id", "0", "--host", "127.0.0.1",
                        "--port", str(port)], root_log)
    return f"http://127.0.0.1:{port}", root, worker, root_log, worker_log


def _one_server(tmp: str, extra: list, name: str):
    port = _free_port()
    log = os.path.join(tmp, f"{name}.log")
    proc = _entry(API, ["--model", os.path.join(tmp, "m.m"), "--tokenizer",
                        os.path.join(tmp, "t.t"), "--workers", "2", "--device", "cpu",
                        "--host", "127.0.0.1", "--port", str(port), *extra], log)
    return f"http://127.0.0.1:{port}", proc, log


def _call(base: str, route: str, body=None, timeout: float = 120) -> tuple[int, dict]:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + route, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _text(base: str, prompt: str, max_tokens: int = 10) -> str:
    status, body = _call(base, "/v1/completions", {"prompt": prompt, "max_tokens": max_tokens,
                                                   "temperature": 0})
    assert status == 200, body
    return body["choices"][0]["text"]


def _worker_exit(worker_log: str) -> dict:
    exits = [ln for ln in open(worker_log) if ln.startswith('{"event": "worker_exit"')]
    assert len(exits) == 1, open(worker_log).read()[-3000:]
    return json.loads(exits[0])


def _swap_traffic(base: str) -> list:
    """X parks; Y needs its pages (X swaps out to the host tier); X again
    comes back from the host tier."""
    return [_text(base, X_PROMPT), _text(base, Y_PROMPT), _text(base, X_PROMPT)]


def _serve_paged(tmp):
    """The ``--paged-kv on`` case: the pod's texts equal the one-process
    paged tp2 server's; a returning prompt swapped in on the root and in
    the worker; equal ring counts; both exit 0 on the root's SIGTERM."""
    sbase, single, slog = _one_server(tmp, SWAP_FLAGS, "single_paged")
    base, root, worker, root_log, worker_log = _pod(tmp, SWAP_FLAGS, "paged")
    try:
        _wait_healthy(sbase, single, slog)
        want = _swap_traffic(sbase)
        _wait_healthy(base, root, root_log)
        got = _swap_traffic(base)
        _, stats = _call(base, "/stats")
        _, page = _call(base, "/load")
        root.send_signal(15)
        assert root.wait(timeout=90) == 0, open(root_log).read()[-3000:]
        assert worker.wait(timeout=60) == 0, open(worker_log).read()[-3000:]
    finally:
        _stop(single, root, worker)
    assert got == want and got[0] == got[2]
    assert stats["swap_outs"] > 0 and stats["swap_ins"] > 0
    assert stats["pool_pages_total"] == 12 and page["pool_pages_total"] == 12
    exit_line = _worker_exit(worker_log)
    assert exit_line["swap_ins"] == stats["swap_ins"]
    assert exit_line["kv_page_writes"] == stats["kv_page_writes"] > 0
    assert exit_line["swap_in_bytes"] == stats["swap_in_bytes"] > 0
    for k in ("ring_hop_plain_calls", "pod_ring_steps", "pod_ring_pulls"):
        assert exit_line[k] == stats[k] > 0, k
    for log in (root_log, worker_log):
        assert "Paged KV: 12 pages x 8 tokens" in open(log).read()


def _sse_text(lines) -> str:
    text = ""
    for line in lines:
        line = line.decode().strip() if isinstance(line, bytes) else line.strip()
        if line.startswith("data: {"):
            chunk = json.loads(line[6:])
            assert "error" not in chunk, chunk
            for choice in chunk.get("choices") or ():
                text += choice.get("text") or ""
    return text


def _serve_role(tmp, monkeypatch):
    """The ``--role decode`` case: a one-process paged tp2 ``--role
    prefill`` server hands a live session (held live by one 8 s step, the
    seeded fault plan) off to a paged ``--role decode`` pod
    (``disagg.prefill.hand_off``): the pod adopts the bundle's pages
    through OP_KV_PAGES on both processes (the worker made the root's page
    writes), shares the prompt's whole chunk, and its regenerated stream
    equals the prefill server's own."""
    from distributed_llama_multiusers_tpu_torch.disagg.prefill import hand_off

    flags = ["--paged-kv", "on", "--kv-page-size", "8", "--reconnect-grace", "30"]
    monkeypatch.setenv("DLLAMA_FAULTS", "engine.dispatch:@6:n=1:kind=hang:hang=8")
    sbase, single, slog = _one_server(tmp, flags + ["--role", "prefill"], "prefill")
    monkeypatch.delenv("DLLAMA_FAULTS")
    base, root, worker, root_log, worker_log = _pod(tmp, flags + ["--role", "decode"], "decode")
    try:
        _wait_healthy(sbase, single, slog)
        _wait_healthy(base, root, root_log)
        _, load = _call(base, "/load")
        body = json.dumps({"prompt": HANDOFF_PROMPT, "max_tokens": 30, "temperature": 0,
                           "stream": True}).encode()
        req = urllib.request.Request(sbase + "/v1/completions", data=body,
                                     headers={"Content-Type": "application/json"})
        src = urllib.request.urlopen(req, timeout=120)
        rid = int(src.headers["X-DLlama-Request"])
        first = src.readline()  # the first delta: the prompt's blocks are committed
        conn, resp, _, receipt = hand_off("127.0.0.1", int(sbase.rsplit(":", 1)[1]), rid,
                                          "127.0.0.1", int(base.rsplit(":", 1)[1]),
                                          timeout=60, read_timeout=120)
        got = _sse_text(resp)
        conn.close()
        want = _sse_text([first, *src])
        src.close()
        _, stats = _call(base, "/stats")
        root.send_signal(15)
        assert root.wait(timeout=90) == 0, open(root_log).read()[-3000:]
        assert worker.wait(timeout=60) == 0, open(worker_log).read()[-3000:]
    finally:
        _stop(single, root, worker)
    assert load["role"] == "decode"
    assert receipt["fresh"] == receipt["pages"] > 0
    assert got == want and got
    assert stats["pool_adopts"] == 1 and stats["prefix_tokens_saved"] == 64
    exit_line = _worker_exit(worker_log)
    assert exit_line["kv_page_writes"] == stats["kv_page_writes"] >= receipt["fresh"]


@pytest.mark.parametrize("flags,what", [(["--paged-kv", "on"], "--paged-kv on"),
                                        (["--role", "decode"], "--role decode")])
def test_pod_serves_what_it_once_refused(model_dir, tmp_path, monkeypatch, flags, what):
    """``--paged-kv on`` and ``--role`` on a pod of ``dllama_api`` and
    ``dllama worker``, which the startup once refused, are served: the
    paged pod answers like the one-process paged server and swaps through
    the host tier on both processes; a decode pod adopts a hand-off."""
    tmp = _copy_model(model_dir, str(tmp_path))
    if what == "--paged-kv on":
        _serve_paged(tmp)
    else:
        _serve_role(tmp, monkeypatch)


def test_paged_worker_beside_a_contiguous_root_stops_at_startup(model_dir, tmp_path):
    """``dllama inference`` keeps contiguous planes; a ``dllama worker
    --paged-kv on`` beside it disagrees on the KV layout: both processes
    exit 2 at startup, naming the skew, within the timeout (no hang)."""
    tmp = _copy_model(model_dir, str(tmp_path))
    args = ["inference", "--model", os.path.join(tmp, "m.m"), "--tokenizer",
            os.path.join(tmp, "t.t"), "--workers", "2", "--device", "cpu", "--prompt",
            "hello world", "--steps", "4", "--temperature", "0", "--paged-kv", "on"]
    coord = ["--coordinator", f"127.0.0.1:{_free_port()}", "--num-processes", "2"]
    worker_log, root_log = os.path.join(tmp, "skew_worker.log"), os.path.join(tmp, "skew_root.log")
    worker = _entry(CLI, ["worker", *args[1:], *coord, "--process-id", "1"], worker_log)
    root = _entry(CLI, [*args, *coord, "--process-id", "0"], root_log)
    t0 = time.monotonic()
    try:
        rcs = [root.wait(timeout=POD_TIMEOUT), worker.wait(timeout=60)]
    finally:
        _stop(root, worker)
    assert time.monotonic() - t0 < POD_TIMEOUT
    assert rcs[1] != 0 and rcs[0] != 0, (open(root_log).read()[-2000:],
                                         open(worker_log).read()[-2000:])
    text = open(root_log).read() + open(worker_log).read()
    assert "disagree on pod/kv_layout" in text and "contiguous" in text
