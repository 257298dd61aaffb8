"""The port's pod on the CPU: two real processes (gloo on a free localhost
port, per-rank shared-memory windows), against the JAX package's references.

The JAX package's tests/test_multihost.py launches a 2-process
jax.distributed pod; here the same drivers run the port's pod
(parallel/multihost.py: ``ControlPlane``, ``RootControlEngine``,
``worker_loop``/``worker_serve``; parallel/window.py), every rank's ring step
across the processes through the windows and the ring step's plain
version. Each pod process blocks jax and the JAX package from importing.

- greedy tokens of a tp2 pod equal JAX's single-process engine and the
  port's single-process tp2 engine on the same files;
- a sampled, seeded request through the root's scheduler (plus a shared
  prefix pair and a cross-lane copy) equals the port's tp2 scheduler and
  JAX's tp2 mesh oracle;
- every op of the slice puts the same packet on the wire as the JAX
  package's ``ControlPlane`` and ``RootControlEngine`` for the same call;
- the worker's restart budget, persistent errors, stats reset and packet
  validation (scripted planes, no pod);
- a worker killed mid-stream ends the root (``--step-deadline``) with a
  nonzero exit within a bound;
- ``dllama_api`` root plus ``dllama worker`` answer like the one-process
  ``--workers 2 --device cpu`` server, and the root's SIGTERM stops the
  worker with exit 0 (the paged pod, its ops and ``--role``:
  tests/test_torch_pod_paged.py).

Every subprocess runs under a timeout.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time
import urllib.request

import numpy as np
import pytest

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

# the drivers are str.format templates: the blocker's braces doubled
POD_PREAMBLE = BLOCKER.replace("{", "{{").replace("}", "}}") + textwrap.dedent(
    """
    import json, os, sys
    sys.path.insert(0, {repo!r})
    mode, tmp, port = sys.argv[1], sys.argv[2], sys.argv[3]

    import numpy as np
    import torch
    from distributed_llama_multiusers_tpu_torch.formats import load_model_header
    from distributed_llama_multiusers_tpu_torch.models import load_params_from_m
    from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
    from distributed_llama_multiusers_tpu_torch.parallel.multihost import (
        ControlPlane, RootControlEngine, maybe_initialize_distributed, worker_loop,
        worker_serve,
    )
    from distributed_llama_multiusers_tpu_torch.parallel.sharding import shard_params
    from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine
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
    params = shard_params(params, mesh)
    engine = InferenceEngine(config, params, n_lanes=2, device="cpu", mesh=mesh)
    plane = ControlPlane(2, chunk=64)
    assert len(engine.params) == 1 and list(mesh.local_ranks) == [pid]
    """
)

DRIVER = POD_PREAMBLE + textwrap.dedent(
    """
    if mode == "root":
        eng = RootControlEngine(engine, plane)
        t = Tokenizer(os.path.join(tmp, "t.t"))
        ids = t.encode("hello world")
        _, greedy, pos = eng.prefill(0, ids)
        out = [greedy]
        cur = greedy
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
    assert not any(m == "jax" or m.startswith(("jax.", "distributed_llama_multiusers_tpu."))
                   for m in sys.modules)
    print(f"{{mode}} done", flush=True)
    """
)

SCHED_DRIVER = POD_PREAMBLE + textwrap.dedent(
    """
    from distributed_llama_multiusers_tpu_torch.runtime.scheduler import (
        ContinuousBatchingScheduler, Request,
    )

    if mode == "root":
        eng = RootControlEngine(engine, plane)
        t = Tokenizer(os.path.join(tmp, "t.t"))
        try:
            # stop_workers runs even when an assert fails, or the worker
            # waits for a packet until its timeout
            sched = ContinuousBatchingScheduler(eng, t)
            sched.start()
            try:
                req = Request(prompt="hello world", max_tokens=6, temperature=0.7, seed=1234)
                sched.submit(req)
                req.future.result(timeout=120)
                assert req.error is None, req.error
                shared = "hello world hello world hello world hello wor "
                outs = []
                for tail in ("one", "two"):
                    r = Request(prompt=shared + tail, max_tokens=4, temperature=0.0)
                    sched.submit(r)
                    r.future.result(timeout=120)
                    assert r.error is None, r.error
                    outs.append(r.generated_tokens)
            finally:
                sched.stop()
            # a cross-lane prefix copy rides OP_COPY_LANE
            ids = t.encode("hello world hello world")
            _, g, pos = eng.prefill(0, ids)
            eng.copy_lane(0, 1)
            cur = int(g)
            copied = [cur]
            tvec = np.zeros(2, np.int32)
            pvec = np.zeros(2, np.int32)
            for _ in range(4):
                tvec[1] = cur
                pvec[1] = pos
                _, gg, _ = eng.decode(tvec, pvec)
                pos += 1
                cur = int(gg[1])
                copied.append(cur)
            out = {{"sampled": req.generated_tokens, "prefix": outs, "copy": copied}}
        finally:
            eng.stop_workers()
        with open(os.path.join(tmp, "root_sched_tokens.json"), "w") as f:
            json.dump(out, f)
    else:
        worker_serve(engine, plane, max_restarts=0)
    print(f"{{mode}} done", flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH", "DLLAMA_COORDINATOR",
                        "DLLAMA_NUM_PROCESSES", "DLLAMA_PROCESS_ID")}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"  # the processes share the host's cores
    return env


def _run_pod(tmp: str, driver_src: str, timeout: float = POD_TIMEOUT) -> None:
    """Write the driver, launch root and worker against a free coordinator
    port, and assert both exit 0."""
    driver = os.path.join(tmp, "driver.py")
    with open(driver, "w") as f:
        f.write(driver_src.format(repo=REPO))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, driver, mode, tmp, str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=_env())
             for mode in ("root", "worker")]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"pod process failed:\n{out[-3000:]}"


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from distributed_llama_multiusers_tpu.formats.synthetic import (
        tiny_header,
        write_synthetic_model,
        write_synthetic_tokenizer,
    )

    tmp = str(tmp_path_factory.mktemp("pod_model"))
    header = tiny_header()
    write_synthetic_model(os.path.join(tmp, "m.m"), header, seed=7)
    write_synthetic_tokenizer(os.path.join(tmp, "t.t"), vocab_size=header.vocab_size)
    return tmp


def _copy_model(src: str, dst: str) -> str:
    import shutil

    for name in ("m.m", "t.t"):
        shutil.copy(os.path.join(src, name), os.path.join(dst, name))
    return dst


def _port_engine(tmp: str, tp: int):
    import torch

    from distributed_llama_multiusers_tpu_torch.formats import load_model_header
    from distributed_llama_multiusers_tpu_torch.models import load_params_from_m
    from distributed_llama_multiusers_tpu_torch.parallel import MeshPlan, make_mesh
    from distributed_llama_multiusers_tpu_torch.parallel.sharding import shard_params
    from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine

    h = load_model_header(os.path.join(tmp, "m.m"))
    config, params = load_params_from_m(os.path.join(tmp, "m.m"), h, dtype=torch.float32,
                                        device="cpu")
    mesh = None
    if tp > 1:
        mesh = make_mesh(MeshPlan(tp=tp), ["cpu"] * tp)
        params = shard_params(params, mesh)
    return InferenceEngine(config, params, n_lanes=2, device="cpu", mesh=mesh)


def _greedy(engine, tokenizer) -> list:
    ids = tokenizer.encode("hello world")
    _, greedy, pos = engine.prefill(0, ids)
    want = [int(greedy)]
    cur = greedy
    toks = np.zeros(2, np.int32)
    poss = np.zeros(2, np.int32)
    for _ in range(5):
        toks[0] = cur
        poss[0] = pos
        _, g, _ = engine.decode(toks, poss)
        pos += 1
        cur = int(g[0])
        want.append(cur)
    return want


def test_two_process_pod_matches_single_process(model_dir, tmp_path):
    """(1) The pod's greedy tokens equal JAX's single-process engine's and
    the port's single-process tp2 engine's on the same files, every ring
    step of the pod through the windows."""
    import jax.numpy as jnp

    from distributed_llama_multiusers_tpu.formats.model_file import load_model_header
    from distributed_llama_multiusers_tpu.models.loader import load_params_from_m
    from distributed_llama_multiusers_tpu.runtime import InferenceEngine
    from distributed_llama_multiusers_tpu.tokenizer import Tokenizer
    from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer as PortTokenizer

    tmp = _copy_model(model_dir, str(tmp_path))
    _run_pod(tmp, DRIVER)
    with open(os.path.join(tmp, "root_tokens.json")) as f:
        got = json.load(f)
    pod_tokens = got["tokens"]
    assert len(pod_tokens) == 6
    # one prefill (2 layers x (2 syncs x 2 steps) + the logits gather) and
    # five decode steps, each ring step staged and pulled once a process
    assert got["pod"]["pod_ring_steps"] == 6 * (2 * 2 * 2 + 1)
    assert got["pod"]["pod_ring_stages"] == got["pod"]["pod_ring_pulls"] == 6 * 9
    assert got["pod"]["pod_packets"] == 7  # prefill, 5 decodes, stop

    h = load_model_header(os.path.join(tmp, "m.m"))
    config, params = load_params_from_m(os.path.join(tmp, "m.m"), h, dtype=jnp.float32)
    want = _greedy(InferenceEngine(config, params, n_lanes=2), Tokenizer(os.path.join(tmp, "t.t")))
    assert pod_tokens == want
    port_tp2 = _greedy(_port_engine(tmp, 2), PortTokenizer(os.path.join(tmp, "t.t")))
    assert pod_tokens == port_tp2


def _sched_run(engine, tokenizer, scheduler_cls, request_cls) -> dict:
    sched = scheduler_cls(engine, tokenizer)
    sched.start()
    try:
        req = request_cls(prompt="hello world", max_tokens=6, temperature=0.7, seed=1234)
        sched.submit(req)
        req.future.result(timeout=300)
        assert req.error is None, req.error
        shared = "hello world hello world hello world hello wor "
        outs = []
        for tail in ("one", "two"):
            r = request_cls(prompt=shared + tail, max_tokens=4, temperature=0.0)
            sched.submit(r)
            r.future.result(timeout=300)
            assert r.error is None, r.error
            outs.append(list(r.generated_tokens))
    finally:
        sched.stop()
    ids = tokenizer.encode("hello world hello world")
    _, g, pos = engine.prefill(0, ids)
    engine.copy_lane(0, 1)
    cur = int(g)
    copied = [cur]
    tvec = np.zeros(2, np.int32)
    pvec = np.zeros(2, np.int32)
    for _ in range(4):
        tvec[1] = cur
        pvec[1] = pos
        _, gg, _ = engine.decode(tvec, pvec)
        pos += 1
        cur = int(gg[1])
        copied.append(cur)
    return {"sampled": list(req.generated_tokens), "prefix": outs, "copy": copied}


def test_two_process_pod_scheduler_sampled_matches_mesh(model_dir, tmp_path):
    """(2) The serving path on a pod: the root's scheduler drives a
    ``RootControlEngine`` with a sampled, seeded request (its packets carry
    the sampling scalars as bits), two greedy requests sharing a prefix and
    a cross-lane copy; the streams equal the port's one-process tp2
    scheduler's and the JAX package's tp2 mesh oracle's."""
    import jax.numpy as jnp

    from distributed_llama_multiusers_tpu.formats.model_file import load_model_header
    from distributed_llama_multiusers_tpu.models.loader import load_params_from_m
    from distributed_llama_multiusers_tpu.parallel import MeshPlan, make_mesh
    from distributed_llama_multiusers_tpu.parallel.sharding import shard_params
    from distributed_llama_multiusers_tpu.runtime import InferenceEngine
    from distributed_llama_multiusers_tpu.runtime.scheduler import (
        ContinuousBatchingScheduler,
        Request,
    )
    from distributed_llama_multiusers_tpu.tokenizer import Tokenizer
    from distributed_llama_multiusers_tpu_torch.runtime.scheduler import (
        ContinuousBatchingScheduler as PortScheduler,
    )
    from distributed_llama_multiusers_tpu_torch.runtime.scheduler import Request as PortRequest
    from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer as PortTokenizer

    tmp = _copy_model(model_dir, str(tmp_path))
    _run_pod(tmp, SCHED_DRIVER)
    with open(os.path.join(tmp, "root_sched_tokens.json")) as f:
        pod = json.load(f)
    assert len(pod["sampled"]) == 6

    h = load_model_header(os.path.join(tmp, "m.m"))
    config, params = load_params_from_m(os.path.join(tmp, "m.m"), h, dtype=jnp.float32)
    mesh = make_mesh(MeshPlan(tp=2))
    engine = InferenceEngine(config, shard_params(params, mesh), n_lanes=2, mesh=mesh,
                             replicate_outputs=True)
    jax_ref = _sched_run(engine, Tokenizer(os.path.join(tmp, "t.t")),
                         ContinuousBatchingScheduler, Request)
    port_ref = _sched_run(_port_engine(tmp, 2), PortTokenizer(os.path.join(tmp, "t.t")),
                          PortScheduler, PortRequest)
    assert pod == port_ref
    assert pod == jax_ref


# ---------------------------------------------------------------------------
# (3) packets, byte for byte against the JAX package's control plane
# ---------------------------------------------------------------------------

N_LANES = 3
K = 3  # SPEC_DRAFT
CHUNK = 16


class _StubEngine:
    """What the root proxies read of an engine: lanes, depth, bucket, the
    pre-broadcast checks and the default grammar vector (both engines'
    rule); the calls themselves do nothing."""

    n_lanes = N_LANES
    pipeline_depth = 2
    kvpool = None
    SPEC_DRAFT = K

    def max_chunk(self):
        return CHUNK

    def _g_vec(self, g_states, reseed):
        if g_states is not None:
            return g_states
        return np.zeros(N_LANES, np.int32) if reseed else np.full(N_LANES, -1, np.int32)

    def __getattr__(self, name):
        return lambda *a, **k: None


def _ints(*vals):
    return np.asarray(vals, np.int32)


_TOK, _POS = _ints(5, 7, 9), _ints(3, 4, 60)
_TEMPS, _TOPPS = np.asarray([0.0, 0.7, 1.3], np.float32), np.asarray([0.9, 0.5, 1.0], np.float32)
_SEEDS = np.asarray([0, 1234, 0xFFFFFFFF], np.uint32)
_GS = _ints(0, 4, -1)
_DRAFTS = np.arange(N_LANES * K, dtype=np.int32).reshape(N_LANES, K)
_DRAFTS1 = np.arange(N_LANES * (K + 1), dtype=np.int32).reshape(N_LANES, K + 1)
_DLEN = _ints(0, 2, 3)
_RF = {"type": "json_schema", "json_schema": {"schema": {
    "type": "object", "properties": {"zeta": {"type": "boolean"}, "alpha": {"enum": ["a", "b"]}},
    "required": ["zeta"]}}}

# (name, ControlPlane method, args, kwargs): every encoder of the slice
PLANE_CALLS = [
    ("stop", "send_stop", (), {}),
    ("stats_reset", "send_stats_reset", (), {}),
    ("pipeline_flush", "send_pipeline_flush", (), {}),
    ("copy_lane", "send_copy_lane", (2, 0), {}),
    ("prefill", "send_prefill", (1, list(range(40)), 7), {"temp": 0.8, "topp": 0.95,
                                                          "seed": 99, "g_state": 3}),
    ("prefill_defaults", "send_prefill", (0, [1, 2, 3], 0), {}),
    ("decode", "send_decode", (_TOK, _POS, _TEMPS, _TOPPS, _SEEDS), {"g_states": _GS}),
    ("decode_no_logits", "send_decode", (_TOK, _POS), {"want_logits": False}),
    ("decode_spec", "send_decode_spec", (_TOK, _DRAFTS, _DLEN, _POS, _TEMPS, _TOPPS, _SEEDS),
     {"g_states": _GS}),
    ("decode_multi", "send_decode_multi", (_TOK, _POS, _TEMPS, _TOPPS, _SEEDS, 8),
     {"g_states": _GS}),
    ("decode_pipelined_reseed", "send_decode_pipelined",
     (_TOK, _POS, _TEMPS, _TOPPS, _SEEDS, 2), {"g_states": _GS}),
    ("decode_pipelined_chained", "send_decode_pipelined",
     (None, _ints(-1, -1, 64), _TEMPS, _TOPPS, _SEEDS, 2), {}),
    ("decode_prefill_fused", "send_decode_prefill_fused",
     (None, _POS, _TEMPS, _TOPPS, _SEEDS, 2),
     {"p_lane": 1, "chunk": list(range(11)), "p_start": 5, "p_temp": 0.6, "p_topp": 0.8,
      "p_seed": 77, "g_states": _GS, "p_g": 2}),
    ("decode_spec_pipelined", "send_decode_spec_pipelined",
     (_TOK, _POS, _TEMPS, _TOPPS, _SEEDS, 2, _DRAFTS1, _DLEN), {"g_states": _GS}),
    ("decode_spec_prefill_fused", "send_decode_spec_prefill_fused",
     (None, _POS, _TEMPS, _TOPPS, _SEEDS, 2, _DRAFTS1, _DLEN),
     {"p_lane": 2, "chunk": [3, 1, 4], "p_start": 9, "p_temp": 0.0, "p_topp": 0.9,
      "p_seed": 5, "g_states": _GS, "p_g": 1}),
    ("grammar_attach", "send_grammar", (json.dumps(_RF).encode(),), {}),
    ("grammar_long", "send_grammar", (b"x" * (CHUNK * 4 * 2 + 5),), {}),
    ("grammar_detach", "send_grammar", (b"schema-key",), {"detach": True}),
]

# (name, RootControlEngine method, args, kwargs): every proxied call of the
# slice, defaults and normalization included
ROOT_CALLS = [
    ("prefill", "prefill", (1, list(range(40))), {"start_pos": 3, "temp": 0.5, "seed": 8}),
    ("prefill_chunk", "prefill_chunk", (0, list(range(9)), 4), {"temp": 0.2, "g_state": 2}),
    ("decode", "decode", (_TOK, _POS), {"temps": _TEMPS, "seeds": _SEEDS}),
    ("decode_defaults", "decode", (_TOK, _POS), {"want_logits": False}),
    ("decode_spec", "decode_spec", (_TOK, _DRAFTS, _DLEN, _POS), {"g_states": _GS}),
    ("decode_multi", "decode_multi", (_TOK, _POS), {"h": 4}),
    ("decode_pipelined", "decode_pipelined", (_POS,), {"tokens": _TOK, "temps": _TEMPS}),
    ("decode_pipelined_chained", "decode_pipelined", (_ints(-1, -1, -1),), {}),
    ("decode_prefill_fused", "decode_prefill_fused", (_POS,),
     {"p_lane": 2, "chunk": [9, 8, 7], "p_start": 1, "tokens": _TOK}),
    ("decode_spec_pipelined", "decode_spec_pipelined", (_POS, _DRAFTS1, _DLEN),
     {"seeds": _SEEDS}),
    ("decode_spec_prefill_fused", "decode_spec_prefill_fused", (_POS, _DRAFTS1, _DLEN),
     {"p_lane": 0, "chunk": list(range(16)), "p_temp": 0.9, "p_seed": 3}),
    ("pipeline_flush", "pipeline_flush", (), {}),
    ("pipeline_abort", "pipeline_abort", (), {}),
    ("copy_lane", "copy_lane", (0, 2), {}),
    ("grammar_attach", "grammar_attach", (_RF,), {}),
    ("grammar_detach", "grammar_detach", ("k",), {}),
    ("stats_reset", "reset_worker_stats", (), {}),
    ("stop", "stop_workers", (), {}),
]


def _capture(plane) -> list:
    sent = []
    plane._bcast = lambda pkt: sent.append(np.array(pkt, copy=True)) or pkt
    return sent


def test_control_plane_layout_is_the_jax_packages():
    """The protocol's constants and the slot sizing are the JAX package's."""
    from distributed_llama_multiusers_tpu.parallel import multihost as J
    from distributed_llama_multiusers_tpu_torch.parallel import multihost as P

    names = [n for n in dir(J) if n.startswith("OP_")] + ["PACKET_MAGIC", "PROTOCOL_VERSION"]
    assert {n: getattr(P, n) for n in names} == {n: getattr(J, n) for n in names}
    for lanes, chunk in ((2, 64), (8, 1024), (300, 16)):
        jp, pp = J.ControlPlane(lanes, chunk=chunk), P.ControlPlane(lanes, chunk=chunk)
        assert (pp.HEADER, pp.SLOTS, pp.chunk, pp._size) == (jp.HEADER, jp.SLOTS, jp.chunk,
                                                             jp._size)


@pytest.mark.parametrize("name,method,args,kwargs", PLANE_CALLS, ids=[c[0] for c in PLANE_CALLS])
def test_plane_packets_match_jax(name, method, args, kwargs):
    """(3) Each encoder's packets equal the JAX package's, word for word."""
    from distributed_llama_multiusers_tpu.parallel import multihost as J
    from distributed_llama_multiusers_tpu_torch.parallel import multihost as P

    jp, pp = J.ControlPlane(N_LANES, chunk=CHUNK), P.ControlPlane(N_LANES, chunk=CHUNK)
    got, want = _capture(pp), _capture(jp)
    getattr(pp, method)(*args, **kwargs)
    getattr(jp, method)(*args, **kwargs)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("name,method,args,kwargs", ROOT_CALLS, ids=[c[0] for c in ROOT_CALLS])
def test_root_proxy_packets_match_jax(name, method, args, kwargs):
    """(3) Each proxied call of the slice (its defaults, sampling
    normalization and validation before the broadcast) puts the JAX
    package's packets on the wire."""
    from distributed_llama_multiusers_tpu.parallel import multihost as J
    from distributed_llama_multiusers_tpu_torch.parallel import multihost as P

    jp, pp = J.ControlPlane(N_LANES, chunk=CHUNK), P.ControlPlane(N_LANES, chunk=CHUNK)
    got, want = _capture(pp), _capture(jp)
    getattr(P.RootControlEngine(_StubEngine(), pp), method)(*args, **kwargs)
    getattr(J.RootControlEngine(_StubEngine(), jp), method)(*args, **kwargs)
    assert len(got) == len(want) >= 1
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]


def test_root_proxy_refuses_before_any_packet():
    """The pod-deadlock rule: a call the engine would refuse dies with no
    packet out (a ragged lane vector, an oversized or empty chunk, a copy
    outside the lanes, a paged call on a contiguous engine, an empty
    prompt)."""
    from distributed_llama_multiusers_tpu_torch.parallel import multihost as P

    pp = P.ControlPlane(N_LANES, chunk=CHUNK)
    sent = _capture(pp)
    root = P.RootControlEngine(_StubEngine(), pp)
    with pytest.raises(ValueError):
        root.decode(_TOK[:2], _POS)
    with pytest.raises(ValueError):
        root.prefill_chunk(0, list(range(CHUNK + 1)), 0)
    with pytest.raises(ValueError):
        root.decode_prefill_fused(_POS, chunk=[], tokens=_TOK)
    with pytest.raises(ValueError):
        root.copy_lane(0, N_LANES)
    with pytest.raises(ValueError):
        root.prefill(0, [])
    with pytest.raises(ValueError):
        root.decode_multi(_TOK, _POS, h=0)
    with pytest.raises(RuntimeError, match="needs a paged engine"):
        root.paged_admit(0, [1, 2], 4)
    assert root.measured_sync_stats() == {}
    assert sent == []


# ---------------------------------------------------------------------------
# (4) scripted planes: the worker's restart policy (JAX tests/test_multihost.py)
# ---------------------------------------------------------------------------


class _ScriptedPlane:
    """Serves a scripted packet list through the real validation gate."""

    HEADER = 6

    def __init__(self, ops, chunk=8, bad=None):
        from distributed_llama_multiusers_tpu_torch.parallel.multihost import (
            PACKET_MAGIC,
            PROTOCOL_VERSION,
        )

        self.chunk = chunk
        self._pkts = []
        for i, op in enumerate(ops):
            pkt = np.zeros(self.HEADER + 10 * chunk, np.int32)
            pkt[0:6] = (PACKET_MAGIC, PROTOCOL_VERSION, op, 0, 2, 0)
            if bad is not None and i in bad:
                pkt[bad[i][0]] = bad[i][1]
            self._pkts.append(pkt)

    def recv(self):
        from distributed_llama_multiusers_tpu_torch.parallel.multihost import ControlPlane

        pkt = self._pkts.pop(0)
        ControlPlane.validate(pkt)
        return pkt

    def slot(self, pkt, i, n):
        start = self.HEADER + i * self.chunk
        return pkt[start:start + n]


class _ScriptedEngine:
    """decode() raises on the scripted call indices (1-based)."""

    SPEC_DRAFT = K

    def __init__(self, fail_on=()):
        from distributed_llama_multiusers_tpu_torch.runtime.engine import EngineStats

        self.calls = 0
        self.fail_on = set(fail_on)
        self.stats = EngineStats()

    def decode(self, *a, want_logits=True, g_states=None):
        self.calls += 1
        if self.calls in self.fail_on:
            raise RuntimeError(f"transient #{self.calls}")


def test_worker_serve_budget_refreshes_after_healthy_window():
    """Three transient errors spread over a long replay stream survive a
    max_restarts=2 budget because healthy_window replays refresh it."""
    from distributed_llama_multiusers_tpu_torch.parallel.multihost import (
        OP_DECODE,
        OP_STOP,
        worker_serve,
    )

    engine = _ScriptedEngine({4, 8, 12})
    worker_serve(engine, _ScriptedPlane([OP_DECODE] * 13 + [OP_STOP]), max_restarts=2,
                 healthy_window=3, log=lambda m: None)
    assert engine.calls == 13
    assert engine.stats.worker_restarts == 3


def test_worker_serve_persistent_error_still_raises():
    """Every replay failing (the desync signature) exhausts the budget
    within one window and raises."""
    from distributed_llama_multiusers_tpu_torch.parallel.multihost import (
        OP_DECODE,
        worker_serve,
    )

    engine = _ScriptedEngine(fail_on=set(range(1, 100)))
    with pytest.raises(RuntimeError, match="transient"):
        worker_serve(engine, _ScriptedPlane([OP_DECODE] * 20), max_restarts=2,
                     healthy_window=3, log=lambda m: None)
    assert engine.calls == 3


def test_ring_step_goes_through_the_one_installed_pod():
    """While a pod is installed every ring step is its ``step``; a second
    pod in the same process is refused, and taking the pod out returns the
    ring steps to the process's own ranks."""
    import torch

    from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc

    class Pod:
        def __init__(self):
            self.steps = []

        def step(self, recv):
            self.steps.append(recv)

    a, b = Pod(), Pod()
    xs = [torch.arange(4.0), torch.arange(4.0) + 10]
    rc.set_pod(a)
    try:
        rc.set_pod(a)  # the same pod again
        with pytest.raises(RuntimeError, match="already runs a pod"):
            rc.set_pod(b)
        rc.ring_shift(xs)
        assert len(a.steps) == 1 and len(a.steps[0]) == 2 and not b.steps
    finally:
        rc.set_pod(None)
    assert not rc.pod_installed()
    out = rc.ring_shift(xs)
    assert len(a.steps) == 1 and torch.equal(out[0], xs[1]) and torch.equal(out[1], xs[0])


def test_stats_reset_op_clears_worker_counters():
    """OP_STATS_RESET zeroes the worker's engine counters and its kernel
    counters (the root's warmup reset, replayed)."""
    from distributed_llama_multiusers_tpu_torch.ops import ring_collective as rc
    from distributed_llama_multiusers_tpu_torch.parallel.multihost import (
        OP_STATS_RESET,
        OP_STOP,
        worker_loop,
    )

    engine = _ScriptedEngine()
    engine.stats.decode_steps = 7
    engine.stats.spec_steps = 2
    rc.add_counts({"plain_calls": 5, "bytes": 40})
    worker_loop(engine, _ScriptedPlane([OP_STATS_RESET, OP_STOP]))
    assert engine.stats.decode_steps == 0 and engine.stats.spec_steps == 0
    assert rc.ring_counts()["ring_hop_plain_calls"] == 0


@pytest.mark.parametrize("word,value,what", [(0, 0x12345678, "magic"),
                                             (1, 5, "protocol version"),
                                             (2, 99, "unknown control op"),
                                             (2, 12, "OP_KV_TABLE")])
def test_bad_packet_is_a_replay_error_that_burns_no_restart(word, value, what):
    """A torn packet (bad magic), a version-skewed root, an unknown op and
    a paged op on a worker whose engine is contiguous (its flags skewed
    against the root's) are classified ``ReplayError``\\ s before any
    dispatch: the worker resubscribes without spending its restart budget
    (max_restarts=0 here) and replays on."""
    from distributed_llama_multiusers_tpu_torch.parallel.multihost import (
        OP_DECODE,
        OP_STOP,
        ReplayError,
        worker_serve,
    )

    engine = _ScriptedEngine()
    plane = _ScriptedPlane([OP_DECODE, OP_DECODE, OP_DECODE, OP_STOP], bad={1: (word, value)})
    said = []
    worker_serve(engine, plane, max_restarts=0, log=said.append)
    assert engine.calls == 2
    assert engine.stats.worker_replay_errors == 1 and engine.stats.worker_restarts == 0
    assert len(said) == 1 and "protocol error" in said[0] and what in said[0]
    assert ReplayError.__mro__[1] is RuntimeError


# ---------------------------------------------------------------------------
# (5)-(7) the entry points
# ---------------------------------------------------------------------------


def _entry(module: str, argv: list, log_path: str) -> subprocess.Popen:
    """``python -m <module> argv`` with jax and the JAX package blocked."""
    code = BLOCKER + f"sys.path.insert(0, {REPO!r})\nimport runpy\n" \
        f"sys.argv = [{module!r}] + {argv!r}\nrunpy.run_module({module!r}, run_name='__main__')\n"
    with open(log_path, "w") as logf:
        return subprocess.Popen([sys.executable, "-c", code], stdout=logf,
                                stderr=subprocess.STDOUT, env=_env(), cwd=REPO)


API = "distributed_llama_multiusers_tpu_torch.app.dllama_api"
CLI = "distributed_llama_multiusers_tpu_torch.app.dllama"


def _wait_healthy(base: str, proc, log_path: str, timeout: float = 120) -> None:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        assert proc.poll() is None, open(log_path).read()[-3000:]
        try:
            with urllib.request.urlopen(base + "/health", timeout=2) as r:
                if r.status == 200:
                    return
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"not healthy:\n{open(log_path).read()[-3000:]}")


def _post(base: str, body: dict, timeout: float = 120) -> dict:
    req = urllib.request.Request(base + "/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _pod(tmp: str, extra: list, log_dir: str, name: str):
    """A pod's root ``dllama_api`` and its ``dllama worker`` on the CPU."""
    coord = f"127.0.0.1:{_free_port()}"
    port = _free_port()
    common = ["--model", os.path.join(tmp, "m.m"), "--tokenizer", os.path.join(tmp, "t.t"),
              "--workers", "2", "--device", "cpu", "--coordinator", coord,
              "--num-processes", "2", *extra]
    root_log = os.path.join(log_dir, f"{name}_root.log")
    worker_log = os.path.join(log_dir, f"{name}_worker.log")
    worker = _entry(CLI, ["worker", *common, "--process-id", "1"], worker_log)
    root = _entry(API, [*common, "--process-id", "0", "--host", "127.0.0.1",
                        "--port", str(port)], root_log)
    return f"http://127.0.0.1:{port}", root, worker, root_log, worker_log


def _stop(*procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)


BODIES = [{"prompt": "hello world", "max_tokens": 12, "temperature": 0},
          {"prompt": "once upon", "max_tokens": 12, "temperature": 0.8, "seed": 7}]


def test_api_root_and_worker_match_one_process_server(model_dir, tmp_path):
    """(6) ``dllama_api`` as the pod's root beside ``dllama worker``
    answers a greedy and a seeded request byte for byte like the
    one-process ``--workers 2 --device cpu`` server; the root's SIGTERM
    drains, stops the worker, and both exit 0. The eager step the root
    timed at startup stands in ``/stats``, and the worker's ring-step
    counts at exit equal the root's: nothing outside the served requests
    reached either side's counters after the warmup's reset. Both pod
    processes run with jax and the JAX package blocked."""
    tmp = _copy_model(model_dir, str(tmp_path))
    single_log = os.path.join(tmp, "single.log")
    port = _free_port()
    single = _entry(API, ["--model", os.path.join(tmp, "m.m"), "--tokenizer",
                          os.path.join(tmp, "t.t"), "--workers", "2", "--device", "cpu",
                          "--host", "127.0.0.1", "--port", str(port)], single_log)
    base, root, worker, root_log, worker_log = _pod(tmp, [], tmp, "api")
    try:
        _wait_healthy(f"http://127.0.0.1:{port}", single, single_log)
        want = [_post(f"http://127.0.0.1:{port}", b)["choices"][0]["text"] for b in BODIES]
        _wait_healthy(base, root, root_log)
        got = [_post(base, b)["choices"][0]["text"] for b in BODIES]
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        root.send_signal(signal.SIGTERM)
        assert root.wait(timeout=90) == 0, open(root_log).read()[-3000:]
        assert worker.wait(timeout=60) == 0, open(worker_log).read()[-3000:]
    finally:
        _stop(single, root, worker)
    assert got == want
    assert stats["pod_step_ms"] > 0 and 0 <= stats["pod_step_wait_share"] <= 1
    exits = [ln for ln in open(worker_log) if ln.startswith('{"event": "worker_exit"')]
    assert len(exits) == 1
    worker_counts = json.loads(exits[0])
    for k in ("ring_hop_plain_calls", "ring_hop_bytes", "pod_ring_steps", "pod_ring_pulls"):
        assert worker_counts[k] == stats[k] > 0, k
    assert stats["mesh"]["tp"] == 2 and stats["mesh"]["processes"] == 2
    assert stats["ring_hop_plain_calls"] > 0 and stats["pod_ring_pulls"] > 0
    assert stats["pod_packets"] > 0 and stats["pod_broadcast_us"] is not None
    log = open(root_log).read()
    assert "Pod root: control plane up" in log
    assert "no CUDA graphs on a pod" in log and "Pod workers sent stop" in log
    wlog = open(worker_log).read()
    assert "Root sent stop; worker exiting" in wlog


def test_killed_worker_ends_the_root(model_dir, tmp_path):
    """(5) A worker SIGKILLed mid-stream: the root, served with
    ``--step-deadline``, exits nonzero within the deadline plus 30 s
    instead of waiting in a ring step forever."""
    tmp = _copy_model(model_dir, str(tmp_path))
    deadline = 2.0
    base, root, worker, root_log, worker_log = _pod(
        tmp, ["--step-deadline", str(deadline)], tmp, "kill")
    try:
        _wait_healthy(base, root, root_log)
        body = {"prompt": "hello", "max_tokens": 60, "temperature": 0, "stream": True}
        req = urllib.request.Request(base + "/v1/completions", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        deltas = 0
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                for line in r:
                    if line.startswith(b"data: {"):
                        deltas += 1
                    if deltas == 3:
                        worker.kill()
                        t_kill = time.monotonic()
                        worker.wait(timeout=30)
                        break
        except OSError:
            pass
        assert deltas == 3, open(root_log).read()[-3000:]
        rc = root.wait(timeout=deadline + 30)
        waited = time.monotonic() - t_kill
    finally:
        _stop(root, worker)
    assert rc != 0, open(root_log).read()[-3000:]
    assert waited < deadline + 30


def test_cli_inference_root_matches_one_process(model_dir, tmp_path):
    """``dllama inference`` is a pod root too: its greedy text beside a
    ``dllama worker`` equals the one-process ``--workers 2`` run's, and the
    worker exits 0 on the root's stop."""
    tmp = _copy_model(model_dir, str(tmp_path))
    args = ["inference", "--model", os.path.join(tmp, "m.m"), "--tokenizer",
            os.path.join(tmp, "t.t"), "--workers", "2", "--device", "cpu", "--prompt",
            "hello world", "--steps", "10", "--temperature", "0"]
    single_log = os.path.join(tmp, "single_cli.log")
    single = _entry(CLI, args, single_log)
    coord = ["--coordinator", f"127.0.0.1:{_free_port()}", "--num-processes", "2"]
    worker_log, root_log = os.path.join(tmp, "cli_worker.log"), os.path.join(tmp, "cli_root.log")
    worker = _entry(CLI, ["worker", *args[1:], *coord, "--process-id", "1"], worker_log)
    root = _entry(CLI, [*args, *coord, "--process-id", "0"], root_log)
    try:
        assert single.wait(timeout=POD_TIMEOUT) == 0, open(single_log).read()[-2000:]
        assert root.wait(timeout=POD_TIMEOUT) == 0, open(root_log).read()[-2000:]
        assert worker.wait(timeout=60) == 0, open(worker_log).read()[-2000:]
    finally:
        _stop(single, root, worker)

    def text(path):
        lines = open(path).read().splitlines()
        i = next(i for i, ln in enumerate(lines) if ln.startswith("🔷 Eval"))
        return lines[i + 1]

    assert text(root_log) == text(single_log)


@pytest.mark.parametrize("tp", [2, 4])
def test_window_collectives_match_one_process(tp):
    """The windows' protocol on the CPU (tools/pod_hop.py): two processes,
    each holding tp/2 ranks, run every ring collective of the path across
    the pod; each process's ranks get the one-process collective's bits,
    every cross-process step staged and pulled once."""
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", "pod_hop.py"), "--device",
                        "cpu", "--small", "--tp", str(tp), "--reps", "3", "--timeout", "120"],
                       capture_output=True, text=True, timeout=180, env=_env(), cwd=REPO)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rows = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert [row["ranks"] for row in rows] == [list(range(tp // 2)), list(range(tp // 2, tp))]
    for row in rows:
        assert all(row["checks"].values()) and not row["failed"], row
        assert row["counts"]["ring_hop_plain_calls"] > 0
