"""The port stands alone: every module of distributed_llama_multiusers_tpu_torch
and chip_smoke.py import in a process where ``jax``, ``jaxlib`` and the JAX
package cannot be imported, and its entry points refuse CUDA where there is
none instead of drifting to the CPU."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKER = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = ("jax", "jaxlib", "distributed_llama_multiusers_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    for mod in list(sys.modules):
        if any(mod == b or mod.startswith(b + ".") for b in BLOCKED):
            del sys.modules[mod]
    sys.path.insert(0, ROOT)
""")


def _run(body: str, *args, timeout=120):
    code = f"ROOT = {ROOT!r}\n" + BLOCKER + textwrap.dedent(body)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_blocker_blocks():
    r = _run("""
        try:
            import jax  # noqa: F401
        except ImportError:
            pass
        else:
            raise SystemExit("jax imported")
        try:
            import distributed_llama_multiusers_tpu.quants.codec  # noqa: F401
        except ImportError:
            print("blocked")
    """)
    assert r.returncode == 0, r.stderr
    assert "blocked" in r.stdout


def test_every_port_module_and_chip_smoke_import_without_jax():
    r = _run("""
        import importlib, pkgutil
        import distributed_llama_multiusers_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        assert "distributed_llama_multiusers_tpu_torch.parallel.ring_attention" in names
        for name in names:
            importlib.import_module(name)
        import chip_smoke  # noqa: F401
        leaked = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib"))
                        or m.split(".")[0] == "distributed_llama_multiusers_tpu")
        assert not leaked, leaked
        print(len(names))
    """)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= 30


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run("""
        import torch
        from distributed_llama_multiusers_tpu_torch.formats.synthetic import (
            tiny_header, write_synthetic_model, write_synthetic_tokenizer)
        from distributed_llama_multiusers_tpu_torch.formats import load_model_header
        from distributed_llama_multiusers_tpu_torch.models import (
            init_kv_cache, load_params_from_m, load_params_from_m_quantized,
            params_from_jax_numpy, params_from_random)
        from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine
        from distributed_llama_multiusers_tpu_torch.app import dllama_api
        d = sys.argv[1]
        h = tiny_header()
        write_synthetic_model(d + "/m.m", h)
        write_synthetic_tokenizer(d + "/t.t", vocab_size=h.vocab_size)
        header = load_model_header(d + "/m.m")
        config, params = load_params_from_m(d + "/m.m", header, dtype=torch.float32,
                                            device="cpu")
        # the library entry points default to the card: without one they
        # raise, naming CUDA and device="cpu", instead of landing on the CPU
        defaults = {
            "load_params_from_m": lambda: load_params_from_m(d + "/m.m", header),
            "load_params_from_m_quantized":
                lambda: load_params_from_m_quantized(d + "/m.m", header),
            "params_from_random": lambda: params_from_random(config, seed=0),
            "params_from_jax_numpy": lambda: params_from_jax_numpy(params),
            "init_kv_cache": lambda: init_kv_cache(config, 1),
        }
        for name, call in defaults.items():
            try:
                call()
            except RuntimeError as e:
                assert "CUDA" in str(e) and "device='cpu'" in str(e), (name, e)
            else:
                raise SystemExit(f"{name} with its default device did not raise")
        for kwargs in ({}, {"device": "cuda"}):
            try:
                InferenceEngine(config, params, **kwargs)
            except RuntimeError as e:
                assert "CUDA" in str(e), e
            else:
                raise SystemExit(f"InferenceEngine({kwargs}) did not raise")
        try:
            dllama_api.main(["--model", d + "/m.m", "--tokenizer", d + "/t.t", "--port", "0"])
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise SystemExit("dllama_api without --device cpu did not raise")
        print("raised")
    """, str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("raised")


def test_chip_smoke_fails_without_cuda_or_package(tmp_path):
    """No CUDA here: non-zero exit and no result line. A directory holding
    chip_smoke.py and nothing else of the repository fails the same way."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes(open(os.path.join(ROOT, "chip_smoke.py"), "rb").read())
    r = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_spec_module_is_the_ports_own():
    """The draft index the port's scheduler drafts with is its own copy
    (``runtime/spec.py``), importable and usable without jax or the JAX
    package, and the engine's and scheduler's ``pow2_floor`` is that one."""
    r = _run("""
        from distributed_llama_multiusers_tpu_torch.runtime import engine, scheduler, spec
        assert scheduler.NgramDraftIndex is spec.NgramDraftIndex
        assert engine.pow2_floor is spec.pow2_floor is scheduler.pow2_floor
        assert engine.InferenceEngine.SPEC_DRAFT == spec.SPEC_DRAFT == 3
        idx = spec.NgramDraftIndex([1, 2, 3, 1, 2])
        assert idx.draft(3, 3) == [1, 2, 3]
        leaked = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib"))
                        or m.split(".")[0] == "distributed_llama_multiusers_tpu")
        assert not leaked, leaked
        print(spec.__file__)
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith(os.path.join("distributed_llama_multiusers_tpu_torch",
                                                  "runtime", "spec.py"))


def test_serving_layers_are_the_ports_own():
    """The QoS queue, deadlines, drain, breaker, watchdog, fault plan,
    lock witness and telemetry the port's scheduler and server use are its
    own copies (``serving/``, ``utils/faults.py``, ``lockcheck.py``,
    ``telemetry/``), importable and working without jax or the JAX
    package; the server's ``Priority`` and the scheduler's
    ``AdmissionRejected`` are the QoS module's."""
    r = _run("""
        import os
        import distributed_llama_multiusers_tpu_torch as pkg
        from distributed_llama_multiusers_tpu_torch import lockcheck, serving, telemetry
        from distributed_llama_multiusers_tpu_torch.runtime import scheduler
        from distributed_llama_multiusers_tpu_torch.server import api_types, http
        from distributed_llama_multiusers_tpu_torch.serving import (
            breaker, deadlines, drain, qos, watchdog)
        from distributed_llama_multiusers_tpu_torch.telemetry import (
            hub, logs, metrics, spans, trace, tracectx)
        from distributed_llama_multiusers_tpu_torch.utils import faults
        root = os.path.dirname(pkg.__file__)
        mods = (lockcheck, serving, breaker, deadlines, drain, qos, watchdog, telemetry, hub,
                logs, metrics, spans, trace, tracectx, faults)
        for m in mods:
            assert m.__file__.startswith(root), m.__file__
        assert api_types.Priority is qos.Priority
        assert scheduler.AdmissionRejected is qos.AdmissionRejected
        assert http.AdmissionRejected is qos.AdmissionRejected
        q = qos.QosQueue(capacity=1)
        q.push(scheduler.Request(prompt="x"))
        try:
            q.push(scheduler.Request(prompt="y"))
        except qos.AdmissionRejected as e:
            assert e.http_status == 429
        else:
            raise SystemExit("no shed at capacity")
        b = breaker.CircuitBreaker(threshold=1)
        b.record_engine_failure("boom")
        assert b.state == "open" and not b.allow()
        plan = faults.FaultPlan.parse("engine.dispatch:@2+3")
        assert plan.schedule("engine.dispatch", 9) == [2, 5, 8]
        tel = telemetry.Telemetry()
        tel.bridge_stats({"decode_steps": 3, "breaker_state_code": 2})
        assert "dllama_stats_decode_steps 3" in tel.render_prometheus()
        ctx = telemetry.TraceContext.mint()
        assert telemetry.TraceContext.parse(ctx.to_header()) == ctx
        leaked = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib"))
                        or m.split(".")[0] == "distributed_llama_multiusers_tpu")
        assert not leaked, leaked
        print(len(mods))
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("15")


def test_durability_cli_and_witnesses_are_the_ports_own():
    """The request journal, recovery, resumable streams, the CLI, the seed
    source and the runtime witnesses are the port's own modules, working
    without jax or the JAX package: a journal written here reads back, a
    relay replays after a Last-Event-ID, and the witnesses count."""
    r = _run("""
        import os, tempfile
        import distributed_llama_multiusers_tpu_torch as pkg
        from distributed_llama_multiusers_tpu_torch import analysis, serving
        from distributed_llama_multiusers_tpu_torch.analysis import jitcheck, leakcheck
        from distributed_llama_multiusers_tpu_torch.app import dllama
        from distributed_llama_multiusers_tpu_torch.runtime import scheduler, spec
        from distributed_llama_multiusers_tpu_torch.serving import journal, recovery, resume
        from distributed_llama_multiusers_tpu_torch.utils import seeds
        root = os.path.dirname(pkg.__file__)
        mods = (analysis, jitcheck, leakcheck, dllama, journal, recovery, resume, seeds)
        for m in mods:
            assert m.__file__.startswith(root), m.__file__
        assert serving.RequestJournal is journal.RequestJournal
        assert serving.recover_scheduler is recovery.recover_scheduler
        assert spec.SpecStream.__module__ == spec.__name__
        assert scheduler.fresh_seed is seeds.fresh_seed and seeds.fresh_seed() != 0
        path = os.path.join(tempfile.mkdtemp(), "j.bin")
        j = journal.RequestJournal(path, fsync=False)
        j.record_admit(request_id=3, prompt="p", tokens=[1], max_tokens=2, temperature=0.0,
                       topp=0.9, seed=5, stop=[], add_bos=True, add_special_tokens=True,
                       user=None, priority=1, queue_timeout_s=None, budget_s=None,
                       stream=True, kind="chat")
        assert j.flush()
        j.close()
        assert [e.request_id for e in journal.read_journal(path).incomplete()] == [3]
        relay = resume.StreamRelay(3, capacity=4)
        relay.push(1, "a")
        relay.push(2, "b")
        assert relay.next_after(1, 0.1, relay.attach()) == ("delta", 2, "b")
        assert leakcheck.check_drained("probe", {"x": 0}) == 0
        jitcheck.arm(relay)
        assert jitcheck.note_capture(relay) and jitcheck.total_compiles() == 1
        leaked = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib"))
                        or m.split(".")[0] == "distributed_llama_multiusers_tpu")
        assert not leaked, leaked
        print(len(mods))
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("8")


def test_dllama_cli_raises_without_cuda(tmp_path):
    """``dllama inference`` and ``chat`` run on the card unless ``--device
    cpu``: without CUDA they raise, naming it; with ``--device cpu`` they
    run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run("""
        import io
        from distributed_llama_multiusers_tpu_torch.formats.synthetic import (
            tiny_header, write_synthetic_model, write_synthetic_tokenizer)
        from distributed_llama_multiusers_tpu_torch.app import dllama
        d = sys.argv[1]
        h = tiny_header()
        write_synthetic_model(d + "/m.m", h)
        write_synthetic_tokenizer(d + "/t.t", vocab_size=h.vocab_size)
        common = ["--model", d + "/m.m", "--tokenizer", d + "/t.t", "--steps", "2"]
        for mode in ("inference", "chat"):
            sys.stdin = io.StringIO("")
            try:
                dllama.main([mode, *common])
            except RuntimeError as e:
                assert "CUDA" in str(e), e
            else:
                raise SystemExit(f"dllama {mode} without --device cpu did not raise")
            dllama.main([mode, *common, "--device", "cpu"])
        print("raised")
    """, str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("raised")


def test_paged_kv_modules_are_the_ports_own():
    """The page pool, its host swap tier and the page integrity frame the
    port's engine uses are its own copies (``runtime/kvpool.py``,
    ``disagg/kvtransfer.py``), importable and working without jax or the
    JAX package, and the pool takes its lock from the port's lock
    witness."""
    r = _run("""
        import os
        import distributed_llama_multiusers_tpu_torch as pkg
        from distributed_llama_multiusers_tpu_torch import disagg, lockcheck
        from distributed_llama_multiusers_tpu_torch.disagg import kvtransfer
        from distributed_llama_multiusers_tpu_torch.models import llama
        from distributed_llama_multiusers_tpu_torch.parallel import sharding
        from distributed_llama_multiusers_tpu_torch.runtime import engine, kvpool, scheduler
        root = os.path.dirname(pkg.__file__)
        for m in (disagg, kvtransfer, kvpool):
            assert m.__file__.startswith(root), m.__file__
        assert kvpool.page_hash is kvtransfer.page_hash is disagg.page_hash
        assert kvpool.make_lock is lockcheck.make_lock
        assert engine.KVPagePool is kvpool.KVPagePool
        assert scheduler.PoolExhausted is kvpool.PoolExhausted
        assert sharding.PagedKVCache is llama.PagedKVCache
        pool = kvpool.KVPagePool.for_seq_len(64, 2, page_size=16, host_bytes=1 << 10)
        start, blocks, copies, swapins = pool.admit(0, list(range(20)), 24)
        assert (start, len(blocks), copies, swapins) == (0, 2, [], [])
        pool.commit(0, list(range(20)))
        pool.finish(0)
        assert pool.admit(1, list(range(20)), 24, min_share_tokens=4)[0] == 16
        leaked = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib"))
                        or m.split(".")[0] == "distributed_llama_multiusers_tpu")
        assert not leaked, leaked
        print("own")
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("own")


def test_grammar_modules_are_the_ports_own():
    """Structured output's modules (``grammar/``, ``ops/cuda_grammar.py``,
    ``utils/testing.py``) are the port's own copies and work without jax
    or the JAX package: an automaton compiles, installs in a slab, and the
    two kernels' plain versions mask and step it; the engine's slab and
    the scheduler's ``GrammarSlabFull`` are these."""
    r = _run("""
        import os
        import torch
        import distributed_llama_multiusers_tpu_torch as pkg
        from distributed_llama_multiusers_tpu_torch import grammar
        from distributed_llama_multiusers_tpu_torch.grammar import automaton, slab
        from distributed_llama_multiusers_tpu_torch.ops import cuda_grammar
        from distributed_llama_multiusers_tpu_torch.runtime import engine
        from distributed_llama_multiusers_tpu_torch.utils import testing
        root = os.path.dirname(pkg.__file__)
        for m in (grammar, automaton, slab, cuda_grammar, testing):
            assert m.__file__.startswith(root), m.__file__
        assert engine.GrammarSlab is slab.GrammarSlab
        tok = testing.ByteJsonTokenizer()
        auto = grammar.compile_automaton({"type": "json_object"}, tok.token_table(),
                                         tok.eos_token_ids)
        s = grammar.GrammarSlab(258)
        h = s.attach(auto)
        masks, keys, nxt, dflt = (torch.from_numpy(a.view("int32") if i == 0 else a)
                                  for i, a in enumerate(s.arrays()))
        rows = torch.zeros((2, 258))
        rows[:, 1 + ord("x")] = 1.0  # a bare 'x' is not a JSON object's start
        states = torch.tensor([0, h.start_state])
        idx = cuda_grammar.mask_argmax(rows, states, masks)
        assert idx[0] == 1 + ord("x") and idx[1] != 1 + ord("x")
        assert h.is_legal(h.start_state, int(idx[1]))
        nxt_state = cuda_grammar.grammar_next(states, idx[:, None], keys, nxt, dflt, 258)
        assert int(nxt_state[0]) == 0
        assert int(nxt_state[1]) == h.next_state(h.start_state, int(idx[1]))
        leaked = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib"))
                        or m.split(".")[0] == "distributed_llama_multiusers_tpu")
        assert not leaked, leaked
        print("ok")
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")
