"""The port's runtime witnesses (``analysis/leakcheck.py``,
``analysis/jitcheck.py``) on the CPU: the JAX package's
``tests/test_leakcheck.py`` and ``tests/test_jitcheck.py`` cases that need
no XLA, ported.

``leakcheck`` is the JAX module's copy: the same calls give the same
counters and the same ``/stats`` surface as the JAX package's (held
side by side). The scheduler's ``stop()`` and the stream registry's
``close()`` drain clean after real serving on the tiny model, with a
journal, mid-flight stops included, and a deliberately leaked registry
entry raises under the witness.

``jitcheck`` witnesses CUDA-graph captures after warmup where the JAX
module listens to XLA compiles; the graph owner here is a stand-in (the
CPU captures no graph), the capture on the card is in
``tests/test_torch_gpu.py``.
"""

import gc
import os
import subprocess
import sys
import time

import pytest
import torch

from distributed_llama_multiusers_tpu.analysis import leakcheck as j_leakcheck
from distributed_llama_multiusers_tpu_torch.analysis import jitcheck, leakcheck
from distributed_llama_multiusers_tpu_torch.analysis.jitcheck import RecompileAfterWarmup
from distributed_llama_multiusers_tpu_torch.analysis.leakcheck import ResourceLeak
from distributed_llama_multiusers_tpu_torch.formats import load_model_header
from distributed_llama_multiusers_tpu_torch.models import load_params_from_m_quantized
from distributed_llama_multiusers_tpu_torch.runtime import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
)
from distributed_llama_multiusers_tpu_torch.serving import RequestJournal, StreamRegistry
from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def witness_on():
    leakcheck.force(True, fresh=True)
    try:
        yield
    finally:
        leakcheck.force(None, fresh=True)


@pytest.fixture
def witness_off():
    leakcheck.force(False, fresh=True)
    try:
        yield
    finally:
        leakcheck.force(None, fresh=True)


# -- leakcheck wiring ---------------------------------------------------------


def test_resource_leak_is_assertion_error():
    assert issubclass(ResourceLeak, AssertionError)
    assert issubclass(RecompileAfterWarmup, AssertionError)


def test_counting_mode_counts_without_raising(witness_off):
    assert leakcheck.check_drained("t", {"kv_pages": 3, "marks": 0}) == 3
    assert leakcheck.leaks_total() == 3
    assert leakcheck.live_counts() == {"kv_pages": 3, "marks": 0}
    assert leakcheck.last_leak() == {"where": "t", "leaked": {"kv_pages": 3}}
    assert leakcheck.check_drained("t", {"kv_pages": 0}) == 0
    assert leakcheck.leaks_total() == 3
    assert leakcheck.live_counts()["kv_pages"] == 0


def test_strict_mode_raises_and_counts(witness_on):
    with pytest.raises(ResourceLeak, match="kv_pages"):
        leakcheck.check_drained("stop", {"kv_pages": 2})
    assert leakcheck.leaks_total() == 2


def test_clean_drain_never_raises(witness_on):
    assert leakcheck.check_drained("stop", {"kv_pages": 0}) == 0
    assert leakcheck.leaks_total() == 0


def test_force_fresh_resets_counters(witness_off):
    leakcheck.check_drained("t", {"x": 5})
    leakcheck.force(False, fresh=True)
    assert leakcheck.leaks_total() == 0
    assert leakcheck.live_counts() == {}
    assert leakcheck.last_leak() is None


def test_stats_surface_equals_jax(witness_off):
    """The same drain points give the JAX module's counters and surface."""
    j_leakcheck.force(False, fresh=True)
    try:
        for where, counts in (("a", {"x": 1}), ("b", {"x": 0, "y": 2}), ("c", {"y": 0})):
            assert leakcheck.check_drained(where, counts) == \
                j_leakcheck.check_drained(where, counts)
        assert leakcheck.stats() == j_leakcheck.stats()
        assert leakcheck.last_leak() == j_leakcheck.last_leak()
    finally:
        j_leakcheck.force(None, fresh=True)
    assert leakcheck.stats() == {"resource_leaks_total": 3, "resource_drain_checks": 3,
                                 "resources_live": {"x": 0, "y": 0}}


def test_env_flag_enables_both_witnesses():
    code = ("from distributed_llama_multiusers_tpu_torch.analysis import jitcheck, leakcheck\n"
            "print(leakcheck.enabled(), jitcheck.enabled())")
    out = []
    for value in ("1", "0"):
        env = dict(os.environ, DLLAMA_LEAKCHECK=value, DLLAMA_JITCHECK=value,
                   PYTHONPATH=ROOT)
        r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                           text=True, timeout=120, cwd=ROOT)
        assert r.returncode == 0, r.stderr
        out.append(r.stdout.split())
    assert out == [["True", "True"], ["False", "False"]]


# -- the serving pin: the scheduler drains clean ------------------------------


@pytest.fixture(scope="module")
def loaded(tiny_model):
    path = tiny_model["model"]
    config, params = load_params_from_m_quantized(path, load_model_header(path),
                                                  dtype=torch.float32, device="cpu")
    return config, params, Tokenizer(tiny_model["tokenizer"])


def _sched(loaded, **kw):
    config, params, tok = loaded
    engine = InferenceEngine(config, params, n_lanes=2, prefill_buckets=(16, 32),
                             device="cpu")
    sched = ContinuousBatchingScheduler(engine, tok, **kw)
    sched.start()
    return sched


@pytest.mark.parametrize("journaled", [False, True])
def test_scheduler_stop_drains_clean(loaded, witness_on, tmp_path, journaled):
    """A churn of greedy and sampled requests, then stop(): no session
    record and (with a journal) no journal mark outlives the loop."""
    journal = RequestJournal(str(tmp_path / "j.bin"), fsync=False) if journaled else None
    sched = _sched(loaded, journal=journal)
    reqs = [Request(prompt=f"drain pin {i}", max_tokens=8, temperature=0.0 if i % 2 else 0.8)
            for i in range(4)]
    try:
        for r in reqs:
            sched.submit(r)
        for r in reqs:
            r.future.result(timeout=60)
    finally:
        sched.stop()  # raises ResourceLeak if anything is still held
        if journal is not None:
            journal.close()
    assert all(r.error is None for r in reqs)
    counts = sched.leak_counts()
    assert set(counts) == ({"session_records", "journal_marks"} if journaled
                           else {"session_records"})
    assert all(v == 0 for v in counts.values())
    assert leakcheck.leaks_total() == 0 and leakcheck.stats()["resource_drain_checks"] == 1


def test_scheduler_stop_mid_flight_drains_clean(loaded, witness_on, tmp_path):
    """Stop with lanes mid-decode (the crash shape of the recovery tests):
    the exit path settles every mirror record and journal mark."""
    journal = RequestJournal(str(tmp_path / "j.bin"), fsync=False)
    sched = _sched(loaded, journal=journal)
    reqs = [Request(prompt=f"mid-flight {i}", max_tokens=40, temperature=0.0)
            for i in range(2)]
    for r in reqs:
        r.on_delta = lambda d: time.sleep(0.01)
        sched.submit(r)
    deadline = time.monotonic() + 60
    while not all(r.generated_tokens for r in reqs) and time.monotonic() < deadline:
        time.sleep(0.002)
    sched.stop()  # cancels the lanes; must still drain clean
    journal.close()
    assert all(r.finish_reason == "cancelled" for r in reqs)
    assert all(v == 0 for v in sched.leak_counts().values())


def test_leaked_registry_entry_fires(witness_on):
    registry = StreamRegistry(grace_s=60.0)
    leaked = Request(prompt="never serviced", max_tokens=4)
    registry.register(leaked)
    with pytest.raises(ResourceLeak, match="stream_entries"):
        registry.close()
    assert leakcheck.leaks_total() == 1
    assert leakcheck.last_leak()["where"] == "stream registry close"


def test_leaked_registry_entry_counted_without_witness(witness_off):
    registry = StreamRegistry(grace_s=60.0)
    registry.register(Request(prompt="never serviced", max_tokens=4))
    registry.close()
    assert leakcheck.leaks_total() == 1


@pytest.mark.parametrize("how", ["discarded", "resolved"])
def test_released_entry_is_clean(witness_on, how):
    """discard() releases a shed entry; a finished stream's entry is
    retention the reaper owns, not a leak."""
    registry = StreamRegistry(grace_s=60.0)
    req = Request(prompt="shed or served", max_tokens=4)
    registry.register(req)
    if how == "discarded":
        registry.discard(req.id)
    else:
        req.future.set_result("done")
    registry.close()
    assert leakcheck.leaks_total() == 0


# -- jitcheck ------------------------------------------------------------------


class _Graphs:
    """A stand-in graph owner (the CPU captures no CUDA graph)."""


@pytest.fixture
def counter_only():
    jitcheck.force(False, fresh=True)
    try:
        yield
    finally:
        jitcheck.force(None, fresh=True)


@pytest.fixture
def strict():
    jitcheck.force(True, fresh=True)
    try:
        yield
    finally:
        jitcheck.force(None, fresh=True)


def test_jitcheck_disabled_by_default(monkeypatch):
    monkeypatch.delenv(jitcheck.ENV_FLAG, raising=False)
    jitcheck.force(None, fresh=False)
    assert not jitcheck.enabled()
    monkeypatch.setenv(jitcheck.ENV_FLAG, "1")
    assert jitcheck.enabled()
    monkeypatch.setenv(jitcheck.ENV_FLAG, "0")
    assert not jitcheck.enabled()


def test_capture_counts_without_strict(counter_only):
    owner = _Graphs()
    total = jitcheck.total_compiles()
    assert not jitcheck.note_capture(owner)  # not armed: warmup's captures
    jitcheck.arm(owner)
    assert jitcheck.armed()
    assert jitcheck.note_capture(owner)
    assert jitcheck.note_capture(_Graphs()) is False  # another engine's graphs
    assert jitcheck.total_compiles() == total + 3


def test_warming_pause_suppresses_counting(counter_only):
    owner = _Graphs()
    jitcheck.arm(owner)
    with jitcheck.warming():
        with jitcheck.warming():
            assert not jitcheck.note_capture(owner)
        assert not jitcheck.note_capture(owner)
    assert jitcheck.note_capture(owner)


def test_capture_after_arm_raises_under_strict(strict):
    """Under DLLAMA_JITCHECK=1 a graph captured after ``arm`` raises
    RecompileAfterWarmup at the step that captured."""
    owner = _Graphs()
    jitcheck.note_capture(owner)  # before arming: warmup, never raises
    jitcheck.arm(owner)
    with pytest.raises(RecompileAfterWarmup, match="captured after warmup"):
        jitcheck.note_capture(owner)


def test_arm_is_idempotent_and_owners_are_weak(counter_only):
    owner = _Graphs()
    jitcheck.arm(owner)
    jitcheck.arm(owner)
    assert jitcheck.note_capture(owner)
    assert sum(r() is owner for r in jitcheck._sinks) == 1  # registered once
    dead = _Graphs()
    jitcheck.arm(dead)
    del dead
    gc.collect()
    jitcheck.arm(owner)  # prunes the dead owner
    assert sum(r() is not None for r in jitcheck._sinks) == 1


def test_scheduler_start_reports_the_witness(loaded, counter_only, capsys):
    """The scheduler's startup line says whether warmup armed the witness
    (False on the CPU: no graph was captured, so none was marked warm)."""
    sched = _sched(loaded)
    sched.stop()
    line = next(l for l in capsys.readouterr().err.splitlines() if "scheduler_start" in l)
    assert '"jitcheck_armed": false' in line
