"""The port's failure containment (``serving/breaker.py``,
``serving/watchdog.py``, ``utils/faults.py`` and the scheduler's
containment boundary) against the JAX package's, on the tiny model (CPU).

Mirrors the JAX package's ``tests/test_failures.py``:
- ``classify_failure``, the ``CircuitBreaker`` state machine and the
  seeded fault plan's schedules equal the JAX package's for the same
  inputs (the breakers run on one fake clock, so no test sleeps);
- an injected ``engine.dispatch`` fault mid-churn fails the requests on
  lanes with ``finish_reason="error"`` and an ``EngineFailure`` naming
  them; every other request, those admitted after the fault included,
  streams the tokens a clean server streams and the JAX scheduler
  streams for the same prompt;
- the breaker's closed -> open -> half-open -> closed walk is seen over
  ``/health``, ``/stats`` and ``/metrics``;
- the step watchdog trips on a ``kind=hang`` consume and not on a slow
  consume that progresses.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import pytest
import torch

from distributed_llama_multiusers_tpu.formats import load_model_header as j_load_header
from distributed_llama_multiusers_tpu.models import load_params_from_m as j_load_params
from distributed_llama_multiusers_tpu.runtime import (
    ContinuousBatchingScheduler as JaxScheduler,
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from distributed_llama_multiusers_tpu.runtime.scheduler import (
    classify_failure as j_classify_failure,
)
from distributed_llama_multiusers_tpu.serving import breaker as j_breaker
from distributed_llama_multiusers_tpu.tokenizer import Tokenizer as JaxTokenizer
from distributed_llama_multiusers_tpu.utils import faults as j_faults
from distributed_llama_multiusers_tpu_torch.formats import load_model_header
from distributed_llama_multiusers_tpu_torch.models import load_params_from_m_quantized
from distributed_llama_multiusers_tpu_torch.runtime import (
    ContinuousBatchingScheduler,
    EngineFailure,
    InferenceEngine,
    Request,
)
from distributed_llama_multiusers_tpu_torch.runtime.scheduler import classify_failure
from distributed_llama_multiusers_tpu_torch.server import ApiServer
from distributed_llama_multiusers_tpu_torch.serving import (
    AdmissionRejected,
    CircuitBreaker,
    StepWatchdog,
    breaker,
)
from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer
from distributed_llama_multiusers_tpu_torch.utils import faults
from distributed_llama_multiusers_tpu_torch.utils.faults import FaultPlan, InjectedFault

BUCKETS = (8,)
PROMPTS = ["chaos one", "chaos request two", "three", "a fourth prompt", "fifth",
           "sixth one here", "seventh", "eight eight"]
MAX_TOKENS = 12


@pytest.fixture(autouse=True)
def _disarm_faults():
    faults.disarm()
    yield
    faults.disarm()


class FakeClock:
    """A monotonic clock the test advances (patched into a breaker module)."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


@pytest.fixture()
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(breaker, "time", c)
    monkeypatch.setattr(j_breaker, "time", c)
    return c


@pytest.fixture(scope="module")
def loaded(tiny_model):
    path = tiny_model["model"]
    config, params = load_params_from_m_quantized(path, load_model_header(path),
                                                  dtype=torch.float32, device="cpu")
    return config, params, Tokenizer(tiny_model["tokenizer"])


@pytest.fixture(scope="module")
def jax_streams(tiny_model):
    """Each PROMPT's greedy stream from the JAX scheduler (synchronous)."""
    path = tiny_model["model"]
    jconfig, jparams = j_load_params(path, j_load_header(path), dtype=jnp.float32)
    engine = JaxEngine(jconfig, jparams, n_lanes=2, prefill_buckets=BUCKETS)
    sched = JaxScheduler(engine, JaxTokenizer(tiny_model["tokenizer"]), speculative=False,
                         pipelined=False, fused_prefill=False, multi_step=1)
    reqs = [JaxRequest(prompt=p, max_tokens=MAX_TOKENS, temperature=0.0) for p in PROMPTS]
    sched.start()
    try:
        for r in reqs:
            sched.submit(r)
        for r in reqs:
            r.future.result(timeout=300)
    finally:
        sched.stop()
    return {r.prompt: list(r.generated_tokens) for r in reqs}


def _engine(loaded, n_lanes=2, **kw):
    config, params, _ = loaded
    return InferenceEngine(config, params, n_lanes=n_lanes, prefill_buckets=BUCKETS,
                           device="cpu", **kw)


def _wait(pred, timeout=60, msg="condition never held"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, msg
        time.sleep(0.002)


# ---------------------------------------------------------------------------
# parity of the pure parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda pkg: ValueError("empty prompt"), lambda pkg: RuntimeError("CUDA error"),
    lambda pkg: KeyError("x"), lambda pkg: pkg[0]("queue_full"),
    lambda pkg: pkg[1]("engine.dispatch", 3), lambda pkg: pkg[1]("engine.consume", 1)])
def test_classify_failure_equal_jax(make):
    """Each package classifies its own exceptions alike."""
    from distributed_llama_multiusers_tpu.serving import AdmissionRejected as JaxRejected

    got = classify_failure(make((AdmissionRejected, InjectedFault)))
    assert got == j_classify_failure(make((JaxRejected, j_faults.InjectedFault)))


BREAKER_SCRIPT = [
    ("allow",), ("fail", "one"), ("allow",), ("success",), ("fail", "one"), ("fail", "two"),
    ("allow",), ("retry",), ("tick", 0.03), ("allow",), ("tick", 0.03), ("allow",),
    ("allow",), ("fail", "probe failed"), ("allow",), ("tick", 0.06), ("allow",),
    ("success",), ("allow",), ("trip", "watchdog: stalled"), ("success",), ("tick", 0.02),
    ("success",), ("tick", 0.05), ("success",), ("request",), ("fail", "x"), ("fail", "y"),
    ("fail", "z"), ("tick", 0.1), ("allow",), ("success",),
]


def _walk(cls, clock, script):
    b = cls(threshold=2, cooldown_s=0.05)
    out = []
    for step in script:
        op = step[0]
        if op == "allow":
            out.append(("allow", b.allow(), b.state))
        elif op == "fail":
            out.append(("fail", b.record_engine_failure(step[1])))
        elif op == "success":
            b.record_success()
            out.append(("success", b.state))
        elif op == "trip":
            b.trip(step[1])
            out.append(("trip", b.state))
        elif op == "request":
            b.record_request_failure()
        elif op == "retry":
            out.append(("retry", b.retry_after_s()))
        elif op == "tick":
            clock.t += step[1]
    return out, b.stats()


def test_breaker_transitions_equal_jax(clock):
    got, got_stats = _walk(CircuitBreaker, clock, BREAKER_SCRIPT)
    clock.t = 1000.0
    want, want_stats = _walk(j_breaker.CircuitBreaker, clock, BREAKER_SCRIPT)
    assert got == want
    assert got_stats == want_stats
    assert got_stats["breaker_trips"] == 4 and got_stats["breaker_state"] == "closed"
    assert got_stats["engine_failures"] == {"engine": 7, "watchdog": 1, "request": 1}


@pytest.mark.parametrize("spec,point,horizon", [
    ("engine.dispatch:p=0.3,seed=42:n=5", "engine.dispatch", 60),
    ("engine.consume:@3+4", "engine.consume", 40),
    ("engine.dispatch:@7:n=1;engine.consume:p=0.1,seed=9", "engine.consume", 200),
    ("engine.dispatch:p=0.05,seed=123", "engine.dispatch", 500),
])
def test_fault_schedules_equal_jax(spec, point, horizon):
    plan, jplan = FaultPlan.parse(spec), j_faults.FaultPlan.parse(spec)
    want = jplan.schedule(point, horizon)
    assert plan.schedule(point, horizon) == want
    fired = []
    for i in range(1, horizon + 1):
        try:
            plan.fire(point)
        except InjectedFault as f:
            assert f.arrival == i
            fired.append(i)
    assert fired == want


def test_fault_spec_errors_and_env_arming(monkeypatch):
    for bad in ("engine.bogus:@1", "engine.dispatch", "engine.dispatch:@0",
                "engine.dispatch:@1:kind=melt", "engine.dispatch:q=1"):
        with pytest.raises(ValueError):
            FaultPlan.parse(bad)
        with pytest.raises(ValueError):
            j_faults.FaultPlan.parse(bad)
    monkeypatch.setenv("DLLAMA_FAULTS", "engine.consume:@2:n=1")
    plan = faults.maybe_arm_from_env()
    assert faults.armed() and plan.schedule("engine.consume", 5) == [2]
    assert faults.maybe_arm_from_env() is plan  # an armed plan is kept


# ---------------------------------------------------------------------------
# containment on the tiny model
# ---------------------------------------------------------------------------


def _serve(loaded, spec=None):
    """The default serving loop (pipelined, fused admissions) over PROMPTS:
    the first four submitted with a live chain, and, when ``spec`` arms a
    fault, the last four once a request has failed, so they are admitted
    after the fault. Returns (requests, scheduler, engine)."""
    engine = _engine(loaded)
    sched = ContinuousBatchingScheduler(engine, loaded[2], speculative=False)
    reqs = [Request(prompt=p, max_tokens=MAX_TOKENS, temperature=0.0) for p in PROMPTS]
    if spec is not None:
        faults.arm(spec)
    sched.start()
    try:
        sched.submit(reqs[0])
        _wait(lambda: len(reqs[0].generated_tokens) >= 2 or reqs[0].future.done())
        for r in reqs[1:4]:
            sched.submit(r)
        if spec is not None:
            _wait(lambda: any(r.finish_reason == "error" for r in reqs[:4]),
                  msg="the injected fault failed no request")
        for r in reqs[4:]:
            sched.submit(r)
        for r in reqs:
            try:
                r.future.result(timeout=120)
            except Exception:  # noqa: BLE001 — the failures are the subject
                pass
    finally:
        sched.stop()
    return reqs, sched, engine


def test_dispatch_fault_mid_churn_is_contained(loaded, jax_streams):
    clean, _, _ = _serve(loaded)
    assert all(r.error is None for r in clean)
    clean_streams = {r.prompt: list(r.generated_tokens) for r in clean}
    assert clean_streams == jax_streams

    reqs, sched, engine = _serve(loaded, "engine.dispatch:@6:n=1")
    failed = [r for r in reqs if r.finish_reason == "error"]
    ok = [r for r in reqs if r.finish_reason != "error"]
    assert 1 <= len(failed) <= engine.n_lanes
    assert all(r in reqs[:4] for r in failed)  # only lanes busy at the fault
    for r in failed:
        assert "injected fault" in r.error
        exc = r.future.exception()
        assert isinstance(exc, EngineFailure) and exc.request_id == r.id
        assert r.summary["finish_reason"] == "error"
    for r in ok:
        assert r.error is None
        assert list(r.generated_tokens) == clean_streams[r.prompt] == jax_streams[r.prompt]
    assert all(r in ok for r in reqs[4:])  # admitted after the fault: served
    assert engine.pipeline_inflight() == 0 and not engine.pipeline_active
    stats = sched.qos_stats()
    assert stats["engine_failure_rounds"] == 1
    assert stats["engine_failures"] == {"engine": 1}
    assert stats["breaker_state"] == "closed"  # one failure, threshold 3


def test_request_scoped_failure_fails_one_request(loaded):
    class BadTok:
        def __init__(self, tok):
            self._tok = tok

        def __getattr__(self, name):
            return getattr(self._tok, name)

        def encode(self, text, add_bos=True, add_special_tokens=True):
            if "poison" in text:
                raise ValueError("tokenizer rejected prompt")
            return self._tok.encode(text, add_bos=add_bos,
                                    add_special_tokens=add_special_tokens)

    engine = _engine(loaded)
    sched = ContinuousBatchingScheduler(engine, BadTok(loaded[2]))
    good = Request(prompt="fine", max_tokens=6)
    bad = Request(prompt="poison", max_tokens=6)
    sched.start()
    try:
        sched.submit(good)
        sched.submit(bad)
        good.future.result(timeout=60)
        with pytest.raises(ValueError, match="tokenizer rejected"):
            bad.future.result(timeout=60)
    finally:
        sched.stop()
    assert bad.finish_reason == "error" and good.error is None
    stats = sched.qos_stats()
    assert stats["engine_failure_rounds"] == 0 and stats["breaker_state"] == "closed"
    assert stats["engine_failures"] == {"request": 1}


def _get(url, timeout=30):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_breaker_over_health_stats_and_metrics(loaded, clock):
    engine = _engine(loaded)
    tok = loaded[2]
    br = CircuitBreaker(threshold=1, cooldown_s=5.0)
    sched = ContinuousBatchingScheduler(engine, tok, breaker=br)
    api = ApiServer(sched, tok, model_name="chaos-test")
    httpd = api.serve(host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    sched.start()
    try:
        status, _, body = _get(base + "/health")
        assert status == 200 and json.loads(body)["status"] == "ok"

        faults.arm("engine.dispatch:@1:n=1")
        victim = sched.submit(Request(prompt="x", max_tokens=4))
        with pytest.raises(EngineFailure):
            victim.future.result(timeout=60)
        status, headers, body = _get(base + "/health")
        body = json.loads(body)
        assert status == 503 and body["status"] == "unhealthy" and body["breaker"] == "open"
        assert int(headers["Retry-After"]) >= 1
        _, _, stats = _get(base + "/stats")
        stats = json.loads(stats)
        assert stats["breaker_state"] == "open" and stats["breaker_state_code"] == 2
        assert stats["engine_failures"] == {"engine": 1}
        assert stats["engine_failure_rounds"] == 1

        with pytest.raises(AdmissionRejected) as ei:
            sched.submit(Request(prompt="y", max_tokens=4))
        assert ei.value.reason == "breaker_open" and ei.value.http_status == 503
        req = urllib.request.Request(base + "/v1/completions",
                                     data=json.dumps({"prompt": "y", "max_tokens": 2}).encode(),
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 503 and int(e.value.headers["Retry-After"]) >= 1
        assert json.loads(e.value.read())["reason"] == "breaker_open"
        _, _, text = _get(base + "/metrics")
        text = text.decode()
        assert "dllama_breaker_state 2" in text
        assert 'dllama_engine_failures_total{failure_class="engine"} 1' in text

        clock.t += 5.0  # the cooldown passes: the next submit is the probe
        probe = sched.submit(Request(prompt="z", max_tokens=4))
        assert br.state == "half_open"
        probe.future.result(timeout=60)
        assert probe.error is None
        _wait(lambda: br.state == "closed", msg=str(br.stats()))
        status, _, body = _get(base + "/health")
        assert status == 200 and json.loads(body)["status"] == "ok"
        stats = json.loads(_get(base + "/stats")[2])
        assert stats["breaker_probes"] >= 1 and stats["queue_rejected_breaker"] >= 2
        assert stats["breaker_last_recovery_s"] is not None
    finally:
        httpd.shutdown()
        sched.stop()


def test_watchdog_trips_on_a_hung_consume(loaded):
    """A blackholed consume trips the watchdog within its deadline: the
    breaker opens while the consume still hangs, the chain is drained,
    and the request completes once the hang clears."""
    engine = _engine(loaded)
    faults.arm("engine.consume:@4:n=1:kind=hang:hang=2.0")
    sched = ContinuousBatchingScheduler(engine, loaded[2], step_deadline_s=0.3)
    req = Request(prompt="stall", max_tokens=30)
    sched.start()
    t0 = time.monotonic()
    try:
        sched.submit(req)
        _wait(lambda: sched.breaker.state == "open", timeout=30,
              msg="the watchdog never tripped the breaker")
        assert time.monotonic() - t0 < 2.0  # the deadline's doing, not the hang's
        req.future.result(timeout=60)
        assert req.error is None and len(req.generated_tokens) == 30
    finally:
        sched.stop()
    stats = sched.qos_stats()
    assert stats["watchdog_trips"] == 1 and stats["engine_failures"] == {"watchdog": 1}
    assert engine.stats.snapshot()["pipeline_flushes"] >= 1  # the chain was aborted


def test_watchdog_quiet_on_a_slow_progressing_consume(loaded):
    engine = _engine(loaded)
    real = engine.pipeline_consume

    def slow():
        time.sleep(0.03)  # a slow step, well inside the deadline
        return real()

    engine.pipeline_consume = slow
    sched = ContinuousBatchingScheduler(engine, loaded[2], step_deadline_s=0.5)
    req = Request(prompt="slow but alive", max_tokens=20)
    sched.start()
    try:
        sched.submit(req)
        req.future.result(timeout=60)
    finally:
        sched.stop()
    assert sched.qos_stats()["watchdog_trips"] == 0
    assert sched.breaker.state == "closed" and req.error is None


def test_watchdog_unit_trips_once_per_armed_step():
    trips = []
    wd = StepWatchdog(0.1, on_trip=trips.append)
    wd.start()
    try:
        for _ in range(5):
            wd.begin_step()
            wd.step_done()
        assert trips == []
        wd.begin_step()
        _wait(lambda: trips, timeout=5)
        assert trips[0] >= 0.1
        wd.begin_step()  # re-armed: trips once more
        _wait(lambda: len(trips) == 2, timeout=5)
    finally:
        wd.stop()
    assert wd.stats()["watchdog_trips"] == 2
