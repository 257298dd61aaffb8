"""The port's QoS layer (``serving/qos.py``, ``serving/deadlines.py``,
``serving/drain.py``) against the JAX package's, and its scheduler's QoS
behaviour on the tiny model (CPU).

Unit parity: the same push/pop scripts (users, priorities, costs, capacity,
made from a seed with numpy) go through both packages' ``QosQueue``; the
pop order, the rejections and the ``Retry-After`` hints must be equal, as
must ``jittered_retry_after`` and the deadline helpers. Scheduler
scenarios mirror the JAX package's ``tests/test_qos.py``: overflow gives
a typed 429 and the backlog is then served; budget expiry finishes with
``timeout`` and the lane is reused; a queue-wait timeout fires while the
lanes stay saturated; drain resolves every future and then sheds 503; a
``high`` request queued behind ``normal`` ones takes the next lane; one
user's burst does not starve another's requests.
"""

import argparse
import contextlib
import json
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distributed_llama_multiusers_tpu.serving import deadlines as j_deadlines
from distributed_llama_multiusers_tpu.serving import qos as j_qos
from distributed_llama_multiusers_tpu_torch.formats import load_model_header
from distributed_llama_multiusers_tpu_torch.models import load_params_from_m_quantized
from distributed_llama_multiusers_tpu_torch.runtime import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
)
from distributed_llama_multiusers_tpu_torch.server import ApiServer
from distributed_llama_multiusers_tpu_torch.serving import deadlines, qos
from distributed_llama_multiusers_tpu_torch.serving import (
    AdmissionRejected,
    DeadlinePolicy,
    Priority,
    QosQueue,
)
from distributed_llama_multiusers_tpu_torch.tokenizer import Tokenizer


# ---------------------------------------------------------------------------
# queue and deadline parity (no model)
# ---------------------------------------------------------------------------


def _script(seed: int, n: int = 120):
    """A push/pop script: ('push', user, priority, max_tokens) and
    ('pop',) steps, pushes twice as likely as pops."""
    rng = np.random.default_rng(seed)
    users = ["alice", "bob", "carol", ""]
    out = []
    for _ in range(n):
        if rng.random() < 0.65:
            out.append(("push", users[rng.integers(len(users))], int(rng.integers(3)),
                        int(rng.choice([1, 8, 64, 300, 2000]))))
        else:
            out.append(("pop",))
    return out


def _play(queue_cls, rejected_cls, script, capacity, quantum, t0):
    """Run ``script`` on a queue; every request is submitted at ``t0`` (a
    fixed stamp, so both packages see the same ages). Returns (pop order
    by push index, rejected push indices, the Retry-After hint of each
    rejection rounded as the HTTP header rounds it)."""
    q = queue_cls(capacity=capacity, quantum=quantum)
    popped, rejected, hints = [], [], []
    for i, step in enumerate(script):
        if step[0] == "push":
            _, user, prio, cost = step
            req = SimpleNamespace(idx=i, user_id=user, priority=prio, max_tokens=cost,
                                  submitted_at=t0)
            try:
                q.push(req)
            except rejected_cls as e:
                assert e.reason == "queue_full" and e.http_status == 429
                rejected.append(i)
                hints.append(max(1, round(e.retry_after_s)))
        elif not q.empty():
            popped.append(q.pop(timeout=0).idx)
    while not q.empty():
        popped.append(q.pop(timeout=0).idx)
    stats = q.stats()
    assert stats["queue_admitted"] == stats["queue_popped"] + stats["queue_removed"]
    return popped, rejected, hints


@pytest.mark.parametrize("seed,capacity,quantum", [
    (0, 0, 128.0), (1, 6, 128.0), (2, 3, 32.0), (3, 10, 500.0), (4, 1, 1.0)])
def test_pop_order_and_rejections_equal_jax(seed, capacity, quantum):
    script = _script(seed)
    # a backlog stuck for ~100 s: the hint is the oldest request's age
    t0 = time.monotonic() - 100.3
    got = _play(QosQueue, AdmissionRejected, script, capacity, quantum, t0)
    want = _play(j_qos.QosQueue, j_qos.AdmissionRejected, script, capacity, quantum, t0)
    assert got == want
    if capacity:
        assert got[1], "the script never reached capacity"
        assert all(h >= 100 for h in got[2])


def test_priority_strict_then_drr_fair_share():
    """HIGH pops before NORMAL before LOW; within a class one user's burst
    interleaves with another's (deficit round robin on max_tokens)."""
    q = QosQueue()
    reqs = ([SimpleNamespace(n=f"a{i}", user_id="alice", priority=Priority.NORMAL,
                             max_tokens=64) for i in range(4)]
            + [SimpleNamespace(n=f"b{i}", user_id="bob", priority=Priority.NORMAL,
                               max_tokens=64) for i in range(2)]
            + [SimpleNamespace(n="low", user_id="c", priority=Priority.LOW, max_tokens=1),
               SimpleNamespace(n="high", user_id="d", priority=Priority.HIGH, max_tokens=1)])
    for r in reqs:
        q.push(r)
    order = [q.pop(timeout=0).n for _ in reqs]
    assert order[0] == "high" and order[-1] == "low"
    assert order[1:5] == ["a0", "b0", "a1", "b1"]


@pytest.mark.parametrize("seconds", [0.2, 1.0, 5.0, 37.5])
def test_jittered_retry_after_equal_jax(seconds):
    keys = list(np.random.default_rng(7).integers(1, 2**40, size=200)) + list(range(1, 50))
    got = [qos.jittered_retry_after(seconds, int(k)) for k in keys]
    want = [j_qos.jittered_retry_after(seconds, int(k)) for k in keys]
    assert got == want
    assert min(got) >= 1.0
    if seconds >= 5.0:  # the +-20% band is used, not one value
        assert max(got) > seconds > min(got)


def test_priority_parse_and_shed_messages_equal_jax():
    for v in ("high", "NORMAL", " low ", 0, 2, Priority.HIGH):
        assert int(Priority.parse(v)) == int(j_qos.Priority.parse(v))
    for reason in ("queue_full", "draining", "breaker_open", "pool_exhausted"):
        a = AdmissionRejected(reason, capacity=4, queue_depth=4, retry_after_s=3.0)
        b = j_qos.AdmissionRejected(reason, capacity=4, queue_depth=4, retry_after_s=3.0)
        assert (a.http_status, a.reason) == (b.http_status, b.reason)
    assert AdmissionRejected("queue_full").http_status == 429
    assert AdmissionRejected("breaker_open").http_status == 503


def test_deadline_policy_and_helpers_equal_jax():
    rng = np.random.default_rng(3)
    args = argparse.Namespace(queue_timeout=0.5, request_budget=0.0)
    pols = (DeadlinePolicy.from_args(args), j_deadlines.DeadlinePolicy.from_args(args))
    assert pols[0] == DeadlinePolicy(queue_timeout_s=0.5, request_budget_s=None)
    assert pols[0].active and pols[1].active
    now = 1000.0
    for _ in range(200):
        req = SimpleNamespace(
            submitted_at=None if rng.random() < 0.1 else now - float(rng.uniform(0, 2)),
            admitted_at=None if rng.random() < 0.1 else now - float(rng.uniform(0, 2)),
            queue_timeout_s=rng.choice([None, 0.0, 0.3, 1.5]),
            budget_s=rng.choice([None, -1.0, 0.4, 1.0]))
        for pol_kw in ({}, {"queue_timeout_s": 0.7, "request_budget_s": 0.9}):
            p, jp = DeadlinePolicy(**pol_kw), j_deadlines.DeadlinePolicy(**pol_kw)
            assert deadlines.queue_expired(req, p, now) == j_deadlines.queue_expired(req, jp, now)
            assert (deadlines.budget_expired(req, p, now)
                    == j_deadlines.budget_expired(req, jp, now))
            assert (deadlines.queue_timeout_for(req, p)
                    == j_deadlines.queue_timeout_for(req, jp))
            assert deadlines.budget_for(req, p) == j_deadlines.budget_for(req, jp)


def test_remove_if_and_drain_keep_the_books():
    q = QosQueue(capacity=0)
    reqs = [SimpleNamespace(i=i, user_id=str(i % 3), priority=i % 3, max_tokens=4)
            for i in range(9)]
    for r in reqs:
        q.push(r)
    gone = q.remove_if(lambda r: r.i % 2 == 0)
    assert sorted(r.i for r in gone) == [0, 2, 4, 6, 8]
    assert q.depth() == 4
    q.note_rejection("draining")
    rest = q.drain()
    assert sorted(r.i for r in rest) == [1, 3, 5, 7]
    s = q.stats()
    assert s["queue_removed"] == 9 and s["queue_depth"] == 0
    assert s["queue_rejected_draining"] == 1


def test_queue_books_balance_under_thread_contention():
    """Many pushing threads against two popping ones, with a short switch
    interval: every admitted request is popped exactly once, and the
    counters reconcile (admitted = popped + removed + depth)."""
    import sys

    q = QosQueue(capacity=64)
    n_push, per = 16, 200
    popped, pop_lock = [], threading.Lock()
    stop = threading.Event()

    def pusher(k):
        for i in range(per):
            req = SimpleNamespace(key=(k, i), user_id=f"u{k % 5}", priority=i % 3,
                                  max_tokens=1 + i % 50)
            while True:
                try:
                    q.push(req)
                    break
                except AdmissionRejected:
                    time.sleep(0)

    def popper():
        while not stop.is_set() or not q.empty():
            r = q.pop(timeout=0.01)
            if r is not None:
                with pop_lock:
                    popped.append(r.key)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pops = [threading.Thread(target=popper) for _ in range(2)]
        pushes = [threading.Thread(target=pusher, args=(k,)) for k in range(n_push)]
        for t in pops + pushes:
            t.start()
        for t in pushes:
            t.join(timeout=120)
        stop.set()
        for t in pops:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in pops + pushes)
    finally:
        sys.setswitchinterval(old)
    assert sorted(popped) == sorted((k, i) for k in range(n_push) for i in range(per))
    s = q.stats()
    assert s["queue_admitted"] == s["queue_popped"] == n_push * per
    assert s["queue_depth"] == 0 and s["queue_max_depth"] <= 64


# ---------------------------------------------------------------------------
# scheduler scenarios (tiny model, CPU, ONE lane: saturation is deterministic)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stack(tiny_model):
    path = tiny_model["model"]
    config, params = load_params_from_m_quantized(path, load_model_header(path),
                                                  dtype=torch.float32, device="cpu")
    tok = Tokenizer(tiny_model["tokenizer"])
    # pipeline_depth 0: the synchronous loop, whose every step goes
    # through engine.decode, which slow_decode stretches
    engine = InferenceEngine(config, params, n_lanes=1, prefill_buckets=(8,),
                             device="cpu", pipeline_depth=0)
    return engine, tok


def make_sched(engine, tok, **kw):
    return ContinuousBatchingScheduler(engine, tok, speculative=False, multi_step=0, **kw)


@contextlib.contextmanager
def slow_decode(engine, delay: float):
    """Stretch each decode step so a blocker holds its lane for a window
    the test controls (the tiny model decodes in ~ms)."""
    real = engine.decode

    def slowed(*a, **k):
        time.sleep(delay)
        return real(*a, **k)

    engine.decode = slowed
    try:
        yield
    finally:
        engine.decode = real


def _wait_generating(req, timeout=60):
    deadline = time.monotonic() + timeout
    while req.state.name != "GENERATING":
        assert time.monotonic() < deadline, f"stuck in {req.state}"
        assert not req.future.done(), req.error
        time.sleep(0.005)


def test_overflow_rejected_then_backlog_served(stack):
    engine, tok = stack
    sched = make_sched(engine, tok, queue_=QosQueue(capacity=2))
    sched.start()
    try:
        with slow_decode(engine, 0.02):
            blocker = sched.submit(Request(prompt="hello", max_tokens=1000))
            _wait_generating(blocker)
            q1 = sched.submit(Request(prompt="hello", max_tokens=2))
            q2 = sched.submit(Request(prompt="hello", max_tokens=2))
            with pytest.raises(AdmissionRejected) as ei:
                sched.submit(Request(prompt="hello", max_tokens=2))
            assert ei.value.reason == "queue_full" and ei.value.http_status == 429
            blocker.cancel()
        assert isinstance(q1.future.result(timeout=120), str)
        assert isinstance(q2.future.result(timeout=120), str)
        blocker.future.result(timeout=120)
        assert blocker.finish_reason == "cancelled"
        assert q1.finish_reason in ("stop", "length") and q2.finish_reason in ("stop", "length")
        assert sched.qos_stats()["queue_rejected_full"] == 1
    finally:
        sched.stop()


def test_budget_expiry_finishes_timeout_and_lane_is_reused(stack):
    engine, tok = stack
    sched = make_sched(engine, tok, deadlines=DeadlinePolicy(request_budget_s=0.2))
    sched.start()
    try:
        with slow_decode(engine, 0.02):
            r = sched.submit(Request(prompt="hello", max_tokens=1000))
            r.future.result(timeout=120)
        assert r.finish_reason == "timeout"
        assert len(r.generated_tokens) < 40
        assert sched.budget_timeouts >= 1
        # the expired request freed its lane: the next one runs to its end
        # (its own budget, so a loaded machine cannot expire it too)
        nxt = sched.submit(Request(prompt="hello", max_tokens=2, budget_s=120.0))
        nxt.future.result(timeout=120)
        assert nxt.finish_reason in ("stop", "length") and nxt.generated_tokens
        # a per-request budget applies without a server-wide one
        sched.deadlines = DeadlinePolicy()
        with slow_decode(engine, 0.02):
            own = sched.submit(Request(prompt="hello", max_tokens=1000, budget_s=0.2))
            own.future.result(timeout=120)
        assert own.finish_reason == "timeout"
    finally:
        sched.stop()


def test_queue_wait_timeout_fires_while_saturated(stack):
    engine, tok = stack
    sched = make_sched(engine, tok, deadlines=DeadlinePolicy(queue_timeout_s=0.2))
    sched.start()
    try:
        with slow_decode(engine, 0.02):
            blocker = sched.submit(Request(prompt="hello", max_tokens=1000))
            _wait_generating(blocker)
            waiter = sched.submit(Request(prompt="hello", max_tokens=2))
            waiter.future.result(timeout=30)
            assert waiter.finish_reason == "timeout" and waiter.generated_tokens == []
            assert not blocker.future.done()  # the lane stayed busy throughout
            blocker.cancel()
        blocker.future.result(timeout=120)
        assert sched.queue_timeouts >= 1
        assert waiter.summary["finish_reason"] == "timeout"
    finally:
        sched.stop()


@contextlib.contextmanager
def slow_consume(engine, delay: float):
    """``slow_decode`` for the pipelined chain: stretch each lagged
    readback."""
    real = engine.pipeline_consume

    def slowed():
        time.sleep(delay)
        return real()

    engine.pipeline_consume = slowed
    try:
        yield
    finally:
        engine.pipeline_consume = real


@pytest.mark.parametrize("pipelined", [False, True])
def test_high_priority_takes_the_next_lane(stack, pipelined):
    """A ``high`` request queued behind three ``normal`` ones takes the
    next free lane: on the synchronous admit path (one lane), and inside
    the live pipelined chain (two lanes: the short blocker's lane frees
    while the long one keeps the chain going, and the chain's own claim
    picks the high request, which then rides fused dispatches)."""
    engine, tok = stack
    slow, blockers = slow_decode, [6]
    if pipelined:
        engine = InferenceEngine(engine.config, engine.params, n_lanes=2,
                                 prefill_buckets=(8,), device="cpu")
        slow, blockers = slow_consume, [6, 60]
    sched = make_sched(engine, tok)
    order = []
    sched.start()
    try:
        with slow(engine, 0.01):
            held = [sched.submit(Request(prompt="hello", max_tokens=n)) for n in blockers]
            for r in held:
                _wait_generating(r)
            reqs = [Request(prompt="hello", max_tokens=2, priority=Priority.NORMAL)
                    for _ in range(3)]
            reqs.append(Request(prompt="hello", max_tokens=2, priority=Priority.HIGH))
            for r in reqs:
                r.future.add_done_callback(lambda _f, r=r: order.append(r.priority))
                sched.submit(r)
        for r in reqs + held:
            r.future.result(timeout=120)
    finally:
        sched.stop()
    assert order[0] == Priority.HIGH, order
    if pipelined:  # claimed inside the chain, its prompt in fused dispatches
        assert reqs[-1].summary["fused_admitted"] is True


def test_fair_share_interleaving_no_starvation(stack):
    engine, tok = stack
    sched = make_sched(engine, tok)
    done_order = []
    lock = threading.Lock()

    def track(req):
        def on_done(_f):
            with lock:
                done_order.append(req.user_id)
        req.future.add_done_callback(on_done)
        return req

    sched.start()
    try:
        with slow_decode(engine, 0.01):
            blocker = sched.submit(Request(prompt="hello", max_tokens=8, user_id="warm"))
            _wait_generating(blocker)
            heavy = [track(sched.submit(Request(prompt="hello", max_tokens=2,
                                                user_id="alice"))) for _ in range(6)]
            light = [track(sched.submit(Request(prompt="hello", max_tokens=2,
                                                user_id="bob"))) for _ in range(2)]
        for r in heavy + light:
            r.future.result(timeout=120)
    finally:
        sched.stop()
    bob_at = [i for i, u in enumerate(done_order) if u == "bob"]
    assert bob_at[0] <= 2 and bob_at[1] <= 4, done_order


def test_drain_resolves_all_futures_then_sheds(stack):
    engine, tok = stack
    sched = make_sched(engine, tok)
    sched.start()
    reqs = [sched.submit(Request(prompt="hello", max_tokens=3)) for _ in range(3)]
    assert sched.drain(timeout=120) is True
    for r in reqs:
        assert r.future.done() and r.finish_reason in ("stop", "length")
    with pytest.raises(AdmissionRejected) as ei:
        sched.submit(Request(prompt="late"))
    assert ei.value.reason == "draining" and ei.value.http_status == 503
    stats = sched.qos_stats()
    assert stats["draining"] is True and stats["queue_rejected_draining"] == 1
    sched.stop()  # idempotent after a clean drain
    sched.start()  # restartable
    assert not sched.draining
    r = sched.submit(Request(prompt="hello", max_tokens=2))
    r.future.result(timeout=120)
    sched.stop()


def test_rejected_submit_keeps_no_stale_stamp(stack):
    engine, tok = stack
    sched = make_sched(engine, tok, queue_=QosQueue(capacity=1))
    first = sched.submit(Request(prompt="x", max_tokens=2))  # loop not started
    rej = Request(prompt="y", max_tokens=2)
    with pytest.raises(AdmissionRejected):
        sched.submit(rej)
    assert rej.submitted_at is None
    assert sched.queue.pop(timeout=0) is first
    sched.submit(rej)
    assert rej.submitted_at is not None and sched.queue.pop(timeout=0) is rej


def test_http_overflow_is_a_typed_429_with_retry_after(stack):
    """Over HTTP: the overflow gets 429 with the typed body and a jittered
    Retry-After of at least 1 s, the admitted requests finish."""
    engine, tok = stack
    sched = make_sched(engine, tok, queue_=QosQueue(capacity=1))
    api = ApiServer(sched, tok, model_name="qos-test")
    httpd = api.serve(host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    sched.start()

    def post(body):
        req = urllib.request.Request(base + "/v1/completions", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, dict(r.headers), json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), json.loads(e.read())

    try:
        with slow_decode(engine, 0.02):
            blocker = sched.submit(Request(prompt="hello", max_tokens=1000))
            _wait_generating(blocker)
            queued = sched.submit(Request(prompt="hello", max_tokens=2))
            status, headers, body = post({"prompt": "hi", "max_tokens": 2, "user": "u"})
            assert status == 429
            assert body["reason"] == "queue_full" and "queue full" in body["error"]
            assert int(headers["Retry-After"]) >= 1
            blocker.cancel()
        queued.future.result(timeout=120)
        status, _, body = post({"prompt": "hi", "max_tokens": 2, "priority": "high"})
        assert status == 200 and body["usage"]["completion_tokens"] >= 1
        with urllib.request.urlopen(base + "/load", timeout=30) as r:
            load = json.loads(r.read())
        assert load["status"] == "ok" and load["lanes_total"] == 1
    finally:
        httpd.shutdown()
        sched.stop()
