"""The port's fleet layer on the CPU (``fleet/``, ``app/dllama_router.py``,
the replica side in ``server/http.py`` and ``runtime/scheduler.py``): the
JAX package's ``tests/test_fleet.py`` cases one for one, on port replicas.

The JAX cases run on a content-keyed mock engine. Here every replica is
the port's ``ApiServer`` over the tiny model (packed Q40, the kernels'
plain versions, exact f32 dot; one set of weights shared by every
replica), whose lanes' bits do not depend on the other lanes or the lane
count, so a stream regenerated on another replica is compared byte for
byte, greedy and seeded. Its context is 512 (the fixture's own file), so
the JAX cases' prompts fit. Each delta sleeps ``THROTTLE_S`` on the
scheduler thread, so a kill lands mid-stream. The balancer cases also hold
every decision, key and ring owner against the JAX package's balancer on
the same ``/load`` states and prompts. Every wait is bounded.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from distributed_llama_multiusers_tpu.fleet import FleetBalancer as JaxBalancer
from distributed_llama_multiusers_tpu.fleet import FleetRouter as JaxRouter
from distributed_llama_multiusers_tpu.fleet import prefix_key as j_prefix_key
from distributed_llama_multiusers_tpu.formats.synthetic import (
    tiny_header,
    write_synthetic_model,
    write_synthetic_tokenizer,
)
from distributed_llama_multiusers_tpu_torch.fleet import FleetBalancer, FleetRouter, prefix_key
from distributed_llama_multiusers_tpu_torch.formats import load_model_header
from distributed_llama_multiusers_tpu_torch.models import load_params_from_m_quantized
from distributed_llama_multiusers_tpu_torch.runtime import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
)
from distributed_llama_multiusers_tpu_torch.server import ApiServer
from distributed_llama_multiusers_tpu_torch.serving import QosQueue, StreamRegistry
from distributed_llama_multiusers_tpu_torch.tokenizer import TemplateType, Tokenizer
from distributed_llama_multiusers_tpu_torch.utils import faults

THROTTLE_S = 0.01  # per delta, on the scheduler thread: keeps a kill mid-stream
SEQ_LEN = 512


@pytest.fixture(autouse=True)
def _disarm_faults():
    faults.disarm()
    yield
    faults.disarm()


@pytest.fixture(scope="module")
def fleet_model(tmp_path_factory):
    """The tiny model at a 512-token context and its tokenizer, loaded once
    (the replicas share the weights: nothing writes them)."""
    d = tmp_path_factory.mktemp("fleet_model")
    header = tiny_header(seq_len=SEQ_LEN)
    path, tok_path = str(d / "model.m"), str(d / "tokenizer.t")
    write_synthetic_model(path, header, seed=0)
    write_synthetic_tokenizer(tok_path, vocab_size=header.vocab_size)
    config, params = load_params_from_m_quantized(path, load_model_header(path),
                                                  dtype=torch.float32, device="cpu")
    return config, params, tok_path


# ---------------------------------------------------------------------------
# balancer: load routing, eligibility, consistent hashing (against JAX's)
# ---------------------------------------------------------------------------


def _both(replicas, **kw):
    return FleetBalancer(replicas, **kw), JaxBalancer(replicas, **kw)


def _loaded(bs, rid, queue_depth=0, lanes_free=4, breaker="closed", draining=False):
    for b in bs:
        b.update_load(rid, {"queue_depth": queue_depth, "lanes_free": lanes_free,
                            "lanes_total": 4, "breaker": breaker, "draining": draining})


def _pick(bs, key=None):
    """Both balancers' pick; they must agree."""
    got = [b.pick(key) for b in bs]
    ids = [None if g is None else g.rid for g in got]
    assert ids[0] == ids[1], ids
    return ids[0]


def test_least_loaded_wins():
    bs = _both(["h:1", "h:2", "h:3"])
    _loaded(bs, "h:1", queue_depth=5, lanes_free=0)
    _loaded(bs, "h:2", queue_depth=0, lanes_free=4)
    _loaded(bs, "h:3", queue_depth=2, lanes_free=1)
    assert _pick(bs) == "h:2"
    # a deeper queue loses even with free lanes equal
    _loaded(bs, "h:2", queue_depth=9, lanes_free=4)
    assert _pick(bs) == "h:3"


def test_breaker_open_and_draining_replicas_excluded():
    bs = _both(["h:1", "h:2"])
    _loaded(bs, "h:1", breaker="open")
    _loaded(bs, "h:2")
    assert _pick(bs) == "h:2"
    # keyed picks walk the ring past the unhealthy replica too
    for key in range(0, 20000, 997):
        assert _pick(bs, key) == "h:2"
    _loaded(bs, "h:2", draining=True)
    _loaded(bs, "h:1", breaker="open")
    assert _pick(bs) is None  # nobody eligible: the router 503s
    assert not any(b.any_eligible() for b in bs)
    # a clean scrape restores eligibility
    _loaded(bs, "h:1")
    assert all(b.any_eligible() for b in bs) and _pick(bs) == "h:1"


def test_shed_retry_after_honored_then_expires():
    bs = _both(["h:1", "h:2"])
    for b in bs:
        b.note_shed("h:1", retry_after_s=0.15)
    for _ in range(5):
        assert _pick(bs) == "h:2"
    assert all(b.min_retry_after_s() >= 1.0 for b in bs)  # the hint's floor
    time.sleep(0.2)
    # past the horizon h:1 is routable again (and, least routed, wins)
    assert _pick(bs) == "h:1"


def test_dead_replica_backs_off_then_reprobes():
    bs = _both(["h:1", "h:2"], dead_backoff_s=0.1)
    for b in bs:
        b.note_dead("h:1")
    assert _pick(bs) == "h:2"
    time.sleep(0.15)
    # past the backoff the dead replica earns one inline probe
    assert {_pick(bs) for _ in range(4)} == {"h:1", "h:2"}


def test_prefix_key_same_leading_blocks_same_key():
    base = "system prompt block " * 100  # far beyond 4 x 256 chars
    k1 = prefix_key(base + "user question A")
    k2 = prefix_key(base + "a completely different user question B")
    assert k1 == k2  # the same leading blocks give the same key
    assert prefix_key("x" * 1024) != prefix_key("y" * 1024)
    assert prefix_key("short") is None  # no full block: no affinity
    # the chain folds earlier blocks: the same block 1, another block 0
    a, b = ("A" * 256) + ("Z" * 256), ("B" * 256) + ("Z" * 256)
    assert prefix_key(a) != prefix_key(b)
    # the JAX package's key on every prompt, at its defaults and others
    for text in (base + "q", "x" * 1024, "short", a, b, "ünïcødé " * 90):
        assert prefix_key(text) == j_prefix_key(text)
        assert prefix_key(text, block_chars=16, max_blocks=2) \
            == j_prefix_key(text, block_chars=16, max_blocks=2)


def test_affinity_deterministic_and_ring_moves_one_over_n():
    """Removing one replica moves only the keys it owned (~1/N); every
    other key keeps its replica. The port's ring places every key where
    the JAX package's does."""
    replicas = ["h:1", "h:2", "h:3", "h:4"]
    b1, j1 = _both(replicas)
    keys = [prefix_key(f"shared system prompt {i} " * 40) for i in range(400)]
    owners1 = {k: b1.ring_owner(k) for k in keys}
    assert owners1 == {k: j1.ring_owner(k) for k in keys}
    assert {k: FleetBalancer(replicas).ring_owner(k) for k in keys} == owners1
    b2 = FleetBalancer(["h:1", "h:2", "h:4"])
    owners2 = {k: b2.ring_owner(k) for k in keys}
    moved = [k for k in keys if owners1[k] != owners2[k]]
    was_on_removed = [k for k in keys if owners1[k] == "h:3"]
    assert set(moved) == set(was_on_removed)
    frac = len(was_on_removed) / len(keys)
    assert 0.10 < frac < 0.45, frac
    # failover (dead, not removed) keeps everyone else's keys too
    for b in (b1, j1):
        b.note_dead("h:3", backoff_s=60.0)
    for k in keys:
        got = _pick((b1, j1), k)
        if owners1[k] != "h:3":
            assert got == owners1[k]
        else:
            assert got != "h:3"


# ---------------------------------------------------------------------------
# replica surfaces: /load, attribution, session export + migrate inject
# ---------------------------------------------------------------------------


def _throttled(sched):
    """Every request submitted to ``sched`` sleeps THROTTLE_S a delta."""
    submit = sched.submit

    def throttled_submit(req):
        inner = req.on_delta

        def on_delta(d):
            if inner is not None:
                inner(d)
            time.sleep(THROTTLE_S)

        req.on_delta = on_delta
        return submit(req)

    sched.submit = throttled_submit


def _replica(fleet_model, rid=None, n_lanes=2, grace_s=30.0, max_queue=0, role="mixed",
             **engine_kw):
    """One in-process dllama_api: the port's engine on the CPU, a resume
    registry (migration targets need one), an ephemeral port."""
    config, params, tok_path = fleet_model
    engine = InferenceEngine(config, params, n_lanes=n_lanes, prefill_buckets=(16, 32),
                             device="cpu", **engine_kw)
    tok = Tokenizer(tok_path)
    sched = ContinuousBatchingScheduler(engine, tok, queue_=QosQueue(capacity=max_queue),
                                        speculative=False, multi_step=0)
    _throttled(sched)
    sched.start()
    registry = StreamRegistry(grace_s=grace_s) if grace_s else None
    api = ApiServer(sched, tok, model_name="fleet", template_type=TemplateType.LLAMA2,
                    resume=registry, replica_id=rid, role=role)
    httpd = api.serve(host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return {"api": api, "sched": sched, "engine": engine, "registry": registry,
            "httpd": httpd, "base": f"127.0.0.1:{httpd.server_address[1]}",
            "rid": api.replica_id}


def _stop_replica(r):
    try:
        r["httpd"].shutdown()
    finally:
        if r["registry"] is not None:
            r["registry"].close()
        try:
            r["sched"].stop()
        except RuntimeError:
            pass


def _get_json(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.loads(resp.read()), dict(resp.headers)


def _post(url, body):
    return urllib.request.Request(url, data=json.dumps(body).encode(),
                                  headers={"Content-Type": "application/json"})


def _sse_texts(resp, first=None):
    """The delta texts of an SSE response (``first``: one already read)."""
    texts = [] if first is None else [first]
    for line in resp:
        line = line.decode().strip()
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        p = json.loads(line[6:])
        if p.get("choices", [{}])[0].get("finish_reason") is None:
            texts.append(p["choices"][0].get("text", ""))
    return texts


def test_load_surface_one_scrape_json(fleet_model):
    r = _replica(fleet_model, rid="alpha")
    try:
        load, headers = _get_json(f"http://{r['base']}/load")
        assert load["status"] == "ok" and load["replica"] == "alpha"
        assert load["role"] == "mixed"
        assert load["queue_depth"] == 0
        assert load["lanes_free"] == 2 and load["lanes_total"] == 2
        assert load["breaker"] == "closed" and load["draining"] is False
        assert headers["X-DLlama-Replica"] == "alpha"
        health, _ = _get_json(f"http://{r['base']}/health")
        assert health["queue_depth"] == 0 and health["breaker"] == "closed"
        # draining: /load stays 200, /health goes 503
        r["sched"]._draining.set()
        load, _ = _get_json(f"http://{r['base']}/load")
        assert load["status"] == "draining" and load["draining"] is True
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://{r['base']}/health", timeout=10)
        assert e.value.code == 503
        assert json.loads(e.value.read())["draining"] is True
        r["sched"]._draining.clear()
    finally:
        _stop_replica(r)


def test_replica_attribution_header_and_terminal_chunk(fleet_model):
    r = _replica(fleet_model, rid="attrib-1")
    try:
        url = f"http://{r['base']}/v1/completions"
        with urllib.request.urlopen(_post(url, {"prompt": "attribution test prompt",
                                                "max_tokens": 4}), timeout=30) as resp:
            assert resp.headers["X-DLlama-Replica"] == "attrib-1"
            json.loads(resp.read())
        term = None
        with urllib.request.urlopen(_post(url, {"prompt": "attribution test prompt",
                                                "max_tokens": 4, "stream": True}),
                                    timeout=30) as resp:
            assert resp.headers["X-DLlama-Replica"] == "attrib-1"
            assert int(resp.headers["X-DLlama-Request"]) > 0
            for line in resp:
                line = line.decode().strip()
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                p = json.loads(line[6:])
                if p.get("choices", [{}])[0].get("finish_reason"):
                    term = p
        assert term is not None and term["replica"] == "attrib-1"
        # a 404 names the replica too
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://{r['base']}/nowhere", timeout=10)
        assert e.value.code == 404 and e.value.headers["X-DLlama-Replica"] == "attrib-1"
    finally:
        _stop_replica(r)


@pytest.mark.parametrize("sampled", [False, True])
def test_session_export_and_migrate_inject_round_trip(fleet_model, sampled):
    """Export a live session's ticket off replica A, inject it into B,
    reattach from 0: the regenerated stream is the same bytes, greedy and
    seeded (the ticket carries the resolved seed)."""
    a, b = _replica(fleet_model, rid="src"), _replica(fleet_model, rid="dst")
    try:
        body = {"prompt": "migration ticket round trip", "max_tokens": 24, "stream": True,
                **({"temperature": 0.9} if sampled else {"temperature": 0.0})}
        resp = urllib.request.urlopen(_post(f"http://{a['base']}/v1/completions", body),
                                      timeout=30)
        rid = int(resp.headers["X-DLlama-Request"])
        first = None
        for line in resp:
            line = line.decode().strip()
            if line.startswith("data: ") and line != "data: [DONE]":
                first = json.loads(line[6:])
                break
        assert first is not None
        ticket, _ = _get_json(f"http://{a['base']}/admin/session/{rid}")
        assert ticket["id"] == rid and ticket["k"] == "admit"
        assert isinstance(ticket["seed"], int) and ticket["tokens"]
        assert ticket["stream"] is True
        reference = "".join(_sse_texts(resp, first["choices"][0].get("text", "")))
        resp.close()

        with urllib.request.urlopen(_post(f"http://{b['base']}/admin/migrate", ticket),
                                    timeout=30) as r2:
            out = json.loads(r2.read())
            assert r2.headers["X-DLlama-Replica"] == "dst"
        assert out["request_id"] == rid and out["replica"] == "dst"
        req3 = urllib.request.Request(f"http://{b['base']}{out['stream_path']}",
                                      headers={"Last-Event-ID": "0"})
        with urllib.request.urlopen(req3, timeout=60) as r3:
            assert "".join(_sse_texts(r3)) == reference
    finally:
        _stop_replica(a)
        _stop_replica(b)


def test_migrate_inject_remaps_colliding_id(fleet_model):
    """An injected session whose original id names a live request on the
    target is re-admitted under a fresh id; the live request's stream is
    untouched."""
    a, b = _replica(fleet_model, rid="ca"), _replica(fleet_model, rid="cb")
    try:
        resp_b = urllib.request.urlopen(_post(
            f"http://{b['base']}/v1/completions",
            {"prompt": "the innocent bystander", "max_tokens": 40, "stream": True}), timeout=30)
        live_rid = int(resp_b.headers["X-DLlama-Request"])
        with urllib.request.urlopen(_post(f"http://{a['base']}/v1/completions",
                                          {"prompt": "the migrating session", "max_tokens": 12,
                                           "stream": True}), timeout=60) as r:
            _sse_texts(r)
        tok = b["api"].tokenizer
        ticket = {"k": "admit", "id": live_rid, "prompt": "the migrating session",
                  "tokens": tok.encode("the migrating session"), "max_tokens": 12,
                  "temp": 0.0, "topp": 0.9, "seed": 5, "stream": True, "kind": "completion"}
        with urllib.request.urlopen(_post(f"http://{b['base']}/admin/migrate", ticket),
                                    timeout=30) as r:
            out = json.loads(r.read())
        assert out["request_id"] != live_rid  # remapped, not clobbered
        got_terminal = False
        for line in resp_b:
            line = line.decode().strip()
            if line.startswith("data: ") and line != "data: [DONE]":
                ch = json.loads(line[6:]).get("choices", [{}])[0]
                if ch.get("finish_reason"):
                    assert ch["finish_reason"] == "length"
                    got_terminal = True
            elif line == "data: [DONE]":
                break
        assert got_terminal
        req3 = urllib.request.Request(f"http://{b['base']}{out['stream_path']}",
                                      headers={"Last-Event-ID": "0"})
        with urllib.request.urlopen(req3, timeout=60) as r3:
            assert "".join(_sse_texts(r3))  # regenerated under the new id
    finally:
        _stop_replica(a)
        _stop_replica(b)


def test_migrate_endpoint_refusals(fleet_model):
    r = _replica(fleet_model, rid="nogrz", grace_s=0)
    try:
        ticket = {"k": "admit", "id": 12345, "prompt": "p", "tokens": [1, 2, 3],
                  "max_tokens": 4, "temp": 0.0, "topp": 0.9, "seed": 7, "stream": True}
        base = f"http://{r['base']}"
        # no resume registry on the target: a clear 409, not a shed
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(_post(base + "/admin/migrate", ticket), timeout=10)
        assert e.value.code == 409
        with pytest.raises(urllib.error.HTTPError) as e:  # malformed record
            urllib.request.urlopen(_post(base + "/admin/migrate", {"k": "finish", "id": 1}),
                                   timeout=10)
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:  # unknown session
            urllib.request.urlopen(base + "/admin/session/424242", timeout=10)
        assert e.value.code == 404
    finally:
        _stop_replica(r)


# ---------------------------------------------------------------------------
# router: routing, typed sheds, migration
# ---------------------------------------------------------------------------


def _router(replicas, cls=FleetRouter, **kw):
    router = cls({r["rid"]: r["base"] for r in replicas},
                 scrape_interval_s=kw.pop("scrape_interval_s", 0.1), **kw).start()
    httpd = router.serve(host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    router.scrape_once()
    return router, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def test_router_routes_around_draining_replica_and_gives_up_typed(fleet_model):
    a, b = _replica(fleet_model, rid="ra"), _replica(fleet_model, rid="rb")
    router, rhttpd, rbase = _router([a, b])
    try:
        a["sched"]._draining.set()
        router.scrape_once()
        body = {"prompt": "routing probe " * 30, "max_tokens": 4}
        for _ in range(3):
            with urllib.request.urlopen(_post(rbase + "/v1/completions", body),
                                        timeout=30) as resp:
                assert resp.headers["X-DLlama-Replica"] == "rb"
                json.loads(resp.read())
        # both gone: one aggregate typed 503 with a Retry-After hint
        b["sched"]._draining.set()
        router.scrape_once()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(_post(rbase + "/v1/completions", body), timeout=30)
        assert e.value.code == 503
        assert json.loads(e.value.read())["reason"] == "fleet_exhausted"
        assert int(e.value.headers["Retry-After"]) >= 1
        assert router.giveups >= 1
        a["sched"]._draining.clear()
        b["sched"]._draining.clear()
    finally:
        router.close()
        rhttpd.shutdown()
        _stop_replica(a)
        _stop_replica(b)


def test_router_retries_replica_shed_elsewhere(fleet_model):
    """A typed 429 (queue full) from one replica is retried on another; the
    shed replica's Retry-After becomes a routing backoff."""
    a = _replica(fleet_model, rid="full", n_lanes=1, max_queue=1)
    b = _replica(fleet_model, rid="roomy")
    router, rhttpd, rbase = _router([a, b])
    hold = [Request(prompt="hold the lane", max_tokens=400) for _ in range(2)]
    try:
        a["sched"].submit(hold[0])
        deadline = time.monotonic() + 10
        while not a["sched"].queue.empty() and time.monotonic() < deadline:
            time.sleep(0.005)
        a["sched"].submit(hold[1])
        router.scrape_once()
        deadline = time.monotonic() + 30
        saw_roomy = False
        while time.monotonic() < deadline and not saw_roomy:
            with urllib.request.urlopen(_post(rbase + "/v1/completions",
                                              {"prompt": "x", "max_tokens": 2}),
                                        timeout=30) as resp:
                saw_roomy = resp.headers["X-DLlama-Replica"] == "roomy"
                json.loads(resp.read())
        assert saw_roomy
    finally:
        for h in hold:
            h.cancel()
        router.close()
        rhttpd.shutdown()
        _stop_replica(a)
        _stop_replica(b)


@pytest.mark.parametrize("router_cls", [FleetRouter, JaxRouter], ids=["port", "jax"])
def test_router_affinity_same_prefix_same_replica(fleet_model, router_cls):
    """Same leading blocks, same replica; the JAX package's router places
    port replicas' traffic the same way (one wire)."""
    reps = [_replica(fleet_model, rid=f"f{i}") for i in (1, 2, 3)]
    router, rhttpd, rbase = _router(reps, cls=router_cls)
    try:
        system = "you are a helpful assistant " * 40  # > 4 blocks
        served = set()
        for i in range(6):
            with urllib.request.urlopen(_post(rbase + "/v1/completions", {
                    "prompt": system + f"user question {i}", "max_tokens": 2}),
                    timeout=30) as resp:
                served.add(resp.headers["X-DLlama-Replica"])
        assert len(served) == 1
        stats = router.handle_stats()
        assert stats["fleet_affinity_routes"] >= 6
        assert stats["fleet_affinity_hits"] >= 6
    finally:
        router.close()
        rhttpd.shutdown()
        for r in reps:
            _stop_replica(r)


def _stream_via_router(rbase, body, on_delta=None, timeout=120):
    """(text, terminal payload, served-by header, router SSE ids)."""
    texts, ids, term, cur_id = [], [], None, None
    with urllib.request.urlopen(_post(rbase + "/v1/completions", body),
                                timeout=timeout) as resp:
        served = resp.headers.get("X-DLlama-Replica")
        for line in resp:
            line = line.decode().strip()
            if line.startswith("id: "):
                cur_id = int(line[4:])
                continue
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                break
            p = json.loads(line[6:])
            if "error" in p:
                term = p
                continue
            ch = p.get("choices", [{}])[0]
            if ch.get("finish_reason") is None:
                texts.append(ch.get("text", ""))
                if cur_id is not None:
                    ids.append(cur_id)
                cur_id = None
                if on_delta is not None:
                    on_delta(len(texts))
            else:
                term = p
    return "".join(texts), term, served, ids


@pytest.mark.parametrize("sampled", [False, True])
def test_live_migration_mid_stream_byte_identical(fleet_model, sampled):
    """A stream moved off a dying replica mid-flight resumes on another
    byte for byte (nothing lost, nothing repeated), greedy and seeded, and
    the router's SSE ids stay gapless across the splice."""
    a, b = _replica(fleet_model, rid="m1"), _replica(fleet_model, rid="m2")
    router, rhttpd, rbase = _router([a, b])
    killed = []
    try:
        body = {"prompt": "migration pin prompt " * 20, "max_tokens": 40, "stream": True,
                **({"temperature": 0.9, "seed": 77} if sampled else {"temperature": 0.0})}
        ref_text, ref_term, source, _ = _stream_via_router(rbase, body)
        assert ref_term["choices"][0]["finish_reason"] == "length" and ref_text

        def kill_source(n_deltas):
            if n_deltas == 5 and not killed:
                victim = a if source == "m1" else b
                killed.append(victim)
                victim["httpd"].shutdown()
                victim["sched"].stop()

        text, term, served, ids = _stream_via_router(rbase, body, on_delta=kill_source)
        assert killed, "the kill never fired"
        assert served == source
        assert text == ref_text
        assert term is not None and "error" not in term
        assert term["choices"][0]["finish_reason"] == "length"
        assert ids == list(range(1, len(ids) + 1))
        assert router.migrations_ok == 1 and router.migrations_failed == 0
        assert "dllama_router_migrations_total" in router.handle_metrics()
    finally:
        router.close()
        rhttpd.shutdown()
        for r in (a, b):
            if r not in killed:
                _stop_replica(r)


def test_migration_rescues_engine_failure_terminal(fleet_model):
    """An engine failure on the source (contained: the stream ends with a
    typed error) is migrated to a healthy replica, not passed through."""
    a, b = _replica(fleet_model, rid="e1"), _replica(fleet_model, rid="e2")
    router, rhttpd, rbase = _router([a, b])
    try:
        body = {"prompt": "engine failure rescue " * 20, "max_tokens": 30, "stream": True}
        ref_text, _, source, _ = _stream_via_router(rbase, body)
        fired = []

        def break_engine(n_deltas):
            if n_deltas == 4 and not fired:
                victim = a if source == "e1" else b
                fired.append(victim)
                engine = victim["sched"].engine
                orig = engine.decode_pipelined

                def boom(*args, **kw):
                    engine.decode_pipelined = orig
                    raise RuntimeError("injected engine failure")

                engine.decode_pipelined = boom

        text, term, served, _ = _stream_via_router(rbase, body, on_delta=break_engine)
        assert fired
        assert text == ref_text
        assert term["choices"][0]["finish_reason"] == "length"
        assert router.migrations_ok >= 1
    finally:
        router.close()
        rhttpd.shutdown()
        _stop_replica(a)
        _stop_replica(b)


def test_router_modules_import_neither_torch_nor_numpy():
    """The router holds no model: ``fleet``, ``disagg.prefill`` and
    ``app.dllama_router`` (with the arg parser) load without torch or
    numpy, as the JAX package's stdlib copies do."""
    code = ("import sys\n"
            "import distributed_llama_multiusers_tpu_torch.fleet\n"
            "import distributed_llama_multiusers_tpu_torch.disagg.prefill\n"
            "import distributed_llama_multiusers_tpu_torch.disagg.kvtransfer\n"
            "import distributed_llama_multiusers_tpu_torch.app.dllama_router as r\n"
            "r.build_router_parser().parse_args(['--replicas', 'h:1'])\n"
            "print(sorted(m for m in ('torch', 'numpy', 'jax') if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
