"""The port's disaggregated prefill on the CPU (``disagg/``, the replica
routes ``/admin/kvpages/<id>`` and ``/admin/kvimport``, the scheduler's
``run_device_op`` and ``export_session_pages``, the router's hand-off):
the JAX package's ``tests/test_disagg.py`` cases one for one, plus the
bundle carried both ways between a JAX and a port paged engine.

The JAX cases run on a content-keyed mock engine whose page payloads are
canonical hashes. Here the pages are the port engine's own KV bytes on the
tiny model (packed Q40, the kernels' plain versions, exact f32 dot): a
chain is committed by a real prefill, so every export, hash and import
moves real cache bytes. The replicas' context is 512 (the fixture's own
file), so the JAX cases' prompts fit, and each delta sleeps ``THROTTLE_S``
so a hand-off lands mid-stream. Every wait is bounded.
"""

from __future__ import annotations

import base64
import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_multiusers_tpu.disagg import adopt_bundle as j_adopt_bundle
from distributed_llama_multiusers_tpu.disagg import export_bundle as j_export_bundle
from distributed_llama_multiusers_tpu.formats import load_model_header as j_load_header
from distributed_llama_multiusers_tpu.formats.synthetic import (
    tiny_header,
    write_synthetic_model,
    write_synthetic_tokenizer,
)
from distributed_llama_multiusers_tpu.models import load_params_from_m as j_load_params
from distributed_llama_multiusers_tpu.runtime import InferenceEngine as JaxEngine
from distributed_llama_multiusers_tpu_torch.disagg import (
    HandoffAborted,
    KVTransferError,
    adopt_bundle,
    classify_prompt,
    decode_bundle,
    export_bundle,
    page_hash,
    prompt_chars,
)
from distributed_llama_multiusers_tpu_torch.fleet import FleetRouter
from distributed_llama_multiusers_tpu_torch.formats import load_model_header
from distributed_llama_multiusers_tpu_torch.models import load_params_from_m_quantized
from distributed_llama_multiusers_tpu_torch.runtime import ContinuousBatchingScheduler, InferenceEngine
from distributed_llama_multiusers_tpu_torch.runtime.kvpool import PoolExhausted
from distributed_llama_multiusers_tpu_torch.server import ApiServer
from distributed_llama_multiusers_tpu_torch.serving import StreamRegistry
from distributed_llama_multiusers_tpu_torch.tokenizer import TemplateType, Tokenizer
from distributed_llama_multiusers_tpu_torch.utils import faults

THROTTLE_S = 0.01  # per delta, on the scheduler thread: keeps a hand-off mid-stream
SEQ_LEN = 512
BUCKETS = (8,)


@pytest.fixture(autouse=True)
def _disarm_faults():
    faults.disarm()
    yield
    faults.disarm()


@pytest.fixture(scope="module")
def loaded(tiny_model):
    path = tiny_model["model"]
    config, params = load_params_from_m_quantized(path, load_model_header(path),
                                                  dtype=torch.float32, device="cpu")
    return config, params


@pytest.fixture(scope="module")
def replica_model(tmp_path_factory):
    """The tiny model at a 512-token context and its tokenizer (the
    replicas share the weights: nothing writes them)."""
    d = tmp_path_factory.mktemp("disagg_model")
    header = tiny_header(seq_len=SEQ_LEN)
    path, tok_path = str(d / "model.m"), str(d / "tokenizer.t")
    write_synthetic_model(path, header, seed=0)
    write_synthetic_tokenizer(tok_path, vocab_size=header.vocab_size)
    config, params = load_params_from_m_quantized(path, load_model_header(path),
                                                  dtype=torch.float32, device="cpu")
    return config, params, tok_path


# ---------------------------------------------------------------------------
# kvtransfer units: bundle round trip over the real pool and engine
# ---------------------------------------------------------------------------


def _counted(engine):
    """Count ``import_kv_page`` calls on ``engine.pages_imported``."""
    engine.pages_imported = 0
    inner = engine.import_kv_page

    def import_kv_page(page, payload):
        engine.pages_imported += 1
        return inner(page, payload)

    engine.import_kv_page = import_kv_page
    return engine


def _paged_engine(loaded, pool_pages=32, max_parked=8, page_size=4, n_lanes=2, **kw):
    config, params = loaded
    return _counted(InferenceEngine(config, params, n_lanes=n_lanes, prefill_buckets=BUCKETS,
                                    device="cpu", paged_kv=True, kv_page_size=page_size,
                                    kv_pool_pages=pool_pages, kv_max_parked=max_parked, **kw))


def _commit_chain(engine, lane, tokens):
    """Admit, prefill, commit and park one session's chain: its pages hold
    the model's KV of ``tokens``."""
    engine.paged_admit(lane, tokens, reserve_tokens=len(tokens))
    engine.prefill(lane, tokens)
    engine.paged_commit(lane, tokens)
    engine.paged_finish(lane, park=True)


def test_bundle_export_import_round_trip(loaded):
    """Export a committed chain off pool A, adopt it into pool B: pages and
    hashes verify, only fresh pages import, B's admission shares the
    adopted prefix, and B re-exports the same bundle byte for byte."""
    a = _paged_engine(loaded)
    tokens = list(range(2, 26))  # 24 tokens: 6 full blocks of 4
    _commit_chain(a, 0, tokens)
    bundle = export_bundle(a.kvpool, a, tokens)
    assert bundle["v"] == 1 and bundle["page_size"] == 4
    assert bundle["n_tokens"] == 24 and len(bundle["blocks"]) == 6
    for blk in bundle["blocks"]:
        payload = base64.b64decode(blk["p"])
        assert len(payload) == a.kv_page_bytes()
        assert blk["h"] == page_hash(4, blk["t"], payload)
        assert any(payload)  # the prefill's KV, not an empty page

    b = _paged_engine(loaded)
    assert adopt_bundle(b.kvpool, b, bundle) == {"pages": 6, "fresh": 6, "reused": 0}
    assert b.pages_imported == 6
    stats = b.kvpool.stats()
    assert stats["pool_adopts"] == 1 and stats["pool_adopted_pages_fresh"] == 6
    assert len(b.kvpool.chain_pages(tokens)) == 6
    assert export_bundle(b.kvpool, b, tokens) == bundle
    # re-adoption: all reused, no new import
    assert adopt_bundle(b.kvpool, b, bundle) == {"pages": 6, "fresh": 0, "reused": 6}
    assert b.pages_imported == 6
    # an admission on B shares the whole adopted prefix
    assert b.paged_admit(0, tokens + [50], reserve_tokens=26, min_share_tokens=4) == 24


def test_cow_block_survives_transfer(loaded):
    """A block born through copy-on-write exports and adopts like any
    committed block, and adoption dedups against the prefix it branched
    from."""
    a = _paged_engine(loaded)
    base = list(range(2, 26))
    _commit_chain(a, 0, base)
    forked = base[:22] + [91, 92]
    start, _blocks, copies, _sw = a.kvpool.admit(1, forked, reserve_tokens=len(forked) + 1,
                                                 min_share_tokens=4)
    assert copies, "expected a COW copy at the divergent block"
    assert start == 22
    a.apply_paged_admit(1, a.kvpool.table_row(_blocks), copies)
    a.prefill(1, forked[start:], start_pos=start)
    a.kvpool.commit(1, forked)
    a.kvpool.finish(1, park=True)

    bundle = export_bundle(a.kvpool, a, forked)
    assert len(bundle["blocks"]) == 6
    b = _paged_engine(loaded)
    assert adopt_bundle(b.kvpool, b, bundle) == {"pages": 6, "fresh": 6, "reused": 0}
    assert adopt_bundle(b.kvpool, b, export_bundle(a.kvpool, a, base)) \
        == {"pages": 6, "fresh": 1, "reused": 5}


def test_integrity_failure_adopts_nothing(loaded):
    a = _paged_engine(loaded)
    tokens = list(range(2, 26))
    _commit_chain(a, 0, tokens)
    bundle = export_bundle(a.kvpool, a, tokens)
    evil = json.loads(json.dumps(bundle))
    evil["blocks"][1]["p"] = base64.b64encode(b"\x00" * 64).decode()
    b = _paged_engine(loaded)
    free_before = b.kvpool.pages_free()
    with pytest.raises(KVTransferError) as e:
        adopt_bundle(b.kvpool, b, evil)
    assert e.value.reason == "integrity"
    assert b.kvpool.pages_free() == free_before
    assert b.kvpool.stats()["pool_adopts"] == 0
    assert b.pages_imported == 0
    assert b.kvpool.chain_pages(tokens) == []
    # intact payloads on the wrong blocks: the tokens are in the framing
    swapped = json.loads(json.dumps(bundle))
    swapped["blocks"][0]["t"], swapped["blocks"][1]["t"] = \
        swapped["blocks"][1]["t"], swapped["blocks"][0]["t"]
    with pytest.raises(KVTransferError) as e:
        adopt_bundle(b.kvpool, b, swapped)
    assert e.value.reason == "integrity"


def test_bundle_geometry_and_shape_rejections(loaded):
    a = _paged_engine(loaded)
    tokens = list(range(2, 26))
    _commit_chain(a, 0, tokens)
    bundle = export_bundle(a.kvpool, a, tokens)
    b = _paged_engine(loaded)
    with pytest.raises(KVTransferError) as e:
        decode_bundle(b.kvpool, {**bundle, "v": 2})
    assert e.value.reason == "bundle_version"
    with pytest.raises(KVTransferError) as e:
        decode_bundle(b.kvpool, {**bundle, "page_size": 8})
    assert e.value.reason == "page_size_mismatch"
    short = b"x" * 8
    partial = {**bundle, "blocks": [{"t": [1, 2, 3], "p": base64.b64encode(short).decode(),
                                     "h": page_hash(4, [1, 2, 3], short)}]}
    with pytest.raises(KVTransferError) as e:
        decode_bundle(b.kvpool, partial)
    assert e.value.reason == "partial_block"
    with pytest.raises(KVTransferError) as e:
        decode_bundle(b.kvpool, {**bundle, "blocks": [{"t": [1, 2, 3, 4]}]})
    assert e.value.reason == "malformed_block"
    # another cache dtype (an f32 replica's pages into an e4m3 pool: a
    # quarter of the bytes) is refused typed before the pool changes
    f8 = _paged_engine(loaded, cache_dtype=torch.float8_e4m3fn)
    assert f8.kv_page_bytes() * 4 == a.kv_page_bytes()
    free_before = f8.kvpool.pages_free()
    with pytest.raises(KVTransferError) as e:
        adopt_bundle(f8.kvpool, f8, bundle)
    assert e.value.reason == "page_bytes"
    assert f8.kvpool.pages_free() == free_before and f8.pages_imported == 0
    assert f8.kvpool.stats()["pool_adopts"] == 0 and f8.kvpool.chain_pages(tokens) == []
    # an empty chain: a valid no-op, not an error
    assert adopt_bundle(b.kvpool, b, {**bundle, "blocks": []}) \
        == {"pages": 0, "fresh": 0, "reused": 0}
    assert b.kvpool.stats()["pool_adopts"] == 0


def test_adopt_exhausted_pool_sheds_without_mutation(loaded):
    b = _paged_engine(loaded, pool_pages=32)
    # two live lanes pin 30 of 32 pages (not parked: nothing evictable)
    b.paged_admit(0, [3 + i % 100 for i in range(56)], reserve_tokens=57)
    b.paged_admit(1, [5 + i % 100 for i in range(56)], reserve_tokens=57)
    assert b.kvpool.pages_free() < 6
    a = _paged_engine(loaded)
    foreign = list(range(2, 26))
    _commit_chain(a, 0, foreign)
    bundle = export_bundle(a.kvpool, a, foreign)
    free_before = b.kvpool.pages_free()
    with pytest.raises(PoolExhausted):
        adopt_bundle(b.kvpool, b, bundle)
    assert b.kvpool.pages_free() == free_before
    assert b.kvpool.chain_pages(foreign) == []
    assert b.pages_imported == 0
    # a pool that parks nothing cannot pin the adopted chain
    parkless = _paged_engine(loaded, max_parked=0)
    with pytest.raises(ValueError):
        adopt_bundle(parkless.kvpool, parkless, bundle)


@pytest.mark.parametrize("kv", ["f32", "f8"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_bundle_carries_across_packages(loaded, tiny_model, direction, kv):
    """A chain committed by one package's paged engine, exported with its
    own ``export_bundle``, is adopted by the other's ``adopt_bundle``: the
    hashes verify, the adopted pages hold the exported bytes, and the
    adopter re-exports the same bundle (f32, and e4m3 on both sides)."""
    config, params = loaded
    path = tiny_model["model"]
    jconfig, jparams = j_load_params(path, j_load_header(path), dtype=jnp.float32)
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "f8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}[kv]
    port = _paged_engine(loaded, page_size=16, pool_pages=16, cache_dtype=tdt)
    jax_eng = JaxEngine(jconfig, jparams, n_lanes=2, prefill_buckets=BUCKETS, paged_kv=True,
                        kv_page_size=16, kv_pool_pages=16, kv_max_parked=8, cache_dtype=jdt)
    tokens = [5, 9, 3, 17, 2, 11, 7, 4, 13, 6, 21, 8, 30, 1, 12, 14, 19, 23, 25, 27, 29,
              31, 33, 35, 37, 39, 41, 43, 45, 47, 49, 51, 53]  # 33: two full pages
    if direction == "jax_to_port":
        src, dst, export, adopt = jax_eng, port, j_export_bundle, adopt_bundle
    else:
        src, dst, export, adopt = port, jax_eng, export_bundle, j_adopt_bundle
    _commit_chain(src, 0, tokens)
    bundle = export(src.kvpool, src, tokens)
    assert len(bundle["blocks"]) == 2
    payloads = [base64.b64decode(b["p"]) for b in bundle["blocks"]]
    itemsize = 1 if kv == "f8" else 4
    assert all(len(p) == 2 * config.n_layers * 16 * config.n_kv_heads * config.head_size
               * itemsize for p in payloads)
    assert adopt(dst.kvpool, dst, json.loads(json.dumps(bundle))) \
        == {"pages": 2, "fresh": 2, "reused": 0}
    pages = [p for _, p in dst.kvpool.chain_pages(tokens)]
    assert [bytes(dst.export_kv_page(p)) for p in pages] == payloads
    assert (export_bundle if dst is port else j_export_bundle)(dst.kvpool, dst, tokens) == bundle


# ---------------------------------------------------------------------------
# prompt-length classification
# ---------------------------------------------------------------------------


def test_prompt_chars_both_api_shapes():
    assert prompt_chars({"prompt": "abcd"}) == 4
    assert prompt_chars({"prompt": ["ab", "cd", 7]}) == 4
    assert prompt_chars({"messages": [{"role": "system", "content": "abc"},
                                      {"role": "user", "content": "de"},
                                      {"role": "user", "content": None}]}) == 5
    assert prompt_chars({}) == 0


def test_classify_prompt_threshold_and_disable():
    assert classify_prompt({"prompt": "x" * 99}, 100) == "short"
    assert classify_prompt({"prompt": "x" * 100}, 100) == "long"
    assert classify_prompt({"prompt": "x" * 10_000}, 0) == "short"
    assert classify_prompt({"prompt": "x" * 10_000}, -1) == "short"


# ---------------------------------------------------------------------------
# replica surfaces: role on /load, kvpages export, kvimport adopt
# ---------------------------------------------------------------------------


def _throttled(sched):
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


def _paged_replica(replica_model, rid, role="mixed", grace_s=30.0, paged=True,
                   cache_dtype=None):
    config, params, tok_path = replica_model
    kw = dict(paged_kv=True, kv_page_size=16, kv_pool_pages=128, kv_max_parked=32) \
        if paged else {}
    engine = _counted(InferenceEngine(config, params, n_lanes=2, prefill_buckets=(16, 32),
                                      device="cpu", cache_dtype=cache_dtype, **kw))
    tok = Tokenizer(tok_path)
    sched = ContinuousBatchingScheduler(engine, tok, speculative=False, prefix_min_tokens=16,
                                        multi_step=0)
    _throttled(sched)
    sched.start()
    registry = StreamRegistry(grace_s=grace_s) if grace_s else None
    api = ApiServer(sched, tok, model_name="disagg", template_type=TemplateType.LLAMA2,
                    resume=registry, replica_id=rid, role=role)
    httpd = api.serve(host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return {"api": api, "engine": engine, "sched": sched, "registry": registry,
            "httpd": httpd, "base": f"127.0.0.1:{httpd.server_address[1]}", "rid": rid}


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
        return json.loads(resp.read())


def _post_json(url, body, timeout=20):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _open_stream(base, body, timeout=60):
    """POST a stream and read to its first delta (the prompt's pages are
    committed by then)."""
    req = urllib.request.Request(f"http://{base}/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    resp = urllib.request.urlopen(req, timeout=timeout)
    rid = int(resp.headers["X-DLlama-Request"])
    for line in resp:
        line = line.decode().strip()
        if line.startswith("data: ") and line != "data: [DONE]":
            break
    return resp, rid


def _drain(resp):
    for _line in resp:
        pass
    resp.close()


def test_run_device_op_executes_on_loop_thread_and_relays_errors(loaded, tiny_model):
    """Admin device ops run on the batching loop's thread between steps;
    an op's exception re-raises to its caller with its type and the loop
    serves on; a stopped loop runs ops inline."""
    engine = _paged_engine(loaded)
    sched = ContinuousBatchingScheduler(engine, Tokenizer(tiny_model["tokenizer"]),
                                        speculative=False, multi_step=0)
    here = threading.current_thread()
    assert sched.run_device_op(threading.current_thread) is here
    sched.start()
    try:
        ran_on = sched.run_device_op(threading.current_thread)
        assert ran_on is sched._thread and ran_on is not here

        class _Boom(RuntimeError):
            pass

        def _raise():
            raise _Boom("device op failed")

        with pytest.raises(_Boom, match="device op failed"):
            sched.run_device_op(_raise)
        assert sched.run_device_op(lambda: 7) == 7
    finally:
        sched.stop()
    assert sched.run_device_op(threading.current_thread) is here



def test_run_device_op_limit_ends_at_the_step_boundary(loaded, tiny_model):
    """``timeout_s`` bounds the wait for a step boundary, not the op: an op
    the loop has taken runs to its end and returns its value however long
    it takes (a pod's page import runs for seconds); an op that no boundary
    takes in time is withdrawn, raises ``TimeoutError`` and never runs."""
    engine = _paged_engine(loaded)
    sched = ContinuousBatchingScheduler(engine, Tokenizer(tiny_model["tokenizer"]),
                                        speculative=False, multi_step=0)
    sched.start()
    try:
        # the idle loop looks for ops every 0.25 s; the op outlasts its limit
        assert sched.run_device_op(lambda: time.sleep(2.0) or 7, timeout_s=1.0) == 7
        taken, gate = threading.Event(), threading.Event()

        def hold():
            taken.set()
            gate.wait(30)

        held = threading.Thread(target=sched.run_device_op, args=(hold,),
                                kwargs={"timeout_s": 30})
        held.start()
        assert taken.wait(30)  # the loop is busy in the held op
        ran = []
        with pytest.raises(TimeoutError, match="step boundary"):
            sched.run_device_op(lambda: ran.append(1), timeout_s=0.2)
        gate.set()
        held.join(timeout=30)
        assert sched.run_device_op(lambda: 8) == 8 and ran == []
    finally:
        sched.stop()

def test_role_advertised_on_load_scrape(replica_model):
    p = _paged_replica(replica_model, "pf", role="prefill")
    m = _paged_replica(replica_model, "mx")
    try:
        assert _get_json(f"http://{p['base']}/load")["role"] == "prefill"
        assert _get_json(f"http://{m['base']}/load")["role"] == "mixed"
    finally:
        _stop_replica(p)
        _stop_replica(m)


def test_kvpages_export_surface(replica_model):
    r = _paged_replica(replica_model, "exp")
    try:
        prompt = "kv page export surface " * 4  # 92 chars: 5 full pages
        resp, rid = _open_stream(r["base"], {"prompt": prompt, "max_tokens": 24,
                                             "stream": True})
        bundle = _get_json(f"http://{r['base']}/admin/kvpages/{rid}")
        assert bundle["v"] == 1 and bundle["page_size"] == 16
        assert len(bundle["blocks"]) >= 5
        for blk in bundle["blocks"]:
            assert blk["h"] == page_hash(16, blk["t"], base64.b64decode(blk["p"]))
        _drain(resp)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://{r['base']}/admin/kvpages/424242", timeout=10)
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://{r['base']}/admin/kvpages/nope", timeout=10)
        assert e.value.code == 400
    finally:
        _stop_replica(r)


def test_kvimport_surface_and_typed_refusals(replica_model):
    src = _paged_replica(replica_model, "isrc")
    dst = _paged_replica(replica_model, "idst")
    flat = _paged_replica(replica_model, "iflat", paged=False)
    narrow = _paged_replica(replica_model, "if8", cache_dtype=torch.float8_e4m3fn)
    try:
        prompt = "kv import surface round trip " * 3  # 87 chars
        resp, rid = _open_stream(src["base"], {"prompt": prompt, "max_tokens": 24,
                                               "stream": True})
        bundle = _get_json(f"http://{src['base']}/admin/kvpages/{rid}")
        _drain(resp)
        status, receipt = _post_json(f"http://{dst['base']}/admin/kvimport", bundle)
        assert status == 200
        assert receipt["pages"] >= 5 and receipt["fresh"] == receipt["pages"]
        assert receipt["replica"] == "idst"
        assert dst["engine"].pages_imported == receipt["pages"]
        # corrupted in flight: a typed 422, the pool untouched
        evil = json.loads(json.dumps(bundle))
        evil["blocks"][0]["p"] = base64.b64encode(b"\x11" * 64).decode()
        adopts_before = dst["engine"].pool_stats()["pool_adopts"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post_json(f"http://{dst['base']}/admin/kvimport", evil)
        assert e.value.code == 422
        assert json.loads(e.value.read())["reason"] == "integrity"
        assert dst["engine"].pool_stats()["pool_adopts"] == adopts_before
        # another cache dtype (f32 pages into an e4m3 pool): a typed 422
        free_before = narrow["engine"].pool_stats()["pool_pages_free"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post_json(f"http://{narrow['base']}/admin/kvimport", bundle)
        assert e.value.code == 422
        assert json.loads(e.value.read())["reason"] == "page_bytes"
        stats = narrow["engine"].pool_stats()
        assert stats["pool_pages_free"] == free_before and stats["pool_adopts"] == 0
        # a contiguous replica cannot adopt pages: a clear 409
        with pytest.raises(urllib.error.HTTPError) as e:
            _post_json(f"http://{flat['base']}/admin/kvimport", bundle)
        assert e.value.code == 409
    finally:
        for r in (src, dst, flat, narrow):
            _stop_replica(r)


# ---------------------------------------------------------------------------
# router: the hand-off and its typed fallbacks
# ---------------------------------------------------------------------------


def _router(replicas, **kw):
    router = FleetRouter({r["rid"]: r["base"] for r in replicas},
                         scrape_interval_s=kw.pop("scrape_interval_s", 0.1), **kw).start()
    httpd = router.serve(host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    router.scrape_once()
    return router, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stream_via_router(rbase, body, timeout=120):
    req = urllib.request.Request(rbase + "/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    texts, ids, term, cur_id = [], [], None, None
    with urllib.request.urlopen(req, timeout=timeout) as resp:
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
            else:
                term = p
    return "".join(texts), term, served, ids


def _oracle_text(replica_model, body):
    """The stream of one standalone replica (the monolithic reference)."""
    r = _paged_replica(replica_model, "oracle")
    try:
        _, out = _post_json(f"http://{r['base']}/v1/completions", {**body, "stream": False},
                            timeout=60)
        return out["generated_text"]
    finally:
        _stop_replica(r)


LONG_BODY = {"prompt": "disagg hand off pin prompt " * 10,  # 270 chars
             "max_tokens": 24, "stream": True}


def test_disagg_handoff_mid_stream_byte_identical(replica_model):
    """A long prompt routed to the prefill replica hands off at its first
    token: pages adopted fresh on the decode replica, the session
    injected and reattached, and the client reads the monolithic bytes
    with gapless SSE ids. The decode replica shares the prompt's whole
    chunks (8 of 32 tokens: 256 of 271) and prefills the tail."""
    ref = _oracle_text(replica_model, LONG_BODY)
    p = _paged_replica(replica_model, "p0", role="prefill")
    d = _paged_replica(replica_model, "d0", role="decode")
    router, rhttpd, rbase = _router([p, d], long_prompt_chars=120)
    try:
        text, term, served, ids = _stream_via_router(rbase, LONG_BODY)
        assert served == "p0"
        assert text == ref
        assert term is not None and "error" not in term
        assert term["choices"][0]["finish_reason"] == "length"
        assert ids == list(range(1, len(ids) + 1))
        assert router.disagg_handoffs_ok == 1 and router.disagg_fallbacks == 0
        assert router.disagg_pages_fresh >= 1
        assert d["engine"].pool_stats()["pool_adopts"] >= 1
        assert d["engine"].pages_imported >= 1
        assert d["engine"].stats.snapshot()["prefix_tokens_saved"] == 256
        assert "dllama_router_disagg_handoffs_total" in router.handle_metrics()
        stats = router.handle_stats()
        assert stats["router_disagg_handoffs_ok"] == 1
        assert stats["router_long_prompt_chars"] == 120
    finally:
        router.close()
        rhttpd.shutdown()
        _stop_replica(p)
        _stop_replica(d)


def test_no_decode_target_falls_back_monolithic(replica_model):
    ref = _oracle_text(replica_model, LONG_BODY)
    p = _paged_replica(replica_model, "solo", role="prefill")
    router, rhttpd, rbase = _router([p], long_prompt_chars=120)
    try:
        text, term, served, _ = _stream_via_router(rbase, LONG_BODY)
        assert served == "solo"
        assert text == ref
        assert term["choices"][0]["finish_reason"] == "length"
        assert router.disagg_handoffs_ok == 0 and router.disagg_fallbacks == 1
    finally:
        router.close()
        rhttpd.shutdown()
        _stop_replica(p)


def test_prefill_death_mid_transfer_migrates_not_hangs(replica_model, monkeypatch):
    """The prefill replica dies mid-transfer: the hand-off aborts typed,
    the source stream breaks, and the session migrates to the decode
    replica off the cached ticket; the client reads the monolithic bytes."""
    import distributed_llama_multiusers_tpu_torch.fleet.router as router_mod

    ref = _oracle_text(replica_model, LONG_BODY)
    p = _paged_replica(replica_model, "dies", role="prefill")
    d = _paged_replica(replica_model, "lives", role="decode")

    def deadly_hand_off(*args, **kw):
        p["sched"].stop()
        p["httpd"].shutdown()
        p["httpd"].server_close()
        raise HandoffAborted("src_died", "injected: source died mid-transfer")

    monkeypatch.setattr(router_mod, "hand_off", deadly_hand_off)
    router, rhttpd, rbase = _router([p, d], long_prompt_chars=120)
    try:
        text, term, served, ids = _stream_via_router(rbase, LONG_BODY)
        assert served == "dies"
        assert text == ref
        assert term is not None and "error" not in term
        assert term["choices"][0]["finish_reason"] == "length"
        assert ids == list(range(1, len(ids) + 1))
        assert router.disagg_fallbacks == 1 and router.disagg_handoffs_ok == 0
        assert router.migrations_ok == 1
    finally:
        router.close()
        rhttpd.shutdown()
        _stop_replica(d)
