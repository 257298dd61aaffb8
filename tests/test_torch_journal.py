"""The port's crash-durable serving on the CPU (``serving/journal.py``,
``resume.py``, ``recovery.py``, the scheduler's journal hooks and the
server's resumable streams), the JAX package's ``tests/test_journal.py``
cases ported one for one onto the tiny model, plus the cross-package
checks: the two journal writers give the same bytes, a journal written by
either package is read, and recovers, in the other.

The JAX cases run on a content-keyed mock engine, whose tokens are a pure
function of (prompt, position). Here the scheduler runs the tiny model
(packed Q40, the kernels' plain versions, exact f32 dot): a lane's bits do
not depend on the other lanes or the lane count, so streams across a
crash and a restart at other lanes are compared for byte equality, as
there. A simulated crash lands mid-stream because the delta callback holds
the scheduler thread on an event until it has landed; other requests are
throttled by a 10 ms sleep in their delta callback. Every wait is bounded.
"""

import itertools
import json
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib

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
from distributed_llama_multiusers_tpu.serving import journal as j_journal
from distributed_llama_multiusers_tpu.serving import recover_scheduler as j_recover
from distributed_llama_multiusers_tpu.tokenizer import Tokenizer as JaxTokenizer
from distributed_llama_multiusers_tpu_torch.formats import load_model_header
from distributed_llama_multiusers_tpu_torch.models import load_params_from_m_quantized
from distributed_llama_multiusers_tpu_torch.runtime import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
)
from distributed_llama_multiusers_tpu_torch.runtime import scheduler as t_scheduler
from distributed_llama_multiusers_tpu_torch.runtime.scheduler import ensure_request_id_floor
from distributed_llama_multiusers_tpu_torch.server import ApiServer
from distributed_llama_multiusers_tpu_torch.serving import (
    CircuitBreaker,
    RequestJournal,
    StreamRegistry,
    StreamRelay,
    entry_from_admit_record,
    read_journal,
    recover_scheduler,
)
from distributed_llama_multiusers_tpu_torch.serving.journal import _FRAME, MAGIC
from distributed_llama_multiusers_tpu_torch.tokenizer import TemplateType, Tokenizer
from distributed_llama_multiusers_tpu_torch.utils import faults

THROTTLE_S = 0.01  # per delta, on the scheduler thread: keeps a crash mid-stream


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
    return config, params, Tokenizer(tiny_model["tokenizer"])


def _sched(loaded, journal=None, n_lanes=4, **kw):
    config, params, tok = loaded
    engine = InferenceEngine(config, params, n_lanes=n_lanes, prefill_buckets=(16, 32),
                             device="cpu")
    sched = ContinuousBatchingScheduler(engine, tok, journal=journal, **kw)
    sched.start()
    return sched


def _reqs(n, max_tokens=40):
    """Greedy requests, then seeded sampled ones (distinct prompts)."""
    return [Request(prompt=f"journal prompt {i} text", max_tokens=max_tokens,
                    temperature=0.0 if i % 2 == 0 else 0.8, seed=None if i % 2 == 0 else 7 + i)
            for i in range(n)]


# ---------------------------------------------------------------------------
# journal format: framing, torn tail, replay fold
# ---------------------------------------------------------------------------


def _admit_kwargs(rid, **over):
    kw = dict(request_id=rid, prompt="p", tokens=[1, 2, 3], max_tokens=8, temperature=0.5,
              topp=0.9, seed=42, stop=["s"], add_bos=True, add_special_tokens=False, user="u",
              priority=1, queue_timeout_s=None, budget_s=2.0, stream=True, kind="chat")
    kw.update(over)
    return kw


def test_journal_round_trip(tmp_path):
    p = str(tmp_path / "j.bin")
    j = RequestJournal(p, progress_every=2, fsync=False)
    j.record_admit(**_admit_kwargs(5))
    j.note_progress(5, 1)  # below the rate limit: not journaled
    j.note_progress(5, 4)
    j.record_admit(**_admit_kwargs(6, stream=False, kind=None, seed=7))
    j.record_finish(6, "stop")
    assert j.flush()
    stats = j.stats()
    assert stats["journal_records"] == 4
    assert stats["journal_errors"] == 0 and stats["journal_pending"] == 0
    j.close()
    img = read_journal(p)
    assert img.records == 4 and not img.torn
    [e] = img.incomplete()
    assert e.request_id == 5 and e.watermark == 4 and e.seed == 42 and e.stream
    assert e.kind == "chat" and e.stop == ["s"] and e.budget_s == 2.0
    assert not e.add_special_tokens and e.tokens == [1, 2, 3]
    assert img.entries[6].finished and img.entries[6].finish_reason == "stop"


def test_journal_reopen_truncates_torn_tail(tmp_path):
    """A reopened journal with a crash-torn tail is cut at the last durable
    frame before appending, or every later frame would sit behind the tear."""
    p = str(tmp_path / "j.bin")
    j = RequestJournal(p, fsync=False)
    j.record_admit(**_admit_kwargs(1))
    assert j.flush()
    j.close()
    with open(p, "ab") as f:
        f.write(b"\x13\x37\x00")
    j2 = RequestJournal(p, fsync=False)
    j2.record_finish(1, "stop")
    j2.record_admit(**_admit_kwargs(2))
    assert j2.flush()
    j2.close()
    img = read_journal(p)
    assert not img.torn
    assert img.entries[1].finished
    assert [e.request_id for e in img.incomplete()] == [2]


def test_journal_reopen_refuses_foreign_file(tmp_path):
    p = str(tmp_path / "notes.txt")
    with open(p, "wb") as f:
        f.write(b"operator notes, definitely not a journal")
    with pytest.raises(ValueError, match="not a request journal"):
        RequestJournal(p, fsync=False)


def test_note_progress_after_finish_is_inert(tmp_path):
    p = str(tmp_path / "j.bin")
    j = RequestJournal(p, progress_every=1, fsync=False)
    j.record_admit(**_admit_kwargs(1))
    j.note_progress(1, 3)
    j.record_finish(1, "stop")
    j.note_progress(1, 9)  # the pump's tail delivery after the finish
    assert j.flush()
    stats = j.stats()
    j.close()
    assert stats["journal_records"] == 3 and stats["journal_open_marks"] == 0
    assert read_journal(p).entries[1].watermark == 3


def test_journal_anonymous_user_round_trips_as_none(tmp_path):
    p = str(tmp_path / "j.bin")
    j = RequestJournal(p, fsync=False)
    j.record_admit(**_admit_kwargs(1, user=None))
    j.record_admit(**_admit_kwargs(2, user="None"))
    assert j.flush()
    j.close()
    img = read_journal(p)
    assert img.entries[1].user is None and img.entries[2].user == "None"


def test_journal_torn_tail_and_crc(tmp_path):
    p = str(tmp_path / "j.bin")
    j = RequestJournal(p, fsync=False)
    j.record_admit(**_admit_kwargs(1))
    j.record_admit(**_admit_kwargs(2))
    assert j.flush()
    j.close()
    whole = open(p, "rb").read()
    torn = tmp_path / "torn.bin"
    torn.write_bytes(whole[:-7])
    img = read_journal(str(torn))
    assert img.torn and img.records == 1
    assert [e.request_id for e in img.incomplete()] == [1]
    bad = bytearray(whole)
    bad[-3] ^= 0xFF
    crc = tmp_path / "crc.bin"
    crc.write_bytes(bytes(bad))
    img = read_journal(str(crc))
    assert img.torn and img.records == 1
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"not a journal")
    assert read_journal(str(junk)).torn
    img = read_journal(str(tmp_path / "nope.bin"))
    assert not img.torn and img.records == 0


def test_journal_unknown_record_kind_skipped(tmp_path):
    p = str(tmp_path / "j.bin")
    j = RequestJournal(p, fsync=False)
    j.record_admit(**_admit_kwargs(1))
    assert j.flush()
    j.close()
    frames = b""
    for rec in ({"k": "future-thing", "id": 1}, {"k": "progress", "id": 1, "n": 9}):
        payload = json.dumps(rec).encode()
        frames += _FRAME.pack(zlib.crc32(payload), len(payload)) + payload
    with open(p, "ab") as f:
        f.write(frames)
    img = read_journal(p)
    assert img.skipped == 1 and img.entries[1].watermark == 9


def test_journal_readmit_carries_watermark(tmp_path):
    p = str(tmp_path / "j.bin")
    j = RequestJournal(p, progress_every=1, fsync=False)
    j.record_admit(**_admit_kwargs(3))
    j.note_progress(3, 6)
    j.record_admit(**_admit_kwargs(3))  # a recovered request re-journals
    assert j.flush()
    j.close()
    e = read_journal(p).entries[3]
    assert not e.finished and e.watermark == 6


def test_journal_write_fault_contained(tmp_path):
    """The ``journal.write`` fault point fires inside the writer: the batch
    is lost and counted, later batches still write."""
    p = str(tmp_path / "j.bin")
    j = RequestJournal(p, fsync=False)
    faults.arm("journal.write:@1:n=1")
    j.record_admit(**_admit_kwargs(1))
    assert j.flush()
    j.record_admit(**_admit_kwargs(2))
    assert j.flush()
    stats = j.stats()
    j.close()
    assert stats["journal_errors"] == 1
    assert [e.request_id for e in read_journal(p).incomplete()] == [2]


def test_journal_header_validated(tmp_path):
    p = tmp_path / "j.bin"
    p.write_bytes(MAGIC + struct.pack("<II", 0, 1 << 30))
    img = read_journal(str(p))
    assert img.torn and img.records == 0


# ---------------------------------------------------------------------------
# the journal against the JAX package's: same bytes, read both ways
# ---------------------------------------------------------------------------


def _script(journal_cls, path):
    """One sequence of writer calls (no clock field anywhere)."""
    j = journal_cls(path, progress_every=2, fsync=False)
    j.record_admit(**_admit_kwargs(1, trace="0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331"))
    j.record_admit(**_admit_kwargs(2, user=None, kind="completion", temperature=0.0,
                                   queue_timeout_s=1.5, budget_s=None, stream=False))
    j.note_progress(1, 1)
    j.note_progress(1, 2)
    j.note_progress(1, 7)
    j.record_finish(2, "length")
    j.record_finish(1, "stop", phases={"ttft_ms": 12.5, "decode_ms": 3.0})
    j.record_admit(**_admit_kwargs(3, prompt="héllo ✓", tokens=list(range(40))))
    assert j.flush()
    j.close()


def test_journal_bytes_equal_jax(tmp_path):
    """The two writers frame the same calls into the same bytes."""
    _script(RequestJournal, str(tmp_path / "port.bin"))
    _script(j_journal.RequestJournal, str(tmp_path / "jax.bin"))
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()


def _image(img) -> dict:
    return {rid: {**e.__dict__} for rid, e in img.entries.items()} | {
        "records": img.records, "torn": img.torn, "skipped": img.skipped}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_read_by_the_other_package(tmp_path, writer):
    p = str(tmp_path / "j.bin")
    _script(j_journal.RequestJournal if writer == "jax" else RequestJournal, p)
    got, want = _image(read_journal(p)), _image(j_journal.read_journal(p))
    assert got == want
    assert [e.request_id for e in read_journal(p).incomplete()] == [3]
    rec = j_journal.admit_record(**_admit_kwargs(9))
    assert entry_from_admit_record({**rec, "watermark": 4}).__dict__ == \
        j_journal.entry_from_admit_record({**rec, "watermark": 4}).__dict__


# ---------------------------------------------------------------------------
# relay and registry
# ---------------------------------------------------------------------------


def test_relay_fast_forward_eviction_and_supersede():
    r = StreamRelay(1, base=2, capacity=3)
    for i in range(1, 7):
        r.push(i, f"t{i}")
    assert r.counts() == (4, 4)  # 1, 2 fast-forwarded; nothing delivered, nothing evicted
    gen = r.attach()
    assert r.next_after(2, timeout=0.2, gen=gen) == ("delta", 3, "t3")
    assert r.next_after(3, timeout=0.2, gen=gen) == ("delta", 4, "t4")
    r.push(7, "t7")  # the delivered prefix is the evictable replay window
    assert r.next_after(2, timeout=0.2, gen=gen)[0] == "gap"
    assert r.next_after(4, timeout=0.2, gen=gen) == ("delta", 5, "t5")
    assert r.next_after(7, timeout=0.05, gen=gen) is None
    r.finish()
    assert r.next_after(7, timeout=0.2, gen=gen) == ("done",)
    gen2 = r.attach()
    assert r.next_after(0, timeout=0.2, gen=gen)[0] == "superseded"
    assert r.next_after(7, timeout=0.2, gen=gen2) == ("done",)


def test_relay_slow_connected_client_never_gaps():
    r = StreamRelay(1, capacity=4)
    for i in range(1, 51):
        r.push(i, f"t{i}")
    r.finish()
    gen = r.attach()
    got, last = [], 0
    while True:
        item = r.next_after(last, timeout=0.2, gen=gen)
        if item == ("done",):
            break
        assert item[0] == "delta", item
        got.append(item[1])
        last = item[1]
    assert got == list(range(1, 51))


def test_relay_capacity0_frees_delivered():
    r = StreamRelay(1, capacity=0)
    for i in range(1, 11):
        r.push(i, f"t{i}")
    gen = r.attach()
    last = 0
    for _ in range(10):
        item = r.next_after(last, timeout=0.2, gen=gen)
        assert item[0] == "delta"
        last = item[1]
    r.push(11, "t11")
    assert r.counts() == (11, 1)
    assert r.next_after(last, timeout=0.2, gen=gen) == ("delta", 11, "t11")


def test_registry_grace_expiry_cancels():
    reg = StreamRegistry(grace_s=0.2)
    req = Request(prompt="x", max_tokens=4)
    reg.register(req, kind="chat")
    reg.detach(req.id)
    deadline = time.monotonic() + 10
    while not req._cancelled.is_set() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert req._cancelled.is_set()
    assert reg.attach(req.id) is None
    assert reg.stats()["resume_expired_cancels"] == 1
    req.future.cancel()  # never served: resolve it, or close() counts an orphan
    reg.close()


def test_registry_reattach_clears_grace_clock():
    reg = StreamRegistry(grace_s=0.3)
    req = Request(prompt="x", max_tokens=4)
    reg.register(req, kind="chat")
    reg.detach(req.id)
    time.sleep(0.1)
    assert reg.attach(req.id) is not None
    time.sleep(0.5)
    assert not req._cancelled.is_set()
    reg.discard(req.id)
    reg.close()


# ---------------------------------------------------------------------------
# the scheduler: admit records with resolved seeds, finishes final
# ---------------------------------------------------------------------------


def test_scheduler_journals_resolved_seed_and_finish(loaded, tmp_path):
    p = str(tmp_path / "j.bin")
    journal = RequestJournal(p, fsync=False)
    sched = _sched(loaded, journal=journal, n_lanes=2)
    try:
        unseeded = Request(prompt="no seed given", max_tokens=4, temperature=0.9)
        cancelled = Request(prompt="queued forever", max_tokens=4)
        sched.submit(unseeded)
        unseeded.future.result(timeout=60)
        cancelled.cancel()
    finally:
        sched.stop()
        journal.close()
    img = read_journal(p)
    e = img.entries[unseeded.id]
    # the journaled finish is the one the client got: "length" after 4
    # tokens, or "stop" where the random seed drew EOS first
    assert e.finished and e.finish_reason == unseeded.finish_reason
    assert e.finish_reason in ("length", "stop")
    assert e.finish_reason == "stop" or len(unseeded.generated_tokens) == 4
    assert e.tokens == loaded[2].encode("no seed given")
    # the journaled seed is the one the lane drew: seeded with it, the
    # request gives the client's stream again
    assert e.seed != 0
    sched = _sched(loaded, n_lanes=2)
    try:
        replay = Request(prompt="no seed given", max_tokens=4, temperature=0.9, seed=e.seed)
        sched.submit(replay)
        replay.future.result(timeout=60)
    finally:
        sched.stop()
    assert replay.generated_tokens == unseeded.generated_tokens
    assert replay.finish_reason == unseeded.finish_reason
    assert cancelled.id not in img.entries
    assert img.incomplete() == []


def test_scheduler_records_equal_jax(loaded, tiny_model, tmp_path):
    """The same seeded requests through both packages' schedulers with a
    journal: the records are equal once request ids are numbered in order
    and the clock fields (the finish records' latency phases) dropped."""
    bodies = [dict(prompt="hello world", max_tokens=6, temperature=0.0, seed=3),
              dict(prompt="the quick brown fox", max_tokens=5, temperature=0.8, seed=11,
                   stop=["zz"], user_id="alice")]
    port_p, jax_p = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    journal = RequestJournal(port_p, fsync=False)
    sched = _sched(loaded, journal=journal, n_lanes=2)
    try:
        for b in bodies:  # one at a time: the record order is the request order
            r = Request(**b)
            sched.submit(r)
            r.future.result(timeout=60)
    finally:
        sched.stop()
        journal.close()
    path = tiny_model["model"]
    jconfig, jparams = j_load_params(path, j_load_header(path), dtype=jnp.float32)
    jjournal = j_journal.RequestJournal(jax_p, fsync=False)
    jsched = JaxScheduler(JaxEngine(jconfig, jparams, n_lanes=2, prefill_buckets=(16, 32)),
                          JaxTokenizer(tiny_model["tokenizer"]), speculative=False,
                          pipelined=False, fused_prefill=False, multi_step=1, journal=jjournal)
    jsched.start()
    try:
        for b in bodies:
            r = JaxRequest(**b)
            jsched.submit(r)
            r.future.result(timeout=120)
    finally:
        jsched.stop()
        jjournal.close()

    def records(p):
        out, ids = [], {}
        with open(p, "rb") as f:
            assert f.read(len(MAGIC)) == MAGIC
            while head := f.read(_FRAME.size):
                _, n = _FRAME.unpack(head)
                rec = json.loads(f.read(n))
                rec.pop("phases", None)
                rec["id"] = ids.setdefault(rec["id"], len(ids))
                out.append(rec)
        return out

    got, want = records(port_p), records(jax_p)
    assert [r["k"] for r in got] == ["admit", "finish", "admit", "finish"]
    assert got == want


# ---------------------------------------------------------------------------
# crash mid-stream, recover, byte-identical resumed streams
# ---------------------------------------------------------------------------


def _run_reference(loaded, reqs):
    """The uninterrupted streams, as (token index, delta) lists."""
    sched = _sched(loaded, n_lanes=4)
    caps = []
    try:
        for rq in reqs:
            cap = []
            rq.on_delta = lambda d, c=cap, r=rq: c.append((len(r.generated_tokens), d))
            caps.append(cap)
            sched.submit(rq)
        for rq in reqs:
            rq.future.result(timeout=120)
    finally:
        sched.stop()
    return caps


def _crash_run(loaded, journal, reqs, min_deltas=5):
    """Submit together, record the client's view, then die: detach the
    journal (nothing after this reaches the disk) and stop. Once every
    request has min_deltas deltas, the next delta holds the scheduler
    thread on an event until the crash has landed, so no request runs on
    to its end first however loaded the host is; the client sees nothing
    after the crash. Returns the views and each request's delivered
    index."""
    sched = _sched(loaded, journal=journal, n_lanes=4)
    pre = [[] for _ in reqs]
    delivered = [0] * len(reqs)
    ready, crashed = threading.Event(), threading.Event()

    def cb(i, rq):
        def on_delta(d):
            if crashed.is_set():
                return  # the client died with the process
            pre[i].append((len(rq.generated_tokens), d))
            delivered[i] = len(rq.generated_tokens)
            journal.note_progress(rq.id, delivered[i])
            if all(len(v) >= min_deltas for v in pre):
                ready.set()
                crashed.wait(60)
        return on_delta

    for i, rq in enumerate(reqs):
        rq.on_delta = cb(i, rq)
        sched.submit(rq)
    try:
        assert ready.wait(60), "the requests did not reach min_deltas"
        sched.journal = None  # the kill: no finish record lands from here
        journal.flush()
        journal.close()
        at_crash = [len(rq.generated_tokens) for rq in reqs]
    finally:
        crashed.set()
    sched.stop()
    assert all(n < rq.max_tokens for n, rq in zip(at_crash, reqs)), \
        "a request finished before the crash"
    return pre, delivered


def _drain(relay, gen, last):
    out = []
    while True:
        item = relay.next_after(last, timeout=60, gen=gen)
        assert item is not None, "recovered stream stalled"
        if item[0] != "delta":
            assert item == ("done",), item
            return out
        _, last, text = item
        out.append((last, text))


# the scheduler's draws for requests without a seed in the crash test:
# distinct, and each one a seed under which "unseeded sampled" runs to its
# 40 tokens (about one random draw in twenty stops within 5 deltas, before
# the crash can land mid-stream); then fresh values
CRASH_DRAWS = (11, 13, 14, 15, 17, 18, 19, 21)


def test_crash_recovery_streams_byte_identical(loaded, tmp_path, monkeypatch):
    """Crash mid-stream with 4 requests on 4 lanes (2 greedy, 1 seeded, 1
    unseeded sampled), restart at HALF the lanes with recovery, reattach
    each client at its Last-Event-ID: every stream equals its
    uninterrupted run, none lost, none duplicated. The unseeded request
    replays its journaled draw: its stream from index 0 starts with what
    its client saw before the crash (every draw is a new value, so a
    replay that drew again would part from it)."""
    draws = itertools.chain(CRASH_DRAWS, itertools.count(1000))
    monkeypatch.setattr(t_scheduler, "fresh_seed", lambda: next(draws))
    ref_streams = _run_reference(loaded, _reqs(3))
    p = str(tmp_path / "j.bin")
    journal = RequestJournal(p, progress_every=1, fsync=False)
    crash = _reqs(3) + [Request(prompt="unseeded sampled", max_tokens=40, temperature=0.9)]
    pre, delivered = _crash_run(loaded, journal, crash)
    incomplete = read_journal(p).incomplete()
    assert [e.request_id for e in incomplete] == [r.id for r in crash]

    registry = StreamRegistry(grace_s=30.0)
    sched2 = _sched(loaded, n_lanes=2)
    try:
        coordinator = recover_scheduler(sched2, p, registry=registry)
        assert coordinator.join(60)
        resumed = {}
        for i, rq in enumerate(crash):
            got = registry.attach(rq.id)
            assert got is not None, f"stream {rq.id} not reattachable"
            _, relay, _, gen = got
            resumed[rq.id] = _drain(relay, gen, 0 if i == 3 else delivered[i])
    finally:
        sched2.stop()
        registry.close()
    lost = dup = 0
    for i, rq in enumerate(crash[:3]):
        seen = {}
        for idx, text in pre[i] + resumed[rq.id]:
            dup += idx in seen
            seen[idx] = text
        ref = dict(ref_streams[i])
        lost += sum(1 for idx in ref if idx not in seen)
        assert "".join(t for _, t in sorted(seen.items())) == \
            "".join(t for _, t in sorted(ref.items())), f"stream {i} diverged across the crash"
    assert lost == 0 and dup == 0
    replay = resumed[crash[3].id]
    assert replay[:len(pre[3])] == pre[3] and len(replay) > len(pre[3])
    stats = coordinator.stats()
    assert stats["recovered_requests"] == 4 and stats["recovery_failed"] == 0
    assert stats["recovery_replayed_tokens"] == sum(e.watermark for e in incomplete)
    assert Request(prompt="fresh").id > max(e.request_id for e in incomplete)


def test_reattach_below_journal_watermark_no_gap(loaded, tmp_path):
    """The watermark trails transport writes, so it can run ahead of what
    the client received: a client reattaching at its honest, lower
    Last-Event-ID gets every missing delta back, not a gap."""
    p = str(tmp_path / "j.bin")
    journal = RequestJournal(p, progress_every=1, fsync=False)
    pre, _ = _crash_run(loaded, journal, _reqs(1), min_deltas=8)
    client_last = pre[0][2][0]
    client_prefix = pre[0][:3]
    incomplete = read_journal(p).incomplete()
    assert incomplete[0].watermark > client_last
    registry = StreamRegistry(grace_s=30.0)
    sched2 = _sched(loaded, n_lanes=2)
    try:
        coordinator = recover_scheduler(sched2, p, registry=registry)
        assert coordinator.join(60)
        _, relay, _, gen = registry.attach(incomplete[0].request_id)
        resumed = _drain(relay, gen, client_last)
    finally:
        sched2.stop()
        registry.close()
    [ref] = _run_reference(loaded, _reqs(1))
    assert client_prefix + resumed == ref


def test_completed_requests_not_resurrected(loaded, tmp_path):
    p = str(tmp_path / "j.bin")
    journal = RequestJournal(p, progress_every=1, fsync=False)
    sched = _sched(loaded, journal=journal, n_lanes=2)
    done = Request(prompt="short one", max_tokens=3)
    live = Request(prompt="long one", max_tokens=40)
    caught = []
    live.on_delta = lambda d: (caught.append(d), time.sleep(THROTTLE_S))
    try:
        sched.submit(done)
        done.future.result(timeout=60)
        sched.submit(live)
        deadline = time.monotonic() + 60
        while len(caught) < 3 and time.monotonic() < deadline:
            time.sleep(0.002)
    finally:
        sched.journal = None
        journal.flush()
        journal.close()
        sched.stop()
    assert [e.request_id for e in read_journal(p).incomplete()] == [live.id]
    sched2 = _sched(loaded, n_lanes=2)
    try:
        coordinator = recover_scheduler(sched2, p)
        assert coordinator.join(60)
        assert coordinator.stats()["recovered_requests"] == 1
        assert [r.id for r in coordinator.requests] == [live.id]
        assert all(r.recovered for r in coordinator.requests)
        for r in coordinator.requests:
            r.future.result(timeout=60)
    finally:
        sched2.stop()


def test_recovery_composes_with_breaker(loaded, tmp_path):
    """A restart into an open breaker is shed like any client, retries on
    the breaker's hint, and lands once the half-open probe window opens."""
    p = str(tmp_path / "j.bin")
    journal = RequestJournal(p, progress_every=1, fsync=False)
    _crash_run(loaded, journal, _reqs(2, max_tokens=30), min_deltas=3)
    breaker = CircuitBreaker(threshold=1, cooldown_s=0.4)
    breaker.trip("still recovering from the crash")
    sched2 = _sched(loaded, n_lanes=2, breaker=breaker)
    try:
        coordinator = recover_scheduler(sched2, p, pace_s=0.01)
        assert coordinator.join(60)
        stats = coordinator.stats()
        assert stats["recovered_requests"] == 2 and stats["recovery_retries"] >= 1
        for r in coordinator.requests:
            r.future.result(timeout=60)
        assert breaker.state == "closed"
    finally:
        sched2.stop()


def test_recovery_replay_fault_contained(loaded, tmp_path):
    """The ``recovery.replay`` fault point skips one entry (counted); the
    rest recover."""
    p = str(tmp_path / "j.bin")
    journal = RequestJournal(p, progress_every=1, fsync=False)
    _crash_run(loaded, journal, _reqs(3, max_tokens=30), min_deltas=3)
    faults.arm("recovery.replay:@1:n=1")
    sched2 = _sched(loaded, n_lanes=2)
    try:
        coordinator = recover_scheduler(sched2, p)
        assert coordinator.join(60)
        stats = coordinator.stats()
        assert stats["recovery_failed"] == 1 and stats["recovered_requests"] == 2
        for r in coordinator.requests:
            r.future.result(timeout=60)
    finally:
        sched2.stop()


@pytest.fixture(scope="module")
def jax_stack(tiny_model):
    path = tiny_model["model"]
    jconfig, jparams = j_load_params(path, j_load_header(path), dtype=jnp.float32)
    return jconfig, jparams, JaxTokenizer(tiny_model["tokenizer"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_recovers_in_the_other_package(loaded, jax_stack, tmp_path, writer):
    """An admit record written by one package's journal recovers in the
    other's scheduler: the greedy and seeded streams regenerate as the
    recovering package's uninterrupted run gives them (the two packages'
    streams are equal; tests/test_torch_server.py)."""
    p = str(tmp_path / "j.bin")
    bodies = [dict(prompt="journal prompt 0 text", max_tokens=12, temperature=0.0),
              dict(prompt="journal prompt 1 text", max_tokens=12, temperature=0.8, seed=8)]
    tok = loaded[2]
    writer_cls = j_journal.RequestJournal if writer == "jax" else RequestJournal
    j = writer_cls(p, fsync=False)
    ids = [1000 + i for i in range(len(bodies))]
    for rid, b in zip(ids, bodies):
        j.record_admit(request_id=rid, prompt=b["prompt"], tokens=tok.encode(b["prompt"]),
                       max_tokens=b["max_tokens"], temperature=b["temperature"], topp=0.9,
                       seed=b.get("seed", 0), stop=[], add_bos=True, add_special_tokens=True,
                       user=None, priority=1, queue_timeout_s=None, budget_s=None,
                       stream=False, kind="completion")
    assert j.flush()
    j.close()
    if writer == "jax":  # the port recovers
        sched = _sched(loaded, n_lanes=2)
        ref = [Request(topp=0.9, seed=b.get("seed", 0),
                       **{k: v for k, v in b.items() if k != "seed"}) for b in bodies]
        recover = recover_scheduler
    else:
        jconfig, jparams, jtok = jax_stack
        sched = JaxScheduler(JaxEngine(jconfig, jparams, n_lanes=2, prefill_buckets=(16, 32)),
                             jtok, speculative=False, pipelined=False, fused_prefill=False,
                             multi_step=1)
        sched.start()
        ref = [JaxRequest(topp=0.9, seed=b.get("seed", 0),
                          **{k: v for k, v in b.items() if k != "seed"}) for b in bodies]
        recover = j_recover
    try:
        coordinator = recover(sched, p)
        assert coordinator.join(120)
        assert [r.id for r in coordinator.requests] == ids
        got = [r.future.result(timeout=120) for r in coordinator.requests]
        for r in ref:
            sched.submit(r)
        want = [r.future.result(timeout=120) for r in ref]
    finally:
        sched.stop()
    assert got == want and all(got)


# ---------------------------------------------------------------------------
# HTTP: SSE ids, live reattach, sessions, counters reconcile
# ---------------------------------------------------------------------------


def _serve(sched, registry=None):
    api = ApiServer(sched, sched.tokenizer, model_name="jrnl",
                    template_type=TemplateType.LLAMA3, resume=registry)
    httpd = api.serve(host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return api, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _read_sse(resp):
    """[(event id or None, payload)] up to [DONE]."""
    out, cur_id = [], None
    for line in resp:
        line = line.decode().strip()
        if line.startswith("id: "):
            cur_id = int(line[4:])
        elif line.startswith("data: "):
            out.append((cur_id, line[6:]))
            cur_id = None
            if line == "data: [DONE]":
                break
    return out


def _stream_post(base, body):
    return urllib.request.Request(base + "/v1/chat/completions",
                                  data=json.dumps({**body, "stream": True}).encode(),
                                  headers={"Content-Type": "application/json"})


def test_sse_chunks_carry_token_index_ids(loaded):
    sched = _sched(loaded, n_lanes=2)
    _, httpd, base = _serve(sched)
    try:
        body = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 6}
        with urllib.request.urlopen(_stream_post(base, body), timeout=60) as r:
            events = _read_sse(r)
    finally:
        httpd.shutdown()
        sched.stop()
    assert events[-1][1] == "[DONE]"
    ids = [i for i, _ in events[:-1] if i is not None]
    assert ids[:-1] == sorted(set(ids[:-1])) and ids[0] >= 1
    term = json.loads(events[-2][1])
    assert ids[-1] == term["summary"]["n_generated_tokens"]


def test_live_disconnect_reattach_within_grace(loaded):
    """Drop the connection mid-stream; the request keeps generating within
    the grace window, and ``GET /v1/stream/<id>`` with Last-Event-ID picks
    up exactly after it: the whole text equals an uninterrupted stream's."""
    registry = StreamRegistry(grace_s=10.0)
    sched = _sched(loaded, n_lanes=2)
    _, httpd, base = _serve(sched, registry)
    body = {"messages": [{"role": "user", "content": "hello there"}], "max_tokens": 40,
            "temperature": 0}
    try:
        with urllib.request.urlopen(_stream_post(base, body), timeout=60) as r:
            whole = _read_sse(r)
        r = urllib.request.urlopen(_stream_post(base, body), timeout=60)
        rid = int(r.headers["X-DLlama-Request"])
        got, cur_id = [], None
        for line in r:
            line = line.decode().strip()
            if line.startswith("id: "):
                cur_id = int(line[4:])
            elif line.startswith("data: "):
                got.append((cur_id, line[6:]))
                if len(got) >= 4:
                    break
        r.close()
        last_seen = got[-1][0]
        req2 = urllib.request.Request(base + f"/v1/stream/{rid}",
                                      headers={"Last-Event-ID": str(last_seen)})
        deadline = time.monotonic() + 30
        events = None
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(req2, timeout=60) as r2:
                    events = _read_sse(r2)
                break
            except urllib.error.HTTPError:
                time.sleep(0.05)
    finally:
        httpd.shutdown()
        registry.close()
        sched.stop()
    assert events is not None and events[-1][1] == "[DONE]"
    ids = [i for i, _ in events[:-2] if i is not None]
    assert not ids or ids[0] > last_seen

    def text(evs):
        out = ""
        for _, payload in evs:
            if payload != "[DONE]":
                out += json.loads(payload)["choices"][0].get("delta", {}).get("content") or ""
        return out

    assert text(got) + text(events) == text(whole)


def test_shed_streaming_post_does_not_leak_registry_entry(loaded):
    registry = StreamRegistry(grace_s=5.0)
    sched = _sched(loaded, n_lanes=2)
    _, httpd, base = _serve(sched, registry)
    try:
        sched._draining.set()  # every submit sheds with 503
        body = {"messages": [{"role": "user", "content": "x"}], "max_tokens": 4}
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(_stream_post(base, body), timeout=30)
        assert e.value.code == 503
        assert registry.depth() == 0
        sched._draining.clear()
    finally:
        httpd.shutdown()
        registry.close()
        sched.stop()


@pytest.mark.parametrize("grace", [0.0, 1.0])
def test_stream_route_404s(loaded, grace):
    """Resumption off (no registry): 404 naming --reconnect-grace; on, an
    unknown id: 404. ``/admin/session/`` of an unknown id: 404."""
    registry = StreamRegistry(grace_s=grace) if grace else None
    sched = _sched(loaded, n_lanes=2)
    _, httpd, base = _serve(sched, registry)
    try:
        for route in ("/v1/stream/424242", "/admin/session/424242"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + route, timeout=30)
            assert e.value.code == 404
            if route.startswith("/v1") and not grace:
                assert "reconnect-grace" in json.loads(e.value.read())["error"]
    finally:
        httpd.shutdown()
        if registry is not None:
            registry.close()
        sched.stop()


def test_admin_session_exports_the_admit_record(loaded):
    """``GET /admin/session/<id>`` of a live request: its admit wire record
    (the JAX package's encoding, resolved seed included) and watermark;
    404 once it finished. The first delta holds the stream (on the
    scheduler thread) until the export has been read, so the request is
    live when the GET lands however loaded the host is; the handler reads
    the session mirror without the scheduler thread."""
    sched = _sched(loaded, n_lanes=2)
    _, httpd, base = _serve(sched)
    req = Request(prompt="session export", max_tokens=40, temperature=0.8)
    seen = []
    exported = threading.Event()
    req.on_delta = lambda d: (seen.append(d), exported.wait(60))
    try:
        sched.submit(req)
        deadline = time.monotonic() + 60
        while not seen and time.monotonic() < deadline:
            time.sleep(0.002)
        try:
            with urllib.request.urlopen(base + f"/admin/session/{req.id}", timeout=30) as r:
                rec = json.loads(r.read())
        finally:
            exported.set()
        req.future.result(timeout=60)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + f"/admin/session/{req.id}", timeout=30)
        assert e.value.code == 404
    finally:
        httpd.shutdown()
        sched.stop()
    assert rec["k"] == "admit" and rec["id"] == req.id and rec["seed"] != 0
    assert rec["tokens"] == loaded[2].encode("session export")
    assert 1 <= rec["watermark"] <= 40
    entry = entry_from_admit_record(rec)
    assert entry.request_id == req.id and entry.seed == rec["seed"]
    assert set(rec) - {"watermark"} == set(j_journal.admit_record(**_admit_kwargs(1)))


def test_recovery_counters_reconcile_stats_vs_metrics(loaded, tmp_path):
    p = str(tmp_path / "j.bin")
    journal = RequestJournal(p, progress_every=1, fsync=False)
    _crash_run(loaded, journal, _reqs(2, max_tokens=30), min_deltas=3)
    journal2 = RequestJournal(p, fsync=False)  # the restarted process's
    sched2 = _sched(loaded, journal=journal2, n_lanes=2)
    registry = StreamRegistry(grace_s=10.0)
    _, httpd, base = _serve(sched2, registry)
    try:
        coordinator = recover_scheduler(sched2, p, registry=registry)
        assert coordinator.join(60)
        for r in coordinator.requests:
            r.future.result(timeout=60)
        sched2.journal.flush()
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            metrics = r.read().decode()
    finally:
        httpd.shutdown()
        registry.close()
        sched2.stop()
        journal2.close()
    assert stats["recovered_requests"] == 2 and stats["recovery_incomplete"] == 2
    assert stats["recovery_done"] is True and stats["journal_records"] >= 2
    assert stats["resources_live"]["journal_marks"] == 0
    gauges = {}
    for line in metrics.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name, _, value = line.rpartition(" ")
        gauges[name] = float(value)
    for fld in ("recovered_requests", "recovery_incomplete", "recovery_failed",
                "recovery_retries", "recovery_replayed_tokens", "journal_records",
                "journal_errors", "resource_leaks_total"):
        assert gauges[f"dllama_stats_{fld}"] == float(stats[fld]), fld
    assert gauges["dllama_recovered_requests_total"] == float(stats["recovered_requests"])
    assert gauges["dllama_journal_records_total"] == float(stats["journal_records"])


def test_ensure_request_id_floor():
    a = Request(prompt="a")
    ensure_request_id_floor(a.id + 1000)
    assert Request(prompt="b").id > a.id + 1000
