"""Crash-durable request journal: append-only, CRC-framed, torn-tail
tolerant (the port's copy of the JAX package's ``serving/journal.py``; the
file format is the same byte for byte, so a journal written by either
package recovers in the other).

The supervised loop, breaker and watchdog make a serving-process death
contained; this module makes it recoverable. Every admitted request is
journaled with everything deterministic replay needs: prompt tokens and
sampler params including the RESOLVED seed (an unseeded request draws OS
entropy at admission; the journal records the draw, so a replay samples
the identical ``fold_in(seed, pos)`` stream), plus periodic per-request
progress watermarks (tokens already handed to the client transport) and
a finish record. After a crash, ``read_journal`` reconstructs the
in-flight set and serving/recovery.py regenerates each incomplete request
from its prompt with the same seed (serving/resume.py buffers the stream
and the client's ``Last-Event-ID`` picks the resume point), so the resumed
stream is byte-identical to the uninterrupted one.

On-disk format (binary, little-endian)::

    magic   := b"DLJRNL01"                     (8 bytes, file head)
    record  := u32 crc32(payload) | u32 len(payload) | payload
    payload := compact JSON, {"k": "admit" | "progress" | "finish", ...}

A reader stops at the first short or CRC-failing frame: a crash mid
``write()`` leaves a torn tail, never a corrupt replay (the torn records
were not yet durable, so the requests they describe resume from an earlier
watermark, or re-run in full). Unknown record kinds are skipped, not fatal.

Writes go through a background writer thread: ``record_admit`` /
``note_progress`` / ``record_finish`` only append to an in-memory queue
under the journal lock; the writer drains batches and does the file I/O
outside any lock, so the serving loop never blocks on the disk. A write
failure (ENOSPC, or the ``journal.write`` fault point) is counted and
contained: journaling degrades, serving never stops. Flag-gated:
``--journal-path``, off by default.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field

from ..lockcheck import make_lock
from ..utils import faults

MAGIC = b"DLJRNL01"
_FRAME = struct.Struct("<II")  # crc32(payload), len(payload)
# a frame longer than this is torn/garbage, not a real record (admit
# records are ~prompt-sized; far below this)
MAX_RECORD_BYTES = 16 << 20
# bound on queued-but-unwritten records: the admission queue is itself
# bounded (--max-queue), so this only trips when the disk stalls for a
# long time — then records drop (counted) rather than growing the heap
MAX_PENDING = 65536


def admit_record(*, request_id: int, prompt: str, tokens: list[int],
                 max_tokens: int, temperature: float, topp: float,
                 seed: int, stop: list[str], add_bos: bool,
                 add_special_tokens: bool, user: str | None, priority: int,
                 queue_timeout_s: float | None, budget_s: float | None,
                 stream: bool, kind: str | None = None,
                 response_format: dict | None = None,
                 trace: str | None = None) -> dict:
    """THE admit wire record — one field-mapping site shared by
    :meth:`RequestJournal.record_admit` (the on-disk journal) and the
    scheduler's live-session mirror (``export_session``, served on
    ``GET /admin/session/<id>``), so the two encodings cannot drift.
    Everything a deterministic replay needs, with the RESOLVED seed."""
    return {
        "k": "admit", "id": int(request_id), "prompt": prompt,
        "tokens": [int(t) for t in tokens],
        "max_tokens": int(max_tokens), "temp": float(temperature),
        "topp": float(topp), "seed": int(seed),
        "stop": list(stop), "add_bos": bool(add_bos),
        # user None stays null: an anonymous request must come back
        # from recovery anonymous, not as a QoS fair-share user
        # literally named "None"
        "add_special": bool(add_special_tokens),
        "user": None if user is None else str(user),
        "prio": int(priority), "queue_timeout_s": queue_timeout_s,
        "budget_s": budget_s, "stream": bool(stream), "kind": kind,
        # structured output (grammar/): the response_format the automaton
        # is rebuilt from on replay (None = unconstrained)
        "response_format": response_format,
        # trace context (telemetry/tracectx.py, "tid-sid" wire form): a
        # recovered stream rejoins its original trace instead of starting
        # a fresh one
        "trace": None if trace is None else str(trace),
    }


def entry_from_admit_record(rec: dict) -> "JournalEntry":
    """Materialize one admit wire record (as :func:`admit_record` /
    ``record_admit`` encode it) back into a :class:`JournalEntry` —
    the decode half of the ``GET /admin/session/<id>`` record, which
    ``scheduler.build_recovered_request`` turns back into a request, the
    path crash recovery replays through. Runs the SAME fold
    ``read_journal`` uses
    (:meth:`JournalImage.apply`), so the two decoders cannot drift; an
    optional ``watermark`` field rides along (tokens the exporting server
    had delivered — informational: resumption is by ``Last-Event-ID``,
    never by watermark skip). Raises ``ValueError`` on a malformed
    record."""
    if rec.get("k", "admit") != "admit":
        raise ValueError(f"not an admit record (k={rec.get('k')!r})")
    image = JournalImage()
    try:
        image.apply({**rec, "k": "admit"})
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"malformed admit record: {e}") from e
    if not image.entries:
        raise ValueError("admit record carried no request id")
    entry = next(iter(image.entries.values()))
    try:
        entry.watermark = max(0, int(rec.get("watermark", 0) or 0))
    except (TypeError, ValueError) as e:
        raise ValueError(f"malformed watermark: {e}") from e
    return entry


@dataclass
class JournalEntry:
    """One request's journaled state after a sequential replay of the
    file: the admit fields plus the folded-in progress/finish records."""

    request_id: int
    prompt: str = ""
    tokens: list[int] = field(default_factory=list)
    max_tokens: int = 128
    temperature: float = 0.0
    topp: float = 0.9
    seed: int = 0  # RESOLVED lane seed (never None: replay must reproduce it)
    stop: list[str] = field(default_factory=list)
    add_bos: bool = True
    add_special_tokens: bool = True
    user: str | None = None
    priority: int = 1
    queue_timeout_s: float | None = None
    budget_s: float | None = None
    stream: bool = False
    kind: str | None = None  # "chat" | "completion" | None (CLI/bench)
    response_format: dict | None = None  # structured output (grammar/)
    trace: str | None = None  # trace context, "tid-sid" wire form
    watermark: int = 0  # tokens already delivered to the client transport
    finished: bool = False
    finish_reason: str | None = None
    phases: dict | None = None  # latency attribution off the finish record


class JournalImage:
    """The journal file, replayed: per-request entries in admit order,
    plus the read-side accounting (record count, torn tail)."""

    def __init__(self):
        self.entries: "OrderedDict[int, JournalEntry]" = OrderedDict()
        self.records = 0
        self.torn = False  # file ended mid-frame / CRC-failed (crash tail)
        self.skipped = 0  # unknown record kinds (forward compat)

    def incomplete(self) -> list[JournalEntry]:
        """Entries with no finish record, in admit order — the set a
        recovery replay re-admits."""
        return [e for e in self.entries.values() if not e.finished]

    def apply(self, rec: dict) -> None:
        kind = rec.get("k")
        if kind == "admit":
            rid = int(rec["id"])
            prev = self.entries.pop(rid, None)
            e = JournalEntry(
                request_id=rid,
                prompt=str(rec.get("prompt", "")),
                tokens=[int(t) for t in rec.get("tokens", [])],
                max_tokens=int(rec.get("max_tokens", 128)),
                temperature=float(rec.get("temp", 0.0)),
                topp=float(rec.get("topp", 0.9)),
                seed=int(rec.get("seed", 0)),
                stop=[str(s) for s in rec.get("stop", [])],
                add_bos=bool(rec.get("add_bos", True)),
                add_special_tokens=bool(rec.get("add_special", True)),
                user=(None if rec.get("user") is None
                      else str(rec.get("user"))),
                priority=int(rec.get("prio", 1)),
                queue_timeout_s=rec.get("queue_timeout_s"),
                budget_s=rec.get("budget_s"),
                stream=bool(rec.get("stream", False)),
                kind=rec.get("kind"),
                response_format=(
                    dict(rec["response_format"])
                    if isinstance(rec.get("response_format"), dict)
                    else None
                ),
                trace=(
                    str(rec["trace"])
                    if isinstance(rec.get("trace"), str)
                    else None
                ),
            )
            if prev is not None:
                # a recovered request re-journals on re-admission: its
                # progress watermark is ABSOLUTE (token index from the
                # stream's start), so delivery state carries across
                # crash generations
                e.watermark = prev.watermark
            self.entries[rid] = e
        elif kind == "progress":
            e = self.entries.get(int(rec.get("id", -1)))
            if e is not None:
                e.watermark = max(e.watermark, int(rec.get("n", 0)))
        elif kind == "finish":
            e = self.entries.get(int(rec.get("id", -1)))
            if e is not None:
                e.finished = True
                e.finish_reason = rec.get("reason")
                if isinstance(rec.get("phases"), dict):
                    e.phases = dict(rec["phases"])
        else:
            self.skipped += 1


def read_journal(path: str) -> JournalImage:
    """Sequentially replay a journal file into a :class:`JournalImage`.
    Tolerates the crash shapes by construction: a missing file is an
    empty image; a torn tail (short frame, short payload, CRC mismatch,
    absurd length) stops the replay at the last durable record."""
    image = JournalImage()
    try:
        f = open(path, "rb")
    except FileNotFoundError:
        return image
    with f:
        if f.read(len(MAGIC)) != MAGIC:
            image.torn = True  # not a journal (or a torn first write)
            return image
        while True:
            head = f.read(_FRAME.size)
            if len(head) < _FRAME.size:
                image.torn = len(head) > 0
                return image
            crc, n = _FRAME.unpack(head)
            if n > MAX_RECORD_BYTES:
                image.torn = True
                return image
            payload = f.read(n)
            if len(payload) < n or zlib.crc32(payload) != crc:
                image.torn = True
                return image
            try:
                rec = json.loads(payload)
            except ValueError:
                image.torn = True  # CRC passed but not JSON: foreign data
                return image
            image.records += 1
            image.apply(rec)


def _durable_end(path: str) -> int | None:
    """Byte offset just past the last durable frame, or ``None`` when
    the file does not start with the journal magic. The writer truncates
    a reopened journal here BEFORE appending: frames appended after a
    crash-torn tail would sit behind the tear, where no reader (which
    stops at the first bad frame) could ever see them."""
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            return None
        off = len(MAGIC)
        while True:
            head = f.read(_FRAME.size)
            if len(head) < _FRAME.size:
                return off
            crc, n = _FRAME.unpack(head)
            if n > MAX_RECORD_BYTES:
                return off
            payload = f.read(n)
            if len(payload) < n or zlib.crc32(payload) != crc:
                return off
            off += _FRAME.size + n


class RequestJournal:
    """Append-only journal with a background writer thread.

    The record_* methods enqueue under ``_lock`` and return immediately;
    the writer drains batches, frames them (CRC32 + length prefix) and
    writes outside any lock. ``flush()`` blocks until everything
    enqueued so far is on disk (fsync'd when ``fsync=True``); ``close()``
    flushes and joins the writer. Write failures are contained: counted
    in ``journal_errors`` (surfaced on ``/stats`` via the scheduler),
    the failing batch is dropped, serving continues.
    """



    def __init__(self, path: str, progress_every: int = 8,
                 fsync: bool = True):
        if progress_every < 1:
            raise ValueError("progress_every must be >= 1")
        self.path = path
        self.progress_every = int(progress_every)
        self.fsync = bool(fsync)
        self._lock = make_lock("RequestJournal._lock")
        self._cv = threading.Condition(self._lock)
        self._j_pending: list[dict] = []
        self._j_seq = 0  # records ever enqueued
        self._j_written_seq = 0  # records written (or dropped on error)
        self._j_closed = False
        self._j_records = 0  # records durably written
        self._j_bytes = 0
        self._j_errors = 0  # contained write failures (batches lost)
        self._j_dropped = 0  # records shed at MAX_PENDING
        # per-request last-journaled watermark (rate-limits progress
        # records to one per `progress_every` delivered tokens)
        self._j_progress_mark: dict[int, int] = {}
        # open (and stamp) the file up front so a bad path fails the
        # operator at startup, not the writer thread mid-serving
        new = not os.path.exists(path) or os.path.getsize(path) == 0
        if not new:
            end = _durable_end(path)
            if end is None:
                raise ValueError(
                    f"{path} exists but is not a request journal "
                    "(bad magic) — refusing to append"
                )
            if end < os.path.getsize(path):
                # crash-torn tail from the previous generation: cut it
                # off before appending, or every record this process
                # writes lands behind the tear and is unreadable forever
                with open(path, "r+b") as tf:
                    tf.truncate(end)
        self._file = open(path, "ab")
        if new:
            self._file.write(MAGIC)
            self._file.flush()
        self._thread = threading.Thread(
            target=self._writer, name="journal-writer", daemon=True
        )
        self._thread.start()

    # -- producer side (scheduler / HTTP threads) ---------------------------

    def record_admit(self, *, request_id: int, prompt: str,
                     tokens: list[int], max_tokens: int, temperature: float,
                     topp: float, seed: int, stop: list[str], add_bos: bool,
                     add_special_tokens: bool, user: str | None,
                     priority: int,
                     queue_timeout_s: float | None, budget_s: float | None,
                     stream: bool, kind: str | None = None,
                     response_format: dict | None = None,
                     trace: str | None = None) -> None:
        """One admitted request, with the RESOLVED seed — everything a
        deterministic replay needs to regenerate the identical stream."""
        with self._lock:
            # seed the progress mark: note_progress only advances marks
            # that exist, so a pump delivering a tail delta AFTER the
            # finish record popped the mark cannot resurrect the entry
            # (a per-request leak plus a spurious post-finish record)
            self._j_progress_mark.setdefault(int(request_id), 0)
        self._enqueue(admit_record(
            request_id=request_id, prompt=prompt, tokens=tokens,
            max_tokens=max_tokens, temperature=temperature, topp=topp,
            seed=seed, stop=stop, add_bos=add_bos,
            add_special_tokens=add_special_tokens, user=user,
            priority=priority, queue_timeout_s=queue_timeout_s,
            budget_s=budget_s, stream=stream, kind=kind,
            response_format=response_format, trace=trace,
        ))

    def note_progress(self, request_id: int, tokens_delivered: int) -> None:
        """Advance a request's delivery watermark. Called AFTER a delta
        was handed to the client transport (the HTTP pump / resume
        relay). NOTE: "handed to the transport" means written to the
        socket, not received — a crash can strand written deltas in the
        kernel send buffer, so the watermark may sit AHEAD of the
        client's true position. It is a progress/diagnostics floor
        (``recovery_replayed_tokens``), never a license to discard
        replayed deltas on recovery (serving/recovery.py re-buffers from
        0 and lets ``Last-Event-ID`` pick the resume point).
        Rate-limited: one record per ``progress_every`` tokens."""
        with self._lock:
            last = self._j_progress_mark.get(int(request_id))
            if last is None:
                # finished (record_finish popped the mark) or never
                # admitted: late pump deliveries journal nothing
                return
            if tokens_delivered - last < self.progress_every:
                return
            self._j_progress_mark[int(request_id)] = int(tokens_delivered)
        self._enqueue({
            "k": "progress", "id": int(request_id),
            "n": int(tokens_delivered),
        })

    def record_finish(self, request_id: int, reason: str | None,
                      phases: dict | None = None) -> None:
        """The finish record; ``phases`` (when the scheduler hands one)
        is the per-request latency attribution dict — journaled so
        post-mortem analysis of a crashed window has the same phase
        numbers the completion response carried."""
        with self._lock:
            self._j_progress_mark.pop(int(request_id), None)
        rec = {"k": "finish", "id": int(request_id), "reason": reason}
        if phases:
            rec["phases"] = dict(phases)
        self._enqueue(rec)

    def _enqueue(self, rec: dict) -> None:
        with self._cv:
            if self._j_closed:
                self._j_dropped += 1
                return
            if len(self._j_pending) >= MAX_PENDING:
                self._j_dropped += 1
                return
            self._j_pending.append(rec)
            self._j_seq += 1
            self._cv.notify_all()

    # -- writer thread -------------------------------------------------------

    def _writer(self) -> None:
        while True:
            with self._cv:
                while not self._j_pending and not self._j_closed:
                    self._cv.wait(0.5)
                batch = self._j_pending
                self._j_pending = []
                closed = self._j_closed
                if not batch and closed:
                    self._cv.notify_all()
                    return
            n_written, n_bytes, failed = self._write_batch(batch)
            with self._cv:
                self._j_written_seq += len(batch)
                self._j_records += n_written
                self._j_bytes += n_bytes
                if failed:
                    self._j_errors += 1
                self._cv.notify_all()

    def _write_batch(self, batch: list[dict]) -> tuple[int, int, bool]:
        """Frame and write one batch — file I/O outside any lock. A raise
        (real ENOSPC or the ``journal.write`` fault point) is contained:
        the batch is dropped and counted, serving never sees it."""
        buf = bytearray()
        for rec in batch:
            payload = json.dumps(rec, separators=(",", ":")).encode()
            buf += _FRAME.pack(zlib.crc32(payload), len(payload))
            buf += payload
        try:
            faults.fire("journal.write")
            self._file.write(buf)
            self._file.flush()
            if self.fsync:
                os.fsync(self._file.fileno())
        except Exception:  # noqa: BLE001 — journaling degrades, never kills
            return 0, 0, True
        return len(batch), len(buf), False

    # -- lifecycle -----------------------------------------------------------

    def flush(self, timeout: float | None = 10.0) -> bool:
        """Block until every record enqueued before this call is written
        (or dropped by a contained error). True when the barrier was
        reached within ``timeout``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            target = self._j_seq
            while self._j_written_seq < target:
                remaining = (
                    None if deadline is None
                    else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining)
        return True

    def close(self, timeout: float | None = 10.0) -> None:
        """Flush, stop the writer, close the file. Idempotent."""
        with self._cv:
            self._j_closed = True
            self._cv.notify_all()
        self._thread.join(timeout)
        try:
            self._file.close()
        except Exception:  # noqa: BLE001 — shutdown must not throw
            pass

    def stats(self) -> dict:
        """Journal counters for /stats (one lock hold); bridged to
        /metrics as dllama_stats_journal_* gauges plus the delta-fed
        dllama_journal_records_total counter."""
        with self._lock:
            return {
                "journal_records": self._j_records,
                "journal_bytes": self._j_bytes,
                "journal_errors": self._j_errors,
                "journal_dropped": self._j_dropped,
                "journal_pending": len(self._j_pending),
                # admits whose finish record has not landed yet: the
                # leak witness's journal-mark gauge — after a clean
                # scheduler stop every admitted request finished, so a
                # non-zero count is a record_admit whose record_finish
                # lost an exit path (analysis/leakcheck.py)
                "journal_open_marks": len(self._j_progress_mark),
            }
