"""Chrome trace-event export: the span ring as a Perfetto-loadable JSON.

Output is the Trace Event Format's JSON-object form
(``{"traceEvents": [...], "displayTimeUnit": "ms"}``) using only the
parts every viewer (chrome://tracing, ui.perfetto.dev) honours:

- one process (pid 1, named for the model/server),
- one *thread* per logical track — ``lane0..laneN`` (requests pinned to
  their KV lane), ``pipeline`` (per-dispatch step slices), ``queue``
  (submit→admit waits) — named via ``M``/``thread_name`` metadata and
  ordered via ``thread_sort_index``,
- ``X`` complete events (``ts``+``dur`` in µs) for spans,
- ``i`` thread-scoped instants for admissions, finishes, flushes.

Fused prefill+decode dispatches render as ``step.fused`` slices on the
``pipeline`` track (plus a ``prefill.fused`` slice on the admitting
lane's track), so "did the admission actually ride the chain" is a thing
you *see*, not infer from counters.
"""

from __future__ import annotations

import json
from typing import Iterable

from .spans import SpanEvent, SpanTracer

PROCESS_NAME = "dllama-serving"


def _track_order(track: str) -> tuple:
    """Stable display order: lanes first (numeric), then pipeline, queue,
    then anything else alphabetically."""
    if track.startswith("lane"):
        suffix = track[4:]
        if suffix.isdigit():
            return (0, int(suffix), track)
    return ({"pipeline": 1, "queue": 2}.get(track, 3), 0, track)


def chrome_trace(events: Iterable[SpanEvent], origin: float = 0.0) -> dict:
    """Render span events into a Chrome trace-event JSON object.

    ``origin`` (the tracer's perf_counter epoch) rebases timestamps so
    the trace starts near t=0; event ``ts``/``dur`` come out in µs as the
    format requires."""
    events = list(events)
    tracks = sorted({e.track for e in events}, key=_track_order)
    tids = {t: i + 1 for i, t in enumerate(tracks)}
    # metadata events carry ts 0: the format ignores it, and a uniform
    # required-field set (name/ph/pid/tid/ts) keeps consumers simple
    out: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": 1, "tid": 0, "ts": 0,
        "args": {"name": PROCESS_NAME},
    }]
    for track, tid in tids.items():
        out.append({
            "name": "thread_name", "ph": "M", "pid": 1, "tid": tid, "ts": 0,
            "args": {"name": track},
        })
        out.append({
            "name": "thread_sort_index", "ph": "M", "pid": 1, "tid": tid,
            "ts": 0, "args": {"sort_index": tid},
        })
    for e in events:
        args = dict(e.args) if e.args else {}
        if e.req_id is not None:
            args.setdefault("request_id", e.req_id)
        if e.seq:
            # the poller cursor rides each event too, so a consumer can
            # resume from any event it already holds, not just the
            # response-level "cursor" field
            args.setdefault("seq", e.seq)
        rec = {
            "name": e.name,
            "ph": e.ph,
            "pid": 1,
            "tid": tids[e.track],
            "ts": round((e.ts - origin) * 1e6, 3),
            "args": args,
        }
        if e.ph == "X":
            rec["dur"] = round(e.dur * 1e6, 3)
        elif e.ph == "i":
            rec["s"] = "t"  # thread-scoped instant
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def tracer_chrome_trace(tracer: SpanTracer, since: int = 0,
                        trace_id: str | None = None) -> dict:
    """Render the tracer's window; ``since``/``trace_id`` filter the ring
    (incremental polling and per-trace extraction). The returned
    doc carries a top-level ``cursor`` — pass it back as ``since=`` to get
    only newer events; viewers ignore unknown top-level keys."""
    events = tracer.snapshot(since=since, trace_id=trace_id)
    doc = chrome_trace(events, origin=tracer.origin)
    doc["cursor"] = events[-1].seq if events else since
    return doc


FLEET_PROCESS_NAME = "dllama-fleet"


def merge_chrome_traces(parts: list) -> dict:
    """Merge per-process Chrome-trace docs into ONE fleet timeline.

    ``parts`` is ``[(source, doc, offset_us, uncertainty_us), ...]`` —
    ``source`` names the process (``router``, replica ids), ``doc`` is
    that process's ``chrome_trace`` output, and ``offset_us`` is the
    estimated clock offset to ADD to its timestamps to land them on the
    merge caller's timebase (each process's ``perf_counter`` has its own
    arbitrary origin). The correction is applied so the timeline lines
    up, and it is NOT silent: every migrated event's args carry
    ``clock_offset_us`` + ``clock_uncertainty_us`` (the RTT/2 error bound
    of the /load-scrape estimate), so a viewer can tell measured
    ordering from estimated alignment.

    Tracks come out as ``<source>/<track>`` rows — router queue next to
    the prefill replica's lane next to the decode replica's lane, the
    adjacency a merged fleet timeline is read by."""
    out: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": 1, "tid": 0, "ts": 0,
        "args": {"name": FLEET_PROCESS_NAME},
    }]
    merged: list[dict] = []
    tid_next = 1
    for source, doc, offset_us, uncertainty_us in parts:
        events = (doc or {}).get("traceEvents", [])
        track_names = {
            e.get("tid"): (e.get("args") or {}).get("name", "")
            for e in events
            if e.get("ph") == "M" and e.get("name") == "thread_name"
        }
        remap: dict = {}
        for e in events:
            if e.get("ph") == "M":
                continue
            old_tid = e.get("tid", 0)
            if old_tid not in remap:
                track = track_names.get(old_tid) or f"t{old_tid}"
                remap[old_tid] = tid_next
                out.append({
                    "name": "thread_name", "ph": "M", "pid": 1,
                    "tid": tid_next, "ts": 0,
                    "args": {"name": f"{source}/{track}"},
                })
                out.append({
                    "name": "thread_sort_index", "ph": "M", "pid": 1,
                    "tid": tid_next, "ts": 0,
                    "args": {"sort_index": tid_next},
                })
                tid_next += 1
            ne = dict(e)
            ne["pid"] = 1
            ne["tid"] = remap[old_tid]
            ne["ts"] = round(float(e.get("ts", 0.0)) + offset_us, 3)
            args = dict(e.get("args") or {})
            args["span_source"] = source
            args["clock_offset_us"] = round(float(offset_us), 1)
            args["clock_uncertainty_us"] = round(float(uncertainty_us), 1)
            ne["args"] = args
            merged.append(ne)
    merged.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": out + merged, "displayTimeUnit": "ms"}


def dump_chrome_trace(tracer: SpanTracer, path: str) -> dict:
    """Write the tracer's current window to ``path`` and return the
    rendered document."""
    doc = tracer_chrome_trace(tracer)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return doc
