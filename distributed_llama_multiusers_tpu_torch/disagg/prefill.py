"""The prefill-worker contract + hand-off orchestration.

A prefill-role replica is an ordinary serving replica (``ApiServer`` with
``role="prefill"``) — what makes it a prefill WORKER is how the router
drives it: a long-classified request is forwarded whole, the replica runs
its normal bounded-chunk prefill (the scheduler's chunked admission — no
new device programs), and the FIRST streamed delta is the proof that
prefill completed and the prompt's full blocks are committed to the
replica's paged pool (``_paged_commit`` registers them incrementally as
the chunks land). At that point :func:`hand_off` moves the session to a
decode replica:

1. fetch the migration ticket (``GET /admin/session/<id>`` — the journal's
   admit record: prompt tokens, RESOLVED seed, params, watermark);
2. fetch the KV-page bundle (``GET /admin/kvpages/<id>``,
   :mod:`.kvtransfer`'s integrity-hashed export);
3. push the bundle to the decode replica (``POST /admin/kvimport`` —
   verify + adopt + import, refcount-correct);
4. inject the ticket (``POST /admin/migrate`` — deterministic replay;
   the decode replica's admission finds the adopted prefix in its tree
   and refcount-shares it, so the "re-prefill" is tail-only);
5. reattach the stream (``GET /v1/stream/<id>`` from event 0 — the
   router's ``skip_chars`` dedup makes the client stream char-exact
   across the hand-off).

The prefill replica keeps decoding (and streaming to the client) for the
whole transfer window, so a hand-off that aborts at ANY step degrades to
the monolithic path by doing nothing: the router keeps pumping the
original stream. That is why every failure here is the typed
:class:`HandoffAborted`, never a hung stream — the caller's except arm
IS the fallback.

Pure stdlib; ``fleet.migrate`` is imported lazily inside
:func:`hand_off` (the router imports this module, and the fleet package
re-exports the router — a top-level import would cycle).
"""

from __future__ import annotations

import http.client

from .kvtransfer import KVTransferError  # noqa: F401  (re-export surface)

DEFAULT_TIMEOUT_S = 10.0
# the prompt-length routing knob: at/above this many prompt chars a
# request classifies "long" and routes to a prefill-role replica. ~8k
# chars ≈ a couple thousand tokens — the point where one prompt's
# prefill visibly taxes co-resident decode TBT on a shared replica.
DEFAULT_LONG_PROMPT_CHARS = 8000

_TRANSPORT_ERRORS = (OSError, http.client.HTTPException)


class HandoffAborted(RuntimeError):
    """Typed hand-off failure (any step: ticket, pages, import, inject,
    reattach). The session is still live on the prefill replica — the
    router's fallback is to keep the original stream (monolithic path),
    so the client sees continued output, never a hang."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"disagg hand-off aborted ({reason})"
                         + (f": {detail}" if detail else ""))


def prompt_chars(body: dict) -> int:
    """Prompt length in characters for either API shape: completions
    ``prompt`` (str or list of str) or chat ``messages`` content — the
    same text the router's affinity key hashes, counted instead."""
    p = body.get("prompt")
    if isinstance(p, str):
        return len(p)
    if isinstance(p, list):
        return sum(len(x) for x in p if isinstance(x, str))
    msgs = body.get("messages")
    total = 0
    if isinstance(msgs, list):
        for m in msgs:
            c = m.get("content") if isinstance(m, dict) else None
            if isinstance(c, str):
                total += len(c)
    return total


def classify_prompt(body: dict,
                    threshold_chars: int = DEFAULT_LONG_PROMPT_CHARS) -> str:
    """``"long"`` (route to a prefill-role replica) or ``"short"``
    (least-loaded / affinity as today). A non-positive threshold
    disables disagg routing: everything classifies short."""
    if threshold_chars <= 0:
        return "short"
    return "long" if prompt_chars(body) >= threshold_chars else "short"


def fetch_pages(host: str, port: int, request_id: int,
                timeout: float = DEFAULT_TIMEOUT_S,
                trace: str | None = None) -> dict | None:
    """GET the session's KV-page bundle off the prefill replica.
    ``None`` when the replica has nothing to ship (contiguous engine,
    session already finished, or an error reply) — the hand-off then
    degrades to ticket-only migration, which re-prefills on the decode
    replica. Mirrors ``fleet.migrate.fetch_ticket``'s shape."""
    from ..fleet.migrate import _request_json

    try:
        status, body, _ = _request_json(
            host, port, "GET", f"/admin/kvpages/{int(request_id)}",
            timeout=timeout, trace=trace,
        )
    except _TRANSPORT_ERRORS:
        return None
    if status != 200 or not isinstance(body, dict) or "blocks" not in body:
        return None
    return body


def push_pages(host: str, port: int, bundle: dict,
               timeout: float = DEFAULT_TIMEOUT_S,
               trace: str | None = None) -> dict:
    """POST a page bundle to the decode replica's ``/admin/kvimport``.
    Returns the adoption receipt (``{"pages", "fresh", "reused"}``).
    Raises :class:`HandoffAborted` on any non-200 — including the
    destination's typed 429 pool-exhausted shed and 422 integrity
    failures — so the caller's fallback arm fires."""
    from ..fleet.migrate import _request_json

    try:
        status, body, _ = _request_json(
            host, port, "POST", "/admin/kvimport", body=bundle,
            timeout=timeout, trace=trace,
        )
    except _TRANSPORT_ERRORS as e:
        raise HandoffAborted("import_transport",
                             f"{type(e).__name__}: {e}") from e
    if status != 200:
        reason = (body or {}).get("reason", f"http_{status}") \
            if isinstance(body, dict) else f"http_{status}"
        raise HandoffAborted("import_rejected", str(reason))
    return body if isinstance(body, dict) else {}


def hand_off(src_host: str, src_port: int, request_id: int,
             dst_host: str, dst_port: int,
             timeout: float = DEFAULT_TIMEOUT_S,
             read_timeout: float | None = None,
             trace: str | None = None):
    """Move a live session from the prefill replica (``src``) to the
    decode replica (``dst``). Returns ``(conn, resp, new_request_id,
    receipt)`` — the reattached SSE stream on the decode replica (from
    event 0; the caller dedups with its ``chars_out`` watermark) plus
    the page-adoption receipt. Raises :class:`HandoffAborted` on any
    failure; the session is then still live on ``src`` and the caller
    keeps the original stream (the monolithic fallback).

    ``timeout`` bounds every admin exchange; ``read_timeout`` (default:
    same) bounds reads on the reattached stream, which waits on
    generation — callers pass their generation-length bound. ``trace``
    (the request's wire-form fleet trace context) rides every admin hop
    as ``X-DLlama-Trace``; the ticket's own ``trace`` field is what
    re-joins the decode-side session to the original trace."""
    from ..fleet.migrate import (
        MigrationShed,
        fetch_ticket,
        inject_session,
        open_stream,
    )

    ticket = fetch_ticket(src_host, src_port, request_id, timeout=timeout,
                          trace=trace)
    if ticket is None:
        raise HandoffAborted(
            "no_ticket",
            f"request {request_id} has no exportable session on the "
            "prefill replica (not admitted yet, or already finished)",
        )
    bundle = fetch_pages(src_host, src_port, request_id, timeout=timeout,
                         trace=trace)
    receipt = {"pages": 0, "fresh": 0, "reused": 0}
    if bundle is not None and bundle.get("blocks"):
        # pages BEFORE the ticket: adoption must be visible to the
        # decode replica's admission, or the migrated session prefills
        # from scratch and the transfer bought nothing
        receipt = push_pages(dst_host, dst_port, bundle, timeout=timeout,
                             trace=trace)
    try:
        injected = inject_session(dst_host, dst_port, ticket,
                                  timeout=timeout, trace=trace)
    except MigrationShed as e:
        raise HandoffAborted("decode_shed", str(e)) from e
    except _TRANSPORT_ERRORS as e:
        raise HandoffAborted("inject_transport",
                             f"{type(e).__name__}: {e}") from e
    except ValueError as e:
        raise HandoffAborted("inject_rejected", str(e)) from e
    new_rid = int(injected.get("request_id", request_id))
    try:
        conn, resp = open_stream(
            dst_host, dst_port, new_rid, last_event_id=0,
            timeout=timeout if read_timeout is None else read_timeout,
            connect_timeout=timeout,
        )
    except _TRANSPORT_ERRORS as e:
        raise HandoffAborted("reattach_transport",
                             f"{type(e).__name__}: {e}") from e
    except ValueError as e:
        raise HandoffAborted("reattach_rejected", str(e)) from e
    return conn, resp, new_rid, receipt
