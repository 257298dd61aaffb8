"""Live session migration, router side: ticket fetch, inject, reattach.

The client half of journal-based migration (the journal's deterministic
replay as a fleet primitive). The replica side lives in server/http.py:
``GET /admin/session/<id>`` exports a live session's admit wire record
(prompt tokens + RESOLVED seed + params + consumed-token watermark) and
``POST /admin/migrate`` feeds one into ``scheduler.build_recovered_request``
through normal breaker-gated admission. This module is what the router
does with those two endpoints:

1. **ticket** — at stream start the router fetches the session's export
   from the source replica and CACHES it. That is what makes replica
   DEATH migratable, not just graceful drains: when the source vanishes
   mid-stream there is nobody left to export from, but the ticket is
   already in hand.
2. **inject** — on a mid-stream break (socket died, typed shed chunk,
   drain force-cancel) the router posts the ticket to another replica,
   which regenerates the stream byte-identically from the same prompt
   tokens and the same resolved seed (the sampler's fold_in(seed, pos)
   draws).
3. **reattach** — ``GET /v1/stream/<id>`` with ``Last-Event-ID: 0``: the
   target's relay re-buffered the ENTIRE regenerated stream from base=0,
   and the router — which knows exactly how many characters its client
   has received — skips that many characters of the replayed text and
   forwards the rest. Character-level dedup makes the migrated stream
   byte-identical BY CONSTRUCTION, zero lost and zero duplicated, even
   when the source's force-cancel flushed held-back tail text whose
   delta indices no longer line up with the regenerated stream's.

Pure stdlib (http.client); no torch, no numpy.
"""

from __future__ import annotations

import http.client
import json

from ..telemetry.tracectx import TRACE_HEADER

DEFAULT_TIMEOUT_S = 10.0


class MigrationShed(RuntimeError):
    """The migration target shed the inject (breaker open / queue full /
    draining / pool exhausted): carries the typed reason + Retry-After
    hint so the router can honor it and try the next replica."""

    def __init__(self, reason: str, retry_after_s: float, status: int):
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.status = status
        super().__init__(
            f"migration target shed ({reason}, HTTP {status}); "
            f"retry in ~{retry_after_s:.0f}s"
        )


def _request_json(host: str, port: int, method: str, path: str,
                  body: dict | None = None,
                  timeout: float = DEFAULT_TIMEOUT_S,
                  trace: str | None = None):
    """One JSON exchange; returns ``(status, parsed_body, headers)``.
    Raises ``OSError``/``http.client.HTTPException`` on transport
    failure — the caller's signal to mark the replica dead. ``trace``
    (the wire-form context) rides as ``X-DLlama-Trace`` so the admin
    hop itself is attributable to the request's fleet trace."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        payload = None if body is None else json.dumps(body).encode()
        headers = {"Content-Type": "application/json"} if payload else {}
        if trace:
            headers[TRACE_HEADER] = str(trace)
        conn.request(method, path, body=payload, headers=headers)
        resp = conn.getresponse()
        raw = resp.read()
        try:
            parsed = json.loads(raw) if raw else {}
        except ValueError:
            parsed = {}
        return resp.status, parsed, dict(resp.getheaders())
    finally:
        conn.close()


def fetch_ticket(host: str, port: int, request_id: int,
                 timeout: float = DEFAULT_TIMEOUT_S,
                 trace: str | None = None) -> dict | None:
    """Fetch a live session's migration ticket from its source replica.
    ``None`` when the session is unknown/already finished (a completed
    stream needs no ticket)."""
    status, body, _ = _request_json(
        host, port, "GET", f"/admin/session/{int(request_id)}",
        timeout=timeout, trace=trace,
    )
    if status != 200 or "seed" not in body:
        return None
    return body


def inject_session(host: str, port: int, ticket: dict,
                   timeout: float = DEFAULT_TIMEOUT_S,
                   trace: str | None = None) -> dict:
    """Hand a ticket to a migration target (``POST /admin/migrate``).
    Returns the target's answer (``request_id`` — the ORIGINAL id, the
    reattach key — and ``stream_path``). Raises :class:`MigrationShed`
    on a typed 429/503 and ``ValueError`` on a non-retryable refusal
    (bad record / missing resume registry). The ticket's own ``trace``
    field (the admit wire record carries it) is what re-joins the
    REGENERATED stream to the original fleet trace; ``trace`` here only
    attributes the inject hop itself."""
    status, body, headers = _request_json(
        host, port, "POST", "/admin/migrate", body=ticket, timeout=timeout,
        trace=trace,
    )
    if status == 200:
        return body
    if status in (429, 503):
        try:
            retry = float(headers.get("Retry-After", 1.0))
        except (TypeError, ValueError):
            retry = 1.0
        raise MigrationShed(
            str(body.get("reason", "shed")), retry, status
        )
    raise ValueError(
        f"migration target refused (HTTP {status}): "
        f"{body.get('error', 'unknown error')}"
    )


def open_stream(host: str, port: int, request_id: int,
                last_event_id: int = 0,
                timeout: float = DEFAULT_TIMEOUT_S,
                connect_timeout: float = DEFAULT_TIMEOUT_S):
    """Reattach to a migrated (or live) stream: returns the open
    ``(connection, response)`` pair for ``GET /v1/stream/<id>`` — the
    caller pumps the SSE body and must close the connection. Two-phase
    timeout like the router's forwards: a short ``connect_timeout`` (a
    lingering dead listener must fail fast) then the generation-length
    ``timeout`` on the body. Raises ``ValueError`` on a non-200
    (unknown id / expired grace window)."""
    conn = http.client.HTTPConnection(host, port, timeout=connect_timeout)
    try:
        conn.connect()
        conn.sock.settimeout(timeout)
        conn.request(
            "GET", f"/v1/stream/{int(request_id)}",
            headers={"Last-Event-ID": str(int(last_event_id))},
        )
        resp = conn.getresponse()
    except BaseException:
        conn.close()
        raise
    if resp.status != 200:
        body = resp.read()
        conn.close()
        raise ValueError(
            f"stream reattach refused (HTTP {resp.status}): {body[:200]!r}"
        )
    return conn, resp
