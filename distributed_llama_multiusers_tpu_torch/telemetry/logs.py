"""Structured one-line JSON logs: startup config and per-request summary.

Deployments grep these, log pipelines parse them, and traces correlate
with them by ``request_id`` — so every line is a
single JSON object on stderr (never stdout: the CLI prints generated
text there) with a fixed envelope:

    {"event": "...", "ts": <unix seconds>, "mono_s": <monotonic>, ...}

``ts`` is the one wall-clock read in the telemetry package — an
absolute timestamp leaving the process, the same category as the API
``created`` fields; everything that measures a *duration* uses the
monotonic fields.
"""

from __future__ import annotations

import json
import sys
import time

from ..lockcheck import make_lock


class JsonLogger:
    """One JSON object per line to ``stream`` (default stderr). A module
    lock serializes lines so concurrent HTTP threads never interleave
    bytes mid-record."""

    def __init__(self, stream=None):
        self.stream = stream
        # witness-wrappable (DLLAMA_LOCKCHECK=1, lockcheck.py)
        self._log_lock = make_lock("JsonLogger._log_lock")

    def emit(self, event: str, **fields) -> None:
        rec = {
            "event": event,
            "ts": round(time.time(), 3),
            "mono_s": round(time.monotonic(), 6),
        }
        rec.update(fields)
        line = json.dumps(rec, default=str)
        stream = self.stream if self.stream is not None else sys.stderr
        with self._log_lock:
            try:
                print(line, file=stream, flush=True)
            except (ValueError, OSError):
                pass  # closed stream at interpreter teardown: drop the line


_DEFAULT = JsonLogger()


def default_logger() -> JsonLogger:
    return _DEFAULT


def log_event(event: str, **fields) -> None:
    """Emit on the process-default logger (startup lines from code that
    has no Telemetry instance in hand, e.g. ``warmup_engine``)."""
    _DEFAULT.emit(event, **fields)
