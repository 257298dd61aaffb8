"""Runtime resource-leak witness (``DLLAMA_LEAKCHECK=1``), the port's copy
of the JAX package's ``analysis/leakcheck.py``.

Owners of lifecycle state call :func:`check_drained` at their natural
drain points with their authoritative live counts (no shadow counters to
drift):

- ``ContinuousBatchingScheduler.stop()``: after the loop thread joins and
  ``_resolve_exit`` has settled every lane, live session-mirror records,
  open journal progress marks and, on a paged engine, lane-held KV pages
  (``pool_pages_in_use``, which counts the pages some lane maps: parked
  sessions' pages stay resident at rest and are not lane pages) and
  staged swap-outs no drain took (``pool_swap_pending``) must all be zero;
- ``StreamRegistry.close()``: entries whose request future never resolved
  are orphans nothing can ever reap.

Every call updates the process-wide ``resources_live{kind}`` gauge
snapshot and, when something is still held, bumps
``resource_leaks_total``; both surface on ``/stats`` and bridge to
``/metrics`` (telemetry/hub.py). With the witness enabled
(``DLLAMA_LEAKCHECK=1`` or :func:`force`) a non-zero count also raises
:class:`ResourceLeak` out of the drain call: a stack trace at the stop
that stranded the resource. Counting is always on (one dict merge per
drain; drains are rare); only the raise is opt-in. Pure stdlib.
"""

from __future__ import annotations

import os

from ..lockcheck import make_lock

ENV_FLAG = "DLLAMA_LEAKCHECK"

_forced: bool | None = None
# guards the witness state below; never held around foreign locks (the
# caller computed its counts before calling in)
_lock = make_lock("leakcheck._lock")
_live: dict[str, int] = {}  # last observed live count per resource kind
_leaks_total = 0  # process lifetime: resources still held at a drain
_checks = 0  # drain points witnessed
_last_leak: dict | None = None  # {"where": ..., "leaked": {...}} diagnostics


class ResourceLeak(AssertionError):
    """A drain point finished with resources still held. AssertionError on
    purpose (the witness convention): a leak at drain is a failed
    invariant, an acquire whose release lost an exit path, not an
    operational error to catch and retry."""


def enabled() -> bool:
    """Strict mode: raise at a leaking drain (the counters run
    regardless)."""
    if _forced is not None:
        return _forced
    return os.environ.get(ENV_FLAG, "") not in ("", "0")


def force(value: bool | None, fresh: bool = True) -> None:
    """Test hook: override the env flag (None restores it). ``fresh`` zeroes
    the counters so each test starts from a clean witness."""
    global _forced, _leaks_total, _checks, _last_leak
    _forced = value
    if fresh:
        with _lock:
            _leaks_total = 0
            _checks = 0
            _last_leak = None
            _live.clear()


def check_drained(where: str, counts: dict[str, int]) -> int:
    """Witness one drain point: ``counts`` maps resource kind to the owner's
    authoritative live count, which a clean drain leaves at zero. Returns
    the number of leaked resources (and raises it in strict mode)."""
    global _leaks_total, _checks, _last_leak
    counts = {str(k): int(v) for k, v in counts.items()}
    leaked = {k: v for k, v in counts.items() if v > 0}
    total = sum(leaked.values())
    with _lock:
        _checks += 1
        _live.update(counts)
        if leaked:
            _leaks_total += total
            _last_leak = {"where": where, "leaked": dict(leaked)}
    if leaked and enabled():
        raise ResourceLeak(
            f"{total} resource(s) still held after {where}: {leaked}: an "
            f"acquire lost its release on some exit path (fix it rather than "
            f"disabling {ENV_FLAG})"
        )
    return total


def leaks_total() -> int:
    """Process-lifetime count of resources found held at drain points."""
    with _lock:
        return _leaks_total


def live_counts() -> dict[str, int]:
    """Last witnessed live count per kind (a gauge snapshot, updated at
    every drain point, clean ones included)."""
    with _lock:
        return dict(_live)


def last_leak() -> dict | None:
    with _lock:
        return dict(_last_leak) if _last_leak is not None else None


def stats() -> dict:
    """The /stats surface (server/http.py merges this; telemetry/hub.py
    bridges ``resources_live`` as a labelled gauge and delta-feeds
    ``resource_leaks_total`` into its native counter)."""
    with _lock:
        return {
            "resource_leaks_total": _leaks_total,
            "resource_drain_checks": _checks,
            "resources_live": dict(_live),
        }
