"""Runtime recompile witness (``DLLAMA_JITCHECK=1``), the port's form of
the JAX package's ``analysis/jitcheck.py``.

The JAX witness listens to XLA's backend-compile events. The port compiles
no programs: its decode families run as CUDA graphs (``runtime/graphs.py``),
and what a post-warmup compile is to the JAX server a graph captured after
warmup is here, a step that stalls while its body is recorded. So
``StepGraphs`` reports every capture to :func:`note_capture`:

- ``warming()``: ``warmup_engine`` wraps its body in this context, so
  warmup's own captures (of any engine in the process; tests build
  several) never count against an armed witness;
- ``arm(owner)``: ``StepGraphs.mark_warm`` arms the witness for its graphs
  once warmup is over. From there every capture of that owner counts (the
  owner's ``captures_after_warmup``, ``/stats``
  ``jit_compiles_after_warmup``, ``dllama_jit_compiles_total`` on
  ``/metrics``), and with the witness enabled (``DLLAMA_JITCHECK=1`` or
  :func:`force`) also raises :class:`RecompileAfterWarmup` out of the step
  that captured: a stack trace at the call that met an unwarmed family.

Counting is always on once armed (one call per capture, none per replay);
only the raise is opt-in. Pure stdlib.
"""

from __future__ import annotations

import contextlib
import os
import weakref

from ..lockcheck import make_lock

ENV_FLAG = "DLLAMA_JITCHECK"

_forced: bool | None = None
# guards the registry below; never held around a caller's own lock
_lock = make_lock("jitcheck._lock")
_pause_depth = 0
_armed = False
_sinks: list = []  # weakrefs to armed graph owners
_total_compiles = 0  # process lifetime: every capture, warmup included


class RecompileAfterWarmup(AssertionError):
    """A decode graph was captured after warmup. AssertionError on purpose
    (the lock witness's convention): the witness is a test-time oracle and
    a capture mid-serving is a failed invariant, an unwarmed family or
    horizon, not an operational error to catch and retry."""


def enabled() -> bool:
    """Strict mode: raise on post-warmup captures (the counter runs
    regardless once armed)."""
    if _forced is not None:
        return _forced
    return os.environ.get(ENV_FLAG, "") not in ("", "0")


def force(value: bool | None, fresh: bool = True) -> None:
    """Test hook: override the env flag (None restores it). ``fresh``
    disarms and drops the armed owners so the next ``arm`` starts clean."""
    global _forced, _armed
    _forced = value
    if fresh:
        with _lock:
            _armed = False
            _sinks.clear()


def note_capture(owner) -> bool:
    """One graph captured by ``owner`` (a ``StepGraphs``). Returns True when
    it counts as a capture after warmup; raises it in strict mode."""
    global _total_compiles
    with _lock:
        _total_compiles += 1
        if _pause_depth > 0 or not _armed:
            return False
        if not any(ref() is owner for ref in _sinks):
            return False
    if enabled():
        raise RecompileAfterWarmup(
            "a decode graph was captured after warmup: an unwarmed family or "
            "horizon; the step that met it is in this stack. Warm it in "
            f"warmup_engine rather than disabling {ENV_FLAG}."
        )
    return True


@contextlib.contextmanager
def warming():
    """Suppress counting and raising for the duration (re-entrant):
    ``warmup_engine`` captures on purpose, and one engine's warmup must not
    fire another engine's armed witness in the same process."""
    global _pause_depth
    with _lock:
        _pause_depth += 1
    try:
        yield
    finally:
        with _lock:
            _pause_depth -= 1


def arm(owner) -> None:
    """Start witnessing ``owner``'s captures. Idempotent per object; owners
    are held weakly, so dead engines cost nothing."""
    global _armed
    with _lock:
        _armed = True
        _sinks[:] = [r for r in _sinks if r() is not None]
        if not any(r() is owner for r in _sinks):
            _sinks.append(weakref.ref(owner))


def armed() -> bool:
    with _lock:
        return _armed


def total_compiles() -> int:
    """Process-lifetime capture count, warmup's included."""
    with _lock:
        return _total_compiles
