"""Runtime lock-order witness (``DLLAMA_LOCKCHECK=1``).

Every shared lock of the serving layers is built through
:func:`make_lock`, which returns a plain ``threading.Lock`` in production
(the witness costs nothing unless asked for) and a :class:`WitnessLock`
when the check is on. The wrapper records per-thread acquisition chains
and, before every blocking acquire, asserts that the acquisition respects
the order observed so far:

- every observed "A held while acquiring B" adds an edge, so the first
  acquire that inverts an established order raises
  :class:`LockOrderViolation`, without a second thread or a racy schedule;
- re-acquiring a held non-reentrant lock raises instead of deadlocking.

Witness names are class-qualified ids (``make_lock("QosQueue._lock")``).
``threading.Condition`` built over a wrapped lock works unchanged (the
condition acquires and releases through the wrapper, so waits keep the
per-thread chain honest).

Enable through the environment (``DLLAMA_LOCKCHECK=1`` before the process
starts) or through :func:`force` from a test; only locks constructed after
enabling are wrapped. Pure stdlib.
"""

from __future__ import annotations

import os
import threading

ENV_FLAG = "DLLAMA_LOCKCHECK"

_forced: bool | None = None
_witness: "LockWitness | None" = None
_witness_guard = threading.Lock()


class LockOrderViolation(AssertionError):
    """An acquisition that contradicts the established lock order (or
    re-enters a held non-reentrant lock). AssertionError on purpose:
    the witness is a test-time oracle, and a violation is a failed
    invariant, not an operational error to catch and retry."""


class LockWitness:
    """Order oracle shared by every wrapped lock in the process."""

    def __init__(self):
        self._graph_lock = threading.Lock()  # guards _after/_sites only
        self._after: dict[str, set[str]] = {}  # a -> {b}: a ordered before b
        self._sites: dict[tuple[str, str], str] = {}
        self._tls = threading.local()

    # -- order graph ---------------------------------------------------------

    def add_order(self, a: str, b: str, site: str = "runtime") -> None:
        """Record 'a before b' without checking (an already-validated
        runtime edge)."""
        with self._graph_lock:
            self._after.setdefault(a, set()).add(b)
            self._sites.setdefault((a, b), site)

    def _ordered_before(self, a: str, b: str) -> list[str] | None:
        """Path a ⇝ b in the order graph (meaning a is ordered before b),
        as the node list, else None. Called with _graph_lock held."""
        stack = [(a, [a])]
        seen = {a}
        while stack:
            node, path = stack.pop()
            for nxt in self._after.get(node, ()):
                if nxt == b:
                    return path + [b]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def order_snapshot(self) -> dict[str, set[str]]:
        with self._graph_lock:
            return {a: set(bs) for a, bs in self._after.items()}

    # -- per-thread chain ----------------------------------------------------

    def _stack(self) -> list[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def held(self) -> tuple[str, ...]:
        return tuple(self._stack())

    def on_acquire(self, name: str) -> None:
        """Validate and record a blocking acquire of ``name``; raises
        BEFORE the caller blocks, so an ordering bug is a stack trace at
        the guilty acquire instead of a hung process."""
        stack = self._stack()
        if name in stack:
            raise LockOrderViolation(
                f"re-acquisition of non-reentrant lock '{name}' "
                f"(chain: {' -> '.join(stack)}) would deadlock this thread"
            )
        for holder in stack:
            with self._graph_lock:
                path = self._ordered_before(name, holder)
                site = self._sites.get((name, holder)) if path else None
            if path is not None:
                raise LockOrderViolation(
                    f"lock-order inversion: acquiring '{name}' while "
                    f"holding '{holder}', but the established order is "
                    f"{' -> '.join(path)} (first established: {site}); "
                    f"this thread's chain: {' -> '.join(stack)} -> {name}"
                )
        for holder in stack:
            self.add_order(holder, name)
        stack.append(name)

    def push(self, name: str) -> None:
        """Record a non-blocking acquire that succeeded (no order check:
        a try-acquire cannot deadlock, and Condition._is_owned probes
        held locks non-blockingly by design)."""
        self._stack().append(name)

    def pop(self, name: str) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return


class WitnessLock:
    """``threading.Lock`` stand-in that reports every acquire/release to
    the witness. Supports the full Lock protocol (and the subset
    ``threading.Condition`` uses), so it drops into
    ``Condition(make_lock(...))`` unchanged."""

    __slots__ = ("name", "_witness", "_inner")

    def __init__(self, name: str, witness: LockWitness):
        self.name = name
        self._witness = witness
        self._inner = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not blocking:
            got = self._inner.acquire(False)
            if got:
                self._witness.push(self.name)
            return got
        self._witness.on_acquire(self.name)  # raises on inversion; pushes
        got = self._inner.acquire(True, timeout)
        if not got:  # timed out: we never held it
            self._witness.pop(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        self._witness.pop(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "WitnessLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<WitnessLock {self.name} {self._inner!r}>"


# -- module surface ----------------------------------------------------------


def enabled() -> bool:
    if _forced is not None:
        return _forced
    return os.environ.get(ENV_FLAG, "") not in ("", "0")


def witness() -> LockWitness:
    """The process-wide witness, created on first use."""
    global _witness
    with _witness_guard:
        if _witness is None:
            _witness = LockWitness()
        return _witness


def make_lock(name: str):
    """The one lock constructor for declared shared locks: a plain
    ``threading.Lock`` unless the witness is enabled. ``name`` is the
    class-qualified id of the declaration site."""
    if not enabled():
        return threading.Lock()
    return WitnessLock(name, witness())


def force(value: bool | None, fresh: bool = True) -> None:
    """Test hook: override the env flag (None restores it). ``fresh``
    drops the current witness so the next wrapped lock starts from a
    clean order graph."""
    global _forced, _witness
    _forced = value
    if fresh:
        with _witness_guard:
            _witness = None
