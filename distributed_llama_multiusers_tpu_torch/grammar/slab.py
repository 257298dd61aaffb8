"""Grammar slab: the fixed-capacity host mirror of the device tables (the
JAX package's ``grammar/slab.py``, copied).

One slab per engine. State 0 is the FREE state — mask all-ones, default
target 0 — so unconstrained lanes flow through the identical compiled
math with a literal identity mask and the step families need no grammar
branch at all. Compiled automata install at a base offset (their local
states shift by ``base``); admissions of the same schema share the
installed range by refcount, releases park the range (LRU-evicted under
pressure) so schema churn does not re-upload tables.

Capacities are FIXED at construction: the device tables the engine
copies this mirror into keep one shape and one address forever, so a new
schema mid-serving changes their VALUES only — never a CUDA-graph
capture. A schema too
big for an empty slab raises :class:`~.automaton.GrammarError` (a 400);
a slab full of OTHER live schemas raises :class:`GrammarSlabFull`
(retryable load, the pool-exhausted shape).

Pure host numpy: the allocation, refcount and eviction bookkeeping is the
JAX slab's, op for op.
"""

from __future__ import annotations

import numpy as np

from .automaton import GrammarAutomaton, GrammarError

DEFAULT_SLAB_STATES = 1024
DEFAULT_SLAB_EDGES = 49152
_KEY_SENTINEL = np.iinfo(np.int32).max


class GrammarSlabFull(RuntimeError):
    """No contiguous free state range / edge capacity for a new grammar:
    load, not a bad schema — the scheduler sheds it retryably (the
    pool-exhausted 429 shape), never a 500."""


class SlabHandle:
    """One attached grammar: the automaton plus its slab base offset.
    Lane-facing mirror API works in ABSOLUTE slab state ids (what the
    device carry holds)."""

    def __init__(self, slab: "GrammarSlab", automaton: GrammarAutomaton,
                 base: int):
        self.slab = slab
        self.automaton = automaton
        self.base = base

    @property
    def key(self) -> str:
        return self.automaton.key

    @property
    def start_state(self) -> int:
        return self.base  # local start is 0

    def next_state(self, state: int, tok: int) -> int:
        return self.base + self.automaton.next_state(
            state - self.base, int(tok)
        )

    def is_legal(self, state: int, tok: int) -> bool:
        return self.automaton.is_legal(state - self.base, int(tok))

    def filter_prefix(self, state: int, tokens) -> int:
        return self.automaton.filter_prefix(state - self.base, tokens)


class _Entry:
    __slots__ = ("automaton", "base", "refs", "stamp")

    def __init__(self, automaton, base):
        self.automaton = automaton
        self.base = base
        self.refs = 0
        self.stamp = 0  # LRU tick of the last release


class GrammarSlab:
    def __init__(self, vocab_size: int,
                 n_states: int = DEFAULT_SLAB_STATES,
                 n_edges: int = DEFAULT_SLAB_EDGES):
        self.vocab_size = int(vocab_size)
        # device transition keys are int32 (state * vocab + token): shrink
        # the state capacity so the largest key always fits
        max_states = max(2, (2**31 - 1) // max(1, self.vocab_size))
        self.n_states = int(min(n_states, max_states))
        self.n_edges = int(n_edges)
        self.words = (self.vocab_size + 31) // 32
        self.masks = np.zeros((self.n_states, self.words), np.uint32)
        self.masks[0, :] = np.uint32(0xFFFFFFFF)  # FREE: everything legal
        self.default_next = np.zeros(self.n_states, np.int32)
        self.edge_keys = np.full(self.n_edges, _KEY_SENTINEL, np.int32)
        self.edge_next = np.zeros(self.n_edges, np.int32)
        self._entries: dict[str, _Entry] = {}
        self._free_ranges: list[tuple[int, int]] = [(1, self.n_states - 1)]
        self._tick = 0
        # bumped on every array change: the engine re-uploads the device
        # copies when its uploaded version falls behind
        self.version = 0

    # -- allocation ----------------------------------------------------------

    def _alloc(self, n: int) -> int | None:
        for i, (base, size) in enumerate(self._free_ranges):
            if size >= n:
                if size == n:
                    self._free_ranges.pop(i)
                else:
                    self._free_ranges[i] = (base + n, size - n)
                return base
        return None

    def _release_range(self, base: int, n: int) -> None:
        self._free_ranges.append((base, n))
        self._free_ranges.sort()
        merged: list[tuple[int, int]] = []
        for b, s in self._free_ranges:
            if merged and merged[-1][0] + merged[-1][1] == b:
                merged[-1] = (merged[-1][0], merged[-1][1] + s)
            else:
                merged.append((b, s))
        self._free_ranges = merged

    def _edges_used(self) -> int:
        return sum(
            len(e.automaton.edge_keys) for e in self._entries.values()
        )

    def _evict_parked(self, need_states: int, need_edges: int) -> None:
        """Drop refcount-0 entries (oldest release first) until the new
        grammar fits, or nothing parked remains."""
        while True:
            if (
                self._alloc_would_fit(need_states)
                and self._edges_used() + need_edges <= self.n_edges
            ):
                return
            parked = [
                (e.stamp, k) for k, e in self._entries.items() if e.refs == 0
            ]
            if not parked:
                return
            _, key = min(parked)
            self._remove(key)

    def _alloc_would_fit(self, n: int) -> bool:
        return any(size >= n for _, size in self._free_ranges)

    def _remove(self, key: str) -> None:
        e = self._entries.pop(key)
        n = e.automaton.n_states
        self.masks[e.base : e.base + n] = 0
        self.default_next[e.base : e.base + n] = 0
        self._release_range(e.base, n)
        self._rebuild_edges()
        self.version += 1

    def _rebuild_edges(self) -> None:
        keys, nexts = [], []
        for e in self._entries.values():
            a = e.automaton
            keys.append(
                (a.edge_keys + np.int64(e.base) * a.vocab_size).astype(
                    np.int64
                )
            )
            nexts.append(a.edge_next + np.int32(e.base))
        self.edge_keys[:] = _KEY_SENTINEL
        self.edge_next[:] = 0
        if keys:
            k = np.concatenate(keys)
            x = np.concatenate(nexts)
            order = np.argsort(k, kind="stable")
            k, x = k[order], x[order]
            self.edge_keys[: len(k)] = k.astype(np.int32)
            self.edge_next[: len(x)] = x

    # -- public API ----------------------------------------------------------

    def attach(self, automaton: GrammarAutomaton) -> SlabHandle:
        e = self._entries.get(automaton.key)
        if e is not None:
            e.refs += 1
            return SlabHandle(self, e.automaton, e.base)
        n = automaton.n_states
        ne = len(automaton.edge_keys)
        if n > self.n_states - 1 or ne > self.n_edges:
            # would not fit even into an EMPTY slab: a schema problem
            # (400), not load
            raise GrammarError(
                f"grammar needs {n} states / {ne} edges; slab capacity is "
                f"{self.n_states - 1} states / {self.n_edges} edges "
                "(raise --grammar-slab-states or simplify the schema)"
            )
        self._evict_parked(n, ne)
        base = self._alloc(n)
        if base is None or self._edges_used() + ne > self.n_edges:
            if base is not None:
                self._release_range(base, n)
            raise GrammarSlabFull(
                f"grammar slab exhausted by live schemas "
                f"({len(self._entries)} installed)"
            )
        e = _Entry(automaton, base)
        e.refs = 1
        self._entries[automaton.key] = e
        self.masks[base : base + n] = automaton.masks
        self.default_next[base : base + n] = (
            automaton.default_next + np.int32(base)
        )
        self._rebuild_edges()
        self.version += 1
        return SlabHandle(self, automaton, base)

    def detach(self, key: str) -> None:
        """Release one reference; the installed range PARKS at refcount 0
        (tables stay resident for the next same-schema admission) and is
        only evicted under capacity pressure."""
        e = self._entries.get(key)
        if e is None:
            return
        e.refs = max(0, e.refs - 1)
        self._tick += 1
        e.stamp = self._tick

    def resolve(self, state: int):
        """(automaton, base) owning an absolute slab state, or None for
        the FREE state / unmapped ranges — how a state-carrying consumer
        maps a carry back to its automaton."""
        for e in self._entries.values():
            n = e.automaton.n_states
            if e.base <= state < e.base + n:
                return e.automaton, e.base
        return None

    def arrays(self):
        """(masks, edge_keys, edge_next, default_next) — the device
        upload source, fixed shapes forever."""
        return (self.masks, self.edge_keys, self.edge_next,
                self.default_next)

    def stats(self) -> dict:
        live = sum(1 for e in self._entries.values() if e.refs > 0)
        return {
            "grammar_schemas_installed": len(self._entries),
            "grammar_schemas_live": live,
            "grammar_slab_states_used": sum(
                e.automaton.n_states for e in self._entries.values()
            ) + 1,
            "grammar_slab_states_total": self.n_states,
        }
