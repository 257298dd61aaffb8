"""Fleet balancing: consistent-hash prefix affinity + load-based picks.

The routing brain of the ``dllama-router`` front-end (fleet/router.py).
Two selection modes over one replica table:

- **prefix affinity** — requests whose prompts share leading content
  blocks hash to the same replica, so same-system-prompt sessions land
  where the paged KV pool (runtime/kvpool.py) already holds the warm
  prefix pages and the prefix tree serves them by refcount bump instead
  of a fresh prefill. The key is a content-hash CHAIN over the prompt's
  leading fixed-size blocks — the router twin of kvpool's
  ``(parent_key, block_tokens)`` node-key chain, computed over request
  text instead of token ids (the router has no tokenizer; BPE is
  prefix-preserving over a shared leading system prompt, so equal text
  blocks imply equal token blocks). Placement uses a classic
  consistent-hash ring (virtual nodes per replica): when a replica
  leaves, only the keys it owned move (~1/N), so the fleet's warm-KV map
  survives membership churn instead of reshuffling wholesale.
- **least-loaded** — requests with no usable prefix (short prompts)
  go to the eligible replica with the smallest queue depth (free lanes
  break ties), from the queue_depth/lanes_free fields each replica's
  ``GET /load`` surface serves.

Eligibility folds in every per-replica signal the serving stack already
emits: a replica is skipped while it is **dead** (connect failures /
failed scrapes), **backing off** (a typed 429/503 shed's Retry-After is
honored — the router never hammers a replica that just said "not now"),
**draining** (SIGTERM flipped /health), or **breaker-open** (repeated
engine failures). The affinity ring simply walks past ineligible
replicas, which IS the consistent-hash failover: the key's placement
comes back the moment the replica does.

Pure stdlib, no torch/numpy, like the rest of serving/.
"""

from __future__ import annotations

import bisect
import threading
import time
import zlib

from ..lockcheck import make_lock
from ..utils.faults import _mix64

# affinity block geometry: ~4 chars/token (the page_cost estimate's BPE
# density) x the pool's 64-token default page -> 256 chars per block; the
# chain covers at most DEFAULT_AFFINITY_BLOCKS leading blocks so a long
# shared system prompt maps to ONE key regardless of what follows it
DEFAULT_BLOCK_CHARS = 256
DEFAULT_AFFINITY_BLOCKS = 4
# virtual ring points per replica: enough that ownership splits within a
# few percent of 1/N without making ring rebuilds noticeable
DEFAULT_VNODES = 64
# a replica that refused a TCP connect (or failed a scrape) sits out at
# least this long before the router re-probes it inline
DEFAULT_DEAD_BACKOFF_S = 2.0


def stable_hash(data: bytes, seed: int = 0) -> int:
    """Deterministic 64-bit hash of ``data`` (crc32 folded through the
    splitmix64 finalizer — the same ``_mix64`` the fault plan and the
    Retry-After jitter use). Python's builtin ``hash`` is salted per
    process, which would reshuffle the whole ring on every router
    restart; this one is stable across processes and restarts, so a
    restarted router routes the same prefixes to the same replicas."""
    return _mix64(zlib.crc32(data, seed & 0xFFFFFFFF) + (seed << 32))


def prefix_key(text: str, block_chars: int = DEFAULT_BLOCK_CHARS,
               max_blocks: int = DEFAULT_AFFINITY_BLOCKS) -> int | None:
    """Content-hash chain over the prompt's leading full blocks — the
    affinity key. ``None`` when the prompt has no full block (nothing
    sharable enough to steer by; the caller balances by load instead).
    Chained like kvpool's tree keys: block b's hash folds the hash of
    blocks [0, b), so two prompts get the same key iff their leading
    ``min(full_blocks, max_blocks)`` blocks are identical."""
    data = text.encode("utf-8", "replace")
    n = min(len(data) // block_chars, max_blocks)
    if n <= 0:
        return None
    key = 0
    for b in range(n):
        key = zlib.crc32(data[b * block_chars:(b + 1) * block_chars], key)
    return _mix64(key + (n << 32))


class ReplicaState:
    """One replica's routing view: static identity plus the last-scraped
    load fields and the router's own failure bookkeeping. Mutated only
    by :class:`FleetBalancer` under its lock."""

    __slots__ = (
        "rid", "base", "queue_depth", "lanes_free", "lanes_total",
        "breaker", "draining", "pool_pages_free", "pool_parked_pages",
        "retry_until", "dead", "scrape_ok", "routed", "role",
    )

    def __init__(self, base: str, rid: str | None = None):
        self.base = str(base)  # "host:port"
        self.rid = str(rid or base)
        self.role = "mixed"  # "prefill" | "decode" | "mixed", from /load
        self.queue_depth = 0
        self.lanes_free = 0
        self.lanes_total = 0
        self.breaker = "closed"
        self.draining = False
        self.pool_pages_free = None
        self.pool_parked_pages = None
        self.retry_until = 0.0  # monotonic: honored Retry-After horizon
        self.dead = False  # connect refused / scrape failed
        self.scrape_ok = False  # at least one successful /load scrape
        self.routed = 0  # requests this router sent here

    def host_port(self) -> tuple[str, int]:
        host, _, port = self.base.rpartition(":")
        return host, int(port)


class FleetBalancer:
    """The replica table + consistent-hash ring + eligibility rules.

    Thread-safe: picks come from router request threads, load updates
    from the scrape thread, shed/death marks from both.
    """

    # the replica table, ring and counters move only under _lock —
    # written by the scrape thread and request threads, read by every pick
    # and by the router's /stats.

    def __init__(self, replicas: list[str] | dict[str, str],
                 vnodes: int = DEFAULT_VNODES,
                 dead_backoff_s: float = DEFAULT_DEAD_BACKOFF_S):
        """``replicas``: ``host:port`` list (each replica's id defaults
        to its address, matching the replica's own ``--replica-id``
        default) or an ``{id: host:port}`` mapping."""
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.vnodes = max(1, int(vnodes))
        self.dead_backoff_s = float(dead_backoff_s)
        self._lock = make_lock("FleetBalancer._lock")
        items = (
            replicas.items() if isinstance(replicas, dict)
            else ((None, base) for base in replicas)
        )
        self._fb_replicas: dict[str, ReplicaState] = {}
        for rid, base in items:
            state = ReplicaState(base, rid)
            if state.rid in self._fb_replicas:
                raise ValueError(f"duplicate replica id {state.rid!r}")
            self._fb_replicas[state.rid] = state
        # the ring: sorted (point, rid) pairs, vnodes points per replica.
        # Built once — membership is config; a dead replica stays ON the
        # ring and is walked past (that is what keeps the other replicas'
        # key ownership stable while it is gone).
        ring = []
        for rid in self._fb_replicas:
            for v in range(self.vnodes):
                ring.append((stable_hash(rid.encode(), seed=v), rid))
        ring.sort()
        self._fb_ring: list[tuple[int, str]] = ring
        self._fb_affinity_routes = 0  # picks that had an affinity key
        self._fb_affinity_hits = 0  # ...that landed on the ring owner
        self._fb_load_routes = 0  # keyless least-loaded picks
        self._fb_sheds_honored = 0  # Retry-After horizons recorded

    # -- eligibility ---------------------------------------------------------

    def _eligible_locked(self, state: ReplicaState, now: float,
                         exclude) -> bool:
        if state.rid in exclude:
            return False
        if now < state.retry_until:
            # dead-backoff or an honored Retry-After; past the horizon a
            # dead replica becomes eligible again for ONE inline probe —
            # a failure re-arms the backoff, a success clears dead
            return False
        if state.draining:
            return False
        if state.breaker != "closed":
            return False
        return True

    def ring_owner(self, key: int) -> str:
        """The key's ring placement ignoring eligibility — the replica
        that WOULD serve it in a healthy fleet (the affinity-hit-rate
        denominator, and the 1/N-movement property's subject)."""
        with self._lock:
            return self._ring_walk_locked(key, lambda s: True)

    def _ring_walk_locked(self, key: int, ok) -> str | None:
        ring = self._fb_ring
        i = bisect.bisect_left(ring, (key & 0xFFFFFFFFFFFFFFFF, ""))
        for step in range(len(ring)):
            point, rid = ring[(i + step) % len(ring)]
            if ok(self._fb_replicas[rid]):
                return rid
        return None

    # -- picks ---------------------------------------------------------------

    def pick(self, key: int | None = None,
             exclude: set[str] | frozenset = frozenset(),
             role: str | None = None) -> ReplicaState | None:
        """Choose a replica: by affinity ring when ``key`` is given (walk
        past ineligible replicas — consistent-hash failover), else least
        loaded. ``exclude`` holds replicas already tried this request.
        ``role`` restricts the pick to replicas advertising that role on
        their ``/load`` surface (disagg routing: long prompts ask for
        ``"prefill"``; the caller falls back to a role-free pick when
        no such replica is eligible — the monolithic path). ``None``
        when no replica is eligible (the router gives up with the
        aggregate 503 + the smallest Retry-After hint)."""
        now = time.monotonic()

        def ok(s: ReplicaState) -> bool:
            if role is not None and s.role != role:
                return False
            return self._eligible_locked(s, now, exclude)

        with self._lock:
            if key is not None:
                self._fb_affinity_routes += 1
                owner = self._ring_walk_locked(key, lambda s: True)
                rid = self._ring_walk_locked(key, ok)
                if rid is None:
                    return None
                if rid == owner:
                    self._fb_affinity_hits += 1
                state = self._fb_replicas[rid]
            else:
                candidates = [
                    s for s in self._fb_replicas.values() if ok(s)
                ]
                if not candidates:
                    return None
                self._fb_load_routes += 1
                state = min(
                    candidates,
                    key=lambda s: (
                        s.queue_depth, -s.lanes_free, s.routed, s.rid
                    ),
                )
            state.routed += 1
            return state

    def any_eligible(self) -> bool:
        """Non-mutating readiness probe (the router's /health): is at
        least one replica currently routable?"""
        now = time.monotonic()
        with self._lock:
            return any(
                self._eligible_locked(s, now, frozenset())
                for s in self._fb_replicas.values()
            )

    def min_retry_after_s(self) -> float:
        """The smallest outstanding backoff horizon across the fleet —
        the Retry-After hint a total give-up hands the client."""
        now = time.monotonic()
        with self._lock:
            horizons = [
                s.retry_until - now
                for s in self._fb_replicas.values()
                if s.retry_until > now
            ]
        return max(1.0, min(horizons)) if horizons else 1.0

    # -- signals -------------------------------------------------------------

    def update_load(self, rid: str, load: dict) -> None:
        """Fold one ``GET /load`` scrape into the table. A successful
        scrape clears the dead flag — the replica is reachable again."""
        with self._lock:
            state = self._fb_replicas.get(rid)
            if state is None:
                return
            state.queue_depth = int(load.get("queue_depth", 0) or 0)
            state.lanes_free = int(load.get("lanes_free", 0) or 0)
            state.lanes_total = int(load.get("lanes_total", 0) or 0)
            state.breaker = str(load.get("breaker", "closed"))
            state.draining = bool(load.get("draining", False))
            state.pool_pages_free = load.get("pool_pages_free")
            state.pool_parked_pages = load.get("pool_parked_pages")
            state.role = str(load.get("role", "mixed") or "mixed")
            state.dead = False
            state.scrape_ok = True

    def note_shed(self, rid: str, retry_after_s: float,
                  draining: bool = False) -> None:
        """A replica answered with a typed 429/503: honor its hint — no
        request routes there until the horizon passes (or a scrape says
        it recovered)."""
        until = time.monotonic() + max(0.05, float(retry_after_s))
        with self._lock:
            state = self._fb_replicas.get(rid)
            if state is None:
                return
            state.retry_until = max(state.retry_until, until)
            if draining:
                state.draining = True
            self._fb_sheds_honored += 1

    def note_dead(self, rid: str, backoff_s: float | None = None) -> None:
        """Connect refused / socket died mid-exchange: mark unreachable.
        The next successful scrape (or an inline probe after the
        backoff) brings it back."""
        until = time.monotonic() + (
            self.dead_backoff_s if backoff_s is None else float(backoff_s)
        )
        with self._lock:
            state = self._fb_replicas.get(rid)
            if state is None:
                return
            state.dead = True
            state.retry_until = max(state.retry_until, until)

    def note_scrape_failed(self, rid: str) -> None:
        """A /load scrape failed: treat like a connect failure (the
        scrape IS the liveness probe), but only once the replica ever
        scraped — a fleet booting up should not mark replicas dead
        before they finish binding."""
        with self._lock:
            state = self._fb_replicas.get(rid)
            if state is None or not state.scrape_ok:
                return
            state.dead = True
            state.retry_until = max(
                state.retry_until, time.monotonic() + self.dead_backoff_s
            )

    # -- introspection -------------------------------------------------------

    def replicas(self) -> list[ReplicaState]:
        with self._lock:
            return list(self._fb_replicas.values())

    def get(self, rid: str) -> ReplicaState | None:
        with self._lock:
            return self._fb_replicas.get(rid)

    def stats(self) -> dict:
        """Routing counters + the per-replica table for the router's
        /stats (bridged to its /metrics like the replica surfaces)."""
        now = time.monotonic()
        with self._lock:
            return {
                "fleet_replicas": len(self._fb_replicas),
                "fleet_affinity_routes": self._fb_affinity_routes,
                "fleet_affinity_hits": self._fb_affinity_hits,
                "fleet_load_routes": self._fb_load_routes,
                "fleet_sheds_honored": self._fb_sheds_honored,
                "fleet_replica_table": {
                    s.rid: {
                        "base": s.base,
                        "role": s.role,
                        "queue_depth": s.queue_depth,
                        "lanes_free": s.lanes_free,
                        "lanes_total": s.lanes_total,
                        "breaker": s.breaker,
                        "draining": s.draining,
                        "dead": s.dead,
                        "backing_off": s.retry_until > now,
                        "routed": s.routed,
                    }
                    for s in self._fb_replicas.values()
                },
            }
