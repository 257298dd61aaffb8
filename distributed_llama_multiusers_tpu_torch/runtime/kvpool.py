"""Paged KV pool: fixed-size KV pages + a ref-counted cross-request
prefix tree — the host-side bookkeeping half of paged attention. The
port's copy of the JAX package's ``runtime/kvpool.py``; its one addition
is ``admit``'s ``share_quantum`` (below).

The contiguous layout binds every resident session to one physical lane
plane (``[n_lanes, seq_len, ...]``): a session's KV footprint is seq_len
slots whether it uses them or not, prefix reuse is a whole-lane HBM copy
(``engine.copy_lane``), and finished sessions stay warm only until a new
request happens to claim their lane. This module virtualizes that: the
device holds ONE pool of fixed-size pages (``page_size`` tokens each,
power of two, every layer's K/V for those tokens), each lane maps to
physical pages through a page table, and this class owns the host truth —
the free list, per-page refcounts, and a prefix tree keyed on
token-block content so N concurrent requests sharing a system prompt map
their prefix blocks to the SAME physical pages with zero copies.

Core rules:

- **Granularity** — only FULL blocks enter the tree (a block's content is
  immutable once committed: writes land strictly past the committing
  lane's watermark, so shared pages are never write targets). A partial
  match at the first divergent block is served copy-on-write: ONE page is
  copied (``engine``-side device op, ~page_size tokens x layers — vs
  copy_lane's whole-lane move) and the tail prefill rewrites it from the
  divergence point before any query can read the stale slots.
- **Reservation** — admission charges the lane's whole potential range
  (prompt + max_tokens, clamped to seq_len) up front, so the pipelined
  loop never needs a mid-chain allocation (the device advances positions
  by per-lane spec accept counts the host only learns one step behind —
  a lazy allocator could not keep up without a sync). Unused reserved
  pages return at finish.
- **Parking** — a finished session parks: its tree-registered blocks stay
  resident (refcounted) so chat follow-ups and same-prompt admissions
  hit copy-free, while its non-sharable tail pages free immediately.
  Parked sessions are LRU-evicted under pool pressure (an admission that
  cannot be served from the free list evicts before it sheds): dropped
  sessions rebuild deterministically on next activity by re-prefilling
  from the journaled prompt tokens — resident sessions are bounded by
  journal bytes, not HBM.
- **Exhaustion** — when eviction cannot cover an admission either, the
  pool raises :class:`PoolExhausted`; the scheduler sheds the request
  with a typed retryable 429 (``AdmissionRejected("pool_exhausted")``)
  instead of corrupting another session's pages.

Safety against in-flight junk writes (the pipelined ring dispatches up
to ``depth`` steps past a stop the host has not consumed yet): every
device mutation is an in-place op on the engine's one compute stream, so
all page writes are totally ordered by dispatch. A freed page re-allocated to a new lane
is only ever READ by that lane after the lane's own (later-dispatched)
writes covered the read frontier, and shared pages only expose content
below the committing session's watermark — the same
overwrite-before-readable invariant the contiguous path relies on.

- **Tiered residency** — between "parked in HBM" (reactivates free) and
  "dropped" (reactivates by re-prefill) sits :class:`HostTier`: a
  bounded (``--kv-host-bytes``, LRU) host-RAM store of swapped page
  payloads keyed by the SAME ``(parent_key, block)`` content-hash chain
  as the prefix tree, so a swapped prefix is still shared — one host
  copy serves every future admission of that chain. Pressure eviction
  deposits each freed committed page into ``_pending_swapouts``; the
  ENGINE drains those (``take_pending_swapouts`` -> device read ->
  ``HostTier.put``) before dispatching any write that could reuse the
  page, and an admission that misses HBM but hits the host tier gets its
  payloads back as ``swapins`` — fresh pages that reactivate with a
  host->device copy instead of a re-prefill. Integrity rides
  :func:`~..disagg.kvtransfer.page_hash` (one serializer with the
  disagg transfer path, no drift): a mismatch on swap-in raises
  :class:`HostTierCorrupt` (request-scoped, entry dropped, prefix tree
  untouched) and the retry re-prefills. ``--kv-host-bytes 0`` disables
  the tier and restores drop-to-rebuild bit-for-bit.

- **On a pod** (parallel/multihost.py) this bookkeeping runs on the root
  only, before any packet goes out; the workers replay its device half
  (table rows, copy-on-write copies, imports, swap-ins). A worker's pool
  holds its geometry alone (``blocks_per_lane`` for the table packets'
  check, the page size the engine's payloads are held to): its free list,
  tree and host tier are never used.

- **Share quantum** — ``admit(..., share_quantum=q)`` shares only a
  multiple of ``q`` tokens (and, for q > 1, no copy-on-write block). The
  default, 1, is the JAX rule. The port's scheduler passes the largest
  prefill bucket: a prompt chunk's KV bits depend on the chunk's shape
  (its products' split plan, its attention length), so only KV written
  by a whole chunk at the same place equals what a cold prefill writes,
  and a hit's stream then equals a cold one's.

Pure host/stdlib (no torch): the device half (pool planes, page tables,
page copies, swaps) lives in :mod:`runtime.engine`.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from itertools import islice

from ..disagg.kvtransfer import page_hash
from ..lockcheck import make_lock

# root key of the prefix tree; node keys are (parent_key, block_tokens)
# tuples, so the dict hash IS the block-content hash chain and two
# different prefixes can never collide into one node
_ROOT = ()

DEFAULT_PAGE_SIZE = 64
DEFAULT_MAX_PARKED = 64
# how many sibling blocks the divergent-block COW probe scans (the tree
# fans out per distinct block content; an unbounded scan under the pool
# lock would let adversarial traffic make every admission O(children))
_COW_SCAN_CAP = 16


class PoolExhausted(RuntimeError):
    """Admission could not reserve its pages: even evicting every parked
    session would not free enough — the pool is pinned by active lanes.
    Raised WITHOUT evicting (the parked prefix cache survives the shed,
    so retrying 429 clients cannot hold it empty under pressure). The
    scheduler maps this to a typed retryable shed (HTTP 429), never a
    500."""

    def __init__(self, need: int, free: int, total: int,
                 host_tier_full: bool = False):
        self.pages_needed = need
        self.pages_free = free
        self.pages_total = total
        # whether the host swap tier was enabled AND at budget when the
        # shed fired: the scheduler sheds "host_tier_full" instead of
        # "pool_exhausted" so dashboards can tell "raise --kv-host-bytes"
        # apart from "raise --kv-pool-pages"
        self.host_tier_full = host_tier_full
        super().__init__(
            f"kv page pool exhausted: admission needs {need} pages, "
            f"{free}/{total} free and parked-session eviction cannot "
            "cover the rest"
        )


class HostTierCorrupt(ValueError):
    """A swapped page's payload failed its integrity re-hash on the way
    back in. ValueError family on purpose: the scheduler treats it as a
    request-scoped failure (HTTP 4xx/typed stream error, breaker stays
    closed) — the corrupt entry is dropped from the tier before raising,
    the prefix tree was never touched, and the request's retry misses
    the tier and re-prefills deterministically from the prompt."""

    def __init__(self, detail: str = ""):
        super().__init__(
            "host-tier kv page failed integrity verification"
            + (f": {detail}" if detail else "")
        )


def blocks_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` KV slots."""
    return max(0, -(-int(n_tokens) // int(page_size)))


class HostTier:
    """Bounded host-RAM store of swapped KV page payloads — the middle
    residency tier between "parked in HBM" and "dropped".

    Entries are keyed by the prefix tree's node key (the
    ``(parent_key, block)`` content-hash chain), so the tier IS a
    shadow of the tree for pages the pool had to free: one host copy
    serves every future admission that walks the same chain, exactly
    like a resident parked page serves N sharers. The byte budget is
    LRU-enforced at ``put``; a hit refreshes recency and does NOT
    remove the entry (shared by design — removal happens only by LRU
    pressure, :meth:`discard`, :meth:`clear`, or a failed integrity
    re-hash). Every payload is hashed at ``put`` and re-verified at
    ``get`` with :func:`~..disagg.kvtransfer.page_hash` — the same
    canonical framing the disagg transfer bundles use, so the two
    serializers cannot drift.

    Own lock (``HostTier._lock``): the engine's drain runs device reads
    between ``put`` calls, and /stats reads the gauges from HTTP
    threads; the pool may call in while holding ``KVPagePool._lock``
    (pool -> tier is the one sanctioned nesting order — the tier never
    calls back into the pool)."""



    def __init__(self, budget_bytes: int, page_size: int):
        self.budget_bytes = max(0, int(budget_bytes))
        self.page_size = int(page_size)
        self._lock = make_lock("HostTier._lock")
        # node key -> (payload bytes, integrity hash); OrderedDict order
        # IS the LRU (oldest first)
        self._swapped: "OrderedDict[tuple, tuple[bytes, str]]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evicted = 0
        self.full_drops = 0  # payloads refused at put (oversize/disabled)
        self.corrupt_drops = 0  # entries dropped by a failed re-hash
        self.stored = 0

    @property
    def enabled(self) -> bool:
        return self.budget_bytes > 0

    def full(self) -> bool:
        """Whether the tier is at (or over) its byte budget — the
        host-tier-full half of the shed-reason distinction."""
        with self._lock:
            return self.enabled and self._bytes >= self.budget_bytes

    def put(self, node_key: tuple, blk_tokens, payload: bytes) -> bool:
        """Store one swapped page's payload under its tree node key.
        Hashes the payload (the exporter-side half of the integrity
        frame), refreshes recency on a re-put of a known key, and
        LRU-evicts until the byte budget holds. Returns whether the
        payload is resident after the call — ``False`` means dropped
        (tier disabled, or the payload alone exceeds the budget)."""
        blk = tuple(int(t) for t in blk_tokens)
        data = bytes(payload)
        h = page_hash(self.page_size, blk, data)
        with self._lock:
            if not self.enabled or len(data) > self.budget_bytes:
                self.full_drops += 1
                return False
            prior = self._swapped.pop(node_key, None)
            if prior is not None:
                self._bytes -= len(prior[0])
            while self._swapped and self._bytes + len(data) > self.budget_bytes:
                _, (old, _h) = self._swapped.popitem(last=False)
                self._bytes -= len(old)
                self.evicted += 1
            self._swapped[node_key] = (data, h)
            self._bytes += len(data)
            self.stored += 1
            return True

    def get(self, node_key: tuple, blk_tokens) -> bytes | None:
        """Look up a swapped page by tree node key. A hit re-verifies
        the payload against its stored hash and refreshes LRU recency
        (the entry STAYS — one host copy serves N admissions); a failed
        re-hash drops the entry and raises :class:`HostTierCorrupt`
        (request-scoped — the caller has not mutated anything yet)."""
        blk = tuple(int(t) for t in blk_tokens)
        with self._lock:
            entry = self._swapped.get(node_key)
            if entry is None:
                self.misses += 1
                return None
            data, want = entry
            if page_hash(self.page_size, blk, data) != want:
                del self._swapped[node_key]
                self._bytes -= len(data)
                self.corrupt_drops += 1
                raise HostTierCorrupt(
                    f"node at depth {_key_depth(node_key)} "
                    f"({len(data)} bytes) — entry dropped, request "
                    "retry will re-prefill"
                )
            self._swapped.move_to_end(node_key)
            self.hits += 1
            return data

    def discard(self, node_key: tuple) -> None:
        """Drop an entry if present (idempotent) — the release path for
        a pending swap-out whose device read failed, and the disposal
        half of containment."""
        with self._lock:
            entry = self._swapped.pop(node_key, None)
            if entry is not None:
                self._bytes -= len(entry[0])

    def clear(self) -> int:
        """Drop every entry (containment / the bench's rebuild lever —
        without this, drop_parked would still reactivate via the tier).
        Returns how many entries were dropped."""
        with self._lock:
            n = len(self._swapped)
            self._swapped.clear()
            self._bytes = 0
            return n

    def stats(self) -> dict:
        """Tier pressure snapshot (one lock hold); merged into the
        pool's ``stats()`` so every field rides the /stats -> /metrics
        bridge as a ``dllama_stats_pool_*`` gauge."""
        with self._lock:
            return {
                "pool_host_pages": len(self._swapped),
                "pool_host_bytes": self._bytes,
                "pool_host_budget_bytes": self.budget_bytes,
                "pool_host_hits": self.hits,
                "pool_host_misses": self.misses,
                "pool_host_evicted": self.evicted,
                "pool_host_full_drops": self.full_drops,
                "pool_host_corrupt": self.corrupt_drops,
                "pool_host_stored": self.stored,
            }


def _key_depth(key: tuple) -> int:
    """Chain depth of a prefix-tree node key (diagnostics only)."""
    d = 0
    while key != _ROOT and isinstance(key, tuple) and len(key) == 2:
        key = key[0]
        d += 1
    return d


class KVPagePool:
    """Host bookkeeping for a device-resident paged KV pool.

    All mutation happens on the scheduler loop thread; ``stats()`` is
    read from HTTP threads — every access holds ``_lock`` (machine-
    checked by no tool in the port: the rule is kept by hand). The pool
    never touches a device value: ``admit`` returns the physical block
    list + the page-copy ops for the ENGINE to apply."""



    def __init__(
        self,
        n_pages: int,
        page_size: int = DEFAULT_PAGE_SIZE,
        n_lanes: int = 8,
        blocks_per_lane: int | None = None,
        max_parked: int = DEFAULT_MAX_PARKED,
        host_bytes: int = 0,
    ):
        if page_size <= 0 or (page_size & (page_size - 1)) != 0:
            raise ValueError(
                f"page_size must be a power of two, got {page_size}"
            )
        if n_pages <= 0:
            raise ValueError(f"n_pages must be positive, got {n_pages}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.n_lanes = int(n_lanes)
        # table width: how many blocks one lane can map (defaults to a
        # full-seq_len lane's worth when the engine builds the pool)
        self.blocks_per_lane = int(blocks_per_lane or n_pages)
        self.max_parked = max(0, int(max_parked))
        # built via make_lock so the runtime lock-order witness
        # (DLLAMA_LOCKCHECK=1) can wrap it
        self._lock = make_lock("KVPagePool._lock")
        # LIFO free stack: recently freed pages are re-used first (their
        # device buffers are the most likely to still be resident-hot)
        self._free: list[int] = list(range(self.n_pages))
        self._ref = [0] * self.n_pages
        # prefix tree: node key -> physical page; key = (parent_key,
        # tuple(block tokens)) chains content, so a lookup walk is one
        # dict get per block. _children mirrors it parent-first for the
        # divergent-block COW probe; _page_key inverts it for removal
        # when a page's refcount hits zero.
        self._nodes: dict[tuple, int] = {}
        self._page_key: dict[int, tuple] = {}
        self._children: dict[tuple, dict[tuple, int]] = {}
        # per-lane mapping: physical pages in block order, how many
        # blocks the lane has registered into the tree, and the tree key
        # of its registration tip (the chain grows from there)
        self._lane_blocks: list[list[int]] = [[] for _ in range(self.n_lanes)]
        self._lane_reg = [0] * self.n_lanes
        self._lane_tip: list[tuple] = [_ROOT for _ in range(self.n_lanes)]
        # parked sessions: park id -> registered block list; OrderedDict
        # order IS the LRU (oldest first). _parked_pages counts DISTINCT
        # physical pages pinned by parking (shared pages once, not once
        # per holder — the gauge means real pool occupancy, and LOWER
        # pages-per-parked-session = more overlap); _park_refs is the
        # per-page park-hold count behind that dedup.
        self._parked: "OrderedDict[int, list[int]]" = OrderedDict()
        self._park_refs: dict[int, int] = {}
        # block-list identity -> park id: a re-park of an IDENTICAL
        # chain refreshes recency in one slot instead of flooding the
        # LRU with duplicate holders of the same pages (one repetitive
        # client would otherwise evict every other parked prefix)
        self._park_index: dict[tuple, int] = {}
        self._parked_pages = 0
        self._park_seq = 0
        # host swap tier (disabled at host_bytes=0 — every tier branch
        # below gates on enabled, so 0 restores drop-to-rebuild exactly)
        # and the swap-out staging list: pressure eviction deposits
        # (node_key, block_tokens, page) here for pages whose last ref
        # just drained; the ENGINE drains it (take_pending_swapouts ->
        # device read -> HostTier.put) before dispatching any write that
        # could reuse the page — the stream order makes the
        # read see pre-eviction bytes. Carries the node key because by
        # drain time the page's tree entry is gone.
        self.host_tier = HostTier(host_bytes, self.page_size)
        self._pending_swapouts: list[tuple[tuple, tuple, int]] = []
        # counters (stats() snapshots them for /stats -> /metrics)
        self.admits = 0
        self.prefix_admits = 0
        self.prefix_tokens_shared = 0
        self.cow_copies = 0
        self.parked_evicted = 0  # drop-rebuild: sessions whose pages were
        # reclaimed under pressure; their next activity re-prefills from
        # the journaled prompt (deterministically byte-identical)
        self.exhausted_sheds = 0
        self.parked_total = 0
        self.pool_resets = 0
        self.adopts = 0  # disagg: chains adopted from a peer replica
        self.adopted_pages_fresh = 0  # pages that needed a payload import
        self.swap_in_admits = 0  # admissions served partly from the tier
        self.host_pages_swapped_in = 0  # pages reactivated by host copy

    @classmethod
    def for_seq_len(
        cls,
        seq_len: int,
        n_lanes: int,
        page_size: int = DEFAULT_PAGE_SIZE,
        pool_pages: int | None = None,
        max_parked: int = DEFAULT_MAX_PARKED,
        host_bytes: int = 0,
    ) -> "KVPagePool":
        """THE pool-construction recipe: validate
        the page size (power of two), shrink it to fit short contexts
        (tiny test configs) while staying a power of two, and default
        the pool to the contiguous layout's exact footprint
        (``n_lanes`` x blocks-per-full-lane) — oversubscription comes
        from sessions reserving only what they can use, never from a
        bigger pool. Callers derive the device/table shapes from the
        result (``page_size``, ``blocks_per_lane``, ``n_pages``)."""
        bs = int(page_size)
        if bs <= 0 or bs & (bs - 1):
            raise ValueError(
                f"kv_page_size must be a positive power of two, "
                f"got {page_size}"
            )
        while bs > seq_len:
            bs //= 2
        n_blocks = blocks_for(seq_len, bs)
        # None = not set (contiguous-footprint default); an explicit 0 or
        # negative must die in __init__'s validation, not silently become
        # the default pool
        n_pages = int(n_lanes * n_blocks if pool_pages is None
                      else pool_pages)
        return cls(n_pages, bs, n_lanes, blocks_per_lane=n_blocks,
                   max_parked=max_parked, host_bytes=host_bytes)

    # -- admission -----------------------------------------------------------

    def admit(
        self,
        lane: int,
        tokens: list[int],
        reserve_tokens: int,
        min_share_tokens: int = 1,
        share_quantum: int = 1,
    ) -> tuple[int, list[int], list[tuple[int, int]],
               list[tuple[int, bytes]]]:
        """Reserve lane ``lane``'s pages for a request whose prompt is
        ``tokens`` and whose whole potential range is ``reserve_tokens``
        KV slots. Returns ``(start, blocks, copies, swapins)``:

        - ``start`` — prompt tokens already resident via sharing: full
          blocks by refcount bump, host-tier full blocks swapped back
          in, plus up to one partial block served copy-on-write. The
          caller prefills only ``tokens[start:]`` (always >= 1 token,
          the prefix-cache rule).
        - ``blocks`` — the lane's physical pages in block order (shared
          prefix pages first), for the device page table.
        - ``copies`` — ``(src_page, dst_page)`` device copies the engine
          must apply BEFORE the tail prefill (the COW at the divergent
          block; at most one).
        - ``swapins`` — ``(page, payload)`` host->device page writes the
          engine must apply BEFORE the tail prefill: the prompt's chain
          continued in the HOST TIER past the resident prefix, so those
          blocks reactivate by copy instead of re-prefill. The pages are
          already registered back into the prefix tree (the next
          admission shares them resident, zero copies).

        ``min_share_tokens`` gates sharing like the contiguous path's
        ``prefix_min_tokens`` (<= 0 disables sharing entirely).
        ``share_quantum`` (the port's addition; 1, the default, is the
        JAX rule): above 1, ``start`` is cut to a multiple of it (and of
        the page size), resident and swapped blocks alike, and no
        copy-on-write block is served. Raises
        :class:`PoolExhausted` when the reservation cannot be served
        even after evicting every parked session, and
        :class:`HostTierCorrupt` (BEFORE any pool mutation — the tree
        is never poisoned by a bad swapped payload) when a host-tier
        hit fails its integrity re-hash."""
        with self._lock:
            self._release_locked(lane)  # defensive: lane must start empty
            bs = self.page_size
            max_reuse = len(tokens) - 1  # >= 1 token must prefill
            shared_pages: list[int] = []
            key = _ROOT
            keys = [key]  # the chain's key after each walked block
            if min_share_tokens > 0:
                while (len(shared_pages) + 1) * bs <= max_reuse:
                    blk = tuple(tokens[len(shared_pages) * bs:
                                       (len(shared_pages) + 1) * bs])
                    page = self._nodes.get((key, blk))
                    if page is None:
                        break
                    key = (key, blk)
                    keys.append(key)
                    shared_pages.append(page)
            # the chain may CONTINUE in the host tier past the resident
            # frontier: swapped blocks reactivate into fresh pages by a
            # host->device copy instead of a re-prefill. The walk runs
            # before any ref/eviction side effect, so a HostTierCorrupt
            # out of get() leaves the pool exactly as it found it.
            hbm_key = key
            swap_meta: list[tuple[tuple, bytes]] = []  # (block, payload)
            if min_share_tokens > 0 and self.host_tier.enabled:
                while (len(shared_pages) + len(swap_meta) + 1) * bs <= max_reuse:
                    i = len(shared_pages) + len(swap_meta)
                    blk = tuple(tokens[i * bs: (i + 1) * bs])
                    payload = self.host_tier.get((key, blk), blk)
                    if payload is None:
                        break
                    key = (key, blk)
                    keys.append(key)
                    swap_meta.append((blk, payload))
            start = (len(shared_pages) + len(swap_meta)) * bs
            quantum = max(1, int(share_quantum))
            if quantum > 1:
                # whole quanta only: the walked chain is cut back to the
                # last block boundary that is a multiple of the quantum
                unit = quantum * bs // math.gcd(quantum, bs)
                n_keep = start // unit * unit // bs
                n_res = min(len(shared_pages), n_keep)
                shared_pages = shared_pages[:n_res]
                swap_meta = swap_meta[:n_keep - n_res]
                key, hbm_key = keys[n_keep], keys[n_res]
                start = n_keep * bs
            # divergent-block COW probe: the best sibling block sharing a
            # leading run with our next (possibly partial) block
            cow_src = -1
            cow_len = 0
            if min_share_tokens > 0 and start < max_reuse and quantum == 1:
                want = tokens[start: min(start + bs, max_reuse)]
                kids = self._children.get(key)
                if kids and want:
                    # islice, not a list copy: the cap exists so wide
                    # fan-out can't make admissions O(children) under
                    # the pool lock — copying the dict first would
                    for blk, page in islice(kids.items(), _COW_SCAN_CAP):
                        p = 0
                        lim = min(len(blk), len(want))
                        while p < lim and blk[p] == want[p]:
                            p += 1
                        if p > cow_len:
                            cow_src, cow_len = page, p
            if start + cow_len < max(1, min_share_tokens):
                # below the sharing threshold: admit fully private (key
                # included — a stale tip would make commit() register
                # this lane's blocks under the matched chain, poisoning
                # future walks with wrong-position KV)
                shared_pages = []
                swap_meta = []
                start = 0
                cow_src, cow_len = -1, 0
                key = _ROOT
                hbm_key = _ROOT
            n_blocks = blocks_for(
                max(reserve_tokens, len(tokens) + 1), bs
            )
            n_blocks = min(n_blocks, self.blocks_per_lane)
            if n_blocks > self.n_pages:
                # structurally unservable (an explicitly undersized
                # --kv-pool-pages): even with every parked session and
                # every other lane evicted the pool cannot hold this
                # reservation, so the retryable PoolExhausted shed would
                # have the client back off and re-probe forever — each
                # probe destructively evicting parked prefixes. ValueError
                # is the scheduler's request-scoped validation class
                # (client error, breaker closed); raised BEFORE any
                # ref/eviction side effect.
                raise ValueError(
                    f"kv page reservation needs {n_blocks} pages but the "
                    f"pool holds {self.n_pages} total: lower the "
                    "request's max_tokens/prompt or raise --kv-pool-pages"
                )
            need = n_blocks - len(shared_pages)
            # take the shared refs (and a COW-source pin) BEFORE any
            # eviction: the parked holders may be the ONLY refs on the
            # pages this admission matched, and evicting them would free
            # pages we are about to map (the free-list pop could then
            # hand the same physical page back as a fresh block)
            for p in shared_pages:
                self._ref[p] += 1
            cow_pinned = cow_src >= 0
            if cow_pinned:
                self._ref[cow_src] += 1
            if len(self._free) < need:
                # evict only when eviction can actually serve this
                # admission: a shed that had first drained the parked LRU
                # would leave retrying 429 clients holding the prefix
                # cache empty for as long as the pool stays pinned — the
                # retry-probe destruction the structural guard above
                # stops for need > n_pages, generalized to transient
                # pressure. A page is evictable iff park holds are its
                # ONLY refs (shared/pinned pages stay resident anyway).
                evictable = sum(
                    1 for p, held in self._park_refs.items()
                    if self._ref[p] == held
                )
                if len(self._free) + evictable < need:
                    self.exhausted_sheds += 1
                    for p in shared_pages:  # undo before shedding
                        self._deref_locked(p)
                    if cow_pinned:
                        self._deref_locked(cow_src)
                    raise PoolExhausted(
                        need, len(self._free), self.n_pages,
                        host_tier_full=self.host_tier.full(),
                    )
                self._evict_parked_locked(need - len(self._free))
            if len(self._free) < need:
                # backstop (the sufficiency check above should make this
                # unreachable): never hand out a short reservation
                self.exhausted_sheds += 1
                for p in shared_pages:
                    self._deref_locked(p)
                if cow_pinned:
                    self._deref_locked(cow_src)
                raise PoolExhausted(
                    need, len(self._free), self.n_pages,
                    host_tier_full=self.host_tier.full(),
                )
            fresh = [self._free.pop() for _ in range(need)]
            for p in fresh:
                self._ref[p] = 1
            if cow_pinned:
                # the pin only had to survive eviction: the device copy
                # is dispatched synchronously with this admission, before
                # any later admission's writes can reuse the page
                self._deref_locked(cow_src)
            copies: list[tuple[int, int]] = []
            if cow_src >= 0 and cow_len > 0 and len(fresh) > len(swap_meta):
                # COW only fires at the HBM frontier (a tier-extended tip
                # is not a tree node, so the sibling probe found nothing)
                # — swap_meta is empty here and the dst is fresh[0], but
                # index past the swap-in pages anyway so the two claims
                # can never alias if either walk ever changes
                copies.append((cow_src, fresh[len(swap_meta)]))
                start += cow_len
                self.cow_copies += 1
            # swapped blocks land in the LEADING fresh pages and register
            # straight back into the prefix tree (the same duplicate rule
            # as commit(): the walk just proved these nodes absent, and
            # each next node chains from the one we create) — the next
            # same-prefix admission shares them RESIDENT, zero copies.
            # The caller must apply the (page, payload) writes before the
            # tail prefill, exactly like the COW copies.
            swapins: list[tuple[int, bytes]] = []
            reg_key = hbm_key
            for j, (blk, payload) in enumerate(swap_meta):
                page = fresh[j]
                child = (reg_key, blk)
                if child not in self._nodes:
                    self._nodes[child] = page
                    self._page_key[page] = child
                    self._children.setdefault(reg_key, {})[blk] = page
                reg_key = child
                swapins.append((page, payload))
            blocks = shared_pages + fresh
            self._lane_blocks[lane] = blocks
            self._lane_reg[lane] = len(shared_pages) + len(swap_meta)
            self._lane_tip[lane] = key
            self.admits += 1
            if swapins:
                self.swap_in_admits += 1
                self.host_pages_swapped_in += len(swapins)
            if start > 0:
                self.prefix_admits += 1
                self.prefix_tokens_shared += start
            return start, list(blocks), copies, swapins

    def commit(self, lane: int, tokens: list[int]) -> None:
        """Register lane ``lane``'s newly completed full blocks into the
        prefix tree. ``tokens`` is the lane's committed history (prompt +
        consumed generated tokens); idempotent and incremental — call it
        after every commit point, it only walks blocks not yet
        registered. Duplicate content (another session registered the
        identical chain first) keeps the existing node: future sharers
        land on the first copy, ours stays private until it frees."""
        with self._lock:
            bs = self.page_size
            blocks = self._lane_blocks[lane]
            reg = self._lane_reg[lane]
            n_full = len(tokens) // bs
            key = self._lane_tip[lane]
            while reg < n_full and reg < len(blocks):
                blk = tuple(tokens[reg * bs: (reg + 1) * bs])
                child = (key, blk)
                if child not in self._nodes:
                    page = blocks[reg]
                    self._nodes[child] = page
                    self._page_key[page] = child
                    self._children.setdefault(key, {})[blk] = page
                key = child
                reg += 1
            self._lane_reg[lane] = reg
            self._lane_tip[lane] = key

    # -- disaggregated prefill: chain export / adoption ----------------------

    def chain_pages(self, tokens: list[int]) -> list[tuple[tuple, int]]:
        """The longest registered prefix chain over ``tokens``'s FULL
        blocks, as ``(block_tokens, physical_page)`` pairs in chain
        order — the export surface for KV-page transfer (disagg/
        kvtransfer.py). Only committed tree nodes are visible: a lane's
        partial tail block and unshared reservation never leave the
        replica, which is exactly the immutability rule that makes the
        exported bytes stable while the source lane keeps decoding."""
        with self._lock:
            bs = self.page_size
            out: list[tuple[tuple, int]] = []
            key = _ROOT
            for i in range(len(tokens) // bs):
                blk = tuple(tokens[i * bs: (i + 1) * bs])
                page = self._nodes.get((key, blk))
                if page is None:
                    break
                key = (key, blk)
                out.append((blk, page))
            return out

    def adopt(self, token_blocks: list) -> tuple[list[int], list[tuple[int, int]]]:
        """Adopt a transferred block chain into THIS pool's prefix tree.
        ``token_blocks`` is the chain's full blocks (page_size tokens
        each) in order. Returns ``(pages, fresh)``:

        - ``pages`` — the chain's physical pages here, in block order;
        - ``fresh`` — ``(block_index, page)`` pairs for blocks that had
          no local node and were newly allocated: ONLY these need their
          KV payload imported (engine ``import_kv_page``). Blocks the
          local tree already held are reused by refcount — adopting a
          chain a replica partly knows moves only the missing suffix.

        The whole chain is pinned by a park entry (the same LRU slot a
        ``finish(park=True)`` would create, identical-chain dedup
        included), so the adopted prefix survives until a real admission
        shares it or LRU pressure evicts it — refcount-correct by
        construction: each chain page carries exactly one park-held ref,
        like any parked session. Raises :class:`PoolExhausted` WITHOUT
        mutating when free + evictable-parked pages cannot cover the
        missing suffix, and ``ValueError`` for malformed blocks or a
        parking-disabled pool (nothing would pin the adopted pages)."""
        with self._lock:
            bs = self.page_size
            if self.max_parked <= 0:
                raise ValueError(
                    "adopt needs parking enabled (max_parked > 0): a "
                    "parkless pool would free the adopted pages at once"
                )
            chain = [tuple(blk) for blk in token_blocks]
            if not chain:
                raise ValueError("adopt: empty block chain")
            if any(len(blk) != bs for blk in chain):
                raise ValueError(
                    f"adopt: every block must hold exactly {bs} tokens "
                    "(full committed blocks only cross replicas)"
                )
            # walk the chain over the local tree: reused prefix first
            key = _ROOT
            pages: list[int] = []
            for blk in chain:
                page = self._nodes.get((key, blk))
                if page is None:
                    break
                key = (key, blk)
                pages.append(page)
            need = len(chain) - len(pages)
            # sufficiency BEFORE any mutation (the admit() rule): a shed
            # must leave the pool exactly as it found it
            if len(self._free) < need:
                evictable = sum(
                    1 for p, held in self._park_refs.items()
                    if self._ref[p] == held
                )
                if len(self._free) + evictable < need:
                    self.exhausted_sheds += 1
                    raise PoolExhausted(need, len(self._free), self.n_pages)
            # pin reused pages BEFORE eviction — parked holders may be
            # the only refs on the very prefix this adoption extends
            for p in pages:
                self._ref[p] += 1
            if len(self._free) < need:
                self._evict_parked_locked(need - len(self._free))
            if len(self._free) < need:  # backstop: undo and shed
                for p in pages:
                    self._deref_locked(p)
                self.exhausted_sheds += 1
                raise PoolExhausted(need, len(self._free), self.n_pages)
            fresh: list[tuple[int, int]] = []
            for j in range(len(pages), len(chain)):
                p = self._free.pop()
                self._ref[p] = 1
                blk = chain[j]
                child = (key, blk)
                self._nodes[child] = p
                self._page_key[p] = child
                self._children.setdefault(key, {})[blk] = p
                key = child
                pages.append(p)
                fresh.append((j, p))
            # park the whole chain: the operation's refs transfer to the
            # park holder (finish(park=True)'s accounting, dedup included)
            existing = self._park_index.get(tuple(pages))
            if existing is not None:
                self._parked.move_to_end(existing)
                for p in pages:
                    self._deref_locked(p)
            else:
                self._park_seq += 1
                self._parked[self._park_seq] = list(pages)
                self._park_index[tuple(pages)] = self._park_seq
                for p in pages:
                    if self._park_refs.get(p, 0) == 0:
                        self._parked_pages += 1
                    self._park_refs[p] = self._park_refs.get(p, 0) + 1
                while len(self._parked) > self.max_parked:
                    self._evict_oldest_locked()
            self.parked_total += 1
            self.adopts += 1
            self.adopted_pages_fresh += len(fresh)
            return list(pages), fresh

    # -- release / parking ---------------------------------------------------

    def finish(self, lane: int, park: bool = True) -> bool:
        """Release lane ``lane``'s mapping at request end. ``park=True``
        keeps the session's tree-registered blocks resident (refcounted,
        LRU-bounded) so follow-ups share copy-free, and frees the
        non-sharable tail (partial block + unused reservation)
        immediately; a re-park of an IDENTICAL chain refreshes the
        existing entry's recency instead of adding a duplicate holder
        (one repetitive client occupies one LRU slot, not max_parked);
        blocks another lane registered first (duplicate content) back no
        tree node and free rather than park as dead residency;
        ``park=False`` frees everything (the failure path — the cache
        contents are not trusted). Returns whether the lane actually
        held pages: callers skip the device-side table unmap otherwise — the exhaustion-
        shed reject path releases lanes that never mapped anything, and
        overload rejects must stay host-only cheap."""
        with self._lock:
            blocks = self._lane_blocks[lane]
            if not blocks:
                self._clear_lane_locked(lane)
                return False
            keep: list[int] = []
            if park and self.max_parked > 0:
                for p in blocks[: self._lane_reg[lane]]:
                    if p in self._page_key:
                        keep.append(p)
                    else:
                        # duplicate-content block: another lane registered
                        # the identical chain first, so this page backs no
                        # tree node — no future walk can reach it, and
                        # parking it would be dead residency that evicts
                        # genuinely sharable sessions under pressure
                        self._deref_locked(p)
                for p in blocks[self._lane_reg[lane]:]:
                    self._deref_locked(p)
            else:
                for p in blocks:
                    self._deref_locked(p)
            if keep:
                existing = self._park_index.get(tuple(keep))
                if existing is not None:
                    # identical chain already parked: refresh its LRU
                    # recency and release the lane's (now redundant)
                    # refs — the existing entry's park holds pin the
                    # pages, and a repeat client occupies ONE slot
                    self._parked.move_to_end(existing)
                    for p in keep:
                        self._deref_locked(p)
                else:
                    self._park_seq += 1
                    self._parked[self._park_seq] = keep
                    self._park_index[tuple(keep)] = self._park_seq
                    for p in keep:
                        if self._park_refs.get(p, 0) == 0:
                            self._parked_pages += 1
                        self._park_refs[p] = self._park_refs.get(p, 0) + 1
                    while len(self._parked) > self.max_parked:
                        self._evict_oldest_locked()
                self.parked_total += 1
            self._clear_lane_locked(lane)
            return True

    def release(self, lane: int) -> None:
        """Free lane ``lane``'s mapping without parking (idempotent)."""
        with self._lock:
            self._release_locked(lane)

    def drop_parked(self) -> int:
        """Evict every parked session WITHOUT staging swap-outs (the
        test/benchmark lever for the park -> drop -> journal-rebuild
        round trip — swapping here would turn the rebuild measurement
        into a swap-in measurement). Returns how many sessions were
        dropped."""
        with self._lock:
            n = len(self._parked)
            while self._parked:
                self._evict_entry_locked(next(iter(self._parked)),
                                         swap=False)
            return n

    def swap_out_parked(self) -> int:
        """Evict every parked session WITH swap-out staging (the bench's
        swap-tier lever; pressure eviction does the same organically).
        Returns how many sessions were evicted; the caller must drain
        the staged pages through the engine (``drain_kv_swapouts``)."""
        with self._lock:
            n = len(self._parked)
            while self._parked:
                self._evict_oldest_locked()
            return n

    def take_pending_swapouts(self) -> list[tuple[tuple, tuple, int]]:
        """Hand the engine the staged swap-outs — ``(node_key,
        block_tokens, page)`` triples whose pages just freed under
        pressure (one lock hold, clears the staging list). The host-page
        ACQUIRE: every triple must reach ``HostTier.put`` or
        ``HostTier.discard``. The caller must apply the device reads
        BEFORE dispatching any write that could reuse the pages (the
        stream order guarantees the read still sees the
        pre-eviction bytes)."""
        with self._lock:
            out = self._pending_swapouts
            self._pending_swapouts = []
            return out

    def reset(self) -> None:
        """Containment: drop every lane mapping, every parked session and
        every tree node — after an engine-scoped failure the device pool
        contents are not trusted, so nothing may be shared from them."""
        with self._lock:
            for lane in range(self.n_lanes):
                self._clear_lane_locked(lane)
            # parked sessions drain WITHOUT counting parked_evicted:
            # that gauge means LRU pressure (drop-rebuild); containment
            # is already counted by pool_resets
            self._parked.clear()
            # anything still referenced would be a bookkeeping leak: the
            # reset is the last resort, start from a clean pool
            self._nodes.clear()
            self._page_key.clear()
            self._children.clear()
            self._free = list(range(self.n_pages))
            self._ref = [0] * self.n_pages
            self._park_refs.clear()
            self._park_index.clear()
            self._parked_pages = 0
            # staged swap-outs are DISCARDED, not stored (their device
            # bytes are exactly what containment distrusts), and the
            # tier itself clears — nothing may be shared from before
            # the failure, host copies included
            self._pending_swapouts = []
            self.host_tier.clear()
            self.pool_resets += 1

    # -- introspection -------------------------------------------------------

    def table_row(self, blocks: list[int]) -> list[int]:
        """One lane's page-table row: physical pages in block order,
        padded to ``blocks_per_lane`` with the ``n_pages`` unmapped
        sentinel — THE row-encoding recipe (the engine's device pool
        keeps a scratch page at index ``n_pages``, so the sentinel
        indexes it directly).
        No lock: reads only immutable pool geometry."""
        row = [self.n_pages] * self.blocks_per_lane
        row[: len(blocks)] = blocks
        return row

    def lane_blocks(self, lane: int) -> list[int]:
        with self._lock:
            return list(self._lane_blocks[lane])

    def pages_free(self) -> int:
        with self._lock:
            return len(self._free)

    def parked_sessions(self) -> int:
        with self._lock:
            return len(self._parked)

    def stats(self) -> dict:
        """Point-in-time pool pressure snapshot (one lock hold); every
        field is bridged to /metrics as a ``dllama_stats_*`` gauge via
        the /stats bridge, so dashboards see pool pressure end-to-end."""
        with self._lock:
            return {
                "pool_pages_total": self.n_pages,
                "pool_pages_free": len(self._free),
                # distinct pages some LANE currently holds (parked pages
                # excluded): the leak witness's kv-page gauge — a drained
                # scheduler must read 0 here (analysis/leakcheck.py)
                "pool_pages_in_use": len(
                    {p for blocks in self._lane_blocks for p in blocks}
                ),
                "pool_page_size": self.page_size,
                "pool_parked_sessions": len(self._parked),
                "pool_parked_pages": self._parked_pages,
                "pool_admits": self.admits,
                "pool_prefix_admits": self.prefix_admits,
                "pool_prefix_tokens_shared": self.prefix_tokens_shared,
                "pool_cow_copies": self.cow_copies,
                "pool_parked_evicted": self.parked_evicted,
                "pool_exhausted_sheds": self.exhausted_sheds,
                "pool_parked_total": self.parked_total,
                "pool_resets": self.pool_resets,
                "pool_adopts": self.adopts,
                "pool_adopted_pages_fresh": self.adopted_pages_fresh,
                "pool_swap_in_admits": self.swap_in_admits,
                "pool_host_pages_swapped_in": self.host_pages_swapped_in,
                # staged swap-outs the engine has not drained yet: the
                # host-page leak witness — a drained scheduler must read
                # 0 here (scheduler.leak_counts / analysis/leakcheck.py)
                "pool_swap_pending": len(self._pending_swapouts),
                **self.host_tier.stats(),
            }

    # -- internals (callers hold _lock) --------------------------------------

    def _clear_lane_locked(self, lane: int) -> None:
        self._lane_blocks[lane] = []
        self._lane_reg[lane] = 0
        self._lane_tip[lane] = _ROOT

    def _release_locked(self, lane: int) -> None:
        for p in self._lane_blocks[lane]:
            self._deref_locked(p)
        self._clear_lane_locked(lane)

    def _deref_locked(self, page: int) -> None:
        self._ref[page] -= 1
        if self._ref[page] > 0:
            return
        self._ref[page] = 0
        # remove the tree node this page backs (if any): children whose
        # parent chain just broke become unreachable for NEW matches but
        # stay refcounted by their own holders and remove themselves the
        # same way when their refs drain
        key = self._page_key.pop(page, None)
        if key is not None:
            self._nodes.pop(key, None)
            parent, blk = key
            kids = self._children.get(parent)
            if kids is not None:
                kids.pop(blk, None)
                if not kids:
                    self._children.pop(parent, None)
        self._free.append(page)

    def _evict_entry_locked(self, pid: int, swap: bool = True) -> None:
        blocks = self._parked.pop(pid)
        self._park_index.pop(tuple(blocks), None)
        for p in blocks:
            held = self._park_refs.get(p, 0) - 1
            if held <= 0:
                self._park_refs.pop(p, None)
                self._parked_pages -= 1
            else:
                self._park_refs[p] = held
            # tiered residency: a committed page about to FREE (this
            # deref is its last ref) is staged for swap-out instead of
            # silently dropping to rebuild — the engine drains the
            # staging list (device read -> HostTier.put) before any
            # write that could reuse the page. Captured BEFORE the
            # deref because _deref_locked removes the tree entry.
            if (
                swap
                and self.host_tier.enabled
                and self._ref[p] == 1
                and p in self._page_key
            ):
                node_key = self._page_key[p]
                self._pending_swapouts.append((node_key, node_key[1], p))
            self._deref_locked(p)
        self.parked_evicted += 1

    def _evict_oldest_locked(self) -> None:
        self._evict_entry_locked(next(iter(self._parked)))

    def _evict_parked_locked(self, short_by: int) -> None:
        """Evict parked sessions in LRU order until at least ``short_by``
        more pages are free, SKIPPING sessions that could free nothing —
        every page still pinned by an active lane or the admitting
        request's own shared-ref/COW pins (``ref > park holds`` on all of
        them). Evicting those would destroy a park entry — typically the
        very prefix the admission is sharing — while relieving zero
        pressure, and if the sharing request later failed with
        park=False the hot prefix would vanish from the tree for
        nothing. Eviction frees a session's pages only where its
        refcount drains to zero — blocks shared with an active lane
        stay resident either way. The admit()-side sufficiency check
        guarantees this pass reaches ``short_by`` whenever it runs."""
        before = len(self._free)
        for pid in list(self._parked):
            if len(self._free) - before >= short_by:
                break
            if any(
                self._ref[p] == self._park_refs.get(p, 0)
                for p in self._parked[pid]
            ):
                self._evict_entry_locked(pid)
