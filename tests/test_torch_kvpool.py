"""The port's paged KV pool bookkeeping (``runtime/kvpool.py``: the
ref-counted prefix tree, parking, LRU eviction, exhaustion, the host swap
tier) against the JAX package's ``KVPagePool`` and ``HostTier``.

Pure host code on both sides. ``test_kvpool_ops_equal_jax`` drives both
pools through the same seeded op sequences (admit, commit, finish with and
without parking, release, drop_parked, swap_out_parked, the engine's drain
through take_pending_swapouts, reset) with the share quantum at its
default, 1 (the JAX rule): every return, exception, table row and
``stats()`` is equal op for op. ``test_kvpool_case`` ports the JAX
package's pool unit tests (``tests/test_prefix_cache.py`` and
``tests/test_kv_swap_tier.py``) as cases of one test; the quantum tests
hold the port's one addition, ``admit(..., share_quantum=q)``.
"""

import hashlib

import numpy as np
import pytest

from distributed_llama_multiusers_tpu.disagg import kvtransfer as j_kvtransfer
from distributed_llama_multiusers_tpu.runtime import kvpool as jkv
from distributed_llama_multiusers_tpu_torch.disagg import KVTransferError, page_hash
from distributed_llama_multiusers_tpu_torch.runtime import kvpool as tkv
from distributed_llama_multiusers_tpu_torch.runtime.kvpool import (
    HostTier,
    HostTierCorrupt,
    KVPagePool,
    PoolExhausted,
)


def _payload(key, size: int = 96) -> bytes:
    """A page's bytes, a function of its tree node key (what a device
    read of a committed page gives: the same bytes for the same chain)."""
    seed = hashlib.sha256(repr(key).encode()).digest()
    return (seed * (size // len(seed) + 1))[:size]


def _drain(pool) -> int:
    """The engine's ``drain_kv_swapouts`` without a device."""
    pending = pool.take_pending_swapouts()
    for key, blk, _page in pending:
        pool.host_tier.put(key, blk, _payload(key))
    return len(pending)


def _call(fn, *args, **kw):
    """An op's outcome: ("ok", value) or ("raise", type name, details)."""
    try:
        return ("ok", fn(*args, **kw))
    except (jkv.PoolExhausted, tkv.PoolExhausted) as e:
        return ("raise", "PoolExhausted", e.pages_needed, e.pages_free, e.pages_total,
                e.host_tier_full, str(e))
    except (ValueError, RuntimeError) as e:
        return ("raise", type(e).__name__, str(e))


def _state(pool) -> dict:
    return {"stats": pool.stats(),
            "rows": [pool.table_row(pool.lane_blocks(i)) for i in range(pool.n_lanes)],
            "free": pool.pages_free(), "parked": pool.parked_sessions()}


def _ops(seed: int, n_ops: int, n_lanes: int, page: int):
    """A seeded op sequence over prompts that share prefixes (so the tree
    shares full blocks, copies a divergent one on write, parks, evicts
    under pressure and swaps)."""
    rng = np.random.default_rng(seed)
    bases = [list(rng.integers(1, 9, size=3 * page)) for _ in range(3)]
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        lane = int(rng.integers(n_lanes))
        if r < 0.4:
            base = bases[int(rng.integers(len(bases)))]
            cut = int(rng.integers(1, len(base) + 1))
            tail = list(rng.integers(1, 9, size=int(rng.integers(0, page + 2))))
            tokens = [int(t) for t in base[:cut] + tail] or [1]
            reserve = len(tokens) + int(rng.integers(0, 3 * page))
            ops.append(("admit", lane, tokens, reserve, int(rng.choice([0, 1, 4, page]))))
        elif r < 0.6:
            ops.append(("commit", lane, int(rng.integers(0, 2 * page))))
        elif r < 0.75:
            ops.append(("finish", lane, bool(rng.random() < 0.8)))
        elif r < 0.82:
            ops.append(("release", lane))
        elif r < 0.88:
            ops.append(("drop_parked",))
        elif r < 0.97:
            ops.append(("swap_out_parked",))
        else:
            ops.append(("reset",))
    return ops


@pytest.mark.parametrize("seed,n_pages,page,n_lanes,max_parked,host_bytes", [
    (0, 24, 4, 2, 4, 0),
    (1, 24, 4, 3, 2, 1 << 12),
    (2, 12, 4, 2, 8, 96 * 6),  # a tier that fills: LRU evictions, host_tier_full
    (3, 40, 8, 4, 64, 1 << 14),
    (4, 6, 2, 2, 1, 1 << 10),
    (5, 16, 1, 2, 3, 1 << 12),  # one-token pages
])
def test_kvpool_ops_equal_jax(seed, n_pages, page, n_lanes, max_parked, host_bytes):
    kw = dict(n_lanes=n_lanes, blocks_per_lane=n_pages, max_parked=max_parked,
              host_bytes=host_bytes)
    ours, theirs = KVPagePool(n_pages, page, **kw), jkv.KVPagePool(n_pages, page, **kw)
    # each lane's committed history: its prompt, then generated tokens
    history = {i: [] for i in range(n_lanes)}
    rng = np.random.default_rng(100 + seed)
    for step, op in enumerate(_ops(seed, 300, n_lanes, page)):
        kind = op[0]
        if kind == "admit":
            _, lane, tokens, reserve, min_share = op
            got = _call(ours.admit, lane, tokens, reserve, min_share)
            want = _call(theirs.admit, lane, tokens, reserve, min_share)
            if got[0] == "ok":
                history[lane] = list(tokens)
        elif kind == "commit":
            lane = op[1]
            history[lane] = history[lane] + [int(t) for t in rng.integers(1, 9, size=op[2])]
            got = _call(ours.commit, lane, history[lane])
            want = _call(theirs.commit, lane, history[lane])
        elif kind == "finish":
            got = _call(ours.finish, op[1], park=op[2])
            want = _call(theirs.finish, op[1], park=op[2])
        elif kind == "release":
            got, want = _call(ours.release, op[1]), _call(theirs.release, op[1])
        else:  # drop_parked, swap_out_parked, reset
            got, want = _call(getattr(ours, kind)), _call(getattr(theirs, kind))
        assert got == want, (step, op)
        # the engine drains staged swap-outs after every mutation
        assert _drain(ours) == _drain(theirs), (step, op)
        assert _state(ours) == _state(theirs), (step, op)
        for lane in range(n_lanes):
            assert ours.chain_pages(history[lane]) == theirs.chain_pages(history[lane])


def test_for_seq_len_and_table_row_equal_jax():
    for seq_len, lanes, page, pages in ((64, 2, 64, None), (64, 3, 16, None),
                                        (2048, 8, 64, None), (100, 2, 64, 7),
                                        (48, 2, 128, None)):
        a = KVPagePool.for_seq_len(seq_len, lanes, page_size=page, pool_pages=pages)
        b = jkv.KVPagePool.for_seq_len(seq_len, lanes, page_size=page, pool_pages=pages)
        assert (a.n_pages, a.page_size, a.blocks_per_lane, a.max_parked) == \
            (b.n_pages, b.page_size, b.blocks_per_lane, b.max_parked)
        assert a.table_row([3, 1]) == b.table_row([3, 1])
    for bad in (dict(page_size=0), dict(page_size=48), dict(pool_pages=0)):
        with pytest.raises(ValueError):
            KVPagePool.for_seq_len(64, 2, **bad)
    assert (tkv.DEFAULT_PAGE_SIZE, tkv.DEFAULT_MAX_PARKED) == \
        (jkv.DEFAULT_PAGE_SIZE, jkv.DEFAULT_MAX_PARKED) == (64, 64)
    assert tkv.blocks_for(129, 64) == jkv.blocks_for(129, 64) == 3


def test_page_hash_and_transfer_error_equal_jax():
    rng = np.random.default_rng(0)
    for page in (1, 4, 64):
        blk = tuple(int(t) for t in rng.integers(0, 1 << 20, size=page))
        data = rng.bytes(int(rng.integers(0, 4096)))
        assert page_hash(page, blk, data) == j_kvtransfer.page_hash(page, blk, data)
    e = KVTransferError("hash_mismatch", "page 3")
    assert isinstance(e, ValueError) and e.reason == "hash_mismatch"
    assert str(e) == str(j_kvtransfer.KVTransferError("hash_mismatch", "page 3"))


# -- the share quantum (the port's addition) ----------------------------------


def _parked_chain(pool, tokens):
    pool.admit(0, tokens, reserve_tokens=len(tokens) + 1)
    pool.commit(0, tokens)
    pool.finish(0, park=True)


@pytest.mark.parametrize("quantum,want", [(1, 14), (4, 12), (8, 8), (16, 0), (6, 12)])
def test_share_quantum_cuts_the_hit_to_whole_quanta(quantum, want):
    """A hit shares a multiple of the quantum and of the page size, and no
    copy-on-write block: quantum 1 is the JAX rule (three full blocks and
    two tokens by copy-on-write)."""
    pool = KVPagePool(64, 4, n_lanes=2)
    _parked_chain(pool, list(range(1, 17)))  # four full blocks
    prompt = list(range(1, 15)) + [99, 98, 97]  # diverges inside block 3
    start, blocks, copies, _ = pool.admit(1, prompt, reserve_tokens=24,
                                          share_quantum=quantum)
    assert start == want
    assert copies == ([] if quantum > 1 else [(copies[0][0], blocks[3])])
    assert pool.stats()["pool_cow_copies"] == (1 if quantum == 1 else 0)
    # the lane registers from the cut: a commit chains its own blocks on
    pool.commit(1, prompt)
    assert [b for b, _ in pool.chain_pages(prompt)] == \
        [tuple(prompt[i:i + 4]) for i in range(0, 16, 4)]


def test_share_quantum_cuts_swapped_blocks_too():
    """Blocks swapped back from the host tier count toward the hit and
    are cut with the resident ones: only whole quanta swap in."""
    pool = KVPagePool(16, 4, n_lanes=2, max_parked=4, host_bytes=1 << 12)
    tokens = list(range(1, 22))  # five full blocks and a token
    _parked_chain(pool, tokens)
    pool.swap_out_parked()
    assert _drain(pool) == 5
    start, _, copies, swapins = pool.admit(1, tokens, reserve_tokens=24, share_quantum=8)
    assert (start, copies, len(swapins)) == (16, [], 4)
    assert [payload for _, payload in swapins] == \
        [_payload(k) for k, _ in _chain_keys(tokens[:16], 4)]


def _chain_keys(tokens, page):
    key, out = (), []
    for i in range(0, len(tokens) // page * page, page):
        blk = tuple(tokens[i:i + page])
        key = (key, blk)
        out.append((key, blk))
    return out


# -- the JAX package's pool unit tests, one case each -------------------------


def _case_cow_at_divergent_block():
    pool = KVPagePool(n_pages=16, page_size=4, n_lanes=2)
    a = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    start, blocks, copies, _ = pool.admit(0, a, reserve_tokens=12, min_share_tokens=4)
    assert (start, copies) == (0, [])
    pool.commit(0, a + [11, 12])
    pool.finish(0, park=True)
    b = [1, 2, 3, 4, 5, 6, 99, 100, 101]
    start, blocks2, copies, _ = pool.admit(1, b, reserve_tokens=12, min_share_tokens=4)
    assert start == 6 and blocks2[0] == blocks[0] and blocks2[1] != blocks[1]
    assert copies == [(blocks[1], blocks2[1])]
    s = pool.stats()
    assert (s["pool_cow_copies"], s["pool_prefix_admits"], s["pool_prefix_tokens_shared"]) \
        == (1, 1, 6)


def _case_refcount_zero_page_reuse():
    pool = KVPagePool(n_pages=4, page_size=4, n_lanes=2, max_parked=4)
    toks = [1, 2, 3, 4, 5, 6]
    _, blocks, _, _ = pool.admit(0, toks, reserve_tokens=8)
    pool.commit(0, [1, 2, 3, 4, 5, 6, 7, 8])
    pool.finish(0, park=False)
    assert pool.pages_free() == 4
    start2, blocks2, _, _ = pool.admit(1, toks, reserve_tokens=8, min_share_tokens=1)
    assert start2 == 0 and sorted(blocks2) == sorted(blocks)
    pool.release(1)
    pool.admit(0, toks, reserve_tokens=8)
    pool.commit(0, [1, 2, 3, 4, 5, 6, 7, 8])
    pool.finish(0, park=True)
    assert (pool.parked_sessions(), pool.pages_free()) == (1, 2)
    assert pool.drop_parked() == 1 and pool.pages_free() == 4


def _case_exhaustion_evicts_parked_then_sheds():
    pool = KVPagePool(n_pages=4, page_size=4, n_lanes=2, max_parked=4)
    pool.admit(0, [1, 2, 3, 4, 5], reserve_tokens=8)
    pool.commit(0, [1, 2, 3, 4])
    pool.finish(0, park=True)
    pool.admit(1, list(range(10, 25)), reserve_tokens=16)
    assert pool.parked_sessions() == 0 and pool.stats()["pool_parked_evicted"] == 1
    with pytest.raises(PoolExhausted) as ei:
        pool.admit(0, [1, 2, 3], reserve_tokens=16)
    assert (ei.value.pages_needed, ei.value.pages_free, ei.value.pages_total) == (4, 0, 4)
    assert pool.stats()["pool_exhausted_sheds"] == 1


def _case_unservable_reservation_is_not_retryable():
    pool = KVPagePool(n_pages=3, page_size=4, n_lanes=2, blocks_per_lane=8, max_parked=4)
    pool.admit(0, [1, 2, 3, 4, 5], reserve_tokens=8)
    pool.commit(0, [1, 2, 3, 4])
    pool.finish(0, park=True)
    with pytest.raises(ValueError, match="pool holds 3 total"):
        pool.admit(1, [9, 9, 9], reserve_tokens=16)
    assert pool.parked_sessions() == 1
    assert pool.stats()["pool_parked_evicted"] == pool.stats()["pool_exhausted_sheds"] == 0
    assert pool.admit(1, [1, 2, 3, 4, 5], reserve_tokens=8, min_share_tokens=4)[0] == 4


def _case_repark_identical_chain_occupies_one_lru_slot():
    pool = KVPagePool(n_pages=16, page_size=4, n_lanes=2, max_parked=2)
    other = [9, 8, 7, 6, 5]
    pool.admit(0, other, reserve_tokens=8)
    pool.commit(0, [9, 8, 7, 6])
    pool.finish(0, park=True)
    toks = [1, 2, 3, 4, 5]
    for _ in range(4):
        pool.admit(0, toks, reserve_tokens=8, min_share_tokens=4)
        pool.commit(0, [1, 2, 3, 4])
        pool.finish(0, park=True)
    s = pool.stats()
    assert (s["pool_parked_sessions"], s["pool_parked_evicted"], s["pool_parked_pages"]) \
        == (2, 0, 2)
    assert pool.admit(1, other, reserve_tokens=8, min_share_tokens=4)[0] == 4
    assert pool.admit(0, toks, reserve_tokens=8, min_share_tokens=4)[0] == 4


def _case_eviction_skips_zero_yield_parked_sessions():
    pool = KVPagePool(n_pages=6, page_size=4, n_lanes=2, max_parked=4)
    a, b = list(range(1, 9)), list(range(11, 19))
    for chain in (a, b):
        pool.admit(0, chain + [99], reserve_tokens=9)
        pool.commit(0, chain)
        pool.finish(0, park=True)
    start, _, _, _ = pool.admit(1, a + list(range(30, 37)), reserve_tokens=17,
                                min_share_tokens=4)
    assert start == 8
    assert pool.stats()["pool_parked_evicted"] == 1 and pool.parked_sessions() == 1
    pool.release(1)
    assert pool.admit(1, a + [99], reserve_tokens=9, min_share_tokens=4)[0] == 8


def _case_shed_does_not_drain_parked_sessions():
    pool = KVPagePool(n_pages=4, page_size=4, n_lanes=2, max_parked=4)
    pool.admit(0, [1, 2, 3, 4, 5], reserve_tokens=8)
    pool.admit(1, [9, 9, 9, 9, 9], reserve_tokens=8)
    pool.commit(1, [9, 9, 9, 9])
    pool.finish(1, park=True)
    assert (pool.parked_sessions(), pool.pages_free()) == (1, 1)
    with pytest.raises(PoolExhausted):
        pool.admit(1, [7, 7, 7], reserve_tokens=16)
    assert pool.parked_sessions() == 1 and pool.stats()["pool_parked_evicted"] == 0
    pool.admit(1, [7, 7, 7], reserve_tokens=8)
    assert pool.parked_sessions() == 0 and pool.stats()["pool_parked_evicted"] == 1


def _case_duplicate_content_pages_freed_not_parked():
    pool = KVPagePool(n_pages=8, page_size=4, n_lanes=2, max_parked=4)
    toks = [1, 2, 3, 4, 5]
    pool.admit(0, toks, reserve_tokens=8)
    pool.admit(1, toks, reserve_tokens=8)
    pool.commit(0, [1, 2, 3, 4])
    pool.commit(1, [1, 2, 3, 4])
    pool.finish(0, park=True)
    pool.finish(1, park=True)
    s = pool.stats()
    assert (s["pool_parked_sessions"], s["pool_parked_pages"], pool.pages_free()) == (1, 1, 7)
    assert pool.admit(0, toks, reserve_tokens=8, min_share_tokens=4)[0] == 4


def _case_parked_pages_count_distinct_pages():
    pool = KVPagePool(n_pages=8, page_size=4, n_lanes=2)
    pool.admit(0, [1, 2, 3, 4, 5], reserve_tokens=8)
    pool.commit(0, [1, 2, 3, 4])
    pool.finish(0, park=True)
    b = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    pool.admit(1, b, reserve_tokens=12, min_share_tokens=4)
    pool.commit(1, [1, 2, 3, 4, 5, 6, 7, 8])
    pool.finish(1, park=True)
    s = pool.stats()
    assert (s["pool_parked_sessions"], s["pool_parked_pages"]) == (2, 2)
    assert pool.drop_parked() == 2
    assert pool.stats()["pool_parked_pages"] == 0 and pool.pages_free() == 8


def _case_eviction_cannot_free_matched_shared_pages():
    pool = KVPagePool(n_pages=4, page_size=4, n_lanes=2, max_parked=4)
    a = [1, 2, 3, 4, 5, 6, 7]
    _, a_blocks, _, _ = pool.admit(0, a, reserve_tokens=8)
    pool.commit(0, a + [8])
    pool.finish(0, park=True)
    b = [9, 10, 11, 12, 13, 14, 15]
    pool.admit(0, b, reserve_tokens=8)
    pool.commit(0, b + [16])
    pool.finish(0, park=True)
    assert pool.pages_free() == 0
    start, c_blocks, _, _ = pool.admit(1, a + [8, 17], reserve_tokens=16, min_share_tokens=4)
    assert start == 8 and c_blocks[:2] == a_blocks
    assert len(set(c_blocks)) == len(c_blocks) and not set(c_blocks) & set(pool._free)


def _case_below_threshold_admit_resets_tree_tip():
    pool = KVPagePool(n_pages=16, page_size=4, n_lanes=2)
    blk = [1, 2, 3, 4]
    pool.admit(0, blk + [5], reserve_tokens=8)
    pool.commit(0, blk)
    pool.finish(0, park=True)
    pool.admit(1, blk + [9], reserve_tokens=8, min_share_tokens=6)
    pool.commit(1, blk + [9, 9, 9, 9])
    pool.finish(1, park=True)
    start, _, copies, _ = pool.admit(0, blk + blk + [7], reserve_tokens=12, min_share_tokens=4)
    assert (start, copies) == (4, [])


def _case_host_tier_lru_byte_bound_eviction():
    blk, pay = (1, 2, 3, 4), b"x" * 100
    tier = HostTier(budget_bytes=250, page_size=4)
    assert tier.enabled and not tier.full()
    assert tier.put(("a",), blk, pay) and tier.put(("b",), blk, pay)
    assert tier.get(("a",), blk) == pay
    assert tier.put(("c",), blk, pay)
    s = tier.stats()
    assert (s["pool_host_pages"], s["pool_host_bytes"], s["pool_host_evicted"]) == (2, 200, 1)
    assert tier.get(("b",), blk) is None and tier.get(("a",), blk) == pay
    assert not tier.put(("big",), blk, b"y" * 300)
    assert tier.stats()["pool_host_full_drops"] == 1 and tier.stats()["pool_host_pages"] == 2
    off = HostTier(budget_bytes=0, page_size=4)
    assert not off.enabled and not off.put(("a",), blk, pay)


def _case_host_tier_rehash_failure_drops_entry_and_raises_typed():
    blk = (1, 2, 3, 4)
    tier = HostTier(budget_bytes=1 << 10, page_size=4)
    assert tier.put(("a",), blk, b"x" * 64)
    with tier._lock:
        tier._swapped[("a",)] = (b"y" * 64, tier._swapped[("a",)][1])
    with pytest.raises(HostTierCorrupt) as ei:
        tier.get(("a",), blk)
    assert isinstance(ei.value, ValueError)
    s = tier.stats()
    assert (s["pool_host_corrupt"], s["pool_host_pages"], s["pool_host_bytes"]) == (1, 0, 0)
    assert tier.get(("a",), blk) is None


def _case_host_tier_hash_framing_matches_disagg():
    blk = (7, 8, 9, 10)
    tier = HostTier(budget_bytes=1 << 10, page_size=4)
    tier.put(("k",), blk, b"payload-bytes")
    with tier._lock:
        stored = tier._swapped[("k",)][1]
    assert stored == page_hash(4, blk, b"payload-bytes") == \
        j_kvtransfer.page_hash(4, blk, b"payload-bytes")


def _case_drop_parked_stays_drop_no_tier_deposit():
    pool = KVPagePool(32, 4, n_lanes=2, max_parked=8, host_bytes=1 << 20)
    _parked_chain(pool, list(range(2, 22)))
    assert pool.drop_parked() == 1
    s = pool.stats()
    assert (s["pool_host_pages"], s["pool_swap_pending"]) == (0, 0)


def _case_host_bytes_zero_restores_drop_to_rebuild():
    pool = KVPagePool(32, 4, n_lanes=2, max_parked=8, host_bytes=0)
    tokens = list(range(2, 22))
    _parked_chain(pool, tokens)
    assert pool.swap_out_parked() == 1
    s = pool.stats()
    assert (s["pool_host_pages"], s["pool_swap_pending"], s["pool_host_budget_bytes"]) == \
        (0, 0, 0)
    start, _, _, swapins = pool.admit(1, tokens, reserve_tokens=24)
    assert (start, swapins) == (0, [])


def _case_reset_discards_pending_and_clears_tier():
    pool = KVPagePool(32, 4, n_lanes=2, max_parked=8, host_bytes=1 << 20)
    _parked_chain(pool, list(range(2, 22)))
    assert pool.swap_out_parked() == 1 and pool.stats()["pool_swap_pending"] > 0
    pool.reset()
    s = pool.stats()
    assert (s["pool_swap_pending"], s["pool_host_pages"], s["pool_resets"]) == (0, 0, 1)


def _case_corrupt_swap_entry_fails_admit_before_any_mutation():
    pool = KVPagePool(32, 4, n_lanes=2, max_parked=8, host_bytes=1 << 20)
    tokens = list(range(2, 22))
    _parked_chain(pool, tokens)
    pool.swap_out_parked()
    _drain(pool)
    tier = pool.host_tier
    with tier._lock:
        for key in list(tier._swapped):
            data, h = tier._swapped[key]
            tier._swapped[key] = (b"\xff" * len(data), h)
    free_before, nodes_before = len(pool._free), dict(pool._nodes)
    with pytest.raises(HostTierCorrupt):
        pool.admit(1, tokens, reserve_tokens=24)
    assert len(pool._free) == free_before and pool._nodes == nodes_before
    assert not pool._lane_blocks[1] and pool.stats()["pool_host_corrupt"] == 1
    assert pool.admit(1, tokens, reserve_tokens=24)[0] == 0


@pytest.mark.parametrize("case", [
    _case_cow_at_divergent_block,
    _case_refcount_zero_page_reuse,
    _case_exhaustion_evicts_parked_then_sheds,
    _case_unservable_reservation_is_not_retryable,
    _case_repark_identical_chain_occupies_one_lru_slot,
    _case_eviction_skips_zero_yield_parked_sessions,
    _case_shed_does_not_drain_parked_sessions,
    _case_duplicate_content_pages_freed_not_parked,
    _case_parked_pages_count_distinct_pages,
    _case_eviction_cannot_free_matched_shared_pages,
    _case_below_threshold_admit_resets_tree_tip,
    _case_host_tier_lru_byte_bound_eviction,
    _case_host_tier_rehash_failure_drops_entry_and_raises_typed,
    _case_host_tier_hash_framing_matches_disagg,
    _case_drop_parked_stays_drop_no_tier_deposit,
    _case_host_bytes_zero_restores_drop_to_rebuild,
    _case_reset_discards_pending_and_clears_tier,
    _case_corrupt_swap_entry_fails_admit_before_any_mutation,
], ids=lambda f: f.__name__[len("_case_"):])
def test_kvpool_case(case):
    case()
