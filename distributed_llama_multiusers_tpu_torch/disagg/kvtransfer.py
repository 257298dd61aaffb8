"""Bulk KV-page export/import between replicas (disaggregated prefill):
the port's copy of the JAX package's ``disagg/kvtransfer.py``, with the
same wire format byte for byte, so a bundle exported by one package is
adopted by the other (at the same page geometry and cache dtype).

The transfer unit is the paged pool's committed block chain: only FULL
blocks enter the prefix tree (``runtime/kvpool.py``'s granularity rule),
and a committed block's content is immutable — so a prefill replica can
export a session's prefix pages while its lane keeps decoding, and the
bytes cannot tear. The bundle is plain JSON (the fleet's admin plane is
HTTP + stdlib everywhere):

```
{"v": 1, "page_size": 16, "n_tokens": 4096,
 "blocks": [{"t": [tokens...], "p": "<base64 payload>", "h": "<sha256>"},
            ...]}
```

``h`` is :func:`page_hash` over a canonical framing of (page_size, block
tokens, payload bytes) — computed by the EXPORTER and re-verified by the
importer before any pool mutation, so a torn or corrupted transfer dies
with a typed :class:`KVTransferError` instead of adopting garbage KV
that every future same-prefix admission would silently share.

The host swap tier (``runtime/kvpool.HostTier``) hashes every payload it
stores with the same ``page_hash``, so the two serializers cannot drift.

Adoption is refcount-correct by construction: :meth:`KVPagePool.adopt`
reuses chain blocks the local tree already holds (refcount bump, no
payload write) and allocates only the missing suffix; the whole chain is
pinned by a park entry — the exact accounting a local
``finish(park=True)`` produces — so the adopted prefix survives until a
real admission shares it or LRU pressure evicts it. Only FRESH pages get
their payload imported (``engine.import_kv_page``: one in-place indexed
copy a plane, ordered on the compute stream before every later step).

A payload whose size is not the destination engine's page size (another
page geometry, or another cache dtype: an e4m3 page is half a bf16 page)
raises the typed ``KVTransferError`` before the pool changes.

Pure stdlib: the engine hooks are duck-typed (``export_kv_page``,
``import_kv_page``, and ``kv_page_bytes`` where the engine has it), so
this module imports neither torch nor numpy.
"""

from __future__ import annotations

import base64
import hashlib

BUNDLE_VERSION = 1
# canonical framing domain separator: versioned so a framing change can
# never silently collide with old hashes
_HASH_DOMAIN = b"dllama-kvpage-v1\0"


class KVTransferError(ValueError):
    """Typed transfer failure (malformed bundle, geometry mismatch,
    integrity-hash mismatch): the importing replica's pool is untouched
    and the router falls back to the monolithic path — never a partial
    adoption."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"kv transfer failed ({reason})"
                         + (f": {detail}" if detail else ""))


def _le32(value: int) -> bytes:
    return int(value).to_bytes(4, "little", signed=True)


def page_hash(page_size: int, tokens, payload: bytes) -> str:
    """Integrity hash of one transferred page: sha256 over a canonical
    framing of (page_size, block tokens, payload bytes). The tokens are
    part of the framing on purpose — a payload attached to the WRONG
    block (an off-by-one page mix-up in transit) fails verification even
    when the bytes themselves are intact."""
    h = hashlib.sha256(_HASH_DOMAIN)
    h.update(_le32(page_size))
    h.update(_le32(len(tokens)))
    for t in tokens:
        h.update(_le32(t))
    h.update(len(payload).to_bytes(8, "little"))
    h.update(payload)
    return h.hexdigest()


def export_bundle(pool, engine, tokens) -> dict:
    """Export the committed prefix chain over ``tokens`` as a transfer
    bundle. ``pool`` is the session's :class:`~..runtime.kvpool.
    KVPagePool`, ``engine`` anything with ``export_kv_page(page) ->
    bytes``. The chain may be empty (prompt shorter than one block, or
    nothing committed yet) — the bundle still carries the geometry so
    the importer can distinguish "nothing to adopt" from a bad reply."""
    blocks = []
    for blk, page in pool.chain_pages(list(tokens)):
        payload = bytes(engine.export_kv_page(page))
        blocks.append({
            "t": [int(t) for t in blk],
            "p": base64.b64encode(payload).decode("ascii"),
            "h": page_hash(pool.page_size, blk, payload),
        })
    return {
        "v": BUNDLE_VERSION,
        "page_size": int(pool.page_size),
        "n_tokens": len(list(tokens)),
        "blocks": blocks,
    }


def decode_bundle(pool, bundle: dict) -> list[tuple[list[int], bytes]]:
    """Validate a bundle against the DESTINATION pool's geometry and
    verify every page hash; returns ``(block_tokens, payload)`` pairs in
    chain order. Raises :class:`KVTransferError` BEFORE any pool
    mutation — verification is the importer's first step, so a corrupt
    bundle can never partially adopt."""
    if not isinstance(bundle, dict) or bundle.get("v") != BUNDLE_VERSION:
        raise KVTransferError(
            "bundle_version",
            f"got {bundle.get('v') if isinstance(bundle, dict) else bundle!r}"
            f", want {BUNDLE_VERSION}",
        )
    if int(bundle.get("page_size", -1)) != int(pool.page_size):
        raise KVTransferError(
            "page_size_mismatch",
            f"bundle {bundle.get('page_size')} vs pool {pool.page_size} — "
            "replicas disagree on --kv-page-size",
        )
    out: list[tuple[list[int], bytes]] = []
    for i, blk in enumerate(bundle.get("blocks") or ()):
        try:
            tokens = [int(t) for t in blk["t"]]
            payload = base64.b64decode(blk["p"], validate=True)
            want = str(blk["h"])
        except (KeyError, TypeError, ValueError) as e:
            raise KVTransferError(
                "malformed_block", f"block {i}: {type(e).__name__}: {e}"
            ) from e
        if len(tokens) != pool.page_size:
            raise KVTransferError(
                "partial_block",
                f"block {i} holds {len(tokens)} tokens, want "
                f"{pool.page_size} — only full committed blocks transfer",
            )
        got = page_hash(pool.page_size, tokens, payload)
        if got != want:
            raise KVTransferError(
                "integrity",
                f"block {i} hash mismatch (got {got[:16]}…, "
                f"want {want[:16]}…) — transfer corrupted, not adopting",
            )
        out.append((tokens, payload))
    return out


def check_page_bytes(engine, pairs) -> None:
    """Every payload must be one of ``engine``'s pages (K then V, its
    geometry, its cache dtype) before anything mutates: another geometry
    or dtype raises ``KVTransferError("page_bytes")``. Engines without
    ``kv_page_bytes`` leave the size check to ``import_kv_page``."""
    size = getattr(engine, "kv_page_bytes", None)
    if not callable(size):
        return
    want = int(size())
    for i, (_tokens, payload) in enumerate(pairs):
        if len(payload) != want:
            raise KVTransferError(
                "page_bytes",
                f"block {i} carries {len(payload)} bytes, this replica's "
                f"pages are {want} — replicas disagree on the model, "
                "--kv-dtype or --workers",
            )


def adopt_bundle(pool, engine, bundle: dict) -> dict:
    """Verify + adopt a transfer bundle into ``pool``, importing fresh
    pages' payloads through ``engine.import_kv_page``. Returns the
    adoption receipt ``{"pages": n, "fresh": n, "reused": n}``.

    Order of operations is the safety argument: (1) every hash verifies
    (:func:`decode_bundle`) and every payload is one of this engine's
    pages (:func:`check_page_bytes`) before anything mutates; (2) ``pool.adopt``
    registers the chain — it either completes or raises with the pool
    untouched (:class:`~..runtime.kvpool.PoolExhausted` propagates as
    the caller's typed shed); (3) only then do payload writes dispatch,
    and only for FRESH pages — reused pages already hold identical
    content by the tree's content-hash keying, so skipping them is not
    an optimization but the correctness rule (their bytes may be live
    read targets of co-resident lanes)."""
    pairs = decode_bundle(pool, bundle)
    if not pairs:
        return {"pages": 0, "fresh": 0, "reused": 0}
    check_page_bytes(engine, pairs)
    pages, fresh = pool.adopt([tokens for tokens, _ in pairs])
    # adopt() may have evicted parked pages and staged them for the host
    # swap tier: drain (device gather -> host store) BEFORE the payload
    # imports below could reuse those pages. Duck-typed like the import
    # hook — engines without a swap tier simply skip.
    drain = getattr(engine, "drain_kv_swapouts", None)
    if callable(drain):
        drain()
    for idx, page in fresh:
        engine.import_kv_page(page, pairs[idx][1])
    return {
        "pages": len(pages),
        "fresh": len(fresh),
        "reused": len(pages) - len(fresh),
    }
