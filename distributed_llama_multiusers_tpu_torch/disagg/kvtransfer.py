"""The KV page integrity frame, the port's copy of the JAX package's
``disagg/kvtransfer.py`` ``page_hash`` and ``KVTransferError``.

The host swap tier (``runtime/kvpool.HostTier``) hashes every payload it
stores with ``page_hash`` and re-verifies it on the way back in; the
transfer bundles that carry pages between replicas frame them the same
way, so the two serializers cannot drift. The bundles (export, decode,
adopt) are later work. Pure stdlib.
"""

from __future__ import annotations

import hashlib

# the hash domain: a page hash can never collide with another sha256 use
_HASH_DOMAIN = b"dllama-kvpage-v1\0"


class KVTransferError(ValueError):
    """Typed transfer failure (malformed bundle, geometry mismatch,
    integrity-hash mismatch): the importing replica's pool is untouched,
    never a partial adoption."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"kv transfer failed ({reason})"
                         + (f": {detail}" if detail else ""))


def _le32(value: int) -> bytes:
    return int(value).to_bytes(4, "little", signed=True)


def page_hash(page_size: int, tokens, payload: bytes) -> str:
    """Integrity hash of one page: sha256 over a canonical framing of
    (page_size, block tokens, payload bytes). The tokens are part of the
    framing on purpose: a payload attached to the wrong block fails
    verification even when the bytes themselves are intact."""
    h = hashlib.sha256(_HASH_DOMAIN)
    h.update(_le32(page_size))
    h.update(_le32(len(tokens)))
    for t in tokens:
        h.update(_le32(t))
    h.update(len(payload).to_bytes(8, "little"))
    h.update(payload)
    return h.hexdigest()
