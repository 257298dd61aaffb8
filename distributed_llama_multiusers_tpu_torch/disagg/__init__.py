"""Disaggregated prefill (the DistServe/Splitwise pattern): prefill and
decode as independently scalable fleet resources, the port's copy of the
JAX package's ``disagg/``.

- :mod:`.kvtransfer`: bulk KV-page export/import on top of
  ``runtime/kvpool.py``: integrity-hashed page bundles (the JAX package's
  wire format), refcount-correct adoption into the destination pool's
  prefix tree, over HTTP between replicas (``server/http.py``'s admin
  routes); ``page_hash`` also frames the host swap tier's payloads.
- :mod:`.prefill`: the hand-off orchestration: prompt-length
  classification, the prefill worker contract (prefill on the prefill
  replica, the first token proves the pages are committed), and the
  page-transfer and ticket-migration sequence that moves the session to a
  decode replica char-exact (``fleet/migrate.py``).

Pure stdlib: no torch, no numpy. The device half stays in
``runtime/engine.py`` behind ``export_kv_page``/``import_kv_page``.
"""

from .kvtransfer import (
    BUNDLE_VERSION,
    KVTransferError,
    adopt_bundle,
    check_page_bytes,
    decode_bundle,
    export_bundle,
    page_hash,
)
from .prefill import (
    DEFAULT_LONG_PROMPT_CHARS,
    HandoffAborted,
    classify_prompt,
    fetch_pages,
    hand_off,
    prompt_chars,
    push_pages,
)

__all__ = [
    "BUNDLE_VERSION",
    "KVTransferError",
    "adopt_bundle",
    "check_page_bytes",
    "decode_bundle",
    "export_bundle",
    "page_hash",
    "DEFAULT_LONG_PROMPT_CHARS",
    "HandoffAborted",
    "classify_prompt",
    "fetch_pages",
    "hand_off",
    "prompt_chars",
    "push_pages",
]
