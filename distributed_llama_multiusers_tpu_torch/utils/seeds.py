"""Sampler seed generation: OS entropy, never the wall clock (the port's
copy of the JAX package's ``utils/seeds.py``).

``int(time.time())`` seeds hand identical sampler streams to every session
that starts in the same clock tick, and an NTP step can even replay past
seeds. ``dllama chat`` without ``--seed`` draws its seed here.
"""

from __future__ import annotations

import time

# xorshift64* (tokenizer/sampler.py) has 0 as a fixed point: a zero seed
# would sample token 0 forever. Substitute when entropy lands on 0.
_ZERO_FALLBACK = 0x9E3779B9  # golden-ratio constant, arbitrary non-zero


def fresh_seed() -> int:
    """Fresh 32-bit sampler seed from OS entropy (``np.random.SeedSequence``
    pools ``os.urandom``); monotonic-clock fallback where numpy is absent.
    Never returns 0."""
    try:
        import numpy as np

        seed = int(np.random.SeedSequence().generate_state(1)[0])
    except ImportError:  # pragma: no cover - numpy is a hard dependency
        seed = time.monotonic_ns() & 0xFFFFFFFF
    return seed or _ZERO_FALLBACK
