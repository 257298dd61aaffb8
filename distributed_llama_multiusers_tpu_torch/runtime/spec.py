"""Prompt-lookup draft index for speculative decoding (the JAX package's
``runtime/spec.py``, kept here so that the port imports nothing of it).

Drafts come from the token stream itself: the previous occurrence of the
current suffix n-gram (3-gram, falling back to 2-gram) proposes the tokens
that followed it; there is no draft model. The index is kept incrementally
(each committed token updates two dict entries), so a draft probe costs
O(k) per step, not a scan of the history.

The scheduler keeps one index per lane. The engine's verify families
(``InferenceEngine.decode_spec`` and the pipelined ones) keep the
speculative-verification identity: greedy token streams are exactly the
plain-decode streams.
"""

from __future__ import annotations

# drafts per speculative step (SPEC_DRAFT + 1 tokens verified per lane)
SPEC_DRAFT = 3


def pow2_floor(h: int) -> int:
    """Largest power of two <= h (0 for h < 1): the multi-step horizon
    buckets, so that warmup captures the horizons serving dispatches."""
    return 1 << (h.bit_length() - 1) if h >= 1 else 0


class NgramDraftIndex:
    """Committed token history + n-gram -> last-start-position index."""

    GRAM_SIZES = (2, 3)

    def __init__(self, tokens=()):
        self.hist: list[int] = []
        self._last: dict = {}
        for t in tokens:
            self.append(t)

    def append(self, tok: int) -> None:
        self.hist.append(tok)
        for g in self.GRAM_SIZES:
            if len(self.hist) >= g:
                self._last[(g, tuple(self.hist[-g:]))] = len(self.hist) - g

    def draft(self, next_token: int, k: int) -> list[int]:
        """Up to k draft tokens continuing (hist + [next_token]). Each probe
        gram ends at a token not yet committed, so a hit is always a
        strictly earlier occurrence; the draft extends by probing again
        over the virtual tail (hist + next_token + the tokens drafted so
        far), so a short-period stream, whose last occurrence sits at the
        end of the history and offers at most period - 1 tokens in one
        lookup, still drafts the full k (the pipelined chain spends one
        candidate on the carry, so single probes could never accelerate a
        period-2 stream)."""
        hist = self.hist
        nh = len(hist)
        # the virtual region: next_token + the tokens drafted so far,
        # indexed past the history without copying it
        virt = [next_token]

        def at(i: int) -> int:
            return hist[i] if i < nh else virt[i - nh]

        # grams ending strictly before the current tail (a probe never
        # matches itself): a period-p stream's only earlier occurrence sits
        # p tokens back, inside the virtual region after a few drafts
        overlay: dict = {}
        gmax = sorted(self.GRAM_SIZES, reverse=True)
        while len(virt) <= k:
            total = nh + len(virt)
            nxt = None
            for g in gmax:
                if total < g:
                    continue
                tail = tuple(at(total - g + j) for j in range(g))
                j = overlay.get((g, tail))
                if j is None:
                    j = self._last.get((g, tail))
                if j is not None and j + g < total:
                    nxt = at(j + g)
                    break
            if nxt is None:
                break
            # the tail's own grams become matches once a token follows them
            for g in self.GRAM_SIZES:
                if total >= g:
                    overlay[(g, tuple(at(total - g + j) for j in range(g)))] = total - g
            virt.append(nxt)
        return virt[1:]
