"""Prompt-lookup draft index for speculative decoding (the JAX package's
``runtime/spec.py``, kept here so that the port imports nothing of it).

Drafts come from the token stream itself: the previous occurrence of the
current suffix n-gram (3-gram, falling back to 2-gram) proposes the tokens
that followed it; there is no draft model. The index is kept incrementally
(each committed token updates two dict entries), so a draft probe costs
O(k) per step, not a scan of the history.

The scheduler keeps one index per lane; ``SpecStream`` is the single
stream of the ``dllama`` CLI (inference and chat). The engine's verify
families (``InferenceEngine.decode_spec`` and the pipelined ones) keep the
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


class SpecStream:
    """Single-stream speculative decode for the CLI (inference and chat):
    prompt-lookup drafts plus a pending-lookahead buffer, so a greedy run
    emits more than one token per forward where drafts hit while keeping
    the plain-decode token stream (the speculative-verification identity).

    The per-stream twin of the scheduler's per-lane path; near seq_len a
    draft is clamped to the slots left."""

    def __init__(self, engine, config, enabled: bool, prompt_tokens=(),
                 multi_h: int = 0):
        """``multi_h`` > 1 turns on the multi-step fallback for greedy
        streams: where no draft hits, chain up to that many decode steps in
        one dispatch (``engine.decode_multi``) and serve the chained tokens
        from the same lookahead buffer drafts use. Callers at temperature
        > 0 leave it 0 (they sample from ``last_logits`` every step)."""
        import numpy as np

        self.engine = engine
        self.config = config
        self.spec_k = getattr(engine, "SPEC_DRAFT", 0)
        self.enabled = (enabled and self.spec_k > 0
                        and getattr(engine, "supports_speculative", False))
        self.drafter = NgramDraftIndex(prompt_tokens) if self.enabled else None
        self.multi_h = (multi_h if multi_h > 1 and getattr(engine, "supports_multi_step", False)
                        else 0)
        self.pending: list[int] = []  # produced but not yet emitted
        # whether `pending` came from a verify step (it counts in the
        # acceptance counters) or a multi-step horizon (it must not)
        self._pending_spec = False
        # tokens consumed from the current verify step's lookahead (seq[0]
        # counts at verify time): discard_pending retracts a partly used step
        self._pending_consumed = 0
        self._toks = np.zeros(engine.n_lanes, np.int32)
        self._poss = np.zeros(engine.n_lanes, np.int32)
        self.last_logits = None  # batch logits of the last real forward

    def extend_history(self, tokens) -> None:
        """Feed tokens that were not generated (a chat turn's prompt) to the
        draft index."""
        if self.drafter is not None:
            for t in tokens:
                self.drafter.append(int(t))

    def discard_pending(self) -> None:
        """Drop the unconsumed lookahead at a turn boundary (chat: tokens
        drafted past EOS are uncommitted cache writes the next prefill
        overwrites; the host buffer must go).

        A verify step whose lookahead was only partly consumed is retracted
        from the acceptance counters (``spec_lane_steps``, ``spec_emitted``):
        the acceptance ratio aggregates fully realized steps only, so a
        turn ending mid-lookahead neither deflates it nor strands a lane
        step. The counters never go below 0."""
        if self.pending and self._pending_spec:
            stats = getattr(self.engine, "stats", None)
            if stats is not None:
                with stats.lock:
                    stats.spec_lane_steps = max(0, stats.spec_lane_steps - 1)
                    stats.spec_emitted = max(0, stats.spec_emitted - self._pending_consumed)
        self.pending.clear()
        self._pending_spec = False
        self._pending_consumed = 0

    def flush_pipeline(self) -> None:
        """Flush a live pipelined chain before a direct engine call: this
        stream's steps thread the same KV cache, and a device-fed chain
        still in flight would feed tokens from a history the stream has
        moved past. A no-op with nothing in flight."""
        if getattr(self.engine, "pipeline_active", False):
            self.engine.pipeline_flush()

    def advance(self, cur: int, pos: int):
        """Commit ``cur`` at ``pos`` and return ``(next_token, used_forward)``.
        ``used_forward`` False: the token came from the lookahead (its cache
        write happened in the step that drafted it). Callers at temperature
        > 0 (speculation off) sample from ``last_logits`` instead of the
        returned greedy token."""
        import numpy as np

        if self.pending:
            if self.drafter is not None:
                self.drafter.append(cur)
            stats = getattr(self.engine, "stats", None)
            if stats is not None and self._pending_spec:
                with stats.lock:
                    stats.spec_emitted += 1  # a lookahead token consumed now
                self._pending_consumed += 1
            return self.pending.pop(0), False
        self.flush_pipeline()
        draft: list[int] = []
        if self.drafter is not None:
            d_max = min(self.spec_k, self.config.seq_len - pos - 1)
            if d_max > 0:
                draft = self.drafter.draft(cur, self.spec_k)[:d_max]
            self.drafter.append(cur)
        self._toks[0] = cur
        self._poss[0] = pos
        if draft:
            drafts = np.zeros((self.engine.n_lanes, self.spec_k), np.int32)
            dlen = np.zeros(self.engine.n_lanes, np.int32)
            drafts[0, :len(draft)] = draft
            dlen[0] = len(draft)
            _, em, ne = self.engine.decode_spec(self._toks, drafts, dlen, self._poss)
            seq = [int(t) for t in em[0, :int(ne[0])]]
            self.pending = seq[1:]
            self._pending_spec = True
            self._pending_consumed = 1  # seq[0], consumed below
            # consumed-only accounting, the scheduler's: the tokens still
            # pending count when popped (never, if a turn discards them)
            stats = getattr(self.engine, "stats", None)
            if stats is not None:
                with stats.lock:
                    stats.spec_lane_steps += 1
                    stats.spec_emitted += 1  # seq[0], consumed now
            return seq[0], True
        if self.multi_h > 1:
            # no draft: chain a horizon of plain decode steps. They feed cur
            # and chosen[0..h-2] at pos..pos+h-1; the last chosen token is
            # fed by a later advance's forward
            p = pow2_floor(min(self.multi_h, self.config.seq_len - pos))
            if p > 1:
                chosen = self.engine.decode_multi(self._toks, self._poss, h=p)
                seq = [int(chosen[j, 0]) for j in range(p)]
                self.pending = seq[1:]
                self._pending_spec = False
                return seq[0], True
        logits_b, greedy_b, _ = self.engine.decode(self._toks, self._poss)
        self.last_logits = logits_b
        return int(greedy_b[0]), True
