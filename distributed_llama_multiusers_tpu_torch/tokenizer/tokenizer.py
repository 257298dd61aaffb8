"""BPE tokenizer over the `.t` format, with streaming UTF-8 decode.

Re-design of src/tokenizer.cpp:42-380. Same observable behavior:

- vocab is split into regular / special at ``bos_id`` (the reference's
  "unstable assumption", src/tokenizer.cpp:137-139)
- encode: greedy longest-special-token scan, byte-accumulation seeding, then
  iterative best-score pair merging (src/tokenizer.cpp:301-368)
- decode: per-token streaming with UTF-8 validation + recovery emitting
  U+FFFD, holding back incomplete trailing sequences (src/tokenizer.cpp:214-299)
"""

from __future__ import annotations

import heapq

from ..formats.tokenizer_file import TokenizerData, load_tokenizer_file

_FFFD = b"\xef\xbf\xbd"


class Tokenizer:
    def __init__(self, data: TokenizerData | str):
        if isinstance(data, str):
            data = load_tokenizer_file(data)
        self.data = data
        self.vocab: list[bytes] = data.vocab
        self.scores: list[float] = data.scores
        self.bos_id: int = data.bos_id
        self.eos_token_ids: list[int] = list(data.eos_token_ids)
        self.chat_template: str | None = data.chat_template
        self.vocab_size: int = data.vocab_size

        self.regular_vocab_size = self.bos_id
        self.special_vocab_size = self.vocab_size - self.regular_vocab_size
        # token string -> id for the regular vocab (replaces the reference's
        # qsort+bsearch TokenIndex table, src/tokenizer.cpp:141-146)
        self._regular: dict[bytes, int] = {}
        for i in range(self.regular_vocab_size):
            self._regular.setdefault(self.vocab[i], i)
        # special tokens in id order (the reference scans them in id order and
        # takes the first prefix match, src/tokenizer.cpp:186-194)
        self._specials: list[tuple[int, bytes]] = [
            (i, self.vocab[i]) for i in range(self.regular_vocab_size, self.vocab_size)
        ]
        # first-byte index over specials: the id-order scan only has to touch
        # candidates that can possibly match at this position (long prompts
        # otherwise pay n_specials startswith calls per byte)
        self._specials_by_first: dict[int, list[tuple[int, bytes]]] = {}
        for tid, piece in self._specials:
            if piece:
                self._specials_by_first.setdefault(piece[0], []).append((tid, piece))
        self._decode_pending = b""  # held-back bytes of an incomplete UTF-8 seq

    # ---- encode -----------------------------------------------------------

    def encode(
        self,
        text: str | bytes,
        add_bos: bool = True,
        add_special_tokens: bool = True,
    ) -> list[int]:
        if isinstance(text, str):
            text = text.encode("utf-8")
        tokens: list[int] = []
        if add_bos:
            tokens.append(self.bos_id)

        buf = b""
        i = 0
        n = len(text)
        while i < n:
            if add_special_tokens:
                special = self._find_special_at(text, i)
                if special is not None:
                    if buf:
                        raise ValueError(f"untokenizable bytes before special token: {buf!r}")
                    tokens.append(special)
                    i += len(self.vocab[special])
                    continue
            buf += text[i : i + 1]
            i += 1
            tid = self._regular.get(buf)
            if tid is not None:
                tokens.append(tid)
                buf = b""
        if buf:
            # the reference asserts here (src/tokenizer.cpp:337)
            raise ValueError(f"untokenizable trailing bytes: {buf!r}")

        return self._merge(tokens)

    def _merge(self, tokens: list[int]) -> list[int]:
        """Iterative best-score pair merging (src/tokenizer.cpp:340-368), as
        a heap over candidate pairs instead of the reference's full rescan
        per merge: O(n log n), not O(n^2), so 100k-char prompts admit without
        stalling the scheduler thread. Order is identical to the reference —
        it takes the strictly-best score scanning left to right, i.e. the
        EARLIEST pair on ties, and merges only remove elements, so original
        position order equals current order and (-score, left_pos) keys pop
        in exactly the reference's merge sequence."""
        n = len(tokens)
        if n < 2:
            return tokens
        ids = list(tokens)
        nxt = list(range(1, n + 1))  # n = end sentinel
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap: list[tuple[float, int, int, int, int]] = []

        def push(j: int) -> None:
            k = nxt[j]
            if k >= n:
                return
            a, b = ids[j], ids[k]
            if a >= self.vocab_size or b >= self.vocab_size:
                return
            merged = self._regular.get(self.vocab[a] + self.vocab[b])
            # > -1e10: the reference's best-score sentinel never merges
            # pairs at or below it (src/tokenizer.cpp:342)
            if merged is not None and self.scores[merged] > -1e10:
                heapq.heappush(heap, (-self.scores[merged], j, merged, a, b))

        for j in range(n - 1):
            push(j)
        while heap:
            _, j, merged, a, b = heapq.heappop(heap)
            k = nxt[j]
            # stale entry: one side merged away or re-merged since the push
            if not alive[j] or k >= n or ids[j] != a or ids[k] != b:
                continue
            ids[j] = merged
            alive[k] = False
            nxt[j] = nxt[k]
            if nxt[k] < n:
                prv[nxt[k]] = j
            if prv[j] >= 0:
                push(prv[j])
            push(j)
        return [ids[j] for j in range(n) if alive[j]]

    def _find_special_at(self, text: bytes, pos: int) -> int | None:
        # candidates share the first byte; kept in id order so the first
        # prefix match is the same one the reference's scan picks
        # (src/tokenizer.cpp:186-194)
        for tid, piece in self._specials_by_first.get(text[pos], ()):
            if text.startswith(piece, pos):
                return tid
        return None

    # ---- decode -----------------------------------------------------------

    def is_eos(self, token: int) -> bool:
        return token in self.eos_token_ids

    def make_stream_decoder(self) -> "StreamDecoder":
        """Independent streaming decoder — one per concurrent request lane
        (the reference has a single shared strBuffer, src/tokenizer.cpp:154,
        which the multi-user loop bypassed entirely — defect (e))."""
        return StreamDecoder(self)

    def reset_decoder(self) -> None:
        self._decode_pending = b""

    def decode(self, token: int) -> str | None:
        """Streaming decode of one token; returns the printable delta or None.

        Mirrors Tokenizer::decode (src/tokenizer.cpp:281-299): BOS yields
        nothing; EOS flushes any held-back bytes; other tokens append their
        piece and emit the longest valid UTF-8 prefix.
        """
        if token == self.bos_id:
            return None
        if self.is_eos(token):
            if self._decode_pending:
                out = self._decode_pending.decode("utf-8", errors="replace")
                self._decode_pending = b""
                return out
            return None
        piece = self.vocab[token]
        return self._detok_utf8(self._decode_pending + piece)

    def decode_full(self, tokens: list[int]) -> str:
        """Non-streaming convenience: decode a whole sequence."""
        self.reset_decoder()
        parts = [self.decode(t) for t in tokens]
        pending = self._decode_pending.decode("utf-8", errors="replace")
        self._decode_pending = b""
        return "".join(p for p in parts if p) + pending

    def _detok_utf8(self, data: bytes) -> str | None:
        out, self._decode_pending = _detok_utf8(data)
        return out


def _detok_utf8(data: bytes) -> tuple[str | None, bytes]:
    """Pure port of detokUtf8 (src/tokenizer.cpp:214-279): emit the valid
    prefix, collapse runs of invalid bytes into a single U+FFFD, return
    (text, held-back bytes of an incomplete trailing sequence)."""
    out = bytearray()
    i = 0
    n = len(data)
    checkpoint_out = 0  # bytes of `out` confirmed (ends on char boundary)
    checkpoint_src = 0
    expect = 0
    while i < n:
        c = data[i]
        need_recovery = False
        if expect:
            if (c & 0xC0) == 0x80:
                out.append(c)
                i += 1
                expect -= 1
            else:
                need_recovery = True
        elif c <= 0x7F:
            out.append(c)
            i += 1
        elif 0xC0 <= c <= 0xDF:
            out.append(c)
            i += 1
            expect = 1
        elif 0xE0 <= c <= 0xEF:
            out.append(c)
            i += 1
            expect = 2
        elif 0xF0 <= c <= 0xF7:
            out.append(c)
            i += 1
            expect = 3
        else:
            need_recovery = True

        if not need_recovery:
            if expect == 0:
                checkpoint_out = len(out)
                checkpoint_src = i
        else:
            if expect:
                expect = 0
            else:
                i += 1
            del out[checkpoint_out:]
            out += _FFFD
    pending = data[checkpoint_src:] if i > checkpoint_src else b""
    if checkpoint_out > 0:
        return bytes(out[:checkpoint_out]).decode("utf-8", errors="replace"), pending
    return None, pending


class StreamDecoder:
    """Per-request streaming decoder sharing a Tokenizer's vocab but owning
    its own held-back-bytes state, so concurrent lanes never interleave."""

    def __init__(self, tokenizer: Tokenizer):
        self._t = tokenizer
        self._pending = b""

    def decode(self, token: int) -> str | None:
        t = self._t
        if token == t.bos_id:
            return None
        if t.is_eos(token):
            if self._pending:
                out = self._pending.decode("utf-8", errors="replace")
                self._pending = b""
                return out
            return None
        out, self._pending = _detok_utf8(self._pending + t.vocab[token])
        return out

    def reset(self) -> None:
        self._pending = b""
