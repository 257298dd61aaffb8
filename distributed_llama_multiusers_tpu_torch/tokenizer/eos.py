"""Streaming stop-string detector.

Port of EosDetector (src/tokenizer.cpp:614-699): an incremental matcher over
decoded text that holds back bytes which may be the prefix of a stop string,
with left/right padding tolerance, emitting a safe delta for streaming UIs.
"""

from __future__ import annotations

from enum import IntEnum


class EosResult(IntEnum):
    MAYBE_EOS = 0
    EOS = 1
    NOT_EOS = 2


class EosDetector:
    def __init__(self, eos_token_ids: list[int], pieces: list[str], padding_left: int, padding_right: int):
        self.tokens = list(eos_token_ids)
        self.pieces = list(pieces)
        self.padding_left = padding_left
        self.padding_right = padding_right
        self._buffer = ""
        self._eos_pos: int = -1

    def is_eos(self, token_id: int) -> bool:
        return token_id in self.tokens

    def append(self, token_id: int, piece: str | None) -> EosResult:
        if piece is not None:
            self._buffer += piece

        if self.is_eos(token_id):
            self._eos_pos = len(self._buffer)
            return EosResult.EOS
        self._eos_pos = -1

        buffer_pos = len(self._buffer)
        for s, stop in enumerate(self.pieces):
            piece_size = len(stop)
            if buffer_pos > piece_size + self.padding_left + self.padding_right:
                continue
            for lo in range(self.padding_left + 1):
                n = buffer_pos - lo
                # n <= 0 must be skipped: the reference's `n > pieceSize +
                # paddingRight` is an int/size_t comparison, so negative n
                # wraps and skips the iteration (src/tokenizer.cpp:674)
                if n <= 0 or n > piece_size + self.padding_right:
                    continue
                if n > piece_size:
                    n = piece_size
                if self._buffer[lo : lo + n] == stop[:n]:
                    if n == piece_size:
                        # full stop string found: truncate buffer at its start
                        self._eos_pos = lo
                        self._buffer = self._buffer[:lo]
                        return EosResult.EOS
                    return EosResult.MAYBE_EOS
        return EosResult.NOT_EOS

    def get_delta(self) -> str | None:
        """The emit-safe text accumulated so far (src/tokenizer.cpp:690-695)."""
        if not self._buffer and self._eos_pos <= 0:
            return None
        if self._eos_pos == 0:
            return None
        return self._buffer if self._buffer else None

    def reset(self) -> None:
        self._buffer = ""
