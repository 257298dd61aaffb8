"""The `.t` tokenizer file format.

Format (reference src/tokenizer.cpp:42-170, converter/tokenizer-writer.py):

    int32 magic = 0x567124
    int32 headerSize               # 8 + 8*nKv
    (int32 key, int32 value) * nKv
    chat template bytes (if CHAT_TEMPLATE present; value = byte length)
    int32 eosTokenId * N_EOS_TOKENS
    per token: (float32 score, uint32 length, bytes)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import BinaryIO

TOKENIZER_MAGIC = 0x567124

KEY_TOK_VERSION = 0
KEY_TOK_VOCAB_SIZE = 1
KEY_MAX_TOKEN_LENGTH = 2
KEY_BOS_ID = 3
KEY_EOS_ID = 4  # backward compat: appends to eos list
KEY_PAD_ID = 5  # ignored
KEY_CHAT_EOS_ID = 6  # backward compat: appends to eos list
KEY_CHAT_TEMPLATE = 7
KEY_CHAT_STOP = 8  # ignored (value bytes skipped)
KEY_N_EOS_TOKENS = 9


@dataclass
class TokenizerData:
    vocab: list[bytes] = field(default_factory=list)
    scores: list[float] = field(default_factory=list)
    bos_id: int = -1
    eos_token_ids: list[int] = field(default_factory=list)
    chat_template: str | None = None
    max_token_length: int = 0

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


def write_tokenizer_file(f: BinaryIO, data: TokenizerData) -> None:
    """Mirror of converter/tokenizer-writer.py:3-56."""
    n_tokens = len(data.vocab)
    max_token_length = max(len(t) for t in data.vocab)
    chat_template = data.chat_template.encode("utf-8") if data.chat_template else None

    pairs = [
        (KEY_BOS_ID, data.bos_id),
        (KEY_TOK_VERSION, 1),
        (KEY_TOK_VOCAB_SIZE, n_tokens),
        (KEY_MAX_TOKEN_LENGTH, max_token_length),
    ]
    if chat_template:
        pairs.append((KEY_CHAT_TEMPLATE, len(chat_template)))
    pairs.append((KEY_N_EOS_TOKENS, len(data.eos_token_ids)))

    body = b"".join(struct.pack("<ii", k, v) for k, v in pairs)
    f.write(struct.pack("<i", TOKENIZER_MAGIC))
    f.write(struct.pack("<i", 8 + len(body)))
    f.write(body)
    if chat_template:
        f.write(chat_template)
    for eos in data.eos_token_ids:
        f.write(struct.pack("<i", eos))
    for token, score in zip(data.vocab, data.scores):
        assert len(token) > 0
        f.write(struct.pack("<fI", score, len(token)))
        f.write(token)


def load_tokenizer_file(path: str) -> TokenizerData:
    """Mirror of Tokenizer::Tokenizer (src/tokenizer.cpp:42-170), new format only."""
    data = TokenizerData()
    with open(path, "rb") as f:
        magic = struct.unpack("<i", f.read(4))[0]
        if magic != TOKENIZER_MAGIC:
            raise ValueError("Invalid tokenizer file (old 0x567123 format not supported)")
        header_size = struct.unpack("<i", f.read(4))[0]
        n_kv = (header_size - 8) // 8
        buf = f.read(n_kv * 8)
        version = -1
        chat_template_length = -1
        n_eos_tokens = 0
        vocab_size = 0
        skip_after_header = 0
        for i in range(n_kv):
            key, value = struct.unpack_from("<ii", buf, i * 8)
            if key == KEY_TOK_VERSION:
                version = value
            elif key == KEY_TOK_VOCAB_SIZE:
                vocab_size = value
            elif key == KEY_MAX_TOKEN_LENGTH:
                data.max_token_length = value
            elif key == KEY_BOS_ID:
                data.bos_id = value
            elif key in (KEY_EOS_ID, KEY_CHAT_EOS_ID):
                data.eos_token_ids.append(value)
            elif key == KEY_CHAT_TEMPLATE:
                chat_template_length = value
            elif key == KEY_CHAT_STOP:
                skip_after_header += value
            elif key == KEY_PAD_ID:
                pass
            elif key == KEY_N_EOS_TOKENS:
                n_eos_tokens = value
            else:
                raise ValueError(f"Invalid tokenizer header key: {key}")
        if version != 1:
            raise ValueError("Old tokenizer version, please regenerate your tokenizer")
        if skip_after_header:
            f.read(skip_after_header)
        if chat_template_length > 0:
            data.chat_template = f.read(chat_template_length).decode("utf-8")
        for _ in range(n_eos_tokens):
            data.eos_token_ids.append(struct.unpack("<i", f.read(4))[0])
        for _ in range(vocab_size):
            score, length = struct.unpack("<fI", f.read(8))
            data.vocab.append(f.read(length))
            data.scores.append(score)
        if data.max_token_length < 1:
            raise ValueError("Invalid tokenizer max token length")
    return data
