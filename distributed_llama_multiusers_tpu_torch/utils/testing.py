"""Tokenizers for harnesses that drive the scheduler and the server without
a ``.t`` file (the JAX package's ``utils/testing.py``; only the byte-level
tokenizer structured-output tests need, and the stub it builds on)."""

from __future__ import annotations


class StubStreamTokenizer:
    """Minimal stream-decoder tokenizer for scheduler-only harnesses (the
    measurement is the scheduler loop, not BPE). EOS id = vocab_size, never
    produced, so requests run to max_tokens."""

    class _Vocab:  # TokenizerChatStops renders eos pieces from .vocab
        def __getitem__(self, i) -> bytes:
            return b"</s>"

    def __init__(self, vocab_size: int = 64, prompt_tokens: int = 8):
        self.vocab_size = vocab_size
        self.prompt_tokens = prompt_tokens
        self.eos_token_ids = [vocab_size]
        self.chat_template = None
        self.bos_id = 1
        self.vocab = self._Vocab()

    def encode(self, text, add_bos=True, add_special_tokens=True):
        n = max(1, min(len(text), self.prompt_tokens))
        return [(7 + i) % self.vocab_size for i in range(n)]

    def make_stream_decoder(self):
        return self

    def decode(self, token):  # stream-decoder protocol
        return "x"


class ByteJsonTokenizer(StubStreamTokenizer):
    """Byte-level tokenizer for grammar-constrained harnesses: id 0 = BOS
    (special), ids 1..256 = the raw bytes 0..255, id 257 = EOS. Every byte
    is a token, so the automaton's token closure is the character machine
    itself and constrained streams decode to real text a test can
    ``json.loads``. ``token_table()`` feeds ``engine.grammar_init`` (None
    for the specials, bytes elsewhere)."""

    def __init__(self):
        super().__init__(vocab_size=258)
        self.eos_token_ids = [257]
        self.bos_id = 0
        # a recognizable template marker, so the server's chat route works
        # against this tokenizer (the rendered text is plain bytes anyway)
        self.chat_template = "[INST]"

    def token_table(self):
        return [None] + [bytes([i]) for i in range(256)] + [None]

    def encode(self, text, add_bos=True, add_special_tokens=True):
        data = text.encode("utf-8", errors="replace") or b"?"
        out = [0] if add_bos else []
        return out + [1 + b for b in data]

    def decode(self, token):  # stream-decoder protocol
        # BOS/EOS yield nothing; ids past the byte range (model vocab
        # padding an unconstrained lane can pick) render as nothing too:
        # only grammar-masked lanes are guaranteed in range
        if not 1 <= int(token) <= 256:
            return None
        # latin-1 keeps the byte value verbatim, so the concatenated stream
        # text reconstructs the constrained byte stream exactly
        return bytes([int(token) - 1]).decode("latin-1")
