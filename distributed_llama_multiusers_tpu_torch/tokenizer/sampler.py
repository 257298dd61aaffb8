"""Token sampler — greedy / temperature / top-p, with the reference's RNG.

Port of Sampler (src/tokenizer.cpp:382-510). The xorshift64* RNG and the
nucleus-sampling cutoff pre-filter are reproduced exactly so that seeded runs
are comparable with the reference; the softmax runs in float32.
"""

from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1


def _random_u32(state: int) -> tuple[int, int]:
    """xorshift64* (src/tokenizer.cpp:25-31). Returns (value, new_state)."""
    state &= _MASK64
    state ^= state >> 12
    state ^= (state << 25) & _MASK64
    state ^= state >> 27
    state &= _MASK64
    return ((state * 0x2545F4914F6CDD1D) & _MASK64) >> 32, state


def _random_f32(state: int) -> tuple[float, int]:
    u, state = _random_u32(state)
    return (u >> 8) / 16777216.0, state


class Sampler:
    def __init__(self, vocab_size: int, temperature: float, topp: float, rng_seed: int):
        self.vocab_size = vocab_size
        self.temperature = float(temperature)
        self.topp = float(topp)
        self.rng_state = int(rng_seed) & _MASK64

    def set_temp(self, temperature: float) -> None:
        self.temperature = float(temperature)

    def set_seed(self, seed: int) -> None:
        self.rng_state = int(seed) & _MASK64

    def sample(self, logits: np.ndarray) -> int:
        logits = np.asarray(logits, dtype=np.float32)[: self.vocab_size]
        if self.temperature == 0.0:
            return int(np.argmax(logits))
        x = logits / self.temperature
        x = x - x.max()
        probs = np.exp(x, dtype=np.float32)
        probs /= probs.sum(dtype=np.float32)
        coin, self.rng_state = _random_f32(self.rng_state)
        if self.topp <= 0 or self.topp >= 1:
            return self._sample_mult(probs, coin)
        return self._sample_topp(probs, coin)

    @staticmethod
    def _sample_mult(probs: np.ndarray, coin: float) -> int:
        cdf = np.cumsum(probs, dtype=np.float64)
        idx = int(np.searchsorted(cdf, coin, side="right"))
        return min(idx, len(probs) - 1)

    def _sample_topp(self, probs: np.ndarray, coin: float) -> int:
        n = len(probs)
        # cutoff pre-filter (src/tokenizer.cpp:426-433)
        cutoff = (1.0 - self.topp) / (n - 1)
        idx = np.nonzero(probs >= cutoff)[0]
        if len(idx) == 0:
            # nothing passes the pre-filter (tiny topp over a near-uniform
            # distribution); the reference reads out of bounds here — fall
            # back to plain multinomial instead
            return self._sample_mult(probs, coin)
        order = idx[np.argsort(-probs[idx], kind="stable")]
        p = probs[order]
        csum = np.cumsum(p, dtype=np.float64)
        over = np.nonzero(csum > self.topp)[0]
        last = int(over[0]) if len(over) else len(order) - 1
        cumulative = float(csum[last])
        r = coin * cumulative
        pick = int(np.searchsorted(csum[: last + 1], r, side="right"))
        return int(order[min(pick, last)])
