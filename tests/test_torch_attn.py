"""The port's decode attention (``ops/cuda_attn.py``) on the CPU, where its
wrapper runs the plain version, against the JAX package's dense attention
on the same inputs under the same position mask. Tolerance: 1e-6 of
max|JAX| (both f32; XLA and PyTorch order the sums differently). The
kernel itself is held against this plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_multiusers_tpu.models.llama import _dense_attention as jax_attention
from distributed_llama_multiusers_tpu_torch.ops import cuda_attn

TOL = 1e-6


def _inputs(seed, lanes, n_kv, group, hd, slots):
    rng = np.random.default_rng(seed)
    qf = rng.standard_normal((lanes, 1, n_kv, group, hd)).astype(np.float32)
    k = rng.standard_normal((lanes, slots + 1, n_kv, hd)).astype(np.float32)
    v = rng.standard_normal((lanes, slots + 1, n_kv, hd)).astype(np.float32)
    return qf, k, v


L = cuda_attn.SPLIT
# on and beside the kernel's split boundaries, and parked
BOUNDARY = [L - 1, L, L + 1, 2 * L - 1, 2 * L, 2 * L + 1, 3 * L, 10**6]


@pytest.mark.parametrize("lanes,n_kv,group,hd,s_len,seed,positions", [
    (2, 2, 2, 16, 64, 0, None), (8, 8, 4, 64, 256, 1, None), (3, 1, 7, 32, 40, 2, None),
    (8, 4, 4, 64, 2048, 3, None),  # one rank's shape of the 1B model at tp=2
    (8, 4, 4, 64, 2048, 4, BOUNDARY),
    (8, 2, 2, 16, 3 * L + 44, 5, BOUNDARY),  # an s_len that is no multiple of the split
    (4, 2, 4, 32, L, 6, BOUNDARY),  # one split: the last slot, the rest parked
    (8, 4, 4, 64, 2 * L, 7, BOUNDARY),  # two splits, each lane on or beside their edge
    (2, 1, 8, 128, L + 1, 8, None),  # the largest head and group the kernel takes
    (8, 8, 4, 64, 2048, 9, [2047] * 8),  # every lane live at the last slot
    (8, 4, 4, 64, 2048, 10, [2048] * 8)])  # every lane parked
def test_decode_attention_matches_jax(lanes, n_kv, group, hd, s_len, seed, positions):
    """Positions at the first slot, inside, at the last slot and parked
    past it (every slot attended), or on and beside the kernel's split
    boundaries."""
    qf, k, v = _inputs(seed, lanes, n_kv, group, hd, s_len)
    positions = positions or [0, s_len - 1, s_len, 5, s_len // 2, 1, 17, 3]
    pos = np.asarray(positions[:lanes], np.int64)[:, None]
    scale = 1.0 / hd ** 0.5
    cuda_attn.reset_counts()
    got = cuda_attn.decode_attention(torch.from_numpy(qf), torch.from_numpy(k),
                                     torch.from_numpy(v), torch.from_numpy(pos), scale, s_len)
    assert cuda_attn.COUNTS == {"launches": 0, "window_launches": 0, "plain_calls": 1}
    mask = np.arange(s_len)[None, None, :] <= pos[:, :, None]
    want = np.asarray(jax_attention(jnp.asarray(qf), jnp.asarray(k[:, :s_len]),
                                    jnp.asarray(v[:, :s_len]), jnp.asarray(mask), scale))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())


def test_decode_attention_lane_independent_on_cpu():
    """Lane 0's output does not move when the other lanes' positions or
    slots change (the plain version computes each lane apart)."""
    qf, k, v = _inputs(4, 4, 2, 2, 16, 64)
    qf, k, v = torch.from_numpy(qf), torch.from_numpy(k), torch.from_numpy(v)
    base = cuda_attn.decode_attention(qf, k, v, torch.full((4, 1), 10), 0.25, 64)
    k2 = k.clone()
    k2[1:] = k2[1:].flip(0)
    got = cuda_attn.decode_attention(qf, k2, v, torch.tensor([[10], [64], [0], [63]]), 0.25, 64)
    assert torch.equal(got[0], base[0])


def test_decode_attention_validates_shapes():
    qf, k, v = (torch.from_numpy(a) for a in _inputs(0, 2, 2, 2, 16, 8))
    pos = torch.zeros((2, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="qf"):
        cuda_attn.decode_attention(qf[:, 0], k, v, pos, 1.0, 8)
    with pytest.raises(ValueError, match="caches"):
        cuda_attn.decode_attention(qf, k[:, :, :1], v, pos, 1.0, 8)
    with pytest.raises(ValueError, match="caches"):
        cuda_attn.decode_attention(qf, k, v, pos, 1.0, 10)
    with pytest.raises(ValueError, match="positions"):
        cuda_attn.decode_attention(qf, k, v, pos[:, 0], 1.0, 8)
