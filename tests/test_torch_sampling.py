"""The port's sampler against the JAX package's, on the CPU.

- threefry2x32, ``fold_in(PRNGKey(seed), pos)``, the random bits and the
  uniforms on [tiny, 1) equal ``jax.random``'s bit for bit over a grid of
  (seed, pos); the Gumbel noise agrees to the ulps of ``log`` (stated
  below);
- the full sampler (nucleus + Gumbel-max draw) picks the JAX engine's
  tokens (its own vmapped ``_sample_lane``) over 512 (seed, pos, temp,
  topp) cases at vocab 512, ties in the logits included;
- the port engine's seeded streams (the prefill boundary token and the
  decode steps) equal the JAX engine's token for token on the tiny model.

Tolerance: ``log`` differs by at most one ulp between XLA's CPU code and
torch's, so -log(-log(u)) differs by at most GUMBEL_ATOL (a few ulps of
values of order 1); the bits, keys and uniforms are compared exactly and
the choices must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_multiusers_tpu.formats import load_model_header as j_load_header
from distributed_llama_multiusers_tpu.formats.synthetic import tiny_header, write_synthetic_model
from distributed_llama_multiusers_tpu.models import load_params_from_m as j_load_params
from distributed_llama_multiusers_tpu.runtime import InferenceEngine as JaxEngine
from distributed_llama_multiusers_tpu_torch.formats import load_model_header
from distributed_llama_multiusers_tpu_torch.models import load_params_from_m_quantized
from distributed_llama_multiusers_tpu_torch.ops import cuda_sample
from distributed_llama_multiusers_tpu_torch.runtime import InferenceEngine
from distributed_llama_multiusers_tpu_torch.runtime import sampling as S

GUMBEL_ATOL = 1e-6
SEEDS = (0, 1, 7, 42, 123456, 2**31 + 5, 2**32 - 1)
POSITIONS = (0, 1, 5, 63, 1000, 2047, 131071)
VOCAB = 512


def _jax_key(seed, pos):
    return jax.random.fold_in(jax.random.PRNGKey(jnp.uint32(seed)), jnp.int32(pos))


def _key_data(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def test_threefry_hash_equals_jax():
    """The raw hash against ``jax._src.prng.threefry_2x32`` on random keys
    and counters."""
    from jax._src import prng

    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, size=(16, 2), dtype=np.uint64).astype(np.uint32)
    count = rng.integers(0, 2**32, size=64, dtype=np.uint64).astype(np.uint32)
    for k in keys:
        want = np.asarray(prng.threefry_2x32(jnp.asarray(k), jnp.asarray(count))).astype(np.int64)
        x0, x1 = S.threefry2x32(int(k[0]), int(k[1]), torch.from_numpy(count[:32].astype(np.int64)),
                                torch.from_numpy(count[32:].astype(np.int64)))
        np.testing.assert_array_equal(np.concatenate([x0.numpy(), x1.numpy()]), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bits_uniforms_equal_jax(seed):
    """Per position: the folded key, ``jax.random.bits`` and
    ``jax.random.uniform(minval=tiny, maxval=1)`` bit for bit; the Gumbel
    noise within GUMBEL_ATOL."""
    tiny = np.finfo(np.float32).tiny
    k0, k1 = S.fold_in_keys(torch.full((len(POSITIONS),), seed), torch.tensor(POSITIONS))
    bits = S.random_bits(k0, k1, VOCAB)
    uni = S.uniform_from_bits(bits)
    gum = S.gumbel_noise(k0, k1, VOCAB)
    for i, pos in enumerate(POSITIONS):
        key = _jax_key(seed, pos)
        np.testing.assert_array_equal([int(k0[i]), int(k1[i])], _key_data(key))
        want_bits = np.asarray(jax.random.bits(key, (VOCAB,), jnp.uint32)).astype(np.int64)
        np.testing.assert_array_equal(bits[i].numpy(), want_bits)
        want_u = np.asarray(jax.random.uniform(key, (VOCAB,), jnp.float32, minval=tiny,
                                               maxval=1.0))
        np.testing.assert_array_equal(uni[i].numpy().view(np.int32), want_u.view(np.int32))
        want_g = np.asarray(jax.random.gumbel(key, (VOCAB,), jnp.float32))
        np.testing.assert_allclose(gum[i].numpy(), want_g, rtol=0, atol=GUMBEL_ATOL)


@pytest.fixture(scope="module")
def jax_sampler(tmp_path_factory):
    """The JAX engine's own vmapped ``_sample_lane`` at vocab 512 (a tiny
    model of that vocabulary)."""
    path = str(tmp_path_factory.mktemp("vocab512") / "m.m")
    write_synthetic_model(path, tiny_header(vocab_size=VOCAB), seed=3)
    config, params = j_load_params(path, j_load_header(path), dtype=jnp.float32)
    return jax.jit(JaxEngine(config, params, n_lanes=1)._sample_lanes)


@pytest.mark.parametrize("batch", range(8))
def test_categorical_choices_equal_jax(jax_sampler, batch):
    """64 lanes a batch, 512 cases over the 8 batches: rows of random
    logits (odd batches rounded to integers, so the sort meets ties),
    temperatures and top-p across their rules, seeds and positions; the
    port's choice equals the JAX engine's everywhere."""
    rng = np.random.default_rng(100 + batch)
    n = 64
    rows = (rng.standard_normal((n, VOCAB)) * 3).astype(np.float32)
    if batch % 2:
        rows = np.round(rows).astype(np.float32)
    temps = rng.choice(np.float32([0.0, 0.3, 0.7, 1.0, 1.5]), n).astype(np.float32)
    topps = rng.choice(np.float32([0.0, 0.5, 0.8, 0.9, 0.95, 1.0]), n).astype(np.float32)
    seeds = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    positions = rng.integers(0, 4096, n).astype(np.int32)
    greedy = rows.argmax(-1).astype(np.int32)
    want = np.asarray(jax_sampler(jnp.asarray(rows), jnp.asarray(temps), jnp.asarray(topps),
                                  jnp.asarray(seeds), jnp.asarray(positions),
                                  jnp.asarray(greedy)))
    got = S.sample_lanes(torch.from_numpy(rows), torch.from_numpy(temps),
                         torch.from_numpy(topps), torch.from_numpy(seeds.astype(np.int64)),
                         torch.from_numpy(positions.astype(np.int64)),
                         torch.from_numpy(greedy.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sort_ties_keep_lower_index_first():
    """Equal logits sort lower index first and -0.0 below +0.0, as
    ``lax.top_k`` orders them."""
    row = torch.tensor([[1.0, 3.0, -0.0, 1.0, 0.0, 3.0, -2.0, 0.0, 3.0, -0.0]])
    _, idx = S.nucleus_logp(row, torch.tensor([1.0]), torch.tensor([1.0]))
    _, jidx = jax.lax.top_k(jnp.asarray(row.numpy()[0]), 10)
    assert idx[0].tolist() == np.asarray(jidx).tolist() == [1, 5, 8, 0, 3, 4, 7, 2, 9, 6]


def test_plain_gumbel_argmax_counts_plain_calls():
    """On a CPU tensor the kernel's wrapper runs the plain version and
    counts it; an all-masked row picks its first index, as argmax does."""
    cuda_sample.reset_counts()
    logp = torch.full((2, 8), float("-inf"))
    logp[1, 5] = 0.0
    got = cuda_sample.gumbel_argmax(logp, torch.tensor([1, 2]), torch.tensor([3, 4]))
    assert got.tolist() == [0, 5]
    assert cuda_sample.COUNTS == {"launches": 0, "plain_calls": 1}
    with pytest.raises(ValueError, match="must be"):
        cuda_sample.gumbel_argmax(logp, torch.tensor([1]), torch.tensor([3, 4]))


def _edge_rows(vocab, rng):
    """Rows the sampler kernel's chunks must get right: every entry masked,
    only the last entry finite, a random nucleus (the sorted log p of a
    top-p of 0.9 at temperature 0.8)."""
    masked = np.full(vocab, -np.inf, np.float32)
    last = masked.copy()
    last[-1] = 0.0
    logp, _ = S.nucleus_logp(torch.from_numpy(rng.standard_normal((1, vocab)).astype(np.float32)
                                              * 3), torch.tensor([0.8]), torch.tensor([0.9]))
    return np.stack([masked, last, logp[0].numpy()])


# vocab 1, widths below, on, across and past the kernel's chunk, ones that are
# no multiple of it, the 1B model's and a 151,936-entry vocabulary
C = cuda_sample.CHUNK


@pytest.mark.parametrize("vocab", [1, 31, C - 1, C, C + 1, 2 * C, 2 * C + 1, 3 * C + 1,
                                   128256, 151936])
def test_gumbel_argmax_edge_rows_equal_jax(vocab):
    """The draw's wrapper (the plain version on the CPU) against
    ``jax.random.categorical(fold_in(PRNGKey(seed), pos), log p)`` on the
    edge rows, over several (seed, pos): an all -inf row picks 0, a row
    whose only finite entry is its last picks it."""
    rows = _edge_rows(vocab, np.random.default_rng(vocab))
    for seed, pos in ((0, 0), (7, 63), (2**32 - 1, 2047)):
        n = len(rows)
        got = cuda_sample.gumbel_argmax(torch.from_numpy(rows), torch.full((n,), seed),
                                        torch.full((n,), pos))
        want = [int(jax.random.categorical(_jax_key(seed, pos), jnp.asarray(r))) for r in rows]
        assert got.tolist() == want
        assert want[:2] == [0, vocab - 1]


@pytest.fixture(scope="module")
def engines(tiny_model):
    path = tiny_model["model"]
    config, params = load_params_from_m_quantized(path, load_model_header(path),
                                                  dtype=torch.float32, device="cpu")
    jconfig, jparams = j_load_params(path, j_load_header(path), dtype=jnp.float32)

    def make():
        return (InferenceEngine(config, params, n_lanes=3, prefill_buckets=(4, 16),
                                device="cpu"),
                JaxEngine(jconfig, jparams, n_lanes=3, prefill_buckets=(4, 16)))

    return make


@pytest.mark.parametrize("seed", [0, 42, 2**32 - 1])
def test_engine_seeded_streams_equal_jax(engines, seed):
    """Three lanes (greedy, temp 0.9/topp 0.8, temp 1.3/topp 1.0), each
    prompt prefilled with its own sampler settings: the sampled boundary
    tokens and 12 decode steps equal the JAX engine's token for token."""
    prompts = [[5, 9, 3], [7, 2, 8, 1, 4, 4], [11, 3, 9, 9, 2, 6, 1, 5, 8, 2, 7, 3, 3, 1, 9, 2, 4]]
    temps = np.asarray([0.0, 0.9, 1.3], np.float32)
    topps = np.asarray([0.9, 0.8, 1.0], np.float32)
    seeds = np.asarray([seed, seed + 1, seed ^ 77], np.uint64).astype(np.uint32)
    streams = []
    for eng in engines():
        toks, positions, out = [], [], []
        for lane, prompt in enumerate(prompts):
            pos = 0
            for start in range(0, len(prompt), eng.max_chunk()):
                chunk = prompt[start:start + eng.max_chunk()]
                _, greedy, sampled = eng.prefill_chunk(
                    lane, chunk, pos, temp=float(temps[lane]), topp=float(topps[lane]),
                    seed=int(seeds[lane]))
                pos += len(chunk)
            toks.append(greedy if temps[lane] == 0 else sampled)
            positions.append(pos)
        toks, positions = np.asarray(toks), np.asarray(positions)
        out.append(toks.copy())
        for _ in range(12):
            _, greedy, sampled = eng.decode(toks, positions, temps, topps, seeds)
            toks = np.where(temps == 0, greedy, sampled)
            positions = positions + 1
            out.append(toks.copy())
        streams.append(np.stack(out).astype(np.int64))
    np.testing.assert_array_equal(streams[0], streams[1])
