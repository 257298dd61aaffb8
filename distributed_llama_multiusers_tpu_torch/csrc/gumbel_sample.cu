// The sampler's Gumbel-max draw on Hopper: per lane, the first index of the
// largest gumbel(fold_in(PRNGKey(seed), pos))[i] + logp[i].
//
// Replaces: no Pallas kernel. The JAX package computes this in XLA inside its
// compiled decode step (distributed_llama_multiusers_tpu/runtime/engine.py,
// `_sample_lane`: `jax.random.categorical(fold_in(PRNGKey(seed), pos),
// log(p))`). The port needs it as one launch: written as PyTorch ops,
// threefry's 20 rounds over every vocab element are about a hundred
// elementwise launches per sampled step.
//
// The bits are JAX's: threefry2x32 (jax._src.prng), fold_in as one hash of
// the counter pair (0, pos) under the key (0, seed), the partitionable layout
// (element i hashes (0, i) and keeps the XOR of the two words), the uniform
// on [tiny, 1) from the top 23 bits, and gumbel's low-range mode
// -log(-log(u)) with the full-precision logf (never __logf), so the noise
// agrees with the plain version (runtime/sampling.py) to the ulps of logf.
//
// Bound: one f32 read of the sorted log-probabilities (8 lanes x 128,256 at
// 1B serving is 4.1 MB, about 1.2 us at 3.35 TB/s); in practice the 20
// integer rounds and two logf per element bound it. Design: one thread block
// per lane, each thread walks the row with a block stride (coalesced reads),
// skips masked entries (log p = -inf can never win against a finite draw),
// keeps its running best and the block reduces (value, index) pairs, the
// lower index winning ties, as argmax does.

#include <cuda_runtime.h>
#include <stdint.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32: five groups of four rounds, a key injection after each
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
gumbel_sample_kernel(const float* __restrict__ logp, const long long* __restrict__ seeds,
                     const long long* __restrict__ pos, long long* __restrict__ out,
                     float* __restrict__ noise, int vocab) {
  const int lane = blockIdx.x;
  // fold_in(PRNGKey(seed), pos): the key (0, seed) hashes the pair (0, pos)
  uint32_t a = 0u, b = (uint32_t)pos[lane];
  threefry2x32(0u, (uint32_t)seeds[lane], a, b);
  const float* row = logp + (size_t)lane * (size_t)vocab;
  float best = -INFINITY;
  int best_i = vocab;  // sentinel: no finite entry seen
  for (int i = threadIdx.x; i < vocab; i += kThreads) {
    const float lp = row[i];
    if (lp == -INFINITY) continue;
    uint32_t x0 = 0u, x1 = (uint32_t)i;
    threefry2x32(a, b, x0, x1);
    const uint32_t bits = x0 ^ x1;
    const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    // uniform(minval=tiny, maxval=1): f * float32(1 - tiny) + tiny, held >= tiny
    const float u = fmaxf(FLT_MIN, f * (1.0f - FLT_MIN) + FLT_MIN);
    const float g = -logf(-logf(u));
    if (noise != nullptr) noise[(size_t)lane * (size_t)vocab + i] = g;  // tests only
    const float v = g + lp;
    if (v > best) {  // i grows within a thread: the first maximum stays
      best = v;
      best_i = i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (better(ov, oi, best, best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    sv[warp] = best;
    si[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      if (better(sv[w], si[w], best, best_i)) {
        best = sv[w];
        best_i = si[w];
      }
    }
    // every entry masked: argmax of an all -inf row is its first index
    out[lane] = best_i == vocab ? 0 : best_i;
  }
}

}  // namespace

// noise: nullptr, or [lanes, vocab] f32 that takes the draw's Gumbel noise at
// every unmasked entry (the tests hold it against the plain version's)
extern "C" int gumbel_sample_launch(const float* logp, const long long* seeds,
                                    const long long* pos, long long* out, float* noise,
                                    int lanes, int vocab, void* stream) {
  if (lanes < 1 || vocab < 1) return (int)cudaErrorInvalidValue;
  gumbel_sample_kernel<<<lanes, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      logp, seeds, pos, out, noise, vocab);
  return (int)cudaGetLastError();
}
