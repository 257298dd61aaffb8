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
// 1B serving is 4.1 MB, about 1.2 us at 3.35 TB/s), or the ~120 integer and
// float operations of each kept entry (20 threefry rounds, two logf), about
// 1.5 us for 410k kept entries at the f32 lane rate. Design: each lane's row
// is cut into chunks of kChunk entries, one thread block each, so a step's
// 8 lanes fill the card in one wave (grid: chunk, lane). The lane's key is
// hashed once per block. Each thread takes kPer entries of its chunk a
// block stride apart (coalesced reads) and hashes them together, so their
// rounds interleave; a warp whose entries are all masked (log p = -inf can
// never win against a finite draw) hashes nothing. The block reduces
// (value, index) pairs, the lower index winning ties, as argmax does; a
// lane of one chunk writes its choice there. Otherwise each block stores
// its pair and takes an arrival ticket after a fence, and the last block of
// the lane reduces the chunks' pairs in chunk order. The comparison is a
// total order on (value, index), so the choice never depends on arrival.

#include <cuda_runtime.h>
#include <stdint.h>
#include <float.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;  // entries per thread block (ops/cuda_sample.py CHUNK)
constexpr int kPer = kChunk / kThreads;  // entries per thread, hashed together
constexpr int kNone = INT_MAX;  // index of a pair that saw no finite entry

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
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

// the block's best (value, index) pair, left in thread 0
__device__ __forceinline__ void block_best(float& best, int& best_i) {
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (better(ov, oi, best, best_i)) {
      best = ov;
      best_i = oi;
    }
  }
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
  }
}

__global__ void __launch_bounds__(kThreads)
gumbel_sample_kernel(const float* __restrict__ logp, const long long* __restrict__ seeds,
                     const long long* __restrict__ pos, long long* __restrict__ out,
                     float* __restrict__ noise, float* __restrict__ part_v,
                     int* __restrict__ part_i, unsigned* __restrict__ tickets, int vocab) {
  const int chunk = blockIdx.x;
  const int lane = blockIdx.y;
  const int n_chunks = gridDim.x;
  // fold_in(PRNGKey(seed), pos): the key (0, seed) hashes the pair (0, pos)
  __shared__ uint32_t s_key[2];
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    uint32_t a = 0u, b = (uint32_t)pos[lane];
    threefry2x32(0u, (uint32_t)seeds[lane], a, b);
    s_key[0] = a;
    s_key[1] = b;
  }
  __syncthreads();
  const uint32_t ka = s_key[0], kb = s_key[1];
  const float* row = logp + (size_t)lane * (size_t)vocab;
  const int i0 = chunk * kChunk + threadIdx.x;
  float lp[kPer];
  bool any = false;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = i0 + e * kThreads;
    lp[e] = i < vocab ? row[i] : -INFINITY;
    any |= lp[e] != -INFINITY;
  }
  float best = -INFINITY;
  int best_i = kNone;
  if (__any_sync(0xffffffffu, any)) {
    float g[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      uint32_t x0 = 0u, x1 = (uint32_t)(i0 + e * kThreads);
      threefry2x32(ka, kb, x0, x1);
      const uint32_t bits = x0 ^ x1;
      const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
      // uniform(minval=tiny, maxval=1): f * float32(1 - tiny) + tiny, held >= tiny
      const float u = fmaxf(FLT_MIN, f * (1.0f - FLT_MIN) + FLT_MIN);
      g[e] = -logf(-logf(u));
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) {  // i grows with e: the first maximum stays
      if (lp[e] == -INFINITY) continue;
      const int i = i0 + e * kThreads;
      if (noise != nullptr) noise[(size_t)lane * (size_t)vocab + i] = g[e];  // tests only
      const float v = g[e] + lp[e];
      if (v > best) {
        best = v;
        best_i = i;
      }
    }
  }
  block_best(best, best_i);
  if (n_chunks == 1) {
    // every entry masked: argmax of an all -inf row is its first index
    if (threadIdx.x == 0) out[lane] = best_i == kNone ? 0 : best_i;
    return;
  }
  if (threadIdx.x == 0) {
    part_v[(size_t)lane * n_chunks + chunk] = best;
    part_i[(size_t)lane * n_chunks + chunk] = best_i;
    __threadfence();
    s_last = atomicAdd(&tickets[lane], 1u) == (unsigned)(n_chunks - 1);
  }
  __syncthreads();
  if (!s_last) return;
  // the last block of the lane: the chunks' pairs, in chunk order
  __threadfence();
  best = -INFINITY;
  best_i = kNone;
  for (int c = threadIdx.x; c < n_chunks; c += kThreads) {
    const float v = __ldcg(part_v + (size_t)lane * n_chunks + c);
    const int i = __ldcg(part_i + (size_t)lane * n_chunks + c);
    if (better(v, i, best, best_i)) {
      best = v;
      best_i = i;
    }
  }
  block_best(best, best_i);
  if (threadIdx.x == 0) out[lane] = best_i == kNone ? 0 : best_i;
}

}  // namespace

// noise: nullptr, or [lanes, vocab] f32 that takes the draw's Gumbel noise at
// every unmasked entry (the tests hold it against the plain version's).
// chunk: the caller's chunk length, which must be kChunk. With more than one
// chunk (vocab > chunk), scratch: [lanes * (2 * ceil(vocab / chunk) + 1)] 32-bit
// zeros (the chunks' values, their indices, the lanes' tickets); else null.
extern "C" int gumbel_sample_launch(const float* logp, const long long* seeds,
                                    const long long* pos, long long* out, float* noise,
                                    void* scratch, int lanes, int vocab, int chunk,
                                    void* stream) {
  if (lanes < 1 || vocab < 1 || chunk != kChunk || (vocab > kChunk && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (vocab + kChunk - 1) / kChunk;
  float* part_v = static_cast<float*>(scratch);
  int* part_i = part_v == nullptr ? nullptr : reinterpret_cast<int*>(part_v + (size_t)lanes * n_chunks);
  unsigned* tickets = part_i == nullptr ? nullptr
                                        : reinterpret_cast<unsigned*>(part_i + (size_t)lanes * n_chunks);
  gumbel_sample_kernel<<<dim3(n_chunks, lanes), kThreads, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      logp, seeds, pos, out, noise, part_v, part_i, tickets, vocab);
  return (int)cudaGetLastError();
}
