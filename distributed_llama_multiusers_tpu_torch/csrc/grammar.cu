// Grammar-constrained decoding on Hopper: the two operations every decode
// step family runs on every lane, every step.
//
// Replaces: no Pallas kernel. The JAX package computes both in XLA inside its
// compiled step families (distributed_llama_multiusers_tpu/runtime/engine.py):
//
// - grammar_mask_argmax (engine.py:493-505 `_g_bits`/`_g_mask_row`, then
//   `jnp.argmax`, :613-614): per row, the first index of the largest value
//   of the row masked by its automaton state's packed legal-token bits
//   (an entry whose bit `(masks[g][t >> 5] >> (t & 31)) & 1` is 0 counts as
//   -inf), optionally writing the masked row for the nucleus sampler;
// - grammar_next (engine.py:507-518 `_g_next1`, walked as `_g_walk_greedy`
//   walks a verify window): per row, the state after each token, a
//   lower-bound search of `state * vocab + token` over the sorted edge keys
//   (clipped to the last key), the edge's target on a hit, else the state's
//   default target.
//
// The argmax order is torch.argmax's and jnp.argmax's: a NaN is above every
// value (the first NaN wins), otherwise the larger value, ties to the lower
// index; -0.0 ties +0.0; an all -inf row returns 0. State 0 is the FREE state
// (every bit set), where the masked row is the row itself, bit for bit, and
// the index is torch.argmax's on it.
//
// Bound: grammar_mask_argmax reads each row once (R x V x 4 bytes) and its
// state's mask words (R x W x 4), and writes the masked rows when asked
// (R x V x 4 more): 4.23 MB at 8 x 128,256, about 1.3 us at 3.35 TB/s. Design
// (gumbel_sample.cu's): each row is cut into chunks of kChunk entries, one
// thread block each (grid: chunk, row), so a decode step's 8 rows fill the
// card in one wave; each thread takes kPer entries a block stride apart
// (coalesced; a warp's 32 entries share one mask word). Each block reduces
// its (value, index) pairs; a row of one chunk writes its index there.
// Otherwise each block stores its pair and takes an arrival ticket after a
// fence, and the last block of the row folds the chunks' pairs in chunk
// order and sets the ticket back to 0, so a caller's workspace stays valid
// for the next launch on the stream with no fill (a CUDA graph replays it as
// is). grammar_next is one thread a row: T binary searches of the ~16 steps
// over the edge keys, a few microseconds of launch latency whatever the work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;  // entries per thread block (ops/cuda_grammar.py CHUNK)
constexpr int kPer = kChunk / kThreads;
constexpr int kNone = INT_MAX;  // index of a pair that saw no entry
constexpr int kNextThreads = 128;

// the argmax order of torch.argmax / jnp.argmax on (value, index) pairs
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (vn || v == bv) return i < bi;
  return v > bv;
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

__device__ __forceinline__ long long clamp_state(long long g, int n_states) {
  return g < 0 ? 0 : (g >= n_states ? n_states - 1 : g);
}

__global__ void __launch_bounds__(kThreads)
mask_argmax_kernel(const float* __restrict__ rows, const long long* __restrict__ states,
                   const uint32_t* __restrict__ masks, long long* __restrict__ out,
                   float* __restrict__ masked, int masked_every, float* __restrict__ part_v,
                   int* __restrict__ part_i, unsigned* __restrict__ tickets, int vocab,
                   int words, int n_states) {
  const int chunk = blockIdx.x;
  const int row = blockIdx.y;
  const int n_chunks = gridDim.x;
  __shared__ bool s_last;
  const long long g = clamp_state(states[row], n_states);
  const float* x = rows + (size_t)row * (size_t)vocab;
  const uint32_t* m = masks + (size_t)g * (size_t)words;
  float* mo = (masked != nullptr && row % masked_every == 0)
                  ? masked + (size_t)(row / masked_every) * (size_t)vocab
                  : nullptr;
  const int i0 = chunk * kChunk + threadIdx.x;
  float v[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = i0 + e * kThreads;
    if (i < vocab) {
      const uint32_t w = __ldg(m + (i >> 5));
      v[e] = ((w >> (i & 31)) & 1u) ? x[i] : -INFINITY;
    }
  }
  float best = -INFINITY;
  int best_i = kNone;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {  // i grows with e: the first maximum stays
    const int i = i0 + e * kThreads;
    if (i >= vocab) continue;
    if (mo != nullptr) mo[i] = v[e];
    if (better(v[e], i, best, best_i)) {
      best = v[e];
      best_i = i;
    }
  }
  block_best(best, best_i);
  if (n_chunks == 1) {
    if (threadIdx.x == 0) out[row] = best_i == kNone ? 0 : best_i;
    return;
  }
  if (threadIdx.x == 0) {
    part_v[(size_t)row * n_chunks + chunk] = best;
    part_i[(size_t)row * n_chunks + chunk] = best_i;
    __threadfence();
    s_last = atomicAdd(&tickets[row], 1u) == (unsigned)(n_chunks - 1);
  }
  __syncthreads();
  if (!s_last) return;
  // the last block of the row: the chunks' pairs, in chunk order
  __threadfence();
  best = -INFINITY;
  best_i = kNone;
  for (int c = threadIdx.x; c < n_chunks; c += kThreads) {
    const float pv = __ldcg(part_v + (size_t)row * n_chunks + c);
    const int pi = __ldcg(part_i + (size_t)row * n_chunks + c);
    if (better(pv, pi, best, best_i)) {
      best = pv;
      best_i = pi;
    }
  }
  block_best(best, best_i);
  if (threadIdx.x == 0) {
    out[row] = best_i == kNone ? 0 : best_i;
    tickets[row] = 0u;  // every block of the row has arrived: ready for the next launch
  }
}

__global__ void __launch_bounds__(kNextThreads)
grammar_next_kernel(const long long* __restrict__ states, const long long* __restrict__ tokens,
                    int tok_stride, int steps, const int* __restrict__ keys,
                    const int* __restrict__ targets, const int* __restrict__ defaults,
                    int n_edges, int n_states, int vocab, long long* __restrict__ walk,
                    int walk_stride, long long* __restrict__ final_state, int n_rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  long long s = clamp_state(states[r], n_states);
  for (int t = 0; t < steps; ++t) {
    if (walk != nullptr) walk[(size_t)r * walk_stride + t] = s;
    const long long key = s * (long long)vocab + tokens[(size_t)r * tok_stride + t];
    int lo = 0, hi = n_edges;  // searchsorted, side left
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((long long)__ldg(keys + mid) < key) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int j = lo < n_edges ? lo : n_edges - 1;
    s = (long long)__ldg(keys + j) == key ? (long long)__ldg(targets + j)
                                          : (long long)__ldg(defaults + s);
  }
  if (walk != nullptr) walk[(size_t)r * walk_stride + steps] = s;
  if (final_state != nullptr) final_state[r] = s;
}

}  // namespace

// rows: [n_rows, vocab] f32; states: [n_rows] int64 (clamped to [0, n_states));
// masks: [n_states, words] 32-bit words, words = ceil(vocab / 32); out:
// [n_rows] int64. masked: null, or [ceil(n_rows / masked_every), vocab] f32
// taking row r's masked values at row r / masked_every where r % masked_every
// is 0. chunk: the caller's chunk length, which must be kChunk. With more than
// one chunk (vocab > chunk), work: [n_rows * (2 * ceil(vocab / chunk) + 1)]
// 32-bit words (the chunks' values, their indices, the rows' tickets) whose
// tickets are 0; the launch leaves them 0. Else work may be null.
extern "C" int grammar_mask_argmax_launch(const float* rows, const long long* states,
                                          const uint32_t* masks, long long* out,
                                          float* masked, int masked_every, void* work,
                                          int n_rows, int vocab, int words, int n_states,
                                          int chunk, void* stream) {
  if (n_rows < 1 || vocab < 1 || n_states < 1 || words != (vocab + 31) / 32 ||
      masked_every < 1 || chunk != kChunk || (vocab > kChunk && work == nullptr))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (vocab + kChunk - 1) / kChunk;
  float* part_v = static_cast<float*>(work);
  int* part_i = part_v == nullptr ? nullptr
                                  : reinterpret_cast<int*>(part_v + (size_t)n_rows * n_chunks);
  unsigned* tickets = part_i == nullptr
                          ? nullptr
                          : reinterpret_cast<unsigned*>(part_i + (size_t)n_rows * n_chunks);
  mask_argmax_kernel<<<dim3(n_chunks, n_rows), kThreads, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      rows, states, masks, out, masked, masked_every, part_v, part_i, tickets, vocab, words,
      n_states);
  return (int)cudaGetLastError();
}

// states: [n_rows] int64 (clamped to [0, n_states)); tokens: [n_rows, steps]
// int64, row r at tokens + r * tok_stride; keys, targets: [n_edges] int32, the
// keys sorted; defaults: [n_states] int32. walk: null, or [n_rows, steps + 1]
// int64 (row stride walk_stride) taking the state after the first t tokens at
// column t; final_state: null, or [n_rows] int64 taking the state after all
// of them.
extern "C" int grammar_next_launch(const long long* states, const long long* tokens,
                                   int tok_stride, int steps, const int* keys,
                                   const int* targets, const int* defaults, int n_edges,
                                   int n_states, int vocab, long long* walk, int walk_stride,
                                   long long* final_state, int n_rows, void* stream) {
  if (n_rows < 1 || steps < 0 || n_edges < 1 || n_states < 1 || vocab < 1 ||
      (walk != nullptr && walk_stride < steps + 1) || (steps > 0 && tok_stride < steps))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_rows + kNextThreads - 1) / kNextThreads;
  grammar_next_kernel<<<blocks, kNextThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      states, tokens, tok_stride, steps, keys, targets, defaults, n_edges, n_states, vocab, walk,
      walk_stride, final_state, n_rows);
  return (int)cudaGetLastError();
}
