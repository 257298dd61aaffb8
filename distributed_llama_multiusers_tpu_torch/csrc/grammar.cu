// Grammar-constrained decoding on Hopper: the two operations every decode
// step family runs on every lane, every step.
//
// Replaces: no Pallas kernel. The JAX package computes both in XLA inside its
// compiled step families (distributed_llama_multiusers_tpu/runtime/engine.py
// :493-518):
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
// the index is torch.argmax's on it. The kernel folds each (value, index)
// pair as one 64-bit key whose unsigned order is that order (argmax_key), so
// a fold is a max, and any grouping of the maxes gives the same index.
//
// Bounds on the H100. grammar_mask_argmax reads each row once (R x V x 4
// bytes) and its state's mask words (R x W x 4), and writes the masked rows
// when asked (R x V x 4 more): 4.23 MB at 8 x 128,256, about 1.3 us at
// 3.35 TB/s. grammar_next moves a few hundred bytes a row. At decode shapes
// both are bound by latency, not bytes: by the chain of dependent device
// memory round trips (about 0.5-1 us each) and barriers between launch and
// result.
//
// grammar_mask_argmax: one thread-block cluster a row (grid (C, rows),
// cluster (C, 1, 1)). Each block takes one contiguous slice of its row (the
// wrapper's plan: a multiple of 4 entries when the loads are 16 bytes wide)
// and issues every row load of its slice before using any (one pass of
// kVecPer 16-byte loads a thread at the served vocabularies); the state load
// and the mask-word loads that depend on it run beside the row loads, and a
// bit applies once both arrived. Each block reduces its keys to one and
// stores it into rank 0's shared memory through distributed shared memory
// (behind a split cluster barrier, arrived at the kernel's start and
// waited on after the reduce, so that every block has started); after one
// cluster barrier rank 0 folds the C keys in rank order from its own
// shared memory and writes the index. The chain is: state -> mask word
// (beside the rows), block reduce, one remote store, one cluster barrier.
// The registers are capped for two blocks an SM, so that a GPC holds two
// clusters of 16 and a decode step's 8 rows run in one wave. The design it replaces loaded the row only
// after its mask word, folded a row's chunks through global partials behind
// a fence and an atomic ticket, and re-read them from the last block, with
// a workspace per row count.
//
// grammar_next: one 256-thread block a row, a search of two rounds (three
// where E > 65,536; one where E <= 256). Round 1's probes, every
// 256^(R-1)-th key, are the same for every step, so each thread loads its
// probe once at launch beside the state and the row's tokens. A step counts
// the probes below the key (__syncthreads_count), which narrows the lower
// bound to fewer than 256^(R-1) keys; each later round reads the interval's
// keys 256^(R-2), ..., 1 apart, one a thread, and counts again. Then the
// keys[j] and targets[j] loads of the clipped bound, beside the state's
// default loaded at the step's start. A step at E <= 65,536 is two
// dependent loads (round 2, the target) and two barriers, where the one
// thread a row binary search it replaces was 16-17 dependent key loads and
// the target load.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cgx = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kVecPer = 10;     // 16-byte row loads a thread issues at once
constexpr int kMinBlocks = 2;   // blocks an SM holds: registers for two clusters a GPC
constexpr int kMaxCluster = 16;  // the non-portable cluster size on Hopper
constexpr int kNextThreads = 256;  // probes a search round (ops/cuda_grammar.py SEARCH_FAN)

// A (value, index) pair as one 64-bit key whose unsigned order is the
// argmax order: the high word the value's bits made monotone (-0.0 as
// +0.0; every NaN above +inf), the low word ~index (the lower index the
// larger). Key 0 is below every pair: a slice with no entry.
__device__ __forceinline__ unsigned long long argmax_key(float v, int i) {
  uint32_t hi;
  if (isnan(v)) {
    hi = 0xFFFFFFFFu;
  } else {
    const uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
    hi = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return ((unsigned long long)hi << 32) | (uint32_t)~(uint32_t)i;
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return key == 0ull ? 0 : (int)~(uint32_t)key;  // an empty row's index is 0
}

__device__ __forceinline__ unsigned long long kmax(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

// the block's largest key, left in thread 0
__device__ __forceinline__ unsigned long long block_max(unsigned long long key) {
  __shared__ unsigned long long sk[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) key = kmax(key, __shfl_down_sync(0xffffffffu, key, off));
  if ((threadIdx.x & 31) == 0) sk[threadIdx.x / 32] = key;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) key = kmax(key, sk[w]);
  }
  return key;
}

__device__ __forceinline__ long long clamp_state(long long g, int n_states) {
  return g < 0 ? 0 : (g >= n_states ? n_states - 1 : g);
}

// kVec: 16-byte row loads and stores (vocab and slice multiples of 4, the
// row pointers 16-byte aligned); else one entry a load
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mask_argmax_kernel(const float* __restrict__ rows, const long long* __restrict__ states,
                   const uint32_t* __restrict__ masks, long long* __restrict__ out,
                   float* __restrict__ masked, int masked_every, int vocab, int words,
                   int n_states, int slice) {
  cgx::cluster_group cluster = cgx::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.y;
  __shared__ unsigned long long s_keys[kMaxCluster];  // rank 0's: key r from rank r
  // the first half of a split cluster barrier: it completes once every
  // block of the cluster has started, so that a store into rank 0's shared
  // memory finds it; the wait is after the loads and the block reduce
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const long long g_raw = __ldg(states + row);  // first: the mask chain's head
  const float* x = rows + (size_t)row * (size_t)vocab;
  float* mo = (masked != nullptr && row % masked_every == 0)
                  ? masked + (size_t)(row / masked_every) * (size_t)vocab
                  : nullptr;
  const int lo = rank * slice;
  const int hi = min(lo + slice, vocab);
  unsigned long long best = 0ull;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* mo4 = reinterpret_cast<float4*>(mo);
    const int hi4 = hi >> 2;
    for (int base = (lo >> 2) + threadIdx.x; base < hi4; base += kVecPer * kThreads) {
      float4 v[kVecPer];
#pragma unroll
      for (int e = 0; e < kVecPer; ++e) {  // every row load of the pass, then the bits
        const int q = base + e * kThreads;
        if (q < hi4) v[e] = __ldg(x4 + q);
      }
      const uint32_t* m = masks + (size_t)clamp_state(g_raw, n_states) * (size_t)words;
      uint32_t w[kVecPer];
#pragma unroll
      for (int e = 0; e < kVecPer; ++e) {
        const int q = base + e * kThreads;
        if (q < hi4) w[e] = __ldg(m + (q >> 3));  // entries 4q..4q+3 share a word
      }
#pragma unroll
      for (int e = 0; e < kVecPer; ++e) {
        const int q = base + e * kThreads;
        if (q >= hi4) continue;
        const uint32_t b = w[e] >> ((q & 7) * 4);
        float4 a;
        a.x = (b & 1u) ? v[e].x : -INFINITY;
        a.y = (b & 2u) ? v[e].y : -INFINITY;
        a.z = (b & 4u) ? v[e].z : -INFINITY;
        a.w = (b & 8u) ? v[e].w : -INFINITY;
        if (mo4 != nullptr) mo4[q] = a;
        const int i = 4 * q;
        best = kmax(best, kmax(kmax(argmax_key(a.x, i), argmax_key(a.y, i + 1)),
                               kmax(argmax_key(a.z, i + 2), argmax_key(a.w, i + 3))));
      }
    }
  } else {
    const uint32_t* m = masks + (size_t)clamp_state(g_raw, n_states) * (size_t)words;
#pragma unroll 4
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
      const float xi = __ldg(x + i);
      const uint32_t w = __ldg(m + (i >> 5));
      const float a = ((w >> (i & 31)) & 1u) ? xi : -INFINITY;
      if (mo != nullptr) mo[i] = a;
      best = kmax(best, argmax_key(a, i));
    }
  }
  best = block_max(best);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every block started
  if (threadIdx.x == 0) *cluster.map_shared_rank(&s_keys[rank], 0) = best;
  cluster.sync();  // every block's key is in rank 0's shared memory
  if (rank == 0 && threadIdx.x == 0) {
    const int n = (int)cluster.num_blocks();
    unsigned long long k = s_keys[0];
    for (int r = 1; r < n; ++r) k = kmax(k, s_keys[r]);  // in rank order
    out[row] = key_index(k);
  }
}

__global__ void __launch_bounds__(kNextThreads)
grammar_next_kernel(const long long* __restrict__ states, const long long* __restrict__ tokens,
                    int tok_stride, int steps, const int* __restrict__ keys,
                    const int* __restrict__ targets, const int* __restrict__ defaults,
                    int n_edges, int n_states, int vocab, int rounds,
                    long long* __restrict__ walk, int walk_stride,
                    long long* __restrict__ final_state) {
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  __shared__ long long s_tok[kNextThreads];
  long long stride = 1;  // round 1's probe spacing, kNextThreads^(rounds - 1)
  for (int k = 1; k < rounds; ++k) stride *= kNextThreads;
  const long long p1 = (long long)t * stride;
  const bool probe1 = p1 < n_edges;
  const long long key1 = probe1 ? (long long)__ldg(keys + p1) : 0;
  long long s = clamp_state(__ldg(states + r), n_states);
  for (int t0 = 0; t0 < steps; t0 += kNextThreads) {
    __syncthreads();  // the last chunk's tokens are read
    if (t0 + t < steps) s_tok[t] = __ldg(tokens + (size_t)r * tok_stride + t0 + t);
    __syncthreads();
    const int n = min(steps - t0, kNextThreads);
    for (int u = 0; u < n; ++u) {
      if (walk != nullptr && t == 0) walk[(size_t)r * walk_stride + t0 + u] = s;
      const int dflt = __ldg(defaults + s);
      const long long key = s * (long long)vocab + s_tok[u];
      // searchsorted, side left: the count of keys below the key, narrowed
      // round by round to [lo, hi]
      int c = __syncthreads_count(probe1 && key1 < key);
      long long lo = c == 0 ? 0 : (long long)(c - 1) * stride + 1;
      long long hi = c == 0 ? 0 : min((long long)c * stride, (long long)n_edges);
      for (long long st = stride / kNextThreads; st >= 1; st /= kNextThreads) {
        const long long p = lo + (long long)t * st;
        c = __syncthreads_count(p < hi && (long long)__ldg(keys + p) < key);
        if (c == 0) {
          hi = lo;
        } else {
          hi = min(lo + (long long)c * st, hi);
          lo += (long long)(c - 1) * st + 1;
        }
      }
      const long long j = lo < n_edges ? lo : n_edges - 1;
      const int kj = __ldg(keys + j);
      const int tj = __ldg(targets + j);
      s = (long long)kj == key ? (long long)tj : (long long)dflt;
    }
  }
  if (t == 0) {
    if (walk != nullptr) walk[(size_t)r * walk_stride + steps] = s;
    if (final_state != nullptr) final_state[r] = s;
  }
}

cudaLaunchConfig_t mask_config(int cluster, int n_rows, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, n_rows, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kVec>
int max_clusters(int cluster) {
  if (cluster > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        mask_argmax_kernel<kVec>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return -(int)err;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = mask_config(cluster, 1, nullptr, attr);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, (const void*)mask_argmax_kernel<kVec>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

// The most clusters of `cluster` blocks of grammar_mask_argmax (vec: its
// 16-byte instantiation, else the scalar one) the current device holds at
// once, after allowing a non-portable size (above 8) for the kernel; 0 when
// none can be scheduled, minus a CUDA error code on an error. Call once a
// device before the first launch at that size.
extern "C" int grammar_mask_argmax_clusters(int cluster, int vec) {
  if (cluster < 1 || cluster > kMaxCluster) return -(int)cudaErrorInvalidValue;
  return vec ? max_clusters<true>(cluster) : max_clusters<false>(cluster);
}

// rows: [n_rows, vocab] f32; states: [n_rows] int64 (clamped to [0, n_states));
// masks: [n_states, words] 32-bit words, words = ceil(vocab / 32); out:
// [n_rows] int64. masked: null, or [ceil(n_rows / masked_every), vocab] f32
// taking row r's masked values at row r / masked_every where r % masked_every
// is 0. cluster: the blocks a row, 1 to 16 (above 8 after
// grammar_mask_argmax_clusters); slice: each block's entries, slice *
// cluster >= vocab. vec: 16-byte loads and stores, which need vocab and
// slice multiples of 4 and rows and masked 16-byte aligned.
extern "C" int grammar_mask_argmax_launch(const float* rows, const long long* states,
                                          const uint32_t* masks, long long* out,
                                          float* masked, int masked_every, int n_rows,
                                          int vocab, int words, int n_states, int cluster,
                                          int slice, int vec, void* stream) {
  if (n_rows < 1 || n_rows > 65535 || vocab < 1 || n_states < 1 ||
      words != (vocab + 31) / 32 || masked_every < 1 || cluster < 1 ||
      cluster > kMaxCluster || slice < 1 || (long long)slice * cluster < vocab)
    return (int)cudaErrorInvalidValue;
  if (vec && (vocab % 4 != 0 || slice % 4 != 0 || (reinterpret_cast<uintptr_t>(rows) & 15) ||
              (reinterpret_cast<uintptr_t>(masked) & 15)))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec) {
    const cudaLaunchConfig_t cfg = mask_config(cluster, n_rows, s, attr);
    err = cudaLaunchKernelEx(&cfg, mask_argmax_kernel<true>, rows, states, masks, out, masked,
                             masked_every, vocab, words, n_states, slice);
  } else {
    const cudaLaunchConfig_t cfg = mask_config(cluster, n_rows, s, attr);
    err = cudaLaunchKernelEx(&cfg, mask_argmax_kernel<false>, rows, states, masks, out, masked,
                             masked_every, vocab, words, n_states, slice);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// states: [n_rows] int64 (clamped to [0, n_states)); tokens: [n_rows, steps]
// int64, row r at tokens + r * tok_stride; keys, targets: [n_edges] int32, the
// keys sorted; defaults: [n_states] int32. rounds: the search's probe
// rounds, 256^rounds >= n_edges. walk: null, or [n_rows, steps + 1] int64
// (row stride walk_stride) taking the state after the first t tokens at
// column t; final_state: null, or [n_rows] int64 taking the state after all
// of them.
extern "C" int grammar_next_launch(const long long* states, const long long* tokens,
                                   int tok_stride, int steps, const int* keys,
                                   const int* targets, const int* defaults, int n_edges,
                                   int n_states, int vocab, int rounds, long long* walk,
                                   int walk_stride, long long* final_state, int n_rows,
                                   void* stream) {
  if (n_rows < 1 || steps < 0 || n_edges < 1 || n_states < 1 || vocab < 1 || rounds < 1 ||
      rounds > 4 || (rounds < 4 && (1LL << (8 * rounds)) < n_edges) ||
      (walk != nullptr && walk_stride < steps + 1) || (steps > 0 && tok_stride < steps))
    return (int)cudaErrorInvalidValue;
  grammar_next_kernel<<<n_rows, kNextThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      states, tokens, tok_stride, steps, keys, targets, defaults, n_edges, n_states, vocab,
      rounds, walk, walk_stride, final_state);
  return (int)cudaGetLastError();
}
