// The mixture-of-experts router on Hopper: per token row, the logits
// y . gate over the E experts in f32, their top k in lax.top_k's order, the
// softmax over those k, and the row's dense routing weights.
//
// Replaces: no Pallas kernel. The JAX package computes the router in XLA
// inside its compiled step (distributed_llama_multiusers_tpu/models/llama.py,
// `_moe_topk` and `_moe_router_weights`, :171-188): an f32 einsum, then
// `lax.top_k`, `jax.nn.softmax` over the k values, and a one-hot einsum
// that scatters the k weights over the expert axis. Written as PyTorch ops
// it is a matmul, a sort, a softmax and a scatter: four to six launches a
// layer in every decode step.
//
// Bound: bytes. One read of the rows (N x dim, bf16 or f32) and of the gate
// (dim x E f32), the outputs written once: at a Mixtral decode step (8 rows,
// dim 4096, E 8) 64 KB of rows and 128 KB of gate, about 0.06 us at
// 3.35 TB/s; at a 1,024-row prompt chunk 8 MB, 2.6 us. The operations
// (2 x N x dim x E) are fewer. At decode shapes the time is latency: the
// launch, the chain of dependent memory round trips and barriers.
//
// One fold order, set by the dim alone (ops/cuda_moe.py `route_plan`
// computes the same slices). The dim is cut into kSlices slices of
// slice_len elements, a multiple of kVec; slice s is [s * slice_len,
// min((s + 1) * slice_len, dim)). In a slice, lane p (of 32) takes the
// kVec-element vectors p, p + 32, ... and sums y[d] * gate[d][e] over
// them with fmaf in increasing d, from 0; the 32 lanes' sums meet in an
// xor tree (offsets 16, 8, 4, 2, 1, each lane adding its partner's value
// to its own: `quad_reduce` computes that tree for four experts at once,
// transposed, bit for bit); the logit is 0 plus the kSlices slice sums
// in slice order. Both plans below compute exactly this, so a row's
// logits, and with them its experts and weights, are the same bits
// whatever rows surround it and whichever plan runs it.
//
// A warp sums one quad of experts over a slice (`slice_quad`), a round
// of kRound gate rows at a time: the lanes' row loads go out first, then
// the warp stages the quad's gate rows in shared memory (each load
// instruction 32 consecutive rows; a lane's own rows lie E x 32 bytes
// from its neighbour's, 32 L1 wavefronts a load if read directly), and
// each lane reads its rows back, padded so no two lanes of a quarter warp
// share a bank. One vector a lane, one round, at dim 4096.
//
// Few rows, E <= kClusterMaxExperts: one thread-block cluster of kSlices
// blocks a row (grid (kSlices, N)); block s takes slice s, each of its
// warps a quad of experts. Each warp pushes its quad's slice sums into
// rank 0's shared memory through distributed shared memory, behind a
// split cluster barrier arrived at on entry; after one cluster barrier
// rank 0 folds them in slice order and its warp 0 routes the row. At 8
// rows that is 128 blocks on 128 SMs, each moving 8.5 KB, where the
// kernel this replaced ran 8 blocks that each walked the whole dim and
// gate in 32 dependent rounds. The card holds 42 such clusters at once
// (the H100): past that the plan takes a second wave.
//
// Many rows, or E above that: one 512-thread block a tile of up to
// kTileRows rows (grid ceil(N / tile_rows)); warp s takes slice s for
// every row of the tile, so each gate element is loaded once a tile and
// applied to all its rows (the kernel this replaced read the whole gate
// once a row: 128 MB of L2 traffic at 1,024 rows). The slice sums go to
// shared memory, a chunk of kExpertChunk experts at a time; the block
// folds them in slice order, then warp r routes row r of the tile.
//
// Routing (`route_row`, one warp a row): k rounds, each the largest
// (value, index) key below the last round's, a key's unsigned order
// being lax.top_k's (the larger value, the lower index on a tie; -0.0
// ties +0.0), so no set of taken experts is kept; then exp(l - max) in
// slot order, their sum, the division, and the dense row.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cgx = cooperative_groups;

namespace {

constexpr int kSlices = 16;           // the dim's slices: a cluster's blocks, a tile block's warps
constexpr int kVec = 8;               // a lane's elements a vector (16 bytes of bf16)
constexpr int kClusterThreads = 128;  // a cluster block: 4 warps, a quad of experts each
constexpr int kTileThreads = kSlices * 32;  // a tile block: a warp a slice
constexpr int kTileRowsBf16 = 8;      // the most rows a tile block holds, bf16 rows
constexpr int kTileRowsF32 = 4;       // and f32 rows (twice the registers a row)
constexpr int kClusterMaxExperts = 256;  // rank 0 holds kSlices + 1 floats an expert
constexpr int kExpertChunk = 64;      // experts a tile block folds at once
constexpr int kMaxExperts = 4096;
constexpr int kTileMaxSmem = 200 * 1024;  // a tile block's dynamic shared memory (opted in)
constexpr int kRound = 32 * kVec;     // gate rows a tile warp stages at once: a vector a lane
// a staged quad: kRound rows of 4 floats, 4 floats of pad after every kVec
// rows, so that lane p's rows 8p .. 8p + 7 lie 144 bytes from lane p + 1's
// (no bank conflict on the 16-byte reads)
constexpr int kStage = (kRound + kRound / kVec) * 4;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct TileRows;
template <>
struct TileRows<__nv_bfloat16> { static constexpr int value = kTileRowsBf16; };
template <>
struct TileRows<float> { static constexpr int value = kTileRowsF32; };

// a lane's kVec elements of a row, as loaded: 16 bytes of bf16, 32 of f32
struct Raw {
  uint4 a, b;
};

__device__ __forceinline__ void load_raw(const __nv_bfloat16* p, int d0, int hi, bool vec,
                                         Raw& r) {
  if (vec) {
    r.a = __ldg(reinterpret_cast<const uint4*>(p + d0));
    return;
  }
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) w[j] = d0 + j < hi ? __ldg(h + d0 + j) : 0u;
  r.a = make_uint4(w[0] | (w[1] << 16), w[2] | (w[3] << 16), w[4] | (w[5] << 16),
                   w[6] | (w[7] << 16));
}

__device__ __forceinline__ void load_raw(const float* p, int d0, int hi, bool vec, Raw& r) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p + d0));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + d0 + 4));
    r.a = make_uint4(__float_as_uint(a.x), __float_as_uint(a.y), __float_as_uint(a.z),
                     __float_as_uint(a.w));
    r.b = make_uint4(__float_as_uint(b.x), __float_as_uint(b.y), __float_as_uint(b.z),
                     __float_as_uint(b.w));
    return;
  }
  uint32_t w[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) w[j] = d0 + j < hi ? __float_as_uint(__ldg(p + d0 + j)) : 0u;
  r.a = make_uint4(w[0], w[1], w[2], w[3]);
  r.b = make_uint4(w[4], w[5], w[6], w[7]);
}

__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// element j of a loaded vector as f32 (a bf16's widening is exact)
template <typename T>
__device__ __forceinline__ float elem(const Raw& r, int j);
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const Raw& r, int j) {
  const uint32_t w = word(r.a, j >> 1);
  return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
}
template <>
__device__ __forceinline__ float elem<float>(const Raw& r, int j) {
  return __uint_as_float(j < 4 ? word(r.a, j) : word(r.b, j - 4));
}

// The xor tree over the warp's 32 lanes of each of a[0..3] (offsets 16,
// 8, 4, 2, 1; a lane adds its partner's value to its own), transposed: at
// offset 16 a lane keeps two of the four values and receives its
// partner's of those two, at 8 one; the rest is the plain tree on one
// value. Every addition is the plain tree's (IEEE addition commutes), so
// the sums are its bits. Returns expert (lane >> 3) & 3's sum.
__device__ __forceinline__ float quad_reduce(const float (&a)[4], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8;
  const float k0 = (b4 ? a[2] : a[0]) + __shfl_xor_sync(kFull, b4 ? a[0] : a[2], 16);
  const float k1 = (b4 ? a[3] : a[1]) + __shfl_xor_sync(kFull, b4 ? a[1] : a[3], 16);
  float v = (b3 ? k1 : k0) + __shfl_xor_sync(kFull, b3 ? k0 : k1, 8);
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 2);
  v += __shfl_xor_sync(kFull, v, 1);
  return v;
}

// A lane's vector (elements d0 .. d0 + kVec - 1 below hi) for experts
// q4 .. q4 + 3 and the first `rows` of kRows rows, already loaded (`raw`):
// acc[r][c] = fmaf(y[d], gate[d][q4 + c], acc[r][c]) in increasing d, the
// gate rows from the warp's staged quad (`stage`, rows base .. base +
// kRound - 1), lane p's rows 8p .. 8p + 7.
template <typename T, int kRows>
__device__ __forceinline__ void fma_staged(const Raw (&raw)[kRows], int rows, const float* stage,
                                           int lane, int d0, int hi, float (&acc)[kRows][4]) {
  const bool full = d0 + kVec <= hi;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (!full && d0 + j >= hi) continue;
    const float4 g = *reinterpret_cast<const float4*>(stage + (9 * lane + j) * 4);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= rows) continue;
      const float v = elem<T>(raw[r], j);
      acc[r][0] = fmaf(v, g.x, acc[r][0]);
      acc[r][1] = fmaf(v, g.y, acc[r][1]);
      acc[r][2] = fmaf(v, g.z, acc[r][2]);
      acc[r][3] = fmaf(v, g.w, acc[r][3]);
    }
  }
}

// A warp stages gate rows base .. base + kRound - 1 (those below hi; zeros
// past it) of experts q4 .. q4 + 3 (zeros past n_exp): lane p loads rows
// p, p + 32, ..., so each load instruction reads 32 consecutive rows (a
// lane's own rows, 8p .. 8p + 7, lie E x 32 bytes from its neighbour's:
// loaded directly, every instruction would touch 32 lines).
__device__ __forceinline__ void stage_quad(float* stage, const float* __restrict__ gate,
                                           int n_exp, int q4, int base, int hi, int lane,
                                           bool vec_g) {
  float4 g[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int d = base + lane + 32 * i;
    const float* gr = gate + (size_t)d * n_exp + q4;
    if (d >= hi) {
      g[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else if (vec_g) {
      g[i] = __ldg(reinterpret_cast<const float4*>(gr));
    } else {
      g[i].x = __ldg(gr);
      g[i].y = q4 + 1 < n_exp ? __ldg(gr + 1) : 0.0f;
      g[i].z = q4 + 2 < n_exp ? __ldg(gr + 2) : 0.0f;
      g[i].w = q4 + 3 < n_exp ? __ldg(gr + 3) : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int rr = lane + 32 * i;
    *reinterpret_cast<float4*>(stage + (rr + (rr >> 3)) * 4) = g[i];
  }
}

// A warp's sums of one quad over slice [lo, hi) for the first `rows` of
// kRows rows (row r at y + off[r]): lane p's vectors p, p + 32, ... a round
// at a time, each round's row loads issued before its gate quad's staging.
template <typename T, int kRows>
__device__ __forceinline__ void slice_quad(const T* __restrict__ y, const size_t (&off)[kRows],
                                           int rows, const float* __restrict__ gate, int n_exp,
                                           int q4, int lo, int hi, int lane, bool vec_y,
                                           bool vec_g, float* stage, float (&acc)[kRows][4]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
  for (int base = lo; base < hi; base += kRound) {
    const int d0 = base + lane * kVec;
    Raw raw[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows && d0 < hi) load_raw(y + off[r], d0, hi, vec_y && d0 + kVec <= hi, raw[r]);
    }
    stage_quad(stage, gate, n_exp, q4, base, hi, lane, vec_g);
    __syncwarp();
    if (d0 < hi) fma_staged<T, kRows>(raw, rows, stage, lane, d0, hi, acc);
    __syncwarp();  // every lane's reads before the next round's stores
  }
}

// A (value, index) pair as one 64-bit key whose unsigned order is
// lax.top_k's: the high word the value's bits made monotone (-0.0 as
// +0.0; a NaN above +inf), the low word ~index (the lower index the
// larger). Every key is above 0.
__device__ __forceinline__ unsigned long long route_key(float v, int i) {
  uint32_t hi;
  if (isnan(v)) {
    hi = 0xFFFFFFFFu;
  } else {
    const uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
    hi = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return ((unsigned long long)hi << 32) | (uint32_t)~(uint32_t)i;
}

// One warp routes a row from its logits (shared memory): the top k in
// lax.top_k's order, the softmax over their values with the largest
// subtracted (as jax.nn.softmax), summed in slot order, and the dense row
// (zero for the experts not taken). Slot j's expert and exp stay in lane
// j's registers when k <= 32; above that lane 0 parks them in topi/topw
// and the lanes read them back (the same values either way).
__device__ void route_row(const float* logits, int n_exp, int k, int lane,
                          float* __restrict__ topw, int* __restrict__ topi,
                          float* __restrict__ rw) {
  unsigned long long prev = 0ull;
  float m = 0.0f, sum = 0.0f, my_w = 0.0f;
  int my_i = 0;
  for (int j = 0; j < k; ++j) {
    unsigned long long best = 0ull;
    for (int e = lane; e < n_exp; e += 32) {
      const unsigned long long key = route_key(logits[e], e);
      if ((j == 0 || key < prev) && key > best) best = key;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, best, off);
      best = o > best ? o : best;
    }
    prev = best;
    const int i = (int)~(uint32_t)best;
    const float v = logits[i];
    if (j == 0) m = v;
    const float w = expf(v - m);
    sum += w;  // every lane, in slot order
    if (lane == j) {
      my_i = i;
      my_w = w;
    } else if (k > 32 && lane == 0) {
      topi[j] = i;
      topw[j] = w;
    }
  }
  for (int e = lane; e < n_exp; e += 32) rw[e] = 0.0f;
  __syncwarp();  // every lane's zeros, and lane 0's parked slots, before the weights
  for (int j = lane; j < k; j += 32) {
    const int i = j < 32 ? my_i : topi[j];
    const float w = (j < 32 ? my_w : topw[j]) / sum;
    topi[j] = i;
    topw[j] = w;
    rw[i] = w;
  }
}

template <typename T>
__global__ void __launch_bounds__(kClusterThreads)
moe_route_kernel_cluster(const T* __restrict__ y, const float* __restrict__ gate,
                         float* __restrict__ topw, int* __restrict__ topi,
                         float* __restrict__ rw, int dim, int n_exp, int k, int slice_len,
                         int vec_y, int vec_g) {
  cgx::cluster_group cluster = cgx::this_cluster();
  const int s = (int)cluster.block_rank();
  const int row = blockIdx.y;
  // stage[4][kStage] (a warp's); rank 0's part[kSlices][n_exp], slice s's
  // sums from rank s, and logits[n_exp]
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4) + (kClusterThreads / 32) * kStage;
  // the first half of a split cluster barrier: it completes once every
  // block of the cluster has started, so a store into rank 0's shared
  // memory finds it; each warp waits after its first quad's sums
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lo = min(s * slice_len, dim), hi = min(lo + slice_len, dim);
  const size_t off[1] = {(size_t)row * dim};
  float* part0 = cluster.map_shared_rank(smem, 0);
  bool waited = false;
  float* stage = reinterpret_cast<float*>(smem4) + warp * kStage;
  for (int q4 = 4 * warp; q4 < n_exp; q4 += 4 * (kClusterThreads / 32)) {
    float acc[1][4];
    slice_quad<T, 1>(y, off, 1, gate, n_exp, q4, lo, hi, lane, vec_y, vec_g, stage, acc);
    const float v = quad_reduce(acc[0], lane);
    if (!waited) {
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every block started
      waited = true;
    }
    const int e = q4 + ((lane >> 3) & 3);
    if ((lane & 7) == 0 && e < n_exp) part0[s * n_exp + e] = v;
  }
  if (!waited) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  cluster.sync();  // every slice's sums are in rank 0's shared memory
  if (s != 0) return;
  float* logits = smem + kSlices * n_exp;
  for (int e = threadIdx.x; e < n_exp; e += kClusterThreads) {
    float a = 0.0f;
#pragma unroll
    for (int r = 0; r < kSlices; ++r) a += smem[r * n_exp + e];  // in slice order
    logits[e] = a;
  }
  __syncthreads();
  if (warp == 0)
    route_row(logits, n_exp, k, lane, topw + (size_t)row * k, topi + (size_t)row * k,
              rw + (size_t)row * n_exp);
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads, 1)
moe_route_kernel_tile(const T* __restrict__ y, const float* __restrict__ gate,
                      float* __restrict__ topw, int* __restrict__ topi, float* __restrict__ rw,
                      int n, int dim, int n_exp, int k, int slice_len, int tile_rows,
                      int vec_y, int vec_g) {
  constexpr int kRows = TileRows<T>::value;
  const int chunk = min(n_exp, kExpertChunk);
  // stage[kSlices][kStage] (a warp's), part[tile_rows][kSlices][chunk],
  // logits[tile_rows][n_exp]
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int s = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* stage = smem + s * kStage;
  float* part = smem + kSlices * kStage;
  float* logits = part + tile_rows * kSlices * chunk;
  const int row0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, n - row0);
  size_t off[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) off[r] = (size_t)(row0 + min(r, rows - 1)) * dim;
  const int lo = min(s * slice_len, dim), hi = min(lo + slice_len, dim);
  for (int c0 = 0; c0 < n_exp; c0 += chunk) {
    const int ce = min(chunk, n_exp - c0);
    for (int q4 = c0; q4 < c0 + ce; q4 += 4) {
      float acc[kRows][4];
      slice_quad<T, kRows>(y, off, rows, gate, n_exp, q4, lo, hi, lane, vec_y, vec_g, stage,
                           acc);
      const int e = q4 + ((lane >> 3) & 3);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= rows) continue;
        const float v = quad_reduce(acc[r], lane);
        if ((lane & 7) == 0 && e < c0 + ce) part[(r * kSlices + s) * chunk + (e - c0)] = v;
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < rows * ce; t += kTileThreads) {
      const int r = t / ce, e = t - r * ce;
      float a = 0.0f;
#pragma unroll
      for (int j = 0; j < kSlices; ++j) a += part[(r * kSlices + j) * chunk + e];  // slice order
      logits[r * n_exp + c0 + e] = a;
    }
    __syncthreads();  // the chunk's sums are folded before the next overwrites them
  }
  for (int r = s; r < rows; r += kSlices) {
    const size_t row = (size_t)row0 + r;
    route_row(logits + r * n_exp, n_exp, k, lane, topw + row * k, topi + row * k,
              rw + row * n_exp);
  }
}

cudaLaunchConfig_t cluster_config(int n_rows, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSlices, n_rows, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSlices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

size_t cluster_smem(int n_exp) {
  return ((size_t)(kClusterThreads / 32) * kStage + (size_t)(kSlices + 1) * n_exp) *
         sizeof(float);
}

size_t tile_smem(int tile_rows, int n_exp) {
  const int chunk = n_exp < kExpertChunk ? n_exp : kExpertChunk;
  return ((size_t)kSlices * kStage + (size_t)tile_rows * (kSlices * chunk + n_exp)) *
         sizeof(float);
}

template <typename T>
int prepare() {
  cudaError_t set = cudaFuncSetAttribute(
      moe_route_kernel_cluster<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (set != cudaSuccess) return -(int)set;
  set = cudaFuncSetAttribute(moe_route_kernel_tile<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kTileMaxSmem);
  if (set != cudaSuccess) return -(int)set;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(1, cluster_smem(kClusterMaxExperts), nullptr,
                                                attr);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, (const void*)moe_route_kernel_cluster<T>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T>
int launch(const T* y, const float* gate, float* topw, int* topi, float* rw, int n, int dim,
           int n_exp, int k, int slice_len, int tile_rows, int vec_y, int vec_g,
           cudaStream_t stream) {
  if (tile_rows == 0) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(n, cluster_smem(n_exp), stream, attr);
    return (int)cudaLaunchKernelEx(&cfg, moe_route_kernel_cluster<T>, y, gate, topw, topi, rw,
                                   dim, n_exp, k, slice_len, vec_y, vec_g);
  }
  const int blocks = (n + tile_rows - 1) / tile_rows;
  moe_route_kernel_tile<T><<<blocks, kTileThreads, tile_smem(tile_rows, n_exp), stream>>>(
      y, gate, topw, topi, rw, n, dim, n_exp, k, slice_len, tile_rows, vec_y, vec_g);
  return (int)cudaGetLastError();
}

}  // namespace

// Once a device before the first launch: allows the cluster plan's
// non-portable size (above 8) and the tile plan's kTileMaxSmem for both
// dtypes, and returns the most clusters of kSlices blocks of the cluster
// plan the device holds at once (the fewer of its bf16 and f32
// instantiations', at the largest shared memory the plan takes); 0 when
// none can be scheduled, minus a CUDA error code on an error.
extern "C" int moe_route_prepare(void) {
  const int a = prepare<__nv_bfloat16>();
  const int b = prepare<float>();
  return a < b ? a : b;
}

// y: [n, dim] bf16 (y_bf16) or f32; gate: [dim, n_exp] f32; topw: [n, k] f32;
// topi: [n, k] int32; rw: [n, n_exp] f32. slice_len: each slice's elements,
// ceil(dim / (kSlices * kVec)) * kVec (the one the dim sets). tile_rows: 0
// for the cluster plan (n <= 65535, n_exp <= kClusterMaxExperts), else the
// rows of a tile block (1 to kTileRows of the dtype, within kTileMaxSmem);
// either after moe_route_prepare on this device. vec_y: 16-byte row loads
// (y 16-byte aligned, dim x the element size a multiple of 16); vec_g:
// float4 gate loads (gate 16-byte aligned, n_exp a multiple of 4).
extern "C" int moe_route_launch(const void* y, int y_bf16, const float* gate, float* topw,
                                int* topi, float* rw, int n, int dim, int n_exp, int k,
                                int slice_len, int tile_rows, int vec_y, int vec_g,
                                void* stream) {
  const int want_slice = (dim + kSlices * kVec - 1) / (kSlices * kVec) * kVec;
  if (n < 1 || dim < 1 || n_exp < 1 || n_exp > kMaxExperts || k < 1 || k > n_exp ||
      slice_len != want_slice || tile_rows < 0)
    return (int)cudaErrorInvalidValue;
  const size_t elt = y_bf16 ? 2 : 4;
  if (vec_y && ((reinterpret_cast<uintptr_t>(y) & 15) || ((size_t)dim * elt) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (vec_g && ((reinterpret_cast<uintptr_t>(gate) & 15) || n_exp % 4 != 0))
    return (int)cudaErrorInvalidValue;
  if (tile_rows == 0 && (n > 65535 || n_exp > kClusterMaxExperts))
    return (int)cudaErrorInvalidValue;
  if (tile_rows > 0 && (tile_rows > (y_bf16 ? kTileRowsBf16 : kTileRowsF32) ||
                        tile_smem(tile_rows, n_exp) > (size_t)kTileMaxSmem))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (y_bf16)
    return launch(static_cast<const __nv_bfloat16*>(y), gate, topw, topi, rw, n, dim, n_exp, k,
                  slice_len, tile_rows, vec_y, vec_g, s);
  return launch(static_cast<const float*>(y), gate, topw, topi, rw, n, dim, n_exp, k,
                slice_len, tile_rows, vec_y, vec_g, s);
}
