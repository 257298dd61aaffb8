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
// (dim x E f32; every block after the first finds it in L2), the outputs
// written once: at a Mixtral decode step (8 rows, dim 4096, E 8) 64 KB of
// rows and 128 KB of gate, about 0.06 us at 3.35 TB/s, so a launch's
// latency sets the time. The operations (2 x N x dim x E) are fewer still.
//
// Design: one thread block a row. Each thread sums its own dims (d = t,
// t + kThreads, ...) for up to kEChunk experts at a time in registers, then
// the block folds the threads' partials in shared memory in a fixed tree
// order, so a row's logits are the same bits whatever rows surround it. One
// warp then takes the top k: k rounds, each a warp argmax over the experts
// not yet taken (value descending, the lower index first on a tie, as
// lax.top_k orders them), then the softmax over the k values with their
// largest subtracted (as jax.nn.softmax), summed in slot order, and the
// row's dense weights (zero for the experts not taken).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kEChunk = 8;  // experts a thread accumulates at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// (v, i) ranks before (bv, bi): the larger value, the lower index on a tie;
// bi < 0 is "nothing yet"
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return bi < 0 || v > bv || (v == bv && i < bi);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_route_kernel(const T* __restrict__ y, const float* __restrict__ gate,
                 float* __restrict__ topw, int* __restrict__ topi, float* __restrict__ rw,
                 int dim, int n_exp, int k) {
  // dynamic: the row's logits [n_exp], the chosen experts [k], their weights [k]
  extern __shared__ float smem[];
  float* logits = smem;
  int* chosen = reinterpret_cast<int*>(smem + n_exp);
  float* wsel = smem + n_exp + k;
  __shared__ float part[kThreads][kEChunk + 1];  // +1: no bank conflicts on the fold

  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const T* yr = y + (size_t)row * dim;
  for (int e0 = 0; e0 < n_exp; e0 += kEChunk) {
    const int ne = min(kEChunk, n_exp - e0);
    float acc[kEChunk];
#pragma unroll
    for (int j = 0; j < kEChunk; ++j) acc[j] = 0.0f;
    for (int d = t; d < dim; d += kThreads) {
      const float yv = to_f32(yr[d]);
      const float* g = gate + (size_t)d * n_exp + e0;
#pragma unroll
      for (int j = 0; j < kEChunk; ++j) {
        if (j < ne) acc[j] = fmaf(yv, g[j], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kEChunk; ++j) part[t][j] = acc[j];
    __syncthreads();
    // fixed-order tree fold: thread t adds thread t + s's partial
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (t < s) {
#pragma unroll
        for (int j = 0; j < kEChunk; ++j) part[t][j] += part[t + s][j];
      }
      __syncthreads();
    }
    if (t < ne) logits[e0 + t] = part[0][t];
    __syncthreads();
  }
  if (t >= 32) return;  // the selection runs on warp 0

  for (int j = 0; j < k; ++j) {
    float bv = 0.0f;
    int bi = -1;
    for (int e = t; e < n_exp; e += 32) {
      bool taken = false;
      for (int p = 0; p < j; ++p) taken |= chosen[p] == e;
      if (!taken && better(logits[e], e, bv, bi)) {
        bv = logits[e];
        bi = e;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (oi >= 0 && better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    // lane 0's choice is the warp's
    bi = __shfl_sync(0xffffffffu, bi, 0);
    if (t == 0) chosen[j] = bi;
    __syncwarp();
  }
  if (t == 0) {
    float m = logits[chosen[0]];
    for (int j = 1; j < k; ++j) m = fmaxf(m, logits[chosen[j]]);
    float sum = 0.0f;
    for (int j = 0; j < k; ++j) {
      wsel[j] = expf(logits[chosen[j]] - m);
      sum += wsel[j];
    }
    for (int j = 0; j < k; ++j) {
      wsel[j] = wsel[j] / sum;
      topw[(size_t)row * k + j] = wsel[j];
      topi[(size_t)row * k + j] = chosen[j];
    }
  }
  __syncwarp();
  for (int e = t; e < n_exp; e += 32) {
    float w = 0.0f;
    for (int j = 0; j < k; ++j) {
      if (chosen[j] == e) w = wsel[j];
    }
    rw[(size_t)row * n_exp + e] = w;
  }
}

}  // namespace

extern "C" int moe_route_launch(const void* y, int y_bf16, const float* gate, float* topw,
                                int* topi, float* rw, int n, int dim, int n_exp, int k,
                                cudaStream_t stream) {
  if (n <= 0) return 0;
  const size_t smem = (size_t)(n_exp + 2 * k) * sizeof(float);
  if (y_bf16) {
    moe_route_kernel<__nv_bfloat16><<<n, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(y), gate, topw, topi, rw, dim, n_exp, k);
  } else {
    moe_route_kernel<float><<<n, kThreads, smem, stream>>>(
        static_cast<const float*>(y), gate, topw, topi, rw, dim, n_exp, k);
  }
  return (int)cudaGetLastError();
}
