// Decode attention on Hopper: one query per lane (a decode step), grouped
// query heads, over the lane's own cache slots 0 .. min(pos, s_len - 1).
//
// Replaces: no Pallas kernel. The JAX package computes this in XLA inside its
// compiled decode step (distributed_llama_multiusers_tpu/models/llama.py,
// the masked softmax attention over the whole cache). The port needs a kernel
// for two reasons. Written as PyTorch ops, attention over the whole cache
// casts and permutes every slot of every lane on every layer (about 5 ms of
// an 8 ms decode step of the 1B shape at seq_len 2048). Bounding the slots by
// a shared attention length instead makes a lane's bits depend on the other
// lanes' positions, since the library's reductions change with the length.
// Here a lane's result depends only on its own query, position and slots:
// the slots it reads and the order it sums them in are fixed by its position.
//
// Design: one thread block per (lane, kv head), kWarps warps. Warp w takes
// the slots of its chunks w, w + kWarps, ..., kU slots each; each of its 32
// threads holds DPL dims of the head (dim d = thread + 32 j). Per chunk the
// warp issues the kU slots' K and V loads together, forms the G query
// heads' dots (a butterfly shuffle sum, so every thread holds the total) and
// folds the chunk into a running max, sum and weighted V with one rescale
// (online softmax, expf never __expf). The warps' partial states are then
// summed in warp order through shared memory. Bound: one read of the slots
// the lanes attend (K and V) plus q and the output; the dots and the softmax
// are a few f32 operations per element.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kU = 8;  // slots per warp and chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// G: query heads per kv head (the runtime group g_n <= G); DPL: dims per
// thread (the runtime head size hd <= 32 * DPL)
template <int G, int DPL, typename KV>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                   const KV* __restrict__ v, const long long* __restrict__ pos,
                   float* __restrict__ out, long long lane_stride, int n_kv, int g_n, int hd,
                   int s_len, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int t = threadIdx.x % 32;
  const long long p = pos[b];
  const int n = (int)(p < (long long)s_len - 1 ? p : (long long)s_len - 1) + 1;

  // q * scale, rounded once as the plain version rounds it
  const float* qb = q + ((size_t)b * n_kv + kvh) * (size_t)g_n * hd;
  float qr[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = t + 32 * j;
      qr[g][j] = (g < g_n && d < hd) ? qb[g * hd + d] * scale : 0.0f;
    }

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.0f;
  }

  const size_t slot_stride = (size_t)n_kv * hd;
  const KV* kb = k + (size_t)b * lane_stride + (size_t)kvh * hd;
  const KV* vb = v + (size_t)b * lane_stride + (size_t)kvh * hd;
  for (int c0 = warp * kU; c0 < n; c0 += kWarps * kU) {
    float kx[kU][DPL], vx[kU][DPL];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int s = c0 + u;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = t + 32 * j;
        const bool in = s < n && d < hd;
        kx[u][j] = in ? to_f32(kb[s * slot_stride + d]) : 0.0f;
        vx[u][j] = in ? to_f32(vb[s * slot_stride + d]) : 0.0f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float dot[kU];
      float cmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float x = 0.0f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) x = fmaf(qr[g][j], kx[u][j], x);
        x = warp_sum(x);
        dot[u] = c0 + u < n ? x : -INFINITY;  // slots past the lane's own
        cmax = fmaxf(cmax, dot[u]);
      }
      const float mn = fmaxf(m[g], cmax);  // finite: slot c0 < n
      const float c = expf(m[g] - mn);  // 0 on the first chunk (m = -inf)
      float lsum = 0.0f;
      float vsum[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) vsum[j] = 0.0f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float pr = expf(dot[u] - mn);  // 0 past the lane's slots
        lsum += pr;
#pragma unroll
        for (int j = 0; j < DPL; ++j) vsum[j] = fmaf(pr, vx[u][j], vsum[j]);
      }
      l[g] = l[g] * c + lsum;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[g][j] = acc[g][j] * c + vsum[j];
      m[g] = mn;
    }
  }

  // the warps' states, summed in warp order (a warp with no slot keeps
  // m = -inf, l = 0 and adds exact zeros)
  __shared__ float sm[kWarps][G];
  __shared__ float sl[kWarps][G];
  __shared__ float sacc[G][32 * DPL];
  if (t == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm[warp][g] = m[g];
      sl[warp][g] = l[g];
    }
  }
  __syncthreads();
  float mx[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    mx[g] = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx[g] = fmaxf(mx[g], sm[w][g]);
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float c = expf(m[g] - mx[g]);
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int i = t + 32 * j;
          sacc[g][i] = w == 0 ? acc[g][j] * c : sacc[g][i] + acc[g][j] * c;
        }
      }
    }
    __syncthreads();
  }
  float* ob = out + ((size_t)b * n_kv + kvh) * (size_t)g_n * hd;
  for (int i = threadIdx.x; i < g_n * hd; i += kThreads) {
    const int g = i / hd;
    const int d = i % hd;
    float mg = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mg = fmaxf(mg, sm[w][g]);
    float den = 0.0f;
    for (int w = 0; w < kWarps; ++w) den += sl[w][g] * expf(sm[w][g] - mg);
    ob[g * hd + d] = sacc[g][d] / den;
  }
}

template <int G, int DPL, typename KV>
cudaError_t launch(const float* q, const void* k, const void* v, const long long* pos,
                   float* out, long long lane_stride, int lanes, int n_kv, int g_n, int hd,
                   int s_len, float scale, cudaStream_t stream) {
  decode_attn_kernel<G, DPL, KV><<<dim3(n_kv, lanes), kThreads, 0, stream>>>(
      q, static_cast<const KV*>(k), static_cast<const KV*>(v), pos, out, lane_stride, n_kv,
      g_n, hd, s_len, scale);
  return cudaGetLastError();
}

template <int G, typename KV>
cudaError_t by_dims(const float* q, const void* k, const void* v, const long long* pos,
                    float* out, long long lane_stride, int lanes, int n_kv, int g_n, int hd,
                    int s_len, float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch<G, 1, KV>(q, k, v, pos, out, lane_stride, lanes, n_kv, g_n, hd, s_len,
                            scale, stream);
  if (hd <= 64)
    return launch<G, 2, KV>(q, k, v, pos, out, lane_stride, lanes, n_kv, g_n, hd, s_len,
                            scale, stream);
  return launch<G, 4, KV>(q, k, v, pos, out, lane_stride, lanes, n_kv, g_n, hd, s_len, scale,
                          stream);
}

template <typename KV>
cudaError_t by_group(const float* q, const void* k, const void* v, const long long* pos,
                     float* out, long long lane_stride, int lanes, int n_kv, int g_n, int hd,
                     int s_len, float scale, cudaStream_t stream) {
  if (g_n <= 1)
    return by_dims<1, KV>(q, k, v, pos, out, lane_stride, lanes, n_kv, g_n, hd, s_len, scale,
                          stream);
  if (g_n <= 2)
    return by_dims<2, KV>(q, k, v, pos, out, lane_stride, lanes, n_kv, g_n, hd, s_len, scale,
                          stream);
  if (g_n <= 4)
    return by_dims<4, KV>(q, k, v, pos, out, lane_stride, lanes, n_kv, g_n, hd, s_len, scale,
                          stream);
  return by_dims<8, KV>(q, k, v, pos, out, lane_stride, lanes, n_kv, g_n, hd, s_len, scale,
                        stream);
}

}  // namespace

// q: f32 [lanes, n_kv, g_n, hd]; k, v: one layer's cache, slot s of lane b at
// b * lane_stride + s * n_kv * hd (elements; kv_bf16: bf16, else f32); pos:
// int64 [lanes]; out: f32 [lanes, n_kv, g_n, hd]
extern "C" int decode_attn_launch(const float* q, const void* k, const void* v,
                                  const long long* pos, float* out, long long lane_stride,
                                  int lanes, int n_kv, int g_n, int hd, int s_len, int kv_bf16,
                                  float scale, void* stream) {
  if (lanes < 1 || n_kv < 1 || g_n < 1 || g_n > 8 || hd < 1 || hd > 128 || s_len < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return (int)by_group<__nv_bfloat16>(q, k, v, pos, out, lane_stride, lanes, n_kv, g_n, hd,
                                        s_len, scale, st);
  return (int)by_group<float>(q, k, v, pos, out, lane_stride, lanes, n_kv, g_n, hd, s_len,
                              scale, st);
}
