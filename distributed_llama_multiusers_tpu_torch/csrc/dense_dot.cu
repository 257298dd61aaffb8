// Dense dot: y = x @ w for a few rows of x against a dense weight plane.
//
// Replaces: scripts/stage_probe.py:279, the pl.pallas_call closure over
// _k_dot_only (the lab's MXU stream reference): x [M, d_in] @ w [d_in, d_out]
// with x and w both bf16 or both f32, accumulated in f32, f32 out.
//
// What bounds it on an H100: at M <= 32 the weight's bytes (2 or 4 per
// weight at 3.35 TB/s); 2*M*d_in*d_out operations are far under the CUDA
// cores' 67 TFLOP/s at these M. It is the lab's yardstick for "what a
// plain dense stream costs" beside the Q40 kernels, so it has their design:
// one thread per 4 adjacent output columns (a warp reads 256 (bf16) or 512
// (f32) contiguous bytes of a weight row), x staged in shared memory in f32
// for an m-tile of rows, split-K over 32-row chunks of d_in across thread
// blocks with a second pass over f32 partials. CUDA cores only.
#include "q40_common.cuh"

namespace {

__device__ __forceinline__ void load_row4(const void* w, int w_bf16, size_t off, float v[kCols]) {
  if (w_bf16) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        reinterpret_cast<const __nv_bfloat16*>(w) + off);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  } else {
    const float4 f = *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(w) + off);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
dense_kernel(const void* __restrict__ x, int x_bf16, const void* __restrict__ w, int w_bf16,
             float* __restrict__ part, float* __restrict__ out, int m, int d_in, int d_out,
             int splits, int blocks_per_split) {
  const int n_blk = d_in / 32;
  const int col0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int row0 = blockIdx.y * MT;
  const int b_begin = blockIdx.z * blocks_per_split;
  const int b_end = min(n_blk, b_begin + blocks_per_split);
  const bool active = col0 < d_out;

  __shared__ float xs[MT][kChunkBlocks * 32];
  float acc[MT][kCols];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int cb = b_begin; cb < b_end; cb += kChunkBlocks) {
    const int nb = min(kChunkBlocks, b_end - cb);
    for (int idx = threadIdx.x; idx < MT * kChunkBlocks * 32; idx += kThreads) {
      const int i = idx / (kChunkBlocks * 32);
      const int k = idx % (kChunkBlocks * 32);
      xs[i][k] = (row0 + i < m && k < nb * 32)
                     ? load_act(x, x_bf16, (size_t)(row0 + i) * d_in + (size_t)cb * 32 + k)
                     : 0.f;
    }
    __syncthreads();
    if (active) {
      const size_t base = (size_t)cb * 32 * d_out + col0;
#pragma unroll 4
      for (int k = 0; k < nb * 32; ++k) {
        float wv[kCols];
        load_row4(w, w_bf16, base + (size_t)k * d_out, wv);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float xv = xs[i][k];
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(xv, wv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
  const size_t plane = (size_t)blockIdx.z * m * d_out;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (row0 + i < m) store_cols(part, out, 0, splits, plane, (size_t)(row0 + i) * d_out + col0,
                                 acc[i]);
  }
}

}  // namespace

// Launches the dense product (and the split-K reduction when splits > 1) on
// `stream`; returns cudaGetLastError() as an int, 0 on success.
extern "C" int dense_dot_launch(const void* x, int x_bf16, const void* w, int w_bf16, float* out,
                                float* part, int m, int d_in, int d_out, int mt, int splits,
                                int blocks_per_split, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(m, d_out, mt, splits);
  switch (mt) {
    case 1:
      dense_kernel<1><<<grid, kThreads, 0, s>>>(x, x_bf16, w, w_bf16, part, out, m, d_in, d_out,
                                                splits, blocks_per_split);
      break;
    case 8:
      dense_kernel<8><<<grid, kThreads, 0, s>>>(x, x_bf16, w, w_bf16, part, out, m, d_in, d_out,
                                                splits, blocks_per_split);
      break;
    case 16:
      dense_kernel<16><<<grid, kThreads, 0, s>>>(x, x_bf16, w, w_bf16, part, out, m, d_in, d_out,
                                                 splits, blocks_per_split);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return finish(part, out, 0, splits, (size_t)m * d_out, s);
}
