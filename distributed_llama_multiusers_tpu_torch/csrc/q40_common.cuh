// Shared pieces of the three Q40 dequant-in-matmul kernels (q40_slab.cu,
// q40_blockdot.cu, q40_i8blockdot.cu): thread-block geometry, operand
// loads, the epilogue store and the split-K reduction.
//
// Weight layout (quants/packed.py): packed uint8 [d_in/2, d_out], row
// 16b+j holds input 32b+j in its low nibble and input 32b+16+j in its high
// nibble; scales f16 [d_in/32, d_out]. Both planes are row-major with d_out
// contiguous, so one thread reading kCols adjacent columns of a packed row
// issues one 32-bit load, and a warp reads 128 contiguous bytes per row.
//
// Work split: blockIdx.x = a tile of kThreads*kCols output columns,
// blockIdx.y = a tile of MT activation rows, blockIdx.z = a range of quant
// blocks of d_in (split-K). With one split the kernel writes the output in
// its dtype; with several it writes f32 partials [splits, m, d_out] that
// reduce_splits sums in a second launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 4;          // output columns per thread
constexpr int kThreads = 128;     // threads per block: 512 columns per block
constexpr int kChunkBlocks = 4;   // quant blocks of activations staged at a time

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_act(const void* x, int x_bf16, size_t idx) {
  if (x_bf16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[idx]);
  }
  return reinterpret_cast<const float*>(x)[idx];
}

// kCols f16 scales of one scale row, exactly converted to f32 (denormals
// included: __half2float is exact for every finite f16).
__device__ __forceinline__ void load_scales(const __half* scales, size_t off,
                                            float s[kCols]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(scales + off);
  const __half2 a = *reinterpret_cast<const __half2*>(&raw.x);
  const __half2 b = *reinterpret_cast<const __half2*>(&raw.y);
  const float2 fa = __half22float2(a);
  const float2 fb = __half22float2(b);
  s[0] = fa.x;
  s[1] = fa.y;
  s[2] = fb.x;
  s[3] = fb.y;
}

__device__ __forceinline__ uint32_t load_packed(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One row's kCols results: straight into the output (single split) or into
// this split's f32 partial plane.
__device__ __forceinline__ void store_cols(float* part, void* out, int out_bf16,
                                           int splits, size_t plane, size_t off,
                                           const float v[kCols]) {
  if (splits == 1) {
    if (out_bf16) {
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out) + off;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[c] = __float2bfloat16_rn(v[c]);
    } else {
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + off) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    *reinterpret_cast<float4*>(part + plane + off) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__global__ void reduce_splits(const float* __restrict__ part, void* __restrict__ out,
                              int out_bf16, int splits, size_t n) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[(size_t)s * n + i];
  if (out_bf16) {
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(acc);
  } else {
    reinterpret_cast<float*>(out)[i] = acc;
  }
}

inline dim3 grid_for(int m, int d_out, int mt, int splits) {
  return dim3((d_out + kThreads * kCols - 1) / (kThreads * kCols), (m + mt - 1) / mt, splits);
}

// Checks the main launch, then sums the partials when d_in was split.
inline int finish(const float* part, void* out, int out_bf16, int splits, size_t n,
                  cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    reduce_splits<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, out, out_bf16,
                                                                   splits, n);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace
