// Shared pieces of the three Q40 dequant-in-matmul kernels (q40_slab.cu,
// q40_blockdot.cu, q40_i8blockdot.cu): thread-block geometry, operand
// loads, the cp.async copies and the stage ring built on them, the
// epilogue stores (the tensor-core kernels' fragment store among them) and
// the split-K reduction.
//
// Weight layout (quants/packed.py): packed uint8 [d_in/2, d_out], row
// 16b+j holds input 32b+j in its low nibble and input 32b+16+j in its high
// nibble; scales f16 [d_in/32, d_out]. Both planes are row-major with d_out
// contiguous, so one thread reading kCols adjacent columns of a packed row
// issues one 32-bit load, and a warp reads 128 contiguous bytes per row.
//
// Widths: any d_out. A thread's kCols columns are read and written as one
// vector when d_out % kCols == 0 and the planes are aligned; otherwise the
// kernels take their kTail instantiation (chosen by the launcher from d_out
// and the pointers), which reads bytes and halves and writes only the
// columns below d_out.
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

// The first n (<= kCols) columns of the right edge: with kTail byte loads,
// the missing columns zero; without, the one 32-bit load.
template <bool kTail>
__device__ __forceinline__ uint32_t load_packed_cols(const uint8_t* p, int n) {
  if constexpr (!kTail) {
    return load_packed(p);
  } else {
    uint32_t v = 0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < n) v |= (uint32_t)p[c] << (8 * c);
    }
    return v;
  }
}

template <bool kTail>
__device__ __forceinline__ void load_scales_cols(const __half* scales, size_t off, int n,
                                                 float s[kCols]) {
  if constexpr (!kTail) {
    load_scales(scales, off, s);
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[c] = c < n ? __half2float(scales[off + c]) : 0.f;
  }
}

// 16-byte global -> shared copies that bypass L1 (asm volatile: the
// compiler cannot drop them), grouped by commit and awaited by group count.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Returns once at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The cp.async stage ring all three kernels stream their weights through:
// one stage is one quant block of a thread block's kTileCols-column tile,
// its 16 packed rows plus its f16 scale row. A row is padded by 16 bytes,
// so that 16-byte reads of the same column chunk in rows 2 apart fall in
// different banks (the blockdot fragments read rows 2t, 2t+1, 2t+8, 2t+9;
// i8blockdot's rows 4t..4t+3 in an order that keeps them apart, see
// q40_i8blockdot.cu); 4-byte reads along one row stay conflict-free.
constexpr int kStages = 3;                    // ring depth: kStages - 1 blocks in flight
constexpr int kTileCols = kThreads * kCols;   // 512 output columns per thread block
constexpr int kRowPitch = kTileCols + 16;     // bytes per staged packed row

struct __align__(16) SlabStage {
  uint8_t packed[16][kRowPitch];   // the quant block's 16 packed rows
  uint16_t scales[kTileCols];      // and its f16 scale row, as raw bits
};

// Starts staging quant block b of the column tile at x0 into `st`.
template <bool kAsync>
__device__ __forceinline__ void stage_block(SlabStage& st, const uint8_t* __restrict__ packed,
                                            const __half* __restrict__ scales, int b, int x0,
                                            int d_out) {
  if constexpr (kAsync) {
    // d_out % 16 == 0: every row segment is whole 16-byte chunks; chunks
    // past d_out are not copied, and what a kernel computes from them is
    // never stored
    constexpr int kRowChunks = kTileCols / 16;
    const int chunks = min(kTileCols, d_out - x0) / 16;
    const uint8_t* src = packed + (size_t)(16 * b) * d_out + x0;
#pragma unroll
    for (int r = 0; r < 16 * kRowChunks / kThreads; ++r) {
      const int idx = r * kThreads + threadIdx.x;
      const int row = idx / kRowChunks;
      const int ch = idx % kRowChunks;
      if (ch < chunks) cp_async16(&st.packed[row][ch * 16], src + (size_t)row * d_out + ch * 16);
    }
    if ((int)threadIdx.x < 2 * chunks) {  // 8 scales per 16-byte chunk
      cp_async16(&st.scales[8 * threadIdx.x],
                 scales + (size_t)b * d_out + x0 + 8 * threadIdx.x);
    }
  } else {
    // each thread stages its own kCols columns; columns past d_out are zero
    const int col0 = x0 + threadIdx.x * kCols;
    const int n = max(0, min(kCols, d_out - col0));
    const uint8_t* src = packed + (size_t)(16 * b) * d_out + col0;
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<uint32_t*>(&st.packed[j][threadIdx.x * kCols]) =
          load_packed_cols<true>(src + (size_t)j * d_out, n);
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      st.scales[threadIdx.x * kCols + c] =
          c < n ? __half_as_ushort(scales[(size_t)b * d_out + col0 + c]) : 0;
    }
  }
}

// True when the planes can be staged by cp.async: 16-byte rows and planes.
inline bool rows_async(int d_out, const void* packed, const void* scales) {
  return d_out % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(scales) % 16 == 0;
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

// store_cols for the first n (<= kCols) columns; with kTail element by
// element, since a row of d_out % kCols != 0 columns breaks vector alignment.
template <bool kTail>
__device__ __forceinline__ void store_cols_n(float* part, void* out, int out_bf16, int splits,
                                             size_t plane, size_t off, const float v[kCols],
                                             int n) {
  if constexpr (!kTail) {
    store_cols(part, out, out_bf16, splits, plane, off, v);
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c >= n) continue;
      if (splits > 1) {
        part[plane + off + c] = v[c];
      } else if (out_bf16) {
        reinterpret_cast<__nv_bfloat16*>(out)[off + c] = __float2bfloat16_rn(v[c]);
      } else {
        reinterpret_cast<float*>(out)[off + c] = v[c];
      }
    }
  }
}

// The tensor-core kernels' fragment geometry (q40_blockdot.cu,
// q40_i8blockdot.cu): thread (g = lane / 4, t = lane % 4) of warp w owns
// the 16 columns w * kWarpCols + g * 16 .. +15 of the thread block's tile,
// as 8 M-tiles of 16 fragment rows; M-tile i maps fragment rows g and g + 8
// to columns 2i and 2i + 1 of those 16. Its f32 results acc[i][nt][e] are
// the m16n8 accumulator fragment of M-tile i and N-tile nt (8 activation
// rows): e = 0, 1 column 2i, rows 2t, 2t + 1; e = 2, 3 column 2i + 1.
constexpr int kWarpCols = kTileCols / (kThreads / 32);  // 128 columns per warp

// Stores the fragments' results, rows past m and columns past d_out
// dropped. One row (MT = 1), held by the lanes with t = 0 (fragment column
// 0): each stores its 16 columns straight away. At m-tiles of 8 and 16 rows
// the results go out through shared memory, one N-tile of 8 rows x 512
// columns at a time over the drained stage ring, so that each warp writes
// whole 512-byte row segments (written straight from the fragments, a
// warp's stores scatter 16-byte pieces over 4 rows). The float4 column
// index is XORed with row / 2 = t, so that the fragment writes of rows 2t
// and 2t + 1 by the 4 threads t fall in different banks. Every thread of
// the block calls it (it holds barriers when MT > 1).
template <int MT, bool kTail>
__device__ __forceinline__ void store_fragments(const float (&acc)[8][(MT + 7) / 8][4],
                                                SlabStage* ring, float* part, void* out,
                                                int out_bf16, int splits, int m, int d_out,
                                                int x0, int row0, int cw, bool warp_active) {
  constexpr int NT = (MT + 7) / 8;
  const int t = (threadIdx.x % 32) % 4;
  const size_t plane = (size_t)blockIdx.z * m * d_out;
  if constexpr (MT == 1) {
    if (!warp_active || t != 0) return;
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // columns cw + 4q .. 4q+3
      const int col = x0 + cw + 4 * q;
      if (col >= d_out) continue;
      // column 4q + c is M-tile 2q + c / 2, fragment half c % 2
      const float v[kCols] = {acc[2 * q][0][0], acc[2 * q][0][2], acc[2 * q + 1][0][0],
                              acc[2 * q + 1][0][2]};
      store_cols_n<kTail>(part, out, out_bf16, splits, plane, (size_t)row0 * d_out + col, v,
                          min(kCols, d_out - col));
    }
  } else {
    float4* tile = reinterpret_cast<float4*>(ring);
    constexpr int kC4 = kTileCols / 4;
    static_assert(8 * kC4 * sizeof(float4) <= kStages * sizeof(SlabStage),
                  "an N-tile fits the ring");
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      __syncthreads();  // the ring (or the previous N-tile) is no longer read
      if (warp_active) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 2 * t + e;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            tile[r * kC4 + ((cw / 4 + q) ^ t)] =
                make_float4(acc[2 * q][nt][e], acc[2 * q][nt][2 + e], acc[2 * q + 1][nt][e],
                            acc[2 * q + 1][nt][2 + e]);
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int it = 0; it < 8 * kC4 / kThreads; ++it) {
        const int idx = it * kThreads + threadIdx.x;
        const int r = idx / kC4;
        const int c4 = idx % kC4;
        const int i_row = 8 * nt + r;
        const int col = x0 + 4 * c4;
        if (i_row >= MT || row0 + i_row >= m || col >= d_out) continue;
        const float4 f = tile[r * kC4 + (c4 ^ (r >> 1))];
        const float v[kCols] = {f.x, f.y, f.z, f.w};
        store_cols_n<kTail>(part, out, out_bf16, splits, plane,
                            (size_t)(row0 + i_row) * d_out + col, v, min(kCols, d_out - col));
      }
    }
  }
}

// A tensor-core kernel's geometry at m-tile MT (its cp.async and its
// plain-load instantiation): out[0] ring stages, out[1] static shared
// memory bytes per thread block, out[2] registers per thread, out[3] local
// (spill) bytes per thread, the larger of the two instantiations'.
template <typename K>
inline int kernel_info(K async_kernel, K plain_kernel, int* out) {
  cudaFuncAttributes attr;
  cudaFuncAttributes other;
  cudaError_t err = cudaFuncGetAttributes(&attr, async_kernel);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&other, plain_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = kStages;
  out[1] = (int)(attr.sharedSizeBytes > other.sharedSizeBytes ? attr.sharedSizeBytes
                                                               : other.sharedSizeBytes);
  out[2] = attr.numRegs > other.numRegs ? attr.numRegs : other.numRegs;
  out[3] = (int)(attr.localSizeBytes > other.localSizeBytes ? attr.localSizeBytes
                                                            : other.localSizeBytes);
  return 0;
}

// True when a thread's kCols columns can be read as one vector: packed rows
// 4-byte and scale rows 8-byte aligned.
inline bool cols_aligned(int d_out, const void* packed, const void* scales) {
  return d_out % kCols == 0 && reinterpret_cast<uintptr_t>(packed) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(scales) % 8 == 0;
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
