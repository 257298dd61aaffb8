// Q40 blockdot kernel: y = x @ dequant(W) with the scale applied per quant
// block to the block's dot instead of to every weight.
//
// Replaces: distributed_llama_multiusers_tpu/ops/pallas_q40.py,
// _q40_blockdot_kernel (mode blockdot), reached through the pl.pallas_call
// in _q40_matmul_core.
//
// Arithmetic (the Pallas kernel's): per quant block b
//   y += (x_lo_b . nib_lo_b + x_hi_b . nib_hi_b - 8 * bsum_b) * s_b
// with x rounded to bf16, the raw nibbles 0..15 (exact in bf16), f32
// accumulation of the 16-deep block dots, bsum the exact f32 per-block sums
// of the unrounded x, and the f32 scale. Callers use it for m <= 32 rows
// (BLOCKDOT_MAX_M); wider products run the slab kernel's bf16 chain.
//
// What bounds it on an H100: the packed weight's bytes (0.5625 B per weight
// at 3.35 TB/s) at the decode shapes it serves. The per-weight work drops
// to a nibble extract and a convert (no scale multiply, no rounding); the
// scale costs one FMA per (row, column, block). Like the slab kernel it
// keeps each weight in registers across an m-tile of activation rows in
// shared memory and splits d_in across thread blocks for narrow outputs;
// tensor cores are not used yet.
#include "q40_common.cuh"

namespace {

template <int MT, bool kTail>
__global__ void __launch_bounds__(kThreads)
blockdot_kernel(const void* __restrict__ x, int x_bf16, const float* __restrict__ bsum,
                const uint8_t* __restrict__ packed, const __half* __restrict__ scales,
                float* __restrict__ part, void* __restrict__ out, int out_bf16,
                int m, int d_in, int d_out, int splits, int blocks_per_split) {
  const int n_blk = d_in / 32;
  const int col0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int row0 = blockIdx.y * MT;
  const int b_begin = blockIdx.z * blocks_per_split;
  const int b_end = min(n_blk, b_begin + blocks_per_split);
  const bool active = col0 < d_out;
  const int n = min(kCols, d_out - col0);  // columns of this thread below d_out

  __shared__ float xs[MT][kChunkBlocks * 32];
  __shared__ float bs[MT][kChunkBlocks];

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
      float v = 0.f;
      if (row0 + i < m && k < nb * 32) {
        v = load_act(x, x_bf16, (size_t)(row0 + i) * d_in + (size_t)cb * 32 + k);
      }
      xs[i][k] = bf16_round(v);
    }
    for (int idx = threadIdx.x; idx < MT * kChunkBlocks; idx += kThreads) {
      const int i = idx / kChunkBlocks;
      const int bb = idx % kChunkBlocks;
      bs[i][bb] = (row0 + i < m && bb < nb) ? bsum[(size_t)(row0 + i) * n_blk + cb + bb] : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int bb = 0; bb < nb; ++bb) {
        const int b = cb + bb;
        float blk[MT][kCols];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) blk[i][c] = 0.f;
        }
        const uint8_t* prow = packed + (size_t)(16 * b) * d_out + col0;
#pragma unroll 4
        for (int j = 0; j < 16; ++j) {
          const uint32_t p = load_packed_cols<kTail>(prow + (size_t)j * d_out, n);
          float nl[kCols];
          float nh[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            nl[c] = (float)((p >> (8 * c)) & 0xFu);
            nh[c] = (float)((p >> (8 * c + 4)) & 0xFu);
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const float xl = xs[i][32 * bb + j];
            const float xh = xs[i][32 * bb + 16 + j];
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              blk[i][c] = fmaf(xl, nl[c], fmaf(xh, nh[c], blk[i][c]));
            }
          }
        }
        float s[kCols];
        load_scales_cols<kTail>(scales, (size_t)b * d_out + col0, n, s);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float corr = 8.f * bs[i][bb];
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(blk[i][c] - corr, s[c], acc[i][c]);
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
  const size_t plane = (size_t)blockIdx.z * m * d_out;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (row0 + i < m) {
      store_cols_n<kTail>(part, out, out_bf16, splits, plane,
                          (size_t)(row0 + i) * d_out + col0, acc[i], n);
    }
  }
}

template <int MT>
void launch(bool tail, dim3 grid, cudaStream_t s, const void* x, int x_bf16, const float* bsum,
            const uint8_t* p, const __half* sc, float* part, void* out, int out_bf16, int m,
            int d_in, int d_out, int splits, int blocks_per_split) {
  if (tail) {
    blockdot_kernel<MT, true><<<grid, kThreads, 0, s>>>(x, x_bf16, bsum, p, sc, part, out,
                                                        out_bf16, m, d_in, d_out, splits,
                                                        blocks_per_split);
  } else {
    blockdot_kernel<MT, false><<<grid, kThreads, 0, s>>>(x, x_bf16, bsum, p, sc, part, out,
                                                         out_bf16, m, d_in, d_out, splits,
                                                         blocks_per_split);
  }
}

}  // namespace

// Launches the blockdot kernel (and the split-K reduction when splits > 1)
// on `stream`; returns cudaGetLastError() as an int, 0 on success. Widths
// with d_out % 4 != 0 (or unaligned planes) take the kTail instantiation.
extern "C" int q40_blockdot_launch(const void* x, int x_bf16, const float* bsum,
                                   const void* packed, const void* scales, void* out,
                                   int out_bf16, float* part, int m, int d_in, int d_out,
                                   int mt, int splits, int blocks_per_split, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(m, d_out, mt, splits);
  const uint8_t* p = reinterpret_cast<const uint8_t*>(packed);
  const __half* sc = reinterpret_cast<const __half*>(scales);
  const bool tail = !cols_aligned(d_out, packed, scales);
  switch (mt) {
    case 1:
      launch<1>(tail, grid, s, x, x_bf16, bsum, p, sc, part, out, out_bf16, m, d_in, d_out,
                splits, blocks_per_split);
      break;
    case 8:
      launch<8>(tail, grid, s, x, x_bf16, bsum, p, sc, part, out, out_bf16, m, d_in, d_out,
                splits, blocks_per_split);
      break;
    case 16:
      launch<16>(tail, grid, s, x, x_bf16, bsum, p, sc, part, out, out_bf16, m, d_in, d_out,
                 splits, blocks_per_split);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return finish(part, out, out_bf16, splits, (size_t)m * d_out, s);
}
