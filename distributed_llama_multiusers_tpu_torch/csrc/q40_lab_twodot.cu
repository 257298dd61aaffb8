// Q40 lab two-dot product: the lab's Q40 matmul variants, with the operand
// roundings as flags.
//
// Replaces the lab's product kernels (pl.pallas_call):
//   scripts/kernel_lab.py:101   q40_matmul_v1 (_v1_kernel), row-major planes
//   scripts/kernel_lab.py:210   q40_matmul_v2 (_v2_kernel), pre-tiled planes
//   scripts/stage_probe.py:309  the closure over _k_full (no -8 correction)
//   scripts/stage_probe2.py:165 full_call on the slab layout (no correction)
//
// Arithmetic:
//   y = x_lo . W_lo + x_hi . W_hi  [- 8 * sum_b bsum_b * s_b  if correction]
// with x f32 [m, d_in] split into its block-local halves inside the kernel,
// rounded to bf16 when x_round is set, and W = nibble * s with
//   w_round 0: nibble * s in f32 (exact)
//   w_round 1: nibble * s in f32, then rounded to bf16 (v1's bf16 w_dtype,
//              _k_full's bf16)
//   w_round 2: s rounded to bf16, nibble * s rounded to bf16 (v2's bf16
//              chain)
// s is the f16 block scale in f32 and bsum the exact f32 per-block sums of
// the unrounded x. All products accumulate in f32; the output is f32.
// Layouts: packed [J][d_in/2][T] with scales [J][d_in/32][T], column o in
// tile o / T (T = d_out, J = 1 is the row-major [d_in/2, d_out] plane).
//
// What bounds it on an H100: at the lab's shapes (m <= 8) the packed
// weight's bytes, 0.5625 B per weight at 3.35 TB/s. It is the serving slab
// kernel's design (q40_slab.cu): one thread per 4 adjacent columns of one
// tile, the dequantized weights in registers reused across an m-tile of
// activations staged in shared memory, split-K across thread blocks with a
// second pass over f32 partials. CUDA cores only; no tensor cores, no TMA.
#include "q40_common.cuh"

namespace {

template <int MT>
__global__ void __launch_bounds__(kThreads)
twodot_kernel(const float* __restrict__ x, const float* __restrict__ bsum,
              const uint8_t* __restrict__ packed, const __half* __restrict__ scales,
              float* __restrict__ part, float* __restrict__ out, int m, int d_in, int d_out,
              int tile, int splits, int blocks_per_split, int w_round, int x_round,
              int correction) {
  const int n_blk = d_in / 32;
  const int half = d_in / 2;
  const int col0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int row0 = blockIdx.y * MT;
  const int b_begin = blockIdx.z * blocks_per_split;
  const int b_end = min(n_blk, b_begin + blocks_per_split);
  const bool active = col0 < d_out;
  const int jt = active ? col0 / tile : 0;
  const int t = col0 - jt * tile;
  const uint8_t* pbase = packed + (size_t)jt * half * tile + t;
  const __half* sbase = scales + (size_t)jt * n_blk * tile + t;

  __shared__ float xs[MT][kChunkBlocks * 32];
  __shared__ float bs[MT][kChunkBlocks];

  float acc[MT][kCols];
  float corr[MT][kCols];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      acc[i][c] = 0.f;
      corr[i][c] = 0.f;
    }
  }

  for (int cb = b_begin; cb < b_end; cb += kChunkBlocks) {
    const int nb = min(kChunkBlocks, b_end - cb);
    for (int idx = threadIdx.x; idx < MT * kChunkBlocks * 32; idx += kThreads) {
      const int i = idx / (kChunkBlocks * 32);
      const int k = idx % (kChunkBlocks * 32);
      float v = 0.f;
      if (row0 + i < m && k < nb * 32) v = x[(size_t)(row0 + i) * d_in + (size_t)cb * 32 + k];
      xs[i][k] = x_round ? bf16_round(v) : v;
    }
    for (int idx = threadIdx.x; idx < MT * kChunkBlocks; idx += kThreads) {
      const int i = idx / kChunkBlocks;
      const int bb = idx % kChunkBlocks;
      bs[i][bb] = (correction && row0 + i < m && bb < nb)
                     ? bsum[(size_t)(row0 + i) * n_blk + cb + bb]
                     : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int bb = 0; bb < nb; ++bb) {
        const int b = cb + bb;
        float s[kCols];
        float sw[kCols];
        load_scales(sbase, (size_t)b * tile, s);
#pragma unroll
        for (int c = 0; c < kCols; ++c) sw[c] = w_round == 2 ? bf16_round(s[c]) : s[c];
        if (correction) {
#pragma unroll
          for (int i = 0; i < MT; ++i) {
#pragma unroll
            for (int c = 0; c < kCols; ++c) corr[i][c] = fmaf(bs[i][bb], s[c], corr[i][c]);
          }
        }
        const uint8_t* prow = pbase + (size_t)(16 * b) * tile;
#pragma unroll 4
        for (int j = 0; j < 16; ++j) {
          const uint32_t p = load_packed(prow + (size_t)j * tile);
          float wl[kCols];
          float wh[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            float lo = __fmul_rn((float)((p >> (8 * c)) & 0xFu), sw[c]);
            float hi = __fmul_rn((float)((p >> (8 * c + 4)) & 0xFu), sw[c]);
            if (w_round) {
              lo = bf16_round(lo);
              hi = bf16_round(hi);
            }
            wl[c] = lo;
            wh[c] = hi;
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const float xl = xs[i][32 * bb + j];
            const float xh = xs[i][32 * bb + 16 + j];
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              acc[i][c] = fmaf(xl, wl[c], fmaf(xh, wh[c], acc[i][c]));
            }
          }
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
      float v[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[c] = acc[i][c] - 8.f * corr[i][c];
      store_cols(part, out, 0, splits, plane, (size_t)(row0 + i) * d_out + col0, v);
    }
  }
}

}  // namespace

// Launches the two-dot product (and the split-K reduction when splits > 1)
// on `stream`; returns cudaGetLastError() as an int, 0 on success.
extern "C" int q40_lab_twodot_launch(const float* x, const float* bsum, const void* packed,
                                     const void* scales, float* out, float* part, int m,
                                     int d_in, int d_out, int tile, int mt, int splits,
                                     int blocks_per_split, int w_round, int x_round,
                                     int correction, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(m, d_out, mt, splits);
  const uint8_t* p = reinterpret_cast<const uint8_t*>(packed);
  const __half* sc = reinterpret_cast<const __half*>(scales);
  switch (mt) {
    case 1:
      twodot_kernel<1><<<grid, kThreads, 0, s>>>(x, bsum, p, sc, part, out, m, d_in, d_out, tile,
                                                 splits, blocks_per_split, w_round, x_round,
                                                 correction);
      break;
    case 8:
      twodot_kernel<8><<<grid, kThreads, 0, s>>>(x, bsum, p, sc, part, out, m, d_in, d_out, tile,
                                                 splits, blocks_per_split, w_round, x_round,
                                                 correction);
      break;
    case 16:
      twodot_kernel<16><<<grid, kThreads, 0, s>>>(x, bsum, p, sc, part, out, m, d_in, d_out,
                                                  tile, splits, blocks_per_split, w_round,
                                                  x_round, correction);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return finish(part, out, 0, splits, (size_t)m * d_out, s);
}
