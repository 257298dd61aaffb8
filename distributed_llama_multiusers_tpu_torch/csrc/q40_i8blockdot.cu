// Q40 i8blockdot kernel: y = x @ dequant(W) with Q80-quantized activations
// and integer block dots on the raw nibbles.
//
// Replaces: distributed_llama_multiusers_tpu/ops/pallas_q40.py,
// _q40_i8blockdot_kernel (mode i8blockdot), reached through the
// pl.pallas_call in _q40_matmul_core; its operands are make_q80_acts'.
//
// Arithmetic (the Pallas kernel's): per quant block b
//   d   = xq_lo_b . nib_lo_b + xq_hi_b . nib_hi_b        (exact int32)
//   y  += (sx_b * d - 8 * bsum_b) * s_b                  (f32)
// xq is x quantized per 32-block to int8 (sx = max(max|x|, 1e-8)/127,
// round half to even, clipped to +-127), the nibbles stay unsigned 0..15,
// bsum is the exact f32 per-block sum of x and s the f32 scale. Callers use
// it for m <= 32 rows (BLOCKDOT_MAX_M).
//
// What bounds it on an H100: the packed weight's bytes (0.5625 B per weight
// at 3.35 TB/s). The inner loop does no float work per weight: a thread
// loads four packed rows of its four columns (four 32-bit loads), turns the
// 4x4 bytes into one word per column with byte permutes, masks out the low
// and high nibbles, and feeds __dp4a (four int8 multiply-adds per
// instruction) against four activation bytes from shared memory. The float
// scale work is one FMA per (row, column, block). Tensor cores are not used
// yet.
#include "q40_common.cuh"

namespace {

template <int MT, bool kTail>
__global__ void __launch_bounds__(kThreads)
i8blockdot_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                  const float* __restrict__ bsum, const uint8_t* __restrict__ packed,
                  const __half* __restrict__ scales, float* __restrict__ part,
                  void* __restrict__ out, int out_bf16, int m, int d_in, int d_out,
                  int splits, int blocks_per_split) {
  const int n_blk = d_in / 32;
  const int col0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int row0 = blockIdx.y * MT;
  const int b_begin = blockIdx.z * blocks_per_split;
  const int b_end = min(n_blk, b_begin + blocks_per_split);
  const bool active = col0 < d_out;
  const int n = min(kCols, d_out - col0);  // columns of this thread below d_out

  // 32 int8 activations per block = 8 words: words 0..3 are the low half
  // (inputs 32b..32b+15), words 4..7 the high half
  __shared__ int xw[MT][kChunkBlocks * 8];
  __shared__ float bs[MT][kChunkBlocks];
  __shared__ float ss[MT][kChunkBlocks];

  float acc[MT][kCols];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int cb = b_begin; cb < b_end; cb += kChunkBlocks) {
    const int nb = min(kChunkBlocks, b_end - cb);
    for (int idx = threadIdx.x; idx < MT * kChunkBlocks * 8; idx += kThreads) {
      const int i = idx / (kChunkBlocks * 8);
      const int k = idx % (kChunkBlocks * 8);
      int v = 0;
      if (row0 + i < m && k < nb * 8) {
        v = *reinterpret_cast<const int*>(xq + (size_t)(row0 + i) * d_in + (size_t)cb * 32 +
                                          4 * k);
      }
      xw[i][k] = v;
    }
    for (int idx = threadIdx.x; idx < MT * kChunkBlocks; idx += kThreads) {
      const int i = idx / kChunkBlocks;
      const int bb = idx % kChunkBlocks;
      const bool ok = row0 + i < m && bb < nb;
      const size_t at = (size_t)(row0 + i) * n_blk + cb + bb;
      bs[i][bb] = ok ? bsum[at] : 0.f;
      ss[i][bb] = ok ? sx[at] : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int bb = 0; bb < nb; ++bb) {
        const int b = cb + bb;
        int d[MT][kCols];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) d[i][c] = 0;
        }
        const uint8_t* prow = packed + (size_t)(16 * b) * d_out + col0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // rows 4q..4q+3 of the block, kCols columns each
          const uint8_t* pq = prow + (size_t)(4 * q) * d_out;
          const uint32_t w0 = load_packed_cols<kTail>(pq, n);
          const uint32_t w1 = load_packed_cols<kTail>(pq + (size_t)d_out, n);
          const uint32_t w2 = load_packed_cols<kTail>(pq + (size_t)2 * d_out, n);
          const uint32_t w3 = load_packed_cols<kTail>(pq + (size_t)3 * d_out, n);
          // 4x4 byte transpose: col[c] holds rows 4q..4q+3 of column c
          const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
          const uint32_t t1 = __byte_perm(w2, w3, 0x5140);
          const uint32_t t2 = __byte_perm(w0, w1, 0x7362);
          const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
          uint32_t col[kCols];
          col[0] = __byte_perm(t0, t1, 0x5410);
          col[1] = __byte_perm(t0, t1, 0x7632);
          col[2] = __byte_perm(t2, t3, 0x5410);
          col[3] = __byte_perm(t2, t3, 0x7632);
          int lo[kCols];
          int hi[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            lo[c] = (int)(col[c] & 0x0F0F0F0Fu);
            hi[c] = (int)((col[c] >> 4) & 0x0F0F0F0Fu);
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const int xl = xw[i][8 * bb + q];
            const int xh = xw[i][8 * bb + 4 + q];
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              d[i][c] = __dp4a(xh, hi[c], __dp4a(xl, lo[c], d[i][c]));
            }
          }
        }
        float s[kCols];
        load_scales_cols<kTail>(scales, (size_t)b * d_out + col0, n, s);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float sxi = ss[i][bb];
          const float corr = 8.f * bs[i][bb];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc[i][c] = fmaf(sxi * (float)d[i][c] - corr, s[c], acc[i][c]);
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
      store_cols_n<kTail>(part, out, out_bf16, splits, plane,
                          (size_t)(row0 + i) * d_out + col0, acc[i], n);
    }
  }
}

template <int MT>
void launch(bool tail, dim3 grid, cudaStream_t s, const int8_t* x, const float* sx,
            const float* bsum, const uint8_t* p, const __half* sc, float* part, void* out,
            int out_bf16, int m, int d_in, int d_out, int splits, int blocks_per_split) {
  if (tail) {
    i8blockdot_kernel<MT, true><<<grid, kThreads, 0, s>>>(x, sx, bsum, p, sc, part, out,
                                                          out_bf16, m, d_in, d_out, splits,
                                                          blocks_per_split);
  } else {
    i8blockdot_kernel<MT, false><<<grid, kThreads, 0, s>>>(x, sx, bsum, p, sc, part, out,
                                                           out_bf16, m, d_in, d_out, splits,
                                                           blocks_per_split);
  }
}

}  // namespace

// Launches the i8blockdot kernel (and the split-K reduction when splits > 1)
// on `stream`; returns cudaGetLastError() as an int, 0 on success. Widths
// with d_out % 4 != 0 (or unaligned planes) take the kTail instantiation.
extern "C" int q40_i8blockdot_launch(const void* xq, const float* sx, const float* bsum,
                                     const void* packed, const void* scales, void* out,
                                     int out_bf16, float* part, int m, int d_in, int d_out,
                                     int mt, int splits, int blocks_per_split, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(m, d_out, mt, splits);
  const int8_t* x = reinterpret_cast<const int8_t*>(xq);
  const uint8_t* p = reinterpret_cast<const uint8_t*>(packed);
  const __half* sc = reinterpret_cast<const __half*>(scales);
  const bool tail = !cols_aligned(d_out, packed, scales);
  switch (mt) {
    case 1:
      launch<1>(tail, grid, s, x, sx, bsum, p, sc, part, out, out_bf16, m, d_in, d_out, splits,
                blocks_per_split);
      break;
    case 8:
      launch<8>(tail, grid, s, x, sx, bsum, p, sc, part, out, out_bf16, m, d_in, d_out, splits,
                blocks_per_split);
      break;
    case 16:
      launch<16>(tail, grid, s, x, sx, bsum, p, sc, part, out, out_bf16, m, d_in, d_out, splits,
                 blocks_per_split);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return finish(part, out, out_bf16, splits, (size_t)m * d_out, s);
}
