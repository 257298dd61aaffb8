// Q40 slab kernel: y = x @ dequant(W) for Q40-packed weights, modes v4 and
// the bf16 chains.
//
// Replaces: distributed_llama_multiusers_tpu/ops/pallas_q40.py,
// _q40_slab_kernel (modes v4 / bf16chain / repeat / u8chain), reached
// through the pl.pallas_call in _q40_matmul_core.
//
// Arithmetic (the Pallas kernel's, operand for operand):
//   y = x_lo . W_lo + x_hi . W_hi - 8 * sum_b bsum_b * s_b
// x is rounded to the dot dtype; W = nibble * s with
//   v4:         nibble * s in f32, then rounded to the dot dtype
//   bf16 chain: s rounded to bf16, nibble * s rounded to bf16
// and the -8 nibble offset is folded into one correction against bsum, the
// exact f32 per-block sums of the UNROUNDED x, with the f32 scales. All
// products accumulate in f32 (a bf16 x bf16 product is exact in f32).
//
// What bounds it on an H100: at decode shapes (m <= 32) the packed weight's
// bytes, 0.5625 B per weight at 3.35 TB/s; each weight is read once, by the
// one thread that owns its column. At prefill shapes (m in the hundreds)
// the f32 FMAs on CUDA cores: 2*m*d_in*d_out operations at 67 TFLOP/s,
// well above the weight-read time. This first version does not use the
// tensor cores (wgmma) or TMA; it keeps every dequantized weight in
// registers and reuses it across an m-tile of up to 16 activation rows held
// in shared memory, and splits d_in across thread blocks when d_out alone
// gives too few blocks to fill the card.
#include "q40_common.cuh"

namespace {

template <int MT>
__global__ void __launch_bounds__(kThreads)
slab_kernel(const void* __restrict__ x, int x_bf16, const float* __restrict__ bsum,
            const uint8_t* __restrict__ packed, const __half* __restrict__ scales,
            float* __restrict__ part, void* __restrict__ out, int out_bf16,
            int m, int d_in, int d_out, int splits, int blocks_per_split,
            int chain, int round_dot) {
  const int n_blk = d_in / 32;
  const int col0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int row0 = blockIdx.y * MT;
  const int b_begin = blockIdx.z * blocks_per_split;
  const int b_end = min(n_blk, b_begin + blocks_per_split);
  const bool active = col0 < d_out;

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
      if (row0 + i < m && k < nb * 32) {
        v = load_act(x, x_bf16, (size_t)(row0 + i) * d_in + (size_t)cb * 32 + k);
      }
      xs[i][k] = round_dot ? bf16_round(v) : v;
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
        float s[kCols];
        float sw[kCols];
        load_scales(scales, (size_t)b * d_out + col0, s);
#pragma unroll
        for (int c = 0; c < kCols; ++c) sw[c] = chain ? bf16_round(s[c]) : s[c];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) corr[i][c] = fmaf(bs[i][bb], s[c], corr[i][c]);
        }
        const uint8_t* prow = packed + (size_t)(16 * b) * d_out + col0;
#pragma unroll 4
        for (int j = 0; j < 16; ++j) {
          const uint32_t p = load_packed(prow + (size_t)j * d_out);
          float wl[kCols];
          float wh[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            float lo = (float)((p >> (8 * c)) & 0xFu) * sw[c];
            float hi = (float)((p >> (8 * c + 4)) & 0xFu) * sw[c];
            if (round_dot) {
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
      store_cols(part, out, out_bf16, splits, plane, (size_t)(row0 + i) * d_out + col0, v);
    }
  }
}

}  // namespace

// Launches the slab kernel (and the split-K reduction when splits > 1) on
// `stream`; returns cudaGetLastError() as an int, 0 on success.
extern "C" int q40_slab_launch(const void* x, int x_bf16, const float* bsum,
                               const void* packed, const void* scales, void* out,
                               int out_bf16, float* part, int m, int d_in, int d_out,
                               int mt, int splits, int blocks_per_split, int chain,
                               int round_dot, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(m, d_out, mt, splits);
  const uint8_t* p = reinterpret_cast<const uint8_t*>(packed);
  const __half* sc = reinterpret_cast<const __half*>(scales);
  switch (mt) {
    case 1:
      slab_kernel<1><<<grid, kThreads, 0, s>>>(x, x_bf16, bsum, p, sc, part, out, out_bf16, m,
                                               d_in, d_out, splits, blocks_per_split, chain,
                                               round_dot);
      break;
    case 8:
      slab_kernel<8><<<grid, kThreads, 0, s>>>(x, x_bf16, bsum, p, sc, part, out, out_bf16, m,
                                               d_in, d_out, splits, blocks_per_split, chain,
                                               round_dot);
      break;
    case 16:
      slab_kernel<16><<<grid, kThreads, 0, s>>>(x, x_bf16, bsum, p, sc, part, out, out_bf16, m,
                                                d_in, d_out, splits, blocks_per_split, chain,
                                                round_dot);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return finish(part, out, out_bf16, splits, (size_t)m * d_out, s);
}
