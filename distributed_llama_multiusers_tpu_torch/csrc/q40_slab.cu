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
// products accumulate in f32 (a bf16 x bf16 product is exact in f32), in
// quant-block order, rows j = 0..15 within a block.
//
// Load path: the ring of kStages shared-memory stages per thread block
// that q40_common.cuh defines (shared with the blockdot kernel). One stage
// is one quant block of the block's 512-column tile: 16 packed rows x 512
// bytes plus the block's 512 f16 scales (9 KB). The ring keeps
// kStages - 1 stages of 16-byte cp.async copies in flight (18 KB per thread
// block, 36-54 KB per SM) while the threads dequantize and multiply the
// stage that has landed; each thread reads its 4-byte word of every staged
// row from shared memory (consecutive threads, consecutive words: no bank
// conflicts). The activations are staged kChunkBlocks quant blocks at a
// time into one of two buffers, before the step's wait, so that their
// loads overlap the weight copies in flight and one __syncthreads per ring
// step serves both. The roundings are template flags: the inner loop has
// no branch and the compiler interleaves its rows.
//
// Rows that do not start on 16 bytes (d_out % 16 != 0) are staged by plain
// byte loads into the same tile (the kAsync = false instantiation, chosen by
// the launcher from d_out and the pointers), columns past d_out as zeros,
// and the store writes only the columns below d_out.
//
// What bounds it on an H100 (measured by chip_smoke.py and the kernel lab,
// PERF.md): no longer the loads. At decode shapes (m <= 32) the ring gets
// the packed bytes (0.5625 B per weight) to the SM faster than the threads
// issue the ~14 instructions a weight costs at m = 8 (nibble extract,
// convert, scale, round, then one f32 FMA per activation row), so the
// kernel runs at the SMs' issue rate, several times its byte bound; the
// products of a few MB (a 1B model's wq/wk/wv/wo) are bound by their two
// launches (this kernel and reduce_splits) and one memory latency. At
// prefill shapes (m in the hundreds) the f32 FMAs on CUDA cores: 2*m*d_in*
// d_out operations at 67 TFLOP/s, far above the weight-read time. Left for
// later: mma.sync / wgmma on the tensor cores (for prefill, and for the
// FMAs at m = 8), and summing the split-K partials inside the kernel
// instead of in the second reduce_splits launch.
#include "q40_common.cuh"

namespace {

// (float)((p >> shift) & 0xF), exactly, by one FADD: the nibble as the low
// mantissa bits of 2^23, minus 2^23 (no I2F on the conversion pipe, which
// runs at a quarter of the FMA rate)
__device__ __forceinline__ float nibble_f32(uint32_t p, int shift) {
  return __uint_as_float(0x4B000000u | ((p >> shift) & 0xFu)) - 8388608.f;
}

// bf16_round of two values with one conversion (cvt.rn.bf16x2.f32): the
// same round-to-nearest-even of each
__device__ __forceinline__ void bf16_round2(float& a, float& b) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);  // a in the low half
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&r);
  a = __uint_as_float(u << 16);
  b = __uint_as_float(u & 0xFFFF0000u);
}

// kRound: the dot operands are rounded to bf16 (a bf16 dot; else exact f32,
// v4). kChain: the bf16 chain's weights (scale rounded first). Both are
// template flags so that the inner loop carries no branch.
template <int MT, bool kAsync, bool kRound, bool kChain>
__global__ void __launch_bounds__(kThreads)
slab_kernel(const void* __restrict__ x, int x_bf16, const float* __restrict__ bsum,
            const uint8_t* __restrict__ packed, const __half* __restrict__ scales,
            float* __restrict__ part, void* __restrict__ out, int out_bf16,
            int m, int d_in, int d_out, int splits, int blocks_per_split) {
  const int n_blk = d_in / 32;
  const int x0 = blockIdx.x * kTileCols;
  const int col0 = x0 + threadIdx.x * kCols;
  const int row0 = blockIdx.y * MT;
  const int b_begin = blockIdx.z * blocks_per_split;
  const int b_end = min(n_blk, b_begin + blocks_per_split);
  const int n_steps = b_end - b_begin;
  const bool active = col0 < d_out;

  __shared__ SlabStage ring[kStages];
  __shared__ float xs[2][MT][kChunkBlocks * 32];  // two chunks of activations
  __shared__ float bs[2][MT][kChunkBlocks];

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

  // prologue: the first kStages - 1 blocks in flight, one commit group each
  // (empty groups too, so the group count always matches the step count)
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_steps) stage_block<kAsync>(ring[k], packed, scales, b_begin + k, x0, d_out);
    cp_async_commit();
  }

  for (int k = 0; k < n_steps; ++k) {
    const int bb = k % kChunkBlocks;
    const int xb = (k / kChunkBlocks) & 1;
    if (bb == 0) {
      // the next kChunkBlocks blocks of activations, loaded while this
      // step's weight copies are still in flight; buffer xb was last read
      // two chunks ago, before the previous step's barrier
      const int cb = b_begin + k;
      const int nb = min(kChunkBlocks, b_end - cb);
      for (int idx = threadIdx.x; idx < MT * kChunkBlocks * 32; idx += kThreads) {
        const int i = idx / (kChunkBlocks * 32);
        const int kk = idx % (kChunkBlocks * 32);
        float v = 0.f;
        if (row0 + i < m && kk < nb * 32) {
          v = load_act(x, x_bf16, (size_t)(row0 + i) * d_in + (size_t)cb * 32 + kk);
        }
        xs[xb][i][kk] = kRound ? bf16_round(v) : v;
      }
      for (int idx = threadIdx.x; idx < MT * kChunkBlocks; idx += kThreads) {
        const int i = idx / kChunkBlocks;
        const int c = idx % kChunkBlocks;
        bs[xb][i][c] =
            (row0 + i < m && c < nb) ? bsum[(size_t)(row0 + i) * n_blk + cb + c] : 0.f;
      }
    }
    cp_async_wait<kStages - 2>();  // this thread's copies of block k have landed
    __syncthreads();               // everyone's have, and the activations; stage k-1 is free
    const int ahead = k + kStages - 1;
    if (ahead < n_steps) {
      stage_block<kAsync>(ring[ahead % kStages], packed, scales, b_begin + ahead, x0, d_out);
    }
    cp_async_commit();

    if (active) {
      const SlabStage& st = ring[k % kStages];
      float s[kCols];
      float sw[kCols];
      load_scales(reinterpret_cast<const __half*>(st.scales), threadIdx.x * kCols, s);
#pragma unroll
      for (int c = 0; c < kCols; ++c) sw[c] = kChain ? bf16_round(s[c]) : s[c];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) corr[i][c] = fmaf(bs[xb][i][bb], s[c], corr[i][c]);
      }
#pragma unroll 4
      for (int j = 0; j < 16; ++j) {
        const uint32_t p = load_packed(&st.packed[j][threadIdx.x * kCols]);
        float wl[kCols];
        float wh[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          float lo = nibble_f32(p, 8 * c) * sw[c];
          float hi = nibble_f32(p, 8 * c + 4) * sw[c];
          if constexpr (kRound) bf16_round2(lo, hi);
          wl[c] = lo;
          wh[c] = hi;
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float xl = xs[xb][i][32 * bb + j];
          const float xh = xs[xb][i][32 * bb + 16 + j];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc[i][c] = fmaf(xl, wl[c], fmaf(xh, wh[c], acc[i][c]));
          }
        }
      }
    }
  }

  if (!active) return;
  const int n = min(kCols, d_out - col0);
  const size_t plane = (size_t)blockIdx.z * m * d_out;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (row0 + i < m) {
      float v[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[c] = acc[i][c] - 8.f * corr[i][c];
      store_cols_n<!kAsync>(part, out, out_bf16, splits, plane,
                            (size_t)(row0 + i) * d_out + col0, v, n);
    }
  }
}

// The launch arguments, shared by every instantiation.
struct SlabArgs {
  const void* x;
  int x_bf16;
  const float* bsum;
  const uint8_t* packed;
  const __half* scales;
  float* part;
  void* out;
  int out_bf16, m, d_in, d_out, splits, blocks_per_split;
};

template <int MT, bool kAsync, bool kRound, bool kChain>
void launch(dim3 grid, cudaStream_t s, const SlabArgs& a) {
  slab_kernel<MT, kAsync, kRound, kChain><<<grid, kThreads, 0, s>>>(
      a.x, a.x_bf16, a.bsum, a.packed, a.scales, a.part, a.out, a.out_bf16, a.m, a.d_in,
      a.d_out, a.splits, a.blocks_per_split);
}

// The three roundings a product runs: exact f32 (v4 on an f32 dot), v4 on a
// bf16 dot, the bf16 chain.
template <int MT, bool kAsync>
void launch_rounding(int chain, int round_dot, dim3 grid, cudaStream_t s, const SlabArgs& a) {
  if (!round_dot) {
    launch<MT, kAsync, false, false>(grid, s, a);
  } else if (!chain) {
    launch<MT, kAsync, true, false>(grid, s, a);
  } else {
    launch<MT, kAsync, true, true>(grid, s, a);
  }
}

template <int MT>
void launch_mt(bool async, int chain, int round_dot, dim3 grid, cudaStream_t s,
               const SlabArgs& a) {
  if (async) {
    launch_rounding<MT, true>(chain, round_dot, grid, s, a);
  } else {
    launch_rounding<MT, false>(chain, round_dot, grid, s, a);
  }
}

template <int MT>
int info_mt(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, slab_kernel<MT, true, true, false>);
  if (err != cudaSuccess) return (int)err;
  out[0] = kStages;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  return 0;
}

}  // namespace

// Launches the slab kernel (and the split-K reduction when splits > 1) on
// `stream`; returns cudaGetLastError() as an int, 0 on success. The
// cp.async stage needs 16-byte aligned rows and planes; other widths take
// the plain-load stage of the same kernel.
extern "C" int q40_slab_launch(const void* x, int x_bf16, const float* bsum,
                               const void* packed, const void* scales, void* out,
                               int out_bf16, float* part, int m, int d_in, int d_out,
                               int mt, int splits, int blocks_per_split, int chain,
                               int round_dot, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(m, d_out, mt, splits);
  const SlabArgs a{x, x_bf16, bsum, reinterpret_cast<const uint8_t*>(packed),
                   reinterpret_cast<const __half*>(scales), part, out, out_bf16, m, d_in,
                   d_out, splits, blocks_per_split};
  const bool async = rows_async(d_out, packed, scales);
  switch (mt) {
    case 1:
      launch_mt<1>(async, chain, round_dot, grid, s, a);
      break;
    case 8:
      launch_mt<8>(async, chain, round_dot, grid, s, a);
      break;
    case 16:
      launch_mt<16>(async, chain, round_dot, grid, s, a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return finish(part, out, out_bf16, splits, (size_t)m * d_out, s);
}

// The geometry of the instantiation a bf16 v4 product runs (cp.async stage)
// at m-tile `mt`: out[0] ring stages,
// out[1] static shared memory bytes per thread block, out[2] registers per
// thread, out[3] local (spill) bytes per thread. Returns a CUDA error code.
extern "C" int q40_slab_info(int mt, int* out) {
  switch (mt) {
    case 1:
      return info_mt<1>(out);
    case 8:
      return info_mt<8>(out);
    case 16:
      return info_mt<16>(out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
