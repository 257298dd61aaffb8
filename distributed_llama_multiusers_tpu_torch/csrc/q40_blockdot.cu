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
// Design for Hopper. The block dots run on the tensor cores, as the
// Pallas kernel runs them on the TPU's matrix unit (two dot_generals per
// quant block): per quant block two mma.sync m16n8k16 bf16 products with
// f32 results (lo half, then hi half, into a fresh fragment), then an f32
// epilogue on the fragment registers, acc += (blk - 8 * bsum) * s. Output
// columns sit on the M = 16 side and activation rows on the N = 8 side, so
// at decode (m = 8) one product covers 16 columns x 8 rows unpadded; m = 1
// pads N with zero rows in shared memory, m-tile 16 is two N-tiles. The
// products x_bf16 * nibble are exact in f32; only the f32 summation order
// differs from the plain version.
//
// Fragments. Thread (g = lane / 4, t = lane % 4) of warp w owns the 16
// columns w*128 + g*16 .. +15 of the thread block's 512-column tile: 8 M-
// tiles, M-tile i mapping fragment rows g and g+8 to columns 2i and 2i+1
// of those 16. Its A operands are the nibbles of packed rows 2t, 2t+1,
// 2t+8 and 2t+9 (k = 2t, 2t+1, 2t+8, 2t+9 of the lo half from the low
// nibbles, of the hi half from the high ones): four 16-byte shared loads a
// quant block, turned into bf16 pairs by byte permutes and one exact bf16x2
// subtract (0x4300 | n is bf16(128 + n)). Its B operands are bf16 pairs of
// x at inputs 32b + 2t (+8, +16, +24) of row g of each N-tile, straight
// from shared memory, where x is stored already rounded.
//
// Load path: the weights stream through the cp.async stage ring of
// q40_common.cuh (shared with the slab kernel; kStages - 1 quant blocks of
// the tile in flight), the activations are staged kChunkBlocks quant
// blocks at a time into one of two buffers before the step's wait, and one
// __syncthreads per ring step serves both. Rows that do not start on 16
// bytes (d_out % 16 != 0) are staged by plain loads into the same tile
// (the kAsync = false instantiation, chosen by the launcher from d_out and
// the pointers), and the store writes only the columns below d_out. At
// m-tiles of 8 and 16 rows the results leave through shared memory, so
// that every warp writes whole row segments (store_fragments in
// q40_common.cuh): at m = 8 the split-K partials of a 1B model's products
// are 0.44-1.78x the bytes of their weights (all but wcls). One row
// (m-tile 1) is stored straight from the fragments, where the detour
// through shared memory measured slower.
//
// What bounds it on an H100: bytes. Per weight the kernel issues a fraction
// of an instruction (a 16x16 fragment of weights costs about a dozen
// integer and bf16x2 instructions and one HMMA), so its time goes to the
// packed weight (0.5625 B per weight at 3.35 TB/s), the split-K partials it
// writes and reduce_splits reads back, and, for the products of a few MB,
// its two launches and a memory latency or two per thread block.
#include "q40_common.cuh"

namespace {

constexpr int kXPitch = kChunkBlocks * 32 + 8;  // bf16 per staged x row: rows 4 banks apart

// D (16x8 f32) = A (16x16 bf16, row) * B (16x8 bf16, col) + C
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1, const float c[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

// Two nibbles (bits 0-3 and 16-19 of v) as a bf16x2 pair, exactly:
// 0x4300 | n is bf16(128 + n), and 128 + n - 128 rounds to nothing.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t v) {
  const uint32_t biased = (v & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                                   __floats2bfloat162_rn(128.f, 128.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

template <int MT, bool kAsync>
__global__ void __launch_bounds__(kThreads)
blockdot_kernel(const void* __restrict__ x, int x_bf16, const float* __restrict__ bsum,
                const uint8_t* __restrict__ packed, const __half* __restrict__ scales,
                float* __restrict__ part, void* __restrict__ out, int out_bf16,
                int m, int d_in, int d_out, int splits, int blocks_per_split) {
  constexpr int NT = (MT + 7) / 8;  // N-tiles of 8 activation rows
  constexpr int NR = 8 * NT;        // staged rows: the m-tile, zero-padded to whole N-tiles
  const int n_blk = d_in / 32;
  const int x0 = blockIdx.x * kTileCols;
  const int row0 = blockIdx.y * MT;
  const int b_begin = blockIdx.z * blocks_per_split;
  const int b_end = min(n_blk, b_begin + blocks_per_split);
  const int n_steps = b_end - b_begin;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int cw = (threadIdx.x / 32) * kWarpCols + g * 16;  // this thread's 16 columns
  const bool warp_active = x0 + (int)(threadIdx.x / 32) * kWarpCols < d_out;

  __shared__ SlabStage ring[kStages];
  __shared__ __align__(16) uint16_t xs[2][NR][kXPitch];  // bf16 bits, two chunks
  __shared__ float bs[2][NR][kChunkBlocks];

  float acc[8][NT][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;
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
      // the next kChunkBlocks blocks of activations, rounded to bf16, rows
      // past the m-tile as zeros; loaded while this step's weight copies
      // are in flight. Buffer xb was last read two chunks ago, before the
      // previous step's barrier.
      const int cb = b_begin + k;
      const int nb = min(kChunkBlocks, b_end - cb);
      for (int idx = threadIdx.x; idx < NR * kChunkBlocks * 32; idx += kThreads) {
        const int i = idx / (kChunkBlocks * 32);
        const int kk = idx % (kChunkBlocks * 32);
        float v = 0.f;
        if (i < MT && row0 + i < m && kk < nb * 32) {
          v = load_act(x, x_bf16, (size_t)(row0 + i) * d_in + (size_t)cb * 32 + kk);
        }
        xs[xb][i][kk] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
      }
      for (int idx = threadIdx.x; idx < NR * kChunkBlocks; idx += kThreads) {
        const int i = idx / kChunkBlocks;
        const int c = idx % kChunkBlocks;
        bs[xb][i][c] = (i < MT && row0 + i < m && c < nb)
                           ? bsum[(size_t)(row0 + i) * n_blk + cb + c] : 0.f;
      }
    }
    cp_async_wait<kStages - 2>();  // this thread's copies of block k have landed
    __syncthreads();               // everyone's have, and the activations; stage k-1 is free
    const int ahead = k + kStages - 1;
    if (ahead < n_steps) {
      stage_block<kAsync>(ring[ahead % kStages], packed, scales, b_begin + ahead, x0, d_out);
    }
    cp_async_commit();

    if (warp_active) {  // warp-uniform: mma.sync needs the whole warp
      const SlabStage& st = ring[k % kStages];
      // packed rows 2t, 2t+1, 2t+8, 2t+9 of this thread's 16 columns
      const uint4 r0 = *reinterpret_cast<const uint4*>(&st.packed[2 * t][cw]);
      const uint4 r1 = *reinterpret_cast<const uint4*>(&st.packed[2 * t + 1][cw]);
      const uint4 r2 = *reinterpret_cast<const uint4*>(&st.packed[2 * t + 8][cw]);
      const uint4 r3 = *reinterpret_cast<const uint4*>(&st.packed[2 * t + 9][cw]);
      const uint32_t w0[4] = {r0.x, r0.y, r0.z, r0.w};
      const uint32_t w1[4] = {r1.x, r1.y, r1.z, r1.w};
      const uint32_t w2[4] = {r2.x, r2.y, r2.z, r2.w};
      const uint32_t w3[4] = {r3.x, r3.y, r3.z, r3.w};
      const uint4 s03 = *reinterpret_cast<const uint4*>(&st.scales[cw]);
      const uint4 s47 = *reinterpret_cast<const uint4*>(&st.scales[cw + 8]);
      const uint32_t sp[8] = {s03.x, s03.y, s03.z, s03.w, s47.x, s47.y, s47.z, s47.w};

      // B fragments (x at inputs 2t, 2t+8 of each half) and the -8 * bsum
      // of rows 2t and 2t+1 of each N-tile
      uint32_t blo[NT][2];
      uint32_t bhi[NT][2];
      float corr[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint16_t* xr = &xs[xb][8 * nt + g][32 * bb + 2 * t];
        blo[nt][0] = *reinterpret_cast<const uint32_t*>(xr);
        blo[nt][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
        bhi[nt][0] = *reinterpret_cast<const uint32_t*>(xr + 16);
        bhi[nt][1] = *reinterpret_cast<const uint32_t*>(xr + 24);
        corr[nt][0] = 8.f * bs[xb][8 * nt + 2 * t][bb];
        corr[nt][1] = 8.f * bs[xb][8 * nt + 2 * t + 1][bb];
      }

#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // M-tile i: columns 2i (fragment row g) and 2i+1 (row g+8); the
        // permute puts both columns' bytes of rows (2t, 2t+1) in one word,
        // [r0.c, r0.c+1, r1.c, r1.c+1], and likewise rows (2t+8, 2t+9)
        const uint32_t sel = (i & 1) ? 0x7632u : 0x5410u;
        const uint32_t p01 = __byte_perm(w0[i / 2], w1[i / 2], sel);
        const uint32_t p23 = __byte_perm(w2[i / 2], w3[i / 2], sel);
        const uint32_t a_lo[4] = {nibbles_bf16x2(p01), nibbles_bf16x2(p01 >> 8),
                                  nibbles_bf16x2(p23), nibbles_bf16x2(p23 >> 8)};
        const uint32_t a_hi[4] = {nibbles_bf16x2(p01 >> 4), nibbles_bf16x2(p01 >> 12),
                                  nibbles_bf16x2(p23 >> 4), nibbles_bf16x2(p23 >> 12)};
        const float2 s = __half22float2(*reinterpret_cast<const __half2*>(&sp[i]));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float z[4] = {0.f, 0.f, 0.f, 0.f};
          float lo[4];
          float blk[4];
          mma_bf16(lo, a_lo, blo[nt][0], blo[nt][1], z);
          mma_bf16(blk, a_hi, bhi[nt][0], bhi[nt][1], lo);
          // blk[0..1]: column 2i, rows 2t, 2t+1; blk[2..3]: column 2i+1
          acc[i][nt][0] = fmaf(blk[0] - corr[nt][0], s.x, acc[i][nt][0]);
          acc[i][nt][1] = fmaf(blk[1] - corr[nt][1], s.x, acc[i][nt][1]);
          acc[i][nt][2] = fmaf(blk[2] - corr[nt][0], s.y, acc[i][nt][2]);
          acc[i][nt][3] = fmaf(blk[3] - corr[nt][1], s.y, acc[i][nt][3]);
        }
      }
    }
  }

  store_fragments<MT, !kAsync>(acc, ring, part, out, out_bf16, splits, m, d_out, x0, row0, cw,
                                warp_active);
}

template <int MT>
void launch(bool async, dim3 grid, cudaStream_t s, const void* x, int x_bf16,
            const float* bsum, const uint8_t* p, const __half* sc, float* part, void* out,
            int out_bf16, int m, int d_in, int d_out, int splits, int blocks_per_split) {
  if (async) {
    blockdot_kernel<MT, true><<<grid, kThreads, 0, s>>>(x, x_bf16, bsum, p, sc, part, out,
                                                        out_bf16, m, d_in, d_out, splits,
                                                        blocks_per_split);
  } else {
    blockdot_kernel<MT, false><<<grid, kThreads, 0, s>>>(x, x_bf16, bsum, p, sc, part, out,
                                                         out_bf16, m, d_in, d_out, splits,
                                                         blocks_per_split);
  }
}

template <int MT>
int info_mt(int* out) {
  return kernel_info(blockdot_kernel<MT, true>, blockdot_kernel<MT, false>, out);
}

}  // namespace

// Launches the blockdot kernel (and the split-K reduction when splits > 1)
// on `stream`; returns cudaGetLastError() as an int, 0 on success. The
// cp.async stage needs 16-byte aligned rows and planes; other widths take
// the plain-load stage of the same kernel.
extern "C" int q40_blockdot_launch(const void* x, int x_bf16, const float* bsum,
                                   const void* packed, const void* scales, void* out,
                                   int out_bf16, float* part, int m, int d_in, int d_out,
                                   int mt, int splits, int blocks_per_split, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(m, d_out, mt, splits);
  const uint8_t* p = reinterpret_cast<const uint8_t*>(packed);
  const __half* sc = reinterpret_cast<const __half*>(scales);
  const bool async = rows_async(d_out, packed, scales);
  switch (mt) {
    case 1:
      launch<1>(async, grid, s, x, x_bf16, bsum, p, sc, part, out, out_bf16, m, d_in, d_out,
                splits, blocks_per_split);
      break;
    case 8:
      launch<8>(async, grid, s, x, x_bf16, bsum, p, sc, part, out, out_bf16, m, d_in, d_out,
                splits, blocks_per_split);
      break;
    case 16:
      launch<16>(async, grid, s, x, x_bf16, bsum, p, sc, part, out, out_bf16, m, d_in, d_out,
                 splits, blocks_per_split);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return finish(part, out, out_bf16, splits, (size_t)m * d_out, s);
}

// The geometry of the blockdot kernel at m-tile `mt` (kernel_info in
// q40_common.cuh: ring stages, shared memory, registers and spills, the
// larger of the cp.async and the plain-load instantiation's). Returns a
// CUDA error code.
extern "C" int q40_blockdot_info(int mt, int* out) {
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
