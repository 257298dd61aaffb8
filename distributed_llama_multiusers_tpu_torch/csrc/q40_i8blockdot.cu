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
// Design for Hopper. The block dots run on the tensor cores, as the
// Pallas kernel runs them on the TPU's matrix unit (two int8 dot_generals
// per quant block with int32 results): per quant block one mma.sync
// m16n8k32 s8 x s8 -> s32 product covers the whole 32-deep block, its low
// and high halves at once, into a zero C, so the int32 block dot is exact
// (|d| <= 32 * 127 * 15 = 60,960). Then an f32 epilogue on the fragment
// registers, acc += (sx * d - 8 * bsum) * s; only the f32 summation order
// over blocks differs from the plain version. Output columns sit on the
// M = 16 side and activation rows on the N = 8 side, as in blockdot
// (q40_common.cuh's fragment geometry): m = 1 pads N with zero rows in
// shared memory, m-tile 16 is two N-tiles.
//
// Fragments. In the s8 A fragment of m16n8k32, thread (g, t) holds k =
// 4t..4t+3 of fragment rows g and g+8 in a0/a1, and k = 16+4t..16+4t+3 in
// a2/a3. Those are the low and the high nibbles of the same four packed
// bytes: rows 4t..4t+3 of the quant block, one column each
// (quants/packed.py: row j holds input j in its low nibble, 16 + j in its
// high one). So a thread reads 16-byte chunks (its 16 columns) of its four
// rows, a 4x4 byte transpose by permutes turns each group of four columns
// into one word per column, and each column word feeds two A registers:
// w & 0x0F0F0F0F and (w >> 4) & 0x0F0F0F0F. No conversion and no subtract:
// the nibbles 0..15 are valid s8. B is two 32-bit shared loads of xq row g,
// at inputs 32b + 4t and 32b + 16 + 4t.
//
// Bank conflicts. With the stage's 528-byte row pitch, rows 8 apart share
// banks, and in one 16-byte load a quarter-warp (g = 2j, 2j+1 and t = 0..3)
// would read rows 4t + r, where t = 0 and 2 (and 1 and 3) are 8 apart.
// Threads with t >= 2 read their rows in the order 4t + (r ^ 2) instead, so
// each load's quarter-warp covers the 32 banks once; the transpose's last
// permute puts their column words back in k order (selectors 0x1054 and
// 0x3276 in place of 0x5410 and 0x7632).
//
// Load path: the weights stream through the cp.async stage ring of
// q40_common.cuh (shared with the other two kernels; kStages - 1 quant
// blocks of the tile in flight); xq, sx and bsum are staged kChunkBlocks
// quant blocks at a time into one of two buffers before the step's wait,
// and one __syncthreads per ring step serves both. Rows that do not start
// on 16 bytes (d_out % 16 != 0) are staged by plain loads into the same
// tile (the kAsync = false instantiation, chosen by the launcher from d_out
// and the pointers), and the store writes only the columns below d_out. At
// m-tiles of 8 and 16 rows the results leave through shared memory as
// whole rows, one row straight from the fragments (store_fragments).
//
// What bounds it on an H100: bytes. A 16x32 fragment of weights costs 4/8
// of a shared load, 3 byte permutes, 4 mask/shift ops and one IMMA per
// N-tile, so its time goes to the packed weight (0.5625 B per weight at
// 3.35 TB/s), the split-K partials it writes and reduce_splits reads back,
// and, for the products of a few MB, its two launches.
#include "q40_common.cuh"

namespace {

constexpr int kXPitch = kChunkBlocks * 32 + 16;  // bytes per staged xq row: rows 4 banks apart

// D (16x8 s32) = A (16x32 s8, row) * B (32x8 s8, col), C = 0
__device__ __forceinline__ void mma_s8(int d[4], const uint32_t a[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0));
}

template <int MT, bool kAsync>
__global__ void __launch_bounds__(kThreads)
i8blockdot_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                  const float* __restrict__ bsum, const uint8_t* __restrict__ packed,
                  const __half* __restrict__ scales, float* __restrict__ part,
                  void* __restrict__ out, int out_bf16, int m, int d_in, int d_out,
                  int splits, int blocks_per_split) {
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
  // load r reads row 4t + (r ^ tx); the last transpose permute undoes it
  const int tx = t & 2;
  const uint32_t sel_even = tx ? 0x1054u : 0x5410u;
  const uint32_t sel_odd = tx ? 0x3276u : 0x7632u;

  __shared__ SlabStage ring[kStages];
  __shared__ __align__(16) int8_t xs[2][NR][kXPitch];  // xq, two chunks
  __shared__ float ss[2][NR][kChunkBlocks];            // sx
  __shared__ float bs[2][NR][kChunkBlocks];            // bsum

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
      // the next kChunkBlocks blocks of xq, sx and bsum, rows past the
      // m-tile as zeros; loaded while this step's weight copies are in
      // flight. Buffer xb was last read two chunks ago, before the previous
      // step's barrier.
      const int cb = b_begin + k;
      const int nb = min(kChunkBlocks, b_end - cb);
      for (int idx = threadIdx.x; idx < NR * kChunkBlocks * 8; idx += kThreads) {
        const int i = idx / (kChunkBlocks * 8);
        const int w = idx % (kChunkBlocks * 8);
        int v = 0;
        if (i < MT && row0 + i < m && w < nb * 8) {
          v = *reinterpret_cast<const int*>(xq + (size_t)(row0 + i) * d_in + (size_t)cb * 32 +
                                            4 * w);
        }
        *reinterpret_cast<int*>(&xs[xb][i][4 * w]) = v;
      }
      for (int idx = threadIdx.x; idx < NR * kChunkBlocks; idx += kThreads) {
        const int i = idx / kChunkBlocks;
        const int c = idx % kChunkBlocks;
        const bool ok = i < MT && row0 + i < m && c < nb;
        const size_t at = (size_t)(row0 + i) * n_blk + cb + c;
        ss[xb][i][c] = ok ? sx[at] : 0.f;
        bs[xb][i][c] = ok ? bsum[at] : 0.f;
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
      // packed rows 4t..4t+3 of this thread's 16 columns, load r from row
      // 4t + (r ^ tx)
      const uint4 r0 = *reinterpret_cast<const uint4*>(&st.packed[4 * t + tx][cw]);
      const uint4 r1 = *reinterpret_cast<const uint4*>(&st.packed[4 * t + (1 ^ tx)][cw]);
      const uint4 r2 = *reinterpret_cast<const uint4*>(&st.packed[4 * t + (2 ^ tx)][cw]);
      const uint4 r3 = *reinterpret_cast<const uint4*>(&st.packed[4 * t + (3 ^ tx)][cw]);
      const uint32_t w0[4] = {r0.x, r0.y, r0.z, r0.w};
      const uint32_t w1[4] = {r1.x, r1.y, r1.z, r1.w};
      const uint32_t w2[4] = {r2.x, r2.y, r2.z, r2.w};
      const uint32_t w3[4] = {r3.x, r3.y, r3.z, r3.w};
      const uint4 s03 = *reinterpret_cast<const uint4*>(&st.scales[cw]);
      const uint4 s47 = *reinterpret_cast<const uint4*>(&st.scales[cw + 8]);
      const uint32_t sp[8] = {s03.x, s03.y, s03.z, s03.w, s47.x, s47.y, s47.z, s47.w};

      // B fragments (xq at inputs 4t and 16 + 4t of row g of each N-tile),
      // and sx and 8 * bsum of rows 2t and 2t+1 of each N-tile
      uint32_t b0[NT];
      uint32_t b1[NT];
      float sxr[NT][2];
      float corr[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* xr = &xs[xb][8 * nt + g][32 * bb + 4 * t];
        b0[nt] = *reinterpret_cast<const uint32_t*>(xr);
        b1[nt] = *reinterpret_cast<const uint32_t*>(xr + 16);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sxr[nt][e] = ss[xb][8 * nt + 2 * t + e][bb];
          corr[nt][e] = 8.f * bs[xb][8 * nt + 2 * t + e][bb];
        }
      }

#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // columns 4q..4q+3: 4x4 byte transpose into one word per column,
        // byte j = row 4t + j
        const uint32_t u0 = __byte_perm(w0[q], w1[q], 0x5140);
        const uint32_t u1 = __byte_perm(w2[q], w3[q], 0x5140);
        const uint32_t u2 = __byte_perm(w0[q], w1[q], 0x7362);
        const uint32_t u3 = __byte_perm(w2[q], w3[q], 0x7362);
        const uint32_t col[4] = {__byte_perm(u0, u1, sel_even), __byte_perm(u0, u1, sel_odd),
                                 __byte_perm(u2, u3, sel_even), __byte_perm(u2, u3, sel_odd)};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // M-tile i: columns 2i (fragment row g) and 2i+1 (row g+8)
          const int i = 2 * q + h;
          const uint32_t ca = col[2 * h];
          const uint32_t cb = col[2 * h + 1];
          const uint32_t a[4] = {ca & 0x0F0F0F0Fu, cb & 0x0F0F0F0Fu, (ca >> 4) & 0x0F0F0F0Fu,
                                 (cb >> 4) & 0x0F0F0F0Fu};
          const float2 s = __half22float2(*reinterpret_cast<const __half2*>(&sp[i]));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            int d[4];
            mma_s8(d, a, b0[nt], b1[nt]);
            // d[0..1]: column 2i, rows 2t, 2t+1; d[2..3]: column 2i+1
            acc[i][nt][0] = fmaf(fmaf(sxr[nt][0], (float)d[0], -corr[nt][0]), s.x, acc[i][nt][0]);
            acc[i][nt][1] = fmaf(fmaf(sxr[nt][1], (float)d[1], -corr[nt][1]), s.x, acc[i][nt][1]);
            acc[i][nt][2] = fmaf(fmaf(sxr[nt][0], (float)d[2], -corr[nt][0]), s.y, acc[i][nt][2]);
            acc[i][nt][3] = fmaf(fmaf(sxr[nt][1], (float)d[3], -corr[nt][1]), s.y, acc[i][nt][3]);
          }
        }
      }
    }
  }

  store_fragments<MT, !kAsync>(acc, ring, part, out, out_bf16, splits, m, d_out, x0, row0, cw,
                                warp_active);
}

template <int MT>
void launch(bool async, dim3 grid, cudaStream_t s, const int8_t* x, const float* sx,
            const float* bsum, const uint8_t* p, const __half* sc, float* part, void* out,
            int out_bf16, int m, int d_in, int d_out, int splits, int blocks_per_split) {
  if (async) {
    i8blockdot_kernel<MT, true><<<grid, kThreads, 0, s>>>(x, sx, bsum, p, sc, part, out,
                                                          out_bf16, m, d_in, d_out, splits,
                                                          blocks_per_split);
  } else {
    i8blockdot_kernel<MT, false><<<grid, kThreads, 0, s>>>(x, sx, bsum, p, sc, part, out,
                                                           out_bf16, m, d_in, d_out, splits,
                                                           blocks_per_split);
  }
}

template <int MT>
int info_mt(int* out) {
  return kernel_info(i8blockdot_kernel<MT, true>, i8blockdot_kernel<MT, false>, out);
}

}  // namespace

// Launches the i8blockdot kernel (and the split-K reduction when splits > 1)
// on `stream`; returns cudaGetLastError() as an int, 0 on success. The
// cp.async stage needs 16-byte aligned rows and planes; other widths take
// the plain-load stage of the same kernel.
extern "C" int q40_i8blockdot_launch(const void* xq, const float* sx, const float* bsum,
                                     const void* packed, const void* scales, void* out,
                                     int out_bf16, float* part, int m, int d_in, int d_out,
                                     int mt, int splits, int blocks_per_split, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(m, d_out, mt, splits);
  const int8_t* x = reinterpret_cast<const int8_t*>(xq);
  const uint8_t* p = reinterpret_cast<const uint8_t*>(packed);
  const __half* sc = reinterpret_cast<const __half*>(scales);
  const bool async = rows_async(d_out, packed, scales);
  switch (mt) {
    case 1:
      launch<1>(async, grid, s, x, sx, bsum, p, sc, part, out, out_bf16, m, d_in, d_out, splits,
                blocks_per_split);
      break;
    case 8:
      launch<8>(async, grid, s, x, sx, bsum, p, sc, part, out, out_bf16, m, d_in, d_out, splits,
                blocks_per_split);
      break;
    case 16:
      launch<16>(async, grid, s, x, sx, bsum, p, sc, part, out, out_bf16, m, d_in, d_out, splits,
                 blocks_per_split);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return finish(part, out, out_bf16, splits, (size_t)m * d_out, s);
}

// The geometry of the i8blockdot kernel at m-tile `mt` (kernel_info in
// q40_common.cuh: ring stages, shared memory, registers and spills, the
// larger of the cp.async and the plain-load instantiation's). Returns a
// CUDA error code.
extern "C" int q40_i8blockdot_info(int mt, int* out) {
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
