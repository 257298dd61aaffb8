// Q40 lab probe: how fast the packed Q40 bytes reach the SM, stage by stage.
//
// Replaces the lab's read and stage probes (all pl.pallas_call kernels over
// packed u8 planes with a [1, d_out] output):
//   scripts/kernel_lab.py:284   read_probe (_probe_kernel): column byte sums
//   scripts/stage_probe.py:208  staged (_k_dma, _k_unpack, _k_nib, _k_conv,
//                               _k_scale) over [L, half, d_out]
//   scripts/stage_probe.py:248  staged32 (_k32_nib, _k32_conv) on u32 words
//   scripts/stage_probe2.py:107, :129, :196  dma_call, scale_call over the
//                               slab layout [L, J, half, T] and dma_wide over
//                               full-width row blocks
//
// What it computes. The packed stack is [L][J][R][Cw] 32-bit words (J = 1
// for the row-major and wide layouts; u8 words hold 4 adjacent byte
// columns, u32 words are one output column each, stage_probe.py:235). The
// reductions sum over ALL L*R rows (the JAX probes overwrite their output on
// every step of an "arbitrary" grid axis and keep the last step only; here
// every byte read counts, or the compiler could sink the loads of a
// non-final step under the store's branch). Per word p:
//   bytes         sum of the bytes                      (u8)
//   nibbles       sum of lo + hi nibbles                (u8; u32: 8 nibbles)
//   convert_f32   the same with each nibble converted to f32 and added in f32
//   convert_bf16  the same in bf16 (__hadd), then to f32 (exact: sums <= 120)
//   scale         sum of lo*s + hi*s, s the block's f16 scale in f32 (u8)
// Integer sums are exact in the f32 output (< 2^24). The dma stage stages
// every tile into shared memory with 16-byte cp.async copies (asm volatile:
// the compiler cannot drop them) and writes one row as f32: row
// (R/tile_rows - 1)*tile_rows of plane L-1, the row the JAX kernels' last
// grid step writes.
//
// What bounds it on an H100: bytes, the packed stack read once at 3.35 TB/s
// (plus the scales for the scale stage). The stack of L planes exceeds the
// 50 MB L2, so a pass streams from HBM. Design: one thread per 32-bit word
// column (4 byte columns, as the serving kernels read a packed row), 16 rows'
// loads in flight per thread before any is used, and the L*R rows split
// across thread blocks until about 8 blocks per SM are in flight; split
// partials are summed by reduce_splits (q40_common.cuh) in a fixed order.
#include "q40_common.cuh"

namespace {

enum Stage { kDma = 0, kBytes = 1, kNibbles = 2, kConvF32 = 3, kConvBf16 = 4, kScale = 5 };
constexpr int kBatch = 16;      // rows whose loads a thread has in flight together
constexpr int kStageRows = 32;  // rows of one shared-memory tile (dma stage)
constexpr int kTileBytes = kThreads * kCols;  // 512 byte columns per thread block

template <int STAGE, bool U32>
__global__ void __launch_bounds__(kThreads)
probe_reduce(const uint32_t* __restrict__ words, const __half* __restrict__ scales,
             float* __restrict__ part, float* __restrict__ out, int L, int J, int R, int Cw,
             int splits, int rows_per_split) {
  constexpr int NC = U32 ? 1 : kCols;  // output columns per word
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int j = blockIdx.y;
  const int total = L * R;
  const int g0 = blockIdx.z * rows_per_split;
  const int g1 = min(total, g0 + rows_per_split);
  if (w >= Cw) return;
  const int n_blk = R / 16;
  const int C = Cw * NC;  // output columns of one tile

  int iacc[NC];
  float facc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    iacc[c] = 0;
    facc[c] = 0.f;
  }
  int l = g0 / R;
  int r = g0 % R;
  for (int g = g0; g < g1; g += kBatch) {
    uint32_t p[kBatch];
    size_t soff[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const bool valid = g + i < g1;
      const size_t plane = (size_t)l * J + j;
      p[i] = valid ? __ldg(words + (plane * R + r) * Cw + w) : 0u;
      soff[i] = valid ? (plane * n_blk + r / 16) * C + (size_t)w * NC : (size_t)-1;
      if (++r == R) {
        r = 0;
        ++l;
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const uint32_t v = p[i];
      if (STAGE == kScale) {
        float s[kCols] = {0.f, 0.f, 0.f, 0.f};
        if (soff[i] != (size_t)-1) load_scales(scales, soff[i], s);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float lo = (float)((v >> (8 * c)) & 0xFu);
          const float hi = (float)((v >> (8 * c + 4)) & 0xFu);
          facc[c] = __fadd_rn(facc[c], __fadd_rn(__fmul_rn(lo, s[c]), __fmul_rn(hi, s[c])));
        }
      } else if (U32) {
        if (STAGE == kNibbles) {
#pragma unroll
          for (int sh = 0; sh < 32; sh += 4) iacc[0] += (int)((v >> sh) & 0xFu);
        } else if (STAGE == kConvF32) {
          float a = 0.f;
#pragma unroll
          for (int sh = 0; sh < 32; sh += 4) a = __fadd_rn(a, (float)((v >> sh) & 0xFu));
          facc[0] = __fadd_rn(facc[0], a);
        } else {  // kConvBf16
          __nv_bfloat16 a = __float2bfloat16_rn(0.f);
#pragma unroll
          for (int sh = 0; sh < 32; sh += 4)
            a = __hadd(a, __float2bfloat16_rn((float)((v >> sh) & 0xFu)));
          facc[0] = __fadd_rn(facc[0], __bfloat162float(a));
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const uint32_t lo = (v >> (8 * c)) & 0xFu;
          const uint32_t hi = (v >> (8 * c + 4)) & 0xFu;
          if (STAGE == kBytes) {
            iacc[c] += (int)((v >> (8 * c)) & 0xFFu);
          } else if (STAGE == kNibbles) {
            iacc[c] += (int)(lo + hi);
          } else if (STAGE == kConvF32) {
            facc[c] = __fadd_rn(facc[c], __fadd_rn((float)lo, (float)hi));
          } else {  // kConvBf16
            const __nv_bfloat16 a =
                __hadd(__float2bfloat16_rn((float)lo), __float2bfloat16_rn((float)hi));
            facc[c] = __fadd_rn(facc[c], __bfloat162float(a));
          }
        }
      }
    }
  }
  const bool ints = STAGE == kBytes || STAGE == kNibbles;
  float* dst = splits == 1 ? out : part + (size_t)blockIdx.z * J * C;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    dst[(size_t)j * C + (size_t)w * NC + c] = ints ? (float)iacc[c] : facc[c];
  }
}

// The dma stage: every kStageRows x 512-byte tile of this block's rows goes
// to shared memory through cp.async, double-buffered (the next tile's copies
// are in flight while the block waits for the current one); the block that
// holds the target row writes it from shared memory.
__global__ void __launch_bounds__(kThreads)
probe_dma(const uint8_t* __restrict__ packed, float* __restrict__ out, int L, int J, int R,
          int C, int rows_per_split, int target) {
  __shared__ __align__(16) uint8_t tile[2][kStageRows][kTileBytes];
  const int x0 = blockIdx.x * kTileBytes;
  const int j = blockIdx.y;
  const int total = L * R;
  const int g0 = blockIdx.z * rows_per_split;
  const int g1 = min(total, g0 + rows_per_split);
  const int chunks = min(kTileBytes, C - x0) / 16;  // 16-byte chunks per row
  const int n_stages = (g1 - g0 + kStageRows - 1) / kStageRows;

  auto issue = [&](int st) {
    uint8_t(*buf)[kTileBytes] = tile[st & 1];
    for (int idx = threadIdx.x; idx < kStageRows * (kTileBytes / 16); idx += kThreads) {
      const int row = idx / (kTileBytes / 16);
      const int ch = idx % (kTileBytes / 16);
      const int g = g0 + st * kStageRows + row;
      if (g < g1 && ch < chunks) {
        const size_t plane = (size_t)(g / R) * J + j;
        cp_async16(&buf[row][ch * 16], packed + (plane * R + g % R) * C + x0 + ch * 16);
      }
    }
    cp_async_commit();
  };

  if (n_stages > 0) issue(0);
  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) {
      issue(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int first = g0 + st * kStageRows;
    if (target >= first && target < min(g1, first + kStageRows)) {
      const uint8_t* row = tile[st & 1][target - first];
      for (int c = threadIdx.x; c < chunks * 16; c += kThreads) {
        out[(size_t)j * C + x0 + c] = (float)row[c];
      }
    }
    __syncthreads();  // the next issue reuses this buffer
  }
}

template <int STAGE, bool U32>
void launch_reduce(dim3 grid, cudaStream_t s, const uint32_t* w, const __half* sc, float* part,
                   float* out, int L, int J, int R, int Cw, int splits, int rows_per_split) {
  probe_reduce<STAGE, U32><<<grid, kThreads, 0, s>>>(w, sc, part, out, L, J, R, Cw, splits,
                                                     rows_per_split);
}

}  // namespace

// Launches one probe pass on `stream`. packed: [L][J][R][Cw] 32-bit words
// (u32 = 0: each word is 4 byte columns; u32 = 1: one column); scales
// (scale stage only): f16 [L][J][R/16][4*Cw]; out: f32 [J][Cw*(u32 ? 1 : 4)];
// part: f32 [splits][same] when splits > 1. dma: tile_row is the row of
// plane L-1 to write. Returns cudaGetLastError() as an int, 0 on success.
extern "C" int q40_probe_launch(const void* packed, const void* scales, float* out, float* part,
                                int stage, int u32, int L, int J, int R, int Cw, int splits,
                                int rows_per_split, int tile_row, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(packed);
  const __half* sc = reinterpret_cast<const __half*>(scales);
  if (stage == kDma) {
    if (u32) return (int)cudaErrorInvalidValue;
    const int C = Cw * kCols;
    const dim3 grid((C + kTileBytes - 1) / kTileBytes, J, splits);
    probe_dma<<<grid, kThreads, 0, s>>>(reinterpret_cast<const uint8_t*>(packed), out, L, J, R,
                                         C, rows_per_split, (L - 1) * R + tile_row);
    return (int)cudaGetLastError();
  }
  const dim3 grid((Cw + kThreads - 1) / kThreads, J, splits);
  if (u32) {
    switch (stage) {
      case kNibbles:
        launch_reduce<kNibbles, true>(grid, s, w, sc, part, out, L, J, R, Cw, splits,
                                      rows_per_split);
        break;
      case kConvF32:
        launch_reduce<kConvF32, true>(grid, s, w, sc, part, out, L, J, R, Cw, splits,
                                      rows_per_split);
        break;
      case kConvBf16:
        launch_reduce<kConvBf16, true>(grid, s, w, sc, part, out, L, J, R, Cw, splits,
                                       rows_per_split);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (stage) {
      case kBytes:
        launch_reduce<kBytes, false>(grid, s, w, sc, part, out, L, J, R, Cw, splits,
                                     rows_per_split);
        break;
      case kNibbles:
        launch_reduce<kNibbles, false>(grid, s, w, sc, part, out, L, J, R, Cw, splits,
                                       rows_per_split);
        break;
      case kConvF32:
        launch_reduce<kConvF32, false>(grid, s, w, sc, part, out, L, J, R, Cw, splits,
                                       rows_per_split);
        break;
      case kConvBf16:
        launch_reduce<kConvBf16, false>(grid, s, w, sc, part, out, L, J, R, Cw, splits,
                                        rows_per_split);
        break;
      case kScale:
        launch_reduce<kScale, false>(grid, s, w, sc, part, out, L, J, R, Cw, splits,
                                     rows_per_split);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  const int cols = Cw * (u32 ? 1 : kCols);
  return finish(part, out, 0, splits, (size_t)J * cols, s);
}
