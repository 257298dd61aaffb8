// Ring step: everything one tensor-parallel rank receives in one step of a
// ring collective, in one launch, with the step's add and gather inside it.
//
// Replaces: distributed_llama_multiusers_tpu/ops/ring_collective.py:130,
// _rdma_shift — a pl.pallas_call whose kernel starts one
// make_async_remote_copy to the right neighbour and waits on its send and
// receive DMA semaphores — together with what the reference leaves to XLA
// around each hop: the accumulate after a reduce hop and the concatenate of
// the gather's arrivals, which XLA fuses into the collective's consumer.
//
// What it computes: up to two segments (HopStep), each a block of rows.
// A row of a segment is row_bytes bytes; row i of the source starts at
// src + i * src_pitch, of the destination at dst + i * dst_pitch, so a
// chunk lands straight in its column slot of a [..., n * C] gather output,
// and a reduce chunk can be read straight out of a full-width partial.
//   copy            dst = src                       (any dtype, bytes)
//   f32 + f32       dst = src + add                 (f32 out)
//   f32 + bf16      dst = src + float(add)          (f32 out; bf16 widened exactly)
//   bf16 + bf16     dst = bf16(float(src) + float(add))   (rounded once)
// The received operand is the left one of the add, and each add is one f32
// add rounded to the destination's dtype once, as torch's own `+` does, so
// the results are bit-identical to a hop followed by that add. The Q80
// wire's values and scales are the two segments of one step; a gather's
// local chunk can ride the first step as its second segment.
//
// It is a pull: the kernel runs on the RECEIVER's device and stream, and a
// source may point into another card's memory (unified addressing with
// peer access enabled by ring_hop_enable_peer), read over NVLink. The TPU
// kernel's DMA semaphores become stream order: the sender records an event
// after the work that produced the source and the receiver's stream waits
// on it before the launch (ops/ring_collective.py). Where every rank shares
// one card and one stream, that order holds by itself.
//
// What bounds it on an H100: bytes, but at decode sizes launches. One card
// reads and writes device memory; across cards the source crosses NVLink
// (450 GB/s each way). An 8-lane f32 ring chunk is 16-32 KB, a byte bound
// of 10-20 ns, far under a launch, so the design cuts launches and what
// each costs:
// - one launch per receiving rank per ring step, the add and the gather
//   slot inside it, where each hop used to be one launch followed by an
//   add, a cast or a concatenate;
// - the common one-segment step runs a kernel whose kind, vector path and
//   row count are template parameters and whose geometry comes as scalars:
//   no dispatch before its loads; two segments take one generic kernel,
//   blockIdx.z picking the segment;
// - a grid of at most kPdlMaxBlocks blocks is launched as a programmatic
//   dependent (PDL): it may start launching while the kernel before it
//   runs, and waits in griddepcontrol.wait before touching memory;
// - 128-thread blocks move 16-byte units along a row (elements, where a
//   pointer or pitch forbids 16-byte vectors), blockIdx.y the row, with
//   32-bit index math and one 64-bit row offset per row: one unit a thread,
//   or, where that grid would be too large to launch as a dependent, four,
//   all loaded before any is stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVecUnits = 4;  // 16-byte units a thread moves per pass
// blocks along a row: one wave of 128-thread blocks on an H100 (16 per SM,
// 132 SMs); longer rows stride over them
constexpr long long kMaxBlocksX = 2112;
constexpr long long kMaxBlocksY = 65535;  // the grid's y limit; more rows stride
// grids of at most this many blocks (two per SM) are launched as
// programmatic dependents; on the card a 1026-block copy grid ran slower so
constexpr long long kPdlMaxBlocks = 264;
// Built with RING_HOP_ONE_KERNEL, every step runs the two-segment kernel
// with one 16-byte unit a thread: the simpler design chip_smoke.py times
// this one against, form by form, in the same run.
#ifdef RING_HOP_ONE_KERNEL
constexpr bool kOneKernel = true;
#else
constexpr bool kOneKernel = false;
#endif

enum Kind { kCopy = 0, kAddF32 = 1, kAddF32Bf16 = 2, kAddBf16 = 3 };

}  // namespace

// Layout shared with ops/ring_collective.py (_HopSeg, _HopStep).
struct HopSeg {
  const void* src;
  const void* add;  // the receiver's addend (kind != kCopy), else null
  void* dst;
  long long src_pitch;  // bytes from one row to the next
  long long add_pitch;
  long long dst_pitch;
  long long row_bytes;  // bytes of one source (= destination) row
  int rows;
  int kind;
  int per;  // set by the launcher: 16-byte units a thread moves per pass (0: elements)
};

struct HopStep {
  HopSeg seg[2];
  int nseg;
};

namespace {

__device__ __forceinline__ float bf16_bits_to_float(uint32_t h) {
  return __uint_as_float(h << 16);
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const float lo = bf16_bits_to_float(a & 0xFFFFu) + bf16_bits_to_float(b & 0xFFFFu);
  const float hi = bf16_bits_to_float(a >> 16) + bf16_bits_to_float(b >> 16);
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// One element of a row (the path for pointers or pitches that do not allow
// 16-byte vectors).
template <int KIND>
__device__ __forceinline__ void move_unit(const char* __restrict__ src,
                                          const char* __restrict__ add,
                                          char* __restrict__ dst, int u) {
  if constexpr (KIND == kCopy) {
    dst[u] = src[u];
  } else if constexpr (KIND == kAddF32) {
    reinterpret_cast<float*>(dst)[u] =
        reinterpret_cast<const float*>(src)[u] + reinterpret_cast<const float*>(add)[u];
  } else if constexpr (KIND == kAddF32Bf16) {
    reinterpret_cast<float*>(dst)[u] =
        reinterpret_cast<const float*>(src)[u] +
        bf16_bits_to_float(reinterpret_cast<const uint16_t*>(add)[u]);
  } else {
    const float v = bf16_bits_to_float(reinterpret_cast<const uint16_t*>(src)[u]) +
                    bf16_bits_to_float(reinterpret_cast<const uint16_t*>(add)[u]);
    reinterpret_cast<uint16_t*>(dst)[u] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
}

__host__ __device__ __forceinline__ int elem_bytes(int kind) {
  return kind == kCopy ? 1 : (kind == kAddBf16 ? 2 : 4);
}

// the alignment the vector path needs of an addend: 8 bf16 bytes per 16
// destination bytes for f32 + bf16, else 16
__host__ __device__ __forceinline__ int add_vec_align(int kind) {
  return kind == kAddF32Bf16 ? 8 : 16;
}

// The vector path: kPer 16-byte units a thread per pass, all loaded before
// any is stored, so that they are in flight together.
template <int KIND>
__device__ __forceinline__ uint4 load_add(const char* __restrict__ add, int u) {
  if constexpr (KIND == kAddF32Bf16) {
    const uint2 y = reinterpret_cast<const uint2*>(add)[u];
    return make_uint4(y.x, y.y, 0u, 0u);
  } else {
    return reinterpret_cast<const uint4*>(add)[u];
  }
}

template <int KIND>
__device__ __forceinline__ uint4 combine(uint4 a, uint4 y) {
  if constexpr (KIND == kAddF32) {
    const float4 x = *reinterpret_cast<const float4*>(&a);
    const float4 z = *reinterpret_cast<const float4*>(&y);
    const float4 r = make_float4(x.x + z.x, x.y + z.y, x.z + z.z, x.w + z.w);
    return *reinterpret_cast<const uint4*>(&r);
  } else if constexpr (KIND == kAddF32Bf16) {
    const float4 x = *reinterpret_cast<const float4*>(&a);
    const float4 r = make_float4(x.x + bf16_bits_to_float(y.x & 0xFFFFu),
                                 x.y + bf16_bits_to_float(y.x >> 16),
                                 x.z + bf16_bits_to_float(y.y & 0xFFFFu),
                                 x.w + bf16_bits_to_float(y.y >> 16));
    return *reinterpret_cast<const uint4*>(&r);
  } else {
    return make_uint4(add_bf16x2(a.x, y.x), add_bf16x2(a.y, y.y), add_bf16x2(a.z, y.z),
                      add_bf16x2(a.w, y.w));
  }
}

template <int KIND, int kPer>
__device__ __forceinline__ void move_vec_units(const char* __restrict__ src,
                                               const char* __restrict__ add,
                                               char* __restrict__ dst, int u0, int units) {
  uint4 a[kPer];
  uint4 y[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int u = u0 + j * kThreads;
    if (u < units) {
      a[j] = reinterpret_cast<const uint4*>(src)[u];
      if constexpr (KIND != kCopy) y[j] = load_add<KIND>(add, u);
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int u = u0 + j * kThreads;
    if (u >= units) continue;
    if constexpr (KIND == kCopy) {
      reinterpret_cast<uint4*>(dst)[u] = a[j];
    } else {
      reinterpret_cast<uint4*>(dst)[u] = combine<KIND>(a[j], y[j]);
    }
  }
}

// Units a thread moves per pass: kPer 16-byte units (1 or kVecUnits), or
// one element (kPer = 0).
__host__ __device__ constexpr int thread_units(int per) { return per == 0 ? 1 : per; }

// Moves one segment's rows: a thread takes thread_units(kPer) units of a
// row kThreads apart, block rows striding over gridDim.y. kOneRow drops
// the row loop and its pitches (a contiguous segment is one row).
template <int KIND, int kPer, bool kOneRow>
__device__ __forceinline__ void move_rows(const char* __restrict__ src,
                                          const char* __restrict__ add,
                                          char* __restrict__ dst, long long src_pitch,
                                          long long add_pitch, long long dst_pitch, int units,
                                          int rows) {
  constexpr int kBlockUnits = kThreads * thread_units(kPer);
  const int first = blockIdx.x * kBlockUnits + threadIdx.x;
  const int stride = gridDim.x * kBlockUnits;
  if (first >= units) return;
  for (int row = blockIdx.y; row < (kOneRow ? 1 : rows); row += gridDim.y) {
    const char* s = kOneRow ? src : src + (long long)row * src_pitch;
    const char* a = KIND == kCopy || kOneRow ? add : add + (long long)row * add_pitch;
    char* d = kOneRow ? dst : dst + (long long)row * dst_pitch;
    for (int u = first; u < units; u += stride) {
      if constexpr (kPer > 0) {
        move_vec_units<KIND, kPer>(s, a, d, u, units);
      } else {
        move_unit<KIND>(s, a, d, u);
      }
    }
  }
}

__host__ __device__ __forceinline__ int seg_units(const HopSeg& s) {
  return (int)(s.per > 0 ? s.row_bytes / 16 : s.row_bytes / elem_bytes(s.kind));
}

template <int kPer>
__device__ __forceinline__ void move_kind(const HopSeg& s) {
  const char* src = reinterpret_cast<const char*>(s.src);
  const char* add = reinterpret_cast<const char*>(s.add);
  char* dst = reinterpret_cast<char*>(s.dst);
  const int units = seg_units(s);
  switch (s.kind) {
    case kCopy:
      move_rows<kCopy, kPer, false>(src, add, dst, s.src_pitch, s.add_pitch, s.dst_pitch, units,
                                    s.rows);
      break;
    case kAddF32:
      move_rows<kAddF32, kPer, false>(src, add, dst, s.src_pitch, s.add_pitch, s.dst_pitch,
                                      units, s.rows);
      break;
    case kAddF32Bf16:
      move_rows<kAddF32Bf16, kPer, false>(src, add, dst, s.src_pitch, s.add_pitch, s.dst_pitch,
                                          units, s.rows);
      break;
    default:
      move_rows<kAddBf16, kPer, false>(src, add, dst, s.src_pitch, s.add_pitch, s.dst_pitch,
                                       units, s.rows);
      break;
  }
}

__device__ __forceinline__ void move_seg(const HopSeg& s) {
  switch (s.per) {
    case 0: move_kind<0>(s); break;
    case 1: move_kind<1>(s); break;
    default: move_kind<kVecUnits>(s); break;
  }
}

// Programmatic dependent launch: wait until the grids this one depends on
// have finished and their writes are visible (at once where it was
// launched the ordinary way), then let the next kernel on the stream start
// launching while this one runs. Nothing is read or written before the wait.
__device__ __forceinline__ void pdl_enter() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" :::);
}

// One segment, its kind, path and row count fixed at compile time and its
// geometry passed as scalars: the common step (a hop, a reduce hop with its
// add, a gather hop into its slot) runs no dispatch before its loads.
template <int KIND, int kPer, bool kOneRow>
__global__ void __launch_bounds__(kThreads)
ring_seg_kernel(const char* __restrict__ src, const char* __restrict__ add,
                char* __restrict__ dst, long long src_pitch, long long add_pitch,
                long long dst_pitch, int units, int rows) {
  pdl_enter();
  move_rows<KIND, kPer, kOneRow>(src, add, dst, src_pitch, add_pitch, dst_pitch, units, rows);
}

// Two segments (the Q80 wire's values and scales; a gather hop and the
// rank's own chunk): blockIdx.z picks one. Each branch reads its own
// parameter at fixed offsets (no indexing into the parameters, which would
// copy them to local memory).
__global__ void __launch_bounds__(kThreads) ring_step2_kernel(const HopSeg s0, const HopSeg s1) {
  pdl_enter();
  if (blockIdx.z == 0) {
    move_seg(s0);
  } else {
    move_seg(s1);
  }
}

template <int KIND, int kPer, bool kOneRow>
cudaError_t launch_seg(const cudaLaunchConfig_t& cfg, const HopSeg& s) {
  return cudaLaunchKernelEx(&cfg, ring_seg_kernel<KIND, kPer, kOneRow>,
                            reinterpret_cast<const char*>(s.src),
                            reinterpret_cast<const char*>(s.add), reinterpret_cast<char*>(s.dst),
                            s.src_pitch, s.add_pitch, s.dst_pitch, seg_units(s), s.rows);
}

template <int KIND, int kPer>
cudaError_t launch_rows(const cudaLaunchConfig_t& cfg, const HopSeg& s) {
  return s.rows == 1 ? launch_seg<KIND, kPer, true>(cfg, s) : launch_seg<KIND, kPer, false>(cfg, s);
}

template <int KIND>
cudaError_t launch_kind(const cudaLaunchConfig_t& cfg, const HopSeg& s) {
  switch (s.per) {
    case 0: return launch_rows<KIND, 0>(cfg, s);
    case 1: return launch_rows<KIND, 1>(cfg, s);
    default: return launch_rows<KIND, kVecUnits>(cfg, s);
  }
}

cudaError_t launch_one(const cudaLaunchConfig_t& cfg, const HopSeg& s) {
  switch (s.kind) {
    case kCopy: return launch_kind<kCopy>(cfg, s);
    case kAddF32: return launch_kind<kAddF32>(cfg, s);
    case kAddF32Bf16: return launch_kind<kAddF32Bf16>(cfg, s);
    default: return launch_kind<kAddBf16>(cfg, s);
  }
}

bool aligned(const void* p, long long pitch, int rows, int a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0 && (rows == 1 || pitch % a == 0);
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// Launches one ring step's segments on `stream` (the receiver's); returns
// cudaGetLastError() as an int, 0 on success, or cudaErrorInvalidValue for
// a descriptor the kernel does not take.
extern "C" int ring_hop_launch(const HopStep* step, void* stream) {
  if (step == nullptr || step->nseg < 1 || step->nseg > 2) return (int)cudaErrorInvalidValue;
  HopSeg seg[2] = {};
  long long gx = 1, gy = 1;
  for (int i = 0; i < step->nseg; ++i) {
    HopSeg& s = seg[i];
    s = step->seg[i];
    if (s.rows <= 0 || s.row_bytes <= 0 || s.kind < kCopy || s.kind > kAddBf16 ||
        s.src == nullptr || s.dst == nullptr || (s.kind != kCopy && s.add == nullptr) ||
        s.row_bytes % elem_bytes(s.kind) != 0 || s.row_bytes / elem_bytes(s.kind) > INT32_MAX) {
      return (int)cudaErrorInvalidValue;
    }
    const bool vec =
        s.row_bytes % 16 == 0 && aligned(s.src, s.src_pitch, s.rows, 16) &&
        aligned(s.dst, s.dst_pitch, s.rows, 16) &&
        (s.kind == kCopy || aligned(s.add, s.add_pitch, s.rows, add_vec_align(s.kind)));
    // one 16-byte unit a thread, unless that grid would be too large to
    // launch as a dependent: then kVecUnits a thread
    const bool wide =
        !kOneKernel && ceil_div(s.row_bytes / 16, kThreads) * s.rows > kPdlMaxBlocks;
    s.per = !vec ? 0 : (wide ? kVecUnits : 1);
    const long long per_block = kThreads * thread_units(s.per);
    gx = gx > ceil_div(seg_units(s), per_block) ? gx : ceil_div(seg_units(s), per_block);
    gy = gy > s.rows ? gy : s.rows;
  }
  gx = gx < kMaxBlocksX ? gx : kMaxBlocksX;
  gy = gy < kMaxBlocksY ? gy : kMaxBlocksY;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)gx, (unsigned)gy, (unsigned)step->nseg);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  // a small grid launches early, its blocks waiting in pdl_enter; a large
  // one would hold the SMs' block slots the running grid still needs
  if (gx * gy * step->nseg <= kPdlMaxBlocks) {
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t err = step->nseg == 1 && !kOneKernel
                              ? launch_one(cfg, seg[0])
                              : cudaLaunchKernelEx(&cfg, ring_step2_kernel, seg[0], seg[1]);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Lets kernels running on `device` read `peer`'s memory (idempotent);
// returns cudaErrorPeerAccessUnsupported where the pair cannot, else the
// CUDA error as an int. Leaves the thread's current device as it found it.
extern "C" int ring_hop_enable_peer(int device, int peer) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  int can = 0;
  e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // not a fault: clear it so the next launch check is clean
    e = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(prev);
  return (int)(e != cudaSuccess ? e : back);
}
