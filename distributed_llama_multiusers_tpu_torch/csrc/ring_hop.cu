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
//
// Across processes (a pod: parallel/multihost.py, parallel/window.py) the
// sender's tensor is not in the receiver's address space. Each rank then
// owns one window, a device allocation made at startup and exported with
// cudaIpcGetMemHandle; every other process of the host opens it
// (ring_window_open). A sender stages a step's sources in a slot of its own
// window (this kernel, a copy segment) and the receiver's launch pulls from
// that slot through the opened pointer: the same kernel, whatever address
// the source has. The DMA semaphores become 32-bit epoch words in the
// windows, written and waited on by stream memory operations
// (cuStreamWriteValue32 / cuStreamWaitValue32, which hold no SM while they
// wait): the sender writes "slot s holds epoch e" into the receiver's window
// after the staging copy, the receiver's stream waits for it before the
// pull and then writes "consumed e" into the sender's window, and the
// sender waits for that before it stages into the slot again.
//
// Across hosts (parallel/window.py, SocketWindows) no process maps another's
// memory. Each end of a ring link then owns a buffer of pinned host memory
// mapped into the card (ring_host_alloc): the sender's staging launch writes
// the slot there, the receiver's pull launch reads its received copy from
// there, and the epoch words live there too, written and waited on by the
// same stream memory operations. A transport thread on each end moves the
// slot over a TCP socket between the two buffers; it polls the words the
// streams write with ring_host_wait, which spins on the host without the
// Python lock.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <sched.h>
#include <stdint.h>
#include <string.h>
#include <time.h>

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

// ---------------------------------------------------------------------------
// Windows across processes
// ---------------------------------------------------------------------------

namespace {

// Runs `fn` with `device` current and puts the thread's device back.
template <typename F>
cudaError_t on_device(int device, F fn) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return e;
  e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  e = fn();
  const cudaError_t back = cudaSetDevice(prev);
  return e != cudaSuccess ? e : back;
}

// The driver's stream memory operations, looked up in libcuda at first use
// (no link against the driver library: the build needs only the toolkit).
typedef CUresult (*StreamValueFn)(CUstream, CUdeviceptr, cuuint32_t, unsigned int);
StreamValueFn g_wait_value = nullptr;
StreamValueFn g_write_value = nullptr;

StreamValueFn driver_symbol(void* lib, const char* v2, const char* v1) {
  void* f = dlsym(lib, v2);
  return reinterpret_cast<StreamValueFn>(f != nullptr ? f : dlsym(lib, v1));
}

int load_stream_ops() {
  if (g_wait_value != nullptr && g_write_value != nullptr) return 0;
  void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
  if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
  if (lib == nullptr) return (int)cudaErrorSharedObjectInitFailed;
  g_wait_value = driver_symbol(lib, "cuStreamWaitValue32_v2", "cuStreamWaitValue32");
  g_write_value = driver_symbol(lib, "cuStreamWriteValue32_v2", "cuStreamWriteValue32");
  return g_wait_value != nullptr && g_write_value != nullptr
             ? 0
             : (int)cudaErrorSymbolNotFound;
}

}  // namespace

// Allocates `bytes` of zeroed device memory on `device` for a rank's window
// and writes its 64-byte IPC handle to `handle`. Returns the CUDA error.
extern "C" int ring_window_alloc(int device, long long bytes, void** ptr, void* handle) {
  if (ptr == nullptr || handle == nullptr || bytes <= 0) return (int)cudaErrorInvalidValue;
  *ptr = nullptr;
  return (int)on_device(device, [&]() {
    cudaError_t e = cudaMalloc(ptr, (size_t)bytes);
    if (e != cudaSuccess) return e;
    e = cudaMemset(*ptr, 0, (size_t)bytes);
    if (e != cudaSuccess) return e;
    cudaIpcMemHandle_t h;
    e = cudaIpcGetMemHandle(&h, *ptr);
    if (e == cudaSuccess) memcpy(handle, &h, sizeof(h));
    return e;
  });
}

// Opens another process's window (its 64-byte handle) on `device`; peer
// access is enabled lazily where the window lives on another card.
extern "C" int ring_window_open(int device, const void* handle, void** ptr) {
  if (ptr == nullptr || handle == nullptr) return (int)cudaErrorInvalidValue;
  *ptr = nullptr;
  return (int)on_device(device, [&]() {
    cudaIpcMemHandle_t h;
    memcpy(&h, handle, sizeof(h));
    return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  });
}

// Closes a window opened with ring_window_open, or frees one's own.
extern "C" int ring_window_release(int device, void* ptr, int own) {
  return (int)on_device(device, [&]() { return own ? cudaFree(ptr) : cudaIpcCloseMemHandle(ptr); });
}

// Copies `n` 32-bit words from host memory into a window (its epoch words'
// first values) and waits for the copy.
extern "C" int ring_window_put(int device, void* dst, const unsigned int* src, int n) {
  return (int)on_device(device, [&]() {
    return cudaMemcpy(dst, src, sizeof(unsigned int) * (size_t)n, cudaMemcpyHostToDevice);
  });
}

// Enqueues on `stream` a wait until the 32-bit word at `addr` (device
// memory of this process's window) equals `value`; later work on the
// stream starts after it. Holds no SM while it waits.
extern "C" int ring_wait_value(void* stream, void* addr, unsigned int value) {
  const int e = load_stream_ops();
  if (e != 0) return e;
  return (int)g_wait_value(reinterpret_cast<CUstream>(stream),
                           reinterpret_cast<CUdeviceptr>(addr), value, CU_STREAM_WAIT_VALUE_EQ);
}

// Enqueues on `stream` a wait until the 32-bit word at `addr` has reached
// `value`, cyclically ((int32_t)(word - value) >= 0): a count another process
// may have passed already (the KV pool's page-write counts). Holds no SM.
extern "C" int ring_wait_value_geq(void* stream, void* addr, unsigned int value) {
  const int e = load_stream_ops();
  if (e != 0) return e;
  return (int)g_wait_value(reinterpret_cast<CUstream>(stream),
                           reinterpret_cast<CUdeviceptr>(addr), value, CU_STREAM_WAIT_VALUE_GEQ);
}

// Enqueues on `stream` a write of `value` to the 32-bit word at `addr` (a
// window, possibly another process's), after a memory barrier: the work
// before it on the stream is visible wherever the word is seen.
extern "C" int ring_write_value(void* stream, void* addr, unsigned int value) {
  const int e = load_stream_ops();
  if (e != 0) return e;
  return (int)g_write_value(reinterpret_cast<CUstream>(stream),
                            reinterpret_cast<CUdeviceptr>(addr), value,
                            CU_STREAM_WRITE_VALUE_DEFAULT);
}

// Allocates `bytes` of zeroed pinned host memory, mapped into the address
// space of every device (portable): a socket link's buffer. *host is its
// host address, *dev the address kernels and stream memory operations on
// `device` use for it. Returns the CUDA error.
extern "C" int ring_host_alloc(int device, long long bytes, void** host, void** dev) {
  if (host == nullptr || dev == nullptr || bytes <= 0) return (int)cudaErrorInvalidValue;
  *host = nullptr;
  *dev = nullptr;
  return (int)on_device(device, [&]() {
    cudaError_t e =
        cudaHostAlloc(host, (size_t)bytes, cudaHostAllocMapped | cudaHostAllocPortable);
    if (e != cudaSuccess) return e;
    memset(*host, 0, (size_t)bytes);
    return cudaHostGetDevicePointer(dev, *host, 0);
  });
}

// Frees a buffer of ring_host_alloc.
extern "C" int ring_host_free(void* host) { return (int)cudaFreeHost(host); }

// Waits on the calling host thread until the 32-bit word at `addr` (host
// memory a stream writes) equals `value`: spins a few microseconds, yields
// the core up to 50 us, then sleeps 20 us at a time, so a wait behind a long
// step leaves the host's cores to the pod's other threads and processes.
// Returns 0 once it does, 1 after about `timeout_us` microseconds. Called
// through ctypes, which releases the Python lock, so the waiting transport
// thread holds up no other thread of the process.
extern "C" int ring_host_wait(const volatile unsigned int* addr, unsigned int value,
                              long long timeout_us) {
  for (int i = 0; i < 4096; ++i) {
    if (*addr == value) return 0;
  }
  timespec t0, now;
  clock_gettime(CLOCK_MONOTONIC, &t0);
  const timespec nap = {0, 20000};
  while (*addr != value) {
    clock_gettime(CLOCK_MONOTONIC, &now);
    const long long us = (now.tv_sec - t0.tv_sec) * 1000000LL + (now.tv_nsec - t0.tv_nsec) / 1000;
    if (us >= timeout_us) return 1;
    if (us < 50) {
      sched_yield();
    } else {
      nanosleep(&nap, nullptr);
    }
  }
  return 0;
}
