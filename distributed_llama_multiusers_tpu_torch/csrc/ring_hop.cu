// Ring hop: one tensor-parallel rank's copy of its left neighbour's buffer.
//
// Replaces: distributed_llama_multiusers_tpu/ops/ring_collective.py:130,
// _rdma_shift — a pl.pallas_call whose kernel starts one
// make_async_remote_copy to the right neighbour and waits on its send and
// receive DMA semaphores. Every hop of every ring collective (the wo/w2
// reduce-scatter and all-gather, the Q80 wire's two chains, the logits
// gather) is one launch of this kernel per receiving rank.
//
// What it computes: dst[i] = src[i] for nbytes bytes. It is a pull: the
// kernel runs on the RECEIVER's device and stream, and src may point into
// another card's memory (unified addressing with peer access enabled by
// ring_hop_enable_peer), read over NVLink. The TPU kernel's DMA semaphores
// become stream order: the sender records an event after the work that
// produced src and the receiver's stream waits on it before the launch
// (ops/ring_collective.py). Where every rank shares one card and one stream,
// that order holds by itself. The Q80 wire's two hop chains (values and
// scales, collective_id 0 and 1 on the TPU) are ordered on that one stream
// too: each launch here is short, and a second stream per channel would add
// an event pair per hop for no overlap worth having at these sizes.
//
// What bounds it on an H100: bytes. On one card the copy reads and writes
// device memory, 2 * nbytes at 3.35 TB/s; across cards it is nbytes at
// 450 GB/s each way over NVLink. At decode sizes (an 8-lane f32 ring chunk
// is 16-32 KB, a Q80 chunk a quarter of that) the byte bound is 10-20 ns,
// far under a kernel launch, so launch latency sets the time; fusing the hops of
// one collective into one launch is later work. The copy moves 16 bytes a
// thread (uint4) where both ends are 16-byte aligned, neighbouring threads
// on neighbouring addresses, with a byte tail; otherwise it copies bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// two blocks per SM of an H100 (132 SMs); larger copies stride over them
constexpr long long kMaxBlocks = 264;

__global__ void __launch_bounds__(kThreads)
hop_vec16(const uint4* __restrict__ src, uint4* __restrict__ dst, long long n16,
          const uint8_t* __restrict__ src_tail, uint8_t* __restrict__ dst_tail, int tail) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n16; i += stride) {
    dst[i] = src[i];
  }
  if (blockIdx.x == 0 && threadIdx.x < tail) dst_tail[threadIdx.x] = src_tail[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
hop_bytes(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, long long n) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    dst[i] = src[i];
  }
}

int blocks_for(long long items) {
  long long b = (items + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

}  // namespace

// Copies nbytes from src to dst on `stream` (the receiver's); returns
// cudaGetLastError() as an int, 0 on success.
extern "C" int ring_hop_launch(const void* src, void* dst, long long nbytes, void* stream) {
  if (nbytes <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* sb = reinterpret_cast<const uint8_t*>(src);
  uint8_t* db = reinterpret_cast<uint8_t*>(dst);
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const long long n16 = nbytes / 16;
    const int tail = (int)(nbytes % 16);
    hop_vec16<<<blocks_for(n16), kThreads, 0, s>>>(
        reinterpret_cast<const uint4*>(src), reinterpret_cast<uint4*>(dst), n16,
        sb + n16 * 16, db + n16 * 16, tail);
  } else {
    hop_bytes<<<blocks_for(nbytes), kThreads, 0, s>>>(sb, db, nbytes);
  }
  return (int)cudaGetLastError();
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
