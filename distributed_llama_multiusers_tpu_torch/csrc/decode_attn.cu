// Decode attention on Hopper: one query per lane (a decode step) or a window
// of up to kWindow query rows per lane (a speculative verify step), grouped
// query heads; row t of a lane attends its own cache slots
// 0 .. min(pos[t], s_len - 1).
//
// Replaces: no Pallas kernel. The JAX package computes this in XLA inside its
// compiled decode step (distributed_llama_multiusers_tpu/models/llama.py,
// the masked softmax attention over the whole cache). The port needs a kernel
// for two reasons. Written as PyTorch ops, attention over the whole cache
// casts and permutes every slot of every lane on every layer (about 5 ms of
// an 8 ms decode step of the 1B shape at seq_len 2048). Bounding the slots by
// a shared attention length instead makes a lane's bits depend on the other
// lanes' positions, since the library's reductions change with the length.
// Here a lane's result depends only on its own query, position and slots:
// the slots it reads and the order it sums them in are fixed by its position.
//
// Bound: one read of the slots the lanes attend (K and V) plus q and the
// output; the dots and the softmax are a few f32 operations per element.
// In practice the instructions per slot and the chain of a split's block
// (loads, scores, softmax, weighted V, fold) bound it.
//
// Design. A lane's slots are cut into splits of kSplit slots, split j
// covering [j kSplit, (j + 1) kSplit); the grid is (kv head, lane, split), so
// a lane that attends the whole cache (a parked lane) spreads over
// ceil(s_len / kSplit) thread blocks across the card, and blocks past a
// lane's last split return at once. In a block, warp w takes the split's
// kWarpSlots slots from w kWarpSlots; a slot's head is spread over TPS
// threads that each load 16 bytes of K and of V (8 bf16 dims), so one load
// instruction of a warp covers 32 / TPS slots, kU of them issued together.
// The G query-head dots of a thread's slots are summed over each slot's TPS
// threads by a reduce-scatter (each level halves what a thread keeps), so
// each (slot, head) score is formed and stored once, in shared memory. The
// split's softmax then takes one slot per thread: the block's max per head
// (max is exact in any order), one expf (never __expf) per (slot, head), and
// the sum of the weights (a warp butterfly, then the warps in order). Each
// thread weights the V it loaded (issued while the scores were formed), and
// the slot groups' sums add in group order through shared memory. A lane
// with one split writes its output there; otherwise each block stores its
// partial state (max, sum, weighted V) and takes an arrival ticket after a
// fence, and the last block of the (lane, kv head) folds the partials in
// split order 0, 1, 2, ... Every choice above is a function of slot indices
// and the lane's position, so a lane's bits never depend on the batch, the
// other lanes or s_len past its position. The tickets and partials are
// per-call scratch from the wrapper.
//
// The window (T > 1 rows a lane, the verify step; the JAX package runs its
// dense attention there, models/llama.py _dense_attention) runs the same
// kernel with a row a lane: the grid is (kv head, row, split) over the B x T
// rows, row r reading cache lane r / T at its own position, so row t gives
// the bits of a T = 1 call at pos[t] by construction. A row's blocks read
// the lane's slots for themselves (the rows after the first mostly from
// L2). Staging a split's slots once for all of a lane's rows in one block
// was measured slower: the block ran the rows' chains one after another.
//
// The paged form (the JAX package's paged layout, models/llama.py: a pool
// of fixed-size pages shared by every lane and a per-lane page table; JAX
// gathers each lane's [S] view through the table before its dense
// attention) reads the pool in place through the table: slot s of lane b
// lies at (table[b, s >> lp] << lp | (s & (page - 1))) * n_kv * hd. Only
// the slot-to-address map differs (Paged below): the split plan, the slots
// a thread takes and every sum's order are the contiguous kernel's, so a
// paged lane's bits equal the contiguous kernel's on the same contents.
// With pages of at least kWarpSlots slots (64 at the 1B shape) a warp's
// slots lie in one page, so a thread loads one table word a split; smaller
// pages (tiny configs) look up each slot.
//
// The e4m3 instantiation (--kv-dtype f8; the JAX package casts each K/V
// write to float8_e4m3fn and its attention reads the cache upcast to f32)
// loads 8 e4m3 values (8 bytes) where bf16 loads 8 bf16 (16 bytes) and
// widens them exactly (e4m3 -> f16 x2 -> f32, Hopper's cvt). Every thread
// then holds the same dims as in the bf16 instantiation and every sum keeps
// its order, so the e4m3 kernel's result equals the bf16 kernel's on the
// same cache widened to bf16 (every e4m3 value is a bf16 value), bit for
// bit. Sixteen e4m3 a thread would have halved the loads but doubled the
// slot groups' shared sums (64 KB at G = 8, past the static limit).
//
// The partial-stats form (a sequence-parallel rank, the JAX package's
// parallel/ring_attention.py sp_attention, whose _block_stats each sp shard
// computes over its block of the cache): with a stats pointer, each row also
// writes its softmax max m (of the scaled scores) and sum l beside its
// normalised output, from the one split's state or from the fold's, with
// every sum in the order above. The caller passes its block as the cache
// and positions shifted by the block's start, so a row whose block lies
// wholly past its position has no slot (n <= 0): split 0's block then
// writes the empty state (o = 0, l = 0, m = -inf), which weighs nothing in
// the ranks' combine. A null stats pointer is the kernel above, unchanged;
// the pointer is a runtime argument, not a template axis, so the form adds
// no instantiation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>
#include <string.h>
#include <math.h>

namespace {

constexpr int kSplit = 128;  // slots per split (ops/cuda_attn.py SPLIT)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;  // one thread per slot of the split in its softmax
constexpr int kWarpSlots = kSplit / kWarps;  // contiguous slots per warp
constexpr int kU = 4;  // slot loads a thread issues together
constexpr int kFoldChunk = 16;  // splits the fold loads at a time
constexpr int kWindow = 4;  // query rows per lane at most (ops/cuda_attn.py WINDOW)
// blocks per SM the light instantiations are held to (registers <= 96, so
// the serving step's 544 live blocks of the 1B shape run in one wave); the
// others would spill under it
constexpr int kMinBlocks = 5;

// one e4m3 cache element (the storage of torch.float8_e4m3fn)
struct E4M3 {
  uint8_t bits;
};

// the load unit of a cache element type: 16 bytes of bf16 or f32, 8 of e4m3
template <typename KV>
struct Vec {
  using raw = uint4;
  static constexpr int n = 16 / sizeof(KV);
};
template <>
struct Vec<E4M3> {
  using raw = uint2;
  static constexpr int n = 8;
};

// 8 bytes of the cache to f32: 8 e4m3 dims, exactly (byte i is dim i)
__device__ __forceinline__ void widen(const uint2& r, float (&x)[8]) {
  const uint32_t w[2] = {r.x, r.y};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __half2_raw p = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w[i] >> (16 * h)), __NV_E4M3);
      const float2 f = __half22float2(__half2(p));
      x[4 * i + 2 * h] = f.x;
      x[4 * i + 2 * h + 1] = f.y;
    }
}

// 16 bytes of the cache to f32: 8 bf16 or 4 f32 dims
__device__ __forceinline__ void widen(const uint4& r, float (&x)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(const uint4& r, float (&x)[4]) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}

// dims d0 .. d0 + VEC - 1 of one slot (zeros past hd, or for a slot the lane
// does not attend: a masked slot's V is weighted by 0 and must not be NaN)
template <typename KV>
__device__ __forceinline__ typename Vec<KV>::raw load16(const KV* p, bool vec_ok, int d0, int hd,
                                                        bool valid) {
  using Raw = typename Vec<KV>::raw;
  constexpr int VEC = Vec<KV>::n;
  Raw r;
  memset(&r, 0, sizeof(r));
  if (!valid || d0 >= hd) return r;
  if (vec_ok) return __ldg(reinterpret_cast<const Raw*>(p));
  KV e[VEC];
  memset(e, 0, sizeof(e));
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    if (d0 + i < hd) e[i] = p[i];
  memcpy(&r, e, sizeof(r));
  return r;
}

// slot s's offset (elements) from the (kv head, chunk) base: contiguous,
// one lane's slots one after another
struct Dense {
  size_t stride;
  __device__ __forceinline__ size_t operator()(int s) const { return (size_t)s * stride; }
};

// through the lane's page-table row: pages of 2^lp slots, nb entries; big
// (pages of at least kWarpSlots slots): every slot the caller asks for lies
// in the page of the warp's first slot, whose start is s + delta
struct Paged {
  const int* tbl;
  int lp, nb;
  bool big;
  long long delta;
  size_t stride;
  __device__ __forceinline__ size_t operator()(int s) const {
    if (big) return (size_t)(s + delta) * stride;
    const int pg = __ldg(tbl + min(s >> lp, nb - 1));
    return ((size_t)pg << lp | (size_t)(s & ((1 << lp) - 1))) * stride;
  }
};

// a row's slots: 0 .. min(pos, s_len - 1)
__device__ __forceinline__ int row_slots(long long p, int s_len) {
  return (int)(p < (long long)s_len - 1 ? p : (long long)s_len - 1) + 1;
}

__device__ __forceinline__ float rescale(float m, float mn) {
  return m == -INFINITY ? 0.0f : expf(m - mn);  // an empty state weighs 0
}

// v[0 .. N) summed over the 2 O threads of a slot group (xor partners at
// offsets O, O / 2, .., 1), scattered: while more than one value is left
// (CNT), a level keeps half of them (the upper half where the thread's
// offset bit is set) and adds its partner's copy of that half; past that
// the levels add whole (a butterfly) and every thread of a sub-group holds
// the same sum. The thread ends with v[0 .. max(N / (2 O), 1)), the sums of
// entries base .. of the N; returns base. The order of every addition is
// fixed by the thread's index c (a sum's tree is the same for any N).
template <int N, int O, int CNT>
__device__ __forceinline__ int reduce_scatter(float (&v)[N], int c) {
  if constexpr (O == 0) {
    return 0;
  } else if constexpr (CNT > 1) {
    constexpr int H = CNT / 2;
    const bool upper = (c & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = upper ? v[i] : v[i + H];
      const float keep = upper ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    return (upper ? H : 0) + reduce_scatter<N, O / 2, H>(v, c);
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
    return reduce_scatter<N, O / 2, 1>(v, c);
  }
}

// One query row's share of split j: its scores, the split's softmax and
// weighted V, written as the row's output (a row with one split, ns == 1)
// or as the split's partial state (max, sum, weighted V) in rec.
template <int G, int TPS, typename KV, typename Addr>
__device__ __forceinline__ void split_row(const float* __restrict__ qb,
                                          const KV* __restrict__ kc, const KV* __restrict__ vc,
                                          const Addr& addr, bool vec_ok, int n, int j,
                                          int ns, float* __restrict__ rec,
                                          float* __restrict__ ob, float* __restrict__ st,
                                          int g_n, int hd, float scale) {
  constexpr int VEC = Vec<KV>::n;
  using Raw = typename Vec<KV>::raw;
  constexpr int SPW = 32 / TPS;  // slots one load instruction of a warp covers
  constexpr int SLOTS = kWarpSlots / SPW;  // slots per thread
  constexpr int U = SLOTS < kU ? SLOTS : kU;  // slots whose loads a thread issues together
  constexpr int NV = G * U;  // a round's dots per thread
  constexpr int NS = NV / TPS > 0 ? NV / TPS : 1;  // the sums a thread keeps of them
  static_assert(SLOTS % U == 0 && kSplit == kThreads, "the split's slot plan");
  const int warp = threadIdx.x / 32;
  const int t = threadIdx.x % 32;
  const int r = t / TPS;  // the slot of a load this thread's group takes
  const int c = t % TPS;  // the group's 16-byte chunk of the head
  const int d0 = c * VEC;

  // q * scale, rounded once as the plain version rounds it
  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int d = d0 + i;
      qr[g][i] = (g < g_n && d < hd) ? qb[g * hd + d] * scale : 0.0f;
    }

  // the split's scores, then its softmax weights: [local slot][query head]
  __shared__ __align__(16) float s_p[kSplit][G];
  __shared__ float s_red[kWarps][G];
  const int l0 = warp * kWarpSlots + r;  // local slot of the thread's first
  const int s0 = j * kSplit + l0;
  Raw vr[U];  // the first round's V, in flight while the scores are formed
#pragma unroll 1
  for (int u0 = 0; u0 < SLOTS; u0 += U) {
    Raw kr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + (u0 + u) * SPW;
      kr[u] = load16(kc + addr(s), vec_ok, d0, hd, s < n);
    }
    float dot[NV];  // [g][u]
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kx[VEC];
      widen(kr[u], kx);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float x = 0.0f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) x = fmaf(qr[g][i], kx[i], x);
        dot[g * U + u] = x;
      }
    }
    if (u0 + U >= SLOTS) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int s = s0 + u * SPW;
        vr[u] = load16(vc + addr(s), vec_ok, d0, hd, s < n);
      }
    }
    // each dot summed over its slot's TPS threads; each sum stored by one
    const int base = reduce_scatter<NV, TPS / 2, NV>(dot, c);
    bool writer = true;  // one thread of the sub-group that holds the same sums
    if constexpr (NV < TPS) writer = (c & (TPS / NV - 1)) == 0;
    if (writer) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int g = (base + i) / U, u = (base + i) % U;
        const int l = l0 + (u0 + u) * SPW;
        s_p[l][g] = j * kSplit + l < n ? dot[i] : -INFINITY;
      }
    }
  }
  __syncthreads();

  // the split's softmax: one slot per thread, its max and sum per query head
  // over the block (a warp's butterfly, then the warps in order)
  const int me = threadIdx.x;
  float sv[G], mx[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    sv[g] = s_p[me][g];
    float x = sv[g];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (t == 0) s_red[warp][g] = x;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    mx[g] = s_red[0][g];  // finite: slot j kSplit < n
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx[g] = fmaxf(mx[g], s_red[w][g]);
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float w = expf(sv[g] - mx[g]);  // 0 past the lane's slots
    s_p[me][g] = w;
    float x = w;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (t == 0) s_red[warp][g] = x;
  }
  __syncthreads();

  // the weighted V of the thread's slots
  float acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.0f;
#pragma unroll 1
  for (int u0 = 0; u0 < SLOTS; u0 += U) {
    if (u0 > 0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int s = s0 + (u0 + u) * SPW;
        vr[u] = load16(vc + addr(s), vec_ok, d0, hd, s < n);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vx[VEC], pw[G];
      widen(vr[u], vx);
#pragma unroll
      for (int g = 0; g < G; ++g) pw[g] = s_p[l0 + (u0 + u) * SPW][g];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(pw[g], vx[i], acc[g][i]);
    }
  }

  // the slot groups' sums, in group order (group = warp * SPW + r), through
  // shared memory
  constexpr int W = TPS * VEC;  // head dims a group covers
  __shared__ float s_acc[kWarps * SPW][G][W];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i) s_acc[warp * SPW + r][g][d0 + i] = acc[g][i];
  __syncthreads();
  if (ns > 1 || st != nullptr) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g == threadIdx.x && g < g_n) {
        float den = 0.0f;
        for (int w = 0; w < kWarps; ++w) den += s_red[w][g];
        if (ns > 1) {
          rec[g_n * hd + g] = mx[g];
          rec[g_n * (hd + 1) + g] = den;
        } else {  // the stats form: the row's one split is its whole state
          st[2 * g] = mx[g];
          st[2 * g + 1] = den;
        }
      }
    }
  }
  for (int e = threadIdx.x; e < g_n * hd; e += kThreads) {
    const int g = e / hd;
    const int d = e % hd;
    float a = 0.0f;
#pragma unroll 8
    for (int grp = 0; grp < kWarps * SPW; ++grp) a += s_acc[grp][g][d];
    if (ns == 1) {
      float den = 0.0f;
      for (int w = 0; w < kWarps; ++w) den += s_red[w][g];
      ob[e] = a / den;
    } else {
      rec[e] = a;
    }
  }
}

// One row's output from its ns splits' partial states (rec0: split 0's,
// split j's at j * split_stride), folded in split order. A chunk of
// kFoldChunk splits at a time (one for s_len <= 2048): each output element's
// partial sums loaded together (past the row's last split, copies weighted
// 0), in flight while one warp lane per (split, query head) loads the split's
// max and sum and forms its weight exp(m_j - max) and the chunk's sum of
// weighted sums (a butterfly over the chunk); then each element's sums
// weighted in split order. A later chunk rescales what came before.
template <int G, int TPS, typename KV>
__device__ __forceinline__ void fold_row(const float* __restrict__ rec0, size_t split_stride,
                                         int ns, float* __restrict__ ob,
                                         float* __restrict__ st, int g_n, int hd) {
  constexpr int VEC = Vec<KV>::n;
  static_assert(kFoldChunk == 16 && G * kFoldChunk <= kThreads, "the fold's lanes");
  __shared__ float s_w[kFoldChunk][G], s_mx[G], s_c[G], s_den[G];
  constexpr int E = (G * TPS * VEC + kThreads - 1) / kThreads;  // outputs per thread, at most
  float fa[E];
#pragma unroll
  for (int x = 0; x < E; ++x) fa[x] = 0.0f;
  if (threadIdx.x < G) {
    s_mx[threadIdx.x] = -INFINITY;
    s_den[threadIdx.x] = 0.0f;
  }
  __syncthreads();
  for (int j0 = 0; j0 < ns; j0 += kFoldChunk) {
    const int nj = min(kFoldChunk, ns - j0);
    float aj[E][kFoldChunk];
#pragma unroll
    for (int x = 0; x < E; ++x) {
      const int e = min(threadIdx.x + x * kThreads, g_n * hd - 1);  // past the head: a copy
#pragma unroll
      for (int jj = 0; jj < kFoldChunk; ++jj)
        aj[x][jj] = __ldcg(rec0 + (size_t)(j0 + min(jj, nj - 1)) * split_stride + e);
    }
    if (threadIdx.x < (G * kFoldChunk > 32 ? G * kFoldChunk : 32)) {  // whole warps
      const int jj = threadIdx.x % kFoldChunk, g = threadIdx.x / kFoldChunk;
      const bool in = jj < nj && g < g_n;
      const float* rj = rec0 + (size_t)(j0 + jj) * split_stride;
      const float m = in ? __ldcg(rj + g_n * hd + g) : -INFINITY;
      const float l = in ? __ldcg(rj + g_n * (hd + 1) + g) : 0.0f;
      const float prev = s_mx[min(g, G - 1)];
      float mn = m;
#pragma unroll
      for (int o = kFoldChunk / 2; o > 0; o >>= 1) mn = fmaxf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mn = fmaxf(mn, prev);  // finite for g < g_n: every split's max is
      const float w = in ? expf(m - mn) : 0.0f;
      float lw = l * w;
#pragma unroll
      for (int o = kFoldChunk / 2; o > 0; o >>= 1) lw += __shfl_xor_sync(0xffffffffu, lw, o);
      if (g < G) s_w[jj][g] = w;
      __syncwarp();  // every lane of the warp has read s_mx before it is written
      if (jj == 0 && g < g_n) {
        const float cs = rescale(prev, mn);
        s_c[g] = cs;
        s_mx[g] = mn;
        s_den[g] = s_den[g] * cs + lw;
      }
    }
    __syncthreads();
#pragma unroll
    for (int x = 0; x < E; ++x) {
      const int g = min(threadIdx.x + x * kThreads, g_n * hd - 1) / hd;
      float a = 0.0f;
#pragma unroll
      for (int jj = 0; jj < kFoldChunk; ++jj) a += aj[x][jj] * s_w[jj][g];
      fa[x] = fa[x] * s_c[g] + a;
    }
    __syncthreads();
  }
#pragma unroll
  for (int x = 0; x < E; ++x) {
    const int e = threadIdx.x + x * kThreads;
    if (e < g_n * hd) ob[e] = fa[x] / s_den[e / hd];
  }
  if (st != nullptr && threadIdx.x < g_n) {  // the stats form: the folded state
    st[2 * threadIdx.x] = s_mx[threadIdx.x];
    st[2 * threadIdx.x + 1] = s_den[threadIdx.x];
  }
}

// Where a lane's slots lie: contiguous (table null), lane b's slot s at b
// lane_stride + s n_kv hd; else paged through tbl [lanes, nb] (pages of 2^lp
// slots)
struct Layout {
  long long lane_stride;
  const int* tbl;
  int nb, lp;
};

// G: query heads per kv head (the runtime group g_n <= G); TPS: threads per
// slot (the runtime head size hd <= TPS * VEC); PAGED: the layout's form.
// Block (kv head, row, split): the row's cache lane is row / lane_rows.
template <int G, int TPS, typename KV, bool PAGED>
__global__ void __launch_bounds__(kThreads, G <= 4 && TPS <= 8 ? kMinBlocks : 1)
decode_attn_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                   const KV* __restrict__ v, const long long* __restrict__ pos,
                   float* __restrict__ out, float* __restrict__ part,
                   unsigned* __restrict__ tickets, float* __restrict__ stats, Layout lay,
                   int lane_rows, int n_kv, int g_n, int hd, int s_len, int vec_ok,
                   float scale) {
  constexpr int VEC = Vec<KV>::n;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int j = blockIdx.z;
  const int n = row_slots(pos[b], s_len);
  const size_t head = (size_t)b * n_kv + kvh;
  // the stats form: this (row, kv head)'s (m, l) per query head
  float* st = stats != nullptr ? stats + head * g_n * 2 : nullptr;
  if (j * kSplit >= n) {  // past the row's last split
    if (st != nullptr && n <= 0 && j == 0) {  // no slot at all: the empty state
      for (int e = threadIdx.x; e < g_n * hd; e += kThreads) out[head * g_n * hd + e] = 0.0f;
      if (threadIdx.x < g_n) {
        st[2 * threadIdx.x] = -INFINITY;
        st[2 * threadIdx.x + 1] = 0.0f;
      }
    }
    return;
  }
  const int ns = (n + kSplit - 1) / kSplit;
  const int c = (threadIdx.x % 32) % TPS;
  const size_t lane = (size_t)(b / lane_rows);
  const size_t slot_stride = (size_t)n_kv * hd;
  const size_t at = (PAGED ? 0 : lane * lay.lane_stride) + (size_t)kvh * hd + c * VEC;
  const int rec_len = g_n * (hd + 2);
  // split j' of this (row, kv head) keeps its partial state at part + (head
  // S + j') rec_len
  float* rec = ns > 1 ? part + (head * gridDim.z + j) * rec_len : nullptr;
  float* ob = out + head * g_n * hd;
  if constexpr (PAGED) {
    const int* row = lay.tbl + lane * lay.nb;
    const int ws = j * kSplit + (int)(threadIdx.x / 32) * kWarpSlots;  // the warp's first slot
    const bool big = lay.lp >= 5;  // 2^lp >= kWarpSlots
    long long delta = 0;
    if (big)
      delta = ((long long)__ldg(row + min(ws >> lay.lp, lay.nb - 1)) << lay.lp) -
              (ws & ~((1 << lay.lp) - 1));
    const Paged addr{row, lay.lp, lay.nb, big, delta, slot_stride};
    split_row<G, TPS, KV>(q + head * g_n * hd, k + at, v + at, addr, vec_ok != 0, n, j, ns, rec,
                          ob, st, g_n, hd, scale);
  } else {
    split_row<G, TPS, KV>(q + head * g_n * hd, k + at, v + at, Dense{slot_stride},
                          vec_ok != 0, n, j, ns, rec, ob, st, g_n, hd, scale);
  }
  if (ns == 1) return;

  // the last block of this (row, kv head) to arrive folds the partial
  // states in split order
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&tickets[head], 1u) == (unsigned)(ns - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  fold_row<G, TPS, KV>(part + head * gridDim.z * rec_len, rec_len, ns, ob, st, g_n, hd);
}

template <int G, int TPS, typename KV>
cudaError_t launch(const float* q, const void* k, const void* v, const long long* pos,
                   float* out, float* part, unsigned* tickets, float* stats, Layout lay,
                   int rows, int lane_rows, int n_kv, int g_n, int hd, int s_len, int vec_ok,
                   float scale, cudaStream_t stream) {
  const dim3 grid(n_kv, rows, (s_len + kSplit - 1) / kSplit);
  if (lay.tbl != nullptr)
    decode_attn_kernel<G, TPS, KV, true><<<grid, kThreads, 0, stream>>>(
        q, static_cast<const KV*>(k), static_cast<const KV*>(v), pos, out, part, tickets, stats,
        lay, lane_rows, n_kv, g_n, hd, s_len, vec_ok, scale);
  else
    decode_attn_kernel<G, TPS, KV, false><<<grid, kThreads, 0, stream>>>(
        q, static_cast<const KV*>(k), static_cast<const KV*>(v), pos, out, part, tickets, stats,
        lay, lane_rows, n_kv, g_n, hd, s_len, vec_ok, scale);
  return cudaGetLastError();
}

// TPS: the fewest threads (at least 4, a power of two) whose 16-byte chunks
// cover the head
template <int G, typename KV>
cudaError_t by_dims(const float* q, const void* k, const void* v, const long long* pos,
                    float* out, float* part, unsigned* tickets, float* stats, Layout lay,
                    int rows, int lane_rows, int n_kv, int g_n, int hd, int s_len, int vec_ok,
                    float scale, cudaStream_t stream) {
  constexpr int VEC = Vec<KV>::n;
#define DECODE_ATTN_LAUNCH(TPS)                                                        \
  return launch<G, TPS, KV>(q, k, v, pos, out, part, tickets, stats, lay, rows,        \
                            lane_rows, n_kv, g_n, hd, s_len, vec_ok, scale, stream)
  if (hd <= 4 * VEC) DECODE_ATTN_LAUNCH(4);
  if (hd <= 8 * VEC) DECODE_ATTN_LAUNCH(8);
  if (hd <= 16 * VEC) DECODE_ATTN_LAUNCH(16);
  if constexpr (VEC == 4) DECODE_ATTN_LAUNCH(32);
#undef DECODE_ATTN_LAUNCH
  return cudaErrorInvalidValue;
}

template <typename KV>
cudaError_t by_group(const float* q, const void* k, const void* v, const long long* pos,
                     float* out, float* part, unsigned* tickets, float* stats, Layout lay,
                     int rows, int lane_rows, int n_kv, int g_n, int hd, int s_len,
                     int vec_ok, float scale, cudaStream_t stream) {
#define DECODE_ATTN_GROUP(G)                                                            \
  return by_dims<G, KV>(q, k, v, pos, out, part, tickets, stats, lay, rows, lane_rows,  \
                        n_kv, g_n, hd, s_len, vec_ok, scale, stream)
  if (g_n <= 1) DECODE_ATTN_GROUP(1);
  if (g_n <= 2) DECODE_ATTN_GROUP(2);
  if (g_n <= 4) DECODE_ATTN_GROUP(4);
  DECODE_ATTN_GROUP(8);
#undef DECODE_ATTN_GROUP
}

}  // namespace

namespace {

// kv_dtype: 0 f32, 1 bf16, 2 e4m3 (ops/cuda_attn.py kv_code)
int launch_any(const float* q, const void* k, const void* v, const long long* pos, float* out,
               float* part, unsigned* tickets, float* stats, Layout lay, int lanes, int rows,
               int n_kv, int g_n, int hd, int s_len, int split, int kv_dtype, float scale,
               void* stream) {
  if (lanes < 1 || rows < 1 || rows > kWindow || n_kv < 1 || g_n < 1 || g_n > 8 || hd < 1 ||
      hd > 128 || s_len < 1 || split != kSplit || kv_dtype < 0 || kv_dtype > 2 ||
      (s_len > kSplit && (part == nullptr || tickets == nullptr)) ||
      (lay.tbl != nullptr && (lay.nb < 1 || lay.lp < 0 || lay.lp > 20 ||
                              ((long long)lay.nb << lay.lp) < s_len)))
    return (int)cudaErrorInvalidValue;
  const int vec = kv_dtype == 0 ? 4 : 8;  // elements a load takes
  const uintptr_t unit = kv_dtype == 2 ? 8 : 16;  // its bytes
  const int vec_ok = hd % vec == 0 && (n_kv * hd) % vec == 0 && lay.lane_stride % vec == 0 &&
                     reinterpret_cast<uintptr_t>(k) % unit == 0 &&
                     reinterpret_cast<uintptr_t>(v) % unit == 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (kv_dtype == 2)
    return (int)by_group<E4M3>(q, k, v, pos, out, part, tickets, stats, lay, lanes * rows, rows,
                               n_kv, g_n, hd, s_len, vec_ok, scale, st);
  if (kv_dtype == 1)
    return (int)by_group<__nv_bfloat16>(q, k, v, pos, out, part, tickets, stats, lay,
                                        lanes * rows, rows, n_kv, g_n, hd, s_len, vec_ok, scale,
                                        st);
  return (int)by_group<float>(q, k, v, pos, out, part, tickets, stats, lay, lanes * rows, rows,
                              n_kv, g_n, hd, s_len, vec_ok, scale, st);
}

}  // namespace

// q: f32 [lanes, rows, n_kv, g_n, hd]; k, v: one layer's cache, slot s of
// lane b at b * lane_stride + s * n_kv * hd (elements; kv_dtype 0: f32,
// 1: bf16, 2: e4m3); pos: int64 [lanes, rows]; out: f32 [lanes, rows, n_kv, g_n, hd];
// rows: 1 .. kWindow. split: the caller's split length, which must be
// kSplit. With more than one split (s_len > split), part: f32 [lanes, rows,
// n_kv, ceil(s_len / split), g_n * (hd + 2)] scratch and tickets: [lanes *
// rows * n_kv] u32 zeros; else both may be null. stats: null, or f32 [lanes,
// rows, n_kv, g_n, 2], each row's (m, l) per query head (the partial-stats
// form; pos may then be negative: a row with no slot).
extern "C" int decode_attn_launch(const float* q, const void* k, const void* v,
                                  const long long* pos, float* out, float* part,
                                  unsigned* tickets, float* stats, long long lane_stride,
                                  int lanes, int rows, int n_kv, int g_n, int hd, int s_len,
                                  int split, int kv_dtype, float scale, void* stream) {
  return launch_any(q, k, v, pos, out, part, tickets, stats, Layout{lane_stride, nullptr, 0, 0},
                    lanes, rows, n_kv, g_n, hd, s_len, split, kv_dtype, scale, stream);
}

// The paged form: k, v: one layer's pool, page p's slot i at (p 2^log2_page
// + i) n_kv hd (elements); table: int32 [lanes, nb], lane b's block i in
// page table[b, i] (nb 2^log2_page >= s_len); the rest as above.
extern "C" int decode_attn_paged_launch(const float* q, const void* k, const void* v,
                                        const long long* pos, float* out, float* part,
                                        unsigned* tickets, const int* table, int nb,
                                        int log2_page, int lanes, int rows, int n_kv, int g_n,
                                        int hd, int s_len, int split, int kv_dtype, float scale,
                                        void* stream) {
  if (table == nullptr) return (int)cudaErrorInvalidValue;
  return launch_any(q, k, v, pos, out, part, tickets, nullptr, Layout{0, table, nb, log2_page},
                    lanes, rows, n_kv, g_n, hd, s_len, split, kv_dtype, scale, stream);
}
