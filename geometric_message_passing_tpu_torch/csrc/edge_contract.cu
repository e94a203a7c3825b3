// Per-edge weighted CG contraction for Hopper (sm_90a): TFN's tensor-product
// stage 2, forward and backward, exact f32, no atomics.
//
// Replaces geometric_message_passing_tpu/ops/pallas_tp.py::_fwd_kernel and
// ::_bwd_kernel (K7).  Per group g (an output irrep) of a layer's edge tensor
// product, with k = (path, u):
//
//   forward   out[e, w, m] = sum_k T[e, k, m] W[e, k, w]
//   backward  dW[e, k, w]  = sum_m T[e, k, m] dO[e, w, m]
//             dT[e, k, m]  = sum_w W[e, k, w] dO[e, w, m]
//
// T [E, K, m] is the f32 CG intermediate, W [E, K, w] the per-edge weight
// (f32, or bf16 converted to f32 in the kernel), out / dO [E, w, m] f32, dW
// [E, K, w] in W's type (rounded to nearest), dT f32.  m = 2l+1 <= 15.
//
// The TPU kernel tiles (edges, K) with K innermost and accumulates the output
// block across the K grid steps.  Here nothing carries over between blocks:
// a block owns whole edges of one group at a time and loops over K itself.
//
// What bounds it: bytes.  W is the giant (at TFN's star width a hidden layer
// holds 143,360 weights per edge, 803 MB at the train bucket's 1400 edges)
// and each weight feeds only m <= 7 multiply-adds forward and 2m backward,
// far below the card's ~20 f32 operations per byte.
//
// Two designs, one per entry:
//
// One group a launch (contract_fwd, contract_bwd; gmp_contract_fwd/_bwd):
// one block per edge, T[e] (and dO[e]) staged in shared memory.  Forward:
// each thread owns one w column and one of ks = blockDim / w interleaved
// slices of k, streams its W[e, k, w] (a warp reads 128 contiguous bytes of a
// row) and keeps its m sums in registers; the ks partial sums are added in
// slice order through shared memory.  Backward: a warp takes the rows k =
// warp, warp + 8, ...: its lanes read W[e, k, :] once, write dW[e, k, :] and
// reduce dT[e, k, :] over w by a fixed shuffle tree.  Any w, any alignment.
//
// All groups of a layer in one launch per direction (contract_ring_kernel;
// gmp_contract_grouped), for W rows of 16-byte multiples:
//   * a table of the groups' pointers and shapes goes by value
//     (__grid_constant__); persistent blocks (as many as fit on the card at
//     once) walk the work list of items (group, edges), the groups with the
//     largest W block per item first, so the small groups fill the tail;
//   * an item is epb consecutive edges of one group, epb sub-blocks of tpi =
//     ks * cols threads; thread (s, c) of a sub-block owns the vector column
//     c (VEC = 4 f32 or 8 bf16 values of w, one 16-byte read or store) and
//     the rows k = s, s + ks, ...; ks is chosen (ops/edge_contract.py::
//     contract_plan) so each thread streams at least 16 rows where K allows;
//   * W reaches the threads through a ring of kStages chunks in shared
//     memory: thread 0 fills it with one bulk copy (cp.async.bulk, the TMA)
//     per edge and chunk, an edge's rows being contiguous, signalled on an
//     mbarrier per slot, and keeps walking the block's work list ahead of
//     the consumers, into the next items, so the copies of the next chunks
//     are in flight while T is staged and the partial sums are added; no
//     register holds a load in flight;
//   * forward: T[e] in shared memory; each thread keeps its VEC x m sums in
//     registers; the ks partial sums are added in slice order through shared
//     memory and out is written coalesced;
//   * backward: T[e] and dO[e] in shared memory, dO's VEC x m values of the
//     thread's columns in registers; each W row is read once, dW written
//     with 16-byte stores, and each row's dT partials (over the thread's VEC
//     columns) go to shared memory, a chunk of ks * kRows rows at a time,
//     where they are added over the columns in a fixed order (chunk_dT).
// Every sum has a fixed order, whatever the grid: two runs give bitwise-equal
// results.  No TF32 and no tensor cores: every product is an f32 FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;        // rows per thread per chunk of the W ring
constexpr int kStages = 3;      // chunks in the W ring
constexpr int kMaxGroups = 16;

struct Group {
  const float* T;   // [E, K, m] contiguous
  const void* W;    // row (e, k) at W + e * w_stride + k * w
  float* out;       // forward: [E, w, m]
  const float* dO;  // backward: [E, w, m]
  float* dT;        // backward: [E, K, m]
  void* dW;         // backward: [E, K, w] contiguous
  long long E, w_stride;
  int K, m, w, cols, ks, tpi, epb, item0;
};

struct Table {
  int n, items;
  int slot_bytes, fofs;   // the W ring's slot size; byte offset of the floats
  int tmax, omax;         // floats of a T and of a dO buffer (ring kernel)
  Group g[kMaxGroups];
};

// Unpacking and 16-byte stores of VEC consecutive W values.
template <typename TW, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(f[0], f[1], f[2], f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    __stcs(reinterpret_cast<uint4*>(p), r);
  }
};

// dT of one chunk of rows: output i (of n_edges x per_edge) is the sum of
// its partials over the cols columns (red: [edge][cols][pad]), in column
// order.
__device__ __forceinline__ void chunk_dT(const Group& G, long long e0, int kb,
                                         int M, int per_edge, int n_edges,
                                         int pad, const float* red) {
  for (int i = threadIdx.x; i < n_edges * per_edge; i += kThreads) {
    const int j2 = i / per_edge, rem = i - j2 * per_edge;
    if (kb + rem / M < G.K) {
      const float* pr = red + (size_t)j2 * G.cols * pad + rem;
      float sum = pr[0];
      for (int c2 = 1; c2 < G.cols; ++c2) sum += pr[(size_t)c2 * pad];
      G.dT[((e0 + j2) * G.K + kb) * M + rem] = sum;
    }
  }
}

// ---- The W ring (16-byte-aligned rows): bulk copies and mbarriers ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ int group_of(const Table& tab, int it) {
  int gi = 0;
  while (gi + 1 < tab.n && it >= tab.g[gi + 1].item0) ++gi;
  return gi;
}

__device__ __forceinline__ int chunks_of(const Group& G) {
  const int R = G.ks * kRows;
  return (G.K + R - 1) / R;
}

// The producer (thread 0 of a block) walks the block's chunks in the order
// the block consumes them: its items b, b + gridDim.x, ..., each item's
// chunks of ks * kRows rows.  A chunk is one bulk copy per edge of the item
// (the edge's rows are contiguous) into the slot, [edge][row][w].
template <typename TW>
struct Producer {
  const Table& tab;
  unsigned char* ring;
  uint64_t* bars;
  int it, j;

  __device__ void fill(int slot) {
    if (it >= tab.items) return;
    const Group& G = tab.g[group_of(tab, it)];
    const int R = G.ks * kRows, kb = j * R, rows = min(R, G.K - kb);
    const long long e0 = (long long)(it - G.item0) * G.epb;
    const int ne = (int)(G.E - e0 < G.epb ? G.E - e0 : G.epb);
    const uint32_t bytes = (uint32_t)rows * G.w * sizeof(TW);
    unsigned char* dst = ring + (size_t)slot * tab.slot_bytes;
    bar_expect(&bars[slot], bytes * ne);
    for (int q = 0; q < ne; ++q)
      bulk_load(dst + (size_t)q * R * G.w * sizeof(TW),
                static_cast<const TW*>(G.W) + (e0 + q) * G.w_stride +
                    (size_t)kb * G.w,
                bytes, &bars[slot]);
    if (++j == chunks_of(G)) {
      j = 0;
      it += gridDim.x;
    }
  }
};

// Forward of one item from the ring.  Shared memory: T of the item's edges
// [epb][K m] (t_s), then the ks slices' partial sums [epb][ks][w m] (part).
// Per chunk the thread's kRows rows of its vector column come from the slot,
// sums in registers; then the slices' partial sums are added in order and
// out is written coalesced.
template <typename TW, int VEC, int M>
__device__ __forceinline__ void fwd_ring_item(const Group& G, long long e0,
                                              const float* t_s, float* part,
                                              Producer<TW>& prod, int& g) {
  using V = Vec<TW, VEC>;
  const int K = G.K, w = G.w, ks = G.ks, cols = G.cols, epb = G.epb;
  const int nt = K * M, no = w * M, R = ks * kRows;
  const long long n_edges = G.E - e0 < epb ? G.E - e0 : epb;

  const int sub = threadIdx.x / G.tpi, lt = threadIdx.x - sub * G.tpi;
  const int s = lt / cols, c = lt - s * cols;
  float acc[VEC][M];
#pragma unroll
  for (int q = 0; q < VEC; ++q)
#pragma unroll
    for (int j = 0; j < M; ++j) acc[q][j] = 0.f;
  const float* Te = t_s + sub * nt;
  const int nch = chunks_of(G);
  for (int ch = 0; ch < nch; ++ch, ++g) {
    const int slot = g % kStages;
    bar_wait(&prod.bars[slot], (g / kStages) & 1);
    if (sub < n_edges) {
      const TW* ws = reinterpret_cast<const TW*>(prod.ring +
                                                 (size_t)slot * prod.tab.slot_bytes) +
                     ((size_t)sub * R + s) * w + (size_t)c * VEC;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int k = ch * R + s + u * ks;
        if (k < K) {
          float f[VEC];
          V::unpack(*reinterpret_cast<const typename V::Raw*>(
                        ws + (size_t)u * ks * w), f);
          const float* tk = Te + k * M;
#pragma unroll
          for (int j = 0; j < M; ++j) {
            const float t = tk[j];
#pragma unroll
            for (int q = 0; q < VEC; ++q) acc[q][j] = fmaf(t, f[q], acc[q][j]);
          }
        }
      }
    }
    __syncthreads();   // the slot is consumed
    if (threadIdx.x == 0) prod.fill(slot);
  }
  if (sub < epb) {
    float* p = part + ((size_t)sub * ks + s) * no + (size_t)c * VEC * M;
#pragma unroll
    for (int q = 0; q < VEC; ++q)
#pragma unroll
      for (int j = 0; j < M; ++j) p[q * M + j] = acc[q][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_edges * no; i += kThreads) {
    const int j = i / no, o = i - j * no;
    const float* p = part + (size_t)j * ks * no + o;
    float sum = p[0];
    for (int q = 1; q < ks; ++q) sum += p[(size_t)q * no];
    G.out[e0 * no + i] = sum;
  }
  __syncthreads();
}

// Backward of one item from the ring.  Shared memory: T [epb][K m] (t_s), dO
// [epb][w m] (g_s), then the dT partials of one chunk of rows [epb][cols][ks
// kRows m + 1] (red: column-major and padded, so the writes of a warp and the
// column sums' reads hit distinct banks).
template <typename TW, int VEC, int M>
__device__ __forceinline__ void bwd_ring_item(const Group& G, long long e0,
                                              const float* t_s,
                                              const float* g_s, float* red,
                                              Producer<TW>& prod, int& g) {
  using V = Vec<TW, VEC>;
  const int K = G.K, w = G.w, ks = G.ks, cols = G.cols, epb = G.epb;
  const int nt = K * M, no = w * M, R = ks * kRows;
  const long long n_edges = G.E - e0 < epb ? G.E - e0 : epb;

  const int sub = threadIdx.x / G.tpi, lt = threadIdx.x - sub * G.tpi;
  const int s = lt / cols, c = lt - s * cols;
  const bool on = sub < n_edges;
  float gr[VEC][M];
#pragma unroll
  for (int q = 0; q < VEC; ++q)
#pragma unroll
    for (int j = 0; j < M; ++j)
      gr[q][j] = on ? g_s[sub * no + (c * VEC + q) * M + j] : 0.f;
  const long long e = on ? e0 + sub : e0;
  TW* __restrict__ dWe =
      static_cast<TW*>(G.dW) + e * (long long)K * w + (size_t)c * VEC;
  const float* Te = t_s + sub * nt;
  const int pad = R * M + 1;   // one column's partials
  float* rs = red + (size_t)sub * cols * pad + (size_t)c * pad;
  const int nch = chunks_of(G);
  for (int ch = 0; ch < nch; ++ch, ++g) {
    const int slot = g % kStages, kb = ch * R;
    bar_wait(&prod.bars[slot], (g / kStages) & 1);
    const TW* ws = reinterpret_cast<const TW*>(prod.ring +
                                               (size_t)slot * prod.tab.slot_bytes) +
                   ((size_t)sub * R + s) * w + (size_t)c * VEC;
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int kr = s + u * ks, k = kb + kr;
      float p[M];
#pragma unroll
      for (int j = 0; j < M; ++j) p[j] = 0.f;
      if (on && k < K) {
        float f[VEC], dw[VEC];
        V::unpack(*reinterpret_cast<const typename V::Raw*>(
                      ws + (size_t)u * ks * w), f);
        const float* tk = Te + k * M;
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          float a = 0.f;
#pragma unroll
          for (int j = 0; j < M; ++j) a = fmaf(tk[j], gr[q][j], a);
          dw[q] = a;
        }
        V::store(dWe + (size_t)k * w, dw);
#pragma unroll
        for (int j = 0; j < M; ++j) {
          float a = 0.f;
#pragma unroll
          for (int q = 0; q < VEC; ++q) a = fmaf(f[q], gr[q][j], a);
          p[j] = a;
        }
      }
      if (sub < epb) {
#pragma unroll
        for (int j = 0; j < M; ++j) rs[kr * M + j] = p[j];
      }
    }
    __syncthreads();   // the slot is consumed, the partials written
    if (threadIdx.x == 0) prod.fill(slot);
    chunk_dT(G, e0, kb, M, R * M, (int)n_edges, pad, red);
    __syncthreads();
  }
}

template <typename TW, int VEC, int MMAX, bool kBwd>
__device__ __forceinline__ void run_ring_item(const Group& G, long long e0,
                                              const float* t_s,
                                              const float* g_s, float* work,
                                              Producer<TW>& prod, int& g) {
  switch (G.m) {
#define GMP_CASE(M_)                                                        \
  case M_:                                                                  \
    if constexpr (M_ <= MMAX) {                                             \
      if constexpr (kBwd)                                                   \
        bwd_ring_item<TW, VEC, M_>(G, e0, t_s, g_s, work, prod, g);         \
      else                                                                  \
        fwd_ring_item<TW, VEC, M_>(G, e0, t_s, work, prod, g);              \
    }                                                                       \
    break;
    GMP_CASE(1) GMP_CASE(3) GMP_CASE(5) GMP_CASE(7)
    GMP_CASE(9) GMP_CASE(11) GMP_CASE(13) GMP_CASE(15)
#undef GMP_CASE
    default: break;
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// Start copying item it's T (and, backward, dO) rows into t_s (and g_s)
// with 4-byte cp.async (any alignment), one commit group.
template <bool kBwd>
__device__ __forceinline__ void prefetch_item(const Table& tab, int it,
                                              float* t_s, float* g_s) {
  if (it < tab.items) {
    const Group& G = tab.g[group_of(tab, it)];
    const long long e0 = (long long)(it - G.item0) * G.epb;
    const long long ne = G.E - e0 < G.epb ? G.E - e0 : G.epb;
    const long long nt = (long long)G.K * G.m, no = (long long)G.w * G.m;
    for (long long i = threadIdx.x; i < ne * nt; i += kThreads)
      cp_async4(t_s + i, G.T + e0 * nt + i);
    if (kBwd)
      for (long long i = threadIdx.x; i < ne * no; i += kThreads)
        cp_async4(g_s + i, G.dO + e0 * no + i);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Persistent blocks over the work list, W through a ring of kStages chunks
// in shared memory that thread 0 keeps filled with bulk copies (16-byte
// rows only), and each item's T (and dO) copied in (cp.async) while the
// item before it runs.  Shared memory: [ring][mbarriers], then at tab.fofs
// the floats [T x 2][dO x 2][partial sums] (tab.tmax, tab.omax floats per
// T and dO buffer).
template <typename TW, int VEC, int MMAX, bool kBwd>
__global__ void __launch_bounds__(kThreads, 2)
contract_ring_kernel(const __grid_constant__ Table tab) {
  extern __shared__ __align__(128) unsigned char ring[];
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + (size_t)kStages * tab.slot_bytes);
  float* fs = reinterpret_cast<float*>(ring + tab.fofs);
  float* t_buf[2] = {fs, fs + tab.tmax};
  float* g_buf[2] = {fs + 2 * tab.tmax, fs + 2 * tab.tmax + tab.omax};
  float* work = fs + 2 * (tab.tmax + tab.omax);
  if (threadIdx.x == 0) {
    for (int q = 0; q < kStages; ++q) bar_init(&bars[q]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  Producer<TW> prod{tab, ring, bars, (int)blockIdx.x, 0};
  if (threadIdx.x == 0)
    for (int q = 0; q < kStages; ++q) prod.fill(q);
  prefetch_item<kBwd>(tab, blockIdx.x, t_buf[0], g_buf[0]);
  int g = 0, b = 0;   // chunks consumed by this block; this item's buffer
  for (int it = blockIdx.x; it < tab.items; it += gridDim.x, b ^= 1) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();   // this item's T (and dO) are in buffer b
    prefetch_item<kBwd>(tab, it + gridDim.x, t_buf[b ^ 1], g_buf[b ^ 1]);
    const Group& G = tab.g[group_of(tab, it)];
    run_ring_item<TW, VEC, MMAX, kBwd>(G, (long long)(it - G.item0) * G.epb,
                                       t_buf[b], g_buf[b], work, prod, g);
  }
}

// Blocks of a kernel that fit on the card at once: looked up once per
// (device, kernel, shared memory).  The kernel's dynamic shared memory limit
// is raised to the device's opt-in maximum first (a limit, not a size).
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, long long* fit) {
  struct Entry { int dev; const void* kernel; size_t smem; long long fit; };
  static Entry cache[64];
  static int used = 0;
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == dev && cache[i].kernel == key && cache[i].smem == smem) {
      *fit = cache[i].fit;
      return cudaSuccess;
    }
  int optin = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if ((long long)smem > optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *fit = (long long)per_sm * sms;
  if (used < 64) cache[used++] = Entry{dev, key, smem, *fit};
  return cudaSuccess;
}

template <typename Kernel>
int launch_kernel(Kernel kernel, const Table& tab, size_t smem,
                  cudaStream_t stream) {
  long long fit = 0;
  const cudaError_t err = resident_blocks(kernel, smem, &fit);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(tab.items < fit ? tab.items : fit);
  kernel<<<grid, kThreads, smem, stream>>>(tab);
  return (int)cudaGetLastError();
}

template <typename TW, bool kBwd>
int dispatch(const Table& tab, size_t smem, int vec, int mmax,
             cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TW);
  if (vec != kVec) return (int)cudaErrorInvalidValue;
  return mmax <= 7
             ? launch_kernel(contract_ring_kernel<TW, kVec, 7, kBwd>, tab, smem,
                             stream)
             : launch_kernel(contract_ring_kernel<TW, kVec, 15, kBwd>, tab,
                             smem, stream);
}

// ---- One group a launch: one block per edge ----

constexpr int kWarps = kThreads / 32;

template <typename TW>
__device__ __forceinline__ float to_f32(TW v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TW>
__device__ __forceinline__ TW from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// grid (E, ceil(w / wcols)); thread t: slice s = t / wcols, column
// blockIdx.y * wcols + t % wcols.  Shared: T[e] (K*M), then the partial
// sums [ks][wcols][M].
template <typename TW, int M>
__global__ void __launch_bounds__(kThreads)
contract_fwd(const float* __restrict__ T, const TW* __restrict__ W,
             float* __restrict__ out, int K, int Wd, int wcols, int ks) {
  extern __shared__ float smem[];
  float* t_s = smem;
  float* part = smem + K * M;
  const int64_t e = blockIdx.x;
  const float* __restrict__ Te = T + e * (int64_t)K * M;
  for (int i = threadIdx.x; i < K * M; i += blockDim.x) t_s[i] = Te[i];
  __syncthreads();

  const int s = threadIdx.x / wcols, tl = threadIdx.x % wcols;
  const int w = blockIdx.y * wcols + tl;
  float acc[M];
#pragma unroll
  for (int j = 0; j < M; ++j) acc[j] = 0.f;
  if (s < ks && w < Wd) {
    const TW* __restrict__ We = W + e * (int64_t)K * Wd + w;
#pragma unroll 4
    for (int k = s; k < K; k += ks) {
      const float wv = to_f32<TW>(We[(int64_t)k * Wd]);
      const float* tk = t_s + k * M;
#pragma unroll
      for (int j = 0; j < M; ++j) acc[j] = fmaf(tk[j], wv, acc[j]);
    }
  }
  if (s < ks) {
#pragma unroll
    for (int j = 0; j < M; ++j) part[(s * wcols + tl) * M + j] = acc[j];
  }
  __syncthreads();
  if (s == 0 && w < Wd) {
    float* __restrict__ o = out + (e * Wd + w) * M;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float sum = part[tl * M + j];
      for (int q = 1; q < ks; ++q) sum += part[(q * wcols + tl) * M + j];
      o[j] = sum;
    }
  }
}

// grid (E); warp v takes the rows k = v, v + kWarps, ...  Shared: T[e]
// (K*M), dO[e] (Wd*M).
template <typename TW, int M>
__global__ void __launch_bounds__(kThreads)
contract_bwd(const float* __restrict__ T, const TW* __restrict__ W,
             const float* __restrict__ dO, float* __restrict__ dT,
             TW* __restrict__ dW, int K, int Wd) {
  extern __shared__ float smem[];
  float* t_s = smem;
  float* g_s = smem + K * M;
  const int64_t e = blockIdx.x;
  const float* __restrict__ Te = T + e * (int64_t)K * M;
  const float* __restrict__ Ge = dO + e * (int64_t)Wd * M;
  for (int i = threadIdx.x; i < K * M; i += blockDim.x) t_s[i] = Te[i];
  for (int i = threadIdx.x; i < Wd * M; i += blockDim.x) g_s[i] = Ge[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const TW* __restrict__ We = W + e * (int64_t)K * Wd;
  TW* __restrict__ dWe = dW + e * (int64_t)K * Wd;
  for (int k = warp; k < K; k += kWarps) {
    const float* tk = t_s + k * M;
    float dt[M];
#pragma unroll
    for (int j = 0; j < M; ++j) dt[j] = 0.f;
    for (int w = lane; w < Wd; w += 32) {
      const float wv = to_f32<TW>(We[(int64_t)k * Wd + w]);
      const float* gw = g_s + w * M;
      float dw = 0.f;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        dw = fmaf(tk[j], gw[j], dw);
        dt[j] = fmaf(wv, gw[j], dt[j]);
      }
      dWe[(int64_t)k * Wd + w] = from_f32<TW>(dw);
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dt[j] += __shfl_xor_sync(0xffffffffu, dt[j], off);
    }
    if (lane == 0) {
      float* __restrict__ o = dT + (e * K + k) * M;
#pragma unroll
      for (int j = 0; j < M; ++j) o[j] = dt[j];
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename TW, int M>
int fwd(const float* T, const TW* W, float* out, int E, int K, int Wd,
        cudaStream_t stream) {
  const int wcols = Wd < kThreads ? Wd : kThreads;
  const int ks = kThreads / wcols;
  const size_t smem = sizeof(float) * ((size_t)K * M + (size_t)ks * wcols * M);
  cudaError_t err = allow_smem(contract_fwd<TW, M>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)E, (unsigned)((Wd + wcols - 1) / wcols));
  contract_fwd<TW, M><<<grid, kThreads, smem, stream>>>(T, W, out, K, Wd,
                                                        wcols, ks);
  return (int)cudaGetLastError();
}

template <typename TW, int M>
int bwd(const float* T, const TW* W, const float* dO, float* dT, TW* dW, int E,
        int K, int Wd, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)K * M + (size_t)Wd * M);
  cudaError_t err = allow_smem(contract_bwd<TW, M>, smem);
  if (err != cudaSuccess) return (int)err;
  contract_bwd<TW, M><<<(unsigned)E, kThreads, smem, stream>>>(T, W, dO, dT,
                                                               dW, K, Wd);
  return (int)cudaGetLastError();
}

// Dispatch on m (odd, 1..15: 2l+1) to a kernel with its sums in registers.
#define GMP_FOR_M(M_, CALL)                                             \
  switch (M_) {                                                         \
    case 1: { constexpr int M = 1; return CALL; }                       \
    case 3: { constexpr int M = 3; return CALL; }                       \
    case 5: { constexpr int M = 5; return CALL; }                       \
    case 7: { constexpr int M = 7; return CALL; }                       \
    case 9: { constexpr int M = 9; return CALL; }                       \
    case 11: { constexpr int M = 11; return CALL; }                     \
    case 13: { constexpr int M = 13; return CALL; }                     \
    case 15: { constexpr int M = 15; return CALL; }                     \
    default: return (int)cudaErrorInvalidValue;                         \
  }

template <typename TW>
int run_fwd(int device, const void* T, const void* W, void* out, int E, int K,
            int m, int Wd, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E == 0 || Wd == 0) return 0;
  const float* t = static_cast<const float*>(T);
  const TW* w = static_cast<const TW*>(W);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GMP_FOR_M(m, (fwd<TW, M>(t, w, o, E, K, Wd, s)))
}

template <typename TW>
int run_bwd(int device, const void* T, const void* W, const void* dO, void* dT,
            void* dW, int E, int K, int m, int Wd, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E == 0 || K == 0) return 0;
  const float* t = static_cast<const float*>(T);
  const TW* w = static_cast<const TW*>(W);
  const float* g = static_cast<const float*>(dO);
  float* dt = static_cast<float*>(dT);
  TW* dw = static_cast<TW*>(dW);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GMP_FOR_M(m, (bwd<TW, M>(t, w, g, dt, dw, E, K, Wd, s)))
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the cudaError_t of the
// launch (0 = success).  The Python wrapper (ops/edge_contract.py) checks the
// tensors.
//
// One group (gmp_contract_fwd / _bwd, the _bf16 entries for bf16 W): all
// tensors contiguous on one device: T [E, K, m] f32, W [E, K, w], out and dO
// [E, w, m] f32, dT [E, K, m] f32, dW [E, K, w] of W's type.
//
// All groups in one launch (gmp_contract_grouped): n groups, given in launch
// order: ptrs [n][6] (T, W, out, dO, dT, dW; unused ones 0) and ints [n][10]
// (E, w_stride, K, m, w, cols, ks, tpi, epb, item0) as int64, items the
// total, smem_bytes the dynamic shared memory, slot_bytes the W ring's slot,
// fofs the byte offset of the shared floats and tmax, omax the floats of a T
// and a dO buffer, bf16 W's type, vec the W values per 16-byte load (4 f32,
// 8 bf16), mmax the largest m.  The wrapper makes the plan (contract_plan)
// and the layout (smem_layout).

extern "C" const char* gmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int gmp_contract_fwd(int device, const void* T, const void* W,
                                void* out, int E, int K, int m, int Wd,
                                void* stream) {
  return run_fwd<float>(device, T, W, out, E, K, m, Wd, stream);
}

extern "C" int gmp_contract_fwd_bf16(int device, const void* T, const void* W,
                                     void* out, int E, int K, int m, int Wd,
                                     void* stream) {
  return run_fwd<__nv_bfloat16>(device, T, W, out, E, K, m, Wd, stream);
}

extern "C" int gmp_contract_bwd(int device, const void* T, const void* W,
                                const void* dO, void* dT, void* dW, int E,
                                int K, int m, int Wd, void* stream) {
  return run_bwd<float>(device, T, W, dO, dT, dW, E, K, m, Wd, stream);
}

extern "C" int gmp_contract_bwd_bf16(int device, const void* T, const void* W,
                                     const void* dO, void* dT, void* dW, int E,
                                     int K, int m, int Wd, void* stream) {
  return run_bwd<__nv_bfloat16>(device, T, W, dO, dT, dW, E, K, m, Wd, stream);
}

extern "C" int gmp_contract_grouped(int device, int bwd, int n,
                                    const void* ptrs, const void* ints,
                                    int items, int smem_bytes, int slot_bytes,
                                    int fofs, int tmax, int omax, int bf16,
                                    int vec, int mmax, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || n > kMaxGroups || mmax < 1 || mmax > 15)
    return (int)cudaErrorInvalidValue;
  if (items == 0) return 0;
  Table tab;
  tab.n = n;
  tab.items = items;
  tab.slot_bytes = slot_bytes;
  tab.fofs = fofs;
  tab.tmax = tmax;
  tab.omax = omax;
  const uint64_t* p = static_cast<const uint64_t*>(ptrs);
  const int64_t* q = static_cast<const int64_t*>(ints);
  for (int i = 0; i < n; ++i, p += 6, q += 10) {
    Group& G = tab.g[i];
    G.T = reinterpret_cast<const float*>(p[0]);
    G.W = reinterpret_cast<const void*>(p[1]);
    G.out = reinterpret_cast<float*>(p[2]);
    G.dO = reinterpret_cast<const float*>(p[3]);
    G.dT = reinterpret_cast<float*>(p[4]);
    G.dW = reinterpret_cast<void*>(p[5]);
    G.E = q[0];
    G.w_stride = q[1];
    G.K = (int)q[2]; G.m = (int)q[3]; G.w = (int)q[4]; G.cols = (int)q[5];
    G.ks = (int)q[6]; G.tpi = (int)q[7]; G.epb = (int)q[8];
    G.item0 = (int)q[9];
  }
  const size_t smem = (size_t)smem_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return bwd ? dispatch<__nv_bfloat16, true>(tab, smem, vec, mmax, s)
               : dispatch<__nv_bfloat16, false>(tab, smem, vec, mmax, s);
  return bwd ? dispatch<float, true>(tab, smem, vec, mmax, s)
             : dispatch<float, false>(tab, smem, vec, mmax, s);
}
