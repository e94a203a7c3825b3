// K1's previous edge kernel with a clock reading at every weight K-tile: a
// measuring tool for bench_kernels --only k1, on no main path.
//
// The kernel is the design egnn_message.cu replaced: one block of 8 warps a
// tile of 16 edges, the weights streamed through egnn_common.cuh's ring of
// 32-row K-tiles (bulk copies on an mbarrier a slot), each K-tile behind a
// wait on its mbarrier and a block barrier.  mm_probe is egnn_common.cuh's
// mm with the readings added (that function stays as K2 and K6 run it); the
// tile's chain is edge_fwd_tile's without the kept activations.  For one
// block, thread 0 (which also issues the copies) records clock64() at each
// K-tile q of the tile's stream: when its copy was issued, when the wait for
// it began, when its mbarrier was seen complete, after the block barrier,
// and after thread 0's products on it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "egnn_common.cuh"

namespace {

using namespace egnn;

constexpr int kTE = 16;
constexpr int kMaxKTiles = 32;              // K-tiles a tile streams, D <= 256
enum Field { kIssue = 0, kBegin, kSeen, kSynced, kDone, kFields };
constexpr int kProbeSlots = 4 + kFields * kMaxKTiles;

struct Probe {
  long long* out;   // null except in the probed block's thread 0
  __device__ __forceinline__ void at(uint32_t q, int field) {
    if (out != nullptr && q < kMaxKTiles) out[4 + kFields * q + field] = clock64();
  }
};

template <int TR>
__device__ void mm_probe(const float* A, int lda, const Weights& w, const Tile& tl,
                         float* C, int ldc, const Weights* next, Probe& pr) {
  constexpr int KT = ktile_rows(8 * TR);
  constexpr int kStage = slot_floats(KT);
  const int K = w.K, N = w.N, ntiles = (K + KT - 1) / KT;
  const bool producer = threadIdx.x < 32;
  if (N > kMaxN) next = nullptr;
  if (next != nullptr && next->N > kMaxN) next = nullptr;
  const int nnext = next != nullptr ? (next->K + KT - 1) / KT : 0;
  uint32_t seq = *tl.seq;
  int pre = *tl.pre;
  for (int c0 = 0; c0 < N; c0 += kMaxN) {
    const int nc = min(kMaxN, N - c0), ncg = nc >> 2;
    const bool last = c0 + kMaxN >= N;
    const int t4 = threadIdx.x >> 2;
    const bool active = (int)threadIdx.x < 8 * ncg;
    const int cg = active ? t4 % ncg : 0;
    const int rb = active ? (t4 / ncg) * 4 + (threadIdx.x & 3) : 0;
    float acc[TR][4];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    auto issue = [&](int i) {
      if (i < ntiles) {
        stage(w.W, N, i * KT, min(KT, K - i * KT), c0, nc,
              tl.ring + ((seq + i) % kStages) * kStage, &tl.bars[(seq + i) % kStages]);
        pr.at(seq + i, kIssue);
      } else if (last && i - ntiles < min(nnext, kStages - 1)) {
        stage_tile<KT>(tl, *next, i - ntiles, seq + i);
        pr.at(seq + i, kIssue);
      }
    };
    if (producer)
      for (int i = pre; i < kStages - 1; ++i) issue(i);
    pre = 0;
    for (int t = 0; t < ntiles; ++t) {
      const uint32_t q = seq + t;
      pr.at(q, kBegin);
      bar_wait(&tl.bars[q % kStages], (q / kStages) & 1);
      pr.at(q, kSeen);
      __syncthreads();
      pr.at(q, kSynced);
      if (producer) issue(t + kStages - 1);
      if (active) {
        const int k0 = t * KT, kt = min(KT, K - k0);
        const float* wb = tl.ring + (q % kStages) * kStage + cg * 4;
        const float* a = A + (size_t)rb * lda + k0;
        int kk = 0;
        for (; kk + 4 <= kt; kk += 4) {
          float4 av[TR];
#pragma unroll
          for (int i = 0; i < TR; ++i)
            av[i] = *reinterpret_cast<const float4*>(a + (size_t)8 * i * lda + kk);
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            const float4 wv = *reinterpret_cast<const float4*>(wb + (kk + qq) * nc);
#pragma unroll
            for (int i = 0; i < TR; ++i) {
              const float x = qq == 0 ? av[i].x : qq == 1 ? av[i].y
                                                : qq == 2 ? av[i].z : av[i].w;
              acc[i][0] = fmaf(x, wv.x, acc[i][0]);
              acc[i][1] = fmaf(x, wv.y, acc[i][1]);
              acc[i][2] = fmaf(x, wv.z, acc[i][2]);
              acc[i][3] = fmaf(x, wv.w, acc[i][3]);
            }
          }
        }
        for (; kk < kt; ++kk) {
          const float4 wv = *reinterpret_cast<const float4*>(wb + kk * nc);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const float x = a[(size_t)8 * i * lda + kk];
            acc[i][0] = fmaf(x, wv.x, acc[i][0]);
            acc[i][1] = fmaf(x, wv.y, acc[i][1]);
            acc[i][2] = fmaf(x, wv.z, acc[i][2]);
            acc[i][3] = fmaf(x, wv.w, acc[i][3]);
          }
        }
      }
      pr.at(q, kDone);
    }
    seq += ntiles;
    __syncthreads();
    if (active) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        float* c = C + (size_t)(rb + 8 * i) * ldc + c0 + cg * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = acc[i][j];
      }
    }
  }
  if (threadIdx.x == 0) {
    *tl.seq = seq;
    *tl.pre = min(nnext, kStages - 1);
  }
  __syncthreads();
}

// LN + affine + ReLU of the tile's product rows into dst (row stride ldd)
__device__ __forceinline__ void ln_rows(const Tile& t, const float* b, int D,
                                        float* dst, int ldd) {
  Row v;
  for (int row = warp_id(); row < kTE; row += kWarps) {
    row_ln(t.C + row * t.ldd, b, D, v);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      if (lane_id() + 32 * c < D) v[c] = affine_relu(v[c], b + D, b + 2 * D, lane_id() + 32 * c);
    put_row(v, dst + row * ldd, D);
  }
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads) egnn_ring_probe_kernel(
    const Idx* __restrict__ send, const Idx* __restrict__ recv,
    const uint8_t* __restrict__ emask, const float* h, const float* pos,
    const float* __restrict__ W, float* msg_e, float* pos_e, long long* stamps,
    int probe_block, int E, int D) {
  extern __shared__ __align__(16) float smem[];
  Probe pr{blockIdx.x == (unsigned)probe_block && threadIdx.x == 0 ? stamps : nullptr};
  if (pr.out != nullptr) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(pr.out[0]));
    pr.out[2] = clock64();
  }
  ring_init(smem);
  const long long tile = blockIdx.x, e0 = tile * kTE;
  const Tile t = carve(smem, kTE, D);
  const MsgWeights m = msg_weights(W, D);
  const Weights w1{m.W1, 2 * D + 1, D}, w2{m.W2, D, D}, p1{m.P1, D, D};
  __syncthreads();
  for (int q = 0; q < kStages - 1; ++q) pr.at(q, kIssue);   // prefetch's copies
  prefetch<2>(t, w1);
  gather_edges<kTE>(tile, send, recv, emask, h, pos, E, D, t, nullptr, 0);
  mm_probe<2>(t.X, t.ldx, w1, t, t.C, t.ldd, &w2, pr);
  ln_rows(t, m.b1, D, t.Y, t.ldd);
  mm_probe<2>(t.Y, t.ldd, w2, t, t.C, t.ldd, &p1, pr);
  ln_rows(t, m.b2, D, t.X, t.ldx);
  for (int row = warp_id(); row < kTE; row += kWarps) {
    const long long e = e0 + row;
    if (e < E && t.s[row * kSmall + kLive] != 0.f)
      for (int c = lane_id(); c < D; c += 32) msg_e[(size_t)e * D + c] = t.X[row * t.ldx + c];
  }
  mm_probe<2>(t.X, t.ldx, p1, t, t.C, t.ldd, nullptr, pr);
  Row v;
  for (int row = warp_id(); row < kTE; row += kWarps) {
    const long long e = e0 + row;
    row_ln(t.C + row * t.ldd, m.pb1, D, v);
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane_id() + 32 * c;
      if (col < D) s = fmaf(affine_relu(v[c], m.pg1, m.pB1, col), m.P2[col], s);
    }
    const float scale = warp_sum(s) + m.pb2;
    const float* sr = t.s + row * kSmall;
    if (e < E && sr[kLive] != 0.f && lane_id() < 3)
      pos_e[(size_t)e * 3 + lane_id()] = sr[kPd + lane_id()] * scale;
  }
  if (pr.out != nullptr) {
    pr.out[3] = clock64();
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(pr.out[1]));
  }
}

template <typename Idx>
int launch(const void* send, const void* recv, const void* emask, const void* h,
           const void* pos, const void* w, void* msg_e, void* pos_e, void* stamps,
           int probe_block, int E, int D, cudaStream_t stream) {
  const size_t smem = sizeof(float) * tile_smem_floats(kTE, D);
  cudaError_t err = cudaFuncSetAttribute(
      egnn_ring_probe_kernel<Idx>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  egnn_ring_probe_kernel<Idx><<<(E + kTE - 1) / kTE, kThreads, smem, stream>>>(
      static_cast<const Idx*>(send), static_cast<const Idx*>(recv),
      static_cast<const uint8_t*>(emask), static_cast<const float*>(h),
      static_cast<const float*>(pos), static_cast<const float*>(w),
      static_cast<float*>(msg_e), static_cast<float*>(pos_e),
      static_cast<long long*>(stamps), probe_block, E, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* gmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The previous K1 edge kernel on E edges (msg_e [E, D], pos_e [E, 3] as
// egnn_message.cu's), block probe_block's readings into stamps
// (kProbeSlots 64-bit slots: globaltimer at its start and end, clock64 at
// its start and end, then per K-tile q: issue, begin, seen, synced, done).
extern "C" int gmp_egnn_ring_probe(int device, const void* send, const void* recv,
                                   int idx64, const void* emask, const void* h,
                                   const void* pos, const void* w, void* msg_e,
                                   void* pos_e, void* stamps, int probe_block,
                                   int E, int D, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E == 0 || D > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return idx64 ? launch<long long>(send, recv, emask, h, pos, w, msg_e, pos_e, stamps,
                                   probe_block, E, D, s)
               : launch<int>(send, recv, emask, h, pos, w, msg_e, pos_e, stamps,
                             probe_block, E, D, s);
}
