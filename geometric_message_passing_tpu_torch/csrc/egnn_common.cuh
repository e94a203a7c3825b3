// Shared device code of the EGNN kernels: the message pass (egnn_message.cu,
// K1), its backward (egnn_message_bwd.cu, K2) and the whole stack
// (egnn_stack.cu and egnn_stack_bwd.cu, K6).  Exact f32 on the CUDA cores
// (no TF32).
//
// A block of 8 warps works on a tile of TE rows (edges or nodes; TE = 8, 16
// or 32, a template parameter chosen per call by the wrapper's tile rule,
// ops/edge.py::egnn_tile).  Every activation of the tile lives in
// shared memory, one row per edge or node, with a row stride of 4 mod 32
// floats (row_ld).  Two kinds of step alternate:
//   * products (mm): C = A W for the whole tile; a product with a
//     transposed weight block reads a transposed copy of it
//     (transpose_weights), so every product streams whole rows.  W streams
//     from global memory through a ring of kStages K-tiles filled by bulk
//     copies (cp.async.bulk, the TMA: warp 0 issues them, an mbarrier per
//     slot counts their bytes), kStages - 1 of them in flight while one
//     K-tile's products run; a tile's products form one stream, so the
//     next product's first K-tiles (and the first product's, before the
//     gather) are in flight during the row step between them.  A K-tile
//     of W is one contiguous run, so one copy instruction moves it; it
//     holds 32 weight rows at TE 8 and 16, 16 at TE 32 (so two blocks fit
//     an SM).  A thread owns TE/8 rows x 4 columns of C (sums in
//     registers); per four k it reads TE/8 float4 of A and four float4 of
//     W, so each staged weight feeds TE/8 FMAs in the thread and is read by
//     4 lanes at once (a broadcast).  A warp's lanes span 4 rows x 8 column
//     groups: with the row stride of 4 mod 32 its reads of A fall on
//     distinct banks.  Every sum runs over k in ascending order.
//   * row steps: a warp takes rows r = warp, warp + 8, ... and each lane
//     the columns lane + 32 c, as the LayerNorms need: bias, mean and
//     variance by warp shuffles, affine and ReLU, the LayerNorm backward;
//     the map fixes every row sum's order.
//
// Packed message rows (ops/edge.py::pack_egnn_weights, [4D+12, D]):
//   W1 [2D+1] b1 g1 B1 | W2 [D] b2 g2 B2 | P1 [D] pb1 pg1 pB1 | P2 | pb2 (col 0)
// and, for the stack, the update MLP after them ([3D+6, D]):
//   U1 [2D] ub1 ug1 uB1 | U2 [D] ub2 ug2 uB2.
// The weights must be 16-byte aligned (the wrappers check it).
//
// Buffers that another block of the same launch writes (the stack's node
// state, per-edge messages, kept activations, cotangents) are read with
// __ldcg (L2, not L1), so a persistent kernel never reads a stale line after
// its grid barrier.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace egnn {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxN = 128;       // output columns per pass of a product
constexpr int kStages = 4;       // ring slots: 3 K-tiles in flight
constexpr int kMaxCols = 8;      // columns per lane in a row step, D <= 256
constexpr int kVecRows = 11;     // vector rows of the message dW
constexpr int kTile = 32;        // dW tile (rows, cols, rows summed)
constexpr int kSmall = 12;       // per-row scalars of a tile (see Tile)
constexpr float kEps = 1e-5f;

// Weight rows per staged K-tile at tile TE; the floats of one ring slot (a
// K-tile of KT rows x kMaxN columns) and of the ring
__host__ __device__ constexpr int ktile_rows(int TE) { return TE >= 32 ? 16 : 32; }
__host__ __device__ constexpr int slot_floats(int KT) { return KT * kMaxN; }
__host__ __device__ constexpr int ring_floats(int TE) {
  return kStages * slot_floats(ktile_rows(TE));
}
// Row stride of a tile's activation rows of n floats: 4 mod 32, so the 4
// rows a warp reads at one k (float4 each) fall on distinct banks
__host__ __device__ constexpr int row_ld(int n) { return (n + 27) / 32 * 32 + 4; }

// Floats of the kept forward activations of one edge (the stack's backward
// and K2): xhat of the three LayerNorms, their rstd, the scale head's value
// (act_edge_ld), and of one node: xhat of the update MLP's two LayerNorms
// and their rstd (act_node_ld).
__host__ __device__ constexpr int act_edge_ld(int D) { return 3 * D + 4; }
__host__ __device__ constexpr int act_node_ld(int D) { return 2 * D + 4; }

// Columns of an edge's row of weight-gradient operands (`ops`, written by
// edge_bwd_tile): x [2D+1] from 0 (3 pad), m [D] from ops_m, msg [D] from
// ops_msg, the 11 vector rows [D each] from ops_vec; row stride
// ops_edge_ld, a multiple of 4 floats, so every operand row starts 16-byte
// aligned (wgrad_tile's copies).
__host__ __device__ constexpr int ops_m(int D) { return 2 * D + 4; }
__host__ __device__ constexpr int ops_msg(int D) { return 3 * D + 4; }
__host__ __device__ constexpr int ops_vec(int D) { return 4 * D + 4; }
__host__ __device__ constexpr int ops_edge_ld(int D) { return 15 * D + 4; }

// The first kHead floats of a kernel's shared memory: the ring's kStages
// mbarriers, the count of K-tiles staged so far (Tile::seq) and of the next
// product's K-tiles already issued (Tile::pre).
constexpr int kHead = 16;

// Shared memory of a tile (floats): the head, X [TE, row_ld(2D+1)] (an
// edge's x = [h_i, h_j, |d|], a node's [h, msg_sum]; later a row of D), Y
// and C [TE, row_ld(D)], kSmall scalars per row, the K-tile ring.
struct Layout {
  int ldx, ldd;
  int x, y, c, small, ring, total;
};

__host__ __device__ inline Layout tile_layout(int TE, int D) {
  Layout l;
  l.ldx = row_ld(2 * D + 1);
  l.ldd = row_ld(D);
  l.x = kHead;
  l.y = l.x + TE * l.ldx;
  l.c = l.y + TE * l.ldd;
  l.small = l.c + TE * l.ldd;
  l.ring = l.small + TE * kSmall;   // a multiple of 4: float4 reads
  l.total = l.ring + ring_floats(TE);
  return l;
}

// The per-row scalars (Tile::s + row * kSmall + field)
enum Small { kPd = 0, kInv = 3, kScale = 4, kDdist = 5, kPnew = 6, kLive = 9 };

struct Tile {
  float *X, *Y, *C, *s, *ring;
  uint64_t* bars;   // the ring's mbarriers
  uint32_t* seq;    // K-tiles staged so far: K-tile q uses slot q % kStages
  uint32_t* pre;    // K-tiles of the next product already issued
  int ldx, ldd;
};

__device__ __forceinline__ Tile carve(float* smem, int TE, int D) {
  const Layout l = tile_layout(TE, D);
  return Tile{smem + l.x, smem + l.y, smem + l.c, smem + l.small,
              smem + l.ring, reinterpret_cast<uint64_t*>(smem),
              reinterpret_cast<uint32_t*>(smem + 2 * kStages),
              reinterpret_cast<uint32_t*>(smem + 2 * kStages + 1), l.ldx, l.ldd};
}

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same (bitwise) sum
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }

// ---------------------------------------------------------------------------
// The product
// ---------------------------------------------------------------------------

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
// Wait for the phase of parity `parity` of bar; traps (a launch error, not a
// hang) if it has not completed after some 2^28 polls.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (tries == (1u << 28)) __trap();
  }
}

// Before a kernel's first tile: the ring's mbarriers and K-tile count.
__device__ __forceinline__ void ring_init(float* smem) {
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
    for (int q = 0; q < kStages; ++q) bar_init(&bars[q]);
    *reinterpret_cast<uint32_t*>(smem + 2 * kStages) = 0;       // seq
    *reinterpret_cast<uint32_t*>(smem + 2 * kStages + 1) = 0;   // pre
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Warp 0 starts the bulk copy of rows [k0, k0 + kt) x columns [c0, c0 +
// nc) of W [K, N] (row-major) into buf (row stride nc), completing on bar:
// one copy when the rows are whole (nc == N), else one per row.  Every run
// is a multiple of 16 bytes on 16-byte boundaries (nc and N multiples of
// 4).  The slot was read by the block before the __syncthreads that
// precedes this: the proxy fence orders those reads before the copy's
// writes.
__device__ __forceinline__ void stage(const float* __restrict__ W, int N, int k0,
                                      int kt, int c0, int nc, float* buf,
                                      uint64_t* bar) {
  const int lane = lane_id();
  const bool whole = nc == N;
  const int copies = whole ? 1 : kt;
  const uint32_t bytes = 4u * (whole ? kt * N : nc);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (lane == 0) bar_expect(bar, bytes * copies);
  __syncwarp();
  for (int j = lane; j < copies; j += 32)
    bulk_load(buf + (size_t)j * nc,
              whole ? W + (size_t)k0 * N : W + (size_t)(k0 + j) * N + c0, bytes,
              bar);
}

// One product of a tile's chain: W [K, N] row-major (N a multiple of 4).
struct Weights {
  const float* W;
  int K, N;
};

// Warp 0 issues K-tile u (the first pass's) of w into stream position q.
template <int KT>
__device__ __forceinline__ void stage_tile(const Tile& tl, const Weights& w,
                                           int u, uint32_t q) {
  const int slot = q % kStages;
  stage(w.W, w.N, u * KT, min(KT, w.K - u * KT), 0, min(kMaxN, w.N),
        tl.ring + slot * slot_floats(KT), &tl.bars[slot]);
}

// Issue the first K-tiles of the product w of a tile with TR = TE / 8 ahead
// of it (the ring is free: called after a __syncthreads), so they arrive
// while the block gathers or runs a row step; mm<TR>(..., w, ...) takes
// them.  Only for a product of one pass (N <= kMaxN).
template <int TR>
__device__ __forceinline__ void prefetch(const Tile& tl, const Weights& w) {
  constexpr int KT = ktile_rows(8 * TR);
  if (w.N > kMaxN) return;
  const uint32_t seq = *tl.seq;
  const int n = min(kStages - 1, (w.K + KT - 1) / KT);
  if (threadIdx.x < 32)
    for (int u = 0; u < n; ++u) stage_tile<KT>(tl, w, u, seq + u);
  __syncthreads();
  if (threadIdx.x == 0) *tl.pre = n;
  __syncthreads();
}

// C[r * ldc + c] = sum_k A[r * lda + k] * W[k * N + c] for r < 8 TR, c < N,
// in K-tiles of ktile_rows(8 TR) rows through the tile's ring.  A and C lie
// in shared memory, 16-byte aligned, with lda a multiple of 4, and must not
// overlap.  Columns go in passes of kMaxN; in a pass thread t owns rows
// rb + 8 i (i < TR) and columns 4 cg .. 4 cg + 3 (rb = 4 (t / 4 / ncg) +
// t % 4, cg = (t / 4) % ncg), and per four k reads TR float4 of A and four
// float4 of the staged weights.  The ring is one stream of K-tiles: when
// `next` (the chain's next product, of one pass) is given and this product
// has one pass, the K-tiles that free up at its end take the first K-tiles
// of next, so its weights arrive during the row step between the two.
// Starts and ends with __syncthreads: A must be complete when it is
// called, C is complete when it returns.
template <int TR>
__device__ void mm(const float* A, int lda, const Weights& w, const Tile& tl,
                   float* C, int ldc, const Weights* next = nullptr) {
  constexpr int KT = ktile_rows(8 * TR);
  constexpr int kStage = slot_floats(KT);
  const int K = w.K, N = w.N, ntiles = (K + KT - 1) / KT;
  const bool producer = threadIdx.x < 32;
  if (N > kMaxN) next = nullptr;
  if (next != nullptr && next->N > kMaxN) next = nullptr;
  const int nnext = next != nullptr ? (next->K + KT - 1) / KT : 0;
  uint32_t seq = *tl.seq;   // stream position of this product's K-tile 0
  int pre = *tl.pre;        // its K-tiles already issued
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
    // stream item i: this pass's K-tile i, then (last pass) next's K-tile
    // i - ntiles; kStages - 1 items in flight ahead of the one in use
    auto issue = [&](int i) {
      if (i < ntiles)
        stage(w.W, N, i * KT, min(KT, K - i * KT), c0, nc,
              tl.ring + ((seq + i) % kStages) * kStage, &tl.bars[(seq + i) % kStages]);
      else if (last && i - ntiles < min(nnext, kStages - 1))
        stage_tile<KT>(tl, *next, i - ntiles, seq + i);
    };
    if (producer)
      for (int i = pre; i < kStages - 1; ++i) issue(i);
    pre = 0;
    for (int t = 0; t < ntiles; ++t) {
      const uint32_t q = seq + t;
      bar_wait(&tl.bars[q % kStages], (q / kStages) & 1);
      __syncthreads();   // K-tile t (and A) visible; K-tile t - 1 consumed
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
    }
    seq += ntiles;
    __syncthreads();   // the ring's consumed slots are free
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

// ---------------------------------------------------------------------------
// Row steps (a warp per row; lane l owns columns l + 32 c)
// ---------------------------------------------------------------------------

typedef float Row[kMaxCols];

// v <- xhat of (crow + bias) over the row's D columns (0 past D); returns
// rstd.
__device__ __forceinline__ float row_ln(const float* crow, const float* __restrict__ bias,
                                        int D, Row& v) {
  const int lane = lane_id();
  const float inv_d = 1.f / (float)D;
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int col = lane + 32 * c;
    v[c] = 0.f;
    if (col < D) {
      v[c] = crow[col] + bias[col];
      s += v[c];
    }
  }
  const float mu = warp_sum(s) * inv_d;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int col = lane + 32 * c;
    if (col < D) {
      v[c] -= mu;
      q += v[c] * v[c];
    }
  }
  const float rstd = 1.f / sqrtf(warp_sum(q) * inv_d + kEps);
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) v[c] *= rstd;
  return rstd;
}

// relu(xhat * gamma + beta) at the lane's column c
__device__ __forceinline__ float affine_relu(float xh, const float* __restrict__ gamma,
                                             const float* __restrict__ beta, int col) {
  return fmaxf(fmaf(xh, gamma[col], beta[col]), 0.f);
}

// dy <- dz = rstd * (dy*g - mean(dy*g) - xhat * mean(dy*g*xhat)): LayerNorm
// backward to its input (0 past D).
__device__ __forceinline__ void row_ln_bwd(Row& dy, const Row& xh, float rstd,
                                           const float* __restrict__ gamma, int D) {
  const int lane = lane_id();
  const float inv_d = 1.f / (float)D;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int col = lane + 32 * c;
    if (col < D) {
      dy[c] *= gamma[col];       // dxhat
      s1 += dy[c];
      s2 += dy[c] * xh[c];
    }
  }
  const float m1 = warp_sum(s1) * inv_d, m2 = warp_sum(s2) * inv_d;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c)
    dy[c] = lane + 32 * c < D ? rstd * (dy[c] - m1 - xh[c] * m2) : 0.f;
}

// row[col] = v (times w when given) for the lane's columns < D
__device__ __forceinline__ void put_row(const Row& v, float* row, int D) {
  const int lane = lane_id();
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c)
    if (lane + 32 * c < D) row[lane + 32 * c] = v[c];
}

__device__ __forceinline__ void put_row(const Row& v, const Row& w, float* row, int D) {
  const int lane = lane_id();
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c)
    if (lane + 32 * c < D) row[lane + 32 * c] = v[c] * w[c];
}

// v = row[col] (0 past D), through L2
__device__ __forceinline__ void get_row_cg(const float* row, int D, Row& v) {
  const int lane = lane_id();
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c)
    v[c] = lane + 32 * c < D ? __ldcg(row + lane + 32 * c) : 0.f;
}

__device__ __forceinline__ void zero_row(Row& v) {
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) v[c] = 0.f;
}

// Offsets of the packed message rows (see the top of this file).
struct MsgWeights {
  const float *W1, *b1, *g1, *B1, *W2, *b2, *g2, *B2, *P1, *pb1, *pg1, *pB1, *P2;
  float pb2;
};

__device__ __forceinline__ MsgWeights msg_weights(const float* W, int D) {
  MsgWeights m;
  m.W1 = W;
  m.b1 = m.W1 + (size_t)(2 * D + 1) * D;
  m.g1 = m.b1 + D;
  m.B1 = m.g1 + D;
  m.W2 = m.B1 + D;
  m.b2 = m.W2 + (size_t)D * D;
  m.g2 = m.b2 + D;
  m.B2 = m.g2 + D;
  m.P1 = m.B2 + D;
  m.pb1 = m.P1 + (size_t)D * D;
  m.pg1 = m.pb1 + D;
  m.pB1 = m.pg1 + D;
  m.P2 = m.pB1 + D;
  m.pb2 = m.P2[D];  // column 0 of the last row
  return m;
}

// Offsets of the update MLP rows (Wu = the layer's rows from 4D+12 on).
struct UpdWeights {
  const float *U1, *ub1, *ug1, *uB1, *U2, *ub2, *ug2, *uB2;
};

__device__ __forceinline__ UpdWeights upd_weights(const float* Wu, int D) {
  UpdWeights u;
  u.U1 = Wu;
  u.ub1 = u.U1 + (size_t)2 * D * D;
  u.ug1 = u.ub1 + D;
  u.uB1 = u.ug1 + D;
  u.U2 = u.uB1 + D;
  u.ub2 = u.U2 + (size_t)D * D;
  u.ug2 = u.ub2 + D;
  u.uB2 = u.ug2 + D;
  return u;
}

// ---------------------------------------------------------------------------
// The message pass on one tile of edges
// ---------------------------------------------------------------------------

// Gather x = [h_i, h_j, |d|] of edges [TE tile, TE tile + TE) into X (zero
// rows for masked-off edges and edges past E) and each row's position
// difference, inverse distance and live flag into the row scalars; with
// ops, also x and 3 zeros into ops[e][0 : 2D+4] (row stride ld_ops) for
// e < E.
template <int TE, typename Idx>
__device__ void gather_edges(long long tile, const Idx* __restrict__ send,
                             const Idx* __restrict__ recv,
                             const uint8_t* __restrict__ emask, const float* h,
                             const float* pos, long long E, int D, const Tile& t,
                             float* ops, size_t ld_ops) {
  const int lane = lane_id(), K1 = 2 * D + 1;
  const long long e0 = tile * TE;
  for (int row = warp_id(); row < TE; row += kWarps) {
    const long long e = e0 + row;
    // the mask and both endpoints in one round of loads
    long long i = 0, j = 0;
    bool live = false;
    if (e < E) {
      live = emask[e] != 0;
      i = (long long)recv[e];
      j = (long long)send[e];
    }
    float* x = t.X + row * t.ldx;
    float* s = t.s + row * kSmall;
    if (live) {
      for (int c = lane; c < D; c += 32) {
        x[c] = __ldcg(h + i * D + c);
        x[D + c] = __ldcg(h + j * D + c);
      }
      if (lane == 0) {
        const float dx = __ldcg(pos + 3 * i) - __ldcg(pos + 3 * j);
        const float dy = __ldcg(pos + 3 * i + 1) - __ldcg(pos + 3 * j + 1);
        const float dz = __ldcg(pos + 3 * i + 2) - __ldcg(pos + 3 * j + 2);
        const float sq = dx * dx + dy * dy + dz * dz;
        const bool positive = sq > 1e-24f;
        const float dist = positive ? sqrtf(sq) : 0.f;
        x[2 * D] = dist;
        s[kInv] = positive ? 1.f / dist : 0.f;
        s[kPd] = dx;
        s[kPd + 1] = dy;
        s[kPd + 2] = dz;
      }
    } else {
      for (int c = lane; c < K1; c += 32) x[c] = 0.f;
      if (lane < 4) s[lane] = 0.f;   // pd, inv
    }
    if (lane == 0) s[kLive] = live ? 1.f : 0.f;
    if (ops != nullptr && e < E) {
      __syncwarp();
      for (int c = lane; c < K1 + 3; c += 32)
        ops[(size_t)e * ld_ops + c] = c < K1 ? x[c] : 0.f;
    }
  }
}

// Floats of shared memory edge_fwd_tile, edge_bwd_tile, node_fwd_tile and
// node_bwd_tile need at tile TE.
__host__ __device__ inline int tile_smem_floats(int TE, int D) {
  return tile_layout(TE, D).total;
}

// Forward of edges [TE tile, TE tile + TE): the message MLP and the scale
// head, writing msg [E, D] (when msg_e is given) and pos_msg [E, 3] (when
// pos_e is given) for the live edges and, when act is given, each edge's
// row of kept activations [E, act_edge_ld(D)] = [xhat1 | xhat2 | xhat3 |
// rstd1 rstd2 rstd3 scale] for every edge < E.
template <int TE, typename Idx>
__device__ void edge_fwd_tile(
    long long tile, const Idx* __restrict__ send, const Idx* __restrict__ recv,
    const uint8_t* __restrict__ emask, const float* h, const float* pos,
    const float* __restrict__ W, float* msg_e, float* pos_e, float* act,
    long long E, int D, float* smem) {
  constexpr int TR = TE / 8;
  const Tile t = carve(smem, TE, D);
  const int K1 = 2 * D + 1, lane = lane_id();
  const size_t lda = act_edge_ld(D);
  const long long e0 = tile * TE;
  const MsgWeights m = msg_weights(W, D);
  const Weights w1{m.W1, K1, D}, w2{m.W2, D, D}, p1{m.P1, D, D};
  Row v;
  __syncthreads();   // the previous tile's rows are consumed
  prefetch<TR>(t, w1);   // W1's first K-tiles arrive during the gather
  gather_edges<TE>(tile, send, recv, emask, h, pos, E, D, t, nullptr, 0);

  mm<TR>(t.X, t.ldx, w1, t, t.C, t.ldd, &w2);   // m = relu(LN1(x W1 + b1))
  for (int row = warp_id(); row < TE; row += kWarps) {
    const long long e = e0 + row;
    const float rstd = row_ln(t.C + row * t.ldd, m.b1, D, v);
    if (act != nullptr && e < E) {
      put_row(v, act + (size_t)e * lda, D);
      if (lane == 0) act[(size_t)e * lda + 3 * D] = rstd;
    }
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      if (lane + 32 * c < D) v[c] = affine_relu(v[c], m.g1, m.B1, lane + 32 * c);
    put_row(v, t.Y + row * t.ldd, D);
  }
  mm<TR>(t.Y, t.ldd, w2, t, t.C, t.ldd, &p1);   // msg = relu(LN2(m W2 + b2))
  for (int row = warp_id(); row < TE; row += kWarps) {
    const long long e = e0 + row;
    const float rstd = row_ln(t.C + row * t.ldd, m.b2, D, v);
    if (act != nullptr && e < E) {
      put_row(v, act + (size_t)e * lda + D, D);
      if (lane == 0) act[(size_t)e * lda + 3 * D + 1] = rstd;
    }
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      if (lane + 32 * c < D) v[c] = affine_relu(v[c], m.g2, m.B2, lane + 32 * c);
    put_row(v, t.X + row * t.ldx, D);
    if (msg_e != nullptr && t.s[row * kSmall + kLive] != 0.f)
      put_row(v, msg_e + (size_t)e * D, D);
  }
  mm<TR>(t.X, t.ldx, p1, t, t.C, t.ldd);        // p = relu(LN3(msg P1 + pb1))
  for (int row = warp_id(); row < TE; row += kWarps) {
    const long long e = e0 + row;
    const float rstd = row_ln(t.C + row * t.ldd, m.pb1, D, v);
    if (act != nullptr && e < E) {
      put_row(v, act + (size_t)e * lda + 2 * D, D);
      if (lane == 0) act[(size_t)e * lda + 3 * D + 2] = rstd;
    }
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) s = fmaf(affine_relu(v[c], m.pg1, m.pB1, col), m.P2[col], s);
    }
    const float scale = warp_sum(s) + m.pb2;
    const float* sr = t.s + row * kSmall;
    if (act != nullptr && e < E && lane == 0) act[(size_t)e * lda + 3 * D + 3] = scale;
    if (pos_e != nullptr && sr[kLive] != 0.f && lane < 3)
      pos_e[(size_t)e * 3 + lane] = sr[kPd + lane] * scale;
  }
}

// The message backward on edges [TE tile, TE tile + TE), from the kept
// activations act [E, act_edge_ld(D)] of edge_fwd_tile, the transposed
// weights wt (transpose_msg_weights) and the cotangents gmsg [N, D], gpos
// [N, 3] of the receiver sums.  Writes per edge: dh_i,
// dh_j [E, D], dpd [E, 3] and one row of `ops` [E, ops_edge_ld(D)]: the left
// operands of the weight products (x, m, msg) and, in packed-row order, the
// per-edge terms whose sums over edges are the vector rows of dW (dz1,
// dy1*xhat1, dy1, dz2, ..., p*dscale, [dscale, 0, ...]).  Masked-off edges
// write zero rows.
template <int TE, typename Idx>
__device__ void edge_bwd_tile(
    long long tile, const Idx* __restrict__ send, const Idx* __restrict__ recv,
    const uint8_t* __restrict__ emask, const float* h, const float* pos,
    const float* __restrict__ W, const float* wt, const float* act,
    const float* gmsg, const float* gpos, float* ops, float* dhi, float* dhj,
    float* dpd_e, long long E, int D, float* smem) {
  constexpr int TR = TE / 8;
  const Tile t = carve(smem, TE, D);
  const int K1 = 2 * D + 1, lane = lane_id();
  const size_t ld = ops_edge_ld(D), lda = act_edge_ld(D), dd = (size_t)D * D;
  float* const vec = ops + ops_vec(D);     // column of the first vector row
  const long long e0 = tile * TE;
  // P1^T, W2^T, W1[:D]^T, W1[D:2D]^T
  const Weights p1t{wt, D, D}, w2t{wt + dd, D, D}, w1it{wt + 2 * dd, D, D},
      w1jt{wt + 3 * dd, D, D};
  __syncthreads();   // the previous tile's rows are consumed
  prefetch<TR>(t, p1t);
  gather_edges<TE>(tile, send, recv, emask, h, pos, E, D, t, ops, ld);
  __syncthreads();   // the row scalars
  const MsgWeights m = msg_weights(W, D);
  Row v, xh, u;
  // Rows past E and masked-off rows: dz is 0, and a masked-off row's ops
  // columns past x are 0
  for (int row = warp_id(); row < TE; row += kWarps) {
    const long long e = e0 + row;
    if (e < E && t.s[row * kSmall + kLive] != 0.f) continue;
    for (int c = lane; c < D; c += 32) t.Y[row * t.ldd + c] = 0.f;
    if (e < E)
      for (int c = ops_m(D) + lane; c < (int)ld; c += 32) ops[(size_t)e * ld + c] = 0.f;
    if (lane == 0) t.s[row * kSmall + kScale] = t.s[row * kSmall + kDdist] = 0.f;
  }

  // ---- scale head and LN3 -> dz3; m and msg into ops ----
  for (int row = warp_id(); row < TE; row += kWarps) {
    const long long e = e0 + row;
    const float* sr = t.s + row * kSmall;
    if (e >= E || sr[kLive] == 0.f) continue;
    const float* a = act + (size_t)e * lda;
    float* o = vec + (size_t)e * ld;
    // every load of the row first: the stores below may alias them
    const float* g = gpos + 3 * (long long)recv[e];
    const float g0 = __ldcg(g), g1 = __ldcg(g + 1), g2 = __ldcg(g + 2);
    const float rstd3 = __ldcg(a + 3 * D + 2), scale = __ldcg(a + 3 * D + 3);
    get_row_cg(a, D, xh);
    get_row_cg(a + D, D, u);
    // m and msg, the left operands of dW2 and dP1
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      v[c] = lane + 32 * c < D ? affine_relu(xh[c], m.g1, m.B1, lane + 32 * c) : 0.f;
    get_row_cg(a + 2 * D, D, xh);
    put_row(v, ops + (size_t)e * ld + ops_m(D), D);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      v[c] = lane + 32 * c < D ? affine_relu(u[c], m.g2, m.B2, lane + 32 * c) : 0.f;
    put_row(v, ops + (size_t)e * ld + ops_msg(D), D);
    // dscale = gpos[recv] . pd; the P2 term p * dscale, the pb2 row
    const float dscale = g0 * sr[kPd] + g1 * sr[kPd + 1] + g2 * sr[kPd + 2];
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      u[c] = col < D ? affine_relu(xh[c], m.pg1, m.pB1, col) : 0.f;   // p
      v[c] = u[c] * dscale;
    }
    put_row(v, o + 9 * D, D);
    for (int col = lane; col < D; col += 32) o[10 * D + col] = col == 0 ? dscale : 0.f;
    // dy3 = dscale * P2 where p > 0
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      v[c] = (col < D && u[c] > 0.f) ? dscale * m.P2[col] : 0.f;
    }
    put_row(v, xh, o + 7 * D, D);              // dy3 * xhat3
    put_row(v, o + 8 * D, D);                  // dy3
    row_ln_bwd(v, xh, rstd3, m.pg1, D);
    put_row(v, o + 6 * D, D);                  // dz3
    put_row(v, t.Y + row * t.ldd, D);
    if (lane == 0) t.s[row * kSmall + kScale] = scale;
  }

  // ---- dmsg = gmsg[recv] + dz3 P1^T; LN2 -> dz2 ----
  mm<TR>(t.Y, t.ldd, p1t, t, t.C, t.ldd, &w2t);
  for (int row = warp_id(); row < TE; row += kWarps) {
    const long long e = e0 + row;
    if (e >= E || t.s[row * kSmall + kLive] == 0.f) continue;
    const float* a = act + (size_t)e * lda;
    float* o = vec + (size_t)e * ld;
    const float rstd2 = __ldcg(a + 3 * D + 1);
    get_row_cg(gmsg + (size_t)recv[e] * D, D, u);
    get_row_cg(a + D, D, xh);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      v[c] = (col < D && affine_relu(xh[c], m.g2, m.B2, col) > 0.f)
                 ? u[c] + t.C[row * t.ldd + col] : 0.f;   // dy2
    }
    put_row(v, xh, o + 4 * D, D);
    put_row(v, o + 5 * D, D);
    row_ln_bwd(v, xh, rstd2, m.g2, D);
    put_row(v, o + 3 * D, D);                  // dz2
    put_row(v, t.Y + row * t.ldd, D);
  }

  // ---- dm = dz2 W2^T; LN1 -> dz1; ddist = dz1 . W1[2D] ----
  mm<TR>(t.Y, t.ldd, w2t, t, t.C, t.ldd, &w1it);
  for (int row = warp_id(); row < TE; row += kWarps) {
    const long long e = e0 + row;
    if (e >= E || t.s[row * kSmall + kLive] == 0.f) continue;
    const float* a = act + (size_t)e * lda;
    float* o = vec + (size_t)e * ld;
    const float rstd1 = __ldcg(a + 3 * D);
    get_row_cg(a, D, xh);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      v[c] = (col < D && affine_relu(xh[c], m.g1, m.B1, col) > 0.f)
                 ? t.C[row * t.ldd + col] : 0.f;   // dy1
    }
    put_row(v, xh, o + 1 * D, D);
    put_row(v, o + 2 * D, D);
    row_ln_bwd(v, xh, rstd1, m.g1, D);
    put_row(v, o, D);                          // dz1
    put_row(v, t.Y + row * t.ldd, D);
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) s = fmaf(v[c], m.W1[(size_t)2 * D * D + col], s);
    }
    s = warp_sum(s);
    if (lane == 0) t.s[row * kSmall + kDdist] = s;
  }

  // ---- dh_i = dz1 W1[:D]^T, dh_j = dz1 W1[D:2D]^T ----
  for (int part = 0; part < 2; ++part) {
    mm<TR>(t.Y, t.ldd, part == 0 ? w1it : w1jt, t, t.C, t.ldd,
           part == 0 ? &w1jt : nullptr);
    float* out = part == 0 ? dhi : dhj;
    for (int row = warp_id(); row < TE; row += kWarps) {
      const long long e = e0 + row;
      if (e >= E) continue;
      const bool live = t.s[row * kSmall + kLive] != 0.f;
      for (int c = lane; c < D; c += 32)
        out[(size_t)e * D + c] = live ? t.C[row * t.ldd + c] : 0.f;
    }
  }

  // dpd = gpos[recv] * scale + ddist * pd * inv
  for (int row = warp_id(); row < TE; row += kWarps) {
    const long long e = e0 + row;
    if (e >= E || lane >= 3) continue;
    const float* sr = t.s + row * kSmall;
    dpd_e[(size_t)e * 3 + lane] =
        sr[kLive] != 0.f
            ? __ldcg(gpos + 3 * (long long)recv[e] + lane) * sr[kScale] +
                  sr[kDdist] * sr[kPd + lane] * sr[kInv]
            : 0.f;
  }
}

// The transposed [D, D] weight blocks the backward multiplies by, for one
// layer's packed rows W (with the update rows when upd): wt[m][k][c] =
// S_m[c][k] for S = P1, W2, W1[:D], W1[D:2D] and then U2, U1[:D], U1[D:2D];
// element i of the blocks for i = first, first + step, ...  Sums over k
// keep their order: the products read wt's rows as they read W's columns.
__device__ __forceinline__ void transpose_weights(const float* W, float* wt,
                                                  int D, bool upd, size_t first,
                                                  size_t step) {
  const MsgWeights m = msg_weights(W, D);
  const UpdWeights u = upd_weights(W + (size_t)(4 * D + 12) * D, D);
  const size_t dd = (size_t)D * D;
  const float* src[7] = {m.P1, m.W2, m.W1, m.W1 + dd, u.U2, u.U1, u.U1 + dd};
  for (size_t i = first; i < (upd ? 7 : 4) * dd; i += step) {
    const size_t blk = i / dd, r = i - blk * dd, k = r / D, c = r - k * D;
    wt[i] = src[blk][c * D + k];
  }
}

// One warp per node: out_h = sum of dh_i over its receiver row + sum of dh_j
// over its sender row (+ base_h), out_pos = sum of dpd (receiver row) - sum
// of dpd (sender row) (+ base_pos); ascending edge order within each row.
// base_pos may be out_pos (each lane reads its entry before writing it).
__device__ __forceinline__ void node_grad_sum(
    long long node, const int64_t* __restrict__ order_r,
    const int64_t* __restrict__ rowptr_r, const int64_t* __restrict__ order_s,
    const int64_t* __restrict__ rowptr_s, const float* dhi, const float* dhj,
    const float* dpd_e, const float* base_h, const float* base_pos,
    float* out_h, float* out_pos, int D) {
  const int lane = lane_id();
  float acc[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) acc[c] = 0.f;
  float pacc = 0.f;
  for (int side = 0; side < 2; ++side) {
    const int64_t* order = side == 0 ? order_r : order_s;
    const int64_t end = (side == 0 ? rowptr_r : rowptr_s)[node + 1];
    const float* rows = side == 0 ? dhi : dhj;
    for (int64_t k0 = (side == 0 ? rowptr_r : rowptr_s)[node]; k0 < end; k0 += 32) {
      // the row's next 32 edge ids in one load, then each edge in order
      const int cnt = end - k0 < 32 ? (int)(end - k0) : 32;
      const int64_t mine = lane < cnt ? order[k0 + lane] : 0;
      for (int j = 0; j < cnt; j += 4) {
        // 4 edges' loads in flight, then their adds in edge order
        float vals[4][kMaxCols], pv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j + u >= cnt) break;
          const int64_t e = __shfl_sync(0xffffffffu, mine, j + u);
          const float* g = rows + (size_t)e * D;
#pragma unroll
          for (int c = 0; c < kMaxCols; ++c) {
            const int col = lane + 32 * c;
            vals[u][c] = col < D ? __ldcg(g + col) : 0.f;
          }
          pv[u] = lane < 3 ? __ldcg(dpd_e + (size_t)e * 3 + lane) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j + u >= cnt) break;
#pragma unroll
          for (int c = 0; c < kMaxCols; ++c)
            if (lane + 32 * c < D) acc[c] += vals[u][c];
          if (lane < 3) pacc = side == 0 ? pacc + pv[u] : pacc - pv[u];
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int col = lane + 32 * c;
    if (col < D)
      out_h[(size_t)node * D + col] =
          base_h ? __ldcg(base_h + (size_t)node * D + col) + acc[c] : acc[c];
  }
  if (lane < 3)
    out_pos[(size_t)node * 3 + lane] =
        base_pos ? __ldcg(base_pos + (size_t)node * 3 + lane) + pacc : pacc;
}

// ---------------------------------------------------------------------------
// Weight gradients: sums over rows (edges or nodes) of per-row operands,
// over fixed slices of rows, with no atomics.
// ---------------------------------------------------------------------------

// One matrix of dW: part[row0 + k][c] = sum_e ops[e][lcol + k] * ops[e][rcol + c]
// for k < K, c < D.
struct Stage {
  int K, lcol, rcol, row0;
};

// The message weights' three matrices in edge_bwd_tile's `ops` rows.
__device__ __forceinline__ Stage msg_stage(int s, int D) {
  const int v0 = ops_vec(D);
  if (s == 0) return Stage{2 * D + 1, 0, v0, 0};
  if (s == 1) return Stage{D, ops_m(D), v0 + 3 * D, 2 * D + 4};
  return Stage{D, ops_msg(D), v0 + 6 * D, 3 * D + 7};
}

// dW row of the message weights' vector row v (0..10): b, g, B of the three
// stages after W1 (2D+1 rows), W2 and P1, then P2 and pb2.
__device__ __forceinline__ int msg_vec_row(int v, int D) {
  return v < 9 ? (v / 3 == 0 ? 2 * D + 1 : v / 3 == 1 ? 3 * D + 4 : 4 * D + 7) + v % 3
               : 4 * D + 1 + v;
}

// Tile t of the 32-row tiles of the stages' matrices, in stage order: the
// stage, with t reduced to the tile within it.
template <typename StageOf>
__device__ __forceinline__ Stage stage_of_tile(int& t, int n_stages, int D,
                                               StageOf stage) {
  for (int s = 0; s < n_stages - 1; ++s) {
    const Stage st = stage(s, D);
    const int tiles = (st.K + kTile - 1) / kTile;
    if (t < tiles) return st;
    t -= tiles;
  }
  return stage(n_stages - 1, D);
}

// Start the 16-byte copy of src[e * ld + col0 + 4 q .. + 3] into
// dst[(e - base) * w + 4 q] for chunk rows e in [base, base + 32) and
// 4 q < w: zeros where e >= e_end or col0 + 4 q >= lim (a source size of
// 0).  ld and col0 are multiples of 4.
__device__ __forceinline__ void stage_chunk(const float* src, size_t ld,
                                            int col0, int lim, int w,
                                            long long base, long long e_end,
                                            float* dst) {
  const int qs = w >> 2;
  for (int i = threadIdx.x; i < kTile * qs; i += kThreads) {
    const int ee = i / qs, q = i - ee * qs;
    const long long e = base + ee;
    const bool ok = e < e_end && col0 + 4 * q < lim;
    const float* from = ok ? src + (size_t)e * ld + col0 + 4 * q : src;
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + ee * w + 4 * q));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(from), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

constexpr int kChunkStages = 3;   // row chunks of a dW item, 2 in flight
constexpr int kWgradCols = 128;   // dW columns of an item
// Floats of shared memory wgrad_tile needs: kChunkStages chunks of a left
// [32, 32] and a right [32, kWgradCols] operand.
constexpr int kWgradFloats = kChunkStages * kTile * (kTile + kWgradCols);

// Shared memory (floats) of the stack's backward: a tile's, or the head and
// the weight gradient's where that is larger.
__host__ __device__ inline int stack_bwd_smem_floats(int TE, int D) {
  const int t = tile_layout(TE, D).total;
  return t > kHead + kWgradFloats ? t : kHead + kWgradFloats;
}

// Rows [k0, k0 + 32) x columns [c0, c0 + 128) of a stage's matrix over rows
// [e_beg, e_end) of `ops` (row stride ld, a multiple of 4), into part (one
// slice's partial dW, row stride D).  Thread t owns rows k0 + 4 (t / 32) ..
// + 3 and columns c0 + 4 (t % 32) .. + 3 (16 sums in registers); the rows
// are walked in order in chunks of 32, kChunkStages - 1 chunks in flight
// by cp.async while one is multiplied.  Each sum runs over e in order.
__device__ __forceinline__ void wgrad_tile(
    const float* ops, size_t ld, Stage st, int k0, int c0, long long e_beg,
    long long e_end, float* part, int D, float* smem) {
  constexpr int kSlot = kTile * (kTile + kWgradCols);
  const int cg = threadIdx.x & 31, kg = threadIdx.x >> 5;
  const int chunks = (int)((e_end - e_beg + kTile - 1) / kTile);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  __syncthreads();   // the previous item's shared memory is consumed
#pragma unroll
  for (int t = 0; t < kChunkStages - 1; ++t) {
    if (t < chunks) {
      float* slot = smem + t * kSlot;
      const long long base = e_beg + (long long)t * kTile;
      // k past K reads the row's next columns: those sums are not stored
      stage_chunk(ops, ld, st.lcol + k0, (int)ld, kTile, base, e_end, slot);
      stage_chunk(ops, ld, st.rcol + c0, st.rcol + D, kWgradCols, base, e_end,
                  slot + kTile * kTile);
    }
    cp_async_commit();
  }
  for (int t = 0; t < chunks; ++t) {
    cp_async_wait<kChunkStages - 2>();
    __syncthreads();   // chunk t visible; chunk t - 1 consumed
    const int ahead = t + kChunkStages - 1;
    if (ahead < chunks) {
      float* slot = smem + (ahead % kChunkStages) * kSlot;
      const long long base = e_beg + (long long)ahead * kTile;
      stage_chunk(ops, ld, st.lcol + k0, (int)ld, kTile, base, e_end, slot);
      stage_chunk(ops, ld, st.rcol + c0, st.rcol + D, kWgradCols, base, e_end,
                  slot + kTile * kTile);
    }
    cp_async_commit();
    const float* ls = smem + (t % kChunkStages) * kSlot + 4 * kg;
    const float* rs = smem + (t % kChunkStages) * kSlot + kTile * kTile + 4 * cg;
#pragma unroll 4
    for (int ee = 0; ee < kTile; ++ee) {
      const float4 l = *reinterpret_cast<const float4*>(ls + ee * kTile);
      const float4 r = *reinterpret_cast<const float4*>(rs + ee * kWgradCols);
      const float lv[4] = {l.x, l.y, l.z, l.w}, rv[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(lv[i], rv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * kg + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 4 * cg + j;
      if (k < st.K && c < D) part[(size_t)(st.row0 + k) * D + c] = acc[i][j];
    }
  }
  __syncthreads();   // shared memory is free for the next item
}

// Columns [c0, c0 + 32) of one vector row of dW: column sums of
// ops[:, src + c] over rows [e_beg, e_end) into part[row][c]; 8 thread groups
// take every 8th row, then one thread adds the 8 partial sums in order.
__device__ __forceinline__ void colsum_cols(
    const float* ops, size_t ld, int src, int row, int c0, long long e_beg,
    long long e_end, float* part, int D, float* smem) {
  float* psum = smem;               // [kWarps][32]
  const int col = c0 + (threadIdx.x & 31), grp = threadIdx.x >> 5;
  float s = 0.f;
  if (col < D) {
    // 8 rows' loads in flight, then their adds in row order
    long long e = e_beg + grp;
    for (; e + 7 * kWarps < e_end; e += 8 * kWarps) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = __ldcg(ops + (size_t)(e + u * kWarps) * ld + src + col);
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; e < e_end; e += kWarps) s += __ldcg(ops + (size_t)e * ld + src + col);
  }
  psum[threadIdx.x] = s;
  __syncthreads();
  if (grp == 0 && col < D) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < kWarps; ++g) t += psum[g * 32 + (threadIdx.x & 31)];
    part[(size_t)row * D + col] = t;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The node side of a layer (K6)
// ---------------------------------------------------------------------------

// The node side of one layer on nodes [TE tile, TE tile + TE): each warp sums
// its nodes' receiver CSR rows of msg [E, D] and pos_msg [E, 3] in ascending
// edge order (msg_acc, stored to macc when given), then the update MLP
// u = relu(LN(cat(h, msg_acc) U1 + ub1)), upd = relu(LN(u U2 + ub2)); writes
// h_out = h + upd and pos_out = pos + pos_sum / max(cnt, 1) when h_out is
// given, and each node's row of kept activations [N, act_node_ld(D)] =
// [xhat1 | xhat2 | rstd1 rstd2] when act is given.  h_out and pos_out may be
// h and pos: a node's row is read before it is written, by the block that
// owns it.
template <int TE>
__device__ void node_fwd_tile(
    long long tile, const int64_t* __restrict__ order,
    const int64_t* __restrict__ rowptr, const float* msg_e, const float* pos_e,
    const float* h, const float* pos, const float* __restrict__ Wu, float* macc,
    float* h_out, float* pos_out, float* act, long long N, int D, float* smem) {
  constexpr int TR = TE / 8;
  const Tile t = carve(smem, TE, D);
  const int lane = lane_id();
  const size_t lda = act_node_ld(D);
  const long long n0 = tile * TE;
  const UpdWeights w = upd_weights(Wu, D);
  const Weights u1{w.U1, 2 * D, D}, u2{w.U2, D, D};
  __syncthreads();
  prefetch<TR>(t, u1);   // U1's first K-tiles arrive during the sums

  for (int row = warp_id(); row < TE; row += kWarps) {
    const long long node = n0 + row;
    float* u = t.X + row * t.ldx;
    float* pn = t.s + row * kSmall + kPnew;
    if (node >= N) {
      for (int c = lane; c < 2 * D; c += 32) u[c] = 0.f;
      continue;
    }
    const int64_t beg = rowptr[node], end = rowptr[node + 1];
    float acc[kMaxCols];
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[c] = 0.f;
    float pacc = 0.f;
    for (int64_t k0 = beg; k0 < end; k0 += 32) {
      // the row's next 32 edge ids in one load, then their rows 4 at a time
      // (loads first, then the adds in edge order)
      const int cnt = end - k0 < 32 ? (int)(end - k0) : 32;
      const int64_t mine = lane < cnt ? order[k0 + lane] : 0;
      for (int j = 0; j < cnt; j += 4) {
        float rows[4][kMaxCols], prow[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j + u >= cnt) break;
          const int64_t e = __shfl_sync(0xffffffffu, mine, j + u);
          const float* mrow = msg_e + (size_t)e * D;
#pragma unroll
          for (int c = 0; c < kMaxCols; ++c) {
            const int col = lane + 32 * c;
            rows[u][c] = col < D ? __ldcg(mrow + col) : 0.f;
          }
          prow[u] = lane < 3 ? __ldcg(pos_e + (size_t)e * 3 + lane) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j + u >= cnt) break;
#pragma unroll
          for (int c = 0; c < kMaxCols; ++c)
            if (lane + 32 * c < D) acc[c] += rows[u][c];
          if (lane < 3) pacc += prow[u];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) {
        u[col] = __ldcg(h + (size_t)node * D + col);
        u[D + col] = acc[c];
        if (macc) macc[(size_t)node * D + col] = acc[c];
      }
    }
    if (lane < 3)
      pn[lane] = __ldcg(pos + (size_t)node * 3 + lane) +
                 pacc / fmaxf((float)(end - beg), 1.f);
  }

  Row v;
  mm<TR>(t.X, t.ldx, u1, t, t.C, t.ldd, &u2);
  for (int row = warp_id(); row < TE; row += kWarps) {
    const long long node = n0 + row;
    const float rstd = row_ln(t.C + row * t.ldd, w.ub1, D, v);
    if (act != nullptr && node < N) {
      put_row(v, act + (size_t)node * lda, D);
      if (lane == 0) act[(size_t)node * lda + 2 * D] = rstd;
    }
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      if (lane + 32 * c < D) v[c] = affine_relu(v[c], w.ug1, w.uB1, lane + 32 * c);
    put_row(v, t.Y + row * t.ldd, D);
  }
  mm<TR>(t.Y, t.ldd, u2, t, t.C, t.ldd);
  for (int row = warp_id(); row < TE; row += kWarps) {
    const long long node = n0 + row;
    const float rstd = row_ln(t.C + row * t.ldd, w.ub2, D, v);
    if (node >= N) continue;
    if (act != nullptr) {
      put_row(v, act + (size_t)node * lda + D, D);
      if (lane == 0) act[(size_t)node * lda + 2 * D + 1] = rstd;
    }
    if (h_out == nullptr) continue;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D)
        h_out[(size_t)node * D + col] =
            t.X[row * t.ldx + col] + affine_relu(v[c], w.ug2, w.uB2, col);
    }
    if (lane < 3) pos_out[(size_t)node * 3 + lane] = t.s[row * kSmall + kPnew + lane];
  }
}

// Barrier across every block of a launch whose blocks are all resident (a
// cooperative launch).  bar[0] counts the blocks that arrived in this round,
// bar[1] is the round; both start at 0 and bar[0] is 0 again after every
// round.  The fences make every write before the barrier visible to every
// read after it (the reads of other blocks' data go through __ldcg).
__device__ __forceinline__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* round = bar + 1;
    const unsigned int r = *round;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*round == r) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// When stamps is given, block 0 records the device clock (ns) in stamps[k]
// and k moves on: a reading of each phase's length (bench_kernels --only
// k6); nothing is recorded in normal calls.
__device__ __forceinline__ void phase_stamp(unsigned long long* stamps, int& k) {
  if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[k] = t;
  }
  ++k;
}

}  // namespace egnn
