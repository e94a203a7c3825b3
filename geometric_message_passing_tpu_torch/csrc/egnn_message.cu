// EGNN fused message pass for Hopper (sm_90a), exact f32 on CUDA cores.
//
// Replaces geometric_message_passing_tpu/ops/pallas_edge.py:134 _egnn_kernel,
// the TPU kernel that gathers both endpoints of every edge, runs the message
// MLP (three Linear+LayerNorm+ReLU stages and the position scale head) and
// sums the results over receivers.  Same function, same packed weight layout
// ([4D+12, D] rows: W1 b1 g1 B1 | W2 b2 g2 B2 | P1 pb1 pg1 pB1 | P2 | pb2 in
// column 0), same masking; not the TPU algorithm: the one-hot [block, N]
// matmuls that gather and scatter on the TPU's matrix unit become indexed
// loads and a sorted (CSR) segment sum, so N is not limited.
//
// What bounds it: f32 FMAs, and what feeds them.  Each edge costs
// 2*D*(2D+1) + 4*D^2 FLOPs of matrix products (about 131 kFLOP at D = 128)
// against some 1.5 KB of gathered and written rows, far above the card's f32
// balance point, and the products run in exact f32 on the CUDA cores (no
// TF32, no tensor cores).  A design that streams the weights (262,656 bytes
// at D = 128) through every tile reads them from L2 once per tile, some
// 2.1 GB per launch on a 10k-atom box against 0.2 GB of edge rows; its
// K-tiles wait little (the clock readings of csrc/egnn_ring_probe.cu: a
// K-tile's time is its products), but a block holds one small tile.  The
// products themselves are bound by shared memory, which hands each thread
// its operands: every column group rereads the activation rows and every
// row group the weights.
//
// What the design does (egnn_edge_kernel below):
//   * the weights stay resident: a launch loads each block's share once into
//     shared memory by bulk tensor copies (the TMA) of 32-row boxes on three
//     mbarriers (W1's rows first, so the first tile's products start while
//     W2's and P1's land); the products read them with no wait inside;
//   * a cluster of C blocks (the smallest of 1, 2, 4, 8 whose share fits,
//     ops/edge.py::resident_plan; C = 2 at D = 128, 136 KB of weights a
//     block) splits every weight by output columns, in shares of a multiple
//     of 4 columns;
//   * the grid is persistent: as many clusters as the card holds at once
//     (cudaOccupancyMaxActiveClusters, at most one per tile), cluster g
//     walks edge tiles g, g + G, ...; the tile (8 to 40 rows) is the plan's;
//   * warps 0-3 run the products: a thread owns TE / 8 rows x 4 columns of
//     its block's share (register blocked, each set of four k's operands in
//     registers a step ahead of its FMAs, every sum over k in ascending
//     order) and stores them into a buffer of whole product rows in every
//     block of the cluster (distributed shared memory); after a cluster
//     barrier every block runs the LayerNorm rows itself on the whole rows,
//     with the plain two-pass statistics, so nothing is summed across
//     blocks and two runs are bitwise equal.  At C = 1 the cluster barriers
//     are block barriers;
//   * the row steps and gathers hide behind the products where the chain
//     allows: the next tile's ids and positions load during this tile's
//     first product and row steps, warps 4-7 copy its features (cp.async)
//     during the last product, and run this tile's last row step (the scale
//     head) during the next tile's first product.
// Every block writes its share of the live edges' msg [E, D] rows; the
// scale head's rows are dealt over the cluster.  Kernel 2
// (egnn_reduce_kernel) sums them by receiver over a CSR (edge order sorted
// stably by receiver, row pointers), one warp per node, in ascending edge
// order: no atomics, so two runs give bitwise-equal outputs.  The count is
// the row's length.

#include <cuda.h>   // CUtensorMap (its encoder is looked up at run time)
#include <cuda_runtime.h>
#include <stdint.h>

#include "egnn_common.cuh"

namespace {

using namespace egnn;

constexpr int kMaxCluster = 8;
constexpr int kMaxShare = 128;    // columns a block holds at most
constexpr int kBoxRows = 32;      // weight rows a bulk tensor copy moves
constexpr int kResHead = 32;      // the copies' mbarriers; 128-byte aligned
constexpr int kVecRows = 10;      // b1 g1 B1 b2 g2 B2 pb1 pg1 pB1 P2
constexpr int kSmemMax = 227 * 1024;
constexpr int kTileCost = 16;     // a tile's fixed steps, in rows of products
constexpr int kMaxTile = 40;      // rows of an edge tile: 8, 16, ..., 40
constexpr int kProductWarps = 4;  // warps 0-3 run the products
constexpr int kProductThreads = kProductWarps * 32;

// The column share of block r of a cluster of C at width D: D / 4 float4
// columns dealt as evenly as can be, the larger shares first; and its first
// column.
__host__ __device__ inline int res_share(int D, int C, int r) {
  const int base = D / 4 / C, extra = D / 4 % C;
  return 4 * (base + (r < extra ? 1 : 0));
}
__host__ __device__ inline int res_col0(int D, int C, int r) {
  const int base = D / 4 / C, extra = D / 4 % C;
  return 4 * (r * base + (r < extra ? r : extra));
}

// Packed rows [0, 4D+7) (W1 b1 g1 B1 | W2 b2 g2 B2 | P1) in boxes of
// kBoxRows: the rows a block holds of its share, rounded up to whole boxes.
__host__ __device__ inline int res_boxes(int D) {
  return (4 * D + 7 + kBoxRows - 1) / kBoxRows;
}

// Shared memory (floats) of a block whose cluster's widest share is `share`:
// the head; the share's weight rows [res_boxes * kBoxRows, share] (each box
// 128-byte aligned); the vector rows b1 ... P2 whole [10, D]; per tile row x
// (later m) [row_ld(2D+1)], two buffers of whole product rows [row_ld(D)]
// that every block of the cluster writes its columns into (one later holds
// msg), and
// two buffers of row scalars (the current tile's, and the next tile's ids
// while the current one runs).  Every block of a cluster has the same
// layout, so an address maps to the same field in a peer.  Mirrored by
// ops/edge.py::resident_smem_bytes.
struct ResLayout {
  int ldx, ldd;
  int w, v, x, f0, f1, small, total;
};

__host__ __device__ inline ResLayout res_layout(int TE, int D, int share) {
  ResLayout l;
  l.ldx = row_ld(2 * D + 1);
  l.ldd = row_ld(D);
  l.w = kResHead;
  l.v = l.w + res_boxes(D) * kBoxRows * share;
  l.x = l.v + kVecRows * D;
  l.f0 = l.x + TE * l.ldx;
  l.f1 = l.f0 + TE * l.ldd;
  l.small = l.f1 + TE * l.ldd;
  l.total = l.small + 2 * TE * kSmall;
  return l;
}

inline int res_smem_bytes(int TE, int D, int share) {
  return (int)sizeof(float) * res_layout(TE, D, share).total;
}

// The cluster size at width D (0 when none fits): the smallest whose
// shares are at least 4 and at most kMaxShare columns and whose block fits
// beside an 8-row tile.
inline int res_cluster(int D) {
  if (D % 16 != 0 || D < 16 || D > 256) return 0;
  for (int C = 1; C <= kMaxCluster; C *= 2)
    if (res_share(D, C, C - 1) >= 4 && res_share(D, C, 0) <= kMaxShare &&
        res_smem_bytes(8, D, res_share(D, C, 0)) <= kSmemMax)
      return C;
  return 0;
}

// The plan (ops/edge.py::resident_plan): cluster, tile, shared bytes for E
// edges on a card holding `clusters` clusters at 8-row tiles; false when D
// has none.  The tile (8, 16, 24, 32 or 40 rows, one that fits) takes the
// fewest rounds of tiles over the clusters x (rows + kTileCost), the smaller
// on a tie.
inline bool res_plan(int D, long long E, int clusters, int* cluster, int* tile,
                     int* smem) {
  const int C = res_cluster(D);
  if (C == 0) return false;
  const int share = res_share(D, C, 0);
  const long long slots = clusters > 1 ? clusters : 1;
  int te = 8;
  long long best = -1;
  for (int t = 8; t <= kMaxTile; t += 8) {
    if (res_smem_bytes(t, D, share) > kSmemMax) continue;
    const long long cost = (((E + t - 1) / t + slots - 1) / slots) * (t + kTileCost);
    if (best < 0 || cost < best) {
      best = cost;
      te = t;
    }
  }
  *cluster = C;
  *tile = te;
  *smem = res_smem_bytes(te, D, share);
  return true;
}

// ---------------------------------------------------------------------------
// Device steps
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cluster_barrier(int C) {
  if (C == 1) {
    __syncthreads();
    return;
  }
  // release and acquire: the peers' stores before it are seen after it
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Store v at `local`'s place in the shared memory of block `rank` of the
// cluster (16-byte aligned).
__device__ __forceinline__ void put_peer4(float* local, int rank, float4 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(remote),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// One bulk tensor copy (the TMA) of the box at (column c, row r) of map
// into dst, completing on bar.
__device__ __forceinline__ void tensor_load(void* dst, const CUtensorMap* map,
                                            int c, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(smem_u32(bar))
      : "memory");
}

// Clock readings of block 0's thread 0, when the launch is given stamps:
// cycles spent in each kind of step, summed over the block's tiles.
enum Lap { kWeights = 0, kGather, kProducts, kBarriers, kLn1, kLn2, kLaps };
// slots of a stamped launch (ops/edge.py::RESIDENT_STAMPS): see Clock::finish
constexpr int kStamps = 5 + kLaps;
static_assert(kStamps == 11, "ops/edge.py::RESIDENT_STAMPS");

struct Clock {
  long long* out;   // null except in block 0's thread 0 of a stamped launch
  long long start, last, first_weights;
  long long acc[kLaps];

  __device__ __forceinline__ explicit Clock(long long* stamps)
      : out(stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0 ? stamps
                                                                     : nullptr),
        start(0), last(0), first_weights(0) {
#pragma unroll
    for (int i = 0; i < kLaps; ++i) acc[i] = 0;
    if (out != nullptr) {
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(out[0]));
      start = last = clock64();
    }
  }
  __device__ __forceinline__ void lap(int kind) {
    if (out == nullptr) return;
    const long long t = clock64();
    acc[kind] += t - last;
    last = t;
    if (kind == kWeights && first_weights == 0) first_weights = t - start;
  }
  // out: [globaltimer at start, at end, cycles in all, cycles by Lap, tiles,
  // cycles from the start until W1's rows were seen]
  __device__ __forceinline__ void finish(long long tiles) {
    if (out == nullptr) return;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(out[1]));
    out[2] = clock64() - start;
#pragma unroll
    for (int i = 0; i < kLaps; ++i) out[3 + i] = acc[i];
    out[3 + kLaps] = tiles;
    out[4 + kLaps] = first_weights;
  }
};

struct Cluster {
  int C, rank, nc, c0;
};

// The next tile's rows, fetched while the current one runs: thread r < TE
// holds row r's ids and both endpoints' positions in registers.
struct NextRow {
  int i = -1, j = -1;   // receiver, sender; -1 for a masked-off edge or one past E
  float pi[3] = {0.f, 0.f, 0.f}, pj[3] = {0.f, 0.f, 0.f};
};

template <typename Idx>
__device__ __forceinline__ void fetch_ids(NextRow& n, long long e, long long E,
                                          const Idx* send, const Idx* recv,
                                          const uint8_t* emask) {
  n.i = n.j = -1;
  if (e < E && emask[e] != 0) {
    n.i = (int)recv[e];
    n.j = (int)send[e];
  }
}

__device__ __forceinline__ void fetch_pos(NextRow& n, const float* pos) {
  if (n.i < 0) return;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    n.pi[c] = __ldcg(pos + 3 * (size_t)n.i + c);
    n.pj[c] = __ldcg(pos + 3 * (size_t)n.j + c);
  }
}

// Row r's scalars (position difference, inverse distance, live flag) and
// x's last column |d|, as egnn_common.cuh's gather_edges computes them.
__device__ __forceinline__ void put_scalars(const NextRow& n, float* s, float* x_dist) {
  float dist = 0.f, inv = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (n.i >= 0) {
    dx = n.pi[0] - n.pj[0];
    dy = n.pi[1] - n.pj[1];
    dz = n.pi[2] - n.pj[2];
    const float sq = dx * dx + dy * dy + dz * dz;
    const bool positive = sq > 1e-24f;
    dist = positive ? sqrtf(sq) : 0.f;
    inv = positive ? 1.f / dist : 0.f;
  }
  *x_dist = dist;
  s[kInv] = inv;
  s[kPd] = dx;
  s[kPd + 1] = dy;
  s[kPd + 2] = dz;
  s[kLive] = n.i >= 0 ? 1.f : 0.f;
}

constexpr int kNodes = 10;   // a row's receiver and sender (int) among its scalars

// x's features [h_i, h_j] of every row whose node ids are in `sc` (row
// scalars, fields kNodes) into X by asynchronous copies (16 bytes each, 4
// when h is not 16-byte aligned), a warp a row, by warps [w0, w0 + nw);
// zeros for rows without an edge.  Committed as one group.
template <int TE>
__device__ __forceinline__ void copy_rows(const float* sc, const float* h, int D,
                                          float* X, int ldx, int w0, int nw) {
  const bool vec = (reinterpret_cast<uintptr_t>(h) & 15) == 0;
  const int lane = lane_id();
  for (int r = warp_id() - w0; r < TE; r += nw) {
    const int* nodes = reinterpret_cast<const int*>(sc + r * kSmall) + kNodes;
    const int ni = nodes[0], nj = nodes[1];
    float* x = X + r * ldx;
    if (ni < 0) {
      for (int c = lane; c < 2 * D; c += 32) x[c] = 0.f;
      continue;
    }
    const float* hi = h + (size_t)ni * D;
    const float* hj = h + (size_t)nj * D;
    if (vec) {
      for (int c = 4 * lane; c < 2 * D; c += 128)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(x + c)),
                     "l"(c < D ? hi + c : hj + (c - D))
                     : "memory");
    } else {
      for (int c = lane; c < 2 * D; c += 32)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(x + c)),
                     "l"(c < D ? hi + c : hj + (c - D))
                     : "memory");
    }
  }
  cp_async_commit();
}

// LayerNorm of RW rows a warp at once (crow[i] + bias over D columns, lane l
// holding columns l + 32 c for c < LC = ceil(D / 32) rounded up to 4 or 8; 0
// past D), each row's arithmetic that of egnn_common.cuh's row_ln, the
// rows' reductions interleaved so their shuffles overlap.
template <int RW, int LC>
__device__ __forceinline__ void rows_ln(const float* const (&crow)[RW],
                                        const float* __restrict__ bias, int D,
                                        float (&v)[RW][LC]) {
  const int lane = lane_id();
  const float inv_d = 1.f / (float)D;
  float s[RW], q[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int c = 0; c < LC; ++c) {
      const int col = lane + 32 * c;
      v[i][c] = 0.f;
      if (col < D) {
        v[i][c] = crow[i][col] + bias[col];
        s[i] += v[i][c];
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < RW; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const float mu = s[i] * inv_d;
    q[i] = 0.f;
#pragma unroll
    for (int c = 0; c < LC; ++c)
      if (lane + 32 * c < D) {
        v[i][c] -= mu;
        q[i] += v[i][c] * v[i][c];
      }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < RW; ++i) q[i] += __shfl_xor_sync(0xffffffffu, q[i], o);
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const float rstd = 1.f / sqrtf(q[i] * inv_d + kEps);
#pragma unroll
    for (int c = 0; c < LC; ++c) v[i][c] *= rstd;
  }
}

// v <- relu(v * gam + bet) at the lane's columns; row[col] = v there
template <int LC>
__device__ __forceinline__ void affine_put(float (&v)[LC], const float* gam,
                                           const float* bet, int D, float* row) {
  const int lane = lane_id();
#pragma unroll
  for (int c = 0; c < LC; ++c)
    if (lane + 32 * c < D) {
      v[c] = affine_relu(v[c], gam, bet, lane + 32 * c);
      row[lane + 32 * c] = v[c];
    }
}

// The block's columns of a product, written into buffer F of every block of
// the cluster: F[r][c0 + c] = sum_k A[r][k] W[k][c] for rows r < TE and the
// block's nc columns c (A, W in shared memory, 16-byte aligned; W's row
// stride ldw), by the product warps (threads below kProductThreads).
// Thread t owns R = TE / 8 consecutive rows and the 4 columns of group
// t % (nc / 4) (at nc = 64: 128 threads, one warp a scheduler partition;
// fewer threads with more rows each ran slower): per four k it reads R
// float4 of A and four of W, so each value it reads feeds R or 4 FMAs.  A
// quarter-warp's reads of A are one row (a broadcast) and of W neighbouring
// float4.  Each sum runs over k in ascending order, one fmaf at a time;
// each set of four k's operands is in registers a step before its FMAs.
template <int TE>
__device__ __forceinline__ void product(const Cluster& k, const float* A, int lda,
                                        int K, const float* W, int ldw, float* F,
                                        int ldf) {
  constexpr int R = TE / 8;
  const int ncg = k.nc >> 2, threads = TE / R * ncg;
  const int K4 = K & ~3;
  for (int t = threadIdx.x; t < threads; t += kProductThreads) {
    const int cg = t % ncg, r0 = t / ncg * R;
    const float* ap = A + (size_t)r0 * lda;
    const float* wp = W + cg * 4;
    float acc[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    // two register sets of four k's operands, each loaded a step ahead of
    // its FMAs (K4 is a multiple of 8: D is one of 16)
    float4 a0[R], w0[4], a1[R], w1[4];
    auto load = [&](float4(&av)[R], float4(&wv)[4], int kk) {
#pragma unroll
      for (int i = 0; i < R; ++i)
        av[i] = *reinterpret_cast<const float4*>(ap + (size_t)i * lda + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wv[q] = *reinterpret_cast<const float4*>(wp + (size_t)(kk + q) * ldw);
    };
    auto fma4 = [&](const float4(&av)[R], const float4(&wv)[4]) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float x = q == 0 ? av[i].x : q == 1 ? av[i].y : q == 2 ? av[i].z : av[i].w;
          acc[i][0] = fmaf(x, wv[q].x, acc[i][0]);
          acc[i][1] = fmaf(x, wv[q].y, acc[i][1]);
          acc[i][2] = fmaf(x, wv[q].z, acc[i][2]);
          acc[i][3] = fmaf(x, wv[q].w, acc[i][3]);
        }
      }
    };
    if (K4 > 0) load(a0, w0, 0);
    for (int kk = 0; kk < K4; kk += 8) {
      load(a1, w1, kk + 4);
      fma4(a0, w0);
      if (kk + 8 < K4) load(a0, w0, kk + 8);
      fma4(a1, w1);
    }
    for (int kk = K4; kk < K; ++kk) {
      const float4 w4 = *reinterpret_cast<const float4*>(wp + (size_t)kk * ldw);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float x = ap[(size_t)i * lda + kk];
        acc[i][0] = fmaf(x, w4.x, acc[i][0]);
        acc[i][1] = fmaf(x, w4.y, acc[i][1]);
        acc[i][2] = fmaf(x, w4.z, acc[i][2]);
        acc[i][3] = fmaf(x, w4.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      float* f = F + (size_t)(r0 + i) * ldf + k.c0 + cg * 4;
      if (k.C == 1)
        *reinterpret_cast<float4*>(f) = v;
      else
        for (int q = 0; q < k.C; ++q) put_peer4(f, q, v);
    }
  }
}

template <typename Idx>
struct EdgeArgs {
  CUtensorMap wmap;    // the packed weights [4D+12, D], boxes [kBoxRows, share]
  const Idx *send, *recv;
  const uint8_t* emask;
  const float *h, *pos, *w;
  float *msg_e, *pos_e;
  long long* stamps;   // kStamps clock readings, or null
  long long E;
  int D;
};

// The persistent, weight-resident edge kernel (see the top of the file).
template <int TE, int LC, typename Idx>
__global__ void __launch_bounds__(kThreads, 1)
    egnn_edge_kernel(const __grid_constant__ EdgeArgs<Idx> a) {
  extern __shared__ __align__(128) float smem[];
  constexpr int RW = TE / kWarps;   // rows a warp takes in a row step
  const int D = a.D, lane = lane_id(), warp = warp_id();
  Cluster k;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(k.C));
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(k.rank));
  k.nc = res_share(D, k.C, k.rank);
  k.c0 = res_col0(D, k.C, k.rank);
  const int share = res_share(D, k.C, 0);
  const ResLayout L = res_layout(TE, D, share);
  float* const Ws = smem + L.w;
  float* const V = smem + L.v;
  float* const X = smem + L.x;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem);
  Clock clk(a.stamps);

  // The block's columns of rows [0, 4D+7), once, a box of kBoxRows rows a
  // copy; box b completes on the mbarrier of the segment holding its first
  // row: W1's [0, 2D+4), W2's [2D+4, 3D+7), P1's from 3D+7.
  const int seg1 = 2 * D + 4, seg2 = 3 * D + 7, boxes = res_boxes(D);
  const uint32_t box_bytes = 4u * kBoxRows * share;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 3; ++s) bar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const int first[4] = {0, (seg1 + kBoxRows - 1) / kBoxRows,
                          (seg2 + kBoxRows - 1) / kBoxRows, boxes};
    for (int s = 0; s < 3; ++s) {
      bar_expect(&bars[s], box_bytes * (first[s + 1] - first[s]));
      for (int b = first[s]; b < first[s + 1]; ++b)
        tensor_load(Ws + (size_t)b * kBoxRows * share, &a.wmap, k.c0, b * kBoxRows,
                    &bars[s]);
    }
  }
  // the vector rows, whole
  for (int i = threadIdx.x; i < kVecRows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int src = r < 3 ? 2 * D + 1 + r : r < 6 ? 3 * D + 1 + r : r < 9 ? 4 * D + 1 + r
                                                                          : 4 * D + 10;
    V[i] = __ldg(a.w + (size_t)src * D + c);
  }
  // every block of the cluster runs before any writes into another's memory
  cluster_barrier(k.C);

  const float* W1 = Ws;
  const float* W2 = Ws + (size_t)seg1 * share;
  const float* P1 = Ws + (size_t)seg2 * share;
  const float *b1 = V, *g1 = V + D, *B1 = V + 2 * D, *b2 = V + 3 * D,
              *g2 = V + 4 * D, *B2 = V + 5 * D, *pb1 = V + 6 * D, *pg1 = V + 7 * D,
              *pB1 = V + 8 * D, *P2 = V + 9 * D;
  const float pb2 = __ldg(a.w + (size_t)(4 * D + 11) * D);

  const long long tiles = (a.E + TE - 1) / TE;
  const int G = gridDim.x / k.C;
  float* const F0 = smem + L.f0;
  float* const F1 = smem + L.f1;
  float* const small0 = smem + L.small;
  auto scalars = [&](long long it) { return small0 + (it & 1) * TE * kSmall; };
  const bool product_warp = warp < kProductWarps;
  bool landed = false;
  long long done = 0;
  unsigned step = 0;   // products so far: the next one writes F1 when odd
  float v[RW][LC];
  const float* rows[RW];

  // The last row step of a tile (scale = relu(LN3(msg P1 + pb1)) . P2 + pb2;
  // pos_msg = pd * scale), by warps 4-7, the cluster's blocks taking its
  // rows in turn; it runs during the next tile's first product.
  auto ln3 = [&](long long e0, const float* F, const float* sc) {
    for (int r = k.rank + k.C * (warp - kProductWarps); r < TE;
         r += k.C * (kWarps - kProductWarps)) {
      const long long e = e0 + r;
      float p[1][LC];
      const float* const crow[1] = {F + r * L.ldd};
      rows_ln<1, LC>(crow, pb1, D, p);
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < LC; ++c) {
        const int col = lane + 32 * c;
        if (col < D) s = fmaf(affine_relu(p[0][c], pg1, pB1, col), P2[col], s);
      }
      const float scale = warp_sum(s) + pb2;
      const float* sr = sc + r * kSmall;
      if (e < a.E && sr[kLive] != 0.f && lane < 3)
        a.pos_e[(size_t)e * 3 + lane] = sr[kPd + lane] * scale;
    }
  };

  // The first tile's rows; later tiles' are fetched during the one before:
  // the ids during its first product, the positions during its row steps,
  // the features (by warps 4-7) during its last product, X being free once
  // the second has read m.
  long long tile = blockIdx.x / k.C, it = 0;
  NextRow nx;
  auto put_ids = [&](float* sc) {
    int* nodes = reinterpret_cast<int*>(sc + threadIdx.x * kSmall) + kNodes;
    nodes[0] = nx.i;
    nodes[1] = nx.j;
  };
  if (threadIdx.x < TE) {
    fetch_ids(nx, tile * TE + threadIdx.x, a.E, a.send, a.recv, a.emask);
    put_ids(scalars(0));
    fetch_pos(nx, a.pos);
  }
  __syncthreads();
  if (tile < tiles) copy_rows<TE>(scalars(0), a.h, D, X, L.ldx, 0, kWarps);

  for (; tile < tiles; tile += G, ++it, ++done) {
    const long long e0 = tile * TE, next = tile + G;
    float* const sc = scalars(it);
    if (threadIdx.x < TE) {
      put_scalars(nx, sc + threadIdx.x * kSmall, X + threadIdx.x * L.ldx + 2 * D);
      fetch_ids(nx, next * TE + threadIdx.x, a.E, a.send, a.recv, a.emask);
    }
    cp_async_wait<0>();
    __syncthreads();
    clk.lap(kGather);

    // m = relu(LN1(x W1 + b1)) into X; meanwhile the previous tile's LN3
    float* F = step++ & 1 ? F1 : F0;
    if (product_warp) {
      if (!landed) {
        bar_wait(&bars[0], 0);
        clk.lap(kWeights);
      }
      product<TE>(k, X, L.ldx, 2 * D + 1, W1, share, F, L.ldd);
    } else if (it > 0) {
      ln3(e0 - (long long)G * TE, step & 1 ? F1 : F0, scalars(it - 1));
    }
    clk.lap(kProducts);
    cluster_barrier(k.C);
    clk.lap(kBarriers);
    if (threadIdx.x < TE) {
      put_ids(scalars(it + 1));
      fetch_pos(nx, a.pos);
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) rows[i] = F + (warp + kWarps * i) * L.ldd;
    rows_ln<RW, LC>(rows, b1, D, v);
#pragma unroll
    for (int i = 0; i < RW; ++i) affine_put<LC>(v[i], g1, B1, D, X + (warp + kWarps * i) * L.ldx);
    __syncthreads();
    clk.lap(kLn1);

    // msg = relu(LN2(m W2 + b2)) over its own rows of F and, for the live
    // edges, into msg_e
    F = step++ & 1 ? F1 : F0;
    if (product_warp) {
      if (!landed) {
        bar_wait(&bars[1], 0);
        clk.lap(kWeights);
      }
      product<TE>(k, X, L.ldx, D, W2, share, F, L.ldd);
    }
    clk.lap(kProducts);
    cluster_barrier(k.C);
    clk.lap(kBarriers);
#pragma unroll
    for (int i = 0; i < RW; ++i) rows[i] = F + (warp + kWarps * i) * L.ldd;
    rows_ln<RW, LC>(rows, b2, D, v);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = warp + kWarps * i;
      const long long e = e0 + r;
      affine_put<LC>(v[i], g2, B2, D, F + r * L.ldd);   // in place
      if (r % k.C == k.rank && e < a.E && sc[r * kSmall + kLive] != 0.f) {
        float* out = a.msg_e + (size_t)e * D;
#pragma unroll
        for (int c = 0; c < LC; ++c)
          if (lane + 32 * c < D) out[lane + 32 * c] = v[i][c];
      }
    }
    __syncthreads();
    clk.lap(kLn2);

    // msg P1 + pb1 into the other F; meanwhile the next tile's features
    // into X
    const float* msg = F;
    F = step++ & 1 ? F1 : F0;
    if (product_warp) {
      if (!landed) {
        bar_wait(&bars[2], 0);
        clk.lap(kWeights);
      }
      product<TE>(k, msg, L.ldd, D, P1, share, F, L.ldd);
    } else if (next < tiles) {
      copy_rows<TE>(scalars(it + 1), a.h, D, X, L.ldx, kProductWarps,
                    kWarps - kProductWarps);
    }
    landed = true;
    clk.lap(kProducts);
    cluster_barrier(k.C);
    clk.lap(kBarriers);
  }
  // the last tile's LN3 (its products and every peer's are complete)
  if (done > 0 && !product_warp)
    ln3((tile - G) * TE, step & 1 ? F0 : F1, scalars(it - 1));
  // a block whose warps had no tile still waits for the copies before it
  // exits
  if (!landed || !product_warp)
    for (int s = 0; s < 3; ++s) bar_wait(&bars[s], 0);
  clk.finish(done);
}

// One warp per node: sum its CSR row of per-edge messages in ascending order.
__global__ void __launch_bounds__(kThreads) egnn_reduce_kernel(
    const int64_t* __restrict__ order, const int64_t* __restrict__ rowptr,
    const float* __restrict__ msg_e, const float* __restrict__ pos_e,
    float* __restrict__ msg_out, float* __restrict__ pos_out,
    float* __restrict__ cnt_out, int N, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long node = (long long)blockIdx.x * kWarps + warp;
  if (node >= N) return;
  const int64_t beg = rowptr[node], end = rowptr[node + 1];
  float acc[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) acc[c] = 0.f;
  float pacc = 0.f;
  for (int64_t k = beg; k < end; ++k) {
    const int64_t e = order[k];
    const float* m = msg_e + (size_t)e * D;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) acc[c] += m[col];
    }
    if (lane < 3) pacc += pos_e[(size_t)e * 3 + lane];
  }
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int col = lane + 32 * c;
    if (col < D) msg_out[(size_t)node * D + col] = acc[c];
  }
  if (lane < 3) pos_out[(size_t)node * 3 + lane] = pacc;
  if (lane == 0) cnt_out[node] = (float)(end - beg);
}

// The launch configuration of a grid of `clusters` clusters of C blocks.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ClusterLaunch(int C, int clusters, int smem, cudaStream_t stream) : cfg{}, attr{} {
    cfg.gridDim = dim3(C * clusters);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// cuTensorMapEncodeTiled, looked up at run time through
// cudaGetDriverEntryPoint (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_weights(CUtensorMap* map, const void* w, int D, int share) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)(4 * D + 12)};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)share, (cuuint32_t)kBoxRows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                              const_cast<void*>(w), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Clusters of egnn_edge_kernel<TE, LC, Idx> the card holds at once at width
// D (launch == nullptr), or the launch itself on at most `clusters` clusters.
template <int TE, int LC, typename Idx>
int edges(int D, EdgeArgs<Idx>* launch, int clusters, int* count,
          cudaStream_t stream) {
  const int C = res_cluster(D);
  if (C == 0) return (int)cudaErrorInvalidValue;
  const int smem = res_smem_bytes(TE, D, res_share(D, C, 0));
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      egnn_edge_kernel<TE, LC, Idx>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (launch == nullptr) {
    ClusterLaunch l(C, 1, smem, stream);
    err = cudaOccupancyMaxActiveClusters(count, egnn_edge_kernel<TE, LC, Idx>, &l.cfg);
    if (err != cudaSuccess) return (int)err;
    return *count > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
  }
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  err = encode_weights(&launch->wmap, launch->w, D, res_share(D, C, 0));
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (launch->E + TE - 1) / TE;
  ClusterLaunch l(C, (int)(tiles < clusters ? tiles : clusters), smem, stream);
  err = cudaLaunchKernelEx(&l.cfg, egnn_edge_kernel<TE, LC, Idx>, *launch);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A row step's columns a lane: 4 up to D 128, else 8
template <int LC, typename Idx>
int edges(int D, int tile, EdgeArgs<Idx>* launch, int clusters, int* count,
          cudaStream_t stream) {
  if (tile == 8) return edges<8, LC, Idx>(D, launch, clusters, count, stream);
  if (tile == 16) return edges<16, LC, Idx>(D, launch, clusters, count, stream);
  if (tile == 24) return edges<24, LC, Idx>(D, launch, clusters, count, stream);
  if (tile == 32) return edges<32, LC, Idx>(D, launch, clusters, count, stream);
  if (tile == 40) return edges<40, LC, Idx>(D, launch, clusters, count, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename Idx>
int edges(int D, int tile, EdgeArgs<Idx>* launch, int clusters, int* count,
          cudaStream_t stream) {
  return D <= 128 ? edges<4, Idx>(D, tile, launch, clusters, count, stream)
                  : edges<8, Idx>(D, tile, launch, clusters, count, stream);
}

template <typename Idx>
int launch_edges(const void* send, const void* recv, const void* emask,
                 const void* h, const void* pos, const void* w, void* msg_e,
                 void* pos_e, int E, int D, int tile, int clusters, void* stamps,
                 cudaStream_t stream) {
  EdgeArgs<Idx> a{};
  a.send = static_cast<const Idx*>(send);
  a.recv = static_cast<const Idx*>(recv);
  a.emask = static_cast<const uint8_t*>(emask);
  a.h = static_cast<const float*>(h);
  a.pos = static_cast<const float*>(pos);
  a.w = static_cast<const float*>(w);
  a.msg_e = static_cast<float*>(msg_e);
  a.pos_e = static_cast<float*>(pos_e);
  a.stamps = static_cast<long long*>(stamps);
  a.E = E;
  a.D = D;
  return edges<Idx>(D, tile, &a, clusters, nullptr, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every launching function returns
// the cudaError_t of its launch (0 = success).  Shapes and types are checked
// by the Python wrapper (ops/edge.py), which also builds the CSR and takes
// the tile from resident_plan.

extern "C" const char* gmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The plan's C twin: out[0] cluster, out[1] tile, out[2] shared bytes,
// out[3 + r] block r's share (r < cluster); cudaErrorInvalidValue when D has
// no plan.
extern "C" int gmp_egnn_resident_plan(int D, int E, int clusters, int* out) {
  int C = 0, tile = 0, smem = 0;
  if (!res_plan(D, E, clusters, &C, &tile, &smem)) return (int)cudaErrorInvalidValue;
  out[0] = C;
  out[1] = tile;
  out[2] = smem;
  for (int r = 0; r < C; ++r) out[3 + r] = res_share(D, C, r);
  return 0;
}

// Clusters of the edge kernel the card holds at once at width D and tile
// (into *out); cudaErrorInvalidConfiguration when that is 0.
extern "C" int gmp_egnn_resident_clusters(int device, int D, int tile, int idx64,
                                          int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return idx64 ? edges<long long>(D, tile, nullptr, 0, out, nullptr)
               : edges<int>(D, tile, nullptr, 0, out, nullptr);
}

// stamps: null, or kStamps (11) 64-bit slots (Clock::finish)
extern "C" int gmp_egnn_edges(int device, const void* send, const void* recv,
                              int idx64, const void* emask, const void* h,
                              const void* pos, const void* w, void* msg_e,
                              void* pos_e, int E, int D, int tile, int clusters,
                              void* stamps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return idx64 ? launch_edges<long long>(send, recv, emask, h, pos, w, msg_e, pos_e,
                                         E, D, tile, clusters, stamps, s)
               : launch_edges<int>(send, recv, emask, h, pos, w, msg_e, pos_e, E,
                                   D, tile, clusters, stamps, s);
}

extern "C" int gmp_egnn_reduce(int device, const void* order,
                               const void* rowptr, const void* msg_e,
                               const void* pos_e, void* msg_out,
                               void* pos_out, void* cnt_out, int N, int D,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0) return 0;
  const int blocks = (N + kWarps - 1) / kWarps;
  egnn_reduce_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(order), static_cast<const int64_t*>(rowptr),
      static_cast<const float*>(msg_e), static_cast<const float*>(pos_e),
      static_cast<float*>(msg_out), static_cast<float*>(pos_out),
      static_cast<float*>(cnt_out), N, D);
  return (int)cudaGetLastError();
}
