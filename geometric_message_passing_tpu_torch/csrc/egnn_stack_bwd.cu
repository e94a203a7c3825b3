// The whole EGNN stack, backward, in one launch, for Hopper (sm_90a), exact
// f32 on the CUDA cores.
//
// Replaces geometric_message_passing_tpu/ops/pallas_egnn_stack.py::
// _stack_bwd_kernel (launched by make_egnn_stack_fused's backward), the TPU
// kernel that reruns the stack's forward once, keeping each layer's input
// (h, pos) in VMEM, and then takes jax.vjp of one layer per grid step from
// layer L-1 down to 0, carrying the cotangents (dh, dpos) in scratch and
// writing that layer's dW block.  Same function: (dh0, dpos0, dW [L, 7D+18,
// D]) given the cotangents (gh, gpos) of the stack's outputs; masked-off
// edges contribute nothing.  Not the TPU algorithm: no vjp runs inside the
// kernel (the backward is written out, as ops/egnn_stack.py's
// egnn_stack_bwd_plain mirrors), gathers and sums are indexed loads and CSR
// rows instead of one-hot [E, N] matmuls, and N and E are not limited.
//
// What bounds it: latency, as the forward (egnn_stack.cu).  Per layer the
// backward needs about twice the forward's products (the input cotangents
// dz W^T and the weight gradients x^T dz), some 0.7 GFLOP for 4 layers at a
// star batch, 10 us at the f32 rate.  One persistent cooperative launch
// takes the per-layer launches away; grid barriers separate the phases:
//   forward, l = 0 .. L-1 (as egnn_stack.cu): edges (edge_fwd_tile) |
//     barrier | nodes (node_fwd_tile) | barrier, keeping each layer's input
//     (h, pos), message sums msg_acc and every LayerNorm's xhat and rstd
//     (and each edge's scale) in device memory, so the backward recomputes
//     nothing;
//   backward, l = L-1 .. 0, the cotangent (dh, dpos) carried in dh0/dpos0:
//     1. nodes (node_bwd_tile): the update MLP differentiated from its kept
//        activations: dh + d(upd)/dh, the message sum's cotangent gmsg, the
//        position sum's gpos = dpos / max(cnt, 1), and per node the
//        operands of the update MLP's weight gradients; with the sum of
//        layer l+1's weight-gradient slices;
//     2. barrier; edges (egnn_common.cuh's edge_bwd_tile, K2's) given gmsg
//        and gpos; barrier;
//     3. work items: the node sums of the edge cotangents (receiver then
//        sender CSR rows, ascending edge order) into the carry; the weight
//        gradients of the message rows over slices of edges and of the
//        update rows over slices of nodes (`split` rows a slice, from
//        ops/edge.py::bwd_split; tiles of 32 rows x 128 columns and column
//        sums, rows summed in order); barrier;
//   and the last layer's slice sum.  No atomics in any sum: two runs are
//   bitwise equal.  The tiles, their products (a ring of weight K-tiles
//   filled by bulk copies, register blocking) and the tile rule are the
//   forward's (egnn_stack.cu); the products by transposed weight blocks
//   read transposed copies that every block writes for its share before
//   the forward sweep.  Keeping the activations costs L (3D + 4) floats per
//   edge and L (2D + 4) per node (0.8 GB at 4 x 128 on the 10k-atom box's
//   129k edges) and takes the forward's products out of every backward
//   layer; the kernel runs two blocks an SM (at most 128 registers a
//   thread).

#include <cuda_runtime.h>
#include <stdint.h>

#include "egnn_common.cuh"

using namespace egnn;

namespace {

// The update MLP's two matrices in node_bwd_tile's `ops` rows
// [u_in (2D) | u (D) | dz1, dy1*xhat1, dy1, dz2, dy2*xhat2, dy2 (D each)].
__device__ __forceinline__ Stage upd_stage(int s, int D) {
  if (s == 0) return Stage{2 * D, 0, 3 * D, 0};
  return Stage{D, 2 * D, 6 * D, 2 * D + 3};
}

// dW row (within the update rows) of the update MLP's vector row v (0..5):
// ub1 ug1 uB1 after U1, ub2 ug2 uB2 after U2.
__device__ __forceinline__ int upd_vec_row(int v, int D) {
  return v < 3 ? 2 * D + v : 3 * D + v;
}

constexpr int kUpdVecRows = 6;

// The update MLP's backward on nodes [TE tile, TE tile + TE) of one layer,
// given the layer's input h, its message sums macc, the update MLP's kept
// activations act [N, act_node_ld(D)] (node_fwd_tile's), its transposed
// weights wtu (U2^T, U1[:D]^T, U1[D:]^T; transpose_weights) and the carried
// cotangents gh [N, D], gpos [N, 3] of the layer's outputs.  Writes per
// node: dhn = gh + d(upd)/dh, gmsg = d(upd)/d(msg_acc), gps = gpos /
// max(cnt, 1) and one row of `ops` [N, 9D] (layout above).
template <int TE>
__device__ void node_bwd_tile(
    long long tile, const int64_t* __restrict__ rowptr, const float* h,
    const float* macc, const float* __restrict__ Wu, const float* wtu,
    const float* act, const float* gh, const float* gpos, float* ops,
    float* dhn, float* gmsg, float* gps, long long N, int D, float* smem) {
  constexpr int TR = TE / 8;
  const Tile t = carve(smem, TE, D);
  const size_t ld = (size_t)9 * D, lda = act_node_ld(D), dd = (size_t)D * D;
  const int lane = lane_id();
  const long long n0 = tile * TE;
  const UpdWeights w = upd_weights(Wu, D);
  const Weights u2t{wtu, D, D}, u1ht{wtu + dd, D, D}, u1mt{wtu + 2 * dd, D, D};
  Row v, xh;
  __syncthreads();
  prefetch<TR>(t, u2t);

  // ---- dy2 = gh where upd > 0; LN backward -> dz2 ----
  for (int row = warp_id(); row < TE; row += kWarps) {
    const long long node = n0 + row;
    float* y = t.Y + row * t.ldd;
    if (node >= N) {
      for (int c = lane; c < D; c += 32) y[c] = 0.f;
      continue;
    }
    const float* a = act + (size_t)node * lda;
    float* o = ops + (size_t)node * ld;
    // every load of the row first: the stores below may alias them
    Row hv, mv, g;
    get_row_cg(h + (size_t)node * D, D, hv);
    get_row_cg(macc + (size_t)node * D, D, mv);
    get_row_cg(gh + (size_t)node * D, D, g);
    get_row_cg(a, D, xh);
    get_row_cg(a + D, D, v);
    const float rstd2 = __ldcg(a + 2 * D + 1);
    const float gp = lane < 3 ? __ldcg(gpos + (size_t)node * 3 + lane) : 0.f;
    put_row(hv, o, D);
    put_row(mv, o + D, D);
    if (lane < 3)
      gps[(size_t)node * 3 + lane] =
          gp / fmaxf((float)(rowptr[node + 1] - rowptr[node]), 1.f);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      hv[c] = lane + 32 * c < D ? affine_relu(xh[c], w.ug1, w.uB1, lane + 32 * c) : 0.f;
    put_row(hv, o + 2 * D, D);                                // u
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      xh[c] = v[c];                                           // xhat2
      v[c] = (col < D && affine_relu(xh[c], w.ug2, w.uB2, col) > 0.f) ? g[c] : 0.f;
    }
    put_row(v, xh, o + 7 * D, D);                             // dy2 * xhat2
    put_row(v, o + 8 * D, D);                                 // dy2
    row_ln_bwd(v, xh, rstd2, w.ug2, D);
    put_row(v, o + 6 * D, D);                                 // dz2
    put_row(v, y, D);
  }

  // ---- du = dz2 U2^T; dy1 = du where u > 0; LN backward -> dz1 ----
  mm<TR>(t.Y, t.ldd, u2t, t, t.C, t.ldd, &u1ht);
  for (int row = warp_id(); row < TE; row += kWarps) {
    const long long node = n0 + row;
    if (node >= N) continue;
    const float* a = act + (size_t)node * lda;
    float* o = ops + (size_t)node * ld;
    const float rstd1 = __ldcg(a + 2 * D);
    get_row_cg(a, D, xh);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      v[c] = (col < D && affine_relu(xh[c], w.ug1, w.uB1, col) > 0.f)
                 ? t.C[row * t.ldd + col] : 0.f;
    }
    put_row(v, xh, o + 4 * D, D);                             // dy1 * xhat1
    put_row(v, o + 5 * D, D);                                 // dy1
    row_ln_bwd(v, xh, rstd1, w.ug1, D);
    put_row(v, o + 3 * D, D);                                 // dz1
    put_row(v, t.Y + row * t.ldd, D);
  }

  // ---- d/dh = dz1 U1[:D]^T, d/dmsg_acc = dz1 U1[D:]^T ----
  for (int part = 0; part < 2; ++part) {
    mm<TR>(t.Y, t.ldd, part == 0 ? u1ht : u1mt, t, t.C, t.ldd,
           part == 0 ? &u1mt : nullptr);
    for (int row = warp_id(); row < TE; row += kWarps) {
      const long long node = n0 + row;
      if (node >= N) continue;
      for (int c = lane; c < D; c += 32) {
        const float g = t.C[row * t.ldd + c];
        if (part == 0)
          dhn[(size_t)node * D + c] = __ldcg(gh + (size_t)node * D + c) + g;
        else
          gmsg[(size_t)node * D + c] = g;
      }
    }
  }
}

}  // namespace

template <typename Idx>
struct BwdArgs {
  const Idx *send, *recv;
  const uint8_t* emask;
  const float *h0, *pos0, *w, *gh, *gpos;
  const int64_t *order_r, *rowptr_r, *order_s, *rowptr_s;
  float *h_ck, *pos_ck, *macc, *msg_e, *pos_e, *act_e, *act_n, *wt, *nops,
      *dhn, *gmsg, *gps, *eops, *dhi, *dhj, *dpd, *part_e, *part_n, *dh, *dpos,
      *dw;
  unsigned int* bar;
  unsigned long long* stamps;   // phase clock readings, or null
  long long N, E;
  int D, L, split;
};

// Work items of the reduction phase, in this order: node sums (8 nodes
// each), message dW tiles (32 rows x 128 columns), message vector-row
// columns, update dW tiles, update vector-row columns.
struct ReduceItems {
  long long node, ew, ec, nw, nc;
  int t_w1, t_u1, t_d, ct, se, sn;
};

__host__ __device__ inline ReduceItems reduce_items(long long N, long long E,
                                                    int D, int split) {
  ReduceItems it;
  it.t_w1 = (2 * D + 1 + kTile - 1) / kTile;
  it.t_u1 = (2 * D + kTile - 1) / kTile;
  it.t_d = (D + kTile - 1) / kTile;
  it.ct = (D + kWgradCols - 1) / kWgradCols;
  it.se = E > 0 ? (int)((E + split - 1) / split) : 1;
  it.sn = N > 0 ? (int)((N + split - 1) / split) : 1;
  it.node = (N + kWarps - 1) / kWarps;
  it.ew = (long long)(it.t_w1 + 2 * it.t_d) * it.ct * it.se;
  it.ec = (long long)kVecRows * it.t_d * it.se;
  it.nw = (long long)(it.t_u1 + it.t_d) * it.ct * it.sn;
  it.nc = (long long)kUpdVecRows * it.t_d * it.sn;
  return it;
}

template <typename Idx>
__device__ void reduce_item(const BwdArgs<Idx>& a, const ReduceItems& it,
                            long long k, float* smem) {
  const int D = a.D;
  if (k < it.node) {
    const long long node = k * kWarps + (threadIdx.x >> 5);
    if (node < a.N)
      node_grad_sum(node, a.order_r, a.rowptr_r, a.order_s, a.rowptr_s, a.dhi,
                    a.dhj, a.dpd, a.dhn, a.dpos, a.dh, a.dpos, D);
    return;
  }
  k -= it.node;
  const size_t ld_e = ops_edge_ld(D), ld_n = (size_t)9 * D;
  const size_t part_e = (size_t)(4 * D + 12) * D, part_n = (size_t)(3 * D + 6) * D;
  if (k < it.ew) {
    const int tx = it.t_w1 + 2 * it.t_d;
    int x = (int)(k % tx);
    const int y = (int)((k / tx) % it.ct), z = (int)(k / ((long long)tx * it.ct));
    const Stage st = stage_of_tile(x, 3, D, msg_stage);
    const long long beg = (long long)z * a.split, end = min(a.E, beg + a.split);
    wgrad_tile(a.eops, ld_e, st, x * kTile, y * kWgradCols, beg, end,
               a.part_e + z * part_e, D, smem);
    return;
  }
  k -= it.ew;
  if (k < it.ec) {
    const int v = (int)(k % kVecRows), y = (int)((k / kVecRows) % it.t_d);
    const int z = (int)(k / ((long long)kVecRows * it.t_d));
    const long long beg = (long long)z * a.split, end = min(a.E, beg + a.split);
    colsum_cols(a.eops, ld_e, ops_vec(D) + v * D, msg_vec_row(v, D), y * 32, beg,
                end, a.part_e + z * part_e, D, smem);
    return;
  }
  k -= it.ec;
  if (k < it.nw) {
    const int tx = it.t_u1 + it.t_d;
    int x = (int)(k % tx);
    const int y = (int)((k / tx) % it.ct), z = (int)(k / ((long long)tx * it.ct));
    const Stage st = stage_of_tile(x, 2, D, upd_stage);
    const long long beg = (long long)z * a.split, end = min(a.N, beg + a.split);
    wgrad_tile(a.nops, ld_n, st, x * kTile, y * kWgradCols, beg, end,
               a.part_n + z * part_n, D, smem);
    return;
  }
  k -= it.nw;
  const int v = (int)(k % kUpdVecRows), y = (int)((k / kUpdVecRows) % it.t_d);
  const int z = (int)(k / ((long long)kUpdVecRows * it.t_d));
  const long long beg = (long long)z * a.split, end = min(a.N, beg + a.split);
  colsum_cols(a.nops, ld_n, 3 * D + v * D, upd_vec_row(v, D), y * 32, beg, end,
              a.part_n + z * part_n, D, smem);
}

// dW of layer l: the message rows the sum of the edge slices' partials, the
// update rows the sum of the node slices', each in slice order.
template <typename Idx>
__device__ void slice_sum(const BwdArgs<Idx>& a, const ReduceItems& it, int l) {
  const size_t size_e = (size_t)(4 * a.D + 12) * a.D;
  const size_t size_n = (size_t)(3 * a.D + 6) * a.D;
  float* dw = a.dw + (size_t)l * (size_e + size_n);
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < size_e + size_n;
       i += (size_t)gridDim.x * kThreads) {
    float t = 0.f;
    if (i < size_e)
      for (int z = 0; z < it.se; ++z) t += __ldcg(a.part_e + z * size_e + i);
    else
      for (int z = 0; z < it.sn; ++z) t += __ldcg(a.part_n + z * size_n + (i - size_e));
    dw[i] = t;
  }
}

template <int TE, typename Idx>
__global__ void __launch_bounds__(kThreads, 2) egnn_stack_bwd_kernel(const BwdArgs<Idx> a) {
  extern __shared__ __align__(16) float smem[];
  ring_init(smem);
  const int D = a.D;
  const long long N = a.N, E = a.E;
  const long long edge_tiles = (E + TE - 1) / TE;
  const long long node_tiles = (N + TE - 1) / TE;
  const size_t rows = (size_t)(7 * D + 18) * D;        // floats per layer
  const size_t msg_floats = (size_t)(4 * D + 12) * D;
  // kept activations per layer (floats)
  const size_t layer_ae = (size_t)E * act_edge_ld(D), layer_an = (size_t)N * act_node_ld(D);
  const ReduceItems it = reduce_items(N, E, D, a.split);
  const long long items = it.node + it.ew + it.ec + it.nw + it.nc;
  const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * kThreads;

  int ph = 0;
  phase_stamp(a.stamps, ph);
  // the carried cotangent starts at the outputs' cotangents; each layer's
  // transposed weight blocks for the backward's products (read by bulk
  // copies after the forward sweep's barriers: the proxy fence orders these
  // writes before those reads)
  for (size_t i = tid; i < (size_t)N * D; i += stride) a.dh[i] = a.gh[i];
  for (size_t i = tid; i < (size_t)N * 3; i += stride) a.dpos[i] = a.gpos[i];
  for (int l = 0; l < a.L; ++l)
    transpose_weights(a.w + (size_t)l * rows, a.wt + (size_t)l * 7 * D * D, D,
                      true, tid, stride);
  asm volatile("fence.proxy.async.global;" ::: "memory");

  // ---- forward, keeping each layer's input, message sums and activations ----
  for (int l = 0; l < a.L; ++l) {
    const float* W = a.w + (size_t)l * rows;
    const float* h = l == 0 ? a.h0 : a.h_ck + (size_t)(l - 1) * N * D;
    const float* pos = l == 0 ? a.pos0 : a.pos_ck + (size_t)(l - 1) * N * 3;
    const bool last = l + 1 == a.L;
    for (long long t = blockIdx.x; t < edge_tiles; t += gridDim.x)
      edge_fwd_tile<TE, Idx>(t, a.send, a.recv, a.emask, h, pos, W, a.msg_e,
                             a.pos_e, a.act_e + l * layer_ae, E, D, smem);
    grid_sync(a.bar);
    phase_stamp(a.stamps, ph);
    for (long long t = blockIdx.x; t < node_tiles; t += gridDim.x)
      node_fwd_tile<TE>(t, a.order_r, a.rowptr_r, a.msg_e, a.pos_e, h, pos,
                        W + msg_floats, a.macc + (size_t)l * N * D,
                        last ? nullptr : a.h_ck + (size_t)l * N * D,
                        last ? nullptr : a.pos_ck + (size_t)l * N * 3,
                        a.act_n + l * layer_an, N, D, smem);
    grid_sync(a.bar);
    phase_stamp(a.stamps, ph);
  }

  // ---- backward, layer by layer ----
  for (int l = a.L - 1; l >= 0; --l) {
    const float* W = a.w + (size_t)l * rows;
    const float* h = l == 0 ? a.h0 : a.h_ck + (size_t)(l - 1) * N * D;
    const float* pos = l == 0 ? a.pos0 : a.pos_ck + (size_t)(l - 1) * N * 3;
    for (long long t = blockIdx.x; t < node_tiles; t += gridDim.x)
      node_bwd_tile<TE>(t, a.rowptr_r, h, a.macc + (size_t)l * N * D,
                        W + msg_floats, a.wt + ((size_t)l * 7 + 4) * D * D,
                        a.act_n + l * layer_an, a.dh, a.dpos, a.nops, a.dhn,
                        a.gmsg, a.gps, N, D, smem);
    if (l + 1 < a.L) slice_sum(a, it, l + 1);
    grid_sync(a.bar);
    phase_stamp(a.stamps, ph);
    for (long long t = blockIdx.x; t < edge_tiles; t += gridDim.x)
      edge_bwd_tile<TE, Idx>(t, a.send, a.recv, a.emask, h, pos, W,
                             a.wt + (size_t)l * 7 * D * D,
                             a.act_e + l * layer_ae, a.gmsg, a.gps, a.eops, a.dhi,
                             a.dhj, a.dpd, E, D, smem);
    grid_sync(a.bar);
    phase_stamp(a.stamps, ph);
    for (long long k = blockIdx.x; k < items; k += gridDim.x)
      reduce_item(a, it, k, smem + kHead);   // the ring's head stays
    grid_sync(a.bar);
    phase_stamp(a.stamps, ph);
  }
  slice_sum(a, it, 0);
  __syncthreads();
  phase_stamp(a.stamps, ph);
}

namespace {

template <int TE, typename Idx>
int launch(const BwdArgs<Idx>& a, cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const size_t smem = sizeof(float) * stack_bwd_smem_floats(TE, a.D);
  err = cudaFuncSetAttribute(egnn_stack_bwd_kernel<TE, Idx>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, egnn_stack_bwd_kernel<TE, Idx>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // as many blocks as the card holds at once, but no more than the largest
  // phase has tiles or items
  const ReduceItems it = reduce_items(a.N, a.E, a.D, a.split);
  long long work = it.node + it.ew + it.ec + it.nw + it.nc;
  const long long tiles = ((a.E > a.N ? a.E : a.N) + TE - 1) / TE;
  if (tiles > work) work = tiles;
  const long long cap = (long long)per_sm * sms;
  const int grid = (int)(work < cap ? work : cap);
  void* args[] = {const_cast<BwdArgs<Idx>*>(&a)};
  err = cudaLaunchCooperativeKernel(egnn_stack_bwd_kernel<TE, Idx>, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

constexpr int kBufs = 21;   // float buffers, then the barrier

template <typename Idx>
int run(const void* send, const void* recv, const void* emask, const void* h0,
        const void* pos0, const void* w, const void* gh, const void* gpos,
        const void* order_r, const void* rowptr_r, const void* order_s,
        const void* rowptr_s, void* const* bufs, int N, int E, int D, int L,
        int split, int tile, void* stamps, cudaStream_t stream) {
  float* f[kBufs];
  for (int i = 0; i < kBufs; ++i) f[i] = static_cast<float*>(bufs[i]);
  const BwdArgs<Idx> a{
      static_cast<const Idx*>(send), static_cast<const Idx*>(recv),
      static_cast<const uint8_t*>(emask), static_cast<const float*>(h0),
      static_cast<const float*>(pos0), static_cast<const float*>(w),
      static_cast<const float*>(gh), static_cast<const float*>(gpos),
      static_cast<const int64_t*>(order_r), static_cast<const int64_t*>(rowptr_r),
      static_cast<const int64_t*>(order_s), static_cast<const int64_t*>(rowptr_s),
      f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10], f[11],
      f[12], f[13], f[14], f[15], f[16], f[17], f[18], f[19], f[20],
      static_cast<unsigned int*>(bufs[kBufs]),
      static_cast<unsigned long long*>(stamps), N, E, D, L, split};
  if (tile == 8) return launch<8, Idx>(a, stream);
  if (tile == 16) return launch<16, Idx>(a, stream);
  if (tile == 32) return launch<32, Idx>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the first cudaError_t
// (0 = success).  Shapes and types are checked, the CSRs built and the
// buffers allocated by the Python wrapper (ops/egnn_stack.py::bwd_buffers,
// in this order): h_ck [L-1, N, D], pos_ck [L-1, N, 3], macc [L, N, D],
// msg_e [E, D], pos_e [E, 3], act_e [L, E, 3D+4], act_n [L, N, 2D+4], wt
// [L, 7, D, D] (transposed weight blocks), nops [N, 9D], dhn [N, D], gmsg [N, D], gps [N, 3], eops [E, 15D+4], dhi
// and dhj [E, D], dpd [E, 3], part_e [max(1, ceil(E/split)), 4D+12, D],
// part_n [max(1, ceil(N/split)), 3D+6, D], the outputs dh0 [N, D], dpos0
// [N, 3], dw [L, 7D+18, D], and bar, two zeroed 32-bit counters; stamps
// null, or 5L + 2 64-bit slots for the clock at the start and after each
// phase; split is a positive multiple of 32, tile one of 8, 16 and 32.

extern "C" const char* gmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int gmp_egnn_stack_bwd(
    int device, const void* send, const void* recv, int idx64,
    const void* emask, const void* h0, const void* pos0, const void* w,
    const void* gh, const void* gpos, const void* order_r,
    const void* rowptr_r, const void* order_s, const void* rowptr_s,
    void* h_ck, void* pos_ck, void* macc, void* msg_e, void* pos_e,
    void* act_e, void* act_n, void* wt, void* nops, void* dhn, void* gmsg,
    void* gps,
    void* eops, void* dhi, void* dhj, void* dpd, void* part_e, void* part_n,
    void* dh0, void* dpos0, void* dw, void* bar, void* stamps, int N, int E,
    int D, int L, int split, int tile, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0) return 0;
  void* const bufs[] = {h_ck, pos_ck, macc, msg_e, pos_e, act_e, act_n, wt,
                        nops, dhn, gmsg, gps, eops, dhi, dhj, dpd, part_e,
                        part_n, dh0, dpos0, dw, bar};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return idx64 ? run<long long>(send, recv, emask, h0, pos0, w, gh, gpos,
                                order_r, rowptr_r, order_s, rowptr_s, bufs, N,
                                E, D, L, split, tile, stamps, s)
               : run<int>(send, recv, emask, h0, pos0, w, gh, gpos, order_r,
                          rowptr_r, order_s, rowptr_s, bufs, N, E, D, L, split,
                          tile, stamps, s);
}
