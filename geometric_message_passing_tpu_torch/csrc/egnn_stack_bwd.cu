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
// recomputed forward and the backward need about three times the forward's
// products (the input cotangents dz W^T and the weight gradients x^T dz),
// some 1 GFLOP for 4 layers at a star batch, 15 us at the f32 rate.  One
// persistent cooperative launch takes the per-layer launches away; grid
// barriers separate the phases:
//   forward, l = 0 .. L-1 (as egnn_stack.cu, layer inputs kept):
//     edges (edge_fwd_tile) | barrier | nodes (node_fwd_tile: the message
//     sums msg_acc kept per layer, h and pos of layer l+1 written) | barrier
//   backward, l = L-1 .. 0, the cotangent (dh, dpos) carried in dh0/dpos0:
//     1. nodes (node_bwd_tile): the update MLP recomputed from (h, msg_acc)
//        and differentiated: dh + d(upd)/dh, the message sum's cotangent
//        gmsg, the position sum's gpos = dpos / max(cnt, 1), and per node
//        the operands of the update MLP's weight gradients; with the sum of
//        layer l+1's weight-gradient slices;
//     2. barrier; edges (egnn_common.cuh's edge_bwd_tile, K2's edge kernel)
//        given gmsg and gpos; barrier;
//     3. work items: the node sums of the edge cotangents (receiver then
//        sender CSR rows, ascending edge order) into the carry; the weight
//        gradients of the message rows over slices of 512 edges and of the
//        update rows over slices of 512 nodes (32 x 32 tiles and column
//        sums, rows summed in order); barrier;
//   and the last layer's slice sum.  No atomics in any sum: two runs are
//   bitwise equal.

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

// The update MLP's backward on nodes [16 tile, 16 tile + 16) of one layer,
// given the layer's input h, its message sums macc and the carried
// cotangents gh [N, D], gpos [N, 3] of the layer's outputs.  Writes per node:
// dhn = gh + d(upd)/dh, gmsg = d(upd)/d(msg_acc), gps = gpos / max(cnt, 1)
// and one row of `ops` [N, 9D] (layout above).
__device__ void node_bwd_tile(
    long long tile, const int64_t* __restrict__ rowptr, const float* h,
    const float* macc, const float* __restrict__ Wu, const float* gh,
    const float* gpos, float* ops, float* dhn, float* gmsg, float* gps,
    long long N, int D, float* smem) {
  float* uin = smem;                       // [kTileRows, 2D]: [h, msg_acc]
  float* ys = uin + kTileRows * 2 * D;     // [kTileRows, D]: u, later dz
  float* ws = ys + kTileRows * D;          // weight tile, [kTileK, D] or [D, kTStride]
  const size_t ld = (size_t)9 * D;
  const int lane = lane_id();
  const long long n0 = tile * kTileRows;
  __syncthreads();

  bool live[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp_row(r);
    const long long node = n0 + row;
    live[r] = node < N;
    float* u = uin + row * 2 * D;
    if (live[r]) {
      for (int c = lane; c < D; c += 32) {
        u[c] = __ldcg(h + (size_t)node * D + c);
        u[D + c] = __ldcg(macc + (size_t)node * D + c);
      }
      if (lane < 3)
        gps[(size_t)node * 3 + lane] =
            __ldcg(gpos + (size_t)node * 3 + lane) /
            fmaxf((float)(rowptr[node + 1] - rowptr[node]), 1.f);
    } else {
      for (int c = lane; c < 2 * D; c += 32) u[c] = 0.f;
    }
    __syncwarp();
    if (live[r])
      for (int c = lane; c < 2 * D; c += 32) ops[(size_t)node * ld + c] = u[c];
  }

  const UpdWeights w = upd_weights(Wu, D);
  Rows acc, xh1, xh2, t;
  float rstd1[kRowsPerWarp], rstd2[kRowsPerWarp];

  // ---- forward recompute ----
  matmul_rows(uin, 2 * D, 2 * D, w.U1, D, ws, acc);   // u = relu(LN(u_in U1 + ub1))
  bias_normalise(acc, w.ub1, D, rstd1);
  copy_rows(acc, xh1);
  affine_relu(xh1, w.ug1, w.uB1, D, t);
  store_smem(t, ys, D, D);
  store_edges(t, ops + 2 * D, ld, n0, N, live, D);
  matmul_rows(ys, D, D, w.U2, D, ws, acc);            // upd = relu(LN(u U2 + ub2))
  bias_normalise(acc, w.ub2, D, rstd2);
  copy_rows(acc, xh2);
  affine_relu(xh2, w.ug2, w.uB2, D, t);

  // ---- dy2 = gh where upd > 0; LN backward -> dz2; du = dz2 U2^T ----
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const long long node = n0 + warp_row(r);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      acc[r][c] = (live[r] && col < D && t[r][c] > 0.f)
                      ? __ldcg(gh + (size_t)node * D + col) : 0.f;
    }
  }
  store_edges(acc, xh2, ops + 7 * D, ld, n0, N, live, D);   // dy2 * xhat2
  store_edges(acc, ops + 8 * D, ld, n0, N, live, D);        // dy2
  ln_backward(acc, xh2, rstd2, w.ug2, D);
  store_edges(acc, ops + 6 * D, ld, n0, N, live, D);        // dz2
  store_smem(acc, ys, D, D);
  matmul_rows_t(ys, D, w.U2, D, ws, acc);

  // ---- dy1 = du where u > 0; LN backward -> dz1; du_in = dz1 U1^T ----
  affine_relu(xh1, w.ug1, w.uB1, D, t);                     // u
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[r][c] = t[r][c] > 0.f ? acc[r][c] : 0.f;
  store_edges(acc, xh1, ops + 4 * D, ld, n0, N, live, D);   // dy1 * xhat1
  store_edges(acc, ops + 5 * D, ld, n0, N, live, D);        // dy1
  ln_backward(acc, xh1, rstd1, w.ug1, D);
  store_edges(acc, ops + 3 * D, ld, n0, N, live, D);        // dz1
  store_smem(acc, ys, D, D);
  matmul_rows_t(ys, D, w.U1, D, ws, acc);                   // d/dh
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (!live[r]) continue;
    const long long node = n0 + warp_row(r);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D)
        dhn[(size_t)node * D + col] = __ldcg(gh + (size_t)node * D + col) + acc[r][c];
    }
  }
  matmul_rows_t(ys, D, w.U1 + (size_t)D * D, D, ws, acc);   // d/dmsg_acc
  store_edges(acc, gmsg, D, n0, N, live, D);
}

}  // namespace

template <typename Idx>
struct BwdArgs {
  const Idx *send, *recv;
  const uint8_t* emask;
  const float *h0, *pos0, *w, *gh, *gpos;
  const int64_t *order_r, *rowptr_r, *order_s, *rowptr_s;
  float *h_ck, *pos_ck, *macc, *msg_e, *pos_e, *nops, *dhn, *gmsg, *gps,
      *eops, *dhi, *dhj, *dpd, *part_e, *part_n, *dh, *dpos, *dw;
  unsigned int* bar;
  long long N, E;
  int D, L, split;
};

// Work items of the reduction phase, in this order: node sums (8 nodes
// each), message dW tiles, message vector-row columns, update dW tiles,
// update vector-row columns.
struct ReduceItems {
  long long node, ew, ec, nw, nc;
  int t_w1, t_u1, t_d, se, sn;
};

__host__ __device__ inline ReduceItems reduce_items(long long N, long long E,
                                                    int D, int split) {
  ReduceItems it;
  it.t_w1 = (2 * D + 1 + kTile - 1) / kTile;
  it.t_u1 = (2 * D + kTile - 1) / kTile;
  it.t_d = (D + kTile - 1) / kTile;
  it.se = E > 0 ? (int)((E + split - 1) / split) : 1;
  it.sn = N > 0 ? (int)((N + split - 1) / split) : 1;
  it.node = (N + kWarps - 1) / kWarps;
  it.ew = (long long)(it.t_w1 + 2 * it.t_d) * it.t_d * it.se;
  it.ec = (long long)kVecRows * it.t_d * it.se;
  it.nw = (long long)(it.t_u1 + it.t_d) * it.t_d * it.sn;
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
  const size_t ld_e = (size_t)15 * D + 1, ld_n = (size_t)9 * D;
  const size_t part_e = (size_t)(4 * D + 12) * D, part_n = (size_t)(3 * D + 6) * D;
  if (k < it.ew) {
    const int tx = it.t_w1 + 2 * it.t_d;
    int x = (int)(k % tx);
    const int y = (int)((k / tx) % it.t_d), z = (int)(k / ((long long)tx * it.t_d));
    const Stage st = stage_of_tile(x, 3, D, msg_stage);
    const long long beg = (long long)z * a.split, end = min(a.E, beg + a.split);
    wgrad_tile(a.eops, ld_e, st, x * kTile, y * kTile, beg, end,
               a.part_e + z * part_e, D, smem);
    return;
  }
  k -= it.ew;
  if (k < it.ec) {
    const int v = (int)(k % kVecRows), y = (int)((k / kVecRows) % it.t_d);
    const int z = (int)(k / ((long long)kVecRows * it.t_d));
    const long long beg = (long long)z * a.split, end = min(a.E, beg + a.split);
    colsum_cols(a.eops, ld_e, 4 * D + 1 + v * D, msg_vec_row(v, D), y * 32, beg,
                end, a.part_e + z * part_e, D, smem);
    return;
  }
  k -= it.ec;
  if (k < it.nw) {
    const int tx = it.t_u1 + it.t_d;
    int x = (int)(k % tx);
    const int y = (int)((k / tx) % it.t_d), z = (int)(k / ((long long)tx * it.t_d));
    const Stage st = stage_of_tile(x, 2, D, upd_stage);
    const long long beg = (long long)z * a.split, end = min(a.N, beg + a.split);
    wgrad_tile(a.nops, ld_n, st, x * kTile, y * kTile, beg, end,
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

template <typename Idx>
__global__ void __launch_bounds__(kThreads) egnn_stack_bwd_kernel(const BwdArgs<Idx> a) {
  extern __shared__ float smem[];
  const int D = a.D;
  const long long N = a.N, E = a.E;
  const long long edge_tiles = (E + kTileRows - 1) / kTileRows;
  const long long node_tiles = (N + kTileRows - 1) / kTileRows;
  const size_t rows = (size_t)(7 * D + 18) * D;        // floats per layer
  const size_t msg_floats = (size_t)(4 * D + 12) * D;
  const ReduceItems it = reduce_items(N, E, D, a.split);
  const long long items = it.node + it.ew + it.ec + it.nw + it.nc;
  const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * kThreads;

  // the carried cotangent starts at the outputs' cotangents
  for (size_t i = tid; i < (size_t)N * D; i += stride) a.dh[i] = a.gh[i];
  for (size_t i = tid; i < (size_t)N * 3; i += stride) a.dpos[i] = a.gpos[i];

  // ---- forward, keeping each layer's input and message sums ----
  for (int l = 0; l < a.L; ++l) {
    const float* W = a.w + (size_t)l * rows;
    const float* h = l == 0 ? a.h0 : a.h_ck + (size_t)(l - 1) * N * D;
    const float* pos = l == 0 ? a.pos0 : a.pos_ck + (size_t)(l - 1) * N * 3;
    const bool last = l + 1 == a.L;
    for (long long t = blockIdx.x; t < edge_tiles; t += gridDim.x)
      edge_fwd_tile<Idx>(t, a.send, a.recv, a.emask, h, pos, W, a.msg_e,
                         a.pos_e, E, D, smem);
    grid_sync(a.bar);
    for (long long t = blockIdx.x; t < node_tiles; t += gridDim.x)
      node_fwd_tile(t, a.order_r, a.rowptr_r, a.msg_e, a.pos_e, h, pos,
                    last ? nullptr : W + msg_floats, a.macc + (size_t)l * N * D,
                    last ? nullptr : a.h_ck + (size_t)l * N * D,
                    last ? nullptr : a.pos_ck + (size_t)l * N * 3, N, D, smem);
    grid_sync(a.bar);
  }

  // ---- backward, layer by layer ----
  for (int l = a.L - 1; l >= 0; --l) {
    const float* W = a.w + (size_t)l * rows;
    const float* h = l == 0 ? a.h0 : a.h_ck + (size_t)(l - 1) * N * D;
    const float* pos = l == 0 ? a.pos0 : a.pos_ck + (size_t)(l - 1) * N * 3;
    for (long long t = blockIdx.x; t < node_tiles; t += gridDim.x)
      node_bwd_tile(t, a.rowptr_r, h, a.macc + (size_t)l * N * D,
                    W + msg_floats, a.dh, a.dpos, a.nops, a.dhn, a.gmsg, a.gps,
                    N, D, smem);
    if (l + 1 < a.L) slice_sum(a, it, l + 1);
    grid_sync(a.bar);
    for (long long t = blockIdx.x; t < edge_tiles; t += gridDim.x)
      edge_bwd_tile<Idx>(t, a.send, a.recv, a.emask, h, pos, W, a.gmsg, a.gps,
                         a.eops, a.dhi, a.dhj, a.dpd, E, D, smem);
    grid_sync(a.bar);
    for (long long k = blockIdx.x; k < items; k += gridDim.x)
      reduce_item(a, it, k, smem);
    grid_sync(a.bar);
  }
  slice_sum(a, it, 0);
}

namespace {

template <typename Idx>
int launch(const BwdArgs<Idx>& a, cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const size_t smem = sizeof(float) * stack_smem_floats(a.D);
  err = cudaFuncSetAttribute(egnn_stack_bwd_kernel<Idx>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, egnn_stack_bwd_kernel<Idx>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // as many blocks as the card holds at once, but no more than the largest
  // phase has tiles or items
  const ReduceItems it = reduce_items(a.N, a.E, a.D, a.split);
  long long work = it.node + it.ew + it.ec + it.nw + it.nc;
  const long long tiles = ((a.E > a.N ? a.E : a.N) + kTileRows - 1) / kTileRows;
  if (tiles > work) work = tiles;
  const long long cap = (long long)per_sm * sms;
  const int grid = (int)(work < cap ? work : cap);
  void* args[] = {const_cast<BwdArgs<Idx>*>(&a)};
  err = cudaLaunchCooperativeKernel(egnn_stack_bwd_kernel<Idx>, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename Idx>
int run(const void* send, const void* recv, const void* emask, const void* h0,
        const void* pos0, const void* w, const void* gh, const void* gpos,
        const void* order_r, const void* rowptr_r, const void* order_s,
        const void* rowptr_s, void* const* bufs, int N, int E, int D, int L,
        int split, cudaStream_t stream) {
  float* f[18];
  for (int i = 0; i < 18; ++i) f[i] = static_cast<float*>(bufs[i]);
  const BwdArgs<Idx> a{
      static_cast<const Idx*>(send), static_cast<const Idx*>(recv),
      static_cast<const uint8_t*>(emask), static_cast<const float*>(h0),
      static_cast<const float*>(pos0), static_cast<const float*>(w),
      static_cast<const float*>(gh), static_cast<const float*>(gpos),
      static_cast<const int64_t*>(order_r), static_cast<const int64_t*>(rowptr_r),
      static_cast<const int64_t*>(order_s), static_cast<const int64_t*>(rowptr_s),
      f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10], f[11],
      f[12], f[13], f[14], f[15], f[16], f[17],
      static_cast<unsigned int*>(bufs[18]), N, E, D, L, split};
  return launch(a, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the first cudaError_t
// (0 = success).  Shapes and types are checked, the CSRs built and the
// buffers allocated by the Python wrapper (ops/egnn_stack.py::bwd_buffers,
// in this order): h_ck [L-1, N, D], pos_ck [L-1, N, 3], macc [L, N, D],
// msg_e [E, D], pos_e [E, 3], nops [N, 9D], dhn [N, D], gmsg [N, D],
// gps [N, 3], eops [E, 15D+1], dhi and dhj [E, D], dpd [E, 3],
// part_e [max(1, ceil(E/split)), 4D+12, D], part_n [max(1, ceil(N/split)),
// 3D+6, D], the outputs dh0 [N, D], dpos0 [N, 3], dw [L, 7D+18, D], and bar,
// two zeroed 32-bit counters; split is a positive multiple of 32.

extern "C" const char* gmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int gmp_egnn_stack_bwd(
    int device, const void* send, const void* recv, int idx64,
    const void* emask, const void* h0, const void* pos0, const void* w,
    const void* gh, const void* gpos, const void* order_r,
    const void* rowptr_r, const void* order_s, const void* rowptr_s,
    void* h_ck, void* pos_ck, void* macc, void* msg_e, void* pos_e, void* nops,
    void* dhn, void* gmsg, void* gps, void* eops, void* dhi, void* dhj,
    void* dpd, void* part_e, void* part_n, void* dh0, void* dpos0, void* dw,
    void* bar, int N, int E, int D, int L, int split, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0) return 0;
  void* const bufs[] = {h_ck, pos_ck, macc, msg_e, pos_e, nops, dhn, gmsg, gps,
                        eops, dhi, dhj, dpd, part_e, part_n, dh0, dpos0, dw,
                        bar};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return idx64 ? run<long long>(send, recv, emask, h0, pos0, w, gh, gpos,
                                order_r, rowptr_r, order_s, rowptr_s, bufs, N,
                                E, D, L, split, s)
               : run<int>(send, recv, emask, h0, pos0, w, gh, gpos, order_r,
                          rowptr_r, order_s, rowptr_s, bufs, N, E, D, L, split,
                          s);
}
