// Backward of the EGNN fused message pass for Hopper (sm_90a), exact f32 on
// CUDA cores.
//
// Replaces geometric_message_passing_tpu/ops/pallas_edge.py::_egnn_bwd_kernel
// (launched by _egnn_bwd_pallas_raw), the TPU kernel that recomputes an edge
// block's forward, backpropagates by hand through the scale head, the three
// Linear+LayerNorm+ReLU stages and the gathers, and accumulates dh [N, D],
// dpos [N, 3] and the packed weight gradient dW [4D+12, D] (the row layout of
// pack_egnn_weights, dpb2 in column 0 of the last row).  Same function, same
// masking (masked-off edges get a zero cotangent), the count's cotangent is
// ignored.  Not the TPU algorithm: the one-hot [block, N] matmuls become
// indexed loads and sorted (CSR) sums, and the TPU's sequential grid, which
// carried the sums from one block to the next, becomes four kernels whose
// sums run in a fixed order, with no atomics, so two runs are bitwise equal.
//
// What bounds it: arithmetic.  Per live edge the forward costs 2D(2D+1) +
// 4D^2 FLOPs of products and the backward twice that (the input cotangents
// dz W^T and the weight gradients x^T dz), about 400 kFLOP at D = 128, in
// exact f32 on the CUDA cores (no TF32).  The per-edge scratch that carries
// the forward's activations and the weight-gradient operands between the
// steps costs some 18D floats per edge of writes and reads, far below that.
// The edge tiles are 85% of the time on a 10k-atom box, so the design is
// theirs: egnn_common.cuh's register-blocked products with the weights
// streamed through a ring of K-tiles filled by bulk copies (the TMA), and a
// tile of TE = 8, 16 or
// 32 edges chosen per call (ops/edge.py::egnn_tile: the largest that
// still gives every SM a block, so the star train bucket takes 8 and a box
// 32).
//
// Kernels (launched in this order by gmp_egnn_bwd):
//  0. egnn_bwd_transpose_kernel: the transposed weight blocks (P1^T, W2^T,
//     W1[:D]^T, W1[D:2D]^T) the backward's products stream, 4 D^2 floats.
//  1. egnn_bwd_edge_kernel: a block takes one tile of TE edges, runs its
//     forward once (edge_fwd_tile), keeping each edge's LayerNorm xhat and
//     rstd and the scale head's value in `act` [E, 3D+4], then the backward
//     from them (edge_bwd_tile: the products dz W^T stream the transposed
//     blocks through the same ring).  It writes per edge: dh_i, dh_j
//     [E, D], dpd [E, 3], and one row of `ops` [E, 15D+4] holding the left
//     operands of the weight products (x, m, msg) and, in packed-row order,
//     the per-edge terms whose sums over edges are the vector rows of dW
//     (dz1, dy1*xhat1, dy1, dz2, ..., p*dscale, [dscale, 0, ...]).
//     Masked-off edges write zero rows there.
//  2. egnn_bwd_node_kernel: one warp per node sums its receiver-CSR row of
//     dh_i and +dpd, then its sender-CSR row of dh_j and -dpd, in ascending
//     edge order.
//  3. egnn_bwd_wgrad_kernel: over one slice of `split` edges per blockIdx.z,
//     the blocks of the first blockIdx.x values own 32 rows x 128 columns
//     of dW1 = x^T dz1, dW2 = m^T dz2 or dP1 = msg^T dz3 (4 x 4 sums a
//     thread) and walk their slice in order in chunks of 32 edges, two in
//     flight by cp.async; the other blocks take 32 columns of one of the 11
//     vector rows (b1 g1 B1 |
//     b2 g2 B2 | pb1 pg1 pB1 | P2 | pb2): column sums of `ops`, 8 thread
//     groups on every 8th edge, then one thread adds the 8 partial sums in
//     order.
//  4. egnn_bwd_wsum_kernel: dW = the sum of the slices' partial dW in slice
//     order.  Slicing keeps every sequential sum short (accuracy at large E)
//     and gives the weight gradient enough blocks to fill the card.
//
// The device code of kernels 1-3 lives in egnn_common.cuh, which the whole
// stack's backward (egnn_stack_bwd.cu, K6) runs too.

#include <cuda_runtime.h>
#include <stdint.h>

#include "egnn_common.cuh"

namespace {

using namespace egnn;

template <int TE, typename Idx>
__global__ void __launch_bounds__(kThreads, 2) egnn_bwd_edge_kernel(
    const Idx* __restrict__ send, const Idx* __restrict__ recv,
    const uint8_t* __restrict__ emask, const float* h, const float* pos,
    const float* __restrict__ W, const float* wt, const float* gmsg,
    const float* gpos, float* act, float* ops, float* dhi, float* dhj,
    float* dpd_e, int E, int D) {
  extern __shared__ __align__(16) float smem[];
  ring_init(smem);
  edge_fwd_tile<TE, Idx>(blockIdx.x, send, recv, emask, h, pos, W, nullptr,
                         nullptr, act, E, D, smem);
  edge_bwd_tile<TE, Idx>(blockIdx.x, send, recv, emask, h, pos, W, wt, act,
                         gmsg, gpos, ops, dhi, dhj, dpd_e, E, D, smem);
}

// The transposed weight blocks the edge kernel's backward multiplies by:
// wt [4, D, D] = P1^T, W2^T, W1[:D]^T, W1[D:2D]^T.
__global__ void __launch_bounds__(kThreads) egnn_bwd_transpose_kernel(
    const float* __restrict__ W, float* __restrict__ wt, int D) {
  transpose_weights(W, wt, D, false, (size_t)blockIdx.x * kThreads + threadIdx.x,
                    (size_t)gridDim.x * kThreads);
}

__global__ void __launch_bounds__(kThreads) egnn_bwd_node_kernel(
    const int64_t* __restrict__ order_r, const int64_t* __restrict__ rowptr_r,
    const int64_t* __restrict__ order_s, const int64_t* __restrict__ rowptr_s,
    const float* dhi, const float* dhj, const float* dpd_e, float* dh,
    float* dpos, int N, int D) {
  const long long node = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (node >= N) return;
  node_grad_sum(node, order_r, rowptr_r, order_s, rowptr_s, dhi, dhj, dpd_e,
                nullptr, nullptr, dh, dpos, D);
}

// Partial dW over edge slice z: blockIdx.x < the row tiles of W1 (K =
// 2D+1), W2 and P1 (K = D) times the 128-column tiles takes that item of
// the matrices; the next kVecRows x D/32 values take 32 columns of one
// vector row.
__global__ void __launch_bounds__(kThreads) egnn_bwd_wgrad_kernel(
    const float* ops, float* part, int E, int D, int split) {
  extern __shared__ __align__(16) float smem[];
  const size_t ld = ops_edge_ld(D);
  const int ct = (D + kWgradCols - 1) / kWgradCols, t_d = (D + kTile - 1) / kTile;
  const int tiles = (2 * D + 1 + kTile - 1) / kTile + 2 * t_d;
  const long long e_beg = (long long)blockIdx.z * split;
  const long long e_end = min((long long)E, e_beg + split);
  float* p = part + (size_t)blockIdx.z * (4 * D + 12) * D;
  int item = blockIdx.x;
  if (item < tiles * ct) {
    int tile = item % tiles;
    const Stage st = stage_of_tile(tile, 3, D, msg_stage);
    wgrad_tile(ops, ld, st, tile * kTile, (item / tiles) * kWgradCols, e_beg,
               e_end, p, D, smem);
  } else {
    item -= tiles * ct;
    const int v = item % kVecRows;
    colsum_cols(ops, ld, ops_vec(D) + v * D, msg_vec_row(v, D),
                (item / kVecRows) * 32, e_beg, e_end, p, D, smem);
  }
}

// dW = the sum over the slices' partial dW, in slice order.
__global__ void __launch_bounds__(kThreads) egnn_bwd_wsum_kernel(
    const float* __restrict__ part, float* __restrict__ dw, int slices,
    int size) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= size) return;
  float t = 0.f;
  for (int z = 0; z < slices; ++z) t += part[(size_t)z * size + i];
  dw[i] = t;
}

template <int TE, typename Idx>
int launch_edges(const void* send, const void* recv, const void* emask,
                 const void* h, const void* pos, const void* w,
                 const void* wt, const void* gmsg, const void* gpos, void* act,
                 void* ops, void* dhi, void* dhj, void* dpd, int E, int D,
                 cudaStream_t stream) {
  const size_t smem = sizeof(float) * tile_smem_floats(TE, D);
  cudaError_t err = cudaFuncSetAttribute(
      egnn_bwd_edge_kernel<TE, Idx>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (E + TE - 1) / TE;
  egnn_bwd_edge_kernel<TE, Idx><<<blocks, kThreads, smem, stream>>>(
      static_cast<const Idx*>(send), static_cast<const Idx*>(recv),
      static_cast<const uint8_t*>(emask), static_cast<const float*>(h),
      static_cast<const float*>(pos), static_cast<const float*>(w),
      static_cast<const float*>(wt), static_cast<const float*>(gmsg),
      static_cast<const float*>(gpos), static_cast<float*>(act),
      static_cast<float*>(ops),
      static_cast<float*>(dhi), static_cast<float*>(dhj),
      static_cast<float*>(dpd), E, D);
  return (int)cudaGetLastError();
}

template <typename Idx>
int launch_edges(int tile, const void* send, const void* recv,
                 const void* emask, const void* h, const void* pos,
                 const void* w, const void* wt, const void* gmsg,
                 const void* gpos, void* act, void* ops, void* dhi, void* dhj,
                 void* dpd, int E, int D, cudaStream_t stream) {
  if (tile == 8)
    return launch_edges<8, Idx>(send, recv, emask, h, pos, w, wt, gmsg, gpos,
                                act, ops, dhi, dhj, dpd, E, D, stream);
  if (tile == 16)
    return launch_edges<16, Idx>(send, recv, emask, h, pos, w, wt, gmsg, gpos,
                                 act, ops, dhi, dhj, dpd, E, D, stream);
  if (tile == 32)
    return launch_edges<32, Idx>(send, recv, emask, h, pos, w, wt, gmsg, gpos,
                                 act, ops, dhi, dhj, dpd, E, D, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the first cudaError_t of
// the launches (0 = success).  Shapes and types are checked, the CSRs built
// and the scratch allocated by the Python wrapper (ops/edge.py): wt
// [4, D, D] (transposed weight blocks), act [E, 3D+4], ops [E, 15D+4], dhi and dhj [E, D], dpd [E, 3], part
// [max(1, ceil(E/split)), 4D+12, D]; split is a positive multiple of 32, tile
// one of 8, 16 and 32.

extern "C" const char* gmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory (bytes) of the edge kernel at tile `tile`.
extern "C" int gmp_egnn_tile_smem(int tile, int D) {
  return (int)sizeof(float) * tile_smem_floats(tile, D);
}

extern "C" int gmp_egnn_bwd(
    int device, const void* send, const void* recv, int idx64,
    const void* emask, const void* h, const void* pos, const void* w,
    const void* gmsg, const void* gpos, const void* order_r,
    const void* rowptr_r, const void* order_s, const void* rowptr_s,
    void* wt, void* act, void* ops, void* dhi, void* dhj, void* dpd,
    void* part, void* dh, void* dpos, void* dw, int N, int E, int D, int split,
    int tile, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  if (E > 0) {
    egnn_bwd_transpose_kernel<<<(4 * D * D + kThreads - 1) / kThreads, kThreads,
                                0, s>>>(static_cast<const float*>(w),
                                        static_cast<float*>(wt), D);
    if ((rc = (int)cudaGetLastError())) return rc;
    rc = idx64 ? launch_edges<long long>(tile, send, recv, emask, h, pos, w,
                                         wt, gmsg, gpos, act, ops, dhi, dhj,
                                         dpd, E, D, s)
               : launch_edges<int>(tile, send, recv, emask, h, pos, w, wt,
                                   gmsg, gpos, act, ops, dhi, dhj, dpd, E, D,
                                   s);
    if (rc) return rc;
  }
  if (N > 0) {
    egnn_bwd_node_kernel<<<(N + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        static_cast<const int64_t*>(order_r), static_cast<const int64_t*>(rowptr_r),
        static_cast<const int64_t*>(order_s), static_cast<const int64_t*>(rowptr_s),
        static_cast<const float*>(dhi), static_cast<const float*>(dhj),
        static_cast<const float*>(dpd), static_cast<float*>(dh),
        static_cast<float*>(dpos), N, D);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  const int slices = E > 0 ? (E + split - 1) / split : 1;
  const int t_w1 = (2 * D + 1 + kTile - 1) / kTile, t_d = (D + kTile - 1) / kTile;
  const int ct = (D + kWgradCols - 1) / kWgradCols;
  const int items = (t_w1 + 2 * t_d) * ct + kVecRows * t_d;
  const int wsmem = kWgradFloats * (int)sizeof(float);
  if ((rc = (int)cudaFuncSetAttribute(egnn_bwd_wgrad_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      wsmem)))
    return rc;
  egnn_bwd_wgrad_kernel<<<dim3(items, 1, slices), kThreads, wsmem, s>>>(
      static_cast<const float*>(ops), static_cast<float*>(part), E, D, split);
  if ((rc = (int)cudaGetLastError())) return rc;
  const int size = (4 * D + 12) * D;
  egnn_bwd_wsum_kernel<<<(size + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), slices, size);
  return (int)cudaGetLastError();
}
