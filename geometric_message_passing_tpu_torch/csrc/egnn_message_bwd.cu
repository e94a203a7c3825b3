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
// What bounds it: arithmetic.  Per live edge the recomputed forward costs
// 2D(2D+1) + 4D^2 FLOPs of products and the backward twice that (the input
// cotangents dz W^T and the weight gradients x^T dz), about 400 kFLOP at
// D = 128, in exact f32 on the CUDA cores (no TF32).  The per-edge scratch
// that carries the weight-gradient operands from kernel 1 to kernel 3 costs
// some (15D + 1) floats per edge of writes and reads, far below that.
//
// Kernels (launched in this order by gmp_egnn_bwd):
//  1. egnn_bwd_edge_kernel: a block takes 16 edges (8 warps x 2 rows, each
//     lane 1/32 of the columns, as in egnn_message.cu), recomputes the
//     forward with the weights streamed through shared memory in 32-row
//     K-tiles, and runs the backward.  The transposed products dz W^T stream
//     32-column slices of W into a [D, 33] tile (the odd stride keeps the
//     lanes' reads on distinct banks).  It writes per edge: dh_i, dh_j
//     [E, D], dpd [E, 3], and one row of `ops` [E, 15D+1] holding the
//     left operands of the weight products (x, m, msg) and, in packed-row
//     order, the per-edge terms whose sums over edges are the vector rows of
//     dW (dz1, dy1*xhat1, dy1, dz2, ..., p*dscale, [dscale, 0, ...]).
//     Masked-off edges write zero rows there.
//  2. egnn_bwd_node_kernel: one warp per node sums its receiver-CSR row of
//     dh_i and +dpd, then its sender-CSR row of dh_j and -dpd, in ascending
//     edge order.
//  3. egnn_bwd_wgrad_kernel: dW1 = x^T dz1, dW2 = m^T dz2, dP1 = msg^T dz3,
//     over one slice of `split` edges per blockIdx.z.  Each block owns a
//     32 x 32 output tile and walks its slice in order in chunks of 32
//     edges staged through shared memory.
//  4. egnn_bwd_colsum_kernel: the 11 vector rows (b1 g1 B1 | b2 g2 B2 |
//     pb1 pg1 pB1 | P2 | pb2): column sums of `ops` over the same slices;
//     8 thread groups take every 8th edge, then one thread adds the 8
//     partial sums in order.
//  5. egnn_bwd_wsum_kernel: dW = the sum of the slices' partial dW in slice
//     order.  Slicing keeps every sequential sum short (accuracy at large E)
//     and gives the weight gradient enough blocks to fill the card.
//
// The device code of kernels 1-4 lives in egnn_common.cuh, which the whole
// stack's backward (egnn_stack_bwd.cu, K6) runs too.

#include <cuda_runtime.h>
#include <stdint.h>

#include "egnn_common.cuh"

namespace {

using namespace egnn;

template <typename Idx>
__global__ void __launch_bounds__(kThreads) egnn_bwd_edge_kernel(
    const Idx* __restrict__ send, const Idx* __restrict__ recv,
    const uint8_t* __restrict__ emask, const float* h, const float* pos,
    const float* __restrict__ W, const float* gmsg, const float* gpos,
    float* ops, float* dhi, float* dhj, float* dpd_e, int E, int D) {
  extern __shared__ float smem[];
  edge_bwd_tile<Idx>(blockIdx.x, send, recv, emask, h, pos, W, gmsg, gpos,
                     ops, dhi, dhj, dpd_e, E, D, smem);
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

// Partial dW rows of the three weight matrices over edge slice z:
// blockIdx.x enumerates the row tiles of W1 (K = 2D+1), W2 and P1 (K = D);
// blockIdx.y the column tiles.
__global__ void __launch_bounds__(kThreads) egnn_bwd_wgrad_kernel(
    const float* ops, float* part, int E, int D, int split) {
  extern __shared__ float smem[];
  int tile = blockIdx.x;
  const Stage st = stage_of_tile(tile, 3, D, msg_stage);
  const long long e_beg = (long long)blockIdx.z * split;
  const long long e_end = min((long long)E, e_beg + split);
  wgrad_tile(ops, (size_t)15 * D + 1, st, tile * kTile, blockIdx.y * kTile,
             e_beg, e_end, part + (size_t)blockIdx.z * (4 * D + 12) * D, D,
             smem);
}

// Partial vector rows of dW over edge slice z: column sums of
// ops[:, 4D+1 + v*D + c] for v = blockIdx.x.
__global__ void __launch_bounds__(kThreads) egnn_bwd_colsum_kernel(
    const float* ops, float* part, int E, int D, int split) {
  extern __shared__ float smem[];
  const int v = blockIdx.x;
  const long long e_beg = (long long)blockIdx.z * split;
  const long long e_end = min((long long)E, e_beg + split);
  colsum_cols(ops, (size_t)15 * D + 1, 4 * D + 1 + v * D, msg_vec_row(v, D),
              blockIdx.y * 32, e_beg, e_end,
              part + (size_t)blockIdx.z * (4 * D + 12) * D, D, smem);
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

size_t edge_smem_bytes(int D) { return sizeof(float) * edge_bwd_smem_floats(D); }

template <typename Idx>
int launch_edges(const void* send, const void* recv, const void* emask,
                 const void* h, const void* pos, const void* w,
                 const void* gmsg, const void* gpos, void* ops, void* dhi,
                 void* dhj, void* dpd, int E, int D, cudaStream_t stream) {
  const size_t smem = edge_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      egnn_bwd_edge_kernel<Idx>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (E + kTileRows - 1) / kTileRows;
  egnn_bwd_edge_kernel<Idx><<<blocks, kThreads, smem, stream>>>(
      static_cast<const Idx*>(send), static_cast<const Idx*>(recv),
      static_cast<const uint8_t*>(emask), static_cast<const float*>(h),
      static_cast<const float*>(pos), static_cast<const float*>(w),
      static_cast<const float*>(gmsg), static_cast<const float*>(gpos),
      static_cast<float*>(ops), static_cast<float*>(dhi),
      static_cast<float*>(dhj), static_cast<float*>(dpd), E, D);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the first cudaError_t of
// the launches (0 = success).  Shapes and types are checked, the CSRs built
// and the scratch allocated by the Python wrapper (ops/edge.py): ops
// [E, 15D+1], dhi and dhj [E, D], dpd [E, 3], part [max(1, ceil(E/split)),
// 4D+12, D]; split is a positive multiple of 32.

extern "C" const char* gmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int gmp_egnn_bwd(
    int device, const void* send, const void* recv, int idx64,
    const void* emask, const void* h, const void* pos, const void* w,
    const void* gmsg, const void* gpos, const void* order_r,
    const void* rowptr_r, const void* order_s, const void* rowptr_s,
    void* ops, void* dhi, void* dhj, void* dpd, void* part, void* dh,
    void* dpos, void* dw, int N, int E, int D, int split, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  if (E > 0) {
    rc = idx64 ? launch_edges<long long>(send, recv, emask, h, pos, w, gmsg,
                                         gpos, ops, dhi, dhj, dpd, E, D, s)
               : launch_edges<int>(send, recv, emask, h, pos, w, gmsg, gpos,
                                   ops, dhi, dhj, dpd, E, D, s);
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
  egnn_bwd_wgrad_kernel<<<dim3(t_w1 + 2 * t_d, t_d, slices), kThreads,
                          2 * kTile * kTile * sizeof(float), s>>>(
      static_cast<const float*>(ops), static_cast<float*>(part), E, D, split);
  if ((rc = (int)cudaGetLastError())) return rc;
  egnn_bwd_colsum_kernel<<<dim3(kVecRows, t_d, slices), kThreads,
                           kThreads * sizeof(float), s>>>(
      static_cast<const float*>(ops), static_cast<float*>(part), E, D, split);
  if ((rc = (int)cudaGetLastError())) return rc;
  const int size = (4 * D + 12) * D;
  egnn_bwd_wsum_kernel<<<(size + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), slices, size);
  return (int)cudaGetLastError();
}
