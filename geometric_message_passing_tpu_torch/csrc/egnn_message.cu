// EGNN fused message pass for Hopper (sm_90a), exact f32 on CUDA cores.
//
// Replaces geometric_message_passing_tpu/ops/pallas_edge.py::_egnn_kernel,
// the TPU kernel that gathers both endpoints of every edge, runs the message
// MLP (three Linear+LayerNorm+ReLU stages and the position scale head) and
// sums the results over receivers.  Same function, same packed weight layout
// ([4D+12, D] rows: W1 b1 g1 B1 | W2 b2 g2 B2 | P1 pb1 pg1 pB1 | P2 | pb2 in
// column 0), same masking; not the TPU algorithm: the one-hot [block, N]
// matmuls that gather and scatter on the TPU's matrix unit become indexed
// loads and a sorted (CSR) segment sum, so N is not limited.
//
// What bounds it: arithmetic.  Each edge costs 2*D*(2D+1) + 4*D^2 FLOPs of
// matrix products (about 131 kFLOP at D = 128) against some 1.5 KB of
// gathered and written rows, far above the card's f32 balance point, and
// the products run in exact f32 on the CUDA cores (no TF32, no tensor
// cores), so the ceiling is the f32 FMA rate.  At the shapes of one serving
// batch (1408 edges) that is a few microseconds, and launch latency and the
// host dominate.
//
// What the design does about it: one block of 8 warps takes a tile of 16
// edges and runs egnn_common.cuh's edge_fwd_tile: the tile's rows stay in
// shared memory, the weights (W1 alone is 131 KB at D = 128) stream through
// a ring of 32-row K-tiles filled by bulk copies (the TMA), each product is
// register blocked (2 rows x 4 columns a thread), and the LayerNorms run a
// warp per row with shuffle sums.  The grid keeps one 16-edge tile per block.
//
// Kernel 1 (egnn_edge_kernel) writes per-edge msg [E, D] and pos_msg [E, 3]
// for live (masked-in) edges.  Kernel 2 (egnn_reduce_kernel) sums them by
// receiver over a CSR (edge order sorted stably by receiver, row pointers),
// one warp per node, in ascending edge order: no atomics, so two runs give
// bitwise-equal outputs.  The count is the row's length.

#include <cuda_runtime.h>
#include <stdint.h>

#include "egnn_common.cuh"

namespace {

using namespace egnn;

constexpr int kTE = 16;   // edges per block

template <typename Idx>
__global__ void __launch_bounds__(kThreads) egnn_edge_kernel(
    const Idx* __restrict__ send, const Idx* __restrict__ recv,
    const uint8_t* __restrict__ emask, const float* __restrict__ h,
    const float* __restrict__ pos, const float* __restrict__ W,
    float* __restrict__ msg_e, float* __restrict__ pos_e, int E, int D) {
  extern __shared__ __align__(16) float smem[];
  ring_init(smem);
  edge_fwd_tile<kTE, Idx>(blockIdx.x, send, recv, emask, h, pos, W, msg_e,
                          pos_e, nullptr, E, D, smem);
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

size_t edge_smem_bytes(int D) { return sizeof(float) * tile_smem_floats(kTE, D); }

template <typename Idx>
int launch_edges(const void* send, const void* recv, const void* emask,
                 const void* h, const void* pos, const void* w, void* msg_e,
                 void* pos_e, int E, int D, cudaStream_t stream) {
  const size_t smem = edge_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      egnn_edge_kernel<Idx>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (E + kTE - 1) / kTE;
  egnn_edge_kernel<Idx><<<blocks, kThreads, smem, stream>>>(
      static_cast<const Idx*>(send), static_cast<const Idx*>(recv),
      static_cast<const uint8_t*>(emask), static_cast<const float*>(h),
      static_cast<const float*>(pos), static_cast<const float*>(w),
      static_cast<float*>(msg_e), static_cast<float*>(pos_e), E, D);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every launching function returns
// the cudaError_t of its launch (0 = success).  Shapes and types are checked
// by the Python wrapper (ops/edge.py), which also builds the CSR.

extern "C" const char* gmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int gmp_egnn_edges(int device, const void* send, const void* recv,
                              int idx64, const void* emask, const void* h,
                              const void* pos, const void* w, void* msg_e,
                              void* pos_e, int E, int D, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return idx64 ? launch_edges<long long>(send, recv, emask, h, pos, w, msg_e,
                                         pos_e, E, D, s)
               : launch_edges<int>(send, recv, emask, h, pos, w, msg_e, pos_e,
                                   E, D, s);
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
