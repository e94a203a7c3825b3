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
// edges; each warp owns 2 edge rows and each lane 1/32 of the columns, so an
// activation row stays in registers through its LayerNorm (warp-shuffle
// sums) and every FMA reads one broadcast activation and one conflict-free
// weight from shared memory.  The weights do not fit in shared memory
// together (W1 alone is 131 KB at D = 128), so they stream through it in
// K-tiles of 32 rows, each used by all 16 edges of the tile.
//
// Kernel 1 (egnn_edge_kernel) writes per-edge msg [E, D] and pos_msg [E, 3]
// for live (masked-in) edges.  Kernel 2 (egnn_reduce_kernel) sums them by
// receiver over a CSR (edge order sorted stably by receiver, row pointers),
// one warp per node, in ascending edge order: no atomics, so two runs give
// bitwise-equal outputs.  The count is the row's length.  The warp sum and
// the K-tiled product are egnn_common.cuh's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "egnn_common.cuh"

namespace {

using namespace egnn;

// acc <- relu(LayerNorm(acc + bias) * gamma + beta), biased variance.
__device__ __forceinline__ void bias_ln_relu(
    float (&acc)[kRowsPerWarp][kMaxCols], const float* __restrict__ bias,
    const float* __restrict__ gamma, const float* __restrict__ beta, int D) {
  const int lane = threadIdx.x & 31;
  const float inv_d = 1.f / (float)D;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) {
        acc[r][c] += bias[col];
        s += acc[r][c];
      }
    }
    const float mu = warp_sum(s) * inv_d;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) {
        const float t = acc[r][c] - mu;
        q += t * t;
      }
    }
    const float rstd = 1.f / sqrtf(warp_sum(q) * inv_d + kEps);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D)
        acc[r][c] = fmaxf((acc[r][c] - mu) * rstd * gamma[col] + beta[col], 0.f);
    }
  }
}

__device__ __forceinline__ void store_rows(
    const float (&acc)[kRowsPerWarp][kMaxCols], float* __restrict__ out,
    int ldo, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) out[(warp * kRowsPerWarp + r) * ldo + col] = acc[r][c];
    }
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads) egnn_edge_kernel(
    const Idx* __restrict__ send, const Idx* __restrict__ recv,
    const uint8_t* __restrict__ emask, const float* __restrict__ h,
    const float* __restrict__ pos, const float* __restrict__ W,
    float* __restrict__ msg_e, float* __restrict__ pos_e, int E, int D) {
  extern __shared__ float smem[];
  __shared__ float pd_s[kTileRows][3];
  const int K1 = 2 * D + 1;
  float* xs = smem;                       // [kTileRows, K1]: [h_i, h_j, d], later msg
  float* ys = xs + kTileRows * K1;       // [kTileRows, D]: first hidden layer
  float* ws = ys + kTileRows * D;        // [kTileK, D]: weight K-tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long e0 = (long long)blockIdx.x * kTileRows;

  // ---- gather (each warp fills its own rows) ----
  bool live[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp * kRowsPerWarp + r;
    const long long e = e0 + row;
    live[r] = e < E && emask[e] != 0;
    float* x = xs + row * K1;
    if (live[r]) {
      const long long i = (long long)recv[e], j = (long long)send[e];
      const float* hi = h + i * D;
      const float* hj = h + j * D;
      for (int c = lane; c < D; c += 32) {
        x[c] = hi[c];
        x[D + c] = hj[c];
      }
      if (lane == 0) {
        const float dx = pos[3 * i] - pos[3 * j];
        const float dy = pos[3 * i + 1] - pos[3 * j + 1];
        const float dz = pos[3 * i + 2] - pos[3 * j + 2];
        const float sq = dx * dx + dy * dy + dz * dz;
        x[2 * D] = sq > 1e-24f ? sqrtf(sq) : 0.f;
        pd_s[row][0] = dx;
        pd_s[row][1] = dy;
        pd_s[row][2] = dz;
      }
    } else {
      for (int c = lane; c < K1; c += 32) x[c] = 0.f;
      if (lane < 3) pd_s[row][lane] = 0.f;
    }
  }

  // ---- packed weight rows (see pack_egnn_weights) ----
  const float* W1 = W;
  const float* b1 = W1 + (size_t)K1 * D;
  const float* g1 = b1 + D;
  const float* B1 = g1 + D;
  const float* W2 = B1 + D;
  const float* b2 = W2 + (size_t)D * D;
  const float* g2 = b2 + D;
  const float* B2 = g2 + D;
  const float* P1 = B2 + D;
  const float* pb1 = P1 + (size_t)D * D;
  const float* pg1 = pb1 + D;
  const float* pB1 = pg1 + D;
  const float* P2 = pB1 + D;
  const float pb2 = P2[D];  // column 0 of the last row

  float acc[kRowsPerWarp][kMaxCols];

  // m = relu(LN(x W1 + b1))
  matmul_rows(xs, K1, K1, W1, D, ws, acc);
  bias_ln_relu(acc, b1, g1, B1, D);
  store_rows(acc, ys, D, D);

  // msg = relu(LN(m W2 + b2)); xs is free once every warp is past stage 1
  matmul_rows(ys, D, D, W2, D, ws, acc);
  bias_ln_relu(acc, b2, g2, B2, D);
  store_rows(acc, xs, D, D);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (!live[r]) continue;
    float* out = msg_e + (size_t)(e0 + warp * kRowsPerWarp + r) * D;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) out[col] = acc[r][c];
    }
  }

  // p = relu(LN(msg P1 + pb1)); scale = p . P2 + pb2; pos_msg = pos_diff * scale
  matmul_rows(xs, D, D, P1, D, ws, acc);
  bias_ln_relu(acc, pb1, pg1, pB1, D);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) s = fmaf(acc[r][c], P2[col], s);
    }
    const float scale = warp_sum(s) + pb2;
    const int row = warp * kRowsPerWarp + r;
    if (live[r] && lane < 3)
      pos_e[(size_t)(e0 + row) * 3 + lane] = pd_s[row][lane] * scale;
  }
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

size_t edge_smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)kTileRows * (2 * D + 1) + (size_t)kTileRows * D +
          (size_t)kTileK * D);
}

template <typename Idx>
int launch_edges(const void* send, const void* recv, const void* emask,
                 const void* h, const void* pos, const void* w, void* msg_e,
                 void* pos_e, int E, int D, cudaStream_t stream) {
  const size_t smem = edge_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      egnn_edge_kernel<Idx>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (E + kTileRows - 1) / kTileRows;
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
