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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kTileEdges = kWarps * kRowsPerWarp;   // edges per block
constexpr int kTileK = 32;                          // weight rows per K-tile
constexpr int kTStride = kTileK + 1;                // transposed tile stride
constexpr int kMaxCols = 8;                         // columns per lane, D <= 256
constexpr int kVecRows = 11;                        // vector rows of dW
constexpr int kTile = 32;                           // dW tile (rows, cols, edges)
constexpr float kEps = 1e-5f;

typedef float Rows[kRowsPerWarp][kMaxCols];

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_row(int r) {
  return (threadIdx.x >> 5) * kRowsPerWarp + r;
}

// acc[r][c] = sum_k A[row r][k] * W[k][col c], W [K, D] row-major in global
// memory, staged through ws in K-tiles (as in egnn_message.cu).
__device__ __forceinline__ void matmul_rows(
    const float* __restrict__ A, int lda, int K,
    const float* __restrict__ W, int D, float* __restrict__ ws, Rows& acc) {
  const int lane = lane_id();
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kTileK) {
    const int kt = min(kTileK, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kt * D; i += kThreads)
      ws[i] = W[(size_t)k0 * D + i];
    __syncthreads();
    for (int kk = 0; kk < kt; ++kk) {
      float a[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) a[r] = A[warp_row(r) * lda + k0 + kk];
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int col = lane + 32 * c;
        if (col < D) {
          const float w = ws[kk * D + col];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] = fmaf(a[r], w, acc[r][c]);
        }
      }
    }
  }
}

// acc[r][c] = sum_k A[row r][k] * W[col c][k] for k < D: the product with
// W^T, W [D, D] row-major in global memory.  32-column slices of W are staged
// transposed-free into wt[row * kTStride + k].
__device__ __forceinline__ void matmul_rows_t(
    const float* __restrict__ A, int lda, const float* __restrict__ W, int D,
    float* __restrict__ wt, Rows& acc) {
  const int lane = lane_id();
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < D; k0 += kTileK) {
    const int kt = min(kTileK, D - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kt * D; i += kThreads) {
      const int row = i / kt, kk = i - row * kt;
      wt[row * kTStride + kk] = W[(size_t)row * D + k0 + kk];
    }
    __syncthreads();
    for (int kk = 0; kk < kt; ++kk) {
      float a[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) a[r] = A[warp_row(r) * lda + k0 + kk];
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int col = lane + 32 * c;
        if (col < D) {
          const float w = wt[col * kTStride + kk];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] = fmaf(a[r], w, acc[r][c]);
        }
      }
    }
  }
}

// acc <- xhat = (acc + bias - mean) * rstd over each row; rstd kept per row.
__device__ __forceinline__ void bias_normalise(
    Rows& acc, const float* __restrict__ bias, int D, float (&rstd)[kRowsPerWarp]) {
  const int lane = lane_id();
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
        acc[r][c] -= mu;
        q += acc[r][c] * acc[r][c];
      }
    }
    rstd[r] = 1.f / sqrtf(warp_sum(q) * inv_d + kEps);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[r][c] *= rstd[r];
  }
}

// out = relu(xhat * gamma + beta); the same expression in forward and backward
__device__ __forceinline__ void affine_relu(
    const Rows& xh, const float* __restrict__ gamma,
    const float* __restrict__ beta, int D, Rows& out) {
  const int lane = lane_id();
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      out[r][c] = col < D ? fmaxf(fmaf(xh[r][c], gamma[col], beta[col]), 0.f) : 0.f;
    }
}

// dy <- dz = rstd * (dy*g - mean(dy*g) - xhat * mean(dy*g*xhat)): LayerNorm
// backward to its input.
__device__ __forceinline__ void ln_backward(
    Rows& dy, const Rows& xh, const float (&rstd)[kRowsPerWarp],
    const float* __restrict__ gamma, int D) {
  const int lane = lane_id();
  const float inv_d = 1.f / (float)D;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) {
        dy[r][c] *= gamma[col];       // dxhat
        s1 += dy[r][c];
        s2 += dy[r][c] * xh[r][c];
      }
    }
    const float m1 = warp_sum(s1) * inv_d, m2 = warp_sum(s2) * inv_d;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      dy[r][c] = lane + 32 * c < D ? rstd[r] * (dy[r][c] - m1 - xh[r][c] * m2) : 0.f;
  }
}

// Rows of the warp into shared memory (row stride ld).
__device__ __forceinline__ void store_smem(const Rows& v, float* __restrict__ s,
                                           int ld, int D) {
  const int lane = lane_id();
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) s[warp_row(r) * ld + col] = v[r][c];
    }
  __syncwarp();
}

// Rows of the warp into a per-edge buffer: out[e * ld + col] = v (times w
// when w is given), 0 on masked-off edges; rows past E are not written.
template <bool kMul>
__device__ __forceinline__ void store_edges_impl(
    const Rows& v, const Rows& w, float* __restrict__ out, size_t ld,
    long long e0, int E, const bool (&live)[kRowsPerWarp], int D) {
  const int lane = lane_id();
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const long long e = e0 + warp_row(r);
    if (e >= E) continue;
    float* o = out + (size_t)e * ld;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) o[col] = live[r] ? (kMul ? v[r][c] * w[r][c] : v[r][c]) : 0.f;
    }
  }
}

__device__ __forceinline__ void store_edges(
    const Rows& v, float* __restrict__ out, size_t ld, long long e0, int E,
    const bool (&live)[kRowsPerWarp], int D) {
  store_edges_impl<false>(v, v, out, ld, e0, E, live, D);
}

__device__ __forceinline__ void store_edges(
    const Rows& v, const Rows& w, float* __restrict__ out, size_t ld,
    long long e0, int E, const bool (&live)[kRowsPerWarp], int D) {
  store_edges_impl<true>(v, w, out, ld, e0, E, live, D);
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads) egnn_bwd_edge_kernel(
    const Idx* __restrict__ send, const Idx* __restrict__ recv,
    const uint8_t* __restrict__ emask, const float* __restrict__ h,
    const float* __restrict__ pos, const float* __restrict__ W,
    const float* __restrict__ gmsg, const float* __restrict__ gpos,
    float* __restrict__ ops, float* __restrict__ dhi, float* __restrict__ dhj,
    float* __restrict__ dpd_e, int E, int D) {
  extern __shared__ float smem[];
  __shared__ float pd_s[kTileEdges][3];
  __shared__ float inv_s[kTileEdges];
  const int K1 = 2 * D + 1;
  const size_t ld = (size_t)15 * D + 1;    // ops row: x m msg | 11 vector rows
  float* const vec = ops + 4 * D + 1;      // column of the first vector row
  float* xs = smem;                        // [kTileEdges, K1]: x, later msg
  float* ys = xs + kTileEdges * K1;        // [kTileEdges, D]: m, later dz
  float* ws = ys + kTileEdges * D;         // weight tile, [kTileK, D] or [D, kTStride]

  const int lane = lane_id();
  const long long e0 = (long long)blockIdx.x * kTileEdges;

  // ---- gather x = [h_i, h_j, d] (each warp fills its own rows) ----
  bool live[kRowsPerWarp];
  long long ri[kRowsPerWarp];            // receiver of each row (live rows)
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp_row(r);
    const long long e = e0 + row;
    live[r] = e < E && emask[e] != 0;
    float* x = xs + row * K1;
    ri[r] = 0;
    if (live[r]) {
      const long long i = (long long)recv[e], j = (long long)send[e];
      ri[r] = i;
      for (int c = lane; c < D; c += 32) {
        x[c] = h[i * D + c];
        x[D + c] = h[j * D + c];
      }
      if (lane == 0) {
        const float dx = pos[3 * i] - pos[3 * j];
        const float dy = pos[3 * i + 1] - pos[3 * j + 1];
        const float dz = pos[3 * i + 2] - pos[3 * j + 2];
        const float sq = dx * dx + dy * dy + dz * dz;
        const bool positive = sq > 1e-24f;
        const float dist = positive ? sqrtf(sq) : 0.f;
        x[2 * D] = dist;
        inv_s[row] = positive ? 1.f / dist : 0.f;
        pd_s[row][0] = dx;
        pd_s[row][1] = dy;
        pd_s[row][2] = dz;
      }
    } else {
      for (int c = lane; c < K1; c += 32) x[c] = 0.f;
      if (lane < 3) pd_s[row][lane] = 0.f;
      if (lane == 0) inv_s[row] = 0.f;
    }
    __syncwarp();
    if (e < E)
      for (int c = lane; c < K1; c += 32) ops[(size_t)e * ld + c] = x[c];
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
  const float pb2 = P2[D];

  Rows acc, xh1, xh2, xh3;
  float rstd1[kRowsPerWarp], rstd2[kRowsPerWarp], rstd3[kRowsPerWarp];

  // ---- forward recompute ----
  matmul_rows(xs, K1, K1, W1, D, ws, acc);          // m = relu(LN1(x W1 + b1))
  bias_normalise(acc, b1, D, rstd1);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) xh1[r][c] = acc[r][c];
  affine_relu(xh1, g1, B1, D, acc);
  store_smem(acc, ys, D, D);
  store_edges(acc, ops + K1, ld, e0, E, live, D);

  matmul_rows(ys, D, D, W2, D, ws, acc);            // msg = relu(LN2(m W2 + b2))
  bias_normalise(acc, b2, D, rstd2);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) xh2[r][c] = acc[r][c];
  affine_relu(xh2, g2, B2, D, acc);
  store_smem(acc, xs, D, D);
  store_edges(acc, ops + K1 + D, ld, e0, E, live, D);

  matmul_rows(xs, D, D, P1, D, ws, acc);            // p = relu(LN3(msg P1 + pb1))
  bias_normalise(acc, pb1, D, rstd3);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) xh3[r][c] = acc[r][c];
  Rows p;
  affine_relu(xh3, pg1, pB1, D, p);

  // ---- backward: scale head ----
  // cotangents at this edge's outputs: gmsg[recv], gpos[recv] (0 if masked)
  float scale[kRowsPerWarp], dscale[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) s = fmaf(p[r][c], P2[col], s);
    }
    scale[r] = warp_sum(s) + pb2;
    const int row = warp_row(r);
    const float* g = gpos + 3 * ri[r];
    dscale[r] = live[r] ? g[0] * pd_s[row][0] + g[1] * pd_s[row][1] +
                              g[2] * pd_s[row][2]
                        : 0.f;
  }
  // per-edge P2 term p * dscale, then dy3 = dscale * P2 where p > 0
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      acc[r][c] = p[r][c] * dscale[r];
    }
  store_edges(acc, vec + 9 * D, ld, e0, E, live, D);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      acc[r][c] = (col < D && p[r][c] > 0.f) ? dscale[r] * P2[col] : 0.f;
    }
  // pb2 row: [dscale, 0, ..., 0]
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const long long e = e0 + warp_row(r);
    if (e >= E) continue;
    float* o = vec + 10 * D + (size_t)e * ld;
    for (int col = lane; col < D; col += 32)
      o[col] = (col == 0 && live[r]) ? dscale[r] : 0.f;
  }

  // ---- LN3 -> dz3; dmsg = gmsg[recv] + dz3 P1^T ----
  store_edges(acc, xh3, vec + 7 * D, ld, e0, E, live, D);   // dy3 * xhat3
  store_edges(acc, vec + 8 * D, ld, e0, E, live, D);  // dy3
  ln_backward(acc, xh3, rstd3, pg1, D);
  store_edges(acc, vec + 6 * D, ld, e0, E, live, D);  // dz3
  store_smem(acc, ys, D, D);
  matmul_rows_t(ys, D, P1, D, ws, acc);
  Rows msk;
  affine_relu(xh2, g2, B2, D, msk);                            // msg
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float* g = gmsg + (size_t)ri[r] * D;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      const float dmsg = (live[r] && col < D) ? g[col] + acc[r][c] : 0.f;
      acc[r][c] = msk[r][c] > 0.f ? dmsg : 0.f;                // dy2
    }
  }

  // ---- LN2 -> dz2; dm = dz2 W2^T ----
  store_edges(acc, xh2, vec + 4 * D, ld, e0, E, live, D);
  store_edges(acc, vec + 5 * D, ld, e0, E, live, D);
  ln_backward(acc, xh2, rstd2, g2, D);
  store_edges(acc, vec + 3 * D, ld, e0, E, live, D);  // dz2
  store_smem(acc, ys, D, D);
  matmul_rows_t(ys, D, W2, D, ws, acc);
  affine_relu(xh1, g1, B1, D, msk);                            // m
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      acc[r][c] = msk[r][c] > 0.f ? acc[r][c] : 0.f;           // dy1

  // ---- LN1 -> dz1; dx = dz1 W1^T = [dh_i, dh_j, ddist] ----
  store_edges(acc, xh1, vec + 1 * D, ld, e0, E, live, D);
  store_edges(acc, vec + 2 * D, ld, e0, E, live, D);
  ln_backward(acc, xh1, rstd1, g1, D);
  store_edges(acc, vec, ld, e0, E, live, D);          // dz1
  store_smem(acc, ys, D, D);
  float ddist[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) s = fmaf(acc[r][c], W1[(size_t)2 * D * D + col], s);
    }
    ddist[r] = warp_sum(s);
  }
  matmul_rows_t(ys, D, W1, D, ws, acc);                        // dh_i
  store_edges(acc, dhi, D, e0, E, live, D);
  matmul_rows_t(ys, D, W1 + (size_t)D * D, D, ws, acc);        // dh_j
  store_edges(acc, dhj, D, e0, E, live, D);

  // dpd = gpos[recv] * scale + ddist * pd * inv
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp_row(r);
    const long long e = e0 + row;
    if (e < E && lane < 3) {
      const float pd = pd_s[row][lane];
      dpd_e[(size_t)e * 3 + lane] =
          live[r] ? gpos[3 * ri[r] + lane] * scale[r] + ddist[r] * pd * inv_s[row]
                  : 0.f;
    }
  }
}

// One warp per node: dh = sum of dh_i over its receiver row + sum of dh_j
// over its sender row; dpos = sum of dpd (receiver row) - sum of dpd
// (sender row); ascending edge order within each row.
__global__ void __launch_bounds__(kThreads) egnn_bwd_node_kernel(
    const int64_t* __restrict__ order_r, const int64_t* __restrict__ rowptr_r,
    const int64_t* __restrict__ order_s, const int64_t* __restrict__ rowptr_s,
    const float* __restrict__ dhi, const float* __restrict__ dhj,
    const float* __restrict__ dpd_e, float* __restrict__ dh,
    float* __restrict__ dpos, int N, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long node = (long long)blockIdx.x * kWarps + warp;
  if (node >= N) return;
  float acc[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) acc[c] = 0.f;
  float pacc = 0.f;
  for (int64_t k = rowptr_r[node]; k < rowptr_r[node + 1]; ++k) {
    const int64_t e = order_r[k];
    const float* g = dhi + (size_t)e * D;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) acc[c] += g[col];
    }
    if (lane < 3) pacc += dpd_e[(size_t)e * 3 + lane];
  }
  for (int64_t k = rowptr_s[node]; k < rowptr_s[node + 1]; ++k) {
    const int64_t e = order_s[k];
    const float* g = dhj + (size_t)e * D;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) acc[c] += g[col];
    }
    if (lane < 3) pacc -= dpd_e[(size_t)e * 3 + lane];
  }
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int col = lane + 32 * c;
    if (col < D) dh[(size_t)node * D + col] = acc[c];
  }
  if (lane < 3) dpos[(size_t)node * 3 + lane] = pacc;
}

// Partial dW rows of the three weight matrices over edge slice z:
// part[z][row0 + k][c] = sum_e L[e][k] * R[e][c], L = ops[:, lcol : lcol + K],
// R = ops[:, rcol : rcol + D].  blockIdx.x enumerates the row tiles of W1
// (K = 2D+1), W2 and P1 (K = D); blockIdx.y the column tiles.
__global__ void __launch_bounds__(kThreads) egnn_bwd_wgrad_kernel(
    const float* __restrict__ ops, float* __restrict__ part, int E, int D,
    int split) {
  __shared__ float ls[kTile][kTile];
  __shared__ float rs[kTile][kTile];
  const size_t ld = (size_t)15 * D + 1;
  const int v0 = 4 * D + 1;
  const int t_w1 = (2 * D + 1 + kTile - 1) / kTile, t_d = (D + kTile - 1) / kTile;
  int tile = blockIdx.x, K, lcol, rcol, row0;
  if (tile < t_w1) {
    K = 2 * D + 1; lcol = 0; rcol = v0; row0 = 0;
  } else if ((tile -= t_w1) < t_d) {
    K = D; lcol = 2 * D + 1; rcol = v0 + 3 * D; row0 = 2 * D + 4;
  } else {
    tile -= t_d;
    K = D; lcol = 3 * D + 1; rcol = v0 + 6 * D; row0 = 3 * D + 7;
  }
  const int k0 = tile * kTile, c0 = blockIdx.y * kTile;
  const long long e_beg = (long long)blockIdx.z * split;
  const long long e_end = min((long long)E, e_beg + split);
  const int col = threadIdx.x & 31, grp = threadIdx.x >> 5;   // 4 rows each
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long base = e_beg; base < e_end; base += kTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const int ee = i >> 5, kk = i & 31;
      const long long e = base + ee;
      const bool ok = e < e_end;
      ls[ee][kk] = (ok && k0 + kk < K) ? ops[(size_t)e * ld + lcol + k0 + kk] : 0.f;
      rs[ee][kk] = (ok && c0 + kk < D) ? ops[(size_t)e * ld + rcol + c0 + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int ee = 0; ee < kTile; ++ee) {
      const float r = rs[ee][col];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fmaf(ls[ee][grp * 4 + q], r, acc[q]);
    }
  }
  float* out = part + (size_t)blockIdx.z * (4 * D + 12) * D;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = k0 + grp * 4 + q;
    if (k < K && c0 + col < D) out[(size_t)(row0 + k) * D + c0 + col] = acc[q];
  }
}

// Partial vector rows of dW over edge slice z: column sums of
// ops[:, v0 + v*D + c].
__global__ void __launch_bounds__(kThreads) egnn_bwd_colsum_kernel(
    const float* __restrict__ ops, float* __restrict__ part, int E, int D,
    int split) {
  __shared__ float psum[kWarps][32];
  const size_t ld = (size_t)15 * D + 1;
  const int v = blockIdx.x;                     // vector row 0..10
  const int src = 4 * D + 1 + v * D;
  // output row: b,g,B of the three stages after W1 (2D+1 rows), W2 and P1,
  // then P2 and pb2
  const int row = v < 9 ? (v / 3 == 0 ? 2 * D + 1 : v / 3 == 1 ? 3 * D + 4 : 4 * D + 7) + v % 3
                        : 4 * D + 1 + v;
  const int col = blockIdx.y * 32 + (threadIdx.x & 31), grp = threadIdx.x >> 5;
  const long long e_beg = (long long)blockIdx.z * split;
  const long long e_end = min((long long)E, e_beg + split);
  float s = 0.f;
  if (col < D)
    for (long long e = e_beg + grp; e < e_end; e += kWarps)
      s += ops[(size_t)e * ld + src + col];
  psum[grp][threadIdx.x & 31] = s;
  __syncthreads();
  if (grp == 0 && col < D) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < kWarps; ++g) t += psum[g][threadIdx.x & 31];
    part[((size_t)blockIdx.z * (4 * D + 12) + row) * D + col] = t;
  }
}

// dW = sum over the slices' partial dW, in slice order.
__global__ void __launch_bounds__(kThreads) egnn_bwd_wsum_kernel(
    const float* __restrict__ part, float* __restrict__ dw, int slices,
    int size) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= size) return;
  float t = 0.f;
  for (int z = 0; z < slices; ++z) t += part[(size_t)z * size + i];
  dw[i] = t;
}

size_t edge_smem_bytes(int D) {
  return sizeof(float) * ((size_t)kTileEdges * (2 * D + 1) +
                          (size_t)kTileEdges * D + (size_t)kTStride * D);
}

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
  const int blocks = (E + kTileEdges - 1) / kTileEdges;
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
  egnn_bwd_wgrad_kernel<<<dim3(t_w1 + 2 * t_d, t_d, slices), kThreads, 0, s>>>(
      static_cast<const float*>(ops), static_cast<float*>(part), E, D, split);
  if ((rc = (int)cudaGetLastError())) return rc;
  egnn_bwd_colsum_kernel<<<dim3(kVecRows, t_d, slices), kThreads, 0, s>>>(
      static_cast<const float*>(ops), static_cast<float*>(part), E, D, split);
  if ((rc = (int)cudaGetLastError())) return rc;
  const int size = (4 * D + 12) * D;
  egnn_bwd_wsum_kernel<<<(size + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), slices, size);
  return (int)cudaGetLastError();
}
