// Shared device code of the EGNN kernels: the message pass (egnn_message.cu,
// K1), its backward (egnn_message_bwd.cu, K2) and the whole stack
// (egnn_stack.cu and egnn_stack_bwd.cu, K6).  Exact f32 on the CUDA cores
// (no TF32).
//
// A block of 8 warps works on a tile of 16 rows (edges or nodes): each warp
// owns 2 rows and each lane 1/32 of the columns, so an activation row stays
// in registers through its LayerNorm (warp-shuffle sums) and every FMA reads
// one broadcast activation from the warp's own rows in shared memory and one
// conflict-free weight from a K-tile of 32 weight rows staged in shared
// memory.  A warp reads and writes only its own rows of the tile's shared
// buffers; the staged weight tile is the only buffer the warps share, and
// every product fences it with __syncthreads.
//
// Packed message rows (ops/edge.py::pack_egnn_weights, [4D+12, D]):
//   W1 [2D+1] b1 g1 B1 | W2 [D] b2 g2 B2 | P1 [D] pb1 pg1 pB1 | P2 | pb2 (col 0)
// and, for the stack, the update MLP after them ([3D+6, D]):
//   U1 [2D] ub1 ug1 uB1 | U2 [D] ub2 ug2 uB2.
//
// Buffers that another block of the same launch writes (the stack's node
// state, per-edge messages, cotangents) are read with __ldcg (L2, not L1),
// so a persistent kernel never reads a stale line after its grid barrier.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace egnn {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kTileRows = kWarps * kRowsPerWarp;    // edges or nodes per tile
constexpr int kTileK = 32;                          // weight rows per K-tile
constexpr int kTStride = kTileK + 1;                // transposed tile stride
constexpr int kMaxCols = 8;                         // columns per lane, D <= 256
constexpr int kVecRows = 11;                        // vector rows of the message dW
constexpr int kTile = 32;                           // dW tile (rows, cols, rows summed)
constexpr float kEps = 1e-5f;

typedef float Rows[kRowsPerWarp][kMaxCols];

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same (bitwise) sum
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_row(int r) {
  return (threadIdx.x >> 5) * kRowsPerWarp + r;
}

// acc[r][c] = sum_k A[row r][k] * W[k][col c] for the warp's rows and the
// lane's columns (lane + 32 c).  A lives in shared memory with row stride
// lda; W [K, D] row-major in global memory is staged through ws in K-tiles.
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
    __syncthreads();  // the previous tile is consumed, A is written
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
// into wt[row * kTStride + k] (the odd stride keeps the lanes' reads on
// distinct banks).
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

// Rows of the warp into a per-row buffer: out[e * ld + col] = v (times w
// when kMul), 0 on rows that are not live; rows past E are not written.
template <bool kMul>
__device__ __forceinline__ void store_rows_impl(
    const Rows& v, const Rows& w, float* __restrict__ out, size_t ld,
    long long e0, long long E, const bool (&live)[kRowsPerWarp], int D) {
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
    const Rows& v, float* __restrict__ out, size_t ld, long long e0, long long E,
    const bool (&live)[kRowsPerWarp], int D) {
  store_rows_impl<false>(v, v, out, ld, e0, E, live, D);
}

__device__ __forceinline__ void store_edges(
    const Rows& v, const Rows& w, float* __restrict__ out, size_t ld,
    long long e0, long long E, const bool (&live)[kRowsPerWarp], int D) {
  store_rows_impl<true>(v, w, out, ld, e0, E, live, D);
}

__device__ __forceinline__ void copy_rows(const Rows& v, Rows& out) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) out[r][c] = v[r][c];
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

// ---------------------------------------------------------------------------
// The message backward on one tile of edges (K2's edge kernel; the stack's
// backward runs it per layer).
// ---------------------------------------------------------------------------

// Floats of shared memory edge_bwd_tile needs: x [16, 2D+1], a second row
// buffer [16, D], the weight tile (the larger of [32, D] and [D, 33]), the
// edges' position differences [16, 3] and inverse distances [16].
__host__ __device__ inline size_t edge_bwd_smem_floats(int D) {
  return (size_t)kTileRows * (2 * D + 1) + (size_t)kTileRows * D +
         (size_t)kTStride * D + (size_t)kTileRows * 4;
}

// Recompute the forward of edges [16 tile, 16 tile + 16), then run the
// backward given the cotangents gmsg [N, D] and gpos [N, 3] of the receiver
// sums.  Writes per edge: dh_i, dh_j [E, D], dpd [E, 3] and one row of `ops`
// [E, 15D+1]: the left operands of the weight products (x, m, msg) and, in
// packed-row order, the per-edge terms whose sums over edges are the vector
// rows of dW (dz1, dy1*xhat1, dy1, dz2, ..., p*dscale, [dscale, 0, ...]).
// Masked-off edges write zero rows.
template <typename Idx>
__device__ void edge_bwd_tile(
    long long tile, const Idx* __restrict__ send, const Idx* __restrict__ recv,
    const uint8_t* __restrict__ emask, const float* h, const float* pos,
    const float* __restrict__ W, const float* gmsg, const float* gpos,
    float* ops, float* dhi, float* dhj, float* dpd_e, long long E, int D,
    float* smem) {
  const int K1 = 2 * D + 1;
  const size_t ld = (size_t)15 * D + 1;    // ops row: x m msg | 11 vector rows
  float* const vec = ops + 4 * D + 1;      // column of the first vector row
  float* xs = smem;                        // [kTileRows, K1]: x, later msg
  float* ys = xs + kTileRows * K1;         // [kTileRows, D]: m, later dz
  float* ws = ys + kTileRows * D;          // weight tile, [kTileK, D] or [D, kTStride]
  float* pd_s = ws + kTStride * D;         // [kTileRows, 3]
  float* inv_s = pd_s + kTileRows * 3;     // [kTileRows]

  const int lane = lane_id();
  const long long e0 = tile * kTileRows;
  __syncthreads();   // the previous tile's rows are consumed

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
        inv_s[row] = positive ? 1.f / dist : 0.f;
        pd_s[row * 3] = dx;
        pd_s[row * 3 + 1] = dy;
        pd_s[row * 3 + 2] = dz;
      }
    } else {
      for (int c = lane; c < K1; c += 32) x[c] = 0.f;
      if (lane < 3) pd_s[row * 3 + lane] = 0.f;
      if (lane == 0) inv_s[row] = 0.f;
    }
    __syncwarp();
    if (e < E)
      for (int c = lane; c < K1; c += 32) ops[(size_t)e * ld + c] = x[c];
  }

  const MsgWeights m = msg_weights(W, D);
  Rows acc, xh1, xh2, xh3;
  float rstd1[kRowsPerWarp], rstd2[kRowsPerWarp], rstd3[kRowsPerWarp];

  // ---- forward recompute ----
  matmul_rows(xs, K1, K1, m.W1, D, ws, acc);        // m = relu(LN1(x W1 + b1))
  bias_normalise(acc, m.b1, D, rstd1);
  copy_rows(acc, xh1);
  affine_relu(xh1, m.g1, m.B1, D, acc);
  store_smem(acc, ys, D, D);
  store_edges(acc, ops + K1, ld, e0, E, live, D);

  matmul_rows(ys, D, D, m.W2, D, ws, acc);          // msg = relu(LN2(m W2 + b2))
  bias_normalise(acc, m.b2, D, rstd2);
  copy_rows(acc, xh2);
  affine_relu(xh2, m.g2, m.B2, D, acc);
  store_smem(acc, xs, D, D);
  store_edges(acc, ops + K1 + D, ld, e0, E, live, D);

  matmul_rows(xs, D, D, m.P1, D, ws, acc);          // p = relu(LN3(msg P1 + pb1))
  bias_normalise(acc, m.pb1, D, rstd3);
  copy_rows(acc, xh3);
  Rows p;
  affine_relu(xh3, m.pg1, m.pB1, D, p);

  // ---- backward: scale head ----
  // cotangents at this edge's outputs: gmsg[recv], gpos[recv] (0 if masked)
  float scale[kRowsPerWarp], dscale[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) s = fmaf(p[r][c], m.P2[col], s);
    }
    scale[r] = warp_sum(s) + m.pb2;
    const int row = warp_row(r);
    const float* g = gpos + 3 * ri[r];
    dscale[r] = live[r] ? __ldcg(g) * pd_s[row * 3] + __ldcg(g + 1) * pd_s[row * 3 + 1] +
                              __ldcg(g + 2) * pd_s[row * 3 + 2]
                        : 0.f;
  }
  // per-edge P2 term p * dscale, then dy3 = dscale * P2 where p > 0
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[r][c] = p[r][c] * dscale[r];
  store_edges(acc, vec + 9 * D, ld, e0, E, live, D);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      acc[r][c] = (col < D && p[r][c] > 0.f) ? dscale[r] * m.P2[col] : 0.f;
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
  ln_backward(acc, xh3, rstd3, m.pg1, D);
  store_edges(acc, vec + 6 * D, ld, e0, E, live, D);  // dz3
  store_smem(acc, ys, D, D);
  matmul_rows_t(ys, D, m.P1, D, ws, acc);
  Rows msk;
  affine_relu(xh2, m.g2, m.B2, D, msk);                        // msg
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float* g = gmsg + (size_t)ri[r] * D;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      const float dmsg = (live[r] && col < D) ? __ldcg(g + col) + acc[r][c] : 0.f;
      acc[r][c] = msk[r][c] > 0.f ? dmsg : 0.f;                // dy2
    }
  }

  // ---- LN2 -> dz2; dm = dz2 W2^T ----
  store_edges(acc, xh2, vec + 4 * D, ld, e0, E, live, D);
  store_edges(acc, vec + 5 * D, ld, e0, E, live, D);
  ln_backward(acc, xh2, rstd2, m.g2, D);
  store_edges(acc, vec + 3 * D, ld, e0, E, live, D);  // dz2
  store_smem(acc, ys, D, D);
  matmul_rows_t(ys, D, m.W2, D, ws, acc);
  affine_relu(xh1, m.g1, m.B1, D, msk);                        // m
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      acc[r][c] = msk[r][c] > 0.f ? acc[r][c] : 0.f;           // dy1

  // ---- LN1 -> dz1; dx = dz1 W1^T = [dh_i, dh_j, ddist] ----
  store_edges(acc, xh1, vec + 1 * D, ld, e0, E, live, D);
  store_edges(acc, vec + 2 * D, ld, e0, E, live, D);
  ln_backward(acc, xh1, rstd1, m.g1, D);
  store_edges(acc, vec, ld, e0, E, live, D);          // dz1
  store_smem(acc, ys, D, D);
  float ddist[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) s = fmaf(acc[r][c], m.W1[(size_t)2 * D * D + col], s);
    }
    ddist[r] = warp_sum(s);
  }
  matmul_rows_t(ys, D, m.W1, D, ws, acc);                      // dh_i
  store_edges(acc, dhi, D, e0, E, live, D);
  matmul_rows_t(ys, D, m.W1 + (size_t)D * D, D, ws, acc);      // dh_j
  store_edges(acc, dhj, D, e0, E, live, D);

  // dpd = gpos[recv] * scale + ddist * pd * inv
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp_row(r);
    const long long e = e0 + row;
    if (e < E && lane < 3) {
      const float pd = pd_s[row * 3 + lane];
      dpd_e[(size_t)e * 3 + lane] =
          live[r] ? __ldcg(gpos + 3 * ri[r] + lane) * scale[r] + ddist[r] * pd * inv_s[row]
                  : 0.f;
    }
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
  for (int64_t k = rowptr_r[node]; k < rowptr_r[node + 1]; ++k) {
    const int64_t e = order_r[k];
    const float* g = dhi + (size_t)e * D;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) acc[c] += __ldcg(g + col);
    }
    if (lane < 3) pacc += __ldcg(dpd_e + (size_t)e * 3 + lane);
  }
  for (int64_t k = rowptr_s[node]; k < rowptr_s[node + 1]; ++k) {
    const int64_t e = order_s[k];
    const float* g = dhj + (size_t)e * D;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) acc[c] += __ldcg(g + col);
    }
    if (lane < 3) pacc -= __ldcg(dpd_e + (size_t)e * 3 + lane);
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
  const int v0 = 4 * D + 1;
  if (s == 0) return Stage{2 * D + 1, 0, v0, 0};
  if (s == 1) return Stage{D, 2 * D + 1, v0 + 3 * D, 2 * D + 4};
  return Stage{D, 3 * D + 1, v0 + 6 * D, 3 * D + 7};
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

// The 32 x 32 tile (k0, c0) of a stage's matrix over rows [e_beg, e_end) of
// `ops` (row stride ld), into part (one slice's partial dW, row stride D).
// Each thread owns one column and 4 rows of the tile; the rows are walked in
// order in chunks of 32 staged through shared memory (2 x 32 x 32 floats).
__device__ __forceinline__ void wgrad_tile(
    const float* ops, size_t ld, Stage st, int k0, int c0, long long e_beg,
    long long e_end, float* part, int D, float* smem) {
  float* ls = smem;                 // [kTile rows][kTile]
  float* rs = smem + kTile * kTile;
  const int col = threadIdx.x & 31, grp = threadIdx.x >> 5;   // 4 rows each
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long base = e_beg; base < e_end; base += kTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const int ee = i >> 5, kk = i & 31;
      const long long e = base + ee;
      const bool ok = e < e_end;
      ls[i] = (ok && k0 + kk < st.K) ? __ldcg(ops + (size_t)e * ld + st.lcol + k0 + kk) : 0.f;
      rs[i] = (ok && c0 + kk < D) ? __ldcg(ops + (size_t)e * ld + st.rcol + c0 + kk) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int ee = 0; ee < kTile; ++ee) {
      const float r = rs[ee * kTile + col];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fmaf(ls[ee * kTile + grp * 4 + q], r, acc[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = k0 + grp * 4 + q;
    if (k < st.K && c0 + col < D) part[(size_t)(st.row0 + k) * D + c0 + col] = acc[q];
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
  if (col < D)
    for (long long e = e_beg + grp; e < e_end; e += kWarps)
      s += __ldcg(ops + (size_t)e * ld + src + col);
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
// The whole stack (K6): forward tiles shared by its forward and backward
// kernels, and the grid barrier of its persistent launches.
// ---------------------------------------------------------------------------

// Floats of shared memory the stack's tiles need: the largest of the edge
// backward's, the edge forward's (x [16, 2D+1], [16, D], [32, D], pd [16, 3]),
// the node tiles' ([16, 2D], [16, D], weight tile [D, 33]) and the weight
// gradient's (2 x 32 x 32).
__host__ __device__ inline size_t stack_smem_floats(int D) {
  const size_t edge = edge_bwd_smem_floats(D), wgrad = 2 * kTile * kTile;
  return edge > wgrad ? edge : wgrad;
}

// Forward of edges [16 tile, 16 tile + 16) of one layer: the message MLP and
// scale head (the same expressions as edge_bwd_tile's recompute), writing
// msg [E, D] and pos_msg [E, 3] for the live edges.
template <typename Idx>
__device__ void edge_fwd_tile(
    long long tile, const Idx* __restrict__ send, const Idx* __restrict__ recv,
    const uint8_t* __restrict__ emask, const float* h, const float* pos,
    const float* __restrict__ W, float* msg_e, float* pos_e, long long E, int D,
    float* smem) {
  const int K1 = 2 * D + 1;
  float* xs = smem;                        // [kTileRows, K1]: x, later msg
  float* ys = xs + kTileRows * K1;         // [kTileRows, D]: m
  float* ws = ys + kTileRows * D;          // [kTileK, D]
  float* pd_s = ws + kTStride * D;         // [kTileRows, 3]
  const int lane = lane_id();
  const long long e0 = tile * kTileRows;
  __syncthreads();

  bool live[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp_row(r);
    const long long e = e0 + row;
    live[r] = e < E && emask[e] != 0;
    float* x = xs + row * K1;
    if (live[r]) {
      const long long i = (long long)recv[e], j = (long long)send[e];
      for (int c = lane; c < D; c += 32) {
        x[c] = __ldcg(h + i * D + c);
        x[D + c] = __ldcg(h + j * D + c);
      }
      if (lane == 0) {
        const float dx = __ldcg(pos + 3 * i) - __ldcg(pos + 3 * j);
        const float dy = __ldcg(pos + 3 * i + 1) - __ldcg(pos + 3 * j + 1);
        const float dz = __ldcg(pos + 3 * i + 2) - __ldcg(pos + 3 * j + 2);
        const float sq = dx * dx + dy * dy + dz * dz;
        x[2 * D] = sq > 1e-24f ? sqrtf(sq) : 0.f;
        pd_s[row * 3] = dx;
        pd_s[row * 3 + 1] = dy;
        pd_s[row * 3 + 2] = dz;
      }
    } else {
      for (int c = lane; c < K1; c += 32) x[c] = 0.f;
      if (lane < 3) pd_s[row * 3 + lane] = 0.f;
    }
  }

  const MsgWeights m = msg_weights(W, D);
  Rows acc, out;
  float rstd[kRowsPerWarp];
  matmul_rows(xs, K1, K1, m.W1, D, ws, acc);        // m = relu(LN1(x W1 + b1))
  bias_normalise(acc, m.b1, D, rstd);
  affine_relu(acc, m.g1, m.B1, D, out);
  store_smem(out, ys, D, D);
  matmul_rows(ys, D, D, m.W2, D, ws, acc);          // msg = relu(LN2(m W2 + b2))
  bias_normalise(acc, m.b2, D, rstd);
  affine_relu(acc, m.g2, m.B2, D, out);
  store_smem(out, xs, D, D);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (!live[r]) continue;
    float* o = msg_e + (size_t)(e0 + warp_row(r)) * D;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) o[col] = out[r][c];
    }
  }
  matmul_rows(xs, D, D, m.P1, D, ws, acc);          // p = relu(LN3(msg P1 + pb1))
  bias_normalise(acc, m.pb1, D, rstd);
  affine_relu(acc, m.pg1, m.pB1, D, out);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) s = fmaf(out[r][c], m.P2[col], s);
    }
    const float scale = warp_sum(s) + m.pb2;
    const int row = warp_row(r);
    if (live[r] && lane < 3)
      pos_e[(size_t)(e0 + row) * 3 + lane] = pd_s[row * 3 + lane] * scale;
  }
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

// The node side of one layer on nodes [16 tile, 16 tile + 16): each warp sums
// its nodes' receiver CSR rows of msg [E, D] and pos_msg [E, 3] in ascending
// edge order (msg_acc, stored to macc when given), then, when Wu is given,
// the update MLP u = relu(LN(cat(h, msg_acc) U1 + ub1)),
// upd = relu(LN(u U2 + ub2)), and writes h_out = h + upd and
// pos_out = pos + pos_sum / max(cnt, 1).  h_out and pos_out may be h and pos:
// a node's row is read before it is written, by the warp that owns it.
__device__ void node_fwd_tile(
    long long tile, const int64_t* __restrict__ order,
    const int64_t* __restrict__ rowptr, const float* msg_e, const float* pos_e,
    const float* h, const float* pos, const float* __restrict__ Wu, float* macc,
    float* h_out, float* pos_out, long long N, int D, float* smem) {
  float* uin = smem;                       // [kTileRows, 2D]: [h, msg_acc]
  float* ys = uin + kTileRows * 2 * D;     // [kTileRows, D]: u
  float* ws = ys + kTileRows * D;          // [kTileK, D]
  const int lane = lane_id();
  const long long n0 = tile * kTileRows;
  __syncthreads();

  float pnew[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp_row(r);
    const long long node = n0 + row;
    float* u = uin + row * 2 * D;
    pnew[r] = 0.f;
    if (node >= N) {
      for (int c = lane; c < 2 * D; c += 32) u[c] = 0.f;
      continue;
    }
    const int64_t beg = rowptr[node], end = rowptr[node + 1];
    float acc[kMaxCols];
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[c] = 0.f;
    float pacc = 0.f;
    for (int64_t k = beg; k < end; ++k) {
      const int64_t e = order[k];
      const float* mrow = msg_e + (size_t)e * D;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int col = lane + 32 * c;
        if (col < D) acc[c] += __ldcg(mrow + col);
      }
      if (lane < 3) pacc += __ldcg(pos_e + (size_t)e * 3 + lane);
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
      pnew[r] = __ldcg(pos + (size_t)node * 3 + lane) +
                pacc / fmaxf((float)(end - beg), 1.f);
  }
  if (Wu == nullptr) return;

  const UpdWeights w = upd_weights(Wu, D);
  Rows acc, out;
  float rstd[kRowsPerWarp];
  matmul_rows(uin, 2 * D, 2 * D, w.U1, D, ws, acc);
  bias_normalise(acc, w.ub1, D, rstd);
  affine_relu(acc, w.ug1, w.uB1, D, out);
  store_smem(out, ys, D, D);
  matmul_rows(ys, D, D, w.U2, D, ws, acc);
  bias_normalise(acc, w.ub2, D, rstd);
  affine_relu(acc, w.ug2, w.uB2, D, out);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp_row(r);
    const long long node = n0 + row;
    if (node >= N) continue;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) h_out[(size_t)node * D + col] = uin[row * 2 * D + col] + out[r][c];
    }
    if (lane < 3) pos_out[(size_t)node * 3 + lane] = pnew[r];
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

}  // namespace egnn
