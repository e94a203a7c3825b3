// Shared pieces of the GVP message kernels (gvp_message.cu, forward;
// gvp_message_bwd.cu, backward): the chain's dimensions, the flat weight
// layout, the shared-memory products and one GVP of the chain on a tile of
// edges.  Exact f32 on the CUDA cores (no TF32).
//
// The chain (ops/gvp_message.py::gvp_chain) maps, per edge, the tuple
// (s [si], V [3, vi]) through L GVPs.  GVP k, with weights Wh [vi, h],
// Wv [h, vo], Ws [si+h, so], bs [so], Wsv [so, vo], bsv [vo]:
//   vh = V Wh (each of the 3 component planes), vn = sqrt(max(|vh|^2, 1e-8)),
//   z = [s, vn] Ws + bs, vo = vh Wv, gi = sigmoid(z) (z on the last GVP),
//   g = sigmoid(gi Wsv + bsv), V' = vo * g, s' = relu(z) (z on the last).
// A tile of kTile edges keeps its rows in shared memory: scalars as kTile
// rows, vectors as 3 * kTile rows, plane p of edge r at row p * kTile + r.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gvp {

constexpr int kThreads = 256;
constexpr int kTile = 8;        // edges per block
constexpr int kTileK = 16;      // weight rows per staged K-tile
constexpr int kMaxN = 256;      // output columns per pass of a product
constexpr int kMaxR = 16;       // output rows per thread in a pass
constexpr int kMaxLayers = 8;
constexpr float kNormEps = 1e-8f;

struct Dims {
  int L;                   // GVPs in the chain
  int S, V, SE, VE;        // node scalar/vector and edge scalar/vector widths
  int si[kMaxLayers], vi[kMaxLayers], h[kMaxLayers], so[kMaxLayers],
      vo[kMaxLayers];
};

// floats of GVP k's six weights in the flat buffer (Wh Wv Ws bs Wsv bsv)
__host__ __device__ inline long long layer_weights(const Dims& d, int k) {
  const long long si = d.si[k], vi = d.vi[k], h = d.h[k], so = d.so[k],
                  vo = d.vo[k];
  return vi * h + h * vo + (si + h) * so + so + so * vo + vo;
}

__host__ __device__ inline long long weight_offset(const Dims& d, int k) {
  long long off = 0;
  for (int j = 0; j < k; ++j) off += layer_weights(d, j);
  return off;
}

__host__ __device__ inline int max_of(const int* a, int n) {
  int m = 0;
  for (int i = 0; i < n; ++i) m = a[i] > m ? a[i] : m;
  return m;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// C[r * ldc + c] = sum_k A[r * lda + k] * w(k, c) for r < R, c < N, where
// w(k, c) = W[k * N + c] (W [K, N] row-major) or, with kTrans, W[c * K + k]
// (the product with the transpose of W [N, K]).  A and C lie in shared
// memory and must not overlap; W lies in global memory and is staged
// through ws (kTileK * kMaxN floats) in K-tiles.  Columns go in passes of
// at most kMaxN; in a pass of width nc, thread t owns column t % nc and
// the rows t / nc, t / nc + 256 / nc, ..., so every thread reads one
// staged weight per k and the rows' activations as warp broadcasts.
// Needs ceil(R / (256 / nc)) <= kMaxR.  Starts and ends with __syncthreads.
template <bool kTrans>
__device__ void mm(const float* A, int lda, int R, int K,
                   const float* __restrict__ W, int N, float* ws, float* C,
                   int ldc) {
  for (int c0 = 0; c0 < N; c0 += kMaxN) {
    const int nc = min(kMaxN, N - c0);
    const int ngrp = kThreads / nc;
    const int col = threadIdx.x % nc, grp = threadIdx.x / nc;
    const bool active = grp < ngrp;
    float acc[kMaxR];
#pragma unroll
    for (int i = 0; i < kMaxR; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kTileK) {
      const int kt = min(kTileK, K - k0);
      __syncthreads();  // A is written, the previous tile consumed
      for (int i = threadIdx.x; i < kt * nc; i += kThreads) {
        const int kk = i / nc, c = i - kk * nc;
        ws[i] = kTrans ? W[(size_t)(c0 + c) * K + k0 + kk]
                       : W[(size_t)(k0 + kk) * N + c0 + c];
      }
      __syncthreads();
      if (active) {
        for (int kk = 0; kk < kt; ++kk) {
          const float w = ws[kk * nc + col];
#pragma unroll
          for (int i = 0; i < kMaxR; ++i) {
            const int r = grp + i * ngrp;
            if (r < R) acc[i] = fmaf(A[r * lda + k0 + kk], w, acc[i]);
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) {
        const int r = grp + i * ngrp;
        if (r < R) C[r * ldc + c0 + col] = acc[i];
      }
    }
  }
  __syncthreads();
}

// Gather the chain input of the tile starting at edge e0:
// X[r, :si0] = [s[j], es[e], s[i]] and V[p * kTile + r, :vi0] =
// [v_p[j], ev_p[e], v_p[i]] for e = e0 + r, j = send[e], i = recv[e]; rows
// of masked-off edges and of edges past E are zero.  live[r] gets the mask.
template <typename Idx>
__device__ void gather_tile(const Dims& d, const Idx* __restrict__ send,
                            const Idx* __restrict__ recv,
                            const uint8_t* __restrict__ emask,
                            const float* __restrict__ s, const float* const* vp,
                            const float* __restrict__ es, const float* const* evp,
                            long long e0, int E, float* X, int ldx, float* V,
                            int ldv, bool* live) {
  if (threadIdx.x < kTile) {
    const long long e = e0 + threadIdx.x;
    live[threadIdx.x] = e < E && emask[e] != 0;
  }
  __syncthreads();
  const int S = d.S, SE = d.SE, Vn = d.V, VE = d.VE;
  const int si0 = 2 * S + SE, vi0 = 2 * Vn + VE;
  for (int i = threadIdx.x; i < kTile * si0; i += kThreads) {
    const int r = i / si0, c = i - r * si0;
    const long long e = e0 + r;
    float val = 0.f;
    if (live[r]) {
      if (c < S) val = s[(size_t)send[e] * S + c];
      else if (c < S + SE) val = es[(size_t)e * SE + c - S];
      else val = s[(size_t)recv[e] * S + c - S - SE];
    }
    X[r * ldx + c] = val;
  }
  for (int i = threadIdx.x; i < 3 * kTile * vi0; i += kThreads) {
    const int row = i / vi0, c = i - row * vi0;
    const int p = row / kTile, r = row - p * kTile;
    const long long e = e0 + r;
    float val = 0.f;
    if (live[r]) {
      if (c < Vn) val = vp[p][(size_t)send[e] * Vn + c];
      else if (c < Vn + VE) val = evp[p][(size_t)e * VE + c - Vn];
      else val = vp[p][(size_t)recv[e] * Vn + c - Vn - VE];
    }
    V[row * ldv + c] = val;
  }
  __syncthreads();
}

// GVP k of the chain on the tile: reads X[:, :si] and V (3 kTile rows of
// vi); writes VH, vn into X[:, si : si + h], GI (sigmoid(z), or z on the
// last GVP), VO and G, then Xn[:, :so] = relu(z) (not on the last GVP) and,
// when Vn is given, Vn = VO * G.  Xn and Vn may be X and V.
__device__ void layer_forward(const Dims& d, int k, const float* __restrict__ Wk,
                              float* X, int ldx, const float* V, int ldv,
                              float* VH, int ldvh, float* GI, int ldgi,
                              float* VO, int ldvo, float* G, int ldg, float* Xn,
                              int ldxn, float* Vn, int ldvn, float* ws) {
  const int si = d.si[k], vi = d.vi[k], h = d.h[k], so = d.so[k], vo = d.vo[k];
  const bool last = k == d.L - 1;
  const float* Wh = Wk;
  const float* Wv = Wh + (size_t)vi * h;
  const float* Ws = Wv + (size_t)h * vo;
  const float* bs = Ws + (size_t)(si + h) * so;
  const float* Wsv = bs + so;
  const float* bsv = Wsv + (size_t)so * vo;

  mm<false>(V, ldv, 3 * kTile, vi, Wh, h, ws, VH, ldvh);
  for (int i = threadIdx.x; i < kTile * h; i += kThreads) {
    const int r = i / h, c = i - r * h;
    const float a = VH[r * ldvh + c], b = VH[(kTile + r) * ldvh + c],
                e = VH[(2 * kTile + r) * ldvh + c];
    X[r * ldx + si + c] = sqrtf(fmaxf(a * a + b * b + e * e, kNormEps));
  }
  mm<false>(X, ldx, kTile, si + h, Ws, so, ws, GI, ldgi);
  mm<false>(VH, ldvh, 3 * kTile, h, Wv, vo, ws, VO, ldvo);
  for (int i = threadIdx.x; i < kTile * so; i += kThreads) {
    const int r = i / so, c = i - r * so;
    const float z = GI[r * ldgi + c] + bs[c];
    if (last) {
      GI[r * ldgi + c] = z;
    } else {
      Xn[r * ldxn + c] = fmaxf(z, 0.f);
      GI[r * ldgi + c] = sigmoid(z);
    }
  }
  mm<false>(GI, ldgi, kTile, so, Wsv, vo, ws, G, ldg);
  for (int i = threadIdx.x; i < kTile * vo; i += kThreads) {
    const int r = i / vo, c = i - r * vo;
    G[r * ldg + c] = sigmoid(G[r * ldg + c] + bsv[c]);
  }
  __syncthreads();
  if (Vn != nullptr) {
    for (int i = threadIdx.x; i < 3 * kTile * vo; i += kThreads) {
      const int row = i / vo, c = i - row * vo;
      Vn[row * ldvn + c] = VO[row * ldvo + c] * G[(row % kTile) * ldg + c];
    }
  }
  __syncthreads();
}

}  // namespace gvp
