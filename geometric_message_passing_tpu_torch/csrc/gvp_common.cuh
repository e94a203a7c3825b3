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
// A tile of TE edges (TE = 8, 16 or 32, a template parameter chosen by
// ops/gvp_message.py::gvp_tile) keeps its rows in shared memory: scalars as
// TE rows, vectors as 3 TE rows, plane p of edge r at row p * TE + r.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gvp {

constexpr int kThreads = 256;
constexpr int kTileK = 16;      // weight rows per staged K-tile
constexpr int kMaxN = 128;      // output columns per pass of a product
// Row stride of a staged K-tile of ncg float4 columns: an odd number of
// float4s, so the transposed staging's writes (a warp: up to 16 rows of 2
// columns) fall in 16 banks, not the 2 of a stride that is a multiple of 32
__host__ __device__ constexpr int stage_stride(int ncg) { return 4 * (ncg | 1); }
constexpr int kStage = kTileK * stage_stride(kMaxN / 4);   // floats of one K-tile
// K-tiles in flight (the staging ring): the more, the longer a copy's
// latency is hidden; fewer where a larger tile's shared memory would
// otherwise leave one block per SM
__host__ __device__ constexpr int fwd_stages(int TE) { return TE >= 32 ? 2 : 4; }
__host__ __device__ constexpr int bwd_stages(int TE) { return TE <= 8 ? 2 : 4; }
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of w(k, c) for k0 <= k < k0 + kt, c0 <= c < c0 + nc into
// buf[(k - k0) * np + c - c0] (4-byte cp.async: any alignment), where
// w(k, c) = W[k * N + c] or, with kTrans, W[c * K + k].  Consecutive threads
// take consecutive addresses of W.
template <bool kTrans>
__device__ __forceinline__ void stage(const float* __restrict__ W, int K,
                                      int N, int k0, int kt, int c0, int nc,
                                      int np, float* buf) {
  if (!kTrans) {
    const int dk = kThreads / nc, dc = kThreads - dk * nc;
    int kk = threadIdx.x / nc, c = threadIdx.x - kk * nc;
    while (kk < kt) {
      cp_async4(buf + kk * np + c, W + (size_t)(k0 + kk) * N + c0 + c);
      c += dc;
      kk += dk;
      if (c >= nc) { c -= nc; ++kk; }
    }
  } else {
    const int dc = kThreads / kt, dk = kThreads - dc * kt;
    int c = threadIdx.x / kt, kk = threadIdx.x - c * kt;
    while (c < nc) {
      cp_async4(buf + kk * np + c, W + (size_t)(c0 + c) * K + k0 + kk);
      kk += dk;
      c += dc;
      if (kk >= kt) { kk -= kt; ++c; }
    }
  }
}

// One product with TR x 4 outputs per thread: see mm.
template <bool kTrans, int TR, int S>
__device__ void mm_tr(const float* A, int lda, int R, int K,
                      const float* __restrict__ W, int N, float* ws, float* C,
                      int ldc) {
  const int ntiles = (K + kTileK - 1) / kTileK;
  for (int c0 = 0; c0 < N; c0 += kMaxN) {
    const int nc = min(kMaxN, N - c0), ncg = (nc + 3) >> 2,
              np = stage_stride(ncg);
    const int nrb = R / TR, nmt = nrb * ncg;
    // consecutive threads: RW row blocks, then the next column group, so a
    // warp reads few staged weights (8 float4 for RW 4) and few rows
    const int RW = nrb % 4 == 0 ? 4 : (nrb % 2 == 0 ? 2 : 1);
    for (int p0 = 0; p0 < nmt; p0 += kThreads) {
      const int mt = p0 + threadIdx.x;
      const bool active = mt < nmt;
      const int q = mt / RW, cg = active ? q % ncg : 0,
                rb = active ? (q / ncg) * RW + mt % RW : 0;
      const float* Ar = A + (size_t)rb * TR * lda;
      float acc[TR][4];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      // S - 1 K-tiles in flight ahead of the one in use; a commit group per
      // tile (empty past the last), so waiting for all but the newest S - 1
      // groups waits for tile t
      for (int t = 0; t < S - 1; ++t) {
        if (t < ntiles)
          stage<kTrans>(W, K, N, t * kTileK, min(kTileK, K - t * kTileK), c0,
                        nc, np, ws + t * kStage);
        cp_async_commit();
      }
      for (int t = 0; t < ntiles; ++t) {
        const int k0 = t * kTileK, kt = min(kTileK, K - k0);
        const int ahead = t + S - 1;
        if (ahead < ntiles)
          stage<kTrans>(W, K, N, ahead * kTileK,
                        min(kTileK, K - ahead * kTileK), c0, nc, np,
                        ws + (ahead % S) * kStage);
        cp_async_commit();
        cp_async_wait<S - 1>();
        __syncthreads();   // this K-tile (and A) visible to every thread
        if (active) {
          const float* wb = ws + (t % S) * kStage + cg * 4;
          const float* a = Ar + k0;
#pragma unroll 4
          for (int kk = 0; kk < kt; ++kk) {
            const float4 w = *reinterpret_cast<const float4*>(wb + kk * np);
#pragma unroll
            for (int i = 0; i < TR; ++i) {
              const float av = a[i * lda + kk];
              acc[i][0] = fmaf(av, w.x, acc[i][0]);
              acc[i][1] = fmaf(av, w.y, acc[i][1]);
              acc[i][2] = fmaf(av, w.z, acc[i][2]);
              acc[i][3] = fmaf(av, w.w, acc[i][3]);
            }
          }
        }
        __syncthreads();   // the buffer is free for the K-tile S ahead
      }
      if (active) {
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          float* c = C + (size_t)(rb * TR + i) * ldc + c0 + cg * 4;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c0 + cg * 4 + j < N) c[j] = acc[i][j];
        }
      }
    }
  }
  __syncthreads();
}

// C[r * ldc + c] = sum_k A[r * lda + k] * w(k, c) for r < R, c < N, where
// w(k, c) = W[k * N + c] (W [K, N] row-major) or, with kTrans, W[c * K + k]
// (the product with the transpose of W [N, K]).  A and C lie in shared
// memory and must not overlap; R is a multiple of 4 (TE or 3 TE rows).  W
// lies in global memory and streams through ws (S kStage floats) in K-tiles
// of kTileK rows, S - 1 of them in flight (cp.async) while one's products
// run.  Columns go in passes of at most
// kMaxN; in a pass a thread owns TR consecutive rows and 4 consecutive
// columns of C (TR x 4 sums in registers), reading per k one float4 of the
// staged weights and TR activations; a warp's lanes span up to 4 row
// blocks and 8 column groups, and every activation row stride is odd, so a
// warp's reads at one k hit distinct banks.  TR in {1, 2, 4} is the one
// that needs the fewest sweeps of
// the threads over the outputs, then keeps the most threads busy, then
// reads the fewest staged weights.  Every sum runs over k in order.  Ends
// with __syncthreads; A must be complete when it is called.
template <bool kTrans, int S>
__device__ void mm(const float* A, int lda, int R, int K,
                   const float* __restrict__ W, int N, float* ws, float* C,
                   int ldc) {
  const int ncg = (min(kMaxN, N) + 3) >> 2;
  int tr = 1;
  for (int cand = 2; cand <= 4; cand *= 2) {
    if (R % cand) break;
    const int n_c = (R / cand) * ncg, n_t = (R / tr) * ncg;
    const int p_c = (n_c + kThreads - 1) / kThreads,
              p_t = (n_t + kThreads - 1) / kThreads;
    if (p_c < p_t || (p_c == p_t && min(n_c, kThreads) >= min(n_t, kThreads)))
      tr = cand;
  }
  if (tr == 4) mm_tr<kTrans, 4, S>(A, lda, R, K, W, N, ws, C, ldc);
  else if (tr == 2) mm_tr<kTrans, 2, S>(A, lda, R, K, W, N, ws, C, ldc);
  else mm_tr<kTrans, 1, S>(A, lda, R, K, W, N, ws, C, ldc);
}

// Gather the chain input of the tile starting at edge e0:
// X[r, :si0] = [s[j], es[e], s[i]] and V[p * TE + r, :vi0] =
// [v_p[j], ev_p[e], v_p[i]] for e = e0 + r, j = send[e], i = recv[e]; rows
// of masked-off edges and of edges past E are zero.  live[r] gets the mask.
template <int TE, typename Idx>
__device__ void gather_tile(const Dims& d, const Idx* __restrict__ send,
                            const Idx* __restrict__ recv,
                            const uint8_t* __restrict__ emask,
                            const float* __restrict__ s, const float* const* vp,
                            const float* __restrict__ es, const float* const* evp,
                            long long e0, int E, float* X, int ldx, float* V,
                            int ldv, bool* live) {
  if (threadIdx.x < TE) {
    const long long e = e0 + threadIdx.x;
    live[threadIdx.x] = e < E && emask[e] != 0;
  }
  __syncthreads();
  const int S = d.S, SE = d.SE, Vn = d.V, VE = d.VE;
  const int si0 = 2 * S + SE, vi0 = 2 * Vn + VE;
  for (int i = threadIdx.x; i < TE * si0; i += kThreads) {
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
  for (int i = threadIdx.x; i < 3 * TE * vi0; i += kThreads) {
    const int row = i / vi0, c = i - row * vi0;
    const int p = row / TE, r = row - p * TE;
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

// GVP k of the chain on the tile: reads X[:, :si] and V (3 TE rows of vi);
// writes VH, vn into X[:, si : si + h], GI (sigmoid(z), or z on the last
// GVP), VO and G, then Xn[:, :so] = relu(z) (not on the last GVP) and, when
// Vn is given, Vn = VO * G.  Xn and Vn may be X and V.
template <int TE, int S>
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

  mm<false, S>(V, ldv, 3 * TE, vi, Wh, h, ws, VH, ldvh);
  for (int i = threadIdx.x; i < TE * h; i += kThreads) {
    const int r = i / h, c = i - r * h;
    const float a = VH[r * ldvh + c], b = VH[(TE + r) * ldvh + c],
                e = VH[(2 * TE + r) * ldvh + c];
    X[r * ldx + si + c] = sqrtf(fmaxf(a * a + b * b + e * e, kNormEps));
  }
  mm<false, S>(X, ldx, TE, si + h, Ws, so, ws, GI, ldgi);
  mm<false, S>(VH, ldvh, 3 * TE, h, Wv, vo, ws, VO, ldvo);
  for (int i = threadIdx.x; i < TE * so; i += kThreads) {
    const int r = i / so, c = i - r * so;
    const float z = GI[r * ldgi + c] + bs[c];
    if (last) {
      GI[r * ldgi + c] = z;
    } else {
      Xn[r * ldxn + c] = fmaxf(z, 0.f);
      GI[r * ldgi + c] = sigmoid(z);
    }
  }
  mm<false, S>(GI, ldgi, TE, so, Wsv, vo, ws, G, ldg);
  for (int i = threadIdx.x; i < TE * vo; i += kThreads) {
    const int r = i / vo, c = i - r * vo;
    G[r * ldg + c] = sigmoid(G[r * ldg + c] + bsv[c]);
  }
  __syncthreads();
  if (Vn != nullptr) {
    for (int i = threadIdx.x; i < 3 * TE * vo; i += kThreads) {
      const int row = i / vo, c = i - row * vo;
      Vn[row * ldvn + c] = VO[row * ldvo + c] * G[(row % TE) * ldg + c];
    }
  }
  __syncthreads();
}

}  // namespace gvp
