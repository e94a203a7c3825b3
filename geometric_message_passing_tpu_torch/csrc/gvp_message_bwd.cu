// Backward of the GVP-GNN fused message pass for Hopper (sm_90a), exact f32
// on CUDA cores.
//
// Replaces geometric_message_passing_tpu/ops/pallas_gvp.py::_gvp_bwd_kernel,
// the TPU kernel that recomputes an edge block's forward, backpropagates
// through the GVP chain and the gathers, and accumulates the node
// cotangents ds [N, S], dvx/dvy/dvz [N, V] and every weight's gradient,
// while writing the edge-feature cotangents des [E, SE], devx/devy/devz
// [E, VE] per edge.  Same function, same masking (masked-off edges get a zero
// cotangent), the count's cotangent is ignored.  Not the TPU algorithm: the
// one-hot [block, N] products become indexed loads and sorted (CSR) sums, the
// vjp traced inside the TPU kernel is written out by hand, and the sums that
// the TPU's sequential grid carried from block to block become kernels that
// add in a fixed order, with no atomics, so two runs are bitwise equal.
//
// What bounds it: arithmetic.  Per live edge the recomputed forward costs the
// forward's products (about 1.8e5 FLOPs at full width) and the backward twice
// that (the input cotangents dz W^T and the weight gradients x^T dz), about
// 5.5e5 FLOPs, in exact f32 on the CUDA cores.  The per-edge scratch that
// carries the weight-gradient operands from kernel 1 to kernel 3 (2154 floats
// per edge at full width) costs far fewer byte-seconds than that.
//
// Kernels (launched in this order by gmp_gvp_bwd):
//  1. gvp_bwd_edge_kernel: a block takes a tile of TE edges (8 or 16,
//     ops/gvp_message.py::gvp_tile; the products as in gvp_message.cu:
//     register blocked, weights double buffered through cp.async),
//     recomputes the chain keeping every GVP's activations in shared memory,
//     then walks the GVPs backwards: the gate (two sigmoids), the ReLU, the
//     clipped norm (no gradient where |vh|^2 <= 1e-8), the three products
//     and the concatenation.  Products with a transposed weight stage slices
//     of it the other way round.  It writes per edge: the left and right
//     operands of every weight gradient into one `ops` row (per GVP: x, dz,
//     V, dvh, vh, dvo, gi, da), the cotangents of the sender's and the
//     receiver's [s | vx | vy | vz] (dnj, dni [E, S + 3V]) and the edge
//     cotangents.  Masked-off edges write zeros.
//  2. gvp_bwd_node_kernel: one warp per node sums its receiver-CSR row of
//     dni, then its sender-CSR row of dnj, in ascending edge order.
//  3. gvp_bwd_wgrad_kernel: every weight gradient as a sum over edges of
//     left^T right (the vector ones also over the 3 planes; a bias's left
//     operand is 1), over one slice of `split` edges per blockIdx.z; a
//     block owns a 64 x 64 output tile (4 x 4 per thread) and walks its
//     slice in order, its stages double buffered.
//  4. gvp_bwd_wsum_kernel: dW = the sum of the slices' partial dW in slice
//     order.  Slicing keeps every sequential sum short and gives the weight
//     gradient enough blocks to fill the card.

#include "gvp_common.cuh"

namespace {

using gvp::Dims;
using gvp::kMaxLayers;
using gvp::kThreads;

// Floats of one GVP's part of an `ops` row, and its pieces' offsets.
struct OpsLayer {
  int x, dz, v, dvh, vh, dvo, gi, da, width;
};

__host__ __device__ inline OpsLayer ops_layer(const Dims& d, int k) {
  const int si = d.si[k], vi = d.vi[k], h = d.h[k], so = d.so[k], vo = d.vo[k];
  OpsLayer o;
  o.x = 0;
  o.dz = o.x + si + h;
  o.v = o.dz + so;
  o.dvh = o.v + 3 * vi;
  o.vh = o.dvh + 3 * h;
  o.dvo = o.vh + 3 * h;
  o.gi = o.dvo + 3 * vo;
  o.da = o.gi + so;
  o.width = o.da + vo;
  return o;
}

__host__ __device__ inline int ops_offset(const Dims& d, int k) {
  int off = 0;
  for (int j = 0; j < k; ++j) off += ops_layer(d, j).width;
  return off;
}

// Shared memory of the edge kernel, in floats: per GVP its stored
// activations X (TE x (si+h)), V (3 TE x vi), VH (3 TE x h),
// GI (TE x so), VO (3 TE x vo), G (TE x vo); then the working
// cotangents and the weight tile.
struct BwdLayout {
  size_t x[kMaxLayers], v[kMaxLayers], vh[kMaxLayers], gi[kMaxLayers],
      vo[kMaxLayers], g[kMaxLayers];
  int ldx[kMaxLayers];   // X's row stride: si + h, made odd
  int ld_ds, ld_dv, mso, mvo, mh, mvi, mx;
  size_t ds, dv, da, dgi, dz, dx, dvo, dvh, dvin, ws, total;
};

__host__ __device__ inline BwdLayout bwd_layout(const Dims& d, int TE) {
  BwdLayout l;
  size_t off = 0;
  l.mx = 0;
  for (int k = 0; k < d.L; ++k) {
    const int si = d.si[k], vi = d.vi[k], h = d.h[k], so = d.so[k], vo = d.vo[k];
    l.ldx[k] = (si + h) | 1;
    l.x[k] = off; off += (size_t)TE * l.ldx[k];
    l.v[k] = off; off += (size_t)3 * TE * vi;
    l.vh[k] = off; off += (size_t)3 * TE * h;
    l.gi[k] = off; off += (size_t)TE * so;
    l.vo[k] = off; off += (size_t)3 * TE * vo;
    l.g[k] = off; off += (size_t)TE * vo;
    l.mx = si + h > l.mx ? si + h : l.mx;
  }
  l.mso = gvp::max_of(d.so, d.L);
  l.mvo = gvp::max_of(d.vo, d.L);
  l.mh = gvp::max_of(d.h, d.L);
  l.mvi = gvp::max_of(d.vi, d.L);
  const int msi = gvp::max_of(d.si, d.L);
  l.ld_ds = msi > l.mso ? msi : l.mso;
  l.ld_dv = l.mvi > l.mvo ? l.mvi : l.mvo;
  // odd row strides: the rows a warp reads at one k fall in distinct banks
  l.ld_ds |= 1; l.ld_dv |= 1; l.mso |= 1; l.mvo |= 1; l.mh |= 1; l.mvi |= 1;
  l.mx |= 1;
  l.ds = off; off += (size_t)TE * l.ld_ds;
  l.dv = off; off += (size_t)3 * TE * l.ld_dv;
  l.da = off; off += (size_t)TE * l.mvo;
  l.dgi = off; off += (size_t)TE * l.mso;
  l.dz = off; off += (size_t)TE * l.mso;
  l.dx = off; off += (size_t)TE * l.mx;
  l.dvo = off; off += (size_t)3 * TE * l.mvo;
  l.dvh = off; off += (size_t)3 * TE * l.mh;
  l.dvin = off; off += (size_t)3 * TE * l.mvi;
  off = (off + 3) & ~(size_t)3;   // float4 reads of the staged weights
  l.ws = off; off += (size_t)gvp::bwd_stages(TE) * gvp::kStage;
  l.total = off;
  return l;
}

// rows x cols of a tile buffer (row stride ld) into a per-edge buffer: row r
// of the tile goes to out[(e0 + r) * ldo + c]; zeros for masked-off edges,
// nothing for edges past E.
template <int TE>
__device__ void store_rows(const float* src, int ld, int cols, float* out,
                           size_t ldo, long long e0, int E, const bool* live) {
  for (int i = threadIdx.x; i < TE * cols; i += kThreads) {
    const int r = i / cols, c = i - r * cols;
    if (e0 + r < E) out[(size_t)(e0 + r) * ldo + c] = live[r] ? src[r * ld + c] : 0.f;
  }
}

// 3 TE plane rows (row p * TE + r, row stride ld) into a per-edge row
// as [plane 0 | plane 1 | plane 2], cols each.
template <int TE>
__device__ void store_planes(const float* src, int ld, int cols, float* out,
                             size_t ldo, long long e0, int E, const bool* live) {
  for (int i = threadIdx.x; i < 3 * TE * cols; i += kThreads) {
    const int row = i / cols, c = i - row * cols;
    const int p = row / TE, r = row - p * TE;
    if (e0 + r < E)
      out[(size_t)(e0 + r) * ldo + p * cols + c] = live[r] ? src[row * ld + c] : 0.f;
  }
}

template <int TE, typename Idx>
__global__ void __launch_bounds__(kThreads, 2) gvp_bwd_edge_kernel(
    Dims d, const Idx* __restrict__ send, const Idx* __restrict__ recv,
    const uint8_t* __restrict__ emask, const float* __restrict__ s,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ vz, const float* __restrict__ es,
    const float* __restrict__ evx, const float* __restrict__ evy,
    const float* __restrict__ evz, const float* __restrict__ W,
    const float* __restrict__ gs, const float* __restrict__ gvx,
    const float* __restrict__ gvy, const float* __restrict__ gvz,
    float* __restrict__ ops, float* __restrict__ dnj, float* __restrict__ dni,
    float* __restrict__ des, float* __restrict__ devx,
    float* __restrict__ devy, float* __restrict__ devz, int E) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool live[TE];
  const BwdLayout l = bwd_layout(d, TE);
  const int L = d.L;
  constexpr int kS = gvp::bwd_stages(TE);   // K-tiles in flight
  const long long e0 = (long long)blockIdx.x * TE;
  float* ws = smem + l.ws;
  const float* vp[3] = {vx, vy, vz};
  const float* evp[3] = {evx, evy, evz};

  // ---- forward recompute, every GVP's activations kept ----
  gvp::gather_tile<TE>(d, send, recv, emask, s, vp, es, evp, e0, E, smem + l.x[0],
                   l.ldx[0], smem + l.v[0], d.vi[0], live);
  for (int k = 0; k < L; ++k) {
    const bool last = k == L - 1;
    gvp::layer_forward<TE, kS>(
        d, k, W + gvp::weight_offset(d, k), smem + l.x[k], l.ldx[k],
        smem + l.v[k], d.vi[k], smem + l.vh[k], d.h[k], smem + l.gi[k],
        d.so[k], smem + l.vo[k], d.vo[k], smem + l.g[k], d.vo[k],
        last ? nullptr : smem + l.x[k + 1],
        last ? 0 : l.ldx[k + 1],
        last ? nullptr : smem + l.v[k + 1], last ? 0 : d.vi[k + 1], ws);
  }

  // ---- cotangents at the chain's output: gs[recv], gv[recv] (0 if masked) ----
  float* dS = smem + l.ds;
  float* dV = smem + l.dv;
  {
    const int so = d.so[L - 1], vo = d.vo[L - 1];
    for (int i = threadIdx.x; i < TE * so; i += kThreads) {
      const int r = i / so, c = i - r * so;
      dS[r * l.ld_ds + c] = live[r] ? gs[(size_t)recv[e0 + r] * so + c] : 0.f;
    }
    const float* gvp_[3] = {gvx, gvy, gvz};
    for (int i = threadIdx.x; i < 3 * TE * vo; i += kThreads) {
      const int row = i / vo, c = i - row * vo;
      const int p = row / TE, r = row - p * TE;
      dV[row * l.ld_dv + c] =
          live[r] ? gvp_[p][(size_t)recv[e0 + r] * vo + c] : 0.f;
    }
  }
  __syncthreads();

  float* DA = smem + l.da;
  float* dGI = smem + l.dgi;
  float* DZ = smem + l.dz;
  float* dX = smem + l.dx;
  float* dVO = smem + l.dvo;
  float* dVH = smem + l.dvh;
  float* dVin = smem + l.dvin;
  const int ld_ops = ops_offset(d, L);

  for (int k = L - 1; k >= 0; --k) {
    const int si = d.si[k], vi = d.vi[k], h = d.h[k], so = d.so[k], vo = d.vo[k];
    const bool last = k == L - 1;
    const float* Wk = W + gvp::weight_offset(d, k);
    const float* Wh = Wk;
    const float* Wv = Wh + (size_t)vi * h;
    const float* Ws = Wv + (size_t)h * vo;
    const float* Wsv = Ws + (size_t)(si + h) * so + so;
    const float* X = smem + l.x[k];
    const float* Vk = smem + l.v[k];
    const float* VH = smem + l.vh[k];
    const float* GI = smem + l.gi[k];
    const float* VO = smem + l.vo[k];
    const float* G = smem + l.g[k];
    const int ldx = l.ldx[k];

    // V' = VO * G: dVO = dV' * G; da = (sum over planes of dV' * VO) * G(1-G)
    for (int i = threadIdx.x; i < TE * vo; i += kThreads) {
      const int r = i / vo, c = i - r * vo;
      const float g = G[r * vo + c];
      float dg = 0.f;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int row = p * TE + r;
        const float dv = dV[row * l.ld_dv + c];
        dVO[row * l.mvo + c] = dv * g;
        dg = fmaf(dv, VO[row * vo + c], dg);
      }
      DA[r * l.mvo + c] = dg * g * (1.f - g);
    }
    // dgi = da Wsv^T
    gvp::mm<true, kS>(DA, l.mvo, TE, vo, Wsv, so, ws, dGI, l.mso);
    // dz: through the ReLU (mask z > 0, read as relu(z) > 0 in the next
    // GVP's input) and the gate's sigmoid; the last GVP is linear
    const float* Xn = last ? nullptr : smem + l.x[k + 1];
    const int ldxn = last ? 0 : l.ldx[k + 1];
    for (int i = threadIdx.x; i < TE * so; i += kThreads) {
      const int r = i / so, c = i - r * so;
      const float dsv = dS[r * l.ld_ds + c], dgi = dGI[r * l.mso + c];
      float dz;
      if (last) {
        dz = dsv + dgi;
      } else {
        const float gi = GI[r * so + c];
        dz = (Xn[r * ldxn + c] > 0.f ? dsv : 0.f) + dgi * gi * (1.f - gi);
      }
      DZ[r * l.mso + c] = dz;
    }
    // d[s, vn] = dz Ws^T
    gvp::mm<true, kS>(DZ, l.mso, TE, so, Ws, si + h, ws, dX, l.mx);
    // dvh = dvo Wv^T + dvn * vh / vn where |vh|^2 > 1e-8
    gvp::mm<true, kS>(dVO, l.mvo, 3 * TE, vo, Wv, h, ws, dVH, l.mh);
    for (int i = threadIdx.x; i < 3 * TE * h; i += kThreads) {
      const int row = i / h, c = i - row * h;
      const int r = row % TE;
      const float a = VH[r * h + c], b = VH[(TE + r) * h + c],
                  e = VH[(2 * TE + r) * h + c];
      if (a * a + b * b + e * e > gvp::kNormEps)
        dVH[row * l.mh + c] += dX[r * l.mx + si + c] * VH[row * h + c] /
                               X[r * ldx + si + c];
    }
    // dV = dvh Wh^T
    gvp::mm<true, kS>(dVH, l.mh, 3 * TE, h, Wh, vi, ws, dVin, l.mvi);

    // this GVP's weight-gradient operands
    const OpsLayer o = ops_layer(d, k);
    float* orow = ops + ops_offset(d, k);
    store_rows<TE>(X, ldx, si + h, orow + o.x, ld_ops, e0, E, live);
    store_rows<TE>(DZ, l.mso, so, orow + o.dz, ld_ops, e0, E, live);
    store_planes<TE>(Vk, vi, vi, orow + o.v, ld_ops, e0, E, live);
    store_planes<TE>(dVH, l.mh, h, orow + o.dvh, ld_ops, e0, E, live);
    store_planes<TE>(VH, h, h, orow + o.vh, ld_ops, e0, E, live);
    store_planes<TE>(dVO, l.mvo, vo, orow + o.dvo, ld_ops, e0, E, live);
    store_rows<TE>(GI, so, so, orow + o.gi, ld_ops, e0, E, live);
    store_rows<TE>(DA, l.mvo, vo, orow + o.da, ld_ops, e0, E, live);

    // the input's cotangents become the previous GVP's output cotangents
    for (int i = threadIdx.x; i < TE * si; i += kThreads) {
      const int r = i / si, c = i - r * si;
      dS[r * l.ld_ds + c] = dX[r * l.mx + c];
    }
    for (int i = threadIdx.x; i < 3 * TE * vi; i += kThreads) {
      const int row = i / vi, c = i - row * vi;
      dV[row * l.ld_dv + c] = dVin[row * l.mvi + c];
    }
    __syncthreads();
  }

  // ---- the chain input [s_j, es, s_i], [v_j, ev, v_i]: node and edge parts ----
  const int S = d.S, Vn = d.V, SE = d.SE, VE = d.VE, wn = S + 3 * Vn;
  for (int i = threadIdx.x; i < TE * wn; i += kThreads) {
    const int r = i / wn, c = i - r * wn;
    const long long e = e0 + r;
    if (e >= E) continue;
    float vj = 0.f, vi_ = 0.f;
    if (live[r]) {
      if (c < S) {
        vj = dS[r * l.ld_ds + c];
        vi_ = dS[r * l.ld_ds + S + SE + c];
      } else {
        const int p = (c - S) / Vn, j = c - S - p * Vn;
        const float* row = dV + (p * TE + r) * l.ld_dv;
        vj = row[j];
        vi_ = row[Vn + VE + j];
      }
    }
    dnj[(size_t)e * wn + c] = vj;
    dni[(size_t)e * wn + c] = vi_;
  }
  for (int i = threadIdx.x; i < TE * SE; i += kThreads) {
    const int r = i / SE, c = i - r * SE;
    if (e0 + r < E)
      des[(size_t)(e0 + r) * SE + c] = live[r] ? dS[r * l.ld_ds + S + c] : 0.f;
  }
  float* devp[3] = {devx, devy, devz};
  for (int i = threadIdx.x; i < 3 * TE * VE; i += kThreads) {
    const int row = i / VE, c = i - row * VE;
    const int p = row / TE, r = row - p * TE;
    if (e0 + r < E)
      devp[p][(size_t)(e0 + r) * VE + c] =
          live[r] ? dV[row * l.ld_dv + Vn + c] : 0.f;
  }
}

constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 8;   // columns per lane: S + 3V <= 256

// One warp per node: d[s | vx | vy | vz] = the sum of dni over its receiver
// row, then of dnj over its sender row, in ascending edge order.
__global__ void __launch_bounds__(kThreads) gvp_bwd_node_kernel(
    const int64_t* __restrict__ order_r, const int64_t* __restrict__ rowptr_r,
    const int64_t* __restrict__ order_s, const int64_t* __restrict__ rowptr_s,
    const float* __restrict__ dni, const float* __restrict__ dnj, int S, int V,
    float* __restrict__ ds, float* __restrict__ dvx, float* __restrict__ dvy,
    float* __restrict__ dvz, int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long node = (long long)blockIdx.x * kWarps + warp;
  if (node >= N) return;
  const int wn = S + 3 * V;
  float acc[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) acc[c] = 0.f;
  for (int64_t k = rowptr_r[node]; k < rowptr_r[node + 1]; ++k) {
    const float* g = dni + (size_t)order_r[k] * wn;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < wn) acc[c] += g[col];
    }
  }
  for (int64_t k = rowptr_s[node]; k < rowptr_s[node + 1]; ++k) {
    const float* g = dnj + (size_t)order_s[k] * wn;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < wn) acc[c] += g[col];
    }
  }
  float* planes[3] = {dvx, dvy, dvz};
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int col = lane + 32 * c;
    if (col < S) {
      ds[(size_t)node * S + col] = acc[c];
    } else if (col < wn) {
      const int p = (col - S) / V;
      planes[p][(size_t)node * V + col - S - p * V] = acc[c];
    }
  }
}

// One weight gradient: out[k][c] = sum over edges (and planes) of
// ops[e][lcol + p K + k] * ops[e][rcol + p N + c]; lcol < 0 reads the left
// operand as 1 (a bias, K = 1).  tile0: its first block in blockIdx.x.
struct Prod {
  int lcol, K, rcol, N, planes, out_off, tile0;
};

struct Prods {
  int n, ld, size;   // products, ops row length, floats of dW
  Prod p[6 * kMaxLayers + 1];   // p[n].tile0: the number of tiles
};

constexpr int kWT = 64;   // dW tile: rows and columns
constexpr int kWE = 32;   // edges per stage
constexpr int kWLoads = kWE * kWT / kThreads;   // values per thread per stage

// A block owns a 64 x 64 tile of one weight gradient over one slice of
// edges; thread (ty, tx) = (t / 16, t % 16) sums the 4 x 4 outputs at rows
// 4 ty.. and columns 4 tx.. in registers, reading a float4 of each operand
// per edge.  The stages (32 edges of one plane) are double buffered in
// shared memory: the next stage's values are loaded into registers while
// this one's products run, so each stage costs one __syncthreads.  Every
// output sums over the slice's edges in order, the planes of an edge in
// order.
__global__ void __launch_bounds__(kThreads) gvp_bwd_wgrad_kernel(
    Prods P, const float* __restrict__ ops, float* __restrict__ part, int E,
    int split) {
  __shared__ __align__(16) float ls[2][kWE][kWT];
  __shared__ __align__(16) float rs[2][kWE][kWT];
  int idx = 0;
  while (idx + 1 < P.n && P.p[idx + 1].tile0 <= (int)blockIdx.x) ++idx;
  const Prod pr = P.p[idx];
  const int local = blockIdx.x - pr.tile0;
  const int tn = (pr.N + kWT - 1) / kWT;
  const int k0 = (local / tn) * kWT, c0 = (local % tn) * kWT;
  const long long e_beg = (long long)blockIdx.z * split;
  const long long e_end = min((long long)E, e_beg + split);
  const int stages =
      (int)((e_end - e_beg + kWE - 1) / kWE) * pr.planes;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float lv[kWLoads], rv[kWLoads];
  auto load = [&](int st) {
    const long long base = e_beg + (long long)(st / pr.planes) * kWE;
    const int p = st % pr.planes;
#pragma unroll
    for (int q = 0; q < kWLoads; ++q) {
      const int i = threadIdx.x + q * kThreads;
      const int ee = i / kWT, kk = i % kWT;
      const long long e = base + ee;
      const bool ok = e < e_end;
      const float* row = ops + (size_t)(ok ? e : e_beg) * P.ld;
      lv[q] = (ok && k0 + kk < pr.K)
                  ? (pr.lcol < 0 ? 1.f : row[pr.lcol + p * pr.K + k0 + kk])
                  : 0.f;
      rv[q] = (ok && c0 + kk < pr.N) ? row[pr.rcol + p * pr.N + c0 + kk] : 0.f;
    }
  };
  auto store = [&](int b) {
#pragma unroll
    for (int q = 0; q < kWLoads; ++q) {
      const int i = threadIdx.x + q * kThreads;
      ls[b][i / kWT][i % kWT] = lv[q];
      rs[b][i / kWT][i % kWT] = rv[q];
    }
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if (stages > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int st = 0; st < stages; ++st) {
    const int b = st & 1;
    if (st + 1 < stages) load(st + 1);
#pragma unroll 8
    for (int ee = 0; ee < kWE; ++ee) {
      const float4 l4 = *reinterpret_cast<const float4*>(&ls[b][ee][ty * 4]);
      const float4 r4 = *reinterpret_cast<const float4*>(&rs[b][ee][tx * 4]);
      const float l[4] = {l4.x, l4.y, l4.z, l4.w};
      const float r[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(l[i], r[j], acc[i][j]);
    }
    if (st + 1 < stages) store(b ^ 1);
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * P.size + pr.out_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (k < pr.K && c < pr.N) out[(size_t)k * pr.N + c] = acc[i][j];
    }
  }
}

// dW = the sum over the slices' partial dW, in slice order.
__global__ void __launch_bounds__(kThreads) gvp_bwd_wsum_kernel(
    const float* __restrict__ part, float* __restrict__ dw, int slices,
    int size) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= size) return;
  float t = 0.f;
  for (int z = 0; z < slices; ++z) t += part[(size_t)z * size + i];
  dw[i] = t;
}

Prods make_prods(const Dims& d) {
  Prods P;
  P.n = 0;
  P.ld = ops_offset(d, d.L);
  int tiles = 0;
  long long woff = 0;
  auto add = [&](int lcol, int K, int rcol, int N, int planes) {
    Prod& pr = P.p[P.n++];
    pr.lcol = lcol; pr.K = K; pr.rcol = rcol; pr.N = N; pr.planes = planes;
    pr.out_off = (int)woff; pr.tile0 = tiles;
    tiles += ((K + kWT - 1) / kWT) * ((N + kWT - 1) / kWT);
    woff += (long long)K * N;
  };
  for (int k = 0; k < d.L; ++k) {
    const int si = d.si[k], vi = d.vi[k], h = d.h[k], so = d.so[k], vo = d.vo[k];
    const int base = ops_offset(d, k);
    const OpsLayer o = ops_layer(d, k);
    add(base + o.v, vi, base + o.dvh, h, 3);       // Wh
    add(base + o.vh, h, base + o.dvo, vo, 3);      // Wv
    add(base + o.x, si + h, base + o.dz, so, 1);   // Ws
    add(-1, 1, base + o.dz, so, 1);                // bs
    add(base + o.gi, so, base + o.da, vo, 1);      // Wsv
    add(-1, 1, base + o.da, vo, 1);                // bsv
  }
  P.size = (int)woff;
  // a sentinel past the last product's tiles
  P.p[P.n].tile0 = tiles;
  return P;
}

int total_tiles(const Prods& P) { return P.p[P.n].tile0; }

template <int TE, typename Idx>
int launch_edges(const Dims& d, const void* send, const void* recv,
                 const void* emask, const void* s, const void* vx,
                 const void* vy, const void* vz, const void* es,
                 const void* evx, const void* evy, const void* evz,
                 const void* w, const void* gs, const void* gvx,
                 const void* gvy, const void* gvz, void* ops, void* dnj,
                 void* dni, void* des, void* devx, void* devy, void* devz,
                 int E, cudaStream_t stream) {
  const size_t smem = bwd_layout(d, TE).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gvp_bwd_edge_kernel<TE, Idx>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (E + TE - 1) / TE;
  gvp_bwd_edge_kernel<TE, Idx><<<blocks, kThreads, smem, stream>>>(
      d, static_cast<const Idx*>(send), static_cast<const Idx*>(recv),
      static_cast<const uint8_t*>(emask), static_cast<const float*>(s),
      static_cast<const float*>(vx), static_cast<const float*>(vy),
      static_cast<const float*>(vz), static_cast<const float*>(es),
      static_cast<const float*>(evx), static_cast<const float*>(evy),
      static_cast<const float*>(evz), static_cast<const float*>(w),
      static_cast<const float*>(gs), static_cast<const float*>(gvx),
      static_cast<const float*>(gvy), static_cast<const float*>(gvz),
      static_cast<float*>(ops), static_cast<float*>(dnj),
      static_cast<float*>(dni), static_cast<float*>(des),
      static_cast<float*>(devx), static_cast<float*>(devy),
      static_cast<float*>(devz), E);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the first cudaError_t of
// the launches (0 = success).  Shapes, types and width limits are checked,
// the CSRs built and the scratch allocated by the Python wrapper
// (ops/gvp_message.py): dims holds (si, vi, h, so, vo) of each GVP; ops
// [E, gmp_gvp_ops_width], dnj and dni [E, S + 3V], part [max(1,
// ceil(E / split)), size of dW], dw the flat weight gradient in the weights'
// order; split is a positive multiple of 32; tile the edge tile (8, 16 or
// 32; ops/gvp_message.py::gvp_tile).

extern "C" const char* gmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

static int read_dims(const void* dims, int L, int S, int V, int SE, int VE,
                     Dims* d) {
  if (L < 1 || L > kMaxLayers) return 1;
  d->L = L; d->S = S; d->V = V; d->SE = SE; d->VE = VE;
  const int* dm = static_cast<const int*>(dims);
  for (int k = 0; k < L; ++k) {
    d->si[k] = dm[5 * k]; d->vi[k] = dm[5 * k + 1]; d->h[k] = dm[5 * k + 2];
    d->so[k] = dm[5 * k + 3]; d->vo[k] = dm[5 * k + 4];
  }
  return 0;
}

extern "C" int gmp_gvp_ops_width(const void* dims, int L) {
  Dims d;
  if (read_dims(dims, L, 0, 0, 0, 0, &d)) return -1;
  return ops_offset(d, L);
}

// Bytes of dynamic shared memory the backward edge kernel needs at this
// tile (host only; -1 for bad dims).
extern "C" int gmp_gvp_bwd_smem(const void* dims, int L, int tile) {
  Dims d;
  if (read_dims(dims, L, 0, 0, 0, 0, &d)) return -1;
  return (int)(bwd_layout(d, tile).total * sizeof(float));
}

template <typename Idx>
static int launch_tile(int tile, const Dims& d, const void* send,
                       const void* recv, const void* emask, const void* s,
                       const void* vx, const void* vy, const void* vz,
                       const void* es, const void* evx, const void* evy,
                       const void* evz, const void* w, const void* gs,
                       const void* gvx, const void* gvy, const void* gvz,
                       void* ops, void* dnj, void* dni, void* des, void* devx,
                       void* devy, void* devz, int E, cudaStream_t st) {
#define GMP_TILE(T_)                                                        \
  case T_:                                                                  \
    return launch_edges<T_, Idx>(d, send, recv, emask, s, vx, vy, vz, es,   \
                                 evx, evy, evz, w, gs, gvx, gvy, gvz, ops,  \
                                 dnj, dni, des, devx, devy, devz, E, st);
  switch (tile) {
    GMP_TILE(8) GMP_TILE(16) GMP_TILE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef GMP_TILE
}

extern "C" int gmp_gvp_bwd(
    int device, const void* send, const void* recv, int idx64,
    const void* emask, const void* s, const void* vx, const void* vy,
    const void* vz, const void* es, const void* evx, const void* evy,
    const void* evz, const void* w, const void* dims, int L, int S, int V,
    int SE, int VE, int E, int N, const void* gs, const void* gvx,
    const void* gvy, const void* gvz, const void* order_r,
    const void* rowptr_r, const void* order_s, const void* rowptr_s,
    void* ops, void* dnj, void* dni, void* part, void* ds, void* dvx,
    void* dvy, void* dvz, void* des, void* devx, void* devy, void* devz,
    void* dw, int split, int tile, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Dims d;
  if (read_dims(dims, L, S, V, SE, VE, &d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = 0;
  if (E > 0) {
    rc = idx64 ? launch_tile<long long>(tile, d, send, recv, emask, s, vx, vy,
                                        vz, es, evx, evy, evz, w, gs, gvx, gvy,
                                        gvz, ops, dnj, dni, des, devx, devy,
                                        devz, E, st)
               : launch_tile<int>(tile, d, send, recv, emask, s, vx, vy, vz,
                                  es, evx, evy, evz, w, gs, gvx, gvy, gvz, ops,
                                  dnj, dni, des, devx, devy, devz, E, st);
    if (rc) return rc;
  }
  if (N > 0) {
    gvp_bwd_node_kernel<<<(N + kWarps - 1) / kWarps, kThreads, 0, st>>>(
        static_cast<const int64_t*>(order_r), static_cast<const int64_t*>(rowptr_r),
        static_cast<const int64_t*>(order_s), static_cast<const int64_t*>(rowptr_s),
        static_cast<const float*>(dni), static_cast<const float*>(dnj), S, V,
        static_cast<float*>(ds), static_cast<float*>(dvx),
        static_cast<float*>(dvy), static_cast<float*>(dvz), N);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  const Prods P = make_prods(d);
  const int slices = E > 0 ? (E + split - 1) / split : 1;
  gvp_bwd_wgrad_kernel<<<dim3(total_tiles(P), 1, slices), kThreads, 0, st>>>(
      P, static_cast<const float*>(ops), static_cast<float*>(part), E, split);
  if ((rc = (int)cudaGetLastError())) return rc;
  gvp_bwd_wsum_kernel<<<(P.size + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), slices, P.size);
  return (int)cudaGetLastError();
}
