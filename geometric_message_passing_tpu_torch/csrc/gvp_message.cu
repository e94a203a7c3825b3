// GVP-GNN fused message pass for Hopper (sm_90a), exact f32 on CUDA cores.
//
// Replaces geometric_message_passing_tpu/ops/pallas_gvp.py::_gvp_fwd_kernel,
// the TPU kernel that gathers [s | vx | vy | vz] at both endpoints of every
// edge, concatenates (s_j, V_j), the edge features and (s_i, V_i) (j the
// sender, i the receiver), runs the GVP chain and sums the results and the
// edge count over receivers (masked-off edges excluded).  Same function, same
// weights (per GVP: Wh, Wv, Ws, bs, Wsv, bsv, flattened in that order, GVP
// after GVP); not the TPU algorithm: the one-hot [block, N] products that
// gather and scatter on the TPU's matrix unit become indexed loads and a
// sorted (CSR) segment sum, so N is not limited.  The chain's math is in
// gvp_common.cuh.
//
// What bounds it: arithmetic.  A live edge costs 2 * sum over the GVPs of
// (3 vi h + (si + h) so + 3 h vo + so vo) FLOPs of products, about 1.8e5 at
// full width (so 128, vo 16, edge 32/1: 9.6e4 for the first GVP, 4.4e4 for
// each of the other two), against some 2.3 KB of gathered rows and 0.7 KB
// written, far above the card's f32 balance point; the products run in exact
// f32 on the CUDA cores, so the ceiling is the f32 FMA rate.
//
// What the design does about it: a block of 256 threads takes a tile of TE
// edges and keeps every activation of the chain in shared memory; the
// weights stream through shared memory in 16-row K-tiles, double buffered
// with cp.async so the next K-tile's copy overlaps this one's products, and
// each product is register blocked (gvp_common.cuh::mm: a thread owns up to
// 4 rows x 4 columns of the output and reads one float4 of weights and the
// rows' activations per k).  Layer 0's Ws alone is 321 x 128 floats
// (164 KB), so it cannot stay resident beside the tiles.  TE (8, 16 or 32)
// comes from ops/gvp_message.py::gvp_tile: the largest tile that still
// gives every SM a block, so the star-graph train bucket (1400 edges) keeps
// 8-edge tiles (175 blocks) and the 10k box reads each weight once per 32
// edges.
//
// Kernel 1 (gvp_fwd_edge_kernel) writes per-edge rows [s' | vx' | vy' | vz']
// for live edges.  Kernel 2 (gvp_reduce_kernel) sums them by receiver over a
// CSR (edge order sorted stably by receiver, row pointers), one warp per
// node, in ascending edge order: no atomics, so two runs give bitwise-equal
// outputs.  The count is the row's length.

#include "gvp_common.cuh"

namespace {

using gvp::Dims;
using gvp::kThreads;

struct FwdLayout {
  int ldx, ldv, lds, ldg;
  size_t x, v, vh, gi, vo, g, ws, total;  // offsets in floats
};

__host__ __device__ inline FwdLayout fwd_layout(const Dims& d, int TE) {
  FwdLayout l;
  l.ldx = 0;
  for (int k = 0; k < d.L; ++k)
    l.ldx = d.si[k] + d.h[k] > l.ldx ? d.si[k] + d.h[k] : l.ldx;
  l.ldv = gvp::max_of(d.vi, d.L);
  l.ldv = gvp::max_of(d.h, d.L) > l.ldv ? gvp::max_of(d.h, d.L) : l.ldv;
  l.ldv = gvp::max_of(d.vo, d.L) > l.ldv ? gvp::max_of(d.vo, d.L) : l.ldv;
  l.lds = gvp::max_of(d.so, d.L);
  l.ldg = gvp::max_of(d.vo, d.L);
  // odd row strides: the rows a warp reads at one k fall in distinct banks
  l.ldx |= 1; l.ldv |= 1; l.lds |= 1; l.ldg |= 1;
  l.x = 0;
  l.v = l.x + (size_t)TE * l.ldx;
  l.vh = l.v + (size_t)3 * TE * l.ldv;
  l.gi = l.vh + (size_t)3 * TE * l.ldv;
  l.vo = l.gi + (size_t)TE * l.lds;
  l.g = l.vo + (size_t)3 * TE * l.ldv;
  l.ws = (l.g + (size_t)TE * l.ldg + 3) & ~(size_t)3;   // float4 reads
  l.total = l.ws + (size_t)gvp::fwd_stages(TE) * gvp::kStage;
  return l;
}

template <int TE, typename Idx>
__global__ void __launch_bounds__(kThreads, 2) gvp_fwd_edge_kernel(
    Dims d, const Idx* __restrict__ send, const Idx* __restrict__ recv,
    const uint8_t* __restrict__ emask, const float* __restrict__ s,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ vz, const float* __restrict__ es,
    const float* __restrict__ evx, const float* __restrict__ evy,
    const float* __restrict__ evz, const float* __restrict__ W,
    float* __restrict__ m_e, int E) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool live[TE];
  const FwdLayout l = fwd_layout(d, TE);
  float* X = smem + l.x;
  float* V = smem + l.v;
  float* VH = smem + l.vh;
  float* GI = smem + l.gi;
  float* VO = smem + l.vo;
  float* G = smem + l.g;
  float* ws = smem + l.ws;
  const long long e0 = (long long)blockIdx.x * TE;
  const float* vp[3] = {vx, vy, vz};
  const float* evp[3] = {evx, evy, evz};
  gvp::gather_tile<TE>(d, send, recv, emask, s, vp, es, evp, e0, E, X, l.ldx, V,
                   l.ldv, live);
  for (int k = 0; k < d.L; ++k)
    gvp::layer_forward<TE, gvp::fwd_stages(TE)>(
        d, k, W + gvp::weight_offset(d, k), X, l.ldx, V, l.ldv, VH, l.ldv, GI,
        l.lds, VO, l.ldv, G, l.ldg, X, l.ldx, V, l.ldv, ws);
  // the last GVP left s' in GI and V' in V
  const int so = d.so[d.L - 1], vo = d.vo[d.L - 1], wm = so + 3 * vo;
  for (int i = threadIdx.x; i < TE * wm; i += kThreads) {
    const int r = i / wm, c = i - r * wm;
    if (!live[r]) continue;
    float val;
    if (c < so) {
      val = GI[r * l.lds + c];
    } else {
      const int p = (c - so) / vo, j = c - so - p * vo;
      val = V[(p * TE + r) * l.ldv + j];
    }
    m_e[(size_t)(e0 + r) * wm + c] = val;
  }
}

constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 8;   // columns per lane: so + 3 vo <= 256

// One warp per node: sum its CSR row of per-edge messages in ascending
// order into the scalar and the three vector-plane outputs, and the count.
__global__ void __launch_bounds__(kThreads) gvp_reduce_kernel(
    const int64_t* __restrict__ order, const int64_t* __restrict__ rowptr,
    const float* __restrict__ m_e, int so, int vo, float* __restrict__ out_s,
    float* __restrict__ out_vx, float* __restrict__ out_vy,
    float* __restrict__ out_vz, float* __restrict__ cnt, int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long node = (long long)blockIdx.x * kWarps + warp;
  if (node >= N) return;
  const int wm = so + 3 * vo;
  const int64_t beg = rowptr[node], end = rowptr[node + 1];
  float acc[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) acc[c] = 0.f;
  for (int64_t k = beg; k < end; ++k) {
    const float* m = m_e + (size_t)order[k] * wm;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < wm) acc[c] += m[col];
    }
  }
  float* planes[3] = {out_vx, out_vy, out_vz};
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int col = lane + 32 * c;
    if (col < so) {
      out_s[(size_t)node * so + col] = acc[c];
    } else if (col < wm) {
      const int p = (col - so) / vo;
      planes[p][(size_t)node * vo + col - so - p * vo] = acc[c];
    }
  }
  if (lane == 0) cnt[node] = (float)(end - beg);
}

template <int TE, typename Idx>
int launch_edges(const Dims& d, const void* send, const void* recv,
                 const void* emask, const void* s, const void* vx,
                 const void* vy, const void* vz, const void* es,
                 const void* evx, const void* evy, const void* evz,
                 const void* w, void* m_e, int E, cudaStream_t stream) {
  const size_t smem = fwd_layout(d, TE).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gvp_fwd_edge_kernel<TE, Idx>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (E + TE - 1) / TE;
  gvp_fwd_edge_kernel<TE, Idx><<<blocks, kThreads, smem, stream>>>(
      d, static_cast<const Idx*>(send), static_cast<const Idx*>(recv),
      static_cast<const uint8_t*>(emask), static_cast<const float*>(s),
      static_cast<const float*>(vx), static_cast<const float*>(vy),
      static_cast<const float*>(vz), static_cast<const float*>(es),
      static_cast<const float*>(evx), static_cast<const float*>(evy),
      static_cast<const float*>(evz), static_cast<const float*>(w),
      static_cast<float*>(m_e), E);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the first cudaError_t of
// the launches (0 = success).  Shapes, types and width limits are checked
// and the receiver CSR built by the Python wrapper (ops/gvp_message.py);
// dims holds (si, vi, h, so, vo) of each of the L GVPs; m_e is per-edge
// scratch [E, so + 3 vo] of the last GVP's widths; tile is the edge tile
// (8, 16 or 32; ops/gvp_message.py::gvp_tile).

extern "C" const char* gmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

static int read_dims(const void* dims, int L, Dims* d) {
  if (L < 1 || L > gvp::kMaxLayers) return 1;
  d->L = L;
  const int* dm = static_cast<const int*>(dims);
  for (int k = 0; k < L; ++k) {
    d->si[k] = dm[5 * k]; d->vi[k] = dm[5 * k + 1]; d->h[k] = dm[5 * k + 2];
    d->so[k] = dm[5 * k + 3]; d->vo[k] = dm[5 * k + 4];
  }
  return 0;
}

// Bytes of dynamic shared memory the forward edge kernel needs at this
// tile (host only; -1 for bad dims).
extern "C" int gmp_gvp_fwd_smem(const void* dims, int L, int tile) {
  Dims d;
  if (read_dims(dims, L, &d)) return -1;
  return (int)(fwd_layout(d, tile).total * sizeof(float));
}

template <typename Idx>
static int launch_tile(int tile, const Dims& d, const void* send,
                       const void* recv, const void* emask, const void* s,
                       const void* vx, const void* vy, const void* vz,
                       const void* es, const void* evx, const void* evy,
                       const void* evz, const void* w, void* m_e, int E,
                       cudaStream_t st) {
#define GMP_TILE(T_)                                                      \
  case T_:                                                                \
    return launch_edges<T_, Idx>(d, send, recv, emask, s, vx, vy, vz, es, \
                                 evx, evy, evz, w, m_e, E, st);
  switch (tile) {
    GMP_TILE(8) GMP_TILE(16) GMP_TILE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef GMP_TILE
}

extern "C" int gmp_gvp_fwd(
    int device, const void* send, const void* recv, int idx64,
    const void* emask, const void* s, const void* vx, const void* vy,
    const void* vz, const void* es, const void* evx, const void* evy,
    const void* evz, const void* w, const void* dims, int L, int S, int V,
    int SE, int VE, int E, int N, const void* order, const void* rowptr,
    void* m_e, void* out_s, void* out_vx, void* out_vy, void* out_vz,
    void* out_cnt, int tile, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Dims d;
  if (read_dims(dims, L, &d)) return (int)cudaErrorInvalidValue;
  d.S = S; d.V = V; d.SE = SE; d.VE = VE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = 0;
  if (E > 0) {
    rc = idx64 ? launch_tile<long long>(tile, d, send, recv, emask, s, vx, vy,
                                        vz, es, evx, evy, evz, w, m_e, E, st)
               : launch_tile<int>(tile, d, send, recv, emask, s, vx, vy, vz,
                                  es, evx, evy, evz, w, m_e, E, st);
    if (rc) return rc;
  }
  if (N > 0) {
    gvp_reduce_kernel<<<(N + kWarps - 1) / kWarps, kThreads, 0, st>>>(
        static_cast<const int64_t*>(order), static_cast<const int64_t*>(rowptr),
        static_cast<const float*>(m_e), d.so[L - 1], d.vo[L - 1],
        static_cast<float*>(out_s), static_cast<float*>(out_vx),
        static_cast<float*>(out_vy), static_cast<float*>(out_vz),
        static_cast<float*>(out_cnt), N);
    rc = (int)cudaGetLastError();
  }
  return rc;
}
