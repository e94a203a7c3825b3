// Sorted (CSR) segment sum for Hopper (sm_90a): exact f32, no atomics.
//
// Replaces two TPU kernels that compute the same function:
//   * geometric_message_passing_tpu/ops/pallas_sorted_segsum.py::_sorted_kernel
//     (K3): the masked segment sum of segment-sorted [E, D] rows into [N, D],
//     the box-scale path's every segment reduction and gather backward;
//   * geometric_message_passing_tpu/ops/pallas_edge.py::_segsum_kernel (K4):
//     the masked segment sum over unsorted ids.
// The TPU forms the sums as one-hot matrix products on its matrix unit (at
// HIGHEST precision, to keep f32 exact).  Here the sum is what it is, an
// indexed row sum over a CSR plan built by the caller:
//
//   out[s, :] = sum_{k = rowptr[s]}^{rowptr[s+1]-1} data[perm[k], :]
//
// with perm omitted (null) when it is the identity.  Masked-off rows lie
// outside every row range, so the kernel never reads them.  Each segment's
// rows are added in ascending k, in f32, by one thread per column: two runs
// give bitwise-equal sums, and every output row is written (0 when empty).
//
// What bounds it: bytes.  One add per element read; at the box path's widest
// shape (E 1.35M live rows, D 128) it reads 692 MB and writes 51 MB, some
// 0.22 ms at 3.35 TB/s, against 0.17 GFLOP.
//
// What the design does about it: for D > 8 one warp takes a segment, its
// lanes across the columns, so each row is read as one coalesced 512-byte
// line of float4 loads (D % 4 == 0 and 16-byte aligned rows) or 128 bytes of
// floats otherwise; the row loop is unrolled so that several rows' loads are
// in flight per warp.  For D <= 8 (the position sums, D 3 and 4) a warp per
// segment would leave most lanes idle, so one thread takes a segment and
// keeps its D sums in registers.  When the segments are few and long (a
// sum or mean pool of a whole box into one graph: E at least 1024 x N rows,
// chosen by the wrapper), one warp per segment would walk 1e5 rows in
// sequence on one SM, so the rows of each segment are cut into G equal
// chunks (G chosen by the wrapper so that N x G blocks fill the card): a
// block of 32 warps sums one chunk (warp w the rows w, w + 32, ... of it,
// the 32 partial sums added in warp order through shared memory) into a
// scratch row, and a second kernel adds each segment's G rows in order.
// Every path fixes its order of addition, so two runs stay bitwise equal.
//
// The same code is instantiated for double (gmp_sorted_segsum_f64): the
// float64 reference runs on the card sum through it too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmallD = 8;       // widths up to this take one thread per segment
constexpr int kBlockWarps = 32;
constexpr int kBlockCols = 128;  // columns per pass of the block kernel

template <bool kPerm>
__device__ __forceinline__ int64_t row_of(const int64_t* __restrict__ perm,
                                          int64_t k) {
  return kPerm ? __ldg(perm + k) : k;
}

// One warp per segment; lane l sums the float4 columns l, l + 32, ...
template <bool kPerm>
__global__ void __launch_bounds__(kThreads)
segsum_warp_vec4(const float* __restrict__ data,
                 const int64_t* __restrict__ perm,
                 const int64_t* __restrict__ rowptr, float* __restrict__ out,
                 int N, int D) {
  const int64_t seg = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (seg >= N) return;
  const int64_t beg = rowptr[seg], end = rowptr[seg + 1];
  const int D4 = D >> 2;
  const float4* __restrict__ src = reinterpret_cast<const float4*>(data);
  float4* __restrict__ dst = reinterpret_cast<float4*>(out) + seg * D4;
  for (int c = lane; c < D4; c += 32) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int64_t k = beg; k < end; ++k) {
      const float4 v = __ldg(src + row_of<kPerm>(perm, k) * D4 + c);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    dst[c] = acc;
  }
}

// One warp per segment; lane l sums the columns l, l + 32, ...
template <typename T, bool kPerm>
__global__ void __launch_bounds__(kThreads)
segsum_warp(const T* __restrict__ data, const int64_t* __restrict__ perm,
            const int64_t* __restrict__ rowptr, T* __restrict__ out, int N,
            int D) {
  const int64_t seg = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (seg >= N) return;
  const int64_t beg = rowptr[seg], end = rowptr[seg + 1];
  for (int c = lane; c < D; c += 32) {
    T acc = 0;
#pragma unroll 4
    for (int64_t k = beg; k < end; ++k)
      acc += __ldg(data + row_of<kPerm>(perm, k) * D + c);
    out[seg * D + c] = acc;
  }
}

// One thread per segment, its D <= kSmallD sums in registers.
template <typename T, bool kPerm>
__global__ void __launch_bounds__(kThreads)
segsum_thread(const T* __restrict__ data, const int64_t* __restrict__ perm,
              const int64_t* __restrict__ rowptr, T* __restrict__ out,
              int N, int D) {
  const int64_t seg = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (seg >= N) return;
  const int64_t beg = rowptr[seg], end = rowptr[seg + 1];
  T acc[kSmallD];
#pragma unroll
  for (int c = 0; c < kSmallD; ++c) acc[c] = 0;
  for (int64_t k = beg; k < end; ++k) {
    const T* __restrict__ row = data + row_of<kPerm>(perm, k) * D;
#pragma unroll
    for (int c = 0; c < kSmallD; ++c)
      if (c < D) acc[c] += __ldg(row + c);
  }
#pragma unroll
  for (int c = 0; c < kSmallD; ++c)
    if (c < D) out[seg * D + c] = acc[c];
}

// Few, long segments, pass 1: block (seg, g) of 32 warps sums chunk g of
// G of segment seg into part[seg, g, :].  Per pass over kBlockCols columns:
// lane l of warp w sums columns c0 + l, c0 + l + 32, ... over the chunk's
// rows w, w + 32, ...; then thread t adds the 32 warps' partials of column
// c0 + t in warp order.
template <typename T, bool kPerm>
__global__ void __launch_bounds__(kBlockWarps * 32)
segsum_chunks(const T* __restrict__ data, const int64_t* __restrict__ perm,
              const int64_t* __restrict__ rowptr, T* __restrict__ part, int D,
              int G) {
  __shared__ T warp_sum[kBlockWarps][kBlockCols];
  const int64_t seg = blockIdx.x;
  const int g = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t beg = rowptr[seg], len = rowptr[seg + 1] - beg;
  const int64_t lo = beg + len * g / G, hi = beg + len * (g + 1) / G;
  T* __restrict__ dst = part + ((int64_t)seg * G + g) * D;
  for (int c0 = 0; c0 < D; c0 += kBlockCols) {
    T acc[kBlockCols / 32];
#pragma unroll
    for (int j = 0; j < kBlockCols / 32; ++j) acc[j] = 0;
#pragma unroll 2
    for (int64_t k = lo + warp; k < hi; k += kBlockWarps) {
      const T* __restrict__ row = data + row_of<kPerm>(perm, k) * D;
#pragma unroll
      for (int j = 0; j < kBlockCols / 32; ++j) {
        const int c = c0 + lane + 32 * j;
        if (c < D) acc[j] += __ldg(row + c);
      }
    }
#pragma unroll
    for (int j = 0; j < kBlockCols / 32; ++j)
      warp_sum[warp][lane + 32 * j] = acc[j];
    __syncthreads();
    if (threadIdx.x < kBlockCols && c0 + (int)threadIdx.x < D) {
      T sum = 0;
      for (int w = 0; w < kBlockWarps; ++w) sum += warp_sum[w][threadIdx.x];
      dst[c0 + threadIdx.x] = sum;
    }
    __syncthreads();
  }
}

// Pass 2: out[seg, c] = sum over g = 0 .. G-1 of part[seg, g, c], in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
segsum_combine(const T* __restrict__ part, T* __restrict__ out, int N, int D,
               int G) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)N * D) return;
  const int64_t seg = i / D, c = i % D;
  const T* __restrict__ src = part + seg * G * D + c;
  T sum = 0;
  for (int g = 0; g < G; ++g) sum += src[(int64_t)g * D];
  out[i] = sum;
}

template <typename T, bool kPerm>
void launch(const T* data, const int64_t* perm, const int64_t* rowptr, T* out,
            int N, int D, int G, T* scratch, cudaStream_t stream) {
  if (G > 0) {
    segsum_chunks<T, kPerm><<<dim3((unsigned)N, (unsigned)G),
                              kBlockWarps * 32, 0, stream>>>(
        data, perm, rowptr, scratch, D, G);
    const int64_t blocks = ((int64_t)N * D + kThreads - 1) / kThreads;
    segsum_combine<T><<<(unsigned)blocks, kThreads, 0, stream>>>(scratch, out,
                                                                N, D, G);
    return;
  }
  if (D <= kSmallD) {
    const int64_t blocks = ((int64_t)N + kThreads - 1) / kThreads;
    segsum_thread<T, kPerm><<<(unsigned)blocks, kThreads, 0, stream>>>(
        data, perm, rowptr, out, N, D);
    return;
  }
  const int64_t blocks = ((int64_t)N * 32 + kThreads - 1) / kThreads;
  if constexpr (sizeof(T) == 4) {
    const bool vec4 = D % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (vec4) {
      segsum_warp_vec4<kPerm><<<(unsigned)blocks, kThreads, 0, stream>>>(
          data, perm, rowptr, out, N, D);
      return;
    }
  }
  segsum_warp<T, kPerm><<<(unsigned)blocks, kThreads, 0, stream>>>(
      data, perm, rowptr, out, N, D);
}

template <typename T>
int run(int device, const void* data, const void* perm, const void* rowptr,
        void* out, int N, int D, int G, void* scratch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || D == 0) return 0;
  const T* x = static_cast<const T*>(data);
  const int64_t* p = static_cast<const int64_t*>(perm);
  const int64_t* r = static_cast<const int64_t*>(rowptr);
  T* y = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* part = static_cast<T*>(scratch);
  if (G > 0 && part == nullptr) return (int)cudaErrorInvalidValue;
  if (p)
    launch<T, true>(x, p, r, y, N, D, G, part, s);
  else
    launch<T, false>(x, p, r, y, N, D, G, part, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the cudaError_t of the
// launch (0 = success).  data [E, D] f32 (f64 for the _f64 entry), perm [E]
// int64 or null (identity), rowptr [N+1] int64, out [N, D] of data's type,
// all contiguous on one device; G > 0 selects the chunked path for few,
// long segments, with scratch [N, G, D] of data's type.  The Python wrapper
// (ops/sorted_segsum.py) checks them, builds the plan and picks G.

extern "C" const char* gmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int gmp_sorted_segsum(int device, const void* data,
                                 const void* perm, const void* rowptr,
                                 void* out, int N, int D, int G, void* scratch,
                                 void* stream) {
  return run<float>(device, data, perm, rowptr, out, N, D, G, scratch, stream);
}

extern "C" int gmp_sorted_segsum_f64(int device, const void* data,
                                     const void* perm, const void* rowptr,
                                     void* out, int N, int D, int G,
                                     void* scratch, void* stream) {
  return run<double>(device, data, perm, rowptr, out, N, D, G, scratch,
                     stream);
}
