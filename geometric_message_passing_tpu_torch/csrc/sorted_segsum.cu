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
// keeps its D sums in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmallD = 8;   // widths up to this take one thread per segment

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
template <bool kPerm>
__global__ void __launch_bounds__(kThreads)
segsum_warp(const float* __restrict__ data, const int64_t* __restrict__ perm,
            const int64_t* __restrict__ rowptr, float* __restrict__ out, int N,
            int D) {
  const int64_t seg = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (seg >= N) return;
  const int64_t beg = rowptr[seg], end = rowptr[seg + 1];
  for (int c = lane; c < D; c += 32) {
    float acc = 0.f;
#pragma unroll 4
    for (int64_t k = beg; k < end; ++k)
      acc += __ldg(data + row_of<kPerm>(perm, k) * D + c);
    out[seg * D + c] = acc;
  }
}

// One thread per segment, its D <= kSmallD sums in registers.
template <bool kPerm>
__global__ void __launch_bounds__(kThreads)
segsum_thread(const float* __restrict__ data, const int64_t* __restrict__ perm,
              const int64_t* __restrict__ rowptr, float* __restrict__ out,
              int N, int D) {
  const int64_t seg = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (seg >= N) return;
  const int64_t beg = rowptr[seg], end = rowptr[seg + 1];
  float acc[kSmallD];
#pragma unroll
  for (int c = 0; c < kSmallD; ++c) acc[c] = 0.f;
  for (int64_t k = beg; k < end; ++k) {
    const float* __restrict__ row = data + row_of<kPerm>(perm, k) * D;
#pragma unroll
    for (int c = 0; c < kSmallD; ++c)
      if (c < D) acc[c] += __ldg(row + c);
  }
#pragma unroll
  for (int c = 0; c < kSmallD; ++c)
    if (c < D) out[seg * D + c] = acc[c];
}

template <bool kPerm>
void launch(const float* data, const int64_t* perm, const int64_t* rowptr,
            float* out, int N, int D, cudaStream_t stream) {
  if (D <= kSmallD) {
    const int64_t blocks = ((int64_t)N + kThreads - 1) / kThreads;
    segsum_thread<kPerm><<<(unsigned)blocks, kThreads, 0, stream>>>(
        data, perm, rowptr, out, N, D);
    return;
  }
  const int64_t blocks = ((int64_t)N * 32 + kThreads - 1) / kThreads;
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4)
    segsum_warp_vec4<kPerm><<<(unsigned)blocks, kThreads, 0, stream>>>(
        data, perm, rowptr, out, N, D);
  else
    segsum_warp<kPerm><<<(unsigned)blocks, kThreads, 0, stream>>>(
        data, perm, rowptr, out, N, D);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the cudaError_t of the
// launch (0 = success).  data [E, D] f32, perm [E] int64 or null (identity),
// rowptr [N+1] int64, out [N, D] f32, all contiguous on one device; the
// Python wrapper (ops/sorted_segsum.py) checks them and builds the plan.

extern "C" const char* gmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int gmp_sorted_segsum(int device, const void* data,
                                 const void* perm, const void* rowptr,
                                 void* out, int N, int D, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || D == 0) return 0;
  const float* x = static_cast<const float*>(data);
  const int64_t* p = static_cast<const int64_t*>(perm);
  const int64_t* r = static_cast<const int64_t*>(rowptr);
  float* y = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p)
    launch<true>(x, p, r, y, N, D, s);
  else
    launch<false>(x, p, r, y, N, D, s);
  return (int)cudaGetLastError();
}
