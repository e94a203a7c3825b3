// Per-edge weighted CG contraction for Hopper (sm_90a): TFN's tensor-product
// stage 2, forward and backward, exact f32, no atomics.
//
// Replaces geometric_message_passing_tpu/ops/pallas_tp.py::_fwd_kernel and
// ::_bwd_kernel (K7).  Per output-irrep group of a layer's edge tensor
// product, with k = (path, u):
//
//   forward   out[e, w, m] = sum_k T[e, k, m] W[e, k, w]
//   backward  dW[e, k, w]  = sum_m T[e, k, m] dO[e, w, m]
//             dT[e, k, m]  = sum_w W[e, k, w] dO[e, w, m]
//
// T [E, K, m] is the f32 CG intermediate, W [E, K, w] the per-edge weight
// (f32, or bf16 converted to f32 in the kernel), out / dO [E, w, m] f32, dW
// in W's type (rounded to nearest), dT f32.  m = 2l+1 <= 15.
//
// The TPU kernel tiles (edges, K) with K innermost and accumulates the output
// block across the K grid steps, with T passed transposed so both operands
// contract over their lane axis.  Here nothing carries over between blocks,
// so a block owns one edge and loops over K itself:
//
// What bounds it: bytes.  W is the giant (at TFN's star width a hidden
// layer holds 143,360 weights per edge, 803 MB at the train bucket's 1400
// edges) and each weight is used by only m <= 7 multiply-adds forward and
// 2m backward, far below the card's ~20 f32 operations per byte.
//
// What the design does about it:
//   * forward: T[e] (K x m <= 3136 floats) is staged in shared memory; each
//     thread owns one w column and one of ks = blockDim / w interleaved
//     slices of k, streams its W[e, k, w] (coalesced along w: a warp reads
//     128 contiguous bytes of a row) and keeps its m sums in registers; the
//     ks partial sums are then added in slice order through shared memory;
//   * backward: T[e] and dO[e] are staged in shared memory; a warp takes the
//     rows k = warp, warp + 8, ...: its lanes read W[e, k, :] once, write
//     dW[e, k, :] and reduce dT[e, k, :] over w by a fixed shuffle tree.
// Every sum has a fixed order: two runs give bitwise-equal results.  No TF32
// and no tensor cores: every product is an f32 FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename TW>
__device__ __forceinline__ float to_f32(TW v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TW>
__device__ __forceinline__ TW from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// grid (E, ceil(w / wcols)); thread t: slice s = t / wcols, column
// blockIdx.y * wcols + t % wcols.  Shared: T[e] (K*M), then the partial
// sums [ks][wcols][M].
template <typename TW, int M>
__global__ void __launch_bounds__(kThreads)
contract_fwd(const float* __restrict__ T, const TW* __restrict__ W,
             float* __restrict__ out, int K, int Wd, int wcols, int ks) {
  extern __shared__ float smem[];
  float* t_s = smem;
  float* part = smem + K * M;
  const int64_t e = blockIdx.x;
  const float* __restrict__ Te = T + e * (int64_t)K * M;
  for (int i = threadIdx.x; i < K * M; i += blockDim.x) t_s[i] = Te[i];
  __syncthreads();

  const int s = threadIdx.x / wcols, tl = threadIdx.x % wcols;
  const int w = blockIdx.y * wcols + tl;
  float acc[M];
#pragma unroll
  for (int j = 0; j < M; ++j) acc[j] = 0.f;
  if (s < ks && w < Wd) {
    const TW* __restrict__ We = W + e * (int64_t)K * Wd + w;
#pragma unroll 4
    for (int k = s; k < K; k += ks) {
      const float wv = to_f32<TW>(We[(int64_t)k * Wd]);
      const float* tk = t_s + k * M;
#pragma unroll
      for (int j = 0; j < M; ++j) acc[j] = fmaf(tk[j], wv, acc[j]);
    }
  }
  if (s < ks) {
#pragma unroll
    for (int j = 0; j < M; ++j) part[(s * wcols + tl) * M + j] = acc[j];
  }
  __syncthreads();
  if (s == 0 && w < Wd) {
    float* __restrict__ o = out + (e * Wd + w) * M;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float sum = part[tl * M + j];
      for (int q = 1; q < ks; ++q) sum += part[(q * wcols + tl) * M + j];
      o[j] = sum;
    }
  }
}

// grid (E); warp v takes the rows k = v, v + kWarps, ...  Shared: T[e]
// (K*M), dO[e] (Wd*M).
template <typename TW, int M>
__global__ void __launch_bounds__(kThreads)
contract_bwd(const float* __restrict__ T, const TW* __restrict__ W,
             const float* __restrict__ dO, float* __restrict__ dT,
             TW* __restrict__ dW, int K, int Wd) {
  extern __shared__ float smem[];
  float* t_s = smem;
  float* g_s = smem + K * M;
  const int64_t e = blockIdx.x;
  const float* __restrict__ Te = T + e * (int64_t)K * M;
  const float* __restrict__ Ge = dO + e * (int64_t)Wd * M;
  for (int i = threadIdx.x; i < K * M; i += blockDim.x) t_s[i] = Te[i];
  for (int i = threadIdx.x; i < Wd * M; i += blockDim.x) g_s[i] = Ge[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const TW* __restrict__ We = W + e * (int64_t)K * Wd;
  TW* __restrict__ dWe = dW + e * (int64_t)K * Wd;
  for (int k = warp; k < K; k += kWarps) {
    const float* tk = t_s + k * M;
    float dt[M];
#pragma unroll
    for (int j = 0; j < M; ++j) dt[j] = 0.f;
    for (int w = lane; w < Wd; w += 32) {
      const float wv = to_f32<TW>(We[(int64_t)k * Wd + w]);
      const float* gw = g_s + w * M;
      float dw = 0.f;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        dw = fmaf(tk[j], gw[j], dw);
        dt[j] = fmaf(wv, gw[j], dt[j]);
      }
      dWe[(int64_t)k * Wd + w] = from_f32<TW>(dw);
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dt[j] += __shfl_xor_sync(0xffffffffu, dt[j], off);
    }
    if (lane == 0) {
      float* __restrict__ o = dT + (e * K + k) * M;
#pragma unroll
      for (int j = 0; j < M; ++j) o[j] = dt[j];
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename TW, int M>
int fwd(const float* T, const TW* W, float* out, int E, int K, int Wd,
        cudaStream_t stream) {
  const int wcols = Wd < kThreads ? Wd : kThreads;
  const int ks = kThreads / wcols;
  const size_t smem = sizeof(float) * ((size_t)K * M + (size_t)ks * wcols * M);
  cudaError_t err = allow_smem(contract_fwd<TW, M>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)E, (unsigned)((Wd + wcols - 1) / wcols));
  contract_fwd<TW, M><<<grid, kThreads, smem, stream>>>(T, W, out, K, Wd,
                                                        wcols, ks);
  return (int)cudaGetLastError();
}

template <typename TW, int M>
int bwd(const float* T, const TW* W, const float* dO, float* dT, TW* dW, int E,
        int K, int Wd, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)K * M + (size_t)Wd * M);
  cudaError_t err = allow_smem(contract_bwd<TW, M>, smem);
  if (err != cudaSuccess) return (int)err;
  contract_bwd<TW, M><<<(unsigned)E, kThreads, smem, stream>>>(T, W, dO, dT,
                                                               dW, K, Wd);
  return (int)cudaGetLastError();
}

// Dispatch on m (odd, 1..15: 2l+1) to a kernel with its sums in registers.
#define GMP_FOR_M(M_, CALL)                                             \
  switch (M_) {                                                         \
    case 1: { constexpr int M = 1; return CALL; }                       \
    case 3: { constexpr int M = 3; return CALL; }                       \
    case 5: { constexpr int M = 5; return CALL; }                       \
    case 7: { constexpr int M = 7; return CALL; }                       \
    case 9: { constexpr int M = 9; return CALL; }                       \
    case 11: { constexpr int M = 11; return CALL; }                     \
    case 13: { constexpr int M = 13; return CALL; }                     \
    case 15: { constexpr int M = 15; return CALL; }                     \
    default: return (int)cudaErrorInvalidValue;                         \
  }

template <typename TW>
int run_fwd(int device, const void* T, const void* W, void* out, int E, int K,
            int m, int Wd, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E == 0 || Wd == 0) return 0;
  const float* t = static_cast<const float*>(T);
  const TW* w = static_cast<const TW*>(W);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GMP_FOR_M(m, (fwd<TW, M>(t, w, o, E, K, Wd, s)))
}

template <typename TW>
int run_bwd(int device, const void* T, const void* W, const void* dO, void* dT,
            void* dW, int E, int K, int m, int Wd, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E == 0 || K == 0) return 0;
  const float* t = static_cast<const float*>(T);
  const TW* w = static_cast<const TW*>(W);
  const float* g = static_cast<const float*>(dO);
  float* dt = static_cast<float*>(dT);
  TW* dw = static_cast<TW*>(dW);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GMP_FOR_M(m, (bwd<TW, M>(t, w, g, dt, dw, E, K, Wd, s)))
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the cudaError_t of the
// launch (0 = success).  All tensors contiguous on one device: T [E, K, m]
// f32, W [E, K, w] f32 (the _bf16 entries: bf16), out and dO [E, w, m] f32,
// dT [E, K, m] f32, dW [E, K, w] of W's type.  The Python wrapper
// (ops/edge_contract.py) checks them.

extern "C" const char* gmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int gmp_contract_fwd(int device, const void* T, const void* W,
                                void* out, int E, int K, int m, int Wd,
                                void* stream) {
  return run_fwd<float>(device, T, W, out, E, K, m, Wd, stream);
}

extern "C" int gmp_contract_fwd_bf16(int device, const void* T, const void* W,
                                     void* out, int E, int K, int m, int Wd,
                                     void* stream) {
  return run_fwd<__nv_bfloat16>(device, T, W, out, E, K, m, Wd, stream);
}

extern "C" int gmp_contract_bwd(int device, const void* T, const void* W,
                                const void* dO, void* dT, void* dW, int E,
                                int K, int m, int Wd, void* stream) {
  return run_bwd<float>(device, T, W, dO, dT, dW, E, K, m, Wd, stream);
}

extern "C" int gmp_contract_bwd_bf16(int device, const void* T, const void* W,
                                     const void* dO, void* dT, void* dW, int E,
                                     int K, int m, int Wd, void* stream) {
  return run_bwd<__nv_bfloat16>(device, T, W, dO, dT, dW, E, K, m, Wd, stream);
}
