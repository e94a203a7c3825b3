// The whole EGNN stack, forward, in one launch, for Hopper (sm_90a), exact
// f32 on the CUDA cores.
//
// Replaces geometric_message_passing_tpu/ops/pallas_egnn_stack.py::
// _stack_fwd_kernel (launched by make_egnn_stack_fused), the TPU kernel that
// runs all L EGNN layers, update MLP and residual included, with the node
// state kept in VMEM across its grid of layers.  Same function, same packed
// rows ([L, 7D+18, D]: the message rows of pack_egnn_weights, then U1 ub1
// ug1 uB1 U2 ub2 ug2 uB2), same masking.  Not the TPU algorithm: the one-hot
// [E, N] matmuls that gather and scatter on the TPU's matrix unit become
// indexed loads and a receiver CSR sum, and nothing requires the edges to fit
// one block, so N and E are not limited.
//
// What bounds it: at the graph sizes it is made for (a star batch: 800
// nodes, 1400 edges, D 128) neither bytes nor operations but latency.  Per
// layer the live edges need 2D(2D+1) + 4D^2 FLOPs each (131 kFLOP at D 128)
// and the nodes 6D^2 (98 kFLOP), some 0.2 GFLOP per layer, 3 us at the f32
// rate; the per-layer launches of the per-layer strategy (the message kernel
// and some fifteen eager ops of the update MLP) cost more than that on the
// host.  So the design takes the launches away: one persistent cooperative
// launch of as many blocks as the card holds at once, and a grid barrier
// between the phases of each layer:
//   1. edges: each block takes tiles of 16 edges (egnn_common.cuh's
//      edge_fwd_tile: K-tiled weights, warp-row LayerNorm) and writes the
//      live edges' msg [E, D] and pos_msg [E, 3];
//   2. barrier;
//   3. nodes: tiles of 16 nodes (node_fwd_tile): each warp sums its nodes'
//      receiver CSR rows in ascending edge order, then the block runs the
//      update MLP on the tile and writes h + upd and pos + pos_sum / max(cnt,
//      1) in place (each node row has one owner);
//   4. barrier (except after the last layer).
// Layer 0 reads h0 and pos0 and writes the outputs; later layers update the
// outputs in place.  No atomics in any sum: two runs are bitwise equal.  The
// tiles of a phase are few at a star batch (88 edge tiles, 50 node tiles for
// 132 SMs), so most blocks wait at the barriers; making them busy is a later
// step.
//
// The grid barrier is egnn_common.cuh's grid_sync, over the two counters the
// wrapper zeroes; the cooperative launch refuses a grid the card cannot hold
// at once, so the barrier cannot deadlock.

#include <cuda_runtime.h>
#include <stdint.h>

#include "egnn_common.cuh"

using namespace egnn;

template <typename Idx>
struct FwdArgs {
  const Idx *send, *recv;
  const uint8_t* emask;
  const float *h0, *pos0, *w;
  const int64_t *order, *rowptr;
  float *msg_e, *pos_e, *h, *pos;
  unsigned int* bar;
  long long N, E;
  int D, L;
};

template <typename Idx>
__global__ void __launch_bounds__(kThreads) egnn_stack_fwd_kernel(const FwdArgs<Idx> a) {
  extern __shared__ float smem[];
  const long long edge_tiles = (a.E + kTileRows - 1) / kTileRows;
  const long long node_tiles = (a.N + kTileRows - 1) / kTileRows;
  const size_t rows = (size_t)(7 * a.D + 18) * a.D;    // floats per layer
  for (int l = 0; l < a.L; ++l) {
    const float* W = a.w + (size_t)l * rows;
    const float* h = l == 0 ? a.h0 : a.h;
    const float* pos = l == 0 ? a.pos0 : a.pos;
    for (long long t = blockIdx.x; t < edge_tiles; t += gridDim.x)
      edge_fwd_tile<Idx>(t, a.send, a.recv, a.emask, h, pos, W, a.msg_e,
                         a.pos_e, a.E, a.D, smem);
    grid_sync(a.bar);
    for (long long t = blockIdx.x; t < node_tiles; t += gridDim.x)
      node_fwd_tile(t, a.order, a.rowptr, a.msg_e, a.pos_e, h, pos,
                    W + (size_t)(4 * a.D + 12) * a.D, nullptr, a.h, a.pos,
                    a.N, a.D, smem);
    if (l + 1 < a.L) grid_sync(a.bar);
  }
}

namespace {

template <typename Idx>
int launch(const FwdArgs<Idx>& a, cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const size_t smem = sizeof(float) * stack_smem_floats(a.D);
  err = cudaFuncSetAttribute(egnn_stack_fwd_kernel<Idx>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, egnn_stack_fwd_kernel<Idx>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // as many blocks as the card holds at once, but no more than a phase has
  // tiles
  const long long tiles = ((a.E > a.N ? a.E : a.N) + kTileRows - 1) / kTileRows;
  const long long cap = (long long)per_sm * sms;
  const int grid = (int)(tiles < cap ? (tiles > 0 ? tiles : 1) : cap);
  void* args[] = {const_cast<FwdArgs<Idx>*>(&a)};
  err = cudaLaunchCooperativeKernel(egnn_stack_fwd_kernel<Idx>, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the first cudaError_t
// (0 = success).  Shapes and types are checked, the receiver CSR built and
// the buffers allocated by the Python wrapper (ops/egnn_stack.py): msg_e
// [E, D] and pos_e [E, 3] scratch, h [N, D] and pos [N, 3] the result, bar two
// zeroed 32-bit counters.

extern "C" const char* gmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int gmp_egnn_stack_fwd(
    int device, const void* send, const void* recv, int idx64,
    const void* emask, const void* h0, const void* pos0, const void* w,
    const void* order, const void* rowptr, void* msg_e, void* pos_e, void* h,
    void* pos, void* bar, int N, int E, int D, int L, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx64) {
    FwdArgs<long long> a{static_cast<const long long*>(send),
                         static_cast<const long long*>(recv),
                         static_cast<const uint8_t*>(emask),
                         static_cast<const float*>(h0),
                         static_cast<const float*>(pos0),
                         static_cast<const float*>(w),
                         static_cast<const int64_t*>(order),
                         static_cast<const int64_t*>(rowptr),
                         static_cast<float*>(msg_e), static_cast<float*>(pos_e),
                         static_cast<float*>(h), static_cast<float*>(pos),
                         static_cast<unsigned int*>(bar), N, E, D, L};
    return launch(a, s);
  }
  FwdArgs<int> a{static_cast<const int*>(send), static_cast<const int*>(recv),
                 static_cast<const uint8_t*>(emask),
                 static_cast<const float*>(h0), static_cast<const float*>(pos0),
                 static_cast<const float*>(w),
                 static_cast<const int64_t*>(order),
                 static_cast<const int64_t*>(rowptr),
                 static_cast<float*>(msg_e), static_cast<float*>(pos_e),
                 static_cast<float*>(h), static_cast<float*>(pos),
                 static_cast<unsigned int*>(bar), N, E, D, L};
  return launch(a, s);
}
