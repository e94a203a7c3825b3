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
// rate.  So the design takes the per-layer launches away: one persistent
// cooperative launch of as many blocks as the card holds at once (at most
// one per tile), and a grid barrier between the phases of each layer:
//   1. edges: each block takes tiles of TE edges (egnn_common.cuh's
//      edge_fwd_tile) and writes the live edges' msg [E, D] and pos_msg
//      [E, 3];
//   2. barrier;
//   3. nodes: tiles of TE nodes (node_fwd_tile): each warp sums its nodes'
//      receiver CSR rows in ascending edge order, then the block runs the
//      update MLP on the tile and writes h + upd and pos + pos_sum / max(cnt,
//      1) in place (each node row has one owner);
//   4. barrier (except after the last layer).
// Layer 0 reads h0 and pos0 and writes the outputs; later layers update the
// outputs in place.  No atomics in any sum: two runs are bitwise equal.
// Within a phase the time is a tile's chain of products, each a pipeline of
// weight K-tiles: egnn_common.cuh keeps three K-tiles in flight by bulk
// copies (the TMA) while one is multiplied, register-blocks the products
// (TE/8 rows x 4 columns a thread) and reads shared memory without bank
// conflicts.
// The tile TE (8, 16 or 32) comes from the wrapper's rule
// (ops/edge.py::egnn_tile): the largest that still gives every SM an
// edge tile, so the star bucket's 1400 edges take 8 (175 edge and 100 node
// tiles for 132 SMs, two blocks an SM) and the 10k box 32 (each staged
// weight used by 32 rows).  A tile's columns are not split over a cluster:
// at the star bucket the 8-row tiles already give every SM edge work, and a
// LayerNorm across blocks would add a cluster barrier to every row step.
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
  unsigned long long* stamps;   // phase clock readings, or null
  long long N, E;
  int D, L;
};

template <int TE, typename Idx>
__global__ void __launch_bounds__(kThreads, 2) egnn_stack_fwd_kernel(const FwdArgs<Idx> a) {
  extern __shared__ __align__(16) float smem[];
  ring_init(smem);
  const long long edge_tiles = (a.E + TE - 1) / TE;
  const long long node_tiles = (a.N + TE - 1) / TE;
  const size_t rows = (size_t)(7 * a.D + 18) * a.D;    // floats per layer
  int k = 0;
  phase_stamp(a.stamps, k);
  for (int l = 0; l < a.L; ++l) {
    const float* W = a.w + (size_t)l * rows;
    const float* h = l == 0 ? a.h0 : a.h;
    const float* pos = l == 0 ? a.pos0 : a.pos;
    for (long long t = blockIdx.x; t < edge_tiles; t += gridDim.x)
      edge_fwd_tile<TE, Idx>(t, a.send, a.recv, a.emask, h, pos, W, a.msg_e,
                             a.pos_e, nullptr, a.E, a.D, smem);
    grid_sync(a.bar);
    phase_stamp(a.stamps, k);
    for (long long t = blockIdx.x; t < node_tiles; t += gridDim.x)
      node_fwd_tile<TE>(t, a.order, a.rowptr, a.msg_e, a.pos_e, h, pos,
                        W + (size_t)(4 * a.D + 12) * a.D, nullptr, a.h, a.pos,
                        nullptr, a.N, a.D, smem);
    if (l + 1 < a.L) grid_sync(a.bar);
    phase_stamp(a.stamps, k);
  }
}

namespace {

template <int TE, typename Idx>
int launch(const FwdArgs<Idx>& a, cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const size_t smem = sizeof(float) * tile_smem_floats(TE, a.D);
  err = cudaFuncSetAttribute(egnn_stack_fwd_kernel<TE, Idx>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, egnn_stack_fwd_kernel<TE, Idx>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // as many blocks as the card holds at once, but no more than a phase has
  // tiles
  const long long tiles = ((a.E > a.N ? a.E : a.N) + TE - 1) / TE;
  const long long cap = (long long)per_sm * sms;
  const int grid = (int)(tiles < cap ? (tiles > 0 ? tiles : 1) : cap);
  void* args[] = {const_cast<FwdArgs<Idx>*>(&a)};
  err = cudaLaunchCooperativeKernel(egnn_stack_fwd_kernel<TE, Idx>, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename Idx>
int launch(const FwdArgs<Idx>& a, int tile, cudaStream_t stream) {
  if (tile == 8) return launch<8, Idx>(a, stream);
  if (tile == 16) return launch<16, Idx>(a, stream);
  if (tile == 32) return launch<32, Idx>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the first cudaError_t
// (0 = success).  Shapes and types are checked, the receiver CSR built and
// the buffers allocated by the Python wrapper (ops/egnn_stack.py): msg_e
// [E, D] and pos_e [E, 3] scratch, h [N, D] and pos [N, 3] the result, bar two
// zeroed 32-bit counters; tile one of 8, 16 and 32; stamps null, or 2L + 1
// 64-bit slots for the clock at the start and after each phase.

extern "C" const char* gmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int gmp_egnn_stack_fwd(
    int device, const void* send, const void* recv, int idx64,
    const void* emask, const void* h0, const void* pos0, const void* w,
    const void* order, const void* rowptr, void* msg_e, void* pos_e, void* h,
    void* pos, void* bar, void* stamps, int N, int E, int D, int L, int tile,
    void* stream) {
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
                         static_cast<unsigned int*>(bar),
                         static_cast<unsigned long long*>(stamps), N, E, D, L};
    return launch(a, tile, s);
  }
  FwdArgs<int> a{static_cast<const int*>(send), static_cast<const int*>(recv),
                 static_cast<const uint8_t*>(emask),
                 static_cast<const float*>(h0), static_cast<const float*>(pos0),
                 static_cast<const float*>(w),
                 static_cast<const int64_t*>(order),
                 static_cast<const int64_t*>(rowptr),
                 static_cast<float*>(msg_e), static_cast<float*>(pos_e),
                 static_cast<float*>(h), static_cast<float*>(pos),
                 static_cast<unsigned int*>(bar),
                 static_cast<unsigned long long*>(stamps), N, E, D, L};
  return launch(a, tile, s);
}
