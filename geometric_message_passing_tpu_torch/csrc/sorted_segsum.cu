// Segment sums for Hopper (sm_90a): exact f32, no floating-point atomics.
//
// Replaces two TPU kernels that compute the same function:
//   * geometric_message_passing_tpu/ops/pallas_sorted_segsum.py::_sorted_kernel
//     (K3): the masked segment sum of segment-sorted [E, D] rows into [N, D],
//     the box-scale path's every segment reduction and gather backward, and
//     the triplet fold of DimeNet++ and SphereNet;
//   * geometric_message_passing_tpu/ops/pallas_edge.py::_segsum_kernel (K4):
//     the masked segment sum over unsorted ids.
// The TPU forms the sums as one-hot matrix products on its matrix unit (at
// HIGHEST precision, to keep f32 exact).  Here the sum is what it is, an
// indexed row sum:
//
//   out[s, :] = acc[s, :] + sum of data[r, :] over the live rows r of s
//
// (acc optional), each segment's rows added in ascending order, in the
// data's type.  Every output row is written (acc, or 0, when empty).
//
// Two routes, one block kernel (segsum_block):
//   * CSR (K3, and K4 above the scan route's row limit): the rows of segment
//     s are rowptr[s] .. rowptr[s+1] of a plan (through perm, or in place),
//     with an optional row mask read in the kernel (the fold's pad rows);
//   * scan (K4 up to the row limit): no plan and no sort.  Each block owns S
//     consecutive segments and reads the ids (int32 or int64) and the mask in
//     tiles of 2048, keeping the rows that fall in its segments by a stable
//     block-wide compaction (warp ballots and prefix counts, in row order);
//     a stable counting sort of that list by segment in shared memory
//     (per-warp counts, one exclusive scan, __match_any_sync ranks) then
//     gives each segment its rows in ascending order.  Ids outside [0, N)
//     and masked rows are dropped.
//
// What bounds it: bytes.  One add per element read; at the box path's widest
// shape (E 1.35M live rows, D 128) it reads 692 MB and writes 51 MB, some
// 0.22 ms at 3.35 TB/s, against 0.17 GFLOP.  At the star buckets (E ~1-4k)
// the work is microseconds: launches and the host are the cost there, so the
// scan route does in one launch what the CSR route needs a device sort for.
//
// What the design does about it: a group of P lanes (P = the vector columns
// rounded up to a power of two, at most 32) takes a segment, so each row is
// read as 16-byte float4 loads (D % 4 == 0 and 16-byte aligned) or floats,
// and narrow rows put 32 / P segments in one warp instead of leaving lanes
// idle; the row loop is unrolled so several rows' loads are in flight.  A
// segment of at least long_rows rows (an embedding's gradient: all rows of a
// batch in one segment) is split across the lane groups of a cluster of C
// blocks (C = 8 for the small, latency-bound calls; 1 on the box), each
// group adding every (C x 8 x 32 / P)-th row, the rows' list copied from the
// owning block's shared memory (distributed shared memory); each block adds
// its groups' partials in group order through shared memory, and the
// cluster's first block adds the block sums in rank order.  Cluster
// barriers run only in a cluster that holds a long segment: every block
// counts the cluster's segment lengths while it reads the ids (or reads
// them from the plan), so all know it without a barrier.  When the
// segments are few and long (a pool of a whole box: at least 1024 rows a
// segment on average, chosen by the wrapper) the rows of each segment are
// cut into G chunks over G blocks
// of 32 warps (segsum_chunks) and a second kernel adds each segment's G
// partial rows in order (segsum_combine).  Every path fixes its order of
// addition, so two runs stay bitwise equal; a segment summed by one lane
// group adds its rows in the order the previous warp-per-segment design did,
// so it is bitwise equal to it.
//
// Each kernel is instantiated for double too (the _f64 entries): the float64
// reference runs on the card sum through them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 8;         // ids per thread per tile of the scan
constexpr int kMaxSegs = 512;        // segments a scan block owns at most
constexpr int kRowBits = 22;         // scan list entry: row | local seg << 22
constexpr uint32_t kRowMask = (1u << kRowBits) - 1;
constexpr int kMaxSmem = 232448;     // bytes of shared memory a block may use
constexpr int kChunkWarps = 32;
constexpr int kChunkCols = 128;      // columns per pass of the chunk kernel
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// ---- element access: V is float4 (4 floats at once), float or double ----

__device__ __forceinline__ float4 vzero(float4*) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float vzero(float*) { return 0.f; }
__device__ __forceinline__ double vzero(double*) { return 0.0; }

__device__ __forceinline__ void vadd(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}
__device__ __forceinline__ void vadd(float& a, float v) { a += v; }
__device__ __forceinline__ void vadd(double& a, double v) { a += v; }

// acc + a, element by element (the order of `acc + fold`)
template <typename V>
__device__ __forceinline__ V plus(const V* __restrict__ acc, int64_t i, V a) {
  if (acc == nullptr) return a;
  V r = __ldg(acc + i);
  vadd(r, a);
  return r;
}

// ---- where a segment's rows are ----

// CSR: list positions rowptr[s] .. rowptr[s+1], row perm[k] (or k).
template <bool kPerm>
struct CsrRows {
  const int64_t* __restrict__ perm;
  __device__ __forceinline__ int64_t operator()(int64_t k) const {
    return kPerm ? __ldg(perm + k) : k;
  }
};

// scan: the block's sorted list in shared memory.
struct ListRows {
  const int* list;
  __device__ __forceinline__ int64_t operator()(int64_t k) const {
    return list[k];
  }
};

// One lane group (P lanes, sub = lane % P) sums segment s, rows beg .. end
// of its list, columns sub, sub + P, ...
template <typename V, bool kMask, class Rows>
__device__ __forceinline__ void group_sum(
    const V* __restrict__ data, const uint8_t* __restrict__ mask,
    const V* __restrict__ acc, V* __restrict__ out, Rows rows, int64_t s,
    int64_t beg, int64_t end, int cols, int P, int sub) {
  for (int c = sub; c < cols; c += P) {
    V a = vzero((V*)nullptr);
#pragma unroll 4
    for (int64_t k = beg; k < end; ++k) {
      const int64_t r = rows(k);
      if (kMask && !__ldg(mask + r)) continue;
      vadd(a, __ldg(data + r * cols + c));
    }
    out[s * cols + c] = plus(acc, s * cols + c, a);
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}
__device__ __forceinline__ void cluster_barrier(int C) {
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
}

// The whole cluster (C blocks) sums one long segment: lane group q of
// block `rank` adds the rows rank * R + q + j * C * R of the list (R lane
// groups a block); each block adds its R partials in group order, then
// rank 0 adds the C block sums in rank order, reading its peers' shared
// memory (distributed shared memory).  `part` holds R * P values, `bpart`
// P.  Called by every thread of the cluster.
template <typename V, bool kMask, class Rows>
__device__ __forceinline__ void cluster_sum(
    const V* __restrict__ data, const uint8_t* __restrict__ mask,
    const V* __restrict__ acc, V* __restrict__ out, Rows rows, int64_t s,
    int64_t beg, int64_t end, int cols, int P, int q, int sub, V* part,
    V* bpart, int rank, int C) {
  cg::cluster_group cluster = cg::this_cluster();
  const int R = kThreads / P;
  const int64_t stride = (int64_t)R * C;
  for (int c0 = 0; c0 < cols; c0 += P) {
    const int c = c0 + sub;
    V a = vzero((V*)nullptr);
    if (c < cols) {
#pragma unroll 4
      for (int64_t k = beg + (int64_t)rank * R + q; k < end; k += stride) {
        const int64_t r = rows(k);
        if (kMask && !__ldg(mask + r)) continue;
        vadd(a, __ldg(data + r * cols + c));
      }
    }
    part[q * P + sub] = a;
    __syncthreads();
    if (q == 0) {
      V t = part[sub];
      for (int g = 1; g < R; ++g) vadd(t, part[g * P + sub]);
      bpart[sub] = t;
    }
    cluster_barrier(C);
    if (rank == 0 && q == 0 && c < cols) {
      V t = bpart[sub];
      for (int r = 1; r < C; ++r) vadd(t, cluster.map_shared_rank(bpart, r)[sub]);
      out[s * cols + c] = plus(acc, s * cols + c, t);
    }
    cluster_barrier(C);
  }
}

struct Smem {
  void* part;      // kThreads values of V
  void* bpart;     // 32 values of V: the block's sum (cluster_sum)
  int64_t* lrp;    // [S + 1] list offsets of the block's segments
  int* longs;      // [S + 1] the long segments, their count last
  int* wcnt;       // [kTileRows * kWarps] compaction counts
  int* cnt;        // [S * kWarps] counting-sort counters (scan)
  int* ccnt;       // [C * S] rows of each segment of the cluster (scan, C > 1)
  int* clong;      // [C * S + 1] the cluster's long segments, count last (C > 1)
  uint32_t* list;  // [E] compacted rows (scan)
  int* sorted;     // [E] rows by segment (scan)
};

// The next 16-byte-aligned piece of `bytes` at base + *off.
__host__ __device__ inline char* take(char* base, int64_t* off, int64_t bytes) {
  char* p = base + *off;
  *off = (*off + bytes + 15) & ~(int64_t)15;
  return p;
}

// The layout of the dynamic shared memory; returns its size in bytes.
__host__ __device__ inline int64_t smem_layout(char* base, int vbytes, int S,
                                               int C, int64_t E, bool scan,
                                               Smem* sm) {
  int64_t off = 0;
  Smem m{};
  m.part = take(base, &off, (int64_t)kThreads * vbytes);
  m.bpart = take(base, &off, 32 * (int64_t)vbytes);
  m.lrp = reinterpret_cast<int64_t*>(take(base, &off, 8 * (int64_t)(S + 1)));
  m.longs = reinterpret_cast<int*>(take(base, &off, 4 * (int64_t)(S + 1)));
  if (C > 1)
    m.clong = reinterpret_cast<int*>(take(base, &off, 4 * ((int64_t)S * C + 1)));
  if (scan) {
    m.wcnt = reinterpret_cast<int*>(take(base, &off, 4 * (kTileRows * kWarps + 4)));
    m.cnt = reinterpret_cast<int*>(take(base, &off, 4 * (int64_t)S * kWarps));
    if (C > 1) m.ccnt = reinterpret_cast<int*>(take(base, &off, 4 * (int64_t)S * C));
    m.list = reinterpret_cast<uint32_t*>(take(base, &off, 4 * E));
    m.sorted = reinterpret_cast<int*>(take(base, &off, 4 * E));
  }
  if (sm) *sm = m;
  return off;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Exclusive scan of a[0 .. n) in place by the whole block (n <= kMaxSegs *
// kWarps); `tmp` holds kWarps + 1 ints.
__device__ void block_exclusive_scan(int* a, int n, int* tmp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += a[i];
  int incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int v = tmp[w];
      tmp[w] = run;
      run += v;
    }
  }
  __syncthreads();
  int run = tmp[warp] + incl - local;
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
}

// The scan route's lists: the rows of segments s0 .. s0 + S - 1 that are
// live (mask) with their ids, compacted in row order into sm.list, then
// sorted stably by segment into sm.sorted; sm.lrp gets each segment's list
// offsets.
template <typename Id>
__device__ void build_lists(const Id* __restrict__ ids,
                            const uint8_t* __restrict__ mask, int64_t E,
                            int64_t s0, int S, int64_t c0, int CS,
                            const Smem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = lanemask_lt();
  int* total = sm.wcnt + kTileRows * kWarps;   // rows kept so far
  if (tid == 0) *total = 0;
  for (int i = tid; i < CS; i += kThreads) sm.ccnt[i] = 0;
  __syncthreads();
  for (int64_t base = 0; base < E; base += (int64_t)kThreads * kTileRows) {
    const int m = *total;   // written by warp 0 only after the next barrier
    int64_t id[kTileRows];
    bool keep[kTileRows];
#pragma unroll
    for (int j = 0; j < kTileRows; ++j) {
      const int64_t r = base + (int64_t)j * kThreads + tid;
      id[j] = r < E ? (int64_t)__ldg(ids + r) : -1;
      keep[j] = r < E && (mask == nullptr || __ldg(mask + r));
    }
    if (CS > 0) {  // the cluster's segment lengths, warp by warp
#pragma unroll
      for (int j = 0; j < kTileRows; ++j) {
        const bool in = keep[j] && id[j] >= c0 && id[j] < c0 + CS;
        const unsigned key = in ? (unsigned)(id[j] - c0) : kFull;
        const unsigned peers = __match_any_sync(kFull, key);
        if (in && lane == __ffs(peers) - 1)
          atomicAdd(sm.ccnt + key, __popc(peers));
      }
    }
    unsigned bal[kTileRows];
#pragma unroll
    for (int j = 0; j < kTileRows; ++j) {
      keep[j] = keep[j] && id[j] >= s0 && id[j] < s0 + S;
      bal[j] = __ballot_sync(kFull, keep[j]);
      if (lane == 0) sm.wcnt[j * kWarps + warp] = __popc(bal[j]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the kTileRows * kWarps = 64 counts
      const int a = sm.wcnt[2 * lane], b = sm.wcnt[2 * lane + 1];
      int incl = a + b;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      sm.wcnt[2 * lane] = incl - a - b;
      sm.wcnt[2 * lane + 1] = incl - b;
      if (lane == 31) *total = m + incl;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kTileRows; ++j) {
      if (keep[j]) {
        const int64_t r = base + (int64_t)j * kThreads + tid;
        sm.list[m + sm.wcnt[j * kWarps + warp] + __popc(bal[j] & lt)] =
            (uint32_t)r | ((uint32_t)(id[j] - s0) << kRowBits);
      }
    }
    __syncthreads();
  }
  const int M = *total;
  if (S == 1) {  // one segment: the list is its rows, in order
    for (int k = tid; k < M; k += kThreads) sm.sorted[k] = (int)(sm.list[k] & kRowMask);
    if (tid == 0) {
      sm.lrp[0] = 0;
      sm.lrp[1] = M;
    }
    __syncthreads();
    return;
  }
  // stable counting sort by segment: warp w takes list[M w / 8, M (w+1) / 8)
  for (int i = tid; i < S * kWarps; i += kThreads) sm.cnt[i] = 0;
  __syncthreads();
  const int pb = (int)((int64_t)M * warp / kWarps);
  const int pe = (int)((int64_t)M * (warp + 1) / kWarps);
  for (int c0 = pb; c0 < pe; c0 += 32) {
    const int k = c0 + lane;
    const bool valid = k < pe;
    const unsigned key = valid ? sm.list[k] >> kRowBits : kFull;
    const unsigned peers = __match_any_sync(kFull, key);
    if (valid && lane == __ffs(peers) - 1)
      sm.cnt[key * kWarps + warp] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  block_exclusive_scan(sm.cnt, S * kWarps, sm.wcnt);
  for (int c0 = pb; c0 < pe; c0 += 32) {
    const int k = c0 + lane;
    const bool valid = k < pe;
    const uint32_t e = valid ? sm.list[k] : 0u;
    const unsigned key = valid ? e >> kRowBits : kFull;
    const unsigned peers = __match_any_sync(kFull, key);
    int* slot = sm.cnt + (valid ? key * kWarps + warp : 0);
    if (valid) sm.sorted[*slot + __popc(peers & lt)] = (int)(e & kRowMask);
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) *slot += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // after the placement cnt[i * kWarps + kWarps - 1] is segment i's end
  if (tid == 0) sm.lrp[0] = 0;
  for (int i = tid; i < S; i += kThreads)
    sm.lrp[i + 1] = sm.cnt[i * kWarps + kWarps - 1];
  __syncthreads();
}

struct Args {
  const void* data;
  const int64_t* perm;     // CSR: [rows] or null (identity)
  const int64_t* rowptr;   // CSR: [N + 1]
  const void* ids;         // scan: [E] int32 or int64
  const uint8_t* mask;     // [E] or null
  const void* acc;         // [N, D] or null
  void* out;               // [N, D]
  int64_t E;
  int N, cols, P, S, C, long_rows;   // S segments a block, C blocks a cluster
};

// Block b: segments b * S .. b * S + S - 1, in clusters of C consecutive
// blocks (C = 1: a block alone).  Each block finds the rows of its own
// segments (scan: its lists in shared memory; CSR: the plan's row pointers)
// and, when C > 1, whether any segment of its cluster is long (scan: it
// counts the cluster's rows while it reads the ids; CSR: the row pointers),
// the same answer in every block of the cluster.  A block sums its own long
// segments itself (C = 1) or, when the cluster has one, the whole cluster
// sums every long segment of the cluster (cluster_sum), its bounds and rows
// read from the owning block's shared memory; the short segments are lane
// group q's: q, q + slots, ... of its block (slots = 8 x 32 / P).  Cluster
// barriers run only in a cluster that has a long segment.  On the CSR
// route with C = 1 (S = slots) lane group q reads its one segment's bounds
// itself and sums it at once if it is short; the block meets at a barrier
// only at the end, and stages its bounds only if a segment was long.
template <typename V, typename Id, bool kScan, bool kPerm, bool kMask>
__global__ void __launch_bounds__(kThreads) segsum_block(Args a) {
  extern __shared__ __align__(16) char smem_raw[];
  const int C = a.C;
  const int rank = (int)(blockIdx.x % C);
  const int64_t s0 = (int64_t)blockIdx.x * a.S;
  const int S = (int)(s0 >= a.N ? 0 : lmin(a.S, (int64_t)a.N - s0));
  const int64_t c0 = s0 - (int64_t)rank * a.S;   // the cluster's first segment
  const int CS = C > 1 ? (int)(c0 >= a.N ? 0 : lmin((int64_t)a.S * C,
                                                    (int64_t)a.N - c0))
                       : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = a.P, G = 32 / P, slots = kWarps * G;
  const int q = warp * G + lane / P, sub = lane % P;
  const V* data = static_cast<const V*>(a.data);
  const V* acc = static_cast<const V*>(a.acc);
  V* out = static_cast<V*>(a.out);
  bool shorts_done = false;
  if constexpr (!kScan) {
    if (C == 1) {
      int64_t beg = 0, end = 0;
      if (q < S) {
        beg = __ldg(a.rowptr + s0 + q);
        end = __ldg(a.rowptr + s0 + q + 1);
      }
      const bool is_long = end - beg >= a.long_rows;
      if (q < S && !is_long)
        group_sum<V, kMask>(data, a.mask, acc, out, CsrRows<kPerm>{a.perm},
                            s0 + q, beg, end, a.cols, P, sub);
      if (!__syncthreads_or(is_long)) return;
      shorts_done = true;
    }
  }
  Smem sm;
  smem_layout(smem_raw, (int)sizeof(V), a.S, C, kScan ? a.E : 0, kScan,
              &sm);
  // C > 1: the lengths of the cluster's segments, the same in every block
  auto cluster_len = [&](int i) -> int64_t {
    if constexpr (kScan) return sm.ccnt[i];
    else return __ldg(a.rowptr + c0 + i + 1) - __ldg(a.rowptr + c0 + i);
  };
  if constexpr (kScan) {
    build_lists<Id>(static_cast<const Id*>(a.ids), a.mask, a.E, s0, S, c0,
                    CS, sm);
  } else {
    if (S == 0 && tid == 0) sm.lrp[0] = 0;
    for (int i = tid; S > 0 && i <= S; i += kThreads)
      sm.lrp[i] = __ldg(a.rowptr + s0 + i);
  }
  bool any = false;
  for (int i = tid; i < CS; i += kThreads) any |= cluster_len(i) >= a.long_rows;
  const bool together = __syncthreads_or(any);   // the cluster has a long one
  if (warp == 0) {  // the long segments, in order: the cluster's or its own
    const int n = together ? CS : S;
    int* dst = together ? sm.clong : sm.longs;
    int n_long = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const bool is_long =
          i < n && (together ? cluster_len(i)
                             : sm.lrp[i + 1] - sm.lrp[i]) >= a.long_rows;
      const unsigned b = __ballot_sync(kFull, is_long);
      if (is_long) dst[n_long + __popc(b & lanemask_lt())] = i;
      n_long += __popc(b);
    }
    if (lane == 0) dst[together ? CS : a.S] = n_long;
  }
  __syncthreads();
  V* part = static_cast<V*>(sm.part);
  V* bpart = static_cast<V*>(sm.bpart);
  // scan: peers copy a long segment's rows from its owner's lists
  if (kScan && together) cluster_arrive();
  if (!shorts_done) {
    for (int i = q; i < S; i += slots) {
      const int64_t beg = sm.lrp[i], end = sm.lrp[i + 1];
      if (end - beg >= a.long_rows) continue;
      if constexpr (kScan)
        group_sum<V, false>(data, nullptr, acc, out, ListRows{sm.sorted},
                            s0 + i, beg, end, a.cols, P, sub);
      else
        group_sum<V, kMask>(data, a.mask, acc, out, CsrRows<kPerm>{a.perm},
                            s0 + i, beg, end, a.cols, P, sub);
    }
  }
  if (!together) {  // a block alone: its own long segments (only if C = 1)
    const int n_long = sm.longs[a.S];
    for (int j = 0; j < n_long; ++j) {
      const int i = sm.longs[j];
      if constexpr (kScan)
        cluster_sum<V, false>(data, nullptr, acc, out,
                                    ListRows{sm.sorted}, s0 + i, sm.lrp[i],
                                    sm.lrp[i + 1], a.cols, P, q, sub, part,
                                    bpart, 0, 1);
      else
        cluster_sum<V, kMask>(data, a.mask, acc, out,
                                     CsrRows<kPerm>{a.perm}, s0 + i, sm.lrp[i],
                                     sm.lrp[i + 1], a.cols, P, q, sub, part,
                                     bpart, 0, 1);
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  if constexpr (kScan) cluster_wait();   // every block's lists are ready
  const int n_long = sm.clong[CS];
  for (int j = 0; j < n_long; ++j) {
    const int i = sm.clong[j];   // the cluster's segment i: rank r's il
    const int r = i / a.S, il = i - r * a.S;
    if constexpr (kScan) {
      // its rows, in order, from the owner's list; a peer copies them into
      // its own compaction list, free by now (the previous cluster_sum's
      // last barrier saw every block done with it)
      const int len = sm.ccnt[i];
      const int* rows;
      if (r == rank) {
        rows = sm.sorted + sm.lrp[il];
      } else {
        const int64_t beg = cluster.map_shared_rank(sm.lrp, r)[il];
        const int* src = cluster.map_shared_rank(sm.sorted, r) + beg;
        int* dst = reinterpret_cast<int*>(sm.list);
        for (int k = tid; k < len; k += kThreads) dst[k] = src[k];
        __syncthreads();
        rows = dst;
      }
      cluster_sum<V, false>(data, nullptr, acc, out, ListRows{rows},
                                  c0 + i, 0, len, a.cols, P, q, sub, part,
                                  bpart, rank, C);
    } else {
      cluster_sum<V, kMask>(data, a.mask, acc, out,
                                   CsrRows<kPerm>{a.perm}, c0 + i,
                                   __ldg(a.rowptr + c0 + i),
                                   __ldg(a.rowptr + c0 + i + 1), a.cols, P, q,
                                   sub, part, bpart, rank, C);
    }
  }
  // every read of a peer's shared memory came before a barrier of the last
  // cluster_sum, so a block may leave
}

// Few, long segments, pass 1: block (seg, g) of 32 warps sums chunk g of
// G of segment seg into part[seg, g, :].  Per pass over kChunkCols columns:
// lane l of warp w sums columns c0 + l, c0 + l + 32, ... over the chunk's
// rows w, w + 32, ...; then thread t adds the 32 warps' partials of column
// c0 + t in warp order.
template <typename T, bool kPerm, bool kMask>
__global__ void __launch_bounds__(kChunkWarps * 32)
segsum_chunks(const T* __restrict__ data, const int64_t* __restrict__ perm,
              const int64_t* __restrict__ rowptr,
              const uint8_t* __restrict__ mask, T* __restrict__ part, int D,
              int G) {
  __shared__ T warp_sum[kChunkWarps][kChunkCols];
  const int64_t seg = blockIdx.x;
  const int g = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t beg = rowptr[seg], len = rowptr[seg + 1] - beg;
  const int64_t lo = beg + len * g / G, hi = beg + len * (g + 1) / G;
  T* __restrict__ dst = part + ((int64_t)seg * G + g) * D;
  for (int c0 = 0; c0 < D; c0 += kChunkCols) {
    T acc[kChunkCols / 32];
#pragma unroll
    for (int j = 0; j < kChunkCols / 32; ++j) acc[j] = 0;
#pragma unroll 2
    for (int64_t k = lo + warp; k < hi; k += kChunkWarps) {
      const int64_t r = kPerm ? __ldg(perm + k) : k;
      if (kMask && !__ldg(mask + r)) continue;
      const T* __restrict__ row = data + r * D;
#pragma unroll
      for (int j = 0; j < kChunkCols / 32; ++j) {
        const int c = c0 + lane + 32 * j;
        if (c < D) acc[j] += __ldg(row + c);
      }
    }
#pragma unroll
    for (int j = 0; j < kChunkCols / 32; ++j)
      warp_sum[warp][lane + 32 * j] = acc[j];
    __syncthreads();
    if (threadIdx.x < kChunkCols && c0 + (int)threadIdx.x < D) {
      T sum = 0;
      for (int w = 0; w < kChunkWarps; ++w) sum += warp_sum[w][threadIdx.x];
      dst[c0 + threadIdx.x] = sum;
    }
    __syncthreads();
  }
}

// Pass 2: out[seg, c] = acc[seg, c] + sum over g = 0 .. G-1 of
// part[seg, g, c], in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
segsum_combine(const T* __restrict__ part, const T* __restrict__ acc,
               T* __restrict__ out, int N, int D, int G) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)N * D) return;
  const int64_t seg = i / D, c = i % D;
  const T* __restrict__ src = part + seg * G * D + c;
  T sum = 0;
  for (int g = 0; g < G; ++g) sum += src[(int64_t)g * D];
  out[i] = acc ? acc[i] + sum : sum;
}

int lanes_for(int cols) {
  int P = 1;
  while (P < cols && P < 32) P <<= 1;
  return P;
}

template <typename V, typename Id, bool kScan, bool kPerm, bool kMask>
int launch_block(Args a, cudaStream_t stream) {
  const int64_t bytes =
      smem_layout(nullptr, (int)sizeof(V), a.S, a.C, kScan ? a.E : 0, kScan,
                  nullptr);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = segsum_block<V, Id, kScan, kPerm, kMask>;
  static int64_t opened = 48 * 1024;   // the default dynamic limit
  if (bytes > opened) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opened = kMaxSmem;
  }
  const int64_t clusters = ((int64_t)a.N + (int64_t)a.S * a.C - 1) /
                           ((int64_t)a.S * a.C);
  const unsigned blocks = (unsigned)(clusters * a.C);
  if (a.C == 1) {
    kernel<<<blocks, kThreads, (size_t)bytes, stream>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename V>
int csr_route(Args a, cudaStream_t stream) {
  if (a.perm && a.mask) return launch_block<V, int, false, true, true>(a, stream);
  if (a.perm) return launch_block<V, int, false, true, false>(a, stream);
  if (a.mask) return launch_block<V, int, false, false, true>(a, stream);
  return launch_block<V, int, false, false, false>(a, stream);
}

template <typename V>
int scan_route(Args a, bool idx64, cudaStream_t stream) {
  return idx64 ? launch_block<V, int64_t, true, false, false>(a, stream)
               : launch_block<V, int, true, false, false>(a, stream);
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Picks the element type and lane groups, then the route.  scan_blocks > 0
// selects the scan route (ids), aiming at that many blocks; else the CSR
// route, chunked when G > 0.
template <typename T>
int run(int device, const void* data, const void* perm, const void* rowptr,
        const void* ids, int idx64, const void* mask, const void* acc,
        void* out, int64_t E, int N, int D, int G, void* scratch,
        int long_rows, int scan_blocks, int cluster, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scan_blocks <= 0 && G > 0) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const T* x = static_cast<const T*>(data);
    const int64_t* p = static_cast<const int64_t*>(perm);
    const int64_t* r = static_cast<const int64_t*>(rowptr);
    const uint8_t* m = static_cast<const uint8_t*>(mask);
    T* part = static_cast<T*>(scratch);
    const dim3 grid((unsigned)N, (unsigned)G), block(kChunkWarps * 32);
    if (p && m)
      segsum_chunks<T, true, true><<<grid, block, 0, s>>>(x, p, r, m, part,
                                                         D, G);
    else if (p)
      segsum_chunks<T, true, false><<<grid, block, 0, s>>>(x, p, r, m, part,
                                                          D, G);
    else if (m)
      segsum_chunks<T, false, true><<<grid, block, 0, s>>>(x, p, r, m, part,
                                                          D, G);
    else
      segsum_chunks<T, false, false><<<grid, block, 0, s>>>(x, p, r, m, part,
                                                           D, G);
    const int64_t blocks = ((int64_t)N * D + kThreads - 1) / kThreads;
    segsum_combine<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        part, static_cast<const T*>(acc), static_cast<T*>(out), N, D, G);
    return (int)cudaGetLastError();
  }
  const bool vec4 = sizeof(T) == 4 && D % 4 == 0 && aligned16(data) &&
                    aligned16(acc) && aligned16(out);
  Args a{data, static_cast<const int64_t*>(perm),
         static_cast<const int64_t*>(rowptr), ids,
         static_cast<const uint8_t*>(mask), acc, out, E, N, 0, 0, 0, 1,
         long_rows};
  a.cols = vec4 ? D / 4 : D;
  a.P = lanes_for(a.cols);
  const int slots = kWarps * (32 / a.P);   // lane groups a block
  a.C = cluster > 1 ? (cluster < 8 ? cluster : 8) : 1;
  if (scan_blocks > 0) {
    if (E >= ((int64_t)1 << kRowBits)) return (int)cudaErrorInvalidValue;
    // segments a lane group takes, so that about scan_blocks blocks run
    const int64_t per = ((int64_t)N + (int64_t)slots * scan_blocks - 1) /
                        ((int64_t)slots * scan_blocks);
    const int64_t most = kMaxSegs / slots;
    a.S = (int)(slots * lmin(per, most > 0 ? most : 1));
  } else {
    a.S = slots;
  }
  if (vec4)
    return scan_blocks > 0 ? scan_route<float4>(a, idx64, s)
                           : csr_route<float4>(a, s);
  return scan_blocks > 0 ? scan_route<T>(a, idx64, s) : csr_route<T>(a, s);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the cudaError_t of the
// launch (0 = success).  data [E, D] f32 (f64 for the _f64 entries) and out
// [N, D] of data's type, mask [E] bytes (or null), all contiguous on one
// device.
//   gmp_segsum_csr: perm [rows] int64 or null (identity), rowptr [N+1]
//     int64, acc [N, D] of data's type or null; G > 0 selects the chunked
//     path, with scratch [N, G, D];
//   gmp_segsum_scan: ids [E] int32 (idx64 0) or int64 (idx64 1), no plan;
//     scan_blocks is the number of blocks to aim for (each block reads all
//     the ids).
// long_rows: rows from which one segment is split across a block (and its
// cluster); cluster: blocks a cluster, at most 8 (1: no cluster).  The
// Python wrapper (ops/sorted_segsum.py) checks the tensors and picks the
// route.

extern "C" const char* gmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int gmp_segsum_csr(int device, const void* data, const void* perm,
                              const void* rowptr, const void* mask,
                              const void* acc, void* out, int N, int D, int G,
                              void* scratch, int long_rows, int cluster,
                              void* stream) {
  return run<float>(device, data, perm, rowptr, nullptr, 0, mask, acc, out, 0,
                    N, D, G, scratch, long_rows, 0, cluster, stream);
}

extern "C" int gmp_segsum_csr_f64(int device, const void* data,
                                  const void* perm, const void* rowptr,
                                  const void* mask, const void* acc, void* out,
                                  int N, int D, int G, void* scratch,
                                  int long_rows, int cluster, void* stream) {
  return run<double>(device, data, perm, rowptr, nullptr, 0, mask, acc, out,
                     0, N, D, G, scratch, long_rows, 0, cluster, stream);
}

extern "C" int gmp_segsum_scan(int device, const void* data, const void* ids,
                               int idx64, const void* mask, void* out,
                               long long E, int N, int D, int long_rows,
                               int scan_blocks, int cluster, void* stream) {
  return run<float>(device, data, nullptr, nullptr, ids, idx64, mask, nullptr,
                    out, E, N, D, 0, nullptr, long_rows, scan_blocks, cluster,
                    stream);
}

extern "C" int gmp_segsum_scan_f64(int device, const void* data,
                                   const void* ids, int idx64,
                                   const void* mask, void* out, long long E,
                                   int N, int D, int long_rows,
                                   int scan_blocks, int cluster,
                                   void* stream) {
  return run<double>(device, data, nullptr, nullptr, ids, idx64, mask,
                     nullptr, out, E, N, D, 0, nullptr, long_rows, scan_blocks,
                     cluster, stream);
}
