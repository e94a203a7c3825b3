// Host-side triplet/quad enumerator: the native twin of the numpy
// triplets.py::build_triplets_plain.
//
// Semantics contract (must match triplets.py exactly):
//   * in-edges of node n are ordered by (dst=n, src) with original edge
//     order breaking ties (numpy lexsort((src, dst)) stability);
//   * for each directed edge e=(j->i), each in-edge e2=(k->j) with k != i
//     emits triplet (i, j, k, e2, e) in e-major order;
//   * with_quads: for each triplet t, each in-neighbor k_n of j with
//     k_n != i emits quad (t, k_n).
//
// Two-pass C ABI: gmp_count_triplets fills {nt, nq}; gmp_fill_triplets
// writes caller-allocated arrays.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct InEdges {
    // CSR of in-edges sorted by (dst, src, edge-id)
    std::vector<int64_t> off;      // [N+1]
    std::vector<int32_t> eid;      // [E]
    std::vector<int32_t> src;      // [E]
};

InEdges build_in_edges(const int32_t* esrc, const int32_t* edst,
                       int32_t num_edges, int32_t num_nodes) {
    InEdges in;
    in.off.assign((size_t)num_nodes + 1, 0);
    for (int32_t e = 0; e < num_edges; ++e) in.off[(size_t)edst[e] + 1]++;
    for (int32_t n = 0; n < num_nodes; ++n) in.off[n + 1] += in.off[n];
    std::vector<int64_t> cur(in.off.begin(), in.off.end() - 1);
    in.eid.resize(num_edges);
    in.src.resize(num_edges);
    for (int32_t e = 0; e < num_edges; ++e) {   // stable: edge-id order
        int64_t p = cur[edst[e]]++;
        in.eid[p] = e;
        in.src[p] = esrc[e];
    }
    // stable sort each node's slice by src (keeps edge-id order on ties,
    // matching lexsort((src, dst)))
    std::vector<int64_t> perm;
    for (int32_t n = 0; n < num_nodes; ++n) {
        int64_t a = in.off[n], b = in.off[n + 1];
        if (b - a < 2) continue;
        perm.resize(b - a);
        for (int64_t t = 0; t < b - a; ++t) perm[t] = t;
        std::stable_sort(perm.begin(), perm.end(),
                         [&](int64_t x, int64_t y) {
                             return in.src[a + x] < in.src[a + y];
                         });
        std::vector<int32_t> te(b - a), ts(b - a);
        for (int64_t t = 0; t < b - a; ++t) {
            te[t] = in.eid[a + perm[t]];
            ts[t] = in.src[a + perm[t]];
        }
        std::copy(te.begin(), te.end(), in.eid.begin() + a);
        std::copy(ts.begin(), ts.end(), in.src.begin() + a);
    }
    return in;
}

}  // namespace

extern "C" {

void gmp_count_triplets(const int32_t* esrc, const int32_t* edst,
                        int32_t num_edges, int32_t num_nodes,
                        int32_t with_quads, int64_t* out_counts) {
    InEdges in = build_in_edges(esrc, edst, num_edges, num_nodes);
    int64_t nt = 0, nq = 0;
    for (int32_t e = 0; e < num_edges; ++e) {
        int32_t j = esrc[e], i = edst[e];
        int64_t a = in.off[j], b = in.off[j + 1];
        int64_t deg = 0;
        for (int64_t p = a; p < b; ++p) deg += (in.src[p] != i);
        nt += deg;
        if (with_quads) nq += deg * deg;
    }
    out_counts[0] = nt;
    out_counts[1] = nq;
}

void gmp_fill_triplets(const int32_t* esrc, const int32_t* edst,
                       int32_t num_edges, int32_t num_nodes,
                       int32_t with_quads,
                       int32_t* idx_i, int32_t* idx_j, int32_t* idx_k,
                       int32_t* idx_kj, int32_t* idx_ji,
                       int32_t* q_trip, int32_t* q_kn) {
    InEdges in = build_in_edges(esrc, edst, num_edges, num_nodes);
    int64_t t = 0, q = 0;
    for (int32_t e = 0; e < num_edges; ++e) {
        int32_t j = esrc[e], i = edst[e];
        int64_t a = in.off[j], b = in.off[j + 1];
        for (int64_t p = a; p < b; ++p) {
            int32_t k = in.src[p];
            if (k == i) continue;
            idx_i[t] = i;
            idx_j[t] = j;
            idx_k[t] = k;
            idx_kj[t] = in.eid[p];
            idx_ji[t] = e;
            if (with_quads) {
                for (int64_t p2 = a; p2 < b; ++p2) {
                    int32_t kn = in.src[p2];
                    if (kn == i) continue;
                    q_trip[q] = (int32_t)t;
                    q_kn[q] = kn;
                    ++q;
                }
            }
            ++t;
        }
    }
}

}  // extern "C"
