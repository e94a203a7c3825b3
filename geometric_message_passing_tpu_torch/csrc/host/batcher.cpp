// Host-side graph batcher: fills the padded static-shape batch arrays of a
// whole epoch in one call (the port's GraphLoader.stage_epochs), in place
// of a per-graph Python loop over graph.batch_graphs.
//
// Layout contract mirrors graph.GraphBatch: pad nodes/edges at the tail,
// pad edges self-loop on node n_pad-1, pad nodes/graphs masked out,
// graph_id of pad nodes = g_pad-1, first_node per graph.
//
// Built and bound by ops/_host_build.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Build `num_batches` consecutive batches covering `order[0..num_take)` in
// chunks of `batch_size` graphs.
// Dataset arrays are the concatenation over graphs (original order);
// node_off/edge_off give each graph's start.
void gmp_build_batches(
    const int32_t* atoms, const float* pos,
    const int32_t* esrc, const int32_t* edst,   // graph-local edge indices
    const float* ys, int32_t y_dim,
    const int32_t* n_nodes, const int32_t* n_edges,
    const int64_t* node_off, const int64_t* edge_off,
    const int32_t* order, int32_t num_take,
    int32_t batch_size, int32_t n_pad, int32_t e_pad, int32_t g_pad,
    // outputs, each with leading dim num_batches = ceil(num_take/batch_size)
    int32_t* out_atoms, float* out_pos,
    int32_t* out_send, int32_t* out_recv,
    int32_t* out_gid, float* out_y,
    uint8_t* out_nmask, uint8_t* out_emask, uint8_t* out_gmask,
    int32_t* out_first)
{
    const int32_t num_batches = (num_take + batch_size - 1) / batch_size;
    for (int32_t b = 0; b < num_batches; ++b) {
        int32_t* b_atoms = out_atoms + (int64_t)b * n_pad;
        float*   b_pos   = out_pos   + (int64_t)b * n_pad * 3;
        int32_t* b_send  = out_send  + (int64_t)b * e_pad;
        int32_t* b_recv  = out_recv  + (int64_t)b * e_pad;
        int32_t* b_gid   = out_gid   + (int64_t)b * n_pad;
        float*   b_y     = out_y     + (int64_t)b * g_pad * y_dim;
        uint8_t* b_nm    = out_nmask + (int64_t)b * n_pad;
        uint8_t* b_em    = out_emask + (int64_t)b * e_pad;
        uint8_t* b_gm    = out_gmask + (int64_t)b * g_pad;
        int32_t* b_first = out_first + (int64_t)b * g_pad;

        // defaults
        std::memset(b_atoms, 0, sizeof(int32_t) * n_pad);
        std::memset(b_pos, 0, sizeof(float) * n_pad * 3);
        std::fill(b_send, b_send + e_pad, n_pad - 1);
        std::fill(b_recv, b_recv + e_pad, n_pad - 1);
        std::fill(b_gid, b_gid + n_pad, g_pad - 1);
        std::memset(b_y, 0, sizeof(float) * g_pad * y_dim);
        std::memset(b_nm, 0, n_pad);
        std::memset(b_em, 0, e_pad);
        std::memset(b_gm, 0, g_pad);
        std::fill(b_first, b_first + g_pad, n_pad - 1);

        int32_t n_off = 0, e_off = 0;
        const int32_t begin = b * batch_size;
        const int32_t end = std::min(begin + batch_size, num_take);
        for (int32_t gi = begin; gi < end; ++gi) {
            const int32_t g = order[gi];
            const int32_t local = gi - begin;
            const int32_t nn = n_nodes[g];
            const int32_t ne = n_edges[g];
            const int64_t no = node_off[g];
            const int64_t eo = edge_off[g];
            std::memcpy(b_atoms + n_off, atoms + no, sizeof(int32_t) * nn);
            std::memcpy(b_pos + (int64_t)n_off * 3, pos + no * 3,
                        sizeof(float) * nn * 3);
            for (int32_t e = 0; e < ne; ++e) {
                b_send[e_off + e] = esrc[eo + e] + n_off;
                b_recv[e_off + e] = edst[eo + e] + n_off;
            }
            for (int32_t n = 0; n < nn; ++n) b_gid[n_off + n] = local;
            std::memset(b_nm + n_off, 1, nn);
            std::memset(b_em + e_off, 1, ne);
            b_gm[local] = 1;
            b_first[local] = n_off;
            std::memcpy(b_y + (int64_t)local * y_dim, ys + (int64_t)g * y_dim,
                        sizeof(float) * y_dim);
            n_off += nn;
            e_off += ne;
        }
    }
}

}  // extern "C"
