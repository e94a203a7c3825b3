"""Spatial graph partitioning for edge-partitioned ("gp") execution (port
of ``parallel/partition.py``).

``halo.build_halo_plan`` gives rank p the node rows ``[p * n_local, (p +
1) * n_local)``: a good partition of a molecular box only if atoms close in
space have close indices.  The Morton (Z-order) relabeling makes it so:
positions are quantised to a 3-D grid, the coordinate bits interleaved
into one key, and the nodes renumbered in key order, so index blocks are
compact spatial bricks and the boundary fraction (the halo's wire bytes)
falls to the bricks' surface-to-volume ratio.  Host-side numpy, bitwise
the JAX package's.
"""

from __future__ import annotations

import numpy as np

from ..graph import Graph


def morton_key(pos: np.ndarray, bits: int = 10) -> np.ndarray:
    """Z-order key of each row of ``pos`` [n, 3]: every coordinate
    quantised to ``bits`` bits over the bounding box, the bits interleaved
    (x_i y_i z_i ... x_0 y_0 z_0); int64, ``3 * bits <= 63``."""
    if 3 * bits > 63:
        raise ValueError(f"3 * bits must be at most 63, got bits {bits}")
    p = np.asarray(pos, np.float64)
    lo = p.min(axis=0)
    span = np.maximum(p.max(axis=0) - lo, 1e-12)
    q = np.minimum(((p - lo) / span * (2 ** bits)).astype(np.int64),
                   2 ** bits - 1)
    key = np.zeros(p.shape[0], np.int64)
    for b in range(bits):
        for c in range(3):
            key |= ((q[:, c] >> b) & 1) << (3 * b + (2 - c))
    return key


def morton_permutation(pos: np.ndarray, bits: int = 10) -> np.ndarray:
    """``perm[new_index] = old_index``, nodes in Morton key order (stable)."""
    return np.argsort(morton_key(pos, bits), kind="stable")


def permute_graph_nodes(g: Graph, perm: np.ndarray) -> Graph:
    """Relabel nodes: new node i is old node ``perm[i]``.  The edges are
    relabeled and keep their order (per-edge arrays stay aligned)."""
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return Graph(atoms=g.atoms[perm], edge_index=inv[g.edge_index],
                 pos=g.pos[perm], y=g.y)


def morton_partition_graph(g: Graph, bits: int = 10) -> Graph:
    """``g`` Morton-relabeled, so index blocks are spatial bricks (compose
    with ``halo.build_halo_plan``)."""
    return permute_graph_nodes(g, morton_permutation(g.pos, bits))


def partition_stats(senders, receivers, num_nodes: int, k: int,
                    edge_mask=None) -> dict:
    """Interior / boundary accounting of the index-block partition into
    ``k`` blocks: edges whose source the target's rank owns, the others,
    and the unique boundary sources summed over ranks (what the packed
    halo moves)."""
    s = np.asarray(senders)
    r = np.asarray(receivers)
    m = (np.ones_like(s, bool) if edge_mask is None
         else np.asarray(edge_mask, bool))
    n_local = num_nodes // k
    os_, ot = s // n_local, r // n_local
    interior = int(np.sum(m & (os_ == ot)))
    boundary = int(np.sum(m & (os_ != ot)))
    uniq = 0
    for q in range(k):
        uniq += np.unique(s[m & (ot == q) & (os_ != q)]).size
    return {
        "k": k,
        "edges": interior + boundary,
        "interior_edges": interior,
        "boundary_edges": boundary,
        "boundary_fraction": boundary / max(interior + boundary, 1),
        "unique_boundary_sources": uniq,
    }
