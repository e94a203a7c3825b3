"""ctypes wrappers of the host C++ graph code (port of the JAX package's
``native/batch.py``): the flattened dataset and the epoch batcher
(``csrc/host/batcher.cpp``), and the triplet / quad enumerator
(``csrc/host/triplets.cpp``).  The library is built on first use by
``ops/_host_build.py``; a failed build raises."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..ops import _host_build


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class FlatDataset:
    """Concatenated, C-contiguous view of a list of Graphs (built once):
    atoms, positions, graph-local edges and float32 targets of every graph
    in order, with each graph's node and edge counts and offsets."""

    def __init__(self, graphs: Sequence):
        self.n = len(graphs)
        self.n_nodes = np.asarray([g.num_nodes for g in graphs], np.int32)
        self.n_edges = np.asarray([g.num_edges for g in graphs], np.int32)
        self.node_off = np.zeros(self.n, np.int64)
        self.edge_off = np.zeros(self.n, np.int64)
        np.cumsum(self.n_nodes[:-1], out=self.node_off[1:])
        np.cumsum(self.n_edges[:-1], out=self.edge_off[1:])
        self.atoms = np.ascontiguousarray(
            np.concatenate([g.atoms for g in graphs]), np.int32)
        self.pos = np.ascontiguousarray(
            np.concatenate([g.pos for g in graphs]), np.float32)
        self.esrc = np.ascontiguousarray(
            np.concatenate([g.edge_index[0] for g in graphs]), np.int32)
        self.edst = np.ascontiguousarray(
            np.concatenate([g.edge_index[1] for g in graphs]), np.int32)
        ys = [np.atleast_1d(np.asarray(g.y, np.float32)) for g in graphs]
        self.y_dim = int(ys[0].shape[0])
        self.ys = np.ascontiguousarray(np.stack(ys), np.float32)


def fast_build_triplets(edge_index: np.ndarray, num_nodes: int,
                        with_quads: bool):
    """``(idx_i, idx_j, idx_k, idx_kj, idx_ji[, q_trip, q_kn])`` int32, the
    enumeration of ``triplets.build_triplets_plain`` element for element,
    by the C++ enumerator."""
    lib = _host_build.load()
    esrc = np.ascontiguousarray(edge_index[0], np.int32)
    edst = np.ascontiguousarray(edge_index[1], np.int32)
    if esrc.shape[0] >= 2 ** 31 or num_nodes >= 2 ** 31:
        raise ValueError("fast_build_triplets: E and N must be below 2**31")
    e = esrc.shape[0]
    if e and not (0 <= min(esrc.min(), edst.min())
                  and max(esrc.max(), edst.max()) < num_nodes):
        raise ValueError(f"fast_build_triplets: edge ids outside "
                         f"[0, {num_nodes})")
    counts = np.zeros(2, np.int64)
    lib.gmp_count_triplets(_ptr(esrc), _ptr(edst), e, int(num_nodes),
                           int(with_quads), _ptr(counts))
    nt, nq = int(counts[0]), int(counts[1])
    if nt >= 2 ** 31:
        raise ValueError(f"fast_build_triplets: {nt} triplets overflow int32")
    outs = [np.empty(nt, np.int32) for _ in range(5)]
    q_trip = np.empty(nq if with_quads else 0, np.int32)
    q_kn = np.empty(nq if with_quads else 0, np.int32)
    lib.gmp_fill_triplets(_ptr(esrc), _ptr(edst), e, int(num_nodes),
                          int(with_quads), *map(_ptr, outs), _ptr(q_trip),
                          _ptr(q_kn))
    tri = tuple(outs)
    return tri + (q_trip, q_kn) if with_quads else tri


def fast_build_batches(flat: FlatDataset, order: np.ndarray, batch_size: int,
                       n_pad: int, e_pad: int, g_pad: int
                       ) -> Dict[str, np.ndarray]:
    """Every batch of the graphs ``order`` in chunks of ``batch_size``, in
    one call of the C++ batcher: numpy arrays with leading dimension
    ``ceil(len(order) / batch_size)``, ``graph.batch_graphs``' layout
    (masks as uint8)."""
    lib = _host_build.load()
    order = np.ascontiguousarray(order, np.int32)
    nb = (len(order) + batch_size - 1) // batch_size
    if len(order) and not (0 <= order.min() and order.max() < flat.n):
        raise ValueError(f"fast_build_batches: order holds graphs outside "
                         f"[0, {flat.n})")
    if nb:     # the batcher writes without bounds checks: check the bucket
        starts = np.arange(0, len(order), batch_size)
        nodes = np.add.reduceat(flat.n_nodes[order].astype(np.int64), starts)
        edges = np.add.reduceat(flat.n_edges[order].astype(np.int64), starts)
        if not (batch_size < g_pad and nodes.max() < n_pad
                and edges.max() <= e_pad):
            raise ValueError(
                f"fast_build_batches: a batch of {batch_size} graphs / "
                f"{nodes.max()} nodes / {edges.max()} edges does not fit "
                f"bucket ({n_pad}, {e_pad}, {g_pad}) with one pad graph and "
                "node")
    out = {
        "atoms": np.empty((nb, n_pad), np.int32),
        "pos": np.empty((nb, n_pad, 3), np.float32),
        "senders": np.empty((nb, e_pad), np.int32),
        "receivers": np.empty((nb, e_pad), np.int32),
        "graph_id": np.empty((nb, n_pad), np.int32),
        "y": np.empty((nb, g_pad, flat.y_dim), np.float32),
        "node_mask": np.empty((nb, n_pad), np.uint8),
        "edge_mask": np.empty((nb, e_pad), np.uint8),
        "graph_mask": np.empty((nb, g_pad), np.uint8),
        "first_node": np.empty((nb, g_pad), np.int32),
    }
    lib.gmp_build_batches(
        _ptr(flat.atoms), _ptr(flat.pos), _ptr(flat.esrc), _ptr(flat.edst),
        _ptr(flat.ys), flat.y_dim, _ptr(flat.n_nodes), _ptr(flat.n_edges),
        _ptr(flat.node_off), _ptr(flat.edge_off), _ptr(order), len(order),
        batch_size, n_pad, e_pad, g_pad, *(_ptr(a) for a in out.values()))
    return out
