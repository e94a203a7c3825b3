"""Host-side triplet and quad indices for directional message passing
(port of ``triplets.py``): ``build_triplets`` runs the C++ enumerator of
``csrc/host/triplets.cpp`` (``native.fast_build_triplets``; a failed build
raises), ``build_triplets_plain`` is its vectorised numpy twin, kept for the
tests and the card's checks.

For each directed edge e = (j -> i) (senders = j, receivers = i) and each
incoming edge e' = (k -> j) with k != i, there is a triplet
(idx_i, idx_j, idx_k, idx_kj = e', idx_ji = e).  For torsion (SphereNet),
for each triplet t and each in-neighbour k_n of j with k_n != i, there is a
quad (t, k_n).

The order is part of the contract, index for index with the JAX package:
edges in ascending id; the in-edges of j in CSR (dst, src) order; k == i
skipped; a triplet's quads in the same CSR order.  So ``idx_ji`` is
ascending, which the triplet fold on the card relies on
(``ops.sorted_segsum.ascending_plan``); ``batch_triplets`` and
``attach_triplets`` check it.

Indices depend on structure only, so they are built once per graph, cached,
and concatenated with offsets at batch time; distances, angles and torsions
are computed from positions on the device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import dataclasses
import weakref

import numpy as np
import torch

from .graph import Graph, GraphBatch, TripletData, check_ascending


def _expand(owner_node: np.ndarray, rowptr: np.ndarray, order: np.ndarray):
    """For each entry r of ``owner_node``, every in-edge of node
    ``owner_node[r]`` in CSR order: (repeat of r, in-edge id)."""
    start = rowptr[owner_node]
    cnt = rowptr[owner_node + 1] - start
    rep = np.repeat(np.arange(len(owner_node)), cnt)
    within = np.arange(len(rep)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    return rep, order[start[rep] + within]


def build_triplets(edge_index: np.ndarray, num_nodes: int,
                   with_quads: bool = False):
    """``(idx_i, idx_j, idx_k, idx_kj, idx_ji[, q_trip, q_kn])`` int32
    numpy arrays, in the JAX package's order (see the module docstring), by
    the C++ enumerator; ``build_triplets_plain`` gives the same arrays."""
    from .native import fast_build_triplets

    return fast_build_triplets(np.asarray(edge_index), num_nodes, with_quads)


def build_triplets_plain(edge_index: np.ndarray, num_nodes: int,
                         with_quads: bool = False):
    """``build_triplets`` in numpy."""
    src = np.asarray(edge_index[0], np.int64)
    dst = np.asarray(edge_index[1], np.int64)
    order = np.lexsort((src, dst))            # by dst, then src
    rowptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=num_nodes), out=rowptr[1:])
    e, e2 = _expand(src, rowptr, order)       # e = j->i, e2 = k->j
    k = src[e2]
    keep = k != dst[e]
    e, e2, k = e[keep], e2[keep], k[keep]
    idx_i, idx_j = dst[e], src[e]
    tri = tuple(a.astype(np.int32) for a in (idx_i, idx_j, k, e2, e))
    if not with_quads:
        return tri
    t, e3 = _expand(idx_j, rowptr, order)
    kn = src[e3]
    keep = kn != idx_i[t]
    return tri + (t[keep].astype(np.int32), kn[keep].astype(np.int32))


# graph -> {with_quads: triplets}; an entry goes when its graph is collected
_TRIPLET_CACHE = weakref.WeakKeyDictionary()


def graph_triplets(g: Graph, with_quads: bool):
    """``build_triplets`` of ``g``, cached per graph object under a weak
    key: the cache keeps no graph alive, and a new graph never meets the
    triplets of a collected one.  A graph whose type takes no weak
    reference (the JAX package's ``Graph``) is not cached."""
    try:
        hit = _TRIPLET_CACHE.get(g)
    except TypeError:
        return build_triplets(g.edge_index, g.num_nodes, with_quads)
    if hit is None:
        hit = _TRIPLET_CACHE[g] = {}
    if with_quads not in hit:
        hit[with_quads] = build_triplets(g.edge_index, g.num_nodes, with_quads)
    return hit[with_quads]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def triplet_pad_sizes(graphs: Sequence[Graph], batch_size: int,
                      with_quads: bool = False,
                      multiple: int = 128) -> Tuple[int, int]:
    """Bucket sizes ``(T_pad, Q_pad)`` covering any ``batch_size`` window
    (``Q_pad`` 0 without quads)."""
    max_t, max_q = 1, 1
    for g in graphs:
        tri = graph_triplets(g, with_quads)
        max_t = max(max_t, len(tri[0]))
        if with_quads:
            max_q = max(max_q, len(tri[5]))
    return (_round_up(batch_size * max_t, multiple),
            _round_up(batch_size * max_q, multiple) if with_quads else 0)


def batch_triplets(graphs: Sequence[Graph], n_pad: int, e_pad: int,
                   t_pad: int, q_pad: int, with_quads: bool) -> TripletData:
    """Concatenate the graphs' triplets with node, edge and triplet offsets
    and pad them (pad triplets: node ``n_pad-1``, edge ``e_pad-1``; pad
    quads: triplet ``t_pad-1``).  ``ValueError`` if they do not fit or
    ``idx_ji`` is not ascending."""
    tris = [graph_triplets(g, with_quads) for g in graphs]
    nts = np.array([len(t[0]) for t in tris], np.int64)
    n_off = np.cumsum([0] + [g.num_nodes for g in graphs])[:-1]
    e_off = np.cumsum([0] + [g.num_edges for g in graphs])[:-1]
    t_off = np.cumsum(np.concatenate([[0], nts]))[:-1]
    nt = int(nts.sum())
    if nt > t_pad:
        raise ValueError(f"{nt} triplets do not fit t_pad {t_pad}")
    fills = (n_pad - 1, n_pad - 1, n_pad - 1, e_pad - 1, e_pad - 1)
    offs = (n_off, n_off, n_off, e_off, e_off)
    arrs = []
    for col, (fill, off) in enumerate(zip(fills, offs)):
        a = np.full(t_pad, fill, np.int32)
        if nt:
            a[:nt] = np.concatenate([t[col] + o for t, o in zip(tris, off)])
        arrs.append(a)
    check_ascending(arrs[4], "batch_triplets")
    kw = dict(zip(("idx_i", "idx_j", "idx_k", "idx_kj", "idx_ji"),
                  map(torch.from_numpy, arrs)))
    kw["t_mask"] = torch.from_numpy(np.arange(t_pad) < nt)
    if with_quads:
        nq = sum(len(t[5]) for t in tris)
        if nq > q_pad:
            raise ValueError(f"{nq} quads do not fit q_pad {q_pad}")
        q_trip = np.full(q_pad, t_pad - 1, np.int32)
        q_kn = np.full(q_pad, n_pad - 1, np.int32)
        if nq:
            q_trip[:nq] = np.concatenate([t[5] + o for t, o in zip(tris, t_off)])
            q_kn[:nq] = np.concatenate([t[6] + o for t, o in zip(tris, n_off)])
        kw.update(q_trip=torch.from_numpy(q_trip),
                  q_kn=torch.from_numpy(q_kn),
                  q_mask=torch.from_numpy(np.arange(q_pad) < nq))
    return TripletData(**kw)


def _pad_i(a: np.ndarray, size: int, fill: int) -> torch.Tensor:
    out = np.full(size, fill, np.int32)
    out[: len(a)] = a
    return torch.from_numpy(out)


def attach_triplets(batch: GraphBatch, with_quads: bool = False,
                    t_pad: Optional[int] = None,
                    q_pad: Optional[int] = None) -> GraphBatch:
    """``batch`` (on the host) with the triplets of its real edges attached
    (loaders normally attach them from per-graph caches).  Edge ids map back
    through the ascending list of real edges, so ``idx_ji`` stays
    ascending; ``ValueError`` otherwise."""
    ei = np.stack([batch.senders.cpu().numpy(), batch.receivers.cpu().numpy()])
    real = np.flatnonzero(batch.edge_mask.cpu().numpy())
    tri = build_triplets(ei[:, real], batch.num_nodes, with_quads)
    idx_kj, idx_ji = real[tri[3]], real[tri[4]]
    check_ascending(idx_ji, "attach_triplets")
    nt = len(tri[0])
    t_pad = t_pad or max(_round_up(nt + 1, 128), 128)
    n_last, e_last = batch.num_nodes - 1, batch.num_edges - 1
    data = dict(
        idx_i=_pad_i(tri[0], t_pad, n_last),
        idx_j=_pad_i(tri[1], t_pad, n_last),
        idx_k=_pad_i(tri[2], t_pad, n_last),
        idx_kj=_pad_i(idx_kj, t_pad, e_last),
        idx_ji=_pad_i(idx_ji, t_pad, e_last),
        t_mask=torch.from_numpy(np.arange(t_pad) < nt))
    if with_quads:
        nq = len(tri[5])
        q_pad = q_pad or max(_round_up(nq + 1, 128), 128)
        data.update(q_trip=_pad_i(tri[5], q_pad, t_pad - 1),
                    q_kn=_pad_i(tri[6], q_pad, n_last),
                    q_mask=torch.from_numpy(np.arange(q_pad) < nq))
    return dataclasses.replace(batch, triplets=TripletData(**data))
