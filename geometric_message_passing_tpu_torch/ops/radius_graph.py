"""Radius-graph construction on the host (port of ``ops/radius_graph.py``).

``radius_graph`` runs the C++ cell list of ``csrc/host/radius.cpp`` (the JAX
package's ``native/radius.cpp``, built by ``ops/_host_build.py``; a failed
build raises, there is no fallback).  ``radius_graph_plain`` is its numpy
twin, kept for the tests and the card's checks: a vectorised cell list.
Points hash into cells of side ``r``; the neighbours of a point lie in the
3^d cells around its own.  Both give the edges of the JAX package's
``radius_graph`` in its order, element for element: receivers (centres) in
row 0,
ascending; for each centre, the neighbour cells in meshgrid order (last axis
fastest), and inside a cell the points by ascending id; with
``max_num_neighbors``, a centre that has more candidates keeps its k nearest
in a stable sort by squared distance.  All distances are float64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import _host_build

# centres per chunk of the candidate enumeration: bounds the host memory to
# some 100 candidates per centre at a time
_CHUNK = 16384


def _cell_keys(cell: np.ndarray, batch: np.ndarray):
    """Keys of each point's (graph, cell), and ``[n, 3^d]`` keys of its
    3^d neighbour cells in meshgrid order (last axis fastest), -1 where that
    cell holds no point.  Each axis's cell coordinates are ranked among
    those that occur, so the keys stay small whatever the radius."""
    n, d = cell.shape
    _, graph = np.unique(batch, return_inverse=True)
    key = graph.astype(np.int64)
    q, valid = key[:, None], np.ones((n, 1), bool)
    span = float(key.max() + 1)
    for k in range(d):
        values = np.unique(cell[:, k])
        size = values.shape[0]
        target = cell[:, k, None] + np.array([-1, 0, 1])
        rank = np.minimum(np.searchsorted(values, target), size - 1)
        found = values[rank] == target
        key = key * size + rank[:, 1]
        q = (q[:, :, None] * size + rank[:, None, :]).reshape(n, -1)
        valid = (valid[:, :, None] & found[:, None, :]).reshape(n, -1)
        span *= size
    if span >= 2.0**62:
        raise ValueError("radius_graph: too many occupied cells for int64 keys")
    return key, np.where(valid, q, -1)


def radius_graph(pos: np.ndarray, r: float, batch: Optional[np.ndarray] = None,
                 loop: bool = False,
                 max_num_neighbors: Optional[int] = None) -> np.ndarray:
    """Edge index ``[2, E]`` int32 of the directed pairs (i, j), i != j
    unless ``loop``, with ``||pos_i - pos_j|| <= r`` and ``batch[i] ==
    batch[j]``: row 0 holds i (the centre), row 1 its neighbour j.

    ``pos`` ``[n, d]`` (or ``[n]``), ``batch`` ``[n]`` graph ids (no edge
    across graphs), ``max_num_neighbors`` keeps each centre's k nearest.
    The C++ cell list (``csrc/host/radius.cpp``); ``radius_graph_plain``
    gives the same array."""
    lib = _host_build.load()
    pos = np.ascontiguousarray(np.asarray(pos, np.float64))
    if pos.ndim == 1:
        pos = np.ascontiguousarray(pos[:, None])
    n, d = pos.shape
    if n == 0:
        return np.zeros((2, 0), np.int32)
    if n >= 2 ** 31:
        raise ValueError("radius_graph: n must be below 2**31")
    b = None if batch is None else np.ascontiguousarray(batch, np.int64)
    if b is not None and b.shape != (n,):
        raise ValueError(f"radius_graph: batch must be [{n}], got {b.shape}")
    k = -1 if max_num_neighbors is None else int(max_num_neighbors)
    cap = max(16, 4 * n)
    while True:
        out = np.empty((2, cap), np.int32)
        count = lib.gmp_radius_graph(
            pos.ctypes.data, n, d, float(r),
            None if b is None else b.ctypes.data, int(loop), k,
            out[0].ctypes.data, out[1].ctypes.data, cap)
        if count <= cap:
            return np.ascontiguousarray(out[:, :count])
        cap = int(count)


def radius_graph_plain(pos: np.ndarray, r: float,
                       batch: Optional[np.ndarray] = None, loop: bool = False,
                       max_num_neighbors: Optional[int] = None) -> np.ndarray:
    """``radius_graph`` in numpy (the same edges in the same order)."""
    pos = np.asarray(pos, np.float64)
    if pos.ndim == 1:
        pos = pos[:, None]
    n = pos.shape[0]
    if n == 0:
        return np.zeros((2, 0), np.int32)
    batch = (np.zeros(n, np.int64) if batch is None
             else np.asarray(batch, np.int64))
    cell = np.floor(pos / max(r, 1e-12)).astype(np.int64)
    key, near = _cell_keys(cell, batch)
    order = np.argsort(key, kind="stable")      # by cell, then ascending id
    skey = key[order]
    r2 = float(r) * float(r)

    rows, cols = [], []
    for c0 in range(0, n, _CHUNK):
        centres = np.arange(c0, min(n, c0 + _CHUNK))
        q = near[centres].ravel()
        start = np.searchsorted(skey, q, "left")
        count = np.searchsorted(skey, q, "right") - start   # 0 where q = -1
        total = int(count.sum())
        if total == 0:
            continue
        first = np.cumsum(count) - count            # block starts, flat
        within = np.arange(total) - np.repeat(first, count)
        j = order[np.repeat(start, count) + within]
        i = np.repeat(np.repeat(centres, near.shape[1]), count)
        diff = pos[j] - pos[i]
        d2 = np.sum(diff * diff, axis=1)
        keep = d2 <= r2
        if not loop:
            keep &= j != i
        i, j, d2 = i[keep], j[keep], d2[keep]
        if max_num_neighbors is not None:
            i, j = _nearest(i, j, d2, int(max_num_neighbors), n)
        rows.append(i)
        cols.append(j)
    if not rows:
        return np.zeros((2, 0), np.int32)
    return np.stack([np.concatenate(rows), np.concatenate(cols)]).astype(np.int32)


def _nearest(i: np.ndarray, j: np.ndarray, d2: np.ndarray, k: int, n: int):
    """Keep each centre's ``k`` nearest candidates.  Centres over the cap are
    reordered by a stable sort on distance; the others keep their order."""
    count = np.bincount(i, minlength=n)
    over = count[i] > k
    if not over.any():
        return i, j
    sort_key = np.where(over, d2, 0.0)
    idx = np.lexsort((np.arange(i.shape[0]), sort_key, i))
    i, j = i[idx], j[idx]
    group_start = np.cumsum(count) - count
    rank = np.arange(i.shape[0]) - group_start[i]
    keep = rank < k
    return i[keep], j[keep]
