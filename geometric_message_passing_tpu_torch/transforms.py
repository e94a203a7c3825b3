"""Graph transforms (port of ``transforms.py``): the complete-graph and
target-column transforms of the teaching notebook, and the rotation and
permutation probes of its tests.  Graphs in, graphs out (numpy)."""

from __future__ import annotations

import numpy as np

from .graph import Graph


def complete_graph(g: Graph) -> Graph:
    """``g`` with every directed edge between distinct nodes."""
    n = g.num_nodes
    row = np.repeat(np.arange(n), n)
    col = np.tile(np.arange(n), n)
    keep = row != col
    ei = np.stack([row[keep], col[keep]]).astype(np.int32)
    return Graph(g.atoms, ei, g.pos, g.y)


def set_target(g: Graph, index: int) -> Graph:
    """``g`` with the one target column ``index``."""
    y = np.atleast_1d(np.asarray(g.y))
    return Graph(g.atoms, g.edge_index, g.pos, y[index:index + 1])


def permute_graph(g: Graph, perm: np.ndarray) -> Graph:
    """``g`` with node ``i`` of the result being node ``perm[i]`` of ``g``."""
    inv = np.argsort(perm)
    return Graph(
        np.asarray(g.atoms)[perm],
        inv[np.asarray(g.edge_index)].astype(np.int32),
        np.asarray(g.pos)[perm],
        g.y,
    )


def rotate_graph(g: Graph, R: np.ndarray, t: np.ndarray = None) -> Graph:
    """``g`` with positions ``pos @ R.T + t``."""
    pos = np.asarray(g.pos) @ np.asarray(R).T
    if t is not None:
        pos = pos + np.asarray(t)
    return Graph(g.atoms, g.edge_index, pos, g.y)


def random_orthogonal_matrix(dim: int = 3, seed: int = 0) -> np.ndarray:
    """A Haar-random orthogonal matrix (``scipy.stats.ortho_group``)."""
    from scipy.stats import ortho_group

    return ortho_group.rvs(dim, random_state=seed)
