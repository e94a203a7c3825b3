"""Static-shape padded graph batches (port of ``graph.py``).

A ``GraphBatch`` is padded to fixed (num_nodes, num_edges, num_graphs)
bucket sizes.  Padding discipline, as in the JAX package:
  * pad nodes/edges are appended at the end and masked out;
  * pad edges connect node ``n_pad-1`` to itself so gathers stay in bounds;
  * pad nodes belong to a trailing pad graph so segment pooling stays correct;
  * ``first_node`` of a pad graph is ``n_pad-1``;
  * per-graph targets carry a ``graph_mask``.

Host-side construction is numpy; the batch holds CPU tensors until
``GraphBatch.to(device)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class GraphBatch:
    """A batch of graphs padded to static shapes.

    Shapes: N = padded node count, E = padded edge count, G = padded graph count.
    """

    atoms: torch.Tensor          # [N] int32 node type labels
    pos: torch.Tensor            # [N, 3] float positions
    senders: torch.Tensor        # [E] int32 source node of each edge (edge_index[0])
    receivers: torch.Tensor      # [E] int32 destination node (edge_index[1])
    graph_id: torch.Tensor       # [N] int32 graph each node belongs to
    y: torch.Tensor              # [G, y_dim] targets
    node_mask: torch.Tensor      # [N] bool
    edge_mask: torch.Tensor      # [E] bool
    graph_mask: torch.Tensor     # [G] bool
    first_node: torch.Tensor     # [G] int32 index of each graph's first node

    @property
    def num_nodes(self) -> int:
        return self.atoms.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[0]

    def to(self, device) -> "GraphBatch":
        return GraphBatch(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})


class Graph:
    """A single host-side graph (numpy), the fields of a PyG ``Data``."""

    __slots__ = ("atoms", "edge_index", "pos", "y")

    def __init__(self, atoms, edge_index, pos, y):
        self.atoms = np.asarray(atoms, dtype=np.int32)
        self.edge_index = np.asarray(edge_index, dtype=np.int32)  # [2, e]
        self.pos = np.asarray(pos, dtype=np.float32)
        self.y = np.asarray(y)

    @property
    def num_nodes(self) -> int:
        return self.atoms.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_index.shape[1]


def to_undirected(edge_index: np.ndarray) -> np.ndarray:
    """Symmetrize and deduplicate edges, sorted row-major like PyG's."""
    src = np.concatenate([edge_index[0], edge_index[1]])
    dst = np.concatenate([edge_index[1], edge_index[0]])
    pairs = np.unique(np.stack([src, dst], axis=1), axis=0)
    return pairs.T.astype(np.int32)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_sizes(
    graphs: Sequence[Graph],
    batch_size: int,
    node_multiple: int = 8,
    edge_multiple: int = 128,
):
    """Bucket sizes covering any ``batch_size`` window of ``graphs``.

    One extra pad graph / pad node is always reserved so padding has a home.
    """
    max_nodes = max(g.num_nodes for g in graphs)
    max_edges = max(g.num_edges for g in graphs)
    n_pad = _round_up(batch_size * max_nodes + 1, node_multiple)
    e_pad = _round_up(max(batch_size * max_edges, 1), edge_multiple)
    g_pad = batch_size + 1
    return n_pad, e_pad, g_pad


def batch_graphs(
    graphs: Sequence[Graph],
    n_pad: int,
    e_pad: int,
    g_pad: int,
    y_dtype=np.float32,
) -> GraphBatch:
    """Concatenate graphs block-diagonally and pad to (n_pad, e_pad, g_pad)."""
    n_graphs = len(graphs)
    total_nodes = sum(g.num_nodes for g in graphs)
    total_edges = sum(g.num_edges for g in graphs)
    if not (n_graphs < g_pad and total_nodes < n_pad and total_edges <= e_pad):
        raise ValueError(
            f"batch of {n_graphs} graphs / {total_nodes} nodes / "
            f"{total_edges} edges does not fit bucket "
            f"({n_pad}, {e_pad}, {g_pad}) with one pad graph and node")

    atoms = np.zeros(n_pad, dtype=np.int32)
    pos = np.zeros((n_pad, 3), dtype=np.float32)
    senders = np.full(e_pad, n_pad - 1, dtype=np.int32)
    receivers = np.full(e_pad, n_pad - 1, dtype=np.int32)
    graph_id = np.full(n_pad, g_pad - 1, dtype=np.int32)
    node_mask = np.zeros(n_pad, dtype=bool)
    edge_mask = np.zeros(e_pad, dtype=bool)
    graph_mask = np.zeros(g_pad, dtype=bool)
    first_node = np.full(g_pad, n_pad - 1, dtype=np.int32)

    ys = [np.atleast_1d(np.asarray(g.y)) for g in graphs]
    y_dim = ys[0].shape[0] if ys else 1
    y = np.zeros((g_pad, y_dim), dtype=y_dtype)

    n_off = 0
    e_off = 0
    for i, g in enumerate(graphs):
        nn, ne = g.num_nodes, g.num_edges
        atoms[n_off : n_off + nn] = g.atoms
        pos[n_off : n_off + nn] = g.pos
        senders[e_off : e_off + ne] = g.edge_index[0] + n_off
        receivers[e_off : e_off + ne] = g.edge_index[1] + n_off
        graph_id[n_off : n_off + nn] = i
        node_mask[n_off : n_off + nn] = True
        edge_mask[e_off : e_off + ne] = True
        graph_mask[i] = True
        first_node[i] = n_off
        y[i] = ys[i].astype(y_dtype)
        n_off += nn
        e_off += ne

    return GraphBatch(
        atoms=torch.from_numpy(atoms),
        pos=torch.from_numpy(pos),
        senders=torch.from_numpy(senders),
        receivers=torch.from_numpy(receivers),
        graph_id=torch.from_numpy(graph_id),
        y=torch.from_numpy(y),
        node_mask=torch.from_numpy(node_mask),
        edge_mask=torch.from_numpy(edge_mask),
        graph_mask=torch.from_numpy(graph_mask),
        first_node=torch.from_numpy(first_node),
    )


class GraphLoader:
    """Host-side batching iterator with static padded shapes; every batch
    shares one bucket.  The last incomplete batch is kept.  The shuffle is a
    numpy ``default_rng(seed)`` stream, as in the JAX package, so both
    packages visit the graphs in the same order."""

    def __init__(
        self,
        graphs: Sequence[Graph],
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        y_dtype=np.float32,
        pad: Optional[tuple] = None,
    ):
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.y_dtype = y_dtype
        self.pad = pad or pad_sizes(self.graphs, batch_size)

    def __len__(self):
        return (len(self.graphs) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.graphs))
        if self.shuffle:
            self.rng.shuffle(order)
        n_pad, e_pad, g_pad = self.pad
        for i in range(0, len(order), self.batch_size):
            chunk = [self.graphs[j] for j in order[i : i + self.batch_size]]
            yield batch_graphs(chunk, n_pad, e_pad, g_pad, self.y_dtype)


def random_split(dataset: Sequence, fractions: Sequence[float], seed: int = 0):
    """Deterministic random split (numpy RNG), the 50/20/30 protocol."""
    n = len(dataset)
    sizes = [int(f * n) for f in fractions[:-1]]
    sizes.append(n - sum(sizes))
    perm = np.random.default_rng(seed).permutation(n)
    out, off = [], 0
    for s in sizes:
        out.append([dataset[int(i)] for i in perm[off : off + s]])
        off += s
    return out
