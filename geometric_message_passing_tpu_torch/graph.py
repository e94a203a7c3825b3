"""Static-shape padded graph batches (port of ``graph.py``).

A ``GraphBatch`` is padded to fixed (num_nodes, num_edges, num_graphs)
bucket sizes.  Padding discipline, as in the JAX package:
  * pad nodes/edges are appended at the end and masked out;
  * pad edges connect node ``n_pad-1`` to itself so gathers stay in bounds;
  * pad nodes belong to a trailing pad graph so segment pooling stays correct;
  * ``first_node`` of a pad graph is ``n_pad-1``;
  * per-graph targets carry a ``graph_mask``.

Host-side construction is numpy; the batch holds CPU tensors until
``GraphBatch.to(device)``.  For training, ``SlotData`` keeps a whole dataset
on the device in per-graph slots and ``assemble_batch`` builds each batch
there from a row of graph indices.

The directional models (DimeNet++, SphereNet) read ``GraphBatch.triplets``,
a ``TripletData`` built on the host (``triplets.batch_triplets``, or the
slot fields of ``build_slot_data(with_triplets=True)``).  Its ``idx_ji`` is
ascending on every path: the enumeration walks edges in ascending id,
offsets grow with the graph or the slot, and pad triplets carry the largest
edge id.  The builders check it (``ValueError``), because the triplet fold
on the card sums over a plan that assumes it
(``ops.sorted_segsum.ascending_plan``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class TripletData:
    """Static-shape triplet (and optional quad) indices of a padded batch.
    T = padded triplet count, Q = padded quad count.  Pad triplets point at
    the last node and edge, pad quads at the last triplet."""

    idx_i: torch.Tensor          # [T] node i of triplet k->j->i
    idx_j: torch.Tensor          # [T]
    idx_k: torch.Tensor          # [T]
    idx_kj: torch.Tensor         # [T] edge id of k->j
    idx_ji: torch.Tensor         # [T] edge id of j->i, ascending
    t_mask: torch.Tensor         # [T] bool
    q_trip: Optional[torch.Tensor] = None   # [Q] triplet id of each quad
    q_kn: Optional[torch.Tensor] = None     # [Q] node id of the 4th point k_n
    q_mask: Optional[torch.Tensor] = None   # [Q] bool

    @property
    def num_triplets(self) -> int:
        return self.idx_i.shape[0]

    def to(self, device) -> "TripletData":
        return TripletData(**{f.name: _to(getattr(self, f.name), device)
                              for f in dataclasses.fields(self)})


def _to(value, device):
    return None if value is None else value.to(device)


def check_ascending(idx_ji: np.ndarray, where: str) -> None:
    """Raise ``ValueError`` unless ``idx_ji`` is ascending along its last
    axis (the triplet fold's plan on the card assumes it)."""
    if idx_ji.shape[-1] > 1 and bool((np.diff(idx_ji, axis=-1) < 0).any()):
        raise ValueError(f"{where}: idx_ji is not ascending; the triplet fold "
                         "needs triplets sorted by their edge j->i")


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
    triplets: Optional[TripletData] = None

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
        return GraphBatch(**{f.name: _to(getattr(self, f.name), device)
                             for f in dataclasses.fields(self)})


class Graph:
    """A single host-side graph (numpy), the fields of a PyG ``Data``."""

    __slots__ = ("atoms", "edge_index", "pos", "y", "__weakref__")

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


@dataclasses.dataclass
class SlotData:
    """Device-resident dataset in per-graph slot-padded layout.

    Every graph is padded to ``Sn`` nodes / ``Se`` edges (edge indices local
    to the graph).  Row M (the last) is a blank sentinel graph that pads
    partial batches.  Batches are assembled on the device (``assemble_batch``)
    from a vector of graph indices, so the dataset is copied to the device
    once and each epoch's shuffle is a device-side permutation."""

    atoms: torch.Tensor        # [M+1, Sn] int32
    pos: torch.Tensor          # [M+1, Sn, 3] f32
    senders: torch.Tensor      # [M+1, Se] int32, local indices
    receivers: torch.Tensor    # [M+1, Se] int32
    node_mask: torch.Tensor    # [M+1, Sn] bool
    edge_mask: torch.Tensor    # [M+1, Se] bool
    y: torch.Tensor            # [M+1, y_dim]
    # optional slotted triplet/quad indices (directional models): local
    # node/edge/triplet ids, padded to St/Sq per graph
    tri_i: Optional[torch.Tensor] = None      # [M+1, St]
    tri_j: Optional[torch.Tensor] = None
    tri_k: Optional[torch.Tensor] = None
    tri_kj: Optional[torch.Tensor] = None     # edge ids
    tri_ji: Optional[torch.Tensor] = None     # edge ids, ascending per slot
    tri_mask: Optional[torch.Tensor] = None
    q_trip: Optional[torch.Tensor] = None     # [M+1, Sq] triplet ids
    q_kn: Optional[torch.Tensor] = None       # [M+1, Sq] node ids
    q_mask: Optional[torch.Tensor] = None

    @property
    def num_graphs(self) -> int:      # real graphs (sentinel excluded)
        return self.atoms.shape[0] - 1

    @property
    def slot_nodes(self) -> int:
        return self.atoms.shape[1]

    @property
    def slot_edges(self) -> int:
        return self.senders.shape[1]


def build_slot_data(graphs: Sequence[Graph], y_dtype=np.float32,
                    sn: Optional[int] = None, se: Optional[int] = None,
                    with_triplets: bool = False, with_quads: bool = False,
                    device="cpu") -> SlotData:
    """Pack ``graphs`` into slot layout on the host, then copy it to
    ``device`` once.  ``with_triplets`` / ``with_quads`` add each graph's
    triplets (and quads) with the JAX package's fills: node ``sn-1``, edge
    ``se-1``, triplet ``st-1``; ``ValueError`` if a slot's ``tri_ji`` is not
    ascending."""
    m = len(graphs)
    sn = sn or max(g.num_nodes for g in graphs)
    se = se or max(max(g.num_edges for g in graphs), 1)
    atoms = np.zeros((m + 1, sn), np.int32)
    pos = np.zeros((m + 1, sn, 3), np.float32)
    senders = np.full((m + 1, se), sn - 1, np.int32)
    receivers = np.full((m + 1, se), sn - 1, np.int32)
    node_mask = np.zeros((m + 1, sn), bool)
    edge_mask = np.zeros((m + 1, se), bool)
    ys = [np.atleast_1d(np.asarray(g.y)) for g in graphs]
    y_dim = ys[0].shape[0] if ys else 1
    y = np.zeros((m + 1, y_dim), y_dtype)
    for i, g in enumerate(graphs):
        nn, ne = g.num_nodes, g.num_edges
        if nn > sn or ne > se:
            raise ValueError(f"graph {i} ({nn} nodes, {ne} edges) exceeds "
                             f"the slot ({sn}, {se})")
        atoms[i, :nn] = g.atoms
        pos[i, :nn] = g.pos
        senders[i, :ne] = g.edge_index[0]
        receivers[i, :ne] = g.edge_index[1]
        node_mask[i, :nn] = True
        edge_mask[i, :ne] = True
        y[i] = ys[i].astype(y_dtype)
    tri = (_slot_triplets(graphs, sn, se, with_quads)
           if with_triplets or with_quads else {})
    return SlotData(*(torch.from_numpy(a).to(device) for a in (
        atoms, pos, senders, receivers, node_mask, edge_mask, y)),
        **{k: torch.from_numpy(v).to(device) for k, v in tri.items()})


def _slot_triplets(graphs: Sequence[Graph], sn: int, se: int,
                   with_quads: bool) -> dict:
    """The slot fields of ``graphs``' triplets (and quads) as numpy arrays."""
    from .triplets import graph_triplets

    m = len(graphs)
    tris = [graph_triplets(g, with_quads) for g in graphs]
    st = max(max((len(t[0]) for t in tris), default=1), 1)
    names = ("tri_i", "tri_j", "tri_k", "tri_kj", "tri_ji")
    fills = (sn - 1, sn - 1, sn - 1, se - 1, se - 1)
    out = {k: np.full((m + 1, st), f, np.int32) for k, f in zip(names, fills)}
    out["tri_mask"] = np.zeros((m + 1, st), bool)
    for i, t in enumerate(tris):
        nt = len(t[0])
        for k, a in zip(names, t[:5]):
            out[k][i, :nt] = a
        out["tri_mask"][i, :nt] = True
    check_ascending(out["tri_ji"], "build_slot_data")
    if with_quads:
        sq = max(max((len(t[5]) for t in tris), default=1), 1)
        out["q_trip"] = np.full((m + 1, sq), st - 1, np.int32)
        out["q_kn"] = np.full((m + 1, sq), sn - 1, np.int32)
        out["q_mask"] = np.zeros((m + 1, sq), bool)
        for i, t in enumerate(tris):
            nq = len(t[5])
            out["q_trip"][i, :nq] = t[5]
            out["q_kn"][i, :nq] = t[6]
            out["q_mask"][i, :nq] = True
    return out


def assemble_batch(slot: SlotData, idx: torch.Tensor) -> GraphBatch:
    """Device-side batch assembly from graph indices ``idx`` [B] (index M
    selects the blank sentinel).  The same ``GraphBatch`` contract as
    ``batch_graphs``, except that graph i's nodes sit at [i*Sn, i*Sn+Sn):
    pad nodes are masked and pooled into the trailing pad graph, and pad
    edges are masked self-loops on each slot's last node.  Slot triplets
    (and quads) come along with node, edge and triplet offsets, so
    ``idx_ji`` stays ascending."""
    b = idx.shape[0]
    m = slot.num_graphs
    sn = slot.slot_nodes
    dev = slot.atoms.device
    idx = torch.clamp_max(idx.to(device=dev, dtype=torch.long), m)
    off = torch.arange(b, dtype=torch.int32, device=dev) * sn
    node_mask = slot.node_mask[idx].reshape(-1)
    gid = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(sn)
    triplets = None
    if slot.tri_i is not None:
        ar = torch.arange(b, dtype=torch.int32, device=dev)[:, None]
        noff, eoff = ar * sn, ar * slot.slot_edges
        tri = dict(
            idx_i=(slot.tri_i[idx] + noff).reshape(-1),
            idx_j=(slot.tri_j[idx] + noff).reshape(-1),
            idx_k=(slot.tri_k[idx] + noff).reshape(-1),
            idx_kj=(slot.tri_kj[idx] + eoff).reshape(-1),
            idx_ji=(slot.tri_ji[idx] + eoff).reshape(-1),
            t_mask=slot.tri_mask[idx].reshape(-1))
        if slot.q_trip is not None:
            toff = ar * slot.tri_i.shape[1]
            tri.update(q_trip=(slot.q_trip[idx] + toff).reshape(-1),
                       q_kn=(slot.q_kn[idx] + noff).reshape(-1),
                       q_mask=slot.q_mask[idx].reshape(-1))
        triplets = TripletData(**tri)
    return GraphBatch(
        atoms=slot.atoms[idx].reshape(-1),
        pos=slot.pos[idx].reshape(-1, 3),
        senders=(slot.senders[idx] + off[:, None]).reshape(-1),
        receivers=(slot.receivers[idx] + off[:, None]).reshape(-1),
        graph_id=torch.where(node_mask, gid, torch.full_like(gid, b)),
        y=torch.cat([slot.y[idx], slot.y.new_zeros((1,) + slot.y.shape[1:])]),
        node_mask=node_mask,
        edge_mask=slot.edge_mask[idx].reshape(-1),
        graph_mask=torch.cat([idx < m, torch.zeros(1, dtype=torch.bool,
                                                    device=dev)]),
        first_node=torch.cat([off, torch.full((1,), b * sn - 1,
                                              dtype=torch.int32, device=dev)]),
        triplets=triplets,
    )


def eval_slot_indices(num_graphs: int, batch_size: int) -> np.ndarray:
    """Static [steps, B] index plan for an unshuffled (eval) pass; sentinel
    index M pads the last partial batch."""
    steps = (num_graphs + batch_size - 1) // batch_size
    idx = np.full(steps * batch_size, num_graphs, np.int32)
    idx[:num_graphs] = np.arange(num_graphs)
    return idx.reshape(steps, batch_size)


class GraphLoader:
    """Host-side batching iterator with static padded shapes; every batch
    shares one bucket.  The last incomplete batch is kept.  The shuffle is a
    numpy ``default_rng(seed)`` stream, as in the JAX package, so both
    packages visit the graphs in the same order.  ``with_triplets`` /
    ``with_quads`` attach each batch's ``TripletData``, padded to
    ``triplet_pad = (T, Q)`` (default ``triplets.triplet_pad_sizes``)."""

    def __init__(
        self,
        graphs: Sequence[Graph],
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        y_dtype=np.float32,
        pad: Optional[tuple] = None,
        with_triplets: bool = False,
        with_quads: bool = False,
        triplet_pad: Optional[tuple] = None,
    ):
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.y_dtype = y_dtype
        self.pad = pad or pad_sizes(self.graphs, batch_size)
        self.with_triplets = with_triplets or with_quads
        self.with_quads = with_quads
        self.triplet_pad = None
        if self.with_triplets:
            from .triplets import triplet_pad_sizes

            self.triplet_pad = triplet_pad or triplet_pad_sizes(
                self.graphs, batch_size, with_quads)

    def __len__(self):
        return (len(self.graphs) + self.batch_size - 1) // self.batch_size

    @property
    def num_examples(self) -> int:
        return len(self.graphs)

    def __iter__(self):
        order = np.arange(len(self.graphs))
        if self.shuffle:
            self.rng.shuffle(order)
        n_pad, e_pad, g_pad = self.pad
        for i in range(0, len(order), self.batch_size):
            chunk = [self.graphs[j] for j in order[i : i + self.batch_size]]
            batch = batch_graphs(chunk, n_pad, e_pad, g_pad, self.y_dtype)
            if self.with_triplets:
                from .triplets import batch_triplets

                batch.triplets = batch_triplets(chunk, n_pad, e_pad,
                                                *self.triplet_pad,
                                                self.with_quads)
            yield batch

    def stacked_epochs(self, n_epochs: int) -> List[GraphBatch]:
        """The batches of ``n_epochs`` passes, epoch after epoch (each
        shuffled from the loader's generator when ``shuffle``)."""
        out = []
        for _ in range(n_epochs):
            out.extend(self)
        return out

    def stage_epochs(self, n_epochs: int) -> Optional[GraphBatch]:
        """Every batch of ``n_epochs`` passes in one call of the C++ batcher
        (``native.fast_build_batches``), shuffled from the loader's numpy
        generator as ``__iter__`` shuffles: a ``GraphBatch`` of CPU tensors
        with leading dimensions ``[n_epochs, steps]``, float32 targets, the
        masks bool.  None with triplets, as in the JAX package (the batcher
        builds no triplets); a failed build of the batcher raises."""
        if self.with_triplets:
            return None
        from .native import FlatDataset, fast_build_batches

        if not hasattr(self, "_flat"):
            self._flat = FlatDataset(self.graphs)
        steps = len(self)
        chunks = []
        for _ in range(n_epochs):
            order = np.arange(len(self.graphs))
            if self.shuffle:
                self.rng.shuffle(order)
            chunks.append(fast_build_batches(self._flat, order,
                                             self.batch_size, *self.pad))
        fields = {}
        for key in chunks[0]:
            a = np.stack([c[key] for c in chunks]).reshape(
                (n_epochs, steps) + chunks[0][key].shape[1:])
            if key.endswith("_mask"):
                a = a.astype(bool)
            fields[key] = torch.from_numpy(a)
        return GraphBatch(**fields)


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


def sort_edges_by_receiver(g: Graph) -> Graph:
    """The graph with its edges reordered by receiver (``edge_index[1]``),
    a stable sort: the layout in which the sorted segment sum's receiver
    plan is the identity (``ops.sorted_segsum``)."""
    ei = np.asarray(g.edge_index)
    order = np.argsort(ei[1], kind="stable")
    return Graph(g.atoms, ei[:, order], g.pos, g.y)
