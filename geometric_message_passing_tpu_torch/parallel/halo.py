"""Edge-partitioned graph parallelism ("gp") over ``torch.distributed``
(port of ``parallel/halo.py``).

Nodes are owned in row blocks (rank p owns rows ``[p * n_local, (p + 1) *
n_local)``), each edge lives on the owner of its target (receiver), and a
message-passing round exchanges node features before the local edge work.

* v0, the full halo: ``gp_gather_nodes`` (tiled all-gather) gives every
  rank all N rows, the local edges sum into all N rows, and
  ``gp_scatter_nodes`` (reduce-scatter) returns the owners' sums.
* The packed halo: ``build_halo_plan`` (host, numpy) lists for every rank
  pair (p -> q) the rows of p that q's edges read, padded to the largest
  such set B.  One all-to-all moves that boundary payload (k * B rows)
  into q's catalog ``[n_local + k * B, d]`` (``halo_catalog``); each
  edge's source is a catalog index and its target a local row, so the
  sums land on local rows and nothing is scattered back.
* ``packed_halo_aggregate_overlapped`` splits the edges into interior
  (source owned here) and boundary ones: the all-to-all starts
  asynchronously (``async_op=True``), the interior edges are computed and
  summed while it runs, and the boundary sum is added after ``wait()``.

The JAX functions run inside ``shard_map`` and strip its leading singleton
shard axis; here each rank passes its own slice of the plan,
``HaloPlan.local(rank)``.  Every collective is a
``mesh.differentiable`` one, so autograd differentiates a gp forward;
each rank's parameter gradients are then partial and are summed over the
axis (``data.all_reduce_grads``).  On the card every segment sum is K4
(``ops.scatter.segment_sum``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping

import numpy as np
import torch
import torch.distributed as dist

from ..graph import GraphBatch
from ..ops.norms import safe_norm
from ..ops.scatter import segment_sum
from .mesh import Mesh, collectives, differentiable

PLAN_ARRAYS = ("send_idx", "send_mask", "edge_src_cat", "edge_tgt_local",
               "edge_mask", "int_src", "int_tgt", "int_mask", "bnd_src_slot",
               "bnd_tgt", "bnd_mask", "edge_perm")


def gp_gather_nodes(mesh: Mesh, h_local: torch.Tensor,
                    axis: str = "gp") -> torch.Tensor:
    """Owner-partitioned ``[n_local, d]`` -> every row ``[N, d]`` (tiled
    all-gather; backward a reduce-scatter)."""
    return differentiable.all_gather(mesh, h_local, axis)


def gp_scatter_nodes(mesh: Mesh, partial_global: torch.Tensor,
                     axis: str = "gp") -> torch.Tensor:
    """Each rank's partial sums over all N rows -> this rank's block of
    their sum over the axis (reduce-scatter; backward a tiled
    all-gather)."""
    return differentiable.reduce_scatter_sum(mesh, partial_global, axis)


@dataclasses.dataclass
class HaloPlan:
    """The host-built plan of a packed boundary-only halo exchange
    (``build_halo_plan``): the JAX ``HaloPlan``'s arrays as CPU tensors
    (int32 / bool), each with a leading ``[k]`` rank axis.

    ``send_idx[p, q]`` lists the local rows of p that q's edges read
    (``send_mask`` marks the real ones of the B slots); edges sit on their
    target's owner in ``E_loc`` slots, ``edge_src_cat`` the catalog index
    of the source, ``edge_tgt_local`` the local row of the target; the
    ``int_*`` / ``bnd_*`` arrays split them into interior and boundary
    edges (``bnd_src_slot`` indexes the payload, ``p * B + s``);
    ``edge_perm`` the original edge id of each slot (0 on pad slots), so
    ``x[edge_perm]`` lays any per-edge array out like the plan."""

    n_local: int
    send_idx: torch.Tensor
    send_mask: torch.Tensor
    edge_src_cat: torch.Tensor
    edge_tgt_local: torch.Tensor
    edge_mask: torch.Tensor
    int_src: torch.Tensor
    int_tgt: torch.Tensor
    int_mask: torch.Tensor
    bnd_src_slot: torch.Tensor
    bnd_tgt: torch.Tensor
    bnd_mask: torch.Tensor
    edge_perm: torch.Tensor

    @property
    def k(self) -> int:
        return int(self.send_idx.shape[0])

    def to(self, device) -> "HaloPlan":
        return dataclasses.replace(self, **{
            name: getattr(self, name).to(device) for name in PLAN_ARRAYS})

    def local(self, rank: int) -> Dict[str, torch.Tensor]:
        """Rank ``rank``'s slice of every array (the leading axis
        dropped): what the device-side functions take."""
        return {name: getattr(self, name)[rank] for name in PLAN_ARRAYS}


def _rank_in_group(groups: np.ndarray, k: int) -> np.ndarray:
    """For ``groups`` sorted ascending (values in ``[0, k)``), each
    entry's position among the entries of its group."""
    counts = np.bincount(groups, minlength=k)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return np.arange(groups.size) - starts[groups]


def build_halo_plan(senders, receivers, num_nodes: int, k: int,
                    edge_mask=None) -> HaloPlan:
    """Partition a graph for packed-halo execution over ``k`` ranks (host,
    numpy; every array equal to JAX's ``build_halo_plan``).  The target is
    the receiver, whose owner keeps the edge; the source is gathered,
    possibly from another rank.  ``num_nodes`` must be a multiple of ``k``
    (pad the node rows first).

    Vectorised where JAX's ``build_halo_plan`` loops over edges: the
    boundary sets are one ``np.unique`` of (source owner, target owner,
    sender) keys, so each pair's slots follow ``np.unique``'s order, and
    the edges keep their original order within an owner (stable sorts by
    owner)."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    e = senders.shape[0]
    emask = (np.ones(e, bool) if edge_mask is None
             else np.asarray(edge_mask, bool))
    if num_nodes % k:
        raise ValueError(f"num_nodes {num_nodes} is not a multiple of k {k}:"
                         " pad the node rows first")
    n_local = num_nodes // k
    owner_s = (senders // n_local).astype(np.int64)
    owner_t = (receivers // n_local).astype(np.int64)

    # per pair (p -> q, p != q): the sources owned by p that q's edges read
    cross = emask & (owner_s != owner_t)
    keys = ((owner_s[cross] * k + owner_t[cross]) * num_nodes
            + senders[cross].astype(np.int64))
    uniq = np.unique(keys)
    u_pair = uniq // num_nodes
    u_slot = _rank_in_group(u_pair, k * k)
    b = max(int(np.bincount(u_pair, minlength=k * k).max()), 1)
    p_u, q_u = u_pair // k, u_pair % k
    send_idx = np.zeros((k, k, b), np.int32)
    send_mask = np.zeros((k, k, b), bool)
    send_idx[p_u, q_u, u_slot] = uniq % num_nodes - p_u * n_local
    send_mask[p_u, q_u, u_slot] = True

    # the live edges by owner, in their original order within one
    live = np.nonzero(emask)[0]
    live = live[np.argsort(owner_t[live], kind="stable")]
    q = owner_t[live]
    e_loc = max(int(np.bincount(q, minlength=k).max()), 1)
    tgt = receivers[live] - q * n_local
    inside = owner_s[live] == q
    slot = np.zeros(live.size, np.int64)   # payload slot p * B + s
    out = live[~inside]
    out_keys = ((owner_s[out] * k + owner_t[out]) * num_nodes
                + senders[out].astype(np.int64))
    slot[~inside] = (owner_s[out] * b
                     + u_slot[np.searchsorted(uniq, out_keys)])
    cat = np.where(inside, senders[live] - q * n_local, n_local + slot)

    def per_owner(width, sel, values):
        arrays = [np.zeros((k, width), np.int32) for _ in values]
        mask = np.zeros((k, width), bool)
        rows, cols = q[sel], _rank_in_group(q[sel], k)
        for a, v in zip(arrays, values):
            a[rows, cols] = v[sel]
        mask[rows, cols] = True
        return arrays, mask

    all_edges = np.ones(live.size, bool)
    (edge_src_cat, edge_tgt_local, edge_perm), edge_mask_out = per_owner(
        e_loc, all_edges, (cat, tgt, live))
    n_int = np.bincount(q[inside], minlength=k)
    n_bnd = np.bincount(q[~inside], minlength=k)
    (int_src, int_tgt), int_mask = per_owner(
        max(int(n_int.max()), 1), inside, (cat, tgt))
    (bnd_src_slot, bnd_tgt), bnd_mask = per_owner(
        max(int(n_bnd.max()), 1), ~inside, (slot, tgt))
    t = torch.from_numpy
    return HaloPlan(
        n_local=n_local, send_idx=t(send_idx), send_mask=t(send_mask),
        edge_src_cat=t(edge_src_cat), edge_tgt_local=t(edge_tgt_local),
        edge_mask=t(edge_mask_out), int_src=t(int_src), int_tgt=t(int_tgt),
        int_mask=t(int_mask), bnd_src_slot=t(bnd_src_slot),
        bnd_tgt=t(bnd_tgt), bnd_mask=t(bnd_mask), edge_perm=t(edge_perm))


def halo_stats(plan: HaloPlan, payload_dim: int, dtype_bytes: int = 4,
               num_nodes: int | None = None) -> dict:
    """Bytes a rank moves in one packed exchange of a ``[*, payload_dim]``
    payload, against the v0 all-gather: ``wire_bytes`` the (k - 1) peer
    blocks of B slots each, padding included (what the all-to-all moves);
    ``useful_bytes`` the real boundary rows; ``allgather_bytes`` the
    ``N - n_local`` rows an all-gather brings in."""
    send_mask = plan.send_mask.numpy()
    k, _, b = send_mask.shape
    n = num_nodes if num_nodes is not None else k * plan.n_local
    off_diag = send_mask.sum() - sum(send_mask[p, p].sum() for p in range(k))
    return {
        "k": k,
        "slots_per_pair": b,
        "payload_dim": payload_dim,
        "wire_bytes": (k - 1) * b * payload_dim * dtype_bytes,
        "useful_bytes": int(off_diag) * payload_dim * dtype_bytes // k,
        "allgather_bytes": (n - plan.n_local) * payload_dim * dtype_bytes,
    }


def _payload(h_local: torch.Tensor, plan_local: Mapping) -> torch.Tensor:
    """The rows this rank sends, ``[k, B, d]`` (pad slots zero)."""
    mask = plan_local["send_mask"][..., None].to(h_local.dtype)
    return h_local[plan_local["send_idx"]] * mask


def halo_catalog(h_local: torch.Tensor, plan_local: Mapping, mesh: Mesh,
                 axis: str = "gp") -> torch.Tensor:
    """One all-to-all of the boundary payload; returns the catalog
    ``[n_local + k * B, d]``: this rank's rows, then slot s received from
    rank p at row ``n_local + p * B + s``.  ``edge_src_cat`` indexes it.
    The payload width is free: a model whose message needs more than the
    two endpoints' rows (spherical harmonics, radial features) runs its
    own edge work over the catalog; an equivariant model sends its flat
    irreps row."""
    recv = differentiable.all_to_all(mesh, _payload(h_local, plan_local),
                                     axis)
    return torch.cat([h_local, recv.reshape(-1, h_local.shape[-1])])


def packed_halo_aggregate(h_local: torch.Tensor, plan_local: Mapping,
                          message_fn: Callable, mesh: Mesh,
                          axis: str = "gp") -> torch.Tensor:
    """One packed-halo round: the catalog, then gather -> ``message_fn(
    h_tgt, h_src)`` -> masked segment sum onto the local targets."""
    catalog = halo_catalog(h_local, plan_local, mesh, axis)
    tgt = plan_local["edge_tgt_local"]
    msg = message_fn(h_local[tgt], catalog[plan_local["edge_src_cat"]])
    return segment_sum(msg, tgt, h_local.shape[0],
                       mask=plan_local["edge_mask"])


class _AllToAllStart(torch.autograd.Function):
    """Starts ``collectives.all_to_all`` on axis 0 with ``async_op=True``
    and returns its output buffer, filled once the work that it appends to
    ``pending`` has been waited on; backward a blocking all-to-all."""

    @staticmethod
    def forward(ctx, x, mesh, axis, pending):
        ctx.mesh, ctx.axis = mesh, axis
        group = mesh.group(axis)
        if group is None:
            return x.clone()
        src = x.contiguous()
        out = torch.empty_like(src)
        pending.append(dist.all_to_all_single(out, src, group=group,
                                              async_op=True))
        return out

    @staticmethod
    def backward(ctx, g):
        return collectives.all_to_all(ctx.mesh, g, ctx.axis), None, None, None


def packed_halo_aggregate_overlapped(h_local: torch.Tensor,
                                     plan_local: Mapping,
                                     message_fn: Callable, mesh: Mesh,
                                     axis: str = "gp") -> torch.Tensor:
    """The packed round with the exchange overlapped: the all-to-all
    starts asynchronously, the interior edges' gather -> message -> sum
    is enqueued while it runs, then ``wait()`` and the boundary edges
    over the payload; ``interior + boundary`` as the JAX function adds
    them (the same masked sums as ``packed_halo_aggregate`` in another
    order).  Whether the exchange and the interior work overlap depends
    on the backend: gloo runs the exchange on its own thread."""
    pending: list = []
    recv = _AllToAllStart.apply(_payload(h_local, plan_local), mesh, axis,
                                pending)
    n = h_local.shape[0]
    int_tgt = plan_local["int_tgt"]
    acc = segment_sum(message_fn(h_local[int_tgt],
                                 h_local[plan_local["int_src"]]),
                      int_tgt, n, mask=plan_local["int_mask"])
    for work in pending:
        work.wait()
    flat = recv.reshape(-1, h_local.shape[-1])
    bnd_tgt = plan_local["bnd_tgt"]
    return acc + segment_sum(message_fn(h_local[bnd_tgt],
                                        flat[plan_local["bnd_src_slot"]]),
                             bnd_tgt, n, mask=plan_local["bnd_mask"])


_NODE_FIELDS = ("atoms", "pos", "graph_id", "node_mask")


def gp_local_batch(batch: GraphBatch, plan: HaloPlan) -> GraphBatch:
    """``batch`` in the plan's edge layout: senders the catalog indices
    (``edge_src_cat``), receivers and the edge mask the plan's slots,
    flattened to ``[k * E_loc]``; node rows unchanged (N a multiple of k)
    and the graph fields kept whole.  ``gp_rank_batch`` cuts it."""
    return dataclasses.replace(
        batch, senders=plan.edge_src_cat.reshape(-1).to(batch.senders.device),
        receivers=plan.edge_tgt_local.reshape(-1).to(batch.senders.device),
        edge_mask=plan.edge_mask.reshape(-1).to(batch.senders.device),
        triplets=None)


def gp_rank_batch(batch: GraphBatch, plan: HaloPlan, rank: int
                  ) -> GraphBatch:
    """Rank ``rank``'s part of ``gp_local_batch(batch, plan)``, as
    ``shard_map`` splits it: the node fields (and ``graph_id``) by row
    block, the edge fields by ``E_loc`` block, ``y``, ``graph_mask`` and
    ``first_node`` whole."""
    if batch.num_nodes != plan.k * plan.n_local:
        raise ValueError(f"the batch has {batch.num_nodes} node rows, the "
                         f"plan {plan.k} x {plan.n_local}")
    local = gp_local_batch(batch, plan)
    n, e = plan.n_local, plan.edge_src_cat.shape[1]
    return dataclasses.replace(
        local, **{f: getattr(local, f)[rank * n:(rank + 1) * n]
                  for f in _NODE_FIELDS},
        **{f: getattr(local, f)[rank * e:(rank + 1) * e]
           for f in ("senders", "receivers", "edge_mask")})


def gp_edge_aggregate(h_local: torch.Tensor, senders: torch.Tensor,
                      receivers: torch.Tensor, edge_mask: torch.Tensor,
                      message_fn: Callable, num_nodes_total: int,
                      mesh: Mesh, axis: str = "gp") -> torch.Tensor:
    """One v0 round over this rank's edges (global node ids): all-gather
    the rows, ``message_fn(h[receivers], h[senders])``, masked segment sum
    into all N rows, reduce-scatter back to the owners."""
    h_all = gp_gather_nodes(mesh, h_local, axis)
    msg = message_fn(h_all[receivers], h_all[senders])
    partial = segment_sum(msg, receivers, num_nodes_total, mask=edge_mask)
    return gp_scatter_nodes(mesh, partial, axis)


def gp_egnn_layer(layer, h_local: torch.Tensor, pos_local: torch.Tensor,
                  plan_local: Mapping, mesh: Mesh, axis: str = "gp"):
    """An ``EGNNLayer`` (``aggr`` sum) over the packed halo: the payload is
    ``[h, pos]``, the message carries the position message and a count
    channel, so ``x' = x + sum_j pos_msg / max(count, 1)`` as the layer's
    segment mean; returns ``(layer.update(h, sum_j msg), x')``."""
    if layer.aggr not in ("sum", "add"):
        raise ValueError(f"gp_egnn_layer needs aggr 'sum'/'add', got "
                         f"{layer.aggr!r}")
    d = h_local.shape[-1]
    payload = torch.cat([h_local, pos_local], dim=-1)

    def message_fn(tgt, src):
        pos_diff = tgt[..., d:] - src[..., d:]
        dists = safe_norm(pos_diff, keepdim=True)
        msg, scale = layer.message(tgt[..., :d], src[..., :d], dists)
        return torch.cat([msg, pos_diff * scale, torch.ones_like(dists)],
                         dim=-1)

    agg = packed_halo_aggregate(payload, plan_local, message_fn, mesh, axis)
    cnt = torch.clamp_min(agg[..., -1:], 1.0)
    return (layer.update(h_local, agg[..., :-4]),
            pos_local + agg[..., -4:-1] / cnt)
