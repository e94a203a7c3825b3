"""SphereNet, spherical message passing with torsion (port of
``models/spherenet.py``).

Triplets and quads come precomputed on the batch (``GraphBatch.triplets``,
``with_quads``).  ``spherenet_geometry`` computes each edge's length, each
triplet's angle at j and its torsion: the dihedral to every candidate fourth
point k_n (the quads), folded to (0, 2 pi] and the least one kept per
triplet by a masked segment min.  The triplet fold of ``update_e`` sums over
ascending ``idx_ji`` through the sorted segment sum (K3 on the card, over
``ops.sorted_segsum.ascending_plan``); the edge -> node sums of
``update_v``, ``update_u`` and the pool are ``ops.scatter.segment_sum`` (K4).

``torsion_fold``: ``'atan2'`` evaluates each quad's torsion directly;
``'widekey'`` (the default) ranks the candidates by a piecewise-linear
pseudo-angle key of (a, b), monotone in the (0, 2 pi] torsion, and recovers
the exact angle per triplet after the min.  The coplanar candidate k_n == k
is pinned to exactly 2 pi in both; the port compares ``k_n`` with ``idx_k``
as integers (the JAX package round-trips ``idx_k`` through float32, exact
only below 2^24).

Module names are the flax names (``init_e``, ``init_v``, ``update_es[b]``
for ``update_e_b``, ``update_vs[b]`` for ``update_v_b``, ``dist_emb.freq``;
``lin_k`` as ``lins[k]``), so ``weights.spherenet_from_jax`` carries a JAX
model's values over.  Layers the reference leaves on torch's defaults keep
them (``init_e.lin_rbf_0``, ``init_e.lin``, the bias of ``lin_up`` in
``update_v``); the rest are GlorotOrthogonal with zero biases.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..graph import GraphBatch
from ..nn.basic import torch_linear_init_
from ..ops.dimenet_basis import (DistEmb, angle_cbf, angle_emb, angle_product,
                                 sph_bessel_rbf, torsion_cbf, torsion_emb,
                                 torsion_product)
from ..ops.norms import safe_arctan2, safe_norm
from ..ops.scatter import segment_sum
from .dimenet import (SQRT3, ResidualLayer, TripletFold, atom_embedding,
                      chunk_slices, dense, remat, swish)
from .pooling import POOL

TWO_PI = 2 * math.pi


class SphereNetInit(nn.Module):
    """init_e: edge features from the endpoints' embeddings and the radial
    basis; returns (e1, e2)."""

    def __init__(self, num_radial: int, hidden: int,
                 use_node_features: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.use_node_features = use_node_features
        if use_node_features:
            self.emb = atom_embedding(hidden, g)
        else:
            self.node_embedding = nn.Parameter(
                torch.randn(hidden, generator=g))
        self.lin_rbf_0 = dense(num_radial, hidden, g, init="torch")
        self.lin = dense(3 * hidden, hidden, g, init="torch")
        self.lin_rbf_1 = dense(num_radial, hidden, g, bias=False)

    def forward(self, atoms, rbf, receivers, senders):
        if self.use_node_features:
            x = self.emb(atoms) - SQRT3
        else:
            x = self.node_embedding.expand(atoms.shape[0], -1)
        rbf0 = swish(self.lin_rbf_0(rbf))
        e1 = swish(self.lin(torch.cat([x[receivers], x[senders], rbf0], -1)))
        return e1, self.lin_rbf_1(rbf) * e1


class SphereNetUpdateE(nn.Module):
    """update_e: the triplet/torsion core.  ``bases_of(s)`` gives the
    (sbf, tbf) rows of the triplets ``s``; the fold sums them chunk by
    chunk (``fold``)."""

    def __init__(self, hidden: int, int_emb_size: int,
                 basis_emb_size_dist: int, basis_emb_size_angle: int,
                 basis_emb_size_torsion: int, num_spherical: int,
                 num_radial: int, num_before_skip: int, num_after_skip: int,
                 *, generator: torch.Generator):
        super().__init__()
        g, ns, nr = generator, num_spherical, num_radial
        self.lin_ji = dense(hidden, hidden, g)
        self.lin_kj = dense(hidden, hidden, g)
        self.lin_rbf1 = dense(nr, basis_emb_size_dist, g, bias=False)
        self.lin_rbf2 = dense(basis_emb_size_dist, hidden, g, bias=False)
        self.lin_down = dense(hidden, int_emb_size, g, bias=False)
        self.lin_sbf1 = dense(ns * nr, basis_emb_size_angle, g, bias=False)
        self.lin_sbf2 = dense(basis_emb_size_angle, int_emb_size, g, bias=False)
        self.lin_t1 = dense(ns * ns * nr, basis_emb_size_torsion, g, bias=False)
        self.lin_t2 = dense(basis_emb_size_torsion, int_emb_size, g, bias=False)
        self.lin_up = dense(int_emb_size, hidden, g, bias=False)
        self.res_before = nn.ModuleList(ResidualLayer(hidden, generator=g)
                                        for _ in range(num_before_skip))
        self.lin = dense(hidden, hidden, g)
        self.res_after = nn.ModuleList(ResidualLayer(hidden, generator=g)
                                       for _ in range(num_after_skip))
        self.lin_rbf = dense(nr, hidden, g, bias=False)

    def pre(self, x1, rbf0):
        """``(x_ji, x_kj)``: the edge features before the triplet pass."""
        x_ji = swish(self.lin_ji(x1))
        x_kj = swish(self.lin_kj(x1)) * self.lin_rbf2(self.lin_rbf1(rbf0))
        return x_ji, swish(self.lin_down(x_kj))

    def rows(self, s: slice, x_kj, bases_of, idx_kj) -> torch.Tensor:
        """The triplet pass's rows of the triplets ``s``: ``x_kj`` gathered
        at their edge k -> j times both projected bases."""
        sbf, tbf = bases_of(s)
        y = x_kj[idx_kj[s]] * self.lin_sbf2(self.lin_sbf1(sbf))
        return y * self.lin_t2(self.lin_t1(tbf))

    def forward(self, e, rbf0, bases_of, idx_kj, fold: TripletFold):
        x1, _ = e
        x_ji, x_kj = self.pre(x1, rbf0)
        # bound by value: the backward calls the rows again to recompute
        folded = fold.sum(functools.partial(self.rows, x_kj=x_kj,
                                            bases_of=bases_of, idx_kj=idx_kj))
        e1 = x_ji + swish(self.lin_up(folded))
        for layer in self.res_before:
            e1 = layer(e1)
        e1 = swish(self.lin(e1)) + x1
        for layer in self.res_after:
            e1 = layer(e1)
        return e1, self.lin_rbf(rbf0) * e1


class SphereNetUpdateV(nn.Module):
    """update_v: e2 summed into the receivers (K4 on the card), then the
    node MLP.  ``lin_up``'s bias keeps torch's default init."""

    def __init__(self, hidden: int, out_emb_channels: int, out_dim: int,
                 num_output_layers: int, output_init: str = "GlorotOrthogonal",
                 *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.lin_up = dense(hidden, out_emb_channels, g)
        torch_linear_init_(self.lin_up.bias, hidden, g)
        self.lins = nn.ModuleList(dense(out_emb_channels, out_emb_channels, g)
                                  for _ in range(num_output_layers))
        self.lin = dense(out_emb_channels, out_dim, g, bias=False,
                         init="zeros" if output_init == "zeros" else "glorot")

    def forward(self, e, receivers, num_nodes, edge_mask):
        v = segment_sum(e[1], receivers, num_nodes, mask=edge_mask)
        v = self.lin_up(v)
        for lin in self.lins:
            v = swish(lin(v))
        return self.lin(v)


class SphereNetUpdateU(nn.Module):
    """update_u: the graph-level accumulator u + sum of v over each graph
    (K4 on the card); built but unused by the model's forward, as in the
    reference."""

    def forward(self, u, v, batch: GraphBatch):
        return u + segment_sum(v, batch.graph_id, batch.num_graphs,
                               mask=batch.node_mask)


def _widekey(a_t: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear pseudo-angle in (0, 4] of (a, b), monotone with the
    (0, 2 pi] torsion atan2(b, a); theta 0 maps to 4 (2 pi)."""
    f = b_t.abs() / torch.clamp_min(a_t.abs() + b_t.abs(), 1e-30)
    key = torch.where(a_t >= 0, torch.where(b_t >= 0, f, 4.0 - f),
                      torch.where(b_t >= 0, 2.0 - f, 2.0 + f))
    return torch.where(key == 0.0, torch.full_like(key, 4.0), key)


def _widekey_angle(key: torch.Tensor) -> torch.Tensor:
    """The (0, 2 pi] torsion of a segment-min key (+inf: no candidate -> 0)."""
    kq = torch.clamp(torch.floor(key), 0, 3)
    fr = key - kq
    a_hat = torch.where(kq == 0, 1 - fr, torch.where(
        kq == 1, -fr, torch.where(kq == 2, -(1 - fr), fr)))
    b_hat = torch.where(kq == 0, fr, torch.where(
        kq == 1, 1 - fr, torch.where(kq == 2, -fr, -(1 - fr))))
    th = safe_arctan2(b_hat, a_hat)
    th = torch.where(th <= 0, th + TWO_PI, th)
    th = torch.where(key >= 4.0, torch.full_like(th, TWO_PI), th)
    return torch.where(torch.isfinite(key), th, torch.zeros_like(th))


def spherenet_geometry(batch: GraphBatch, quad_chunk: Optional[int] = None,
                       torsion_fold: str = "widekey"):
    """(dist [E], angle [T], torsion [T]) from the positions: the angle at j
    between (i - j) and (k - j) in (0, pi); the torsion the least dihedral,
    folded to (0, 2 pi], between the planes (ji, jk) and (ji, jk_n) over the
    triplet's quads (0 for a triplet without one).  ``quad_chunk`` folds the
    quads in slices of that many (the last shorter), each slice's minimum
    under checkpoint (its gathered positions are recomputed in a backward
    to the positions, not kept), combined by ``torch.minimum``."""
    if torsion_fold not in ("widekey", "atan2"):
        raise ValueError(f"torsion_fold must be 'widekey' or 'atan2', got "
                         f"{torsion_fold!r}")
    tri, pos = batch.triplets, batch.pos
    dist = safe_norm(pos[batch.receivers] - pos[batch.senders])
    pos_ji = pos[tri.idx_i] - pos[tri.idx_j]
    pos_jk = pos[tri.idx_k] - pos[tri.idx_j]
    a = (pos_ji * pos_jk).sum(-1)
    b = safe_norm(torch.linalg.cross(pos_ji, pos_jk, dim=-1))
    angle = safe_arctan2(b, a)
    num_t = tri.idx_i.shape[0]
    widekey = torsion_fold == "widekey"
    if widekey:
        plane1_t = torch.linalg.cross(pos_ji, pos_jk, dim=-1)
        inv_dji = 1.0 / torch.clamp_min(safe_norm(pos_ji), 1e-9)

    def quad_min(q, kn, qmask):
        """Raw per-triplet min over one slice of quads (+inf where none)."""
        pos_j = pos[tri.idx_j[q]]
        pos_ji_q = pos[tri.idx_i[q]] - pos_j
        pos_jk_q = pos[kn] - pos_j
        plane2 = torch.linalg.cross(pos_ji_q, pos_jk_q, dim=-1)
        degen = kn == tri.idx_k[q]
        if widekey:
            plane1 = plane1_t[q]
            a_t = (plane1 * plane2).sum(-1)
            b_t = (torch.linalg.cross(plane1, plane2, dim=-1)
                   * pos_ji_q).sum(-1) * inv_dji[q]
            val = torch.where(degen, torch.full_like(a_t, 4.0),
                              _widekey(a_t, b_t))
        else:
            plane1 = torch.linalg.cross(pos_ji_q, pos[tri.idx_k[q]] - pos_j,
                                        dim=-1)
            a_t = (plane1 * plane2).sum(-1)
            b_t = (torch.linalg.cross(plane1, plane2, dim=-1)
                   * pos_ji_q).sum(-1) / torch.clamp_min(safe_norm(pos_ji_q),
                                                         1e-9)
            t1 = safe_arctan2(b_t, a_t)
            t1 = torch.where(t1 <= 0, t1 + TWO_PI, t1)
            val = torch.where(degen, torch.full_like(t1, TWO_PI), t1)
        val = torch.where(qmask, val, torch.full_like(val, torch.inf))
        out = val.new_full((num_t,), torch.inf)
        return out.scatter_reduce(0, q.long(), val, "amin", include_self=True)

    slices = chunk_slices(tri.q_trip.shape[0], quad_chunk)
    raw = None
    for s in slices:
        args = (tri.q_trip[s], tri.q_kn[s], tri.q_mask[s])
        part = remat(quad_min, *args) if len(slices) > 1 else quad_min(*args)
        raw = part if raw is None else torch.minimum(raw, part)
    if widekey:
        torsion = _widekey_angle(raw)
    else:
        torsion = torch.where(torch.isfinite(raw), raw, torch.zeros_like(raw))
    return dist, angle, torsion


class SphereNetModel(nn.Module):
    """SphereNet with the JAX package's constructor surface and defaults;
    ``forward(batch)`` returns ``[num_graphs, out_dim]`` and needs
    ``batch.triplets`` with quads.  ``in_dim`` is accepted and unused.
    ``triplet_chunk`` evaluates the bases and folds the triplets in slices
    (the last shorter; with more than one, each slice's bases, projections
    and gather under checkpoint, ``TripletFold.sum``), ``quad_chunk`` the
    torsion candidates (each slice under checkpoint).

    Parameters are drawn on the CPU from ``generator`` (seeded with 0 when
    None), then moved to ``device`` (default ``"cuda"``, which raises when
    CUDA is absent)."""

    def __init__(self, cutoff: float = 10.0, num_layers: int = 4,
                 hidden_channels: int = 128, in_dim: int = 1,
                 out_dim: int = 1, int_emb_size: int = 64,
                 basis_emb_size_dist: int = 8, basis_emb_size_angle: int = 8,
                 basis_emb_size_torsion: int = 8, out_emb_channels: int = 128,
                 num_spherical: int = 7, num_radial: int = 6,
                 envelope_exponent: int = 5, num_before_skip: int = 1,
                 num_after_skip: int = 2, num_output_layers: int = 2,
                 output_init: str = "GlorotOrthogonal",
                 use_node_features: bool = True, pool: str = "sum",
                 triplet_chunk: Optional[int] = None,
                 quad_chunk: Optional[int] = None,
                 torsion_fold: str = "widekey", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if pool not in POOL:
            raise ValueError(f"pool must be one of {sorted(POOL)}, got {pool!r}")
        if torsion_fold not in ("widekey", "atan2"):
            raise ValueError(f"torsion_fold must be 'widekey' or 'atan2', got "
                             f"{torsion_fold!r}")
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.out_dim, self.pool, self.cutoff = out_dim, pool, cutoff
        self.num_spherical, self.num_radial = num_spherical, num_radial
        self.triplet_chunk, self.quad_chunk = triplet_chunk, quad_chunk
        self.torsion_fold = torsion_fold
        self.dist_emb = DistEmb(num_radial, cutoff, envelope_exponent,
                                zero_outside=False)
        self.init_e = SphereNetInit(num_radial, hidden_channels,
                                    use_node_features, generator=g)
        v_args = (hidden_channels, out_emb_channels, out_dim,
                  num_output_layers, output_init)
        self.init_v = SphereNetUpdateV(*v_args, generator=g)
        self.update_es = nn.ModuleList(
            SphereNetUpdateE(hidden_channels, int_emb_size,
                             basis_emb_size_dist, basis_emb_size_angle,
                             basis_emb_size_torsion, num_spherical,
                             num_radial, num_before_skip, num_after_skip,
                             generator=g)
            for _ in range(num_layers))
        self.update_vs = nn.ModuleList(SphereNetUpdateV(*v_args, generator=g)
                                       for _ in range(num_layers))
        self.to(dev)

    def _bases_of(self, batch: GraphBatch, dist, angle, torsion):
        """``s -> (sbf, tbf)`` of the triplets ``s``: slices of the
        materialised bases, or (chunked) evaluated per chunk from the
        per-edge radial table."""
        tri, ns, nr = batch.triplets, self.num_spherical, self.num_radial
        if self.triplet_chunk is not None:
            rbf_sph = sph_bessel_rbf(dist, ns, nr, self.cutoff)

            def bases_of(s: slice):
                rows = rbf_sph[tri.idx_kj[s]]
                return (angle_product(rows, angle_cbf(angle[s], ns)),
                        torsion_product(rows, torsion_cbf(angle[s],
                                                          torsion[s], ns)))
            return bases_of
        sbf = angle_emb(dist, angle, tri.idx_kj, ns, nr, self.cutoff)
        tbf = torsion_emb(dist, angle, torsion, tri.idx_kj, ns, nr, self.cutoff)
        return lambda s: (sbf[s], tbf[s])

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        tri = batch.triplets
        if tri is None or tri.q_trip is None:
            raise ValueError("SphereNet needs triplet and quad indices "
                             "(with_quads=True)")
        dist, angle, torsion = spherenet_geometry(batch, self.quad_chunk,
                                                  self.torsion_fold)
        rbf = self.dist_emb(dist)
        bases_of = self._bases_of(batch, dist, angle, torsion)
        fold = TripletFold(tri.idx_ji, tri.t_mask, batch.num_edges,
                           self.triplet_chunk)
        e = self.init_e(batch.atoms, rbf, batch.receivers, batch.senders)
        v = self.init_v(e, batch.receivers, batch.num_nodes, batch.edge_mask)
        for update_e, update_v in zip(self.update_es, self.update_vs):
            e = update_e(e, rbf, bases_of, tri.idx_kj, fold)
            # v is replaced each layer, unlike DimeNet's accumulated P
            v = update_v(e, batch.receivers, batch.num_nodes, batch.edge_mask)
        return POOL[self.pool](v, batch)
