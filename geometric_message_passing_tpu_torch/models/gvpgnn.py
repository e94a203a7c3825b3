"""GVP-GNN (port of ``models/gvpgnn.py``): ``GVPConv``, ``GVPConvLayer`` and
``GVPGNNModel``.

``GVPConv`` with the default chain (vector gate, ReLU/sigmoid) keeps flat
per-GVP weights ``gvp{k}_{wh,wv,ws,bs,wsv,bsv}`` in the JAX shapes
(``wh [vi, h]``, ``bs [so]``, ...) and runs the message pass through one of
two routes, chosen by ``use_pallas`` as in the JAX package:

* ``use_pallas=True``: ``ops.gvp_message.gvp_message``, the hand-written
  kernels (K5) on the card, their plain versions on the CPU;
* ``use_pallas=False`` (the default): ``gvp_message_plain``, the port of the
  JAX package's default route, optionally under ``torch.utils.checkpoint``
  (``remat``) and with ``seg_plans`` (the sorted segment-sum kernel for the
  merged receiver sum and the sender gather's backward).

Other activations or gates run a chain of ``nn.gvp.GVP`` modules
(``gvps[k]``, flax ``gvp_k``).  Module names follow the flax tree, so
``weights.gvp_from_jax`` carries a JAX model's values over.

Training mode (``module.train()``) is the JAX package's ``train=True``: the
layers' ``GVPDropout`` is on, drawing from the model's own generator on the
batch's device, seeded from the generator that drew the initial weights and
reseeded by ``fit_regression`` from its ``seed``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..graph import GraphBatch
from ..nn import gvp
from ..nn.basic import Embedding, OutputLinear, linear, torch_linear_init_
from ..ops.gvp_message import gvp_message, gvp_message_plain
from ..ops.norms import safe_norm
from ..ops.radial import radial_embedding
from ..ops.scatter import segment_sum
from ..ops.sorted_segsum import SegmentPlan
from .pooling import POOL


class _DropoutRNG:
    """One dropout generator per device, seeded with ``seed``.  A deep copy
    (``fit_regression`` trains one) starts again from the seed;
    ``fit_resident`` calls ``reseed`` with a seed drawn from its own, so the
    masks follow the fit's seed, as the JAX package's dropout stream does.
    ``state`` and ``set_state`` carry the stream across a checkpoint."""

    def __init__(self, seed: int):
        self.seed = seed
        self._gens: Dict[torch.device, torch.Generator] = {}

    def reseed(self, seed: int) -> None:
        self.seed = seed
        self._gens.clear()

    def state(self) -> dict:
        """The seed and each device generator's state (CPU byte tensors)."""
        return {"seed": self.seed,
                "gens": {str(dev): gen.get_state()
                         for dev, gen in self._gens.items()}}

    def set_state(self, state: dict) -> None:
        """Put the generators back where ``state`` found them."""
        self.reseed(int(state["seed"]))
        for dev, gen_state in state["gens"].items():
            gen = torch.Generator(device=dev)
            gen.set_state(gen_state.cpu())
            self._gens[torch.device(dev)] = gen

    def __call__(self, device: torch.device) -> torch.Generator:
        gen = self._gens.get(device)
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(self.seed)
            self._gens[device] = gen
        return gen

    def __deepcopy__(self, memo):
        return _DropoutRNG(self.seed)


class GVPConv(nn.Module):
    """Message = the GVP chain over ``cat[(s_j, V_j), edge, (s_i, V_i)]``,
    mean- (or add-) aggregated at the receivers.  ``forward`` returns
    ``(s [N, ns], V [N, nv, 3])``."""

    def __init__(self, node_dims: Tuple[int, int], edge_dims: Tuple[int, int],
                 n_layers: int = 3, aggr: str = "mean", act_s: str = "relu",
                 act_v: str = "sigmoid", vector_gate: bool = True,
                 use_pallas: bool = False, remat: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        if aggr not in ("mean", "add"):
            raise ValueError(f"aggr must be 'mean' or 'add', got {aggr!r}")
        self.node_dims, self.edge_dims = tuple(node_dims), tuple(edge_dims)
        self.n_layers, self.aggr = n_layers, aggr
        self.use_pallas, self.remat = use_pallas, remat
        (si, vi), (se, ve) = node_dims, edge_dims
        dims_chain = [(2 * si + se, 2 * vi + ve)] + [tuple(node_dims)] * n_layers
        self.flat = vector_gate and act_s == "relu" and act_v == "sigmoid"
        if not self.flat:
            self.gvps = nn.ModuleList(
                gvp.GVP(dims_chain[k], dims_chain[k + 1],
                        act_s=None if k == n_layers - 1 else act_s,
                        act_v=None if k == n_layers - 1 else act_v,
                        vector_gate=vector_gate, generator=generator)
                for k in range(n_layers))
            return
        for k in range(n_layers):
            (sik, vik), (sok, vok) = dims_chain[k], dims_chain[k + 1]
            hk = max(vik, vok)
            # torch.nn.Linear's default init, fan-in = the input width
            for name, shape, fan_in in (
                    ("wh", (vik, hk), vik), ("wv", (hk, vok), hk),
                    ("ws", (sik + hk, sok), sik + hk), ("bs", (sok,), sik + hk),
                    ("wsv", (sok, vok), sok), ("bsv", (vok,), sok)):
                t = torch_linear_init_(torch.empty(shape), fan_in, generator)
                self.register_parameter(f"gvp{k}_{name}", nn.Parameter(t))

    def chain_weights(self) -> list:
        """The flat weights in the kernel's order: per GVP Wh Wv Ws bs Wsv bsv."""
        return [getattr(self, f"gvp{k}_{name}") for k in range(self.n_layers)
                for name in ("wh", "wv", "ws", "bs", "wsv", "bsv")]

    def forward(self, x, senders, receivers, edge_attr, edge_mask,
                seg_plans: Optional[Dict[str, SegmentPlan]] = None,
                aggr: Optional[str] = None):
        aggr = aggr or self.aggr
        if not self.flat:
            if seg_plans is not None:
                raise ValueError(
                    "seg_plans (the sorted segment-sum path) is only "
                    "implemented for the default relu/sigmoid vector-gate "
                    "chain; drop seg_plans for general configs")
            return self._module_chain(x, senders, receivers, edge_attr,
                                      edge_mask, aggr)
        s, v = x
        es, ev = edge_attr
        planes = [v[..., c].contiguous() for c in range(3)]
        eplanes = [ev[..., c].contiguous() for c in range(3)]
        ws = self.chain_weights()
        if self.use_pallas:
            if seg_plans is not None:
                raise ValueError("use_pallas and seg_plans are exclusive")
            out = gvp_message(senders, receivers, edge_mask, s.contiguous(),
                              *planes, es.contiguous(), *eplanes, *ws)
        elif self.remat:
            out = checkpoint(gvp_message_plain, senders, receivers, edge_mask,
                             s, *planes, es, *eplanes, ws, self.n_layers,
                             seg_plans, use_reentrant=False)
        else:
            out = gvp_message_plain(senders, receivers, edge_mask, s, *planes,
                                    es, *eplanes, ws, self.n_layers,
                                    seg_plans=seg_plans)
        ssum, sx, sy, sz, cnt = out
        if aggr == "mean":
            cnt = torch.clamp_min(cnt, 1.0)
            ssum, sx, sy, sz = ssum / cnt, sx / cnt, sy / cnt, sz / cnt
        return ssum, torch.stack([sx, sy, sz], dim=-1)

    def _module_chain(self, x, senders, receivers, edge_attr, edge_mask, aggr):
        s, v = x
        es, ev = edge_attr
        n = s.shape[0]
        h = (torch.cat([s[senders], es, s[receivers]], dim=-1),
             torch.cat([v[senders], ev, v[receivers]], dim=-2))
        for layer in self.gvps:
            h = layer(h)
        ms, mv = h
        ssum = segment_sum(ms, receivers, n, mask=edge_mask)
        vsum = segment_sum(mv.reshape(mv.shape[0], -1), receivers, n,
                           mask=edge_mask).reshape(n, -1, 3)
        if aggr == "mean":
            cnt = torch.clamp_min(segment_sum(s.new_ones((senders.shape[0], 1)),
                                              receivers, n, mask=edge_mask), 1.0)
            ssum, vsum = ssum / cnt, vsum / cnt[..., None]
        return ssum, vsum


class GVPConvLayer(nn.Module):
    """``GVPConv``, then residual + ``GVPLayerNorm``, the pointwise GVP
    feed-forward (``ff[k]``, flax ``ff_k``), residual + ``GVPLayerNorm``
    (without ``residual``: the conv and the feed-forward alone).

    ``autoregressive_x``: messages on backward edges (``src >= dst``) are
    formed from these embeddings instead of ``x``, add-aggregated and divided
    by the total degree.  ``node_mask``: only the masked nodes are updated.
    ``generator`` feeds the dropout in training mode."""

    def __init__(self, node_dims: Tuple[int, int], edge_dims: Tuple[int, int],
                 n_message: int = 3, n_feedforward: int = 2,
                 drop_rate: float = 0.1, act_s: str = "relu",
                 act_v: str = "sigmoid", vector_gate: bool = True,
                 residual: bool = True, use_pallas: bool = False,
                 remat: bool = False, *, generator: torch.Generator):
        super().__init__()
        node_dims = tuple(node_dims)
        self.residual = residual
        self.conv = GVPConv(node_dims, edge_dims, n_message, aggr="mean",
                            act_s=act_s, act_v=act_v, vector_gate=vector_gate,
                            use_pallas=use_pallas, remat=remat,
                            generator=generator)
        if residual:      # the norms exist only where they are used, as in flax
            self.drop0 = gvp.GVPDropout(drop_rate)
            self.drop1 = gvp.GVPDropout(drop_rate)
            self.norm0 = gvp.GVPLayerNorm(node_dims)
            self.norm1 = gvp.GVPLayerNorm(node_dims)
        kw = dict(vector_gate=vector_gate, generator=generator)
        if n_feedforward == 1:
            ff = [gvp.GVP(node_dims, node_dims, act_s=None, act_v=None, **kw)]
        else:
            hid = (4 * node_dims[0], 2 * node_dims[1])
            ff = [gvp.GVP(node_dims, hid, act_s=act_s, act_v=act_v, **kw)]
            ff += [gvp.GVP(hid, hid, act_s=act_s, act_v=act_v, **kw)
                   for _ in range(n_feedforward - 2)]
            ff.append(gvp.GVP(hid, node_dims, act_s=None, act_v=None, **kw))
        self.ff = nn.ModuleList(ff)

    def forward(self, x, senders, receivers, edge_attr, edge_mask,
                autoregressive_x=None, node_mask=None,
                seg_plans: Optional[Dict[str, SegmentPlan]] = None,
                generator: Optional[torch.Generator] = None):
        if autoregressive_x is not None:
            if seg_plans is not None:
                raise ValueError("seg_plans are built against the full "
                                 "edge_mask; the autoregressive split masks "
                                 "differ: drop seg_plans")
            forward = senders < receivers
            dh_f = self.conv(x, senders, receivers, edge_attr,
                             edge_mask & forward, aggr="add")
            dh_b = self.conv(autoregressive_x, senders, receivers, edge_attr,
                             edge_mask & ~forward, aggr="add")
            count = torch.clamp_min(segment_sum(
                x[0].new_ones((senders.shape[0], 1)), receivers, x[0].shape[0],
                mask=edge_mask), 1.0)
            dh = ((dh_f[0] + dh_b[0]) / count,
                  (dh_f[1] + dh_b[1]) / count[..., None])
        else:
            dh = self.conv(x, senders, receivers, edge_attr, edge_mask,
                           seg_plans=seg_plans)
        x_old = x
        if self.residual:
            x = self.norm0(gvp.tuple_sum(x, self.drop0(dh, self.training,
                                                       generator)))
        else:
            x = dh
        h = x
        for layer in self.ff:
            h = layer(h)
        if self.residual:
            x = self.norm1(gvp.tuple_sum(x, self.drop1(h, self.training,
                                                       generator)))
        else:
            x = h
        if node_mask is not None:
            x = (torch.where(node_mask[:, None], x[0], x_old[0]),
                 torch.where(node_mask[:, None, None], x[1], x_old[1]))
        return x


class GVPGNNModel(nn.Module):
    """GVP-GNN with the JAX package's constructor surface (and defaults);
    ``forward(batch, seg_plans=None)`` returns ``[num_graphs, out_dim]``.

    Parameters are drawn on the CPU from ``generator`` (seeded with 0 when
    None), then moved to ``device`` (default ``"cuda"``, which raises when
    CUDA is absent); the dropout generator's seed is drawn from it first."""

    def __init__(self, r_max: float = 10.0, num_bessel: int = 8,
                 num_polynomial_cutoff: int = 5, num_layers: int = 5,
                 in_dim: int = 1, out_dim: int = 1, s_dim: int = 128,
                 v_dim: int = 16, s_dim_edge: int = 32, v_dim_edge: int = 1,
                 pool: str = "sum", residual: bool = True,
                 equivariant_pred: bool = False, use_pallas: bool = False,
                 remat: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        if pool not in POOL:
            raise ValueError(f"pool must be one of {sorted(POOL)}, got {pool!r}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.r_max, self.num_bessel = r_max, num_bessel
        self.num_polynomial_cutoff = num_polynomial_cutoff
        self.s_dim, self.v_dim = s_dim, v_dim
        self.out_dim, self.pool = out_dim, pool
        self.equivariant_pred = equivariant_pred
        self._dropout_rng = _DropoutRNG(int(torch.randint(
            0, 2**62, (), generator=generator)))
        node_dims, edge_dims = (s_dim, v_dim), (s_dim_edge, v_dim_edge)

        self.emb_in = Embedding(in_dim, s_dim)
        with torch.no_grad():
            self.emb_in.weight.normal_(0.0, 1.0, generator=generator)
        self.layer_norm_0 = nn.LayerNorm(s_dim, eps=1e-5)
        self.W_v = gvp.GVP((s_dim, 0), node_dims, act_s=None, act_v=None,
                           vector_gate=True, generator=generator)
        self.W_e_norm = gvp.GVPLayerNorm((num_bessel, 1))
        self.W_e = gvp.GVP((num_bessel, 1), edge_dims, act_s=None, act_v=None,
                           vector_gate=True, generator=generator)
        self.layers = nn.ModuleList(
            GVPConvLayer(node_dims, edge_dims, residual=residual,
                         use_pallas=use_pallas,
                         remat=remat, generator=generator)
            for _ in range(num_layers))
        if equivariant_pred:
            self.pred = linear(s_dim + 3 * v_dim, out_dim, generator,
                               OutputLinear)
        else:
            self.dense_0 = linear(s_dim, s_dim, generator)
            self.dense_1 = linear(s_dim, out_dim, generator, OutputLinear)
        self.to(dev)

    def embed_edges(self, batch: GraphBatch):
        """The edge features ``(s [E, s_dim_edge], V [E, v_dim_edge, 3])``:
        ``W_e`` of the normed radial embedding and unit vector (0 on
        zero-length edges)."""
        vectors = batch.pos[batch.senders] - batch.pos[batch.receivers]
        lengths = safe_norm(vectors, dim=-1, keepdim=True)
        edge_s = radial_embedding(lengths, self.r_max, self.num_bessel,
                                  self.num_polynomial_cutoff)
        unit = torch.where(lengths > 1e-12,
                           vectors / torch.clamp_min(lengths, 1e-12),
                           torch.zeros_like(vectors))
        return self.W_e(self.W_e_norm((edge_s, unit[:, None, :])))

    def forward(self, batch: GraphBatch,
                seg_plans: Optional[Dict[str, SegmentPlan]] = None
                ) -> torch.Tensor:
        h_V = self.W_v(self.layer_norm_0(self.emb_in(batch.atoms)))
        h_E = self.embed_edges(batch)
        gen = self._dropout_rng(batch.pos.device) if self.training else None
        for layer in self.layers:
            h_V = layer(h_V, batch.senders, batch.receivers, h_E,
                        batch.edge_mask, seg_plans=seg_plans, generator=gen)
        out = POOL[self.pool](gvp.merge(*h_V), batch)
        if self.equivariant_pred:
            return self.pred(out)
        return self.dense_1(torch.relu(self.dense_0(out[:, :self.s_dim])))
