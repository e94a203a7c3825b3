"""Tensor parallelism over the channels (mul) of MACE and TFN (port of
``parallel/tp.py``).

Every feature tensor is split on its channel axis: rank p of k on the
``tp`` axis holds channels ``[p * mul / k, (p + 1) * mul / k)`` of every
irrep.  Channel-wise operations (edge features, the symmetric contraction,
the equivariant batch norm, gathers, sums, pools) run locally; the
channel-mixing products (the edge tensor product's weight contraction, the
product block's ``IrrepsLinear``, the readout's first Linear) are
row-parallel: local-mul input against full-mul weights, one
``differentiable.psum`` over the axis, then this rank's slice.  Per MACE
layer that is two ``[N, hidden]`` all-reduces, plus one ``[G, emb]`` at the
readout; the numbers are the single-rank model's up to the order of f32
sums.

    shards = shard_model_variables(full.state_dict(), full, k)
    local = tp_local_model(full, k, mesh)          # every rank
    local.load_state_dict(shards[mesh.coords["tp"]])
    step = tp_train_step(local, make_tx(local.parameters(), lr), mesh, loss)

Every rank holds its own parameter slice and computes the loss alike.  The
loss is divided by ``k`` inside the differentiated function and ``loss *
k`` returned, as in the JAX package: the readout's psum sums the ranks' k
equal cotangents in its backward.  The conv's psum must sum its cotangents
in the backward too (``differentiable.psum``), not pass them through as
Megatron's all-reduce does: after it each rank keeps its own channels, so
its cotangent is nonzero on those only, and only their sum is the
cotangent of the partial product.

A replicated parameter (the edge MLP's trunk, the readout after its
psum) gets only a part of its gradient on each rank: the trunk the part
through this rank's head columns, the readout 1/k (the loss / k).  The
steps sum those gradients over the axis, which gives each copy the whole
gradient.  The JAX package's steps do not (they sum over ``dp`` only), so
its replicated copies part after a step; its split parameters' gradients
are exact, and those are what its tests check.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..irreps import Irrep, Irreps
from ..nn.equivariant import irreps2gate, scale_mul, shard_mul_slice
from ..nn.tensor_product import EdgeTensorProduct
from .data import all_reduce_grads, average_batch_stats
from .mesh import Mesh, collectives, seed_from_key


def tp_local_model(model: torch.nn.Module, tp_size: int, mesh: Mesh,
                   axis: str = "tp") -> torch.nn.Module:
    """This rank's module for the full ``model`` (a ``MACEModel`` or
    ``TFNModel``): the same configuration at ``emb_dim / tp_size`` and
    ``hidden_irreps`` of ``mul / tp_size``, with ``tp_axis``, on the mesh's
    device.  Its weights are drawn anew (seed 0); load a shard of
    ``shard_model_variables`` into it."""
    cfg = dict(model.config)
    if cfg["emb_dim"] % tp_size:
        raise ValueError(f"emb_dim {cfg['emb_dim']} does not split into "
                         f"{tp_size} shards")
    hid = Irreps(model.hidden_irreps)
    if any(mul % tp_size for mul, _ in hid):
        raise ValueError(f"hidden irreps {hid} do not split into {tp_size} "
                         "shards")
    cfg.update(emb_dim=cfg["emb_dim"] // tp_size,
               hidden_irreps=str(Irreps([(mul // tp_size, ir)
                                         for mul, ir in hid])),
               tp_axis=axis, tp_size=tp_size)
    return type(model)(**cfg, device=mesh.device, mesh=mesh)


def _conv_tp_pair(model, layer: int, tp_size: int):
    """``(full_tp, local_tp, entry_map)`` of conv ``layer`` of a full
    model: the single-rank edge tensor product, the one a ``1/tp_size``
    mul shard builds (local-mul inputs to full-mul outputs), and
    ``entry_map[i_out_local] = (i_out_full, col_offset)``, where each local
    output entry lies in the full model's.  The map is more than the
    identity when the model gates: the full model's gate scalars are one
    merged ``0e`` entry, the shard's one entry per gated irrep, so a local
    gates entry reads a column range of the merged full entry."""
    sh_irreps = Irreps.spherical_harmonics(model.max_ell)
    hid_f = Irreps(model.hidden_irreps)
    if any(mul % tp_size for mul, _ in hid_f):
        raise ValueError(f"hidden irreps {hid_f} do not split into {tp_size}")
    hid_l = Irreps([(mul // tp_size, ir) for mul, ir in hid_f])
    use_gate = bool(model.config.get("gate", False))
    if use_gate:
        s_f, g_f, gd_f = irreps2gate(hid_f)
        use_gate = gd_f.num_irreps > 0
    if use_gate:
        tp_out_f = s_f + g_f + gd_f
        s_l, _, gd_l = irreps2gate(hid_l)
        g_l = Irreps([(mul, Irrep(0, 1)) for mul, _ in gd_l])
        tp_out_l = s_l + g_l + gd_l
        n_s, g_f_list = len(list(s_l)), list(g_f)
        entry_map = {j: (j, 0) for j in range(n_s)}
        cum = f_j = f_off = 0    # full-channel offset into the gates
        for j, (mul_l, _) in enumerate(g_l):
            w = mul_l * tp_size
            while cum >= f_off + g_f_list[f_j][0]:
                f_off += g_f_list[f_j][0]
                f_j += 1
            if cum + w > f_off + g_f_list[f_j][0]:
                raise ValueError("a local gates entry spans two full ones")
            entry_map[n_s + j] = (n_s + f_j, cum - f_off)
            cum += w
        for j in range(len(list(gd_l))):
            entry_map[n_s + len(list(g_l)) + j] = (n_s + len(g_f_list) + j, 0)
    else:
        tp_out_f, tp_out_l = hid_f, hid_l
        entry_map = {j: (j, 0) for j in range(len(list(hid_l)))}
    emb = model.config["emb_dim"]
    in_f = Irreps(f"{emb}x0e") if layer == 0 else hid_f
    in_l = Irreps(f"{emb // tp_size}x0e") if layer == 0 else hid_l
    full_tp = EdgeTensorProduct(in_f, sh_irreps, tp_out_f)
    local_tp = EdgeTensorProduct(in_l, sh_irreps, scale_mul(tp_out_l, tp_size))
    return full_tp, local_tp, entry_map


def _conv_head_cols(model, layer: int, tp_size: int, shard: int) -> list:
    """Per LOCAL ``fc_out`` head of conv ``layer``: ``(full_group, cols)``,
    the index array into the full model's ``fc_out[full_group]`` outputs
    (its weight's rows, flax's kernel columns) that shard ``shard`` holds.
    A path's weight block is ``[mul_in, mul_out]`` row-major and a shard
    owns the rows of its input channels.  From the two tensor-product
    descriptors only, so MACE and TFN share it."""
    full_tp, local_tp, entry_map = _conv_tp_pair(model, layer, tp_size)
    group_of_entry = {g[0]: gi for gi, g in enumerate(full_tp._groups)}
    path_base = {}      # (full group, i_in1, i_in2) -> (offset, w_full)
    for gi, (i_out, *_rest) in enumerate(full_tp._groups):
        off = 0
        for p in full_tp.paths:
            if p.i_out == i_out:
                path_base[(gi, p.i_in1, p.i_in2)] = (off, p.mul_out)
                off += p.mul_in1 * p.mul_out
    out = []
    for (i_out_l, _, _, _, _, _, w_l) in local_tp._groups:
        gf, col_off = entry_map[i_out_l]
        gi = group_of_entry[gf]
        cols = []
        for p in local_tp.paths:
            if p.i_out != i_out_l:
                continue
            base, w_f = path_base[(gi, p.i_in1, p.i_in2)]
            u = p.mul_in1
            rows = base + (shard * u + np.arange(u)) * w_f
            cols.append((rows[:, None] + (col_off + np.arange(w_l))[None, :])
                        .reshape(-1))
        out.append((gi, np.concatenate(cols)))
    return out


_FC_OUT = re.compile(r"convs\.(\d+)\.fc_out\.(\d+)\.(weight|bias)$")
REPLICATED, HEADS, PRED = "replicated", "heads", "pred"


def split_rule(key: str):
    """The sharder's rule for the tensor ``key``: the dim it is split on,
    ``REPLICATED``, ``HEADS`` (an ``fc_out`` head, split by
    ``_conv_head_cols``) or ``PRED`` (the equivariant readout, split by
    channel); ``ValueError`` for a key no rule covers."""
    if _FC_OUT.match(key):
        return HEADS
    if re.match(r"convs\.\d+\.fc\.", key):
        return REPLICATED
    if key == "emb_in.weight" or re.match(
            r"(convs\.\d+\.bn|prods\.\d+\.symmetric_contraction)\.", key):
        return -1                                # per channel
    if re.match(r"prods\.\d+\.linear\.", key):
        return 0                                 # the input channels' rows
    if key == "dense_0.weight":
        return 1                                 # torch's [out, in]: the input
    if key == "pred.weight":
        return PRED
    if key.startswith(("dense_", "pred.")):
        return REPLICATED
    raise ValueError(f"no tensor-parallel sharding rule for {key}")


def shard_model_variables(state_dict: Dict[str, torch.Tensor],
                          model: torch.nn.Module, tp_size: int
                          ) -> List[Dict[str, torch.Tensor]]:
    """The full ``model``'s ``state_dict`` (parameters and buffers) as
    ``tp_size`` local state dicts, shard p for the rank at ``tp`` coordinate
    p (the JAX package's rules, in torch's layout; ``split_rule``):

    - ``emb_in.weight``: split on its last axis;
    - the edge MLP trunk ``convs.i.fc``: replicated;
    - the batch norm ``convs.i.bn`` (weights and statistics) and the
      symmetric contraction's weights: split per channel, the last axis;
    - the product block's ``IrrepsLinear`` (``prods.i.linear``): split on
      its weight rows (input channels);
    - ``dense_0.weight``: split on its input, dim 1 of torch's ``[out,
      in]``; ``pred.weight`` (``equivariant_pred``): its input columns
      taken as the features are, this shard's channels of every irrep
      (``shard_mul_slice``; the JAX sharder cuts it into contiguous row
      blocks, which matches the local layout only for one irrep);
    - the rest of the readout: replicated;
    - ``convs.i.fc_out.g``: the rows ``_conv_head_cols`` names (TFN's gate
      heads regrouped);
    - any other key raises ``ValueError``.

    Works for ``MACEModel`` and ``TFNModel``, and for a dict of their
    gradients; every tensor is a contiguous copy on the input's device."""
    shards: List[Dict[str, torch.Tensor]] = [{} for _ in range(tp_size)]
    conv_layers = set()
    for key, x in state_dict.items():
        rule = split_rule(key)
        if rule == HEADS:
            conv_layers.add(int(_FC_OUT.match(key).group(1)))
            continue
        if rule == REPLICATED:
            parts = [x] * tp_size
        elif rule == PRED:
            hid = Irreps(model.hidden_irreps)
            parts = [shard_mul_slice(x, hid, tp_size, p)
                     for p in range(tp_size)]
        elif x.shape[rule] % tp_size:
            raise ValueError(f"{key}: dim {rule} of size {x.shape[rule]} "
                             f"does not split into {tp_size}")
        else:
            parts = torch.chunk(x, tp_size, dim=rule)
        for p in range(tp_size):
            shards[p][key] = parts[p].contiguous().clone()
    for i in sorted(conv_layers):
        for p in range(tp_size):
            for g_l, (gf, cols) in enumerate(_conv_head_cols(model, i, tp_size,
                                                             p)):
                for leaf in ("weight", "bias"):
                    src = state_dict[f"convs.{i}.fc_out.{gf}.{leaf}"]
                    idx = torch.as_tensor(cols, device=src.device)
                    shards[p][f"convs.{i}.fc_out.{g_l}.{leaf}"] = (
                        src.index_select(0, idx).contiguous())
    return shards


shard_mace_variables = shard_model_variables   # the JAX package's name


def tp_apply(model: torch.nn.Module, shard: Dict[str, torch.Tensor],
             mesh: Mesh, axis: str = "tp") -> Callable:
    """This rank's tensor-parallel forward of the full ``model``: its
    local module with ``shard`` (this rank's ``shard_model_variables``
    entry) loaded, in eval mode.  Returns ``apply(batch) -> [G, out_dim]``,
    the same on every rank of the axis.  Every rank of the axis calls it
    alike (each forward runs collectives)."""
    local = tp_local_model(model, mesh.shape[axis], mesh, axis)
    local.load_state_dict(shard)
    local.eval()

    def apply(batch) -> torch.Tensor:
        with torch.no_grad():
            return local(batch)

    return apply


def _reseed(model: torch.nn.Module, mesh: Mesh, key, axes) -> None:
    """Seed every dropout generator of ``model`` from ``key`` with this
    rank's index along ``axes`` folded in (none: every rank alike)."""
    from ..experiments.train import dropout_rngs, reseed_dropout

    if dropout_rngs(model):
        reseed_dropout(model, seed_from_key(
            collectives.fold_in_axes(mesh, key, *axes)))


def _step(model, opt, mesh, loss_fn, tp_axis: str,
          dp_axis: Optional[str]) -> Callable:
    k = mesh.shape[tp_axis]
    params = [p for p in model.parameters() if p.requires_grad]
    replicated = [p for n, p in model.named_parameters()
                  if p.requires_grad and split_rule(n) == REPLICATED]

    def step(batch, rng=None) -> torch.Tensor:
        # dropout: distinct over dp (the replicas see other graphs), alike
        # over tp (its ranks compute the same activations)
        _reseed(model, mesh, 0 if rng is None else rng,
                () if dp_axis is None else (dp_axis,))
        model.train()
        loss = loss_fn(model(batch), batch) / k
        opt.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads(mesh, replicated, tp_axis)
        if dp_axis is not None:
            all_reduce_grads(mesh, params, dp_axis)
            average_batch_stats(mesh, model, dp_axis)
        opt.step()
        loss = loss.detach()
        if dp_axis is not None:
            loss = collectives.all_reduce_sum(mesh, loss, dp_axis)
        return loss * k

    return step


def tp_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
                  mesh: Mesh, loss_fn: Callable, axis: str = "tp"
                  ) -> Callable:
    """A tensor-parallel train step: ``model`` is this rank's local module
    (``tp_local_model`` with its shard loaded), ``opt`` over its
    parameters.  Returns ``step(batch, rng=None) -> loss``: every rank of
    the axis takes the same whole ``batch`` and gets the exact gradients
    of its own parameter slice; the replicated parameters' gradients are
    summed over the axis (one flat all-reduce), so their copies stay
    equal.  Dropout is seeded from ``rng`` alike on every rank."""
    return _step(model, opt, mesh, loss_fn, axis, None)


def dp_tp_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
                     mesh: Mesh, loss_fn: Callable, dp_axis: str = "dp",
                     tp_axis: str = "tp") -> Callable:
    """A (dp, tp) train step: every dp row is a tensor-parallel replica of
    the model and ``batch`` is the row's graph shard (``shard_batches``).
    The gradients are summed over ``dp`` (each rank all-reduces its own
    parameter slice; the replicated ones over ``tp`` first, as in
    ``tp_train_step``), the batch statistics averaged over ``dp``, dropout
    folded over ``dp`` and never over ``tp``.  Returns ``step(batch,
    rng=None) -> loss``, the loss summed over ``dp``."""
    return _step(model, opt, mesh, loss_fn, tp_axis, dp_axis)
