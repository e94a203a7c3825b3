"""Data-parallel training over graph shards (port of ``parallel/data.py``).

A global batch is split into per-rank sub-batches padded to one bucket
(``shard_batches``).  Each rank computes the loss and its gradients on its
own shard; the gradients are then all-reduced as a SUM over the dp axis.
The experiment loss is an L1 sum over graphs, so N shards give exactly the
gradient of one device on the concatenated batch (up to the order of f32
sums).  ``DistributedDataParallel`` would average them instead (1/N too
small, which Adam's ``eps`` and any other optimizer then sees), so the
port reduces one flat bucket itself.  Batch statistics (``BatchNorm``'s
running averages) are averaged over the shards, as the JAX step's
``pmean`` of ``batch_stats`` does.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..graph import GraphBatch, batch_graphs
from ..nn.basic import BatchNorm
from .mesh import Mesh, collectives, seed_from_key


def shard_of(graphs: Sequence, num_shards: int, index: int, n_pad: int,
             e_pad: int, g_pad: int) -> GraphBatch:
    """Shard ``index`` of ``shard_batches``: graphs ``[index * per, (index
    + 1) * per)`` with ``per = ceil(len / num_shards)``, padded to the
    bucket (it may hold no graph at all)."""
    per = (len(graphs) + num_shards - 1) // num_shards
    return batch_graphs(graphs[index * per: (index + 1) * per], n_pad, e_pad,
                        g_pad)


def shard_batches(graphs: Sequence, num_shards: int, n_pad: int, e_pad: int,
                  g_pad: int) -> List[GraphBatch]:
    """Split ``graphs`` into ``num_shards`` groups padded alike, one
    ``GraphBatch`` (CPU tensors) per rank; rank r trains on element r."""
    return [shard_of(graphs, num_shards, s, n_pad, e_pad, g_pad)
            for s in range(num_shards)]


def batch_stats(model: torch.nn.Module) -> List[torch.Tensor]:
    """The buffers a train-mode forward updates: each ``BatchNorm``'s
    running mean and variance."""
    return [b for m in model.modules() if isinstance(m, BatchNorm)
            for b in (m.running_mean, m.running_var)]


def reseed_rank_dropout(model: torch.nn.Module, mesh: Mesh, key,
                        axis: str = "dp") -> None:
    """Seed every dropout generator of ``model`` from ``key`` and this
    rank's index on ``axis`` (``collectives.fold_in_axes``), so shards draw
    different masks and a repeat draws the same ones."""
    from ..experiments.train import dropout_rngs, reseed_dropout

    if dropout_rngs(model):
        reseed_dropout(model, seed_from_key(
            collectives.fold_in_axes(mesh, key, axis)))


def _flat_sum(mesh: Mesh, tensors: Sequence[torch.Tensor], axis: str,
              mean: bool = False) -> List[torch.Tensor]:
    """All-reduce ``tensors`` as one flat bucket per dtype (a sum, or the
    mean with ``mean``); returns the reduced tensors in their shapes."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        flat = (collectives.all_reduce_mean if mean
                else collectives.all_reduce_sum)(mesh, flat, axis)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def all_reduce_grads(mesh: Mesh, params: Sequence[torch.nn.Parameter],
                     axis: str = "dp") -> None:
    """Replace every gradient of ``params`` by its SUM over ``axis``, in
    one flat bucket.  A parameter with no gradient on any rank keeps none
    (``torch.optim`` then skips it, as in a single process); one that has a
    gradient on some rank gets the sum, zeros standing in for the others."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    present = torch.tensor([p.grad is not None for p in params],
                           dtype=grads[0].dtype, device=grads[0].device)
    *summed, present = _flat_sum(mesh, grads + [present], axis)
    for p, g, has in zip(params, summed, present.tolist()):
        p.grad = g if has else None


def average_batch_stats(mesh: Mesh, model: torch.nn.Module,
                        axis: str = "dp") -> None:
    """Set every batch statistic of ``model`` to its mean over ``axis``."""
    stats = batch_stats(model)
    if stats:
        with torch.no_grad():
            for b, avg in zip(stats, _flat_sum(mesh, stats, axis, mean=True)):
                b.copy_(avg)


def dp_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
                  mesh: Mesh, loss_fn: Callable, axis: str = "dp") -> Callable:
    """A data-parallel train step over ``mesh``'s ``axis``.

    Returns ``step(batch, rng=None) -> loss``: ``batch`` is this rank's
    shard (on the rank's device), ``rng`` a key (an int or a tuple of ints,
    default 0) that seeds dropout with this rank's index folded in.  The
    step runs the model in train mode, sums the gradients over the axis,
    averages the batch statistics, takes one ``opt`` step and returns the
    loss summed over the axis (a device scalar).  Every rank must start
    from the same weights and optimizer state; they then stay equal."""
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: GraphBatch, rng=None) -> torch.Tensor:
        reseed_rank_dropout(model, mesh, 0 if rng is None else rng, axis)
        model.train()
        loss = loss_fn(model(batch), batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads(mesh, params, axis)
        average_batch_stats(mesh, model, axis)
        opt.step()
        return collectives.all_reduce_sum(mesh, loss.detach(), axis)

    return step
