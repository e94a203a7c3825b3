"""ZeRO-1 data parallelism: the optimizer state sharded over the dp axis
(port of ``parallel/zero.py``).

Plain data parallelism (``data.dp_train_step``) keeps Adam's two moments,
twice the parameters' bytes, on every rank.  Here the parameters are
raveled into one flat vector, padded to ``N * chunk`` with ``chunk =
ceil(P / N)`` (the JAX layout), and each rank keeps the optimizer over its
own slice of ``chunk`` elements only:

  1. each rank computes gradients on its shard of the batch;
  2. one reduce-scatter sums them and leaves each rank its slice;
  3. the optimizer (any whose update is elementwise: Adam, AdamW, SGD with
     momentum) steps that slice;
  4. one all-gather of the updated slices rebuilds every parameter.

Reduce-scatter plus all-gather move the bytes of one all-reduce, and the
arithmetic is plain data parallelism's: slicing commutes with an
elementwise update.  A model with parameters of more than one dtype
raises ``TypeError`` (raveling would promote them).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from .data import average_batch_stats, reseed_rank_dropout
from .mesh import Mesh, collectives


def flat_layout(params: Sequence[torch.Tensor],
                n_shards: int) -> Tuple[int, int, torch.dtype]:
    """``(size, chunk, dtype)`` of the raveled parameters split into
    ``n_shards`` slices of ``chunk = ceil(size / n_shards)``."""
    dtypes = {p.dtype for p in params}
    if len(dtypes) > 1:
        raise TypeError(
            "ZeRO-1 requires a uniform parameter dtype: raveling would "
            "silently promote a mixed set and the optimizer would run in "
            f"the promoted dtype; got {sorted(str(d) for d in dtypes)}")
    size = sum(p.numel() for p in params)
    return size, -(-size // n_shards), dtypes.pop()


def _flat(tensors: Sequence[torch.Tensor], padded: int) -> torch.Tensor:
    flat = torch.cat([t.reshape(-1) for t in tensors])
    return torch.nn.functional.pad(flat, (0, padded - flat.numel()))


def zero_init(tx: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
              params, n_shards: Optional[int] = None,
              mesh: Optional[Mesh] = None, axis: str = "dp"
              ) -> Union[torch.optim.Optimizer, List[torch.optim.Optimizer]]:
    """The sharded optimizer: ``tx`` (a function from a list of tensors to
    an optimizer, e.g. ``lambda ps: make_tx(ps, lr)``) over one slice of
    ``chunk`` elements of the raveled ``params``.  With ``mesh``, this
    rank's slice (index ``coords[axis]``; ``n_shards`` is the axis size);
    without, a list of all ``n_shards`` slices' optimizers."""
    params = [p for p in params if p.requires_grad]
    n = mesh.shape[axis] if mesh is not None else n_shards
    if n is None or (n_shards is not None and n_shards != n):
        raise ValueError(f"n_shards {n_shards} for a mesh axis of {n}")
    size, chunk, _ = flat_layout(params, n)
    flat = _flat([p.detach() for p in params], n * chunk)

    def one(i: int) -> torch.optim.Optimizer:
        piece = flat[i * chunk:(i + 1) * chunk].clone()
        return tx([torch.nn.Parameter(piece)])

    if mesh is None:
        return [one(i) for i in range(n)]
    return one(mesh.coords[axis])


def zero_dp_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
                       mesh: Mesh, loss_fn: Callable,
                       axis: str = "dp") -> Callable:
    """A ZeRO-1 train step.  ``opt`` comes from ``zero_init(tx,
    model.parameters(), mesh=mesh)``.  Returns ``step(batch, rng=None) ->
    loss`` with ``dp_train_step``'s arguments and result: the loss summed
    over the axis, batch statistics averaged, every rank's parameters
    replaced by the gathered update."""
    params = [p for p in model.parameters() if p.requires_grad]
    n = mesh.shape[axis]
    size, chunk, _ = flat_layout(params, n)
    (shard,) = opt.param_groups[0]["params"]
    if shard.shape != (chunk,):
        raise ValueError(f"the optimizer holds {tuple(shard.shape)} elements, "
                         f"this model's slice is ({chunk},)")
    lo = mesh.coords[axis] * chunk
    sizes = [p.numel() for p in params]

    def step(batch, rng=None) -> torch.Tensor:
        reseed_rank_dropout(model, mesh, 0 if rng is None else rng, axis)
        model.train()
        loss = loss_fn(model(batch), batch)
        for p in params:
            p.grad = None
        loss.backward()
        gflat = _flat([p.grad if p.grad is not None else torch.zeros_like(p)
                       for p in params], n * chunk)
        for p in params:
            p.grad = None
        gslice = collectives.reduce_scatter_sum(mesh, gflat, axis)
        with torch.no_grad():
            shard.copy_(_flat([p.detach() for p in params],
                              n * chunk)[lo:lo + chunk])
        shard.grad = gslice
        opt.step()
        full = collectives.all_gather(mesh, shard.detach(), axis,
                                      tiled=True)[:size]
        with torch.no_grad():
            for p, part in zip(params, full.split(sizes)):
                p.copy_(part.view_as(p))
        average_batch_stats(mesh, model, axis)
        return collectives.all_reduce_sum(mesh, loss.detach(), axis)

    return step
