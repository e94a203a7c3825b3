"""Pipeline parallelism, the GPipe schedule, over a ``pp`` mesh axis (port
of ``parallel/pp.py``).

A stack of S layers of one shape runs as S stages, one a rank: rank d
holds stage d's parameters only.  M microbatches go through M + S - 1
ticks; at tick t rank d works on microbatch t - d (the bubble is (S - 1) /
(M + S - 1)), and after each tick every rank passes its output to the next
along the ring (``differentiable.ppermute``).  Per-microbatch graph data
(edge indices, masks) does not ride the ring: every rank holds all of it
and takes the slice of the microbatch it is working on.  The outputs come
out of the last stage through one masked all-reduce, so every rank returns
them all.

The schedule is differentiated by autograd.  Every rank must run the
backward of every collective in the same order, so every collective's
output reaches the result on every rank: stage 0 selects its fresh input
over the ring value with ``torch.where`` (both stay in the graph, as
JAX's ``jnp.where``), every rank keeps every tick's output in the stacked
result and masks it with ``torch.where``.  A rank that dropped the ring
value would skip that ppermute's backward while the others waited in
theirs.  Each rank's parameter gradients come out on that rank, and the
input's gradient on every rank.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .mesh import Mesh, differentiable


def stack_stage_params(per_stage: Sequence[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """Per-stage parameter dicts stacked on a new leading axis (the JAX
    package's layout, one slice a stage; rank d of a pipeline holds slice
    d only)."""
    return {k: torch.stack([p[k] for p in per_stage]) for k in per_stage[0]}


def _leaves(x) -> Tuple[List[torch.Tensor], Callable]:
    """A tensor or a dict of tensors as a list, and its rebuild."""
    if isinstance(x, dict):
        keys = sorted(x)
        return [x[k] for k in keys], lambda vs: dict(zip(keys, vs))
    return [x], lambda vs: vs[0]


def _ring(mesh: Mesh, leaves: List[torch.Tensor], perm, axis: str
          ) -> List[torch.Tensor]:
    """``differentiable.ppermute`` of every leaf, in one flat buffer."""
    flat = torch.cat([v.reshape(-1) for v in leaves])
    moved = differentiable.ppermute(mesh, flat, perm, axis)
    return [part.view_as(v) for part, v in
            zip(moved.split([v.numel() for v in leaves]), leaves)]


def pipeline_apply(stage_fn: Callable, params: Any, x_mb, aux_mb: Tuple = (),
                   *, mesh: Mesh, axis: str = "pp"):
    """``x -> stage_{S-1}(... stage_0(x))`` for M microbatches, GPipe-style.

    ``stage_fn(params, x, *aux) -> y``, with ``y`` of ``x``'s structure
    and shapes (a tensor or a dict of tensors); ``params`` is THIS rank's
    stage (rank ``coords[axis]``), anything ``stage_fn`` takes.  ``x_mb``:
    ``[M, ...]`` microbatch inputs, the same on every rank; ``aux_mb``: a
    tuple of ``[M, ...]`` per-microbatch extras, the slice of the
    microbatch at hand passed to ``stage_fn``.  Returns the ``[M, ...]``
    outputs on every rank.  Every rank of the axis calls it alike, and
    differentiates the same function of the result."""
    S, d = mesh.shape[axis], mesh.coords[axis]
    leaves, rebuild = _leaves(x_mb)
    M = leaves[0].shape[0]
    T = M + S - 1
    if torch.is_grad_enabled():
        leaves = [differentiable.replicated(mesh, v, axis) if v.requires_grad
                  else v for v in leaves]
    first = torch.tensor(d == 0, device=leaves[0].device)
    last = torch.tensor(d == S - 1, device=leaves[0].device)
    perm = [(i, (i + 1) % S) for i in range(S)]
    x_cur = [torch.zeros_like(v[0]) for v in leaves]
    outs: List[List[torch.Tensor]] = []
    for t in range(T):
        mb = min(max(t - d, 0), M - 1)
        x_in = [torch.where(first, v[min(t, M - 1)], c)
                for v, c in zip(leaves, x_cur)]
        y, _ = _leaves(stage_fn(params, rebuild(x_in),
                                *(a[mb] for a in aux_mb)))
        if t >= S - 1:        # the last stage finished microbatch t - S + 1
            outs.append(y)
        if t < T - 1:
            x_cur = _ring(mesh, y, perm, axis)
    stacked = [torch.stack(col) for col in zip(*outs)]
    return rebuild([
        differentiable.psum_replicated(
            mesh, torch.where(last, v, torch.zeros_like(v)), axis)
        for v in stacked])


def sequential_apply(stage_fn: Callable, stage_params: Sequence[Any], x_mb,
                     aux_mb: Tuple = ()):
    """The one-rank twin of ``pipeline_apply``: each microbatch through
    every stage in turn (``stage_params``: one entry a stage)."""
    leaves, rebuild = _leaves(x_mb)
    outs = []
    for m in range(leaves[0].shape[0]):
        x = rebuild([v[m] for v in leaves])
        for params in stage_params:
            x = stage_fn(params, x, *(a[m] for a in aux_mb))
        outs.append(_leaves(x)[0])
    return rebuild([torch.stack(col) for col in zip(*outs)])


def egnn_pipeline_stage(emb_dim: int, activation: str = "relu",
                        norm: str = "layer", aggr: str = "sum", *,
                        device, generator: Optional[torch.Generator] = None):
    """The EGNN hidden layer (``models.egnn.EGNNLayer``) as a pipeline
    stage.  Returns ``(layer, stage_fn)``: ``layer`` is the module whose
    parameter names the stages' dicts use (``dict(layer.named_parameters())``
    is one stage; ``weights.egnn_layer_from_jax`` carries a JAX stage over),
    ``stage_fn(params, x, senders, receivers, edge_mask)`` carries ``x =
    {"h": [N, D], "pos": [N, 3]}`` through one layer with ``params``
    (``torch.func.functional_call``): ``h`` with the residual, ``pos``
    replaced, as ``EGNNModel`` does.  For ``pipeline_apply`` and
    ``sequential_apply`` alike."""
    from ..models.egnn import EGNNLayer

    if generator is None:
        generator = torch.Generator().manual_seed(0)
    layer = EGNNLayer(emb_dim, activation, norm, aggr,
                      generator=generator).to(device)

    def stage_fn(params, x, senders, receivers, edge_mask):
        upd, pos = torch.func.functional_call(
            layer, params, (x["h"], x["pos"], senders, receivers, edge_mask))
        return {"h": x["h"] + upd, "pos": pos}

    return layer, stage_fn
