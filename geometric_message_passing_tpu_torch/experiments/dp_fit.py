"""The regression experiment with every step data-parallel over a mesh
(port of ``experiments/dp_fit.py``).

``fit_dp`` runs the JAX package's protocol line for line: a shuffle per
epoch from ``numpy.random.default_rng(SeedSequence([seed, epoch]))``,
global batches of ``batch_size`` graphs split into one shard per rank
(padded to ``pad_sizes(all graphs, batch_size / N)``), the plateau or
cosine schedule kept on the host, the best-val test rule, and
checkpoint/resume.  Train steps are ``parallel.data.dp_train_step`` (the
gradients summed over the ranks); validation and test sum each rank's
absolute errors with one all-reduce a batch.

Every rank runs ``fit_dp`` with the same arguments and returns the same
``FitResult``.  With the same seed, N ranks reproduce one rank: the batch
windows do not depend on N, only their split into shards does, and the
sum losses add up to the same totals up to the order of f32 sums.

Checkpoints go through ``utils/checkpoint.py``: rank 0 writes, all ranks
wait at a barrier, and a resumed run has every rank read the latest file.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..graph import GraphBatch, pad_sizes
from ..parallel.data import dp_train_step, shard_of
from ..parallel.mesh import Mesh, collectives
from ..utils.checkpoint import CheckpointManager
from .train import (FitResult, PlateauConfig, _working_copy, cosine_lr,
                    l1_sum_loss, make_tx)


def dp_eval_step(model: torch.nn.Module, mesh: Mesh, axis: str = "dp"):
    """Sharded evaluation: ``evaluate(batch) -> (err_sum, n_graphs)``, each
    rank's sum of |pred - y| over its shard's real graphs and its count of
    them, both summed over the axis (device scalars, f32)."""

    @torch.no_grad()
    def evaluate(batch: GraphBatch):
        pred = model(batch)
        err = ((pred - batch.y).abs() * batch.graph_mask[:, None]).sum()
        cnt = batch.graph_mask.sum().to(err.dtype)
        total = collectives.all_reduce_sum(mesh, torch.stack([err, cnt]), axis)
        return total[0], total[1]

    return evaluate


def _epoch_batches(graphs: Sequence, order, batch_size: int, n_dev: int,
                   index: int, n_pad: int, e_pad: int,
                   g_pad: int) -> List[GraphBatch]:
    """Shard ``index`` of each global batch of ``order``: the windows of
    ``batch_size`` graphs do not depend on ``n_dev``, only their split."""
    return [shard_of([graphs[i] for i in order[s:s + batch_size]], n_dev,
                     index, n_pad, e_pad, g_pad)
            for s in range(0, len(order), batch_size)]


def fit_dp(model: torch.nn.Module, variables, train_graphs, val_graphs,
           test_graphs, n_epochs: int, mesh: Mesh, axis: str = "dp",
           batch_size: int = 8, lr: float = 1e-4, cosine: bool = False,
           plateau: Optional[PlateauConfig] = None, seed: int = 0,
           checkpoint_dir: Optional[str] = None,
           checkpoint_every: int = 0) -> FitResult:
    """Regression experiment (MAE, best-val test rule) with every step
    sharded over ``mesh``'s ``axis``.  Trains a copy of ``model`` loaded
    with ``variables`` (a state dict; None keeps the model's own) on the
    mesh's device.  ``plateau`` None with ``cosine`` False keeps the
    rate."""
    n_dev = mesh.shape[axis]
    if batch_size % n_dev:
        raise ValueError(f"batch_size {batch_size} must be divisible by "
                         f"mesh size {n_dev}")
    per_shard = batch_size // n_dev
    index = mesh.coords[axis]
    dev = mesh.device
    all_graphs = list(train_graphs) + list(val_graphs) + list(test_graphs)
    pads = pad_sizes(all_graphs, per_shard)

    work = _working_copy(model, variables, dev)
    opt = make_tx(work.parameters(), lr)
    step_fn = dp_train_step(work, opt, mesh, l1_sum_loss, axis=axis)
    eval_fn = dp_eval_step(work, mesh, axis=axis)

    def on_device(batches):
        return [b.to(dev) for b in batches]

    val_batches = on_device(_epoch_batches(
        val_graphs, np.arange(len(val_graphs)), batch_size, n_dev, index,
        *pads))
    test_batches = on_device(_epoch_batches(
        test_graphs, np.arange(len(test_graphs)), batch_size, n_dev, index,
        *pads))

    def evaluate(batches) -> float:
        work.eval()
        sums = torch.stack([torch.stack(eval_fn(b)) for b in batches])
        tot = cnt = 0.0
        for e, c in sums.tolist():          # one host read, the JAX order
            tot += e
            cnt += c
        return tot / max(cnt, 1.0)

    # host-side scheduler and protocol state, as the JAX package keeps it
    lr_now, sched_best, sched_bad = float(lr), -float("inf"), 0
    best_val, test_metric = float("inf"), 0.0
    per_epoch: list = []
    losses: list = []           # each step's summed loss, read per epoch
    start_epoch = 0
    mgr = None
    if checkpoint_dir:
        mgr = CheckpointManager(checkpoint_dir, max_to_keep=2)
        if mgr.latest_step is not None:
            st = mgr.restore()        # on the CPU; loaded onto dev below
            work.load_state_dict(st["model"], strict=True)
            opt.load_state_dict(st["opt"])
            h = st["host"]
            lr_now, sched_best = float(h["lr_now"]), float(h["sched_best"])
            sched_bad = int(h["sched_bad"])
            best_val, test_metric = float(h["best_val"]), float(
                h["test_metric"])
            start_epoch = int(mgr.latest_step) + 1
            per_epoch = [tuple(r) for r in
                         st["per_epoch"][:start_epoch].tolist()]
            losses = st["losses"][:start_epoch].tolist()

    t0 = time.time()
    for epoch in range(start_epoch, n_epochs):
        if cosine:
            lr_now = float(cosine_lr(lr, 1e-6, n_epochs, epoch))
        for group in opt.param_groups:
            group["lr"] = float(np.float32(lr_now))
        order = np.random.default_rng(
            np.random.SeedSequence([seed, epoch])).permutation(
                len(train_graphs))
        step_losses = [step_fn(shard.to(dev), rng=(seed, epoch, k))
                       for k, shard in enumerate(_epoch_batches(
                           train_graphs, order, batch_size, n_dev, index,
                           *pads))]
        losses.append(torch.stack(step_losses).tolist())
        val_metric = evaluate(val_batches)
        if val_metric <= best_val:
            best_val = val_metric
            test_metric = evaluate(test_batches)
        if not cosine and plateau is not None:
            signed = val_metric if plateau.mode == "max" else -val_metric
            dynamic = (sched_best * (1 + plateau.threshold)
                       if sched_best >= 0
                       else sched_best * (1 - plateau.threshold))
            improved = signed > dynamic
            sched_bad = 0 if improved else sched_bad + 1
            if improved:
                sched_best = signed
            if sched_bad > plateau.patience:
                lr_now = max(lr_now * plateau.factor, plateau.min_lr)
                sched_bad = 0
        per_epoch.append((test_metric, val_metric))
        if mgr is not None and checkpoint_every and \
                (epoch + 1) % checkpoint_every == 0:
            if mesh.rank == 0:
                mgr.save(epoch, {
                    "model": work.state_dict(), "opt": opt.state_dict(),
                    "host": dict(lr_now=lr_now, sched_best=sched_best,
                                 sched_bad=sched_bad, best_val=best_val,
                                 test_metric=test_metric),
                    "per_epoch": torch.tensor(per_epoch,
                                              dtype=torch.float64),
                    "losses": torch.tensor(losses)})
            mesh.barrier()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return FitResult(
        best_val=best_val, test=test_metric, train_time=time.time() - t0,
        perf_per_epoch=np.asarray(per_epoch, np.float64).reshape(-1, 2),
        variables={k: v.detach().clone() for k, v in work.state_dict().items()},
        train_losses=(np.asarray(losses, np.float32) if losses
                      else np.zeros((0, 0), np.float32)))
