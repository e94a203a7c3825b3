"""Training over a device-resident dataset (port of the JAX package's
``experiments/train.py``: ``fit_regression`` and ``fit_classification`` ->
``fit_resident``, the single-device path, and the two repeat protocols),
and the JAX package's other two engines: ``fit`` over epochs staged up
front by the C++ batcher (``_stage_epochs``, ``stack_batches``) and
``fit_stepwise`` (``fit_regression(engine="stepwise")``), which in eager
PyTorch is the resident engine.

The JAX engine runs a whole experiment as one jit-compiled scan.  The port
runs the same protocol eagerly, epoch by epoch, with the data on the device
in slot layout (``graph.SlotData``):

  * each epoch shuffles the training graphs on the device
    (``torch.randperm`` from a device generator seeded by ``seed``), pads
    the last batch with the sentinel index M and assembles every batch on
    the device (``graph.assemble_batch``), with its triplets (and quads)
    when the loaders carry them (DimeNet++, SphereNet);
  * a train step is the task's loss (regression: the L1 sum; classification:
    the mean cross-entropy over real graphs), ``backward`` and an Adam step;
  * the learning rate is set from the plateau scheduler (or, with
    ``cosine``, from the cosine schedule) before the epoch's steps; after
    them the validation metric (MAE, or accuracy in percent) is read to the
    host (one read per epoch) and the test set is evaluated only when
    validation is at least as good as the best so far: the JAX package's
    best-val rule (``<=`` from +inf for regression, ``>=`` from -inf for
    classification).

Protocol quirks kept from the JAX package (and its reference): regression
losses are sums over the batch, metrics sum / num_examples, the plateau
scheduler runs in ``mode='max'`` on the validation metric, regression
re-instantiates the model every repeat and classification carries the
trained parameters from one repeat into the next.

The JAX engine's training options are keyword arguments here: ``loss_mask``
(``mask_cols``), ``grad_clip`` and ``lr_warmup`` (the JAX module globals
``GRAD_CLIP`` and ``LR_WARMUP``), checkpoint/resume and the NaN watchdog
(``checkpoint_dir``, ``checkpoint_every``, ``nan_recovery``,
``max_recoveries``, ``inject_fault``), with ``fit_stepwise``'s semantics:
the loop is epoch by epoch.  ``run_experiment_reg(mesh=)`` runs every
repeat data-parallel over a ``parallel.Mesh`` (``experiments/dp_fit.py``).
"""

from __future__ import annotations

import copy
import dataclasses
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import precision, resolve_device
from ..graph import (GraphBatch, GraphLoader, SlotData, assemble_batch,
                     build_slot_data, eval_slot_indices)
from ..utils.checkpoint import CheckpointManager


def seed_everything(seed: int = 0) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators; returns a CPU
    ``torch.Generator`` seeded with ``seed`` (the JAX package returns a
    PRNGKey), e.g. for a model's initial weights."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def l1_sum_loss(pred: torch.Tensor, batch: GraphBatch,
                mask_cols: Optional[int] = None) -> torch.Tensor:
    """sum |pred - y| over real graphs; ``mask_cols`` keeps the first k
    target columns."""
    y = batch.y
    if mask_cols is not None:
        pred, y = pred[:, :mask_cols], y[:, :mask_cols]
    return ((pred - y).abs() * batch.graph_mask[:, None]).sum()


def cross_entropy_mean_loss(pred: torch.Tensor,
                            batch: GraphBatch) -> torch.Tensor:
    """Mean cross-entropy of the logits ``pred`` against the integer labels
    ``batch.y`` over the real graphs (pad graphs weigh 0)."""
    labels = batch.y.reshape(-1).long()
    logp = torch.log_softmax(pred, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0] * batch.graph_mask
    return nll.sum() / torch.clamp_min(batch.graph_mask.sum(), 1)


def accuracy_count(pred: torch.Tensor, batch: GraphBatch) -> tuple:
    """``(correct, real)``: how many real graphs the logits ``pred``
    classify right (argmax, first of equal maxima) and how many real graphs
    the batch holds, as device integers."""
    labels = batch.y.reshape(-1).long()
    correct = (torch.argmax(pred, dim=-1) == labels) & batch.graph_mask
    return correct.sum(), batch.graph_mask.sum()


LOSSES = {"regression": l1_sum_loss,
          "classification": cross_entropy_mean_loss}


# ---------------------------------------------------------------------------
# ReduceLROnPlateau (torch semantics), in the JAX package's float32 arithmetic
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlateauConfig:
    mode: str = "max"            # torch's mode param
    factor: float = 0.9
    patience: int = 25
    threshold: float = 1e-4      # rel threshold (torch default)
    min_lr: float = 1e-5


def plateau_init(lr: float) -> Dict[str, np.generic]:
    return {"lr": np.float32(lr), "best": np.float32(-np.inf),
            "bad": np.int32(0)}


def plateau_update(state: Dict[str, np.generic], metric: float,
                   cfg: PlateauConfig) -> Dict[str, np.generic]:
    """One scheduler step on ``metric``.  Every operation is float32, as in
    the JAX package, so the two decay the rate on the same epochs."""
    f32 = np.float32
    metric = f32(metric)
    signed = metric if cfg.mode == "max" else -metric
    best = state["best"]
    dynamic = (best * f32(1 + cfg.threshold) if best >= 0
               else best * f32(1 - cfg.threshold))
    improved = bool(signed > dynamic)
    bad = np.int32(0) if improved else np.int32(state["bad"] + 1)
    decay = bool(bad > cfg.patience)
    lr = (max(state["lr"] * f32(cfg.factor), f32(cfg.min_lr)) if decay
          else state["lr"])
    return {"lr": f32(lr), "best": signed if improved else best,
            "bad": np.int32(0) if decay else bad}


def cosine_lr(lr0: float, eta_min: float, t_max: int, epoch: int) -> np.float32:
    """The cosine schedule's rate at ``epoch`` of ``t_max``, in the JAX
    package's float32 arithmetic."""
    f32 = np.float32
    return f32(eta_min) + f32(0.5) * (f32(lr0) - f32(eta_min)) * (
        f32(1) + np.cos(f32(np.pi) * f32(epoch) / f32(t_max)))


def warmup_scale(epoch: int, lr_warmup: Optional[int]) -> np.float32:
    """The linear warmup's factor at ``epoch``, ``min(1, (epoch + 1) /
    lr_warmup)``, in the JAX package's float32 arithmetic (1 when
    ``lr_warmup`` is None or 0)."""
    f32 = np.float32
    if not lr_warmup:
        return f32(1)
    return min(f32(1), f32(epoch + 1) / f32(lr_warmup))


def make_tx(params, lr: float = 1e-4) -> torch.optim.Optimizer:
    """The experiment optimizer: Adam with ``optax.adam``'s constants.  The
    JAX package's ``GRAD_CLIP`` chains ``optax.clip_by_global_norm`` in
    front of it; here ``train_step(grad_clip=)`` clips the gradients
    (``clip_grad_global_norm_``) before the step."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def clip_grad_global_norm_(params, max_norm: float) -> None:
    """``optax.clip_by_global_norm(max_norm)`` on the gradients of
    ``params``, in place: each gradient ``g`` is kept where the global norm
    is below ``max_norm`` and becomes ``g / norm * max_norm`` otherwise.
    The choice is made on the device (``torch.where`` on the divisor and
    the factor, 1 and 1 where kept): no host read, and a few multi-tensor
    launches for all the gradients together.  (``torch.nn.utils.
    clip_grad_norm_`` scales by ``max_norm / (norm + 1e-6)``: other
    arithmetic.)"""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))


@dataclass
class FitResult:
    best_val: float
    test: float
    train_time: float
    perf_per_epoch: np.ndarray      # [epochs, 2] = (test, val)
    variables: Dict[str, torch.Tensor]   # trained state dict
    train_losses: np.ndarray = field(  # [epochs, steps]: each step's loss
        default_factory=lambda: np.zeros((0, 0), np.float32))


def dropout_rngs(model: torch.nn.Module) -> list:
    """The dropout generators of ``model`` (GVP-GNN's ``_dropout_rng``), in
    module order."""
    return [m._dropout_rng for m in model.modules()
            if getattr(m, "_dropout_rng", None) is not None]


def reseed_dropout(model: torch.nn.Module, seed: int) -> None:
    """Reseed every dropout generator of ``model`` from ``seed``, as the JAX
    engine derives its dropout stream from the fit's seed: a seed other
    than the shuffle's, drawn from ``numpy.random.SeedSequence([seed, 1])``."""
    derived = int(np.random.SeedSequence([seed, 1]).generate_state(
        1, np.uint64)[0] >> np.uint64(2))
    for rng in dropout_rngs(model):
        rng.reseed(derived)


def train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
               slot: SlotData, idx_row: torch.Tensor,
               task: str = "regression", mask_cols: Optional[int] = None,
               grad_clip: Optional[float] = None) -> torch.Tensor:
    """One optimizer step on the batch of graphs ``idx_row`` under the
    ``task``'s loss (regression: over the first ``mask_cols`` target
    columns when given), the gradients clipped to the global norm
    ``grad_clip`` when given; returns the loss as a device scalar (no host
    read)."""
    return batch_step(model, opt, assemble_batch(slot, idx_row), task,
                      mask_cols, grad_clip)


def batch_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
               batch: GraphBatch, task: str = "regression",
               mask_cols: Optional[int] = None,
               grad_clip: Optional[float] = None) -> torch.Tensor:
    """``train_step`` on a batch already assembled."""
    pred = model(batch)
    loss = (LOSSES[task](pred, batch) if mask_cols is None
            else l1_sum_loss(pred, batch, mask_cols))
    opt.zero_grad(set_to_none=True)
    loss.backward()
    if grad_clip:
        clip_grad_global_norm_(
            [p for group in opt.param_groups for p in group["params"]],
            grad_clip)
    opt.step()
    return loss.detach()


@torch.no_grad()
def eval_metric(model: torch.nn.Module, slot: SlotData, plan: torch.Tensor,
                num_examples: int, task: str = "regression",
                mask_cols: Optional[int] = None) -> torch.Tensor:
    """Over the rows of ``plan``, as a device scalar (forward only): the
    summed L1 (over the first ``mask_cols`` target columns when given)
    divided by ``num_examples`` (regression), or the count of right answers
    divided by ``num_examples`` times 100 (classification), in float32."""
    return eval_batches(model, (assemble_batch(slot, row) for row in plan),
                        num_examples, task, mask_cols, plan.device)


@torch.no_grad()
def eval_batches(model: torch.nn.Module, batches, num_examples: int,
                 task: str = "regression", mask_cols: Optional[int] = None,
                 device=None) -> torch.Tensor:
    """``eval_metric`` over batches already assembled (on ``device``)."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    for batch in batches:
        pred = model(batch)
        if task == "regression":
            total = total + l1_sum_loss(pred, batch, mask_cols)
        else:
            total = total + accuracy_count(pred, batch)[0].to(torch.float32)
    if task == "regression":
        return total / num_examples
    return total / num_examples * 100.0


@dataclass
class _Progress:
    """What a fit has done besides the model's and the optimizer's state:
    the scheduler, the best-val rule's state and the per-epoch rows."""
    sched: Dict[str, np.generic]
    best_val: np.float32
    test_metric: torch.Tensor
    tests: List[torch.Tensor] = field(default_factory=list)
    vals: List[np.float32] = field(default_factory=list)
    losses: List[List[float]] = field(default_factory=list)

    @property
    def epoch(self) -> int:
        """Epochs done, the index of the next one."""
        return len(self.vals)


def restore_shuffle(gen: torch.Generator, state: torch.Tensor) -> None:
    """Set the shuffle generator back to the ``state`` a checkpoint saved,
    so the resumed epochs draw the permutations the uninterrupted run
    draws."""
    gen.set_state(state)


def _run_state(model, opt, gen, prog: _Progress, settings: dict) -> dict:
    """The whole state of a run between epochs, as a checkpoint holds it:
    numpy scalars as Python floats and ints (``torch.load(weights_only=
    True)`` rejects them; float32 survives the round trip exactly).  Saved
    after an epoch, so the per-epoch rows are never empty."""
    return {
        "model": model.state_dict(),
        "opt": opt.state_dict(),
        "shuffle": gen.get_state(),
        "dropout": [rng.state() for rng in dropout_rngs(model)],
        "sched": {"lr": float(prog.sched["lr"]),
                  "best": float(prog.sched["best"]),
                  "bad": int(prog.sched["bad"])},
        "best_val": float(prog.best_val),
        "test_metric": prog.test_metric,
        "tests": torch.stack(prog.tests),
        "vals": torch.tensor(prog.vals, dtype=torch.float32),
        "losses": torch.tensor(prog.losses, dtype=torch.float32),
        "settings": settings,
    }


def _load_run_state(st: dict, model, opt, gen, settings: dict,
                    dev: torch.device) -> _Progress:
    """Set the run back to the checkpoint ``st``; raises ``ValueError`` if it
    was written under other settings (the JAX package's optax state tree
    refuses such a restore too)."""
    if st["settings"] != settings:
        raise ValueError(f"the checkpoint was written with {st['settings']}, "
                         f"this run has {settings}: resume with the same "
                         "settings")
    model.load_state_dict(st["model"], strict=True)
    opt.load_state_dict(st["opt"])
    restore_shuffle(gen, st["shuffle"])
    rngs = dropout_rngs(model)
    if len(rngs) != len(st["dropout"]):
        raise ValueError(f"the checkpoint holds {len(st['dropout'])} dropout "
                         f"generators, the model {len(rngs)}")
    for rng, rng_state in zip(rngs, st["dropout"]):
        rng.set_state(rng_state)
    sched = st["sched"]
    return _Progress(
        sched={"lr": np.float32(sched["lr"]), "best": np.float32(sched["best"]),
               "bad": np.int32(sched["bad"])},
        best_val=np.float32(st["best_val"]),
        test_metric=st["test_metric"].to(dev),
        tests=list(st["tests"].to(dev).unbind(0)),
        vals=[np.float32(v) for v in st["vals"].tolist()],
        losses=st["losses"].tolist())


def fit_resident(model: torch.nn.Module, train_loader: GraphLoader,
                 val_loader: GraphLoader, test_loader: GraphLoader,
                 n_epochs: int, lr: float = 1e-4, task: str = "regression",
                 cosine: bool = False,
                 plateau: Optional[PlateauConfig] = None, seed: int = 0,
                 mask_cols: Optional[int] = None,
                 grad_clip: Optional[float] = None,
                 lr_warmup: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, nan_recovery: bool = False,
                 max_recoveries: int = 3,
                 inject_fault: Optional[Callable[[int, torch.nn.Module],
                                                 None]] = None,
                 device=None,
                 epoch_order: Optional[Callable[[int], torch.Tensor]] = None,
                 ) -> FitResult:
    """Train ``model`` in place for ``n_epochs`` over device-resident slot
    copies of the three loaders' graphs; ``task`` is ``"regression"`` or
    ``"classification"`` (integer labels: loaders with
    ``y_dtype=np.int32``).  The model's parameters must be on ``device``
    (default ``"cuda"``; raises without CUDA).

    Options (the JAX engine's; each off by default):

    * ``mask_cols``: regression's loss, validation and test metrics over
      the first ``mask_cols`` target columns only;
    * ``grad_clip``: global-norm gradient clipping (the JAX package's
      ``GRAD_CLIP``, ``optax.clip_by_global_norm``);
    * ``lr_warmup``: the rate of the scheduler (or of the cosine schedule)
      times ``min(1, (epoch + 1) / lr_warmup)`` (the JAX package's
      ``LR_WARMUP``); the plateau state keeps the rate without it;
    * ``checkpoint_dir`` / ``checkpoint_every``: every ``checkpoint_every``
      epochs the whole state of the run is saved to ``checkpoint_dir`` (the
      model's and Adam's state, the shuffle and dropout generators, the
      scheduler, the best-val rule, the per-epoch rows and the settings);
      a fit given a directory that holds a checkpoint resumes from the
      latest one, bitwise the uninterrupted run.  Restoring raises
      ``ValueError`` if the checkpoint's ``task``, ``grad_clip`` or
      ``lr_warmup`` differs from this fit's;
    * ``nan_recovery``: when an epoch's training losses (already read once
      an epoch) are not all finite, roll back to the latest checkpoint, up
      to ``max_recoveries`` times; ``FloatingPointError`` when there is no
      checkpoint or past that.  Needs ``checkpoint_dir`` and
      ``checkpoint_every`` (``ValueError`` otherwise);
    * ``inject_fault(epoch, model)`` runs at each epoch's start and may
      change the parameters in place (the fault-injection hook of the
      tests).

    ``epoch_order(epoch) -> LongTensor[m]`` replaces the epoch's shuffle of
    the m training graphs.  It is a test seam, not a feature: the tests feed
    the JAX package's permutations through it, which torch cannot draw.

    Matrix products outside the kernels (the update MLP, the readout) run
    at their sites' precision (``precision.py``): exact float32 unless the
    process default was lowered through ``precision.matmul_precision``.
    ``torch.backends.cuda.matmul.allow_tf32`` set by hand against that
    default raises ``ValueError`` (``precision.check_flags``)."""
    if task not in LOSSES:
        raise ValueError(f"task must be one of {sorted(LOSSES)}, got {task!r}")
    if mask_cols is not None and task != "regression":
        raise ValueError("mask_cols applies to regression only")
    if nan_recovery and not (checkpoint_dir and checkpoint_every):
        raise ValueError("nan_recovery requires checkpointing "
                         "(checkpoint_dir + checkpoint_every)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        precision.check_flags()
    plateau = plateau or PlateauConfig()
    slot_train, slot_val, slot_test = (
        build_slot_data(ld.graphs, y_dtype=ld.y_dtype,
                        with_triplets=ld.with_triplets,
                        with_quads=ld.with_quads, device=dev)
        for ld in (train_loader, val_loader, test_loader))
    b = train_loader.batch_size
    steps = len(train_loader)
    m = slot_train.num_graphs
    val_plan = torch.from_numpy(eval_slot_indices(slot_val.num_graphs, b)).to(dev)
    test_plan = torch.from_numpy(eval_slot_indices(slot_test.num_graphs, b)).to(dev)
    pad_row = torch.full((steps * b - m,), m, dtype=torch.long, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    reseed_dropout(model, seed)

    opt = make_tx(model.parameters(), lr)
    regression = task == "regression"
    prog = _Progress(sched=plateau_init(lr),
                     best_val=np.float32(np.inf if regression else -np.inf),
                     test_metric=torch.zeros((), dtype=torch.float32,
                                             device=dev))
    settings = {"task": task, "grad_clip": grad_clip or None,
                "lr_warmup": lr_warmup or None}
    mgr = (CheckpointManager(checkpoint_dir, max_to_keep=2)
           if checkpoint_dir else None)

    def rollback() -> _Progress:
        restored = _load_run_state(mgr.restore(), model, opt, gen, settings,
                                   dev)
        if restored.epoch > n_epochs:
            raise ValueError(f"the checkpoint in {checkpoint_dir} is at epoch "
                             f"{restored.epoch}, past n_epochs={n_epochs}")
        return restored

    if mgr is not None and mgr.latest_step is not None:
        prog = rollback()
    recoveries = 0
    t0 = time.time()
    while prog.epoch < n_epochs:
        epoch = prog.epoch
        if inject_fault is not None:
            inject_fault(epoch, model)
        set_epoch_lr(opt, prog, epoch, lr, n_epochs, cosine, lr_warmup)
        perm = (epoch_order(epoch) if epoch_order is not None
                else torch.randperm(m, generator=gen, device=dev))
        slots = torch.cat([perm.to(device=dev, dtype=torch.long),
                           pad_row]).reshape(steps, b)
        model.train()
        step_losses = [train_step(model, opt, slot_train, row, task,
                                  mask_cols, grad_clip) for row in slots]
        model.eval()
        val = eval_metric(model, slot_val, val_plan, val_loader.num_examples,
                          task, mask_cols)
        read = torch.cat([val[None], torch.stack(step_losses)]).tolist()
        if nan_recovery and not np.isfinite(read[1:]).all():
            recoveries += 1
            if mgr.latest_step is None or recoveries > max_recoveries:
                raise FloatingPointError(
                    f"non-finite training loss in epoch {epoch}; "
                    f"recoveries={recoveries - 1}, no rollback possible")
            prog = rollback()
            continue
        close_epoch(prog, read, regression, cosine, plateau, lambda: eval_metric(
            model, slot_test, test_plan, test_loader.num_examples, task,
            mask_cols))
        if mgr is not None and checkpoint_every and \
                prog.epoch % checkpoint_every == 0:
            mgr.save(prog.epoch, _run_state(model, opt, gen, prog, settings))
    return _fit_result(model, prog, time.time() - t0, n_epochs, steps)


def set_epoch_lr(opt: torch.optim.Optimizer, prog: _Progress, epoch: int,
                 lr: float, n_epochs: int, cosine: bool,
                 lr_warmup: Optional[int]) -> None:
    """The epoch's rate: the cosine schedule's or the plateau state's, times
    the warmup factor."""
    lr_now = (cosine_lr(lr, 1e-6, n_epochs, epoch) if cosine
              else prog.sched["lr"])
    if lr_warmup:
        lr_now = lr_now * warmup_scale(epoch, lr_warmup)
    for group in opt.param_groups:
        group["lr"] = float(lr_now)


def close_epoch(prog: _Progress, read: list, regression: bool, cosine: bool,
                plateau: PlateauConfig,
                test_metric: Callable[[], torch.Tensor]) -> None:
    """The protocol after an epoch's steps, from ``read`` (the validation
    metric, then the step losses, read to the host once): the best-val
    test rule (``test_metric()`` evaluated where validation is at least as
    good as the best), the plateau scheduler unless ``cosine``, the
    per-epoch rows."""
    val_f = np.float32(read[0])
    prog.losses.append(read[1:])
    best = prog.best_val
    if (val_f <= best) if regression else (val_f >= best):
        prog.test_metric = test_metric()
        prog.best_val = val_f
    if not cosine:
        prog.sched = plateau_update(prog.sched, val_f, plateau)
    prog.tests.append(prog.test_metric)
    prog.vals.append(val_f)


def _fit_result(model: torch.nn.Module, prog: _Progress, train_time: float,
                n_epochs: int, steps: int) -> FitResult:
    test_read = torch.stack(prog.tests).tolist() if prog.tests else []
    return FitResult(
        best_val=float(prog.best_val),
        test=float(np.float32(test_read[-1])) if test_read else 0.0,
        train_time=train_time,
        perf_per_epoch=np.asarray(list(zip(test_read, prog.vals)),
                                  np.float32).reshape(-1, 2),
        variables={k: v.detach().clone() for k, v in model.state_dict().items()},
        train_losses=np.asarray(prog.losses, np.float32).reshape(n_epochs,
                                                                 steps),
    )


def _map_batch(fn, value):
    """``value`` (a ``GraphBatch``, its ``TripletData`` or a tensor) with
    ``fn`` applied to every tensor."""
    if value is None:
        return None
    if dataclasses.is_dataclass(value):
        return type(value)(**{f.name: _map_batch(fn, getattr(value, f.name))
                              for f in dataclasses.fields(value)})
    return fn(value)


def stack_batches(batches: Sequence[GraphBatch]) -> GraphBatch:
    """The batches stacked along a new leading dimension, field by field
    (triplets too)."""
    first = batches[0]
    if first is None:
        return None
    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: stack_batches([getattr(b, f.name) for b in batches])
            for f in dataclasses.fields(first)})
    return torch.stack(list(batches))


def _stage_epochs(loader: GraphLoader, n_epochs: int) -> GraphBatch:
    """Every shuffled batch of ``n_epochs`` epochs stacked to ``[n_epochs,
    steps, ...]``: ``loader.stage_epochs`` (the C++ batcher), or with
    triplets (which it does not build) the loader's own batches stacked."""
    staged = loader.stage_epochs(n_epochs)
    if staged is not None:
        return staged
    steps = len(loader)
    return _map_batch(lambda x: x.reshape((n_epochs, steps) + x.shape[1:]),
                      stack_batches(loader.stacked_epochs(n_epochs)))


def fit(model: torch.nn.Module, variables, train_epochs: GraphBatch,
        val_set: GraphBatch, test_set: GraphBatch, num_val: int,
        num_test: int, n_epochs: int, lr: float = 1e-4,
        task: str = "regression", cosine: bool = False,
        plateau: Optional[PlateauConfig] = None,
        mask_cols: Optional[int] = None, seed: int = 0,
        metric_norm: str = "examples", device=None,
        grad_clip: Optional[float] = None,
        lr_warmup: Optional[int] = None) -> FitResult:
    """The whole run over batches staged up front (the JAX package's
    ``fit``): ``train_epochs`` ``[n_epochs, steps, ...]`` (``_stage_epochs``),
    ``val_set`` / ``test_set`` ``[batches, ...]`` (``stack_batches``), each
    copied to ``device`` once (default ``"cuda"``; raises without CUDA).
    JAX runs the protocol as one compiled program; here it is a host loop
    over the staged batches on the card, with ``fit_resident``'s protocol:
    the plateau scheduler (``plateau``) or the cosine schedule, the warmup
    (``lr_warmup``, the JAX package's ``LR_WARMUP``), global-norm clipping
    (``grad_clip``, ``GRAD_CLIP``), the best-val test rule, metrics summed
    over the batches and divided by ``num_val`` / ``num_test`` (the JAX
    signature's ``metric_norm``: only ``"examples"``).  Trains a copy of
    ``model`` loaded with ``variables`` (None: its own), as
    ``fit_regression`` does; the dropout generators are seeded from
    ``seed``."""
    if task not in LOSSES:
        raise ValueError(f"task must be one of {sorted(LOSSES)}, got {task!r}")
    if metric_norm != "examples":
        raise ValueError(f"metric_norm must be 'examples', got {metric_norm!r}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        precision.check_flags()
    work = _working_copy(model, variables, dev)
    reseed_dropout(work, seed)
    plateau = plateau or PlateauConfig()
    to_dev = lambda b: _map_batch(lambda x: x.to(dev), b)    # noqa: E731
    train, val, test = to_dev(train_epochs), to_dev(val_set), to_dev(test_set)
    steps = train.atoms.shape[1]

    def batches(staged: GraphBatch, *lead: int):
        return (_map_batch(lambda x: x[(*lead, i)], staged)
                for i in range(staged.atoms.shape[len(lead)]))

    opt = make_tx(work.parameters(), lr)
    regression = task == "regression"
    prog = _Progress(sched=plateau_init(lr),
                     best_val=np.float32(np.inf if regression else -np.inf),
                     test_metric=torch.zeros((), dtype=torch.float32,
                                             device=dev))
    t0 = time.time()
    for epoch in range(n_epochs):
        set_epoch_lr(opt, prog, epoch, lr, n_epochs, cosine, lr_warmup)
        work.train()
        step_losses = [batch_step(work, opt, b, task, mask_cols, grad_clip)
                       for b in batches(train, epoch)]
        work.eval()
        v = eval_batches(work, batches(val), num_val, task, mask_cols, dev)
        close_epoch(prog, torch.cat([v[None], torch.stack(step_losses)]
                                    ).tolist(), regression, cosine, plateau,
                    lambda: eval_batches(work, batches(test), num_test, task,
                                         mask_cols, dev))
    return _fit_result(work, prog, time.time() - t0, n_epochs, steps)


def _working_copy(model: torch.nn.Module, variables,
                  dev: torch.device) -> torch.nn.Module:
    """A copy of ``model`` on ``dev`` loaded with ``variables`` (a state
    dict, buffers included; None keeps the model's own)."""
    work = copy.deepcopy(model).to(dev)
    if variables is not None:
        work.load_state_dict(variables, strict=True)
    return work


# The JAX package's engine tables.  STEPWISE_MODELS: the models
# fit_regression sends to fit_stepwise (none).  RESIDENT_CHUNK: epochs per
# device call of the JAX resident engine by model; the port's resident
# engine is a host loop that reads once an epoch, so it takes no chunks.
STEPWISE_MODELS = ()
RESIDENT_CHUNK = {"MACEModel": 100, "TFNModel": 50,
                  "DimeNetPPModel": 200, "SphereNetModel": 100,
                  "GVPGNNModel": 100}


def fit_stepwise(model: torch.nn.Module, variables, train_loader,
                 val_loader, test_loader, n_epochs: int, lr: float = 1e-4,
                 task: str = "regression", cosine: bool = False,
                 plateau: Optional[PlateauConfig] = None,
                 mask_cols: Optional[int] = None, seed: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, nan_recovery: bool = False,
                 max_recoveries: int = 3, inject_fault=None, device=None,
                 epoch_order=None, grad_clip: Optional[float] = None,
                 lr_warmup: Optional[int] = None) -> FitResult:
    """The JAX package's host-looped engine, with its signature.  In JAX it
    is two small compiled programs (an epoch, an evaluation) under a host
    epoch loop, beside the resident engine's whole-run program.  In eager
    PyTorch both engines are the same host loop over the device-resident
    dataset, so this is ``fit_resident`` on a copy of ``model`` loaded with
    ``variables``, with the same options.  As in JAX, ``plateau`` None
    without ``cosine`` keeps the rate at ``lr``."""
    dev = resolve_device(device)
    if plateau is None and not cosine:
        plateau = PlateauConfig(patience=n_epochs)      # never decays
    return fit_resident(_working_copy(model, variables, dev), train_loader,
                        val_loader, test_loader, n_epochs=n_epochs, lr=lr,
                        task=task, cosine=cosine, plateau=plateau, seed=seed,
                        mask_cols=mask_cols, grad_clip=grad_clip,
                        lr_warmup=lr_warmup, checkpoint_dir=checkpoint_dir,
                        checkpoint_every=checkpoint_every,
                        nan_recovery=nan_recovery,
                        max_recoveries=max_recoveries,
                        inject_fault=inject_fault, device=dev,
                        epoch_order=epoch_order)


def fit_regression(model: torch.nn.Module, variables, train_loader,
                   val_loader, test_loader, n_epochs: int = 100,
                   lr: float = 1e-4, cosine: bool = False,
                   loss_mask: bool = False, seed: int = 0,
                   checkpoint_dir=None, checkpoint_every: int = 0,
                   nan_recovery: bool = False, engine: Optional[str] = None,
                   device=None, epoch_order=None,
                   grad_clip: Optional[float] = None,
                   lr_warmup: Optional[int] = None, max_recoveries: int = 3,
                   inject_fault=None) -> FitResult:
    """Regression protocol: Adam at ``lr``, plateau scheduler in mode 'max'
    (factor 0.9, patience 15, min_lr 1e-4) or, with ``cosine``, the cosine
    schedule from ``lr`` down to 1e-6 over ``n_epochs``; best-val test rule.
    ``loss_mask`` scores only the first half of the target columns (their
    count read from the validation loader's targets), as the JAX package
    does for the two-centre stars; the other options are ``fit_resident``'s.
    ``engine``: None or ``"resident"`` (``fit_resident``), ``"stepwise"``
    (``fit_stepwise``, also for a model named in ``STEPWISE_MODELS``): in
    the port the two are one loop, so the result is the same.

    Trains a copy of ``model`` loaded with ``variables`` (a state dict; None
    takes the model's own) and leaves ``model`` untouched, so repeated calls
    from the same inputs start from the same weights, as the JAX package's
    pure functions do.  ``device=None`` means ``"cuda"``."""
    if engine not in (None, "resident", "stepwise"):
        raise ValueError(f"engine must be 'resident' or 'stepwise', got "
                         f"{engine!r}")
    mask_cols = None
    if loss_mask:
        mask_cols = next(iter(val_loader)).y.shape[-1] // 2
    dev = resolve_device(device)
    plateau = PlateauConfig(mode="max", factor=0.9, patience=15, min_lr=1e-4)
    kw = dict(n_epochs=n_epochs, lr=lr, cosine=cosine, plateau=plateau,
              seed=seed, mask_cols=mask_cols, grad_clip=grad_clip,
              lr_warmup=lr_warmup, checkpoint_dir=checkpoint_dir,
              checkpoint_every=checkpoint_every, nan_recovery=nan_recovery,
              max_recoveries=max_recoveries, inject_fault=inject_fault,
              device=dev, epoch_order=epoch_order)
    if engine == "stepwise" or type(model).__name__ in STEPWISE_MODELS:
        return fit_stepwise(model, variables, train_loader, val_loader,
                            test_loader, **kw)
    return fit_resident(_working_copy(model, variables, dev), train_loader,
                        val_loader, test_loader, **kw)


def fit_classification(model: torch.nn.Module, variables, train_loader,
                       val_loader, test_loader, n_epochs: int = 100,
                       lr: float = 1e-4, seed: int = 0, device=None,
                       epoch_order=None) -> FitResult:
    """Classification protocol: Adam at ``lr``, plateau scheduler in mode
    'max' on the validation accuracy (factor 0.9, patience 25, min_lr
    1e-5), no cosine; mean cross-entropy loss, accuracy in percent,
    best-val test rule ``>=``.  Like ``fit_regression`` it trains a copy
    of ``model`` loaded with ``variables`` and leaves ``model`` untouched.
    The loaders carry integer labels (``y_dtype=np.int32``)."""
    dev = resolve_device(device)
    work = _working_copy(model, variables, dev)
    plateau = PlateauConfig(mode="max", factor=0.9, patience=25, min_lr=1e-5)
    return fit_resident(work, train_loader, val_loader, test_loader,
                        n_epochs=n_epochs, lr=lr, task="classification",
                        cosine=False, plateau=plateau, seed=seed, device=dev,
                        epoch_order=epoch_order)


def run_experiment(model: torch.nn.Module, train_loader, val_loader,
                   test_loader, n_epochs: int = 100, n_times: int = 10,
                   verbose: bool = False, lr: float = 1e-4, device=None):
    """Classification repeat protocol: the same parameters go on training
    across repeats (the reference's quirk).  Repeat ``idx`` calls
    ``seed_everything(idx)`` and fits with
    ``seed=idx`` and a fresh Adam, starting from the previous repeat's
    trained state (parameters and batch-norm statistics).  The first
    repeat starts from ``model``'s own weights: a port model draws them
    when it is built (build it with ``generator=seed_everything(0)`` for
    the JAX protocol's initialisation).  Returns (best_vals, test_accs,
    times)."""
    dev = resolve_device(device)
    variables = None
    best_val, test_acc, times = [], [], []
    for idx in range(n_times):
        seed_everything(idx)
        res = fit_classification(model, variables, train_loader, val_loader,
                                 test_loader, n_epochs=n_epochs, lr=lr,
                                 seed=idx, device=dev)
        variables = res.variables
        best_val.append(res.best_val)
        test_acc.append(res.test)
        times.append(res.train_time)
        if verbose:
            print(f"run {idx}: best val {res.best_val:.3f} "
                  f"test {res.test:.3f} ({res.train_time:.2f}s)")
    return best_val, test_acc, times


def run_experiment_reg(model_func, model_args, train_loader, val_loader,
                       test_loader, n_epochs: int = 100, n_times: int = 100,
                       verbose: bool = False, cosine: bool = False,
                       lr: float = 1e-4, loss_mask: bool = False,
                       checkpoint_dir=None, checkpoint_every: int = 0,
                       nan_recovery: bool = False, mesh=None, device=None,
                       grad_clip: Optional[float] = None,
                       lr_warmup: Optional[int] = None):
    """Regression repeat protocol: repeat ``idx`` builds a new model,
    ``model_func(**model_args, generator=seed_everything(idx), device=...)``,
    and trains it with ``seed=idx``; with ``checkpoint_dir`` its checkpoints
    go to ``{checkpoint_dir}/run{idx}``, so a second call with the same
    directory resumes every repeat.  ``grad_clip`` and ``lr_warmup`` stand
    for the JAX package's ``GRAD_CLIP`` and ``LR_WARMUP``.  Returns
    (best_vals, test_maes, times, mean test MAE, std test MAE).

    ``mesh``: run every train and eval step data-parallel over a
    ``parallel.Mesh`` (``dp_fit.fit_dp``, called by every rank alike; the
    model is built on the mesh's device, the batch is the train loader's,
    split over the ranks).  Cosine, the plateau schedule and checkpoints
    hold there; ``loss_mask``, ``nan_recovery``, ``grad_clip`` and
    ``lr_warmup`` raise ``ValueError`` (the single-device engine's
    options), a ``mesh`` that is not a ``parallel.Mesh`` ``TypeError``."""
    if mesh is not None:
        from ..parallel.mesh import Mesh

        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh, got "
                            f"{type(mesh).__name__}")
        if loss_mask or nan_recovery:
            raise ValueError("loss_mask/nan_recovery are not supported "
                             "under mesh execution (single-device "
                             "engine features)")
        if grad_clip or lr_warmup:
            raise ValueError("grad_clip/lr_warmup are not supported under "
                             "mesh execution (single-device engine "
                             "features)")
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
    dev = mesh.device if mesh is not None else resolve_device(device)
    best_val, test_mae, times = [], [], []
    for idx in range(n_times):
        model = model_func(**model_args, generator=seed_everything(idx),
                           device=dev)
        run_dir = f"{checkpoint_dir}/run{idx}" if checkpoint_dir else None
        if mesh is not None:
            from .dp_fit import fit_dp

            res = fit_dp(
                model, None, train_loader.graphs, val_loader.graphs,
                test_loader.graphs, n_epochs=n_epochs, mesh=mesh,
                batch_size=train_loader.batch_size, lr=lr, cosine=cosine,
                plateau=None if cosine else PlateauConfig(
                    mode="max", factor=0.9, patience=15, min_lr=1e-4),
                seed=idx, checkpoint_dir=run_dir,
                checkpoint_every=checkpoint_every)
        else:
            res = fit_regression(
                model, None, train_loader, val_loader, test_loader,
                n_epochs=n_epochs, lr=lr, cosine=cosine, loss_mask=loss_mask,
                seed=idx, checkpoint_dir=run_dir,
                checkpoint_every=checkpoint_every, nan_recovery=nan_recovery,
                device=dev, grad_clip=grad_clip, lr_warmup=lr_warmup)
        best_val.append(res.best_val)
        test_mae.append(res.test)
        times.append(res.train_time)
        if verbose:
            print(f"run {idx}: best val MAE {res.best_val:.5f} "
                  f"test MAE {res.test:.5f} ({res.train_time:.2f}s)")
    return (best_val, test_mae, times,
            float(np.mean(test_mae)), float(np.std(test_mae)))
