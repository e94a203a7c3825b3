"""Training over a device-resident dataset (port of the JAX package's
``experiments/train.py``: ``fit_regression`` and ``fit_classification`` ->
``fit_resident``, the single-device path, and the two repeat protocols).

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
trained parameters from one repeat into the next.  The JAX engine's
checkpointing, NaN recovery, ``mesh=`` and ``loss_mask`` are not ported yet
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..graph import (GraphBatch, GraphLoader, SlotData, assemble_batch,
                     build_slot_data, eval_slot_indices)


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


def make_tx(params, lr: float = 1e-4) -> torch.optim.Optimizer:
    """The experiment optimizer: Adam with ``optax.adam``'s constants."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


@dataclass
class FitResult:
    best_val: float
    test: float
    train_time: float
    perf_per_epoch: np.ndarray      # [epochs, 2] = (test, val)
    variables: Dict[str, torch.Tensor]   # trained state dict
    train_losses: np.ndarray = field(  # [epochs, steps]: each step's loss
        default_factory=lambda: np.zeros((0, 0), np.float32))


def reseed_dropout(model: torch.nn.Module, seed: int) -> None:
    """Reseed every dropout generator of ``model`` (GVP-GNN's
    ``_dropout_rng``) from ``seed``, as the JAX engine derives its dropout
    stream from the fit's seed: a seed other than the shuffle's, drawn from
    ``numpy.random.SeedSequence([seed, 1])``."""
    derived = int(np.random.SeedSequence([seed, 1]).generate_state(
        1, np.uint64)[0] >> np.uint64(2))
    for module in model.modules():
        rng = getattr(module, "_dropout_rng", None)
        if rng is not None:
            rng.reseed(derived)


def train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
               slot: SlotData, idx_row: torch.Tensor,
               task: str = "regression") -> torch.Tensor:
    """One optimizer step on the batch of graphs ``idx_row`` under the
    ``task``'s loss; returns the loss as a device scalar (no host read)."""
    batch = assemble_batch(slot, idx_row)
    loss = LOSSES[task](model(batch), batch)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def eval_metric(model: torch.nn.Module, slot: SlotData, plan: torch.Tensor,
                num_examples: int, task: str = "regression") -> torch.Tensor:
    """Over the rows of ``plan``, as a device scalar (forward only): the
    summed L1 divided by ``num_examples`` (regression), or the count of
    right answers divided by ``num_examples`` times 100 (classification),
    in float32."""
    total = torch.zeros((), dtype=torch.float32, device=plan.device)
    for idx_row in plan:
        batch = assemble_batch(slot, idx_row)
        pred = model(batch)
        if task == "regression":
            total = total + l1_sum_loss(pred, batch)
        else:
            total = total + accuracy_count(pred, batch)[0].to(torch.float32)
    if task == "regression":
        return total / num_examples
    return total / num_examples * 100.0


def fit_resident(model: torch.nn.Module, train_loader: GraphLoader,
                 val_loader: GraphLoader, test_loader: GraphLoader,
                 n_epochs: int, lr: float = 1e-4, task: str = "regression",
                 cosine: bool = False,
                 plateau: Optional[PlateauConfig] = None, seed: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, nan_recovery: bool = False,
                 device=None,
                 epoch_order: Optional[Callable[[int], torch.Tensor]] = None,
                 ) -> FitResult:
    """Train ``model`` in place for ``n_epochs`` over device-resident slot
    copies of the three loaders' graphs; ``task`` is ``"regression"`` or
    ``"classification"`` (integer labels: loaders with
    ``y_dtype=np.int32``).  The model's parameters must be on ``device``
    (default ``"cuda"``; raises without CUDA).

    ``epoch_order(epoch) -> LongTensor[m]`` replaces the epoch's shuffle of
    the m training graphs.  It is a test seam, not a feature: the tests feed
    the JAX package's permutations through it, which torch cannot draw.

    Matrix products outside the kernels (the update MLP, the readout) run
    in full float32: ``torch.backends.cuda.matmul.allow_tf32`` must stay
    False, its default; this raises otherwise."""
    if task not in LOSSES:
        raise ValueError(f"task must be one of {sorted(LOSSES)}, got {task!r}")
    if checkpoint_dir or checkpoint_every or nan_recovery:
        raise NotImplementedError(
            "checkpointing and NaN recovery are not ported yet")
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("fit_resident runs in float32: set "
                         "torch.backends.cuda.matmul.allow_tf32 = False")
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
    sched = plateau_init(lr)
    regression = task == "regression"
    best_val = np.float32(np.inf if regression else -np.inf)
    test_metric = torch.zeros((), dtype=torch.float32, device=dev)
    tests: List[torch.Tensor] = []
    vals: List[np.float32] = []
    losses: List[List[float]] = []
    t0 = time.time()
    for epoch in range(n_epochs):
        lr_now = (cosine_lr(lr, 1e-6, n_epochs, epoch) if cosine
                  else sched["lr"])
        for group in opt.param_groups:
            group["lr"] = float(lr_now)
        perm = (epoch_order(epoch) if epoch_order is not None
                else torch.randperm(m, generator=gen, device=dev))
        slots = torch.cat([perm.to(device=dev, dtype=torch.long),
                           pad_row]).reshape(steps, b)
        model.train()
        step_losses = [train_step(model, opt, slot_train, row, task)
                       for row in slots]
        model.eval()
        val = eval_metric(model, slot_val, val_plan, val_loader.num_examples,
                          task)
        read = torch.cat([val[None], torch.stack(step_losses)]).tolist()
        val_f = np.float32(read[0])     # the epoch's one host read
        losses.append(read[1:])
        if (val_f <= best_val) if regression else (val_f >= best_val):
            test_metric = eval_metric(model, slot_test, test_plan,
                                      test_loader.num_examples, task)
            best_val = val_f
        if not cosine:
            sched = plateau_update(sched, val_f, plateau)
        tests.append(test_metric)
        vals.append(val_f)
    test_read = torch.stack(tests).tolist() if tests else []
    train_time = time.time() - t0
    return FitResult(
        best_val=float(best_val),
        test=float(np.float32(test_read[-1])) if test_read else 0.0,
        train_time=train_time,
        perf_per_epoch=np.asarray(list(zip(test_read, vals)),
                                  np.float32).reshape(-1, 2),
        variables={k: v.detach().clone() for k, v in model.state_dict().items()},
        train_losses=np.asarray(losses, np.float32).reshape(n_epochs, steps),
    )


def _working_copy(model: torch.nn.Module, variables,
                  dev: torch.device) -> torch.nn.Module:
    """A copy of ``model`` on ``dev`` loaded with ``variables`` (a state
    dict, buffers included; None keeps the model's own)."""
    work = copy.deepcopy(model).to(dev)
    if variables is not None:
        work.load_state_dict(variables, strict=True)
    return work


def fit_regression(model: torch.nn.Module, variables, train_loader,
                   val_loader, test_loader, n_epochs: int = 100,
                   lr: float = 1e-4, cosine: bool = False,
                   loss_mask: bool = False, seed: int = 0,
                   checkpoint_dir=None, checkpoint_every: int = 0,
                   nan_recovery: bool = False, device=None,
                   epoch_order=None) -> FitResult:
    """Regression protocol: Adam at ``lr``, plateau scheduler in mode 'max'
    (factor 0.9, patience 15, min_lr 1e-4) or, with ``cosine``, the cosine
    schedule from ``lr`` down to 1e-6 over ``n_epochs``; best-val test rule.

    Trains a copy of ``model`` loaded with ``variables`` (a state dict; None
    takes the model's own) and leaves ``model`` untouched, so repeated calls
    from the same inputs start from the same weights, as the JAX package's
    pure functions do.  ``device=None`` means ``"cuda"``."""
    if loss_mask:
        raise NotImplementedError("loss_mask is not ported yet")
    dev = resolve_device(device)
    work = _working_copy(model, variables, dev)
    plateau = PlateauConfig(mode="max", factor=0.9, patience=15, min_lr=1e-4)
    return fit_resident(work, train_loader, val_loader, test_loader,
                        n_epochs=n_epochs, lr=lr, cosine=cosine,
                        plateau=plateau, seed=seed,
                        checkpoint_dir=checkpoint_dir,
                        checkpoint_every=checkpoint_every,
                        nan_recovery=nan_recovery, device=dev,
                        epoch_order=epoch_order)


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
                       nan_recovery: bool = False, mesh=None, device=None):
    """Regression repeat protocol: repeat ``idx`` builds a new model,
    ``model_func(**model_args, generator=seed_everything(idx), device=...)``,
    and trains it with ``seed=idx``.  Returns (best_vals, test_maes, times,
    mean test MAE, std test MAE)."""
    if mesh is not None:
        raise NotImplementedError("run_experiment_reg(mesh=) is not ported yet")
    dev = resolve_device(device)
    best_val, test_mae, times = [], [], []
    for idx in range(n_times):
        model = model_func(**model_args, generator=seed_everything(idx),
                           device=dev)
        res = fit_regression(
            model, None, train_loader, val_loader, test_loader,
            n_epochs=n_epochs, lr=lr, cosine=cosine, loss_mask=loss_mask,
            seed=idx, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, nan_recovery=nan_recovery,
            device=dev)
        best_val.append(res.best_val)
        test_mae.append(res.test)
        times.append(res.train_time)
        if verbose:
            print(f"run {idx}: best val MAE {res.best_val:.5f} "
                  f"test MAE {res.test:.5f} ({res.train_time:.2f}s)")
    return (best_val, test_mae, times,
            float(np.mean(test_mae)), float(np.std(test_mae)))
