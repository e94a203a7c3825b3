"""The staged engine and the host C++ graph code on one CUDA card
(``chip_smoke.py`` phases 11c and 11d, also runnable alone):

    python -m geometric_message_passing_tpu_torch.experiments.staged_check

11c. ``train.fit`` over ``train._stage_epochs`` (the C++ batcher) trains the
     star bench's EGNN (``bench.bench_model``: 4 x 128, pool "first", 1400
     star graphs, batch 100, lr 5e-4, plateau schedule) for ``EPOCHS``
     epochs from seed-0 weights, the launch counters set to 0 just before
     and read just after: K1 4 a train step and eval batch, K2 4 and K4 1 (the
     embedding's gradient) a train step; its losses finite and falling.
     Against ``fit_resident`` (through ``fit_regression``) from the same
     weights, fed the staged epochs' permutations (``epoch_order``), in
     two parts.  The engine: ``fit`` over the same epochs assembled in slot
     layout (``assemble_batch``, the resident engine's batches, stacked)
     gives the resident run's per-epoch rows, step losses and final
     weights bitwise.  The batcher's layout: the first staged batch's
     gradients within ``GRAD_REL`` of each tensor's largest entry of the
     slot-assembled batch's (f32 sums over the edges in other tiles) and
     the first loss within 1e-5 relative.  The staged run's per-epoch MAEs
     are printed beside the resident run's and not held: Adam's first
     steps are near ``lr * sign(g)``, so a gradient entry within rounding
     of 0 takes an lr-sized step either way, and two runs whose sums part
     by rounding part by that much in a few epochs at full width.
11d. The C++ graph code against its numpy twins: the radius graph of the
     100k-atom box (cutoff 3, degree 14, seed 0: the phases' box) and the
     triplets and quads of the 10k-atom box, equal element for element,
     each side's host seconds printed.

``run()`` returns (readings, failures); ``main`` prints the readings as one
JSON line and exits 1 on a failure.  It needs a card and raises without
one.
"""

from __future__ import annotations

import copy
import json
import sys
import time

import numpy as np
import torch

from .. import datasets as ds
from ..graph import assemble_batch, build_slot_data, eval_slot_indices
from ..ops import edge, sorted_segsum
from ..ops.radius_graph import radius_graph, radius_graph_plain
from ..triplets import build_triplets, build_triplets_plain
from .bench import LR, bench_data, bench_model, card_line
from .train import (PlateauConfig, _map_batch, _stage_epochs, fit,
                    fit_regression, l1_sum_loss, seed_everything,
                    stack_batches)

EPOCHS = 3
FIRST_LOSS_RTOL = 1e-5
GRAD_REL = 1e-5          # the first batch's gradients, of each largest entry
BOX_CUTOFF, BOX_DEGREE = 3.0, 14.0


def _reset() -> None:
    edge.egnn_message.launches = edge.egnn_message.bwd_launches = 0
    sorted_segsum.segment_sum.launches = 0


def _counts() -> dict:
    return {"k1": edge.egnn_message.launches,
            "k2": edge.egnn_message.bwd_launches,
            "k4": sorted_segsum.segment_sum.launches}


def fired(vals) -> int:
    """Epochs whose validation MAE was at least as good as the best before
    (the best-val rule: the test set is evaluated there)."""
    best, n = np.inf, 0
    for v in vals:
        if np.float32(v) <= best:
            best, n = np.float32(v), n + 1
    return n


def staged_fit() -> tuple:
    """11c: readings and failures."""
    fails = []
    _, loaders = bench_data()
    train_loader, val_loader, test_loader = loaders
    rng_before = copy.deepcopy(train_loader.rng)
    t = time.perf_counter()
    staged = _stage_epochs(train_loader, EPOCHS)
    stage_s = time.perf_counter() - t
    orders = []
    for _ in range(EPOCHS):             # the permutations the batcher took
        order = np.arange(train_loader.num_examples)
        rng_before.shuffle(order)
        orders.append(torch.from_numpy(order))
    val_set, test_set = (stack_batches(list(ld))
                         for ld in (val_loader, test_loader))
    model = bench_model(seed_everything(0))
    dev = next(model.parameters()).device
    plateau = PlateauConfig(mode="max", factor=0.9, patience=15, min_lr=1e-4)
    # the resident run first: the staged one's time is then warm too
    ref = fit_regression(model, None, *loaders, n_epochs=EPOCHS, lr=LR,
                         seed=0, device=dev, epoch_order=lambda e: orders[e])
    _reset()
    res = fit(model, None, staged, val_set, test_set,
              val_loader.num_examples, test_loader.num_examples,
              n_epochs=EPOCHS, lr=LR, plateau=plateau, seed=0, device=dev)
    launched = _counts()
    steps = len(train_loader)
    evals = EPOCHS * len(val_loader) + fired(res.perf_per_epoch[:, 1]) * len(
        test_loader)
    want = {"k1": 4 * (EPOCHS * steps + evals), "k2": 4 * EPOCHS * steps,
            "k4": EPOCHS * steps}
    if launched != want:
        fails.append(f"11c fit launched {launched}, want {want}")
    losses = res.train_losses.mean(axis=1)
    if not (np.isfinite(res.perf_per_epoch).all() and losses[-1] < losses[0]):
        fails.append(f"11c the staged run's losses {losses.tolist()}, MAEs "
                     f"{res.perf_per_epoch.tolist()}")
    # the engine on the resident run's own batches: bitwise
    slots = [build_slot_data(ld.graphs, device=dev) for ld in loaders]
    b = train_loader.batch_size
    slot_epochs = stack_batches([stack_batches(
        [assemble_batch(slots[0], row) for row in order.to(dev).reshape(-1, b)])
        for order in orders])
    slot_val, slot_test = (stack_batches(
        [assemble_batch(slot, torch.from_numpy(row).to(dev))
         for row in eval_slot_indices(slot.num_graphs, b)])
        for slot in slots[1:])
    same = fit(model, None, slot_epochs, slot_val, slot_test,
               val_loader.num_examples, test_loader.num_examples,
               n_epochs=EPOCHS, lr=LR, plateau=plateau, seed=0, device=dev)
    bitwise = (np.array_equal(same.perf_per_epoch, ref.perf_per_epoch)
               and np.array_equal(same.train_losses, ref.train_losses)
               and all(torch.equal(v, ref.variables[k])
                       for k, v in same.variables.items()))
    if not bitwise:
        fails.append(f"11c fit over the slot-layout batches "
                     f"{same.perf_per_epoch.tolist()} is not bitwise "
                     f"fit_resident's {ref.perf_per_epoch.tolist()}")
    # the batcher's layout against the slot layout, at the first step
    first_batch = _map_batch(lambda x: x[0, 0].to(dev), staged)
    grad_rel = _grad_rel(_loss_grads(model, first_batch),
                         _loss_grads(model, assemble_batch(
                             slots[0], orders[0][:b].to(dev))))
    if grad_rel > GRAD_REL:
        fails.append(f"11c the first staged batch's gradients lie "
                     f"{grad_rel:.3e} from the slot-assembled batch's")
    first = abs(res.train_losses[0, 0] - ref.train_losses[0, 0]) / abs(
        ref.train_losses[0, 0])
    if first > FIRST_LOSS_RTOL:
        fails.append(f"11c first step's loss {res.train_losses[0, 0]} vs "
                     f"fit_resident's {ref.train_losses[0, 0]}")
    return {"epochs": EPOCHS, "steps_per_epoch": steps,
            "engine_bitwise": bitwise, "first_batch_grad_rel": grad_rel,
            "first_loss_rel": float(first),
            "stage_s": stage_s, "staged_shape": list(staged.atoms.shape),
            "perf_per_epoch": res.perf_per_epoch.tolist(),
            "epoch_loss": losses.tolist(),
            "resident_perf_per_epoch": ref.perf_per_epoch.tolist(),
            "max_metric_diff": float(np.abs(res.perf_per_epoch
                                            - ref.perf_per_epoch).max()),
            "train_time_s": res.train_time,
            "resident_train_time_s": ref.train_time,
            "launches": launched,
            "launches_per_train_step": {k: launched[k] / (EPOCHS * steps)
                                        for k in ("k2", "k4")}}, fails


def _loss_grads(model, batch) -> dict:
    """Each parameter's gradient of the L1-sum loss of a copy of ``model``
    on ``batch`` (train mode)."""
    work = copy.deepcopy(model).train()
    l1_sum_loss(work(batch), batch).backward()
    return {n: p.grad for n, p in work.named_parameters()
            if p.grad is not None}


def _grad_rel(got: dict, want: dict) -> float:
    """The largest gradient distance, of each tensor's largest entry."""
    return max(float((got[n] - w).abs().max() / w.abs().max().clamp_min(1e-30))
               for n, w in want.items())


def _timed(fn, *args, **kw):
    t = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t


def graph_code() -> tuple:
    """11d: readings and failures."""
    fails, out = [], {}
    box = ds.create_molecular_boxes(num=1, n_nodes=100_000, cutoff=BOX_CUTOFF,
                                    avg_degree=BOX_DEGREE, seed=0)[0]
    got, cpp_s = _timed(radius_graph, box.pos, BOX_CUTOFF)
    want, np_s = _timed(radius_graph_plain, box.pos, BOX_CUTOFF)
    out["radius_100k"] = {"edges": int(got.shape[1]), "cpp_s": cpp_s,
                          "numpy_s": np_s, "equal": bool(np.array_equal(
                              got, want) and got.dtype == want.dtype)}
    if not out["radius_100k"]["equal"]:
        fails.append("11d the C++ radius graph of the 100k box differs")
    box10 = ds.create_molecular_boxes(num=1, n_nodes=10_000, cutoff=BOX_CUTOFF,
                                      avg_degree=BOX_DEGREE, seed=0)[0]
    got, cpp_s = _timed(build_triplets, box10.edge_index, box10.num_nodes,
                        True)
    want, np_s = _timed(build_triplets_plain, box10.edge_index,
                        box10.num_nodes, True)
    equal = len(got) == len(want) and all(
        np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(got, want))
    out["triplets_quads_10k"] = {
        "edges": int(box10.num_edges), "triplets": int(got[0].shape[0]),
        "quads": int(got[5].shape[0]), "cpp_s": cpp_s, "numpy_s": np_s,
        "equal": bool(equal)}
    if not equal:
        fails.append("11d the C++ triplets / quads of the 10k box differ")
    return out, fails


def run() -> tuple:
    t = time.perf_counter()
    c, fc = staged_fit()
    d, fd = graph_code()
    return {"c": c, "d": d, "seconds": time.perf_counter() - t}, fc + fd


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("staged_check: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    read, fails = run()
    read["card"] = card_line()
    print(json.dumps(read))
    for f in fails:
        print(f"FAIL {f}", file=sys.stderr)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
