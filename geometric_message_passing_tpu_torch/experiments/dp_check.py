"""The data-parallel path at the bench configuration on one card: two
gloo ranks sharing it, held to one process.

    python -m geometric_message_passing_tpu_torch.experiments.dp_check

The bench's model and data (``bench.py``: ``EGNNFusedModel`` 4 x 128, pool
"first", 1400 star graphs on folds 5-7 split 50/20/30, global batch 100,
lr 5e-4, the plateau schedule; weights from seed 0).  Two gloo ranks on
``cuda:0`` (``parallel.launch.spawn``) run, in one launch:

  a. two ``dp_train_step`` steps on their halves of the first 100 training
     graphs; the summed gradient of the first step and the weights after
     the second against two plain steps on the concatenated batch in this
     process (``STEP_TOL`` of each tensor's largest entry / atol);
  b. the same with ``zero_dp_train_step``, each rank's Adam state
     ``ceil(P / 2)`` elements;
  c. ``fit_dp`` for ``FIT_EPOCHS`` epochs against the same run on one
     NCCL rank (a second launch): the sharded validation MAE of the
     initial weights and the first step's summed loss within ``STEP_TOL``
     (relative), launches by the protocol, and both runs' test MAE finite
     and below half the untrained model's.  The runs' per-epoch rows are
     printed, not held: at this width a rounding-sized difference in one
     step's gradient sum carries (ReLU and L1 sign flips become Adam steps
     of lr), and one f32 rounding step in one weight tensor of the one-rank
     run parts it from itself as far (``dp_drift.py``);
  d. ``run_experiment_reg(mesh=)`` (one repeat, ``REG_EPOCHS`` epochs)
     and its ledger record: test MAE finite and below the untrained
     model's;
  e. ``Predictor(mesh=)`` over ``SERVE_GRAPHS`` graphs (13 batches: a
     ragged last group) bitwise equal to one ``Predictor`` in this process.

Each rank counts its K1 / K2 / K4 launches per part (counters set to 0
just before, read just after) and times a dp step (``TIME_STEPS`` after
two warm ones); the one NCCL rank times its step too.  NCCL asked for two
ranks on the one GPU must raise before any process starts.  ``run``
returns the readings and the list of failed checks; the module's main
prints them as one JSON line and exits 1 on any failure.  It needs a card.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..graph import batch_graphs, pad_sizes
from ..models import EGNNFusedModel
from ..ops import sorted_segsum as sss
from ..ops.edge import egnn_message
from ..parallel import launch
from ..parallel.data import shard_batches
from ..parallel.mesh import make_mesh
from ..parallel.zero import flat_layout
from .bench import BATCH_SIZE, LR, N_LAYERS, WIDTH, bench_data, card_line
from .dp_fit import _epoch_batches, dp_eval_step, fit_dp
from .infer import Predictor
from .ledger import append_result
from .train import (PlateauConfig, l1_sum_loss, make_tx, run_experiment_reg,
                    seed_everything)

WORLD = 2
STEPS = 2                 # (a), (b)
TIME_STEPS = 10           # timed dp steps after two warm ones
FIT_EPOCHS = 5            # (c)
REG_EPOCHS = 10           # (d)
SERVE_GRAPHS = 1300       # (e): 13 batches of 100, a ragged last group
STEP_TOL = 1e-5
TIMEOUT_S = 600
MODEL_KW = dict(num_layers=N_LAYERS, emb_dim=WIDTH, in_dim=1, out_dim=1,
                pool="first")
PLATEAU = PlateauConfig(mode="max", factor=0.9, patience=15, min_lr=1e-4)


def counts() -> dict:
    return {"k1": egnn_message.launches, "k2": egnn_message.bwd_launches,
            "k4": sss.segment_sum.launches}


def reset_counts() -> None:
    egnn_message.launches = egnn_message.bwd_launches = 0
    sss.segment_sum.launches = 0


def bench_model(device) -> EGNNFusedModel:
    return EGNNFusedModel(**MODEL_KW, generator=seed_everything(0),
                          device=device)


def step_window(n: int):
    """The first global batch of training graphs and its shards' bucket."""
    data, loaders = bench_data()
    window = loaders[0].graphs[:BATCH_SIZE]
    return window, pad_sizes(data, BATCH_SIZE // n)


def _numpy(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True).numpy()
            for k, v in tensors.items()}


def _timed_steps(step, shard) -> float:
    """ms per step: ``TIME_STEPS`` steps after two warm ones."""
    for _ in range(2):
        step(shard)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(TIME_STEPS):
        step(shard)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / TIME_STEPS * 1e3


def _steps(mesh, make_step, shard) -> dict:
    """``STEPS`` steps of a fresh bench model; the first step's summed
    gradients, the end weights, the losses and the launches."""
    from ..parallel import dp_train_step, zero_dp_train_step, zero_init

    model = bench_model(mesh.device)
    if make_step == "dp":
        opt = make_tx(model.parameters(), LR)
        step = dp_train_step(model, opt, mesh, l1_sum_loss)
    else:
        opt = zero_init(lambda ps: make_tx(ps, LR), model.parameters(),
                        mesh=mesh)
        step = zero_dp_train_step(model, opt, mesh, l1_sum_loss)
    reset_counts()
    losses, grads = [], None
    for i in range(STEPS):
        losses.append(float(step(shard)))
        if i == 0 and make_step == "dp":
            grads = _numpy({n: p.grad for n, p in model.named_parameters()
                            if p.grad is not None})
    torch.cuda.synchronize()
    out = {"launches": counts(), "losses": losses,
           "state": _numpy(model.state_dict()), "grads": grads}
    if make_step == "dp":
        out["ms_per_step"] = _timed_steps(step, shard)
    else:
        (piece,) = opt.param_groups[0]["params"]
        out["adam_state_elems"] = {k: int(v.numel()) for k, v in
                                   opt.state[piece].items() if v.ndim}
    return out


def _initial_val_mae(mesh, data, va) -> float:
    """The sharded validation MAE of the initial weights (``fit_dp``'s
    evaluation: each rank's shard of each batch, one all-reduce a batch)."""
    n = mesh.shape["dp"]
    evaluate = dp_eval_step(bench_model(mesh.device).eval(), mesh)
    batches = _epoch_batches(va.graphs, np.arange(len(va.graphs)),
                             BATCH_SIZE, n, mesh.coords["dp"],
                             *pad_sizes(data, BATCH_SIZE // n))
    sums = np.asarray([torch.stack(evaluate(b.to(mesh.device))).tolist()
                       for b in batches])
    return float(sums[:, 0].sum() / sums[:, 1].sum())


def _fit(mesh) -> dict:
    data, (tr, va, te) = bench_data()
    val0 = _initial_val_mae(mesh, data, va)
    reset_counts()
    res = fit_dp(bench_model(mesh.device), None, tr.graphs, va.graphs,
                 te.graphs, n_epochs=FIT_EPOCHS, mesh=mesh,
                 batch_size=BATCH_SIZE, lr=LR, plateau=PLATEAU, seed=0)
    return {"perf": res.perf_per_epoch, "best_val": res.best_val,
            "test": res.test, "train_time": res.train_time,
            "losses": res.train_losses, "val0": val0, "launches": counts()}


def rank_main(tmp: str) -> dict:
    """Parts (a)-(e) on one of the gloo ranks."""
    mesh = make_mesh()
    n, me = mesh.shape["dp"], mesh.coords["dp"]
    window, pads = step_window(n)
    shard = shard_batches(window, n, *pads)[me].to(mesh.device)
    out = {"device": str(mesh.device), "backend": mesh.backend, "seconds": {}}
    for part, fn in (("a", lambda: _steps(mesh, "dp", shard)),
                     ("b", lambda: _steps(mesh, "zero", shard)),
                     ("c", lambda: _fit(mesh))):
        t = time.perf_counter()
        out[part] = fn()
        out["seconds"][part] = time.perf_counter() - t

    t = time.perf_counter()
    data, loaders = bench_data()
    reset_counts()
    bv, tm, times, mean, std = run_experiment_reg(
        EGNNFusedModel, MODEL_KW, *loaders, n_epochs=REG_EPOCHS, n_times=1,
        lr=LR, mesh=mesh)
    launches = counts()
    ledger = os.path.join(tmp, "exp_history.json")
    if mesh.rank == 0:
        append_result(ledger, dict(model="egnn_fused", mesh=f"dp{n}",
                                   test_mae=tm, mean=mean, std=std,
                                   n_epochs=REG_EPOCHS))
    mesh.barrier()
    with open(ledger) as f:
        record = json.load(f)[-1]
    out["d"] = {"test_mae": tm[0], "best_val": bv[0], "train_time": times[0],
                "record": record, "launches": launches}
    out["seconds"]["d"] = time.perf_counter() - t

    t = time.perf_counter()
    reset_counts()
    out["e"] = {"y": Predictor(bench_model(mesh.device), BATCH_SIZE,
                               mesh=mesh).predict(data[:SERVE_GRAPHS]),
                "launches": counts()}
    out["seconds"]["e"] = time.perf_counter() - t
    return out


def one_rank_main() -> dict:
    """The NCCL rank: (c)'s reference run and its dp step time."""
    mesh = make_mesh()
    window, pads = step_window(1)
    shard = shard_batches(window, 1, *pads)[0].to(mesh.device)
    return {"backend": mesh.backend, "c": _fit(mesh),
            "ms_per_step": _steps(mesh, "dp", shard)["ms_per_step"]}


def _plain_steps(device) -> dict:
    """Two plain Adam steps on the concatenated batch in this process."""
    window, pads = step_window(WORLD)
    big = batch_graphs(window, *(p * WORLD for p in pads)).to(device)
    model = bench_model(device).train()
    opt = make_tx(model.parameters(), LR)
    grads, losses = None, []
    for i in range(STEPS):
        loss = l1_sum_loss(model(big), big)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if i == 0:
            grads = _numpy({n: p.grad for n, p in model.named_parameters()
                            if p.grad is not None})
        opt.step()
        losses.append(float(loss.detach()))
    return {"grads": grads, "state": _numpy(model.state_dict()),
            "losses": losses, "params": sum(p.numel()
                                            for p in model.parameters())}


def _scaled_err(got: dict, want: dict) -> float:
    """Largest |got - want| of each tensor over max(|want|, 1)."""
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    return max(float(np.abs(got[k] - want[k]).max()
                     / max(np.abs(want[k]).max(), 1.0)) for k in want)


def _abs_err(got: dict, want: dict) -> float:
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


def run() -> tuple:
    """Every part on the card; returns (readings, failed checks)."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    fails, read = [], {}
    try:
        launch.spawn(one_rank_main, WORLD, backend="nccl")
        read["nccl_world2"] = "no error"
        fails.append("NCCL with two ranks on one GPU did not raise")
    except ValueError as exc:
        read["nccl_world2"] = f"ValueError: {exc}"
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        ranks = launch.spawn(rank_main, WORLD, backend="gloo", args=(tmp,),
                             timeout_s=TIMEOUT_S)
        read["gloo_launch_s"] = time.perf_counter() - t
    t = time.perf_counter()
    (one,) = launch.spawn(one_rank_main, 1, backend="nccl",
                          timeout_s=TIMEOUT_S)
    read["world1_launch_s"] = time.perf_counter() - t
    plain = _plain_steps(dev)
    data, (tr, va, te) = bench_data()
    single = Predictor(bench_model(dev), BATCH_SIZE, device=dev)
    y_single = single.predict(data[:SERVE_GRAPHS])
    test_pred = single.predict(te.graphs)
    untrained = float(np.mean(np.abs(
        test_pred - np.stack([g.y for g in te.graphs]).reshape(
            test_pred.shape))))

    size, chunk, _ = flat_layout([torch.empty(plain["params"])], WORLD)
    per_step = {"k1": N_LAYERS, "k2": N_LAYERS, "k4": 1}
    batches = -(-SERVE_GRAPHS // BATCH_SIZE)
    serve_per_rank = {"k1": N_LAYERS * -(-batches // WORLD), "k2": 0, "k4": 0}
    for r, out in enumerate(ranks):
        for part in ("a", "b"):
            want = {k: STEPS * v for k, v in per_step.items()}
            if out[part]["launches"] != want:
                fails.append(f"rank {r} ({part}) launched "
                             f"{out[part]['launches']}, expected {want}")
            if not np.allclose(out[part]["losses"], plain["losses"],
                               rtol=STEP_TOL, atol=0):
                fails.append(f"rank {r} ({part}) losses {out[part]['losses']}"
                             f", one process {plain['losses']}")
        if out["b"]["adam_state_elems"] != {"exp_avg": chunk,
                                            "exp_avg_sq": chunk}:
            fails.append(f"rank {r} ZeRO state {out['b']['adam_state_elems']}"
                         f", expected {chunk} elements (P {size})")
        if out["e"]["launches"] != serve_per_rank:
            fails.append(f"rank {r} (e) launched {out['e']['launches']}, "
                         f"expected {serve_per_rank}")
        if not np.array_equal(out["e"]["y"], y_single):
            fails.append(f"rank {r} (e): Predictor(mesh=) differs from one "
                         "Predictor")
    a, b, c, d = (ranks[0][p] for p in "abcd")
    read["a"] = {"grad_err": _scaled_err(a["grads"], plain["grads"]),
                 "param_err": _abs_err(a["state"], plain["state"]),
                 "losses": a["losses"], "plain_losses": plain["losses"],
                 "launches_per_rank": [o["a"]["launches"] for o in ranks],
                 "ms_per_step_world2": a["ms_per_step"],
                 "ms_per_step_world1": one["ms_per_step"]}
    read["b"] = {"param_err": _abs_err(b["state"], plain["state"]),
                 "adam_state_elems": b["adam_state_elems"],
                 "params": size, "chunk": chunk,
                 "launches_per_rank": [o["b"]["launches"] for o in ranks]}
    if read["a"]["grad_err"] > STEP_TOL:
        fails.append(f"(a) summed gradient {read['a']['grad_err']:.3e} from "
                     "the single process's")
    for part in ("a", "b"):
        if read[part]["param_err"] > STEP_TOL:
            fails.append(f"({part}) weights {read[part]['param_err']:.3e} "
                         "from two plain steps")
    best, fired = np.inf, 0           # epochs whose test pass ran
    for val in c["perf"][:, 1]:
        if val <= best:
            best, fired = val, fired + 1
    rel = (np.abs(c["losses"] - one["c"]["losses"])
           / np.abs(one["c"]["losses"])).ravel()
    read["c"] = {"perf_world2": c["perf"].tolist(),
                 "perf_world1_nccl": one["c"]["perf"].tolist(),
                 "max_diff": float(np.abs(c["perf"] - one["c"]["perf"]).max()),
                 "val0": [c["val0"], one["c"]["val0"]],
                 "first_loss_rel": float(rel[0]),
                 "steps_within_step_tol": int(np.argmax(
                     np.append(rel, np.inf) > STEP_TOL)),
                 "train_time_world2": c["train_time"],
                 "train_time_world1": one["c"]["train_time"],
                 "launches_per_rank": [o["c"]["launches"] for o in ranks],
                 "launches_world1": one["c"]["launches"]}
    if read["c"]["first_loss_rel"] > STEP_TOL:
        fails.append(f"(c) first step's loss {read['c']['first_loss_rel']:.3e}"
                     " from world 1's")
    if abs(c["val0"] - one["c"]["val0"]) > STEP_TOL * one["c"]["val0"]:
        fails.append(f"(c) initial validation MAE {read['c']['val0']}")
    for label, run_ in (("world 2", c), ("world 1", one["c"])):
        if not (np.isfinite(run_["perf"]).all()
                and run_["test"] < 0.5 * untrained):
            fails.append(f"(c) {label} test MAE {run_['test']} not below "
                         f"half the untrained model's {untrained}")
    steps, evals = (-(-len(ld.graphs) // BATCH_SIZE) for ld in (tr, va))
    tests = -(-len(te.graphs) // BATCH_SIZE)
    want_fit = {"k1": N_LAYERS * (FIT_EPOCHS * (steps + evals)
                                  + fired * tests),
                "k2": N_LAYERS * FIT_EPOCHS * steps, "k4": FIT_EPOCHS * steps}
    for r, out in enumerate(ranks):
        if out["c"]["launches"] != want_fit:
            fails.append(f"rank {r} (c) launched {out['c']['launches']}, "
                         f"expected {want_fit} ({fired} test passes)")
    read["c"]["fired"] = fired
    read["d"] = {k: d[k] for k in ("test_mae", "best_val", "train_time",
                                   "record", "launches")}
    read["d"]["untrained_test_mae"] = untrained
    if not (np.isfinite(d["test_mae"]) and d["test_mae"] < untrained):
        fails.append(f"(d) test MAE {d['test_mae']} not finite and below "
                     f"the untrained model's {untrained}")
    if d["record"].get("mesh") != f"dp{WORLD}":
        fails.append(f"(d) ledger record {d['record']}")
    read["e"] = {"graphs": SERVE_GRAPHS, "batches": batches,
                 "launches_per_rank": [o["e"]["launches"] for o in ranks],
                 "bitwise": all(np.array_equal(o["e"]["y"], y_single)
                                for o in ranks)}
    read["backends"] = {"world2": ranks[0]["backend"],
                        "world1": one["backend"],
                        "devices": [o["device"] for o in ranks]}
    read["rank_seconds"] = ranks[0]["seconds"]
    read["seconds"] = time.perf_counter() - t0
    return read, fails


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("dp_check needs a CUDA card")
    print(card_line(), flush=True)
    read, fails = run()
    print(json.dumps({"dp_check": read, "fails": fails}), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
