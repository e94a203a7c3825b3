"""Test MAE of a star configuration's training run over several repeats
on one CUDA card: the spread an accuracy bound of ``chip_smoke.py`` is set
from when the run's depth is cut.

    python -m geometric_message_passing_tpu_torch.experiments.seed_spread \\
        --model dimenet --epochs 200 --repeats 3

``--model dimenet``: ``bench.DIMENET_STAR`` (fold 7, 4 layers, 1000 graphs,
lr 1e-4, plateau schedule; ``chip_smoke.py`` phase 6i); ``mace``:
``bench.MACE_STAR`` (fold 7, 1500 graphs, lr 5e-4, cosine; phase 6l);
``tfn``: ``bench.TFN_STAR`` on ``bench.tfn_data`` (fold 7, 1400 graphs, lr
5e-4, plateau; phase 6g, whose shuffle seed is 1); ``spherenet``:
``bench.SPHERENET_STAR`` (folds 5-7, 2 layers, 1500 graphs, lr 5e-4,
cosine; phase 6j); ``mace_paired``: the CLI's MACE ``paired_star`` run
(``MACE_PAIRED``: 2 layers, pool mean, fold 7, 1500 graphs, 2 pairs, lr
5e-4, cosine; phase 7d).  Repeat ``i`` is ``run_experiment_reg``'s:
weights and shuffle from seed ``i``, so repeat 0 is the configuration of
the chip_smoke run.

``--model final_mpnn`` / ``invariant_mpnn``: the 101 notebook's
``train_model`` (``examples.gnn101``: 4 x 64, 400 molecules, lr 5e-3,
batch 32; ``--epochs 40`` is the notebook's; phase 8b); repeat ``i`` builds
the model from ``seed_everything(i)`` and shuffles with seed ``i``.  These
two also run on the CPU (``--device cpu``).

Prints one line a repeat and one JSON line with the test MAEs, their mean
and standard deviation, and the card's ``nvidia-smi`` name and power limit.
The star and CLI configurations need a card and raise without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from functools import partial

import numpy as np
import torch

from ..models import DimeNetPPModel, MACEModel, SphereNetModel, TFNModel
from .bench import (DIMENET_STAR, LR, MACE_LR, MACE_STAR, SPHERENET_STAR,
                    TFN_STAR, mace_data, tfn_data, triplet_star_data)
from .train import run_experiment_reg

# the CLI flags of the JAX package's MACE paired_star number
# (scripts/validate_accuracy.py:17-25, RESULTS.md:193), less the depth
MACE_PAIRED = ["--model", "mace", "--dataset", "paired_star", "--pool",
               "mean", "--n_layers", "2", "--cosine", "--max_ell", "3",
               "--n_pairs", "2", "--fold", "7", "--n_data", "1500", "--lr",
               "5e-4"]
NOTEBOOK = {"final_mpnn": "FinalMPNN", "invariant_mpnn": "InvariantMPNN"}


def configuration(name: str):
    """(model_func, model_args, loaders, lr, cosine) of ``name``."""
    if name in ("dimenet", "spherenet"):
        cls, cfg = ((DimeNetPPModel, DIMENET_STAR) if name == "dimenet"
                    else (SphereNetModel, SPHERENET_STAR))
        return (cls, dict(num_layers=cfg["num_layers"], in_dim=1, out_dim=1),
                triplet_star_data(**cfg)[1], cfg["lr"], cfg["cosine"])
    if name == "tfn":
        return (partial(TFNModel, **TFN_STAR), dict(in_dim=1, out_dim=1),
                tfn_data()[1], LR, False)
    if name == "mace_paired":
        from . import cli

        args = cli.build_parser().parse_args(MACE_PAIRED)
        data, model_args = cli.make_dataset(args)
        return (cli.make_model_func(args), model_args,
                cli.make_loaders(args, data), args.lr, args.cosine)
    return (partial(MACEModel, **MACE_STAR), dict(in_dim=1, out_dim=1),
            mace_data()[1], MACE_LR, True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def notebook_spread(name: str, epochs: int, repeats: int, device) -> tuple:
    """Test MAEs and seconds of ``repeats`` runs of the 101 notebook's
    ``train_model`` for ``NOTEBOOK[name]``."""
    from ..examples import gnn101

    splits = gnn101.notebook_splits()
    maes, times = [], []
    for i in range(repeats):
        t = time.perf_counter()
        model = gnn101.build(NOTEBOOK[name], seed=i, device=device)
        res = gnn101.train_model(model, f"{NOTEBOOK[name]} {i}",
                                 n_epochs=epochs, splits=splits, seed=i)
        maes.append(res["test_mae"])
        times.append(time.perf_counter() - t)
    return maes, times


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("dimenet", "mace", "tfn", "spherenet",
                                        "mace_paired", *NOTEBOOK),
                    required=True)
    ap.add_argument("--epochs", type=int, required=True)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cpu: final_mpnn / invariant_mpnn only")
    args = ap.parse_args(argv)
    if args.device != "cuda" and args.model not in NOTEBOOK:
        raise SystemExit(f"seed_spread: --model {args.model} runs on the card")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("seed_spread: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.model in NOTEBOOK:
        test_mae, times = notebook_spread(args.model, args.epochs,
                                          args.repeats, args.device)
        best_val = None
        mean, std = float(np.mean(test_mae)), float(np.std(test_mae))
    else:
        model_func, model_args, loaders, lr, cosine = configuration(args.model)
        best_val, test_mae, times, mean, std = run_experiment_reg(
            model_func, model_args, *loaders, n_epochs=args.epochs,
            n_times=args.repeats, verbose=True, cosine=cosine, lr=lr,
            device="cuda")
    card = card_line() if args.device == "cuda" else "cpu"
    out = {"model": args.model, "epochs": args.epochs, "test_mae": test_mae,
           "best_val": best_val, "train_time_s": times, "mean": mean,
           "std": std, "device": card}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
