"""Test MAE of a star configuration's training run over several repeats
on one CUDA card: the spread an accuracy bound of ``chip_smoke.py`` is set
from when the run's depth is cut.

    python -m geometric_message_passing_tpu_torch.experiments.seed_spread \\
        --model dimenet --epochs 300 --repeats 3

``--model dimenet``: ``bench.DIMENET_STAR`` (fold 7, 4 layers, 1000 graphs,
lr 1e-4, plateau schedule; ``chip_smoke.py`` phase 6i); ``mace``:
``bench.MACE_STAR`` (fold 7, 1500 graphs, lr 5e-4, cosine; phase 6l);
``tfn``: ``bench.TFN_STAR`` on ``bench.tfn_data`` (fold 7, 1400 graphs, lr
5e-4, plateau; phase 6g, whose shuffle seed is 1); ``spherenet``:
``bench.SPHERENET_STAR`` (folds 5-7, 2 layers, 1500 graphs, lr 5e-4,
cosine; phase 6j).
Repeat ``i`` is ``run_experiment_reg``'s: weights and shuffle from seed
``i``, so repeat 0 is the configuration of the chip_smoke run.  Prints one line a repeat and one
JSON line with the test MAEs, their mean and standard deviation, and the
card's ``nvidia-smi`` name and power limit.  It needs a card and raises
without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from functools import partial

import torch

from ..models import DimeNetPPModel, MACEModel, SphereNetModel, TFNModel
from .bench import (DIMENET_STAR, LR, MACE_LR, MACE_STAR, SPHERENET_STAR,
                    TFN_STAR, mace_data, tfn_data, triplet_star_data)
from .train import run_experiment_reg


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
    return (partial(MACEModel, **MACE_STAR), dict(in_dim=1, out_dim=1),
            mace_data()[1], MACE_LR, True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("dimenet", "mace", "tfn",
                                            "spherenet"), required=True)
    ap.add_argument("--epochs", type=int, required=True)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("seed_spread: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    model_func, model_args, loaders, lr, cosine = configuration(args.model)
    best_val, test_mae, times, mean, std = run_experiment_reg(
        model_func, model_args, *loaders, n_epochs=args.epochs,
        n_times=args.repeats, verbose=True, cosine=cosine, lr=lr,
        device="cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"model": args.model, "epochs": args.epochs, "test_mae": test_mae,
           "best_val": best_val, "train_time_s": times, "mean": mean,
           "std": std, "device": card}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
