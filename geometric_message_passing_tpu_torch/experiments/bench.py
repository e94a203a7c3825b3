"""Benchmark of the port: EGNN star-graph angle regression training, the
headline configuration of the repository's root ``bench.py``, on one CUDA
card.

    python -m geometric_message_passing_tpu_torch.experiments.bench [--seed S]

EGNN (fused message kernels), 4 layers x 128 wide, pool "first", on 1400
star graphs (fold 5/6/7, target max angle, seed 0), split 50/20/30, batch
100, 200 epochs, lr 5e-4, through ``fit_regression`` over device-resident
slot data.  One warm run (kernel build, cuBLAS start-up), then ``--samples``
measured runs (default 5); the value is the median ``train_time``.  The
initial weights come from ``--init-seed`` (default 0), the shuffle from
``--seed`` (default 1), as in the root bench.

As in the root bench, ``GMP_BENCH_MODEL=egnn`` trains the plain ``EGNNModel``
(same numerics, plain tensor ops) in place of the default ``egnn_fused``
(``EGNNFusedModel``, the per-layer message kernels).

Prints one JSON line with the root bench's keys.  ``baseline_s`` is the
reference implementation's own 26 s per run (its BASELINE.md), not a time
of this card; ``device`` is the card's ``nvidia-smi`` name and power limit.
It needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from .. import datasets as ds
from ..graph import GraphLoader, pad_sizes, random_split
from ..triplets import triplet_pad_sizes
from ..models import EGNNFusedModel, EGNNModel, MACEModel, TFNModel
from .train import fit_regression, seed_everything

BASELINE_TRAIN_TIME_S = 26.0   # the reference implementation's train_time
N_DATA, BATCH_SIZE, N_LAYERS, WIDTH, LR, N_EPOCHS = 1400, 100, 4, 128, 5e-4, 200


def bench_data():
    """The bench's 1400 star graphs and its (train, val, test) loaders."""
    data = ds.create_star_graphs(num=N_DATA, fold=[5, 6, 7], dim=3,
                                 target="max", seed=0)
    tr, va, te = random_split(data, [0.5, 0.2, 0.3], seed=0)
    kw = dict(batch_size=BATCH_SIZE, pad=pad_sizes(data, BATCH_SIZE))
    return data, (GraphLoader(tr, shuffle=True, seed=0, **kw),
                  GraphLoader(va, **kw), GraphLoader(te, **kw))


# TFN's star configuration, the reference's (BASELINE.md: 4 layers, 200
# epochs, lr 5e-4, pool "first", fold [7]) at its published width
TFN_STAR = dict(num_layers=4, max_ell=3, emb_dim=64, mlp_dim=256,
                pool="first", gate=True, residual=True, tp_precision="highest")


def tfn_data():
    """TFN's star data: 1400 star graphs with seven spokes (fold [7]),
    target max angle, seed 0; split 50/20/30 (seed 0), batch 100."""
    data = ds.create_star_graphs(num=N_DATA, fold=[7], dim=3, target="max",
                                 seed=0)
    tr, va, te = random_split(data, [0.5, 0.2, 0.3], seed=0)
    kw = dict(batch_size=BATCH_SIZE, pad=pad_sizes(data, BATCH_SIZE))
    return data, (GraphLoader(tr, shuffle=True, seed=0, **kw),
                  GraphLoader(va, **kw), GraphLoader(te, **kw))


def tfn_model(generator: torch.Generator, device="cuda", **kw) -> TFNModel:
    """``TFNModel`` at ``TFN_STAR`` (entries overridden by ``kw``)."""
    return TFNModel(**dict(TFN_STAR, **kw), in_dim=1, out_dim=1,
                    generator=generator, device=device)


# MACE's star configuration, the protocol of the JAX package's MACE star
# number (scripts/validate_accuracy.py: 2 layers, pool "first", 200 epochs;
# lr 5e-4, cosine, 1500 graphs, fold [7], max_ell 3; the CLI's correlation
# 3 and batch 100) at the model's default widths (emb_dim 64, mlp_dim 256).
MACE_STAR = dict(num_layers=2, max_ell=3, correlation=3, emb_dim=64,
                 mlp_dim=256, pool="first", batch_norm=True, residual=True)
MACE_N_DATA, MACE_LR, MACE_EPOCHS = 1500, 5e-4, 200


def mace_data():
    """MACE's star data: 1500 star graphs with seven spokes (fold [7]),
    target max angle, seed 0; split 50/20/30 (seed 0), batch 100."""
    data = ds.create_star_graphs(num=MACE_N_DATA, fold=[7], dim=3,
                                 target="max", seed=0)
    tr, va, te = random_split(data, [0.5, 0.2, 0.3], seed=0)
    kw = dict(batch_size=BATCH_SIZE, pad=pad_sizes(data, BATCH_SIZE))
    return data, (GraphLoader(tr, shuffle=True, seed=0, **kw),
                  GraphLoader(va, **kw), GraphLoader(te, **kw))


def mace_model(generator: torch.Generator, device="cuda", **kw) -> MACEModel:
    """``MACEModel`` at ``MACE_STAR`` (entries overridden by ``kw``)."""
    return MACEModel(**dict(MACE_STAR, **kw), in_dim=1, out_dim=1,
                     generator=generator, device=device)


# The triplet models' star configurations.  DimeNet++: the JAX CLI's
# defaults (1000 graphs, batch 100, lr 1e-4, plateau schedule, seed 0, split
# 50/20/30) on fold [7] with 4 layers.  SphereNet: folds 5-7 with 2 layers
# under the protocol of the JAX package's SphereNet star number
# (scripts/validate_accuracy.py: 1500 graphs, lr 5e-4, cosine schedule).
DIMENET_STAR = dict(fold=[7], num_layers=4, with_quads=False, n_data=1000,
                    lr=1e-4, cosine=False)
SPHERENET_STAR = dict(fold=[5, 6, 7], num_layers=2, with_quads=True,
                      n_data=1500, lr=5e-4, cosine=True)


def triplet_star_data(fold, with_quads: bool, n_data: int, **_):
    """The JAX CLI's star data for a directional model: ``n_data`` star
    graphs on ``fold`` (target max angle, seed 0), split 50/20/30 (seed 0),
    batch 100, loaders with triplets (and quads), their node and triplet
    buckets sized over all the data.  Takes a ``*_STAR`` dict as keywords
    (its other entries are ignored)."""
    data = ds.create_star_graphs(num=n_data, fold=list(fold), dim=3,
                                 target="max", seed=0)
    tr, va, te = random_split(data, [0.5, 0.2, 0.3], seed=0)
    kw = dict(batch_size=BATCH_SIZE, pad=pad_sizes(data, BATCH_SIZE),
              with_triplets=True, with_quads=with_quads,
              triplet_pad=triplet_pad_sizes(data, BATCH_SIZE, with_quads))
    return data, (GraphLoader(tr, shuffle=True, seed=0, **kw),
                  GraphLoader(va, **kw), GraphLoader(te, **kw))


def bench_model(generator: torch.Generator, device="cuda",
                fuse_stack: bool = False) -> torch.nn.Module:
    """The bench's model: ``EGNNFusedModel`` (``fuse_stack`` picks its
    strategy), or the plain ``EGNNModel`` when ``GMP_BENCH_MODEL=egnn`` (the
    root bench's switch, its two values)."""
    kw = dict(num_layers=N_LAYERS, emb_dim=WIDTH, in_dim=1, out_dim=1,
              pool="first", generator=generator, device=device)
    if os.environ.get("GMP_BENCH_MODEL", "egnn_fused") == "egnn":
        if fuse_stack:
            raise ValueError("fuse_stack is an EGNNFusedModel strategy")
        return EGNNModel(**kw)
    return EGNNFusedModel(**kw, fuse_stack=fuse_stack)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1, help="shuffle seed")
    ap.add_argument("--init-seed", type=int, default=0,
                    help="seed of the initial weights")
    ap.add_argument("--samples", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=N_EPOCHS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    t_setup = time.time()
    _, loaders = bench_data()
    model = bench_model(seed_everything(args.init_seed))
    variables = model.state_dict()
    setup_time = time.time() - t_setup

    fit = dict(n_epochs=args.epochs, lr=LR, device="cuda")
    warm = fit_regression(model, variables, *loaders, seed=0, **fit)
    runs = [fit_regression(model, variables, *loaders, seed=args.seed, **fit)
            for _ in range(args.samples)]
    times = sorted(r.train_time for r in runs)
    med = times[len(times) // 2]
    res = runs[[r.train_time for r in runs].index(med)]
    edges_per_epoch = sum(g.num_edges for g in loaders[0].graphs)
    result = {
        "metric": "egnn_star_train_time_4l_200ep",
        "value": round(med, 4),
        "samples_s": [round(t, 4) for t in times],
        "unit": "s",
        "vs_baseline": round(BASELINE_TRAIN_TIME_S / res.train_time, 2),
        "baseline_s": BASELINE_TRAIN_TIME_S,
        "test_mae": round(res.test, 5),
        "best_val_mae": round(res.best_val, 5),
        "warmup_incl_compile_s": round(warm.train_time, 2),
        "train_edges_per_sec": round(edges_per_epoch * args.epochs
                                     / res.train_time, 0),
        "setup_s": round(setup_time, 2),
        "device": card_line(),
        "epochs": args.epochs, "seed": args.seed,
        "init_seed": args.init_seed,
        "sample_test_maes": [round(r.test, 5) for r in runs],
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
