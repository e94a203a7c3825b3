"""Angle-prediction experiment CLI (port of the JAX package's
``experiments/cli.py``): the same flags, defaults and choices, the same
datasets and model arguments, the same split, loaders and ledger record.

Usage (on the card):
    python -m geometric_message_passing_tpu_torch.experiments.cli \\
        --model mace --dataset paired_star --fold 7 --n_pairs 2 ...

``main(argv, device="cpu")`` runs the plain PyTorch versions of the kernels
on the CPU (the tests do); ``device`` is an argument of ``main``, not a
flag.  ``--matmul_precision`` sets the process default of ``precision.py``
for the run (and restores the previous one on return); ``--tp_precision``
and ``--tp_precision_scope`` reach the models' scoped products.
"""

from __future__ import annotations

import argparse
import time
from functools import partial


from .. import datasets as ds
from .. import precision
from .. import resolve_device
from ..graph import GraphLoader, pad_sizes, random_split
from ..models import model_registry
from .ledger import append_result
from .train import run_experiment_reg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Graph angle prediction (PyTorch/CUDA port).")
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--pool", type=str, default="mean")
    p.add_argument("--max_corr", type=int, default=3)
    p.add_argument("--max_ell", type=int, default=3)
    p.add_argument("--n_epochs", type=int, default=600)
    p.add_argument("--n_layers", type=int, default=2)
    p.add_argument("--n_data", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--fold", type=int, nargs="+")
    p.add_argument("--n_nodes", type=int, nargs="+")
    p.add_argument("--n_pairs", type=int)
    p.add_argument("--cosine", action="store_true")
    p.add_argument("--equivariant", action="store_true")
    p.add_argument("--loss_mask", action="store_true",
                   help="paired_star2: score only the first half of the "
                        "targets (the angles at the first centre)")
    p.add_argument("--n_times", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--results_file", type=str, default="exp_history.json")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="save the whole state of each repeat under "
                        "DIR/run<i> every --checkpoint_every epochs; a run "
                        "given a directory that holds checkpoints resumes "
                        "from the latest, bitwise the uninterrupted run")
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--nan_recovery", action="store_true",
                   help="roll back to the latest checkpoint when an epoch's "
                        "training losses are not finite (at most 3 times); "
                        "needs --checkpoint_dir and --checkpoint_every")
    p.add_argument("--grad_clip", type=float, default=None,
                   help="global-norm gradient clipping (opt-in). A "
                        "checkpoint written with one setting does not "
                        "restore under another: resume with the same "
                        "setting")
    p.add_argument("--lr_warmup", type=int, default=-1,
                   help="linear LR warmup over the first N epochs. -1 "
                        "(default) resolves per task: 50 for "
                        "egnn/paired_star*, off elsewhere; 0 disables")
    p.add_argument("--bf16_tp_weights", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="tfn/mace: the per-edge tensor-product weights in "
                        "bfloat16 (the models' weights_bf16)")
    p.add_argument("--matmul_precision", type=str, default=None,
                   choices=["default", "tensorfloat32", "float32",
                            "bfloat16_3x", "highest"],
                   help="the process default of the float32 products "
                        "(precision.py) for the run: 'highest' and "
                        "'float32' exact IEEE f32; 'tensorfloat32' TF32 "
                        "tensor cores; 'bfloat16_3x' three bf16 products "
                        "(hi.hi + hi.lo + lo.hi) accumulated in f32; "
                        "'default' is PyTorch's default on the card, exact "
                        "f32, as with no flag. The hand-written kernels "
                        "compute exact f32 whatever it says")
    p.add_argument("--tp_precision", type=str, default="model",
                   choices=["model", "default", "highest"],
                   help="tfn/mace/mace_ff: the precision of the equivariant "
                        "products ('default': the process default; 'model': "
                        "each model's own)")
    p.add_argument("--tp_precision_scope", type=str, default="model",
                   choices=["model", "all", "conv", "prod", "heads"],
                   help="mace: which stages take --tp_precision (conv: the "
                        "edge products; prod: the symmetric contraction and "
                        "its linear; all: both; heads: both and the weight "
                        "heads); the others follow --matmul_precision")
    return p


def make_dataset(args):
    """The dataset and the model's width arguments, as the JAX CLI makes
    them."""
    if args.dataset == "star":
        data = ds.create_star_graphs(num=args.n_data, fold=args.fold, dim=3,
                                     target="max")
        model_args = dict(num_layers=args.n_layers, in_dim=1, out_dim=1)
    elif args.dataset == "paired_star":
        data = ds.create_paired_star_graphs(num=args.n_data, fold=args.fold,
                                            dim=3, n_pairs=args.n_pairs)
        model_args = dict(num_layers=args.n_layers, in_dim=args.n_pairs + 2,
                          out_dim=args.n_pairs)
    elif args.dataset == "paired_star2":
        data = ds.create_paired_star_graphs_with_two_centers(
            num=args.n_data, fold=args.fold, dim=3, n_pairs=args.n_pairs)
        model_args = dict(num_layers=args.n_layers, in_dim=args.n_pairs + 2,
                          out_dim=args.n_pairs * 2)
    elif args.dataset == "complete":
        data = ds.create_paired_complete_graphs(
            num=args.n_data, n_nodes=args.n_nodes, dim=3, n_pairs=args.n_pairs)
        model_args = dict(num_layers=args.n_layers, in_dim=args.n_pairs + 2,
                          out_dim=args.n_pairs)
    else:
        raise SystemExit(f"unknown dataset {args.dataset}")
    return data, model_args


def make_model_func(args):
    """The model's constructor with the flags' arguments bound, as the JAX
    CLI binds them."""
    name = args.model
    base = model_registry[name]
    if name in ("schnet", "dimenet", "spherenet"):
        return base
    prec = {}
    if args.tp_precision != "model":
        prec["tp_precision"] = (None if args.tp_precision == "default"
                                else args.tp_precision)
    if name == "mace_ff":
        return partial(base, pool=args.pool, **prec)
    if name == "tfn":
        # the JAX CLI's per-task switch: paired_star* takes TFN's fast
        # numerics on the TPU
        if args.tp_precision == "model" and args.dataset.startswith(
                "paired_star"):
            prec["tp_precision"] = None
        return partial(base, max_ell=args.max_ell,
                       equivariant_pred=args.equivariant, pool=args.pool,
                       weights_bf16=args.bf16_tp_weights, **prec)
    if name == "mace":
        return partial(base, max_ell=args.max_ell, correlation=args.max_corr,
                       equivariant_pred=args.equivariant, pool=args.pool,
                       weights_bf16=args.bf16_tp_weights,
                       **({"tp_precision_scope": args.tp_precision_scope}
                          if args.tp_precision_scope != "model" else {}),
                       **prec)
    return partial(base, equivariant_pred=args.equivariant, pool=args.pool)


def make_loaders(args, data):
    """The train, validation and test loaders, as the JAX CLI makes them:
    the 50/20/30 split (seed 0), one padding bucket for the whole dataset,
    the training loader shuffled (seed 0), triplets (and quads) for
    dimenet (spherenet) padded for the whole dataset."""
    tr, va, te = random_split(data, [0.5, 0.2, 0.3], seed=0)
    needs_tri = args.model in ("dimenet", "spherenet")
    needs_quads = args.model == "spherenet"
    pad = pad_sizes(data, args.batch_size)
    tri_pad = None
    if needs_tri:
        from ..triplets import triplet_pad_sizes

        tri_pad = triplet_pad_sizes(data, args.batch_size, needs_quads)
    kw = dict(batch_size=args.batch_size, pad=pad, with_triplets=needs_tri,
              with_quads=needs_quads, triplet_pad=tri_pad)
    return (GraphLoader(tr, shuffle=True, seed=0, **kw), GraphLoader(va, **kw),
            GraphLoader(te, **kw))


def resolve_lr_warmup(args) -> None:
    """``args.lr_warmup`` -1 becomes the per-task default (50 epochs for
    egnn on paired_star*, else off: None), 0 becomes None."""
    if args.lr_warmup == -1:
        args.lr_warmup = (50 if args.model == "egnn"
                          and args.dataset.startswith("paired_star") else None)
    elif args.lr_warmup == 0:
        args.lr_warmup = None


def main(argv=None, device=None):
    """Run the experiment the flags ``argv`` describe on ``device`` (default
    ``"cuda"``; raises without CUDA), print the test MAE, append the record
    to ``--results_file`` and return the mean test MAE.  The run's process
    precision is ``--matmul_precision``'s (exact f32 without it); the one
    before the call is restored on return."""
    args = build_parser().parse_args(argv)
    resolve_lr_warmup(args)
    dev = resolve_device(device)
    data, model_args = make_dataset(args)
    loaders = make_loaders(args, data)
    model_func = make_model_func(args)
    loss_mask = args.dataset == "paired_star2" and args.loss_mask

    t0 = time.time()
    with precision.matmul_precision(args.matmul_precision):
        best_val, test_mae, train_time, mean, std = run_experiment_reg(
            model_func, model_args, *loaders, n_epochs=args.n_epochs,
            n_times=args.n_times, verbose=True, cosine=args.cosine,
            lr=args.lr, loss_mask=loss_mask,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            nan_recovery=args.nan_recovery, device=dev,
            grad_clip=args.grad_clip, lr_warmup=args.lr_warmup)
    print(f"Test MAE {mean:.5f} ± {std:.5f}  (total {time.time()-t0:.1f}s)")

    record = vars(args).copy()
    record.update(
        best_val_acc=best_val, test_acc=test_mae, train_time=train_time,
        mean=mean, std=std,
    )
    append_result(args.results_file, record)
    return mean


if __name__ == "__main__":
    main()
