"""Rotationally symmetric structures: an n-fold symmetric star and the same
star turned, 1-layer models with equivariant prediction.  Cartesian-vector
models (EGNN, GVP-GNN) stay at 50%; spherical-tensor models (TFN, MACE)
separate the pair when max_ell >= fold (the port's twin of
``examples/rotsym.py``, same flags, plus ``--device``).

    python -m geometric_message_passing_tpu_torch.examples.rotsym \\
        --fold 3 --models egnn tfn mace [--device cpu]

Each arm is ``run_experiment`` over the two graphs (train = validation =
test, one batch of 2) from ``seed_everything(0)``'s weights.  Runs on the
card (``--device cuda``, the default) unless told otherwise.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import datasets as ds
from ..experiments.train import run_experiment, seed_everything
from ..graph import GraphLoader
from ..models import model_registry


def build(name: str, fold: int, max_ell: int, device):
    """The arm's 1-layer model, weights from ``seed_everything(0)``."""
    kw = dict(generator=seed_everything(0), device=device)
    if name in ("egnn", "gvp"):
        return model_registry[name](num_layers=1, in_dim=1, out_dim=2,
                                    equivariant_pred=True, pool="sum", **kw)
    if name == "tfn":
        return model_registry[name](num_layers=1, emb_dim=8, max_ell=max_ell,
                                    mlp_dim=32, in_dim=1, out_dim=2,
                                    equivariant_pred=True, pool="first",
                                    gate=False, **kw)
    if name == "mace":
        return model_registry[name](num_layers=1, emb_dim=8, max_ell=max_ell,
                                    correlation=2, mlp_dim=32, in_dim=1,
                                    out_dim=2, equivariant_pred=True,
                                    pool="first", **kw)
    raise SystemExit(f"unsupported model {name}")


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fold", type=int, default=3)
    p.add_argument("--models", nargs="+", default=["egnn", "tfn"])
    p.add_argument("--max_ell", type=int, default=None,
                   help="default: sweep fold-1 and fold")
    p.add_argument("--n_epochs", type=int, default=150)
    p.add_argument("--n_times", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    data = ds.create_rotsym_envs(fold=args.fold)
    loader = GraphLoader(data, batch_size=2, y_dtype=np.int32)
    rows = []
    for name in args.models:
        ells = ([args.max_ell] if args.max_ell is not None
                else ([args.fold - 1, args.fold]
                      if name in ("tfn", "mace") else [0]))
        for ell in ells:
            model = build(name, args.fold, ell, args.device)
            _, test_acc, _ = run_experiment(
                model, loader, loader, loader, n_epochs=args.n_epochs,
                n_times=args.n_times, device=args.device)
            rows.append({"model": name, "max_ell": ell, "test_acc": test_acc})
            tag = f" max_ell={ell}" if name in ("tfn", "mace") else ""
            print(f"{name:6s}{tag}: test {np.mean(test_acc):6.1f}% "
                  f"± {np.std(test_acc):.1f} {test_acc}", flush=True)
    return rows


if __name__ == "__main__":
    main()
