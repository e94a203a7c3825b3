"""Incompleteness counterexamples: the degenerate environment pairs of
Pozdnyakov et al., 1-layer models (the port's twin of
``examples/incompleteness.py``, same flags, plus ``--device``).

    python -m geometric_message_passing_tpu_torch.examples.incompleteness \\
        --env two_body --models schnet egnn [--device cpu]

Expected: on ``two_body`` distance-only models (SchNet) fail and
E(3)-equivariant layers pass; on ``three_body`` MACE with correlation 3
passes; ``four_body_chiral`` is rotation-equivalent (its pair is one
rotation apart), ``true_chiral`` needs both parities.  Each arm is
``run_experiment`` over the two graphs (one batch of 2) from
``seed_everything(0)``'s weights.  Runs on the card (``--device cuda``, the
default) unless told otherwise.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import datasets as ds
from ..experiments.train import run_experiment, seed_everything
from ..graph import GraphLoader
from ..models import model_registry

ENVS = {
    "two_body": ds.create_two_body_envs,
    "three_body": ds.create_three_body_envs,
    "four_body_nonchiral": ds.create_four_body_nonchiral_envs,
    "four_body_chiral": ds.create_four_body_chiral_envs,
    "true_chiral": ds.create_true_chiral_envs,
}


def build(name: str, device):
    """The arm's 1-layer model, weights from ``seed_everything(0)``."""
    kw = dict(generator=seed_everything(0), device=device)
    if name == "schnet":
        return model_registry[name](num_layers=1, hidden_channels=32,
                                    num_filters=32, num_gaussians=16,
                                    in_dim=1, out_dim=2, **kw)
    if name == "mace":
        return model_registry[name](num_layers=1, emb_dim=16, max_ell=2,
                                    correlation=3, mlp_dim=64, in_dim=1,
                                    out_dim=2, equivariant_pred=True,
                                    pool="sum", **kw)
    return model_registry[name](num_layers=1, emb_dim=32, in_dim=1, out_dim=2,
                                equivariant_pred=True, pool="sum", **kw)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--env", choices=sorted(ENVS), default="two_body")
    p.add_argument("--models", nargs="+", default=["schnet", "egnn"])
    p.add_argument("--n_epochs", type=int, default=150)
    p.add_argument("--n_times", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    data = ENVS[args.env]()
    loader = GraphLoader(data, batch_size=len(data), y_dtype=np.int32)
    rows = []
    for name in args.models:
        model = build(name, args.device)
        _, test_acc, _ = run_experiment(
            model, loader, loader, loader, n_epochs=args.n_epochs,
            n_times=args.n_times, device=args.device)
        rows.append({"env": args.env, "model": name, "test_acc": test_acc})
        print(f"{args.env:20s} {name:8s}: "
              f"test {np.mean(test_acc):6.1f}% ± {np.std(test_acc):.1f} "
              f"{test_acc}", flush=True)
    return rows


if __name__ == "__main__":
    main()
