"""k-chains: two k-chains that differ only at one end; sweep the number of
layers from k/2 to k+1 and report the test accuracy of each model (the
port's twin of ``examples/kchains.py``, same flags, plus ``--device``).

    python -m geometric_message_passing_tpu_torch.examples.kchains \\
        --k 4 --models egnn mpnn [--device cpu]

Each arm is ``run_experiment`` (the classification repeat protocol) over
the two graphs as train, validation and test set, one batch of 2; the
model's initial weights come from ``seed_everything(0)``.  Runs on the card
(``--device cuda``, the default) unless told otherwise.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import datasets as ds
from ..experiments.train import run_experiment, seed_everything
from ..graph import GraphLoader
from ..models import model_registry


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--k", type=int, default=4)
    p.add_argument("--models", nargs="+", default=["mpnn", "egnn"])
    p.add_argument("--n_epochs", type=int, default=100)
    p.add_argument("--n_times", type=int, default=3)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    data = ds.create_kchains(args.k)
    loader = GraphLoader(data, batch_size=2, y_dtype=np.int32)
    print(f"k={args.k}: layers swept {args.k // 2}..{args.k + 1}")
    rows = []
    for name in args.models:
        for num_layers in range(args.k // 2, args.k + 2):
            model = model_registry[name](
                num_layers=num_layers, emb_dim=32, in_dim=1, out_dim=2,
                generator=seed_everything(0), device=args.device)
            _, test_acc, _ = run_experiment(
                model, loader, loader, loader, n_epochs=args.n_epochs,
                n_times=args.n_times, lr=args.lr, device=args.device)
            rows.append({"model": name, "num_layers": num_layers,
                         "test_acc": test_acc})
            print(f"{name:8s} layers={num_layers}: "
                  f"test {np.mean(test_acc):6.1f}% ± {np.std(test_acc):.1f} "
                  f"{test_acc}", flush=True)
    return rows


if __name__ == "__main__":
    main()
