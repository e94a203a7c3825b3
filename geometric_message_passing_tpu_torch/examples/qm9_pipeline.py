"""QM9-style property regression on the port (the twin of the repository's
``examples/qm9_pipeline.py``, same flags, plus ``--device``): the teaching
notebook's QM9 flow — complete graphs and one target column, target
standardisation, MSE training with Adam, and the de-normalised test MAE
(``MAE * std``) every 10 epochs.

The molecules are the JAX script's synthetic QM9 stand-in
(``make_molecules``: the same ``random.Random`` call order, so the same
molecules bit for bit): 5-12 atoms of 5 types, 3-D coordinates and two
targets, a pairwise-potential energy surrogate and the atom count.

    python -m geometric_message_passing_tpu_torch.examples.qm9_pipeline \\
        --model egnn [--device cpu]

Runs on the card (``--device cuda``, the default) unless told otherwise.
The model is ``model_registry[--model](num_layers=3, emb_dim=64, in_dim=5,
out_dim=1)`` with weights from ``seed_everything(0)``; batches come from
``GraphLoader`` (the JAX script's shuffle, seed 0).
"""

from __future__ import annotations

import argparse
import random

import numpy as np
import torch

from .. import resolve_device
from ..experiments.train import make_tx, seed_everything
from ..graph import Graph, GraphBatch, GraphLoader, random_split
from ..models import model_registry
from ..transforms import complete_graph, set_target


def make_molecules(num: int, seed: int = 0):
    """Synthetic QM9 stand-in: 5-12 atoms of 5 types; two target columns
    (a pairwise-potential energy surrogate and a size surrogate) so that
    ``set_target`` has something to select, like QM9's 19 targets."""
    rnd = random.Random(seed)
    out = []
    for _ in range(num):
        n = rnd.randint(5, 12)
        atoms = np.array([rnd.randrange(5) for _ in range(n)], np.int32)
        pos = np.array(
            [[rnd.gauss(0, 1) for _ in range(3)] for _ in range(n)],
            np.float32,
        )
        d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
        iu = np.triu_indices(n, 1)
        energy = float(np.sum(np.exp(-d[iu]) * (1 + 0.3 * (
            atoms[iu[0]] + atoms[iu[1]]))))
        y = np.array([energy, float(n)], np.float32)
        out.append(Graph(atoms, np.zeros((2, 0), np.int32), pos, y))
    return out


def standardised_data(n_data: int, target: int = 0):
    """``(graphs, mean, std)``: complete graphs of ``make_molecules(n_data)``
    with target column ``target``, standardised by the targets' mean and
    std (over every molecule, as the JAX script does)."""
    data = [set_target(complete_graph(g), target)
            for g in make_molecules(n_data)]
    ys = np.array([float(np.asarray(g.y)[0]) for g in data])
    mean, std = float(ys.mean()), float(ys.std() + 1e-12)
    data = [Graph(g.atoms, g.edge_index, g.pos,
                  (np.asarray(g.y) - mean) / std) for g in data]
    return data, mean, std


def mse_loss(model: torch.nn.Module, batch: GraphBatch) -> torch.Tensor:
    """Mean squared error of the first output column over the real
    graphs."""
    pred = model(batch)[:, 0]
    err = (pred - batch.y[:, 0]) ** 2 * batch.graph_mask
    return err.sum() / torch.clamp_min(batch.graph_mask.sum(), 1)


def train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
               batch: GraphBatch) -> torch.Tensor:
    """One Adam step on ``mse_loss``; returns the loss (no host read)."""
    loss = mse_loss(model, batch)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def mae_sum(model: torch.nn.Module, batch: GraphBatch) -> torch.Tensor:
    """Summed absolute error of the first output column over the real
    graphs (standardised units)."""
    pred = model(batch)[:, 0]
    return ((pred - batch.y[:, 0]).abs() * batch.graph_mask).sum()


def main(argv=None) -> list:
    """Train and print the JAX script's lines; returns the printed
    ``(epoch, train MSE, de-normalised test MAE)`` rows."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="egnn")
    p.add_argument("--target", type=int, default=0)
    p.add_argument("--n_data", type=int, default=400)
    p.add_argument("--n_epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    data, _, std = standardised_data(args.n_data, args.target)
    tr, va, te = random_split(data, [0.8, 0.1, 0.1], seed=0)
    kw = dict(batch_size=args.batch_size)
    tr_l = GraphLoader(tr, shuffle=True, seed=0, **kw)
    te_l = GraphLoader(te, **kw)

    model = model_registry[args.model](num_layers=3, emb_dim=64, in_dim=5,
                                       out_dim=1, generator=seed_everything(0),
                                       device=dev)
    opt = make_tx(model.parameters(), lr=args.lr)
    rows = []
    for epoch in range(args.n_epochs):
        model.train()
        losses = [train_step(model, opt, b.to(dev)) for b in tr_l]
        if (epoch + 1) % 10 == 0 or epoch == 0:
            model.eval()
            test_mae = float(sum(mae_sum(model, b.to(dev)) for b in te_l)
                             ) / len(te)
            train_mse = float(torch.stack(losses).mean())
            rows.append((epoch + 1, train_mse, test_mae * std))
            # the notebook's metric: MAE * std (de-normalised units)
            print(f"epoch {epoch + 1:3d}: train MSE {train_mse:.4f} "
                  f"test MAE(denorm) {test_mae * std:.4f}", flush=True)
    return rows


if __name__ == "__main__":
    main()
