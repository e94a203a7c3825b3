"""The code cells of the geometric-GNN-101 notebook on the port (the twin of
``scripts/make_101_notebook.py``'s cells): the data, the three symmetry
unit tests, ``evaluate`` / ``train_model`` and the radius sparsification,
as functions; ``main`` runs the notebook's table.

    python -m geometric_message_passing_tpu_torch.examples.gnn101 [--device cpu]

prints the unit tests' outcomes, trains MPNN, CoordMPNN, InvariantMPNN and
FinalMPNN (4 x 64) on complete graphs of 400 synthetic QM9-style molecules
for 40 epochs (lr 5e-3, batch 32), then MPNN, InvariantMPNN and FinalMPNN
on radius graphs (r 1.5) for 25, and the test MAEs side by side.  Runs on
the card (``--device cuda``, the default) unless told otherwise.

Batches come from ``GraphLoader`` (block-diagonal, pad rows at the end), as
in the JAX notebook: BatchNorm's statistics include the pad rows, so the
trainers' slot layout (``SlotData``) would change the numbers.  The loss is
the MSE on standardised targets, the metric the de-normalised MAE.  A
model's weights are its own (built from ``generator=seed_everything(s)``);
the shuffle's seed is ``train_model(seed=)``.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..experiments.train import make_tx, seed_everything
from ..graph import Graph, GraphBatch, GraphLoader, random_split
from ..models.egnn import MPNNModel
from ..models.gnn101 import (CoordMPNNModel, EquivariantMPNNLayer,
                             FinalMPNNModel, InvariantMPNNModel)
from ..ops.radius_graph import radius_graph
from ..transforms import (complete_graph, permute_graph,
                          random_orthogonal_matrix, rotate_graph, set_target)
from .qm9_pipeline import make_molecules

MODELS = {"MPNN": MPNNModel, "CoordMPNN": CoordMPNNModel,
          "InvariantMPNN": InvariantMPNNModel, "FinalMPNN": FinalMPNNModel}
SPARSE_MODELS = ("MPNN", "InvariantMPNN", "FinalMPNN")


@dataclass
class Splits:
    """The notebook's 80/10/10 split and the train targets' mean and std
    (``MEAN``, ``STD``)."""
    train: list
    val: list
    test: list
    mean: float
    std: float


def radius_sparsify(g: Graph, r: float = 1.5) -> Graph:
    """``g`` with the radius graph at ``r`` in place of its edges."""
    ei = radius_graph(np.asarray(g.pos), r=r)
    return Graph(g.atoms, ei.astype(np.int32), g.pos, g.y)


def notebook_data(num: int = 400, seed: int = 0) -> list:
    """The notebook's dataset: complete graphs of ``make_molecules(num,
    seed)`` with target column 0."""
    return [set_target(complete_graph(g), 0) for g in make_molecules(num, seed)]


def notebook_splits(dataset: Optional[list] = None) -> Splits:
    """``random_split(dataset, [0.8, 0.1, 0.1], seed=0)`` and the train
    targets' mean and std (default: ``notebook_data()``)."""
    dataset = notebook_data() if dataset is None else dataset
    tr, va, te = random_split(dataset, [0.8, 0.1, 0.1], seed=0)
    ys = np.concatenate([np.atleast_1d(np.asarray(g.y, np.float32))
                         for g in tr])
    return Splits(tr, va, te, float(ys.mean()), float(ys.std() + 1e-8))


def build(name: str, num_layers: int = 4, emb_dim: int = 64, seed: int = 0,
          device=None) -> torch.nn.Module:
    """The notebook's ``name`` model (``MODELS``) at ``num_layers`` x
    ``emb_dim``, ``in_dim`` 5, one output, weights from
    ``seed_everything(seed)``."""
    return MODELS[name](num_layers=num_layers, emb_dim=emb_dim, in_dim=5,
                        out_dim=1, generator=seed_everything(seed),
                        device=device)


def _device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def batch_one(g: Graph, device="cpu") -> GraphBatch:
    """``g`` alone as a padded batch on ``device``."""
    return next(iter(GraphLoader([g], batch_size=1))).to(device)


@torch.no_grad()
def permutation_invariance_unit_test(model: torch.nn.Module, g: Graph,
                                     seed: int = 0) -> bool:
    """The model's output (eval mode) unchanged, to 1e-4, when ``g``'s
    nodes are permuted."""
    model.eval()
    dev = _device(model)
    out1 = model(batch_one(g, dev))
    perm = np.random.default_rng(seed).permutation(g.num_nodes)
    out2 = model(batch_one(permute_graph(g, perm), dev))
    return bool(torch.allclose(out1, out2, atol=1e-4))


@torch.no_grad()
def rot_trans_invariance_unit_test(model: torch.nn.Module, g: Graph,
                                   seed: int = 0) -> bool:
    """The model's output (eval mode) unchanged, to 1e-4, when ``g`` is
    rotated by a random orthogonal matrix and moved by (10, -5, 2)."""
    model.eval()
    dev = _device(model)
    out1 = model(batch_one(g, dev))
    Q = random_orthogonal_matrix(3, seed=seed)
    t = np.array([10.0, -5.0, 2.0], np.float32)
    out2 = model(batch_one(rotate_graph(g, Q, t), dev))
    return bool(torch.allclose(out1, out2, atol=1e-4))


@torch.no_grad()
def rot_trans_equivariance_unit_test(g: Graph, emb_dim: int = 32,
                                     seed: int = 0, device="cpu") -> tuple:
    """``(features invariant, positions equivariant)`` of an
    ``EquivariantMPNNLayer`` (eval mode, weights from seed 0) on ``g``
    with ``h = 1`` and zero edge features, under a random orthogonal
    matrix and a shift by 3, each to 1e-4."""
    b = batch_one(g, device)
    layer = EquivariantMPNNLayer(emb_dim, generator=seed_everything(0)).to(
        device).eval()
    h0 = torch.ones((b.atoms.shape[0], emb_dim), device=device)
    ea = torch.zeros((b.senders.shape[0], 4), device=device)
    h1, p1 = layer(h0, b.pos, b.senders, b.receivers, ea, b.edge_mask)
    Q = torch.as_tensor(random_orthogonal_matrix(3, seed=seed),
                        dtype=torch.float32, device=device)
    t = 3.0
    h2, p2 = layer(h0, b.pos @ Q.T + t, b.senders, b.receivers, ea,
                   b.edge_mask)
    return (bool(torch.allclose(h1, h2, atol=1e-4)),
            bool(torch.allclose(p1 @ Q.T + t, p2, atol=1e-4)))


@torch.no_grad()
def evaluate(model: torch.nn.Module, loader: GraphLoader, mean: float,
             std: float) -> float:
    """The de-normalised MAE over ``loader``'s real graphs (eval mode)."""
    model.eval()
    dev = _device(model)
    tot, cnt = 0.0, 0
    for b in loader:
        b = b.to(dev)
        out = model(b) * std + mean
        tot += float(((out - b.y).abs() * b.graph_mask[:, None]).sum())
        cnt += int(b.graph_mask.sum())
    return tot / max(cnt, 1)


def notebook_loss(out: torch.Tensor, b: GraphBatch, mean: float,
                  std: float) -> torch.Tensor:
    """The notebook's loss of a model's output ``out`` on ``b``: the MSE on
    standardised targets over the real graphs."""
    y = (b.y - mean) / std
    err = (out - y) ** 2 * b.graph_mask[:, None]
    return err.sum() / torch.clamp_min(b.graph_mask.sum(), 1)


def train_model(model: torch.nn.Module, name: str = "model",
                n_epochs: int = 40, lr: float = 5e-3,
                splits: Optional[Splits] = None, batch_size: int = 32,
                seed: int = 0, results: Optional[dict] = None,
                verbose: bool = True) -> dict:
    """The notebook's ``train_model``: Adam at ``lr`` on ``notebook_loss``
    (train mode), the validation MAE after every epoch, the test MAE at the
    end; trains ``model`` in place on its own device.  Returns
    ``{"val_curve", "test_mae"}`` and, with ``results``, stores it under
    ``name``.  ``splits`` defaults to ``notebook_splits()``."""
    sp = notebook_splits() if splits is None else splits
    dev = _device(model)
    tr = GraphLoader(sp.train, batch_size=batch_size, shuffle=True, seed=seed)
    va = GraphLoader(sp.val, batch_size=batch_size)
    te = GraphLoader(sp.test, batch_size=batch_size)
    opt = make_tx(model.parameters(), lr=lr)
    curve = []
    for _ in range(n_epochs):
        model.train()
        for b in tr:
            b = b.to(dev)
            loss = notebook_loss(model(b), b, sp.mean, sp.std)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        curve.append(evaluate(model, va, sp.mean, sp.std))
    out = {"val_curve": curve, "test_mae": evaluate(model, te, sp.mean, sp.std)}
    if results is not None:
        results[name] = out
    if verbose:
        print(f"{name:>14}: best val MAE {min(curve):.4f}   test MAE "
              f"{out['test_mae']:.4f}", flush=True)
    return out


def main(argv=None) -> dict:
    """The notebook's table: the unit tests, the four models on complete
    graphs, three on radius graphs; returns both tables' test MAEs."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n_epochs", type=int, default=40)
    p.add_argument("--sparse_epochs", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    dataset = notebook_data()
    splits = notebook_splits(dataset)
    g0 = splits.train[0]
    for name in MODELS:
        small = MODELS[name](num_layers=2, emb_dim=32, in_dim=5, device=dev)
        print(f"{name:>14}: permutation invariant "
              f"{permutation_invariance_unit_test(small, g0)}, rotation/"
              f"translation invariant {rot_trans_invariance_unit_test(small, g0)}")
    fi, pe = rot_trans_equivariance_unit_test(g0, device=dev)
    print(f"EquivariantMPNNLayer: feature invariance {'PASS' if fi else 'FAIL'}"
          f", position equivariance {'PASS' if pe else 'FAIL'}")

    results: dict = {}
    for name in MODELS:
        train_model(build(name, seed=args.seed, device=dev), name,
                    n_epochs=args.n_epochs, splits=splits, seed=args.seed,
                    results=results)
    sparse_dataset = [radius_sparsify(g) for g in dataset]
    sparse = notebook_splits(sparse_dataset)
    e_dense = np.mean([g.num_edges for g in dataset])
    e_sparse = np.mean([g.num_edges for g in sparse_dataset])
    print(f"mean edges per molecule: complete {e_dense:.1f} vs sparse "
          f"{e_sparse:.1f}")
    sparse_results: dict = {}
    for name in SPARSE_MODELS:
        print("[sparse] ", end="")
        train_model(build(name, seed=args.seed, device=dev), name,
                    n_epochs=args.sparse_epochs, splits=sparse,
                    seed=args.seed, results=sparse_results)
    print(f"{'model':>14} | {'complete (test MAE)':>20} | "
          f"{'sparse (test MAE)':>18}")
    print("-" * 60)
    for name in SPARSE_MODELS:
        print(f"{name:>14} | {results[name]['test_mae']:>20.4f} | "
              f"{sparse_results[name]['test_mae']:>18.4f}")
    return {"complete": {k: v["test_mae"] for k, v in results.items()},
            "sparse": {k: v["test_mae"] for k, v in sparse_results.items()}}


if __name__ == "__main__":
    main()
