"""Write the four experiment notebooks for the port (the twin of
``scripts/make_experiment_notebooks.py``): ``kchains.ipynb``,
``rotsym.ipynb``, ``incompleteness.ipynb`` and
``star_graph_pair_angle.ipynb``, the same cells, driving the port's
``examples/{kchains,rotsym,incompleteness}.py``, its datasets, its
``fit_classification`` and its CLI.

    python -m geometric_message_passing_tpu_torch.examples.make_experiment_notebooks \\
        [--device cuda|cpu] [--only NAME] [--execute]

writes them to ``examples/notebooks/`` beside this file, without outputs
unless ``--execute`` (``nbclient``) runs them first.  One ``DEVICE`` line
in each header cell says where they run.
"""

from __future__ import annotations

import argparse
import os

from .make_101_notebook import NOTEBOOK_DIR, write

HEADER = """
import os, sys
sys.path.insert(0, os.path.abspath(os.path.join("..", "..", "..")))  # the repo
DEVICE = "{device}"   # "cuda": the H100 and its kernels; "cpu": plain PyTorch

%matplotlib inline
import numpy as np
import matplotlib.pyplot as plt
import torch
from geometric_message_passing_tpu_torch import datasets as ds
from geometric_message_passing_tpu_torch.utils.plot import plot_2d, plot_3d
torch.backends.cuda.matmul.allow_tf32 = False   # the port computes exact f32
"""

TRAIN_ACC_HELPER = """
from geometric_message_passing_tpu_torch.experiments import fit_classification
from geometric_message_passing_tpu_torch.experiments.train import seed_everything
from geometric_message_passing_tpu_torch.graph import GraphLoader
from geometric_message_passing_tpu_torch.models import (
    EGNNModel, MACEModel, SchNetModel, TFNModel)

def train_acc(model_cls, data, n_epochs=200, lr=1e-3, seed=0, **model_kw):
    \"\"\"Train = val = test on the 2-graph pair (the reference protocol:
    success == the representation separates the pair, so even memorization
    is impossible for an incomplete descriptor).  The model's weights come
    from seed_everything(seed).\"\"\"
    loader = GraphLoader(data, batch_size=2, y_dtype=np.int32)
    model = model_cls(**model_kw, generator=seed_everything(seed), device=DEVICE)
    res = fit_classification(model, None, loader, loader, loader,
                             n_epochs=n_epochs, lr=lr, seed=seed, device=DEVICE)
    return res.test
"""


def notebooks(device: str = "cuda") -> dict:
    """File name -> the notebook as ``(kind, source)`` pairs."""
    header = HEADER.format(device=device)
    return {
        # --------------------------------------------------------------
        "kchains.ipynb": [
            ("md", """
# Propagating geometric information: k-chains

Re-creation of the reference's `kchains.ipynb` on the PyTorch port.
*Background:* in geometric GNNs, **geometric information** — such as the
relative orientation of the two endpoints — must be propagated along the
graph by message passing.  The two k-chain graphs below differ **only** in
the orientation of one terminal node; distinguishing them requires
information from the distinguishing end to reach the readout, i.e. at least
`floor(k/2) + 1` message-passing layers.  Too few layers *underreach*;
the depth sweep exposes the phase transition.

The depth threshold is enforced as a pytest behavioral test
(`tests/test_torch_expressivity.py::test_kchains_depth_requirement`).
"""),
            ("code", header),
            ("code", """
k = 4
dataset = ds.create_kchains(k=k)
for g in dataset:
    print("atoms:", g.atoms, " y:", g.y)
    print("edges:\\n", g.edge_index)
fig = plt.figure(figsize=(9, 4))
for i, g in enumerate(dataset):
    plot_3d(g, lim=5 * k, ax=fig.add_subplot(1, 2, 1 + i, projection="3d"))
plt.show()
"""),
            ("md", """
Graph 0 and graph 1 share the chain body; only the final bend differs.
A model with `L` layers sees a `L`-hop neighborhood at the readout node —
below the threshold the two graphs are **provably indistinguishable**.
"""),
            ("code", """
from geometric_message_passing_tpu_torch.examples import kchains
# the reference protocol: 100 epochs x 10 repeats, the SAME parameters
# continuing training across repeats (the reference's model-reuse quirk)
rows = kchains.main(["--k", str(k), "--models", "mpnn", "egnn",
                     "--n_epochs", "100", "--n_times", "10",
                     "--device", DEVICE])
"""),
            ("md", """
The position-blind MPNN stays at 50% at EVERY depth (the chains are
isomorphic with identical edge lengths — only geometry differs), while
the geometric model lifts off chance once depth suffices — the
reference's oversquashing/underreaching picture.  `layers >= k/2 + 1`
is the *expressivity* floor (below it the graphs are provably
indistinguishable); within this demo budget the *learnability* transition
lands a layer or two above the floor, and success is statistical over
repeats.  The full sweep is
`python -m geometric_message_passing_tpu_torch.examples.kchains --k 8
--models mpnn egnn --n_times 10`.
"""),
        ],
        # --------------------------------------------------------------
        "rotsym.ipynb": [
            ("md", """
# Identifying neighbourhood orientation: rotationally symmetric structures

Re-creation of the reference's `rotsym.ipynb` on the PyTorch port.
*Background:* rotationally equivariant GNNs aggregate local geometry into
per-node features that transform predictably under rotation.  The two
environments below are `fold`-fold rotationally symmetric stars whose
orientations differ by half a step — distinguishing them from a **single
aggregated neighborhood** requires spherical-tensor features of degree
`>= fold`:

* Cartesian-vector models (EGNN, GVP) carry only degree-1 information —
  the symmetric star sums every spoke direction to ~0, so they are blind
  (stuck at 50%).
* Spherical-tensor models (TFN, MACE) solve the task **iff
  `max_ell >= fold`**.

Enforced in `tests/test_torch_expressivity.py`.
"""),
            ("code", header),
            ("code", """
fold = 3
dataset = ds.create_rotsym_envs(fold=fold)
fig, axes = plt.subplots(1, 2, figsize=(9, 4))
for g, ax in zip(dataset, axes):
    plot_2d(g, lim=1, ax=ax)
plt.show()
"""),
            ("md", """
Environment 0 and environment 1: the same `fold`-fold star, rotated by
half the symmetry angle.  Every pairwise distance and angle multiset is
identical — only the l >= fold spherical moments differ.
"""),
            ("code", """
from geometric_message_passing_tpu_torch.examples import rotsym
rows = rotsym.main(["--fold", str(fold), "--models", "egnn", "tfn",
                    "--n_epochs", "100", "--n_times", "2", "--device", DEVICE])
"""),
            ("md", """
EGNN stays at 50% at every setting; TFN fails at `max_ell = fold - 1` and
snaps to 100% at `max_ell = fold` — the degree threshold, exactly as in
the reference.  Full sweep:
`python -m geometric_message_passing_tpu_torch.examples.rotsym --fold 5
--models egnn gvp tfn mace`.
"""),
        ],
        # --------------------------------------------------------------
        "incompleteness.ipynb": [
            ("md", """
# Identifying neighbourhood fingerprints: counterexamples from Pozdnyakov et al., 2020

Re-creation of the reference's `incompleteness.ipynb` on the PyTorch port
([Incompleteness of Atomic Structure Representations](https://journals.aps.org/prl/abstract/10.1103/PhysRevLett.125.166001)):
pairs of local environments that identical **2-body** (distances),
**3-body** (distances + angles), or **4-body** descriptor sets cannot
distinguish.  Each section builds one counterexample pair, trains 1-layer
models on it (train = test: success requires the representation to
*separate* the pair), and reads out the pass/fail.

The whole table is enforced in `tests/test_torch_expressivity.py`; the
script form is `python -m
geometric_message_passing_tpu_torch.examples.incompleteness --env
three_body --models ...`.
"""),
            ("code", header + TRAIN_ACC_HELPER),
            ("md", """
## Two-body counterexample

A pair of local neighbourhoods indistinguishable by the unordered set of
center-neighbor **distances**.  SchNet (distance-only messages) cannot
separate them; any model with access to directions (here a 1-layer EGNN
with equivariant readout) can.
"""),
            ("code", """
data2 = ds.create_two_body_envs()
fig = plt.figure(figsize=(9, 4))
for i, g in enumerate(data2):
    plot_3d(g, lim=6, ax=fig.add_subplot(1, 2, 1 + i, projection="3d"))
plt.show()
"""),
            ("code", """
acc_schnet = train_acc(SchNetModel, data2, num_layers=1, hidden_channels=32,
                       in_dim=1, out_dim=2)
acc_egnn = train_acc(EGNNModel, data2, num_layers=1, emb_dim=32, in_dim=1,
                     out_dim=2, equivariant_pred=True, pool="sum")
print(f"SchNet (2-body distances): {acc_schnet:5.1f}%  <- chance = fail")
print(f"EGNN  (directions):        {acc_egnn:5.1f}%  <- separates")
"""),
            ("md", """
## Three-body counterexample

Indistinguishable by the set of **3-body scalars** (distances + angles).
A MACE layer with `correlation=1` exposes exactly distance/angle-order
information through its scalar readout — it fails; raising the body order
(`correlation=3`, `max_ell=3`) separates the pair.
"""),
            ("code", """
data3 = ds.create_three_body_envs()
fig = plt.figure(figsize=(9, 4))
for i, g in enumerate(data3):
    plot_3d(g, lim=6, ax=fig.add_subplot(1, 2, 1 + i, projection="3d"))
plt.show()
"""),
            ("code", """
acc_c1 = train_acc(MACEModel, data3, num_layers=1, emb_dim=8, max_ell=2,
                   correlation=1, mlp_dim=32, in_dim=1, out_dim=2, pool="sum")
acc_c3 = train_acc(MACEModel, data3, num_layers=1, emb_dim=8, max_ell=3,
                   correlation=3, mlp_dim=32, in_dim=1, out_dim=2, pool="sum")
print(f"MACE correlation=1 (~ dist+angle): {acc_c1:5.1f}%  <- fail")
print(f"MACE correlation=3:                {acc_c3:5.1f}%  <- separates")
"""),
            ("md", """
## Four-body non-chiral counterexample

The hardest scalar pair: indistinguishable by low-body-order descriptor
sets.  The reference's cell 10 runs a single-layer MACE at
`correlation=4`; the body-order ladder below shows `correlation <= 2`
failing at chance while raising the body order separates the pair.
"""),
            ("code", """
data4 = ds.create_four_body_nonchiral_envs()
fig = plt.figure(figsize=(9, 4))
for i, g in enumerate(data4):
    plot_3d(g, lim=6, ax=fig.add_subplot(1, 2, 1 + i, projection="3d"))
plt.show()
"""),
            ("code", """
for corr in (1, 2, 3):
    acc = train_acc(MACEModel, data4, num_layers=1, emb_dim=8, max_ell=2,
                    correlation=corr, mlp_dim=32, in_dim=1, out_dim=2,
                    pool="sum")
    print(f"MACE correlation={corr}: {acc:5.1f}%")
"""),
            ("md", """
## Four-body chiral counterexample

The reference's final pair is meant to require **chirality** (mirror)
sensitivity.  **Finding** (documented in
`datasets.create_true_chiral_envs` and verified below): the reference's
pair is *not* actually chiral — environment 0 has an internal x-mirror
symmetry, so its y-mirror (environment 1) equals `R_z(pi) @ env0`.  No
rotation-invariant model can separate the pair; the notebook protocol can
only be "passed" by rotation-NON-invariant memorization of the fixed
inputs.
"""),
            ("code", """
env0, env1 = ds.create_four_body_chiral_envs()
fig = plt.figure(figsize=(9, 4))
for i, g in enumerate((env0, env1)):
    plot_3d(g, lim=6, ax=fig.add_subplot(1, 2, 1 + i, projection="3d"))
plt.show()
Rz = np.diag([-1.0, -1.0, 1.0])          # rotation by pi about z
perm = [0, 3, 2, 1, 4]                   # nodes 1 and 3 swap
print("max |R_z(pi) @ env0 - env1| =",
      np.abs((env0.pos @ Rz.T)[perm] - env1.pos).max(),
      "-> the 'chiral' pair is rotation-equivalent")
"""),
            ("code", """
data_ch = [env0, env1]
acc_eq = train_acc(MACEModel, data_ch, num_layers=1, emb_dim=8, max_ell=2,
                   correlation=3, mlp_dim=32, in_dim=1, out_dim=2, pool="sum",
                   equivariant_pred=True)
acc_inv = train_acc(MACEModel, data_ch, num_layers=1, emb_dim=8, max_ell=2,
                    correlation=3, mlp_dim=32, in_dim=1, out_dim=2, pool="sum",
                    hidden_irreps="8x0e+8x0o+8x1o+8x2e")
print(f"equivariant (rotation-NON-invariant) readout: {acc_eq:5.1f}%"
      "  <- memorizes the fixed pair (the reference notebook's outcome)")
print(f"invariant scalar readout (both parities):     {acc_inv:5.1f}%"
      "  <- rotation-equivalent pair is inseparable, as it must be")
"""),
            ("md", """
## The fix: genuine chirality needs both parities

On a **truly** chiral pair (`datasets.create_true_chiral_envs` — mirror
images that are NOT rotation-equivalent), chirality detection lives in the
**pseudoscalar (0o)** channels: rotation-invariant, sign-flipping under
mirror.  A both-parity 2-layer MACE exposes them; single-parity hidden
irreps are provably blind.  (Two layers are required: the symmetric
contraction powers the SAME channel vector, so `eps(x,x,x)=0` kills
layer-1 pseudoscalars.)  The second layer's product output is read with a
forward hook on `model.prods[1]`.
"""),
            ("code", """
from geometric_message_passing_tpu_torch.models.pooling import global_add_pool

@torch.no_grad()
def pooled_prod1(hidden, graphs):
    loader = GraphLoader(graphs, batch_size=2, y_dtype=np.int32)
    b = next(iter(loader)).to(DEVICE)
    model = MACEModel(num_layers=2, emb_dim=8, max_ell=2, correlation=3,
                      mlp_dim=32, in_dim=1, out_dim=2, pool="sum",
                      equivariant_pred=True, hidden_irreps=hidden,
                      generator=seed_everything(1), device=DEVICE)
    seen = []
    hook = model.prods[1].register_forward_hook(
        lambda module, args, out: seen.append(out))
    model(b)
    hook.remove()
    return global_add_pool(seen[0], b).cpu().numpy()[:2]

true_pair = ds.create_true_chiral_envs()
both = pooled_prod1("8x0e+8x0o+8x1e+8x1o+8x2e+8x2o", true_pair)
o = both[:, 8:16]                       # the pooled 0o block
print("pseudoscalar channels, env0 vs mirror env1:")
print("  max |0o|          =", np.abs(o).max().round(5), " (nonzero)")
print("  max |o0 + o1|     =", np.abs(o[0] + o[1]).max().round(7),
      " (exact sign flip)")
single = pooled_prod1(None, true_pair)  # default single-parity irreps
print("single-parity scalars, env0 vs env1: max diff =",
      np.abs(single[0, :8] - single[1, :8]).max(), " (blind)")
"""),
            ("md", """
## Summary

| environment | incomplete descriptor | fails | separates |
|---|---|---|---|
| two_body | distances | SchNet | EGNN (directions) |
| three_body | distances+angles | MACE corr=1 | MACE corr=3 |
| four_body_nonchiral | low-body-order scalars | MACE corr<=2 | MACE corr=3 |
| four_body_chiral | (rotation-equivalent pair) | every invariant model | only non-invariant memorization |
| true chiral pair | single-parity irreps | 0e-only channels | both-parity 0o pseudoscalars |

The same table as the JAX package's `tests/test_incompleteness.py`.
"""),
        ],
        # --------------------------------------------------------------
        "star_graph_pair_angle.ipynb": [
            ("md", """
# Star-graph angle regression (the fork's experiment)

Re-creation of the reference's `star_graph_pair_angle.ipynb` on the
PyTorch port: random star graphs whose regression target is the angle
between labeled spoke pairs — the data behind
`experiments/graph_angle_prediction.py` and the `exp_history.json`
ledger.  The two generator families below are seed-protocol-compatible
re-implementations of the reference's
`create_paired_star_graphs_with_two_centers` and
`create_paired_complete_graphs` (same `random.Random` call order as the
JAX package, held to it by `tests/test_torch_paired_datasets.py`).
"""),
            ("code", header),
            ("code", """
dataset = ds.create_paired_star_graphs_with_two_centers(
    num=5, fold=[5], dim=3, n_pairs=1)
fig = plt.figure(figsize=(13, 4))
for i, g in enumerate(dataset[:3]):
    plot_3d(g, lim=1, ax=fig.add_subplot(1, 3, 1 + i, projection="3d"))
plt.show()
print("targets (angle at center 1, angle at center 2):")
for g in dataset:
    print(" ", np.round(g.y, 4))
"""),
            ("code", """
dataset_c = ds.create_paired_complete_graphs(num=5, n_nodes=[7], dim=3,
                                             n_pairs=2)
fig = plt.figure(figsize=(13, 4))
for i, g in enumerate(dataset_c[:3]):
    plot_3d(g, lim=1, ax=fig.add_subplot(1, 3, 1 + i, projection="3d"))
plt.show()
print("targets (one angle per labeled pair):")
for g in dataset_c:
    print(" ", np.round(g.y, 4))
"""),
            ("md", """
### Multi-target masking

The reference's scratch cells probe `y.view(-1, 2)[::2]` — training on a
masked slice of the per-graph target vector.  The harness formalizes that
as `loss_mask` (`experiments/train.py::fit_regression`): the loss is
restricted to the first k target columns while metrics report all.  Below:
the batch target layout those cells index into.
"""),
            ("code", """
from geometric_message_passing_tpu_torch.graph import GraphLoader
loader = GraphLoader(dataset_c, batch_size=5)
b = next(iter(loader))
print("batched y [G, n_targets]:\\n", np.asarray(b.y).round(4))
print("masked slice (first column only, the view(-1,2)[::2] analog):")
print(np.asarray(b.y)[:, :1].round(4))
"""),
            ("md", """
### The production harness

A short EGNN run on `star` through the SAME experiment harness the CLI
uses (the data resident on the device, best-val-checkpointed test
metric).  The entry point with every reference flag is
`python -m geometric_message_passing_tpu_torch.experiments.cli --model
mace --dataset paired_star ...`; the card's accuracy numbers are in the
port's `PERF.md`.
"""),
            ("code", """
import tempfile
from geometric_message_passing_tpu_torch.experiments import cli
HISTORY = os.path.join(tempfile.gettempdir(), "nb_history.json")
mean = cli.main(["--model", "egnn", "--dataset", "star", "--pool", "first",
                 "--n_layers", "2", "--n_epochs", "60", "--n_data", "300",
                 "--lr", "5e-4", "--fold", "5", "6", "7", "--cosine",
                 "--n_times", "2", "--results_file", HISTORY], device=DEVICE)
print(f"mean test MAE over repeats: {mean:.4f}")
"""),
            ("md", """
Each run appends a full flags+metrics record to the results ledger
(reference `exp_history.json` schema) — the comparison record the
accuracy tables are built from.
"""),
            ("code", """
import json
rec = json.load(open(HISTORY))[-1]
print("ledger record keys:", sorted(rec)[:12], "...")
print({k: rec[k] for k in ("model", "dataset", "n_layers", "best_val_acc",
                           "test_acc") if k in rec})
"""),
        ],
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--only", default=None)
    ap.add_argument("--execute", action="store_true")
    ap.add_argument("--out_dir", default=NOTEBOOK_DIR)
    args = ap.parse_args(argv)
    written = []
    for fname, nb_cells in notebooks(args.device).items():
        if args.only and args.only not in fname:
            continue
        out = os.path.join(args.out_dir, fname)
        write(nb_cells, out, args.execute)
        written.append(out)
    return written


if __name__ == "__main__":
    main()
