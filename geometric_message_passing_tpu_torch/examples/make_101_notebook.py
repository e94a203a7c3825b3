"""Write the geometric-GNN-101 teaching notebook for the port (the twin of
``scripts/make_101_notebook.py``): the same Parts 0-5 — data, batching,
the MPNN formalism, MPNN -> CoordMPNN -> InvariantMPNN -> FinalMPNN, the
three symmetry unit tests (CoordMPNN's designed rotation failure
included), training curves, sample efficiency and dense vs sparse graphs.

The code cells import the port (``models/gnn101.py``,
``examples/gnn101.py``, ``examples/qm9_pipeline.py``) and display their
source where the reference notebook has exercise cells, so the notebook
cannot drift from the tested code (``tests/test_torch_gnn101.py``,
``tests/test_torch_teaching.py``).  One ``DEVICE`` line in the header cell
says where it runs.

    python -m geometric_message_passing_tpu_torch.examples.make_101_notebook \\
        [--device cuda|cpu] [--execute]

writes ``examples/notebooks/geometric_gnn_101.ipynb`` beside this file
(``--execute`` runs it first, with ``nbclient``).  ``nbformat`` and
``nbclient`` are imported only here, in ``write``.
"""

from __future__ import annotations

import argparse
import os

HERE = os.path.dirname(os.path.abspath(__file__))
NOTEBOOK_DIR = os.path.join(HERE, "notebooks")

HEADER = """
import os, sys, inspect
sys.path.insert(0, os.path.abspath(os.path.join("..", "..", "..")))  # the repo
DEVICE = "{device}"   # "cuda": the H100 and its kernels; "cpu": plain PyTorch

import numpy as np
import torch
import matplotlib.pyplot as plt
torch.backends.cuda.matmul.allow_tf32 = False   # the port computes exact f32
print("device:", DEVICE,
      torch.cuda.get_device_name(0) if DEVICE == "cuda" else "")
"""


def cells(device: str = "cuda") -> list:
    """The notebook as ``(kind, source)`` pairs, ``kind`` "md" or "code"."""
    return [
        # ------------------------------------------------------------- title
        ("md", """
# A Gentle Introduction to Geometric Graph Neural Networks — PyTorch/CUDA edition

A runnable re-creation of the reference teaching notebook
(`geometric_gnn_101.ipynb` in NW-JEFF/Geometric-Message-Passing) on the
PyTorch port in this repo, which trains on an NVIDIA H100 with hand-written
CUDA kernels.  Same storyline, same exercises, same unit tests:

* **Part 0** — molecular property prediction, geometric graphs, batching,
  and the vanilla Message Passing Neural Network.
* **Part 1** — naive use of 3-D coordinates (`CoordMPNNModel`).
* **Part 2** — what invariance to rotations/translations *means*, and a unit
  test that catches models which lack it.
* **Part 3** — invariant message passing with distances (`InvariantMPNNModel`).
* **Part 4** — equivariant message passing (`FinalMPNNModel`, EGNN-style).
* **Part 5** — wrap-up: sample efficiency and dense vs. sparse graphs.

Where the reference has "`# ============ YOUR CODE HERE`" exercise blanks,
this edition *displays the canonical solution source* from the tested
package (`geometric_message_passing_tpu_torch/models/gnn101.py`), so the
notebook cannot drift from the test suite (`tests/test_torch_gnn101.py`).
"""),
        # ------------------------------------------------------ Part 0: setup
        ("md", """
# ⚙️ Part 0: Installation and Setup

No installation needed here — `torch`, `matplotlib` and this package are
already available.  The reference's PyTorch Geometric / RDKit stack is
replaced by the package's own pieces: `GraphBatch` (padded batching),
`transforms.complete_graph` (the `CompleteGraph` transform) and a synthetic
QM9 stand-in (`examples/qm9_pipeline.py` — swap in a real QM9 loader for
the full dataset).  `DEVICE` below picks the card (`"cuda"`) or the CPU,
where every kernel runs its plain PyTorch version.
"""),
        ("code", HEADER.format(device=device)),
        ("code", """
# Set random seed for deterministic results
from geometric_message_passing_tpu_torch.experiments.train import seed_everything
generator = seed_everything(0)
"""),
        # ------------------------------------- Part 0: molecular data intro
        ("md", """
# 🧪 Part 0: Introduction to Molecular Property Prediction

Molecules are **geometric graphs**: atoms are nodes with categorical
features (the atom type) *and* 3-D coordinates; edges carry bond or
proximity structure.  The prediction target (e.g. dipole moment, atomization
energy in QM9) is a property of the whole molecule — a *graph-level*
regression.

## Data Preparation and Splitting
"""),
        ("code", """
from geometric_message_passing_tpu_torch.examples.qm9_pipeline import make_molecules
from geometric_message_passing_tpu_torch.transforms import complete_graph, set_target

raw = make_molecules(400, seed=0)
# CompleteGraph: connect every atom pair (the reference's QM9 transform);
# SetTarget: select one of the target columns as g.y
dataset = [set_target(complete_graph(g), 0) for g in raw]
print(f"Total number of samples: {len(dataset)}.")
"""),
        ("code", """
from geometric_message_passing_tpu_torch.graph import GraphLoader, random_split

train_set, val_set, test_set = random_split(dataset, [0.8, 0.1, 0.1], seed=0)
print(f"Created dataset splits with {len(train_set)} training, "
      f"{len(val_set)} validation, {len(test_set)} test samples.")
"""),
        ("md", """
## Visualising Molecular Graphs

The reference renders molecules with RDKit; here we use the package's
matplotlib helpers — node colors are atom types, edges the (complete)
connectivity.
"""),
        ("code", """
%matplotlib inline
from geometric_message_passing_tpu_torch.utils.plot import plot_2d, plot_3d

fig = plt.figure(figsize=(10, 3))
for k in range(3):
    ax = fig.add_subplot(1, 3, k + 1, projection="3d")
    plot_3d(train_set[k], lim=2.5, ax=ax)
    ax.set_title(f"molecule {k}: {train_set[k].num_nodes} atoms")
plt.tight_layout()
"""),
        ("md", """
## Understanding the data objects

Each sample is a `Graph` — the host-side analog of a PyG `Data` object:
`atoms` (atom types), `edge_index` `[2, E]`, `pos` `[n, 3]`, and the
target `y`.
"""),
        ("code", """
data = train_set[0]     # one data sample, i.e. molecular graph
print(data)
print(f"This molecule has {data.num_nodes} atoms and {data.num_edges} "
      f"(directed, complete-graph) edges.")
print("atom types:", np.asarray(data.atoms))
print("y:", np.asarray(data.y))
"""),
        ("md", """
## Batching into padded buckets

PyG batches graphs into one big block-diagonal graph of whatever size the
batch has.  This package pads every batch to one bucket (`GraphBatch`):
the graphs sit block-diagonally at the front, pad nodes and edges at the
end carry a mask and contribute nothing to message passing, reductions or
losses.  One set of shapes then serves every batch.  (BatchNorm's batch
statistics are taken over every row, pad rows included, exactly as the JAX
reference package does.)
"""),
        ("code", """
loader = GraphLoader(train_set, batch_size=32, shuffle=True, seed=0)
batch = next(iter(loader)).to(DEVICE)
print("padded nodes:", tuple(batch.atoms.shape), " real:", int(batch.node_mask.sum()))
print("padded edges:", tuple(batch.senders.shape), " real:", int(batch.edge_mask.sum()))
print("graphs:      ", tuple(batch.y.shape),     " real:", int(batch.graph_mask.sum()))
"""),
        ("md", """
Great!  We have prepared the dataset, visualised some samples, understood
the data objects and how they are batched into padded buckets.
"""),
        # --------------------------------------- Part 0: MPNN formalism
        ("md", """
# 📩 Part 0: Introduction to Message Passing Neural Networks

## Formalism

One message-passing layer updates node features $h_i$ by aggregating
messages from neighbors $j \\in \\mathcal{N}(i)$:

$$ m_{ij} = \\psi\\big(h_i,\\ h_j,\\ e_{ij}\\big), \\qquad
   m_i = \\bigoplus_{j \\in \\mathcal{N}(i)} m_{ij}, \\qquad
   h_i' = \\phi\\big(h_i,\\ m_i\\big) $$

with $\\psi, \\phi$ MLPs and $\\bigoplus$ a permutation-invariant
aggregator (sum here).  A *model* stacks layers (with residuals), pools
node features into a graph embedding, and applies a linear readout.

## Coding the basic Message Passing layer

The reference's exercise cell 25 asks you to implement this with PyG's
`MessagePassing` base class.  The canonical solution here is
`MPNN101Layer`: gather → message MLP → masked segment sum → update MLP.
"""),
        ("code", """
from geometric_message_passing_tpu_torch.models.gnn101 import (
    MPNN101Layer, InvariantMPNNLayer, CoordMPNNModel, InvariantMPNNModel,
    FinalMPNNModel)
from geometric_message_passing_tpu_torch.models.egnn import MPNNModel

print(inspect.getsource(MPNN101Layer))
"""),
        ("md", """
Instead of PyG's `propagate()` machinery, the layer is three tensor ops:
`h[senders]`/`h[receivers]` **gathers** replace message indexing, a masked
**`segment_sum`** replaces scatter-aggregation (pad edges are masked out),
and the update MLP consumes the concatenation.  On the card each
`segment_sum` is one launch of the port's hand-written CUDA kernel
(`csrc/sorted_segsum.cu`), which adds every segment's rows in a fixed
order, so two runs give bitwise-equal sums.
"""),
        ("code", """
# The full MPNN model: embedding -> num_layers x (residual MPNN layer)
# -> global pool -> readout
model = MPNNModel(num_layers=4, emb_dim=64, in_dim=5, out_dim=1, device=DEVICE)
n_params = sum(p.numel() for p in model.parameters())
print(f"MPNNModel: {n_params:,} parameters")
print("output shape:", tuple(model.eval()(batch).shape), "(one scalar per graph)")
"""),
        # --------------------------- Part 0: permutation unit test (cell 29)
        ("md", """
## Unit test 1: permutation invariance and equivariance (reference cell 29)

Graph nets must not care about node *ordering*: the **model** output must be
unchanged (invariant) under a permutation of the nodes, and a **layer**'s
node features must permute along (equivariant).  `transforms.permute_graph`
applies a permutation to a graph; the test runs the model on both and
compares.
"""),
        ("code", """
from geometric_message_passing_tpu_torch.examples import gnn101 as nb

print(inspect.getsource(nb.permutation_invariance_unit_test))
g0 = train_set[0]
print("MPNNModel permutation invariant:",
      nb.permutation_invariance_unit_test(
          MPNNModel(num_layers=2, emb_dim=32, in_dim=5, device=DEVICE), g0))
"""),
        # ----------------------------- Part 0: training helpers + MPNN run
        ("md", """
## Training and evaluating models

The reference trains with MSE on standardized targets and reports the
de-normalized MAE (`MAE × std`).  The helper below records the validation
curve per epoch so Part 5 can compare models.  Each model's weights come
from `nb.build(name, seed=0)` (`seed_everything(0)`), the shuffle from
`train_model(seed=0)`.
"""),
        ("code", """
splits = nb.notebook_splits(dataset)
MEAN, STD = splits.mean, splits.std
RESULTS = {}          # name -> dict(val_curve=[...], test_mae=float)
print(inspect.getsource(nb.evaluate))
print(inspect.getsource(nb.train_model))
"""),
        ("code", """
_ = nb.train_model(nb.build("MPNN", device=DEVICE), "MPNN", splits=splits,
                   results=RESULTS)
"""),
        ("code", """
plt.plot(RESULTS["MPNN"]["val_curve"], label="MPNN")
plt.xlabel("Epoch"); plt.ylabel("Val MAE"); plt.legend(); plt.title("Validation MAE")
plt.show()
"""),
        ("md", """
Super!  Everything up to this point is the standard (geometry-free) GNN
pipeline.  Now for the core question of this practical: **how should a GNN
use 3-D coordinates?**
"""),
        # ---------------------------------------------------------- Part 1
        ("md", """
# 🧊 Part 1: Geometric Graphs and Message Passing with 3D Coordinates

Our molecules have `pos` — each atom's 3-D coordinates.  The vanilla MPNN
ignores them entirely.

## 💻 Task 1.1: an MPNN that incorporates atom coordinates

The reference's exercise (cell 42): *concatenate the raw coordinates into
the initial node features*.  Canonical solution — `CoordMPNNModel`:
"""),
        ("code", """
print(inspect.getsource(CoordMPNNModel))
"""),
        ("md", """
## 💻 Task 1.2-1.3: which symmetry tests does `CoordMPNNModel` pass?

It must still be **permutation invariant** (coordinates permute with their
nodes).  Whether it respects *rotations* is Part 2's question…
"""),
        ("code", """
print("CoordMPNN permutation invariant:",
      nb.permutation_invariance_unit_test(
          CoordMPNNModel(num_layers=2, emb_dim=32, in_dim=5, device=DEVICE), g0))
"""),
        ("md", """
## 💻 Task 1.4: train and evaluate `CoordMPNNModel`
"""),
        ("code", """
_ = nb.train_model(nb.build("CoordMPNN", device=DEVICE), "CoordMPNN",
                   splits=splits, results=RESULTS)
"""),
        ("code", """
for name in ["MPNN", "CoordMPNN"]:
    plt.plot(RESULTS[name]["val_curve"], label=name)
plt.xlabel("Epoch"); plt.ylabel("Val MAE"); plt.legend(); plt.title("Validation MAE")
plt.show()
"""),
        ("md", """
Hmm… if implemented correctly you may see a *curious result*: raw
coordinates can help on a fixed frame (the target here is built from
pairwise geometry), but the model has learned something that is **not a
property of the molecule** — rotate the molecule and the prediction
changes.  Let's prove that.
"""),
        # ---------------------------------------------------------- Part 2
        ("md", """
# 🔄 Part 2: Invariance to 3D Symmetries: Rotation and Translation

## 💻 Task 2.1-2.2: what *should* hold?

A molecular property does not depend on the arbitrary coordinate frame: for
any rotation $R$ and translation $t$,

$$ f\\big(\\{R x_i + t\\}, \\{h_i\\}\\big) = f\\big(\\{x_i\\}, \\{h_i\\}\\big)
\\quad \\text{(model: invariance)} $$

while a *layer* that outputs geometric quantities (e.g. updated positions)
should be **equivariant**: its geometric outputs must transform with the
frame, $\\mathbf{F}(R x + t) = R\\,\\mathbf{F}(x) + t$.

## 💻 Task 2.3: the rotation/translation unit test (reference cell 56)
"""),
        ("code", """
print(inspect.getsource(nb.rot_trans_invariance_unit_test))
for name, m in [("MPNN", MPNNModel(num_layers=2, emb_dim=32, in_dim=5, device=DEVICE)),
                ("CoordMPNN", CoordMPNNModel(num_layers=2, emb_dim=32, in_dim=5,
                                             device=DEVICE))]:
    ok = nb.rot_trans_invariance_unit_test(m, g0)
    print(f"{name:>14}: rotation/translation invariance "
          f"{'PASS' if ok else 'FAIL'}")
"""),
        ("md", """
`CoordMPNN` **fails** — by design.  That failure (asserted in
`tests/test_torch_gnn101.py`, as in the JAX package's
`tests/test_gnn101.py`) is the lesson of this practical: naive coordinate
features break the physics.  Parts 3 and 4 fix it in the two principled
ways.
"""),
        # ---------------------------------------------------------- Part 3
        ("md", """
# ✈️ Part 3: Message Passing with Invariance to 3D Rotations and Translations

## 💻 Task 3.1: an invariant message passing layer

Condition messages only on quantities that are *unchanged* by rotations and
translations — the simplest being the **pairwise distance**
$\\lVert x_i - x_j \\rVert$.  Canonical solution (reference cell 62) —
`InvariantMPNNLayer`:
"""),
        ("code", """
print(inspect.getsource(InvariantMPNNLayer))
"""),
        ("code", """
m = InvariantMPNNModel(num_layers=2, emb_dim=32, in_dim=5, device=DEVICE)
print("permutation invariant:      ", nb.permutation_invariance_unit_test(m, g0))
print("rotation/translation inv.:  ", nb.rot_trans_invariance_unit_test(m, g0))
"""),
        ("code", """
_ = nb.train_model(nb.build("InvariantMPNN", device=DEVICE), "InvariantMPNN",
                   splits=splits, results=RESULTS)
"""),
        ("code", """
for name in ["MPNN", "CoordMPNN", "InvariantMPNN"]:
    plt.plot(RESULTS[name]["val_curve"], label=name)
plt.xlabel("Epoch"); plt.ylabel("Val MAE"); plt.legend(); plt.title("Validation MAE")
plt.show()
"""),
        ("md", """
You have now gone from a vanilla `MPNNModel`, to a naive use of coordinates,
to a geometrically principled **invariant** model.  One step further:
keep the *directional* information without breaking symmetry.
"""),
        # ---------------------------------------------------------- Part 4
        ("md", """
# 🚀 Part 4: Message Passing with Equivariance to 3D Rotations and Translations

## 💻 Task 4.1-4.2: an equivariant message passing layer

Invariant models throw away directions.  An **equivariant** layer keeps a
geometric channel: it updates positions with relative-vector messages

$$ x_i' = x_i + \\frac{1}{|\\mathcal{N}(i)|} \\sum_{j}
   (x_i - x_j)\\,\\phi_x(m_{ij}) $$

so positions transform *with* the frame, while $h$ stays invariant — the
EGNN recipe.  Canonical solution (reference cell 78) —
`EquivariantMPNNLayer`:
"""),
        ("code", """
from geometric_message_passing_tpu_torch.models.gnn101 import EquivariantMPNNLayer
print(inspect.getsource(EquivariantMPNNLayer))
"""),
        ("md", """
## Unit test 3: layer equivariance (reference cell 81)

The layer's updated positions must rotate with the input; its features must
not change.
"""),
        ("code", """
print(inspect.getsource(nb.rot_trans_equivariance_unit_test))
fi, pe = nb.rot_trans_equivariance_unit_test(g0, device=DEVICE)
print(f"EquivariantMPNNLayer: feature invariance {'PASS' if fi else 'FAIL'}, "
      f"position equivariance {'PASS' if pe else 'FAIL'}")
"""),
        ("code", """
_ = nb.train_model(nb.build("FinalMPNN", device=DEVICE), "FinalMPNN",
                   splits=splits, results=RESULTS)
"""),
        ("code", """
for name in RESULTS:
    plt.plot(RESULTS[name]["val_curve"], label=name)
plt.xlabel("Epoch"); plt.ylabel("Val MAE"); plt.legend(); plt.title("Validation MAE")
plt.show()
"""),
        ("md", """
Congratulations!  You have gone from a vanilla `MPNNModel` all the way to a
rotation-**equivariant** model — the design axis along which the whole
model zoo in this repo (SchNet → DimeNet → SphereNet → EGNN → GVP → TFN →
MACE) varies.
"""),
        # ---------------------------------------------------------- Part 5
        ("md", """
# 🌯 Part 5: Wrapping up

### Sample efficiency

## 💻 Task 5.1: study the models' validation curves

Which inductive bias buys the most per epoch?  (One run per model: the
final test MAE of this protocol moves a lot from seed to seed, see the
port's `PERF.md`.)
"""),
        ("code", """
fig, axes = plt.subplots(1, 2, figsize=(11, 4))
for name in RESULTS:
    axes[0].plot(RESULTS[name]["val_curve"], label=name)
axes[0].set_xlabel("Epoch"); axes[0].set_ylabel("Val MAE"); axes[0].legend()
axes[0].set_title("Validation MAE per epoch")
names = list(RESULTS)
axes[1].bar(names, [RESULTS[n]["test_mae"] for n in names])
axes[1].set_ylabel("Test MAE"); axes[1].set_title("Final test MAE")
plt.setp(axes[1].get_xticklabels(), rotation=20)
plt.tight_layout(); plt.show()
"""),
        ("md", """
Typical outcome (matching the reference's narrative): the geometry-aware
models beat the blind MPNN; the invariant/equivariant models additionally
keep that advantage under *any* pose of the test molecules, which
`CoordMPNN` does not.

### Dense vs. Sparse Graphs

## 💻 Task 5.2: compare models on complete vs. radius-sparsified graphs

The complete-graph transform lets one layer see every atom pair (distance
information is complete) at $O(n^2)$ edges.  Real pipelines sparsify with a
radius cutoff — cheaper, but distance information beyond the cutoff must
now travel multiple hops.
"""),
        ("code", """
print(inspect.getsource(nb.radius_sparsify))
sparse_dataset = [nb.radius_sparsify(g) for g in dataset]
sparse = nb.notebook_splits(sparse_dataset)

e_dense = np.mean([g.num_edges for g in dataset])
e_sparse = np.mean([g.num_edges for g in sparse_dataset])
print(f"mean edges per molecule: complete {e_dense:.1f} vs sparse {e_sparse:.1f}")
"""),
        ("code", """
sparse_results = {}
for name in nb.SPARSE_MODELS:
    print("[sparse] ", end="")
    nb.train_model(nb.build(name, device=DEVICE), name, n_epochs=25,
                   splits=sparse, results=sparse_results)
"""),
        ("code", """
print(f"{'model':>14} | {'complete (test MAE)':>20} | {'sparse (test MAE)':>18}")
print("-" * 60)
for name in sparse_results:
    dense_mae = RESULTS[name]["test_mae"]
    print(f"{name:>14} | {dense_mae:>20.4f} | {sparse_results[name]['test_mae']:>18.4f}")
"""),
        ("md", """
Observations to take away (the reference's closing discussion):

* **Distance-aware models degrade gracefully** under sparsification — the
  geometry they rely on is local, and deeper stacks recover longer-range
  structure hop by hop.
* **The blind MPNN loses its connectivity crutch**: on complete graphs the
  aggregation itself leaks the molecule's size/shape; on sparse graphs it
  has less to work with.
* At production scale, sparse radius graphs are the only option — the
  port's molecular-box benchmark
  (`python -m geometric_message_passing_tpu_torch.experiments.bench_scale`)
  runs 100k-atom radius graphs through the same batching machinery.
"""),
        ("md", """
## Where to next

* **Expressivity experiments** — `kchains.ipynb`, `rotsym.ipynb`,
  `incompleteness.ipynb`, `star_graph_pair_angle.ipynb` in this folder
  (the reference's other notebooks, on the port).
* **The full model zoo** — SchNet, DimeNet++, SphereNet, EGNN, GVP-GNN,
  TFN, MACE: `geometric_message_passing_tpu_torch/models/`.
* **Angle-prediction CLI** —
  `python -m geometric_message_passing_tpu_torch.experiments.cli ...`
* **The same path from a script** —
  `python -m geometric_message_passing_tpu_torch.examples.gnn101` and
  `python -m geometric_message_passing_tpu_torch.examples.qm9_pipeline`.
"""),
    ]


def write(notebook_cells: list, out: str, execute: bool = False) -> None:
    """Write ``notebook_cells`` (``(kind, source)`` pairs) as a notebook at
    ``out``, run first with ``nbclient`` when ``execute``."""
    import nbformat as nbf

    nb = nbf.v4.new_notebook()
    nb.metadata.kernelspec = {
        "display_name": "Python 3", "language": "python", "name": "python3"}
    nb.cells = [(nbf.v4.new_markdown_cell if kind == "md"
                 else nbf.v4.new_code_cell)(src.strip())
                for kind, src in notebook_cells]
    if execute:
        from nbclient import NotebookClient

        NotebookClient(nb, timeout=2400, resources={
            "metadata": {"path": os.path.dirname(os.path.abspath(out))}}
        ).execute()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        nbf.write(nb, f)
    print("wrote", out, f"({len(nb.cells)} cells, executed={execute})")


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--execute", action="store_true")
    ap.add_argument("--out", default=os.path.join(NOTEBOOK_DIR,
                                                  "geometric_gnn_101.ipynb"))
    args = ap.parse_args(argv)
    write(cells(args.device), args.out, args.execute)
    return args.out


if __name__ == "__main__":
    main()
