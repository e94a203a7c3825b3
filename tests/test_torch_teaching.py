"""The teaching path of the port against the JAX package's: the QM9-style
molecules bit for bit, one step of the QM9 pipeline with the weights carried
across, the 101 notebook's ``train_model`` for each model, and the generated
notebooks (their code cells compile and import nothing of JAX).

Run as a script, the file gives the JAX notebook's spread (the bound of
``chip_smoke.py`` phase 8b comes from it): ``train_model`` of the 101
notebook (``scripts/make_101_notebook.py:268-298``) for FinalMPNN at 4 x 64,
400 molecules, 40 epochs, lr 5e-3, batch 32, repeats 0-2 (repeat ``s``:
``PRNGKey(s)`` and shuffle seed ``s``), on the CPU:

    JAX_PLATFORMS=cpu python tests/test_torch_teaching.py --repeats 3 [--first 0]
"""

import ast
import functools
import importlib.util
import json
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


@functools.lru_cache(maxsize=None)
def _jax_qm9():
    """The JAX package's ``examples/qm9_pipeline.py`` (a script, not a
    package module), loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "jax_qm9_pipeline", ROOT / "examples" / "qm9_pipeline.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_notebook_splits(num: int = 400, seed: int = 0, radius=None):
    """The JAX notebook's data: ``make_molecules(num, seed)``, complete
    graphs (or radius graphs at ``radius``) with target 0, the 80/10/10
    split and the train targets' mean and std."""
    make_molecules = _jax_qm9().make_molecules

    from geometric_message_passing_tpu.graph import Graph, random_split
    from geometric_message_passing_tpu.ops.radius_graph import radius_graph
    from geometric_message_passing_tpu.transforms import (complete_graph,
                                                          set_target)

    data = [set_target(complete_graph(g), 0) for g in make_molecules(num, seed)]
    if radius is not None:
        data = [Graph(g.atoms, radius_graph(np.asarray(g.pos), r=radius)
                      .astype(np.int32), g.pos, g.y) for g in data]
    tr, va, te = random_split(data, [0.8, 0.1, 0.1], seed=0)
    ys = np.concatenate([np.atleast_1d(np.asarray(g.y, np.float32))
                         for g in tr])
    return tr, va, te, float(ys.mean()), float(ys.std() + 1e-8)


def jax_train_model(model, splits, n_epochs: int = 40, lr: float = 5e-3,
                    seed: int = 0, batch_size: int = 32):
    """The JAX notebook's ``train_model`` (MSE on standardised targets,
    Adam, the de-normalised MAE), with ``PRNGKey(seed)`` and shuffle seed
    ``seed``; returns ``(val_curve, test_mae, variables)``."""
    import jax.numpy as jnp
    import optax

    from geometric_message_passing_tpu.graph import GraphLoader

    train_set, val_set, test_set, mean, std = splits
    tr = GraphLoader(train_set, batch_size=batch_size, shuffle=True, seed=seed)
    va = GraphLoader(val_set, batch_size=batch_size)
    te = GraphLoader(test_set, batch_size=batch_size)
    variables = model.init(jax.random.PRNGKey(seed), next(iter(tr)))
    tx = optax.adam(lr)
    opt = tx.init(variables["params"])

    @jax.jit
    def step(variables, opt, b):
        def loss_fn(params):
            out, mut = model.apply({**variables, "params": params}, b,
                                   train=True, mutable=["batch_stats"])
            y = (b.y - mean) / std
            err = (out - y) ** 2 * b.graph_mask[:, None]
            return err.sum() / jnp.maximum(b.graph_mask.sum(), 1), mut
        (loss, mut), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
        upd, opt = tx.update(grads, opt, variables["params"])
        return ({**variables,
                 "params": optax.apply_updates(variables["params"], upd),
                 **mut}, opt, loss)

    def evaluate(loader):
        tot, cnt = 0.0, 0
        for b in loader:
            out = model.apply(variables, b) * std + mean
            tot += float((jnp.abs(out - b.y) * b.graph_mask[:, None]).sum())
            cnt += int(b.graph_mask.sum())
        return tot / max(cnt, 1)

    curve = []
    for _ in range(n_epochs):
        for b in tr:
            variables, opt, _ = step(variables, opt, b)
        curve.append(evaluate(va))
    return curve, evaluate(te), variables


def _spread_main(argv=None) -> dict:
    import argparse

    jax.config.update("jax_platforms", "cpu")
    from geometric_message_passing_tpu.models.gnn101 import (
        FinalMPNNModel, InvariantMPNNModel)

    p = argparse.ArgumentParser(description="the JAX 101 notebook's spread")
    p.add_argument("--model", choices=("final_mpnn", "invariant_mpnn"),
                   default="final_mpnn")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--first", type=int, default=0,
                   help="seed of the first repeat")
    p.add_argument("--epochs", type=int, default=40)
    args = p.parse_args(argv)
    cls = {"final_mpnn": FinalMPNNModel,
           "invariant_mpnn": InvariantMPNNModel}[args.model]
    splits = jax_notebook_splits()
    maes, seconds = [], []
    for s in range(args.first, args.first + args.repeats):
        t = time.perf_counter()
        _, mae, _ = jax_train_model(cls(num_layers=4, emb_dim=64, in_dim=5,
                                        out_dim=1), splits,
                                    n_epochs=args.epochs, seed=s)
        seconds.append(time.perf_counter() - t)
        maes.append(mae)
        print(f"repeat {s}: test MAE {mae:.4f} ({seconds[-1]:.1f} s)",
              flush=True)
    out = {"model": args.model, "epochs": args.epochs,
           "seeds": list(range(args.first, args.first + args.repeats)),
           "test_mae": maes,
           "mean": float(np.mean(maes)), "std": float(np.std(maes)),
           "seconds": seconds, "device": "CPU (JAX package, XLA)"}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _spread_main()


# --------------------------------------------------------------- the tests

def test_make_molecules_is_bit_equal():
    from geometric_message_passing_tpu_torch.examples.qm9_pipeline import (
        make_molecules)

    jax_molecules = _jax_qm9().make_molecules

    for seed in (0, 3):
        want, got = jax_molecules(60, seed), make_molecules(60, seed)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for field in ("atoms", "edge_index", "pos", "y"):
                a, b = np.asarray(getattr(g, field)), np.asarray(getattr(w, field))
                assert a.dtype == b.dtype and np.array_equal(a, b), field


def _egnn_pair(n_data=40):
    """The QM9 pipeline's data and a narrow EGNN on both packages, the JAX
    weights carried to the port (the JAX script's init)."""
    from geometric_message_passing_tpu.experiments.train import (
        init_variables, seed_everything as jseed, tiny_init_batch)
    from geometric_message_passing_tpu.graph import Graph as JGraph
    from geometric_message_passing_tpu.graph import GraphLoader as JLoader
    from geometric_message_passing_tpu.graph import random_split as jsplit
    from geometric_message_passing_tpu.models import model_registry as jreg
    from geometric_message_passing_tpu.transforms import (complete_graph,
                                                          set_target)

    from geometric_message_passing_tpu_torch.examples import qm9_pipeline
    from geometric_message_passing_tpu_torch.graph import GraphLoader, random_split
    from geometric_message_passing_tpu_torch.models import model_registry
    from geometric_message_passing_tpu_torch.weights import egnn_from_jax

    # the JAX script's data steps (examples/qm9_pipeline.py:70-79)
    jdata = [set_target(complete_graph(g), 0)
             for g in _jax_qm9().make_molecules(n_data)]
    ys = np.array([float(np.asarray(g.y)[0]) for g in jdata])
    mean, std = float(ys.mean()), float(ys.std() + 1e-12)
    jdata = [JGraph(g.atoms, g.edge_index, g.pos,
                    (np.asarray(g.y) - mean) / std) for g in jdata]
    tdata, tmean, tstd = qm9_pipeline.standardised_data(n_data)
    assert (tmean, tstd) == (mean, std)
    for g, w in zip(tdata, jdata):
        assert np.array_equal(g.y, w.y) and np.array_equal(g.edge_index,
                                                           w.edge_index)
    jtr = jsplit(jdata, [0.8, 0.1, 0.1], seed=0)[0]
    ttr = random_split(tdata, [0.8, 0.1, 0.1], seed=0)[0]
    jl = JLoader(jtr, batch_size=8, shuffle=True, seed=0)
    tl = GraphLoader(ttr, batch_size=8, shuffle=True, seed=0)
    kw = dict(num_layers=2, emb_dim=16, in_dim=5, out_dim=1)
    jm = jreg["egnn"](**kw)
    variables = init_variables(jm, jseed(0), tiny_init_batch(jl))
    tm = model_registry["egnn"](**kw, device="cpu")
    tm.load_state_dict(egnn_from_jax(jax.tree.map(np.asarray, variables)),
                       strict=True)
    return jm, variables, next(iter(jl)), tm, next(iter(tl))


def test_qm9_step_matches_jax():
    """One step of the QM9 pipeline (MSE over real graphs, Adam 1e-3) from
    the same weights: loss, every gradient and every updated parameter.
    Gradients within 1e-4 of max(the tensor's largest JAX entry, 1); the
    updated parameters within 1e-5 (Adam's first step moves each entry by
    ~lr whatever its gradient's size, so an entry whose gradient is of
    rounding size on both sides, below 1e-7, is exempt: the rule of
    tests/test_torch_train_options.py)."""
    import jax.numpy as jnp
    import optax
    import torch

    from geometric_message_passing_tpu_torch.examples import qm9_pipeline
    from geometric_message_passing_tpu_torch.experiments.train import make_tx
    from geometric_message_passing_tpu_torch.weights import egnn_from_jax

    jm, variables, jb, tm, tb = _egnn_pair()
    params = variables["params"]
    uv = {k: v for k, v in variables.items() if k != "params"}
    tx = optax.adam(1e-3)

    def loss_fn(p):      # the JAX script's step (qm9_pipeline.py:94-97)
        pred = jm.apply({"params": p, **uv}, jb)[:, 0]
        err = (pred - jb.y[:, 0]) ** 2 * jb.graph_mask
        return jnp.sum(err) / jnp.maximum(jnp.sum(jb.graph_mask), 1)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    upd, _ = tx.update(grads, tx.init(params))
    new = optax.apply_updates(params, upd)

    opt = make_tx(tm.parameters(), lr=1e-3)
    got_loss = qm9_pipeline.mse_loss(tm, tb)
    opt.zero_grad()
    got_loss.backward()
    want_g = egnn_from_jax(jax.tree.map(np.asarray, {"params": grads}))
    small = set()
    for name, p in tm.named_parameters():
        w = want_g[name].numpy()
        # the last layer's position MLP feeds nothing the readout reads:
        # no gradient here, zeros in JAX
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        err = np.abs(g - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1.0), (name, err)
        small |= {(name, i) for i in np.flatnonzero(
            (np.abs(g) < 1e-7) & (np.abs(w) < 1e-7) & (g != w))}
    opt.step()
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), rtol=1e-5)
    want_p = egnn_from_jax(jax.tree.map(np.asarray, {"params": new}))
    for name, p in tm.named_parameters():
        d = np.abs(p.detach().numpy() - want_p[name].numpy()).ravel()
        keep = np.ones(d.shape, bool)
        keep[[i for n, i in small if n == name]] = False
        assert d[keep].max(initial=0) <= 1e-5, name
    with torch.no_grad():
        assert np.isfinite(float(qm9_pipeline.mae_sum(tm, tb)))


def test_qm9_pipeline_main_runs():
    from geometric_message_passing_tpu_torch.examples import qm9_pipeline

    rows = qm9_pipeline.main(["--n_data", "40", "--n_epochs", "1",
                              "--batch_size", "8", "--model", "mpnn",
                              "--device", "cpu"])
    assert [r[0] for r in rows] == [1] and np.isfinite(rows[0][2])


def _small_splits():
    from geometric_message_passing_tpu_torch.examples import gnn101

    return gnn101.notebook_splits(gnn101.notebook_data(40))


@pytest.mark.parametrize("name", ["MPNN", "CoordMPNN", "InvariantMPNN",
                                  "FinalMPNN"])
def test_train_model_runs_one_epoch(name):
    from geometric_message_passing_tpu_torch.examples import gnn101

    model = gnn101.build(name, num_layers=2, emb_dim=16, device="cpu")
    results = {}
    out = gnn101.train_model(model, name, n_epochs=1, splits=_small_splits(),
                             batch_size=8, results=results, verbose=False)
    assert results[name] is out and len(out["val_curve"]) == 1
    assert np.isfinite(out["val_curve"][0]) and np.isfinite(out["test_mae"])


NOTEBOOK_TESTS = {
    **{f"permutation invariant {m}": (m, "perm", True)
       for m in ("MPNN", "CoordMPNN", "InvariantMPNN", "FinalMPNN")},
    **{f"rotation invariant {m}": (m, "rot", m != "CoordMPNN")
       for m in ("MPNN", "CoordMPNN", "InvariantMPNN", "FinalMPNN")},
    "equivariant layer": (None, "equi", True),
}


@pytest.mark.parametrize("case", list(NOTEBOOK_TESTS))
def test_notebook_unit_tests_on_the_port(case):
    """The notebook's three unit tests give the notebook's outcomes:
    CoordMPNN fails the rotation test, the rest pass."""
    from geometric_message_passing_tpu_torch.examples import gnn101

    name, kind, holds = NOTEBOOK_TESTS[case]
    g0 = _small_splits().train[0]
    if kind == "equi":
        assert gnn101.rot_trans_equivariance_unit_test(g0) == (True, True)
        return
    model = gnn101.MODELS[name](num_layers=2, emb_dim=32, in_dim=5,
                                device="cpu")
    test = (gnn101.permutation_invariance_unit_test if kind == "perm"
            else gnn101.rot_trans_invariance_unit_test)
    assert test(model, g0) is holds


def test_radius_sparsify_matches_the_jax_notebook():
    from geometric_message_passing_tpu.ops.radius_graph import radius_graph

    from geometric_message_passing_tpu_torch.examples import gnn101

    for g in gnn101.notebook_data(20):
        want = radius_graph(np.asarray(g.pos), r=1.5).astype(np.int32)
        got = gnn101.radius_sparsify(g).edge_index
        assert got.dtype == np.int32 and np.array_equal(got, want)


def test_notebook_spread_runs_on_the_cpu():
    from geometric_message_passing_tpu_torch.experiments import seed_spread

    maes, times = seed_spread.notebook_spread("final_mpnn", 1, 1, "cpu")
    assert len(maes) == 1 and np.isfinite(maes[0]) and times[0] > 0


def _generated():
    from geometric_message_passing_tpu_torch.examples import (
        make_101_notebook, make_experiment_notebooks)

    out = {"geometric_gnn_101.ipynb": make_101_notebook.cells("cuda")}
    out.update(make_experiment_notebooks.notebooks("cuda"))
    return out


NOTEBOOKS = ["geometric_gnn_101.ipynb", "kchains.ipynb", "rotsym.ipynb",
             "incompleteness.ipynb", "star_graph_pair_angle.ipynb"]
BANNED = ("jax", "jaxlib", "flax", "optax", "geometric_message_passing_tpu")


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_code_compiles_and_imports_no_jax(name):
    """Every code cell compiles (IPython's % lines aside) and imports
    nothing of JAX or the JAX package; the committed notebook is the
    generator's output (``--device cuda``), without outputs."""
    cells = _generated()[name]
    code = [src.strip() for kind, src in cells if kind == "code"]
    assert code
    for i, src in enumerate(code):
        body = "\n".join(line for line in src.splitlines()
                         if not line.lstrip().startswith("%"))
        tree = ast.parse(compile(body, f"{name}[{i}]", "exec",
                                 ast.PyCF_ONLY_AST))
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for mod in mods:
                assert mod.split(".")[0] not in BANNED, (name, i, mod)
    path = (ROOT / "geometric_message_passing_tpu_torch" / "examples"
            / "notebooks" / name)
    nb = json.loads(path.read_text())
    got = [("md" if c["cell_type"] == "markdown" else "code",
            "".join(c["source"])) for c in nb["cells"]]
    assert got == [(k, s.strip()) for k, s in cells]
    assert all(not c.get("outputs") for c in nb["cells"]
               if c["cell_type"] == "code")
