"""The expressivity table on the port's CPU path, part 1: k-chains (the
outcome ``tests/test_training.py`` asserts), the arm started from the JAX
model's initial weights (carried over by ``weights.*_from_jax``) and
trained by the port's ``fit_classification`` at the JAX test's settings;
and each example twin's ``main`` on the CPU with few epochs, its ``mace``
choices included.  Part 2 (rotsym, incompleteness) is
``test_torch_expressivity_envs.py``.

Success is which model can separate which pair: 100% test accuracy where
the JAX tests assert it, at most 50% where they assert failure."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu.models import model_registry as jzoo
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch import weights
from geometric_message_passing_tpu_torch.examples import (incompleteness,
                                                          kchains, rotsym)
from geometric_message_passing_tpu_torch.experiments import train as ttrain
from geometric_message_passing_tpu_torch.models import model_registry as zoo

FIELDS = ("atoms", "pos", "senders", "receivers", "graph_id", "y",
          "node_mask", "edge_mask", "graph_mask", "first_node")
CARRY = {"egnn": weights.egnn_from_jax, "mpnn": weights.mpnn_from_jax,
         "tfn": weights.tfn_from_jax, "schnet": weights.schnet_from_jax,
         "mace": weights.mace_from_jax}


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny graphs: one intra-op thread is the fastest, and leaves the
    other test workers their cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def accuracy(name, kw, graphs, seed=0, n_epochs=200, lr=1e-3):
    """``fit_classification``'s test accuracy of the port's ``name`` model
    from the JAX model's initial weights at ``seed`` (the JAX tests'
    ``model.init(seed_everything(seed), first batch)``)."""
    loader = tgraph.GraphLoader(graphs, batch_size=2, y_dtype=np.int32)
    tb = next(iter(loader))
    jb = jgraph.GraphBatch(triplets=None, **{
        k: jnp.asarray(getattr(tb, k).numpy()) for k in FIELDS})
    variables = jax.tree.map(np.asarray, jzoo[name](**kw).init(
        jax.random.PRNGKey(seed), jb))
    model = zoo[name](**kw, device="cpu")
    sd = (CARRY[name](variables, model) if name == "mace"
          else CARRY[name](variables))
    model.load_state_dict(sd, strict=True)
    res = ttrain.fit_classification(model, None, loader, loader, loader,
                                    n_epochs=n_epochs, lr=lr, seed=seed,
                                    device="cpu")
    return res.test


def test_kchains_depth_requirement():
    """k = 4: EGNN with k/2 + 1 layers reaches 100% at some seed of 0-4 and
    its mean is above 50%; the position-blind MPNN never exceeds 50%."""
    k = 4
    data = tds.create_kchains(k)
    kw = dict(num_layers=k // 2 + 1, emb_dim=32, in_dim=1, out_dim=2)
    egnn = [accuracy("egnn", kw, data, seed, 400) for seed in range(5)]
    assert max(egnn) == 100.0, egnn
    assert np.mean(egnn) > 50.0, egnn
    mpnn = [accuracy("mpnn", kw, data, seed, 400) for seed in range(3)]
    assert max(mpnn) <= 50.0, mpnn


@pytest.mark.parametrize("module,argv", [
    (kchains, ["--k", "2", "--models", "mpnn", "egnn"]),
    (rotsym, ["--fold", "2", "--models", "egnn", "gvp", "tfn", "mace"]),
    (incompleteness, ["--env", "three_body", "--models", "schnet", "mace"]),
    (incompleteness, ["--env", "true_chiral", "--models", "egnn"]),
])
def test_example_twins_run_on_the_cpu(module, argv, capsys):
    rows = module.main(argv + ["--n_epochs", "3", "--n_times", "2",
                               "--device", "cpu"])
    printed = capsys.readouterr().out
    assert rows and all(len(r["test_acc"]) == 2 for r in rows)
    assert all(a in (0.0, 50.0, 100.0) for r in rows for a in r["test_acc"])
    assert printed.count("test ") == len(rows)
    if module is rotsym:       # tfn and mace sweep max_ell fold-1 and fold
        assert [(r["model"], r["max_ell"]) for r in rows] == [
            ("egnn", 0), ("gvp", 0), ("tfn", 1), ("tfn", 2), ("mace", 1),
            ("mace", 2)]


def test_example_twins_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module in (kchains, rotsym, incompleteness):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.main(["--n_epochs", "1", "--n_times", "1"])
