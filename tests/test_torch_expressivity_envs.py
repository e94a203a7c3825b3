"""The expressivity table on the port's CPU path, part 2: rotsym
(``tests/test_training.py``) and the two- and three-body incompleteness
pairs (``tests/test_incompleteness.py``), each arm started from the JAX
model's initial weights and trained by the port's ``fit_classification``
at the JAX test's settings (``test_torch_expressivity.accuracy``)."""

import pytest

from geometric_message_passing_tpu_torch import datasets as tds

from test_torch_expressivity import accuracy, one_thread  # noqa: F401


@pytest.mark.parametrize("name,should_solve", [("egnn", False), ("tfn", True),
                                               ("mace", None)])
def test_rotsym_expressivity(name, should_solve):
    """fold 3, 1 layer, equivariant prediction, 150 epochs: EGNN stays at
    50%, TFN (max_ell 3, pool first, gate off) reaches 100%.  MACE at
    max_ell 3 runs too; the JAX suite asserts nothing for it."""
    data = tds.create_rotsym_envs(fold=3)
    if name == "egnn":
        kw = dict(num_layers=1, emb_dim=32, in_dim=1, out_dim=2,
                  equivariant_pred=True, pool="sum")
    else:
        kw = dict(num_layers=1, emb_dim=8, max_ell=3, mlp_dim=32, in_dim=1,
                  out_dim=2, equivariant_pred=True, pool="first")
        kw.update(gate=False) if name == "tfn" else kw.update(correlation=2)
    acc = accuracy(name, kw, data, n_epochs=150)
    if should_solve is None:
        assert acc in (0.0, 50.0, 100.0)
    elif should_solve:
        assert acc == 100.0, acc
    else:
        assert acc <= 50.0, acc


@pytest.mark.parametrize("env,name,kw,should_solve", [
    ("two_body", "schnet", dict(num_layers=1, hidden_channels=32), False),
    ("two_body", "egnn", dict(num_layers=1, emb_dim=32,
                              equivariant_pred=True, pool="sum"), True),
    ("three_body", "mace", dict(num_layers=1, emb_dim=8, max_ell=2,
                                correlation=1, mlp_dim=32, pool="sum"), False),
    ("three_body", "mace", dict(num_layers=1, emb_dim=8, max_ell=3,
                                correlation=3, mlp_dim=32, pool="sum"), True),
])
def test_incompleteness(env, name, kw, should_solve):
    """Two-body: SchNet fails, EGNN passes; three-body: MACE with
    correlation 1 fails, correlation 3 passes (200 epochs, lr 1e-3)."""
    data = getattr(tds, f"create_{env}_envs")()
    acc = accuracy(name, dict(kw, in_dim=1, out_dim=2), data)
    if should_solve:
        assert acc == 100.0, acc
    else:
        assert acc <= 50.0, acc
