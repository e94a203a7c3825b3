"""The port's ``parallel.data.dp_train_step_autoshard`` on 4 gloo CPU
ranks: the twin of ``tests/test_parallel.py::
test_dp_autoshard_matches_single_device`` (EGNN 2 x 16 on the
block-diagonal batch of 8 stars, every field cut into 4 row blocks, one
Adam step at lr 1e-3) against the JAX package's single-device step with
the same weights (``weights.egnn_from_jax``): the loss within rtol 1e-5
and the weights within atol 1e-5 (the JAX test's), and against the port's
own single-process step (the same program on the same batch: atol 1e-6).
JAX is imported inside the tests only, so a rank imports none of it."""

import dataclasses

import numpy as np
import pytest
import torch

from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch.experiments.train import (
    l1_sum_loss, make_tx)
from geometric_message_passing_tpu_torch.graph import batch_graphs, pad_sizes
from geometric_message_passing_tpu_torch.models import EGNNModel
from geometric_message_passing_tpu_torch.parallel import (
    autoshard_rows, dp_train_step_autoshard, launch, make_mesh)

N_DEV = 4
LR = 1e-3
TIMEOUT = 120
KW = dict(num_layers=2, emb_dim=16, in_dim=1, out_dim=1)


def _big(pkg=tds, batch_fn=batch_graphs, pad_fn=pad_sizes):
    graphs = pkg.create_star_graphs(num=8, fold=[4], dim=3, seed=0)
    n_pad, e_pad, g_pad = pad_fn(graphs, 2)
    return batch_fn(graphs, n_pad * N_DEV, e_pad * N_DEV, g_pad * N_DEV)


def _model(sd):
    model = EGNNModel(**KW, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model


def _autoshard_rank(sd: dict) -> dict:
    mesh = make_mesh((N_DEV,), ("dp",), device="cpu")
    model = _model(sd)
    step = dp_train_step_autoshard(model, make_tx(model.parameters(), LR),
                                   mesh, l1_sum_loss)
    loss = step(autoshard_rows(_big(), N_DEV, mesh.coords["dp"]))
    return {"loss": float(loss),
            "params": {k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()}}


def _jax_step():
    """JAX's single-device Adam step: (weights before and after in the
    port's names, the loss)."""
    import jax
    import optax

    from geometric_message_passing_tpu import datasets as jds
    from geometric_message_passing_tpu.experiments.train import (
        l1_sum_loss as jl1, seed_everything)
    from geometric_message_passing_tpu.graph import (batch_graphs as jbatch,
                                                     pad_sizes as jpad)
    from geometric_message_passing_tpu.models import EGNNModel as JEGNN
    from geometric_message_passing_tpu_torch.weights import egnn_from_jax

    big = _big(jds, jbatch, jpad)
    model = JEGNN(**KW)
    variables = model.init(seed_everything(0), big)
    tx = optax.adam(LR)

    def loss_fn(params):
        return jl1(model.apply({**variables, "params": params}, big), big)

    loss, g = jax.value_and_grad(loss_fn)(variables["params"])
    updates, _ = tx.update(g, tx.init(variables["params"]),
                           variables["params"])
    new = optax.apply_updates(variables["params"], updates)

    def port(params):
        sd = egnn_from_jax(jax.tree.map(np.asarray,
                                        {**variables, "params": params}))
        return {k: v.numpy() for k, v in sd.items()}

    return port(variables["params"]), port(new), float(loss)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    before, after, loss = _jax_step()
    ranks = launch.spawn(_autoshard_rank, N_DEV, backend="gloo", device="cpu",
                         init_file=str(tmp_path_factory.mktemp("auto")
                                       / "rendezvous"),
                         args=(before,), timeout_s=TIMEOUT)
    return before, after, loss, ranks


def test_dp_autoshard_matches_jax_single_device(runs):
    _, after, loss, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        assert r["params"].keys() == after.keys()
        for k, v in after.items():
            np.testing.assert_allclose(r["params"][k], v, atol=1e-5, rtol=0,
                                       err_msg=k)


def test_dp_autoshard_matches_the_single_process_step(runs):
    """Every rank ends with the weights of one process stepping on the
    whole batch (the compute is replicated, not split)."""
    before, _, _, ranks = runs
    model = _model(before)
    opt = make_tx(model.parameters(), LR)
    model.train()
    batch = _big()
    loss = l1_sum_loss(model(batch), batch)
    loss.backward()
    opt.step()
    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(loss.detach()),
                                   rtol=1e-6)
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(r["params"][k], v.detach().numpy(),
                                       atol=1e-6, rtol=0, err_msg=k)


def test_autoshard_rows_cut_every_field_and_need_divisible_rows():
    big = _big()
    parts = [autoshard_rows(big, N_DEV, i) for i in range(N_DEV)]
    for f in dataclasses.fields(big):
        if f.name == "triplets":
            continue
        whole = getattr(big, f.name)
        torch.testing.assert_close(torch.cat([getattr(p, f.name)
                                              for p in parts]), whole)
    with pytest.raises(ValueError, match="multiple"):
        autoshard_rows(big, 3, 0)
