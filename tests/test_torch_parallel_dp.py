"""The port's data-parallel step (``parallel/data.py``) on gloo CPU ranks,
against its own single-process step on the concatenated batch and against
the JAX package's ``dp_train_step`` on a 4-device mesh (the 8 virtual CPU
devices of ``tests/conftest.py``), with the JAX weights carried over.

Ranks are started by ``parallel.launch.spawn`` and run the module-level
``_*_rank`` functions below; this module imports JAX only inside the tests,
so a rank imports none of it.  Tolerance: atol 1e-5 on the parameters after
Adam steps (JAX's own ``test_dp_matches_single_device``); the summed loss
to rtol 1e-6 of the single process's."""

import copy

import numpy as np
import pytest
import torch

from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch.experiments.train import (
    l1_sum_loss, make_tx)
from geometric_message_passing_tpu_torch.graph import batch_graphs, pad_sizes
from geometric_message_passing_tpu_torch.models import (EGNNFusedModel,
                                                        EGNNModel, GVPGNNModel)
from geometric_message_passing_tpu_torch.models import gnn101
from geometric_message_passing_tpu_torch.parallel import (dp_train_step,
                                                          launch,
                                                          make_mesh,
                                                          shard_batches)
from geometric_message_passing_tpu_torch.parallel.data import (
    batch_stats, reseed_rank_dropout)

N_DEV = 4
ATOL = 1e-5
LR = 1e-3
SGD_LR = 1e-2
TIMEOUT = 120
KW = dict(num_layers=2, emb_dim=16, in_dim=1, out_dim=1)
BN_KW = dict(num_layers=2, emb_dim=16, in_dim=1, edge_dim=4, out_dim=1)
GVP_KW = dict(num_layers=2, s_dim=16, v_dim=4, s_dim_edge=8, v_dim_edge=1,
              in_dim=1, out_dim=1)


# the JAX test's stars; for BatchNorm stars of four folds, so the shards'
# statistics differ (the 4-fold stars differ by a rotation only, and the
# model is invariant)
FOLDS = {"egnn": [4], "egnn_fused": [4], "gnn101": [4, 5, 6, 7], "gvp": [4]}


def _graphs(kind: str = "egnn", pkg=tds):
    return pkg.create_star_graphs(num=8, fold=FOLDS[kind], dim=3, seed=0)


def _model(kind: str):
    if kind == "egnn":
        return EGNNModel(**KW, device="cpu")
    if kind == "egnn_fused":
        return EGNNFusedModel(**KW, device="cpu")
    if kind == "gnn101":
        return gnn101.InvariantMPNNModel(**BN_KW, device="cpu")
    return GVPGNNModel(**GVP_KW, device="cpu",
                       generator=torch.Generator().manual_seed(0))


def _opt(name: str, model):
    if name == "adam":
        return make_tx(model.parameters(), LR)
    return torch.optim.SGD(model.parameters(), lr=SGD_LR)


def _state(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _dp_rank(kind: str, sd: dict, opt_name: str, steps: int) -> dict:
    """``steps`` dp steps on this rank's shard; rank 0 also takes the same
    steps in one process on the concatenated batch."""
    mesh = make_mesh(device="cpu")
    n, me = mesh.shape["dp"], mesh.coords["dp"]
    graphs = _graphs(kind)
    pads = pad_sizes(graphs, 2)
    model = _model(kind)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    opt = _opt(opt_name, model)
    step = dp_train_step(model, opt, mesh, l1_sum_loss)
    shard = shard_batches(graphs, n, *pads)[me]
    local = copy.deepcopy(model).train()
    with torch.no_grad():        # this shard's own statistics, not averaged
        local(shard)
    losses = [float(step(shard)) for _ in range(steps)]
    out = {"state": _state(model), "losses": losses,
           "local_stats": [b.numpy().copy() for b in batch_stats(local)],
           "stats": [b.numpy().copy() for b in batch_stats(model)]}
    if me == 0:
        single = _model(kind)
        single.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        sopt = _opt(opt_name, single)
        big = batch_graphs(graphs, pads[0] * n, pads[1] * n, pads[2] * n)
        single.train()
        single_losses = []
        for _ in range(steps):
            loss = l1_sum_loss(single(big), big)
            sopt.zero_grad(set_to_none=True)
            loss.backward()
            sopt.step()
            single_losses.append(float(loss.detach()))
        out["single"] = {"state": _state(single), "losses": single_losses}
    return out


def _dropout_rank(sd: dict) -> dict:
    """GVP-GNN's train-mode output on one batch, the dropout seeded by
    ``reseed_rank_dropout`` (what ``dp_train_step`` calls) from two keys."""
    mesh = make_mesh(device="cpu")
    model = _model("gvp")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    graphs = _graphs()
    batch = batch_graphs(graphs, *pad_sizes(graphs, len(graphs)))
    model.train()
    outs = {}
    with torch.no_grad():
        for label, key in (("a", (0, 0, 0)), ("again", (0, 0, 0)),
                           ("b", (0, 0, 1))):
            reseed_rank_dropout(model, mesh, key)
            outs[label] = model(batch).numpy().copy()
    # two dp steps from the same start and key give the same weights
    steps = {}
    for label, key in (("a", (1, 2, 3)), ("again", (1, 2, 3)),
                       ("b", (1, 2, 4))):
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        step = dp_train_step(model, make_tx(model.parameters(), LR), mesh,
                             l1_sum_loss)
        n = mesh.shape["dp"]
        shard = shard_batches(graphs, n, *pad_sizes(
            graphs, -(-len(graphs) // n)))[mesh.coords["dp"]]
        step(shard, rng=key)
        steps[label] = _state(model)
    return {"outs": outs, "steps": steps}


def _spawn(fn, tmp_path, *args, world=N_DEV):
    return launch.spawn(fn, world, backend="gloo", device="cpu",
                        init_file=str(tmp_path / "rendezvous"), args=args,
                        timeout_s=TIMEOUT)


# --------------------------------------------------------------------------
# the JAX side
# --------------------------------------------------------------------------


def _jax_setup(kind: str):
    """(JAX model, its variables, the port's state dict of them)."""
    import jax

    from geometric_message_passing_tpu import datasets as jds
    from geometric_message_passing_tpu.graph import batch_graphs as jbatch
    from geometric_message_passing_tpu.graph import pad_sizes as jpad
    from geometric_message_passing_tpu.models import EGNNModel as JEGNN
    from geometric_message_passing_tpu.models import gnn101 as jgnn101
    from geometric_message_passing_tpu.models.egnn_fused import (
        EGNNFusedModel as JFused)
    from geometric_message_passing_tpu_torch import weights

    graphs = _graphs(kind, jds)
    n_pad, e_pad, g_pad = jpad(graphs, 2)
    big = jbatch(graphs, n_pad * N_DEV, e_pad * N_DEV, g_pad * N_DEV)
    if kind == "egnn":
        model, bridge = JEGNN(**KW), weights.egnn_from_jax
    elif kind == "egnn_fused":
        model = JFused(**KW, use_pallas=False)
        bridge = weights.egnn_fused_from_jax
    else:
        model = jgnn101.InvariantMPNNModel(**BN_KW)
        bridge = weights.gnn101_from_jax
    variables = model.init(jax.random.PRNGKey(0), big)
    if "batch_stats" in variables:   # running statistics away from 0 and 1
        variables = {**variables, "batch_stats": jax.tree.map(
            lambda v: v + 0.1, variables["batch_stats"])}
    sd = {k: v.numpy() for k, v in
          bridge(jax.tree.map(np.asarray, variables)).items()}
    return model, variables, sd, bridge


def _jax_dp(kind: str, steps: int):
    """The JAX package's dp_train_step on 4 devices: (port state dict of
    the start, of the end, losses)."""
    import jax
    import optax

    from geometric_message_passing_tpu import datasets as jds
    from geometric_message_passing_tpu.experiments.train import (
        l1_sum_loss as jl1)
    from geometric_message_passing_tpu.graph import pad_sizes as jpad
    from geometric_message_passing_tpu.parallel import (
        dp_train_step as jdp, make_mesh as jmesh,
        shard_batches as jshard)

    model, variables, sd, bridge = _jax_setup(kind)
    graphs = _graphs(kind, jds)
    mesh = jmesh((N_DEV,), ("dp",), devices=jax.devices()[:N_DEV])
    sharded = jshard(graphs, N_DEV, *jpad(graphs, 2))
    tx = optax.adam(LR)
    opt_state = tx.init(variables["params"])
    step = jdp(model, tx, mesh, jl1)
    losses = []
    for _ in range(steps):
        variables, opt_state, loss = step(variables, opt_state, sharded)
        losses.append(float(loss))
    end = {k: v.numpy() for k, v in
           bridge(jax.tree.map(np.asarray, variables)).items()}
    return sd, end, losses


def _close(got: dict, want: dict, atol=ATOL, keys=None):
    for k in keys or want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0,
                                   err_msg=k)


@pytest.fixture(scope="module")
def egnn_runs(tmp_path_factory):
    """EGNNModel: JAX's two dp steps, the port's at 4 ranks (Adam, and SGD
    to show the gradients are summed)."""
    sd, jax_end, jax_losses = _jax_dp("egnn", steps=2)
    tmp = tmp_path_factory.mktemp("egnn")
    adam = _spawn(_dp_rank, tmp, "egnn", sd, "adam", 2)
    sgd = _spawn(_dp_rank, tmp_path_factory.mktemp("sgd"), "egnn", sd,
                 "sgd", 1)
    return dict(sd=sd, jax_end=jax_end, jax_losses=jax_losses, adam=adam,
                sgd=sgd)


def test_dp_matches_single_process(egnn_runs):
    ranks = egnn_runs["adam"]
    _close(ranks[0]["state"], ranks[0]["single"]["state"])
    for r in ranks[1:]:       # every rank holds the same weights
        for k, v in ranks[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)


def test_dp_matches_jax(egnn_runs):
    _close(egnn_runs["adam"][0]["state"], egnn_runs["jax_end"])
    np.testing.assert_allclose(egnn_runs["adam"][0]["losses"],
                               egnn_runs["jax_losses"], rtol=1e-5)


def test_returned_loss_is_the_sum(egnn_runs):
    ranks = egnn_runs["adam"]
    single = ranks[0]["single"]["losses"]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], single, rtol=1e-6)


def test_gradients_are_summed_not_averaged(egnn_runs):
    """SGD's update is linear in the gradient: the dp step equals the
    single step on the concatenated batch only if the ranks' gradients are
    summed (a mean would move each weight by a quarter as much)."""
    ranks, sd = egnn_runs["sgd"], egnn_runs["sd"]
    single = ranks[0]["single"]["state"]
    _close(ranks[0]["state"], single, atol=1e-6)
    moved = max(np.abs(single[k] - sd[k]).max() for k in sd)
    assert moved > 1e3 * 1e-6


def test_fused_model_matches_jax(tmp_path):
    """EGNNFusedModel (its plain route on the CPU; K1/K2 on the card)
    against the JAX fused model with use_pallas=False."""
    sd, jax_end, jax_losses = _jax_dp("egnn_fused", steps=2)
    ranks = _spawn(_dp_rank, tmp_path, "egnn_fused", sd, "adam", 2)
    _close(ranks[0]["state"], jax_end)
    _close(ranks[0]["state"], ranks[0]["single"]["state"])
    np.testing.assert_allclose(ranks[0]["losses"], jax_losses, rtol=1e-5)


def test_batch_stats_are_the_shard_mean(tmp_path):
    """InvariantMPNNModel (BatchNorm): after one step each running
    statistic equals JAX's pmean over the shards, on every rank (rtol
    1e-4, atol 1e-5: test_torch_gnn101's statistics tolerance)."""
    sd, jax_end, _ = _jax_dp("gnn101", steps=1)
    ranks = _spawn(_dp_rank, tmp_path, "gnn101", sd, "adam", 1)
    names = [k for k in jax_end if k.endswith(("running_mean",
                                               "running_var"))]
    assert len(names) == 2 * 2 * 2 * 2     # 2 layers x 2 MLPs x 2 norms
    for r in ranks:
        for k in names:
            np.testing.assert_allclose(r["state"][k], jax_end[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    # the mean of the ranks' own statistics, which differ from one another
    # (broadcasting rank 0's buffers would keep its own)
    apart = 0.0
    for i, got in enumerate(ranks[0]["stats"]):
        locals_ = [r["local_stats"][i] for r in ranks]
        np.testing.assert_allclose(got, np.mean(locals_, axis=0), atol=1e-6)
        apart = max(apart, np.abs(got - locals_[0]).max())
    assert apart > 1e-3


def test_shard_batches_matches_jax():
    from geometric_message_passing_tpu import datasets as jds
    from geometric_message_passing_tpu.graph import pad_sizes as jpad
    from geometric_message_passing_tpu.parallel import shard_batches as jshard

    for num, n_dev in ((8, 4), (7, 3), (3, 4)):
        jg = jds.create_star_graphs(num=num, fold=[4, 5], dim=3, seed=1)
        tg = tds.create_star_graphs(num=num, fold=[4, 5], dim=3, seed=1)
        pads = jpad(jg, -(-num // n_dev))
        want = jshard(jg, n_dev, *pads)
        got = shard_batches(tg, n_dev, *pads)
        assert len(got) == n_dev
        for field in ("atoms", "pos", "senders", "receivers", "graph_id",
                      "y", "node_mask", "edge_mask", "graph_mask",
                      "first_node"):
            stacked = np.asarray(getattr(want, field))
            for s in range(n_dev):
                np.testing.assert_array_equal(
                    getattr(got[s], field).numpy(), stacked[s],
                    err_msg=f"{field} shard {s}")


def test_dropout_differs_across_ranks_and_repeats(tmp_path):
    model = _model("gvp")
    ranks = _spawn(_dropout_rank, tmp_path, _state(model), world=2)
    for r in ranks:
        np.testing.assert_array_equal(r["outs"]["a"], r["outs"]["again"])
        assert not np.array_equal(r["outs"]["a"], r["outs"]["b"])
        for k in r["steps"]["a"]:
            np.testing.assert_array_equal(r["steps"]["a"][k],
                                          r["steps"]["again"][k])
    assert not np.array_equal(ranks[0]["outs"]["a"], ranks[1]["outs"]["a"])
    assert any(not np.array_equal(ranks[0]["steps"]["a"][k],
                                  ranks[0]["steps"]["b"][k])
               for k in ranks[0]["steps"]["a"])
