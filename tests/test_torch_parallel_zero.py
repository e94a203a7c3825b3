"""The port's ZeRO-1 step (``parallel/zero.py``) on gloo CPU ranks: two
steps against two plain Adam steps on the concatenated batch in one
process and against the JAX package's ``zero_dp_train_step`` on the same
number of devices (weights carried over by ``weights.egnn_from_jax``),
each rank's Adam moments a ``ceil(P / N)`` slice of the single process's,
and the mixed-dtype refusal.  Tolerance: atol 1e-5 on the parameters
(JAX's own ``test_zero_dp_matches_single_device``); the moments to 1e-6
of their largest entry.  JAX is imported inside the tests only, so a rank
imports none of it."""

import numpy as np
import pytest
import torch

from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch.experiments.train import (
    l1_sum_loss, make_tx)
from geometric_message_passing_tpu_torch.graph import batch_graphs, pad_sizes
from geometric_message_passing_tpu_torch.models import EGNNModel
from geometric_message_passing_tpu_torch.parallel import (launch, make_mesh,
                                                          shard_batches,
                                                          zero_dp_train_step,
                                                          zero_init)
from geometric_message_passing_tpu_torch.parallel.zero import flat_layout

ATOL = 1e-5
LR = 1e-3
STEPS = 2
TIMEOUT = 120
KW = dict(num_layers=2, emb_dim=16, in_dim=1, out_dim=1)


def _graphs(pkg=tds):
    return pkg.create_star_graphs(num=8, fold=[4], dim=3, seed=0)


def _tx(params):
    return make_tx(params, LR)


def _zero_rank(sd: dict) -> dict:
    """Two ZeRO-1 steps; rank 0 also two plain Adam steps in one process
    on the concatenated batch (its moments flattened in the same layout)."""
    mesh = make_mesh(device="cpu")
    n, me = mesh.shape["dp"], mesh.coords["dp"]
    graphs = _graphs()
    pads = pad_sizes(graphs, -(-len(graphs) // n))
    model = EGNNModel(**KW, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    opt = zero_init(_tx, model.parameters(), mesh=mesh)
    step = zero_dp_train_step(model, opt, mesh, l1_sum_loss)
    shard = shard_batches(graphs, n, *pads)[me]
    losses = [float(step(shard)) for _ in range(STEPS)]
    (piece,) = opt.param_groups[0]["params"]
    st = opt.state[piece]
    out = {"state": {k: v.numpy().copy() for k, v in model.state_dict().items()},
           "losses": losses, "moments": {k: st[k].numpy().copy()
                                         for k in ("exp_avg", "exp_avg_sq")}}
    if me == 0:
        single = EGNNModel(**KW, device="cpu")
        single.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        sopt = _tx(single.parameters())
        big = batch_graphs(graphs, pads[0] * n, pads[1] * n, pads[2] * n)
        single.train()
        for _ in range(STEPS):
            loss = l1_sum_loss(single(big), big)
            sopt.zero_grad(set_to_none=True)
            loss.backward()
            sopt.step()
        params = list(single.parameters())
        # a parameter no loss reaches (the last layer's coordinate head)
        # has no Adam state here; its ZeRO moments stay 0
        out["single"] = {
            "state": {k: v.detach().numpy().copy()
                      for k, v in single.state_dict().items()},
            "moments": {k: torch.cat([
                sopt.state[p][k].reshape(-1) if p in sopt.state
                else torch.zeros(p.numel()) for p in params]).numpy()
                for k in ("exp_avg", "exp_avg_sq")}}
    return out


def _jax_zero(n_dev: int):
    """(port state dict of the start, of the end after JAX's two ZeRO-1
    steps on ``n_dev`` devices)."""
    import jax
    import optax

    from geometric_message_passing_tpu import datasets as jds
    from geometric_message_passing_tpu.experiments.train import (
        l1_sum_loss as jl1)
    from geometric_message_passing_tpu.graph import batch_graphs as jbatch
    from geometric_message_passing_tpu.graph import pad_sizes as jpad
    from geometric_message_passing_tpu.models import EGNNModel as JEGNN
    from geometric_message_passing_tpu.parallel import (
        make_mesh as jmesh, shard_batches as jshard,
        zero_dp_train_step as jzero, zero_init as jzero_init)
    from geometric_message_passing_tpu_torch.weights import egnn_from_jax

    graphs = _graphs(jds)
    pads = jpad(graphs, -(-len(graphs) // n_dev))
    model = JEGNN(**KW)
    big = jbatch(graphs, *(p * n_dev for p in pads))
    variables = model.init(jax.random.PRNGKey(0), big)
    mesh = jmesh((n_dev,), ("dp",), devices=jax.devices()[:n_dev])
    tx = optax.adam(LR)
    opt_state = jzero_init(tx, variables["params"], n_dev, mesh=mesh)
    step = jzero(model, tx, mesh, jl1, variables["params"])
    sharded = jshard(graphs, n_dev, *pads)
    start = variables
    for _ in range(STEPS):
        variables, opt_state, _ = step(variables, opt_state, sharded)

    def port(v):
        return {k: t.numpy() for k, t in
                egnn_from_jax(jax.tree.map(np.asarray, v)).items()}

    return port(start), port(variables)


@pytest.fixture(scope="module", params=[4, 5], ids=["N4", "N5"])
def runs(request, tmp_path_factory):
    n_dev = request.param
    sd, jax_end = _jax_zero(n_dev)
    ranks = launch.spawn(_zero_rank, n_dev, backend="gloo", device="cpu",
                         init_file=str(tmp_path_factory.mktemp("zero")
                                       / "rendezvous"),
                         args=(sd,), timeout_s=TIMEOUT)
    return n_dev, sd, jax_end, ranks


def test_zero_matches_plain_adam(runs):
    _, _, _, ranks = runs
    single = ranks[0]["single"]["state"]
    for r in ranks:
        for k, want in single.items():
            np.testing.assert_allclose(r["state"][k], want, atol=ATOL, rtol=0,
                                       err_msg=k)


def test_zero_matches_jax(runs):
    _, _, jax_end, ranks = runs
    for k, want in jax_end.items():
        np.testing.assert_allclose(ranks[0]["state"][k], want, atol=ATOL,
                                   rtol=0, err_msg=k)


def test_each_rank_keeps_its_slice_of_the_moments(runs):
    """Moments of ``chunk = ceil(P / N)`` elements a rank (N 4 does not
    divide P = 4435, N 5 does), equal to the single process's moments in
    the flat layout: the summed gradient's, not a mean's (that would scale
    exp_avg by 1/N and exp_avg_sq by 1/N^2)."""
    n_dev, sd, _, ranks = runs
    size = sum(v.size for k, v in sd.items())
    chunk = -(-size // n_dev)
    assert (size % n_dev != 0) == (n_dev == 4)
    for key in ("exp_avg", "exp_avg_sq"):
        want = np.pad(ranks[0]["single"]["moments"][key],
                      (0, n_dev * chunk - size))
        scale = np.abs(want).max()
        for i, r in enumerate(ranks):
            got = r["moments"][key]
            assert got.shape == (chunk,)
            np.testing.assert_allclose(got, want[i * chunk:(i + 1) * chunk],
                                       atol=1e-6 * scale, rtol=0,
                                       err_msg=f"{key} rank {i}")


def test_mixed_dtypes_raise():
    from geometric_message_passing_tpu.parallel.zero import _flat_meta

    params = [torch.zeros(3), torch.zeros(2, dtype=torch.float64)]
    with pytest.raises(TypeError, match="uniform parameter dtype"):
        flat_layout(params, 2)
    model = EGNNModel(**KW, device="cpu")
    model.emb_in.weight.data = model.emb_in.weight.data.double()
    with pytest.raises(TypeError, match="uniform parameter dtype"):
        zero_init(_tx, model.parameters(), n_shards=2)
    with pytest.raises(TypeError, match="uniform parameter dtype"):
        _flat_meta({"a": np.zeros(3, np.float32),
                    "b": np.zeros(2, np.float16)}, 2)


def test_zero_init_without_mesh_covers_every_slice():
    model = EGNNModel(**KW, device="cpu")
    params = list(model.parameters())
    size, chunk, dtype = flat_layout(params, 4)
    opts = zero_init(_tx, params, n_shards=4)
    assert dtype == torch.float32 and len(opts) == 4
    pieces = [o.param_groups[0]["params"][0] for o in opts]
    assert all(p.shape == (chunk,) for p in pieces)
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    np.testing.assert_array_equal(torch.cat(pieces)[:size].detach().numpy(),
                                  flat.numpy())
