"""The port's tensor parallelism (``parallel/tp.py``, the ``tp_axis`` paths
of ``nn/conv.py``, ``models/mace.py`` and ``models/tfn.py``) on 4 gloo
CPU ranks, against the JAX package's ``tp.py`` on 4 of the 8 virtual CPU
devices of ``tests/conftest.py`` and against the port's own single-rank
model, at the JAX tests' toy sizes (``tests/test_parallel.py``'s
``TestTensorParallel``, ``test_tfn_tensor_parallel_matches_single_device``,
``test_dp_tp_hybrid_matches_single_device``).

Tolerances: the forward within atol 1e-5 of JAX's (MACE) and rtol = atol =
2e-5 (TFN with gates); the gradients, probed as JAX's tests probe them (one
SGD step at lr 1: old - new), within ``GRAD_TOL`` of each tensor's largest
entry of the reference, JAX's or the single-rank model's sliced by the
sharder; the dp x tp loss within rtol 1e-5.  The sharder's output is the
JAX sharder's, carried over by ``weights``, bitwise.  JAX is imported
inside the tests only, so a rank imports none of it; one launch of 4 ranks
runs every tensor-parallel part."""

import numpy as np
import pytest
import torch

from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import weights
from geometric_message_passing_tpu_torch.experiments.train import (
    l1_sum_loss, make_tx)
from geometric_message_passing_tpu_torch.graph import batch_graphs, pad_sizes
from geometric_message_passing_tpu_torch.models import MACEModel, TFNModel
from geometric_message_passing_tpu_torch.parallel import (
    differentiable, dp_tp_train_step, launch, make_mesh, shard_batches,
    shard_model_variables, tp_apply, tp_local_model, tp_train_step)
from geometric_message_passing_tpu_torch.parallel.tp import (REPLICATED,
                                                             split_rule)

TP = 4
DP_TP = (2, 2)
TIMEOUT = 120
GRAD_TOL = 1e-4          # of each tensor's largest gradient entry
ADAM_STEPS, LR = 3, 5e-4
KW = {"mace": dict(num_layers=2, emb_dim=8, in_dim=1, out_dim=1, max_ell=2,
                   correlation=2),
      "mace_nobn": dict(num_layers=2, emb_dim=8, in_dim=1, out_dim=1,
                        max_ell=2, correlation=2, batch_norm=False),
      "tfn": dict(num_layers=2, emb_dim=8, in_dim=1, out_dim=1, max_ell=2,
                  pool="sum")}


def _graphs(pkg=tds, dp=False):
    if dp:     # the JAX dp x tp test's stars
        return pkg.create_star_graphs(num=8, fold=[4], dim=3, target="max",
                                      seed=0)
    return pkg.create_star_graphs(num=6, fold=[3, 4], dim=3, target="max",
                                  seed=0)


def _batch():
    graphs = _graphs()
    return batch_graphs(graphs, *pad_sizes(graphs, len(graphs)))


def _dp_pads():
    return pad_sizes(_graphs(dp=True), 4)


def _model(kind: str, **kw):
    cls = TFNModel if kind == "tfn" else MACEModel
    return cls(**{**KW[kind], **kw}, device="cpu")


def _full(kind: str, sd: dict):
    model = _model(kind)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model


def _np(tensors: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def _params(model) -> dict:
    return _np(dict(model.named_parameters()))


def _probe(model, step, batch) -> tuple:
    """One SGD(lr 1) step: (old - new per parameter, the exact gradients,
    the returned loss)."""
    before = _params(model)
    loss = float(step(batch))
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    after = _params(model)
    return {k: before[k] - after[k] for k in before}, grads, loss


def _local(full, mesh, shard, axis="tp"):
    local = tp_local_model(full, mesh.shape[axis], mesh, axis)
    local.load_state_dict(shard)
    return local


def _tp_rank(sds: dict) -> dict:
    """Every tensor-parallel part on one of 4 ranks."""
    mesh = make_mesh((TP,), ("tp",), device="cpu")
    me = mesh.coords["tp"]
    batch = _batch()
    out = {}
    for kind in ("mace", "tfn"):
        full = _full(kind, sds[kind])
        shard = shard_model_variables(full.state_dict(), full, TP)[me]
        res = {"fwd": tp_apply(full, shard, mesh)(batch).numpy().copy()}
        local = _local(full, mesh, shard)
        step = tp_train_step(local, torch.optim.SGD(local.parameters(),
                                                    lr=1.0), mesh, l1_sum_loss)
        res["probe"], res["grads"], res["loss"] = _probe(local, step, batch)
        local = _local(full, mesh, shard)
        step = tp_train_step(local, make_tx(local.parameters(), LR), mesh,
                             l1_sum_loss)
        for _ in range(ADAM_STEPS):
            step(batch)
        res["adam"] = _np(local.state_dict())
        out[kind] = res

    # the equivariant readout (``pred`` over every irrep's channels)
    full = _model("mace", equivariant_pred=True)
    shard = shard_model_variables(full.state_dict(), full, TP)[me]
    out["eqp_fwd"] = tp_apply(full, shard, mesh)(batch).numpy().copy()

    # (dp 2, tp 2): MACE without batch norm, one dp shard of graphs a row
    mesh2 = make_mesh(DP_TP, ("dp", "tp"), device="cpu")
    full = _full("mace_nobn", sds["mace_nobn"])
    shard = shard_model_variables(full.state_dict(), full,
                                  DP_TP[1])[mesh2.coords["tp"]]
    local = _local(full, mesh2, shard)
    step = dp_tp_train_step(local, torch.optim.SGD(local.parameters(),
                                                   lr=1.0), mesh2, l1_sum_loss)
    part = shard_batches(_graphs(dp=True), DP_TP[0],
                         *_dp_pads())[mesh2.coords["dp"]]
    res = {}
    res["probe"], res["grads"], res["loss"] = _probe(local, step, part)
    res["coords"] = dict(mesh2.coords)
    out["dp_tp"] = res

    # the differentiable collectives' backward
    x = torch.arange(3.0, requires_grad=True)
    w = torch.tensor([1.0, 2.0, 3.0]) * (me + 1)
    (differentiable.psum(mesh, x * (me + 1), "tp") * w).sum().backward()
    out["psum_grad"] = x.grad.numpy().copy()
    x.grad = None
    ring = [(i, (i + 1) % TP) for i in range(TP)]
    (differentiable.ppermute(mesh, x * (me + 1), ring, "tp") * w).sum(
        ).backward()
    out["ppermute_grad"] = x.grad.numpy().copy()
    x.grad = None
    (differentiable.psum_replicated(mesh, x * (me + 1), "tp") * w).sum(
        ).backward()
    out["psum_replicated_grad"] = x.grad.numpy().copy()
    return out


def _scales(shards) -> dict:
    """Each tensor's largest entry over all its shards (the whole
    parameter's)."""
    return {k: max(float(np.abs(s[k]).max()) for s in shards)
            for k in shards[0]}


def _grad_close(got: dict, want: dict, scales: dict, what: str,
                tol=GRAD_TOL) -> None:
    assert got.keys() == want.keys(), (what, sorted(got), sorted(want))
    for k in want:
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= tol * scales[k], (
            f"{what} {k}: {err:.3e} > {tol} x {scales[k]:.3e}")


def _jax_summed(probes: list) -> list:
    """JAX's per-shard gradients with the replicated parameters' summed
    over the shards: JAX leaves each copy its own part (the trunk's
    through its heads, the readout's 1/k of the loss / k), the port sums
    them (``parallel/tp.py``)."""
    out = []
    for probe in probes:
        out.append({k: (sum(q[k] for q in probes)
                        if split_rule(k) == REPLICATED else v)
                    for k, v in probe.items()})
    return out


# --------------------------------------------------------------------------
# the JAX side
# --------------------------------------------------------------------------


def _jax(kind: str):
    """(JAX model, its variables, its batch, bridge to the port)."""
    import jax
    import jax.numpy as jnp

    from geometric_message_passing_tpu import datasets as jds
    from geometric_message_passing_tpu.graph import (assemble_batch,
                                                     batch_graphs as jbatch,
                                                     build_slot_data)
    from geometric_message_passing_tpu.graph import pad_sizes as jpad
    from geometric_message_passing_tpu.models import MACEModel as JMACE
    from geometric_message_passing_tpu.models import TFNModel as JTFN
    from geometric_message_passing_tpu.experiments.train import seed_everything

    if kind == "mace_nobn":
        graphs = _graphs(jds, dp=True)
        n_pad, e_pad, g_pad = jpad(graphs, 4)
        batch = jbatch(graphs, n_pad * DP_TP[0], e_pad * DP_TP[0],
                       g_pad * DP_TP[0])
        model = JMACE(**KW[kind])
        return model, model.init(seed_everything(0), batch), batch
    graphs = _graphs(jds)
    batch = assemble_batch(build_slot_data(graphs),
                           jnp.arange(len(graphs), dtype=jnp.int32))
    model = (JTFN if kind == "tfn" else JMACE)(**KW[kind])
    return model, model.init(jax.random.PRNGKey(0), batch), batch


def _bridge(kind: str, variables, model=None) -> dict:
    import jax

    tree = jax.tree.map(np.asarray, variables)
    if kind == "tfn":
        sd = weights.tfn_from_jax(tree)
    else:
        sd = weights.mace_from_jax(tree, model if model is not None
                                   else _model(kind))
    return {k: v.numpy() for k, v in sd.items()}


def _shard_of(tree, p: int):
    import jax

    return jax.tree.map(lambda x: np.asarray(x)[p], tree)


def _local_twin(kind: str, k: int):
    """A single-rank model at the local widths: its U tables are the
    shards' (channel-free), which ``mace_from_jax`` checks."""
    return _model(kind, emb_dim=KW[kind]["emb_dim"] // k)


def _jax_runs(kind: str) -> dict:
    """JAX's tp_apply and the tp_train_step SGD(1) probe on 4 devices
    (dp x tp on (2, 2) for mace_nobn), each shard in the port's names."""
    import jax
    import optax

    from geometric_message_passing_tpu import datasets as jds
    from geometric_message_passing_tpu.experiments.train import (
        l1_sum_loss as jl1)
    from geometric_message_passing_tpu.graph import pad_sizes as jpad
    from geometric_message_passing_tpu.parallel import (make_mesh as jmesh,
                                                        shard_batches as jsb)
    from geometric_message_passing_tpu.parallel.tp import (
        dp_tp_train_step as jdptp, shard_model_variables as jshard,
        tp_apply as japply, tp_train_step as jstep)

    model, variables, batch = _jax(kind)
    k = DP_TP[1] if kind == "mace_nobn" else TP
    shards = jshard(variables, model, k)
    twin = _local_twin(kind, k)
    local_sd = [_bridge(kind, _shard_of(shards, p), twin) for p in range(k)]
    out = {"full": _bridge(kind, variables), "local_sd": local_sd}
    tx = optax.sgd(1.0)
    opt = jax.vmap(tx.init)(shards["params"])
    if kind == "mace_nobn":
        mesh = jmesh(DP_TP, ("dp", "tp"), devices=jax.devices()[:4])
        graphs = _graphs(jds, dp=True)
        sharded = jsb(graphs, DP_TP[0], *jpad(graphs, 4))
        new, _, loss = jdptp(model, tx, mesh, jl1)(shards, opt, sharded)
    else:
        mesh = jmesh((TP,), ("tp",), devices=jax.devices()[:TP])
        out["fwd"] = np.asarray(japply(model, shards, mesh)(shards, batch))
        new, _, loss = jstep(model, tx, mesh, jl1)(shards, opt, batch)
    out["loss"] = float(loss)
    out["probe"] = []
    for p in range(k):        # the parameters alone (no batch statistics)
        params = {c: v for c, v in _shard_of(new, p).items()
                  if c != "batch_stats"}
        after = _bridge(kind, params, twin)
        out["probe"].append({n: local_sd[p][n] - v for n, v in after.items()})
    return out


# --------------------------------------------------------------------------
# the port's single-rank reference
# --------------------------------------------------------------------------


def _single(kind: str, sd: dict) -> dict:
    """The full model's gradients (sharded like the parameters), loss and
    forward on one process; with Adam, its state after ``ADAM_STEPS``
    sharded."""
    model = _full(kind, sd).train()
    if kind == "mace_nobn":
        graphs = _graphs(dp=True)
        n_pad, e_pad, g_pad = _dp_pads()
        batch = batch_graphs(graphs, n_pad * DP_TP[0], e_pad * DP_TP[0],
                             g_pad * DP_TP[0])
        k = DP_TP[1]
    else:
        batch, k = _batch(), TP
    loss = l1_sum_loss(model(batch), batch)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    out = {"loss": float(loss.detach()), "grads": [
        _np(s) for s in shard_model_variables(grads, model, k)]}
    if kind != "mace_nobn":
        model = _full(kind, sd)
        out["fwd"] = model.eval()(batch).detach().numpy()
        model.train()
        opt = make_tx(model.parameters(), LR)
        for _ in range(ADAM_STEPS):
            loss = l1_sum_loss(model(batch), batch)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        out["adam"] = [_np(s) for s in shard_model_variables(
            model.state_dict(), model, k)]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_runs = {kind: _jax_runs(kind) for kind in KW}
    sds = {kind: r["full"] for kind, r in jax_runs.items()}
    ranks = launch.spawn(_tp_rank, TP, backend="gloo", device="cpu",
                         init_file=str(tmp_path_factory.mktemp("tp")
                                       / "rendezvous"),
                         args=(sds,), timeout_s=TIMEOUT)
    single = {kind: _single(kind, sds[kind]) for kind in KW}
    return dict(jax=jax_runs, ranks=ranks, single=single)


@pytest.mark.parametrize("kind", ["mace", "tfn"])
@pytest.mark.parametrize("k", [2, 4])
def test_sharder_matches_jax_bitwise(kind, k):
    """The port's sharder on the port's copy of the full weights gives, for
    every shard, the port's copy of JAX's shard exactly (TFN: the gates
    regrouped into one entry per gated irrep)."""
    from geometric_message_passing_tpu.parallel.tp import (
        shard_model_variables as jshard)

    model, variables, _ = _jax(kind)
    full = _full(kind, _bridge(kind, variables))
    mine = shard_model_variables(full.state_dict(), full, k)
    theirs = jshard(variables, model, k)
    twin = _local_twin(kind, k)
    for p in range(k):
        want = _bridge(kind, _shard_of(theirs, p), twin)
        got = _np(mine[p])
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"shard {p} {key}")
    if kind == "tfn":       # the hidden layer's local heads outnumber the full
        heads = {key.split(".")[3] for key in mine[0]
                 if key.startswith("convs.1.fc_out.")}
        full_heads = {key.split(".")[3] for key in full.state_dict()
                      if key.startswith("convs.1.fc_out.")}
        assert len(heads) > len(full_heads)


@pytest.mark.parametrize("kind", ["mace", "tfn"])
def test_tp_apply_matches_jax_and_single_rank(runs, kind):
    tol = dict(atol=1e-5, rtol=0) if kind == "mace" else dict(atol=2e-5,
                                                             rtol=2e-5)
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[kind]["fwd"], runs["jax"][kind]["fwd"],
                                   **tol)
        np.testing.assert_allclose(r[kind]["fwd"],
                                   runs["single"][kind]["fwd"], **tol)


def test_tp_apply_with_the_equivariant_readout(runs):
    """``equivariant_pred``: ``pred`` reads every irrep, so a shard's
    columns are its channels of each (not JAX's contiguous row blocks)."""
    model = _model("mace", equivariant_pred=True).eval()
    with torch.no_grad():
        want = model(_batch()).numpy()
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["eqp_fwd"], want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["mace", "tfn"])
def test_tp_gradients_match_jax(runs, kind):
    """The SGD(1) probe of every shard against JAX's probe of the same
    shard (the replicated parameters' summed over JAX's shards), and the
    returned loss (loss * k) against JAX's."""
    want = _jax_summed(runs["jax"][kind]["probe"])
    scales = _scales(want)
    for p, r in enumerate(runs["ranks"]):
        _grad_close(r[kind]["probe"], want[p], scales, f"{kind} shard {p}")
        np.testing.assert_allclose(r[kind]["loss"], runs["jax"][kind]["loss"],
                                   rtol=1e-5)


@pytest.mark.parametrize("kind", ["mace", "tfn"])
def test_tp_gradients_are_slices_of_the_single_rank_gradients(runs, kind):
    """Each rank's exact gradients (and its SGD probe) against the
    single-rank model's gradients cut by the sharder: the conv's psum sums
    its cotangents (an identity backward would leave each rank only its
    own channels' part)."""
    single = runs["single"][kind]
    scales = _scales(single["grads"])
    for p, r in enumerate(runs["ranks"]):
        _grad_close(r[kind]["grads"], single["grads"][p], scales,
                    f"{kind} {p}")
        _grad_close(r[kind]["probe"], single["grads"][p], scales,
                    f"{kind} probe {p}")
        np.testing.assert_allclose(r[kind]["loss"], single["loss"], rtol=1e-5)


@pytest.mark.parametrize("kind", ["mace", "tfn"])
def test_tp_adam_steps_match_single_rank(runs, kind):
    """Three Adam steps at lr 5e-4: every shard's weights and batch
    statistics within 1e-4 of each tensor's largest entry of the
    single-rank steps' (sharded)."""
    for p, r in enumerate(runs["ranks"]):
        want = runs["single"][kind]["adam"][p]
        got = r[kind]["adam"]
        assert got.keys() == want.keys()
        for key in want:
            scale = max(float(np.abs(want[key]).max()), 1.0)
            assert float(np.abs(got[key] - want[key]).max()) <= 1e-4 * scale, key


def test_dp_tp_step_matches_jax_and_single_rank(runs):
    """(dp 2, tp 2), MACE without batch norm as in the JAX test: the loss
    summed over dp within rtol 1e-5 of the single rank's on the whole
    batch; every rank's gradients (summed over dp) against JAX's probe and
    against the single-rank gradients' slice of its tp coordinate."""
    jax_run, single = runs["jax"]["mace_nobn"], runs["single"]["mace_nobn"]
    want = _jax_summed(jax_run["probe"])
    scales = _scales(single["grads"])
    for r in runs["ranks"]:
        res = r["dp_tp"]
        p = res["coords"]["tp"]
        np.testing.assert_allclose(res["loss"], single["loss"], rtol=1e-5)
        np.testing.assert_allclose(res["loss"], jax_run["loss"], rtol=1e-5)
        _grad_close(res["grads"], single["grads"][p], scales, f"dp x tp {p}")
        _grad_close(res["probe"], want[p], scales, f"dp x tp jax {p}")


def test_differentiable_collectives_backward(runs):
    """psum's backward sums the cotangents over the axis (sum over ranks
    r of (r + 1) * w_r, times this rank's factor); ppermute's sends them
    back along the inverse ring; psum_replicated's passes this rank's."""
    w = np.array([1.0, 2.0, 3.0])
    total = sum((r + 1) * w for r in range(TP))
    for me, r in enumerate(runs["ranks"]):
        np.testing.assert_allclose(r["psum_grad"], (me + 1) * total)
        nxt = (me + 1) % TP
        np.testing.assert_allclose(r["ppermute_grad"],
                                   (me + 1) * (nxt + 1) * w)
        np.testing.assert_allclose(r["psum_replicated_grad"],
                                   (me + 1) * (me + 1) * w)


def test_tp_axis_needs_a_mesh_and_the_sharder_knows_every_key():
    with pytest.raises(ValueError, match="needs mesh="):
        TFNModel(tp_axis="tp", tp_size=2, device="cpu")
    model = _model("mace")
    sd = dict(model.state_dict())
    sd["extra.weight"] = torch.zeros(2)
    with pytest.raises(ValueError, match="no tensor-parallel sharding rule"):
        shard_model_variables(sd, model, 2)
