"""The experiment under a mesh: ``experiments/dp_fit.py::fit_dp``,
``run_experiment_reg(mesh=)`` and ``Predictor(mesh=)`` on gloo CPU ranks,
against one rank and against the JAX package's ``fit_dp`` and
``Predictor(mesh=)`` on a 4-device mesh, with the JAX weights carried
over (``weights.egnn_from_jax``).

Tolerances: ``fit_dp``'s per-epoch (test, val) MAE rtol = atol = 2e-3,
JAX's own ``TestFitDP`` tolerance (f32 sums split another way over four
epochs), both for 4 ranks against 1 and for the port against JAX; a
resumed run against the uninterrupted one bitwise; ``Predictor(mesh=)``
bitwise the single ``Predictor`` and within 1e-5 of JAX's.  JAX is
imported inside the tests only, so a rank imports none of it."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch.experiments.dp_fit import fit_dp
from geometric_message_passing_tpu_torch.experiments.infer import Predictor
from geometric_message_passing_tpu_torch.experiments.ledger import (
    append_result)
from geometric_message_passing_tpu_torch.experiments.train import (
    PlateauConfig, run_experiment_reg)
from geometric_message_passing_tpu_torch.graph import GraphLoader
from geometric_message_passing_tpu_torch.models import EGNNModel
from geometric_message_passing_tpu_torch.parallel import launch, make_mesh

N_DEV = 4
TOL = 2e-3
TIMEOUT = 150
KW = dict(num_layers=2, emb_dim=16, in_dim=1, out_dim=1)
PLATEAU = dict(mode="max", patience=1, factor=0.5)


def _data(pkg=tds):
    graphs = pkg.create_star_graphs(num=24, fold=[4], dim=3, seed=0)
    return graphs[:16], graphs[16:20], graphs[20:]


def _spawn(fn, world, tmp_path, *args):
    return launch.spawn(fn, world, backend="gloo", device="cpu",
                        init_file=str(tmp_path / "rendezvous"), args=args,
                        timeout_s=TIMEOUT)


def _fit(mesh, sd, n_epochs, ckpt=None, every=0) -> dict:
    tr, va, te = _data()
    res = fit_dp(EGNNModel(**KW, device="cpu"),
                 {k: torch.from_numpy(v) for k, v in sd.items()}, tr, va, te,
                 n_epochs=n_epochs, mesh=mesh, batch_size=8, lr=1e-3,
                 plateau=PlateauConfig(**PLATEAU), seed=0,
                 checkpoint_dir=ckpt, checkpoint_every=every)
    return {"best_val": res.best_val, "test": res.test,
            "perf": res.perf_per_epoch, "losses": res.train_losses,
            "state": {k: v.numpy() for k, v in res.variables.items()}}


def _fit_rank(sd: dict, ckpt: str) -> dict:
    """The uninterrupted run; with ``ckpt`` also a run stopped after epoch
    2 (checkpoints every epoch) and its resumption to epoch 4."""
    mesh = make_mesh(device="cpu")
    out = {"full": _fit(mesh, sd, 4)}
    if ckpt:
        out["cut"] = _fit(mesh, sd, 2, ckpt, every=1)
        out["resumed"] = _fit(mesh, sd, 4, ckpt, every=1)
    return out


def _jax_fit():
    """(the port's state dict of JAX's initial weights, JAX's fit_dp on 4
    devices: best val, test, per-epoch rows)."""
    import jax

    from geometric_message_passing_tpu import datasets as jds
    from geometric_message_passing_tpu.experiments.dp_fit import (
        fit_dp as jfit)
    from geometric_message_passing_tpu.experiments.train import (
        PlateauConfig as JPlateau, seed_everything)
    from geometric_message_passing_tpu.graph import batch_graphs, pad_sizes
    from geometric_message_passing_tpu.models import EGNNModel as JEGNN
    from geometric_message_passing_tpu.parallel import make_mesh as jmesh
    from geometric_message_passing_tpu_torch.weights import egnn_from_jax

    tr, va, te = _data(jds)
    model = JEGNN(**KW)
    init = batch_graphs(tr[:2], *pad_sizes(tr, 2))
    variables = model.init(seed_everything(0), init)
    mesh = jmesh((N_DEV,), ("dp",), devices=jax.devices()[:N_DEV])
    res = jfit(model, variables, tr, va, te, n_epochs=4, mesh=mesh,
               batch_size=8, lr=1e-3, plateau=JPlateau(**PLATEAU), seed=0)
    sd = {k: v.numpy() for k, v in
          egnn_from_jax(jax.tree.map(np.asarray, variables)).items()}
    return sd, {"best_val": res.best_val, "test": res.test,
                "perf": np.asarray(res.perf_per_epoch, np.float64)}


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    sd, jax_res = _jax_fit()
    tmp = tmp_path_factory.mktemp("fit4")
    four = _spawn(_fit_rank, N_DEV, tmp, sd, str(tmp / "ck"))
    one = _spawn(_fit_rank, 1, tmp_path_factory.mktemp("fit1"), sd, "")
    return dict(sd=sd, jax=jax_res, four=four, one=one[0])


def test_four_ranks_match_one(fits):
    r4, r1 = fits["four"][0]["full"], fits["one"]["full"]
    assert np.isfinite(r4["best_val"]) and np.isfinite(r4["test"])
    # each step's loss is the sum over the ranks: the one rank's
    np.testing.assert_allclose(r4["losses"], r1["losses"], rtol=TOL)
    np.testing.assert_allclose(r4["best_val"], r1["best_val"], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(r4["perf"], r1["perf"], rtol=TOL, atol=TOL)
    assert r4["perf"].shape == (4, 2)


def test_every_rank_returns_the_same_result(fits):
    first = fits["four"][0]["full"]
    for r in fits["four"][1:]:
        np.testing.assert_array_equal(r["full"]["perf"], first["perf"])
        for k, v in first["state"].items():
            np.testing.assert_array_equal(r["full"]["state"][k], v)


def test_tracks_jax_fit_dp(fits):
    got, want = fits["four"][0]["full"], fits["jax"]
    np.testing.assert_allclose(got["perf"], want["perf"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["best_val"], want["best_val"], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got["test"], want["test"], rtol=TOL, atol=TOL)


def test_resume_reproduces_the_uninterrupted_run(fits):
    """Stopped after epoch 2 and resumed at 4 ranks: bitwise the run that
    was not interrupted (the shuffle and the dropout keys come from (seed,
    epoch, step), the rest from the checkpoint)."""
    for r in fits["four"]:
        full, cut, resumed = r["full"], r["cut"], r["resumed"]
        np.testing.assert_array_equal(cut["perf"], full["perf"][:2])
        np.testing.assert_array_equal(resumed["perf"], full["perf"])
        np.testing.assert_array_equal(resumed["losses"], full["losses"])
        assert full["losses"].shape == (4, 2)    # 16 graphs, batch 8
        assert (resumed["best_val"], resumed["test"]) == (full["best_val"],
                                                          full["test"])
        for k, v in full["state"].items():
            np.testing.assert_array_equal(resumed["state"][k], v, err_msg=k)


def _ledger_rank(path: str) -> dict:
    mesh = make_mesh(device="cpu")
    loaders = [GraphLoader(g, batch_size=8) for g in _data()]
    model_func = lambda **kw: EGNNModel(num_layers=1, emb_dim=16, **kw)  # noqa: E731
    args = dict(in_dim=1, out_dim=1)
    bv, tm, times, mean, std = run_experiment_reg(
        model_func, args, *loaders, n_epochs=2, n_times=1, mesh=mesh)
    if mesh.rank == 0:
        append_result(path, dict(model="egnn", mesh=f"dp{mesh.size}",
                                 test_acc=tm, mean=mean, std=std))
    dist.barrier()
    refused = {}
    for kw in (dict(loss_mask=True), dict(nan_recovery=True),
               dict(grad_clip=1.0), dict(lr_warmup=5)):
        try:
            run_experiment_reg(model_func, args, *loaders, n_epochs=1,
                               n_times=1, mesh=mesh, **kw)
            refused[next(iter(kw))] = None
        except ValueError as exc:
            refused[next(iter(kw))] = str(exc)
    return {"mean": mean, "std": std, "test": tm, "refused": refused}


def test_run_experiment_reg_under_a_mesh_writes_the_ledger(tmp_path):
    import json

    path = tmp_path / "hist.json"
    ranks = _spawn(_ledger_rank, N_DEV, tmp_path, str(path))
    assert np.isfinite(ranks[0]["mean"])
    assert all(r["test"] == ranks[0]["test"] for r in ranks)
    rec = json.loads(path.read_text())
    assert rec[-1]["mesh"] == "dp4" and rec[-1]["mean"] == ranks[0]["mean"]
    for r in ranks:
        assert "not supported under mesh" in r["refused"]["loss_mask"]
        assert "not supported under mesh" in r["refused"]["nan_recovery"]
        assert "not supported under mesh" in r["refused"]["grad_clip"]
        assert "not supported under mesh" in r["refused"]["lr_warmup"]


def _predict_graphs(pkg=tds):
    return pkg.create_star_graphs(num=27, fold=[4, 5], dim=3, seed=3)


def _predict_rank(sd: dict) -> dict:
    mesh = make_mesh(device="cpu")
    model = EGNNModel(num_layers=2, emb_dim=16, in_dim=1, out_dim=2,
                      device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    graphs = _predict_graphs()
    single = Predictor(model, batch_size=4, device="cpu").predict(graphs)
    sharded = Predictor(model, batch_size=4, mesh=mesh)
    y = sharded.predict(graphs)
    y10 = sharded.predict(graphs[:10])
    return {"single": single, "y": y, "y10": y10,
            "trace_count": sharded.trace_count,
            "device": str(sharded.device)}


def test_predictor_mesh(tmp_path):
    """27 graphs at batch 4 over 4 ranks: 7 batches, a ragged last group
    and a partial last batch (the JAX test's case)."""
    import jax

    from geometric_message_passing_tpu import datasets as jds
    from geometric_message_passing_tpu.experiments.infer import (
        Predictor as JPredictor)
    from geometric_message_passing_tpu.experiments.train import (
        seed_everything)
    from geometric_message_passing_tpu.graph import GraphLoader as JLoader
    from geometric_message_passing_tpu.models import EGNNModel as JEGNN
    from geometric_message_passing_tpu.parallel import make_mesh as jmesh
    from geometric_message_passing_tpu_torch.weights import egnn_from_jax

    graphs = _predict_graphs(jds)
    model = JEGNN(num_layers=2, emb_dim=16, in_dim=1, out_dim=2)
    variables = model.init(seed_everything(0),
                           next(iter(JLoader(graphs, batch_size=4))))
    mesh = jmesh((N_DEV,), ("dp",), devices=jax.devices()[:N_DEV])
    want = JPredictor(model, variables, batch_size=4, mesh=mesh).predict(
        graphs)
    sd = {k: v.numpy() for k, v in
          egnn_from_jax(jax.tree.map(np.asarray, variables)).items()}
    ranks = _spawn(_predict_rank, N_DEV, tmp_path, sd)
    for r in ranks:
        assert r["y"].shape == (27, 2) and r["device"] == "cpu"
        np.testing.assert_array_equal(r["y"], r["single"])
        np.testing.assert_array_equal(r["y10"], r["single"][:10])
        np.testing.assert_array_equal(r["y"], ranks[0]["y"])
        assert r["trace_count"] == 1
    np.testing.assert_allclose(ranks[0]["y"], want, atol=1e-5, rtol=0)


def test_predictor_refuses_a_foreign_mesh():
    model = EGNNModel(**KW, device="cpu")
    with pytest.raises(TypeError, match="parallel.Mesh"):
        Predictor(model, batch_size=4, device="cpu", mesh=object())
