"""Checkpoint/resume and the NaN watchdog of the port's trainer: the twins
of the JAX package's ``test_resident_checkpoint_resume_bitwise``,
``test_resident_nan_recovery`` and
``test_repeat_protocol_checkpoint_threading`` (``tests/test_training.py``),
held to bitwise equality: the per-epoch rows, every step's loss and the
final state dict.  Plus the checkpoint files themselves (``utils.checkpoint``)
and the numeric checks (``utils.debug``)."""

import os

import numpy as np
import pytest
import torch

from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch.experiments import train as ttrain
from geometric_message_passing_tpu_torch.models import EGNNModel, GVPGNNModel
from geometric_message_passing_tpu_torch.utils import (
    CheckpointManager, all_finite, debug_nans, load_checkpoint,
    save_checkpoint)

EGNN_KW = dict(num_layers=1, emb_dim=16, in_dim=1, out_dim=1)
GVP_KW = dict(num_layers=2, s_dim=16, v_dim=4, in_dim=1, out_dim=1,
              pool="first")
ARGS = dict(lr=5e-4, seed=1, device="cpu")


@pytest.fixture(scope="module")
def loaders():
    data = tds.create_star_graphs(num=40, fold=[3, 4], dim=3, target="max",
                                  seed=9)
    tr, va, te = tgraph.random_split(data, [0.5, 0.2, 0.3], seed=0)
    pad = tgraph.pad_sizes(data, 10)
    return (tgraph.GraphLoader(tr, 10, shuffle=True, seed=0, pad=pad),
            tgraph.GraphLoader(va, 10, pad=pad),
            tgraph.GraphLoader(te, 10, pad=pad))


def _model(kind):
    model, kw = {"egnn": (EGNNModel, EGNN_KW), "gvp": (GVPGNNModel, GVP_KW)}[kind]
    return model(**kw, device="cpu", generator=ttrain.seed_everything(0))


def _assert_bitwise(got, want):
    np.testing.assert_array_equal(got.perf_per_epoch, want.perf_per_epoch)
    np.testing.assert_array_equal(got.train_losses, want.train_losses)
    assert (got.best_val, got.test) == (want.best_val, want.test)
    assert got.variables.keys() == want.variables.keys()
    for key, value in want.variables.items():
        assert torch.equal(got.variables[key], value), key


def _poison(model):
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float("nan"))


@pytest.mark.parametrize("kind, first, every", [("egnn", 4, 2), ("gvp", 3, 3)])
def test_resume_is_bitwise(loaders, tmp_path, kind, first, every):
    """Checkpointing changes no number; a run killed after ``first`` epochs
    and resumed to 6 from its directory is bitwise the uninterrupted run
    (the shuffle generator, GVP-GNN's dropout generators and Adam's state
    restored).  A resume whose shuffle generator is left at its seed
    (re-seeded rather than restored) is not."""
    model = _model(kind)
    full = ttrain.fit_regression(model, None, *loaders, n_epochs=6, **ARGS)
    kept = ttrain.fit_regression(model, None, *loaders, n_epochs=6, **ARGS,
                                 checkpoint_dir=str(tmp_path / "kept"),
                                 checkpoint_every=every)
    _assert_bitwise(kept, full)

    for name in ("resumed", "reseeded"):
        ckdir = str(tmp_path / name)
        ttrain.fit_regression(model, None, *loaders, n_epochs=first, **ARGS,
                              checkpoint_dir=ckdir, checkpoint_every=every)
        assert CheckpointManager(ckdir).latest_step == first
        if name == "reseeded":
            orig = ttrain.restore_shuffle
            ttrain.restore_shuffle = lambda gen, state: None
        try:
            resumed = ttrain.fit_regression(model, None, *loaders, n_epochs=6,
                                            **ARGS, checkpoint_dir=ckdir,
                                            checkpoint_every=every)
        finally:
            if name == "reseeded":
                ttrain.restore_shuffle = orig
        if name == "resumed":
            _assert_bitwise(resumed, full)
        else:
            np.testing.assert_array_equal(resumed.perf_per_epoch[:first],
                                          full.perf_per_epoch[:first])
            assert not np.array_equal(resumed.train_losses[first:],
                                      full.train_losses[first:])


def test_resume_needs_the_same_settings(loaders, tmp_path):
    model = _model("egnn")
    ckdir = str(tmp_path / "ck")
    ttrain.fit_regression(model, None, *loaders, n_epochs=2, **ARGS,
                          checkpoint_dir=ckdir, checkpoint_every=1,
                          grad_clip=1.0)
    for kw in (dict(), dict(grad_clip=0.5), dict(grad_clip=1.0, lr_warmup=3)):
        with pytest.raises(ValueError, match="same settings"):
            ttrain.fit_regression(model, None, *loaders, n_epochs=3, **ARGS,
                                  checkpoint_dir=ckdir, checkpoint_every=1,
                                  **kw)
    res = ttrain.fit_regression(model, None, *loaders, n_epochs=3, **ARGS,
                                checkpoint_dir=ckdir, checkpoint_every=1,
                                grad_clip=1.0)
    assert res.perf_per_epoch.shape == (3, 2)


def test_nan_recovery(loaders, tmp_path):
    """A fault at epoch 4 (every parameter NaN) is rolled back to the
    checkpoint at epoch 4 and the run ends bitwise the clean run; a fault
    at every epoch from 2 on raises after ``max_recoveries``; without
    ``nan_recovery`` the fault stays in the losses."""
    model = _model("egnn")
    args = dict(ARGS, n_epochs=6, cosine=True, checkpoint_every=2)
    clean = ttrain.fit_regression(model, None, *loaders, **args,
                                  checkpoint_dir=str(tmp_path / "a"))
    fired = []

    def once(epoch, work):
        if epoch == 4 and not fired:
            fired.append(epoch)
            _poison(work)

    faulted = ttrain.fit_regression(model, None, *loaders, **args,
                                    checkpoint_dir=str(tmp_path / "b"),
                                    nan_recovery=True, inject_fault=once)
    assert fired == [4]
    _assert_bitwise(faulted, clean)

    hits = []

    def always(epoch, work):
        if epoch >= 2:
            hits.append(epoch)
            _poison(work)

    with pytest.raises(FloatingPointError, match="recoveries=2"):
        ttrain.fit_regression(model, None, *loaders, **args,
                              checkpoint_dir=str(tmp_path / "c"),
                              nan_recovery=True, max_recoveries=2,
                              inject_fault=always)
    assert hits == [2, 2, 2]          # rolled back to epoch 2 twice
    with pytest.raises(FloatingPointError, match="no rollback"):
        ttrain.fit_regression(model, None, *loaders, **args,
                              checkpoint_dir=str(tmp_path / "d"),
                              nan_recovery=True,
                              inject_fault=lambda e, w: _poison(w))
    fired.clear()
    unguarded = ttrain.fit_regression(model, None, *loaders, **args,
                                      checkpoint_dir=str(tmp_path / "e"),
                                      inject_fault=once)
    assert np.isfinite(unguarded.train_losses[:4]).all()
    assert not np.isfinite(unguarded.train_losses[4:]).any()


def test_repeat_protocol_checkpoint_threading(loaders, tmp_path):
    """Each repeat gets ``run<i>``; a second call with the same directory
    resumes every repeat from its final checkpoint and reproduces it."""
    args = dict(model_args=EGNN_KW, n_epochs=3, n_times=2, lr=5e-4,
                checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1,
                device="cpu")
    first = ttrain.run_experiment_reg(EGNNModel, train_loader=loaders[0],
                                      val_loader=loaders[1],
                                      test_loader=loaders[2], **args)
    assert np.isfinite(first[3]) and np.isfinite(first[4])
    assert sorted(os.listdir(tmp_path / "ck")) == ["run0", "run1"]
    again = ttrain.run_experiment_reg(EGNNModel, train_loader=loaders[0],
                                      val_loader=loaders[1],
                                      test_loader=loaders[2], **args)
    assert again[:2] == first[:2] and again[3:] == first[3:]


def test_manager_keeps_the_newest_and_ignores_partial_files(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step is None
    for step in (1, 2, 3):
        mgr.save(step, {"w": torch.full((3,), float(step)),
                        "best": np.float32(0.25).item(), "none": None})
    assert sorted(os.listdir(tmp_path)) == ["step_2.pt", "step_3.pt"]
    # a save killed before its rename leaves only a temporary file
    (tmp_path / "step_4.pt.123.tmp").write_bytes(b"\x80half-written")
    assert mgr.all_steps() == [2, 3] and mgr.latest_step == 3
    got = mgr.restore()
    assert torch.equal(got["w"], torch.full((3,), 3.0))
    assert np.float32(got["best"]) == np.float32(0.25) and got["none"] is None
    assert torch.equal(mgr.restore(2)["w"], torch.full((3,), 2.0))
    mgr.close()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()

    path = str(tmp_path / "one.pt")
    save_checkpoint(path, {"w": torch.ones(2)}, opt_state={"step": 3}, step=7,
                    metadata={"task": "regression"})
    got = load_checkpoint(path)
    assert got["step"] == 7 and got["opt_state"] == {"step": 3}
    assert got["metadata"] == {"task": "regression"}
    assert torch.equal(got["variables"]["w"], torch.ones(2))
    # numpy scalars are not weights: the reason the trainer stores floats
    save_checkpoint(path, {"w": np.float32(1.0)})
    with pytest.raises(Exception):
        load_checkpoint(path)


def test_all_finite_and_debug_nans():
    state = {"a": torch.ones(3), "b": [torch.zeros(2), torch.arange(3)]}
    assert bool(all_finite(state))
    state["b"][0][1] = float("inf")
    assert not bool(all_finite(state))
    assert bool(all_finite({"ids": torch.arange(4)}))
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    with debug_nans():
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()
