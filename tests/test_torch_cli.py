"""The port's experiment CLI against the JAX package's: the same flags
(names, defaults, choices, types), the same datasets and model arguments,
the same warmup resolution and ledger record; and one real 2-epoch run on
the CPU that appends its record."""

import argparse
import json

import numpy as np
import pytest
import torch

from geometric_message_passing_tpu.experiments import cli as jcli
from geometric_message_passing_tpu.experiments import train as jtrain
from geometric_message_passing_tpu_torch.experiments import cli as tcli

BASE = ["--n_data", "12", "--n_pairs", "2", "--fold", "5", "6",
        "--n_nodes", "6", "7", "--batch_size", "4"]


def _actions(parser):
    return {a.dest: a for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


def test_flags_match_jax():
    want, got = _actions(jcli.build_parser()), _actions(tcli.build_parser())
    assert list(got) == list(want)
    for dest, w in want.items():
        g = got[dest]
        for attr in ("option_strings", "default", "choices", "nargs", "type",
                     "required", "const"):
            assert getattr(g, attr) == getattr(w, attr), (dest, attr)
        assert type(g) is type(w), dest


@pytest.mark.parametrize("dataset", ["star", "paired_star", "paired_star2",
                                     "complete"])
def test_make_dataset_matches_jax(dataset):
    argv = ["--model", "egnn", "--dataset", dataset] + BASE
    want, want_args = jcli.make_dataset(jcli.build_parser().parse_args(argv))
    got, got_args = tcli.make_dataset(tcli.build_parser().parse_args(argv))
    assert got_args == want_args
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.atoms, w.atoms)
        np.testing.assert_array_equal(g.edge_index, w.edge_index)
        np.testing.assert_array_equal(g.y, w.y)
        np.testing.assert_allclose(g.pos, w.pos, atol=1e-12, rtol=0)


MODEL_FLAGS = [
    [], ["--equivariant", "--pool", "first"], ["--tp_precision", "default"],
    ["--tp_precision", "highest", "--bf16_tp_weights"],
    ["--tp_precision_scope", "prod", "--max_ell", "2", "--max_corr", "2"],
]


@pytest.mark.parametrize("flags", MODEL_FLAGS)
@pytest.mark.parametrize("dataset", ["star", "paired_star"])
def test_make_model_func_matches_jax(flags, dataset):
    for name in ("schnet", "egnn", "egnn_fused", "gvp", "tfn", "mace",
                 "mace_ff", "mpnn", "dimenet", "spherenet"):
        argv = ["--model", name, "--dataset", dataset] + flags
        want = jcli.make_model_func(jcli.build_parser().parse_args(argv))
        got = tcli.make_model_func(tcli.build_parser().parse_args(argv))
        want_kw = getattr(want, "keywords", None)
        got_kw = getattr(got, "keywords", None)
        assert got_kw == want_kw, (name, flags)
        base = getattr(got, "func", got)
        assert base is tcli.model_registry[name]
        assert base.__name__ == getattr(want, "func", want).__name__


@pytest.fixture
def captured(monkeypatch, tmp_path):
    """Both CLIs' ``main`` with the experiment itself stubbed out: what
    each passes to ``run_experiment_reg`` and the record it appends."""
    seen = {"jax": {}, "port": {}}

    def fake_run(side):
        def run(*args, **kw):
            seen[side]["run"] = kw
            return [0.5], [0.25], [1.0], 0.25, 0.0
        return run

    def fake_append(side):
        return lambda path, record: seen[side].__setitem__("record", record)

    monkeypatch.setattr(jcli, "run_experiment_reg", fake_run("jax"))
    monkeypatch.setattr(jcli, "append_result", fake_append("jax"))
    monkeypatch.setattr(tcli, "run_experiment_reg", fake_run("port"))
    monkeypatch.setattr(tcli, "append_result", fake_append("port"))
    # the JAX CLI sets these module globals; monkeypatch restores them
    monkeypatch.setattr(jtrain, "GRAD_CLIP", None)
    monkeypatch.setattr(jtrain, "LR_WARMUP", None)
    return seen


@pytest.mark.parametrize("model, dataset, warmup, want", [
    ("egnn", "paired_star", [], 50), ("egnn", "paired_star2", [], 50),
    ("egnn", "star", [], None), ("mace", "paired_star", [], None),
    ("egnn", "paired_star", ["--lr_warmup", "0"], None),
    ("tfn", "star", ["--lr_warmup", "7"], 7),
])
def test_lr_warmup_and_record_match_jax(captured, model, dataset, warmup,
                                        want):
    argv = ["--model", model, "--dataset", dataset, "--grad_clip", "0.5",
            "--checkpoint_dir", "ck", "--checkpoint_every", "2",
            "--nan_recovery", "--loss_mask"] + BASE + warmup
    jcli.main(argv)
    tcli.main(argv, device="cpu")
    assert jtrain.LR_WARMUP == want and jtrain.GRAD_CLIP == 0.5
    run = captured["port"]["run"]
    assert run["lr_warmup"] == want and run["grad_clip"] == 0.5
    for key, value in captured["jax"]["run"].items():
        assert run[key] == value, key
    assert run["loss_mask"] == (dataset == "paired_star2")
    assert captured["port"]["record"] == captured["jax"]["record"]


@pytest.mark.parametrize("precision", ["default", "tensorfloat32",
                                       "bfloat16_3x"])
def test_unported_matmul_precisions_raise(captured, monkeypatch, precision):
    """Ported: every choice runs, as the process default of
    ``precision.py`` for the run only ('default' is exact f32 on the card),
    with the TF32 flag to match; both are restored on return."""
    from geometric_message_passing_tpu_torch import precision as tprec

    stub, during = tcli.run_experiment_reg, []

    def run(*args, **kw):
        during.append((tprec.process_default(),
                       torch.backends.cuda.matmul.allow_tf32))
        return stub(*args, **kw)

    monkeypatch.setattr(tcli, "run_experiment_reg", run)
    want = {"default": "highest", "float32": "highest", "highest": "highest",
            "tensorfloat32": "tensorfloat32", "bfloat16_3x": "bfloat16_3x"}
    argv = ["--model", "egnn", "--dataset", "star", "--matmul_precision",
            precision] + BASE
    for name in (precision, "float32", "highest"):
        tcli.main(argv[:-len(BASE) - 1] + [name] + BASE, device="cpu")
        assert captured["port"]["record"]["matmul_precision"] == name
        assert during[-1] == (want[name], name == "tensorfloat32")
        assert tprec.process_default() == "highest"
        assert torch.backends.cuda.matmul.allow_tf32 is False


def test_main_runs_and_appends_a_record(tmp_path, capsys):
    results = tmp_path / "history.json"
    argv = ["--model", "egnn", "--dataset", "paired_star", "--n_data", "40",
            "--n_pairs", "2", "--fold", "5", "6", "--n_layers", "1",
            "--pool", "first", "--lr", "5e-4", "--n_epochs", "2",
            "--batch_size", "8", "--results_file", str(results)]
    mean = tcli.main(argv, device="cpu")
    tcli.main(argv + ["--n_times", "2"], device="cpu")
    assert "Test MAE " in capsys.readouterr().out
    records = json.loads(results.read_text())
    assert len(records) == 2
    jax_keys = set(vars(jcli.build_parser().parse_args(argv))) | {
        "best_val_acc", "test_acc", "train_time", "mean", "std"}
    for record in records:
        assert set(record) == jax_keys
        assert record["lr_warmup"] == 50
        assert np.isfinite(record["mean"]) and np.isfinite(record["std"])
    assert records[0]["mean"] == mean == records[0]["test_acc"][0]
    assert len(records[1]["test_acc"]) == 2
    assert records[1]["test_acc"][0] == mean   # repeat 0 is seeded alike
