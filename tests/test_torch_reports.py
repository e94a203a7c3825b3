"""The port's twins of the JAX tree's report scripts that run no roofline:
``experiments/validate_accuracy.py`` (its table against
``scripts/validate_accuracy.py``, one row through its child process on the
CPU, a failing row), ``experiments/halo_box_stats.py`` (its rows equal to
the JAX script's) and ``experiments/bench_scaling.py`` (gloo CPU ranks at
worlds 1 and 2: the JAX script's fields and edge count)."""

import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu_torch.experiments import (bench_scaling,
                                                             halo_box_stats,
                                                             validate_accuracy
                                                             as va)

ROOT = Path(__file__).resolve().parent.parent
JAX_SCALING_FIELDS = ("devices", "edges_per_sec", "edges_per_sec_per_chip",
                      "scaling_efficiency_vs_1", "step_ms")


def _load(script: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{script}", ROOT / "scripts" / f"{script}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_sweep_table_is_the_jax_scripts():
    jax_script = _load("validate_accuracy")
    assert va.CONFIGS == jax_script.CONFIGS
    assert va.BASE == jax_script.BASE
    assert len(va.CONFIGS) == 18 and len(va.selected()) == 18
    assert [r[:2] for _, r in va.selected(["egnn"])] == [
        ("egnn", "star"), ("egnn", "paired_star"), ("egnn", "paired_star2"),
        ("egnn", "star")]
    argv = va.child_argv("tfn", "star", ["--fold", "5"], ["--n_epochs", "1"],
                         "r.json")
    assert argv[:4] == ["--model", "tfn", "--dataset", "star"]
    assert argv[4:4 + len(va.BASE)] == va.BASE
    assert argv[4 + len(va.BASE):] == ["--fold", "5", "--n_epochs", "1",
                                       "--results_file", "r.json"]


def test_sweep_row_runs_its_child_on_the_cpu(tmp_path):
    model, dataset, ref, flags = va.CONFIGS[3]
    assert (model, dataset) == ("egnn", "star")
    ledger = tmp_path / "ledger.json"
    row = va.run_row(model, dataset, ref, flags,
                     extra=["--n_epochs", "1", "--n_data", "40"],
                     device="cpu", ledger=str(ledger))
    assert row["status"] == "ok", row.get("tail")
    assert math.isfinite(row["mean"]) and math.isfinite(row["std"])
    assert len(row["test_maes"]) == 3 and len(row["s_per_run"]) == 3
    assert row["mean"] == pytest.approx(
        sum(row["test_maes"]) / 3, abs=1e-5)
    (record,) = json.loads(ledger.read_text())
    assert (record["model"], record["n_epochs"], record["n_data"],
            record["n_times"], record["fold"]) == ("egnn", 1, 40, 3, [7])
    assert record["cosine"] and record["lr"] == 5e-4


def test_failing_row_fails_the_sweep_and_is_named(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.setattr(va, "CONFIGS", [
        ("egnn", "star", 0.1, ["--no_such_flag"])])
    monkeypatch.chdir(tmp_path)
    assert va.main(["egnn", "--results_file", "ledger.json"],
                   device="cpu") == 1
    assert "egnn/star" in capsys.readouterr().err
    (row,) = json.loads((tmp_path / va.SWEEP_FILE).read_text())
    assert row["status"] == "FAILED rc=2" and math.isnan(row["mean"])
    assert not (tmp_path / "ledger.json").exists()
    assert va.failed([row]) == ["egnn/star"]


def test_halo_rows_equal_the_jax_scripts():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "halo_box_stats.py"),
         "--sizes", "2000", "--k", "2,4"], capture_output=True, text=True,
        env=env, timeout=120, check=True)
    want = [json.loads(line) for line in out.stdout.splitlines()]
    got = halo_box_stats.main(["--sizes", "2000", "--k", "2,4"])
    assert len(want) == 2 and got == want
    assert all(r["packed_win"] > 1 for r in got)


def test_scaling_rows_on_gloo_cpu_ranks():
    rows = bench_scaling.main(["--device", "cpu", "--worlds", "1,2",
                               "--steps", "2"])
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        k = r["devices"]
        assert set(JAX_SCALING_FIELDS) <= set(r)
        want = sum(g.num_edges for g in jds.create_star_graphs(
            num=32 * k, fold=[5, 6, 7], dim=3, seed=0))
        assert r["edges_per_step"] == want
        assert r["edges_per_sec"] == pytest.approx(
            want / (r["step_ms"] / 1e3), rel=1e-9)
        assert r["edges_per_sec_per_chip"] == pytest.approx(
            r["edges_per_sec"] / k)
        assert (r["backend"], r["device"]) == ("gloo", "cpu")
        assert math.isfinite(r["loss"])
    assert rows[0]["scaling_efficiency_vs_1"] == 1.0
    assert rows[1]["scaling_efficiency_vs_1"] == pytest.approx(
        rows[1]["edges_per_sec"] / (2 * rows[0]["edges_per_sec"]))


def test_card_entries_need_a_card(monkeypatch):
    import torch

    from geometric_message_passing_tpu_torch.experiments import (
        roofline_report, roofline_scale)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((bench_scaling.main, []),
                       (roofline_report.main, ["egnn"]),
                       (roofline_scale.main, ["schnet"])):
        with pytest.raises(SystemExit, match="needs a CUDA card"):
            main(argv)
