"""The harness on the CPU: every cell of ``BENCHMARK.json`` loads; a new
configuration, mix and cell added as files load and run with no code
edited; a misspelled name fails loudly; the result line's keys; each
fault planted under the timed path turns ``correct`` false; the trace
reader on a made-up trace."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from port_bench import faults, harness, spec
from port_bench.tests.test_portbench_reference import ATOMS, ROOT, small_cell
from port_bench.trace import Trace

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_loads_and_the_file_keeps_its_form():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                              "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and name.match(m["name"])
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"], ROOT)
        assert name.match(w["name"]) and cell.chips == 1
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer


def _added_cell(tmp_path):
    """A copy of the benchmark with one configuration, one mix and one cell
    more, each a new file (plus the ``BENCHMARK.json`` entries)."""
    pkg = tmp_path / "port_bench"
    shutil.copytree(ROOT / "port_bench", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    config = json.loads((pkg / "configs" / "mace_ff.json").read_text())
    config.update(name="mace_ff_l1", args={**config["args"], "max_ell": 1,
                                           "correlation": 2})
    (pkg / "configs" / "mace_ff_l1.json").write_text(json.dumps(config))
    (pkg / "traffic" / "tiny.json").write_text(json.dumps(
        {"atoms": ATOMS, "cutoff": 3.0, "density": 0.1237913, "species": 8,
         "frames": 1, "geometry_seed": 0}))
    (pkg / "limits" / "mace_ff_l1.tiny.train.json").write_text(
        (pkg / "limits" / "mace_ff.box10k.train.json").read_text())
    b = bench()
    b["configs"].append({"name": "mace_ff_l1", "source": "https://arxiv.org/abs/2206.07697",
                         "file": "port_bench/configs/mace_ff_l1.json",
                         "reduced": ["max_ell", "correlation"], "why": "a test"})
    b["workloads"].append({"name": "mace_ff_l1.tiny.train", "config": "mace_ff_l1",
                           "traffic": "tiny", "chips": 1, "why": "a test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("mace_ff_l1.tiny.train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return pkg


@pytest.mark.parametrize("trace", [False, True])
def test_a_cell_added_as_files_runs(tmp_path, trace):
    pkg = _added_cell(tmp_path)
    cell = spec.load_cell("mace_ff_l1.tiny.train", tmp_path, pkg)
    assert cell.config["args"]["max_ell"] == 1 and cell.mix["atoms"] == ATOMS
    r = harness.run_cell(cell, 2 ** 31 + 9, 0.2, trace, device="cpu")
    assert list(r) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert r["correct"] and r["failed"] == 0
    want = ({"frames_build_s"} if trace
            else {"setup_s", "train_atoms_per_s", "peak_mem_gib"})
    assert set(r["metrics"]) == want     # the rest need the card's trace
    assert set(r["checks"]) == {"loss_gap", "grad_gap", "update_gap"}


def test_misspelled_names_fail_loudly(tmp_path):
    with pytest.raises(spec.SpecError, match="unknown workload"):
        spec.load_cell("mace_ff.box10k.trian", ROOT)
    pkg = _added_cell(tmp_path)
    (pkg / "traffic" / "tiny.json").rename(pkg / "traffic" / "tinny.json")
    with pytest.raises(spec.SpecError, match="traffic tiny"):
        spec.load_cell("mace_ff_l1.tiny.train", tmp_path, pkg)
    (pkg / "traffic" / "tinny.json").rename(pkg / "traffic" / "tiny.json")
    (pkg / "metrics" / "step_mfu.py").unlink()
    with pytest.raises(spec.SpecError, match="step_mfu"):
        spec.load_cell("mace_ff_l1.tiny.train", tmp_path, pkg)


@pytest.mark.parametrize("workload", ["mace_ff.box10k.train",
                                      "dimenet_pp.box10k.train"])
@pytest.mark.parametrize("fault", [None, *sorted(faults.FAULTS)])
def test_a_planted_fault_turns_correct_false(workload, fault):
    cell = small_cell(workload)
    if fault is None:
        r = harness.run_cell(cell, 2 ** 31 + 3, 0.1, False, device="cpu")
        assert r["correct"]
        return
    with faults.FAULTS[fault]():
        r = harness.run_cell(cell, 2 ** 31 + 3, 0.1, False, device="cpu")
    assert not r["correct"], r["checks"]


def test_trace_reader(tmp_path):
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    events = [x("kernel", "spin_kernel(long)", 10, 1),       # range opens
              x("kernel", "segsum_block", 12, 3),
              x("kernel", "gemm", 16, 2),
              x("kernel", "spin_kernel(long)", 19, 1),       # and closes
              x("kernel", "segsum_block", 30, 5),
              x("gpu_memset", "Memset", 36, 2),
              x("cpu_op", "aten::mm", 20, 9),
              x("user_annotation", "port_bench.window", 5, 40)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tr = Trace.parse(str(path))
    assert tr.window == (5, 45) and tr.window_s == pytest.approx(40e-6)
    assert [k.name for k in tr.kernels] == ["segsum_block", "gemm", "segsum_block"]
    assert [k.ts for k in tr.in_ranges()] == [12, 16]
    assert tr.busy_s() == pytest.approx(12e-6)
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::mm"] == pytest.approx(12e-6)          # 18-30, mid 24
    assert sum(gaps.values()) == pytest.approx(28e-6)
    assert Trace.parse(str(path), window_s=1.5).window_s == 1.5


def test_study_reads_sound_control_and_fault_numbers(capsys):
    """``study.py``'s readings on the CPU at a small size: the sound run
    and the control near rounding (TF32 does not exist on the CPU), each
    fault far above."""
    from port_bench import study
    study.main(["--workload", "dimenet_pp.box10k.train", "--seeds", "7",
                "--controls", "1", "--faults", "1", "--atoms", str(ATOMS),
                "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    by = {x["reading"]: x for x in lines[:-1] if "look" not in x}
    assert set(by) == {"sound", "program_tf32", "reference_tf32",
                       *faults.FAULTS}
    assert max(by["sound"][k] for k in ("loss_gap", "grad_gap")) < 1e-4
    # an unchanged state: the median leaf's reference change over its
    # path, 1 where its steps go one way, less where they turn
    assert 0.1 < by["frozen_state"]["update_gap"] <= 1.0
    assert by["half_batch"]["loss_gap"] > 1e-2
    assert lines[-1]["sound.loss_gap"] == by["sound"]["loss_gap"]
