"""The port's twin of ``__graft_entry__.py::dryrun_multichip``
(``experiments/dryrun_multichip.py``) at world 4 on gloo CPU ranks: every
part held to its single-rank result within the tolerances its module
states, the launches of the CPU run (every kernel's plain version: none),
and the summary line in the JAX function's format.  Only the port runs
here (each part's reference is its own single-rank run), so no JAX is
imported."""

import re

import pytest

from geometric_message_passing_tpu_torch.experiments import dryrun_multichip

PARTS = ("dp", "zero_dp", "gp_v0", "gp_packed", "gp_packed_overlapped",
         "gp_mace", "tp_mace", "tp_tfn", "dp_tp", "hybrid_fit_dp", "pp",
         "serve")


@pytest.fixture(scope="module")
def dryrun():
    return dryrun_multichip.run(world=4, device="cpu", timeout_s=240)


def test_every_part_matches_its_single_rank_result(dryrun):
    _, read, fails = dryrun
    assert fails == []
    assert tuple(read["parts"]) == PARTS
    parts = read["parts"]
    tol = dryrun_multichip.TOL
    for name in ("dp", "zero_dp", "tp_mace", "dp_tp", "pp"):
        assert parts[name]["loss_rel"] <= tol, name
    assert parts["dp"]["param_err"] <= tol
    assert parts["zero_dp"]["param_err"] <= tol
    for name in ("gp_v0", "gp_packed", "gp_packed_overlapped"):
        assert parts[name]["err"] <= tol, name
    assert parts["gp_mace"]["grad_excess"] <= 0
    assert parts["hybrid_fit_dp"]["rel"] <= dryrun_multichip.FIT_TOL
    assert parts["serve"] == {**parts["serve"], "shape": [8, 1],
                              "bitwise": True}
    st = parts["gp_mace"]["halo"]
    assert st["k"] == 4 and 0 < st["useful_bytes"] <= st["wire_bytes"]


def test_cpu_ranks_launch_no_kernel(dryrun):
    _, read, _ = dryrun
    assert read["devices"] == ["cpu"] * 4
    for part, ranks in read["launches_per_rank"].items():
        assert all(set(r.values()) == {0} for r in ranks), part


def test_summary_line_has_the_jax_format(dryrun):
    line, _, _ = dryrun
    assert re.fullmatch(
        r"dryrun_multichip ok: dp loss=\d+\.\d{4}, zero-dp loss=\d+\.\d{4}, "
        r"tp loss=\d+\.\d{4}, dpxtp loss=[\d.]+, hybrid-mesh fit_dp "
        r"best_val=[\d.]+, pp loss=\d+\.\d{4}, gp out shape=\(32, 16\), "
        r"gp_mace loss=\d+\.\d{4} \(halo \d+B wire vs \d+B all-gather per "
        r"exchange\)", line), line
