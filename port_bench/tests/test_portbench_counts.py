"""``counts/<config>.py`` against what they count: the flops against
``FlopCounterMode`` over the plain reference's step (no checkpoint, so no
recompute), and the K3 / K4 call lists against the shapes the program's
plain segment sums and triplet fold receive on the CPU over one step."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import harness, spec
from port_bench.tests.test_portbench_reference import both_sides, small_cell

# small chunks, so that the chunked paths (and their padded tails) run
CHUNKS = {"mace_ff.box10k.train": {"edge_chunk": 256},
          "dimenet_pp.box10k.train": {"triplet_chunk": 1000}}


@pytest.mark.parametrize("workload", sorted(CHUNKS))
def test_flops_equal_the_reference_step(workload):
    cell = small_cell(workload, **CHUNKS[workload])
    frame, batch, _, graph, rmodel, ref = both_sides(cell)
    with torch.no_grad():
        ref.atom_energies(rmodel, graph, chunks=False)   # the geometry, once
    with FlopCounterMode(display=False) as fc:
        loss = (ref.atom_energies(rmodel, graph, chunks=False).sum()
                - frame.y).abs()
        loss.backward()
    shapes = harness.shapes(batch)
    counted = spec.module(cell, "counts").flops(cell.config["args"], shapes)
    assert shapes["edges"] == graph["senders"].shape[0]
    assert abs(counted - fc.get_total_flops()) <= 0.01 * fc.get_total_flops()


def _record(monkeypatch):
    """Record ``(rows, width, segments, mask, acc)`` of every K4 and K3 call
    the program makes on the CPU (its plain versions)."""
    from geometric_message_passing_tpu_torch.models import dimenet
    from geometric_message_passing_tpu_torch.ops import scatter
    calls = {"k4": [], "k3": []}
    plain, fold = scatter.segment_sum_plain, dimenet.sorted_fold

    def k4(data, ids, n, mask=None):
        calls["k4"].append((data.shape[0], data[0].numel(), n,
                            mask is not None, False))
        return plain(data, ids, n, mask)

    def k3(data, ids, plan, mask=None, acc=None):
        calls["k3"].append((data.shape[0], data[0].numel(), plan.num_segments,
                            mask is not None, acc is not None))
        return fold(data, ids, plan, mask, acc=acc)
    monkeypatch.setattr(scatter, "segment_sum_plain", k4)
    monkeypatch.setattr(dimenet, "sorted_fold", k3)
    return calls


@pytest.mark.parametrize("workload", sorted(CHUNKS))
def test_segment_sum_calls_equal_the_programs(workload, monkeypatch):
    cell = small_cell(workload, **CHUNKS[workload])
    _, batch, model, _, _, _ = both_sides(cell)
    calls = _record(monkeypatch)
    harness.make_step(model, batch)()
    counts = spec.module(cell, "counts")
    shapes = harness.shapes(batch)
    args = cell.config["args"]
    assert sorted(calls["k4"]) == sorted(counts.k4_calls(args, shapes))
    assert sorted(calls["k3"]) == sorted(counts.k3_calls(args, shapes))
    assert calls["k4"] and (calls["k3"] or not counts.K3_IN_INTERACTIONS)
