"""The plain references against the program's plain path on the CPU, at a
small size with seeded weights: energy, loss, every gradient and the
parameters after one Adam step.  Then the import rules (no JAX, nothing
of the program in a reference) and, on the card only, the control and a
sound run at a cell's own size.

    python -m pytest port_bench/tests -q        # from the repository root
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench import harness, spec
from port_bench.reference import _adam

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["mace_ff.box10k.train", "dimenet_pp.box10k.train"]
ATOMS = 90


def small_cell(workload: str, **args) -> spec.Cell:
    cell = spec.load_cell(workload, ROOT)
    cell.mix = dict(cell.mix, atoms=ATOMS)
    cell.config = dict(cell.config, args={**cell.config["args"], **args})
    return cell


def both_sides(cell: spec.Cell, seed: int = 3):
    """The program's model and one-step results, and the reference's, from
    one set of drawn weights on one frame."""
    frame = harness.frames.make_frame(cell.mix, seed)
    batch, _ = harness.port_batch(cell, frame, "cpu")
    model = harness.port_model(cell, batch, "cpu")
    weights = harness.draw_weights(
        [(k, tuple(p.shape)) for k, p in model.named_parameters()],
        spec.module(cell, "reference").init_rule, seed, "cpu")
    ref = spec.module(cell, "reference")
    graph = ref.make_graph(torch.from_numpy(frame.pos),
                           torch.from_numpy(frame.atoms), cell.mix["cutoff"],
                           cell.config["triplets"])
    rmodel = ref.build(cell.config["args"], graph)
    _adam.load(model, weights)
    _adam.load(rmodel, weights)
    return frame, batch, model, graph, rmodel, ref


@pytest.mark.parametrize("workload", CELLS)
def test_reference_matches_program(workload):
    cell = small_cell(workload)
    frame, batch, model, graph, rmodel, ref = both_sides(cell)
    with torch.no_grad():
        e_prog = float(model(batch)[0, 0])
        e_ref = float(ref.atom_energies(rmodel, graph, chunks=False).sum())
    # float32 sums of 1e3-1e5 terms added in other orders (the program's
    # segment sums and chunks against index_add_) differ by ~1e-6
    assert abs(e_prog - e_ref) <= 1e-5 * max(abs(e_ref), 1.0)

    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    loss_prog = float(harness.make_step(model, batch)())
    out = _adam.train_steps(rmodel, lambda: ref.atom_energies(rmodel, graph, False),
                            frame.y, 1, harness.LR)
    assert abs(loss_prog - out["losses"][0]) <= 1e-5 * max(out["losses"][0], 1.0)
    for k, p in rmodel.named_parameters():
        g_ref = p.grad if p.grad is not None else torch.zeros_like(p)
        scale = float(g_ref.abs().max()) or 1.0
        # the same reordering carried through the backward: each entry
        # within 1e-4 of the leaf's largest
        assert float((params[k].grad - g_ref).abs().max()) <= 1e-4 * scale, k
        # Adam's first update is lr g / (|g| + eps): equal to 1e-3 lr where
        # the gradient stands clear of rounding (over a thousandth of the
        # leaf's largest), elsewhere its sign may flip (2 lr at most); each
        # side's new value also rounds to float32 (an ulp of |p|, 2^-23 |p|)
        diff = ((params[k].detach() - start[k]) - (p.detach() - start[k])).abs()
        diff = diff - 2.0 ** -22 * start[k].abs()
        clear = g_ref.abs() > 1e-3 * scale
        assert float(torch.where(clear, diff, 0.0).max()) <= 1e-3 * harness.LR, k
        assert float(diff.max()) <= 2.0 * harness.LR * (1 + 1e-3), k


def test_references_import_nothing_of_the_program():
    for path in list((ROOT / "port_bench" / "reference").glob("*.py")) + \
            list((ROOT / "port_bench" / "counts").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "geometric_message_passing_tpu_torch", *harness.FORBIDDEN), \
                    (path.name, name)
    code = ("import sys, port_bench.reference.mace_ff, "
            "port_bench.reference.dimenet_pp, port_bench.counts.mace_ff, "
            "port_bench.counts.dimenet_pp; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    top = json.loads(out.strip().splitlines()[-1].replace("'", '"'))
    assert "geometric_message_passing_tpu_torch" not in top
    assert not set(top) & set(harness.FORBIDDEN)


def test_dry_pass_loads_no_jax():
    """A CPU pass of the harness, traced, in a fresh process: no module
    whose top-level name is JAX's or the JAX package's is loaded."""
    code = f"""
import json, sys
from pathlib import Path
from port_bench import harness, spec
cell = spec.load_cell("dimenet_pp.box10k.train", Path("."))
cell.mix = dict(cell.mix, atoms={ATOMS})
r = harness.run_cell(cell, 2**31 + 5, 0.2, True, device="cpu")
print(json.dumps([r["correct"], sorted({{m.split('.')[0] for m in sys.modules}})]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    correct, top = json.loads(out.strip().splitlines()[-1])
    assert correct
    assert "geometric_message_passing_tpu_torch" in top
    assert not set(top) & set(harness.FORBIDDEN), top


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS + ["mace_ff.water10k.train"])
def test_control_fails_and_program_passes_on_the_card(card, workload):
    """At the cell's own size: the program's checked steps pass the
    limits; the reference computed with TF32 products in the program's
    place (the control) fails one of them."""
    cell = spec.load_cell(workload, ROOT)
    seed = 2 ** 31 + 77
    frame = harness.frames.make_frame(cell.mix, seed)
    batch, _ = harness.port_batch(cell, frame, "cuda")
    model = harness.port_model(cell, batch, "cuda")
    weights = harness.draw_weights(
        [(k, tuple(p.shape)) for k, p in model.named_parameters()],
        spec.module(cell, "reference").init_rule, seed, "cuda")
    _adam.load(model, weights)
    prog, _ = harness.checked_steps(harness.make_step(model, batch), model,
                                    harness.CHECK_STEPS)
    del model, batch
    harness.free("cuda")
    ref = harness.reference_readings(cell, frame, weights, "cuda")
    control = harness.reference_readings(cell, frame, weights, "cuda",
                                         allow_tf32=True)
    from port_bench import check
    assert check.judge(check.compare(prog, ref), cell.limits)[0]
    assert not check.judge(check.compare(control, ref), cell.limits)[0]
