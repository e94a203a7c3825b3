"""The readings the limits of ``limits/<cell>.json`` are set from, in one
process on the card, at the cell's own size.

    python3 -m port_bench.study --workload mace_ff.box10k.train \\
        --seeds 101-112 --controls 3 --faults 3

For each seed, the program's checked steps (the timed path's first steps,
as a run makes them) against the plain reference: the sound readings.  On
the first ``--controls`` seeds, the controls: the program with its own
TF32 path switched on (``precision.matmul_precision("tensorfloat32")``),
and the reference itself computed with TF32 products, each against the
float32 reference.  On the first ``--faults`` seeds, each planted fault of
``faults.py``.  One JSON line a seed and reading; the last line gives, per
number, the largest sound reading and the smallest of each control and
fault.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from port_bench import check, faults, harness, spec


def seeds_of(text: str) -> list:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def program(cell, frame, batch, model, weights, context=None) -> dict:
    """The program's checked steps from ``weights`` with a fresh step
    (and optimizer), under ``context`` when given."""
    from contextlib import nullcontext
    from port_bench.reference import _adam
    _adam.load(model, weights)
    with context() if context else nullcontext():
        step = harness.make_step(model, batch)
        readings, _ = harness.checked_steps(step, model, harness.CHECK_STEPS)
    return readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--atoms", type=int, default=None,
                    help="a smaller frame (the tests' CPU rehearsal)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device
    from geometric_message_passing_tpu_torch import precision
    cell = spec.load_cell(args.workload, Path(__file__).resolve().parent.parent)
    if args.atoms:
        cell.mix = dict(cell.mix, atoms=args.atoms)
    harness.exact_f32(False)
    summary = {}

    def note(seed, kind, numbers):
        """One reading's line; the summary keeps the largest sound and the
        smallest control or fault reading of each number."""
        print(json.dumps({"seed": seed, "reading": kind, **numbers}), flush=True)
        for k, v in numbers.items():
            key = (kind, k)
            pick = max if kind == "sound" else min
            summary[key] = v if key not in summary else pick(summary[key], v)

    for i, seed in enumerate(seeds_of(args.seeds)):
        frame = harness.frames.make_frame(cell.mix, seed)
        batch, _ = harness.port_batch(cell, frame, dev)
        model = harness.port_model(cell, batch, dev)
        weights = harness.draw_weights(
            [(k, tuple(p.shape)) for k, p in model.named_parameters()],
            spec.module(cell, "reference").init_rule, seed, dev)
        runs = {"sound": program(cell, frame, batch, model, weights)}
        if i < args.controls:
            runs["program_tf32"] = program(
                cell, frame, batch, model, weights,
                lambda: precision.matmul_precision("tensorfloat32"))
        if i < args.faults:
            for name, ctx in faults.FAULTS.items():
                runs[name] = program(cell, frame, batch, model, weights, ctx)
        del model, batch
        harness.free(dev)
        ref = harness.reference_readings(cell, frame, weights, dev)
        if i < args.controls:
            runs["reference_tf32"] = harness.reference_readings(
                cell, frame, weights, dev, allow_tf32=True)
        for kind, readings in runs.items():
            note(seed, kind, check.compare(readings, ref))
            print(json.dumps({"seed": seed, "reading": kind, "look": {
                **check.worst_leaves(readings, ref),
                "losses": readings["losses"], "ref_losses": ref["losses"],
                "ref_energies": ref["energies"]}}), flush=True)
        harness.free(dev)
    print(json.dumps({f"{kind}.{k}": v for (kind, k), v in sorted(summary.items())}))
    if dev == "cuda":
        print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              "GiB", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
