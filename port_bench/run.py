"""Run one cell of the port's benchmark and print its result line.

    python3 -m port_bench.run --workload mace_ff.box10k.train --seed 7 \\
        --seconds 10 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, this directory
and the program (``geometric_message_passing_tpu_torch``).  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer
metrics from a traced window; both check the first training steps against
the plain reference (``check.py``).  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last); the
last lines of standard error give each compared number beside its limit.
Exits 2 without enough CUDA cards, 3 if JAX or the JAX package was
loaded, printing no result either way.
"""

import time

T_START = time.perf_counter()      # before the imports: set-up starts here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from port_bench import harness, spec

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"port_bench: loaded {bad}; the benchmark runs without JAX",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
