"""Box-scale roofline: the whole train step at molecular-box shapes, FLOPs
and bytes counted on the CPU, the step timed on one CUDA card (port of the
repository's ``scripts/roofline_scale.py``).

    python -m geometric_message_passing_tpu_torch.experiments.roofline_scale \\
        [model ...] [--matmul_precision NAME]

``CONFIGS`` is the JAX script's table without its TPU times: each model at
its own box size (``schnet``, ``egnn`` and ``mace_ff`` at 30k atoms; ``gvp``,
``tfn_ff``, ``dimenet`` and ``spherenet`` at 10k) and model arguments
(``mace_ff`` and ``tfn_ff`` with 8192-edge chunks, ``dimenet`` with
262144-triplet chunks, ``spherenet`` with 131072 / 1048576).  The box, the
models and the step are ``bench_scale``'s (``kind_box``, ``build``,
``make_step``: cutoff 3.0, average degree 14, 8 species, seed 0; ``in_dim``
8, ``out_dim`` 1, the force fields' ``avg_num_neighbors`` the box's mean
degree; L1-sum loss, backward, Adam 1e-4, training mode), initial weights
from seed 0.

Timed on the card by ``bench_scale.bench_one`` at ``bench_scale``'s steps a
call (``model_steps``); counted once on a CPU twin holding the card model's
weights, over the same box on the CPU (``roofline_report.count_on_cpu``:
the counters cannot see the hand-written kernels on the card).  Prints one
JSON line per model: ``model``, ``nodes``, ``edges`` and the fields of
``roofline_report``'s rows (``count_s`` says how long the CPU count took,
``host_s`` the box's build).  A model whose row fails prints ``error`` and
the script exits 1 after the last row.  It needs a card and raises without
one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Optional

import torch

from .. import precision
from . import bench_scale as bs
from .bench import card_line
from .roofline_report import count_on_cpu, cpu_twin, roofline_row
from .train import seed_everything

# model -> (box nodes, model arguments): the JAX script's table
CONFIGS = {
    "schnet": (30000, dict(num_layers=4, hidden_channels=128,
                           num_filters=128)),
    "egnn": (30000, dict(num_layers=4, emb_dim=128)),
    "gvp": (10000, dict(num_layers=4)),
    "mace_ff": (30000, dict(num_layers=2, emb_dim=64, max_ell=3,
                            correlation=3, edge_chunk=8192)),
    "tfn_ff": (10000, dict(num_layers=4, emb_dim=64, max_ell=2,
                           edge_chunk=8192)),
    "dimenet": (10000, dict(num_layers=4, triplet_chunk=262144)),
    "spherenet": (10000, dict(num_layers=4, triplet_chunk=131072,
                              quad_chunk=1048576)),
}


def scale_row(name: str, n_nodes: Optional[int] = None,
              cfg: Optional[dict] = None, device="cuda",
              steps: Optional[int] = None, reps: int = 3,
              precision_name: Optional[str] = None) -> dict:
    """``name``'s row at ``n_nodes`` atoms and ``cfg`` (default: its
    ``CONFIGS`` entry), timed on ``device`` over ``steps`` steps a call
    (default ``bench_scale``'s), counted on the CPU."""
    n_default, cfg_default = CONFIGS[name]
    n_nodes = n_nodes or n_default
    cfg = dict(cfg_default if cfg is None else cfg)
    t0 = time.perf_counter()
    host = bs.kind_box(bs.box_kind(name), n_nodes)
    host_s = time.perf_counter() - t0
    avg = bs.mean_degree(host)
    model = bs.build(name, cfg, seed_everything(0), device, avg_deg=avg)
    twin = cpu_twin(model, lambda dev: bs.build(
        name, cfg, torch.Generator().manual_seed(0), dev, avg_deg=avg))
    steps = steps or bs.model_steps(name, bs.steps_per_call(n_nodes), n_nodes)
    timed = bs.bench_one(name, cfg, host.to(device), steps, reps,
                         model=model)
    del model
    t0 = time.perf_counter()
    r = count_on_cpu(bs.make_step(twin, host), twin,
                     step_time_s=timed["ms_per_step"] / 1e3)
    count_s = time.perf_counter() - t0
    card = card_line() if torch.device(device).type == "cuda" else "cpu"
    return {"model": name, "nodes": n_nodes, "edges": timed["edges"],
            **roofline_row(r, count_s, card, precision_name),
            "cfg": cfg, "host_s": host_s, "steps_timed": steps * reps,
            "peak_mem_gb": timed["peak_mem_gb"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("models", nargs="*", default=list(CONFIGS))
    ap.add_argument("--matmul_precision", choices=precision.NAMES,
                    default=None,
                    help="the process default of the float32 products "
                         "(precision.py; without it exact f32)")
    args = ap.parse_args(argv)
    for name in args.models:
        if name not in CONFIGS:
            raise SystemExit(f"roofline_scale: unknown model {name!r}; the "
                             f"table has {sorted(CONFIGS)}")
    if not torch.cuda.is_available():
        raise SystemExit("roofline_scale: needs a CUDA card")
    failed = False
    with precision.matmul_precision(args.matmul_precision):
        for name in args.models:
            try:
                row = scale_row(name, precision_name=args.matmul_precision)
            except Exception as exc:     # a row's fault: report, go on
                traceback.print_exc()
                row = bs.error_row(name, CONFIGS[name][0], exc)
                failed = True
            bs.free_device_memory()
            print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
