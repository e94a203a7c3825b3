"""Where ``fit_dp`` at world 2 and at world 1 part, at the bench
configuration on one card (``dp_check``'s part c).

    python -m geometric_message_passing_tpu_torch.experiments.dp_drift

Four runs of ``dp_check``'s 5-epoch ``fit_dp``: world 2 on gloo twice in
one launch (is a run repeatable?), world 1 on gloo with CUDA tensors and
world 1 on NCCL (do the backends agree?), and world 1 on NCCL from the
same weights with one weight tensor scaled by ``1 + 2**-23`` (one f32
rounding step: how far does a rounding-sized change carry?).  Prints one
JSON line: per run the per-step summed losses and per-epoch (test, val)
rows, and per run the largest relative step-loss difference from the
world-1 NCCL run, step by step.  It needs a card.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..parallel import launch
from ..parallel.mesh import make_mesh
from . import dp_check
from .bench import card_line

NUDGE = 1.0 + 2.0 ** -23


def _row(res: dict) -> dict:
    return {"perf": res["perf"].tolist(), "losses": res["losses"].ravel()}


def world2_rank() -> dict:
    mesh = make_mesh()
    return {"first": _row(dp_check._fit(mesh)),
            "again": _row(dp_check._fit(mesh))}


def world1_rank(nudge: bool = False) -> dict:
    mesh = make_mesh()
    if nudge:
        build = dp_check.bench_model

        def nudged(device):
            model = build(device)
            with torch.no_grad():
                model.dense_0.weight.mul_(NUDGE)
            return model

        dp_check.bench_model = nudged
    return _row(dp_check._fit(mesh))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("dp_drift needs a CUDA card")
    print(card_line(), flush=True)
    two = launch.spawn(world2_rank, 2, backend="gloo", timeout_s=900)[0]
    runs = {"world2": two["first"], "world2 again": two["again"],
            "world1 gloo": launch.spawn(world1_rank, 1, backend="gloo")[0],
            "world1 nccl": launch.spawn(world1_rank, 1, backend="nccl")[0],
            "world1 nccl nudged": launch.spawn(world1_rank, 1, backend="nccl",
                                               args=(True,))[0]}
    ref = runs["world1 nccl"]["losses"]
    rel = {name: (np.abs(r["losses"] - ref) / np.abs(ref)).tolist()
           for name, r in runs.items()}
    for r in runs.values():
        r["losses"] = r["losses"].tolist()
    print(json.dumps({"runs": runs, "rel_step_loss_vs_world1_nccl": rel}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
