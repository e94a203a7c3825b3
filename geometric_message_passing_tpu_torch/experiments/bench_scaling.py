"""Data-parallel scaling bench: edges per second of the dp train step at
one or more world sizes (port of the repository's
``scripts/bench_scaling.py``).

    python -m geometric_message_passing_tpu_torch.experiments.bench_scaling \\
        [--worlds 1] [--device cpu] [--steps 50]

Each world is one ``parallel.launch.spawn`` of ``world`` ranks: NCCL on the
card, gloo on CPU ranks (``--device cpu``).  The JAX script's workload:
``EGNNModel`` 4 layers x 128, ``in_dim`` / ``out_dim`` 1 (initial weights
from seed 0 on every rank), 32 star graphs a rank (folds 5-7, seed 0;
``32 * world`` graphs, split by ``parallel/data.py::shard_of`` into
shards padded to one bucket), Adam 1e-4, L1-sum loss,
``parallel/data.py::dp_train_step``; one warm step, then ``--steps`` timed
steps ending in a host read of the loss.  ``edges_per_sec`` counts every
graph's edges once a step (the JAX script's ``edges_per_step``) over the
slowest rank's time.

One H100 takes world 1 only: NCCL refuses two ranks on one GPU, and ranks
that share a card measure no scaling, so worlds above 1 run on CPU ranks
(they share the host's cores: they check the harness, as the JAX script's
CPU mesh does).  Prints one JSON line per world with the JAX script's
fields (``devices``, ``edges_per_sec``, ``edges_per_sec_per_chip``,
``scaling_efficiency_vs_1``, ``step_ms``) plus ``edges_per_step``,
``backend`` and ``device`` (the card's ``nvidia-smi`` name and power limit,
or ``cpu``).
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from ..datasets import create_star_graphs
from ..graph import pad_sizes
from ..models import EGNNModel
from ..parallel import launch
from ..parallel.data import dp_train_step, shard_of
from ..parallel.mesh import make_mesh
from .bench import card_line
from .train import l1_sum_loss, make_tx, seed_everything

STEPS, GRAPHS_PER_RANK, LR = 50, 32, 1e-4


def workload(world: int, graphs_per_rank: int = GRAPHS_PER_RANK):
    """The star graphs of a world, their bucket and edges a step."""
    graphs = create_star_graphs(num=graphs_per_rank * world, fold=[5, 6, 7],
                                dim=3, seed=0)
    return (graphs, pad_sizes(graphs, graphs_per_rank),
            sum(g.num_edges for g in graphs))


def rank_main(steps: int, graphs_per_rank: int, device) -> dict:
    """One rank: its shard, the dp step, the timed loop; its seconds."""
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_mesh((world,), ("dp",), device=device)
    graphs, pad, edges = workload(world, graphs_per_rank)
    shard = shard_of(graphs, world, rank, *pad).to(mesh.device)
    model = EGNNModel(num_layers=4, emb_dim=128, in_dim=1, out_dim=1,
                      generator=seed_everything(0), device=mesh.device)
    step = dp_train_step(model, make_tx(model.parameters(), LR), mesh,
                         l1_sum_loss)
    float(step(shard))                  # warm
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(shard)
    loss = float(loss)                  # host read: waits for the device
    return {"seconds": time.perf_counter() - t0, "edges_per_step": edges,
            "loss": loss}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worlds", type=str, default="1")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--graphs_per_rank", type=int, default=GRAPHS_PER_RANK)
    args = ap.parse_args(argv)
    worlds = [int(w) for w in args.worlds.split(",")]
    on_card = args.device == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise SystemExit("bench_scaling: needs a CUDA card (or --device "
                             "cpu)")
        if max(worlds) > torch.cuda.device_count():
            raise SystemExit(
                f"bench_scaling: a world of {max(worlds)} on "
                f"{torch.cuda.device_count()} card(s): NCCL needs one card "
                "a rank, and ranks sharing a card measure no scaling")
        where = card_line()
    else:
        where = "cpu"
    rows, base = [], None
    for k in sorted(set(worlds)):
        res = launch.spawn(rank_main, k, backend="nccl" if on_card else "gloo",
                           device=None if on_card else "cpu",
                           args=(args.steps, args.graphs_per_rank,
                                 None if on_card else "cpu"))
        dt = max(r["seconds"] for r in res)
        eps = res[0]["edges_per_step"] * args.steps / dt
        base = base or eps
        rows.append({"devices": k, "edges_per_sec": eps,
                     "edges_per_sec_per_chip": eps / k,
                     "scaling_efficiency_vs_1": eps / (base * k),
                     "step_ms": dt / args.steps * 1e3,
                     "edges_per_step": res[0]["edges_per_step"],
                     "backend": "nccl" if on_card else "gloo",
                     "device": where, "loss": res[0]["loss"]})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
