"""Halo accounting for graph-partitioned molecular boxes (port of the
repository's ``scripts/halo_box_stats.py``; host work only, no card).

    python -m geometric_message_passing_tpu_torch.experiments.halo_box_stats \\
        [--sizes 10000,30000,100000] [--k 8] [--payload_dim 1024]

For each box size and rank count ``k``: Morton-partition the box
(``parallel/partition.py::morton_partition_graph``), build the packed halo
plan (``parallel/halo.py::build_halo_plan``) and print one JSON line with
the JAX script's fields: the interior / boundary structure of the Morton
and the raw index partitions (``partition_stats``) and the bytes one packed
exchange of a ``payload_dim``-float row moves against the all-gather's
(``halo_stats``; ``packed_win`` is their ratio).
"""

from __future__ import annotations

import argparse
import json
from typing import Iterator, Sequence

from ..datasets import create_molecular_boxes
from ..graph import batch_graphs, pad_sizes
from ..parallel.halo import build_halo_plan, halo_stats
from ..parallel.partition import morton_partition_graph, partition_stats


def rows(sizes: Sequence[int], ks: Sequence[int], payload_dim: int = 64 * 16,
         cutoff: float = 3.0, avg_degree: float = 14.0) -> Iterator[dict]:
    """One row per (box size, k), in that order."""
    for n_nodes in sizes:
        g = create_molecular_boxes(num=1, n_nodes=n_nodes, cutoff=cutoff,
                                   avg_degree=avg_degree, n_species=8,
                                   seed=0)[0]
        gm = morton_partition_graph(g)
        big = batch_graphs([gm], *pad_sizes([gm], 1))
        senders, receivers = big.senders.numpy(), big.receivers.numpy()
        mask = big.edge_mask.numpy()
        num_nodes = big.atoms.shape[0]
        for k in ks:
            raw = partition_stats(g.edge_index[0], g.edge_index[1],
                                  (g.num_nodes + k - 1) // k * k, k)
            mor = partition_stats(senders, receivers, num_nodes, k,
                                  edge_mask=mask)
            plan = build_halo_plan(senders, receivers, num_nodes, k,
                                   edge_mask=mask)
            st = halo_stats(plan, payload_dim=payload_dim,
                            num_nodes=num_nodes)
            yield {
                "nodes": n_nodes, "k": k,
                "edges": mor["edges"],
                "boundary_fraction_morton":
                    round(mor["boundary_fraction"], 4),
                "boundary_fraction_raw": round(raw["boundary_fraction"], 4),
                "unique_boundary_sources": mor["unique_boundary_sources"],
                "payload_dim": payload_dim,
                "wire_MB_per_exchange": round(st["wire_bytes"] / 1e6, 3),
                "allgather_MB_per_exchange":
                    round(st["allgather_bytes"] / 1e6, 3),
                "packed_win":
                    round(st["allgather_bytes"] / max(st["wire_bytes"], 1), 2),
            }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=str, default="10000,30000,100000")
    ap.add_argument("--k", type=str, default="8")
    ap.add_argument("--payload_dim", type=int, default=64 * 16,
                    help="irrep row width (default: mace_ff hidden, "
                         "64x(0e+1o+2e+3o) = 1024 floats)")
    ap.add_argument("--cutoff", type=float, default=3.0)
    ap.add_argument("--avg_degree", type=float, default=14.0)
    args = ap.parse_args(argv)
    out = []
    for row in rows([int(s) for s in args.sizes.split(",")],
                    [int(s) for s in args.k.split(",")], args.payload_dim,
                    args.cutoff, args.avg_degree):
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


if __name__ == "__main__":
    main()
