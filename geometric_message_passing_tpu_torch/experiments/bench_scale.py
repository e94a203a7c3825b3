"""Box-scale training throughput of the port on one CUDA card (port of the
repository's ``scripts/bench_scale.py``, its SchNet, EGNN, GVP-GNN,
DimeNet++ and force-field models).

    python -m geometric_message_passing_tpu_torch.experiments.bench_scale \\
        [--sizes 10000,30000,100000] \\
        [--models schnet,schnet_sorted,egnn,egnn_sorted,gvp,gvp_sorted,dimenet,mace_ff,tfn_ff] \\
        [--steps N]

Data: one synthetic molecular box per size
(``datasets.create_molecular_boxes``: cutoff 3.0, average degree 14, 8
species, seed 0; 1,350,872 edges at 100k atoms), batched alone. The
``_sorted`` models take the receiver-sorted box and its segment plans
(``ops.sorted_segsum.batch_seg_plans``): every segment reduction and gather
backward runs the sorted segment-sum kernel (GVP-GNN's merged receiver sum
and sender gather backward; its message chain takes the plain route, not the
GVP kernel, as in the JAX script). Models at the widths of ``MODELS`` (4
layers x 128; GVP-GNN 4 layers at its defaults, 128/16 node and 32/1 edge
widths, with ``remat`` from 30k atoms on, the JAX script's rule), ``in_dim``
8, ``out_dim`` 1, initial weights from seed 0; no narrower fallback.
``dimenet`` (DimeNet++ at its default widths, 4 layers, ``triplet_chunk``
262144) takes the box with its triplets (about 1.7M at 10k atoms); its
triplet fold runs K3 per chunk over the ascending ``idx_ji``, its other sums
K4. Its 50k/100k settings (edge chunks, remat) are not ported yet:
``config`` raises from 50k atoms on. ``mace_ff`` (``MACEForceField``: 2
layers, emb 64, max_ell 3, correlation 3) and ``tfn_ff`` (``TFNForceField``:
4 layers, emb 64, max_ell 2) take the plain box with ``avg_num_neighbors``
its mean degree, ``node_chunk`` 16384 and ``edge_chunk`` 8192, 16384 below
100k atoms (the JAX script's rule); every sum of theirs is K4
(``ff_k4_launches_per_step``). The models train in training mode
(GVP-GNN's dropout on), as the JAX script applies them with ``train=True``.

Step: L1-sum loss, backward, Adam (lr 1e-4).  A call is
``max(4, min(40, 1_500_000 // n))`` steps ending in a host read of the loss
(a tenth of that, at least 2, for the models in ``HEAVY``:
``model_steps``); two warm calls, then 3 timed calls on the host clock.  The
box, the plans and the copy to the card come before the timed window.

Prints one JSON line per (model, size) with the JAX script's keys
(``triplets`` and ``triplets_per_sec`` for ``dimenet``) plus
``peak_mem_gb`` (``torch.cuda.max_memory_allocated`` over the warm and
timed calls); ``device`` is the card's ``nvidia-smi`` name and power limit.
A model that fails (out of memory, say) prints a row with ``error`` and the
script exits 1 after the last row.  It needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
import traceback
from typing import Callable, Dict, Optional

import torch

from ..datasets import create_molecular_boxes
from ..graph import GraphBatch, GraphLoader, sort_edges_by_receiver
from ..models import model_registry
from ..ops.sorted_segsum import SegmentPlan, batch_seg_plans
from .bench import card_line
from .train import l1_sum_loss, make_tx, seed_everything

MODELS = {
    "schnet": dict(num_layers=4, hidden_channels=128, num_filters=128),
    "egnn": dict(num_layers=4, emb_dim=128),
    "egnn_sorted": dict(num_layers=4, emb_dim=128),
    "schnet_sorted": dict(num_layers=4, hidden_channels=128, num_filters=128),
    "gvp": dict(num_layers=4),
    "gvp_sorted": dict(num_layers=4),
    "dimenet": dict(num_layers=4, triplet_chunk=262144),
    "mace_ff": dict(num_layers=2, emb_dim=64, max_ell=3, correlation=3,
                    edge_chunk=8192),
    "tfn_ff": dict(num_layers=4, emb_dim=64, max_ell=2, edge_chunk=8192),
}
SORTED = {"egnn_sorted": "egnn", "schnet_sorted": "schnet",
          "gvp_sorted": "gvp"}
FORCE_FIELDS = ("mace_ff", "tfn_ff")
HEAVY = ("dimenet",) + FORCE_FIELDS   # a tenth of the steps per call
REMAT_FROM = 30_000   # GVP-GNN atoms from which the chain is rematerialised
DIMENET_MAX = 50_000  # DimeNet++'s settings from here on are not ported yet
FF_WIDE_CHUNK_BELOW = 100_000   # force fields: 16384-edge chunks below this
LR = 1e-4


def mean_degree(batch: GraphBatch) -> float:
    """Live edges per live node: the force fields' ``avg_num_neighbors``."""
    return int(batch.edge_mask.sum()) / max(int(batch.node_mask.sum()), 1)


def build(name: str, cfg: dict, generator: torch.Generator, device="cuda",
          avg_deg: Optional[float] = None):
    """The registry model behind ``name`` (``_sorted`` names its plain one);
    a force field takes ``avg_deg`` (``mean_degree`` of its box) as its
    ``avg_num_neighbors``, and ``MACEForceField`` has no ``out_dim``."""
    if name in FORCE_FIELDS:
        if avg_deg is None:
            raise ValueError(f"{name} needs avg_deg, the box's mean degree")
        extra = dict(avg_num_neighbors=avg_deg)
        if name == "tfn_ff":
            extra["out_dim"] = 1
        return model_registry[name](in_dim=8, **extra, **cfg,
                                    generator=generator, device=device)
    return model_registry[SORTED.get(name, name)](
        out_dim=1, in_dim=8, **cfg, generator=generator, device=device)


def box_batch(n_nodes: int, sort: bool, cutoff: float = 3.0,
              avg_degree: float = 14.0, triplets: bool = False) -> GraphBatch:
    """The benchmark's box of ``n_nodes`` atoms as one padded batch on the
    host, its edges sorted by receiver when ``sort``, with its triplets when
    ``triplets``."""
    graphs = create_molecular_boxes(num=1, n_nodes=n_nodes, cutoff=cutoff,
                                    avg_degree=avg_degree, n_species=8, seed=0)
    if sort:
        graphs = [sort_edges_by_receiver(g) for g in graphs]
    return next(iter(GraphLoader(graphs, batch_size=1,
                                 with_triplets=triplets)))


def steps_per_call(n_nodes: int) -> int:
    return max(4, min(40, 1_500_000 // n_nodes))


def model_steps(name: str, steps: int) -> int:
    """Steps per call of ``name``: ``steps``, or for the models in ``HEAVY``
    a tenth, at least 2 (the JAX script's rule)."""
    return max(2, steps // 10) if name in HEAVY else steps


def config(name: str, n_nodes: int) -> dict:
    """``MODELS[name]`` at a box of ``n_nodes`` atoms: GVP-GNN rematerialises
    its message chain from ``REMAT_FROM`` atoms on; the force fields take
    16384-edge chunks below ``FF_WIDE_CHUNK_BELOW`` atoms."""
    cfg = dict(MODELS[name])
    if name in ("gvp", "gvp_sorted") and n_nodes >= REMAT_FROM:
        cfg["remat"] = True
    if name in FORCE_FIELDS and n_nodes < FF_WIDE_CHUNK_BELOW:
        cfg["edge_chunk"] = 16384
    if name == "dimenet" and n_nodes >= DIMENET_MAX:
        raise NotImplementedError(
            f"dimenet at {n_nodes} atoms (edge chunks, remat) is not ported "
            "yet")
    return cfg


def sorted_launches_per_step(name: str, num_layers: int,
                             remat: bool = False) -> int:
    """Sorted segment-sum kernel launches in one training step of a
    ``_sorted`` model on the card (``equivariant_pred`` off).  SchNet, per
    layer: the receiver sum and the sender gather's backward.  EGNN, per
    layer: two receiver sums (messages; position messages with the count)
    and the backward of the receiver and sender gathers of ``h``; from layer
    1 on the positions depend on the weights, so the backward of their two
    gathers runs too (layer 0's positions are data: autograd skips it).
    GVP-GNN, per layer: the merged receiver sum and the sender gather's
    backward, and with ``remat`` the receiver sum once more, when the
    backward reruns the checkpointed message pass."""
    if name == "schnet_sorted":
        return 2 * num_layers
    if name == "egnn_sorted":
        return 4 * num_layers + 2 * (num_layers - 1)
    if name == "gvp_sorted":
        return (3 if remat else 2) * num_layers
    raise ValueError(f"{name!r} is not a sorted model")


def ff_k4_launches_per_step(name: str, num_layers: int, n_chunks: int) -> int:
    """K4 launches in one training step of a force field on the card (pool
    "sum"), with ``n_chunks`` edge chunks a convolution (1 when it runs in
    one pass).  Forward: every layer's convolution sums each chunk once;
    the backward reruns each chunk's checkpointed body but not its sum
    (``_InteractionBase._conv``), and a sum's backward is a gather, so no
    more.  ``mace_ff`` pools each layer's readout (one sum a layer);
    ``tfn_ff`` pools once and its embedding's gradient is one sum
    (``nn.basic.Embedding``); ``mace_ff``'s embedding is a product."""
    if name == "mace_ff":
        return num_layers * (n_chunks + 1)
    if name == "tfn_ff":
        return num_layers * n_chunks + 2
    raise ValueError(f"{name!r} is not a force field")


def edge_chunks(cfg: dict, batch: GraphBatch) -> int:
    """Edge chunks of each convolution of a force field on ``batch``."""
    c = cfg.get("edge_chunk")
    e = batch.senders.shape[0]
    return 1 if c is None or e <= c else -(-e // c)


def make_step(model: torch.nn.Module, batch: GraphBatch,
              plans: Optional[Dict[str, SegmentPlan]] = None,
              lr: float = LR) -> Callable[[], torch.Tensor]:
    """One training step per call of the result: L1-sum loss, backward and
    an Adam step on ``model``'s parameters; returns the loss (on the
    device, not read)."""
    opt = make_tx(model.parameters(), lr)

    kw = {} if plans is None else {"seg_plans": plans}

    def step() -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = l1_sum_loss(model(batch, **kw), batch)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def bench_one(name: str, cfg: dict, batch: GraphBatch, steps: int,
              reps: int = 3) -> dict:
    """Time ``name`` on ``batch`` (already on the card): two warm calls of
    ``steps`` steps, then ``reps`` timed calls."""
    edges = int(batch.edge_mask.sum())
    nodes = int(batch.node_mask.sum())
    model = build(name, cfg, seed_everything(0), batch.atoms.device,
                  avg_deg=mean_degree(batch))
    plans = batch_seg_plans(batch) if name in SORTED else None
    step = make_step(model, batch, plans)

    def call() -> float:
        for _ in range(steps):
            loss = step()
        return float(loss)          # host read: waits for the device

    torch.cuda.reset_peak_memory_stats()
    call()
    call()
    t0 = time.perf_counter()
    for _ in range(reps):
        loss = call()
    dt = time.perf_counter() - t0
    if not math.isfinite(loss):
        raise FloatingPointError(f"{name}: loss {loss} is not finite")
    sps = steps * reps / dt
    extra = {}
    if batch.triplets is not None:
        tri = int(batch.triplets.t_mask.sum())
        extra = {"triplets": tri, "triplets_per_sec": tri * sps}
    return {
        "model": name, "nodes": nodes, "edges": edges,
        "ms_per_step": 1000.0 / sps,
        "steps_per_sec": sps,
        "edges_per_sec_per_chip": edges * sps,
        "cfg": dict(cfg),
        "device": card_line(),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "steps_per_call": steps, "loss": loss, **extra,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=str, default="10000,30000,100000")
    ap.add_argument("--models", type=str,
                    default="schnet,schnet_sorted,egnn,egnn_sorted")
    ap.add_argument("--steps", type=int, default=0,
                    help="steps per call (0 = by size)")
    ap.add_argument("--cutoff", type=float, default=3.0)
    ap.add_argument("--avg_degree", type=float, default=14.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_scale: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    names = args.models.split(",")
    for name in names:
        if name not in MODELS:
            raise SystemExit(f"bench_scale: unknown model {name!r}; "
                             f"ported: {sorted(MODELS)}")
    failed = False
    for n_nodes in [int(s) for s in args.sizes.split(",")]:
        batches = {}
        steps = args.steps or steps_per_call(n_nodes)
        for name in names:
            kind = "sorted" if name in SORTED else (
                "triplets" if name == "dimenet" else "plain")
            try:
                if kind not in batches:
                    batches[kind] = box_batch(
                        n_nodes, kind == "sorted", args.cutoff,
                        args.avg_degree, triplets=kind == "triplets").to("cuda")
                row = bench_one(name, config(name, n_nodes), batches[kind],
                                model_steps(name, steps))
            except Exception as exc:      # out of memory, say: no fallback
                traceback.print_exc()
                failed = True
                row = {"model": name, "nodes": n_nodes,
                       "error": f"{type(exc).__name__}: "
                                f"{str(exc).splitlines()[0][:160]}"}
            gc.collect()
            torch.cuda.empty_cache()
            print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
