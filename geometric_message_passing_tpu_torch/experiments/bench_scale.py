"""Box-scale training throughput of the port on one CUDA card (port of the
repository's ``scripts/bench_scale.py``: every model of its ``MODELS``).

    python -m geometric_message_passing_tpu_torch.experiments.bench_scale \\
        [--sizes 10000,30000,100000] \\
        [--models schnet,schnet_sorted,egnn,egnn_sorted,egnn_fused,gvp,gvp_sorted,dimenet,spherenet,mace_ff,tfn_ff] \\
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
8, ``out_dim`` 1, initial weights from seed 0. ``egnn_fused``
(``EGNNFusedModel``, 4 x 128) runs K1 forward and K2 backward once a layer
(``fused_launches_per_step``). ``dimenet`` (DimeNet++ at its default
widths, 4 layers, ``triplet_chunk`` 262144) takes the box with its triplets
(about 1.7M at 10k atoms); from 50k atoms on ``remat_blocks`` and 131072-edge
chunks, from 100k ``edge_chunk`` 65536, ``rbf_in_chunk`` and one step a
call (``config``: the JAX script's rule); its triplet fold runs K3 per
chunk over the ascending ``idx_ji``, its other sums K4
(``dimenet_launches_per_step``). ``spherenet`` (4 layers,
``triplet_chunk`` 131072, ``quad_chunk`` 1048576) takes the box with its
triplets and quads (``spherenet_launches_per_step``). ``mace_ff``
(``MACEForceField``: 2 layers, emb 64, max_ell 3, correlation 3) and
``tfn_ff`` (``TFNForceField``: 4 layers, emb 64, max_ell 2) take the plain
box with ``avg_num_neighbors`` its mean degree, ``node_chunk`` 16384 and
``edge_chunk`` 8192, 16384 below 100k atoms (the JAX script's rule); every
sum of theirs is K4 (``ff_k4_launches_per_step``). The models train in
training mode (GVP-GNN's dropout on), as the JAX script applies them with
``train=True``.

Step: L1-sum loss, backward, Adam (lr 1e-4).  A call is
``max(4, min(40, 1_500_000 // n))`` steps ending in a host read of the loss
(a tenth of that, at least 2, for the models in ``HEAVY``; one for
``dimenet`` from 100k atoms: ``model_steps``); two warm calls, then 3 timed
calls on the host clock.  The box, its triplets and quads, the plans and
the copy to the card come before the timed window.

Prints one JSON line per (model, size) with the JAX script's keys
(``triplets`` and ``triplets_per_sec`` for the triplet models, ``quads``
for ``spherenet``) plus ``peak_mem_gb`` (``torch.cuda.max_memory_allocated``
over the warm and timed calls) and ``host_s`` (the box's build, triplets
and quads included, on the host); ``device`` is the card's ``nvidia-smi``
name and power limit.  A row that runs out of device memory
(``torch.cuda.OutOfMemoryError``, and only that) is run again at
``{**cfg, **FALLBACKS[name]}``, the JAX script's narrower widths, and
labelled with ``note`` (the first line of the error) and that ``cfg``. A
row that fails otherwise, or at both widths, prints ``error`` and the
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

from .. import precision
from ..datasets import create_molecular_boxes
from ..graph import GraphBatch, GraphLoader, sort_edges_by_receiver
from ..models import model_registry
from ..models.dimenet import chunk_slices
from ..ops.sorted_segsum import SegmentPlan, batch_seg_plans
from .bench import card_line
from .train import l1_sum_loss, make_tx, seed_everything

MODELS = {
    "schnet": dict(num_layers=4, hidden_channels=128, num_filters=128),
    "egnn": dict(num_layers=4, emb_dim=128),
    "egnn_sorted": dict(num_layers=4, emb_dim=128),
    "schnet_sorted": dict(num_layers=4, hidden_channels=128, num_filters=128),
    "egnn_fused": dict(num_layers=4, emb_dim=128),
    "mace_ff": dict(num_layers=2, emb_dim=64, max_ell=3, correlation=3,
                    edge_chunk=8192),
    "tfn_ff": dict(num_layers=4, emb_dim=64, max_ell=2, edge_chunk=8192),
    "gvp": dict(num_layers=4),
    "gvp_sorted": dict(num_layers=4),
    "dimenet": dict(num_layers=4, triplet_chunk=262144),
    "spherenet": dict(num_layers=4, triplet_chunk=131072,
                      quad_chunk=1048576),
}
# narrower configurations, tried on running out of device memory alone
FALLBACKS = {
    "schnet": dict(hidden_channels=64, num_filters=64),
    "dimenet": dict(hidden_channels=64, int_emb_size=32),
    "spherenet": dict(hidden_channels=64, int_emb_size=32,
                      triplet_chunk=65536),
    "egnn": dict(emb_dim=64),
    "egnn_sorted": dict(emb_dim=64),
    "schnet_sorted": dict(hidden_channels=64, num_filters=64),
    "egnn_fused": dict(emb_dim=64),
    "mace_ff": dict(emb_dim=32, edge_chunk=16384),
    "tfn_ff": dict(emb_dim=32, edge_chunk=16384),
    "gvp": dict(s_dim=64, v_dim=8),
    "gvp_sorted": dict(s_dim=64, v_dim=8),
}
SORTED = {"egnn_sorted": "egnn", "schnet_sorted": "schnet",
          "gvp_sorted": "gvp"}
FORCE_FIELDS = ("mace_ff", "tfn_ff")
HEAVY = ("dimenet", "spherenet") + FORCE_FIELDS   # a tenth of the steps
REMAT_FROM = 30_000   # GVP-GNN atoms from which the chain is rematerialised
DIMENET_CHUNK_FROM = 50_000    # DimeNet++: remat_blocks, 131072-edge chunks
DIMENET_100K_FROM = 100_000    # 65536-edge chunks, rbf_in_chunk, 1 step
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
              avg_degree: float = 14.0, triplets: bool = False,
              quads: bool = False) -> GraphBatch:
    """The benchmark's box of ``n_nodes`` atoms as one padded batch on the
    host, its edges sorted by receiver when ``sort``, with its triplets when
    ``triplets`` (and their quads when ``quads``)."""
    graphs = create_molecular_boxes(num=1, n_nodes=n_nodes, cutoff=cutoff,
                                    avg_degree=avg_degree, n_species=8, seed=0)
    if sort:
        graphs = [sort_edges_by_receiver(g) for g in graphs]
    return next(iter(GraphLoader(graphs, batch_size=1,
                                 with_triplets=triplets or quads,
                                 with_quads=quads)))


def box_kind(name: str) -> str:
    """Which box ``name`` trains on: ``'sorted'``, ``'triplets'``,
    ``'quads'`` or ``'plain'``."""
    if name in SORTED:
        return "sorted"
    return {"dimenet": "triplets", "spherenet": "quads"}.get(name, "plain")


def kind_box(kind: str, n_nodes: int, cutoff: float = 3.0,
             avg_degree: float = 14.0) -> GraphBatch:
    """``box_batch`` of one ``box_kind``."""
    return box_batch(n_nodes, kind == "sorted", cutoff, avg_degree,
                     triplets=kind == "triplets", quads=kind == "quads")


def steps_per_call(n_nodes: int) -> int:
    return max(4, min(40, 1_500_000 // n_nodes))


def model_steps(name: str, steps: int, n_nodes: int = 0) -> int:
    """Steps per call of ``name``: ``steps``, or for the models in ``HEAVY``
    a tenth, at least 2, and one for ``dimenet`` from
    ``DIMENET_100K_FROM`` atoms (the JAX script's rule)."""
    if name == "dimenet" and n_nodes >= DIMENET_100K_FROM:
        return 1
    return max(2, steps // 10) if name in HEAVY else steps


def config(name: str, n_nodes: int) -> dict:
    """``MODELS[name]`` at a box of ``n_nodes`` atoms: GVP-GNN rematerialises
    its message chain from ``REMAT_FROM`` atoms on; the force fields take
    16384-edge chunks below ``FF_WIDE_CHUNK_BELOW`` atoms; DimeNet++ takes
    ``remat_blocks`` and 131072-edge chunks from ``DIMENET_CHUNK_FROM``
    atoms, 65536-edge chunks and ``rbf_in_chunk`` from
    ``DIMENET_100K_FROM``."""
    cfg = dict(MODELS[name])
    if name in ("gvp", "gvp_sorted") and n_nodes >= REMAT_FROM:
        cfg["remat"] = True
    if name in FORCE_FIELDS and n_nodes < FF_WIDE_CHUNK_BELOW:
        cfg["edge_chunk"] = 16384
    if name == "dimenet" and n_nodes >= DIMENET_CHUNK_FROM:
        cfg.update(remat_blocks=True, edge_chunk=131072)
    if name == "dimenet" and n_nodes >= DIMENET_100K_FROM:
        cfg.update(edge_chunk=65536, rbf_in_chunk=True)
    return cfg


def dimenet_launches_per_step(cfg: dict, batch: GraphBatch) -> dict:
    """K3 and K4 launches in one training step of DimeNet++ at ``cfg`` on
    ``batch`` (pool "sum"), from ``models/dimenet.py``.  K3: the triplet
    fold, once per interaction block and triplet chunk; the backward reruns
    a checkpointed chunk's rows but not its fold (``TripletFold.sum``),
    except under ``remat_full_blocks``, where it reruns each whole block,
    folds and all (twice).  K4: each output block sums its gated edges once
    a chunk (chunked when ``edge_chunk`` is set, ``chunk_output_blocks`` on
    and ``remat_full_blocks`` off; the backward reruns a checkpointed gate,
    not its sum), plus the pool and the embedding's gradient
    (``nn.basic.Embedding``)."""
    layers = cfg.get("num_layers", 4)
    t = len(chunk_slices(batch.triplets.num_triplets,
                         cfg.get("triplet_chunk")))
    full = cfg.get("remat_full_blocks", False)
    out_chunk = (cfg.get("edge_chunk") if cfg.get("chunk_output_blocks", True)
                 and not full else None)
    e = len(chunk_slices(batch.num_edges, out_chunk))
    return {"k3": layers * t * (2 if full else 1),
            "k4": (layers + 1) * e + 2}


def spherenet_launches_per_step(cfg: dict, batch: GraphBatch) -> dict:
    """K3 and K4 launches in one training step of SphereNet at ``cfg`` on
    ``batch`` (pool "sum"), from ``models/spherenet.py``.  K3: ``update_e``'s
    triplet fold once per layer and triplet chunk (the backward reruns a
    chunk's rows, not its fold).  K4: ``init_v`` and each layer's
    ``update_v`` sum the edges into the nodes, the pool, and the
    embedding's gradient; the quads' minimum is no segment sum."""
    layers = cfg.get("num_layers", 4)
    t = len(chunk_slices(batch.triplets.num_triplets,
                         cfg.get("triplet_chunk")))
    return {"k3": layers * t, "k4": layers + 3}


def fused_launches_per_step(num_layers: int) -> dict:
    """K1, K2 and K4 launches in one training step of ``egnn_fused`` (pool
    "sum"): each layer's message pass is one K1 forward and one K2
    backward; the pool and the embedding's gradient are K4."""
    return {"k1": num_layers, "k2": num_layers, "k4": 2}


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
    return len(chunk_slices(batch.num_edges, cfg.get("edge_chunk")))


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
              reps: int = 3, model: Optional[torch.nn.Module] = None) -> dict:
    """Time ``name`` on ``batch`` (already on the card; a CPU batch times
    the CPU): two warm calls of ``steps`` steps, then ``reps`` timed calls;
    of ``model`` when given, else of ``build(name, cfg)`` from seed 0."""
    edges = int(batch.edge_mask.sum())
    nodes = int(batch.node_mask.sum())
    if model is None:
        model = build(name, cfg, seed_everything(0), batch.atoms.device,
                      avg_deg=mean_degree(batch))
    plans = batch_seg_plans(batch) if name in SORTED else None
    step = make_step(model, batch, plans)

    def call() -> float:
        for _ in range(steps):
            loss = step()
        return float(loss)          # host read: waits for the device

    on_card = batch.pos.is_cuda
    if on_card:
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
        if batch.triplets.q_mask is not None:
            extra["quads"] = int(batch.triplets.q_mask.sum())
    return {
        "model": name, "nodes": nodes, "edges": edges,
        "ms_per_step": 1000.0 / sps,
        "steps_per_sec": sps,
        "edges_per_sec_per_chip": edges * sps,
        "cfg": dict(cfg),
        "device": card_line() if on_card else "cpu",
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9 if on_card
                        else None),
        "steps_per_call": steps, "loss": loss, **extra,
    }


def bench_row(name: str, n_nodes: int, cfg: dict, batch: GraphBatch,
              steps: int) -> dict:
    """``bench_one``'s row, or, when the card runs out of memory
    (``torch.cuda.OutOfMemoryError`` and nothing else), the row of
    ``{**cfg, **FALLBACKS[name]}`` labelled with ``note``; a row that fails
    otherwise, or at both widths, is ``{"model", "nodes", "error"}``."""
    note = None
    try:
        return bench_one(name, cfg, batch, steps)
    except torch.cuda.OutOfMemoryError as exc:
        traceback.print_exc()
        note = str(exc).splitlines()[0][:120] if str(exc) else "out of memory"
    except Exception as exc:         # a fault, not a width: no retry
        traceback.print_exc()
        return error_row(name, n_nodes, exc)
    # out of the handler, so the traceback's frames and tensors are freed
    free_device_memory()
    try:
        row = bench_one(name, {**cfg, **FALLBACKS[name]}, batch, steps)
    except Exception as exc:
        traceback.print_exc()
        return error_row(name, n_nodes, exc)
    row["note"] = f"fallback config after: {note}"
    return row


def error_row(name: str, n_nodes: int, exc: BaseException) -> dict:
    text = str(exc).splitlines()[0][:160] if str(exc) else ""
    return {"model": name, "nodes": n_nodes,
            "error": f"{type(exc).__name__}: {text}"}


def free_device_memory() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=str, default="10000,30000,100000")
    ap.add_argument("--models", type=str,
                    default="schnet,schnet_sorted,egnn,egnn_sorted")
    ap.add_argument("--steps", type=int, default=0,
                    help="steps per call (0 = by size)")
    ap.add_argument("--cutoff", type=float, default=3.0)
    ap.add_argument("--avg_degree", type=float, default=14.0)
    ap.add_argument("--matmul_precision", choices=precision.NAMES,
                    default=None,
                    help="the process default of the float32 products "
                         "(precision.py; without it exact f32); each row "
                         "then names it")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_scale: needs a CUDA card")
    names = args.models.split(",")
    for name in names:
        if name not in MODELS:
            raise SystemExit(f"bench_scale: unknown model {name!r}; "
                             f"ported: {sorted(MODELS)}")
    with precision.matmul_precision(args.matmul_precision):
        return _rows(args, names)


def _rows(args, names) -> int:
    """Print each (size, model) row; 1 if a row holds an error."""
    failed = False
    for n_nodes in [int(s) for s in args.sizes.split(",")]:
        batches, host_s = {}, {}
        steps = args.steps or steps_per_call(n_nodes)
        for name in names:
            kind = box_kind(name)
            try:
                if kind not in batches:
                    t0 = time.perf_counter()
                    batches[kind] = kind_box(kind, n_nodes, args.cutoff,
                                             args.avg_degree).to("cuda")
                    host_s[kind] = time.perf_counter() - t0
            except Exception as exc:
                traceback.print_exc()
                row = error_row(name, n_nodes, exc)
            else:
                row = bench_row(name, n_nodes, config(name, n_nodes),
                                batches[kind],
                                model_steps(name, steps, n_nodes))
                row["host_s"] = host_s[kind]
            if args.matmul_precision:
                row["matmul_precision"] = args.matmul_precision
            failed |= "error" in row
            free_device_memory()
            print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
