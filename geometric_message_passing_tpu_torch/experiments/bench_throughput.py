"""Per-model training-step throughput on one CUDA card, in edges per second
(port of the repository's ``scripts/bench_throughput.py``).

    python -m geometric_message_passing_tpu_torch.experiments.bench_throughput \\
        [model ...]

Models and depths are the JAX script's ``MODELS`` table; the port builds
``schnet``, ``egnn``, ``egnn_fused`` (per-layer kernels K1/K2), ``egnn_stack``
(``EGNNFusedModel(fuse_stack=True)``, the whole-stack kernel K6), ``gvp`` and
``tfn`` (4 layers, max_ell 3 at its default widths: the per-edge CG
contraction kernel K7 and the segment sum K4), ``mace`` (2 layers, max_ell
3, correlation 3 at its default widths: K7 and K4 in its convolutions, the
symmetric contraction in PyTorch products), ``dimenet`` (DimeNet++, 4
layers) and ``spherenet`` (2 layers) at their default widths (the triplet
fold on K3, the other sums on K4), and runs them all by default.

Data: 100 star graphs (fold 5/6/7, target max angle, seed 0) as one padded
batch of 100 on the card, with its triplets for ``dimenet`` and its triplets
and quads for ``spherenet``, as the JAX script pads them. Model: the
registry's defaults at ``out_dim`` 1 and the table's layer count, initial
weights from seed 0. Step: L1-sum loss, backward, Adam (lr 5e-4), in
training mode (GVP-GNN's dropout on, drawn from the model's own generator,
where the JAX script reuses one key for every step). A call is 100 steps
ending in a host read of the last loss; two warm calls, then three timed
calls on the host clock.  The JAX script scans its 100 steps inside one
device program; the port runs them as eager steps, so its number includes
the host's launches and is not comparable with the JAX script's TPU
numbers.

``--output-layer`` instead times a model's output layer alone
(``output_layer_cost``): ``nn.basic.OutputLinear`` against
``torch.nn.Linear`` at the batch's pooled shape.

Prints one JSON line per model with the JAX script's keys (``model``,
``num_layers``, ``edges_per_batch``, ``steps_per_sec``,
``edges_per_sec_per_chip``, ``edges_per_sec_per_chip_per_layer``) and
``device``, the card's ``nvidia-smi`` name and power limit.  It needs a card
and raises without one.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional

import torch

from .. import datasets as ds
from ..graph import GraphBatch, GraphLoader, pad_sizes
from ..models import EGNNFusedModel, model_registry
from ..nn.basic import OutputLinear, linear
from .bench import card_line
from .train import l1_sum_loss, make_tx, seed_everything

# the JAX script's table (reference-config layer counts)
MODELS = {
    "schnet": dict(num_layers=4),
    "egnn": dict(num_layers=4),
    "egnn_fused": dict(num_layers=4),
    "egnn_stack": dict(num_layers=4),
    "gvp": dict(num_layers=4),
    "tfn": dict(num_layers=4, max_ell=3),
    "mace": dict(num_layers=2, max_ell=3, correlation=3),
    "dimenet": dict(num_layers=4),
    "spherenet": dict(num_layers=2),
}
TRIPLETS = {"dimenet": False, "spherenet": True}   # name -> with quads
STEPS, REPS, WARM, LR = 100, 3, 2, 5e-4


def check_names(names) -> None:
    """Raise on a name outside the table."""
    for name in names:
        if name not in MODELS:
            raise ValueError(f"unknown model {name!r}; the table has "
                             f"{sorted(MODELS)}")


def build(name: str, generator: torch.Generator, device="cuda", **kw):
    """The model behind ``name`` at the table's depth and ``out_dim`` 1
    (``kw`` overrides the table's and the defaults' arguments)."""
    check_names([name])
    cfg = {**MODELS[name], **kw, "out_dim": 1, "generator": generator,
           "device": device}
    if name == "egnn_fused":
        return EGNNFusedModel(**cfg)
    if name == "egnn_stack":
        return EGNNFusedModel(fuse_stack=True, **cfg)
    return model_registry[name](**cfg)


def star_batch(num: int = 100, batch_size: int = 100, device="cuda",
               name: str = "") -> GraphBatch:
    """The JAX script's batch for model ``name``: the first padded batch of
    ``num`` star graphs (fold 5/6/7, seed 0), with triplets (and quads) for
    the directional models, on ``device``."""
    data = ds.create_star_graphs(num=num, fold=[5, 6, 7], dim=3, target="max",
                                 seed=0)
    needs_tri = name in TRIPLETS
    loader = GraphLoader(data, batch_size=batch_size,
                         pad=pad_sizes(data, batch_size),
                         with_triplets=needs_tri,
                         with_quads=TRIPLETS.get(name, False))
    return next(iter(loader)).to(device)


def make_step(model: torch.nn.Module, batch: GraphBatch,
              lr: float = LR) -> Callable[[], torch.Tensor]:
    """One training step per call of the result, in training mode: L1-sum
    loss, backward and an Adam step; returns the loss on the device."""
    opt = make_tx(model.parameters(), lr)
    model.train()

    def step() -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = l1_sum_loss(model(batch), batch)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def bench_one(name: str, batch: GraphBatch, steps: int = STEPS,
              reps: int = REPS, warm: int = WARM,
              model: Optional[torch.nn.Module] = None) -> dict:
    """Time ``name``'s train step on ``batch`` (on the card; a CPU batch
    times the CPU), of ``model`` when given, else of ``build(name)`` from
    seed 0."""
    if model is None:
        model = build(name, seed_everything(0), batch.pos.device)
    step = make_step(model, batch)

    def call() -> float:
        for _ in range(steps):
            loss = step()
        return float(loss)          # host read: waits for the device

    for _ in range(warm):
        call()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    sps = steps * reps / (time.perf_counter() - t0)
    edges = int(batch.edge_mask.sum())
    layers = MODELS[name]["num_layers"]
    return {"model": name, "num_layers": layers, "edges_per_batch": edges,
            "steps_per_sec": sps, "edges_per_sec_per_chip": edges * sps,
            "edges_per_sec_per_chip_per_layer": edges * sps / layers,
            "device": card_line() if batch.pos.is_cuda else "cpu"}


def output_layer_cost(rows: int = 100, width: int = 128, out: int = 1,
                      iters: int = 2000) -> dict:
    """A model's output layer alone, forward and backward (``y.sum()``'s
    gradient into the input and the parameters) on the card at ``[rows,
    width] -> out`` (the star batch's 100 pooled graphs, 128 wide):
    ``OutputLinear`` (W^T copied, one ``addmm``) against ``torch.nn.Linear``
    (``F.linear``).  Host microseconds a call over ``iters`` calls ending
    in a synchronize, in the order Linear, OutputLinear, OutputLinear,
    Linear; device kernels and ms a call by the profiler."""
    from .bench_kernels import kernel_launches
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(rows, width, generator=gen).cuda().requires_grad_()
    layers = {cls.__name__: linear(width, out, torch.Generator().manual_seed(1),
                                   cls).cuda()
              for cls in (torch.nn.Linear, OutputLinear)}

    def call(layer):
        layer(x).sum().backward()

    def host_us(layer) -> float:
        for _ in range(20):
            call(layer)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            call(layer)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e6

    res = {name: {"host_us": []} for name in layers}
    for name in ("Linear", "OutputLinear", "OutputLinear", "Linear"):
        res[name]["host_us"].append(host_us(layers[name]))
    for name, layer in layers.items():
        split = kernel_launches(lambda layer=layer: call(layer), 50)
        res[name].update(device_ms=sum(v["ms"] for v in split.values()),
                         kernels=sum(v["launches"] for v in split.values()),
                         split=split)
    return dict(res, shape=[rows, width, out], iters=iters,
                device=card_line())


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("models", nargs="*", default=list(MODELS))
    ap.add_argument("--output-layer", action="store_true",
                    help="time the output layer alone (output_layer_cost)")
    args = ap.parse_args(argv)
    check_names(args.models)
    if not torch.cuda.is_available():
        raise SystemExit("bench_throughput: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.output_layer:
        res = output_layer_cost()
        print(json.dumps(res), flush=True)
        return [res]
    batches = {}
    rows = []
    for name in args.models:
        kind = TRIPLETS.get(name)
        if kind not in batches:
            batches[kind] = star_batch(name=name)
        rows.append(bench_one(name, batches[kind]))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
