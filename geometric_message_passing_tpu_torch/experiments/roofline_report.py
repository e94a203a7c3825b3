"""Whole-step roofline of the seven star train steps: FLOPs and bytes
counted on the CPU, the step timed on one CUDA card (port of the
repository's ``scripts/roofline_report.py``).

    python -m geometric_message_passing_tpu_torch.experiments.roofline_report \\
        [model ...] [--matmul_precision NAME]

Models and depths are the JAX script's ``LAYERS`` (each at its registry
widths, ``out_dim`` 1); the step is the throughput bench's
(``bench_throughput.build / star_batch / make_step``: 100 star graphs on
folds 5-7 as one batch of 100, L1-sum loss, backward, Adam 5e-4, training
mode), initial weights from seed 0.

Timed on the card: ``bench_throughput.bench_one`` (2 warm calls of 100
steps, then 3 timed calls ending in a host read of the loss), so
``step_ms`` is the throughput bench's step, host launches included.

Counted on the CPU: the card model's ``state_dict`` is copied into a CPU
twin of the same model, whose step runs once over the same batch on the
CPU under ``utils.roofline.roofline`` (``FlopCounterMode`` and the aten op
counter; the plain versions of K1-K7 there).  On the card the counters
would miss the hand-written kernels, which are launched through ``ctypes``
below the dispatcher; the plain versions compute the same function, so
the count does not change when a kernel does.  ``count_on_cpu`` raises on a
step that touches a tensor off the CPU.  The JAX script also counts on the host
CPU; its ``MEASURED_MS`` (TPU times) are not used.

Prints one JSON line per model: the JAX row's fields (``gflops_per_step``,
``mb_per_step``, ``intensity_flop_per_byte``, ``static_bound``, ``step_ms``,
``achieved_tflops``, ``achieved_gbps``, ``frac_of_roof`` against the H100's
67 TFLOP/s f32 and 3.35 TB/s, not clipped: the bytes are an upper bound)
plus the unrounded counts, ``counted_on`` ("cpu"), ``count_s`` (the
count's seconds), ``precision`` (exact f32 unless ``--matmul_precision``)
and ``device`` (the card's ``nvidia-smi`` name and power limit).  It needs
a card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .. import precision
from ..utils.roofline import Roofline, roofline
from . import bench_throughput as bt
from .bench import card_line
from .train import seed_everything

# the JAX script's table (reference-config layer counts)
LAYERS = {
    "schnet": dict(num_layers=4), "egnn": dict(num_layers=4),
    "gvp": dict(num_layers=4), "tfn": dict(num_layers=4, max_ell=3),
    "mace": dict(num_layers=2, max_ell=3, correlation=3),
    "dimenet": dict(num_layers=4), "spherenet": dict(num_layers=2),
}


class _CpuOnly(TorchDispatchMode):
    """Raises on the first aten op given a tensor off the CPU."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        off = [t.device for t in tree_leaves((args, kwargs or {}))
               if isinstance(t, torch.Tensor) and t.device.type != "cpu"]
        if off:
            raise ValueError(
                f"count_on_cpu: {func} was given a tensor on {off[0]}; the "
                "counters do not see the hand-written kernels on the card, "
                "so count a CPU twin of the model on a CPU batch")
        return func(*args, **(kwargs or {}))


def count_on_cpu(step: Callable, model: torch.nn.Module,
                 step_time_s: Optional[float] = None) -> Roofline:
    """``utils.roofline.roofline`` of one call of ``step()``, a step of
    ``model`` that must run on the CPU: ``ValueError`` if a parameter or
    buffer of ``model``, or any tensor an op of the step is given, lies
    off the CPU (on the card)."""
    off = [n for n, t in model.state_dict().items()
           if t.device.type != "cpu"]
    if off:
        raise ValueError(f"count_on_cpu: {off[0]} (and {len(off) - 1} "
                         "more) off the CPU; count a CPU twin")
    with _CpuOnly():
        return roofline(step, step_time_s=step_time_s)


def cpu_twin(model: torch.nn.Module, make: Callable) -> torch.nn.Module:
    """``make("cpu")`` (the same model on the CPU) holding ``model``'s
    parameters and buffers."""
    twin = make("cpu")
    twin.load_state_dict(model.state_dict())
    return twin


def roofline_row(r: Roofline, count_s: float, device: str,
                 precision_name: Optional[str]) -> dict:
    """The JAX row's fields and the port's: the unrounded counts, where
    they were counted, how long that took, the precision and the card."""
    return {**r.row(), "flops": r.flops, "bytes_accessed": r.bytes_accessed,
            "transcendentals": r.transcendentals, "step_s": r.step_time_s,
            "counted_on": "cpu", "count_s": count_s,
            "precision": precision_name or "exact f32", "device": device}


def report_row(name: str, device="cuda", batch_kw: Optional[dict] = None,
               steps: int = bt.STEPS, reps: int = bt.REPS,
               warm: int = bt.WARM, precision_name: Optional[str] = None,
               **width) -> dict:
    """``name``'s row: its step timed on ``device`` (the tests pass
    ``"cpu"``; ``width`` overrides the model's arguments, ``batch_kw``
    ``star_batch``'s), counted on the CPU."""
    kw = dict(LAYERS[name], **width)
    host = bt.star_batch(**(batch_kw or {}), device="cpu", name=name)
    model = bt.build(name, seed_everything(0), device, **kw)
    twin = cpu_twin(model, lambda dev: bt.build(
        name, torch.Generator().manual_seed(0), dev, **kw))
    timed = bt.bench_one(name, host.to(device), steps, reps, warm,
                         model=model)
    t0 = time.perf_counter()
    r = count_on_cpu(bt.make_step(twin, host), twin,
                     step_time_s=1.0 / timed["steps_per_sec"])
    count_s = time.perf_counter() - t0
    card = card_line() if torch.device(device).type == "cuda" else "cpu"
    return {"model": name, "num_layers": kw["num_layers"],
            "edges_per_batch": timed["edges_per_batch"],
            **roofline_row(r, count_s, card, precision_name),
            "steps_timed": steps * reps}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("models", nargs="*", default=list(LAYERS))
    ap.add_argument("--matmul_precision", choices=precision.NAMES,
                    default=None,
                    help="the process default of the float32 products "
                         "(precision.py; without it exact f32)")
    args = ap.parse_args(argv)
    for name in args.models:
        if name not in LAYERS:
            raise SystemExit(f"roofline_report: unknown model {name!r}; the "
                             f"table has {sorted(LAYERS)}")
    if not torch.cuda.is_available():
        raise SystemExit("roofline_report: needs a CUDA card")
    rows = []
    with precision.matmul_precision(args.matmul_precision):
        for name in args.models:
            rows.append(report_row(name,
                                   precision_name=args.matmul_precision))
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
