"""One run of a training cell: set-up, the measured window, the check.

1. Inputs: the frame from the seed (``frames.py``), the weights drawn on
   the device from the seed in one call (``draw_weights``), each leaf
   scaled by the reference's ``init_rule``.
2. Program set-up: the program's data layer builds the graph and batch
   (``frames_build_s``), its registry builds the model, the drawn
   weights are copied in, and ``experiments.bench_scale.make_step`` builds
   the training step.  Its first ``CHECK_STEPS`` steps are the checked
   steps (their losses, the step-1 gradients as ``.grad`` holds them, the
   leaves' change after the last); ``WARM_STEPS`` more warm it.
3. The window: the same step object, for ``seconds``, one synchronise at
   the end; or, traced (``traced_window``), the device activity over at
   least ``TRACE_MIN_STEPS`` steps and ``TRACE_SECONDS``, with device
   markers around each forward of the config's ``interactions`` blocks.
4. After the window: the peak memory is read, the program's state freed,
   and the plain reference runs the checked steps from the same weights
   on its own graph of the same frame (``check.py``).
"""

from __future__ import annotations

import gc
import os
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import check, frames, peaks, spec
from .reference import _adam
from .trace import WINDOW, Trace

LR = 1e-4                # make_step's default learning rate
CHECK_STEPS = 3
WARM_STEPS = 2
TRACE_MIN_STEPS = 3
TRACE_SECONDS = 2.0
LABEL_STEPS = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "geometric_message_passing_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def exact_f32(allow_tf32: bool = False) -> None:
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32


def sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def port_batch(cell: spec.Cell, frame: frames.Frame, device: str):
    """The program's data layer: its radius graph, the one-graph batch
    (with triplets when the config asks) on ``device``; and its seconds."""
    from geometric_message_passing_tpu_torch.graph import Graph, GraphLoader
    from geometric_message_passing_tpu_torch.ops.radius_graph import radius_graph
    t = time.perf_counter()
    edges = radius_graph(frame.pos, cell.mix["cutoff"])
    graph = Graph(frame.atoms, edges, frame.pos, [frame.y])
    batch = next(iter(GraphLoader([graph], batch_size=1,
                                  with_triplets=cell.config["triplets"])))
    batch = batch.to(device)
    sync(device)
    return batch, time.perf_counter() - t


def shapes(batch) -> dict:
    """Live and padded sizes of the batch, for the counts."""
    tri = batch.triplets
    return {"nodes": int(batch.node_mask.sum()),
            "edges": int(batch.edge_mask.sum()),
            "triplets": 0 if tri is None else int(tri.t_mask.sum()),
            "nodes_pad": batch.num_nodes, "edges_pad": batch.num_edges,
            "triplets_pad": 0 if tri is None else tri.num_triplets,
            "graphs_pad": batch.num_graphs}


def port_model(cell: spec.Cell, batch, device: str) -> torch.nn.Module:
    from geometric_message_passing_tpu_torch.models import model_registry
    args = dict(cell.config["args"])
    if cell.config.get("mean_degree_arg"):
        s = shapes(batch)
        args[cell.config["mean_degree_arg"]] = s["edges"] / s["nodes"]
    return model_registry[cell.config["model"]](
        **args, generator=torch.Generator().manual_seed(0), device=device)


def draw_weights(names_shapes, rule: Callable, seed: int,
                 device: str) -> Dict[str, torch.Tensor]:
    """Every leaf from one ``randn`` of a generator on ``device`` seeded
    with ``seed``, each slice times the rule's std plus its mean."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(int(np.prod(s)) for _, s in names_shapes)
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in names_shapes:
        n = int(np.prod(shape))
        mean, std = rule(name, tuple(shape))
        if isinstance(mean, torch.Tensor):
            mean = mean.to(device)
        out[name] = flat[off:off + n].view(shape) * std + mean
        off += n
    return out


def make_step(model, batch):
    from geometric_message_passing_tpu_torch.experiments.bench_scale import (
        make_step as program_step)
    return program_step(model, batch, lr=LR)


def checked_steps(step, model, n: int) -> tuple:
    """Run ``n`` steps; ``(readings, losses)``: the losses, each leaf's
    step-1 gradient norm (``.grad`` after step 1: the step zeroes it at the
    start of the next), each leaf's change after step ``n``."""
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    losses, grad = [], {}
    for i in range(n):
        losses.append(step())
        if i == 0:
            grad = {k: _adam._norm(p.grad) for k, p in params.items()}
    delta = {k: _adam._norm(p.detach() - start[k]) for k, p in params.items()}
    return {"losses": [float(x) for x in losses], "grad": grad,
            "delta": delta}, losses


def range_hooks(model, attr: str) -> list:
    """A device marker (``trace.MARKER``) before and after each forward of
    the blocks in ``model.<attr>`` (an ``AttributeError`` when the model
    lacks it)."""
    blocks = getattr(model, attr)
    mark = lambda *_: torch.cuda._sleep(1)
    handles = []
    for blk in blocks:
        handles += [blk.register_forward_pre_hook(mark),
                    blk.register_forward_hook(mark)]
    return handles


def window(step, seconds: float, device: str) -> tuple:
    """Steps until ``seconds`` have passed on the host clock, then one
    synchronise: ``(steps, seconds, losses)``."""
    losses = []
    sync(device)
    t0 = time.perf_counter()
    while True:
        losses.append(step())
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return len(losses), time.perf_counter() - t0, losses


def _export(prof, workdir: str, window_s: Optional[float] = None) -> Trace:
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        return Trace.parse(path, window_s)
    finally:
        os.remove(path)


def traced_window(step, model, attr: str, seconds: float,
                  workdir: str) -> tuple:
    """The traced window on the card: ``(steps, Trace, labels, losses)``.
    At least ``TRACE_MIN_STEPS`` steps and ``min(seconds, TRACE_SECONDS)``
    traced with the device activity alone and the blocks' ranges marked;
    then ``LABEL_STEPS`` more with the host operators too, whose trace
    gives the idle gaps their labels."""
    from torch.profiler import ProfilerActivity, profile
    handles = range_hooks(model, attr)
    losses = []
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while (len(losses) < TRACE_MIN_STEPS
                   or time.perf_counter() - t0 < min(seconds, TRACE_SECONDS)):
                losses.append(step())
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    finally:
        for h in handles:
            h.remove()
    n = len(losses)
    tr = _export(prof, workdir, window_s)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            losses += [step() for _ in range(LABEL_STEPS)]
            torch.cuda.synchronize()
    return n, tr, _export(prof, workdir).idle_gaps(), losses


def reference_readings(cell: spec.Cell, frame: frames.Frame,
                       weights: Dict[str, torch.Tensor], device: str,
                       allow_tf32: bool = False) -> dict:
    """The plain reference's checked steps from ``weights`` on its own
    graph of ``frame`` (TF32 products when ``allow_tf32``: the control)."""
    ref = spec.module(cell, "reference")
    pos = torch.from_numpy(frame.pos).to(device)
    atoms = torch.from_numpy(frame.atoms).to(device)
    graph = ref.make_graph(pos, atoms, cell.mix["cutoff"],
                           cell.config["triplets"])
    model = ref.build(cell.config["args"], graph).to(device)
    _adam.load(model, weights)
    chunks = device.startswith("cuda")
    exact_f32(allow_tf32)
    try:
        return _adam.train_steps(
            model, lambda: ref.atom_energies(model, graph, chunks), frame.y,
            CHECK_STEPS, LR)
    finally:
        exact_f32(False)


def free(device: str) -> None:
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()


def setup(cell: spec.Cell, seed: int, device: str) -> SimpleNamespace:
    """Frame, program batch, model, drawn weights, step; the checked and
    warm steps run.  Each phase's seconds go to standard error."""
    marks = [("start", time.perf_counter())]
    frame = frames.make_frame(cell.mix, seed)
    batch, build_s = port_batch(cell, frame, device)
    marks.append(("frame and data layer", time.perf_counter()))
    model = port_model(cell, batch, device)
    marks.append(("model", time.perf_counter()))
    rule = spec.module(cell, "reference").init_rule
    weights = draw_weights([(k, tuple(p.shape))
                            for k, p in model.named_parameters()],
                           rule, seed, device)
    sync(device)
    marks.append(("weights drawn", time.perf_counter()))
    _adam.load(model, weights)
    step = make_step(model, batch)
    marks.append(("weights loaded", time.perf_counter()))
    readings, losses = checked_steps(step, model, CHECK_STEPS)
    marks.append(("checked steps", time.perf_counter()))
    losses += [step() for _ in range(WARM_STEPS)]
    sync(device)
    marks.append(("warm steps", time.perf_counter()))
    print("set-up s: " + ", ".join(f"{name} {b - a:.3f}" for (_, a), (name, b)
                                   in zip(marks, marks[1:])), file=sys.stderr)
    return SimpleNamespace(frame=frame, batch=batch, model=model, step=step,
                           weights=weights, readings=readings, losses=losses,
                           frames_build_s=build_s, shapes=shapes(batch))


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    on_card = device.startswith("cuda")
    exact_f32(False)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    s = setup(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    ctx = SimpleNamespace(cell=cell, config=cell.config, mix=cell.mix,
                          shapes=s.shapes, frames_build_s=s.frames_build_s,
                          setup_s=setup_s, counts=spec.module(cell, "counts"),
                          kind=(torch.cuda.get_device_name(0) if on_card
                                else "cpu"))
    ctx.peaks = peaks.for_device(ctx.kind)
    with tempfile.TemporaryDirectory() as work:
        if trace and on_card:
            n, ctx.trace, labels, losses = traced_window(
                s.step, s.model, cell.config["interactions"], seconds, work)
            ctx.steps = n
        elif trace:        # no device to trace: the readers find nothing
            n, secs, losses = window(s.step, seconds, device)
            ctx.steps, ctx.trace, labels = n, Trace((0.0, 0.0), secs, [], [],
                                                    [], []), []
        else:
            n, secs, losses = window(s.step, seconds, device)
            ctx.steps, ctx.window_s = n, secs
    losses = s.losses + losses
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    ctx.peak_bytes = torch.cuda.max_memory_allocated() if on_card else 0
    frame, weights, prog = s.frame, s.weights, s.readings
    del s
    free(device)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(cell, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    ref = reference_readings(cell, frame, weights, device)
    ok, checks = check.judge(check.compare(prog, ref), cell.limits)
    dev = {"platform": "gpu" if on_card else "cpu", "kind": ctx.kind,
           "count": cell.chips if on_card else 1,
           "memory_peak_bytes": int(ctx.peak_bytes)}
    result = {"correct": bool(ok and failed == 0), "attempted": len(losses),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = ctx.trace.busy_s()
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                               "idle_gaps": labels}
    result["checks"] = checks
    return result
