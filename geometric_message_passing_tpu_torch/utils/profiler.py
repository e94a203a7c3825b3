"""Tracing and cost counters of the port (port of ``utils/profiler.py``):
``profile_trace`` writes a ``torch.profiler`` Chrome trace, ``time_fn`` is
the steady-state time of a call, ``cost_report`` counts a call's FLOPs and
bytes against the card's peaks.

The default peaks are the H100's that the kernel table of ``PERF.md`` uses,
for the card ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` reports as "NVIDIA H100 80GB HBM3, 700.00 W":
67 TFLOP/s f32 on the CUDA cores and 3.35 TB/s of HBM.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import Counter
from typing import Any, Callable, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

H100_PEAK_FLOPS = 67e12        # f32, CUDA cores (NVIDIA H100 80GB HBM3, 700 W)
H100_PEAK_BYTES = 3.35e12      # HBM3, bytes/s (the same card)

# aten ops whose every output element costs one transcendental
# (XLA's "transcendentals" counter)
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log2", "log10", "log1p",
                   "sin", "cos", "tan", "asin", "acos", "atan", "atan2",
                   "sinh", "cosh", "tanh", "sigmoid", "erf", "erfc", "rsqrt",
                   "sqrt", "pow", "silu", "gelu", "softplus", "_softmax",
                   "_log_softmax"}


def _sync(out: Any) -> None:
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tree_leaves(out)):
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_trace(logdir: Optional[str] = None) -> Iterator[str]:
    """Trace the body with ``torch.profiler`` (CPU, and CUDA where a card
    is present) and write it as a Chrome trace, ``{logdir}/trace.json``
    (open it in Perfetto or ``chrome://tracing``); yields ``logdir``
    (default: ``gmp_trace`` under the temporary directory)."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "gmp_trace")
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10, **kw):
    """Steady-state wall time of ``fn(*args, **kw)`` in seconds a call:
    ``warmup`` calls, then ``iters`` timed ones, with
    ``torch.cuda.synchronize`` after the last of each where the result
    holds a CUDA tensor."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kw)
    _sync(out)
    return (time.perf_counter() - t0) / iters


class OpCounter(TorchDispatchMode):
    """Counts every aten op a body dispatches: ``ops`` (by name), the
    bytes of its tensor inputs and outputs (``bytes``; a view's output is
    not counted again) and the output elements of transcendental ops
    (``transcendentals``)."""

    def __init__(self):
        super().__init__()
        self.ops: Counter = Counter()
        self.bytes = 0
        self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        self.ops[name] += 1
        ins = [t for t in tree_leaves((args, kwargs or {}))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.bytes += sum(t.numel() * t.element_size() for t in ins)
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size() for t in outs)
        if name.rstrip("_") in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        return out


def count_costs(fn: Callable, *args, **kw) -> dict:
    """Run ``fn(*args, **kw)`` once and count its work: ``flops``
    (``torch.utils.flop_counter.FlopCounterMode``: products and
    convolutions, a backward's too), ``bytes accessed``,
    ``transcendentals`` and ``aten ops`` (``OpCounter``)."""
    from torch.utils.flop_counter import FlopCounterMode

    ops = OpCounter()
    flops = FlopCounterMode(display=False)
    with flops, ops:
        out = fn(*args, **kw)
    _sync(out)
    return {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(ops.bytes),
            "transcendentals": float(ops.transcendentals),
            "aten ops": sum(ops.ops.values())}


def cost_report(fn: Callable, *args, peak_flops: float = H100_PEAK_FLOPS,
                peak_bytes_per_s: float = H100_PEAK_BYTES, **kw) -> dict:
    """Roofline estimate of one call of ``fn`` from what it dispatches
    (``count_costs``; the call runs once, so a train step steps): FLOPs
    and bytes, each over its peak, and which bound is the larger.

    The bytes are every aten op's input and output bytes: an upper bound
    on the memory traffic, as XLA's count on the CPU is, since a fused or
    cached operand is counted at every op that reads it.  XLA's
    ``hlo_ops`` and ``fusions`` have no meaning for eager PyTorch; the
    report gives ``aten_ops``, the count of aten ops dispatched, in their
    place (each is at least one kernel launch on the card)."""
    c = count_costs(fn, *args, **kw)
    flops, nbytes = c["flops"], c["bytes accessed"]
    return dict(
        flops=flops,
        bytes_accessed=nbytes,
        t_flops_s=flops / peak_flops,
        t_bytes_s=nbytes / peak_bytes_per_s,
        roofline_bound=("compute" if flops / peak_flops >
                        nbytes / peak_bytes_per_s else "memory"),
        aten_ops=c["aten ops"],
    )
