"""Roofline counters for a train or eval step (port of
``utils/roofline.py``): ``cost_analysis`` counts a call's FLOPs, bytes and
transcendentals (``utils.profiler.count_costs``, the XLA cost analysis's
keys) and ``roofline`` turns them, with a measured step time, into
achieved-vs-peak coordinates.

The peaks default to the H100's (``utils.profiler.H100_PEAK_FLOPS`` /
``H100_PEAK_BYTES``: 67 TFLOP/s f32, 3.35 TB/s; NVIDIA H100 80GB HBM3,
700.00 W).  The bytes are an upper bound on the traffic (every aten op's
inputs and outputs), so ``achieved_gbps`` and ``frac_of_roof`` may exceed
the physical peak where operands stay in cache; the counters come from
running the call once (on the CPU they are the same as on the card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from .profiler import H100_PEAK_BYTES, H100_PEAK_FLOPS, count_costs


@dataclass
class Roofline:
    """Cost counters of one call + (optional) measured achieved rates."""

    flops: float                    # per execution
    bytes_accessed: float           # per execution (every aten op's operands)
    transcendentals: float
    intensity: float                # flops / bytes (operational intensity)
    ridge: float                    # peak_flops / peak_bytes (card's ridge)
    bound: str                      # "compute" or "memory" (static)
    step_time_s: Optional[float] = None
    achieved_tflops: Optional[float] = None
    achieved_gbps: Optional[float] = None
    frac_of_roof: Optional[float] = None   # achieved / attainable-at-intensity

    def row(self) -> dict:
        out = {
            "gflops_per_step": round(self.flops / 1e9, 2),
            "mb_per_step": round(self.bytes_accessed / 1e6, 2),
            "intensity_flop_per_byte": round(self.intensity, 2),
            "static_bound": self.bound,
        }
        if self.step_time_s is not None:
            out.update(
                step_ms=round(self.step_time_s * 1e3, 3),
                achieved_tflops=round(self.achieved_tflops / 1e12, 3),
                achieved_gbps=round(self.achieved_gbps / 1e9, 1),
                frac_of_roof=round(self.frac_of_roof, 3),
            )
        return out


# {'flops', 'bytes accessed', 'transcendentals', 'aten ops'} of one call
# fn(*args, **kwargs), which runs once (the JAX module's name)
cost_analysis = count_costs


def roofline(fn: Callable, *args, step_time_s: Optional[float] = None,
             peak_flops: float = H100_PEAK_FLOPS,
             peak_bytes: float = H100_PEAK_BYTES, **kwargs) -> Roofline:
    """Roofline coordinates of one call of ``fn(*args)``.

    ``step_time_s``: measured time per call (e.g. ``utils.time_fn``) —
    adds achieved rates and the fraction of the attainable roof at this
    intensity."""
    ca = cost_analysis(fn, *args, **kwargs)
    flops = float(ca.get("flops", 0.0))
    nbytes = float(ca.get("bytes accessed", 0.0))
    trans = float(ca.get("transcendentals", 0.0))
    intensity = flops / nbytes if nbytes else float("inf")
    ridge = peak_flops / peak_bytes
    r = Roofline(
        flops=flops, bytes_accessed=nbytes, transcendentals=trans,
        intensity=intensity, ridge=ridge,
        bound="compute" if intensity >= ridge else "memory",
    )
    if step_time_s:
        r.step_time_s = step_time_s
        r.achieved_tflops = flops / step_time_s
        r.achieved_gbps = nbytes / step_time_s
        attainable = min(peak_flops, intensity * peak_bytes)
        r.frac_of_roof = (flops / step_time_s) / attainable
    return r
