"""The traced window, read from ``torch.profiler``'s Chrome trace.

The window the metrics read is traced with the device activity alone
(``torch.profiler`` recording every host operator would double a
host-bound step's time).  The benchmark marks its ranges on the device
instead: a one-cycle ``torch.cuda._sleep`` kernel (``MARKER``) before and
after each forward of a wrapped block.  One stream runs the kernels in the
order they were launched, so the kernels between a pair of markers are
the range's.  Markers are left out of every list and sum.

A second, short trace with the host operators labels the device's idle
gaps by what the host was doing (``idle_gaps``); it sets no metric.
Times are microseconds on the trace's clock.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "port_bench.window"
MARKER = "spin_kernel"
Span = Tuple[float, float]


@dataclasses.dataclass
class Kernel:
    name: str
    ts: float
    dur: float


@dataclasses.dataclass
class Trace:
    window: Span
    window_s: float
    kernels: List[Kernel]
    device: List[Tuple[str, float, float]]      # kernels, copies, fills
    ranges: List[Span]                           # between marker pairs
    host_ops: List[Tuple[str, float, float]]

    @classmethod
    def parse(cls, path: str, window_s: Optional[float] = None) -> "Trace":
        """The trace at ``path``.  Its window is the ``WINDOW`` host range
        where the trace has one, else the span of its device activity;
        ``window_s`` (host seconds) overrides the window's length."""
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels, device, host, markers, window = [], [], [], [], None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat == "kernel" and MARKER in name:
                markers.append((ts, ts + dur))
            elif cat == "kernel":
                kernels.append(Kernel(name, ts, dur))
                device.append((name, ts, dur))
            elif cat in ("gpu_memcpy", "gpu_memset"):
                device.append((name, ts, dur))
            elif cat == "user_annotation" and name == WINDOW:
                window = (ts, ts + dur)
            elif cat in ("cpu_op", "user_annotation", "python_function"):
                host.append((name, ts, ts + dur))
        if len(markers) % 2:
            raise ValueError(f"{len(markers)} range markers: not in pairs")
        markers.sort()
        if window is None:
            if not device:
                raise ValueError("the trace holds no device activity")
            window = (min(d[1] for d in device), max(d[1] + d[2] for d in device))
        return cls(window=window,
                   window_s=((window[1] - window[0]) * 1e-6 if window_s is None
                             else window_s),
                   kernels=kernels, device=device,
                   ranges=[(a[1], b[0]) for a, b in zip(markers[::2],
                                                        markers[1::2])],
                   host_ops=host)

    def busy(self) -> List[Span]:
        """The union of the device's activity inside the window."""
        spans = sorted((max(ts, self.window[0]), min(ts + d, self.window[1]))
                       for _, ts, d in self.device)
        out: List[List[float]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            elif b > a:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def in_ranges(self) -> List[Kernel]:
        """The kernels that ran between a pair of markers; ``ValueError``
        if the trace has no range."""
        if not self.ranges:
            raise ValueError("the trace has no marked range")
        starts = [a for a, _ in self.ranges]
        out = []
        for k in self.kernels:
            i = bisect.bisect_right(starts, k.ts) - 1
            if i >= 0 and k.ts + k.dur <= self.ranges[i][1]:
                out.append(k)
        return out

    def top_ops(self, n: int = 10) -> List[list]:
        total: Dict[str, float] = defaultdict(float)
        for name, _, d in self.device:
            total[name] += d * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda x: -x[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time inside the window, summed by what the host
        was doing at each gap's middle (the innermost host operator there),
        the largest ``n``."""
        busy = self.busy()
        edges = [self.window[0]] + [t for s in busy for t in s] + [self.window[1]]
        ops = sorted(self.host_ops, key=lambda o: o[1])
        starts = [o[1] for o in ops]
        total: Dict[str, float] = defaultdict(float)
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid, label = 0.5 * (a + b), "no host operator"
            i = bisect.bisect_right(starts, mid) - 1
            for name, _, e in reversed(ops[max(i - 5000, 0):i + 1]):
                if e >= mid:          # the latest-starting op covering mid
                    label = name
                    break
            total[label] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda x: -x[1])[:n]]
