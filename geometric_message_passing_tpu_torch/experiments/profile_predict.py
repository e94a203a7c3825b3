"""Where the time of one serving call goes, on one CUDA card.

    python -m geometric_message_passing_tpu_torch.experiments.profile_predict

Serves the headline configuration (1400 star graphs, fold 5/6/7, seed 0,
batch 100, EGNN 4 layers x 128, pool "first") through ``Predictor`` and
prints:
  * the wall time of ``predict`` (median of 5, host clock, ends in a copy to
    the host) and of building and copying the batches alone;
  * a ``torch.profiler`` trace of one ``predict``: device time by kernel,
    the sum of device time and the device's idle share of the wall time;
  * the host time to enqueue one ``egnn_message`` call (no synchronise) and
    its device time (CUDA events), at the serving bucket.
The last line is one JSON object of these numbers with the card's name and
power limit.  It needs a card and raises without one.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .. import datasets as ds
from ..graph import GraphLoader
from ..models import EGNNFusedModel
from ..ops.edge import egnn_message
from .infer import Predictor


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_predict needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    graphs = ds.create_star_graphs(1400, fold=(5, 6, 7), dim=3, seed=0)
    model = EGNNFusedModel(4, 128, 1, 1, pool="first",
                           generator=torch.Generator().manual_seed(0),
                           device=dev)
    pred = Predictor(model, batch_size=100, device=dev)
    pred.predict(graphs)                        # build kernels, size bucket

    walls = []
    for _ in range(5):
        t = time.perf_counter()
        pred.predict(graphs)
        walls.append((time.perf_counter() - t) * 1e3)
    predict_ms = statistics.median(walls)

    t = time.perf_counter()
    batches = [b.to(dev) for b in GraphLoader(graphs, 100, pad=pred.pad)]
    torch.cuda.synchronize()
    host_batch_ms = (time.perf_counter() - t) * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pred.predict(graphs)
        traced_wall_ms = (time.perf_counter() - t) * 1e3
    rows = []
    for ev in prof.key_averages():   # device-side events: kernels, copies
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            rows.append((ev.self_device_time_total, ev.count, ev.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    print(f"predict: median {predict_ms:.3f} ms of 5; batches built and "
          f"copied alone {host_batch_ms:.3f} ms")
    print(f"traced predict: wall {traced_wall_ms:.3f} ms, device time "
          f"{device_ms:.3f} ms, idle share "
          f"{1 - device_ms / traced_wall_ms:.3f}")
    for dev_us, count, key in rows[:15]:
        print(f"  {dev_us / 1e3:9.3f} ms  {count:5d}x  {key[:90]}")

    b = batches[0]
    h = torch.randn(b.num_nodes, 128, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        w = model.convs[0].packed().contiguous()
    args = (b.senders, b.receivers, b.edge_mask, h, b.pos, w)
    with torch.inference_mode():
        for _ in range(3):
            egnn_message(*args)
        torch.cuda.synchronize()
        n = 200
        t = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            egnn_message(*args)
        stop.record()
        enqueue_us = (time.perf_counter() - t) / n * 1e6
        torch.cuda.synchronize()
        call_us = start.elapsed_time(stop) / n * 1e3
    print(f"egnn_message at the serving bucket: host enqueue {enqueue_us:.1f} "
          f"us per call, {call_us:.1f} us per call back to back")
    res = {
        "card": _card(), "predict_ms": predict_ms,
        "host_batch_ms": host_batch_ms, "traced_wall_ms": traced_wall_ms,
        "device_ms": device_ms, "idle_share": 1 - device_ms / traced_wall_ms,
        "egnn_enqueue_us": enqueue_us, "egnn_call_us": call_us,
        "top_kernels": [{"name": k, "count": c, "ms": u / 1e3}
                        for u, c, k in rows[:15]],
    }
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
