"""Where the time of one box-scale training step goes, on one CUDA card.

    python -m geometric_message_passing_tpu_torch.experiments.profile_box \\
        [--model egnn_sorted] [--atoms 100000] [--steps 3]

Builds ``experiments/bench_scale.py``'s receiver-sorted box (or its plain
box for a model without ``_sorted``) and model at full width (``gvp`` and
``gvp_sorted`` with bench_scale's remat rule), runs two warm
steps, times 5 untraced steps on the host clock (each ending in a host read
of the loss), then traces ``--steps`` more with ``torch.profiler`` and
prints:
  * the untraced and traced step wall times, the device busy time per step
    and the device's idle share of each;
  * device time per step and launch counts by group: the sorted segment sum
    (K3), matrix products, LayerNorm, gathers and index ops, concatenation
    and copies, elementwise ops and reductions, the Adam update, the rest;
  * the top kernels by device time, with launch counts.
The last line is one JSON object of these numbers with the card's name and
power limit.  It needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..ops.sorted_segsum import batch_seg_plans
from .bench import card_line
from .bench_scale import MODELS, SORTED, box_batch, build, config, make_step
from .train import seed_everything

# kernel-name fragments of each group, checked in this order
GROUPS = (
    ("K3 sorted_segment_sum", ("segsum_",)),
    ("Adam", ("multi_tensor_apply", "adam", "Adam")),
    ("matmul", ("gemm", "Gemm", "cutlass", "sm90_xmma", "cublas")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("gather, index, scatter", ("index", "Index", "gather", "scatter",
                                "radixSort", "RadixSort", "sort")),
    ("cat, copy", ("CatArray", "cat_", "copy", "Memcpy", "Memset")),
    ("elementwise, reductions", ("elementwise", "vectorized", "reduce",
                                 "Reduce")),
)


def _group(name: str) -> str:
    for group, parts in GROUPS:
        if any(p in name for p in parts):
            return group
    return "other"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="egnn_sorted", choices=sorted(MODELS))
    ap.add_argument("--atoms", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_box needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = box_batch(args.atoms, sort=args.model in SORTED).to("cuda")
    cfg = config(args.model, args.atoms)
    model = build(args.model, cfg, seed_everything(0))
    plans = batch_seg_plans(batch) if args.model in SORTED else None
    step = make_step(model, batch, plans)
    for _ in range(2):
        step().item()
    t = time.perf_counter()
    for _ in range(5):
        step().item()
    step_ms = (time.perf_counter() - t) / 5 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(args.steps):
            step().item()
        traced_ms = (time.perf_counter() - t) / args.steps * 1e3
    rows = []
    for ev in prof.key_averages():   # device-side events: kernels, copies
        if (ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
                and not getattr(ev, "is_user_annotation", False)):
            rows.append((ev.self_device_time_total / args.steps,
                         ev.count / args.steps, ev.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    groups = defaultdict(lambda: [0.0, 0.0])
    for dev_us, count, key in rows:
        g = groups[_group(key)]
        g[0] += dev_us / 1e3
        g[1] += count
    edges = int(batch.edge_mask.sum())
    print(f"{args.model} {cfg} on a {args.atoms}-atom box "
          f"({edges} edges), per step:")
    print(f"untraced: {step_ms:.3f} ms (mean of 5), idle share "
          f"{1 - device_ms / step_ms:.3f} at the traced device time")
    print(f"traced: wall {traced_ms:.3f} ms, device time {device_ms:.3f} ms, "
          f"idle share {1 - device_ms / traced_ms:.3f}")
    for name, (ms, count) in sorted(groups.items(), key=lambda g: -g[1][0]):
        print(f"  {ms:9.3f} ms  {count:7.1f}x  {name}")
    print("top kernels:")
    for dev_us, count, key in rows[:25]:
        print(f"  {dev_us / 1e3:9.3f} ms  {count:7.1f}x  {key[:100]}")
    res = {
        "card": card_line(), "model": args.model, "cfg": cfg,
        "atoms": args.atoms,
        "edges": edges, "step_ms_untraced": step_ms,
        "idle_share_untraced": 1 - device_ms / step_ms,
        "step_ms_traced": traced_ms, "device_ms": device_ms,
        "idle_share": 1 - device_ms / traced_ms,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "groups": {k: {"ms": v[0], "count": v[1]} for k, v in groups.items()},
        "top_kernels": [{"name": k, "count": c, "ms": u / 1e3}
                        for u, c, k in rows[:25]],
    }
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
