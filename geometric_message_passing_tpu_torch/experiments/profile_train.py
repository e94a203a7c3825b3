"""Where the time of one training epoch and of one train step goes, on one
CUDA card.

    python -m geometric_message_passing_tpu_torch.experiments.profile_train \
        [--fuse-stack | --tfn | --mace | --dimenet]

Trains the bench configuration (EGNN 4 layers x 128, pool "first", 1400
star graphs split 50/20/30, batch 100, lr 5e-4; see ``experiments/bench.py``;
``--fuse-stack`` runs its whole-stack strategy, K6, in place of the
per-layer kernels K1/K2; ``--tfn`` trains TFN's star configuration instead,
``bench.TFN_STAR`` on ``bench.tfn_data``; ``--mace`` MACE's,
``bench.MACE_STAR`` on ``bench.mace_data`` (lr 5e-4, 8 train steps an
epoch); ``--dimenet`` DimeNet++'s star
configuration, ``bench.DIMENET_STAR`` on ``bench.triplet_star_data``: 4
layers at the default widths, fold [7], 1000 graphs, lr 1e-4, 5 train
steps an epoch) through ``fit_regression`` for a few warm epochs,
then traces one more epoch (its train steps, the validation pass and, since
its best-val rule fires on a first epoch, the test pass) with
``torch.profiler`` and prints:
  * the mean epoch wall time of an untraced 10-epoch run, and the traced
    epoch's wall time (host clock, profiler overhead included), device busy
    time and the device's idle share of each;
  * device time and launch counts by group: K6 (the whole stack), K1 (the
    message kernel), K2 (its backward), K7 (TFN's CG contraction, both
    directions), K3/K4 (the segment sums), the CSR build (sort,
    searchsorted), matrix products outside the kernels (update MLP, TFN's
    edge-weight heads, readout), the Adam update and the rest;
  * the top kernels by device time, with launch counts;
  * one train step on the first train batch (``train_step``): the mean
    wall time of 20 untraced steps, each ending in a synchronise, and the
    device time and idle share of 5 traced steps;
  * with ``--mace``, the parts no kernel name tells apart, each run alone
    forward and backward on its inputs of that step (captured by forward
    hooks) and traced: per layer the symmetric contraction and the edge
    MLP's weight heads (``fc`` and ``fc_out``), device ms and share of the
    step's device time.
The last line is one JSON object of these numbers with the card's name and
power limit.  It needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..graph import assemble_batch, build_slot_data
from ..models import DimeNetPPModel
from .bench import (BATCH_SIZE, DIMENET_STAR, LR, MACE_LR, bench_data,
                    bench_model, card_line, mace_data, mace_model, tfn_data,
                    tfn_model, triplet_star_data)
from .train import fit_regression, make_tx, seed_everything, train_step

# kernel-name fragments of each group, checked in this order
GROUPS = (
    ("K6 egnn_stack", ("egnn_stack_",)),
    ("K1 egnn_message", ("egnn_edge_kernel", "egnn_reduce_kernel")),
    ("K2 egnn_message_bwd", ("egnn_bwd_",)),
    ("K7 edge_contract", ("contract_ring_kernel", "contract_fwd",
                          "contract_bwd")),
    ("K3/K4 segment sum", ("segsum_",)),
    ("CSR build", ("radixSort", "RadixSort", "searchsorted", "sort")),
    ("matmul outside kernels", ("gemm", "Gemm", "cutlass", "sm90_xmma")),
    ("Adam", ("multi_tensor_apply", "adam", "Adam")),
)


def _group(name: str) -> str:
    for group, parts in GROUPS:
        if any(p in name for p in parts):
            return group
    return "other"


def _device_rows(prof):
    """(device us, count, name) of the trace's device-side events (kernels,
    copies), largest first."""
    rows = []
    for ev in prof.key_averages():
        if (ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
                and not getattr(ev, "is_user_annotation", False)):
            rows.append((ev.self_device_time_total, ev.count, ev.key))
    return sorted(rows, reverse=True)


def step_reading(model, loaders, steps: int = 20, traced: int = 5,
                 lr: float = LR) -> dict:
    """One train step of a copy of ``model`` on the first ``BATCH_SIZE``
    training graphs: untraced wall ms (mean of ``steps``, each ending in a
    synchronise), device ms per step and idle share from ``traced`` steps."""
    work = copy.deepcopy(model)
    slot = build_slot_data(loaders[0].graphs,
                           with_triplets=loaders[0].with_triplets,
                           with_quads=loaders[0].with_quads, device="cuda")
    row = torch.arange(BATCH_SIZE, device="cuda")
    opt = make_tx(work.parameters(), lr)

    def step():
        train_step(work, opt, slot, row)
        torch.cuda.synchronize()

    for _ in range(5):
        step()
    t = time.perf_counter()
    for _ in range(steps):
        step()
    wall_ms = (time.perf_counter() - t) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(traced):
            step()
        traced_ms = (time.perf_counter() - t) / traced * 1e3
    rows = _device_rows(prof)
    device_ms = sum(r[0] for r in rows) / 1e3 / traced
    return {"step_ms": wall_ms, "traced_step_ms": traced_ms,
            "device_ms": device_ms, "idle_share": 1 - device_ms / wall_ms,
            "device_events": sum(r[1] for r in rows) / traced}


def part_device_ms(fn, iters: int = 10) -> float:
    """Device ms of one call of ``fn`` (3 warm calls, then ``iters`` traced
    ones)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(r[0] for r in _device_rows(prof)) / 1e3 / iters


def mace_parts(model, loaders) -> dict:
    """Device ms, forward and backward, of each layer's symmetric
    contraction and weight heads on their inputs of a train-mode forward of
    the first ``BATCH_SIZE`` training graphs (a copy of ``model``)."""
    work = copy.deepcopy(model).train()
    slot = build_slot_data(loaders[0].graphs, device="cuda")
    batch = assemble_batch(slot, torch.arange(BATCH_SIZE, device="cuda"))
    seen = {}
    hooks = []
    for i, (conv, prod) in enumerate(zip(work.convs, work.prods)):
        hooks.append(prod.symmetric_contraction.register_forward_hook(
            lambda mod, inp, out, i=i: seen.__setitem__(("sc", i), inp[0])))
        hooks.append(conv.fc.register_forward_hook(
            lambda mod, inp, out, i=i: seen.__setitem__(("fc", i), inp[0])))
    with torch.no_grad():
        work(batch)
    for h in hooks:
        h.remove()
    out = {}
    for i, (conv, prod) in enumerate(zip(work.convs, work.prods)):
        x = seen[("sc", i)].detach().requires_grad_()
        sc = prod.symmetric_contraction
        g = torch.randn_like(sc(x))
        out[f"symmetric_contraction_{i}"] = part_device_ms(
            lambda: torch.autograd.backward(sc(x), g))
        ef = seen[("fc", i)].detach()
        gs = [torch.randn_like(w) for w in conv.heads(ef)]
        out[f"heads_{i}"] = part_device_ms(
            lambda: torch.autograd.backward(conv.heads(ef), gs))
    return out


def main(argv=None, warm_epochs: int = 3) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--fuse-stack", action="store_true",
                       help="the whole-stack strategy (K6)")
    which.add_argument("--tfn", action="store_true",
                       help="TFN's star configuration (K7)")
    which.add_argument("--mace", action="store_true",
                       help="MACE's star configuration (K7, K4)")
    which.add_argument("--dimenet", action="store_true",
                       help="DimeNet++'s star configuration (K3 fold, K4)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    lr = LR
    if args.tfn:
        _, loaders = tfn_data()
        model = tfn_model(seed_everything(0))
    elif args.mace:
        _, loaders = mace_data()
        model = mace_model(seed_everything(0))
        lr = MACE_LR
    elif args.dimenet:
        _, loaders = triplet_star_data(**DIMENET_STAR)
        model = DimeNetPPModel(num_layers=DIMENET_STAR["num_layers"],
                               in_dim=1, out_dim=1,
                               generator=seed_everything(0))
        lr = DIMENET_STAR["lr"]
    else:
        _, loaders = bench_data()
        model = bench_model(seed_everything(0), fuse_stack=args.fuse_stack)
    fit = dict(lr=lr, seed=1, device="cuda")
    warm = fit_regression(model, None, *loaders, n_epochs=warm_epochs, **fit)
    model.load_state_dict(warm.variables)

    epoch_ms = fit_regression(model, None, *loaders, n_epochs=10,
                              **fit).train_time / 10 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fit_regression(model, None, *loaders, n_epochs=1, **fit)
        traced_wall_ms = (time.perf_counter() - t) * 1e3
    rows = _device_rows(prof)
    device_ms = sum(r[0] for r in rows) / 1e3
    groups = defaultdict(lambda: [0.0, 0])
    for dev_us, count, key in rows:
        g = groups[_group(key)]
        g[0] += dev_us / 1e3
        g[1] += count
    print(f"untraced: {epoch_ms:.3f} ms per epoch (mean of 10), idle share "
          f"{1 - device_ms / epoch_ms:.3f} at the traced epoch's device time")
    print(f"traced epoch: wall {traced_wall_ms:.3f} ms, device time "
          f"{device_ms:.3f} ms, idle share {1 - device_ms / traced_wall_ms:.3f}")
    for name, (ms, count) in sorted(groups.items(), key=lambda g: -g[1][0]):
        print(f"  {ms:9.3f} ms  {count:5d}x  {name}")
    print("top kernels:")
    for dev_us, count, key in rows[:20]:
        print(f"  {dev_us / 1e3:9.3f} ms  {count:5d}x  {key[:90]}")
    step = step_reading(model, loaders, lr=lr)
    print(f"one train step: {step['step_ms']:.3f} ms untraced (mean of 20), "
          f"device {step['device_ms']:.3f} ms, idle share "
          f"{step['idle_share']:.3f}, {step['device_events']:.0f} device events")
    parts = mace_parts(model, loaders) if args.mace else {}
    for name, ms in parts.items():
        print(f"  {name}: {ms:.3f} device ms forward and backward, "
              f"{ms / step['device_ms']:.1%} of the step's device time")
    res = {
        "card": card_line(), "fuse_stack": args.fuse_stack, "tfn": args.tfn,
        "mace": args.mace, "dimenet": args.dimenet, "mace_parts_ms": parts,
        "epoch_ms_untraced": epoch_ms,
        "idle_share_untraced": 1 - device_ms / epoch_ms,
        "traced_wall_ms": traced_wall_ms, "device_ms": device_ms,
        "idle_share": 1 - device_ms / traced_wall_ms,
        "groups": {k: {"ms": v[0], "count": v[1]} for k, v in groups.items()},
        "top_kernels": [{"name": k, "count": c, "ms": u / 1e3}
                        for u, c, k in rows[:20]],
        "train_step": step,
    }
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
