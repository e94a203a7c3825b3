"""A/B trial of GVP-GNN's message route on one CUDA card: the hand-written
GVP message kernels (``use_pallas=True``) against the plain PyTorch route
(``use_pallas=False``, the default) (port of ``scripts/trial_gvp_pallas.py``).

    python -m geometric_message_passing_tpu_torch.experiments.trial_gvp \\
        [--layers 4] [--steps 100]

Same data, model and protocol as the JAX script: 100 star graphs (fold
5/6/7, target max angle, seed 0) in one padded batch of 100, GVP-GNN at its
defaults with ``--layers`` layers, weights from seed 0, Adam 5e-4, the
L1-sum loss, dropout on (training mode; the port's dropout generator runs
on from step to step where the JAX script reuses one key).  A call is
``--steps`` train steps ending in a host read of the loss; the first call
(with the kernels' build for ``use_pallas=True``) and a second are warm-up,
then 3 calls are timed on the host clock.  Then 5 more steps are traced
with ``torch.profiler``: device time per step, the device's idle share,
and the GVP kernels' device time per step.

Prints one JSON line per variant, with the card's ``nvidia-smi`` name and
power limit.  It needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .. import datasets as ds
from ..graph import GraphLoader, pad_sizes
from ..models import GVPGNNModel
from ..ops.gvp_message import gvp_message
from .bench import card_line
from .train import l1_sum_loss, make_tx, seed_everything

TRACED_STEPS = 5


def run_variant(use_pallas: bool, num_layers: int, steps: int) -> dict:
    data = ds.create_star_graphs(num=100, fold=[5, 6, 7], dim=3, target="max",
                                 seed=0)
    batch = next(iter(GraphLoader(data, batch_size=100,
                                  pad=pad_sizes(data, 100)))).to("cuda")
    edges = int(batch.edge_mask.sum())
    model = GVPGNNModel(num_layers=num_layers, out_dim=1, use_pallas=use_pallas,
                        generator=seed_everything(0), device="cuda")
    model.train()
    opt = make_tx(model.parameters(), 5e-4)

    def step() -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = l1_sum_loss(model(batch), batch)
        loss.backward()
        opt.step()
        return loss.detach()

    def call(n: int) -> float:
        for _ in range(n):
            loss = step()
        return float(loss)              # host read: waits for the device

    t0 = time.perf_counter()
    call(steps)
    first_s = time.perf_counter() - t0
    call(steps)
    reps = 3
    launches = (gvp_message.launches, gvp_message.bwd_launches)
    t0 = time.perf_counter()
    for _ in range(reps):
        loss = call(steps)
    dt = time.perf_counter() - t0
    launches = ((gvp_message.launches - launches[0]) / (reps * steps),
                (gvp_message.bwd_launches - launches[1]) / (reps * steps))
    sps = steps * reps / dt

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call(TRACED_STEPS)
        traced_ms = (time.perf_counter() - t0) / TRACED_STEPS * 1e3
    device_us = gvp_us = 0.0
    for ev in prof.key_averages():
        if (ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
                and not getattr(ev, "is_user_annotation", False)):
            device_us += ev.self_device_time_total
            if "gvp_" in ev.key and "_kernel" in ev.key:   # K5's kernels
                gvp_us += ev.self_device_time_total
    device_ms = device_us / TRACED_STEPS / 1e3
    return {
        "variant": "kernel" if use_pallas else "plain",
        "use_pallas": use_pallas,
        "num_layers": num_layers,
        "first_call_s": first_s,
        "ms_per_step": 1000.0 / sps,
        "steps_per_sec": sps,
        "edges_per_sec_per_chip": edges * sps,
        "gvp_launches_per_step": {"forward": launches[0],
                                  "backward": launches[1]},
        "traced_ms_per_step": traced_ms,
        "device_ms_per_step": device_ms,
        "idle_share": 1.0 - device_ms / traced_ms,
        "gvp_kernels_ms_per_step": gvp_us / TRACED_STEPS / 1e3,
        "final_loss": loss,
        "device": card_line(),
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trial_gvp: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for use_pallas in (False, True):
        rows.append(run_variant(use_pallas, args.layers, args.steps))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
