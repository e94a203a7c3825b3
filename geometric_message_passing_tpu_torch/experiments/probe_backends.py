"""Which collectives each backend runs on CUDA tensors, on this host.

    python -m geometric_message_passing_tpu_torch.experiments.probe_backends

Two gloo ranks share ``cuda:0`` and try every collective the parallel
layer could use, on CUDA tensors and on CPU tensors, each result checked;
then two ranks try an NCCL group on one GPU (NCCL refuses it: the error is
printed), and one rank runs an NCCL all-reduce.  One JSON line per probe.
On the H100 with torch 2.11 gloo ran every op on CUDA tensors (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from ..parallel.launch import spawn

OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "reduce_scatter_tensor", "reduce_scatter", "all_to_all_single",
       "barrier")


def _try(op: str, dev: str, rank: int, world: int) -> str:
    x = torch.arange(4 * world, dtype=torch.float32, device=dev) + rank
    want_sum = sum(torch.arange(4 * world, dtype=torch.float32) + r
                   for r in range(world))
    if op == "all_reduce":
        dist.all_reduce(x)
        got, want = x, want_sum
    elif op == "broadcast":
        dist.broadcast(x, src=0)
        got, want = x, torch.arange(4 * world, dtype=torch.float32)
    elif op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        got = torch.cat(parts)
        want = torch.cat([torch.arange(4 * world, dtype=torch.float32) + r
                          for r in range(world)])
    elif op == "all_gather_into_tensor":
        out = x.new_empty(x.numel() * world)
        dist.all_gather_into_tensor(out, x)
        got = out
        want = torch.cat([torch.arange(4 * world, dtype=torch.float32) + r
                          for r in range(world)])
    elif op == "reduce_scatter_tensor":
        out = x.new_empty(4)
        dist.reduce_scatter_tensor(out, x)
        got, want = out, want_sum[4 * rank:4 * rank + 4]
    elif op == "reduce_scatter":
        out = x.new_empty(4)
        dist.reduce_scatter(out, list(x.chunk(world)))
        got, want = out, want_sum[4 * rank:4 * rank + 4]
    elif op == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        got = out
        want = torch.cat([torch.arange(4 * world, dtype=torch.float32)[
            4 * rank:4 * rank + 4] + r for r in range(world)])
    else:
        dist.barrier()
        return "ok"
    if dev != "cpu":
        torch.cuda.synchronize()
    return "ok" if torch.equal(got.cpu(), want) else f"wrong: {got.tolist()}"


def gloo_rank() -> dict:
    """Every op on CUDA, then on CPU tensors; the first line of any error."""
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    for dev in ("cuda", "cpu"):
        for op in OPS:
            try:
                out[f"{op} {dev}"] = _try(op, dev, rank, world)
            except (RuntimeError, ValueError) as exc:
                out[f"{op} {dev}"] = "error: " + str(exc).splitlines()[0][:200]
    return out


def nccl_shared_gpu_rank() -> str:
    """Two ranks (joined over gloo) open an NCCL group on ``cuda:0``."""
    torch.cuda.set_device(0)
    group = dist.new_group([0, 1], backend="nccl")
    x = torch.ones(1, device="cuda:0")
    try:
        dist.all_reduce(x, group=group)
        torch.cuda.synchronize()
        return f"no error: {x.item()}"
    except (RuntimeError, ValueError) as exc:   # DistBackendError included
        return f"{type(exc).__name__}: {exc}"


def nccl_world1_rank() -> str:
    x = torch.ones(3, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    return f"{dist.get_backend()} world {dist.get_world_size()}: {x.tolist()}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--world", type=int, default=2)
    args = ap.parse_args(argv)
    card = torch.cuda.get_device_name(0)
    t = time.perf_counter()
    gloo = spawn(gloo_rank, args.world, backend="gloo", timeout_s=180)
    print(json.dumps({"probe": "gloo", "world": args.world, "card": card,
                      "ops": gloo[0], "ranks_agree": all(
                          set(g) == set(gloo[0]) for g in gloo),
                      "s": round(time.perf_counter() - t, 2)}), flush=True)
    t = time.perf_counter()
    try:
        nccl = spawn(nccl_shared_gpu_rank, 2, backend="gloo", device="cpu",
                     timeout_s=120)
    except RuntimeError as exc:
        nccl = [f"launch failed: {exc}"]
    print(json.dumps({"probe": "nccl two ranks on one GPU", "result": nccl,
                      "s": round(time.perf_counter() - t, 2)}), flush=True)
    try:
        spawn(nccl_world1_rank, 2, backend="nccl")
        guard = "no error"
    except ValueError as exc:
        guard = f"ValueError: {exc}"
    print(json.dumps({"probe": "launch.spawn nccl world 2", "result": guard}),
          flush=True)
    one = spawn(nccl_world1_rank, 1, backend="nccl", timeout_s=120)
    print(json.dumps({"probe": "nccl world 1", "result": one}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
