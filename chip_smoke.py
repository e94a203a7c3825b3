#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile every CUDA kernel from ``csrc/`` (nvcc, sm_90a);
  3. kernels: hold each kernel against its plain PyTorch version on the card
     (atol = rtol = 1e-4: f32 sums are taken in another order) at three
     shapes, check that two runs are bitwise equal, and time kernel and plain
     version at the serving shape;
  4. serve: star graphs (1400, fold 5/6/7, seed 0) through
     ``Predictor(EGNNFusedModel(4 layers, 128 wide, pool "first"))``, with
     the launch counters set to 0 just before and read just after; the
     result must be finite, of shape (1400, 1), and match the same weights
     run on the CPU through the plain path (atol 1e-4);
  5. summary: one JSON line of kernels, then the device line last.

It imports nothing of JAX.  Peak rates for the bounds are the H100 SXM data
sheet's: 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s HBM.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from geometric_message_passing_tpu_torch import datasets as ds
from geometric_message_passing_tpu_torch.experiments.infer import Predictor
from geometric_message_passing_tpu_torch.graph import GraphLoader, pad_sizes
from geometric_message_passing_tpu_torch.models import EGNNFusedModel
from geometric_message_passing_tpu_torch.ops import _build
from geometric_message_passing_tpu_torch.ops import edge
from geometric_message_passing_tpu_torch.ops.edge import (
    egnn_message, egnn_message_plain, msg_rows)

F32_FLOPS = 67e12          # H100 SXM, f32 on CUDA cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
ATOL = RTOL = 1e-4

N_GRAPHS, FOLD, BATCH, LAYERS, WIDTH = 1400, (5, 6, 7), 100, 4, 128


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernels_only_ms(args, iters: int = 50) -> float:
    """Device time of egnn_message's two hand-written kernels alone: the
    CSR and the buffers are made once, outside the timed loop."""
    send, recv, emask, h, pos, _ = args
    (n, d), e = h.shape, send.shape[0]
    order, rowptr = edge.receiver_csr(recv, emask, n)
    bufs = [torch.empty(shape, dtype=torch.float32, device=h.device)
            for shape in ((e, d), (e, 3), (n, d), (n, 3), (n, 1))]
    return cuda_time_ms(
        lambda: edge._launch_kernels(*args, order, rowptr, *bufs), iters)


def bound_ms(args) -> tuple:
    """Least time for egnn_message on these inputs: bytes (each input read
    once, each output written once) over HBM rate vs operations that the
    masked-in edges need over the f32 rate."""
    send, recv, emask, h, pos, w = args
    n, d = h.shape
    e = send.shape[0]
    n_bytes = (2 * e * send.element_size() + e + 4 * h.numel() + 4 * pos.numel()
               + 4 * w.numel() + 4 * (n * d + n * 3 + n))
    e_live = int(emask.sum())
    # matrix products (2 ops per FMA), scale dot, three LayerNorm+ReLU
    # (~9 ops per element) and the receiver sum (d + 3 adds)
    per_edge = 2 * d * (2 * d + 1) + 4 * d * d + 2 * d + 27 * d + d + 3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = e_live * per_edge / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def random_case(n: int, e: int, d: int, seed: int, masked: float, dev):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, d)).astype(np.float32)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    send = rng.integers(0, n, e).astype(np.int32)
    recv = rng.integers(0, n, e).astype(np.int32)
    emask = rng.random(e) >= masked
    w = (rng.normal(size=(msg_rows(d), d)) * 0.1).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (send, recv, emask, h, pos, w))


def star_case(graphs, model: EGNNFusedModel, seed: int, dev):
    """The first serving batch's edges and positions, random node features
    and layer 0's packed weights."""
    batch = next(iter(GraphLoader(graphs, BATCH, pad=pad_sizes(graphs, BATCH))))
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(
        rng.normal(size=(batch.num_nodes, model.emb_dim)).astype(np.float32))
    with torch.no_grad():
        w = model.convs[0].packed().detach().contiguous()
    return (batch.senders.to(dev), batch.receivers.to(dev),
            batch.edge_mask.to(dev), h.to(dev), batch.pos.to(dev), w.to(dev))


def check_kernel_case(name: str, args) -> float:
    with torch.no_grad():
        got = egnn_message(*args)
        want = egnn_message_plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    for g, w_, part in zip(got, want, ("msg", "pos", "cnt")):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: kernel {part} has non-finite values")
        err = max(err, (g - w_).abs().max().item())
        if not torch.allclose(g, w_, atol=ATOL, rtol=RTOL):
            raise AssertionError(
                f"{name}: kernel {part} differs from plain version by "
                f"{(g - w_).abs().max().item():.3e}")
    n, d = args[3].shape
    log(f"  {name}: N={n} E={args[0].shape[0]} D={d} "
        f"live={int(args[2].sum())} max_abs_err={err:.3e}")
    return err


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "needs one CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)                       # name, power limit as nvidia-smi gives them

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SIGNATURES:
        _build.load(name)
    log(f"[build] {len(_build.SIGNATURES)} kernel sources in "
        f"{time.perf_counter() - t0:.2f} s")

    # 3. kernels against their plain versions
    graphs = ds.create_star_graphs(N_GRAPHS, fold=FOLD, dim=3, target="max",
                                   seed=0)
    cpu_model = EGNNFusedModel(LAYERS, WIDTH, 1, 1, pool="first",
                               generator=torch.Generator().manual_seed(0),
                               device="cpu")
    log("[kernels] egnn_message vs egnn_message_plain "
        f"(atol={ATOL}, rtol={RTOL})")
    small = random_case(40, 150, 32, seed=1, masked=0.1, dev=dev)
    serve = star_case(graphs, cpu_model, seed=2, dev=dev)
    large = random_case(10_000, 129_000, WIDTH, seed=3, masked=0.0, dev=dev)
    err = max(check_kernel_case("small", small),
              check_kernel_case("serve bucket", serve),
              check_kernel_case("N=10k", large))
    with torch.no_grad():
        first, second = egnn_message(*large), egnn_message(*large)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("egnn_message: two runs differ bitwise")
    log("  two runs at N=10k are bitwise equal")

    with torch.no_grad():
        k_ms = kernels_only_ms(serve)
        call_ms = cuda_time_ms(lambda: egnn_message(*serve))
        p_ms = cuda_time_ms(lambda: egnn_message_plain(*serve))
        k_ms_large = kernels_only_ms(large, iters=10)
        call_ms_large = cuda_time_ms(lambda: egnn_message(*large), iters=10)
        p_ms_large = cuda_time_ms(lambda: egnn_message_plain(*large), iters=10)
    b_ms, b_by = bound_ms(serve)
    b_ms_large, b_by_large = bound_ms(large)
    for label, k, c, p, b, by in (
            ("serve bucket", k_ms, call_ms, p_ms, b_ms, b_by),
            ("N=10k", k_ms_large, call_ms_large, p_ms_large, b_ms_large,
             b_by_large)):
        log(f"  {label}: kernels {k:.4f} ms, whole call {c:.4f} ms, plain "
            f"{p:.4f} ms, bound {b:.5f} ms ({by}) [{card}]")

    # 4. serve
    model = EGNNFusedModel(LAYERS, WIDTH, 1, 1, pool="first",
                           generator=torch.Generator().manual_seed(0),
                           device="cuda")
    for key, value in model.state_dict().items():
        if not torch.equal(value.cpu(), cpu_model.state_dict()[key]):
            raise AssertionError(f"CPU and CUDA models differ at {key}")
    pred = Predictor(model, batch_size=BATCH)
    egnn_message.launches = 0
    y = pred.predict(graphs)
    launches = egnn_message.launches
    want = -(-N_GRAPHS // BATCH) * LAYERS
    log(f"[serve] predict({N_GRAPHS} graphs): egnn_message launches "
        f"{launches} (want {want}), bucket {pred.pad}")
    if y.shape != (N_GRAPHS, 1) or not np.isfinite(y).all():
        raise AssertionError(f"predict gave shape {y.shape}, "
                             f"finite={np.isfinite(y).all()}")
    if launches != want:
        raise AssertionError(f"egnn_message launched {launches} times, "
                             f"expected {want}")
    y_cpu = Predictor(cpu_model, batch_size=BATCH, device="cpu").predict(graphs)
    serve_err = float(np.abs(y - y_cpu).max())
    log(f"  vs the CPU plain path: max_abs_err={serve_err:.3e} (atol 1e-4)")
    if not np.allclose(y, y_cpu, atol=1e-4, rtol=0):
        raise AssertionError(f"predict differs from the CPU run by {serve_err}")

    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred.predict(graphs)      # ends in a copy to the host: synchronous
        times.append(time.perf_counter() - t)
    ms = statistics.median(times) * 1e3
    t = time.perf_counter()
    for _ in range(3):
        for batch in GraphLoader(graphs, BATCH, pad=pred.pad):
            batch.to(dev)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) / 3 * 1e3
    log(f"[serve] predict: median {ms:.2f} ms per call of 7 "
        f"({N_GRAPHS / ms * 1e3:.0f} graphs/s); batch build + copy alone "
        f"{host_ms:.2f} ms; {want} calls x {call_ms:.4f} ms = "
        f"{want * call_ms:.2f} ms [{card}]")

    # 5. summary
    kernels = [{
        "name": "egnn_message", "ok": True, "route": "cuda",
        "source": "geometric_message_passing_tpu_torch/csrc/egnn_message.cu",
        "replaces": "geometric_message_passing_tpu/ops/pallas_edge.py:134",
        "launches": launches, "max_abs_err": err, "max_err": err,
        "ms": k_ms, "call_ms": call_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
    }]
    log(json.dumps({"kernels": kernels, "card": card,
                    "predict_ms": ms, "predict_graphs_per_s": N_GRAPHS / ms * 1e3,
                    "host_batch_ms": host_ms}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
