#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile every CUDA kernel from ``csrc/`` (nvcc, sm_90a), one
     nvcc per source, all at once;
  3. kernels: hold each kernel against its plain PyTorch version on the card
     at three shapes, check that two runs are bitwise equal, and time
     kernel, whole call and plain version.  K1 (``egnn_message``): atol =
     rtol = 1e-4 (f32 sums in another order).  K2 (``egnn_message_bwd``):
     the same for dh and dpos, and dW within 1e-5 of its largest entry, at
     the small and train-bucket shapes; at N 10k / E 129k, where a few of
     the 50M ReLU pre-activations lie within f32 rounding of zero and flip
     (the plain f32 version differs from a float64 run just as much), at
     most 1% of node rows beyond 1e-4, no entry beyond 0.1, and dW within
     1e-3 of its largest entry;
  4. serve: star graphs (1400, fold 5/6/7, seed 0) through
     ``Predictor(EGNNFusedModel(4 layers, 128 wide, pool "first"))``, with
     the launch counters set to 0 just before and read just after; the
     result must be finite, of shape (1400, 1), and match the same weights
     run on the CPU through the plain path (atol 1e-4);
  5. train, against the CPU: the bench configuration (split 50/20/30,
     batch 100, lr 5e-4) from the same weights and the same shuffle, run on
     the card, on the CPU plain path in float32 and on the CPU in float64,
     and on the card twice more: with the plain message pass in place of
     K1/K2 (a witness of the card's rounding outside the kernels) and with a
     planted fault, the message weights cut off from the gradient (the
     card's message pass before it had a backward).  First one
     ``train_step``: every parameter's gradient on the card must lie within
     1e-2 of that parameter's largest float64 entry.  Then one epoch
     through ``fit_regression``: float32 rounding grows through the Adam
     steps, so that tolerance is measured: every step loss and MAE of the
     card must lie within 10x the CPU float32 run's largest relative
     distance from the float64 run (at least 1e-5) of the float64 value.
     The planted fault must fail both checks;
  6. train, the main path: one 200-epoch ``fit_regression`` on the card with
     the launch counters set to 0 just before and read just after: K2 must
     have launched 4 x (train steps) times, K1 4 x (train steps + validation
     batches + test batches of the epochs whose best-val rule fired); the
     test MAE must be finite and below 0.2;
  7. summary: one JSON line of kernels, then the device line last.

It imports nothing of JAX.  Peak rates for the bounds are the H100 SXM data
sheet's: 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s HBM.
"""

from __future__ import annotations

import contextlib
import copy
import json
import statistics
import sys
import time

import numpy as np
import torch

from geometric_message_passing_tpu_torch.experiments.bench import (
    LR, N_EPOCHS as EPOCHS, bench_data, card_line)
from geometric_message_passing_tpu_torch.experiments.infer import Predictor
from geometric_message_passing_tpu_torch.experiments.train import (
    fit_regression, make_tx, train_step)
from geometric_message_passing_tpu_torch.graph import (
    GraphLoader, assemble_batch, build_slot_data, pad_sizes)
from geometric_message_passing_tpu_torch.models import EGNNFusedModel, egnn_fused
from geometric_message_passing_tpu_torch.ops import _build
from geometric_message_passing_tpu_torch.ops import edge
from geometric_message_passing_tpu_torch.ops.edge import (
    egnn_message, egnn_message_bwd, egnn_message_bwd_plain, egnn_message_plain,
    msg_rows)

F32_FLOPS = 67e12          # H100 SXM, f32 on CUDA cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
ATOL = RTOL = 1e-4
GRAD_TOL = 1e-2   # one step's gradients, of each parameter's largest entry

N_GRAPHS, BATCH, LAYERS, WIDTH = 1400, 100, 4, 128


def log(*args) -> None:
    print(*args, flush=True)


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


def with_cotangents(args, seed: int):
    """``args`` of egnn_message plus random cotangents gmsg [N, D], gpos [N, 3]."""
    h = args[3]
    gen = torch.Generator(device=h.device).manual_seed(seed)
    return args + (torch.randn(h.shape, generator=gen, device=h.device),
                   torch.randn((h.shape[0], 3), generator=gen, device=h.device))


def train_bucket_case(loaders, model: EGNNFusedModel, seed: int, dev):
    """The first train batch of the bench split, assembled on the card from
    its slot data (N 800, E 1400), with random node features and
    cotangents and layer 0's packed weights."""
    slot = build_slot_data(loaders[0].graphs, device=dev)
    b = assemble_batch(slot, torch.arange(BATCH, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((b.num_nodes, model.emb_dim), generator=gen, device=dev)
    with torch.no_grad():
        w = model.convs[0].packed().detach().contiguous().to(dev)
    return with_cotangents((b.senders, b.receivers, b.edge_mask, h, b.pos, w),
                           seed + 1)


def check_bwd_case(name: str, args, large: bool = False) -> float:
    """K2 against its plain version (tolerances in the module docstring);
    returns the largest absolute difference."""
    got = egnn_message_bwd(*args)
    want = egnn_message_bwd_plain(*args)
    torch.cuda.synchronize()
    n = args[3].shape[0]
    worst = 0.0
    for g, w_, part in zip(got, want, ("dh", "dpos", "dW")):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: K2 {part} has non-finite values")
        err = (g - w_).abs()
        top = err.max().item() if err.numel() else 0.0
        worst = max(worst, top)
        if part == "dW":
            tol = (1e-3 if large else 1e-5) * w_.abs().max().item()
            ok, detail = top <= tol, f"tol {tol:.3e}"
        elif not large:
            ok = torch.allclose(g, w_, atol=ATOL, rtol=RTOL)
            detail = f"atol=rtol={ATOL}"
        else:
            bad = int((err > ATOL + RTOL * w_.abs()).any(dim=1).sum())
            ok = bad <= 0.01 * n and top <= 0.1
            detail = f"{bad} of {n} rows beyond 1e-4"
        log(f"  {name}: K2 {part} max_abs_err={top:.3e} ({detail})")
        if large and part == "dW":
            # how far each f32 version lies from a float64 run of the plain
            # version: the flips hit both, at different entries
            exact = egnn_message_bwd_plain(*(
                t.double() if t.is_floating_point() else t for t in args))
            for g64, w64, e64, p64 in zip(got, want, exact, ("dh", "dpos", "dW")):
                log(f"  {name}: {p64} vs float64: K2 "
                    f"{(g64.double() - e64).abs().max().item():.3e}, plain f32 "
                    f"{(w64.double() - e64).abs().max().item():.3e}")
        if not ok:
            raise AssertionError(f"{name}: K2 {part} differs from its plain "
                                 f"version by {top:.3e} ({detail})")
    return worst


def bwd_kernels_only_ms(args, iters: int = 50) -> float:
    """Device time of K2's kernels alone: the CSRs and the scratch are made
    once, outside the timed loop."""
    send, recv, emask, h, pos, w, gmsg, gpos = args
    (n, d), e = h.shape, send.shape[0]
    csrs = (edge.receiver_csr(recv, emask, n), edge.sender_csr(send, emask, n))
    scratch = edge.bwd_scratch(n, e, d, h.device)
    return cuda_time_ms(lambda: edge._launch_bwd_kernels(*args, *csrs, scratch),
                        iters)


def bwd_bound_ms(args) -> tuple:
    """Least time for egnn_message_bwd on these inputs: bytes (each input
    read once, each output written once) over HBM rate vs the operations
    that the masked-in edges need over the f32 rate."""
    send, recv, emask, h, pos, w, gmsg, gpos = args
    n, d = h.shape
    e = send.shape[0]
    n_bytes = (2 * e * send.element_size() + e
               + 4 * (h.numel() + pos.numel() + w.numel() + gmsg.numel()
                      + gpos.numel())
               + 4 * (n * d + n * 3 + w.numel()))
    e_live = int(emask.sum())
    products = 2 * d * (2 * d + 1) + 4 * d * d   # one pass of the 3 stages
    # the forward recomputed once (products, scale dot, 3 LayerNorm+ReLU),
    # the input cotangents dz W^T and the weight gradients x^T dz (twice the
    # products), 3 LayerNorm backward (~12 ops per element with the gamma
    # and beta terms), the scale head's 4D, the node sums of dh_i and dh_j
    # (2D + 6) and the 11 vector rows of dW (11D)
    per_edge = 3 * products + 2 * d + 27 * d + 36 * d + 4 * d + 2 * d + 6 + 11 * d
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = e_live * per_edge / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


@contextlib.contextmanager
def message_pass(fn):
    """Run ``EGNNFusedModel``'s layers through ``fn`` in place of
    ``egnn_message`` (phase 5's witness and planted fault)."""
    saved = egnn_fused.egnn_message
    egnn_fused.egnn_message = fn
    try:
        yield
    finally:
        egnn_fused.egnn_message = saved


def without_weight_grad(send, recv, emask, h, pos, packed_w):
    """The planted fault: ``egnn_message`` with the packed weights cut off
    from the gradient, so that no msg_*/pos_* parameter learns."""
    return egnn_message(send, recv, emask, h, pos, packed_w.detach())


def first_step(model, device, dtype, graphs, row):
    """One ``train_step`` of a copy of ``model`` on the graphs ``row``:
    each parameter's gradient (zero where it got none) and its value after
    the Adam step, in float64 on the CPU."""
    work = copy.deepcopy(model).to(device=device, dtype=dtype)
    slot = build_slot_data(graphs, device=device)
    train_step(work, make_tx(work.parameters(), LR), slot, row.to(device))
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in work.named_parameters()}
    return ({n: g.double().cpu() for n, g in grads.items()},
            {n: p.detach().double().cpu() for n, p in work.named_parameters()})


def step_reading(got, want) -> tuple:
    """How far one ``first_step`` lies from another: the largest gradient
    error relative to that parameter's largest reference entry, the count
    of gradient entries whose sign differs from a nonzero reference entry,
    and the largest parameter distance after the step in units of lr."""
    err, flips, moved = 0.0, 0, 0.0
    for name, g in got[0].items():
        ref = want[0][name]
        top = ref.abs().max().item()
        diff = (g - ref).abs().max().item()
        err = max(err, diff / top if top > 0 else diff)
        flips += int(((torch.sign(g) != torch.sign(ref)) & (ref != 0)).sum())
        moved = max(moved, (got[1][name] - want[1][name]).abs().max().item() / LR)
    return err, flips, moved


def fired_epochs(per_epoch: np.ndarray) -> int:
    """Epochs whose best-val rule fired (validation <= best so far, f32),
    each of which evaluated the test set."""
    best, fired = np.float32(np.inf), 0
    for val in per_epoch[:, 1].astype(np.float32):
        if val <= best:
            best, fired = val, fired + 1
    return fired


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
    graphs, loaders = bench_data()      # 1400 star graphs, fold 5/6/7, seed 0
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

    log("[kernels] egnn_message_bwd vs egnn_message_bwd_plain")
    small_b = with_cotangents(small, seed=4)
    train_b = train_bucket_case(loaders, cpu_model, seed=5, dev=dev)
    large_b = with_cotangents(large, seed=6)
    bwd_err = max(check_bwd_case("small", small_b),
                  check_bwd_case("train bucket", train_b))
    bwd_err_large = check_bwd_case("N=10k", large_b, large=True)
    for label, case in (("train bucket", train_b), ("N=10k", large_b)):
        first, second = egnn_message_bwd(*case), egnn_message_bwd(*case)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"egnn_message_bwd: two runs at {label} "
                                 "differ bitwise")
    log("  two runs at the train bucket and at N=10k are bitwise equal")
    bk_ms = bwd_kernels_only_ms(train_b)
    bcall_ms = cuda_time_ms(lambda: egnn_message_bwd(*train_b))
    bp_ms = cuda_time_ms(lambda: egnn_message_bwd_plain(*train_b))
    bk_ms_large = bwd_kernels_only_ms(large_b, iters=10)
    bcall_ms_large = cuda_time_ms(lambda: egnn_message_bwd(*large_b), iters=10)
    bp_ms_large = cuda_time_ms(lambda: egnn_message_bwd_plain(*large_b),
                               iters=10)
    bb_ms, bb_by = bwd_bound_ms(train_b)
    bb_ms_large, bb_by_large = bwd_bound_ms(large_b)
    for label, k, c, p, b, by in (
            ("train bucket", bk_ms, bcall_ms, bp_ms, bb_ms, bb_by),
            ("N=10k", bk_ms_large, bcall_ms_large, bp_ms_large, bb_ms_large,
             bb_by_large)):
        log(f"  {label}: K2 kernels {k:.4f} ms, whole call {c:.4f} ms, plain "
            f"{p:.4f} ms, bound {b:.5f} ms ({by}) [{card}]")

    # 4. serve
    model = EGNNFusedModel(LAYERS, WIDTH, 1, 1, pool="first",
                           generator=torch.Generator().manual_seed(0),
                           device="cuda")
    for key, value in model.state_dict().items():
        if not torch.equal(value.cpu(), cpu_model.state_dict()[key]):
            raise AssertionError(f"CPU and CUDA models differ at {key}")
    pred = Predictor(model, batch_size=BATCH)
    egnn_message.launches = egnn_message.bwd_launches = 0
    y = pred.predict(graphs)
    launches = egnn_message.launches
    if egnn_message.bwd_launches:
        raise AssertionError("predict launched the backward kernel")
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

    # 5. train, against the CPU: one step's gradients, then one epoch
    steps, val_b, test_b = (len(ld) for ld in loaders)
    order = torch.from_numpy(np.random.default_rng(7).permutation(
        loaders[0].num_examples))
    runs = (("card", "cuda", torch.float32, egnn_message),
            ("card, plain message pass", "cuda", torch.float32,
             egnn_message_plain),
            ("card, planted fault", "cuda", torch.float32, without_weight_grad),
            ("cpu f32", "cpu", torch.float32, egnn_message),
            ("cpu f64", "cpu", torch.float64, egnn_message))
    step, epoch = {}, {}
    for run, d_, dtype, fn in runs:
        with message_pass(fn):
            step[run] = first_step(cpu_model, d_, dtype, loaders[0].graphs,
                                   order[:BATCH])
            egnn_message.launches = egnn_message.bwd_launches = 0
            res = fit_regression(copy.deepcopy(cpu_model).to(dtype=dtype), None,
                                 *loaders, n_epochs=1, lr=LR, seed=0,
                                 device=d_, epoch_order=lambda e: order)
        epoch[run] = np.concatenate([res.train_losses.ravel(),
                                     res.perf_per_epoch.ravel()]).astype(np.float64)
        if run == "card":
            one_epoch = (egnn_message.launches, egnn_message.bwd_launches)
    want_one = (LAYERS * (steps + val_b + test_b), LAYERS * steps)
    exact = epoch["cpu f64"]
    spread = float(np.max(np.abs(epoch["cpu f32"] - exact) / np.abs(exact)))
    tol = max(1e-5, 10 * spread)
    log(f"[train] one step (graphs order[:{BATCH}]) and one epoch ({steps} "
        "step losses, test and val MAE) against the CPU float64 run: "
        f"gradients tol {GRAD_TOL:g} of each parameter's largest entry, "
        f"epoch tol {tol:.3e} relative (10x the CPU float32 run's); launches "
        f"K1 {one_epoch[0]}, K2 {one_epoch[1]} (want {want_one})")
    check = {}
    for run, *_ in runs[:-1]:
        g_err, flips, moved = step_reading(step[run], step["cpu f64"])
        rel = np.abs(epoch[run] - exact) / np.abs(exact)
        e_err = float(rel.max())
        check[run] = {"grad_err": g_err, "sign_flips": flips,
                      "step_lr": moved, "epoch_err": e_err}
        log(f"  {run}: gradients within {g_err:.3e}, {flips} signs differ, "
            f"parameters within {moved:.3f} lr after the step; epoch within "
            f"{e_err:.3e} (by step loss, then test, val: "
            f"{' '.join(f'{r:.1e}' for r in rel)})")
    if check["card"]["grad_err"] > GRAD_TOL:
        raise AssertionError("the gradients on the card do not match the CPU")
    fault = check["card, planted fault"]
    if fault["grad_err"] <= GRAD_TOL or fault["epoch_err"] <= tol:
        raise AssertionError("a check of phase 5 passed the planted fault")
    if check["card"]["epoch_err"] > tol or one_epoch != want_one:
        raise AssertionError("the epoch on the card does not match the CPU")

    # 6. train, the main path
    egnn_message.launches = egnn_message.bwd_launches = 0
    res = fit_regression(model, None, *loaders, n_epochs=EPOCHS, lr=LR,
                         seed=1, device="cuda")
    train_launches = (egnn_message.launches, egnn_message.bwd_launches)
    fired = fired_epochs(res.perf_per_epoch)
    want_train = (LAYERS * (EPOCHS * (steps + val_b) + fired * test_b),
                  LAYERS * EPOCHS * steps)
    graphs_per_s = EPOCHS * loaders[0].num_examples / res.train_time
    log(f"[train] fit_regression {EPOCHS} epochs: train_time "
        f"{res.train_time:.3f} s ({graphs_per_s:.0f} train graphs/s), test "
        f"MAE {res.test:.5f}, best val MAE {res.best_val:.5f}; launches K1 "
        f"{train_launches[0]}, K2 {train_launches[1]} (want {want_train}, "
        f"{fired} test passes) [{card}]")
    if train_launches != want_train:
        raise AssertionError(f"training launched {train_launches}, "
                             f"expected {want_train}")
    if not (np.isfinite(res.test) and res.test < 0.2):
        raise AssertionError(f"test MAE {res.test} is not finite and below 0.2")

    # 7. summary
    kernels = [{
        "name": "egnn_message", "ok": True, "route": "cuda",
        "source": "geometric_message_passing_tpu_torch/csrc/egnn_message.cu",
        "replaces": "geometric_message_passing_tpu/ops/pallas_edge.py:134",
        "launches": train_launches[0], "serve_launches": launches,
        "max_abs_err": err, "max_err": err,
        "ms": k_ms, "call_ms": call_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
    }, {
        "name": "egnn_message_bwd", "ok": True, "route": "cuda",
        "source": "geometric_message_passing_tpu_torch/csrc/egnn_message_bwd.cu",
        "replaces": "geometric_message_passing_tpu/ops/pallas_edge.py:246",
        "launches": train_launches[1], "max_abs_err": bwd_err,
        "max_abs_err_n10k": bwd_err_large, "ms": bk_ms, "call_ms": bcall_ms,
        "plain_ms": bp_ms, "bound_ms": bb_ms, "bound_by": bb_by,
        "library_ms": None,
    }]
    log(json.dumps({"kernels": kernels, "card": card,
                    "predict_ms": ms, "predict_graphs_per_s": N_GRAPHS / ms * 1e3,
                    "host_batch_ms": host_ms, "train_time_s": res.train_time,
                    "train_epochs": EPOCHS, "test_mae": res.test,
                    "best_val_mae": res.best_val, "train_check": check,
                    "train_check_epoch_tol": tol}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
