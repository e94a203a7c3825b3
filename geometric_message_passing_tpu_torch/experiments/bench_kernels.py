"""Device time of the EGNN kernels (K1, K2, K6), K5 (the GVP message pass),
K7 (TFN's CG contraction) and K3/K4 (the segment sums) at the shapes of
their main paths, split by CUDA kernel, on one CUDA card.

    python -m geometric_message_passing_tpu_torch.experiments.bench_kernels \
        [--only k6 | k2 | k1 | k5 | k5-box | k7 | k7-one-group | segsum
                | segsum-box | segsum-split | segsum-bitwise --io PATH]
    PYTHONPATH=<another checkout> python3 <this file> --only k6

The second form times another checkout's kernels (an older commit of the
port, unpacked with ``git archive``) through the calls both have, so two
designs can be compared in one call on one card: ``k6``, ``k2``, ``k1``,
``k5`` and ``k7-one-group`` use only calls that older checkouts of the port
have too, ``segsum`` and ``segsum-box`` calls that the port had before K3
and K4 took their scan route and in-kernel mask.

* ``k6``: K6 (``egnn_stack`` under ``no_grad``, ``egnn_stack_bwd``) with the
  weights of ``EGNNFusedModel(4 layers, 128 wide, pool "first")`` from seed
  0, random node features and cotangents, on the star train bucket
  (``bench.bench_data``'s first 100 train graphs: N 800, E 1400) and on the
  unsorted 10k-atom box (``bench_scale.box_batch``); the plain versions
  timed beside them, the time of each phase between K6's grid barriers
  from the kernel's clock stamps (``k6_phases``) and, at the train bucket,
  the kernel at each tile (``forced_egnn_tile``) beside the rule's choice.
* ``k2``: K2 (``egnn_message_bwd``) with that model's layer-0 message rows
  at the same two shapes, plain version beside it, and at the train bucket
  each tile.
* ``k1``: K1 (``egnn_message`` under ``no_grad``) with layer 0's message
  rows on the first serving batch of the 1400 star graphs (E 1408), the
  star train bucket and the box, plain beside it; the whole call split into
  the receiver CSR's kernels, the edge kernel and the reduce kernel; with a
  package that has them, the edge kernel's plan and clock readings by kind
  of step (``k1_phases``: weights, gather, products, cluster barriers, row
  steps), the serving bucket at every tile the plan could take, and the
  previous edge kernel's readings at every weight K-tile
  (``csrc/egnn_ring_probe.cu``, ``ring_probe_ktiles``).
* each of the three adds the registers, spills and stack frame of every
  kernel of the ``egnn_*`` sources (``resource_usage``).

* ``k5``: K5 at layer 0 of ``GVPGNNModel`` (4 layers, its defaults, weights
  from seed 0, ``use_pallas=True``): random node features and cotangents,
  the model's edge features, on the star train bucket
  (``bench.bench_data``'s first 100 train graphs) and on the unsorted
  10k-atom box (``bench_scale.box_batch``).  Forward ``gvp_message`` under
  ``no_grad``, backward ``gvp_message_bwd``.
* ``k5-box``: why K5's backward is slow on the 10k box: the edge kernels'
  registers, spills and shared memory (``cuobjdump --dump-resource-usage``
  of the built libraries), the shared memory a block needs at each tile
  (``gmp_gvp_{fwd,bwd}_smem``) and the blocks that fit an SM by it, and the
  box forward and backward with every edge tile forced in turn.
* ``k7``: K7 over one TFN layer's output-irrep groups at TFN's train bucket
  (E 1400, ``bench.TFN_STAR``), layer 0 and a hidden layer, f32 W, and the
  hidden layer with bf16 W: random T, W and cotangents, forward and
  backward through ``edge_weighted_contract_grouped`` (one launch per layer
  and direction); ``torch.bmm`` over the same groups is the library
  reading; then ``k7-one-group``.
* ``k7-one-group``: the same layers through the one-group entry
  (``edge_weighted_contract``, ``edge_weighted_contract_bwd``): one call
  per group back to back, then each group alone.

* ``segsum``: every K4 (``sorted_segsum.segment_sum``) and fold
  (``sorted_fold``) call of one train step and one predict batch of each
  star model at its main path's configuration (egnn per layer and whole
  stack, gvp, tfn, mace, dimenet, spherenet), of the expressivity arms'
  batches (``EXPRESSIVITY_MODELS``) and of the regression CLI's paired-star
  configurations (``CLI_MODELS``; ``capture_star_shapes``), each
  distinct shape once: E, N, D, live rows, the longest segment; the call
  by the profiler (device ms and launches a call, the segment-sum kernels
  apart), by events (whole call) and by the host clock (microseconds a
  call, no synchronize), K4's CSR-sort route beside its scan route, the
  fold with an accumulator, ``index_add_``, ``segment_reduce``, the plain
  version and the byte bound; then the box shapes (``segsum-box``: K3 on
  the sorted 100k box and K4 on its edges shuffled, D 128; K4 as the box's
  sum pool, D 176; the fold over the 10k box's 1.7M triplets, D 64) and K4's
  scan route against its CSR route from E 1024 to 24576
  (``scan_crossover``).
* ``segsum-split``: a long segment split across a cluster of blocks against
  one block, and the box pool's chunked path against one block
  (``segsum_split_readings``).
* ``segsum-bitwise --io PATH``: the star shapes' sums saved by one checkout
  and compared bitwise by another (``segsum_bitwise``).

Each reading: the whole call's mean time over ``--iters`` calls by CUDA
events after warm-up (``cuda_time_ms``), and the device time per call of
each CUDA kernel under ``torch.profiler`` over the same calls.  The last
line is one JSON object of the readings with the card's ``nvidia-smi`` name
and power limit.  It needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import inspect
import json
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from geometric_message_passing_tpu_torch.experiments import bench_scale
from geometric_message_passing_tpu_torch.experiments.bench import (
    BATCH_SIZE, bench_data, card_line, tfn_data, tfn_model)
from geometric_message_passing_tpu_torch.graph import (
    GraphLoader, assemble_batch, build_slot_data, pad_sizes)
from geometric_message_passing_tpu_torch.models import (EGNNFusedModel,
                                                        GVPGNNModel)
from geometric_message_passing_tpu_torch.ops import _build
from geometric_message_passing_tpu_torch.ops import edge
from geometric_message_passing_tpu_torch.ops import egnn_stack as es
from geometric_message_passing_tpu_torch.ops import edge_contract as ec
from geometric_message_passing_tpu_torch.ops import gvp_message as gm
from geometric_message_passing_tpu_torch.ops import scatter
from geometric_message_passing_tpu_torch.ops import sorted_segsum as sss

BOX_ATOMS = 10_000
EGNN_SOURCES = ("egnn_message", "egnn_message_bwd", "egnn_stack",
                "egnn_stack_bwd", "egnn_ring_probe")
# kernel-name fragments of each EGNN kernel's CUDA kernels
K1_NAMES, K2_NAMES, K6_NAMES = (("egnn_edge_kernel", "egnn_reduce_kernel"),
                                ("egnn_bwd_",), ("egnn_stack_",))


def cuda_time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls (CUDA
    events), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def short_name(key: str) -> str:
    """A profiler kernel name without its argument list and namespaces."""
    key = re.sub(r"\(anonymous namespace\)::|^void ", "", key)
    return re.sub(r"\(.*", "", key)[:80]


def kernel_split(fn, iters: int) -> dict:
    """Device ms per call of each CUDA kernel ``fn`` launches (profiler),
    by ``short_name``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = defaultdict(float)
    for ev in prof.key_averages():
        if (ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
                and not getattr(ev, "is_user_annotation", False)):
            split[short_name(ev.key)] += (ev.self_device_time_total
                                          / 1e3 / iters)
    return dict(sorted(split.items(), key=lambda kv: -kv[1]))


def reading(fn, iters: int, kernel_names) -> dict:
    """Whole-call ms, the per-kernel split and the named kernels' sum."""
    split = kernel_split(fn, iters)
    return {"call_ms": cuda_time_ms(fn, iters),
            "kernel_ms": sum(v for k, v in split.items()
                             if any(n in k for n in kernel_names)),
            "split_ms": split}


def gvp_layer_case(batch, model: GVPGNNModel, seed: int):
    """K5's inputs at layer 0 of ``model`` on ``batch`` (both on the card):
    random node features and cotangents, the model's edge features
    (``embed_edges``) and layer 0's chain weights."""
    dev = batch.pos.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, S, V = batch.num_nodes, model.s_dim, model.v_dim

    def draw():
        return [torch.randn((n, S), generator=gen, device=dev)] + [
            torch.randn((n, V), generator=gen, device=dev) for _ in range(3)]

    with torch.no_grad():
        es, ev = model.embed_edges(batch)
        ws = [w.detach().contiguous()
              for w in model.layers[0].conv.chain_weights()]
    return ((batch.senders, batch.receivers, batch.edge_mask), draw(),
            [es.contiguous()] + [ev[..., c].contiguous() for c in range(3)],
            ws, draw())


def k5_readings(iters_train: int, iters_box: int) -> dict:
    dev = torch.device("cuda")
    model = GVPGNNModel(num_layers=4, in_dim=1, out_dim=1, use_pallas=True,
                        device=dev, generator=torch.Generator().manual_seed(0))
    _, loaders = bench_data()
    slot = build_slot_data(loaders[0].graphs, device=dev)
    cases = {
        "train bucket": (gvp_layer_case(assemble_batch(
            slot, torch.arange(BATCH_SIZE, device=dev)), model, 31),
            iters_train),
        "10k box": (gvp_layer_case(bench_scale.box_batch(
            BOX_ATOMS, sort=False).to(dev), model, 32), iters_box)}
    out = {}
    for label, ((idx, nodes, edges, ws, cots), iters) in cases.items():
        with torch.no_grad():
            fwd = reading(lambda: gm.gvp_message(*idx, *nodes, *edges, *ws),
                          iters, ("gvp_",))
            bwd = reading(lambda: gm.gvp_message_bwd(*idx, *nodes, *edges, ws,
                                                     *cots),
                          iters, ("gvp_",))
        out[label] = {"E": int(idx[0].shape[0]), "live": int(idx[2].sum()),
                      "N": int(nodes[0].shape[0]), "fwd": fwd, "bwd": bwd}
    return out


def egnn_cases(dev, box: bool = True) -> dict:
    """The EGNN kernels' inputs on the card, by label: the star train bucket
    and (``box``) the unsorted 10k box, each ``(send, recv, emask, h, pos)``
    with random ``h``; the serving bucket (E 1408) the same; the stacked
    rows ``wall [4, 7D+18, D]`` of ``EGNNFusedModel(4, 128)`` from seed 0."""
    model = EGNNFusedModel(4, 128, 1, 1, pool="first", device="cpu",
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        wall = torch.stack([c.stack_packed() for c in model.convs]).to(dev)
    graphs, loaders = bench_data()
    slot = build_slot_data(loaders[0].graphs, device=dev)
    batches = {"train bucket": assemble_batch(
        slot, torch.arange(BATCH_SIZE, device=dev))}
    serve = next(iter(GraphLoader(graphs, BATCH_SIZE,
                                  pad=pad_sizes(graphs, BATCH_SIZE))))
    batches["serve bucket"] = serve.to(dev)
    if box:
        batches["10k box"] = bench_scale.box_batch(BOX_ATOMS, sort=False).to(dev)
    gen = torch.Generator(device=dev).manual_seed(70)
    cases = {}
    for label, b in batches.items():
        h = torch.randn((b.num_nodes, wall.shape[2]), generator=gen, device=dev)
        cases[label] = (b.senders, b.receivers, b.edge_mask, h, b.pos)
    return {"wall": wall, "cases": cases}


def k6_phases(args, wall, gh, gpos, reps: int = 5) -> dict:
    """K6's time by phase (us, the median of ``reps`` launches), from the
    kernels' clock stamps: forward edges and nodes per layer; backward the
    forward sweep's edges and nodes per layer, then per layer (L-1 first)
    the update MLP's backward, the edges' backward and the sums and weight
    gradients, and the last slice sum.  Each phase includes its grid
    barrier.  Empty for a checkout whose K6 takes no stamps."""
    if "stamps" not in inspect.signature(es._launch_fwd).parameters:
        return {}
    send, recv, emask, h = args[:4]
    (n, d), e, layers = h.shape, send.shape[0], wall.shape[0]
    rcsr = edge.receiver_csr(recv, emask, n)
    scsr = edge.sender_csr(send, emask, n)
    out = {}
    for direction, slots in (("fwd", 2 * layers + 1), ("bwd", 5 * layers + 2)):
        names = [f"{p} {l}" for l in range(layers) for p in ("edges", "nodes")]
        if direction == "bwd":
            names += [f"{p} {l}" for l in reversed(range(layers))
                      for p in ("node bwd", "edge bwd", "sums+dW")] + ["slice sum"]
        runs = []
        for _ in range(reps + 1):
            stamps = torch.zeros(slots, dtype=torch.int64, device=h.device)
            if direction == "fwd":
                es._launch_fwd(*args, wall, *rcsr,
                               es.fwd_buffers(n, e, d, h.device), stamps)
            else:
                es._launch_bwd(*args, wall, gh, gpos, rcsr, scsr,
                               es.bwd_buffers(n, e, d, layers, h.device), stamps)
            torch.cuda.synchronize()
            runs.append((stamps[1:] - stamps[:-1]).double().cpu() / 1e3)
        med = torch.stack(runs[1:]).median(dim=0).values
        out[direction] = dict(zip(names, [round(float(x), 3) for x in med]))
    return out


def k1_phases(args, w0, reps: int = 5) -> dict:
    """K1's edge kernel by kind of step (us, the median of ``reps``
    launches) from the clock readings of block 0's thread 0 (a product
    warp's): waiting for the weights, the gathers (what of them is not
    hidden), the products, the cluster barriers and the first two
    LayerNorm row steps, summed over its tiles (warps 4-7 copy the next
    tile's features during the last product and run the third row step
    during the next tile's first); the time until W1's rows were seen; the
    whole block."""
    send, recv, emask, h, pos = args
    (n, d), e = h.shape, send.shape[0]
    order, rowptr = edge.receiver_csr(recv, emask, n)
    bufs = [torch.empty(shape, device=h.device)
            for shape in ((e, d), (e, 3), (n, d), (n, 3), (n, 1))]
    kinds = ("weights", "gather", "products", "cluster barriers", "LN1",
             "LN2")
    runs = []
    for _ in range(reps + 1):
        stamps = torch.zeros(edge.RESIDENT_STAMPS, dtype=torch.int64,
                             device=h.device)
        edge._launch_kernels(*args, w0, order, rowptr, *bufs, stamps=stamps)
        torch.cuda.synchronize()
        s = stamps.cpu().tolist()
        us_per_cycle = (s[1] - s[0]) / s[2] / 1e3   # globaltimer ns over clock
        cycles = [s[2]] + s[3:3 + len(kinds)] + [s[4 + len(kinds)]]
        runs.append([c * us_per_cycle for c in cycles])
    med = torch.tensor(runs[1:], dtype=torch.float64).median(dim=0).values
    out = dict(zip(("block",) + kinds + ("W1 seen at",),
                   [round(float(x), 3) for x in med]))
    out["tiles"] = int(s[3 + len(kinds)])
    return out


def ring_probe_ktiles(args, w0, reps: int = 5) -> dict:
    """The previous K1 edge kernel (``csrc/egnn_ring_probe.cu``) at every
    weight K-tile of the middle block's tile (us, medians over ``reps``
    launches): the wait for its mbarrier, the block barrier after it, the
    products on it, the copy's flight from its issue to the mbarrier seen
    complete, and the time before its wait began since the last K-tile's
    products (the gather or a row step where a product starts).  Sums over
    the tile's K-tiles beside the block's whole time."""
    lib = _build.load("egnn_ring_probe")
    send, recv, emask, h, pos = args
    (n, d), e = h.shape, send.shape[0]
    ktiles = -(-(2 * d + 1) // 32) + 2 * -(-d // 32)
    msg_e, pos_e = torch.empty((e, d), device=h.device), torch.empty((e, 3), device=h.device)
    block = (-(-e // 16)) // 2
    dev = h.device.index if h.device.index is not None else torch.cuda.current_device()
    fields = ("wait", "barrier", "products", "flight", "before")
    runs, whole = [], []
    for _ in range(reps + 1):
        stamps = torch.zeros(4 + 5 * 32, dtype=torch.int64, device=h.device)
        _build.check(lib, lib.gmp_egnn_ring_probe(
            dev, send.data_ptr(), recv.data_ptr(), int(send.dtype == torch.int64),
            emask.data_ptr(), h.data_ptr(), pos.data_ptr(), w0.data_ptr(),
            msg_e.data_ptr(), pos_e.data_ptr(), stamps.data_ptr(), block, e, d,
            torch.cuda.current_stream().cuda_stream), "egnn ring probe")
        torch.cuda.synchronize()
        s = stamps.cpu().tolist()
        ns = (s[1] - s[0]) / (s[3] - s[2]) / 1e3          # us per cycle
        q = [s[4 + 5 * k: 9 + 5 * k] for k in range(ktiles)]   # issue, begin, seen, synced, done
        runs.append([[(t[2] - t[1]) * ns, (t[3] - t[2]) * ns, (t[4] - t[3]) * ns,
                      (t[2] - t[0]) * ns,
                      (t[1] - (q[k - 1][4] if k else s[2])) * ns]
                     for k, t in enumerate(q)])
        whole.append((s[3] - s[2]) * ns)
    med = torch.tensor(runs[1:], dtype=torch.float64).median(dim=0).values
    return {"block": block, "ktiles": ktiles,
            "block_us": round(float(torch.tensor(whole[1:]).median()), 3),
            "sum_us": {f: round(float(med[:, i].sum()), 3)
                       for i, f in enumerate(fields)},
            "per_ktile_us": {f: [round(float(x), 3) for x in med[:, i]]
                             for i, f in enumerate(fields)}}


@contextlib.contextmanager
def forced_resident_tile(tile: int):
    """K1's edge tile forced to ``tile`` (in place of ``resident_plan``'s
    choice) while the block runs."""
    saved = edge._resident_for

    def forced(n_edges, d, idx64, device):
        plan, _ = saved(n_edges, d, idx64, device)
        plan = plan._replace(tile=tile, smem_bytes=edge.resident_smem_bytes(
            d, plan.shares[0], tile))
        return plan, edge._resident_clusters(d, tile, idx64, device)

    edge._resident_for = forced
    try:
        yield
    finally:
        edge._resident_for = saved


def k1_split(split: dict) -> dict:
    """K1's whole call by part: the edge kernel, the reduce kernel and the
    rest (the receiver CSR's sort and search kernels)."""
    edge_ms = sum(v for k, v in split.items() if "egnn_edge_kernel" in k)
    reduce_ms = sum(v for k, v in split.items() if "egnn_reduce_kernel" in k)
    return {"receiver_csr": sum(split.values()) - edge_ms - reduce_ms,
            "edge kernel": edge_ms, "reduce kernel": reduce_ms}


def k1_readings(iters_small: int, iters_box: int) -> dict:
    """K1 at the serving bucket, the star train bucket and the 10k box (see
    the module's docstring)."""
    dev = torch.device("cuda")
    made = egnn_cases(dev)
    wall, cases = made["wall"], made["cases"]
    out = {}
    for label in ("serve bucket", "train bucket", "10k box"):
        args = cases[label]
        n, d = args[3].shape
        e = args[0].shape[0]
        iters = iters_box if label == "10k box" else iters_small
        w0 = wall[0, : edge.msg_rows(d)].contiguous()
        with torch.no_grad():
            fwd = reading(lambda: edge.egnn_message(*args, w0), iters, K1_NAMES)
            r = {"fwd": dict(fwd, parts_ms=k1_split(fwd["split_ms"])),
                 "fwd_plain_ms": cuda_time_ms(
                     lambda: edge.egnn_message_plain(*args, w0), iters)}
            if hasattr(edge, "resident_plan"):
                plan, clusters = edge.kernel_resident_plan(e, d, dev)
                r["plan"] = dict(plan._asdict(), clusters=clusters)
                r["phases_us"] = k1_phases(args, w0)
                if label == "serve bucket":
                    r["by_tile_ms"] = {}
                    for tile in edge.RESIDENT_TILES:
                        if edge.resident_smem_bytes(d, plan.shares[0], tile) > edge.SMEM_MAX:
                            continue
                        with forced_resident_tile(tile):
                            r["by_tile_ms"][tile] = reading(
                                lambda: edge.egnn_message(*args, w0), iters,
                                K1_NAMES)["kernel_ms"]
            if "egnn_ring_probe" in _build.SIGNATURES:
                r["previous_kernel_ktiles"] = ring_probe_ktiles(args, w0)
        out[label] = dict(r, N=n, E=e, live=int(args[2].sum()))
    return out


@contextlib.contextmanager
def forced_egnn_tile(tile: int):
    """K2's and K6's tile forced to ``tile`` (in place of ``egnn_tile``'s
    choice) while the block runs."""
    saved = edge._tile_for
    edge._tile_for = lambda n_edges, d, device: tile
    try:
        yield
    finally:
        edge._tile_for = saved


def egnn_readings(which: str, iters_small: int, iters_box: int) -> dict:
    """``which`` (k6 or k2) at its two shapes: whole call, device time by
    CUDA kernel, the plain version's call, with the shape's live edges."""
    dev = torch.device("cuda")
    made = egnn_cases(dev)
    wall, cases = made["wall"], made["cases"]
    labels = ("train bucket", "10k box")
    out = {}
    for label in labels:
        args = cases[label]
        n, d = args[3].shape
        iters = iters_box if label == "10k box" else iters_small
        gen = torch.Generator(device=dev).manual_seed(71)
        gh = torch.randn((n, d), generator=gen, device=dev)
        gpos = torch.randn((n, 3), generator=gen, device=dev)
        w0 = wall[0, : edge.msg_rows(d)].contiguous()
        layers = wall.shape[0]
        with torch.no_grad():
            if which == "k6":
                r = {"fwd": reading(lambda: es.egnn_stack(*args, wall, layers),
                                    iters, K6_NAMES),
                     "bwd": reading(lambda: es.egnn_stack_bwd(
                         *args, wall, layers, gh, gpos), iters, K6_NAMES),
                     "fwd_plain_ms": cuda_time_ms(lambda: es.egnn_stack_plain(
                         *args, wall, layers), iters),
                     "bwd_plain_ms": cuda_time_ms(
                         lambda: es.egnn_stack_bwd_plain(*args, wall, layers,
                                                         gh, gpos), iters),
                     "phases_us": k6_phases(args, wall, gh, gpos)}
            else:
                r = {"bwd": reading(lambda: edge.egnn_message_bwd(
                         *args, w0, gh, gpos), iters, K2_NAMES),
                     "bwd_plain_ms": cuda_time_ms(
                         lambda: edge.egnn_message_bwd_plain(*args, w0, gh,
                                                             gpos), iters)}
        if label != "10k box" and hasattr(edge, "egnn_tile"):
            # the train bucket at every tile, the rule's choice among them
            r["tile"] = edge.kernel_tile(args[0].shape[0], d, dev)
            r["by_tile_ms"] = {}
            for tile in edge.TILES:
                with forced_egnn_tile(tile), torch.no_grad():
                    fns = ({"fwd": lambda: es.egnn_stack(*args, wall, layers),
                            "bwd": lambda: es.egnn_stack_bwd(*args, wall, layers,
                                                             gh, gpos)}
                           if which == "k6" else
                           {"bwd": lambda: edge.egnn_message_bwd(*args, w0, gh,
                                                                 gpos)})
                    r["by_tile_ms"][tile] = {
                        k: reading(fn, iters, K6_NAMES if which == "k6"
                                   else K2_NAMES)["kernel_ms"]
                        for k, fn in fns.items()}
        out[label] = dict(r, N=n, E=int(args[0].shape[0]),
                          live=int(args[2].sum()))
    return out


def k7_layer(shapes, e: int, wdtype, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    Ts, Ws, dOs = [], [], []
    for k, m, w in shapes:
        Ts.append(torch.randn((e, k, m), generator=gen, device="cuda"))
        Ws.append(torch.randn((e, k, w), generator=gen, device="cuda")
                  .to(wdtype))
        dOs.append(torch.randn((e, w, m), generator=gen, device="cuda"))
    return Ts, Ws, dOs


def k7_readings(iters: int, grouped: bool = True) -> dict:
    """Per layer: the grouped launch each way (``grouped``) beside the
    groups' ``torch.bmm`` calls; the layer as one one-group call per group
    back to back; and each group alone through the one-group entry, with
    those kernels' sum (a lone group's W may stay in L2 from call to call;
    a hidden layer's W, 803 MB at E 1400, cannot)."""
    _, loaders = tfn_data()
    slot = build_slot_data(loaders[0].graphs, device="cuda")
    e = assemble_batch(slot, torch.arange(BATCH_SIZE, device="cuda")).num_edges
    tfn = tfn_model(torch.Generator().manual_seed(0), "cpu")
    out = {"E": e}
    for label, layer, wdtype in (("layer 0", 0, torch.float32),
                                 ("hidden", 1, torch.float32),
                                 ("hidden bf16 W", 1, torch.bfloat16)):
        shapes = tfn.convs[layer].tp.group_shapes
        Ts, Ws, dOs = k7_layer(shapes, e, wdtype, seed=60 + layer)
        r = out[label] = {"groups": [list(s) for s in shapes]}
        with torch.no_grad():
            if grouped:
                Wf = [W.float() for W in Ws]
                r["fwd"] = reading(lambda: ec.edge_weighted_contract_grouped(
                    Ts, Ws), iters, ("contract",))
                r["bwd"] = reading(lambda: ec.edge_weighted_contract_grouped_bwd(
                    Ts, Ws, dOs), iters, ("contract",))
                r["bmm_fwd_ms"] = cuda_time_ms(lambda: [
                    torch.bmm(W.transpose(1, 2), T) for T, W in zip(Ts, Wf)],
                    iters)
                r["bmm_bwd_ms"] = cuda_time_ms(lambda: [
                    (torch.bmm(W, dO), torch.bmm(T, dO.transpose(1, 2)))
                    for T, W, dO in zip(Ts, Wf, dOs)], iters)
                del Wf
            r["one_group_fwd"] = reading(lambda: [
                ec.edge_weighted_contract(T, W) for T, W in zip(Ts, Ws)],
                iters, ("contract",))
            r["one_group_bwd"] = reading(lambda: [
                ec.edge_weighted_contract_bwd(T, W, dO)
                for T, W, dO in zip(Ts, Ws, dOs)], iters, ("contract",))
            r["per_group"] = [{
                "fwd_ms": reading(lambda: ec.edge_weighted_contract(T, W),
                                  iters, ("contract",))["kernel_ms"],
                "bwd_ms": reading(lambda: ec.edge_weighted_contract_bwd(
                    T, W, dO), iters, ("contract",))["kernel_ms"]}
                for T, W, dO in zip(Ts, Ws, dOs)]
        r["one_group_sum"] = {d: sum(g[f"{d}_ms"] for g in r["per_group"])
                              for d in ("fwd", "bwd")}
        del Ts, Ws, dOs
        torch.cuda.empty_cache()
    return out


def resource_usage(sources=("gvp_message", "gvp_message_bwd")) -> dict:
    """Registers, stack, shared and local (spilled) bytes of each kernel of
    the built ``sources`` (``cuobjdump --dump-resource-usage``), by kernel:
    the raw line after each ``Function`` line; a source the package does
    not have is skipped."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    usage = {}
    for source in (s for s in sources if s in _build.SIGNATURES):
        _build.load(source)
        text = subprocess.run(
            [str(cuobjdump), "--dump-resource-usage", str(_build._target(source))],
            capture_output=True, text=True, timeout=120, check=True).stdout
        name = None
        for line in text.splitlines():
            line = line.strip()
            if line.startswith("Function "):
                name = line[len("Function "):].rstrip(":")
            elif name and line.startswith("REG:"):
                usage[f"{source}:{name}"] = line
                name = None
    return usage


@contextlib.contextmanager
def forced_tile(tile: int):
    """K5's edge tile forced to ``tile`` in both directions (in place of
    ``gvp_tile``'s choice) while the block runs."""
    saved = gm._tile_for
    gm._tile_for = lambda source, dims, n_edges, device: tile
    try:
        yield
    finally:
        gm._tile_for = saved


def k5_box_readings(iters: int) -> dict:
    """K5 on the unsorted 10k box at every edge tile whose shared memory
    fits, with the edge kernels' resources and the blocks per SM."""
    dev = torch.device("cuda")
    model = GVPGNNModel(num_layers=4, in_dim=1, out_dim=1, use_pallas=True,
                        device=dev, generator=torch.Generator().manual_seed(0))
    idx, nodes, edges, ws, cots = gvp_layer_case(bench_scale.box_batch(
        BOX_ATOMS, sort=False).to(dev), model, 32)
    dims = gm.chain_dims(ws)
    arr = gm._dims_array(dims)
    props = torch.cuda.get_device_properties(0)
    sm_bytes = getattr(props, "shared_memory_per_multiprocessor", 228 * 1024)
    out = {"E": int(idx[0].shape[0]), "live": int(idx[2].sum()),
           "chosen_tiles": list(gm.kernel_tiles(ws, idx[0].shape[0], dev)),
           "sm_shared_bytes": sm_bytes, "resources": resource_usage(),
           "tiles": {}}
    for tile in gm.TILES:
        row = {}
        for d, source, fn in (
                ("fwd", "gvp_message",
                 lambda: gm.gvp_message(*idx, *nodes, *edges, *ws)),
                ("bwd", "gvp_message_bwd",
                 lambda: gm.gvp_message_bwd(*idx, *nodes, *edges, ws, *cots))):
            lib = _build.load(source)
            smem_fn = (lib.gmp_gvp_fwd_smem if d == "fwd"
                       else lib.gmp_gvp_bwd_smem)
            smem = smem_fn(ctypes.addressof(arr), len(dims), tile)
            if not 0 < smem <= gm.SMEM_MAX:
                row[d] = {"smem_bytes": smem, "fits": False}
                continue
            with forced_tile(tile), torch.no_grad():
                r = reading(fn, iters, ("gvp_",))
            row[d] = dict(r, smem_bytes=smem,
                          blocks_per_sm_by_smem=sm_bytes // (smem + 1024))
        out["tiles"][tile] = row
    return out


HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12    # H100 SXM data sheet


def segsum_bound_ms(live: int, d: int, n: int, index_bytes: int) -> tuple:
    """Least time for a segment sum of ``live`` rows of width ``d`` into
    ``n`` segments: the rows read once, ``index_bytes`` of plan or ids and
    mask, the output written once, over HBM rate, against ``live * d`` adds
    over the f32 rate."""
    t_bytes = (4 * live * d + index_bytes + 4 * n * d) / HBM_BYTES_PER_S * 1e3
    t_ops = live * d / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def kernel_launches(fn, iters: int) -> dict:
    """Device ms and launches per call of each CUDA kernel (and copy or
    fill) ``fn`` runs, by ``short_name``, from the profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = defaultdict(lambda: [0.0, 0.0])
    for ev in prof.key_averages():
        if (ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
                and not getattr(ev, "is_user_annotation", False)):
            row = split[short_name(ev.key)]
            row[0] += ev.self_device_time_total / 1e3 / iters
            row[1] += ev.count / iters
    return {k: {"ms": v[0], "launches": v[1]}
            for k, v in sorted(split.items(), key=lambda kv: -kv[1][0])}


def host_us(fn, iters: int) -> float:
    """Host microseconds per call of ``fn`` (host clock, no synchronize
    inside the loop), after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def segsum_library_ms(data, ids, mask, n: int, iters: int) -> tuple:
    """Times of one PyTorch call computing the same sum: ``index_add_`` of
    the masked rows into a buffer, and ``torch.segment_reduce`` of the live
    rows in segment order (both prepared outside the timed loop)."""
    live = torch.ones_like(ids, dtype=torch.bool) if mask is None else mask
    masked = torch.where(live[:, None], data, torch.zeros_like(data))
    buf = torch.zeros((n, data.shape[1]), dtype=data.dtype, device=data.device)
    order, rowptr = edge.receiver_csr(ids, live, n)
    rows = data[order[:int(rowptr[-1])]]
    lengths = rowptr.diff()
    idx = ids.long()
    return (cuda_time_ms(lambda: buf.index_add_(0, idx, masked), iters),
            cuda_time_ms(lambda: torch.segment_reduce(rows, "sum",
                                                      lengths=lengths), iters))


@contextlib.contextmanager
def forced_k4_route(route: str):
    """K4 on ``route`` ("scan" or "csr") whatever its row count; nothing
    for a package whose K4 has only the CSR route."""
    if not hasattr(sss, "SCAN_MAX_ROWS"):
        yield
        return
    saved = sss.SCAN_MAX_ROWS
    sss.SCAN_MAX_ROWS = 1 << 30 if route == "scan" else -1
    try:
        yield
    finally:
        sss.SCAN_MAX_ROWS = saved


def has_k4_scan() -> bool:
    return hasattr(sss, "SCAN_MAX_ROWS")


def segsum_kernel_names(split: dict) -> dict:
    """The split's segment-sum kernels (``segsum``) apart from the rest (the
    CSR build's sort, searchsorted and fills, the masking pass)."""
    mine = {k: v for k, v in split.items() if "segsum" in k}
    return {"segsum_ms": sum(v["ms"] for v in mine.values()),
            "segsum_launches": sum(v["launches"] for v in mine.values()),
            "device_ms": sum(v["ms"] for v in split.values()),
            "device_launches": sum(v["launches"] for v in split.values())}


def segsum_call_reading(fn, iters: int, split: bool = True) -> dict:
    """A call's whole-call time (events) and host microseconds, and with
    ``split`` its device time and launches (profiler)."""
    res = {"call_ms": cuda_time_ms(fn, iters),
           "host_us": host_us(fn, 4 * iters)}
    if split:
        by_kernel = kernel_launches(fn, iters)
        res.update(segsum_kernel_names(by_kernel), split=by_kernel)
    return res


def segsum_shape(kind: str, data, ids, n: int, mask) -> dict:
    """E, N, D, live rows and the longest segment of one captured call."""
    live = (torch.ones_like(ids, dtype=torch.bool) if mask is None
            else mask.bool())
    lengths = torch.bincount(ids.long()[live], minlength=n)[:n]
    return {"kind": kind, "E": int(data.shape[0]), "N": int(n),
            "D": int(data.shape[1]), "live": int(live.sum()),
            "longest": int(lengths.max()) if n else 0,
            "ids": str(ids.dtype).replace("torch.", ""),
            "mask": mask is not None}


class SegsumCapture:
    """Record every K4 call (``sorted_segsum.segment_sum``) and every fold
    (``sorted_fold``) a model's train step and predict batch make: each
    distinct shape once, with its inputs, and the count by phase."""

    def __init__(self):
        self.shapes, self.calls = {}, defaultdict(int)
        self.phase = ""

    def _record(self, kind, data, ids, n, mask):
        shape = segsum_shape(kind, data, ids, n, mask)
        key = tuple(shape.values())
        if key not in self.shapes:
            self.shapes[key] = (shape, (data.detach().clone(), ids.clone(), n,
                                        None if mask is None else mask.clone()))
        self.calls[(self.phase, key)] += 1

    @contextlib.contextmanager
    def active(self):
        from geometric_message_passing_tpu_torch.models import dimenet as dm
        real_k4, real_fold = sss.segment_sum, sss.sorted_fold

        def k4(data, ids, n, mask=None):
            self._record("k4", data, ids, n, mask)
            return real_k4(data, ids, n, mask)

        def fold(data, ids, plan, mask=None, **kw):
            self._record("fold", data, ids, plan.num_segments, mask)
            return real_fold(data, ids, plan, mask, **kw)

        k4.launches = real_k4.launches
        saved = [(sss, "segment_sum", real_k4), (sss, "sorted_fold", real_fold),
                 (dm, "sorted_fold", dm.sorted_fold)]
        sss.segment_sum, sss.sorted_fold, dm.sorted_fold = k4, fold, fold
        try:
            yield
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)


# The expressivity arms' batches (the JAX package's behavioral tests'
# configurations, as ``chip_smoke.py`` phase 6m trains them): each task's
# two graphs in one batch with integer labels, and the model that reads them.
EXPRESSIVITY_MODELS = {
    "mpnn kchains": ("mpnn", dict(num_layers=3, emb_dim=32), "kchains"),
    "egnn kchains": ("egnn", dict(num_layers=3, emb_dim=32), "kchains"),
    "schnet two_body": ("schnet", dict(num_layers=1, hidden_channels=32),
                        "two_body"),
    "mace three_body": ("mace", dict(num_layers=1, emb_dim=8, max_ell=3,
                                     correlation=3, mlp_dim=32, pool="sum"),
                        "three_body")}

# The regression CLI's configurations as ``chip_smoke.py`` phases 7a-7d run
# them (1500 paired stars on fold 7, two pairs, batch 100): EGNN on the
# two-centre stars and on the one-centre stars (in_dim 4: the atom types'
# embedding gradient), and MACE with the mean pool over graph ids.
CLI_PAIRED = ["--n_pairs", "2", "--fold", "7", "--n_data", "1500"]
CLI_MODELS = {
    "cli egnn paired_star2": ["--model", "egnn", "--dataset", "paired_star2",
                              "--n_layers", "4", "--pool", "first"]
    + CLI_PAIRED,
    "cli egnn paired_star": ["--model", "egnn", "--dataset", "paired_star",
                             "--n_layers", "4", "--pool", "first"] + CLI_PAIRED,
    "cli mace paired_star": ["--model", "mace", "--dataset", "paired_star",
                             "--pool", "mean", "--n_layers", "2", "--max_ell",
                             "3"] + CLI_PAIRED}


def cli_models(dev) -> dict:
    """Each ``CLI_MODELS`` entry built as the CLI builds it (``make_dataset``,
    ``make_loaders``, ``make_model_func``; weights from seed 0), with its
    first train batch and first test batch on ``dev``."""
    from geometric_message_passing_tpu_torch.experiments import cli

    out = {}
    for label, argv in CLI_MODELS.items():
        args = cli.build_parser().parse_args(argv)
        data, model_args = cli.make_dataset(args)
        loaders = cli.make_loaders(args, data)
        model = cli.make_model_func(args)(
            **model_args, generator=torch.Generator().manual_seed(0),
            device=dev)
        out[label] = (model, (next(iter(loaders[0])).to(dev),
                              next(iter(loaders[2])).to(dev)))
    return out


def star_models(dev) -> dict:
    """Each star model at its main path's configuration with weights from
    seed 0, and its (train batch, predict batch) on the card; then each
    ``EXPRESSIVITY_MODELS`` entry with its one batch (k = 4 chains, the
    environment pairs) as both, and each ``CLI_MODELS`` entry
    (``cli_models``)."""
    from geometric_message_passing_tpu_torch import datasets
    from geometric_message_passing_tpu_torch.experiments import (
        bench_throughput as bt)
    from geometric_message_passing_tpu_torch.experiments.bench import (
        DIMENET_STAR, SPHERENET_STAR, bench_model, mace_data, mace_model,
        triplet_star_data)
    from geometric_message_passing_tpu_torch.models import model_registry

    def gen():
        return torch.Generator().manual_seed(0)

    def batches(loaders):
        return (next(iter(loaders[0])).to(dev), next(iter(loaders[2])).to(dev))

    _, egnn_loaders = bench_data()
    out = {"egnn": (bench_model(gen(), dev), batches(egnn_loaders)),
           "egnn_stack": (bench_model(gen(), dev, fuse_stack=True),
                          batches(egnn_loaders)),
           "gvp": (GVPGNNModel(num_layers=4, in_dim=1, out_dim=1,
                               use_pallas=True, device=dev, generator=gen()),
                   batches(egnn_loaders)),
           "tfn": (tfn_model(gen(), dev), batches(tfn_data()[1])),
           "mace": (mace_model(gen(), dev), batches(mace_data()[1]))}
    for name, cfg in (("dimenet", DIMENET_STAR), ("spherenet", SPHERENET_STAR)):
        model = bt.build(name, gen(), dev)
        out[name] = (model, batches(triplet_star_data(**cfg)[1]))
    for label, (name, kw, task) in EXPRESSIVITY_MODELS.items():
        graphs = (datasets.create_kchains(4) if task == "kchains"
                  else getattr(datasets, f"create_{task}_envs")())
        batch = next(iter(GraphLoader(graphs, batch_size=2,
                                      y_dtype=np.int32))).to(dev)
        model = model_registry[name](**kw, in_dim=1, out_dim=2,
                                     generator=gen(), device=dev)
        out[label] = (model, (batch, batch))
    out.update(cli_models(dev))
    return out


def capture_star_shapes(dev) -> SegsumCapture:
    """Run one train step (forward and backward; the L1-sum loss, or the
    cross-entropy for integer labels) and one predict batch (eval, no grad)
    of every ``star_models`` entry under a capture."""
    from geometric_message_passing_tpu_torch.experiments.train import LOSSES
    cap = SegsumCapture()
    for name, (model, (train_b, pred_b)) in star_models(dev).items():
        task = ("regression" if train_b.y.is_floating_point()
                else "classification")
        with cap.active():
            cap.phase = f"{name} train step"
            model.train()
            LOSSES[task](model(train_b), train_b).backward()
            cap.phase = f"{name} predict batch"
            model.eval()
            with torch.no_grad():
                model(pred_b)
        torch.cuda.synchronize()
    return cap


def segsum_reading(kind: str, inputs, iters: int,
                   split_all: bool = True) -> dict:
    """One captured shape on the card: the call as the package makes it
    (K4: ``segment_sum``; the fold: ``sorted_fold`` over ``ascending_plan``,
    and ``segment_sum_into`` with an accumulator), K4's CSR route beside a
    scan-route call, the plain version's error, ``index_add_``,
    ``segment_reduce`` and the bound.  The profiler splits the main call,
    and the others too with ``split_all``."""
    data, ids, n, mask = inputs
    res = {}
    with torch.no_grad():
        if kind == "k4":
            want = sss.sorted_segment_sum_plain(data, ids, n, mask)
            got = sss.segment_sum(data, ids, n, mask)
            res["call"] = segsum_call_reading(
                lambda: sss.segment_sum(data, ids, n, mask), iters)
            if has_k4_scan():
                res["route"] = sss.segsum_route(data.shape[0], n)[0]
                with forced_k4_route("csr"):
                    res["csr_route"] = segsum_call_reading(
                        lambda: sss.segment_sum(data, ids, n, mask), iters,
                        split_all)
            index_bytes = ids.shape[0] * (ids.element_size()
                                          + (0 if mask is None else 1))
        else:
            plan = sss.ascending_plan(ids, n)
            want = sss.sorted_segment_sum_plain(data, ids, n, mask)
            got = sss.sorted_fold(data, ids, plan, mask)
            acc = torch.randn_like(want)
            res["call"] = segsum_call_reading(
                lambda: sss.sorted_fold(data, ids, plan, mask), iters)
            res["with_acc"] = segsum_call_reading(
                lambda: scatter.segment_sum_into(acc, data, ids, mask,
                                                 plan=plan), iters, split_all)
            res["k4"] = segsum_call_reading(
                lambda: sss.segment_sum(data, ids, n, mask), iters, split_all)
            index_bytes = ids.shape[0] * (ids.element_size()
                                          + (0 if mask is None else 1))
        torch.cuda.synchronize()
        res["max_abs_err"] = (got - want).abs().max().item() if got.numel() else 0.0
        res["index_add_ms"], res["segment_reduce_ms"] = segsum_library_ms(
            data, ids, mask, n, iters)
        res["plain_ms"] = cuda_time_ms(
            lambda: sss.sorted_segment_sum_plain(data, ids, n, mask), iters)
    live = data.shape[0] if mask is None else int(mask.sum())
    res["bound_ms"], res["bound_by"] = segsum_bound_ms(live, data.shape[1], n,
                                                       index_bytes)
    return res


def box_segsum_inputs(dev) -> dict:
    """The box shapes of PERF.md's K3/K4 rows: K3 over the receiver plan of
    the sorted 100k box (D 128), K4 over its edges shuffled (D 128), K4 as
    the box's sum pool (D 176, one segment) and the fold over the 10k box's
    1.7M triplets (D 64)."""
    box = bench_scale.box_batch(100_000, sort=True).to(dev)
    gen = torch.Generator(device=dev).manual_seed(29)
    rows = torch.randn((box.num_edges, 128), generator=gen, device=dev)
    shuffle = torch.from_numpy(np.random.default_rng(28).permutation(
        box.num_edges)).to(dev)
    tri = bench_scale.box_batch(BOX_ATOMS, sort=False, triplets=True).to(dev)
    t = tri.triplets
    return {
        "K3 sorted 100k box D128": ("k3", rows, box.receivers, box.num_nodes,
                                    box.edge_mask),
        "K4 shuffled 100k box D128": ("k4", rows, box.receivers[shuffle],
                                      box.num_nodes, box.edge_mask[shuffle]),
        "K4 100k box pool D176": ("k4", torch.randn(
            (box.num_nodes, 176), generator=gen, device=dev), box.graph_id,
            box.num_graphs, box.node_mask),
        "fold 10k box D64": ("fold", torch.randn(
            (t.num_triplets, 64), generator=gen, device=dev), t.idx_ji,
            tri.num_edges, t.t_mask)}


def box_segsum_reading(kind, data, ids, n, mask, iters: int) -> dict:
    if kind != "k3":
        res = segsum_reading(kind, (data, ids, n, mask), iters)
        res.update(segsum_shape(kind, data, ids, n, mask))
        return res
    plan = sss.build_segment_plan(ids, n, mask=mask, device=data.device)
    with torch.no_grad():
        res = segsum_call_reading(
            lambda: sss.sorted_segment_sum(data, plan, ids, mask), iters)
    live = int(plan.rowptr[-1])
    res["bound_ms"], res["bound_by"] = segsum_bound_ms(live, 128, n,
                                                       8 * (n + 1))
    res.update(segsum_shape(kind, data, ids, n, mask))
    return res


def scan_crossover(dev, iters: int) -> dict:
    """K4's scan route against its CSR route as E grows (uniform random
    ids into E / 2 segments, 10% masked, D 64 and 128): whole call and
    device time, to place ``SCAN_MAX_ROWS``.  Empty without a scan route."""
    if not has_k4_scan():
        return {}
    out = {}
    gen = torch.Generator(device=dev).manual_seed(81)
    for d in (64, 128):
        for e in (1024, 4096, 8192, 16384, 24576):
            n = e // 2
            data = torch.randn((e, d), generator=gen, device=dev)
            ids = torch.randint(0, n, (e,), generator=gen, device=dev)
            mask = torch.rand(e, generator=gen, device=dev) > 0.1
            row = {}
            with torch.no_grad():
                for route in ("scan", "csr"):
                    with forced_k4_route(route):
                        r = segsum_call_reading(
                            lambda: sss.segment_sum(data, ids, n, mask), iters)
                    r.pop("split")
                    row[route] = r
            out[f"E {e} N {n} D {d}"] = row
    return out


def segsum_box_readings(iters: int) -> dict:
    """``--only segsum-box``: the box shapes alone."""
    _build.load("sorted_segsum")
    return {"box": {label: box_segsum_reading(*args, iters=iters)
                    for label, args in box_segsum_inputs(
                        torch.device("cuda")).items()}}


def segsum_readings(iters: int) -> dict:
    """``--only segsum``: every K4 and fold shape of the star models' train
    steps and predict batches, then the box shapes and (with a scan route)
    the crossover."""
    dev = torch.device("cuda")
    _build.load("sorted_segsum")
    cap = capture_star_shapes(dev)
    shapes = []
    for key, (shape, inputs) in cap.shapes.items():
        calls = {phase: c for (phase, k), c in cap.calls.items() if k == key}
        shapes.append(dict(shape, calls=calls,
                           **segsum_reading(shape["kind"], inputs, iters)))
    box = {label: box_segsum_reading(*args, iters=max(5, iters // 4))
           for label, args in box_segsum_inputs(dev).items()}
    return {"star_shapes": shapes, "box": box,
            "crossover": scan_crossover(dev, iters),
            "scan_max_rows": getattr(sss, "SCAN_MAX_ROWS", None)}


@contextlib.contextmanager
def forced_split(cluster: int, chunked: bool = True):
    """K3/K4 with clusters of ``cluster`` blocks at every row count
    (``sss.CLUSTER``; 1: one block splits a long segment), and without the
    chunked path unless ``chunked``."""
    saved = sss.CLUSTER, sss.CLUSTER_MAX_ROWS, sss.LONG_ROWS
    sss.CLUSTER, sss.CLUSTER_MAX_ROWS = cluster, 1 << 30
    if not chunked:
        sss.LONG_ROWS = 1 << 62
    try:
        yield
    finally:
        sss.CLUSTER, sss.CLUSTER_MAX_ROWS, sss.LONG_ROWS = saved


def split_reading(fn, iters: int) -> dict:
    """Segment-sum kernel ms and launches a call (profiler), whole call ms
    (events)."""
    r = segsum_kernel_names(kernel_launches(fn, iters))
    return {"kernel_ms": r["segsum_ms"], "launches": r["segsum_launches"],
            "device_launches": r["device_launches"],
            "call_ms": cuda_time_ms(fn, iters)}


def segsum_split_readings(iters: int) -> dict:
    """``--only segsum-split``: how a long segment is split.  At every
    captured star shape (``capture_star_shapes``) and at one segment of E
    rows (E 808 to 24576, D 128): clusters of ``sss.CLUSTER`` blocks against
    one block (cluster 1), in the order cluster, block, block, cluster (from
    ``LONG_ROWS`` rows a lone segment takes the chunked CSR route, so those
    read the chunked path whatever the cluster); at the 100k box's sum pool
    (D 176, one segment a graph) the chunked path against one block's
    split, in the order chunked, block, block, chunked."""
    dev = torch.device("cuda")
    _build.load("sorted_segsum")
    c = sss.CLUSTER
    cases = []
    cap = capture_star_shapes(dev)
    for shape, (data, ids, n, mask) in cap.shapes.values():
        if shape["kind"] == "k4":
            fn = (lambda data=data, ids=ids, n=n, mask=mask:
                  sss.segment_sum(data, ids, n, mask))
        else:
            plan = sss.ascending_plan(ids, n)
            fn = (lambda data=data, ids=ids, plan=plan, mask=mask:
                  sss.sorted_fold(data, ids, plan, mask))
        cases.append((shape, fn))
    gen = torch.Generator(device=dev).manual_seed(83)
    for e in (808, 2048, 4096, 8192, 16384, 24576):
        data = torch.randn((e, 128), generator=gen, device=dev)
        ids = torch.zeros(e, dtype=torch.int32, device=dev)
        shape = segsum_shape("k4", data, ids, 1, None)
        cases.append((shape, lambda data=data, ids=ids:
                      sss.segment_sum(data, ids, 1)))
    star = []
    with torch.no_grad():
        for shape, fn in cases:
            runs = []
            for cl in (c, 1, 1, c):
                with forced_split(cl):
                    runs.append(dict(split_reading(fn, iters), cluster=cl))
            star.append(dict(shape, runs=runs))
            print(json.dumps(star[-1]), file=sys.stderr, flush=True)
        box = bench_scale.box_batch(100_000, sort=True).to(dev)
        data = torch.randn((box.num_nodes, 176), generator=gen, device=dev)
        n = box.num_graphs
        pool = []
        for chunked in (True, False, False, True):
            with forced_split(1, chunked):
                pool.append(dict(split_reading(
                    lambda: sss.segment_sum(data, box.graph_id, n,
                                            box.node_mask),
                    max(3, iters // 4)), chunked=chunked))
    return {"cluster": c, "star_and_one_segment": star,
            "box_pool": dict(segsum_shape("k4", data, box.graph_id, n,
                                          box.node_mask), runs=pool)}


def segsum_bitwise(path: str) -> dict:
    """``--only segsum-bitwise --io PATH``: K4 and the fold at the captured
    star shapes against another checkout's, bitwise.  If PATH does not
    exist: capture the shapes, sum each with this package and save inputs,
    outputs and ``LONG_SEG`` there.  If it does (run then with an older
    checkout on ``PYTHONPATH``): sum each saved input with this package and
    compare segment by segment.  A segment of fewer than ``LONG_SEG`` live
    rows is summed by one lane group (one warp before), rows in ascending
    order in both, so it must be bitwise equal; the longer ones are split
    and compared within SEG_TOL of max(|ref|, 1).  Raises on a difference."""
    dev = torch.device("cuda")
    _build.load("sorted_segsum")

    def run(kind, data, ids, n, mask):
        with torch.no_grad():
            if kind == "k4":
                return sss.segment_sum(data, ids, n, mask)
            return sss.sorted_fold(data, ids, sss.ascending_plan(ids, n), mask)

    if not Path(path).exists():
        cap = capture_star_shapes(dev)
        saved = []
        for shape, (data, ids, n, mask) in cap.shapes.values():
            out = run(shape["kind"], data, ids, n, mask)
            saved.append((shape, [None if t is None else t.cpu()
                                  for t in (data, ids, mask, out)], n))
        torch.save({"long_seg": sss.LONG_SEG, "shapes": saved}, path)
        return {"saved": path, "shapes": len(saved)}
    blob = torch.load(path)
    rows = []
    for shape, (data, ids, mask, want), n in blob["shapes"]:
        data, ids = data.to(dev), ids.to(dev)
        mask = None if mask is None else mask.to(dev)
        got = run(shape["kind"], data, ids, n, mask).cpu()
        live = (torch.ones_like(ids, dtype=torch.bool) if mask is None
                else mask.bool())
        lengths = torch.bincount(ids.long()[live], minlength=n)[:n].cpu()
        short = lengths < blob["long_seg"]
        same = (got == want).all(dim=1)
        scale = max(1.0, want.abs().max().item()) if want.numel() else 1.0
        long_err = ((got - want)[~short].abs().max().item()
                    if bool((~short).any()) else 0.0)
        row = dict(shape, short_segments=int(short.sum()),
                   short_bitwise_equal=int((same & short).sum()),
                   long_segments=int((~short).sum()),
                   long_max_abs_diff=long_err)
        rows.append(row)
        if row["short_bitwise_equal"] != row["short_segments"] or \
                long_err > 1e-5 * scale:
            raise AssertionError(f"segsum-bitwise: differs at {row}")
    return {"compared": path, "shapes": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=("k6", "k2", "k1", "k5", "k5-box", "k7",
                                       "k7-one-group", "segsum", "segsum-box",
                                       "segsum-split", "segsum-bitwise"),
                    default=None)
    ap.add_argument("--io", default=None,
                    help="segsum-bitwise: the file of saved inputs and sums")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    result = {"card": card, "kind": torch.cuda.get_device_name(0)}
    for which in ("k6", "k2"):
        if args.only in (None, which):
            result[which] = egnn_readings(which, args.iters,
                                          max(2, args.iters // 4))
    if args.only in (None, "k1"):
        result["k1"] = k1_readings(args.iters, max(2, args.iters // 4))
    if args.only in (None, "k6", "k2", "k1"):
        result["egnn_resources"] = resource_usage(EGNN_SOURCES)
    if args.only in (None, "k5"):
        result["k5"] = k5_readings(args.iters, max(2, args.iters // 4))
    if args.only in (None, "k5-box"):
        result["k5_box"] = k5_box_readings(max(2, args.iters // 4))
    if args.only in (None, "k7", "k7-one-group"):
        result["k7"] = k7_readings(args.iters,
                                   grouped=args.only != "k7-one-group")
    if args.only in (None, "segsum"):
        result["segsum"] = segsum_readings(args.iters)
    if args.only == "segsum-box":
        result["segsum"] = segsum_box_readings(args.iters)
    if args.only == "segsum-split":
        result["segsum_split"] = segsum_split_readings(args.iters)
    if args.only == "segsum-bitwise":
        if args.io is None:
            raise SystemExit("bench_kernels: segsum-bitwise needs --io")
        result["segsum_bitwise"] = segsum_bitwise(args.io)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
