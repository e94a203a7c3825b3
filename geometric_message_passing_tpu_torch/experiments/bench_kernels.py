"""Device time of the EGNN kernels (K1, K2, K6), K5 (the GVP message pass)
and K7 (TFN's CG contraction) at the shapes of their main paths, split by
CUDA kernel, on one CUDA card.

    python -m geometric_message_passing_tpu_torch.experiments.bench_kernels \
        [--only k6 | k2 | k1 | k5 | k5-box | k7 | k7-one-group]
    PYTHONPATH=<another checkout> python3 <this file> --only k6

The second form times another checkout's kernels (an older commit of the
port, unpacked with ``git archive``) through the calls both have, so two
designs can be compared in one call on one card: ``k6``, ``k2``, ``k1``,
``k5`` and ``k7-one-group`` use only calls that older checkouts of the port
have too.

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
from collections import defaultdict
from pathlib import Path

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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=("k6", "k2", "k1", "k5", "k5-box", "k7",
                                       "k7-one-group"), default=None)
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
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
