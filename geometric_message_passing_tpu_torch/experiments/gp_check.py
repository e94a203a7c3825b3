"""Graph partitioning at full width on one card: four gloo ranks sharing
it, each held to the single-rank model on the same card.

    python -m geometric_message_passing_tpu_torch.experiments.gp_check

One launch of 4 gloo ranks on ``cuda:0`` (``parallel.launch.spawn``; NCCL
refuses two ranks on one GPU).  The box is the box-scale rows' 10k-atom
molecular box (``bench_scale.box_batch``'s, 129,224 edges), Morton-
relabeled (``parallel.partition``), its node rows padded to a multiple of
4 and cut by ``build_halo_plan``.  Every rank computes the single-rank
references itself on the card, one rank at a time (their memory is
released before the next starts):

  a. ``MACEForceField`` as the ``mace_ff`` row of ``bench_scale`` at 10k
     atoms (2 layers, emb 64, max_ell 3, correlation 3, edge chunks of
     16384, in_dim 8, ``avg_num_neighbors`` the box's mean degree) with
     ``gp_axis``: the energy within ``E_ATOL`` + ``E_RTOL`` |ref| of the
     single-rank forward, the gradients of sum(E^2) (each rank's summed
     over the axis) within ``GRAD_TOL`` of each tensor's largest entry of
     the single-rank gradients (the JAX tests' gp tolerances,
     ``tests/test_parallel.py``); ``halo_stats`` of the 1024-float irreps
     row, its wire bytes below the all-gather's; K4 launches a step, which
     must be 2 x (the local edge chunks + 1 pool); a step's ms a rank at
     world 4 and in one process;
  b. ``gp_egnn_layer`` stacked: 4 ``EGNNLayer`` of width 128 (the box
     EGNN's; layer l's weights from seed l, h from seed 0, the residual as
     ``EGNNModel``), and the v0, packed and overlapped aggregations of
     ``0.5 h_tgt + h_src`` at D 128, each within ``OUT_TOL`` of max(|ref|,
     1); the overlapped round's ms beside the packed one's, the exchange
     alone and the interior work alone (does gloo overlap anything?);
  c. ``dp_train_step_autoshard`` on the star bench's model (EGNN 4 x 128,
     ``bench.bench_model``), its first 100 training graphs (the bucket's
     rows rounded up to multiples of 4) cut into 4 row blocks, against the
     single-rank Adam step at lr 5e-4: the weights within atol
     ``AUTO_TOL``, the loss within rtol ``AUTO_TOL``; K1 / K2 / K4 4 / 4 /
     1 a step;
  d. rank 0 holds K4 against its plain version and float64
     (``tp_check.hold_k4``) on the inputs of every sum of one gp MACE-FF
     step and one ``gp_egnn_layer`` (the catalog-indexed messages: E_loc
     rows into n_local segments, the CSR route above 24576 rows).

``run`` returns the readings and the failed checks; the main prints them
as one JSON line and exits 1 on any failure.  It needs a card.
"""

from __future__ import annotations

import contextlib
import json
import math
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import datasets
from ..graph import GraphBatch, batch_graphs, pad_sizes
from ..models import MACEForceField
from ..models.egnn import EGNNLayer
from ..ops import edge as edge_ops
from ..ops import sorted_segsum as sss
from ..ops.scatter import segment_sum
from ..parallel import (HaloPlan, autoshard_rows, build_halo_plan,
                        dp_train_step_autoshard, gp_edge_aggregate,
                        gp_egnn_layer, gp_rank_batch, halo_stats, launch,
                        make_mesh, morton_partition_graph,
                        packed_halo_aggregate,
                        packed_halo_aggregate_overlapped)
from ..parallel import halo as halo_mod
from ..parallel.data import all_reduce_grads
from ..parallel.mesh import differentiable
from .bench import BATCH_SIZE, LR, WIDTH, bench_data, bench_model, card_line
from .bench_scale import config, mean_degree
from .tp_check import hold_k4, window
from .train import l1_sum_loss, make_tx

WORLD = GP = 4
BOX_ATOMS = 10_000
EGNN_LAYERS = 4
E_ATOL, E_RTOL = 5e-4, 1e-4   # energy, the JAX gp tests'
GRAD_TOL = 2e-3               # of each tensor's largest entry
OUT_TOL = 2e-5                # of max(|ref|, 1)
AUTO_TOL = 1e-5
TIME_STEPS = 5
TIMEOUT_S = 900


def counts() -> dict:
    return {"k1": edge_ops.egnn_message.launches,
            "k2": edge_ops.egnn_message.bwd_launches,
            "k4": sss.segment_sum.launches}


def reset_counts() -> None:
    edge_ops.egnn_message.launches = edge_ops.egnn_message.bwd_launches = 0
    sss.segment_sum.launches = 0


def gp_box(k: int = GP) -> GraphBatch:
    """The 10k-atom box (``bench_scale.box_batch``'s graph), Morton-
    relabeled, its node rows a multiple of ``k``; on the host."""
    g = datasets.create_molecular_boxes(num=1, n_nodes=BOX_ATOMS, cutoff=3.0,
                                        avg_degree=14.0, n_species=8,
                                        seed=0)[0]
    g = morton_partition_graph(g)
    n_pad, e_pad, g_pad = pad_sizes([g], 1)
    return batch_graphs([g], -(-n_pad // k) * k, e_pad, g_pad)


def box_plan(box: GraphBatch, k: int = GP) -> HaloPlan:
    return build_halo_plan(box.senders.numpy(), box.receivers.numpy(),
                           box.num_nodes, k, edge_mask=box.edge_mask.numpy())


def mace_ff_kw(box: GraphBatch) -> dict:
    """The ``mace_ff`` row's configuration at this box."""
    return dict(in_dim=8, avg_num_neighbors=mean_degree(box),
                **config("mace_ff", BOX_ATOMS))


def mace_k4_per_step(e_loc: int, edge_chunk: int, layers: int) -> int:
    """K4 in one gp MACE-FF step of a rank: each layer's chunk sums and its
    pool (the backward adds none: ``bench_scale.ff_k4_launches_per_step``)."""
    return layers * (math.ceil(e_loc / edge_chunk) + 1)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _one_at_a_time(mesh, fn):
    """``fn()`` on each rank in turn (the others wait), its cached memory
    released before the next rank starts; returns this rank's result."""
    out = None
    for r in range(mesh.shape["gp"]):
        if mesh.rank == r:
            out = fn()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _timed(fn) -> float:
    """ms per call: ``TIME_STEPS`` calls after two warm ones."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(TIME_STEPS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / TIME_STEPS * 1e3


def _scaled(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) / max(
        float(want.abs().max()), 1.0)


def _part_mace(mesh, box, plan) -> tuple:
    """(a) on this rank."""
    dev, me = mesh.device, mesh.coords["gp"]
    kw = mace_ff_kw(box)
    model = MACEForceField(**kw, gp_axis="gp", mesh=mesh, generator=_gen(0),
                           device=dev)
    params = list(model.parameters())
    local = gp_rank_batch(box.to(dev), plan.to(dev), me)
    plan_local = plan.to(dev).local(me)

    def step():
        model.zero_grad(set_to_none=True)
        energy = model(local, halo_plan=plan_local)
        (energy ** 2).sum().backward()
        all_reduce_grads(mesh, params, "gp")
        return energy.detach()

    reset_counts()
    energy = step()
    torch.cuda.synchronize()
    launched = counts()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    def reference():
        single = MACEForceField(**kw, generator=_gen(0), device=dev)
        single.load_state_dict(model.state_dict())
        whole = box.to(dev)
        e_ref = single(whole)
        (e_ref ** 2).sum().backward()
        worst = max(float((grads[n] - p.grad).abs().max())
                    / max(float(p.grad.abs().max()), 1.0)
                    for n, p in single.named_parameters())
        out = {"energy": float(energy.sum()), "ref_energy": float(
            e_ref.detach().sum()),
            "energy_err": float((energy - e_ref.detach()).abs().max()),
            "grad_err": worst}
        if dist.get_rank() == 0:      # one process alone on the card
            def one():
                single.zero_grad(set_to_none=True)
                (single(whole) ** 2).sum().backward()
            out["ms_per_step_single"] = _timed(one)
        return out

    out = _one_at_a_time(mesh, reference)
    out["ms_per_step"] = _timed(step)
    e_loc = int(plan.edge_src_cat.shape[1])
    want = mace_k4_per_step(e_loc, kw["edge_chunk"], len(model.interactions))
    out.update(launches=launched, want_launches={"k1": 0, "k2": 0,
                                                 "k4": want},
               e_loc=e_loc, n_local=plan.n_local,
               halo=halo_stats(plan, model.hidden_irreps.dim,
                               num_nodes=box.num_nodes),
               config={k: v for k, v in kw.items()})
    fails = []
    if out["energy_err"] > E_ATOL + E_RTOL * abs(out["ref_energy"]):
        fails.append(f"energy {out['energy_err']:.3e} from the single rank")
    if out["grad_err"] > GRAD_TOL:
        fails.append(f"gradients {out['grad_err']:.3e} > {GRAD_TOL}")
    if launched["k4"] != want or launched["k1"] or launched["k2"]:
        fails.append(f"launches {launched}, K4 expected {want}")
    if out["halo"]["wire_bytes"] >= out["halo"]["allgather_bytes"]:
        fails.append(f"halo {out['halo']}: wire bytes not below the "
                     "all-gather's")
    return out, fails


def _part_egnn(mesh, box, plan) -> tuple:
    """(b) on this rank."""
    dev, me = mesh.device, mesh.coords["gp"]
    n = box.num_nodes
    rows = slice(me * plan.n_local, (me + 1) * plan.n_local)
    layers = [EGNNLayer(WIDTH, generator=_gen(l)).to(dev)
              for l in range(EGNN_LAYERS)]
    h0 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n, WIDTH)).astype(np.float32)).to(dev)
    whole, on_dev = box.to(dev), plan.to(dev)
    plan_local = on_dev.local(me)
    out, fails = {}, []

    reset_counts()
    with torch.no_grad():
        h, pos = h0[rows], whole.pos[rows]
        for layer in layers:
            upd, pos = gp_egnn_layer(layer, h, pos, plan_local, mesh)
            h = h + upd
    torch.cuda.synchronize()
    out["launches"] = counts()

    def add(t, u):
        return 0.5 * t + u

    snd, rcv, emask = whole.senders, whole.receivers, whole.edge_mask
    k = mesh.shape["gp"]
    e_pad = -(-snd.shape[0] // k) * k       # v0: equal edge blocks

    def pad(x, fill):
        return torch.cat([x, x.new_full((e_pad - x.shape[0],), fill)])

    v0_edges = [pad(x, f).reshape(k, -1)[me]
                for x, f in ((snd, 0), (rcv, 0), (emask, False))]
    with torch.no_grad():
        got = {"v0": gp_edge_aggregate(h0[rows], *v0_edges, add, n, mesh),
               "packed": packed_halo_aggregate(h0[rows], plan_local, add,
                                               mesh),
               "overlapped": packed_halo_aggregate_overlapped(
                   h0[rows], plan_local, add, mesh)}

    def reference():
        with torch.no_grad():
            hr, pr = h0, whole.pos
            for layer in layers:
                upd, pr = layer(hr, pr, snd, rcv, emask)
                hr = hr + upd
            agg = segment_sum(add(h0[rcv], h0[snd]), rcv, n, mask=emask)
        res = {"h_err": _scaled(h, hr[rows]),
               "pos_err": _scaled(pos, pr[rows])}
        res.update({f"{name}_err": _scaled(v, agg[rows])
                    for name, v in got.items()})
        return res

    out.update(_one_at_a_time(mesh, reference))
    for key in ("h_err", "pos_err", "v0_err", "packed_err",
                "overlapped_err"):
        if out[key] > OUT_TOL:
            fails.append(f"{key} {out[key]:.3e} > {OUT_TOL}")
    if out["launches"]["k4"] != EGNN_LAYERS:
        fails.append(f"gp_egnn_layer launches {out['launches']}, K4 "
                     f"expected {EGNN_LAYERS}")

    # the overlap: the packed round, the overlapped one, and its parts
    payload = halo_mod._payload(h0[rows], plan_local)
    int_tgt = plan_local["int_tgt"]
    with torch.no_grad():
        out["ms"] = {
            "packed": _timed(lambda: packed_halo_aggregate(
                h0[rows], plan_local, add, mesh)),
            "overlapped": _timed(lambda: packed_halo_aggregate_overlapped(
                h0[rows], plan_local, add, mesh)),
            "all_to_all_alone": _timed(lambda: differentiable.all_to_all(
                mesh, payload, "gp")),
            "interior_alone": _timed(lambda: segment_sum(
                add(h0[rows][int_tgt], h0[rows][plan_local["int_src"]]),
                int_tgt, plan.n_local, mask=plan_local["int_mask"]))}
    out["halo"] = halo_stats(plan, WIDTH + 3, num_nodes=n)
    out["interior_edges"] = int(plan.int_mask[me].sum())
    out["boundary_edges"] = int(plan.bnd_mask[me].sum())
    return out, fails


def _part_autoshard(mesh) -> tuple:
    """(c) on this rank."""
    dev = mesh.device
    graphs, (n_pad, e_pad, g_pad) = window(bench_data)
    k = mesh.shape["gp"]           # every field's rows split k ways
    big = batch_graphs(graphs, -(-n_pad // k) * k, -(-e_pad // k) * k,
                       -(-g_pad // k) * k)
    model = bench_model(_gen(0), device=dev)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step = dp_train_step_autoshard(model, make_tx(model.parameters(), LR),
                                   mesh, l1_sum_loss, axis="gp")
    rows = autoshard_rows(big, mesh.shape["gp"], mesh.coords["gp"]).to(dev)
    reset_counts()
    loss = float(step(rows))
    torch.cuda.synchronize()
    launched = counts()
    got = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def reference():
        single = bench_model(_gen(0), device=dev)
        single.load_state_dict(sd)
        opt = make_tx(single.parameters(), LR)
        whole = big.to(dev)
        single.train()
        ref = l1_sum_loss(single(whole), whole)
        ref.backward()
        opt.step()
        return {"loss": loss, "ref_loss": float(ref.detach()),
                "param_err": max(float((got[k] - v).abs().max())
                                 for k, v in single.state_dict().items())}

    out = _one_at_a_time(mesh, reference)
    out["launches"] = launched
    out["shapes"] = {"rows_per_rank": [int(x) for x in (
        rows.num_nodes, rows.num_edges, rows.num_graphs)],
        "whole": [int(x) for x in (big.num_nodes, big.num_edges,
                                   big.num_graphs)]}
    fails = []
    rel = abs(out["loss"] - out["ref_loss"]) / abs(out["ref_loss"])
    if rel > AUTO_TOL or out["param_err"] > AUTO_TOL:
        fails.append(f"loss {rel:.3e} apart, weights {out['param_err']:.3e}")
    want = {"k1": 4, "k2": 4, "k4": 1}
    if launched != want:
        fails.append(f"launches {launched}, expected {want}")
    return out, fails


@contextlib.contextmanager
def recording(on: bool):
    """Record the inputs of every K4 call while the block runs (``on``);
    the calls themselves are unchanged."""
    rec = []
    kernel = sss.segment_sum

    def k4_rec(data, ids, n, mask=None):
        rec.append((data.detach().clone(), ids, n, mask))
        return kernel(data, ids, n, mask)

    k4_rec.launches = 0      # the kernel's wrapper counts on its own name
    if on:
        sss.segment_sum = k4_rec
    try:
        yield rec
    finally:
        sss.segment_sum = kernel


def _part_kernels(mesh, box, plan) -> tuple:
    """(d): every rank runs the recorded gp MACE-FF step and EGNN layer
    (their collectives need all); rank 0 records and holds K4."""
    dev, me = mesh.device, mesh.coords["gp"]
    on_dev = plan.to(dev)
    local = gp_rank_batch(box.to(dev), on_dev, me)
    model = MACEForceField(**mace_ff_kw(box), gp_axis="gp", mesh=mesh,
                           generator=_gen(0), device=dev)
    layer = EGNNLayer(WIDTH, generator=_gen(0)).to(dev)
    rows = slice(me * plan.n_local, (me + 1) * plan.n_local)
    h = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (box.num_nodes, WIDTH)).astype(np.float32)).to(dev)[rows]
    with recording(mesh.rank == 0) as rec:
        energy = model(local, halo_plan=on_dev.local(me))
        (energy ** 2).sum().backward()
        with torch.no_grad():
            gp_egnn_layer(layer, h, local.pos, on_dev.local(me), mesh)
    del model
    torch.cuda.empty_cache()
    if mesh.rank != 0:
        return {}, []
    out, fails = [], []
    for i, args in enumerate(rec):
        reading, f = hold_k4(f"gp sum {i}", *args)
        reading["route"] = sss.segsum_route(int(args[0].shape[0]),
                                            int(args[2]))[0]
        out.append(reading)
        fails += f
    return {"k4": out}, fails


def rank_main() -> dict:
    """Parts (a)-(d) on one of the gloo ranks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh((GP,), ("gp",))
    box = gp_box()
    plan = box_plan(box)
    out = {"device": str(mesh.device), "backend": mesh.backend,
           "seconds": {}, "fails": []}
    for part, fn in (("a", lambda: _part_mace(mesh, box, plan)),
                     ("b", lambda: _part_egnn(mesh, box, plan)),
                     ("c", lambda: _part_autoshard(mesh)),
                     ("d", lambda: _part_kernels(mesh, box, plan))):
        t = time.perf_counter()
        out[part], fails = fn()
        out["fails"] += [f"rank {mesh.rank} ({part}) {f}" for f in fails]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out["seconds"][part] = time.perf_counter() - t
    return out


def run() -> tuple:
    """Every part on the card; returns (readings, failed checks)."""
    t0 = time.perf_counter()
    ranks = launch.spawn(rank_main, WORLD, backend="gloo",
                         timeout_s=TIMEOUT_S)
    read = {"launch_s": time.perf_counter() - t0,
            "devices": [r["device"] for r in ranks],
            "backend": ranks[0]["backend"],
            "rank_seconds": ranks[0]["seconds"],
            "a": {**ranks[0]["a"],
                  "energy_err": max(r["a"]["energy_err"] for r in ranks),
                  "grad_err": max(r["a"]["grad_err"] for r in ranks),
                  "launches_per_rank": [r["a"]["launches"] for r in ranks],
                  "e_loc_per_rank": [r["a"]["e_loc"] for r in ranks],
                  "ms_per_step_per_rank": [r["a"]["ms_per_step"]
                                           for r in ranks]},
            "b": {**ranks[0]["b"],
                  **{key: max(r["b"][key] for r in ranks)
                     for key in ("h_err", "pos_err", "v0_err", "packed_err",
                                 "overlapped_err")},
                  "launches_per_rank": [r["b"]["launches"] for r in ranks],
                  "ms_per_rank": [r["b"]["ms"] for r in ranks]},
            "c": {**ranks[0]["c"],
                  "param_err": max(r["c"]["param_err"] for r in ranks),
                  "launches_per_rank": [r["c"]["launches"] for r in ranks]},
            "d": ranks[0]["d"]}
    read["seconds"] = time.perf_counter() - t0
    return read, [f for r in ranks for f in r["fails"]]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("gp_check needs a CUDA card")
    print(card_line(), flush=True)
    read, fails = run()
    print(json.dumps({"gp_check": read, "fails": fails}), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
