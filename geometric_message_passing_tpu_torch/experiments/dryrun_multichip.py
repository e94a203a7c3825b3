"""Every parallel strategy of the port at toy sizes on ``world`` ranks,
each held to its single-rank result: the twin of the repository's
``__graft_entry__.py::dryrun_multichip``.

    python -m geometric_message_passing_tpu_torch.experiments.dryrun_multichip \\
        [--world 4] [--device cpu]

One launch of ``world`` gloo ranks (``parallel.launch.spawn``; on the card
every rank shares ``cuda:0``) runs the JAX function's parts at its sizes:
dp and ZeRO-1 train steps (MACE 2 x 8, 2 star graphs a rank), the gp v0,
packed and overlapped aggregations, gp MACE-FF (value, gradients,
``halo_stats``), a tp MACE train step, tp TFN ``tp_apply``, with ``world``
>= 4 (even) a (dp 2, tp world / 2) step and ``fit_dp`` on a hybrid mesh
(the dp axis across two "hosts" of ``world / 2`` ranks, 1 epoch), the
GPipe pipeline of ``world`` EGNN stages (value, gradients) and
``Predictor(mesh=)``.  Unlike the JAX function, every rank also computes
each part's single-rank result itself (the whole batch in one process, the
single-device model, ``sequential_apply``, ``fit_dp`` on a mesh of the rank
alone, one ``Predictor``) and holds the part to it:

* losses within rtol ``TOL``; a train step's summed gradients within
  ``TOL`` (``TP_GRAD_TOL`` for tp) of each tensor's largest entry, and the
  dp / ZeRO weights after the Adam step within atol ``TOL``;
* the gp aggregations within ``TOL`` of max(|ref|, 1); gp MACE-FF's value
  within ``GP_ATOL`` + ``GP_RTOL`` |ref| and its gradients within atol =
  rtol = ``GP_GRAD_TOL`` (the JAX tests' gp tolerances); TFN within atol =
  rtol = ``TFN_TOL``; ``fit_dp``'s best validation MAE within rtol
  ``FIT_TOL`` (JAX's ``TestFitDP``); ``Predictor(mesh=)`` bitwise.

``run`` returns JAX's summary line, the readings (each part's errors and
its K1 / K4 / K7 launches per rank) and the failed checks; the main prints
the line and the readings as JSON and exits 1 on any failure.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np
import torch

from .. import datasets
from ..graph import batch_graphs, pad_sizes
from ..models import EGNNModel, MACEForceField, MACEModel, TFNModel
from ..ops import edge_contract as ec
from ..ops import edge as edge_ops
from ..ops import sorted_segsum as sss
from ..ops.scatter import segment_sum
from ..parallel import (build_halo_plan, dp_tp_train_step,
                        dp_train_step, egnn_pipeline_stage, gp_edge_aggregate,
                        gp_rank_batch, halo_stats, launch, make_hybrid_mesh,
                        make_mesh, packed_halo_aggregate,
                        packed_halo_aggregate_overlapped, pipeline_apply,
                        sequential_apply, shard_batches,
                        shard_model_variables, solo_mesh, tp_apply,
                        tp_local_model, tp_train_step, zero_dp_train_step,
                        zero_init)
from ..parallel.data import all_reduce_grads
from ..parallel.mesh import rank_device
from .dp_fit import fit_dp
from .infer import Predictor
from .train import l1_sum_loss, make_tx

WORLD = 4
LR = 1e-3
TOL = 1e-5
TP_GRAD_TOL = 1e-4
GP_ATOL, GP_RTOL, GP_GRAD_TOL = 5e-4, 1e-4, 2e-3
TFN_TOL = 2e-5
FIT_TOL = 2e-3
TIMEOUT_S = 600


def counts() -> dict:
    return {"k1": edge_ops.egnn_message.launches,
            "k2": edge_ops.egnn_message.bwd_launches,
            "k4": sss.segment_sum.launches,
            "k7": ec.edge_weighted_contract_grouped.launches,
            "k7_bwd": ec.edge_weighted_contract_grouped.bwd_launches}


def reset_counts() -> None:
    edge_ops.egnn_message.launches = edge_ops.egnn_message.bwd_launches = 0
    sss.segment_sum.launches = 0
    ec.edge_weighted_contract_grouped.launches = 0
    ec.edge_weighted_contract_grouped.bwd_launches = 0


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _scaled(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| over max(|want|, 1), the largest entry."""
    return float((got.double() - want.double()).abs().max()) / max(
        float(want.abs().max()), 1.0)


def _grad_err(got: dict, want: dict) -> float:
    """The largest |got - want| of any tensor over its largest |want|."""
    if got.keys() != want.keys():
        raise AssertionError(f"gradient names differ: {sorted(got ^ want)}")
    return max(float((got[k].double() - want[k].double()).abs().max())
               / max(float(want[k].abs().max()), 1e-30) for k in want)


@torch.no_grad()
def _param_err(model, ref_params: dict) -> float:
    """The largest |weight - reference weight| of any parameter."""
    return max(float((p - ref_params[n]).abs().max())
               for n, p in model.named_parameters())


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _loaded(model, sd):
    twin = copy.deepcopy(model)
    twin.load_state_dict(sd)
    return twin


class Parts:
    """Runs each part on this rank: its readings, launches and fails."""

    def __init__(self):
        self.read, self.fails = {}, []

    def run(self, name: str, fn) -> None:
        reset_counts()
        t = time.perf_counter()
        reading, fails = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        reading["launches"] = counts()
        reading["seconds"] = time.perf_counter() - t
        self.read[name] = reading
        self.fails += [f"({name}) {f}" for f in fails]

    def check(self, fails: list, what: str, value: float, tol: float) -> None:
        if not value <= tol:
            fails.append(f"{what} {value:.3e} > {tol}")


def _dp_parts(parts: Parts, dev, world: int, graphs, pads) -> dict:
    """dp and ZeRO-1 against one process summing the shards' losses."""
    mesh = make_mesh((world,), ("dp",), device=dev)
    shards = [b.to(dev) for b in shard_batches(graphs, world, *pads)]
    mine = shards[mesh.coords["dp"]]
    model = MACEModel(num_layers=2, emb_dim=8, max_ell=2, correlation=2,
                      mlp_dim=32, in_dim=1, out_dim=1, generator=_gen(0),
                      device=dev)
    sd0 = {k: v.detach().clone() for k, v in model.state_dict().items()}

    ref = _loaded(model, sd0).train()
    opt = make_tx(ref.parameters(), LR)
    total = sum(l1_sum_loss(ref(b), b) for b in shards)
    total.backward()
    ref_loss, ref_grads = float(total.detach()), _grads(ref)
    opt.step()
    ref_params = dict(ref.named_parameters())

    def dp():
        local = _loaded(model, sd0)
        loss = float(dp_train_step(local, make_tx(local.parameters(), LR),
                                   mesh, l1_sum_loss)(mine))
        fails = []
        out = {"loss": loss, "loss_rel": _rel(loss, ref_loss),
               "grad_err": _grad_err(_grads(local), ref_grads),
               "param_err": _param_err(local, ref_params)}
        parts.check(fails, "loss", out["loss_rel"], TOL)
        parts.check(fails, "gradients", out["grad_err"], TOL)
        parts.check(fails, "weights", out["param_err"], TOL)
        return out, fails

    def zero():
        local = _loaded(model, sd0)
        z_opt = zero_init(lambda ps: make_tx(ps, LR), local.parameters(),
                          mesh=mesh)
        loss = float(zero_dp_train_step(local, z_opt, mesh,
                                        l1_sum_loss)(mine))
        out = {"loss": loss, "loss_rel": _rel(loss, ref_loss),
               "param_err": _param_err(local, ref_params)}
        fails = []
        parts.check(fails, "loss", out["loss_rel"], TOL)
        parts.check(fails, "weights", out["param_err"], TOL)
        return out, fails

    parts.run("dp", dp)
    parts.run("zero_dp", zero)
    return {"model": model, "sd0": sd0, "init_batch": shards[0]}


def _gp_parts(parts: Parts, dev, world: int, rng) -> None:
    """The three aggregations and gp MACE-FF against one process."""
    mesh = make_mesh((world,), ("gp",), device=dev)
    me = mesh.coords["gp"]
    n_total, e_total = 8 * world, 16 * world
    h = torch.from_numpy(rng.normal(size=(n_total, 16)).astype(np.float32))
    snd = rng.integers(0, n_total, e_total).astype(np.int32)
    rcv = rng.integers(0, n_total, e_total).astype(np.int32)
    h = h.to(dev)
    rows = slice(me * 8, (me + 1) * 8)
    rcv_all = torch.from_numpy(rcv).to(dev)
    ref = segment_sum(h[rcv_all] + h[torch.from_numpy(snd).to(dev)],
                      rcv_all, n_total)[rows]

    def add(hi, hj):
        return hi + hj

    def v0():
        s, r = (torch.from_numpy(a.reshape(world, -1)[me]).to(dev)
                for a in (snd, rcv))
        out = gp_edge_aggregate(h[rows], s, r,
                                torch.ones(s.shape, dtype=torch.bool,
                                           device=dev), add, n_total, mesh)
        err = _scaled(out, ref)
        return ({"err": err, "shape": [n_total, 16]},
                [] if err <= TOL else [f"error {err:.3e} > {TOL}"])

    plan = build_halo_plan(snd, rcv, n_total, world).to(dev)

    def packed(fn):
        def part():
            err = _scaled(fn(h[rows], plan.local(me), add, mesh), ref)
            return {"err": err}, ([] if err <= TOL
                                  else [f"error {err:.3e} > {TOL}"])
        return part

    parts.run("gp_v0", v0)
    parts.run("gp_packed", packed(packed_halo_aggregate))
    parts.run("gp_packed_overlapped",
              packed(packed_halo_aggregate_overlapped))

    def mace():
        graphs = datasets.create_star_graphs(num=world, fold=[4], dim=3,
                                             seed=1)
        n, e, g = pad_sizes(graphs, world)
        big = batch_graphs(graphs, -(-n // world) * world, e, g)
        mf_plan = build_halo_plan(big.senders.numpy(),
                                  big.receivers.numpy(), big.num_nodes, world,
                                  edge_mask=big.edge_mask.numpy())
        kw = dict(num_layers=2, emb_dim=4, max_ell=2, correlation=2,
                  in_dim=2, node_chunk=None, generator=_gen(0), device=dev)
        model = MACEForceField(**kw, gp_axis="gp", mesh=mesh)
        single = MACEForceField(**kw)
        single.load_state_dict(model.state_dict())
        big, on_dev = big.to(dev), mf_plan.to(dev)
        val = (model(gp_rank_batch(big, on_dev, me),
                     halo_plan=on_dev.local(me)) ** 2).sum()
        val.backward()
        all_reduce_grads(mesh, list(model.parameters()), "gp")
        ref_val = (single(big) ** 2).sum()
        ref_val.backward()
        val, ref_val = float(val.detach()), float(ref_val.detach())
        want = _grads(single)
        got = _grads(model)
        grad_excess = max(float(((got[k] - w).abs() - GP_GRAD_TOL
                                 * (1 + w.abs())).max()) for k, w in
                          want.items())
        stats = halo_stats(mf_plan, 4 * 9, num_nodes=big.num_nodes)
        out = {"loss": val, "ref_loss": ref_val,
               "loss_err": abs(val - ref_val),
               "grad_err": _grad_err(got, want),
               "grad_excess": grad_excess, "halo": stats}
        fails = []
        if out["loss_err"] > GP_ATOL + GP_RTOL * abs(ref_val):
            fails.append(f"value {val} vs {ref_val}")
        if grad_excess > 0:
            fails.append(f"gradients beyond atol = rtol = {GP_GRAD_TOL}")
        return out, fails

    parts.run("gp_mace", mace)


def _tp_parts(parts: Parts, dev, world: int, batch, graphs, pads) -> None:
    """tp MACE step, tp TFN forward and the (dp 2, tp) step."""
    mesh = make_mesh((world,), ("tp",), device=dev)
    me = mesh.coords["tp"]
    kw = dict(num_layers=2, max_ell=2, mlp_dim=32, in_dim=1, out_dim=1,
              generator=_gen(0), device=dev)

    def step_vs_single(full, local_mesh, k, p, part_batch, whole, dp=False):
        sd = {k_: v.detach().clone() for k_, v in full.state_dict().items()}
        local = tp_local_model(full, k, local_mesh)
        local.load_state_dict(shard_model_variables(sd, full, k)[p])
        make = dp_tp_train_step if dp else tp_train_step
        loss = float(make(local, make_tx(local.parameters(), LR), local_mesh,
                          l1_sum_loss)(part_batch))
        full.train()
        ref = l1_sum_loss(full(whole), whole)
        ref.backward()
        want = shard_model_variables(_grads(full), full, k)[p]
        out = {"loss": loss, "loss_rel": _rel(loss, float(ref.detach())),
               "grad_err": _grad_err(_grads(local), want)}
        fails = []
        parts.check(fails, "loss", out["loss_rel"], TOL)
        parts.check(fails, "gradients", out["grad_err"], TP_GRAD_TOL)
        return out, fails

    parts.run("tp_mace", lambda: step_vs_single(
        MACEModel(emb_dim=2 * world, correlation=2, **kw), mesh, world, me,
        batch, batch))

    def tfn():
        full = TFNModel(emb_dim=2 * world, pool="sum", **kw)
        shard = shard_model_variables(full.state_dict(), full, world)[me]
        got = tp_apply(full, shard, mesh)(batch)
        with torch.no_grad():
            want = full.eval()(batch)
        err = float(((got - want).abs() - TFN_TOL * want.abs()).max())
        return ({"err": _scaled(got, want), "excess": err},
                [] if err <= TFN_TOL else [f"beyond atol = rtol = {TFN_TOL}"])

    parts.run("tp_tfn", tfn)
    if world >= 4 and world % 2 == 0:
        dp_n, tp_n = 2, world // 2
        mesh2 = make_mesh((dp_n, tp_n), ("dp", "tp"), device=dev)
        sub = graphs[:2 * dp_n]
        part = shard_batches(sub, dp_n, *pads)[mesh2.coords["dp"]].to(dev)
        whole = batch_graphs(sub, *(x * dp_n for x in pads)).to(dev)
        parts.run("dp_tp", lambda: step_vs_single(
            MACEModel(emb_dim=2 * tp_n, correlation=2, batch_norm=False,
                      **kw), mesh2, tp_n, mesh2.coords["tp"], part, whole,
            dp=True))


def _fit_part(parts: Parts, dev, world: int, graphs) -> None:
    """fit_dp over a hybrid mesh (the dp axis across two blocks of ranks)
    against fit_dp on this rank alone."""
    hmesh = make_hybrid_mesh((1, world // 2), (2, 1), ("dp", "rep"),
                             device=dev)
    args = (graphs[:2 * world - 4], graphs[-4:-2], graphs[-2:])

    def fit(mesh):
        model = EGNNModel(num_layers=1, emb_dim=8, in_dim=1, out_dim=1,
                          generator=_gen(0), device=dev)
        return fit_dp(model, None, *args, n_epochs=1, mesh=mesh,
                      batch_size=2, lr=LR, seed=0).best_val

    def part():
        got, want = fit(hmesh), fit(solo_mesh(("dp",), device=dev))
        out = {"best_val": got, "ref_best_val": want,
               "rel": _rel(got, want)}
        return out, ([] if out["rel"] <= FIT_TOL
                     else [f"best_val {got} vs {want}"])

    parts.run("hybrid_fit_dp", part)


def _pp_part(parts: Parts, dev, world: int, rng) -> None:
    """The GPipe pipeline of ``world`` EGNN stages against
    ``sequential_apply``."""
    mesh = make_mesh((world,), ("pp",), device=dev)
    d = mesh.coords["pp"]
    n_micro, n, e, dim = 2 * world, 8, 12, 8

    def stage(s):
        layer, fn = egnn_pipeline_stage(dim, device=dev, generator=_gen(s))
        return fn, {k: v.detach().clone().requires_grad_()
                    for k, v in layer.named_parameters()}

    def tensor(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    h = rng.standard_normal((n_micro, n, dim)).astype(np.float32)
    pos = rng.standard_normal((n_micro, n, 3)).astype(np.float32)
    aux = (tensor(rng.integers(0, n, (n_micro, e))),
           tensor(rng.integers(0, n, (n_micro, e))),
           torch.ones((n_micro, e), dtype=torch.bool, device=dev))

    def loss_of(out):
        return (out["h"] ** 2).sum() + (out["pos"] ** 2).sum()

    def part():
        fn, params = stage(d)
        val = loss_of(pipeline_apply(fn, params, {"h": tensor(h),
                                                  "pos": tensor(pos)}, aux,
                                     mesh=mesh, axis="pp"))
        val.backward()
        stages = [stage(s)[1] for s in range(world)]
        ref = loss_of(sequential_apply(fn, stages, {"h": tensor(h),
                                                    "pos": tensor(pos)}, aux))
        ref.backward()
        val, ref = float(val.detach()), float(ref.detach())
        out = {"loss": val, "loss_rel": _rel(val, ref),
               "grad_err": _grad_err({k: v.grad for k, v in params.items()},
                                     {k: v.grad for k, v in
                                      stages[d].items()})}
        fails = []
        parts.check(fails, "loss", out["loss_rel"], TOL)
        parts.check(fails, "gradients", out["grad_err"], TOL)
        return out, fails

    parts.run("pp", part)


def rank_main(device=None) -> dict:
    """Every part on one rank; returns its readings and failed checks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = torch.distributed.get_world_size()
    dev = rank_device(device)
    parts = Parts()
    graphs = datasets.create_star_graphs(num=2 * world, fold=[4], dim=3,
                                         seed=0)
    pads = pad_sizes(graphs, 2)
    dp = _dp_parts(parts, dev, world, graphs, pads)
    rng = np.random.default_rng(0)
    _gp_parts(parts, dev, world, rng)
    _tp_parts(parts, dev, world, dp["init_batch"], graphs, pads)
    if world >= 4 and world % 2 == 0:
        _fit_part(parts, dev, world, graphs)
    _pp_part(parts, dev, world, rng)

    def serve():
        mesh = make_mesh((world,), ("dp",), device=dev)
        model = _loaded(dp["model"], dp["sd0"])
        got = Predictor(model, batch_size=2, mesh=mesh).predict(graphs)
        want = Predictor(model, batch_size=2, device=dev).predict(graphs)
        out = {"shape": list(got.shape), "bitwise": bool(
            np.array_equal(got, want))}
        fails = [] if got.shape == (len(graphs), 1) and out["bitwise"] \
            else [f"shape {got.shape}, bitwise {out['bitwise']}"]
        return out, fails

    parts.run("serve", serve)
    return {"device": str(dev), "read": parts.read, "fails": parts.fails}


def summary_line(read: dict) -> str:
    """The JAX function's closing line, from rank 0's readings."""
    hy = read.get("dp_tp", {}).get("loss")
    fit = read.get("hybrid_fit_dp", {}).get("best_val")
    st = read["gp_mace"]["halo"]
    return (f"dryrun_multichip ok: dp loss={read['dp']['loss']:.4f}, "
            f"zero-dp loss={read['zero_dp']['loss']:.4f}, "
            f"tp loss={read['tp_mace']['loss']:.4f}, dpxtp loss={hy}, "
            f"hybrid-mesh fit_dp best_val={fit}, "
            f"pp loss={read['pp']['loss']:.4f}, "
            f"gp out shape={tuple(read['gp_v0']['shape'])}, "
            f"gp_mace loss={read['gp_mace']['loss']:.4f} "
            f"(halo {st['wire_bytes']}B wire vs {st['allgather_bytes']}B "
            "all-gather per exchange)")


def run(world: int = WORLD, device=None,
        timeout_s: float = TIMEOUT_S) -> tuple:
    """Every part on ``world`` gloo ranks (``device`` None: the card);
    returns (summary line, readings, failed checks)."""
    t = time.perf_counter()
    ranks = launch.spawn(rank_main, world, backend="gloo", device=device,
                         args=(device,), timeout_s=timeout_s)
    fails = [f"rank {r} {f}" for r, res in enumerate(ranks)
             for f in res["fails"]]
    read = {"world": world, "devices": [r["device"] for r in ranks],
            "seconds": time.perf_counter() - t,
            "parts": ranks[0]["read"],
            "launches_per_rank": {part: [r["read"][part]["launches"]
                                         for r in ranks]
                                  for part in ranks[0]["read"]}}
    return summary_line(ranks[0]["read"]), read, fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=WORLD)
    ap.add_argument("--device", default=None,
                    help="cpu for CPU ranks (default: the card)")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        raise SystemExit("dryrun_multichip needs a CUDA card; pass "
                         "--device cpu for CPU ranks")
    line, read, fails = run(args.world, args.device)
    print(line, flush=True)
    print(json.dumps({"dryrun_multichip": read, "fails": fails}), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
