"""Tensor and pipeline parallelism at full width on one card: four gloo
ranks sharing it, each held to the single-rank model on the same card.

    python -m geometric_message_passing_tpu_torch.experiments.tp_check

One launch of 4 gloo ranks on ``cuda:0`` (``parallel.launch.spawn``; NCCL
refuses two ranks on one GPU).  Every rank builds the full models from seed
0, shards them (``shard_model_variables``) and runs its shard, and computes
the single-rank references itself on the card (the kernels are bitwise
repeatable, so every rank's reference is the same):

  a. MACE star (``bench.MACE_STAR``: 2 layers, max_ell 3, correlation 3,
     emb 64, mlp 256, pool first) on the first 100 training graphs of its
     star data (fold 7, N 808, E 1408): ``tp_apply`` at tp 4 and on the
     tp axis of a (dp 2, tp 2) mesh within ``OUT_TOL`` of max(|ref|, 1);
     ``tp_train_step``'s first-step gradients within ``GRAD_TOL`` of each
     tensor's largest entry of the single-rank gradients' slice; after
     ``ADAM_STEPS`` Adam steps at lr 5e-4 the weights and batch statistics
     within ``ADAM_TOL`` of each tensor's largest entry of the single-rank
     steps' slice, or, beyond it, within twice the distance of single-rank
     steps from weights one rounding step away (``adam_reading``);
  b. TFN star (``bench.TFN_STAR``: 4 layers, max_ell 3, emb 64, mlp 256,
     gate, residual): ``tp_apply`` and one ``tp_train_step`` at tp 4, the
     gates regrouped (a hidden layer's contraction has 7 groups where the
     single-rank model's has 5);
  c. ``dp_tp_train_step`` on (dp 2, tp 2), MACE without batch norm, each dp
     row on half of the 100 graphs: the loss summed over dp within
     ``GRAD_TOL`` (relative) of the single-rank step's on the whole batch,
     the gradients and the weights after one Adam step as in (a);
  d. ``pipeline_apply``, S 4 stages of ``EGNNLayer`` at width 128 (the
     bench EGNN's 4 layers; stage s's weights from seed s), M 8
     microbatches: the bench's first 8 training batches (N and E of its
     bucket), ``h`` drawn from seed 0; forward within ``OUT_TOL`` and
     parameter and input gradients within ``GRAD_TOL`` of each tensor's
     largest entry of ``sequential_apply``'s;
  e. rank 0 holds K7 (forward and backward) and K4 against their plain
     versions and a float64 run on the inputs recorded in this phase's
     steps: MACE layer 0 and the hidden layer at tp 4, TFN's
     gate-regrouped hidden layer, every K4 sum of a MACE step (the
     messages at local shapes, the embedding's gradient).

Each rank counts its launches of K7 (``edge_contract`` forward and
backward, the one-group kernel) and K4 in every part (counters set to 0
just before, read just after), asserted against what the code implies.
``run`` returns the readings and the failed checks; the module's main
prints them as one JSON line and exits 1 on any failure.  It needs a card.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

import numpy as np
import torch

from ..graph import batch_graphs, pad_sizes
from ..nn import basic as nn_basic
from ..nn import conv as nn_conv
from ..nn import tensor_product
from ..ops import edge_contract as ec
from ..ops import scatter
from ..ops import sorted_segsum as sss
from ..parallel import (dp_tp_train_step, egnn_pipeline_stage, launch,
                        make_mesh, pipeline_apply, sequential_apply,
                        shard_batches, shard_model_variables, tp_apply,
                        tp_local_model, tp_train_step)
from .bench import (BATCH_SIZE, MACE_LR, N_LAYERS, WIDTH, bench_data,
                    card_line, mace_data, mace_model, tfn_data, tfn_model)
from .train import l1_sum_loss, make_tx

WORLD = TP = 4
DP_TP = (2, 2)
ADAM_STEPS = 3
OUT_TOL = 1e-4           # of max(|ref|, 1)
GRAD_TOL = 1e-5          # of each tensor's largest entry
ADAM_TOL = 1e-4          # of each tensor's largest entry
K7_TOL, K4_TOL = 2e-5, 1e-5   # kernel against plain, of max(|plain|, 1)
PP_STAGES, PP_MICRO = N_LAYERS, 8
TIME_STEPS = 5
TIMEOUT_S = 900


def counts() -> dict:
    return {"k7": ec.edge_weighted_contract_grouped.launches,
            "k7_bwd": ec.edge_weighted_contract_grouped.bwd_launches,
            "k7_one_group": ec.edge_weighted_contract.launches
            + ec.edge_weighted_contract.bwd_launches,
            "k4": sss.segment_sum.launches}


def reset_counts() -> None:
    ec.edge_weighted_contract_grouped.launches = 0
    ec.edge_weighted_contract_grouped.bwd_launches = 0
    ec.edge_weighted_contract.launches = 0
    ec.edge_weighted_contract.bwd_launches = 0
    sss.segment_sum.launches = 0


def want_launches(layers: int, forwards: int, steps: int) -> dict:
    """K7 and K4 of a MACE / TFN (pool first) model: per layer and forward
    one K7 and one K4 (the message sum), per train step one K7 backward a
    layer and one K4 (the embedding's gradient)."""
    return {"k7": layers * forwards, "k7_bwd": layers * steps,
            "k7_one_group": 0, "k4": layers * forwards + steps}


def window(data_fn):
    """The first global batch of training graphs, padded to the data's
    bucket of 100."""
    data, loaders = data_fn()
    return loaders[0].graphs[:BATCH_SIZE], pad_sizes(data, BATCH_SIZE)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def scaled_err(got: dict, want: dict, floor: float = 0.0) -> float:
    """Largest |got - want| of any tensor over max(its largest |want|,
    ``floor``)."""
    if got.keys() != want.keys():
        raise AssertionError(f"keys differ: {sorted(got ^ want)[:6]}")
    return max(float((got[k].double() - want[k].double()).abs().max())
               / max(float(want[k].abs().max()), floor, 1e-30) for k in want)


NUDGE = 1 + 2.0 ** -23     # one or two rounding steps of every weight


def adam_reading(state: dict, r_state: dict, n_state: dict, model, k: int,
                 p: int) -> dict:
    """Shard ``p``'s state after the Adam steps against the single-rank
    steps' slice (``adam_err``: the largest difference of a tensor over its
    largest entry), and how far the single-rank steps from weights nudged
    by ``NUDGE`` lie from them (``adam_nudged_err``): Adam's first steps
    move an entry by about lr whatever its gradient's size, so where
    rounding decides a small gradient's sign two runs part by up to 2 lr
    a step, and the nudged run says how far rounding alone takes them."""
    want = shard_model_variables(r_state, model, k)[p]
    nudged = shard_model_variables(n_state, model, k)[p]
    return {"adam_err": scaled_err(state, want),
            "adam_nudged_err": scaled_err(nudged, want)}


def _nudged_steps(model, sd: dict, batch, steps: int) -> dict:
    """The single-rank state after ``steps`` Adam steps from ``sd`` with
    every parameter times ``NUDGE``."""
    model.load_state_dict(sd)
    with torch.no_grad():
        for q in model.parameters():
            q.mul_(NUDGE)
    return _ref_steps(model, batch, steps)[2]


def _numpy(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True).numpy()
            for k, v in tensors.items()}


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _ref_steps(model, batch, steps: int) -> tuple:
    """``steps`` single-rank Adam steps: (first gradients, first loss,
    state after)."""
    model.train()
    opt = make_tx(model.parameters(), MACE_LR)
    grads = loss0 = None
    for i in range(steps):
        loss = l1_sum_loss(model(batch), batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if i == 0:
            grads, loss0 = _grads(model), float(loss.detach())
        opt.step()
    return grads, loss0, {k: v.detach().clone()
                          for k, v in model.state_dict().items()}


def _tp_steps(full, shard, mesh, batch, steps: int, dp: bool = False
              ) -> tuple:
    """The same steps tensor-parallel: (first gradients, first loss,
    state after, launches of the first step)."""
    local = tp_local_model(full, mesh.shape["tp"], mesh)
    local.load_state_dict(shard)
    opt = make_tx(local.parameters(), MACE_LR)
    step = (dp_tp_train_step if dp else tp_train_step)(local, opt, mesh,
                                                       l1_sum_loss)
    grads = loss0 = launched = None
    for i in range(steps):
        reset_counts()
        loss = float(step(batch))
        if i == 0:
            torch.cuda.synchronize()
            grads, loss0, launched = _grads(local), loss, counts()
    return grads, loss0, dict(local.state_dict()), launched


def _part_tp(kind: str, mesh, mesh2) -> dict:
    """(a) or (b) on this rank."""
    dev = mesh.device
    make, data_fn = ((mace_model, mace_data) if kind == "mace"
                     else (tfn_model, tfn_data))
    graphs, pads = window(data_fn)
    batch = batch_graphs(graphs, *pads).to(dev)
    full = make(_gen(0), device=dev)
    layers = len(full.convs)
    sd = {k: v.detach().clone() for k, v in full.state_dict().items()}
    shard = shard_model_variables(sd, full, TP)[mesh.coords["tp"]]
    out, fails = {}, []
    with torch.no_grad():
        ref = full.eval()(batch)
    reset_counts()
    y = tp_apply(full, shard, mesh)(batch)
    torch.cuda.synchronize()
    out["apply_launches"] = counts()
    out["apply_err"] = scaled_err({"y": y}, {"y": ref}, 1.0)
    if kind == "mace":       # on the tp axis of the (dp 2, tp 2) mesh
        shard2 = shard_model_variables(sd, full, DP_TP[1])[
            mesh2.coords["tp"]]
        y2 = tp_apply(full, shard2, mesh2)(batch)
        out["apply_dp_tp_err"] = scaled_err({"y": y2}, {"y": ref}, 1.0)
    steps = ADAM_STEPS if kind == "mace" else 1
    _, r_loss, r_state = _ref_steps(full, batch, steps)
    me = mesh.coords["tp"]
    g, loss, state, launched = _tp_steps(full, shard, mesh, batch, steps)
    out["step_launches"] = launched
    out["grads"] = _numpy(g)
    out["loss_rel"] = abs(loss - r_loss) / abs(r_loss)
    if kind == "mace":
        out.update(adam_reading(state, r_state, _nudged_steps(
            full, sd, batch, steps), full, TP, me))
        local = tp_local_model(full, TP, mesh)
        local.load_state_dict(shard)
        step = tp_train_step(local, make_tx(local.parameters(), MACE_LR),
                             mesh, l1_sum_loss)
        out["ms_per_step"] = _timed(lambda: step(batch))
        if mesh.rank == 0:       # one process alone on the card
            full.load_state_dict(sd)
            opt = make_tx(full.parameters(), MACE_LR)

            def one():
                loss = l1_sum_loss(full(batch), batch)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
            out["ms_per_step_single"] = _timed(one)
        mesh.barrier()
    for name, want in (("apply_launches", want_launches(layers, 1, 0)),
                       ("step_launches", want_launches(layers, 1, 1))):
        if out[name] != want:
            fails.append(f"{kind} {name} {out[name]}, expected {want}")
    return out, fails


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


def dp_tp_data() -> tuple:
    """(c)'s graphs: (the 100 graphs, the dp shards' bucket)."""
    graphs, _ = window(mace_data)
    return graphs, pad_sizes(graphs, BATCH_SIZE // DP_TP[0])


def _part_dp_tp(mesh2) -> tuple:
    """(c) on this rank."""
    dev = mesh2.device
    graphs, sub = dp_tp_data()
    n = DP_TP[0]
    part = shard_batches(graphs, n, *sub)[mesh2.coords["dp"]].to(dev)
    whole = batch_graphs(graphs, *(p * n for p in sub)).to(dev)
    full = mace_model(_gen(0), device=dev, batch_norm=False)
    sd = {k: v.detach().clone() for k, v in full.state_dict().items()}
    me = mesh2.coords["tp"]
    shard = shard_model_variables(sd, full, DP_TP[1])[me]
    g, loss, state, launched = _tp_steps(full, shard, mesh2, part, 1,
                                         dp=True)
    _, r_loss, r_state = _ref_steps(full, whole, 1)
    n_state = _nudged_steps(full, sd, whole, 1)
    out = {"launches": launched, "loss": loss, "ref_loss": r_loss,
           "loss_rel": abs(loss - r_loss) / abs(r_loss),
           "grads": _numpy(g),
           **adam_reading(state, r_state, n_state, full, DP_TP[1], me)}
    fails = []
    want = want_launches(len(full.convs), 1, 1)
    if launched != want:
        fails.append(f"dp x tp launches {launched}, expected {want}")
    return out, fails


def pp_inputs(dev) -> tuple:
    """(x_mb, aux_mb): the bench's first ``PP_MICRO`` training batches."""
    data, (tr, _, _) = bench_data()
    pads = pad_sizes(data, BATCH_SIZE)
    batches = [batch_graphs(tr.graphs[i * BATCH_SIZE:(i + 1) * BATCH_SIZE],
                            *pads) for i in range(PP_MICRO)]
    rng = np.random.default_rng(0)
    h = rng.standard_normal((PP_MICRO, pads[0], WIDTH)).astype(np.float32)
    x = {"h": torch.tensor(h, device=dev, requires_grad=True),
         "pos": torch.stack([b.pos for b in batches]).to(dev)
         .requires_grad_()}
    aux = tuple(torch.stack([getattr(b, f) for b in batches]).to(dev)
                for f in ("senders", "receivers", "edge_mask"))
    return x, (aux[0].long(), aux[1].long(), aux[2])


def pp_stage(s: int, dev) -> tuple:
    """Stage ``s``: (stage_fn, its parameter dict), weights from seed s."""
    layer, fn = egnn_pipeline_stage(WIDTH, device=dev, generator=_gen(s))
    return fn, {k: v.detach().clone().requires_grad_()
                for k, v in layer.named_parameters()}


def _pp_loss(out) -> torch.Tensor:
    return (out["h"] ** 2).mean() + (out["pos"] ** 2).mean()


def _part_pp(mesh) -> tuple:
    """(d) on this rank."""
    dev, d = mesh.device, mesh.coords["pp"]
    fn, params = pp_stage(d, dev)
    x, aux = pp_inputs(dev)
    reset_counts()
    res = pipeline_apply(fn, params, x, aux, mesh=mesh, axis="pp")
    _pp_loss(res).backward()
    torch.cuda.synchronize()
    launched = counts()
    got = {"out_" + k: v.detach() for k, v in res.items()}
    g_par = {k: v.grad for k, v in params.items()}
    g_x = {k: v.grad for k, v in x.items()}
    # the one-rank twin, every stage on this rank
    stages = [pp_stage(s, dev)[1] for s in range(PP_STAGES)]
    x_ref, _ = pp_inputs(dev)
    ref = sequential_apply(fn, stages, x_ref, aux)
    _pp_loss(ref).backward()
    out = {"launches": launched,
           "out_err": scaled_err(got, {"out_" + k: v.detach()
                                       for k, v in ref.items()}, 1.0),
           "param_grad_err": scaled_err(g_par, {k: v.grad for k, v in
                                                stages[d].items()}),
           "input_grad_err": scaled_err(g_x, {k: v.grad for k, v in
                                              x_ref.items()})}
    ticks = PP_MICRO + PP_STAGES - 1
    # a stage's forward: K4 for the message sum, two for the position
    # mean; its backward gathers (no K4)
    want = {"k7": 0, "k7_bwd": 0, "k7_one_group": 0, "k4": 3 * ticks}
    fails = [] if launched == want else [
        f"pp launches {launched}, expected {want}"]
    return out, fails


@contextlib.contextmanager
def recording():
    """Record the inputs of every K7 call (the tensor product's grouped
    contraction) and K4 call (the convs' sums, the embedding's gradient)
    while the block runs; the calls themselves are unchanged."""
    rec = {"k7": [], "k4": []}
    k7 = tensor_product.edge_weighted_contract_grouped
    saved = {mod: mod.segment_sum for mod in (nn_conv, nn_basic)}

    def k7_rec(Ts, Ws):
        rec["k7"].append(([T.detach().clone() for T in Ts],
                          [W.detach().clone() for W in Ws]))
        return k7(Ts, Ws)

    def k4_rec(fn):
        def call(data, ids, n, mask=None):
            rec["k4"].append((data.detach().clone(), ids, n, mask))
            return fn(data, ids, n, mask=mask)
        return call

    tensor_product.edge_weighted_contract_grouped = k7_rec
    for mod, fn in saved.items():
        mod.segment_sum = k4_rec(fn)
    try:
        yield rec
    finally:
        tensor_product.edge_weighted_contract_grouped = k7
        for mod, fn in saved.items():
            mod.segment_sum = fn


def _dist64(x, x64) -> float:
    return float((x.double() - x64).abs().max()) / max(
        float(x64.abs().max()), 1.0)


def hold_k7(label: str, Ts, Ws, seed: int) -> tuple:
    """K7 forward and backward on these inputs against the plain versions
    (within K7_TOL of max(|plain|, 1)) and a float64 run (the kernel no
    farther than twice the plain version, plus 1e-6)."""
    g = torch.Generator(device=Ts[0].device).manual_seed(seed)
    with torch.no_grad():
        outs = ec.edge_weighted_contract_grouped(Ts, Ws)
        dOs = [torch.randn(o.shape, generator=g, device=o.device)
               for o in outs]
        dTs, dWs = ec.edge_weighted_contract_grouped_bwd(Ts, Ws, dOs)
        reading, fails = {"groups": len(Ts), "K": [int(T.shape[1]) for T in Ts],
                          "w": [int(W.shape[2]) for W in Ws],
                          "E": int(Ts[0].shape[0])}, []
        for name, got, plain, f64 in (
                ("fwd", outs,
                 [ec.edge_weighted_contract_plain(T, W) for T, W in zip(Ts, Ws)],
                 [ec.edge_weighted_contract_plain(T.double(), W.double())
                  for T, W in zip(Ts, Ws)]),
                ("dT", dTs,
                 [ec.edge_weighted_contract_bwd_plain(T, W, d)[0]
                  for T, W, d in zip(Ts, Ws, dOs)],
                 [ec.edge_weighted_contract_bwd_plain(
                     T.double(), W.double(), d.double())[0]
                  for T, W, d in zip(Ts, Ws, dOs)]),
                ("dW", dWs,
                 [ec.edge_weighted_contract_bwd_plain(T, W, d)[1]
                  for T, W, d in zip(Ts, Ws, dOs)],
                 [ec.edge_weighted_contract_bwd_plain(
                     T.double(), W.double(), d.double())[1]
                  for T, W, d in zip(Ts, Ws, dOs)])):
            vs_plain = max(_dist64(a, b.double()) for a, b in zip(got, plain))
            k64 = max(_dist64(a, b) for a, b in zip(got, f64))
            p64 = max(_dist64(a, b) for a, b in zip(plain, f64))
            reading[name] = {"vs_plain": vs_plain, "kernel_f64": k64,
                             "plain_f64": p64}
            if vs_plain > K7_TOL or k64 > 2 * p64 + 1e-6:
                fails.append(f"K7 {label} {name}: {reading[name]}")
    return reading, fails


def hold_k4(label: str, data, ids, n, mask) -> tuple:
    with torch.no_grad():
        got = scatter.segment_sum(data, ids, n, mask)
        plain = sss.sorted_segment_sum_plain(data, ids, n, mask)
        f64 = sss.sorted_segment_sum_plain(data.double(), ids, n, mask)
    reading = {"E": int(data.shape[0]), "N": int(n), "D": int(data.shape[1]),
               "vs_plain": _dist64(got, plain.double()),
               "kernel_f64": _dist64(got, f64),
               "plain_f64": _dist64(plain, f64)}
    bad = (reading["vs_plain"] > K4_TOL
           or reading["kernel_f64"] > 2 * reading["plain_f64"] + 1e-6)
    return reading, ([f"K4 {label}: {reading}"] if bad else [])


def _part_kernels(mesh) -> tuple:
    """(e): every rank runs the recorded MACE step and TFN forward (their
    collectives need all); rank 0 holds the kernels."""
    dev = mesh.device
    recs = {}
    for kind, make, data_fn in (("mace", mace_model, mace_data),
                                ("tfn", tfn_model, tfn_data)):
        graphs, pads = window(data_fn)
        batch = batch_graphs(graphs, *pads).to(dev)
        full = make(_gen(0), device=dev)
        shard = shard_model_variables(full.state_dict(), full, TP)[
            mesh.coords["tp"]]
        local = tp_local_model(full, TP, mesh)
        local.load_state_dict(shard)
        with recording() as rec:
            if kind == "mace":
                tp_train_step(local, make_tx(local.parameters(), MACE_LR),
                              mesh, l1_sum_loss)(batch)
            else:
                tp_apply(full, shard, mesh)(batch)
        recs[kind] = rec
    if mesh.rank != 0:
        return {}, []
    out, fails = {"k7": {}, "k4": []}, []
    for label, (Ts, Ws) in (("MACE layer 0", recs["mace"]["k7"][0]),
                            ("MACE hidden", recs["mace"]["k7"][1]),
                            ("TFN hidden, gates regrouped",
                             recs["tfn"]["k7"][1])):
        out["k7"][label], f = hold_k7(label, Ts, Ws, seed=len(out["k7"]))
        fails += f
    for i, args in enumerate(recs["mace"]["k4"]):
        reading, f = hold_k4(f"MACE step sum {i}", *args)
        out["k4"].append(reading)
        fails += f
    return out, fails


def rank_main() -> dict:
    """Parts (a)-(e) on one of the gloo ranks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh((TP,), ("tp",))
    mesh2 = make_mesh(DP_TP, ("dp", "tp"))
    pp_mesh = make_mesh((PP_STAGES,), ("pp",))
    out = {"device": str(mesh.device), "backend": mesh.backend,
           "coords": {"tp": mesh2.coords["tp"]}, "seconds": {}, "fails": []}
    for part, fn in (("a", lambda: _part_tp("mace", mesh, mesh2)),
                     ("b", lambda: _part_tp("tfn", mesh, mesh2)),
                     ("c", lambda: _part_dp_tp(mesh2)),
                     ("d", lambda: _part_pp(pp_mesh)),
                     ("e", lambda: _part_kernels(mesh))):
        t = time.perf_counter()
        out[part], fails = fn()
        out["fails"] += [f"rank {mesh.rank} ({part}) {f}" for f in fails]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out["seconds"][part] = time.perf_counter() - t
    return out


def reference_grads(kind: str) -> tuple:
    """The single-rank first-step gradients of (a), (b) or (c)
    ("mace_nobn", on the whole batch): (the model on the CPU, f32 on the
    card, f64 on the CPU), float64 tensors on the CPU."""
    if kind == "mace_nobn":
        graphs, sub = dp_tp_data()
        pads = [p * DP_TP[0] for p in sub]
        make, kw = mace_model, dict(batch_norm=False)
    else:
        graphs, pads = window(mace_data if kind == "mace" else tfn_data)
        make, kw = (mace_model if kind == "mace" else tfn_model), {}
    out = []
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        batch = batch_graphs(graphs, *pads).to(dev)
        batch.pos, batch.y = batch.pos.to(dtype), batch.y.to(dtype)
        model = make(_gen(0), device=dev, **kw).to(dtype)
        grads, _, _ = _ref_steps(model, batch, 1)
        out.append({k: v.to("cpu", torch.float64) for k, v in grads.items()})
    return (make(_gen(0), device="cpu", **kw), *out)


def grad_reading(kind: str, tp_grads: list, shards: list, k: int) -> tuple:
    """Each rank's first-step gradients against the single-rank ones
    (``GRAD_TOL`` of each tensor's largest entry).  A tensor beyond it is
    held to the float64 step instead: the rank's no farther from it than
    twice the single-rank f32 gradient, plus ``GRAD_TOL`` (the batch norm's
    backward amplifies f32 rounding: PERF.md)."""
    model, g32, g64 = reference_grads(kind)
    s32 = shard_model_variables(g32, model, k)
    s64 = shard_model_variables(g64, model, k)

    def largest(shards, key):   # the tensor's, over every shard
        return max(max(float(sh[key].abs().max()) for sh in shards), 1e-30)

    worst, to64, fails = 0.0, {}, []
    for r, (got, p) in enumerate(zip(tp_grads, shards)):
        if got.keys() != s32[p].keys():
            fails.append(f"({kind}) rank {r} gradient names differ")
            continue
        for key, v in got.items():
            v = torch.from_numpy(v).double()
            err = float((v - s32[p][key]).abs().max()) / largest(s32, key)
            worst = max(worst, err)
            if err <= GRAD_TOL:
                continue
            scale64 = largest(s64, key)
            e_tp = float((v - s64[p][key]).abs().max()) / scale64
            e_one = float((s32[p][key] - s64[p][key]).abs().max()) / scale64
            to64[f"rank {r} {key}"] = {"vs_single": err, "tp_f64": e_tp,
                                       "single_f64": e_one,
                                       "margin": e_tp / (2 * e_one + GRAD_TOL)}
            if e_tp > 2 * e_one + GRAD_TOL:
                fails.append(f"({kind}) rank {r} {key}: {err:.3e} from the "
                             f"single-rank gradient, {e_tp:.3e} from float64 "
                             f"(single rank {e_one:.3e})")
    tight = max(to64, key=lambda t: to64[t]["margin"], default=None)
    return {"grad_err": worst, "held_to_float64": len(to64),
            "closest_to_its_bound": tight and {tight: to64[tight]}}, fails


def run() -> tuple:
    """Every part on the card; returns (readings, failed checks)."""
    t0 = time.perf_counter()
    ranks = launch.spawn(rank_main, WORLD, backend="gloo",
                         timeout_s=TIMEOUT_S)
    read = {"launch_s": time.perf_counter() - t0,
            "devices": [r["device"] for r in ranks],
            "backend": ranks[0]["backend"],
            "rank_seconds": ranks[0]["seconds"]}
    fails = [f for r in ranks for f in r["fails"]]
    for part, kind, k, axis in (("a", "mace", TP, None),
                                ("b", "tfn", TP, None),
                                ("c", "mace_nobn", DP_TP[1], "tp")):
        shards = [r["coords"][axis] if axis else i
                  for i, r in enumerate(ranks)]
        read[part], f = grad_reading(kind, [r[part].pop("grads")
                                            for r in ranks], shards, k)
        fails += f
    checks = (("a", "apply_err", OUT_TOL), ("a", "apply_dp_tp_err", OUT_TOL),
              ("a", "loss_rel", GRAD_TOL),
              ("b", "apply_err", OUT_TOL), ("b", "loss_rel", GRAD_TOL),
              ("c", "loss_rel", GRAD_TOL),
              ("d", "out_err", OUT_TOL), ("d", "param_grad_err", GRAD_TOL),
              ("d", "input_grad_err", GRAD_TOL))
    for part, key, tol in checks:
        values = [r[part][key] for r in ranks]
        read.setdefault(part, {})[key] = max(values)
        if max(values) > tol:
            fails.append(f"({part}) {key} {max(values):.3e} > {tol}")
    for part in ("a", "c"):     # Adam and rounding: PERF.md
        err = max(r[part]["adam_err"] for r in ranks)
        nudged = max(r[part]["adam_nudged_err"] for r in ranks)
        read[part].update(adam_err=err, adam_nudged_err=nudged)
        if err > max(ADAM_TOL, 2 * nudged):
            fails.append(f"({part}) Adam steps {err:.3e} from the single "
                         f"rank's, beyond {ADAM_TOL} and twice a nudged "
                         f"single-rank run's {nudged:.3e}")
    for part, key in (("a", "apply_launches"), ("a", "step_launches"),
                      ("b", "apply_launches"), ("b", "step_launches"),
                      ("c", "launches"), ("d", "launches")):
        read[part][key + "_per_rank"] = [r[part][key] for r in ranks]
    read["a"]["ms_per_step"] = ranks[0]["a"]["ms_per_step"]
    read["a"]["ms_per_step_single"] = ranks[0]["a"]["ms_per_step_single"]
    read["c"]["loss"] = ranks[0]["c"]["loss"]
    read["c"]["ref_loss"] = ranks[0]["c"]["ref_loss"]
    read["e"] = ranks[0]["e"]
    read["seconds"] = time.perf_counter() - t0
    return read, fails


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tp_check needs a CUDA card")
    print(card_line(), flush=True)
    read, fails = run()
    print(json.dumps({"tp_check": read, "fails": fails}), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
