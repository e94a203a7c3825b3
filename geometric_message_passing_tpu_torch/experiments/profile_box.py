"""Where the time of one box-scale training step goes, on one CUDA card.

    python -m geometric_message_passing_tpu_torch.experiments.profile_box \\
        [--model egnn_sorted] [--atoms 100000] [--steps 3]

Builds ``experiments/bench_scale.py``'s box for the model
(``bench_scale.box_kind``: receiver-sorted for a ``_sorted`` model, with
triplets for ``dimenet``, with triplets and quads for ``spherenet``, else
plain) and the model at full width (``bench_scale.config``: ``gvp`` and
``gvp_sorted`` with its remat rule, the force fields ``mace_ff`` and
``tfn_ff`` with its edge chunks, ``dimenet`` with its chunk and remat rule
by size), runs two warm
steps, times 5 untraced steps on the host clock (each ending in a host read
of the loss), then traces ``--steps`` more with ``torch.profiler`` and
prints:
  * the untraced and traced step wall times, the device busy time per step
    and the device's idle share of each;
  * device time per step and launch counts by group: the segment sums (K3
    and K4), matrix products, LayerNorm, gathers and index ops,
    concatenation and copies, elementwise ops and reductions, the Adam
    update, the rest;
  * the top kernels by device time, with launch counts;
  * for a force field, the parts no kernel name tells apart (``ff_parts``):
    per layer the weight MLP, the 'uvu' product and the chunk's K4 sum on
    the first edge chunk, the self-connection product and (``mace_ff``) the
    product basis block (symmetric contraction, linear, self-connection)
    on all nodes, each run alone forward and forward + backward, and each
    scaled to a step (every chunk; a checkpointed body's forward once more
    for the recompute) with its share of the traced device time;
  * for ``dimenet`` and ``spherenet`` likewise (``triplet_parts``): the
    triplet rows of the first triplet chunk (basis, projections, gather,
    product), its K3 fold, the per-edge chains and the output gate on the
    first edge chunk and its K4 sum (``dimenet``), the geometry with the
    quads' minimum and ``update_v``'s K4 sum (``spherenet``), each scaled
    to a step, and ``recompute_ms``: the checkpointed bodies' forwards that
    the backward reruns.
The last line is one JSON object of these numbers with the card's name and
power limit.  It needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .. import precision
from ..models.dimenet import chunk_slices
from ..models.mace_ff import edge_geometry
from ..models.spherenet import spherenet_geometry
from ..ops.scatter import segment_sum
from ..ops.sorted_segsum import batch_seg_plans, sorted_fold
from .bench import card_line
from .bench_scale import (FORCE_FIELDS, MODELS, SORTED, box_kind, build,
                          config, edge_chunks, kind_box, make_step,
                          mean_degree)
from .profile_train import part_device_ms
from .train import seed_everything

# kernel-name fragments of each group, checked in this order
GROUPS = (
    ("K3/K4 segment sums", ("segsum_",)),
    ("K1/K2 EGNN message", ("egnn_",)),
    ("Adam", ("multi_tensor_apply", "adam", "Adam")),
    ("matmul", ("gemm", "Gemm", "cutlass", "sm90_xmma", "cublas")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("gather, index, scatter", ("index", "Index", "gather", "scatter",
                                "radixSort", "RadixSort", "sort")),
    ("cat, copy", ("CatArray", "cat_", "copy", "Memcpy", "Memset")),
    ("elementwise, reductions", ("elementwise", "vectorized", "reduce",
                                 "Reduce")),
)


def _group(name: str) -> str:
    for group, parts in GROUPS:
        if any(p in name for p in parts):
            return group
    return "other"


def _fwd_and_step(fn, *leaves) -> dict:
    """Device ms of ``fn()`` forward, and forward + backward into
    ``leaves`` (inputs that require grad) and ``fn``'s parameters."""
    out = fn()
    g = (tuple(torch.randn_like(o) for o in out) if isinstance(out, tuple)
         else torch.randn_like(out))
    with torch.no_grad():
        fwd = part_device_ms(fn)
    return {"fwd_ms": fwd,
            "fwd_bwd_ms": part_device_ms(
                lambda: torch.autograd.backward(fn(), g))}


def ff_parts(model, batch, cfg: dict) -> dict:
    """Per layer of a force field, its parts timed alone on the inputs of a
    forward of ``batch``: the weight MLP, the 'uvu' product and the K4 sum
    of the first edge chunk, the self-connection product and (``mace_ff``)
    the product basis block, each forward and forward + backward; and
    ``step_ms``, each part's time in one train step: the chunk parts once a
    chunk (the body's forward twice: the checkpoint reruns it), the node
    parts once (their forward twice where ``node_chunk`` blocks them)."""
    seen, hooks = {}, []
    for i, blk in enumerate(model.interactions):
        hooks.append(blk.linear_up.register_forward_hook(
            lambda mod, inp, out, i=i: seen.__setitem__(("nf", i), out)))
        hooks.append(blk.skip_tp.register_forward_hook(
            lambda mod, inp, out, i=i: seen.__setitem__(("skip", i), inp)))
    for i, prod in enumerate(getattr(model, "products", [])):
        hooks.append(prod.register_forward_hook(
            lambda mod, inp, out, i=i: seen.__setitem__(("prod", i), inp)))
    with torch.no_grad():
        model(batch)
    for h in hooks:
        h.remove()
    edge_sh, edge_feats = edge_geometry(batch, model.max_ell, model.r_max,
                                        model.num_bessel,
                                        model.num_polynomial_cutoff)
    n = batch.num_nodes
    chunks = edge_chunks(cfg, batch)
    c = min(cfg.get("edge_chunk") or batch.num_edges, batch.num_edges)
    node_chunk = cfg.get("node_chunk", 16384)
    node_blocked = node_chunk is not None and n > node_chunk
    s, r = batch.senders[:c], batch.receivers[:c]
    ea, ef, m = edge_sh[:c], edge_feats[:c], batch.edge_mask[:c]

    def leaf(t):
        return t.detach().clone().requires_grad_()

    out = {}
    for i, blk in enumerate(model.interactions):
        nf = leaf(seen[("nf", i)])
        w = leaf(blk.conv_tp_weights(ef))
        mji = leaf(blk.tp.apply(nf[s], ea, w))
        parts = {
            "weight_mlp": _fwd_and_step(lambda: blk.conv_tp_weights(ef)),
            "uvu_product": _fwd_and_step(lambda: blk.tp.apply(nf[s], ea, w),
                                         nf, w),
            "k4_chunk_sum": _fwd_and_step(
                lambda: segment_sum(mji, r, n, mask=m), mji)}
        x1, x2 = (leaf(t) for t in seen[("skip", i)])
        parts["skip_product"] = _fwd_and_step(lambda: blk.skip_tp(x1, x2), x1)
        if ("prod", i) in seen:
            mf, sc = (None if t is None else leaf(t)
                      for t in seen[("prod", i)][:2])
            prod = model.products[i]
            parts["product_basis"] = _fwd_and_step(lambda: prod(mf, sc, None),
                                                   mf)
        for name, v in parts.items():
            if name in ("weight_mlp", "uvu_product"):
                v["step_ms"] = chunks * (v["fwd_bwd_ms"]
                                         + (v["fwd_ms"] if chunks > 1 else 0))
            elif name == "k4_chunk_sum":
                v["step_ms"] = chunks * v["fwd_bwd_ms"]
            else:
                v["step_ms"] = v["fwd_bwd_ms"] + (v["fwd_ms"] if node_blocked
                                                  else 0)
        out[f"layer_{i}"] = parts
        del nf, w, mji
    return {"edge_chunk": c, "chunks": chunks, "node_blocked": node_blocked,
            "layers": out}


def triplet_parts(name: str, model, batch, cfg: dict) -> dict:
    """The parts of a ``dimenet`` or ``spherenet`` step that no kernel name
    tells apart, timed alone (forward, forward + backward) on the inputs of
    the first interaction block in a forward of ``batch``, and scaled to a
    step (``step_ms``): per layer and triplet chunk the rows (checkpointed
    when ``TripletFold.remat``: their forward once more) and the K3
    fold; ``dimenet``: per layer and edge chunk the chains before and after
    the triplet pass (checkpointed with ``edge_chunk`` or
    ``remat_blocks``), per output block and chunk the gate (checkpointed
    when chunked or ``remat``) and its K4 sum, every part's forward once
    more under ``remat_full_blocks``; ``spherenet``: the geometry (angles,
    torsions, the quads' minimum; no gradient) and the K4 sums of
    ``init_v`` and each ``update_v``.  ``recompute_ms``: the forwards the
    backward reruns."""
    blocks = model.interactions if name == "dimenet" else model.update_es
    seen = {}
    hook = blocks[0].register_forward_hook(
        lambda mod, inp, out: seen.__setitem__("inp", inp))
    with torch.no_grad():
        model(batch)
    hook.remove()
    blk, layers = blocks[0], len(blocks)
    x, rbf, basis_of, idx_kj, fold = seen["inp"]
    with torch.no_grad():
        x_ji, x_kj = blk.pre(x if name == "dimenet" else x[0], rbf)
    s0, t_chunks = fold.slices[0], len(fold.slices)
    full = cfg.get("remat_full_blocks", False)

    def leaf(t):
        return t.detach().clone().requires_grad_()

    xk = leaf(x_kj)
    rows = leaf(blk.rows(s0, x_kj, basis_of, idx_kj))
    acc = leaf(torch.zeros_like(x_kj))
    parts = {
        "triplet_rows": dict(_fwd_and_step(
            lambda: blk.rows(s0, xk, basis_of, idx_kj), xk),
            per_step=layers * t_chunks, remat=fold.remat or full),
        "k3_fold": dict(_fwd_and_step(
            lambda: sorted_fold(rows, fold.idx_ji[s0], fold.plans[0],
                                fold.t_mask[s0], acc=acc), rows, acc),
            per_step=layers * t_chunks, remat=full)}
    n = batch.num_nodes
    if name == "dimenet":
        e_inter = len(chunk_slices(batch.num_edges, cfg.get("edge_chunk")))
        c = batch.num_edges // e_inter if e_inter > 1 else batch.num_edges
        xc, rc, jc, kc = (leaf(t[:c]) for t in (x, rbf, x_ji, x_kj))
        chained = e_inter > 1 or cfg.get("remat_blocks", False)
        parts["edge_pre"] = dict(_fwd_and_step(lambda: blk.pre(xc, rc), xc),
                                 per_step=layers * e_inter,
                                 remat=chained or full)
        parts["edge_post"] = dict(_fwd_and_step(
            lambda: blk.post(jc, kc, xc), jc, kc, xc),
            per_step=layers * e_inter, remat=chained or full)
        out = model.outputs[0]
        e_out = len(chunk_slices(batch.num_edges, out.edge_chunk))
        co = batch.num_edges // e_out if e_out > 1 else batch.num_edges
        gx, gr = leaf(x[:co]), leaf(rbf[:co])
        gated = leaf(out.gate(x[:co], rbf[:co]))
        parts["output_gate"] = dict(_fwd_and_step(lambda: out.gate(gx, gr),
                                                  gx),
                                    per_step=(layers + 1) * e_out,
                                    remat=e_out > 1 or out.remat)
        parts["k4_chunk_sum"] = dict(_fwd_and_step(
            lambda: segment_sum(gated, batch.receivers[:co], n,
                                mask=batch.edge_mask[:co]), gated),
            per_step=(layers + 1) * e_out, remat=False)
    else:
        with torch.no_grad():
            geometry = part_device_ms(lambda: spherenet_geometry(
                batch, model.quad_chunk, model.torsion_fold))
        parts["geometry"] = dict(fwd_ms=geometry, fwd_bwd_ms=geometry,
                                 per_step=1, remat=False)
        e2 = leaf(x[1])
        parts["k4_update_v"] = dict(_fwd_and_step(
            lambda: segment_sum(e2, batch.receivers, n,
                                mask=batch.edge_mask), e2),
            per_step=layers + 1, remat=False)
    recompute = 0.0
    for v in parts.values():
        again = v["fwd_ms"] if v["remat"] else 0.0
        v["step_ms"] = v["per_step"] * (v["fwd_bwd_ms"] + again)
        recompute += v["per_step"] * again
    return {"triplet_chunks": t_chunks, "parts": parts,
            "recompute_ms": recompute}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="egnn_sorted", choices=sorted(MODELS))
    ap.add_argument("--atoms", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--matmul_precision", choices=precision.NAMES,
                    default=None,
                    help="the process default of the float32 products "
                         "(precision.py; without it exact f32)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_box needs a CUDA card")
    with precision.matmul_precision(args.matmul_precision):
        return _profile(args)


def _profile(args) -> dict:
    """``main``'s readings of one model's box step."""
    t = time.perf_counter()
    batch = kind_box(box_kind(args.model), args.atoms).to("cuda")
    host_s = time.perf_counter() - t
    cfg = config(args.model, args.atoms)
    model = build(args.model, cfg, seed_everything(0),
                  avg_deg=mean_degree(batch))
    plans = batch_seg_plans(batch) if args.model in SORTED else None
    step = make_step(model, batch, plans)
    for _ in range(2):
        step().item()
    t = time.perf_counter()
    for _ in range(5):
        step().item()
    step_ms = (time.perf_counter() - t) / 5 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(args.steps):
            step().item()
        traced_ms = (time.perf_counter() - t) / args.steps * 1e3
    rows = []
    for ev in prof.key_averages():   # device-side events: kernels, copies
        if (ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
                and not getattr(ev, "is_user_annotation", False)):
            rows.append((ev.self_device_time_total / args.steps,
                         ev.count / args.steps, ev.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    groups = defaultdict(lambda: [0.0, 0.0])
    for dev_us, count, key in rows:
        g = groups[_group(key)]
        g[0] += dev_us / 1e3
        g[1] += count
    edges = int(batch.edge_mask.sum())
    print(f"{args.model} {cfg} on a {args.atoms}-atom box "
          f"({edges} edges), per step:")
    print(f"untraced: {step_ms:.3f} ms (mean of 5), idle share "
          f"{1 - device_ms / step_ms:.3f} at the traced device time")
    print(f"traced: wall {traced_ms:.3f} ms, device time {device_ms:.3f} ms, "
          f"idle share {1 - device_ms / traced_ms:.3f}")
    for name, (ms, count) in sorted(groups.items(), key=lambda g: -g[1][0]):
        print(f"  {ms:9.3f} ms  {count:7.1f}x  {name}")
    print("top kernels:")
    for dev_us, count, key in rows[:25]:
        print(f"  {dev_us / 1e3:9.3f} ms  {count:7.1f}x  {key[:100]}")
    parts = {}
    if args.model in FORCE_FIELDS:
        parts = ff_parts(model, batch, cfg)
        print(f"parts alone ({parts['chunks']} chunks of "
              f"{parts['edge_chunk']} edges; node blocks "
              f"{parts['node_blocked']}), device ms: forward, forward + "
              "backward, in a step (share of the traced device time):")
        for layer, ps in parts["layers"].items():
            for name, v in ps.items():
                v["share"] = v["step_ms"] / device_ms
                print(f"  {layer} {name:16s} {v['fwd_ms']:9.3f} "
                      f"{v['fwd_bwd_ms']:9.3f} {v['step_ms']:9.3f} "
                      f"({v['share']:.3f})")
    if args.model in ("dimenet", "spherenet"):
        parts = triplet_parts(args.model, model, batch, cfg)
        print(f"parts alone ({parts['triplet_chunks']} triplet chunks), "
              "device ms: forward, forward + backward, in a step (share of "
              "the traced device time):")
        for name, v in parts["parts"].items():
            v["share"] = v["step_ms"] / device_ms
            print(f"  {name:16s} {v['fwd_ms']:9.3f} {v['fwd_bwd_ms']:9.3f} "
                  f"{v['step_ms']:9.3f} ({v['share']:.3f})")
        print(f"  recompute (checkpointed forwards rerun) "
              f"{parts['recompute_ms']:.3f} ms "
              f"({parts['recompute_ms'] / device_ms:.3f})")
    res = {
        "card": card_line(), "model": args.model, "cfg": cfg,
        "matmul_precision": args.matmul_precision,
        "host_s": host_s,
        "atoms": args.atoms,
        "edges": edges, "step_ms_untraced": step_ms,
        "idle_share_untraced": 1 - device_ms / step_ms,
        "step_ms_traced": traced_ms, "device_ms": device_ms,
        "idle_share": 1 - device_ms / traced_ms,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "groups": {k: {"ms": v[0], "count": v[1]} for k, v in groups.items()},
        "top_kernels": [{"name": k, "count": c, "ms": u / 1e3}
                        for u, c, k in rows[:25]],
        "ff_parts": parts if args.model in FORCE_FIELDS else {},
        "triplet_parts": (parts if args.model in ("dimenet", "spherenet")
                          else {}),
    }
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
