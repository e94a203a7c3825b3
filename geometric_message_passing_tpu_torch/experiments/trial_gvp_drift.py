"""Where one GVP-GNN train step on a CUDA card drifts from float64: a
bisection by op class.

    python -m geometric_message_passing_tpu_torch.experiments.trial_gvp_drift \\
        [--probe-bias]

Model and data are those of ``chip_smoke.py`` phase 5b: ``GVPGNNModel`` at
its defaults with 4 layers, weights from seed 0, every dropout rate 0; the
bench's star split (``bench.bench_data``) and one train step (L1-sum loss,
Adam 5e-4) on the train graphs ``permutation(700)[:100]`` of
``numpy.random.default_rng(7)``.  Each run's reading is the largest
gradient error relative to that parameter's largest entry in the CPU
float64 run, and the parameter where it lies:

  * ``cpu f32``, ``card f32`` (the GVP kernels, K5), ``card f32 plain``
    (the plain message route), ``card f64 plain`` (the whole step in
    float64 on the card);
  * ``card f64, <class> in f32``: the float64 plain-route step with one op
    class run in float32 (its inputs and parameters cast down, its outputs
    cast back up), and ``card f32, <class> in f64``, the float32 step with
    that class in float64: ``message`` (the GVP convolutions' message passing and
    sums), ``layer_norms`` (``GVPLayerNorm`` and ``LayerNorm``), ``gvps``
    (the other ``GVP`` modules: node and edge embeddings, feed-forward),
    ``readout`` (the embedding, the pool and the two Linear layers),
    ``edges`` (the whole edge embedding: the edge vectors from float32
    positions, their lengths, the Bessel basis and cutoff, the unit
    vectors, and ``W_e_norm``/``W_e``).

A class whose float32 run alone reproduces the ``card f32`` gap is where
the card's drift enters; a class whose float64 run alone closes it is where
the rounding of the layers before it is amplified.

``--probe-bias`` looks at the parameter where the gap lies,
``layers.2.conv.gvp1_bs`` (the bias of the second GVP of layer 2's message
chain), on the plain route: its gradient is the sum over the edges of the
cotangent of that GVP's pre-activation, one term per edge and channel.  The
probe keeps those terms (``gvp_chain``'s ``pre_relu`` rows) in the CPU
float64 run, the CPU float32 run and the card's float32 run, and reports
for each f32 run: the bias gradient's error (of its largest float64 entry),
the part of it that the f32 sum itself adds (against the float64 sum of the
same f32 terms) and the part the terms carry, the terms' largest error (of
their largest float64 entry), and the cancellation of the worst channel (the
sum of its terms' magnitudes over the magnitude of their sum).  It also
counts the ReLU mask flips (a pre-activation whose sign differs from the
float64 run's) of every GVP chain in the step and of the probed GVP, with
the largest float64 |pre-activation| among them, and the bias gradient's
error left when the probed GVP's flipped entries take the float64 run's
terms.

Prints one JSON line with the card's ``nvidia-smi`` name and power limit.
It needs a card and raises without one.
"""

from __future__ import annotations

import contextlib
import copy
import json
from typing import Dict, Iterable, List

import numpy as np
import torch
from torch import nn
from torch.utils._pytree import tree_map

from ..graph import build_slot_data
from ..ops import gvp_message as gm
from ..models import GVPGNNModel, gvpgnn
from ..models.pooling import global_add_pool
from ..nn import gvp
from .bench import LR, bench_data, card_line
from .train import make_tx, train_step

CLASSES = ("message", "layer_norms", "gvps", "readout", "edges")


def select(model: GVPGNNModel, op_class: str) -> List[nn.Module]:
    """The outermost modules of ``op_class`` in ``model``."""
    convs = [m for m in model.modules() if isinstance(m, gvpgnn.GVPConv)]
    in_conv = {id(m) for conv in convs for m in conv.modules()}
    if op_class == "message":
        return convs
    if op_class == "layer_norms":
        return [model.layer_norm_0] + [
            m for m in model.modules() if isinstance(m, gvp.GVPLayerNorm)]
    if op_class == "gvps":
        return [m for m in model.modules()
                if isinstance(m, gvp.GVP) and id(m) not in in_conv]
    if op_class == "readout":
        return [model.emb_in, model.dense_0, model.dense_1]
    if op_class == "edges":
        return [model.W_e_norm, model.W_e]
    raise ValueError(op_class)


def _cast(tree, dtype):
    return tree_map(lambda t: t.to(dtype) if isinstance(t, torch.Tensor)
                    and t.is_floating_point() else t, tree)


@contextlib.contextmanager
def in_dtype(modules: Iterable[nn.Module], inner, outer):
    """Run each of ``modules`` in ``inner`` inside a model in ``outer``:
    inputs and parameters cast (differentiably), outputs cast back."""
    saved = []
    for module in modules:
        original = module.forward

        def forward(*args, _m=module, _f=original, **kwargs):
            state = {n: p.to(inner) for n, p in _m.named_parameters()}
            state.update({n: b.to(inner) if b.is_floating_point() else b
                          for n, b in _m.named_buffers()})
            _m.forward = _f
            try:
                out = torch.func.functional_call(
                    _m, state, _cast(args, inner), _cast(kwargs, inner))
            finally:
                _m.forward = forward
            return _cast(out, outer)

        module.forward = forward
        saved.append((module, original))
    try:
        yield
    finally:
        for module, original in saved:
            module.forward = original


def one_step(model: GVPGNNModel, graphs, row, device, dtype,
             other_class: str = "") -> Dict[str, torch.Tensor]:
    """Each parameter's gradient after one train step of a copy of
    ``model`` on ``row`` in ``dtype``, with the op class ``other_class`` in
    the other of float32 and float64; float64 on the CPU."""
    inner = torch.float32 if dtype == torch.float64 else torch.float64
    work = copy.deepcopy(model).to(device=device, dtype=dtype)
    slot = build_slot_data(graphs, device=device)
    slot.pos, slot.y = slot.pos.to(dtype), slot.y.to(dtype)
    chosen = select(work, other_class) if other_class else []
    pool = gvpgnn.POOL["sum"]
    if other_class == "readout":
        gvpgnn.POOL["sum"] = lambda x, batch: _cast(
            global_add_pool(x.to(inner), batch), dtype)
    if other_class == "edges":
        embed = work.embed_edges

        def embed_in_other(batch):
            other = copy.copy(batch)
            other.pos = batch.pos.to(inner)
            return _cast(embed(other), dtype)

        work.embed_edges = embed_in_other
    try:
        with in_dtype(chosen, inner, dtype):
            train_step(work, make_tx(work.parameters(), LR), slot,
                       row.to(device))
    finally:
        gvpgnn.POOL["sum"] = pool
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            .double().cpu() for n, p in work.named_parameters()}


def grad_error(got, want) -> tuple:
    """Largest gradient error relative to that parameter's largest
    reference entry, and the parameter."""
    err, worst = 0.0, ""
    for name, g in got.items():
        top = want[name].abs().max().item()
        diff = (g - want[name]).abs().max().item()
        rel = diff / top if top > 0 else diff
        if rel > err:
            err, worst = rel, name
    return err, worst


def quiet_model(use_pallas: bool) -> GVPGNNModel:
    model = GVPGNNModel(num_layers=4, in_dim=1, out_dim=1,
                        use_pallas=use_pallas, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    for m in model.modules():
        if isinstance(m, gvp.GVPDropout):
            m.rate = 0.0
    return model


PROBE_LAYER, PROBE_GVP = 2, 1     # layers.2.conv.gvp1_bs


@contextlib.contextmanager
def bias_terms(work: GVPGNNModel, found: list, every: list):
    """Collect, in ``found``, the pre-activation of GVP ``PROBE_GVP`` in
    layer ``PROBE_LAYER``'s message chain (its rows' cotangents are the
    per-edge terms of that GVP's bias gradient), with its grad retained;
    and in ``every`` each chain's ReLU pre-activations, in call order."""
    target = getattr(work.layers[PROBE_LAYER].conv, f"gvp{PROBE_GVP}_bs")
    original = gm.gvp_chain

    def chain(s, vx, vy, vz, weights, n_layers, pre_relu=None):
        zs = []
        out = original(s, vx, vy, vz, weights, n_layers, zs)
        every.append([z.detach().double().cpu() for z in zs])
        if weights[gm.N_W * PROBE_GVP + 3] is target:
            zs[PROBE_GVP].retain_grad()
            found.append(zs[PROBE_GVP])
        if pre_relu is not None:
            pre_relu.extend(zs)
        return out

    gm.gvp_chain = chain
    try:
        yield
    finally:
        gm.gvp_chain = original


def probe_step(model: GVPGNNModel, graphs, row, device, dtype) -> dict:
    """One plain-route train step of a copy of ``model``: the probed bias's
    gradient and its per-edge terms, float64 on the CPU."""
    work = copy.deepcopy(model).to(device=device, dtype=dtype)
    slot = build_slot_data(graphs, device=device)
    slot.pos, slot.y = slot.pos.to(dtype), slot.y.to(dtype)
    found: list = []
    every: list = []
    with bias_terms(work, found, every):
        train_step(work, make_tx(work.parameters(), LR), slot, row.to(device))
    if len(found) != 1:
        raise AssertionError(f"probe found {len(found)} chains, want 1")
    bias = getattr(work.layers[PROBE_LAYER].conv, f"gvp{PROBE_GVP}_bs")
    return {"grad": bias.grad.double().cpu(),
            "terms": found[0].grad.double().cpu(),
            "z": found[0].detach().double().cpu(), "every": every}


def flips(z, z_exact):
    """Entries whose sign differs from the float64 run's, their count, and
    the largest float64 |z| among them."""
    flip = torch.sign(z) != torch.sign(z_exact)
    margin = z_exact.abs()[flip].max().item() if flip.any() else 0.0
    return flip, int(flip.sum()), margin


def probe_reading(run: dict, exact: dict) -> dict:
    """How far ``run``'s bias gradient lies from ``exact``'s, split into the
    f32 sum's own rounding and the terms' errors, and the cancellation."""
    top = exact["grad"].abs().max().item()
    t_top = exact["terms"].abs().max().item()
    sum64 = run["terms"].sum(dim=0)
    err = (run["grad"] - exact["grad"]).abs()
    j = int(err.argmax())
    mag = exact["terms"][:, j].abs().sum().item()
    flip, n_flip, margin = flips(run["z"], exact["z"])
    mended = torch.where(flip, exact["terms"], run["terms"]).sum(dim=0)
    all_flips, all_margin = 0, 0.0
    for zs, zs_exact in zip(run["every"], exact["every"]):
        for z, z_exact in zip(zs, zs_exact):
            _, n, m = flips(z, z_exact)
            all_flips, all_margin = all_flips + n, max(all_margin, m)
    return {"grad_err": err.max().item() / top,
            "probed_flips": n_flip, "probed_flip_margin": margin,
            "grad_err_flips_mended": (mended - exact["grad"]).abs().max().item()
            / top,
            "all_relu_flips": all_flips, "all_flip_margin": all_margin,
            "sum_rounding_err": (run["grad"] - sum64).abs().max().item() / top,
            "terms_carry_err": (sum64 - exact["grad"]).abs().max().item() / top,
            "term_err": (run["terms"] - exact["terms"]).abs().max().item()
            / t_top,
            "worst_channel": j,
            "worst_channel_grad": exact["grad"][j].item(),
            "largest_grad": top,
            "cancellation": mag / max(abs(exact["grad"][j].item()), 1e-300),
            "terms_magnitude_sum": mag,
            "live_terms": int((exact["terms"][:, j] != 0).sum())}


def probe_main(graphs, row) -> dict:
    plain = quiet_model(False)
    f32, f64 = torch.float32, torch.float64
    exact = probe_step(plain, graphs, row, "cpu", f64)
    runs = {"cpu f32": probe_step(plain, graphs, row, "cpu", f32),
            "card f32 plain": probe_step(plain, graphs, row, "cuda", f32),
            "card f64 plain": probe_step(plain, graphs, row, "cuda", f64)}
    readings = {name: probe_reading(r, exact) for name, r in runs.items()}
    cpu, card = runs["cpu f32"]["terms"], runs["card f32 plain"]["terms"]
    readings["card vs cpu f32 terms"] = (
        (card - cpu).abs().max().item() / exact["terms"].abs().max().item())
    return {"trial": "gvp_drift_probe_bias",
            "parameter": f"layers.{PROBE_LAYER}.conv.gvp{PROBE_GVP}_bs",
            "readings": readings, "device": card_line()}


def main(argv=None) -> dict:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe-bias", action="store_true",
                    help="the per-edge terms of layers.2.conv.gvp1_bs's "
                    "gradient on both devices")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trial_gvp_drift: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, loaders = bench_data()
    graphs = loaders[0].graphs
    row = torch.from_numpy(np.random.default_rng(7).permutation(
        loaders[0].num_examples))[:100]
    if args.probe_bias:
        out = probe_main(graphs, row)
        print(json.dumps(out), flush=True)
        return out
    kernel, plain = quiet_model(True), quiet_model(False)
    f32, f64 = torch.float32, torch.float64
    exact = one_step(plain, graphs, row, "cpu", f64)
    runs = {"cpu f32": one_step(plain, graphs, row, "cpu", f32),
            "card f32": one_step(kernel, graphs, row, "cuda", f32),
            "card f32 plain": one_step(plain, graphs, row, "cuda", f32),
            "card f64 plain": one_step(plain, graphs, row, "cuda", f64)}
    for name in CLASSES:
        runs[f"card f64, {name} in f32"] = one_step(plain, graphs, row, "cuda",
                                                    f64, name)
        runs[f"card f32, {name} in f64"] = one_step(plain, graphs, row, "cuda",
                                                    f32, name)
    readings = {run: dict(zip(("grad_err", "worst"), grad_error(g, exact)))
                for run, g in runs.items()}
    out = {"trial": "gvp_drift", "readings": readings, "device": card_line()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
