"""The precision options on one CUDA card (``chip_smoke.py`` phases 11a and
11b, also runnable alone):

    python -m geometric_message_passing_tpu_torch.experiments.precision_check

11a. ``precision.py``'s products at MACE's head and tensor-product shapes
     (``bench.MACE_STAR``'s hidden layer at the star train bucket, E 1400:
     a weight head ``F.linear``, stage 1's ``sh @ C`` and its batched
     product), forward and backward, against float64 on the card:
     ``highest`` under the process default ``tensorfloat32`` bitwise the
     exact f32 product and gradients (the scope holds in the backward);
     ``tensorfloat32`` within TF32's error, ``(2^-9 + K 2^-23) |A| @ |B|``
     element by element, and different from exact at the head (TF32 is
     allowed, not forced: cuBLAS may keep f32 FMAs for a shape, as it does
     for the batched product's [1400, 64, 16] x [1400, 16, 99]);
     ``bfloat16_3x``'s max error above exact f32's and, where TF32 was
     taken, below TF32's.
11b. One train step (the L1-sum loss's gradients) of MACE star and TFN star
     at full width on their first training batch, against a float64 step
     on the card (K7 there by its plain version: the kernel is f32): exact
     f32, the process default ``tensorfloat32``, ``bfloat16_3x`` and, for
     MACE, ``chain_dtype="bfloat16"``; each gradient within ``STEP_TOL``
     of that tensor's largest float64 entry, TF32 farther than exact f32,
     K7 and K4 launched as in the f32 step.  Then a short CLI run of MACE
     star under ``--matmul_precision tensorfloat32`` and ``bfloat16_3x``
     (``CLI_ARGV``): the mean training loss of its last epoch below its
     first's.

``run()`` returns (readings, failures); ``main`` prints the readings as one
JSON line and exits 1 on a failure.  It needs a card and raises without
one.
"""

from __future__ import annotations

import copy
import json
import sys
import tempfile
import time
from unittest import mock

import torch
from torch.nn import functional as F

from .. import precision
from ..graph import assemble_batch, build_slot_data
from ..nn import tensor_product
from ..nn.symmetric_contraction import SymmetricContraction
from ..ops import edge_contract as ec
from ..ops import sorted_segsum
from . import cli, train
from .bench import (BATCH_SIZE, card_line, mace_data, mace_model, tfn_data,
                    tfn_model)
from .train import l1_sum_loss, seed_everything

E_TRAIN = 1400          # the star train bucket's edges
# a step's gradients against float64, of each tensor's largest entry
STEP_TOL = {"exact": 1e-3, "bfloat16_3x": 1e-3, "tensorfloat32": 5e-2,
            "chain bfloat16": 1e-1}
CLI_ARGV = ["--model", "mace", "--dataset", "star", "--fold", "7",
            "--n_data", "500", "--n_layers", "2", "--max_ell", "3",
            "--pool", "first", "--lr", "5e-4", "--cosine", "--n_epochs", "8"]


def _reset() -> None:
    ec.edge_weighted_contract_grouped.launches = 0
    ec.edge_weighted_contract_grouped.bwd_launches = 0
    ec.edge_weighted_contract.launches = ec.edge_weighted_contract.bwd_launches = 0
    sorted_segsum.segment_sum.launches = 0


def _counts() -> dict:
    return {"k7": ec.edge_weighted_contract_grouped.launches,
            "k7_bwd": ec.edge_weighted_contract_grouped.bwd_launches,
            "k7_one": ec.edge_weighted_contract.launches
            + ec.edge_weighted_contract.bwd_launches,
            "k4": sorted_segsum.segment_sum.launches}


def _contract_grouped_plain(Ts, Ws):
    """K7's plain version, group by group (for the float64 step)."""
    return [ec.edge_weighted_contract_plain(T, W) for T, W in zip(Ts, Ws)]


def _run(routed, xs, g, precision_name=None, process=None):
    """``routed(*xs, precision_name)`` under the process default
    ``process``: (output, gradients of (output * g).sum())."""
    leaves = [x.detach().clone().requires_grad_(x.requires_grad) for x in xs]
    with precision.matmul_precision(process):
        out = routed(*leaves, precision_name)
        (out * g).sum().backward()
    return out.detach(), [x.grad for x in leaves if x.requires_grad]


def product_cases(dev) -> dict:
    """(plain op, its ``precision.py`` route, inputs, K) at MACE's
    hidden-layer head and stage-1 shapes."""
    model = mace_model(seed_everything(0), device=dev)
    conv = model.convs[1]
    head, tp = conv.fc_out[0], conv.tp
    L, S, M = tp._C.shape
    u = tp._uniform_mul
    gen = torch.Generator().manual_seed(11)

    def rand(*shape, grad=True):
        return torch.randn(*shape, generator=gen).to(dev).requires_grad_(grad)

    C = torch.as_tensor(tp._C, device=dev).permute(1, 0, 2).reshape(S, L * M)
    return {
        "head F.linear": (F.linear, precision.linear,
                          [rand(E_TRAIN, head.in_features),
                           rand(head.out_features, head.in_features),
                           rand(head.out_features)], head.in_features),
        "stage 1 sh @ C": (torch.matmul, precision.matmul,
                           [rand(E_TRAIN, S), C.clone().requires_grad_(False)],
                           S),
        "stage 1 bmm": (torch.bmm, precision.bmm,
                        [rand(E_TRAIN, u, L), rand(E_TRAIN, L, M)], L),
    }


def products(dev) -> tuple:
    """11a: readings and failures."""
    fails, out = [], {}
    for label, (op, routed, xs, k) in product_cases(dev).items():
        gen = torch.Generator().manual_seed(12)
        probe = op(*[x.detach() for x in xs])
        g = torch.randn(probe.shape, generator=gen).to(dev)
        want = _run(lambda *a: op(*a[:-1]), xs, g)     # the plain call
        scoped = _run(routed, xs, g, "highest", "tensorfloat32")
        tf32 = _run(routed, xs, g, None, "tensorfloat32")
        bf3 = _run(routed, xs, g, "bfloat16_3x")
        x64 = [x.detach().double().requires_grad_(x.requires_grad) for x in xs]
        ref = op(*x64)
        (ref * g.double()).sum().backward()
        ref, ref_grads = ref.detach(), [x.grad for x in x64 if x.requires_grad]
        mag = op(*[x.detach().double().abs() for x in xs[:2]])
        if len(xs) == 3:
            mag = mag + xs[2].detach().double().abs()

        def err(res):
            return (float((res[0].double() - ref).abs().max()),
                    [float((a.double() - b).abs().max() / b.abs().max())
                     for a, b in zip(res[1], ref_grads)])

        row = {"shapes": [list(x.shape) for x in xs], "K": k,
               "exact": err(want), "tensorfloat32": err(tf32),
               "bfloat16_3x": err(bf3)}
        row["highest_under_tf32_bitwise"] = bool(
            torch.equal(scoped[0], want[0])
            and all(torch.equal(a, b) for a, b in zip(scoped[1], want[1])))
        row["tf32_taken"] = not torch.equal(tf32[0], want[0])
        bound = (2.0 ** -9 + k * 2.0 ** -23) * mag
        row["tf32_within_bound"] = bool(
            ((tf32[0].double() - ref).abs() <= bound).all())
        row["bf16_3x_between"] = (
            row["exact"][0] < row["bfloat16_3x"][0]
            and (row["bfloat16_3x"][0] < row["tensorfloat32"][0]
                 or not row["tf32_taken"]))
        checks = ["highest_under_tf32_bitwise", "tf32_within_bound",
                  "bf16_3x_between"]
        if label.startswith("head"):
            checks.append("tf32_taken")
        for key in checks:
            if not row[key]:
                fails.append(f"11a {label}: {key} fails: {row}")
        out[label] = row
    return out, fails


def _step_grads(model, batch, dtype=torch.float32, process=None,
                chain_dtype=None):
    """Gradients (float64 on the card) of one L1-sum loss backward of a
    copy of ``model`` on ``batch``, and the K7 / K4 launches it made."""
    work = copy.deepcopy(model).to(dtype)
    for m in work.modules():
        if isinstance(m, SymmetricContraction):
            m.chain_dtype = chain_dtype
    b = batch
    if dtype != torch.float32:
        b = copy.copy(batch)
        b.pos, b.y = batch.pos.to(dtype), batch.y.to(dtype)
    work.train()
    _reset()
    with precision.matmul_precision(process):
        if dtype == torch.float64:
            with mock.patch.object(tensor_product,
                                   "edge_weighted_contract_grouped",
                                   _contract_grouped_plain):
                l1_sum_loss(work(b), b).backward()
        else:
            l1_sum_loss(work(b), b).backward()
    launched = _counts()
    return ({n: (p.grad if p.grad is not None else torch.zeros_like(p)
                 ).double() for n, p in work.named_parameters()}, launched)


def _grad_err(got: dict, ref: dict) -> tuple:
    worst, name = 0.0, ""
    for n, r in ref.items():
        top = float(r.abs().max())
        e = float((got[n] - r).abs().max()) / (top if top > 0 else 1.0)
        if e > worst:
            worst, name = e, n
    return worst, name


def steps(dev) -> tuple:
    """11b's steps: readings and failures."""
    fails, out = [], {}
    for label, make, data in (("MACE star", mace_model, mace_data),
                              ("TFN star", tfn_model, tfn_data)):
        loaders = data()[1]
        slot = build_slot_data(loaders[0].graphs, device=dev)
        batch = assemble_batch(slot, torch.arange(BATCH_SIZE, device=dev))
        model = make(seed_everything(0), device=dev)
        ref, _ = _step_grads(model, batch, torch.float64)
        arms = {"exact": {}, "tensorfloat32": {"process": "tensorfloat32"},
                "bfloat16_3x": {"process": "bfloat16_3x"}}
        if label.startswith("MACE"):
            arms["chain bfloat16"] = {"chain_dtype": "bfloat16"}
        row = {}
        for arm, kw in arms.items():
            t = time.perf_counter()
            grads, launched = _step_grads(model, batch, **kw)
            if torch.device(dev).type == "cuda":
                torch.cuda.synchronize()
            e, worst = _grad_err(grads, ref)
            row[arm] = {"grad_err": e, "worst": worst, "launches": launched,
                        "seconds": time.perf_counter() - t}
            if not e <= STEP_TOL[arm]:
                fails.append(f"11b {label} {arm}: gradients {e:.3e} from "
                             f"float64 ({worst}), tol {STEP_TOL[arm]}")
            if launched != row["exact"]["launches"]:
                fails.append(f"11b {label} {arm}: launched {launched}, the "
                             f"f32 step {row['exact']['launches']}")
        if not row["tensorfloat32"]["grad_err"] > row["exact"]["grad_err"]:
            fails.append(f"11b {label}: TF32 no farther from float64 than "
                         "exact f32")
        out[label] = row
    return out, fails


class _FitLog:
    """``train.fit_regression`` with its results kept."""

    def __init__(self):
        self.results, self._fit = [], train.fit_regression

    def __call__(self, *args, **kw):
        res = self._fit(*args, **kw)
        self.results.append(res)
        return res


def cli_runs() -> tuple:
    """11b's CLI runs: readings and failures."""
    fails, out = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("tensorfloat32", "bfloat16_3x"):
            log = _FitLog()
            _reset()
            t = time.perf_counter()
            with mock.patch.object(train, "fit_regression", log):
                mean = cli.main(CLI_ARGV + ["--matmul_precision", name,
                                            "--results_file",
                                            f"{tmp}/{name}.json"])
            res = log.results[0]
            losses = res.train_losses.mean(axis=1)
            out[name] = {"test_mae": mean, "epoch_loss_first_last":
                         [float(losses[0]), float(losses[-1])],
                         "seconds": time.perf_counter() - t,
                         "launches": _counts(),
                         "process_after": precision.process_default()}
            if not losses[-1] < losses[0]:
                fails.append(f"11b CLI {name}: the loss did not fall "
                             f"({losses.tolist()})")
            if precision.process_default() != "highest" or \
                    torch.backends.cuda.matmul.allow_tf32:
                fails.append(f"11b CLI {name}: the process precision was "
                             "not restored")
    return out, fails


def run(dev="cuda") -> tuple:
    t = time.perf_counter()
    a, fa = products(dev)
    b, fb = steps(dev)
    c, fc = cli_runs()
    return ({"a": a, "b": {"steps": b, "cli": c},
             "seconds": time.perf_counter() - t}, fa + fb + fc)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("precision_check: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    read, fails = run()
    read["card"] = card_line()
    print(json.dumps(read))
    for f in fails:
        print(f"FAIL {f}", file=sys.stderr)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
