"""The port's whole-step roofline reports, ``experiments/roofline_report.py``
and ``experiments/roofline_scale.py``, on the CPU: their tables against the
JAX scripts' (``scripts/roofline_report.py``'s ``LAYERS``,
``scripts/roofline_scale.py``'s ``CONFIGS`` read by ``ast``: the JAX scripts
import JAX at the top), each model's row at one layer and narrow width
(the JAX row's fields plus ``counted_on``), the FLOP count of EGNN's step
against a hand count of its products, and the refusal to count a step off
the CPU."""

import ast
from pathlib import Path

import pytest
import torch

from geometric_message_passing_tpu_torch.experiments import (
    bench_throughput as bt, roofline_report as rr, roofline_scale as rs)

ROOT = Path(__file__).resolve().parent.parent
JAX_ROW_FIELDS = ("gflops_per_step", "mb_per_step", "intensity_flop_per_byte",
                  "static_bound", "step_ms", "achieved_tflops",
                  "achieved_gbps", "frac_of_roof")
NARROW = {
    "schnet": dict(hidden_channels=16, num_filters=16),
    "egnn": dict(emb_dim=16),
    "gvp": dict(s_dim=16, v_dim=4),
    "tfn": dict(emb_dim=4, mlp_dim=8, max_ell=2),
    "mace": dict(emb_dim=4, mlp_dim=8, max_ell=2, correlation=2),
    "dimenet": dict(hidden_channels=16, int_emb_size=8, basis_emb_size=4,
                    out_emb_channels=16),
    "spherenet": dict(hidden_channels=16, int_emb_size=8,
                      out_emb_channels=16),
}


def _jax_table(script: str, name: str):
    """The literal assigned to ``name`` in ``scripts/{script}.py``."""
    tree = ast.parse((ROOT / "scripts" / f"{script}.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and [t.id for t in node.targets] == [name]):
            return eval(compile(ast.Expression(node.value), script, "eval"),
                        {"dict": dict})
    raise KeyError(name)


def test_tables_are_the_jax_scripts():
    assert rr.LAYERS == _jax_table("roofline_report", "LAYERS")
    assert all(bt.MODELS[name] == cfg for name, cfg in rr.LAYERS.items())
    want = _jax_table("roofline_scale", "CONFIGS")
    assert list(rs.CONFIGS) == list(want)
    assert {k: (n, cfg) for k, (n, _ms, cfg) in want.items()} == rs.CONFIGS


@pytest.mark.parametrize("name", list(rr.LAYERS))
def test_star_row_has_the_jax_fields(name):
    row = rr.report_row(name, device="cpu",
                        batch_kw=dict(num=6, batch_size=6), steps=1, reps=1,
                        warm=0, num_layers=1, **NARROW[name])
    assert set(JAX_ROW_FIELDS) <= set(row)
    assert row["model"] == name and row["num_layers"] == 1
    assert row["flops"] > 0 and row["bytes_accessed"] > 0
    assert row["step_ms"] > 0 and row["frac_of_roof"] >= 0
    assert (row["counted_on"], row["precision"], row["device"]) == (
        "cpu", "exact f32", "cpu")
    assert row["static_bound"] in ("compute", "memory")


def test_egnn_flops_are_the_hand_count_of_its_products():
    """EGNN, 2 layers x 16 on 6 star graphs: every Linear on the loss's
    path costs 2 M K N forward and twice that backward (the input's and
    the weight's gradients); the last layer's position MLP feeds positions
    the readout never reads, so it has no backward."""
    d, layers = 16, 2
    row = rr.report_row("egnn", device="cpu",
                        batch_kw=dict(num=6, batch_size=6), steps=1, reps=1,
                        warm=0, num_layers=layers, emb_dim=d)
    b = bt.star_batch(num=6, batch_size=6, device="cpu", name="egnn")
    e, n, g = b.senders.shape[0], b.pos.shape[0], b.graph_mask.shape[0]
    msg = e * ((2 * d + 1) * d + d * d)
    pos = e * (d * d + d)
    upd = n * (2 * d * d + d * d)
    head = g * (d * d + d)
    fwd = 2 * (layers * (msg + pos + upd) + head)
    want = 3 * fwd - 2 * 2 * pos
    assert row["flops"] == pytest.approx(want, rel=0.01)


def test_count_refuses_a_step_off_the_cpu():
    model = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="off the CPU"):
        rr.count_on_cpu(lambda: None, model.to("meta"))
    cpu_model = torch.nn.Linear(2, 2)
    x = torch.ones(3, 2, device="meta")
    with pytest.raises(ValueError, match="a tensor on meta"):
        rr.count_on_cpu(lambda: cpu_model(x), cpu_model)
    r = rr.count_on_cpu(lambda: cpu_model(torch.ones(3, 2)), cpu_model)
    assert r.flops == 2 * 3 * 2 * 2


@pytest.mark.parametrize("name", list(rs.CONFIGS))
def test_box_row_on_a_small_box(name):
    cfg = dict(rs.CONFIGS[name][1], num_layers=1,
               **NARROW.get(name, dict(emb_dim=8)))
    row = rs.scale_row(name, n_nodes=300, cfg=cfg, device="cpu", steps=1,
                       reps=1)
    assert set(JAX_ROW_FIELDS) <= set(row)
    assert (row["model"], row["nodes"]) == (name, 300)
    assert row["edges"] > 0 and row["flops"] > 0 and row["bytes_accessed"] > 0
    assert row["counted_on"] == "cpu" and row["cfg"] == cfg
