"""``experiments/bench_scale.py``'s rows against ``scripts/bench_scale.py``:
``MODELS`` and ``FALLBACKS`` read from the JAX script's source, DimeNet++'s
rule by size, the fallback taken on running out of device memory alone (a
labelled row, exit 0; any other error an ``error`` row, no retry, exit 1),
and the launch rules (``dimenet_launches_per_step``,
``spherenet_launches_per_step``, ``fused_launches_per_step``) against the
calls of each kernel's plain version in one CPU step of the model, where
the card launches the kernel."""

import ast
import json
from pathlib import Path

import pytest
import torch

from geometric_message_passing_tpu_torch.experiments import bench_scale
from geometric_message_passing_tpu_torch.ops import edge, scatter
from geometric_message_passing_tpu_torch.ops import sorted_segsum as sss

JAX_SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "bench_scale.py"


def _jax_table(name: str) -> dict:
    """The value of the JAX script's module-level ``name`` (a dict of
    ``dict(...)`` literals), evaluated from its source."""
    tree = ast.parse(JAX_SCRIPT.read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == name for t in node.targets)):
            return eval(compile(ast.Expression(node.value), str(JAX_SCRIPT),
                                "eval"), {"__builtins__": {}, "dict": dict})
    raise LookupError(name)


@pytest.mark.parametrize("table", ["MODELS", "FALLBACKS"])
def test_tables_match_the_jax_script(table):
    assert getattr(bench_scale, table) == _jax_table(table)


def test_dimenet_rule_matches_the_jax_script():
    """``scripts/bench_scale.py:230-240``: remat_blocks and 131072-edge
    chunks from 50k atoms; 65536-edge chunks, rbf_in_chunk and one step a
    call from 100k."""
    base = dict(num_layers=4, triplet_chunk=262144)
    assert bench_scale.config("dimenet", 30_000) == base
    assert bench_scale.config("dimenet", 50_000) == dict(
        base, remat_blocks=True, edge_chunk=131072)
    assert bench_scale.config("dimenet", 100_000) == dict(
        base, remat_blocks=True, edge_chunk=65536, rbf_in_chunk=True)
    assert [bench_scale.model_steps("dimenet", 15, n)
            for n in (30_000, 50_000, 100_000)] == [2, 2, 1]
    assert bench_scale.model_steps("spherenet", 40, 10_000) == 4
    assert bench_scale.config("spherenet", 30_000) == dict(
        num_layers=4, triplet_chunk=131072, quad_chunk=1048576)
    assert bench_scale.config("egnn_fused", 100_000) == dict(num_layers=4,
                                                             emb_dim=128)
    assert [bench_scale.box_kind(n) for n in (
        "dimenet", "spherenet", "egnn_fused", "egnn_sorted")] == [
        "triplets", "quads", "plain", "sorted"]


class _Box:
    def to(self, device):
        return self


def _run_main(monkeypatch, capsys, outcomes, models="dimenet"):
    """``bench_scale.main`` with a card pretended, the box stubbed and
    ``bench_one`` replaced by ``outcomes`` in turn (a row, or an exception
    to raise); the exit code, the printed rows and the configs tried."""
    tried = []

    def bench_one(name, cfg, batch, steps, reps=3):
        tried.append(dict(cfg))
        out = outcomes.pop(0)
        if isinstance(out, BaseException):
            raise out
        return dict(out, cfg=dict(cfg))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench_scale, "kind_box", lambda *a, **k: _Box())
    monkeypatch.setattr(bench_scale, "bench_one", bench_one)
    code = bench_scale.main(["--models", models, "--sizes", "100000"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    return code, rows, tried


def test_out_of_memory_takes_the_labelled_fallback(monkeypatch, capsys):
    code, rows, tried = _run_main(monkeypatch, capsys, [
        torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                    "2.00 GiB\nmore"), {"model": "dimenet"}])
    assert code == 0 and len(rows) == 1
    full = bench_scale.config("dimenet", 100_000)
    assert tried == [full, {**full, **bench_scale.FALLBACKS["dimenet"]}]
    row = rows[0]
    assert row["cfg"] == tried[1] and "error" not in row
    assert row["note"] == ("fallback config after: CUDA out of memory. "
                           "Tried to allocate 2.00 GiB")


@pytest.mark.parametrize("outcomes", [
    [RuntimeError("a kernel fault")],
    [torch.cuda.OutOfMemoryError("out of memory"),
     torch.cuda.OutOfMemoryError("out of memory again")],
    [torch.cuda.OutOfMemoryError("out of memory"), ValueError("bad width")],
], ids=["fault", "oom-twice", "oom-then-fault"])
def test_errors_are_error_rows(monkeypatch, capsys, outcomes):
    """Any error but running out of memory is an ``error`` row with no
    retry; a row that fails at both widths is one too; either exits 1."""
    first = type(outcomes[0])
    code, rows, tried = _run_main(monkeypatch, capsys, list(outcomes))
    assert code == 1 and len(rows) == 1 and "error" in rows[0]
    assert "note" not in rows[0]
    assert len(tried) == (1 if first is RuntimeError else 2)


class _Counts:
    """Calls of each kernel's plain version: where a CUDA tensor launches
    K1 (``egnn_message``), K2 (its backward), K3 (the triplet fold) or K4
    (``ops.scatter.segment_sum``); K4's inside K1's and K2's plain versions
    are theirs, not K4's."""

    def __init__(self, monkeypatch):
        self.n = {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
        self.inside = 0
        for mod, name, key in ((edge, "egnn_message_plain", "k1"),
                               (edge, "egnn_message_bwd_plain", "k2"),
                               (sss, "sorted_segment_sum_plain", "k3"),
                               (scatter, "segment_sum_plain", "k4")):
            monkeypatch.setattr(mod, name, self._counted(getattr(mod, name),
                                                         key))

    def _counted(self, fn, key):
        def call(*args, **kwargs):
            if not self.inside:
                self.n[key] += 1
            if key in ("k1", "k2"):
                self.inside += 1
            try:
                return fn(*args, **kwargs)
            finally:
                if key in ("k1", "k2"):
                    self.inside -= 1
        return call


def _small(name, cfg):
    return dict(cfg, **({"emb_dim": 16} if name == "egnn_fused" else
                        dict(hidden_channels=16, int_emb_size=8,
                             out_emb_channels=16)))


@pytest.mark.parametrize("name,rule", [
    ("dimenet", dict()),
    ("dimenet", dict(triplet_chunk=3)),
    ("dimenet", dict(triplet_chunk=3, edge_chunk=3, remat_blocks=True,
                     rbf_in_chunk=True)),
    ("dimenet", dict(triplet_chunk=3, edge_chunk=3, remat_full_blocks=True)),
    ("dimenet", dict(triplet_chunk=3, edge_chunk=3,
                     chunk_output_blocks=False)),
    ("spherenet", dict(triplet_chunk=3)),
    ("egnn_fused", dict()),
], ids=str)
def test_launch_rules_count_the_code(monkeypatch, name, rule):
    """One bench_scale step on a 200-atom box, chunks (``rule``'s 3: a
    third of the rows, plus one) that do not divide the rows; each kernel's
    calls against the rule."""
    box = bench_scale.kind_box(bench_scale.box_kind(name), 200)
    cfg = dict(bench_scale.config(name, 200))
    if name == "egnn_fused":
        cfg["num_layers"] = 3
    for key, parts in rule.items():
        if key in ("triplet_chunk", "edge_chunk"):
            rows = (box.triplets.num_triplets if key == "triplet_chunk"
                    else box.num_edges)
            parts = rows // parts + 1
        cfg[key] = parts
    if name == "spherenet":
        cfg["quad_chunk"] = box.triplets.q_trip.shape[0] // 3 + 1
    model = bench_scale.build(name, _small(name, cfg),
                              torch.Generator().manual_seed(0), "cpu")
    step = bench_scale.make_step(model, box)
    counts = _Counts(monkeypatch)
    step()
    if name == "dimenet":
        want = dict(bench_scale.dimenet_launches_per_step(cfg, box), k1=0,
                    k2=0)
    elif name == "spherenet":
        want = dict(bench_scale.spherenet_launches_per_step(cfg, box), k1=0,
                    k2=0)
    else:
        want = dict(bench_scale.fused_launches_per_step(3), k3=0)
    assert counts.n == want
    if rule.get("triplet_chunk"):
        assert want["k3"] >= 3 * cfg["num_layers"]
