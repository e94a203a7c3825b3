"""Accuracy validation sweep of the port (port of the repository's
``scripts/validate_accuracy.py``): every (model, dataset) row of the JAX
script's table through the port's regression CLI (``experiments/cli.py``),
each row in a child process of its own, on one CUDA card.

    python -m geometric_message_passing_tpu_torch.experiments.validate_accuracy \\
        [name ...] [--jobs N]

``CONFIGS`` and ``BASE`` are the JAX script's, row for row: a row's argv is
``--model M --dataset D`` + ``BASE`` + the row's own flags (argparse's last
value wins, so a row's ``--fold`` / ``--n_data`` override ``BASE``'s), then
``extra`` (``sweep(extra=...)``: the tests and ``chip_smoke.py`` cut the
depth with it), then ``--results_file`` of the child's own.  A name keeps
the rows whose model or dataset it is (the JAX script's ``only``); none
keeps all 18.  ``--jobs N`` runs up to N children at a time (default 1, the
JAX script's one at a time), the rows with the most epochs first; the rows
and the files keep the table's order.

A child is ``python -m ...validate_accuracy --child [--device D] ARGV``: it
calls ``cli.main(ARGV, device=D)`` (the CLI's device is an argument, not a
flag), on the card unless ``D`` is ``cpu``, and loads the kernels the
sweep built before it started (``.gmp_torch_build/``).  Each row records the child's
``Test MAE {mean} ± {std}`` line, the test MAE and ``train_time`` of each
repeat (from the child's ledger record), its wall seconds and its
``status``: ``ok``, ``FAILED rc=N`` (a non-zero exit, or no MAE line) or
``timeout`` (3400 s, as in the JAX script).  A diverging row (the
reference's ``dimenet/paired_star2`` is 3.95e7) is a result, not a failure.

Writes ``validation_sweep_torch.json`` (the rows, rewritten after each row)
and appends each child's records to the ledger
``validation_history_torch.json`` (``--sweep_file``, ``--results_file``).
After the last row, ``main`` names the failed rows and returns 1 if any
failed.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

from .ledger import append_result

# (model, dataset, ref_mean, extra flags) — the JAX script's table: the
# reference's best rows; all cosine schedule, lr 5e-4, n_data 1500, fold
# [7], max_ell 3
CONFIGS = [
    ("tfn",     "star",         0.0667, ["--pool", "first", "--n_layers", "4", "--n_epochs", "200"]),
    ("mace",    "star",         0.0766, ["--pool", "first", "--n_layers", "2", "--n_epochs", "200"]),
    ("dimenet", "star",         0.0837, ["--pool", "first", "--n_layers", "4", "--n_epochs", "600"]),
    ("egnn",    "star",         0.0986, ["--pool", "first", "--n_layers", "4", "--n_epochs", "600"]),
    ("dimenet", "paired_star",  0.0078, ["--pool", "first", "--n_layers", "4", "--n_epochs", "600", "--n_pairs", "2"]),
    ("mace",    "paired_star",  0.0254, ["--pool", "mean", "--n_layers", "2", "--n_epochs", "200", "--n_pairs", "2"]),
    ("egnn",    "paired_star",  0.0271, ["--pool", "mean", "--n_layers", "4", "--n_epochs", "600", "--n_pairs", "2"]),
    ("tfn",     "paired_star",  0.0712, ["--pool", "mean", "--n_layers", "4", "--n_epochs", "200", "--n_pairs", "2"]),
    ("mace",    "paired_star2", 0.1013, ["--pool", "mean", "--n_layers", "2", "--n_epochs", "200", "--n_pairs", "2"]),
    ("egnn",    "paired_star2", 0.3008, ["--pool", "first", "--n_layers", "4", "--n_epochs", "600", "--n_pairs", "2"]),
    # the reference's dimenet/paired_star2 diverged (mean 3.95e7): a
    # stability row
    ("tfn",     "paired_star2", 0.1888, ["--pool", "mean", "--n_layers", "4", "--n_epochs", "200", "--n_pairs", "2"]),
    ("dimenet", "paired_star2", 39526332.0, ["--pool", "mean", "--n_layers", "4", "--n_epochs", "600", "--n_pairs", "2"]),
    # the reference's unlabeled (pre-dataset-flag) rows: star dataset, the
    # models' default pooling, single reference runs
    ("spherenet", "star", 0.0735, ["--n_layers", "2", "--n_epochs", "200",
                                   "--fold", "5", "6", "7"]),
    ("tfn",     "star", 0.0055, ["--n_layers", "4", "--n_epochs", "200",
                                 "--fold", "5"]),
    ("egnn",    "star", 0.0079, ["--n_layers", "4", "--n_epochs", "600",
                                 "--fold", "8"]),
    ("dimenet", "star", 0.0169, ["--n_layers", "4", "--n_epochs", "200",
                                 "--fold", "7"]),
    ("mace",    "star", 0.0482, ["--n_layers", "2", "--n_epochs", "200",
                                 "--fold", "5", "6", "7"]),
    ("schnet",    "star", 0.7351, ["--n_layers", "4", "--n_epochs", "1200",
                                   "--fold", "3", "4", "5", "6", "7",
                                   "--n_data", "1400"]),
]

BASE = ["--lr", "5e-4", "--n_data", "1500", "--fold", "7", "--max_ell", "3",
        "--cosine", "--n_times", "3", "--results_file",
        "validation_history.json"]

SWEEP_FILE = "validation_sweep_torch.json"
LEDGER_FILE = "validation_history_torch.json"
TIMEOUT_S = 3400
MODULE = "geometric_message_passing_tpu_torch.experiments.validate_accuracy"
MAE_LINE = re.compile(r"Test MAE (\S+) ± (\S+)")
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def selected(only: Optional[Sequence[str]] = None) -> list:
    """``(index, row)`` of the rows whose model or dataset is in ``only``
    (every row when it is empty)."""
    return [(i, row) for i, row in enumerate(CONFIGS)
            if not only or row[0] in only or row[1] in only]


def child_argv(model: str, dataset: str, flags: Sequence[str],
               extra: Sequence[str], results_file: str) -> list:
    """The CLI's argv for one row: ``BASE``, the row's flags, ``extra``,
    then ``results_file`` (argparse's last value wins)."""
    return (["--model", model, "--dataset", dataset] + BASE + list(flags)
            + list(extra) + ["--results_file", results_file])


def run_row(model: str, dataset: str, ref_mean: float, flags: Sequence[str],
            extra: Sequence[str] = (), device=None, timeout: float = TIMEOUT_S,
            ledger: Optional[str] = LEDGER_FILE,
            lock: Optional[threading.Lock] = None) -> dict:
    """Run one row in a child process and return its row; its ledger
    records are appended to ``ledger`` (under ``lock``)."""
    with tempfile.TemporaryDirectory(prefix="gmp_sweep_") as tmp:
        results = os.path.join(tmp, "row.json")
        cmd = [sys.executable, "-m", MODULE, "--child"]
        if device is not None:
            cmd += ["--device", str(device)]
        cmd += child_argv(model, dataset, flags, extra, results)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (_PACKAGE_PARENT, os.environ.get("PYTHONPATH")) if p))
        t0 = time.time()
        mean = std = float("nan")
        records, tail = [], ""
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=timeout, env=env)
            lines = [m for m in map(MAE_LINE.search,
                                    (out.stdout or "").splitlines()) if m]
            if lines:
                mean, std = float(lines[-1].group(1)), float(lines[-1].group(2))
            status = ("ok" if lines and out.returncode == 0
                      else f"FAILED rc={out.returncode}")
            if status != "ok":
                tail = (out.stdout or "")[-2000:] + (out.stderr or "")[-2000:]
            if os.path.isfile(results):
                with open(results) as f:
                    records = json.load(f)
        except subprocess.TimeoutExpired:
            status = "timeout"
        wall = time.time() - t0
    if ledger and records:
        with lock or threading.Lock():
            for rec in records:
                append_result(ledger, rec)
    last = records[-1] if records else {}
    row = dict(model=model, dataset=dataset, ref_mean=ref_mean, mean=mean,
               std=std, status=status, wall_s=round(wall, 1),
               test_maes=last.get("test_acc"), s_per_run=last.get("train_time"),
               flags=list(flags) + list(extra))
    if tail:
        row["tail"] = tail
    return row


def sweep(only: Optional[Sequence[str]] = None, extra: Sequence[str] = (),
          device=None, jobs: int = 1, sweep_file: Optional[str] = SWEEP_FILE,
          ledger: Optional[str] = LEDGER_FILE,
          timeout: float = TIMEOUT_S) -> list:
    """Run the selected rows (``jobs`` children at a time) and return their
    rows in the table's order; ``sweep_file`` is rewritten after each.  On
    the card the kernels are built here first, so no child builds them."""
    if device is None or str(device).startswith("cuda"):
        from ..ops import _build

        _build.build_all()
    todo = selected(only)
    done: dict = {}
    lock = threading.Lock()

    def one(item):
        i, (model, dataset, ref_mean, flags) = item
        print(f"== {model}/{dataset} (ref {ref_mean}) ...", flush=True)
        row = run_row(model, dataset, ref_mean, flags, extra, device, timeout,
                      ledger, lock)
        with lock:
            done[i] = row
            print(f"   {model}/{dataset} -> {row['mean']:.5f} ± "
                  f"{row['std']:.5f} ({row['status']}, {row['wall_s']:.0f}s)",
                  flush=True)
            if row.get("tail"):
                print(row["tail"], flush=True)
            if sweep_file:
                with open(sweep_file, "w") as f:
                    json.dump([done[k] for k in sorted(done)], f, indent=1)
        return row

    with ThreadPoolExecutor(max_workers=max(1, jobs)) as pool:
        list(pool.map(one, sorted(todo, key=lambda it: -epochs(
            BASE + list(it[1][3]) + list(extra)))))
    return [done[i] for i, _ in todo]


def epochs(argv: Sequence[str]) -> int:
    """The CLI's ``--n_epochs`` in ``argv`` (the last one; 600 without)."""
    flags = list(argv)
    at = [i for i, a in enumerate(flags) if a == "--n_epochs"]
    return int(flags[at[-1] + 1]) if at else 600


def failed(rows: Sequence[dict]) -> list:
    """``model/dataset`` of each row whose status is not ``ok``."""
    return [f"{r['model']}/{r['dataset']}" for r in rows
            if r["status"] != "ok"]


def child(argv: Sequence[str]) -> int:
    """The child: ``[--device D] ARGV`` -> ``cli.main(ARGV, device=D)``."""
    argv = list(argv)
    device = None
    if argv[:1] == ["--device"]:
        device, argv = argv[1], argv[2:]
    from .cli import main as cli_main

    cli_main(argv, device=device)
    return 0


def main(argv=None, device=None) -> int:
    """Run the sweep the arguments ``argv`` select on ``device`` (default
    the card); 1 if a row failed (the failed rows are named)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--child"]:
        return child(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("only", nargs="*",
                    help="model or dataset names (default: every row)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="children at a time (default 1)")
    ap.add_argument("--sweep_file", default=SWEEP_FILE)
    ap.add_argument("--results_file", default=LEDGER_FILE,
                    help="the ledger the children's records go to")
    args = ap.parse_args(argv)
    rows = sweep(args.only or None, device=device, jobs=args.jobs,
                 sweep_file=args.sweep_file, ledger=args.results_file)
    bad = failed(rows)
    if bad:
        print(f"validate_accuracy: {len(bad)} of {len(rows)} rows failed: "
              + ", ".join(bad), file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
