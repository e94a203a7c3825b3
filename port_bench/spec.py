"""What a cell is, found by name: ``BENCHMARK.json`` at the checkout's root
names the cells and metrics; everything else is a file of its own under
this directory, found by the names there.

* ``configs/<config>.json`` (the path in ``BENCHMARK.json``): the
  program's registry name (``model``) and constructor arguments
  (``args``), ``mean_degree_arg`` (the argument that takes the frame's
  mean degree, if any), ``triplets`` (whether the data layer builds the
  triplets), ``interactions`` (the model attribute whose blocks the traced
  run wraps in ranges), and the names of its ``counts/`` and
  ``reference/`` modules;
* ``traffic/<mix>.json``: the frame generator's parameters;
* ``limits/<cell>.json``: each compared number's limit;
* ``metrics/<metric>.py``: one reader a metric (``read(ctx)``).

A name that has no file fails here, loudly, before anything runs.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

from .check import NUMBERS

PKG = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class SpecError(ValueError):
    """A cell, configuration, mix, limit or reader that cannot be found."""


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    pkg: Path


def _json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise SpecError(f"{what}: no file {path}")
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, what: str) -> ModuleType:
    """The Python file ``path`` as a module (its name may hold dots)."""
    if not path.is_file():
        raise SpecError(f"{what}: no file {path}")
    key = "port_bench._loaded." + re.sub(r"\W", "_", str(path.resolve()))
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str, e2e_of_cell: Optional[set]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_of_cell is None or metric.get("moves") in e2e_of_cell


def load_cell(workload: str, root: Path, pkg: Path = PKG) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its files."""
    bench = _json(root / "BENCHMARK.json", "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SpecError(f"unknown workload {workload!r}; the cells are "
                        f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"{workload}: unknown config {w['config']!r}")
    for name in (w["config"], w["traffic"], workload):
        if not NAME.match(name):
            raise SpecError(f"{name!r} is not a name")
    config = _json(root / configs[w["config"]]["file"], f"config {w['config']}")
    mix = _json(pkg / "traffic" / f"{w['traffic']}.json", f"traffic {w['traffic']}")
    limits = _json(pkg / "limits" / f"{workload}.json", f"limits of {workload}")
    missing = [k for k in NUMBERS if "limit" not in limits.get(k, {})]
    if missing:
        raise SpecError(f"limits of {workload}: no limit for {missing}")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, names)]
    for m in e2e + per_layer:
        if not (pkg / "metrics" / f"{m['name']}.py").is_file():
            raise SpecError(f"metric {m['name']!r}: no reader "
                            f"{pkg / 'metrics' / (m['name'] + '.py')}")
    for key in ("counts", "reference"):
        if not (pkg / key / f"{config[key]}.py").is_file():
            raise SpecError(f"config {w['config']}: no {key} module "
                            f"{config[key]!r}")
    return Cell(workload, config, mix, int(w["chips"]),
                {k: float(limits[k]["limit"]) for k in NUMBERS},
                e2e, per_layer, pkg)


def module(cell: Cell, kind: str) -> ModuleType:
    """The config's ``counts`` or ``reference`` module."""
    return load_module(cell.pkg / kind / f"{cell.config[kind]}.py",
                       f"{kind} of {cell.config['name']}")


def reader(cell: Cell, metric: str) -> ModuleType:
    return load_module(cell.pkg / "metrics" / f"{metric}.py",
                       f"metric {metric}")
