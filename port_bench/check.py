"""The comparison that decides ``correct``: the program's first training
steps against the plain reference's, from the same weights on the same
frame.

Three numbers, each against the limit in ``limits/<cell>.json``:

* ``loss_gap``: the largest gap of the three steps' losses, over the
  reference's sum of the atoms' absolute energies at that step (the scale
  of the rounding in a sum of 10k atom energies: the loss ``|E - y|`` and
  the energy itself can both fall near zero, and a gap over either then
  reads how near, not the error);
* ``grad_gap``: over the leaves, the gap between the program's and the
  reference's norm of the step-1 gradient, over the larger of the
  reference leaf's norm and the median leaf's;
* ``update_gap``: the median leaf's gap between the program's and the
  reference's norm of the leaf's change over the three steps (Adam's
  updates), each over the larger of the reference leaf's path (the sum of
  its three steps' norms) and the median leaf's path.  The median and the
  path, not the worst leaf and the change, because of what sound runs
  read: Adam moves every entry by about ``lr`` whatever its gradient's
  size, so an entry whose gradient is zero to rounding moves either way,
  and in a leaf of n entries one such entry moves the change's norm by
  some 1/n of the path (on DimeNet++'s 10k box the worst leaf's gap read
  1.2e-4 on one seed in 16, 5e-7 on the median seed); and the change
  cancels where the energy crosses its target between steps.  The leaves whose step-1 reference gradient is under a
  thousandth of the median leaf's are left out (they move by round-off).
"""

from __future__ import annotations

import statistics
from typing import Dict

NUMBERS = ("loss_gap", "grad_gap", "update_gap")
ROUNDOFF_LEAF = 1e-3


def _gaps(prog: Dict[str, float], ref: Dict[str, float],
          scale: Dict[str, float], keys) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its scale and the
    median leaf's."""
    keys = list(keys)
    med = statistics.median(scale[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(scale[k], med, 1e-300)
            for k in keys}


def _leaf_gaps(prog: dict, ref: dict) -> tuple:
    """Each leaf's gradient gap, and each moved leaf's change gap."""
    med = statistics.median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items() if g >= ROUNDOFF_LEAF * med]
    return (_gaps(prog["grad"], ref["grad"], ref["grad"], ref["grad"]),
            _gaps(prog["delta"], ref["delta"], ref["path"], moved))


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers of the program's readings (``losses``, ``grad``,
    ``delta``) against the reference's (those, with ``scales`` and
    ``path``)."""
    loss = max(abs(a - b) / max(scale, 1e-300)
               for a, b, scale in zip(prog["losses"], ref["losses"],
                                      ref["scales"]))
    grad, update = _leaf_gaps(prog, ref)
    return {"loss_gap": loss, "grad_gap": max(grad.values()),
            "update_gap": statistics.median(update.values())}


def worst_leaves(prog: dict, ref: dict) -> dict:
    """The look behind a seed that reads far above the others: the leaf
    behind ``grad_gap``, the worst leaf's change gap (over its path, and
    over the change itself) and that leaf."""
    grad, update = _leaf_gaps(prog, ref)
    over_change = _gaps(prog["delta"], ref["delta"], ref["delta"], update)
    return {"grad_leaf": max(grad, key=grad.get),
            "update_leaf": max(update, key=update.get),
            "update_gap_worst_leaf": max(update.values()),
            "update_gap_worst_over_change": max(over_change.values())}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """``(correct, checks)``: every number at most its limit (a NaN
    fails); ``checks`` maps each name to its number and limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(c["value"] <= c["limit"] for c in checks.values())  # NaN: False
    return ok, checks
