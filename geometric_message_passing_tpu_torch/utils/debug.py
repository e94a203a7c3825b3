"""Numeric checks: ``debug_nans`` finds the operation that first makes a
NaN in a backward pass; ``all_finite`` tells whether a state holds only
finite values.

The trainer's own guard is ``fit_resident(nan_recovery=True)``
(``experiments/train.py``), which rolls back to the latest checkpoint.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Autograd's anomaly mode inside the context: a backward pass that
    makes a NaN raises at the operation whose forward made it, with that
    forward's traceback.  Slow: for tests and debugging.  Restores the
    previous mode on exit."""
    with torch.autograd.set_detect_anomaly(enable, check_nan=True):
        yield


def _float_tensors(state: Any):
    if isinstance(state, torch.Tensor):
        if state.is_floating_point() or state.is_complex():
            yield state
    elif isinstance(state, dict):
        for value in state.values():
            yield from _float_tensors(value)
    elif isinstance(state, (list, tuple)):
        for value in state:
            yield from _float_tensors(value)


def all_finite(state: Any) -> torch.Tensor:
    """A bool scalar tensor: every floating tensor in ``state`` (a tensor, or
    dicts, lists and tuples of them, such as a ``state_dict()``) is finite.
    It stays on the tensors' device: reading it is the caller's host read."""
    flags = [torch.isfinite(t).all() for t in _float_tensors(state)]
    if not flags:
        return torch.ones((), dtype=torch.bool)
    device = flags[0].device
    return torch.stack([f.to(device) for f in flags]).all()
