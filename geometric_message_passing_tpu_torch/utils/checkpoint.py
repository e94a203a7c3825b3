"""Checkpoint / resume on ``torch.save`` and ``torch.load``.

A checkpoint is one file holding a nested dict of tensors, Python numbers,
strings, lists and dicts: what ``torch.load(weights_only=True)`` reads back
without running any pickled code.  numpy scalars are not among them, so
callers store floats as Python floats (a float32 survives the float64 round
trip exactly) or as tensors.

Each file is written under a temporary name and then moved into place with
``os.replace``, so a process killed in mid-save leaves the previous
checkpoint whole and at most a stray ``*.tmp`` file, which is ignored.

The JAX package's orbax checkpoints are not read here: weights cross over
through ``weights.py``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _write(path: str, obj: Any) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_checkpoint(path: str, variables: Dict[str, Any],
                    opt_state: Any = None, step: int = 0,
                    metadata: Optional[dict] = None) -> None:
    """Write ``{"variables", "step"[, "opt_state"][, "metadata"]}`` to the
    file ``path`` (a model's ``state_dict()`` and an optimizer's, say)."""
    ckpt = {"variables": variables, "step": int(step)}
    if opt_state is not None:
        ckpt["opt_state"] = opt_state
    if metadata:
        ckpt["metadata"] = metadata
    _write(os.path.abspath(path), ckpt)


def load_checkpoint(path: str, map_location: Any = "cpu") -> dict:
    """Read a checkpoint file back, its tensors on ``map_location``."""
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)


class CheckpointManager:
    """Rolling checkpoints in ``directory``, one file ``step_<n>.pt`` per
    saved step; the newest ``max_to_keep`` are kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be at least 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> List[int]:
        """The saved steps, in ascending order."""
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.match, os.listdir(self.directory)) if m)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any]) -> None:
        """Write ``state`` as step ``step``, then drop all but the newest
        ``max_to_keep`` steps."""
        _write(self._path(step), state)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, step: Optional[int] = None,
                map_location: Any = "cpu") -> Dict[str, Any]:
        """The state saved as ``step`` (default: the latest)."""
        step = self.latest_step if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return load_checkpoint(self._path(step), map_location)

    def close(self) -> None:
        """Nothing is held open between calls; kept for the JAX package's
        interface."""
