"""Checkpoints and numeric checks of the port (``utils`` of the JAX package:
its checkpoint and debug modules)."""

from .checkpoint import CheckpointManager, load_checkpoint, save_checkpoint  # noqa: F401
from .debug import all_finite, debug_nans  # noqa: F401
