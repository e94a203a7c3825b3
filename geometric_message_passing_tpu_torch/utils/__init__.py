"""Utilities of the port (``utils`` of the JAX package): checkpoints,
numeric checks, tracing and timing (``profiler``), roofline counters
(``roofline``) and graph drawing (``plot``, matplotlib imported on use)."""

from .checkpoint import CheckpointManager, load_checkpoint, save_checkpoint  # noqa: F401
from .debug import all_finite, debug_nans  # noqa: F401
from .profiler import profile_trace, time_fn  # noqa: F401
