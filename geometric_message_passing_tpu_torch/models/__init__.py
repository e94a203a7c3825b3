"""Models of the port."""

from .egnn_fused import EGNNFusedModel, FusedEGNNLayer  # noqa: F401
