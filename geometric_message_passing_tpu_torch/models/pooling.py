"""Graph-level readout over padded batches (port of ``models/pooling.py``)."""

from __future__ import annotations

import torch

from ..graph import GraphBatch
from ..ops.scatter import segment_mean, segment_sum


def global_add_pool(x: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    return segment_sum(x, batch.graph_id, batch.num_graphs, mask=batch.node_mask)


def global_mean_pool(x: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    return segment_mean(x, batch.graph_id, batch.num_graphs, mask=batch.node_mask)


def first_node_pool(x: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """x at each graph's first node (a pad graph reads node n_pad-1)."""
    return x[batch.first_node]


POOL = {
    "sum": global_add_pool,
    "add": global_add_pool,
    "mean": global_mean_pool,
    "first": first_node_pool,
}
