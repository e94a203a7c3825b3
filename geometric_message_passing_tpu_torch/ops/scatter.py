"""Masked segment reductions (port of ``ops/scatter.py``).

Pad rows contribute zero; an empty segment gives 0 for both sum and mean
(torch_scatter semantics).  These are plain PyTorch: on CUDA ``index_add_``
sums with atomics, so the order of a sum may vary from run to run there.
The deterministic reduction of the hot path is the EGNN message kernel's
(``ops/edge.py``).
"""

from __future__ import annotations

from typing import Optional

import torch


def _bcast(mask: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets; ``mask`` zeroes rows."""
    if mask is not None:
        data = torch.where(_bcast(mask, data), data, torch.zeros_like(data))
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean with empty segments mapped to 0."""
    total = segment_sum(data, segment_ids, num_segments, mask)
    ones = data.new_ones(data.shape[:1] + (1,))
    count = segment_sum(ones, segment_ids, num_segments, mask)[..., 0]
    count = torch.clamp_min(count, 1.0)
    return total / count.reshape(count.shape + (1,) * (total.ndim - 1))
