"""Masked segment reductions (port of ``ops/scatter.py``).

Pad rows contribute zero; an empty segment gives 0 for sum, mean and max
(torch_scatter semantics).

``segment_sum`` (and ``segment_mean``, whose sum and count are two segment
sums) is deterministic on both devices: a CUDA tensor goes to the
hand-written segment sum (``ops.sorted_segsum.segment_sum``, K4), which
adds each segment's rows in a fixed order without atomics, so two runs give
bitwise-equal sums; a CPU tensor takes ``segment_sum_plain``, the
masked ``index_add_``.  Data of more than two dimensions is summed as
``[E, prod(rest)]`` rows and reshaped back.  ``segment_max`` and
``segment_min`` stay plain PyTorch on both devices (``scatter_reduce`` with
``amax`` / ``amin`` is order-independent).

``segment_sum_into`` is the accumulator form of the chunked triplet folds;
given the chunk's plan of ids that are already ascending
(``ops.sorted_segsum.ascending_plan``), a CUDA tensor takes the sorted
segment sum (K3) over it instead of K4, the accumulator added in the same
launch.
"""

from __future__ import annotations

from typing import Optional

import torch


def _bcast(mask: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))


def segment_sum_plain(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: the masked ``index_add_`` of ``data`` rows into
    ``num_segments`` buckets (on CUDA its order of addition is not fixed)."""
    if mask is not None:
        data = torch.where(_bcast(mask, data), data, torch.zeros_like(data))
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets; ``mask`` zeroes rows.
    On the card: K4, one launch (ids outside ``[0, num_segments)`` are
    dropped there); on the CPU: ``segment_sum_plain``."""
    if data.device.type == "cpu":
        return segment_sum_plain(data, segment_ids, num_segments, mask)
    from .sorted_segsum import segment_sum as csr_segment_sum

    rest = tuple(data.shape[1:])
    rows = data.reshape(data.shape[0], -1) if len(rest) != 1 else data
    out = csr_segment_sum(rows, segment_ids, num_segments, mask)
    return out.reshape((num_segments,) + rest)


def segment_sum_into(acc: torch.Tensor, data: torch.Tensor,
                     segment_ids: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     plan=None) -> torch.Tensor:
    """``acc`` plus the masked segment sum of ``data`` over ``segment_ids``
    into ``acc.shape[0]`` rows.  With ``plan`` (ids ascending): K3 over it
    on the card, ``acc`` added inside the same launch
    (``sorted_segsum.sorted_fold``); else ``segment_sum``."""
    if plan is not None:
        from .sorted_segsum import sorted_fold

        return sorted_fold(data, segment_ids, plan, mask, acc=acc)
    return acc + segment_sum(data, segment_ids, acc.shape[0], mask)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean with empty segments mapped to 0."""
    total = segment_sum(data, segment_ids, num_segments, mask)
    ones = data.new_ones(data.shape[:1] + (1,))
    count = segment_sum(ones, segment_ids, num_segments, mask)[..., 0]
    count = torch.clamp_min(count, 1.0)
    return total / count.reshape(count.shape + (1,) * (total.ndim - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Max with empty segments mapped to 0."""
    if mask is not None:
        data = torch.where(_bcast(mask, data), data,
                           torch.full_like(data, -torch.inf))
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), -torch.inf)
    idx = _bcast(segment_ids.long(), data).expand_as(data)
    out = out.scatter_reduce(0, idx, data, "amax", include_self=True)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Min with empty segments mapped to 0."""
    if mask is not None:
        data = torch.where(_bcast(mask, data), data,
                           torch.full_like(data, torch.inf))
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), torch.inf)
    idx = _bcast(segment_ids.long(), data).expand_as(data)
    out = out.scatter_reduce(0, idx, data, "amin", include_self=True)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically stable softmax within each segment (masked rows 0)."""
    mx = segment_max(logits, segment_ids, num_segments, mask)
    ex = torch.exp(logits - mx[segment_ids])
    if mask is not None:
        ex = torch.where(_bcast(mask, ex), ex, torch.zeros_like(ex))
    denom = segment_sum(ex, segment_ids, num_segments)
    return ex / torch.clamp_min(denom[segment_ids], 1e-16)
