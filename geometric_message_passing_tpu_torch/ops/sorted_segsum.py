"""Sorted segment sums for the box-scale path (port of
``ops/pallas_sorted_segsum.py``), and the masked segment sum over unsorted
ids (port of ``ops/pallas_edge.py::segment_sum_pallas``).

Both reduce through one hand-written CUDA kernel, ``csrc/sorted_segsum.cu``:
``out[s] = sum of data[perm[k]] for k in rowptr[s]:rowptr[s+1]``, in a
fixed order, in the data's type (f32, or f64 for the float64 reference
runs on the card), without atomics.

* ``build_segment_plan`` makes that CSR on the host, once per graph: a
  stable sort of the masked-in edges by segment id (masked-off edges sort
  last, outside every row) and the row pointers, moved to the device once.
  ``identity_perm`` marks a plan whose edges are already sorted (the
  receiver plan of a receiver-sorted graph): the kernel then reads the rows
  in place.  ``batch_seg_plans`` builds a batch's receiver and sender plans.
* ``ascending_plan`` builds the identity plan of ids that are already
  ascending on their own device (``searchsorted``: no sort, no host read):
  the triplet fold of DimeNet++ and SphereNet over ``idx_ji``
  (``sorted_fold``: masked rows are zeroed in the data, not left out of the
  plan), one K3 launch per fold.
* ``sorted_segment_sum`` (K3 forward; its backward is the masked gather
  ``g[seg]``) and ``sorted_gather`` (``h[idx]``, whose backward is K3 over
  the cotangent) are autograd functions; ``sorted_segment_sum.launches``
  counts their K3 launches.
* ``segment_sum`` (K4) builds the CSR of unsorted ids on the device
  (``ops.edge.receiver_csr``) and launches the same kernel;
  ``segment_sum.launches`` counts it.  ``ops.scatter.segment_sum`` (every
  plain-route message sum, ``segment_mean`` and the sum/mean pools) sends
  its CUDA tensors here.

Tensors on the CPU take the plain version of the kernel,
``sorted_segment_sum_plain``: the masked ``index_add_`` sum of
``ops.scatter.segment_sum``, computed from the segment ids and the mask, not
from the plan.  CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .edge import receiver_csr
from .scatter import segment_sum_plain as sorted_segment_sum_plain


class SegmentPlan(NamedTuple):
    """CSR of the masked-in edges by segment id."""

    perm: Optional[torch.Tensor]  # [E] int64 edge ids, stably sorted by
    #                               segment (None: the identity, not stored)
    rowptr: torch.Tensor   # [S+1] int64: segment s is perm[rowptr[s]:rowptr[s+1]]
    num_segments: int
    identity_perm: bool    # perm == arange(E)
    masked: bool           # built with a mask: masked-off edges in no row


def build_segment_plan(segment_ids, num_segments: int, mask=None,
                       device="cpu") -> SegmentPlan:
    """The plan of ``segment_ids`` ``[E]`` (any order) under ``mask``
    (``[E]`` bool, None = all edges), built with numpy and moved to
    ``device`` once.  Masked-in ids must lie in ``[0, num_segments)``."""
    seg = np.asarray(torch.as_tensor(segment_ids).cpu(), np.int64)
    e = seg.shape[0]
    live = (np.ones(e, bool) if mask is None
            else np.asarray(torch.as_tensor(mask).cpu(), bool))
    if live.any() and (seg[live].min() < 0 or seg[live].max() >= num_segments):
        raise ValueError("build_segment_plan: a masked-in segment id lies "
                         f"outside [0, {num_segments})")
    key = np.where(live, seg, num_segments)       # masked-off edges sort last
    perm = np.argsort(key, kind="stable")
    rowptr = np.searchsorted(key[perm], np.arange(num_segments + 1), "left")
    return SegmentPlan(
        perm=torch.from_numpy(perm).to(device),
        rowptr=torch.from_numpy(rowptr.astype(np.int64)).to(device),
        num_segments=num_segments,
        identity_perm=bool(np.array_equal(perm, np.arange(e))),
        masked=mask is not None)


def ascending_plan(segment_ids: torch.Tensor, num_segments: int
                   ) -> SegmentPlan:
    """The identity plan of ``segment_ids`` ``[T]``, which must already be
    ascending and lie in ``[0, num_segments)`` (the builders of the triplet
    arrays check it on the host), built on their device:
    ``rowptr = searchsorted(ids, arange(S + 1))``.  Every row lies in a
    segment; a mask is applied to the data (``sorted_fold``)."""
    ids = segment_ids.long()
    rowptr = torch.searchsorted(
        ids, torch.arange(num_segments + 1, device=ids.device))
    return SegmentPlan(perm=None, rowptr=rowptr, num_segments=num_segments,
                       identity_perm=True, masked=False)


def batch_seg_plans(batch) -> Dict[str, SegmentPlan]:
    """``{'rcv': plan of batch.receivers, 'snd': plan of batch.senders}``
    under the batch's edge mask, with one segment per node, on the batch's
    device.  For a receiver-sorted edge list the 'rcv' plan is the
    identity."""
    n = batch.num_nodes
    dev = batch.receivers.device
    return {key: build_segment_plan(idx, n, mask=batch.edge_mask, device=dev)
            for key, idx in (("rcv", batch.receivers), ("snd", batch.senders))}


def _check_cuda(data: torch.Tensor, rowptr: torch.Tensor,
                perm: Optional[torch.Tensor], what: str) -> None:
    if data.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{what}: data must be float32 or float64, got "
                         f"{data.dtype}")
    if data.ndim != 2:
        raise ValueError(f"{what}: data must be [E, D], got {tuple(data.shape)}")
    for name, t in (("rowptr", rowptr), ("perm", perm)):
        if t is None:
            continue
        if t.device != data.device:
            raise ValueError(f"{what}: the plan's {name} is on {t.device}, "
                             f"the data on {data.device}")
        if t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous int64")
    if perm is not None and perm.shape[0] != data.shape[0]:
        raise ValueError(f"{what}: the plan has {perm.shape[0]} edges, the "
                         f"data {data.shape[0]} rows")
    if data.shape[0] >= 2**31 or rowptr.shape[0] > 2**31:
        raise ValueError(f"{what}: E and N must be below 2**31")


LONG_ROWS = 1024        # rows per segment from which segments are chunked
CHUNK_BLOCKS = 264      # blocks the chunked path aims for (2 per SM)
MAX_CHUNKS = 64


def segment_chunks(rows: int, n: int) -> int:
    """Chunks per segment for ``rows`` rows in ``n`` segments: 0 (a warp or
    a thread per segment) unless the segments are few and long (``rows >=
    LONG_ROWS * n``: a pool of a whole box), then enough for ``n`` x chunks
    blocks to fill the card."""
    if n == 0 or rows < LONG_ROWS * n:
        return 0
    return max(1, min(MAX_CHUNKS, -(-CHUNK_BLOCKS // n)))


def launch_csr_segsum(data: torch.Tensor, perm: Optional[torch.Tensor],
                      rowptr: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the kernel on the current stream into ``out`` ``[N, D]``
    (``perm`` None: rows in place), with the scratch of the chunked path
    when the segments are few and long.  No checks and no count: the
    wrappers below and the timing code call it."""
    lib = _build.load("sorted_segsum")
    n, d = out.shape
    chunks = segment_chunks(data.shape[0], n)
    scratch = (torch.empty((n, chunks, d), dtype=data.dtype, device=data.device)
               if chunks else None)
    dev = data.device.index if data.device.index is not None else \
        torch.cuda.current_device()
    stream = torch.cuda.current_stream(data.device).cuda_stream
    fn = (lib.gmp_sorted_segsum if data.dtype == torch.float32
          else lib.gmp_sorted_segsum_f64)
    _build.check(lib, fn(
        dev, data.data_ptr(), None if perm is None else perm.data_ptr(),
        rowptr.data_ptr(), out.data_ptr(), n, d, chunks,
        None if scratch is None else scratch.data_ptr(), stream),
        "sorted segment sum")


def _sorted_segsum_cuda(data: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """K3 on the card: ``[num_segments, D]``."""
    data = data.contiguous()
    perm = None if plan.identity_perm else plan.perm
    _check_cuda(data, plan.rowptr, plan.perm, "sorted_segment_sum")
    out = torch.empty((plan.num_segments, data.shape[1]), dtype=data.dtype,
                      device=data.device)
    launch_csr_segsum(data, perm, plan.rowptr, out)
    sorted_segment_sum.launches += 1
    return out


def _masked(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x
    return torch.where(mask[:, None], x, x.new_zeros(()))


class SortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, plan, seg, mask):
        if data.device.type == "cpu":
            out = sorted_segment_sum_plain(data, seg, plan.num_segments, mask)
        elif data.device.type == "cuda":
            out = _sorted_segsum_cuda(data, plan)
        else:
            raise ValueError(f"sorted_segment_sum: unsupported device {data.device}")
        ctx.save_for_backward(seg, mask)
        return out

    @staticmethod
    def backward(ctx, g):
        seg, mask = ctx.saved_tensors
        return _masked(g[seg], mask), None, None, None


def sorted_segment_sum(data: torch.Tensor, plan: SegmentPlan,
                       seg: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked segment sum of ``data`` ``[E, D]`` into ``[plan.num_segments,
    D]``; differentiable in ``data`` (backward: the masked gather
    ``g[seg]``).  ``plan`` is ``build_segment_plan(seg, S, mask)``; ``seg``
    and ``mask`` are the original ids and mask.  On the card the plan alone
    decides which rows are summed (K3, one launch)."""
    return SortedSegmentSum.apply(data, plan, seg, mask)


sorted_segment_sum.launches = 0


def sorted_fold(data: torch.Tensor, segment_ids: torch.Tensor,
                plan: SegmentPlan,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The masked segment sum of ``data`` ``[T, D]`` over ascending
    ``segment_ids`` into ``[plan.num_segments, D]``, ``plan`` being
    ``ascending_plan(segment_ids, S)``: K3 on the card (one launch, masked
    rows zeroed first), the plain sum on the CPU; differentiable in
    ``data``."""
    return sorted_segment_sum(_masked(data, mask), plan, segment_ids, mask)


class SortedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, idx, plan, mask):
        if plan.num_segments != h.shape[0]:
            raise ValueError(f"sorted_gather: the plan has {plan.num_segments} "
                             f"segments, h {h.shape[0]} rows")
        if h.device.type == "cuda" and plan.rowptr.device != h.device:
            raise ValueError(f"sorted_gather: the plan is on "
                             f"{plan.rowptr.device}, h on {h.device}")
        ctx.save_for_backward(idx, mask)
        ctx.plan = plan
        return h[idx]

    @staticmethod
    def backward(ctx, g):
        idx, mask = ctx.saved_tensors
        plan = ctx.plan
        if g.device.type == "cpu":
            dh = sorted_segment_sum_plain(g, idx, plan.num_segments, mask)
        elif g.device.type == "cuda":
            # a plan built with the mask leaves masked-off rows out already
            dh = _sorted_segsum_cuda(g if plan.masked else _masked(g, mask),
                                     plan)
        else:
            raise ValueError(f"sorted_gather: unsupported device {g.device}")
        return dh, None, None, None


def sorted_gather(h: torch.Tensor, idx: torch.Tensor, plan: SegmentPlan,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h[idx]`` whose backward is the masked segment sum of the cotangent
    over ``idx``: K3 on the card, through ``plan`` (``build_segment_plan(idx,
    h.shape[0], mask)``)."""
    return SortedGather.apply(h, idx, plan, mask)


class SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, num_segments, mask):
        if data.device.type == "cpu":
            out = sorted_segment_sum_plain(data, segment_ids, num_segments, mask)
        elif data.device.type == "cuda":
            data = data.contiguous()
            live = (torch.ones_like(segment_ids, dtype=torch.bool)
                    if mask is None else mask)
            order, rowptr = receiver_csr(segment_ids, live, num_segments)
            _check_cuda(data, rowptr, order, "segment_sum")
            out = torch.empty((num_segments, data.shape[1]), dtype=data.dtype,
                              device=data.device)
            launch_csr_segsum(data, order, rowptr, out)
            segment_sum.launches += 1
        else:
            raise ValueError(f"segment_sum: unsupported device {data.device}")
        ctx.save_for_backward(segment_ids, mask)
        return out

    @staticmethod
    def backward(ctx, g):
        seg, mask = ctx.saved_tensors
        return _masked(g[seg], mask), None, None, None


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked segment sum over unsorted ids, ``[E, D] -> [num_segments,
    D]`` (the JAX package's ``segment_sum_pallas``); differentiable in
    ``data``.  On the card: a stable device sort of the masked-in ids into a
    CSR, then the kernel (K4, one launch); ids outside ``[0, num_segments)``
    are dropped there.  On the CPU: ``sorted_segment_sum_plain``."""
    return SegmentSum.apply(data, segment_ids, num_segments, mask)


segment_sum.launches = 0
