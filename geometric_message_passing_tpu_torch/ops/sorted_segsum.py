"""Sorted segment sums for the box-scale path (port of
``ops/pallas_sorted_segsum.py``), and the masked segment sum over unsorted
ids (port of ``ops/pallas_edge.py::segment_sum_pallas``).

Both reduce through one hand-written CUDA kernel, ``csrc/sorted_segsum.cu``:
``out[s] = acc[s] + the sum of segment s's live rows`` (``acc`` optional),
each segment's rows added in ascending order, in the data's type (f32, or
f64 for the float64 reference runs on the card), without atomics.

* ``build_segment_plan`` makes a CSR on the host, once per graph: a stable
  sort of the masked-in edges by segment id (masked-off edges sort last,
  outside every row) and the row pointers, moved to the device once.
  ``identity_perm`` marks a plan whose edges are already sorted (the
  receiver plan of a receiver-sorted graph): the kernel then reads the rows
  in place.  ``batch_seg_plans`` builds a batch's receiver and sender plans.
* ``ascending_plan`` builds the identity plan of ids that are already
  ascending on their own device (``searchsorted``: no sort, no host read):
  the triplet fold of DimeNet++ and SphereNet over ``idx_ji``
  (``sorted_fold``: the kernel skips the masked rows, which stay in the
  plan, and adds the previous chunks' accumulator), one K3 launch per fold
  and chunk.
* ``sorted_segment_sum`` (K3 forward; its backward is the masked gather
  ``g[seg]``) and ``sorted_gather`` (``h[idx]``, whose backward is K3 over
  the cotangent) are autograd functions; ``sorted_segment_sum.launches``
  counts their K3 launches.
* ``segment_sum`` (K4) takes the route ``segsum_route`` picks from the row
  and segment counts: up to ``SCAN_MAX_ROWS`` rows one launch that reads
  the ids and the mask itself (no plan, no sort); above it a stable device
  sort into a CSR (``ops.edge.receiver_csr``) and the CSR route.
  ``segment_sum.launches`` counts its calls.  ``ops.scatter.segment_sum``
  (every plain-route message sum, ``segment_mean``, the sum/mean pools and
  the embeddings' gradients) sends its CUDA tensors here.
* Inside the kernel a segment of at least ``LONG_SEG`` rows is split across
  a block, or across a cluster of ``cluster_size(rows)`` blocks
  (``long_segments``), and few segments of ``LONG_ROWS`` rows or more each
  are cut into chunks over many blocks (``segment_chunks``).

Tensors on the CPU take the plain version of the kernel,
``sorted_segment_sum_plain``: the masked ``index_add_`` sum of
``ops.scatter.segment_sum``, computed from the segment ids and the mask, not
from the plan.  CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

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
    segment; the kernel reads a mask beside it (``sorted_fold``)."""
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


def _check_cuda(data: torch.Tensor, rowptr: Optional[torch.Tensor],
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
    if data.shape[0] >= 2**31 or (rowptr is not None
                                  and rowptr.shape[0] > 2**31):
        raise ValueError(f"{what}: E and N must be below 2**31")


def _check_rows(data: torch.Tensor, t: Optional[torch.Tensor], name: str,
                what: str) -> None:
    """``t`` (None, or one entry per row of ``data``: ids or a mask) is 1-D
    with ``data.shape[0]`` entries on data's device: the kernels read
    ``t[r]`` for every row r as a raw pointer."""
    if t is None:
        return
    if t.ndim != 1 or t.shape[0] != data.shape[0]:
        raise ValueError(f"{what}: {name} must be [{data.shape[0]}] (one entry "
                         f"a row), got {tuple(t.shape)}")
    if t.device != data.device:
        raise ValueError(f"{what}: {name} is on {t.device}, the data on "
                         f"{data.device}")


LONG_ROWS = 1024        # rows per segment from which segments are chunked
CHUNK_BLOCKS = 264      # blocks the chunked path aims for (2 per SM)
MAX_CHUNKS = 64
LONG_SEG = 64           # rows from which one segment is split across a block
SCAN_MAX_ROWS = 24576   # K4 rows up to which the scan route runs (PERF.md)
SCAN_BLOCKS = 264       # blocks the scan route aims for (each reads all ids)
CLUSTER = 8             # blocks that split a long segment in a small call
CLUSTER_MAX_ROWS = 8192  # rows up to which a call runs in clusters (PERF.md)


def cluster_size(rows: int) -> int:
    """Blocks a cluster for ``rows`` rows: ``CLUSTER`` for the small calls
    (the star buckets), whose long segments would otherwise leave all but
    one SM idle; 1 above ``CLUSTER_MAX_ROWS``, where whole clusters wait
    for SMs and one block's warps split a long segment."""
    return CLUSTER if rows <= CLUSTER_MAX_ROWS else 1


def segment_chunks(rows: int, n: int) -> int:
    """Chunks per segment for ``rows`` rows in ``n`` segments: 0 (a lane
    group, or a block for a long segment) unless the segments are few and
    long (``rows >= LONG_ROWS * n``: a pool of a whole box), then enough for
    ``n`` x chunks blocks to fill the card."""
    if n == 0 or rows < LONG_ROWS * n:
        return 0
    return max(1, min(MAX_CHUNKS, -(-CHUNK_BLOCKS // n)))


def segsum_route(rows: int, n: int) -> Tuple[str, int]:
    """K4's route for ``rows`` ids into ``n`` segments: ``("scan", 0)``, one
    launch with no plan and no sort, up to ``SCAN_MAX_ROWS`` rows; else
    ``("csr", chunks)``, a device sort into a CSR and the kernel (chunked
    when the segments are few and long).  K3 always takes the CSR route
    over its plan."""
    chunks = segment_chunks(rows, n)
    if chunks == 0 and rows <= SCAN_MAX_ROWS:
        return "scan", 0
    return "csr", chunks


def long_segments(rowptr: torch.Tensor) -> torch.Tensor:
    """Which segments of a plan the kernel splits across a block (at least
    ``LONG_SEG`` rows); the others take one lane group each."""
    return rowptr.diff() >= LONG_SEG


_ENTRIES: Dict[tuple, tuple] = {}


def _entry(route: str, dtype: torch.dtype) -> tuple:
    """(library, C entry) of ``route`` for ``dtype``, looked up once."""
    key = (route, dtype)
    hit = _ENTRIES.get(key)
    if hit is None:
        lib = _build.load("sorted_segsum")
        suffix = "" if dtype == torch.float32 else "_f64"
        hit = _ENTRIES[key] = (lib, getattr(lib, f"gmp_segsum_{route}{suffix}"))
    return hit


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _mask_bytes(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A row mask as contiguous bytes (bool or uint8 as they are)."""
    if mask is None:
        return None
    if mask.dtype not in (torch.bool, torch.uint8):
        mask = mask != 0
    return mask.contiguous()


def launch_csr_segsum(data: torch.Tensor, perm: Optional[torch.Tensor],
                      rowptr: torch.Tensor, out: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      acc: Optional[torch.Tensor] = None) -> None:
    """Launch the CSR route on the current stream into ``out`` ``[N, D]``
    (``perm`` None: rows in place; ``mask``: rows to skip; ``acc``: added to
    each sum), with the scratch of the chunked path when the segments are
    few and long.  No checks and no count: the wrappers below and the
    timing code call it."""
    lib, fn = _entry("csr", data.dtype)
    n, d = out.shape
    chunks = segment_chunks(data.shape[0], n)
    scratch = (torch.empty((n, chunks, d), dtype=data.dtype, device=data.device)
               if chunks else None)
    dev = data.get_device()
    err = fn(dev, data.data_ptr(), _ptr(perm), rowptr.data_ptr(), _ptr(mask),
             _ptr(acc), out.data_ptr(), n, d, chunks, _ptr(scratch), LONG_SEG,
             cluster_size(data.shape[0]), torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _build.check(lib, err, "segment sum (CSR route)")


def launch_scan_segsum(data: torch.Tensor, ids: torch.Tensor,
                       mask: Optional[torch.Tensor], out: torch.Tensor) -> None:
    """Launch the scan route on the current stream into ``out`` ``[N, D]``:
    ``ids`` contiguous int32 or int64, ``mask`` contiguous bytes or None.
    No checks and no count."""
    lib, fn = _entry("scan", data.dtype)
    n, d = out.shape
    dev = data.get_device()
    err = fn(dev, data.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
             _ptr(mask), out.data_ptr(), data.shape[0], n, d,
             LONG_SEG, SCAN_BLOCKS, cluster_size(data.shape[0]),
             torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _build.check(lib, err, "segment sum (scan route)")


def _sorted_segsum_cuda(data: torch.Tensor, plan: SegmentPlan,
                        mask: Optional[torch.Tensor] = None,
                        acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 on the card: ``[num_segments, D]`` (``acc`` + the sums), rows
    whose ``mask`` is False skipped in the kernel."""
    data = data.contiguous()
    perm = None if plan.identity_perm else plan.perm
    _check_cuda(data, plan.rowptr, plan.perm, "sorted_segment_sum")
    _check_rows(data, mask, "mask", "sorted_segment_sum")
    out = torch.empty((plan.num_segments, data.shape[1]), dtype=data.dtype,
                      device=data.device)
    if acc is not None:
        acc = acc.contiguous()
        if acc.shape != out.shape or acc.dtype != out.dtype or \
                acc.device != out.device:
            raise ValueError(f"sorted_fold: acc must be {tuple(out.shape)} "
                             f"{out.dtype} on {out.device}")
    launch_csr_segsum(data, perm, plan.rowptr, out, _mask_bytes(mask), acc)
    sorted_segment_sum.launches += 1
    return out


def _masked(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x
    return torch.where(mask[:, None], x, x.new_zeros(()))


def _plan_mask(plan: SegmentPlan, mask: Optional[torch.Tensor]):
    """The mask the kernel must read: none when the plan left the masked-off
    rows out already."""
    return None if plan.masked else mask


class SortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, plan, seg, mask):
        if data.device.type == "cpu":
            out = sorted_segment_sum_plain(data, seg, plan.num_segments, mask)
        elif data.device.type == "cuda":
            out = _sorted_segsum_cuda(data, plan, _plan_mask(plan, mask))
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
    ``g[seg]``).  ``plan`` is ``build_segment_plan(seg, S, mask)`` (or a plan
    built without the mask, which the kernel then reads); ``seg`` and
    ``mask`` are the original ids and mask.  On the card: K3, one launch."""
    return SortedSegmentSum.apply(data, plan, seg, mask)


sorted_segment_sum.launches = 0


class SortedFold(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, acc, plan, seg, mask):
        if data.device.type == "cpu":
            out = sorted_segment_sum_plain(data, seg, plan.num_segments, mask)
            if acc is not None:
                out = acc + out
        elif data.device.type == "cuda":
            out = _sorted_segsum_cuda(data, plan, _plan_mask(plan, mask), acc)
        else:
            raise ValueError(f"sorted_fold: unsupported device {data.device}")
        ctx.save_for_backward(seg, mask)
        ctx.has_acc = acc is not None
        return out

    @staticmethod
    def backward(ctx, g):
        seg, mask = ctx.saved_tensors
        return (_masked(g[seg], mask), g if ctx.has_acc else None, None, None,
                None)


def sorted_fold(data: torch.Tensor, segment_ids: torch.Tensor,
                plan: SegmentPlan, mask: Optional[torch.Tensor] = None,
                acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc`` (optional, ``[plan.num_segments, D]``) plus the masked
    segment sum of ``data`` ``[T, D]`` over ascending ``segment_ids``,
    ``plan`` being ``ascending_plan(segment_ids, S)``: K3 on the card, one
    launch that skips the masked rows and adds ``acc`` (the same additions,
    in the same order, as ``acc + fold``); the plain sum on the CPU;
    differentiable in ``data`` and ``acc``."""
    return SortedFold.apply(data, acc, plan, segment_ids, mask)


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
            dh = _sorted_segsum_cuda(g, plan, _plan_mask(plan, mask))
        else:
            raise ValueError(f"sorted_gather: unsupported device {g.device}")
        return dh, None, None, None


def sorted_gather(h: torch.Tensor, idx: torch.Tensor, plan: SegmentPlan,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h[idx]`` whose backward is the masked segment sum of the cotangent
    over ``idx``: K3 on the card, through ``plan`` (``build_segment_plan(idx,
    h.shape[0], mask)``, or the plan without the mask, read then in the
    kernel)."""
    return SortedGather.apply(h, idx, plan, mask)


def _segment_sum_cuda(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int,
                      mask: Optional[torch.Tensor]) -> torch.Tensor:
    """K4 on the card, by ``segsum_route``: the scan route (one launch) or
    a stable device sort into a CSR and the CSR route."""
    data = data.contiguous()
    _check_cuda(data, None, None, "segment_sum")
    _check_rows(data, segment_ids, "segment_ids", "segment_sum")
    _check_rows(data, mask, "mask", "segment_sum")
    out = torch.empty((num_segments, data.shape[1]), dtype=data.dtype,
                      device=data.device)
    route, _ = segsum_route(data.shape[0], num_segments)
    if route == "scan":
        ids = segment_ids
        if ids.dtype not in (torch.int32, torch.int64):
            ids = ids.long()
        launch_scan_segsum(data, ids.contiguous(), _mask_bytes(mask), out)
    else:
        order, rowptr = receiver_csr(segment_ids, mask, num_segments)
        _check_cuda(data, rowptr, order, "segment_sum")
        launch_csr_segsum(data, order, rowptr, out)
    return out


class SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, num_segments, mask):
        if data.device.type == "cpu":
            out = sorted_segment_sum_plain(data, segment_ids, num_segments, mask)
        elif data.device.type == "cuda":
            out = _segment_sum_cuda(data, segment_ids, num_segments, mask)
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
    ``data``.  On the card: K4, by ``segsum_route`` one launch with no sort
    (up to ``SCAN_MAX_ROWS`` rows) or a stable device sort of the masked-in
    ids into a CSR and then the kernel; ids outside ``[0, num_segments)``
    are dropped either way.  On the CPU: ``sorted_segment_sum_plain``."""
    return SegmentSum.apply(data, segment_ids, num_segments, mask)


segment_sum.launches = 0
