"""Rank mesh and collectives over ``torch.distributed`` (port of
``parallel/mesh.py``).

The JAX package names the axes of a ``jax.sharding.Mesh`` of devices and
lets XLA insert the collectives inside ``shard_map``.  Here every rank is
one process with one device.  A ``Mesh`` lays the ranks of an initialised
process group out on a grid with named axes and holds one process group
per axis (the ranks that differ only in that axis's coordinate), so
``collectives`` can reduce over ``"dp"`` alone, as ``jax.lax.psum(x,
"dp")`` does:

    init_distributed(backend="gloo")          # or launch.spawn(...)
    mesh = make_mesh((world,), ("dp",))
    g = collectives.all_reduce_sum(mesh, g, "dp")

``collectives`` move values and are not differentiated; ``differentiable``
holds the collectives used inside a model's forward (tensor, pipeline and
graph parallelism), each with the JAX transpose as its backward.

Backends.  NCCL needs one GPU per rank: it refuses two ranks on one
device ("Duplicate GPU detected"), so ``init_distributed`` raises before it
starts a group that would put two NCCL ranks on one GPU.  Ranks that share
a GPU use gloo, which takes CUDA tensors in every collective used here
(``experiments/probe_backends.py`` checks each on the card); any copy to
the host is gloo's own.

A rank's device is ``cuda:(local_rank % device_count)`` unless the caller
passes ``device="cpu"``; there is no silent CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

DEFAULT_TIMEOUT_S = 300


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value is None else int(value)


def rank_device(device=None, rank: Optional[int] = None) -> torch.device:
    """This rank's device: ``device`` if given, else ``cuda:(local_rank %
    device_count)``, the local rank from ``LOCAL_RANK`` or ``rank`` (raises
    without CUDA)."""
    if device is not None:
        return resolve_device(device)
    resolve_device("cuda")
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    local = _env_int("LOCAL_RANK", rank)
    return torch.device("cuda", local % torch.cuda.device_count())


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Initialise the default process group once; returns this rank.

    ``rank`` / ``world_size`` default to the ``RANK`` / ``WORLD_SIZE``
    environment (``torchrun`` sets them, with ``MASTER_ADDR`` /
    ``MASTER_PORT``), else to a world of 1, which needs no rendezvous (an
    in-process store).  ``backend`` defaults to NCCL on a CUDA device and
    gloo on the CPU.  NCCL with more ranks on this host
    (``LOCAL_WORLD_SIZE``, else the world) than GPUs raises ``ValueError``
    before any group starts.  On a CUDA device the rank's GPU becomes the
    current one."""
    if dist.is_initialized():
        return dist.get_rank()
    rank = _env_int("RANK", 0) if rank is None else rank
    world = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    dev = rank_device(device, rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("NCCL needs a CUDA device per rank")
        local_world = _env_int("LOCAL_WORLD_SIZE", world)
        if local_world > torch.cuda.device_count():
            raise ValueError(
                f"NCCL needs one GPU per rank: {local_world} ranks on this "
                f"host, {torch.cuda.device_count()} GPU(s); use gloo for "
                "ranks that share a GPU")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    if init_method is None and "MASTER_ADDR" not in os.environ:
        if world != 1:
            raise ValueError(f"a world of {world} needs init_method or the "
                             "MASTER_ADDR / MASTER_PORT environment")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world, timeout=timeout)
    return rank


class Mesh:
    """The ranks of the default process group on a named grid.

    ``ranks[i, j, ...]`` is the global rank at those coordinates,
    ``shape[axis]`` an axis's size, ``coords[axis]`` this rank's coordinate,
    ``device`` this rank's device.  Built by ``make_mesh`` and the other
    constructors below, which every rank calls alike."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 device: torch.device, groups: Dict[str, object]):
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.size = int(ranks.size)
        self.rank = dist.get_rank()
        where = np.argwhere(ranks == self.rank)[0]
        self.coords = dict(zip(self.axis_names, (int(c) for c in where)))
        self.device = device
        self.backend = str(dist.get_backend())
        self._groups = groups

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (None for
        an axis of size 1 that is not the whole world: nothing to do)."""
        return self._groups[axis]

    def barrier(self) -> None:
        dist.barrier()


def _axis_groups(ranks: np.ndarray, axis_names: Sequence[str],
                 timeout_s: float) -> Dict[str, object]:
    """One group per axis line, made by every rank for every line in the
    same order (``dist.new_group`` hangs otherwise); returns this rank's."""
    me, world = dist.get_rank(), dist.get_world_size()
    timeout = datetime.timedelta(seconds=timeout_s)
    groups = {}
    for k, name in enumerate(axis_names):
        lines = np.moveaxis(ranks, k, -1).reshape(-1, ranks.shape[k])
        for line in lines:
            members = [int(r) for r in line]
            if len(members) == world:
                group = dist.group.WORLD
            elif len(members) == 1:
                group = None
            else:
                group = dist.new_group(members, timeout=timeout)
            if me in members:
                groups[name] = group
    return groups


def _mesh_from_ranks(ranks: np.ndarray, axis_names: Sequence[str], device,
                     timeout_s: float) -> Mesh:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed (or run "
                           "under launch.spawn / torchrun) first")
    if len(axis_names) != ranks.ndim:
        raise ValueError(f"{len(axis_names)} axis names for a "
                         f"{ranks.ndim}-d mesh")
    if ranks.size != dist.get_world_size():
        raise ValueError(f"a mesh of shape {ranks.shape} needs "
                         f"{ranks.size} ranks, the world has "
                         f"{dist.get_world_size()}")
    dev = rank_device(device)
    groups = _axis_groups(ranks, axis_names, timeout_s)
    return Mesh(ranks, axis_names, dev, groups)


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("dp",), device=None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """A mesh over every rank, in rank order.  Default: one ``dp`` axis
    over the world (other axes of size 1)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    return _mesh_from_ranks(ranks, axis_names, device, timeout_s)


def solo_mesh(axis_names: Sequence[str] = ("dp",), device=None) -> Mesh:
    """A mesh of this rank alone, every axis of size 1 (each collective
    the identity), inside a larger world: where a rank runs the
    single-rank twin of a parallel program itself."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed (or run "
                           "under launch.spawn / torchrun) first")
    ranks = np.full((1,) * len(axis_names), dist.get_rank())
    return Mesh(ranks, axis_names, rank_device(device),
                {name: None for name in axis_names})


def hybrid_rank_grid(ici_shape: Tuple[int, ...],
                     dcn_shape: Tuple[int, ...]) -> np.ndarray:
    """The JAX package's hybrid layout on ranks: ``prod(dcn_shape)``
    contiguous blocks of ``prod(ici_shape)`` ranks (one host's ranks each,
    as ``torchrun`` numbers them), axis k of size ``dcn[k] * ici[k]`` with
    the block index major."""
    if len(ici_shape) != len(dcn_shape):
        raise ValueError(f"rank mismatch: {ici_shape} vs {dcn_shape}")
    need = int(np.prod(ici_shape)) * int(np.prod(dcn_shape))
    arr = np.arange(need).reshape(tuple(dcn_shape) + tuple(ici_shape))
    n = len(ici_shape)
    perm = [a for k in range(n) for a in (k, n + k)]
    return arr.transpose(perm).reshape(
        tuple(d * i for d, i in zip(dcn_shape, ici_shape)))


def make_hybrid_mesh(ici_shape: Tuple[int, ...], dcn_shape: Tuple[int, ...],
                     axis_names: Sequence[str], device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """A mesh spanning hosts: axis i has ``ici_shape[i] * dcn_shape[i]``
    ranks, the host (the slow link) major.  Put data parallelism on the
    axis that crosses hosts and the communication-heavy strategies on
    axes inside one host.  Example, 2 hosts of 4 GPUs, dp across hosts:
    ``make_hybrid_mesh((1, 4), (2, 1), ("dp", "gp"))`` gives the grid
    ``[[0, 1, 2, 3], [4, 5, 6, 7]]``."""
    return _mesh_from_ranks(hybrid_rank_grid(ici_shape, dcn_shape),
                            axis_names, device, timeout_s)


def make_multihost_mesh(axis_names: Sequence[str] = ("dp",),
                        ici_shape: Optional[Tuple[int, ...]] = None,
                        dcn_shape: Optional[Tuple[int, ...]] = None,
                        device=None) -> Mesh:
    """``init_distributed()`` and the default hybrid layout: the leading
    axis spans hosts (``WORLD_SIZE / LOCAL_WORLD_SIZE`` of them), the last
    holds one host's ranks, the others are 1.  In one process outside a
    launcher this is a world-1 mesh, every axis of size 1."""
    init_distributed(device=device)
    world = dist.get_world_size()
    nlocal = _env_int("LOCAL_WORLD_SIZE", world)
    nhost = world // nlocal
    n_axes = len(axis_names)
    if ici_shape is None:
        ici_shape = (1,) * (n_axes - 1) + (nlocal,)
    if dcn_shape is None:
        dcn_shape = (nhost,) + (1,) * (n_axes - 1)
    if nhost == 1:
        shape = tuple(i * d for i, d in zip(ici_shape, dcn_shape))
        return make_mesh(shape, axis_names, device)
    return make_hybrid_mesh(ici_shape, dcn_shape, axis_names, device)


def process_local_slice(n: int, process_index: Optional[int] = None,
                        process_count: Optional[int] = None) -> slice:
    """This rank's contiguous rows of a length-``n`` global batch axis (each
    rank is a process here): blocks in rank order.  ``n`` must divide by
    the count (pad the batch first), else ``ValueError``."""
    initialised = dist.is_initialized()
    p = process_index if process_index is not None else (
        dist.get_rank() if initialised else 0)
    count = process_count if process_count is not None else (
        dist.get_world_size() if initialised else 1)
    if n % count:
        raise ValueError(
            f"global batch length {n} must be divisible by process_count "
            f"{count}; pad the batch (mask rows) to a multiple first")
    per = n // count
    return slice(p * per, (p + 1) * per)


def global_batch_from_local(mesh: Mesh, local_batch, axis: str = "dp"):
    """This rank's part of the global batch, ``local_batch`` (its
    ``process_local_slice`` rows, numpy arrays in a dict, list or tuple),
    as tensors on the rank's device.  No rank sends anything: the global
    batch is the ranks' parts in ``axis`` order, as
    ``collectives.all_gather(..., tiled=True)`` would assemble it."""
    del axis    # the rows are this rank's whatever the axis
    if isinstance(local_batch, dict):
        return {k: global_batch_from_local(mesh, v)
                for k, v in local_batch.items()}
    if isinstance(local_batch, (list, tuple)):
        return type(local_batch)(global_batch_from_local(mesh, v)
                                 for v in local_batch)
    return torch.as_tensor(np.asarray(local_batch)).to(mesh.device)


class collectives:
    """Named-axis collectives over a ``Mesh`` (the JAX package's
    ``jax.lax`` wrappers).  Each returns a new tensor and leaves its input
    alone; on an axis of size 1 each is the identity."""

    @staticmethod
    def all_reduce_sum(mesh: Mesh, x: torch.Tensor,
                       axis: str = "dp") -> torch.Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        group = mesh.group(axis)
        if group is not None:
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def all_reduce_mean(mesh: Mesh, x: torch.Tensor,
                        axis: str = "dp") -> torch.Tensor:
        return collectives.all_reduce_sum(mesh, x, axis) / mesh.shape[axis]

    @staticmethod
    def all_gather(mesh: Mesh, x: torch.Tensor, axis: str = "dp",
                   tiled: bool = False) -> torch.Tensor:
        """Every rank's ``x`` in axis order: stacked on a new leading axis,
        or with ``tiled`` concatenated along axis 0 (a bool tensor moves as
        bytes)."""
        group = mesh.group(axis)
        if group is None:
            return x.clone() if tiled else x[None].clone()
        src = x.contiguous()
        if src.dtype == torch.bool:     # moved as bytes
            src = src.view(torch.uint8)
        parts = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts) if tiled else torch.stack(parts)
        return out.view(torch.bool) if x.dtype == torch.bool else out

    @staticmethod
    def reduce_scatter_sum(mesh: Mesh, x: torch.Tensor,
                           axis: str = "dp") -> torch.Tensor:
        """``jax.lax.psum_scatter(x, axis, tiled=True)``: the sum over the
        axis of ``x``, cut along axis 0 into as many blocks as ranks; this
        rank keeps block ``coords[axis]``."""
        n = mesh.shape[axis]
        if x.shape[0] % n:
            raise ValueError(f"axis 0 of size {x.shape[0]} does not split "
                             f"into {n} blocks")
        group = mesh.group(axis)
        if group is None:
            return x.clone()
        src = x.contiguous()
        out = src.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                   group=group)
        return out

    @staticmethod
    def all_to_all(mesh: Mesh, x: torch.Tensor, axis: str = "dp",
                   split_axis: int = 0, concat_axis: int = 0) -> torch.Tensor:
        """``jax.lax.all_to_all`` (untiled): ``x.shape[split_axis]`` equals
        the axis size; entry i along it goes to rank i, and the entries
        received, in rank order, form a new axis at ``concat_axis`` (the
        split axis removed)."""
        n = mesh.shape[axis]
        if x.shape[split_axis] != n:
            raise ValueError(f"all_to_all needs x.shape[{split_axis}] == {n}, "
                             f"the size of axis {axis!r}; got "
                             f"{x.shape[split_axis]}")
        src = torch.movedim(x, split_axis, 0).contiguous()
        group = mesh.group(axis)
        if group is None:
            return torch.movedim(src.clone(), 0, concat_axis)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
        return torch.movedim(out, 0, concat_axis)

    @staticmethod
    def ppermute(mesh: Mesh, x: torch.Tensor, perm, axis: str = "dp"
                 ) -> torch.Tensor:
        """``jax.lax.ppermute``: for each (source, destination) pair of axis
        indices in ``perm``, the destination receives the source's ``x``;
        a rank that no pair names receives zeros.  One all-gather: gloo's
        point-to-point sends abort the process on a CUDA tensor
        (``experiments/probe_backends.py``), and ranks that share a card
        run on gloo."""
        sources = {dst: src for src, dst in perm}
        gathered = collectives.all_gather(mesh, x, axis)
        src = sources.get(mesh.coords[axis])
        return torch.zeros_like(x) if src is None else gathered[src].clone()

    @staticmethod
    def axis_index(mesh: Mesh, axis: str = "dp") -> int:
        return mesh.coords[axis]

    @staticmethod
    def fold_in_axes(mesh: Mesh, key, *axes: str) -> tuple:
        """``key`` (an int or a tuple of ints) with this rank's index along
        each of ``axes`` appended: a per-rank seed, so dropout masks differ
        across shards (``seed_from_key`` turns it into one integer)."""
        key = tuple(key) if isinstance(key, (tuple, list)) else (int(key),)
        return key + tuple(mesh.coords[a] for a in axes)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return collectives.all_reduce_sum(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        return collectives.all_reduce_sum(ctx.mesh, g, ctx.axis), None, None


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return collectives.all_reduce_sum(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collectives.all_reduce_sum(ctx.mesh, g, ctx.axis), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, perm, axis):
        ctx.mesh, ctx.perm, ctx.axis = mesh, perm, axis
        return collectives.ppermute(mesh, x, perm, axis)

    @staticmethod
    def backward(ctx, g):
        inverse = [(dst, src) for src, dst in ctx.perm]
        return (collectives.ppermute(ctx.mesh, g, inverse, ctx.axis), None,
                None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return collectives.all_to_all(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        return collectives.all_to_all(ctx.mesh, g, ctx.axis), None, None


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return collectives.all_gather(mesh, x, axis, tiled=True)

    @staticmethod
    def backward(ctx, g):
        return (collectives.reduce_scatter_sum(ctx.mesh, g, ctx.axis), None,
                None)


class _ReduceScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return collectives.reduce_scatter_sum(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        return (collectives.all_gather(ctx.mesh, g, ctx.axis, tiled=True),
                None, None)


class differentiable:
    """Collectives inside a function that autograd differentiates, each a
    ``torch.autograd.Function`` whose backward is the JAX transpose of the
    forward, over the axis's process group of ``mesh``.

    Every rank must run every backward collective in the same order, as
    the forwards: each rank builds the same graph, and the output of each
    collective must reach the loss on every rank (through ``torch.where``
    where a rank does not need the value), or autograd skips its backward
    on that rank while the others wait in theirs."""

    @staticmethod
    def psum(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``jax.lax.psum``: the sum over the axis; backward the sum of the
        cotangents over the axis (psum's transpose).  Tensor parallelism
        relies on it: after a psum each rank keeps its own channels, so its
        cotangent is nonzero on those only, and only the sum rebuilds the
        cotangent of the partial product (Megatron's identity would not)."""
        return _AllReduceSum.apply(x, mesh, axis)

    @staticmethod
    def psum_replicated(mesh: Mesh, x: torch.Tensor,
                        axis: str) -> torch.Tensor:
        """The sum over the axis, whose result every rank then
        differentiates alike (a loss of a replicated output): backward
        passes this rank's cotangent through, since summing the ranks'
        equal cotangents would count the one loss once per rank."""
        return _SumForward.apply(x, mesh, axis)

    @staticmethod
    def replicated(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The identity on a tensor every rank holds alike and uses in
        part (JAX's unmapped ``shard_map`` input); backward the sum of the
        cotangents over the axis, so every rank gets the whole gradient."""
        return _SumBackward.apply(x, mesh, axis)

    @staticmethod
    def ppermute(mesh: Mesh, x: torch.Tensor, perm,
                 axis: str) -> torch.Tensor:
        """``collectives.ppermute``; backward the ppermute of the
        cotangents along the inverse pairs."""
        return _PPermute.apply(x, mesh, perm, axis)

    @staticmethod
    def all_to_all(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``collectives.all_to_all`` on axis 0 (untiled: ``x.shape[0]``
        is the axis size); its transpose is itself, so the backward sends
        each block of cotangents back to the rank it came from."""
        return _AllToAll.apply(x, mesh, axis)

    @staticmethod
    def all_gather(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``collectives.all_gather(..., tiled=True)``; backward the
        reduce-scatter (sum) of the cotangents, each rank keeping its
        block."""
        return _AllGatherTiled.apply(x, mesh, axis)

    @staticmethod
    def reduce_scatter_sum(mesh: Mesh, x: torch.Tensor,
                           axis: str) -> torch.Tensor:
        """``collectives.reduce_scatter_sum``; backward the tiled all-gather
        of the cotangents."""
        return _ReduceScatterSum.apply(x, mesh, axis)


def seed_from_key(key) -> int:
    """One 62-bit seed from a tuple of ints (``numpy``'s ``SeedSequence``)."""
    key = list(key) if isinstance(key, (tuple, list)) else [int(key)]
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
               >> np.uint64(2))
