"""Start a group of ranks on this host and collect what each returns.

    results = spawn(fn, world=2, backend="gloo", device="cuda",
                    args=(path,))

starts ``world`` processes with the ``spawn`` start method.  Each sets
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``, takes one
CPU thread, joins the default process group through a ``file://``
rendezvous (``init_file``, or a fresh file under the temporary directory)
by ``mesh.init_distributed``, runs ``fn(*args)`` and sends its result back
(pickled, so return numpy arrays and plain values).  ``fn`` is pickled by
its import path: a module-level function of a module that imports no JAX.

A rank that raises, dies or outlives ``timeout_s`` fails the whole launch
with ``RuntimeError`` (its traceback in the message) and the other ranks
are stopped.  On CUDA the kernels are built here, in the parent, before
any rank starts (``ops._build.build_all``), so no two ranks run ``nvcc``;
each rank loads them from the build directory.  NCCL with more ranks than
GPUs raises ``ValueError`` before any process starts: ranks that share a
GPU use gloo.

``torchrun`` (with ``--nproc-per-node`` and a script that calls
``init_distributed`` and ``make_mesh``) starts the same ranks from a shell.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import DEFAULT_TIMEOUT_S, init_distributed


def _rank_main(fn: Callable, rank: int, world: int, backend: str, device,
               init_method: str, args: Sequence, conn,
               timeout_s: float) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    try:
        init_distributed(backend, init_method, rank, world, device,
                         timeout_s=timeout_s)
        conn.send(("ok", fn(*args)))
    except Exception:      # the boundary: report, the parent raises
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: str = "gloo", device=None,
          init_file: Optional[str] = None, args: Sequence = (),
          timeout_s: float = DEFAULT_TIMEOUT_S) -> List:
    """Run ``fn(*args)`` on ``world`` ranks; returns their results in rank
    order.  ``device`` is each rank's (``"cpu"``, or None for
    ``cuda:rank % device_count``)."""
    on_cuda = device is None or torch.device(device).type == "cuda"
    if on_cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("spawn on CUDA needs a CUDA card; pass "
                               "device='cpu' for CPU ranks")
        if backend == "nccl" and world > torch.cuda.device_count():
            raise ValueError(
                f"NCCL needs one GPU per rank: {world} ranks, "
                f"{torch.cuda.device_count()} GPU(s); use gloo for ranks "
                "that share a GPU")
        from ..ops import _build

        _build.build_all()
    elif backend == "nccl":
        raise ValueError("NCCL needs CUDA ranks")
    tmp = None
    if init_file is None:
        tmp = tempfile.TemporaryDirectory(prefix="gmp_rdzv_")
        init_file = os.path.join(tmp.name, "rendezvous")
    ctx = mp.get_context("spawn")
    procs, conns = [], []
    try:
        for rank in range(world):
            parent, child = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                fn, rank, world, backend, device,
                f"file://{os.path.abspath(init_file)}", tuple(args), child,
                timeout_s))
            p.start()
            child.close()
            procs.append(p)
            conns.append(parent)
        return _collect(procs, conns, timeout_s)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
        for c in conns:
            c.close()
        if tmp is not None:
            tmp.cleanup()


def _collect(procs, conns, timeout_s: float) -> List:
    """Each rank's result; raises on the first rank that fails, dies or
    runs past the deadline."""
    results: dict = {}
    deadline = time.monotonic() + timeout_s
    waiting = dict(enumerate(conns))
    while waiting:
        left = deadline - time.monotonic()
        if left <= 0:
            raise RuntimeError(f"ranks {sorted(waiting)} did not finish "
                               f"within {timeout_s:.0f} s")
        ready = wait(list(waiting.values())
                     + [procs[r].sentinel for r in waiting], timeout=left)
        for rank, conn in list(waiting.items()):
            if conn in ready:
                try:
                    status, value = conn.recv()
                except EOFError:
                    raise RuntimeError(f"rank {rank} died (exit code "
                                       f"{procs[rank].exitcode})") from None
                if status != "ok":
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                results[rank] = value
                del waiting[rank]
            elif procs[rank].sentinel in ready and not conn.poll():
                procs[rank].join(timeout=1)
                raise RuntimeError(f"rank {rank} died (exit code "
                                   f"{procs[rank].exitcode}) without a "
                                   "result")
    return [results[r] for r in range(len(procs))]
