"""Build the hand-written CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into a shared library at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build dir>/<name>-<hash>.so csrc/<name>.cu

The build directory is ``.gmp_torch_build/`` beside the package (listed in
``.gitignore``).  A library's file name carries a hash of its source and
flags (and of the shared headers ``csrc/*.cuh``), so an edited source is
rebuilt and a stale library is never loaded.  ``build_all`` starts one
``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / ".gmp_torch_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argtypes of every C entry point, by library; every pointer (and the
# stream) is c_void_p so ctypes does not cut it to 32 bits
SIGNATURES: Dict[str, Dict[str, list]] = {
    "egnn_message": {
        # indices, features, weights, msg_e, pos_e, E, D, tile, clusters,
        # stamps, stream
        "gmp_egnn_edges": [I, P, P, I, P, P, P, P, P, P, I, I, I, I, P, P],
        "gmp_egnn_reduce": [I, P, P, P, P, P, P, P, I, I, P],
        "gmp_egnn_resident_plan": [I, I, I, P],          # D, E, clusters, out
        "gmp_egnn_resident_clusters": [I, I, I, I, P],   # device, D, tile, idx64, out
    },
    "egnn_ring_probe": {
        # indices, features, weights, msg_e, pos_e, stamps, probe block, E,
        # D, stream
        "gmp_egnn_ring_probe": [I, P, P, I, P, P, P, P, P, P, P, I, I, I, P],
    },
    "egnn_message_bwd": {
        # indices, features, weights, cotangents (2), CSRs (4), scratch and
        # outputs (10), N, E, D, split, tile, stream
        "gmp_egnn_bwd": [I, P, P, I, *[P] * 10, *[P] * 10, *[I] * 5, P],
        "gmp_egnn_tile_smem": [I, I],   # tile, D
    },
    "sorted_segsum": {
        # data, perm, rowptr, mask, acc, out, N, D, G, scratch, long rows,
        # cluster, stream
        "gmp_segsum_csr": [I, P, P, P, P, P, P, I, I, I, P, I, I, P],
        "gmp_segsum_csr_f64": [I, P, P, P, P, P, P, I, I, I, P, I, I, P],
        # data, ids, ids int64?, mask, out, E, N, D, long rows, blocks,
        # cluster, stream
        "gmp_segsum_scan": [I, P, P, I, P, P, L, I, I, I, I, I, P],
        "gmp_segsum_scan_f64": [I, P, P, I, P, P, L, I, I, I, I, I, P],
    },
    "gvp_message": {
        # features (8), weights, dims, 7 ints, CSR (2), scratch, outputs
        # (5), tile, stream
        "gmp_gvp_fwd": [I, P, P, I, P, *[P] * 8, P, P, *[I] * 7, P, P, P,
                        *[P] * 5, I, P],
        "gmp_gvp_fwd_smem": [P, I, I],   # dims, L, tile
    },
    "gvp_message_bwd": {
        # features (8), weights, dims, 7 ints, cotangents (4), CSRs (4),
        # scratch (4), node and edge cotangents (4 + 4), dW, split, tile,
        # stream
        "gmp_gvp_bwd": [I, P, P, I, P, *[P] * 8, P, P, *[I] * 7, *[P] * 4,
                        *[P] * 4, *[P] * 4, *[P] * 4, *[P] * 4, P, I, I, P],
        "gmp_gvp_ops_width": [P, I],
        "gmp_gvp_bwd_smem": [P, I, I],   # dims, L, tile
    },
    "egnn_stack": {
        # indices, features, weights, CSR (2), scratch (2), outputs (2),
        # barrier, phase stamps, N, E, D, L, tile, stream
        "gmp_egnn_stack_fwd": [I, P, P, I, *[P] * 12, *[I] * 5, P],
    },
    "egnn_stack_bwd": {
        # indices, features, weights, cotangents (2), CSRs (4), scratch and
        # outputs (21), barrier, phase stamps, N, E, D, L, split, tile, stream
        "gmp_egnn_stack_bwd": [I, P, P, I, *[P] * 10, *[P] * 23, *[I] * 6, P],
    },
    "edge_contract": {
        # one group: T, W, out, E, K, m, w, stream
        "gmp_contract_fwd": [I, P, P, P, I, I, I, I, P],
        "gmp_contract_fwd_bf16": [I, P, P, P, I, I, I, I, P],
        # T, W, dO, dT, dW, E, K, m, w, stream
        "gmp_contract_bwd": [I, P, P, P, P, P, I, I, I, I, P],
        "gmp_contract_bwd_bf16": [I, P, P, P, P, P, I, I, I, I, P],
        # all groups in one launch: backward?, groups, pointer table, shape table, items, shared
        # bytes, ring slot bytes, float offset, T and dO buffer floats, bf16
        # W, W values per load, largest m, stream
        "gmp_contract_grouped": [I, I, I, P, P, I, I, I, I, I, I, I, I, I, P],
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME); the CUDA kernels "
                       "of geometric_message_passing_tpu_torch cannot be built")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (target, process or None, temporary output)."""
    target = _target(name)
    if target.exists():
        return target, None, None
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, proc, tmp


def _finish(name: str, target: Path, proc, tmp: Path) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)  # atomic: a reader never sees half a library


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> None:
    """Compile every named kernel source that is not built yet, one nvcc
    process per source, all running together."""
    with _lock:
        started = [(n, *_start(n)) for n in names]
        errors = []
        for name, target, proc, tmp in started:
            try:
                _finish(name, target, proc, tmp)
            except RuntimeError as exc:
                errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.gmp_error_string.argtypes = [ctypes.c_int]
            lib.gmp_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return _loaded[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point of ``lib`` returned a CUDA error code."""
    if err != 0:
        msg = lib.gmp_error_string(err).decode()
        raise RuntimeError(f"{what} failed: cudaError_t {err} ({msg})")
