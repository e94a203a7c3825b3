"""Build the hand-written CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into a shared library at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build dir>/<name>-<hash>.so csrc/<name>.cu

The build directory is ``.gmp_torch_build/`` beside the package (listed in
``.gitignore``).  A library's file name carries a hash of its source and
flags, so an edited source is rebuilt and a stale library is never loaded.  ``build_all`` starts one ``nvcc`` per
source, all at once.
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

P, I = ctypes.c_void_p, ctypes.c_int
# argtypes of every C entry point, by library; every pointer (and the
# stream) is c_void_p so ctypes does not cut it to 32 bits
SIGNATURES: Dict[str, Dict[str, list]] = {
    "egnn_message": {
        "gmp_egnn_edges": [I, P, P, I, P, P, P, P, P, P, I, I, P],
        "gmp_egnn_reduce": [I, P, P, P, P, P, P, P, I, I, P],
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
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
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
