"""Build the host C++ graph code in ``csrc/host/`` and load it with ctypes.

``batcher.cpp`` (the epoch batcher of ``GraphLoader.stage_epochs``),
``radius.cpp`` (``ops.radius_graph.radius_graph``) and ``triplets.cpp``
(``triplets.build_triplets``) keep the JAX package's C interface.  They
are compiled together at first use:

    g++ -O3 -ffp-contract=off -shared -fPIC -o <build dir>/libgmphost-<hash>.so \
        csrc/host/batcher.cpp csrc/host/radius.cpp csrc/host/triplets.cpp

into ``.gmp_torch_build/`` beside the package (git-ignored), the kernels'
build directory.  The file name carries a hash of the sources and flags,
so an edited source is rebuilt.  Processes that build at once (test
workers) take an exclusive ``fcntl`` lock on ``host.lock`` in that
directory; the one holding it compiles into a temporary file and renames it
into place (atomic), the others find the library when they get the lock.
A failed build raises: there is no numpy fallback behind this code.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

from ._build import BUILD_DIR, CSRC

HOST_SRC = CSRC / "host"
SOURCES = ("batcher.cpp", "radius.cpp", "triplets.cpp")
GXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def target(build_dir: Path = BUILD_DIR) -> Path:
    """The library's path: its name carries a hash of sources and flags."""
    digest = hashlib.sha256(b"".join((HOST_SRC / s).read_bytes()
                                     for s in SOURCES)
                            + " ".join(GXX_FLAGS).encode())
    return Path(build_dir) / f"libgmphost-{digest.hexdigest()[:16]}.so"


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no C++ compiler (g++, c++ or $CXX) on PATH: the host "
                       "graph code of csrc/host cannot be built")


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the host library into ``build_dir`` unless it is there;
    returns its path."""
    out = target(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # released when the file closes
        if out.exists():                      # another process built it
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_compiler(), *GXX_FLAGS, "-o", str(tmp),
               *(str(HOST_SRC / s) for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"the host graph code failed to compile (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)     # atomic: a reader never sees half a library
    return out


def load() -> ctypes.CDLL:
    """The host library, built on first use, its entry points typed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I32 = ctypes.c_void_p, ctypes.c_int32
            lib.gmp_build_batches.restype = None
            lib.gmp_build_batches.argtypes = (
                [P] * 5 + [I32] + [P] * 5 + [I32] + [I32] * 4 + [P] * 10)
            lib.gmp_count_triplets.restype = None
            lib.gmp_count_triplets.argtypes = [P, P, I32, I32, I32, P]
            lib.gmp_fill_triplets.restype = None
            lib.gmp_fill_triplets.argtypes = [P, P, I32, I32, I32] + [P] * 7
            lib.gmp_radius_graph.restype = ctypes.c_long
            lib.gmp_radius_graph.argtypes = [
                P, ctypes.c_long, ctypes.c_long, ctypes.c_double, P,
                ctypes.c_int, ctypes.c_long, P, P, ctypes.c_long]
            _lib = lib
        return _lib
