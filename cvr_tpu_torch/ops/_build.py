"""Build and load the Hopper kernels of cvr_tpu_torch/csrc/.

``nvcc`` compiles the sources for ``sm_90a`` into a shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), which
ctypes loads.  The library goes into ``cvr_tpu_torch/_build/`` under a name
keyed by the sources' hash, at first use; nothing is built on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "route_kernels.cu",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIB = None
# what the last build printed (ptxas registers / spills per kernel) and
# how long it took; None when the library was already built
build_log: str | None = None
build_seconds: float | None = None


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the kernels need it")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcvr_route_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if their library is missing; return its path."""
    global build_log, build_seconds
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
        capture_output=True,
        text=True,
        timeout=600,
    )
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, so)
    return so


def load():
    """The loaded kernel library (built at first call), argtypes set."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.cvr_expand.argtypes = [p, p, p, p, p, p, i64, i64, i64, i32, p]
    lib.cvr_route_middle.argtypes = [p, p, p, p, i64, i32, p]
    lib.cvr_reduce_slices.argtypes = [
        p, p, p, p, p, p, p, p, p, i64, i64, i64, i64, p,
    ]
    lib.cvr_route_small.argtypes = [p, p, p, p, p, i64, p]
    lib.cvr_tileperm.argtypes = [p, p, p, i64, p]
    lib.cvr_route_m3.argtypes = [p, p, p, i64, p]
    lib.cvr_reduce_hot.argtypes = [p, p, p, p, p, p, p, i64, i64, i64, i64, p]
    for fn in (
        lib.cvr_expand, lib.cvr_route_middle, lib.cvr_reduce_slices,
        lib.cvr_route_small, lib.cvr_tileperm, lib.cvr_route_m3,
        lib.cvr_reduce_hot,
    ):
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib
