"""Build and load the Hopper kernels of cvr_tpu_torch/csrc/.

``nvcc`` compiles each source for ``sm_90a`` into an object, all sources
at once in parallel, and links them into one shared library with a plain
C interface (no PyTorch headers, so the build takes seconds), which ctypes
loads.  The library goes into ``cvr_tpu_torch/_build/`` under a name keyed
by the sources' hash, at first use; nothing is built on import.
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
SOURCES = tuple(
    _PKG / "csrc" / f"{name}.cu"
    for name in ("route_kernels", "dia_kernels", "bell_kernels",
                 "window_kernels", "bsr_kernels", "lane_kernels",
                 "pmm_kernels")
)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    return BUILD_DIR / f"libcvr_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if their library is missing; return its path."""
    global build_log, build_seconds
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in SOURCES]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(SOURCES, objs)
    ]
    logs, failed = [], []
    try:
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate(timeout=600)
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode})")
    finally:
        for proc in procs:  # stop the others when one timed out
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if not failed:
        link = subprocess.run(
            [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True, timeout=600,
        )
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode})")
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{build_log}")
    os.replace(tmp, so)
    return so


def load():
    """The loaded kernel library (built at first call), argtypes set."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.cvr_expand.argtypes = [p, p, p, p, p, p, i32, i32, i32, i32, i32,
                               i32, i32, p]
    lib.cvr_route_middle.argtypes = [p, p, p, p, i32, i32, p]
    lib.cvr_route_middle_m1.argtypes = [p, p, p, i32, p]
    lib.cvr_route_middle_select.argtypes = [p, p, p, i32, i32, p]
    lib.cvr_reduce_slices.argtypes = [p, i32, p, p, p, p, p, i32, i32, i32,
                                      i32, p]
    lib.cvr_reduce_slices_combine.argtypes = [p, p, p, i32, i32, i32, p]
    lib.cvr_route_small.argtypes = [p, p, p, i32, p]
    lib.cvr_tileperm.argtypes = [p, p, p, i32, i32, i32, p]
    lib.cvr_route_m3.argtypes = [p, p, p, i64, p]
    lib.cvr_route_flat.argtypes = [p, p, p, p]
    lib.cvr_reduce_hot.argtypes = [p, p, p, p, p, p, p, i64, i64, i64, i64, p]
    lib.cvr_reduce_stream.argtypes = [p, p, p, p, p, p, i32, i32, i32, i32,
                                      i32, i32, p]
    lib.cvr_reduce_stream_combine.argtypes = [p, p, p, i32, i32, i32, p]
    lib.cvr_dia_spmv.argtypes = [p, p, p, p, i32, i64, i64, p]
    lib.cvr_bell_gather_mac.argtypes = [p, p, p, p, i32, i64, i32, i32, i64, p]
    lib.cvr_window_reduce.argtypes = [
        p, p, p, p, p, p, p, p, p, i32, i32, i32, i64, i32, i32, i32, i32, p,
    ]
    lib.cvr_dia_spmm.argtypes = [p, p, p, i32, i32, p, p, i64, i64, i32,
                                  p]
    lib.cvr_bsr_spmm.argtypes = [p, p, p, p, p, i64, i64, i64, i32, p]
    lib.cvr_bsr_spmm_smem.argtypes = []
    lib.cvr_lane_reduce.argtypes = [p, p, p, p, p, p, i32, i32, i32, p]
    lib.cvr_lane_reduce_combine.argtypes = [p, p, p, i32, i32, p]
    lib.cvr_pmm_spmm.argtypes = [p, p, p, p, p, p, p, i32, i32, i32, p]
    lib.cvr_pmm_spmm_combine.argtypes = [p, p, p, i32, i32, p]
    for fn in (
        lib.cvr_expand, lib.cvr_route_middle, lib.cvr_route_middle_m1,
        lib.cvr_route_middle_select, lib.cvr_reduce_slices,
        lib.cvr_reduce_slices_combine, lib.cvr_lane_reduce_combine,
        lib.cvr_route_small, lib.cvr_tileperm, lib.cvr_route_m3,
        lib.cvr_route_flat,
        lib.cvr_reduce_hot, lib.cvr_reduce_stream,
        lib.cvr_reduce_stream_combine, lib.cvr_dia_spmv,
        lib.cvr_bell_gather_mac, lib.cvr_window_reduce, lib.cvr_dia_spmm,
        lib.cvr_bsr_spmm, lib.cvr_bsr_spmm_smem, lib.cvr_lane_reduce,
        lib.cvr_pmm_spmm, lib.cvr_pmm_spmm_combine,
    ):
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib
