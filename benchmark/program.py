"""The system under test, cvr_tpu_torch, as the benchmark drives it.

The only module of the benchmark that imports the program.  It hands
the program the matrix the benchmark made, as the program's COOMatrix,
and runs the program's own set-up path:

* ``"artifact": "packed"``: pack on every run (``cli.spmm_pick("auto",
  coo, K)`` for an SpMM, ``formats.pack_auto`` of the CSR for an SpMV,
  as ``cli spmv`` packs), then ``ops.spmv.upload``;
* ``"artifact": "saved"``: where the pack is too slow to pay on every
  run, the first run of a cell in a checkout packs and writes the
  artifact with ``cli.save_packed`` under ``benchmark/cache/packed/`` (a
  fixed place, keyed by the matrix, the product and the program's
  sources); every run then reads it with ``cli.load_packed`` and uploads
  it.

The product is ``ops.spmv.spmv`` or ``ops.spmv.spmm``, looked up on the
module at each call.
"""

from __future__ import annotations

import hashlib
import importlib
import os
import time
from pathlib import Path

from benchmark import matrix as mx

PACKAGE = "cvr_tpu_torch"


def package_dir() -> Path:
    return Path(importlib.import_module(PACKAGE).__file__).resolve().parent


def sources_digest() -> str:
    """A digest of the program's sources: the package's Python and CUDA
    files and the native library's sources beside it."""
    pkg = package_dir()
    files = sorted([*pkg.rglob("*.py"), *pkg.rglob("*.cu"),
                    *(pkg.parent / "native").glob("*.cpp"),
                    *(pkg.parent / "native").glob("Makefile")])
    h = hashlib.sha256()
    for f in files:
        h.update(str(f.relative_to(pkg.parent)).encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _coo(m: mx.Matrix):
    from cvr_tpu_torch.formats.coo import COOMatrix

    return COOMatrix(rows=m.rows, cols=m.cols, vals=m.vals, shape=(m.n, m.n))


def pack(m: mx.Matrix, op: str, K: int):
    """The program's packed host artifact of ``m`` for the product."""
    if op == "spmm":
        from cvr_tpu_torch import cli

        return cli.spmm_pick("auto", _coo(m), K)[1]
    from cvr_tpu_torch.formats import pack_auto

    return pack_auto(_coo(m).to_csr())


def artifact_path(config: dict, op: str, K: int,
                  cache: Path = mx.CACHE) -> Path:
    key = mx.key({"matrix": mx.params(config), "op": op, "K": K,
                  "program": sources_digest()})
    return cache / "packed" / f"{config['name']}-{op}{K}-{key}.npz"


def set_up(config: dict, op: str, K: int, device, spans: dict,
           cache: Path = mx.CACHE):
    """(the device artifact, the matrix or None): the program's set-up
    path of the config, each step's host seconds in ``spans`` ("import",
    "matrix", "pack", "save", "load", "upload"; "generate" where the
    matrix was made now).  The matrix is returned where it was read
    anyway, for the reference."""
    import torch

    t = time.perf_counter()
    from cvr_tpu_torch.utils import memarena

    dispatch = importlib.import_module(f"{PACKAGE}.ops.spmv")
    spans["import"] = time.perf_counter() - t

    # as the program's command line does: warm the host's allocator
    # arena where first touches are slow
    memarena.warm_if_lazy()

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        spans[name] = spans.get(name, 0.0) + time.perf_counter() - t
        return out

    def read_matrix():
        m, made = timed("matrix", lambda: mx.load(config, cache))
        if made:
            spans["generate"] = spans.pop("matrix")
        return m

    m = None
    if config["artifact"] == "packed":
        m = read_matrix()
        host = timed("pack", lambda: pack(m, op, K))
    elif config["artifact"] == "saved":
        from cvr_tpu_torch import cli

        path = artifact_path(config, op, K, cache)
        if not path.exists():
            m = read_matrix()
            made = timed("pack", lambda: pack(m, op, K))
            path.parent.mkdir(parents=True, exist_ok=True)
            for old in path.parent.glob(f"{config['name']}-{op}{K}-*"):
                old.unlink()
            tmp = path.with_name(path.stem + ".tmp.npz")
            timed("save", lambda: cli.save_packed(made, str(tmp)))
            os.replace(tmp, path)
            del made
            m = None  # this run's reference reads it back, as later runs do
        host = timed("load", lambda: cli.load_packed(str(path))[1])
    else:
        raise ValueError(f"unknown artifact {config['artifact']!r}")

    def up():
        sd = dispatch.upload(host, device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return sd

    sd = timed("upload", up)
    return sd, m


def product(op: str):
    """The timed call: Y = A @ X by the program's dispatcher."""
    dispatch = importlib.import_module(f"{PACKAGE}.ops.spmv")
    if op == "spmv":
        return lambda sd, x: dispatch.spmv(sd, x)
    return lambda sd, X: dispatch.spmm(sd, X)


def launches() -> int:
    """Kernel launches the program has counted since the last reset."""
    from cvr_tpu_torch.ops import kernels

    return sum(kernels.launches().values())


def reset_launches() -> None:
    from cvr_tpu_torch.ops import kernels

    kernels.reset_launches()
