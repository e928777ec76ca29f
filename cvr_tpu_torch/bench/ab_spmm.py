"""Time the SpMM kernels K11 (dia_spmm) and K12 (bsr_spmm) of several
checkouts of this repository on one card, in turns.

    python3 -m cvr_tpu_torch.bench.ab_spmm ROOT [ROOT ...]

Each ROOT is a directory holding a checkout's ``cvr_tpu_torch/`` and
``native/``, as for ab_routed.py, whose helpers this tool shares.  The
matrices, banded-2M (2,097,152 rows, 27 diagonals) and fem-like
(1,048,576 rows, ~51.9M nnz), are generated once, and X (ncols, 64) from
``np.random.default_rng(64)``; then, for each root in the order given (give
them as A B B A), a subprocess imports that root's package, builds its
kernels and native library, packs banded-2M as DIA and both matrices as
BSR-128, and takes from torch.profiler traces of back-to-back launches the
device time per launch of K11 on banded-2M's DIA and of K12 on both BSR
packs.  Each launch's output is held against the root's own plain version
within 1e-6 of the row scale (the order of a sum is free, so outputs are
not compared across roots).  It prints one JSON line per root and exits 1
if a root's kernel disagrees with its plain version.  It needs a CUDA card
and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ITERS = 50
K = 64


def worker(root: str, npz: str, iters: int) -> dict:
    """One root's measurements (run in a subprocess whose path starts at
    ``root``)."""
    import numpy as np
    import torch

    import cvr_tpu_torch
    from cvr_tpu_torch import _native
    from cvr_tpu_torch.bench.ab_routed import _device_us
    from cvr_tpu_torch.formats.bsr import bsr_pack
    from cvr_tpu_torch.formats.coo import COOMatrix
    from cvr_tpu_torch.formats.dia import dia_pack
    from cvr_tpu_torch.ops import _build, spmm_bsr
    from cvr_tpu_torch.ops import bsr_kernels as bk
    from cvr_tpu_torch.ops import dia_kernels as dk
    from cvr_tpu_torch.ops.spmv_dia import to_device_dia

    pkg = Path(cvr_tpu_torch.__file__).resolve().parent
    if pkg.parent != Path(root).resolve():
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    _native.build()
    _build.load()
    z = np.load(npz)
    out = {"root": root, "device": torch.cuda.get_device_name(0)}
    for mat in ("banded_2m", "fem_like"):
        csr = COOMatrix(rows=z[f"{mat}_rows"], cols=z[f"{mat}_cols"],
                        vals=z[f"{mat}_vals"],
                        shape=tuple(z[f"{mat}_shape"])).to_csr()
        X = torch.from_numpy(np.random.default_rng(64).standard_normal(
            (csr.shape[1], K)).astype(np.float32)).to("cuda")
        cases = []
        if mat == "banded_2m":
            sd = to_device_dia(dia_pack(csr), "cuda")
            cases.append(("dia_spmm", dk.dia_spmm, dk.dia_spmm_plain,
                          (sd.bands, sd.offsets, X),
                          (sd.bands.abs(), sd.offsets, X.abs())))
        bd = spmm_bsr.to_device_bsr(bsr_pack(csr), "cuda")
        args = spmm_bsr.kernel_args(bd, X)
        cases.append(("bsr_spmm", bk.bsr_spmm, bk.bsr_spmm_plain, args,
                      (bd.vals.abs(), *args[1:4], X.abs(), args[5])))
        for name, wrapper, plain, args, abs_args in cases:
            got, want = wrapper(*args), plain(*args)
            err = (got - want).abs()
            del want
            scale = plain(*abs_args)
            key = f"{name}_{mat}"
            out[f"{key}_max_abs_err"] = float(err.max())
            out[f"{key}_max_row_scaled_err"] = float(
                (err / (scale + 1e-30)).max())
            out[f"{key}_within"] = bool((err <= 1e-6 * scale + 1e-30).all())
            del got, err, scale
            us, per_call = _device_us(lambda: wrapper(*args),
                                      f"{name}_kernel", iters)
            out[f"{key}_ms"] = us / 1e3
            out[f"{key}_launches"] = per_call
        del cases, args, bd, X
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "NPZ"))
    args = ap.parse_args(argv)
    if args.worker:
        # the root's package (and its ab_routed), not the one beside this file
        sys.path[0] = str(Path(args.worker[0]).resolve())
        print(json.dumps(worker(*args.worker, args.iters)))
        return 0
    import numpy as np
    import torch

    from cvr_tpu_torch.bench.ab_routed import card, run_roots
    from cvr_tpu_torch.bench.synthetic import banded_matrix, fem_like

    if not torch.cuda.is_available():
        raise SystemExit("ab_spmm: torch.cuda.is_available() is false")
    print(f"nvidia-smi: {card()}")
    mats = {"banded_2m": banded_matrix(1 << 21, 27), "fem_like": fem_like()}
    with tempfile.TemporaryDirectory() as tmp:
        npz = str(Path(tmp) / "matrices.npz")
        np.savez(npz, **{f"{m}_{k}": v for m, coo in mats.items()
                         for k, v in (("rows", coo.rows), ("cols", coo.cols),
                                      ("vals", coo.vals),
                                      ("shape", np.asarray(coo.shape)))})
        del mats
        rows = run_roots(__file__, args.roots, npz, args.iters)
    bad = [(r["root"], k) for r in rows for k, v in r.items()
           if k.endswith("_within") and not v]
    if bad:
        print(f"ab_spmm: kernels disagree with their plain versions: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
