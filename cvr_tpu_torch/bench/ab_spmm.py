"""Time the SpMM kernels K11 (dia_spmm), K12 (bsr_spmm), K13
(lane_reduce) and K14 (pmm_spmm), and the SELL-W SpMV's K10
(window_reduce), of several checkouts of this repository on one card, in
turns.

    python3 -m cvr_tpu_torch.bench.ab_spmm ROOT [ROOT ...] [--kernels K,..]

Each ROOT is a directory holding a checkout's ``cvr_tpu_torch/`` and
``native/``, as for ab_routed.py, whose helpers this tool shares.  The
matrices, banded-2M (2,097,152 rows, 27 diagonals), fem-like (1,048,576
rows, ~51.9M nnz), web-Google-like (R-MAT scale 20, 6,162,120 nnz) and
fsm-like (2,097,152 rows, ~16.5M nnz), are generated once, X (ncols, K)
from ``np.random.default_rng(K)``, K 64 for K11 and K12, 128 for K13, 32
for K14, and K10's x (ncols,) from ``np.random.default_rng(0)``; then,
for each root in the order given (give them as A B B A), a subprocess
imports that root's package, builds its kernels and native library, packs
banded-2M as DIA, banded-2M and fem-like as BSR-128, web-Google-like as
the lane plan, fsm-like with pmm_plan and fem-like as SELL-W
(sell_pack_window, the artifact spmv_window runs), and takes from
torch.profiler traces of back-to-back launches the device time per launch
of K11 on banded-2M's DIA, of K12 on both BSR packs and of K10, and per
call of K13 and K14 (their kernels, a split item's second pass
included).  ``--kernels`` names the ones to time (default all).  Each
launch's output is held against the root's own plain version within 1e-6
of the row scale (the order of a sum is free); each root also prints a
digest of K10's and K14's outputs (sha256 of their bytes), so that roots
whose kernels sum in the same order can be seen to agree bit for bit.  It
prints one JSON line per root and exits 1 if a root's kernel disagrees
with its plain version or two of its launches on the same inputs differ.
It needs a CUDA card and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ITERS = 50
K = 64
K_LANE = 128
K_PMM = 32
MATRICES = {"dia_spmm": ("banded_2m",), "bsr_spmm": ("banded_2m", "fem_like"),
            "lane_reduce": ("web_google_like",), "pmm_spmm": ("fsm_like",),
            "window_reduce": ("fem_like",)}
# K13's and K14's kernels' device event names (the second pass where a
# checkout has one)
K13_EVENTS = ("lane_reduce_kernel", "lane_reduce_combine_kernel")
K14_EVENTS = ("pmm_spmm_kernel", "pmm_spmm_combine_kernel")
# kernels whose outputs' digests each root prints
DIGESTS = ("pmm_spmm", "window_reduce")


def ptxas_lines(log: str, names) -> dict:
    """ptxas' report (registers, shared memory, spills) of each kernel
    function of ``names`` in the build log: mangled name -> its lines."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            fn = fn if any(n in fn for n in names) else None
        elif fn and ("Used" in line or "spill" in line):
            out[fn] = f"{out.get(fn, '')} {line.strip()}".strip()
    return out


def worker(root: str, npz: str, iters: int, names) -> dict:
    """One root's measurements (run in a subprocess whose path starts at
    ``root``)."""
    import hashlib

    import numpy as np
    import torch

    import cvr_tpu_torch
    from cvr_tpu_torch import _native
    from cvr_tpu_torch.bench.ab_routed import _device_us
    from cvr_tpu_torch.formats.bsr import bsr_pack
    from cvr_tpu_torch.formats.coo import COOMatrix
    from cvr_tpu_torch.formats.dia import dia_pack
    from cvr_tpu_torch.formats.sell_window import sell_pack_window
    from cvr_tpu_torch.ops import _build, spmm_bsr, spmm_lane, spmm_pmm
    from cvr_tpu_torch.ops import bsr_kernels as bk
    from cvr_tpu_torch.ops import dia_kernels as dk
    from cvr_tpu_torch.ops import lane_kernels as lk
    from cvr_tpu_torch.ops import pmm_kernels as pk
    from cvr_tpu_torch.ops import window_kernels as wk
    from cvr_tpu_torch.ops.spmv_dia import to_device_dia
    from cvr_tpu_torch.ops.spmv_window import reduce_args, to_device_window

    pkg = Path(cvr_tpu_torch.__file__).resolve().parent
    if pkg.parent != Path(root).resolve():
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    _native.build()
    _build.load()
    z = np.load(npz)
    out = {"root": root, "device": torch.cuda.get_device_name(0),
           "ptxas": ptxas_lines(_build.build_log or "", names)}
    mats = [m for m in ("banded_2m", "fem_like", "web_google_like",
                        "fsm_like")
            if any(m in MATRICES[n] for n in names)]
    for mat in mats:
        csr = COOMatrix(rows=z[f"{mat}_rows"], cols=z[f"{mat}_cols"],
                        vals=z[f"{mat}_vals"],
                        shape=tuple(z[f"{mat}_shape"])).to_csr()
        k = {"web_google_like": K_LANE, "fsm_like": K_PMM}.get(mat, K)
        X = torch.from_numpy(np.random.default_rng(k).standard_normal(
            (csr.shape[1], k)).astype(np.float32)).to("cuda")
        cases = []
        if mat == "banded_2m" and "dia_spmm" in names:
            sd = to_device_dia(dia_pack(csr), "cuda")
            cases.append(("dia_spmm", dk.dia_spmm, dk.dia_spmm_plain,
                          (sd.bands, sd.offsets, X),
                          (sd.bands.abs(), sd.offsets, X.abs()),
                          ("dia_spmm_kernel",)))
        if mat in MATRICES["bsr_spmm"] and "bsr_spmm" in names:
            bd = spmm_bsr.to_device_bsr(bsr_pack(csr), "cuda")
            args = spmm_bsr.kernel_args(bd, X)
            cases.append(("bsr_spmm", bk.bsr_spmm, bk.bsr_spmm_plain, args,
                          (bd.vals.abs(), *args[1:4], X.abs(), args[5]),
                          ("bsr_spmm_kernel",)))
        if mat == "web_google_like":
            ld = spmm_lane.to_device_lane(spmm_lane.spmm_lane_pack(csr),
                                          "cuda")
            args = spmm_lane.kernel_args(ld, X)
            cases.append(("lane_reduce", lk.lane_reduce,
                          lambda *a: lk.lane_reduce_plain(*a[:5]), args,
                          (args[0], args[1].abs(), *args[2:4], X.abs()),
                          K13_EVENTS))
        if mat == "fsm_like":
            pd = spmm_pmm.to_device_pmm(spmm_pmm.pmm_plan(
                csr.row_ids(), csr.cols, csr.vals, csr.shape), "cuda")
            args = spmm_pmm.kernel_args(pd, X)
            # the values and X at the positions each checkout's
            # kernel_args puts them
            cases.append(("pmm_spmm", pk.pmm_spmm, pk.pmm_spmm_plain, args,
                          tuple(a.abs() if i == 1 or a is X else a
                                for i, a in enumerate(args)), K14_EVENTS))
        if mat == "fem_like" and "window_reduce" in names:
            wd = to_device_window(sell_pack_window(csr), "cuda")
            x = torch.from_numpy(np.random.default_rng(0).standard_normal(
                csr.shape[1]).astype(np.float32)).to("cuda")
            args = reduce_args(wd, x)
            cases.append(("window_reduce", wk.window_reduce,
                          wk.window_reduce_plain, args,
                          (args[0], args[1].abs(), *args[2:4], x.abs(),
                           *args[5:]), ("window_reduce_kernel",)))
        for name, wrapper, plain, args, abs_args, events in cases:
            got, want = wrapper(*args), plain(*args)
            err = (got - want).abs()
            del want
            scale = plain(*abs_args)
            key = f"{name}_{mat}"
            out[f"{key}_max_abs_err"] = float(err.max())
            out[f"{key}_max_row_scaled_err"] = float(
                (err / (scale + 1e-30)).max())
            out[f"{key}_within"] = bool((err <= 1e-6 * scale + 1e-30).all())
            out[f"{key}_repeats"] = bool(torch.equal(got, wrapper(*args)))
            if name in DIGESTS:
                out[f"{key}_sha256"] = hashlib.sha256(
                    got.cpu().numpy().tobytes()).hexdigest()[:16]
            del got, err, scale
            total, per_call = 0.0, 0.0
            for event in events:  # an older checkout may lack the 2nd pass
                try:
                    us, n = _device_us(lambda: wrapper(*args), event, iters)
                except RuntimeError:
                    continue
                total, per_call = total + us * round(n), per_call + n
            out[f"{key}_ms"] = total / 1e3
            out[f"{key}_launches"] = per_call
        del cases, args, X
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "NPZ"))
    ap.add_argument("--kernels", default=",".join(MATRICES),
                    help="comma-separated kernels to time")
    args = ap.parse_args(argv)
    names = args.kernels.split(",")
    if not set(names) <= set(MATRICES):
        raise SystemExit(f"ab_spmm: --kernels among {sorted(MATRICES)}")
    if args.worker:
        # the root's package (and its ab_routed), not the one beside this file
        sys.path[0] = str(Path(args.worker[0]).resolve())
        print(json.dumps(worker(*args.worker, args.iters, names)))
        return 0
    import numpy as np
    import torch

    from cvr_tpu_torch.bench.ab_routed import card, run_roots
    from cvr_tpu_torch.bench.synthetic import (
        banded_matrix,
        fem_like,
        fsm_like,
        web_google_like,
    )

    if not torch.cuda.is_available():
        raise SystemExit("ab_spmm: torch.cuda.is_available() is false")
    print(f"nvidia-smi: {card()}")
    make = {"banded_2m": lambda: banded_matrix(1 << 21, 27),
            "fem_like": fem_like, "web_google_like": web_google_like,
            "fsm_like": fsm_like}
    mats = {m: make[m]() for m in make
            if any(m in MATRICES[n] for n in names)}
    with tempfile.TemporaryDirectory() as tmp:
        npz = str(Path(tmp) / "matrices.npz")
        np.savez(npz, **{f"{m}_{k}": v for m, coo in mats.items()
                         for k, v in (("rows", coo.rows), ("cols", coo.cols),
                                      ("vals", coo.vals),
                                      ("shape", np.asarray(coo.shape)))})
        del mats
        rows = run_roots(__file__, args.roots, npz, args.iters,
                         ["--kernels", args.kernels])
    for key in sorted({k for r in rows for k in r if k.endswith("_sha256")}):
        same = len({r.get(key) for r in rows}) == 1
        print(f"ab_spmm: {key[:-len('_sha256')]} outputs "
              f"{'equal bit for bit' if same else 'differ'} across the roots")
    bad = [(r["root"], k) for r in rows for k, v in r.items()
           if k.endswith(("_within", "_repeats")) and not v]
    if bad:
        print(f"ab_spmm: kernels disagree with their plain versions: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
