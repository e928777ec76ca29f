"""SpMM benchmark: the BSR-128 kernel (K12), the SpMVs of pack_auto's
format through ``spmm``, the lane SpMM (K13) and the PMM SpMM (K14).

The port of the JAX package's ``scripts/spmm_bench.py``: the same rows,
grids and JSON keys, each run checked against a float64 golden on the
first min(K, 8) columns of a random X (``max_rel_err``, scaled by
|A| @ |X|), and timed with CUDA events over back-to-back calls
(``spmm_s``, seconds) and as device time from a torch.profiler trace
(``device_ms``, an added key, with ``device``).  K12 always computes at
float32 grade (3xTF32 on the tensor cores): the JAX script's HIGHEST and
HIGH rows (``bsr-highest``, ``bsr-high``) run the same kernel, and every
BSR row says so (``k12_grade``).  Rows are appended to a results file of
the port's own (``--out``, default results_spmm_h100.jsonl).

Usage: python -m cvr_tpu_torch.bench.spmm [--quick | --pmm]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

DEFAULT_OUT = "results_spmm_h100.jsonl"
K12_GRADE = "float32 (3xTF32)"


def _x(ncols: int, K: int) -> np.ndarray:
    return np.random.default_rng(0).standard_normal((ncols, K)).astype(
        np.float32)


def golden_err(csr, X: np.ndarray, run) -> float:
    """Max error of ``run``'s Y (a torch SpMM of X's first min(K, 8)
    columns) against the float64 golden, scaled by |A| @ |X|."""
    m64 = csr.to_scipy().astype(np.float64)
    Xv = X[:, : min(X.shape[1], 8)]
    Y = run(np.ascontiguousarray(Xv)).cpu().numpy()
    gold = m64 @ Xv.astype(np.float64)
    scale = abs(m64) @ np.abs(Xv.astype(np.float64)) + 1e-30
    return float((np.abs(Y - gold) / scale).max())


def timed(fn, iters: int, device, marker) -> tuple[float, float | None]:
    """(seconds per call by CUDA events, or the host clock on the CPU;
    device ms per call from a trace on a CUDA device, else None)."""
    from cvr_tpu_torch.bench.harness import device_ms, time_iterations

    t = time_iterations(fn, iters, device)
    if torch.device(device).type != "cuda":
        return t, None
    return t, sum(device_ms(fn, iters, marker).values())


def _row(row, dms, device) -> dict:
    row["device_ms"] = dms
    row["device"] = (torch.cuda.get_device_name(torch.device(device))
                     if torch.device(device).type == "cuda" else "cpu")
    print(json.dumps(row))
    return row


def bench_one(name, coo, K, precision="highest", iters=20, device="cuda"):
    """BSR-128 through K12 at width K (``precision`` names the row as the
    JAX script's; K12 computes at float32 grade whatever it says)."""
    from cvr_tpu_torch.formats.bsr import bsr_pack
    from cvr_tpu_torch.ops.spmm_bsr import spmm_bsr_fused, to_device_bsr

    csr = coo.to_csr()
    t0 = time.perf_counter()
    bm = bsr_pack(csr)
    pack_s = time.perf_counter() - t0
    sd = to_device_bsr(bm, device)
    X = _x(csr.shape[1], K)
    maxrel = golden_err(
        csr, X, lambda Xv: spmm_bsr_fused(sd, torch.from_numpy(Xv).to(device)))
    Xd = torch.from_numpy(X).to(device)
    t, dms = timed(lambda: spmm_bsr_fused(sd, Xd), iters, device,
                   "bsr_spmm_kernel")
    return _row({
        "name": name,
        "impl": f"bsr-{precision}",
        "K": K,
        "nnz": csr.nnz,
        "nbricks": bm.nbricks,
        "fill": round(bm.fill, 4),
        "pack_s": round(pack_s, 3),
        "spmm_s": t,
        "useful_gflops": round(2 * csr.nnz * K / t / 1e9, 1),
        "max_rel_err": maxrel,
        "k12_grade": K12_GRADE,
    }, dms, device)


def bench_vmapped(name, coo, K, iters=5, device="cuda"):
    """``spmm`` on pack_auto's artifact: its SpMV once per column (DIA:
    K11)."""
    from cvr_tpu_torch.formats import pack_auto
    from cvr_tpu_torch.ops.spmv import spmm, upload

    csr = coo.to_csr()
    sd = upload(pack_auto(csr), device)
    X = _x(csr.shape[1], K)
    maxrel = golden_err(
        csr, X, lambda Xv: spmm(sd, torch.from_numpy(Xv).to(device)))
    Xd = torch.from_numpy(X).to(device)
    t, dms = timed(lambda: spmm(sd, Xd), iters, device, None)
    return _row({
        "name": name,
        "impl": "vmapped-auto",
        "K": K,
        "nnz": csr.nnz,
        "spmm_s": t,
        "useful_gflops": round(2 * csr.nnz * K / t / 1e9, 1),
        "max_rel_err": maxrel,
    }, dms, device)


def bench_lane(name, coo, K, iters=10, device="cuda"):
    """The K-in-lane SpMM (ops/spmm_lane.py, K13)."""
    from cvr_tpu_torch.ops.spmm_lane import (
        spmm_lane,
        spmm_lane_pack,
        to_device_lane,
    )

    csr = coo.to_csr()
    t0 = time.perf_counter()
    lp = spmm_lane_pack(csr)
    pack_s = time.perf_counter() - t0
    sd = to_device_lane(lp, device)
    X = _x(csr.shape[1], K)
    maxrel = golden_err(
        csr, X, lambda Xv: spmm_lane(sd, torch.from_numpy(Xv).to(device)))
    Xd = torch.from_numpy(X).to(device)
    t, dms = timed(lambda: spmm_lane(sd, Xd), iters, device,
                   "lane_reduce_kernel")
    return _row({
        "name": name,
        "impl": "lane",
        "K": K,
        "nnz": csr.nnz,
        "pack_s": round(pack_s, 3),
        "spmm_s": t,
        "useful_gflops": round(2 * csr.nnz * K / t / 1e9, 1),
        "max_rel_err": maxrel,
    }, dms, device)


def bench_pmm(name, coo, K, iters=20, device="cuda"):
    """The PMM SpMM (ops/spmm_pmm.py, K14), with the sampled fan-in."""
    from cvr_tpu_torch.ops.spmm_pmm import (
        pmm_estimate,
        pmm_plan,
        spmm_pmm,
        to_device_pmm,
    )

    npairs, nchunks = pmm_estimate(coo.rows, coo.cols, coo.shape)
    t0 = time.perf_counter()
    plan = pmm_plan(coo.rows, coo.cols, coo.vals, coo.shape)
    pack_s = time.perf_counter() - t0
    sd = to_device_pmm(plan, device)
    X = _x(coo.shape[1], K)
    maxrel = golden_err(
        coo.to_csr(), X,
        lambda Xv: spmm_pmm(sd, torch.from_numpy(Xv).to(device)))
    Xd = torch.from_numpy(X).to(device)
    t, dms = timed(lambda: spmm_pmm(sd, Xd), iters, device,
                   "pmm_spmm_kernel")
    return _row({
        "name": name,
        "impl": "pmm",
        "K": K,
        "nnz": int(coo.nnz),
        "fanin_C": round(npairs / max(nchunks, 1), 2),
        "pack_s": round(pack_s, 3),
        "spmm_s": t,
        "useful_gflops": round(2 * coo.nnz * K / t / 1e9, 1),
        "max_rel_err": maxrel,
    }, dms, device)


def run(quick: bool = False, pmm: bool = False, device="cuda") -> list[dict]:
    """The JAX script's grids: ``pmm`` the PMM rows (fsm-like at K 32,
    64, 128), ``quick`` banded-200K at K 128 through K12, else the full
    grid (web-Google-like, banded-1M, fem-like, rgg-like)."""
    from cvr_tpu_torch.bench.synthetic import (
        banded_matrix,
        fem_like,
        fsm_like,
        rgg_like,
        web_google_like,
    )

    rows = []
    if pmm:
        fsm = fsm_like()
        for K in (32, 64, 128):
            rows.append(bench_pmm("fsm-like", fsm, K, device=device))
        del fsm
    elif quick:
        coo = banded_matrix(200_000, bandwidth=27, seed=0)
        rows.append(bench_one("banded-200K", coo, 128, device=device))
    else:
        web = web_google_like()
        for K in (32, 64):
            rows.append(bench_vmapped("web-Google-like", web, K,
                                      device=device))
        for K in (64, 96, 128):
            rows.append(bench_lane("web-Google-like", web, K, device=device))
        del web
        banded = banded_matrix(1_000_000, bandwidth=27, seed=0)
        for K in (32, 128, 256):
            rows.append(bench_one("banded-1M", banded, K, device=device))
        rows.append(bench_one("banded-1M", banded, 128, "high",
                              device=device))
        for K in (32, 128):
            rows.append(bench_vmapped("banded-1M", banded, K, device=device))
        del banded
        rows.append(bench_one("fem-like", fem_like(), 128, device=device))
        rows.append(bench_one("rgg-like", rgg_like(n=1 << 20), 128,
                              device=device))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--pmm", action="store_true",
                    help="only the PMM rows (fsm-class)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="JSONL to append the rows to")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a smoke run)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a CPU run")
    rows = run(args.quick, args.pmm, args.device)
    with open(args.out, "a") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
