"""The payloads' benchmark: PageRank and CG on the packed formats.

    python -m cvr_tpu_torch.bench.models [--pagerank-iters 50]
        [--cg-iters 100] [--only pagerank|cg] [--device cpu]

  * PageRank on web-Google-like (R-MAT scale 20, unit link values),
    iterating its transpose through the routed SpMV (``pagerank_routed``),
    the power-law class of the CVR paper's datasets;
  * conjugate gradient on an SPD banded system of 1,048,576 rows (13
    diagonals made symmetric and diagonally dominant) through the SELL-W
    SpMV (K10), the banded / stencil class.

Each prints its two ``[model: ...]`` lines, then its time per iteration:
CUDA events around back-to-back loops (they count the host as well,
whenever it is the slower side: each PageRank and CG iteration reads its
stopping test back to the host), and the device time per iteration from
a torch.profiler trace.  PageRank is timed at ``tol=0`` (a fixed number
of iterations), CG by ``cg_shaped``, a CG loop with guarded denominators
and no early exit (the library CG stops after ~20 iterations on this
system).  Runs on the card unless ``--device cpu`` is passed; a CPU run
reports host time only.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from cvr_tpu_torch.bench.harness import device_ms, time_iterations
from cvr_tpu_torch.formats.coo import COOMatrix
from cvr_tpu_torch.formats.csr import CSRMatrix

CALLS = 5  # loops timed back to back by CUDA events
TRACE_CALLS = 4  # loops a device-time trace keeps (after as many lead ones)


def pagerank_operator(coo: COOMatrix) -> tuple[CSRMatrix, np.ndarray]:
    """(A^T in CSR, the out-degree of each vertex) of the adjacency of
    ``coo``'s pattern (unweighted links: every value 1)."""
    adj = COOMatrix(coo.rows, coo.cols, np.ones_like(coo.vals), coo.shape)
    csr_t = adj.transpose().to_csr()  # PageRank follows in-links: A^T
    out_degree = np.zeros(csr_t.shape[0], dtype=np.float32)
    np.add.at(out_degree, adj.rows.astype(np.int64), 1.0)
    return csr_t, out_degree


def spd_banded(n: int = 1 << 20, bandwidth: int = 13,
               seed: int = 5) -> CSRMatrix:
    """The SPD system A = B + B^T + diag(row |sums| + 1) of the band
    B = banded_matrix(n, bandwidth, seed): diagonal dominance makes it
    SPD."""
    from cvr_tpu_torch.bench.synthetic import banded_matrix

    band = banded_matrix(n, bandwidth=bandwidth, seed=seed)
    sym = COOMatrix(
        rows=np.concatenate([band.rows, band.cols]),
        cols=np.concatenate([band.cols, band.rows]),
        vals=np.concatenate([band.vals, band.vals]),
        shape=(n, n),
    ).sum_duplicates()
    row_abs = np.zeros(n, dtype=np.float64)
    np.add.at(row_abs, sym.rows.astype(np.int64), np.abs(sym.vals))
    diag = COOMatrix(
        rows=np.arange(n, dtype=np.int32),
        cols=np.arange(n, dtype=np.int32),
        vals=(row_abs + 1.0).astype(np.float32),
        shape=(n, n),
    )
    return COOMatrix(
        rows=np.concatenate([sym.rows, diag.rows]),
        cols=np.concatenate([sym.cols, diag.cols]),
        vals=np.concatenate([sym.vals, diag.vals]),
        shape=(n, n),
    ).sum_duplicates().to_csr()


def cg_shaped(matvec, b: torch.Tensor, scale: float, k: int) -> torch.Tensor:
    """k CG iterations on (A, b * scale) with no early exit: guarded
    denominators keep it stable past convergence.  Returns sum(x)."""
    bb = b * scale
    x = torch.zeros_like(bb)
    r = bb
    p = r
    rs = torch.dot(r, r)
    for _ in range(k):
        Ap = matvec(p)
        alpha = rs / (torch.dot(p, Ap) + 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs2 = torch.dot(r, r)
        p = r + (rs2 / (rs + 1e-30)) * p
        rs = rs2
    return torch.sum(x)


def per_iteration(loop, iters: int, device, marker) -> dict:
    """Time per iteration of ``loop`` (one call runs ``iters`` iterations,
    each launching ``marker``'s kernel once): ms by CUDA events over CALLS
    loops back to back (the host clock on the CPU), and on the card the
    device ms and the device ms by event name from a trace of TRACE_CALLS
    loops (None on the CPU)."""
    ms = time_iterations(loop, CALLS, device, warmup=1) * 1e3 / iters
    if torch.device(device).type != "cuda":
        return {"ms": ms, "device_ms": None, "by_event": None}
    per = device_ms(loop, TRACE_CALLS, marker, per_call=iters)
    by_event = {name: t / iters for name, t in per.items()}
    return {"ms": ms, "device_ms": sum(by_event.values()),
            "by_event": by_event}


def report_time(model: str, t: dict) -> None:
    if t["device_ms"] is None:
        print(f"[model: {model}] {t['ms']:.4f} ms/iteration by the host "
              "clock (CPU run: no device time)")
        return
    print(f"[model: {model}] {t['ms']:.4f} ms/iteration by CUDA events, "
          f"device {t['device_ms']:.4f} ms/iteration (busy "
          f"{100 * t['device_ms'] / t['ms']:.1f}%)")


def bench_pagerank(iters: int = 50, device="cuda", coo=None,
                   name: str = "web-Google-like") -> dict:
    """PageRank at ``tol=0`` for ``iters`` iterations on the transposed
    adjacency of ``coo`` (default web-Google-like; ``name`` labels it),
    packed by sell_pack_routed and uploaded once.  Returns what it ran
    and measured: csr_t, out_degree, the pack (``packed``, ``sd``,
    ``pack_s``), the ranks with their iterations and final delta, and the
    times (per_iteration's)."""
    from cvr_tpu_torch.bench.synthetic import web_google_like
    from cvr_tpu_torch.formats.sell_routed import sell_pack_routed
    from cvr_tpu_torch.models.pagerank import pagerank_routed
    from cvr_tpu_torch.ops.spmv_routed import to_device_routed

    coo = web_google_like() if coo is None else coo
    csr_t, out_degree = pagerank_operator(coo)
    t0 = time.perf_counter()
    sr = sell_pack_routed(csr_t)
    pack_s = time.perf_counter() - t0
    sd = to_device_routed(sr, device)
    odeg = torch.from_numpy(out_degree).to(device)

    def loop():
        return pagerank_routed(sd, out_degree=odeg, tol=0.0,
                               max_iters=iters)

    times = per_iteration(loop, iters, device, "route_small_kernel")
    ranks, its, delta = loop()
    ranks_np = ranks.cpu().numpy()
    top = np.argsort(-ranks_np)[:5]
    print(f"[model: pagerank] [matrix: {name}] pack {pack_s:.1f}s, "
          f"{times['ms']:.2f} ms/iteration, final delta after {its} iters "
          f"{float(delta):.2e}")
    print(f"[model: pagerank] top ranks {ranks_np[top].round(7).tolist()} "
          f"sum {ranks_np.sum():.6f}")
    report_time("pagerank", times)
    if not abs(ranks_np.sum() - 1.0) < 1e-3:
        raise AssertionError(f"PageRank's ranks sum to {ranks_np.sum()}")
    return {"csr_t": csr_t, "out_degree": out_degree, "packed": sr,
            "sd": sd, "pack_s": pack_s, "ranks": ranks, "iters": its,
            "delta": float(delta), "times": times}


def bench_cg(iters: int = 100, device="cuda", n: int = 1 << 20) -> dict:
    """cg_shaped's time per iteration over ``iters`` iterations, then
    conjugate_gradient to 1e-6 on the SPD banded system of n rows, packed
    by sell_pack_window and uploaded once, with its true float64 residual.
    Returns csr, the pack (``packed``, ``sd``, ``pack_s``), b, the
    solution with its iterations and residuals, and the times."""
    from cvr_tpu_torch.formats.sell_window import sell_pack_window
    from cvr_tpu_torch.models.solvers import conjugate_gradient
    from cvr_tpu_torch.ops.spmv_ref import spmv_golden_numpy
    from cvr_tpu_torch.ops.spmv_window import spmv_window, to_device_window

    csr = spd_banded(n)
    t0 = time.perf_counter()
    sw = sell_pack_window(csr)
    pack_s = time.perf_counter() - t0
    sd = to_device_window(sw, device)
    b_np = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    b = torch.from_numpy(b_np).to(device)

    def matvec(v):
        return spmv_window(sd, v)

    times = per_iteration(lambda: cg_shaped(matvec, b, 1.0, iters), iters,
                          device, "window_reduce_kernel")
    x, its, res = conjugate_gradient(matvec, b, tol=1e-6, max_iters=1000,
                                     device=device)
    x_np = x.cpu().numpy()
    r = b_np.astype(np.float64) - spmv_golden_numpy(csr, x_np)
    rel = float(np.linalg.norm(r) / np.linalg.norm(b_np.astype(np.float64)))
    label = "1M" if n == 1 << 20 else str(n)
    print(f"[model: cg] [matrix: spd-banded-{label}, nnz {csr.nnz}] pack "
          f"{pack_s:.1f}s, {times['ms']:.2f} ms/iteration, converges to "
          f"1e-6 in {its} iters, true rel residual at convergence {rel:.2e}")
    report_time("cg", times)
    if not rel < 1e-4:
        raise AssertionError(f"CG's true relative residual is {rel:.2e}")
    return {"csr": csr, "packed": sw, "sd": sd, "pack_s": pack_s, "b": b,
            "x": x, "iters": its, "residual": float(res), "true_rel": rel,
            "times": times}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pagerank-iters", type=int, default=50)
    ap.add_argument("--cg-iters", type=int, default=100)
    ap.add_argument("--only", choices=["pagerank", "cg"], default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a CPU run")
    if args.only in (None, "pagerank"):
        bench_pagerank(args.pagerank_iters, args.device)
    if args.only in (None, "cg"):
        bench_cg(args.cg_iters, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
