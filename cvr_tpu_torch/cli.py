"""Command-line entry point of the port.

  python -m cvr_tpu_torch.cli spmv <file.mtx> [--iters N]
      [--format auto|sell-routed|dia|bell|sell-window|sell|csr
                |bsr|lane|pmm]
      [--rhs K] [--device cuda|cpu] [--no-verify]
  python -m cvr_tpu_torch.cli info <file.mtx>

``spmv`` converts (``--format auto``, the default: the format
``pack_auto`` picks, as the JAX package's CLI does), runs the timed SpMV
iterations, verifies against the float64 golden and prints the greppable
report.  With ``--rhs K`` > 1 it runs the SpMM Y = A @ X with X all ones
(K columns) instead: ``auto`` tries BSR-128 first, then ``pack_auto``'s
format, with the PMM and lane paths for matrices that ``pack_auto`` sends
to the routed path where the JAX package's gate picks them.
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch


def _load(path: str, pattern_values: str):
    from cvr_tpu_torch.io.mmio import read_matrix_market

    t0 = time.perf_counter()
    coo = read_matrix_market(path, pattern_values=pattern_values)
    print(
        f"[file: {path}] read {coo.shape[0]}x{coo.shape[1]}, "
        f"{coo.nnz} nnz in {time.perf_counter() - t0:.2f}s"
    )
    return coo


# --format -> the bench harness's impl
_SPMV_IMPL = {"sell": "sell-xla"}


def cmd_spmv(args) -> int:
    from cvr_tpu_torch.bench.harness import run_spmv_benchmark

    coo = _load(args.matrix, args.pattern_values)
    if args.rhs > 1:
        return _spmm(args, coo).rc
    if args.format in ("bsr", "lane", "pmm"):
        print(
            f"error: --format {args.format} is an SpMM format; use it with "
            "--rhs K > 1",
            file=sys.stderr,
        )
        return 2
    r = run_spmv_benchmark(
        coo,
        name=args.matrix,
        impl=_SPMV_IMPL.get(args.format, args.format),
        iters=args.iters,
        device=args.device,
        verify_result=not args.no_verify,
    )
    r.print_report()
    return 0 if r.verified in (True, None) else 1


@dataclass
class SpmmRun:
    """What ``_spmm`` ran: the format it picked, the device artifact that
    ``spmm`` multiplies, its report's numbers and the exit code."""

    rc: int
    fmt: str = ""
    sd: object = None
    spmm_s: float = 0.0
    verified: bool | None = None  # None: --no-verify, or above the cap
    max_rel_err: float | None = None


def spmm_pick(fmt: str, coo, K: int):
    """(format name, packed host artifact) that ``spmv --rhs K --format
    fmt`` runs, picked as the JAX package's CLI picks them.  Raises
    BsrInfeasible for --format bsr where the bricks are refused."""
    from cvr_tpu_torch.formats import pack_auto
    from cvr_tpu_torch.formats.bell import BellMatrix, bell_pack
    from cvr_tpu_torch.formats.bsr import BsrInfeasible, bsr_pack
    from cvr_tpu_torch.formats.dia import DiaMatrix, dia_pack
    from cvr_tpu_torch.formats.sell import sell_pack
    from cvr_tpu_torch.formats.sell_routed import SellRouted, sell_pack_routed
    from cvr_tpu_torch.formats.sell_window import SellWindow, sell_pack_window
    from cvr_tpu_torch.ops.spmm_lane import spmm_lane_pack
    from cvr_tpu_torch.ops.spmm_pmm import (
        NS_LANE_PER_ELEM,
        NS_ROUTED_PER_ELEM,
        pmm_estimate,
        pmm_plan,
        pmm_projected_ms,
    )

    csr = coo.to_csr()
    if fmt in ("auto", "bsr"):
        try:
            return "bsr", bsr_pack(csr)
        except BsrInfeasible:
            if fmt == "bsr":
                raise
    if fmt == "auto":
        packed = pack_auto(csr)
        if isinstance(packed, DiaMatrix):
            return "dia", packed
        if isinstance(packed, BellMatrix):
            return "bell", packed
        if isinstance(packed, SellWindow):
            return "sell-window", packed
        if not isinstance(packed, SellRouted):  # above the routed cap
            return "sell", packed
        # the JAX package's gate, with its TPU v5e constants
        est = pmm_estimate(coo.rows, coo.cols, coo.shape)
        pmm_ms = pmm_projected_ms(est, K)
        routed_ms = K * coo.nnz * NS_ROUTED_PER_ELEM / 1e6
        lane_ms = coo.nnz * NS_LANE_PER_ELEM / 1e6
        if pmm_ms < min(routed_ms, lane_ms):
            return "pmm", pmm_plan(coo.rows, coo.cols, coo.vals, coo.shape)
        if K >= 96 and lane_ms < routed_ms:
            return "lane", spmm_lane_pack(csr)
        return "sell-routed", packed
    if fmt == "lane":
        return fmt, spmm_lane_pack(csr)
    if fmt == "pmm":
        return fmt, pmm_plan(coo.rows, coo.cols, coo.vals, coo.shape)
    pack = {"bell": bell_pack, "sell-routed": sell_pack_routed,
            "sell-window": sell_pack_window, "dia": dia_pack}.get(fmt)
    if pack is not None:
        return fmt, pack(csr)
    # "sell" and "csr": the plain SELL planes, as in the JAX package's CLI
    return "sell", sell_pack(csr)


def _spmm(args, coo) -> SpmmRun:
    """The SpMM of ``spmv --rhs K``: pick and pack (timed), upload, the
    timed iterations of Y = A @ X with X all ones, the three-line report,
    and the float64 verify where nnz * K <= 2e9."""
    import scipy.sparse as sps

    from cvr_tpu_torch.bench.harness import time_iterations
    from cvr_tpu_torch.formats.bsr import BsrInfeasible
    from cvr_tpu_torch.ops.spmv import spmm, upload

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for a CPU run")
    K = args.rhs
    csr = coo.to_csr()
    t0 = time.perf_counter()
    try:
        fmt, packed = spmm_pick(args.format, coo, K)
    except BsrInfeasible as e:
        print(f"error: {e}", file=sys.stderr)
        return SpmmRun(rc=2)
    preproc = time.perf_counter() - t0
    sd = upload(packed, dev)
    del packed
    X = np.ones((coo.shape[1], K), dtype=np.float32)
    Xd = torch.from_numpy(X).to(dev)
    t = time_iterations(lambda: spmm(sd, Xd), args.iters, dev)
    tag = f"[file: {args.matrix}] [rhs: {K}]"
    print(f"{tag} [format: {fmt}] Pre-processing Time: {preproc * 1e3:.3f} ms")
    print(f"{tag} SpMM Execution Time: {t * 1e3:.6f} ms")
    print(f"{tag} Throughput: {2.0 * csr.nnz * K / t / 1e9:.3f} GFlops "
          "(2*nnz*K)")
    run = SpmmRun(rc=0, fmt=fmt, sd=sd, spmm_s=t)
    # row-scaled verification vs the float64 golden, capped: the host's
    # golden is O(nnz * K)
    if not args.no_verify and csr.nnz * K <= 2_000_000_000:
        Y = spmm(sd, Xd).cpu().numpy()
        A64 = sps.csr_matrix((csr.vals.astype(np.float64), csr.cols,
                              csr.rowptr), shape=csr.shape)
        gold = A64 @ X.astype(np.float64)
        scale = abs(A64) @ np.abs(X.astype(np.float64)) + 1e-30
        maxrel = float((np.abs(Y - gold) / scale).max()) if Y.size else 0.0
        run.verified, run.max_rel_err = maxrel < 1e-6, maxrel
        run.rc = 0 if run.verified else 1
        print(f"[file: {args.matrix}] Verification: "
              f"{'PASS' if run.verified else 'FAIL'} (max rel err "
              f"{maxrel:.2e})")
    return run


def cmd_info(args) -> int:
    from cvr_tpu_torch.formats.sell import sell_pack

    coo = _load(args.matrix, args.pattern_values)
    csr = coo.to_csr()
    lens = csr.row_lengths
    print(f"rows: {coo.shape[0]}  cols: {coo.shape[1]}  nnz: {coo.nnz}")
    print(
        f"row nnz: min {lens.min()}  mean {lens.mean():.2f}  "
        f"max {lens.max()}  empty {(lens == 0).sum()}"
    )
    sm = sell_pack(csr)
    print(
        f"sell-pack: C={sm.C} slices={sm.nslices} slots={sm.n_slots} "
        f"fill={sm.fill_ratio:.3f} splits={sm.n_splits} "
        f"convert={sm.convert_time * 1e3:.1f} ms"
    )
    # the hub-column capture verdict (formats/hot.py): would the routed
    # pack serve the hottest columns from the hot table?
    from cvr_tpu_torch.formats.hot import plan_hot

    plan = plan_hot(csr)
    if plan is not None:
        print(f"hot-column capture: ON at NH={plan[0]} "
              f"(predicted {plan[1] / 1e3:.0f} us/SpMV saving)")
    else:
        counts = np.bincount(csr.cols, minlength=csr.shape[1])
        top = int(np.sort(counts)[::-1][:1024].sum())
        print("hot-column capture: off (top-1024 columns cover "
              f"{top / max(csr.nnz, 1):.1%} of nnz; the gate's calibrated "
              "model predicts no net win)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cvr_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("matrix", help=".mtx file (optionally .gz)")
        p.add_argument(
            "--pattern-values", default="mod13", choices=["mod13", "ones"]
        )

    p = sub.add_parser("spmv", help="convert + SpMV benchmark + verify")
    common(p)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument(
        "--format", default="auto",
        choices=["auto", "sell-routed", "dia", "bell", "sell-window", "sell",
                 "csr", "bsr", "lane", "pmm"],
    )
    p.add_argument("--rhs", type=int, default=1, help="K for SpMM")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--no-verify", action="store_true")
    p.set_defaults(fn=cmd_spmv)

    p = sub.add_parser("info", help="matrix + packing statistics")
    common(p)
    p.set_defaults(fn=cmd_info)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
