"""Command-line entry point of the port.

  python -m cvr_tpu_torch.cli spmv <file.mtx> [--iters N]
      [--format auto|bell|bsr|dia|lane|pmm|routed|sell-routed|window
                |sell-window|sell|csr]
      [--rhs K] [--c C] [--sigma S] [--no-verify]
      [--save-packed out.npz] [--load-packed in.npz] [--device cuda|cpu]
  python -m cvr_tpu_torch.cli compare <file.mtx> [--iters N] [--rhs K]
  python -m cvr_tpu_torch.cli info <file.mtx>

Every subcommand also takes ``--threads`` (accepted and ignored, as in
the reference's command line), ``--pattern-values`` and ``--device``
(``cuda``, the default, or ``cpu``).

``spmv`` converts (``--format auto``, the default: the format
``pack_auto`` picks, as the JAX package's CLI does), runs the timed SpMV
iterations, verifies against the float64 golden and prints the greppable
report.  ``--save-packed`` then writes the format's packed artifact in
the JAX package's ``.npz`` layout; ``--load-packed`` runs the SpMV from
such a file (written by either package) in place of the conversion, the
kind sniffed from its keys under ``--format auto``.  With ``--rhs K`` > 1
it runs the SpMM Y = A @ X with X all ones (K columns) instead: ``auto``
tries BSR-128 first, then ``pack_auto``'s format, with the PMM and lane
paths for matrices that ``pack_auto`` sends to the routed path where the
JAX package's gate picks them.  ``compare`` runs the six SpMV impls (with
``--rhs K``, the eight SpMM formats) on one matrix, each report labelled
by impl, then the best; a format that refuses the matrix prints
``[impl] failed: ...`` and the comparison goes on.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from cvr_tpu_torch.formats.bell import BellInfeasible
from cvr_tpu_torch.formats.bsr import BsrInfeasible
from cvr_tpu_torch.formats.dia import DiaInfeasible
from cvr_tpu_torch.formats.sell_window import WindowInfeasible

# A format's refusal of a matrix: ``compare`` prints it and goes on.
# Anything else (a kernel that does not build or launch, a bad artifact)
# ends the run.
REFUSALS = (DiaInfeasible, BellInfeasible, WindowInfeasible, BsrInfeasible)


def _load(path: str, pattern_values: str):
    from cvr_tpu_torch.io.mmio import read_matrix_market

    t0 = time.perf_counter()
    coo = read_matrix_market(path, pattern_values=pattern_values)
    print(
        f"[file: {path}] read {coo.shape[0]}x{coo.shape[1]}, "
        f"{coo.nnz} nnz in {time.perf_counter() - t0:.2f}s"
    )
    return coo


# --format's other names
FORMAT_ALIASES = {"routed": "sell-routed", "window": "sell-window"}
# --format -> the bench harness's impl
_SPMV_IMPL = {"sell": "sell-xla"}
# the SpMM-only formats
_SPMM_ONLY = ("bsr", "lane", "pmm")


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for a CPU run")
    return dev


def cmd_spmv(args) -> int:
    from cvr_tpu_torch.bench.harness import run_spmv_benchmark

    coo = _load(args.matrix, args.pattern_values)
    if args.rhs > 1:
        return _spmm(args, coo).rc
    if args.format in _SPMM_ONLY:
        print(
            f"error: --format {args.format} is an SpMM format; use it with "
            "--rhs K > 1",
            file=sys.stderr,
        )
        return 2
    if args.load_packed:
        return _spmv_prepacked(args, coo)
    fmt = FORMAT_ALIASES.get(args.format, args.format)
    impl = _SPMV_IMPL.get(fmt, fmt)
    r = run_spmv_benchmark(
        coo,
        name=args.matrix,
        impl=impl,
        iters=args.iters,
        C=args.c,
        sigma=args.sigma,
        device=args.device,
        verify_result=not args.no_verify,
    )
    r.print_report()
    if args.save_packed:
        from cvr_tpu_torch.bench.harness import pack_impl

        # the format's artifact; the plain SELL planes for "csr", as in
        # the JAX package's CLI
        t0 = time.perf_counter()
        packed, _ = pack_impl(coo.to_csr(),
                              "sell-xla" if impl == "csr" else impl,
                              args.c, args.sigma)
        pack_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        save_packed(packed, args.save_packed)
        save_s = time.perf_counter() - t0
        mb = os.path.getsize(args.save_packed) / 1e6
        print(f"packed artifact saved to {args.save_packed} (pack "
              f"{pack_s:.3f} s, save {save_s:.3f} s, {mb:.3f} MB)")
    return 0 if r.verified in (True, None) else 1


def save_packed(A, path) -> None:
    """Write any packed artifact of the port in the JAX package's
    ``.npz`` layout, by its type's save."""
    from cvr_tpu_torch.formats.bell import BellMatrix, save_bell
    from cvr_tpu_torch.formats.sell_routed import SellRouted, save_routed
    from cvr_tpu_torch.ops.spmm_lane import LanePlan, save_lane
    from cvr_tpu_torch.ops.spmm_pmm import PmmPlan, save_pmm

    for kind, save in ((SellRouted, save_routed), (BellMatrix, save_bell),
                       (LanePlan, save_lane), (PmmPlan, save_pmm)):
        if isinstance(A, kind):
            return save(A, path)
    return A.save(path)


def sniff_packed(path) -> str:
    """The artifact kind of a saved ``.npz``, from its keys, in the JAX
    CLI's order (a file with none of its keys is the plain SELL planes),
    the SpMM plans' kinds after them."""
    keys = set(np.load(path).files)
    for key, kind in (("bell_meta", "bell"), ("mid_kind", "sell-routed"),
                      ("bands", "dia"), ("w10", "sell-window"),
                      ("lane_meta", "lane"), ("pmm_meta", "pmm"),
                      ("brick_col", "bsr")):
        if key in keys:
            return kind
    return "sell"


def load_packed(path, fmt: str = "auto"):
    """(kind, artifact) of a file that either package saved: ``fmt`` names
    its kind (a --format name), "auto" sniffs it (sniff_packed)."""
    from cvr_tpu_torch.formats.bell import load_bell
    from cvr_tpu_torch.formats.bsr import BsrMatrix
    from cvr_tpu_torch.formats.dia import DiaMatrix
    from cvr_tpu_torch.formats.sell import SellMatrix
    from cvr_tpu_torch.formats.sell_routed import load_routed
    from cvr_tpu_torch.formats.sell_window import SellWindow
    from cvr_tpu_torch.ops.spmm_lane import load_lane
    from cvr_tpu_torch.ops.spmm_pmm import load_pmm

    kind = FORMAT_ALIASES.get(fmt, fmt)
    if kind == "auto":
        kind = sniff_packed(path)
    load = {"bell": load_bell, "sell-routed": load_routed,
            "dia": DiaMatrix.load, "sell-window": SellWindow.load,
            "lane": load_lane, "pmm": load_pmm,
            "bsr": BsrMatrix.load}.get(kind, SellMatrix.load)
    return kind, load(path)


def _spmv_prepacked(args, coo) -> int:
    """The SpMV from a saved packed artifact, in place of the conversion:
    load, check the shape, upload, the timed iterations, the report (its
    pre-processing time 0, with the load and upload seconds on a line
    before it), and the float64 verify."""
    from cvr_tpu_torch.bench.harness import time_iterations
    from cvr_tpu_torch.ops.spmv import spmv, upload
    from cvr_tpu_torch.ops.spmv_ref import (
        spmv_golden_numpy,
        spmv_row_scale,
        verify,
    )

    dev = _device(args.device)
    t0 = time.perf_counter()
    kind, A = load_packed(args.load_packed, args.format)
    load_s = time.perf_counter() - t0
    if kind in _SPMM_ONLY:
        print(f"error: {args.load_packed} holds a {kind} plan, an SpMM "
              "artifact", file=sys.stderr)
        return 2
    if tuple(A.shape) != tuple(coo.shape):
        print("packed artifact shape mismatch")
        return 1
    t0 = time.perf_counter()
    sd = upload(A, dev)
    del A
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    upload_s = time.perf_counter() - t0
    x = np.ones(coo.shape[1], dtype=np.float32)
    xd = torch.from_numpy(x).to(dev)
    t = time_iterations(lambda: spmv(sd, xd), args.iters, dev)
    tag = f"[file: {args.matrix}]"
    print(f"{tag} [packed: {args.load_packed}] [format: {kind}] load "
          f"{load_s:.3f} s, upload {upload_s:.3f} s")
    print(f"{tag} [packed: {args.load_packed}] Pre-processing Time: 0.000 ms "
          "(loaded artifact)")
    print(f"{tag} SpMV Execution Time: {t * 1e3:.6f} ms")
    print(f"{tag} Throughput: {2 * coo.nnz / t / 1e9:.3f} GFlops (2*nnz)")
    if args.no_verify:
        return 0
    csr = coo.to_csr()
    ok, nbad, maxrel = verify(spmv(sd, xd).cpu().numpy(),
                              spmv_golden_numpy(csr, x), rtol=1e-6,
                              row_scale=spmv_row_scale(csr, x))
    print(f"{tag} Verification: "
          + (f"PASS (max rel err {maxrel:.2e})" if ok
             else f"FAIL ({nbad} rows)"))
    return 0 if ok else 1


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


def spmm_pick(fmt: str, coo, K: int, C: int | None = None, sigma: int = 0):
    """(format name, packed host artifact) that ``spmv --rhs K --format
    fmt`` runs, picked as the JAX package's CLI picks them; ``sell`` and
    ``csr`` pack the plain SELL planes at slice height C (default 1024)
    and sort window sigma, as ``--c`` and ``--sigma`` give them.  Raises
    BsrInfeasible for --format bsr where the bricks are refused."""
    from cvr_tpu_torch.formats import pack_auto
    from cvr_tpu_torch.formats.bell import BellMatrix, bell_pack
    from cvr_tpu_torch.formats.bsr import bsr_pack
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
    return "sell", sell_pack(csr, C=C or 1024, sigma=sigma)


def _spmm(args, coo, refusals=()) -> SpmmRun:
    """The SpMM of ``spmv --rhs K``: pick and pack (timed), upload, the
    timed iterations of Y = A @ X with X all ones, the three-line report,
    and the float64 verify where nnz * K <= 2e9.  A format's refusal
    among ``refusals`` propagates (``compare``); --format bsr's refusal
    otherwise exits 2."""
    import scipy.sparse as sps

    from cvr_tpu_torch.bench.harness import time_iterations
    from cvr_tpu_torch.ops.spmv import spmm, upload

    dev = _device(args.device)
    K = args.rhs
    csr = coo.to_csr()
    t0 = time.perf_counter()
    try:
        fmt, packed = spmm_pick(FORMAT_ALIASES.get(args.format, args.format),
                                coo, K, C=args.c, sigma=args.sigma)
    except refusals:
        raise
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


def cmd_compare(args) -> int:
    """Every SpMV impl on one matrix, each report labelled by impl, then
    the best (with --rhs K > 1: the eight SpMM formats).  A format that
    refuses the matrix (REFUSALS) prints ``[impl] failed: ...`` and the
    comparison goes on; any other error ends it, and a result that fails
    its golden makes the exit code 1."""
    from cvr_tpu_torch.bench.harness import run_spmv_benchmark

    coo = _load(args.matrix, args.pattern_values)
    rc = 0
    if args.rhs > 1:
        for fmt in ("bsr", "dia", "bell", "lane", "pmm", "routed", "window",
                    "sell"):
            sub = argparse.Namespace(**{**vars(args), "format": fmt})
            try:
                rc = max(rc, _spmm(sub, coo, REFUSALS).rc)
            except REFUSALS as e:
                print(f"[{fmt}] failed: {type(e).__name__}: {e}")
        return rc
    results = []
    for impl in ("csr", "sell-xla", "sell-routed", "sell-window", "dia",
                 "bell"):
        try:
            r = run_spmv_benchmark(coo, name=args.matrix, impl=impl,
                                   iters=args.iters, device=args.device)
        except REFUSALS as e:
            print(f"[{impl}] failed: {type(e).__name__}: {e}")
            continue
        r.print_report(threads_label=impl)
        results.append(r)
        rc = rc if r.verified else 1
    if results:
        best = max(results, key=lambda r: r.gflops_2nnz)
        print(f"Best: {best.impl} at {best.gflops_2nnz:.3f} GFlops (2*nnz)")
    return rc


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
        p.add_argument("--iters", type=int, default=100)
        p.add_argument("--threads", type=int, default=None,
                       help="ignored; reference-CLI compatibility")
        p.add_argument(
            "--pattern-values", default="mod13", choices=["mod13", "ones"]
        )
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    p = sub.add_parser("spmv", help="convert + SpMV benchmark + verify")
    common(p)
    p.add_argument(
        "--format", default="auto",
        choices=["auto", "bell", "bsr", "dia", "lane", "pmm", "routed",
                 "sell-routed", "window", "sell-window", "sell", "csr"],
    )
    p.add_argument("--rhs", type=int, default=1, help="K for SpMM")
    p.add_argument("--c", type=int, default=None, help="SELL lane count")
    p.add_argument("--sigma", type=int, default=0, help="sort window")
    p.add_argument("--no-verify", action="store_true")
    p.add_argument("--save-packed", default=None)
    p.add_argument("--load-packed", default=None)
    p.set_defaults(fn=cmd_spmv)

    p = sub.add_parser("compare", help="all impls on one matrix")
    common(p)
    p.add_argument("--rhs", type=int, default=1,
                   help="K > 1 compares the SpMM formats instead")
    p.add_argument("--c", type=int, default=None)
    p.add_argument("--sigma", type=int, default=0)
    p.add_argument("--no-verify", action="store_true")
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("info", help="matrix + packing statistics")
    common(p)
    p.set_defaults(fn=cmd_info)
    return ap


def main(argv=None) -> int:
    from cvr_tpu_torch.utils import memarena

    args = build_parser().parse_args(argv)
    # warm the allocator arena only where first touch is slow (lazily
    # backed VMs); any other host would pay for a pointless sweep
    memarena.warm_if_lazy()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
