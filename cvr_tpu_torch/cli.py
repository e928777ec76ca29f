"""Command-line entry point of the port.

  python -m cvr_tpu_torch.cli spmv <file.mtx> [--iters N]
      [--format sell-routed|csr] [--device cuda|cpu] [--no-verify]
  python -m cvr_tpu_torch.cli info <file.mtx>

``spmv`` converts, runs the timed SpMV iterations, verifies against the
float64 golden and prints the greppable report.
"""

from __future__ import annotations

import argparse
import sys
import time


def _load(path: str, pattern_values: str):
    from cvr_tpu_torch.io.mmio import read_matrix_market

    t0 = time.perf_counter()
    coo = read_matrix_market(path, pattern_values=pattern_values)
    print(
        f"[file: {path}] read {coo.shape[0]}x{coo.shape[1]}, "
        f"{coo.nnz} nnz in {time.perf_counter() - t0:.2f}s"
    )
    return coo


def cmd_spmv(args) -> int:
    from cvr_tpu_torch.bench.harness import run_spmv_benchmark

    coo = _load(args.matrix, args.pattern_values)
    r = run_spmv_benchmark(
        coo,
        name=args.matrix,
        impl=args.format,
        iters=args.iters,
        device=args.device,
        verify_result=not args.no_verify,
    )
    r.print_report()
    return 0 if r.verified in (True, None) else 1


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
        "--format", default="sell-routed", choices=["sell-routed", "csr"]
    )
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
