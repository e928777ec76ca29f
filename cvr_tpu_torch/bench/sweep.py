"""Benchmark sweep: every impl over a suite of matrices on the card.

Runs each implementation over a suite (MatrixMarket files or the
synthetic generators), appends each result to a CSV and a JSONL file of
the port's own (``results_h100.csv`` / ``.jsonl`` by default: the
repository's ``results*.csv`` hold the JAX package's TPU runs), prints the
greppable per-run report, a ``FAILED`` line for a run that raised, and a
summary table.  The suites and flags are the JAX package's
``scripts/sweep.py``'s, with ``--device``.

Usage:
  python -m cvr_tpu_torch.bench.sweep                  # default suite
  python -m cvr_tpu_torch.bench.sweep --mtx a.mtx b.mtx
  python -m cvr_tpu_torch.bench.sweep --full           # the CGO'18 suite
  python -m cvr_tpu_torch.bench.sweep --iters 200 --impls sell-xla,csr
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from cvr_tpu_torch.utils.report import DEFAULT_CSV


def default_suite():
    """Synthetic stand-ins for the CGO'18 suite's domains: a web graph, a
    denser social power law and an HPC band stencil."""
    from cvr_tpu_torch.bench.synthetic import banded_matrix, rmat_matrix

    return [
        ("rmat16-web", lambda: rmat_matrix(scale=16, edge_factor=6, seed=1)),
        ("rmat16-social",
         lambda: rmat_matrix(scale=16, edge_factor=16, seed=2)),
        ("banded-1M", lambda: banded_matrix(1 << 20, bandwidth=27)),
    ]


def real_or(name, group, fallback):
    """A loader of the SuiteSparse matrix ``group/name`` from the local
    cache (io/suitesparse.py) where it is there, else of the synthetic
    stand-in ``fallback``."""
    def load():
        try:
            from cvr_tpu_torch.io.suitesparse import load_suitesparse

            return load_suitesparse(name, group=group)
        except FileNotFoundError:
            return fallback()
    return load


def cgo18_suite():
    """Full-scale stand-ins for the eight CGO'18 headline domains, two
    structurally distinct matrices each (the domain's score is the least
    of its matrices', bench/parity.py), then banded-2M.  CVR's domain
    averages on the KNL 7250 (2*nnz GFLOPS): webGraph 7.28, social 6.59,
    wiki 5.77, citation 6.26, road 9.57, routing 17.11, FSM 8.09, EngSci
    21.11."""
    from cvr_tpu_torch.bench.synthetic import (
        banded_matrix,
        citation_like,
        citation_like_b,
        fem_like,
        fem_like_b,
        fsm_like,
        fsm_like_b,
        rgg_like,
        rgg_like_b,
        road_usa_like,
        road_usa_like_b,
        soc_livejournal_like,
        soc_livejournal_like_b,
        web_google_like,
        web_google_like_b,
        wiki_talk_like,
        wiki_talk_like_b,
    )

    return [
        ("web-Google-like", real_or("web-Google", "SNAP", web_google_like)),
        ("web-rmat-b", web_google_like_b),
        ("soc-LJ-like",
         real_or("soc-LiveJournal1", "SNAP", soc_livejournal_like)),
        ("soc-rmat-b", soc_livejournal_like_b),
        ("wiki-Talk-like", real_or("wiki-Talk", "SNAP", wiki_talk_like)),
        ("wiki-hub-b", wiki_talk_like_b),
        ("citation-like", real_or("cit-Patents", "SNAP", citation_like)),
        ("citation-b", citation_like_b),
        ("road-usa-like", real_or("road_usa", "DIMACS10", road_usa_like)),
        ("road-b", road_usa_like_b),
        ("rgg-like", rgg_like),
        ("rgg-b", rgg_like_b),
        ("fsm-like", fsm_like),
        ("fsm-b", fsm_like_b),
        ("fem-like", fem_like),
        ("fem-b", fem_like_b),
        ("banded-2M", lambda: banded_matrix(1 << 21, bandwidth=27)),
    ]


def run_suite(suite, impls, iters: int = 50, out: str | Path = DEFAULT_CSV,
              pack_repeats: int = 1, device="cuda"):
    """Each impl over each (name, loader) of ``suite``: the report lines,
    the CSV row (``out``) and the JSONL row (``out`` with a .jsonl
    suffix) of each run, or its FAILED line where it raised (the sweep
    goes on).  Returns the BenchResults of the runs that finished."""
    from cvr_tpu_torch.bench.harness import run_spmv_benchmark
    from cvr_tpu_torch.utils.report import append_jsonl, append_result

    rows = []
    for name, load in suite:
        coo = load()
        for impl in impls:
            try:
                r = run_spmv_benchmark(
                    coo, name=name, impl=impl, iters=iters,
                    pack_repeats=pack_repeats, device=device,
                )
            except Exception as e:  # noqa: BLE001 (the sweep goes on)
                print(f"[{name}/{impl}] FAILED: {type(e).__name__}: {e}")
                continue
            r.print_report(threads_label=impl)
            append_result(r, out)
            append_jsonl(r, Path(out).with_suffix(".jsonl"))
            rows.append(r)
        del coo
    return rows


def summary(rows) -> str:
    """The closing table: GFLOPS (2*nnz), pack ms and verdict a run."""
    lines = ["", "=== summary (GFLOPS 2*nnz) ==="]
    for r in rows:
        v = "PASS" if r.verified else ("n/a" if r.verified is None
                                       else "FAIL")
        lines.append(
            f"{r.name:16s} {r.impl:12s} {r.gflops_2nnz:10.3f}  "
            f"preproc {r.preproc_s * 1e3:9.1f} ms  verify {v}"
        )
    return "\n".join(lines)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mtx", nargs="*", default=None)
    ap.add_argument("--impls", default="auto,sell-xla,csr")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", default=DEFAULT_CSV,
                    help="CSV to append to (JSONL beside it, .jsonl)")
    ap.add_argument(
        "--full", action="store_true", help="full-scale CGO'18 suite"
    )
    ap.add_argument(
        "--pack-repeats",
        type=int,
        default=1,
        help="pack timing = min over N in-process repeats "
        "(first run also recorded; see bench harness)",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a smoke run)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    from cvr_tpu_torch.io.mmio import read_matrix_market
    from cvr_tpu_torch.utils import memarena

    memarena.warm()
    if args.mtx:
        suite = [(p, (lambda p=p: read_matrix_market(p))) for p in args.mtx]
    elif args.full:
        suite = cgo18_suite()
    else:
        suite = default_suite()
    rows = run_suite(suite, args.impls.split(","), iters=args.iters,
                     out=args.out, pack_repeats=args.pack_repeats,
                     device=args.device)
    if rows:
        print(summary(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
