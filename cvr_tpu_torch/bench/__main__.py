"""Headline benchmark: the routed SpMV on a web-Google-scale power-law
matrix, on the card.

    python -m cvr_tpu_torch.bench [--quick] [--impl sell-routed|sell-xla|csr]
                                  [--iters N] [--pack-repeats N]
                                  [--json-only] [--device cuda|cpu]

The port of the JAX package's root ``bench.py``, with its flags, defaults
and output: the greppable three-line report and its verification line on
stdout, the whole ``BenchResult`` as JSON on stderr (both left out under
``--json-only``), and as the last line of stdout ONE JSON object,

  {"metric": ..., "value": N, "unit": "GFLOPS", "vs_baseline": N}

``vs_baseline`` compares the 2*nnz GFLOPS with the reference CVR binary's
webGraph-domain average on its own hardware: 7.28 GFLOPS on a 68-core
Xeon Phi KNL (the CVR paper's Table 3; BASELINE.md), a 2018 CPU baseline.
The exit code is 1 only when y fails the float64 golden.

``--help`` works: bench.py's help for ``--pack-repeats`` holds an
unescaped "%", on which argparse raises; the port escapes it.
``--device`` (default cuda) is the port's, as every tool of the port has
it; without a card the default raises before any work, and the CPU runs
only when asked (``--device cpu``, a smoke run).  Before the report (and
not under ``--json-only``) stderr also gets the matrix's generation
seconds.

One deliberate difference: the timing protocol.  The JAX harness times a
dependent power iteration by the slope between two loop lengths; this
harness times back-to-back calls on one x with CUDA events
(``bench/harness.py`` ``time_iterations``).  The function timed is the
same; the clocks differ.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

# Reference: CVR webGraph domain average, 2*nnz GFLOPS (paper Table 3),
# measured by the CVR paper on a Xeon Phi KNL: a CPU number, not the
# port's.
CVR_KNL_WEBGRAPH_GFLOPS = 7.28


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="small matrix")
    ap.add_argument("--impl", default="sell-routed")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument(
        "--pack-repeats",
        type=int,
        default=1,
        help="pack timing = min over N repeats (first run also reported "
        "when N > 1).  Default 1 = one COLD pack, matching the reference "
        "protocol (spmv.cpp:575,1009 times a single conversion) so the "
        "amortize metric stays comparable to the paper's cold-pack 2.14; "
        "opt into min-over-N on this ±40%%-variance single-core host.",
    )
    ap.add_argument("--json-only", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a smoke run)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a CPU run")

    # Start faulting the allocator arena now, overlapped with matrix
    # generation (see cvr_tpu_torch/utils/memarena.py).
    from cvr_tpu_torch.utils import memarena

    memarena.warm()

    from cvr_tpu_torch.bench.harness import run_spmv_benchmark
    from cvr_tpu_torch.bench.synthetic import rmat_matrix, web_google_like

    t0 = time.perf_counter()
    if args.quick:
        coo = rmat_matrix(scale=13, edge_factor=8, seed=3)
        name = "rmat13"
        iters = args.iters or 200
    else:
        coo = web_google_like()
        name = "web-Google-like"
        iters = args.iters or 100
    if not args.json_only:
        print(f"[bench] {name}: {coo.shape[0]}x{coo.shape[1]}, {coo.nnz} "
              f"nnz, generated in {time.perf_counter() - t0:.3f} s",
              file=sys.stderr)

    r = run_spmv_benchmark(
        coo,
        name=name,
        impl=args.impl,
        iters=iters,
        pack_repeats=args.pack_repeats,
        device=args.device,
    )
    if not args.json_only:
        r.print_report()
        print(r.to_json(), file=sys.stderr)

    print(
        json.dumps(
            {
                "metric": f"SpMV GFLOPS (2*nnz) on {name}, {args.impl}",
                "value": round(r.gflops_2nnz, 3),
                "unit": "GFLOPS",
                "vs_baseline": round(
                    r.gflops_2nnz / CVR_KNL_WEBGRAPH_GFLOPS, 3
                ),
            }
        )
    )
    return 0 if (r.verified in (True, None)) else 1


if __name__ == "__main__":
    sys.exit(main())
