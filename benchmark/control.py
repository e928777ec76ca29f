#!/usr/bin/env python3
"""Run a cell with the control in the program's place.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13
        [--seconds 3]

For each seed, one run of the cell by the harness's own ``runner.run``,
with the program's set-up and product replaced by the control: the
plain reference one precision lower (TF32 inputs, float32 sums;
``reference.control``) on the matrix the benchmark made, at the cell's
own sizes and load.  The harness's own comparison decides ``correct``;
the control has to come out not correct on every seed.  Prints each
run's result line with the seed.  It does not run the program.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def put_in_place(program, mx, reference) -> None:
    """Replace the program's set-up and product, on the ``program``
    module the runner calls, by the control's."""
    import torch

    def set_up(config, op, K, device, spans, cache=mx.CACHE):
        m, _ = mx.load(config, cache)
        rows, cols = (torch.from_numpy(a).to(device, torch.int64)
                      for a in (m.rows, m.cols))
        vals = torch.from_numpy(m.vals).to(device)
        return (rows, cols, vals, m.n), m

    def product(op):
        return lambda sd, X: reference.control(sd[0], sd[1], sd[2], X,
                                               sd[3])

    program.set_up = set_up
    program.product = product


def main(argv=None) -> int:
    import argparse

    from benchmark import matrix as mx
    from benchmark import program, reference, runner

    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    put_in_place(program, mx, reference)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = runner.run(args.workload, seed, args.seconds, False,
                       time.perf_counter(), device=args.device, root=ROOT)
        r.pop("_context", None)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": r["correct"],
                          "attempted": r["attempted"],
                          "failed": r["failed"],
                          "compared": r["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
