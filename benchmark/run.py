#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout of the repository, on a machine with the
CUDA cards the cell asks for.  The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, then ``compared``: each number
compared with its limit); the last lines of standard error repeat the
compared numbers.  Without the cards, or where jax or the JAX package
was loaded, it prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _since_start() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _since_start()
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import runner

    try:
        result = runner.run(args.workload, args.seed, args.seconds,
                            bool(args.trace), T_START, root=ROOT)
    except runner.NoDevice as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except runner.TraceMismatch as e:
        print(f"error: {e}", file=sys.stderr)
        return 4
    found = runner.forbidden_modules()
    if found:
        print(f"error: the run loaded {found}", file=sys.stderr)
        return 3
    return runner.emit(result)


if __name__ == "__main__":
    sys.exit(main())
