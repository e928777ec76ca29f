"""Result logging: the append-only CSV and JSONL of benchmark rows.

Every sweep row is appended to a CSV (header written when the file is
new) and a JSONL file, so that sweeps are machine-consumable.  The CSV
carries the JAX package's columns in its order (``cvr_tpu.utils.report``)
and then the ones the port's BenchResult adds; the JSONL line is the whole
BenchResult, the JAX package's fields first.

The defaults are files of the port's own (``results_h100.*``): the
repository's ``results*.csv`` / ``results*.jsonl`` hold the JAX package's
TPU runs.
"""

from __future__ import annotations

import csv
import json
import os
from dataclasses import asdict
from pathlib import Path

# the JAX package's columns, in its order
REFERENCE_FIELDS = [
    "name",
    "impl",
    "nnz",
    "padded_nnz",
    "preproc_s",
    "spmv_s",
    "iters",
    "gflops_2nnz",
    "gnnz_per_s",
    "roofline_frac",
    "amortize_iters",
    "verified",
    "max_rel_err",
    "nrows",
    "ncols",
]
# and the port's: the device the row was measured on
FIELDS = [*REFERENCE_FIELDS, "device"]

DEFAULT_CSV = "results_h100.csv"
DEFAULT_JSONL = "results_h100.jsonl"


def append_result(result, csv_path: str | os.PathLike = DEFAULT_CSV):
    """Append a BenchResult row (creates the file with a header)."""
    path = Path(csv_path)
    d = asdict(result)
    new = not path.exists()
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS, extrasaction="ignore")
        if new:
            w.writeheader()
        w.writerow(d)


def append_jsonl(result, path: str | os.PathLike = DEFAULT_JSONL):
    """Append a BenchResult as one JSON line."""
    with open(path, "a") as f:
        f.write(json.dumps(asdict(result)) + "\n")
