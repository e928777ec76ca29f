"""A configuration's matrix, made from its file and kept in the cache.

The configuration's ``generator`` names a file, ``generators/<name>.py``
(loaded by path, as a metric's reader is), that says how to make it:
``PARAMS``, the configuration's keys it takes, in order; ``make(*params)
-> (rows, cols, vals, n)``, a square n x n matrix, int32 / int32 /
float32 in CSR order with no duplicates; and ``TINY``, the keys that cut
a configuration to the size the tests run.  The configuration's
``expect`` entry gives the rows and stored entries it must come out
with.  The first run of a cell in a checkout makes the arrays and writes
them, uncompressed, under ``benchmark/cache/`` (a fixed place inside the
checkout, keyed by the generator and its parameters); later runs read
them back.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from benchmark import spec

CACHE = spec.HERE / "cache"
GENERATORS = spec.HERE / "generators"


@dataclass
class Matrix:
    """A square sparse matrix in CSR order: rows, cols int32 and vals
    float32 sorted by (row, col), no duplicates, and its row pointer."""

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    n: int

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def rowptr(self) -> np.ndarray:
        ptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(np.bincount(self.rows, minlength=self.n), out=ptr[1:])
        return ptr


def key(entry: dict) -> str:
    """A short digest of a JSON entry: the name of what it makes."""
    blob = json.dumps(entry, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def generator(name: str):
    """The module of ``generators/<name>.py``, loaded by path; a name
    with no such file raises ValueError."""
    path = GENERATORS / f"{name}.py"
    if "/" in name or name.startswith(".") or not path.is_file():
        raise ValueError(f"unknown generator {name!r}")
    return spec.by_path(path, "generator")


def params(config: dict) -> dict:
    """The generator and the parameters it takes, from a config."""
    gen = config["generator"]
    return {"generator": gen,
            **{k: config[k] for k in generator(gen).PARAMS}}


def make(config: dict) -> Matrix:
    """Generate the matrix that a config names, held to the generator's
    contract: int32 rows and columns, float32 values, square, in CSR
    order with no duplicates."""
    name = config["generator"]
    gen = generator(name)
    rows, cols, vals, n = gen.make(*(config[k] for k in gen.PARAMS))
    m = Matrix(rows, cols, vals, int(n))
    if not (rows.dtype == cols.dtype == np.int32 and vals.dtype == np.float32
            and rows.shape == cols.shape == vals.shape):
        raise ValueError(f"{name}: arrays of "
                         f"{rows.dtype}/{cols.dtype}/{vals.dtype}")
    if m.nnz and not (0 <= rows.min() and rows.max() < m.n
                      and 0 <= cols.min() and cols.max() < m.n):
        raise ValueError(f"{name}: an index outside {m.n} x {m.n}")
    dr, dc = np.diff(rows), np.diff(cols)
    if not np.all((dr > 0) | ((dr == 0) & (dc > 0))):
        raise ValueError(f"{name}: not in CSR order, or a "
                         "duplicate entry")
    return m


def cache_dir(config: dict, cache: Path = CACHE) -> Path:
    return cache / f"{config['name']}-{key(params(config))}"


def load(config: dict, cache: Path = CACHE) -> tuple[Matrix, bool]:
    """(the config's matrix, whether it was generated now): read from the
    cache, or generated, checked against ``expect`` and written there
    (whole, then renamed into place)."""
    d = cache_dir(config, cache)
    if (d / "vals.npy").exists():
        arrs = [np.load(d / f"{k}.npy") for k in ("rows", "cols", "vals")]
        return Matrix(*arrs, n=int(np.load(d / "n.npy"))), False
    m = make(config)
    want = config["expect"]
    if (m.n, m.nnz) != (want["rows"], want["nnz"]):
        raise RuntimeError(f"{config['name']}: made {m.n} rows, {m.nnz} "
                           f"stored entries; expected {want}")
    tmp = d.with_name(d.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    for k in ("rows", "cols", "vals"):
        np.save(tmp / f"{k}.npy", getattr(m, k))
    np.save(tmp / "n.npy", np.int64(m.n))
    # other keys of this config are stale: keep one matrix a config
    for old in cache.glob(f"{config['name']}-*"):
        if old != tmp:
            shutil.rmtree(old, ignore_errors=True)
    os.replace(tmp, d)
    return m, True
