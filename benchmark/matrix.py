"""A configuration's matrix, made from its file and kept in the cache.

The configuration's ``generator`` and its parameters say how to make it
(``graph500``: ``scale``, ``edgefactor``, the initiator ``A``, ``B``,
``C`` and the ``seed``); its ``expect`` entry the rows and stored
entries it must come out with.  The first run of a cell in a checkout
makes the arrays and writes them, uncompressed, under
``benchmark/cache/`` (a fixed place inside the checkout, keyed by the
parameters); later runs read them back.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from benchmark import rmat

CACHE = Path(__file__).resolve().parent / "cache"


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


GENERATORS = {"graph500": ("scale", "edgefactor", "A", "B", "C", "seed")}


def params(config: dict) -> dict:
    """The generator and the parameters it takes, from a config."""
    gen = config["generator"]
    if gen not in GENERATORS:
        raise ValueError(f"unknown generator {gen!r}")
    return {"generator": gen, **{k: config[k] for k in GENERATORS[gen]}}


def make(config: dict) -> Matrix:
    """Generate the matrix that a config names."""
    p = params(config)
    rows, cols, vals = rmat.graph500(*(p[k] for k in GENERATORS["graph500"]))
    return Matrix(rows, cols, vals, 1 << p["scale"])


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
