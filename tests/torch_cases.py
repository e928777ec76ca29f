"""Matrices the port's tests build twice, once per package, from one seed.

Each builder returns (cvr_tpu COO, cvr_tpu_torch COO) holding the same
arrays.
"""

from pathlib import Path

import numpy as np

from cvr_tpu.bench import synthetic as jsyn
from cvr_tpu.formats.coo import COOMatrix as JCOO

from cvr_tpu_torch.bench import synthetic as tsyn
from cvr_tpu_torch.formats.coo import COOMatrix as TCOO

FIXTURES = sorted((Path(__file__).parent / "fixtures").glob("*.mtx*"))


def pair(rows, cols, vals, shape):
    return (
        JCOO(rows=rows, cols=cols, vals=vals, shape=shape),
        TCOO(rows=rows, cols=cols, vals=vals, shape=shape),
    )


def powerlaw(n=3000, avg_nnz=6, alpha=1.8, seed=2):
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(alpha, size=n), n)
    deg = np.minimum((deg * (avg_nnz / deg.mean())).astype(np.int64), n)
    rows = np.repeat(np.arange(n, dtype=np.int32), deg)
    cols = rng.integers(0, n, size=rows.shape[0]).astype(np.int32)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    j, t = pair(rows, cols, vals, (n, n))
    return j.sum_duplicates(), t.sum_duplicates()


def rmat(scale, edge_factor, seed):
    return (
        jsyn.rmat_matrix(scale=scale, edge_factor=edge_factor, seed=seed,
                         cache=False),
        tsyn.rmat_matrix(scale=scale, edge_factor=edge_factor, seed=seed),
    )


def banded(n=3000, bandwidth=9, seed=0):
    return (
        jsyn.banded_matrix(n=n, bandwidth=bandwidth, seed=seed),
        tsyn.banded_matrix(n=n, bandwidth=bandwidth, seed=seed),
    )


def fsm(n=1 << 15, seed=19):
    return (
        jsyn.fsm_like(n=n, seed=seed),
        tsyn.fsm_like(n=n, seed=seed),
    )


def tall_sparse(n=1_100_000, nnz=1_400_000, seed=12):
    """Just over 1,048,576 rows with ~1.3 nnz per row: a y-route of 2048
    tiles at a CPU-test size."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    j, t = pair(rows, cols, vals, (n, n))
    return j.sum_duplicates(), t.sum_duplicates()


def same_arrays(t):
    """A port COO and a cvr_tpu COO built from its arrays."""
    j = JCOO(rows=t.rows, cols=t.cols, vals=t.vals, shape=t.shape)
    return j.sum_duplicates(), t


def empty_rows_cols():
    return same_arrays(tsyn.empty_rows_cols())


def uniform_rows():
    return same_arrays(tsyn.uniform_rows())


def multisegment(seed=9):
    return same_arrays(tsyn.multisegment(seed=seed))


CASES = {
    "powerlaw": (powerlaw, None),
    "banded": (banded, None),
    "rmat_split16": (lambda: rmat(10, 12, 5), 16),
    "empty_rows_cols": (empty_rows_cols, 16),
    "uniform_w16": (uniform_rows, None),
    "rmat_T2048": (lambda: rmat(17, 8, 4), None),
    "multisegment": (multisegment, None),
}
