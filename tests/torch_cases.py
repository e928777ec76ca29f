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


def multisegment_tail(seed=9):
    """4000 x 1,300,000 with every entry in columns >= 1,140,000: the
    second x segment only, and at 8 row shards the last ring piece only,
    so real tile blocks expand at ring steps whose table starts at
    segment 1."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 4000, 40_000).astype(np.int32)
    cols = rng.integers(1_140_000, 1_300_000, 40_000).astype(np.int32)
    vals = rng.standard_normal(40_000).astype(np.float32)
    j, t = pair(rows, cols, vals, (4000, 1_300_000))
    return j.sum_duplicates(), t.sum_duplicates()


CASES = {
    "powerlaw": (powerlaw, None),
    "banded": (banded, None),
    "rmat_split16": (lambda: rmat(10, 12, 5), 16),
    "empty_rows_cols": (empty_rows_cols, 16),
    "uniform_w16": (uniform_rows, None),
    "rmat_T2048": (lambda: rmat(17, 8, 4), None),
    "multisegment": (multisegment, None),
}


def rgg(n=20000, reach=48, seed=3):
    return (
        jsyn.rgg_like(n=n, reach=reach, seed=seed),
        tsyn.rgg_like(n=n, reach=reach, seed=seed),
    )


def road(n=1 << 17, reach=48, seed=17):
    return (
        jsyn.road_usa_like(n=n, reach=reach, seed=seed),
        tsyn.road_usa_like(n=n, reach=reach, seed=seed),
    )


def fem(n=1 << 15, deg=54, bw=150, seed=23):
    return (
        jsyn.fem_like(n=n, deg=deg, bw=bw, seed=seed),
        tsyn.fem_like(n=n, deg=deg, bw=bw, seed=seed),
    )


def diagonals(nrows, ncols, offsets, seed=4):
    """Dense diagonals at ``offsets`` of an nrows x ncols matrix."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in offsets:
        r = np.arange(max(0, -off), min(nrows, ncols - off))
        rows.append(r)
        cols.append(r + off)
    rows = np.concatenate(rows).astype(np.int32)
    cols = np.concatenate(cols).astype(np.int32)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return pair(rows, cols, vals, (nrows, ncols))


def window_rect(seed=6):
    """A wide band (~0.6 rows per column: 8000 x 13000), 12 nnz per row."""
    rng = np.random.default_rng(seed)
    nrows, ncols = 8000, 13000
    rows = np.repeat(np.arange(nrows), 12)
    cols = np.clip(rows * 13 // 8 + rng.integers(-200, 200, rows.shape[0]),
                   0, ncols - 1)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    j, t = pair(rows.astype(np.int32), cols.astype(np.int32), vals,
                (nrows, ncols))
    return j.sum_duplicates(), t.sum_duplicates()


def window_empty_rows(seed=8):
    """A band with every third block of 2048 rows empty: zero-width
    slices, and whole zero-width reduce groups at YB 2."""
    j, t = fem(n=1 << 14, deg=10, bw=100, seed=seed)
    keep = (t.rows // 2048) % 3 != 1
    return pair(t.rows[keep], t.cols[keep], t.vals[keep], t.shape)


# SELL-W packs, each reaching one geometry: builder, segw (None: default)
WINDOW_CASES = {
    "fem_D2": (fem, None),
    "banded_D2_wrl7": (lambda: banded(20000, 9), None),
    "W2048_wrl15": (lambda: fem(n=1 << 14, deg=8, bw=400), None),
    "segw2": (lambda: fem(n=1 << 13, deg=10, bw=100), 2),
    "rectangular": (window_rect, None),
    "empty_rows": (window_empty_rows, None),
}


def random_rect(nrows=500, ncols=700, density=0.03, seed=4):
    """Uniformly scattered entries of a rectangular matrix."""
    rng = np.random.default_rng(seed)
    nnz = int(nrows * ncols * density)
    rows = rng.integers(0, nrows, nnz).astype(np.int32)
    cols = rng.integers(0, ncols, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    j, t = pair(rows, cols, vals, (nrows, ncols))
    return j.sum_duplicates(), t.sum_duplicates()


def empty_blocks(seed=6):
    """900 x 1000 with rows 0-127 and 640-899 empty: whole empty row
    blocks (BSR) and row tiles (PMM) at both ends."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(128, 640, 3000).astype(np.int32)
    cols = rng.integers(0, 1000, 3000).astype(np.int32)
    vals = rng.standard_normal(3000).astype(np.float32)
    j, t = pair(rows, cols, vals, (900, 1000))
    return j.sum_duplicates(), t.sum_duplicates()
