"""Deterministic synthetic matrices for benchmarking and tests.

An R-MAT generator whose outputs carry the statistics of the scale-free
suite (power-law row degrees, ~5 nnz/row, web-scale row counts;
web-Google is 916K x 916K with 5.10M nnz) and a banded stencil.  The
numpy generators are seeded exactly as the JAX package seeds them, so
both packages build the same matrix from the same seed.  Nothing is
cached on disk: generation is part of each run's set-up.
"""

from __future__ import annotations

import numpy as np

from cvr_tpu_torch.formats.coo import COOMatrix


def rmat_matrix(
    scale: int,
    edge_factor: int = 6,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 42,
    dtype=np.float32,
) -> COOMatrix:
    """R-MAT power-law graph: 2**scale vertices, edge_factor * 2**scale edges.

    Kronecker quadrant probabilities (a, b, c, 1-a-b-c) follow the Graph500
    convention; duplicates are coalesced, so the final nnz is slightly below
    the nominal edge count.
    """
    n = 1 << scale
    nnz = edge_factor * n
    rng = np.random.default_rng(seed)
    d = 1.0 - a - b - c
    rows = np.zeros(nnz, dtype=np.int64)
    cols = np.zeros(nnz, dtype=np.int64)
    # inverse-CDF sampling of the quadrant, one uniform draw per level
    cdf = np.cumsum([a, b, c, d])[:3]
    for _level in range(scale):
        u = rng.random(nnz)
        q = np.searchsorted(cdf, u).astype(np.int64)
        rows = (rows << 1) | (q >> 1)
        cols = (cols << 1) | (q & 1)
    vals = rng.standard_normal(nnz).astype(dtype)
    return COOMatrix(
        rows=rows.astype(np.int32),
        cols=cols.astype(np.int32),
        vals=vals,
        shape=(n, n),
    ).sum_duplicates()


def web_google_like(seed: int = 42) -> COOMatrix:
    """A deterministic stand-in for web-Google (916K x 916K, 5.10M nnz,
    power-law degrees): R-MAT scale 20, edge factor 6, coalesced to
    ~6.2M nnz."""
    return rmat_matrix(scale=20, edge_factor=6, seed=seed)


def wiki_talk_like(seed: int = 7) -> COOMatrix:
    """A deterministic stand-in for wiki-Talk (2.39M x 2.39M, 5.02M nnz,
    extreme in-degree skew): steeper R-MAT quadrants produce celebrity
    columns and rows with 10^4-10^5 nonzeros (2,097,152 rows)."""
    return rmat_matrix(
        scale=21, edge_factor=3, a=0.65, b=0.15, c=0.15, seed=seed
    )


def fsm_like(
    n: int = 1 << 21, deg: int = 8, hub_states: int = 1024,
    reach: int = 64, p_fail: float = 0.55, seed: int = 19,
) -> COOMatrix:
    """Stand-in for the FSM domain (automata transition matrices of
    pattern-matching FSMs).

    The structure of an Aho-Corasick-style automaton: near-constant row
    out-degree (the stored alphabet transitions), columns split between
    forward trie edges (state + small offset: spatial locality) and
    failure links back to a small set of shallow states near the root
    (extreme column reuse).  ``p_fail`` of the transitions land on a
    geometric distribution over the first ``hub_states`` columns, the hub
    columns the hub-column hybrid captures."""
    rng = np.random.default_rng(seed)
    nnz = n * deg
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    fail = rng.random(nnz) < p_fail
    g = rng.geometric(p=8.0 / hub_states, size=nnz).astype(np.int64)
    hub = np.minimum(g - 1, hub_states - 1)
    fwd = rows + rng.integers(1, reach + 1, size=nnz)
    cols = np.where(fail, hub, np.minimum(fwd, n - 1))
    vals = rng.standard_normal(nnz).astype(np.float32)
    return COOMatrix(
        rows=rows.astype(np.int32),
        cols=cols.astype(np.int32),
        vals=vals,
        shape=(n, n),
    ).sum_duplicates()


def banded_matrix(
    n: int, bandwidth: int = 27, seed: int = 0, dtype=np.float32
) -> COOMatrix:
    """A regular HPC-style banded matrix (stencil-like)."""
    rng = np.random.default_rng(seed)
    offsets = np.arange(-(bandwidth // 2), bandwidth // 2 + 1)
    rows_list, cols_list = [], []
    for off in offsets:
        r = np.arange(max(0, -off), min(n, n - off), dtype=np.int32)
        rows_list.append(r)
        cols_list.append(r + off)
    rows = np.concatenate(rows_list)
    cols = np.concatenate(cols_list).astype(np.int32)
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    return COOMatrix(rows=rows, cols=cols, vals=vals, shape=(n, n))


# Small matrices whose routed packs reach one branch each (used by the
# tests and by chip_smoke.py's geometry phase).


def _random_coo(rng, rows, ncols: int, shape) -> COOMatrix:
    rows = np.asarray(rows, dtype=np.int32)
    cols = rng.integers(0, ncols, rows.shape[0]).astype(np.int32)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return COOMatrix(rows=rows, cols=cols, vals=vals,
                     shape=shape).sum_duplicates()


def empty_rows_cols(n: int = 1 << 17, seed: int = 3) -> COOMatrix:
    """Rows past n/3 and columns past n/2 empty, plus a 300-nnz row: with
    split_len=16 its extra segments push the last empty rows' sorted
    positions past the y-route, so the row mask is non-empty."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, n // 3, 20000), np.full(300, 5)])
    return _random_coo(rng, rows, n // 2, (n, n))


def uniform_rows(n: int = 4096, lo: int = 121, hi: int = 129,
                 seed: int = 8) -> COOMatrix:
    """Uniform ~121-128 nnz rows: zone widths of 16, a regular region."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), rng.integers(lo, hi, n))
    return _random_coo(rng, rows, n, (n, n))


def multisegment(seed: int = 9) -> COOMatrix:
    """~1.24M columns: x spans two 1024-window segments."""
    rng = np.random.default_rng(seed)
    nrows, ncols = 4000, 1_300_000
    return _random_coo(rng, rng.integers(0, nrows, 40_000), ncols,
                       (nrows, ncols))
