"""The benchmark's R-MAT generator and the Graph500 graph made from it.

A frozen copy of ``cvr_tpu_torch/bench/synthetic.py:rmat_matrix`` with
its seeding and its coalescing of duplicates (``COOMatrix.
sum_duplicates`` and ``row_col_order``), NumPy only: the same
(scale, edge factor, quadrants, seed) give the same arrays as the
program's generator, and no later change to the program moves them.
``graph500`` makes the Graph500 specification's graph from that edge
list: weights, permuted labels, undirected.
"""

from __future__ import annotations

import numpy as np


def row_col_order(rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """The stable (row, col) order, by one sort of an int64 key."""
    key = (rows.astype(np.int64) << 32) + (cols.astype(np.int64) + (1 << 31))
    return np.argsort(key, kind="stable")


def sum_duplicates(rows, cols, vals):
    """(rows, cols, vals) sorted by (row, col), duplicates summed in
    float64 and cast back to the values' type."""
    order = row_col_order(rows, cols)
    r, c, v = rows[order], cols[order], vals[order]
    if r.size == 0:
        return r, c, v
    new = np.empty(r.size, dtype=bool)
    new[0] = True
    new[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    idx = np.flatnonzero(new)
    sums = np.add.reduceat(v.astype(np.float64), idx).astype(v.dtype)
    return r[idx], c[idx], sums


def rmat_edges(scale: int, edge_factor: int, a: float, b: float,
               c: float, rng):
    """The R-MAT edge list: edge_factor * 2**scale (row, col) pairs on
    2**scale vertices, int32, each drawn quadrant by quadrant (a, b, c,
    1-a-b-c) from ``rng``, one uniform draw an edge a level."""
    n = 1 << scale
    nnz = edge_factor * n
    d = 1.0 - a - b - c
    rows = np.zeros(nnz, dtype=np.int32)
    cols = np.zeros(nnz, dtype=np.int32)
    # inverse-CDF sampling of the quadrant, one uniform draw per level:
    # the high bit is u > cdf[1], the low bit the parity of u's crossings
    cdf = np.cumsum([a, b, c, d])[:3]
    lo = np.empty(nnz, dtype=bool)
    for _level in range(scale):
        u = rng.random(nnz)
        hi = u > cdf[1]
        np.greater(u, cdf[0], out=lo)
        lo ^= hi
        lo ^= u > cdf[2]
        del u
        rows <<= 1
        rows |= hi
        cols <<= 1
        cols |= lo
    return rows, cols


def rmat(scale: int, edge_factor: int, a: float, b: float, c: float,
         seed: int):
    """R-MAT power-law graph on 2**scale vertices with edge_factor *
    2**scale edges drawn (Graph500 quadrants a, b, c, 1-a-b-c), values
    from N(0, 1) in float32, duplicates coalesced: (rows int32, cols
    int32, vals float32), sorted by (row, col)."""
    rng = np.random.default_rng(seed)
    rows, cols = rmat_edges(scale, edge_factor, a, b, c, rng)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return sum_duplicates(rows, cols, vals)


def graph500(scale: int, edgefactor: int, A: float, B: float, C: float,
             seed: int):
    """The Graph500 benchmark's graph as its specification makes it:
    the Kronecker (R-MAT) edge list of ``rmat_edges`` with initiator
    A, B, C, 1-A-B-C and edgefactor * 2**scale edges, a weight uniform
    in [0, 1) an edge, the vertex labels randomly permuted, and the
    graph undirected.  Its adjacency matrix: each edge stored both ways
    with its weight (a self-loop once), parallel edges summed, as
    (rows int32, cols int32, vals float32) sorted by (row, col)."""
    n = 1 << scale
    rng = np.random.default_rng(seed)
    rows, cols = rmat_edges(scale, edgefactor, A, B, C, rng)
    w = rng.random(rows.shape[0], dtype=np.float32)
    perm = rng.permutation(n).astype(np.int32)
    rows, cols = perm[rows], perm[cols]
    del perm
    off = rows != cols
    r = np.concatenate([rows, cols[off]])
    c = np.concatenate([cols, rows[off]])
    v = np.concatenate([w, w[off]])
    del rows, cols, w, off
    return sum_duplicates(r, c, v)
