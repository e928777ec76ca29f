"""Deterministic synthetic matrices for benchmarking and tests.

An R-MAT generator whose outputs carry the statistics of the scale-free
suite (power-law row degrees, ~5 nnz/row, web-scale row counts;
web-Google is 916K x 916K with 5.10M nnz) and a banded stencil.  The
numpy generators are seeded exactly as the JAX package seeds them, so
both packages build the same matrix from the same seed.  R-MAT matrices
of scale 16 and more are cached on disk, under ``CVR_TPU_CACHE`` (default
~/.cache/cvr_tpu), in the JAX package's file layout and by its key, so
either package reads what the other cached; ``cache=False`` neither reads
nor writes the cache.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from cvr_tpu_torch.formats.coo import COOMatrix


def _cache_dir() -> Path:
    """The generator cache, ``CVR_TPU_CACHE`` (read at each call) or
    ~/.cache/cvr_tpu; made if missing."""
    d = Path(
        os.environ.get("CVR_TPU_CACHE", Path.home() / ".cache" / "cvr_tpu")
    )
    d.mkdir(parents=True, exist_ok=True)
    return d


def rmat_matrix(
    scale: int,
    edge_factor: int = 6,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 42,
    dtype=np.float32,
    cache: bool = True,
) -> COOMatrix:
    """R-MAT power-law graph: 2**scale vertices, edge_factor * 2**scale edges.

    Kronecker quadrant probabilities (a, b, c, 1-a-b-c) follow the Graph500
    convention; duplicates are coalesced, so the final nnz is slightly below
    the nominal edge count.  Instances of scale >= 16 are read from the
    cache when ``cache`` and present there, and written to it after
    generation.
    """
    n = 1 << scale
    nnz = edge_factor * n
    cached = cache and scale >= 16
    if cached:
        key = f"rmat_s{scale}_e{edge_factor}_a{a}_b{b}_c{c}_seed{seed}.npz"
        cpath = _cache_dir() / key
        if cpath.exists():
            z = np.load(cpath)
            return COOMatrix(rows=z["rows"], cols=z["cols"],
                             vals=z["vals"].astype(dtype), shape=(n, n))
    rng = np.random.default_rng(seed)
    d = 1.0 - a - b - c
    rows = np.zeros(nnz, dtype=np.int32)
    cols = np.zeros(nnz, dtype=np.int32)
    # inverse-CDF sampling of the quadrant, one uniform draw per level:
    # quadrant q = searchsorted(cdf, u) in [0, 4), whose high bit (q >> 1)
    # is u > cdf[1] and low bit (q & 1) the parity of u's cdf crossings;
    # the bits are shifted in place (the JAX package's int64 arithmetic
    # gives the same ids, all below 2**scale)
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
    vals = rng.standard_normal(nnz).astype(dtype)
    coo = COOMatrix(rows=rows, cols=cols, vals=vals,
                    shape=(n, n)).sum_duplicates()
    if cached:
        # written whole under another name, then renamed: processes that
        # generate the same matrix at once never read a partial file
        tmp = cpath.with_name(f"{cpath.name}.{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, rows=coo.rows, cols=coo.cols, vals=coo.vals)
        os.replace(tmp, cpath)
    return coo


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


def soc_livejournal_like(seed: int = 11) -> COOMatrix:
    """Mid-scale stand-in for soc-LiveJournal1-class social graphs
    (~4.2M x 4.2M, ~25M nnz): R-MAT scale 22, edge factor 6."""
    return rmat_matrix(scale=22, edge_factor=6, seed=seed)


def soc_livejournal_full(seed: int = 11) -> COOMatrix:
    """Full-scale stand-in for soc-LiveJournal1 (4.8M x 4.8M, 69M nnz):
    R-MAT scale 23, edge factor 9, coalesced to 74,366,358 nnz on
    8,388,608 rows; its routed stream takes 79,872 route tiles, under
    ROUTED_T_CAP."""
    return rmat_matrix(scale=23, edge_factor=9, seed=seed)


def citation_like(seed: int = 13) -> COOMatrix:
    """Stand-in for the citation domain (cit-Patents-class: moderate
    power-law, ~15 nnz per row): milder R-MAT quadrants at web scale."""
    return rmat_matrix(
        scale=20, edge_factor=16, a=0.55, b=0.2, c=0.2, seed=seed
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


def road_usa_like(
    n: int = 1 << 23, deg: float = 2.5, reach: int = 64, seed: int = 17
) -> COOMatrix:
    """Stand-in for the road domain (road_usa-class: millions of rows,
    ~2.4 nnz per row, strong spatial locality under a good node order):
    each of n*deg links joins a random row to a row within ``reach``."""
    rng = np.random.default_rng(seed)
    nnz = int(n * deg)
    rows = rng.integers(0, n, nnz).astype(np.int64)
    cols = np.clip(rows + rng.integers(-reach, reach + 1, nnz), 0, n - 1)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return COOMatrix(
        rows=rows.astype(np.int32), cols=cols.astype(np.int32),
        vals=vals, shape=(n, n),
    ).sum_duplicates()


def rgg_like(
    n: int = 1 << 21, deg: int = 6, reach: int = 96, seed: int = 19
) -> COOMatrix:
    """Stand-in for the routing domain (rgg-class random geometric graphs:
    ~6 nnz per row, edges between spatially close nodes)."""
    rng = np.random.default_rng(seed)
    nnz = n * deg
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = np.clip(rows + rng.integers(-reach, reach + 1, nnz), 0, n - 1)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return COOMatrix(
        rows=rows.astype(np.int32), cols=cols.astype(np.int32),
        vals=vals, shape=(n, n),
    ).sum_duplicates()


def fem_like(
    n: int = 1 << 20, deg: int = 54, bw: int = 150, seed: int = 23
) -> COOMatrix:
    """Stand-in for the engineering domain (FEM matrices: ~50-80 nnz per
    row within a narrow band after reordering)."""
    rng = np.random.default_rng(seed)
    nnz = n * deg
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = np.clip(rows + rng.integers(-bw, bw + 1, nnz), 0, n - 1)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return COOMatrix(
        rows=rows.astype(np.int32), cols=cols.astype(np.int32),
        vals=vals, shape=(n, n),
    ).sum_duplicates()


# Second stand-ins per domain: other generator seeds and parameters, so
# that a domain's score can be the minimum over two structurally distinct
# matrices (the JAX package's sweep runs both).


def web_google_like_b() -> COOMatrix:
    """Web-graph second stand-in: shallower quadrant skew, lower edge
    factor, another seed (~4.6M nnz)."""
    return rmat_matrix(
        scale=20, edge_factor=5, a=0.59, b=0.18, c=0.18, seed=101
    )


def soc_livejournal_like_b() -> COOMatrix:
    """Social second stand-in: denser rows at half the vertex count."""
    return rmat_matrix(scale=21, edge_factor=12, seed=31)


def wiki_talk_like_b(seed: int = 99) -> COOMatrix:
    """Wiki second stand-in with a 100K-degree hub tail: the steep R-MAT
    of wiki_talk_like plus one ~100K-nnz row (12,345) and one
    ~100K-reference column (54,321), from ``default_rng(seed + 1)``."""
    coo = rmat_matrix(
        scale=21, edge_factor=3, a=0.65, b=0.15, c=0.15, seed=seed
    )
    rng = np.random.default_rng(seed + 1)
    n = coo.shape[0]
    hub = 100_000
    hub_row = np.full(hub, 12345, dtype=np.int32)
    hub_row_cols = rng.integers(0, n, hub).astype(np.int32)
    hub_col_rows = rng.integers(0, n, hub).astype(np.int32)
    hub_col = np.full(hub, 54321, dtype=np.int32)
    rows = np.concatenate([coo.rows, hub_row, hub_col_rows])
    cols = np.concatenate([coo.cols, hub_row_cols, hub_col])
    vals = np.concatenate(
        [coo.vals, rng.standard_normal(2 * hub).astype(np.float32)]
    )
    return COOMatrix(
        rows=rows, cols=cols, vals=vals, shape=coo.shape
    ).sum_duplicates()


def citation_like_b() -> COOMatrix:
    """Citation second stand-in: milder skew, ~12 nnz per row."""
    return rmat_matrix(
        scale=20, edge_factor=12, a=0.52, b=0.22, c=0.22, seed=37
    )


def road_usa_like_b() -> COOMatrix:
    """Road second stand-in: half the vertices, denser, tighter reach."""
    return road_usa_like(n=1 << 22, deg=2.8, reach=48, seed=23)


def rgg_like_b() -> COOMatrix:
    """Routing second stand-in: smaller graph, denser, shorter reach."""
    return rgg_like(n=1 << 20, deg=9, reach=64, seed=5)


def fsm_like_b() -> COOMatrix:
    """FSM second stand-in: wider alphabet (deg 10), 4096 shallow hub
    states, lower failure fraction."""
    return fsm_like(
        n=1 << 20, deg=10, hub_states=4096, reach=32, p_fail=0.45,
        seed=29,
    )


def fem_like_b() -> COOMatrix:
    """Engineering second stand-in: denser rows, wider band, fewer
    nodes."""
    return fem_like(n=1 << 19, deg=80, bw=220, seed=3)


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
