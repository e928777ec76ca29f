"""COO (coordinate) sparse matrix container (host NumPy)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def row_col_order(rows, cols) -> np.ndarray:
    """np.lexsort((cols, rows)): the (row, col) order, entries of equal
    (row, col) in their order, by one stable sort of an int64 key (half
    lexsort's time) where the ids fit in 32 bits."""
    int32 = all(a.dtype.kind == "i" and a.dtype.itemsize <= 4
                for a in (rows, cols))
    if rows.size and not int32:
        lo = min(int(rows.min()), int(cols.min()))
        hi = max(int(rows.max()), int(cols.max()))
        if lo < -(1 << 31) or hi >= 1 << 31:
            return np.lexsort((cols, rows))
    key = (rows.astype(np.int64) << 32) + (cols.astype(np.int64) + (1 << 31))
    return np.argsort(key, kind="stable")


@dataclass
class COOMatrix:
    rows: np.ndarray  # [nnz] int
    cols: np.ndarray  # [nnz] int
    vals: np.ndarray  # [nnz] float
    shape: tuple[int, int]

    def __post_init__(self):
        self.rows = np.asarray(self.rows)
        self.cols = np.asarray(self.cols)
        self.vals = np.asarray(self.vals)
        if not (self.rows.shape == self.cols.shape == self.vals.shape):
            raise ValueError("rows/cols/vals must have identical shapes")
        if self.rows.ndim != 1:
            raise ValueError("COO arrays must be 1-D")

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def transpose(self) -> "COOMatrix":
        """A^T (swap row/col ids) — e.g. PageRank follows in-links."""
        return COOMatrix(
            rows=self.cols,
            cols=self.rows,
            vals=self.vals,
            shape=(self.shape[1], self.shape[0]),
        )

    def sorted_by_row(self) -> "COOMatrix":
        """Stable (row, col) sort, the order CSR assembly puts entries in."""
        order = row_col_order(self.rows, self.cols)
        return COOMatrix(
            rows=self.rows[order],
            cols=self.cols[order],
            vals=self.vals[order],
            shape=self.shape,
        )

    def sum_duplicates(self) -> "COOMatrix":
        """Coalesce duplicate (row, col) entries by summation."""
        order = row_col_order(self.rows, self.cols)
        r, c, v = self.rows[order], self.cols[order], self.vals[order]
        if r.size == 0:
            return COOMatrix(r, c, v, self.shape)
        new_group = np.empty(r.size, dtype=bool)
        new_group[0] = True
        new_group[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
        idx = np.flatnonzero(new_group)
        sums = np.add.reduceat(v.astype(np.float64), idx).astype(v.dtype)
        return COOMatrix(r[idx], c[idx], sums, self.shape)

    def to_csr(self, sort_cols: bool = True) -> "CSRMatrix":
        """Assemble CSR.  sort_cols=True yields canonical (col-sorted rows)
        form via lexsort; sort_cols=False keeps insertion order within rows
        and uses the native O(nnz) counting sort when available."""
        from cvr_tpu_torch import _native
        from cvr_tpu_torch.formats.csr import CSRMatrix

        nrows = self.shape[0]
        if (
            not sort_cols
            and self.vals.dtype == np.float32
            and _native.available()
        ):
            rowptr, cols, vals = _native.coo_to_csr_native(
                nrows, self.rows, self.cols, self.vals
            )
            return CSRMatrix(
                rowptr=rowptr, cols=cols, vals=vals, shape=self.shape
            )
        if sort_cols:
            order = row_col_order(self.rows, self.cols)
        else:
            order = np.argsort(self.rows, kind="stable")
        counts = np.bincount(self.rows, minlength=nrows).astype(np.int64)
        rowptr = np.zeros(nrows + 1, dtype=np.int64)
        np.cumsum(counts, out=rowptr[1:])
        return CSRMatrix(
            rowptr=rowptr,
            cols=self.cols[order].astype(np.int32),
            vals=self.vals[order],
            shape=self.shape,
        )

    def to_dense(self) -> np.ndarray:
        dense = np.zeros(self.shape, dtype=np.float64)
        np.add.at(dense, (self.rows, self.cols), self.vals.astype(np.float64))
        return dense.astype(self.vals.dtype)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.coo_matrix(
            (self.vals, (self.rows, self.cols)), shape=self.shape
        )

    @staticmethod
    def from_scipy(m) -> "COOMatrix":
        m = m.tocoo()
        return COOMatrix(
            rows=m.row.astype(np.int32),
            cols=m.col.astype(np.int32),
            vals=m.data,
            shape=m.shape,
        )
