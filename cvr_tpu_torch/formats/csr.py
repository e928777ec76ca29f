"""CSR (compressed sparse row) container (host NumPy)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CSRMatrix:
    rowptr: np.ndarray  # [nrows + 1] int64
    cols: np.ndarray  # [nnz] int32
    vals: np.ndarray  # [nnz] float
    shape: tuple[int, int]

    def __post_init__(self):
        self.rowptr = np.asarray(self.rowptr, dtype=np.int64)
        self.cols = np.asarray(self.cols)
        self.vals = np.asarray(self.vals)
        if self.rowptr.shape != (self.shape[0] + 1,):
            raise ValueError(
                f"rowptr length {self.rowptr.shape} != nrows+1 = {self.shape[0] + 1}"
            )
        if self.cols.shape != self.vals.shape:
            raise ValueError("cols/vals must have identical shapes")

    @property
    def nnz(self) -> int:
        return int(self.cols.shape[0])

    @property
    def row_lengths(self) -> np.ndarray:
        return np.diff(self.rowptr)

    def row_ids(self) -> np.ndarray:
        """Expand rowptr to a per-nnz row-id array [nnz]."""
        return np.repeat(
            np.arange(self.shape[0], dtype=np.int32), self.row_lengths
        )

    def to_coo(self):
        from cvr_tpu_torch.formats.coo import COOMatrix

        return COOMatrix(
            rows=self.row_ids(),
            cols=self.cols.copy(),
            vals=self.vals.copy(),
            shape=self.shape,
        )

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.vals, self.cols, self.rowptr), shape=self.shape
        )

    @staticmethod
    def from_scipy(m) -> "CSRMatrix":
        m = m.tocsr()
        return CSRMatrix(
            rowptr=m.indptr.astype(np.int64),
            cols=m.indices.astype(np.int32),
            vals=m.data,
            shape=m.shape,
        )
