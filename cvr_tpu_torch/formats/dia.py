"""DIA: the diagonal format, for banded and stencil matrices.

With every nonzero on one of nd dense diagonals,

    y[r] = sum_k  band_k[r] * x[r + off_k]

is nd shifted multiply-adds over contiguous x: no indices, no windows, no
route.  ``dia_pack`` gates hard: at most ``max_diags`` diagonals whose
mean fill is at least ``min_fill``, otherwise DiaInfeasible, and
``pack_auto`` tries the next format.  Same arrays as the JAX package's
pack of the same matrix.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.utils.timing import PhaseTimer


class DiaInfeasible(ValueError):
    """Nonzeros not concentrated on few dense diagonals."""


@dataclass
class DiaMatrix:
    """Host-side DIA artifact: ``bands[k, r] = A[r, r + offsets[k]]``
    (row-aligned; zero where the diagonal leaves the matrix)."""

    offsets: np.ndarray  # (nd,) int64, sorted
    bands: np.ndarray  # (nd, nrows) f32
    shape: tuple[int, int]
    nnz: int
    convert_time: float = 0.0
    convert_phases: dict = field(default_factory=dict)

    @property
    def nd(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def padded_nnz(self) -> int:
        return self.nd * self.shape[0]

    def save(self, path) -> None:
        """Write the artifact as the JAX package's ``.npz`` layout."""
        np.savez_compressed(
            path,
            offsets=self.offsets, bands=self.bands,
            shape=np.asarray(self.shape, dtype=np.int64),
            nnz=np.int64(self.nnz),
        )

    @staticmethod
    def load(path) -> "DiaMatrix":
        z = np.load(path)
        return DiaMatrix(
            offsets=z["offsets"], bands=z["bands"],
            shape=tuple(int(v) for v in z["shape"]), nnz=int(z["nnz"]),
        )


def dia_pack(
    csr: CSRMatrix, max_diags: int = 64, min_fill: float = 0.25
) -> DiaMatrix:
    """CSR -> DIA, O(nnz); the native passes when the library loads, the
    numpy path otherwise.

    Gate: at most ``max_diags`` distinct diagonals, and an aggregate fill
    (nnz over nd * nrows) of at least ``min_fill``.
    """
    from cvr_tpu_torch import _native

    pt = PhaseTimer()
    nrows, ncols = csr.shape
    nnz = csr.nnz
    native_ok = _native.available()
    with pt.phase("offsets"):
        if native_ok:
            offsets = _native.dia_offsets_native(csr.rowptr, csr.cols, nrows,
                                                 ncols)
        else:
            rows = np.repeat(np.arange(nrows, dtype=np.int64),
                             csr.row_lengths)
            offs_all = csr.cols.astype(np.int64) - rows
            offsets = np.unique(offs_all)
        if offsets.shape[0] > max_diags:
            raise DiaInfeasible(
                f"{offsets.shape[0]} distinct diagonals > {max_diags}"
            )
        fill = nnz / max(1, offsets.shape[0] * nrows)
        if fill < min_fill:
            raise DiaInfeasible(f"diagonal fill {fill:.3f} < {min_fill}")
    with pt.phase("bands"):
        if native_ok:
            bands = _native.dia_fill_native(csr.rowptr, csr.cols, csr.vals,
                                            offsets, nrows)
        else:
            bands = np.zeros((offsets.shape[0], nrows), dtype=np.float32)
            bands[np.searchsorted(offsets, offs_all), rows] = csr.vals
    return DiaMatrix(
        offsets=offsets,
        bands=bands,
        shape=csr.shape,
        nnz=nnz,
        convert_time=pt.total,
        convert_phases=dict(pt.phases),
    )
