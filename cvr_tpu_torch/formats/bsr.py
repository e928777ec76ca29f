"""BSR-128: dense 128x128 bricks for SpMM on matrices with block locality.

For every occupied 128x128 brick of A, ``Y[rb] += A_brick @ X[cb]`` is a
dense (128, 128) x (128, K) product.  On a locality-structured matrix
(banded, road, FEM) the brick fill is 5-15%, and a dense product over
the bricks pays the 1/fill work of densification for regular memory
access.  ``bsr_pack`` raises :class:`BsrInfeasible` where densification
would explode memory or work (power-law matrices); callers then take the
gather formats.

The pack gives the same arrays as the JAX package's, including one
all-zero brick for each row block that holds no entry, so that every
output row block is visited by a brick.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.utils.timing import PhaseTimer

B = 128  # brick edge


class BsrInfeasible(ValueError):
    """Brick fill too low, or the dense bricks too large."""


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class BsrMatrix:
    """Host-side BSR-128 artifact (dense f32 bricks, sorted by row block)."""

    vals: np.ndarray  # (nbricks, B, B) f32 dense bricks
    brick_row: np.ndarray  # (nbricks,) int32, non-decreasing
    brick_col: np.ndarray  # (nbricks,) int32
    shape: tuple[int, int]
    nnz: int
    convert_time: float = 0.0
    convert_phases: dict = field(default_factory=dict)

    @property
    def nbricks(self) -> int:
        return int(self.vals.shape[0])

    @property
    def fill(self) -> float:
        return self.nnz / max(1, self.nbricks * B * B)

    @property
    def padded_nnz(self) -> int:
        return self.nbricks * B * B

    def save(self, path) -> None:
        """Write the artifact as the JAX package's ``.npz`` layout."""
        np.savez_compressed(
            path,
            vals=self.vals, brick_row=self.brick_row,
            brick_col=self.brick_col,
            shape=np.asarray(self.shape, dtype=np.int64),
            nnz=np.int64(self.nnz),
        )

    @staticmethod
    def load(path) -> "BsrMatrix":
        z = np.load(path)
        return BsrMatrix(
            vals=z["vals"], brick_row=z["brick_row"],
            brick_col=z["brick_col"],
            shape=tuple(int(v) for v in z["shape"]), nnz=int(z["nnz"]),
        )


def from_reference(bm) -> BsrMatrix:
    """The port's artifact from the JAX package's ``BsrMatrix`` (its numpy
    attributes only)."""
    return BsrMatrix(
        vals=bm.vals, brick_row=bm.brick_row, brick_col=bm.brick_col,
        shape=tuple(bm.shape), nnz=bm.nnz, convert_time=bm.convert_time,
        convert_phases=dict(bm.convert_phases),
    )


def bsr_pack(
    csr: CSRMatrix,
    min_fill: float = 0.005,
    max_bytes: int = 6 << 30,
) -> BsrMatrix:
    """CSR -> BSR-128 densification.

    Raises BsrInfeasible when the dense bricks would take more than
    ``max_bytes`` or fill less than ``min_fill`` of them with entries.
    The native library does both passes where it is available, numpy
    otherwise.
    """
    from cvr_tpu_torch import _native

    pt = PhaseTimer()
    nrows, ncols = csr.shape
    nnz = csr.nnz
    ncb = max(1, _round_up(ncols, B) // B)
    native_ok = _native.available()

    with pt.phase("bricks"):
        if native_ok:
            nb = _native.bsr_count_native(nrows, ncb, csr.rowptr, csr.cols)
        else:
            lengths = np.diff(csr.rowptr)
            r = np.repeat(np.arange(nrows, dtype=np.int64), lengths)
            c = csr.cols.astype(np.int64)
            key = (r >> 7) * ncb + (c >> 7)
            bricks, inv = np.unique(key, return_inverse=True)
            nb = int(bricks.shape[0])
        if nb * B * B * 4 > max_bytes:
            raise BsrInfeasible(
                f"{nb} bricks = {nb * B * B * 4 / 1e9:.1f} GB dense "
                f"(max {max_bytes / 1e9:.1f} GB)"
            )
        fill = nnz / max(1, nb * B * B)
        if fill < min_fill:
            raise BsrInfeasible(
                f"brick fill {fill:.4f} < {min_fill}: no block locality; "
                "use the routed SpMM"
            )

    with pt.phase("fill"):
        if native_ok:
            brick_row, brick_col, vals = _native.bsr_fill_native(
                nrows, ncb, csr.rowptr, csr.cols,
                csr.vals.astype(np.float32), nb,
            )
        else:
            brick_row = (bricks // ncb).astype(np.int32)
            brick_col = (bricks % ncb).astype(np.int32)
            vals = np.zeros((nb, B, B), dtype=np.float32)
            dest = (inv << 14) + ((r & 127) << 7) + (c & 127)
            # CSR has unique (row, col) pairs, so a plain scatter is exact
            vals.reshape(-1)[dest] = csr.vals.astype(np.float32)
        # one all-zero brick for each row block without entries, as the
        # JAX package appends them (its TPU kernel zeroes an output block
        # only where a brick visits it)
        nrb = max(1, _round_up(nrows, B) // B)
        missing = np.setdiff1d(
            np.arange(nrb, dtype=np.int32), brick_row, assume_unique=False
        )
        if missing.shape[0]:
            vals = np.concatenate(
                [vals, np.zeros((missing.shape[0], B, B), np.float32)]
            )
            brick_row = np.concatenate([brick_row, missing])
            brick_col = np.concatenate(
                [brick_col, np.zeros(missing.shape[0], np.int32)]
            )
            order = np.argsort(brick_row, kind="stable")
            vals, brick_row, brick_col = (
                vals[order], brick_row[order], brick_col[order]
            )

    return BsrMatrix(
        vals=vals,
        brick_row=brick_row,
        brick_col=brick_col,
        shape=csr.shape,
        nnz=nnz,
        convert_time=pt.total,
        convert_phases=dict(pt.phases),
    )
