"""nnz-balanced row partitioning (host NumPy).

Shards are contiguous row ranges with near-equal nnz, cut exactly at row
boundaries, so no row is shared between two shards and y needs no
cross-shard reduction.  Lane-level balance within a shard is the SELL
packer's job.
"""

from __future__ import annotations

import numpy as np


def partition_rows_by_nnz(rowptr: np.ndarray, n_parts: int) -> np.ndarray:
    """Split rows into n_parts contiguous ranges with near-equal nnz.

    Returns bounds [n_parts + 1]: part i owns rows [bounds[i], bounds[i+1]).
    """
    rowptr = np.asarray(rowptr, dtype=np.int64)
    nrows = rowptr.shape[0] - 1
    nnz = int(rowptr[-1])
    if n_parts < 1:
        raise ValueError("n_parts must be >= 1")
    targets = (np.arange(1, n_parts, dtype=np.int64) * nnz) // n_parts
    cuts = np.searchsorted(rowptr, targets, side="left").astype(np.int64)
    bounds = np.concatenate(([0], cuts, [nrows]))
    # a mega-row larger than nnz/n_parts can break monotonicity; enforce
    # it so every part is a valid (possibly empty) row range
    np.maximum.accumulate(bounds, out=bounds)
    np.clip(bounds, 0, nrows, out=bounds)
    return bounds


def partition_balance(rowptr: np.ndarray, bounds: np.ndarray) -> dict:
    """Diagnostics: per-part nnz and the max/mean imbalance ratio."""
    rowptr = np.asarray(rowptr, dtype=np.int64)
    part_nnz = rowptr[bounds[1:]] - rowptr[bounds[:-1]]
    mean = part_nnz.mean() if part_nnz.size else 0.0
    return {
        "part_nnz": part_nnz,
        "imbalance": float(part_nnz.max() / mean) if mean > 0 else 1.0,
    }
