"""The work a product needs and the least time the card could take.

The counts are of the product Y = A @ X itself, whatever format or
kernel computes it: each stored entry of A read once (a float32 value
and an int32 column), the row pointer once, X read once and Y written
once.  So no change to the program's own layouts moves them.  The peaks
are the NVIDIA H100 SXM data sheet's: HBM3 at 3.35 TB/s, float32 outside
the tensor cores at 67 TFLOP/s.
"""

from __future__ import annotations

PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops_per_s": 67e12,
}


def flops(nnz: int, K: int) -> int:
    return 2 * nnz * K


def bytes_moved(nrows: int, ncols: int, nnz: int, K: int) -> int:
    return 8 * nnz + 4 * (nrows + 1) + 4 * ncols * K + 4 * nrows * K


def least_seconds(nrows: int, ncols: int, nnz: int, K: int,
                  peaks: dict = PEAKS) -> float:
    """The larger of the bytes over the memory rate and the operations
    over the float32 rate."""
    return max(bytes_moved(nrows, ncols, nnz, K) / peaks["hbm_bytes_per_s"],
               flops(nnz, K) / peaks["fp32_flops_per_s"])
