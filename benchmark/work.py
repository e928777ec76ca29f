"""The work a product needs and the least time the card could take.

The counts are of the product Y = A @ X itself, whatever format or
kernel computes it: each stored value of A read once (4 B, float32), X
read once and Y written once.  An index (CSR's columns and row pointer,
SELL's or the routed planes' tables) is one layout's overhead, which a
banded or stencil layout does not read, so none is counted: the bytes
are a least for every format, and no change to the program's layouts
moves them.  The peaks are the NVIDIA H100 SXM data sheet's: HBM3 at
3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s.
"""

from __future__ import annotations

PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops_per_s": 67e12,
}


def flops(nnz: int, K: int) -> int:
    return 2 * nnz * K


def bytes_moved(nrows: int, ncols: int, nnz: int, K: int) -> int:
    return 4 * nnz + 4 * ncols * K + 4 * nrows * K


def least_seconds(nrows: int, ncols: int, nnz: int, K: int,
                  peaks: dict = PEAKS) -> float:
    """The larger of the bytes over the memory rate and the operations
    over the float32 rate."""
    return max(bytes_moved(nrows, ncols, nnz, K) / peaks["hbm_bytes_per_s"],
               flops(nnz, K) / peaks["fp32_flops_per_s"])
