"""Y = A @ X on the BSR-128 artifact.

Two paths over the same device planes:

  * ``spmm_bsr``, the JAX package's "bsr-xla" path: a block gather of X,
    one batched float32 product over the bricks and an ``index_add_``
    into row blocks, as torch ops (no kernel of its own);
  * ``spmm_bsr_fused``, the fused kernel K12 (the JAX package's Pallas
    ``bsr_spmm_pallas``): no gathered X and no per-brick products in
    device memory.  ``spmm`` takes it unless asked for "bsr-xla".
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cvr_tpu_torch.formats.bsr import B, BsrMatrix
from cvr_tpu_torch.ops import bsr_kernels as bk


@dataclass(frozen=True)
class BsrDevice:
    vals: torch.Tensor  # (nbricks, B, B) f32 dense bricks
    brick_row: torch.Tensor  # (nbricks,) int32, non-decreasing
    brick_col: torch.Tensor  # (nbricks,) int32
    row_start: torch.Tensor  # (nrb + 1,) int64: row block rb's bricks
    shape: tuple[int, int]
    nnz: int
    nrb: int
    ncb: int


def to_device_bsr(bm: BsrMatrix, device="cuda") -> BsrDevice:
    """Upload the bricks and each row block's brick range to ``device``."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    nrb = -(-bm.shape[0] // B)
    row_start = np.searchsorted(bm.brick_row, np.arange(nrb + 1))
    return BsrDevice(
        vals=put(bm.vals, np.float32),
        brick_row=put(bm.brick_row, np.int32),
        brick_col=put(bm.brick_col, np.int32),
        row_start=put(row_start, np.int64),
        shape=tuple(bm.shape),
        nnz=bm.nnz,
        nrb=nrb,
        ncb=-(-bm.shape[1] // B),
    )


def kernel_args(dev: BsrDevice, X: torch.Tensor) -> tuple:
    """K12's arguments for X (f32, contiguous)."""
    return (dev.vals, dev.brick_row, dev.brick_col, dev.row_start, X,
            dev.shape[0])


def spmm_bsr(dev: BsrDevice, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X as torch ops (the "bsr-xla" path); X (ncols, K)."""
    return bk.bsr_spmm_plain(*kernel_args(dev, X.to(torch.float32)))


def spmm_bsr_fused(dev: BsrDevice, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X through K12; X (ncols, K) on dev's device."""
    return bk.bsr_spmm(*kernel_args(dev, X.to(torch.float32).contiguous()))
