"""The BSR-128 SpMM's device pass: K12 ``bsr_spmm`` and its plain version.

As in cvr_tpu_torch/ops/route_kernels.py: the wrapper launches the CUDA
kernel of cvr_tpu_torch/csrc/bsr_kernels.cu for CUDA tensors and counts
the launch in ``bsr_spmm.launches``; given CPU tensors it runs the plain
version, and only then.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cvr_tpu_torch.formats.bsr import B
from cvr_tpu_torch.ops.route_kernels import (
    _check_aligned,
    _check_dtype,
    _launch,
    _on_card,
    _p,
)

SOURCE = "cvr_tpu_torch/csrc/bsr_kernels.cu"


def bsr_spmm_plain(vals, brick_row, brick_col, row_start, X, nrows: int):
    """Y (nrows, K) = A @ X over the bricks: a block gather of X, one
    batched float32 product per brick (``torch.bmm``, TF32 off) and an
    ``index_add_`` into the row blocks: the JAX package's ``spmm_bsr``.
    ``row_start`` (the row blocks' brick ranges) only gives the row-block
    count here."""
    nrb = row_start.shape[0] - 1
    ncols, K = X.shape
    ncb = -(-ncols // B)
    Xp = F.pad(X, (0, 0, 0, ncb * B - ncols)).reshape(ncb, B, K)
    gx = Xp[brick_col.long()]  # (nbricks, B, K)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products
    try:
        prod = torch.bmm(vals, gx)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    Y = torch.zeros((nrb, B, K), dtype=torch.float32, device=X.device)
    Y.index_add_(0, brick_row.long(), prod)
    return Y.reshape(nrb * B, K)[:nrows]


def bsr_spmm(vals, brick_row, brick_col, row_start, X, nrows: int):
    """K12: the whole BSR-128 SpMM, Y (nrows, K) from the bricks vals
    (nbricks, 128, 128) f32 sorted by row block, their coordinates
    brick_row / brick_col (nbricks,) int32, each row block's brick range
    row_start (nrb + 1,) int64, and X (ncols, K) f32 row-major; see
    bsr_spmm_plain.  vals must start on a 16 B boundary (X may not)."""
    args = (vals, brick_row, brick_col, row_start, X)
    if not _on_card("bsr_spmm", *args):
        return bsr_spmm_plain(*args, nrows)
    for t, dt in zip(args, (torch.float32, torch.int32, torch.int32,
                            torch.int64, torch.float32)):
        _check_dtype("bsr_spmm", t, dt)
    nb = vals.shape[0]
    nrb = row_start.shape[0] - 1
    if (vals.shape != (nb, B, B) or brick_col.shape != (nb,)
            or brick_row.shape != (nb,) or X.dim() != 2
            or not 0 <= nrows <= nrb * B):
        raise ValueError("bsr_spmm: bricks (nb, 128, 128), one row and "
                         "column per brick, X (ncols, K), nrows <= nrb*128")
    _check_aligned("bsr_spmm", vals)  # copied in 16 B pieces
    K = X.shape[1]
    Y = torch.empty((nrows, K), dtype=torch.float32, device=X.device)
    if nrows and K:
        _launch("cvr_bsr_spmm", X.device, _p(vals), _p(brick_col),
                _p(row_start), _p(X), _p(Y), nrb, nrows, X.shape[0], K)
        bsr_spmm.launches += 1
    return Y


bsr_spmm.launches = 0

# name -> (wrapper, plain version, TPU kernel it replaces)
KERNELS = {
    "bsr_spmm": (bsr_spmm, bsr_spmm_plain, "cvr_tpu/ops/pallas_bsr.py:42"),
}
