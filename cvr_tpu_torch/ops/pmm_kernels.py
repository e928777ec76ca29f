"""The PMM SpMM's device pass: K14 ``pmm_spmm`` and its plain version.

As in cvr_tpu_torch/ops/route_kernels.py: the wrapper launches the CUDA
kernel of cvr_tpu_torch/csrc/pmm_kernels.cu for CUDA tensors and counts
the launch in ``pmm_spmm.launches``; given CPU tensors it runs the plain
version, and only then.
"""

from __future__ import annotations

import torch

from cvr_tpu_torch.ops.route_kernels import _check_dtype, _launch, _on_card, _p

SOURCE = "cvr_tpu_torch/csrc/pmm_kernels.cu"


def pmm_spmm_plain(col, val, rl, chunk_start, X, nrows: int):
    """Y (nrows, K): every element slot with col >= 0 adds val * X[col]
    into row 128 * t + rl of its chunk's row tile t (row tile t owns the
    chunks [chunk_start[t], chunk_start[t + 1])): a gather, a multiply and
    an ``index_add_``."""
    nrt = chunk_start.shape[0] - 1
    chunk_rt = torch.repeat_interleave(torch.arange(nrt, device=X.device),
                                       chunk_start[1:] - chunk_start[:-1])
    row = chunk_rt.repeat_interleave(128) * 128 + rl.long()
    m = col >= 0
    Y = torch.zeros((nrt * 128, X.shape[1]), dtype=torch.float32,
                    device=X.device)
    Y.index_add_(0, row[m], val[m][:, None] * X[col[m].long()])
    return Y[:nrows]


def pmm_spmm(col, val, rl, chunk_start, X, nrows: int):
    """K14: the whole PMM SpMM, Y (nrows, K) from the element slots' col
    (nchunks * 128,) int32 (-1 on pads), val f32 and rl int32, each row
    tile's chunk range chunk_start (nrt + 1,) int64, and X (ncols, K) f32
    row-major; see pmm_spmm_plain."""
    args = (col, val, rl, chunk_start, X)
    if not _on_card("pmm_spmm", *args):
        return pmm_spmm_plain(*args, nrows)
    for t, dt in zip(args, (torch.int32, torch.float32, torch.int32,
                            torch.int64, torch.float32)):
        _check_dtype("pmm_spmm", t, dt)
    nrt = chunk_start.shape[0] - 1
    if (col.shape[0] % 128 or val.shape != col.shape or rl.shape != col.shape
            or X.dim() != 2 or not 0 <= nrows <= nrt * 128):
        raise ValueError("pmm_spmm: 128 slots per chunk, X (ncols, K), "
                         "nrows <= nrt*128")
    K = X.shape[1]
    Y = torch.empty((nrows, K), dtype=torch.float32, device=X.device)
    if nrows and K:
        _launch("cvr_pmm_spmm", X.device, _p(col), _p(val), _p(rl),
                _p(chunk_start), _p(X), _p(Y), nrt, nrows, K)
        pmm_spmm.launches += 1
    return Y


pmm_spmm.launches = 0

# name -> (wrapper, plain version, TPU kernel it replaces)
KERNELS = {
    "pmm_spmm": (pmm_spmm, pmm_spmm_plain, "cvr_tpu/ops/spmm_pmm.py:396"),
}
