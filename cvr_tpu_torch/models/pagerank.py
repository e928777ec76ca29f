"""PageRank over the port's SpMVs.

The power method on a link-following operator, as a Python loop over
tensors: each iteration is one SpMV plus a few elementwise and reduction
ops on the device, and one read of the stopping test back to the host,
so the loop stops at the iteration the JAX package's ``while_loop``
stops at.
"""

from __future__ import annotations

import torch

from cvr_tpu_torch.ops.spmv import _device_of, sell_spmv, upload
from cvr_tpu_torch.ops.spmv_routed import spmv_routed


def pagerank(
    matvec,
    nrows: int,
    damping: float = 0.85,
    tol: float = 1e-8,
    max_iters: int = 100,
    out_degree=None,
    device="cuda",
):
    """Power-method PageRank.

    matvec: y = A^T_normalized @ p on ``device``, where the caller
    provides the link-following operator, typically
    ``lambda p: spmv(A_T, p / out_degree)`` for adjacency A.
    out_degree: optional [nrows] array (numpy or torch, cast to float32 on
    ``device``); if given, matvec receives the raw rank vector and the
    normalization (+ dangling-mass redistribution) happens here.

    Returns (ranks [nrows], iterations, final_delta), iterations a Python
    int.
    """
    if out_degree is not None:
        out_degree = torch.as_tensor(out_degree, dtype=torch.float32,
                                     device=device)
        contributes = out_degree > 0
        deg = torch.clamp(out_degree, min=1)
        dangles = out_degree == 0

    def normalized_matvec(p):
        if out_degree is None:
            return matvec(p)
        spread = matvec(torch.where(contributes, p / deg, 0.0))
        dangling = torch.sum(torch.where(dangles, p, 0.0))
        return spread + dangling / nrows

    p = torch.full((nrows,), 1.0 / nrows, dtype=torch.float32, device=device)
    delta = torch.tensor(float("inf"), device=device)
    it = 0
    while it < max_iters and bool(delta > tol):
        p_new = (1.0 - damping) / nrows + damping * normalized_matvec(p)
        # L1 normalize to counter FP drift.
        p_new = p_new / torch.sum(torch.abs(p_new))
        delta = torch.sum(torch.abs(p_new - p))
        p = p_new
        it += 1
    return p, it, delta


def pagerank_routed(sd, *, transposed_sd=None, device="cuda", **kwargs):
    """PageRank on a routed adjacency (SellRouted, uploaded to ``device``,
    or its device form, run where it lies).

    Pass ``transposed_sd`` packed from the transposed adjacency (swap
    rows/cols in COO before packing): PageRank iterates A^T @ p.
    """
    A = upload(transposed_sd if transposed_sd is not None else sd, device)
    return pagerank(lambda p: spmv_routed(A, p), A.shape[0],
                    device=_device_of(A), **kwargs)


def pagerank_sell(sd, *, transposed_sd=None, device="cuda", **kwargs):
    """PageRank on the plain SELL planes (SellMatrix, uploaded to
    ``device``, or its device form, run where it lies); pass
    ``transposed_sd`` as for ``pagerank_routed``."""
    A = upload(transposed_sd if transposed_sd is not None else sd, device)
    return pagerank(lambda p: sell_spmv(A, p), A.row_rank.shape[0],
                    device=_device_of(A), **kwargs)
