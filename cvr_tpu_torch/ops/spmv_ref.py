"""Reference (golden) SpMV implementations and the verifier.

The golden path is float64 NumPy, independent of torch and of every
kernel; the verifier uses a relative tolerance, optionally against the
backward-error row scale sum_j |a_rj| |x_j|.
"""

from __future__ import annotations

import numpy as np
import torch

from cvr_tpu_torch.formats.csr import CSRMatrix


def spmv_golden_numpy(csr: CSRMatrix, x: np.ndarray) -> np.ndarray:
    """Float64 golden y = A @ x on the host."""
    vals = csr.vals.astype(np.float64)
    xg = x.astype(np.float64)[csr.cols]
    y = np.zeros(csr.shape[0], dtype=np.float64)
    np.add.at(y, csr.row_ids(), vals * xg)
    return y


def spmv_csr_torch(
    rowptr: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    x: torch.Tensor,
    nrows: int,
) -> torch.Tensor:
    """Plain torch CSR SpMV: gather, multiply, ``index_add_`` by row; for
    x of shape (ncols, K) the SpMM.

    The CSR baseline of the benchmark; the JAX package wrote no kernel
    for it (its counterpart is a jnp gather + segment_sum), so neither
    does the port.
    """
    lengths = rowptr[1:] - rowptr[:-1]
    row_ids = torch.repeat_interleave(
        torch.arange(nrows, device=x.device), lengths
    )
    contrib = vals.view(-1, *[1] * (x.dim() - 1)) * x[cols]
    y = torch.zeros((nrows, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return y.index_add_(0, row_ids, contrib)


def spmv_row_scale(csr: CSRMatrix, x: np.ndarray) -> np.ndarray:
    """Per-row magnitude scale s_r = sum_j |a_rj| |x_j| (float64).

    The meaningful error bound for a reordered f32 summation is
    |y_r - y_ref_r| <= c * eps * s_r; raw relative error |dy|/|y| blows up
    on rows whose true sum cancels to ~0."""
    vals = np.abs(csr.vals.astype(np.float64))
    xg = np.abs(x.astype(np.float64))[csr.cols]
    s = np.zeros(csr.shape[0], dtype=np.float64)
    np.add.at(s, csr.row_ids(), vals * xg)
    return s


def verify(
    y: np.ndarray,
    y_ref: np.ndarray,
    rtol: float = 1e-6,
    atol: float = 1e-6,
    row_scale: np.ndarray | None = None,
) -> tuple[bool, int, float]:
    """Compare a result against the golden result.

    Returns (ok, n_bad_rows, max_scaled_err).  Criterion:
    |y - y_ref| <= atol + rtol * scale, where scale is |y_ref| by default
    or the row scale when ``row_scale`` is given (use spmv_row_scale for
    signed data, whose row sums cancel).
    """
    y = np.asarray(y, dtype=np.float64)
    y_ref = np.asarray(y_ref, dtype=np.float64)
    err = np.abs(y - y_ref)
    scale = np.abs(y_ref) if row_scale is None else np.asarray(row_scale)
    bad = err > atol + rtol * scale
    denom = np.maximum(scale, atol)
    max_rel = float((err / denom).max()) if err.size else 0.0
    return (not bool(bad.any()), int(bad.sum()), max_rel)
