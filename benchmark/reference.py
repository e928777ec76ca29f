"""The plain reference and the comparison that decides ``correct``.

Y = A @ X in float64 with plain PyTorch ops (a gather of X's rows by
the stored entries' columns, a product with their values, a sum into
their rows), in blocks of stored entries, from the matrix and the inputs
the benchmark made, on the card once the program's state is freed (or
on the CPU in the tests); nothing of the program is imported or read.
The number compared is the widest gap of an output entry from the
reference, each over its own scale |A| @ |X| (the sum of the magnitudes
of the products that make it), so that cancellation in a row neither
hides nor inflates an error.  An entry whose scale is 0 must be exactly
0.

``control`` is the reference put in the program's place one precision
lower: the values and inputs rounded to TF32 (10 bits of mantissa, as a
tensor core reads float32) and the sums taken in float32.
"""

from __future__ import annotations

import torch

# products (stored entries times columns) a block holds at most
BLOCK = 1 << 25


def product(rows, cols, vals, X, nrows: int, dtype=torch.float64,
            scale: bool = True):
    """(Y, scale) of A @ X: Y in ``dtype`` with its sums taken in that
    type, scale = |A| @ |X| in float64 (None unless ``scale``).  rows,
    cols int64 and vals are the stored entries, X (ncols,) or
    (ncols, K), all on one device."""
    K = 1 if X.dim() == 1 else X.shape[1]
    Xd = X.to(dtype)
    Y = torch.zeros((nrows,) + tuple(X.shape[1:]), dtype=dtype,
                    device=X.device)
    S = torch.zeros_like(Y, dtype=torch.float64) if scale else None
    per = max(1, BLOCK // K)
    for e0 in range(0, vals.shape[0], per):
        e1 = min(vals.shape[0], e0 + per)
        prod = Xd.index_select(0, cols[e0:e1])
        v = vals[e0:e1].to(dtype)
        prod *= v if K == 1 and X.dim() == 1 else v[:, None]
        Y.index_add_(0, rows[e0:e1], prod)
        if scale:
            S.index_add_(0, rows[e0:e1], prod.abs_().to(torch.float64))
    return Y, S


def reference(rows, cols, vals, X, nrows: int):
    """(Y, scale) in float64."""
    return product(rows, cols, vals, X, nrows)


def tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` rounded to TF32 (the low 13 of 23 mantissa bits
    cleared, to nearest, ties away from zero, as the tensor cores'
    conversion rounds)."""
    b = a.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def control(rows, cols, vals, X, nrows: int):
    """The reference one precision lower: TF32 inputs, float32 sums."""
    Y, _ = product(rows, cols, tf32(vals), tf32(X), nrows,
                   dtype=torch.float32, scale=False)
    return Y


def gap(Y, ref: torch.Tensor, scale: torch.Tensor) -> float:
    """The widest |Y - ref| / scale over the entries (inf where Y is not
    finite, has another shape, or is not 0 where the scale is)."""
    Y = torch.as_tensor(Y).to(ref.device, torch.float64)
    if Y.shape != ref.shape or not bool(torch.isfinite(Y).all()):
        return float("inf")
    if not Y.numel():
        return 0.0
    d = (Y - ref).abs_()
    zero = scale == 0
    if bool((d[zero] > 0).any()):
        return float("inf")
    d.div_(torch.where(zero, 1.0, scale))
    return float(d.max())
