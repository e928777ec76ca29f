"""The PMM SpMM's device pass: K14 ``pmm_spmm`` and its plain version.

As in cvr_tpu_torch/ops/route_kernels.py: the wrapper launches the CUDA
kernel of cvr_tpu_torch/csrc/pmm_kernels.cu for CUDA tensors and counts
the launch in ``pmm_spmm.launches``; given CPU tensors it runs the plain
version, and only then.

On the card the kernel reads a work plan made at upload (``pmm_work``):
the rows cut into segments of at most PMM_PIECE entries (a longer row is
cut into pieces, split_rows), and the segments grouped into units of at
most PMM_UNIT_ROWS, one unit a warp.  A row of one segment is summed by
one fmaf chain from 0 over its entries in column order; the pieces of a
longer row write partial rows, which a second launch adds in piece order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cvr_tpu_torch.ops.route_kernels import (
    INT32_MAX,
    _check_dtype,
    _launch,
    _on_card,
    _p,
    split_rows,
)

SOURCE = "cvr_tpu_torch/csrc/pmm_kernels.cu"

# entries a segment holds at most (a longer row is cut into pieces)
PMM_PIECE = 64
# segments a unit (one warp) takes at most: its 4 groups of 8 lanes take
# them in turn, and 8 lanes hold their offsets
PMM_UNIT_ROWS = 32
# a unit ends before the first segment that starts past a multiple of
# this many entries, so that it holds at most PMM_UNIT_ENTRIES + PMM_PIECE
PMM_UNIT_ENTRIES = 256


@dataclass(frozen=True)
class PmmWork:
    """K14's plan, made at upload, on the kernel's device.  segptr
    (nseg + 1,) int32: each segment's entry range (a whole row, or one
    piece of a row of more than ``piece`` entries, in row order); units
    (nunits, 3) int32: a unit's first and end segment and the destination
    of its first one (its row >= 0, or -1 - its partial; a unit's
    segments are all rows or all pieces, and the next segment goes to the
    next row or partial); combine (nsplit, 3) int32: a split row's first
    partial, end partial and row."""

    segptr: torch.Tensor
    units: torch.Tensor
    combine: torch.Tensor
    npart: int
    piece: int


def pmm_units(segptr, dst):
    """(nunits, 3) int32 numpy units (PmmWork) over segments with entry
    offsets segptr (nseg + 1,) and destinations dst (nseg,): a unit
    starts where the kind of destination changes (row or partial), at
    every PMM_UNIT_ROWS-th segment, and at the first segment that starts
    past a multiple of PMM_UNIT_ENTRIES."""
    segptr = np.asarray(segptr, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    nseg = dst.shape[0]
    start = np.arange(nseg) % PMM_UNIT_ROWS == 0
    block = segptr[:-1] // PMM_UNIT_ENTRIES
    kind = dst >= 0
    start[1:] |= (block[1:] != block[:-1]) | (kind[1:] != kind[:-1])
    first = np.flatnonzero(start)
    end = np.append(first[1:], nseg)[: first.shape[0]]  # none for no segment
    units = np.stack([first, end, dst[first]], 1)
    return np.ascontiguousarray(units, dtype=np.int32).reshape(-1, 3)


def pmm_work(rowptr, piece: int = PMM_PIECE, device="cpu") -> PmmWork:
    """K14's plan of the per-row entry offsets rowptr (nrows + 1,; on the
    host): each row one segment, a row of more than ``piece`` entries cut
    into pieces (split_rows), the segments grouped into units
    (pmm_units), on ``device``."""
    rp = np.asarray(rowptr, dtype=np.int64)
    nrows = rp.shape[0] - 1
    pieces, combine = split_rows(rp[:-1], rp[1:], np.arange(nrows), piece)
    segptr = np.append(pieces[:, 0], rp[-1]).astype(np.int32)
    units = pmm_units(segptr, pieces[:, 2])

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
            device)

    return PmmWork(segptr=put(segptr), units=put(units), combine=put(combine),
                   npart=int((pieces[:, 2] < 0).sum()), piece=piece)


def pmm_geometry(nnz: int, nrows: int, ncols: int, npart: int,
                 K: int) -> None:
    """Raise where K14's 32-bit index arithmetic or its grid cannot
    reach: nnz entries, X (ncols, K), Y (nrows, K), npart partial rows of
    K, a K of more column tiles (8 columns at the 4 B path) than a grid's
    second dimension holds."""
    for what, n in (("entries", nnz), ("X", ncols * K), ("Y", nrows * K),
                    ("partials", npart * K)):
        if n > INT32_MAX:
            raise ValueError(f"pmm_spmm: {what} of {n} elements exceed the "
                             "kernel's 32-bit indices")
    if K > 65535 * 8:
        raise ValueError(f"pmm_spmm: K {K} exceeds the kernel's grid")


def pmm_spmm_plain(col, val, rowptr, X, work=None):
    """Y (nrows, K): row r sums val * X[col] over its entries [rowptr[r],
    rowptr[r + 1]): a gather, a multiply and an ``index_add_``.
    ``work`` (the kernel's) is not read."""
    nrows = rowptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(nrows, device=X.device),
                                  (rowptr[1:] - rowptr[:-1]).long())
    Y = torch.zeros((nrows, X.shape[1]), dtype=torch.float32, device=X.device)
    Y.index_add_(0, row, val[:, None] * X[col.long()])
    return Y


def pmm_spmm(col, val, rowptr, X, work: PmmWork | None = None):
    """K14: the whole PMM SpMM, Y (nrows, K) from the entries' columns
    col (nnz,) int32 and values val (nnz,) f32 in row order, each row
    in column order, the per-row offsets rowptr (nrows + 1,) int32 and X
    (ncols, K) f32 row-major; see pmm_spmm_plain.  On the card the kernel
    reads ``work`` (pmm_work of the same rowptr, made at upload) in place
    of rowptr: two launches where a row is split, the second adding its
    pieces' partials."""
    args = (col, val, rowptr, X)
    if not _on_card("pmm_spmm", *args):
        return pmm_spmm_plain(*args)
    for t, dt in zip(args, (torch.int32, torch.float32, torch.int32,
                            torch.float32)):
        _check_dtype("pmm_spmm", t, dt)
    if (col.dim() != 1 or val.shape != col.shape or rowptr.dim() != 1
            or X.dim() != 2):
        raise ValueError("pmm_spmm: entries (nnz,), rowptr (nrows + 1,), "
                         "X (ncols, K)")
    if work is None:
        raise ValueError("pmm_spmm: the kernel needs the work plan made at "
                         "upload (pmm_work)")
    _on_card("pmm_spmm", work.segptr, work.units, work.combine, X)
    for t in (work.segptr, work.units, work.combine):
        _check_dtype("pmm_spmm", t, torch.int32)
    nrows = rowptr.shape[0] - 1
    K = X.shape[1]
    pmm_geometry(col.shape[0], nrows, X.shape[0], work.npart, K)
    Y = torch.empty((nrows, K), dtype=torch.float32, device=X.device)
    part = torch.empty((work.npart, K), dtype=torch.float32, device=X.device)
    if work.units.shape[0] and K:
        # 16 B X row pieces where K and X allow them, else 4 B
        vec = int(K % 4 == 0 and X.data_ptr() % 16 == 0)
        _launch("cvr_pmm_spmm", X.device, _p(col), _p(val), _p(work.segptr),
                _p(work.units), _p(X), _p(Y), _p(part), work.units.shape[0],
                K, vec)
        pmm_spmm.launches += 1
        if work.combine.shape[0]:
            _launch("cvr_pmm_spmm_combine", X.device, _p(part),
                    _p(work.combine), _p(Y), work.combine.shape[0], K)
            pmm_spmm.launches += 1
    return Y


pmm_spmm.launches = 0

# name -> (wrapper, plain version, TPU kernel it replaces)
KERNELS = {
    "pmm_spmm": (pmm_spmm, pmm_spmm_plain, "cvr_tpu/ops/spmm_pmm.py:396"),
}
