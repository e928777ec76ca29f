"""The least time an H100 could take for a kernel's work: the bytes the
kernel must move (each input read once, each output written once, where
the data names what it reads: only that) over the memory rate, or its
operations over the card's peak rate for their type, whichever is
larger.  chip_smoke.py's kernels line and bench/profile_passes.py's
per-pass table count the same bytes.

Rates: NVIDIA H100 SXM5 80 GB data sheet (HBM3 3.35 TB/s; float32 67
TFLOP/s outside the tensor cores; TF32 495 TFLOP/s dense on them).
"""

from __future__ import annotations

import torch

from cvr_tpu_torch.ops import route_kernels as rk

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, 80 GB HBM3
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM, TF32 on the tensor cores, dense


def work(name, args, out) -> tuple[int, int, float]:
    """The kernel's work on its inputs ``args`` and output ``out``: (bytes
    it must move, operations it must do, the card's rate for their type).
    Each input byte is read once and each output byte written once; the
    operations are float32 ones outside the tensor cores (one multiply
    and one add per stored
    element, and per column of X for an SpMM kernel: BSR counts its dense
    bricks, lane the plane rows its slots sum, PMM its entries).  BSR's
    f32-grade product runs on the tensor cores as 3xTF32: three TF32
    passes over its bricks at the TF32 rate.  The
    reduces read only the plane rows their slice tables name (this run's
    data); K3 reads, per element of those rows, its value and its composed
    index (in place of K1, the route middle's planes, p3 and the M3
    plane), the elements of its source the index names (x's columns, or
    g1's elements on the ring), and its piece tables; the unfused
    reduce reads its plan's piece tables (in place of emit), and per
    element of those rows its value, p3 entry and one gx element (its
    gemit is not read); K4 its index and the ysp
    elements it names (none for a -1); K3w and K4w as K3 and K4, each
    named element a row of X or ysp (the tile's columns); K14 its
    entries (8 B each), its work plan's tables
    (segment offsets, units, combine table: on the card they take the
    place of the row offsets, which it does not read) and the X rows its
    entries name; K13 the plane rows its slots name and the X rows they
    name, K12 the X rows of the column blocks its bricks name, K8 the x
    entries its rows' diagonals reach and K9 the x prefix it may read
    (a shard of [14] reads a part of x or X)."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    ops, rate = 0, F32_OPS_PER_S
    if name == "route_small":  # the ysp elements the index reaches
        ysp, src, _n = args
        nbytes = (int(torch.unique(src[src >= 0]).numel()) + src.numel()) * 4
    if name == "route_small_cols":  # the ysp rows the index reaches
        ysp, src, _n = args
        named = int(torch.unique(src[src >= 0]).numel())
        nbytes = named * ysp.shape[-1] * 4 + src.numel() * 4
    if name == "reduce_stream":
        emit, _gemit, vals, gx, p3, nys, plan = args
        row0, row1, _ = rk.reduce_stream_table(emit, nys)
        used = int((row1.long() - row0.long()).sum()) * 8 * 128
        nbytes = (4 * (plan.split.pieces.numel() + plan.split.combine.numel())
                  + used * (4 + 2 + 4))
        ops = 2 * used
    if name == "reduce_slices":  # the source elements its index names
        src, _vals, plan, _nys = args
        _, rows = rk.slice_rows(plan.row0, plan.row1)
        used = rows.numel() * 8 * 128
        idx = plan.idx[:, rows].reshape(-1)
        named = torch.unique(idx[(idx >= 0) & (idx < src.numel())]).numel()
        nbytes = (used * (4 + 4) + int(named) * 4
                  + 4 * (plan.split.pieces.numel()
                         + plan.split.combine.numel()))
        ops = 2 * used
    if name == "reduce_slices_cols":  # the rows of X its index names
        X, _vals, plan, _nys = args
        _, rows = rk.slice_rows(plan.row0, plan.row1)
        used = rows.numel() * 8 * 128
        idx = plan.idx[:, rows].reshape(-1)
        named = torch.unique(idx[(idx >= 0) & (idx < X.shape[0])]).numel()
        nbytes = (used * (4 + 4) + int(named) * X.shape[1] * 4
                  + 4 * (plan.split.pieces.numel()
                         + plan.split.combine.numel()))
        ops = 2 * used * X.shape[1]
    # (row0, row1) index and the planes of each reduce
    reduces = {"reduce_hot": (3, 4, slice(1, 3)),
               "window_reduce": (5, 6, slice(0, 2))}
    if name in reduces:
        i0, i1, planes = reduces[name]
        used = int((args[i1].long() - args[i0].long()).sum()) * 8 * 128
        for t in args[planes]:
            if t.dim() == 3:  # read only the used plane elements
                nbytes -= t.numel() * t.element_size()
                nbytes += min(used, t.numel()) * t.element_size()
        ops = 2 * used
    elif name == "dia_spmv":  # the x entries its rows' diagonals reach
        bands, offsets, x = args
        offs = offsets.tolist()
        reach = (min(x.numel(), bands.shape[1] + max(offs))
                 - max(min(offs), 0))
        nbytes += (max(reach, 0) - x.numel()) * 4
        ops = 2 * bands.numel()
    elif name == "bell_gather_mac":  # the x prefix it may read
        nbytes += (args[5] - args[2].numel()) * 4
        ops = 2 * args[0].numel()
    elif name == "dia_spmm":
        ops = 2 * args[0].numel() * out.shape[1]
    elif name == "bsr_spmm":  # three TF32 passes
        _vals, _brow, bcol, _row_start, X, _nrows = args
        xrows = min(int(torch.unique(bcol).numel()) * 128, X.shape[0])
        nbytes += (xrows - X.shape[0]) * X.shape[1] * 4
        ops, rate = 3 * 2 * args[0].numel() * out.shape[1], TF32_OPS_PER_S
    elif name == "lane_reduce":  # the named plane rows, the X rows they name
        cols, vals, row0, row1, X, _split = args
        _, rows = rk.slice_rows(row0, row1)
        used = rows.numel() * 1024
        xrows = int(torch.unique(cols.view(-1, 1024)[rows]).numel())
        nbytes += ((used - vals.numel()) * 8
                   + (xrows - X.shape[0]) * X.shape[1] * 4)
        ops = 2 * used * out.shape[1]
    elif name == "pmm_spmm":  # the X rows its entries name
        col, val, rowptr, X, work = args
        nbytes = sum(t.numel() * t.element_size() for t in (
            col, val, work.segptr, work.units, work.combine))
        nbytes += int(torch.unique(col).numel()) * X.shape[1] * 4
        ops = 2 * col.numel() * out.shape[1]
    nbytes += out.numel() * out.element_size()
    return nbytes, ops, rate


def bound(name, args, out) -> tuple[float, str]:
    """The least time (ms) the card could take for the kernel's work, and
    what sets it: the larger of work()'s bytes over the HBM rate and its
    operations over their rate."""
    nbytes, ops, rate = work(name, args, out)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
