"""Power-law SpMM with K in lanes: plane-order X row gather + slice reduce.

With a whole X row of K values per stored element, the 128-lane window
constraint that sends the SpMV through the compiled route does not bind,
so this path drops the route:

  1. ys = lane_reduce(...)   K13: every slice's (1024, K) block of sums,
                             reading X rows in place at the plane columns;
  2. y  = ys[first_pos]      each row's first segment (a zero slot for
                             rows whose segments hold nothing);
  3. y[extra_row] += ys[extra_pos]   split rows' other segments.

The plan (``lane_plan``) is the JAX package's, array for array: the SELL
planes with each 8-slice group's rows padded to a multiple of 8, the
emission plane and the output block of each 8-row step.  From the
emission plane the host derives once each output slot's plane-row range
(``lane_table``), as the JAX package's kernel walks it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from cvr_tpu_torch.formats.sell import SellMatrix
from cvr_tpu_torch.ops import lane_kernels as lk

RB = 8  # plane rows per step of the reference kernel
SB = 8  # slices per output block


@dataclass
class LanePlan:
    """Host-side lane-SpMM plan derived from a SellMatrix (C=1024)."""

    cols_l: np.ndarray  # (S_lane * 1024,) int32 plane columns, padded
    vals_l: np.ndarray  # (S_lane, 1024) f32 values, padded rows zero
    emit_l: np.ndarray  # (S_lane,) int32 block-local slice id or -1
    ob: np.ndarray  # (S_lane // RB,) int32 output block per row group
    first_pos: np.ndarray  # (nrows,) int64 into y_sorted flat (+sentinel)
    extra_pos: np.ndarray  # (n_extra,) int64 y_sorted flat positions
    extra_row: np.ndarray  # (n_extra,) int64 rows to add into
    shape: tuple
    nnz: int
    nslices: int  # effective (trailing empty slices dropped)
    convert_time: float = 0.0


_FIELDS = ("cols_l", "vals_l", "emit_l", "ob", "first_pos", "extra_pos",
           "extra_row", "shape", "nnz", "nslices", "convert_time")


def from_reference(lp) -> LanePlan:
    """The port's plan from the JAX package's ``LanePlan`` (its numpy
    attributes only)."""
    return LanePlan(**{k: getattr(lp, k) for k in _FIELDS})


def save_lane(lp: LanePlan, path) -> None:
    """Write the lane plan as the JAX package's ``.npz`` layout."""
    np.savez_compressed(
        path,
        lane_cols=lp.cols_l,
        lane_vals=lp.vals_l,
        lane_emit=lp.emit_l,
        lane_ob=lp.ob,
        lane_first=lp.first_pos,
        lane_extra_pos=lp.extra_pos,
        lane_extra_row=lp.extra_row,
        lane_meta=np.asarray([lp.shape[0], lp.shape[1], lp.nnz, lp.nslices],
                             dtype=np.int64),
    )


def load_lane(path) -> LanePlan:
    """Read a lane plan that either package saved."""
    z = np.load(path)
    m = [int(v) for v in z["lane_meta"]]
    return LanePlan(
        cols_l=z["lane_cols"], vals_l=z["lane_vals"], emit_l=z["lane_emit"],
        ob=z["lane_ob"], first_pos=z["lane_first"],
        extra_pos=z["lane_extra_pos"], extra_row=z["lane_extra_row"],
        shape=(m[0], m[1]), nnz=m[2], nslices=m[3],
    )


def lane_plan(sm: SellMatrix) -> LanePlan:
    """Plan the lane SpMM from a SELL pack (cheap vectorized passes)."""
    from cvr_tpu_torch.formats.sell_routed import group_padded_rmap

    t0 = time.perf_counter()
    if sm.C != 1024:
        raise ValueError("lane SpMM requires C == 1024")
    nrows, ncols = sm.shape
    offs = sm.slice_offsets.astype(np.int64)
    widths = np.diff(offs)
    nsl = int((widths > 0).sum())
    if (widths[nsl:] != 0).any():
        raise AssertionError("zero-width slices must be trailing")
    nsl = max(nsl, 1)
    # pad each 8-slice group's rows to an RB multiple so one step of the
    # reference kernel never emits into two output blocks
    S = int(offs[nsl])
    ngrp = -(-nsl // SB)
    rmap, gstart, _, rows_gp, gshift = group_padded_rmap(offs, nsl, S, SB, RB)
    S_lane = int(rows_gp.sum())
    cols_l = np.zeros((S_lane, 1024), dtype=np.int32)
    vals_l = np.zeros((S_lane, 1024), dtype=np.float32)
    cols_l[rmap] = sm.cols_plane[:S]
    vals_l[rmap] = sm.vals_plane[:S].astype(np.float32)
    emit_l = np.full(S_lane, -1, dtype=np.int32)
    ends = offs[1:]
    sl = np.arange(nsl)
    nonempty = widths[:nsl] > 0
    emit_l[rmap[ends[:nsl][nonempty] - 1]] = (sl[nonempty] % SB).astype(
        np.int32
    )
    ob = np.repeat(np.arange(ngrp), rows_gp // RB).astype(np.int32)
    # y combine maps (slice-sorted flat position -> natural row)
    seg_row = sm.perm.astype(np.int64)
    seg_off = sm.seg_offset.astype(np.int64)
    is_first = (seg_off == 0) & (seg_row < nrows)
    first_pos = np.full(nrows, -1, dtype=np.int64)
    first_pos[seg_row[is_first]] = np.flatnonzero(is_first)
    if (first_pos < 0).any():
        raise AssertionError("row without a first segment")
    nsl8 = ngrp * SB
    # rows whose (empty) first segment sorted past the effective slices
    # read the appended zero slot
    zero_slot = nsl8 * 1024
    first_pos = np.where(first_pos < nsl * 1024, first_pos, zero_slot)
    extra = (~is_first) & (seg_row < nrows)
    extra_pos = np.flatnonzero(extra).astype(np.int64)
    keep = extra_pos < nsl * 1024
    extra_row = seg_row[extra][keep]
    extra_pos = extra_pos[keep]
    return LanePlan(
        cols_l=cols_l.reshape(-1),
        vals_l=vals_l,
        emit_l=emit_l,
        ob=ob,
        first_pos=first_pos,
        extra_pos=extra_pos,
        extra_row=extra_row,
        shape=sm.shape,
        nnz=sm.nnz,
        nslices=nsl,
        convert_time=time.perf_counter() - t0,
    )


def spmm_lane_pack(csr, split_len: int | None = None) -> LanePlan:
    """CSR -> lane-SpMM plan (SELL pack + plan; no route compile)."""
    from cvr_tpu_torch.formats.sell import sell_pack

    if split_len is None:
        mean_len = -(-max(csr.nnz, 1) // max(csr.shape[0], 1))
        split_len = max(1024, 16 * mean_len)
    sm = sell_pack(csr, C=1024, split_len=split_len)
    lp = lane_plan(sm)
    lp.convert_time += sm.convert_time
    return lp


def lane_table(emit_l: np.ndarray, ob: np.ndarray, nslots: int):
    """Each output slot's plane-row range (row0, row1), int32 (nslots,).

    The reference kernel sums plane rows from its start or from the row
    after the previous emission, and writes the sum into slot
    ob[r // RB] * SB + emit_l[r] at an emission row r.  A slot that is
    never written (the last block's unused slices, the zero slot) gets an
    empty range."""
    e = np.flatnonzero(np.asarray(emit_l) >= 0)
    starts = np.concatenate([[0], e[:-1] + 1])
    slot = np.asarray(ob)[e // RB].astype(np.int64) * SB + emit_l[e]
    row0 = np.zeros(nslots, dtype=np.int32)
    row1 = np.zeros(nslots, dtype=np.int32)
    row0[slot] = starts
    row1[slot] = e + 1
    return row0, row1


@dataclass(frozen=True)
class LaneDevice:
    cols_l: torch.Tensor  # (S_lane * 1024,) int32
    vals_l: torch.Tensor  # (S_lane, 1024) f32
    row0: torch.Tensor  # (nslots,) int32 slot s sums plane rows
    row1: torch.Tensor  # [row0[s], row1[s])
    split: lk.Split  # the slots cut into pieces (lane_split), for K13
    first_pos: torch.Tensor  # (nrows,) int64
    extra_pos: torch.Tensor  # (n_extra,) int64
    extra_row: torch.Tensor  # (n_extra,) int64
    shape: tuple
    nnz: int
    nslices: int


def to_device_lane(lp: LanePlan, device="cuda") -> LaneDevice:
    """Upload the plan's planes, its slot table, K13's split of it
    (lane_split, made here once) and the combine maps.  The slots are the
    plan's 8-slice output blocks plus one zero slot."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    nslots = -(-lp.nslices // SB) * SB + 1
    row0, row1 = (put(a, np.int32) for a in lane_table(lp.emit_l, lp.ob,
                                                       nslots))
    return LaneDevice(
        cols_l=put(lp.cols_l, np.int32),
        vals_l=put(lp.vals_l, np.float32),
        row0=row0,
        row1=row1,
        split=lk.lane_split(row0, row1),
        first_pos=put(lp.first_pos, np.int64),
        extra_pos=put(lp.extra_pos, np.int64),
        extra_row=put(lp.extra_row, np.int64),
        shape=tuple(lp.shape),
        nnz=lp.nnz,
        nslices=lp.nslices,
    )


def kernel_args(sd: LaneDevice, X: torch.Tensor) -> tuple:
    """K13's arguments for X (f32, contiguous)."""
    return sd.cols_l, sd.vals_l, sd.row0, sd.row1, X, sd.split


def spmm_lane(sd: LaneDevice, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for dense X (ncols, K) on sd's device; any K in one
    launch."""
    ys = lk.lane_reduce(*kernel_args(sd, X.to(torch.float32).contiguous()))
    y = ys[sd.first_pos]
    if sd.extra_pos.shape[0]:
        y.index_add_(0, sd.extra_row, ys[sd.extra_pos])
    return y
