"""The lane SpMM's device pass: K13 ``lane_reduce`` and its plain version.

As in cvr_tpu_torch/ops/route_kernels.py: the wrapper launches the CUDA
kernel of cvr_tpu_torch/csrc/lane_kernels.cu for CUDA tensors and counts
the launch in ``lane_reduce.launches``; given CPU tensors it runs the
plain version, and only then.
"""

from __future__ import annotations

import torch

from cvr_tpu_torch.ops.route_kernels import (
    INT32_MAX,
    Split,
    _check_dtype,
    _launch,
    _on_card,
    _p,
    make_split,
)

SOURCE = "cvr_tpu_torch/csrc/lane_kernels.cu"


def lane_reduce_plain(cols, vals, row0, row1, X, split=None):
    """ys (nslots * 1024, K): slot s sums, lane by lane, the plane rows
    [row0[s], row1[s]) of vals (S_lane, 1024) times the X rows that cols
    (S_lane * 1024,) names: the JAX package's gather ``X[cols_l]`` and its
    slice reduce, as a gather and an ``index_add_`` by slot.  ``split``
    (the kernel's) is not read."""
    nslots = row0.shape[0]
    K = X.shape[1]
    lens = (row1 - row0).long()
    slot = torch.repeat_interleave(torch.arange(nslots, device=X.device), lens)
    first = torch.cumsum(lens, 0) - lens  # each slot's place in `rows`
    rows = (torch.arange(slot.shape[0], device=X.device)
            + (row0.long() - first)[slot])
    contrib = vals[rows][:, :, None] * X[cols.view(-1, 1024)[rows].long()]
    ys = torch.zeros((nslots, 1024, K), dtype=torch.float32, device=X.device)
    ys.index_add_(0, slot, contrib)
    return ys.reshape(nslots * 1024, K)


# plane rows a K13 piece sums at most (a slot of more rows is split)
LANE_PIECE_ROWS = 128


def lane_split(row0, row1) -> Split:
    """K13's plan, made at upload: each slot's plane rows (row0, row1)
    cut into pieces of at most LANE_PIECE_ROWS rows (split_rows; slot s
    writes ys block s), on the tables' device."""
    return make_split(row0, row1, torch.arange(row0.shape[0]),
                      LANE_PIECE_ROWS, row0.device)


def lane_geometry(S_lane: int, ncols: int, nslots: int, npart: int,
                  K: int) -> None:
    """Raise where K13's 32-bit index arithmetic or its grid cannot
    reach: planes of S_lane rows, X (ncols, K), ys of nslots blocks or
    npart partial blocks (1024 x K elements each), a K of more column
    tiles than a grid's second dimension holds."""
    for what, n in (("planes", S_lane * 1024), ("X", ncols * K),
                    ("ys", nslots * 1024 * K), ("partials", npart * 1024 * K)):
        if n > INT32_MAX:
            raise ValueError(f"lane_reduce: {what} of {n} elements exceed "
                             "the kernel's 32-bit indices")
    if K > 65535 * 32:
        raise ValueError(f"lane_reduce: K {K} exceeds the kernel's grid")


def lane_reduce(cols, vals, row0, row1, X, split: Split | None = None):
    """K13: the lane SpMM's slice sums ys (nslots * 1024, K) from the plane
    columns cols (S_lane * 1024,) int32 and values vals (S_lane, 1024) f32,
    each slot's plane-row range row0 / row1 (nslots,) int32 and X (ncols,
    K) f32 row-major; see lane_reduce_plain.  On the card the kernel reads
    ``split`` (lane_split of the same table, made at upload) in place of
    row0 / row1: two launches, the second adding the split slots'
    partials."""
    args = (cols, vals, row0, row1, X)
    if not _on_card("lane_reduce", *args):
        return lane_reduce_plain(*args)
    for t, dt in zip(args, (torch.int32, torch.float32, torch.int32,
                            torch.int32, torch.float32)):
        _check_dtype("lane_reduce", t, dt)
    nslots = row0.shape[0]
    if (vals.dim() != 2 or vals.shape[1] != 1024
            or cols.shape != (vals.numel(),) or row1.shape != (nslots,)
            or X.dim() != 2):
        raise ValueError("lane_reduce: planes (S_lane, 1024), one row range "
                         "per slot, X (ncols, K)")
    if split is None:
        raise ValueError("lane_reduce: the kernel needs the split made at "
                         "upload (lane_split)")
    _on_card("lane_reduce", split.pieces, split.combine, X)
    for t in (split.pieces, split.combine):
        _check_dtype("lane_reduce", t, torch.int32)
    K = X.shape[1]
    lane_geometry(vals.shape[0], X.shape[0], nslots, split.npart, K)
    ys = torch.empty((nslots * 1024, K), dtype=torch.float32, device=X.device)
    part = torch.empty((split.npart * 1024, K), dtype=torch.float32,
                       device=X.device)
    if nslots and K:
        # 16 B X row pieces where K and X allow them, else 4 B
        vec = int(K % 4 == 0 and X.data_ptr() % 16 == 0)
        _launch("cvr_lane_reduce", X.device, _p(cols), _p(vals),
                _p(split.pieces), _p(X), _p(ys), _p(part),
                split.pieces.shape[0], K, vec)
        lane_reduce.launches += 1
        if split.combine.shape[0]:
            _launch("cvr_lane_reduce_combine", X.device, _p(part),
                    _p(split.combine), _p(ys), split.combine.shape[0], K)
            lane_reduce.launches += 1
    return ys


lane_reduce.launches = 0

# name -> (wrapper, plain version, TPU kernel it replaces)
KERNELS = {
    "lane_reduce": (lane_reduce, lane_reduce_plain,
                    "cvr_tpu/ops/spmm_lane.py:181"),
}
