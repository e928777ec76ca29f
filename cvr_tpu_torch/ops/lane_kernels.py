"""The lane SpMM's device pass: K13 ``lane_reduce`` and its plain version.

As in cvr_tpu_torch/ops/route_kernels.py: the wrapper launches the CUDA
kernel of cvr_tpu_torch/csrc/lane_kernels.cu for CUDA tensors and counts
the launch in ``lane_reduce.launches``; given CPU tensors it runs the
plain version, and only then.
"""

from __future__ import annotations

import torch

from cvr_tpu_torch.ops.route_kernels import _check_dtype, _launch, _on_card, _p

SOURCE = "cvr_tpu_torch/csrc/lane_kernels.cu"


def lane_reduce_plain(cols, vals, row0, row1, X):
    """ys (nslots * 1024, K): slot s sums, lane by lane, the plane rows
    [row0[s], row1[s]) of vals (S_lane, 1024) times the X rows that cols
    (S_lane * 1024,) names: the JAX package's gather ``X[cols_l]`` and its
    slice reduce, as a gather and an ``index_add_`` by slot."""
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


def lane_reduce(cols, vals, row0, row1, X):
    """K13: the lane SpMM's slice sums ys (nslots * 1024, K) from the plane
    columns cols (S_lane * 1024,) int32 and values vals (S_lane, 1024) f32,
    each slot's plane-row range row0 / row1 (nslots,) int32 and X (ncols,
    K) f32 row-major; see lane_reduce_plain."""
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
    K = X.shape[1]
    ys = torch.empty((nslots * 1024, K), dtype=torch.float32, device=X.device)
    if nslots and K:
        _launch("cvr_lane_reduce", X.device, _p(cols), _p(vals), _p(row0),
                _p(row1), _p(X), _p(ys), nslots, K)
        lane_reduce.launches += 1
    return ys


lane_reduce.launches = 0

# name -> (wrapper, plain version, TPU kernel it replaces)
KERNELS = {
    "lane_reduce": (lane_reduce, lane_reduce_plain,
                    "cvr_tpu/ops/spmm_lane.py:181"),
}
