"""The row-sharded lane SpMM: K13 on each nnz-balanced row shard.

Rows are partitioned by nnz balance; each shard plans its own rows
against the global columns (``lane_plan(sell_pack(rows, C=1024,
split_len))``, ``split_len`` from the whole matrix's mean row length),
and every plan is padded to the largest one's extents, as the JAX package
pads them for its one shard_map program: zero plane rows with ``emit``
-1, rows past a shard's own reading the zero slot, padding extras adding
into row ``rows_max``, which is dropped.  The port keeps the padded plans
on the host and uploads each shard's own part of its plan.  X is
replicated, or row-sharded and all-gathered; each shard runs the port's
single-card lane SpMM (K13 ``lane_reduce`` over the slot table
``lane_table`` derives from ``emit``, then the first-segment gather and
the extras' adds), and the shards' Y rows are put back in row order on
the mesh's first device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.formats.sell import sell_pack
from cvr_tpu_torch.ops.spmm_lane import (
    RB,
    SB,
    LaneDevice,
    LanePlan,
    lane_plan,
    spmm_lane,
    to_device_lane,
)
from cvr_tpu_torch.parallel.dist import (
    Mesh,
    concat_rows,
    local_csrs,
    on_shards,
    replicate_or_gather,
)
from cvr_tpu_torch.parallel.partition import (
    partition_balance,
    partition_rows_by_nnz,
)

PLANES = ("cols_l", "vals_l", "emit_l", "ob", "first_pos", "extra_pos",
          "extra_row")


@dataclass
class DistLaneMatrix:
    """Row-sharded lane plans: padded to one geometry on the host, each
    shard's own part on its device."""

    planes: tuple[dict, ...]  # per shard: name -> host array (JAX's names)
    shards: tuple[LaneDevice | None, ...]  # the held ones
    meta: dict  # S_lane, nslices: the shared geometry
    bounds: np.ndarray
    shape: tuple[int, int]
    nnz: int
    mesh: Mesh
    rows_max: int
    balance: dict | None = None

    @property
    def n_shards(self) -> int:
        return int(self.bounds.shape[0] - 1)


def _padded(lp: LanePlan, S_u: int, nsl_u: int, nex_u: int,
            rows_max: int) -> dict:
    """One shard's plan padded to the shared extents (the JAX package's
    arrays, first_pos and the extras as int32)."""
    S = lp.vals_l.shape[0]
    nbl_u = nsl_u // SB
    zero_slot = nsl_u * 1024  # the appended zero slot
    first = np.where(lp.first_pos >= lp.nslices * 1024, zero_slot,
                     lp.first_pos)
    return {
        "cols_l": np.concatenate(
            [lp.cols_l, np.zeros((S_u - S) * 1024, np.int32)]),
        "vals_l": np.concatenate(
            [lp.vals_l, np.zeros((S_u - S, 1024), np.float32)]),
        "emit_l": np.concatenate([lp.emit_l, np.full(S_u - S, -1, np.int32)]),
        # padding row groups emit nothing; they point at the last block
        "ob": np.concatenate(
            [lp.ob, np.full((S_u - S) // RB, nbl_u - 1, np.int32)]),
        "first_pos": np.concatenate(
            [first, np.full(rows_max - first.size, zero_slot, np.int64)]
        ).astype(np.int32),
        "extra_pos": np.concatenate(
            [lp.extra_pos,
             np.full(nex_u - lp.extra_pos.size, zero_slot, np.int64)]
        ).astype(np.int32),
        # row rows_max is past the output: dropped
        "extra_row": np.concatenate(
            [lp.extra_row,
             np.full(nex_u - lp.extra_row.size, rows_max, np.int64)]
        ).astype(np.int32),
    }


def _shard_device(pl: dict, meta: dict, nrows: int, ncols: int, nnz: int,
                  device) -> LaneDevice:
    """One shard's own plan on its device: its plane rows up to its last
    emission (the padding rows after it are read by no slot), its own
    rows' first positions and its own split-row extras (the padding
    extras, which add into row rows_max, are dropped)."""
    e = np.flatnonzero(pl["emit_l"] >= 0)
    S = -(-(int(e[-1]) + 1) // RB) * RB if e.size else 0
    keep = pl["extra_row"] < nrows
    return to_device_lane(LanePlan(
        cols_l=pl["cols_l"][: S * 1024], vals_l=pl["vals_l"][:S],
        emit_l=pl["emit_l"][:S], ob=pl["ob"][: S // RB],
        first_pos=pl["first_pos"][:nrows].astype(np.int64),
        extra_pos=pl["extra_pos"][keep].astype(np.int64),
        extra_row=pl["extra_row"][keep].astype(np.int64),
        shape=(nrows, ncols), nnz=nnz, nslices=int(meta["nslices"]),
    ), device)


def _assemble(planes, meta, bounds, shape, nnz, mesh: Mesh,
              balance) -> DistLaneMatrix:
    D = mesh.size
    if len(planes) != D:
        raise ValueError(f"{len(planes)} shards on a mesh of {D} devices")
    bounds = np.asarray(bounds, dtype=np.int64)
    rows = np.diff(bounds)
    shards = tuple(on_shards(mesh, lambda i: _shard_device(
        planes[i], meta, int(rows[i]), int(shape[1]), int(nnz),
        mesh.devices[i])))
    return DistLaneMatrix(
        planes=tuple(planes), shards=shards, meta=dict(meta), bounds=bounds,
        shape=tuple(shape), nnz=int(nnz), mesh=mesh,
        rows_max=int(rows.max()),
        balance=balance,
    )


def dist_lane_pack(csr: CSRMatrix, mesh: Mesh,
                   split_len: int | None = None) -> DistLaneMatrix:
    """Partition rows by nnz, lane-plan each shard, pad the plans to one
    geometry and upload each to its device.  split_len default:
    ``max(1024, 16 * mean_row_len)`` of the whole matrix."""
    nrows = csr.shape[0]
    bounds = partition_rows_by_nnz(csr.rowptr, mesh.size)
    if split_len is None:
        mean_len = -(-max(csr.nnz, 1) // max(nrows, 1))
        split_len = max(1024, 16 * mean_len)
    rows_max = max(int(b) for b in np.diff(bounds))
    lps = [lane_plan(sell_pack(lc, C=1024, split_len=split_len))
           for lc in local_csrs(csr, bounds)]
    S_u = max(lp.vals_l.shape[0] for lp in lps)
    nsl_u = max(-(-lp.nslices // SB) for lp in lps) * SB
    nex_u = max(lp.extra_pos.shape[0] for lp in lps)
    planes = [_padded(lp, S_u, nsl_u, nex_u, rows_max) for lp in lps]
    return _assemble(planes, {"S_lane": S_u, "nslices": nsl_u}, bounds,
                     csr.shape, csr.nnz, mesh,
                     partition_balance(csr.rowptr, bounds))


def from_reference(jdm, mesh: Mesh) -> DistLaneMatrix:
    """The port's artifact from the JAX package's ``DistLaneMatrix``: its
    stacked planes (read as numpy arrays; nothing of the JAX package is
    imported), meta, bounds and shape, uploaded shard by shard."""
    stacked = {k: np.asarray(jdm.planes[k]) for k in PLANES}
    D = int(np.asarray(jdm.bounds).shape[0] - 1)
    planes = [{k: np.array(v[i]) for k, v in stacked.items()}
              for i in range(D)]
    return _assemble(planes, dict(jdm.meta), jdm.bounds, jdm.shape, jdm.nnz,
                     mesh, jdm.balance)


def dist_spmm_lane(dm: DistLaneMatrix, X: torch.Tensor,
                   x_sharded: bool = False) -> torch.Tensor:
    """Y = A @ X across the mesh, K13 on each shard; Y whole on the mesh's
    home device.  X (ncols, K) is replicated, or row-sharded and
    all-gathered (x_sharded=True)."""
    Xs = replicate_or_gather(X.to(torch.float32), dm.mesh, dm.shape[1],
                             x_sharded)
    return concat_rows(dm.mesh, on_shards(dm.mesh, lambda i: spmm_lane(
        dm.shards[i], Xs[i])), dm.bounds)


def dist_spmm_lane_jit(dm: DistLaneMatrix, x_sharded: bool = False):
    """A closure over the matrix for iteration-heavy callers (the JAX
    package jits it; torch runs eagerly)."""
    return functools.partial(dist_spmm_lane, dm, x_sharded=x_sharded)
