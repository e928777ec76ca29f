"""The routed SpMV on an R x C mesh: row blocks by nnz balance, column
blocks of cyclic 1024-column windows.

Device (i, j) owns row block i and column block j of A: window w (1024
columns) belongs to column block w mod C, and its columns become
(w // C) * 1024 + offset of the block, so a block's windows keep their
locality and the block's column count is uniform (ceil(nwin / C)
windows).  Every block is SELL-R packed under one forced geometry, as the
1-D path packs its shards (cvr_tpu_torch/parallel/dist_routed.py).

Per SpMV, device (i, j) all-gathers x block j over the row axis (the R
pieces of block j), runs the port's single-card routed SpMV (K3, K4)
on its block, and the row block's partial ys are reduce-scattered over
the column axis.  In one process the all-gather is the concatenation of
the pieces on each device, and the reduce-scatter is the sum of a row
block's C partials on device (i, 0), in column order, cut into C pieces,
piece j copied to device (i, j); the pieces are put back in row order on
the mesh's first device.  After initialize_distributed block (i, j) is
rank i * C + j: the all-gather runs over the R ranks of column block j,
the reduce-scatter over the C ranks of row block i (nccl's
reduce_scatter, which sums in its own order; gloo has none, so there the
C partials are all-gathered and added in column order, as in one
process), and the ranks' pieces are all-gathered so that y comes back
whole on every rank.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from cvr_tpu_torch import _native
from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.formats.sell import sell_pack
from cvr_tpu_torch.formats.sell_routed import (
    RoutedForce,
    group_padded_rmap,
    pack_routed,
)
from cvr_tpu_torch.ops import route_planes as rp
from cvr_tpu_torch.ops.spmv_routed import (
    SellRoutedDevice,
    spmv_routed,
    to_device_routed,
)
from cvr_tpu_torch.parallel.dist import (
    gather_rows,
    local_csrs,
    world_devices,
)
from cvr_tpu_torch.parallel.dist_routed import _local_artifact, forced_planes
from cvr_tpu_torch.parallel.partition import (
    partition_balance,
    partition_rows_by_nnz,
)

WIN = 1024


@dataclass(frozen=True)
class Mesh2D:
    """An R x C mesh: block (i, j) runs on devices[i][j].

    In a run of ranks (``group`` the world) block (i, j) is rank i * C +
    j, ``rank`` is this process's, ``row_axis`` the group of the R ranks
    of its column block (x's all-gather) and ``col_axis`` that of the C
    ranks of its row block (the partial ys' reduce-scatter)."""

    devices: tuple[tuple[torch.device, ...], ...]
    group: object = None
    rank: int | None = None
    row_axis: object = None
    col_axis: object = None

    @property
    def shape(self) -> tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def local(self) -> tuple[int, ...]:
        """The blocks (row-major) this process holds."""
        return (tuple(range(self.size)) if self.group is None
                else (self.rank,))


def make_mesh2d(R: int, C: int, devices=None) -> Mesh2D:
    """An R x C mesh.  After initialize_distributed, over the world's R * C
    ranks (rank i * C + j holds block (i, j)), with the groups of its two
    axes.  Otherwise over the first R * C of ``devices`` (row-major),
    which may repeat one device; by default the visible CUDA devices, and
    it raises where there is none (``devices=["cpu"] * 4`` runs a 2 x 2
    mesh on the CPU)."""
    if devices is None and dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != R * C:
            raise ValueError(f"make_mesh2d: a {R} x {C} mesh in a world of "
                             f"{dist.get_world_size()} ranks")
        rank = dist.get_rank()
        # every rank makes every group, in one order
        cols = [dist.new_group([i * C + j for i in range(R)])
                for j in range(C)]
        rows = [dist.new_group([i * C + j for j in range(C)])
                for i in range(R)]
        devs = world_devices()
        return Mesh2D(tuple(tuple(devs[i * C : (i + 1) * C])
                            for i in range(R)),
                      group=dist.group.WORLD, rank=rank,
                      row_axis=cols[rank % C], col_axis=rows[rank // C])
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh2d: no CUDA device; pass devices= (e.g. ['cpu'] "
                "* 4) for a run on the CPU"
            )
        devices = [f"cuda:{k}" for k in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices][: R * C]
    if len(devs) != R * C:
        raise ValueError(f"make_mesh2d: {len(devs)} devices for a {R} x {C} "
                         "mesh")
    if len({d.type for d in devs}) != 1:
        raise ValueError("make_mesh2d: a mesh holds devices of one type")
    return Mesh2D(tuple(tuple(devs[i * C : (i + 1) * C]) for i in range(R)))


@dataclass
class Dist2DRoutedMatrix:
    """Each (row block, column block)'s SELL-R planes on its device."""

    planes: tuple[dict, ...]  # per block, row-major (i * C + j): JAX's names
    blocks: tuple[SellRoutedDevice | None, ...]  # row-major, held ones
    meta: dict  # the shared geometry
    bounds: np.ndarray  # [R + 1] global row bounds
    shape: tuple[int, int]
    nnz: int
    mesh: Mesh2D
    rows_max: int  # padded local y length (C divides it)
    nwin_u: int  # 1024-column windows per column block
    balance: dict | None = None

    @property
    def R(self) -> int:
        return self.mesh.shape[0]

    @property
    def C(self) -> int:
        return self.mesh.shape[1]


def _col_block(rows: CSRMatrix, j: int, C: int, nwin_u: int) -> CSRMatrix:
    """Column block j of a row block: its cyclic windows, relabeled."""
    w = (rows.cols >> 10).astype(np.int64)
    keep = (w % C) == j
    newc = ((w[keep] // C) * WIN + (rows.cols[keep] & (WIN - 1))).astype(
        np.int32)
    row_of = np.repeat(np.arange(rows.shape[0], dtype=np.int64),
                       np.diff(rows.rowptr))
    rowptr = np.zeros(rows.shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(row_of[keep], minlength=rows.shape[0]),
              out=rowptr[1:])
    return CSRMatrix(rowptr=rowptr, cols=newc, vals=rows.vals[keep],
                     shape=(rows.shape[0], nwin_u * WIN))


def dist_routed_pack_2d(csr: CSRMatrix, mesh: Mesh2D,
                        split_len: int | None = None) -> Dist2DRoutedMatrix:
    """Pack every (row block, cyclic column block) under one geometry and
    upload each block to its device (in a run of ranks, this rank's
    only)."""
    CH, SEGW, TB, YB = rp.CH, rp.SEGW, rp.TB, rp.YB
    R, C = mesh.shape
    nrows, ncols = csr.shape
    nwin = -(-max(ncols, 1) // WIN)
    nwin_u = -(-nwin // C)
    bounds = partition_rows_by_nnz(csr.rowptr, R)
    if split_len is None:
        mean_len = -(-max(csr.nnz, 1) // max(nrows, 1))
        split_len = max(1024, 16 * mean_len)
    sms = [sell_pack(_col_block(rows, j, C, nwin_u), C=WIN,
                     split_len=split_len)
           for rows in local_csrs(csr, bounds) for j in range(C)]
    # one geometry over all R * C blocks, as the 1-D path unifies shards
    nslices_u = max(max(sm.nslices for sm in sms), 1)
    n_ycalls = max(1, -(-nslices_u // YB))
    rcp_u = np.zeros(n_ycalls, dtype=np.int64)
    for sm in sms:
        _, _, _, rcp, _ = group_padded_rmap(
            sm.slice_offsets.astype(np.int64), sm.nslices, 0, YB, CH,
            n_groups=n_ycalls)
        rcp_u = np.maximum(rcp_u, rcp)
    rows_nat = max(int(b) for b in np.diff(bounds))
    rows_max = -(-rows_nat // C) * C  # the reduce-scatter needs C | len
    segw = min(SEGW, -(-nwin_u // 8) * 8)
    n_segs = -(-nwin_u // segw)
    T_u = int(rcp_u.sum())
    for sm in sms:
        rmap, _, _, _, _ = group_padded_rmap(
            sm.slice_offsets.astype(np.int64), sm.nslices, sm.n_slots, YB,
            CH, n_groups=n_ycalls, rcp_override=rcp_u)
        T_src_p, _ = _native.stream_count2_native(
            rmap, sm.cols_plane, int(rcp_u.sum()), segw * 8 * n_segs, segw,
            TB)
        T_u = max(T_u, T_src_p)
    T_u = -(-T_u // WIN) * WIN
    force = RoutedForce(rcp=rcp_u, nslices=nslices_u, T=T_u,
                        nrows_out=rows_max,
                        n_extras=max(sm.n_splits for sm in sms))
    planes, meta = forced_planes([pack_routed(sm, force=force)
                                  for sm in sms])
    return _assemble(planes, meta, bounds, csr.shape, csr.nnz, mesh,
                     partition_balance(csr.rowptr, bounds), nwin_u)


def _assemble(planes, meta, bounds, shape, nnz, mesh: Mesh2D, balance,
              nwin_u: int) -> Dist2DRoutedMatrix:
    """Upload each block this process holds to its device."""
    R, C = mesh.shape
    if len(planes) != R * C:
        raise ValueError(f"{len(planes)} blocks on a {R} x {C} mesh")
    bounds = np.asarray(bounds, dtype=np.int64)
    rows_max = int(meta["y_n"])
    if rows_max % C:
        raise ValueError("the local y length must be a multiple of C")
    devs = [d for row in mesh.devices for d in row]
    own = set(mesh.local)
    blocks = tuple(
        to_device_routed(_local_artifact(meta, pl, (rows_max, nwin_u * WIN),
                                         0), dev) if b in own else None
        for b, (pl, dev) in enumerate(zip(planes, devs)))
    return Dist2DRoutedMatrix(
        planes=tuple(planes), blocks=blocks, meta=dict(meta), bounds=bounds,
        shape=tuple(shape),
        nnz=int(nnz), mesh=mesh, rows_max=rows_max, nwin_u=nwin_u,
        balance=balance,
    )


def from_reference(jdm, mesh: Mesh2D) -> Dist2DRoutedMatrix:
    """The port's artifact from the JAX package's ``Dist2DRoutedMatrix``:
    its stacked planes (row-major blocks, read as numpy arrays; nothing of
    the JAX package is imported; its ``gemit`` is not needed), meta,
    bounds and shape, uploaded block by block to ``mesh``."""
    stacked = {k: np.asarray(v) for k, v in jdm.planes.items()
               if k != "gemit"}
    n = mesh.size
    planes = [{k: np.array(v[b]) for k, v in stacked.items()}
              for b in range(n)]
    return _assemble(planes, dict(jdm.meta), jdm.bounds, jdm.shape, jdm.nnz,
                     mesh, jdm.balance, int(jdm.nwin_u))


def dist_spmv_routed_2d(dm: Dist2DRoutedMatrix,
                        x: torch.Tensor) -> torch.Tensor:
    """y = A @ x on the R x C mesh; y whole on the mesh's first device (in
    a run of ranks, on every rank's).

    x (ncols,) may lie on any device; its cyclic windows are cut into the
    column blocks, each block into R pieces (piece i of block j on device
    (i, j)), then all-gathered over the row axis; each block runs the
    routed SpMV, and the partial ys are reduce-scattered over the column
    axis."""
    R, C = dm.R, dm.C
    nwin_u = dm.nwin_u
    if (nwin_u * WIN) % R:
        raise ValueError("row-axis size must divide the column-block size")
    xp = F.pad(x.to(torch.float32), (0, nwin_u * C * WIN - x.shape[0]))
    xw = xp.view(nwin_u * C, WIN)
    w = nwin_u * WIN // R  # one row piece of a column block
    devs = dm.mesh.devices

    def piece(i, j):  # piece i of column block j, on device (i, j)
        return xw[j::C].reshape(-1)[i * w : (i + 1) * w].to(devs[i][j])

    py = dm.rows_max // C  # one piece of a row block's y
    rows = np.diff(dm.bounds)
    if dm.mesh.group is not None:
        return _ranks_spmv(dm, piece, py, rows)
    pieces = [[piece(i, j) for j in range(C)] for i in range(R)]
    ys = []
    for i in range(R):
        partial = None
        for j in range(C):
            # the all-gather of block j over the row axis
            xj = torch.cat([pieces[r][j].to(devs[i][j]) for r in range(R)])
            y = spmv_routed(dm.blocks[i * C + j], xj).to(devs[i][0])
            partial = y if partial is None else partial + y
        # the reduce-scatter: piece j on device (i, j), cut to the row
        # block's own rows
        n = int(rows[i])
        ys += [partial[j * py : min((j + 1) * py, n)].to(devs[i][j])
               for j in range(C) if j * py < n]
    return torch.cat([y.to(devs[0][0]) for y in ys])


def _ranks_spmv(dm: Dist2DRoutedMatrix, piece, py: int, rows) -> torch.Tensor:
    """This rank's block of dist_spmv_routed_2d, and y put together from
    every rank's piece."""
    mesh, (R, C) = dm.mesh, dm.mesh.shape
    i, j = divmod(mesh.rank, C)
    xj = gather_rows(piece(i, j), mesh.row_axis)
    y = spmv_routed(dm.blocks[mesh.rank], xj)
    if dist.get_backend(mesh.col_axis) == "gloo":
        parts = gather_rows(y, mesh.col_axis).view(C, -1)
        partial = parts[0]
        for k in range(1, C):  # column order, as in one process
            partial = partial + parts[k]
        mine = partial[j * py : (j + 1) * py]
    else:
        mine = y.new_empty(py)
        dist.reduce_scatter_tensor(mine, y, group=mesh.col_axis)
    g = gather_rows(mine, mesh.group).view(R, C * py)
    return torch.cat([g[r, : int(n)] for r, n in enumerate(rows)])


def dist_spmv_routed_2d_jit(dm: Dist2DRoutedMatrix):
    """A closure over the matrix for iteration-heavy callers (the JAX
    package jits it; torch runs eagerly)."""
    return functools.partial(dist_spmv_routed_2d, dm)
