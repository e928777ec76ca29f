"""The row-sharded BELL SpMV: K9 on each 1024-aligned row shard, plus a
routed spill under one forced geometry.

Rows are partitioned by nnz balance with the cuts rounded to 1024 (the
BELL window advances per 1024-row tile, so an aligned shard's planes are
the global ones re-based).  One global probe (``bell_pack(...,
pack_spill=False)``) fixes k and the reach; each shard packs its rows
with columns ``col - lo`` (negative columns down to ``-pre * 128`` are
part of the format) under that k and reach (``reach_force``) and one row
count (``R_sub_min``).  A shard without entries gets zero planes.  The
spill entries go back to global columns, are compressed to their rows
and are routed-packed under one ``RoutedForce`` across the shards.

x is replicated, or row-sharded and all-gathered.  Each shard runs K9
``bell_gather_mac`` and then its spill's routed SpMV (K1, K3, K4) on its
own device, adds the spill's rows through ``sp_map`` (padding rows point
past the shard and are dropped), and the shards' y slices are put back
in row order on the mesh's first device.

K9 reads x in place, column (row - pre)*128 + lane of its x table, and
takes x as 0 outside [0, n_keep).  A shard's column c - lo below 0 names
a real x entry on every shard after the first, so K9 is given the view
x[lo - s:] (no copy) with ``pre - s / 128`` in place of ``pre`` and
``n_keep`` shifted by s, s = min(lo, 128 * pre): its reads are then the
global columns c, 0 only below column 0, past ncols, or past the JAX
package's x window of the shard (``shard_gather_args``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from cvr_tpu_torch.formats.bell import bell_pack
from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.formats.sell import sell_pack
from cvr_tpu_torch.formats.sell_routed import (
    RoutedForce,
    group_padded_rmap,
    pack_routed,
)
from cvr_tpu_torch.ops import bell_kernels as bk
from cvr_tpu_torch.ops import route_planes as rp
from cvr_tpu_torch.ops.spmv_routed import (
    SellRoutedDevice,
    spmv_routed,
    to_device_routed,
)
from cvr_tpu_torch.parallel.dist import (
    Mesh,
    concat_rows,
    local_csrs,
    on_shards,
    replicate_or_gather,
)
from cvr_tpu_torch.parallel.dist_routed import _local_artifact, forced_planes
from cvr_tpu_torch.parallel.partition import (
    partition_balance,
    partition_rows_by_nnz,
)


@dataclass(frozen=True)
class BellShard:
    """One shard's device planes: the BELL planes, and its spill's routed
    artifact with the shard rows of the spill's compressed rows."""

    li: torch.Tensor  # (k, R_sub, 128) int16
    vals: torch.Tensor  # (k, R_sub, 128) f32
    lo: int  # the shard's first global row
    spill: SellRoutedDevice | None
    sp_map: torch.Tensor | None  # (sp_rows_max,) int64; rows_max: dropped


@dataclass
class DistBellMatrix:
    """Row-sharded BELL planes and routed spills, each shard's on its
    device."""

    planes: tuple[dict, ...]  # per shard: name -> host array (JAX's names)
    shards: tuple[BellShard | None, ...]  # the held ones
    meta: dict  # k, reach, d, pre, ncand, TBb, R_sub, spill (its geometry)
    bounds: np.ndarray  # [D + 1] global row bounds (1024-aligned)
    shape: tuple[int, int]
    nnz: int
    mesh: Mesh
    rows_max: int
    balance: dict | None = None

    @property
    def n_shards(self) -> int:
        return int(self.bounds.shape[0] - 1)


def _aligned_bounds(rowptr, D: int, nrows: int) -> np.ndarray:
    """nnz-balanced bounds rounded to 1024 and kept monotone (empty shards
    allowed on tiny inputs)."""
    b = partition_rows_by_nnz(rowptr, D).astype(np.int64)
    b = (b + 512) // 1024 * 1024
    b[0] = 0
    b[-1] = nrows
    for i in range(1, D):
        b[i] = min(max(b[i], b[i - 1]), nrows)
    return b


def _shard_csrs(csr: CSRMatrix, bounds) -> list[CSRMatrix]:
    """Each shard's rows, its columns re-based to ``col - lo``."""
    return [CSRMatrix(rowptr=lc.rowptr,
                      cols=(lc.cols.astype(np.int64) - lo).astype(np.int32),
                      vals=lc.vals, shape=lc.shape)
            for lc, lo in zip(local_csrs(csr, bounds), bounds[:-1])]


def _spill_planes(bms, bounds, ncols: int, rows_nat: int):
    """The shards' spills routed-packed under one forced geometry:
    (per-shard plane dicts under the JAX package's ``sp_`` names, the
    spill's shared geometry), or (None, None) without a spill."""
    CH, SEGW, TB, YB = rp.CH, rp.SEGW, rp.TB, rp.YB
    if not any(bm is not None and bm.spill_raw is not None for bm in bms):
        return None, None
    sp_csrs, sp_maps = [], []
    for i, bm in enumerate(bms):
        if bm is None or bm.spill_raw is None:
            sp_csrs.append(CSRMatrix(
                rowptr=np.zeros(1, np.int64), cols=np.zeros(0, np.int32),
                vals=np.zeros(0, np.float32), shape=(0, ncols)))
            sp_maps.append(np.zeros(0, np.int64))
            continue
        sp_rows, sp_cols, sp_vals = bm.spill_raw
        gcols = (sp_cols.astype(np.int64) + int(bounds[i])).astype(np.int32)
        smap, rows_c = np.unique(sp_rows, return_inverse=True)
        rowptr = np.zeros(smap.size + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows_c, minlength=smap.size), out=rowptr[1:])
        sp_csrs.append(CSRMatrix(rowptr=rowptr, cols=gcols, vals=sp_vals,
                                 shape=(int(smap.size), ncols)))
        sp_maps.append(smap.astype(np.int64))
    sms = [sell_pack(c, C=1024) for c in sp_csrs]
    nsl_u = max(max(sm.nslices for sm in sms), 1)
    n_yc = max(1, -(-nsl_u // YB))
    rcp_u = np.zeros(n_yc, dtype=np.int64)
    for sm in sms:
        _, _, _, rcp, _ = group_padded_rmap(
            sm.slice_offsets.astype(np.int64), sm.nslices, 0, YB, CH,
            n_groups=n_yc)
        rcp_u = np.maximum(rcp_u, rcp)
    sp_rows_max = max(max(c.shape[0] for c in sp_csrs), 1)
    nwin_total = -(-max(ncols, 1) // 1024)
    segw = min(SEGW, -(-nwin_total // 8) * 8)
    n_segs = -(-nwin_total // segw)
    T_u = -(-(int(rcp_u.sum()) + nwin_total + n_segs * TB) // 1024) * 1024
    force = RoutedForce(rcp=rcp_u, nslices=nsl_u, T=T_u,
                        nrows_out=sp_rows_max,
                        n_extras=max(sm.n_splits for sm in sms))
    planes, meta = forced_planes(
        [pack_routed(sm, force=force) for sm in sms], prefix="sp_")
    for pl, m in zip(planes, sp_maps):
        # padding rows point past the shard's rows: dropped
        pl["sp_map"] = np.pad(m, (0, sp_rows_max - m.size),
                              constant_values=rows_nat).astype(np.int32)
    meta["rows_max"] = sp_rows_max
    return planes, meta


def _assemble(planes, meta, bounds, shape, nnz, mesh: Mesh,
              balance) -> DistBellMatrix:
    """Upload each shard's BELL planes, spill artifact and spill row map
    to its device, for the shards this process holds."""
    D = mesh.size
    if len(planes) != D:
        raise ValueError(f"{len(planes)} shards on a mesh of {D} devices")
    bounds = np.asarray(bounds, dtype=np.int64)
    rows_nat = max(int(b) for b in np.diff(bounds))
    spill = meta["spill"]

    def upload(d):
        pl, dev = planes[d], mesh.devices[d]
        sp = sp_map = None
        if spill is not None:
            spl = {k[3:]: v for k, v in pl.items()
                   if k.startswith("sp_") and k != "sp_map"}
            sp = to_device_routed(_local_artifact(
                spill, spl, (int(spill["rows_max"]), int(shape[1])), 0), dev)
            sp_map = torch.from_numpy(
                pl["sp_map"].astype(np.int64)).to(dev)
        return BellShard(
            li=torch.from_numpy(np.ascontiguousarray(pl["li"])).to(dev),
            vals=torch.from_numpy(np.ascontiguousarray(pl["vals"])).to(dev),
            lo=int(bounds[d]), spill=sp, sp_map=sp_map)

    return DistBellMatrix(
        planes=tuple(planes), shards=tuple(on_shards(mesh, upload)),
        meta=dict(meta), bounds=bounds, shape=tuple(shape), nnz=int(nnz),
        mesh=mesh, rows_max=rows_nat, balance=balance,
    )


def dist_bell_pack(csr: CSRMatrix, mesh: Mesh,
                   max_spill: float = 0.04) -> DistBellMatrix:
    """1024-aligned nnz-balanced row shards, each BELL-packed under the
    global probe's k and reach, their spills routed-packed under one
    forced geometry, each shard's planes uploaded to its device.  Raises
    BellInfeasible where the whole matrix fails BELL's gate."""
    D = mesh.size
    nrows, ncols = csr.shape
    bounds = _aligned_bounds(csr.rowptr, D, nrows)
    # the gate and the geometry are global (the offsets are shift-invariant
    # under aligned row shards): one stats pass fixes k and the reach
    probe = bell_pack(csr, max_spill=max_spill, pack_spill=False)
    k_u, reach_u = probe.k, probe.reach
    rows_nat = max(int(b) for b in np.diff(bounds))
    R_sub_min = -(-max(rows_nat, 1) // 128)
    bms = [bell_pack(lc, k=k_u, max_spill=1.0, reach_force=reach_u,
                     R_sub_min=R_sub_min, pack_spill=False)
           if lc.nnz else None
           for lc in _shard_csrs(csr, bounds)]
    ref = next(bm for bm in bms if bm is not None)
    for bm in bms:
        if bm is not None and (bm.R_sub, bm.TBb) != (ref.R_sub, ref.TBb):
            raise AssertionError("BELL forced geometry failed to unify")
    zero = np.zeros((k_u, ref.R_sub, 128), np.float32)
    planes = [{"li": bm.li if bm else zero.astype(np.int16),
               "vals": bm.vals if bm else zero,
               "lo": np.asarray([lo], dtype=np.int32)}
              for bm, lo in zip(bms, bounds[:-1])]
    sp_planes, sp_meta = _spill_planes(bms, bounds, ncols, rows_nat)
    for pl, spl in zip(planes, sp_planes or [{}] * D):
        pl.update(spl)
    meta = {"k": k_u, "reach": reach_u, "d": ref.d, "pre": ref.pre,
            "ncand": ref.ncand, "TBb": ref.TBb, "R_sub": ref.R_sub,
            "spill": sp_meta}
    return _assemble(planes, meta, bounds, csr.shape, csr.nnz, mesh,
                     partition_balance(csr.rowptr, bounds))


def from_reference(jdm, mesh: Mesh) -> DistBellMatrix:
    """The port's artifact from the JAX package's ``DistBellMatrix``: its
    stacked planes (read as numpy arrays; nothing of the JAX package is
    imported; the spill's group-emission plane ``sp_gemit`` is not
    needed), meta, bounds and shape, uploaded shard by shard."""
    stacked = {k: np.asarray(v) for k, v in jdm.planes.items()
               if k != "sp_gemit"}
    D = int(np.asarray(jdm.bounds).shape[0] - 1)
    planes = [{k: np.array(v[i]) for k, v in stacked.items()}
              for i in range(D)]
    return _assemble(planes, dict(jdm.meta), jdm.bounds, jdm.shape, jdm.nnz,
                     mesh, jdm.balance)


def shard_gather_args(dm: DistBellMatrix, d: int, x: torch.Tensor) -> tuple:
    """K9's arguments for shard d on the whole x (f32, contiguous, on the
    shard's device): the view x[lo - s:], s = min(lo, 128 * pre), with
    ``pre - s / 128`` and the x prefix it may read (the JAX package's x
    window of the shard, [lo - 128 * pre, lo + 128 * (R_sub + 8 * TBb -
    pre)), within [0, ncols))."""
    m, sh = dm.meta, dm.shards[d]
    s = min(sh.lo, 128 * int(m["pre"]))
    xv = x[sh.lo - s:]
    n_keep = min(xv.shape[0],
                 (int(m["R_sub"]) + 8 * int(m["TBb"]) - int(m["pre"])) * 128
                 + s)
    return (sh.li, sh.vals, xv, int(m["d"]), int(m["pre"]) - s // 128,
            max(n_keep, 0))


def dist_spmv_bell(dm: DistBellMatrix, x: torch.Tensor,
                   x_sharded: bool = False) -> torch.Tensor:
    """y = A @ x across the mesh, K9 and the spill's routed SpMV on each
    shard; y whole on the mesh's home device.  x_sharded=True all-gathers
    a row-sharded x first."""
    xs = replicate_or_gather(x.to(torch.float32).contiguous(), dm.mesh,
                             dm.shape[1], x_sharded)

    def shard(d):
        sh, xi = dm.shards[d], xs[d]
        y = bk.bell_gather_mac(*shard_gather_args(dm, d, xi)).reshape(-1)
        if sh.spill is not None:
            if y.shape[0] <= dm.rows_max:  # room for the dropped row
                y = F.pad(y, (0, 1))
            y.index_add_(0, sh.sp_map, spmv_routed(sh.spill, xi))
        return y[: int(dm.bounds[d + 1] - dm.bounds[d])]

    return concat_rows(dm.mesh, on_shards(dm.mesh, shard), dm.bounds)


def dist_spmv_bell_jit(dm: DistBellMatrix, x_sharded: bool = False):
    """A closure over the matrix for iteration-heavy callers (the JAX
    package jits it; torch runs eagerly)."""
    return functools.partial(dist_spmv_bell, dm, x_sharded=x_sharded)
