"""The row-sharded routed SpMV: the routed pipeline once per shard.

Rows are partitioned by nnz balance, every shard is SELL-R packed under
one forced geometry (``RoutedForce``, cvr_tpu_torch/formats/sell_routed.py)
and its planes go to its mesh device (cvr_tpu_torch/parallel/dist.py).
x is replicated, or enters row-sharded and is all-gathered before the
per-shard SpMV, or (``overlap=True``) moves round a D-step ring whose
steps each run K15 (``expand_ring``) over the stream blocks whose x
pieces have arrived, while the next piece moves.

The forced geometry mirrors the JAX package, where shard_map needs one
program over identical shapes; every shard gets the same route tiles T,
reduce-group row counts and slice count, y-route length (the largest
shard's rows) and split-row extras count (padding extras add into a row
past the output, which the upload drops).  Each shard's passes are then
the same sequence of kernels, so the launch counts of one SpMV follow
from one shard's geometry.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.formats.sell import sell_pack
from cvr_tpu_torch.formats.sell_routed import (
    RingSpec,
    RoutedForce,
    SellRouted,
    group_padded_rmap,
    pack_routed,
    ring_block_unlock,
    ring_table_base,
    routed_stream_phase,
)
from cvr_tpu_torch.ops import route_planes as rp
from cvr_tpu_torch.ops.route_kernels import expand_ring
from cvr_tpu_torch.ops.spmv_routed import (
    SellRoutedDevice,
    route_post_expand,
    spmv_routed,
    to_device_routed,
)
from cvr_tpu_torch.parallel.dist import (
    Mesh,
    RingPermute,
    concat_rows,
    local_csrs,
    on_shards,
    replicate_or_gather,
)
from cvr_tpu_torch.parallel.partition import (
    partition_balance,
    partition_rows_by_nnz,
)
from cvr_tpu_torch.utils.timing import PhaseTimer

TILE = 1024

_MID_KEYS = ("mid", "m1", "csel", "m3")


@dataclass
class DistRoutedMatrix:
    """Row-sharded SELL-R planes, each shard's on its mesh device."""

    planes: tuple[dict, ...]  # per shard: name -> host array (JAX's names)
    shards: tuple[SellRoutedDevice | None, ...]  # per shard held
    seg_ring: tuple[torch.Tensor | None, ...] | None  # ring packs
    meta: dict  # shared geometry (T, S_pad, nslices, ...)
    bounds: np.ndarray  # [D + 1] global row bounds
    shape: tuple[int, int]
    nnz: int
    mesh: Mesh
    rows_max: int
    balance: dict | None = None  # partition_balance diagnostics
    convert_phases: dict | None = None  # pack seconds by phase

    @property
    def n_shards(self) -> int:
        return int(self.bounds.shape[0] - 1)


def _natural_rcp(sm, n_ycalls, YB, CH):
    _, _, _, rcp, _ = group_padded_rmap(
        sm.slice_offsets.astype(np.int64), sm.nslices, 0, YB, CH,
        n_groups=n_ycalls,
    )
    return rcp


def _shard_packs(csr: CSRMatrix, D: int, split_len: int | None = None,
                overlap: bool = False, pt: PhaseTimer | None = None):
    """Partition rows by nnz and pack each shard under the unified
    geometry.  Returns (bounds, per-shard SellRouted, ring meta or None);
    ``overlap`` also schedules every shard's stream for the ring."""
    from cvr_tpu_torch import _native

    pt = pt or PhaseTimer()
    CH, SEGW, TB, YB = rp.CH, rp.SEGW, rp.TB, rp.YB
    with pt.phase("partition"):
        bounds = partition_rows_by_nnz(csr.rowptr, D)
        locals_ = local_csrs(csr, bounds)
    if split_len is None:
        mean_len = -(-max(csr.nnz, 1) // max(csr.shape[0], 1))
        split_len = max(1024, 16 * mean_len)
    with pt.phase("sell_pack"):
        sms = [sell_pack(lc, C=TILE, split_len=split_len) for lc in locals_]

    # the unified geometry across shards
    nslices_u = max(sm.nslices for sm in sms)
    n_ycalls = max(1, -(-nslices_u // YB))
    rcp_u = np.zeros(n_ycalls, dtype=np.int64)
    for sm in sms:
        rcp_u = np.maximum(rcp_u, _natural_rcp(sm, n_ycalls, YB, CH))
    S_pad_u = int(rcp_u.sum())
    rows_max = max(int(b) for b in (bounds[1:] - bounds[:-1]))
    n_extras_u = max(sm.n_splits for sm in sms)
    ncols = csr.shape[1]
    nwin_total = -(-max(ncols, 1) // TILE)
    segw = min(SEGW, -(-nwin_total // 8) * 8)

    def _phases(srs):
        for sr in srs:
            for k, v in sr.convert_phases.items():
                pt.phases[k] = pt.phases.get(k, 0.0) + v

    if overlap:
        if D < 2:
            raise ValueError("overlap needs a mesh with >= 2 devices")
        force = RoutedForce(rcp=rcp_u, nslices=nslices_u, T=None,
                            nrows_out=rows_max, n_extras=n_extras_u)
        streams = [routed_stream_phase(sm, force) for sm in sms]
        ncols_pad = -(-ncols // (128 * D)) * (128 * D)
        Wr = ncols_pad // (128 * D)
        probe = np.zeros(D, dtype=np.int64)
        cnt_u = np.zeros(D, dtype=np.int64)
        for i, st in enumerate(streams):
            unl = ring_block_unlock(st, RingSpec(D, i, Wr, probe))
            cnt_u = np.maximum(cnt_u, np.bincount(unl, minlength=D))
        srs = [
            pack_routed(sm, force=force, ring=RingSpec(D, i, Wr, cnt_u),
                        stream=st)
            for i, (sm, st) in enumerate(zip(sms, streams))
        ]
        _phases(srs)
        if len({sr.ring_cnt for sr in srs}) != 1:
            raise AssertionError("ring schedule failed to unify shards")
        ring_meta = {
            "ring_cnt": srs[0].ring_cnt,
            # per-step elementwise max across shards: every shard runs
            # the same table spans
            "ring_nsegtab": tuple(
                max(t) for t in zip(*[sr.ring_nsegtab for sr in srs])),
            "ring_Wr": Wr,
        }
        return bounds, srs, ring_meta

    # per-shard stream tile count under the unified S_pad
    with pt.phase("unify_T"):
        T_u = S_pad_u
        n_segs = -(-nwin_total // segw)
        if _native.available():
            for sm in sms:
                rmap, _, _, _, _ = group_padded_rmap(
                    sm.slice_offsets.astype(np.int64), sm.nslices,
                    sm.n_slots, YB, CH, n_groups=n_ycalls,
                    rcp_override=rcp_u,
                )
                T_src_p, _ = _native.stream_count2_native(
                    rmap, sm.cols_plane, S_pad_u, segw * 8 * n_segs, segw,
                    TB)
                T_u = max(T_u, T_src_p)
        else:
            # the JAX package's bound without the library: the stream holds
            # S_pad_u * 1024 elements, each nonempty window adds at most
            # one partial tile, and each segment pads to a TB multiple
            T_u = max(T_u, S_pad_u + nwin_total + n_segs * TB)
        T_u = -(-T_u // TILE) * TILE
    force = RoutedForce(rcp=rcp_u, nslices=nslices_u, T=T_u,
                        nrows_out=rows_max, n_extras=n_extras_u)
    srs = [pack_routed(sm, force=force) for sm in sms]
    _phases(srs)
    return bounds, srs, None


def dist_routed_pack(
    csr: CSRMatrix,
    mesh: Mesh,
    split_len: int | None = None,
    overlap: bool = False,
) -> DistRoutedMatrix:
    """Partition rows by nnz, SELL-R-pack each shard under one forced
    geometry and upload each shard's planes to its mesh device (in a run
    of ranks every rank packs every shard, since the geometry unifies
    them all, and uploads its own).

    split_len default: ``max(1024, 16 * mean_row_len)``.  No hot planes
    are built.  ``overlap=True`` also bakes the ring schedule into every
    shard's stream tile order (RingSpec), for dist_spmv_routed(...,
    overlap=True); such a pack also runs the other two modes.
    """
    pt = PhaseTimer()
    bounds, srs, ring_meta = _shard_packs(csr, mesh.size, split_len, overlap,
                                         pt)
    return _dist_routed_finish(csr, mesh, bounds, srs, ring_meta, pt)


def forced_planes(srs, prefix: str = "") -> tuple[list[dict], dict]:
    """Check that shards packed under one forced geometry share it, and
    name each shard's planes (after ``prefix``) and the shared geometry as
    the JAX package stacks them: (per-shard plane dicts, meta)."""
    s0 = srs[0]
    mid_kind = s0.mid["kind"]
    ymid_kind = s0.y_ra["mid_planes"]["kind"]
    for sr in srs[1:]:
        if (
            sr.T != s0.T
            or sr.S_pad != s0.S_pad
            or sr.nslices != s0.nslices
            or sr.mid["kind"] != mid_kind
            or sr.y_ra["Tp"] != s0.y_ra["Tp"]
            or sr.y_ra["mid_planes"]["kind"] != ymid_kind
            or sr.extra_src.shape != s0.extra_src.shape
        ):
            raise AssertionError("forced geometry failed to unify shards")
    planes = []
    for sr in srs:
        pl = {
            "w8": sr.w8, "gcls": sr.gcls, "li": sr.li, "seg_blk": sr.seg_blk,
            "vals_ss": sr.vals_ss, "p3": sr.p3, "emit": sr.emit,
            "y_s1": sr.y_ra["s1"], "y_s3": sr.y_ra["s3"],
            "extra_src": sr.extra_src.astype(np.int32),
            "extra_row": sr.extra_row.astype(np.int32),
            "ymask": sr.ymask,
        }
        for k in _MID_KEYS:
            if k in sr.mid:
                pl[f"mid_{k}"] = sr.mid[k]
            if k in sr.y_ra["mid_planes"]:
                pl[f"ymid_{k}"] = sr.y_ra["mid_planes"][k]
        planes.append({prefix + k: v for k, v in pl.items()})
    meta = {
        "T": s0.T,
        "S_pad": s0.S_pad,
        "nslices": s0.nslices,
        "segw": s0.segw,
        "n_segs": s0.n_segs,
        "ycall_rows": tuple(
            (int(a), int(b)) for a, b in np.asarray(s0.ycall_rows)),
        "mid_kind": mid_kind,
        "mid_Tk": s0.mid["Tk"],
        "y_T": s0.y_ra["T"],
        "y_Tp": s0.y_ra["Tp"],
        "y_n": s0.y_ra["n"],
        "ymid_kind": ymid_kind,
        "ymid_Tk": s0.y_ra["mid_planes"]["Tk"],
    }
    return planes, meta


def _dist_routed_finish(csr, mesh: Mesh, bounds, srs, ring_meta=None,
                        pt: PhaseTimer | None = None) -> DistRoutedMatrix:
    """Check the shards' geometry, name their planes as the JAX package
    stacks them, and upload."""
    planes, meta = forced_planes(srs)
    if ring_meta is not None:
        for pl, sr in zip(planes, srs):
            pl["seg_ring"] = sr.seg_ring
        meta.update(ring_meta)
    pt = pt or PhaseTimer()
    with pt.phase("upload"):
        dm = _assemble(planes, meta, bounds, csr.shape, csr.nnz, mesh,
                       partition_balance(csr.rowptr, bounds))
    dm.convert_phases = dict(pt.phases)
    return dm


def _local_artifact(meta: dict, pl: dict, shape, nnz: int) -> SellRouted:
    """One shard's host artifact from its planes and the shared geometry
    (forced geometries pack without regular regions or zone A)."""

    def midp(prefix, kind, Tk):
        return {"kind": kind, "Tk": Tk,
                **{k: pl[f"{prefix}{k}"] for k in _MID_KEYS
                   if f"{prefix}{k}" in pl}}

    T, S_pad = int(meta["T"]), int(meta["S_pad"])
    return SellRouted(
        w8=pl["w8"], li=pl["li"], seg_blk=pl["seg_blk"], gcls=pl["gcls"],
        mid=midp("mid_", meta["mid_kind"], meta["mid_Tk"]),
        vals_ss=pl["vals_ss"], p3=pl["p3"], emit=pl["emit"],
        ycall_rows=np.asarray(meta["ycall_rows"], dtype=np.int64).reshape(
            -1, 2),
        regions=np.zeros((0, 5), dtype=np.int64),
        y_ra={"s1": pl["y_s1"], "s3": pl["y_s3"],
              "mid_planes": midp("ymid_", meta["ymid_kind"],
                                 meta["ymid_Tk"]),
              "T": meta["y_T"], "Tp": meta["y_Tp"], "n": meta["y_n"]},
        extra_src=pl["extra_src"], extra_row=pl["extra_row"],
        ymask=pl["ymask"], shape=tuple(shape), nnz=nnz, T=T, S=S_pad,
        S_pad=S_pad, nslices=int(meta["nslices"]), segw=int(meta["segw"]),
        n_segs=int(meta["n_segs"]), n_fillers=(T - S_pad) * TILE,
        seg_ring=pl.get("seg_ring"), ring_cnt=meta.get("ring_cnt"),
        ring_nsegtab=tuple(meta.get("ring_nsegtab", ())),
    )


def _assemble(planes, meta, bounds, shape, nnz, mesh: Mesh,
              balance) -> DistRoutedMatrix:
    """Upload each shard this process holds to its device."""
    D = mesh.size
    if len(planes) != D:
        raise ValueError(f"{len(planes)} shards on a mesh of {D} devices")
    bounds = np.asarray(bounds, dtype=np.int64)
    rows_max = max(int(b) for b in (bounds[1:] - bounds[:-1]))
    if int(meta["y_n"]) != rows_max:
        raise ValueError("the y-route length must be the largest shard's rows")
    part_nnz = np.asarray(balance["part_nnz"]) if balance else np.zeros(D)
    shards = tuple(on_shards(mesh, lambda i: to_device_routed(
        _local_artifact(meta, planes[i], (rows_max, shape[1]),
                        int(part_nnz[i])), mesh.devices[i])))
    ring = "ring_cnt" in meta
    if ring and sum(meta["ring_cnt"]) * rp.TB != int(meta["T"]):
        raise ValueError("the ring steps must cover every tile block")
    seg_ring = tuple(on_shards(mesh, lambda i: torch.from_numpy(
        np.ascontiguousarray(planes[i]["seg_ring"], dtype=np.int32)).to(
            mesh.devices[i]))) if ring else None
    return DistRoutedMatrix(
        planes=tuple(planes), shards=shards, seg_ring=seg_ring, meta=meta,
        bounds=bounds, shape=tuple(shape), nnz=int(nnz), mesh=mesh,
        rows_max=rows_max, balance=balance,
    )


def from_reference(dm, mesh: Mesh) -> DistRoutedMatrix:
    """The port's artifact from the JAX package's ``DistRoutedMatrix``:
    its stacked planes (read as numpy arrays; nothing of the JAX package
    is imported), meta, bounds and shape, uploaded shard by shard to
    ``mesh``."""
    planes_np = {k: np.asarray(v) for k, v in dm.planes.items()
                 if k != "gemit"}  # the port's reduce needs no gemit
    D = int(np.asarray(dm.bounds).shape[0] - 1)
    planes = [{k: np.array(v[i]) for k, v in planes_np.items()}
              for i in range(D)]
    return _assemble(planes, dict(dm.meta), dm.bounds, dm.shape, dm.nnz,
                     mesh, dm.balance)


def dist_spmv_routed(
    dm: DistRoutedMatrix,
    x: torch.Tensor,
    x_sharded: bool = False,
    overlap: bool = False,
) -> torch.Tensor:
    """y = A @ x across the mesh with the routed pipeline per shard; y
    whole on the mesh's home device (its first, or every rank's).

    x_sharded=True all-gathers a row-sharded x (padded to a multiple of
    the mesh size, so any ncols works) before the per-shard SpMV.

    overlap=True (a dist_routed_pack(..., overlap=True) artifact, and
    x_sharded=True) replaces the all-gather with a D-step ring: at step s
    each shard writes the piece it holds into its gathered-x buffer,
    starts the copy of that piece to its neighbour, and, while it moves,
    runs K15 over exactly the stream blocks whose windows read pieces
    received so far (the pack scheduled them contiguously).  The rest of
    the pipeline (route middle, reduce, y-route) runs once after the
    ring.
    """
    if overlap:
        if not x_sharded:
            raise ValueError("overlap requires x_sharded=True")
        if "ring_cnt" not in dm.meta:
            raise ValueError(
                "overlap requires dist_routed_pack(..., overlap=True)")
        return _dist_spmv_routed_overlap(dm, x)
    xs = replicate_or_gather(x, dm.mesh, dm.shape[1], x_sharded)
    rows = np.diff(dm.bounds)
    return concat_rows(dm.mesh, on_shards(dm.mesh, lambda i: spmv_routed(
        dm.shards[i], xs[i])[:rows[i]]), dm.bounds)


def _dist_spmv_routed_overlap(dm: DistRoutedMatrix,
                              x: torch.Tensor) -> torch.Tensor:
    TB = rp.TB
    D = dm.n_shards
    m = dm.meta
    cnt = m["ring_cnt"]
    off = np.zeros(D + 1, dtype=np.int64)
    np.cumsum(np.asarray(cnt, dtype=np.int64), out=off[1:])
    Wr = int(m["ring_Wr"])
    segw = int(m["segw"])
    T = int(m["T"])
    ncols_pad = D * Wr * 128
    # gathered-x buffer rows: every table slice (k_lo+c)*segw8 + segw8+8
    # of a referenced segment lies inside
    XGR = max(int(m["n_segs"]) * segw * 8 + 8, ncols_pad // 128)
    mesh = dm.mesh
    devs = mesh.devices
    x = F.pad(x.to(torch.float32), (0, ncols_pad - x.shape[0]))
    # the row-sharded input: piece i on shard i's device
    cur = on_shards(mesh, lambda i: x[i * Wr * 128 : (i + 1) * Wr * 128]
                    .reshape(Wr, 128).to(devs[i]))
    # zeros where a piece has not arrived yet
    xg = on_shards(mesh, lambda i: torch.zeros(
        (XGR, 128), dtype=torch.float32, device=devs[i]))
    g1 = on_shards(mesh, lambda i: torch.empty(
        (8, T, 128), dtype=torch.float32, device=devs[i]))
    k_lo = on_shards(mesh, lambda i: ring_table_base(RingSpec(D, i, Wr, cnt),
                                                     segw))
    ring = RingPermute(mesh, (Wr, 128))
    for s in range(D):
        for i in mesh.local:
            p = (i - s) % D
            xg[i][p * Wr : (p + 1) * Wr] = cur[i]
        # start the move before the expand, which runs while it is on its way
        nxt = ring.start(cur) if s < D - 1 else cur
        if cnt[s]:
            o0, o1 = int(off[s]), int(off[s + 1])
            for i in mesh.local:
                sd = dm.shards[i]
                expand_ring(sd.w8[o0 * TB : o1 * TB],
                            sd.gcls[o0 * TB // 8 : o1 * TB // 8],
                            dm.seg_ring[i][o0:o1], sd.li, xg[i], o0,
                            int(k_lo[i][s]), segw, g1[i])
        if s < D - 1:
            ring.wait()
        cur = nxt
    # after the last step every shard's buffer holds all of x
    ncols = dm.shape[1]
    rows = np.diff(dm.bounds)
    return concat_rows(mesh, on_shards(mesh, lambda i: route_post_expand(
        dm.shards[i], g1[i], xg[i].view(-1)[:ncols])[:rows[i]]), dm.bounds)


def dist_spmv_routed_jit(
    dm: DistRoutedMatrix,
    x_sharded: bool = False,
    overlap: bool = False,
):
    """A closure over the matrix for iteration-heavy callers (the JAX
    package jits it; torch runs eagerly)."""
    return functools.partial(dist_spmv_routed, dm, x_sharded=x_sharded,
                             overlap=overlap)
