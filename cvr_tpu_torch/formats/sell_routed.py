"""SELL-R: the SELL-pack format extended with a compiled gather route.

On top of the SELL planes (cvr_tpu_torch.formats.sell) the pack compiles:

  * an **expand schedule**: the plane's column ids sorted and cut into
    1024-element tiles whose columns lie in one window of at most
    8 x 128 consecutive columns, plus filler slots where a window
    boundary forces a cut;
  * a **Clos route** (cvr_tpu_torch.ops.route) carrying each expanded x
    value from its column-sorted stream position to its SELL plane
    position: stage 1 composed into the expand index plane, stage 3 into
    the reduce pass's plane, the middle stage standing alone;
  * a **y-route** carrying per-slice lane sums back to natural row order,
    with split-row extra segments combined by a small scatter-add.

The whole route runs at pack time in the native library (without it,
in the JAX package's numpy path) and leaves static index planes, so the
device passes have no data-dependent control flow.
With ``hot="auto"`` (the default) the hub-column hybrid
(cvr_tpu_torch.formats.hot) may first move the hottest columns' elements
into hot planes.  This is the host layer of the port; it builds the same
arrays as the JAX package's pack of the same matrix, array for array.

The row-sharded path (cvr_tpu_torch/parallel/dist_routed.py) packs each
shard under one forced geometry (``RoutedForce``) and, for the
ring-overlapped expand, in a ring-schedule tile order (``RingSpec``).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np

from cvr_tpu_torch.formats.sell import SellMatrix
from cvr_tpu_torch.utils.profiling import load_npz
from cvr_tpu_torch.utils.timing import PhaseTimer

TILE = 1024

# Zone-A eligibility: a 128-segment group joins the lambda-segment zone
# when its longest segment has >= ZONE_MINLEN nnz; below that, the
# round-to-8 slot padding outweighs the finer-granularity width win.
ZONE_MINLEN = 8


@dataclass
class RoutedForce:
    """Geometry overrides so that independently packed row shards share
    one geometry (cvr_tpu_torch/parallel/dist_routed.py).  Every field
    must be >= the shard's natural value."""

    rcp: np.ndarray | None = None  # per-reduce-group padded row counts
    nslices: int | None = None  # uniform slice count
    T: int | None = None  # uniform route tiles
    nrows_out: int | None = None  # y-route output length (>= nrows)
    n_extras: int | None = None  # pad split-row extras to this count


@dataclass
class RingSpec:
    """The ring schedule of the overlapped expand.

    x enters row-sharded; a D-step ring moves the pieces.  Shard
    ``shard`` holds piece ``(shard - s) mod D`` at step ``s``, and every
    expand tile block is scheduled at the step where the last x piece its
    window reads has arrived.  The pack bakes the schedule into the
    stream's tile order (the route absorbs any tile order), so each
    step's expand is one pass over a contiguous block range.
    """

    D: int  # ring size == mesh size
    shard: int  # this shard's position on the mesh
    Wr: int  # x rows (128 columns each) per ring piece
    cnt: np.ndarray  # (D,) unified per-step tile-block counts


@dataclass
class RoutedStream:
    """The stream build's output, before the route compile: the
    distributed pack computes every shard's natural ring schedule from it
    (w8, seg_blk) and unifies the per-step counts before the route is
    compiled against the scheduled tile order."""

    perm: np.ndarray  # (T*1024,) int32 dest plane pos -> src stream pos
    li_flat: np.ndarray  # (T*1024,) int16 in-window offsets (pre-fuse)
    w8: np.ndarray  # (T,) int32 segment-relative sublane bases
    gcls: np.ndarray  # (T//8,) int32 gather class per 8-tile group
    seg_blk: np.ndarray  # (T//TB,) int32 x segment per block
    T: int
    T_src_p: int  # real (unpadded-to-1024) tile count, a TB multiple
    segw: int
    n_segs: int
    rmap: np.ndarray
    offs: np.ndarray
    ycall_rows: np.ndarray
    regions: np.ndarray
    S_padded: int
    nslices_u: int  # the slice count of the y stream (forced or natural)
    pt: PhaseTimer
    zone: dict | None = None  # lambda-segment zone plan (see _zone_plan)
    vals_prov: np.ndarray | None = None  # (S_padded,1024) f32 zone layout


@dataclass
class SellRouted:
    """Host-side routed-SpMV artifact (NumPy planes; see to_device_routed)."""

    # expand schedule
    w8: np.ndarray  # (T,) int32 segment-relative sublane window bases
    li: np.ndarray  # (8, T, 128) int16 in-window offsets (stage-1 fused)
    seg_blk: np.ndarray  # (T // TB,) int32 x-segment per tile block
    gcls: np.ndarray  # (T // 8,) int32 gather class per 8-tile group
    # middle route stage planes (kind "flat" or "rec")
    mid: dict
    # reduce pass
    vals_ss: np.ndarray  # (8, S_pad, 128) f32 value planes, stream layout
    p3: np.ndarray  # (8, S_pad, 128) int16 stage-3 plane
    emit: np.ndarray  # (S_pad,) int32 group-local slice id on ends, -1 else
    ycall_rows: np.ndarray  # (n_groups, 2) int64 padded (start, rows)
    # regular-width regions (grp, row0, n_rows, w, slice_rel) per row:
    # runs of equal slice width w in {1,2,4,8,16}
    regions: np.ndarray  # (n_regions, 5) int64
    # y combine
    y_ra: dict  # route arrays of the y-route (y_sorted -> natural rows)
    extra_src: np.ndarray  # (n_extra,) int64 padded y-stream positions
    extra_row: np.ndarray  # (n_extra,) int64 natural rows to add into
    ymask: np.ndarray  # (nrows_out,) f32 row mask, or (0,) when unneeded
    # geometry
    shape: tuple[int, int]
    nnz: int
    T: int  # route tiles (multiple of 1024)
    S: int  # plane rows (slots)
    S_pad: int
    nslices: int
    segw: int  # 1024-col windows per x-table segment
    n_segs: int
    n_fillers: int
    convert_time: float = 0.0
    convert_phases: dict | None = None
    # ring-overlap schedule (pack_routed(ring=...); see RingSpec)
    seg_ring: np.ndarray | None = None  # (T//TB,) int32 segment - table base
    ring_cnt: tuple | None = None  # tile blocks per ring step
    ring_nsegtab: tuple = ()  # per ring step: segments its x table spans
    # lambda-segment zone (aligned stage-3); 0 = legacy layout
    nslA: int = 0  # zone-A slices (128 segments each, leading)
    zone_rows: int = 0  # padded plane rows covered by zone A
    yslices: int = 0  # y-stream tiles (nslA//8 + zone-B slices)
    # hub-column hybrid: the captured elements' planes
    # (cvr_tpu_torch.formats.hot.HotPlanes); None = pure routed artifact
    hot: object | None = None


_FIELDS = (
    "w8", "li", "seg_blk", "gcls", "mid", "vals_ss", "p3", "emit",
    "ycall_rows", "regions", "y_ra", "extra_src", "extra_row", "ymask",
    "shape", "nnz", "T", "S", "S_pad", "nslices", "segw", "n_segs",
    "n_fillers", "convert_time", "convert_phases", "seg_ring", "ring_cnt",
    "ring_nsegtab", "nslA", "zone_rows", "yslices",
)


def from_reference(sr) -> SellRouted:
    """The port's artifact from the JAX package's ``SellRouted``.

    Reads the reference artifact's numpy attributes only (it imports
    nothing of the JAX package), so planes packed by the reference drive
    the port's passes unchanged, hot planes and ring schedules included.
    """
    from cvr_tpu_torch.formats.hot import HotPlanes

    hp = getattr(sr, "hot", None)
    hot = None
    if hp is not None:
        hot = HotPlanes(**{f.name: getattr(hp, f.name)
                           for f in dataclasses.fields(HotPlanes)})
    return SellRouted(**{k: getattr(sr, k) for k in _FIELDS}, hot=hot)


def _zone_plan(sm: SellMatrix, YB: int, CH: int):
    """Plan the lambda-segment zone split.

    Zone A re-groups the longest sorted segments into 128-segment slices:
    segment g sits at lane g & 127 of slice g >> 7, and its elements fill
    the slice's (row, sublane) slots freely, the freedom the route
    compiler uses to make every zone-A edge's color satisfy
    (q >> 7) == slot sublane, so the reduce's stage-3 is one lane-gather
    per sublane.  Zone B (short segments) keeps the legacy layout.
    Returns None when nothing qualifies.
    """
    if sm.sigma != 0:
        return None
    L = sm.lane_lengths.astype(np.int64)
    P = L.shape[0]
    if P == 0 or P % 1024:
        return None
    g128 = L.reshape(-1, 128).max(axis=1)
    za = g128 >= ZONE_MINLEN
    nza = int(za.shape[0]) if za.all() else int(np.argmin(za))
    nza8 = (nza // 8) * 8  # zone boundary on an old-slice boundary
    if nza8 == 0:
        return None
    zsl_old = nza8 // 8
    nslA = nza8
    widthsA = (-(-g128[:nza8] // 8)).astype(np.int64)
    old_widths = np.diff(sm.slice_offsets.astype(np.int64))
    widths_mixed = np.concatenate([widthsA, old_widths[zsl_old:]])
    offs_mixed = np.zeros(widths_mixed.shape[0] + 1, dtype=np.int64)
    np.cumsum(widths_mixed, out=offs_mixed[1:])
    nslices = int((widths_mixed > 0).sum())
    if (widths_mixed[nslices:] != 0).any():
        raise AssertionError("zero-width slices must be trailing")
    S_mixed = int(offs_mixed[-1])
    rmap, ycall_rows, regions, S_padded = _plan_layout(
        offs_mixed, nslices, S_mixed, YB, CH
    )
    zr0 = rmap[offs_mixed[:nslA]]
    b = int(offs_mixed[nslA])
    zrows = int(rmap[b]) if b < S_mixed else S_padded
    wsum = int(widthsA.sum())
    row_slice = np.full(zrows, -1, dtype=np.int32)
    starts = np.repeat(zr0, widthsA)
    within = np.arange(wsum, dtype=np.int64) - np.repeat(
        np.cumsum(widthsA) - widthsA, widthsA
    )
    row_slice[starts + within] = np.repeat(
        np.arange(nslA, dtype=np.int32), widthsA
    )
    # zone-B old rows -> padded rows (old slices map 1:1 past the zone)
    S_old = sm.n_slots
    zrows_old = int(sm.slice_offsets[zsl_old])
    rmapB = np.zeros(S_old, dtype=np.int64)
    rmapB[zrows_old:] = rmap[wsum : wsum + S_old - zrows_old]
    return {
        "nslA": nslA,
        "zsl_old": zsl_old,
        "zr0": np.ascontiguousarray(zr0, dtype=np.int64),
        "zw": np.ascontiguousarray(widthsA, dtype=np.int32),
        "zrows": zrows,
        "row_slice": row_slice,
        "rmapB": rmapB,
        "rmap": rmap,
        "offs": offs_mixed,
        "ycall_rows": ycall_rows,
        "regions": regions,
        "S_padded": S_padded,
        "nslices": nslices,
        "yslices": nslA // 8 + (nslices - nslA),
    }


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def sell_pack_routed(
    csr, split_len: int | None = None, hot: str = "auto",
    max_T: int | None = None,
) -> SellRouted:
    """CSR -> SELL-R in one step (the routed path's converter entry).

    split_len default: ``max(1024, 16 * mean_row_len)``, widened up to 4x
    while that keeps the segment count within 1024 slices (one flat
    y-route).

    ``hot``: "auto" enables the hub-column hybrid when the pack-time cost
    model predicts a win (cvr_tpu_torch/formats/hot.py), "off" disables
    it.  The JAX package's switches apply the same way: ``CVR_HOT=0``
    disables the hybrid (the harness and the CLI take no ``hot``
    argument, so it is how their users pack without it), ``CVR_HOT=1``
    forces it on whatever the model says, and ``CVR_HOT_NH`` pins the
    hot-set size.

    ``max_T``: raise ValueError once the stream needs more route tiles
    (``pack_auto`` passes the JAX package's one-chip cap, so that both
    packages pick the same format).
    """
    from cvr_tpu_torch.formats.sell import sell_pack

    hot_env = os.environ.get("CVR_HOT", "")
    hotinfo = None
    pt_hot = PhaseTimer()
    if hot == "auto" and hot_env != "0":
        from cvr_tpu_torch.formats.hot import capture_split, plan_hot

        with pt_hot.phase("hot_plan"):
            nh_env = os.environ.get("CVR_HOT_NH", "")
            if nh_env:
                plan = (int(nh_env), 0.0)
            elif hot_env == "1":
                plan = plan_hot(csr, min_net=float("-inf"))
            else:
                plan = plan_hot(csr)
        if plan is not None:
            with pt_hot.phase("hot_capture"):
                csr, hotinfo = capture_split(csr, plan[0], plan[1])

    if split_len is None:
        mean_len = -(-max(csr.nnz, 1) // max(csr.shape[0], 1))
        split_len = max(1024, 16 * mean_len)
        lens = np.diff(csr.rowptr)
        for mult in (1, 2, 4):
            sl = split_len * mult
            G = int(np.maximum(1, -(-lens // sl)).sum())
            if G <= TILE * TILE:
                split_len = sl
                break
    sm = sell_pack(csr, C=TILE, split_len=split_len)
    sr = pack_routed(sm, max_T)
    if hotinfo is not None:
        from cvr_tpu_torch.formats.hot import build_hot_planes
        from cvr_tpu_torch.ops import route_planes as rp

        with pt_hot.phase("hot_planes"):
            sr.hot = build_hot_planes(sm, hotinfo, rp.YB, rp.CH)
        # the artifact represents the full matrix (rest + captured)
        sr.nnz += int(hotinfo.hot_ptr[-1])
    sr.convert_time += sm.convert_time + pt_hot.total
    sr.convert_phases = {
        **(sm.convert_phases or {}),
        **sr.convert_phases,
        **dict(pt_hot.phases),
    }
    return sr


def routed_stream_phase(sm: SellMatrix,
                        force: RoutedForce | None = None) -> RoutedStream:
    """The layout plan and the native stream build, stopping before the
    route compile (see RoutedStream).  A forced pack never takes the zone
    layout (shards need one reduce structure) and refuses more than
    ROUTED_T_CAP route tiles, as the JAX package does."""
    from cvr_tpu_torch import _native
    from cvr_tpu_torch.ops import route_planes as rp

    if not _native.available():
        raise RuntimeError("the routed pack requires the native library")
    CH, YB, TB = rp.CH, rp.YB, rp.TB
    pt = PhaseTimer()
    S = sm.n_slots
    ncols = sm.shape[1]
    zone = None
    vals_prov = None
    if force is None:
        with pt.phase("zone_plan"):
            zone = _zone_plan(sm, YB, CH)
    if zone is not None:
        nslices = nslices_u = zone["nslices"]
        offs = zone["offs"]
        rmap = zone["rmap"]
        ycall_rows = zone["ycall_rows"]
        regions = zone["regions"]
        S_padded = zone["S_padded"]
        with pt.phase("zone_scatter"):
            cols_used, vals_prov = _native.zone_scatter_native(
                sm.slice_offsets, zone["zsl_old"], zone["zr0"],
                sm.lane_lengths, zone["rmapB"], S_padded,
                sm.cols_plane, sm.vals_plane,
            )
        rmap_used = np.arange(S_padded, dtype=np.int64)
    else:
        widths_all = np.diff(sm.slice_offsets)
        nslices = int((widths_all > 0).sum())
        if (widths_all[nslices:] != 0).any():
            raise AssertionError("zero-width slices must be trailing")
        nslices = max(nslices, 1)
        nslices_u = nslices
        if force is not None and force.nslices is not None:
            if force.nslices < nslices:
                raise ValueError("force.nslices below natural slice count")
            nslices_u = force.nslices
        offs = sm.slice_offsets.astype(np.int64)
        rmap, ycall_rows, regions, S_padded = _plan_layout(
            offs, nslices, S, YB, CH, nslices_u=nslices_u, force=force
        )
        cols_used = sm.cols_plane
        rmap_used = rmap
    force_T = 0 if force is None or force.T is None else int(force.T)
    nwin_total = -(-max(ncols, 1) // 1024)
    segw = min(rp.SEGW, _round_up(nwin_total, 8))
    n_segs = -(-nwin_total // segw)
    with pt.phase("stream"):
        perm, li_flat, w8_arr, cand, seg_blk, T, T_src_p = (
            _native.stream_build2_native(
                rmap_used, cols_used, S_padded, segw * 8 * n_segs, segw, TB,
                force_T,
            )
        )
        if force is not None:
            _check_T(T)
        cls_tile = np.where(
            cand <= 1, 1, np.where(cand <= 2, 2, np.where(cand <= 4, 4, 8))
        ).astype(np.int32)
        gcls = np.ascontiguousarray(
            cls_tile.reshape(-1, 8).max(axis=1).astype(np.int32)
        )
        # tiles past the real stream are pure filler: pin their window
        # metadata to deterministic values (the ring scheduler reads them)
        if T_src_p < T:
            w8_arr[T_src_p:] = 0
            seg_blk[T_src_p // TB :] = 0
    return RoutedStream(
        perm=perm, li_flat=li_flat, w8=w8_arr, gcls=gcls, seg_blk=seg_blk,
        T=T, T_src_p=T_src_p, segw=segw, n_segs=n_segs, rmap=rmap,
        offs=offs, ycall_rows=ycall_rows, regions=regions,
        S_padded=S_padded, nslices_u=nslices_u, pt=pt,
        zone=zone, vals_prov=vals_prov,
    )


def ring_block_unlock(st: RoutedStream, ring: RingSpec) -> np.ndarray:
    """Per tile block, the ring step at which every x piece the block's
    windows read has arrived (the earliest step it may expand)."""
    from cvr_tpu_torch.ops import route_planes as rp

    TB = rp.TB
    segw8 = st.segw * 8
    D, Wr, i = ring.D, ring.Wr, ring.shard
    ncr = D * Wr
    seg_of_tile = np.repeat(st.seg_blk.astype(np.int64), TB)
    base = seg_of_tile * segw8 + (st.w8.astype(np.int64) >> 3) * 8
    p_lo = np.clip(base // Wr, 0, D - 1)
    p_hi = np.clip(np.minimum(base + 15, ncr - 1) // Wr, 0, D - 1)
    # piece p arrives at step (i - p) mod D; over the contiguous piece
    # range the max is D-1 iff the last-arriving piece (i+1) is inside
    pstar = (i + 1) % D
    f_lo = (i - p_lo) % D
    f_hi = (i - p_hi) % D
    unlock = np.where(
        (p_lo <= pstar) & (pstar <= p_hi),
        D - 1,
        np.maximum(f_lo, f_hi),
    ).astype(np.int64)
    blk = unlock.reshape(-1, TB).max(axis=1)
    blk[st.T_src_p // TB :] = 0  # pure-filler blocks: schedule anywhere
    return blk


def ring_table_base(ring: RingSpec, segw: int) -> np.ndarray:
    """(D,) the x segment each ring step's table starts at: the segment
    of the piece that arrives at the step, and 0 at the last step.

    Step D-1 is the only step whose arrived pieces wrap the ring (all of
    them): a block whose 16-row window straddles a segment boundary can
    need piece i+1 (unlock D-1) while sitting in a lower segment than
    that piece's, so the last step's table starts at segment 0."""
    p_of_step = (ring.shard - np.arange(ring.D)) % ring.D
    k_lo = (p_of_step * ring.Wr) // (segw * 8)
    k_lo[ring.D - 1] = 0
    return k_lo


def _ring_permute(st: RoutedStream, ring: RingSpec):
    """Reorder the stream by tile blocks into ring-schedule order
    (step-major, fillers padding each step to the unified count) and remap
    the route permutation to it.  Returns (seg_ring, cnt_u, per-step
    nsegtab) and updates ``st`` in place."""
    from cvr_tpu_torch.ops import route_planes as rp

    TB = rp.TB
    D = ring.D
    unlock = ring_block_unlock(st, ring)
    counts = np.bincount(unlock, minlength=D)
    cnt_u = np.asarray(ring.cnt, dtype=np.int64).copy()
    if (counts > cnt_u).any():
        raise ValueError("ring.cnt below this shard's natural counts")
    T_new = int(cnt_u.sum()) * TB
    T_req = _round_up(max(T_new, st.S_padded), 1024)
    cnt_u[D - 1] += (T_req - T_new) // TB
    T_new = T_req
    _check_T(T_new)
    off_u = np.zeros(D + 1, dtype=np.int64)
    np.cumsum(cnt_u, out=off_u[1:])
    order = np.argsort(unlock, kind="stable")
    coff = np.zeros(D + 1, dtype=np.int64)
    np.cumsum(counts, out=coff[1:])
    nblk_new = T_new // TB
    newb = np.full(nblk_new, -1, dtype=np.int64)
    for s in range(D):
        newb[off_u[s] : off_u[s] + counts[s]] = order[coff[s] : coff[s + 1]]
    step_of_new = np.repeat(np.arange(D), cnt_u)
    k_lo = ring_table_base(ring, st.segw)

    real = newb >= 0
    nt = (np.flatnonzero(real)[:, None] * TB + np.arange(TB)).ravel()
    ot = (newb[real][:, None] * TB + np.arange(TB)).ravel()
    w8_new = np.zeros(T_new, dtype=np.int32)
    w8_new[nt] = st.w8[ot]
    gcls_new = np.ones(T_new // 8, dtype=np.int32)
    gcls_new.reshape(-1, TB // 8)[real] = st.gcls.reshape(-1, TB // 8)[
        newb[real]
    ]
    seg_new = np.zeros(nblk_new, dtype=np.int64)
    seg_new[real] = st.seg_blk.astype(np.int64)[newb[real]]
    # pure-filler source blocks and padding blocks read an arbitrary
    # valid table segment: their gather results route to trash
    nreal_blk = st.T_src_p // TB
    base_seg = k_lo[step_of_new]
    seg_new[~real] = base_seg[~real]
    filler_real = real.copy()
    filler_real[real] = newb[real] >= nreal_blk
    seg_new[filler_real] = base_seg[filler_real]
    seg_ring = (seg_new - base_seg).astype(np.int32)
    if (seg_ring < 0).any():
        raise AssertionError("block segment below its ring table base")
    # per-step table spans: the last step's base-0 table may reach any
    # segment, earlier steps only the window-straddle span
    nsegtab = np.ones(D, dtype=np.int64)
    for s in range(D):
        sl = seg_ring[off_u[s] : off_u[s + 1]]
        if sl.size:
            nsegtab[s] = int(sl.max()) + 1

    li_new = np.zeros(T_new * TILE, dtype=np.int16)
    li_new.reshape(-1, TILE)[nt] = st.li_flat.reshape(-1, TILE)[ot]
    tile_map = np.full(st.T, -1, dtype=np.int64)
    tile_map[ot] = nt
    N_plane = st.S_padded * TILE
    src_old = st.perm.astype(np.int64)[:N_plane]
    src_new = tile_map[src_old >> 10] * TILE + (src_old & (TILE - 1))
    if (src_new < 0).any():
        raise AssertionError("route source fell in an unmapped tile")
    perm_new = np.empty(T_new * TILE, dtype=np.int32)
    perm_new[:N_plane] = src_new.astype(np.int32)
    used = np.zeros(T_new * TILE, dtype=bool)
    used[src_new] = True
    perm_new[N_plane:] = np.flatnonzero(~used).astype(np.int32)

    st.perm = perm_new
    st.li_flat = li_new
    st.w8 = w8_new
    st.gcls = gcls_new
    st.seg_blk = seg_new.astype(np.int32)
    st.T = T_new
    return seg_ring, cnt_u, nsegtab


def pack_routed(
    sm: SellMatrix,
    max_T: int | None = None,
    force: RoutedForce | None = None,
    ring: RingSpec | None = None,
    stream: RoutedStream | None = None,
) -> SellRouted:
    """Compile a SellMatrix (C=1024) into the routed-SpMV artifact; raise
    ValueError when the stream needs more than ``max_T`` route tiles.

    ``force`` pins the geometry (tiles, reduce-group row counts, slice
    count, y length, extras count) so that independently packed row
    shards share one (cvr_tpu_torch/parallel/dist_routed.py).  ``ring``
    also puts the stream's tile blocks in ring-schedule order for the
    overlapped expand (RingSpec); ``stream`` reuses a stream already built
    by routed_stream_phase (the distributed pack builds every shard's
    first, to unify the per-step counts).

    The stream build and the route compile are native passes.  Without
    the native library the pack takes the JAX package's numpy path
    (_pack_routed_numpy: no zone layout, every pack under the route tile
    cap); ``ring`` and ``stream`` still require the library.
    """
    from cvr_tpu_torch import _native
    from cvr_tpu_torch.ops import route_planes as rp

    if sm.C != TILE:
        raise ValueError("routed path requires C == 1024")
    if ring is None and stream is None and not _native.available():
        return _pack_routed_numpy(sm, max_T, force)
    st = stream if stream is not None else routed_stream_phase(sm, force)
    pt = st.pt
    if max_T is not None and st.T > max_T:
        raise ValueError(f"the routed stream needs T={st.T} route tiles, "
                         f"above the cap of {max_T}")
    seg_ring, ring_cnt, ring_nsegtab = None, None, ()
    if ring is not None:
        if st.zone is not None:
            # checked before _ring_permute, which updates the stream
            raise ValueError("ring scheduling requires a legacy (non-"
                             "zone) stream; pass a force geometry")
        with pt.phase("ring_schedule"):
            seg_ring, cnt_u, nseg_step = _ring_permute(st, ring)
            ring_cnt = tuple(int(c) for c in cnt_u)
            ring_nsegtab = tuple(int(v) for v in nseg_step)
    zone = st.zone
    with pt.phase("route_plan"):
        if zone is not None:
            li_ss, mid_arr, p3_ss, r2 = _native.route_compile_zone_native(
                st.perm, st.T, st.T, st.S_padded, st.li_flat, zone["nslA"],
                zone["zr0"], zone["zw"], zone["zrows"], zone["row_slice"],
            )
        else:
            li_ss, mid_arr, p3_ss = _native.route_compile_native(
                st.perm, st.T, st.T, st.S_padded, st.li_flat
            )
            r2 = None
    with pt.phase("fuse_planes"):
        mid = rp.middle_planes_from(mid_arr, st.T)
    sr = _pack_routed_tail(
        sm, pt, force, st.offs, st.rmap, st.nslices_u, st.S_padded,
        st.ycall_rows, st.regions, st.w8, li_ss, st.seg_blk, mid, p3_ss,
        st.T, st.n_segs, st.segw, st.T * TILE - st.S_padded * TILE, st.gcls,
        zone, st.vals_prov, r2,
    )
    sr.seg_ring = seg_ring
    sr.ring_cnt = ring_cnt
    sr.ring_nsegtab = ring_nsegtab
    return sr


def _pack_routed_numpy(sm: SellMatrix, max_T: int | None,
                       force: RoutedForce | None) -> SellRouted:
    """pack_routed without the native library, the JAX package's numpy
    path array for array: the plain layout plan (no zone), the expand
    schedule cut by vectorised numpy (phase "expand_tiles"), the route of
    the source stream onto the plane compiled by ops/route.plan_route
    (phase "route_plan": its coloring is pure Python without the
    library), stage 1 fused into the expand plane and the middle's planes
    (phase "fuse_planes"), then the shared tail."""
    from cvr_tpu_torch.ops import route_planes as rp
    from cvr_tpu_torch.ops.route import plan_route

    pt = PhaseTimer()
    CH, YB, TB = rp.CH, rp.YB, rp.TB
    S = sm.n_slots
    ncols = sm.shape[1]
    # rows are length-sorted, so the zero-width slices (all-empty rows)
    # are the trailing ones; the artifact drops them from nslices
    widths_all = np.diff(sm.slice_offsets)
    nslices = int((widths_all > 0).sum())
    if (widths_all[nslices:] != 0).any():
        raise AssertionError("zero-width slices must be trailing")
    nslices = max(nslices, 1)
    nslices_u = nslices
    if force is not None and force.nslices is not None:
        if force.nslices < nslices:
            raise ValueError("force.nslices below natural slice count")
        nslices_u = force.nslices
    offs = sm.slice_offsets.astype(np.int64)
    rmap, ycall_rows, regions, S_padded = _plan_layout(
        offs, nslices, S, YB, CH, nslices_u=nslices_u, force=force
    )
    N_plane = S_padded * TILE
    force_T = 0 if force is None or force.T is None else int(force.T)

    with pt.phase("expand_tiles"):
        # columns at padded plane positions: inserted rows carry col 0 and
        # val 0 (trash on the route's dest side)
        cols_pad = np.zeros((S_padded, TILE), dtype=np.int64)
        cols_pad[rmap] = sm.cols_plane.astype(np.int64)
        cols_flat = cols_pad.reshape(-1)
        order = np.argsort(cols_flat, kind="stable")  # the source stream
        sc = cols_flat[order]
        # cut at every aligned 1024-column window boundary, then every
        # 1024 elements within a window
        wins = sc >> 10
        nwin = int(wins[-1]) + 1 if sc.shape[0] else 0
        wb = np.searchsorted(sc, np.arange(nwin + 1) * 1024)
        wcnt = np.diff(wb)
        nz = wcnt > 0
        tiles_per_win = -(-wcnt[nz] // TILE)
        T_src = int(tiles_per_win.sum())
        # per tile: its window and its start in the stream
        win_of_tile = np.repeat(np.flatnonzero(nz), tiles_per_win)
        cum = np.cumsum(tiles_per_win)
        first_of_win = np.zeros(nz.sum(), dtype=np.int64)
        first_of_win[1:] = cum[:-1]
        k_in_win = np.arange(T_src, dtype=np.int64) - np.repeat(
            first_of_win, tiles_per_win
        )
        win_idx = np.searchsorted(np.flatnonzero(nz), win_of_tile)
        tile_start = wb[:-1][nz][win_idx] + k_in_win * TILE
        tile_end = np.minimum(tile_start + TILE, wb[1:][nz][win_idx])

    with pt.phase("route_plan"):
        # x-table segments: blocks of TB tiles share a segment, so each
        # segment's tile range is padded to a TB multiple
        nwin_total = -(-max(ncols, 1) // 1024)
        segw = min(rp.SEGW, _round_up(nwin_total, 8))
        n_segs = -(-nwin_total // segw)
        seg_of_tile = (win_of_tile // segw).astype(np.int64)
        seg_counts = np.bincount(seg_of_tile, minlength=n_segs)
        seg_padded = -(-seg_counts // TB) * TB
        seg_new_start = np.zeros(n_segs, dtype=np.int64)
        np.cumsum(seg_padded[:-1], out=seg_new_start[1:])
        seg_old_start = np.zeros(n_segs, dtype=np.int64)
        np.cumsum(seg_counts[:-1], out=seg_old_start[1:])
        tile_new = (np.arange(T_src, dtype=np.int64)
                    - seg_old_start[seg_of_tile] + seg_new_start[seg_of_tile])
        T_src_p = int(seg_padded.sum())

        T = _round_up(max(T_src_p, S_padded), 1024)
        if force_T:
            if force_T < T:
                raise ValueError(f"force.T {force_T} < required T {T}")
            T = force_T
        _check_T(T)
        if max_T is not None and T > max_T:
            raise ValueError(f"the routed stream needs T={T} route tiles, "
                             f"above the cap of {max_T}")
        # source stream arrays, filler slots -1
        src_pos = np.full(T * TILE, -1, dtype=np.int64)
        li_flat = np.zeros(T * TILE, dtype=np.int16)
        # w8: segment-relative sublane bases (128-column granularity);
        # aligned windows are the *8 case, every tile in gather class 8
        w8_arr = np.zeros(T, dtype=np.int32)
        w8_arr[tile_new] = ((win_of_tile - seg_of_tile * segw) * 8).astype(
            np.int32)
        gcls = np.full(T // 8, 8, dtype=np.int32)
        seg_blk = np.zeros(T // TB, dtype=np.int32)
        seg_end_blk = (seg_new_start + seg_padded) // TB
        for sg in range(n_segs):
            seg_blk[seg_new_start[sg] // TB : seg_end_blk[sg]] = sg
        tlen = tile_end - tile_start
        tile_of_el = np.repeat(tile_new, tlen)
        starts_rep = np.repeat(tile_start, tlen)
        j_in_tile = np.arange(int(tlen.sum()), dtype=np.int64) - np.repeat(
            np.cumsum(tlen) - tlen, tlen)
        stream_idx = tile_of_el * TILE + j_in_tile
        el = starts_rep + j_in_tile  # index into the sorted stream
        src_pos[stream_idx] = order[el]
        li_flat[stream_idx] = (
            sc[el] - win_of_tile[np.repeat(np.arange(T_src, dtype=np.int64),
                                           tlen)] * 1024
        ).astype(np.int16)
        # fillers keep the offset of their tile's last real column
        short = np.flatnonzero(tlen < TILE)
        fill_tiles, fill_len = tile_new[short], tlen[short]
        if fill_tiles.shape[0]:
            last_li = li_flat[fill_tiles * TILE + (fill_len - 1)]
            pads = TILE - fill_len
            ft_rep = np.repeat(fill_tiles, pads)
            base_rep = np.repeat(fill_len, pads)
            jj = np.arange(int(pads.sum()), dtype=np.int64) - np.repeat(
                np.cumsum(pads) - pads, pads)
            li_flat[ft_rep * TILE + base_rep + jj] = np.repeat(last_li, pads)
        # perm: dest position (plane) -> source stream position
        perm = np.empty(T * TILE, dtype=np.int64)
        stream_of_plane = np.empty(N_plane, dtype=np.int64)
        real = src_pos >= 0
        stream_of_plane[src_pos[real]] = np.flatnonzero(real)
        perm[:N_plane] = stream_of_plane
        trash_src = np.flatnonzero(~real)
        perm[N_plane:] = trash_src[: T * TILE - N_plane]
        if perm[N_plane:].shape[0] != trash_src.shape[0]:
            raise AssertionError("filler/trash count mismatch")
        plan = plan_route(perm)
        if plan.n_tiles != T:
            raise AssertionError(f"route of {plan.n_tiles} tiles, not {T}")

    with pt.phase("fuse_planes"):
        # stage 1 fused into the expand plane: the element emitted at
        # color q of tile a reads li at the pre-stage-1 offset s1[a, q]
        s1 = plan.s1.astype(np.int64)
        li_fused = np.take_along_axis(li_flat.reshape(T, TILE), s1, axis=1)
        li_ss = np.ascontiguousarray(
            li_fused.reshape(T, 8, 128).transpose(1, 0, 2))
        mid = rp.middle_planes(plan)
        # stage 3 plane restricted to the real dest tiles (plane rows)
        p3 = plan.s3[:S_padded].astype(np.int16)
        p3_ss = np.ascontiguousarray(
            p3.reshape(S_padded, 8, 128).transpose(1, 0, 2))

    return _pack_routed_tail(
        sm, pt, force, offs, rmap, nslices_u, S_padded, ycall_rows, regions,
        w8_arr, li_ss, seg_blk, mid, p3_ss, T, n_segs, segw,
        int((~real).sum()), gcls, None, None, None,
    )


def group_padded_rmap(offs, nslices: int, S: int, group_slices: int,
                      row_mult: int, n_groups: int | None = None,
                      rcp_override=None):
    """Row map for group-tail padding: slices group ``group_slices`` per
    reduce group (``n_groups`` groups, by default as many as the slices
    need), each group's rows padded to a ``row_mult`` multiple, or to the
    per-group ``rcp_override`` (already checked >= natural by the
    caller).

    Returns (rmap [S] old->padded row, gstart, rc natural rows, rcp
    padded rows, gshift).
    """
    n_g = (max(1, -(-nslices // group_slices)) if n_groups is None
           else n_groups)
    gstart = offs[np.minimum(np.arange(n_g) * group_slices, nslices)]
    gend = offs[np.minimum((np.arange(n_g) + 1) * group_slices, nslices)]
    rc = gend - gstart
    rcp = (-(-rc // row_mult) * row_mult if rcp_override is None
           else np.asarray(rcp_override, dtype=np.int64))
    gshift = np.zeros(n_g, dtype=np.int64)
    np.cumsum((rcp - rc)[:-1], out=gshift[1:])
    grp_of_row = np.searchsorted(gend, np.arange(S), side="right")
    rmap = np.arange(S, dtype=np.int64) + gshift[
        np.minimum(grp_of_row, n_g - 1)
    ]
    return rmap, gstart, rc, rcp, gshift


def _plan_layout(offs, nslices, S, YB, CH, region_widths=(1, 2, 4, 8, 16),
                 nslices_u=None, force: RoutedForce | None = None):
    """Padded plane layout: row map, reduce-group ranges and regular-width
    regions.

    Slices are length-sorted, so equal widths form contiguous runs; a run
    of >= CH/w slices of width w in ``region_widths`` becomes a REGION:
    up to w-1 zero rows are inserted first so its slice boundaries land
    on the CH grid, and the region's CH-aligned interior sums without the
    emission sweep.  Forced geometries (row shards, which share one reduce
    structure) keep the plain group-tail padding, over the groups of
    ``nslices_u`` slices and to ``force.rcp`` rows each, with no regions.

    Returns (rmap [S] old->padded plane row, ycall_rows (n,2) int64,
    regions (m,5) int64 rows (grp, row0, n_rows, w, slice_rel), S_padded).
    """
    n_groups = max(1, -(-(nslices_u or nslices) // YB))
    if force is not None or S == 0:
        rcp_over = None
        if force is not None and force.rcp is not None:
            _, _, _, rcp0, _ = group_padded_rmap(
                offs, nslices, 0, YB, CH, n_groups=n_groups
            )
            frcp = np.asarray(force.rcp, dtype=np.int64)
            if frcp.shape[0] != n_groups or (frcp < rcp0).any():
                raise ValueError("force.rcp must cover natural group rows")
            rcp_over = frcp
        rmap, gstart, _rc, rcp, gshift = group_padded_rmap(
            offs, nslices, S, YB, CH, n_groups=n_groups,
            rcp_override=rcp_over,
        )
        S_padded = int(rcp.sum()) if S or force is not None else 0
        ycall_rows = np.stack([gstart + gshift, rcp], axis=1).astype(
            np.int64
        )
        return rmap, ycall_rows, np.zeros((0, 5), dtype=np.int64), S_padded

    widths = np.diff(offs)[:nslices]
    cuts = np.flatnonzero(widths[1:] != widths[:-1]) + 1
    run_ends = np.concatenate((cuts, [nslices]))
    run_end_of = np.repeat(
        run_ends, np.diff(np.concatenate(([0], run_ends)))
    )
    slice_row = np.zeros(nslices, dtype=np.int64)  # padded slice starts
    regions = []
    ycall_rows = np.zeros((n_groups, 2), dtype=np.int64)
    total = 0
    for g in range(n_groups):
        ycall_rows[g, 0] = total
        row = total
        s = g * YB
        s_end = min((g + 1) * YB, nslices)
        while s < s_end:
            sb = min(int(run_end_of[s]), s_end)
            w = int(widths[s])
            accepted = False
            if w in region_widths and (sb - s) * w >= CH:
                pad = (-row) % w
                ra = row + pad
                r0 = -(-ra // CH) * CH
                r1 = (ra + (sb - s) * w) // CH * CH
                if r1 - r0 >= CH:
                    accepted = True
                    slice_row[s:sb] = ra + np.arange(sb - s) * w
                    regions.append(
                        (g, r0, r1 - r0, w, s - g * YB + (r0 - ra) // w)
                    )
                    row = ra + (sb - s) * w
            if not accepted:
                slice_row[s:sb] = row + (offs[s:sb] - offs[s])
                row += int(offs[sb] - offs[s])
            s = sb
        rcp_g = -(-(row - total) // CH) * CH
        ycall_rows[g, 1] = rcp_g
        total += rcp_g
    sig_of_row = (
        np.searchsorted(offs[: nslices + 1], np.arange(S), side="right") - 1
    )
    sig_of_row = np.minimum(sig_of_row, nslices - 1)
    rmap = slice_row[sig_of_row] + (np.arange(S) - offs[sig_of_row])
    return (
        rmap,
        ycall_rows,
        np.asarray(regions, dtype=np.int64).reshape(-1, 5),
        total,
    )


def _check_T(T: int) -> None:
    """Refuse a forced pack above ROUTED_T_CAP route tiles, as the JAX
    package refuses every pack there (its chunk-select block spans all
    T/1024 chunks in TPU VMEM): a larger matrix takes more shards."""
    from cvr_tpu_torch.formats import ROUTED_T_CAP

    if T > ROUTED_T_CAP:
        raise ValueError(
            f"matrix too large for one chip's routed path (T={T}, "
            f"Tk > {ROUTED_T_CAP // 1024}); row-shard it across devices "
            "(cvr_tpu_torch.parallel.dist_routed)"
        )


def _pack_routed_tail(
    sm, pt, force, offs, rmap, nslices, S_pad, ycall_rows, regions, w8_arr,
    li_ss, seg_blk, mid, p3_ss, T, n_segs, segw, n_fillers, gcls, zone,
    vals_prov, r2,
) -> SellRouted:
    """Reduce-pass auxiliaries and the y-route.  Under ``force`` the
    y-route has ``force.nrows_out`` outputs, the row mask is always
    present and the split-row extras are padded to ``force.n_extras``
    with entries that add into row ``nrows_out``, past the output (the
    device upload drops them)."""
    from cvr_tpu_torch.ops import route_planes as rp

    nrows, ncols = sm.shape
    nrows_out = nrows
    if force is not None and force.nrows_out is not None:
        if force.nrows_out < nrows:
            raise ValueError("force.nrows_out below nrows")
        nrows_out = force.nrows_out
    with pt.phase("reduce_aux"):
        if zone is not None:
            # zone layout: values sit at provisional positions; r2 maps
            # every final plane position to its provisional source
            vals = vals_prov.reshape(-1)[
                r2[: S_pad * TILE].astype(np.int64)
            ].reshape(S_pad, TILE)
        else:
            vals = np.zeros((S_pad, TILE), dtype=np.float32)
            vals[rmap] = sm.vals_plane.astype(np.float32)
        vals_ss = np.ascontiguousarray(
            vals.reshape(S_pad, 8, 128).transpose(1, 0, 2)
        )
        # emissions carry the slice id LOCAL to the reduce group
        emit = np.full(S_pad, -1, dtype=np.int32)
        ends = offs[1:]  # first row AFTER each slice
        widths = np.diff(offs)
        nonempty = widths > 0
        sl = np.flatnonzero(nonempty).astype(np.int64)
        emit[rmap[ends[nonempty] - 1]] = (sl % rp.YB).astype(np.int32)

    with pt.phase("y_route"):
        # y_sorted flat position of the segment at sorted position g is g
        seg_row = sm.perm.astype(np.int64)  # sorted pos -> row (or nrows)
        seg_off = sm.seg_offset.astype(np.int64)
        is_first = (seg_off == 0) & (seg_row < nrows)
        first_pos = np.full(nrows, -1, dtype=np.int64)
        first_pos[seg_row[is_first]] = np.flatnonzero(is_first)
        if (first_pos < 0).any():
            raise AssertionError("row without a first segment")
        # y-stream tiles: zone-A slices contribute 128 folded segment sums
        # each, compacted 8 slices per tile, so the y flat position of
        # segment g stays g in both layouts
        y_tiles = zone["yslices"] if zone is not None else nslices
        Ty = _round_up(max(-(-nrows_out // TILE), y_tiles), 128)
        # rows whose (zero-length) first segment sorts beyond the effective
        # slices route from free positions; a row mask zeroes them after
        # the route (they are empty rows, y == 0)
        in_range = first_pos < Ty * TILE
        dropped = np.flatnonzero(~in_range)
        ypern = np.empty(Ty * TILE, dtype=np.int64)
        ypern[:nrows] = np.where(in_range, first_pos, -1)
        used = np.zeros(Ty * TILE, dtype=bool)
        used[first_pos[in_range]] = True
        free = np.flatnonzero(~used)
        ypern[dropped] = free[: dropped.shape[0]]
        # rows [nrows, nrows_out) pad a forced geometry: never read back
        ypern[nrows:] = free[
            dropped.shape[0] : dropped.shape[0] + Ty * TILE - nrows
        ]
        if dropped.shape[0] or force is not None:
            # shards share one set of passes, so a forced geometry always
            # carries the (possibly all-ones) mask
            ymask = np.ones(nrows_out, dtype=np.float32)
            ymask[dropped] = 0.0
        else:
            ymask = np.zeros(0, dtype=np.float32)
        y_ra = rp.route_arrays_from_perm(ypern, n=nrows_out)
        extra = (~is_first) & (seg_row < nrows)
        extra_pos = np.flatnonzero(extra).astype(np.int64)  # y_sorted flat
        # remap to the padded stream layout (8, Tp, 128): position
        # sigma*1024 + i*128 + l  ->  i*(Tp*128) + sigma*128 + l
        yTp = y_ra["Tp"]
        sig, rem = extra_pos // 1024, extra_pos % 1024
        i_, l_ = rem // 128, rem % 128
        extra_src = i_ * (yTp * 128) + sig * 128 + l_
        extra_row = seg_row[extra]
        if force is not None and force.n_extras is not None:
            if force.n_extras < extra_src.shape[0]:
                raise ValueError("force.n_extras below natural count")
            pad = force.n_extras - extra_src.shape[0]
            if pad:
                # padding extras read position 0 and add into row
                # nrows_out, past the output
                extra_src = np.concatenate(
                    [extra_src, np.zeros(pad, dtype=np.int64)])
                extra_row = np.concatenate(
                    [extra_row, np.full(pad, nrows_out, dtype=np.int64)])

    return SellRouted(
        w8=w8_arr,
        li=li_ss,
        gcls=gcls,
        mid=mid,
        vals_ss=vals_ss,
        p3=p3_ss,
        emit=emit,
        regions=regions,
        y_ra=y_ra,
        extra_src=extra_src,
        extra_row=extra_row,
        ymask=ymask,
        seg_blk=seg_blk,
        ycall_rows=ycall_rows,
        shape=sm.shape,
        nnz=sm.nnz,
        T=T,
        S=sm.n_slots,
        S_pad=S_pad,
        nslices=nslices,
        segw=segw,
        n_segs=n_segs,
        n_fillers=n_fillers,
        convert_time=pt.total,
        convert_phases=dict(pt.phases),
        nslA=zone["nslA"] if zone is not None else 0,
        zone_rows=zone["zrows"] if zone is not None else 0,
        yslices=zone["yslices"] if zone is not None else nslices,
    )


# ---------------------------------------------------------------------------
# save / load: the JAX package's .npz layout, key for key and dtype for
# dtype, so that either package loads the other's files
# ---------------------------------------------------------------------------

_MID_PLANES = ("mid", "m1", "csel", "m3")


def mid_npz(mid: dict, prefix: str) -> dict:
    """A route middle's planes as .npz entries ``{prefix}_*``."""
    out = {f"{prefix}_{k}": v for k, v in mid.items()
           if k not in ("kind", "Tk")}
    out[f"{prefix}_kind"] = np.bytes_(mid["kind"].encode())
    out[f"{prefix}_Tk"] = np.int64(mid["Tk"])
    return out


def mid_from_npz(z, prefix: str) -> dict:
    mid = {"kind": bytes(z[f"{prefix}_kind"]).decode(),
           "Tk": int(z[f"{prefix}_Tk"])}
    for k in _MID_PLANES:
        if f"{prefix}_{k}" in z:
            mid[k] = z[f"{prefix}_{k}"]
    return mid


def y_route_npz(ra: dict) -> dict:
    """A y-route's arrays (route_planes.route_arrays) as .npz entries
    ``y_*`` and ``ymid_*``."""
    out = {f"y_{k}": v for k, v in ra.items()
           if k not in ("T", "Tp", "n", "mid_planes")}
    out.update(y_T=np.int64(ra["T"]), y_Tp=np.int64(ra["Tp"]),
               y_n=np.int64(ra["n"]))
    return {**out, **mid_npz(ra["mid_planes"], "ymid")}


def y_route_from_npz(z) -> dict:
    return {"s1": z["y_s1"], "s3": z["y_s3"],
            "mid_planes": mid_from_npz(z, "ymid"), "T": int(z["y_T"]),
            "Tp": int(z["y_Tp"]), "n": int(z["y_n"])}


def save_routed(sr: SellRouted, path) -> None:
    """Write the routed artifact as the JAX package's ``.npz`` layout, so
    that a later run loads it in place of the pack and its route compile
    (``cli spmv --save-packed`` / ``--load-packed``).  A ring-scheduled
    artifact keeps its schedule (ring_*): its streams are permuted into
    ring order, and without the schedule they would load as a corrupt
    artifact."""
    hot = {}
    if sr.hot is not None:
        hp = sr.hot
        hot = {
            "hot_hidx": hp.hidx, "hot_hvals": hp.hvals,
            "hot_gcls": hp.hgcls, "hot_emit": hp.hemit,
            "hot_ycall_rows": hp.ycall_rows, "hot_regions": hp.regions,
            "hot_ids": hp.hot_ids,
            "hot_meta": np.asarray([hp.nslices, hp.NH, hp.ncand],
                                   dtype=np.int64),
        }
    np.savez_compressed(
        path,
        w8=sr.w8, li=sr.li, gcls=sr.gcls, seg_blk=sr.seg_blk,
        ycall_rows=sr.ycall_rows, regions=sr.regions,
        vals_ss=sr.vals_ss, p3=sr.p3, emit=sr.emit,
        extra_src=sr.extra_src, extra_row=sr.extra_row, ymask=sr.ymask,
        shape=np.asarray(sr.shape), nnz=np.int64(sr.nnz), T=np.int64(sr.T),
        S=np.int64(sr.S), S_pad=np.int64(sr.S_pad),
        nslices=np.int64(sr.nslices), segw=np.int64(sr.segw),
        n_segs=np.int64(sr.n_segs), n_fillers=np.int64(sr.n_fillers),
        nslA=np.int64(sr.nslA), zone_rows=np.int64(sr.zone_rows),
        yslices=np.int64(sr.yslices),
        ring_seg=(sr.seg_ring if sr.seg_ring is not None
                  else np.zeros(0, dtype=np.int32)),
        ring_cnt=np.asarray(sr.ring_cnt if sr.ring_cnt is not None else (),
                            dtype=np.int64),
        ring_nsegtab=np.asarray(sr.ring_nsegtab, dtype=np.int64),
        **mid_npz(sr.mid, "mid"), **y_route_npz(sr.y_ra), **hot,
    )


def load_routed(path) -> SellRouted:
    """Read a routed artifact that either package saved.  Older layouts
    read as the JAX package reads them: before v10 w8 held 1024-aligned
    window indices and there were no gather classes (all 8), and a file
    without regions, ymask, nslA, zone_rows, yslices or ring_* gets the
    values that mean none."""
    from cvr_tpu_torch.formats.hot import HotPlanes

    z = load_npz(path)
    if "gcls" in z:
        w8, gcls = z["w8"], z["gcls"]
    else:
        w8 = z["w8"] * 8
        gcls = np.full(int(z["T"]) // 8, 8, dtype=np.int32)
    hot = None
    if "hot_meta" in z:
        hm = z["hot_meta"]
        hot = HotPlanes(
            hidx=z["hot_hidx"], hvals=z["hot_hvals"], hgcls=z["hot_gcls"],
            hemit=z["hot_emit"], ycall_rows=z["hot_ycall_rows"],
            regions=z["hot_regions"], hot_ids=z["hot_ids"],
            nslices=int(hm[0]), NH=int(hm[1]), ncand=int(hm[2]),
        )
    ring_seg = z["ring_seg"] if "ring_seg" in z else None
    ring_cnt = z["ring_cnt"] if "ring_cnt" in z else None
    return SellRouted(
        hot=hot, w8=w8, gcls=gcls, li=z["li"], seg_blk=z["seg_blk"],
        regions=(z["regions"] if "regions" in z
                 else np.zeros((0, 5), dtype=np.int64)),
        ycall_rows=z["ycall_rows"], mid=mid_from_npz(z, "mid"),
        vals_ss=z["vals_ss"], p3=z["p3"], emit=z["emit"],
        y_ra=y_route_from_npz(z), extra_src=z["extra_src"],
        extra_row=z["extra_row"],
        ymask=z["ymask"] if "ymask" in z else np.zeros(0, np.float32),
        shape=tuple(int(v) for v in z["shape"]),
        nnz=int(z["nnz"]), T=int(z["T"]), S=int(z["S"]),
        S_pad=int(z["S_pad"]), nslices=int(z["nslices"]),
        segw=int(z["segw"]), n_segs=int(z["n_segs"]),
        n_fillers=int(z["n_fillers"]),
        nslA=int(z["nslA"]) if "nslA" in z else 0,
        zone_rows=int(z["zone_rows"]) if "zone_rows" in z else 0,
        yslices=int(z["yslices"] if "yslices" in z else z["nslices"]),
        seg_ring=ring_seg if ring_seg is not None and ring_seg.size else None,
        ring_cnt=(tuple(int(c) for c in ring_cnt)
                  if ring_cnt is not None and ring_cnt.size else None),
        ring_nsegtab=(tuple(int(v) for v in z["ring_nsegtab"])
                      if "ring_nsegtab" in z else ()),
    )
