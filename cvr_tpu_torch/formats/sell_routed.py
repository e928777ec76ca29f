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

The whole route runs at pack time in the native library and leaves static
index planes, so the device passes have no data-dependent control flow.
With ``hot="auto"`` (the default) the hub-column hybrid
(cvr_tpu_torch.formats.hot) may first move the hottest columns' elements
into hot planes.  This is the host layer of the port; it builds the same
arrays as the JAX package's pack of the same matrix, array for array.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np

from cvr_tpu_torch.formats.sell import SellMatrix
from cvr_tpu_torch.utils.timing import PhaseTimer

TILE = 1024

# Zone-A eligibility: a 128-segment group joins the lambda-segment zone
# when its longest segment has >= ZONE_MINLEN nnz; below that, the
# round-to-8 slot padding outweighs the finer-granularity width win.
ZONE_MINLEN = 8


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
    "n_fillers", "convert_time", "convert_phases", "nslA", "zone_rows",
    "yslices",
)


def from_reference(sr) -> SellRouted:
    """The port's artifact from the JAX package's ``SellRouted``.

    Reads the reference artifact's numpy attributes only (it imports
    nothing of the JAX package), so planes packed by the reference drive
    the port's passes unchanged, hot planes included.
    """
    from cvr_tpu_torch.formats.hot import HotPlanes

    if getattr(sr, "seg_ring", None) is not None:
        raise NotImplementedError(
            "ring-scheduled artifacts (the distributed routed path) are "
            "not ported yet: ROADMAP queue 1"
        )
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


def pack_routed(sm: SellMatrix, max_T: int | None = None) -> SellRouted:
    """Compile a SellMatrix (C=1024) into the routed-SpMV artifact; raise
    ValueError when the stream needs more than ``max_T`` route tiles.

    Requires the native library: the stream build and the route compile
    are native passes (the reference's numpy fallback is not ported).
    """
    from cvr_tpu_torch import _native
    from cvr_tpu_torch.ops import route_planes as rp

    if sm.C != TILE:
        raise ValueError("routed path requires C == 1024")
    if not _native.available():
        raise RuntimeError("the routed pack requires the native library")
    CH, YB, TB = rp.CH, rp.YB, rp.TB
    pt = PhaseTimer()
    S = sm.n_slots
    nrows, ncols = sm.shape
    vals_prov = None
    with pt.phase("zone_plan"):
        zone = _zone_plan(sm, YB, CH)
    if zone is not None:
        nslices = zone["nslices"]
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
        offs = sm.slice_offsets.astype(np.int64)
        rmap, ycall_rows, regions, S_padded = _plan_layout(
            offs, nslices, S, YB, CH
        )
        cols_used = sm.cols_plane
        rmap_used = rmap
    nwin_total = -(-max(ncols, 1) // 1024)
    segw = min(rp.SEGW, _round_up(nwin_total, 8))
    n_segs = -(-nwin_total // segw)
    with pt.phase("stream"):
        perm, li_flat, w8_arr, cand, seg_blk, T, T_src_p = (
            _native.stream_build2_native(
                rmap_used, cols_used, S_padded, segw * 8 * n_segs, segw, TB
            )
        )
        cls_tile = np.where(
            cand <= 1, 1, np.where(cand <= 2, 2, np.where(cand <= 4, 4, 8))
        ).astype(np.int32)
        gcls = np.ascontiguousarray(
            cls_tile.reshape(-1, 8).max(axis=1).astype(np.int32)
        )
        # tiles past the real stream are pure filler: pin their window
        # metadata to deterministic values
        if T_src_p < T:
            w8_arr[T_src_p:] = 0
            seg_blk[T_src_p // TB :] = 0
    if max_T is not None and T > max_T:
        raise ValueError(f"the routed stream needs T={T} route tiles, "
                         f"above the cap of {max_T}")
    with pt.phase("route_plan"):
        if zone is not None:
            li_ss, mid_arr, p3_ss, r2 = _native.route_compile_zone_native(
                perm, T, T, S_padded, li_flat, zone["nslA"], zone["zr0"],
                zone["zw"], zone["zrows"], zone["row_slice"],
            )
        else:
            li_ss, mid_arr, p3_ss = _native.route_compile_native(
                perm, T, T, S_padded, li_flat
            )
            r2 = None
    with pt.phase("fuse_planes"):
        mid = rp.middle_planes_from(mid_arr, T)
    return _pack_routed_tail(
        sm, pt, offs, rmap, nslices, S_padded, ycall_rows, regions, w8_arr,
        li_ss, seg_blk, mid, p3_ss, T, n_segs, segw,
        T * TILE - S_padded * TILE, gcls, zone, vals_prov, r2,
    )


def group_padded_rmap(offs, nslices: int, S: int, group_slices: int,
                      row_mult: int):
    """Row map for group-tail padding: slices group ``group_slices`` per
    reduce group, each group's rows padded to a ``row_mult`` multiple.

    Returns (rmap [S] old->padded row, gstart, rc natural rows, rcp
    padded rows, gshift).
    """
    n_g = max(1, -(-nslices // group_slices))
    gstart = offs[np.minimum(np.arange(n_g) * group_slices, nslices)]
    gend = offs[np.minimum((np.arange(n_g) + 1) * group_slices, nslices)]
    rc = gend - gstart
    rcp = -(-rc // row_mult) * row_mult
    gshift = np.zeros(n_g, dtype=np.int64)
    np.cumsum((rcp - rc)[:-1], out=gshift[1:])
    grp_of_row = np.searchsorted(gend, np.arange(S), side="right")
    rmap = np.arange(S, dtype=np.int64) + gshift[
        np.minimum(grp_of_row, n_g - 1)
    ]
    return rmap, gstart, rc, rcp, gshift


def _plan_layout(offs, nslices, S, YB, CH, region_widths=(1, 2, 4, 8, 16)):
    """Padded plane layout: row map, reduce-group ranges and regular-width
    regions.

    Slices are length-sorted, so equal widths form contiguous runs; a run
    of >= CH/w slices of width w in ``region_widths`` becomes a REGION:
    up to w-1 zero rows are inserted first so its slice boundaries land
    on the CH grid, and the region's CH-aligned interior sums without the
    emission sweep.

    Returns (rmap [S] old->padded plane row, ycall_rows (n,2) int64,
    regions (m,5) int64 rows (grp, row0, n_rows, w, slice_rel), S_padded).
    """
    n_groups = max(1, -(-nslices // YB))
    if S == 0:
        rmap, gstart, _rc, rcp, gshift = group_padded_rmap(
            offs, nslices, S, YB, CH
        )
        ycall_rows = np.stack([gstart + gshift, rcp], axis=1).astype(
            np.int64
        )
        return rmap, ycall_rows, np.zeros((0, 5), dtype=np.int64), 0

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


def _pack_routed_tail(
    sm, pt, offs, rmap, nslices, S_pad, ycall_rows, regions, w8_arr, li_ss,
    seg_blk, mid, p3_ss, T, n_segs, segw, n_fillers, gcls, zone, vals_prov,
    r2,
) -> SellRouted:
    """Reduce-pass auxiliaries and the y-route."""
    from cvr_tpu_torch.ops import route_planes as rp

    nrows, ncols = sm.shape
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
        Ty = _round_up(max(-(-nrows // TILE), y_tiles), 128)
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
        ypern[nrows:] = free[
            dropped.shape[0] : dropped.shape[0] + Ty * TILE - nrows
        ]
        if dropped.shape[0]:
            ymask = np.ones(nrows, dtype=np.float32)
            ymask[dropped] = 0.0
        else:
            ymask = np.zeros(0, dtype=np.float32)
        y_ra = rp.route_arrays_from_perm(ypern, n=nrows)
        extra = (~is_first) & (seg_row < nrows)
        extra_pos = np.flatnonzero(extra).astype(np.int64)  # y_sorted flat
        # remap to the padded stream layout (8, Tp, 128): position
        # sigma*1024 + i*128 + l  ->  i*(Tp*128) + sigma*128 + l
        yTp = y_ra["Tp"]
        sig, rem = extra_pos // 1024, extra_pos % 1024
        i_, l_ = rem // 128, rem % 128
        extra_src = i_ * (yTp * 128) + sig * 128 + l_
        extra_row = seg_row[extra]

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
