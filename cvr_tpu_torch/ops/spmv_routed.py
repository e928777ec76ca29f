"""y = A @ x on the SELL-R artifact: the routed-gather SpMV on the card,
and the route library's device API.

Pipeline (cvr_tpu_torch/formats/sell_routed.py packs the planes):

    ys  = reduce_slices(x, vals, plan)    K3  window gather + route stage 1
                                              + route middle + M3 + stage 3
                                              + x vals + slice sums
    ysp = zone-A fold, pad to the y-route's tiles
    ysp += reduce_hot(x[hot_ids], ...)    K7  hub-column hybrid (hot planes)
    y   = route_small(ysp, src)           K4  the whole y-route, any Tp
    y   = y * ymask ; y[extra_row] += ysp[extra_src]

The SpMM (spmm_routed) runs the same chain on a tile of up to 8 columns
of X at once, a lane's columns side by side: K3w (reduce_slices_cols)
over the same plan, the fold and pad, K7 a column, K4w
(route_small_cols) into the tile's columns of Y, the mask and the extras.

The TPU stages the route because it gathers only inside VMEM windows: the
x side's middle (M1 + chunk select, then M3 inside the reduce) and the
y-route's stage 1, middle and stage 3 are passes of their own there.
Every stage is a static map that the pack fixes, and the card gathers
from anywhere through its L2, so the upload composes them: K3 reads x by
one int32 index per plane element composed through K1's window gather
(expand's map, rk.expand_source), the route middle (route_middle's map,
or the flat kind's relayout), M3 and stage 3 (reduce_plan, then
rk.reduce_plan_x), and K4 reads ysp by one int32 index per output
composed through the y-route's stages (compose_route).  The row-sharded
ring (parallel/dist_routed.py), whose x arrives in pieces while K15
expands them, keeps g1: its shards also carry the plan into g1, composed
without K1's map (g1_plan).  ``middle`` and ``staged_route`` keep the
staged passes, and K1 (rk.expand) the expanded stream: the chains the
composed indices are held against.

The unfused reduce the JAX package's routed SpMV specifies runs the whole
middle first and reduces from the stream (reduce_unfused):

    gx  = middle_pass(g1)                 K2 + K6 (rec) | K16 (flat)
    ys  = reduce_stream(emit, gemit, vals, gx, p3, plan)
                                          K18, per reduce group, by its
                                          plan made at upload

The route library: ``apply_route(ra, v)`` computes v[perm] for any
compiled permutation (route_planes.route_arrays_from_perm or
route_arrays(plan_route(perm))): K5, ``middle_pass``, K5, where the
middle is K2 + K6 (kind "rec", T a multiple of 1024 tiles above 1024),
K16 (kind "flat", T == 1024; apply_route takes K4 there instead) or
stream_to_middle, K17, middle_to_stream (kind "brute", any other T).

The kernels are in cvr_tpu_torch/ops/route_kernels.py; everything else
here is plain torch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from cvr_tpu_torch.formats.sell_routed import SellRouted
from cvr_tpu_torch.ops import route_kernels as rk
from cvr_tpu_torch.ops import route_planes as rp
from cvr_tpu_torch.utils.profiling import span, spanned


@dataclass(frozen=True)
class RouteMidDevice:
    """Middle-stage planes: ``mid`` for kind "flat" (Tk == 1, a stream
    plane) and kind "brute" (Tk == K, a (K, 1024, 128) middle-layout
    plane), m1/csel/m3 for kind "rec" (Tk >= 2)."""

    kind: str
    Tk: int
    mid: torch.Tensor | None = None
    m1: torch.Tensor | None = None
    csel: torch.Tensor | None = None
    m3: torch.Tensor | None = None


@dataclass(frozen=True)
class RouteDevice:
    """A route's stage planes: stages 1/3 and the middle; where the
    upload composed them (route_to_device), also ``src``, the stages as
    one (n,) int32 gather index (compose_route), which K4 reads in their
    place."""

    s1: torch.Tensor
    mid: RouteMidDevice
    s3: torch.Tensor
    T: int
    Tp: int
    n: int
    src: torch.Tensor | None = None


@dataclass(frozen=True)
class SellRoutedDevice:
    w8: torch.Tensor  # (T,) int32
    gcls: torch.Tensor  # (T // 8,) int32
    li: torch.Tensor  # (8, T, 128) int16
    seg_blk: torch.Tensor  # (T // TB,) int32
    mid: RouteMidDevice
    vals_ss: torch.Tensor  # (8, S_pad, 128) f32
    p3: torch.Tensor  # (8, S_pad, 128) int16
    # the reduce's slice table: slice k sums plane rows [row0, row1) into
    # y-stream slice out; fast marks zone-A slices (aligned stage 3)
    red_row0: torch.Tensor  # (n_items,) int32
    red_row1: torch.Tensor
    red_out: torch.Tensor
    red_fast: torch.Tensor
    # what K3 reads in place of K1, the route middle, p3, the M3 plane and
    # the table: the index into x composed through them, the slices cut
    # into pieces (reduce_plan, rk.reduce_plan_x)
    red_plan: rk.ReducePlan
    yroute: RouteDevice
    extra_src: torch.Tensor  # (n_extra,) int64 padded y-stream positions
    extra_row: torch.Tensor  # (n_extra,) int64 rows to add into
    ymask: torch.Tensor  # (nrows_out,) f32 row mask, (0,) when unneeded
    shape: tuple[int, int]
    T: int
    nslices: int
    segw: int
    n_segs: int
    nslA: int  # leading zone-A slices (folded before the y-route)
    yslices: int  # y-stream tiles after the zone-A fold
    # hub-column hybrid (cvr_tpu_torch/formats/hot.py); hot_nslices == 0
    # means no hot planes and the fields below are None
    hidx: torch.Tensor | None = None  # (8, S_hp, 128) int16 hot ranks
    hvals: torch.Tensor | None = None  # (8, S_hp, 128) f32
    hot_ids: torch.Tensor | None = None  # (NH,) int64 hot column ids
    # the hot reduce's slice table, as red_row0/red_row1/red_out
    hot_row0: torch.Tensor | None = None
    hot_row1: torch.Tensor | None = None
    hot_out: torch.Tensor | None = None
    hot_nslices: int = 0
    # the unfused reduce's plans (rk.reduce_stream_plan), one per reduce
    # group, made from the pack's emissions at upload
    stream_plans: tuple[rk.StreamPlan, ...] = ()
    # K3's plan into g1 (the same pieces), on a ring-scheduled artifact
    # only: the row-sharded ring's K15 writes g1 (g1_plan)
    red_plan_g1: rk.ReducePlan | None = None


def reduce_table(emit, ycall_rows, regions, nslices: int,
                 zone_rows: int = 0) -> tuple[np.ndarray, ...]:
    """A reduce pass's per-slice row ranges, derived once on the host,
    for the main planes (emit, ycall_rows, regions, nslices, zone_rows of
    the pack) or the hot planes (hemit and the hot ycall_rows, regions and
    slice count; no zone A).

    Reproduces the TPU reduce exactly: one reduce group of YB slices per
    ``ycall_rows`` range; inside a group, the regular regions sum fixed
    width-w row runs, and the rest is walked in irregular pieces where
    each emission row ``e`` (emit[e] = group-local slice id) closes the
    slice begun after the previous emission (or at the piece start); rows
    after a piece's last emission are dropped.  A piece's stage 3 is
    aligned (``fast``) when it ends inside zone A.

    Returns int32 arrays (row0, row1, out, fast): slice k sums plane rows
    [row0[k], row1[k]) into y-stream slice out[k].
    """
    YB, CH = rp.YB, rp.CH
    regions = [tuple(int(v) for v in r) for r in np.asarray(regions)]
    emit = np.asarray(emit)
    parts = []
    for j, (r0g, nrg) in enumerate(np.asarray(ycall_rows).tolist()):
        nsl = min(YB, nslices - j * YB)
        regs = sorted(r for r in regions if r[0] == j)
        pieces, cur = [], r0g
        for _, rr0, rnr, _w, _s in regs:
            if rr0 > cur:
                pieces.append((cur, rr0 - cur))
            cur = rr0 + rnr
        if cur < r0g + nrg:
            pieces.append((cur, r0g + nrg - cur))
        for r0, nr in pieces:
            if r0 % CH or nr % CH:
                raise ValueError("reduce pieces must be CH-aligned")
            e = np.flatnonzero(emit[r0 : r0 + nr] >= 0) + r0
            starts = np.concatenate([[r0], e[:-1] + 1])
            # an emission past the group's slices resets the sum but is
            # cut from the TPU's output block
            live = emit[e] < nsl
            e, starts = e[live], starts[live]
            parts.append((starts, e + 1, j * YB + emit[e],
                          np.full(e.shape, r0 + nr <= zone_rows)))
        for _, r0, nr, w, srel in regs:
            k = np.arange(nr // w)
            if srel + k.shape[0] > nsl:
                raise ValueError("regular region runs past its group")
            parts.append((r0 + k * w, r0 + (k + 1) * w, j * YB + srel + k,
                          np.full(k.shape, r0 + nr <= zone_rows)))
    cols = [np.concatenate([p[i] for p in parts]) if parts else np.zeros(0)
            for i in range(4)]
    out = cols[2]
    if np.unique(out).shape[0] != out.shape[0]:
        raise ValueError("a slice is emitted twice")
    return tuple(c.astype(np.int32) for c in cols)


def _put(device):
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return put


def mid_to_device(mp: dict, device) -> RouteMidDevice:
    """Upload a route's middle planes (route_planes.middle_planes_from) to
    ``device``."""
    put = _put(device)
    return RouteMidDevice(
        kind=mp["kind"], Tk=mp["Tk"],
        **{k: put(mp[k]) for k in ("mid", "m1", "csel", "m3") if k in mp},
    )


def middle_pass_plain(g, planes: RouteMidDevice) -> torch.Tensor:
    """middle_pass's function in plain torch, on a stream g of any
    dtype."""
    if planes.kind == "flat":
        return rk.route_flat_plain(g, planes.mid)
    if planes.kind == "rec":
        return rk.route_m3_plain(
            rk.route_middle_plain(g, planes.m1, planes.csel), planes.m3)
    mid = rk.groupperm_plain(rk.stream_to_middle(g), planes.mid)
    return rk.middle_to_stream(mid)


def compose_route(s1, mid: RouteMidDevice, s3, Tp: int, n: int):
    """A route's stages as one gather index: (n,) int32 on the planes'
    device, for each output y[e] (natural order) the flat position in the
    stream ysp (8, Tp, 128) of the value that stage 1 (s1), the middle
    and stage 3 (s3) move there, or -1 where they give 0; the staged
    route's plain versions run once on ysp's own flat positions
    (rk.source_index), so each stage's zero case becomes that -1."""
    rk.route_small_geometry(Tp, n)

    def staged(g):
        g = rk.tileperm_plain(middle_pass_plain(rk.tileperm_plain(g, s1),
                                                mid), s3)
        return rk.stream_to_flat(g)[:n]

    return rk.source_index(staged, (8, Tp, 128), s1.device).int()


def route_to_device(ra: dict, device, compose: bool = False) -> RouteDevice:
    """Upload a route's arrays (route_planes.route_arrays_from_perm) to
    ``device``, with the stages composed into K4's index (compose_route,
    made here once) for a flat route, and for any route when
    ``compose``; a route without it runs its stages (staged_route)."""
    put = _put(device)
    mid = mid_to_device(ra["mid_planes"], device)
    s1, s3 = put(ra["s1"]), put(ra["s3"])
    src = None
    if compose or mid.kind == "flat":
        src = compose_route(s1, mid, s3, ra["Tp"], ra["n"])
    return RouteDevice(s1=s1, mid=mid, s3=s3, T=ra["T"], Tp=ra["Tp"],
                       n=ra["n"], src=src)


def mstream_source(mid: RouteMidDevice) -> torch.Tensor:
    """(8, T, 128) int64 on the planes' device: for each element of the
    mstream that the staged route middle gives the reduce (``middle``),
    the flat position in the stream g1 (8, T, 128) of the value it holds,
    or -1 where it holds 0 (a chunk select outside [0, Tk)): K2's map
    (kind "rec") or the flat kind's relayout, by rk.source_index."""
    if mid.kind == "rec":
        return rk.source_index(
            lambda g: rk.route_middle_plain(g, mid.m1, mid.csel),
            mid.m1.shape, mid.m1.device)
    return rk.source_index(lambda g: rk.stream_to_mstream(g, mid.Tk),
                           mid.mid.shape, mid.mid.device)


def reduce_plan(mid: RouteMidDevice, p3, row0, row1, out,
                fast) -> rk.ReducePlan:
    """K3's plan (rk.reduce_plan) for the slice table (row0, row1, out,
    fast) over p3 and the route middle ``mid``, composed through the
    middle into g1 (mstream_source)."""
    m3 = mid.m3 if mid.kind == "rec" else mid.mid
    return rk.reduce_plan(mstream_source(mid), m3, p3, row0, row1, out,
                          fast)


def stream_plans(sr: SellRouted, device) -> tuple[rk.StreamPlan, ...]:
    """K18's plan of each reduce group of the pack (reduce_unfused's
    launches), on ``device``."""
    return tuple(
        rk.reduce_stream_plan(sr.emit[r0 : r0 + nr],
                              min(rp.YB, sr.nslices - j * rp.YB), device)
        for j, (r0, nr) in enumerate(np.asarray(sr.ycall_rows).tolist()))


def to_device_routed(sr: SellRouted, device="cuda") -> SellRoutedDevice:
    """Upload the routed artifact's planes to ``device`` (the card unless
    the caller asks for another), with K3's plan (reduce_plan, then
    rk.reduce_plan_x: the index into x composed through K1's window map,
    the route middle, M3 and stage 3, and the slices cut into pieces), K4's
    index (the y-route's stages composed) and K18's plans (stream_plans),
    made here once.  A ring-scheduled artifact (``ring_cnt``: a shard of
    dist_routed_pack(..., overlap=True)) keeps the plan into g1 as well,
    for the ring, which expands x piece by piece."""
    put = _put(device)
    mid = mid_to_device(sr.mid, device)
    nrows_out = sr.y_ra["n"]
    # geometry-padding extras (forced dist shards) add into row nrows_out,
    # out of range: the reference drops them, the port filters them here
    keep = np.asarray(sr.extra_row) < nrows_out
    red = [put(a) for a in spanned("upload.plan", reduce_table, sr.emit,
                                   sr.ycall_rows, sr.regions, sr.nslices,
                                   sr.zone_rows)]
    p3 = put(sr.p3)
    hot = {}
    hp = sr.hot
    if hp is not None:
        h0, h1, hout, _ = spanned("upload.plan", reduce_table, hp.hemit,
                                  hp.ycall_rows, hp.regions, hp.nslices)
        hot = dict(
            hidx=put(hp.hidx), hvals=put(hp.hvals),
            hot_ids=put(np.asarray(hp.hot_ids, dtype=np.int64)),
            hot_row0=put(h0), hot_row1=put(h1), hot_out=put(hout),
            hot_nslices=hp.nslices,
        )
    w8, gcls, li, seg_blk = (put(a) for a in (sr.w8, sr.gcls, sr.li,
                                              sr.seg_blk))
    vals_ss = put(sr.vals_ss)
    g1_plan = spanned("upload.plan", reduce_plan, mid, p3, *red)
    red_plan = spanned("upload.plan", lambda: rk.reduce_plan_x(
        g1_plan, rk.expand_source(w8, gcls, seg_blk, li, sr.segw)),
        sync=device)
    return SellRoutedDevice(
        w8=w8,
        gcls=gcls,
        li=li,
        seg_blk=seg_blk,
        mid=mid,
        vals_ss=vals_ss,
        p3=p3,
        red_row0=red[0],
        red_row1=red[1],
        red_out=red[2],
        red_fast=red[3],
        red_plan=red_plan,
        yroute=spanned("upload.plan", route_to_device, sr.y_ra, device,
                       compose=True, sync=device),
        extra_src=put(np.asarray(sr.extra_src, dtype=np.int64)[keep]),
        extra_row=put(np.asarray(sr.extra_row, dtype=np.int64)[keep]),
        ymask=put(sr.ymask),
        shape=tuple(sr.shape),
        T=sr.T,
        nslices=sr.nslices,
        segw=sr.segw,
        n_segs=sr.n_segs,
        nslA=sr.nslA,
        yslices=sr.yslices or sr.nslices,
        stream_plans=spanned("upload.plan", stream_plans, sr, device,
                             sync=device),
        red_plan_g1=g1_plan if sr.ring_cnt is not None else None,
        **hot,
    )


def spmv_routed(sd: SellRoutedDevice, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x via the compiled route; x (ncols,) on sd's device: K3
    gathers x by the plan composed at upload, then y_from_slices."""
    x = x.to(torch.float32).contiguous()
    return reduce_and_route(sd, x, x)


def spmm_routed(sd: SellRoutedDevice, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for dense X (ncols, K) on sd's device, column k equal to
    spmv_routed(sd, X[:, k]) bit for bit (the JAX package vmaps the SpMV
    over the K columns).  K 1 is the SpMV; a wider X runs in tiles of up
    to rk.COLS_TILE columns, each one K3w pass over the planes that
    gathers the tile's rows of X in place, then y_from_slices_cols into
    the tile's columns of one (nrows, K) Y."""
    if X.shape[1] == 1:
        return spmv_routed(sd, X[:, 0])[:, None]
    X = X.to(torch.float32)
    if X.stride(1) != 1:
        X = X.contiguous()
    K = X.shape[1]
    Y = torch.empty((sd.yroute.n, K), dtype=torch.float32, device=X.device)
    # past the kernels' 32-bit indices, a tile's columns are copied out
    big = max(X.shape[0] * X.stride(0), Y.numel()) > rk.INT32_MAX
    for c0 in range(0, K, rk.COLS_TILE):
        c1 = min(K, c0 + rk.COLS_TILE)
        Xt, Yt = X[:, c0:c1], Y[:, c0:c1]
        if big:
            Xt, Yt = Xt.contiguous(), torch.empty_like(Yt)
        with span("routed.reduce", f"X{c1 - c0}"):
            ys = rk.reduce_slices_cols(Xt, sd.vals_ss, sd.red_plan,
                                       sd.nslices)
        with span("routed.y"):
            y_from_slices_cols(sd, ys, Xt, Yt)
        if big:
            Y[:, c0:c1] = Yt
    return Y


def middle(sd: SellRoutedDevice, g1: torch.Tensor):
    """The route middle as the TPU stages it, up to the mstream, and the
    M3 plane its reduce applies: (m, m3).  No SpMV runs it: K3 gathers x
    (the ring's K3, g1) by an index composed through it (mstream_source);
    the tests and chip_smoke.py hold that index against it."""
    if sd.mid.kind == "rec":
        return rk.route_middle(g1, sd.mid.m1, sd.mid.csel), sd.mid.m3
    # flat: the relayout alone; the within-slab perm IS the flat mid plane
    return rk.stream_to_mstream(g1, sd.mid.Tk).contiguous(), sd.mid.mid


def g1_plan(sd: SellRoutedDevice) -> rk.ReducePlan:
    """K3's plan into the expanded stream g1: the one the upload kept (a
    ring-scheduled artifact), else composed now from the slice table and
    the route middle (reduce_plan), as the tools and tests that run the
    K1 + K3 chain on purpose need it."""
    if sd.red_plan_g1 is not None:
        return sd.red_plan_g1
    return reduce_plan(sd.mid, sd.p3, sd.red_row0, sd.red_row1, sd.red_out,
                       sd.red_fast)


def reduce(sd: SellRoutedDevice, src: torch.Tensor,
           plan: rk.ReducePlan | None = None):
    """Per-slice lane sums ys (8, nslices, 128) by K3: from x (ncols,) by
    the plan composed at upload, or from the expanded stream g1
    (8, T, 128) by g1_plan; ``plan`` gives the plan instead."""
    if plan is None:
        plan = sd.red_plan if src.dim() == 1 else g1_plan(sd)
    return rk.reduce_slices(src, sd.vals_ss, plan, sd.nslices)


def y_stream(sd: SellRoutedDevice, ys: torch.Tensor) -> torch.Tensor:
    """The y-route's input stream ysp (8, Tp, 128).  Zone-A slices
    (128 lambda-segments each) fold their 8 sublane partials and compact
    8 slices per stream tile, so the y flat position of segment g is g in
    both layouts; zone-B slices are stream tiles directly."""
    if sd.nslA:
        nA = sd.nslA
        sA = ys[:, :nA, :].sum(dim=0).reshape(nA // 8, 8, 128).permute(1, 0, 2)
        ys = torch.cat([sA, ys[:, nA:, :]], dim=1)
    return F.pad(ys, (0, 0, 0, sd.yroute.Tp - sd.yslices)).contiguous()


def hot_stream(sd: SellRoutedDevice, x: torch.Tensor) -> torch.Tensor:
    """Per-slice sums (8, hot_nslices, 128) of the captured hot-column
    elements, in the y-stream layout (flat position of segment g is g):
    one add into the routed y stream integrates the hybrid."""
    xh = x[sd.hot_ids]
    return rk.reduce_hot(xh, sd.hidx, sd.hvals, sd.hot_row0, sd.hot_row1,
                         sd.hot_out, sd.hot_nslices)


def reduce_unfused(sd: SellRoutedDevice, gx: torch.Tensor, emit, gemit,
                   ycall_rows) -> torch.Tensor:
    """Per-slice lane sums ys (8, nslices, 128) by the unfused reduce: one
    reduce_stream (K18) per reduce group over the group's plane rows of
    the stream-layout middle output gx (8, >= S_pad, 128).  emit (S_pad,)
    and gemit (S_pad // 8,) int32 on sd's device are the pack's emissions
    and their group codes (route_planes.group_emit_encode), ycall_rows
    its reduce groups' (first row, rows); K18 reads each group's rows of
    the planes in place, by the group's plan made at upload from the same
    emissions (sd.stream_plans)."""
    parts = []
    for j, (r0, nr) in enumerate(np.asarray(ycall_rows).tolist()):
        rows = slice(r0, r0 + nr)
        parts.append(rk.reduce_stream(
            emit[rows], gemit[r0 // 8 : (r0 + nr) // 8], sd.vals_ss[:, rows],
            gx[:, rows], sd.p3[:, rows], min(rp.YB, sd.nslices - j * rp.YB),
            sd.stream_plans[j] if sd.stream_plans else None,
        ))
    return torch.cat(parts, 1)


def middle_pass(g1: torch.Tensor, planes: RouteMidDevice) -> torch.Tensor:
    """The route middle on the stream g1 (8, T, 128), returning a stream:
    kind "flat" (T == 1024) K16; kind "rec" (T == Tk*1024) K2 then K6;
    kind "brute" (T == K*128) K17 between the stream<->middle relayouts.
    See middle_pass_plain."""
    if planes.kind == "flat":
        return rk.route_flat(g1, planes.mid)
    if planes.kind == "rec":
        return rk.route_m3(rk.route_middle(g1, planes.m1, planes.csel),
                           planes.m3)
    mid = rk.groupperm(rk.stream_to_middle(g1).contiguous(), planes.mid)
    return rk.middle_to_stream(mid).contiguous()


def staged_route(ra: RouteDevice, g: torch.Tensor) -> torch.Tensor:
    """Route the stream g (8, Tp, 128) to y (n,) in natural order by its
    stages, as the TPU runs them: stage 1 (K5), middle_pass and stage 3
    (K5)."""
    g2 = middle_pass(rk.tileperm(g, ra.s1), ra.mid)
    return rk.stream_to_flat(rk.tileperm(g2, ra.s3))[: ra.n]


def apply_route_stream(ra: RouteDevice, g: torch.Tensor) -> torch.Tensor:
    """Route the stream g (8, Tp, 128) to y (n,) in natural order: one
    K4 gather by the composed index where the route carries it, else
    staged_route."""
    if ra.src is not None:
        return rk.route_small(g, ra.src, ra.n)
    return staged_route(ra, g)


def route_stream(ra: RouteDevice, v: torch.Tensor) -> torch.Tensor:
    """v (at most Tp*1024 elements) as float32, padded to the route's
    Tp*1024 and laid out as its input stream (8, Tp, 128)."""
    n_pad = ra.Tp * 1024 - v.shape[0]
    if n_pad < 0:
        raise ValueError(f"apply_route: v has {v.shape[0]} elements, the "
                         f"route {ra.Tp * 1024}")
    g = rk.flat_to_stream(F.pad(v.to(torch.float32), (0, n_pad)), ra.Tp)
    return g.contiguous()


def apply_route(ra, v: torch.Tensor) -> torch.Tensor:
    """out = v[perm] (float32) for the compiled permutation ``ra``: a
    host route_arrays dict (uploaded to v's device) or a RouteDevice; v
    holds at most Tp*1024 elements and is padded to them."""
    if isinstance(ra, dict):
        ra = route_to_device(ra, v.device)
    return apply_route_stream(ra, route_stream(ra, v))


def y_from_slices(sd: SellRoutedDevice, ys: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """y from the per-slice sums ys: the y stream, the hot planes' sums
    (the only part that reads x), y-route, row mask and split-row
    extras."""
    ysp = y_stream(sd, ys)
    if sd.hot_nslices:
        ysp[:, : sd.hot_nslices] += hot_stream(sd, x)
    y = apply_route_stream(sd.yroute, ysp)
    if sd.ymask.shape[0]:
        # empty rows whose segments sorted beyond the effective slices
        # route from arbitrary positions; zero them
        y = y * sd.ymask
    if sd.extra_src.shape[0]:
        y.index_add_(0, sd.extra_row, ysp.reshape(-1)[sd.extra_src])
    return y


def y_stream_cols(sd: SellRoutedDevice, ys: torch.Tensor) -> torch.Tensor:
    """y_stream of each column of a tile's sums ys (8, nslices, 128, KT):
    ysp (8, Tp, 128, KT), the zone-A fold and the zone-B slices written
    into it in place of the SpMV's cat and pad."""
    nA, a = sd.nslA, sd.nslA // 8
    ysp = ys.new_empty((8, sd.yroute.Tp, *ys.shape[2:]))
    if nA:
        ysp[:, :a] = ys[:, :nA].sum(dim=0).reshape(
            a, 8, *ys.shape[2:]).permute(1, 0, 2, 3)
    ysp[:, a : sd.yslices] = ys[:, nA:]
    ysp[:, sd.yslices :] = 0
    return ysp


def y_from_slices_cols(sd: SellRoutedDevice, ys: torch.Tensor,
                       X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """y_from_slices of each column of a tile, into Y (nrows, KT), a tile
    of the SpMM's Y written in place: the y stream (y_stream_cols), the
    hot planes' sums a column (K7 reads the column of X), the y-route by
    K4w, the row mask and the split-row extras over the tile's columns."""
    ysp = y_stream_cols(sd, ys)
    if sd.hot_nslices:
        for c in range(X.shape[1]):
            ysp[:, : sd.hot_nslices, :, c] += hot_stream(sd, X[:, c])
    rk.route_small_cols(ysp, sd.yroute.src, sd.yroute.n, out=Y)
    if sd.ymask.shape[0]:
        Y.mul_(sd.ymask[:, None])
    if sd.extra_src.shape[0]:
        # a column at a time, as the SpMV adds them: on the card the order
        # in which index_add_ sums a row's extras differs between a 1-D and
        # a 2-D tensor (deterministic algorithms' kernels; atomics else)
        add = ysp.reshape(-1, ysp.shape[-1])[sd.extra_src]
        for c in range(Y.shape[1]):
            Y[:, c].index_add_(0, sd.extra_row, add[:, c])
    return Y


def reduce_and_route(sd: SellRoutedDevice, src: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """K3 on its source src (x, or the ring's g1), then y_from_slices; the
    reduce's span names the source."""
    with span("routed.reduce", "x" if src.dim() == 1 else "g1"):
        ys = reduce(sd, src)
    with span("routed.y"):
        return y_from_slices(sd, ys, x)
