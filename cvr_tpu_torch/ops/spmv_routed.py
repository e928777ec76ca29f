"""y = A @ x on the SELL-R artifact: the routed-gather SpMV on the card,
and the route library's device API.

Pipeline (cvr_tpu_torch/formats/sell_routed.py packs the planes):

    g1  = expand(x)                       K1  window gather + route stage 1
    ys  = reduce_slices(g1, vals, plan)   K3  route middle + M3 + stage 3
                                              + x vals + slice sums
    ysp = zone-A fold, pad to the y-route's tiles
    ysp += reduce_hot(x[hot_ids], ...)    K7  hub-column hybrid (hot planes)
    y   = route_small(ysp, src)           K4  the whole y-route, any Tp
    y   = y * ymask ; y[extra_row] += ysp[extra_src]

The TPU stages the route because it gathers only inside VMEM windows: the
x side's middle (M1 + chunk select, then M3 inside the reduce) and the
y-route's stage 1, middle and stage 3 are passes of their own there.
Every stage is a static map that the pack fixes, and the card gathers
from anywhere through its L2, so the upload composes them: K3 reads g1
by one int32 index per plane element composed through the route middle
(route_middle's map, or the flat kind's relayout), M3 and stage 3
(reduce_plan), and K4 reads ysp by one int32 index per output composed
through the y-route's stages (compose_route).  ``middle`` and
``staged_route`` keep the staged passes: the chains the composed indices
are held against.

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
    # what K3 reads in place of the route middle, p3, the M3 plane and the
    # table: the index into g1 composed through them, the slices cut into
    # pieces (reduce_plan)
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
    the caller asks for another), with K3's plan (reduce_plan: the index
    into g1 composed through the route middle, M3 and stage 3, and the
    slices cut into pieces), K4's index (the y-route's stages composed)
    and K18's plans (stream_plans), made here once."""
    put = _put(device)
    mid = mid_to_device(sr.mid, device)
    nrows_out = sr.y_ra["n"]
    # geometry-padding extras (forced dist shards) add into row nrows_out,
    # out of range: the reference drops them, the port filters them here
    keep = np.asarray(sr.extra_row) < nrows_out
    red = [put(a) for a in reduce_table(sr.emit, sr.ycall_rows, sr.regions,
                                        sr.nslices, sr.zone_rows)]
    p3 = put(sr.p3)
    hot = {}
    hp = sr.hot
    if hp is not None:
        h0, h1, hout, _ = reduce_table(hp.hemit, hp.ycall_rows, hp.regions,
                                       hp.nslices)
        hot = dict(
            hidx=put(hp.hidx), hvals=put(hp.hvals),
            hot_ids=put(np.asarray(hp.hot_ids, dtype=np.int64)),
            hot_row0=put(h0), hot_row1=put(h1), hot_out=put(hout),
            hot_nslices=hp.nslices,
        )
    return SellRoutedDevice(
        w8=put(sr.w8),
        gcls=put(sr.gcls),
        li=put(sr.li),
        seg_blk=put(sr.seg_blk),
        mid=mid,
        vals_ss=put(sr.vals_ss),
        p3=p3,
        red_row0=red[0],
        red_row1=red[1],
        red_out=red[2],
        red_fast=red[3],
        red_plan=reduce_plan(mid, p3, *red),
        yroute=route_to_device(sr.y_ra, device, compose=True),
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
        stream_plans=stream_plans(sr, device),
        **hot,
    )


def spmv_routed(sd: SellRoutedDevice, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x via the compiled route; x (ncols,) on sd's device."""
    x = x.to(torch.float32).contiguous()
    g1 = rk.expand(sd.w8, sd.gcls, sd.seg_blk, sd.li, x, sd.segw, sd.n_segs)
    return route_post_expand(sd, g1, x)


def spmm_routed(sd: SellRoutedDevice, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for dense X (ncols, K): one SpMV per column (the JAX
    package vmaps the SpMV over the K columns)."""
    return torch.stack([spmv_routed(sd, X[:, k]) for k in range(X.shape[1])],
                       1)


def middle(sd: SellRoutedDevice, g1: torch.Tensor):
    """The route middle as the TPU stages it, up to the mstream, and the
    M3 plane its reduce applies: (m, m3).  No SpMV runs it: K3 gathers g1
    by an index composed through it (mstream_source); the tests and
    chip_smoke.py hold that index against it."""
    if sd.mid.kind == "rec":
        return rk.route_middle(g1, sd.mid.m1, sd.mid.csel), sd.mid.m3
    # flat: the relayout alone; the within-slab perm IS the flat mid plane
    return rk.stream_to_mstream(g1, sd.mid.Tk).contiguous(), sd.mid.mid


def reduce(sd: SellRoutedDevice, g1: torch.Tensor):
    """Per-slice lane sums ys (8, nslices, 128) from the expanded stream
    g1: K3 by the plan composed at upload."""
    return rk.reduce_slices(g1, sd.vals_ss, sd.red_plan, sd.nslices)


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


def route_post_expand(sd: SellRoutedDevice, g1: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """The tail of the pipeline after the expand: K3 on g1, then
    y_from_slices."""
    return y_from_slices(sd, reduce(sd, g1), x)
