"""y = A @ x on the SELL-R artifact: the routed-gather SpMV on the card.

Pipeline (cvr_tpu_torch/formats/sell_routed.py packs the planes):

    g1  = expand(x)                       K1  window gather + route stage 1
    m   = route_middle(g1)                K2  M1 + chunk select (Tk >= 2)
        | stream_to_mstream(g1)               relayout only (Tk == 1)
    ys  = reduce_slices(m, m3, vals, p3)  K3  M3 + stage 3 + x vals + sums
    ysp = zone-A fold, pad to the y-route's tiles
    y   = route_small(ysp)                K4  the y-route to row order
    y   = y * ymask ; y[extra_row] += ysp[extra_src]

The kernels are in cvr_tpu_torch/ops/route_kernels.py; everything else
here is plain torch.  Routes the port has no kernel for yet (a y-route
above 1024 tiles, hot planes) raise NotImplementedError.
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
    """Middle-stage planes: ``mid`` for kind "flat" (Tk == 1), m1/csel/m3
    for kind "rec" (Tk >= 2)."""

    kind: str
    Tk: int
    mid: torch.Tensor | None = None
    m1: torch.Tensor | None = None
    csel: torch.Tensor | None = None
    m3: torch.Tensor | None = None


@dataclass(frozen=True)
class RouteDevice:
    """A flat 1024-tile route (stages 1/3 + middle) for route_small."""

    s1: torch.Tensor
    mid: torch.Tensor
    s3: torch.Tensor
    T: int
    Tp: int
    n: int


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


def reduce_table(sr: SellRouted) -> tuple[np.ndarray, ...]:
    """The reduce pass's per-slice row ranges, derived once on the host.

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
    regions = [tuple(int(v) for v in r) for r in np.asarray(sr.regions)]
    emit = np.asarray(sr.emit)
    parts = []
    for j, (r0g, nrg) in enumerate(np.asarray(sr.ycall_rows).tolist()):
        nsl = min(YB, sr.nslices - j * YB)
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
                          np.full(e.shape, r0 + nr <= sr.zone_rows)))
        for _, r0, nr, w, srel in regs:
            k = np.arange(nr // w)
            if srel + k.shape[0] > nsl:
                raise ValueError("regular region runs past its group")
            parts.append((r0 + k * w, r0 + (k + 1) * w, j * YB + srel + k,
                          np.full(k.shape, r0 + nr <= sr.zone_rows)))
    cols = [np.concatenate([p[i] for p in parts]) if parts else np.zeros(0)
            for i in range(4)]
    out = cols[2]
    if np.unique(out).shape[0] != out.shape[0]:
        raise ValueError("a slice is emitted twice")
    return tuple(c.astype(np.int32) for c in cols)


def to_device_routed(sr: SellRouted, device) -> SellRoutedDevice:
    """Upload the routed artifact's planes to ``device``."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    mp = sr.mid
    if mp["kind"] == "flat":
        mid = RouteMidDevice(kind="flat", Tk=mp["Tk"], mid=put(mp["mid"]))
    elif mp["kind"] == "rec":
        mid = RouteMidDevice(kind="rec", Tk=mp["Tk"], m1=put(mp["m1"]),
                             csel=put(mp["csel"]), m3=put(mp["m3"]))
    else:
        raise NotImplementedError(
            f"route middle kind {mp['kind']!r} is not ported yet: "
            "ROADMAP queue 2"
        )
    ya = sr.y_ra
    if ya["Tp"] != 1024 or ya["mid_planes"]["kind"] != "flat":
        raise NotImplementedError(
            f"a y-route over Tp={ya['Tp']} tiles (tileperm_ss + m3_fused) "
            "is not ported yet: ROADMAP queue 2"
        )
    nrows_out = ya["n"]
    # geometry-padding extras (forced dist shards) add into row nrows_out,
    # out of range: the reference drops them, the port filters them here
    keep = np.asarray(sr.extra_row) < nrows_out
    row0, row1, out, fast = reduce_table(sr)
    return SellRoutedDevice(
        w8=put(sr.w8),
        gcls=put(sr.gcls),
        li=put(sr.li),
        seg_blk=put(sr.seg_blk),
        mid=mid,
        vals_ss=put(sr.vals_ss),
        p3=put(sr.p3),
        red_row0=put(row0),
        red_row1=put(row1),
        red_out=put(out),
        red_fast=put(fast),
        yroute=RouteDevice(
            s1=put(ya["s1"]), mid=put(ya["mid_planes"]["mid"]),
            s3=put(ya["s3"]), T=ya["T"], Tp=ya["Tp"], n=nrows_out,
        ),
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
    )


def spmv_routed(sd: SellRoutedDevice, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x via the compiled route; x (ncols,) on sd's device."""
    g1 = rk.expand(sd.w8, sd.gcls, sd.seg_blk, sd.li,
                   x.to(torch.float32).contiguous(), sd.segw, sd.n_segs)
    return route_post_expand(sd, g1)


def middle(sd: SellRoutedDevice, g1: torch.Tensor):
    """The route middle up to the mstream, and the M3 plane the reduce
    applies: (m, m3)."""
    if sd.mid.kind == "rec":
        return rk.route_middle(g1, sd.mid.m1, sd.mid.csel), sd.mid.m3
    # flat: the relayout alone; the within-slab perm IS the flat mid plane
    return rk.stream_to_mstream(g1, sd.mid.Tk).contiguous(), sd.mid.mid


def reduce(sd: SellRoutedDevice, m: torch.Tensor, m3: torch.Tensor):
    """Per-slice lane sums ys (8, nslices, 128)."""
    return rk.reduce_slices(m, m3, sd.vals_ss, sd.p3, sd.red_row0,
                            sd.red_row1, sd.red_out, sd.red_fast,
                            sd.nslices)


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


def route_post_expand(sd: SellRoutedDevice, g1: torch.Tensor) -> torch.Tensor:
    """The x-independent tail of the pipeline: middle, reduce, y-route,
    row mask and split-row extras."""
    m, m3 = middle(sd, g1)
    ysp = y_stream(sd, reduce(sd, m, m3))
    ra = sd.yroute
    y = rk.route_small(ysp, ra.s1, ra.mid, ra.s3, ra.n)
    if sd.ymask.shape[0]:
        # empty rows whose segments sorted beyond the effective slices
        # route from arbitrary positions; zero them
        y = y * sd.ymask
    if sd.extra_src.shape[0]:
        y.index_add_(0, sd.extra_row, ysp.reshape(-1)[sd.extra_src])
    return y
