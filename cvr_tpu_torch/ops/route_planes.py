"""Host half of the routed pipeline: geometry constants and route planes.

Every stream on the device uses the sublane-split layout

    stream  (8, T, 128):  logical element (tile a, pos p) at [p>>7, a, p&127]

and index planes are int16 in that layout.  The route middle stage runs
on the mstream layout (8, Tk*1024, 128), element (tile a = ca*1024 + p,
color q) at [p>>7, ca*1024 + q, p&127]; the brute middle (T not a
multiple of 1024) on the middle layout (K, 1024, 128), T = K*128,
element (tile a = k*128 + l, color q) at [k, q, l].

The constants are module attributes that the pack and the op read at
call time (tests shrink YB to reach the multi-group paths at small
sizes).  They are the reference geometry, kept until the main path holds
on the card: retuning them for Hopper is later work.
"""

from __future__ import annotations

import numpy as np

# Plane rows per reduce block: the fused M3 stage reads one 128-row
# f-row of a mstream chunk per block, so this must stay 128.
CH = 128
# Slices per reduce group: emission ids in the pack are group-local.
YB = 512
# Tiles per expand block: blocks of TB tiles share one x segment.
TB = 128
# 1024-column windows per x segment.
SEGW = 1024

# Flag bit marking a two-emission group code (see group_emit_encode).
_EMIT2_BIT = 1 << 29


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def group_emit_encode(emit) -> np.ndarray:
    """Per-8-row-group emission code of the emission sweep: -2 none,
    -1 three-or-more (row walk), ``j << 16 | dest`` for one emission at
    group row j, or ``(1 << 29) | (j1 << 26) | (j2 << 23) | d`` for exactly
    two emissions at rows j1 < j2 with consecutive dests d, d+1."""
    e = np.asarray(emit).reshape(-1, 8)
    has = e >= 0
    cnt = has.sum(axis=1)
    j = np.argmax(has, axis=1)
    dest = e[np.arange(e.shape[0]), j]
    enc = np.where(cnt == 0, -2, np.where(cnt > 1, -1, (j << 16) | dest))
    j2 = 7 - np.argmax(has[:, ::-1], axis=1)
    dest2 = e[np.arange(e.shape[0]), j2]
    two = (cnt == 2) & (dest2 == dest + 1)
    enc = np.where(two, _EMIT2_BIT | (j << 26) | (j2 << 23) | dest, enc)
    return enc.astype(np.int32)


def _to_ss16(a: np.ndarray) -> np.ndarray:
    """Logical [Ntiles, 1024] int plane -> stream layout (8, Ntiles, 128)."""
    n = a.shape[0]
    return np.ascontiguousarray(
        a.astype(np.int16).reshape(n, 8, 128).transpose(1, 0, 2)
    )


def middle_planes(plan) -> dict:
    """Device-ready middle-stage planes for a RoutePlan (host NumPy)."""
    return middle_planes_from(plan.mid, plan.n_tiles)


def middle_planes_from(mid_arr: np.ndarray, T: int) -> dict:
    """Middle-stage planes straight from the (1024, T) mid array.

    T == 1024: kind "flat", the within-slab permutation itself.
    T == Tk*1024, Tk >= 2: kind "rec", the recursive middle (M1 within
    chunks, chunk select, M3 within chunks): the native capacitated
    per-row colorings with the planes emitted in the stream layout, or
    without the library ops/route.py's mid_recursive_planes, relaid.
    Any other T <= 32767: kind "brute", one (K, 1024, 128) int16 plane of
    tile ids over the middle layout (T padded to Tp = K*128 tiles by
    identity columns); ``Tk`` is K there.
    """
    from cvr_tpu_torch import _native
    from cvr_tpu_torch.ops.route import mid_recursive_planes

    if T % 1024 == 0:
        Tk = T // 1024
        if Tk == 1:
            return {"kind": "flat", "mid": _to_ss16(mid_arr), "Tk": 1}
        if _native.available():
            mid_c = np.ascontiguousarray(mid_arr, dtype=np.int32)
            colors = _native.color_rows_cap_native(mid_c, T, Tk)
            m1, csel, m3 = _native.mid_planes_ss_native(mid_c, T, colors)
            return {"kind": "rec", "m1": m1, "csel": csel, "m3": m3,
                    "Tk": Tk}
        rec = mid_recursive_planes(mid_arr, T)
        return {"kind": "rec", "m1": _to_ss16(rec["m1"]),
                "csel": _to_ss16(rec["csel"]), "m3": _to_ss16(rec["m3"]),
                "Tk": Tk}
    if T > 32767:
        raise ValueError(
            "brute middle stage holds tile ids in int16 (T <= 32767); "
            "pad the stream to a 1024-tile multiple for the recursive "
            "middle"
        )
    Tp = _round_up(T, 128)
    K = Tp // 128
    mid = np.tile(np.arange(Tp, dtype=np.int16), (1024, 1))
    mid[:, :T] = mid_arr.astype(np.int16)
    mid_ss = np.ascontiguousarray(mid.reshape(1024, K, 128).transpose(1, 0, 2))
    return {"kind": "brute", "mid": mid_ss, "Tk": K}


def route_arrays_from_perm(
    perm, n: int | None = None, tile_multiple: int = 1024
) -> dict:
    """Device-ready route arrays straight from a permutation: the native
    coloring, the stream-layout stage planes and the middle planes.
    Without the native library: plan_route + route_arrays."""
    from cvr_tpu_torch import _native
    from cvr_tpu_torch.ops.route import TILE, plan_route

    if not _native.available():
        return route_arrays(plan_route(perm, n=n, tile_multiple=tile_multiple))
    perm = np.asarray(perm, dtype=np.int64)
    n = int(perm.shape[0]) if n is None else n
    N = perm.shape[0]
    T = max(1, -(-N // TILE))
    T = -(-T // tile_multiple) * tile_multiple
    full = np.arange(T * TILE, dtype=np.int64)
    full[:N] = perm
    Tp = _round_up(T, 128)
    s1_ss, mid, s3_ss = _native.route_compile_native(
        full.astype(np.int32), T, Tp, Tp
    )
    return {
        "s1": s1_ss,
        "mid_planes": middle_planes_from(mid, T),
        "s3": s3_ss,
        "T": T,
        "Tp": Tp,
        "n": n,
    }


def route_arrays(plan) -> dict:
    """Device-ready sublane-split int16 index planes for a RoutePlan."""
    T = plan.n_tiles
    Tp = _round_up(T, 128)
    # padded tiles route by identity
    s1 = np.tile(np.arange(1024, dtype=np.int16), (Tp, 1))
    s1[:T] = plan.s1.astype(np.int16)
    s3 = np.tile(np.arange(1024, dtype=np.int16), (Tp, 1))
    s3[:T] = plan.s3.astype(np.int16)
    return {
        "s1": _to_ss16(s1),
        "mid_planes": middle_planes(plan),
        "s3": _to_ss16(s3),
        "T": T,
        "Tp": Tp,
        "n": plan.n,
    }
