"""ctypes bindings for the native host runtime (native/libcvr_native.so).

The port shares the C++ library with the JAX package but binds it itself,
so importing it pulls in no jax.  Only the entry points the port's packs
call are bound: the MatrixMarket reader, COO->CSR assembly, the SELL-pack
converter, the routed stream builder, the zone scatter, the fused route
compilers, the Euler colorings and plane passes of ``plan_route`` and
``mid_recursive_planes``, the recursive-middle planes, the DIA, BELL and SELL-W
passes of ``pack_auto``'s other formats, and the BSR-128 densification.
The library is built at first use with ``make -C native``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False

_REPO_ROOT = Path(__file__).resolve().parent.parent
_SO_PATH = _REPO_ROOT / "native" / "libcvr_native.so"
_VERSION = 16

FIELD_NAMES = {0: "real", 1: "integer", 2: "pattern", 3: "complex"}
SYM_NAMES = {0: "general", 1: "symmetric", 2: "skew-symmetric", 3: "hermitian"}

_i64 = ctypes.c_int64
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


class NativeError(RuntimeError):
    pass


# native/Makefile's CXXFLAGS and LDFLAGS without -fopenmp (keep the two in
# step when the Makefile changes).  The source runs single-threaded without
# it; its OpenMP paths are deterministic across thread counts, so the packs
# are the same arrays.
_NO_OPENMP = (
    "CXXFLAGS=-O3 -march=native -std=c++17 -fPIC -Wall -Wno-unknown-pragmas",
    "LDFLAGS=-shared",
)


def _make(*extra: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        ["make", "-C", str(_SO_PATH.parent), *extra],
        capture_output=True,
        text=True,
        timeout=300,
    )


def build() -> str:
    """Build native/libcvr_native.so if it is missing; raise on failure.

    Returns how: "present", "openmp", or "no-openmp" where the Makefile's
    build fails only because the compiler has no OpenMP runtime (no
    ``libgomp.spec``).  Any other build error raises.
    """
    if _SO_PATH.exists():
        return "present"
    how, proc = "openmp", _make()
    if proc.returncode != 0 and "libgomp.spec" in proc.stderr:
        how, proc = "no-openmp", _make(*_NO_OPENMP)
    if proc.returncode != 0 or not _SO_PATH.exists():
        raise NativeError(
            f"make -C native ({how}) failed, rc {proc.returncode}:\n"
            f"{proc.stderr[-2000:]}"
        )
    return how


def get_lib():
    """The loaded native library, or None if it is unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        build()
        lib = ctypes.CDLL(str(_SO_PATH))
    except (NativeError, OSError, subprocess.TimeoutExpired):
        return None

    lib.cvr_last_error.restype = ctypes.c_char_p
    lib.cvr_version.restype = ctypes.c_int
    lib.cvr_mtx_open.restype = ctypes.c_int
    lib.cvr_mtx_open.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(_i64),
        ctypes.POINTER(_i64),
        ctypes.POINTER(_i64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.cvr_mtx_read.restype = ctypes.c_int
    lib.cvr_mtx_read.argtypes = [ctypes.c_int, _i32p, _i32p, _f32p, ctypes.c_int]
    lib.cvr_mtx_close.restype = ctypes.c_int
    lib.cvr_mtx_close.argtypes = [ctypes.c_int]
    lib.cvr_coo_to_csr.restype = ctypes.c_int
    lib.cvr_coo_to_csr.argtypes = [
        _i64, _i64, _i32p, _i32p, _f32p, _i64p, _i32p, _f32p,
    ]
    lib.cvr_sell_count_segments.restype = _i64
    lib.cvr_sell_count_segments.argtypes = [_i64, _i64p, _i64]
    lib.cvr_sell_plan.restype = ctypes.c_int
    lib.cvr_sell_plan.argtypes = [
        _i64, _i64p, _i64, _i64, _i32p, _i32p, _i32p, _i64p,
    ]
    lib.cvr_sell_fill.restype = ctypes.c_int
    lib.cvr_sell_fill.argtypes = [
        _i64, _i64, _i64p, _i32p, _f32p, _i32p, _i32p, _i32p, _i64p,
        _i32p, _f32p, _i32p,
    ]
    lib.cvr_stream_count2.restype = _i64
    lib.cvr_stream_count2.argtypes = [
        _i64, _i64, _i64p, _i32p, _i64, _i64, _i64, _i64p,
    ]
    lib.cvr_stream_fill2.restype = ctypes.c_int
    lib.cvr_stream_fill2.argtypes = [
        _i64, _i64, _i64p, _i32p, _i64, _i64, _i64, _i64p, _i64,
        _i32p, _i16p, _i32p, _i8p, _i32p,
    ]
    lib.cvr_euler_color.restype = ctypes.c_int
    lib.cvr_euler_color.argtypes = [
        _i64, _i32p, _i32p, _i64, ctypes.c_int32, _i32p,
    ]
    lib.cvr_euler_color_perm.restype = ctypes.c_int
    lib.cvr_euler_color_perm.argtypes = [_i64, _i32p, _i64, _i32p]
    lib.cvr_route_planes.restype = ctypes.c_int
    lib.cvr_route_planes.argtypes = [
        _i64, _i32p, _i32p, _i64, _i16p, _i32p, _i16p,
    ]
    lib.cvr_mid_planes.restype = ctypes.c_int
    lib.cvr_mid_planes.argtypes = [_i64, _i32p, _i32p, _i16p, _i16p, _i16p]
    lib.cvr_color_rows_cap.restype = ctypes.c_int
    lib.cvr_color_rows_cap.argtypes = [_i64, _i64, _i32p, _i32p]
    lib.cvr_mid_planes_ss.restype = ctypes.c_int
    lib.cvr_mid_planes_ss.argtypes = [
        _i64, _i32p, _i32p, _i16p, _i16p, _i16p,
    ]
    lib.cvr_route_compile.restype = ctypes.c_int
    lib.cvr_route_compile.argtypes = [
        _i64, _i32p, _i64, _i64, _i64, ctypes.c_void_p, _i16p, _i32p,
        _i16p,
    ]
    lib.cvr_route_compile_zone.restype = ctypes.c_int
    lib.cvr_route_compile_zone.argtypes = [
        _i64, _i32p, _i64, _i64, _i64, ctypes.c_void_p, _i16p, _i32p,
        _i16p, _i64, _i64p, _i32p, _i64, _i32p, _i32p,
    ]
    lib.cvr_zone_scatter.restype = ctypes.c_int
    lib.cvr_zone_scatter.argtypes = [
        _i64, _i64, _i64p, _i64, _i64p, _i32p, _i64p, _i64, _i32p,
        _f32p, _i32p, _f32p,
    ]
    lib.cvr_window_minmax.restype = ctypes.c_int
    lib.cvr_window_minmax.argtypes = [
        _i64, _i64, _i64, _i64p, _i32p, _i64p, _i64, _i32p, _i32p, _i32p,
    ]
    lib.cvr_window_fill_ss.restype = ctypes.c_int
    lib.cvr_window_fill_ss.argtypes = [
        _i64, _i64, _i64, _i64p, _i32p, _f32p, _i64p, _i64p, _i32p,
        _i64, _i32p, _f32p, _i16p,
    ]
    lib.cvr_dia_offsets.restype = ctypes.c_int
    lib.cvr_dia_offsets.argtypes = [_i64, _i64, _i64p, _i32p, _u8p]
    lib.cvr_dia_fill.restype = ctypes.c_int
    lib.cvr_dia_fill.argtypes = [
        _i64, _i64, _i64p, _i32p, _f32p, _i64, _i64p, _f32p,
    ]
    lib.cvr_bell_stats.restype = _i64
    lib.cvr_bell_stats.argtypes = [_i64, _i64p, _i32p, _i64, _i32p]
    lib.cvr_bell_fill.restype = _i64
    lib.cvr_bell_fill.argtypes = [
        _i64, _i64p, _i32p, _f32p, _i64, _i64, _i64, _i64,
        _i16p, _f32p, _i64, _i32p, _i32p, _f32p,
    ]
    lib.cvr_bsr_count.restype = _i64
    lib.cvr_bsr_count.argtypes = [_i64, _i64, _i64p, _i32p]
    lib.cvr_bsr_fill.restype = ctypes.c_int
    lib.cvr_bsr_fill.argtypes = [
        _i64, _i64, _i64p, _i32p, _f32p, _i64, _i32p, _i32p, _f32p,
    ]
    if lib.cvr_version() != _VERSION:
        return None
    _LIB = lib
    return _LIB


def available() -> bool:
    return get_lib() is not None


def _need_lib():
    lib = get_lib()
    if lib is None:
        raise NativeError("native library unavailable")
    return lib


def _check(lib, rc: int) -> None:
    if rc != 0:
        raise NativeError(lib.cvr_last_error().decode())


def mtx_read_native(path: str | os.PathLike, pattern_mode: int = 0):
    """Parse a coordinate .mtx with the native parser.

    Returns (rows, cols, vals, nrows, ncols, field, symmetry) with raw
    (un-mirrored) entries, 0-based.  Raises NativeError when the native
    path can't handle the file (caller falls back to the Python parser).
    """
    lib = _need_lib()
    nrows, ncols, nnz = _i64(), _i64(), _i64()
    field, sym = ctypes.c_int(), ctypes.c_int()
    h = lib.cvr_mtx_open(
        str(path).encode(),
        ctypes.byref(nrows),
        ctypes.byref(ncols),
        ctypes.byref(nnz),
        ctypes.byref(field),
        ctypes.byref(sym),
    )
    if h < 0:
        raise NativeError(lib.cvr_last_error().decode())
    try:
        rows = np.empty(nnz.value, dtype=np.int32)
        cols = np.empty(nnz.value, dtype=np.int32)
        vals = np.empty(nnz.value, dtype=np.float32)
        _check(lib, lib.cvr_mtx_read(h, rows, cols, vals, pattern_mode))
    finally:
        lib.cvr_mtx_close(h)
    return (
        rows,
        cols,
        vals,
        int(nrows.value),
        int(ncols.value),
        FIELD_NAMES[field.value],
        SYM_NAMES[sym.value],
    )


def coo_to_csr_native(nrows: int, rows, cols, vals):
    lib = _need_lib()
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    nnz = rows.shape[0]
    rowptr = np.empty(nrows + 1, dtype=np.int64)
    out_cols = np.empty(nnz, dtype=np.int32)
    out_vals = np.empty(nnz, dtype=np.float32)
    _check(lib, lib.cvr_coo_to_csr(
        nrows, nnz, rows, cols, vals, rowptr, out_cols, out_vals
    ))
    return rowptr, out_cols, out_vals


def sell_pack_native(rowptr, csr_cols, csr_vals, C: int, split_len: int):
    """Native CSR -> SELL-pack.  Returns the same arrays sell_pack builds
    (a counting sort on segment length, stable like
    np.argsort(kind='stable'))."""
    lib = _need_lib()
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    csr_cols = np.ascontiguousarray(csr_cols, dtype=np.int32)
    csr_vals = np.ascontiguousarray(csr_vals, dtype=np.float32)
    nrows = rowptr.shape[0] - 1

    G = int(lib.cvr_sell_count_segments(nrows, rowptr, split_len))
    seg_row = np.empty(G, dtype=np.int32)
    seg_off = np.empty(G, dtype=np.int32)
    sorted_len = np.empty(G, dtype=np.int32)
    order = np.empty(G, dtype=np.int64)
    _check(lib, lib.cvr_sell_plan(
        nrows, rowptr, split_len, G, seg_row, seg_off, sorted_len, order
    ))

    nslices = max(1, -(-G // C))
    P = nslices * C
    pad_sorted_len = np.zeros(P, dtype=np.int32)
    pad_sorted_len[:G] = sorted_len
    widths = pad_sorted_len.reshape(nslices, C).max(axis=1)
    slice_offsets = np.zeros(nslices + 1, dtype=np.int32)
    np.cumsum(widths, out=slice_offsets[1:])
    S = int(slice_offsets[-1])

    vals_plane = np.zeros((S, C), dtype=np.float32)
    cols_plane = np.zeros((S, C), dtype=np.int32)
    _check(lib, lib.cvr_sell_fill(
        G, C, rowptr, csr_cols, csr_vals, seg_row, seg_off, sorted_len,
        order, slice_offsets, vals_plane, cols_plane,
    ))

    perm = np.full(P, nrows, dtype=np.int32)
    perm[:G] = seg_row[order]
    seg_offset = np.zeros(P, dtype=np.int32)
    seg_offset[:G] = seg_off[order]
    slot_slice = np.repeat(np.arange(nslices, dtype=np.int32), widths)
    return (
        vals_plane,
        cols_plane,
        slice_offsets,
        slot_slice,
        perm,
        seg_offset,
        pad_sorted_len,
        G - nrows,
    )


def stream_count2_native(
    rmap, cols_plane, S_padded: int, nsw_total: int, segw: int, TB: int,
):
    """The stream builder's first pass: (T_src_p, swcnt), the real tile
    count (segments padded to TB tiles) and the per-subwindow counts."""
    lib = _need_lib()
    rmap = np.ascontiguousarray(rmap, dtype=np.int64)
    cols_plane = np.ascontiguousarray(cols_plane, dtype=np.int32)
    swcnt = np.empty(nsw_total, dtype=np.int64)
    T_src_p = int(
        lib.cvr_stream_count2(
            rmap.shape[0], S_padded, rmap, cols_plane, nsw_total, segw * 8,
            TB, swcnt,
        )
    )
    return T_src_p, swcnt


def stream_build2_native(
    rmap, cols_plane, S_padded: int, nsw_total: int, segw: int, TB: int,
    force_T: int = 0,
):
    """Subwindow-granular routed-pack stream builder.

    Tiles slide at 128-column granularity, and each tile carries its
    gather-candidate count for the expand pass.  ``segw`` is in
    1024-column windows (segw * 8 subwindows per x segment).  ``force_T``
    (0: off) pins the tile count, which must cover the stream's own.

    Returns (perm int32[T*1024], li_flat int16[T*1024],
    w8 int32[T] segment-relative sublane bases, cand int8[T],
    seg_blk int32[T//TB], T, T_src_p).
    """
    lib = _need_lib()
    rmap = np.ascontiguousarray(rmap, dtype=np.int64)
    cols_plane = np.ascontiguousarray(cols_plane, dtype=np.int32)
    S = rmap.shape[0]
    segw8 = segw * 8
    T_src_p, swcnt = stream_count2_native(rmap, cols_plane, S_padded,
                                          nsw_total, segw, TB)
    T = -(-max(T_src_p, S_padded) // 1024) * 1024
    if force_T:
        if force_T < T:
            raise ValueError(f"force_T {force_T} < required T {T}")
        T = force_T
    perm = np.empty(T * 1024, dtype=np.int32)
    li_flat = np.empty(T * 1024, dtype=np.int16)
    w8 = np.empty(T, dtype=np.int32)
    cand = np.empty(T, dtype=np.int8)
    seg_blk = np.empty(T // TB, dtype=np.int32)
    _check(lib, lib.cvr_stream_fill2(
        S, S_padded, rmap, cols_plane, nsw_total, segw8, TB, swcnt, T,
        perm, li_flat, w8, cand, seg_blk,
    ))
    return perm, li_flat, w8, cand, seg_blk, T, T_src_p


def euler_color_native(src, dst, n_tiles: int, k: int):
    """k-edge-coloring of the k-regular bipartite tile multigraph with
    edges (src[i], dst[i]) (the routing assignment of ops/route.py)."""
    lib = _need_lib()
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    color = np.empty(src.shape[0], dtype=np.int32)
    _check(lib, lib.cvr_euler_color(src.shape[0], src, dst, n_tiles, k,
                                    color))
    return color


def euler_color_perm_native(perm, T: int):
    """The route's edge coloring with src = perm >> 10 and dst = i >> 10
    derived (no edge arrays)."""
    lib = _need_lib()
    perm = np.ascontiguousarray(perm, dtype=np.int32)
    color = np.empty(perm.shape[0], dtype=np.int32)
    _check(lib, lib.cvr_euler_color_perm(perm.shape[0], perm, T, color))
    return color


def route_planes_native(perm, colors, T: int):
    """The logical s1 (T, 1024) i16, mid (1024, T) i32 and s3 (T, 1024)
    i16 planes of a colored route, in one pass."""
    lib = _need_lib()
    perm = np.ascontiguousarray(perm, dtype=np.int32)
    colors = np.ascontiguousarray(colors, dtype=np.int32)
    s1 = np.empty((T, 1024), dtype=np.int16)
    mid = np.empty((1024, T), dtype=np.int32)
    s3 = np.empty((T, 1024), dtype=np.int16)
    _check(lib, lib.cvr_route_planes(perm.shape[0], perm, colors, T, s1, mid,
                                     s3))
    return s1, mid, s3


def mid_planes_native(mid, T: int, colors_rows):
    """Recursive-middle planes (m1, csel, m3), logical (T, 1024) each."""
    lib = _need_lib()
    mid = np.ascontiguousarray(mid, dtype=np.int32)
    colors_rows = np.ascontiguousarray(colors_rows, dtype=np.int32)
    m1 = np.empty((T, 1024), dtype=np.int16)
    csel = np.empty((T, 1024), dtype=np.int16)
    m3 = np.empty((T, 1024), dtype=np.int16)
    _check(lib, lib.cvr_mid_planes(T, mid, colors_rows, m1, csel, m3))
    return m1, csel, m3


def color_rows_cap_native(mid, T: int, tk: int):
    """Per-row chunk colorings on the aggregated capacity matrix."""
    lib = _need_lib()
    mid = np.ascontiguousarray(mid, dtype=np.int32)
    color = np.empty(1024 * T, dtype=np.int32)
    _check(lib, lib.cvr_color_rows_cap(T, tk, mid, color))
    return color


def mid_planes_ss_native(mid, T: int, colors_rows):
    """Recursive-middle planes (m1, csel, m3) in the sublane-split device
    layout (8, T, 128)."""
    lib = _need_lib()
    m1 = np.zeros((8, T, 128), dtype=np.int16)
    csel = np.zeros((8, T, 128), dtype=np.int16)
    m3 = np.zeros((8, T, 128), dtype=np.int16)
    _check(lib, lib.cvr_mid_planes_ss(T, mid, colors_rows, m1, csel, m3))
    return m1, csel, m3


def route_compile_native(perm, T: int, Tp: int, S_dst: int, li_flat=None):
    """Fused Euler coloring + plane emission (one native call): returns
    (s1_ss (8,Tp,128) i16, mid (1024,T) i32, p3_ss (8,S_dst,128) i16).
    With li_flat, s1 carries the stage-1 li composition (expand plane);
    without, the raw offsets (y-route)."""
    lib = _need_lib()
    perm = np.ascontiguousarray(perm, dtype=np.int32)
    s1 = np.zeros((8, Tp, 128), dtype=np.int16)
    mid = np.empty((1024, T), dtype=np.int32)
    p3 = np.zeros((8, S_dst, 128), dtype=np.int16)
    li_ptr = None
    if li_flat is not None:
        li_flat = np.ascontiguousarray(li_flat, dtype=np.int16)
        li_ptr = li_flat.ctypes.data
    _check(lib, lib.cvr_route_compile(
        perm.shape[0], perm, T, Tp, S_dst, li_ptr, s1, mid, p3
    ))
    return s1, mid, p3


def route_compile_zone_native(
    perm, T: int, Tp: int, S_dst: int, li_flat, nslA: int, zr0, zw,
    zrows: int, row_slice,
):
    """Fused route compile with zone-A lambda-segment slices: every
    zone-A edge's slot sublane equals its color's top-3 bits, so the
    reduce's stage-3 is one lane-gather per sublane.

    Returns (s1_ss, mid, p3_ss, r2) where r2[final] = provisional plane
    position (permute the value planes with it)."""
    lib = _need_lib()
    perm = np.ascontiguousarray(perm, dtype=np.int32)
    s1 = np.zeros((8, Tp, 128), dtype=np.int16)
    mid = np.empty((1024, T), dtype=np.int32)
    p3 = np.zeros((8, S_dst, 128), dtype=np.int16)
    r2 = np.empty(perm.shape[0], dtype=np.int32)
    li_flat = np.ascontiguousarray(li_flat, dtype=np.int16)
    _check(lib, lib.cvr_route_compile_zone(
        perm.shape[0], perm, T, Tp, S_dst, li_flat.ctypes.data, s1, mid,
        p3, nslA,
        np.ascontiguousarray(zr0, dtype=np.int64),
        np.ascontiguousarray(zw, dtype=np.int32),
        zrows,
        np.ascontiguousarray(row_slice, dtype=np.int32),
        r2,
    ))
    return s1, mid, p3, r2


def zone_scatter_native(
    oldoff, zsl_old: int, zr0, lane_len, rmapB, S_padded: int,
    cols_plane, vals_plane,
):
    """Scatter the SELL planes into the routed provisional layout
    (zone-A lambda-segment slices + zone-B row shift) in one pass.
    Returns (cols_prov (S_padded,1024) i32, vals_prov f32)."""
    lib = _need_lib()
    oldoff = np.ascontiguousarray(oldoff, dtype=np.int64)
    cols_plane = np.ascontiguousarray(cols_plane, dtype=np.int32)
    vals_plane = np.ascontiguousarray(vals_plane, dtype=np.float32)
    S_old = cols_plane.shape[0]
    cols_out = np.empty((S_padded, 1024), dtype=np.int32)
    vals_out = np.empty((S_padded, 1024), dtype=np.float32)
    _check(lib, lib.cvr_zone_scatter(
        S_old, oldoff.shape[0] - 1, oldoff, zsl_old,
        np.ascontiguousarray(zr0, dtype=np.int64),
        np.ascontiguousarray(lane_len, dtype=np.int32),
        np.ascontiguousarray(rmapB, dtype=np.int64),
        S_padded, cols_plane, vals_plane, cols_out, vals_out,
    ))
    return cols_out, vals_out


def window_minmax_native(nrows: int, C: int, D: int, rowptr, csr_cols,
                         slice_offsets):
    """Per-plane-row column min/max straight from CSR (SELL-W pass 1), rows
    in natural order."""
    lib = _need_lib()
    S = int(slice_offsets[-1])
    wmin = np.empty(S, dtype=np.int32)
    wmax = np.empty(S, dtype=np.int32)
    _check(lib, lib.cvr_window_minmax(
        nrows, C, D,
        np.ascontiguousarray(rowptr, dtype=np.int64),
        np.ascontiguousarray(csr_cols, dtype=np.int32),
        np.ascontiguousarray(slice_offsets, dtype=np.int64),
        S, np.arange(nrows, dtype=np.int32), wmin, wmax,
    ))
    return wmin, wmax


def window_fill_ss_native(nrows: int, C: int, D: int, rowptr, csr_cols,
                          csr_vals, slice_offsets, rmap, base_col,
                          S_pad: int):
    """Value and in-window-offset planes, directly in the padded stream
    layout (8, S_pad, 128) (SELL-W pass 2)."""
    lib = _need_lib()
    vals_ss = np.zeros((8, S_pad, 128), dtype=np.float32)
    li_ss = np.zeros((8, S_pad, 128), dtype=np.int16)
    _check(lib, lib.cvr_window_fill_ss(
        nrows, C, D,
        np.ascontiguousarray(rowptr, dtype=np.int64),
        np.ascontiguousarray(csr_cols, dtype=np.int32),
        np.ascontiguousarray(csr_vals, dtype=np.float32),
        np.ascontiguousarray(slice_offsets, dtype=np.int64),
        np.ascontiguousarray(rmap, dtype=np.int64),
        np.ascontiguousarray(base_col, dtype=np.int32),
        S_pad, np.arange(nrows, dtype=np.int32), vals_ss, li_ss,
    ))
    return vals_ss, li_ss


def dia_offsets_native(rowptr, cols, nrows: int, ncols: int) -> np.ndarray:
    """Distinct diagonals (col - row), sorted, in one native pass."""
    lib = _need_lib()
    flags = np.zeros(nrows + ncols, dtype=np.uint8)
    _check(lib, lib.cvr_dia_offsets(
        nrows, int(rowptr[-1]),
        np.ascontiguousarray(rowptr, dtype=np.int64),
        np.ascontiguousarray(cols, dtype=np.int32),
        flags,
    ))
    return np.flatnonzero(flags).astype(np.int64) - nrows


def dia_fill_native(rowptr, cols, vals, offsets, nrows: int) -> np.ndarray:
    """DIA band planes (nd, nrows) in one native pass."""
    lib = _need_lib()
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    bands = np.zeros((offsets.shape[0], nrows), dtype=np.float32)
    _check(lib, lib.cvr_dia_fill(
        nrows, int(rowptr[-1]),
        np.ascontiguousarray(rowptr, dtype=np.int64),
        np.ascontiguousarray(cols, dtype=np.int32),
        np.ascontiguousarray(vals, dtype=np.float32),
        offsets.shape[0], offsets, bands,
    ))
    return bands


def bell_stats_native(rowptr, cols, cap: int):
    """Per-row counts of entries within ``cap`` of the diagonal, and the
    reach (the largest such |col - row|)."""
    lib = _need_lib()
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    nrows = rowptr.shape[0] - 1
    near_lens = np.empty(nrows, dtype=np.int32)
    reach = int(lib.cvr_bell_stats(nrows, rowptr, cols, cap, near_lens))
    return near_lens, reach


def bell_fill_native(rowptr, cols, vals, k: int, cap: int, cr: int,
                     R128: int, spill_cap: int):
    """BELL (li, val) planes (k, R128) and the spill as COO triples, in one
    pass.  Returns (li int16, vals f32, spill_rows, spill_cols,
    spill_vals), the spill arrays cut to their count."""
    lib = _need_lib()
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    nrows = rowptr.shape[0] - 1
    li = np.zeros((k, R128), dtype=np.int16)
    vout = np.zeros((k, R128), dtype=np.float32)
    sr = np.empty(spill_cap, dtype=np.int32)
    sc = np.empty(spill_cap, dtype=np.int32)
    sv = np.empty(spill_cap, dtype=np.float32)
    ns = int(lib.cvr_bell_fill(
        nrows, rowptr, cols, vals, k, cap, cr, R128, li, vout,
        spill_cap, sr, sc, sv,
    ))
    if ns < 0:
        raise NativeError("bell_fill: spill capacity exceeded")
    return li, vout, sr[:ns], sc[:ns], sv[:ns]


def bsr_count_native(nrows: int, ncb: int, rowptr, cols) -> int:
    """Occupied 128x128 brick count (BSR pass 1)."""
    lib = _need_lib()
    return int(lib.cvr_bsr_count(
        nrows, ncb,
        np.ascontiguousarray(rowptr, dtype=np.int64),
        np.ascontiguousarray(cols, dtype=np.int32),
    ))


def bsr_fill_native(nrows: int, ncb: int, rowptr, cols, vals, nbricks: int):
    """Brick coordinates (sorted by row block, then column block) and the
    dense value planes (BSR pass 2): (brick_row, brick_col, vals
    (nbricks, 128, 128) f32)."""
    lib = _need_lib()
    brick_row = np.empty(nbricks, dtype=np.int32)
    brick_col = np.empty(nbricks, dtype=np.int32)
    bvals = np.zeros((nbricks, 128, 128), dtype=np.float32)
    _check(lib, lib.cvr_bsr_fill(
        nrows, ncb,
        np.ascontiguousarray(rowptr, dtype=np.int64),
        np.ascontiguousarray(cols, dtype=np.int32),
        np.ascontiguousarray(vals, dtype=np.float32),
        nbricks, brick_row, brick_col, bvals,
    ))
    return brick_row, brick_col, bvals
