"""SELL-W: the window-gather SpMV format, for matrices with column locality.

For FEM and engineering matrices (dense rows in a narrow band after
reordering) the routed path's four gather passes and its route compile
buy nothing: with rows kept in natural order, the 1024 columns of one
packed plane row span a narrow range.  SELL-W exploits that:

  * rows stay in natural order (slice i = rows [i*1024/D, (i+1)*1024/D),
    each row on D consecutive lanes), so y is a reshape and a D-fold of
    the slice sums: no y-route, no scatter;
  * each plane row gets an aligned column window (1024 or 2048 wide,
    chosen at pack time from the measured spreads) in one of G shifted
    offset grids; padding slots point at the row's smallest column;
  * the SpMV is one gather-multiply-sum pass (K10,
    cvr_tpu_torch/ops/window_kernels.py).

``sell_pack_window`` raises WindowInfeasible when some plane row's spread
fits no window (power-law matrices); ``pack_auto`` then takes the routed
path.  Same arrays as the JAX package's pack of the same matrix.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.utils.timing import PhaseTimer

TILE = 1024
# 1024-column windows per x segment.  The JAX package sizes its VMEM x
# table by it; the port keeps it so that both packs agree.
SEGW_WIN = 128
# Aligned offset grids: grid g's windows start at g*1024/NGRIDS mod 1024,
# which caps the alignment loss of a window at 255 columns.
NGRIDS = 4


class WindowInfeasible(ValueError):
    """Column spread exceeds the window reach: use the routed path."""


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class SellWindow:
    """Host-side SELL-W artifact (see ops/spmv_window.to_device_window)."""

    vals_ss: np.ndarray  # (8, S_pad, 128) f32, stream layout
    li: np.ndarray  # (8, S_pad, 128) int16 in [0, W)
    w10: np.ndarray  # (S_pad,) int32 segment-relative window index
    seg_blk: np.ndarray  # (S_pad // CH,) int32 x segment per CH rows
    emit: np.ndarray  # (S_pad,) int32 group-local slice id on ends, -1 else
    ycall_rows: np.ndarray  # (n_groups, 2) int64 padded (start, rows)
    shape: tuple[int, int]
    nnz: int
    W: int  # window width: 1024 or 2048
    D: int  # lane duplication: each row occupies D lanes
    G: int  # aligned offset grids in the x table
    S: int  # plane rows before padding
    S_pad: int
    nslices: int
    segw: int
    n_segs: int
    wrl: int  # 128-column blocks a window gather reaches (<= W // 128)
    # a y-route to natural rows (route_planes.route_arrays), for planes
    # whose rows are in another order; the pack gives none, a loaded
    # artifact may carry one
    y_ra: dict | None = None
    convert_time: float = 0.0
    convert_phases: dict = field(default_factory=dict)

    @property
    def padded_nnz(self) -> int:
        return self.S_pad * TILE

    def save(self, path) -> None:
        """Write the artifact as the JAX package's ``.npz`` layout (the
        y-route's keys only where it has one)."""
        from cvr_tpu_torch.formats.sell_routed import y_route_npz

        np.savez_compressed(
            path,
            vals_ss=self.vals_ss, li=self.li, w10=self.w10,
            seg_blk=self.seg_blk, emit=self.emit,
            ycall_rows=self.ycall_rows,
            shape=np.asarray(self.shape, dtype=np.int64),
            nnz=np.int64(self.nnz), W=np.int64(self.W),
            D=np.int64(self.D), G=np.int64(self.G),
            S=np.int64(self.S), S_pad=np.int64(self.S_pad),
            nslices=np.int64(self.nslices), segw=np.int64(self.segw),
            n_segs=np.int64(self.n_segs), wrl=np.int64(self.wrl),
            **(y_route_npz(self.y_ra) if self.y_ra is not None else {}),
        )

    @staticmethod
    def load(path) -> "SellWindow":
        """Read a SELL-W artifact that either package saved; a file
        without wrl loads wrl 0, which the upload reads as W // 128, as
        the JAX package does."""
        from cvr_tpu_torch.formats.sell_routed import y_route_from_npz

        z = np.load(path)
        W = int(z["W"])
        return SellWindow(
            vals_ss=z["vals_ss"], li=z["li"], w10=z["w10"],
            seg_blk=z["seg_blk"], emit=z["emit"],
            ycall_rows=z["ycall_rows"],
            shape=tuple(int(v) for v in z["shape"]),
            nnz=int(z["nnz"]), W=W, D=int(z["D"]), G=int(z["G"]),
            S=int(z["S"]), S_pad=int(z["S_pad"]),
            nslices=int(z["nslices"]), segw=int(z["segw"]),
            n_segs=int(z["n_segs"]),
            wrl=int(z["wrl"]) if "wrl" in z.files else 0,
            y_ra=y_route_from_npz(z) if "y_s1" in z.files else None,
        )


def _plan_for_d(nrows, row_lengths, D):
    """Slice layout for duplication factor D: a slice covers 1024/D rows,
    each row on D lanes with ceil(len/D) slots."""
    rps = TILE // D
    nslices = max(1, _round_up(max(nrows, 1), rps) // rps)
    L = np.zeros(nslices * rps, dtype=np.int64)
    L[:nrows] = -(-row_lengths // D)
    widths = L.reshape(nslices, rps).max(axis=1)
    slice_offsets = np.zeros(nslices + 1, dtype=np.int64)
    np.cumsum(widths, out=slice_offsets[1:])
    S = int(slice_offsets[-1])
    if S == 0:  # empty matrix: one zero plane row for shape sanity
        widths[0] = 1
        slice_offsets[1:] = 1
        S = 1
    return nslices, widths, slice_offsets, S


def _window_fill_numpy(nrows, C, D, rowptr, cols, vals, slice_offsets):
    """NumPy form of the native fill: (vals_plane, cols_plane, pad mask,
    per-row column min, max) over the (S, C) planes."""
    S = int(slice_offsets[-1])
    SENT = np.iinfo(np.int32).max
    vals_plane = np.zeros((S, C), dtype=np.float32)
    cols_plane = np.full((S, C), SENT, dtype=np.int32)
    nnz = int(rowptr[-1])
    rps = C // D
    if nnz:
        lengths = np.diff(rowptr)
        r = np.repeat(np.arange(nrows, dtype=np.int64), lengths)
        j = np.arange(nnz, dtype=np.int64) - np.repeat(rowptr[:-1], lengths)
        L = np.repeat(np.maximum(-(-lengths // D), 1), lengths)
        slot = j % L
        lane = (r % rps) * D + j // L
        dest = (slice_offsets[r // rps] + slot) * C + lane
        vals_plane.reshape(-1)[dest] = vals
        cols_plane.reshape(-1)[dest] = cols
    masked = np.ma.masked_equal(cols_plane, SENT)
    wmin = masked.min(axis=1).filled(0).astype(np.int32)
    wmax = masked.max(axis=1).filled(0).astype(np.int32)
    pad = cols_plane == SENT
    cols_plane = np.where(pad, wmin[:, None], cols_plane)
    return vals_plane, cols_plane, pad, wmin, wmax


def _grid_fit(wmin, wmax, W, G):
    """Per plane row, the offset grid whose W-wide aligned window covers
    [wmin, wmax] with the smallest largest in-window offset.  Returns
    (all rows fit, grid, window index)."""
    step = 1024 // G
    wmin64 = wmin.astype(np.int64)
    wmax64 = wmax.astype(np.int64)
    grid = np.full(wmin.shape[0], -1, dtype=np.int32)
    wb = np.zeros(wmin.shape[0], dtype=np.int32)
    best = np.full(wmin.shape[0], np.iinfo(np.int64).max)
    for g in range(G):
        wb_g = (wmin64 - g * step) >> 10
        base = wb_g * 1024 + g * step
        ok = (wb_g >= 0) & (wmax64 < base + W)
        limax = wmax64 - base
        take = ok & (limax < best)
        grid = np.where(take, g, grid)
        wb = np.where(take, wb_g.astype(np.int32), wb)
        best = np.where(take, limax, best)
    return bool(np.all(grid >= 0)), grid, wb


def sell_pack_window(
    csr: CSRMatrix,
    segw: int = SEGW_WIN,
    use_native: bool | None = None,
    force_dw: tuple[int, int] | None = None,
) -> SellWindow:
    """CSR -> SELL-W, O(nnz).

    Takes the cheapest feasible (D, W): duplication D narrows each plane
    row's column spread about D-fold for ~D/2 extra slots per row, and
    W = 1024 halves the gather reach of 2048.  Raises WindowInfeasible
    when nothing fits.  ``use_native`` (default: float32 values) picks the
    native passes over the numpy ones when the library loads.  ``force_dw``
    pins (D, W), so that row shards packed one by one share one geometry
    (cvr_tpu_torch/parallel/dist_window.py); WindowInfeasible if it does
    not fit.
    """
    from cvr_tpu_torch.ops import route_planes as rp

    CH, YB = rp.CH, rp.YB
    pt = PhaseTimer()
    nrows, ncols = csr.shape
    if use_native is None:
        use_native = csr.vals.dtype == np.float32
    native_ok = False
    if use_native:
        from cvr_tpu_torch import _native

        native_ok = _native.available()

    with pt.phase("plan"):
        plans = {D: _plan_for_d(nrows, csr.row_lengths, D) for D in (1, 2, 4)}
        # candidate order: estimated kernel cost = rows x (base + gathers)
        cands = [tuple(force_dw)] if force_dw is not None else sorted(
            [(D, W) for D in (1, 2, 4) for W in (1024, 2048)],
            key=lambda dw: plans[dw[0]][3] * (40 + 4.5 * (dw[1] // 128)),
        )

    with pt.phase("minmax"):
        minmax = {}  # D -> (wmin, wmax)
        fills = {}  # D -> numpy fill (numpy path only)

        def get_minmax(D):
            if D not in minmax:
                offs = plans[D][2]
                if native_ok:
                    minmax[D] = _native.window_minmax_native(
                        nrows, TILE, D, csr.rowptr, csr.cols, offs)
                else:
                    fills[D] = _window_fill_numpy(
                        nrows, TILE, D, csr.rowptr, csr.cols,
                        csr.vals.astype(np.float32), offs)
                    minmax[D] = (fills[D][3], fills[D][4])
            return minmax[D]

        chosen = None
        for D, W in cands:
            wmin, wmax = get_minmax(D)
            ok, grid, wb_used = _grid_fit(wmin, wmax, W, NGRIDS)
            if ok:
                chosen = (D, W, grid, wb_used)
                break
        if chosen is None:
            # the spread without duplication (the pinned D's under force_dw)
            wmin, wmax = minmax.get(1) or minmax[cands[0][0]]
            spread = int((wmax.astype(np.int64) - wmin.astype(np.int64)).max())
            raise WindowInfeasible(
                f"max plane-row column spread {spread} exceeds the window "
                "reach even with lane duplication; no window locality — "
                "use the routed path"
            )
        D, W, grid, wb_used = chosen
        nslices, widths, slice_offsets, S = plans[D]
        base_col = wb_used * 1024 + grid * (1024 // NGRIDS)
        wmin, wmax = minmax[D]
        li_max = int(
            (wmax.astype(np.int64) - base_col.astype(np.int64)).max()
        ) if S else 0
        wrl = min(W // 128, (max(li_max, 0) >> 7) + 1)

    with pt.phase("segments"):
        nwin = max(1, -(-ncols // 1024))
        segw = min(segw, _round_up(nwin, 8))
        n_segs = -(-nwin // segw)
        seg = (wb_used // segw).astype(np.int32)
        # window index into the segment's G-grid x table: grid g's
        # 8*(segw+2) rows start at 8*g*(segw+2)
        w10 = (grid * (segw + 2) + wb_used - seg * segw).astype(np.int32)

        # maximal runs of plane rows sharing (reduce group, x segment) are
        # each padded to a CH multiple, so that every CH rows see one x
        # segment and every reduce group starts on a CH boundary
        slice_of = np.repeat(np.arange(nslices, dtype=np.int64), widths)[:S]
        grp = slice_of // YB
        n_ycalls = max(1, -(-nslices // YB))
        if S > 1:
            cut = np.flatnonzero(
                (grp[1:] != grp[:-1]) | (seg[1:] != seg[:-1])
            ) + 1
        else:
            cut = np.empty(0, dtype=np.int64)
        run_starts = np.concatenate(([0], cut))
        run_lens = np.concatenate((cut, [S])) - run_starts
        padded_lens = _round_up(run_lens, CH)
        new_starts = np.zeros(run_starts.shape[0], dtype=np.int64)
        np.cumsum(padded_lens[:-1], out=new_starts[1:])
        S_pad = int(padded_lens.sum())
        run_of_row = np.repeat(
            np.arange(run_starts.shape[0], dtype=np.int64), run_lens
        )
        rmap = (np.arange(S, dtype=np.int64) - run_starts[run_of_row]
                + new_starts[run_of_row])
        seg_blk = np.repeat(seg[run_starts], padded_lens)[::CH].astype(np.int32)
        grp_pad = np.repeat(grp[run_starts], padded_lens)
        w10_pad = np.zeros(S_pad, dtype=np.int32)
        w10_pad[rmap] = w10

    with pt.phase("fill"):
        if native_ok:
            vals_pad, li_pad = _native.window_fill_ss_native(
                nrows, TILE, D, csr.rowptr, csr.cols, csr.vals,
                slice_offsets, rmap, base_col, S_pad,
            )
        else:
            vals_plane, cols_plane, pad_mask, _, _ = fills[D]
            li = np.where(pad_mask, 0, cols_plane - base_col[:, None])
            vals_pad = np.zeros((8, S_pad, 128), dtype=np.float32)
            li_pad = np.zeros((8, S_pad, 128), dtype=np.int16)
            vals_pad[:, rmap] = vals_plane.reshape(S, 8, 128).transpose(1, 0, 2)
            li_pad[:, rmap] = li.astype(np.int16).reshape(S, 8, 128).transpose(
                1, 0, 2)

    with pt.phase("emit"):
        emit = np.full(S_pad, -1, dtype=np.int32)
        nonempty = widths > 0
        sl = np.flatnonzero(nonempty).astype(np.int64)
        ends = slice_offsets[1:][nonempty] - 1  # last plane row per slice
        emit[rmap[ends]] = (sl % YB).astype(np.int32)
        # per reduce group: (first padded row, padded row count)
        counts = np.bincount(grp_pad.astype(np.int64), minlength=n_ycalls)
        ycall_rows = np.zeros((n_ycalls, 2), dtype=np.int64)
        np.cumsum(counts[:-1], out=ycall_rows[1:, 0])
        ycall_rows[:, 1] = counts

    return SellWindow(
        vals_ss=vals_pad,
        li=li_pad,
        w10=w10_pad,
        seg_blk=seg_blk,
        emit=emit,
        ycall_rows=ycall_rows,
        shape=csr.shape,
        nnz=csr.nnz,
        W=W,
        D=D,
        G=NGRIDS,
        S=S,
        S_pad=S_pad,
        nslices=nslices,
        segw=int(segw),
        n_segs=int(n_segs),
        wrl=int(wrl),
        convert_time=pt.total,
        convert_phases=dict(pt.phases),
    )
