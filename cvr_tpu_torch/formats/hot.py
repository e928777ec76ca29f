"""Hub-column capture: the hot-column hybrid for power-law SpMV.

Scale-free matrices concentrate a large share of their nonzeros in a few
hundred *columns*.  The routed pipeline moves every stored element through
the expand, the Clos route and stage 3; an element whose column is in a
<= 1024-column hot set can instead be gathered directly from a small hot
table ``xh = x[hot_ids]``.

  * The top-NH most-referenced columns (NH in {128, 256, 512, 1024})
    form the hot set; ``xh = x[hot_ids]`` is one tiny gather per SpMV.
  * Each row's hot elements, capped at ``min(h_r, n_r - 1, HCAP)`` so that
    every captured row stays nonempty in the rest pack, move to **hot
    planes**; the rest pack is the ordinary routed artifact of the
    remaining elements.
  * Hot planes follow the REST pack's segment sort: hot slice t covers
    sorted segment positions [1024 t, 1024 (t+1)), width = max capped hot
    count in the tile (rounded up to a power of two).  The hot reduce emits
    per-slice lane sums in the y-stream layout of the routed reduce (flat
    position of segment g is g in both), so the hybrid is ONE add into the
    y stream before the shared y-route.
  * Within each row, captured elements are ordered by hot RANK (frequency
    order); each 8-plane-row group carries a gather class (the number of
    128-column windows of the hot table its ranks reach).

Whether to capture is decided at pack time by a cost model of the pipeline
(see plan_hot).  This is the JAX package's module, kept array for array:
for the same matrix both packages make the same decision and build the
same planes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

HCAP = 64  # max captured elements per row (hub rows keep their tail routed)

# The capture gate's time model.  These are TPU v5e timings, measured by
# the JAX package on that chip, kept unchanged so that the port makes the
# reference's decision on the same matrix; they say nothing about the
# H100 (recalibrating them there is open work).
NS_ROUTE_TILE = 71.0  # expand+M1+csel ns per stream tile (1024 elems)
NS_REDUCE_BASE = 64.0  # reduce ns/plane-row, zone-A (aligned stage 3)
NS_S3FULL = 24.0  # extra ns/plane-row when stage 3 runs the 8-way select
NS_HOT_REGION = 10.0  # hot-kernel ns/plane-row in regular regions ...
NS_HOT_SWEEP = 45.0  # ... and under the emission sweep
NS_HOT_CAND = 7.0  # + per gather candidate (NH / 128)
NS_FIXED = 40e3  # per-SpMV fixed hybrid overhead (xh gather, adds)
# enable when the predicted net saving clears this fraction of the
# predicted baseline pipeline time
MIN_GAIN_FRAC = 0.04


@dataclass
class HotInfo:
    """Per-row captured elements (host side, pre-sort)."""

    hot_ids: np.ndarray  # (NH,) int32 hot column ids, frequency order
    hot_ptr: np.ndarray  # (nrows + 1,) int64
    hot_rank: np.ndarray  # (n_captured,) int16, rank asc within each row
    hot_val: np.ndarray  # (n_captured,) f32
    NH: int
    net: float  # predicted gain (ns) the gate saw


@dataclass
class HotPlanes:
    """Device-ready hot planes in the rest pack's segment order."""

    hidx: np.ndarray  # (8, S_hp, 128) int16 ranks into the hot table
    hvals: np.ndarray  # (8, S_hp, 128) f32
    hgcls: np.ndarray  # (S_hp // 8,) int32 gather class (1/2/4/8)
    hemit: np.ndarray  # (S_hp,) int32 emission codes (slice id % YB)
    ycall_rows: np.ndarray  # (n_calls, 2) int64 (start, rows)
    regions: np.ndarray  # (m, 5) int64 regular-width regions
    hot_ids: np.ndarray  # (NH,) int32
    nslices: int  # hot stream tiles Th
    NH: int
    ncand: int  # NH // 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pipeline_terms(lengths_desc, wtiles, split_len):
    """(stream tiles, padded plane rows, zone-A row coverage) estimate
    for a routed pack over segments with the given lengths.

    ``lengths_desc`` must be (approximately) descending: the caller sorts
    once by total length and reuses the order for every NH candidate
    (capture subtracts at most HCAP per row, so the rest lengths stay
    near-sorted).  wtiles: per-1024-column-window nnz histogram (the
    expand cuts tiles at window boundaries).  Splits are approximated by
    capping lengths at split_len and adding the overflow back as extra
    segments of split_len.
    """
    capped = np.minimum(lengths_desc, split_len)
    over = lengths_desc[lengths_desc > split_len]
    n_extra = int((-(-over // split_len) - 1).sum()) if over.size else 0
    tiles = int(np.ceil(np.maximum(wtiles, 0.0) / 1024.0).sum())
    srt = capped
    if n_extra:
        srt = np.concatenate(
            [np.full(n_extra, split_len, srt.dtype), srt]
        )
    pad = (-srt.shape[0]) % 1024
    if pad:
        srt = np.concatenate([srt, np.zeros(pad, srt.dtype)])
    by_slice = srt.reshape(-1, 1024)
    rows = int(by_slice.max(axis=1).sum() * 1.02)  # CH/region padding
    # zone-A coverage: a 128-segment group joins the lambda zone when its
    # longest segment reaches ZONE_MINLEN=8; its rows are the 8-slot-
    # rounded lambda widths
    g128_max = srt.reshape(-1, 128).max(axis=1)
    elig = g128_max >= 8
    zrows = int((-(-g128_max[elig] // 8)).sum())
    covA = min(1.0, zrows * 1.02 / max(rows, 1))
    return tiles, rows, covA


def plan_hot(
    csr,
    nh_candidates=(128, 256, 512, 1024),
    min_net: float | None = None,
):
    """Choose the hot-set size, or None when capture cannot pay.

    The gate is a time model with the NS_* constants: route passes scale
    with the 1024-rounded stream tile count, the reduce with padded plane
    rows and zone-A coverage (capture shortens rest segments and can
    collapse the lambda zone), and the hot reduce costs per-plane-row
    rates split by regular-region coverage.  Returns
    (NH, predicted_gain_ns) or None.
    """
    ncols = csr.shape[1]
    nnz = csr.nnz
    if nnz == 0 or ncols < 256:
        return None
    counts = np.bincount(csr.cols, minlength=ncols)
    nh_max = max(k for k in nh_candidates if k <= ncols)
    # top-NH sets are nested: one argpartition + a small sort of NH_max
    top = np.argpartition(-counts, nh_max - 1)[:nh_max]
    order = top[np.argsort(-counts[top], kind="stable")]
    n = csr.row_lengths
    mean_len = -(-max(nnz, 1) // max(csr.shape[0], 1))
    split_len = max(1024, 16 * mean_len)
    wtiles_all = np.bincount(
        (csr.cols >> 10).astype(np.int64), minlength=-(-ncols // 1024)
    ).astype(np.float64)
    # one length sort, reused for base, every rest estimate and the
    # hot-slot estimate (capture perturbs lengths by <= HCAP per row)
    n_order = np.argsort(-n, kind="stable")
    n_desc = n[n_order]
    t_old, r_old, cov_old = _pipeline_terms(n_desc, wtiles_all, split_len)
    T_old = _round_up(max(t_old, r_old), 1024)
    base_ns = T_old * NS_ROUTE_TILE + r_old * (
        NS_REDUCE_BASE + NS_S3FULL * (1 - cov_old)
    )
    rows_rep = csr.row_ids()
    rank_of = np.full(ncols, np.iinfo(np.int32).max, dtype=np.int32)
    rank_of[order] = np.arange(nh_max, dtype=np.int32)
    rank = rank_of[csr.cols]
    best = None
    for NH in nh_candidates:
        if NH > ncols:
            continue
        h = np.bincount(rows_rep[rank < NH], minlength=csr.shape[0])
        hc = np.minimum(np.minimum(h, np.maximum(n - 1, 0)), HCAP)
        capture = int(hc.sum())
        if capture == 0:
            continue
        # rest-side terms: captured nnz leave their column windows in
        # proportion to each hot column's reference count
        cap_frac = capture / max(int(h.sum()), 1)
        wtiles_new = wtiles_all.copy()
        np.subtract.at(
            wtiles_new,
            (order[:NH] >> 10).astype(np.int64),
            counts[order[:NH]] * cap_frac,
        )
        hc_d = hc[n_order]
        rest_d = n_desc - hc_d
        t_new, r_new, cov_new = _pipeline_terms(
            rest_d, wtiles_new, split_len
        )
        T_new = _round_up(max(t_new, r_new), 1024)
        rest_ns = T_new * NS_ROUTE_TILE + r_new * (
            NS_REDUCE_BASE + NS_S3FULL * (1 - cov_new)
        )

        # hot-side cost: quantized widths, exact region-run coverage
        def hot_cost(hs):
            pad = (-hs.shape[0]) % 1024
            if pad:
                hs = np.concatenate([hs, np.zeros(pad, hs.dtype)])
            w = hs.reshape(-1, 1024).max(axis=1)
            nzw = w > 0
            w[nzw] = 1 << np.ceil(np.log2(w[nzw])).astype(np.int64)
            cuts = np.flatnonzero(np.diff(w) != 0) + 1
            bounds = np.concatenate(([0], cuts, [w.shape[0]]))
            reg_rows = 0
            swp_rows = 0
            for b0, b1 in zip(bounds[:-1], bounds[1:]):
                ww = int(w[b0])
                nr = (b1 - b0) * ww
                if ww and ww <= 16 and nr >= 128:
                    reg_rows += nr
                else:
                    swp_rows += nr
            ncand = max(1, NH // 128)
            return (
                reg_rows * (NS_HOT_REGION + NS_HOT_CAND * ncand)
                + swp_rows * (NS_HOT_SWEEP + NS_HOT_CAND * ncand)
                + NS_FIXED
            )

        gain = base_ns - rest_ns - hot_cost(hc_d)
        thresh0 = (
            min_net if min_net is not None else MIN_GAIN_FRAC * base_ns
        )
        if gain < thresh0 and capture / nnz >= 0.15:
            # the cheap n-order estimate misjudges both sides when capture
            # is large and degrees are near-uniform (the real layout sorts
            # by REST length, which co-sorts the hot counts and shrinks
            # the rest slices); pay one exact sort to decide
            o2 = np.argsort(-(n - hc), kind="stable")
            rest_s = (n - hc)[o2]
            t2, r2, cov2 = _pipeline_terms(rest_s, wtiles_new, split_len)
            T2 = _round_up(max(t2, r2), 1024)
            rest_ns2 = T2 * NS_ROUTE_TILE + r2 * (
                NS_REDUCE_BASE + NS_S3FULL * (1 - cov2)
            )
            gain = base_ns - rest_ns2 - hot_cost(hc[o2])
        if best is None or gain > best[1]:
            best = (NH, gain)
    thresh = (
        min_net if min_net is not None else MIN_GAIN_FRAC * base_ns
    )
    if best is None or best[1] < thresh:
        return None
    return best  # (NH, predicted_gain_ns)


def capture_split(csr, NH: int, net: float = 0.0):
    """Split csr into (csr_rest, HotInfo).

    Captured = per row, the lowest-rank min(h, n-1, HCAP) hot elements
    (low ranks gather from the smallest candidate windows); within each
    row they are kept in rank-ascending order.
    """
    from cvr_tpu_torch.formats.csr import CSRMatrix

    ncols = csr.shape[1]
    counts = np.bincount(csr.cols, minlength=ncols)
    order = np.argsort(-counts, kind="stable")
    hot_ids = order[:NH].astype(np.int32)
    rank_of = np.full(ncols, -1, dtype=np.int32)
    rank_of[hot_ids] = np.arange(NH, dtype=np.int32)
    rank = rank_of[csr.cols]
    is_hot = rank >= 0
    rows_rep = csr.row_ids()
    n = csr.row_lengths
    h = np.bincount(rows_rep[is_hot], minlength=csr.shape[0])
    cap = np.minimum(np.minimum(h, np.maximum(n - 1, 0)), HCAP)

    hot_pos = np.flatnonzero(is_hot)
    hrows = rows_rep[hot_pos]
    # order hot elements by (row, rank) and keep the first cap[row]
    o = np.lexsort((rank[hot_pos], hrows))
    hot_pos = hot_pos[o]
    hrows = hrows[o]
    firsts = np.searchsorted(hrows, np.arange(csr.shape[0]))
    k_within = np.arange(hot_pos.shape[0], dtype=np.int64) - firsts[hrows]
    take = k_within < cap[hrows]
    cap_pos = hot_pos[take]  # captured nnz indices, (row, rank asc) order

    keep = np.ones(csr.nnz, dtype=bool)
    keep[cap_pos] = False
    rest_lens = n - cap
    rowptr_rest = np.zeros(csr.shape[0] + 1, dtype=np.int64)
    np.cumsum(rest_lens, out=rowptr_rest[1:])
    csr_rest = CSRMatrix(
        rowptr=rowptr_rest,
        cols=csr.cols[keep],
        vals=csr.vals[keep],
        shape=csr.shape,
    )
    hot_ptr = np.zeros(csr.shape[0] + 1, dtype=np.int64)
    np.cumsum(cap, out=hot_ptr[1:])
    return csr_rest, HotInfo(
        hot_ids=hot_ids,
        hot_ptr=hot_ptr,
        hot_rank=rank[cap_pos].astype(np.int16),
        hot_val=csr.vals[cap_pos].astype(np.float32),
        NH=NH,
        net=net,
    )


def build_hot_planes(sm, hi: HotInfo, YB: int, CH: int) -> HotPlanes:
    """Lay the captured elements into hot planes ordered by the REST
    pack's segment sort (sm = the rest SellMatrix).

    Hot slice t covers sorted positions [1024t, 1024(t+1)); row r's
    captured elements fill plane rows [slice_start, slice_start + h_r)
    of lane (first_pos[r] & 1023).  The emitted per-slice lane sums add
    directly into the routed y stream (flat position of segment g is g).
    """
    from cvr_tpu_torch.formats.sell_routed import _plan_layout

    nrows = sm.shape[0]
    seg_row = sm.perm.astype(np.int64)
    seg_off = sm.seg_offset.astype(np.int64)
    is_first = (seg_off == 0) & (seg_row < nrows)
    first_pos = np.full(nrows, -1, dtype=np.int64)
    first_pos[seg_row[is_first]] = np.flatnonzero(is_first)
    h = np.diff(hi.hot_ptr)
    rows_hot = np.flatnonzero(h > 0)
    if rows_hot.shape[0] == 0:
        raise ValueError("no captured elements")
    if (first_pos[rows_hot] < 0).any():
        raise AssertionError("captured row without a first segment")
    g = first_pos[rows_hot]
    Th = int(g.max() // 1024) + 1
    # per-tile widths, quantized to powers of two (<= HCAP) so runs of
    # equal width form regular regions and skip the emission sweep
    widths = np.zeros(Th, dtype=np.int64)
    np.maximum.at(widths, g // 1024, h[rows_hot])
    nzw = widths > 0
    widths[nzw] = 1 << np.ceil(np.log2(widths[nzw])).astype(np.int64)
    offs = np.zeros(Th + 1, dtype=np.int64)
    np.cumsum(widths, out=offs[1:])
    S = int(offs[-1])
    # region widths stop at 16, as the TPU's regular hot kernel requires
    rmap, ycall_rows, regions, S_padded = _plan_layout(
        offs, Th, S, YB, CH, region_widths=(1, 2, 4, 8, 16),
    )
    slice_start = rmap[offs[:-1]] if S else np.zeros(Th, dtype=np.int64)
    # elements in (row, rank-asc) order: row r's j-th captured element
    # sits at padded plane row slice_start[t] + j, lane g & 1023
    hr = np.repeat(rows_hot, h[rows_hot])
    j = np.arange(hr.shape[0], dtype=np.int64) - np.repeat(
        hi.hot_ptr[rows_hot], h[rows_hot]
    )
    gg = np.repeat(g, h[rows_hot])
    prow = slice_start[gg // 1024] + j
    lane = gg & 1023
    hidx = np.zeros((S_padded, 1024), dtype=np.int16)
    hvals = np.zeros((S_padded, 1024), dtype=np.float32)
    hidx[prow, lane] = hi.hot_rank
    hvals[prow, lane] = hi.hot_val
    hidx_ss = np.ascontiguousarray(
        hidx.reshape(S_padded, 8, 128).transpose(1, 0, 2)
    )
    hvals_ss = np.ascontiguousarray(
        hvals.reshape(S_padded, 8, 128).transpose(1, 0, 2)
    )
    # gather class per 8-plane-row group: candidates needed to cover the
    # group's max rank (the TPU kernel's dispatch; the port's kernel
    # indexes the hot table directly and does not read it)
    gmax = np.zeros(S_padded // 8, dtype=np.int64)
    np.maximum.at(gmax, prow // 8, hi.hot_rank.astype(np.int64))
    need = (gmax >> 7) + 1
    hgcls = np.where(
        need <= 1, 1, np.where(need <= 2, 2, np.where(need <= 4, 4, 8))
    ).astype(np.int32)
    # emission codes: the plane row ending slice t emits its local id
    hemit = np.full(S_padded, -1, dtype=np.int32)
    nz = widths > 0
    ends = offs[1:][nz] - 1
    hemit[rmap[ends]] = (np.flatnonzero(nz) % YB).astype(np.int32)
    return HotPlanes(
        hidx=hidx_ss,
        hvals=hvals_ss,
        hgcls=hgcls,
        hemit=hemit,
        ycall_rows=ycall_rows,
        regions=regions,
        hot_ids=hi.hot_ids,
        nslices=Th,
        NH=hi.NH,
        ncand=max(1, hi.NH // 128),
    )
