"""The redesigned K14 (pmm_spmm) and K10 (window_reduce) of the port
against their plain versions, the first designs' orders and the JAX
package.

On the card K14 reads each row's entries in column order (the plan's
element slots reordered by row at upload, pads dropped: pmm_entries) and
a work plan made at upload (pmm_work): rows cut into segments of at most
PMM_PIECE entries, grouped into units of at most PMM_UNIT_ROWS segments;
each segment is one fmaf chain from 0 over its entries, and a split row's
partials are added in piece order by a second launch.  K10 computes each
plane row's window arithmetic once (divmod of w10 * 8 by the grid's rows,
then one wrap per element) and sums each output in plane-row order.
Here, with no card: the upload holds every entry once, each row in column
order; the work units cover every row once, in order; the kernels'
orders, emulated in torch (each sum one chain of additions in the
kernel's order), equal the first designs' orders bit for bit where they
are the same order (K14 without split rows) and stay within 1e-6 of the
row scale of the plain versions and of the JAX package (Pallas in
interpret mode, as tests/test_torch_spmm_kernels.py and
tests/test_torch_format_kernels.py run it); K10's per-row arithmetic
equals the divmod formula of window_columns bit for bit; the wrappers
refuse what the kernels' 32-bit indices cannot reach.
"""

import functools

import numpy as np
import pytest
import torch

import cvr_tpu.ops.pallas_window as jpw
import cvr_tpu.ops.spmm_pmm as jpmm
from cvr_tpu.formats.sell_window import sell_pack_window as j_pack_window

import cvr_tpu_torch.ops.route_planes as tpr
from cvr_tpu_torch.formats.sell_window import sell_pack_window
from cvr_tpu_torch.ops import kernels
from cvr_tpu_torch.ops import pmm_kernels as pk
from cvr_tpu_torch.ops import spmm_pmm
from cvr_tpu_torch.ops import window_kernels as wk
from cvr_tpu_torch.ops.spmv_window import reduce_args, to_device_window
from test_torch_format_kernels import _window_reference
from test_torch_spmm_kernels import _X, _close
from torch_cases import (
    WINDOW_CASES,
    empty_blocks,
    fsm,
    pair,
    powerlaw,
    random_rect,
)

PMM_KS = (8, 17, 32, 130)


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launches()
    yield
    # CPU tensors: every wrapper ran its plain version
    assert not any(kernels.launches().values())


def _within(got, want, scale):
    err = (got.double() - want.double()).abs()
    assert (err <= 1e-6 * scale.double() + 1e-30).all(), float(err.max())


# ---------------------------------------------------------------------------
# K14: the upload, the work plan, the order of summation
# ---------------------------------------------------------------------------


def fsm_long_rows(seed=8):
    """fsm(n=4096) with rows 5, 700 and 3000 given 300, 1,000 and 130
    entries at random columns: rows that K14 cuts into pieces."""
    jcoo, _ = fsm(n=1 << 12)
    rng = np.random.default_rng(seed)
    rows, cols, vals = [jcoo.rows], [jcoo.cols], [jcoo.vals]
    for r, n in ((5, 300), (700, 1000), (3000, 130)):
        rows.append(np.full(n, r, dtype=np.int32))
        cols.append(rng.choice(jcoo.shape[1], n, replace=False).astype(
            np.int32))
        vals.append(rng.standard_normal(n).astype(np.float32))
    j, t = pair(np.concatenate(rows), np.concatenate(cols),
                np.concatenate(vals), jcoo.shape)
    return j.sum_duplicates(), t.sum_duplicates()


PMM_CASES = {
    "fsm": lambda: fsm(n=1 << 12),
    "fsm_long_rows": fsm_long_rows,
    "powerlaw": lambda: powerlaw(n=3000),
    "random_rect": lambda: random_rect(700, 900, 0.01),
    "empty_blocks": empty_blocks,
}


@functools.cache
def _pmm(case):
    """(JAX plan, the port's COO, the port's device artifact on the CPU),
    built once per case."""
    jcoo, tcoo = PMM_CASES[case]()
    jplan = jpmm.pmm_plan(jcoo.rows, jcoo.cols, jcoo.vals, jcoo.shape)
    dev = spmm_pmm.to_device_pmm(spmm_pmm.from_reference(jplan), "cpu")
    return jplan, tcoo, dev


@functools.cache
def _pallas_pmm(case, K):
    """The JAX package's spmm_pmm of _pmm(case) at _X(ncols, K), its
    kernel in interpret mode with 512 pairs a call, once per case and K."""
    jplan, tcoo, _ = _pmm(case)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpmm, "SEG", 512)
        return np.asarray(jpmm.spmm_pmm(jpmm.to_device_pmm(jplan),
                                        _X(tcoo.shape[1], K)))


def _slots(plan):
    """The first design's upload of the plan: each element slot's column
    (-1 on pads), value, row within its tile and row tile."""
    p, e = np.nonzero(plan.lc != spmm_pmm.LC_SENTINEL)
    col = np.full(plan.nchunks * 128, -1, dtype=np.int64)
    col[plan.ch[p].astype(np.int64) * 128 + e] = (
        plan.win[p].astype(np.int64) * 128 + plan.lc[p, e])
    chunk_rt = np.zeros(plan.nchunks, dtype=np.int64)
    chunk_rt[plan.ch] = plan.rt
    return (torch.from_numpy(col), torch.from_numpy(plan.val.reshape(-1)),
            torch.from_numpy(plan.rl.reshape(-1).astype(np.int64)),
            torch.from_numpy(np.repeat(chunk_rt, 128)))


def _slot_plain(plan, X, nrows):
    """The first design's plain version: every slot with col >= 0 adds
    val * X[col] into row 128 * tile + rl, by one index_add_."""
    col, val, rl, tile = _slots(plan)
    m = col >= 0
    Y = torch.zeros((plan.nrt * 128, X.shape[1]), dtype=torch.float32)
    Y.index_add_(0, (tile * 128 + rl)[m], val[m][:, None] * X[col[m]])
    return Y[:nrows]


def _slot_walk(plan, X, nrows):
    """Y summed as the first design's kernel summed it: one accumulator
    per output, each row tile's slots walked in slot order (pads add
    nothing)."""
    col, val, rl, tile = _slots(plan)
    first = torch.searchsorted(tile, tile)  # a slot's tile's first slot
    pos = torch.arange(tile.shape[0]) - first
    Y = torch.zeros((plan.nrt * 128, X.shape[1]), dtype=torch.float32)
    for p in range(int(pos.max()) + 1 if pos.numel() else 0):
        s = (pos == p) & (col >= 0)  # one slot a tile: distinct rows
        r = tile[s] * 128 + rl[s]
        Y[r] = Y[r] + val[s][:, None] * X[col[s]]
    return Y[:nrows]


def _segment_dst(work):
    """Each segment's destination (row >= 0, or -1 - partial) from the
    units."""
    dst = torch.empty(work.segptr.shape[0] - 1, dtype=torch.int64)
    for s0, s1, d0 in work.units.tolist():
        j = torch.arange(s1 - s0)
        dst[s0:s1] = d0 + j if d0 >= 0 else d0 - j
    return dst


def _k14_emulated(col, val, work, X, nrows):
    """Y summed as K14 sums on the card: each segment one chain from 0 over
    its entries in order; a split row's partials added in piece order."""
    seg = work.segptr.long()
    start, lens = seg[:-1], seg[1:] - seg[:-1]
    acc = torch.zeros((lens.shape[0], X.shape[1]), dtype=torch.float32)
    for j in range(int(lens.max()) if lens.numel() else 0):
        s = lens > j
        e = start[s] + j
        acc[s] = acc[s] + val[e][:, None] * X[col[e].long()]
    dst = _segment_dst(work)
    Y = torch.zeros((nrows, X.shape[1]), dtype=torch.float32)
    part = torch.zeros((work.npart, X.shape[1]), dtype=torch.float32)
    Y[dst[dst >= 0]] = acc[dst >= 0]
    part[-1 - dst[dst < 0]] = acc[dst < 0]
    for c0, c1, out in work.combine.tolist():
        s = part[c0]
        for c in range(c0 + 1, c1):
            s = s + part[c]
        Y[out] = s
    return Y


@pytest.mark.parametrize("case", list(PMM_CASES))
def test_pmm_upload_holds_each_entry_once_in_column_order(case):
    """Every stored entry of the plan once, row by row, each row's entries
    in column order, no pad: the matrix's canonical CSR, array for
    array."""
    jplan, tcoo, dev = _pmm(case)
    csr = tcoo.to_csr()
    assert dev.col.dtype == dev.rowptr.dtype == torch.int32
    assert dev.col.shape == (jplan.nnz,) == (csr.nnz,)
    np.testing.assert_array_equal(dev.rowptr.numpy(), csr.rowptr)
    np.testing.assert_array_equal(dev.col.numpy(), csr.cols)
    np.testing.assert_array_equal(dev.val.numpy(), csr.vals)


def _check_work(rowptr, work):
    """The segments cover every row once and in order: a row of at most
    ``piece`` entries is one segment writing its row, a longer one
    consecutive pieces of at most ``piece`` entries whose partials the
    combine table adds, in piece order, into its row; every unit holds
    at most PMM_UNIT_ROWS segments, all starting within one block of
    PMM_UNIT_ENTRIES entries."""
    rp = rowptr.tolist()
    seg = work.segptr.tolist()
    dst = _segment_dst(work).tolist()
    combine = {out: (c0, c1) for c0, c1, out in work.combine.tolist()}
    s = 0
    for r in range(len(rp) - 1):
        if r in combine:
            c0, c1 = combine[r]
            mine = range(s, s + c1 - c0)
            assert [dst[k] for k in mine] == [-1 - c for c in range(c0, c1)]
        else:
            mine = range(s, s + 1)
            assert dst[s] == r
        bounds = [seg[k] for k in mine] + [seg[mine[-1] + 1]]
        assert bounds[0] == rp[r] and bounds[-1] == rp[r + 1]
        sizes = [b - a for a, b in zip(bounds, bounds[1:])]
        assert all(0 <= n <= work.piece for n in sizes)
        assert all(n > 0 for n in sizes) or len(mine) == 1
        s = mine[-1] + 1
    assert s == len(seg) - 1
    assert sorted(-1 - d for d in dst if d < 0) == list(range(work.npart))
    units = work.units.tolist()
    assert [u[0] for u in units[1:]] == [u[1] for u in units[:-1]]
    assert (units[0][0] if units else 0) == 0
    assert (units[-1][1] if units else 0) == len(seg) - 1
    for s0, s1, _ in units:
        assert 0 < s1 - s0 <= pk.PMM_UNIT_ROWS
        assert len({seg[k] // pk.PMM_UNIT_ENTRIES for k in range(s0, s1)}) == 1


@pytest.mark.parametrize("piece", [3, pk.PMM_PIECE])
@pytest.mark.parametrize("case", list(PMM_CASES))
def test_pmm_work_covers_every_row_in_order(case, piece):
    """The upload's plan (PMM_PIECE), and one of pieces of 3 entries,
    which splits most rows here."""
    _, _, dev = _pmm(case)
    work = dev.work if piece == pk.PMM_PIECE else pk.pmm_work(dev.rowptr,
                                                              piece)
    assert work.piece == piece
    for t in (work.segptr, work.units, work.combine):
        assert t.dtype == torch.int32
    _check_work(dev.rowptr, work)
    longest = int((dev.rowptr[1:] - dev.rowptr[:-1]).max())
    assert (work.combine.shape[0] > 0) == (longest > piece)


def test_pmm_work_of_empty_and_short_tables():
    """No rows; empty rows only (one empty segment each); one row of
    exactly ``piece`` entries (one segment) and one of piece + 1 (two)."""
    for rowptr in ([0], [0, 0, 0], [0, 64, 129]):
        work = pk.pmm_work(torch.tensor(rowptr, dtype=torch.int32))
        _check_work(torch.tensor(rowptr), work)
    assert work.combine.tolist() == [[0, 2, 1]]


@pytest.mark.parametrize("K", PMM_KS)
@pytest.mark.parametrize("case", ["fsm", "fsm_long_rows", "powerlaw"])
def test_pmm_plain_matches_first_design_and_spmm_pmm(case, K):
    """pmm_spmm_plain (the wrapper on CPU tensors) against the first
    design's index-add form and the JAX package's spmm_pmm (Pallas in
    interpret mode), within 1e-6 of the row scale |A| @ |X|."""
    jplan, tcoo, dev = _pmm(case)
    X = _X(tcoo.shape[1], K)
    Xt = torch.from_numpy(X)
    got = pk.pmm_spmm(*spmm_pmm.kernel_args(dev, Xt))
    assert torch.equal(got, spmm_pmm.spmm_pmm(dev, Xt))
    _close(got.numpy(), _slot_plain(jplan, Xt, tcoo.shape[0]).numpy(), tcoo,
           X)
    _close(got.numpy(), _pallas_pmm(case, K), tcoo, X)


@pytest.mark.parametrize("K", PMM_KS)
@pytest.mark.parametrize("case", ["fsm", "random_rect", "empty_blocks"])
def test_k14_order_is_the_first_designs_bit_for_bit(case, K):
    """With no row split, K14's order (one chain per row over its entries
    in column order) is the first design's slot walk restricted to each
    row: the emulations agree bit for bit, and both lie within 1e-6 of
    the row scale of the plain version."""
    jplan, tcoo, dev = _pmm(case)
    assert dev.work.combine.shape[0] == 0
    Xt = torch.from_numpy(_X(tcoo.shape[1], K))
    got = _k14_emulated(dev.col, dev.val, dev.work, Xt, tcoo.shape[0])
    assert torch.equal(got, _slot_walk(jplan, Xt, tcoo.shape[0]))
    _close(got.numpy(), pk.pmm_spmm_plain(dev.col, dev.val, dev.rowptr,
                                          Xt).numpy(), tcoo, Xt.numpy())


@pytest.mark.parametrize("K", PMM_KS)
@pytest.mark.parametrize("case,piece", [("fsm_long_rows", pk.PMM_PIECE),
                                        ("powerlaw", pk.PMM_PIECE),
                                        ("fsm", 3)])
def test_k14_split_sums_match_plain_and_spmm_pmm(case, piece, K):
    """K14's order with split rows (pieces' partials added in piece order)
    against pmm_spmm_plain and the JAX package's spmm_pmm, within 1e-6 of
    the row scale."""
    _, tcoo, dev = _pmm(case)
    work = pk.pmm_work(dev.rowptr, piece)
    assert work.combine.shape[0] > 0
    X = _X(tcoo.shape[1], K)
    Xt = torch.from_numpy(X)
    got = _k14_emulated(dev.col, dev.val, work, Xt, tcoo.shape[0]).numpy()
    _close(got, pk.pmm_spmm_plain(dev.col, dev.val, dev.rowptr, Xt).numpy(),
           tcoo, X)
    _close(got, _pallas_pmm(case, K), tcoo, X)


@pytest.mark.parametrize("nnz, nrows, ncols, npart, K", [
    (16_524_173, 1 << 21, 1 << 21, 0, 32),  # fsm-like at K 32
    (2**31 - 1, 2**24 - 1, 2**24 - 1, 2**24 - 1, 128),
    (8, 1, 1, 0, 65535 * 8),
])
def test_pmm_geometry_takes(nnz, nrows, ncols, npart, K):
    pk.pmm_geometry(nnz, nrows, ncols, npart, K)


@pytest.mark.parametrize("nnz, nrows, ncols, npart, K, what", [
    (2**31, 8, 8, 0, 1, "entries"),
    (8, 8, 2**24, 0, 128, "X"),
    (8, 2**24, 8, 0, 128, "Y"),
    (8, 8, 8, 2**24, 128, "partials"),
    (8, 1, 1, 0, 65535 * 8 + 1, "grid"),
])
def test_pmm_geometry_refuses(nnz, nrows, ncols, npart, K, what):
    with pytest.raises(ValueError, match=what):
        pk.pmm_geometry(nnz, nrows, ncols, npart, K)


# ---------------------------------------------------------------------------
# K10: the per-row window arithmetic, the order of summation
# ---------------------------------------------------------------------------


def _window_rows(li, w10, seg_blk, rows, segw, G, wrl, ncols):
    """(col, valid) as K10 computes them: per plane row (g0, rr0) =
    divmod(w10 * 8, 8*(segw + 2)), base = seg_blk*segw*8 + g0*(8 // G) +
    rr0 and wrap = 8*(segw + 2) - rr0; per element x row = base + hi,
    less 8*(segw + 2) - 8 // G where hi >= wrap."""
    grid_rows, shift = 8 * (segw + 2), 8 // G
    t = w10[rows].long() * 8
    g0 = t // grid_rows
    rr0 = t - g0 * grid_rows
    base = (seg_blk[rows // tpr.CH].long() * segw * 8 + g0 * shift
            + rr0).view(1, -1, 1)
    wrap = (grid_rows - rr0).view(1, -1, 1)
    idx = li[:, rows, :].long()
    hi = idx >> 7
    xrow = base + hi + torch.where(hi >= wrap, shift - grid_rows, 0)
    col = xrow * 128 + (idx & 127)
    return col, (hi < wrl) & (col < ncols)


def _same_columns(li, w10, seg_blk, rows, segw, G, wrl, ncols):
    got, ok = _window_rows(li, w10, seg_blk, rows, segw, G, wrl, ncols)
    want, valid = wk.window_columns(li, w10, seg_blk, rows, segw, G, wrl,
                                    ncols)
    assert torch.equal(ok, valid)
    assert torch.equal(got[ok], want[valid])
    return int(ok.sum())


@functools.cache
def _window(case):
    """(the port's device artifact on the CPU, x), once per case."""
    make, segw = WINDOW_CASES[case]
    _, tcoo = make()
    kw = {} if segw is None else {"segw": segw}
    sd = to_device_window(sell_pack_window(tcoo.to_csr(), **kw), "cpu")
    x = np.random.default_rng(7).standard_normal(tcoo.shape[1]).astype(
        np.float32)
    return sd, x


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_k10_row_arithmetic_is_the_divmod_formula(case):
    """On each pack's own planes, over every plane row."""
    sd, x = _window(case)
    rows = torch.arange(sd.w10.shape[0])
    assert _same_columns(sd.li, sd.w10, sd.seg_blk, rows, sd.segw, sd.G,
                         sd.wrl, x.shape[0]) > 0


@pytest.mark.parametrize("segw,G,wrl", [(1, 4, 16), (2, 1, 12), (128, 4, 16),
                                        (128, 2, 9)])
def test_k10_row_arithmetic_wraps_into_the_next_grid(segw, G, wrl):
    """Random windows anywhere in their grids and every hi below wrl (a
    window of 2048 columns reaches wrl up to 16): rr0 + hi crosses into
    the next grid where rr0 lies in its grid's last 8 rows and hi >= 8,
    which the packs' own windows never reach."""
    rng = np.random.default_rng(segw + G)
    S = 4 * 128
    grid_rows = 8 * (segw + 2)
    w10 = torch.from_numpy(rng.integers(0, G * (segw + 2), S).astype(np.int32))
    seg_blk = torch.from_numpy(rng.integers(0, 3, S // tpr.CH).astype(
        np.int32))
    li = torch.from_numpy(rng.integers(0, wrl * 128, (8, S, 128)).astype(
        np.int16))
    rows = torch.arange(S)
    wraps = (w10.long() * 8 % grid_rows).view(1, -1, 1) + (
        li.long() >> 7) >= grid_rows
    assert bool(wraps.any())
    assert _same_columns(li, w10, seg_blk, rows, segw, G, wrl, 1 << 30) == (
        li.numel())


def _k10_emulated(li, vals, w10, seg_blk, x, row0, row1, out, nys, segw, G,
                  wrl):
    """ys (8, nys, 128) summed as K10 sums on the card: one accumulator per
    output, its slice's plane rows added in row order."""
    S = vals.shape[1]
    P = wk.window_products_plain(li, vals, w10, seg_blk, x, torch.arange(S),
                                 segw, G, wrl)
    r0, lens = row0.long(), (row1 - row0).long()
    acc = torch.zeros((8, r0.shape[0], 128), dtype=torch.float32)
    for j in range(int(lens.max()) if lens.numel() else 0):
        s = lens > j
        acc[:, s] = acc[:, s] + P[:, r0[s] + j]
    ys = torch.zeros((8, nys, 128), dtype=torch.float32)
    ys[:, out.long()] = acc
    return ys


@pytest.mark.parametrize("case,yb", [
    ("banded_D2_wrl7", 512),
    ("W2048_wrl15", 512),
    ("segw2", 512),
    ("rectangular", 512),
    ("empty_rows", 2),
])
def test_k10_order_matches_plain_and_pallas(case, yb, monkeypatch):
    """K10's order against window_reduce_plain and the JAX package's
    window_reduce (Pallas in interpret mode, one call per reduce group),
    within 1e-6 of the row scale; YB 2 gives empty_rows zero-width slices
    and reduce groups over several reduce calls."""
    monkeypatch.setattr(jpw, "YB", yb)
    monkeypatch.setattr(tpr, "YB", yb)
    make, segw = WINDOW_CASES[case]
    jcoo, tcoo = make()
    kw = {} if segw is None else {"segw": segw}
    jsw = j_pack_window(jcoo.to_csr(), **kw)
    sd = to_device_window(sell_pack_window(tcoo.to_csr(), **kw), "cpu")
    x = np.random.default_rng(7).standard_normal(tcoo.shape[1]).astype(
        np.float32)
    args = reduce_args(sd, torch.from_numpy(x))
    li, vals, w10, seg_blk, xt, *rest = args
    got = _k10_emulated(*args)
    scale = wk.window_reduce_plain(li, vals.abs(), w10, seg_blk, xt.abs(),
                                   *rest)
    _within(got, wk.window_reduce(*args), scale)
    _within(got, torch.from_numpy(_window_reference(jsw, x)), scale)


def test_k10_order_on_fem_like():
    """fem-like's shape (D 2, 54 entries a row within 150) against the
    plain version."""
    sd, x = _window("fem_D2")
    args = reduce_args(sd, torch.from_numpy(x))
    li, vals, w10, seg_blk, xt, *rest = args
    scale = wk.window_reduce_plain(li, vals.abs(), w10, seg_blk, xt.abs(),
                                   *rest)
    _within(_k10_emulated(*args), wk.window_reduce_plain(*args), scale)


@pytest.mark.parametrize("S, nys, ncols, segw, G, wrl", [
    (55936, 2048, 1 << 20, 128, 4, 8),  # fem-like's shapes
    (2**21 - 1, 2**21 - 1, 2**31 - 1, 1, 1, 24),
])
def test_window_geometry_takes(S, nys, ncols, segw, G, wrl):
    wk.window_geometry(S, nys, ncols, segw, G, wrl)


@pytest.mark.parametrize("S, nys, ncols, segw, G, wrl, what", [
    (2**21, 8, 8, 128, 4, 8, "planes"),
    (8, 2**21, 8, 128, 4, 8, "ys"),
    (8, 8, 2**31, 128, 4, 8, "x"),
    (8, 8, 8, 128, 3, 8, "G 3"),
    (8, 8, 8, 1, 4, 25, "wrl 25"),
])
def test_window_geometry_refuses(S, nys, ncols, segw, G, wrl, what):
    with pytest.raises(ValueError, match=what):
        wk.window_geometry(S, nys, ncols, segw, G, wrl)


@pytest.mark.parametrize("name", ["window_reduce", "pmm_spmm"])
def test_wrappers_take_no_plain_path_off_the_cpu(name):
    """Given tensors that are not on the CPU (meta tensors stand in for a
    card here), the wrappers raise: they never run the plain version."""
    def t(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    i32 = torch.int32
    if name == "window_reduce":
        args = (t((8, 128, 128), torch.int16), t((8, 128, 128)),
                t((128,), i32), t((1,), i32), t((300,)), t((1,), i32),
                t((1,), i32), t((1,), i32), 1, 1, 4, 8)
        wrapper = wk.window_reduce
    else:
        args = (t((8,), i32), t((8,)), t((3,), i32), t((64, 3)))
        wrapper = pk.pmm_spmm
    with pytest.raises(ValueError, match=name):
        wrapper(*args)
    assert wrapper.launches == 0
