"""The redesigned K3 (reduce_slices) and K13 (lane_reduce) of the port
against their plain versions and the JAX package.

On the card both kernels cut every slice (K3) or slot (K13) into pieces of
at most P plane rows, planned on the host at upload (split_rows), sum the
pieces side by side and add a split item's partials in piece order in a
second pass; K3 gathers by one int32 index per plane element composed at
upload (reduce_index) in place of the p3 -> M3 -> m chain.  Here, with no
card: the piece tables cover every item's rows once, in order; the
composed index followed by a plain gather-multiply is
reduce_products_plain bit for bit; the kernels' order of summation,
emulated in torch (each piece's rows into kReduceUnroll accumulators for
K3 and one per output for K13, the accumulators added as the kernels add
them, the pieces' partials in piece order), stays within 1e-6 of the row
scale of the plain versions and of the JAX package (Pallas in interpret
mode); the wrappers refuse what the kernels' 32-bit indices cannot reach.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import cvr_tpu.ops.spmv_routed as jsr_mod
from cvr_tpu.formats.sell_routed import sell_pack_routed as j_pack_routed
from cvr_tpu.ops.spmm_lane import spmm_lane as j_spmm_lane
from cvr_tpu.ops.spmm_lane import spmm_lane_pack as j_spmm_lane_pack
from cvr_tpu.ops.spmm_lane import to_device_lane as j_to_device_lane

from cvr_tpu_torch.formats.sell_routed import from_reference
from cvr_tpu_torch.ops import kernels
from cvr_tpu_torch.ops import lane_kernels as lk
from cvr_tpu_torch.ops import route_kernels as rk
from cvr_tpu_torch.ops import spmm_lane
from cvr_tpu_torch.ops import spmv_routed as tsp
from test_torch_route_kernels import _capture_ysp
from test_torch_route_redesign import _dist_pack
from test_torch_spmm_kernels import _X, _close
from torch_cases import CASES, empty_blocks, powerlaw, rmat

K3_UNROLL = 4  # kReduceUnroll of csrc/route_kernels.cu


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launches()
    yield
    # CPU tensors: every wrapper ran its plain version
    assert not any(kernels.launches().values())


@functools.cache
def _routed(case):
    """(JAX pack, the port's device artifact on the CPU, x)."""
    make, split_len = CASES[case]
    jcoo, _ = make()
    sr = j_pack_routed(jcoo.to_csr(), split_len=split_len, hot="off")
    x = np.random.default_rng(5).standard_normal(jcoo.shape[1]).astype(np.float32)
    return sr, tsp.to_device_routed(from_reference(sr), "cpu"), x


def _pieces_of(row0, row1, out, split):
    """Each item's pieces, walked in table order: a list per item of
    (first row, end row, destination), checked against the combine
    table."""
    pieces = split.pieces.numpy().tolist()
    combine = split.combine.numpy().tolist()
    got, p, c = [], 0, 0
    for r0, r1, o in zip(row0.tolist(), row1.tolist(), out.tolist()):
        n = max(1, -(-(r1 - r0) // split.rows))
        mine = pieces[p : p + n]
        p += n
        if n > 1:
            c0, c1, co = combine[c]
            c += 1
            assert (c1 - c0, co) == (n, o)
            assert [d for _, _, d in mine] == [-1 - k for k in range(c0, c1)]
        else:
            assert mine[0][2] == o
        got.append(mine)
    assert p == len(pieces) and c == len(combine)
    return got


def _check_cover(row0, row1, out, split):
    """Every item's rows [row0, row1) covered once, in order, by pieces
    of at most split.rows rows; an empty item is one empty piece; the
    partials are numbered 0 .. npart-1 in piece order."""
    for r0, r1, mine in zip(row0.tolist(), row1.tolist(),
                            _pieces_of(row0, row1, out, split)):
        rows = [r for a, b, _ in mine for r in range(a, b)]
        assert rows == list(range(r0, r1))
        assert all(0 <= b - a <= split.rows for a, b, _ in mine)
        assert all(b > a for a, b, _ in mine) or (r0 == r1 and len(mine) == 1)
    dst = split.pieces[:, 2]
    np.testing.assert_array_equal(-1 - dst[dst < 0].numpy(),
                                  np.arange(split.npart))


def _k3_emulated(m, idx, vals, split, nys):
    """ys (8, nys, 128) summed as K3 sums on the card: each piece's rows
    into K3_UNROLL accumulators (row j of the unrolled body into
    accumulator j, the last rows % K3_UNROLL into the first), added as
    (a0 + a1) + (a2 + a3); a split slice's partials added in piece
    order."""
    mf = m.reshape(-1)
    ys = torch.zeros((8, nys, 128), dtype=torch.float32)
    part = torch.zeros((8, split.npart, 128), dtype=torch.float32)
    for r0, r1, dst in split.pieces.tolist():
        acc = [torch.zeros((8, 128), dtype=torch.float32)
               for _ in range(K3_UNROLL)]
        body = r0 + (r1 - r0) // K3_UNROLL * K3_UNROLL
        for R in range(r0, r1):
            u = (R - r0) % K3_UNROLL if R < body else 0
            acc[u] = acc[u] + vals[:, R] * mf[idx[:, R].long()]
        s = (acc[0] + acc[1]) + (acc[2] + acc[3])
        if dst >= 0:
            ys[:, dst] = s
        else:
            part[:, -1 - dst] = s
    for c0, c1, out in split.combine.tolist():
        s = part[:, c0]
        for c in range(c0 + 1, c1):
            s = s + part[:, c]
        ys[:, out] = s
    return ys


def _k13_emulated(cols, vals, split, X, nslots):
    """ys (nslots * 1024, K) summed as K13 sums on the card: each piece's
    rows in order into one accumulator per output; a split slot's
    partials added in piece order."""
    K = X.shape[1]
    c = cols.view(-1, 1024).long()
    ys = torch.zeros((nslots, 1024, K), dtype=torch.float32)
    part = torch.zeros((split.npart, 1024, K), dtype=torch.float32)
    for r0, r1, dst in split.pieces.tolist():
        acc = torch.zeros((1024, K), dtype=torch.float32)
        for r in range(r0, r1):
            acc = acc + vals[r][:, None] * X[c[r]]
        if dst >= 0:
            ys[dst] = acc
        else:
            part[-1 - dst] = acc
    for c0, c1, out in split.combine.tolist():
        s = part[c0]
        for j in range(c0 + 1, c1):
            s = s + part[j]
        ys[out] = s
    return ys.reshape(nslots * 1024, K)


def _within(got, want, scale):
    err = (got.double() - want.double()).abs()
    assert (err <= 1e-6 * scale.double() + 1e-30).all(), float(err.max())


# ---------------------------------------------------------------------------
# (a) the piece tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row0,row1,rows", [
    ([0, 5, 5, 9], [5, 5, 9, 130], 4),  # an empty item, a long one
    ([0], [1024], 32),  # one slice of a forced shard's width
    ([3, 40], [40, 41], 1),  # pieces of one row
    ([], [], 16),
])
def test_split_rows_covers_each_item_once(row0, row1, rows):
    out = np.arange(len(row0))[::-1].copy()
    t = [torch.tensor(a, dtype=torch.int32) for a in (row0, row1, out)]
    split = rk.make_split(*t, rows, "cpu")
    assert split.pieces.dtype == split.combine.dtype == torch.int32
    _check_cover(*t, split)
    # sizes differ by at most one row within an item
    for mine in _pieces_of(*t, split):
        sizes = [b - a for a, b, _ in mine]
        assert max(sizes) - min(sizes) <= 1


def test_split_rows_refuses_bad_ranges():
    with pytest.raises(ValueError, match="ends before"):
        rk.split_rows([5], [4], [0], 8)
    with pytest.raises(ValueError, match="pieces of 0 rows"):
        rk.split_rows([0], [4], [0], 0)


@pytest.mark.parametrize("case", ["powerlaw", "uniform_w16"])
def test_reduce_plan_covers_every_slice(case):
    """The routed artifact's K3 pieces at the default P and at P 3, which
    splits most slices here."""
    _, sd, _ = _routed(case)
    t = (sd.red_row0, sd.red_row1, sd.red_out)
    assert sd.red_plan.split.rows == rk.REDUCE_PIECE_ROWS
    _check_cover(*t, sd.red_plan.split)
    small = rk.make_split(*t, 3, "cpu")
    assert small.combine.shape[0] > 0
    _check_cover(*t, small)


def test_dist_shards_carry_split_reduce_plans():
    """Every shard of the forced 4-shard pack holds a slice wider than
    P rows; each shard's plan covers its slices, splits the wide one, and
    its composed index is reduce_index of the shard's planes."""
    dm = _dist_pack()
    for sd in dm.shards:
        t = (sd.red_row0, sd.red_row1, sd.red_out)
        width = int((sd.red_row1 - sd.red_row0).max())
        assert width > rk.REDUCE_PIECE_ROWS
        sp = sd.red_plan.split
        _check_cover(*t, sp)
        assert sp.combine.shape[0] > 0
        m3 = sd.mid.m3 if sd.mid.kind == "rec" else sd.mid.mid
        assert torch.equal(sd.red_plan.idx, rk.reduce_index(
            m3, sd.p3, sd.red_row0, sd.red_row1, sd.red_fast))


@functools.cache
def _lane_case(case):
    jcoo, tcoo, split_len = {
        "powerlaw": lambda: (*powerlaw(n=3000, avg_nnz=8, seed=1), None),
        "rmat_split16": lambda: (*rmat(11, 8, 5), 16),
        "empty_blocks": lambda: (*empty_blocks(), None),
    }[case]()
    jlp = j_spmm_lane_pack(jcoo.to_csr(), split_len=split_len)
    return jlp, tcoo, spmm_lane.to_device_lane(spmm_lane.from_reference(jlp),
                                               "cpu")


@pytest.mark.parametrize("case", ["powerlaw", "rmat_split16", "empty_blocks"])
def test_lane_split_covers_every_slot(case):
    """K13's pieces at the default P and at P 2; the slots no slice fills
    (the zero slot among them) are one empty piece each, writing their
    own block."""
    _, _, sd = _lane_case(case)
    nslots = sd.row0.shape[0]
    out = torch.arange(nslots, dtype=torch.int32)
    assert sd.split.rows == lk.LANE_PIECE_ROWS
    _check_cover(sd.row0, sd.row1, out, sd.split)
    small = rk.make_split(sd.row0, sd.row1, out, 2, "cpu")
    assert small.combine.shape[0] > 0
    _check_cover(sd.row0, sd.row1, out, small)
    empty = torch.nonzero(sd.row1 == sd.row0).flatten()
    assert int(empty[-1]) == nslots - 1  # the zero slot
    pieces = small.pieces
    for s in empty.tolist():
        (hit,) = torch.nonzero(pieces[:, 2] == s).flatten().tolist()
        assert pieces[hit, 0] == pieces[hit, 1]


# ---------------------------------------------------------------------------
# (b) K3's composed index
# ---------------------------------------------------------------------------


def _middle(sd, x):
    g1 = rk.expand(sd.w8, sd.gcls, sd.seg_blk, sd.li, torch.from_numpy(x),
                   sd.segw, sd.n_segs)
    return tsp.middle(sd, g1)


@pytest.mark.parametrize("fast", ["packed", "off"])
@pytest.mark.parametrize("case", ["powerlaw", "uniform_w16"])
def test_reduce_index_is_the_three_plane_chain(case, fast):
    """m at the composed index times vals equals reduce_products_plain bit
    for bit, with zone A's aligned stage 3 as packed and switched off."""
    _, sd, x = _routed(case)
    m, m3 = _middle(sd, x)
    fast_t = sd.red_fast if fast == "packed" else torch.zeros_like(sd.red_fast)
    if case == "uniform_w16" and fast == "packed":
        assert bool(fast_t.any())
    idx = rk.reduce_index(m3, sd.p3, sd.red_row0, sd.red_row1, fast_t)
    assert idx.dtype == torch.int32 and idx.shape == sd.p3.shape
    item, rows = rk.slice_rows(sd.red_row0, sd.red_row1)
    got = sd.vals_ss[:, rows, :] * m.reshape(-1)[idx[:, rows, :].long()]
    want = rk.reduce_products_plain(m, m3, sd.vals_ss, sd.p3, rows,
                                    fast_t.bool()[item])
    assert torch.equal(got, want)
    if fast == "packed":
        assert torch.equal(idx, sd.red_plan.idx)


# ---------------------------------------------------------------------------
# (c) the kernels' order of summation, emulated
# ---------------------------------------------------------------------------


@functools.cache
def _pallas_ysp(case):
    """The JAX package's y stream of _routed(case) (its reduce kernels in
    interpret mode), computed once per case."""
    sr, _, x = _routed(case)
    with pytest.MonkeyPatch.context() as mp:
        ysp, _ = _capture_ysp(mp, jsr_mod.to_device_routed(sr), x)
    return torch.from_numpy(np.array(ysp))


@functools.cache
def _pallas_spmm_lane(case, K):
    """The JAX package's spmm_lane of _lane_case(case) at _X(ncols, K),
    computed once per case and K."""
    jlp, tcoo, _ = _lane_case(case)
    return np.asarray(j_spmm_lane(j_to_device_lane(jlp), _X(tcoo.shape[1], K)))


@pytest.mark.parametrize("rows", [3, rk.REDUCE_PIECE_ROWS])
@pytest.mark.parametrize("case", ["powerlaw", "uniform_w16"])
def test_k3_split_sums_match_plain_and_pallas(case, rows):
    """K3's order (pieces of ``rows`` rows, K3_UNROLL accumulators,
    partials in piece order) against reduce_slices_plain and the JAX
    package's _reduce_m3_kernel / _reduce_m3_regular_kernel (interpret
    mode) through the zone-A fold, within 1e-6 of the row scale."""
    sr, sd, x = _routed(case)
    m, m3 = _middle(sd, x)
    split = rk.make_split(sd.red_row0, sd.red_row1, sd.red_out, rows, "cpu")
    ys = _k3_emulated(m, sd.red_plan.idx, sd.vals_ss, split, sd.nslices)
    want = tsp.reduce(sd, m, m3)
    abs_sd = dataclasses.replace(sd, vals_ss=sd.vals_ss.abs())
    scale = tsp.reduce(abs_sd, m.abs(), m3)
    _within(ys, want, scale)
    _within(tsp.y_stream(sd, ys), _pallas_ysp(case),
            tsp.y_stream(abs_sd, scale))


def test_k3_split_sums_on_a_forced_shard():
    """The forced pack's shard 0 (a slice of hundreds of plane rows, split
    at the default P) against its plain reduce."""
    dm = _dist_pack()
    sd = dm.shards[0]
    x = np.random.default_rng(2).standard_normal(dm.shape[1]).astype(np.float32)
    m, m3 = _middle(sd, x)
    ys = _k3_emulated(m, sd.red_plan.idx, sd.vals_ss, sd.red_plan.split,
                      sd.nslices)
    abs_sd = dataclasses.replace(sd, vals_ss=sd.vals_ss.abs())
    _within(ys, tsp.reduce(sd, m, m3), tsp.reduce(abs_sd, m.abs(), m3))


@pytest.mark.parametrize("K", [1, 17, 130])
@pytest.mark.parametrize("case,rows", [("powerlaw", 2), ("rmat_split16", 5),
                                       ("powerlaw", lk.LANE_PIECE_ROWS)])
def test_k13_split_sums_match_plain_and_spmm_lane(case, rows, K):
    """K13's order (pieces of ``rows`` rows, partials in piece order)
    against lane_reduce_plain within 1e-6 of the row scale, and, through
    spmm_lane's first-segment gather and extra scatter-add, against the
    JAX package's spmm_lane (its lane reduce kernel in interpret mode) at
    every K on rmat_split16 and at K 17 on powerlaw (one interpret-mode
    call of its 1,032 plane rows takes ~10 s)."""
    _, tcoo, sd = _lane_case(case)
    X = _X(tcoo.shape[1], K)
    Xt = torch.from_numpy(X)
    nslots = sd.row0.shape[0]
    split = rk.make_split(sd.row0, sd.row1, torch.arange(nslots), rows, "cpu")
    assert split.combine.shape[0] > 0
    ys = _k13_emulated(sd.cols_l, sd.vals_l, split, Xt, nslots)
    want = lk.lane_reduce_plain(sd.cols_l, sd.vals_l, sd.row0, sd.row1, Xt)
    scale = lk.lane_reduce_plain(sd.cols_l, sd.vals_l.abs(), sd.row0,
                                 sd.row1, Xt.abs())
    _within(ys, want, scale)
    assert not ys[-1024:].any()  # the zero slot
    if case == "rmat_split16" or K == 17:
        y = ys[sd.first_pos]
        y.index_add_(0, sd.extra_row, ys[sd.extra_pos])
        _close(y.numpy(), _pallas_spmm_lane(case, K), tcoo, X)


# ---------------------------------------------------------------------------
# (d) the wrappers refuse what 32-bit indices cannot reach
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S, TM, nys, npart", [
    (7168, 7168, 1119, 92),  # web-Google-like's shapes
    (2**21 - 1, 2**21 - 1, 2**21 - 1, 2**21 - 1),  # 8*rows*128 < 2^31
])
def test_reduce_geometry_takes(S, TM, nys, npart):
    rk.reduce_geometry(S, TM, nys, npart)


@pytest.mark.parametrize("S, TM, nys, npart, what", [
    (2**21, 1024, 8, 0, "planes"),
    (1024, 2**21, 8, 0, "mstream"),
    (1024, 1024, 2**21, 0, "ys"),
    (1024, 1024, 8, 2**21, "partials"),
])
def test_reduce_geometry_refuses(S, TM, nys, npart, what):
    with pytest.raises(ValueError, match=what):
        rk.reduce_geometry(S, TM, nys, npart)


def test_reduce_index_refuses_a_wide_mstream():
    m3 = torch.empty((8, 2**21, 128), dtype=torch.int16, device="meta")
    p3 = torch.zeros((8, 8, 128), dtype=torch.int16)
    t = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="32-bit"):
        rk.reduce_index(m3, p3, t, t + 8, t)


@pytest.mark.parametrize("S_lane, ncols, nslots, npart, K", [
    (6504, 1 << 20, 401, 82, 128),  # web-Google-like at K 128
    (2**21 - 1, 2**24 - 1, 2**14 - 1, 2**14 - 1, 128),
    (8, 1, 1, 0, 65535 * 32),
])
def test_lane_geometry_takes(S_lane, ncols, nslots, npart, K):
    lk.lane_geometry(S_lane, ncols, nslots, npart, K)


@pytest.mark.parametrize("S_lane, ncols, nslots, npart, K, what", [
    (2**21, 16, 2, 0, 1, "planes"),
    (8, 2**24, 2, 0, 128, "X"),
    (8, 16, 2**14, 0, 128, "ys"),
    (8, 16, 2, 2**14, 128, "partials"),
    (8, 1, 1, 0, 65535 * 32 + 1, "grid"),
])
def test_lane_geometry_refuses(S_lane, ncols, nslots, npart, K, what):
    with pytest.raises(ValueError, match=what):
        lk.lane_geometry(S_lane, ncols, nslots, npart, K)


@pytest.mark.parametrize("name", ["reduce_slices", "lane_reduce"])
def test_wrappers_take_no_plain_path_off_the_cpu(name):
    """Given tensors that are not on the CPU (meta tensors stand in for a
    card here), the wrappers raise: they never run the plain version."""
    def t(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    i32 = torch.int32
    if name == "reduce_slices":
        args = (t((8, 1024, 128)), t((8, 1024, 128), torch.int16),
                t((8, 8, 128)), t((8, 8, 128), torch.int16), t((1,), i32),
                t((1,), i32), t((1,), i32), t((1,), i32), 1)
        wrapper = rk.reduce_slices
    else:
        args = (t((1024,), i32), t((1, 1024)), t((2,), i32), t((2,), i32),
                t((64, 3)))
        wrapper = lk.lane_reduce
    with pytest.raises(ValueError, match=name):
        wrapper(*args)
