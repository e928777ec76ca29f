"""The routed SpMM over tiles of columns: K3w (reduce_slices_cols), the
glue on a trailing column dimension and K4w (route_small_cols) against
the routed SpMV run once per column, bit for bit.

spmm_routed runs a tile of up to 8 columns of X through one pass over the
planes and writes the tile's columns of one (nrows, K) Y.  Each column's
sums are K3's, in K3's order, so Y equals the per-column SpMVs stacked:
here on the CPU by the plain versions, on a card by the kernels (those
cases skip without one).  Covered: zone A, hot planes (rmat15_hot512 as
chip_smoke.py packs it), split-row extras (several into one row) and the
row mask (a forced 4-shard pack's shard), split slices; ragged tiles (K 3,
9) and two tiles (K 16); K 1 through the SpMV; the wrappers' refusals.

This file imports nothing of JAX, so that its card cases run where the
JAX package is not installed:
``python -m pytest --noconftest -q tests/test_torch_spmm_routed_cols.py``.
"""

import functools
import types

import numpy as np
import pytest
import torch

from cvr_tpu_torch.bench import synthetic as tsyn
from cvr_tpu_torch.formats.coo import COOMatrix
from cvr_tpu_torch.formats.sell_routed import sell_pack_routed
from cvr_tpu_torch.ops import kernels
from cvr_tpu_torch.ops import route_kernels as rk
from cvr_tpu_torch.ops import spmv_routed as sp
from cvr_tpu_torch.parallel import dist as tdist
from cvr_tpu_torch.parallel import dist_routed as tdr
from cvr_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)  # one per test worker, as tests/torch_cases.py


def _powerlaw(n=3000, avg_nnz=6, alpha=1.8, seed=2):
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(alpha, size=n), n)
    deg = np.minimum((deg * (avg_nnz / deg.mean())).astype(np.int64), n)
    rows = np.repeat(np.arange(n, dtype=np.int32), deg)
    cols = rng.integers(0, n, size=rows.shape[0]).astype(np.int32)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return COOMatrix(rows=rows, cols=cols, vals=vals,
                     shape=(n, n)).sum_duplicates()


# name -> (matrix, split_len, hot-plane switches, what the pack must hold);
# dist_shard is shard 1 of a forced 4-shard pack of the power-law matrix
CASES = {
    "uniform_w16": (tsyn.uniform_rows, None, {},
                    lambda sd: sd.nslA > 0),
    "rmat15_hot512": (lambda: tsyn.rmat_matrix(15, 8, seed=5, cache=False),
                      None, {"CVR_HOT": "1", "CVR_HOT_NH": "512"},
                      lambda sd: sd.hot_nslices > 0 and sd.nslA > 0),
    "empty_rows_cols": (tsyn.empty_rows_cols, 16, {},
                        lambda sd: sd.extra_src.shape[0] > 0
                        and sd.ymask.shape[0] > 0),
    "powerlaw": (_powerlaw, None, {},
                 lambda sd: sd.red_plan.split.combine.shape[0] > 0
                 and sd.extra_src.shape[0] > 0),
    # rows split into many segments: several extras add into one row
    "rmat_split16": (lambda: tsyn.rmat_matrix(10, 12, seed=5, cache=False),
                     16, {}, lambda sd: torch.unique(sd.extra_row).numel()
                     < sd.extra_row.numel()),
    "dist_shard": (lambda: _powerlaw(seed=3), None, {},
                   lambda sd: sd.ymask.shape[0] > 0),
}
WIDTHS = (2, 3, 8, 9, 16)


@functools.cache
def _upload(case, device):
    """(the case's COO, its routed device artifact on ``device``)."""
    make, split_len, env, _ = CASES[case]
    coo = make()
    if case == "dist_shard":
        dm = tdr.dist_routed_pack(coo.to_csr(), tdist.make_mesh(
            devices=[device] * 4))
        return coo, dm.shards[1]
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        sr = sell_pack_routed(coo.to_csr(), split_len=split_len,
                              hot="auto" if env else "off")
    return coo, sp.to_device_routed(sr, device)


def _X(ncols, K, seed=1):
    X = np.random.default_rng(seed).standard_normal((ncols, K))
    return torch.from_numpy(X.astype(np.float32))


def _bits(t):
    """A float tensor's bits: NaN payloads compared too."""
    return t.contiguous().view(torch.int32).cpu()


def _per_column(sd, X):
    return torch.stack([sp.spmv_routed(sd, X[:, k])
                        for k in range(X.shape[1])], 1)


@pytest.mark.parametrize("K", WIDTHS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_spmm_equals_spmv_per_column(case, K):
    """Y of the wide chain equals the routed SpMV per column, stacked, bit
    for bit, on packs with zone A, hot planes, extras, a row mask and
    split slices."""
    coo, sd = _upload(case, "cpu")
    assert CASES[case][3](sd)
    X = _X(coo.shape[1], K, seed=K)
    Y = sp.spmm_routed(sd, X)
    assert Y.shape == (sd.yroute.n, K)  # a shard's rows
    assert torch.equal(_bits(Y), _bits(_per_column(sd, X)))
    assert bool(Y.any())


@pytest.mark.parametrize("case", ["rmat15_hot512", "dist_shard"])
def test_spmm_reads_x_in_place(case):
    """X a column slice of a wider tensor (rows 13 floats apart) and X
    transposed (columns apart): the same Y, bit for bit."""
    coo, sd = _upload(case, "cpu")
    wide = _X(coo.shape[1], 13, seed=5)
    X = wide[:, 2:11]
    want = _per_column(sd, X.contiguous())
    assert torch.equal(_bits(sp.spmm_routed(sd, X)), _bits(want))
    Xt = X.t().contiguous().t()  # columns side by side no more
    assert torch.equal(_bits(sp.spmm_routed(sd, Xt)), _bits(want))


def test_spmm_copies_tiles_past_32_bits(monkeypatch):
    """Where X or Y lies past the kernels' 32-bit reach, each tile's
    columns of X are copied out and its Y written apart, then put into
    place: the same Y, bit for bit (the reach made small here)."""
    coo, sd = _upload("powerlaw", "cpu")
    X = _X(coo.shape[1], 13, seed=5)[:, 2:12]
    want = _per_column(sd, X.contiguous())
    seen = []
    small = types.SimpleNamespace(**vars(rk))
    small.INT32_MAX = 1000

    def reduce(Xt, *args):
        seen.append((Xt.is_contiguous(), Xt.shape[1]))
        return rk.reduce_slices_cols(Xt, *args)

    small.reduce_slices_cols = reduce
    monkeypatch.setattr(sp, "rk", small)
    assert torch.equal(_bits(sp.spmm_routed(sd, X)), _bits(want))
    assert seen == [(True, 8), (True, 2)]


def test_tile_sums_equal_k3_a_column():
    """K3w's ys: column c equals K3's ys of that column, bit for bit, in
    every tile width."""
    coo, sd = _upload("powerlaw", "cpu")
    for K in range(1, rk.COLS_TILE + 1):
        X = _X(coo.shape[1], K, seed=K)
        ys = rk.reduce_slices_cols(X, sd.vals_ss, sd.red_plan, sd.nslices)
        assert ys.shape == (8, sd.nslices, 128, K)
        for c in range(K):
            want = rk.reduce_slices(X[:, c].contiguous(), sd.vals_ss,
                                    sd.red_plan, sd.nslices)
            assert torch.equal(_bits(ys[..., c]), _bits(want))


def test_k1_goes_through_the_spmv(monkeypatch):
    """At K 1 spmm_routed is spmv_routed's y as one column: no wide pass."""
    coo, sd = _upload("powerlaw", "cpu")
    X = _X(coo.shape[1], 1)
    want = sp.spmv_routed(sd, X[:, 0])
    calls = []
    spmv = sp.spmv_routed
    monkeypatch.setattr(sp, "spmv_routed",
                        lambda s, x: calls.append(x.shape) or spmv(s, x))

    def refuse(*a, **k):
        raise AssertionError("the wide pass ran at K 1")

    monkeypatch.setattr(rk, "reduce_slices_cols", refuse)
    monkeypatch.setattr(rk, "route_small_cols", refuse)
    Y = sp.spmm_routed(sd, X)
    assert calls == [(coo.shape[1],)] and Y.shape == (coo.shape[0], 1)
    assert torch.equal(_bits(Y[:, 0]), _bits(want))


def test_spmm_spans_name_the_tiles():
    """One routed.reduce span a tile, its detail the tile's width, each
    followed by its routed.y."""
    coo, sd = _upload("uniform_w16", "cpu")
    with prof.recording():
        sp.spmm_routed(sd, _X(coo.shape[1], 9))
    got = [(s.name, s.detail) for s in prof.record()]
    assert got == [("routed.reduce", "X8"), ("routed.y", None),
                   ("routed.reduce", "X1"), ("routed.y", None)]


def test_reduce_slices_cols_refuses():
    """A wrong dtype, a plan of another pack or into g1, a tile wider than
    COLS_TILE or with its columns apart, and a source or output past
    2**31 - 1 elements."""
    coo, sd = _upload("powerlaw", "cpu")
    _, other = _upload("uniform_w16", "cpu")
    X = _X(coo.shape[1], 8)
    plan, vals, nys = sd.red_plan, sd.vals_ss, sd.nslices
    with pytest.raises(TypeError):
        rk.reduce_slices_cols(X.double(), vals, plan, nys)
    with pytest.raises(TypeError):
        rk.reduce_slices_cols(X, vals.double(), plan, nys)
    with pytest.raises(ValueError, match="plane shapes"):
        rk.reduce_slices_cols(X, other.vals_ss, plan, nys)
    with pytest.raises(ValueError, match="indexes g1"):
        rk.reduce_slices_cols(X, vals, sp.g1_plan(sd), nys)
    with pytest.raises(ValueError, match="KT"):
        rk.reduce_slices_cols(_X(coo.shape[1], 9), vals, plan, nys)
    with pytest.raises(ValueError, match="side by side"):
        rk.reduce_slices_cols(X.t().contiguous().t(), vals, plan, nys)
    big = torch.empty((2**28, 9), device="meta")[:, :8]
    with pytest.raises(ValueError, match="32-bit"):
        rk.reduce_slices_cols(big, vals, plan, nys)
    with pytest.raises(ValueError, match="32-bit"):
        rk.reduce_slices_cols(X, vals, plan, 2**19)


def test_route_small_cols_refuses():
    """A wrong dtype, an index of another length, an output of another
    shape, and a stream or output past 2**31 - 1 elements."""
    coo, sd = _upload("powerlaw", "cpu")
    ra = sd.yroute
    ysp = torch.zeros((8, ra.Tp, 128, 8))
    with pytest.raises(TypeError):
        rk.route_small_cols(ysp.double(), ra.src, ra.n)
    with pytest.raises(TypeError):
        rk.route_small_cols(ysp, ra.src.long(), ra.n)
    with pytest.raises(ValueError, match="one index per output"):
        rk.route_small_cols(ysp, ra.src[:-1], ra.n)
    with pytest.raises(ValueError, match="out is"):
        rk.route_small_cols(ysp, ra.src, ra.n, out=torch.empty(ra.n, 7))
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="32-bit"):
        rk.route_small_cols(torch.empty((8, 2**18, 128, 8), **meta),
                            torch.empty(8, dtype=torch.int32, **meta), 8)
    n = 2**19 + 1
    with pytest.raises(ValueError, match="32-bit"):
        rk.route_small_cols(torch.empty((8, 1024, 128, 8), **meta),
                            torch.empty(n, dtype=torch.int32, **meta), n,
                            out=torch.empty((n, 2**12), **meta)[:, :8])


def test_route_small_cols_is_route_small_a_column():
    """K4w's plain version: column c equals K4's plain version on column c
    of the stream, and writes into the given tile of a wider Y."""
    _, sd = _upload("rmat15_hot512", "cpu")
    ra = sd.yroute
    ysp = torch.randn((8, ra.Tp, 128, 5), generator=torch.Generator()
                      .manual_seed(3))
    Y = torch.full((ra.n, 9), 7.0)
    got = rk.route_small_cols(ysp, ra.src, ra.n, out=Y[:, 2:7])
    assert got.data_ptr() == Y[:, 2:7].data_ptr()
    for c in range(5):
        want = rk.route_small(ysp[..., c].contiguous(), ra.src, ra.n)
        assert torch.equal(_bits(Y[:, 2 + c]), _bits(want))
    assert bool((Y[:, :2] == 7).all() and (Y[:, 7:] == 7).all())


def test_card_kernels_against_plain_and_per_column():
    """On a card: K3w within 1e-6 of the row scale of its plain version and
    bit for bit with K3 a column, K4w's rows bit for bit with its plain
    version (also with the y stream at a 4 B offset, which the kernel
    reads 4 B at a time), Y bit for bit with the routed SpMV a column
    (under torch's deterministic algorithms: index_add_ adds the
    split-row extras by atomics otherwise), at K 3, 8, 9, 16 and X at a
    4 B offset; 3 launches a product at K 8 on a hot-free pack whose
    slices split."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels' variant of the cases")
    for case in sorted(CASES):
        coo, sd = _upload(case, "cuda")
        for K, offset in ((3, 0), (8, 0), (9, 0), (16, 0), (8, 1)):
            buf = torch.empty(coo.shape[1] * K + offset, device="cuda")
            X = buf[offset:].view(coo.shape[1], K)
            X.copy_(_X(coo.shape[1], K, seed=K))
            Xt = X[:, : rk.COLS_TILE]
            args = (Xt, sd.vals_ss, sd.red_plan, sd.nslices)
            ys = rk.reduce_slices_cols(*args)
            want = rk.reduce_slices_cols_plain(*args)
            scale = rk.reduce_slices_cols_plain(Xt.abs(), sd.vals_ss.abs(),
                                                *args[2:])
            assert bool(((ys - want).abs() <= 1e-6 * scale + 1e-30).all())
            for c in range(Xt.shape[1]):
                assert torch.equal(ys[..., c], sp.reduce(
                    sd, Xt[:, c].contiguous()))
            ysp = sp.y_stream_cols(sd, ys)
            ra = sd.yroute
            want = rk.route_small_cols_plain(ysp, ra.src, ra.n)
            assert torch.equal(rk.route_small_cols(ysp, ra.src, ra.n), want)
            ysp4 = torch.empty(ysp.numel() + 1, device="cuda")[1:]
            ysp4 = ysp4.view(ysp.shape).copy_(ysp)
            assert torch.equal(rk.route_small_cols(ysp4, ra.src, ra.n), want)
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                Y = sp.spmm_routed(sd, X)
                assert torch.equal(Y, _per_column(sd, X)), (case, K)
            finally:
                torch.use_deterministic_algorithms(False)
    coo, sd = _upload("powerlaw", "cuda")
    assert sd.hot_nslices == 0 and sd.red_plan.split.combine.shape[0]
    X = _X(coo.shape[1], 8).cuda()
    kernels.reset_launches()
    sp.spmm_routed(sd, X)
    torch.cuda.synchronize()
    got = {k: n for k, n in kernels.launches().items() if n}
    assert got == {"reduce_slices_cols": 2, "route_small_cols": 1}
