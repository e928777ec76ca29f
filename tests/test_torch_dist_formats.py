"""The row-sharded DIA, SELL-W and BELL SpMVs of the port on a CPU mesh,
against the JAX package's (its 8-device CPU mesh, Pallas in interpret
mode) and the float64 golden, at the row-scaled 1e-6 contract.

Each path: the shard bounds and the forced geometry equal the JAX
package's, the per-shard planes equal its stacked ones array for array,
y in both x modes (replicated, and row-sharded then all-gathered) agrees
with the JAX package's and the golden, the JAX artifact carried across
(``from_reference``) gives the port's own pack's y bit for bit, and the
mesh sizes 1, 2, 4 and 8 give the golden.  Then each path's trouble
spot: DIA's bands and BELL's links across every shard bound (x read left
of the shard's first row), shard 0's columns below 0 read as 0, the
native BELL fill on negative columns against the numpy one, the spliced
SELL-W planes (``emit = -1`` rows) against each shard's own, empty
shards, BELL with and without a spill, and a SELL-W geometry with two
reduce groups a shard.  On the CPU every kernel wrapper runs its plain
version: no launch is counted.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_dist_formats.py -q
"""

import functools

import numpy as np
import pytest
import torch

from cvr_tpu.parallel import dist_bell as jbell
from cvr_tpu.parallel import dist_dia as jdia
from cvr_tpu.parallel import dist_window as jwin
from cvr_tpu.parallel.dist import make_mesh as j_make_mesh

from cvr_tpu_torch import _native
from cvr_tpu_torch.formats.bell import bell_pack
from cvr_tpu_torch.formats.sell_window import (
    WindowInfeasible,
    sell_pack_window,
)
from cvr_tpu_torch.ops import bell_kernels as bk
from cvr_tpu_torch.ops import kernels
from cvr_tpu_torch.ops import route_planes as tpr
from cvr_tpu_torch.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify
from cvr_tpu_torch.ops.spmv_window import to_device_window, window_rows
from cvr_tpu_torch.parallel import dist as tdist
from cvr_tpu_torch.parallel import dist_bell as tbell
from cvr_tpu_torch.parallel import dist_dia as tdia
from cvr_tpu_torch.parallel import dist_window as twin
from torch_cases import banded, diagonals, fem, pair, road, window_empty_rows

D = 4
MODES = (False, True)  # x_sharded
SHARD_COUNTS = (1, 2, 4, 8)


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launches()
    yield
    # CPU tensors: every wrapper ran its plain version
    assert not any(kernels.launches().values())


def _mesh(n):
    return tdist.make_mesh(devices=["cpu"] * n)


def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _check(y, csr, x, ref=None):
    """y against the float64 golden (and ``ref``) at rtol 1e-6, scaled by
    |A| |x| row by row."""
    y = np.asarray(y)
    scale = spmv_row_scale(csr, x)
    assert y.shape == (csr.shape[0],) and np.isfinite(y).all()
    ok, nbad, maxrel = verify(y, spmv_golden_numpy(csr, x), rtol=1e-6,
                              row_scale=scale)
    assert ok, f"golden: {nbad} bad rows, max rel {maxrel}"
    if ref is not None:
        ok, nbad, maxrel = verify(y, np.asarray(ref), rtol=1e-6,
                                  row_scale=scale)
        assert ok, f"JAX: {nbad} bad rows, max rel {maxrel}"


def _crosses_every_bound(csr, bounds):
    """Every inner shard bound b has an entry of a row >= b in a column
    < b (x read left of the shard's first row) and one of a row < b in a
    column >= b."""
    rows = csr.row_ids()
    for b in bounds[1:-1]:
        assert ((rows >= b) & (csr.cols < b)).any()
        assert ((rows < b) & (csr.cols >= b)).any()


# ---------------------------------------------------------------------------
# DIA: equal row ranges, K8 per shard on a shifted view of x
# ---------------------------------------------------------------------------


def dia_matrix():
    """4099 x 4093 (ncols not a multiple of 4 or 8), diagonals reaching
    300 rows left and 600 right: every shard bound is crossed."""
    return diagonals(4099, 4093, (-300, -7, 0, 5, 600), seed=12)


@pytest.fixture(scope="module")
def dia_pair():
    jcoo, tcoo = dia_matrix()
    csr, x = tcoo.to_csr(), _x(tcoo.shape[1], seed=3)
    jdm = jdia.dist_dia_pack(jcoo.to_csr(), j_make_mesh(D))
    y_jax = {xs: np.asarray(jdia.dist_spmv_dia(jdm, x, x_sharded=xs))
             for xs in MODES}
    return csr, x, jdm, tdia.dist_dia_pack(csr, _mesh(D)), y_jax


@pytest.mark.parametrize("x_sharded", MODES)
def test_dia_matches_reference(dia_pair, x_sharded):
    csr, x, jdm, dm, y_jax = dia_pair
    assert np.array_equal(dm.bounds, jdm.bounds)
    assert dm.offsets == jdm.offsets and dm.rows_max == jdm.rows_max
    for d in range(D):
        assert np.array_equal(dm.bands(d).numpy(), np.asarray(jdm.bands[d]))
    _crosses_every_bound(csr, dm.bounds)
    y = tdia.dist_spmv_dia(dm, torch.from_numpy(x), x_sharded=x_sharded)
    _check(y, csr, x, y_jax[x_sharded])
    carried = tdia.from_reference(jdm, _mesh(D))
    assert carried.pre == dm.pre == (0, 300, 300, 300)
    assert torch.equal(tdia.dist_spmv_dia(carried, torch.from_numpy(x),
                                          x_sharded=x_sharded), y)


@pytest.mark.parametrize("n", SHARD_COUNTS)
def test_dia_shard_counts(n):
    jcoo, tcoo = dia_matrix()
    csr, x = tcoo.to_csr(), _x(tcoo.shape[1], seed=3)
    dm = tdia.dist_dia_pack(csr, _mesh(n))
    assert np.array_equal(
        dm.bounds, jdia.dist_dia_pack(jcoo.to_csr(), j_make_mesh(n)).bounds)
    for xs in MODES:
        _check(tdia.dist_spmv_dia(dm, torch.from_numpy(x), x_sharded=xs),
               csr, x)


def test_dia_reads_left_of_each_shard():
    """An entry put on the -300 diagonal at local row 5 of each shard:
    shard 0's names column -295 and reads 0 there (it takes no pre rows,
    K8 reads x in place); every later shard's reads the real x entry
    x[r0 - 295] left of its first row r0 (through its pre rows)."""
    _, tcoo = dia_matrix()
    dm = tdia.dist_dia_pack(tcoo.to_csr(), _mesh(D))
    assert dm.offsets[0] == -300
    x = torch.from_numpy(_x(tcoo.shape[1], seed=9))
    y0 = tdia.dist_spmv_dia(dm, x)
    for d, sd in enumerate(dm.shards):
        sd.bands[0, dm.pre[d] + 5] += 1.0
    diff = tdia.dist_spmv_dia(dm, x) - y0
    for d in range(D):
        r0 = int(dm.bounds[d])
        want = 0.0 if d == 0 else float(x[r0 + 5 - 300])
        assert abs(float(diff[r0 + 5]) - want) <= 1e-5 * (1 + abs(want))
    assert float(diff[0]) == 0.0


# ---------------------------------------------------------------------------
# SELL-W: one forced (D, W), the shards spliced to one geometry, K10
# ---------------------------------------------------------------------------


def window_matrix():
    return fem(n=1 << 13, deg=10, bw=100, seed=5)


@pytest.fixture(scope="module")
def window_pair():
    jcoo, tcoo = window_matrix()
    csr, x = tcoo.to_csr(), _x(tcoo.shape[1], seed=4)
    jdm = jwin.dist_window_pack(jcoo.to_csr(), j_make_mesh(D))
    y_jax = {xs: np.asarray(jwin.dist_spmv_window(jdm, x, x_sharded=xs))
             for xs in MODES}
    return csr, x, jdm, twin.dist_window_pack(csr, _mesh(D)), y_jax


def _same_window_geometry(dm, jdm):
    assert np.array_equal(dm.bounds, jdm.bounds)
    for k in ("W", "D", "G", "segw", "n_segs", "nslices_u", "rows_max",
              "wrl"):
        assert getattr(dm, k) == getattr(jdm, k), k
    assert dm.ycall_rows == tuple(tuple(r) for r in jdm.ycall_rows)


@pytest.mark.parametrize("x_sharded", MODES)
def test_window_matches_reference(window_pair, x_sharded):
    csr, x, jdm, dm, y_jax = window_pair
    _same_window_geometry(dm, jdm)
    for d, pl in enumerate(dm.planes):
        for k in twin.PLANES:
            assert np.array_equal(pl[k], np.asarray(jdm.planes[k][d])), k
    y = twin.dist_spmv_window(dm, torch.from_numpy(x), x_sharded=x_sharded)
    _check(y, csr, x, y_jax[x_sharded])
    carried = twin.from_reference(jdm, _mesh(D))
    assert torch.equal(twin.dist_spmv_window(
        carried, torch.from_numpy(x), x_sharded=x_sharded), y)


@pytest.mark.parametrize("n", SHARD_COUNTS)
def test_window_shard_counts(n):
    jcoo, tcoo = window_matrix()
    csr, x = tcoo.to_csr(), _x(tcoo.shape[1], seed=4)
    dm = twin.dist_window_pack(csr, _mesh(n))
    _same_window_geometry(dm, jwin.dist_window_pack(jcoo.to_csr(),
                                                    j_make_mesh(n)))
    for xs in MODES:
        _check(twin.dist_spmv_window(dm, torch.from_numpy(x), x_sharded=xs),
               csr, x)


@pytest.fixture
def reduce_groups_of_2(monkeypatch):
    """Reduce groups of 2 slices (YB) in both packages' packers, so that
    a small matrix gives every shard several groups, of row counts that
    differ from shard to shard."""
    import cvr_tpu.ops.pallas_window as jpw

    monkeypatch.setattr(tpr, "YB", 2)
    monkeypatch.setattr(jpw, "YB", 2)
    monkeypatch.setattr(jwin, "YB", 2)


def test_window_spliced_planes(reduce_groups_of_2):
    """Several reduce groups a shard, spliced to the largest shard's row
    counts with zero rows whose emit is -1: the planes equal the JAX
    package's; K10 over each shard's spliced planes gives its own pack's
    rows bit for bit; the JAX artifact carried across gives the port's
    y bit for bit; y at the golden in both modes."""
    jcoo, tcoo = window_empty_rows()
    csr, x = tcoo.to_csr(), _x(tcoo.shape[1], seed=4)
    dm = twin.dist_window_pack(csr, _mesh(D))
    jdm = jwin.dist_window_pack(jcoo.to_csr(), j_make_mesh(D))
    _same_window_geometry(dm, jdm)
    for d, pl in enumerate(dm.planes):
        for k in twin.PLANES:
            assert np.array_equal(pl[k], np.asarray(jdm.planes[k][d])), k
        closing = [j for j, (r0, nr) in enumerate(dm.ycall_rows)
                   if (pl["emit"][r0 : r0 + nr] >= 0).any()]
        assert len(closing) >= 2
    xt = torch.from_numpy(x)
    padded = 0
    for d, lc in enumerate(tdist.local_csrs(csr, dm.bounds)):
        own = sell_pack_window(lc, force_dw=(dm.D, dm.W))
        padded += dm.planes[d]["emit"].shape[0] - own.emit.shape[0]
        # the device holds the shard's own rows of the spliced planes
        assert dm.shards[d].li.shape[1] <= own.emit.shape[0]
        n = lc.shape[0]
        assert torch.equal(window_rows(dm.shards[d], xt)[:n],
                           window_rows(to_device_window(own, "cpu"), xt)[:n])
    assert padded > 0
    carried = twin.from_reference(jdm, _mesh(D))
    for xs in MODES:
        y = twin.dist_spmv_window(dm, xt, x_sharded=xs)
        _check(y, csr, x)
        assert torch.equal(twin.dist_spmv_window(carried, xt, x_sharded=xs),
                           y)


def test_window_refuses_where_no_geometry_fits():
    """Scattered columns fit no (D, W): WindowInfeasible with the JAX
    package's message (its own pack raises a KeyError there: the pinned
    candidate's spread is read at D 1)."""
    rng = np.random.default_rng(0)
    _, tcoo = pair(rng.integers(0, 5000, 20000).astype(np.int32),
                   rng.integers(0, 100000, 20000).astype(np.int32),
                   rng.standard_normal(20000).astype(np.float32),
                   (5000, 100000))
    with pytest.raises(WindowInfeasible, match="every row shard"):
        twin.dist_window_pack(tcoo.sum_duplicates().to_csr(), _mesh(D))
    with pytest.raises(WindowInfeasible, match="spread"):
        sell_pack_window(tcoo.sum_duplicates().to_csr(), force_dw=(2, 1024))


# ---------------------------------------------------------------------------
# BELL: 1024-aligned shards, K9 on a shifted view of x, a forced spill
# ---------------------------------------------------------------------------


def bell_matrix():
    """The JAX dryrun's road matrix: links within 48 columns cross every
    1024-aligned shard bound; a routed spill."""
    return road(n=1 << 14, reach=48, seed=9)


@functools.cache
def _road_dryrun():
    from cvr_tpu.bench import synthetic as jsyn
    from cvr_tpu_torch.bench import synthetic as tsyn

    return (jsyn.road_usa_like(n=1 << 14, deg=2.5, reach=48, seed=9),
            tsyn.road_usa_like(n=1 << 14, deg=2.5, reach=48, seed=9))


@pytest.fixture(scope="module")
def bell_pair():
    jcoo, tcoo = _road_dryrun()
    csr, x = tcoo.to_csr(), _x(tcoo.shape[1], seed=6)
    jdm = jbell.dist_bell_pack(jcoo.to_csr(), j_make_mesh(D))
    y_jax = {xs: np.asarray(jbell.dist_spmv_bell(jdm, x, x_sharded=xs))
             for xs in MODES}
    return csr, x, jdm, tbell.dist_bell_pack(csr, _mesh(D)), y_jax


def _same_bell(dm, jdm):
    assert np.array_equal(dm.bounds, jdm.bounds)
    assert dm.rows_max == jdm.rows_max
    jm = dict(jdm.meta)
    assert {k: v for k, v in dm.meta.items() if k != "spill"} == {
        k: v for k, v in jm.items() if k != "spill"}
    assert (dm.meta["spill"] is None) == (jm["spill"] is None)
    if jm["spill"] is not None:
        assert dm.meta["spill"] == jm["spill"]
    keys = set(dm.planes[0])
    assert keys == set(jdm.planes) - {"sp_gemit"}
    for d, pl in enumerate(dm.planes):
        for k in keys:
            assert np.array_equal(pl[k], np.asarray(jdm.planes[k][d])), k


@pytest.mark.parametrize("x_sharded", MODES)
def test_bell_matches_reference(bell_pair, x_sharded):
    csr, x, jdm, dm, y_jax = bell_pair
    assert dm.meta["spill"] is not None
    _same_bell(dm, jdm)
    _crosses_every_bound(csr, dm.bounds)
    y = tbell.dist_spmv_bell(dm, torch.from_numpy(x), x_sharded=x_sharded)
    _check(y, csr, x, y_jax[x_sharded])
    carried = tbell.from_reference(jdm, _mesh(D))
    assert torch.equal(tbell.dist_spmv_bell(
        carried, torch.from_numpy(x), x_sharded=x_sharded), y)


@pytest.mark.parametrize("n", SHARD_COUNTS)
def test_bell_shard_counts(n):
    jcoo, tcoo = _road_dryrun()
    csr, x = tcoo.to_csr(), _x(tcoo.shape[1], seed=6)
    dm = tbell.dist_bell_pack(csr, _mesh(n))
    assert np.array_equal(
        dm.bounds, jbell._aligned_bounds(jcoo.to_csr().rowptr, n,
                                         csr.shape[0]))
    for xs in MODES:
        _check(tbell.dist_spmv_bell(dm, torch.from_numpy(x), x_sharded=xs),
               csr, x)


@pytest.mark.parametrize("case", ["no_spill", "empty_shards"])
def test_bell_geometries_match_reference(case):
    """Without a spill (three diagonals within the reach; 5000 x 4999,
    ncols not a multiple of 8), and on 3000 rows over 8 shards, where the
    1024-aligned cuts leave shards empty (zero planes): the pack equals
    the JAX package's, y is at the golden."""
    if case == "no_spill":
        jcoo, tcoo = diagonals(5000, 4999, (-40, 0, 33), seed=2)
    else:
        jcoo, tcoo = road(n=3000, reach=48, seed=4)
    csr, x = tcoo.to_csr(), _x(tcoo.shape[1], seed=8)
    dm = tbell.dist_bell_pack(csr, _mesh(8))
    _same_bell(dm, jbell.dist_bell_pack(jcoo.to_csr(), j_make_mesh(8)))
    if case == "no_spill":
        assert dm.meta["spill"] is None
    else:
        assert (np.diff(dm.bounds) == 0).sum() >= 4
        assert dm.meta["spill"] is not None
    for xs in MODES:
        _check(tbell.dist_spmv_bell(dm, torch.from_numpy(x), x_sharded=xs),
               csr, x)


def test_bell_first_shard_reads_zero_below_column_0(bell_pair):
    """Shard 0's K9 reads x in place with the format's pre rows: a plane
    entry naming a column below 0 reads 0; shard 1 gets the view at
    lo - 128 * pre, so the same entry reads x[lo - 128 * pre + ...]."""
    _, x, _, dm, _ = bell_pair
    xt = torch.from_numpy(x)
    li, vals, xv, d, pre, n_keep = tbell.shard_gather_args(dm, 0, xt)
    assert xv.data_ptr() == xt.data_ptr() and pre == dm.meta["pre"]
    li, vals = li.clone(), vals.clone()
    li[0, 0, 0], vals[0, 0, 0] = 3, 1.0  # column (d - pre) * 128 + 3 < 0
    assert (d - pre) * 128 + 3 < 0
    y = bk.bell_gather_mac(li, vals, xv, d, pre, n_keep)
    vals[0, 0, 0] = 0.0
    assert torch.equal(y, bk.bell_gather_mac(li, vals, xv, d, pre, n_keep))
    _, _, xv1, _, pre1, _ = tbell.shard_gather_args(dm, 1, xt)
    s = 128 * dm.meta["pre"]
    assert pre1 == 0 and torch.equal(xv1, xt[int(dm.bounds[1]) - s:])


def test_bell_native_fill_on_negative_columns(bell_pair, monkeypatch):
    """A shard's columns go below 0 (col - lo); the native stats and fill
    passes give the numpy path's planes and spill on such a shard."""
    csr, _, _, dm, _ = bell_pair
    lc = tbell._shard_csrs(csr, dm.bounds)[2]
    assert lc.cols.min() < 0
    kw = dict(k=dm.meta["k"], max_spill=1.0, reach_force=dm.meta["reach"],
              R_sub_min=dm.meta["R_sub"], pack_spill=False)
    assert _native.available()
    native = bell_pack(lc, **kw)
    monkeypatch.setattr(_native, "available", lambda: False)
    numpy_ = bell_pack(lc, **kw)
    assert np.array_equal(native.li, numpy_.li)
    assert np.array_equal(native.vals, numpy_.vals)
    for a, b in zip(native.spill_raw, numpy_.spill_raw):
        assert np.array_equal(a, b)
    assert (native.R_sub, native.reach) == (dm.meta["R_sub"],
                                            dm.meta["reach"])


def test_bell_pack_options_keep_the_default_output():
    """bell_pack's defaults pack the spill and leave spill_raw None; the
    pinned reach and row count only widen the geometry."""
    _, tcoo = road(n=1 << 13, reach=48, seed=3)
    csr = tcoo.to_csr()
    bm = bell_pack(csr)
    assert bm.spill_raw is None
    pinned = bell_pack(csr, reach_force=200, R_sub_min=bm.R_sub + 1)
    assert pinned.reach == 200 and pinned.R_sub > bm.R_sub
    with pytest.raises(ValueError, match="reach_force"):
        bell_pack(csr, reach_force=bm.reach - 1)


def test_dist_modules_take_the_mesh_as_given():
    """A pack on a mesh of other size than the artifact's refuses."""
    jcoo, _ = banded(2048, 5)
    jdm = jdia.dist_dia_pack(jcoo.to_csr(), j_make_mesh(D))
    with pytest.raises(ValueError, match="shards on a mesh"):
        tdia.from_reference(jdm, _mesh(2))
