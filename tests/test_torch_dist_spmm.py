"""The row-sharded BSR, lane and PMM SpMMs of the port on a CPU mesh,
against the JAX package's (its 8-device CPU mesh, Pallas in interpret
mode) and the float64 golden: each Y within 1e-6 of |A| @ |X| (the
row-scaled contract of an SpMM).

Each path: the shard bounds equal the JAX package's, the per-shard
planes equal its stacked ones array for array (BSR bricks and brick
coordinates, the padded lane plans; PMM: each shard's plan equals the JAX
``pmm_plan`` of the shard's rows, and the TPU kernel's segments a shard
are the JAX pack's), Y with X replicated and with X row-sharded then
all-gathered agrees with the JAX package's and the golden, the JAX
artifact carried across (``from_reference``) gives the port's own pack's
Y bit for bit, and the mesh sizes 1, 2, 4 and 8 give the golden.  Then:
empty shards, split-row extras padded across shards, several lane
output blocks and PMM segments a shard (held against the golden alone:
the JAX package's interpret mode is too slow there), and PMM's refusal
of K > 128.  On the CPU every kernel wrapper runs its plain version.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_dist_spmm.py -q
"""

import numpy as np
import pytest
import torch

from cvr_tpu.ops.spmm_pmm import pmm_plan as j_pmm_plan
from cvr_tpu.parallel import dist_bsr as jbsr
from cvr_tpu.parallel import dist_lane as jlane
from cvr_tpu.parallel import dist_pmm as jpmm
from cvr_tpu.parallel.dist import make_mesh as j_make_mesh

from cvr_tpu_torch.formats.sell import sell_pack
from cvr_tpu_torch.ops import kernels
from cvr_tpu_torch.ops.spmm_lane import lane_plan, spmm_lane, to_device_lane
from cvr_tpu_torch.ops.spmm_pmm import PmmPlan
from cvr_tpu_torch.parallel import dist as tdist
from cvr_tpu_torch.parallel import dist_bsr as tbsr
from cvr_tpu_torch.parallel import dist_lane as tlane
from cvr_tpu_torch.parallel import dist_pmm as tpmm
from torch_cases import diagonals, fsm, pair, random_rect, rmat

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


def _X(n, K, seed=0):
    return np.random.default_rng(seed).standard_normal((n, K)).astype(
        np.float32)


def _check(Y, csr, X, ref=None):
    """Y against the float64 golden (and ``ref``): max |Y - want| over
    |A| @ |X| below 1e-6."""
    Y = np.asarray(Y)
    assert Y.shape == (csr.shape[0], X.shape[1]) and np.isfinite(Y).all()
    A = csr.to_scipy().astype(np.float64)
    scale = abs(A) @ np.abs(X.astype(np.float64)) + 1e-30
    for want in (A @ X.astype(np.float64),
                 *(() if ref is None else (np.asarray(ref),))):
        assert float((np.abs(Y - want) / scale).max()) < 1e-6


def _drop_last_columns(coo, n=3):
    """The pair of COOs without the last n columns (ncols % D != 0)."""
    keep = coo.cols < coo.shape[1] - n
    return pair(coo.rows[keep], coo.cols[keep], coo.vals[keep],
                (coo.shape[0], coo.shape[1] - n))


def _run(fn, dm, X, x_sharded):
    return fn(dm, torch.from_numpy(X), x_sharded=x_sharded)


# ---------------------------------------------------------------------------
# BSR: equal brick counts cut at row-block bounds, K12 per shard
# ---------------------------------------------------------------------------


def bsr_matrix():
    """4099 x 4093 (ncols not a multiple of 4 or 8), five diagonals."""
    return diagonals(4099, 4093, (-130, -3, 0, 2, 260), seed=13)


@pytest.fixture(scope="module")
def bsr_pair():
    jcoo, tcoo = bsr_matrix()
    csr, X = tcoo.to_csr(), _X(tcoo.shape[1], 4, seed=3)
    jdm = jbsr.dist_bsr_pack(jcoo.to_csr(), j_make_mesh(D))
    Y_jax = {xs: np.asarray(jbsr.dist_spmm_bsr(jdm, X, x_sharded=xs))
             for xs in MODES}
    return csr, X, jdm, tbsr.dist_bsr_pack(csr, _mesh(D)), Y_jax


@pytest.mark.parametrize("x_sharded", MODES)
def test_bsr_matches_reference(bsr_pair, x_sharded):
    csr, X, jdm, dm, Y_jax = bsr_pair
    assert np.array_equal(dm.rb_bounds, jdm.rb_bounds)
    assert (dm.nrb_local_max, dm.ncb) == (jdm.nrb_local_max, jdm.ncb)
    padding = 0
    for d, sd in enumerate(dm.shards):
        # the shard's own bricks are the JAX package's; the rest of its
        # stack pads it to the largest shard's count with zero bricks in
        # its last row block, which the port does not upload
        k = sd.vals.shape[0]
        jv, jr = np.asarray(jdm.vals[d]), np.asarray(jdm.brick_row[d])
        assert np.array_equal(sd.vals.numpy(), jv[:k])
        assert np.array_equal(sd.brick_row.numpy(), jr[:k])
        assert np.array_equal(sd.brick_col.numpy(),
                              np.asarray(jdm.brick_col[d])[:k])
        assert sd.nrb == dm.rb_bounds[d + 1] - dm.rb_bounds[d]
        assert not jv[k:].any()
        assert (jr[k:] == max(sd.nrb - 1, 0)).all()
        padding += jv.shape[0] - k
    assert padding > 0
    Y = _run(tbsr.dist_spmm_bsr, dm, X, x_sharded)
    _check(Y, csr, X, Y_jax[x_sharded])
    carried = tbsr.from_reference(jdm, _mesh(D))
    assert torch.equal(_run(tbsr.dist_spmm_bsr, carried, X, x_sharded), Y)


@pytest.mark.parametrize("n", SHARD_COUNTS)
def test_bsr_shard_counts(n):
    jcoo, tcoo = bsr_matrix()
    csr, X = tcoo.to_csr(), _X(tcoo.shape[1], 4, seed=3)
    dm = tbsr.dist_bsr_pack(csr, _mesh(n))
    assert np.array_equal(
        dm.rb_bounds,
        jbsr.dist_bsr_pack(jcoo.to_csr(), j_make_mesh(n)).rb_bounds)
    for xs in MODES:
        _check(_run(tbsr.dist_spmm_bsr, dm, X, xs), csr, X)


def test_bsr_empty_shards():
    """300 rows (3 row blocks) on 8 shards: five shards hold no row block
    and only zero bricks."""
    _, tcoo = diagonals(300, 310, (-5, 0, 7), seed=2)
    csr, X = tcoo.to_csr(), _X(310, 5, seed=1)
    dm = tbsr.dist_bsr_pack(csr, _mesh(8))
    assert (np.diff(dm.rb_bounds) == 0).sum() >= 5
    for xs in MODES:
        _check(_run(tbsr.dist_spmm_bsr, dm, X, xs), csr, X)


# ---------------------------------------------------------------------------
# lane: nnz-balanced shards, plans padded to one geometry, K13 per shard
# ---------------------------------------------------------------------------


def lane_matrix():
    """The JAX dryrun's routed matrix: R-MAT 10, edge factor 7, seed 5,
    less its last 3 columns."""
    return _drop_last_columns(rmat(10, 7, 5)[1])


def _same_lane(dm, jdm):
    assert np.array_equal(dm.bounds, jdm.bounds)
    assert dm.meta == dict(jdm.meta) and dm.rows_max == jdm.rows_max
    for d, pl in enumerate(dm.planes):
        for k in tlane.PLANES:
            assert np.array_equal(pl[k], np.asarray(jdm.planes[k][d])), k


@pytest.fixture(scope="module")
def lane_pair():
    jcoo, tcoo = lane_matrix()
    csr, X = tcoo.to_csr(), _X(tcoo.shape[1], 8, seed=7)
    jdm = jlane.dist_lane_pack(jcoo.to_csr(), j_make_mesh(D))
    Y_jax = {xs: np.asarray(jlane.dist_spmm_lane(jdm, X, x_sharded=xs))
             for xs in MODES}
    return csr, X, jdm, tlane.dist_lane_pack(csr, _mesh(D)), Y_jax


@pytest.mark.parametrize("x_sharded", MODES)
def test_lane_matches_reference(lane_pair, x_sharded):
    csr, X, jdm, dm, Y_jax = lane_pair
    _same_lane(dm, jdm)
    Y = _run(tlane.dist_spmm_lane, dm, X, x_sharded)
    _check(Y, csr, X, Y_jax[x_sharded])
    carried = tlane.from_reference(jdm, _mesh(D))
    assert torch.equal(_run(tlane.dist_spmm_lane, carried, X, x_sharded), Y)


def test_lane_shards_upload_their_own_plans(lane_pair):
    """Each shard's device plan is its own part of the padded one: the
    plane rows up to its last emission and its own extras; its Y equals
    its own unpadded plan's bit for bit."""
    csr, X, _, dm, _ = lane_pair
    Xt = torch.from_numpy(X)
    trimmed = 0
    for d, (lc, sd, pl) in enumerate(zip(tdist.local_csrs(csr, dm.bounds),
                                         dm.shards, dm.planes)):
        S = sd.vals_l.shape[0]
        assert torch.equal(sd.vals_l, torch.from_numpy(pl["vals_l"][:S]))
        assert sd.extra_row.shape[0] == int(
            (pl["extra_row"] < lc.shape[0]).sum())
        trimmed += pl["vals_l"].shape[0] - S
        mean_len = -(-csr.nnz // csr.shape[0])
        own = lane_plan(sell_pack(lc, C=1024,
                                  split_len=max(1024, 16 * mean_len)))
        assert S <= own.vals_l.shape[0]
        assert torch.equal(spmm_lane(sd, Xt),
                           spmm_lane(to_device_lane(own, "cpu"), Xt))
    assert trimmed > 0


@pytest.mark.parametrize("n", SHARD_COUNTS)
def test_lane_shard_counts(n):
    """Split rows (split_len 16): every shard's extras padded to the
    largest count, the padding adding into the dropped row; the plans
    equal the JAX package's."""
    jcoo, tcoo = lane_matrix()
    csr, X = tcoo.to_csr(), _X(tcoo.shape[1], 8, seed=7)
    dm = tlane.dist_lane_pack(csr, _mesh(n), split_len=16)
    _same_lane(dm, jlane.dist_lane_pack(jcoo.to_csr(), j_make_mesh(n),
                                        split_len=16))
    extras = [int((pl["extra_row"] < dm.rows_max).sum()) for pl in dm.planes]
    assert max(extras) > 0
    if n > 1:
        assert min(extras) < dm.planes[0]["extra_row"].shape[0]
    for xs in MODES:
        _check(_run(tlane.dist_spmm_lane, dm, X, xs), csr, X)


def test_lane_output_blocks_a_shard():
    """40,000 x 30,007 uniformly scattered on 4 shards of 10,000 rows: 10
    slices, two 8-slice output blocks a shard (K 17); against the golden
    alone."""
    _, tcoo = random_rect(40000, 30007, density=1e-4, seed=3)
    csr, X = tcoo.to_csr(), _X(tcoo.shape[1], 17, seed=2)
    dm = tlane.dist_lane_pack(csr, _mesh(D))
    for pl in dm.planes:  # each shard emits into both blocks
        assert np.unique(pl["ob"][np.flatnonzero(pl["emit_l"] >= 0) // 8]
                         ).shape[0] >= 2
    for xs in MODES:
        _check(_run(tlane.dist_spmm_lane, dm, X, xs), csr, X)


# ---------------------------------------------------------------------------
# PMM: nnz-balanced shards, each its own plan, K14 per shard
# ---------------------------------------------------------------------------


def pmm_matrix():
    """The JAX dryrun's PMM matrix: fsm-like, 3000 states, seed 11."""
    return fsm(n=3000, seed=11)


def _same_plans(dm, jplans):
    for p, q in zip(dm.plans, jplans):
        for k in ("win", "rt", "ch", "lc", "val", "rl"):
            assert np.array_equal(getattr(p, k), getattr(q, k)), k
        assert (p.shape, p.nnz, p.npairs, p.nchunks, p.nrt) == (
            tuple(q.shape), q.nnz, q.npairs, q.nchunks, q.nrt)


@pytest.fixture(scope="module")
def pmm_pair():
    """The JAX package's Y with X row-sharded (its dryrun's mode; one
    interpret-mode call takes ~16 s, and its two modes differ only in how
    X reaches the shards): both of the port's modes are held to it."""
    jcoo, tcoo = pmm_matrix()
    csr, X = tcoo.to_csr(), _X(tcoo.shape[1], 16, seed=8)
    jdm = jpmm.dist_pmm_pack(jcoo.to_csr(), j_make_mesh(D))
    Y_jax = np.asarray(jpmm.dist_spmm_pmm(jdm, X, x_sharded=True))
    jplans = tpmm.shard_plans(jcoo.to_csr(), jdm.bounds, j_pmm_plan)
    return csr, X, jdm, jplans, tpmm.dist_pmm_pack(csr, _mesh(D)), Y_jax


@pytest.mark.parametrize("x_sharded", MODES)
def test_pmm_matches_reference(pmm_pair, x_sharded):
    csr, X, jdm, jplans, dm, Y_jax = pmm_pair
    assert np.array_equal(dm.bounds, jdm.bounds)
    _same_plans(dm, jplans)
    assert dm.meta["nseg"] == jdm.meta["nseg"]
    assert dm.c_mean == pytest.approx(jdm.c_mean, rel=0, abs=0)
    Y = _run(tpmm.dist_spmm_pmm, dm, X, x_sharded)
    _check(Y, csr, X, Y_jax)
    carried = tpmm.from_reference(jdm, _mesh(D), jplans)
    assert all(isinstance(p, PmmPlan) for p in carried.plans)
    assert torch.equal(_run(tpmm.dist_spmm_pmm, carried, X, x_sharded), Y)


@pytest.mark.parametrize("n", SHARD_COUNTS)
def test_pmm_shard_counts(n):
    jcoo, tcoo = pmm_matrix()
    csr, X = tcoo.to_csr(), _X(tcoo.shape[1], 16, seed=8)
    dm = tpmm.dist_pmm_pack(csr, _mesh(n))
    jdm = jpmm.dist_pmm_pack(jcoo.to_csr(), j_make_mesh(n))
    assert np.array_equal(dm.bounds, jdm.bounds)
    assert dm.meta["nseg"] == jdm.meta["nseg"] and dm.c_mean == jdm.c_mean
    for xs in MODES:
        _check(_run(tpmm.dist_spmm_pmm, dm, X, xs), csr, X)


def test_pmm_empty_shard_rows():
    """tests/test_dist_pmm.py's case: entries only in the first half of
    the rows, so the last shard's row tiles past them hold only pad
    chunks; its rows there are exact zeros.  Then 3 rows of entries over
    8 shards: shards of no row at all (a plan of one empty row)."""
    rng = np.random.default_rng(5)
    n = 4000
    rows = rng.integers(0, n // 2, size=6 * n).astype(np.int32)
    cols = rng.integers(0, n, size=6 * n).astype(np.int32)
    vals = rng.standard_normal(6 * n).astype(np.float32)
    _, tcoo = pair(rows, cols, vals, (n, n))
    csr = tcoo.sum_duplicates().to_csr()
    X = rng.standard_normal((n, 16)).astype(np.float32)
    dm = tpmm.dist_pmm_pack(csr, _mesh(8))
    last = dm.plans[-1]
    assert last.nchunks > np.unique(last.rt).shape[0] or (
        last.nrt > -(-(n // 2 - int(dm.bounds[-2])) // 128))
    for xs in MODES:
        Y = _run(tpmm.dist_spmm_pmm, dm, X, xs).numpy()
        _check(Y, csr, X)
        assert np.all(Y[n // 2 :] == 0.0)
    _, tiny = pair(np.array([0, 1, 2], np.int32), np.array([3, 0, 9],
                                                           np.int32),
                   np.ones(3, np.float32), (3, 10))
    dm = tpmm.dist_pmm_pack(tiny.to_csr(), _mesh(8))
    assert (np.diff(dm.bounds) == 0).sum() >= 5
    X = _X(10, 16, seed=1)
    for xs in MODES:
        _check(_run(tpmm.dist_spmm_pmm, dm, X, xs), tiny.to_csr(), X)


def test_pmm_segments_a_shard():
    """A wide scattered matrix whose chunks each touch many windows: more
    than SEG pairs a shard, so the JAX package's TPU kernel would run
    several segments on every shard; the port's plans and K14 (its plain
    version here) against the golden alone."""
    rng = np.random.default_rng(9)
    nnz = 200_000
    rows = rng.integers(0, 4096, nnz).astype(np.int32)
    cols = rng.integers(0, 1 << 20, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    _, tcoo = pair(rows, cols, vals, (4096, 1 << 20))
    csr = tcoo.sum_duplicates().to_csr()
    X = _X(csr.shape[1], 8, seed=4)
    dm = tpmm.dist_pmm_pack(csr, _mesh(2))
    assert min(tpmm.tpu_segments(p) for p in dm.plans) >= 2
    for xs in MODES:
        _check(_run(tpmm.dist_spmm_pmm, dm, X, xs), csr, X)


def test_pmm_refuses_wide_k(pmm_pair):
    _, _, _, _, dm, _ = pmm_pair
    X = torch.zeros((dm.shape[1], 129))
    with pytest.raises(NotImplementedError, match="K <= 128"):
        tpmm.dist_spmm_pmm(dm, X)
