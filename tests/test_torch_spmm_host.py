"""The SpMM path's host layer against the JAX package's, at CPU-test
sizes: ``bsr_pack`` (native and numpy, both gates, the zero bricks of
empty row blocks), ``lane_plan`` / ``spmm_lane_pack``, ``pmm_plan``,
``pmm_estimate`` and ``pmm_projected_ms`` array for array, the
``from_reference`` conversions, and the format ``cli spmv --rhs K
--format auto`` picks, pinned to the one the JAX package's CLI runs.
"""

import argparse

import numpy as np
import pytest

import cvr_tpu.bench.harness as jharness
import cvr_tpu.cli as jcli
import cvr_tpu.formats.bsr as jbsr
import cvr_tpu.ops.spmm_pmm as jpmm
from cvr_tpu.formats.sell import sell_pack as j_sell_pack
from cvr_tpu.ops.spmm_lane import lane_plan as j_lane_plan
from cvr_tpu.ops.spmm_lane import spmm_lane_pack as j_spmm_lane_pack

import cvr_tpu_torch.formats.bsr as tbsr
import cvr_tpu_torch.ops.spmm_pmm as tpmm
from cvr_tpu_torch import _native, cli
from cvr_tpu_torch.formats.bsr import BsrInfeasible, bsr_pack
from cvr_tpu_torch.formats.sell import sell_pack
from cvr_tpu_torch.ops import spmm_lane
from cvr_tpu_torch.ops.spmm_lane import lane_plan, spmm_lane_pack
from torch_cases import (
    banded,
    empty_blocks,
    fem,
    fsm,
    multisegment,
    powerlaw,
    random_rect,
    rmat,
    road,
)


def _same(port, ref, fields):
    for f in fields:
        a, b = getattr(port, f), getattr(ref, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert tuple(a) == tuple(b) if isinstance(b, tuple) else a == b, f


BSR_FIELDS = ("vals", "brick_row", "brick_col", "shape", "nnz")


@pytest.mark.parametrize("case,min_fill", [
    ("banded", 0.005),
    ("fem", 0.005),
    ("random_rect", 0.0),
    ("empty_blocks", 0.0),
])
def test_bsr_pack_matches_reference(case, min_fill, monkeypatch):
    jcoo, tcoo = {
        "banded": lambda: banded(3000, 9),
        "fem": lambda: fem(n=1 << 12, deg=20, bw=150),
        "random_rect": random_rect,
        "empty_blocks": empty_blocks,
    }[case]()
    ref = jbsr.bsr_pack(jcoo.to_csr(), min_fill=min_fill)
    got = bsr_pack(tcoo.to_csr(), min_fill=min_fill)
    _same(got, ref, BSR_FIELDS)
    assert got.nbricks == ref.nbricks and got.padded_nnz == ref.padded_nnz
    # the numpy branch, where the native library is unavailable
    monkeypatch.setattr(_native, "available", lambda: False)
    _same(bsr_pack(tcoo.to_csr(), min_fill=min_fill), ref, BSR_FIELDS)
    # the reference's artifact carried across
    _same(tbsr.from_reference(ref), ref, BSR_FIELDS)


def test_bsr_zero_bricks_for_empty_row_blocks():
    """Rows 0-127 and 640-899 hold nothing: the pack appends one zero
    brick for each of those row blocks (0, 5, 6), sorted in, so that every
    row block has a brick, as in the JAX package."""
    _, tcoo = empty_blocks()
    bm = bsr_pack(tcoo.to_csr(), min_fill=0.0)
    assert set(bm.brick_row.tolist()) == set(range(8))
    assert (np.diff(bm.brick_row) >= 0).all()
    for rb in (0, 5, 6):
        (i,) = np.flatnonzero(bm.brick_row == rb)
        assert bm.brick_col[i] == 0 and not bm.vals[i].any()


def test_bsr_infeasible_on_both_gates():
    _, tcoo = powerlaw(n=3000)
    with pytest.raises(BsrInfeasible, match="brick fill"):
        bsr_pack(tcoo.to_csr())
    _, tcoo = banded(3000, 9)
    with pytest.raises(BsrInfeasible, match="GB dense"):
        bsr_pack(tcoo.to_csr(), max_bytes=1 << 20)
    assert issubclass(BsrInfeasible, ValueError)


LANE_FIELDS = ("cols_l", "vals_l", "emit_l", "ob", "first_pos", "extra_pos",
               "extra_row", "shape", "nnz", "nslices")


@pytest.mark.parametrize("case,split_len", [
    ("powerlaw", None),
    ("rmat_split16", 16),
    ("multisegment", None),
    ("empty_blocks", None),
])
def test_lane_plan_matches_reference(case, split_len):
    jcoo, tcoo = {
        "powerlaw": lambda: powerlaw(n=4000, avg_nnz=8, seed=1),
        "rmat_split16": lambda: rmat(11, 8, 5),
        "multisegment": multisegment,
        "empty_blocks": empty_blocks,
    }[case]()
    ref = j_spmm_lane_pack(jcoo.to_csr(), split_len=split_len)
    got = spmm_lane_pack(tcoo.to_csr(), split_len=split_len)
    _same(got, ref, LANE_FIELDS)
    _same(spmm_lane.from_reference(ref), ref, LANE_FIELDS)
    if split_len:
        assert got.extra_pos.shape[0] > 0  # split rows' extra segments
    # lane_plan on a SELL pack of C 1024 directly
    sm = sell_pack(tcoo.to_csr(), C=1024)
    _same(lane_plan(sm), j_lane_plan(j_sell_pack(jcoo.to_csr(), C=1024)),
          LANE_FIELDS)


def test_lane_table_walks_the_emissions():
    """Each slot's plane-row range is what the reference kernel sums: from
    the row after the previous emission to its own emission row; slots no
    slice fills are empty."""
    _, tcoo = powerlaw(n=4000, avg_nnz=8, seed=1)
    lp = spmm_lane_pack(tcoo.to_csr())
    nslots = -(-lp.nslices // 8) * 8 + 1
    row0, row1 = spmm_lane.lane_table(lp.emit_l, lp.ob, nslots)
    e = np.flatnonzero(lp.emit_l >= 0)
    assert e.shape[0] == lp.nslices
    assert (row1[: lp.nslices] == e + 1).all()
    assert (row0[1 : lp.nslices] == e[:-1] + 1).all() and row0[0] == 0
    assert (row0[lp.nslices :] == row1[lp.nslices :]).all()


PMM_FIELDS = ("win", "rt", "ch", "lc", "val", "rl", "shape", "nnz", "nchunks",
              "npairs", "ncb", "nrt")


@pytest.mark.parametrize("case", ["fsm", "random_rect", "empty_blocks",
                                  "powerlaw"])
def test_pmm_plan_matches_reference(case):
    jcoo, tcoo = {
        "fsm": lambda: fsm(n=1 << 12),
        "random_rect": lambda: random_rect(700, 900, 0.01),
        "empty_blocks": empty_blocks,
        "powerlaw": lambda: powerlaw(n=3000),
    }[case]()
    ref = jpmm.pmm_plan(jcoo.rows, jcoo.cols, jcoo.vals, jcoo.shape)
    got = tpmm.pmm_plan(tcoo.rows, tcoo.cols, tcoo.vals, tcoo.shape)
    _same(got, ref, PMM_FIELDS)
    _same(tpmm.from_reference(ref), ref, PMM_FIELDS)
    assert got.c_mean == ref.c_mean
    for K in (1, 8, 16, 33, 64, 128, 130, 300):
        assert tpmm.pmm_projected_ms(got, K) == jpmm.pmm_projected_ms(ref, K)


@pytest.mark.parametrize("case", ["fsm_sampled", "rmat_sampled",
                                  "powerlaw_whole"])
def test_pmm_estimate_matches_reference(case):
    """Above 256 row tiles both sample the same row tiles (one
    default_rng(seed).choice); below, both count every tile."""
    jcoo, tcoo = {
        "fsm_sampled": lambda: fsm(n=1 << 16),
        "rmat_sampled": lambda: rmat(16, 6, 42),
        "powerlaw_whole": lambda: powerlaw(n=3000),
    }[case]()
    for seed in (0, 3):
        ref = jpmm.pmm_estimate(jcoo.rows, jcoo.cols, jcoo.shape, seed=seed)
        got = tpmm.pmm_estimate(tcoo.rows, tcoo.cols, tcoo.shape, seed=seed)
        assert got == ref
        for K in (8, 32, 128):
            assert (tpmm.pmm_projected_ms(got, K)
                    == jpmm.pmm_projected_ms(ref, K))
    for name in ("NS_PAIR", "NS_CHUNK_EXTRA", "FIXED_US",
                 "NS_ROUTED_PER_ELEM", "NS_LANE_PER_ELEM", "LC_SENTINEL"):
        assert getattr(tpmm, name) == getattr(jpmm, name), name


# the JAX package's SpMM callee -> the port's format name
_REF_FORMAT = {
    "bsr_spmm_pallas": "bsr", "spmm_dia": "dia", "spmm_bell": "bell",
    "spmm_pmm": "pmm", "spmm_lane": "lane", "spmm_routed": "sell-routed",
    "spmm_window": "sell-window",
}


def _reference_pick(jcoo, K, monkeypatch) -> str:
    """The format the JAX package's ``_spmm`` (--format auto) runs: its
    timing call is replaced by one that records the callee."""
    seen = []

    def record(kernel, sd, X, iters=1, **kw):
        seen.append(kernel.__name__)
        return 1.0

    monkeypatch.setattr(jharness, "time_fn_iterated", record)
    args = argparse.Namespace(format="auto", rhs=K, iters=1, no_verify=True,
                              matrix="m", c=None, sigma=0)
    assert jcli._spmm(args, jcoo) == 0
    return _REF_FORMAT[seen[0]]


# matrix, the BSR byte gate of both packages (None: the default), the
# fixed cost of both PMM models (None: the default), the picks at K 8, 128
PICKS = {
    "banded": (lambda: banded(3000, 9), None, None, ("bsr", "bsr")),
    "banded_no_bsr": (lambda: banded(3000, 9), 1 << 20, None,
                      ("dia", "dia")),
    "road_no_bsr": (lambda: road(n=1 << 14, reach=48), 1 << 20, None,
                    ("bell", "bell")),
    "fem_no_bsr": (lambda: fem(n=1 << 13, deg=20, bw=150), 1 << 20, None,
                   ("sell-window", "sell-window")),
    "powerlaw": (lambda: powerlaw(n=3000), None, None,
                 ("sell-routed", "pmm")),
    "powerlaw_pmm_fixed": (lambda: powerlaw(n=3000), None, 1e6,
                           ("sell-routed", "lane")),
    "fsm_no_bsr": (lambda: fsm(n=1 << 15), 1 << 24, None, ("pmm", "pmm")),
}


@pytest.mark.parametrize("case", sorted(PICKS))
def test_cli_auto_pick_matches_reference(case, monkeypatch):
    """``spmm_pick("auto")`` against the JAX CLI's own choice at K 8 and
    128.  Where a case needs another branch at CPU sizes, both packages'
    gates are moved alike: the BSR byte gate (the full-size matrices
    exceed it) or the PMM model's fixed cost (at web scale the lane path
    wins the reference's model at K 128)."""
    make, max_bytes, fixed_us, want = PICKS[case]
    if max_bytes is not None:
        for mod in (jbsr, tbsr):
            monkeypatch.setattr(mod.bsr_pack, "__defaults__",
                                (0.005, max_bytes))
    if fixed_us is not None:
        for mod in (jpmm, tpmm):
            monkeypatch.setattr(mod, "FIXED_US", fixed_us)
    jcoo, tcoo = make()
    for K, w in zip((8, 128), want):
        got, _ = cli.spmm_pick("auto", tcoo, K)
        assert got == _reference_pick(jcoo, K, monkeypatch) == w, K
