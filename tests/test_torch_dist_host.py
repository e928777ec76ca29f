"""The row-sharded routed pack of the port against the JAX package's.

For D 2, 4 and 8 shards, the port's forced pack (the all-gather modes)
and ring pack (the overlapped expand) must build the JAX package's arrays
shard for shard: every plane, the y-route, the split-row extras and the
ring schedule (seg_ring, ring_cnt, ring_nsegtab).  The forced-geometry
errors must raise as the JAX package's do.  JAX packs on its 8-device
CPU mesh; the port's mesh is ``["cpu"] * D``.
"""

import types

import numpy as np
import pytest

import cvr_tpu.parallel.dist_routed as jdr
from cvr_tpu.formats import sell_routed as jsr
from cvr_tpu.formats.sell import sell_pack as j_sell_pack
from cvr_tpu.parallel.dist import make_mesh as j_make_mesh
from cvr_tpu.parallel.partition import partition_rows_by_nnz as j_partition

import cvr_tpu_torch.parallel.dist_routed as tdr
from cvr_tpu_torch.formats import sell_routed as tsr
from cvr_tpu_torch.formats.sell import sell_pack as t_sell_pack
from cvr_tpu_torch.ops import route_planes as tpr
from cvr_tpu_torch.parallel.dist import make_mesh as t_make_mesh
from cvr_tpu_torch.parallel.partition import (
    partition_balance,
    partition_rows_by_nnz as t_partition,
)
from torch_cases import (
    banded,
    multisegment,
    multisegment_tail,
    powerlaw,
    random_rect,
    rmat,
    stacked_rows,
)

SKIP = ("convert_time", "convert_phases")

MATRICES = {
    "powerlaw": lambda: powerlaw(n=2000, avg_nnz=4, seed=3),
    # 700 columns: not a multiple of 128 * D for any D here
    "random_rect": random_rect,
    "multisegment": multisegment,
}


def _same(a, b, path):
    """Deep equality: arrays bit for bit (dtype and shape too)."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _capture(monkeypatch, module) -> dict:
    """Record the per-shard artifacts the module's dist pack assembles."""
    got = {}
    finish = module._dist_routed_finish

    def capture(csr, mesh, bounds, srs, *args, **kwargs):
        got["srs"] = srs
        return finish(csr, mesh, bounds, srs, *args, **kwargs)

    monkeypatch.setattr(module, "_dist_routed_finish", capture)
    return got


def _check_dist_pack(jcoo, tcoo, D, overlap, monkeypatch):
    jcsr, tcsr = jcoo.to_csr(), tcoo.to_csr()
    jgot, tgot = _capture(monkeypatch, jdr), _capture(monkeypatch, tdr)
    jdm = jdr.dist_routed_pack(jcsr, j_make_mesh(D), overlap=overlap)
    tdm = tdr.dist_routed_pack(tcsr, t_make_mesh(devices=["cpu"] * D),
                               overlap=overlap)
    for i, (js, ts) in enumerate(zip(jgot["srs"], tgot["srs"], strict=True)):
        for k in tsr._FIELDS:
            if k not in SKIP:
                _same(getattr(js, k), getattr(ts, k), f"shard {i}: {k}")
        assert ts.hot is None and ts.nslA == 0
    _same(jdm.meta, tdm.meta, "meta")
    _same(np.asarray(jdm.bounds), tdm.bounds, "bounds")
    np.testing.assert_array_equal(np.asarray(jdm.unpad_index),
                                  stacked_rows(tdm.bounds, tdm.rows_max))
    assert set(tdm.planes[0]) == set(jdm.planes) - {"gemit"}
    for k, v in jdm.planes.items():
        if k != "gemit":
            for i in range(D):
                _same(np.asarray(v)[i], tdm.planes[i][k], f"shard {i}: {k}")
    assert tdm.rows_max == jdm.rows_max and tdm.shape == jdm.shape
    if overlap:
        assert {"ring_schedule", "route_plan"} <= set(tdm.convert_phases)
        assert sum(tdm.meta["ring_cnt"]) * tpr.TB == tdm.meta["T"]
    return tdm


def _ring_k_lo(tdm):
    """(shard, step) pairs whose ring step expands blocks at a table base
    above segment 0."""
    D, m = tdm.n_shards, tdm.meta
    return [
        (i, s) for i in range(D) for s in range(D)
        if m["ring_cnt"][s] and tsr.ring_table_base(
            tsr.RingSpec(D, i, m["ring_Wr"], m["ring_cnt"]), m["segw"])[s]
    ]


@pytest.mark.parametrize("case,D", [
    ("powerlaw", 2), ("powerlaw", 4), ("powerlaw", 8),
    ("random_rect", 2), ("random_rect", 4), ("random_rect", 8),
    # two x segments; only at 8 shards does a ring piece start past column
    # 1,048,576, so that a step's table starts at segment 1
    ("multisegment", 8),
])
def test_dist_pack_matches_reference(case, D, monkeypatch):
    jcoo, tcoo = MATRICES[case]()
    _check_dist_pack(jcoo, tcoo, D, False, monkeypatch)
    tdm = _check_dist_pack(jcoo, tcoo, D, True, monkeypatch)
    assert sum(c > 0 for c in tdm.meta["ring_cnt"]) > 1  # several steps
    if case == "multisegment":
        assert tdm.meta["n_segs"] == 2 and _ring_k_lo(tdm)


def test_dist_pack_tail_columns_match_reference(monkeypatch):
    """Every entry in the last ring piece at 8 shards: real blocks expand
    at steps whose table starts at segment 1."""
    tdm = _check_dist_pack(*multisegment_tail(), 8, True, monkeypatch)
    hits = _ring_k_lo(tdm)
    # shard 0 reads piece 7 only; it arrives at step 1, table base 1
    assert (0, 1) in hits
    off = np.concatenate([[0], np.cumsum(tdm.meta["ring_cnt"])])
    w8 = tdm.planes[0]["w8"].reshape(-1, tpr.TB)[off[1] : off[2]]
    assert (w8 > 0).any()  # real windows, not only fillers


@pytest.mark.parametrize("case", ["powerlaw", "mega_row", "empty", "tiny"])
def test_partition_matches_reference(case):
    rng = np.random.default_rng(3)
    lens = {
        "powerlaw": np.minimum(rng.zipf(1.8, 5000), 4000),
        # one row holds most of the nnz: later cuts collapse onto it
        "mega_row": np.r_[np.ones(100), [100_000], np.ones(300)],
        "empty": np.zeros(50),
        "tiny": np.array([3, 0, 5]),
    }[case].astype(np.int64)
    rowptr = np.concatenate([[0], np.cumsum(lens)])
    for n_parts in (1, 2, 4, 8, 16):
        jb, tb = j_partition(rowptr, n_parts), t_partition(rowptr, n_parts)
        _same(np.asarray(jb), tb, f"{case} / {n_parts}")
        assert (np.diff(tb) >= 0).all() and tb[-1] == rowptr.shape[0] - 1
        bal = partition_balance(rowptr, tb)
        assert bal["part_nnz"].sum() == rowptr[-1]
    with pytest.raises(ValueError, match="n_parts"):
        t_partition(rowptr, 0)


def test_ring_unlock_wrap_table_base():
    """A 16-row window straddling a segment boundary can need the
    last-arriving piece (i+1, unlock D-1) while sitting in a lower segment
    than that piece's: the last step's table base must be 0.  D 16, Wr
    1024, segw8 8192, shard 7, a block window on rows 8184..8199 of
    segment 0 (pieces 7 and 8), as in the JAX package's test."""
    D, Wr, shard, segw8 = 16, 1024, 7, 8192
    nblk = 2
    st = types.SimpleNamespace(
        segw=segw8 // 8,
        seg_blk=np.zeros(nblk, dtype=np.int32),
        w8=np.zeros(nblk * tpr.TB, dtype=np.int32),
        T_src_p=nblk * tpr.TB,
    )
    st.w8[0] = (8184 // 8) << 3
    cnt = tuple([nblk] * D)
    t_unlock = tsr.ring_block_unlock(st, tsr.RingSpec(D, shard, Wr, cnt))
    j_unlock = jsr.ring_block_unlock(st, jsr.RingSpec(D, shard, Wr, cnt))
    _same(j_unlock, t_unlock, "unlock")
    assert t_unlock[0] == D - 1
    k_lo = tsr.ring_table_base(tsr.RingSpec(D, shard, Wr, cnt), segw8 // 8)
    assert k_lo[D - 1] == 0 and st.seg_blk[0] - k_lo[t_unlock[0]] >= 0
    # earlier steps start at the segment of the piece that arrives
    p = (shard - np.arange(D)) % D
    np.testing.assert_array_equal(k_lo[:-1], (p * Wr // segw8)[:-1])


def _forced_error(pkg, sm, case):
    """Run the failing call of ``case`` through package ``pkg``'s pack."""
    sr, RF, RS = pkg
    nat = sr.routed_stream_phase(sm, sr.RoutedForce())
    n_g = max(1, -(-nat.nslices_u // tpr.YB))
    if case == "nslices":
        return sr.pack_routed(sm, force=RF(nslices=nat.nslices_u - 1))
    if case == "rcp_low":
        return sr.pack_routed(sm, force=RF(rcp=np.zeros(n_g, np.int64)))
    if case == "rcp_groups":
        return sr.pack_routed(sm, force=RF(rcp=np.full(n_g + 1, 1 << 20)))
    if case == "T":
        return sr.pack_routed(sm, force=RF(T=nat.T - tpr.TB))
    if case == "nrows_out":
        return sr.pack_routed(sm, force=RF(nrows_out=sm.shape[0] - 1))
    if case == "n_extras":
        return sr.pack_routed(sm, force=RF(n_extras=sm.n_splits - 1))
    if case == "ring_cnt":
        st = sr.routed_stream_phase(sm, RF())
        return sr.pack_routed(sm, force=RF(), stream=st,
                              ring=RS(2, 0, 8, np.zeros(2, np.int64)))
    if case == "ring_zone":
        st = sr.routed_stream_phase(sm)
        assert st.zone is not None
        return sr.pack_routed(sm, stream=st,
                              ring=RS(2, 0, 8, np.full(2, 64)))
    return sr._check_T(99 * 1024)


@pytest.mark.parametrize("case", [
    "nslices", "rcp_low", "rcp_groups", "T", "nrows_out", "n_extras",
    "ring_cnt", "ring_zone", "T_cap",
])
def test_force_errors_match_reference(case):
    if case == "ring_zone":
        jcoo, tcoo = banded()
    else:  # split rows (extras) and two reduce groups' worth of T
        jcoo, tcoo = rmat(12, 12, 5)
    split = None if case == "ring_zone" else 64
    jsm = j_sell_pack(jcoo.to_csr(), C=1024, split_len=split)
    tsm = t_sell_pack(tcoo.to_csr(), C=1024, split_len=split)
    assert tsm.n_splits > 0 or case == "ring_zone"
    errs = []
    for pkg, sm in (((jsr, jsr.RoutedForce, jsr.RingSpec), jsm),
                    ((tsr, tsr.RoutedForce, tsr.RingSpec), tsm)):
        with pytest.raises(ValueError) as e:
            _forced_error(pkg, sm, case)
        errs.append(str(e.value))
    # the same refusal; the cap's advice names each package's own module
    assert errs[0].replace("cvr_tpu.", "cvr_tpu_torch.") == errs[1]


def test_overlap_needs_two_shards():
    _, tcoo = powerlaw(n=500, seed=1)
    with pytest.raises(ValueError, match=">= 2 devices"):
        tdr.dist_routed_pack(tcoo.to_csr(), t_make_mesh(devices=["cpu"]),
                             overlap=True)
