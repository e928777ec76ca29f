"""K3 (reduce_slices) by the x plan against K1 (expand) followed by K3 by
the g1 plan, bit for bit.

The upload composes K1's window map into K3's index (rk.expand_source,
rk.reduce_plan_x), so the routed SpMV's K3 gathers x itself and K1 is not
launched.  The pieces, the rows and the products are the same, so the
sums are the same bits: here on the CPU by the plain versions, and on a
card by the kernels (those cases skip without one).  Covered: zone A
(aligned stage 3) and zone B, hot planes, split-row extras, two x
segments, a forced row shard; x shorter and longer than the pack's
columns, and x carrying +-inf at columns that only pads name.  The
row-sharded ring keeps K15 and the g1 plan.

This file imports nothing of JAX, so that its card cases run where the
JAX package is not installed.
"""

import dataclasses
import functools

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


# name -> (matrix, split_len, hot-plane switches); the dist shard is
# shard 1 of a forced 4-shard pack of the power-law matrix
CASES = {
    "powerlaw": (_powerlaw, None, {}),
    "uniform_w16": (tsyn.uniform_rows, None, {}),  # zone A slices
    "rmat_split16": (lambda: tsyn.rmat_matrix(scale=10, edge_factor=12,
                                              seed=5, cache=False), 16, {}),
    "empty_rows_cols": (tsyn.empty_rows_cols, 16, {}),
    "hot": (lambda: tsyn.rmat_matrix(scale=12, edge_factor=8, seed=4,
                                     cache=False), None,
            {"CVR_HOT": "1", "CVR_HOT_NH": "128"}),
    "multisegment": (tsyn.multisegment, None, {}),
    "dist_shard": (lambda: _powerlaw(seed=3), None, {}),
}
DEVICES = ["cpu", "cuda"]


def _device(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels' variant of the case")
    return torch.device(device)


@functools.cache
def _host(case):
    """(the case's COO, the host artifact: one routed pack or, for
    dist_shard, the DistRoutedMatrix's planes are packed per device)."""
    make, split_len, env = CASES[case]
    coo = make()
    if case == "dist_shard":
        return coo, None
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        sr = sell_pack_routed(coo.to_csr(), split_len=split_len,
                              hot="auto" if env else "off")
    if env:
        assert sr.hot is not None
    return coo, sr


@functools.cache
def _upload(case, device):
    coo, sr = _host(case)
    if sr is None:
        dm = tdr.dist_routed_pack(coo.to_csr(), tdist.make_mesh(
            devices=[device] * 4))
        return coo, dm.shards[1]
    return coo, sp.to_device_routed(sr, device)


def _x(ncols, seed=1, n=None):
    x = np.random.default_rng(seed).standard_normal(
        ncols if n is None else n).astype(np.float32)
    return torch.from_numpy(x)


def _bits(t):
    """A float tensor's bits: NaN payloads compared too."""
    return t.contiguous().view(torch.int32).cpu()


def _g1_chain(sd, x):
    """ys by K1 (expand) and K3 by the g1 plan: the routed SpMV's chain
    before the x plan."""
    g1 = rk.expand(sd.w8, sd.gcls, sd.seg_blk, sd.li, x, sd.segw,
                   sd.n_segs)
    plan = sp.g1_plan(sd)
    assert plan.source == "g1"
    return g1, sp.reduce(sd, g1, plan)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_x_plan_equals_expand_then_g1_plan(case, device):
    """ys of K3 by the x plan equals K1 then K3 by the g1 plan bit for bit,
    and on the CPU so does the whole SpMV (on the card the split-row
    extras are added by atomics)."""
    dev = _device(device)
    coo, sd = _upload(case, device)
    assert sd.red_plan.source == "x" and sd.red_plan_g1 is None
    x = _x(coo.shape[1]).to(dev)
    kernels.reset_launches()
    ys = sp.reduce(sd, x)
    assert kernels.launches()["expand"] == 0
    g1, want = _g1_chain(sd, x)
    assert torch.equal(_bits(ys), _bits(want))
    assert bool(ys.any())
    if dev.type == "cpu":
        y = sp.spmv_routed(sd, x)
        assert torch.equal(_bits(y), _bits(sp.reduce_and_route(sd, g1, x)))


def _pad_only_columns(sd):
    """Columns of x that the x plan names only where the value is 0 (the
    pads), and never at a stored entry."""
    _, rows = rk.slice_rows(sd.red_plan.row0, sd.red_plan.row1)
    idx = sd.red_plan.idx[:, rows].reshape(-1).long().cpu()
    vals = sd.vals_ss[:, rows].reshape(-1).cpu()
    named = idx >= 0
    real = torch.unique(idx[named & (vals != 0)])
    pads = torch.unique(idx[named & (vals == 0)])
    return pads[~torch.isin(pads, real)]


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("xform", ["shorter", "longer", "inf_at_pads"])
@pytest.mark.parametrize("case", ["empty_rows_cols", "multisegment"])
def test_x_plan_reads_what_k1_reads(case, xform, device):
    """An x shorter than the pack's columns (read as 0 past its end),
    longer (its tail never named), or carrying +-inf at the columns only
    pads name (0 * inf gives NaN in both chains): K3 by the x plan
    equals K1 then K3 by the g1 plan, bit for bit."""
    dev = _device(device)
    coo, sd = _upload(case, device)
    ncols = coo.shape[1]
    if xform == "shorter":
        x = _x(ncols, n=ncols - ncols // 5)
    elif xform == "longer":
        x = _x(ncols, n=ncols + 3000)
        x[ncols:] = torch.where(torch.arange(3000) % 2 == 0, torch.inf,
                                -torch.inf)
    else:
        x = _x(ncols)
        cols = _pad_only_columns(sd)
        assert cols.numel()
        x[cols] = torch.where(cols % 2 == 0, torch.inf, -torch.inf)
    x = x.to(dev)
    ys = sp.reduce(sd, x)
    _, want = _g1_chain(sd, x)
    assert torch.equal(_bits(ys), _bits(want))
    assert bool(ys.isnan().any()) == (xform == "inf_at_pads")


@pytest.mark.parametrize("case", ["powerlaw", "hot", "multisegment"])
def test_expand_source_is_k1s_map(case):
    """rk.expand_source, for each element of g1, names the column that
    K1's plain version copies there: source_index of expand_plain, -1
    where K1 writes 0."""
    _, sd = _upload(case, "cpu")
    col = rk.expand_source(sd.w8, sd.gcls, sd.seg_blk, sd.li, sd.segw)
    n = (sd.n_segs * sd.segw * 8 + 8) * 128
    want = rk.source_index(lambda v: rk.expand_plain(
        sd.w8, sd.gcls, sd.seg_blk, sd.li, v, sd.segw, sd.n_segs), (n,),
        "cpu")
    assert torch.equal(col, want)
    assert int(col.max()) < n
    gcls = sd.gcls.clone()
    gcls[::2] = 0  # a class of 0: K1 writes 0 over the whole tile group
    col = rk.expand_source(sd.w8, gcls, sd.seg_blk, sd.li, sd.segw)
    want = rk.source_index(lambda v: rk.expand_plain(
        sd.w8, gcls, sd.seg_blk, sd.li, v, sd.segw, sd.n_segs), (n,), "cpu")
    assert torch.equal(col, want) and bool((col < 0).any())


@pytest.mark.parametrize("device", DEVICES)
def test_gather_class_cuts_read_zero(device):
    """Where the gather class cuts a tile group's window (none of the
    packs here does: they give every tile the class its offsets need),
    K1 writes 0 and the x plan's index is -1: with the classes lowered on
    every other tile group, K3 by the x plan composed through the lowered
    classes equals K1 by them then K3 by the g1 plan, bit for bit."""
    dev = _device(device)
    coo, sd = _upload("powerlaw", device)
    gcls = sd.gcls.clone()
    gcls[::2] = (gcls[::2] - 1).clamp(min=0)
    cut = dataclasses.replace(sd, gcls=gcls)
    col = rk.expand_source(cut.w8, cut.gcls, cut.seg_blk, cut.li, cut.segw)
    assert bool((col < 0).any())
    plan = rk.reduce_plan_x(sp.g1_plan(cut), col)
    x = _x(coo.shape[1]).to(dev)
    ys = sp.reduce(cut, x, plan)
    _, want = _g1_chain(cut, x)
    assert torch.equal(_bits(ys), _bits(want))
    assert not torch.equal(_bits(ys), _bits(sp.reduce(sd, x)))


def test_reduce_plan_x_refuses_columns_past_32_bits():
    plan = rk.ReducePlan(
        idx=torch.tensor([0, 1, -1], dtype=torch.int32).view(1, 3, 1),
        split=rk.make_split(*(torch.zeros(1, dtype=torch.int32),) * 3, 16,
                            "cpu"),
        T=1, row0=None, row1=None, out=None)
    col = torch.full((8, 1, 128), 5, dtype=torch.int64)
    x_plan = rk.reduce_plan_x(plan, col)
    assert x_plan.source == "x" and x_plan.idx.tolist() == [[[5], [5], [-1]]]
    col[0, 0, 1] = rk.INT32_MAX + 1
    with pytest.raises(ValueError, match="32-bit"):
        rk.reduce_plan_x(plan, col)
    with pytest.raises(ValueError, match="g1 plan"):
        rk.reduce_plan_x(x_plan, col)


def test_reduce_slices_refuses_the_other_source():
    """The wrapper refuses a g1 given to an x plan and an x given to a g1
    plan."""
    coo, sd = _upload("powerlaw", "cpu")
    x = _x(coo.shape[1])
    g1 = rk.expand(sd.w8, sd.gcls, sd.seg_blk, sd.li, x, sd.segw,
                   sd.n_segs)
    with pytest.raises(ValueError, match="indexes x"):
        rk.reduce_slices(g1, sd.vals_ss, sd.red_plan, sd.nslices)
    with pytest.raises(ValueError, match="indexes g1"):
        rk.reduce_slices(x, sd.vals_ss, sp.g1_plan(sd), sd.nslices)


def test_spmv_records_the_reduce_from_x():
    """A product records routed.reduce with the detail "x" and no
    routed.expand."""
    coo, sd = _upload("hot", "cpu")
    prof.reset()
    with prof.recording():
        sp.spmv_routed(sd, _x(coo.shape[1]))
    got = [(s.name, s.detail) for s in prof.record()]
    assert got == [("routed.reduce", "x"), ("routed.y", None)]


@functools.cache
def _ring(device):
    coo = _powerlaw(seed=3)
    mesh = tdist.make_mesh(devices=[device] * 2)
    return coo, tdr.dist_routed_pack(coo.to_csr(), mesh, overlap=True)


@pytest.mark.parametrize("device", DEVICES)
def test_ring_runs_k15_and_the_g1_plan(device, monkeypatch):
    """The overlap ring's shards carry the g1 plan beside the x plan; the
    ring expands by K15 into g1 and reduces by the g1 plan, the
    replicated and gathered modes reduce from x, and the ring's y equals
    theirs (bit for bit on the CPU)."""
    dev = _device(device)
    coo, dm = _ring(device)
    for sd in dm.shards:
        assert sd.red_plan.source == "x" and sd.red_plan_g1.source == "g1"
        assert sp.g1_plan(sd) is sd.red_plan_g1
    x = _x(coo.shape[1], seed=4).to(dev)
    steps = []
    ring_step = tdr.expand_ring
    monkeypatch.setattr(tdr, "expand_ring",
                        lambda *a: steps.append(a) or ring_step(*a))
    ys = {}
    for mode, kw in (("ring", dict(x_sharded=True, overlap=True)),
                     ("replicated", {}), ("gathered", dict(x_sharded=True))):
        prof.reset()
        with prof.recording():
            ys[mode] = tdr.dist_spmv_routed(dm, x, **kw)
        details = {s.detail for s in prof.record()
                   if s.name == "routed.reduce"}
        assert details == {"g1" if mode == "ring" else "x"}, mode
        assert bool(steps) == (mode == "ring"), mode
        steps.clear()
    if dev.type == "cpu":
        assert torch.equal(_bits(ys["ring"]), _bits(ys["replicated"]))
        assert torch.equal(_bits(ys["ring"]), _bits(ys["gathered"]))
    else:
        scale = tdr.dist_spmv_routed(dm, x.abs()).abs() + 1e-30
        assert bool(((ys["ring"] - ys["replicated"]).abs()
                     <= 1e-6 * scale).all())


def test_only_ring_artifacts_keep_the_g1_plan():
    """A plain pack and a forced shard without the ring schedule carry
    the x plan only (g1_plan composes one on request); a ring-scheduled
    shard keeps its g1 plan, the same pieces as its x plan."""
    _, sd = _upload("powerlaw", "cpu")
    assert sd.red_plan_g1 is None
    _, shard = _upload("dist_shard", "cpu")
    assert shard.red_plan_g1 is None
    _, dm = _ring("cpu")
    for s in dm.shards:
        assert s.red_plan_g1.split is s.red_plan.split
        col = rk.expand_source(s.w8, s.gcls, s.seg_blk, s.li, s.segw)
        assert torch.equal(rk.reduce_plan_x(s.red_plan_g1, col).idx,
                           s.red_plan.idx)
