"""The routed SpMV without its staged route: K3 and K4 of the port
gathering by indices composed at upload, against the staged chains and
the JAX package.

The TPU stages the route because it gathers only inside VMEM windows: on
the x side the route middle (M1 and the chunk select, K2 on the card)
writes an mstream that the reduce reads through M3 and stage 3; above 1024
tiles the y-route runs stage 1, the middle and stage 3 as passes of their
own (K5, K2, K6, K5).  Every stage is a static map, so the port composes
them at upload: K3 gathers g1 by one int32 index per plane element
(spmv_routed.reduce_plan), K4 the y stream by one per output, at any Tp
(spmv_routed.compose_route); -1 stands where a stage writes 0.  Here, on
the CPU (the wrappers run their plain versions): each composed index
gives its staged chain's output bit for bit, also where a stage writes 0
(planes with out-of-range entries put in on purpose, since a pack's own
planes have none); the routed SpMV on those packs stays within 1e-6 of the
row scale of the JAX package's (Pallas in interpret mode) and of the
float64 golden; the 32-bit checks refuse what the kernels cannot reach;
and the package exports the JAX package's names.
"""

import ast
import dataclasses
import functools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import cvr_tpu
import cvr_tpu.formats as jformats
from cvr_tpu.formats.sell_routed import sell_pack_routed as j_pack_routed
from cvr_tpu.ops.spmv_routed import spmv_routed as j_spmv
from cvr_tpu.ops.spmv_routed import to_device_routed as j_to_device

import cvr_tpu_torch
import cvr_tpu_torch.formats as tformats
from cvr_tpu_torch.formats.sell_routed import from_reference
from cvr_tpu_torch.formats.sell_routed import sell_pack_routed as t_pack_routed
from cvr_tpu_torch.ops import kernels
from cvr_tpu_torch.ops import route_kernels as rk
from cvr_tpu_torch.ops import spmv_routed as tsp
from cvr_tpu_torch.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify
from cvr_tpu_torch.parallel.dist_routed import dist_spmv_routed
from test_torch_route_redesign import _dist_pack
from torch_cases import powerlaw, rmat, tall_sparse

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launches()
    yield
    # CPU tensors: every wrapper ran its plain version
    assert not any(kernels.launches().values())


def _x(n, seed=7):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _named_mstream(sd):
    """The flat mstream positions that sd's slices read (reduce_index over
    the rows its slice table names)."""
    m3 = sd.mid.m3 if sd.mid.kind == "rec" else sd.mid.mid
    idx = rk.reduce_index(m3, sd.p3, sd.red_row0, sd.red_row1, sd.red_fast)
    _, rows = rk.slice_rows(sd.red_row0, sd.red_row1)
    return torch.unique(idx[:, rows, :].long())


def _with_sentinels(sr):
    """The JAX pack sr (recursive middle) with every 97th mstream element
    that a slice reads given a chunk select outside [0, Tk) (-1 and Tk by
    turns): the route middle writes 0 there."""
    sd = tsp.to_device_routed(from_reference(sr), "cpu")
    pos = _named_mstream(sd)[::97].numpy()
    csel = sr.mid["csel"].copy()
    csel.reshape(-1)[pos] = np.where(np.arange(pos.shape[0]) % 2, -1,
                                     sr.mid["Tk"])
    return dataclasses.replace(sr, mid={**sr.mid, "csel": csel})


@functools.cache
def _packs():
    """name -> (JAX pack, the port's device artifact on the CPU, the
    port's COO): a recursive x middle (T 2048), the same with chunk
    selects out of range, and a flat x middle."""
    (jrec, trec), (jflat, tflat) = rmat(17, 8, 4), powerlaw(n=3000, seed=3)
    rec = j_pack_routed(jrec.to_csr(), hot="off")
    flat = j_pack_routed(jflat.to_csr(), hot="off")
    packs = {"rec": (rec, trec), "rec_sentinels": (_with_sentinels(rec), trec),
             "flat": (flat, tflat)}
    return {k: (sr, tsp.to_device_routed(from_reference(sr), "cpu"), coo)
            for k, (sr, coo) in packs.items()}


def _staged_ys(sd, g1):
    """K3's sums as the TPU stages them: the route middle's mstream
    (``middle``), then M3, stage 3, the values and the slice sums
    (reduce_products_plain), summed as the plain version sums."""
    m, m3 = tsp.middle(sd, g1)
    item, rows = rk.slice_rows(sd.red_row0, sd.red_row1)
    P = rk.reduce_products_plain(m, m3, sd.vals_ss, sd.p3, rows,
                                 sd.red_fast.bool()[item])
    return rk.slice_sums(P, item, sd.red_out, sd.nslices)


def _x_side(sd, x):
    g1 = rk.expand(sd.w8, sd.gcls, sd.seg_blk, sd.li, torch.from_numpy(x),
                   sd.segw, sd.n_segs)
    assert torch.equal(tsp.reduce(sd, g1), _staged_ys(sd, g1))


# ---------------------------------------------------------------------------
# the x side: K3's index composed through the route middle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["rec", "rec_sentinels", "flat"])
def test_x_side_fold_is_the_staged_chain(case):
    """K3's plain gather of g1 by the composed index equals the staged
    chain (route middle, M3, stage 3, values, sums) bit for bit."""
    sr, sd, _ = _packs()[case]
    assert sd.mid.kind == ("flat" if case == "flat" else "rec")
    named = _named_mstream(sd)
    zero = tsp.mstream_source(sd.mid).reshape(-1)[named] < 0
    item, rows = rk.slice_rows(sd.red_row0, sd.red_row1)
    in_plan = int((sd.red_plan.idx[:, rows, :] < 0).sum())
    if case == "rec_sentinels":  # elements the slices read come out 0
        assert int(zero.sum()) == named[::97].shape[0] and in_plan > 0
    else:
        assert not zero.any() and in_plan == 0
    _x_side(sd, _x(sr.shape[1]))


def test_x_side_fold_on_forced_shards():
    """Every shard of the forced 4-shard pack (a slice of hundreds of
    plane rows on each)."""
    dm = _dist_pack()
    x = _x(dm.shape[1], seed=2)
    for sd in dm.shards:
        _x_side(sd, x)


# ---------------------------------------------------------------------------
# the y side: K4's index composed through the whole route, any Tp
# ---------------------------------------------------------------------------


@functools.cache
def _tall_y_route():
    """The y-route of test_slice_over_1024_y_tiles_matches_reference's
    pack: 2048 tiles, the recursive middle."""
    ra = t_pack_routed(tall_sparse()[1].to_csr(), hot="off").y_ra
    assert ra["Tp"] == 2048 and ra["mid_planes"]["kind"] == "rec"
    return ra


def _y_sentinels(ra):
    """ra with entries outside their range in each stage: stage 1 and 3
    positions past a tile and below 0, chunk selects past Tk, M3 sources
    past a slab."""
    rng = np.random.default_rng(21)
    mp = dict(ra["mid_planes"])
    out = {**ra, "mid_planes": mp}
    for planes, key, bad in ((out, "s1", (-1, 1024)), (out, "s3", (-3, 2000)),
                             (mp, "csel", (-1, mp["Tk"])),
                             (mp, "m3", (-2, 1024))):
        a = planes[key].copy()
        pos = rng.choice(a.size, 200, replace=False)
        a.reshape(-1)[pos] = np.resize(bad, 200)
        planes[key] = a
    return out


@pytest.mark.parametrize("case", ["tall", "tall_sentinels"])
def test_y_side_compose_is_the_staged_chain(case):
    """K4's plain gather by the composed index equals stage 1, the
    middle (route_middle, route_m3), stage 3 and the flatten bit for
    bit, on the 2048-tile y-route and on it with out-of-range entries in
    each stage."""
    ra = _tall_y_route()
    if case == "tall_sentinels":
        ra = _y_sentinels(ra)
    rd = tsp.route_to_device(ra, "cpu", compose=True)
    assert rd.src.dtype == torch.int32 and rd.src.shape == (ra["n"],)
    assert tsp.route_to_device(ra, "cpu").src is None  # staged by default
    ysp = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, ra["Tp"], 128)).astype(np.float32))
    got = tsp.apply_route_stream(rd, ysp)
    want = tsp.staged_route(rd, ysp)
    assert torch.equal(got, want)
    zeros = int((rd.src < 0).sum())
    if case == "tall":  # a permutation: every output has its source
        assert zeros == 0
        assert torch.unique(rd.src).shape[0] == ra["n"]
    else:
        assert zeros > 0 and not got[rd.src < 0].any()


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["rec", "rec_sentinels", "flat"])
def test_slice_matches_reference(case):
    """spmv_routed on the packs above against the JAX package's
    spmv_routed on the same planes, and (but where chunk selects were
    put out of range: another matrix then) the float64 golden."""
    sr, sd, coo = _packs()[case]
    x = _x(sr.shape[1])
    y = tsp.spmv_routed(sd, torch.from_numpy(x)).numpy()
    y_jax = np.asarray(jax.jit(j_spmv)(j_to_device(sr), x))
    csr = coo.to_csr()
    scale = spmv_row_scale(csr, x)
    ok, nbad, maxrel = verify(y, y_jax, rtol=1e-6, row_scale=scale)
    assert ok, f"JAX spmv_routed: {nbad} bad rows, max rel {maxrel}"
    if case != "rec_sentinels":
        ok, nbad, maxrel = verify(y, spmv_golden_numpy(csr, x), rtol=1e-6,
                                  row_scale=scale)
        assert ok, f"golden: {nbad} bad rows, max rel {maxrel}"


def test_forced_shards_against_golden():
    """The forced 4-shard pack's SpMV, x replicated, at the golden."""
    dm = _dist_pack()
    coo = powerlaw(n=3000, seed=3)[1]
    x = _x(dm.shape[1], seed=2)
    y = dist_spmv_routed(dm, torch.from_numpy(x)).numpy()
    csr = coo.to_csr()
    ok, nbad, maxrel = verify(y, spmv_golden_numpy(csr, x), rtol=1e-6,
                              row_scale=spmv_row_scale(csr, x))
    assert ok, f"{nbad} bad rows, max rel {maxrel}"


# ---------------------------------------------------------------------------
# what 32-bit indices cannot reach
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Tp, n", [
    (1024, 1024 * 1024),
    (2048, 2_097_152),  # fsm-like's and wiki-Talk-like's y-routes
    (2**21 - 1, 5),  # 8*Tp*128 just below 2^31
])
def test_route_small_geometry_takes(Tp, n):
    rk.route_small_geometry(Tp, n)


@pytest.mark.parametrize("Tp, n, what", [
    (2**21, 8, "32-bit"),  # 8*Tp*128 = 2^31
    (1024, 1024 * 1024 + 1, "outputs"),
    (1024, -1, "outputs"),
])
def test_route_small_geometry_refuses(Tp, n, what):
    with pytest.raises(ValueError, match=what):
        rk.route_small_geometry(Tp, n)


def test_compose_route_refuses_a_wide_stream():
    """The upload refuses a y-route whose stream K4 cannot index (meta
    tensors: nothing is computed)."""
    s = torch.empty((8, 2**21, 128), dtype=torch.int16, device="meta")
    mid = tsp.RouteMidDevice(kind="rec", Tk=2048, m1=s, csel=s, m3=s)
    with pytest.raises(ValueError, match="32-bit"):
        tsp.compose_route(s, mid, s, 2**21, 8)


@pytest.mark.parametrize("T, ok", [(2**21 - 1, True), (2**21, False)])
def test_reduce_geometry_checks_g1(T, ok):
    """K3 reads g1 in place of the mstream: its rows take the check."""
    if ok:
        rk.reduce_geometry(1024, T, 8, 0)
    else:
        with pytest.raises(ValueError, match="g1"):
            rk.reduce_geometry(1024, T, 8, 0)


# ---------------------------------------------------------------------------
# the package's names
# ---------------------------------------------------------------------------

# names of the JAX package's __all__ the port gives under another name
RENAMED = {"spmv_csr_jnp": "spmv_csr_torch"}
# the JAX formats package's names not ported yet
FORMATS_GAPS = {"sell_unpack"}


def test_package_exports_the_reference_names():
    want = [RENAMED.get(n, n) for n in cvr_tpu.__all__]
    assert cvr_tpu_torch.__all__ == want
    for name in want:
        assert callable(getattr(cvr_tpu_torch, name)), name


def test_formats_export_the_reference_names():
    want = [n for n in jformats.__all__ if n not in FORMATS_GAPS]
    assert tformats.__all__ == want
    assert set(jformats.__all__) - set(want) == FORMATS_GAPS
    for name in want:
        assert callable(getattr(tformats, name)), name
        assert getattr(tformats, name) is getattr(cvr_tpu_torch, name, None) \
            or name not in cvr_tpu_torch.__all__


def _imported(path):
    """The top-level module names a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_neither_jax_nor_the_reference():
    files = [*sorted((REPO / "cvr_tpu_torch").rglob("*.py")),
             REPO / "chip_smoke.py"]
    bad = {str(p.relative_to(REPO)): sorted(_imported(p) & {"jax", "cvr_tpu"})
           for p in files}
    assert not {k: v for k, v in bad.items() if v}
