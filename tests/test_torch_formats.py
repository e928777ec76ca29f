"""pack_auto's formats in the port against the JAX package's, array for
array: DIA, BELL (with its routed spill), SELL-W and the dispatch itself,
their infeasibility gates, and the numpy fills against the native ones.
"""

import dataclasses

import numpy as np
import pytest

import cvr_tpu.ops.pallas_window as jpw
from cvr_tpu.formats import pack_auto as j_pack_auto
from cvr_tpu.formats.bell import BellInfeasible as JBellInfeasible
from cvr_tpu.formats.bell import bell_pack as j_bell_pack
from cvr_tpu.formats.dia import DiaInfeasible as JDiaInfeasible
from cvr_tpu.formats.dia import dia_pack as j_dia_pack
from cvr_tpu.formats.sell_window import WindowInfeasible as JWindowInfeasible
from cvr_tpu.formats.sell_window import sell_pack_window as j_pack_window

import cvr_tpu_torch.formats as tformats
import cvr_tpu_torch.ops.route_planes as tpr
from cvr_tpu_torch import _native
from cvr_tpu_torch.bench import synthetic as tsyn
from cvr_tpu_torch.formats import pack_auto as t_pack_auto
from cvr_tpu_torch.formats import sell_routed
from cvr_tpu_torch.formats.bell import BellInfeasible, BellMatrix, bell_pack
from cvr_tpu_torch.formats.dia import DiaInfeasible, DiaMatrix, dia_pack
from cvr_tpu_torch.formats.sell import SellMatrix, sell_pack
from cvr_tpu_torch.formats.sell_routed import _FIELDS, SellRouted
from cvr_tpu_torch.formats.sell_window import (
    SellWindow,
    WindowInfeasible,
    sell_pack_window,
)
from cvr_tpu_torch.ops.spmv import spmv
from cvr_tpu_torch.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify
from torch_cases import (
    WINDOW_CASES,
    banded,
    diagonals,
    fem,
    powerlaw,
    rgg,
    road,
    same_arrays,
)

SKIP = ("convert_time", "convert_phases")


def _same(a, b, path):
    """Deep equality: arrays bit for bit (dtype and shape too), packed
    artifacts field by field."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if f.name not in SKIP:
                _same(getattr(a, f.name), getattr(b, f.name),
                      f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _same_routed(t, j, path):
    for k in _FIELDS:
        if k not in SKIP:
            _same(getattr(t, k), getattr(j, k), f"{path}.{k}")
    assert (t.hot is None) == (j.hot is None), path


def _same_pack(t, j):
    """The port's artifact ``t`` against the reference's ``j``: every field
    of the port's (the reference's extra, distributed-only fields aside)."""
    if isinstance(t, SellRouted):
        return _same_routed(t, j, "sr")
    if isinstance(t, SellMatrix):
        keep = [k for k in vars(t) if k not in SKIP]
        return _same({k: getattr(t, k) for k in keep},
                     {k: getattr(j, k) for k in keep}, "sm")
    for f in dataclasses.fields(t):
        if f.name in SKIP:
            continue
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name == "spill" and a is not None:
            _same_routed(a, b, "spill")
        else:
            _same(a, b, f.name)


@pytest.mark.parametrize("case", ["banded", "asymmetric", "wide"])
def test_dia_pack_matches_reference(case):
    jcoo, tcoo = {
        "banded": lambda: banded(3000, 27),
        "asymmetric": lambda: diagonals(3000, 3000, (-300, -5, 0, 7, 129, 1000)),
        "wide": lambda: diagonals(3000, 200_000, (0, 2, 5000, 150_000)),
    }[case]()
    jdm, tdm = j_dia_pack(jcoo.to_csr()), dia_pack(tcoo.to_csr())
    _same_pack(tdm, jdm)
    assert tdm.padded_nnz == jdm.padded_nnz


@pytest.mark.parametrize("case", ["rgg_no_spill", "road_spill"])
def test_bell_pack_matches_reference(case):
    jcoo, tcoo = rgg() if case == "rgg_no_spill" else road()
    jbm, tbm = j_bell_pack(jcoo.to_csr()), bell_pack(tcoo.to_csr())
    _same_pack(tbm, jbm)
    assert (tbm.spill is None) == (case == "rgg_no_spill")
    if tbm.spill is not None:
        assert tbm.spill.nnz == tcoo.nnz - int((tbm.vals != 0).sum())


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_pack_matches_reference(case):
    make, segw = WINDOW_CASES[case]
    jcoo, tcoo = make()
    kw = {} if segw is None else {"segw": segw}
    jsw = j_pack_window(jcoo.to_csr(), **kw)
    tsw = sell_pack_window(tcoo.to_csr(), **kw)
    _same_pack(tsw, jsw)
    assert jsw.y_ra is None
    if case == "segw2":
        assert tsw.n_segs >= 2
    if case == "W2048_wrl15":
        assert tsw.W == 2048 and tsw.wrl < tsw.W // 128
    if case == "empty_rows":
        assert (tsw.emit >= 0).sum() < tsw.nslices


def test_window_pack_multi_group_matches_reference(monkeypatch):
    # the reference's window pack reads YB from pallas_window
    monkeypatch.setattr(jpw, "YB", 2)
    monkeypatch.setattr(tpr, "YB", 2)
    jcoo, tcoo = WINDOW_CASES["empty_rows"][0]()
    jsw, tsw = j_pack_window(jcoo.to_csr()), sell_pack_window(tcoo.to_csr())
    _same_pack(tsw, jsw)
    assert (tsw.ycall_rows[:, 1] == 0).any()  # a zero-width reduce group


@pytest.mark.parametrize("case,kind", [
    ("banded", DiaMatrix),
    ("rgg", BellMatrix),
    ("road", BellMatrix),
    ("reach600", SellRouted),
    ("reach600_inf_fill", SellWindow),
    ("fem", SellWindow),
    ("powerlaw", SellRouted),
])
def test_pack_auto_matches_reference(case, kind):
    make = {
        "banded": lambda: banded(3000, 9),
        "rgg": rgg,
        "road": road,
        "reach600": lambda: same_arrays(tsyn.road_usa_like(n=1 << 15,
                                                           reach=600)),
        "fem": fem,
        "powerlaw": powerlaw,
    }[case.replace("_inf_fill", "")]
    jcoo, tcoo = make()
    kw = {"max_window_fill": np.inf} if case.endswith("inf_fill") else {}
    j = j_pack_auto(jcoo.to_csr(), **kw)
    t = t_pack_auto(tcoo.to_csr(), **kw)
    assert isinstance(t, kind) and type(j).__name__ == kind.__name__
    _same_pack(t, j)
    if isinstance(t, SellWindow):
        assert t.D == 2 or case != "fem"


def test_pack_auto_above_the_routed_cap(monkeypatch):
    """Above the routed cap pack_auto warns and returns the plain SELL
    planes (C 1024), as the reference does above T 98304; the dispatcher
    runs them."""
    monkeypatch.setattr(tformats, "ROUTED_T_CAP", 512)
    jcoo, tcoo = powerlaw(n=20000, avg_nnz=20, seed=3)
    csr = tcoo.to_csr()
    with pytest.warns(UserWarning, match="routed path infeasible"):
        sm = t_pack_auto(csr)
    assert isinstance(sm, SellMatrix) and sm.C == 1024
    _same_pack(sm, sell_pack(csr, C=1024))
    x = np.random.default_rng(2).standard_normal(csr.shape[1]).astype(np.float32)
    ok, nbad, maxrel = verify(spmv(sm, x, device="cpu").numpy(),
                              spmv_golden_numpy(csr, x), rtol=1e-6,
                              row_scale=spmv_row_scale(csr, x))
    assert ok, f"{nbad} bad rows, max rel {maxrel}"


@pytest.mark.parametrize("fmt", ["dia", "bell", "window"])
def test_infeasible_gates_match_reference(fmt):
    jcoo, tcoo = powerlaw(n=5000, seed=7)
    jpack, jerr, tpack, terr = {
        "dia": (j_dia_pack, JDiaInfeasible, dia_pack, DiaInfeasible),
        "bell": (j_bell_pack, JBellInfeasible, bell_pack, BellInfeasible),
        "window": (j_pack_window, JWindowInfeasible, sell_pack_window,
                   WindowInfeasible),
    }[fmt]
    with pytest.raises(jerr):
        jpack(jcoo.to_csr())
    with pytest.raises(terr):
        tpack(tcoo.to_csr())


@pytest.mark.parametrize("fmt", ["dia", "bell", "window"])
def test_numpy_fill_matches_native(fmt, monkeypatch):
    """Each pack's numpy path builds the native path's arrays (BELL: the
    planes and the spill matrix handed to the routed pack, which itself
    needs the native library)."""
    if fmt == "window":
        csr = WINDOW_CASES["segw2"][0]()[1].to_csr()
        native = sell_pack_window(csr, segw=2, use_native=True)
        _same_pack(native, sell_pack_window(csr, segw=2, use_native=False))
        return
    if fmt == "dia":
        csr, pack = diagonals(3000, 3500, (-40, 0, 3, 300))[1].to_csr(), dia_pack
    else:
        csr, pack = road(n=1 << 15)[1].to_csr(), bell_pack
        spills = []
        monkeypatch.setattr(sell_routed, "sell_pack_routed",
                            lambda sp: spills.append(vars(sp)))
    native = pack(csr)
    monkeypatch.setattr(_native, "available", lambda: False)
    plain = pack(csr)
    _same_pack(plain, native)
    if fmt == "bell":
        assert len(spills) == 2 and spills[0]["rowptr"].shape[0] > 1
        _same(spills[1], spills[0], "spill csr")
