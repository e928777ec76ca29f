"""The port's hub-column hybrid against the JAX package's.

Host side, array for array: the generators of the hub-heavy stand-ins,
the capture gate's decisions and predicted gains, the capture split, the
hot planes (NH 128, 256, 512 under the reference's forcing switches) and
the routed packs around them.  Device side: K7 ``reduce_hot`` (its plain
version, the tensors lying on the CPU) against the Pallas hot reduce
(interpret mode) over emission-swept pieces and regular regions, within
1e-6 of the row scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvr_tpu.bench.synthetic as jsyn_mod
import cvr_tpu.ops.spmv_routed as jsr_mod
from cvr_tpu.formats.hot import capture_split as j_capture
from cvr_tpu.formats.hot import plan_hot as j_plan_hot
from cvr_tpu.formats.sell_routed import sell_pack_routed as j_pack_routed

import cvr_tpu_torch.bench.synthetic as tsyn_mod
from cvr_tpu_torch.formats.hot import capture_split as t_capture
from cvr_tpu_torch.formats.hot import plan_hot as t_plan_hot
from cvr_tpu_torch.formats.sell_routed import _FIELDS, from_reference
from cvr_tpu_torch.formats.sell_routed import sell_pack_routed as t_pack_routed
from cvr_tpu_torch.ops import kernels
from cvr_tpu_torch.ops import route_kernels as rk
from cvr_tpu_torch.ops import spmv_routed as tsp
from torch_cases import banded, fsm, powerlaw, rmat


def _same(a, b, path):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert a == b, path


def _same_hot(jh, th):
    assert (jh is None) == (th is None)
    if jh is not None:
        for k in vars(jh):
            _same(getattr(jh, k), getattr(th, k), f"hot.{k}")


def _check_hot_pack(jcoo, tcoo):
    jsr = j_pack_routed(jcoo.to_csr())
    tsr = t_pack_routed(tcoo.to_csr())
    for k in _FIELDS:
        if k not in ("convert_time", "convert_phases"):
            _same(getattr(jsr, k), getattr(tsr, k), k)
    _same_hot(jsr.hot, tsr.hot)
    if tsr.hot is not None:
        assert {"hot_plan", "hot_capture", "hot_planes"} <= set(
            tsr.convert_phases)
    _same_hot(jsr.hot, from_reference(jsr).hot)
    return jsr, tsr


def test_fsm_like_generator_matches_reference():
    for n, seed in ((1 << 12, 19), (5000, 3)):
        j, t = fsm(n=n, seed=seed)
        _same(vars(j), vars(t), "coo")


def test_wiki_talk_like_generator_matches_reference(monkeypatch):
    """Both packages' wiki_talk_like pass the same R-MAT parameters; the
    generator runs at scale 10 instead of 21."""
    seen = {}

    def shrink(mod, key):
        real = mod.rmat_matrix

        def small(scale, **kw):
            seen[key] = (scale, dict(kw))
            if key == "jax":
                kw["cache"] = False
            return real(10, **kw)

        monkeypatch.setattr(mod, "rmat_matrix", small)

    shrink(jsyn_mod, "jax")
    shrink(tsyn_mod, "torch")
    j, t = jsyn_mod.wiki_talk_like(), tsyn_mod.wiki_talk_like()
    assert seen["jax"] == seen["torch"] and seen["torch"][0] == 21
    _same(vars(j), vars(t), "coo")


PLAN_CASES = {
    "fsm": lambda: fsm(n=1 << 17),
    "fsm_small": lambda: fsm(n=1 << 16),
    "powerlaw": lambda: powerlaw(n=20000, avg_nnz=8, seed=5),
    "banded": lambda: banded(n=20000, bandwidth=9),
    "rmat": lambda: rmat(13, 8, 4),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_hot_matches_reference(case):
    jcoo, tcoo = PLAN_CASES[case]()
    want = j_plan_hot(jcoo.to_csr())
    got = t_plan_hot(tcoo.to_csr())
    assert got == want
    forced = t_plan_hot(tcoo.to_csr(), min_net=float("-inf"))
    assert forced == j_plan_hot(jcoo.to_csr(), min_net=float("-inf"))
    if case in ("banded", "fsm_small"):
        assert got is None  # capture cannot pay
    if case == "fsm":
        assert got is not None  # the hub columns of the FSM stand-in


def test_plan_hot_decisions_cover_both_verdicts():
    verdicts = {case: t_plan_hot(make()[1].to_csr())
                for case, make in PLAN_CASES.items()}
    assert any(v is None for v in verdicts.values())
    assert any(v is not None for v in verdicts.values())


@pytest.mark.parametrize("NH", [128, 256, 512])
def test_capture_split_matches_reference(NH):
    jcoo, tcoo = powerlaw(n=20000, avg_nnz=8, seed=5)
    jrest, jhi = j_capture(jcoo.to_csr(), NH, 1.5)
    trest, thi = t_capture(tcoo.to_csr(), NH, 1.5)
    for k in ("rowptr", "cols", "vals", "shape"):
        _same(getattr(jrest, k), getattr(trest, k), f"rest.{k}")
    for k in vars(jhi):
        _same(getattr(jhi, k), getattr(thi, k), f"hotinfo.{k}")


@pytest.mark.parametrize("NH", [128, 256, 512])
def test_hot_planes_match_reference(monkeypatch, NH):
    monkeypatch.setenv("CVR_HOT", "1")
    monkeypatch.setenv("CVR_HOT_NH", str(NH))
    _, tsr = _check_hot_pack(*powerlaw(n=40000, avg_nnz=8, seed=5))
    hp = tsr.hot
    assert hp.NH == NH and hp.ncand == NH // 128
    if NH == 512:  # mixed gather classes
        assert np.unique(hp.hgcls).shape[0] > 1


def test_hot_regions_pack_matches_reference(monkeypatch):
    monkeypatch.setenv("CVR_HOT", "1")
    _, tsr = _check_hot_pack(*fsm(n=1 << 17))
    assert tsr.hot.regions.shape[0] > 0


def test_hot_off_switch_matches_reference(monkeypatch):
    monkeypatch.setenv("CVR_HOT", "0")
    jcoo, tcoo = fsm(n=1 << 14)
    jsr, tsr = _check_hot_pack(jcoo, tcoo)
    assert tsr.hot is None
    monkeypatch.setenv("CVR_HOT", "1")
    assert t_pack_routed(tcoo.to_csr(), hot="off").hot is None


def _hot_case(monkeypatch, NH, make):
    monkeypatch.setenv("CVR_HOT", "1")
    monkeypatch.setenv("CVR_HOT_NH", str(NH))
    jcoo, _ = make()
    sr = j_pack_routed(jcoo.to_csr())
    x = np.random.default_rng(11).standard_normal(jcoo.shape[1]).astype(np.float32)
    return sr, x


@pytest.mark.parametrize("NH,case", [(128, "fsm"), (256, "fsm"),
                                     (256, "powerlaw"), (512, "powerlaw")])
def test_reduce_hot_matches_pallas(monkeypatch, NH, case):
    """The port's hot stream (x[hot_ids] and K7's plain version) against
    the JAX package's ``_hot_stream`` (reduce_hot_slices over the
    emission-swept pieces, reduce_hot_regular over the regions) at
    ncand 1, 2 and 4."""
    make = (lambda: fsm(n=1 << 17)) if case == "fsm" else (
        lambda: powerlaw(n=40000, avg_nnz=8, seed=5))
    sr, x = _hot_case(monkeypatch, NH, make)
    hp = sr.hot
    assert hp.ncand == NH // 128
    if case == "fsm":
        assert hp.regions.shape[0] > 0
    jsd = jsr_mod.to_device_routed(sr)
    want = np.asarray(jsr_mod._hot_stream(jsd, jnp.asarray(x)))
    tsd = tsp.to_device_routed(from_reference(sr), "cpu")
    xt = torch.from_numpy(x)
    kernels.reset_launches()
    got = tsp.hot_stream(tsd, xt).numpy()
    assert rk.reduce_hot.launches == 0  # CPU tensors: the plain version ran
    scale = rk.reduce_hot(xt[tsd.hot_ids].abs(), tsd.hidx, tsd.hvals.abs(),
                          tsd.hot_row0, tsd.hot_row1, tsd.hot_out,
                          tsd.hot_nslices).numpy()
    assert got.shape == want.shape == (8, hp.nslices, 128)
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= 1e-6 + 1e-6 * scale).all(), float(err.max())
