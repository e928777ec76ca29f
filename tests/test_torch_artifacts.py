"""The packed artifacts' .npz layout, held both ways against the JAX
package: what the port saves, the JAX package's loaders read, and what
the JAX package saves, the port's loaders read, key for key, dtype for
dtype and array for array; a loaded artifact runs the port's plain path to
the y (or Y) of the artifact it was saved from, bit for bit.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_artifacts.py -q

The cases are the eight artifact kinds: a routed pack with hot planes, a
ring-scheduled routed pack, BELL with a routed spill, SELL-W with and
without a y-route, DIA, BSR, the lane and PMM plans, and the plain SELL
planes.  Also: sell_unpack against sell_pack, the routed loader's older
layouts, the kind sniffing of the CLI, the JAX-written fixtures that
chip_smoke.py phase [12](c) loads on the card, and the SELL-W y-route's
SpMV against the JAX package's spmv_window in interpret mode.
"""

import io

import numpy as np
import pytest
import torch

import chip_smoke
import cvr_tpu.formats.sell_routed as jsr
from cvr_tpu.formats.bell import load_bell as j_load_bell
from cvr_tpu.formats.bell import save_bell as j_save_bell
from cvr_tpu.formats.bsr import BsrMatrix as JBsr
from cvr_tpu.formats.coo import COOMatrix as JCOO
from cvr_tpu.formats.dia import DiaMatrix as JDia
from cvr_tpu.formats.sell import SellMatrix as JSell
from cvr_tpu.formats.sell import sell_pack as j_sell_pack
from cvr_tpu.formats.sell import sell_unpack as j_sell_unpack
from cvr_tpu.formats.sell_window import SellWindow as JWindow
from cvr_tpu.ops.spmm_lane import load_lane as j_load_lane
from cvr_tpu.ops.spmm_lane import save_lane as j_save_lane
from cvr_tpu.ops.spmm_pmm import load_pmm as j_load_pmm
from cvr_tpu.ops.spmm_pmm import save_pmm as j_save_pmm

import cvr_tpu_torch.formats.sell_routed as tsr
from cvr_tpu_torch import cli
from cvr_tpu_torch.formats.bell import BellMatrix, load_bell, save_bell
from cvr_tpu_torch.formats.bsr import BsrMatrix
from cvr_tpu_torch.formats.coo import COOMatrix as TCOO
from cvr_tpu_torch.formats.dia import DiaMatrix
from cvr_tpu_torch.formats.sell import SellMatrix, sell_pack, sell_unpack
from cvr_tpu_torch.formats.sell_window import SellWindow
from cvr_tpu_torch.ops.spmm_lane import LanePlan, load_lane, save_lane
from cvr_tpu_torch.ops.spmm_pmm import PmmPlan, load_pmm, save_pmm
from cvr_tpu_torch.ops.spmv import spmm, spmv, upload
from cvr_tpu_torch.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify
from torch_cases import banded, fem, j_pack, powerlaw, rmat, road

from conftest import make_powerlaw_coo, make_random_coo

HOT = {"CVR_HOT": "1", "CVR_HOT_NH": "128"}
RING_D, RING_WR = 2, 12  # ring size, x rows (128 columns) per piece


def ring_pack(sr_mod, sell_pack_fn, coo):
    """A ring-scheduled routed pack (shard 0 of a ring of RING_D) of coo
    by the package of ``sr_mod``: the stream's tile blocks counted per
    ring step, then packed in ring order."""
    sm = sell_pack_fn(coo.to_csr(), C=1024)
    st = sr_mod.routed_stream_phase(sm, sr_mod.RoutedForce())
    unlock = sr_mod.ring_block_unlock(
        st, sr_mod.RingSpec(RING_D, 0, RING_WR, None))
    cnt = tuple(int(c) for c in np.bincount(unlock, minlength=RING_D))
    st = sr_mod.routed_stream_phase(sm, sr_mod.RoutedForce())
    return sr_mod.pack_routed(
        sm, ring=sr_mod.RingSpec(RING_D, 0, RING_WR, cnt), stream=st)


# name -> (matrices (JAX COO, port COO), kind, environment, K: 0 for an
# SpMV artifact, the width of X for an SpMM plan)
CASES = {
    "routed_hot": (lambda: rmat(11, 8, 5), "sell-routed", HOT, 0),
    "routed_ring": (lambda: powerlaw(n=3000, seed=3), "routed_ring", {}, 0),
    "bell_spill": (lambda: road(n=1 << 14), "bell", {}, 0),
    "window": (lambda: fem(n=1 << 13, deg=10, bw=100), "sell-window", {}, 0),
    "window_y_route": (lambda: fem(n=1 << 13, deg=10, bw=100),
                       "window_y_route", {}, 0),
    "dia": (lambda: banded(3000, 9), "dia", {}, 0),
    "bsr": (lambda: banded(3000, 9), "bsr", {}, 8),
    "lane": (lambda: powerlaw(n=3000), "lane", {}, 8),
    "pmm": (lambda: powerlaw(n=3000), "pmm", {}, 8),
    "sell": (lambda: powerlaw(n=3000), "sell", {}, 0),
}

J_SAVE = {"sell-routed": jsr.save_routed, "routed_ring": jsr.save_routed,
          "bell": j_save_bell, "lane": j_save_lane, "pmm": j_save_pmm}
J_LOAD = {"sell-routed": jsr.load_routed, "routed_ring": jsr.load_routed,
          "bell": j_load_bell, "sell-window": JWindow.load,
          "window_y_route": JWindow.load, "dia": JDia.load,
          "bsr": JBsr.load, "lane": j_load_lane, "pmm": j_load_pmm,
          "sell": JSell.load}
T_SAVE = {"sell-routed": tsr.save_routed, "routed_ring": tsr.save_routed,
          "bell": save_bell, "lane": save_lane, "pmm": save_pmm}
T_LOAD = {"sell-routed": tsr.load_routed, "routed_ring": tsr.load_routed,
          "bell": load_bell, "sell-window": SellWindow.load,
          "window_y_route": SellWindow.load, "dia": DiaMatrix.load,
          "bsr": BsrMatrix.load, "lane": load_lane, "pmm": load_pmm,
          "sell": SellMatrix.load}
T_TYPE = {"sell-routed": tsr.SellRouted, "routed_ring": tsr.SellRouted,
          "bell": BellMatrix, "sell-window": SellWindow,
          "window_y_route": SellWindow, "dia": DiaMatrix, "bsr": BsrMatrix,
          "lane": LanePlan, "pmm": PmmPlan, "sell": SellMatrix}
SNIFFED = {"routed_ring": "sell-routed", "window_y_route": "sell-window"}


def save(table, kind, A, path):
    table.get(kind, lambda a, p: a.save(p))(A, path)
    return path


def npz(path) -> dict:
    """A saved artifact's entries; BELL's embedded spill file as its own
    entries (the bytes of a zip hold its write time)."""
    z = np.load(path)
    return {k: (npz(io.BytesIO(z[k].tobytes()))
                if k == "bell_spill" and z[k].size else z[k])
            for k in z.files}


def assert_same_layout(got: dict, want: dict, where=""):
    assert sorted(got) == sorted(want), where
    for k, w in want.items():
        if isinstance(w, dict):
            assert_same_layout(got[k], w, f"{where}{k}.")
            continue
        g = got[k]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), f"{where}{k}"
        assert np.array_equal(g, w), f"{where}{k}"


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Per case: the port's pack, the port COO, and the files each package
    saved of its own pack of the same matrix."""
    d = tmp_path_factory.mktemp("artifacts")
    out = {}
    for name, (make, kind, env, K) in CASES.items():
        jcoo, tcoo = make()
        if kind == "routed_ring":
            with chip_smoke.environment({"CVR_HOT": "0"}):
                jA = ring_pack(jsr, j_sell_pack, jcoo)
                tA = ring_pack(tsr, sell_pack, tcoo)
            assert tA.ring_cnt is not None and tA.seg_ring is not None
        else:
            jA = j_pack(kind, jcoo, env)
            tA = chip_smoke.port_pack(kind, tcoo, env)
        out[name] = dict(
            kind=kind, K=K, tA=tA, tcoo=tcoo,
            jfile=save(J_SAVE, kind, jA, d / f"{name}.jax.npz"),
            tfile=save(T_SAVE, kind, tA, d / f"{name}.port.npz"))
    return out


@pytest.mark.parametrize("name", CASES)
def test_port_saves_the_reference_layout(saved, name):
    c = saved[name]
    assert_same_layout(npz(c["tfile"]), npz(c["jfile"]))


@pytest.mark.parametrize("name", CASES)
def test_reference_reads_the_port_file(saved, name, tmp_path):
    """The JAX package's loader reads the port's file; saved again by the
    JAX package, it is the JAX package's own file of the matrix."""
    c = saved[name]
    again = save(J_SAVE, c["kind"], J_LOAD[c["kind"]](c["tfile"]),
                 tmp_path / "again.npz")
    assert_same_layout(npz(again), npz(c["jfile"]))


@pytest.mark.parametrize("name", CASES)
def test_port_reads_the_reference_file(saved, name, tmp_path):
    c = saved[name]
    A = T_LOAD[c["kind"]](c["jfile"])
    assert type(A) is T_TYPE[c["kind"]]
    again = save(T_SAVE, c["kind"], A, tmp_path / "again.npz")
    assert_same_layout(npz(again), npz(c["jfile"]))
    if c["kind"] == "sell-routed":
        assert A.hot is not None and A.hot.NH == 128
    if c["kind"] == "routed_ring":
        assert A.ring_cnt == c["tA"].ring_cnt
    if c["kind"] == "bell":
        assert A.spill is not None and A.spill_map is not None
    if c["kind"] == "window_y_route":
        assert A.y_ra is not None and A.y_ra["n"] == A.shape[0]


def run(A, coo, K):
    """The port's plain path (CPU tensors) on artifact A: y for x, or Y
    for X, both from a seed; and the float64 golden's verdict."""
    rng = np.random.default_rng(5)
    csr = coo.to_csr()
    if K:
        X = rng.standard_normal((coo.shape[1], K)).astype(np.float32)
        Y = spmm(upload(A, "cpu"), torch.from_numpy(X))
        ok = all(verify(Y[:, k].numpy(), spmv_golden_numpy(csr, X[:, k]),
                        rtol=1e-6, row_scale=spmv_row_scale(csr, X[:, k]))[0]
                 for k in range(K))
        return Y, ok
    x = rng.standard_normal(coo.shape[1]).astype(np.float32)
    y = spmv(upload(A, "cpu"), torch.from_numpy(x))
    return y, verify(y.numpy(), spmv_golden_numpy(csr, x), rtol=1e-6,
                     row_scale=spmv_row_scale(csr, x))[0]


@pytest.mark.parametrize("name", CASES)
def test_loaded_artifact_runs(saved, name):
    """Loaded from either package's file, the artifact gives the y (Y) of
    the port's pack bit for bit, and passes the golden."""
    c = saved[name]
    want, ok = run(c["tA"], c["tcoo"], c["K"])
    assert ok
    for f in (c["tfile"], c["jfile"]):
        got, _ = run(T_LOAD[c["kind"]](f), c["tcoo"], c["K"])
        assert torch.equal(got, want), f


@pytest.mark.parametrize("name", CASES)
def test_cli_sniffs_the_kind(saved, name, tmp_path):
    """cli.load_packed sniffs each file's kind from its keys (the JAX
    CLI's rule for the SpMV kinds), and cli.save_packed writes each kind
    with its own save."""
    c = saved[name]
    kind, A = cli.load_packed(c["jfile"])
    assert kind == SNIFFED.get(c["kind"], c["kind"])
    assert type(A) is T_TYPE[c["kind"]]
    cli.save_packed(c["tA"], tmp_path / "cli.npz")
    assert_same_layout(npz(tmp_path / "cli.npz"), npz(c["tfile"]))


def test_window_y_route_against_reference(saved):
    """The SELL-W artifact with a y-route: K10's rows in the planes' order,
    then K4 to natural rows, against the JAX package's spmv_window (its
    window kernel in interpret mode, then apply_route_tpu) on the same
    file."""
    import jax.numpy as jnp
    from cvr_tpu.ops.spmv_window import spmv_window as j_spmv_window
    from cvr_tpu.ops.spmv_window import to_device_window as j_to_device

    c = saved["window_y_route"]
    tcoo = c["tcoo"]
    _, inv = chip_smoke.block_sorted(tcoo)
    assert (inv != np.arange(tcoo.shape[0])).any()
    x = np.random.default_rng(3).standard_normal(tcoo.shape[1]).astype(
        np.float32)
    y = spmv(upload(SellWindow.load(c["jfile"]), "cpu"),
             torch.from_numpy(x)).numpy()
    jy = np.asarray(j_spmv_window(j_to_device(JWindow.load(c["jfile"])),
                                  jnp.asarray(x)))
    csr = tcoo.to_csr()
    scale = spmv_row_scale(csr, x)
    assert verify(y, jy, rtol=1e-6, row_scale=scale)[0]
    assert verify(y, spmv_golden_numpy(csr, x), rtol=1e-6,
                  row_scale=scale)[0]


# ---------------------------------------------------------------------------
# the routed and SELL-W loaders' older layouts
# ---------------------------------------------------------------------------

OPTIONAL = ("regions", "ymask", "nslA", "zone_rows", "yslices", "ring_seg",
            "ring_cnt", "ring_nsegtab")


def older(path, out, variant):
    """The file at ``path`` rewritten as an older layout: "pre_v10" (w8 as
    1024-aligned window indices, no gather classes), "no_optional" (none
    of the keys added since), "window_no_wrl" (a SELL-W file without
    wrl)."""
    z = dict(np.load(path))
    if variant == "pre_v10":
        z["w8"] = z["w8"] // 8
        del z["gcls"]
    elif variant == "no_optional":
        for k in OPTIONAL:
            del z[k]
    else:
        del z["wrl"]
    np.savez_compressed(out, **z)
    return out


@pytest.mark.parametrize("name, variant", [
    ("routed_hot", "pre_v10"), ("routed_hot", "no_optional"),
    ("routed_ring", "no_optional"), ("window", "window_no_wrl"),
])
def test_older_layouts_load_as_in_the_reference(saved, name, variant,
                                                tmp_path):
    c = saved[name]
    f = older(c["jfile"], tmp_path / "older.npz", variant)
    kind = c["kind"]
    t_again = save(T_SAVE, kind, T_LOAD[kind](f), tmp_path / "t.npz")
    j_again = save(J_SAVE, kind, J_LOAD[kind](f), tmp_path / "j.npz")
    assert_same_layout(npz(t_again), npz(j_again))
    A = T_LOAD[kind](f)
    if variant == "pre_v10":
        assert (A.gcls == 8).all() and A.gcls.shape == (A.T // 8,)
        assert np.array_equal(A.w8, np.load(f)["w8"] * 8)
    elif variant == "no_optional":
        assert A.regions.shape == (0, 5) and A.ymask.shape == (0,)
        assert (A.nslA, A.zone_rows, A.yslices) == (0, 0, A.nslices)
        assert (A.seg_ring, A.ring_cnt, A.ring_nsegtab) == (None, None, ())
    else:
        assert A.wrl == 0 and upload(A, "cpu").wrl == A.W // 128


# ---------------------------------------------------------------------------
# the artifacts chip_smoke.py phase [12](c) loads on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", chip_smoke.JAX_FIXTURES)
def test_jax_written_fixture(name, tmp_path):
    """tests/fixtures/jax_<name>.npz, written by the JAX package's save
    (tests/make_torch_fixtures.py), is what the port saves of its own pack
    of the fixture's matrix, and runs to its y (Y) bit for bit."""
    make, kind, env, K = chip_smoke.JAX_FIXTURES[name]
    path = chip_smoke.FIXTURE_DIR / f"jax_{name}.npz"
    assert path.stat().st_size < 1 << 20
    coo = make()
    A = chip_smoke.port_pack(kind, coo, env)
    mine = save(T_SAVE, kind, A, tmp_path / "port.npz")
    assert_same_layout(npz(mine), npz(path))
    got_kind, B = cli.load_packed(path)
    assert got_kind == chip_smoke.saved_kind(kind)
    want, ok = run(A, coo, K)
    got, _ = run(B, coo, K)
    assert ok and torch.equal(got, want)


# ---------------------------------------------------------------------------
# sell_unpack: the exact inverse of sell_pack (tests/test_formats.py's
# cases)
# ---------------------------------------------------------------------------


def _pair(j):
    """(JAX COO, port COO) of the same arrays."""
    return j, TCOO(rows=j.rows, cols=j.cols, vals=j.vals, shape=j.shape)


def _small(rows, cols, vals, shape):
    return _pair(JCOO(rows=np.asarray(rows, dtype=np.int32),
                      cols=np.asarray(cols, dtype=np.int32),
                      vals=np.asarray(vals, dtype=np.float32), shape=shape))


def _overlong():
    n = 64
    rows = np.concatenate([np.zeros(n), np.arange(1, 9)])
    cols = np.concatenate([np.arange(n), np.zeros(8)])
    return _small(rows, cols, np.arange(n + 8) + 1.0, (16, n))


UNPACK = {
    "random_C8": (lambda: _pair(make_random_coo(200, 180, 0.05, 1)),
                  dict(C=8)),
    "random_C128": (lambda: _pair(make_random_coo(200, 180, 0.05, 1)),
                    dict(C=128)),
    "random_C1024": (lambda: _pair(make_random_coo(200, 180, 0.05, 1)),
                     dict(C=1024)),
    "powerlaw_sigma0": (lambda: _pair(make_powerlaw_coo(3000, 3000)),
                        dict(C=128, sigma=0)),
    "powerlaw_sigma64": (lambda: _pair(make_powerlaw_coo(3000, 3000)),
                         dict(C=128, sigma=64)),
    "powerlaw_sigma1000": (lambda: _pair(make_powerlaw_coo(3000, 3000)),
                           dict(C=128, sigma=1000)),
    "split16": (lambda: _pair(make_powerlaw_coo(3000, 3000)),
                dict(C=128, split_len=16)),
    "split_off": (lambda: _pair(make_powerlaw_coo(3000, 3000)),
                  dict(C=128, split_len=0)),
    "empty_rows": (lambda: _small([1, 1, 3], [0, 2, 1], [1, 2, 3], (5, 3)),
                   dict(C=8)),
    "overlong_row": (_overlong, dict(C=8)),
    "empty": (lambda: _small([], [], [], (4, 4)), dict(C=8)),
    "explicit_zeros": (lambda: _small([0, 0, 1], [0, 1, 0], [0, 5, 0],
                                      (2, 2)), dict(C=8)),
}


@pytest.mark.parametrize("name", UNPACK)
def test_sell_unpack_inverts_sell_pack(name):
    make, kw = UNPACK[name]
    jcoo, tcoo = make()
    csr = tcoo.to_csr()
    sm = sell_pack(csr, **kw)
    if name == "split16":
        assert sm.n_splits > 0
    got = sell_unpack(sm)
    want = j_sell_unpack(j_sell_pack(jcoo.to_csr(), **kw))
    for a, b in ((got, csr), (got, want)):
        assert a.shape == b.shape
        for k in ("rowptr", "cols", "vals"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and np.array_equal(x, y), k


def test_sell_unpack_refuses_a_corrupt_pack():
    sm = sell_pack(_pair(make_powerlaw_coo(300, 300))[1].to_csr(), C=8)
    sm.nnz += 1
    with pytest.raises(ValueError, match="corrupt"):
        sell_unpack(sm)
