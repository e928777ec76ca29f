"""The routed pack without the native library: the port's numpy path
(``pack_routed`` when ``_native.available()`` is false) against the JAX
package's, array for array, with both libraries hidden by the switch the
other tests use (``_native.available`` -> False).

Without the library the route's Euler coloring is pure Python
(``euler_color_py``, ~1 min per million elements), so here both
packages' coloring is replaced by one shared function, the native
coloring: the numpy pack around it (the expand schedule, the route
planes, the middle's decomposition, the tail) is what runs, and
test_torch_route_api.py holds the two pure-Python colorings against each
other.  The fallback's y through the port's plain versions must pass the
float64 golden and agree with the native pack's y; the row-sharded pack
without the library takes the JAX package's bound on its route tiles.
"""

import numpy as np
import pytest
import torch

import cvr_tpu._native as jnative
import cvr_tpu.parallel.dist_routed as jdr
from cvr_tpu.formats import sell_routed as jsr
from cvr_tpu.formats.sell import sell_pack as j_sell_pack
from cvr_tpu.ops import route as jroute
from cvr_tpu.parallel.dist import make_mesh as j_make_mesh

import cvr_tpu_torch._native as tnative
import cvr_tpu_torch.parallel.dist_routed as tdr
from cvr_tpu_torch.formats import sell_routed as tsr
from cvr_tpu_torch.formats.sell import sell_pack as t_sell_pack
from cvr_tpu_torch.ops import route as troute
from cvr_tpu_torch.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify
from cvr_tpu_torch.ops.spmv_routed import spmv_routed, to_device_routed
from cvr_tpu_torch.parallel.dist import make_mesh as t_make_mesh
from torch_cases import banded, powerlaw, random_rect, rmat

SKIP = ("convert_time", "convert_phases")

MATRICES = {
    "rmat13": lambda: rmat(13, 8, 3),
    "powerlaw": lambda: powerlaw(n=3000, seed=5),
    "banded": lambda: banded(5000, 9),
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


def _hide_native(monkeypatch):
    """Both libraries hidden; both pure-Python colorings replaced by the
    native one (see the module docstring)."""
    assert tnative.available() and jnative.available()
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)

    def shared(src, dst, n_tiles, k):
        return tnative.euler_color_native(src, dst, n_tiles, k)

    monkeypatch.setattr(troute, "euler_color_py", shared)
    monkeypatch.setattr(jroute, "euler_color_py", shared)


def _y(sr, csr, x):
    return spmv_routed(to_device_routed(sr, "cpu"),
                       torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("case", sorted(MATRICES))
def test_numpy_pack_matches_reference(case, monkeypatch):
    """pack_routed without the library: the JAX numpy path's SellRouted
    array for array (no zone layout), its phases the numpy path's; its y
    at the golden and within the contract of the native pack's y."""
    jcoo, tcoo = MATRICES[case]()
    csr = tcoo.to_csr()
    tsm = t_sell_pack(csr, C=1024, split_len=1024)
    jsm = j_sell_pack(jcoo.to_csr(), C=1024, split_len=1024)
    native = tsr.pack_routed(tsm)
    _hide_native(monkeypatch)
    got, want = tsr.pack_routed(tsm), jsr.pack_routed(jsm)
    for k in tsr._FIELDS:
        if k not in SKIP:
            _same(getattr(want, k), getattr(got, k), k)
    assert got.nslA == 0 and "zone_plan" not in got.convert_phases
    assert {"expand_tiles", "route_plan", "fuse_planes", "reduce_aux",
            "y_route"} == set(got.convert_phases)
    x = np.random.default_rng(7).standard_normal(csr.shape[1]).astype(
        np.float32)
    y = _y(got, csr, x)
    scale = spmv_row_scale(csr, x)
    ok, nbad, maxrel = verify(y, spmv_golden_numpy(csr, x), rtol=1e-6,
                              row_scale=scale)
    assert ok, f"golden: {nbad} bad rows, max rel {maxrel}"
    ok, nbad, maxrel = verify(y, _y(native, csr, x), rtol=1e-6,
                              row_scale=scale)
    assert ok, f"native pack's y: {nbad} bad rows, max rel {maxrel}"


def test_numpy_pack_under_a_forced_geometry(monkeypatch):
    """A forced geometry (as a row shard packs) without the library: the
    JAX numpy path's arrays, the forced T and the padded extras."""
    jcoo, tcoo = powerlaw(n=2000, avg_nnz=4, seed=3)
    tsm = t_sell_pack(tcoo.to_csr(), C=1024, split_len=16)
    jsm = j_sell_pack(jcoo.to_csr(), C=1024, split_len=16)
    n_ex = tsm.n_splits + 3
    _hide_native(monkeypatch)
    got = tsr.pack_routed(tsm, force=tsr.RoutedForce(
        T=2048, nrows_out=2100, n_extras=n_ex))
    want = jsr.pack_routed(jsm, force=jsr.RoutedForce(
        T=2048, nrows_out=2100, n_extras=n_ex))
    for k in tsr._FIELDS:
        if k not in SKIP:
            _same(getattr(want, k), getattr(got, k), k)
    assert got.T == 2048 and got.extra_src.shape[0] == n_ex
    assert got.ymask.shape[0] == 2100


def test_numpy_pack_refusals(monkeypatch):
    """The caps hold without the library: max_T as in the native pack, a
    forced T below the stream's as in the JAX numpy path."""
    _, tcoo = rmat(13, 8, 3)
    tsm = t_sell_pack(tcoo.to_csr(), C=1024, split_len=1024)
    _hide_native(monkeypatch)
    with pytest.raises(ValueError, match="above the cap of 1024"):
        tsr.pack_routed(tsm, max_T=1024)
    with pytest.raises(ValueError, match="force.T 1024 < required T 2048"):
        tsr.pack_routed(tsm, force=tsr.RoutedForce(T=1024))


def test_ring_and_stream_still_require_the_library(monkeypatch):
    _, tcoo = powerlaw(n=2000, avg_nnz=4, seed=3)
    tsm = t_sell_pack(tcoo.to_csr(), C=1024, split_len=1024)
    monkeypatch.setattr(tnative, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native library"):
        tsr.pack_routed(tsm, ring=tsr.RingSpec(2, 0, 8, np.ones(2)))
    with pytest.raises(RuntimeError, match="native library"):
        tsr.routed_stream_phase(tsm)


def test_sell_pack_routed_with_hot_planes_without_the_library(monkeypatch):
    """sell_pack_routed (the hybrid forced on) without the library: the
    JAX package's artifact, hot planes included, and y at the golden."""
    from cvr_tpu.formats.sell_routed import sell_pack_routed as j_pack
    from cvr_tpu_torch.formats.sell_routed import sell_pack_routed as t_pack

    jcoo, tcoo = rmat(12, 8, 4)
    monkeypatch.setenv("CVR_HOT", "1")
    monkeypatch.setenv("CVR_HOT_NH", "128")
    _hide_native(monkeypatch)
    got, want = t_pack(tcoo.to_csr()), j_pack(jcoo.to_csr())
    for k in tsr._FIELDS:
        if k not in SKIP:
            _same(getattr(want, k), getattr(got, k), k)
    assert got.hot is not None
    for f in ("hidx", "hvals", "hgcls", "hemit", "ycall_rows", "regions",
              "hot_ids"):
        _same(getattr(want.hot, f), getattr(got.hot, f), f"hot.{f}")
    csr = tcoo.to_csr()
    x = np.random.default_rng(3).standard_normal(csr.shape[1]).astype(
        np.float32)
    ok, nbad, maxrel = verify(_y(got, csr, x), spmv_golden_numpy(csr, x),
                              rtol=1e-6, row_scale=spmv_row_scale(csr, x))
    assert ok, f"golden: {nbad} bad rows, max rel {maxrel}"


def _capture(monkeypatch, module) -> dict:
    """Record the per-shard artifacts the module's dist pack assembles."""
    got = {}
    finish = module._dist_routed_finish

    def capture(csr, mesh, bounds, srs, *args, **kwargs):
        got["srs"] = srs
        return finish(csr, mesh, bounds, srs, *args, **kwargs)

    monkeypatch.setattr(module, "_dist_routed_finish", capture)
    return got


def test_dist_pack_bound_without_the_library(monkeypatch):
    """dist_routed_pack without the library: every shard packed at the
    JAX package's upper bound on T (S_pad + windows + a TB pad a segment,
    in 1024-tile units), above the native count, array for array.  Wide
    rows (977 column windows) put the bound above the 1024 tiles the
    stream needs."""
    jcoo, tcoo = random_rect(nrows=500, ncols=1_000_000, density=4e-6)
    D = 2
    native = tdr.dist_routed_pack(tcoo.to_csr(),
                                  t_make_mesh(devices=["cpu"] * D))
    jgot, tgot = _capture(monkeypatch, jdr), _capture(monkeypatch, tdr)
    _hide_native(monkeypatch)
    jdm = jdr.dist_routed_pack(jcoo.to_csr(), j_make_mesh(D))
    tdm = tdr.dist_routed_pack(tcoo.to_csr(),
                               t_make_mesh(devices=["cpu"] * D))
    S_pad, n_segs = tgot["srs"][0].S_pad, tgot["srs"][0].n_segs
    bound = -(-(S_pad + 977 + n_segs * 128) // 1024) * 1024
    assert tdm.meta["T"] == jdm.meta["T"] == bound > native.meta["T"]
    for i, (js, ts) in enumerate(zip(jgot["srs"], tgot["srs"], strict=True)):
        for k in tsr._FIELDS:
            if k not in SKIP:
                _same(getattr(js, k), getattr(ts, k), f"shard {i}: {k}")
