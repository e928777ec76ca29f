"""The route library's device API of the port against the JAX package's.

``apply_route`` (v[perm] on the device) over the three middle kinds,
``middle_pass``, the brute and flat middle kernels K17 ``groupperm`` and
K16 ``route_flat``, the unfused reduce K18 ``reduce_stream``, and the host
planning behind them (``plan_route``, ``middle_planes_from``,
``mid_recursive_planes``), with the native library and without it.

The JAX passes run in Pallas interpret mode; the port's wrappers run
their plain versions, the tensors lying on the CPU.  Passes that only move
values agree bit for bit; the reduce sums in another order and is held to
the row-scaled 1e-6 of the golden verifier.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvr_tpu._native as jnative
import cvr_tpu.ops.pallas_route as jpr
import cvr_tpu.ops.route as jroute
from cvr_tpu.formats.sell_routed import sell_pack_routed as j_pack_routed

import cvr_tpu_torch._native as tnative
import cvr_tpu_torch.ops.route as troute
import cvr_tpu_torch.ops.route_planes as tpr
from cvr_tpu_torch.formats.sell_routed import from_reference
from cvr_tpu_torch.ops import kernels
from cvr_tpu_torch.ops import route_kernels as rk
from cvr_tpu_torch.ops import spmv_routed as tsp
from cvr_tpu_torch.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify
from torch_cases import CASES, rmat


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_route(a: dict, b: dict):
    """Two route_arrays dicts, array for array."""
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _same_route(a[k], b[k])
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("K", [1, 2, 3])
def test_groupperm_matches_pallas(K):
    rng = np.random.default_rng(K)
    data = rng.standard_normal((K, 1024, 128)).astype(np.float32)
    idx = rng.integers(0, K * 128, (K, 1024, 128)).astype(np.int16)
    idx[0, :4, 0] = (-1, K * 128, K * 128 + 5, 32767)  # outside: 0
    want = np.asarray(jpr.groupperm_ss(jnp.asarray(data), jnp.asarray(idx)))
    kernels.reset_launches()
    got = rk.groupperm(_t(data), _t(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0, :4, 0] == 0).all()
    assert rk.groupperm.launches == 0  # CPU tensors: the plain version ran


def test_route_flat_matches_pallas():
    """K16 against _flat_fused_call on the flat middle plane of a random
    permutation of 1024 * 1024."""
    perm = np.random.default_rng(12).permutation(1024 * 1024)
    mp = jpr.route_arrays_from_perm(perm)["mid_planes"]
    assert mp["kind"] == "flat"
    g1 = np.random.default_rng(13).standard_normal((8, 1024, 128)).astype(np.float32)
    want = np.asarray(jpr._mid_fused_call(1, "flat", True)(jnp.asarray(g1),
                                                          mp["mid"]))
    kernels.reset_launches()
    got = rk.route_flat(_t(g1), _t(mp["mid"]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert rk.route_flat.launches == 0
    # the plain version is the composition it names
    np.testing.assert_array_equal(
        got.numpy(),
        rk.mstream_to_stream(rk.tileperm_plain(
            rk.stream_to_mstream(_t(g1), 1), _t(mp["mid"])), 1).numpy())


def test_stream_middle_relayouts_match_reference():
    g = np.random.default_rng(14).standard_normal((8, 384, 128)).astype(np.float32)
    m = rk.stream_to_middle(_t(g))
    np.testing.assert_array_equal(
        m.numpy(), np.asarray(jpr.stream_to_middle(jnp.asarray(g))))
    np.testing.assert_array_equal(
        rk.middle_to_stream(m).numpy(),
        np.asarray(jpr.middle_to_stream(jnp.asarray(m.numpy()))))
    np.testing.assert_array_equal(rk.middle_to_stream(m).numpy(), g)


# N, tile_multiple, the middle it must reach: (kind, T, Tp, Tk)
ROUTES = {
    "brute_K3": (300_000, 1, ("brute", 293, 384, 3)),
    "brute_K1": (1_500, 1, ("brute", 2, 128, 1)),
    "flat": (1_000_000, 1024, ("flat", 1024, 1024, 1)),
    "rec_Tk2": (2048 * 1024 - 5, 1024, ("rec", 2048, 2048, 2)),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_apply_route_matches_reference(case):
    """apply_route against apply_route_tpu and against v[perm], bit for
    bit, from the host route dict and from its upload."""
    N, tm, reach = ROUTES[case]
    perm = np.random.default_rng(N).permutation(N)
    ra = tpr.route_arrays_from_perm(perm, tile_multiple=tm)
    jra = jpr.route_arrays_from_perm(perm, tile_multiple=tm)
    _same_route(ra, jra)
    mp = ra["mid_planes"]
    assert (mp["kind"], ra["T"], ra["Tp"], mp["Tk"]) == reach
    v = np.random.default_rng(15).standard_normal(N).astype(np.float32)
    want = np.asarray(jpr.apply_route_tpu(jra, jnp.asarray(v)))
    kernels.reset_launches()
    got = tsp.apply_route(ra, _t(v)).numpy()
    assert all(w.launches == 0 for w, _, _ in kernels.KERNELS.values())
    np.testing.assert_array_equal(got, v[perm])
    np.testing.assert_array_equal(got, want)
    rd = tsp.route_to_device(ra, "cpu")
    np.testing.assert_array_equal(tsp.apply_route(rd, _t(v)).numpy(), want)


@pytest.mark.parametrize("kind", ["brute", "rec"])
def test_middle_pass_matches_pallas(kind):
    """middle_pass over the stream against the JAX package's, on the
    planes of the brute and recursive routes above."""
    N, tm, (_, _, Tp, _) = ROUTES["brute_K3" if kind == "brute" else "rec_Tk2"]
    ra = jpr.route_arrays_from_perm(np.random.default_rng(N).permutation(N),
                                    tile_multiple=tm)
    g1 = np.random.default_rng(16).standard_normal((8, Tp, 128)).astype(np.float32)
    want = np.asarray(jpr.middle_pass(jnp.asarray(g1), ra["mid_planes"]))
    got = tsp.middle_pass(_t(g1), tsp.mid_to_device(ra["mid_planes"], "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


def _native_off(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def test_route_planes_match_reference_native():
    """plan_route (the native coloring and plane pass), route_arrays,
    route_arrays_from_perm and middle_planes_from, array for array."""
    assert tnative.available() and jnative.available()
    perm = np.random.default_rng(17).permutation(300_000)
    tp, jp = troute.plan_route(perm), jroute.plan_route(perm)
    for k in ("s1", "mid", "s3"):
        np.testing.assert_array_equal(getattr(tp, k), getattr(jp, k))
    _same_route(tpr.route_arrays(tp), jpr.route_arrays(jp))
    perm = np.random.default_rng(18).permutation(2048 * 1024)
    ra, jra = (m.route_arrays_from_perm(perm) for m in (tpr, jpr))
    _same_route(ra, jra)
    tp, jp = (m.plan_route(perm, tile_multiple=1024) for m in (troute, jroute))
    for k in ("s1", "mid", "s3"):
        np.testing.assert_array_equal(getattr(tp, k), getattr(jp, k))
    mid = jp.mid
    _same_route(tpr.middle_planes_from(mid, 2048),
                jpr.middle_planes_from(mid, 2048))
    _same_route(troute.plan_mid_recursive(tp), jroute.plan_mid_recursive(jp))
    # the native-or-Python dispatch, on the first middle row's graph
    ca, cd = mid[0] >> 10, np.arange(2048, dtype=np.int32) >> 10
    np.testing.assert_array_equal(troute.euler_color(ca, cd, 2, 1024),
                                  jroute.euler_color(ca, cd, 2, 1024))


def test_route_planes_match_reference_without_native(monkeypatch):
    """The numpy paths with the native library switched off in both
    packages: plan_route through euler_color_py (a 3-tile route), and
    middle_planes_from's mid_recursive_planes at Tk 2.

    euler_color_py colors one 2048-edge middle row in ~0.13 s, so the
    1024 rows of a Tk 2 middle take minutes per package: it is held
    against the reference's on rows of that middle here, and the numpy
    decomposition around it runs with both packages' euler_color_py
    replaced by one shared (native) coloring."""
    mid = jroute.plan_route(np.random.default_rng(19).permutation(2048 * 1024),
                            tile_multiple=1024).mid
    _native_off(monkeypatch)
    perm = np.random.default_rng(20).permutation(3000)
    for tm in (1, 2):
        _same_route(tpr.route_arrays(troute.plan_route(perm, tile_multiple=tm)),
                    jpr.route_arrays(jroute.plan_route(perm, tile_multiple=tm)))
    _same_route(tpr.route_arrays_from_perm(perm, tile_multiple=1),
                jpr.route_arrays_from_perm(perm, tile_multiple=1))
    cd = np.arange(2048, dtype=np.int32) >> 10
    for q in (0, 511, 1023):
        np.testing.assert_array_equal(
            troute.euler_color_py(mid[q] >> 10, cd, 2, 1024),
            jroute.euler_color_py(mid[q] >> 10, cd, 2, 1024))

    def shared(src, dst, n_tiles, k):
        return tnative.euler_color_native(src, dst, n_tiles, k)

    monkeypatch.setattr(troute, "euler_color_py", shared)
    monkeypatch.setattr(jroute, "euler_color_py", shared)
    got = tpr.middle_planes_from(mid, 2048)
    assert got["kind"] == "rec" and got["Tk"] == 2
    _same_route(got, jpr.middle_planes_from(mid, 2048))


def test_brute_middle_refuses_int16_overflow():
    for mod in (tpr, jpr):
        with pytest.raises(ValueError, match="int16"):
            mod.middle_planes_from(np.zeros((1024, 32769), np.int32), 32769)


def _routed(case, monkeypatch):
    if case == "rmat_yb4":
        monkeypatch.setattr(jpr, "YB", 4)
        monkeypatch.setattr(tpr, "YB", 4)
        jcoo, _ = rmat(12, 16, 4)
    else:
        jcoo, _ = CASES[case][0]()
    sr = j_pack_routed(jcoo.to_csr(), hot="off")
    x = np.random.default_rng(5).standard_normal(jcoo.shape[1]).astype(np.float32)
    return jcoo, sr, x


@pytest.mark.parametrize("case", ["uniform_w16", "rmat_yb4", "powerlaw"])
def test_reduce_stream_matches_reduce_slices(monkeypatch, case):
    """K18 per reduce group against the JAX reduce_slices on the same
    stream-layout gx, within 1e-6 of the row scale; then the unfused
    composition (expand, middle_pass, K18 per group) against the fused
    K3 reduce, and its routed y against the float64 golden.  The cases
    reach zone A with a regular region, three reduce groups, and the
    recursive middle."""
    jcoo, sr, x = _routed(case, monkeypatch)
    sd = tsp.to_device_routed(from_reference(sr), "cpu")
    xt = _t(x)
    g1 = rk.expand(sd.w8, sd.gcls, sd.seg_blk, sd.li, xt, sd.segw, sd.n_segs)
    gx = tsp.middle_pass(g1, sd.mid)
    emit = _t(sr.emit)
    gemit = _t(tpr.group_emit_encode(sr.emit))
    kernels.reset_launches()
    ys = tsp.reduce_unfused(sd, gx, emit, gemit, sr.ycall_rows)
    assert rk.reduce_stream.launches == 0
    m, m3 = tsp.middle(sd, g1)
    ys_fused = tsp.reduce(sd, m, m3)
    abs_sd = dataclasses.replace(sd, vals_ss=sd.vals_ss.abs())
    scale = tsp.reduce(abs_sd, m.abs(), m3).numpy()
    assert ys.shape == ys_fused.shape
    err = np.abs(ys.numpy().astype(np.float64) - ys_fused.numpy())
    assert (err <= 1e-6 + 1e-6 * scale).all(), float(err.max())

    gxn = gx.numpy()
    YB = tpr.YB
    for j, (r0, nr) in enumerate(np.asarray(sr.ycall_rows).tolist()):
        nsl = min(YB, sr.nslices - j * YB)
        rows = slice(r0, r0 + nr)
        want = np.asarray(jpr.reduce_slices(
            jnp.asarray(sr.emit[rows]),
            jnp.asarray(tpr.group_emit_encode(sr.emit[rows])),
            jnp.asarray(sr.vals_ss[:, rows]), jnp.asarray(gxn[:, rows]),
            jnp.asarray(sr.p3[:, rows]), nsl))
        got = rk.reduce_stream(emit[rows], gemit[r0 // 8 : (r0 + nr) // 8],
                               sd.vals_ss[:, rows], gx[:, rows],
                               sd.p3[:, rows], nsl).numpy()
        err = np.abs(got.astype(np.float64) - want)
        sc = scale[:, j * YB : j * YB + nsl]
        assert (err <= 1e-6 + 1e-6 * sc).all(), (j, float(err.max()))

    csr = jcoo.to_csr()
    y = tsp.y_from_slices(sd, ys, xt).numpy()
    ok, nbad, maxrel = verify(y, spmv_golden_numpy(csr, x), rtol=1e-6,
                              row_scale=spmv_row_scale(csr, x))
    assert ok, (nbad, maxrel)


@pytest.mark.parametrize("name", ["route_flat", "groupperm", "reduce_stream"])
def test_new_wrappers_refuse_mixed_devices(name):
    meta = torch.empty((8, 1024, 128), dtype=torch.float32, device="meta")
    i16 = torch.zeros((8, 1024, 128), dtype=torch.int16)
    args = {
        "route_flat": (meta, i16),
        "groupperm": (meta, i16),
        "reduce_stream": (torch.full((1024,), -1, dtype=torch.int32),
                          torch.zeros(128, dtype=torch.int32), meta,
                          torch.zeros((8, 1024, 128)), i16, 4),
    }[name]
    wrapper = kernels.KERNELS[name][0]
    with pytest.raises(ValueError, match="mixed devices"):
        wrapper(*args)
    assert wrapper.launches == 0
