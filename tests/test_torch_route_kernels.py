"""Each device pass of the port against its Pallas counterpart.

The JAX passes run as the JAX package's own tests run them on the CPU
(Pallas interpret mode); the port's wrappers run their plain versions,
because the tensors lie on the CPU.  Both read the same planes: the JAX
pack carried across with ``from_reference``.  Passes that only move
values must agree bit for bit; the reduce sums in another order and is
held to the row-scaled 1e-6 contract of the golden verifier.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvr_tpu.ops.pallas_route as jpr
import cvr_tpu.ops.spmv_routed as jsr_mod
from cvr_tpu.formats.sell_routed import sell_pack_routed as j_pack_routed

import cvr_tpu_torch.ops.route_planes as tpr
from cvr_tpu_torch.formats.sell_routed import from_reference
from cvr_tpu_torch.ops import kernels
from cvr_tpu_torch.ops import route_kernels as rk
from cvr_tpu_torch.ops import spmv_routed as tsp
from torch_cases import CASES, multisegment, powerlaw, rmat, uniform_rows


def _packed(make, split_len=None):
    jcoo, _ = make()
    sr = j_pack_routed(jcoo.to_csr(), split_len=split_len, hot="off")
    x = np.random.default_rng(5).standard_normal(jcoo.shape[1]).astype(np.float32)
    return sr, x


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", ["multisegment", "powerlaw", "uniform_w16"])
def test_expand_matches_pallas(case):
    sr, x = _packed(CASES[case][0])
    x2 = jpr.expand_x_table(jnp.asarray(x), sr.shape[1], sr.segw, sr.n_segs)
    want = np.asarray(jpr.expand(sr.w8, sr.gcls, sr.seg_blk, sr.li, x2, sr.segw))
    np.testing.assert_array_equal(
        rk.expand_x_table(_t(x), sr.segw, sr.n_segs).numpy(), np.asarray(x2)
    )
    kernels.reset_launches()
    got = rk.expand(_t(sr.w8), _t(sr.gcls), _t(sr.seg_blk), _t(sr.li), _t(x),
                    sr.segw, sr.n_segs)
    np.testing.assert_array_equal(got.numpy(), want)
    assert rk.expand.launches == 0  # CPU tensors: the plain version ran


def _capture_ysp(monkeypatch, sd, x):
    """Run the JAX pipeline and keep the y-route's input stream."""
    seen = {}
    real = jsr_mod.apply_route_stream

    def spy(ra, ysp):
        seen["ysp"] = np.asarray(ysp)
        return real(ra, ysp)

    monkeypatch.setattr(jsr_mod, "apply_route_stream", spy)
    y = np.asarray(jsr_mod.spmv_routed(sd, jnp.asarray(x)))
    return seen["ysp"], y


@pytest.mark.parametrize("s3fast", ["packed", "off"])
@pytest.mark.parametrize("case", ["uniform_w16", "rmat_yb4"])
def test_reduce_matches_pallas(monkeypatch, case, s3fast):
    """reduce_m3_slices + reduce_m3_regular (and the zone-A fold) against
    K3's plain version, with stage 3 aligned where the pack says so and
    with the aligned path switched off in both packages."""
    if case == "rmat_yb4":
        monkeypatch.setattr(jpr, "YB", 4)
        monkeypatch.setattr(tpr, "YB", 4)
        sr, x = _packed(lambda: rmat(12, 16, 4))
        assert len(sr.ycall_rows) >= 3
    else:
        sr, x = _packed(uniform_rows)
        assert sr.regions.shape[0] > 0
    assert sr.nslA > 0
    jsd = jsr_mod.to_device_routed(sr)
    tsd = tsp.to_device_routed(from_reference(sr), "cpu")
    if s3fast == "off":
        jsd = dataclasses.replace(jsd, zone_rows=0)
        tsd = dataclasses.replace(tsd, red_fast=torch.zeros_like(tsd.red_fast))
    else:
        assert bool(tsd.red_fast.any())
    want, _ = _capture_ysp(monkeypatch, jsd, x)

    g1 = rk.expand(tsd.w8, tsd.gcls, tsd.seg_blk, tsd.li, _t(x), tsd.segw,
                   tsd.n_segs)
    m, m3 = tsp.middle(tsd, g1)
    got = tsp.y_stream(tsd, tsp.reduce(tsd, m, m3)).numpy()
    # row scale: the same sums over |vals| * |gathered x|
    abs_sd = dataclasses.replace(tsd, vals_ss=tsd.vals_ss.abs())
    scale = tsp.y_stream(abs_sd, tsp.reduce(abs_sd, m.abs(), m3)).numpy()
    assert got.shape == want.shape
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= 1e-6 + 1e-6 * scale).all(), float(err.max())


def test_route_small_matches_pallas():
    sr, _ = _packed(CASES["rmat_split16"][0], split_len=16)
    ya = sr.y_ra
    assert ya["Tp"] == 1024 and ya["mid_planes"]["kind"] == "flat"
    ysp = np.random.default_rng(3).standard_normal((8, 1024, 128)).astype(np.float32)
    want = np.asarray(jpr._route_small_call(True)(
        jnp.asarray(ysp), ya["s1"], ya["mid_planes"]["mid"], ya["s3"]
    ))[: ya["n"]]
    got = rk.route_small(_t(ysp), _t(ya["s1"]), _t(ya["mid_planes"]["mid"]),
                         _t(ya["s3"]), ya["n"])
    np.testing.assert_array_equal(got.numpy(), want)


def test_route_middle_matches_pallas():
    """M1 + chunk select at Tk = 2, on the planes of a random route over
    2048 tiles (the packs of CPU-sized matrices round T to 1024 tiles and
    never reach the recursive middle)."""
    perm = np.random.default_rng(4).permutation(2048 * 1024)
    mp = jpr.route_arrays_from_perm(perm)["mid_planes"]
    assert mp["kind"] == "rec" and mp["Tk"] == 2
    g1 = np.random.default_rng(6).standard_normal((8, 2048, 128)).astype(np.float32)
    m = jpr._mid_fused_call(2, "m1", True)(jnp.asarray(g1), mp["m1"])
    want = np.asarray(jpr.chunksel(m, mp["csel"], 2))
    got = rk.route_middle(_t(g1), _t(mp["m1"]), _t(mp["csel"]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_layout_helpers_match_reference():
    g = np.random.default_rng(8).standard_normal((8, 2048, 128)).astype(np.float32)
    np.testing.assert_array_equal(
        rk.stream_to_mstream(_t(g), 2).numpy(),
        np.asarray(jpr.stream_to_mstream(jnp.asarray(g), 2)),
    )
    flat = np.asarray(jpr.stream_to_flat(jnp.asarray(g)))
    np.testing.assert_array_equal(rk.stream_to_flat(_t(g)).numpy(), flat)
    np.testing.assert_array_equal(
        rk.flat_to_stream(_t(flat), 2048).numpy(),
        np.asarray(jpr.flat_to_stream(jnp.asarray(flat), 2048)),
    )


def test_wrappers_refuse_mixed_devices():
    sr, x = _packed(lambda: multisegment(seed=3))
    meta = torch.empty(sr.w8.shape, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="mixed devices"):
        rk.expand(meta, _t(sr.gcls), _t(sr.seg_blk), _t(sr.li), _t(x),
                  sr.segw, sr.n_segs)


@pytest.mark.parametrize("T", [256, 2048])
def test_tileperm_matches_pallas(T):
    rng = np.random.default_rng(T)
    data = rng.standard_normal((8, T, 128)).astype(np.float32)
    idx = rng.integers(0, 1024, (8, T, 128)).astype(np.int16)
    want = np.asarray(jpr.tileperm_ss(jnp.asarray(data), jnp.asarray(idx)))
    kernels.reset_launches()
    got = rk.tileperm(_t(data), _t(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert rk.tileperm.launches == 0


def _random_route_2048():
    """The planes of a random route over 2048 tiles (recursive middle,
    Tk = 2), as in test_route_middle_matches_pallas."""
    ra = jpr.route_arrays_from_perm(np.random.default_rng(4).permutation(2048 * 1024))
    assert ra["Tp"] == 2048 and ra["mid_planes"]["kind"] == "rec"
    return ra


def test_route_m3_matches_pallas():
    mp = _random_route_2048()["mid_planes"]
    m = np.random.default_rng(9).standard_normal((8, 2048, 128)).astype(np.float32)
    want = np.asarray(jpr._mid_fused_call(2, "m3", True)(jnp.asarray(m), mp["m3"]))
    got = rk.route_m3(_t(m), _t(mp["m3"]))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        rk.mstream_to_stream(_t(m), 2).numpy(),
        np.asarray(jpr.mstream_to_stream(jnp.asarray(m), 2)),
    )


def test_apply_route_stream_matches_pallas():
    """The whole 2048-tile route (K5, K2, K6, K5 and the flatten) against
    the JAX package's apply_route_stream, and against the permutation."""
    ra = _random_route_2048()
    g = np.random.default_rng(10).standard_normal((8, 2048, 128)).astype(np.float32)
    want = np.asarray(jpr.apply_route_stream(ra, jnp.asarray(g)))
    rd = tsp.route_to_device(ra, "cpu")
    kernels.reset_launches()
    got = tsp.apply_route_stream(rd, _t(g)).numpy()
    np.testing.assert_array_equal(got, want)
    assert all(w.launches == 0 for w, _, _ in kernels.KERNELS.values())
    perm = np.random.default_rng(4).permutation(2048 * 1024)
    np.testing.assert_array_equal(got, rk.stream_to_flat(_t(g)).numpy()[perm])


def test_brute_route_uploads():
    """A route over T tiles not a multiple of 1024 (293 here) has the
    brute middle: its (K, 1024, 128) int16 plane goes to the device as it
    is, with Tk == K == Tp / 128."""
    perm = np.random.default_rng(11).permutation(300_000)
    ra = tpr.route_arrays_from_perm(perm, tile_multiple=1)
    assert (ra["T"], ra["Tp"]) == (293, 384)
    rd = tsp.route_to_device(ra, "cpu")
    assert (rd.mid.kind, rd.mid.Tk) == ("brute", 3)
    assert rd.mid.m1 is None and rd.mid.mid.dtype == torch.int16
    assert tuple(rd.mid.mid.shape) == (3, 1024, 128)
    np.testing.assert_array_equal(rd.mid.mid.numpy(), ra["mid_planes"]["mid"])
    # identity columns pad tiles [T, Tp) of every middle row
    mid = rd.mid.mid.numpy().transpose(1, 0, 2).reshape(1024, 384)
    np.testing.assert_array_equal(mid[:, 293:],
                                  np.broadcast_to(np.arange(293, 384), (1024, 91)))
