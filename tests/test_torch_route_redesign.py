"""The redesigned K4 and K1 of the port against the JAX package.

K4 (route_small) gathers the y stream by one int32 index that
spmv_routed.compose_route composes at upload from the route's stage
planes (route_to_device); on a flat route the index followed by K4's
plain gather must equal the three-plane chain (route_small_chain) and the
JAX package's small route (_sr1_kernel + _sr2_kernel, Pallas in interpret
mode) bit for bit.  K1's
launch geometry (expand_blocks) is a pure function and refuses what the
kernel's 32-bit indices cannot reach.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvr_tpu.ops.pallas_route as jpr
from cvr_tpu.formats.sell_routed import sell_pack_routed as j_pack_routed

import cvr_tpu_torch.parallel.dist_routed as tdr
from cvr_tpu_torch.ops import kernels
from cvr_tpu_torch.ops import route_kernels as rk
from cvr_tpu_torch.ops import route_planes as tpr
from cvr_tpu_torch.ops import spmv_routed as tsp
from cvr_tpu_torch.parallel import dist as tdist
from torch_cases import CASES, powerlaw


def _t(a):
    return torch.from_numpy(np.array(a))


def _split16_route():
    """The y-route of test_route_small_matches_pallas's pack (rmat_split16,
    split_len 16): flat, n 1024."""
    jcoo, _ = CASES["rmat_split16"][0]()
    return j_pack_routed(jcoo.to_csr(), split_len=16, hot="off").y_ra


def _ragged_route():
    """A flat route over a random permutation of 1024 tiles, keeping
    n = 1,000,003 outputs: neither a multiple of 1024 nor of 4."""
    perm = np.random.default_rng(12).permutation(1024 * 1024)
    return tpr.route_arrays_from_perm(perm, n=1_000_003)


@functools.cache
def _dist_pack():
    """A forced 4-shard routed pack on the CPU (every shard at the largest
    one's geometry and y length)."""
    coo = powerlaw(n=3000, seed=3)[1]
    return tdr.dist_routed_pack(coo.to_csr(),
                                tdist.make_mesh(devices=["cpu"] * 4))


def _shard_route(dm, p):
    """The y-route arrays of the shard whose planes are ``p``."""
    m = dm.meta
    return {"s1": p["y_s1"], "s3": p["y_s3"], "n": m["y_n"], "T": m["y_T"],
            "Tp": m["y_Tp"],
            "mid_planes": {"kind": m["ymid_kind"], "Tk": m["ymid_Tk"],
                           "mid": p["ymid_mid"]}}


def _dist_shard_route():
    """Shard 0's y-route of the forced pack."""
    dm = _dist_pack()
    return _shard_route(dm, dm.planes[0])


ROUTES = {"split16": _split16_route, "ragged": _ragged_route,
          "dist_shard": _dist_shard_route}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_compose_small_route_matches_pallas(case):
    ra = ROUTES[case]()
    mp = ra["mid_planes"]
    assert mp["kind"] == "flat"
    n = ra["n"]
    if case == "ragged":
        assert n % 1024 and n % 4
    src = tsp.route_to_device(ra, "cpu").src.numpy()
    assert src.dtype == np.int32 and src.shape == (n,)
    ysp = np.random.default_rng(3).standard_normal((8, 1024, 128)).astype(np.float32)
    want = np.asarray(jpr._route_small_call(True)(
        jnp.asarray(ysp), ra["s1"], mp["mid"], ra["s3"]))[:n]
    kernels.reset_launches()
    got = rk.route_small(_t(ysp), _t(src), n)
    assert rk.route_small.launches == 0  # CPU tensors: the plain version ran
    chain = rk.route_small_chain(_t(ysp), _t(ra["s1"]), _t(mp["mid"]),
                                 _t(ra["s3"]), n)
    np.testing.assert_array_equal(chain.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want)


def test_compose_small_route_is_a_permutation():
    """The composed index of a whole flat route (n = 2^20) names every
    element of the stream once."""
    ra = {**_ragged_route(), "n": 1024 * 1024}
    src = tsp.route_to_device(ra, "cpu").src.numpy()
    np.testing.assert_array_equal(np.sort(src), np.arange(1024 * 1024))


def test_dist_shards_carry_the_composed_index():
    """Every shard of a forced routed pack uploads its y-route's index,
    composed from its own planes."""
    dm = _dist_pack()
    for p, sd in zip(dm.planes, dm.shards):
        want = tsp.route_to_device(_shard_route(dm, p), "cpu").src
        assert torch.equal(sd.yroute.src, want)


def _route(kind):
    if kind == "flat":
        return _split16_route()
    if kind == "rec":
        perm = np.random.default_rng(4).permutation(2048 * 1024)
        return tpr.route_arrays_from_perm(perm)
    perm = np.random.default_rng(11).permutation(300_000)
    return tpr.route_arrays_from_perm(perm, tile_multiple=1)


@pytest.mark.parametrize("kind", ["flat", "rec", "brute"])
def test_route_to_device_carries_src_for_flat_routes(kind):
    ra = _route(kind)
    assert ra["mid_planes"]["kind"] == kind
    rd = tsp.route_to_device(ra, "cpu")
    if kind != "flat":
        assert rd.src is None
        return
    assert rd.src.dtype == torch.int32
    ysp = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 1024, 128)).astype(np.float32))
    assert torch.equal(
        rk.route_small_plain(ysp, rd.src, ra["n"]),
        rk.route_small_chain(ysp, rd.s1, rd.mid.mid, rd.s3, ra["n"]))


@pytest.mark.parametrize("T, n, xlen", [
    (1024, 1024, 1 << 20),
    (98304, 98304, 1 << 27),  # pack_auto's routed cap
    (7168, 1536, 1 << 20),  # a ring step's blocks
    (2**21 - 8, 8, 1 << 20),  # 8*T*128 just below 2^31
])
def test_expand_blocks(T, n, xlen):
    """One block per tile launched."""
    assert rk.expand_blocks(T, n, xlen) == n


@pytest.mark.parametrize("T, n, xlen", [
    (2**21, 8, 1 << 20),  # 8*T*128 = 2^31
    (1024, 1024, 2**31),  # xlen past 2^31 - 1
    (1024, 1028, 1 << 20),  # more tiles than the stream's
    (1024, -8, 1 << 20),
])
def test_expand_blocks_refuses(T, n, xlen):
    with pytest.raises(ValueError):
        rk.expand_blocks(T, n, xlen)
