"""The redesigned K5/K17 (tileperm_kernel) and K16 (route_flat_kernel)
of the port, emulated in torch, against the plain versions and the JAX
package.

A CUDA kernel cannot run here, so each new body's staging and index
arithmetic is written out below as the kernel computes it, one block at a
time (vectorized over the blocks): the 16 B pieces each thread copies
into shared memory, from which flat offsets (32-bit: every offset is held
below 2^31), into which shared-memory slots, and from which slots each
output is gathered and to which flat offset it is stored.  The emulations
must give the plain versions' outputs bit for bit (both only move
values), with out-of-range indices (negative, or past the staged planes)
giving 0; the plain versions are held against the JAX package's
tileperm_ss, groupperm_ss and flat fused middle (Pallas in interpret
mode) at the same inputs.  groupperm_ss's interpret mode traces K*K
gather-and-select pairs (36 s at K 48 on this test host), so the JAX
package is asked at K 1 and 3, and K 48 (the brute middle of
web-Google-like's CSR->CSC route) and K 256 (the largest the int16 index
reaches, 192 KB of shared memory a block) are held against the plain
version.  The launch geometry's refusals are pure functions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvr_tpu.ops.pallas_route as jpr

from cvr_tpu_torch.ops import kernels
from cvr_tpu_torch.ops import route_kernels as rk
from cvr_tpu_torch.ops import route_planes as tpr

INT32_LIMIT = 2**31
BANKS = 32  # shared-memory banks of 4 B


def _t(a):
    return torch.from_numpy(np.array(a))


def _pieces(flat, offsets, width):
    """The ``width`` consecutive elements of ``flat`` at each offset (a 16
    B cp.async), the offsets' shape with a last axis of ``width``;
    offsets must fit the kernel's 32-bit arithmetic."""
    assert int(offsets.min()) >= 0 and int(offsets.max()) + width <= INT32_LIMIT
    return flat[offsets.unsqueeze(-1) + torch.arange(width)]


def _threads(n_items, n_threads):
    """The items a block's threads take in `for (j = t; j < n; j += N)`:
    each item once."""
    t = torch.arange(n_threads).view(-1, 1)
    k = torch.arange(-(-n_items // n_threads)).view(1, -1)
    j = (t + k * n_threads).reshape(-1)
    j = j[j < n_items]
    assert torch.equal(torch.sort(j).values, torch.arange(n_items))
    return j


def tileperm_emulated(data, idx, middle: bool, blocks=None):
    """tileperm_kernel<middle> on data and idx (P, R, 128), block by block:
    the out rows of the blocks (rows a) named, (P, len(blocks), 128).
    Block a stages its row's P plane rows of data (piece j: 32 a plane row)
    and of idx (16 a plane row) by 16 B copies, then piece j of idx gives
    the 8 outputs at flat offset ((j>>4)*R + a)*128 + (j&15)*8, each
    win[v] for v in [0, P*128), else 0."""
    P, R = data.shape[:2]
    assert P == 8 or middle
    n_threads = 256 if middle else 128
    smem = rk.tileperm_geometry(P, R)
    a = (torch.arange(R) if blocks is None else blocks).view(-1, 1)
    dflat, iflat, lim = data.reshape(-1), idx.reshape(-1), P * 128
    j = _threads(P * 32, n_threads)
    win = torch.empty((a.shape[0], lim), dtype=data.dtype)
    win.view(a.shape[0], -1, 4)[:, j] = _pieces(
        dflat, ((j >> 5) * R + a) * 128 + (j & 31) * 4, 4)
    j = _threads(P * 16, n_threads)
    six = torch.empty((a.shape[0], lim), dtype=idx.dtype)
    six.view(a.shape[0], -1, 8)[:, j] = _pieces(
        iflat, ((j >> 4) * R + a) * 128 + (j & 15) * 8, 8)
    assert win.shape[1] * 4 + six.shape[1] * 2 == smem  # P*768 B
    v = six.long()
    got = torch.where((v >= 0) & (v < lim),
                      torch.gather(win, 1, v.clamp(0, lim - 1)), 0.0)
    # store: piece j's 8 lanes at its flat offset (32-bit), each once
    dst = ((j >> 4) * R + a) * 128 + (j & 15) * 8
    dst = dst.unsqueeze(-1) + torch.arange(8)
    assert int(dst.max()) < INT32_LIMIT
    out = torch.zeros(P * R * 128, dtype=data.dtype)
    out[dst.reshape(-1)] = got.view(a.shape[0], -1, 8)[:, j].reshape(-1)
    return out.view(P, R, 128)[:, a.view(-1)]


def route_flat_emulated(g1, mid):
    """route_flat_kernel on g1 and mid (8, 1024, 128), block by block
    (blockIdx.x the strip of 8 lanes ql0 = 8*x, blockIdx.y qh): the strip's
    1024 rows of g1 (two 16 B pieces a row) at gs[v*8 + l], the 64 rows
    (fH, l) of mid (16 pieces a row) with piece c at c ^ l; output
    e = t + k*1024 of the block (f = e>>3, l = e&7) is gs[v*8 + l] for
    v = mid's row (fH, l) at fL, or 0.  Also returns the shared-memory word
    (4 B) each thread of each output's warp reads of mid, (k, warps, 32)
    per block, for the bank check."""
    gf, mf = g1.reshape(-1), mid.reshape(-1)
    x = torch.arange(16).view(16, 1, 1)
    qh = torch.arange(8).view(1, 8, 1)
    ql0 = 8 * x
    j = _threads(2048, 1024)
    gs = torch.empty((16, 8, 1024 * 8), dtype=g1.dtype)
    gs.view(16, 8, 2048, 4)[:, :, j] = _pieces(
        gf, (qh * 1024 + (j >> 1)) * 128 + ql0 + (j & 1) * 4, 4)
    t = torch.arange(1024)
    r, c = t >> 4, t & 15
    lr = r & 7
    ms = torch.empty((16, 8, 64 * 16, 8), dtype=mid.dtype)
    ms[:, :, r * 16 + (c ^ lr)] = _pieces(
        mf, ((r >> 3) * 1024 + qh * 128 + ql0 + lr) * 128 + c * 8, 8)
    ms = ms.view(16, 8, -1)
    assert (gs.shape[-1] * 4 + ms.shape[-1] * 2) == 48 * 1024
    e = t.view(1, 1024) + torch.arange(8).view(8, 1) * 1024  # (k, t)
    f, l = e >> 3, e & 7
    fL = f & 127
    slot = ((f >> 7) * 8 + l) * 128 + (((fL >> 3) ^ l) << 3) + (fL & 7)
    v = ms[:, :, slot].long()  # (16, 8, k, t)
    got = torch.where((v >= 0) & (v < 1024),
                      torch.gather(gs.unsqueeze(2).expand(-1, -1, 8, -1), 3,
                                   (v.clamp(0, 1023) * 8 + l)), 0.0)
    dst = ((qh.unsqueeze(-1) * 1024 + f) * 128 + ql0.unsqueeze(-1) + l)
    assert int(dst.max()) < INT32_LIMIT
    out = torch.full((8 * 1024 * 128,), float("nan"), dtype=g1.dtype)
    out[dst.reshape(-1)] = got.reshape(-1)
    assert torch.unique(dst).numel() == out.numel()  # every output once
    return out.view(8, 1024, 128), (slot >> 1).view(8, 32, 32)


def _perm_inputs(P, R, seed, lo=0, hi=None):
    """data (P, R, 128) f32 and idx (P, R, 128) int16 from a seed, idx
    in [lo, hi) (default [0, P*128)) within int16's range; numpy arrays."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((P, R, 128), dtype=np.float32)
    hi = min(P * 128 if hi is None else hi, 2**15)
    idx = rng.integers(lo, hi, (P, R, 128), dtype=np.int32).astype(np.int16)
    return data, idx


def _outside(idx, P):
    """Put indices outside [0, P*128) into idx: negative ones and, below
    K 256, ones past the staged planes (up to int16's largest), on plane
    0's first rows."""
    past = [min(P * 128 + d, 2**15 - 1) for d in (0, 127)]
    idx[0, :2, :6] = (-1, -128, -32768, *past, 2**15 - 1)


@pytest.mark.parametrize("T", [1024, 1000, 3])
def test_tileperm_emulation_matches_pallas(T):
    """K5 (P 8, any T: 1000 and 3 are not multiples of the JAX package's
    512-tile block) at the y-route's T and at ragged ones."""
    data, idx = _perm_inputs(8, T, T)
    _outside(idx, 8)
    want = np.asarray(jpr.tileperm_ss(jnp.asarray(data), jnp.asarray(idx)))
    plain = rk.tileperm_plain(_t(data), _t(idx))
    np.testing.assert_array_equal(plain.numpy(), want)
    got = tileperm_emulated(_t(data), _t(idx), middle=False)
    assert torch.equal(got, plain)
    assert (got[0, :2, :6] == 0).all()
    kernels.reset_launches()
    assert torch.equal(rk.tileperm(_t(data), _t(idx)), plain)
    assert rk.tileperm.launches == 0  # CPU tensors: the plain version ran


def test_tileperm_emulation_on_a_route_stage():
    """K5 on stage 1 and stage 3 planes of a compiled 2048-tile route
    (every index in [0, 1024): a permutation within each tile)."""
    perm = np.random.default_rng(21).permutation(2048 * 1024 - 7)
    ra = tpr.route_arrays_from_perm(perm)
    assert ra["Tp"] == 2048
    g = np.random.default_rng(22).standard_normal((8, 2048, 128), dtype=np.float32)
    for s in ("s1", "s3"):
        want = rk.tileperm_plain(_t(g), _t(ra[s]))
        assert torch.equal(tileperm_emulated(_t(g), _t(ra[s]), False), want)
        np.testing.assert_array_equal(
            want.numpy(), np.asarray(jpr.tileperm_ss(jnp.asarray(g),
                                                     jnp.asarray(ra[s]))))


@pytest.mark.parametrize("K", [1, 3])
def test_groupperm_emulation_matches_pallas(K):
    data, idx = _perm_inputs(K, 1024, 30 + K)
    _outside(idx, K)
    want = np.asarray(jpr.groupperm_ss(jnp.asarray(data), jnp.asarray(idx)))
    plain = rk.groupperm_plain(_t(data), _t(idx))
    np.testing.assert_array_equal(plain.numpy(), want)
    assert torch.equal(tileperm_emulated(_t(data), _t(idx), middle=True),
                       plain)


@pytest.mark.parametrize("K, nblocks", [(1, 1024), (48, 1024), (256, 96)])
def test_groupperm_emulation_matches_plain(K, nblocks):
    """K17 at K 1, 48 (web-Google-like's brute middle) and 256 (192 KB of
    shared memory a block; 96 of its 1,024 blocks emulated, rows a taken
    from a seed, against the plain version's rows)."""
    data, idx = _perm_inputs(K, 1024, 40 + K, lo=-3, hi=K * 128 + 3)
    _outside(idx, K)
    blocks = torch.from_numpy(np.sort(np.random.default_rng(K).choice(
        1024, nblocks, replace=False)))
    if 0 not in blocks:
        blocks = torch.cat([blocks.new_zeros(1), blocks])
    d, i = torch.from_numpy(data), torch.from_numpy(idx)
    got = tileperm_emulated(d, i, middle=True, blocks=blocks)
    want = rk.groupperm_plain(d[:, blocks], i[:, blocks])
    assert torch.equal(got, want)
    assert (got[0, :2, :(6 if K < 256 else 3)] == 0).all()
    assert rk.tileperm_geometry(K, 1024) == K * 768


def _flat_mid(seed):
    """The flat middle plane of a random permutation of 1024 tiles."""
    perm = np.random.default_rng(seed).permutation(1024 * 1024)
    mp = jpr.route_arrays_from_perm(perm)["mid_planes"]
    assert mp["kind"] == "flat"
    return mp["mid"]


@pytest.mark.parametrize("outside", [False, True])
def test_route_flat_emulation_matches_pallas(outside):
    """K16 on a route's flat middle plane, and with indices outside
    [0, 1024) put in (negative ones and ones past the 1,024 rows)."""
    mid = np.array(_flat_mid(12))
    if outside:
        _outside(mid, 8)
        mid[3, 100:104, 7] = (-5, 1024, 2000, -1024)
    g1 = np.random.default_rng(13).standard_normal((8, 1024, 128), dtype=np.float32)
    want = np.asarray(jpr._mid_fused_call(1, "flat", True)(jnp.asarray(g1),
                                                          jnp.asarray(mid)))
    plain = rk.route_flat_plain(_t(g1), _t(mid))
    np.testing.assert_array_equal(plain.numpy(), want)
    got, _ = route_flat_emulated(_t(g1), _t(mid))
    assert torch.equal(got, plain)
    kernels.reset_launches()
    assert torch.equal(rk.route_flat(_t(g1), _t(mid)), plain)
    assert rk.route_flat.launches == 0


def test_route_flat_index_reads_hit_distinct_banks():
    """The swizzle of the staged mid rows: in every warp's read of the
    index (4 rows f x 8 lanes l), the distinct 4 B words lie in distinct
    banks (no bank conflict), and the 8 lanes of one f in 8 groups."""
    _, words = route_flat_emulated(torch.zeros((8, 1024, 128)),
                                   torch.zeros((8, 1024, 128),
                                               dtype=torch.int16))
    for w in words.reshape(-1, 32):
        distinct = torch.unique(w)
        assert torch.unique(distinct % BANKS).numel() == distinct.numel()
        assert torch.unique(w[:8] % BANKS // 4).numel() == 8


@pytest.mark.parametrize("P, R, smem", [
    (8, 1024, 6144),
    (8, 2**21 - 1, 6144),  # P*R*128 just below 2^31
    (48, 1024, 36864),
    (256, 1024, 196608),  # K17's largest K
    (302, 1024, 231936),  # the most planes a block can stage
])
def test_tileperm_geometry(P, R, smem):
    assert rk.tileperm_geometry(P, R) == smem


@pytest.mark.parametrize("P, R", [
    (8, 2**21),  # 8*T*128 = 2^31: past the 32-bit indices
    (303, 1024),  # 232,704 B: past a block's shared memory
    (16384, 1024),  # both
])
def test_tileperm_geometry_refuses(P, R):
    with pytest.raises(ValueError):
        rk.tileperm_geometry(P, R)
