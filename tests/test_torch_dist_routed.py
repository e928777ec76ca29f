"""The row-sharded SpMVs of the port end to end on a CPU mesh, against the
JAX package's (its 8-device CPU mesh, Pallas in interpret mode) and the
float64 golden, at the row-scaled 1e-6 contract: the routed SpMV with x
replicated, all-gathered and moved round the ring (K15 per step), the
SELL SpMV, a JAX artifact carried across, and K15's plain version
against the JAX package's ring-step expand, bit for bit.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import cvr_tpu.parallel.dist_routed as jdr
from cvr_tpu.ops.pallas_route import expand_ring_step as j_expand_ring_step
from cvr_tpu.parallel.dist import dist_sell_pack as j_dist_sell_pack
from cvr_tpu.parallel.dist import dist_spmv as j_dist_spmv
from cvr_tpu.parallel.dist import make_mesh as j_make_mesh

import cvr_tpu_torch.parallel.dist_routed as tdr
from cvr_tpu_torch.formats.sell_routed import (
    RingSpec,
    ring_table_base,
    sell_pack_routed,
)
from cvr_tpu_torch.ops import kernels
from cvr_tpu_torch.ops import route_kernels as rk
from cvr_tpu_torch.ops import route_planes as tpr
from cvr_tpu_torch.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify
from cvr_tpu_torch.ops.spmv_routed import spmv_routed, to_device_routed
from cvr_tpu_torch.parallel import dist as tdist
from torch_cases import multisegment_tail, powerlaw, random_rect

REPO = Path(__file__).resolve().parent.parent
MODES = {
    "replicated": {},
    "x_sharded": {"x_sharded": True},
    "overlap": {"x_sharded": True, "overlap": True},
}
D = 4


def _blocks_powerlaw():
    """~600,000 nnz: three real tile blocks per shard on two shards, so
    that both ring steps expand real blocks."""
    return powerlaw(n=60000, avg_nnz=10, seed=5)[1]


def _cpu_mesh(n):
    return tdist.make_mesh(devices=["cpu"] * n)


def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _check(y, csr, x, ref=None):
    """y against the float64 golden (and ``ref``) at rtol 1e-6, scaled by
    |A| |x| row by row."""
    scale = spmv_row_scale(csr, x)
    ok, nbad, maxrel = verify(y, spmv_golden_numpy(csr, x), rtol=1e-6,
                              row_scale=scale)
    assert ok, f"golden: {nbad} bad rows, max rel {maxrel}"
    if ref is not None:
        ok, nbad, maxrel = verify(y, ref, rtol=1e-6, row_scale=scale)
        assert ok, f"JAX: {nbad} bad rows, max rel {maxrel}"


def _port_y(dm, x, **mode):
    kernels.reset_launches()
    y = tdr.dist_spmv_routed(dm, torch.from_numpy(x), **mode).numpy()
    # CPU tensors: every pass ran its plain version, no kernel launched
    assert not any(kernels.launches().values())
    return y


@pytest.fixture(scope="module")
def ring_pair():
    """One ring pack of a power-law matrix on 4 shards in each package,
    and the JAX package's y in each mode (interpret mode: ~15 s each)."""
    jcoo, tcoo = powerlaw(n=6000, avg_nnz=8, seed=11)
    x = _x(6000)
    jdm = jdr.dist_routed_pack(jcoo.to_csr(), j_make_mesh(D), overlap=True)
    y_jax = {name: np.asarray(jdr.dist_spmv_routed(jdm, x, **mode))
             for name, mode in MODES.items()}
    tdm = tdr.dist_routed_pack(tcoo.to_csr(), _cpu_mesh(D), overlap=True)
    return tcoo.to_csr(), x, jdm, tdm, y_jax


@pytest.mark.parametrize("mode", sorted(MODES))
def test_dist_spmv_routed_matches_reference(ring_pair, mode):
    csr, x, _, tdm, y_jax = ring_pair
    _check(_port_y(tdm, x, **MODES[mode]), csr, x, y_jax[mode])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_reference_artifact_carried_across(ring_pair, mode):
    """from_reference: the JAX package's own planes drive the port."""
    csr, x, jdm, tdm, y_jax = ring_pair
    rdm = tdr.from_reference(jdm, _cpu_mesh(D))
    assert rdm.meta == tdm.meta
    for pr, pt in zip(rdm.planes, tdm.planes, strict=True):
        for k in pt:
            np.testing.assert_array_equal(pr[k], pt[k], err_msg=k)
    _check(_port_y(rdm, x, **MODES[mode]), csr, x, y_jax[mode])


@pytest.mark.parametrize("x_sharded", [False, True])
def test_dist_spmv_matches_reference(x_sharded):
    """The SELL planes per shard (gather, slice sums, unpermute), with
    uneven ncols (777 columns on 4 shards)."""
    jcoo, tcoo = random_rect(nrows=1003, ncols=777, density=0.02, seed=4)
    x = _x(777, seed=2)
    jdm = j_dist_sell_pack(jcoo.to_csr(), j_make_mesh(D))
    y_jax = np.asarray(j_dist_spmv(jdm, x, x_sharded=x_sharded))
    tdm = tdist.dist_sell_pack(tcoo.to_csr(), _cpu_mesh(D))
    for k, v in jdm.planes.items():
        for i in range(D):
            np.testing.assert_array_equal(np.asarray(v)[i],
                                          tdm.planes[i][k].numpy())
    np.testing.assert_array_equal(np.asarray(jdm.unpad_index),
                                  tdm.unpad_index.numpy())
    y = tdist.dist_spmv_jit(tdm, x_sharded=x_sharded)(torch.from_numpy(x))
    _check(y.numpy(), tcoo.to_csr(), x, y_jax)


@pytest.mark.parametrize("case", ["rect_uneven", "powerlaw_2", "tail_8"])
def test_dist_spmv_routed_against_golden(case):
    """Every mode, the port alone: uneven ncols (700 on 4 shards), two
    shards, and 8 shards of a matrix whose entries all lie in the last
    ring piece (real blocks at steps whose table starts at segment 1)."""
    tcoo, n = {
        "rect_uneven": lambda: (random_rect()[1], 4),
        "powerlaw_2": lambda: (_blocks_powerlaw(), 2),
        "tail_8": lambda: (multisegment_tail()[1], 8),
    }[case]()
    csr = tcoo.to_csr()
    dm = tdr.dist_routed_pack(csr, _cpu_mesh(n), overlap=True)
    x = _x(csr.shape[1], seed=3)
    for name, mode in MODES.items():
        y = tdr.dist_spmv_routed_jit(dm, **mode)(torch.from_numpy(x))
        _check(y.numpy(), csr, x)

    # the single-card routed SpMV of the same matrix agrees
    sd = to_device_routed(sell_pack_routed(csr, hot="off"), "cpu")
    _check(spmv_routed(sd, torch.from_numpy(x)).numpy(), csr, x)


def _ring_xg(dm, i, s, x):
    """Shard i's gathered-x buffer at ring step s: the pieces that have
    arrived by then, zeros elsewhere."""
    m, n = dm.meta, dm.n_shards
    Wr, segw8 = m["ring_Wr"], m["segw"] * 8
    xp = np.zeros(n * Wr * 128, np.float32)
    xp[: x.shape[0]] = x
    xp = xp.reshape(n * Wr, 128)
    xg = np.zeros((max(m["n_segs"] * segw8 + 8, n * Wr), 128), np.float32)
    for t in range(s + 1):
        p = (i - t) % n
        xg[p * Wr : (p + 1) * Wr] = xp[p * Wr : (p + 1) * Wr]
    return xg


def _steps(dm, shards, only_k_lo=False):
    """(shard, step, off, cnt, k_lo) of every ring step with blocks (only
    those whose table starts above segment 0, with ``only_k_lo``)."""
    m, n = dm.meta, dm.n_shards
    off = np.concatenate([[0], np.cumsum(m["ring_cnt"])])
    out = []
    for i in shards:
        k_lo = ring_table_base(RingSpec(n, i, m["ring_Wr"], m["ring_cnt"]),
                               m["segw"])
        for s in range(n):
            if m["ring_cnt"][s] and (k_lo[s] or not only_k_lo):
                out.append((i, s, int(off[s]), int(m["ring_cnt"][s]),
                            int(k_lo[s])))
    return out


@pytest.mark.parametrize("case", ["powerlaw_2", "tail_8"])
def test_expand_ring_plain_matches_reference(case):
    """K15's plain version and its wrapper on CPU tensors against the JAX
    package's ring-step expand (the Pallas kernel in interpret mode) over
    the x table the JAX package builds for the step, bit for bit: every
    step of both shards of a two-shard ring pack, and the steps of shard 0
    of an 8-shard pack whose table starts at segment 1."""
    if case == "powerlaw_2":
        tcoo, n, shards, only = _blocks_powerlaw(), 2, (0, 1), False
    else:
        tcoo, n, shards, only = multisegment_tail()[1], 8, (0,), True
    csr = tcoo.to_csr()
    dm = tdr.dist_routed_pack(csr, _cpu_mesh(n), overlap=True)
    x = _x(csr.shape[1], seed=4)
    m = dm.meta
    segw, segw8, TB = m["segw"], m["segw"] * 8, tpr.TB
    steps = _steps(dm, shards, only)
    assert len(steps) >= (4 if case == "powerlaw_2" else 1)
    for i, s, o0, cnt, k_lo in steps:
        pl = dm.planes[i]
        xg = _ring_xg(dm, i, s, x)
        w8_s = pl["w8"][o0 * TB : (o0 + cnt) * TB]
        gcls_s = pl["gcls"][o0 * TB // 8 : (o0 + cnt) * TB // 8]
        seg_s = pl["seg_ring"][o0 : o0 + cnt]
        nseg = max(int(m["ring_nsegtab"][s]), 1)
        tab = jax.numpy.concatenate([
            jax.lax.dynamic_slice(jax.numpy.asarray(xg),
                                  ((k_lo + c) * segw8, 0), (segw8 + 8, 128))
            for c in range(nseg)
        ])
        want = np.asarray(j_expand_ring_step(o0, cnt, w8_s, gcls_s, seg_s,
                                             pl["li"], tab, segw))
        args = [torch.from_numpy(np.ascontiguousarray(a))
                for a in (w8_s, gcls_s, seg_s, pl["li"], xg)]
        got = rk.expand_ring_plain(*args, o0, k_lo, segw).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{i} {s}")
        g1 = torch.full((8, m["T"], 128), float("nan"))
        out = rk.expand_ring(*args, o0, k_lo, segw, g1)
        np.testing.assert_array_equal(out.numpy(), want)
        assert torch.isnan(g1[:, : o0 * TB]).all()  # nothing else written
        assert rk.expand_ring.launches == 0


def test_early_block_fails_the_golden():
    """The ring schedule matters: a block moved one step before its
    unlock step reads x pieces that have not arrived (zeros) and y is
    wrong, while the pack's own schedule is right."""
    csr = _blocks_powerlaw().to_csr()
    dm = tdr.dist_routed_pack(csr, _cpu_mesh(2), overlap=True)
    x = _x(csr.shape[1], seed=6)
    mode = MODES["overlap"]
    _check(_port_y(dm, x, **mode), csr, x)
    cnt = list(dm.meta["ring_cnt"])
    assert cnt[0] and cnt[1]
    # the first block of step 1 (in every shard) runs at step 0
    early = dataclasses.replace(
        dm, meta={**dm.meta, "ring_cnt": (cnt[0] + 1, cnt[1] - 1)})
    y = _port_y(early, x, **mode)
    ok, nbad, _ = verify(y, spmv_golden_numpy(csr, x), rtol=1e-6,
                         row_scale=spmv_row_scale(csr, x))
    assert not ok and nbad > 0


def test_overlap_needs_a_ring_pack_and_sharded_x():
    tcoo = powerlaw(n=800, seed=2)[1]
    dm = tdr.dist_routed_pack(tcoo.to_csr(), _cpu_mesh(2))
    x = torch.from_numpy(_x(800))
    with pytest.raises(ValueError, match="x_sharded"):
        tdr.dist_spmv_routed(dm, x, overlap=True)
    with pytest.raises(ValueError, match="overlap=True"):
        tdr.dist_spmv_routed(dm, x, x_sharded=True, overlap=True)


def test_make_mesh_needs_a_card():
    """make_mesh() takes the CUDA devices and raises where there are none,
    never falling back to the CPU; the multi-process entry is not
    ported."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.make_mesh()
    mesh = tdist.make_mesh(2, devices=["cpu"] * 4)
    assert mesh.size == 2 and mesh.devices == (torch.device("cpu"),) * 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdist.initialize_distributed()


def test_to_device_routed_defaults_to_the_card():
    """Without a device the upload goes to the card: on a host without one
    it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sr = sell_pack_routed(powerlaw(n=500, seed=1)[1].to_csr(), hot="off")
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        to_device_routed(sr)


def test_parallel_imports_no_jax():
    code = (
        "import sys, cvr_tpu_torch.parallel\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'cvr_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
