"""The multi-device dry run: every row-sharded path once, on tiny shapes,
each held against the float64 golden.

    python -m cvr_tpu_torch.parallel.dryrun [N]

``dryrun_multichip(n)`` runs the JAX package's ten distributed paths
(``__graft_entry__.dryrun_multichip``) at its shapes and seeds on a mesh
of n shard devices: by default n shards of the first card (the moves are
then copies inside it), or ``devices`` (``["cpu"] * n`` runs it on the
CPU, each kernel's plain version in its place).  The paths: the SELL
SpMV, SELL-W (K10), the routed SpMV (K1, K3, K4) with x all-gathered and
on the ring (K15), the 2-D mesh (n >= 4 and even: n / 2 x 2), DIA (K8),
BELL with its routed spill (K9, K1, K3, K4), and the lane (K13, K 8),
PMM (K14, K 16) and BSR (K12, K 4) SpMMs, each with x (X) row-sharded
and all-gathered.  An SpMV is held at rtol 1e-6 of the row scale
sum |a| |x|, an SpMM at a max relative error below 1e-6 over |A| @ |X|;
each prints the JAX package's line, and any failure raises.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from cvr_tpu_torch.bench.synthetic import (
    banded_matrix,
    fsm_like,
    rmat_matrix,
    road_usa_like,
)
from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify
from cvr_tpu_torch.parallel.dist import dist_sell_pack, dist_spmv, make_mesh
from cvr_tpu_torch.parallel.dist2d import (
    dist_routed_pack_2d,
    dist_spmv_routed_2d,
    make_mesh2d,
)
from cvr_tpu_torch.parallel.dist_bell import dist_bell_pack, dist_spmv_bell
from cvr_tpu_torch.parallel.dist_bsr import dist_bsr_pack, dist_spmm_bsr
from cvr_tpu_torch.parallel.dist_dia import dist_dia_pack, dist_spmv_dia
from cvr_tpu_torch.parallel.dist_lane import dist_lane_pack, dist_spmm_lane
from cvr_tpu_torch.parallel.dist_pmm import dist_pmm_pack, dist_spmm_pmm
from cvr_tpu_torch.parallel.dist_routed import (
    dist_routed_pack,
    dist_spmv_routed,
)
from cvr_tpu_torch.parallel.dist_window import (
    dist_spmv_window,
    dist_window_pack,
)


def _rng(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _spmv_ok(what, y, csr, x):
    ok, nbad, maxrel = verify(y.cpu().numpy(), spmv_golden_numpy(csr, x),
                              rtol=1e-6, row_scale=spmv_row_scale(csr, x))
    if not ok:
        raise AssertionError(f"{what} mismatch: {nbad} rows, max rel "
                             f"{maxrel}")
    return maxrel


def _spmm_ok(what, Y, csr, X):
    m64 = csr.to_scipy().astype(np.float64)
    X64 = X.astype(np.float64)
    scale = abs(m64) @ np.abs(X64) + 1e-30
    maxrel = float((np.abs(Y.cpu().numpy() - m64 @ X64) / scale).max())
    if not maxrel < 1e-6:  # NaN fails too
        raise AssertionError(f"{what} mismatch: max rel {maxrel}")
    return maxrel


def _drop_last_columns(csr: CSRMatrix, n: int) -> CSRMatrix:
    """csr without its last n columns (so that ncols % D != 0)."""
    keep = csr.cols < csr.shape[1] - n
    rowid = np.repeat(np.arange(csr.shape[0]), np.diff(csr.rowptr))[keep]
    rowptr = np.zeros(csr.shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(rowid, minlength=csr.shape[0]), out=rowptr[1:])
    return CSRMatrix(rowptr=rowptr, cols=csr.cols[keep],
                     vals=csr.vals[keep],
                     shape=(csr.shape[0], csr.shape[1] - n))


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The ten distributed paths on ``make_mesh(devices=devices or
    ["cuda:0"] * n_devices)``, each verified (see the module doc)."""
    n = n_devices
    devices = list(devices or ["cuda:0"] * n)
    if len(devices) != n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    mesh = make_mesh(devices=devices)
    dev = mesh.devices[0]

    def put(a):
        return torch.from_numpy(a).to(dev)

    tag = f"dryrun_multichip({n})"

    # the SELL SpMV: row-sharded planes, x all-gathered
    csr = rmat_matrix(scale=8, edge_factor=6, seed=1).to_csr()  # 256 x 256
    x = _rng(1, csr.shape[1])
    y = dist_spmv(dist_sell_pack(csr, mesh, C=8), put(x), x_sharded=True)
    maxrel = _spmv_ok("multichip dryrun", y, csr, x)
    print(f"{tag}: OK — y[{tuple(y.shape)}] verified (max rel err "
          f"{maxrel:.2e})")

    # SELL-W: K10 per shard on a locality-structured matrix
    csr_b = banded_matrix(n=4096, bandwidth=9, seed=2).to_csr()
    xb = _rng(2, csr_b.shape[1])
    yb = dist_spmv_window(dist_window_pack(csr_b, mesh), put(xb),
                          x_sharded=True)
    maxrel = _spmv_ok("dist window dryrun", yb, csr_b, xb)
    print(f"{tag}: window-kernel path OK — y[{tuple(yb.shape)}] verified "
          f"(max rel err {maxrel:.2e})")

    # the routed SpMV under one forced geometry, ncols % n != 0
    csr_r = _drop_last_columns(
        rmat_matrix(scale=10, edge_factor=7, seed=5).to_csr(), 3)
    xr = _rng(4, csr_r.shape[1])
    yr = dist_spmv_routed(dist_routed_pack(csr_r, mesh), put(xr),
                          x_sharded=True)
    maxrel = _spmv_ok("dist routed dryrun", yr, csr_r, xr)
    print(f"{tag}: ROUTED path OK — y[{tuple(yr.shape)}] verified "
          f"(row-scaled max rel {maxrel:.2e})")

    # the routed SpMV with x moved round the ring (K15 per step)
    if n >= 2:
        dmo = dist_routed_pack(csr_r, mesh, overlap=True)
        yo = dist_spmv_routed(dmo, put(xr), x_sharded=True, overlap=True)
        maxrel = _spmv_ok("overlap dryrun", yo, csr_r, xr)
        print(f"{tag}: routed OVERLAP path OK — ring cnt "
              f"{dmo.meta['ring_cnt']}, y[{tuple(yo.shape)}] verified "
              f"(row-scaled max rel {maxrel:.2e})")

    # the 2-D (row x col) mesh: cyclic 1024-column windows
    if n >= 4 and n % 2 == 0:
        R2, C2 = n // 2, 2
        dm2 = dist_routed_pack_2d(csr_r, make_mesh2d(R2, C2,
                                                     devices=devices))
        y2 = dist_spmv_routed_2d(dm2, put(xr))
        maxrel = _spmv_ok("2D mesh dryrun", y2, csr_r, xr)
        print(f"{tag}: 2D {R2}x{C2} MESH path OK — y[{tuple(y2.shape)}] "
              f"verified (row-scaled max rel {maxrel:.2e})")

    # DIA: equal row ranges, K8 per shard
    yd = dist_spmv_dia(dist_dia_pack(csr_b, mesh), put(xb), x_sharded=True)
    maxrel = _spmv_ok("dist dia dryrun", yd, csr_b, xb)
    print(f"{tag}: dia path OK — y[{tuple(yd.shape)}] verified (max rel err "
          f"{maxrel:.2e})")

    # BELL (road domain): 1024-aligned shards, a forced routed spill
    csr_rd = road_usa_like(n=1 << 14, deg=2.5, reach=48, seed=9).to_csr()
    x_rd = _rng(6, csr_rd.shape[1])
    ybe = dist_spmv_bell(dist_bell_pack(csr_rd, mesh), put(x_rd),
                         x_sharded=True)
    maxrel = _spmv_ok("dist bell dryrun", ybe, csr_rd, x_rd)
    print(f"{tag}: BELL path OK — y[{tuple(ybe.shape)}] verified "
          f"(row-scaled max rel {maxrel:.2e})")

    # the lane SpMM (power-law, K 8)
    Xl = _rng(7, (csr_r.shape[1], 8))
    Yl = dist_spmm_lane(dist_lane_pack(csr_r, mesh), put(Xl),
                        x_sharded=True)
    maxrel = _spmm_ok("dist lane dryrun", Yl, csr_r, Xl)
    print(f"{tag}: lane-SpMM path OK — Y[{tuple(Yl.shape)}] verified (max "
          f"rel err {maxrel:.2e})")

    # the PMM SpMM (hub-concentrated, K 16)
    csr_f = fsm_like(n=3000, seed=11).to_csr()
    dmp = dist_pmm_pack(csr_f, mesh)
    Xp = _rng(8, (csr_f.shape[1], 16))
    Yp = dist_spmm_pmm(dmp, put(Xp), x_sharded=True)
    maxrel = _spmm_ok("dist pmm dryrun", Yp, csr_f, Xp)
    print(f"{tag}: PMM-SpMM path OK — Y[{tuple(Yp.shape)}] verified (fan-in "
          f"C {dmp.c_mean:.2f}, max rel err {maxrel:.2e})")

    # the BSR SpMM: row-block-sharded bricks (K 4)
    Xb = _rng(3, (csr_b.shape[1], 4))
    Yb = dist_spmm_bsr(dist_bsr_pack(csr_b, mesh), put(Xb), x_sharded=True)
    maxrel = _spmm_ok("dist bsr dryrun", Yb, csr_b, Xb)
    print(f"{tag}: bsr-spmm path OK — Y[{tuple(Yb.shape)}] verified (max rel "
          f"err {maxrel:.2e})")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
