"""Record the JAX package's outputs that the port's tests read from
tests/fixtures/ in place of its slowest interpret-mode calls.

    JAX_PLATFORMS=cpu python tests/make_torch_fixtures.py

It imports the JAX package on an 8-device CPU mesh, as tests/conftest.py
sets it up for the tests, and writes:

  * torch_ref_dist_routed_ring.npz: the routed SpMV of
    test_torch_dist_routed.py's ring pack (powerlaw n 6000, avg 8 nnz a
    row, seed 11, on 4 shards, overlap=True; x from default_rng(0)) in
    each mode, y (6000,) float32 under the mode's name (each interpret-mode
    call takes 11-17 s).

  * torch_ref_multiprocess.npz: the JAX package's dist_* of every path
    of tests/torch_ranks.py on 2 and 4 devices, its y (Y) under
    test_torch_multiprocess.jax_key (the routed SpMV all-gathered and on
    the ring, the 2-D mesh at 2 x 2 on 4).

  * jax_<name>.npz for each name of chip_smoke.JAX_FIXTURES: the JAX
    package's pack of the fixture's matrix (made by the port's generator,
    the same arrays), saved by the JAX package's own save (save_routed
    with hot planes, save_bell, SellWindow.save with a y-route,
    DiaMatrix.save, BsrMatrix.save, save_lane, save_pmm); chip_smoke.py
    phase [12](c) loads them on the card.

The tests keep one mode live (test_torch_dist_routed.LIVE_MODE) and hold
its recorded y against the JAX package's live one, so that the records
stay tied to the package; test_torch_artifacts.py holds each jax_*.npz
against the port's save of its own pack.  Rerun this after a change to
the JAX package's routed SpMV, its savers, or the matrices.

    JAX_PLATFORMS=cpu python tests/make_torch_fixtures.py \
        [dist | multiprocess | jax]
"""

import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import numpy as np  # noqa: E402

import cvr_tpu.parallel.dist_routed as jdr  # noqa: E402
from cvr_tpu.parallel.dist import make_mesh as j_make_mesh  # noqa: E402
from test_torch_dist_routed import D, MODES, RING_FIXTURE, ring_matrix  # noqa: E402


def dist_routed_ring() -> None:
    jcoo, _, x = ring_matrix()
    jdm = jdr.dist_routed_pack(jcoo.to_csr(), j_make_mesh(D), overlap=True)
    ys = {name: np.asarray(jdr.dist_spmv_routed(jdm, x, **mode))
          for name, mode in MODES.items()}
    np.savez_compressed(RING_FIXTURE, **ys)
    print(f"{RING_FIXTURE}: {sorted(ys)}, {ys['replicated'].shape}")


def multiprocess() -> None:
    from test_torch_multiprocess import FIXTURE, SIZES, jax_ys

    ys = {k: v for D in SIZES for k, v in jax_ys(D).items()}
    np.savez_compressed(FIXTURE, **ys)
    print(f"{FIXTURE}: {sorted(ys)}")


def jax_fixtures() -> None:
    import chip_smoke
    import cvr_tpu.formats.sell_routed as jsr
    from cvr_tpu.formats.bell import save_bell
    from cvr_tpu.formats.coo import COOMatrix
    from cvr_tpu.ops.spmm_lane import save_lane
    from cvr_tpu.ops.spmm_pmm import save_pmm
    from torch_cases import j_pack

    saves = {"sell-routed": jsr.save_routed, "bell": save_bell,
             "lane": save_lane, "pmm": save_pmm}
    for name, (make, kind, env, _K) in chip_smoke.JAX_FIXTURES.items():
        t = make()
        jcoo = COOMatrix(rows=t.rows, cols=t.cols, vals=t.vals, shape=t.shape)
        A = j_pack(kind, jcoo, env)
        path = chip_smoke.FIXTURE_DIR / f"jax_{name}.npz"
        saves.get(kind, lambda a, p: a.save(p))(A, path)
        print(f"{path}: {type(A).__name__}, {path.stat().st_size} B")


if __name__ == "__main__":
    which = sys.argv[1:] or ["dist", "multiprocess", "jax"]
    if "dist" in which:
        dist_routed_ring()
    if "multiprocess" in which:
        multiprocess()
    if "jax" in which:
        jax_fixtures()
