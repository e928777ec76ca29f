"""The port's 2-D mesh routed SpMV, its comm model and its multi-device
dry run, on the CPU.

The R x C mesh (cyclic 1024-column windows as column blocks, x gathered
over the row axis, y reduce-scattered over the column axis) against the
JAX package's (its 8-device CPU mesh, Pallas in interpret mode) and the
float64 golden at the row-scaled 1e-6 contract: bounds, geometry and
every block's planes equal, the JAX artifact carried across, other mesh
shapes, and the refusal of a row axis that does not divide a column
block.  The comm model's tables row for row against the JAX package's,
at its own link figures passed in (the port has no default).  Then
``dryrun_multichip(4)`` on four CPU shards: all ten paths at the
golden.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_dist2d.py -q
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import cvr_tpu.parallel.comm_model as jcm
from cvr_tpu.parallel import dist2d as j2d

import cvr_tpu_torch.parallel.comm_model as tcm
from cvr_tpu_torch.ops import kernels
from cvr_tpu_torch.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify
from cvr_tpu_torch.parallel import dist2d as t2d
from cvr_tpu_torch.parallel.dryrun import dryrun_multichip
from cvr_tpu_torch.parallel.partition import partition_rows_by_nnz
from torch_cases import pair, random_rect, rmat, stacked_rows

REPO = Path(__file__).resolve().parents[1]

# the JAX package's link figures, passed in where it has defaults
LINKS = {"link_bw": jcm.ICI_LINK_BW, "links": jcm.RING_LINKS}


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launches()
    yield
    # CPU tensors: every wrapper ran its plain version
    assert not any(kernels.launches().values())


def _x(n, seed=4):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _check(y, csr, x, ref=None):
    y = np.asarray(y)
    scale = spmv_row_scale(csr, x)
    assert y.shape == (csr.shape[0],) and np.isfinite(y).all()
    for want in (spmv_golden_numpy(csr, x),
                 *(() if ref is None else (np.asarray(ref),))):
        ok, nbad, maxrel = verify(y, want, rtol=1e-6, row_scale=scale)
        assert ok, f"{nbad} bad rows, max rel {maxrel}"


def matrix():
    """The JAX dryrun's routed matrix, less its last 3 columns (R-MAT 10,
    edge factor 7, seed 5)."""
    t = rmat(10, 7, 5)[1]
    keep = t.cols < t.shape[1] - 3
    return pair(t.rows[keep], t.cols[keep], t.vals[keep],
                (t.shape[0], t.shape[1] - 3))


def _mesh(R, C):
    return t2d.make_mesh2d(R, C, devices=["cpu"] * (R * C))


@pytest.fixture(scope="module")
def mesh_pair():
    jcoo, tcoo = matrix()
    csr, x = tcoo.to_csr(), _x(tcoo.shape[1])
    jdm = j2d.dist_routed_pack_2d(
        jcoo.to_csr(), j2d.make_mesh2d(2, 2, devices=jax.devices()[:4]))
    y_jax = np.asarray(j2d.dist_spmv_routed_2d(jdm, x))
    return csr, x, jdm, t2d.dist_routed_pack_2d(csr, _mesh(2, 2)), y_jax


def test_2d_matches_reference(mesh_pair):
    csr, x, jdm, dm, y_jax = mesh_pair
    assert np.array_equal(dm.bounds, jdm.bounds)
    assert (dm.rows_max, dm.nwin_u, dm.R, dm.C) == (jdm.rows_max, jdm.nwin_u,
                                                     jdm.R, jdm.C)
    assert dm.meta == dict(jdm.meta)
    keys = set(dm.planes[0])
    assert keys == set(jdm.planes) - {"gemit"}
    for b, pl in enumerate(dm.planes):
        for k in keys:
            assert np.array_equal(pl[k], np.asarray(jdm.planes[k][b])), k
    # block i's C reduce-scattered pieces of rows_max / C rows, each cut
    # to the block's own rows: JAX's index of the stacked pieces
    assert np.array_equal(np.asarray(jdm.unpad_index),
                          stacked_rows(dm.bounds, dm.rows_max))
    y = t2d.dist_spmv_routed_2d(dm, torch.from_numpy(x))
    _check(y, csr, x, y_jax)
    carried = t2d.from_reference(jdm, _mesh(2, 2))
    assert torch.equal(t2d.dist_spmv_routed_2d(carried, torch.from_numpy(x)),
                       y)


@pytest.mark.parametrize("R, C", [(1, 1), (1, 4), (4, 1), (4, 2), (2, 4)])
def test_2d_mesh_shapes(R, C):
    """Other meshes (8 blocks included): the row bounds are the JAX
    package's nnz partition over R, y at the golden."""
    _, tcoo = matrix()
    csr, x = tcoo.to_csr(), _x(tcoo.shape[1])
    dm = t2d.dist_routed_pack_2d(csr, _mesh(R, C))
    assert np.array_equal(dm.bounds, partition_rows_by_nnz(csr.rowptr, R))
    assert dm.rows_max % C == 0 and len(dm.blocks) == R * C
    _check(t2d.dist_spmv_routed_2d(dm, torch.from_numpy(x)), csr, x)


def test_2d_wide_matrix_cyclic_windows():
    """3000 x 9,000 scattered: 9 windows over 2 column blocks (5 and 4,
    padded to 5), each block's x gathered from 2 row pieces."""
    _, tcoo = random_rect(3000, 9000, density=2e-3, seed=6)
    csr, x = tcoo.to_csr(), _x(9000, seed=2)
    dm = t2d.dist_routed_pack_2d(csr, _mesh(2, 2))
    assert dm.nwin_u == 5
    _check(t2d.dist_spmv_routed_2d(dm, torch.from_numpy(x)), csr, x)


def test_2d_refuses_a_row_axis_that_does_not_divide_a_block():
    """R 3 does not divide a column block of 1,024 columns (the JAX
    package refuses the same at its call)."""
    _, tcoo = matrix()
    dm = t2d.dist_routed_pack_2d(tcoo.to_csr(), _mesh(3, 1))
    assert (dm.nwin_u * 1024) % 3
    with pytest.raises(ValueError, match="row-axis size must divide"):
        t2d.dist_spmv_routed_2d(dm, torch.zeros(tcoo.shape[1]))


def test_make_mesh2d_needs_a_card_or_devices():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t2d.make_mesh2d(2, 2)
    with pytest.raises(ValueError, match="3 devices"):
        t2d.make_mesh2d(2, 2, devices=["cpu"] * 3)
    mesh = t2d.make_mesh2d(2, 2, devices=["cpu"] * 6)
    assert mesh.shape == (2, 2) and mesh.size == 4


# ---------------------------------------------------------------------------
# the comm model
# ---------------------------------------------------------------------------

T_COMP = (1.1e-3, 1.2e-4, 3e-3)
NCOLS = (916_428, 10**6, 4_000_000)


@pytest.mark.parametrize("t, ncols", list(zip(T_COMP, NCOLS)))
def test_comm_model_tables_match_reference(t, ncols):
    nrows = ncols // 2 + 17
    for D in (1, 2, 3, 4, 8, 16, 64, 256):
        assert tcm.weak_scaling(t, ncols, D, **LINKS) == jcm.weak_scaling(
            t, ncols, D)
        assert tcm.weak_scaling(t, ncols, D, f_exp=0.5, **LINKS) == \
            jcm.weak_scaling(t, ncols, D, f_exp=0.5)
        assert tcm.best_mesh_2d(t, ncols, nrows, D, **LINKS) == \
            jcm.best_mesh_2d(t, ncols, nrows, D)
        for R in range(1, D + 1):
            if D % R == 0:
                assert tcm.weak_scaling_2d(t, ncols, nrows, R, D // R,
                                           **LINKS) == \
                    jcm.weak_scaling_2d(t, ncols, nrows, R, D // R)
    assert tcm.knee_devices(t, ncols, **LINKS) == jcm.knee_devices(t, ncols)
    assert tcm.knee_devices(t, ncols, target=0.5, **LINKS) == \
        jcm.knee_devices(t, ncols, target=0.5)
    assert tcm.routed_stream_bytes(ncols, 77) == jcm.routed_stream_bytes(
        ncols, 77)


def test_comm_table_matches_reference():
    rows = [{"name": "old", "nnz": 10, "padded_nnz": 12, "spmv_s": 1e-3},
            {"name": "a", "ncols": 1000, "nnz": 10, "padded_nnz": 12,
             "spmv_s": 1e-3},
            {"name": "b", "ncols": 916_428, "nnz": 5_000_000,
             "padded_nnz": 7_340_032, "spmv_s": 1.1e-4}]
    for D in (2, 8):
        got = tcm.comm_table(rows, D=D, **LINKS)
        want = jcm.comm_table(rows, D=D)
        assert [vars(r) for r in got] == [vars(r) for r in want]


def test_comm_model_takes_no_link_default():
    with pytest.raises(TypeError):
        tcm.weak_scaling(1e-3, 1000, 4)
    with pytest.raises(TypeError):
        tcm.comm_table([], 8)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def test_dryrun_multichip_on_four_cpu_shards(capsys):
    """All ten of the JAX package's paths, each at the golden."""
    dryrun_multichip(4, devices=["cpu"] * 4)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 10
    for what in ("(4): OK — y", "window-kernel path OK", "ROUTED path OK",
                 "routed OVERLAP path OK", "2D 2x2 MESH path OK",
                 "dia path OK", "BELL path OK", "lane-SpMM path OK",
                 "PMM-SpMM path OK", "bsr-spmm path OK"):
        assert sum(what in s for s in lines) == 1, what
    assert all(s.startswith("dryrun_multichip(4): ") for s in lines)


def test_dryrun_checks_survive_python_o():
    """The dry run's golden checks raise under ``python -O`` too (no
    ``assert`` statements): a y and a Y one part in 1e-3 off are
    refused."""
    code = (
        "import numpy as np, torch\n"
        "from cvr_tpu_torch.formats.csr import CSRMatrix\n"
        "from cvr_tpu_torch.parallel import dryrun\n"
        "csr = CSRMatrix(rowptr=np.array([0, 1, 2]), cols=np.array([0, 1]),\n"
        "                vals=np.ones(2, np.float32), shape=(2, 2))\n"
        "x = np.ones(2, np.float32)\n"
        "refused = 0\n"
        "for check, got in ((dryrun._spmv_ok, x * 1.001),\n"
        "                   (dryrun._spmm_ok, x[:, None] * 1.001)):\n"
        "    check('exact', torch.from_numpy(got / 1.001), csr,\n"
        "          x if got.ndim == 1 else x[:, None])\n"
        "    try:\n"
        "        check('off', torch.from_numpy(got), csr,\n"
        "              x if got.ndim == 1 else x[:, None])\n"
        "    except AssertionError:\n"
        "        refused += 1\n"
        "print(refused)\n"
    )
    out = subprocess.run([sys.executable, "-O", "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "2", out.stderr


def test_dryrun_defaults_to_the_card():
    """Without devices the dry run's mesh is the first card's: on a host
    without one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError), match="CUDA|cuda"):
        dryrun_multichip(2)
