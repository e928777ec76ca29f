"""The port on HPCG's problem, the matrix of the benchmark's ``hpcg_256``
configuration, at CPU-test sizes: ``benchmark/generators/hpcg27.py``'s
``make`` (held to HPCG's ``GenerateProblem_ref`` loop by
``benchmark/tests``) through ``pack_auto`` to DIA, the product against
the benchmark's float64 reference within the gap a run allows, and a
saved artifact's product bit for bit; K8 against its plain version at
64^3, where its reach (+-4,161 rows) is far wider than banded-2M's.

This file imports nothing of JAX, so that its card case runs where the
JAX package is not installed:

    python -m pytest --noconftest -q tests/test_torch_hpcg.py
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from benchmark import matrix as mx
from benchmark import reference
from cvr_tpu_torch import cli
from cvr_tpu_torch.formats import pack_auto
from cvr_tpu_torch.formats.coo import COOMatrix
from cvr_tpu_torch.formats.dia import DiaMatrix
from cvr_tpu_torch.ops import dia_kernels as dk
from cvr_tpu_torch.ops.spmv import spmv, upload

torch.set_num_threads(1)  # one per test worker, as tests/torch_cases.py

# the widest gap over |A| @ |x| a product may have in these tests: the
# float32 sums of at most 27 terms, in either order, stay far inside it
GAP = 1e-6
GRIDS = [(2, 3, 4), (5, 5, 5), (8, 4, 6), (8, 8, 8), (1, 7, 9)]


@functools.cache
def _problem(nx, ny, nz):
    """(the generator's matrix, pack_auto's artifact of its CSR)."""
    rows, cols, vals, n = mx.generator("hpcg27").make(nx, ny, nz)
    m = mx.Matrix(rows, cols, vals, int(n))
    coo = COOMatrix(rows=rows, cols=cols, vals=vals, shape=(m.n, m.n))
    return m, pack_auto(coo.to_csr())


def _offsets(nx, ny, nz):
    """{dz nx ny + dy nx + dx} over the shifts that some point's
    neighbour takes inside the grid."""
    steps = [(-1, 0, 1) if k > 1 else (0,) for k in (nz, ny, nx)]
    return sorted({dz * nx * ny + dy * nx + dx for dz in steps[0]
                   for dy in steps[1] for dx in steps[2]})


def _x(n, seed=5, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=g).to(device)


def _gap(m, x, y):
    rows, cols = (torch.from_numpy(a).to(x.device, torch.int64)
                  for a in (m.rows, m.cols))
    ref, scale = reference.reference(rows, cols,
                                     torch.from_numpy(m.vals).to(x.device),
                                     x, m.n)
    return reference.gap(y, ref, scale)


@pytest.mark.parametrize("grid", GRIDS)
def test_pack_auto_takes_dia_with_the_stencils_offsets(grid):
    m, dm = _problem(*grid)
    assert isinstance(dm, DiaMatrix)
    assert dm.offsets.tolist() == _offsets(*grid)
    assert dm.nnz == m.nnz == np.prod([3 * k - 2 for k in grid])
    if grid == (1, 7, 9):
        assert dm.nd == 9


@pytest.mark.parametrize("grid", GRIDS)
def test_product_is_within_the_benchmarks_gap(grid):
    m, dm = _problem(*grid)
    x = _x(m.n)
    y = spmv(upload(dm, "cpu"), x)
    assert y.dtype == torch.float32 and y.shape == (m.n,)
    assert _gap(m, x, y) <= GAP


@pytest.mark.parametrize("grid", GRIDS)
def test_saved_artifact_gives_the_same_product(grid, tmp_path):
    _, dm = _problem(*grid)
    path = str(tmp_path / "hpcg.npz")
    cli.save_packed(dm, path)
    kind, host = cli.load_packed(path)
    assert kind == "dia" and isinstance(host, DiaMatrix)
    x = _x(dm.shape[1], seed=9)
    assert torch.equal(spmv(upload(host, "cpu"), x),
                       spmv(upload(dm, "cpu"), x))


def test_k8_at_64_cubed_matches_its_plain_version():
    """On a card: K8 at 64^3 (27 diagonals, offsets to +-4,161) within
    GAP of its plain version's row scale and of the reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K8 has no CPU form")
    m, dm = _problem(64, 64, 64)
    assert dm.nd == 27 and dm.offsets.max() == 64 * 64 + 64 + 1
    sd = upload(dm, "cuda")
    x = _x(m.n, device="cuda")
    before = dk.dia_spmv.launches
    y = spmv(sd, x)
    assert dk.dia_spmv.launches == before + 1
    plain = dk.dia_spmv_plain(sd.bands, sd.offsets, x)
    scale = dk.dia_spmv_plain(sd.bands.abs(), sd.offsets, x.abs())
    assert bool(((y - plain).abs() <= GAP * scale).all())
    assert _gap(m, x, y) <= GAP
