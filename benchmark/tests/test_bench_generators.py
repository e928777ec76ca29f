"""The generators found by file: Graph500's graph as it was before they
were (same key, same arrays), HPCG's 27-point problem against a plain
construction, the contract ``make`` holds them to, and the tests' cut of
each configuration by its generator's ``TINY``."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark import matrix as mx
from benchmark import rmat, spec

MANIFEST = spec.load()


def _hpcg_plain(nx, ny, nz):
    """HPCG's GenerateProblem_ref, loop by loop: rows in z, y, x order,
    x fastest; each neighbour z, then y, then x over -1, 0, 1."""
    rows, cols, vals = [], [], []
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                row = iz * ny * nx + iy * nx + ix
                for sz in (-1, 0, 1):
                    for sy in (-1, 0, 1):
                        for sx in (-1, 0, 1):
                            if (0 <= iz + sz < nz and 0 <= iy + sy < ny
                                    and 0 <= ix + sx < nx):
                                col = (iz + sz) * ny * nx + (iy + sy) * nx \
                                    + ix + sx
                                rows.append(row)
                                cols.append(col)
                                vals.append(26.0 if col == row else -1.0)
    return (np.array(rows, np.int32), np.array(cols, np.int32),
            np.array(vals, np.float32))


@pytest.mark.parametrize("grid", [(2, 3, 4), (5, 5, 5), (8, 4, 6)])
def test_hpcg27_equals_the_plain_construction(grid):
    rows, cols, vals, n = mx.generator("hpcg27").make(*grid)
    want = _hpcg_plain(*grid)
    assert n == grid[0] * grid[1] * grid[2]
    for got, w in zip((rows, cols, vals), want):
        assert got.dtype == w.dtype and np.array_equal(got, w)


@pytest.mark.parametrize("grid", [(2, 3, 4), (5, 5, 5), (8, 4, 6),
                                  (1, 1, 1), (16, 9, 3)])
def test_hpcg27_is_the_symmetric_27_point_stencil(grid):
    """nnz (3nx-2)(3ny-2)(3nz-2); symmetric; a row sums to 0 where all
    26 neighbours lie inside the grid, and is positive on the boundary."""
    nx, ny, nz = grid
    m = mx.make({"generator": "hpcg27", "nx": nx, "ny": ny, "nz": nz})
    assert m.nnz == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    dense = np.zeros((m.n, m.n))
    dense[m.rows, m.cols] = m.vals
    assert np.array_equal(dense, dense.T)
    sums = dense.sum(axis=1).reshape(nz, ny, nx)
    inner = np.zeros((nz, ny, nx), dtype=bool)
    inner[1:-1, 1:-1, 1:-1] = True
    assert np.all(sums[inner] == 0) and np.all(sums[~inner] > 0)
    assert np.all(np.diag(dense) == 26.0)


def test_graph500_s21_keeps_its_key_and_its_arrays(tmp_path):
    """The parameters, the cache key and so the cache's and artifact's
    paths are those from before generators were files; the generator's
    arrays are ``rmat.graph500``'s, bit for bit (at a scale the CPU
    makes in a second)."""
    cfg = spec.config(MANIFEST, "graph500_s21")
    p = mx.params(cfg)
    assert p == {"generator": "graph500", "scale": 21, "edgefactor": 16,
                 "A": 0.57, "B": 0.19, "C": 0.19, "seed": 1}
    assert mx.key(p) == "438c7c3b3c098454"
    assert mx.cache_dir(cfg, tmp_path).name == "graph500_s21-438c7c3b3c098454"
    small = dict(cfg, scale=12, edgefactor=8)
    m = mx.make(small)
    r, c, v = rmat.graph500(12, 8, cfg["A"], cfg["B"], cfg["C"], cfg["seed"])
    assert m.n == 1 << 12
    assert np.array_equal(m.rows, r) and np.array_equal(m.cols, c)
    assert np.array_equal(m.vals, v)


@pytest.mark.parametrize("name", ["nope", "../rmat", "graph500/x", ".x"])
def test_an_unknown_generator_raises(name):
    with pytest.raises(ValueError, match="unknown generator"):
        mx.params({"generator": name, "scale": 10})


@pytest.mark.parametrize("bad, fault", [
    (lambda r, c, v: (r.astype(np.int64), c, v), "arrays"),
    (lambda r, c, v: (r, c, v.astype(np.float64)), "arrays"),
    (lambda r, c, v: (r[::-1].copy(), c[::-1].copy(), v), "CSR order"),
    (lambda r, c, v: (np.concatenate([r, r[-1:]]),
                      np.concatenate([c, c[-1:]]),
                      np.concatenate([v, v[-1:]])), "duplicate"),
    (lambda r, c, v: (r, c + 1, v), "outside"),
])
def test_make_holds_a_generator_to_its_contract(monkeypatch, bad, fault):
    gen = mx.generator("hpcg27")
    make = gen.make

    def broken(*a):
        r, c, v, n = make(*a)
        return (*bad(r, c, v), n)

    monkeypatch.setattr(gen, "make", broken)
    monkeypatch.setattr(mx, "generator", lambda name: gen)
    with pytest.raises(ValueError, match=fault):
        mx.make({"generator": "hpcg27", "nx": 3, "ny": 3, "nz": 3})


@pytest.mark.parametrize("name", sorted(
    p.stem for p in mx.GENERATORS.glob("*.py")))
def test_each_generator_keeps_the_file_contract(name):
    """PARAMS, the keys it takes; TINY, some of them; make."""
    gen = mx.generator(name)
    assert isinstance(gen.PARAMS, tuple) and set(gen.TINY) <= set(gen.PARAMS)
    assert callable(gen.make)


def test_the_tests_cut_every_config_by_its_generators_tiny(tiny_root):
    m = spec.load(tiny_root / "BENCHMARK.json")
    for c in m["configs"]:
        full = spec.config(MANIFEST, c["name"])
        tiny = json.loads((tiny_root / c["file"]).read_text())
        cut = mx.generator(full["generator"]).TINY
        assert {k: tiny[k] for k in cut} == cut
        kept = set(full) - set(cut) - {"expect"}
        assert set(tiny) == set(full)
        assert {k: tiny[k] for k in kept} == {k: full[k] for k in kept}
        made = mx.make(tiny)
        assert tiny["expect"] == {"rows": made.n, "nnz": made.nnz}
        assert made.nnz < full["expect"]["nnz"]
