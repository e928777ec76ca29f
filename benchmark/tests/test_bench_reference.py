"""The reference against a dense float64 product, the control against
the limits, and the frozen generator against the program's."""

from __future__ import annotations

import ast

import numpy as np
import pytest
import torch

from benchmark import matrix as mx
from benchmark import reference, rmat, spec


def _small(scale=11, ef=6, seed=42):
    r, c, v = rmat.rmat(scale, ef, 0.57, 0.19, 0.19, seed)
    n = 1 << scale
    dense = np.zeros((n, n))
    np.add.at(dense, (r, c), v.astype(np.float64))
    t = (torch.from_numpy(r.astype(np.int64)),
         torch.from_numpy(c.astype(np.int64)), torch.from_numpy(v))
    return t, dense, n


@pytest.mark.parametrize("K", [1, 8, 128])
def test_reference_equals_a_dense_float64_product(K):
    (rows, cols, vals), dense, n = _small()
    g = torch.Generator().manual_seed(K)
    X = torch.randn((n,) if K == 1 else (n, K), generator=g)
    Y, scale = reference.reference(rows, cols, vals, X, n)
    want = dense @ X.double().numpy()
    assert np.abs(Y.numpy() - want).max() <= 1e-12 * max(1.0,
                                                         np.abs(want).max())
    assert np.allclose(scale.numpy(), np.abs(dense) @ np.abs(X.double()
                                                             .numpy()))


@pytest.mark.parametrize("K", [1, 128])
def test_reference_in_blocks_equals_one_block(K, monkeypatch):
    (rows, cols, vals), _, n = _small()
    X = torch.randn((n,) if K == 1 else (n, K),
                    generator=torch.Generator().manual_seed(3))
    whole = reference.reference(rows, cols, vals, X, n)[0]
    monkeypatch.setattr(reference, "BLOCK", 4096)
    parts = reference.reference(rows, cols, vals, X, n)[0]
    assert torch.allclose(whole, parts, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("cell", [c["name"] for c in
                                  spec.load()["workloads"]])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_and_float32_passes_the_limit(cell, seed):
    """At test size: the control (TF32 inputs, float32 sums) reads above
    the cell's limit, a plain float32 product far under it."""
    m = spec.load()
    K = spec.traffic(spec.cell(m, cell)["traffic"])["rhs"]
    limit = spec.limits(cell)["widest_gap"]
    (rows, cols, vals), dense, n = _small(seed=seed)
    X = torch.randn((n,) if K == 1 else (n, K),
                    generator=torch.Generator().manual_seed(seed))
    ref, scale = reference.reference(rows, cols, vals, X, n)
    ctl = reference.control(rows, cols, vals, X, n)
    f32 = torch.from_numpy(dense.astype(np.float32) @ X.numpy())
    assert reference.gap(ctl, ref, scale) > limit
    assert reference.gap(f32, ref, scale) < limit / 10


def test_gap_catches_one_altered_entry_and_non_finite_output():
    (rows, cols, vals), _, n = _small()
    X = torch.randn(n, generator=torch.Generator().manual_seed(0))
    ref, scale = reference.reference(rows, cols, vals, X, n)
    y = ref.float()
    assert reference.gap(y, ref, scale) < 1e-6
    i = int(torch.argmax(scale))
    bad = y.clone()
    bad[i] += 1e-4 * float(scale[i])
    assert reference.gap(bad, ref, scale) >= 9e-5
    bad = y.clone()
    bad[0] = float("nan")
    assert reference.gap(bad, ref, scale) == float("inf")
    empty = int(torch.nonzero(scale == 0)[0])
    bad = y.clone()
    bad[empty] = 1e-30
    assert reference.gap(bad, ref, scale) == float("inf")
    assert reference.gap(y[:-1], ref, scale) == float("inf")


def test_tf32_rounds_to_ten_mantissa_bits():
    a = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11 + 2.0 ** -20,
                      -(1.0 + 2.0 ** -12), 3.0])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -1.0, 3.0])
    assert torch.equal(reference.tf32(a), want)


def test_frozen_generator_equals_the_programs():
    from cvr_tpu_torch.bench.synthetic import rmat_matrix

    for scale, ef, a, b, c, seed in ((12, 6, 0.57, 0.19, 0.19, 42),
                                     (11, 9, 0.57, 0.19, 0.19, 11),
                                     (10, 3, 0.65, 0.15, 0.15, 7)):
        theirs = rmat_matrix(scale, ef, a, b, c, seed=seed, cache=False)
        r, cc, v = rmat.rmat(scale, ef, a, b, c, seed)
        assert np.array_equal(r, theirs.rows)
        assert np.array_equal(cc, theirs.cols)
        assert np.array_equal(v, theirs.vals)


def test_rmat_is_its_edge_list_coalesced():
    r, c, v = rmat.rmat(10, 6, 0.57, 0.19, 0.19, 3)
    er, ec = rmat.rmat_edges(10, 6, 0.57, 0.19, 0.19,
                             np.random.default_rng(3))
    pairs = set(zip(er.tolist(), ec.tolist()))
    assert set(zip(r.tolist(), c.tolist())) == pairs and len(pairs) == v.size


@pytest.mark.parametrize("scale,ef", [(10, 16), (12, 4)])
def test_graph500_is_the_specifications_graph(scale, ef):
    """The R-MAT edge list with a weight from [0, 1) an edge, its labels
    permuted and each edge stored both ways (a self-loop once), parallel
    edges' weights summed: a symmetric matrix whose hub is no longer the
    label 0 the edge list puts it at."""
    n = 1 << scale
    r, c, v = rmat.graph500(scale, ef, 0.57, 0.19, 0.19, 1)
    assert r.dtype == c.dtype == np.int32 and v.dtype == np.float32
    assert np.all(np.diff(r) >= 0) and v.min() >= 0
    dense = np.zeros((n, n))
    dense[r, c] = v
    assert np.array_equal(dense, dense.T)
    rng = np.random.default_rng(1)
    er, ec = rmat.rmat_edges(scale, ef, 0.57, 0.19, 0.19, rng)
    w = rng.random(er.size, dtype=np.float32).astype(np.float64)
    perm = rng.permutation(n)
    assert not np.array_equal(perm, np.arange(n))
    pr, pc = perm[er], perm[ec]
    want = set(zip(pr.tolist(), pc.tolist())) | set(zip(pc.tolist(),
                                                        pr.tolist()))
    assert set(zip(r.tolist(), c.tolist())) == want and v.size == len(want)
    loops = er == ec
    assert v.astype(np.float64).sum() == pytest.approx(
        2 * w.sum() - w[loops].sum(), rel=1e-6)
    raw = np.bincount(np.concatenate([er, ec]), minlength=n)
    assert np.argmax(raw) == 0
    assert np.argmax(np.bincount(r, minlength=n)) == perm[0] != 0


def test_matrix_cache_round_trip(tmp_path):
    cfg = {"name": "t", "generator": "graph500", "scale": 9,
           "edgefactor": 4, "A": 0.57, "B": 0.19, "C": 0.19, "seed": 5}
    made = mx.make(cfg)
    cfg["expect"] = {"rows": made.n, "nnz": made.nnz}
    first, generated = mx.load(cfg, tmp_path)
    again, regenerated = mx.load(cfg, tmp_path)
    assert generated and not regenerated
    assert np.array_equal(first.vals, again.vals)
    assert np.array_equal(first.rowptr, again.rowptr)
    cfg["expect"]["nnz"] += 1
    cfg["seed"] = 6
    with pytest.raises(RuntimeError):
        mx.load(cfg, tmp_path)


def test_reference_imports_nothing_of_the_program():
    """Neither the reference nor anything that makes the matrix: the
    modules, and every generator file."""
    files = [mod.__file__ for mod in (reference, rmat, mx)]
    files += sorted(mx.GENERATORS.glob("*.py"))
    assert len(files) >= 5
    for f in files:
        tree = ast.parse(open(f).read())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        tops = {x.split(".")[0] for x in names}
        assert not tops & {"cvr_tpu_torch", "cvr_tpu", "jax"}, f
