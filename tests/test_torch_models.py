"""The port's payloads (cvr_tpu_torch.models, bench/models.py) against the
JAX package's cvr_tpu.models on the CPU.

The same numpy-seeded inputs go through both packages' functions: the
JAX package's over its jnp CSR SpMV, its SELL planes or its routed SpMV
(Pallas in interpret mode), the port's over its counterparts (CPU tensors:
the plain versions of the kernels).  Fixed-length runs are compared value
for value; converging runs at iteration counts within 1, since XLA and
torch reduce the stopping test's sums in different orders and a run that
ends within an ulp of ``tol`` may stop an iteration apart; the random
starts (jax.random against a torch generator) on converged quantities
only.  Also: the COO / CSR host helpers array for array, gcn_normalize bit
for bit, the benchmark's matrices against the JAX model script's
construction, the dense products' precision guard, and the package's
exports.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cvr_tpu.bench import synthetic as jsyn
from cvr_tpu.formats.coo import COOMatrix as JCOO
from cvr_tpu.formats.sell import sell_pack as j_sell_pack
from cvr_tpu.formats.sell_routed import sell_pack_routed as j_pack_routed
import cvr_tpu.models as jmodels
from cvr_tpu.models import gnn as jgnn
from cvr_tpu.models.pagerank import pagerank_routed as j_pagerank_routed
from cvr_tpu.models.pagerank import pagerank_sell as j_pagerank_sell
from cvr_tpu.ops.spmv import to_device as j_to_device
from cvr_tpu.ops.spmv_ref import spmv_csr_jnp
from cvr_tpu.ops.spmv_routed import to_device_routed as j_to_device_routed

import cvr_tpu_torch.models as tmodels
from cvr_tpu_torch.bench import models as bench_models
from cvr_tpu_torch.formats.coo import COOMatrix as TCOO
from cvr_tpu_torch.formats.csr import CSRMatrix as TCSR
from cvr_tpu_torch.formats.sell import sell_pack as t_sell_pack
from cvr_tpu_torch.formats.sell_routed import sell_pack_routed as t_pack_routed
from cvr_tpu_torch.models import gnn as tgnn
from cvr_tpu_torch.models.pagerank import pagerank_routed, pagerank_sell
from cvr_tpu_torch.models.solvers import full_f32
from cvr_tpu_torch.ops import kernels
from cvr_tpu_torch.ops.spmv_ref import spmv_csr_torch
from torch_cases import banded, pair, powerlaw, rmat

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"
# fixed-length runs: float32 reductions (dot products, norms, the SpMV's
# row sums) in another order than XLA's, a few ulp an iteration
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launches()
    yield
    # CPU tensors: every wrapper ran its plain version
    assert not any(kernels.launches().values())


def matvecs(j, t):
    """(JAX CSR matvec, the port's) of one matrix: jnp gather +
    segment_sum, torch gather + index_add_."""
    jc, tc = j.to_csr(), t.to_csr()
    jargs = (jnp.asarray(jc.rowptr), jnp.asarray(jc.cols),
             jnp.asarray(jc.vals, dtype=jnp.float32))
    targs = (torch.from_numpy(tc.rowptr),
             torch.from_numpy(tc.cols.astype(np.int64)),
             torch.from_numpy(tc.vals.astype(np.float32)))
    n = jc.shape[0]

    def jax_mv(v):  # an SpMM one column at a time
        if v.ndim == 2:
            return jax.vmap(jax_mv, in_axes=1, out_axes=1)(v)
        return spmv_csr_jnp(*jargs, v, n)

    return jax_mv, lambda v: spmv_csr_torch(*targs, v, n)


def np_of(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# the host helpers

HELPER_CASES = {
    "powerlaw": powerlaw,
    "banded": banded,
    "rmat": lambda: rmat(10, 8, 3),
    "rectangular": lambda: pair(
        np.array([0, 3, 3, 1], np.int32), np.array([7, 2, 2, 0], np.int32),
        np.array([1.5, -2.0, 4.0, 0.5], np.float32), (4, 9)),
}


def same(a, b):
    assert type(a).__name__ == type(b).__name__
    assert tuple(a.shape) == tuple(b.shape)
    for name in ("rows", "cols", "vals", "rowptr"):
        if hasattr(a, name):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", sorted(HELPER_CASES))
@pytest.mark.parametrize("helper", ["transpose", "sorted_by_row", "to_scipy",
                                    "from_scipy", "csr_to_coo", "csr_to_scipy",
                                    "csr_from_scipy"])
def test_host_helpers_match_reference(case, helper):
    j, t = HELPER_CASES[case]()
    if helper in ("transpose", "sorted_by_row"):
        same(getattr(j, helper)(), getattr(t, helper)())
    elif helper == "to_scipy":
        a, b = j.to_scipy(), t.to_scipy()
        assert (a != b).nnz == 0 and a.format == b.format == "coo"
        np.testing.assert_array_equal(a.row, b.row)
        np.testing.assert_array_equal(a.data, b.data)
    elif helper == "from_scipy":
        m = j.to_scipy().tocsr()
        same(JCOO.from_scipy(m), TCOO.from_scipy(m))
    elif helper == "csr_to_coo":
        same(j.to_csr().to_coo(), t.to_csr().to_coo())
    elif helper == "csr_to_scipy":
        a, b = j.to_csr().to_scipy(), t.to_csr().to_scipy()
        for name in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    else:
        m = j.to_scipy()
        from cvr_tpu.formats.csr import CSRMatrix as JCSR

        same(JCSR.from_scipy(m), TCSR.from_scipy(m))


# ---------------------------------------------------------------------------
# fixed-length runs, value for value


def graph(n=300, deg=8, seed=0):
    """test_models' random graph: ``deg`` out-links a vertex, unit values."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int32), deg)
    cols = rng.integers(0, n, size=deg * n).astype(np.int32)
    j, t = pair(rows, cols, np.ones(deg * n, dtype=np.float32), (n, n))
    return j.sum_duplicates(), t.sum_duplicates()


def out_degree(coo):
    deg = np.zeros(coo.shape[0], dtype=np.float32)
    np.add.at(deg, coo.rows, coo.vals)
    return deg


def spd(n=200, seed=1):
    """test_models' SPD system: a sparse symmetric matrix + 10 I."""
    rng = np.random.default_rng(seed)
    m = sp.random(n, n, density=0.05, random_state=rng)
    A = ((m + m.T) * 0.5 + sp.eye(n) * 10.0).tocoo()
    b = rng.standard_normal(n).astype(np.float32)
    return (*pair(A.row.astype(np.int32), A.col.astype(np.int32),
                  A.data.astype(np.float32), (n, n)), b, A)


def nonsym_band(n=3000, seed=0):
    """test_models' nonsymmetric diagonally dominant band."""
    rng = np.random.default_rng(seed)
    m = sp.diags([rng.standard_normal(n - 1) * 0.2, np.full(n, 4.0),
                  rng.standard_normal(n - 1) * 0.3], offsets=[-1, 0, 1],
                 format="coo")
    b = rng.standard_normal(n).astype(np.float32)
    return JCOO.from_scipy(m), TCOO.from_scipy(m), b, m


def dominant_band(n=2000):
    """test_models' Jacobi system: banded_matrix(n, 5) with its diagonal
    set to the row's |sum| + 1."""
    m = jsyn.banded_matrix(n=n, bandwidth=5, seed=3).to_scipy().tolil()
    m.setdiag(np.abs(m).sum(axis=1).A1 + 1.0)
    m = m.tocoo()
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    diag = np.asarray(m.diagonal(), dtype=np.float32)
    return JCOO.from_scipy(m), TCOO.from_scipy(m), b, diag, m


@pytest.mark.parametrize("with_degree", [True, False])
def test_pagerank_fixed_length(with_degree):
    j, t = graph()
    jT, tT = j.transpose(), t.transpose()
    jm, tm = matvecs(jT, tT)
    deg = out_degree(t) if with_degree else None
    got = tmodels.pagerank(tm, 300, tol=0.0, max_iters=25, out_degree=deg,
                           device=CPU)
    want = jmodels.pagerank(jm, 300, tol=0.0, max_iters=25,
                            out_degree=None if deg is None
                            else jnp.asarray(deg))
    assert got[1] == int(want[1]) == 25 and isinstance(got[1], int)
    np.testing.assert_allclose(np_of(got[0]), np_of(want[0]), rtol=RTOL)
    assert got[0].dtype == torch.float32


def test_conjugate_gradient_fixed_length():
    j, t, b, _ = spd()
    jm, tm = matvecs(j, t)
    # tol 0: the run stops only at max_iters
    x, its, res = tmodels.conjugate_gradient(tm, b, tol=0.0, max_iters=8,
                                             device=CPU)
    xj, itj, resj = jmodels.conjugate_gradient(jm, jnp.asarray(b), tol=0.0,
                                               max_iters=8)
    assert its == int(itj) == 8
    np.testing.assert_allclose(np_of(x), np_of(xj), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(float(res), float(resj), rtol=1e-4)


def test_bicgstab_fixed_length():
    j, t, b, _ = nonsym_band(400)
    jm, tm = matvecs(j, t)
    x, its, res = tmodels.bicgstab(tm, b, tol=0.0, max_iters=4, device=CPU)
    xj, itj, resj = jmodels.bicgstab(jm, jnp.asarray(b), tol=0.0,
                                     max_iters=4)
    assert its == int(itj) == 4
    np.testing.assert_allclose(np_of(x), np_of(xj), rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("omega", [1.0, 0.8])
def test_jacobi_fixed_length(omega):
    j, t, b, diag, _ = dominant_band(500)
    jm, tm = matvecs(j, t)
    x, its, res = tmodels.jacobi(tm, diag, b, omega=omega, tol=0.0,
                                 max_iters=12, device=CPU)
    xj, itj, resj = jmodels.jacobi(jm, jnp.asarray(diag), jnp.asarray(b),
                                   omega=omega, tol=0.0, max_iters=12)
    assert its == int(itj) == 12
    np.testing.assert_allclose(np_of(x), np_of(xj), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(float(res), float(resj), rtol=1e-4)


# ---------------------------------------------------------------------------
# converging runs: iteration counts within 1


def test_pagerank_converges_with_reference():
    """tol 1e-6: on this graph float32's delta stalls at 3e-8 to 1e-7,
    where each package's order of summation decides whether it ever
    reaches tol (the port's stalls at 9e-8 under 3e-8, the JAX
    package's reaches it)."""
    j, t = graph()
    jm, tm = matvecs(j.transpose(), t.transpose())
    deg = out_degree(t)
    p, its, delta = tmodels.pagerank(tm, 300, tol=1e-6, max_iters=200,
                                     out_degree=deg, device=CPU)
    pj, itj, _ = jmodels.pagerank(jm, 300, tol=1e-6, max_iters=200,
                                  out_degree=jnp.asarray(deg))
    assert 1 < its < 200 and abs(its - int(itj)) <= 1
    assert float(delta) <= 1e-6
    np.testing.assert_allclose(np_of(p), np_of(pj), rtol=1e-4, atol=1e-9)


def test_conjugate_gradient_converges_with_reference():
    j, t, b, A = spd()
    jm, tm = matvecs(j, t)
    x, its, res = tmodels.conjugate_gradient(tm, b, tol=1e-5, max_iters=500,
                                             device=CPU)
    xj, itj, _ = jmodels.conjugate_gradient(jm, jnp.asarray(b), tol=1e-5,
                                            max_iters=500)
    assert abs(its - int(itj)) <= 1 and float(res) < 1e-4
    # test_models' own check against the dense float64 solve
    x_ref = np.linalg.solve(A.toarray(), b.astype(np.float64))
    np.testing.assert_allclose(np_of(x), x_ref, rtol=1e-2, atol=1e-4)


def test_bicgstab_converges_with_reference():
    j, t, b, m = nonsym_band()
    jm, tm = matvecs(j, t)
    x, its, res = tmodels.bicgstab(tm, b, device=CPU)
    xj, itj, _ = jmodels.bicgstab(jm, jnp.asarray(b))
    assert abs(its - int(itj)) <= 1 and float(res) < 1e-5
    gold = sp.linalg.spsolve(m.tocsr().astype(np.float64), b)
    assert np.allclose(np_of(x), gold, rtol=1e-3, atol=1e-4)


def test_jacobi_converges_with_reference():
    j, t, b, diag, m = dominant_band()
    jm, tm = matvecs(j, t)
    x, its, res = tmodels.jacobi(tm, diag, b, tol=1e-6, max_iters=3000,
                                 device=CPU)
    xj, itj, _ = jmodels.jacobi(jm, jnp.asarray(diag), jnp.asarray(b),
                                tol=1e-6, max_iters=3000)
    assert abs(its - int(itj)) <= 1 and float(res) < 1e-5
    r = b - m.tocsr() @ np_of(x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-4


def test_jacobi_reported_residual_matches_iterate():
    """test_models' dense case: the returned residual describes the
    returned x, at the JAX package's iteration count within 1."""
    n = 64
    rng = np.random.default_rng(5)
    A = np.diag(np.full(n, 5.0)) + 0.3 * rng.standard_normal((n, n)) / n
    A = A.astype(np.float32)
    diag = np.ascontiguousarray(np.diag(A))
    b = rng.standard_normal(n).astype(np.float32)
    At = torch.from_numpy(A)
    x, its, res = tmodels.jacobi(lambda v: At @ v, diag, b, tol=1e-5,
                                 max_iters=500, device=CPU)
    _, itj, _ = jmodels.jacobi(lambda v: jnp.asarray(A) @ v,
                               jnp.asarray(diag), jnp.asarray(b), tol=1e-5,
                               max_iters=500)
    true_res = np.linalg.norm(b - A @ np_of(x)) / np.linalg.norm(b)
    assert abs(float(res) - true_res) < 1e-6 + 1e-3 * true_res
    assert true_res < 1e-5 and abs(its - int(itj)) <= 1


@pytest.mark.parametrize("rhs", ["half_outside", "inside", "zero"])
def test_bicgstab_breakdown_guard(rhs):
    """A singular A (an identity block): b partly outside its range breaks
    down without NaNs, b inside it converges at the half step, b = 0
    stops at once; each at the JAX package's iteration count within 1."""
    n = 32
    A = np.zeros((n, n), np.float32)
    A[: n // 2, : n // 2] = np.eye(n // 2, dtype=np.float32)
    b = {"half_outside": np.ones(n, np.float32),
         "inside": np.r_[np.ones(n // 2), np.zeros(n // 2)].astype(np.float32),
         "zero": np.zeros(n, np.float32)}[rhs]
    At = torch.from_numpy(A)
    x, its, res = tmodels.bicgstab(lambda v: At @ v, b, max_iters=50,
                                   device=CPU)
    xj, itj, resj = jmodels.bicgstab(lambda v: jnp.asarray(A) @ v,
                                     jnp.asarray(b), max_iters=50)
    assert np.isfinite(np_of(x)).all() and np.isfinite(float(res))
    assert abs(its - int(itj)) <= 1 and its < 50
    np.testing.assert_allclose(np_of(x), np_of(xj), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(float(res), float(resj), rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# the routed and SELL PageRanks


def test_pagerank_routed_matches_reference():
    """test_models' n 1500 graph: the routed PageRank of both packages
    (the JAX package's in interpret mode, so 30 iterations)."""
    j, t = graph(1500, 6, seed=1)
    deg = out_degree(t)
    sdj = j_to_device_routed(j_pack_routed(j.transpose().to_csr()))
    srt = t_pack_routed(t.transpose().to_csr())
    pj, itj, _ = j_pagerank_routed(sdj, out_degree=jnp.asarray(deg),
                                   tol=0.0, max_iters=30)
    p, its, delta = pagerank_routed(srt, out_degree=deg, tol=0.0,
                                    max_iters=30, device=CPU)
    assert its == int(itj) == 30
    np.testing.assert_allclose(np_of(p), np_of(pj), rtol=RTOL)
    assert abs(float(np_of(p).sum()) - 1.0) < 1e-3 and (np_of(p) >= 0).all()
    # the transposed_sd form, and converging runs
    p2, its2, _ = pagerank_routed(None, transposed_sd=srt, out_degree=deg,
                                  tol=1e-8, device=CPU)
    _, itj2, _ = j_pagerank_routed(None, transposed_sd=sdj,
                                   out_degree=jnp.asarray(deg), tol=1e-8)
    assert abs(its2 - int(itj2)) <= 1


def test_pagerank_sell_matches_reference():
    j, t = graph()
    deg = out_degree(t)
    sdj = j_to_device(j_sell_pack(j.transpose().to_csr(), C=128))
    pj, itj, _ = j_pagerank_sell(sdj, out_degree=jnp.asarray(deg), tol=0.0,
                                 max_iters=25)
    p, its, _ = pagerank_sell(t_sell_pack(t.transpose().to_csr(), C=128),
                              out_degree=deg, tol=0.0, max_iters=25,
                              device=CPU)
    assert its == int(itj) == 25
    np.testing.assert_allclose(np_of(p), np_of(pj), rtol=RTOL)


# ---------------------------------------------------------------------------
# the eigen solvers, on converged quantities


def sym_random(n=150, seed=2):
    rng = np.random.default_rng(seed)
    m = sp.random(n, n, density=0.1, random_state=rng)
    A = ((m + m.T) * 0.5).tocoo()
    j, t = pair(A.row.astype(np.int32), A.col.astype(np.int32),
                A.data.astype(np.float32), (n, n))
    return j, t, A


def test_power_iteration_converged_eigenvalue():
    j, t, A = sym_random()
    jm, tm = matvecs(j, t)
    lam, v, its = tmodels.power_iteration(tm, 150, tol=1e-10,
                                          max_iters=2000, device=CPU)
    lamj, vj, _ = jmodels.power_iteration(jm, 150, tol=1e-10,
                                          max_iters=2000)
    # the same dominant eigenvalue from different starts: relative 1e-4
    assert abs(float(lam) - float(lamj)) <= 1e-4 * abs(float(lamj))
    evals = np.linalg.eigvalsh(A.toarray())
    lam_ref = evals[np.argmax(np.abs(evals))]
    assert abs(abs(float(lam)) - abs(lam_ref)) / abs(lam_ref) < 1e-4
    assert isinstance(its, int) and np_of(v).dtype == np.float32


def tridiagonal(n=500, seed=11):
    rng = np.random.default_rng(seed)
    d = sp.diags([np.full(n - 1, -1.0), rng.uniform(2.1, 6.0, n),
                  np.full(n - 1, -1.0)], [-1, 0, 1]).tocoo()
    return JCOO.from_scipy(d), TCOO.from_scipy(d), d


def ritz(alpha, beta):
    a, b = np_of(alpha), np_of(beta)
    return np.linalg.eigvalsh(np.diag(a) + np.diag(b, 1) + np.diag(b, -1))


def test_lanczos_extremal_eigenvalues():
    """test_models' checks on both packages' Lanczos: extremal Ritz values
    of the tridiagonal against the dense spectrum, the basis orthonormal."""
    j, t, d = tridiagonal()
    jm, tm = matvecs(j, t)
    alpha, beta, V = tmodels.lanczos(tm, 500, k=40, seed=1, device=CPU)
    aj, bj, _ = jmodels.lanczos(jm, 500, k=40, seed=1)
    true = np.linalg.eigvalsh(d.toarray())
    for r in (ritz(alpha, beta), ritz(aj, bj)):
        assert abs(r[-1] - true[-1]) / abs(true[-1]) < 1e-3
        assert abs(r[0] - true[0]) / max(abs(true[0]), 1e-9) < 2e-2
    G = np_of(V).T @ np_of(V)
    np.testing.assert_allclose(G, np.eye(40), atol=1e-4)
    assert tuple(V.shape) == (500, 40) and tuple(beta.shape) == (39,)


def test_subspace_iteration_top_eigenvalue():
    """test_models' symmetrized band (its spectrum clusters at the top, so
    60 iterations settle the top eigenvalue, not the subspace)."""
    j, t = banded(1200, 7, 5)
    m = t.to_scipy()
    ms = ((m + m.T) / 2).tocoo()
    jm, tm = matvecs(JCOO.from_scipy(ms), TCOO.from_scipy(ms))
    evals, V = tmodels.subspace_iteration(tm, 1200, k=4, iters=60,
                                          device=CPU)
    ej, _ = jmodels.subspace_iteration(jm, 1200, k=4, iters=60)
    # largest first, as the JAX package's evals[::-1]
    assert (np.diff(np_of(evals)) <= 0).all() and tuple(V.shape) == (1200, 4)
    top = np.sort(np.abs(np.linalg.eigvalsh(ms.toarray())))[-1]
    assert abs(abs(float(evals[0])) - top) / top < 5e-2
    np.testing.assert_allclose(np_of(evals)[0], np_of(ej)[0], rtol=1e-4)


def test_subspace_iteration_spans_reference_subspace():
    """A symmetric matrix whose top 4 eigenvalues (near 20, 18, 16, 14)
    stand apart from the rest (under 5): 60 iterations converge the
    subspace, so both packages' starts reach the same one."""
    n, k = 1000, 4
    rng = np.random.default_rng(8)
    d = np.r_[20.0, 18.0, 16.0, 14.0, rng.uniform(0.0, 4.0, n - k)]
    off = rng.uniform(-0.2, 0.2, n - 1)
    m = sp.diags([off, d, off], [-1, 0, 1]).tocoo()
    jm, tm = matvecs(JCOO.from_scipy(m), TCOO.from_scipy(m))
    evals, V = tmodels.subspace_iteration(tm, n, k=k, iters=60, device=CPU)
    ej, Vj = jmodels.subspace_iteration(jm, n, k=k, iters=60)
    true = np.linalg.eigvalsh(m.toarray())[::-1][:k]
    # converged eigenvalues: relative 1e-4 of each other and of float64
    np.testing.assert_allclose(np_of(evals), np_of(ej), rtol=1e-4)
    np.testing.assert_allclose(np_of(evals), true, rtol=1e-4)
    # the same subspace: the singular values of V_port^T V_jax (cosines
    # of the principal angles) within 1e-3 of 1
    s = np.linalg.svd(np_of(V).T.astype(np.float64) @ np_of(Vj))[1]
    assert s.min() >= 1 - 1e-3


# ---------------------------------------------------------------------------
# the GNN layers, with the JAX weights carried across


def gcn_case(n=400, fin=16, fh=24, fout=8, seed=3):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int32), 6)
    cols = rng.integers(0, n, size=6 * n).astype(np.int32)
    vals = np.ones(6 * n, dtype=np.float32)
    nr, nc, nv = jgnn.gcn_normalize(rows, cols, vals, n)
    j, t = pair(nr, nc, nv, (n, n))
    X = rng.standard_normal((n, fin)).astype(np.float32)
    W1 = (rng.standard_normal((fin, fh)) * 0.3).astype(np.float32)
    W2 = (rng.standard_normal((fh, fout)) * 0.3).astype(np.float32)
    b1 = (rng.standard_normal(fh) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(fout) * 0.1).astype(np.float32)
    return j.sum_duplicates(), t.sum_duplicates(), X, [W1, W2], [b1, b2]


@pytest.mark.parametrize("add_self_loops", [True, False])
def test_gcn_normalize_bit_for_bit(add_self_loops):
    j, _ = powerlaw()  # signed values: the degree takes |weights|
    n = j.shape[0]
    got = tgnn.gcn_normalize(j.rows, j.cols, j.vals, n, add_self_loops)
    want = jgnn.gcn_normalize(j.rows, j.cols, j.vals, n, add_self_loops)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_bias", [False, True])
def test_gcn_forward_matches_reference_and_dense(with_bias):
    """GCN at widths 16 -> 24 -> 8 (the first layer widens: (A X) W, the
    second narrows: A (X W)), the weights carried across by
    params_from_reference.  rtol 1e-5, atol 1e-6: float32 sums of 6-7
    entries and of 16-24 products in another order; against float64 dense
    at test_models' rtol 1e-4, atol 1e-5."""
    j, t, X, Ws, bs = gcn_case()
    jm, tm = matvecs(j, t)
    bs = bs if with_bias else None
    weights, biases = tgnn.params_from_reference(Ws, bs, device=CPU)
    assert all(w.dtype == torch.float32 for w in weights)
    out = tmodels.gcn_forward(tm, X, weights, biases, device=CPU)
    want = jmodels.gcn_forward(jm, jnp.asarray(X),
                               [jnp.asarray(W) for W in Ws],
                               None if bs is None
                               else [jnp.asarray(b) for b in bs])
    np.testing.assert_allclose(np_of(out), np_of(want), rtol=1e-5, atol=1e-6)
    Ad = t.to_dense().astype(np.float64)
    H = Ad @ X.astype(np.float64) @ Ws[0] + (0 if bs is None else bs[0])
    H = np.maximum(H, 0.0)
    ref = Ad @ (H @ Ws[1]) + (0 if bs is None else bs[1])
    np.testing.assert_allclose(np_of(out), ref, rtol=1e-4, atol=1e-5)


def test_graphsage_layer_matches_reference_and_dense():
    rng = np.random.default_rng(7)
    n, fin, fout = 300, 12, 12
    rows = np.repeat(np.arange(n, dtype=np.int32), 5)
    cols = rng.integers(0, n, size=5 * n).astype(np.int32)
    j, t = pair(rows, cols, np.ones(5 * n, dtype=np.float32), (n, n))
    t = t.sum_duplicates()
    deg = out_degree(t).astype(np.float64)
    mv = (t.vals / np.maximum(deg[t.rows], 1)).astype(np.float32)
    jmean, tmean = pair(t.rows, t.cols, mv, (n, n))
    jm, tm = matvecs(jmean, tmean)
    X = rng.standard_normal((n, fin)).astype(np.float32)
    Ws = (rng.standard_normal((fin, fout)) * 0.3).astype(np.float32)
    Wn = (rng.standard_normal((fin, fout)) * 0.3).astype(np.float32)
    (ws, wn), _ = tgnn.params_from_reference([Ws, Wn], device=CPU)
    out = tmodels.graphsage_layer(tm, X, ws, wn, device=CPU)
    want = jmodels.graphsage_layer(jm, jnp.asarray(X), Ws, Wn)
    # float32 sums of 5 entries and of 12 products in another order
    np.testing.assert_allclose(np_of(out), np_of(want), rtol=1e-5, atol=1e-6)
    ref = np.maximum(X @ Ws + (tmean.to_dense().astype(np.float64) @ X) @ Wn,
                     0.0)
    np.testing.assert_allclose(np_of(out), ref, rtol=1e-4, atol=1e-5)


def test_dense_products_run_in_full_float32():
    """Under a process-wide "high" (TF32 on the card) the layers and
    Lanczos run their matmuls at "highest", then restore "high"."""
    seen = []
    j, t, X, Ws, _ = gcn_case()
    _, tm = matvecs(j, t)

    def spmm(M):
        seen.append(torch.get_float32_matmul_precision())
        return tm(M)

    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        tmodels.gcn_forward(spmm, X, Ws, device=CPU)
        tmodels.lanczos(lambda v: spmm(v[:, None])[:, 0], 400, k=3,
                        device=CPU)
        assert torch.get_float32_matmul_precision() == "high"
        with pytest.raises(ZeroDivisionError):
            with full_f32():
                raise ZeroDivisionError
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
    assert seen == ["highest"] * 5


# ---------------------------------------------------------------------------
# bench/models.py against the JAX model script's construction


def test_spd_banded_is_the_scripts_system():
    """scripts/models_bench.py's SPD system at n 4096, built as it builds
    it with the JAX package's COOMatrix."""
    n = 4096
    band = jsyn.banded_matrix(n, bandwidth=13, seed=5)
    sym = JCOO(np.concatenate([band.rows, band.cols]),
               np.concatenate([band.cols, band.rows]),
               np.concatenate([band.vals, band.vals]), (n, n)).sum_duplicates()
    row_abs = np.zeros(n, dtype=np.float64)
    np.add.at(row_abs, sym.rows.astype(np.int64), np.abs(sym.vals))
    spd_ = JCOO(np.concatenate([sym.rows, np.arange(n, dtype=np.int32)]),
                np.concatenate([sym.cols, np.arange(n, dtype=np.int32)]),
                np.concatenate([sym.vals, (row_abs + 1.0).astype(np.float32)]),
                (n, n)).sum_duplicates()
    same(bench_models.spd_banded(n), spd_.to_csr())


def test_pagerank_operator_is_the_scripts():
    """scripts/models_bench.py's A^T and out-degree, on R-MAT scale 12."""
    j, t = rmat(12, 6, 42)
    j.vals = np.ones_like(j.vals)
    csr_t = j.transpose().to_csr()
    deg = np.zeros(csr_t.shape[0], dtype=np.float32)
    np.add.at(deg, j.rows.astype(np.int64), 1.0)
    got_csr, got_deg = bench_models.pagerank_operator(t)
    same(got_csr, csr_t)
    assert got_deg.dtype == deg.dtype
    np.testing.assert_array_equal(got_deg, deg)


def test_cg_shaped_is_the_scripts_loop():
    """cg_shaped against the script's fori_loop rendering in jnp, 12
    iterations past convergence's guards, value for value."""
    j, t, b, _ = spd(seed=4)
    jm, tm = matvecs(j, t)

    def reference(scale, k):
        bb = jnp.asarray(b) * scale
        r = bb

        def body(i, st):
            xv, r, p, rs = st
            Ap = jm(p)
            alpha = rs / (jnp.vdot(p, Ap) + 1e-30)
            xv = xv + alpha * p
            r = r - alpha * Ap
            rs2 = jnp.vdot(r, r)
            return xv, r, r + (rs2 / (rs + 1e-30)) * p, rs2

        xv, *_ = jax.lax.fori_loop(0, k, body,
                                   (jnp.zeros_like(bb), r, r, jnp.vdot(r, r)))
        return jnp.sum(xv)

    got = bench_models.cg_shaped(tm, torch.from_numpy(b), 1.5, 12)
    np.testing.assert_allclose(float(got), float(reference(1.5, 12)),
                               rtol=RTOL)


def test_bench_runs_the_payloads_on_the_cpu(capsys):
    """The slice end to end, at a small size: bench_pagerank through
    pagerank_routed on an R-MAT scale-12 graph and bench_cg on an SPD band
    of 4096 rows (SELL-W), on CPU tensors, against the JAX package's
    PageRank and CG over its CSR SpMV on the same operators."""
    j, t = rmat(12, 6, 42)
    r = bench_models.bench_pagerank(20, CPU, coo=t, name="rmat12")
    csr_t, deg = r["csr_t"], r["out_degree"]
    jc = JCOO(*(a.astype(np.int32) for a in (csr_t.row_ids(), csr_t.cols)),
              csr_t.vals, csr_t.shape)
    jm, _ = matvecs(jc, t)
    pj, _, _ = jmodels.pagerank(jm, csr_t.shape[0], tol=0.0, max_iters=20,
                                out_degree=jnp.asarray(deg))
    assert r["iters"] == 20 and r["times"]["device_ms"] is None
    np.testing.assert_allclose(np_of(r["ranks"]), np_of(pj), rtol=RTOL)
    c = bench_models.bench_cg(10, CPU, n=4096)
    csr = c["csr"]
    jc = JCOO(csr.row_ids(), csr.cols, csr.vals, csr.shape)
    jm, _ = matvecs(jc, TCOO(csr.row_ids(), csr.cols, csr.vals, csr.shape))
    _, itj, _ = jmodels.conjugate_gradient(jm, jnp.asarray(np_of(c["b"])),
                                           tol=1e-6, max_iters=1000)
    assert abs(c["iters"] - int(itj)) <= 1 and c["true_rel"] < 1e-4
    out = capsys.readouterr().out
    assert "[model: pagerank] [matrix: rmat12]" in out
    assert "[model: cg] [matrix: spd-banded-4096" in out


def test_bench_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        bench_models.main([])


# ---------------------------------------------------------------------------
# the package


def test_models_export_the_reference_names():
    assert tmodels.__all__ == jmodels.__all__
    for name in tmodels.__all__:
        assert callable(getattr(tmodels, name)), name


def test_models_import_neither_jax_nor_the_reference():
    """The ast check of test_torch_route_fold covers every file under
    cvr_tpu_torch/; here, that it reaches the models and their bench."""
    from test_torch_route_fold import _imported

    files = [*sorted((REPO / "cvr_tpu_torch" / "models").glob("*.py")),
             REPO / "cvr_tpu_torch" / "bench" / "models.py"]
    assert len(files) == 5
    for p in files:
        assert not _imported(p) & {"jax", "cvr_tpu"}, p
