"""Iterative solvers driven by the port's SpMVs and SpMMs.

Conjugate gradient, BiCGSTAB, Jacobi, power iteration, subspace iteration
and Lanczos, as Python loops over tensors.  A stopping test reads one
device scalar per iteration, so each solver stops at the iteration the
JAX package's ``while_loop`` stops at; iteration counts are Python ints.
Vectors given as numpy or float64 are cast to float32 on ``device``.  The
random starts draw from a seeded CPU ``torch.Generator`` and move the draw
to ``device``, so a CPU run and a card run start from the same vector.
The dense products run in full float32 whatever
``torch.set_float32_matmul_precision`` says (``full_f32``).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Float32 matmuls at full precision (no TF32) inside the block; the
    process's setting is restored after it."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _randn(shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(device)


def conjugate_gradient(matvec, b, x0=None, tol: float = 1e-6,
                       max_iters: int = 1000, device="cuda"):
    """Solve A x = b for SPD A.  Returns (x, iterations, residual_norm)."""
    b = _f32(b, device)
    x = torch.zeros_like(b) if x0 is None else _f32(x0, device)
    r = b - matvec(x)
    p = r
    rs = torch.dot(r, r)
    b_norm = torch.clamp(torch.linalg.vector_norm(b), min=1e-30)
    it = 0
    while it < max_iters and bool(torch.sqrt(rs) / b_norm > tol):
        Ap = matvec(p)
        alpha = rs / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        it += 1
    return x, it, torch.sqrt(rs) / b_norm


def power_iteration(matvec, n: int, tol: float = 1e-9, max_iters: int = 500,
                    seed: int = 0, device="cuda"):
    """Dominant eigenpair of A.  Returns (eigenvalue, eigenvector, iters)."""
    v = _randn((n,), seed, device)
    v = v / torch.linalg.vector_norm(v)
    lam = torch.tensor(0.0, device=device)
    delta = torch.tensor(float("inf"), device=device)
    it = 0
    while it < max_iters and bool(delta > tol):
        w = matvec(v)
        lam_new = torch.dot(v, w)
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
        delta = torch.abs(lam_new - lam)
        lam = lam_new
        it += 1
    return lam, v, it


def bicgstab(matvec, b, x0=None, tol: float = 1e-6, max_iters: int = 1000,
             device="cuda"):
    """Solve A x = b for general (nonsymmetric) A via BiCGSTAB, two A @ v
    products an iteration.  Returns (x, iterations, relative residual
    norm).  On an exact breakdown (rho = 0, r_hat orthogonal to v, or
    omega = 0: singular or deficient systems) the iteration stops at the
    last finite iterate instead of spinning NaNs to max_iters."""
    b = _f32(b, device)
    x = torch.zeros_like(b) if x0 is None else _f32(x0, device)
    r = b - matvec(x)
    r_hat = r  # shadow residual
    b_norm = torch.clamp(torch.linalg.vector_norm(b), min=1e-30)
    rho = torch.dot(r_hat, r)
    p = r
    eps = 1e-30
    down = torch.tensor(False, device=device)
    it = 0
    while it < max_iters and bool(
            (torch.linalg.vector_norm(r) / b_norm > tol) & ~down):
        v = matvec(p)
        rv = torch.dot(r_hat, v)
        rv_broke = torch.abs(rv) < eps
        alpha = rho / torch.where(rv_broke, 1.0, rv)
        s = r - alpha * v
        x_h = x + alpha * p  # the valid half-step iterate
        # exact (half-)step convergence is not a breakdown: t ~ 0 makes
        # tt / omega degenerate precisely because s already solved the
        # system, so x_h is kept (A = I converges here in one iteration)
        half = torch.linalg.vector_norm(s) / b_norm <= tol
        t = matvec(s)
        tt = torch.dot(t, t)
        tt_broke = tt < eps
        omega = torch.dot(t, s) / torch.where(tt_broke, 1.0, tt)
        om_broke = tt_broke | (torch.abs(omega) < eps)
        x_n = x_h + omega * s
        r_n = s - omega * t
        rho_n = torch.dot(r_hat, r_n)
        # three outcomes: rv breakdown -> nothing new is defined, keep the
        # old iterate; half-step valid but t-step degenerate (or already
        # converged) -> keep (x_h, s); otherwise the full step
        use_old = rv_broke
        use_half = ~rv_broke & (half | om_broke)
        x_sel = torch.where(use_old, x, torch.where(use_half, x_h, x_n))
        r_sel = torch.where(use_old, r, torch.where(use_half, s, r_n))
        stop = use_old | use_half | (torch.abs(rho_n) < eps)
        beta = (rho_n / torch.where(torch.abs(rho) < eps, 1.0, rho)) * (
            alpha / torch.where(om_broke, 1.0, omega))
        p_n = r_n + beta * (p - omega * v)
        x, r = x_sel, r_sel
        p = torch.where(stop, p, p_n)
        rho = torch.where(stop, rho, rho_n)
        down = stop
        it += 1
    return x, it, torch.linalg.vector_norm(r) / b_norm


def jacobi(matvec, diag, b, x0=None, omega: float = 1.0, tol: float = 1e-6,
           max_iters: int = 1000, device="cuda"):
    """(Weighted) Jacobi iteration x <- x + omega D^-1 (b - A x): one SpMV
    plus elementwise work a sweep.  Returns (x, iterations, relative
    residual norm)."""
    b = _f32(b, device)
    x = torch.zeros_like(b) if x0 is None else _f32(x0, device)
    dinv = omega / _f32(diag, device)
    b_norm = torch.clamp(torch.linalg.vector_norm(b), min=1e-30)
    # r = b - A x for the current x, so the convergence test and the
    # returned residual describe the returned iterate
    r = b - matvec(x)
    it = 0
    while it < max_iters and bool(torch.linalg.vector_norm(r) / b_norm > tol):
        x = x + dinv * r
        r = b - matvec(x)
        it += 1
    return x, it, torch.linalg.vector_norm(r) / b_norm


def subspace_iteration(matmat, n: int, k: int = 8, iters: int = 30,
                       seed: int = 0, device="cuda"):
    """Top-k eigenpairs of symmetric A by block power (subspace)
    iteration, the multi-RHS workload of the SpMM paths.

    matmat: V [n, k] -> A @ V.  Returns (eigenvalues [k], V [n, k]),
    largest eigenvalue first."""
    with full_f32():
        V, _ = torch.linalg.qr(_randn((n, k), seed, device))
        for _ in range(iters):
            V, _ = torch.linalg.qr(matmat(V))
        W = matmat(V)
        # Rayleigh-Ritz on the subspace
        H = V.T @ W
        evals, Q = torch.linalg.eigh((H + H.T) / 2)
        return torch.flip(evals, (0,)), V @ torch.flip(Q, (1,))


def lanczos(matvec, n: int, k: int = 32, seed: int = 0, device="cuda"):
    """k-step Lanczos tridiagonalization of symmetric A with full
    reorthogonalization (k is small, so its k^2 cost is dwarfed by the
    SpMVs and the numerics stay clean in float32).

    matvec: v [n] -> A @ v.  Returns (alpha [k], beta [k-1], V [n, k]):
    eigenvalues of the (alpha, beta) tridiagonal approximate A's extremal
    spectrum."""
    v = _randn((n,), seed, device)
    # the basis by rows, so that each vector handed to matvec is contiguous
    Vt = torch.zeros((k, n), dtype=torch.float32, device=device)
    Vt[0] = v / torch.linalg.vector_norm(v)
    alpha = torch.zeros(k, dtype=torch.float32, device=device)
    beta = torch.zeros(max(k - 1, 1), dtype=torch.float32, device=device)
    with full_f32():
        for j in range(k):
            v = Vt[j]
            w = matvec(v)
            a = torch.dot(v, w)
            w = w - a * v
            # full reorthogonalization against the basis built so far
            basis = Vt[: j + 1]
            w = w - (basis @ w) @ basis
            b = torch.linalg.vector_norm(w)
            alpha[j] = a
            if j < k - 1:
                beta[j] = b
                Vt[j + 1] = torch.where(b > 1e-30,
                                        w / torch.clamp(b, min=1e-30), w)
    return alpha, beta[: k - 1], Vt.T
