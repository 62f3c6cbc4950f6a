"""GMRES and BiCGStab on torch tensors.

Torch has no nonsymmetric Krylov solvers, so this module ports the ones the
JAX package calls from ``jax.scipy.sparse.linalg`` (``gmres`` with
``solve_method="batched"`` and ``bicgstab``), keeping their algorithms:

* ``gmres``: left preconditioning (the Krylov space is built on
  ``M(A(v))``), one classical Gram-Schmidt pass per Arnoldi step (JAX's
  ``_iterative_classical_gram_schmidt`` with ``max_iterations=2`` stops
  after its first pass), the Hessenberg least-squares problem solved at
  the end of each restart through its normal equations and a Cholesky
  factorization, and ``maxiter`` counting restarts.  The restart loop tests
  the preconditioned residual's norm against ``max(tol * |b|, atol)``:
  one host read per restart.  A breakdown inside a restart (an invariant
  subspace) leaves the remaining Hessenberg rows at their identity
  initialisation, as in JAX, without a host read.
* ``bicgstab``: the preconditioned BiCGStab of scipy's non-legacy
  tolerance, with its early exit on a small intermediate residual and its
  breakdown exits (``rho == 0``; ``omega == 0`` or ``alpha == 0``).  One
  host read per iteration: the loop test.

Both return the iterate only; the JAX package reports no iteration count
for them (``ksp_iterations`` gains 0).
"""

from __future__ import annotations

import torch

from .utils.profiling import host_read

__all__ = ["bicgstab", "gmres"]


def _safe_normalize(x, thresh=None):
    """``(x / |x|, |x|)``, or ``(0, 0)`` where ``|x|`` is not above
    ``thresh`` (default: the dtype's machine epsilon)."""
    norm = torch.linalg.vector_norm(x)
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    return torch.where(use, x / norm, 0.0), torch.where(use, norm, 0.0)


def _gmres_restart(A, M, b, x0, unit_residual, residual_norm, restart):
    """One restart: ``restart`` Arnoldi steps from the unit preconditioned
    residual, then the projected solution ``x0 + V y`` with ``y`` the
    least-squares solution of ``H^T y = |r| e_0``."""
    n, dt, dev = b.shape[0], b.dtype, b.device
    V = torch.zeros((n, restart + 1), dtype=dt, device=dev)
    V[:, 0] = unit_residual
    H = torch.eye(restart, restart + 1, dtype=dt, device=dev)
    eps = torch.finfo(dt).eps
    broken = torch.zeros((), dtype=torch.bool, device=dev)
    for k in range(restart):
        v = M(A(V[:, k]))
        _, v_norm_0 = _safe_normalize(v)
        h = V.T @ v                     # one classical Gram-Schmidt pass
        v = v - V @ h
        unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
        # once broken down, JAX stops the Arnoldi loop: the later columns
        # stay zero and the later rows of H their identity rows
        V[:, k + 1] = torch.where(broken, V[:, k + 1], unit_v)
        h[k + 1] = v_norm_1
        H[k] = torch.where(broken, H[k], h)
        broken = broken | (v_norm_1 == 0.0)
    beta = torch.zeros(restart + 1, dtype=dt, device=dev)
    beta[0] = residual_norm
    # the normal equations of the least-squares problem (JAX's _lstsq,
    # solved with assume_a="pos")
    L, _ = torch.linalg.cholesky_ex(H @ H.T)
    y = torch.cholesky_solve((H @ beta)[:, None], L).squeeze(-1)
    x = x0 + V[:, :-1] @ y
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)))
    return x, unit_residual, residual_norm


def gmres(A, b, x0=None, *, tol=1e-5, atol=0.0, restart=20, maxiter=None, M=None):
    """Restarted, left-preconditioned GMRES (JAX ``gmres(...,
    solve_method="batched")``): ``A`` and ``M`` map a vector to a vector.
    Stops when the preconditioned residual's norm is at most ``max(tol *
    |b|, atol)`` or after ``maxiter`` restarts (default ``10 n``)."""
    n = b.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0
    M = M or (lambda r: r)
    maxiter = 10 * n if maxiter is None else maxiter
    restart = min(restart, n)
    target = max(tol * host_read(torch.linalg.vector_norm(b)), atol)
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)))
    k = 0
    while k < maxiter and host_read(residual_norm) > target:
        x, unit_residual, residual_norm = _gmres_restart(A, M, b, x, unit_residual,
                                                         residual_norm, restart)
        k += 1
    return x


def bicgstab(A, b, x0=None, *, tol=1e-5, atol=0.0, maxiter=None, M=None):
    """Preconditioned BiCGStab (JAX ``bicgstab``): stops when ``|r|^2 <=
    max(tol^2 |b|^2, atol^2)``, after ``maxiter`` iterations (default
    ``10 n``), or on a breakdown."""
    n = b.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0
    M = M or (lambda r: r)
    maxiter = 10 * n if maxiter is None else maxiter
    atol2 = max(tol * tol * host_read(torch.dot(b, b)), atol * atol)
    r = b - A(x)
    rhat = p = q = r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    alpha = omega = rho = one
    # k < 0 marks a breakdown: -10 (rho == 0), -11 (omega or alpha == 0)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    while True:
        rs, kk = host_read(torch.stack([torch.dot(r, r), k.to(b.dtype)]), torch.Tensor.tolist)
        if not (rs > atol2 and 0 <= kk < maxiter):
            return x
        rho_ = torch.dot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p = r + beta * (p - omega * q)
        phat = M(p)
        q = A(phat)
        alpha = rho_ / torch.dot(rhat, q)
        s = r - alpha * q
        exit_early = torch.dot(s, s) < atol2
        shat = M(s)
        t = A(shat)
        omega = torch.dot(t, s) / torch.dot(t, t)
        x = torch.where(exit_early, x + alpha * phat, x + (alpha * phat + omega * shat))
        r = torch.where(exit_early, s, s - omega * t)
        k = torch.where((omega == 0) | (alpha == 0), -11, k + 1)
        k = torch.where(rho_ == 0, -10, k)
        rho = rho_
