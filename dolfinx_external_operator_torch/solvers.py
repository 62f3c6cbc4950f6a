"""Nonlinear and linear solvers: the PETSc SNES/KSP replacement.

The port of ``dolfinx_external_operator_tpu/solvers.py`` (``_lu_ir``
``:44-66``, ``_ebe_pcg`` ``:131-189``, ``NewtonSolver`` ``:191-548``,
``NonlinearProblem`` ``:551-595``):

* ``NewtonSolver``: full-step Newton with the constitutive-update-BEFORE-
  assembly callback order of the reference SNES residual shim
  (``petsc/petsc.py:55-68``), the lifting through ``J.action``, the SNES
  atol/rtol test on the BC-adjusted residual norm, and the
  divergence-only backtracking counted in ``backtrack_count``.
* ``solve_dense`` (``ksp_type`` "preonly"/"lu"): Jacobi equilibration, an
  f32 LU factorization with partial pivoting (``torch.linalg.lu_factor``,
  as ``jax.scipy.linalg.lu_factor``) and 4 rounds of f64 refinement, the
  JAX package's algorithm.  TF32 stays off (package ``__init__``).
* ``ksp_type="cg"``: Jacobi-preconditioned CG over the element tensors
  (``_ebe_pcg``) with its breakdown guard and best-iterate exit; one host
  read per iteration (the loop test).

Not ported yet (ROADMAP.md queue 1, item 3, the general pipeline's deferred options); each
raises ``NotImplementedError``: ``ksp_type`` "gmres"/"bicgstab",
``pc_type="mg"``, and variable bounds under ``snes_type="vinewtonrsls"``.
Without bounds, ``vinewtonrsls`` is plain Newton, which is how every
reference demo runs it.
"""

from __future__ import annotations

import torch

from .assembly import bc_arrays, create_form

__all__ = ["solve_dense", "cg", "NewtonSolver", "NonlinearProblem"]

_F64 = torch.float64
_F32 = torch.float32

_DEFERRED = "not ported yet: ROADMAP.md queue 1, item 3 (the general pipeline's deferred options)"


# ----------------------------------------------------------------------
# Linear solvers
# ----------------------------------------------------------------------

def lu_factor32(A):
    """Jacobi equilibration and the f32 LU factorization with partial
    pivoting: ``(As, d, lu, piv)`` with ``As = D A D``, ``D = diag(d)``."""
    d = 1.0 / torch.sqrt(torch.clamp(torch.abs(torch.diagonal(A)), min=1e-300))
    As = A * d[:, None] * d[None, :]
    lu, piv = torch.linalg.lu_factor(As.to(_F32))
    return As, d, lu, piv


def lu_refine(factors, b, n_refine: int = 4):
    """The f32 solve of ``factors`` (``lu_factor32``) and ``n_refine``
    rounds of f64 iterative refinement against ``As``."""
    As, d, lu, piv = factors

    def solve32(r):
        return torch.linalg.lu_solve(lu, piv, r.to(_F32).unsqueeze(-1)).squeeze(-1).to(_F64)

    bs = b * d
    y = solve32(bs)
    for _ in range(n_refine):
        r = bs - As @ y
        y = y + solve32(r)
    return y * d


def _lu_ir(A, b, n_refine: int = 4):
    """f32 LU + f64 iterative refinement with Jacobi equilibration."""
    return lu_refine(lu_factor32(A), b, n_refine)


def solve_dense(A, b):
    """Direct dense solve in f64 (see module docstring)."""
    return _lu_ir(A, b)


def _pcg(matvec, M, b, x, target, maxiter, p_update):
    """The safeguarded PCG loop shared by ``cg`` and ``_ebe_pcg``:
    breakdown guard (``ok``, SPD invariants) and best-iterate tracking with
    a divergence exit (residual above 100x the best seen).  One host read
    per iteration: the loop test."""
    r = b - matvec(x)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    n_best = torch.linalg.vector_norm(r)
    n_cur = n_best
    x_best = x
    ok = torch.ones((), dtype=torch.bool, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    k = 0
    while k < maxiter and bool(ok & (n_cur > target)):
        Ap = matvec(p)
        pAp = torch.dot(p, Ap)
        ok = torch.isfinite(pAp) & (pAp > 0.0) & torch.isfinite(rz) & (rz > 0.0)
        alpha = torch.where(ok, rz / torch.where(pAp > 0.0, pAp, one), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        beta = torch.where(rz > 0.0, rz_new / torch.where(rz > 0.0, rz, one), zero)
        p = p_update(p, z, beta)
        rz = rz_new
        n_cur = torch.linalg.vector_norm(r)
        better = n_cur < n_best
        x_best = torch.where(better, x, x_best)
        n_best = torch.where(better, n_cur, n_best)
        ok = ok & torch.isfinite(n_cur) & (n_cur < 100.0 * n_best)
        k += 1
    return x_best, k


def cg(matvec, b, x0=None, M=None, tol=1e-12, atol=0.0, maxiter=None):
    """Preconditioned conjugate gradients (f64, matrix-free).

    ``matvec``: x -> A@x; ``M``: r -> approx A^{-1} r (default identity)."""
    n = b.shape[0]
    if maxiter is None:
        maxiter = 10 * n
    if M is None:
        M = lambda r: r  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    target = torch.clamp(tol * torch.linalg.vector_norm(b), min=atol)
    return _pcg(matvec, M, b, x, target, maxiter, lambda p, z, beta: z + beta * p)


def _ebe_pcg(elems, udofs_l, scatter, mask, diag, b, rtol, atol, maxiter):
    """Jacobi-preconditioned CG on the element-blocked operator: the matvec
    gathers ``x`` per cell, contracts the element tensors and sums through
    ``scatter`` (the form's gather table); BC rows/cols are eliminated
    (identity on constrained dofs)."""
    free = ~mask
    zero = torch.zeros((), dtype=b.dtype, device=b.device)

    def matvec(x):
        xz = torch.where(free, x, zero)
        out = scatter([torch.einsum("cij,cj->ci", e, xz[ud]) for e, ud in zip(elems, udofs_l)])
        return torch.where(free, out, zero) + torch.where(mask, x, zero)

    dsafe = torch.where(torch.abs(diag) > 1e-300, diag, torch.ones((), dtype=b.dtype, device=b.device))
    target = torch.clamp(rtol * torch.linalg.vector_norm(b), min=atol)
    return _pcg(matvec, lambda r: r / dsafe, b, torch.zeros_like(b), target, maxiter,
                lambda p, z, beta: p * beta + z)


# ----------------------------------------------------------------------
# Newton
# ----------------------------------------------------------------------

class NewtonSolver:
    """Full-step Newton with SNES-compatible semantics.

    Per iteration (the reference's SNES + residual-shim flow):
      1. call ``external_callback`` (constitutive update) at the current
         iterate -- BEFORE any assembly (``petsc/petsc.py:58-61``);
      2. assemble residual; apply BC lifting and ``set_bc`` rows;
      3. check ||r|| against atol/rtol (SNES default norm);
      4. assemble Jacobian, eliminate BC rows/cols symmetrically;
      5. solve J delta = -r and take the full step
         (``snes_linesearch_type: basic``).  Linear solvers by
         ``ksp_type``: "preonly"/"lu" = dense direct (f32 LU + f64
         refinement); "cg" = element-by-element CG with Jacobi
         preconditioning.
    """

    def __init__(self, atol=1e-8, rtol=1e-8, max_it=100, monitor=False,
                 ksp_type="preonly", ksp_rtol=1e-12, ksp_atol=0.0, ksp_max_it=None,
                 pc_type="jacobi", snes_type="newtonls"):
        self.atol = atol
        self.rtol = rtol
        self.max_it = max_it
        self.monitor = monitor
        if ksp_type in ("gmres", "bicgstab"):
            raise NotImplementedError(f"ksp_type={ksp_type!r} is {_DEFERRED}")
        if ksp_type not in ("preonly", "lu", "cg"):
            raise ValueError(f"unknown ksp_type {ksp_type!r}")
        self.ksp_type = ksp_type
        self.ksp_rtol = ksp_rtol
        self.ksp_atol = ksp_atol
        self.ksp_max_it = ksp_max_it
        if pc_type == "mg":
            raise NotImplementedError(f"pc_type='mg' in NewtonSolver is {_DEFERRED}")
        self.pc_type = pc_type
        if snes_type not in ("newtonls", "vinewtonrsls"):
            raise ValueError(f"unknown snes_type {snes_type!r}")
        self.snes_type = snes_type
        self._bounds = None
        self.iterations = 0
        self.ksp_iterations = 0
        self.history = []        # residual norms of the last solve ([norm0, ...])
        self.backtrack_count = 0  # times divergence backtracking fired (0 = SNES-"basic" trajectory)

    def set_variable_bounds(self, lb, ub):
        """``SNES.setVariableBounds``: bounds ``lb <= x <= ub`` for
        ``snes_type='vinewtonrsls'``.  Solving with bounds active is not
        ported yet and raises in ``solve``."""
        self._bounds = (lb, ub)

    def solve(self, problem) -> tuple[int, bool]:
        u = problem.u
        n = u.function_space.num_dofs
        if self.snes_type == "vinewtonrsls" and self._bounds is not None:
            raise NotImplementedError(f"variable bounds under snes_type='vinewtonrsls' are {_DEFERRED}")
        mask, g = bc_arrays(problem.bcs, n, u.device, u.dtype)
        zero = torch.zeros((), dtype=u.dtype, device=u.device)
        matrix_free = self.ksp_type == "cg"

        def residual():
            """BC-adjusted residual WITHOUT assembling the Jacobian: the
            lifting term ``A @ (g - x)`` goes through the matrix-free
            ``CompiledForm.action`` and is skipped once the BC dofs sit
            exactly on their values (every iterate after the first)."""
            if problem.external_callback is not None:
                problem.external_callback(*problem.callback_args)
            r = problem.F.vector()
            x = u.data
            dx_bc = torch.where(mask, g - x, zero)
            if bool(torch.any(dx_bc != 0.0)):
                r = r + problem.J.action(dx_bc)
            return torch.where(mask, x - g, r)

        def newton_step(r, emask):
            """delta solving  J_elim @ delta = -r  (rows/cols of ``emask``
            eliminated)."""
            if matrix_free:
                elems = problem.J.element_tensors()
                diag = torch.where(emask, torch.ones((), dtype=r.dtype, device=r.device),
                                   problem.J.diagonal())
                # PETSc KSP default maxits parity (10000); the breakdown
                # guard in _ebe_pcg exits earlier at the rounding floor
                maxiter = self.ksp_max_it if self.ksp_max_it is not None else min(10 * n, 10000)
                delta, k = _ebe_pcg(
                    [e for e, _, _ in elems], [ud for _, _, ud in elems], problem.J._scatter_rows,
                    emask, diag, -r, self.ksp_rtol, self.ksp_atol, maxiter)
                self.ksp_iterations += int(k)
                return delta
            # the assembled matrix is a fresh tensor: eliminate in place
            A = problem.J.matrix()
            keep = (~emask).to(A.dtype)
            A.mul_(keep[:, None]).mul_(keep[None, :])
            A.diagonal().add_(emask.to(A.dtype))
            return solve_dense(A, -r)

        def rnorm(r):
            return float(torch.linalg.vector_norm(r))

        r = residual()
        norm0 = rnorm(r)
        norm = norm0
        it = 0
        # per-solve stats: residual-norm history + backtracking counter.
        # The divergence-only backtracking below deviates from SNES
        # "basic" (full steps unconditionally), so a solve where it FIRED
        # is not trajectory-comparable to the reference.
        self.history = [norm0]
        self.backtrack_count = 0
        if self.monitor:
            print(f"  0 SNES Function norm {norm0:.12e}")
        converged = norm0 < self.atol
        while not converged and it < self.max_it:
            delta = newton_step(r, mask)
            u._data = u._data + delta
            it += 1
            r = residual()
            new_norm = rnorm(r)
            # divergence-only backtracking: full steps on nominal paths (the
            # reference's "basic" line search), halved steps only when the
            # residual grows strongly (robustness; the reference would fail)
            alpha = 1.0
            while new_norm > 2.0 * norm and alpha > 2**-8:
                self.backtrack_count += 1
                u._data = u._data - alpha * 0.5 * delta  # retract to alpha/2
                alpha *= 0.5
                r = residual()
                new_norm = rnorm(r)
            norm = new_norm
            self.history.append(norm)
            if self.monitor:
                print(f"  {it} SNES Function norm {norm:.12e}")
            converged = norm < self.atol or norm < self.rtol * max(norm0, 1e-300)
        self.iterations = it
        return it, converged


class NonlinearProblem:
    """High-level nonlinear problem mirroring
    ``dolfinx.fem.petsc.NonlinearProblem`` usage in the demos
    (``demo_plasticity_von_mises.py:433-435``).

    ``external_callback(*callback_args)`` is invoked before each residual
    assembly (the constitutive update hook)."""

    def __init__(self, F, u, J, bcs=(), petsc_options=None, petsc_options_prefix="",
                 external_callback=None, callback_args=()):
        # forms without coefficients (a linear problem's Jacobian) go
        # where the unknown lies
        self.F = create_form(F, u.device)
        self.J = create_form(J, u.device)
        self.u = u
        self.bcs = list(bcs)
        opts = dict(petsc_options or {})
        self.solver = NewtonSolver(
            atol=float(opts.get("snes_atol", 1e-8)),
            rtol=float(opts.get("snes_rtol", 1e-8)),
            max_it=int(opts.get("snes_max_it", 100)),
            monitor="snes_monitor" in opts,
            ksp_type=str(opts.get("ksp_type", "preonly")),
            ksp_rtol=float(opts.get("ksp_rtol", 1e-12)),
            ksp_atol=float(opts.get("ksp_atol", 0.0)),
            ksp_max_it=(int(opts["ksp_max_it"]) if "ksp_max_it" in opts else None),
            pc_type=str(opts.get("pc_type", "jacobi")),
            # the reference demos all pass {"snes_type": "vinewtonrsls"}
            # (with no bounds installed -- identical to plain Newton there)
            snes_type=str(opts.get("snes_type", "newtonls")),
        )
        self.external_callback = external_callback
        self.callback_args = tuple(callback_args)

    def set_external_callback(self, fn, args=()):
        """Install the constitutive-update hook (plays the role of
        ``problem.solver.setFunction(assemble_residual_with_callback_, b)``
        in the reference demos, ``demo_plasticity_von_mises.py:531``)."""
        self.external_callback = fn
        self.callback_args = tuple(args)

    def solve(self):
        its, converged = self.solver.solve(self)
        if not converged:
            raise RuntimeError(f"Newton failed to converge in {its} iterations")
        return its, converged
