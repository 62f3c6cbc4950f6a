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
* ``ksp_type`` "gmres"/"bicgstab": the port's own restarted GMRES and
  BiCGStab (``krylov.py``, the algorithms of ``jax.scipy.sparse.linalg``)
  over the same element-by-element operator with Jacobi preconditioning.
* ``pc_type="mg"`` with "cg" or "gmres" (``NewtonSolver._mg_solve``):
  aggregation AMG from ``parallel/mg.py`` on the element-blocked Jacobian,
  inside the mixed-precision ``ir_pcg`` or as GMRES's preconditioner.
* ``snes_type="vinewtonrsls"`` with bounds (``set_variable_bounds``): the
  reduced-space active-set Newton of PETSc's SNESVINEWTONRSLS.  Without
  bounds it is plain Newton, which is how every reference demo runs it.

Cell-sharded (forms compiled under ``parallel.set_default_device_mesh``),
the assembled vectors, matrices and diagonals are whole and the same on
every rank (``assembly``), so the dense path factorizes the same matrix on
every rank and the Newton loop reads the same norms; the element tensors
are the rank's, and each element-by-element matvec gathers its per-cell
products whole (``CompiledForm._scatter_rows``).  The AMG hierarchy is
built whole on every rank from the gathered element tensors, with the
rank's level-0 maps and their sums through ``dist.psum`` (the fused
step's ``parallel/mg.py`` hooks).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import krylov
from .assembly import bc_arrays, create_form

__all__ = ["solve_dense", "cg", "NewtonSolver", "NonlinearProblem"]

_F64 = torch.float64
_F32 = torch.float32

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


def _ebe_operator(elems, udofs_l, scatter, mask):
    """The element-by-element operator with the rows and columns of
    ``mask`` eliminated (identity on them): the matvec gathers ``x`` per
    cell, contracts the element tensors and sums through ``scatter`` (the
    form's gather table)."""
    free = ~mask
    zero = torch.zeros((), dtype=elems[0].dtype, device=mask.device)

    def matvec(x):
        xz = torch.where(free, x, zero)
        out = scatter([torch.einsum("cij,cj->ci", e, xz[ud]) for e, ud in zip(elems, udofs_l)])
        return torch.where(free, out, zero) + torch.where(mask, x, zero)

    return matvec


def _jacobi(diag):
    """``r -> r / diag`` with the zero-diagonal guard of the JAX package."""
    dsafe = torch.where(torch.abs(diag) > 1e-300, diag, torch.ones((), dtype=diag.dtype, device=diag.device))
    return lambda r: r / dsafe


def _ebe_pcg(elems, udofs_l, scatter, mask, diag, b, rtol, atol, maxiter):
    """Jacobi-preconditioned CG on the element-blocked operator
    (``_ebe_operator``: BC rows/cols eliminated, identity on constrained
    dofs)."""
    target = torch.clamp(rtol * torch.linalg.vector_norm(b), min=atol)
    return _pcg(_ebe_operator(elems, udofs_l, scatter, mask), _jacobi(diag), b,
                torch.zeros_like(b), target, maxiter, lambda p, z, beta: p * beta + z)


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
         refinement); "cg"/"gmres"/"bicgstab" = element-by-element
         Krylov with Jacobi preconditioning, or with ``pc_type="mg"``
         ("cg" and "gmres") aggregation AMG.
    """

    def __init__(self, atol=1e-8, rtol=1e-8, max_it=100, monitor=False,
                 ksp_type="preonly", ksp_rtol=1e-12, ksp_atol=0.0, ksp_max_it=None,
                 pc_type="jacobi", snes_type="newtonls"):
        self.atol = atol
        self.rtol = rtol
        self.max_it = max_it
        self.monitor = monitor
        if ksp_type not in ("preonly", "lu", "cg", "gmres", "bicgstab"):
            raise ValueError(f"unknown ksp_type {ksp_type!r}")
        self.ksp_type = ksp_type
        self.ksp_rtol = ksp_rtol
        self.ksp_atol = ksp_atol
        self.ksp_max_it = ksp_max_it
        # "jacobi" (default) or "mg" (aggregation-AMG cycle, with cg or
        # gmres; the reference's {"pc_type": "lu"} maps to ksp_type
        # "preonly")
        self.pc_type = pc_type
        # "newtonls" or "vinewtonrsls" (reduced-space active-set Newton for
        # bounds lb <= x <= ub, PETSc's SNESVINEWTONRSLS, the snes_type
        # every reference plasticity demo requests); without bounds
        # (``set_variable_bounds``) the two are identical
        if snes_type not in ("newtonls", "vinewtonrsls"):
            raise ValueError(f"unknown snes_type {snes_type!r}")
        self.snes_type = snes_type
        self._bounds = None
        self.iterations = 0
        self.ksp_iterations = 0
        self.history = []        # residual norms of the last solve ([norm0, ...])
        self.backtrack_count = 0  # times divergence backtracking fired (0 = SNES-"basic" trajectory)
        self._mg = None  # the AMG plan of the first mg solve, kept for the problem's life

    def set_variable_bounds(self, lb, ub):
        """``SNES.setVariableBounds``: install per-dof bounds ``lb <= x <=
        ub`` (scalars broadcast) for ``snes_type='vinewtonrsls'``.  At each
        iteration the active set ``{i : (x_i <= lb_i and F_i > 0) or (x_i
        >= ub_i and F_i < 0)}`` is frozen (delta_i = 0, row and column
        eliminated as a Dirichlet row), the Newton system is solved on the
        inactive set, and the iterate is projected back into the box;
        convergence is tested on the reduced residual (F_i on the inactive
        set), PETSc's RSLS semantics."""
        self._bounds = (lb, ub)

    def _mg_plan(self, problem, elems):
        """The AMG hierarchy of the general path, built once per problem
        from the Jacobian's element tensors at the first call (the elastic
        operator for the usual zero start).

        The hierarchy and the smoother values come from the DOMINANT
        batch, the full-domain cell integral whose dofmap is the space's
        own; every batch must map test dofs == trial dofs.  The structure
        is frozen on the Dirichlet-only mask: a bound-constrained Newton's
        changing active set is eliminated per call (``_mg_solve``).  For
        gmres the hierarchy is built on the symmetrized operator.  The
        typed raises and their messages are the JAX package's."""
        from .parallel import mg as mgmod

        V = problem.J.test_space
        dm_V = V.unrolled_dofmap
        dom = None
        for i, ((_, tdofs, udofs), s) in enumerate(zip(elems, problem.J._statics())):
            if not torch.equal(tdofs, udofs):
                raise NotImplementedError(
                    "pc_type='mg' needs test dofs == trial dofs (the "
                    "symmetric displacement-block case); this Jacobian's "
                    f"cell batch {i} maps different spaces — use "
                    "pc_type='jacobi'")
            td = s["test_dofs_all"]  # every rank's cells of the batch
            if dom is None and td.shape == dm_V.shape and np.array_equal(td, dm_V):
                dom = i
        if dom is None:
            raise NotImplementedError(
                "pc_type='mg' needs one full-domain cell-integral batch "
                "over the whole space (the aggregation/smoothing proxy); "
                f"none of the {len(elems)} batches covers it — use "
                "pc_type='jacobi'")
        n = V.num_dofs
        bc_only = np.zeros(n, dtype=bool)
        for bc in problem.bcs:
            bc_only[bc.dofs] = True
        gmres = self.ksp_type == "gmres"
        dmesh, psum = problem.J.device_mesh, None
        K_dom0 = elems[dom][0]
        if dmesh is not None:  # the hierarchy is built whole on every rank
            from .parallel import dist, rank_rows

            K_dom0 = dist.all_gather(K_dom0, dm_V.shape[0], dmesh.group)
            psum = functools.partial(dist.psum, group=dmesh.group)
        K_dom0 = K_dom0.cpu().numpy()
        if gmres:
            K_dom0 = 0.5 * (K_dom0 + np.swapaxes(K_dom0, 1, 2))
        mgs = mgmod.build_mg_statics(problem.J.mesh, V, bc_only, K_dom0,
                                     galerkin_levels=None if n <= 30_000 else 1)
        if dmesh is not None:  # the level-0 maps of the rank's cells
            rows = rank_rows(dm_V.shape[0], dmesh)[0]
            t0 = dict(mgs["transfers"][0])
            t0["W"], t0["blk_dst"] = np.asarray(t0["W"])[rows], np.asarray(t0["blk_dst"])[rows]
            mgs["transfers"] = [t0] + list(mgs["transfers"][1:])
        dev = elems[dom][0].device
        return {"dom": dom, "gmres": gmres, "n": n,
                "plan": mgmod.mg_plan(mgs, elems[dom][1].cpu().numpy(), bc_only, dev, psum=psum,
                                      mv0_mode="scalar", cheb_degree=mgs["cheb_degree"]),
                "ebe": [mgmod.ebe_plan(td.cpu().numpy(), bc_only, n, dev, psum=psum)
                        for _, td, _ in elems]}

    def _mg_solve(self, problem, elems, mask, b, maxiter):
        """AMG-preconditioned Krylov on the element-blocked Jacobian
        (JAX ``solvers.py:252-392``), with the rows and columns of ``mask``
        (Dirichlet dofs plus, under ``vinewtonrsls``, the active bound
        set) eliminated on every call: the exact f64 operator, the f32
        iteration operator and the smoother values give identity rows on
        ``mask``, and the cycle's output is overwritten there.  The exact
        operator sums every batch (each contributes the identity on masked
        rows, so ``k`` batches subtract ``k - 1`` of them).

        cg: the mixed-precision ``ir_pcg`` (f32 PCG with one cycle per
        iteration inside f64 refinement), honouring ``ksp_atol``.  gmres:
        f64 GMRES on the true operator with the cycle (symmetrized values)
        as its preconditioner; it reports 0 iterations.  On the card the
        cycle is replayed from a CUDA graph captured once per call
        (``mg.cuda_graphed``).  Returns (delta, inner iterations)."""
        from .parallel import mg as mgmod

        if self._mg is None:
            self._mg = self._mg_plan(problem, elems)
        st = self._mg
        plan, dom, gmres = st["plan"], st["dom"], st["gmres"]
        free = ~mask
        f32 = torch.float32
        Kbs = []
        for K_cell, tdofs, _ in elems:
            km = free.to(K_cell.dtype)[tdofs]
            Kbs.append(K_cell * km[:, :, None] * km[:, None, :])
        K_dom = Kbs[dom]
        if gmres:  # the smoother values track the symmetric part
            K_dom = 0.5 * (K_dom + K_dom.transpose(1, 2))
        rt = mgmod.mg_setup(plan, K_dom.to(f32), free)
        mvs64 = [mgmod.ebe_matvec(Kb, e, free) for Kb, e in zip(Kbs, st["ebe"])]
        sec32 = [mgmod.ebe_matvec(Kb.to(f32), e, free)
                 for i, (Kb, e) in enumerate(zip(Kbs, st["ebe"])) if i != dom]

        def mv(x):
            out = mvs64[0](x)
            for m in mvs64[1:]:
                out = out + m(x) - torch.where(mask, x, 0.0)
            return out

        def mv32(x):
            out = rt["mv0"](x)
            for m in sec32:
                out = out + m(x) - torch.where(mask, x, 0.0)
            return out

        def M(r):
            z = mgmod.vcycle(plan, rt, torch.where(mask, 0.0, r.to(f32)))
            return torch.where(mask, r, z.to(r.dtype))

        # sharded, the cycle's level-0 matvec all-reduces: a graph holds an
        # NCCL all-reduce, not gloo's, which stages through the host, so
        # over gloo the cycle runs eager
        dmesh = problem.J.device_mesh
        if dmesh is None or dmesh.backend == "nccl":
            M = mgmod.cuda_graphed(M, torch.zeros_like(b if gmres else b.to(f32)))
        if gmres:
            delta = krylov.gmres(mv, b, M=M, tol=self.ksp_rtol, atol=self.ksp_atol,
                                 maxiter=maxiter, restart=min(st["n"], 50))
            return delta, 0
        return mgmod.ir_pcg(mv, mv32, M, b, self.ksp_rtol, maxiter, atol=self.ksp_atol)

    def solve(self, problem) -> tuple[int, bool]:
        u = problem.u
        n = u.function_space.num_dofs
        mask, g = bc_arrays(problem.bcs, n, u.device, u.dtype)
        zero = torch.zeros((), dtype=u.dtype, device=u.device)
        matrix_free = self.ksp_type in ("cg", "gmres", "bicgstab")
        vi = self.snes_type == "vinewtonrsls" and self._bounds is not None
        if vi:
            lb, ub = (torch.as_tensor(v, dtype=u.dtype, device=u.device).broadcast_to((n,))
                      for v in self._bounds)
        if self.pc_type == "mg" and self.ksp_type not in ("cg", "gmres"):
            # also for preonly (the default): falling through to the dense
            # path would factorize an (n, n) matrix at exactly the sizes mg
            # exists for
            raise NotImplementedError(
                "pc_type='mg' is implemented for ksp_type='cg' (SPD "
                "Jacobians) and ksp_type='gmres' (nonsymmetric Jacobians, "
                "V-cycle built on the symmetrized operator); bicgstab uses "
                "pc_type='jacobi', and the default ksp_type='preonly' is "
                "the dense direct solver")

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
            """delta solving  J_elim @ delta = -r  (rows/cols of ``emask``,
            the BC dofs plus, under vinewtonrsls, the active bound set,
            eliminated)."""
            if matrix_free:
                elems = problem.J.element_tensors()
                # PETSc KSP default maxits parity (10000); the breakdown
                # guard in _ebe_pcg exits earlier at the rounding floor
                maxiter = self.ksp_max_it if self.ksp_max_it is not None else min(10 * n, 10000)
                if self.pc_type == "mg":
                    delta, k = self._mg_solve(problem, elems, emask, -r, maxiter)
                    self.ksp_iterations += int(k)
                    return delta
                diag = torch.where(emask, torch.ones((), dtype=r.dtype, device=r.device),
                                   problem.J.diagonal())
                args = ([e for e, _, _ in elems], [ud for _, _, ud in elems],
                        problem.J._scatter_rows, emask)
                if self.ksp_type == "cg":
                    delta, k = _ebe_pcg(*args, diag, -r, self.ksp_rtol, self.ksp_atol, maxiter)
                    self.ksp_iterations += int(k)
                    return delta
                # gmres / bicgstab for nonsymmetric Jacobians, over the same
                # operator with Jacobi preconditioning; neither reports an
                # iteration count
                if self.ksp_type == "gmres":
                    return krylov.gmres(_ebe_operator(*args), -r, M=_jacobi(diag), tol=self.ksp_rtol,
                                        atol=self.ksp_atol, maxiter=maxiter, restart=min(n, 50))
                return krylov.bicgstab(_ebe_operator(*args), -r, M=_jacobi(diag), tol=self.ksp_rtol,
                                       atol=self.ksp_atol, maxiter=maxiter)
            # the assembled matrix is a fresh tensor: eliminate in place
            A = problem.J.matrix()
            keep = (~emask).to(A.dtype)
            A.mul_(keep[:, None]).mul_(keep[None, :])
            A.diagonal().add_(emask.to(A.dtype))
            return solve_dense(A, -r)

        def vi_active(r):
            """RSLS active set: dofs on a bound whose residual pushes them
            further out of the box (at x = lb feasibility needs F >= 0, at
            x = ub F <= 0).  The iterate stays in the box by projection, so
            the bound comparisons are exact."""
            x = u.data
            return (~mask) & (((x <= lb) & (r > 0.0)) | ((x >= ub) & (r < 0.0)))

        def rnorm(r):
            """Convergence norm; PETSc RSLS tests the REDUCED residual (the
            active set's components are feasible by complementarity, not
            zero)."""
            if vi:
                r = torch.where(vi_active(r), zero, r)
            return float(torch.linalg.vector_norm(r))

        if vi:
            u._data = torch.clamp(u.data, lb, ub)
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
            if vi:
                active = vi_active(r)
                delta = newton_step(torch.where(active, zero, r), mask | active)
                delta = torch.where(active, zero, delta)
                u._data = torch.clamp(u._data + delta, lb, ub)
            else:
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
                if vi:
                    u._data = torch.clamp(u._data, lb, ub)
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
            # (with no bounds installed -- identical to plain Newton there);
            # bounds go in through solver.set_variable_bounds
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
