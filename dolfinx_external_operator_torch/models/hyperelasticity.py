"""ICNN hyperelasticity: a square with elliptic holes under tension.

The port of ``dolfinx_external_operator_tpu/models/hyperelasticity.py``
(``_setup`` ``:47-65``, ``solve_hyperelasticity_nn`` ``:68-118``,
``solve_hyperelasticity_isihara`` ``:121-148``, ``run_comparison``
``:151-165``), the reference demo ``demo_hyperelasticity.py``: a pretrained
input-convex network's energy W(F) gives the first Piola-Kirchhoff stress
P = dW/dF + F H as an external operator on a tensor-valued quadrature
space, its callback the port's ``ICNN`` on the operands' device (the
tangent dP/dF by ``torch.func``).  The verification twin is the analytic
Isihara model written with ``variable``/``diff`` (reference ``:686-705``),
compared through the relative L-infinity and L2 displacement errors
(``:806,817``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .icnn import ICNN

__all__ = ["solve_hyperelasticity_nn", "solve_hyperelasticity_isihara", "run_comparison"]

QUADRATURE_DEGREE = 2

_OPTS = {"snes_atol": 1e-7, "snes_rtol": 1e-7, "snes_max_it": 50}


def _setup(lc=0.1, L=1.0, W=1.0):
    from ..assembly import DirichletBC, locate_dofs_topological
    from ..functionspace import functionspace
    from ..mesh import build_square_with_elliptic_holes
    from ..sym import Measure

    mesh, facet_tags, _ = build_square_with_elliptic_holes(L=L, lc=lc)
    V = functionspace(mesh, ("Lagrange", 2, (2,)))
    bottom_dofs = locate_dofs_topological(V, 1, facet_tags["bottom"])
    top_uy = locate_dofs_topological(V.sub(1), 1, facet_tags["top"])
    top_ux = locate_dofs_topological(V.sub(0), 1, facet_tags["top"])
    # bcs: bottom fully fixed; top ux = 0; top uy = prescribed (per step)
    bc_bottom = DirichletBC(np.concatenate([bottom_dofs * 2, bottom_dofs * 2 + 1]),
                            np.zeros(2 * bottom_dofs.size))
    bc_top_ux = DirichletBC(top_ux, np.zeros(top_ux.size))
    bc_top_uy = DirichletBC(top_uy, np.zeros(top_uy.size))
    dx = Measure("dx", domain=mesh, metadata={"quadrature_degree": QUADRATURE_DEGREE})
    return mesh, V, dx, [bc_top_uy, bc_top_ux, bc_bottom], bc_top_uy


def _run_steps(problem, bc_top, n_steps, max_displacement, verbose, what):
    iterations, step_s = [], []
    for step in range(1, n_steps + 1):
        t0 = time.perf_counter()
        bc_top.set(np.full(bc_top.dofs.shape, step * max_displacement / n_steps))
        its, converged = problem.solve()
        if not converged:
            raise RuntimeError(f"{what} did not converge at step {step}")
        iterations.append(its)
        step_s.append(time.perf_counter() - t0)
        if verbose:
            print(f"Step {step}: disp {step * max_displacement / n_steps:.3f}, Newton its: {its}")
    return iterations, step_s


def solve_hyperelasticity_nn(lc=0.1, n_steps=10, max_displacement=0.5, verbose=False,
                             icnn: ICNN | None = None, mesh_data=None, device=None):
    """External-operator (ICNN) solve on ``device`` (``None``: the card;
    raises without one).  Returns the JAX package's dict (u, mesh,
    iterations, ...) and ``step_s``, the host seconds of each step,
    ``icnn`` and the operator list ``F_ops``."""
    from .. import resolve_device, solvers
    from ..elements import quadrature_element
    from ..external_operator import (
        FEMExternalOperator,
        evaluate_external_operators,
        evaluate_operands,
        replace_external_operators,
    )
    from ..function import Function
    from ..functionspace import functionspace
    from ..sym import Identity, TestFunction, TrialFunction, derivative, grad, inner

    dev = resolve_device(device)
    mesh, V, dx, bcs, bc_top = mesh_data or _setup(lc)
    icnn = icnn or ICNN(device=dev)

    u = Function(V, name="displacement", device=dev)
    v = TestFunction(V)
    u_hat = TrialFunction(V)
    gradU = Identity(2) + grad(u)  # deformation gradient F

    Qe = quadrature_element(mesh.cell_name(), degree=QUADRATURE_DEGREE, value_shape=(2, 2))
    Q = functionspace(mesh, Qe)

    def dP_dF_impl(Fvals):
        return icnn.stress_and_tangent(Fvals.reshape(-1, 4))

    def P_external(derivatives):
        if derivatives == (1,):
            return dP_dF_impl
        raise NotImplementedError(derivatives)

    P = FEMExternalOperator(gradU, function_space=Q, external_function=P_external, name="P",
                            device=dev)

    F_res = inner(grad(v), P) * dx
    J = derivative(F_res, u, u_hat)
    F_replaced, F_ops = replace_external_operators(F_res)
    J_replaced, J_ops = replace_external_operators(J)

    def constitutive_update():
        evaluated = evaluate_operands(F_ops)
        ((_, P_new),) = evaluate_external_operators(J_ops, evaluated)
        P.ref_coefficient.x.array[:] = P_new

    problem = solvers.NonlinearProblem(F_replaced, u, J_replaced, bcs=bcs, petsc_options=_OPTS,
                                       external_callback=constitutive_update)
    iterations, step_s = _run_steps(problem, bc_top, n_steps, max_displacement, verbose,
                                    "Newton")
    return {"u": u, "mesh": mesh, "V": V, "dx": dx, "iterations": iterations,
            "mesh_data": (mesh, V, dx, bcs, bc_top), "step_s": step_s, "icnn": icnn,
            "F_ops": F_ops}


def solve_hyperelasticity_isihara(lc=0.1, n_steps=10, max_displacement=0.5, verbose=False,
                                  mesh_data=None, device=None):
    """Pure-form Isihara twin (reference :686-705), via ``variable``/``diff``,
    on ``device`` (``None``: the card).  Besides the JAX package's dict:
    ``step_s``."""
    from .. import resolve_device, solvers
    from ..function import Function
    from ..sym import Identity, TestFunction, TrialFunction, derivative, det, diff, grad, inner
    from ..sym import tr, variable

    dev = resolve_device(device)
    mesh, V, dx, bcs, bc_top = mesh_data or _setup(lc)
    u = Function(V, name="UFL_displacement", device=dev)
    v = TestFunction(V)
    u_hat = TrialFunction(V)

    F_ = variable(Identity(2) + grad(u))
    C = F_.T @ F_
    J_ = det(F_)
    I1 = tr(C) + 1.0
    I2 = I1 + J_**2 - 1.0
    I1_bar = (J_ ** (-2.0 / 3.0)) * I1
    I2_bar = (J_ ** (-4.0 / 3.0)) * I2
    W_isihara = 0.5 * (I1_bar - 3.0) + (I2_bar - 3.0) + (I1_bar - 3.0) ** 2 + 1.5 * (J_ - 1.0) ** 2
    P = diff(W_isihara, F_)

    F_res = inner(grad(v), P) * dx
    J_form = derivative(F_res, u, u_hat)
    problem = solvers.NonlinearProblem(F_res, u, J_form, bcs=bcs, petsc_options=_OPTS)
    iterations, step_s = _run_steps(problem, bc_top, n_steps, max_displacement, verbose,
                                    "Isihara twin")
    return {"u": u, "mesh": mesh, "V": V, "dx": dx, "iterations": iterations,
            "mesh_data": (mesh, V, dx, bcs, bc_top), "step_s": step_s}


def run_comparison(lc=0.1, n_steps=10, max_displacement=0.5, verbose=False, device=None):
    """NN against Isihara: the relative L-infinity and L2 displacement
    errors (reference :806,817) on ``device`` (``None``: the card)."""
    from ..assembly import assemble_scalar
    from ..function import Function
    from ..sym import inner

    nn = solve_hyperelasticity_nn(lc=lc, n_steps=n_steps, max_displacement=max_displacement,
                                  verbose=verbose, device=device)
    tw = solve_hyperelasticity_isihara(n_steps=n_steps, max_displacement=max_displacement,
                                       verbose=verbose, mesh_data=nn["mesh_data"], device=device)
    du = nn["u"].data - tw["u"].data
    rel_linf = float(du.abs().max() / tw["u"].data.abs().max())
    diff_fun = Function(nn["V"], device=du.device)
    diff_fun.x.array = du
    l2 = float(torch.sqrt(assemble_scalar(inner(diff_fun, diff_fun) * nn["dx"])))
    return {"rel_linf": rel_linf, "l2": l2, "nn": nn, "isihara": tw}
