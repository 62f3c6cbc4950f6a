"""Nonlinear heat equation with a PyTorch external operator.

The twin of ``demos/demo_nonlinear_heat.py`` (reference
``demo_nonlinear_heat_equation_part3.py``): k(T) = 1/(A + B T), its
tangent by ``torch.func.jacfwd`` under ``torch.func.vmap`` over cells and
points (the JAX demo's ``jax.jit(vmap(jacfwd))``), solved by Newton and
verified against the pure-form twin with identical iteration counts.

    python demos_torch/demo_nonlinear_heat.py [--device cpu] [--small]
"""
import numpy as np
from torch.func import jacfwd, vmap

import dolfinx_external_operator_torch as fem
from dolfinx_external_operator_torch import (
    FEMExternalOperator,
    evaluate_external_operators,
    evaluate_operands,
    replace_external_operators,
    solvers,
)

from _common import check_no_jax, parse_args

A_, B_ = 1.0, 1.0


def main(n=16, device=None):
    mesh = fem.create_unit_square(n, n)
    V = fem.functionspace(mesh, ("Lagrange", 1))
    T = fem.Function(V, name="T", device=device)
    Q = fem.functionspace(mesh, fem.quadrature_element(mesh.cell_name(), degree=2))
    dx = fem.Measure("dx", metadata={"quadrature_degree": 2})

    k = FEMExternalOperator(T, function_space=Q)

    def k_pt(t):
        return 1.0 / (A_ + B_ * t)

    k_vec = vmap(vmap(k_pt))
    dk_vec = vmap(vmap(jacfwd(k_pt)))
    k.external_function = lambda d: {(0,): lambda t: k_vec(t).reshape(-1),
                                     (1,): lambda t: dk_vec(t).reshape(-1)}[d]

    v, du = fem.TestFunction(V), fem.TrialFunction(V)
    F = fem.inner(k * fem.grad(T), fem.grad(v)) * dx - 1.0 * v * dx
    J = fem.derivative(F, T, du)
    F_r, F_ops = replace_external_operators(F)
    J_r, J_ops = replace_external_operators(J)

    bdofs = fem.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[0], 0) | np.isclose(x[0], 1) | np.isclose(x[1], 0)
        | np.isclose(x[1], 1))
    bc = fem.DirichletBC(bdofs, np.zeros(len(bdofs)))

    def callback():
        ops = evaluate_operands(F_ops)
        evaluate_external_operators(F_ops, ops)
        evaluate_external_operators(J_ops, ops)

    T.interpolate(lambda x: 0.0 * x[0] + 0.01)
    prob = solvers.NonlinearProblem(
        F_r, T, J_r, bcs=[bc],
        petsc_options={"snes_atol": 1e-10, "snes_rtol": 1e-10, "snes_monitor": ""},
        external_callback=callback)
    its, conv = prob.solve()
    assert conv
    T_ext = T.data.clone()

    # pure-form twin from the same initial guess
    T.interpolate(lambda x: 0.0 * x[0] + 0.01)
    k_sym = 1.0 / (A_ + B_ * T)
    F_tw = fem.inner(k_sym * fem.grad(T), fem.grad(v)) * dx - 1.0 * v * dx
    prob_tw = solvers.NonlinearProblem(F_tw, T, fem.derivative(F_tw, T, du), bcs=[bc],
                                       petsc_options={"snes_atol": 1e-10, "snes_rtol": 1e-10})
    its_tw, _ = prob_tw.solve()
    diff = float((T_ext - T.data).abs().max())
    print(f"external vs twin: Newton its {its} vs {its_tw}; max diff {diff:.2e}")
    assert its == its_tw and diff < 1e-10
    print(f"nonlinear heat demo OK on {T.device}")


if __name__ == "__main__":
    args = parse_args(__doc__.splitlines()[0])
    main(n=8 if args.small else 16, device=args.device)
    check_no_jax()
