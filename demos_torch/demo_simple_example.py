"""Simple external-operator walkthrough: N(u) = u^2, with the PyTorch port.

The twin of ``demos/demo_simple_example.py`` (reference
``doc/demo/demo_simple_example.py``): define a symbolic external operator
on a quadrature space, differentiate the form, evaluate operands and
operators (the callbacks take and return tensors), assemble, and compare
with the explicit form.

    python demos_torch/demo_simple_example.py [--device cpu]
"""
import numpy as np

import dolfinx_external_operator_torch as fem
from dolfinx_external_operator_torch import (
    FEMExternalOperator,
    evaluate_external_operators,
    evaluate_operands,
    replace_external_operators,
)

from _common import check_no_jax, parse_args


def main(device=None, n=8):
    mesh = fem.create_unit_square(n, n)
    V = fem.functionspace(mesh, ("Lagrange", 1))
    u = fem.Function(V, name="u", device=device)
    u.interpolate(lambda x: x[0] ** 2 + x[1])

    qdeg = 2
    Q = fem.functionspace(mesh, fem.quadrature_element(mesh.cell_name(), degree=qdeg))
    dx = fem.Measure("dx", metadata={"quadrature_degree": qdeg})

    N = FEMExternalOperator(
        u, function_space=Q,
        external_function=lambda d: {
            (0,): lambda uu: (uu ** 2).reshape(-1),
            (1,): lambda uu: (2.0 * uu).reshape(-1),
        }[d],
    )

    v = fem.TestFunction(V)
    F = N * v * dx
    J = fem.derivative(F, u, fem.TrialFunction(V))

    F_replaced, F_ops = replace_external_operators(F)
    J_replaced, J_ops = replace_external_operators(J)
    operands = evaluate_operands(F_ops)
    evaluate_external_operators(F_ops, operands)
    evaluate_external_operators(J_ops, operands)

    b = np.asarray(fem.assemble_vector(F_replaced).cpu())
    A = np.asarray(fem.assemble_matrix(J_replaced).cpu())

    b_ref = np.asarray(fem.assemble_vector(u**2 * v * dx).cpu())
    A_ref = np.asarray(fem.assemble_matrix(fem.derivative(u**2 * v * dx, u,
                                                          fem.TrialFunction(V))).cpu())
    assert np.allclose(b, b_ref, atol=1e-14)
    assert np.allclose(A, A_ref, atol=1e-13)
    print(f"simple example OK on {u.device}: |b|={np.abs(b).max():.3e}")


if __name__ == "__main__":
    args = parse_args(__doc__.splitlines()[0])
    main(device=args.device)
    check_no_jax()
