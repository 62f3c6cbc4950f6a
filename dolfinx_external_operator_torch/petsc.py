"""Reference-parity solver shim (``dolfinx_external_operator.petsc``).

The port of ``dolfinx_external_operator_tpu/petsc.py:13-45``.  The reference
exposes ``petsc.assemble_residual_with_callback``
(``src/dolfinx_external_operator/petsc/petsc.py:11-68``): a SNES residual
callback that (1) updates the solution, (2) calls the user's constitutive
callback BEFORE assembly, (3) assembles + lifts + applies BCs.  Here the
same order is built into ``solvers.NewtonSolver.solve`` /
``NonlinearProblem``; this module keeps the reference's entry-point name so
user code ports directly.
"""

from __future__ import annotations

from .solvers import NewtonSolver, NonlinearProblem

__all__ = ["assemble_residual_with_callback", "NonlinearProblem", "NewtonSolver"]


def assemble_residual_with_callback(u, F, J, bcs, external_callback, args_external_callback,
                                    solver=None, x=None, b=None):
    """Install the constitutive-update hook on a problem/solver.

    Usage parity with the reference
    (``demo_plasticity_von_mises.py:519-531``): partially apply the first
    six arguments, then hand the result to the problem.  Called with a
    ``NonlinearProblem`` as ``solver`` it installs the callback and returns
    the problem; the order (callback before assembly) is enforced inside
    ``NewtonSolver.solve``.
    """
    if isinstance(solver, NonlinearProblem):
        solver.set_external_callback(external_callback, args_external_callback)
        return solver
    # direct invocation: run the callback and return the BC-adjusted residual
    # (assemble -> apply_lifting -> set_bc, the reference shim's
    # petsc/petsc.py:64-68 order)
    external_callback(*args_external_callback)
    from .assembly import apply_lifting, create_form, set_bc

    b = create_form(F, u.device).vector()
    if bcs:
        x0 = u.data if x is None else x
        b = apply_lifting(b, J, bcs, x0, scale=-1.0)
        b = set_bc(b, bcs, x0, scale=-1.0)
    return b
