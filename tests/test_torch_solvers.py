"""The general pipeline's Krylov, AMG and bound-constrained solvers, and
the grad composites, against the JAX package.

Mirrors ``test_sparse_solvers.py`` (``matrix_bcoo``, Newton-Krylov, the
lifting through CG, GMRES and BiCGStab, ``pc_type="mg"`` on the von Mises
cylinder, on a two-batch Jacobian, with GMRES on a nonsymmetric Jacobian
and with ``ksp_atol``), ``test_vi_newton.py`` (obstacle problems under
``vinewtonrsls``: the KKT conditions, projected Gauss-Seidel, bounds with
mg, no bounds = ``newtonls``) and ``test_grad_composites.py``.  Each case
runs the same inputs through both packages (the port on the CPU); Newton
lists are equal to the JAX package's, solutions agree within the stated
tolerance, and each test also holds the JAX test's own check on the port.
"""
import functools

import numpy as np
import pytest
import torch

import dolfinx_external_operator_tpu as fj

import dolfinx_external_operator_torch as pt

torch.set_num_threads(2)


class _OnCpu:
    """The port's namespace with its device-taking entry points on the CPU."""

    _PINNED = ("Function", "FEMExternalOperator", "assemble_scalar", "assemble_vector",
               "assemble_matrix", "create_form")

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        obj = getattr(self._mod, name)
        return functools.partial(obj, device="cpu") if name in self._PINNED else obj


PKGS = {"jax": fj, "port": _OnCpu(pt)}


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _both(build, *args, **kw):
    return {k: build(fem, *args, **kw) for k, fem in PKGS.items()}


# ----------------------------------------------------------------------
# test_sparse_solvers.py
# ----------------------------------------------------------------------

def _heat_problem(fem, n, ksp_type="preonly", atol=1e-10, pc="jacobi"):
    """The nonlinear heat problem of ``test_sparse_solvers.py`` with the
    conductivity 1 / (1 + T) and its derivative as the operator's
    callbacks (one arithmetic for JAX arrays and tensors)."""
    mesh = fem.create_unit_square(n, n)
    V = fem.functionspace(mesh, ("Lagrange", 1))
    T = fem.Function(V)
    T.interpolate(lambda X: 0.0 * X[0] + 0.01)
    Q = fem.functionspace(mesh, fem.quadrature_element(mesh.cell_name(), degree=2))
    dx = fem.Measure("dx", metadata={"quadrature_scheme": "default", "quadrature_degree": 2})
    k_ext = fem.FEMExternalOperator(T, function_space=Q)
    k_ext.external_function = lambda d: {(0,): lambda t: (1.0 / (1.0 + t)).reshape(-1),
                                         (1,): lambda t: (-1.0 / ((1.0 + t) * (1.0 + t))).reshape(-1)}[d]
    T_tilde, T_hat = fem.TestFunction(V), fem.TrialFunction(V)
    x = fem.SpatialCoordinate(mesh)
    F = fem.inner(k_ext * fem.grad(T), fem.grad(T_tilde)) * dx - (2.0 * x[0] + x[1]) * T_tilde * dx
    J = fem.derivative(F, T, T_hat)
    F_r, F_ops = fem.replace_external_operators(F)
    J_r, J_ops = fem.replace_external_operators(J)
    bdofs = fem.locate_dofs_geometrical(
        V, lambda X: np.isclose(X[0], 0) | np.isclose(X[0], 1) | np.isclose(X[1], 0) | np.isclose(X[1], 1))
    bc = fem.DirichletBC(bdofs, np.zeros(len(bdofs)))

    def callback():
        ops = fem.evaluate_operands(F_ops)
        fem.evaluate_external_operators(F_ops, ops)
        fem.evaluate_external_operators(J_ops, ops)

    prob = fem.solvers.NonlinearProblem(
        F_r, T, J_r, bcs=[bc],
        petsc_options={"snes_atol": atol, "snes_rtol": atol, "ksp_type": ksp_type, "pc_type": pc},
        external_callback=callback)
    return prob, T


def _heat_solve(fem, n, ksp, atol):
    prob, T = _heat_problem(fem, n, ksp, atol)
    its, conv = prob.solve()
    return its, conv, _np(T.data), prob.solver.ksp_iterations


def _heat_matrices(fem):
    prob, T = _heat_problem(fem, 7)
    prob.external_callback()
    J = prob.J
    A = _np(J.matrix())
    x = np.random.default_rng(3).normal(size=A.shape[0])
    Ab = J.matrix_bcoo()
    if isinstance(Ab, torch.Tensor):
        dense, prod = Ab.to_dense(), Ab @ torch.as_tensor(x)
    else:
        import jax.numpy as jnp

        dense, prod = Ab.todense(), Ab @ jnp.asarray(x)
    return A, x, _np(J.action(x)), _np(J.diagonal()), _np(dense), _np(prod), Ab


def test_action_bcoo_diagonal_match_dense():
    """The action, diagonal and the coalesced sparse matrix against the
    dense matrix (1e-12, 1e-13), and each against the JAX package's."""
    out = _both(_heat_matrices)
    A, x, act, diag, dense, prod, Ab = out["port"]
    assert Ab.is_sparse and Ab.is_coalesced() and Ab.dtype == torch.float64
    idx = _np(Ab.indices())
    assert np.all(np.diff(idx[0] * A.shape[1] + idx[1]) > 0)  # row-major, unique
    np.testing.assert_allclose(act, A @ x, rtol=0, atol=1e-12)
    np.testing.assert_allclose(diag, np.diag(A), rtol=0, atol=1e-13)
    np.testing.assert_allclose(dense, A, rtol=0, atol=1e-13)
    np.testing.assert_allclose(prod, A @ x, rtol=0, atol=1e-12)
    j = out["jax"]
    np.testing.assert_allclose(A, j[0], rtol=0, atol=1e-13)
    np.testing.assert_allclose(dense, j[4], rtol=0, atol=1e-13)
    np.testing.assert_allclose(prod, j[5], rtol=0, atol=1e-12)
    assert Ab._nnz() == j[6].nse


@pytest.fixture(scope="module")
def heat_runs():
    """The heat problem at 9x9 (direct, cg) and 7x7 (direct, gmres,
    bicgstab) through both packages."""
    runs = {}
    for n, ksp, atol in ((9, "preonly", 1e-10), (9, "cg", 1e-10), (7, "preonly", 1e-9),
                         (7, "gmres", 1e-9), (7, "bicgstab", 1e-9)):
        runs[n, ksp] = _both(_heat_solve, n, ksp, atol)
    return runs


def test_newton_krylov_matches_direct(heat_runs):
    """CG reproduces the direct path: the JAX package's Newton counts, the
    same count as direct, u within 1e-9 of direct and of the JAX CG's
    solution, inner counts within 2 of the JAX package's."""
    d, c = heat_runs[9, "preonly"]["port"], heat_runs[9, "cg"]["port"]
    cj = heat_runs[9, "cg"]["jax"]
    assert d[1] and c[1] and d[0] == c[0] == cj[0] == heat_runs[9, "preonly"]["jax"][0]
    assert c[3] > 0 and abs(c[3] - cj[3]) <= 2
    np.testing.assert_allclose(c[2], d[2], rtol=0, atol=1e-9)
    np.testing.assert_allclose(c[2], cj[2], rtol=0, atol=1e-10)


@pytest.mark.parametrize("ksp", ["gmres", "bicgstab"])
def test_newton_gmres_bicgstab(heat_runs, ksp):
    """GMRES and BiCGStab over the element-by-element operator: converged,
    the JAX package's Newton count, u within 1e-7 of the direct solve and
    within 1e-10 of the JAX package's solution with the same solver; both
    report 0 inner iterations, as in JAX."""
    its, conv, u, kits = heat_runs[7, ksp]["port"]
    j = heat_runs[7, ksp]["jax"]
    assert conv and its == j[0] and kits == 0 == j[3]
    np.testing.assert_allclose(u, heat_runs[7, "preonly"]["port"][2], rtol=0, atol=1e-7)
    np.testing.assert_allclose(u, j[2], rtol=0, atol=1e-10)


def _lifting(fem):
    mesh = fem.create_unit_square(8, 8)
    V = fem.functionspace(mesh, ("Lagrange", 1))
    T = fem.Function(V)
    T_tilde, T_hat = fem.TestFunction(V), fem.TrialFunction(V)
    dx = fem.Measure("dx", metadata={"quadrature_scheme": "default", "quadrature_degree": 2})
    F = fem.inner(fem.grad(T), fem.grad(T_tilde)) * dx
    J = fem.derivative(F, T, T_hat)
    left = fem.locate_dofs_geometrical(V, lambda X: np.isclose(X[0], 0))
    right = fem.locate_dofs_geometrical(V, lambda X: np.isclose(X[0], 1))
    bcs = [fem.DirichletBC(left, np.zeros(len(left))), fem.DirichletBC(right, np.ones(len(right)))]
    prob = fem.solvers.NonlinearProblem(F, T, J, bcs=bcs, petsc_options={"ksp_type": "cg"})
    its, conv = prob.solve()
    return its, conv, _np(T.data), fem.assembly._dof_coordinates(V)


def test_nonzero_bc_lifting_through_krylov():
    """Nonzero Dirichlet data through the matrix-free lifting with CG:
    u = x within 1e-8, the JAX package's Newton count and u within 1e-12."""
    out = _both(_lifting)
    its, conv, u, coords = out["port"]
    assert conv and its == out["jax"][0]
    np.testing.assert_allclose(u, coords[:, 0], rtol=0, atol=1e-8)
    np.testing.assert_allclose(u, out["jax"][2], rtol=0, atol=1e-12)


@pytest.mark.slow
def test_heat_300x300_general_path():
    """~90k dofs through the general pipeline with Newton-CG (the JAX
    package's slow test), the port on the CPU."""
    prob, T = _heat_problem(PKGS["port"], 300, "cg", atol=1e-8)
    its, conv = prob.solve()
    assert conv and its <= 8
    arr = _np(T.data)
    assert np.isfinite(arr).all() and arr.max() > 0.01


@pytest.fixture(scope="module")
def von_mises_runs():
    """The von Mises cylinder at lc=0.5 through both packages: 3
    increments direct and with cg+mg, 2 increments direct and with mg at
    ``ksp_rtol=0, ksp_atol=1e-11``."""
    from dolfinx_external_operator_tpu.models.von_mises import solve_von_mises as solve_j

    from dolfinx_external_operator_torch.models.von_mises import solve_von_mises as solve_t

    mg = {"ksp_type": "cg", "pc_type": "mg"}
    cases = {"direct3": (3, None), "mg3": (3, mg), "direct2": (2, None),
             "atol2": (2, dict(mg, ksp_rtol=0.0, ksp_atol=1e-11))}
    return {name: {"jax": solve_j(lc=0.5, num_increments=k, snes_opts=opts),
                   "port": solve_t(lc=0.5, num_increments=k, snes_opts=opts, device="cpu")}
            for name, (k, opts) in cases.items()}


def test_von_mises_general_path_mg_pc(von_mises_runs):
    """``ksp_type=cg, pc_type=mg`` reproduces the direct path: the JAX
    package's Newton lists for both, the probe within 1e-9 of direct and
    within 1e-10 of the JAX package's mg run."""
    d, m = von_mises_runs["direct3"], von_mises_runs["mg3"]
    assert d["port"]["iterations"] == d["jax"]["iterations"] == m["port"]["iterations"] \
        == m["jax"]["iterations"]
    assert sum(m["port"]["ksp_iterations"]) > 0
    du = np.abs(d["port"]["results"][:, 0] - m["port"]["results"][:, 0]).max()
    assert du < 1e-9, du
    assert np.abs(m["port"]["results"][:, 0] - m["jax"]["results"][:, 0]).max() < 1e-10


def test_mg_honors_ksp_atol(von_mises_runs):
    """``ksp_rtol=0`` with a loose ``ksp_atol`` terminates on atol: the
    direct path's Newton list (the JAX package's too), the probe within
    1e-8 of direct."""
    out, ref = von_mises_runs["atol2"], von_mises_runs["direct2"]
    assert out["port"]["iterations"] == ref["port"]["iterations"] == out["jax"]["iterations"]
    du = np.abs(out["port"]["results"][:, 0] - ref["port"]["results"][:, 0]).max()
    assert du < 1e-8, du


def _vector_problem(fem, ksp, pc, n=8, split=True, convect=False):
    """The vector problems of ``test_sparse_solvers.py``: with ``split``
    the Jacobian compiles to TWO cell batches over the same space (split
    measures of different degrees); with ``convect`` a convective term
    makes it nonsymmetric."""
    mesh = fem.create_unit_square(n, n)
    V = fem.functionspace(mesh, ("Lagrange", 1, (2,)))
    u = fem.Function(V)
    v = fem.TestFunction(V)
    uh = fem.TrialFunction(V)
    dx2 = fem.Measure("dx", metadata={"quadrature_degree": 2, "quadrature_scheme": "default"})
    dx4 = fem.Measure("dx", metadata={"quadrature_degree": 4, "quadrature_scheme": "default"})

    def e(w):
        return fem.symmetric(fem.grad(w))

    coef = 1.0 + fem.inner(u, u)
    body = fem.as_vector([0.2, -0.3])
    if convect:
        F = (fem.inner(coef * e(u), e(v)) * dx2
             + fem.inner(fem.dot(fem.grad(u), fem.as_vector([1.5, 0.7])), v) * dx2
             - fem.inner(body, v) * dx2)
    else:
        F = (fem.inner(coef * e(u), e(v)) * dx2 + 0.5 * fem.inner(u, v) * (dx4 if split else dx2)
             - fem.inner(body, v) * dx2)
    J = fem.expand_derivatives(fem.derivative(F, u, uh))
    bdofs = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0))
    bc = fem.dirichletbc(np.zeros(2), bdofs, V)
    prob = fem.solvers.NonlinearProblem(
        F, u, J=J, bcs=[bc],
        petsc_options={"ksp_type": ksp, "pc_type": pc, "snes_atol": 1e-10, "snes_rtol": 1e-10})
    return prob, u


def _vector_solve(fem, ksp, pc, **kw):
    prob, u = _vector_problem(fem, ksp, pc, **kw)
    its, conv = prob.solve()
    return its, conv, _np(u.data), prob


def test_mg_multi_batch_jacobian():
    """mg on a two-batch Jacobian: the hierarchy from the dominant batch,
    the exact operators over both; the direct path's and the JAX
    package's Newton counts, u within 1e-8 of direct and of the JAX mg
    run."""
    mg = _both(_vector_solve, "cg", "mg")
    d = _vector_solve(PKGS["port"], "preonly", "jacobi")
    its, conv, u, prob = mg["port"]
    assert len(prob.J.element_tensors()) == 2
    assert conv and its == d[0] == mg["jax"][0]
    assert np.abs(u - d[2]).max() < 1e-8
    assert np.abs(u - mg["jax"][2]).max() < 1e-8


def test_mg_gmres_nonsymmetric_jacobian():
    """gmres + mg on a nonsymmetric Jacobian (the cycle built on the
    symmetrized operator, GMRES on the true one): the direct path's and
    the JAX package's Newton counts, u within 1e-8 of direct and of the
    JAX run."""
    mg = _both(_vector_solve, "gmres", "mg", n=12, convect=True)
    d = _vector_solve(PKGS["port"], "preonly", "jacobi", n=12, convect=True)
    its, conv, u, prob = mg["port"]
    assert conv
    A = _np(prob.J.matrix())
    assert np.abs(A - A.T).max() > 1e-6 * np.abs(A).max()
    assert its == d[0] == mg["jax"][0]
    assert np.abs(u - d[2]).max() < 1e-8
    assert np.abs(u - mg["jax"][2]).max() < 1e-8


# ----------------------------------------------------------------------
# test_vi_newton.py
# ----------------------------------------------------------------------

def _membrane_problem(fem, n=12, f_mag=-10.0, nonlinear=False, **opts):
    """F(u; v) = (1 + c u^2) grad(u).grad(v) - f v on the unit square, u =
    0 on the boundary."""
    mesh = fem.create_unit_square(n, n)
    V = fem.functionspace(mesh, ("Lagrange", 1))
    u = fem.Function(V)
    v, du = fem.TestFunction(V), fem.TrialFunction(V)
    dx = fem.Measure("dx", metadata={"quadrature_scheme": "default", "quadrature_degree": 3})
    c = 1.0 if nonlinear else 0.0
    F = fem.inner((1.0 + c * u * u) * fem.grad(u), fem.grad(v)) * dx - f_mag * v * dx
    J = fem.derivative(F, u, du)
    bdofs = fem.locate_dofs_geometrical(
        V, lambda X: np.isclose(X[0], 0) | np.isclose(X[0], 1) | np.isclose(X[1], 0) | np.isclose(X[1], 1))
    bc = fem.DirichletBC(bdofs, np.zeros(len(bdofs)))
    prob = fem.solvers.NonlinearProblem(
        F, u, J, bcs=[bc], petsc_options={"snes_atol": 1e-10, "snes_rtol": 1e-10, **opts})
    return prob, u, bdofs


def _kkt_check(prob, u, bdofs, lb, ub, tol=5e-9):
    """Feasibility, complementarity and reduced stationarity of the iterate
    (``test_vi_newton.py``'s oracle)."""
    x = _np(u.data)
    r = _np(prob.F.vector())
    free = np.ones(len(x), bool)
    free[bdofs] = False
    assert x.min() >= lb - 1e-12 and x.max() <= ub + 1e-12
    on_lb = free & (x <= lb + 1e-12)
    on_ub = free & (x >= ub - 1e-12)
    inactive = free & ~on_lb & ~on_ub
    assert np.abs(r[inactive]).max() < tol
    if on_lb.any():
        assert r[on_lb].min() > -tol
    if on_ub.any():
        assert r[on_ub].max() < tol
    return on_lb, on_ub


def _obstacle(fem, lb, ub, n=12, **kw):
    prob, u, bdofs = _membrane_problem(fem, n=n, snes_type="vinewtonrsls", **kw)
    prob.solver.set_variable_bounds(lb, ub)
    its, conv = prob.solver.solve(prob)
    return its, conv, prob, u, bdofs


OBSTACLES = {
    "lower_preonly": (-0.05, np.inf, {}),
    "lower_cg": (-0.05, np.inf, {"ksp_type": "cg"}),
    "upper": (-np.inf, 0.05, {"f_mag": 10.0}),
    "nonlinear": (-0.04, np.inf, {"nonlinear": True}),
}


@pytest.mark.parametrize("case", list(OBSTACLES))
def test_obstacle_kkt(case):
    """Obstacle problems under ``vinewtonrsls`` (lower with the dense and
    the CG solver, upper, nonlinear diffusion): converged, the KKT
    conditions within 5e-9, a contact set on the right side only, the
    JAX package's Newton count and u within 1e-10 of its."""
    lb, ub, kw = OBSTACLES[case]
    out = _both(_obstacle, lb, ub, **kw)
    its, conv, prob, u, bdofs = out["port"]
    assert conv
    on_lb, on_ub = _kkt_check(prob, u, bdofs, lb, ub)
    assert (on_lb.sum() > 0) == (lb > -np.inf) and (on_ub.sum() > 0) == (ub < np.inf)
    assert its == out["jax"][0]
    assert np.abs(_np(u.data) - _np(out["jax"][3].data)).max() < 1e-10


def test_obstacle_matches_projected_gauss_seidel():
    """Projected Gauss-Seidel on the assembled system converges to the
    unique solution of the (convex, linear) obstacle problem; the port's
    solution within 1e-7 of it and within 1e-10 of the JAX package's."""
    lb = -0.05
    out = _both(_obstacle, lb, np.inf, n=8)
    its, conv, prob, u, bdofs = out["port"]
    assert conv and its == out["jax"][0]
    A = _np(prob.J.matrix())
    u_save = u.data
    u._data = torch.zeros_like(u_save)
    b = -_np(prob.F.vector())
    u._data = u_save
    mask = np.zeros(A.shape[0], bool)
    mask[bdofs] = True
    keep = ~mask
    A = A * keep[:, None] * keep[None, :] + np.diag(mask.astype(float))
    b = np.where(mask, 0.0, b)
    x = np.zeros(A.shape[0])
    for _ in range(4000):
        for i in range(len(x)):
            x[i] = max((b[i] - A[i] @ x + A[i, i] * x[i]) / A[i, i], lb)
        x[mask] = 0.0
    assert np.abs(_np(u.data) - x).max() < 1e-7
    assert np.abs(_np(u.data) - _np(out["jax"][3].data)).max() < 1e-10


def _newton_pair(fem):
    out = []
    for snes in ("newtonls", "vinewtonrsls"):
        prob, u, _ = _membrane_problem(fem, nonlinear=True, snes_type=snes)
        its, conv = prob.solver.solve(prob)
        out.append((its, conv, _np(u.data)))
    return out


def test_no_bounds_identical_to_newtonls():
    """``vinewtonrsls`` without bounds is ``newtonls`` bit for bit, with the
    JAX package's Newton count and u within 1e-12 of its."""
    out = _both(_newton_pair)
    (its_a, conv_a, u_a), (its_b, conv_b, u_b) = out["port"]
    assert conv_a and conv_b and its_a == its_b == out["jax"][0][0]
    np.testing.assert_array_equal(u_a, u_b)
    np.testing.assert_allclose(u_a, out["jax"][0][2], rtol=0, atol=1e-12)


def test_bad_snes_type_raises():
    with pytest.raises(ValueError, match="snes_type"):
        pt.solvers.NewtonSolver(snes_type="vinewtonssls")


def _elastic_block(fem, n=10, lb=-0.04, **opts):
    """A 2D linear-elastic block (bs=2, the mg case) under a body force,
    clamped on the bottom edge, on a displacement floor ``lb``."""
    mesh = fem.create_unit_square(n, n)
    V = fem.functionspace(mesh, ("Lagrange", 1, (2,)))
    u = fem.Function(V)
    v, du = fem.TestFunction(V), fem.TrialFunction(V)
    dx = fem.Measure("dx", metadata={"quadrature_scheme": "default", "quadrature_degree": 2})

    def e(w):
        return fem.symmetric(fem.grad(w))

    body = fem.as_vector([0.0, -1.0])
    F = (2.0 * fem.inner(e(u), e(v)) + 0.5 * fem.tr(e(u)) * fem.tr(e(v)) - fem.inner(body, v)) * dx
    J = fem.derivative(F, u, du)
    bdofs_s = fem.locate_dofs_geometrical(V, lambda X: np.isclose(X[1], 0))
    bdofs = np.concatenate([bdofs_s * 2, bdofs_s * 2 + 1])
    bc = fem.DirichletBC(bdofs, np.zeros(len(bdofs)))
    prob = fem.solvers.NonlinearProblem(
        F, u, J, bcs=[bc], petsc_options={"snes_atol": 1e-10, "snes_rtol": 1e-10,
                                          "snes_type": "vinewtonrsls", **opts})
    prob.solver.set_variable_bounds(lb, np.inf)
    its, conv = prob.solver.solve(prob)
    return its, conv, _np(u.data), bdofs


def test_mg_with_bounds():
    """``vinewtonrsls`` + mg (the active set eliminated per call on a
    hierarchy frozen on the Dirichlet mask) against the Jacobi-CG VI
    path: the same Newton count as it and as the JAX mg run, u within
    1e-8 of both, and the floor binds off the clamped edge."""
    lb = -0.04
    its_j, conv_j, x, bdofs = _elastic_block(PKGS["port"], ksp_type="cg")
    assert conv_j
    free = np.ones(len(x), bool)
    free[bdofs] = False
    assert (x[free] <= lb + 1e-12).any(), "no active set developed"
    out = _both(_elastic_block, ksp_type="cg", pc_type="mg")
    its_m, conv_m, u_m, _ = out["port"]
    assert conv_m and its_m == its_j == out["jax"][0]
    np.testing.assert_allclose(u_m, x, rtol=0, atol=1e-8)
    np.testing.assert_allclose(u_m, out["jax"][2], rtol=0, atol=1e-8)


# ----------------------------------------------------------------------
# test_grad_composites.py
# ----------------------------------------------------------------------

def _grad_setup(fem):
    mesh = fem.create_unit_square(4, 4)
    V = fem.functionspace(mesh, ("Lagrange", 2))
    W = fem.functionspace(mesh, ("Lagrange", 2, (2,)))
    u = fem.Function(V, name="u")
    w = fem.Function(W, name="w")
    u.interpolate(lambda x: 1.0 + x[0] ** 2 + 0.5 * x[1])
    w.interpolate(lambda x: (x[0] * x[1], x[0] - x[1] ** 2))
    v = fem.TestFunction(V)
    dx = fem.Measure("dx", metadata={"quadrature_degree": 6, "quadrature_scheme": "default"})
    return u, w, v, dx


def _composite(fem, case):
    """Composite ``grad`` forms and their hand-expanded twins, assembled."""
    u, w, v, dx = _grad_setup(fem)
    g, inner = fem.grad, fem.inner
    if case == "product":
        pairs = [(g(u * u), 2.0 * u * g(u))]
    elif case == "division":
        pairs = [(g(1.0 / u), -1.0 / (u * u) * g(u))]
    elif case == "power":
        pairs = [(g(u**3), 3.0 * u * u * g(u))]
    elif case == "inner_and_dot":
        # grad(w.w) = 2 grad(w)^T w with grad(w)_ij = dw_i/dx_j
        pairs = [(g(inner(w, w)), 2.0 * fem.dot(fem.transpose(g(w)), w))]
    elif case == "unary_chain":
        pairs = [(g(fem.exp(u)), fem.exp(u) * g(u)), (g(fem.sqrt(u)), 0.5 / fem.sqrt(u) * g(u))]
    else:
        u2 = fem.Function(u.function_space, name="u2")
        u2.interpolate(lambda x: x[0] - 2.0 * x[1])
        pairs = [(g(u * u2), u2 * g(u) + u * g(u2))]
    return [[_np(fem.assemble_vector(inner(a, g(v)) * dx)) for a in pair] for pair in pairs]


@pytest.mark.parametrize("case", ["product", "division", "power", "inner_and_dot", "unary_chain",
                                  "product_of_functions"])
def test_grad_composite_matches_twin_and_jax(case):
    """Each composite form against its twin within 1e-12, and against the
    JAX package's composite within 1e-12."""
    out = _both(_composite, case)
    for (b, twin), (b_j, _) in zip(out["port"], out["jax"]):
        np.testing.assert_allclose(b, twin, rtol=0, atol=1e-12)
        np.testing.assert_allclose(b, b_j, rtol=0, atol=1e-12)
