"""The port's external-operator pipeline and Newton solver against the JAX
package's.

``FEMExternalOperator`` construction and differentiation bookkeeping
(``test_construction.py``, ``test_foundations.py``), operand evaluation
(``test_operands_evaluation.py``), nested and multi-action operators
(``test_nested_operators.py``, ``test_multiaction.py``), the nonlinear heat
example in its three parts (``test_heat_external_operator.py``) and the
``petsc`` shim (``test_petsc_shim.py``).  Each case is built through both
packages from the same inputs; callbacks are written once for ``numpy``
(JAX arrays in) and ``torch`` (tensors in, tensors out).  Arrays agree
within 1e-12 of their largest entry (f32: 50 eps); Newton lists are equal.
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

    _PINNED = ("Function", "Expression", "FEMExternalOperator", "assemble_scalar",
               "assemble_vector", "assemble_matrix", "create_form")

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        obj = getattr(self._mod, name)
        return functools.partial(obj, device="cpu") if name in self._PINNED else obj


PKGS = {"jax": (fj, np), "port": (_OnCpu(pt), torch)}


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(port, ref, tol=1e-12):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-300)
    err = float(np.abs(port - ref).max(initial=0.0)) / scale
    assert err <= tol, err
    return err


def _both(build, *args):
    return {k: build(fem, xp, *args) for k, (fem, xp) in PKGS.items()}


def _unit(fem, n=4, deg=1):
    mesh = fem.create_unit_square(n, n)
    V = fem.functionspace(mesh, ("Lagrange", deg))
    u = fem.Function(V)
    u.interpolate(lambda x: x[0])
    return mesh, V, u


# ----------------------------------------------------------------------
# Construction and differentiation bookkeeping
# ----------------------------------------------------------------------

def _shapes(fem, xp, op_shape, out_shape):
    mesh, V, u = _unit(fem)
    Q = fem.functionspace(mesh, fem.quadrature_element(mesh.cell_name(), 2, value_shape=out_shape))
    operand = {(): u, (2,): fem.grad(u), (2, 2): fem.outer(fem.grad(u), fem.grad(u))}[op_shape]
    N = fem.FEMExternalOperator(operand, function_space=Q)
    dN = N._derivative_node(0)
    d2N = dN._derivative_node(0)
    return N.shape, dN.shape, d2N.shape, dN.ref_coefficient.function_space.num_dofs, str(d2N.name)


@pytest.mark.parametrize("op_shape", [(), (2,), (2, 2)])
@pytest.mark.parametrize("out_shape", [(), (2,), (2, 2)])
def test_derivative_shape_law(op_shape, out_shape):
    """shape(dN/do) == shape(N) + shape(o), for the node and its
    coefficient, as in the JAX package."""
    out = _both(_shapes, op_shape, out_shape)
    assert out["port"] == out["jax"]
    assert out["port"][1] == tuple(out_shape) + tuple(op_shape)


def _replacements(fem, xp):
    mesh, V, u = _unit(fem)
    dx = fem.Measure("dx", metadata={"quadrature_degree": 2})
    Q = fem.functionspace(mesh, fem.quadrature_element(mesh.cell_name(), 2))
    v = fem.TestFunction(V)
    N1 = fem.FEMExternalOperator(u, function_space=Q)
    N2 = fem.FEMExternalOperator(u, fem.grad(u), function_space=Q)
    F, F2, F3 = N1 * v * dx, N1 * v * dx + N2 * v * dx, N1 * N2 * v * dx
    J = fem.derivative(F, u, fem.TrialFunction(V))
    J2 = fem.derivative(F2, u, fem.TrialFunction(V))
    out = [[op.derivatives for op in fem.replace_external_operators(f)[1]]
           for f in (F, F2, F3, J, J2, N1 * v * dx + N1 * u * v * dx)]
    ops1 = fem.replace_external_operators(fem.derivative(F, u, fem.TrialFunction(V)))[1]
    ops2 = fem.replace_external_operators(fem.derivative(F, u, fem.TrialFunction(V)))[1]
    reuse = ops1[0] is ops2[0] and ops1[0].ref_coefficient is ops2[0].ref_coefficient
    uniq = len(fem.unique_external_operators(
        [N1, fem.FEMExternalOperator(u, function_space=Q), N1]))
    return out, reuse, uniq


def test_replacement_bookkeeping_matches_jax():
    """Operators found per form, the chain rule's derivative nodes, reuse
    of derivative coefficients, ``unique_external_operators``."""
    out = _both(_replacements)
    assert out["port"] == out["jax"]
    assert out["port"][0][4] == [(1,), (1, 0), (0, 1)] and out["port"][1:] == (True, 1)


def test_empty_pipeline_and_mixed_operand():
    fem = PKGS["port"][0]
    mesh, V, u = _unit(fem)
    v = fem.TestFunction(V)
    dx = fem.Measure("dx", metadata={"quadrature_degree": 2})
    F = fem.inner(fem.grad(u), fem.grad(v)) * dx
    F_r, ops = fem.replace_external_operators(F)
    assert ops == [] and fem.evaluate_operands([]) == {} and fem.evaluate_external_operators([], {}) == []
    assert torch.equal(fem.assemble_vector(F_r), fem.assemble_vector(F))
    W = fem.functionspace(mesh, fem.mixed_element([fem.element("Lagrange", "triangle", 1)] * 2))
    Q = fem.functionspace(mesh, fem.quadrature_element(mesh.cell_name(), 2))
    with pytest.raises(TypeError):
        fem.FEMExternalOperator(fem.Function(W), function_space=Q)


# ----------------------------------------------------------------------
# Operands (test_operands_evaluation.py)
# ----------------------------------------------------------------------

def _operands(fem, xp, qdeg):
    mesh = fem.create_unit_square(6, 6)
    V = fem.functionspace(mesh, ("Lagrange", 1, (2,)))
    u = fem.Function(V)
    u.interpolate(lambda x: (x[0] ** 2 + x[1], 0.5 * x[0] * x[1]))
    F_def = fem.Identity(2) + fem.grad(u)
    I1 = fem.tr(fem.dot(fem.transpose(F_def), F_def))
    const_op = fem.Constant(3.5) * (u[0] - u[0] + 1.0)
    Q = fem.functionspace(mesh, fem.quadrature_element(mesh.cell_name(), degree=qdeg))
    N = fem.FEMExternalOperator(I1, const_op, function_space=Q)
    evaluated = fem.evaluate_operands([N])
    qpts, _ = fem.make_quadrature(mesh.cell_name(), qdeg)
    direct = fem.Expression(I1, qpts).eval(mesh)
    Q2 = fem.functionspace(mesh, fem.quadrature_element(mesh.cell_name(), degree=2))
    N1 = fem.FEMExternalOperator(u[0], function_space=Q2)
    N2 = fem.FEMExternalOperator(N1.ufl_operands[0], function_space=Q2)
    return evaluated[I1], evaluated[const_op], direct, len(fem.evaluate_operands([N1, N2]))


@pytest.mark.parametrize("qdeg", [1, 2, 4])
def test_operands_match_expression_and_jax(qdeg):
    out = _both(_operands, qdeg)
    I1, const, direct, n_unique = out["port"]
    _close(I1, direct)
    _close(I1, out["jax"][0])
    assert torch.allclose(const, torch.full_like(const, 3.5), atol=1e-14, rtol=0)
    assert n_unique == 1 == out["jax"][3]


# ----------------------------------------------------------------------
# Nested and multi-action operators
# ----------------------------------------------------------------------

def _u_NN(mod, gdim, x, theta):
    if gdim == 1:
        return mod.sin(theta[0] * x[0])
    return mod.sin(theta[0] * x[0]) * mod.sin(theta[1] * x[1])


def _nested(fem, xp, cell, n, q_deg):
    if cell == "interval":
        mesh = fem.create_unit_interval(n)
    elif cell in ("triangle", "quadrilateral"):
        mesh = fem.create_unit_square(n, n, cell)
    else:
        mesh = fem.create_unit_cube(n, n, n, cell)
    gdim = mesh.gdim
    R = fem.functionspace(mesh, ("DG", 1, (4,)))
    theta = fem.Function(R)
    theta.x.array[:] = np.full(R.num_dofs, 0.32)
    x = fem.SpatialCoordinate(mesh)
    Q = fem.functionspace(mesh, fem.quadrature_element(mesh.cell_name(), degree=q_deg))

    def u_NN_impl(x_, theta_):
        x_vec = xp.asarray(x_).reshape(-1, gdim)
        theta_vec = xp.asarray(theta_).reshape(-1, 4)
        return _u_NN(xp, gdim, x_vec.T, theta_vec.T).reshape(-1)

    N = fem.FEMExternalOperator(x, theta, function_space=Q, name="exop",
                                external_function=lambda d: {(0, 0): u_NN_impl}[d])
    P = fem.FEMExternalOperator(
        N, function_space=Q, name="second_op",
        external_function=lambda d: {(0,): lambda nn: xp.sin(xp.asarray(nn)).reshape(-1)}[d])
    Z = fem.FEMExternalOperator(
        N, P, function_space=Q, name="third_op",
        external_function=lambda d: {(0, 0): lambda nn, pp: (xp.cos(xp.asarray(nn))
                                                             + xp.asarray(pp) ** 2).reshape(-1)}[d])
    V = fem.functionspace(mesh, ("Lagrange", 1))
    phi, v = fem.TrialFunction(V), fem.TestFunction(V)
    dx = fem.Measure("dx", domain=mesh, metadata={"quadrature_degree": q_deg})

    def F_of(Pe, Ne, Ze, phi_h):
        return fem.action(fem.inner(fem.grad(phi), fem.grad(v)) * dx - (Ze**2 * Pe * Ne) * v * dx, phi_h)

    phih = fem.Function(V, name="phih")
    phih.interpolate(lambda X: np.sin(np.pi * X[0]))
    F_r, ops = fem.replace_external_operators(F_of(P, N, Z, phih))
    names = [op.name for op in ops]
    fem.evaluate_external_operators(ops, fem.evaluate_operands(ops))
    N_sym = _u_NN(fem.sym, gdim, x, theta)
    P_sym = fem.sym.sin(N_sym)
    twin = fem.assemble_vector(F_of(P_sym, N_sym, fem.sym.cos(N_sym) + P_sym**2, phih))
    return names, fem.assemble_vector(F_r), twin


@pytest.mark.parametrize("cell,n,q_deg", [("interval", 8, 4), ("triangle", 4, 1), ("triangle", 4, 8),
                                          ("quadrilateral", 4, 4), ("tetrahedron", 2, 4),
                                          ("hexahedron", 2, 1)])
def test_nested_operators_match_jax(cell, n, q_deg):
    out = _both(_nested, cell, n, q_deg)
    names, vec, twin = out["port"]
    assert names == out["jax"][0]
    assert names.index("exop") < names.index("second_op") < names.index("third_op")
    _close(vec, out["jax"][1])
    _close(vec, twin, 1e-12)


def _multiaction(fem, xp, q_deg):
    mesh = fem.create_unit_square(4, 4)
    T = fem.functionspace(mesh, ("DG", 0, (3,)))
    theta = fem.Function(T, name="theta")
    theta.interpolate(lambda x: (0.1 * x[0], 0.2 * x[1] + 0.3 * x[1], x[0] * x[1]))

    def split(th, x):
        return xp.asarray(th).reshape(-1, 3).T, xp.asarray(x).reshape(-1, 2).T

    def f(th, x):
        th, x = split(th, x)
        return (xp.sin(np.pi * th[0] * x[0]) * xp.cos(np.pi * th[2] * x[1]) + 3.11 * th[1]).reshape(-1)

    def df_dtheta(th, x):
        th, x = split(th, x)
        d0 = np.pi * x[0] * xp.cos(np.pi * th[0] * x[0]) * xp.cos(np.pi * th[2] * x[1])
        d2 = -np.pi * x[1] * xp.sin(np.pi * th[0] * x[0]) * xp.sin(np.pi * th[2] * x[1])
        return xp.stack([d0, xp.ones_like(d0) * 3.11, d2]).T.reshape(-1)

    def df_dx(th, x):
        th, x = split(th, x)
        d0 = np.pi * th[0] * xp.cos(np.pi * th[0] * x[0]) * xp.cos(np.pi * th[2] * x[1])
        d1 = -np.pi * th[2] * xp.sin(np.pi * th[0] * x[0]) * xp.sin(np.pi * th[2] * x[1])
        return xp.stack([d0, d1]).T.reshape(-1)

    Q = fem.functionspace(mesh, fem.quadrature_element(mesh.cell_name(), degree=q_deg))
    x = fem.SpatialCoordinate(mesh)
    N = fem.FEMExternalOperator(theta, x, function_space=Q,
                                external_function=lambda d: {(0, 0): f, (1, 0): df_dtheta, (0, 1): df_dx}[d])
    V = fem.functionspace(mesh, ("Lagrange", 1))
    u, v = fem.TrialFunction(V), fem.TestFunction(V)
    dx = fem.Measure("dx", metadata={"quadrature_degree": q_deg})
    F = fem.inner(u, v) * dx - fem.inner(N, v) * dx
    uh = fem.Function(V, name="uh")
    uh.interpolate(lambda X: np.sin(np.pi * X[0]))
    lmbda = fem.Function(V, name="lmbda")
    lmbda.interpolate(lambda X: np.cos(X[1]))
    dFdtheta = fem.action(fem.adjoint(fem.derivative(fem.action(F, uh), theta)), lmbda)
    F_r, ops = fem.replace_external_operators(dFdtheta)
    fem.evaluate_external_operators(ops, fem.evaluate_operands(ops))
    return [op.derivatives for op in ops], fem.assemble_vector(F_r)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("q_deg", [1, 3])
def test_multiaction_matches_jax(q_deg, dtype):
    """The adjoint-gradient path in f64 and, inside ``scalar_type_context``,
    f32 (50 eps, as ``test_multiaction.py``)."""
    out = {}
    with fj.scalar_type_context(getattr(np, dtype)):
        out["jax"] = _multiaction(fj, np, q_deg)
    with pt.scalar_type_context(getattr(torch, dtype)):
        assert pt.default_scalar_type() == getattr(torch, dtype)
        out["port"] = _multiaction(PKGS["port"][0], torch, q_deg)
    assert pt.default_scalar_type() == torch.float64
    assert out["port"][0] == out["jax"][0] == [(1, 0)]
    assert out["port"][1].dtype == getattr(torch, dtype)
    _close(out["port"][1], out["jax"][1], 1e-12 if dtype == "float64" else 50 * np.finfo(np.float32).eps)


# ----------------------------------------------------------------------
# The nonlinear heat example (test_heat_external_operator.py)
# ----------------------------------------------------------------------

def _heat_setup(fem, n=6):
    mesh = fem.create_unit_square(n, n)
    V = fem.functionspace(mesh, ("Lagrange", 1))
    T = fem.Function(V)
    T.interpolate(lambda x: x[0] ** 2 + x[1])
    Q = fem.functionspace(mesh, fem.quadrature_element(mesh.cell_name(), degree=2))
    dx = fem.Measure("dx", metadata={"quadrature_scheme": "default", "quadrature_degree": 2})
    return mesh, V, T, Q, dx


def _assemble_pair(fem, F, J):
    F_r, F_ops = fem.replace_external_operators(F)
    J_r, J_ops = fem.replace_external_operators(J)
    operands = fem.evaluate_operands(F_ops)
    fem.evaluate_external_operators(F_ops, operands)
    fem.evaluate_external_operators(J_ops, operands)
    return fem.assemble_vector(F_r), fem.assemble_matrix(J_r), J_ops


def _heat1(fem, xp):
    mesh, V, T, Q, dx = _heat_setup(fem)
    k = fem.FEMExternalOperator(T, function_space=Q)

    def k_impl(t):
        return (1.0 / (1.0 + xp.asarray(t))).reshape(-1)

    k.external_function = lambda d: {(0,): k_impl, (1,): lambda t: -k_impl(t) ** 2}[d]
    T_tilde, T_hat = fem.TestFunction(V), fem.TrialFunction(V)
    F = fem.inner(-1.0 * k * fem.grad(T), fem.grad(T_tilde)) * dx
    b, A, J_ops = _assemble_pair(fem, F, fem.expand_derivatives(fem.derivative(F, T, T_hat)))
    k_ex = 1.0 / (1.0 + T)
    F_ex = fem.inner(-1.0 * k_ex * fem.grad(T), fem.grad(T_tilde)) * dx
    return b, A, fem.assemble_vector(F_ex), fem.assemble_matrix(fem.derivative(F_ex, T, T_hat))


def _heat2(fem, xp):
    mesh, V, T, _, dx = _heat_setup(fem)
    Q = fem.functionspace(mesh, fem.quadrature_element(mesh.cell_name(), degree=2, value_shape=(2,)))
    q_ = fem.FEMExternalOperator(T, fem.grad(T), function_space=Q)

    def k(t):
        return 1.0 / (1.0 + t)

    def q_impl(t, s):
        t, s = xp.asarray(t), xp.asarray(s)
        return (-k(t)[:, :, None] * s.reshape(t.shape[0], -1, 2)).reshape(-1)

    def dqdT_impl(t, s):
        t, s = xp.asarray(t), xp.asarray(s)
        return ((k(t) ** 2)[:, :, None] * s.reshape(t.shape[0], -1, 2)).reshape(-1)

    def dqds_impl(t, s):
        t = xp.asarray(t)
        eye = xp.asarray(np.eye(2))
        return (-k(t)[:, :, None, None] * eye[None, None, :, :]).reshape(-1)

    q_.external_function = lambda d: {(0, 0): q_impl, (1, 0): dqdT_impl, (0, 1): dqds_impl}[d]
    T_tilde, T_hat = fem.TestFunction(V), fem.TrialFunction(V)
    F = fem.inner(q_, fem.grad(T_tilde)) * dx
    b, A, J_ops = _assemble_pair(fem, F, fem.expand_derivatives(fem.derivative(F, T, T_hat)))
    k_ex = 1.0 / (1.0 + T)
    F_ex = fem.inner(-1.0 * k_ex * fem.grad(T), fem.grad(T_tilde)) * dx
    shapes = {op.derivatives: op.shape for op in J_ops}
    return b, A, fem.assemble_vector(F_ex), fem.assemble_matrix(fem.derivative(F_ex, T, T_hat)), shapes


@pytest.mark.parametrize("part", [_heat1, _heat2], ids=["part1", "part2"])
def test_heat_residual_jacobian_match_jax(part):
    out = _both(part)
    port, ref = out["port"], out["jax"]
    for p, j in zip(port[:4], ref[:4]):
        _close(p, j)
    _close(port[0], port[2])  # the explicit twin
    _close(port[1], port[3])
    if part is _heat2:  # the shape law: dq/dsigma is (2,) + (2,)
        assert port[4] == ref[4] and port[4][(0, 1)] == (2, 2) and port[4][(1, 0)] == (2,)


def _heat3(fem, xp):
    """Part 3: the kernel and its derivative by forward-mode AD (JAX:
    ``vmap(jacfwd)``; the port: ``torch.func``), a full Newton solve."""
    mesh, V, T, Q, dx = _heat_setup(fem, n=8)
    k_ext = fem.FEMExternalOperator(T, function_space=Q)

    def k_pt(t):
        return 1.0 / (1.0 + t)

    if fem is fj:
        import jax

        k_vec = jax.jit(jax.vmap(jax.vmap(k_pt)))
        dk_vec = jax.jit(jax.vmap(jax.vmap(jax.jacfwd(k_pt))))
    else:
        k_vec = torch.func.vmap(torch.func.vmap(k_pt))
        dk_vec = torch.func.vmap(torch.func.vmap(torch.func.jacfwd(k_pt)))
    calls = []

    def k_impl(t):
        calls.append(type(t))
        return k_vec(t).reshape(-1)

    k_ext.external_function = lambda d: {(0,): k_impl, (1,): lambda t: dk_vec(t).reshape(-1)}[d]
    T_tilde, T_hat = fem.TestFunction(V), fem.TrialFunction(V)
    x = fem.SpatialCoordinate(mesh)
    F = fem.inner(k_ext * fem.grad(T), fem.grad(T_tilde)) * dx - (2.0 * x[0] + x[1]) * T_tilde * dx
    J = fem.derivative(F, T, T_hat)
    F_r, F_ops = fem.replace_external_operators(F)
    J_r, J_ops = fem.replace_external_operators(J)
    bdofs = fem.locate_dofs_geometrical(
        V, lambda X: np.isclose(X[0], 0) | np.isclose(X[0], 1) | np.isclose(X[1], 0) | np.isclose(X[1], 1))
    bc = fem.DirichletBC(bdofs, np.zeros(len(bdofs)))
    T.interpolate(lambda X: 0.0 * X[0] + 0.01)

    def callback():
        ops = fem.evaluate_operands(F_ops)
        fem.evaluate_external_operators(F_ops, ops)
        fem.evaluate_external_operators(J_ops, ops)

    prob = fem.solvers.NonlinearProblem(F_r, T, J_r, bcs=[bc], external_callback=callback,
                                        petsc_options={"snes_atol": 1e-10, "snes_rtol": 1e-10})
    its, conv = prob.solve()
    return its, conv, _np(T.data).copy(), prob.solver.history, calls


def test_heat_full_solve_with_torch_callback_matches_jax():
    out = _both(_heat3)
    its, conv, T, hist, calls = out["port"]
    assert conv and its == out["jax"][0] and len(hist) == its + 1
    assert np.abs(T - out["jax"][2]).max() < 1e-10
    assert calls and set(calls) == {torch.Tensor}


# ----------------------------------------------------------------------
# Solvers, the petsc shim, the P4 operand
# ----------------------------------------------------------------------

def _shim(fem, xp):
    mesh, V, T, Q, dx = _heat_setup(fem)
    T.interpolate(lambda x: 0.5 + x[0] * x[1])
    k = fem.FEMExternalOperator(T, function_space=Q)
    k.external_function = lambda d: {(0,): lambda t: (1.0 / (1.0 + xp.asarray(t))).reshape(-1),
                                     (1,): lambda t: (-1.0 / (1.0 + xp.asarray(t)) ** 2).reshape(-1)}[d]
    T_tilde, T_hat = fem.TestFunction(V), fem.TrialFunction(V)
    F = fem.inner(k * fem.grad(T), fem.grad(T_tilde)) * dx
    F_r, F_ops = fem.replace_external_operators(F)
    J_r, J_ops = fem.replace_external_operators(fem.expand_derivatives(fem.derivative(F, T, T_hat)))
    left = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[0], 0.0))
    bc = fem.DirichletBC(left, np.full(left.size, 0.3))
    calls = []

    def update():
        calls.append(1)
        operands = fem.evaluate_operands(F_ops)
        fem.evaluate_external_operators(F_ops, operands)
        fem.evaluate_external_operators(J_ops, operands)

    b = fem.petsc.assemble_residual_with_callback(T, F_r, J_r, [bc], update, ())
    problem = fem.petsc.NonlinearProblem(F_r, T, J_r, bcs=[bc])
    installed = fem.petsc.assemble_residual_with_callback(T, F_r, J_r, [bc], update, (), solver=problem)
    return b, len(calls), installed is problem and problem.external_callback is update, bc


def test_petsc_shim_matches_jax():
    out = _both(_shim)
    b, n_calls, installed, bc = out["port"]
    _close(b, out["jax"][0])
    assert n_calls == 1 and installed
    assert np.allclose(_np(b)[bc.dofs], -(bc.values - 0.5), atol=1e-14)


def _poisson(fem, xp, ksp):
    mesh = fem.create_unit_square(6, 6)
    V = fem.functionspace(mesh, ("Lagrange", 2))
    dx = fem.Measure("dx", metadata={"quadrature_degree": 5})
    v, du = fem.TestFunction(V), fem.TrialFunction(V)
    uh = fem.Function(V)
    F = fem.inner(fem.grad(uh), fem.grad(v)) * dx + uh * uh * uh * v * dx - fem.Constant(-4.0) * v * dx
    J = fem.derivative(F, uh, du)
    bdofs = fem.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[0], 0) | np.isclose(x[0], 1) | np.isclose(x[1], 0) | np.isclose(x[1], 1))
    coords = (fj.assembly if fem is fj else pt.assembly)._dof_coordinates(V)
    bc = fem.DirichletBC(bdofs, coords[bdofs, 0] ** 2 + coords[bdofs, 1] ** 2)
    prob = fem.solvers.NonlinearProblem(F, uh, J, bcs=[bc], petsc_options={
        "snes_atol": 1e-11, "snes_rtol": 1e-11, "ksp_type": ksp})
    its, conv = prob.solve()
    return its, _np(uh.data), prob.solver.ksp_iterations


@pytest.mark.parametrize("ksp", ["preonly", "cg"])
def test_newton_solve_matches_jax(ksp):
    """A nonlinear Poisson problem with nonzero Dirichlet values through
    both linear solvers: the JAX package's Newton list, u within 1e-10."""
    out = _both(_poisson, ksp)
    its, u, kits = out["port"]
    assert its == out["jax"][0] and its > 1
    assert np.abs(u - out["jax"][1]).max() < 1e-10
    if ksp == "cg":
        assert abs(kits - out["jax"][2]) <= 2


def _heat_mg(ksp):
    """A scalar problem with ``pc_type="mg"`` set after construction, as
    the JAX package's tests set it."""
    fem = PKGS["port"][0]
    mesh, V, u = _unit(fem)
    v = fem.TestFunction(V)
    dx = fem.Measure("dx", metadata={"quadrature_degree": 2})
    F = fem.inner(fem.grad(u), fem.grad(v)) * dx - v * dx
    prob = fem.solvers.NonlinearProblem(F, u, fem.derivative(F, u, fem.TrialFunction(V)),
                                        petsc_options={"ksp_type": ksp})
    prob.solver.pc_type = "mg"
    return prob


@pytest.mark.parametrize("ksp,match", [("preonly", "preonly"), ("bicgstab", "bicgstab"),
                                       ("cg", "bs == 2")])
def test_deferred_options_raise(ksp, match):
    """What still raises, where and as the JAX package raises it:
    ``pc_type="mg"`` with ``preonly`` or ``bicgstab``, and mg on a scalar
    space (the hierarchy is the 2D vector case)."""
    with pytest.raises(NotImplementedError, match=match):
        _heat_mg(ksp).solve()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from dolfinx_external_operator_torch.models import hyperelasticity as he
    from dolfinx_external_operator_torch.models import icnn
    from dolfinx_external_operator_torch.models import mohr_coulomb as mc
    from dolfinx_external_operator_torch.models import von_mises as vm

    mesh = pt.create_unit_square(2, 2)
    V = pt.functionspace(mesh, ("Lagrange", 1))
    for make in (lambda: pt.Function(V), lambda: mc.build_slope_problem(2, 2),
                 lambda: mc.solve_slope_stability(2, 2, [2.0]),
                 lambda: pt.assemble_scalar(pt.SpatialCoordinate(mesh)[0] * pt.Measure("dx")),
                 lambda: vm.solve_von_mises(0.5, 2), lambda: vm.solve_von_mises_pure_form(0.5, 2),
                 lambda: he.solve_hyperelasticity_nn(0.3, 1), icnn.ICNN):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_function_values_are_owned():
    """``x.array[:] =`` copies a tensor (no alias); writes rebind, so a
    tensor read before a write keeps its values; interpolation and the
    probe match the JAX package."""
    fem = PKGS["port"][0]
    mesh = fem.create_unit_square(5, 5)
    V = fem.functionspace(mesh, ("Lagrange", 2))
    f = fem.Function(V)
    f.interpolate(lambda x: x[0] ** 2 + 3 * x[1])
    before = f.data
    src = torch.arange(V.num_dofs, dtype=torch.float64)
    f.x.array[:] = src
    src += 1.0
    assert torch.equal(f.data, src - 1.0) and not torch.equal(before, f.data)
    f.x.array[3] = 7.0
    assert float(f.data[3]) == 7.0 and float(src[3]) == 4.0
    from dolfinx_external_operator_torch.utils.probes import find_cell_by_point
    from dolfinx_external_operator_tpu.utils.probes import find_cell_by_point as find_j

    fj_ = fj.Function(fj.functionspace(fj.create_unit_square(5, 5), ("Lagrange", 2)))
    fj_.interpolate(lambda x: x[0] ** 2 + 3 * x[1])
    assert np.array_equal(np.asarray(fj_.data), _np(before))
    pt_ = np.array([[0.33, 0.47, 0.0]])
    cells, pts = find_cell_by_point(mesh, pt_)
    cj, pj = find_j(fj_.function_space.mesh, pt_)
    assert cells == cj and np.array_equal(np.asarray(pts), np.asarray(pj))
    f.x.array[:] = before
    assert abs(float(f.eval(pts, cells)[0]) - (0.33**2 + 3 * 0.47)) < 1e-11
    assert float(f.eval(pts, cells)[0]) == float(fj_.eval(pts, cells)[0])
    g = pt.convert.function_from_numpy(V, np.asarray(fj_.data), device="cpu")
    assert torch.equal(g.data, before)


def _p4_operand(fem, xp):
    mesh = fem.create_unit_square(3, 3)
    V = fem.functionspace(mesh, ("Lagrange", 4))
    Q = fem.functionspace(mesh, fem.quadrature_element(mesh.cell_name(), degree=8))
    T = fem.Function(V)
    T.interpolate(lambda x: x[0] ** 4 + x[1] ** 3)
    N = fem.FEMExternalOperator(T, function_space=Q)
    N.external_function = lambda d: {(0,): lambda t: (xp.asarray(t) ** 2).reshape(-1),
                                     (1,): lambda t: (2.0 * xp.asarray(t)).reshape(-1)}[d]
    v = fem.TestFunction(V)
    dx = fem.Measure("dx", metadata={"quadrature_degree": 8, "quadrature_scheme": "default"})
    F_r, ops = fem.replace_external_operators(N * v * dx)
    fem.evaluate_external_operators(ops, fem.evaluate_operands(ops))
    return fem.assemble_vector(F_r), fem.assemble_vector(T**2 * v * dx)


def test_external_operator_on_p4_operand():
    out = _both(_p4_operand)
    b, twin = out["port"]
    _close(b, out["jax"][0])
    assert float((b - twin).abs().max()) < 1e-12
