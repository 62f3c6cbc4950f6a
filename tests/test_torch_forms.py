"""The port's form layer against the JAX package's: the symbolic language,
assembly, boundary conditions and ``Expression``.

Each test builds the same problem through both packages from the same
seeded inputs (each case function takes the package as an argument) and holds the
port's arrays to the JAX package's: within 1e-12 of the largest entry for
assembled scalars, vectors, matrices, actions, diagonals and element
tensors.  The spaces are those of ``test_spaces_parity.py`` (DG, CG, mixed
scalar and vector sub-spaces), ``test_high_degree_elements.py`` and the
facet and codim integrals of ``test_codim.py``; lifting is that of
``test_bc_lifting.py``.  External-operator callbacks are written once for
``numpy`` (JAX arrays in) and ``torch`` (tensors in and out).
"""
import functools
import os
import re

import numpy as np
import pytest
import torch

import dolfinx_external_operator_tpu as fj

import dolfinx_external_operator_torch as pt

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    """``build(fem, xp, *args)`` through each package: {name: result}."""
    return {k: build(fem, xp, *args) for k, (fem, xp) in PKGS.items()}


# ----------------------------------------------------------------------
# The symbolic language
# ----------------------------------------------------------------------

def _code(path):
    """A module's source past its docstring."""
    with open(path) as f:
        text = f.read()
    return text[text.index('"""', text.index('"""') + 3) + 3:]


def test_sym_is_a_copy_of_the_jax_module():
    port = os.path.join(REPO, "dolfinx_external_operator_torch", "sym.py")
    ref = os.path.join(REPO, "dolfinx_external_operator_tpu", "sym.py")
    assert _code(port) == _code(ref)
    with open(port) as f:
        assert "dolfinx_external_operator_tpu/sym.py" in f.readline()
    assert not re.search(r"^\s*(import|from)\s+jax", _code(port), re.M)


def _render(e, memo):
    """A canonical text of a symbolic DAG: node kinds, shapes, indices and
    values, terminals by name (``sym`` defines no ``__str__``)."""
    hit = memo.get(id(e))
    if hit is not None:
        return hit
    kind = type(e).__name__
    if kind == "Function":
        s = f"Function({e.name},{e.shape},{e.function_space.num_dofs})"
    elif kind == "FEMExternalOperator":
        s = (f"Op({e.name},{e.derivatives},{e.shape};"
             + ",".join(_render(o, memo) for o in e.ufl_operands) + ")")
    elif kind == "Argument":
        s = f"Arg({e.number},{e.shape})"
    elif kind == "Literal":
        s = f"Lit({e.array.tolist()})"
    elif kind == "Constant":
        s = f"Const({e.value.tolist()})"
    else:
        attrs = [getattr(e, a) for a in ("op", "idx", "n", "gdim") if hasattr(e, a)]
        s = f"{kind}{e.shape}{attrs}(" + ",".join(_render(o, memo) for o in e.operands) + ")"
    memo[id(e)] = s
    return s


def _render_form(form):
    memo = {}
    return " + ".join(f"[{_render(i.integrand, memo)}]*{i.measure.kind}"
                      f"{sorted(i.measure.metadata.items())}" for i in form.integrals)


def _slope_forms(fem, xp, mc):
    mesh = fem.create_rectangle((0.0, 0.0), (1.2, 1.0), (4, 4), "triangle")
    V = fem.functionspace(mesh, ("Lagrange", 2, (2,)))
    S = fem.functionspace(mesh, fem.quadrature_element(mesh.cell_name(), degree=2, value_shape=(4,)))
    dx = fem.Measure("dx", domain=mesh, metadata={"quadrature_degree": 2, "quadrature_scheme": "default"})
    Du, sigma_n = fem.Function(V, name="Du"), fem.Function(S, name="sigma_n")
    v, u_hat = fem.TestFunction(V), fem.TrialFunction(V)
    sigma = fem.FEMExternalOperator(mc.epsilon(Du), function_space=S, hidden_operands=[sigma_n],
                                    name="sigma")
    q = fem.Constant(np.array([0.0, -1.0]))
    F = fem.inner(mc.epsilon(v), sigma) * dx - fem.dot(q, v) * dx
    J = fem.derivative(F, Du, u_hat)
    return [_render_form(f) for f in (F, J, fem.replace_external_operators(F)[0],
                                      fem.replace_external_operators(J)[0])]


def test_slope_forms_render_equal():
    """The slope's F, J = derivative(F, Du, u_hat) and both replaced forms
    are the same trees in both packages, as built by hand and as
    ``build_slope_problem`` builds them."""
    from dolfinx_external_operator_torch.models import mohr_coulomb as mc_t
    from dolfinx_external_operator_tpu.models import mohr_coulomb as mc_j

    ref = _slope_forms(fj, np, mc_j)
    assert _slope_forms(PKGS["port"][0], torch, mc_t) == ref
    assert "Op(∂sigma/∂o1,(1,),(4, 4)" in ref[1]
    Pj = mc_j.build_slope_problem(Nx=4, Ny=4)
    Pt = mc_t.build_slope_problem(Nx=4, Ny=4, device="cpu")
    for key in ("F_replaced", "J_replaced"):
        assert _render_form(Pt[key]) == _render_form(Pj[key])


# ----------------------------------------------------------------------
# Assembly on the spaces of test_spaces_parity.py
# ----------------------------------------------------------------------

def _run_pipeline(fem, F, u):
    """Replace, evaluate, assemble F and J; the Jacobian's action on a
    seeded vector, its diagonal and element tensors; the explicit twin
    too where given."""
    V = u.function_space
    J = fem.derivative(F, u, fem.TrialFunction(V))
    F_r, F_ops = fem.replace_external_operators(F)
    J_r, J_ops = fem.replace_external_operators(J)
    operands = fem.evaluate_operands(F_ops)
    fem.evaluate_external_operators(F_ops, operands)
    fem.evaluate_external_operators(J_ops, operands)
    Jc = fem.create_form(J_r)
    x = np.random.default_rng(7).standard_normal(V.num_dofs)
    return {
        "b": fem.assemble_vector(F_r),
        "A": fem.assemble_matrix(J_r),
        "action": Jc.action(x if fem is fj else torch.as_tensor(x)),
        "diagonal": Jc.diagonal(),
        "elements": [e for e, _, _ in Jc.element_tensors()],
        "tdofs": [td for _, td, _ in Jc.element_tensors()],
    }


def _dg(fem, xp):
    mesh = fem.create_unit_square(6, 6)
    V = fem.functionspace(mesh, ("Lagrange", 1, (2,)))
    u = fem.Function(V)
    u.interpolate(lambda x: (x[0], x[1]))

    def N_impl(div_u_, grad_u_):
        div_u_ = xp.asarray(div_u_)
        grad_u_ = xp.asarray(grad_u_).reshape(div_u_.shape[0], div_u_.shape[1], 2, 2)
        return (div_u_ + xp.einsum("...ij,...ij->...", grad_u_, grad_u_)).reshape(-1)

    def dNddivu_impl(div_u_, grad_u_):
        return xp.ones_like(xp.asarray(div_u_)).reshape(-1)

    def dNdgradu_impl(div_u_, grad_u_):
        return 2 * xp.asarray(grad_u_).reshape(-1)

    ext = lambda d: {(0, 0): N_impl, (1, 0): dNddivu_impl, (0, 1): dNdgradu_impl}[d]  # noqa: E731
    Q = fem.functionspace(mesh, ("DG", 1))
    N = fem.FEMExternalOperator(fem.div(u), fem.grad(u), function_space=Q, external_function=ext)
    v = fem.TestFunction(V)
    dx = fem.Measure("dx", metadata={"quadrature_degree": 2})
    return fem, N * fem.inner(u, v) * dx, u


def _cg(fem, xp):
    mesh = fem.create_unit_square(6, 6)
    V = fem.functionspace(mesh, ("Lagrange", 1, (2,)))
    u = fem.Function(V)
    u.interpolate(lambda x: (1.0 + x[0] * x[1], 2.0 - x[1] ** 2))

    def N_impl(u_):
        return (xp.asarray(u_) ** 2).reshape(-1)

    def dNdu_impl(u_):
        u_ = xp.asarray(u_)
        out = xp.zeros(u_.shape + (2,), dtype=xp.float64)
        out[..., 0, 0] = 2 * u_[..., 0]
        out[..., 1, 1] = 2 * u_[..., 1]
        return out.reshape(-1)

    N = fem.FEMExternalOperator(u, function_space=V,
                                external_function=lambda d: {(0,): N_impl, (1,): dNdu_impl}[d])
    v = fem.TestFunction(V)
    dx = fem.Measure("dx", metadata={"quadrature_degree": 2})
    return fem, fem.inner(N, v) * dx, u


def _mixed_scalar(fem, xp):
    mesh = fem.create_unit_square(6, 6)
    e1 = fem.element("Lagrange", mesh.cell_name(), 1)
    e2 = fem.element("Lagrange", mesh.cell_name(), 2)
    V = fem.functionspace(mesh, fem.mixed_element([e1, e2]))
    u = fem.Function(V)
    u.sub(0).interpolate(lambda x: x[1] + 2.0)
    u.sub(1).interpolate(lambda x: x[1] * x[0] + 1.0)
    u1, u2 = fem.sym.split(u)
    v = fem.TestFunction(V)
    p1 = V.sub(0).element.interpolation_points.shape[0]
    pt_ = p1 + V.sub(1).element.interpolation_points.shape[0]

    def N_impl(u_):
        u_ = xp.asarray(u_)
        out = xp.zeros_like(u_)
        out[:, p1:pt_] = u_[:, p1:pt_] ** 2
        return out.reshape(-1)

    def dN_impl(u_):
        u_ = xp.asarray(u_)
        out = xp.zeros_like(u_)
        out[:, p1:pt_] = 2 * u_[:, p1:pt_]
        return out.reshape(-1)

    N = fem.FEMExternalOperator(u2, function_space=V, name="N",
                                external_function=lambda d: {(0,): N_impl, (1,): dN_impl}[d])
    N1, N2 = fem.sym.split(N)
    v1, v2 = fem.sym.split(v)
    dx = fem.Measure("dx", metadata={"quadrature_degree": 4})
    return fem, N1 * v1 * dx + N2 * v2 * dx, u


def _mixed_vector(fem, xp):
    mesh = fem.create_unit_square(4, 4)
    e1 = fem.element("Lagrange", mesh.cell_name(), 4)
    e2 = fem.element("Lagrange", mesh.cell_name(), 2, shape=(2,))
    V = fem.functionspace(mesh, fem.mixed_element([e1, e2]))
    u = fem.Function(V)
    u.sub(0).interpolate(lambda x: x[1] + 2.0)
    u.sub(1).interpolate(lambda x: (x[0], x[1]))
    u1, u2 = fem.sym.split(u)
    p1 = V.sub(0).element.interpolation_points.shape[0]
    pt_ = p1 + V.sub(1).element.interpolation_points.shape[0]

    def N_impl(u1_, u2_):
        u1_, u2_ = xp.asarray(u1_), xp.asarray(u2_)
        out = xp.zeros((u2_.shape[0], pt_, 2), dtype=xp.float64)
        first = u2_[:, :p1, :]
        out[:, :p1, 0] = u1_[:, :p1] + xp.einsum("...i,...i->...", first, first)
        out[:, p1:, :] = u2_[:, p1:, :]
        return out.reshape(-1)

    def dNdu1_impl(u1_, u2_):
        out = xp.zeros((xp.asarray(u2_).shape[0], pt_, 2), dtype=xp.float64)
        out[:, :p1, 0] = 1.0
        return out.reshape(-1)

    def dNdu2_impl(u1_, u2_):
        u2_ = xp.asarray(u2_)
        out = xp.zeros((u2_.shape[0], pt_, 4), dtype=xp.float64)
        out[:, :p1, 0:2] = 2.0 * u2_[:, :p1, :]
        out[:, p1:, 0] = 1.0
        out[:, p1:, 3] = 1.0
        return out.reshape(-1)

    N = fem.FEMExternalOperator(
        u1, u2, function_space=V, name="N",
        external_function=lambda d: {(0, 0): N_impl, (1, 0): dNdu1_impl, (0, 1): dNdu2_impl}[d])
    N1, N2 = fem.sym.split(N)
    v1, v2 = fem.sym.split(fem.TestFunction(V))
    dx = fem.Measure("dx", metadata={"quadrature_degree": 5})
    return fem, N1 * v1 * dx + fem.inner(N2, v2) * dx, u


@pytest.mark.parametrize("case", [_dg, _cg, _mixed_scalar, _mixed_vector],
                         ids=["dg", "cg", "mixed_scalar", "mixed_vector"])
def test_space_assembly_matches_jax(case):
    out = {k: _run_pipeline(*case(fem, xp)) for k, (fem, xp) in PKGS.items()}
    port, ref = out["port"], out["jax"]
    for key in ("b", "A", "action", "diagonal"):
        _close(port[key], ref[key])
    assert len(port["elements"]) == len(ref["elements"])
    for e_p, e_j, t_p, t_j in zip(port["elements"], ref["elements"], port["tdofs"], ref["tdofs"]):
        _close(e_p, e_j)
        assert np.array_equal(_np(t_p), _np(t_j))
    assert float(np.abs(_np(ref["A"])).max()) > 0.0


# ----------------------------------------------------------------------
# High-degree elements (test_high_degree_elements.py)
# ----------------------------------------------------------------------

def _mesh(fem, cell, n):
    if cell == "interval":
        return fem.create_unit_interval(n)
    if cell in ("triangle", "quadrilateral"):
        return fem.create_unit_square(n, n, cell)
    return fem.create_unit_cube(n, n, n, cell)


def _laplace_reaction(fem, xp, cell, deg, keys):
    mesh = _mesh(fem, cell, 2 if cell in ("tetrahedron", "hexahedron") else 3)
    V = fem.functionspace(mesh, ("Lagrange", deg))
    u = fem.Function(V)
    u.interpolate(lambda x: 1.0 + x[0] ** 2 - 0.5 * x[1] + 0.3 * x[0] * x[1])
    v, du = fem.TestFunction(V), fem.TrialFunction(V)
    x = fem.SpatialCoordinate(mesh)
    dx = fem.Measure("dx", metadata={"quadrature_degree": deg + 1})
    F = (fem.inner(fem.grad(u), fem.grad(v)) + u * u * v - x[0] * v) * dx
    J = fem.derivative(F, u, du)
    Jc = fem.create_form(J)
    xv = np.random.default_rng(deg).standard_normal(V.num_dofs)
    ops = {"b": lambda: fem.assemble_vector(F), "A": lambda: fem.assemble_matrix(J),
           "action": lambda: Jc.action(xv if fem is fj else torch.as_tensor(xv)),
           "diagonal": Jc.diagonal}
    return {k: ops[k]() for k in keys}


# each JAX program compiles for seconds: the tetrahedra (20 basis
# functions) check the vector and the matrix only
@pytest.mark.parametrize("cell,deg,keys", [
    ("triangle", 4, ("b", "A", "action", "diagonal")),
    ("quadrilateral", 4, ("b", "A", "action", "diagonal")),
    ("tetrahedron", 3, ("b", "A")),
    ("hexahedron", 2, ("b", "A", "action", "diagonal"))])
def test_high_degree_assembly_matches_jax(cell, deg, keys):
    out = _both(_laplace_reaction, cell, deg, keys)
    for key in keys:
        _close(out["port"][key], out["jax"][key])


# ----------------------------------------------------------------------
# Facet and codim integrals (test_codim.py, test_foundations.py)
# ----------------------------------------------------------------------

def _facets(fem, xp, cell):
    mesh = fem.create_unit_square(4, 4, cell)
    V = fem.functionspace(mesh, ("Lagrange", 2))
    g = fem.Function(V)
    g.interpolate(lambda x: x[0] ** 2 + 0.5 * x[1])
    x = fem.SpatialCoordinate(mesh)
    n = fem.FacetNormal(mesh)
    ds = fem.Measure("ds", domain=mesh, metadata={"quadrature_degree": 4})
    v, du = fem.TestFunction(V), fem.TrialFunction(V)
    w = fem.as_vector([x[0] ** 2, x[0] * x[1]])
    left = fem.locate_entities_boundary(mesh, lambda X: np.isclose(X[0], 0.0))
    ds_left = fem.Measure("ds", domain=mesh, subdomain_data={3: left}, subdomain_id=3,
                          metadata={"quadrature_degree": 3})
    return {"perimeter_x2": fem.assemble_scalar(x[0] ** 2 * ds),
            "flux": fem.assemble_scalar(fem.dot(w, n) * ds),
            "vector": fem.assemble_vector(g * fem.dot(fem.grad(g), n) * v * ds),
            "matrix": fem.assemble_matrix(g * du * v * ds),
            "left": fem.assemble_vector((g + 1.0) * v * ds_left)}


@pytest.mark.parametrize("cell", ["triangle", "quadrilateral"])
def test_facet_integrals_match_jax(cell):
    out = _both(_facets, cell)
    for key, ref in out["jax"].items():
        _close(out["port"][key], ref)
    assert abs(float(out["port"]["flux"]) - 1.5) < 1e-12


def _codim(fem, xp, codim, qdeg):
    mesh = fem.create_unit_square(5, 5)
    V = fem.functionspace(mesh, ("Lagrange", 1))
    u = fem.Function(V)
    u.interpolate(lambda x: x[0] + x[1])
    mesh_mod = fj.mesh if fem is fj else pt.mesh
    if codim == 1:
        facets = mesh.exterior_facets
        submesh, _, _, _ = mesh_mod.create_submesh(mesh, mesh.tdim - 1, facets)
        entities = np.stack([mesh.facet_cells[facets, 0], mesh.facet_local_index[facets, 0]],
                            axis=1).astype(np.int32)
        meas = fem.Measure("ds", domain=mesh, subdomain_data={1: facets}, subdomain_id=1,
                           metadata={"quadrature_degree": qdeg})
        operand = u

        def ext(d):
            if d == (0,):
                return lambda a: xp.cos(xp.asarray(a)).reshape(-1)
            return lambda a: xp.sin(xp.asarray(a)).reshape(-1)
    else:
        cells = mesh_mod.locate_entities(mesh, mesh.tdim, lambda x: x[0] <= 0.2 + 1e-10)
        submesh, entity_map, _, _ = mesh_mod.create_submesh(mesh, mesh.tdim, cells)
        entities = entity_map.sub_topology_to_topology(
            np.arange(submesh.num_cells, dtype=np.int32), inverse=False)
        meas = fem.Measure("dx", domain=mesh, subdomain_data={1: cells}, subdomain_id=1,
                           metadata={"quadrature_degree": qdeg})
        operand = u * u

        def ext(d):
            if d == (0,):
                return lambda a: (xp.asarray(a) * xp.sqrt(xp.asarray(a))).reshape(-1)
            return lambda a: (3 * xp.asarray(a)).reshape(-1)

    Q = fem.functionspace(submesh, fem.quadrature_element(submesh.cell_name(), degree=qdeg))
    N = fem.FEMExternalOperator(operand, function_space=Q, external_function=ext)
    out = []
    for J in (N * meas, fem.expand_derivatives(fem.derivative(N * meas, u, fem.sym.as_expr(1.0)))):
        J_r, ops = fem.replace_external_operators(J)
        fem.evaluate_external_operators(ops, fem.evaluate_operands(ops, entities=entities))
        out.append(float(fem.assemble_scalar(J_r)))
    return out


@pytest.mark.parametrize("codim", [0, 1])
@pytest.mark.parametrize("qdeg", range(1, 5))
def test_codim_functionals_match_jax(codim, qdeg):
    out = _both(_codim, codim, qdeg)
    for p, j in zip(out["port"], out["jax"]):
        assert abs(p - j) <= 1e-12 * max(abs(j), 1e-300), (p, j)


# ----------------------------------------------------------------------
# Dirichlet lifting (test_bc_lifting.py)
# ----------------------------------------------------------------------

def _lifting(fem, xp):
    asm = fj.assembly if fem is fj else pt.assembly
    mesh = fem.create_unit_square(8, 8)
    V = fem.functionspace(mesh, ("Lagrange", 1))
    dx = fem.Measure("dx", metadata={"quadrature_degree": 2})
    v, du = fem.TestFunction(V), fem.TrialFunction(V)
    uh = fem.Function(V)
    uh.interpolate(lambda x: 0.1 * np.sin(3 * x[0]) * x[1])
    F = fem.inner(fem.grad(uh), fem.grad(v)) * dx + uh * uh * v * dx
    J = fem.derivative(F, uh, du)
    bdofs = fem.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[0], 0) | np.isclose(x[0], 1) | np.isclose(x[1], 0) | np.isclose(x[1], 1))
    coords = asm._dof_coordinates(V)
    bc = fem.DirichletBC(bdofs, coords[bdofs, 0] + 0.5 * coords[bdofs, 1] ** 2)
    x0 = uh.data
    b = asm.create_form(F).vector()
    lifted = asm.apply_lifting(b, J, [bc], x0, scale=-1.0)
    b_bc = asm.set_bc(lifted, [bc], x0, scale=-1.0)
    A = asm._apply_bc_matrix(asm.create_form(J).matrix(), [bc])
    delta = np.linalg.solve(_np(A), -_np(b_bc))
    return {"lifted": lifted, "set_bc": b_bc, "A": A, "u": _np(x0) + delta, "bc": bc}


def test_lifting_and_set_bc_match_jax():
    out = _both(_lifting)
    for key in ("lifted", "set_bc", "A", "u"):
        _close(out["port"][key], out["jax"][key])
    bc = out["port"]["bc"]
    assert np.abs(out["port"]["u"][bc.dofs] - bc.values).max() < 1e-14
    assert np.abs(bc.values).max() > 0.0


# ----------------------------------------------------------------------
# Expression on cells and facets
# ----------------------------------------------------------------------

def _expressions(fem, xp):
    mesh = fem.create_unit_square(4, 4)
    V = fem.functionspace(mesh, ("Lagrange", 2, (2,)))
    f = fem.Function(V)
    f.interpolate(lambda x: (x[0] ** 2 + x[1], np.sin(x[0]) * x[1]))
    c = fem.Constant(np.array(1.5))
    x = fem.SpatialCoordinate(mesh)
    pts, _ = fem.make_quadrature("triangle", 2)
    expr = fem.as_vector([f[0] * c + x[1], fem.div(f), fem.inner(fem.grad(f), fem.grad(f))])
    E = fem.Expression(expr, pts)
    Es = fem.Expression(fem.sym.sqrt(1.0 + f[0] * f[0]), pts)
    fpts, _ = fem.make_quadrature("interval", 3)
    facets = mesh.exterior_facets
    entities = np.stack([mesh.facet_cells[facets, 0], mesh.facet_local_index[facets, 0]],
                        axis=1).astype(np.int32)
    return {"cells": E.eval(mesh), "subset": E.eval(mesh, np.array([0, 5, 7], dtype=np.int32)),
            "other_subset": E.eval(mesh, np.array([0, 4, 8], dtype=np.int32)),
            "scalar": Es.eval(mesh),
            "facets": fem.Expression(expr, fpts).eval(mesh, entities)}


def test_expression_eval_matches_jax():
    out = _both(_expressions)
    for key, ref in out["jax"].items():
        _close(out["port"][key], ref)
    port = out["port"]
    # the cell-subset cache is keyed by content (test_bc_lifting.py)
    assert np.allclose(_np(port["subset"]), _np(port["cells"])[[0, 5, 7]], atol=1e-14)
    assert np.allclose(_np(port["other_subset"]), _np(port["cells"])[[0, 4, 8]], atol=1e-14)
    assert tuple(port["facets"].shape) == (16, 2, 3)
