"""Von Mises J2 plasticity with isotropic hardening: cylinder expansion.

The port of ``dolfinx_external_operator_tpu/models/von_mises.py``: the
material constants (``:54-74``), the return maps (``_return_mapping_kernel``
``:83-113``, ``pallas_batched_kernel`` ``:116-142``, ``VonMisesMaterial``
``:145-160``) and the cylinder-expansion solvers (``epsilon`` ``:77-80``,
``_setup_common``, ``solve_von_mises`` and ``solve_von_mises_pure_form``
``:163-331``).  The JAX package writes a per-point kernel and vmaps it;
here every map is written on the batch directly, with the Gauss-point axis
LAST (SoA), the layout of the fused step's kernel contract.

``solve_von_mises`` runs the reference demo ``demo_plasticity_von_mises.py``
through the general pipeline: the stress is a ``FEMExternalOperator`` of
``epsilon(Du)`` whose callback is the f64 ``VonMisesMaterial`` on the
operands' device (as in the JAX package, whose general path uses the f64
map, not the f32 kernel).  ``solve_von_mises_pure_form`` is the analytic
pure-form twin (``demo_plasticity_von_mises_pure_ufl.py``), the oracle.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.vonmises import vonmises_return_map

__all__ = ["VonMisesMaterial", "batched_kernel_f32", "batched_kernel_f64",
           "return_mapping_kernel", "solve_von_mises", "solve_von_mises_pure_form"]

# Geometry / material constants of the reference demo (:183-204)
R_E, R_I = 1.3, 1.0
E_MOD, NU = 70e3, 0.3
E_TANGENT = E_MOD / 100.0
H_MOD = E_MOD * E_TANGENT / (E_MOD - E_TANGENT)
SIGMA_0 = 250.0
LAMBDA = E_MOD * NU / (1.0 + NU) / (1.0 - 2.0 * NU)
MU = E_MOD / 2.0 / (1.0 + NU)

C_ELAS = np.array(
    [
        [LAMBDA + 2 * MU, LAMBDA, LAMBDA, 0.0],
        [LAMBDA, LAMBDA + 2 * MU, LAMBDA, 0.0],
        [LAMBDA, LAMBDA, LAMBDA + 2 * MU, 0.0],
        [0.0, 0.0, 0.0, 2 * MU],
    ]
)
DEV4 = np.eye(4)
DEV4[:3, :3] -= 1.0 / 3.0

Q_LIM = float(2.0 / np.sqrt(3.0) * np.log(R_E / R_I) * SIGMA_0)

PARAMS = (LAMBDA, MU, H_MOD, SIGMA_0)


def return_mapping_kernel(deps, sigma_n, p):
    """Analytic return map with consistent tangent, f64, batch last:
    deps/sigma_n (4, N), p (N,) -> (C_tang (4, 4, N), sig (4, N), dp (N,)).
    The formula of the JAX package's ``_return_mapping_kernel``, with the
    same guarded divisions (elastic points get exactly zero plastic terms)."""
    dt, dev = deps.dtype, deps.device
    C = torch.as_tensor(C_ELAS, dtype=dt, device=dev)
    D = torch.as_tensor(DEV4, dtype=dt, device=dev)
    sig_el = sigma_n + C @ deps
    s = D @ sig_el
    sig_eq = torch.sqrt(1.5 * (s * s).sum(0))
    f_el = sig_eq - SIGMA_0 - H_MOD * p
    f_plus = (f_el + torch.sqrt(f_el * f_el)) / 2.0
    dp = f_plus / (3.0 * MU + H_MOD)
    plastic = f_el > 0.0
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    sig_eq_safe = torch.where(sig_eq > 0.0, sig_eq, one)
    n_elas = torch.where(plastic, s / sig_eq_safe * f_plus / torch.where(plastic, f_el, one), zero)
    beta = torch.where(plastic, 3.0 * MU * dp / sig_eq_safe, zero)
    sig = sig_el - beta * s
    C_tang = (
        C[:, :, None]
        - 3.0 * MU * (3.0 * MU / (3.0 * MU + H_MOD) - beta) * (n_elas[:, None, :] * n_elas[None, :, :])
        - 2.0 * MU * beta * D[:, :, None]
    )
    return C_tang, sig, dp


def batched_kernel_f64():
    """The f64 plain kernel in the fused step's SoA contract
    ``(deps (4, n), sigma_n (4, n)) -> (C_tang (4, 4, n), sig (4, n))``,
    with ``p = 0`` (the fused von Mises step carries no hardening state)."""

    def batched(deps_soa, sn_soa):
        p = torch.zeros(deps_soa.shape[1], dtype=deps_soa.dtype, device=deps_soa.device)
        C, sig, _ = return_mapping_kernel(deps_soa, sn_soa, p)
        return C, sig

    return batched


def batched_kernel_f32(tile=512):
    """The hand-written f32 kernel (``ops.vonmises``) in the fused step's
    SoA contract: the counterpart of ``pallas_batched_kernel``.  The batch
    is padded to ``tile`` as the JAX wrapper pads it, cast to f32 and back,
    and ``p = 0``.  An opt-in fast path; the f64 kernel stays the parity
    path."""

    def batched(deps_soa, sn_soa):
        n = deps_soa.shape[1]
        pad = -n % tile
        d32 = F.pad(deps_soa.to(torch.float32), (0, pad)).contiguous()
        s32 = F.pad(sn_soa.to(torch.float32), (0, pad)).contiguous()
        p32 = torch.zeros(n + pad, dtype=torch.float32, device=deps_soa.device)
        C, sig, _ = vonmises_return_map(d32, s32, p32, PARAMS)
        C = C[:, :n].reshape(4, 4, n).to(deps_soa.dtype)
        sig = sig[:, :n].to(deps_soa.dtype)
        return C, sig

    return batched


class VonMisesMaterial:
    """Batched f64 return map with consistent tangent on flat point-major
    arrays, as the JAX package's ``VonMisesMaterial.__call__`` takes them."""

    def __call__(self, deps_flat, sigma_n_flat, p_flat):
        deps = deps_flat.reshape(-1, 4).T
        sn = sigma_n_flat.reshape(-1, 4).T
        p = p_flat.reshape(-1)
        C_tang, sig, dp = return_mapping_kernel(deps, sn, p)
        return C_tang.permute(2, 0, 1).reshape(-1), sig.T.reshape(-1), dp.reshape(-1)


# ----------------------------------------------------------------------
# The cylinder expansion through the general pipeline
# ----------------------------------------------------------------------

def epsilon(v):
    """Mandel-Voigt strain 4-vector (reference :225-227)."""
    from ..sym import as_vector, grad

    g = grad(v)
    return as_vector([g[0, 0], g[1, 1], 0.0, np.sqrt(2.0) * 0.5 * (g[0, 1] + g[1, 0])])


def _setup_common(lc):
    from ..assembly import DirichletBC, locate_dofs_topological
    from ..functionspace import functionspace
    from ..mesh import build_cylinder_quarter
    from ..sym import Measure

    mesh, facet_tags, _ = build_cylinder_quarter(lc=lc)
    k_u = 2
    V = functionspace(mesh, ("Lagrange", k_u, (2,)))
    bottom_dofs_y = locate_dofs_topological(V.sub(1), mesh.tdim - 1, facet_tags["Lx"])
    left_dofs_x = locate_dofs_topological(V.sub(0), mesh.tdim - 1, facet_tags["Ly"])
    bcs = [DirichletBC(bottom_dofs_y, 0.0), DirichletBC(left_dofs_x, 0.0)]

    k_stress = 2 * (k_u - 1)
    ds = Measure("ds", domain=mesh, subdomain_data=facet_tags,
                 metadata={"quadrature_degree": k_stress, "quadrature_scheme": "default"})
    dx = Measure("dx", domain=mesh,
                 metadata={"quadrature_degree": k_stress, "quadrature_scheme": "default"})
    return mesh, facet_tags, V, bcs, ds, dx, k_stress


def _probe(mesh):
    from ..utils.probes import find_cell_by_point

    return find_cell_by_point(mesh, np.array([[R_I, 0, 0]]))


def solve_von_mises(lc=0.3, num_increments=20, verbose=False, snes_opts=None, device=None,
                    steps=None):
    """External-operator implementation (reference
    demo_plasticity_von_mises.py) on ``device`` (``None``: the card; raises
    without one).  ``snes_opts`` go into the Newton solver's PETSc options
    (``{"ksp_type": "cg", "pc_type": "mg"}``: AMG-CG).  ``steps``: run only
    the first ``steps`` load steps of the ``num_increments`` schedule
    (default: all; the rows of ``results`` after them stay zero).

    Returns the JAX package's results, and besides them ``step_s`` (the
    host seconds of each load step), ``ksp_iterations`` (the inner
    iterations of each step) and ``problem``."""
    import time

    from .. import resolve_device, solvers
    from ..elements import quadrature_element
    from ..external_operator import (
        FEMExternalOperator,
        evaluate_external_operators,
        evaluate_operands,
        replace_external_operators,
    )
    from ..function import Constant, Function
    from ..functionspace import functionspace
    from ..sym import FacetNormal, TestFunction, TrialFunction, derivative, inner

    dev = resolve_device(device)
    mesh, facet_tags, V, bcs, ds, dx, k_stress = _setup_common(lc)

    Du = Function(V, name="displacement_increment", device=dev)
    u = Function(V, name="displacement", device=dev)

    S = functionspace(mesh, quadrature_element(mesh.cell_name(), degree=k_stress, value_shape=(4,)))
    P = functionspace(mesh, quadrature_element(mesh.cell_name(), degree=k_stress))
    p = Function(P, name="cumulative_plastic_strain", device=dev)
    dp = Function(P, name="incremental_plastic_strain", device=dev)
    sigma_n = Function(S, name="stress_n", device=dev)

    material = VonMisesMaterial()
    sigma = FEMExternalOperator(epsilon(Du), function_space=S,
                                hidden_operands=[sigma_n, p], name="sigma", device=dev)

    def sigma_external(derivatives):
        if derivatives == (1,):
            return material
        raise NotImplementedError(f"No external function for derivative {derivatives}")

    sigma.external_function = sigma_external

    n = FacetNormal(mesh)
    loading = Constant(0.0)
    v = TestFunction(V)
    u_hat = TrialFunction(V)

    F = inner(sigma, epsilon(v)) * dx - inner(-1.0 * loading * n, v) * ds("inner")
    J = derivative(F, Du, u_hat)

    F_replaced, F_ops = replace_external_operators(F)
    J_replaced, J_ops = replace_external_operators(J)

    def constitutive_update():
        evaluated = evaluate_operands(F_ops)
        ((_, sigma_new, dp_new),) = evaluate_external_operators(J_ops, evaluated)
        sigma.ref_coefficient.x.array[:] = sigma_new
        dp.x.array[:] = dp_new

    opts = {"snes_atol": 1e-8, "snes_rtol": 1e-8, "snes_max_it": 100}
    opts.update(snes_opts or {})
    problem = solvers.NonlinearProblem(F_replaced, Du, J_replaced, bcs=bcs,
                                       petsc_options=opts, external_callback=constitutive_update)

    cells, points = _probe(mesh)

    load_steps = np.linspace(0, 1.1, num_increments, endpoint=True) ** 0.5
    loadings = Q_LIM * load_steps
    results = np.zeros((num_increments, 2))
    iterations, step_s, ksp_its = [], [], []

    eps_tiny = torch.full((V.num_dofs,), np.finfo(np.float64).eps, dtype=torch.float64, device=dev)
    for i, load in enumerate(loadings[:steps]):
        if verbose:
            print(f"Load increment #{i}, load: {load:.3f}")
        t0 = time.perf_counter()
        k0 = problem.solver.ksp_iterations
        loading.value = load
        Du.x.array[:] = eps_tiny
        its, _ = problem.solve()
        iterations.append(its)
        ksp_its.append(problem.solver.ksp_iterations - k0)
        if verbose:
            print(f"\tNewton iterations: {its}")
        u.x.axpy(1.0, Du.x)
        p.x.axpy(1.0, dp.x)
        sigma_n.x.array[:] = sigma.ref_coefficient.data
        if points:
            results[i, :] = (float(u.eval(points, cells)[0, 0]), load / Q_LIM)
        step_s.append(time.perf_counter() - t0)

    return {"results": results, "iterations": iterations, "u": u, "p": p,
            "sigma": sigma, "mesh": mesh, "q_lim": Q_LIM, "step_s": step_s,
            "ksp_iterations": ksp_its, "problem": problem}


def solve_von_mises_pure_form(lc=0.3, num_increments=20, verbose=False, device=None):
    """Analytic pure-form twin (reference
    demo_plasticity_von_mises_pure_ufl.py:18-177) on ``device`` (``None``:
    the card).  Besides the JAX package's results: ``step_s``."""
    import time

    from .. import resolve_device, solvers
    from ..elements import quadrature_element
    from ..function import Constant, Function
    from ..functionspace import functionspace
    from ..sym import (
        FacetNormal,
        Identity,
        TestFunction,
        TrialFunction,
        as_tensor,
        as_vector,
        derivative,
        dev as deviator,
        grad,
        inner,
        sqrt,
        sym as symmetric,
        tr,
    )
    from ..utils.probes import interpolate_quadrature

    device = resolve_device(device)
    mesh, facet_tags, V, bcs, ds, dx, k_stress = _setup_common(lc)

    W = functionspace(mesh, quadrature_element(mesh.cell_name(), degree=k_stress, value_shape=(4,)))
    W0 = functionspace(mesh, quadrature_element(mesh.cell_name(), degree=k_stress))

    sig = Function(W, name="stress_vector", device=device)
    dp = Function(W0, name="dp", device=device)
    p = Function(W0, name="p", device=device)
    u = Function(V, name="displacement", device=device)
    Du = Function(V, name="increment", device=device)
    v = TestFunction(V)
    v_hat = TrialFunction(V)

    n = FacetNormal(mesh)
    loading = Constant(0.0)

    def eps3(w):
        e = symmetric(grad(w))
        return as_tensor([[e[0, 0], e[0, 1], 0.0], [e[0, 1], e[1, 1], 0.0], [0.0, 0.0, 0.0]])

    def sigma3(eps_el):
        return LAMBDA * tr(eps_el) * Identity(3) + 2.0 * MU * eps_el

    def as_3d(X):
        return as_tensor([[X[0], X[3], 0.0], [X[3], X[1], 0.0], [0.0, 0.0, X[2]]])

    def ppos(x):
        return (x + sqrt(x**2)) / 2.0

    sig_n3 = as_3d(sig)
    sig_elas = sig_n3 + sigma3(eps3(Du))
    s = deviator(sig_elas)
    sig_eq = sqrt(3.0 / 2.0 * inner(s, s))
    f_elas = sig_eq - SIGMA_0 - H_MOD * p
    dp_expr = ppos(f_elas) / (3.0 * MU + H_MOD)
    beta = 3.0 * MU * dp_expr / sig_eq
    new_sig = sig_elas - beta * s
    deps_p = 3.0 / 2.0 * (dp_expr / sig_eq) * s
    sig_expr = as_vector([new_sig[0, 0], new_sig[1, 1], new_sig[2, 2], new_sig[0, 1]])

    residual = inner(as_3d(sig) + sigma3(eps3(Du) - deps_p), eps3(v)) * dx \
        - inner(-1.0 * loading * n, v) * ds("inner")
    J = derivative(inner(sigma3(eps3(Du) - deps_p), eps3(v)) * dx, Du, v_hat)

    problem = solvers.NonlinearProblem(residual, Du, J, bcs=bcs,
                                       petsc_options={"snes_atol": 1e-8, "snes_rtol": 1e-8,
                                                      "snes_max_it": 100})

    cells, points = _probe(mesh)

    sig.x.array[:] = torch.full((W.num_dofs,), np.finfo(np.float64).eps, dtype=torch.float64,
                                device=device)

    load_steps = np.linspace(0, 1.1, num_increments, endpoint=True) ** 0.5
    results = np.zeros((num_increments, 2))
    iterations, step_s = [], []
    for i, t in enumerate(load_steps):
        t0 = time.perf_counter()
        loading.value = t * Q_LIM
        if verbose:
            print(f"Load increment #{i}, load: {t * Q_LIM:.3f}")
        its, _ = problem.solve()
        iterations.append(its)
        # dp BEFORE sig, as the JAX package commits them: dp_expr reads the
        # sig coefficient, so dp comes from the consistent old state (the
        # external-operator kernel's semantics; the reference twin
        # interpolates sig first, demo_plasticity_von_mises_pure_ufl.py:168-169)
        interpolate_quadrature(dp_expr, dp)
        interpolate_quadrature(sig_expr, sig)
        u.x.axpy(1.0, Du.x)
        p.x.array[:] = p.data + dp.data
        if points:
            results[i, :] = (float(u.eval(points, cells)[0, 0]), t)
        step_s.append(time.perf_counter() - t0)

    return {"results": results, "iterations": iterations, "u": u, "mesh": mesh,
            "q_lim": Q_LIM, "step_s": step_s}
