"""Rank functions of ``tests/test_torch_parallel_general.py``.

``parallel.dist.spawn`` pickles a rank function by module name and each
rank imports that module anew, so these live apart from the test module,
which imports JAX: this module imports only the port.  Every case builds
the port's problem after ``parallel.set_default_device_mesh(mesh)``, so
its forms and expressions are sharded over the ranks; rank 0 also runs
it with no mesh installed (the port unsharded).
"""
import time

import numpy as np
import torch
import torch.distributed as tdist

import dolfinx_external_operator_torch as fem
from dolfinx_external_operator_torch import (
    FEMExternalOperator,
    convert,
    evaluate_external_operators,
    evaluate_operands,
    parallel,
    replace_external_operators,
    solvers,
)
from dolfinx_external_operator_torch.models import mohr_coulomb as mc
from dolfinx_external_operator_torch.models import von_mises as vm
from dolfinx_external_operator_torch.parallel import dist

# every collective of torch.distributed but all_reduce and all_gather: the
# sharded general pipeline may call none of them
OTHER_COLLECTIVES = ("all_gather_into_tensor", "all_gather_object", "all_to_all",
                     "all_to_all_single", "barrier", "broadcast", "broadcast_object_list",
                     "gather", "irecv", "isend", "recv", "reduce", "reduce_scatter",
                     "reduce_scatter_tensor", "scatter", "send")


def _k(d):
    """k(T) = 1 / (1 + T) and its derivative (tests/test_parallel_general.py:41-44)."""
    return {(0,): lambda t: (1.0 / (1.0 + t)).reshape(-1),
            (1,): lambda t: (-1.0 / (1.0 + t) ** 2).reshape(-1)}[d]


def heat_forms(T0, n=5):
    """The heat forms of ``tests/test_parallel_general.py:32-48`` on the
    n x n P2 mesh, with T's dofs ``T0``."""
    mesh = fem.create_unit_square(n, n)
    V = fem.functionspace(mesh, ("Lagrange", 2))
    T = convert.function_from_numpy(V, T0, device="cpu")
    Q = fem.functionspace(mesh, fem.quadrature_element(mesh.cell_name(), degree=4))
    dx = fem.Measure("dx", metadata={"quadrature_degree": 4, "quadrature_scheme": "default"})
    k = FEMExternalOperator(T, function_space=Q, external_function=_k)
    v, uh = fem.TestFunction(V), fem.TrialFunction(V)
    F = fem.inner(k * fem.grad(T), fem.grad(v)) * dx
    return mesh, V, T, F, fem.derivative(F, T, uh)


def assembly(case):
    """b, A and the operators' coefficients of the heat pipeline."""
    _, _, _, F, J = heat_forms(case["T0"])
    F_r, F_ops = replace_external_operators(F)
    J_r, J_ops = replace_external_operators(J)
    operands = evaluate_operands(F_ops)
    evaluate_external_operators(F_ops, operands)
    evaluate_external_operators(J_ops, operands)
    return {"b": fem.assemble_vector(F_r).numpy(), "A": fem.assemble_matrix(J_r).numpy(),
            "coeffs": {op.derivatives: op.ref_coefficient.data.numpy() for op in F_ops + J_ops},
            "local_rows": int(next(iter(operands.values())).shape[0])}


def statics(case):
    """This rank's rows of the 8x8 heat Jacobian's cell batch."""
    _, _, _, _, J = heat_forms(case["T0"], n=8)
    Jc = fem.create_form(J)
    s = Jc.kernels[0].batches[0][1]
    a = torch.arange(10.0).reshape(5, 2)
    return {"nc": s["nc"], "test_dofs": s["test_dofs"].numpy(),
            "all_test_dofs": s["test_dofs_all"],
            "pad_shard": parallel.pad_shard_cells(a, parallel.padded_cell_count(5)).numpy()}


def full_solve(case):
    """The heat solve of ``tests/test_parallel_general.py:76-96``."""
    _, V, T, F, J = heat_forms(case["T0"])
    F_r, F_ops = replace_external_operators(F)
    J_r, J_ops = replace_external_operators(J)

    def callback():
        ops = evaluate_operands(F_ops)
        evaluate_external_operators(F_ops, ops)
        evaluate_external_operators(J_ops, ops)

    bdofs = fem.locate_dofs_geometrical(V, lambda X: np.isclose(X[0], 0) | np.isclose(X[0], 1))
    bc = fem.DirichletBC(bdofs, np.zeros(len(bdofs)))
    T.interpolate(lambda X: 0.02 + 0.0 * X[0])
    prob = solvers.NonlinearProblem(F_r, T, J_r, bcs=[bc], petsc_options={"ksp_type": "cg"},
                                    external_callback=callback)
    its, _ = prob.solve()
    return {"its": its, "T": T.data.numpy().copy(), "ksp": prob.solver.ksp_iterations}


def facet_measure(package, mesh, few):
    """``ds`` over every exterior facet, or with ``few`` over two facets of
    the top edge (``package``: either package's module, whose API is the
    same)."""
    if not few:
        return package.Measure("ds")
    top = package.locate_entities_boundary(mesh, lambda x: np.isclose(x[1], 1.0))
    return package.Measure("ds", domain=mesh, subdomain_data={"few": top[:2]})("few")


def facets(case):
    """The 3x3 P1 exterior-facet vector of ``tests/test_parallel_general.py:104-118``."""
    mesh = fem.create_unit_square(3, 3)
    V = fem.functionspace(mesh, ("Lagrange", 1))
    u = convert.function_from_numpy(V, case["u0"], device="cpu")
    v = fem.TestFunction(V)
    form = fem.create_form(u * v * facet_measure(fem, mesh, case.get("few", False)))
    return {"b": form.vector().numpy(), "batch_sizes": [s["test_dofs_all"].shape[0]
                                                         for s in form._statics()]}


def krylov(case):
    """EBE Jacobi-PCG (``tests/test_parallel_general.py:121-141``)."""
    mesh = fem.create_unit_square(5, 5)
    V = fem.functionspace(mesh, ("Lagrange", 1))
    u = fem.Function(V, device="cpu")
    v, uh = fem.TestFunction(V), fem.TrialFunction(V)
    dx = fem.Measure("dx", metadata={"quadrature_degree": 2, "quadrature_scheme": "default"})
    F = fem.inner(fem.grad(u), fem.grad(v)) * dx - 1.0 * v * dx
    J = fem.derivative(F, u, uh)
    bd = fem.locate_dofs_geometrical(V, lambda X: np.isclose(X[0], 0) | np.isclose(X[0], 1))
    prob = solvers.NonlinearProblem(F, u, J, bcs=[fem.DirichletBC(bd, np.zeros(len(bd)))],
                                    petsc_options={"ksp_type": "cg"})
    its, _ = prob.solve()
    return {"its": its, "u": u.data.numpy().copy(), "ksp": prob.solver.ksp_iterations}


def cylinder(case):
    """The von Mises cylinder through ``solve_von_mises`` with the case's
    Krylov options."""
    run = vm.solve_von_mises(lc=case["lc"], num_increments=case["steps"],
                             snes_opts=case["opts"], device="cpu")
    return {"newton": run["iterations"], "inner": run["ksp_iterations"],
            "results": run["results"], "u": run["u"].data.numpy().copy()}


class _CountingMaterial(mc.MohrCoulombMaterial):
    """The material, recording how many points each call of its map
    sees."""

    def __init__(self):
        super().__init__()
        self.points = []

    def tangent_and_stress(self, deps, sigma_n, route="cuda"):
        self.points.append(int(deps.numel() // 4))
        return super().tangent_and_stress(deps, sigma_n, route=route)


def slope(case):
    """The n x n slope through ``solve_slope_stability`` (plain f64 map)."""
    mat = _CountingMaterial()
    run = mc.solve_slope_stability(case["N"], case["N"], case["loads"], material=mat,
                                   device="cpu", route="plain")
    return {"newton": run["iterations"], "u": run["u"].data.numpy().copy(),
            "results": run["results"], "points": sorted(set(mat.points)),
            "calls": len(mat.points)}


def hyperelasticity(case):
    """The ICNN model against the Isihara twin (``run_comparison``)."""
    from dolfinx_external_operator_torch.models.hyperelasticity import run_comparison

    run = run_comparison(lc=case["lc"], n_steps=case["steps"], device="cpu")
    return {"newton": run["nn"]["iterations"] + run["isihara"]["iterations"],
            "u": run["nn"]["u"].data.numpy().copy(), "rel_linf": run["rel_linf"],
            "l2": run["l2"]}


CASES = {"hyperelasticity": hyperelasticity, "assembly": assembly, "statics": statics, "full_solve": full_solve, "facets": facets,
         "krylov": krylov, "cylinder": cylinder, "slope": slope}


def suite(mesh, cases):
    """Rank function: every case on this rank with the mesh installed,
    with every collective but ``all_reduce`` and ``all_gather`` made to
    raise and those two counted; per case the case's results, the calls
    of ``dist.psum`` and ``dist.all_gather`` and of the two collectives,
    and the seconds.  Rank 0 also runs each case with no mesh
    (``"unsharded"``)."""
    saved = {name: getattr(tdist, name) for name in OTHER_COLLECTIVES + ("all_reduce",
                                                                         "all_gather")}

    def refuse(*args, **kwargs):
        raise AssertionError("the sharded pipeline called a collective other than all_reduce "
                             "and all_gather")

    def counter(name):
        def counted(*args, **kwargs):
            counted.calls += 1
            return saved[name](*args, **kwargs)
        counted.calls = 0
        return counted

    for name in OTHER_COLLECTIVES:
        setattr(tdist, name, refuse)
    tdist.all_reduce, tdist.all_gather = counter("all_reduce"), counter("all_gather")
    out = {}
    try:
        for name, case in cases.items():
            fn = CASES[case["kind"]]
            parallel.set_default_device_mesh(mesh)
            dist.psum.calls = dist.all_gather.calls = 0
            tdist.all_reduce.calls = tdist.all_gather.calls = 0
            t0 = time.perf_counter()
            res = fn(case)
            res.update(seconds=time.perf_counter() - t0, psum_calls=dist.psum.calls,
                       gather_calls=dist.all_gather.calls,
                       all_reduce_calls=tdist.all_reduce.calls,
                       all_gather_calls=tdist.all_gather.calls, rank=mesh.rank)
            parallel.set_default_device_mesh(None)
            if mesh.rank == 0:
                res["unsharded"] = fn(case)
            out[name] = res
    finally:
        parallel.set_default_device_mesh(None)
        for name, fn in saved.items():
            setattr(tdist, name, fn)
    return out
