"""The general pipeline: the slope written as the upstream demo writes it
(``models.mohr_coulomb.build_slope_problem``): the stress a
``FEMExternalOperator`` whose callback is the return map, solved by
``NonlinearProblem``.  Each step sets ``q.value``, calls
``problem.solve()``, adds the increment to the total displacement and hands
the stress on, as ``solve_slope_stability`` does; each schedule starts as
it does (``Du`` all ones, zero stress, one constitutive update).

The program's dof vectors are never written in place, so the states kept
for judging are the tensors themselves.

Spans in traced runs: ``external_operator.evaluate_operands`` and
``evaluate_external_operators`` (put on the module before the problem is
built, which imports them), the forms' ``vector``, ``matrix`` and
``action``, and ``solvers._lu_ir``."""

from __future__ import annotations

import numpy as np

from .common import port_material


class Cell:
    kind = "steps"

    def __init__(self, config, traffic, factor, device, seed, spans=False):
        from dolfinx_external_operator_torch import external_operator, solvers
        from dolfinx_external_operator_torch.models.mohr_coulomb import build_slope_problem

        from ..harness.spans import wrap

        if spans:
            wrap(external_operator, "evaluate_operands", "fembench.evaluate_operands")
            wrap(external_operator, "evaluate_external_operators",
                 "fembench.evaluate_external_operators")
            wrap(solvers, "_lu_ir", "fembench.lu_ir")
        m, newton = config["mesh"], config["newton"]
        self.P = build_slope_problem(
            m["Nx"], m["Ny"], L=m["L"], H=m["H"],
            material=port_material(config["material"], factor),
            snes_opts={"snes_atol": newton["atol"], "snes_rtol": newton["rtol"],
                       "snes_max_it": newton["max_it"], "ksp_type": traffic["ksp_type"]},
            device=device, route=traffic["route"])
        problem = self.P["problem"]
        if spans:
            wrap(problem.F, "vector", "fembench.form_vector")
            wrap(problem.J, "matrix", "fembench.form_matrix")
            wrap(problem.J, "action", "fembench.form_action")
        self.n_dofs = self.P["V"].num_dofs

    def start(self):
        P = self.P
        P["Du"].x.array[:] = np.ones(self.n_dofs)
        P["sigma_n"].x.array[:] = np.zeros(P["S"].num_dofs)
        P["u"].x.array[:] = np.zeros(self.n_dofs)
        P["constitutive_update"]()

    def step(self, load, keep):
        P = self.P
        sigma_n, Du_in = P["sigma_n"].data, P["Du"].data
        P["q"].value = load * np.array([0.0, -P["gamma"]])
        try:
            its, _ = P["problem"].solve()
        except RuntimeError:  # not converged: count it, start the schedule again
            self.start()
            return P["problem"].solver.iterations, False, None
        P["u"].x.axpy(1.0, P["Du"].x)
        sigma = P["sigma"].ref_coefficient.data
        P["sigma_n"].x.array[:] = sigma
        state = ({"sigma_n": sigma_n, "Du_in": Du_in, "Du": P["Du"].data, "sigma": sigma} if keep
                 else None)
        return its, True, state

    def warm(self, loads):
        """One schedule start and two steps, outside the window."""
        self.start()
        for load in np.asarray(loads)[:2]:
            self.step(float(load), False)

    def counts(self):
        return {"n_dofs": self.n_dofs, "linear_solver": "lu_ir"}
