"""The general pipeline on the thick cylinder, written as the upstream von
Mises demo writes it (``models.von_mises.build_cylinder_problem``): the
stress a ``FEMExternalOperator`` of the strain with the hidden operands
``sigma_n`` and ``p``, whose callback is the f64 J2 return map, the
pressure on the inner arc a facet integral, solved by ``NonlinearProblem``
with the traffic's linear solver.  Each step sets the pressure (the
schedule's fraction of the material's ``q_lim``) and ``Du`` (machine
epsilon everywhere, as the demo), calls ``problem.solve()``, adds the
increment to ``u`` and ``dp`` to ``p`` and hands the stress on, as
``solve_von_mises`` does; each schedule starts from zero ``u``, ``p`` and
``sigma_n``.

The program's dof vectors are never written in place, so the states kept
for judging are the tensors themselves.  Each kept state has a
``serial``: the entry's count of steps, which a schedule's start advances
by one more, so that two kept steps are consecutive on one state exactly
where their serials differ by one (the judge then checks what the first
handed on).

Spans in traced runs: ``external_operator.evaluate_operands`` and
``evaluate_external_operators``, the forms' ``vector`` and ``action``, the
Jacobian's ``element_tensors`` (the matrix-free path's assembly, read as
``fembench.form_matrix``), ``NewtonSolver._mg_solve``, and
``parallel.mg.mg_setup`` (the hierarchy's values) and ``cuda_graphed``
(the cycle's capture, which the general path makes only under gmres), as
``fembench.mg_setup``.  Under cg the PCG's graphs are captured inside
``_mg_solve`` at the first solve, in the warm-up."""

from __future__ import annotations

import numpy as np
import torch


class Cell:
    kind = "steps"

    def __init__(self, config, traffic, factor, device, seed, spans=False):
        from dolfinx_external_operator_torch import external_operator
        from dolfinx_external_operator_torch.models.von_mises import (
            VonMisesMaterial,
            build_cylinder_problem,
        )
        from dolfinx_external_operator_torch.parallel import mg

        from ..harness.spans import wrap

        if spans:
            wrap(external_operator, "evaluate_operands", "fembench.evaluate_operands")
            wrap(external_operator, "evaluate_external_operators",
                 "fembench.evaluate_external_operators")
            wrap(mg, "mg_setup", "fembench.mg_setup")
            wrap(mg, "cuda_graphed", "fembench.mg_setup")
        m, mat, newton = config["mesh"], config["material"], config["newton"]
        if (m["R_i"], m["R_e"]) != (1.0, 1.3):
            raise ValueError("build_cylinder_problem builds the 1.0 to 1.3 annulus only")
        material = VonMisesMaterial(E=mat["E"], nu=mat["nu"], E_t=mat["E_t"],
                                    sigma_0=mat["sigma_0"] * factor)
        opts = {"snes_atol": newton["atol"], "snes_rtol": newton["rtol"],
                "snes_max_it": newton["max_it"], "ksp_type": traffic["ksp_type"],
                "pc_type": traffic["pc_type"]}
        self.P = build_cylinder_problem(m["lc"], material=material, snes_opts=opts,
                                        device=device)
        problem = self.P["problem"]
        if spans:
            wrap(problem.F, "vector", "fembench.form_vector")
            wrap(problem.J, "element_tensors", "fembench.form_matrix")
            wrap(problem.J, "action", "fembench.form_action")
            wrap(problem.solver, "_mg_solve", "fembench.mg_solve")
        V = self.P["V"]
        self.n_dofs, self.q_lim = V.num_dofs, self.P["q_lim"]
        self.eps = torch.full((self.n_dofs,), np.finfo(np.float64).eps, dtype=torch.float64,
                              device=self.P["Du"].device)
        self.serial = 0

    def start(self):
        P = self.P
        self.serial += 1
        P["u"].x.array[:] = torch.zeros_like(self.eps)
        P["p"].x.array[:] = torch.zeros_like(P["p"].data)
        P["sigma_n"].x.array[:] = torch.zeros_like(P["sigma_n"].data)

    def step(self, load, keep):
        P = self.P
        problem = P["problem"]
        self.serial += 1
        P["loading"].value = load * self.q_lim
        P["Du"].x.array[:] = self.eps
        sigma_n, p, Du_in = P["sigma_n"].data, P["p"].data, P["Du"].data
        try:
            its, _ = problem.solve()
        except RuntimeError:  # not converged: count it, start the schedule again
            self.start()
            return problem.solver.iterations, False, None
        P["u"].x.axpy(1.0, P["Du"].x)
        P["p"].x.axpy(1.0, P["dp"].x)
        sigma = P["sigma"].ref_coefficient.data
        P["sigma_n"].x.array[:] = sigma
        state = ({"sigma_n": sigma_n, "p": p, "Du_in": Du_in, "Du": P["Du"].data,
                  "sigma": sigma, "serial": self.serial} if keep else None)
        return its, True, state

    def warm(self, loads):
        """One schedule start and two steps, outside the window: the second
        is the first solve, which builds the AMG hierarchy."""
        self.start()
        for load in np.asarray(loads)[:2]:
            self.step(float(load), False)

    def counts(self):
        return {"n_dofs": self.n_dofs, "linear_solver": self.P["problem"].solver.pc_type}
