"""The fused load step: ``parallel.spmd.FusedPlasticityStep`` on the
configuration's slope, built as ``problems.mohr_coulomb_slope_step`` builds
it (``problems.build_plasticity_block``, the material's
``batched_kernel``), with the configuration's material, driven through
``run_step`` with the state carried from step to step as
``run_schedule`` carries it.

Spans in traced runs: ``_constitutive`` (E1 and K1), ``_residual`` (E2),
``_dense_solve``, ``_bcr_solve``, ``parallel.bcr.bcr_factor`` and
``_mg_solve``; each solver runs only its own."""

from __future__ import annotations

import numpy as np

from .common import port_material

SPANS = {"_constitutive": "fembench.constitutive", "_residual": "fembench.residual",
         "_dense_solve": "fembench.dense_solve", "_bcr_solve": "fembench.bcr_solve",
         "_mg_solve": "fembench.mg_solve"}


class Cell:
    kind = "steps"

    def __init__(self, config, traffic, factor, device, seed, spans=False):
        from dolfinx_external_operator_torch.parallel import bcr
        from dolfinx_external_operator_torch.parallel.spmd import FusedPlasticityStep
        from dolfinx_external_operator_torch.problems import build_plasticity_block

        from ..harness.spans import wrap

        mesh_cfg = config["mesh"]
        if (mesh_cfg["L"], mesh_cfg["H"]) != (1.2, 1.0):
            raise ValueError("build_plasticity_block builds the 1.2 x 1.0 slope only")
        material = port_material(config["material"], factor)
        mesh, V, S, bc_dofs = build_plasticity_block(mesh_cfg["Nx"], mesh_cfg["Ny"])
        newton = config["newton"]
        self.fp = FusedPlasticityStep(
            mesh, V, S, material.batched_kernel(traffic["route"]), bc_dofs, device=device,
            linear_solver=traffic["linear_solver"], dense_refine=traffic["dense_refine"],
            newton_atol=newton["atol"], newton_rtol=newton["rtol"],
            newton_max_it=newton["max_it"])
        if self.fp.linear_solver != traffic["resolves_to"]:
            raise RuntimeError(f"linear_solver={traffic['linear_solver']!r} resolved to "
                               f"{self.fp.linear_solver!r}, not {traffic['resolves_to']!r}")
        if spans:
            for attr, name in SPANS.items():
                wrap(self.fp, attr, name)
            wrap(bcr, "bcr_factor", "fembench.bcr_factor")
        self.max_it = newton["max_it"]

    def start(self):
        self.Du, self.sigma = self.fp.zero_state()

    def step(self, load, keep):
        Du, sigma, _, its, _ = self.fp.run_step(self.Du, self.sigma, load)
        state = ({"sigma_n": self.sigma, "Du_in": self.Du, "Du": Du, "sigma": sigma} if keep
                 else None)
        self.Du, self.sigma = Du, sigma
        return its, its < self.max_it, state

    def warm(self, loads):
        """Two steps from the zero state: first-call allocations and library
        handles, outside the window."""
        self.start()
        for load in np.asarray(loads)[:2]:
            self.step(float(load), False)

    def counts(self):
        return {"n_dofs": self.fp.n_dofs, "linear_solver": self.fp.linear_solver}
