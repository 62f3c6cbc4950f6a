"""What the entries share: the configuration's material as the program's
``MohrCoulombMaterial``."""

from __future__ import annotations

import numpy as np


def port_material(mat, factor):
    """The program's material with the configuration's constants, its
    cohesion scaled by the seed's ``factor``."""
    from dolfinx_external_operator_torch.models.mohr_coulomb import MohrCoulombMaterial

    return MohrCoulombMaterial(E=mat["E"], nu=mat["nu"], c=mat["c"] * factor,
                               phi=mat["phi_deg"] * np.pi / 180, psi=mat["psi_deg"] * np.pi / 180,
                               theta_T=mat["theta_T_deg"] * np.pi / 180, a=mat.get("a"),
                               tol=mat["tol"])
