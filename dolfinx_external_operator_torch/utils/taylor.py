"""Taylor-remainder consistency test with Riesz-dual norms.

The port of ``dolfinx_external_operator_tpu/utils/taylor.py``, the
verification harness of the reference Mohr-Coulomb demo
(``demo_plasticity_mohr_coulomb.py:1092-1235``): for a residual form F(u)
and its Jacobian J(u),

    r0(k) = F(u0 + k du) - F(u0)                  -> O(k)
    r1(k) = F(u0 + k du) - F(u0) - k J(u0) du     -> O(k^2)

with norms measured in the dual space via the Riesz map of the vector
Laplacian (``solvers.solve_dense``).  It runs on the device of ``Du``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..assembly import assemble_matrix, bc_arrays, create_form
from ..function import Function
from ..solvers import solve_dense
from ..sym import Measure, TestFunction, TrialFunction, grad, inner

__all__ = ["taylor_test", "convergence_rates"]


def taylor_test(Du: Function, F_form, J_form, refresh, bcs=(), k_list=None, du0=None):
    """Return (k_list, r0_norms, r1_norms).

    ``refresh()`` must re-evaluate any external operators at the current Du
    (the constitutive-update callback).  ``du0`` is the perturbation
    direction (defaults to Du's current value, as in the reference)."""
    if k_list is None:
        k_list = np.logspace(-2.0, -6.0, 5)[::-1]
    V = Du.function_space
    dev = Du.device
    dxm = Measure("dx", domain=V.mesh, metadata={"quadrature_degree": 2 * V.element.degree})
    u_hat, v = TrialFunction(V), TestFunction(V)
    L = assemble_matrix(inner(grad(u_hat), grad(v)) * dxm, bcs=bcs, device=dev)

    mask, _ = bc_arrays(bcs, V.num_dofs, dev)
    F_c = create_form(F_form, dev)
    J_c = create_form(J_form, dev)

    Du0 = Du.data.clone()
    delta_u = Du0 if du0 is None else torch.as_tensor(du0, dtype=Du0.dtype, device=dev)

    refresh()
    F0 = torch.where(mask, 0.0, F_c.vector())
    J0 = J_c.matrix()
    keep = (~mask).to(J0.dtype)
    J0 = J0 * keep[:, None] * keep[None, :] + torch.diag(mask.to(J0.dtype))

    r0_norms = np.zeros(len(k_list))
    r1_norms = np.zeros(len(k_list))
    for i, k in enumerate(k_list):
        Du.x.array = Du0 + k * delta_u
        refresh()
        r0 = torch.where(mask, 0.0, F_c.vector()) - F0
        r1 = r0 - k * (J0 @ delta_u)
        r0_norms[i] = float(torch.sqrt(torch.abs(torch.dot(r0, solve_dense(L, r0)))))
        r1_norms[i] = float(torch.sqrt(torch.abs(torch.dot(r1, solve_dense(L, r1)))))

    Du.x.array = Du0
    refresh()
    return np.asarray(k_list), r0_norms, r1_norms


def convergence_rates(k_list, norms, skip=0):
    """Least-squares slope of log(norm) vs log(k)."""
    k = np.asarray(k_list)[skip:]
    v = np.asarray(norms)[skip:]
    return float(np.polyfit(np.log(k), np.log(np.maximum(v, 1e-300)), 1)[0])
