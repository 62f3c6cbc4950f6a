"""What decides ``correct`` for the thick cylinder: the program's outputs
against the plain reference.

A load step is judged from the state it started from: the stress
``sigma_n`` and hardening variable ``p`` the step was handed, and its
pressure.  From the step's displacement increment ``Du`` the reference
works out the strain with its own mesh (``reference.cylinder``), the
stress with its own J2 return map (``reference.von_mises``, f64) and the
assembled out-of-balance force with its own quadrature.  Two numbers:

* ``residual``: the norm of that force on the free dofs, with ``Du`` itself
  on the clamped ones (the vector of the program's own convergence test),
  over the norm of the load vector at the limit pressure ``q_lim``: the
  step's equilibrium, which a wrong solve, a skipped update or an altered
  ``Du`` breaks.  The scale is the schedule's, not the step's: the first
  step's pressure is zero;
* ``stress``: the widest gap between the program's stress and the
  reference's at that ``Du``, over the larger of the largest reference
  stress and the yield stress (at zero pressure every stress is of
  rounding size): the constitutive layer and the state it was handed,
  which a wrong return map, a stale stress or a stale ``p`` breaks.  Where
  two kept steps follow one another (their ``serial`` numbers, the entry's
  count of steps, differ by one), the state the later one was handed is
  held to the reference's outcome of the earlier: its ``sigma_n`` against
  the reference's stress, its ``p`` against the earlier ``p`` plus the
  reference's ``dp``, that gap times the hardening modulus (the yield
  stress it moves), both over the earlier step's scale.  So a step that
  left ``p`` or the stress it hands on unchanged fails, though each step
  alone agrees with the reference from what it was handed.

A number that is not finite reads as infinite.
"""

from __future__ import annotations

import math

import torch

from .judge import _finite_max
from .slope import internal_force, strain
from .von_mises import return_map

F64 = torch.float64


def judge_steps(cyl, arrays, mat, steps):
    """``steps``: dicts of ``load`` (a fraction of ``q_lim``), ``sigma_n``
    and ``sigma`` (nc * nq * 4 values, point-major), ``p`` (nc * nq),
    ``Du`` (n,) and, optionally, ``serial``, on one device.  Returns
    ``{"residual": .., "stress": ..}``, the widest over the steps."""
    if not steps:
        return {"residual": math.inf, "stress": math.inf}
    shape = (cyl.n_cells, cyl.nq, 4)
    q_lim = mat.q_lim(cyl.R_i, cyl.R_e)
    bc, f = arrays["bc"], arrays["f"]
    scale = q_lim * torch.linalg.vector_norm(f)
    residuals, gaps, outcome = [], [], {}
    for s in steps:
        Du = s["Du"].to(F64)
        deps = strain(arrays, Du).reshape(-1, 4).T
        sig_ref, dp_ref, _ = return_map(mat, deps, s["sigma_n"].reshape(-1, 4).T,
                                        s["p"].reshape(-1))
        sig_ref = sig_ref.T.reshape(shape)
        r = internal_force(arrays, sig_ref) - s["load"] * q_lim * f
        residuals.append(torch.linalg.vector_norm(torch.where(bc, Du, r)) / scale)
        stress_scale = max(float(sig_ref.abs().max()), mat.sigma_0)
        gap = (s["sigma"].to(F64).reshape(shape) - sig_ref).abs().max()
        gaps.append(gap / stress_scale)
        if s.get("serial") is not None:
            outcome[s["serial"]] = (sig_ref, s["p"].to(F64).reshape(-1) + dp_ref, stress_scale)
    for s in steps:
        before = outcome.get(s["serial"] - 1) if s.get("serial") is not None else None
        if before is not None:
            sig_before, p_before, stress_scale = before
            handed = torch.maximum(
                (s["sigma_n"].to(F64).reshape(shape) - sig_before).abs().max(),
                mat.H * (s["p"].to(F64).reshape(-1) - p_before).abs().max())
            gaps.append(handed / stress_scale)
    return {"residual": _finite_max(residuals), "stress": _finite_max(gaps)}
