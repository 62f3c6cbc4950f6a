"""What decides ``correct``: the program's outputs against the plain
reference.

A load step is judged from the state it started from: the stress
``sigma_n`` the step was handed and its load.  From the step's displacement
increment ``Du`` the reference works out the strain with its own mesh, the
stress with its own return map (f64, to 1e-12 of each point's scale) and
the assembled out-of-balance force with its own quadrature.  Two numbers:

* ``residual``: the norm of that force on the free dofs, with ``Du`` itself
  on the clamped ones (the program's own convergence test, whose absolute
  tolerance the configuration states): the step's equilibrium, which a
  wrong solve, a skipped update or an altered ``Du`` breaks;
* ``stress``: the widest gap between the program's stress and the
  reference's at that ``Du``, over the largest reference stress: the
  constitutive layer, which a wrong or partial return map breaks.

A batch of the return map alone is judged point by point: the widest gap of
its stress (over the largest reference stress) and of its tangent (over the
largest elastic modulus).  A number that is not finite reads as infinite.
"""

from __future__ import annotations

import math

import torch

from .mohr_coulomb import return_map
from .slope import internal_force, strain

F64 = torch.float64


def _finite_max(values):
    out = 0.0
    for v in values:
        v = float(v)
        out = math.inf if not math.isfinite(v) else max(out, v)
    return out


def reference_stress(mat, deps, sigma_n, block_points=1 << 20, tangent=False):
    """The reference return map over (n, 4) point-major inputs, in blocks:
    stress (n, 4), tangent (n, 4, 4) or None, and the per-point iterations
    counted to the material's tolerance."""
    sig, tan, counted = [], [], []
    for s in range(0, deps.shape[0], block_points):
        d = deps[s:s + block_points].T.to(F64)
        sn = sigma_n[s:s + block_points].T.to(F64)
        out = return_map(mat, d, sn, tangent=tangent)
        sig.append(out[0].T)
        counted.append(out[3])
        if tangent:
            tan.append(out[1].permute(2, 0, 1))
    return (torch.cat(sig), torch.cat(tan) if tangent else None, torch.cat(counted))


def judge_steps(slope, arrays, mat, steps):
    """``steps``: dicts of ``load``, ``sigma_n`` and ``sigma`` (any shape of
    nc * nq * 4 values, point-major) and ``Du`` (n,), on one device.
    Returns ``{"residual": .., "stress": ..}``, the widest over the steps."""
    if not steps:
        return {"residual": math.inf, "stress": math.inf}
    shape = (slope.n_cells, slope.nq, 4)
    deps = torch.cat([strain(arrays, s["Du"].to(F64)).reshape(-1, 4) for s in steps])
    sn = torch.cat([s["sigma_n"].to(F64).reshape(-1, 4) for s in steps])
    sig_ref = reference_stress(mat, deps, sn)[0].reshape((len(steps),) + shape)
    bc, f = arrays["bc"], arrays["f"]
    residuals, gaps = [], []
    for k, s in enumerate(steps):
        Du = s["Du"].to(F64)
        r = internal_force(arrays, sig_ref[k]) - s["load"] * f
        residuals.append(torch.linalg.vector_norm(torch.where(bc, Du, r)))
        gap = (s["sigma"].to(F64).reshape(shape) - sig_ref[k]).abs().max()
        gaps.append(gap / sig_ref[k].abs().max())
    return {"residual": _finite_max(residuals), "stress": _finite_max(gaps)}


def judge_points(mat, batches, block_points=1 << 20):
    """``batches``: dicts of ``deps``, ``sigma_n`` (4, n), and the program's
    ``sigma`` (4, n) and ``tangent`` (4, 4, n), all of one size.  Returns
    the widest stress and tangent gaps, and the reference's iterations
    counted to the material's tolerance, (batches, n)."""
    if not batches:
        return {"stress": math.inf, "tangent": math.inf}, None
    n = batches[0]["deps"].shape[1]
    sig_ref, tan_ref, counted = reference_stress(
        mat, torch.cat([b["deps"] for b in batches], 1).T,
        torch.cat([b["sigma_n"] for b in batches], 1).T, block_points, tangent=True)
    C_max = float(abs(mat.C).max())
    stress, tangent = [], []
    for k, b in enumerate(batches):
        s_ref, t_ref = sig_ref[k * n:(k + 1) * n], tan_ref[k * n:(k + 1) * n]
        stress.append((b["sigma"].to(F64).T - s_ref).abs().max() / s_ref.abs().max())
        tangent.append((b["tangent"].to(F64).permute(2, 0, 1) - t_ref).abs().max() / C_max)
    return ({"stress": _finite_max(stress), "tangent": _finite_max(tangent)},
            counted.reshape(len(batches), n))
