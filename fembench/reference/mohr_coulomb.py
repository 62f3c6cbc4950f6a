"""The Mohr-Coulomb return map with Abbo-Sloan smoothing and its consistent
tangent, in plain PyTorch at any float precision.

What it computes is the material's definition, not the program's
algorithm: per Gauss point the trial stress ``sigma_tr = sigma_n + C deps``;
where the yield value ``f(sigma_tr) > 0`` the pair ``(sigma, dlambda)``
that solves

    sigma - sigma_n - C (deps - dlambda dg/dsigma(sigma)) = 0,   f(sigma) = 0

by a damped Newton iteration from the trial state (each step the first of
six step lengths that lowers the residual, else the shortest), in the
precision asked for, down to ``tol`` of the point's scale, or until the
residual has stopped falling; elsewhere the trial stress.  The tangent is
``d sigma / d deps`` of that solution (the implicit-function theorem).
The surface is the smoothed Mohr-Coulomb surface of Abbo and Sloan (1995)
with a hyperbolic apex, its constants and closed-form gradient frozen from
the program's plain version (``ops/abbo_sloan.py``), with the Lode-angle
trig taken in the working precision.  It imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

ALPHAS = (1.0, 0.5, 0.25, 0.0625, 2.0**-6, 2.0**-10)
# a point stops once its residual has not fallen below its least for this
# many iterations in a row
PATIENCE = 5


class Material:
    """The configuration's material: E, nu, c, the friction, dilatancy and
    transition angles in degrees, and the apex parameter ``a`` (default
    0.26 c / tan(phi))."""

    def __init__(self, E, nu, c, phi_deg, psi_deg, theta_T_deg, a=None):
        phi, psi, theta_T = (v * np.pi / 180 for v in (phi_deg, psi_deg, theta_T_deg))
        self.c = c
        a_f = 0.26 * c / np.tan(phi) if a is None else a
        a_g = a_f * np.tan(phi) / np.tan(psi)
        lmbda = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
        mu = E / (2.0 * (1.0 + nu))
        self.C = np.array([[lmbda + 2 * mu, lmbda, lmbda, 0.0],
                           [lmbda, lmbda + 2 * mu, lmbda, 0.0],
                           [lmbda, lmbda, lmbda + 2 * mu, 0.0],
                           [0.0, 0.0, 0.0, 2 * mu]])
        self.yield_k = surface_constants(c, phi, a_f, theta_T)
        self.potential_k = surface_constants(c, psi, a_g, theta_T)

    @classmethod
    def from_config(cls, mat, cohesion_factor=1.0):
        return cls(mat["E"], mat["nu"], mat["c"] * cohesion_factor, mat["phi_deg"],
                   mat["psi_deg"], mat["theta_T_deg"], mat.get("a"))


def surface_constants(c, angle, a_coef, theta_T):
    """The constants of one smoothed surface (frozen from the program's
    ``ops/abbo_sloan.py::surface_constants``)."""
    sin_a = float(np.sin(angle))
    inv_sqrt3 = float(1.0 / np.sqrt(3.0))
    cosT, sinT = float(np.cos(theta_T)), float(np.sin(theta_T))
    cos3T, sin3T = float(np.cos(3 * theta_T)), float(np.sin(3 * theta_T))
    cos6T, sin6T = float(np.cos(6 * theta_T)), float(np.sin(6 * theta_T))
    denom = float(18.0 * cos3T**3)

    def abc(sgn):
        c1 = cosT - sin_a * sinT * inv_sqrt3
        c2 = sgn * sinT + sin_a * cosT * inv_sqrt3
        Cc = (-cos3T * c1 - 3.0 * sgn * sin3T * c2) / denom
        Bc = (sgn * sin6T * c1 - 6.0 * cos6T * c2) / denom
        Ac = -(sin_a * inv_sqrt3) * sgn * sinT - Bc * sgn * sin3T - Cc * sin3T**2 + cosT
        return float(Ac), float(Bc), float(Cc)

    (Ap, Bp, Cp), (Am, Bm, Cm) = abc(1.0), abc(-1.0)
    return {"sin_a": sin_a, "c_cos_a": float(c * np.cos(angle)),
            "asa2": float((a_coef * sin_a) ** 2), "inv_sqrt3": inv_sqrt3,
            "c0": float(3.0 * np.sqrt(3.0) / 2.0), "sinT": sinT, "sin3T": sin3T,
            "Ap": Ap, "Bp": Bp, "Cp": Cp, "Am": Am, "Bm": Bm, "Cm": Cm}


def _dev(v):
    d23, d13 = 2.0 / 3.0, -1.0 / 3.0
    return torch.stack([d23 * v[0] + d13 * v[1] + d13 * v[2],
                        d13 * v[0] + d23 * v[1] + d13 * v[2],
                        d13 * v[0] + d13 * v[1] + d23 * v[2], v[3]])


def surface(k, sigma):
    """``(f, df/dsigma)`` of the surface with constants ``k`` at stresses
    ``(4, *batch)``, in their precision."""
    dt = sigma.dtype
    eps = 1e-12 if dt == torch.float64 else 1e-6
    one = torch.ones((), dtype=dt, device=sigma.device)
    zero = torch.zeros((), dtype=dt, device=sigma.device)
    s = _dev(sigma)
    I1 = sigma[0] + sigma[1] + sigma[2]
    J2 = 0.5 * (s[0] * s[0] + s[1] * s[1] + s[2] * s[2] + s[3] * s[3])
    safe = J2 > 0.0
    J2s = torch.where(safe, J2, one)
    J3 = s[2] * (s[0] * s[1] - s[3] * s[3] / 2.0)
    inv32 = 1.0 / (J2s * torch.sqrt(J2s))
    arg = torch.where(safe, -k["c0"] * J3 * inv32, zero)
    x = torch.clamp(arg, -1.0 + eps, 1.0 - eps)
    theta = torch.asin(x) / 3.0
    st, ct = torch.sin(theta), torch.cos(theta)
    c3t = torch.sqrt(1.0 - x * x)
    pos = x >= 0.0

    def pick(a, b):
        return torch.where(pos, torch.tensor(k[a], dtype=dt, device=sigma.device),
                           torch.tensor(k[b], dtype=dt, device=sigma.device))

    Ac, Bc, Cc = pick("Ap", "Am"), pick("Bp", "Bm"), pick("Cp", "Cm")
    sa, is3 = k["sin_a"], k["inv_sqrt3"]
    outer = torch.abs(x) > k["sin3T"]
    K = torch.where(outer, Ac + (Bc + Cc * x) * x, ct - sa * st * is3)
    dK = torch.where(outer, Bc + 2.0 * Cc * x, (-st - sa * ct * is3) / (3.0 * c3t))
    Q = torch.sqrt(J2 * K * K + k["asa2"])
    f = I1 / 3.0 * sa + Q - k["c_cos_a"]
    dJ3 = _dev(torch.stack([s[1] * s[2], s[0] * s[2], s[0] * s[1] - s[3] * s[3] / 2.0,
                            -s[2] * s[3]]))
    dx = torch.where(safe & (torch.abs(arg) < 1.0 - eps),
                     -k["c0"] * (dJ3 - 1.5 * (J3 / J2s) * s) * inv32, zero)
    tr = torch.tensor([sa / 3.0, sa / 3.0, sa / 3.0, 0.0], dtype=dt, device=sigma.device)
    tr = tr.reshape((4,) + (1,) * (sigma.dim() - 1))
    df = tr + (K * K * s + (2.0 * J2 * K * dK) * dx) / (2.0 * torch.clamp(Q, min=1e-30))
    return f, df


def _hessian(k, sigma):
    """``d^2 g / d sigma^2`` (4, 4, n): forward derivatives of the gradient
    in the four basis directions."""
    n = sigma.shape[1]
    s4 = sigma.unsqueeze(1).expand(4, 4, n).contiguous()
    t4 = torch.eye(4, dtype=sigma.dtype, device=sigma.device)[:, :, None].expand(4, 4, n)
    _, H = torch.func.jvp(lambda s: surface(k, s)[1], (s4,), (t4.contiguous(),))
    return H


def _residual(mat, C, y, d, sn):
    """Plastic residual of ``y = (sigma, dlambda)`` (5, *batch)."""
    sig, dl = y[:4], y[4]
    _, dg = surface(mat.potential_k, sig)
    f, _ = surface(mat.yield_k, sig)
    rg = sig - sn - torch.einsum("ij,j...->i...", C, d - dl * dg)
    return torch.cat([rg, f.unsqueeze(0)])


def _jacobian(mat, C, y):
    """(n, 5, 5) Jacobian of the plastic residual."""
    sig, dl = y[:4], y[4]
    n = sig.shape[1]
    _, dg = surface(mat.potential_k, sig)
    _, df = surface(mat.yield_k, sig)
    Hg = _hessian(mat.potential_k, sig)
    J = torch.zeros((n, 5, 5), dtype=sig.dtype, device=sig.device)
    J[:, :4, :4] = (torch.eye(4, dtype=sig.dtype, device=sig.device)[:, :, None]
                    + dl * torch.einsum("ij,jk...->ik...", C, Hg)).permute(2, 0, 1)
    J[:, :4, 4] = (C @ dg).T
    J[:, 4, :4] = df.T
    return J


def return_map(mat, deps, sigma_n, dtype=torch.float64, tol=1e-12, count_tol=1e-8,
               max_it=100, tangent=True):
    """Stress (4, n), tangent (4, 4, n) or None, and per point the Newton
    iterations taken, those taken until the residual first fell below
    ``count_tol`` of the point's scale, and whether it reached ``tol``.
    ``deps``, ``sigma_n``: (4, n) of any float type, computed in ``dtype``."""
    dev = deps.device
    d, sn = deps.to(dtype), sigma_n.to(dtype)
    n = d.shape[1]
    C = torch.as_tensor(mat.C, dtype=dtype, device=dev)
    Cd = C @ d
    sig_tr = sn + Cd
    f_tr, _ = surface(mat.yield_k, sig_tr)
    plastic = f_tr > 0.0
    scale = torch.clamp(torch.sqrt((Cd * Cd).sum(0) + torch.where(plastic, f_tr, 0.0) ** 2),
                        min=1e-30)
    y = torch.cat([sig_tr, torch.zeros((1, n), dtype=dtype, device=dev)])
    iters = torch.zeros(n, dtype=torch.int64, device=dev)
    counted = torch.zeros(n, dtype=torch.int64, device=dev)
    reached = ~plastic
    alph = torch.tensor(ALPHAS, dtype=dtype, device=dev).reshape(1, -1, 1)
    idx = torch.nonzero(plastic).squeeze(1)
    y_a, d_a, sn_a = y[:, idx], d[:, idx], sn[:, idx]
    r_a = _residual(mat, C, y_a, d_a, sn_a)
    nrm = torch.sqrt((r_a * r_a).sum(0))
    least, stale = nrm.clone(), torch.zeros_like(idx)
    below = nrm / scale[idx] <= count_tol
    for _ in range(max_it):
        if idx.numel() == 0:
            break
        dy = torch.linalg.solve_ex(_jacobian(mat, C, y_a), -r_a.T)[0].T
        ys = y_a.unsqueeze(1) + alph * dy.unsqueeze(1)  # (5, na, m)
        m = ys.shape[2]
        rc = _residual(mat, C, ys, d_a.unsqueeze(1), sn_a.unsqueeze(1))
        norms = torch.sqrt((rc * rc).sum(0))
        better = norms < nrm
        first = torch.argmax(better.to(torch.int64), dim=0)
        pick = torch.where(better.any(0), first, torch.full_like(first, len(ALPHAS) - 1))
        ar = torch.arange(m, device=dev)
        y_a, r_a, new = ys[:, pick, ar], rc[:, pick, ar], norms[pick, ar]
        iters[idx] += 1
        counted[idx] += (~below).to(torch.int64)
        rel = new / scale[idx]
        below = below | (rel <= count_tol)
        ok = rel <= tol
        stale = torch.where(new < least, 0, stale + 1)
        least = torch.minimum(least, new)
        stop = ok | (stale >= PATIENCE) | ~torch.isfinite(new)
        nrm = new
        y[:, idx] = y_a
        reached[idx] = ok
        keep = ~stop
        idx, y_a, r_a, nrm, below = idx[keep], y_a[:, keep], r_a[:, keep], nrm[keep], below[keep]
        d_a, sn_a, least, stale = d_a[:, keep], sn_a[:, keep], least[keep], stale[keep]
    sig = y[:4]
    C_t = None
    if tangent:
        C_t = C.unsqueeze(-1).expand(4, 4, n).clone()
        pidx = torch.nonzero(plastic).squeeze(1)
        if pidx.numel():
            rhs = torch.cat([C, torch.zeros((1, 4), dtype=dtype, device=dev)])
            X = torch.linalg.solve_ex(_jacobian(mat, C, y[:, pidx]),
                                      rhs.expand(pidx.numel(), 5, 4))[0]
            C_t[:, :, pidx] = X[:, :4, :].permute(1, 2, 0)
    return sig, C_t, iters, counted, reached
