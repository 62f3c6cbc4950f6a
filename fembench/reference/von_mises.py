"""J2 (von Mises) plasticity with linear isotropic hardening: the return map
and its consistent tangent in plain PyTorch at any float precision, on
plane-strain Mandel 4-vectors ``[xx, yy, zz, sqrt2 xy]``, the Gauss-point
axis last.

What it computes is the material's definition: the trial stress
``sigma_tr = sigma_n + K tr(deps) 1 + 2 mu dev(deps)``; with
``s = dev(sigma_tr)`` and ``q = sqrt(3/2 s . s)``, the point yields where
``f = q - sigma_0 - H p_n > 0``, and then the radial return gives
``dp = f / (3 mu + H)`` and ``sigma = sigma_tr - 3 mu dp s / q``; elsewhere
``sigma = sigma_tr`` and ``dp = 0``.  Hardening modulus
``H = E E_t / (E - E_t)``.  The tangent ``d sigma / d deps`` at a yielding
point is ``K 1 x 1 + 2 mu (1 - b) I_dev - 2 mu (g - b) nh x nh`` with
``b = 3 mu dp / q``, ``g = 3 mu / (3 mu + H)`` and the unit deviatoric
direction ``nh = s / |s|`` (Simo and Hughes, Computational Inelasticity,
box 3.2).  It imports nothing of the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Material:
    """The configuration's material: E, nu, the tangent modulus E_t and
    the yield stress sigma_0."""

    def __init__(self, E, nu, E_t, sigma_0):
        self.E, self.nu, self.E_t, self.sigma_0 = E, nu, E_t, sigma_0
        self.K = E / (3.0 * (1.0 - 2.0 * nu))
        self.mu = E / (2.0 * (1.0 + nu))
        self.H = E * E_t / (E - E_t)

    @classmethod
    def from_config(cls, mat, yield_factor=1.0):
        return cls(mat["E"], mat["nu"], mat["E_t"], mat["sigma_0"] * yield_factor)

    def q_lim(self, R_i, R_e):
        """The thick cylinder's limit pressure (perfect plasticity)."""
        return 2.0 / math.sqrt(3.0) * self.sigma_0 * math.log(R_e / R_i)

    def elastic(self, dtype=torch.float64, device=None):
        """The elastic stiffness (4, 4)."""
        one = torch.tensor([1.0, 1.0, 1.0, 0.0], dtype=dtype, device=device)
        return (self.K * torch.outer(one, one)
                + 2.0 * self.mu * _dev_projector(dtype, device))


def _dev_projector(dtype, device):
    I_dev = np.eye(4)
    I_dev[:3, :3] -= 1.0 / 3.0
    return torch.as_tensor(I_dev, dtype=dtype, device=device)


def _dev(v):
    """The deviator of Mandel 4-vectors (4, n)."""
    mean = v[:3].sum(0) / 3.0
    return torch.cat([v[:3] - mean, v[3:]])


def return_map(mat, deps, sigma_n, p_n, dtype=torch.float64, tangent=False):
    """``(sigma (4, n), dp (n,), tangent (4, 4, n) or None)`` of strain
    increments ``deps`` (4, n) from the stresses ``sigma_n`` (4, n) and
    hardening variables ``p_n`` (n,), computed in ``dtype``."""
    deps, sigma_n, p_n = (t.to(dtype) for t in (deps, sigma_n, p_n))
    K, mu, H = mat.K, mat.mu, mat.H
    tr = deps[:3].sum(0)
    sig_tr = sigma_n + _dev(deps) * (2.0 * mu)
    sig_tr = torch.cat([sig_tr[:3] + K * tr, sig_tr[3:]])
    s = _dev(sig_tr)
    q = torch.sqrt(1.5 * (s * s).sum(0))
    f = q - mat.sigma_0 - H * p_n
    yields = f > 0.0
    dp = torch.where(yields, f / (3.0 * mu + H), torch.zeros_like(f))
    q_safe = torch.where(yields, q, torch.ones_like(q))
    b = torch.where(yields, 3.0 * mu * dp / q_safe, torch.zeros_like(q))
    sigma = sig_tr - b * s
    if not tangent:
        return sigma, dp, None
    C = mat.elastic(dtype, deps.device)[:, :, None]
    g = 3.0 * mu / (3.0 * mu + H)
    s_norm = torch.sqrt((s * s).sum(0))
    nh = s / torch.where(yields, s_norm, torch.ones_like(s_norm))
    C_t = (C - 2.0 * mu * b * _dev_projector(dtype, deps.device)[:, :, None]
           - 2.0 * mu * torch.where(yields, g - b, torch.zeros_like(b)) * nh[:, None] * nh[None, :])
    return sigma, dp, C_t
