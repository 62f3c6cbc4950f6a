"""Abbo-Sloan smoothed Mohr-Coulomb surface with closed-form derivatives.

The port of ``dolfinx_external_operator_tpu/ops/abbo_sloan.py::
make_surface`` (``:36-167``) as plain PyTorch on batches with the stress
axis FIRST: ``sigma`` is ``(4, *batch)`` in Mandel notation
``[sxx, syy, szz, sqrt2*sxy]``, and every output keeps the batch axes last
(SoA).  The value and gradient share one (arcsin, sin, cos) set per
evaluation, as in the JAX package:

  * sin(3*theta) == x  and  cos(3*theta) == sqrt(1 - x^2),

so the outer branch is polynomial in x and only the inner branch needs the
trig of theta itself.  In f64 that trig comes from an f32 seed, gradient-
stopped (``detach``), and two f64 triple-angle Newton steps.

Every scalar constant is a Python float, so the f32 variant stays f32
(PyTorch casts a Python scalar to the tensor's dtype, as JAX's weak types
do), and every constant combination the JAX package folds in Python
(``sin_a / 3.0``, ``-1.0 + eps_clip``) is folded in Python here too.

``surface_constants`` gives the f64 constants that the CUDA kernel
(``csrc/mohr_coulomb.cuh``) receives and casts to its working type.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.func

__all__ = ["grad_and_hess", "make_surface", "surface_constants"]


def surface_constants(c, angle, a_coef, theta_T):
    """The host-side constants of one surface, as Python floats, computed
    exactly as ``abbo_sloan.py:61-83`` computes them."""
    sin_a = float(np.sin(angle))
    inv_sqrt3 = float(1.0 / np.sqrt(3.0))
    cosT, sinT = float(np.cos(theta_T)), float(np.sin(theta_T))
    cos3T, sin3T = float(np.cos(3 * theta_T)), float(np.sin(3 * theta_T))
    cos6T, sin6T = float(np.cos(6 * theta_T)), float(np.sin(6 * theta_T))
    denom = float(18.0 * cos3T**3)

    def _abc(sgn):
        c1 = cosT - sin_a * sinT * inv_sqrt3
        c2 = sgn * sinT + sin_a * cosT * inv_sqrt3
        Cc = (-cos3T * c1 - 3.0 * sgn * sin3T * c2) / denom
        Bc = (sgn * sin6T * c1 - 6.0 * cos6T * c2) / denom
        Ac = -(sin_a * inv_sqrt3) * sgn * sinT - Bc * sgn * sin3T - Cc * sin3T**2 + cosT
        return float(Ac), float(Bc), float(Cc)

    Ap, Bp, Cp = _abc(1.0)
    Am, Bm, Cm = _abc(-1.0)
    return {
        "sin_a": sin_a,
        "c_cos_a": float(c * np.cos(angle)),
        "asa2": float((a_coef * sin_a) ** 2),
        "inv_sqrt3": inv_sqrt3,
        "c0": float(3.0 * np.sqrt(3.0) / 2.0),
        "sinT": sinT,
        "sin3T": sin3T,
        "Ap": Ap, "Bp": Bp, "Cp": Cp,
        "Am": Am, "Bm": Bm, "Cm": Cm,
    }


def _dev(v):
    """DEV @ v over the leading axis, DEV's entries rounded to v's dtype
    (the products by 0 of ``DEV @ v`` are left out)."""
    d23, d13 = 2.0 / 3.0, -1.0 / 3.0
    return torch.stack([d23 * v[0] + d13 * v[1] + d13 * v[2],
                        d13 * v[0] + d23 * v[1] + d13 * v[2],
                        d13 * v[0] + d13 * v[1] + d23 * v[2],
                        v[3]])


def make_surface(c, angle, a_coef, theta_T, dtype):
    """Evaluators of one smoothed surface in ``dtype`` (float32 or float64).

    Returns ``terms(sigma) -> (f, grad_f)`` with ``f`` of shape ``batch``
    and ``grad_f`` ``(4, *batch)``, and ``hess(sigma) -> (4, 4, *batch)``,
    the forward-mode derivative of the closed-form gradient (what
    ``jax.jacfwd`` of it gives): ``hess[i, k] = d grad_f[i] / d sigma[k]``.
    """
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")
    f64 = dtype == torch.float64
    eps_clip = 1e-12 if f64 else 1e-6
    k = surface_constants(c, angle, a_coef, theta_T)
    sin_a, c_cos_a, asa2 = k["sin_a"], k["c_cos_a"], k["asa2"]
    inv_sqrt3, c0, sinT, sin3T = k["inv_sqrt3"], k["c0"], k["sinT"], k["sin3T"]
    Ap, Bp, Cp, Am, Bm, Cm = (k[n] for n in ("Ap", "Bp", "Cp", "Am", "Bm", "Cm"))
    lo, hi = -1.0 + eps_clip, 1.0 - eps_clip
    q_floor = 1e-30 if f64 else 1e-20
    sin_a_3 = sin_a / 3.0

    if f64:
        def _sincos_third(x):
            # f32 seed with no tangent (stop_gradient), clamped to the inner
            # branch range, then two f64 triple-angle Newton steps
            s0 = torch.sin(torch.asin(x.detach().to(torch.float32)) * (1.0 / 3.0))
            s0 = torch.clamp(s0.to(dtype), -sinT, sinT)

            def newton(s):
                return s - (3.0 * s - 4.0 * s * s * s - x) / (3.0 - 12.0 * s * s)

            st = newton(newton(s0))
            return st, torch.sqrt(1.0 - st * st)
    else:
        def _sincos_third(x):
            theta = torch.asin(x) * (1.0 / 3.0)
            return torch.sin(theta), torch.cos(theta)

    def _const(v, like):
        return torch.tensor(v, dtype=dtype, device=like.device)

    def terms(sigma):
        if sigma.dtype != dtype:
            raise TypeError(f"sigma must be {dtype}, got {sigma.dtype}")
        s = _dev(sigma)
        I1 = sigma[0] + sigma[1] + sigma[2]
        J2 = 0.5 * (s[0] * s[0] + s[1] * s[1] + s[2] * s[2] + s[3] * s[3])
        safe = J2 > 0.0
        J2s = torch.where(safe, J2, _const(1.0, J2))
        J3 = s[2] * (s[0] * s[1] - s[3] * s[3] / 2.0)
        sqJ2 = torch.sqrt(J2s)
        invJ2_32 = 1.0 / (J2s * sqJ2)
        arg_raw = torch.where(safe, -c0 * J3 * invJ2_32, _const(0.0, J2))
        # clip as jnp.clip: maximum, then minimum (half tangents at ties)
        x = torch.minimum(torch.maximum(arg_raw, _const(lo, J2)), _const(hi, J2))

        st, ct = _sincos_third(x)
        c3t = torch.sqrt(1.0 - x * x)

        pos = x >= 0.0
        Ac = torch.where(pos, _const(Ap, x), _const(Am, x))
        Bc = torch.where(pos, _const(Bp, x), _const(Bm, x))
        Cc = torch.where(pos, _const(Cp, x), _const(Cm, x))

        K_in = ct - sin_a * st * inv_sqrt3
        K_out = Ac + (Bc + Cc * x) * x
        dKin_dx = (-st - sin_a * ct * inv_sqrt3) / (3.0 * c3t)
        dKout_dx = Bc + 2.0 * Cc * x
        outer = torch.abs(x) > sin3T
        K = torch.where(outer, K_out, K_in)
        dK_dx = torch.where(outer, dKout_dx, dKin_dx)

        Q = torch.sqrt(J2 * K * K + asa2)
        f = I1 / 3.0 * sin_a + Q - c_cos_a

        dJ3 = _dev(torch.stack([s[1] * s[2], s[0] * s[2],
                                s[0] * s[1] - s[3] * s[3] / 2.0, -s[2] * s[3]]))
        unclipped = safe & (torch.abs(arg_raw) < hi)
        darg = -c0 * (dJ3 - 1.5 * (J3 / J2s) * s) * invJ2_32
        dx = torch.where(unclipped, darg, _const(0.0, darg))
        Qs = torch.maximum(Q, _const(q_floor, Q))
        tr = torch.tensor([sin_a_3, sin_a_3, sin_a_3, 0.0], dtype=dtype, device=sigma.device)
        tr = tr.reshape((4,) + (1,) * (sigma.dim() - 1))
        df = tr + (K * K * s + (2.0 * J2 * K * dK_dx) * dx) / (2.0 * Qs)
        return f, df

    def hess(sigma):
        return grad_and_hess(terms, sigma)[1]

    return terms, hess


def grad_and_hess(terms, sigma):
    """``(grad_f (4, *batch), hess (4, 4, *batch))`` of a surface's
    ``terms``: one ``torch.func.jvp`` of the closed-form gradient with the
    four basis tangents stacked on a new axis after the stress axis, so one
    pass carries all four directions."""
    shape = (4, 4) + tuple(sigma.shape[1:])
    s4 = sigma.unsqueeze(1).expand(shape).contiguous()
    eye = torch.eye(4, dtype=sigma.dtype, device=sigma.device)
    t4 = eye.reshape((4, 4) + (1,) * (sigma.dim() - 1)).expand(shape).contiguous()
    df4, H = torch.func.jvp(lambda s: terms(s)[1], (s4,), (t4,))
    return df4[:, 0], H
