"""Von Mises J2 plasticity with isotropic hardening: material constants and
batched return maps.

The port of the kernel side of ``dolfinx_external_operator_tpu/models/
von_mises.py`` (constants ``:54-74``, ``_return_mapping_kernel`` ``:83-113``,
``pallas_batched_kernel`` ``:116-142``, ``VonMisesMaterial`` ``:145-160``).
The JAX package writes a per-point kernel and vmaps it; here every map is
written on the batch directly, with the Gauss-point axis LAST (SoA), the
layout of the fused step's kernel contract.  The cylinder-expansion solvers
of that module need the form layer and come with ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.vonmises import vonmises_return_map

__all__ = ["VonMisesMaterial", "batched_kernel_f32", "batched_kernel_f64",
           "return_mapping_kernel"]

# Geometry / material constants of the reference demo (:183-204)
R_E, R_I = 1.3, 1.0
E_MOD, NU = 70e3, 0.3
E_TANGENT = E_MOD / 100.0
H_MOD = E_MOD * E_TANGENT / (E_MOD - E_TANGENT)
SIGMA_0 = 250.0
LAMBDA = E_MOD * NU / (1.0 + NU) / (1.0 - 2.0 * NU)
MU = E_MOD / 2.0 / (1.0 + NU)

C_ELAS = np.array(
    [
        [LAMBDA + 2 * MU, LAMBDA, LAMBDA, 0.0],
        [LAMBDA, LAMBDA + 2 * MU, LAMBDA, 0.0],
        [LAMBDA, LAMBDA, LAMBDA + 2 * MU, 0.0],
        [0.0, 0.0, 0.0, 2 * MU],
    ]
)
DEV4 = np.eye(4)
DEV4[:3, :3] -= 1.0 / 3.0

Q_LIM = float(2.0 / np.sqrt(3.0) * np.log(R_E / R_I) * SIGMA_0)

PARAMS = (LAMBDA, MU, H_MOD, SIGMA_0)


def return_mapping_kernel(deps, sigma_n, p):
    """Analytic return map with consistent tangent, f64, batch last:
    deps/sigma_n (4, N), p (N,) -> (C_tang (4, 4, N), sig (4, N), dp (N,)).
    The formula of the JAX package's ``_return_mapping_kernel``, with the
    same guarded divisions (elastic points get exactly zero plastic terms)."""
    dt, dev = deps.dtype, deps.device
    C = torch.as_tensor(C_ELAS, dtype=dt, device=dev)
    D = torch.as_tensor(DEV4, dtype=dt, device=dev)
    sig_el = sigma_n + C @ deps
    s = D @ sig_el
    sig_eq = torch.sqrt(1.5 * (s * s).sum(0))
    f_el = sig_eq - SIGMA_0 - H_MOD * p
    f_plus = (f_el + torch.sqrt(f_el * f_el)) / 2.0
    dp = f_plus / (3.0 * MU + H_MOD)
    plastic = f_el > 0.0
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    sig_eq_safe = torch.where(sig_eq > 0.0, sig_eq, one)
    n_elas = torch.where(plastic, s / sig_eq_safe * f_plus / torch.where(plastic, f_el, one), zero)
    beta = torch.where(plastic, 3.0 * MU * dp / sig_eq_safe, zero)
    sig = sig_el - beta * s
    C_tang = (
        C[:, :, None]
        - 3.0 * MU * (3.0 * MU / (3.0 * MU + H_MOD) - beta) * (n_elas[:, None, :] * n_elas[None, :, :])
        - 2.0 * MU * beta * D[:, :, None]
    )
    return C_tang, sig, dp


def batched_kernel_f64():
    """The f64 plain kernel in the fused step's SoA contract
    ``(deps (4, n), sigma_n (4, n)) -> (C_tang (4, 4, n), sig (4, n))``,
    with ``p = 0`` (the fused von Mises step carries no hardening state)."""

    def batched(deps_soa, sn_soa):
        p = torch.zeros(deps_soa.shape[1], dtype=deps_soa.dtype, device=deps_soa.device)
        C, sig, _ = return_mapping_kernel(deps_soa, sn_soa, p)
        return C, sig

    return batched


def batched_kernel_f32(tile=512):
    """The hand-written f32 kernel (``ops.vonmises``) in the fused step's
    SoA contract: the counterpart of ``pallas_batched_kernel``.  The batch
    is padded to ``tile`` as the JAX wrapper pads it, cast to f32 and back,
    and ``p = 0``.  An opt-in fast path; the f64 kernel stays the parity
    path."""

    def batched(deps_soa, sn_soa):
        n = deps_soa.shape[1]
        pad = -n % tile
        d32 = F.pad(deps_soa.to(torch.float32), (0, pad)).contiguous()
        s32 = F.pad(sn_soa.to(torch.float32), (0, pad)).contiguous()
        p32 = torch.zeros(n + pad, dtype=torch.float32, device=deps_soa.device)
        C, sig, _ = vonmises_return_map(d32, s32, p32, PARAMS)
        C = C[:, :n].reshape(4, 4, n).to(deps_soa.dtype)
        sig = sig[:, :n].to(deps_soa.dtype)
        return C, sig

    return batched


class VonMisesMaterial:
    """Batched f64 return map with consistent tangent on flat point-major
    arrays, as the JAX package's ``VonMisesMaterial.__call__`` takes them."""

    def __call__(self, deps_flat, sigma_n_flat, p_flat):
        deps = deps_flat.reshape(-1, 4).T
        sn = sigma_n_flat.reshape(-1, 4).T
        p = p_flat.reshape(-1)
        C_tang, sig, dp = return_mapping_kernel(deps, sn, p)
        return C_tang.permute(2, 0, 1).reshape(-1), sig.T.reshape(-1), dp.reshape(-1)
