"""The port's yield-surface tracing: the counterpart of
``tests/test_yield_surface.py`` (reference demo_plasticity_mohr_coulomb.py
:853-994).

Stress paths are made in Haigh-Westergaard coordinates (xi, rho, theta)
with the principal-stress formula.  The port's smoothed Mohr-Coulomb
surface has its zero where the JAX package's has it, and the return map
projects elastic predictors beyond the surface back onto it across the
whole Lode-angle range, the smoothed corners included.  The sweep runs
through the plain map (``MohrCoulombMaterial.return_map``) and through
K1's own body built for the CPU with g++ (``ops.mohr_coulomb.
mc_return_map_host``), and each is held to the JAX package's
``return_mapping`` on the same predictors: sigma within 1e-9 of its
largest entry, the bound ``tests/test_torch_mohr_coulomb.py`` holds the
maps to on the bench mix.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dolfinx_external_operator_tpu.models.mohr_coulomb import MohrCoulombMaterial as MatJ

import dolfinx_external_operator_torch as pt
from dolfinx_external_operator_torch.ops import mohr_coulomb as mc_ops


def principal_to_mandel(sig_principal):
    """Principal stresses (3,) -> Mandel 4-vector [sxx, syy, szz, sqrt2*sxy]
    with the principal axes on x/y (s_xy = 0)."""
    s1, s2, s3 = sig_principal
    return np.array([s1, s2, s3, 0.0])


def haigh_westergaard(xi, rho, theta):
    """Principal stresses from HW coordinates (reference :823-840)."""
    c = np.sqrt(2.0 / 3.0)
    s1 = xi / np.sqrt(3.0) + c * rho * np.cos(theta)
    s2 = xi / np.sqrt(3.0) + c * rho * np.cos(theta - 2.0 * np.pi / 3.0)
    s3 = xi / np.sqrt(3.0) + c * rho * np.cos(theta + 2.0 * np.pi / 3.0)
    return np.array([s1, s2, s3])


@pytest.fixture(scope="module")
def mats():
    return pt.MohrCoulombMaterial(), MatJ()


def _f(mat, sig):
    """The port's yield function at one Mandel stress."""
    return float(mat.f_yield(torch.tensor(sig).reshape(4, 1))[0])


def test_surface_points_have_zero_f(mats):
    """1D Newton in rho finds the surface; f vanishes there, in the port
    and in the JAX package."""
    mat, mat_j = mats
    xi = -5.0
    for theta in np.linspace(-np.pi / 6 + 0.01, np.pi / 6 - 0.01, 9):
        rho = 1.0
        for _ in range(60):
            f = _f(mat, principal_to_mandel(haigh_westergaard(xi, rho, theta)))
            fp = _f(mat, principal_to_mandel(haigh_westergaard(xi, rho + 1e-6, theta)))
            rho_new = rho - f / ((fp - f) / 1e-6)
            if abs(rho_new - rho) < 1e-12:
                rho = rho_new
                break
            rho = max(rho_new, 1e-3)
        sig = principal_to_mandel(haigh_westergaard(xi, rho, theta))
        f_final = _f(mat, sig)
        assert abs(f_final) < 1e-9, (theta, rho, f_final)
        assert abs(float(mat_j.f_yield(jnp.asarray(sig)))) < 1e-9, (theta, rho)


@pytest.fixture(scope="module")
def sweep(mats):
    """Elastic predictors beyond the surface across the Lode range: the
    strain increments (SoA (4, 11)) that elastically produce them from
    zero stress, and the JAX package's return map of each (sigma (11, 4),
    the plastic multiplier (11,))."""
    mat, mat_j = mats
    S_elas = np.linalg.inv(mat.C_elas)
    xi = -6.0
    sigs = [principal_to_mandel(haigh_westergaard(xi, 14.0, theta))
            for theta in np.linspace(-np.pi / 6 + 0.02, np.pi / 6 - 0.02, 11)]
    # the states well beyond the surface at their angle
    sigs = np.array([s for s in sigs if _f(mat, s) > 0.1])
    assert len(sigs) == 11
    deps = sigs @ S_elas.T
    sig_j, aux_j = jax.vmap(mat_j.return_mapping)(jnp.asarray(deps), jnp.zeros_like(deps))
    return torch.tensor(deps.T.copy()), np.asarray(sig_j), np.asarray(aux_j[4])


@pytest.mark.parametrize("impl", ["plain", "kernel_body"])
def test_return_mapping_projects_onto_surface(mats, sweep, impl):
    """Elastic predictors pushed beyond the surface return to f ~= 0 across
    the Lode range (the corner-smoothing region included), with a positive
    plastic multiplier, as the JAX package's return map returns them."""
    mat, _ = mats
    deps, sig_j, dlambda_j = sweep
    zero = torch.zeros_like(deps)
    if impl == "plain":
        sig_ret, _, _, _, dlambda = mat.return_map(deps, zero)
    else:
        _, sig_ret, _, _, _, dlambda = mc_ops.mc_return_map_host(deps, zero, mat)
    f_ret = mat.f_yield(sig_ret).numpy()
    assert np.abs(f_ret).max() < 5e-7, f_ret
    assert bool((dlambda > 0.0).all()) and bool((dlambda_j > 0.0).all())
    gap = np.abs(sig_ret.T.numpy() - sig_j).max(axis=1) / np.abs(sig_j).max()
    assert gap.max() < 1e-9, gap
