"""The plasticity block of the main path, without the form layer.

A 1.2 x 1.0 rectangle of ``Nx x Ny`` right-diagonal triangles, P2 vector
displacements, degree-2 stress quadrature, bottom and right edges clamped:
the block that ``__graft_entry__.py:35-58`` and ``bench.py:103-121`` build
through the JAX package (25 x 25: 5,202 dofs, 1,250 cells, 3,750 Gauss
points).  It is also the slope of the Mohr-Coulomb slope-stability problem
(``models/mohr_coulomb.py::build_slope_problem`` in the JAX package: same
geometry, same clamped edges, gravity along -y scaled by the load).
"""

from __future__ import annotations

import numpy as np

from .assembly import locate_dofs_geometrical
from .elements import quadrature_element
from .functionspace import functionspace
from .mesh import create_rectangle

__all__ = ["SLOPE_LOADS", "build_plasticity_block", "mohr_coulomb_slope_step",
           "von_mises_block_step"]

# the slope-stability load schedule (reference :708-733, bench.py:579):
# 50 steps of gamma in [2, 22.9], then 22.96 and 22.99
SLOPE_LOADS = np.concatenate([np.linspace(2, 22.9, 50), [22.96, 22.99]])


def build_plasticity_block(Nx, Ny):
    """(mesh, V, S, bc_dofs) of the clamped plasticity block."""
    mesh = create_rectangle((0.0, 0.0), (1.2, 1.0), (Nx, Ny), "triangle")
    V = functionspace(mesh, ("Lagrange", 2, (2,)))
    S = functionspace(mesh, quadrature_element(mesh.cell_name(), degree=2, value_shape=(4,)))
    bottom = locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0))
    right = locate_dofs_geometrical(V, lambda x: np.isclose(x[0], 1.2))
    bc_dofs = np.concatenate([np.concatenate([s * 2, s * 2 + 1]) for s in (bottom, right)])
    return mesh, V, S, bc_dofs


def von_mises_block_step(Nx, Ny, kernel="f64", device=None, **opts):
    """The von Mises fused step on the block: ``kernel="f64"`` is the plain
    f64 return map (the parity path), ``"f32"`` the hand-written kernel.
    ``opts`` go to ``FusedPlasticityStep`` (solver, tolerances)."""
    from .models.von_mises import batched_kernel_f32, batched_kernel_f64
    from .parallel.spmd import FusedPlasticityStep

    kernels = {"f64": batched_kernel_f64, "f32": batched_kernel_f32}
    if kernel not in kernels:
        raise ValueError(f"kernel must be 'f64' or 'f32', got {kernel!r}")
    mesh, V, S, bc_dofs = build_plasticity_block(Nx, Ny)
    return FusedPlasticityStep(mesh, V, S, kernels[kernel](), bc_dofs, device=device, **opts)


def mohr_coulomb_slope_step(Nx, Ny, route="cuda", device=None, linear_solver="auto",
                            dense_refine=2, **opts):
    """The Mohr-Coulomb fused load step on the slope with the reference
    material (``MohrCoulombMaterial()``): the main path.

    Any ``Nx x Ny``: 25 x 25 is the main path (5,202 dofs), 100 x 100 the
    scaling record's size (80,802 dofs, 60,000 Gauss points).
    ``route="cuda"`` evaluates the return map with the hand-written kernel
    (its plain version on the CPU), ``"plain"`` with the plain f64 PyTorch
    version everywhere.  ``linear_solver="auto"`` resolves to the dense
    solver up to 10k dofs, to block-cyclic reduction (``"bcr"``) up to
    130k, and to AMG-preconditioned CG (``"mg"``) above that.  ``"mg"``
    runs at any size; ``"elastic"`` (CG preconditioned by the lagged
    elastic inverse) holds an n x n f32 inverse.  ``opts`` go to
    ``FusedPlasticityStep`` (tolerances, ``mg_opts``, ``fused_forcing``).

    ``dense_refine`` applies to the dense solver only; the other solvers
    refine until the residual is ``cg_rtol`` of the right-hand side.  The
    dense path refines its f32 solve twice, where the JAX package's
    default is once: step 1 of the schedule is linear, and after one round
    its residual sits next to the Newton tolerance (atol 1e-8), under it
    with the CPU's f32 LU and over it with the card's f32 Cholesky, which
    then takes a second update where the record has one (PERF.md,
    ``chip_smoke.py`` phase 6).  A second round clears it on both."""
    from .models.mohr_coulomb import MohrCoulombMaterial
    from .parallel.spmd import FusedPlasticityStep

    kernel = MohrCoulombMaterial().batched_kernel(route)
    mesh, V, S, bc_dofs = build_plasticity_block(Nx, Ny)
    return FusedPlasticityStep(mesh, V, S, kernel, bc_dofs, device=device,
                               linear_solver=linear_solver, dense_refine=dense_refine, **opts)
