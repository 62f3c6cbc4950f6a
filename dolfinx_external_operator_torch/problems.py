"""The plasticity block of the main path, without the form layer.

A 1.2 x 1.0 rectangle of ``Nx x Ny`` right-diagonal triangles, P2 vector
displacements, degree-2 stress quadrature, bottom and right edges clamped:
the block that ``__graft_entry__.py:35-58`` and ``bench.py:103-121`` build
through the JAX package (25 x 25: 5,202 dofs, 1,250 cells, 3,750 Gauss
points).
"""

from __future__ import annotations

import numpy as np

from .assembly import locate_dofs_geometrical
from .elements import quadrature_element
from .functionspace import functionspace
from .mesh import create_rectangle

__all__ = ["build_plasticity_block", "von_mises_block_step"]


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
