"""The slope of the Mohr-Coulomb stability problem, worked out from its
configuration in plain NumPy: mesh, P2 dofs, strain matrices, quadrature
weights, the unit body-force vector and the clamped dofs.

It imports nothing of the program under test.  The layouts are the ones the
program's outputs come in, stated here so that the reference can read them:

* vertices row-major, vertex ``j * (Nx + 1) + i`` at ``(i L / Nx, j H / Ny)``;
* each grid square ``(i, j)``, row by row, split along its right diagonal
  into ``(v00, v10, v11)`` and ``(v00, v11, v01)``;
* P2 scalar dofs: the vertices, then one dof per edge, edges numbered in
  the order in which the cells, in turn, first name them; a cell's
  local order is its three vertices, then its edges opposite vertex 0, 1
  and 2; a vector dof ``2 s + k`` is component ``k`` of scalar dof ``s``;
* the degree-2 triangle rule with points (1/6, 1/6), (2/3, 1/6),
  (1/6, 2/3), weights 1/6; a stress is cell-major, point-major, then its
  four Mandel components ``[sxx, syy, szz, sqrt2 sxy]``.
"""

from __future__ import annotations

import numpy as np
import torch

QPTS = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
QWTS = np.full(3, 1 / 6)
# local edges of a triangle, each opposite one vertex
EDGES = ((1, 2), (0, 2), (0, 1))


def p2_basis(x, y):
    """Values (6,) and reference gradients (6, 2) of the P2 basis at one
    point: vertices, then the edges of ``EDGES``."""
    lam = np.array([1.0 - x - y, x, y])
    dlam = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    vals = [lam[i] * (2 * lam[i] - 1) for i in range(3)]
    grads = [(4 * lam[i] - 1) * dlam[i] for i in range(3)]
    for a, b in EDGES:
        vals.append(4 * lam[a] * lam[b])
        grads.append(4 * (lam[a] * dlam[b] + lam[b] * dlam[a]))
    return np.array(vals), np.array(grads)


class Slope:
    """The clamped ``L x H`` rectangle of ``Nx x Ny`` right-diagonal
    triangles with P2 vector displacements and degree-2 stress points."""

    def __init__(self, Nx, Ny, L=1.2, H=1.0):
        self.Nx, self.Ny, self.L, self.H = Nx, Ny, L, H
        xs, ys = np.linspace(0.0, L, Nx + 1), np.linspace(0.0, H, Ny + 1)
        X, Y = np.meshgrid(xs, ys, indexing="xy")
        verts = np.stack([X.ravel(), Y.ravel()], axis=1)
        nv = verts.shape[0]
        i, j = np.meshgrid(np.arange(Nx), np.arange(Ny), indexing="xy")
        v00 = (j * (Nx + 1) + i).ravel()
        v10, v01, v11 = v00 + 1, v00 + Nx + 1, v00 + Nx + 2
        cells = np.stack([np.stack([v00, v10, v11], 1), np.stack([v00, v11, v01], 1)],
                         axis=1).reshape(-1, 3)
        pairs = np.sort(cells[:, EDGES], axis=-1).reshape(-1, 2)
        uniq, first, inv = np.unique(pairs, axis=0, return_index=True, return_inverse=True)
        rank = np.empty(len(first), np.int64)
        rank[np.argsort(first, kind="stable")] = np.arange(len(first))
        edges, inv = uniq[np.argsort(first, kind="stable")], rank[inv.ravel()]
        sdofs = np.concatenate([cells, nv + inv.reshape(-1, 3)], axis=1)
        self.cells, self.n_cells = cells, cells.shape[0]
        self.n_scalar = nv + edges.shape[0]
        self.n_dofs = 2 * self.n_scalar
        self.dofmap = (np.repeat(sdofs, 2, axis=1) * 2 + np.tile([0, 1], 6)).astype(np.int64)
        coords = np.concatenate([verts, verts[edges].mean(axis=1)])

        # affine geometry: J = [x1 - x0, x2 - x0] as columns
        p = verts[cells]
        J = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], axis=2)  # (nc, 2, 2)
        detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        Jinv_T = np.stack([np.stack([J[:, 1, 1], -J[:, 1, 0]], 1),
                           np.stack([-J[:, 0, 1], J[:, 0, 0]], 1)], 1) / detJ[:, None, None]
        nq = QPTS.shape[0]
        phi = np.zeros((nq, 6))
        B = np.zeros((self.n_cells, nq, 4, 12))
        s2 = np.sqrt(2.0) * 0.5
        for q, (x, y) in enumerate(QPTS):
            phi[q], g = p2_basis(x, y)
            gp = np.einsum("cij,kj->cki", Jinv_T, g)  # (nc, 6, 2) physical
            B[:, q, 0, 0::2] = gp[:, :, 0]
            B[:, q, 1, 1::2] = gp[:, :, 1]
            B[:, q, 3, 0::2] = s2 * gp[:, :, 1]
            B[:, q, 3, 1::2] = s2 * gp[:, :, 0]
        self.nq = nq
        self.n_points = self.n_cells * nq
        self.B = B
        self.w = np.abs(detJ)[:, None] * QWTS[None, :]  # (nc, nq)
        # unit body force (0, -1): f_k = -int phi_k on the y components
        f_cell = np.zeros((self.n_cells, 12))
        f_cell[:, 1::2] = -np.einsum("cq,qk->ck", self.w, phi)
        self.f = np.zeros(self.n_dofs)
        np.add.at(self.f, self.dofmap, f_cell)
        clamped = np.isclose(coords[:, 1], 0.0) | np.isclose(coords[:, 0], L)
        self.bc_mask = np.repeat(clamped, 2)

    def on(self, device, dtype):
        """The arrays that the judge and the control need, as tensors."""
        return {"B": torch.as_tensor(self.B, dtype=dtype, device=device),
                "w": torch.as_tensor(self.w, dtype=dtype, device=device),
                "dofmap": torch.as_tensor(self.dofmap, device=device),
                "f": torch.as_tensor(self.f, dtype=dtype, device=device),
                "bc": torch.as_tensor(self.bc_mask, device=device)}


def strain(arrays, Du):
    """Strain increments (nc, nq, 4) of the displacement increment ``Du``."""
    return torch.einsum("cqik,ck->cqi", arrays["B"], Du[arrays["dofmap"]])


def internal_force(arrays, sigma):
    """The assembled vector of ``int B^T sigma`` over every cell."""
    cell = torch.einsum("cqik,cqi,cq->ck", arrays["B"], sigma, arrays["w"])
    out = torch.zeros(arrays["f"].shape[0], dtype=cell.dtype, device=cell.device)
    return out.index_add_(0, arrays["dofmap"].reshape(-1), cell.reshape(-1))
