"""The quarter annulus of the von Mises thick-cylinder demo, worked out from
its configuration in plain NumPy: mesh, P2 dofs, strain matrices,
quadrature weights, the unit pressure vector of the inner arc and the
clamped dofs.

It imports nothing of the program under test.  The layouts are the ones the
program's outputs come in, stated here so that the reference can read them:

* ``nr = max(1, round((R_e - R_i) / lc))`` rings of
  ``nt = max(4, round(pi / 2 * (R_e + R_i) / 2 / lc))`` sectors; vertex
  ``i * (nt + 1) + j`` at radius ``r_i`` and angle ``theta_j`` (the
  ``linspace`` of ``[R_i, R_e]`` in ``nr + 1`` and of ``[0, pi / 2]`` in
  ``nt + 1`` values), ``(r cos theta, r sin theta)``;
* each ring-sector quad ``(i, j)``, ring by ring, split into
  ``(v(i, j), v(i+1, j), v(i+1, j+1))`` and ``(v(i, j), v(i+1, j+1),
  v(i, j+1))``: straight-sided triangles, so the inner arc is a chain of
  chords;
* P2 scalar dofs: the vertices, then one dof per edge, edges numbered in
  the order in which the cells, in turn, first name them; a cell's local
  order is its three vertices, then its edges opposite vertex 0, 1 and 2;
  a vector dof ``2 s + k`` is component ``k`` of scalar dof ``s``;
* the degree-2 triangle rule with points (1/6, 1/6), (2/3, 1/6),
  (1/6, 2/3), weights 1/6; a stress is cell-major, point-major, then its
  four Mandel components ``[sxx, syy, szz, sqrt2 sxy]``; the hardening
  variable ``p`` cell-major, then point;
* the pressure ``q`` pushes on the inner arc's chords along their normals
  out of the annulus' hole: the load vector is ``q f`` with ``f_k`` the
  integral over the chords of ``-n . phi_k``, ``n`` the outward normal of
  the domain (each chord's exactly: ``L / 6`` at its ends, ``2 L / 3`` at
  its midpoint);
* clamped: ``u_y`` on ``y = 0`` and ``u_x`` on ``x = 0`` (the dofs within
  ``1e-10`` of those lines).
"""

from __future__ import annotations

import numpy as np
import torch

from .slope import EDGES, QPTS, QWTS, p2_basis

TOL = 1e-10


def layout(lc, R_i, R_e):
    """``(rings, sectors)`` of the generator at mesh size ``lc``."""
    nr = max(1, int(round((R_e - R_i) / lc)))
    nt = max(4, int(round((np.pi / 2 * 0.5 * (R_e + R_i)) / lc)))
    return nr, nt


class Cylinder:
    """The clamped quarter annulus with P2 vector displacements and degree-2
    stress points."""

    def __init__(self, lc, R_i=1.0, R_e=1.3):
        self.lc, self.R_i, self.R_e = lc, R_i, R_e
        nr, nt = self.rings, self.sectors = layout(lc, R_i, R_e)
        R, T = np.meshgrid(np.linspace(R_i, R_e, nr + 1), np.linspace(0.0, np.pi / 2, nt + 1),
                           indexing="ij")
        verts = np.stack([(R * np.cos(T)).ravel(), (R * np.sin(T)).ravel()], axis=1)
        nv = verts.shape[0]
        i, j = np.meshgrid(np.arange(nr), np.arange(nt), indexing="ij")
        v0 = (i * (nt + 1) + j).ravel()
        v1, v2, v3 = v0 + nt + 1, v0 + 1, v0 + nt + 2
        cells = np.stack([np.stack([v0, v1, v3], 1), np.stack([v0, v3, v2], 1)],
                         axis=1).reshape(-1, 3)
        pairs = np.sort(cells[:, EDGES], axis=-1).reshape(-1, 2)
        uniq, first, inv = np.unique(pairs, axis=0, return_index=True, return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty(len(first), np.int64)
        rank[order] = np.arange(len(first))
        edges, cell_edges = uniq[order], rank[inv.ravel()].reshape(-1, 3)
        sdofs = np.concatenate([cells, nv + cell_edges], axis=1)
        self.cells, self.n_cells = cells, cells.shape[0]
        self.n_scalar = nv + edges.shape[0]
        self.n_dofs = 2 * self.n_scalar
        self.dofmap = (np.repeat(sdofs, 2, axis=1) * 2 + np.tile([0, 1], 6)).astype(np.int64)
        coords = np.concatenate([verts, verts[edges].mean(axis=1)])

        # affine geometry: J = [x1 - x0, x2 - x0] as columns
        p = verts[cells]
        J = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], axis=2)
        detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        Jinv_T = np.stack([np.stack([J[:, 1, 1], -J[:, 1, 0]], 1),
                           np.stack([-J[:, 0, 1], J[:, 0, 0]], 1)], 1) / detJ[:, None, None]
        nq = QPTS.shape[0]
        B = np.zeros((self.n_cells, nq, 4, 12))
        s2 = np.sqrt(2.0) * 0.5
        for q, (x, y) in enumerate(QPTS):
            _, g = p2_basis(x, y)
            gp = np.einsum("cij,kj->cki", Jinv_T, g)
            B[:, q, 0, 0::2] = gp[:, :, 0]
            B[:, q, 1, 1::2] = gp[:, :, 1]
            B[:, q, 3, 0::2] = s2 * gp[:, :, 1]
            B[:, q, 3, 1::2] = s2 * gp[:, :, 0]
        self.nq = nq
        self.n_points = self.n_cells * nq
        self.B = B
        self.w = np.abs(detJ)[:, None] * QWTS[None, :]

        # unit pressure on the inner arc: the edges of ring 0's vertices
        on_arc = (edges < nt + 1).all(axis=1)
        self.f = np.zeros(self.n_dofs)
        for e in np.flatnonzero(on_arc):
            a, b = verts[edges[e, 0]], verts[edges[e, 1]]
            t = b - a
            L = float(np.hypot(t[0], t[1]))
            out = np.array([t[1], -t[0]]) / L  # a normal of the chord ...
            if out @ (a + b) < 0.0:  # ... turned away from the hole's centre
                out = -out
            for s, share in ((edges[e, 0], L / 6), (edges[e, 1], L / 6), (nv + e, 2 * L / 3)):
                self.f[2 * s:2 * s + 2] += share * out
        self.arc_chords = int(on_arc.sum())
        clamped = np.zeros((self.n_scalar, 2), bool)
        clamped[:, 1] = np.abs(coords[:, 1]) < TOL
        clamped[:, 0] = np.abs(coords[:, 0]) < TOL
        self.bc_mask = clamped.reshape(-1)

    @classmethod
    def from_config(cls, mesh):
        cyl = cls(mesh["lc"], mesh["R_i"], mesh["R_e"])
        if (cyl.rings, cyl.sectors) != (mesh["rings"], mesh["sectors"]):
            raise ValueError(f"lc = {mesh['lc']} gives {cyl.rings} x {cyl.sectors} quads, not "
                             f"the configuration's {mesh['rings']} x {mesh['sectors']}")
        return cyl

    def on(self, device, dtype):
        """The arrays that the judge and the control need, as tensors."""
        return {"B": torch.as_tensor(self.B, dtype=dtype, device=device),
                "w": torch.as_tensor(self.w, dtype=dtype, device=device),
                "dofmap": torch.as_tensor(self.dofmap, device=device),
                "f": torch.as_tensor(self.f, dtype=dtype, device=device),
                "bc": torch.as_tensor(self.bc_mask, device=device)}
