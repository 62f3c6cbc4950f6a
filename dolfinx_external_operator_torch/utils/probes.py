"""Point-probe utilities.

The port of ``dolfinx_external_operator_tpu/utils/probes.py:16-66`` (numpy,
host side): a point-in-cell search that replaces the bounding-box collision
search of the reference (``doc/demo/utilities.py:73-83``)."""

from __future__ import annotations

import numpy as np

from ..elements import Element
from ..mesh import Mesh

__all__ = ["find_cell_by_point", "interpolate_quadrature"]


def find_cell_by_point(mesh: Mesh, points: np.ndarray):
    """Return (cells, points) for points found inside the mesh
    (reference parity: ``utilities.py:73-83``)."""
    points = np.atleast_2d(np.asarray(points, dtype=np.float64))[:, : mesh.gdim]
    cells = []
    pts_found = []
    verts = mesh.points[mesh.cells]  # (nc, nv, g)
    for pt in points:
        c = _locate(mesh, verts, pt)
        if c >= 0:
            cells.append(c)
            pts_found.append(pt)
    return cells, pts_found


def _locate(mesh, verts, pt, tol=1e-10):
    if mesh.cell_type == "triangle":
        a, b, c = verts[:, 0], verts[:, 1], verts[:, 2]
        d = (b[:, 1] - c[:, 1]) * (a[:, 0] - c[:, 0]) + (c[:, 0] - b[:, 0]) * (a[:, 1] - c[:, 1])
        l1 = ((b[:, 1] - c[:, 1]) * (pt[0] - c[:, 0]) + (c[:, 0] - b[:, 0]) * (pt[1] - c[:, 1])) / d
        l2 = ((c[:, 1] - a[:, 1]) * (pt[0] - c[:, 0]) + (a[:, 0] - c[:, 0]) * (pt[1] - c[:, 1])) / d
        l3 = 1.0 - l1 - l2
        inside = (l1 >= -tol) & (l2 >= -tol) & (l3 >= -tol)
        hits = np.where(inside)[0]
        return int(hits[0]) if hits.size else -1
    # generic fallback: nearest cell midpoint, then verify by pull-back
    mids = verts.mean(axis=1)
    order = np.argsort(np.linalg.norm(mids - pt[None, :], axis=1))
    from ..function import _pull_back

    geo = Element("Lagrange", mesh.cell_type, 1)
    for c in order[:8]:
        xi = _pull_back(mesh, geo, int(c), pt)
        if np.all(xi >= -tol) and (
            np.all(xi <= 1 + tol)
            if mesh.cell_type in ("quadrilateral", "hexahedron", "interval")
            else xi.sum() <= 1 + tol
        ):
            return int(c)
    return -1


def interpolate_quadrature(expr, fem_func) -> None:
    """Interpolate a symbolic expression into a quadrature-space Function
    (reference ``utilities.py:86-97``), on the Function's device."""
    from ..expression import Expression

    V = fem_func.function_space
    e = Expression(expr, V.element.interpolation_points, dtype=fem_func.dtype, device=fem_func.device)
    fem_func.x.array[:] = e.eval(V.mesh).reshape(-1)
