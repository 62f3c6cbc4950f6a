"""Gauss quadrature rules on the reference cells.

Copy of ``dolfinx_external_operator_tpu/quadrature.py`` (numpy only): the port
keeps its own copy because importing any module of the JAX package
imports JAX.  Keep the two in step; ``tests/test_torch_substrate.py``
holds them bitwise equal.

Host-side (numpy) replacement for ``basix.make_quadrature`` (used by the reference
at ``external_operator.py:33-45`` via ``quadrature_element`` and in
``doc/demo/utilities.py:90``).  Rules are exact to the requested polynomial
degree.  Low-degree simplex rules use compact symmetric point sets (matching
basix's default point counts for the degrees exercised in the demos, e.g.
3 points for degree 2 on triangles); higher degrees fall back to collapsed
(Duffy) tensor-product Gauss-Legendre rules.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["make_quadrature"]


def _gauss_legendre_01(n: int):
    """n-point Gauss-Legendre rule on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def _interval(degree: int):
    n = max(1, (degree + 2) // 2)
    x, w = _gauss_legendre_01(n)
    return x[:, None], w


def _tensor(degree: int, dim: int):
    x, w = _gauss_legendre_01(max(1, (degree + 2) // 2))
    grids = np.meshgrid(*([x] * dim), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=1)
    ws = np.ones(pts.shape[0])
    wg = np.meshgrid(*([w] * dim), indexing="ij")
    for g in wg:
        ws = ws * g.ravel()
    return pts, ws


# Compact symmetric triangle rules (points in barycentric-derived (x, y),
# weights sum to reference area 1/2).
_TRIANGLE_RULES = {
    0: (np.array([[1 / 3, 1 / 3]]), np.array([0.5])),
    1: (np.array([[1 / 3, 1 / 3]]), np.array([0.5])),
    2: (
        np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]]),
        np.array([1 / 6, 1 / 6, 1 / 6]),
    ),
    3: (
        # 6-point degree-3/4 rule (Strang-Fix / Dunavant deg 4, positive weights)
        None,
        None,
    ),
}
# Dunavant degree-4, 6-point rule
_a1, _a2 = 0.445948490915965, 0.091576213509771
_w1, _w2 = 0.223381589678011 / 2, 0.109951743655322 / 2
_TRI6_PTS = np.array(
    [
        [_a1, _a1], [1 - 2 * _a1, _a1], [_a1, 1 - 2 * _a1],
        [_a2, _a2], [1 - 2 * _a2, _a2], [_a2, 1 - 2 * _a2],
    ]
)
_TRI6_W = np.array([_w1, _w1, _w1, _w2, _w2, _w2])

# Tetrahedron rules (weights sum to 1/6)
_TET1 = (np.array([[0.25, 0.25, 0.25]]), np.array([1 / 6]))
_b = 0.138196601125011  # (5 - sqrt(5)) / 20
_TET2 = (
    np.array(
        [
            [_b, _b, _b],
            [1 - 3 * _b, _b, _b],
            [_b, 1 - 3 * _b, _b],
            [_b, _b, 1 - 3 * _b],
        ]
    ),
    np.full(4, 1 / 24),
)


def _duffy_triangle(degree: int):
    """Collapsed-coordinate rule on the triangle, exact to ``degree``."""
    # x = u, y = v (1 - u); Jacobian (1 - u). Use Gauss-Jacobi-free safe count.
    n = max(1, (degree + 2) // 2 + 1)
    u, wu = _gauss_legendre_01(n)
    v, wv = _gauss_legendre_01(n)
    U, V = np.meshgrid(u, v, indexing="ij")
    WU, WV = np.meshgrid(wu, wv, indexing="ij")
    x = U.ravel()
    y = (V * (1 - U)).ravel()
    w = (WU * WV * (1 - U)).ravel()
    return np.stack([x, y], axis=1), w


def _duffy_tet(degree: int):
    n = max(1, (degree + 2) // 2 + 1)
    u, wu = _gauss_legendre_01(n)
    U, V, W = np.meshgrid(u, u, u, indexing="ij")
    WU, WV, WW = np.meshgrid(wu, wu, wu, indexing="ij")
    x = U.ravel()
    y = (V * (1 - U)).ravel()
    z = (W * (1 - U) * (1 - V)).ravel()
    w = (WU * WV * WW * (1 - U) ** 2 * (1 - V)).ravel()
    return np.stack([x, y, z], axis=1), w


@lru_cache(maxsize=None)
def make_quadrature(cell_type: str, degree: int):
    """Return (points (n, tdim), weights (n,)) exact to ``degree``.

    The returned arrays are cached process-wide and marked read-only so a
    caller mutating them cannot corrupt the cache; copy before writing.
    """
    pts, w = _make_quadrature_impl(cell_type, degree)
    pts = np.asarray(pts)
    w = np.asarray(w)
    pts.flags.writeable = False
    w.flags.writeable = False
    return pts, w


def _make_quadrature_impl(cell_type: str, degree: int):
    degree = int(degree)
    if cell_type == "point":
        return np.zeros((1, 0)), np.ones(1)
    if cell_type == "interval":
        return _interval(degree)
    if cell_type == "quadrilateral":
        return _tensor(degree, 2)
    if cell_type == "hexahedron":
        return _tensor(degree, 3)
    if cell_type == "triangle":
        if degree <= 1:
            return _TRIANGLE_RULES[1]
        if degree == 2:
            return _TRIANGLE_RULES[2]
        if degree <= 4:
            return _TRI6_PTS.copy(), _TRI6_W.copy()
        return _duffy_triangle(degree)
    if cell_type == "tetrahedron":
        if degree <= 1:
            return _TET1
        if degree == 2:
            return _TET2
        return _duffy_tet(degree)
    raise ValueError(f"unknown cell type {cell_type}")
