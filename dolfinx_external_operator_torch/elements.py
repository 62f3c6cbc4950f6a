"""Reference finite elements: Lagrange (CG/DG) and quadrature elements.

Copy of ``dolfinx_external_operator_tpu/elements.py`` (numpy only): the port
keeps its own copy because importing any module of the JAX package
imports JAX.  Keep the two in step; ``tests/test_torch_substrate.py``
holds them bitwise equal.

Host-side (numpy) replacement for Basix element tabulation and
``basix.ufl.quadrature_element`` / ``basix.ufl.element`` which the reference
consumes at ``external_operator.py:29-46`` and throughout the demos.  Basis
functions are constructed generically as nodal bases (monomial Vandermonde
inversion), so tabulation is exact and dimension-agnostic.

Element node layout (scalar dofs, must match ``mesh.CELL_EDGES`` order):
vertices in local order, then one node per edge (P2), then interior nodes.
Vector/tensor elements are *blocked*: scalar basis x ``bs`` components with
unrolled dof ``scalar_dof * bs + component`` (same convention as DOLFINx
blocked spaces, cf. reference ``get_unrolled_dofmap``,
``external_operator.py:18-26``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .mesh import CELL_EDGES, CELL_FACETS, CELL_TDIM, REFERENCE_VERTICES
from .quadrature import make_quadrature

__all__ = ["Element", "element", "quadrature_element", "mixed_element", "MixedElement"]


def _monomials(cell_type: str, degree: int):
    """Exponent multi-indices of the polynomial space."""
    tdim = CELL_TDIM[cell_type]
    exps = []
    if cell_type in ("interval", "triangle", "tetrahedron"):
        # total degree <= degree
        if tdim == 1:
            exps = [(i,) for i in range(degree + 1)]
        elif tdim == 2:
            exps = [(i, j) for i in range(degree + 1) for j in range(degree + 1 - i)]
        else:
            exps = [
                (i, j, k)
                for i in range(degree + 1)
                for j in range(degree + 1 - i)
                for k in range(degree + 1 - i - j)
            ]
    else:
        # tensor-product space, per-direction degree <= degree
        if tdim == 2:
            exps = [(i, j) for i in range(degree + 1) for j in range(degree + 1)]
        else:
            exps = [(i, j, k) for i in range(degree + 1) for j in range(degree + 1) for k in range(degree + 1)]
    return np.asarray(exps, dtype=np.int64)


def _eval_monomials(exps: np.ndarray, pts: np.ndarray):
    """Values and gradients of monomials at pts: (npts, nm), (npts, nm, tdim)."""
    npts, tdim = pts.shape
    nm = exps.shape[0]
    vals = np.ones((npts, nm))
    grads = np.zeros((npts, nm, tdim))
    for d in range(tdim):
        e = exps[:, d][None, :]  # (1, nm)
        x = pts[:, d][:, None]  # (npts, 1)
        vals = vals * np.power(x, e)
    for d in range(tdim):
        g = np.ones((npts, nm))
        for d2 in range(tdim):
            e = exps[:, d2][None, :].astype(float)
            x = pts[:, d2][:, None]
            if d2 == d:
                with np.errstate(divide="ignore", invalid="ignore"):
                    xe = np.where(e - 1 >= 0, np.power(x, np.maximum(e - 1, 0)), 0.0)
                g = g * e * xe
            else:
                g = g * np.power(x, e)
        grads[:, :, d] = g
    return vals, grads


def _lagrange_nodes(cell_type: str, degree: int):
    """Node coordinates + entity dof layout for degree-n Lagrange elements
    (equispaced nodes — the same polynomial space as Basix's default
    variants, which is all assembly parity requires).

    Returns (nodes (nb, tdim), entity_counts with per-vertex/edge/face/cell
    scalar-dof counts).  Node order: vertices (REFERENCE_VERTICES order),
    then per edge (CELL_EDGES order) the n-1 interior points directed from
    local vertex a to b, then per facet (CELL_FACETS order, 3D only) the
    face-interior points, then cell-interior points.

    The reference gets arbitrary-degree elements from Basix; its mixed-space
    oracle uses P4 (``test_external_operators_evaluation.py:230-306``).
    """
    verts = REFERENCE_VERTICES[cell_type]
    tdim = CELL_TDIM[cell_type]
    n = int(degree)
    if n == 0:
        # piecewise constant: one node at the cell midpoint (DG0)
        return verts.mean(axis=0, keepdims=True), {"vertex": 0, "edge": 0, "face": 0, "cell": 1}
    counts = {"vertex": 1, "edge": 0, "face": 0, "cell": 0}
    nodes = [verts.copy()]
    simplex = cell_type in ("interval", "triangle", "tetrahedron")

    edges = CELL_EDGES[cell_type]
    if n >= 2 and edges:
        t = (np.arange(1, n) / n)[:, None]  # (n-1, 1)
        for a, b in edges:
            nodes.append(verts[a][None, :] * (1.0 - t) + verts[b][None, :] * t)
        counts["edge"] = n - 1

    if tdim == 3 and n >= 2:
        if simplex:
            ij = [(i, j) for i in range(1, n) for j in range(1, n - i)]
        else:
            ij = [(i, j) for i in range(1, n) for j in range(1, n)]
        counts["face"] = len(ij)
        # >1 face dof: the two incident cells see the face lattice in
        # different local frames; FunctionSpace._build_dofmap applies the
        # canonical (global-vertex-id-ordered) permutation per cell/facet
        # (see ``face_dof_permutations``) so both agree on the numbering
        for f in CELL_FACETS[cell_type]:
            fv = verts[list(f)]
            # both face types use the (v0; v1-v0, v2-v0) local frame
            # (DOLFINx tensor vertex order for quadrilateral faces)
            pts = np.array([fv[0] + (fv[1] - fv[0]) * (i / n) + (fv[2] - fv[0]) * (j / n)
                            for i, j in ij], dtype=float).reshape(len(ij), tdim)
            nodes.append(pts)

    # cell-interior nodes
    interior = []
    if tdim == 1:
        interior = [[i / n] for i in range(1, n)]
    elif tdim == 2:
        if simplex:
            interior = [[i / n, j / n] for i in range(1, n) for j in range(1, n - i)]
        else:
            interior = [[i / n, j / n] for i in range(1, n) for j in range(1, n)]
    else:
        if simplex:
            interior = [
                [i / n, j / n, k / n]
                for i in range(1, n) for j in range(1, n - i) for k in range(1, n - i - j)
            ]
        else:
            interior = [
                [i / n, j / n, k / n]
                for i in range(1, n) for j in range(1, n) for k in range(1, n)
            ]
    counts["cell"] = len(interior)
    if interior:
        nodes.append(np.asarray(interior, dtype=float))
    return np.concatenate(nodes, axis=0), counts


def face_lattice(cell_type: str, degree: int):
    """Face-interior lattice of a degree-n Lagrange element, in the local
    enumeration order used by ``_lagrange_nodes`` (the (i, j) coefficients
    of the (fv0; fv1-fv0, fv2-fv0) face frame)."""
    n = int(degree)
    if cell_type == "tetrahedron":
        return [(i, j) for i in range(1, n) for j in range(1, n - i)]
    return [(i, j) for i in range(1, n) for j in range(1, n)]


def face_dof_permutations(cell_type: str, degree: int, cells: np.ndarray) -> np.ndarray:
    """(n_cells, n_local_facets, nf) canonical face-dof position for each
    local face-lattice node — the role of DOLFINx/Basix dof permutations
    for face-interior dofs (consumed by Basix-tabulated elements in the
    reference, ``external_operator.py:33-45``).

    Canonical numbering of a face's interior dofs: the lattice expressed in
    the frame ordered by GLOBAL vertex ids (triangle faces: barycentric
    components sorted by id; quad faces: s-axis toward the lower-id
    neighbor of the lowest-id corner), so the two incident cells agree."""
    n = int(degree)
    ij = face_lattice(cell_type, n)
    idx2d = np.full((n, n), -1, dtype=np.int64)
    for k, (i, j) in enumerate(ij):
        idx2d[i, j] = k
    local_facets = CELL_FACETS[cell_type]
    nc = cells.shape[0]
    out = np.empty((nc, len(local_facets), len(ij)), dtype=np.int64)
    for fi, f in enumerate(local_facets):
        gv = cells[:, list(f)].astype(np.int64)  # (nc, 3|4) global vertex ids
        if cell_type == "tetrahedron":
            order = np.argsort(gv, axis=1)  # ascending-id positions
            for k, (i, j) in enumerate(ij):
                bar = np.array([n - i - j, i, j])  # barycentric * n, local order
                out[:, fi, k] = idx2d[bar[order[:, 1]], bar[order[:, 2]]]
        else:
            # quad face, tensor vertex order: v0,v1 span s; v0,v2 span t
            corner_st = np.array([[0, 0], [1, 0], [0, 1], [1, 1]])
            nbr = np.array([[1, 2], [0, 3], [0, 3], [1, 2]])
            w0 = np.argmin(gv, axis=1)
            na, nb = nbr[w0, 0], nbr[w0, 1]
            ga = np.take_along_axis(gv, na[:, None], 1)[:, 0]
            gb = np.take_along_axis(gv, nb[:, None], 1)[:, 0]
            w1 = np.where(ga < gb, na, nb)
            s0, t0 = corner_st[w0].T
            s1, _ = corner_st[w1].T
            w1_along_s = s1 != s0  # else w1 lies along the t-axis from w0
            for k, (i, j) in enumerate(ij):
                sp = np.where(w1_along_s, np.abs(i - s0 * n), np.abs(j - t0 * n))
                tp = np.where(w1_along_s, np.abs(j - t0 * n), np.abs(i - s0 * n))
                out[:, fi, k] = idx2d[sp, tp]
    assert (out >= 0).all()
    return out


class Element:
    """A finite element on a reference cell.

    Families: "Lagrange" (CG), "DG" (discontinuous Lagrange — same nodes,
    all dofs cell-local), "quadrature" (point evaluations at a Gauss rule;
    reference equivalent: ``basix.ufl.quadrature_element``,
    ``external_operator.py:33-37``).
    """

    def __init__(self, family: str, cell_type: str, degree: int, value_shape=(), quad_scheme: str = "default"):
        self.family = family
        self.cell_type = cell_type
        self.degree = int(degree)
        self.value_shape = tuple(int(s) for s in value_shape)
        self.quad_scheme = quad_scheme

        if family in ("Lagrange", "P", "CG", "DG"):
            self.family = "DG" if family == "DG" else "Lagrange"
            nodes, counts = _lagrange_nodes(cell_type, self.degree)
            self._nodes = nodes
            if self.family == "DG":
                counts = {"vertex": 0, "edge": 0, "face": 0, "cell": nodes.shape[0]}
            self.entity_counts = counts
            exps = _monomials(cell_type, self.degree)
            V, _ = _eval_monomials(exps, nodes)
            assert V.shape[0] == V.shape[1], (V.shape, "nodal basis must be square")
            self._exps = exps
            self._coeffs = np.linalg.inv(V)  # phi(x) = monos(x) @ coeffs
        elif family == "quadrature":
            pts, wts = make_quadrature(cell_type, self.degree)
            self._nodes = pts
            self.quad_weights = wts
            self.entity_counts = {"vertex": 0, "edge": 0, "face": 0, "cell": pts.shape[0]}
            self._exps = None
            self._coeffs = None
        else:
            raise ValueError(f"unknown family {family}")

    # ------------------------------------------------------------------
    @property
    def tdim(self) -> int:
        return CELL_TDIM[self.cell_type]

    @property
    def num_scalar_dofs(self) -> int:
        return self._nodes.shape[0]

    @property
    def block_size(self) -> int:
        bs = 1
        for s in self.value_shape:
            bs *= s
        return bs

    @property
    def num_dofs(self) -> int:
        return self.num_scalar_dofs * self.block_size

    @property
    def interpolation_points(self) -> np.ndarray:
        """Points at which dof values are point evaluations.

        Mirrors ``element.interpolation_points`` used to drive operand
        evaluation in the reference (``external_operator.py:144,200``)."""
        return self._nodes

    @property
    def is_mixed(self) -> bool:
        return False

    @property
    def discontinuous(self) -> bool:
        return self.family in ("DG", "quadrature")

    def tabulate(self, points: np.ndarray):
        """Scalar basis values and reference gradients at ``points``.

        Returns (phi (npts, nb), dphi (npts, nb, tdim))."""
        points = np.asarray(points, dtype=np.float64)
        if self.family == "quadrature":
            if points.shape != self._nodes.shape or not np.allclose(points, self._nodes, atol=1e-12):
                raise ValueError(
                    "quadrature elements can only be tabulated at their own quadrature points; "
                    "ensure the measure's quadrature_degree matches the element degree"
                )
            n = self._nodes.shape[0]
            return np.eye(n), np.zeros((n, n, self.tdim))
        M, dM = _eval_monomials(self._exps, points)
        phi = M @ self._coeffs
        dphi = np.einsum("pmd,mb->pbd", dM, self._coeffs)
        return phi, dphi

    def with_value_shape(self, value_shape) -> "Element":
        return Element(self.family, self.cell_type, self.degree, value_shape, self.quad_scheme)

    def __repr__(self):
        return f"Element({self.family}, {self.cell_type}, deg={self.degree}, shape={self.value_shape})"

    def __eq__(self, other):
        return (
            isinstance(other, Element)
            and (self.family, self.cell_type, self.degree, self.value_shape)
            == (other.family, other.cell_type, other.degree, other.value_shape)
        )

    def __hash__(self):
        return hash((self.family, self.cell_type, self.degree, self.value_shape))


class MixedElement:
    """A mixed element: a tuple of sub-elements on the same cell.

    Reference equivalent: ``basix.ufl.mixed_element``
    (``external_operator.py:122``)."""

    def __init__(self, sub_elements):
        self.sub_elements = tuple(sub_elements)
        cells = {e.cell_type for e in self.sub_elements}
        assert len(cells) == 1, "mixed element sub-elements must share a cell"
        self.cell_type = self.sub_elements[0].cell_type
        self.family = "mixed"
        # UFL flattens mixed value shapes to a single vector
        self.value_shape = (sum(e.block_size for e in self.sub_elements),)

    @property
    def is_mixed(self) -> bool:
        return True

    @property
    def tdim(self) -> int:
        return self.sub_elements[0].tdim

    @property
    def num_dofs(self) -> int:
        return sum(e.num_dofs for e in self.sub_elements)

    def __eq__(self, other):
        return isinstance(other, MixedElement) and self.sub_elements == other.sub_elements

    def __hash__(self):
        return hash(self.sub_elements)


@lru_cache(maxsize=None)
def _element_cached(family, cell_type, degree, value_shape, quad_scheme):
    return Element(family, cell_type, degree, value_shape, quad_scheme)


def element(family: str, cell_type: str, degree: int, shape=(), discontinuous: bool = False) -> Element:
    """Create a Lagrange-family element (reference: ``basix.ufl.element``,
    ``external_operator.py:39-45``)."""
    fam = "DG" if (discontinuous or family == "DG") else "Lagrange"
    return _element_cached(fam, cell_type, int(degree), tuple(shape), "default")


def quadrature_element(cell_type: str, degree: int, value_shape=(), scheme: str = "default") -> Element:
    """Create a quadrature element (reference: ``basix.ufl.quadrature_element``,
    used e.g. at ``demo_plasticity_von_mises.py:245``)."""
    return _element_cached("quadrature", cell_type, int(degree), tuple(value_shape), scheme)


def mixed_element(sub_elements) -> MixedElement:
    return MixedElement(sub_elements)
