"""Host-side mesh data structures and generators.

Copy of ``dolfinx_external_operator_tpu/mesh.py`` (numpy only): the port
keeps its own copy because importing any module of the JAX package
imports JAX.  Keep the two in step; ``tests/test_torch_substrate.py``
holds them bitwise equal.

Host-side (numpy) replacement for the DOLFINx C++ mesh/topology/dofmap substrate the
reference package depends on (see reference ``external_operator.py:364-371``
and ``doc/demo/utilities.py:13-70,100-182``).  The mesh is built once on the
host in NumPy (integer connectivity arrays + vertex coordinates) and shipped
to the device as static arrays; there is no ghost layer — multi-chip runs
shard the cell axis with an owner-computes layout (see ``parallel/``).

Reference cell conventions (all on the unit reference domain):

* ``interval``       : vertices (0), (1)
* ``triangle``       : vertices (0,0), (1,0), (0,1)
* ``quadrilateral``  : vertices (0,0), (1,0), (0,1), (1,1)   [lexicographic]
* ``tetrahedron``    : vertices (0,0,0), (1,0,0), (0,1,0), (0,0,1)
* ``hexahedron``     : lexicographic over (z, y, x)

Local edge/facet numbering is defined in ``CELL_EDGES`` / ``CELL_FACETS``
below and is the single source of truth for element dof layouts.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "Mesh",
    "Submesh",
    "EntityMap",
    "create_submesh",
    "locate_entities",
    "create_interval",
    "create_unit_interval",
    "create_rectangle",
    "create_unit_square",
    "create_box",
    "create_unit_cube",
    "build_cylinder_quarter",
    "build_square_with_elliptic_holes",
    "locate_entities_boundary",
]

# Local edges of each cell type: pairs of local vertex indices.  P2 edge dofs
# attach to these in this order.
CELL_EDGES = {
    "interval": (),
    "triangle": ((1, 2), (0, 2), (0, 1)),
    "quadrilateral": ((0, 1), (0, 2), (1, 3), (2, 3)),
    "tetrahedron": ((2, 3), (1, 3), (1, 2), (0, 3), (0, 2), (0, 1)),
    "hexahedron": (
        (0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3),
        (2, 6), (3, 7), (4, 5), (4, 6), (5, 7), (6, 7),
    ),
}

# Local facets (codim-1 entities): tuples of local vertex indices.
CELL_FACETS = {
    "interval": ((0,), (1,)),
    "triangle": ((1, 2), (0, 2), (0, 1)),
    "quadrilateral": ((0, 1), (0, 2), (1, 3), (2, 3)),
    "tetrahedron": ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)),
    "hexahedron": (
        (0, 1, 2, 3),  # z = 0
        (0, 1, 4, 5),  # y = 0
        (0, 2, 4, 6),  # x = 0
        (1, 3, 5, 7),  # x = 1
        (2, 3, 6, 7),  # y = 1
        (4, 5, 6, 7),  # z = 1
    ),
}

CELL_TDIM = {
    "interval": 1,
    "triangle": 2,
    "quadrilateral": 2,
    "tetrahedron": 3,
    "hexahedron": 3,
}

# Facet cell type (for facet quadrature rules)
FACET_CELL = {
    "interval": "point",
    "triangle": "interval",
    "quadrilateral": "interval",
    "tetrahedron": "triangle",
    "hexahedron": "quadrilateral",
}

REFERENCE_VERTICES = {
    "interval": np.array([[0.0], [1.0]]),
    "triangle": np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
    "quadrilateral": np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]),
    "tetrahedron": np.array(
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    ),
    "hexahedron": np.array(
        [
            [0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [1.0, 1.0, 0.0],
            [0.0, 0.0, 1.0], [1.0, 0.0, 1.0], [0.0, 1.0, 1.0], [1.0, 1.0, 1.0],
        ]
    ),
}


class Mesh:
    """An unstructured mesh: vertex coordinates + cell connectivity.

    All topology (edges, facets, exterior facets) is derived lazily on the
    host and cached.  Plays the role of the DOLFINx ``Mesh`` + ``Topology`` +
    ``IndexMap`` consumed by the reference (``external_operator.py:364-371``)
    but without MPI ghosting: device-parallel runs shard cells instead.
    """

    def __init__(self, points: np.ndarray, cells: np.ndarray, cell_type: str, name: str = "mesh"):
        points = np.asarray(points, dtype=np.float64)
        if points.ndim == 1:
            points = points[:, None]
        self.points = points
        self.cells = np.asarray(cells, dtype=np.int32)
        assert cell_type in CELL_EDGES, f"unknown cell type {cell_type}"
        self.cell_type = cell_type
        self.name = name
        self._edges = None
        self._cell_edges = None
        self._facets = None
        self._cache = {}

    # -- basic queries -------------------------------------------------
    @property
    def gdim(self) -> int:
        return self.points.shape[1]

    @property
    def tdim(self) -> int:
        return CELL_TDIM[self.cell_type]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.points.shape[0]

    def cell_name(self) -> str:
        return self.cell_type

    # -- edges (for P2 dofmaps) ---------------------------------------
    def _build_edges(self):
        local_edges = CELL_EDGES[self.cell_type]
        if not local_edges:
            self._edges = np.empty((0, 2), dtype=np.int32)
            self._cell_edges = np.empty((self.num_cells, 0), dtype=np.int32)
            return
        from ._native import loader as _nat

        if _nat.available():
            self._edges, self._cell_edges = _nat.build_edges(self.cells, local_edges)
            return
        le = np.asarray(local_edges, dtype=np.int32)  # (n_local_edges, 2)
        # (n_cells, n_local_edges, 2) global vertex pairs, sorted within pair
        ev = self.cells[:, le]  # fancy: (n_cells, nle, 2)
        ev_sorted = np.sort(ev, axis=-1)
        flat = ev_sorted.reshape(-1, 2)
        uniq, inverse = np.unique(flat, axis=0, return_inverse=True)
        self._edges = uniq.astype(np.int32)
        self._cell_edges = inverse.reshape(self.num_cells, len(local_edges)).astype(np.int32)

    @property
    def edges(self) -> np.ndarray:
        """(n_edges, 2) vertex pairs, each sorted ascending."""
        if self._edges is None:
            self._build_edges()
        return self._edges

    @property
    def cell_edges(self) -> np.ndarray:
        """(n_cells, n_local_edges) global edge index per local edge."""
        if self._cell_edges is None:
            self._build_edges()
        return self._cell_edges

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]

    # -- facets (codim-1, for boundary integrals & BCs) ----------------
    def _build_facets(self):
        local_facets = CELL_FACETS[self.cell_type]
        lf = [np.asarray(f, dtype=np.int32) for f in local_facets]
        nvf = len(lf[0])
        n_lf = len(lf)
        from ._native import loader as _nat

        if _nat.available():
            fv, fc, flo, cell_facets = _nat.build_facets(
                self.cells, np.asarray(local_facets, dtype=np.int32)
            )
            self._facets = {
                "vertices": fv,
                "vertices_sorted": np.sort(fv, axis=1),
                "cells": fc,
                "local": flo,
                "exterior": np.where(fc[:, 1] < 0)[0].astype(np.int32),
                "cell_facets": cell_facets,
            }
            return
        fv = np.stack([self.cells[:, f] for f in lf], axis=1)  # (n_cells, n_lf, nvf)
        fv_sorted = np.sort(fv, axis=-1)
        flat = fv_sorted.reshape(-1, nvf)
        uniq, inverse, counts = np.unique(flat, axis=0, return_inverse=True, return_counts=True)
        n_facets = uniq.shape[0]
        # facet -> (cell, local_facet) incidences (up to 2)
        facet_cells = np.full((n_facets, 2), -1, dtype=np.int32)
        facet_local = np.full((n_facets, 2), -1, dtype=np.int32)
        inv = inverse.reshape(self.num_cells, n_lf)
        slot = np.zeros(n_facets, dtype=np.int8)
        for c in range(self.num_cells):
            for k in range(n_lf):
                fidx = inv[c, k]
                s = slot[fidx]
                facet_cells[fidx, s] = c
                facet_local[fidx, s] = k
                slot[fidx] += 1
        # keep the *unsorted* vertex order of the first incident cell's local
        # facet so that facet orientation is well defined
        first_cell = facet_cells[:, 0]
        first_local = facet_local[:, 0]
        facet_vertices = np.empty_like(uniq)
        for i in range(n_facets):
            facet_vertices[i] = self.cells[first_cell[i], lf[first_local[i]]]
        self._facets = {
            "vertices": facet_vertices.astype(np.int32),
            "vertices_sorted": uniq.astype(np.int32),
            "cells": facet_cells,
            "local": facet_local,
            "exterior": np.where(counts == 1)[0].astype(np.int32),
            "cell_facets": inv.astype(np.int32),
        }

    @property
    def facets(self) -> np.ndarray:
        """(n_facets, nv_per_facet) vertex ids in first-cell local order."""
        if self._facets is None:
            self._build_facets()
        return self._facets["vertices"]

    @property
    def facet_cells(self) -> np.ndarray:
        if self._facets is None:
            self._build_facets()
        return self._facets["cells"]

    @property
    def cell_facets(self) -> np.ndarray:
        """(n_cells, n_local_facets) global facet index per local facet
        (for face-attached dofs, e.g. Q2 hexahedra)."""
        if self._facets is None:
            self._build_facets()
        return self._facets["cell_facets"]

    @property
    def facet_local_index(self) -> np.ndarray:
        if self._facets is None:
            self._build_facets()
        return self._facets["local"]

    @property
    def exterior_facets(self) -> np.ndarray:
        """Indices of facets with exactly one incident cell.

        Host-side equivalent of DOLFINx ``exterior_facet_indices`` used for
        BC location in the reference demos."""
        if self._facets is None:
            self._build_facets()
        return self._facets["exterior"]

    @property
    def num_facets(self) -> int:
        return self.facets.shape[0]

    def facet_midpoints(self, facet_indices=None) -> np.ndarray:
        f = self.facets if facet_indices is None else self.facets[facet_indices]
        return self.points[f].mean(axis=1)

    def cell_midpoints(self) -> np.ndarray:
        return self.points[self.cells].mean(axis=1)


# ----------------------------------------------------------------------
# Generators
# ----------------------------------------------------------------------

def create_interval(n: int, a: float = 0.0, b: float = 1.0) -> Mesh:
    pts = np.linspace(a, b, n + 1)[:, None]
    cells = np.stack([np.arange(n), np.arange(1, n + 1)], axis=1)
    return Mesh(pts, cells, "interval", name="interval")


def create_unit_interval(n: int) -> Mesh:
    return create_interval(n)


def create_rectangle(p0, p1, n, cell_type: str = "triangle", diagonal: str = "right") -> Mesh:
    """Structured rectangle mesh (triangles or quadrilaterals).

    Replaces ``dolfinx.mesh.create_rectangle`` used by the Mohr-Coulomb demo
    (reference ``demo_plasticity_mohr_coulomb.py:122``)."""
    nx, ny = n
    x0, y0 = p0
    x1, y1 = p1
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)  # vertex id = j*(nx+1)+i

    def vid(i, j):
        return j * (nx + 1) + i

    quads = []
    for j in range(ny):
        for i in range(nx):
            quads.append((vid(i, j), vid(i + 1, j), vid(i, j + 1), vid(i + 1, j + 1)))
    quads = np.asarray(quads, dtype=np.int32)

    if cell_type == "quadrilateral":
        return Mesh(pts, quads, "quadrilateral", name="rectangle")
    elif cell_type == "triangle":
        tris = []
        for q in quads:
            v0, v1, v2, v3 = q
            if diagonal == "right":
                tris.append((v0, v1, v3))
                tris.append((v0, v3, v2))
            elif diagonal == "left":
                tris.append((v0, v1, v2))
                tris.append((v1, v3, v2))
            elif diagonal == "crossed":
                raise NotImplementedError("crossed diagonal")
            else:
                raise ValueError(diagonal)
        return Mesh(pts, np.asarray(tris, dtype=np.int32), "triangle", name="rectangle")
    else:
        raise ValueError(cell_type)


def create_unit_square(nx: int, ny: int, cell_type: str = "triangle") -> Mesh:
    return create_rectangle((0.0, 0.0), (1.0, 1.0), (nx, ny), cell_type)


def create_box(p0, p1, n, cell_type: str = "tetrahedron") -> Mesh:
    nx, ny, nz = n
    xs = np.linspace(p0[0], p1[0], nx + 1)
    ys = np.linspace(p0[1], p1[1], ny + 1)
    zs = np.linspace(p0[2], p1[2], nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    # vertex id = (i*(ny+1) + j)*(nz+1) + k
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    cells = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                # hex vertices in lexicographic (z, y, x) reference order:
                v = [
                    vid(i, j, k), vid(i + 1, j, k), vid(i, j + 1, k), vid(i + 1, j + 1, k),
                    vid(i, j, k + 1), vid(i + 1, j, k + 1), vid(i, j + 1, k + 1), vid(i + 1, j + 1, k + 1),
                ]
                if cell_type == "hexahedron":
                    cells.append(v)
                else:
                    # 6-tet (Kuhn) subdivision of the cube
                    v0, v1, v2, v3, v4, v5, v6, v7 = v
                    cells.extend(
                        [
                            (v0, v1, v3, v7),
                            (v0, v1, v7, v5),
                            (v0, v5, v7, v4),
                            (v0, v3, v2, v7),
                            (v0, v2, v6, v7),
                            (v0, v6, v4, v7),
                        ]
                    )
    return Mesh(pts, np.asarray(cells, dtype=np.int32), cell_type, name="box")


def create_unit_cube(nx: int, ny: int, nz: int, cell_type: str = "tetrahedron") -> Mesh:
    return create_box((0, 0, 0), (1, 1, 1), (nx, ny, nz), cell_type)


def build_cylinder_quarter(lc: float = 0.3, R_e: float = 1.3, R_i: float = 1.0):
    """Structured quarter-annulus (triangles) with facet tags.

    Host-side replacement for the gmsh quarter-cylinder generator of the
    reference (``doc/demo/utilities.py:13-70``).  Instead of gmsh physical
    groups, returns a dict of facet-index arrays keyed by the same labels
    {"Lx", "Ly", "inner", "outer"}.
    """
    nr = max(1, int(round((R_e - R_i) / lc)))
    ntheta = max(4, int(round((np.pi / 2 * 0.5 * (R_e + R_i)) / lc)))
    rs = np.linspace(R_i, R_e, nr + 1)
    thetas = np.linspace(0.0, np.pi / 2, ntheta + 1)
    R, T = np.meshgrid(rs, thetas, indexing="ij")
    pts = np.stack([(R * np.cos(T)).ravel(), (R * np.sin(T)).ravel()], axis=1)

    def vid(i, j):
        return i * (ntheta + 1) + j

    tris = []
    for i in range(nr):
        for j in range(ntheta):
            v0, v1, v2, v3 = vid(i, j), vid(i + 1, j), vid(i, j + 1), vid(i + 1, j + 1)
            tris.append((v0, v1, v3))
            tris.append((v0, v3, v2))
    mesh = Mesh(pts, np.asarray(tris, dtype=np.int32), "triangle", name="quarter_cylinder")

    eps = 1e-10
    mid = mesh.facet_midpoints()
    ext = mesh.exterior_facets
    mid_ext = mid[ext]
    r_ext = np.linalg.norm(mid_ext, axis=1)
    facet_tags = {
        "Lx": ext[np.abs(mid_ext[:, 1]) < eps],
        "Ly": ext[np.abs(mid_ext[:, 0]) < eps],
        "inner": ext[(np.abs(mid_ext[:, 0]) >= eps) & (np.abs(mid_ext[:, 1]) >= eps) & (r_ext < 0.5 * (R_i + R_e))],
        "outer": ext[(np.abs(mid_ext[:, 0]) >= eps) & (np.abs(mid_ext[:, 1]) >= eps) & (r_ext >= 0.5 * (R_i + R_e))],
    }
    facet_tags_labels = {"Lx": "Lx", "Ly": "Ly", "inner": "inner", "outer": "outer"}
    return mesh, facet_tags, facet_tags_labels


def build_square_with_elliptic_holes(
    lc: float = 0.05,
    L: float = 1.0,
    hole1_center=(0.375, 0.25),
    hole1_radii=(0.25, 0.125),
    hole2_center=(0.75, 0.625),
    hole2_radii=(0.25, 0.125),
):
    """Unstructured-ish triangulation of a square with two elliptic holes.

    Replaces the gmsh generator of the reference
    (``doc/demo/utilities.py:100-182``) with a Delaunay-based mesher: grid +
    boundary sample points, scipy Delaunay triangulation, carve triangles
    whose centroid falls inside a hole.  Hole 2 is rotated 90 degrees (the
    reference passes ``xAxis=[0, 1, 0]``), so its radii are swapped here.
    """
    from scipy.spatial import Delaunay

    c1 = np.asarray(hole1_center)
    r1 = np.asarray(hole1_radii)
    c2 = np.asarray(hole2_center)
    r2 = np.asarray(hole2_radii)[::-1]  # rotated ellipse

    def inside_hole(p, margin=0.0):
        d1 = ((p[:, 0] - c1[0]) / (r1[0] + margin)) ** 2 + ((p[:, 1] - c1[1]) / (r1[1] + margin)) ** 2
        d2 = ((p[:, 0] - c2[0]) / (r2[0] + margin)) ** 2 + ((p[:, 1] - c2[1]) / (r2[1] + margin)) ** 2
        return (d1 < 1.0) | (d2 < 1.0)

    n = int(round(L / lc))
    xs = np.linspace(0, L, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="xy")
    grid = np.stack([X.ravel(), Y.ravel()], axis=1)
    # keep grid points clearly outside the holes
    keep = ~inside_hole(grid, margin=0.35 * lc)
    pts = [grid[keep]]
    # boundary points of each ellipse
    for c, r in ((c1, r1), (c2, r2)):
        per = np.pi * (3 * (r[0] + r[1]) - np.sqrt((3 * r[0] + r[1]) * (r[0] + 3 * r[1])))
        m = max(16, int(round(per / lc)))
        t = np.linspace(0, 2 * np.pi, m, endpoint=False)
        pts.append(np.stack([c[0] + r[0] * np.cos(t), c[1] + r[1] * np.sin(t)], axis=1))
    pts = np.concatenate(pts, axis=0)
    pts = np.unique(np.round(pts / (1e-9)) * 1e-9, axis=0)

    tri = Delaunay(pts)
    cells = tri.simplices.astype(np.int32)
    cent = pts[cells].mean(axis=1)
    good = ~inside_hole(cent)
    # also drop degenerate slivers on the hole boundary
    p0, p1, p2 = pts[cells[:, 0]], pts[cells[:, 1]], pts[cells[:, 2]]
    area = 0.5 * np.abs((p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1]) - (p2[:, 0] - p0[:, 0]) * (p1[:, 1] - p0[:, 1]))
    good &= area > 1e-6 * lc * lc
    cells = cells[good]
    # drop unused points and renumber
    used = np.unique(cells)
    remap = -np.ones(pts.shape[0], dtype=np.int32)
    remap[used] = np.arange(used.size, dtype=np.int32)
    mesh = Mesh(pts[used], remap[cells], "triangle", name="square_with_elliptic_holes")

    eps = 1e-8
    mid = mesh.facet_midpoints()
    ext = mesh.exterior_facets
    mid_ext = mid[ext]
    facet_tags = {
        "bottom": ext[np.abs(mid_ext[:, 1]) < eps],
        "top": ext[np.abs(mid_ext[:, 1] - L) < eps],
        "right": ext[np.abs(mid_ext[:, 0] - L) < eps],
        "left": ext[np.abs(mid_ext[:, 0]) < eps],
    }
    facet_tags_labels = {"bottom": "bottom", "top": "top", "right": "right", "left": "left"}
    return mesh, facet_tags, facet_tags_labels


class Submesh:
    """A codim-0 (cell subset) or codim-1 (facet set) submesh.

    Host-side (numpy) replacement for ``dolfinx.mesh.create_submesh``: just the
    parent back-pointer + entity list.  Quadrature spaces built on it get a
    cell-local dofmap over the entities; operand evaluation and restricted
    assembly use the parent's geometry (reference codim tests:
    ``test_codim_external_operator.py:75-96,160-171``)."""

    def __init__(self, parent: Mesh, dim: int, entities: np.ndarray):
        self.parent = parent
        self.dim = int(dim)
        self.entities = np.asarray(entities, dtype=np.int32)
        self.codim = parent.tdim - self.dim
        assert self.codim in (0, 1), "only codim 0/1 submeshes supported"
        self.cell_type = parent.cell_type if self.codim == 0 else FACET_CELL[parent.cell_type]
        self.name = f"{parent.name}_submesh"

    @property
    def gdim(self):
        return self.parent.gdim

    @property
    def tdim(self):
        return self.dim

    @property
    def num_cells(self):
        return self.entities.shape[0]

    def cell_name(self):
        return self.cell_type

    # minimal duck-typing for quadrature-space dofmap construction
    @property
    def cells(self):
        import numpy as _np

        return _np.empty((self.num_cells, 0), dtype=_np.int32)

    @property
    def num_vertices(self):
        return 0

    @property
    def num_edges(self):
        return 0


class EntityMap:
    """Sub-to-parent entity index map (dolfinx ``EntityMap`` parity,
    reference ``test_codim_external_operator.py:160-171``)."""

    def __init__(self, submesh: Submesh):
        self.submesh = submesh

    def sub_topology_to_topology(self, entities, inverse=False):
        entities = np.asarray(entities)
        if not inverse:
            return self.submesh.entities[entities]
        lookup = {int(e): i for i, e in enumerate(self.submesh.entities)}
        return np.asarray([lookup[int(e)] for e in entities], dtype=np.int32)


def create_submesh(mesh: Mesh, dim: int, entities):
    """Create a codim-0/1 submesh (dolfinx-parity signature; returns
    (submesh, entity_map, None, None))."""
    sub = Submesh(mesh, dim, entities)
    return sub, EntityMap(sub), None, None


def locate_entities(mesh: Mesh, dim: int, marker) -> np.ndarray:
    """Entities (cells for dim==tdim, facets for tdim-1) whose every vertex
    satisfies ``marker`` (dolfinx parity)."""
    coords = mesh.points
    x = np.zeros((3, coords.shape[0]))
    x[: coords.shape[1]] = coords.T
    vert_ok = np.asarray(marker(x), dtype=bool)
    if dim == mesh.tdim:
        ok = vert_ok[mesh.cells].all(axis=1)
        return np.where(ok)[0].astype(np.int32)
    assert dim == mesh.tdim - 1
    ok = vert_ok[mesh.facets].all(axis=1)
    return np.where(ok)[0].astype(np.int32)


def locate_entities_boundary(mesh: Mesh, marker) -> np.ndarray:
    """Exterior facets whose *every* vertex satisfies ``marker(x)``.

    Mirrors ``dolfinx.mesh.locate_entities_boundary`` semantics: ``marker``
    receives coordinates with shape (gdim[+], n_points) and returns a bool
    array (the reference demos use e.g. ``lambda x: np.isclose(x[0], L)``,
    ``demo_plasticity_mohr_coulomb.py:131-136``)."""
    ext = mesh.exterior_facets
    fverts = mesh.facets[ext]  # (n_ext, nvf)
    coords = mesh.points  # (n_pts, gdim)
    x = np.zeros((3, coords.shape[0]))
    x[: coords.shape[1]] = coords.T
    vert_ok = np.asarray(marker(x), dtype=bool)
    ok = vert_ok[fverts].all(axis=1)
    return ext[ok]
