"""Function spaces and dofmaps.

Copy of ``dolfinx_external_operator_tpu/functionspace.py`` (numpy only): the port
keeps its own copy because importing any module of the JAX package
imports JAX.  Keep the two in step; ``tests/test_torch_substrate.py``
holds them bitwise equal.

Host-side (numpy) replacement for DOLFINx ``FunctionSpace`` + C++ dofmap creation
(consumed by the reference at ``fem.py:77`` and throughout).  Dofmaps are
plain int32 arrays built once on the host; there is no IndexMap/ghosting —
multi-device runs shard the *cell* axis instead (owner-computes, see
``parallel/``).

Also provides the ``DualSpace`` shim mirroring the reference
``src/dolfinx_external_operator/fem.py:20-88`` (needed so adjoint/action
paths type-check).
"""

from __future__ import annotations

import numpy as np

from .elements import Element, MixedElement, element as make_element
from .mesh import Mesh

__all__ = ["FunctionSpace", "DualSpace", "functionspace"]


def _prod(shape):
    n = 1
    for s in shape:
        n *= s
    return n


class FunctionSpace:
    """A (blocked) finite element space over a mesh.

    ``dofmap`` is the scalar per-cell dof array (n_cells, ndofs_per_cell);
    vector/tensor components are unrolled as ``scalar_dof * bs + comp``
    (same convention as the reference's ``get_unrolled_dofmap``,
    ``external_operator.py:18-26``)."""

    def __init__(self, mesh: Mesh, element):
        self.mesh = mesh
        self.element = element
        if isinstance(element, MixedElement):
            self._init_mixed()
            return
        self.value_shape = element.value_shape
        self.bs = element.block_size
        self._sub_spaces = ()
        self._build_dofmap()
        self._tab_cache = {}

    # -- mixed ----------------------------------------------------------
    def _init_mixed(self):
        """Mixed space: stacked sub-space dof numbering (sub i occupies the
        global range [offset_i, offset_i + ndofs_i))."""
        self.value_shape = self.element.value_shape
        self.bs = 1
        subs = []
        offset = 0
        for sub_el in self.element.sub_elements:
            V = FunctionSpace(self.mesh, sub_el)
            V._offset = offset
            V._parent = self
            offset += V.num_dofs
            subs.append(V)
        self._sub_spaces = tuple(subs)
        self.num_scalar_dofs = offset
        self.dofmap = None  # per-sub dofmaps are used instead
        self._unrolled = np.concatenate(
            [V.unrolled_dofmap + V._offset for V in subs], axis=1
        ).astype(np.int32)
        self._tab_cache = {}

    @property
    def num_sub_spaces(self) -> int:
        return len(self._sub_spaces)

    def sub(self, i: int):
        """Mixed space -> i-th sub-space; blocked space -> i-th component
        handle (dolfinx parity: ``V.sub(1)`` for a component BC,
        ``demo_plasticity_von_mises.py:216``)."""
        if self._sub_spaces:
            return self._sub_spaces[i]
        assert self.bs > 1, "sub() on a scalar space"
        return ComponentSubspace(self, i)

    @property
    def sub_offset(self) -> int:
        return getattr(self, "_offset", 0)

    # -- dofmap ---------------------------------------------------------
    def _build_dofmap(self):
        """Scalar dofmap over mesh entities (vertex / edge / face / interior).

        Edge dofs are orientation-corrected: global edge dofs are ordered
        from the lower to the higher global vertex id, so the (n-1) interior
        Lagrange nodes of a shared edge receive the SAME global dof from
        both incident cells (the role of DOLFINx's dof permutations)."""
        from .mesh import CELL_EDGES

        mesh, el = self.mesh, self.element
        counts = el.entity_counts
        parts = []
        offset = 0
        self._entity_offsets = {}
        if counts["vertex"] > 0:
            assert counts["vertex"] == 1
            self._entity_offsets["vertex"] = 0
            parts.append(mesh.cells.astype(np.int64))
            offset += mesh.num_vertices
        ne = counts["edge"]
        if ne > 0:
            self._entity_offsets["edge"] = offset
            ce = mesh.cell_edges.astype(np.int64)  # (ncells, n_local_edges)
            local_edges = np.asarray(CELL_EDGES[mesh.cell_type], dtype=np.int64)
            a, b = local_edges[:, 0], local_edges[:, 1]
            # element edge-node j runs local-vertex a -> b; global dof j runs
            # lower -> higher global vertex id
            aligned = mesh.cells[:, a] < mesh.cells[:, b]  # (ncells, nle)
            j = np.arange(ne, dtype=np.int64)
            jj = np.where(aligned[:, :, None], j[None, None, :], ne - 1 - j[None, None, :])
            ed = offset + ce[:, :, None] * ne + jj
            parts.append(ed.reshape(mesh.num_cells, -1))
            offset += mesh.num_edges * ne
        nf = counts.get("face", 0)
        if nf > 0:
            self._entity_offsets["face"] = offset
            cf = mesh.cell_facets.astype(np.int64)  # (ncells, n_local_facets)
            if nf == 1:
                # single face dof (tet P3 / hex Q2): orientation-free
                parts.append(offset + cf)
            else:
                # face-interior lattices (tet >= P4, hex >= Q3): map each
                # cell's local lattice position to the face's CANONICAL
                # (global-vertex-id-ordered) numbering so the incident
                # cells share dofs consistently
                from .elements import face_dof_permutations

                perm = face_dof_permutations(mesh.cell_type, el.degree, mesh.cells)
                fd = offset + cf[:, :, None] * nf + perm
                parts.append(fd.reshape(mesh.num_cells, -1))
            offset += mesh.num_facets * nf
        if counts["cell"] > 0:
            nc = counts["cell"]
            self._entity_offsets["cell"] = offset
            cell_dofs = offset + (np.arange(mesh.num_cells, dtype=np.int64)[:, None] * nc + np.arange(nc)[None, :])
            parts.append(cell_dofs)
            offset += mesh.num_cells * nc
        self.dofmap = np.concatenate(parts, axis=1).astype(np.int32) if parts else np.empty((mesh.num_cells, 0), np.int32)
        self.num_scalar_dofs = offset
        assert self.dofmap.shape[1] == el.num_scalar_dofs, (self.dofmap.shape, el.num_scalar_dofs)
        self._unrolled = None

    @property
    def num_dofs(self) -> int:
        """Total number of (unrolled) dofs."""
        return self.num_scalar_dofs * self.bs

    @property
    def unrolled_dofmap(self) -> np.ndarray:
        """(n_cells, ndofs_per_cell * bs) unrolled dof indices.

        For mixed spaces: concatenation of the (offset) sub-space dofmaps."""
        if getattr(self, "_unrolled", None) is None:
            dm, bs = self.dofmap, self.bs
            if bs == 1:
                self._unrolled = dm
            else:
                self._unrolled = (np.repeat(dm, bs, axis=1) * bs
                                  + np.tile(np.arange(bs, dtype=np.int32), dm.shape[1]))
        return self._unrolled

    # -- tabulation -----------------------------------------------------
    def tabulate(self, points: np.ndarray):
        """Cached scalar basis tabulation at reference points."""
        key = points.tobytes()
        hit = self._tab_cache.get(key)
        if hit is None:
            hit = self.element.tabulate(points)
            self._tab_cache[key] = hit
        return hit

    @property
    def is_quadrature(self) -> bool:
        return getattr(self.element, "family", None) == "quadrature"

    def dual(self) -> "DualSpace":
        """Reference parity: ``FunctionSpace.dual`` (``fem.py:26-28``)."""
        return DualSpace(self)

    def __eq__(self, other):
        return isinstance(other, FunctionSpace) and self.mesh is other.mesh and self.element == other.element \
            and getattr(self, "_offset", 0) == getattr(other, "_offset", 0)

    def __hash__(self):
        return hash((id(self.mesh), self.element, getattr(self, "_offset", 0)))

    def __repr__(self):
        return f"FunctionSpace({self.element}, ndofs={self.num_dofs})"


class ComponentSubspace:
    """A single component of a blocked space (for component-wise BCs)."""

    def __init__(self, parent: FunctionSpace, component: int):
        self.parent = parent
        self.component = int(component)
        self.mesh = parent.mesh
        self.value_shape = ()

    def __repr__(self):
        return f"ComponentSubspace({self.parent!r}, {self.component})"


class DualSpace:
    """Dual of a FunctionSpace, with a back-pointer to the primal space.

    Mirrors the reference shim ``fem.py:31-56`` used so that
    adjoint/Action-typed forms can type-check."""

    def __init__(self, primal: FunctionSpace):
        self.primal = primal
        self.mesh = primal.mesh
        self.value_shape = primal.value_shape

    def dual(self) -> FunctionSpace:
        return self.primal


def functionspace(mesh: Mesh, element_spec) -> FunctionSpace:
    """Create a function space.

    ``element_spec`` may be an Element/MixedElement, or a tuple like
    ``("Lagrange", degree)`` / ``("Lagrange", degree, shape)`` mirroring the
    dolfinx convenience API used throughout the reference demos (e.g.
    ``demo_plasticity_von_mises.py:211``)."""
    if isinstance(element_spec, (Element, MixedElement)):
        return FunctionSpace(mesh, element_spec)
    family, degree, *rest = element_spec
    shape = tuple(rest[0]) if rest else ()
    el = make_element(family, mesh.cell_type, degree, shape=shape)
    return FunctionSpace(mesh, el)
