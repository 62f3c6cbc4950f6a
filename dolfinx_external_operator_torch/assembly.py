"""Dof location helpers (numpy, host side).

The subset of ``dolfinx_external_operator_tpu/assembly.py`` that the fused
plasticity step needs (``:686-755``): ``locate_dofs_topological``,
``locate_dofs_geometrical`` and ``_dof_coordinates``, copied so that the
port imports no JAX.  Form assembly is ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import numpy as np

from .elements import Element

__all__ = ["locate_dofs_geometrical", "locate_dofs_topological"]


def locate_dofs_topological(V, dim, entities) -> np.ndarray:
    """Scalar-block (full space) or unrolled (component subspace) dofs on
    the given facets.  Mirrors ``fem.locate_dofs_topological``
    (``demo_plasticity_von_mises.py:216-217``)."""
    from .functionspace import ComponentSubspace

    comp = None
    if isinstance(V, ComponentSubspace):
        comp = V.component
        V = V.parent
    mesh = V.mesh
    entities = np.asarray(entities, dtype=np.int32)
    counts = V.element.entity_counts
    offs = getattr(V, "_entity_offsets", {"vertex": 0, "edge": mesh.num_vertices})
    sdofs = set()
    fverts = mesh.facets[entities]
    if counts["vertex"]:
        sdofs.update(np.unique(fverts).tolist())
    ne = counts["edge"]
    if ne:
        edge_lookup = {tuple(e): i for i, e in enumerate(np.sort(mesh.edges, axis=1).tolist())}
        base = offs["edge"]
        for fv in fverts:
            vs = sorted(fv.tolist())
            for a in range(len(vs)):
                for b in range(a + 1, len(vs)):
                    e = edge_lookup.get((vs[a], vs[b]))
                    if e is not None:
                        sdofs.update(range(base + e * ne, base + (e + 1) * ne))
    nf = counts.get("face", 0)
    if nf:
        base = offs["face"]
        for f in entities.astype(np.int64).tolist():
            sdofs.update(range(base + f * nf, base + (f + 1) * nf))
    sdofs = np.array(sorted(sdofs), dtype=np.int64)
    if comp is None:
        return sdofs
    return sdofs * V.bs + comp


def locate_dofs_geometrical(V, marker) -> np.ndarray:
    """Scalar-block dofs whose coordinates satisfy ``marker`` (dolfinx
    parity: ``demo_plasticity_mohr_coulomb.py:139-140``)."""
    from .functionspace import ComponentSubspace

    comp = None
    if isinstance(V, ComponentSubspace):
        comp = V.component
        V = V.parent
    coords = _dof_coordinates(V)
    x = np.zeros((3, coords.shape[0]))
    x[: coords.shape[1]] = coords.T
    mask = np.asarray(marker(x), dtype=bool)
    sdofs = np.where(mask)[0].astype(np.int64)
    if comp is None:
        return sdofs
    return sdofs * V.bs + comp


def _dof_coordinates(V) -> np.ndarray:
    mesh = V.mesh
    ip = V.element.interpolation_points
    geo = Element("Lagrange", mesh.cell_type, 1)
    phi, _ = geo.tabulate(ip)
    pts = np.einsum("pv,cvg->cpg", phi, mesh.points[mesh.cells])
    coords = np.zeros((V.num_scalar_dofs, mesh.gdim))
    coords[V.dofmap.ravel()] = pts.reshape(-1, mesh.gdim)
    return coords
