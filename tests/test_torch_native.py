"""The port's native (C++) topology kernels against its numpy fallback: the
counterpart of ``tests/test_native.py``.

``_native/loader.py`` builds the root ``csrc/topology.cpp`` into the port's
``_build/``, and ``mesh.Mesh`` numbers edges and facets with it where it
builds, with numpy otherwise (``Mesh._build_edges``, ``_build_facets``).
Both must give topologically identical meshes: the same edge and facet
sets and incidences (the numbering may differ).  The cases skip where the
library cannot be built (no C++ compiler)."""
import numpy as np
import pytest

from dolfinx_external_operator_torch import mesh as mesh_t
from dolfinx_external_operator_torch._native import loader
from dolfinx_external_operator_torch.mesh import CELL_EDGES, CELL_FACETS

CASES = [("triangle", 6), ("quadrilateral", 5), ("tetrahedron", 3), ("hexahedron", 3)]


@pytest.fixture(autouse=True)
def native():
    if not loader.available():
        pytest.skip("native topology library not built (no C++ compiler)")


def _mesh(cell_type, n):
    if cell_type in ("triangle", "quadrilateral"):
        return mesh_t.create_unit_square(n, n, cell_type)
    return mesh_t.create_unit_cube(n, n, n, cell_type)


def _edges(mesh):
    return {tuple(e) for e in np.sort(mesh.edges, axis=1).tolist()}


def _exterior(mesh):
    return {tuple(sorted(mesh.facets[f])) for f in mesh.exterior_facets}


def _check_incidence(mesh):
    """Each facet's recorded (cell, local facet) pairs hold its vertices,
    and each cell's local facets and edges name global ones with the same
    vertices."""
    lfs = CELL_FACETS[mesh.cell_type]
    for fidx in range(mesh.num_facets):
        verts = set(mesh.facets[fidx].tolist())
        for slot in range(2):
            c = mesh.facet_cells[fidx, slot]
            if c < 0:
                continue
            lfi = mesh.facet_local_index[fidx, slot]
            assert set(mesh.cells[c][list(lfs[lfi])].tolist()) == verts
    for k, lf in enumerate(lfs):
        got = np.sort(mesh.facets[mesh.cell_facets[:, k]], axis=1)
        assert np.array_equal(got, np.sort(mesh.cells[:, list(lf)], axis=1))
    for k, le in enumerate(CELL_EDGES[mesh.cell_type]):
        got = mesh.edges[mesh.cell_edges[:, k]]
        assert np.array_equal(got, np.sort(mesh.cells[:, list(le)], axis=1))


@pytest.mark.parametrize("cell_type,n", CASES)
def test_native_matches_numpy_topology(cell_type, n):
    mesh = _mesh(cell_type, n)

    # numpy sets, recomputed from scratch
    le = np.asarray(CELL_EDGES[cell_type], dtype=np.int32)
    ev = np.sort(mesh.cells[:, le], axis=-1).reshape(-1, 2)
    assert _edges(mesh) == {tuple(e) for e in np.unique(ev, axis=0).tolist()}

    lfs = [np.asarray(f) for f in CELL_FACETS[cell_type]]
    fv = np.sort(np.stack([mesh.cells[:, f] for f in lfs], axis=1), axis=-1)
    uniq, counts = np.unique(fv.reshape(-1, fv.shape[-1]), axis=0, return_counts=True)
    assert _exterior(mesh) == {tuple(r) for r in uniq[counts == 1].tolist()}


def test_rcb_partition_balanced_and_compact():
    mesh = mesh_t.create_unit_square(16, 16)
    mids = mesh.cell_midpoints()
    for parts in (2, 3, 8):
        p = loader.partition_rcb(mids, parts)
        counts = np.bincount(p, minlength=parts)
        assert counts.min() >= (mesh.num_cells // parts) - parts
        # compactness: each part's bounding box much smaller than the domain
        for k in range(parts):
            box = mids[p == k]
            assert (box.max(0) - box.min(0)).prod() < 1.01 / parts * 2.5


def test_facet_incidence_consistency():
    _check_incidence(mesh_t.create_unit_square(4, 4))


@pytest.mark.parametrize("cell_type,n", CASES)
def test_numpy_fallback_matches_native(cell_type, n, monkeypatch):
    """With the native library unavailable the mesh builds its edges and
    facets with numpy: the same edge, facet and exterior-facet sets as the
    native build's, each incidence consistent."""
    nat = _mesh(cell_type, n)
    want = (_edges(nat), {tuple(sorted(f)) for f in nat.facets.tolist()}, _exterior(nat))
    monkeypatch.setattr(loader, "available", lambda: False)
    fb = _mesh(cell_type, n)
    assert (_edges(fb), {tuple(sorted(f)) for f in fb.facets.tolist()}, _exterior(fb)) == want
    assert (fb.num_edges, fb.num_facets) == (nat.num_edges, nat.num_facets)
    _check_incidence(fb)
