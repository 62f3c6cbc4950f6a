"""The port's numpy host substrate against the JAX package's.

``dolfinx_external_operator_torch`` keeps its own copies of the mesh,
element, quadrature and function-space modules (importing the JAX
package's would import JAX).  These tests hold the copies bitwise equal to
the originals, and check that the port imports no JAX at all."""
import os
import subprocess
import sys

import numpy as np
import pytest

import dolfinx_external_operator_tpu as fem_j
from dolfinx_external_operator_tpu import elements as el_j
from dolfinx_external_operator_tpu import mesh as mesh_j
from dolfinx_external_operator_tpu import quadrature as q_j

import dolfinx_external_operator_torch as fem_t
from dolfinx_external_operator_torch import elements as el_t
from dolfinx_external_operator_torch import mesh as mesh_t
from dolfinx_external_operator_torch import quadrature as q_t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _mesh(mod, cell_type):
    if cell_type in ("triangle", "quadrilateral"):
        return mod.create_rectangle((0.0, 0.0), (1.2, 1.0), (5, 4), cell_type)
    return mod.create_unit_cube(2, 2, 2, cell_type)


@pytest.mark.parametrize("cell_type", ["triangle", "quadrilateral"])
@pytest.mark.parametrize("degree", [1, 2, 3])
def test_spaces_bitwise(cell_type, degree):
    mj, mt = _mesh(mesh_j, cell_type), _mesh(mesh_t, cell_type)
    _eq(mj.points, mt.points)
    _eq(mj.cells, mt.cells)
    _eq(mj.edges, mt.edges)
    _eq(mj.facets, mt.facets)
    _eq(mj.exterior_facets, mt.exterior_facets)
    for shape in ((), (2,)):
        Vj = fem_j.functionspace(mj, ("Lagrange", degree, shape))
        Vt = fem_t.functionspace(mt, ("Lagrange", degree, shape))
        _eq(Vj.dofmap, Vt.dofmap)
        _eq(Vj.unrolled_dofmap, Vt.unrolled_dofmap)
        assert Vj.num_dofs == Vt.num_dofs
    pts = np.random.default_rng(degree).uniform(0.0, 0.5, size=(7, 2))
    for a, b in zip(el_j.Element("Lagrange", cell_type, degree).tabulate(pts),
                    el_t.Element("Lagrange", cell_type, degree).tabulate(pts)):
        _eq(a, b)
    for qdeg in range(1, 2 * degree + 1):
        for a, b in zip(q_j.make_quadrature(cell_type, qdeg), q_t.make_quadrature(cell_type, qdeg)):
            _eq(a, b)
    facets = mj.exterior_facets[:5]
    _eq(fem_j.locate_dofs_topological(Vj, 1, facets), fem_t.locate_dofs_topological(Vt, 1, facets))
    _eq(fem_j.locate_dofs_topological(Vj.sub(1), 1, facets),
        fem_t.locate_dofs_topological(Vt.sub(1), 1, facets))


@pytest.mark.parametrize("cell_type", ["tetrahedron", "hexahedron"])
def test_3d_spaces_bitwise(cell_type):
    mj, mt = _mesh(mesh_j, cell_type), _mesh(mesh_t, cell_type)
    _eq(mj.points, mt.points)
    _eq(mj.cells, mt.cells)
    _eq(mj.facets, mt.facets)
    Vj = fem_j.functionspace(mj, ("Lagrange", 2))
    Vt = fem_t.functionspace(mt, ("Lagrange", 2))
    _eq(Vj.dofmap, Vt.dofmap)
    for a, b in zip(q_j.make_quadrature(cell_type, 2), q_t.make_quadrature(cell_type, 2)):
        _eq(a, b)


def test_plasticity_block_25x25_bitwise():
    """The main path's block: the port's helper against the construction of
    ``__graft_entry__._build_vm`` in the JAX package."""
    mesh, V, S, bc_dofs = fem_t.build_plasticity_block(25, 25)
    mj = fem_j.create_rectangle((0.0, 0.0), (1.2, 1.0), (25, 25), "triangle")
    Vj = fem_j.functionspace(mj, ("Lagrange", 2, (2,)))
    Sj = fem_j.functionspace(mj, fem_j.quadrature_element(mj.cell_name(), degree=2, value_shape=(4,)))
    bottom = fem_j.locate_dofs_geometrical(Vj, lambda x: np.isclose(x[1], 0.0))
    right = fem_j.locate_dofs_geometrical(Vj, lambda x: np.isclose(x[0], 1.2))
    bc_j = np.concatenate([np.concatenate([s * 2, s * 2 + 1]) for s in (bottom, right)])
    assert (V.num_dofs, mesh.num_cells) == (5202, 1250)
    _eq(mj.points, mesh.points)
    _eq(mj.cells, mesh.cells)
    _eq(Vj.unrolled_dofmap, V.unrolled_dofmap)
    _eq(bc_j, bc_dofs)
    assert S.element.degree == Sj.element.degree == 2
    assert S.element.value_shape == Sj.element.value_shape


def test_port_imports_no_jax():
    """The port (with the BCR and AMG solvers, cell sharding and the entry
    points, the Mohr-Coulomb material, surface, kernel wrapper and the
    comparison scripts, and the general pipeline: the form language,
    functions, the evaluator, expressions, assembly, external operators,
    the solvers with GMRES and BiCGStab, the petsc shim and the probes;
    the von Mises cylinder, the ICNN with its weights and the
    hyperelasticity model; the general pipeline's sharding, the utilities
    and the five demos), chip_smoke's module-level
    code, the card-only test file and the sharded tests' rank functions
    import no JAX."""
    code = ("import sys; import dolfinx_external_operator_torch, chip_smoke; "
            "sys.path.insert(0, 'tests'); import test_torch_cuda, _torch_shard_worker, "
            "_torch_general_shard_worker; "
            "from dolfinx_external_operator_torch.parallel import bcr, dist, mg, scatter, spmd; "
            "from dolfinx_external_operator_torch import convert, entry, problems; "
            "from dolfinx_external_operator_torch.models import mohr_coulomb; "
            "from dolfinx_external_operator_torch.ops import abbo_sloan, mohr_coulomb as mc_ops; "
            "from dolfinx_external_operator_torch.tools import ec_compare, k1_compare, "
            "schedule_bits, slice_bits; "
            "from dolfinx_external_operator_torch import (sym, dtypes, function, compile, "
            "expression, assembly, external_operator, solvers, petsc, krylov); "
            "from dolfinx_external_operator_torch.models import hyperelasticity, icnn, von_mises; "
            "icnn.load_isihara_weights(); "
            "from dolfinx_external_operator_torch.utils import checkpoint, plots, probes, profiling, roofline, "
            "taylor; from dolfinx_external_operator_torch import parallel; "
            "sys.path.insert(0, 'demos_torch'); import _common, demo_simple_example, "
            "demo_nonlinear_heat, demo_plasticity_von_mises, demo_plasticity_mohr_coulomb, "
            "demo_hyperelasticity; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
            "'dolfinx_external_operator_tpu'))); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_stops_its_children():
    """``chip_smoke.stop_children`` leaves no process of the script alive:
    the resource tracker that a ``spawn``-method process starts, and a
    child with a child of its own."""
    code = ("import multiprocessing as mp, os, subprocess, chip_smoke as c; "
            "p = mp.get_context('spawn').Process(target=os.getpid); p.start(); p.join(); "
            "subprocess.Popen(['sh', '-c', 'sleep 60 & sleep 60']); "
            "before = c.descendants(os.getpid()); c.stop_children(); "
            "print(len(before), c.descendants(os.getpid()))")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    # the tracker, sh and its two sleeps: at least sh and the tracker
    # by the time they were listed
    n_before, after = res.stdout.split(maxsplit=1)
    assert int(n_before) >= 2 and after.strip() == "[]", res.stdout + res.stderr


def test_kernel_tables_list_every_included_file():
    """Each library's file name hashes the files its table entry lists, so
    every file that a listed source includes with ``#include "..."`` must be
    listed too: an edited header then rebuilds the library."""
    import re

    from dolfinx_external_operator_torch._native import cuda as native

    def included(name, seen):
        seen.add(name)
        with open(os.path.join(native.CSRC_DIR, name)) as f:
            for inc in re.findall(r'^\s*#include\s+"([^"]+)"', f.read(), re.M):
                if inc not in seen:
                    included(inc, seen)
        return seen

    tables = {**{("cuda", k): v for k, v in native.KERNELS.items()},
              **{("host", k): v for k, v in native._HOST.items()}}
    for key, (sources, *_) in tables.items():
        assert included(sources[0], set()) == set(sources), key
