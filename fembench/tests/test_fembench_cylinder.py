"""The thick cylinder's cell, ``vm-cylinder-fine.general-mg``: found by name
with its problem, its reference's sizes and layouts against the program's,
its two new per-layer readers, and whole runs at lc = 0.3 on the CPU
(sound, a fault planted under the timed path, and the f32 control)."""

import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from fembench.harness import catalog  # noqa: E402
from fembench.harness.trace import Trace  # noqa: E402
from fembench.harness.traffic import cohesion_factor  # noqa: E402
from fembench.reference.cylinder import Cylinder, layout  # noqa: E402
from fembench.reference.slope import strain  # noqa: E402
from fembench.reference.von_mises import Material, return_map  # noqa: E402

NAME = "vm-cylinder-fine.general-mg"
CPU = torch.device("cpu")
SEED = 2**31 + 7


def test_the_cell_and_its_problem_are_found_by_name():
    cell = catalog.Cell(NAME)
    assert cell.config["problem"] == "von_mises_cylinder" and cell.chips == 1
    found = catalog.problem_class(cell.config)
    assert (found.__module__, found.__name__) == (cell.Problem.__module__, "Problem")
    assert cell.driver().Cell.kind == "steps"
    assert {m["name"] for m in cell.end_to_end} == {"step_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "device_idle_pct.step", "host_reads_per_update", "assembly_ms_per_update.general",
        "mg_idle_ms_per_update", "pcg_iters_per_update", "mg_setup_ms_per_update",
        "mg_rounds_per_update"}
    assert cell.config["seed"]["yield_spread"] == 1e-15
    assert cell.problem(0).draw == 1.0 and 0 <= cell.problem(SEED).draw - 1.0 < 5e-15
    cell.config["seed"]["yield_spread"] = 1e-7
    problem = cell.problem(SEED)
    assert problem.draw == cohesion_factor(SEED, 1e-7) != 1.0
    assert problem.material.sigma_0 == cell.config["material"]["sigma_0"] * problem.draw


def test_the_reference_has_the_configurations_sizes():
    cfg = catalog.Cell(NAME).config
    cyl = Cylinder.from_config(cfg["mesh"])
    assert (cyl.n_dofs, cyl.n_cells, cyl.n_points) == (11222, 2700, 8100)
    assert (cyl.n_dofs, cyl.n_cells, cyl.n_points) == tuple(
        cfg["sizes"][k] for k in ("dofs", "cells", "gauss_points"))
    assert cyl.arc_chords == cfg["mesh"]["sectors"] and int(cyl.bc_mask.sum()) == 62
    with pytest.raises(ValueError, match="quads"):
        Cylinder.from_config(dict(cfg["mesh"], lc=0.1))


def test_the_references_layouts_are_the_programs():
    """At lc = 0.1: the dofmap, the clamped dofs and the unit pressure
    vector, and the strain and stress of a random increment."""
    from dolfinx_external_operator_torch.models.von_mises import build_cylinder_problem

    torch.set_num_threads(1)
    P = build_cylinder_problem(0.1, device="cpu")
    cyl = Cylinder(0.1)
    V = P["V"]
    assert (cyl.rings, cyl.sectors, cyl.n_cells) == (3, 18, 108)
    assert np.array_equal(np.asarray(V.unrolled_dofmap), cyl.dofmap)
    mask = np.zeros(V.num_dofs, bool)
    for bc in P["problem"].bcs:
        mask[np.asarray(bc.dofs)] = True
    assert np.array_equal(mask, cyl.bc_mask)
    P["loading"].value = 1.0
    P["sigma"].ref_coefficient.x.array[:] = torch.zeros(P["S"].num_dofs, dtype=torch.float64)
    F = P["problem"].F.vector()  # zero stress: the load alone, -f
    assert float((F + torch.as_tensor(cyl.f)).abs().max()) < 1e-15 * np.abs(cyl.f).max() * 10
    Du = torch.randn(V.num_dofs, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    P["Du"].x.array[:] = Du * 1e-4
    P["constitutive_update"]()
    arrays = cyl.on(CPU, torch.float64)
    mat = Material(70e3, 0.3, 700.0, 250.0)
    n = cyl.n_points
    sig, dp, _ = return_map(mat, strain(arrays, Du * 1e-4).reshape(-1, 4).T,
                            torch.zeros(4, n, dtype=torch.float64),
                            torch.zeros(n, dtype=torch.float64))
    assert 0 < int((dp > 0).sum()) < n
    prog = P["sigma"].ref_coefficient.data.reshape(-1, 4)
    assert float((prog - sig.T).abs().max() / sig.abs().max()) < 1e-14
    assert float((P["dp"].data - dp).abs().max() / dp.abs().max()) < 1e-14


def test_the_references_tangent_is_its_maps_derivative():
    mat = Material(70e3, 0.3, 700.0, 250.0)
    gen = torch.Generator().manual_seed(5)
    n = 64
    deps = torch.randn((4, n), dtype=torch.float64, generator=gen) * 3e-3
    sigma_n = torch.randn((4, n), dtype=torch.float64, generator=gen) * 80.0
    p = torch.rand(n, dtype=torch.float64, generator=gen) * 1e-3
    _, dp, C = return_map(mat, deps, sigma_n, p, tangent=True)
    assert 0 < int((dp > 0).sum()) < n
    h = 1e-7
    for k in range(4):
        e = torch.zeros((4, 1), dtype=torch.float64)
        e[k] = h
        fd = (return_map(mat, deps + e, sigma_n, p)[0]
              - return_map(mat, deps - e, sigma_n, p)[0]) / (2 * h)
        assert float((fd - C[:, k]).abs().max()) < 1e-5 * float(C.abs().max())


# -- the new per-layer readers ------------------------------------------------

def _events():
    """One step of two updates, an AMG-CG solve each with its set-up
    inside."""
    spans = [("fembench.window", 0, 1000), ("fembench.step", 10, 990),
             ("fembench.mg_solve", 100, 400), ("fembench.mg_setup", 110, 200),
             ("fembench.mg_solve", 500, 900), ("fembench.mg_setup", 525, 600)]
    kernels = [(0, 120), (130, 160), (180, 300), (300, 520), (540, 1000)]
    out = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
           for n, a, b in spans]
    out += [{"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": a, "dur": b - a,
             "args": {"correlation": i}} for i, (a, b) in enumerate(kernels)]
    out += [{"ph": "X", "cat": "cuda_runtime", "name": "launch", "ts": t, "dur": 1,
             "args": {"correlation": i}} for i, t in enumerate((5, 125, 170, 250, 530))]
    return out


def test_mg_setup_ms_per_update_reads_device_and_idle_in_the_set_up():
    reader = catalog.metric_reader("mg_setup_ms_per_update")
    tr = Trace(_events())
    # launched in a set-up: k1 (30 us), k2 (120 us) and k4 (460 us); idle
    # begun in one: 120-130 and 160-180 (30 us); 520-540 begun in the solve
    assert math.isclose(tr.device_s_in("fembench.mg_setup"), 610e-6)
    assert math.isclose(tr.idle_s_in("fembench.mg_setup"), 30e-6)
    assert math.isclose(tr.idle_s_in("fembench.mg_solve"), 20e-6)
    assert math.isclose(reader.read(tr, {"updates": 2}), 0.32)
    assert reader.read(tr, {"updates": 0}) is None


def test_pcg_iters_per_update_reads_the_counter_recorded_over_the_solves(monkeypatch):
    from dolfinx_external_operator_torch.utils import profiling

    reader = catalog.metric_reader("pcg_iters_per_update")
    monkeypatch.setattr(profiling, "_spans", {"deo.solve": 4})
    monkeypatch.setattr(profiling, "_recorded", {"solve.inner": 574})
    assert reader.read(None, {}) == 143.5
    monkeypatch.setattr(profiling, "_recorded", {})
    assert reader.read(None, {}) is None
    monkeypatch.setattr(profiling, "_spans", {})
    assert reader.read(None, {}) is None


# -- whole runs at lc = 0.3 ---------------------------------------------------

def small(lc=0.3):
    cell = catalog.Cell(NAME)
    nr, nt = layout(lc, 1.0, 1.3)
    cell.config["mesh"].update(lc=lc, rings=nr, sectors=nt)
    torch.set_num_threads(1)
    return cell


def test_sound_run_is_correct():
    from fembench.run import run_cell

    res = run_cell(small(), SEED, 0.2, 0, CPU)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 20 and res["info"]["newton_first_pass"][:13] == [0] + [1] * 12


def test_a_return_map_off_by_a_part_in_a_billion_is_not_correct(monkeypatch):
    """The callback's stress is scaled by 1 + 1e-9: Newton still converges
    on it, and the judge's stress gap sees it."""
    from dolfinx_external_operator_torch.models import von_mises as vm

    from fembench.run import run_cell

    real = vm.VonMisesMaterial.__call__

    def off(self, deps, sigma_n, p):
        C, sig, dp = real(self, deps, sigma_n, p)
        return C, sig * (1.0 + 1e-9), dp

    monkeypatch.setattr(vm.VonMisesMaterial, "__call__", off)
    res = run_cell(small(), SEED, 0.2, 0, CPU)
    assert res["failed"] == 0 and not res["correct"], res["checks"]


def test_the_f32_control_fails_a_limit():
    from fembench.tools.control import readings

    cell = small()
    r = readings(cell, SEED, CPU)
    limits = cell.spec["limits"]
    assert all(r["program"][k] <= limits[k] for k in limits), r
    assert any(r["control"][k] > limits[k] for k in limits), r
