"""The comparison that decides ``correct``, shown to fail: whole runs of
each cell at a small size on the CPU (the harness's look for a card
skipped), with the timed path broken underneath, and with the plain
reference in the program's place one precision below the configuration's.
A sound run is correct; each fault and the f32 control are not.  On the
card, each cell's run is correct (marked ``cuda``; skips here)."""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from fembench.harness import catalog  # noqa: E402
from fembench.run import run_cell  # noqa: E402

HELD_OUT = "mc-slope-100x100.returnmap-mix"
CELLS = ["mc-slope-25x25.fused-dense", "mc-slope-25x25.general-lu",
         "mc-slope-100x100.fused-bcr", "mc-slope-25x25.fused-mg", HELD_OUT]
CPU = torch.device("cpu")
SEED = 2**31 + 5


def small(name):
    """The cell at 3 x 3 cells with a three-step schedule to 22 (a pool of
    two 54-point batches): every path, plastic points included; Newton is
    cut at 6 updates, so that a broken path fails soon."""
    cell = catalog.find(name)
    cell.config["mesh"].update(Nx=3, Ny=3)
    cell.config["newton"]["max_it"] = 6
    cell.config["schedule"] = {"linspace": [[2.0, 22.0, 3]], "steps": 3}
    if cell.traffic.get("resolves_to") == "bcr":
        cell.traffic["linear_solver"] = "bcr"
    if "mix" in cell.traffic:
        cell.traffic["mix"]["batches"] = 2
    torch.set_num_threads(1)
    return cell


def run(name, seconds=0.2):
    return run_cell(small(name), SEED, seconds, 0, CPU)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


# -- faults planted in the program under the timed path ----------------------

def _fused(monkeypatch, fault):
    from dolfinx_external_operator_torch.parallel.spmd import FusedPlasticityStep as FP

    if fault == "unchanged":
        monkeypatch.setattr(FP, "run_step", lambda self, Du, sn, load: (Du, sn, 0.0, 1, 0))
    elif fault == "half":
        orig = FP._constitutive

        def half(self, Du, sigma_n):
            C, sig = orig(self, Du, sigma_n)
            flat = sig.reshape(-1, 4).clone()
            flat[flat.shape[0] // 2:] = flat[:flat.shape[0] // 2].mean(0)
            return C, flat.reshape(sig.shape)

        monkeypatch.setattr(FP, "_constitutive", half)
    else:
        orig = FP.run_step

        def altered(self, Du, sn, load):
            out = list(orig(self, Du, sn, load))
            du = out[0].clone()
            du[int(torch.argmax(du.abs()))] *= 1.001
            out[0] = du
            return tuple(out)

        monkeypatch.setattr(FP, "run_step", altered)


def _general(monkeypatch, fault):
    from dolfinx_external_operator_torch import solvers
    from dolfinx_external_operator_torch.models.mohr_coulomb import MohrCoulombMaterial as M

    if fault == "unchanged":
        monkeypatch.setattr(solvers.NonlinearProblem, "solve", lambda self: (1, True))
    elif fault == "half":
        orig = M.tangent_and_stress

        def half(self, deps, sn, route="cuda"):
            C, sig, stats = orig(self, deps, sn, route)
            flat = sig.reshape(-1, 4).clone()
            flat[flat.shape[0] // 2:] = flat[:flat.shape[0] // 2].mean(0)
            return C, flat.reshape(-1), stats

        monkeypatch.setattr(M, "tangent_and_stress", half)
    else:
        orig = solvers.NonlinearProblem.solve

        def altered(self):
            out = orig(self)
            du = self.u._data.clone()
            du[int(torch.argmax(du.abs()))] *= 1.001
            self.u._data = du
            return out

        monkeypatch.setattr(solvers.NonlinearProblem, "solve", altered)


def _kernel(monkeypatch, fault):
    from dolfinx_external_operator_torch.models.mohr_coulomb import MohrCoulombMaterial as M

    orig = M.batched_kernel

    def faulty(self, route="cuda"):
        k = orig(self, route)

        def call(deps, sn):
            C, sig = k(deps, sn)
            if fault == "unchanged":
                return C, sn.clone()
            sig = sig.clone()
            n = sig.shape[1]
            if fault == "half":
                sig[:, n // 2:] = sig[:, :n // 2].mean(1, keepdim=True)
            else:
                sig[0, int(torch.argmax(sig[0].abs()))] *= 1.001
            return C, sig

        return call

    monkeypatch.setattr(M, "batched_kernel", faulty)


PLANT = {"fused-dense": _fused, "fused-bcr": _fused, "fused-mg": _fused,
         "general-lu": _general, "returnmap-mix": _kernel}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(monkeypatch, name, fault):
    PLANT[name.split(".", 1)[1]](monkeypatch, fault)
    res = run(name)
    assert not res["correct"], (fault, res["checks"])


# -- the control: the reference in the program's place, in f32 ---------------

def _reference_steps(monkeypatch, dtype):
    """The fused step's ``run_step`` replaced by the reference's own solve of
    the step in ``dtype``."""
    from dolfinx_external_operator_torch.parallel.spmd import FusedPlasticityStep as FP

    def reference_step(self, Du, sn, load):
        cfg = self._fembench_cfg
        problem = catalog.problem_class(cfg)(cfg, SEED)
        (step,) = problem.control_steps([{"load": load, "sigma_n": sn, "Du_in": Du}], CPU,
                                        dtype)
        return step["Du"].to(torch.float64), step["sigma"].to(torch.float64), 0.0, 1, 0

    monkeypatch.setattr(FP, "run_step", reference_step)


@pytest.mark.parametrize("dtype, correct", [(torch.float32, False), (torch.float64, True)])
def test_reference_in_the_programs_place(monkeypatch, dtype, correct):
    from dolfinx_external_operator_torch.parallel.spmd import FusedPlasticityStep as FP

    cell = small("mc-slope-25x25.fused-dense")
    monkeypatch.setattr(FP, "_fembench_cfg", cell.config, raising=False)
    _reference_steps(monkeypatch, dtype)
    res = run_cell(cell, SEED, 0.2, 0, CPU)
    assert res["correct"] == correct, res["checks"]


def test_f32_return_map_in_the_kernels_place(monkeypatch):
    from dolfinx_external_operator_torch.models.mohr_coulomb import MohrCoulombMaterial as M

    cfg = small("mc-slope-100x100.returnmap-mix").config
    problem = catalog.problem_class(cfg)(cfg, SEED)

    def f32_kernel(self, route="cuda"):
        def call(deps, sn):
            (b,) = problem.control_points([{"deps": deps, "sigma_n": sn}], torch.float32)
            return b["tangent"].to(torch.float64), b["sigma"].to(torch.float64)
        return call

    monkeypatch.setattr(M, "batched_kernel", f32_kernel)
    res = run("mc-slope-100x100.returnmap-mix")
    assert not res["correct"], res["checks"]


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", [c for c in CELLS if c != HELD_OUT])
def test_cell_is_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "fembench", "run.py"),
                          "--workload", name, "--seed", "3", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line["checks"]
