"""The port's deterministic-assembly invariants: the counterpart of
``tests/test_determinism.py``.

The JAX package pins down that its scatter-adds are deterministic by
construction on XLA.  The port never uses ``index_add_`` (atomics on the
card): every scatter is a fixed gather table summed in a fixed order
(``parallel/scatter.py``).  These tests pin that down the same way, with
bit-identical results across (a) repeated evaluations, (b) freshly
rebuilt mesh/space/form objects, (c) repeated matrix-free actions and
(d) the fused plasticity step run twice.  Each result is also held to
the JAX package's on the same inputs (dof values made with numpy from a
seed): the heat forms within 1e-12 of the largest entry, the fused step
within 1e-12 (both dense paths with two f64 refinement rounds, as in
``tests/test_torch_slope_step.py``).

The slope's schedules with the fused solvers are also held bitwise across
fresh processes (``tools/schedule_bits.py``), and ``chip_smoke.py`` phase
26, which does so on the card, is held to fail on a difference.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dolfinx_external_operator_tpu as fj

import dolfinx_external_operator_torch as pt
from dolfinx_external_operator_torch import convert, problems
from dolfinx_external_operator_torch.tools import schedule_bits
from test_torch_slope_step import _jax_step

torch.set_num_threads(2)

N = 6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _dofs(n=N):
    """Seeded dof values of the P2 heat problem's unknown, near 1."""
    V = pt.functionspace(pt.create_unit_square(n, n), ("Lagrange", 2))
    return 1.0 + 0.2 * np.random.default_rng(11).standard_normal(V.num_dofs)


def _heat(fem, u0, n=N):
    """The heat forms of ``tests/test_determinism.py:15-24`` through
    ``fem`` (either package), u's dofs ``u0``: (F, J)."""
    mesh = fem.create_unit_square(n, n)
    V = fem.functionspace(mesh, ("Lagrange", 2))
    if fem is pt:
        u = convert.function_from_numpy(V, u0, device="cpu")
    else:
        u = fem.Function(V)
        u.x.array[:] = u0
    v, uh = fem.TestFunction(V), fem.TrialFunction(V)
    dx = fem.Measure("dx", metadata={"quadrature_degree": 4, "quadrature_scheme": "default"})
    F = fem.inner((1.0 + u * u) * fem.grad(u), fem.grad(v)) * dx
    return F, fem.derivative(F, u, uh)


def _close(port, ref, tol=1e-12):
    scale = max(float(np.abs(ref).max()), 1e-300)
    return float(np.abs(port - ref).max()) / scale <= tol


def test_vector_matrix_bitwise_repeatable():
    u0 = _dofs()
    F, J = _heat(pt, u0)
    b1 = pt.assemble_vector(F, device="cpu").numpy()
    b2 = pt.assemble_vector(F, device="cpu").numpy()
    assert np.array_equal(b1, b2), "vector assembly must be bitwise deterministic"
    A1 = pt.assemble_matrix(J, device="cpu").numpy()
    A2 = pt.assemble_matrix(J, device="cpu").numpy()
    assert np.array_equal(A1, A2), "matrix assembly must be bitwise deterministic"
    F_j, J_j = _heat(fj, u0)
    assert _close(b1, np.asarray(fj.assemble_vector(F_j)))
    assert _close(A1, np.asarray(fj.assemble_matrix(J_j)))


def test_bitwise_across_rebuilt_objects():
    """Fresh mesh/space/form objects (fresh compiled kernels and gather
    tables) give the bit-identical global vector."""
    u0 = _dofs()
    b1 = pt.assemble_vector(_heat(pt, u0)[0], device="cpu").numpy()
    b2 = pt.assemble_vector(_heat(pt, u0)[0], device="cpu").numpy()
    assert np.array_equal(b1, b2)
    assert _close(b1, np.asarray(fj.assemble_vector(_heat(fj, u0)[0])))


def test_ebe_action_bitwise_repeatable():
    u0 = _dofs()
    Jc = pt.create_form(_heat(pt, u0)[1], device="cpu")
    n = Jc.test_space.num_dofs
    x = np.random.default_rng(7).normal(size=n)
    y1 = Jc.action(torch.tensor(x)).numpy()
    y2 = Jc.action(torch.tensor(x)).numpy()
    assert np.array_equal(y1, y2)
    y_j = np.asarray(fj.create_form(_heat(fj, u0)[1]).action(x))
    assert _close(y1, y_j)


def test_fused_step_bitwise_repeatable():
    """The fused plasticity step (residual, dense solve, Newton loop) on the
    4x4 slope at load 8 is run-to-run deterministic, and within 1e-12 of
    the JAX package's step."""
    fp = pt.mohr_coulomb_slope_step(4, 4, route="plain", device="cpu", linear_solver="dense")
    outs = []
    for _ in range(2):
        Du, sig = fp.zero_state()
        Du, sig, norm, its, _ = fp.run_step(Du, sig, 8.0)
        outs.append((Du.numpy(), sig.numpy(), float(norm), int(its)))
    assert np.array_equal(outs[0][0], outs[1][0])
    assert np.array_equal(outs[0][1], outs[1][1])
    assert outs[0][2:] == outs[1][2:]
    fj_step = _jax_step("dense", refine=2)
    Du_j, sig_j = fj_step.zero_state()
    Du_j, sig_j, _, its_j, _ = fj_step.run_step(Du_j, sig_j, 8.0)
    assert outs[0][3] == int(its_j)
    assert _close(outs[0][0], np.asarray(Du_j))
    assert _close(outs[0][1], np.asarray(sig_j).reshape(outs[0][1].shape))


def _schedule_bits(*args):
    """A fresh process of ``tools/schedule_bits.py`` on the CPU, on one
    thread."""
    return subprocess.Popen(
        [sys.executable, "-m", "dolfinx_external_operator_torch.tools.schedule_bits",
         "--device", "cpu", *args],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _one_thread(fn):
    """``fn()`` on one thread, as the fresh processes run: a CPU
    reduction's bits depend on the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def test_schedules_bitwise_across_fresh_processes():
    """The 4x4 slope over ``SLOPE_LOADS[[0, 25, 45]]`` with dense, BCR,
    AMG-CG and elastic: this process's per-step Newton updates, inner
    iterations and Du fingerprints equal those of a fresh process run under
    ``--poison`` (deterministic mode, every uninitialized allocation NaN),
    which warns about no op."""
    solvers, idx = ("dense", "bcr", "mg", "elastic"), [0, 25, 45]
    child = _schedule_bits("--n", "4", "--loads", ",".join(map(str, idx)),
                           "--solvers", ",".join(solvers), "--poison")
    try:
        here = _one_thread(lambda: {s: schedule_bits.schedule(s, CPU, 4, problems.SLOPE_LOADS[idx])
                                    for s in solvers})
        out, err = child.communicate(timeout=120)
    finally:
        child.kill()
    assert child.returncode == 0, err
    head, *lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert head["threads"] == 1 and head["poison"] and head["empty_is_nan"]
    assert any(w.startswith("put_") for w in head["probe_warned"])
    there = {line.pop("solver"): line for line in lines}
    assert {s: line.pop("warned") for s, line in there.items()} == {s: [] for s in solvers}
    assert there == here
    assert [sum(here[s]["newton"]) for s in solvers] == [11] * 4


def test_fresh_process_phase_fails_on_a_difference(tmp_path, monkeypatch):
    """``chip_smoke.py`` phase 26 on the CPU: a phase whose reading differs
    from the fresh processes' fails it, naming the first step apart; so
    does a fresh process that fails."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "OUT_DIR", str(tmp_path))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    idx = [0, 45]
    ref = _one_thread(lambda: schedule_bits.schedule("bcr", CPU, 2, problems.SLOPE_LOADS[idx]))
    ref["inner"][1] += 1
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="bcr: phase 9's reading differs from the fresh processes' from "
                             "step 2"):
        chip_smoke.fresh_process_phase({"bcr_25x25": {"reading": ref}},
                                       ("--device", "cpu", "--n", "2", "--loads", "0,45"))
    with pytest.raises(chip_smoke.SmokeFailure, match=r"schedule_bits \(plain\) exited 2"):
        chip_smoke.fresh_process_phase({}, ("--device", "cpu", "--solvers", "nothing"))


def test_schedule_bits_times_a_schedule_only_when_asked(capsys):
    """``schedule_bits --time`` adds the fused step's wall seconds a step to
    its line and leaves the reading as it was; without it the line holds
    the reading alone (what phase 26 compares)."""
    args = ["--device", "cpu", "--n", "2", "--loads", "0,25", "--solvers", "mg"]
    lines = {}
    for flag in ([], ["--time"]):
        assert schedule_bits.main(args + flag) == 0
        lines[bool(flag)] = json.loads(capsys.readouterr().out.splitlines()[-1])
    timed = lines[True].pop("s_per_step")
    assert timed > 0 and lines[True] == lines[False]
    assert set(lines[False]) == {"solver", "newton", "inner", "du"}
