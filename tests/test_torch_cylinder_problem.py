"""The von Mises cylinder as a problem stepped by hand
(``models.von_mises.build_cylinder_problem``), and the benchmark's plain
J2 reference that judges it (``fembench/problems/von_mises_cylinder.py``).

On the CPU: ``build_cylinder_problem`` stepped as the benchmark's entry steps it gives
``solve_von_mises``'s bits at lc = 0.3 over the 20 steps, direct and with
cg + mg; ``VonMisesMaterial()`` gives the bits of the map before the
material took its constants; the program at lc = 0.1 (108 cells) with a
seeded yield stress is within the cell's limits of the reference over the
first 14 steps (the plastic ones from step 11); a stress or a hardening
variable altered by one part in a million fails the judge, and so do
steps that hand on a ``p`` or a stress left unchanged; and a load
step counts its AMG set-ups and PCG iterations; ``ir_pcg``'s batched
reads keep the bits of a read every iteration.  The card's captures,
made at the first solve only, are marked ``cuda``.  This file imports no JAX.
"""
import contextlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from dolfinx_external_operator_torch.models import von_mises as vm
from dolfinx_external_operator_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from fembench.harness import catalog, steps  # noqa: E402
from fembench.reference.cylinder import layout  # noqa: E402
from fembench.run import schedule  # noqa: E402

torch.set_num_threads(2)

CELL = "vm-cylinder-fine.general-mg"
MG = {"ksp_type": "cg", "pc_type": "mg"}
CPU = torch.device("cpu")
SEED = 2**31 + 5


def _cell(lc, n_steps):
    """The benchmark's cylinder cell at mesh size ``lc``, its schedule cut
    to the first ``n_steps`` steps."""
    cell = catalog.find(CELL)
    nr, nt = layout(lc, cell.config["mesh"]["R_i"], cell.config["mesh"]["R_e"])
    cell.config["mesh"].update(lc=lc, rings=nr, sectors=nt)
    cell.config["schedule"]["steps"] = n_steps
    return cell


def _by_hand(lc, opts, n_steps=20):
    """``build_cylinder_problem`` stepped as ``solve_von_mises`` steps it."""
    P = vm.build_cylinder_problem(lc, snes_opts=opts, device="cpu")
    eps = torch.full((P["V"].num_dofs,), np.finfo(np.float64).eps, dtype=torch.float64)
    its = []
    for load in P["q_lim"] * np.linspace(0, 1.1, 20) ** 0.5:
        P["loading"].value = load
        P["Du"].x.array[:] = eps
        its.append(P["problem"].solve()[0])
        P["u"].x.axpy(1.0, P["Du"].x)
        P["p"].x.axpy(1.0, P["dp"].x)
        P["sigma_n"].x.array[:] = P["sigma"].ref_coefficient.data
    return its, P


@pytest.mark.parametrize("opts", [None, MG], ids=["direct", "cg-mg"])
def test_stepped_by_hand_is_solve_von_mises(opts):
    its, P = _by_hand(0.3, opts)
    run = vm.solve_von_mises(lc=0.3, num_increments=20, snes_opts=opts, device="cpu")
    assert its == run["iterations"] and sum(its) > 20
    for a, b in ((P["u"].data, run["u"].data), (P["p"].data, run["p"].data),
                 (P["Du"].data, run["problem"].u.data),
                 (P["sigma"].ref_coefficient.data, run["sigma"].ref_coefficient.data)):
        assert torch.equal(a, b)
    assert P["q_lim"] == run["q_lim"] == vm.Q_LIM


def _map_before(deps, sigma_n, p):
    """The return map as written on the module's constants."""
    C = torch.as_tensor(vm.C_ELAS, dtype=deps.dtype)
    D = torch.as_tensor(vm.DEV4, dtype=deps.dtype)
    MU, H = vm.MU, vm.H_MOD
    sig_el = sigma_n + C @ deps
    s = D @ sig_el
    sig_eq = torch.sqrt(1.5 * (s * s).sum(0))
    f_el = sig_eq - vm.SIGMA_0 - H * p
    f_plus = (f_el + torch.sqrt(f_el * f_el)) / 2.0
    dp = f_plus / (3.0 * MU + H)
    plastic = f_el > 0.0
    one, zero = torch.ones((), dtype=deps.dtype), torch.zeros((), dtype=deps.dtype)
    sig_eq_safe = torch.where(sig_eq > 0.0, sig_eq, one)
    n_elas = torch.where(plastic, s / sig_eq_safe * f_plus / torch.where(plastic, f_el, one), zero)
    beta = torch.where(plastic, 3.0 * MU * dp / sig_eq_safe, zero)
    sig = sig_el - beta * s
    nn = n_elas[:, None, :] * n_elas[None, :, :]
    C_tang = (C[:, :, None] - 3.0 * MU * (3.0 * MU / (3.0 * MU + H) - beta) * nn
              - 2.0 * MU * beta * D[:, :, None])
    return C_tang, sig, dp


def test_default_material_gives_the_module_constants_bits():
    m = vm.VonMisesMaterial()
    assert (m.lmbda, m.mu, m.H, m.sigma_0) == (vm.LAMBDA, vm.MU, vm.H_MOD, vm.SIGMA_0)
    assert np.array_equal(m.C, vm.C_ELAS) and m.q_lim() == vm.Q_LIM
    gen = torch.Generator().manual_seed(11)
    n = 4096
    deps = torch.randn((4, n), dtype=torch.float64, generator=gen) * 3e-3
    sigma_n = torch.randn((4, n), dtype=torch.float64, generator=gen) * 80.0
    p = torch.rand(n, dtype=torch.float64, generator=gen) * 1e-3
    before = _map_before(deps, sigma_n, p)
    assert 0 < int((before[2] > 0).sum()) < n  # elastic and plastic points
    for now in (vm.return_mapping_kernel(deps, sigma_n, p),
                vm.return_mapping_kernel(deps, sigma_n, p, m)):
        assert all(torch.equal(a, b) for a, b in zip(now, before))
    flat = m(deps.T.reshape(-1), sigma_n.T.reshape(-1), p)
    assert torch.equal(flat[1], before[1].T.reshape(-1))
    stronger = vm.VonMisesMaterial(sigma_0=2 * vm.SIGMA_0)
    assert stronger.q_lim() == 2 * vm.Q_LIM
    assert int((vm.return_mapping_kernel(deps, sigma_n, p, stronger)[2] > 0).sum()) \
        < int((before[2] > 0).sum())


@pytest.fixture(scope="module")
def judged():
    """The cell at lc = 0.1 over its first 14 steps with a seeded yield
    stress, every step kept, and its problem."""
    cell = _cell(0.1, 14)
    cell.config["seed"]["yield_spread"] = 1e-7  # the configuration's is 1e-15
    problem = cell.problem(SEED)
    assert problem.draw != 1.0
    prog = cell.driver().Cell(cell.config, cell.traffic, problem.draw, CPU, SEED)
    w = steps.run(prog, schedule(cell.config), SEED, CPU, passes=1, sample=14, tail=0)
    assert w.failed == 0 and len(w.kept) == 14
    return cell, problem, sorted(w.kept, key=lambda s: s["load"]), w.updates


def test_program_is_within_the_cells_limits(judged):
    cell, problem, kept, updates = judged
    limits = cell.spec["limits"]
    assert updates[1:11] == [1] * 10 and min(updates[11:]) > 1
    for part in (kept[:8], kept[8:]):
        checks = problem.judge_steps(part, CPU)
        assert set(checks) == set(limits)
        assert all(checks[k] <= limits[k] for k in limits), checks


@pytest.mark.parametrize("key", ["sigma", "p"])
def test_a_state_altered_by_one_part_in_a_million_fails(judged, key):
    cell, problem, kept, _ = judged
    last = kept[-1]
    assert float(last["p"].max()) > 0.0  # the step was handed plastic points
    bad = dict(last, **{key: last[key] * (1.0 + 1e-6)})
    limits = cell.spec["limits"]
    assert all(v <= limits[k] for k, v in problem.judge_steps([last], CPU).items())
    checks = problem.judge_steps([bad], CPU)
    assert any(checks[k] > limits[k] for k in limits), checks


class _Ignored:
    """An array that takes no values: ``x.array[:] = v`` does nothing."""

    def __setitem__(self, idx, value):
        pass


@pytest.mark.parametrize("fault", [None, "p", "sigma_n"],
                         ids=["sound", "p-not-committed", "sigma-not-handed-on"])
def test_a_step_that_hands_on_a_stale_state_fails(fault, monkeypatch):
    """Three plastic steps of the cell at lc = 0.1, all kept: sound, they
    are ``correct``; where the entry leaves ``p`` as it was (``p += dp``
    skipped) or never hands the stress on as ``sigma_n``, each step agrees
    with the reference from the state it was handed, but the state the
    next one was handed does not follow from the step before."""
    from fembench.run import verdict

    cell = _cell(0.1, 3)
    cell.config["schedule"].update(linspace=[], then=[0.85, 0.9, 0.95])
    problem = cell.problem(SEED)
    prog = cell.driver().Cell(cell.config, cell.traffic, problem.draw, CPU, SEED)
    if fault == "p":
        monkeypatch.setattr(prog.P["p"].x, "axpy", lambda alpha, other: None)
    elif fault == "sigma_n":
        monkeypatch.setattr(prog.P["sigma_n"].x, "_proxy", _Ignored())
    w = steps.run(prog, schedule(cell.config), SEED, CPU, passes=1, sample=0, tail=3)
    assert w.failed == 0 and len(w.kept) == 3
    assert [s["serial"] for s in w.kept] == [2, 3, 4]
    limits = cell.spec["limits"]
    alone = [problem.judge_steps([s], CPU) for s in w.kept]
    assert all(c[k] <= limits[k] for c in alone for k in limits), alone
    checks = problem.judge_steps(w.kept, CPU)
    assert verdict(w.steps, w.failed, checks, limits) == (fault is None), checks


def _counted_steps(device):
    """Three steps of the lc = 0.3 cylinder with cg + mg: an elastic one
    (its first solve builds the hierarchy) and two plastic ones, the last
    under the profiler.  Returns the updates and PCG iterations of all
    three and of the last, the counters over the three, and the counts
    recorded over the last."""
    from torch.profiler import ProfilerActivity, profile

    P = vm.build_cylinder_problem(0.3, snes_opts=MG, device=device)
    solver = P["problem"].solver
    profiling.reset_counters()
    its = []
    for k, load in enumerate((0.5, 0.8, 0.95)):
        P["loading"].value = load * P["q_lim"]
        P["Du"].x.array[:] = torch.full_like(P["Du"].data, np.finfo(np.float64).eps)
        k0 = solver.ksp_iterations
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
        with profile(activities=acts) if k == 2 else contextlib.nullcontext():
            its.append(P["problem"].solve()[0])
        P["p"].x.axpy(1.0, P["dp"].x)
        P["sigma_n"].x.array[:] = P["sigma"].ref_coefficient.data
    last_inner = solver.ksp_iterations - k0
    return (its, solver.ksp_iterations, last_inner, profiling.counters(),
            profiling.recorded_counts(), profiling.span_counts())


def test_steps_count_their_mg_setups_and_pcg_iterations():
    its, inner, last_inner, counters, recorded, spans = _counted_steps("cpu")
    assert its[0] == 1 and its[2] > 1 and last_inner > its[2]
    assert counters["mg.setups"] == sum(its)
    assert counters.get("graphs.captures", 0) == 0  # no graph off the card
    assert counters["solve.inner"] == inner
    assert recorded["solve.inner"] == last_inner and recorded["newton.updates"] == its[2]
    assert spans["deo.solve.setup"] == spans["deo.solve"] == its[2]


@pytest.mark.cuda
def test_the_card_captures_its_graphs_at_the_first_solve_only():
    """The set-up, the PCG's first cycle and its batches are captured while
    the first step solves, and replayed after."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (see README: the port's card-only tests)")
    its, inner, last_inner, counters, recorded, spans = _counted_steps("cuda")
    assert counters["mg.setups"] == sum(its) and counters["graphs.captures"] >= 3
    assert recorded.get("graphs.captures", 0) == 0
    assert counters["solve.inner"] == inner and recorded["solve.inner"] == last_inner


def test_the_cells_record_is_its_configurations_schedule():
    cfg = _cell(0.02, 20).config
    loads = schedule(cfg)
    assert np.array_equal(loads, np.linspace(0, 1.1, 20) ** 0.5)
    rec = cfg["record"]
    assert len(rec["newton_per_step"]) == 20 == cfg["schedule"]["steps"]
    assert sum(rec["newton_per_step"]) == rec["newton_total"]
    assert json.loads(json.dumps(cfg)) == cfg


def _ir_pcg_read_each_iteration(mv64, mv32, M32, b, rtol, maxiter):
    """``mg.ir_pcg`` as it was written with one host read an f32
    iteration: the bits the batched reads must keep."""
    from dolfinx_external_operator_torch.parallel import mg

    F32 = torch.float32
    bnorm = float(torch.linalg.vector_norm(b))
    target = rtol * bnorm

    def pcg32(r32, tgt, budget):
        x = torch.zeros_like(r32)
        r = r32
        z = M32(r)
        rz = torch.dot(r, z)
        nb = torch.linalg.vector_norm(r)
        ok, ncur = torch.stack([(rz >= 0.0).to(F32), nb]).tolist()
        p, xb, k, k_best = z, x, 0, 0
        while ok and ncur > tgt and k < budget and k - k_best < mg._STALL_WINDOW:
            Ap = mv32(p)
            pAp = torch.dot(p, Ap)
            good = torch.isfinite(pAp) & (pAp > 0.0) & torch.isfinite(rz) & (rz > 0.0)
            alpha = torch.where(good, rz / torch.where(pAp > 0.0, pAp, 1.0), 0.0)
            x = x + alpha * p
            r = r - alpha * Ap
            z = M32(r)
            rz2 = torch.dot(r, z)
            beta = torch.where(rz > 0.0, rz2 / torch.where(rz > 0.0, rz, 1.0), 0.0)
            p = z + beta * p
            nn = torch.linalg.vector_norm(r)
            better = nn < nb
            xb = torch.where(better, x, xb)
            nb = torch.where(better, nn, nb)
            good = good & torch.isfinite(nn) & (nn < 100.0 * nb)
            rz = rz2
            k += 1
            ok, ncur, is_better = torch.stack([good.to(F32), nn, better.to(F32)]).tolist()
            if is_better:
                k_best = k
        return xb, k

    x = torch.zeros_like(b)
    r64, rnorm, k_tot, rounds, ok = b, bnorm, 0, 0, True
    xb, nbest = x, bnorm
    while ok and rnorm > target and rounds < mg._MAX_ROUNDS and k_tot < maxiter:
        t_rel = min(max(target / max(rnorm, 1e-300), mg._INNER_FLOOR), 0.5)
        dx, k = pcg32(r64.to(F32), float(np.float32(t_rel * rnorm)),
                      min(maxiter - k_tot, mg._INNER_CAP))
        x = x + dx.to(b.dtype)
        r64 = b - mv64(x)
        rn = float(torch.linalg.vector_norm(r64))
        if rn < nbest:
            xb, nbest = x, rn
        ok = np.isfinite(rn) and rn < rnorm
        rnorm, k_tot, rounds = rn, k_tot + k, rounds + 1
    return xb, k_tot


@pytest.mark.parametrize("maxiter, precond", [(10000, "jacobi"), (10000, "none"), (13, "jacobi")])
def test_batched_reads_keep_the_per_iteration_bits(maxiter, precond):
    """A 1D Laplacian plus a random SPD part, solved to 1e-12 with the f32
    PCG's tests read once a batch: the same iterate and iteration count as
    a read after every iteration, where the loop ends inside a batch on
    the target, on stagnation and on the budget; with ``graphs`` and
    without (off the card a given dict captures nothing)."""
    from dolfinx_external_operator_torch.parallel import mg

    n = 300
    gen = torch.Generator().manual_seed(4)
    Q = torch.randn((n, 20), dtype=torch.float64, generator=gen)
    A = (torch.diag(torch.full((n,), 2.0, dtype=torch.float64))
         - torch.diag(torch.ones(n - 1, dtype=torch.float64), 1)
         - torch.diag(torch.ones(n - 1, dtype=torch.float64), -1) + 1e-2 * Q @ Q.T)
    A32 = A.to(torch.float32)
    dinv = 1.0 / torch.diagonal(A32)
    M32 = (lambda r: dinv * r) if precond == "jacobi" else (lambda r: r.clone())
    b = torch.randn(n, dtype=torch.float64, generator=gen)
    args = (lambda x: A @ x, lambda x: A32 @ x, M32, b, 1e-12, maxiter)
    x_old, k_old = _ir_pcg_read_each_iteration(*args)
    for graphs in (None, {}):
        x_new, k_new = mg.ir_pcg(*args, graphs=graphs)
        assert k_new == k_old > 0 and torch.equal(x_new, x_old)
