"""Print the measured parity of the port's Mohr-Coulomb slice against the
JAX package, on the CPU: the numbers that ``test_torch_mohr_coulomb.py``
and ``test_torch_slope_step.py`` bound.

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py

Prints one JSON object: the surface's largest relative gaps (f32 and
f64), the return map's per-lane gaps on the bench strain mix (port against
JAX, kernel body against port), the 4x4 slope's Newton lists and Du gaps,
the residual that the 25x25 slope's first (linear) dense solve leaves
after 0, 1 and 2 refinement rounds on the CPU, and the BCR solver's
parity: the 12x12 slope over ``test_torch_bcr.LOADS`` (Newton lists, Du
gaps, signed refinement rounds, port against JAX and against the port's
dense step) and the 25x25 slope over the 52 steps (Newton lists and
rounds of both packages); and the AMG-CG and lagged-elastic solvers' parity
on the 12x12 slope over ``test_torch_mg.LOADS`` (Newton lists, Du gaps,
inner iterations per step, with full and frozen Galerkin levels and with
``fused_forcing``); the AMG-CG inner counts with each suspect of their
gap to the JAX package swapped for the JAX package's order or route, one
at a time (ROADMAP queue 3); and the general pipeline's parity
(``solve_slope_stability`` on the 4x4 and 8x8 slopes against the JAX
package's and against the port's fused step); and the general
pipeline's deferred solvers and models (``general_solvers``): GMRES and
BiCGStab against the direct solve on the heat problem, mg against direct
on the von Mises cylinder (lc=0.3, 20 increments; with both packages'
Newton lists, and the last step started from the JAX package's state),
the ICNN's P and dP/dF against the JAX ICNN, and the hyperelasticity
errors (lc=0.12, 2 steps; with ``--slow`` the record's lc=0.05 over 100
steps).  With ``--slow`` it also runs the 25x25 slope over the 52 steps
with AMG-CG and through the general path in both packages (several
minutes each).

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py --slow
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import conftest  # noqa: E402,F401  (JAX on the CPU)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_bcr as tb  # noqa: E402
import test_torch_mg as tg  # noqa: E402
import test_torch_mohr_coulomb as tm  # noqa: E402
import test_torch_slope_step as ts  # noqa: E402

import dolfinx_external_operator_torch as pt  # noqa: E402
from dolfinx_external_operator_torch.parallel import mg as mg_t  # noqa: E402


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def surface():
    out = {}
    states = tm.lode_states()
    for dt in ("float64", "float32"):
        tj, hj = tm.make_surface_j(tm.C_, tm.PHI, tm.A_COEF, tm.THETA_T, getattr(jnp, dt))
        tt, ht = tm.make_surface_t(tm.C_, tm.PHI, tm.A_COEF, tm.THETA_T, getattr(torch, dt))
        sj = jnp.asarray(states, dtype=getattr(jnp, dt))
        f_j, df_j = jax.vmap(tj)(sj)
        x = torch.tensor(states.T.copy(), dtype=getattr(torch, dt))
        f_t, df_t = tt(x)
        out[dt] = {"f": _rel(f_t, f_j), "grad": _rel(df_t.T, df_j),
                   "hess": _rel(ht(x).permute(2, 0, 1), jax.vmap(hj)(sj))}
    return out


def return_map():
    mj, mt = tm.MatJ(), tm.MatT()
    deps, sn = tm._bench_mix(tm.N_MIX)
    Cj, sj, stj = mj.tangent_and_stress(jnp.asarray(deps).ravel(), jnp.asarray(sn).ravel())
    d, s = tm._soa(deps), tm._soa(sn)
    plain = tm.ops_t.mc_return_map(d, s, mt)
    body = tm.ops_t.mc_return_map_host(d, s, mt)
    out = {"n": tm.N_MIX, "plastic_lanes": int((plain[2] > 0).sum()),
           "niter_max": int(plain[2].max())}
    for name, (C, sig, it), (C_ref, s_ref, it_ref) in (
            ("port_vs_jax", (plain[0].T.numpy(), plain[1].T.numpy(), plain[2].numpy()),
             (np.asarray(Cj), np.asarray(sj), np.asarray(stj["niter"]))),
            ("body_vs_port", (body[0].T.numpy(), body[1].T.numpy(), body[2].numpy()),
             (plain[0].T.numpy(), plain[1].T.numpy(), plain[2].numpy()))):
        gC, gs = tm._lane_gaps(C, C_ref, 16), tm._lane_gaps(sig, s_ref, 4)
        out[name] = {"C_max": float(gC.max()), "C_lanes_above_1e-10": int((gC > 1e-10).sum()),
                     "sig_max": float(gs.max()), "sig_lanes_above_1e-10": int((gs > 1e-10).sum()),
                     "niter_diff_lanes": int((np.asarray(it) != np.asarray(it_ref)).sum())}
    return out


def slope_4x4():
    out = {}
    for solver, refine in (("dense", 2), ("cg", None), ("dense_one_round", 1)):
        name = solver.split("_")[0]
        du_j, _, its_j = ts._schedule(ts._jax_step(name, refine))
        du_t, _, its_t = ts._schedule(ts._port_step(name, refine))
        out[solver] = {"newton_jax": its_j, "newton_port": its_t,
                       "du_rel": [_rel(a, b) for a, b in zip(du_t, du_j)]}
    return out


def first_solve_25x25():
    torch.set_num_threads(4)
    fp = pt.mohr_coulomb_slope_step(25, 25, route="plain", device="cpu")
    Du, sig = fp.zero_state()
    C_tang, sigma = fp._constitutive(Du, sig)
    mask = fp.statics["bc_mask"]
    b = torch.where(mask, Du - fp.statics["bc_vals"],
                    -fp._residual(sigma, float(pt.SLOPE_LOADS[0]), fp._assemble_f()))
    out = {"load_norm": float(b.norm())}
    for k in (0, 1, 2):
        fp._dense_refine = k
        x, _ = fp._dense_solve(C_tang, b)
        out[f"rounds_{k}"] = float((b - fp._bc_matvec(C_tang, x)).norm() / b.norm())
    return out


def bcr_slope():
    """The BCR step of both packages on the 12x12 slope (8 loads) and the
    25x25 slope (the 52-step schedule), and the port's dense step at
    12x12 (two refinement rounds)."""
    out, du_port = {}, {}
    for N, loads in ((12, tb.LOADS), (25, pt.SLOPE_LOADS)):
        du_j, its_j, cg_j = tb._schedule(tb.StepJ(*tb._jax_slope(N), linear_solver="bcr"), loads)
        du_t, its_t, cg_t = tb._schedule(
            pt.mohr_coulomb_slope_step(N, N, route="plain", device="cpu", linear_solver="bcr"),
            loads)
        du_port[N] = du_t
        out[f"{N}x{N}"] = {"newton_jax": its_j, "newton_port": its_t,
                           "rounds_jax": cg_j, "rounds_port": cg_t,
                           "du_rel": [_rel(a, b) for a, b in zip(du_t, du_j)]}
    du_d, its_d, _ = tb._schedule(pt.mohr_coulomb_slope_step(
        12, 12, route="plain", device="cpu", linear_solver="dense", dense_refine=2))
    out["12x12"].update(newton_port_dense=its_d,
                        du_rel_dense=[_rel(a, b) for a, b in zip(du_port[12], du_d)])
    return out


def mg_slope(slow):
    """The AMG-CG and lagged-elastic steps of both packages on the 12x12
    slope over ``tg.LOADS`` against the port's dense step (two refinement
    rounds); with ``slow`` the 25x25 slope over the 52 steps with AMG-CG."""
    out = {}
    du_d, its_d, _ = tg._schedule(tg._port_step(12, "dense", dense_refine=2))
    runs = (("mg", "mg", {}), ("elastic", "elastic", {}),
            ("mg_frozen", "mg", {"mg_opts": {"galerkin_levels": 1}}),
            ("mg_forcing", "mg", {"fused_forcing": True}))
    for name, solver, opts in runs:
        du_j, its_j, in_j = tg._schedule(tb.StepJ(*tb._jax_slope(12), linear_solver=solver,
                                                  **opts))
        du_t, its_t, in_t = tg._schedule(tg._port_step(12, solver, **opts))
        out[f"12x12_{name}"] = {"newton_jax": its_j, "newton_port": its_t,
                                "newton_port_dense": its_d, "inner_jax": in_j,
                                "inner_port": in_t,
                                "du_rel": [_rel(a, b) for a, b in zip(du_t, du_j)],
                                "du_rel_dense": [_rel(a, b) for a, b in zip(du_t, du_d)]}
    if slow:
        du_j, its_j, in_j = tg._schedule(tb.StepJ(*tb._jax_slope(25), linear_solver="mg"),
                                         pt.SLOPE_LOADS)
        du_t, its_t, in_t = tg._schedule(tg._port_step(25), pt.SLOPE_LOADS)
        out["25x25_mg"] = {"newton_jax": its_j, "newton_port": its_t, "inner_jax": in_j,
                           "inner_port": in_t, "inner_total_jax": sum(in_j),
                           "inner_total_port": sum(in_t),
                           "du_rel": [_rel(a, b) for a, b in zip(du_t, du_j)]}
    return out


def _seq_segment_sum(vals, table):
    """A gather-table sum left to right in position order (the order of a
    sequential scatter-add), in place of ``sum(dim=1)``."""
    ext = torch.cat([vals, vals.new_zeros(1)])
    acc = ext[table[:, 0]]
    for j in range(1, table.shape[1]):
        acc = acc + ext[table[:, j]]
    return acc


class _Linalg:
    """``torch`` for ``parallel/mg.py`` with ``linalg.inv`` replaced."""

    def __init__(self, inv):
        self._inv = inv

    def __getattr__(self, name):
        if name == "linalg":
            return type("L", (), {"__getattr__": lambda _, k: self._inv if k == "inv"
                                  else getattr(torch.linalg, k)})()
        return getattr(torch, name)


def _jax_start_lmax(matvec, dinv, n):
    x = torch.tensor(np.asarray(jnp.cos(1.234 * jnp.arange(n, dtype=jnp.float32))))
    lam = torch.ones((), dtype=torch.float32)
    for _ in range(mg_t._POWER_ITERS):
        y = dinv * matvec(x)
        lam = torch.linalg.vector_norm(y)
        x = y / torch.clamp(lam, min=1e-30)
    return 1.1 * lam


def mg_suspects():
    """The port's 12x12 AMG-CG inner counts per step (``tg.LOADS``) with
    each suspect of the gap to the JAX package swapped, one at a time, and
    all three at once; an f64 coarse inverse as a control."""
    from dolfinx_external_operator_torch.parallel import scatter

    jinv = lambda a: torch.tensor(np.asarray(jnp.linalg.inv(jnp.asarray(a.numpy()))))  # noqa: E731
    swaps = {"band_sums_in_order": {(scatter, "segment_sum"): _seq_segment_sum,
                                    (mg_t, "segment_sum"): _seq_segment_sum},
             "power_start_jnp_cos": {(mg_t, "_power_lmax"): _jax_start_lmax},
             "coarse_inv_jnp": {(mg_t, "torch"): _Linalg(jinv)},
             "coarse_inv_f64_control": {(mg_t, "torch"): _Linalg(
                 lambda a: torch.linalg.inv(a.double()).to(a.dtype))}}
    swaps["all_three_jax"] = {k: v for name in ("band_sums_in_order", "power_start_jnp_cos",
                                                 "coarse_inv_jnp") for k, v in swaps[name].items()}
    out = {"jax": tg._schedule(tb.StepJ(*tb._jax_slope(12), linear_solver="mg"))[2],
           "port": tg._schedule(tg._port_step(12))[2]}
    for name, patches in swaps.items():
        saved = {k: getattr(*k) for k in patches}
        try:
            for (mod, attr), fn in patches.items():
                setattr(mod, attr, fn)
            out[name] = tg._schedule(tg._port_step(12))[2]
        finally:
            for (mod, attr), fn in saved.items():
                setattr(mod, attr, fn)
    return out


def general_slope(slow):
    """``solve_slope_stability`` of both packages on the 4x4 slope (loads
    2, 8, 14) and the 8x8 slope (``linspace(2, 20, 4)``); the port's
    general path against its fused step at 4x4; with ``slow`` the 25x25
    slope over the 52 steps in both packages."""
    from dolfinx_external_operator_torch.models.mohr_coulomb import solve_slope_stability as st
    from dolfinx_external_operator_tpu.models.mohr_coulomb import solve_slope_stability as sj

    out = {}
    cases = [(4, np.linspace(2, 14, 3), {}), (8, np.linspace(2, 20, 4), {}),
             (4, np.linspace(2, 14, 3), {"snes_opts": {"ksp_type": "cg"}})]
    if slow:
        cases.append((25, pt.SLOPE_LOADS, {}))
    for n, loads, kw in cases:
        rj, rt = sj(n, n, loads, **kw), st(n, n, loads, device="cpu", **kw)
        key = f"{n}x{n}" + ("_cg" if kw else "")
        out[key] = {"newton_jax": rj["iterations"], "newton_port": rt["iterations"],
                    "u_rel": _rel(rt["u"].data.numpy(), np.asarray(rj["u"].data)),
                    "ksp_its": [rt["problem"].solver.ksp_iterations,
                                rj["problem"].solver.ksp_iterations]}
        if n == 4 and not kw:
            fp = pt.mohr_coulomb_slope_step(4, 4, route="plain", device="cpu")
            Du, sig = fp.zero_state()
            u = torch.zeros_like(Du)
            for load in loads:
                Du, sig, *_ = fp.run_step(Du, sig, float(load))
                u = u + Du
            out[key]["u_rel_fused"] = _rel(rt["u"].data.numpy(), u.numpy())
    return out


def _vm_last_step_from_jax_state(steps=20):
    """The cylinder's last step (lc=0.3) in the port started from the JAX
    package's state before it (sigma_n and p written into the port's
    hidden operands): both Newton counts and residual histories."""
    import inspect

    import dolfinx_external_operator_tpu.solvers as solvers_j
    from dolfinx_external_operator_tpu.models.von_mises import solve_von_mises as vm_j

    import dolfinx_external_operator_torch.solvers as solvers_t
    from dolfinx_external_operator_torch.models.von_mises import solve_von_mises as vm_t

    state, calls = {}, {"jax": 0, "port": 0}

    def hidden(problem):
        sigma = inspect.getclosurevars(problem.external_callback).nonlocals["sigma"]
        return {f.name: f for f in sigma.hidden_operands}

    def wrapped(mod, key):
        orig = mod.NewtonSolver.solve

        def solve(self, problem):
            if calls[key] == steps - 1:
                ops = hidden(problem)
                if key == "jax":
                    state.update({k: np.asarray(f.data).copy() for k, f in ops.items()})
                else:
                    for k, f in ops.items():
                        state[f"{k}_gap_to_jax"] = _rel(f.data.numpy(), state[k])
                        f._data = torch.tensor(state[k])
            calls[key] += 1
            out = orig(self, problem)
            if calls[key] == steps:
                state[f"history_{key}"] = list(self.history)
            return out

        return orig, solve

    origs = []
    for mod, key in ((solvers_j, "jax"), (solvers_t, "port")):
        orig, solve = wrapped(mod, key)
        origs.append((mod, orig))
        mod.NewtonSolver.solve = solve
    try:
        vm_j(lc=0.3, num_increments=steps)
        vm_t(lc=0.3, num_increments=steps, device="cpu")
    finally:
        for mod, orig in origs:
            mod.NewtonSolver.solve = orig
    # the yield function at the step's start (Du = eps, so deps ~ 0) on
    # the JAX package's state: every plastic point sits on the surface
    from dolfinx_external_operator_torch.models import von_mises as vmm

    sn = state["stress_n"].reshape(-1, 4).T
    s_dev = vmm.DEV4 @ sn
    f0 = np.sqrt(1.5 * (s_dev * s_dev).sum(0)) - vmm.SIGMA_0 - vmm.H_MOD * state["cumulative_plastic_strain"]
    return {"newton_jax": len(state["history_jax"]) - 1,
            "newton_port_from_jax_state": len(state["history_port"]) - 1,
            "gauss_points": int(f0.size), "points_with_abs_f_below_1e-9": int((np.abs(f0) < 1e-9).sum()),
            "max_abs_f_of_those": float(np.abs(f0[np.abs(f0) < 1e-9]).max(initial=0.0)),
            "positive_f": int((f0 > 0).sum()),
            **{k: v for k, v in state.items() if k.startswith(("history", "stress_n_gap",
                                                                "cumulative_plastic_strain_gap"))}}


def general_solvers(slow):
    """The deferred solvers and the two models, port against JAX (CPU)."""
    import test_torch_solvers as tsol
    from dolfinx_external_operator_tpu.models import hyperelasticity as he_j
    from dolfinx_external_operator_tpu.models import icnn as icnn_j
    from dolfinx_external_operator_tpu.models.von_mises import solve_von_mises as vm_j

    from dolfinx_external_operator_torch import convert
    from dolfinx_external_operator_torch.models import hyperelasticity as he_t
    from dolfinx_external_operator_torch.models.von_mises import solve_von_mises as vm_t

    out = {}
    direct = tsol._heat_solve(tsol.PKGS["port"], 7, "preonly", 1e-9)
    for ksp in ("gmres", "bicgstab"):
        runs = tsol._both(tsol._heat_solve, 7, ksp, 1e-9)
        out[f"heat_7x7_{ksp}"] = {"newton": [runs["port"][0], runs["jax"][0], direct[0]],
                                  "u_gap_to_direct": float(np.abs(runs["port"][2] - direct[2]).max()),
                                  "u_gap_to_jax": float(np.abs(runs["port"][2] - runs["jax"][2]).max())}
    mg = {"ksp_type": "cg", "pc_type": "mg"}
    vm = {f"{pkg}_{name}": fn(lc=0.3, num_increments=20, snes_opts=opts, **kw)
          for pkg, fn, kw in (("port", vm_t, {"device": "cpu"}), ("jax", vm_j, {}))
          for name, opts in (("direct", None), ("mg", mg))}
    out["von_mises_lc03_20"] = {
        **{f"newton_{k}": v["iterations"] for k, v in vm.items()},
        "inner_port_mg": sum(vm["port_mg"]["ksp_iterations"]),
        "probe_gap_mg_to_direct": float(np.abs(vm["port_mg"]["results"][:, 0]
                                               - vm["port_direct"]["results"][:, 0]).max()),
        "probe_gap_to_jax": float(np.abs(vm["port_direct"]["results"][:, 0]
                                         - vm["jax_direct"]["results"][:, 0]).max()),
        "last_step": _vm_last_step_from_jax_state()}
    # the dense solve's rounds on the cylinder's tangent after its first
    # linear step, by mesh size (chip_smoke.dense_rounds, seeded rhs)
    import chip_smoke

    out["dense_rounds_by_lc"] = {}
    for lc in (0.1, 0.05, 0.03):
        run = vm_t(lc=lc, num_increments=20, device="cpu", steps=2)
        out["dense_rounds_by_lc"][lc] = {"dofs": run["u"].function_space.num_dofs,
                                         "rel_residual_by_rounds": chip_smoke.dense_rounds(run, "cpu")}
    weights = icnn_j.load_isihara_weights()
    F = np.array([1.0, 0.0, 0.0, 1.0]) + 0.05 * np.random.default_rng(7).standard_normal((256, 4))
    dP_t, P_t = convert.icnn_from_numpy(weights, device="cpu").stress_and_tangent(torch.tensor(F))
    dP_j, P_j = icnn_j.ICNN(weights).stress_and_tangent(jnp.asarray(F))
    out["icnn_256"] = {"P_rel": _rel(P_t.numpy(), P_j), "dPdF_rel": _rel(dP_t.numpy(), dP_j)}
    kw = ({"lc": 0.05, "n_steps": 100, "max_displacement": 0.5} if slow
          else {"lc": 0.12, "n_steps": 2, "max_displacement": 0.1})
    ht, hj = he_t.run_comparison(device="cpu", **kw), he_j.run_comparison(**kw)
    out["hyperelasticity"] = {
        "config": kw, "rel_linf": [ht["rel_linf"], hj["rel_linf"]], "l2": [ht["l2"], hj["l2"]],
        "newton_nn": [sum(ht["nn"]["iterations"]), sum(hj["nn"]["iterations"])],
        "newton_isihara": [sum(ht["isihara"]["iterations"]), sum(hj["isihara"]["iterations"])],
        "u_gap_nn": float(np.abs(ht["nn"]["u"].data.numpy() - np.asarray(hj["nn"]["u"].data)).max())}
    return out


if __name__ == "__main__":
    torch.set_num_threads(2)
    print(json.dumps({"surface": surface(), "return_map": return_map(),
                      "slope_4x4": slope_4x4(), "first_solve_25x25_cpu": first_solve_25x25(),
                      "bcr_slope": bcr_slope(), "mg_slope": mg_slope("--slow" in sys.argv),
                      "mg_suspects": mg_suspects(),
                      "general_slope": general_slope("--slow" in sys.argv),
                      "general_solvers": general_solvers("--slow" in sys.argv)}))
