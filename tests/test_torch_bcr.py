"""The port's block-cyclic-reduction solver against the JAX package's.

- ``bcr_factor``/``bcr_apply`` in f64 on the random SPD block-tridiagonal
  systems of ``tests/test_bcr.py`` agree with the JAX functions and with
  ``np.linalg.solve`` to 1e-10 relative; ``equilibrate`` (in place)
  agrees in f32 to 1e-6 and keeps identity rows at d = 1; ``ir_direct``
  signs its round count, and gives the eager round's bits and counts
  through ``fixed_round`` (converging, stalling, capped); ``bcr_factor``
  into a workspace gives the bits of the factor without one, in the same
  tensors call after call.
- ``build_bcr_statics`` is array-equal to the JAX package's (8x8, 25x25).
- The Mohr-Coulomb slope step with ``linear_solver="bcr"`` on the 12x12
  slope over ``linspace(2, 22.9, 50)[:8]`` (the protocol of
  ``tests/test_bcr.py``) gives the JAX BCR step's Newton list with Du
  within 1e-10, the port's dense step's (two refinement rounds) likewise,
  repeats bitwise, gives the bits of ``ir_direct``'s eager round with its
  rounds through ``fixed_round``, and refines at most 6 rounds per
  update.
- ``auto`` resolves to BCR above 10k dofs, and to AMG-CG on a mesh that is
  not a lattice, where ``"bcr"`` raises; a step built from a JAX step's
  statics (``convert.py``) runs BCR without a mesh.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dolfinx_external_operator_tpu import locate_dofs_geometrical
from dolfinx_external_operator_tpu.models.mohr_coulomb import build_slope_problem
from dolfinx_external_operator_tpu.parallel import bcr as bcr_j
from dolfinx_external_operator_tpu.parallel.spmd import FusedPlasticityStep as StepJ

import dolfinx_external_operator_torch as pt
from dolfinx_external_operator_torch import convert
from dolfinx_external_operator_torch import mesh as mesh_t
from dolfinx_external_operator_torch.ops import element_chain as ec
from dolfinx_external_operator_torch.parallel import bcr as bcr_t
from dolfinx_external_operator_torch.utils import profiling
from test_bcr import _random_block_tridiag
from test_torch_cuda import eager_bcr_solve
from test_torch_slope_step import RECORD_25X25

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)

LOADS = np.linspace(2, 22.9, 50)[:8]


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("m,B", [(1, 6), (2, 6), (5, 8), (8, 8), (11, 4)])
def test_factor_apply_matches_jax(m, B):
    """f64 factor + apply: equal to the JAX package's and to the dense
    solve, across odd, even and power-of-two block counts."""
    T, A = _random_block_tridiag(m, B)
    b = np.random.default_rng(1).normal(size=m * B)
    x_t = bcr_t.bcr_apply(bcr_t.bcr_factor(torch.tensor(T), m, B), torch.tensor(b)).numpy()
    x_j = np.asarray(bcr_j.bcr_apply(bcr_j.bcr_factor(jnp.asarray(T), m, B), jnp.asarray(b)))
    x_ref = np.linalg.solve(A, b)
    assert _rel(x_t, x_ref) < 1e-10
    assert _rel(x_t, x_j) < 1e-10


def test_equilibrate_matches_jax():
    """f32 equilibration, in place, equals the JAX package's to 1e-6
    relative and leaves identity (bc/padding) rows with d == 1."""
    m, B = 3, 4
    T, _ = _random_block_tridiag(m, B)
    r0, r1 = 5, 9
    for r in (r0, r1):
        T[r // B, r % B, :] = 0.0
        T[r // B, r % B, B + r % B] = 1.0
    rows = np.arange(m * B)
    diag_slot = (rows // B) * (B * 3 * B) + (rows % B) * (3 * B) + B + (rows % B)
    Tflat = T.ravel().astype(np.float32)
    Tflat_t = torch.tensor(Tflat)
    T_t, d_t = bcr_t.equilibrate(Tflat_t, torch.tensor(diag_slot), m, B)
    T_j, d_j = bcr_j.equilibrate(jnp.asarray(Tflat), jnp.asarray(diag_slot), m, B)
    assert T_t.dtype == d_t.dtype == torch.float32
    assert T_t.data_ptr() == Tflat_t.data_ptr()  # scaled in place
    assert float(d_t[r0]) == 1.0 and float(d_t[r1]) == 1.0
    assert _rel(d_t.numpy(), np.asarray(d_j)) < 1e-6
    assert _rel(T_t.numpy(), np.asarray(T_j)) < 1e-6


def test_ir_direct_signed_rounds():
    """A healthy refinement counts its rounds positive; one that stalls
    counts them negative."""
    m, B = 4, 6
    T, A = _random_block_tridiag(m, B)
    b = torch.tensor(np.random.default_rng(2).normal(size=m * B))
    A_t = torch.tensor(A)
    fact = bcr_t.bcr_factor(torch.tensor(T), m, B)
    x, k = bcr_t.ir_direct(lambda x: A_t @ x, lambda r: bcr_t.bcr_apply(fact, r), b, rtol=1e-12)
    assert k > 0
    assert float(torch.linalg.norm(b - A_t @ x)) < 1e-11 * float(torch.linalg.norm(b))
    _, k_bad = bcr_t.ir_direct(lambda x: A_t @ x, lambda r: 1e-3 * r, b, rtol=1e-12)
    assert k_bad < 0


def _solve_counts():
    c = profiling.counters()
    return (c.get("solve.rounds", 0), c.get("solve.short", 0), c.get("graphs.captures", 0),
            c.get("bcr.round_replays", 0))


# (solve32 from the f64 and f32 factors, rtol, sign of the rounds):
# converging on the f32 factor; stalling at rounding, below any reachable
# target, so the round before the last is the best; capped by a solve that
# halves the error each round
IR_CASES = {
    "converging": (lambda f64, f32: (lambda r: bcr_t.bcr_apply(f32, r.float()).double()),
                   1e-12, 1),
    "stalling": (lambda f64, f32: (lambda r: bcr_t.bcr_apply(f32, r.float()).double()),
                 1e-30, -1),
    "capped": (lambda f64, f32: (lambda r: 0.5 * bcr_t.bcr_apply(f64, r)), 1e-12, -1),
}


@pytest.mark.parametrize("case", list(IR_CASES))
def test_ir_direct_fixed_round_matches_eager(case):
    """``ir_direct`` with ``fixed_round``'s buffered round (no graphs off
    the card) against the eager composition, on two right-hand sides in
    turn through one round, as a solver reuses it: the same iterate bit for
    bit, the same signed rounds, ``solve.rounds`` and ``solve.short``; no
    capture and no replay counted."""
    make, rtol, sign = IR_CASES[case]
    m, B = 4, 6
    T, A = _random_block_tridiag(m, B)
    A_t = torch.tensor(A)
    solve32 = make(bcr_t.bcr_factor(torch.tensor(T), m, B),
                   bcr_t.bcr_factor(torch.tensor(T, dtype=torch.float32), m, B))
    rhs = [torch.tensor(np.random.default_rng(s).normal(size=m * B)) for s in (2, 3)]
    held = rhs[0].clone()
    round_fn = bcr_t.fixed_round(solve32, lambda x: A_t @ x, held)
    for b in rhs:
        profiling.reset_counters()
        x_e, k_e = bcr_t.ir_direct(lambda x: A_t @ x, solve32, b, rtol)
        eager = _solve_counts()
        held.copy_(b)
        profiling.reset_counters()
        x_f, k_f = bcr_t.ir_direct(None, None, b, rtol, round_fn=round_fn)
        assert torch.equal(x_f, x_e) and k_f == k_e
        assert _solve_counts() == eager
        assert eager[1] == (k_e < 0) and eager[2:] == (0, 0)
        assert k_e * sign > 0 and (case != "capped" or k_e == -bcr_t._MAX_ROUNDS)
        if case == "stalling":  # the last round is not the best
            x_last = x_e + solve32(b - A_t @ x_e)
            assert 1 < -k_e < bcr_t._MAX_ROUNDS and not torch.equal(x_last, x_e)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bcr_factor_workspace_bitwise(dtype):
    """``bcr_factor`` into a ``bcr_workspace``: every level's A, C, V, VL, VU
    and ``root_inv`` equal to the factor without one, bit for bit; a second
    call on other bands writes the same tensors (each ``data_ptr`` kept)
    with that band's factor."""
    m, B = 11, 4
    ws = bcr_t.bcr_workspace(m, B, dtype, "cpu")
    ptrs = [t.data_ptr() for lv in ws[0] for t in lv.values()] + [ws[1].data_ptr()]
    for seed in (0, 5):
        T = torch.tensor(_random_block_tridiag(m, B, seed)[0], dtype=dtype)
        levels, root = bcr_t.bcr_factor(T, m, B)
        levels_w, root_w = bcr_t.bcr_factor(T, m, B, workspace=ws)
        assert len(levels_w) == len(levels) == len(ws[0]) == 4
        for lv, lw, wv in zip(levels, levels_w, ws[0]):
            assert lv.keys() == lw.keys() == wv.keys()
            for k in lv:
                assert lw[k] is wv[k] and lw[k].dtype == dtype and torch.equal(lw[k], lv[k]), k
        assert root_w is ws[1] and torch.equal(root_w, root)
        assert [t.data_ptr() for lv in ws[0] for t in lv.values()] + [ws[1].data_ptr()] == ptrs


def _jax_slope(N):
    P = build_slope_problem(Nx=N, Ny=N)
    mat, mesh, V, S = P["material"], P["mesh"], P["V"], P["S"]
    bottom = locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0))
    right = locate_dofs_geometrical(V, lambda x: np.isclose(x[0], 1.2))
    bc_dofs = np.concatenate([np.concatenate([s * 2, s * 2 + 1]) for s in (bottom, right)])

    def kernel(deps, sn):
        C_tang, state = mat.tangent_stress_point(deps, sn)
        return C_tang, state[0]

    return mesh, V, S, kernel, bc_dofs


@pytest.mark.parametrize("N", [8, 25])
def test_build_statics_matches_jax(N):
    mesh_j, V_j, _, _, bc_j = _jax_slope(N)
    mask_j = np.zeros(V_j.num_dofs, bool)
    mask_j[bc_j] = True
    mesh, V, _, bc_dofs = pt.build_plasticity_block(N, N)
    mask = np.zeros(V.num_dofs, bool)
    mask[bc_dofs] = True
    info_j = bcr_j.build_bcr_statics(mesh_j, V_j, mask_j)
    info_t = bcr_t.build_bcr_statics(mesh, V, mask)
    assert info_t.keys() == info_j.keys()
    for k, a in info_j.items():
        b = info_t[k]
        assert type(a) is type(b) and np.asarray(a).dtype == np.asarray(b).dtype, k
        assert np.array_equal(a, b), k


def _bcr_counts():
    """The profiling counters of the BCR factorization, as
    ``{"factorizations": ..., "inv_levels": ...}``."""
    c = profiling.counters()
    return {"factorizations": c.get("bcr.factorizations", 0),
            "inv_levels": c.get("bcr.inv_levels", 0)}


def _schedule(fp, loads=LOADS):
    """(Du per step, Newton list, signed rounds per step) as numpy/ints."""
    Du, sig = fp.zero_state()
    dus, its, rounds = [], [], []
    for load in loads:
        Du, sig, _, it, cg = fp.run_step(Du, sig, float(load))
        dus.append(np.asarray(Du))
        its.append(int(it))
        rounds.append(int(cg))
    return dus, its, rounds


@pytest.fixture(scope="module")
def jax_bcr():
    fp = StepJ(*_jax_slope(12), linear_solver="bcr")
    return fp, _schedule(fp)


@pytest.fixture(scope="module")
def port_bcr():
    fp = pt.mohr_coulomb_slope_step(12, 12, route="plain", device="cpu", linear_solver="bcr")
    profiling.reset_counters()
    run = _schedule(fp)
    return fp, run, _bcr_counts()


def test_bcr_step_matches_jax(jax_bcr, port_bcr):
    _, (du_j, its_j, _) = jax_bcr
    fp, (du_t, its_t, _), _ = port_bcr
    assert fp.linear_solver == "bcr" and (fp._bcr["m"], fp._bcr["B"]) == (13, 100)
    assert its_t == its_j
    assert sum(its_t) > len(LOADS)  # the plastic regime is reached
    for a, b in zip(du_t, du_j):
        assert _rel(a, b) < 1e-10


def test_bcr_step_matches_dense(port_bcr):
    _, (du, its, _), _ = port_bcr
    fp_d = pt.mohr_coulomb_slope_step(12, 12, route="plain", device="cpu",
                                      linear_solver="dense", dense_refine=2)
    du_d, its_d, _ = _schedule(fp_d)
    assert its_d == its
    for a, b in zip(du, du_d):
        assert _rel(a, b) < 1e-10


def test_bcr_step_repeats_bitwise(port_bcr):
    fp, (du, its, rounds), _ = port_bcr
    du2, its2, rounds2 = _schedule(fp)
    assert (its2, rounds2) == (its, rounds)
    assert all(np.array_equal(a, b) for a, b in zip(du2, du))


def test_bcr_step_fixed_rounds_match_eager(port_bcr):
    """The fused step, its refinement rounds through ``fixed_round`` (the
    card's path, here without graphs), over the schedule: the Du bit for
    bit, the Newton list and the signed rounds of the step refined by
    ``ir_direct``'s eager round; nothing captured or replayed off the
    card over the whole schedule."""
    _, (du, its, rounds), _ = port_bcr
    fp = pt.mohr_coulomb_slope_step(12, 12, route="plain", device="cpu", linear_solver="bcr")
    fp._bcr_solve = eager_bcr_solve(fp)
    du_e, its_e, rounds_e = _schedule(fp)
    assert (its, rounds) == (its_e, rounds_e)
    assert all(np.array_equal(a, b) for a, b in zip(du, du_e))
    fp = pt.mohr_coulomb_slope_step(12, 12, route="plain", device="cpu", linear_solver="bcr")
    profiling.reset_counters()
    du2, its2, rounds2 = _schedule(fp)
    c = profiling.counters()
    assert (its2, rounds2) == (its_e, rounds_e)
    assert all(np.array_equal(a, b) for a, b in zip(du2, du_e))
    assert (c.get("graphs.captures", 0), c.get("graphs.replays", 0),
            c.get("bcr.round_replays", 0)) == (0, 0, 0)
    assert c["solve.rounds"] == sum(abs(r) for r in rounds_e) > 0


def test_bcr_rounds_bounded(port_bcr):
    """Every solve reached its target (positive counts), in at most 6
    refinement rounds per update on average, and no level left Cholesky."""
    _, (_, its, rounds), stats = port_bcr
    assert all(r > 0 for r, i in zip(rounds, its) if i > 0)
    assert sum(rounds) <= 6 * sum(its)
    assert stats == {"factorizations": sum(its), "inv_levels": 0}


def test_auto_resolves_to_bcr():
    """Above 10k dofs on a lattice ``auto`` picks BCR (setup only); at or
    below it, dense."""
    fp = pt.mohr_coulomb_slope_step(36, 36, device="cpu")
    assert fp.n_dofs > 10_000 and fp.linear_solver == "bcr"
    assert pt.mohr_coulomb_slope_step(4, 4, device="cpu").linear_solver == "dense"


def _holes_step(solver, lc):
    msh, *_ = mesh_t.build_square_with_elliptic_holes(lc=lc)
    V = pt.functionspace(msh, ("Lagrange", 2, (2,)))
    S = pt.functionspace(msh, pt.quadrature_element(msh.cell_name(), degree=2,
                                                    value_shape=(4,)))
    kernel = pt.MohrCoulombMaterial().batched_kernel("plain")
    return pt.FusedPlasticityStep(msh, V, S, kernel, np.array([0, 1]), device="cpu",
                                  linear_solver=solver)


def test_bcr_requires_lattice_mesh():
    with pytest.raises(ValueError, match="lattice"):
        _holes_step("bcr", 0.25)


def test_auto_on_non_lattice_mesh_picks_mg():
    """Above 10k dofs on a mesh that is not a lattice (the holed square,
    16,858 dofs) ``auto`` falls back from BCR to AMG-CG, as the JAX package
    does (setup only)."""
    fp = _holes_step("auto", 0.02)
    assert fp.n_dofs == 16858 and fp.linear_solver == "mg"
    assert fp._mg_mv0_mode == "node" and fp._bcr is None


def test_from_statics_runs_bcr(jax_bcr, port_bcr):
    """A JAX step's statics, with its BCR map carried across by
    ``convert.bcr_statics_from_numpy``, give the mesh-built step's
    results bit for bit, without a mesh."""
    fp_j, _ = jax_bcr
    _, (du, its, _), _ = port_bcr
    statics = {k: np.asarray(v) for k, v in fp_j.statics.items() if k != "bcr"}
    statics["bcr"] = convert.bcr_statics_from_numpy(fp_j.statics["bcr"], fp_j._bcr_plan)
    kernel = pt.MohrCoulombMaterial().batched_kernel("plain")
    fp = pt.FusedPlasticityStep.from_statics(statics, kernel, device="cpu",
                                             linear_solver="bcr")
    du_s, its_s, _ = _schedule(fp)
    assert its_s == its
    assert all(np.array_equal(a, b) for a, b in zip(du_s, du))
    del statics["bcr"]
    with pytest.raises(ValueError, match="statics\\['bcr'\\]"):
        pt.FusedPlasticityStep.from_statics(statics, kernel, device="cpu", linear_solver="bcr")


@pytest.mark.slow
def test_slope_25x25_bcr_full_schedule():
    """The main path's schedule with BCR on the CPU: the record's Newton
    list (171 updates), the JAX BCR step's list, and Du within 1e-8 of the
    JAX BCR step's at every step (measured: 3.6e-9 at step 29, under 1e-11
    at all but steps 29 and 30).  The refinement rounds are not the
    record's: here, as with the JAX package on the CPU, the linear solves
    of steps 1 and 2 stall short of 1e-13 (negative counts), and the total
    is ~555 rounds against the record's 335 (ROADMAP queue 3)."""
    fp = pt.mohr_coulomb_slope_step(25, 25, route="plain", device="cpu", linear_solver="bcr")
    profiling.reset_counters()
    du, its, _ = _schedule(fp, loads=pt.SLOPE_LOADS)
    assert its == RECORD_25X25 and sum(its) == 171
    assert _bcr_counts() == {"factorizations": 171, "inv_levels": 0}
    du_j, its_j, _ = _schedule(StepJ(*_jax_slope(25), linear_solver="bcr"), loads=pt.SLOPE_LOADS)
    assert its_j == its
    for a, b in zip(du, du_j):
        assert _rel(a, b) < 1e-8


@pytest.mark.slow
def test_slope_25x25_step29_gap_is_the_polish_stop():
    """Where Du at step 29 of the 25x25 schedule leaves the JAX package's
    (3.6e-9 against within 1e-11 elsewhere; ROADMAP queue 3).  From the
    JAX BCR state after 28 steps, at the iterate of step 29's third Newton
    pass: the residual assembled by the port from the JAX sigma is the JAX
    residual to 1e-15, but the return map is not.  One Gauss point's f64
    polish stops one iteration apart in the two packages, each under
    ``tol`` = 1e-8 of the lane's scale, and its sigma differs by ~2.4e-9
    of the largest entry, which the ill-conditioned last update carries
    into Du.  With ``tol`` = 1e-10 every point's iteration count agrees and
    sigma within 1e-12: the f32 start the two libraries' trig gives, not a
    fault of either."""
    from dolfinx_external_operator_tpu.models.mohr_coulomb import MohrCoulombMaterial as MatJ

    fj = StepJ(*_jax_slope(25), linear_solver="bcr")
    Du, sig = fj.zero_state()
    for load in pt.SLOPE_LOADS[:28]:
        Du, sig, *_ = fj.run_step(Du, sig, float(load))
    load = float(pt.SLOPE_LOADS[28])
    Du2 = fj._step(fj.statics, Du, sig, jnp.asarray(load), jnp.asarray(2),
                   jnp.asarray(fj.cg_rtol), jnp.asarray(jnp.nan))[0]
    fp = pt.mohr_coulomb_slope_step(25, 25, route="plain", device="cpu", linear_solver="bcr")
    deps = ec.cell_strain_reference(fp.statics["B"], fp.statics["dofmap"],
                                    torch.tensor(np.asarray(Du2))).reshape(-1, 4).T.contiguous()
    sn = torch.tensor(np.asarray(sig)).reshape(-1, 4).T.contiguous()
    gaps, sig_j = {}, {}
    for tol in (1e-8, 1e-10):
        f = jax.jit(jax.vmap(MatJ(tol=tol).tangent_stress_point, in_axes=(1, 1)))
        _, (s_j, it_j, *_) = f(jnp.asarray(deps.numpy()), jnp.asarray(sn.numpy()))
        _, (s_t, it_t, *_) = pt.MohrCoulombMaterial(tol=tol).tangent_stress(deps, sn)
        sig_j[tol] = s_j = np.asarray(s_j).T
        gap = np.abs(s_t.numpy() - s_j).max(0) / np.abs(s_j).max()
        gaps[tol] = (gap, int((it_t.numpy() != np.asarray(it_j)).sum()))
    gap, niter_diff = gaps[1e-8]
    assert 1e-9 < gap.max() < 1e-8 and (gap > 1e-12).sum() <= 3 and niter_diff >= 1
    gap, niter_diff = gaps[1e-10]
    assert gap.max() < 1e-12 and niter_diff == 0
    # the assembly downstream of the map agrees: port residual from the
    # JAX sigma against the JAX residual
    _, residual, *_, assemble_f = fj._local_ops()
    s_cells = jnp.asarray(sig_j[1e-8].T.reshape(fp.nc, fp.nq, 4))
    ident = lambda x: x  # noqa: E731
    r_j = np.asarray(residual(fj.statics, s_cells, load, ident, assemble_f(fj.statics, ident)))
    r_t = fp._residual(torch.tensor(np.asarray(s_cells)), load, fp._assemble_f()).numpy()
    assert np.abs(r_t - r_j).max() < 1e-15
