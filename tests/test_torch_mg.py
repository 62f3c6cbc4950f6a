"""The port's AMG-CG and lagged-elastic solvers against the JAX package's.

- ``build_mg_statics`` is array-equal to the JAX package's, in every array
  and static tuple (8x8 slope in dia and scalar numbering, 12x12 with full
  and frozen Galerkin levels).
- ``mg_setup``'s level values equal scipy's P^T K P at every level, in the
  original and in the lattice numbering (``tests/test_mg.py:54``, ``:440``).
- One cycle on a seeded r is within 1e-5 relative of the JAX ``vcycle`` and
  is a linear operator; ``ir_pcg`` keeps identity bc rows and reaches 1e-11
  with a nonzero bc right-hand side (``tests/test_mg.py:248``); the node,
  scalar and banded level-0 matvecs are one linear map; the block and
  stencil transfers equal the scalar prolongator and its transpose; ``dia``
  falls back to ``node`` off the lattice.
- The 12x12 slope over ``LOADS`` with ``"mg"`` and ``"elastic"``: the JAX
  step's Newton list and the port's dense step's, Du within 1e-10 of the
  JAX step's; inner counts within the bounds measured below (ROADMAP queue
  3: f32 sums in another order shift where an inner round stalls).
- Frozen Galerkin levels equal full ones; ``fused_forcing`` lowers the
  inner count; a step built from a JAX step's statics
  (``convert.mg_statics_from_numpy``) gives the mesh-built step's bits.
- The 8x8 slope over ``LOADS``, dia and node mode: the step's AMG-CG
  through its kept workspace gives a fresh hierarchy's bits at every
  update.
"""
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from dolfinx_external_operator_tpu.parallel import mg as mg_j
from dolfinx_external_operator_tpu.parallel.spmd import FusedPlasticityStep as StepJ

import dolfinx_external_operator_torch as pt
from dolfinx_external_operator_torch import convert
from dolfinx_external_operator_torch import mesh as mesh_t
from dolfinx_external_operator_torch.parallel import mg as mg_t
from dolfinx_external_operator_torch.parallel import spmd
from test_torch_bcr import _jax_slope
from test_torch_slope_step import RECORD_25X25

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)

LOADS = (2.0, 6.0, 10.0, 14.0)  # the protocol of tests/test_mg.py:131-162


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _assert_same(a, b, path="mg"):
    """Equal nested statics: the same keys, types, dtypes and values."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    else:
        assert a == b, path


def _jax_elastic(N):
    """mesh, V, bc mask and elastic element blocks as the JAX step's
    ``_setup_mg`` computes them."""
    mesh, V, S, kernel, bc = _jax_slope(N)
    fp = StepJ(mesh, V, S, kernel, bc, linear_solver="cg")
    C_el = np.asarray(kernel(jnp.zeros(4, jnp.float64), jnp.zeros(4, jnp.float64))[0])
    B_np = np.asarray(fp.statics["B"])[:fp.nc]
    K_el = np.einsum("cqik,ij,cqjl,cq->ckl", B_np, C_el, B_np, fp._wdet, optimize=True)
    return mesh, V, fp.bc_mask_np, K_el


def _port_step(N, solver="mg", **opts):
    return pt.mohr_coulomb_slope_step(N, N, route="plain", device="cpu", linear_solver=solver,
                                      **opts)


def _port_elastic(N):
    mesh, V, S, bc = pt.build_plasticity_block(N, N)
    st = spmd.host_statics(mesh, V, S, bc)
    return mesh, V, st["bc_mask"], _port_step(N, "cg")._elastic_blocks(st)


@pytest.mark.parametrize("N,opts", [(8, {"dia": True}), (8, {"dia": False}),
                                    (12, {"dia": True}), (12, {"dia": True, "galerkin_levels": 1})])
def test_build_statics_matches_jax(N, opts):
    mesh_j, V_j, mask_j, K_j = _jax_elastic(N)
    mesh, V, mask, K = _port_elastic(N)
    assert np.array_equal(mask, mask_j) and np.array_equal(K, K_j)
    _assert_same(mg_t.build_mg_statics(mesh, V, mask, K, **opts),
                 mg_j.build_mg_statics(mesh_j, V_j, mask_j, K_j, **opts))


def _masked_elastic32(fp):
    """The bc-masked elastic element blocks of a port step, f32."""
    K = torch.as_tensor(fp._elastic_tangent())
    st = fp.statics
    Kc = torch.einsum("cqik,ij,cqjl,cq->ckl", st["B"], K, st["B"], st["wdet"])
    km = fp._keep_cell
    return (Kc * km[:, :, None] * km[:, None, :]).to(torch.float32)


def _ell_csr(cols, vals, n):
    cols = cols.numpy()
    rows = np.repeat(np.arange(cols.shape[0]), cols.shape[1])
    return sp.coo_matrix((vals.numpy().ravel().astype(np.float64), (rows, cols.ravel())),
                         shape=(n, n)).tocsr()


@pytest.mark.parametrize("mode", ["scalar", "dia"])
def test_galerkin_values_match_scipy(mode):
    """Every level's f32 values equal scipy's P^T K P of the level above
    (level 1 from the bc-eliminated level-0 matrix and the P2 -> P1
    interpolation; in dia mode permuted into the lattice numbering), to
    f32 accuracy."""
    fp = _port_step(8, mg_opts={"mv0_mode": mode})
    assert fp._mg_mv0_mode == mode
    plan, n, mask = fp._mg, fp.n_dofs, fp.statics["bc_mask"].numpy()
    K32 = _masked_elastic32(fp)
    rt = mg_t.mg_setup(plan, K32)
    dm = fp.statics["dofmap"].numpy()
    K0 = mg_t._eliminate_bc(mg_t._csr_from_blocks(K32.double().numpy(), dm, n), mask)
    P0 = mg_t._p2_to_p1_interpolation(fp.mesh, 2, mask)
    K_ref = (P0.T @ K0 @ P0).tocsr()
    if mode == "dia":
        perm, _ = mg_t._lattice_node_perm(fp.mesh.points[:, :2])
        p1 = (perm[:, None] * 2 + np.arange(2)[None, :]).ravel()
        K_ref = K_ref[p1][:, p1].tocsr()
    levels = plan["levels"]
    assert len(levels) >= 2
    for k, (lvl, vals) in enumerate(zip(levels, rt["vals"])):
        got = _ell_csr(lvl["cols"], vals, lvl["n"])
        assert abs(got - K_ref).max() < 5e-6 * abs(K_ref).max(), k
        x = np.random.default_rng(k).normal(size=lvl["n"]).astype(np.float32)
        y = rt["mvs"][k](torch.tensor(x)).numpy()
        assert np.abs(y - K_ref @ x).max() < 1e-4 * np.abs(K_ref @ x).max(), k
        if k + 1 < len(levels):
            t = plan["transfers"][k + 1]
            Pi, Pw = t["P_idx"].numpy(), t["P_w"].numpy().astype(np.float64)
            P = sp.coo_matrix((Pw.ravel(), (np.repeat(np.arange(Pi.shape[0]), Pi.shape[1]),
                                            Pi.ravel())), shape=(lvl["n"], levels[k + 1]["n"]))
            K_ref = (P.T @ K_ref @ P).tocsr()


def _smooth_residual(plan, rt, rng):
    """A x, f32, for x a seeded coarsest-level vector prolonged to level 0
    (level-0 numbering of the plan's cycle)."""
    x = torch.tensor(rng.normal(size=plan["levels"][-1]["n"]).astype(np.float32))
    for t in plan["transfers"][:0:-1]:
        x = mg_t._prolong(t, x)
    if "stencil" in plan:
        x = mg_t._stencil_prolong(plan["stencil"], x)
    else:
        x = mg_t._prolong(plan["transfers"][0], x)
    return rt["mv0"](x).numpy()


@pytest.mark.parametrize("gamma", [(1, 2), 2], ids=["gamma12", "gamma2"])
@pytest.mark.parametrize("mode", ["dia", "scalar"])
def test_vcycle_matches_jax_and_is_linear(mode, gamma):
    """One cycle of each package on the same elastic values and seeded
    residuals: within 1e-5 relative (f32; the sums run in another order),
    and linear.  With ``coarse_target=20`` the 8x8 hierarchy has three
    levels below level 0 (162, 30, 6 dofs), so ``gamma_coarse=2`` repeats
    the correction from level 2, itself a two-grid cycle (``level_solve``'s
    loop on the next level's operator), as the 25x25 and 100x100 W-cycles
    repeat theirs."""
    opts = {"mv0_mode": mode, "coarse_target": 20}
    mesh, V, S, kernel, bc = _jax_slope(8)
    fp_j = StepJ(mesh, V, S, kernel, bc, linear_solver="mg", mg_opts=dict(opts))
    fp_t = _port_step(8, mg_opts=dict(opts))
    K32 = _masked_elastic32(fp_t)
    mgs = fp_j.statics["mg"]
    dia = None
    if mode == "dia":
        dia = {"dst": mgs["dia0_dst"], "offsets": fp_j._mg_dia_offsets,
               "mask_lat": mgs["mask0_lat"], "dst1": mgs["dia1_dst"],
               "offsets1": fp_j._mg_dia1_offsets}
    rt_j = mg_j.mg_setup(mgs, jnp.asarray(K32.numpy()), fp_j.statics["dofmap"],
                         fp_j.statics["bc_mask"], fp_j.n_dofs, dia=dia)
    t0s = None
    if mode == "dia":
        shape0, shape1 = fp_j._mg_lat_shapes
        t0s = (fp_j._mg_t0_stencil, shape0, shape1, 2, ~mgs["mask0_lat"])
    M_j = jax.jit(lambda r: mg_j.vcycle(mgs, rt_j, r, fp_j._mg_cheb_degree, gamma_coarse=gamma,
                                        t0s=t0s))
    rt_t = mg_t.mg_setup(fp_t._mg, K32)
    assert [lvl["n"] for lvl in fp_t._mg["levels"]] == [162, 30, 6]

    def M_t(r):
        return mg_t.vcycle(fp_t._mg, rt_t, torch.tensor(r), gamma_coarse=gamma).numpy()

    rng = np.random.default_rng(3)
    r1, r2 = (rng.normal(size=fp_t.n_dofs).astype(np.float32) for _ in range(2))
    z1 = M_t(r1)
    assert _rel(z1, M_j(jnp.asarray(r1))) < 1e-5
    # a random r is mostly smoothed away at level 0; the residual of a
    # field prolonged from the coarsest level is carried by the coarse
    # corrections (gamma 2 against 1 moves this cycle by ~10%)
    rs = _smooth_residual(fp_t._mg, rt_t, rng)
    assert _rel(M_t(rs), M_j(jnp.asarray(rs))) < 1e-5
    assert np.allclose(M_t(2.0 * r1 - 3.0 * r2), 2.0 * z1 - 3.0 * M_t(r2), rtol=1e-4, atol=1e-4)


def test_ir_pcg_nonzero_bc_rows():
    """The f32 level-0 operator is identity on bc rows, as the exact f64
    operator is, so a right-hand side with ~1e-8 on bc rows (the first
    Newton update after a load step re-initialises Du) converges to 1e-11
    instead of stagnating."""
    fp = _port_step(8, mg_opts={"mv0_mode": "scalar"})
    plan, n = fp._mg, fp.n_dofs
    K32 = _masked_elastic32(fp)
    rt = mg_t.mg_setup(plan, K32)
    mask = fp.statics["bc_mask"]
    e_bc = torch.zeros(n, dtype=torch.float32)
    e_bc[int(torch.nonzero(mask)[0])] = 1.0
    assert torch.allclose(rt["mv0"](e_bc), e_bc)
    mv = mg_t.ebe_matvec(K32.double(), plan["ebe"])

    def M32(r):
        return torch.where(mask, r, mg_t.vcycle(plan, rt, torch.where(mask, 0.0, r)))

    rng = np.random.default_rng(7)
    b = torch.tensor(np.where(mask.numpy(), 1e-8 * rng.normal(size=n), rng.normal(size=n)))
    x, k = mg_t.ir_pcg(mv, rt["mv0"], M32, b, 1e-12, 2000)
    assert k > 0
    assert float(torch.linalg.norm(b - mv(x)) / torch.linalg.norm(b)) < 1e-11


def test_level0_matvecs_are_one_linear_map():
    """The scalar, node and banded (lattice-numbered) level-0 operators
    agree as linear maps (f32), and equal the f64 element-blocked operator
    with identity bc rows."""
    steps = {m: _port_step(9, mg_opts={"mv0_mode": m}) for m in ("scalar", "node", "dia")}
    K32 = _masked_elastic32(steps["scalar"])
    n = steps["scalar"].n_dofs
    x = torch.tensor(np.random.default_rng(11).normal(size=n).astype(np.float32))
    ys = {}
    for m, fp in steps.items():
        mv0 = mg_t.mg_setup(fp._mg, K32)["mv0"]
        if m == "dia":
            ys[m] = mv0(x[fp._mg["perm0_l2o"]])[fp._mg["perm0_o2l"]]
        else:
            ys[m] = mv0(x)
    y64 = mg_t.ebe_matvec(K32.double(), steps["scalar"]._mg["ebe"])(x.double())
    for m, y in ys.items():
        assert _rel(y, y64) < 1e-5, m
    assert torch.equal(ys["scalar"], ys["node"])


def test_block_transfer_forms_match_scalar():
    """The block gather forms of the aggregation transfers (prolongation and
    restriction) reproduce the padded-row prolongator and its transpose
    (the gather table of P^T) on a smoothed-aggregation hierarchy."""
    fp = _port_step(16)
    plan = fp._mg
    rng = np.random.default_rng(7)
    checked = 0
    for k, t in enumerate(plan["transfers"][1:], start=1):
        if "Pb_idx" not in t:
            continue
        scalar = {key: t[key] for key in ("P_idx", "P_w", "R_table")}
        n_f, n_c = plan["levels"][k - 1]["n"], plan["levels"][k]["n"]
        x_c = torch.tensor(rng.normal(size=n_c).astype(np.float32))
        r_f = torch.tensor(rng.normal(size=n_f).astype(np.float32))
        p_ref = mg_t._prolong(scalar, x_c)
        r_ref = mg_t._restrict(scalar, r_f)
        assert _rel(mg_t._prolong(t, x_c), p_ref) < 1e-5
        assert _rel(mg_t._restrict(t, r_f), r_ref) < 1e-5
        Pi, Pw = t["P_idx"].numpy(), t["P_w"].numpy().astype(np.float64)
        P = sp.coo_matrix((Pw.ravel(), (np.repeat(np.arange(n_f), Pi.shape[1]), Pi.ravel())),
                          shape=(n_f, n_c))
        assert _rel(r_ref, P.T @ r_f.double().numpy()) < 1e-5
        checked += 1
    assert checked >= 1, "no aggregation transfer carried block forms"


def test_stencil_transfers_equal_p0():
    """The stencil transfers of dia mode equal the P2 -> P1 interpolation
    (bc rows zeroed) and its transpose, in the lattice numberings."""
    fp = _port_step(8)
    plan = fp._mg
    assert fp._mg_mv0_mode == "dia" and "stencil" in plan
    mask = fp.statics["bc_mask"].numpy()
    P0 = mg_t._p2_to_p1_interpolation(fp.mesh, 2, mask)
    perm, _ = mg_t._lattice_node_perm(fp.mesh.points[:, :2])
    p1 = (perm[:, None] * 2 + np.arange(2)[None, :]).ravel()
    P_lat = P0[plan["perm0_l2o"].numpy()][:, p1]
    rng = np.random.default_rng(5)
    x_c = rng.normal(size=P_lat.shape[1]).astype(np.float32)
    r_f = rng.normal(size=P_lat.shape[0]).astype(np.float32)
    st = plan["stencil"]
    assert _rel(mg_t._stencil_prolong(st, torch.tensor(x_c)), P_lat @ x_c) < 1e-6
    assert _rel(mg_t._stencil_restrict(st, torch.tensor(r_f)), P_lat.T @ r_f) < 1e-6


def test_dia_falls_back_off_lattice():
    """A mesh that is not a lattice (the holed square) turns an explicit
    ``mv0_mode="dia"`` into ``"node"`` with a warning."""
    msh, *_ = mesh_t.build_square_with_elliptic_holes(lc=0.3)
    V = pt.functionspace(msh, ("Lagrange", 2, (2,)))
    S = pt.functionspace(msh, pt.quadrature_element(msh.cell_name(), degree=2, value_shape=(4,)))
    sd = pt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], x[1].min()))
    bc = np.concatenate([sd * 2, sd * 2 + 1])
    kernel = pt.MohrCoulombMaterial().batched_kernel("plain")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fp = pt.FusedPlasticityStep(msh, V, S, kernel, bc, device="cpu", linear_solver="mg",
                                    mg_opts={"mv0_mode": "dia"})
    assert fp._mg_mv0_mode == "node" and "dia0" not in fp._mg
    assert any("lattice" in str(x.message) for x in w)


def _schedule(fp, loads=LOADS):
    """(Du per step, Newton list, inner iterations per step)."""
    Du, sig = fp.zero_state()
    dus, its, inner = [], [], []
    for load in loads:
        Du, sig, _, it, cg = fp.run_step(Du, sig, float(load))
        dus.append(np.asarray(Du))
        its.append(int(it))
        inner.append(int(cg))
    return dus, its, inner


@pytest.fixture(scope="module")
def jax_runs():
    runs = {}
    for solver in ("mg", "elastic"):
        fp = StepJ(*_jax_slope(12), linear_solver=solver)
        runs[solver] = (fp, _schedule(fp))
    return runs


@pytest.fixture(scope="module")
def port_runs():
    runs = {}
    for name, solver, opts in (("mg", "mg", {}), ("elastic", "elastic", {}),
                               ("dense", "dense", {"dense_refine": 2}),
                               ("frozen", "mg", {"mg_opts": {"galerkin_levels": 1}}),
                               ("forcing", "mg", {"fused_forcing": True})):
        fp = _port_step(12, solver, **opts)
        runs[name] = (fp, _schedule(fp))
    return runs


# Inner iterations, port against the JAX package, on the CPU (ROADMAP
# queue 3): measured per step, mg [25, 171, 128, 138] against [25, 107,
# 122, 131] (the port's last update of step 2 stalls at 4e-13 where the
# target is 1e-13 and spends two more stall windows), elastic [5, 82, 156,
# 225] against [5, 76, 151, 211].  Held to 2x a step's count plus 10, and
# the schedule's total to 1.5x.
def _inner_within_bound(port, ref):
    return (all(p <= 2 * r + 10 for p, r in zip(port, ref))
            and sum(port) <= 1.5 * sum(ref))


@pytest.mark.parametrize("solver", ["mg", "elastic"])
def test_slope_12x12_matches_jax_and_dense(solver, jax_runs, port_runs):
    fp, (du, its, inner) = port_runs[solver]
    _, (du_j, its_j, inner_j) = jax_runs[solver]
    _, (du_d, its_d, _) = port_runs["dense"]
    assert fp.linear_solver == solver
    assert its == its_j == its_d
    assert sum(its) > len(LOADS)  # the plastic regime is reached
    for a, b, c in zip(du, du_j, du_d):
        assert _rel(a, b) < 1e-10
        assert _rel(a, c) < 1e-10
    assert all(k > 0 for k in inner)
    assert _inner_within_bound(inner, inner_j), (inner, inner_j)


def test_mg_hierarchy_12x12(port_runs):
    fp = port_runs["mg"][0]
    assert (fp._mg_mv0_mode, fp.mg_sizes) == ("dia", [1250, 338, 75])
    assert [lvl["kind"] for lvl in fp._mg["levels"]] == ["dia", "dense"]


def test_frozen_galerkin_matches_full(port_runs):
    fp, (du_f, its_f, inner_f) = port_runs["frozen"]
    _, (du, its, _) = port_runs["mg"]
    assert any("frozen_vals" in lvl for lvl in fp._mg["levels"][1:])
    assert all("src" not in t for t in fp._mg["transfers"][1:])
    assert its_f == its
    for a, b in zip(du_f, du):
        assert _rel(a, b) < 1e-10
    assert all(k > 0 for k in inner_f)


def test_fused_forcing_reduces_inner_iterations(port_runs):
    """Eisenstat-Walker tolerances in the Newton loop: fewer inner
    iterations (possibly an extra Newton update), the same solution to
    1e-8."""
    fp, (du_f, _, inner_f) = port_runs["forcing"]
    _, (du, _, inner) = port_runs["mg"]
    assert fp.fused_forcing == 1e-4
    assert sum(inner_f) < sum(inner)
    assert np.abs(du_f[-1] - du[-1]).max() < 1e-8


@pytest.mark.parametrize("solver", ["mg", "elastic"])
def test_from_statics_runs_without_mesh(solver, jax_runs, port_runs):
    """A JAX step's statics, with its hierarchy carried across by
    ``convert.mg_statics_from_numpy``, give the mesh-built step's results
    bit for bit."""
    fp_j = jax_runs["mg"][0]
    _, (du, its, inner) = port_runs[solver]
    statics = {k: np.asarray(v) for k, v in fp_j.statics.items() if k != "mg"}
    if solver == "mg":
        statics["mg"] = convert.mg_statics_from_numpy(
            fp_j.statics["mg"], dia0_offsets=fp_j._mg_dia_offsets,
            dia1_offsets=fp_j._mg_dia1_offsets, t0_stencil=fp_j._mg_t0_stencil,
            lat_shapes=fp_j._mg_lat_shapes, cheb_degree=fp_j._mg_cheb_degree,
            gamma_coarse=fp_j._mg_gamma, mv0_mode=fp_j._mg_mv0_mode)
    kernel = pt.MohrCoulombMaterial().batched_kernel("plain")
    fp = pt.FusedPlasticityStep.from_statics(statics, kernel, device="cpu", linear_solver=solver)
    du_s, its_s, inner_s = _schedule(fp)
    assert (its_s, inner_s) == (its, inner)
    assert all(np.array_equal(a, b) for a, b in zip(du_s, du))
    if solver == "mg":
        del statics["mg"]
        with pytest.raises(ValueError, match="statics\\['mg'\\]"):
            pt.FusedPlasticityStep.from_statics(statics, kernel, device="cpu", linear_solver="mg")


def _fresh_mg_solve(fp):
    """The fused step's AMG-CG with a fresh hierarchy each update: ``mg_setup``
    on the update's f32 blocks, and ``ir_pcg`` with the cycle on it."""
    plan = fp._mg
    dia = fp._mg_mv0_mode == "dia"
    mask = plan["mask0_lat"] if dia else fp.statics["bc_mask"]
    inner = ({"to_inner": lambda v: v[plan["perm0_l2o"]],
              "from_inner": lambda v: v[plan["perm0_o2l"]]} if dia else {})

    def solve(C_tang, b, rtol):
        K_cell = fp._k_cell_masked(C_tang)
        rt = mg_t.mg_setup(plan, K_cell.to(torch.float32))

        def M32(r):
            z = mg_t.vcycle(plan, rt, torch.where(mask, 0.0, r), gamma_coarse=fp._mg_gamma)
            return torch.where(mask, r, z)

        return mg_t.ir_pcg(mg_t.ebe_matvec(K_cell, plan["ebe"]), rt["mv0"], M32, b, rtol,
                           fp.cg_maxiter, **inner)

    return solve


@pytest.mark.parametrize("mode", ["dia", "node"])
def test_kept_workspace_matches_a_fresh_hierarchy(mode):
    """The fused step's AMG-CG through its kept workspace (``mg.AMGCG``) on
    the 8x8 slope over ``LOADS``: every update's dx and inner count, the
    Newton list and Du bit for bit those of a fresh ``mg_setup`` and
    ``ir_pcg`` at every update."""
    runs = []
    for fresh in (False, True):
        fp = _port_step(8, mg_opts={"mv0_mode": mode})
        assert fp._mg_mv0_mode == mode
        updates, solve = [], _fresh_mg_solve(fp) if fresh else fp._mg_solve

        def logged(C_tang, b, rtol, solve=solve, updates=updates):
            dx, k = solve(C_tang, b, rtol)
            updates.append((dx.clone(), k))
            return dx, k

        fp._mg_solve = logged
        runs.append((_schedule(fp), updates))
    ((du, its, inner), updates), ((du_f, its_f, inner_f), updates_f) = runs
    assert (its, inner) == (its_f, inner_f) and sum(its) > 0 and all(k > 0 for k in inner)
    assert all(np.array_equal(a, b) for a, b in zip(du, du_f))
    assert len(updates) == len(updates_f) == sum(its)
    assert all(k == k_f and torch.equal(dx, dx_f)
               for (dx, k), (dx_f, k_f) in zip(updates, updates_f))


# inner iterations of the 25x25 AMG-CG schedule: the JAX package's on the
# CPU.  The port's are held within 15% of it (measured: 11,986 on the CPU,
# +3.8%; 10,815 on the H100, -6.3%, which chip_smoke.py phase 11 holds to
# the same bound)
MG_25_INNER_JAX = 11545


@pytest.mark.slow
def test_slope_25x25_mg_full_schedule():
    """``entry()``'s program on the CPU: the 25x25 slope with AMG-CG (dia
    mode) over the 52-step schedule gives the record's Newton list, with
    inner iterations within 15% of the JAX package's."""
    fp = _port_step(25)
    assert fp._mg_mv0_mode == "dia"
    _, its, inner = _schedule(fp, loads=pt.SLOPE_LOADS)
    assert its == RECORD_25X25 and sum(its) == 171
    assert all(k > 0 for k in inner)
    assert abs(sum(inner) - MG_25_INNER_JAX) <= 0.15 * MG_25_INNER_JAX, sum(inner)
