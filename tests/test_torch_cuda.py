"""Card-only tests of the port's CUDA kernels and of its runs on the card;
each skips without a GPU.

This file imports no JAX, so that it runs on a machine that has PyTorch
with CUDA but no JAX (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import dolfinx_external_operator_torch as pt
from dolfinx_external_operator_torch.models import von_mises as vm
from dolfinx_external_operator_torch.ops import mohr_coulomb as mc_ops
from dolfinx_external_operator_torch.ops import vonmises as ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (see README: the port's card-only tests)")
    return torch.device("cuda")


def _inputs(n, device, seed=3):
    """The strain/stress mix of test_pallas_ops.py (half the points
    plastic), SoA f32."""
    rng = np.random.default_rng(seed)
    deps = rng.normal(scale=2e-3, size=(n, 4))
    deps[: n // 2, 3] += 6e-3
    sig_n = rng.normal(scale=20.0, size=(n, 4))
    p = np.abs(rng.normal(scale=1e-3, size=n))
    return [torch.tensor(a.T.copy(), dtype=torch.float32, device=device)
            for a in (deps, sig_n)] + [torch.tensor(p, dtype=torch.float32, device=device)]


def test_cuda_kernel_matches_plain(cuda):
    """The kernel against the plain version on the card, at a ragged n."""
    args = _inputs(3750, cuda) + [vm.PARAMS]
    before = ops.vonmises_return_map.launches
    C, sig, dp = ops.vonmises_return_map(*args)
    C_r, sig_r, dp_r = ops.vonmises_return_map_reference(*args)
    torch.cuda.synchronize()
    assert ops.vonmises_return_map.launches == before + 1
    assert float((C - C_r).abs().max() / C_r.abs().max()) < 1e-5
    assert float((sig - sig_r).abs().max() / max(float(sig_r.abs().max()), 1.0)) < 1e-5
    assert float((dp - dp_r).abs().max()) < 1e-7


def _old_vm_route(deps, sn, tile=512):
    """``batched_kernel_f32`` before K2 took f64: pad to the 512 tile, cast
    to f32, p = 0, the f32 entry, slice and cast back."""
    n = deps.shape[1]
    pad = -n % tile
    d32 = torch.nn.functional.pad(deps.to(torch.float32), (0, pad)).contiguous()
    s32 = torch.nn.functional.pad(sn.to(torch.float32), (0, pad)).contiguous()
    p32 = torch.zeros(n + pad, dtype=torch.float32, device=deps.device)
    C, sig, _ = ops.vonmises_return_map(d32, s32, p32, vm.PARAMS)
    return C[:, :n].reshape(4, 4, n).double(), sig[:, :n].double()


@pytest.mark.parametrize("layout", ["step", "point_major", "soa"])
@pytest.mark.parametrize("n", [1, 1001, 3750, 4096, 65536])
def test_cuda_vonmises_f64_entry_bitwise_old_route(cuda, n, layout):
    """K2's f64 entry (one launch, casts in registers) against the route
    it replaced, on the card: the same bits, on the block step's layout
    (deps the transpose of a point-major array, sig_n SoA), point-major
    and SoA."""
    rng = np.random.default_rng(n)
    deps = rng.normal(scale=2e-3, size=(n, 4))
    deps[: n // 2, 3] += 6e-3
    sig_n = rng.normal(scale=20.0, size=(n, 4))
    pm = [torch.tensor(a, device=cuda).T for a in (deps, sig_n)]
    soa = [torch.tensor(a.T.copy(), device=cuda) for a in (deps, sig_n)]
    d, s = {"step": (pm[0], soa[1]), "point_major": pm, "soa": soa}[layout]
    C_o, sig_o = _old_vm_route(d, s)
    before = ops.vonmises_return_map_f64.launches
    C, sig, dp = ops.vonmises_return_map_f64(d, s, None, vm.PARAMS)
    torch.cuda.synchronize()
    assert dp is None
    assert torch.equal(C.view(4, 4, n), C_o) and torch.equal(sig, sig_o)
    assert ops.vonmises_return_map_f64.launches == before + 1


def _run(fp):
    Du, sig = fp.zero_state()
    its = []
    for load in (200.0, 400.0, 600.0):
        Du, sig, _, it, _ = fp.run_step(Du, sig, load)
        its.append(it)
    return Du, its


def test_cuda_fused_step_through_kernel(cuda):
    """The fused step on the card, 8x8 block, dense solver: the f64 path
    gives the JAX package's Newton list [1, 5, 7]; the f32 kernel path
    converges within 10 updates a step, launches the kernel (its f64 entry,
    never the f32 one) once per Newton pass, agrees with the f64 path to
    1e-3, and repeats bitwise (the scatters use no atomics)."""
    fp64 = pt.von_mises_block_step(8, 8, "f64", linear_solver="dense")
    fp32 = pt.von_mises_block_step(8, 8, "f32", linear_solver="dense",
                                   newton_rtol=1e-5, newton_atol=1e-3)
    assert fp32.device.type == "cuda" and fp32._dense_fact == "chol"
    Du64, its64 = _run(fp64)
    before = ops.vonmises_return_map_f64.launches
    before32 = ops.vonmises_return_map.launches
    Du32, its32 = _run(fp32)
    assert its64 == [1, 5, 7]
    assert all(i <= 10 for i in its32), its32
    assert ops.vonmises_return_map_f64.launches - before == sum(its32) + len(its32)
    assert ops.vonmises_return_map.launches == before32
    assert float((Du32 - Du64).abs().max() / Du64.abs().max()) < 1e-3
    Du32_again, its32_again = _run(fp32)
    assert its32_again == its32 and torch.equal(Du32_again, Du32)


def test_cuda_mohr_coulomb_kernel_matches_plain(cuda):
    """K1 against the plain f64 map on the card, on the bench strain mix
    (bench.py:77-83) at the main path's 3,750 points: C within 1e-6 and
    sigma within 1e-7 of their largest entries, per lane, and the lanes'
    iteration counts equal but for a few lanes that end next to the
    polish tolerance (1e-8 of the lane's scale; chip_smoke.MC_TOL)."""
    n = 3750
    rng = np.random.default_rng(0)
    deps = rng.normal(scale=1e-3, size=(n, 4))
    deps[:, :3] -= 1.5e-3
    deps[: n // 2, 3] += 6e-3
    d = torch.tensor(deps.T.copy(), dtype=torch.float64, device=cuda)
    s = torch.zeros_like(d)
    mat = pt.MohrCoulombMaterial()
    before = mc_ops.mc_return_map.launches
    C, sig, niter, yielding, norm_res, dlambda = mc_ops.mc_return_map(d, s, mat)
    C_r, (sig_r, niter_r, yielding_r, *_) = mat.tangent_stress(d, s)
    torch.cuda.synchronize()
    assert mc_ops.mc_return_map.launches == before + 1
    C_r = C_r.reshape(16, n)
    assert float(((C - C_r).abs().amax(0) / C_r.abs().max()).max()) < 1e-6
    assert float(((sig - sig_r).abs().amax(0) / sig_r.abs().max()).max()) < 1e-7
    assert int((niter != niter_r).sum()) <= n // 1000
    assert float((yielding - yielding_r).abs().max()) < 1e-12


# Lanes whose iteration count may differ from the plain map's when every
# lane is plastic: 2 in a thousand, and at least 2.  Measured on an H100 by
# dolfinx_external_operator_torch/tools/k1_compare.py, where the one-pass
# kernel that this one replaced differs from the plain map on 2 of the 256
# lanes of the "sheared" mix and on 99 of 65,536 (this kernel: 2 and 105);
# built without FMA contraction the two kernels give the same bits, and
# then differ on 1 and 73.  So the count is the f32 phase's, not the
# kernel design's.  (At 65,536 sheared points both kernels also leave C
# 1.9e-6 from the plain map, above chip_smoke.MC_TOL, so no test runs it.)
def _niter_allowance(case, n):
    return max(2, 2 * n // 1000) if case.startswith("all_plastic") else n // 1000


def _mc_input(case, device):
    """SoA f64 (deps, sigma_n) of a K1 edge case: every lane elastic (pass
    A finishes all), elastic lanes that take Newton steps, every lane
    plastic (pass B takes all: the plastic lanes of the bench mix at 3,750
    points, or the mix at 256 points with every point sheared by a further
    1.2e-2, as the all-plastic case of test_torch_mohr_coulomb.py),
    or the bench mix at a ragged n with its first point sheared past
    yield."""
    sn = None
    if case == "all_elastic":
        deps = np.random.default_rng(5).normal(scale=1e-5, size=(64, 4))
    elif case == "elastic_iterating":
        rng = np.random.default_rng(9)
        sn = rng.normal(scale=5.0, size=(64, 4))
        sn[:, :3] -= 100.0
        deps = rng.normal(scale=1e-6, size=(64, 4))
    else:
        n = 3750 if case == "all_plastic" else int(case.split("n")[-1])
        rng = np.random.default_rng(0 if case == "all_plastic" else 6)
        deps = rng.normal(scale=1e-3, size=(n, 4))
        deps[:, :3] -= 1.5e-3
        deps[: max(n // 2, 1), 3] += 6e-3
        if case.startswith("all_plastic_sheared"):
            deps[:, 3] += 1.2e-2
    if case == "all_plastic":
        mat = pt.MohrCoulombMaterial()
        deps = deps[mat.f_yield(torch.tensor(deps @ mat.C_elas.T).T).numpy() > 0.0]
    d = torch.tensor(deps.T.copy(), dtype=torch.float64, device=device)
    if sn is None:
        return d, torch.zeros_like(d)
    return d, torch.tensor(sn.T.copy(), dtype=torch.float64, device=device)


@pytest.mark.parametrize("case", ["all_elastic", "elastic_iterating", "all_plastic",
                                  "all_plastic_sheared_n256", "n1", "n33", "n65537"])
def test_cuda_mohr_coulomb_edge_inputs(cuda, case):
    """K1 against the plain map where one pass takes every lane and at
    ragged sizes, within chip_smoke.MC_TOL (iteration counts within
    ``_niter_allowance``); the plastic lanes are those with f(sigma_tr) > 0.  Pass A lists exactly the plastic lanes and the
    elastic ones that take a Newton step (read from the workspace of a
    second call, which gives the same bits)."""
    d, s = _mc_input(case, cuda)
    n = d.shape[1]
    mat = pt.MohrCoulombMaterial()
    first = mc_ops.mc_return_map(d, s, mat)
    C, sig, niter, yielding, norm_res, _ = first
    C_r, (sig_r, niter_r, yielding_r, *_) = mat.tangent_stress(d, s)
    outs, work = mc_ops._outputs(n, cuda), mc_ops._workspace(n, cuda)
    mc_ops._launch(d, s, mat, outs, work)
    torch.cuda.synchronize()
    assert int(work[0]) == int(((yielding > 0.0) | (niter > 0)).sum())
    assert all(torch.equal(a, b) for a, b in zip(outs, first))
    plastic = yielding_r > 0.0
    if case in ("all_elastic", "elastic_iterating"):
        assert not bool(plastic.any())
        C_el = torch.tensor(mat.C_elas, dtype=torch.float64, device=cuda).reshape(16, 1)
        assert torch.equal(C, C_el.expand(16, n))
        assert bool((niter_r > 0).all()) == (case == "elastic_iterating")
    elif case.startswith("all_plastic"):
        assert bool(plastic.all())
    C_r = C_r.reshape(16, n)
    assert float(((C - C_r).abs().amax(0) / C_r.abs().max()).max()) < 1e-6
    assert float(((sig - sig_r).abs().amax(0) / sig_r.abs().max()).max()) < 1e-7
    assert int((niter != niter_r).sum()) <= _niter_allowance(case, n)
    assert float((yielding - yielding_r).abs().max()) < 1e-12
    assert bool(torch.isfinite(norm_res).all())


def test_cuda_mohr_coulomb_repeats_bitwise(cuda):
    """Two eager calls, and a call replayed from a CUDA graph, give the
    same bits: the order in which pass A lists the plastic lanes (atomics)
    does not reach the outputs, and the call holds no host sync."""
    d, s = _mc_input("n65537", cuda)
    mat = pt.MohrCoulombMaterial()
    first = mc_ops.mc_return_map(d, s, mat)
    second = mc_ops.mc_return_map(d, s, mat)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    before = mc_ops.mc_return_map.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = mc_ops.mc_return_map(d, s, mat)
    graph.replay()
    torch.cuda.synchronize()
    assert mc_ops.mc_return_map.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(first, captured))


def test_cuda_slope_step_through_kernel(cuda):
    """The Mohr-Coulomb slope step on the card, 4x4, loads linspace(2, 14,
    3): the kernel route gives the plain route's Newton list [1, 4, 4] and
    Du within 1e-8, launching the kernel once per Newton pass."""
    loads = np.linspace(2, 14, 3)
    result = {}
    for route in ("plain", "cuda"):
        fp = pt.mohr_coulomb_slope_step(4, 4, route=route)
        Du, sig = fp.zero_state()
        before, its = mc_ops.mc_return_map.launches, []
        for load in loads:
            Du, sig, _, it, _ = fp.run_step(Du, sig, load)
            its.append(it)
        result[route] = (Du, its, mc_ops.mc_return_map.launches - before)
    (Du_p, its_p, n_p), (Du_k, its_k, n_k) = result["plain"], result["cuda"]
    assert its_p == its_k == [1, 4, 4]
    assert n_p == 0 and n_k == sum(its_k) + len(its_k)
    assert float((Du_k - Du_p).abs().max() / Du_p.abs().max()) < 1e-8


def test_cuda_general_slope_through_kernel(cuda):
    """The same slope through the general pipeline on the card, K1 as the
    external operator's callback: the Newton list [1, 4, 4] of the plain
    route on the CPU, u within 1e-8 of it, one launch per residual plus
    the initial update, and the fused step's u on the card within 1e-8."""
    from dolfinx_external_operator_torch.models.mohr_coulomb import solve_slope_stability

    loads = np.linspace(2, 14, 3)
    ref = solve_slope_stability(4, 4, loads, device="cpu", route="plain")
    before = mc_ops.mc_return_map.launches
    run = solve_slope_stability(4, 4, loads, route="cuda")
    launches = mc_ops.mc_return_map.launches - before
    u, u_ref = run["u"].data, ref["u"].data
    assert u.device.type == "cuda" and run["iterations"] == ref["iterations"] == [1, 4, 4]
    assert launches == 1 + sum(run["iterations"]) + len(loads) + sum(run["backtracks"])
    assert float((u.cpu() - u_ref).abs().max() / u_ref.abs().max()) < 1e-8
    fp = pt.mohr_coulomb_slope_step(4, 4, route="cuda")
    Du, sig = fp.zero_state()
    u_fused = torch.zeros_like(Du)
    for load in loads:
        Du, sig, *_ = fp.run_step(Du, sig, load)
        u_fused = u_fused + Du
    assert float((u - u_fused).abs().max() / u_fused.abs().max()) < 1e-8


def _block_tridiag(m, B, seed=0):
    """A random SPD block-tridiagonal system (the construction of
    tests/test_bcr.py): the (m, B, 3B) row bands and the dense matrix."""
    rng = np.random.default_rng(seed)
    n = m * B
    L = rng.normal(size=(m, B, B)) * 0.3
    D = rng.normal(size=(m, B, B))
    D = 0.5 * (D + np.swapaxes(D, 1, 2))
    A = np.zeros((n, n))
    for i in range(m):
        A[i * B:(i + 1) * B, i * B:(i + 1) * B] = D[i]
        if i > 0:
            A[i * B:(i + 1) * B, (i - 1) * B:i * B] = L[i]
            A[(i - 1) * B:i * B, i * B:(i + 1) * B] = L[i].T
    A += np.eye(n) * (np.abs(A).sum(axis=1).max() + 1.0)
    T = np.zeros((m, B, 3 * B))
    for i in range(m):
        T[i, :, B:2 * B] = A[i * B:(i + 1) * B, i * B:(i + 1) * B]
        if i > 0:
            T[i, :, :B] = A[i * B:(i + 1) * B, (i - 1) * B:i * B]
        if i < m - 1:
            T[i, :, 2 * B:] = A[i * B:(i + 1) * B, (i + 1) * B:(i + 2) * B]
    return T, A


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-5)])
def test_cuda_bcr_factor_apply(cuda, dtype, tol):
    """BCR factorization and apply on the card (cuSOLVER's batched Cholesky,
    cuBLAS's batched products) against np.linalg.solve, 11 block rows of
    64: within 1e-10 in f64, 1e-5 in f32 (this system's condition number
    is a few units), with no level falling back to the LU inverse."""
    from dolfinx_external_operator_torch.parallel import bcr
    from dolfinx_external_operator_torch.utils import profiling

    m, B = 11, 64
    T, A = _block_tridiag(m, B)
    b = np.random.default_rng(1).normal(size=m * B)
    profiling.reset_counters()
    fact = bcr.bcr_factor(torch.tensor(T, dtype=dtype, device=cuda), m, B)
    x = bcr.bcr_apply(fact, torch.tensor(b, dtype=dtype, device=cuda)).cpu().numpy()
    x_ref = np.linalg.solve(A, b)
    assert np.abs(x - x_ref).max() < tol * np.abs(x_ref).max()
    assert profiling.counters().get("bcr.inv_levels", 0) == 0


def test_cuda_bcr_step_matches_cpu(cuda):
    """The 8x8 slope with linear_solver="bcr" and the plain return map, on
    the card and on the CPU, loads linspace(2, 22.9, 50)[:8]: equal Newton
    lists, Du within 1e-10, and two runs on the card bitwise equal."""
    loads = np.linspace(2, 22.9, 50)[:8]

    def run(device):
        fp = pt.mohr_coulomb_slope_step(8, 8, route="plain", device=device, linear_solver="bcr")
        Du, sig = fp.zero_state()
        its = []
        for load in loads:
            Du, sig, _, it, _ = fp.run_step(Du, sig, load)
            its.append(it)
        return Du.cpu(), its

    Du_c, its_c = run(cuda)
    Du_h, its_h = run("cpu")
    assert its_c == its_h
    assert float((Du_c - Du_h).abs().max() / Du_h.abs().max()) < 1e-10
    Du_c2, its_c2 = run(cuda)
    assert its_c2 == its_c and torch.equal(Du_c2, Du_c)


def eager_bcr_solve(fp):
    """``fp._bcr_solve`` refined by ``ir_direct``'s own eager round over the
    same equilibration, factor and operators: the reference that the
    step's rounds through ``fixed_round`` are held to."""
    from dolfinx_external_operator_torch.parallel import bcr as bcr_t

    plan = fp._bcr
    m, B = plan["m"], plan["B"]
    ws = bcr_t.bcr_workspace(m, B, torch.float32, fp.device)

    def solve(C_tang, b, rtol):
        T, d = bcr_t.equilibrate(fp._bcr_bands(C_tang), plan["diag_slot"], m, B)
        fact = bcr_t.bcr_factor(T, m, B, workspace=ws)
        return bcr_t.ir_direct(lambda x: fp._bc_matvec(C_tang, x),
                               lambda rr: fp._bcr_apply(fact, d, rr), b, rtol)

    return solve


def test_cuda_bcr_graphed_rounds_match_eager(cuda):
    """The 8x8 slope with linear_solver="bcr" over linspace(2, 22.9,
    50)[:8], its refinement rounds replayed from CUDA graphs, against the
    step refined by ``ir_direct``'s eager round (``eager_bcr_solve``):
    every update's dx bit for bit and its signed rounds, each update on
    another tangent; the solver captured its two graphs once, and a replay
    for every round."""
    from dolfinx_external_operator_torch.utils import profiling

    loads = np.linspace(2, 22.9, 50)[:8]

    def run(eager):
        fp = pt.mohr_coulomb_slope_step(8, 8, route="plain", device=cuda, linear_solver="bcr")
        solves, solve = [], eager_bcr_solve(fp) if eager else fp._bcr_solve

        def logged(C_tang, b, rtol):
            dx, k = solve(C_tang, b, rtol)
            solves.append((dx.cpu(), k))
            return dx, k

        fp._bcr_solve = logged
        profiling.reset_counters()
        Du, sig = fp.zero_state()
        for load in loads:
            Du, sig, *_ = fp.run_step(Du, sig, load)
        return solves, profiling.counters()

    eager, c_e = run(True)
    graphed, c_g = run(False)
    assert len(graphed) == len(eager) > 1
    assert [k for _, k in graphed] == [k for _, k in eager]
    assert all(torch.equal(a, b) for (a, _), (b, _) in zip(graphed, eager))
    assert c_g["graphs.captures"] == 2
    assert c_g["bcr.round_replays"] == c_g["solve.rounds"] == c_e["solve.rounds"] > 0
    assert c_e.get("graphs.captures", 0) == c_e.get("bcr.round_replays", 0) == 0


def _slope_run(solver, device, N=12, loads=(2.0, 6.0, 10.0, 14.0)):
    """The N x N slope with the plain return map over ``loads``: Du (on
    the CPU), the Newton list and the inner iterations per step."""
    fp = pt.mohr_coulomb_slope_step(N, N, route="plain", device=device, linear_solver=solver)
    Du, sig = fp.zero_state()
    its, inner = [], []
    for load in loads:
        Du, sig, _, it, k = fp.run_step(Du, sig, load)
        its.append(it)
        inner.append(k)
    return Du.cpu(), its, inner


def test_cuda_mg_step_matches_cpu(cuda):
    """AMG-CG (dia mode) on the card, 12x12 slope, the loads of
    tests/test_torch_mg.py: the CPU port's Newton list, Du within 1e-10,
    and two runs on the card bitwise equal (no atomics in any scatter)."""
    Du_c, its_c, inner_c = _slope_run("mg", cuda)
    Du_h, its_h, _ = _slope_run("mg", "cpu")
    assert its_c == its_h
    assert all(k > 0 for k in inner_c)
    assert float((Du_c - Du_h).abs().max() / Du_h.abs().max()) < 1e-10
    Du_c2, its_c2, inner_c2 = _slope_run("mg", cuda)
    assert (its_c2, inner_c2) == (its_c, inner_c) and torch.equal(Du_c2, Du_c)


def test_cuda_elastic_refresh_inverts_tangent(cuda):
    """The lagged preconditioner that a load step leaves behind (Cholesky,
    triangular inverse and Gram product on the card) inverts the step's
    last equilibrated tangent to f32 accuracy (condition number ~1e3 on
    the 8x8 slope)."""
    fp = pt.mohr_coulomb_slope_step(8, 8, route="plain", device=cuda, linear_solver="elastic")
    Du, sig0 = fp.zero_state()
    Du, _, _, it, k = fp.run_step(Du, sig0, 6.0)
    assert it > 0 and k > 0
    C, _ = fp._constitutive(Du, sig0)
    f32 = torch.float32
    Kd = (fp._assemble_dense_f32(fp._k_cell_masked(C, f32))
          + torch.diag(fp.statics["bc_mask"].to(f32)))
    Minv, d = fp._el_precond
    E = Minv @ (Kd * d[:, None] * d[None, :]) - torch.eye(fp.n_dofs, device=cuda)
    assert float(E.abs().max()) < 1e-4


def _unsharded(N, loads, device, **opts):
    """The port's slope step without a mesh, as ``entry.slope_schedule``
    runs it: (Du, sigma, Newton list, inner counts) as numpy and ints."""
    fp = pt.mohr_coulomb_slope_step(N, N, device=device, **opts)
    Du, sig = fp.zero_state()
    its, inner = [], []
    for load in loads:
        Du, sig, _, it, cg = fp.run_step(Du, sig, float(load))
        its.append(int(it))
        inner.append(int(cg))
    return Du.cpu().numpy(), sig.cpu().numpy(), its, inner


@pytest.mark.parametrize("mode", ["dia", "node"])
def test_cuda_one_nccl_rank_is_the_unsharded_step(cuda, mode):
    """One NCCL rank through the sharded code, 8x8 slope with AMG-CG, on
    the card: the unsharded step's bits.  In node mode the cycle's level-0
    matvec all-reduces, and over NCCL it is captured in the CUDA graph."""
    from dolfinx_external_operator_torch.entry import slope_schedule
    from dolfinx_external_operator_torch.parallel import dist

    loads, opts = (2.0, 6.0), {"linear_solver": "mg", "mg_opts": {"mv0_mode": mode}}
    (run,) = dist.spawn(slope_schedule, 1, "nccl", None, 8, loads, "mg",
                        mg_opts={"mv0_mode": mode})
    Du, sig, its, inner = _unsharded(8, loads, cuda, **opts)
    assert (run["newton"], run["inner"]) == (its, inner)
    assert np.array_equal(run["du"], Du) and np.array_equal(run["sigma"], sig)
    assert run["launches"] == run["passes"] and run["psum_calls"] > 0


@pytest.mark.parametrize("mode", ["dia", "node"])
def test_cuda_two_gloo_ranks_on_one_card(cuda, mode):
    """Two gloo ranks with CUDA tensors on one card (NCCL refuses that),
    8x8 slope with AMG-CG: the unsharded card run's bits in Du, sigma (the
    ranks' slices in rank order), the Newton list and the inner counts,
    the ranks' norms bitwise equal, one K1 launch per Newton pass on each
    rank.  The sums are order-free (``dist.cell_sum``) and every per-cell
    product is a kernel of fixed summation order (``ops/element_chain.py``),
    so a rank's 64 cells give the rows of all 128 bit for bit.  In node
    mode the cycle's level-0 matvec all-reduces over gloo, so the cycle
    runs eager (no CUDA graph can hold a gloo all-reduce); in dia mode it
    is graphed."""
    from dolfinx_external_operator_torch.entry import slope_schedule
    from dolfinx_external_operator_torch.parallel import dist

    loads, mg_opts = (2.0, 6.0, 10.0), {"mv0_mode": mode}
    runs = dist.spawn(slope_schedule, 2, "gloo", None, 8, loads, "mg", mg_opts=mg_opts)
    Du, sig, its, inner = _unsharded(8, loads, cuda, linear_solver="mg", mg_opts=mg_opts)
    sigma = np.concatenate([run["sigma"] for run in sorted(runs, key=lambda r: r["rank"])])
    assert np.array_equal(sigma[:len(sig)], sig)
    for run in runs:
        assert run["device"] == "cuda:0"
        assert (run["newton"], run["inner"]) == (its, inner)
        assert np.array_equal(run["du"], Du)
        assert run["norms"] == runs[0]["norms"]
        assert run["launches"] == run["passes"]


def test_cuda_dryrun_multichip_two_gloo_ranks(cuda):
    """``dryrun_multichip(2)`` with two gloo ranks on one card gives Newton
    counts 1 and 2 on both ranks."""
    from dolfinx_external_operator_torch.entry import dryrun_multichip

    assert [r["newton"] for r in dryrun_multichip(2, backend="gloo")] == [[1, 2], [1, 2]]


def test_cuda_von_mises_general_solvers_match_cpu(cuda):
    """The von Mises cylinder (lc=0.5, 3 increments) through the general
    pipeline on the card with the dense, cg + mg (the cycle replayed from
    a CUDA graph) and gmres + mg solvers: the CPU port's Newton list, the
    probe within 1e-10 of the CPU's dense run."""
    ref = vm.solve_von_mises(lc=0.5, num_increments=3, device="cpu")
    for opts in (None, {"ksp_type": "cg", "pc_type": "mg"}, {"ksp_type": "gmres", "pc_type": "mg"}):
        run = vm.solve_von_mises(lc=0.5, num_increments=3, snes_opts=opts)
        assert run["u"].data.device.type == "cuda" and run["iterations"] == ref["iterations"]
        assert np.abs(run["results"][:, 0] - ref["results"][:, 0]).max() < 1e-10


def test_cuda_icnn_graphed_call_matches_cpu(cuda):
    """The ICNN callback on the card (each batch size's call replayed from
    a CUDA graph): within 1e-13 of its eager call and within 1e-12 of the
    CPU module's, on 2,004 seeded deformation gradients near I, twice."""
    from dolfinx_external_operator_torch.models.icnn import ICNN

    F = np.array([1.0, 0.0, 0.0, 1.0]) + 0.05 * np.random.default_rng(7).standard_normal((2004, 4))
    net, net_h = ICNN(), ICNN(device="cpu")
    F_d = torch.tensor(F, device=cuda)
    dP_h, P_h = net_h.stress_and_tangent(torch.tensor(F))
    dP_e, P_e = (t.reshape(-1) for t in net._stress_and_tangent(F_d))
    for _ in range(2):
        dP, P = net.stress_and_tangent(F_d)
        for a, e, h in ((dP, dP_e, dP_h), (P, P_e, P_h)):
            assert float((a - e).abs().max() / e.abs().max()) <= 1e-13
            assert float((a.cpu() - h).abs().max() / h.abs().max()) <= 1e-12


def test_cuda_one_nccl_rank_general_slope_is_unsharded(cuda):
    """The 8x8 slope through the general pipeline (``solve_slope_stability``,
    K1 as the callback) with every form sharded over one NCCL rank: the
    unsharded run's Newton list, K1 launches and u, bit for bit."""
    from dolfinx_external_operator_torch.entry import general_slope_schedule
    from dolfinx_external_operator_torch.models.mohr_coulomb import solve_slope_stability
    from dolfinx_external_operator_torch.parallel import dist

    loads = tuple(np.linspace(2, 20, 4))
    (run,) = dist.spawn(general_slope_schedule, 1, "nccl", None, 8, loads)
    mc_ops.mc_return_map.launches = 0
    ref = solve_slope_stability(8, 8, loads, device=cuda)
    assert run["newton"] == ref["iterations"] and run["launches"] == mc_ops.mc_return_map.launches
    assert np.array_equal(run["u"], ref["u"].data.cpu().numpy())
    assert run["gather_calls"] > 0 and run["points"] == [3 * 2 * 8 * 8]


def _gather_rank(mesh, n):
    """Rank function: ``dist.all_gather`` of this rank's block of a CUDA
    tensor."""
    from dolfinx_external_operator_torch.parallel import dist

    x = torch.arange(n, dtype=torch.float64, device=mesh.device) + 100.0 * mesh.rank
    whole = dist.all_gather(x.reshape(n, 1), 2 * n - 1, mesh.group)
    return {"device": str(whole.device), "whole": whole.cpu().numpy().ravel()}


def test_cuda_two_gloo_ranks_gather_and_general_slope(cuda):
    """Two gloo ranks on one card: ``dist.all_gather`` of CUDA tensors
    (gloo stages them through the host) gives the whole batch on the card,
    and the 8x8 general slope sharded over them gives the unsharded run's
    Newton list, u within 1e-10 relative, and each rank's K1 half the
    points."""
    from dolfinx_external_operator_torch.entry import general_slope_schedule
    from dolfinx_external_operator_torch.models.mohr_coulomb import solve_slope_stability
    from dolfinx_external_operator_torch.parallel import dist

    n = 5
    expect = np.concatenate([np.arange(n), np.arange(n) + 100.0])[:2 * n - 1]
    for g in dist.spawn(_gather_rank, 2, "gloo", None, n):
        assert g["device"] == "cuda:0" and np.array_equal(g["whole"], expect)

    loads = tuple(np.linspace(2, 20, 4))
    runs = dist.spawn(general_slope_schedule, 2, "gloo", None, 8, loads)
    ref = solve_slope_stability(8, 8, loads, device=cuda)
    u_ref = ref["u"].data.cpu().numpy()
    for run in runs:
        assert run["device"] == "cuda:0" and run["newton"] == ref["iterations"]
        assert float(np.abs(run["u"] - u_ref).max()) <= 1e-10 * float(np.abs(u_ref).max())
        assert run["points"] == [3 * 8 * 8] and run["launches"] == run["map_calls"]
        assert np.array_equal(run["u"], runs[0]["u"])


def test_cuda_determinism(cuda):
    """``tests/test_torch_determinism.py`` on the card: the heat forms'
    vector, matrix and action bitwise repeatable and across rebuilt
    objects (every scatter a gather table, no atomics), and within 1e-12
    of the CPU's; the 4x4 fused dense step through K1 at load 8 run twice,
    bitwise, and within 1e-8 of the CPU's plain step (Cholesky on the
    card, LU on the CPU)."""
    from dolfinx_external_operator_torch import convert

    def heat(device):
        mesh = pt.create_unit_square(6, 6)
        V = pt.functionspace(mesh, ("Lagrange", 2))
        u0 = 1.0 + 0.2 * np.random.default_rng(11).standard_normal(V.num_dofs)
        u = convert.function_from_numpy(V, u0, device=device)
        v, uh = pt.TestFunction(V), pt.TrialFunction(V)
        dx = pt.Measure("dx", metadata={"quadrature_degree": 4, "quadrature_scheme": "default"})
        F = pt.inner((1.0 + u * u) * pt.grad(u), pt.grad(v)) * dx
        return F, pt.derivative(F, u, uh)

    def close(a, b, tol):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        return float(np.abs(a - b).max()) <= tol * float(np.abs(b).max())

    F, J = heat(cuda)
    Fc, Jc = heat("cpu")
    b1, b2 = pt.assemble_vector(F, device=cuda), pt.assemble_vector(heat(cuda)[0], device=cuda)
    A1, A2 = pt.assemble_matrix(J, device=cuda), pt.assemble_matrix(J, device=cuda)
    form = pt.create_form(J, device=cuda)
    x = torch.tensor(np.random.default_rng(7).normal(size=form.test_space.num_dofs), device=cuda)
    y1, y2 = form.action(x), form.action(x)
    assert torch.equal(b1, b2) and torch.equal(A1, A2) and torch.equal(y1, y2)
    assert close(b1, pt.assemble_vector(Fc, device="cpu"), 1e-12)
    assert close(A1, pt.assemble_matrix(Jc, device="cpu"), 1e-12)
    assert close(y1, pt.create_form(Jc, device="cpu").action(x.cpu()), 1e-12)

    outs = []
    for device, route in ((cuda, "cuda"), (cuda, "cuda"), ("cpu", "plain")):
        fp = pt.mohr_coulomb_slope_step(4, 4, route=route, device=device, linear_solver="dense")
        Du, sig = fp.zero_state()
        before = mc_ops.mc_return_map.launches
        Du, sig, _, its, _ = fp.run_step(Du, sig, 8.0)
        outs.append((Du, sig, int(its), mc_ops.mc_return_map.launches - before))
    (Du1, sig1, its1, n1), (Du2, sig2, its2, _), (Du_c, sig_c, its_c, _) = outs
    assert torch.equal(Du1, Du2) and torch.equal(sig1, sig2) and its1 == its2 == its_c
    assert n1 == its1 + 1  # one K1 launch per Newton pass
    assert close(Du1, Du_c, 1e-8) and close(sig1, sig_c, 1e-8)


def test_cuda_yield_surface_sweep(cuda):
    """``tests/test_torch_yield_surface.py``'s Lode sweep through K1 on the
    card: predictors beyond the surface return to |f| < 5e-7 with a
    positive multiplier, sigma within 1e-9 of the plain map's on the CPU
    (relative to its largest entry), one launch."""
    mat = pt.MohrCoulombMaterial()
    c = np.sqrt(2.0 / 3.0)
    xi, rho = -6.0, 14.0
    sigs = np.array([[xi / np.sqrt(3.0) + c * rho * np.cos(t + k * 2.0 * np.pi / 3.0)
                      for k in (0, -1, 1)] + [0.0]
                     for t in np.linspace(-np.pi / 6 + 0.02, np.pi / 6 - 0.02, 11)])
    deps = torch.tensor((sigs @ np.linalg.inv(mat.C_elas).T).T.copy())
    zero = torch.zeros_like(deps)
    before = mc_ops.mc_return_map.launches
    _, sig, _, _, _, dlambda = mc_ops.mc_return_map(deps.to(cuda), zero.to(cuda), mat)
    torch.cuda.synchronize()
    assert mc_ops.mc_return_map.launches == before + 1
    sig_p, _, _, _, _ = mat.return_map(deps, zero)
    assert float(mat.f_yield(sig).abs().max()) < 5e-7
    assert bool((dlambda > 0.0).all())
    assert float((sig.cpu() - sig_p).abs().max() / sig_p.abs().max()) < 1e-9


# ----------------------------------------------------------------------
# the element chain's kernels E1-E5 (ops/element_chain.py)
EC_PRODUCTS = ("strain", "residual", "tangent_matvec", "tangent_diag", "blocks_f64",
               "blocks_f32", "ebe_f64", "ebe_f32", "ebe_node_f64", "ebe_node_f32",
               "operand_geometry", "operand_gphys", "operand_values", "operand_grads",
               "operand_values_grads", "triple_f32")
# E5's operand einsums (assembly.py, compile.py)
EC_OPERAND = {"operand_geometry": "qvd,cvg->cqgd", "operand_gphys": "qbd,cqdg->cqbg",
              "operand_values": "qb,cbk->cqk", "operand_grads": "cqbg,cbk->cqkg"}


@pytest.fixture(scope="module")
def ec_state():
    """The 8x8 slope (dense, K1) on the card after two load steps: its
    arrays, the tangent and sigma there, a seeded vector."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (see README: the port's card-only tests)")
    dev = torch.device("cuda")
    fp = pt.mohr_coulomb_slope_step(8, 8, device=dev, linear_solver="dense")
    Du, sig_n = fp.zero_state()
    for load in (2.0, 6.0):
        Du, sig_n, *_ = fp.run_step(Du, sig_n, load)
    C, sigma = fp._constitutive(Du, sig_n)
    st = fp.statics
    from dolfinx_external_operator_torch.ops import element_chain as ec

    K = ec.cell_tangent("blocks", st["B"], C, st["wdet"], keep=fp._keep_cell)
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.standard_normal(fp.n_dofs), device=dev)

    def draw(*shape, dtype=torch.float64):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)

    # E5's operands at the slope's shapes (3 points, 6 basis functions of
    # 2 components, 3 geometry vertices, 6 coarse dofs a cell)
    nc = fp.nc
    dphi, Jinv = draw(3, 6, 2), draw(nc, 3, 2, 2)
    return {"Du": Du, "C": C, "sigma": sigma, "x": x, "B": st["B"], "w": st["wdet"],
            "dof": st["dofmap"], "keep": fp._keep_cell, "node": st["dofmap"][:, ::2] // 2,
            "K": K, "dphi_g": draw(3, 3, 2), "coords": draw(nc, 3, 2), "phi": draw(3, 6),
            "dphi": dphi, "Jinv": Jinv, "gp": torch.einsum("qbd,cqdg->cqbg", dphi, Jinv),
            "d2w": draw(nc, 6, 3), "W": draw(nc, 12, 6, dtype=torch.float32)}


def _ec_call(ch, name, kind, cells=slice(None), device=None):
    """Product ``name`` of ops.element_chain (``kind``: "" the wrapper,
    "_reference" the plain version, "_host" the g++ build) on ``cells``,
    its inputs moved to ``device`` where given."""
    from dolfinx_external_operator_torch.ops import element_chain as ec

    def r(t):
        t = t[cells].contiguous()
        return t if device is None else t.to(device)

    def v(t):
        return t if device is None else t.to(device)

    B, C, w, dof, x = r(ch["B"]), r(ch["C"]), r(ch["w"]), r(ch["dof"]), v(ch["x"])
    if name == "operand_values_grads":  # the pair, each cell's values and gradients a row
        val, grad = getattr(ec, "cell_values_grads" + kind)(v(ch["phi"]), r(ch["gp"]),
                                                             r(ch["d2w"])[:, :, :2])
        return torch.cat([val.flatten(1), grad.flatten(1)], dim=1), "cell_values_grads"
    if name in EC_OPERAND:
        d2 = r(ch["d2w"])[:, :, :2]  # a strided view
        a, b = {"operand_geometry": (v(ch["dphi_g"]), r(ch["coords"])),
                "operand_gphys": (v(ch["dphi"]), r(ch["Jinv"])),
                "operand_values": (v(ch["phi"]), d2), "operand_grads": (r(ch["gp"]), d2)}[name]
        return getattr(ec, "cell_product" + kind)(EC_OPERAND[name], a, b), "cell_product"
    if name == "triple_f32":
        return getattr(ec, "cell_triple" + kind)(r(ch["W"]), r(ch["K"]).float()), "cell_triple"
    if name == "strain":
        fn, args, kw = "cell_strain", (B, dof, v(ch["Du"])), {}
    elif name == "residual":
        fn, args, kw = "cell_residual", (B, r(ch["sigma"]), w), {}
    elif name == "tangent_matvec":
        fn, args, kw = "cell_tangent", ("matvec", B, C, w, dof, x), {}
    elif name == "tangent_diag":
        fn, args, kw = "cell_tangent", ("diag", B, C, w), {}
    elif name.startswith("blocks"):
        fn, args, kw = "cell_tangent", ("blocks", B, C, w), {
            "keep": r(ch["keep"]), "dtype": torch.float32 if "f32" in name else torch.float64}
    else:
        dt = torch.float32 if "f32" in name else torch.float64
        idx, bs = (r(ch["node"]), 2) if "node" in name else (dof, 1)
        K = r(ch["K"]).to(dt)
        fn, args, kw = "ebe_cell_matvec", (K, idx, x.to(dt), bs), {}
    return getattr(ec, fn + kind)(*args, **kw), fn


@pytest.mark.parametrize("name", EC_PRODUCTS)
def test_cuda_element_chain_kernel(ec_state, name):
    """Each E kernel on the card: one launch (the level-1 triple's and the
    values-and-gradients pair's counted under their own wrappers), within
    1e-13 (f64) or 1e-5 (f32) of its plain version, the g++ build's bits,
    the whole batch's bits on the cells of 2 and of 3 slices and in
    reverse order, and the same bits replayed from a CUDA graph."""
    from dolfinx_external_operator_torch.ops import element_chain as ec

    before = ec.launch_counts()
    out, fn = _ec_call(ec_state, name, "")
    torch.cuda.synchronize()
    after = ec.launch_counts()
    assert after[fn] == before[fn] + 1
    assert {k: after[k] - before[k] for k in after if k != fn} == {k: 0 for k in after if k != fn}
    plain, _ = _ec_call(ec_state, name, "_reference")
    tol = 1e-5 if out.dtype == torch.float32 else 1e-13
    assert float((out - plain).abs().max() / plain.abs().max()) < tol
    host, _ = _ec_call(ec_state, name, "_host", device="cpu")
    assert torch.equal(out.cpu(), host)
    nc = out.shape[0]
    for n in (2, 3):
        k = -(-nc // n)
        for r in range(n):
            cells = slice(r * k, min((r + 1) * k, nc))
            assert torch.equal(_ec_call(ec_state, name, "", cells)[0], out[cells]), (n, r)
    rev = torch.arange(nc - 1, -1, -1, device=out.device)
    assert torch.equal(_ec_call(ec_state, name, "", rev)[0], out[rev])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed, _ = _ec_call(ec_state, name, "")
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, out)


@pytest.mark.parametrize("case", [(8, "dia"), (8, "node")])
def test_cuda_slice_bits_of_the_fused_step(cuda, case):
    """``tools/slice_bits.py`` on the card: every per-cell product of the
    8x8 slope's AMG-CG step, the return map included, gives on the cells
    of each of 2 and 3 ranks the whole batch's bits (the level-1 triple,
    a torch matmul, too at this size)."""
    from dolfinx_external_operator_torch.tools import slice_bits

    out = slice_bits.probe(*case, cuda)
    assert out == {name: {2: True, 3: True} for name in out}, out


def test_cuda_slice_bits_of_the_general_path(cuda):
    """``tools/slice_bits.py`` on the card, the general pipeline's 8x8
    slope: the operand evaluation (E5), the Jacobian's action and the
    element-by-element Krylov operator's per-cell product (E4 both) give
    on the cells of each of 2 and 3 ranks the whole batch's bits."""
    from dolfinx_external_operator_torch.tools import slice_bits

    out = slice_bits.probe_general(8, cuda)
    for name in ("operand", "action", "ebe_operator"):
        assert out[name] == {2: True, 3: True}, out


# E2 and E3 at the staging's edges: C and sigma as the return map hands
# them, point-fastest views; the f64 blocks masked, the f32 ones unmasked
# (the dense update's) and masked
EC_STAGED = ("residual", "tangent_matvec", "tangent_diag", "blocks_f64", "blocks_f32",
             "blocks_f32_masked")


def _quad_case(kernel, nc, device, rng, n):
    from dolfinx_external_operator_torch.ops import element_chain as ec

    def point_fastest(*shape):
        t = torch.as_tensor(rng.standard_normal(shape[2:] + shape[:2]), device=device)
        return t.permute(*range(t.dim() - 2, t.dim()), *range(t.dim() - 2))

    B = torch.as_tensor(rng.standard_normal((nc, 3, 4, 12)), device=device)
    C, sig = point_fastest(nc, 3, 4, 4), point_fastest(nc, 3, 4)
    w = torch.as_tensor(rng.standard_normal((nc, 3)), device=device)
    dof = torch.as_tensor(rng.integers(0, n + 1, (nc, 12)), device=device)  # n: padding
    x = torch.as_tensor(rng.standard_normal(n), device=device)
    keep = torch.as_tensor(rng.integers(0, 2, (nc, 12)).astype(np.float64), device=device)
    if kernel == "residual":
        fn, args, kw = "cell_residual", (B, sig, w), {}
    elif kernel.startswith("tangent"):
        mode = kernel.split("_")[1]
        fn, args, kw = "cell_tangent", (mode, B, C, w) + ((dof, x) if mode == "matvec" else ()), {}
    else:
        fn, args = "cell_tangent", ("blocks", B, C, w)
        kw = {"dtype": torch.float32 if "f32" in kernel else torch.float64}
        if kernel != "blocks_f32":
            kw["keep"] = keep

    def call(kind):
        a = args if kind == "" else tuple(t.cpu() if torch.is_tensor(t) else t for t in args)
        k = kw if kind == "" else {key: v.cpu() if torch.is_tensor(v) else v
                                   for key, v in kw.items()}
        return getattr(ec, fn + kind)(*a, **k)
    return call


def _staging_case(kernel, nc, device, seed=13):
    """Seeded inputs of E1, E2, E3 or E4 on ``nc`` cells, as (wrapper
    suffix -> output): ``kernel`` names the layout ("strain"; one of
    ``EC_STAGED``; "ebe_<na>x<nb>_<bs>_<f64|f32>", with "_t" for K a
    transposed view)."""
    from dolfinx_external_operator_torch.ops import element_chain as ec

    rng = np.random.default_rng(seed)
    n = 97
    if kernel in EC_STAGED:
        return _quad_case(kernel, nc, device, rng, n)
    if kernel == "strain":
        B = torch.as_tensor(rng.standard_normal((nc, 3, 4, 12)), device=device)
        dof = torch.as_tensor(rng.integers(0, n + 1, (nc, 12)), device=device)  # n: padding
        u = torch.as_tensor(rng.standard_normal(n), device=device)
        return lambda kind: getattr(ec, "cell_strain" + kind)(*(
            t if kind == "" else t.cpu() for t in (B, dof, u)))
    shape, bs, dt, *t = kernel.split("_")[1:]
    na, nb = map(int, shape.split("x"))
    bs = int(bs)
    dtype = torch.float32 if dt == "f32" else torch.float64
    K = torch.as_tensor(rng.standard_normal((nc, nb, na) if t else (nc, na, nb)), dtype=dtype,
                        device=device)
    K = K.transpose(1, 2) if t else K
    idx = torch.as_tensor(rng.integers(0, n // bs + 1, (nc, nb // bs)), device=device)
    x = torch.as_tensor(rng.standard_normal(n - n % bs), dtype=dtype, device=device)

    def call(kind):
        args = (K, idx, x) if kind == "" else (K.cpu(), idx.cpu(), x.cpu())
        return getattr(ec, "ebe_cell_matvec" + kind)(*args, bs)
    return call


@pytest.mark.parametrize("kernel", ["strain", "ebe_12x12_2_f64", "ebe_12x12_1_f32",
                                    "ebe_12x12_2_f32_t", "ebe_12x12_1_f64_t",
                                    "ebe_6x10_1_f64", "ebe_14x14_2_f32", *EC_STAGED])
@pytest.mark.parametrize("cells", ["1", "G-1", "G+1", "1250"])
def test_cuda_element_chain_staging_edges(cuda, kernel, cells):
    """E1, E2, E3 and E4 at cell counts that reach the staging's edges (one
    cell, a block's group G less and more one, the main path's 1,250), K
    as a transposed view, E4 non-square and wider than the staged shape,
    E2 and E3 with C and sigma point-fastest views: the g++ build's bits,
    and the same bits replayed from a CUDA graph."""
    from dolfinx_external_operator_torch.ops import element_chain as ec

    if kernel in EC_STAGED:
        G = ec.staged_quad()[4 if kernel.startswith("blocks") else 3]
    else:
        G = ec.staged_cells()[2]
    nc = {"1": 1, "G-1": G - 1, "G+1": G + 1, "1250": 1250}[cells]
    call = _staging_case(kernel, nc, cuda)
    out = call("")
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), call("_host"))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = call("")
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, out)


# E5 at the staging's edges: each new kernel (the staged product at each
# summed length, the values-and-gradients pair, the level-1 triple) and an
# unstaged shape of each, f64 and f32, the dofs a strided view
E5_KERNELS = ("geometry_f64", "gphys_f64", "values_f64", "grads_f32", "product_nk5_f64",
              "pair_f64", "pair_f32", "pair_nb10_f64", "triple", "triple_na4")


def _e5_group(kernel):
    """The cells of one group of E5 ``kernel``'s staged kernel: the
    triple's cells a block, the pair's (3 points x 2 components x (1 + 2)
    outputs a cell), the product's cells whose outputs fill a block."""
    from dolfinx_external_operator_torch.ops import element_chain as ec

    e5 = ec.staged_e5()
    if kernel.startswith("triple"):
        return e5["triple"][2]
    if kernel.startswith("pair"):
        return e5["pair_threads"] // 18
    src = (Path(ec.__file__).parent.parent / "csrc" / "element_chain.cu").read_text()
    threads = int(src.split("constexpr int kThreads = ")[1].split(";")[0])
    per_cell = {"geometry": 12, "gphys": 36, "values": 6, "grads": 12, "product": 6}
    return threads // per_cell[kernel.split("_")[0]]


def _e5_case(kernel, nc, device, seed=17):
    """(call(kind) -> output as rows of cells, the wrapper whose count
    moves, its launches) of E5 ``kernel`` on ``nc`` cells: ``kind`` "" the
    wrapper on the card, "_host" the g++ build (the staged composition
    where the card runs staged, else the bodies)."""
    from dolfinx_external_operator_torch.ops import element_chain as ec

    rng = np.random.default_rng(seed)
    dt = torch.float32 if kernel.endswith("f32") or kernel.startswith("triple") else torch.float64

    def draw(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dt, device=device)

    def rows(out):
        return (torch.cat([t.flatten(1) for t in out], dim=1) if isinstance(out, tuple)
                else out.flatten(1))

    def run(fn, staged, *args):
        def call(kind):
            if kind == "":
                return rows(getattr(ec, fn)(*args))
            return rows(getattr(ec, fn + kind)(*(a if isinstance(a, str) else a.cpu()
                                                 for a in args), staged=staged))
        return call

    if kernel.startswith("triple"):
        staged = not kernel.endswith("na4")
        args = (draw(nc, 12, 6 if staged else 4), draw(nc, 12, 12))
        return (run("cell_triple", staged, *args), "cell_triple" if staged else "cell_product",
                1 if staged else 2)
    if kernel.startswith("pair"):
        staged = "nb10" not in kernel
        nb = 6 if staged else 10
        args = (draw(3, nb), draw(nc, 3, nb, 2), draw(nc, nb, 3)[:, :, :2])
        return (run("cell_values_grads", staged, *args),
                "cell_values_grads" if staged else "cell_product", 1 if staged else 2)
    nk = 5 if "nk5" in kernel else None
    eq, args = {
        "geometry": ("qvd,cvg->cqgd", (draw(3, 3, 2), draw(nc, 3, 2))),
        "gphys": ("qbd,cqdg->cqbg", (draw(3, 6, 2), draw(nc, 3, 2, 2))),
        "values": ("qb,cbk->cqk", (draw(3, 6), draw(nc, 6, 3)[:, :, :2])),
        "grads": ("cqbg,cbk->cqkg", (draw(nc, 3, 6, 2), draw(nc, 6, 3)[:, :, :2])),
        "product": ("qb,cbk->cqk", (draw(3, nk or 6), draw(nc, nk or 6, 3)[:, :, :2])),
    }[kernel.split("_")[0]]
    return run("cell_product", nk is None, eq, *args), "cell_product", 1


@pytest.mark.parametrize("kernel", E5_KERNELS)
@pytest.mark.parametrize("cells", ["1", "G-1", "G+1", "1250"])
def test_cuda_e5_staging_edges(cuda, kernel, cells):
    """E5's new kernels at cell counts that reach their groups' edges (one
    cell, a group G less and more one, the main path's 1,250) and one
    unstaged shape of each: the g++ build's bits (the staged composition
    where the card runs staged), the launches of the wrapper that runs
    them (one staged launch, or the two products), and the same bits
    replayed from a CUDA graph."""
    from dolfinx_external_operator_torch.ops import element_chain as ec

    G = _e5_group(kernel)
    nc = {"1": 1, "G-1": max(G - 1, 1), "G+1": G + 1, "1250": 1250}[cells]
    call, fn, launches = _e5_case(kernel, nc, cuda)
    before = ec.launch_counts()
    out = call("")
    torch.cuda.synchronize()
    after = ec.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: launches if k == fn else 0 for k in after}
    assert torch.equal(out.cpu(), call("_host"))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = call("")
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, out)


# ----------------------------------------------------------------------
# AMG-CG's f32 iteration through the fused kernels (ops/mg_cycle.py)

MG_OPTS = {"ksp_type": "cg", "pc_type": "mg"}
CYLINDER_RECORD = Path(__file__).resolve().parent.parent / "fembench/configs/vm-cylinder-fine.json"


def _same_bits(a, b):
    """Equal bit for bit where not NaN, NaN at the same places."""
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def _torch_chains(monkeypatch):
    """``vcycle`` and ``ir_pcg`` through the torch chains, as before the
    kernels."""
    from dolfinx_external_operator_torch.parallel import mg

    monkeypatch.setattr(mg, "_chebyshev", mg._chebyshev_reference)
    monkeypatch.setattr(mg, "_pcg_iterations", mg._pcg_iterations_reference)


@pytest.fixture(scope="module")
def cylinder_mg():
    """The lc = 0.02 cylinder with cg + mg on the card after two load
    steps (the second plastic): the solver's plan and workspace, the f32
    operator and the cycle as ``_mg_solve`` builds them, and a seeded
    residual zero on the masked rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (see README: the port's card-only tests)")
    from dolfinx_external_operator_torch.parallel import mg

    P = vm.build_cylinder_problem(0.02, snes_opts=MG_OPTS)
    for load in (0.5, 0.85):
        P["loading"].value = load * P["q_lim"]
        P["Du"].x.array[:] = torch.full_like(P["Du"].data, np.finfo(np.float64).eps)
        P["problem"].solve()
        P["p"].x.axpy(1.0, P["dp"].x)
        P["sigma_n"].x.array[:] = P["sigma"].ref_coefficient.data
    st = P["problem"].solver._mg
    plan, ws = st["amg"].plan, st["amg"].ws
    mask = ws["mask"]

    def M32(r):
        return torch.where(mask, r, mg.vcycle(plan, ws["rt"], torch.where(mask, 0.0, r)))

    rng = np.random.default_rng(23)
    r = torch.as_tensor(rng.standard_normal(mask.shape[0]), dtype=torch.float32, device="cuda")
    return plan, ws, ws["rt"]["mv0"], M32, torch.where(mask, 0.0, r)


def _pcg_state(M32, r):
    from dolfinx_external_operator_torch.parallel import mg

    z, rz, nb, _ = mg._pcg_start(M32, r)
    x = torch.zeros_like(r)
    return {"x": x, "r": r, "p": z, "rz": rz, "nb": nb, "xb": x}


def _same_batch(a, b):
    (s_a, t_a, xb_a), (s_b, t_b, xb_b) = a, b
    return (_same_bits(t_a, t_b) and _same_bits(xb_a, xb_b)
            and all(_same_bits(s_a[k], s_b[k].reshape(s_a[k].shape)) for k in s_a))


def test_cuda_mg_cycle_kernels_match_the_torch_chains(cylinder_mg, monkeypatch):
    """On the cylinder's own hierarchy (11,222 / 2,912 / 558 dofs smoothed,
    63 inverted): a cycle (18 Chebyshev launches) and a batch of 8 f32 PCG
    iterations (8 launches of each PCG kernel) through the kernels give
    the torch chains' bits on the same CUDA tensors."""
    from dolfinx_external_operator_torch.ops import mg_cycle as mgc
    from dolfinx_external_operator_torch.parallel import mg

    plan, ws, mv32, M32, r = cylinder_mg
    assert [lv["n"] for lv in plan["levels"]][:2] == [2912, 558] and r.shape[0] == 11222
    mgc.reset_launches()
    z = mg.vcycle(plan, ws["rt"], r)
    assert mgc.launch_counts() == {"chebyshev_step": 18, "pcg_xr": 0, "pcg_p": 0}
    state = _pcg_state(M32, r)
    mgc.reset_launches()
    fused = mg._pcg_iterations(mv32, M32, state, 8)
    torch.cuda.synchronize()
    assert mgc.launch_counts() == {"chebyshev_step": 8 * 18, "pcg_xr": 8, "pcg_p": 8}
    _torch_chains(monkeypatch)
    assert _same_bits(z, mg.vcycle(plan, ws["rt"], r))
    assert _same_batch(fused, mg._pcg_iterations(mv32, M32, _pcg_state(M32, r), 8))


def test_cuda_graphs_replayed_after_mg_setup_read_the_new_hierarchy(cylinder_mg, monkeypatch):
    """A cycle and a PCG batch captured in CUDA graphs, then the workspace's
    element blocks scaled cell by cell and ``mg_setup(..., out=)`` run
    again: the replays read the new hierarchy (its Chebyshev bounds
    moved) and give the torch chains' bits on it."""
    from dolfinx_external_operator_torch.parallel import mg
    from dolfinx_external_operator_torch.utils.graphs import capture

    plan, ws, mv32, M32, r = cylinder_mg
    K32, rt = ws["K32"], ws["rt"]
    held = K32.clone()
    cycle = capture(M32, r)
    batch = capture(mg._pcg_iterations, mv32, M32, _pcg_state(M32, r), 8)
    theta = rt["cheb0"][0].clone()
    rng = np.random.default_rng(5)
    scale = torch.as_tensor(1.0 + 0.5 * rng.random(K32.shape[0]), dtype=torch.float32,
                            device=K32.device)
    try:
        K32.mul_(scale[:, None, None])
        assert mg.mg_setup(plan, K32, ws["free"], out=rt) is rt
        assert not torch.equal(rt["cheb0"][0], theta)
        z = cycle(r)
        state = _pcg_state(M32, r)
        replayed = batch(mv32, M32, state, 8)
        torch.cuda.synchronize()
        with monkeypatch.context() as m:
            _torch_chains(m)
            assert _same_bits(z, M32(r))
            assert _same_batch(replayed, mg._pcg_iterations(mv32, M32, _pcg_state(M32, r), 8))
    finally:
        K32.copy_(held)
        mg.mg_setup(plan, K32, ws["free"], out=rt)


def test_cuda_capture_outlives_a_graph_collected_meanwhile(cuda):
    """A graph left in a dead reference cycle (as a discarded solver leaves
    its graphs) while another is captured: the collector does not free it
    during the capture, which would invalidate the capture, and the new
    graph replays."""
    from dolfinx_external_operator_torch.utils.graphs import capture

    x = torch.arange(8.0, device=cuda)
    spare = [capture(lambda v: 2.0 * v, x)]
    calls = []

    def fn(v):
        if not calls:  # the eager call: the spare graph into a dead cycle
            cycle = [spare.pop()]
            cycle.append(cycle)
        else:  # the capture: enough new objects for the collector to run
            [[] for _ in range(100_000)]
        calls.append(v.shape)
        return v + 1.0

    run = capture(fn, x)
    assert len(calls) == 2 and not spare
    assert torch.equal(run(x + 1.0), x + 2.0)


# the last step's Du of that schedule before the kernels (the first 16 hex
# digits of the SHA-256 of its bytes; an H100)
CYLINDER_DU = "f5aac105293c2f28"


def _du_fingerprint(Du):
    import hashlib

    return hashlib.sha256(Du.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def test_cuda_cylinder_schedule_through_the_kernels_keeps_the_record(cuda, monkeypatch):
    """The lc = 0.02 cylinder's 20 steps with cg + mg (the default yield
    stress, the benchmark's seed 0): the record's Newton list, 8,885 PCG
    iterations through the kernels (launched at the batches' captures,
    replayed after), and the torch chains' ``Du`` bit for bit, which is
    the schedule's ``Du`` before the kernels."""
    import json

    from dolfinx_external_operator_torch.ops import mg_cycle as mgc
    from dolfinx_external_operator_torch.utils import profiling

    record = json.loads(CYLINDER_RECORD.read_text())["record"]
    profiling.reset_counters()
    mgc.reset_launches()
    run = vm.solve_von_mises(lc=0.02, num_increments=20, snes_opts=MG_OPTS)
    counted = profiling.counters()
    assert run["iterations"] == record["newton_per_step"]
    assert sum(run["ksp_iterations"]) == record["inner_total"] == 8885
    assert counted["solve.inner"] == 8885
    assert counted["launches.pcg_xr"] == counted["launches.pcg_p"] > 0
    assert counted["launches.chebyshev_step"] > 0
    Du = run["problem"].u.data.clone()
    _torch_chains(monkeypatch)
    plain = vm.solve_von_mises(lc=0.02, num_increments=20, snes_opts=MG_OPTS)
    assert plain["iterations"] == run["iterations"]
    assert plain["ksp_iterations"] == run["ksp_iterations"]
    assert torch.equal(plain["problem"].u.data, Du)
    assert _du_fingerprint(Du) == CYLINDER_DU
