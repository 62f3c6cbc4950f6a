"""Card-only tests of the port's CUDA kernels and of its runs on the card;
each skips without a GPU.

This file imports no JAX, so that it runs on a machine that has PyTorch
with CUDA but no JAX (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
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
    converges within 10 updates a step, launches the kernel once per Newton
    pass, agrees with the f64 path to 1e-3, and repeats bitwise (the
    scatters use no atomics)."""
    fp64 = pt.von_mises_block_step(8, 8, "f64", linear_solver="dense")
    fp32 = pt.von_mises_block_step(8, 8, "f32", linear_solver="dense",
                                   newton_rtol=1e-5, newton_atol=1e-3)
    assert fp32.device.type == "cuda" and fp32._dense_fact == "chol"
    Du64, its64 = _run(fp64)
    before = ops.vonmises_return_map.launches
    Du32, its32 = _run(fp32)
    assert its64 == [1, 5, 7]
    assert all(i <= 10 for i in its32), its32
    assert ops.vonmises_return_map.launches - before == sum(its32) + len(its32)
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

    m, B = 11, 64
    T, A = _block_tridiag(m, B)
    b = np.random.default_rng(1).normal(size=m * B)
    stats = {}
    fact = bcr.bcr_factor(torch.tensor(T, dtype=dtype, device=cuda), m, B, stats)
    x = bcr.bcr_apply(fact, torch.tensor(b, dtype=dtype, device=cuda)).cpu().numpy()
    x_ref = np.linalg.solve(A, b)
    assert np.abs(x - x_ref).max() < tol * np.abs(x_ref).max()
    assert stats.get("inv_levels", 0) == 0


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
    """Two gloo ranks with CUDA tensors on one card (NCCL refuses that):
    the one-rank Newton list, Du within 1e-10, the ranks' norms bitwise
    equal, one K1 launch per Newton pass on each rank.  In node mode the
    cycle's level-0 matvec all-reduces over gloo, so the cycle runs eager
    (no CUDA graph can hold a gloo all-reduce); in dia mode it is graphed."""
    from dolfinx_external_operator_torch.entry import slope_schedule
    from dolfinx_external_operator_torch.parallel import dist

    loads, mg_opts = (2.0, 6.0, 10.0), {"mv0_mode": mode}
    runs = dist.spawn(slope_schedule, 2, "gloo", None, 8, loads, "mg", mg_opts=mg_opts)
    Du, _, its, _ = _unsharded(8, loads, cuda, linear_solver="mg", mg_opts=mg_opts)
    for run in runs:
        assert run["device"] == "cuda:0" and run["newton"] == its
        assert float(np.abs(run["du"] - Du).max()) < 1e-10
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
