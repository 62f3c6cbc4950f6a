"""Card-only tests of the port's CUDA kernels; each skips without a GPU.

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
