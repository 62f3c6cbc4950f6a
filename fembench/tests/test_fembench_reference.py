"""The plain reference: its slope is laid out as the program's outputs are,
its return map keeps the elastic points exact and puts the plastic ones on
the yield surface, and the frozen counts equal the hand-worked values."""

import ast
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from fembench.counts import bcr, dense, mc  # noqa: E402
from fembench.reference.mohr_coulomb import Material, return_map, surface  # noqa: E402
from fembench.reference.slope import Slope  # noqa: E402

DEMO = dict(E=6778.0, nu=0.25, c=3.45, phi_deg=30.0, psi_deg=30.0, theta_T_deg=26.0)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "fembench", "reference")
    for f in sorted(os.listdir(ref)):
        if not f.endswith(".py"):
            continue
        for node in ast.walk(ast.parse(open(os.path.join(ref, f)).read())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert tops <= {"__future__", "math", "numpy", "scipy", "torch"}, (f, tops)


@pytest.mark.parametrize("n", [(3, 2), (6, 6)])
def test_slope_layout_is_the_programs(n):
    from dolfinx_external_operator_torch.parallel.spmd import host_statics
    from dolfinx_external_operator_torch.problems import build_plasticity_block

    s = Slope(*n)
    mesh, V, S, bc = build_plasticity_block(*n)
    st = host_statics(mesh, V, S, bc)
    assert np.array_equal(s.dofmap, st["dofmap"])
    assert np.array_equal(s.bc_mask, st["bc_mask"])
    np.testing.assert_allclose(s.B, st["B"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(s.w, st["wdet"], rtol=1e-14)
    f = np.zeros(s.n_dofs)
    np.add.at(f, st["dofmap"], st["f_cell"])
    np.testing.assert_allclose(s.f, f, rtol=0, atol=1e-15)


def test_elastic_point_is_the_trial_state():
    mat = Material(**DEMO)
    d = torch.tensor([[1e-5], [-2e-5], [0.0], [1e-5]], dtype=torch.float64)
    sn = torch.zeros_like(d)
    sig, C_t, it, counted, ok = return_map(mat, d, sn)
    C = torch.as_tensor(mat.C)
    assert torch.equal(sig, C @ d) and torch.equal(C_t[:, :, 0], C)
    assert int(it) == 0 and int(counted) == 0 and bool(ok)


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-10), (torch.float32, 1e-3)])
def test_plastic_point_lies_on_the_yield_surface(dtype, tol):
    mat = Material(**DEMO)
    d = torch.tensor([[-1.5e-3], [-2.5e-3], [-1.5e-3], [7e-3]], dtype=torch.float64)
    sig, C_t, it, counted, ok = return_map(mat, d, torch.zeros_like(d), dtype=dtype)
    f, _ = surface(mat.yield_k, sig.to(torch.float64))
    assert int(it) >= 1 and abs(float(f)) < tol * float(mat.c)
    assert bool(ok) == (dtype == torch.float64)
    # the tangent is softer than the elastic one along the shear
    assert float(C_t[3, 3, 0]) < float(mat.C[3, 3])


def test_return_map_agrees_with_the_programs_plain_map():
    from dolfinx_external_operator_torch.models.mohr_coulomb import MohrCoulombMaterial

    rng = np.random.default_rng(3)
    n = 64
    deps = rng.normal(scale=1e-3, size=(n, 4))
    deps[:, :3] -= 1.5e-3
    deps[: n // 2, 3] += 6e-3
    d = torch.tensor(deps.T.copy())
    sig, C_t, *_ = return_map(Material(**DEMO), d, torch.zeros_like(d))
    C_p, aux = MohrCoulombMaterial().tangent_stress(d, torch.zeros_like(d))
    assert float((sig - aux[0]).abs().max() / aux[0].abs().max()) < 1e-7
    assert float((C_t - C_p).abs().max() / C_p.abs().max()) < 1e-4


def test_frozen_counts_at_both_sizes():
    # 25 x 25: n = 5,202; Cholesky n^3/3 at 67 TFLOP/s, LU 2n^3/3
    assert dense.cholesky_bound_s(5202) == pytest.approx(5202 ** 3 / 3 / 67e12)
    assert dense.cholesky_bound_s(5202) * 1e3 == pytest.approx(0.7003, abs=1e-4)
    assert dense.lu_bound_s(5202) * 1e3 == pytest.approx(1.4007, abs=1e-4)
    # 100 x 100: the lattice blocks and the factor's 13.57 ms
    assert bcr.lattice_blocks(100, 100) == (101, 804)
    assert bcr.lattice_blocks(25, 25) == (26, 204)
    ops, nbytes = bcr.factor_counts(101, 804)
    # levels of 101, 51, 26, 13, 7, 4, 2 blocks: 1,748 B^3 and 508 blocks, plus the root
    assert ops == 1749 * 804 ** 3 and nbytes == 4 * 804 ** 2 * (303 + 509)
    assert bcr.factor_bound_s(101, 804) * 1e3 == pytest.approx(13.567, abs=1e-3)
    # K1: 252 bytes a point; 65,536 points at one iteration each
    assert mc.BYTES_PER_POINT == 252
    f32, f64 = mc.ops(65536, 65536)
    assert (f32, f64) == (65536 * 2315, 65536 * 1590)
    assert mc.bound_s(65536, 65536) == pytest.approx(65536 * (2315 / 67e12 + 1590 / 34e12))


def test_frozen_counts_equal_the_programs_roofline():
    from dolfinx_external_operator_torch.utils import roofline as rf

    assert (mc.BYTES_PER_POINT, mc.ITER_OPS, mc.FIXED_F32_OPS, mc.FIXED_F64_OPS) == (
        rf.MC_BYTES_PER_POINT, rf.MC_ITER_OPS, rf.MC_FIXED_F32_OPS, rf.MC_FIXED_F64_OPS)
    niter = np.array([0, 3, 7, 1])
    assert mc.bound_s(4, 11) * 1e3 == pytest.approx(rf.mc_bound(niter)[0])
    c = rf.bcr_counts(101, 804)
    assert bcr.factor_counts(101, 804) == (c["factor_ops"], c["factor_bytes"])


def test_bcr_blocks_are_the_programs():
    from dolfinx_external_operator_torch.parallel import bcr as pbcr
    from dolfinx_external_operator_torch.problems import build_plasticity_block

    for n in (3, 4):
        mesh, V, S, bc = build_plasticity_block(n, n)
        mask = np.zeros(V.num_dofs, bool)
        mask[bc] = True
        info = pbcr.build_bcr_statics(mesh, V, mask)
        assert (int(info["m"]), int(info["B"])) == bcr.lattice_blocks(n, n)
