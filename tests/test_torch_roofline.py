"""The port's roofline accounting (``utils/roofline.py``) against the JAX
package's (``tests/test_roofline.py`` mirrored).

* the return map's MFU entry: its ranges, and the JAX entry's keys with the
  TPU's units renamed for the card;
* the return map's operation count on the bench mix: the same from the
  JAX map's iteration counts, the port's plain map and the g++ build of
  K1's body, since the count reads the work and not what implements it;
* the level-0 DIA matvec's counts on a 12x12 AMG-CG step, equal to the
  JAX entry's on the JAX step built from the same mesh;
* the timing path, which needs a card and raises on a CPU step;
* the bounds and the work counts that ``chip_smoke.py`` reports against.

CPU only: the timings themselves are measured on the card by
``chip_smoke.py``."""
import numpy as np
import pytest

import jax.numpy as jnp

import torch

from dolfinx_external_operator_tpu import locate_dofs_geometrical
from dolfinx_external_operator_tpu.models.mohr_coulomb import MohrCoulombMaterial as MatJ
from dolfinx_external_operator_tpu.models.mohr_coulomb import build_slope_problem
from dolfinx_external_operator_tpu.parallel.spmd import FusedPlasticityStep as StepJ
from dolfinx_external_operator_tpu.utils import roofline as roof_j

import dolfinx_external_operator_torch as pt
from dolfinx_external_operator_torch.models.mohr_coulomb import MohrCoulombMaterial as MatT
from dolfinx_external_operator_torch.ops import mohr_coulomb as mc_ops
from dolfinx_external_operator_torch.ops import vonmises as vm_ops
from dolfinx_external_operator_torch.utils import roofline

torch.set_num_threads(2)

N_MIX = 2000
# the JAX entry's keys and the port's names for them
RENAMED = {"flops_per_pt_xla_lo_hi": "flops_per_pt_lo_hi",
           "vpu_f32_peak_gflops": "h100_f32_peak_gflops",
           "pct_vpu_peak_lo_hi": "pct_h100_f32_peak_lo_hi"}


def _bench_mix(n, seed=0):
    """bench.py:77-83: compressive normal strains, half the points sheared
    past yield, zero initial stress; point-major."""
    rng = np.random.default_rng(seed)
    deps = rng.normal(scale=1e-3, size=(n, 4))
    deps[:, :3] -= 1.5e-3
    deps[: n // 2, 3] += 6e-3
    return deps, np.zeros_like(deps)


@pytest.fixture(scope="module")
def mix_counts():
    """The bench mix's per-lane iteration counts from the JAX map, the
    port's plain map and K1's g++ body, and the SoA inputs."""
    deps, sn = _bench_mix(N_MIX)
    _, _, stats = MatJ().tangent_and_stress(jnp.asarray(deps).ravel(), jnp.asarray(sn).ravel())
    d = torch.tensor(deps.T.copy())
    s = torch.zeros_like(d)
    mat = MatT()
    return {"mat": mat, "d": d, "s": s,
            "jax": np.asarray(stats["niter"]),
            "plain": mat.tangent_stress(d, s)[1][1].numpy(),
            "body": mc_ops.mc_return_map_host(d, s, mat)[2].numpy()}


@pytest.mark.parametrize("impl", ["jax", "plain", "body"])
def test_return_map_flops_same_work_whatever_implements_it(mix_counts, impl):
    """The count per point is the fixed part plus MC_ITER_OPS per Newton
    iteration taken: the JAX map, the plain map and K1's body take the same
    iterations on every lane of the bench mix, so the count is the same,
    and it lies between the fixed part and the trip bound."""
    mat, d, s = mix_counts["mat"], mix_counts["d"], mix_counts["s"]
    assert np.array_equal(mix_counts[impl], mix_counts["plain"])
    f = roofline.return_map_flops_per_pt(mat, d, s, niter=mix_counts[impl])
    assert f == roofline.return_map_flops_per_pt(mat, d, s)
    fixed = roofline.MC_FIXED_F32_OPS + roofline.MC_FIXED_F64_OPS
    expect = fixed + roofline.MC_ITER_OPS * mix_counts[impl].sum() / N_MIX
    assert f == pytest.approx(expect, rel=1e-15)
    assert fixed < f < roofline.return_map_flops_per_pt_hi(mat)


def test_return_map_flops_hi_is_the_trip_bound():
    mat = MatT()
    it = mat.max_iter32_eff + mat.n_polish_max
    assert roofline.return_map_flops_per_pt_hi(mat) == (
        roofline.MC_FIXED_F32_OPS + roofline.MC_FIXED_F64_OPS + roofline.MC_ITER_OPS * it)


def test_return_map_mfu_entry(mix_counts):
    """The JAX entry's layout and ranges, its TPU units renamed for the
    card; achieved rate = points/s x operations per point."""
    mat, d, s = mix_counts["mat"], mix_counts["d"], mix_counts["s"]
    lo = roofline.return_map_flops_per_pt(mat, d, s)
    hi = roofline.return_map_flops_per_pt_hi(mat)
    e = roofline.return_map_mfu(1.0e6, lo, hi, card="a card, 700.00 W")
    e_j = roof_j.return_map_mfu(1.0e6, 100.0, 200.0)
    assert set(e) == {RENAMED.get(k, k) for k in e_j} | {"card"}
    lo_g, hi_g = e["achieved_gflops_lo_hi"]
    assert 0 < lo_g < hi_g
    assert lo_g == pytest.approx(1.0e6 * lo / 1e9) and hi_g == pytest.approx(1.0e6 * hi / 1e9)
    plo, phi = e["pct_h100_f32_peak_lo_hi"]
    assert 0 < plo < phi < 100
    assert e["h100_f32_peak_gflops"] == roofline.H100_F32_FLOPS_PER_S / 1e9
    assert e["card"] == "a card, 700.00 W"
    assert "card" not in roofline.return_map_mfu(1.0e6, lo, hi)


@pytest.fixture(scope="module")
def mg_steps():
    """The 12x12 slope's AMG-CG steps in both packages, from the same mesh
    parameters (the JAX one as tests/test_roofline.py builds it)."""
    mat = MatJ()
    P = build_slope_problem(Nx=12, Ny=12)
    V, S = P["V"], P["S"]
    bottom = locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0))
    right = locate_dofs_geometrical(V, lambda x: np.isclose(x[0], 1.2))
    bc = np.concatenate([np.concatenate([s * 2, s * 2 + 1]) for s in (bottom, right)])

    def kernel(deps, sn):
        C, st = mat.tangent_stress_point(deps, sn)
        return C, st[0]

    fp_j = StepJ(P["mesh"], V, S, kernel, bc, linear_solver="mg")
    fp_t = pt.mohr_coulomb_slope_step(12, 12, route="plain", device="cpu", linear_solver="mg")
    return fp_j, fp_t


@pytest.mark.parametrize("field", ["n_rows", "n_bands", "bytes_per_matvec"])
def test_dia_counts_match_jax(mg_steps, field):
    fp_j, fp_t = mg_steps
    e_j = roof_j.dia_roofline_from_fp(fp_j, reps=2, chain=2)
    counts = roofline.dia_counts(fp_t)
    assert counts[field] == e_j[field]
    assert counts["n_rows"] == fp_t.n_dofs
    assert counts["flops_per_matvec"] == 2 * counts["n_bands"] * counts["n_rows"]


def test_dia_timing_raises_on_a_cpu_step(mg_steps):
    """A measurement path finds a card or fails: no CPU timing under the
    card's name."""
    _, fp_t = mg_steps
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.dia_roofline_from_fp(fp_t, reps=2, chain=2)


def test_dia_counts_none_without_bands():
    """A step with no banded level 0 (dense solver) has no DIA entry."""
    fp = pt.mohr_coulomb_slope_step(4, 4, route="plain", device="cpu", linear_solver="dense")
    assert roofline.dia_counts(fp) is None
    assert "error" in roofline.dia_roofline_from_fp(fp)


@pytest.mark.parametrize("ops,nbytes,by", [(0, 3.35e9, "bytes"), (67e9, 0, "operations"),
                                           (67e9, 3.35e9, "operations")])
def test_bound_takes_the_larger_time(ops, nbytes, by):
    """1 ms per 67 GFLOP of f32 or per 3.35 GB of HBM traffic; a tie
    counts as operations."""
    ms, which = roofline.bound(ops, nbytes)
    assert ms == pytest.approx(1.0) and which == by
    assert roofline.bound(34e9, 0, roofline.H100_F64_FLOPS_PER_S)[0] == pytest.approx(1.0)


def test_kernel_counts():
    """The byte counts of the kernels' wrappers are the roofline's, and
    the von Mises kernel is bound by bytes at any size on both entries."""
    assert vm_ops.BYTES_PER_POINT == roofline.VM_BYTES_PER_POINT == 120
    assert vm_ops.BYTES_PER_POINT_F64 == roofline.VM_F64_BYTES_PER_POINT == 224
    assert mc_ops.BYTES_PER_POINT == roofline.MC_BYTES_PER_POINT == 252
    for bpp in (roofline.VM_BYTES_PER_POINT, roofline.VM_F64_BYTES_PER_POINT):
        ms, by = roofline.vm_bound(3750, bpp)
        assert by == "bytes" and ms == pytest.approx(bpp * 3750 / 3.35e12 * 1e3)
    niter = np.array([0, 3, 5])
    f32_ops, f64_ops = roofline.mc_ops(niter)
    assert f32_ops == 3 * roofline.MC_FIXED_F32_OPS + 8 * roofline.MC_ITER_OPS
    assert f64_ops == 3 * roofline.MC_FIXED_F64_OPS
    assert roofline.mc_bound(torch.tensor(niter))[1] == "operations"


def test_bcr_and_mg_counts():
    """BCR at one block is the root's inversion alone; the 12x12 AMG-CG
    plan's cycle reads its level-0 bands."""
    c = roofline.bcr_counts(1, 4)
    assert c == {"factor_ops": 64, "factor_bytes": 4 * 16 * 4, "apply_ops": 32,
                 "apply_bytes": 64}
    c2 = roofline.bcr_counts(26, 204)
    assert c2["factor_ops"] > 0 and c2["apply_bytes"] > c["apply_bytes"]
    fp = pt.mohr_coulomb_slope_step(12, 12, route="plain", device="cpu", linear_solver="mg")
    plan = fp._mg
    nc, nk = fp.statics["dofmap"].shape
    m = roofline.mg_counts(plan, fp._mg_gamma, nc, nk)
    nnz0 = plan["dia0"]["nb"] * plan["n0"]
    assert m["cycle_bytes"] > 4 * nnz0 and m["cycle_ops"] > 12 * nnz0
    assert m["setup_ops"] > 0 and m["setup_bytes"] > 4 * nc * nk * nk
