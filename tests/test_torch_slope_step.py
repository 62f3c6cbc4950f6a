"""The port's Mohr-Coulomb slope load step against the JAX package's.

The protocol of ``test_parallel.py:22-55``: the 4x4 slope (P2, 162 dofs,
96 Gauss points), loads ``linspace(2, 14, 3)``, Du carried from step to
step, the JAX ``FusedPlasticityStep`` built on the material's per-point
``tangent_stress_point``.  The port runs the same steps with the plain f64
return map; the Newton lists must be equal and Du must agree to 1e-12.
The dense path runs two f64 refinement rounds on both sides (with one, the
two libraries' f32 factorizations leave ~1e-11 here; ROADMAP queue 3).
"""
import numpy as np
import pytest

import torch

from dolfinx_external_operator_tpu import locate_dofs_geometrical
from dolfinx_external_operator_tpu.models.mohr_coulomb import build_slope_problem
from dolfinx_external_operator_tpu.parallel.spmd import FusedPlasticityStep as StepJ

import dolfinx_external_operator_torch as pt
from dolfinx_external_operator_torch.ops import mohr_coulomb as ops_t

torch.set_num_threads(2)

LOADS = np.linspace(2, 14, 3)
RECORD_25X25 = [1, 2, 2, 3, 3, 2, 3, 3, 3, 3, 3, 3, 4, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3,
                4, 4, 3, 3, 3, 3, 3, 3, 4, 3, 3, 3, 3, 3, 4, 4, 3, 4, 4, 4, 4, 4, 4, 6, 7, 4]


def _jax_step(solver, refine=None):
    P = build_slope_problem(Nx=4, Ny=4)
    mat, mesh, V, S = P["material"], P["mesh"], P["V"], P["S"]
    bottom = locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0))
    right = locate_dofs_geometrical(V, lambda x: np.isclose(x[0], 1.2))
    bc_dofs = np.concatenate([np.concatenate([s * 2, s * 2 + 1]) for s in (bottom, right)])

    def kernel(deps, sn):
        C_tang, state = mat.tangent_stress_point(deps, sn)
        return C_tang, state[0]

    fp = StepJ(mesh, V, S, kernel, bc_dofs, linear_solver=solver)
    if refine is not None:
        fp._dense_refine = refine
        fp._step = fp._build_step()
    return fp


def _port_step(solver, refine=None, **kw):
    fp = pt.mohr_coulomb_slope_step(4, 4, device="cpu", linear_solver=solver, **kw)
    if refine is not None:
        fp._dense_refine = refine
    return fp


def _schedule(fp, loads=LOADS, step=None):
    """(Du per step, sigma per step, Newton list) as numpy."""
    step = step or fp.run_step
    Du, sig = fp.zero_state()
    dus, sigs, its = [], [], []
    for load in loads:
        Du, sig, _, it, _ = step(Du, sig, load)
        dus.append(np.asarray(Du))
        sigs.append(np.asarray(sig))
        its.append(int(it))
    return dus, sigs, its


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def port_dense():
    fp = _port_step("dense", refine=2)
    return fp, _schedule(fp)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_slope_4x4_matches_jax(solver, port_dense):
    refine = 2 if solver == "dense" else None
    du_j, sig_j, its_j = _schedule(_jax_step(solver, refine))
    if solver == "dense":
        du_t, sig_t, its_t = port_dense[1]
    else:
        du_t, sig_t, its_t = _schedule(_port_step(solver))
    assert its_t == its_j == [1, 4, 4]
    for a, b in zip(du_t, du_j):
        assert _rel(a, b) < 1e-12
    for a, b in zip(sig_t, sig_j):
        assert _rel(a, b) < 1e-12


def test_slope_step_is_the_block(port_dense):
    fp, _ = port_dense
    assert (fp.n_dofs, fp.nc * fp.nq) == (162, 96) and fp.linear_solver == "dense"
    assert pt.mohr_coulomb_slope_step(2, 2, device="cpu").linear_solver == "dense"  # auto
    assert len(pt.SLOPE_LOADS) == 52 and pt.SLOPE_LOADS[49] == 22.9
    assert tuple(pt.SLOPE_LOADS[-2:]) == (22.96, 22.99)


def test_kernel_body_drives_the_same_steps(port_dense):
    """A step whose return map is the kernel's own per-point body (the g++
    build) gives the plain path's Newton list and Du to 1e-12."""
    fp, (du, _, its) = port_dense
    mat = pt.MohrCoulombMaterial()

    def body(deps, sn):
        C, sig, *_ = ops_t.mc_return_map_host(deps.contiguous(), sn.contiguous(), mat)
        return C.view(4, 4, -1), sig

    mesh, V, S, bc_dofs = pt.build_plasticity_block(4, 4)
    fp_b = pt.FusedPlasticityStep(mesh, V, S, body, bc_dofs, device="cpu",
                                  linear_solver="dense")
    fp_b._dense_refine = 2
    du_b, _, its_b = _schedule(fp_b)
    assert its_b == its
    for a, b in zip(du_b, du):
        assert _rel(a, b) < 1e-12


def test_routes_and_drivers_agree(port_dense):
    """route="cuda" on CPU tensors is the plain version; run_schedule and
    the host-driven step reach the fused step's results."""
    fp, (du, sig, its) = port_dense
    fp_c = _port_step("dense", refine=2, route="cuda")
    du_c, sig_c, its_c = _schedule(fp_c)
    assert its_c == its and all(np.array_equal(a, b) for a, b in zip(du_c + sig_c, du + sig))
    Du_s, sig_s, norms, its_s, _ = fp.run_schedule(LOADS)
    assert its_s.tolist() == its and np.array_equal(Du_s.numpy(), du[-1])
    du_h, _, its_h = _schedule(fp, step=fp.run_step_host)
    assert its_h == its
    for a, b in zip(du_h, du):
        assert _rel(a, b) < 1e-12


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.mohr_coulomb_slope_step(2, 2)


@pytest.mark.slow
def test_slope_25x25_full_schedule():
    """The main path at full size on the CPU: the 52-step schedule gives the
    record's Newton list (171 updates)."""
    fp = pt.mohr_coulomb_slope_step(25, 25, route="plain", device="cpu")
    _, _, its = _schedule(fp, loads=pt.SLOPE_LOADS)
    assert its == RECORD_25X25 and sum(its) == 171
