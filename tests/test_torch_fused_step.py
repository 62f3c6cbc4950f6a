"""The port's fused plasticity load step against the JAX package's.

The von Mises block of ``__graft_entry__._build_vm`` at 8x8 (P2, 578 dofs)
with loads (200, 400, 600), Du carried from step to step as ``bench.py``
carries it.  The JAX package gives the Newton lists [1, 5, 7] with the f64
kernel (dense and CG) and [1, 5, 6] with the f32 Pallas kernel; the port
must give the same lists.

Du agrees to 1e-12 relative wherever both packages run the same
arithmetic to f64 accuracy.  The dense solver's default is an f32
factorization with ONE f64 refinement round, which leaves an error of
order (kappa * eps32)^2 ~ 1e-10 in each solve; torch's and XLA's f32
factorizations differ, so a step whose last Newton update is large (8x8
steps 1 and 2) differs by that much (measured 5.5e-10; ROADMAP queue 3).
With two refinement rounds on both sides the same steps agree to 1e-12.
"""
from functools import partial

import numpy as np
import pytest

import jax.numpy as jnp

import torch

from dolfinx_external_operator_tpu import (
    create_rectangle, functionspace, locate_dofs_geometrical, quadrature_element)
from dolfinx_external_operator_tpu.models.von_mises import (
    _return_mapping_kernel, pallas_batched_kernel)
from dolfinx_external_operator_tpu.ops import vonmises_pallas as vp
from dolfinx_external_operator_tpu.parallel.spmd import FusedPlasticityStep as StepJ

import dolfinx_external_operator_torch as pt
from dolfinx_external_operator_torch.convert import state_from_numpy
from dolfinx_external_operator_torch.parallel.spmd import FusedPlasticityStep as StepT

torch.set_num_threads(2)

LOADS = (200.0, 400.0, 600.0)
F32_TOLS = {"newton_rtol": 1e-5, "newton_atol": 1e-3}


def _jax_step(n, solver, f32=False):
    mesh = create_rectangle((0.0, 0.0), (1.2, 1.0), (n, n), "triangle")
    V = functionspace(mesh, ("Lagrange", 2, (2,)))
    S = functionspace(mesh, quadrature_element(mesh.cell_name(), degree=2, value_shape=(4,)))
    bottom = locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0))
    right = locate_dofs_geometrical(V, lambda x: np.isclose(x[0], 1.2))
    bc = np.concatenate([np.concatenate([s * 2, s * 2 + 1]) for s in (bottom, right)])
    vm = _return_mapping_kernel()

    def kernel(deps, sn):
        C, sig, _ = vm(deps, sn, jnp.zeros(()))
        return C, sig

    kw = dict(F32_TOLS, batched_kernel=pallas_batched_kernel()) if f32 else {}
    return StepJ(mesh, V, S, kernel, bc, linear_solver=solver, **kw)


def _schedule(fp, loads=LOADS, step=None):
    """(Du per step, sigma per step, Newton list, CG list) as numpy."""
    step = step or fp.run_step
    Du, sig = fp.zero_state()
    dus, sigs, its, cgs = [], [], [], []
    for load in loads:
        Du, sig, _, it, cg = step(Du, sig, load)
        dus.append(np.asarray(Du))
        sigs.append(np.asarray(sig))
        its.append(int(it))
        cgs.append(int(cg))
    return dus, sigs, its, cgs


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def jax_runs():
    orig = vp.pl.pallas_call
    vp.pl.pallas_call = partial(orig, interpret=True)
    try:
        runs = {}
        for name, solver, f32 in (("dense", "dense", False), ("cg", "cg", False),
                                  ("f32", "dense", True)):
            fp = _jax_step(8, solver, f32)
            runs[name] = (fp, _schedule(fp))
        return runs
    finally:
        vp.pl.pallas_call = orig


@pytest.fixture(scope="module")
def port_dense():
    fp = pt.von_mises_block_step(8, 8, "f64", device="cpu", linear_solver="dense")
    return fp, _schedule(fp)


def test_statics_bitwise(jax_runs, port_dense):
    fp_j = jax_runs["dense"][0]
    fp_t = port_dense[0]
    assert set(fp_t.statics) == set(fp_j.statics)
    for k, v in fp_j.statics.items():
        a, b = np.asarray(v), fp_t.statics[k].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_cg_newton_list_and_du_match_jax(jax_runs):
    _, (du_j, sig_j, its_j, cgs_j) = jax_runs["cg"]
    fp = pt.von_mises_block_step(8, 8, "f64", device="cpu", linear_solver="cg")
    du_t, sig_t, its_t, cgs_t = _schedule(fp)
    assert its_j == its_t == [1, 5, 7]
    for a, b in zip(du_t, du_j):
        assert _rel(a, b) < 1e-12
    for a, b in zip(sig_t, sig_j):
        assert _rel(a, b) < 1e-10
    # CG counts differ by summation order only (ROADMAP queue 3)
    assert all(abs(a - b) <= 0.01 * b + 3 for a, b in zip(cgs_t, cgs_j)), (cgs_t, cgs_j)


def test_dense_newton_list_and_du_match_jax(jax_runs, port_dense):
    _, (du_j, sig_j, its_j, _) = jax_runs["dense"]
    du_t, sig_t, its_t, _ = port_dense[1]
    assert its_j == its_t == [1, 5, 7]
    # one refinement round: the f32 factorizations' difference, ~1e-10
    for a, b in zip(du_t, du_j):
        assert _rel(a, b) < 1e-8
    # the last step ends on a small update, so its Du carries no such error
    assert _rel(du_t[-1], du_j[-1]) < 1e-12


def test_dense_two_refinement_rounds_match_jax():
    """With two f64 refinement rounds on both sides (the JAX step's own
    ``_dense_refine`` knob) the dense path agrees to 1e-12 on every step."""
    fp_j = _jax_step(8, "dense")
    fp_j._dense_refine = 2
    fp_j._step = fp_j._build_step()
    fp_t = pt.von_mises_block_step(8, 8, "f64", device="cpu", linear_solver="dense")
    fp_t._dense_refine = 2
    du_j, sig_j, its_j, _ = _schedule(fp_j)
    du_t, sig_t, its_t, _ = _schedule(fp_t)
    assert its_j == its_t == [1, 5, 7]
    for a, b in zip(du_t, du_j):
        assert _rel(a, b) < 1e-12
    for a, b in zip(sig_t, sig_j):
        assert _rel(a, b) < 1e-12


def test_f32_kernel_path_converges(jax_runs, port_dense):
    """The f32 return map (on the CPU: the plain version of the kernel)
    drives every step to convergence with the JAX Pallas path's Newton list,
    and Du within 1e-3 of the f64 path."""
    fp = pt.von_mises_block_step(8, 8, "f32", device="cpu", linear_solver="dense", **F32_TOLS)
    du, _, its, _ = _schedule(fp)
    its_j = jax_runs["f32"][1][2]
    assert its == its_j == [1, 5, 6]
    assert all(i < fp.newton_max_it for i in its)
    assert _rel(du[-1], port_dense[1][0][-1]) < 1e-3
    assert _rel(du[-1], jax_runs["f32"][1][0][-1]) < 1e-5


def test_schedule_equals_steps(port_dense):
    fp, (du, sig, its, cgs) = port_dense
    Du, sigma, norms, its_s, cgs_s = fp.run_schedule(LOADS)
    assert its_s.tolist() == its and cgs_s.tolist() == cgs
    assert torch.equal(Du, torch.as_tensor(du[-1])) and torch.equal(sigma, torch.as_tensor(sig[-1]))
    assert norms.shape == (3,) and bool(torch.isfinite(norms).all())


def test_host_driven_equals_fused(port_dense):
    fp, (du, sig, its, _) = port_dense
    du_h, sig_h, its_h, _ = _schedule(fp, step=fp.run_step_host)
    assert its_h == its
    for a, b in zip(du_h, du):
        assert _rel(a, b) < 1e-12
    for a, b in zip(sig_h, sig):
        assert _rel(a, b) < 1e-10


def test_two_runs_bitwise(port_dense):
    fp, (du, sig, its, _) = port_dense
    du2, sig2, its2, _ = _schedule(fp)
    assert its2 == its
    for a, b in zip(du2 + sig2, du + sig):
        assert np.array_equal(a, b)


def test_step_from_jax_state(jax_runs):
    """convert.py: the port continues a JAX run.  A JAX step's statics and
    its state after loads 200 and 400 go to the port, whose step at load
    600 equals the JAX step's."""
    fp_j, (du_j, sig_j, its_j, _) = jax_runs["dense"]
    statics = {k: np.asarray(v) for k, v in fp_j.statics.items()}
    fp_t = StepT.from_statics(statics, pt.batched_kernel_f64(), device="cpu",
                              linear_solver="dense")
    Du, sig = state_from_numpy(du_j[1], sig_j[1], device="cpu")
    Du, sig, _, it, _ = fp_t.run_step(Du, sig, LOADS[2])
    assert it == its_j[2]
    assert _rel(Du.numpy(), du_j[2]) < 1e-12
    assert _rel(sig.numpy(), sig_j[2]) < 1e-10


def test_auto_resolves_to_dense():
    fp = pt.von_mises_block_step(2, 2, "f64", device="cpu", linear_solver="auto")
    assert fp.linear_solver == "dense" and fp._dense_fact == "lu"


@pytest.mark.parametrize("solver", ["mg", "elastic"])
def test_block_solvers_match_dense(solver):
    """The preconditioned Krylov solvers on the 4x4 von Mises block: the
    dense step's Newton list, Du within 1e-10 (each solve runs to
    ``cg_rtol``)."""
    du_d, _, its_d, _ = _schedule(pt.von_mises_block_step(4, 4, "f64", device="cpu",
                                                          linear_solver="dense"))
    fp = pt.von_mises_block_step(4, 4, "f64", device="cpu", linear_solver=solver)
    du, _, its, inner = _schedule(fp)
    assert fp.linear_solver == solver
    assert its == its_d
    assert all(k > 0 for k in inner)
    for a, b in zip(du, du_d):
        assert _rel(a, b) < 1e-10


def test_default_device_is_cuda():
    """No entry point drops to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.von_mises_block_step(2, 2, "f64")


@pytest.mark.slow
def test_block_25x25_newton_list():
    """The main path's block at full size: the JAX package's [4, 5, 7]."""
    fp = pt.von_mises_block_step(25, 25, "f64", device="cpu", linear_solver="dense")
    _, _, its, _ = _schedule(fp)
    assert its == [4, 5, 7]
