"""The port's utilities against the JAX package's: ``utils.taylor``,
``utils.checkpoint``, ``utils.plots`` and ``utils.profiling``.

Mirrors ``tests/test_taylor.py`` and ``tests/test_checkpoint.py``:

- Taylor remainders on the 4x4 slope (the plain f64 return map), loaded
  into the plastic regime as the JAX test does: the same rate assertions
  in the elastic and the plastic state, and, from the JAX package's own
  state carried into the port (``x.array =``), r0 at the largest k within
  1e-10 relative of the JAX package's and r1 within 1e-10 of r0 (r1
  cancels r0 down to O(k^2), so r0's roundoff is both packages' floor;
  in the elastic state r1 is roundoff in both, below 1e-10 of r0);
- checkpoints: the round trip on a P1 vector space, a file saved by the
  JAX package loads into a port ``Function`` bit for bit and the reverse
  (the von Mises cylinder's P2 space), and a slope run resumed from a
  checkpoint after its first load step equals the uninterrupted run bit
  for bit.
"""
import numpy as np
import pytest
import torch

from dolfinx_external_operator_tpu import evaluate_external_operators as eval_ops_j
from dolfinx_external_operator_tpu import evaluate_operands as operands_j
import dolfinx_external_operator_tpu as fj
from dolfinx_external_operator_tpu.models.mohr_coulomb import build_slope_problem as build_j
from dolfinx_external_operator_tpu.utils.checkpoint import load_state as load_j
from dolfinx_external_operator_tpu.utils.checkpoint import save_state as save_j
from dolfinx_external_operator_tpu.utils.taylor import taylor_test as taylor_j

import dolfinx_external_operator_torch as pt
from dolfinx_external_operator_torch import evaluate_external_operators, evaluate_operands
from dolfinx_external_operator_torch.models.mohr_coulomb import build_slope_problem
from dolfinx_external_operator_torch.utils import plots, profiling
from dolfinx_external_operator_torch.utils.checkpoint import load_state, save_state
from dolfinx_external_operator_torch.utils.taylor import convergence_rates, taylor_test

torch.set_num_threads(2)

LOADS = (2.0, 8.0, 14.0)  # tests/test_taylor.py:32


def _refresh(P, ops=(evaluate_operands, evaluate_external_operators)):
    evaluate, external = ops

    def refresh():
        ((_, sigma_new),) = external(P["J_ops"], evaluate(P["F_ops"]))
        P["sigma"].ref_coefficient.x.array[:] = sigma_new
    return refresh


def _load(P, refresh, to_numpy):
    """tests/test_taylor.py:16-44: Du = 1e-8, then the loads; the elastic
    state is the first step's Du, the plastic one the last's with its
    committed stress."""
    Du, sigma = P["Du"], P["sigma"]
    Du.x.array[:] = np.full(P["V"].num_dofs, 1e-8)
    refresh()
    Du0_elastic = None
    for load in LOADS:
        P["q"].value = np.array([0.0, -load])
        P["problem"].solve()
        P["u"].x.axpy(1.0, Du.x)
        P["sigma_n"].x.array[:] = sigma.ref_coefficient.data
        if Du0_elastic is None:
            Du0_elastic = to_numpy(Du.data).copy()
    assert float(P["stats"]["max_f"]) > 1.0  # genuinely yielded final state
    return Du0_elastic, to_numpy(Du.data).copy(), to_numpy(P["sigma_n"].data).copy()


@pytest.fixture(scope="module")
def states():
    """The port's and the JAX package's problems, each loaded into its own
    elastic and plastic states."""
    Pt = build_slope_problem(4, 4, device="cpu", route="plain")
    Pj = build_j(Nx=4, Ny=4)
    rt, rj = _refresh(Pt), _refresh(Pj, (operands_j, eval_ops_j))
    return {"port": (Pt, rt, *_load(Pt, rt, lambda t: t.numpy())),
            "jax": (Pj, rj, *_load(Pj, rj, np.asarray))}


def _taylor(P, refresh, Du0, sigma_n0, taylor=taylor_test):
    P["Du"].x.array = Du0
    P["sigma_n"].x.array[:] = sigma_n0
    return taylor(P["Du"], P["F_replaced"], P["J_replaced"], refresh, P["bcs"])


def test_taylor_elastic(states):
    P, refresh, Du0_e, _, sigma_n0 = states["port"]
    k, r0, r1 = _taylor(P, refresh, Du0_e, np.zeros_like(sigma_n0))
    rate0 = convergence_rates(k, r0)
    assert 0.9 < rate0 < 1.1, (rate0, r0)
    # elastic: Jacobian is exact and constant -> r1 at machine precision
    assert r1.max() < 1e-10 * max(r0.max(), 1.0), (r0, r1)


def test_taylor_plastic(states):
    P, refresh, _, Du0_p, sigma_n0 = states["port"]
    k, r0, r1 = _taylor(P, refresh, Du0_p, sigma_n0)
    rate0 = convergence_rates(k, r0)
    rate1 = convergence_rates(k, r1, skip=1)
    assert 0.9 < rate0 < 1.1, (rate0, r0)
    assert rate1 > 1.8, (rate1, r1)


@pytest.mark.parametrize("state", ["elastic", "plastic"])
def test_taylor_remainders_match_jax_on_its_state(states, state):
    """Both packages' remainders from the JAX package's state: r0 (and, in
    the plastic state, r1) at the largest k within 1e-10 relative."""
    Pj, rj, Du0_e, Du0_p, sigma_n0 = states["jax"]
    Pt, rt = states["port"][:2]
    Du0, sn0 = (Du0_e, np.zeros_like(sigma_n0)) if state == "elastic" else (Du0_p, sigma_n0)
    _, r0_t, r1_t = _taylor(Pt, rt, Du0, sn0)
    _, r0_j, r1_j = _taylor(Pj, rj, Du0, sn0, taylor_j)
    assert abs(r0_t[-1] - r0_j[-1]) <= 1e-10 * abs(r0_j[-1]), (r0_t, r0_j)
    # r1 = r0 - k J du cancels r0 down to O(k^2): a roundoff of r0 is the
    # floor of both packages' r1, so the gap is held to r0's scale (on the
    # CPU the plastic state's r1 gap is 5.6e-14 of r0, 1.2e-9 of r1)
    assert abs(r1_t[-1] - r1_j[-1]) <= 1e-10 * abs(r0_j[-1]), (r1_t, r1_j)
    if state == "elastic":
        assert max(r1_t.max(), r1_j.max()) < 1e-10 * r0_j.max(), (r1_t, r1_j)


def test_save_load_roundtrip(tmp_path):
    """tests/test_checkpoint.py:10-23."""
    mesh = pt.create_unit_square(3, 3)
    V = pt.functionspace(mesh, ("Lagrange", 1, (2,)))
    u = pt.Function(V, device="cpu")
    u.x.array[:] = np.linspace(0, 1, V.num_dofs)
    p = np.arange(7.0)
    path = str(tmp_path / "state.npz")
    save_state(path, 5, u=u, p=p)

    u2 = pt.Function(V, device="cpu")
    step, extra = load_state(path, u=u2, p=None)
    assert step == 5
    assert torch.equal(u2.data, u.data)
    assert np.array_equal(extra["p"].numpy(), p)


def test_checkpoints_cross_packages(tmp_path):
    """A file the JAX package saves loads into a port Function bit for
    bit, and the reverse, on the cylinder's P2 space."""
    rng = np.random.default_rng(4)
    Vt = pt.functionspace(pt.build_cylinder_quarter(lc=0.5)[0], ("Lagrange", 2, (2,)))
    Vj = fj.functionspace(fj.build_cylinder_quarter(lc=0.5)[0], ("Lagrange", 2, (2,)))
    assert Vt.num_dofs == Vj.num_dofs
    a, b = rng.standard_normal(Vt.num_dofs), rng.standard_normal(7)

    uj = fj.Function(Vj)
    uj.x.array[:] = a
    save_j(str(tmp_path / "jax.npz"), 3, u=uj, p=b)
    ut = pt.Function(Vt, device="cpu")
    step, extra = load_state(str(tmp_path / "jax.npz"), u=ut, p=None)
    assert step == 3
    assert np.array_equal(ut.data.numpy(), a) and np.array_equal(extra["p"].numpy(), b)

    ut.x.array[:] = -a
    save_state(str(tmp_path / "port.npz"), 4, u=ut, p=torch.as_tensor(b))
    uj2 = fj.Function(Vj)
    step, extra = load_j(str(tmp_path / "port.npz"), u=uj2, p=None)
    assert step == 4
    assert np.array_equal(np.asarray(uj2.data), -a)
    assert np.array_equal(np.asarray(extra["p"]), b)


def _slope_steps(P, loads):
    """solve_slope_stability's step loop (without the probe) over ``loads``."""
    for load in loads:
        P["q"].value = load * np.array([0.0, -P["gamma"]])
        P["problem"].solve()
        P["u"].x.axpy(1.0, P["Du"].x)
        P["sigma_n"].x.array[:] = P["sigma"].ref_coefficient.data


def _slope_start():
    P = build_slope_problem(4, 4, device="cpu", route="plain")
    P["Du"].x.array[:] = np.ones(P["V"].num_dofs)
    P["constitutive_update"]()
    return P


def test_resumed_run_equals_uninterrupted(tmp_path):
    """The 4x4 slope over 3 loads, and the same resumed from a checkpoint
    of its state after the first load in a newly built problem: the same
    bits."""
    whole = _slope_start()
    _slope_steps(whole, LOADS)

    first = _slope_start()
    _slope_steps(first, LOADS[:1])
    path = str(tmp_path / "slope.npz")
    save_state(path, 1, Du=first["Du"], u=first["u"], sigma_n=first["sigma_n"])
    resumed = build_slope_problem(4, 4, device="cpu", route="plain")
    step, _ = load_state(path, Du=resumed["Du"], u=resumed["u"], sigma_n=resumed["sigma_n"])
    _slope_steps(resumed, LOADS[step:])
    for key in ("u", "Du", "sigma_n"):
        assert torch.equal(resumed[key].data, whole[key].data), key


def test_plots_and_step_stats(tmp_path):
    """The figures are written where matplotlib exists (None where it is
    missing); StepStats records and sums the steps."""
    P = _slope_start()
    out = plots.save_displacement_field(P["mesh"], P["Du"], str(tmp_path / "u.png"))
    curve = plots.save_load_displacement([("a", np.array([[0.0, 0.0], [1.0, 2.0]]))],
                                         str(tmp_path / "c.png"))
    for path in (out, curve):
        assert path is None or (tmp_path / path.split("/")[-1]).exists()
    stats = profiling.StepStats(device="cpu")
    for its in (2, 3):
        stats.start()
        stats.stop(newton_its=its)
    summary = stats.summary()
    assert summary["n_steps"] == 2 and summary["total_newton_its"] == 5
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(3).sum()
    assert (tmp_path / "trace" / "trace.json").exists()
