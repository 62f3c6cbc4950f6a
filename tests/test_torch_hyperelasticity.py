"""The ICNN hyperelasticity model through the port against the JAX package
(the port of ``test_hyperelasticity.py``).

The port's ``ICNN`` (an ``nn.Module`` of f64 parameters, the tangent by
``torch.func``) holds the JAX ICNN's stress P and tangent dP/dF within
1e-12 relative on 256 seeded deformation gradients near I, with the same
parameters carried over by ``convert.icnn_from_numpy``; its reference
state is stress-free and its tangent matches central differences.  The
external-operator solve and the Isihara twin at lc=0.12 over 2 steps give
the JAX package's Newton lists and displacements within 1e-10.  The
``slow`` test runs ``docs/records/hyperelasticity_lc005_100steps.json``.
"""
import filecmp
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dolfinx_external_operator_tpu.models import hyperelasticity as he_j
from dolfinx_external_operator_tpu.models import icnn as icnn_j

from dolfinx_external_operator_torch import convert
from dolfinx_external_operator_torch.models import hyperelasticity as he_t
from dolfinx_external_operator_torch.models import icnn as icnn_t

torch.set_num_threads(2)

RECORD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs",
                      "records", "hyperelasticity_lc005_100steps.json")


@pytest.fixture(scope="module")
def nets():
    weights = icnn_j.load_isihara_weights()
    return icnn_j.ICNN(weights), convert.icnn_from_numpy(weights, device="cpu")


def test_weights_are_a_copy_of_the_jax_packages():
    """The port reads its own checkpoint, byte for byte the JAX package's,
    into the same arrays and state-dict keys."""
    assert os.path.dirname(icnn_t.DEFAULT_WEIGHTS_PATH) != os.path.dirname(icnn_j.DEFAULT_WEIGHTS_PATH)
    assert filecmp.cmp(icnn_t.DEFAULT_WEIGHTS_PATH, icnn_j.DEFAULT_WEIGHTS_PATH, shallow=False)
    wt, wj = icnn_t.load_isihara_weights(), icnn_j.load_isihara_weights()
    assert sorted(wt) == sorted(wj) and all(np.array_equal(wt[k], wj[k]) for k in wj)
    net = icnn_t.ICNN(device="cpu")
    assert sorted(net.state_dict()) == sorted(wj)
    assert all(v.dtype == torch.float64 for v in net.state_dict().values())


def test_icnn_stress_free_reference(nets):
    _, net = nets
    dP, P = net.stress_and_tangent(torch.tensor([1.0, 0.0, 0.0, 1.0], dtype=torch.float64))
    assert float(P.abs().max()) < 1e-12
    # the tangent at I is symmetric positive semi-definite: the rotation
    # mode has zero stiffness at the stress-free state
    C = dP.reshape(4, 4).numpy()
    assert np.abs(C - C.T).max() < 1e-8
    assert np.linalg.eigvalsh(0.5 * (C + C.T)).min() > -1e-10


def test_icnn_tangent_matches_fd(nets):
    _, net = nets
    F0 = np.array([1.08, 0.03, -0.02, 0.95])
    dP, _ = net.stress_and_tangent(torch.tensor(F0))
    dP = dP.reshape(4, 4).numpy()
    eps = 1e-6
    fd = np.zeros((4, 4))
    for j in range(4):
        fp, fm = F0.copy(), F0.copy()
        fp[j] += eps
        fm[j] -= eps
        fd[:, j] = (net.stress_and_tangent(torch.tensor(fp))[1]
                    - net.stress_and_tangent(torch.tensor(fm))[1]).numpy() / (2 * eps)
    assert np.abs(dP - fd).max() / np.abs(fd).max() < 1e-7


def test_icnn_matches_jax(nets):
    """P and dP/dF on 256 seeded deformation gradients near I within 1e-12
    of the largest entry of the JAX ICNN's."""
    net_j, net_t = nets
    F = np.array([1.0, 0.0, 0.0, 1.0]) + 0.05 * np.random.default_rng(7).standard_normal((256, 4))
    dP_t, P_t = net_t.stress_and_tangent(torch.tensor(F))
    dP_j, P_j = (np.asarray(a) for a in net_j.stress_and_tangent(jnp.asarray(F)))
    assert np.abs(P_t.numpy() - P_j).max() <= 1e-12 * np.abs(P_j).max()
    assert np.abs(dP_t.numpy() - dP_j).max() <= 1e-12 * np.abs(dP_j).max()


@pytest.fixture(scope="module")
def comparisons():
    kw = {"lc": 0.12, "n_steps": 2, "max_displacement": 0.1}
    return he_t.run_comparison(device="cpu", **kw), he_j.run_comparison(**kw)


@pytest.mark.parametrize("model", ["nn", "isihara"])
def test_solve_matches_jax(comparisons, model):
    """The ICNN external-operator solve and the Isihara twin: every step
    converged, the JAX package's Newton lists, u within 1e-10."""
    port, ref = comparisons
    assert port[model]["iterations"] == ref[model]["iterations"]
    u, u_j = port[model]["u"].data.numpy(), np.asarray(ref[model]["u"].data)
    assert np.abs(u - u_j).max() < 1e-10


def test_errors_match_jax(comparisons):
    """The NN-against-twin errors at the trained model's level (the ICNN
    learned noisy Isihara data), and within 1e-8 relative of the JAX
    package's."""
    port, ref = comparisons
    for key in ("rel_linf", "l2"):
        assert abs(port[key] - ref[key]) <= 1e-8 * ref[key]
    assert port["rel_linf"] < 0.02 and port["l2"] < 2e-3


@pytest.mark.slow
def test_record_lc005_100_steps():
    """The record's run: 2,926 dofs, 100 steps to 0.5, Newton totals 200
    and 200, ``rel_linf`` and ``l2`` within 1e-6 relative of the record's."""
    with open(RECORD) as f:
        rec = json.load(f)
    out = he_t.run_comparison(lc=0.05, n_steps=100, max_displacement=0.5, device="cpu")
    assert out["nn"]["V"].num_dofs == rec["config"]["dofs"]
    assert sum(out["nn"]["iterations"]) == rec["newton_total_nn"]
    assert sum(out["isihara"]["iterations"]) == rec["newton_total_isihara"]
    for key in ("rel_linf", "l2"):
        assert abs(out[key] - rec[key]) <= 1e-6 * rec[key], (key, out[key], rec[key])
