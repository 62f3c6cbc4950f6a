"""The port's von Mises return maps against the JAX package's.

* the plain f32 version (what a CPU tensor runs) against the Pallas kernel
  in interpret mode, with the tolerances of ``test_pallas_ops.py``;
* the CPU (g++) build of the CUDA kernel's own per-point body
  (``csrc/vonmises.cuh``) against the plain f32 version;
* the f64 batched map against the JAX package's vmapped kernel.

The CUDA kernel itself is tested on a card by ``test_torch_cuda.py``,
which imports no JAX."""
from functools import partial

import numpy as np
import pytest

import jax.numpy as jnp

import torch

from dolfinx_external_operator_tpu.models import von_mises as vm_j
from dolfinx_external_operator_tpu.ops import vonmises_pallas as vp

from dolfinx_external_operator_torch.models import von_mises as vm_t
from dolfinx_external_operator_torch.ops import vonmises as ops_t

torch.set_num_threads(2)

PARAMS = [vm_j.LAMBDA, vm_j.MU, vm_j.H_MOD, vm_j.SIGMA_0]


def _inputs(n, seed=3):
    """The strain/stress mix of test_pallas_ops.py (half the points
    plastic), point-major."""
    rng = np.random.default_rng(seed)
    deps = rng.normal(scale=2e-3, size=(n, 4))
    deps[: n // 2, 3] += 6e-3
    sig_n = rng.normal(scale=20.0, size=(n, 4))
    p = np.abs(rng.normal(scale=1e-3, size=n))
    return deps, sig_n, p


def _t32(deps, sig_n, p):
    return (torch.tensor(deps.T.copy(), dtype=torch.float32),
            torch.tensor(sig_n.T.copy(), dtype=torch.float32),
            torch.tensor(p, dtype=torch.float32))


def _errs(a, b):
    """(C relative to its max, sigma relative to max(|sigma|, 1), dp abs),
    the scalings of test_pallas_ops.py:46-49."""
    (Ca, sa, dpa), (Cb, sb, dpb) = ([np.asarray(x, dtype=np.float64) for x in t] for t in (a, b))
    return (np.abs(Ca - Cb).max() / np.abs(Cb).max(),
            np.abs(sa - sb).max() / max(np.abs(sb).max(), 1.0),
            np.abs(dpa - dpb).max())


@pytest.fixture
def interpret_pallas():
    orig = vp.pl.pallas_call
    vp.pl.pallas_call = partial(orig, interpret=True)
    try:
        yield
    finally:
        vp.pl.pallas_call = orig


@pytest.mark.parametrize("n", [512, 2048])
def test_plain_f32_matches_pallas(interpret_pallas, n):
    deps, sig_n, p = _inputs(n)
    ref = vp.vonmises_return_map_pallas(jnp.asarray(deps.T), jnp.asarray(sig_n.T),
                                        jnp.asarray(p), PARAMS, tile=512)
    out = ops_t.vonmises_return_map(*_t32(deps, sig_n, p), PARAMS)
    assert [tuple(x.shape) for x in out] == [(16, n), (4, n), (n,)]
    err_C, err_s, err_dp = _errs(out, ref)
    assert err_C < 1e-5 and err_s < 1e-5 and err_dp < 1e-7, (err_C, err_s, err_dp)


@pytest.mark.parametrize("n", [1, 1000, 4096])
def test_kernel_body_matches_plain(n):
    """The g++ build of vonmises.cuh: the kernel's arithmetic, checked on
    the CPU (ragged n: the body itself knows no tile)."""
    args = _t32(*_inputs(n, seed=n)) + (PARAMS,)
    body = ops_t.vonmises_return_map_host(*args)
    plain = ops_t.vonmises_return_map_reference(*args)
    err_C, err_s, err_dp = _errs(body, plain)
    assert err_C < 1e-6 and err_s < 1e-6 and err_dp < 1e-7, (err_C, err_s, err_dp)


def test_elastic_points_have_elastic_tangent():
    """Zero strain on zero stress: dp = 0, sigma = 0 and C = C_elas, in
    the kernel body and the plain version alike."""
    z = torch.zeros((4, 8), dtype=torch.float32)
    p = torch.zeros(8, dtype=torch.float32)
    C_el = torch.tensor(vm_t.C_ELAS, dtype=torch.float32).reshape(16, 1).expand(16, 8)
    for fn in (ops_t.vonmises_return_map_host, ops_t.vonmises_return_map_reference):
        C, sig, dp = fn(z, z, p, PARAMS)
        assert torch.equal(dp, p) and torch.equal(sig, z)
        assert torch.equal(C, C_el)


def test_f64_kernel_matches_vmapped():
    n = 1000
    deps, sig_n, p = _inputs(n, seed=11)
    C_j, s_j, dp_j = (np.asarray(x) for x in vm_j.VonMisesMaterial()(
        jnp.asarray(deps).ravel(), jnp.asarray(sig_n).ravel(), jnp.asarray(p)))
    C_t, s_t, dp_t = vm_t.return_mapping_kernel(
        torch.tensor(deps.T.copy(), dtype=torch.float64),
        torch.tensor(sig_n.T.copy(), dtype=torch.float64),
        torch.tensor(p, dtype=torch.float64))
    C_t = C_t.permute(2, 0, 1).numpy().reshape(-1)
    s_t = s_t.T.numpy().reshape(-1)
    assert np.abs(C_t - C_j).max() / np.abs(C_j).max() < 1e-12
    assert np.abs(s_t - s_j).max() / np.abs(s_j).max() < 1e-12
    assert np.abs(dp_t.numpy() - dp_j).max() / np.abs(dp_j).max() < 1e-12
    # the flat-array material wrapper is the same map
    C_m, s_m, dp_m = vm_t.VonMisesMaterial()(
        torch.tensor(deps).ravel(), torch.tensor(sig_n).ravel(), torch.tensor(p))
    assert np.array_equal(C_m.numpy(), C_t) and np.array_equal(s_m.numpy(), s_t)


def test_batched_f32_matches_pallas_batched(interpret_pallas):
    """The fused-step contract of the f32 kernel: pad to the tile, p = 0,
    cast back to the caller's dtype (n = 700 is not a tile multiple)."""
    n = 700
    deps, sig_n, _ = _inputs(n, seed=5)
    C_j, s_j = (np.asarray(x) for x in vm_j.pallas_batched_kernel(tile=512)(
        jnp.asarray(deps.T), jnp.asarray(sig_n.T)))
    C_t, s_t = vm_t.batched_kernel_f32(tile=512)(
        torch.tensor(deps.T.copy()), torch.tensor(sig_n.T.copy()))
    assert C_t.dtype == s_t.dtype == torch.float64
    assert tuple(C_t.shape) == (4, 4, n) and tuple(s_t.shape) == (4, n)
    err_C, err_s, _ = _errs((C_t, s_t, np.zeros(1)), (C_j, s_j, np.zeros(1)))
    assert err_C < 1e-5 and err_s < 1e-5


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity"])
def test_wrapper_rejects_bad_input(bad):
    deps, sig_n, p = _t32(*_inputs(64))
    if bad == "dtype":
        deps = deps.double()
    elif bad == "shape":
        p = p[:-1]
    else:
        deps = deps.T.contiguous().T
    with pytest.raises((TypeError, ValueError)):
        ops_t.vonmises_return_map(deps, sig_n, p, PARAMS)
