"""The port's Mohr-Coulomb material against the JAX package's.

* the Abbo-Sloan surface (value, gradient, Hessian) in f32 and f64 on the
  Lode-range states of ``test_abbo_sloan.py``;
* ``solve_small`` on random 5x5 systems;
* the plain f64 return map and tangent (what a CPU tensor runs) on the
  bench strain mix (``bench.py:77-83``), unsorted and in sorted chunks;
* the CPU (g++) build of the CUDA kernel's own body
  (``csrc/mohr_coulomb.cuh``) against the plain version, on the bench mix
  and on all-elastic, all-plastic and ragged inputs, and with each
  point's roles run forward and in reverse (the same bits: no role reads
  what another writes, which on the card would be a race in a tile);
* the material properties of ``test_mohr_coulomb.py`` on the port.

The return map's f32 phase uses each library's f32 asin/sin/cos (PyTorch's,
XLA's, the C library's), which differ in the last bits.  The f64 polish
stops at a residual of 1e-8 relative to the lane's scale, so a lane whose
last polish step lands just under that tolerance keeps an f32-sized trace of
its start: on the bench mix a handful of such lanes differ by up to ~2e-8
relative in C (~2e-10 in sigma), every other lane within 1e-10, and every
lane takes the same number of iterations (ROADMAP queue 3).  The tests
assert those measured bounds and counts.

The CUDA kernel itself is tested on a card by ``test_torch_cuda.py``,
which imports no JAX."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from dolfinx_external_operator_tpu.models.mohr_coulomb import MohrCoulombMaterial as MatJ
from dolfinx_external_operator_tpu.models.mohr_coulomb import solve_small as solve_small_j
from dolfinx_external_operator_tpu.ops.abbo_sloan import make_surface as make_surface_j

from dolfinx_external_operator_torch.convert import MOHR_COULOMB_PARAMS, mohr_coulomb_from_params
from dolfinx_external_operator_torch.models.mohr_coulomb import MohrCoulombMaterial as MatT
from dolfinx_external_operator_torch.models.mohr_coulomb import solve_small as solve_small_t
from dolfinx_external_operator_torch.ops import mohr_coulomb as ops_t
from dolfinx_external_operator_torch.ops.abbo_sloan import make_surface as make_surface_t

from test_abbo_sloan import A_COEF, C_, PHI, THETA_T, lode_states

torch.set_num_threads(2)

N_MIX = 2000
# measured on the bench mix (module docstring); C relative to max |C|,
# sigma relative to max |sigma|, per lane
GAP_C, GAP_SIG, GAP_LANES = 1e-7, 1e-9, 20


def _bench_mix(n, seed=0):
    """bench.py:77-83: compressive normal strains, half the points sheared
    past yield, zero initial stress; point-major."""
    rng = np.random.default_rng(seed)
    deps = rng.normal(scale=1e-3, size=(n, 4))
    deps[:, :3] -= 1.5e-3
    deps[: n // 2, 3] += 6e-3
    return deps, np.zeros((n, 4))


def _soa(a):
    return torch.tensor(np.ascontiguousarray(a.T), dtype=torch.float64)


def _lane_gaps(a, b, width):
    """Per-lane largest gap of flat point-major arrays, relative to max |b|."""
    a, b = np.asarray(a).reshape(-1, width), np.asarray(b).reshape(-1, width)
    return np.abs(a - b).max(axis=1) / np.abs(b).max()


@pytest.fixture(scope="module")
def mats():
    return MatJ(), MatT()


@pytest.fixture(scope="module")
def mix(mats):
    """The bench mix through the JAX package, the plain port and the
    kernel body: (JAX (C, sig, niter), port outputs, body outputs)."""
    mj, mt = mats
    deps, sn = _bench_mix(N_MIX)
    Cj, sj, stj = mj.tangent_and_stress(jnp.asarray(deps).ravel(), jnp.asarray(sn).ravel())
    jax_out = (np.asarray(Cj), np.asarray(sj), np.asarray(stj["niter"]))
    d, s = _soa(deps), _soa(sn)
    plain = ops_t.mc_return_map(d, s, mt)
    body = ops_t.mc_return_map_host(d, s, mt)
    return jax_out, plain, body


# -- the surface ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("angle", [PHI, 20 * np.pi / 180])
def test_surface_matches_jax(dtype, angle):
    """terms and hess against make_surface: f64 within 1e-12, f32 within
    1e-5, relative to each output's largest entry."""
    tol = 1e-12 if dtype == "float64" else 1e-5
    states = lode_states()
    terms_j, hess_j = make_surface_j(C_, angle, A_COEF, THETA_T, getattr(jnp, dtype))
    terms_t, hess_t = make_surface_t(C_, angle, A_COEF, THETA_T, getattr(torch, dtype))
    sj = jnp.asarray(states, dtype=getattr(jnp, dtype))
    f_j, df_j = (np.asarray(x) for x in jax.jit(jax.vmap(terms_j))(sj))
    H_j = np.asarray(jax.jit(jax.vmap(hess_j))(sj))
    st = torch.tensor(states.T.copy(), dtype=getattr(torch, dtype))
    f_t, df_t = terms_t(st)
    H_t = hess_t(st)
    assert f_t.dtype == df_t.dtype == H_t.dtype == getattr(torch, dtype)
    for a, b in ((f_t.numpy(), f_j), (df_t.numpy().T, df_j), (H_t.permute(2, 0, 1).numpy(), H_j)):
        b = b.astype(np.float64)
        assert np.abs(a - b).max() / np.abs(b).max() < tol


def test_surface_batch_shapes():
    """Any trailing batch shape; the hydrostatic axis stays finite."""
    terms, hess = make_surface_t(C_, PHI, A_COEF, THETA_T, torch.float64)
    sig = torch.tensor(lode_states()[:12].T.copy()).reshape(4, 3, 4)
    f, df = terms(sig)
    assert f.shape == (3, 4) and df.shape == (4, 3, 4) and hess(sig).shape == (4, 4, 3, 4)
    zero = torch.zeros((4, 1), dtype=torch.float64)
    assert all(bool(torch.isfinite(t).all()) for t in (*terms(zero), hess(zero)))
    with pytest.raises(TypeError):
        terms(sig.float())


# -- solve_small ---------------------------------------------------------------

@pytest.mark.parametrize("rhs", ["one", "four", "zero_pivot"])
def test_solve_small_matches_jax(rhs):
    rng = np.random.default_rng(42)
    n = 16
    A = rng.standard_normal((n, 5, 5))
    if rhs == "zero_pivot":
        A[:, 0, 0] = 0.0  # the first step must swap
    b = rng.standard_normal((n, 5) if rhs != "four" else (n, 5, 4))
    x_j = np.stack([np.asarray(solve_small_j(jnp.asarray(A[i]), jnp.asarray(b[i])))
                    for i in range(n)])
    x_t = solve_small_t(torch.tensor(np.moveaxis(A, 0, -1).copy()),
                        torch.tensor(np.moveaxis(b, 0, -1).copy())).numpy()
    x_t = np.moveaxis(x_t, -1, 0)
    assert x_t.shape == x_j.shape
    assert np.abs(x_t - x_j).max() / np.abs(x_j).max() < 1e-13
    res = np.einsum("nij,nj...->ni...", A, x_t) - b
    assert np.abs(res).max() < 1e-12


# -- the return map on the bench mix -------------------------------------------

def test_plain_matches_jax_on_bench_mix(mix):
    (C_j, s_j, it_j), plain, _ = mix
    C, sig, niter, yielding, norm_res, dlambda = plain
    n = N_MIX
    assert (C.shape, sig.shape, niter.shape) == ((16, n), (4, n), (n,))
    assert niter.dtype == torch.int32 and yielding.dtype == torch.float64
    C_flat = C.T.numpy().ravel()
    s_flat = sig.T.numpy().ravel()
    gap_C, gap_s = _lane_gaps(C_flat, C_j, 16), _lane_gaps(s_flat, s_j, 4)
    assert np.array_equal(niter.numpy(), it_j)
    assert 900 < int((it_j > 0).sum()) < 1100  # about half the lanes plastic
    assert gap_C.max() < GAP_C and gap_s.max() < GAP_SIG
    assert int((gap_C > 1e-10).sum()) <= GAP_LANES and int((gap_s > 1e-10).sum()) <= GAP_LANES
    assert float(norm_res.max()) < 1e-6 and bool(torch.isfinite(dlambda).all())


def test_kernel_body_matches_plain(mix):
    """The g++ build of mohr_coulomb.cuh against the plain version: equal
    per-lane iteration counts, C and sigma within the same bounds."""
    _, plain, body = mix
    assert np.array_equal(body[2].numpy(), plain[2].numpy())
    gap_C = _lane_gaps(body[0].T.numpy(), plain[0].T.numpy(), 16)
    gap_s = _lane_gaps(body[1].T.numpy(), plain[1].T.numpy(), 4)
    assert gap_C.max() < GAP_C and gap_s.max() < GAP_SIG
    assert int((gap_C > 1e-10).sum()) <= GAP_LANES and int((gap_s > 1e-10).sum()) <= GAP_LANES
    # the trial yield value is f64 throughout: equal but for the last bits
    # of the triple-angle Newton's f32 seed
    assert np.abs(body[3].numpy() - plain[3].numpy()).max() < 1e-13
    assert np.abs(body[5].numpy() - plain[5].numpy()).max() < 1e-12


def _edge_input(case):
    """Point-major (deps, sigma_n) of a kernel edge case."""
    if case == "all_elastic":
        rng = np.random.default_rng(5)
        return rng.normal(scale=1e-5, size=(64, 4)), np.zeros((64, 4))
    if case == "elastic_iterating":
        # a tiny strain on a large compressive stress: elastic, but the f32
        # start residual (rounding of sigma_n) exceeds tol32 * |C deps|
        rng = np.random.default_rng(9)
        sn = rng.normal(scale=5.0, size=(64, 4))
        sn[:, :3] -= 100.0
        return rng.normal(scale=1e-6, size=(64, 4)), sn
    if case == "all_plastic":
        deps, sn = _bench_mix(256, seed=6)
        deps[:, 3] += 1.2e-2
        return deps, sn
    n = int(case[1:])  # ragged: n points, the first sheared past yield
    deps, sn = _bench_mix(n, seed=7)
    deps[0, 3] += 6e-3
    return deps, sn


@pytest.mark.parametrize("case", ["all_elastic", "elastic_iterating", "all_plastic", "n1",
                                  "n33"])
def test_kernel_body_edge_inputs(mats, case):
    """The g++ build against the plain version where pass A finishes every
    lane, where pass B takes every lane (plastic, or elastic lanes that
    take Newton steps), and at ragged sizes: equal iteration counts, C and
    sigma within the bench mix's bounds."""
    _, mt = mats
    deps, sn = _edge_input(case)
    d, s = _soa(deps), _soa(sn)
    plain = ops_t.mc_return_map(d, s, mt)
    body = ops_t.mc_return_map_host(d, s, mt)
    plastic = plain[3] > 0.0
    if case in ("all_elastic", "elastic_iterating"):
        assert not bool(plastic.any())
        assert np.array_equal(body[0].numpy(), np.repeat(mt.C_elas.reshape(16, 1), 64, axis=1))
        assert bool((plain[2] > 0).all()) == (case == "elastic_iterating")
    elif case == "all_plastic":
        assert bool(plastic.all())
    else:
        assert bool(plastic[0])
    assert torch.equal(body[3] > 0.0, plastic)
    assert np.array_equal(body[2].numpy(), plain[2].numpy())
    gap_C = _lane_gaps(body[0].T.numpy(), plain[0].T.numpy(), 16)
    gap_s = _lane_gaps(body[1].T.numpy(), plain[1].T.numpy(), 4)
    assert gap_C.max() < GAP_C and gap_s.max() < GAP_SIG
    assert int((gap_C > 1e-10).sum()) <= GAP_LANES and int((gap_s > 1e-10).sum()) <= GAP_LANES
    assert np.abs(body[3].numpy() - plain[3].numpy()).max() < 1e-13
    assert np.abs(body[5].numpy() - plain[5].numpy()).max() < 1e-12
    assert bool(torch.isfinite(body[4]).all()) and float(body[4].max()) < 1e-6


@pytest.mark.parametrize("psi_deg", [30, 20])
def test_kernel_body_role_order(psi_deg):
    """Each point's roles forward and in reverse give the same bits, on
    the bench mix with associative flow (4 Jacobian roles) and without
    (a fifth role evaluates the yield surface's gradient)."""
    mt = MatT(psi=psi_deg * np.pi / 180)
    d, s = (_soa(a) for a in _bench_mix(512, seed=8))
    fwd = ops_t.mc_return_map_host(d, s, mt)
    rev = ops_t.mc_return_map_host(d, s, mt, reverse=True)
    assert int((fwd[2] > 0).sum()) > 200
    for a, b in zip(fwd, rev):
        assert torch.equal(a, b)


def test_sorted_chunks_match_jax_and_unsorted(mats):
    """tangent_and_stress_sorted(chunk=256) against the JAX package's, and
    bitwise equal to the port's unsorted map (lanes are independent)."""
    mj, mt = mats
    n = 1500
    deps, sn = _bench_mix(n, seed=0)
    C_j, s_j, st_j = mj.tangent_and_stress_sorted(
        jnp.asarray(deps).ravel(), jnp.asarray(sn).ravel(), chunk=256)
    args = (torch.tensor(deps).ravel(), torch.tensor(sn).ravel())
    C_s, s_s, st_s = mt.tangent_and_stress_sorted(*args, chunk=256)
    C_u, s_u, st_u = mt.tangent_and_stress(*args)
    assert np.array_equal(st_s["niter"].numpy(), np.asarray(st_j["niter"]))
    assert _lane_gaps(C_s.numpy(), np.asarray(C_j), 16).max() < GAP_C
    assert _lane_gaps(s_s.numpy(), np.asarray(s_j), 4).max() < GAP_SIG
    assert torch.equal(C_s, C_u) and torch.equal(s_s, s_u)
    assert torch.equal(st_s["niter"], st_u["niter"])


def test_sorted_elastic_shortcut_bitwise(mats):
    """The whole-chunk elastic shortcut gives exactly C_elas and exactly the
    trial stress, bitwise equal to the full map's elastic branch."""
    _, mt = mats
    n = 512
    rng = np.random.default_rng(3)
    deps = rng.normal(scale=1e-5, size=(n, 4))
    sn = np.zeros((n, 4))
    args = (torch.tensor(deps).ravel(), torch.tensor(sn).ravel())
    C2, s2, st2 = mt.tangent_and_stress_sorted(*args, chunk=256)
    C2 = C2.numpy().reshape(n, 4, 4)
    s2 = s2.numpy().reshape(n, 4)
    assert np.all(C2 == mt.C_elas[None, :, :])
    assert np.abs(s2 - deps @ mt.C_elas.T).max() < 1e-14
    assert int(st2["niter"].max()) == 0
    C1, s1, _ = mt.tangent_and_stress(*args)
    assert np.array_equal(C1.numpy().reshape(n, 4, 4), C2)
    assert np.array_equal(s1.numpy().reshape(n, 4), s2)


def test_stress_only_and_batched_routes(mats):
    _, mt = mats
    deps, sn = _bench_mix(64, seed=1)
    d, s = _soa(deps), _soa(sn)
    C_p, s_p = mt.batched_kernel("plain")(d, s)
    C_c, s_c = mt.batched_kernel("cuda")(d, s)  # a CPU tensor: the plain version
    assert C_p.shape == (4, 4, 64) and torch.equal(C_p, C_c) and torch.equal(s_p, s_c)
    C_k, s_k = mt.batched_kernel_sorted(chunk=32)(d, s)
    assert torch.equal(C_k, C_p) and torch.equal(s_k, s_p)
    assert torch.equal(mt.stress_only(torch.tensor(deps).ravel(), torch.tensor(sn).ravel()),
                       s_p.T.reshape(-1))
    with pytest.raises(ValueError):
        mt.batched_kernel("triton")


# -- material properties (test_mohr_coulomb.py:26-83, :98-140) -----------------

def _one(mt, impl, deps, sn=None):
    d = torch.tensor(np.asarray(deps, dtype=np.float64).reshape(4, 1))
    s = torch.zeros((4, 1), dtype=torch.float64) if sn is None else sn
    fn = ops_t.mc_return_map if impl == "plain" else ops_t.mc_return_map_host
    C, sig, niter, *_ = fn(d, s, mt)
    return C.numpy().reshape(4, 4), sig.numpy().ravel(), int(niter[0])


@pytest.mark.parametrize("impl", ["plain", "body"])
@pytest.mark.parametrize("prop", ["elastic_linear", "plastic_on_surface", "tangent_fd",
                                  "zero_strain", "associative_symmetric"])
def test_material_properties(mats, impl, prop):
    _, mt = mats
    if prop == "elastic_linear":
        deps = np.array([1e-5, -2e-5, 0.0, 5e-6])
        Ct, sig, it = _one(mt, impl, deps)
        assert np.allclose(sig, mt.C_elas @ deps, atol=1e-12)
        assert np.allclose(Ct, mt.C_elas, atol=1e-8) and it == 0
    elif prop == "plastic_on_surface":
        deps = np.array([0.0, 0.0, 0.0, 1e-2])
        f_pred = float(mt.f_yield(torch.tensor(mt.C_elas @ deps).reshape(4, 1))[0])
        assert f_pred > 1.0
        _, sig, it = _one(mt, impl, deps)
        assert abs(float(mt.f_yield(torch.tensor(sig).reshape(4, 1))[0])) < 1e-6
        assert 0 < it <= 200
    elif prop == "tangent_fd":
        deps0 = np.array([0.0, 0.0, 0.0, 1e-2])
        Ct, _, _ = _one(mt, impl, deps0)
        eps = 1e-7
        Ct_fd = np.zeros((4, 4))
        for j in range(4):
            dp, dm = deps0.copy(), deps0.copy()
            dp[j] += eps
            dm[j] -= eps
            Ct_fd[:, j] = (_one(mt, impl, dp)[1] - _one(mt, impl, dm)[1]) / (2 * eps)
        assert np.abs(Ct - Ct_fd).max() / np.abs(Ct_fd).max() < 1e-8
    elif prop == "zero_strain":
        Ct, sig, _ = _one(mt, impl, np.zeros(4))
        assert not np.isnan(Ct).any() and not np.isnan(sig).any()
    else:  # phi == psi: the consistent tangent is symmetric
        Ct, _, _ = _one(mt, impl, np.array([1e-3, -4e-3, 0.0, 6e-3]))
        assert np.abs(Ct - Ct.T).max() / np.abs(Ct).max() < 1e-9


# -- constants, converter, wrapper ---------------------------------------------

def test_constants_carried_from_jax(mats):
    """convert.mohr_coulomb_from_params: the JAX material's 12 constants
    give the port's material, with the same derived constants and yield
    values."""
    mj, _ = mats
    mj = MatJ(phi=32 * np.pi / 180, psi=25 * np.pi / 180, tol32=2e-5)
    mt = mohr_coulomb_from_params({k: getattr(mj, k) for k in MOHR_COULOMB_PARAMS},
                                  device="cpu")
    assert np.array_equal(mt.C_elas, mj.C_elas) and mt.a == mj.a
    assert mt.a_g == float(mj.a * np.tan(mj.phi) / np.tan(mj.psi))
    assert (mt.n_polish_max, mt.tol32_eff, mt.max_iter32_eff) == (60, 2e-5, 40)
    states = lode_states()
    f_j = np.asarray(jax.vmap(mj.f_yield)(jnp.asarray(states)))
    g_j = np.asarray(jax.vmap(mj.g_pot)(jnp.asarray(states)))
    st = torch.tensor(states.T.copy())
    assert np.abs(mt.f_yield(st).numpy() - f_j).max() < 1e-12
    assert np.abs(mt.g_pot(st).numpy() - g_j).max() < 1e-12
    p = mt.kernel_params()
    assert p[-1] == 0.0 and MatT().kernel_params()[-1] == 1.0  # non-associative here
    with pytest.raises(KeyError):
        mohr_coulomb_from_params({"E": 1.0}, device="cpu")


def test_non_associative_body_matches_plain():
    """With psi != phi the kernel body evaluates both surfaces."""
    mt = MatT(psi=20 * np.pi / 180)
    deps, sn = _bench_mix(256, seed=4)
    d, s = _soa(deps), _soa(sn)
    plain = ops_t.mc_return_map(d, s, mt)
    body = ops_t.mc_return_map_host(d, s, mt)
    assert np.array_equal(body[2].numpy(), plain[2].numpy())
    assert _lane_gaps(body[0].T.numpy(), plain[0].T.numpy(), 16).max() < GAP_C
    assert _lane_gaps(body[1].T.numpy(), plain[1].T.numpy(), 4).max() < GAP_SIG


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity"])
def test_wrapper_rejects_bad_input(mats, bad):
    _, mt = mats
    deps, sn = (_soa(a) for a in _bench_mix(64))
    if bad == "dtype":
        deps = deps.float()
    elif bad == "shape":
        sn = sn[:, :-1]
    else:
        deps = deps.T.contiguous().T
    for fn in (ops_t.mc_return_map, ops_t.mc_return_map_host):
        with pytest.raises((TypeError, ValueError)):
            fn(deps, sn, mt)
