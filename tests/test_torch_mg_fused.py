"""AMG-CG's fused f32 iteration (``ops/mg_cycle.py``) on the CPU.

* A Chebyshev call through the kernels' bodies built with g++
  (``mg._chebyshev_fused`` with ``chebyshev_step_host``) against the torch
  chain (``mg._chebyshev_reference``), bit for bit, with a zero and a
  given start, at the lc = 0.02 cylinder's level sizes (11,222, 2,912 and
  558 dofs) and coefficients from ``_cheb_coeffs`` on a seeded lambda max.
* A batch of f32 PCG iterations through the two PCG bodies
  (``_pcg_iterations_fused`` with ``pcg_xr_host`` and ``pcg_p_host``)
  against ``_pcg_iterations_reference``, bit for bit (NaN where NaN), on
  every branch: an SPD system (better true, and false where the best
  norm lies below the first iterations'), ``pAp`` negative,
  zero and NaN, ``rz`` zero and NaN, and the norm at or past 100 times the
  best.
* The cylinder at lc = 0.3 over three load steps with cg + mg, every
  cycle and PCG batch through the bodies: the torch chains' Newton list,
  PCG iterations and ``Du``, bit for bit.
* The bodies updating their vectors in place give the bits of an update
  into fresh buffers, and PCG (b) at length 0 still writes its scalars.
* ``_chebyshev``, ``_pcg_iterations`` and ``ir_pcg`` on CPU tensors run
  the torch chains and count no launch, ``ir_pcg`` with and without
  ``graphs`` giving the bits of a read every iteration; the launchers
  refuse CPU tensors and malformed operands.

The card's kernels against the torch chains on the same CUDA tensors are
in ``tests/test_torch_cuda.py``.  This file imports no JAX.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dolfinx_external_operator_torch.models import von_mises as vm
from dolfinx_external_operator_torch.ops import mg_cycle as mgc
from dolfinx_external_operator_torch.parallel import mg
from dolfinx_external_operator_torch.utils import profiling
from test_torch_cylinder_problem import _ir_pcg_read_each_iteration

F32 = torch.float32
# the lc = 0.02 cylinder's smoothed levels: 0 (element-blocked), 1 and 2 (dense)
LEVELS = (11222, 2912, 558)


def same_bits(a, b):
    """Equal bit for bit where not NaN, NaN at the same places."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def _operator(n, seed):
    """An SPD f32 operator x -> A x (a shifted 1D Laplacian and a low-rank
    part), a Jacobi inverse diagonal and a right-hand side, from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    Q = torch.randn((n, 6), generator=gen, dtype=F32) / n ** 0.5
    diag = 2.5 + torch.rand(n, generator=gen, dtype=F32)

    def mv(x):
        lap = diag * x - F.pad(x[1:], (0, 1)) - F.pad(x[:-1], (1, 0))
        return lap + Q @ (Q.T @ x)

    dinv = 1.0 / (diag + (Q * Q).sum(1))
    return mv, dinv, torch.randn(n, generator=gen, dtype=F32)


@pytest.mark.parametrize("start", ["zero", "given"])
@pytest.mark.parametrize("n", LEVELS)
def test_chebyshev_bodies_are_the_torch_chain(n, start):
    mv, dinv, b = _operator(n, seed=n)
    lmax = torch.tensor(np.random.default_rng(n).uniform(1.5, 4.0), dtype=F32)
    coeffs = mg._cheb_coeffs(lmax, 3)
    x0 = None if start == "zero" else torch.randn(n, generator=torch.Generator().manual_seed(1))
    ref = mg._chebyshev_reference(mv, dinv, b, x0, coeffs)
    b_in, x0_in = b.clone(), None if x0 is None else x0.clone()
    new = mg._chebyshev_fused(mv, dinv, b, x0, coeffs, mgc.chebyshev_step_host)
    assert same_bits(new, ref)
    assert torch.equal(b, b_in) and (x0 is None or torch.equal(x0, x0_in))  # only read


@pytest.mark.parametrize("degree", [1, 2, 5])
def test_chebyshev_bodies_at_other_degrees(degree):
    mv, dinv, b = _operator(558, seed=degree)
    coeffs = mg._cheb_coeffs(torch.tensor(3.1, dtype=F32), degree)
    for x0 in (None, b.flip(0)):
        ref = mg._chebyshev_reference(mv, dinv, b, x0, coeffs)
        assert same_bits(mg._chebyshev_fused(mv, dinv, b, x0, coeffs,
                                             mgc.chebyshev_step_host), ref)


def _pcg_case(case, n=558):
    """(mv32, M32, state) of one PCG branch."""
    mv, dinv, b = _operator(n, seed=7)
    M32 = lambda r: dinv * r  # noqa: E731
    z = M32(b)
    rz, nb = torch.dot(b, z), torch.linalg.vector_norm(b)
    x = torch.zeros_like(b)
    if case == "pAp_negative":
        mv = lambda p: -p  # noqa: E731
    elif case == "pAp_zero":
        mv = lambda p: 0.0 * p  # noqa: E731
    elif case == "pAp_nan":
        mv = lambda p: torch.full_like(p, float("nan"))  # noqa: E731
    elif case == "rz_zero":
        rz = torch.zeros((), dtype=F32)
    elif case == "rz_nan":
        rz = torch.tensor(float("nan"), dtype=F32)
    elif case == "not_better":  # the best norm below the first iterations', good all along
        nb = 0.03 * nb
    elif case == "diverged":  # the norm at or past 100 x the best: not good, not better
        nb = torch.tensor(1e-30, dtype=F32)
    elif case == "restart":  # a state from iterations before: x, xb and p nonzero
        x = 1e-3 * b.flip(0)
        z = z + 1e-2 * b.roll(3)
    state = {"x": x, "r": b, "p": z, "rz": rz, "nb": nb, "xb": x}
    return mv, M32, state


PCG_CASES = ["spd", "not_better", "restart", "pAp_negative", "pAp_zero", "pAp_nan", "rz_zero",
             "rz_nan", "diverged"]


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("case", PCG_CASES)
def test_pcg_bodies_are_the_torch_chain(case, batch):
    mv, M32, state = _pcg_case(case)
    held = {k: v.clone() for k, v in state.items()}
    s_ref, t_ref, xb_ref = mg._pcg_iterations_reference(mv, M32, state, batch)
    s_new, t_new, xb_new = mg._pcg_iterations_fused(mv, M32, state, batch, mgc.pcg_xr_host,
                                                    mgc.pcg_p_host)
    assert same_bits(t_new, t_ref) and same_bits(xb_new, xb_ref)
    for k in s_ref:
        assert same_bits(s_new[k], s_ref[k].reshape(s_new[k].shape)), k
    assert all(same_bits(state[k], held[k]) for k in state)  # only read
    if case == "not_better" and batch == 8:  # both sides of better, all good
        assert set(t_ref[:, 2].tolist()) == {0.0, 1.0} and t_ref[:, 0].min() == 1.0
    if case not in ("spd", "not_better", "restart"):
        assert t_ref[0, 0] == 0.0


def _cylinder_steps(bodies, monkeypatch):
    """Three steps of the lc = 0.3 cylinder with cg + mg (an elastic one,
    two plastic), the cycle's Chebyshev calls and the PCG's batches
    through the g++ bodies where ``bodies``: Newton list, PCG iterations,
    Du, and the calls that took the bodies."""
    calls = []

    def counted(fn, *kernels):
        return lambda *a: calls.append(fn.__name__) or fn(*a, *kernels)

    if bodies:
        monkeypatch.setattr(mg, "_chebyshev", counted(mg._chebyshev_fused,
                                                      mgc.chebyshev_step_host))
        monkeypatch.setattr(mg, "_pcg_iterations", counted(
            mg._pcg_iterations_fused, mgc.pcg_xr_host, mgc.pcg_p_host))
    P = vm.build_cylinder_problem(0.3, snes_opts={"ksp_type": "cg", "pc_type": "mg"},
                                  device="cpu")
    its = []
    for load in (0.5, 0.8, 0.95):
        P["loading"].value = load * P["q_lim"]
        P["Du"].x.array[:] = torch.full_like(P["Du"].data, np.finfo(np.float64).eps)
        its.append(P["problem"].solve()[0])
        P["p"].x.axpy(1.0, P["dp"].x)
        P["sigma_n"].x.array[:] = P["sigma"].ref_coefficient.data
    monkeypatch.undo()
    return its, P["problem"].solver.ksp_iterations, P["Du"].data.clone(), set(calls)


def test_cylinder_steps_through_the_bodies_keep_the_bits(monkeypatch):
    its, inner, du, _ = _cylinder_steps(False, monkeypatch)
    its_b, inner_b, du_b, calls = _cylinder_steps(True, monkeypatch)
    assert calls == {"_chebyshev_fused", "_pcg_iterations_fused"}
    assert its_b == its and its[2] > 1 and inner_b == inner > 0
    assert torch.equal(du_b, du)


@pytest.mark.parametrize("case", ["chebyshev_step", "pcg_xr", "pcg_p_empty"])
def test_bodies_in_place_and_at_length_zero(case):
    """Each vector a launch both reads and writes (r, x and d of a
    Chebyshev step; x and r of PCG (a)) given as one buffer gives the bits
    of the launch into fresh buffers; PCG (b) with no dofs still writes
    the best norm and the test row."""
    mv, dinv, b = _operator(558, seed=11)
    gen = torch.Generator().manual_seed(12)
    r, av, d, x = (torch.randn(558, generator=gen, dtype=F32) for _ in range(4))
    c0, c1 = torch.tensor(0.7, dtype=F32), torch.tensor(0.4, dtype=F32)
    if case == "chebyshev_step":
        fresh = [torch.empty_like(r) for _ in range(2)]
        d_fresh = d.clone()
        mgc.chebyshev_step_host(2, dinv, r, av, x, fresh[0], d_fresh, fresh[1], c0, c1)
        mgc.chebyshev_step_host(2, dinv, r, av, x, r, d, x, c0, c1)
        assert same_bits(r, fresh[0]) and same_bits(d, d_fresh) and same_bits(x, fresh[1])
    elif case == "pcg_xr":
        fresh = [torch.empty_like(r) for _ in range(2)]
        mgc.pcg_xr_host(c0, c1, x, r, d, av, *fresh)
        mgc.pcg_xr_host(c0, c1, x, r, d, av, x, r)
        assert same_bits(x, fresh[0]) and same_bits(r, fresh[1])
    else:
        e = torch.empty(0, dtype=F32)
        nb_out, test = torch.full((), -1.0, dtype=F32), torch.full((3,), -1.0, dtype=F32)
        nn, nb = torch.tensor(0.5, dtype=F32), torch.tensor(2.0, dtype=F32)
        mgc.pcg_p_host(c0, c1, c1, nn, nb, e, e, e, e, e, e, nb_out, test)
        assert nb_out.item() == 0.5 and test.tolist() == [1.0, 0.5, 1.0]


def test_cpu_tensors_take_the_torch_chains_and_count_nothing():
    mgc.reset_launches()
    profiling.reset_counters()
    mv, dinv, b = _operator(300, seed=2)
    coeffs = mg._cheb_coeffs(torch.tensor(2.0, dtype=F32), 3)
    assert same_bits(mg._chebyshev(mv, dinv, b, b, coeffs),
                     mg._chebyshev_reference(mv, dinv, b, b, coeffs))
    mv_, M32, state = _pcg_case("spd", 300)
    for got, want in zip(mg._pcg_iterations(mv_, M32, state, 4),
                         mg._pcg_iterations_reference(mv_, M32, state, 4)):
        if isinstance(got, dict):
            assert all(same_bits(got[k], want[k]) for k in got)
        else:
            assert same_bits(got, want)
    args = (lambda v: mv(v.float()).double(), mv, lambda r: dinv * r, b.double(), 1e-10, 500)
    x_ref, k_ref = _ir_pcg_read_each_iteration(*args)
    for graphs in (None, {}):
        x, k = mg.ir_pcg(*args, graphs=graphs)
        assert k == k_ref > 0 and same_bits(x, x_ref)
    counted = profiling.counters()
    assert all(counted[f"launches.{name}"] == 0
               for name in ("chebyshev_step", "pcg_xr", "pcg_p"))
    assert counted["solve.inner"] > 0


def test_launchers_refuse_what_the_kernels_do_not_take():
    n = 16
    v = [torch.zeros(n, dtype=F32) for _ in range(6)]
    one = torch.ones((), dtype=F32)
    with pytest.raises(ValueError, match="CUDA"):
        mgc.chebyshev_step(0, v[0], v[1], None, None, None, v[2], v[3], one)
    with pytest.raises(ValueError, match="CUDA"):
        mgc.pcg_xr(one, one, *v)
    with pytest.raises(TypeError, match="float32"):
        mgc.chebyshev_step_host(0, v[0].double(), v[1], None, None, None, v[2], v[3], one)
    with pytest.raises(ValueError, match="shape"):
        mgc.pcg_xr_host(one, one, v[0], v[1], v[2], torch.zeros(n + 1), v[4], v[5])
    with pytest.raises(ValueError, match="mode 1"):
        mgc.chebyshev_step_host(1, v[0], v[1], None, None, None, v[2], v[3], one)
    with pytest.raises(ValueError, match="contiguous"):
        mgc.pcg_xr_host(one, one, v[0], v[1], torch.zeros(2 * n)[::2], v[3], v[4], v[5])
    nb, test = torch.ones((), dtype=F32), torch.zeros(3, dtype=F32)
    with pytest.raises(ValueError, match="nb_out"):
        mgc.pcg_p_host(one, one, one, one, nb, *v, nb, test)
