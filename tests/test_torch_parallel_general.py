"""Cell sharding of the port's general pipeline over gloo ranks on the CPU.

The counterparts of ``tests/test_parallel_general.py`` (the JAX package's
general pipeline GSPMD-sharded over the 8 virtual devices of
``tests/conftest.py``), with ``torch.distributed`` ranks
(``parallel.dist.spawn``, one process each) under
``parallel.set_default_device_mesh``, on 2 and 3 ranks:

- the heat pipeline's assembly on the 5x5 P2 mesh (50 cells: 3 ranks pad
  the cell batch, 2 ranks pad only facet groups) within 1e-14 of the port
  unsharded, with the operators' coefficients (bit for bit: a form gathers
  the ranks' per-cell contributions and sums them in the unsharded
  order);
- the statics of a compiled form hold the rank's rows (8x8, 128 cells);
- the heat Newton solve with CG: identical Newton counts, T within 1e-12;
- 3x3 P1 exterior facets, and a facet group of 2 on 3 ranks, where one
  rank holds only padded rows and still calls every collective;
- element-by-element Jacobi-PCG over the rank's element tensors;

each also against the JAX package sharded over 8 devices (the same inputs,
made with numpy from a seed, through ``convert.function_from_numpy``)
within 1e-12.  Added: GMRES and AMG-CG on the von Mises cylinder (lc=0.5,
3 increments) and the 4x4 slope through ``solve_slope_stability`` on 2
ranks, against one rank (the cylinder bit for bit: AMG's level-0 sums go
through ``dist.cell_sum``) and the slope against the JAX package; each
rank's callback sees half the Gauss points; ICNN hyperelasticity
(``run_comparison``, lc=0.12, 2 steps) on 2 ranks against one.  Every
collective is counted: only ``all_reduce`` (through ``dist.psum``: AMG's
level-0 sums, by ``dist.cell_sum``) and ``all_gather`` (through
``dist.all_gather``) are called.  One rank gives the unsharded bits.

All cases of a rank count run in one spawn
(``_torch_general_shard_worker.suite``); the JAX runs happen in the test
process meanwhile.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import dolfinx_external_operator_tpu as fj
from dolfinx_external_operator_tpu import parallel as parallel_j
from dolfinx_external_operator_tpu import solvers as solvers_j
from dolfinx_external_operator_tpu.models.mohr_coulomb import solve_slope_stability as slope_j

import dolfinx_external_operator_torch as pt
from dolfinx_external_operator_torch.parallel import dist
import _torch_general_shard_worker as worker

jax.config.update("jax_enable_x64", True)

LOADS_4 = np.linspace(2, 14, 3)


def _inputs():
    """The seeded dof values the cases start from."""
    rng = np.random.default_rng(9)
    n5 = pt.functionspace(pt.create_unit_square(5, 5), ("Lagrange", 2)).num_dofs
    n8 = pt.functionspace(pt.create_unit_square(8, 8), ("Lagrange", 2)).num_dofs
    n3 = pt.functionspace(pt.create_unit_square(3, 3), ("Lagrange", 1)).num_dofs
    return {"T0": 1.0 + 0.2 * rng.standard_normal(n5), "T8": 1.0 + 0.2 * rng.standard_normal(n8),
            "u0": rng.standard_normal(n3)}


def _cases(n, x):
    cases = {"assembly": {"kind": "assembly", "T0": x["T0"]},
             "full_solve": {"kind": "full_solve", "T0": x["T0"]},
             "slope": {"kind": "slope", "N": 4, "loads": LOADS_4}}
    if n == 1:
        return cases
    cases.update({"statics": {"kind": "statics", "T0": x["T8"]},
                  "facets": {"kind": "facets", "u0": x["u0"]},
                  "few_facets": {"kind": "facets", "u0": x["u0"], "few": True},
                  "krylov": {"kind": "krylov"}})
    if n == 2:
        cases.update({
            "gmres": {"kind": "cylinder", "lc": 0.5, "steps": 3, "opts": {"ksp_type": "gmres"}},
            "mg": {"kind": "cylinder", "lc": 0.5, "steps": 3,
                   "opts": {"ksp_type": "cg", "pc_type": "mg"}},
            "hyperelasticity": {"kind": "hyperelasticity", "lc": 0.12, "steps": 2}})
    else:
        cases.pop("slope")
    return cases


# ----------------------------------------------------------------------
# the JAX package, sharded over 8 virtual devices
# ----------------------------------------------------------------------

def _heat_j(T0, n=5):
    mesh = fj.create_unit_square(n, n)
    V = fj.functionspace(mesh, ("Lagrange", 2))
    T = fj.Function(V)
    T.x.array[:] = T0
    Q = fj.functionspace(mesh, fj.quadrature_element(mesh.cell_name(), degree=4))
    dx = fj.Measure("dx", metadata={"quadrature_degree": 4, "quadrature_scheme": "default"})
    k = fj.FEMExternalOperator(T, function_space=Q)
    k.external_function = lambda d: {
        (0,): lambda t: (1.0 / (1.0 + jnp.asarray(t))).reshape(-1),
        (1,): lambda t: (-1.0 / (1.0 + jnp.asarray(t)) ** 2).reshape(-1),
    }[d]
    v, uh = fj.TestFunction(V), fj.TrialFunction(V)
    F = fj.inner(k * fj.grad(T), fj.grad(v)) * dx
    return V, T, F, fj.derivative(F, T, uh)


def _jax_runs(x):
    out = {}
    _, _, F, J = _heat_j(x["T0"])
    F_r, F_ops = fj.replace_external_operators(F)
    J_r, J_ops = fj.replace_external_operators(J)
    ops = fj.evaluate_operands(F_ops)
    fj.evaluate_external_operators(F_ops, ops)
    fj.evaluate_external_operators(J_ops, ops)
    out["assembly"] = {"b": np.asarray(fj.assemble_vector(F_r)),
                       "A": np.asarray(fj.assemble_matrix(J_r)),
                       "coeffs": {op.derivatives: np.asarray(op.ref_coefficient.data)
                                  for op in F_ops + J_ops}}

    V, T, F, J = _heat_j(x["T0"])
    F_r, F_ops = fj.replace_external_operators(F)
    J_r, J_ops = fj.replace_external_operators(J)

    def callback():
        o = fj.evaluate_operands(F_ops)
        fj.evaluate_external_operators(F_ops, o)
        fj.evaluate_external_operators(J_ops, o)

    bdofs = fj.locate_dofs_geometrical(V, lambda X: np.isclose(X[0], 0) | np.isclose(X[0], 1))
    T.interpolate(lambda X: 0.02 + 0.0 * X[0])
    prob = solvers_j.NonlinearProblem(F_r, T, J_r, bcs=[fj.DirichletBC(bdofs, np.zeros(len(bdofs)))],
                                      petsc_options={"ksp_type": "cg"}, external_callback=callback)
    its, _ = prob.solve()
    out["full_solve"] = {"its": its, "T": np.asarray(T.data)}

    for name, few in (("facets", False), ("few_facets", True)):
        mesh = fj.create_unit_square(3, 3)
        V = fj.functionspace(mesh, ("Lagrange", 1))
        u = fj.Function(V)
        u.x.array[:] = x["u0"]
        out[name] = {"b": np.asarray(fj.assemble_vector(u * fj.TestFunction(V)
                                                        * worker.facet_measure(fj, mesh, few)))}

    mesh = fj.create_unit_square(5, 5)
    V = fj.functionspace(mesh, ("Lagrange", 1))
    u = fj.Function(V)
    v, uh = fj.TestFunction(V), fj.TrialFunction(V)
    dx = fj.Measure("dx", metadata={"quadrature_degree": 2, "quadrature_scheme": "default"})
    F = fj.inner(fj.grad(u), fj.grad(v)) * dx - 1.0 * v * dx
    bd = fj.locate_dofs_geometrical(V, lambda X: np.isclose(X[0], 0) | np.isclose(X[0], 1))
    solvers_j.NonlinearProblem(F, u, fj.derivative(F, u, uh),
                               bcs=[fj.DirichletBC(bd, np.zeros(len(bd)))],
                               petsc_options={"ksp_type": "cg"}).solve()
    out["krylov"] = {"u": np.asarray(u.data)}
    return out


@pytest.fixture(scope="module")
def runs():
    """{rank count: [each rank's results by case]} on 1, 2 and 3 gloo
    ranks (the three spawns at once), and the JAX package's runs over 8
    virtual devices (the slope unsharded), made in this process
    meanwhile."""
    assert len(jax.devices()) >= 8, "conftest must force 8 virtual cpu devices"
    x = _inputs()
    with ThreadPoolExecutor(3) as ex:
        spawns = {n: ex.submit(dist.spawn, worker.suite, n, "gloo", "cpu", _cases(n, x))
                  for n in (1, 2, 3)}
        parallel_j.set_default_device_mesh(parallel_j.make_device_mesh(8))
        try:
            jax_runs = _jax_runs(x)
        finally:
            parallel_j.set_default_device_mesh(None)
        jax_runs["slope"] = {"newton": slope_j(4, 4, LOADS_4)["iterations"]}
        jax_runs["slope"]["u"] = None
        return {n: f.result() for n, f in spawns.items()}, jax_runs


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs[1]


def _unsharded(ranks, n, case):
    return ranks[n][0][case]["unsharded"]


def _diff(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("n", [2, 3])
def test_assembly_parity_sharded_vs_single(ranks, jax_runs, n):
    one, ref = _unsharded(ranks, n, "assembly"), jax_runs["assembly"]
    for res in ranks[n]:
        run = res["assembly"]
        assert run["local_rows"] == -(-50 // n)
        for key in ("b", "A"):
            assert _diff(run[key], one[key]) <= 1e-14, key
            assert _diff(run[key], ref[key]) <= 1e-12, key
            assert np.array_equal(run[key], one[key]), key  # the unsharded bits
        for d in one["coeffs"]:
            assert _diff(run["coeffs"][d], one["coeffs"][d]) <= 1e-14, d
            assert _diff(run["coeffs"][d], ref["coeffs"][d]) <= 1e-12, d
            assert np.array_equal(run["coeffs"][d], one["coeffs"][d]), d


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_statics_actually_sharded(ranks, n):
    """Each rank's statics hold its block of the padded cell batch: 8x8 has
    128 cells, 3 ranks take 43 rows each, the last one's final row a
    repeat of row 0."""
    k = -(-128 // n)
    for res in ranks[n]:
        run = res["statics"]
        assert run["nc"] == k
        rows = np.arange(run["rank"] * k, (run["rank"] + 1) * k)
        rows[rows >= 128] = 0
        assert np.array_equal(run["test_dofs"], run["all_test_dofs"][rows])
        # parallel.pad_shard_cells: 5 rows padded by row 0, the rank's block
        k5 = -(-5 // n)
        rows = np.arange(run["rank"] * k5, (run["rank"] + 1) * k5)
        rows[rows >= 5] = 0
        assert np.array_equal(run["pad_shard"], np.arange(10.0).reshape(5, 2)[rows])


@pytest.mark.parametrize("n", [2, 3])
def test_full_solve_parity_sharded_vs_single(ranks, jax_runs, n):
    one, ref = _unsharded(ranks, n, "full_solve"), jax_runs["full_solve"]
    for res in ranks[n]:
        run = res["full_solve"]
        assert run["its"] == one["its"] == ref["its"]
        assert _diff(run["T"], one["T"]) <= 1e-12
        assert _diff(run["T"], ref["T"]) <= 1e-12
        assert np.array_equal(run["T"], one["T"])


@pytest.mark.parametrize("case", ["facets", "few_facets"])
@pytest.mark.parametrize("n", [2, 3])
def test_facet_assembly_sharded(ranks, jax_runs, n, case):
    """Exterior-facet groups of 6 and 3 facets, and a group of 2 (on 3
    ranks one rank holds only padded rows and still calls the psum)."""
    one, ref = _unsharded(ranks, n, case), jax_runs[case]
    for res in ranks[n]:
        run = res[case]
        assert _diff(run["b"], one["b"]) <= 1e-14
        assert _diff(run["b"], ref["b"]) <= 1e-12
        assert np.array_equal(run["b"], one["b"])
        assert (run["psum_calls"], run["gather_calls"]) == (0, 1)
    if case == "few_facets":
        assert max(one["batch_sizes"]) < 3


@pytest.mark.parametrize("n", [2, 3])
def test_krylov_sharded(ranks, jax_runs, n):
    """EBE Jacobi-PCG over the rank's element tensors."""
    one, ref = _unsharded(ranks, n, "krylov"), jax_runs["krylov"]
    for res in ranks[n]:
        run = res["krylov"]
        assert run["its"] == one["its"]
        assert _diff(run["u"], one["u"]) <= 1e-12
        assert _diff(run["u"], ref["u"]) <= 1e-12
        assert np.array_equal(run["u"], one["u"])
        assert run["gather_calls"] > run["ksp"]  # one gather in each matvec


@pytest.mark.parametrize("case", ["gmres", "mg"])
def test_cylinder_krylov_two_ranks(ranks, case):
    """The von Mises cylinder with GMRES and with AMG-CG on 2 ranks: one
    rank's bits.  AMG's level-0 sums all-reduce every cell's contributions
    (``dist.cell_sum``: each rank's beside exact zeros) and sum them in
    the unsharded order, so the Newton list, the inner counts, u and the
    probes are one rank's; the bounds the test held before (inner counts
    within 2x a step + 10, u and the probes within 1e-8 of u's largest
    entry) are kept beside them."""
    one = _unsharded(ranks, 2, case)
    assert sum(one["newton"]) > len(one["newton"])  # the plastic step is reached
    for res in ranks[2]:
        run = res[case]
        assert run["newton"] == one["newton"]
        assert run["inner"] == one["inner"]
        for k, k1 in zip(run["inner"], one["inner"]):
            assert k <= 2 * k1 + 10 and k1 <= 2 * k + 10, (run["inner"], one["inner"])
        scale = np.abs(one["u"]).max()
        assert _diff(run["u"], one["u"]) <= 1e-8 * scale
        assert _diff(run["results"], one["results"]) <= 1e-8 * scale
        assert np.array_equal(run["u"], one["u"])
        assert np.array_equal(run["results"], one["results"])


def test_slope_two_ranks(ranks, jax_runs):
    """The 4x4 slope through ``solve_slope_stability`` on 2 ranks: the
    Newton list of one rank and of the JAX package, u within 1e-12 of one
    rank's, and each rank's callback saw its 48 of the 96 Gauss points."""
    one = _unsharded(ranks, 2, "slope")
    assert one["points"] == [96]
    for res in ranks[2]:
        run = res["slope"]
        assert run["newton"] == one["newton"] == jax_runs["slope"]["newton"]
        # not bitwise: the plain map's vectorized CPU loops take a point on
        # their vector lanes or on their scalar tail by its position in the
        # batch, which halving the batch moves (2e-19 apart on the CPU)
        assert _diff(run["u"], one["u"]) <= 1e-12 * np.abs(one["u"]).max()
        assert run["points"] == [48] and run["calls"] == one["calls"]


def test_hyperelasticity_two_ranks(ranks):
    """``run_comparison`` (the ICNN callback on each rank's points, and the
    Isihara twin) on 2 ranks: one rank's Newton lists, u and errors."""
    one = _unsharded(ranks, 2, "hyperelasticity")
    for res in ranks[2]:
        run = res["hyperelasticity"]
        assert run["newton"] == one["newton"]
        assert _diff(run["u"], one["u"]) <= 1e-12 * np.abs(one["u"]).max()
        assert abs(run["rel_linf"] - one["rel_linf"]) <= 1e-10 * one["rel_linf"]
        assert abs(run["l2"] - one["l2"]) <= 1e-10 * one["l2"]


def test_one_rank_is_the_unsharded_pipeline_bitwise(ranks):
    """With one rank the collectives are identities and the rank's rows are
    every row: the unsharded bits."""
    for case, run in ranks[1][0].items():
        ref = run["unsharded"]
        for key in ("b", "A", "T", "u", "newton", "its"):
            if key in ref:
                assert np.array_equal(run[key], ref[key]), (case, key)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_only_psum_and_all_gather(ranks, n):
    """No other collective was called (each raises in the ranks), every
    all_reduce went through dist.psum and every all_gather through
    dist.all_gather: the heat assembly makes one psum each for b and A and
    one gather for each of its three operators' results."""
    for res in ranks[n]:
        for case, run in res.items():
            assert run["all_reduce_calls"] == run["psum_calls"], case
            assert run["all_gather_calls"] == run["gather_calls"], case
        assert (res["assembly"]["psum_calls"], res["assembly"]["gather_calls"]) == (0, 5)
