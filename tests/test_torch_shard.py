"""Cell sharding of the port's fused step over gloo ranks on the CPU.

The counterparts of the JAX package's sharded tests, with ``torch.
distributed`` ranks (``parallel.dist.spawn``, one process each) in place of
``shard_map`` over the virtual devices of ``tests/conftest.py``:

- ``tests/test_parallel.py:58``: the 4x4 slope with CG over
  ``linspace(2, 14, 3)`` on 2 and 3 ranks, against one rank and against
  the JAX package sharded over 3 devices (Du within 1e-12, equal Newton
  lists);
- ``tests/test_mg.py:190`` and ``:394``: AMG-CG at 12x12 and in dia mode
  at 8x8, on 2 and 3 ranks against one; node mode too;
- every case on 2 and 3 ranks gives one rank's bits: Du at every step,
  sigma (the ranks' slices in rank order), the residual norms, the Newton
  and inner lists (each scatter all-reduces every cell's contributions,
  each rank's beside exact zeros, and sums them in the unsharded order);
- every solver at 8x8 (dense, elastic, BCR, AMG-CG in dia and node mode)
  on 2 and 3 ranks against the JAX package's step sharded over 3 devices:
  equal Newton lists, Du within 1e-10, Krylov inner counts within
  ``max(10, 0.4 n)``;
- ``tests/test_multichip_scaling.py:48``: at 8x8 on 1, 2 and 3 ranks, equal
  Newton and inner lists (the JAX band, inner counts within ``max(10, 0.4
  n1)``, held too), sigma of shape ``(nc_pad / n, nq, 4)`` per rank;
  ``:78``: the ranks call ``all_reduce`` and no other collective (the
  others raise), every call through ``dist.psum``, and CG's count per
  Newton pass is exact;
- the rest of the step: dense, elastic and BCR, ``fused_forcing`` and
  ``run_step_host``; ``from_statics`` on a sharded JAX step's statics (its
  cells padded for 3 devices, re-padded for 2 ranks), with the AMG and
  BCR sub-statics; ``dryrun_multichip(2)``;
- repeatability: one rank is bitwise equal to ``device_mesh=None``, two
  runs on 2 ranks are bitwise equal, and every rank reports the same
  residual norms bit for bit.

All ranks of a rank count run in one spawn (``_torch_shard_worker.suite``).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax

from dolfinx_external_operator_tpu.parallel.spmd import FusedPlasticityStep as StepJ
from dolfinx_external_operator_tpu.parallel.spmd import make_device_mesh as mesh_j

from dolfinx_external_operator_torch import convert
from dolfinx_external_operator_torch.entry import dryrun_multichip, entry
from dolfinx_external_operator_torch.parallel import dist
import _torch_shard_worker as worker
from test_torch_bcr import _jax_slope

jax.config.update("jax_enable_x64", True)

CG_LOADS = [float(x) for x in np.linspace(2, 14, 3)]  # tests/test_parallel.py:42
LOADS_8 = [2.0, 6.0]                                   # tests/test_mg.py:398
LOADS_12 = [2.0, 8.0, 14.0]                            # tests/test_mg.py:195


# the JAX package's steps sharded over 3 devices at 8x8, by the port's case
# they are held against: (linear_solver, options)
JAX_8 = {"dense8": ("dense", {}), "elastic8": ("elastic", {}), "bcr8": ("bcr", {}),
         "dia8": ("mg", {"mg_opts": {"mv0_mode": "dia"}}),
         "node8": ("mg", {"mg_opts": {"mv0_mode": "node"}})}


def _jax_statics(fp):
    return {k: np.asarray(v) for k, v in fp.statics.items() if k not in ("mg", "bcr")}


def _jax_mesh_statics():
    """The JAX steps whose statics the ``from_statics`` cases take: the
    4x4 CG and 8x8 AMG steps sharded over 3 devices (cells padded for 3;
    the AMG hierarchy with them) and the 8x8 BCR map of a single-device
    step.  Returns (the sharded steps by case, the statics by kind)."""
    cg4 = StepJ(*_jax_slope(4), device_mesh=mesh_j(3))
    mg3 = StepJ(*_jax_slope(8), linear_solver="mg", device_mesh=mesh_j(3), **JAX_8["dia8"][1])
    mg_statics = _jax_statics(mg3)
    mg_statics["mg"] = convert.mg_statics_from_numpy(
        mg3.statics["mg"], dia0_offsets=mg3._mg_dia_offsets, dia1_offsets=mg3._mg_dia1_offsets,
        t0_stencil=mg3._mg_t0_stencil, lat_shapes=mg3._mg_lat_shapes,
        cheb_degree=mg3._mg_cheb_degree, gamma_coarse=mg3._mg_gamma, mv0_mode=mg3._mg_mv0_mode)
    bcr1 = StepJ(*_jax_slope(8), linear_solver="bcr")
    bcr_statics = _jax_statics(bcr1)
    bcr_statics["bcr"] = convert.bcr_statics_from_numpy(bcr1.statics["bcr"], bcr1._bcr_plan)
    return {"cg4": cg4, "dia8": mg3}, {"cg": _jax_statics(cg4), "mesh8": _jax_statics(mg3),
                                       "mg": mg_statics, "bcr": bcr_statics}


def _jax_run(fp, loads):
    """A JAX step over ``loads`` from the zero state: Du after each step,
    the Newton list and inner counts."""
    Du, sig = fp.zero_state()
    dus, its, inner = [], [], []
    for load in loads:
        Du, sig, _, it, k = fp.run_step(Du, sig, load)
        dus.append(np.asarray(Du))
        its.append(int(it))
        inner.append(int(k))
    return {"du": dus, "newton": its, "inner": inner, "nc_pad": fp.nc_pad}


# the cases every rank count runs
CASES = ("cg4", "dia8", "host8", "mg12", "node8", "forcing8", "dense8", "elastic8", "bcr8")


def _cases(n, statics=None):
    """The cases each rank count runs (``_torch_shard_worker.suite``);
    2 ranks also run ``from_statics`` on the JAX steps' ``statics``."""
    dia = {"mg_opts": {"mv0_mode": "dia"}}
    cases = {
        "cg4": {"N": 4, "solver": "cg", "loads": CG_LOADS},
        "dia8": {"N": 8, "solver": "mg", "loads": LOADS_8, "opts": dia},
        "host8": {"N": 8, "solver": "mg", "loads": LOADS_8, "opts": dia, "host": True},
        "mg12": {"N": 12, "solver": "mg", "loads": LOADS_12},
        "node8": {"N": 8, "solver": "mg", "loads": LOADS_8,
                  "opts": {"mg_opts": {"mv0_mode": "node"}}},
        "forcing8": {"N": 8, "solver": "mg", "loads": LOADS_8, "opts": {"fused_forcing": True}},
        **{f"{s}8": {"N": 8, "solver": s, "loads": LOADS_8} for s in ("dense", "elastic", "bcr")},
    }
    if n == 1:
        for name in ("dia8", "node8", "dense8", "elastic8", "bcr8"):
            cases[name]["unsharded"] = True
    if n == 2:
        cases["dia8"]["repeat"] = True
        cases.update({
            "cg4_jax": {"statics": statics["cg"], "solver": "cg", "loads": CG_LOADS},
            "elastic8_jax": {"statics": statics["mesh8"], "solver": "elastic", "loads": LOADS_8},
            "mg8_jax": {"statics": statics["mg"], "solver": "mg", "loads": LOADS_8},
            "bcr8_jax": {"statics": statics["bcr"], "solver": "bcr", "loads": LOADS_8},
        })
    return cases


@pytest.fixture(scope="module")
def runs():
    """The port's ranks, {rank count: [each rank's results by case]} on 1,
    2 and 3 gloo ranks (the three spawns at once; 2 ranks start once the
    JAX statics they take are built), and, run in this process meanwhile,
    the JAX package's steps sharded over 3 devices over the same loads:
    the 4x4 slope with CG and the 8x8 slope with every other solver
    (``JAX_8``), by case."""
    assert len(jax.devices()) >= 3, "conftest must force 8 virtual cpu devices"
    with ThreadPoolExecutor(3) as ex:
        spawns = {n: ex.submit(dist.spawn, worker.suite, n, "gloo", "cpu", _cases(n))
                  for n in (1, 3)}
        steps, statics = _jax_mesh_statics()
        spawns[2] = ex.submit(dist.spawn, worker.suite, 2, "gloo", "cpu", _cases(2, statics))
        for case, (solver, opts) in JAX_8.items():
            if case not in steps:
                steps[case] = StepJ(*_jax_slope(8), linear_solver=solver, device_mesh=mesh_j(3),
                                    **opts)
        jax_runs = {case: _jax_run(fp, CG_LOADS if case == "cg4" else LOADS_8)
                    for case, fp in steps.items()}
        return {n: spawns[n].result() for n in (1, 2, 3)}, jax_runs


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs[1]


def _max_diff(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


@pytest.mark.parametrize("n", [2, 3])
def test_cg_4x4_matches_one_rank_and_jax(ranks, jax_runs, n):
    one, ref = ranks[1][0]["cg4"], jax_runs["cg4"]
    for res in ranks[n]:
        run = res["cg4"]
        assert run["newton"] == one["newton"] == ref["newton"]
        assert all(np.array_equal(a, b) for a, b in zip(run["du"], one["du"]))
        assert _max_diff(run["du"], ref["du"]) < 1e-12


@pytest.mark.parametrize("case,n", [(c, n) for c in JAX_8 for n in (2, 3)])
def test_solver_matches_jax_sharded(ranks, jax_runs, case, n):
    """Every solver sharded over ``n`` ranks against the JAX package's step
    sharded over 3 devices, at 8x8 over loads (2, 6): equal Newton lists,
    Du within 1e-10 (tests/test_mg.py:394's bound) at every step, and the
    Krylov solvers' inner counts within max(10, 0.4 n_jax)."""
    ref = jax_runs[case]
    for res in ranks[n]:
        run = res[case]
        assert run["newton"] == ref["newton"]
        assert _max_diff(run["du"], ref["du"]) < 1e-10
        if run["solver"] in ("mg", "elastic"):
            for k, k_jax in zip(run["inner"], ref["inner"]):
                assert abs(k - k_jax) <= max(10, 0.4 * k_jax), (run["inner"], ref["inner"])


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("case", CASES)
def test_solver_matches_one_rank(ranks, case, n):
    """Every solver sharded over ``n`` ranks gives one rank's bits: Du at
    every step, the last sigma (the ranks' slices in rank order, the
    padded cells cut), the residual norms, the Newton and inner lists."""
    one = ranks[1][0][case]
    nc = one["sigma"].shape[0]
    for res in ranks[n]:
        run = res[case]
        assert run["solver"] == one["solver"]
        assert sum(run["newton"]) > len(run["newton"])  # the plastic regime is reached
        assert (run["newton"], run["inner"], run["norms"]) == \
            (one["newton"], one["inner"], one["norms"])
        assert all(np.array_equal(a, b) for a, b in zip(run["du"], one["du"]))
    sigma = np.concatenate([res[case]["sigma"] for res in ranks[n]])
    assert np.array_equal(sigma[:nc], one["sigma"])
    assert not sigma[nc:].any()  # the padded cells' stress stays zero


@pytest.mark.parametrize("n", [2, 3])
def test_counts_and_sigma_layout_across_rank_counts(ranks, n):
    """tests/test_multichip_scaling.py:48 at 8x8 (dia mode): Newton lists
    equal, inner lists equal (and so within the JAX test's band, max(10,
    0.4 n1) per step), each rank's sigma its (nc_pad / n, nq, 4) slice."""
    one = ranks[1][0]["dia8"]
    assert one["nc_pad"] == 128
    for res in ranks[n]:
        run = res["dia8"]
        assert run["newton"] == one["newton"]
        assert run["inner"] == one["inner"]
        for k_n, k_1 in zip(run["inner"], one["inner"]):
            assert abs(k_n - k_1) <= max(10, 0.4 * k_1), (run["inner"], one["inner"])
        assert run["nc_pad"] == -(-128 // n) * n
        assert run["sigma"].shape == (run["nc_pad"] // n, run["nq"], 4)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_only_all_reduce_through_psum(ranks, n):
    """tests/test_multichip_scaling.py:78: no other collective was called
    (each raises in the ranks), every all_reduce went through dist.psum,
    and CG makes per step one (the load vector), per Newton pass one (the
    residual), per update two (the diagonal and the first residual) and
    one per iteration (the matvec)."""
    for res in ranks[n]:
        for case, run in res.items():
            assert run["all_reduce_calls"] == run["psum_calls"] > 0, case
        run = res["cg4"]
        steps, updates = len(run["newton"]), sum(run["newton"])
        assert run["psum_calls"] == steps + run["passes"] + 2 * updates + sum(run["inner"])


def test_one_rank_is_the_unsharded_step_bitwise(ranks):
    """With one rank the all-reduce is the identity and the rank's tables
    cover every cell: the sharded step gives the unsharded one's bits,
    with the scatters of every solver (AMG in both level-0 layouts)."""
    for case, run in ranks[1][0].items():
        if "unsharded" not in run:
            continue
        ref = run["unsharded"]
        assert (run["newton"], run["inner"], run["norms"]) == \
            (ref["newton"], ref["inner"], ref["norms"]), case
        assert all(np.array_equal(a, b) for a, b in zip(run["du"], ref["du"])), case
        assert np.array_equal(run["sigma"], ref["sigma"]), case


@pytest.mark.parametrize("n", [2, 3])
def test_ranks_agree_bitwise_and_repeat(ranks, n):
    """Every rank holds the same Du and reports the same norms, bit for
    bit (the sharded loops branch on them); a second 2-rank run repeats
    the first bitwise."""
    for case in ranks[n][0]:
        runs = [res[case] for res in ranks[n]]
        assert all(r["norms"] == runs[0]["norms"] for r in runs), case
        assert all(np.array_equal(a, b) for r in runs for a, b in zip(r["du"], runs[0]["du"]))
    if n == 2:
        for res in ranks[2]:
            run, again = res["dia8"], res["dia8"]["again"]
            assert (again["newton"], again["inner"], again["norms"]) == \
                (run["newton"], run["inner"], run["norms"])
            assert all(np.array_equal(a, b) for a, b in zip(again["du"], run["du"]))


def test_from_statics_of_a_sharded_jax_step(ranks, jax_runs):
    """A JAX step's statics, padded for 3 devices (33 cells at 4x4, 129 at
    8x8) and re-padded for 2 ranks (34, 130), with the AMG hierarchy of a
    sharded JAX step and the BCR map of a single-device one, give the JAX
    package's sharded results."""
    assert (jax_runs["cg4"]["nc_pad"], jax_runs["elastic8"]["nc_pad"]) == (33, 129)
    for res in ranks[2]:
        for case, ref in (("cg4_jax", "cg4"), ("elastic8_jax", "elastic8"),
                          ("mg8_jax", "dia8"), ("bcr8_jax", "bcr8")):
            run = res[case]
            assert run["newton"] == jax_runs[ref]["newton"], case
            assert _max_diff(run["du"], jax_runs[ref]["du"]) < 1e-10, case
        assert (res["cg4_jax"]["nc_pad"], res["elastic8_jax"]["nc_pad"]) == (34, 130)
        assert _max_diff(res["cg4_jax"]["du"], jax_runs["cg4"]["du"]) < 1e-12


def test_entry_runs_one_step_on_cpu():
    """``entry()``: one Newton-solved step of the 25x25 slope with AMG-CG
    from the zero state (``tests/test_parallel.py:75``)."""
    fn, args = entry(device="cpu")
    Du, sig, norm, its, inner = fn(*args)
    assert its >= 1 and inner > 0 and norm < 1e-8
    assert Du.shape == (5202,) and sig.shape == (1250, 3, 4)


def test_dryrun_multichip_two_ranks_on_cpu(capsys):
    """``dryrun_multichip(2)`` on the CPU: the Newton counts of
    MULTICHIP_r05.json, 1 and 2, on both ranks; sigma split in halves."""
    out = dryrun_multichip(2, device="cpu")
    assert [r["newton"] for r in out] == [[1, 2], [1, 2]]
    assert [r["sigma_shape"] for r in out] == [(256, 3, 4), (256, 3, 4)]
    assert "dryrun_multichip(2, gloo) step 1" in capsys.readouterr().out
