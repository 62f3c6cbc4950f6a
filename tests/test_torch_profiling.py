"""The port's tracing layer (``utils/profiling.py``) on 3x3 slopes, CPU.

Under ``torch.profiler`` the fused dense step, the fused BCR step and the
general slope each give the span tree of the layer boundaries (every
``deo.pass`` and ``deo.solve`` inside a ``deo.step``, every factorization
and refinement round inside a ``deo.solve``), one ``deo.solve`` per
Newton update, and one ``deo.host_read`` per counted host read.  With no
profiler running no step enters ``record_function``.  Under
``profiling.trace`` the return map's device sums are written with the
counters, and the largest residual is the map's own.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import dolfinx_external_operator_torch as pt
from dolfinx_external_operator_torch.models.mohr_coulomb import (
    MohrCoulombMaterial,
    build_slope_problem,
)
from dolfinx_external_operator_torch.utils import profiling

LOADS = pt.SLOPE_LOADS[[0, 25, 45]]


def _fused(solver):
    fp = pt.mohr_coulomb_slope_step(3, 3, route="plain", device="cpu", linear_solver=solver)
    assert fp.linear_solver == solver

    def run():
        Du, sigma = fp.zero_state()
        its = 0
        for load in LOADS:
            Du, sigma, _, it, _ = fp.run_step(Du, sigma, float(load))
            its += int(it)
        return its

    return run


def _general():
    P = build_slope_problem(3, 3, device="cpu", route="plain")
    P["Du"].x.array[:] = np.ones(P["V"].num_dofs)
    P["constitutive_update"]()

    def run():
        its = 0
        for load in LOADS:
            P["q"].value = float(load) * np.array([0.0, -P["gamma"]])
            it, _ = P["problem"].solve()
            P["sigma_n"].x.array[:] = P["sigma"].ref_coefficient.data
            its += it
        return its

    return run


RUNS = {"fused-dense": lambda: _fused("dense"), "fused-bcr": lambda: _fused("bcr"),
        "general": _general}


def _profiled(run, tmp_path):
    """``run()`` under the profiler, from zeroed counters: its result, the
    counters, and the ``deo.*`` spans of the trace as (name, start, end)."""
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("deo.")]
    return out, profiling.counters(), spans


def _inside(spans, child, parent):
    """Every ``child`` span lies within some ``parent`` span."""
    outer = [(a, b) for name, a, b in spans if name == parent]
    return all(any(a <= c0 and c1 <= b for a, b in outer)
               for name, c0, c1 in spans if name == child)


@pytest.mark.parametrize("case", sorted(RUNS))
def test_span_tree_and_counts(case, tmp_path):
    its, counters, spans = _profiled(RUNS[case](), tmp_path)
    names = [s[0] for s in spans]
    assert its > len(LOADS)  # the plastic regime is reached
    assert names.count("deo.step") == len(LOADS)
    for child in ("deo.pass", "deo.solve"):
        assert names.count(child) > 0 and _inside(spans, child, "deo.step"), child
    for child in ("deo.solve.factor", "deo.solve.round"):
        assert names.count(child) > 0 and _inside(spans, child, "deo.solve"), child
    assert names.count("deo.solve") == counters["newton.updates"] == its
    assert names.count("deo.pass") == counters["newton.passes"]
    assert names.count("deo.host_read") == counters["host.reads"] > 0
    assert profiling.span_counts() == {n: names.count(n) for n in set(names)}
    if case == "general":
        for name in ("deo.operands", "deo.external", "deo.form.vector", "deo.form.matrix"):
            assert _inside(spans, name, "deo.step"), name
        assert names.count("deo.solve.round") == 4 * its
    else:
        assert names.count("deo.constitutive") == names.count("deo.residual") \
            == counters["newton.passes"]
        assert _inside(spans, "deo.constitutive", "deo.pass")
    if case == "fused-bcr":
        assert counters["bcr.factorizations"] == its
        assert counters.get("bcr.inv_levels", 0) == 0
        assert names.count("deo.solve.round") == counters["solve.rounds"]
    if case == "fused-dense":
        assert names.count("deo.solve.round") == 2 * its == counters["solve.rounds"]


@pytest.mark.parametrize("case", sorted(RUNS))
def test_no_record_function_when_off(case, monkeypatch):
    run = RUNS[case]()

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset_counters()
    its = run()
    counters = profiling.counters()
    assert counters["newton.updates"] == its and counters["host.reads"] > 0
    assert profiling.span_counts() == {}


def test_trace_writes_k1_sums(tmp_path):
    """Inside ``trace`` the plain map's calls add their points, their
    plastic (listed) lanes and their largest residual; ``counters.json``
    holds them beside the counters over the block."""
    mat = MohrCoulombMaterial()
    gen = torch.Generator().manual_seed(7)
    deps = torch.randn((4, 257), dtype=torch.float64, generator=gen) * 2e-3
    sn = torch.zeros((4, 257), dtype=torch.float64)
    with profiling.trace(str(tmp_path / "t")):
        _, (_, _, yielding, norm_res, _) = mat.tangent_stress(deps, sn)
        its = _fused("dense")()
    with open(tmp_path / "t" / "counters.json") as f:
        c = json.load(f)
    passes = c["newton.passes"]
    fp = pt.mohr_coulomb_slope_step(3, 3, route="plain", device="cpu")
    n_fused = fp.nc * fp.nq
    assert c["newton.updates"] == its
    assert c["k1.points"] == 257 + passes * n_fused
    assert c["k1.listed"] >= int((yielding > 0).sum()) > 0
    assert c["k1.max_norm_res"] >= float(norm_res.max())
    # one call alone: the sums are exactly the map's own
    with profiling.trace(str(tmp_path / "one")):
        mat.tangent_stress(deps, sn)
    with open(tmp_path / "one" / "counters.json") as f:
        one = json.load(f)
    assert one["k1.points"] == 257
    assert one["k1.listed"] == int((yielding > 0).sum())
    assert one["k1.max_norm_res"] == float(norm_res.max())
    assert profiling._k1 is None  # the sums stop with the block
