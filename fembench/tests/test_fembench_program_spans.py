"""The readings of the program's own spans (``harness.program_spans``) and
of the two per-layer metrics that count them, on a synthetic Chrome event
list: two load steps inside the benchmark's window, the program's
``deo.*`` spans nested in the benchmark's ``fembench.*`` ones, kernels,
device-to-host copies, their launches and a CUDA graph's replay (three
kernels of one launch).  Every value below is worked out by hand from the
list.  The benchmark's own reading of the same events (``Trace``, the
accepted metrics, ``breakdown``) is the same with the program's spans in
it as without them."""

import math
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from fembench.harness import catalog  # noqa: E402
from fembench.harness.program_spans import ProgramSpans  # noqa: E402
from fembench.harness.trace import Trace  # noqa: E402

SPANS = [  # (name, start, end), microseconds
    ("fembench.window", 0, 1000),
    # step 1: one pass, one update (factor with its breakdown read, two rounds)
    ("fembench.step", 10, 500), ("deo.step", 12, 498),
    ("deo.pass", 20, 200),
    ("fembench.constitutive", 25, 80), ("deo.constitutive", 26, 79),
    ("fembench.residual", 85, 120), ("deo.residual", 86, 119),
    ("deo.host_read", 150, 190),
    ("fembench.dense_solve", 209, 481), ("deo.solve", 210, 480),
    ("deo.solve.factor", 215, 260), ("deo.host_read", 250, 258),
    ("deo.solve.round", 300, 350), ("deo.solve.round", 360, 420),
    # step 2: one pass, one update
    ("fembench.step", 520, 900), ("deo.step", 521, 899),
    ("deo.pass", 530, 700), ("deo.host_read", 650, 690),
    ("fembench.dense_solve", 709, 881), ("deo.solve", 710, 880),
    ("deo.solve.factor", 720, 760),
    ("deo.solve.round", 770, 800), ("deo.solve.round", 810, 850),
]
OPS = [  # (category, name, start, end, correlation, launch call, launch time)
    ("kernel", "void mc_trial_pass<double>(int)", 40, 70, 1, "cudaLaunchKernel", 30),
    ("kernel", "ec_residual_staged", 95, 115, 2, "cudaLaunchKernel", 90),
    ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 155, 157, 3, "cudaMemcpyAsync", 152),
    ("kernel", "potrf_kernel", 230, 248, 4, "cudaLaunchKernel", 220),
    ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 252, 253, 5, "cudaMemcpyAsync", 251),
    ("kernel", "trsv_a", 310, 320, 6, "cudaGraphLaunch", 305),
    ("kernel", "trsv_b", 320, 330, 6, "cudaGraphLaunch", 305),
    ("kernel", "trsv_c", 331, 340, 6, "cudaGraphLaunch", 305),
    ("kernel", "ec_matvec_staged", 370, 410, 7, "cudaLaunchKernel", 365),
    ("gpu_memset", "Memset (Device)", 506, 508, 13, "cudaMemsetAsync", 505),
    ("kernel", "void mc_trial_pass<double>(int)", 540, 600, 8, "cudaLaunchKernel", 535),
    ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 655, 656, 9, "cudaMemcpyAsync", 651),
    ("kernel", "potrf_kernel", 730, 760, 10, "cudaLaunchKernel", 725),
    ("kernel", "trsv_a", 775, 790, 11, "cudaLaunchKernel", 772),
    ("kernel", "ec_matvec_staged", 815, 845, 12, "cudaLaunchKernel", 812),
]


def events(program=True):
    out = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
           for n, a, b in SPANS if program or not n.startswith("deo.")]
    launched = set()
    for cat, name, a, b, corr, call, at in OPS:
        out.append({"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a,
                    "args": {"correlation": corr}})
        if corr not in launched:
            launched.add(corr)
            out.append({"ph": "X", "cat": "cuda_runtime", "name": call, "ts": at, "dur": 3,
                        "args": {"correlation": corr}})
    return out


def test_program_span_readings():
    ps = ProgramSpans(events())
    assert ps.span_count("deo.solve") == 2 and ps.span_count("deo.host_read") == 3
    assert ps.span_count("fembench.step") == 0  # the benchmark's spans are not the program's
    # the kernels launched inside: K1 30 us; the two solves 18 + 1 + 29 + 40 + 30 + 15 + 30
    assert math.isclose(ps.device_s_in("deo.constitutive"), 30e-6)
    assert math.isclose(ps.device_s_in("deo.solve"), 163e-6)
    # idle by the innermost open span where each gap began: the three
    # reads' 73, 57 and 74 us; the rounds' 1 + 30 + 96 + 25 + 155; the
    # second solve's 15 after its factor; the window's 40 before the first
    # kernel and 32 between the steps
    assert math.isclose(ps.read_idle_s(), 204e-6)
    assert math.isclose(ps.idle["deo.solve.round"], 307e-6)
    assert math.isclose(ps.idle["deo.solve"], 15e-6)
    assert math.isclose(ps.idle["fembench.window"], 72e-6)
    for name, us in (("deo.constitutive", 25), ("deo.residual", 40),
                     ("deo.solve.factor", 4), ("deo.pass", 55)):
        assert math.isclose(ps.idle[name], us * 1e-6), name
    assert math.isclose(sum(ps.idle.values()), ps.window_s - ps.busy_s)
    # twelve launch calls inside the steps (the graph's three kernels one
    # call, the memset between the steps none)
    assert ps.launches_in("deo.step") == 12
    got = ps.per_update()
    want = {"host_reads_per_update": 1.5, "read_idle_ms_per_update": 0.102,
            "launches_per_update": 6.0, "refine_rounds_per_update": 2.0}
    assert set(got) == set(want)
    for k, v in want.items():
        assert math.isclose(got[k], v), k
    row = ps.table()["deo.solve"]
    assert row["count"] == 2 and row["device_s"] == ps.device_s_in("deo.solve")
    assert math.isclose(row["idle_s"], 15e-6)


def test_program_spans_reproduce_the_benchmarks():
    ps, tr = ProgramSpans(events()), Trace(events())
    for mine, theirs in (("deo.constitutive", "fembench.constitutive"),
                         ("deo.residual", "fembench.residual"),
                         ("deo.solve", "fembench.dense_solve")):
        assert ps.span_count(mine) == tr.span_count(theirs)
        assert math.isclose(ps.device_s_in(mine), tr.device_s_in(theirs))
    assert math.isclose(ps.busy_s, tr.busy_s) and math.isclose(ps.window_s, tr.window_s)


def test_nested_spans_of_one_name():
    """A span inside another of its name (a nested operand's evaluation)
    counts twice and takes its kernels once."""
    evs = events() + [{"ph": "X", "cat": "user_annotation", "name": "deo.solve", "ts": 300,
                       "dur": 50}]
    ps = ProgramSpans(evs)
    assert ps.span_count("deo.solve") == 3
    assert math.isclose(ps.device_s_in("deo.solve"), 163e-6)


def test_no_program_spans_read_nothing():
    ps = ProgramSpans(events(program=False))
    assert ps.per_update() == {} and ps.table() == {}


CTX = {"n_dofs_reference": 5202, "bcr_blocks": (101, 804), "updates": 2, "calls": 0,
       "ref_iterations": None}


def test_the_benchmarks_readings_ignore_the_program_spans():
    with_program, without = Trace(events()), Trace(events(program=False))
    assert with_program.breakdown() == without.breakdown()
    assert (with_program.busy_s, with_program.window_s) == (without.busy_s, without.window_s)
    for m in catalog.benchmark()["per_layer"]:
        if m["source"] != "device_trace":
            continue
        reader = catalog.metric_reader(m["name"])
        assert reader.read(with_program, CTX) == reader.read(without, CTX), m["name"]


@pytest.mark.parametrize("name, want", [("host_reads_per_update", 1.5),
                                        ("refine_rounds_per_update", 2.0)])
def test_span_count_metrics(name, want, monkeypatch):
    """The two metrics read the program's own count of the spans it
    entered while the profiler recorded; without spans, or in a program
    that has no such count, they read nothing."""
    from dolfinx_external_operator_torch.utils import profiling

    reader = catalog.metric_reader(name)
    tr = Trace(events())
    counted = {"deo.solve": 2, "deo.host_read": 3, "deo.solve.round": 4, "deo.step": 2}
    monkeypatch.setattr(profiling, "_spans", dict(counted))
    assert math.isclose(reader.read(tr, CTX), want)
    monkeypatch.setattr(profiling, "_spans", {})
    assert reader.read(tr, CTX) is None
    monkeypatch.delattr(profiling, "span_counts")
    assert reader.read(tr, CTX) is None
