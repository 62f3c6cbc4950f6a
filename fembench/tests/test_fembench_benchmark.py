"""BENCHMARK.json and the files the harness finds by name: every cell,
configuration, traffic mix and per-layer metric has its file, the names
and units keep to the allowed characters, and the last line's keys and
the JAX check behave as the benchmark's contract asks."""

import json
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from fembench.harness import catalog, guard, steps  # noqa: E402
from fembench.run import verdict  # noqa: E402

BENCH = catalog.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "fembench/run.py"]
    assert BENCH["paths"] == ["fembench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its time: 2 + 14 runs a cell
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_valid_and_unique(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(catalog.NAME.match(n) for n in names), names


def test_units_and_texts():
    for m in METRICS:
        assert catalog.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for e in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for c in BENCH["configs"]:
        assert len(c["source"]) <= 200 and all(catalog.NAME.match(k) for k in c["reduced"])


def test_metric_sources_and_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in names and "bound" not in m
        if "_roofline" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_found_by_name(name):
    cell = catalog.Cell(name)
    assert cell.driver().Cell.kind in ("steps", "calls")
    assert cell.chips == 1
    assert set(cell.spec["limits"]) and all(v > 0 for v in cell.spec["limits"].values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:  # each moves a metric this cell reports
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_is_found_by_name(metric):
    reader = catalog.metric_reader(metric["name"])
    assert reader.LAYER == metric["layer"]
    assert reader.MOVES == metric["moves"]
    assert reader.UNIT == metric["unit"]
    assert callable(reader.read)


@pytest.mark.parametrize("name, kind, end_to_end", [
    ("mc-slope-100x100.returnmap-mix", "calls", {"gauss_pts_per_s", "setup_s"}),
    ("mc-slope-25x25.fused-mg", "steps", {"step_s", "setup_s"}),
])
def test_held_out_cell_is_complete(name, kind, end_to_end):
    """A held-out cell's file keeps its BENCHMARK.json entries, which name
    files that exist, so that putting it back edits no file; a metric that
    BENCHMARK.json already has gains the cell in its list, once."""
    assert name not in CELLS
    bench = catalog.with_held_out(name)
    for group in ("workloads", "end_to_end", "per_layer"):
        names = [m["name"] for m in bench[group]]
        assert len(names) == len(set(names)), group
    cell = catalog.find(name)
    assert cell.driver().Cell.kind == kind
    assert {m["name"] for m in cell.end_to_end} == end_to_end
    assert cell.per_layer
    for m in cell.per_layer:
        reader = catalog.metric_reader(m["name"])
        assert (reader.LAYER, reader.MOVES, reader.UNIT) == (m["layer"], m["moves"], m["unit"])
    assert all(name not in m.get("workloads", ()) for m in BENCH["per_layer"])


def test_a_cell_neither_listed_nor_held_out_is_refused():
    with pytest.raises(KeyError, match="no-such"):
        catalog.find("mc-slope-25x25.no-such")
    with pytest.raises(KeyError, match="held-out"):
        catalog.with_held_out("mc-slope-25x25.fused-dense")


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, dirnames, files in os.walk(os.path.join(ROOT, "fembench")):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert all(catalog.NAME.match(part) for part in rel.split(os.sep)), rel


def test_configs_hold_the_cells_sizes():
    """Each configuration's file agrees with its entry, and its stated dofs
    with its problem's reference (the slope's other sizes:
    ``test_fembench_problems.py``)."""
    for c in BENCH["configs"]:
        cfg = catalog.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        counts = catalog.problem_class(cfg)(cfg, 0).counts()
        assert cfg["sizes"]["dofs"] == counts["n_dofs_reference"]
        assert len(cfg["record"]["newton_per_step"]) == cfg["schedule"]["steps"]


@pytest.mark.parametrize("names, found", [
    (["jax", "numpy"], ["jax"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["dolfinx_external_operator_tpu.ops"], ["dolfinx_external_operator_tpu"]),
    (["dolfinx_external_operator_torch", "dolfinx_external_operator_torch.ops", "jaxtyping",
      "flaxen", "my_jax"], []),
    (["flax.linen"], ["flax"]),
])
def test_guard_compares_whole_top_level_names(names, found):
    assert guard.forbidden_modules(names) == found


def test_verdict_needs_work_done_and_every_number_within_its_limit():
    limits = {"residual": 1e-7, "stress": 1e-8}
    good = {"residual": 1e-9, "stress": 1e-10}
    assert verdict(10, 0, good, limits)
    assert not verdict(0, 0, good, limits)  # a run that completed nothing
    assert not verdict(10, 1, good, limits)  # a step that never converged
    assert not verdict(10, 0, {"residual": 1e-9}, limits)
    assert not verdict(10, 0, dict(good, stress=float("inf")), limits)
    assert not verdict(10, 0, dict(good, stress=float("nan")), limits)
    assert not verdict(10, 0, dict(good, stress=2e-8), limits)


def test_last_line_keys(tmp_path):
    """The line ``main`` prints carries the keys the driver reads, with
    ``checks`` last."""
    import torch

    from fembench.run import run_cell

    cell = catalog.Cell("mc-slope-25x25.fused-dense")
    cell.config["mesh"].update(Nx=2, Ny=2)
    cell.config["schedule"]["steps"] = 2
    torch.set_num_threads(1)
    res = run_cell(cell, 7, 0.05, 0, torch.device("cpu"))
    line = json.loads(json.dumps(res))
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert {"metrics", "device"} <= set(line) and list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert {"step_s", "step_p95_s", "setup_s"} == set(line["metrics"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_window_from_a_later_step():
    """A mix's ``trace_from`` runs the schedule's first steps before the
    profiler opens; the traced window holds the rest of the schedule, the
    per-update metrics read its updates alone, and the Newton list is the
    whole schedule's."""
    import torch

    from fembench.run import run_cell

    cell = catalog.find("mc-slope-25x25.fused-mg")
    cell.config["mesh"].update(Nx=2, Ny=2)
    cell.config["schedule"] = {"linspace": [[2.0, 12.0, 3]], "steps": 3}
    cell.traffic["trace_from"] = 1
    torch.set_num_threads(1)
    res = run_cell(cell, 11, 0.05, 1, torch.device("cpu"))
    assert res["correct"] and res["attempted"] == 2
    first_pass = res["info"]["newton_first_pass"]
    assert len(first_pass) == 3 and res["info"]["updates"] == sum(first_pass[1:])
    assert "host_reads_per_update" in res["metrics"]


class Sleeper:
    """A load-step cell whose step sleeps for its load in seconds."""

    def __init__(self):
        self.starts, self.seen = 0, []

    def start(self):
        self.starts += 1

    def step(self, load, keep):
        time.sleep(load)
        self.seen.append(load)
        return 1, True, ({} if keep else None)


@pytest.mark.parametrize("whole, want", [(False, 1), (True, 3)])
def test_window_closes_at_a_step_or_at_a_schedule_boundary(whole, want):
    import torch

    w = steps.run(Sleeper(), [0.02, 0.001, 0.001], 5, torch.device("cpu"), seconds=0.005,
                  sample=0, tail=0, whole=whole)
    assert w.steps == want


def test_lead_in_then_a_window_from_that_step():
    import torch

    cell, loads = Sleeper(), [0.0, 1e-4, 2e-4, 3e-4]
    assert steps.lead_in(cell, loads, 2) == ([1, 1], 0)
    w = steps.run(cell, loads, 5, torch.device("cpu"), passes=1, sample=0, tail=1, first=2)
    assert cell.starts == 1 and cell.seen == loads and w.steps == 2
    assert [s["load"] for s in w.kept] == [3e-4] and w.updates == [1, 1]
