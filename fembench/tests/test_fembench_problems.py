"""Each configuration names its problem (``fembench/problems/<problem>.py``),
and the harness judges through that problem's ``Problem``: a configuration
of a new problem needs only new files.  Also the slope's own problem, and
the reader of ``mg_idle_ms_per_update`` on a synthetic trace."""

import json
import math
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from fembench.harness import catalog  # noqa: E402
from fembench.harness.trace import Trace  # noqa: E402
from fembench.harness.traffic import cohesion_factor  # noqa: E402

BENCH = catalog.benchmark()
SLOPE = catalog.load_json(os.path.join(ROOT, "fembench", "configs", "mc-slope-25x25.json"))

STUB = '''
import math

CALLS = []


class Problem:
    def __init__(self, config, seed):
        self.config = config
        self.draw = 1.0 + (seed % 10) / 100

    def judge_steps(self, kept, device):
        CALLS.append(("judge_steps", [sorted(s) for s in kept], str(device)))
        return {"residual": 2.5e-9, "stress": 0.0}

    def judge_points(self, batches):
        return {"residual": math.inf, "stress": math.inf}, None

    def counts(self):
        return {"n_dofs_reference": self.config["sizes"]["dofs"], "stub_count": 7}
'''


def stub_root(tmp, problem="stub_problem", module=STUB):
    """A benchmark under ``tmp`` with one cell whose configuration, a copy of
    the 25x25 slope cut to 2 x 2 cells and two steps, names ``problem``."""
    fem = os.path.join(tmp, "fembench")
    for sub in ("configs", "problems", "traffic", "workloads"):
        os.makedirs(os.path.join(fem, sub))
    cfg = json.loads(json.dumps(SLOPE))
    cfg.update(name="stub-config")
    cfg["mesh"].update(Nx=2, Ny=2)
    cfg["sizes"] = {"dofs": 50, "cells": 8, "gauss_points": 24}
    cfg["schedule"] = {"linspace": [[2.0, 12.0, 2]], "steps": 2}
    if problem is None:
        del cfg["problem"]
    else:
        cfg["problem"] = problem
    cell = {"config": "stub-config", "traffic": "fused-dense", "chips": 1, "why": "stub",
            "limits": {"residual": 1e-6, "stress": 1e-7}}
    bench = {"configs": [{"name": "stub-config", "file": "fembench/configs/stub-config.json"}],
             "workloads": [dict(name="stub-config.fused-dense",
                                **{k: cell[k] for k in ("config", "traffic", "chips", "why")})],
             "end_to_end": [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
             + [{"name": "step_s", "unit": "s/step", "better": "lower", "bound": 0.17,
                 "source": "host_clock"}],
             "per_layer": []}
    for rel, obj in (("configs/stub-config.json", cfg),
                     ("workloads/stub-config.fused-dense.json", cell)):
        with open(os.path.join(fem, rel), "w") as f:
            json.dump(obj, f)
    shutil.copy(os.path.join(ROOT, "fembench", "traffic", "fused-dense.json"),
                os.path.join(fem, "traffic"))
    with open(os.path.join(fem, "problems", "stub_problem.py"), "w") as f:
        f.write(module)
    return bench


def test_a_new_problem_is_dispatched_by_its_files_alone(tmp_path, monkeypatch):
    """A configuration naming a problem that only a new file under a
    temporary root defines: ``run_cell`` hands the problem's ``draw`` to the
    entry, judges the kept steps by its ``judge_steps`` and reports its
    ``counts``."""
    from fembench.entries import fused_step
    from fembench.run import run_cell

    bench = stub_root(str(tmp_path))
    cell = catalog.Cell("stub-config.fused-dense", bench, root=str(tmp_path))
    handed = []
    init = fused_step.Cell.__init__

    def recording(self, config, traffic, factor, *args, **kwargs):
        handed.append(factor)
        init(self, config, traffic, factor, *args, **kwargs)

    monkeypatch.setattr(fused_step.Cell, "__init__", recording)
    torch.set_num_threads(1)
    res = run_cell(cell, 2147483659, 0.05, 0, torch.device("cpu"))
    stub = cell.Problem.__init__.__globals__["CALLS"]
    assert handed == [1.09] and res["info"]["draw"] == 1.09
    assert [c[0] for c in stub] == ["judge_steps"] and stub[0][2] == "cpu"
    assert stub[0][1] and all(k == ["Du", "Du_in", "load", "sigma", "sigma_n"]
                              for k in stub[0][1])
    assert res["checks"] == {"residual": {"value": 2.5e-9, "limit": 1e-6},
                             "stress": {"value": 0.0, "limit": 1e-7}}
    assert res["correct"] and res["info"]["stub_count"] == 7
    assert res["info"]["n_dofs_reference"] == 50 and "bcr_blocks" not in res["info"]


@pytest.mark.parametrize("problem, error", [("no_such_problem", FileNotFoundError),
                                            (None, ValueError), ("bad name", ValueError)])
def test_a_configuration_without_its_problem_is_refused(tmp_path, problem, error):
    bench = stub_root(str(tmp_path), problem)
    with pytest.raises(error, match="stub-config"):
        catalog.Cell("stub-config.fused-dense", bench, root=str(tmp_path))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_every_configuration_names_a_problem_module(config):
    cfg = catalog.load_json(os.path.join(ROOT, config["file"]))
    assert os.path.isfile(os.path.join(ROOT, "fembench", "problems", f"{cfg['problem']}.py"))
    problem = catalog.problem_class(cfg)(cfg, 0)
    for member in ("judge_steps", "judge_points", "counts", "control_steps", "control_points"):
        assert callable(getattr(problem, member)), member
    assert isinstance(problem.draw, float)


@pytest.mark.parametrize("seed", [0, 7, 2147483659])
def test_the_slopes_draw_is_the_cohesion_factor(seed):
    problem = catalog.problem_class(SLOPE)(SLOPE, seed)
    assert problem.draw == cohesion_factor(seed, SLOPE["seed"]["cohesion_spread"])
    assert problem.material.c == SLOPE["material"]["c"] * problem.draw


@pytest.mark.parametrize("name", ["mc-slope-25x25", "mc-slope-100x100"])
def test_the_slopes_reference_has_the_configurations_sizes(name):
    cfg = catalog.load_json(os.path.join(ROOT, "fembench", "configs", f"{name}.json"))
    problem = catalog.problem_class(cfg)(cfg, 3)
    n = cfg["mesh"]["Nx"]
    assert problem.counts() == {"n_dofs_reference": cfg["sizes"]["dofs"],
                                "bcr_blocks": (n + 1, 4 * (2 * n + 1))}
    assert problem.slope.n_points == cfg["sizes"]["gauss_points"]
    assert problem.slope.n_cells == cfg["sizes"]["cells"]


# -- mg_idle_ms_per_update on a synthetic trace --------------------------------

def _events(mg=True):
    """Two steps of one update each; inside each step an mg solve in which
    the card idles 50 us, and gaps elsewhere."""
    spans = [("fembench.window", 0, 1000), ("fembench.step", 10, 480),
             ("fembench.step", 500, 990)]
    if mg:
        spans += [("fembench.mg_solve", 200, 400), ("fembench.mg_solve", 700, 900)]
    kernels = [(20, 200), (230, 300), (320, 480), (520, 700), (750, 990)]
    out = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
           for n, a, b in spans]
    out += [{"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": a, "dur": b - a,
             "args": {"correlation": i}} for i, (a, b) in enumerate(kernels)]
    return out


def test_mg_idle_per_update_reads_the_gaps_begun_in_the_solve():
    reader = catalog.metric_reader("mg_idle_ms_per_update")
    tr = Trace(_events())
    # gaps: 0-20 window, 200-230 mg (30), 300-320 mg (20), 480-520 window
    # (the step closed at 480), 700-750 mg (50), 990-1000 window
    assert math.isclose(tr.idle_s_in("fembench.mg_solve"), 100e-6)
    assert math.isclose(reader.read(tr, {"updates": 2}), 0.05)
    assert reader.read(tr, {"updates": 0}) is None
    assert reader.read(Trace(_events(mg=False)), {"updates": 2}) is None
