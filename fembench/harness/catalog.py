"""Finds what a run needs by name: the cell in ``BENCHMARK.json`` and its
file under ``fembench/workloads/``, the configuration, the problem it
names (``fembench/problems/<problem>.py``), the traffic mix, the entry that
drives the program, and the metrics the cell reports.  Adding a cell, a
configuration, a problem, a mix or a per-layer metric adds files and
``BENCHMARK.json`` entries; nothing here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

FEMBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(FEMBENCH)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _named(kind, name):
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a valid name")
    return name


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell: its ``BENCHMARK.json`` entry, its own file, its
    configuration, the problem the configuration names and its traffic mix,
    and the metrics it reports."""

    def __init__(self, name, bench=None, root=ROOT):
        bench = benchmark(root) if bench is None else bench
        self.name = _named("workload", name)
        entries = [w for w in bench["workloads"] if w["name"] == name]
        if len(entries) != 1:
            raise KeyError(f"BENCHMARK.json lists no workload {name!r}")
        self.entry = entries[0]
        fem = os.path.join(root, "fembench")
        self.spec = load_json(os.path.join(fem, "workloads", f"{name}.json"))
        for key in ("config", "traffic", "chips"):
            if self.spec[key] != self.entry[key]:
                raise ValueError(f"{name}: {key} is {self.spec[key]!r} in its file and "
                                 f"{self.entry[key]!r} in BENCHMARK.json")
        cfgs = [c for c in bench["configs"] if c["name"] == self.entry["config"]]
        if len(cfgs) != 1:
            raise KeyError(f"BENCHMARK.json lists no config {self.entry['config']!r}")
        self.config = load_json(os.path.join(root, cfgs[0]["file"]))
        self.Problem = problem_class(self.config, root)
        self.traffic = load_json(os.path.join(
            fem, "traffic", f"{_named('traffic', self.entry['traffic'])}.json"))
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]

    def _reports(self, metric):
        return "workloads" not in metric or self.name in metric["workloads"]

    def problem(self, seed):
        """The configuration's problem with what ``seed`` makes of it."""
        return self.Problem(self.config, seed)

    def driver(self):
        """The entry module that drives the program for this mix."""
        return importlib.import_module(f"fembench.entries.{self.traffic['entry']}")


def with_held_out(name, bench=None, root=ROOT):
    """``BENCHMARK.json`` with the entries that a held-out cell's file keeps
    for it (``held_out.benchmark_entries``): a cell left out while the
    program fails it or its runs spread too widely to hold a bound, ready
    to go back by those entries alone.  A metric that ``BENCHMARK.json``
    already has gains the cell in its list; another is added whole."""
    bench = json.loads(json.dumps(benchmark(root) if bench is None else bench))
    path = os.path.join(root, "fembench", "workloads", f"{_named('workload', name)}.json")
    spec = load_json(path) if os.path.isfile(path) else {}
    if "held_out" not in spec:
        raise KeyError(f"BENCHMARK.json lists no workload {name!r}, and no held-out cell "
                       "has that name")
    frag = spec["held_out"]["benchmark_entries"]
    bench["workloads"].append(frag["workload"])
    for kind in ("end_to_end", "per_layer"):
        have = {m["name"]: m for m in bench[kind]}
        for m in frag[kind]:
            if m["name"] in have:
                have[m["name"]]["workloads"] += m["workloads"]
            else:
                bench[kind].append(m)
    return bench


def find(name, root=ROOT):
    """The cell ``name`` of ``BENCHMARK.json``, or the held-out cell of that
    name with its entries put back (``with_held_out``)."""
    bench = benchmark(root)
    if any(w["name"] == name for w in bench["workloads"]):
        return Cell(name, bench, root)
    return Cell(name, with_held_out(name, bench, root), root)


def problem_class(config, root=ROOT):
    """The ``Problem`` of the problem that ``config`` names:
    ``fembench/problems/<problem>.py``.  ``Problem(config, seed)`` has
    ``draw`` (what the seed makes of the configuration, handed to the
    entry), ``judge_steps(kept, device)`` and ``judge_points(batches)``
    (the checks against the plain reference), ``counts()`` (its part of
    the metrics' context), and ``control_steps`` and ``control_points``
    (the reference in the program's place, ``tools/control.py``)."""
    name = config.get("name")
    problem = config.get("problem")
    try:
        _named("problem", problem if isinstance(problem, str) else "")
    except ValueError as e:
        raise ValueError(f"configuration {name!r} names no problem: {e}") from None
    path = os.path.join(root, "fembench", "problems", f"{problem}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"configuration {name!r} names problem {problem!r}, and "
                                f"fembench/problems/{problem}.py does not exist")
    return _module(path, f"fembench_problem_{problem}").Problem


def metric_reader(name, root=ROOT):
    """The reader of per-layer metric ``name``: ``fembench/metrics/<name>.py``."""
    path = os.path.join(root, "fembench", "metrics", f"{_named('metric', name)}.py")
    return _module(path, f"fembench_metric_{name}")
