"""Run one cell of the benchmark of ``dolfinx_external_operator_torch`` once.

    python3 fembench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is one of ``BENCHMARK.json``, or a held-out cell whose file keeps
its entries.  Set-up builds the cell from its configuration, the problem
it names and its traffic mix (the program's tables, the inputs from the
seed, the kernels from the build cache in the checkout) and warms every
shape the window uses.  With ``--trace 0`` the window runs ``--seconds`` and the
line's metrics are the cell's end-to-end metrics; with ``--trace 1`` it
runs under the profiler for the mix's traced length and the metrics are
the cell's per-layer metrics.  Then the problem's plain reference judges
what the window produced, and the last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each number compared
beside its limit (also the last lines of standard error).  Without a CUDA
device, or with fewer than the cell asks for, or with JAX loaded at the
end, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fembench.harness import catalog, guard, steps  # noqa: E402
from fembench.harness.timing import process_age_s, sync  # noqa: E402
from fembench.harness.trace import traced  # noqa: E402


def schedule(config):
    """The configuration's load factors: ``linspace`` pieces, concatenated,
    then the first ``steps``."""
    s = config["schedule"]
    loads = np.concatenate([np.linspace(a, b, n) for a, b, n in s["linspace"]]
                           + [np.asarray(s.get("then", []), dtype=np.float64)])
    return loads[:s["steps"]]


def verdict(attempted, failed, checks, limits):
    """``correct``: work was done and none failed, and every number the
    cell compares is within its limit (an empty or non-finite reading is
    not: the judge reads it as infinite)."""
    return (attempted > 0 and failed == 0 and set(checks) == set(limits)
            and all(math.isfinite(checks[k]) and checks[k] <= limits[k] for k in limits))


def run_cell(cell, seed, seconds, trace, device):
    """Set-up, window, judgment and metrics of one run: the result's
    fields.  ``main`` adds the look for a card and the JAX check."""
    cfg, traffic, spec = cell.config, cell.traffic, cell.spec
    problem = cell.problem(seed)
    Entry = cell.driver().Cell
    prog = Entry(cfg, traffic, problem.draw, device, seed, spans=bool(trace))
    loads = schedule(cfg)
    prog.warm(loads)
    sync(device)
    setup_s = process_age_s()

    box = {}
    first = traffic.get("trace_from", 0) if trace and Entry.kind == "steps" else 0
    lead, lead_failed = steps.lead_in(prog, loads, first)
    with traced(device, box) if trace else contextlib.nullcontext():
        if Entry.kind == "calls":
            w = prog.run(seconds=None if trace else seconds,
                         calls=traffic["trace_calls"] if trace else None)
        else:
            w = steps.run(prog, loads, seed, device, seconds=None if trace else seconds,
                          passes=traffic["trace_passes"] if trace else None,
                          sample=traffic["judge"]["sample"], tail=traffic["judge"]["tail"],
                          span=bool(trace), first=first,
                          whole=traffic.get("close_at") == "schedule")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    counts = prog.counts()

    # the reference, once the window has closed
    if Entry.kind == "calls":
        batches = prog.batches()
        del prog
        gc.collect()
        checks, ref_iters = problem.judge_points(batches)
        attempted, failed = w.calls, w.failed
        metrics = {"gauss_pts_per_s": w.calls * counts["points"] / w.seconds}
    else:
        kept = w.kept
        del prog
        gc.collect()
        checks = problem.judge_steps(kept, device)
        ref_iters = None
        attempted, failed = w.steps, w.failed + lead_failed
        metrics = steps.step_metrics(w)
        counts.update(problem.counts())
        counts["updates"] = int(sum(w.updates))
        counts["newton_first_pass"] = lead + w.updates[:len(loads) - first]
    limits = spec["limits"]
    correct = verdict(attempted, failed, checks, limits)

    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed)}
    if trace:
        tr = box["trace"]
        ctx = dict(counts, calls=getattr(w, "calls", 0), ref_iterations=ref_iters)
        out = {}
        for m in cell.per_layer:
            value = catalog.metric_reader(m["name"]).read(tr, ctx)
            if value is not None and math.isfinite(value):
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["metrics"] = out
    else:
        metrics["setup_s"] = setup_s
        result["metrics"] = {m["name"]: {"value": float(metrics[m["name"]]), "unit": m["unit"]}
                             for m in cell.end_to_end if m["name"] in metrics}
    result["device"] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["info"] = {"seed": seed, "draw": problem.draw, "setup_s": setup_s,
                      "window_s": w.seconds, **counts}
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in limits}
    return result


def card_line():
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = catalog.find(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"fembench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(cell, args.seed, args.seconds, args.trace, torch.device("cuda", 0))
    found = guard.forbidden_modules()
    if found:
        print(f"fembench: the process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    print(f"fembench: {args.workload} seed {args.seed} on {card_line()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
