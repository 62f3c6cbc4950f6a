"""The control of a cell's comparison: the plain reference put in the
program's place one precision below the configuration's (float32 for its
float64), judged as a run is judged; beside it, the same seed's sound run.

    python3 fembench/tools/control.py --workload <name> --seeds 1 2 3 [--out <jsonl>]

For a load-step cell the program runs one schedule from the zero state and
keeps the steps a run keeps (the last ``tail`` and the ``sample`` with the
highest draws); the control solves each of those steps in f32 by the
reference alone, from the stress and the first guess the step was handed
(the problem's ``control_steps``; for the slope, the reference's Newton
and sparse LU, ``reference.solve``).  For the return-map cell the control
is the reference's return map in f32 on every batch of the pool
(``control_points``).  Both are judged by the problem's own judge.
Each reading is printed and appended to ``--out``: the benchmark's own runs
never run this."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from fembench.harness import catalog, steps  # noqa: E402
from fembench.run import schedule  # noqa: E402


def readings(cell, seed, device, dtype=torch.float32, sample=None):
    """``{"program": {...}, "control": {...}}`` for one seed; ``sample``
    overrides the mix's number of sampled steps (the tail is kept)."""
    cfg, traffic = cell.config, cell.traffic
    problem = cell.problem(seed)
    Entry = cell.driver().Cell
    prog = Entry(cfg, traffic, problem.draw, device, seed)
    if Entry.kind == "calls":
        prog.warm(None)
        batches = prog.batches()
        program, _ = problem.judge_points(batches)
        control, _ = problem.judge_points(problem.control_points(batches, dtype))
        return {"program": program, "control": control}
    w = steps.run(prog, schedule(cfg), seed, device, passes=1,
                  sample=traffic["judge"]["sample"] if sample is None else sample,
                  tail=traffic["judge"]["tail"])
    program = problem.judge_steps(w.kept, device)
    control = problem.judge_steps(problem.control_steps(w.kept, device, dtype), device)
    return {"program": program, "control": control, "steps": len(w.kept)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sample", type=int, default=None)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "control.jsonl"))
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = catalog.find(args.workload)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        row = dict(readings(cell, seed, device, sample=args.sample), workload=args.workload,
                   seed=seed)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
