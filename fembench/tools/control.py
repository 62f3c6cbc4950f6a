"""The control of a cell's comparison: the plain reference put in the
program's place one precision below the configuration's (float32 for its
float64), judged as a run is judged; beside it, the same seed's sound run.

    python3 fembench/tools/control.py --workload <name> --seeds 1 2 3 [--out <jsonl>]

For a load-step cell the program runs one schedule from the zero state and
keeps the steps a run keeps (the last ``tail`` and the ``sample`` with the
highest draws); the control solves each of those steps in f32 with the
reference's Newton and sparse LU (``reference.solve``), from the stress
and the first guess the step was handed.  For the return-map cell the
control is the reference's return map in f32 on every batch of the pool.
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
from fembench.harness.traffic import cohesion_factor  # noqa: E402
from fembench.reference.judge import judge_points, judge_steps  # noqa: E402
from fembench.reference.mohr_coulomb import Material, return_map  # noqa: E402
from fembench.reference.slope import Slope  # noqa: E402
from fembench.reference.solve import solve_step  # noqa: E402
from fembench.run import schedule  # noqa: E402


def readings(cell, seed, device, dtype=torch.float32, sample=None):
    """``{"program": {...}, "control": {...}}`` for one seed; ``sample``
    overrides the mix's number of sampled steps (the tail is kept)."""
    cfg, traffic = cell.config, cell.traffic
    factor = cohesion_factor(seed, cfg["seed"]["cohesion_spread"])
    mat = Material.from_config(cfg["material"], factor)
    Entry = cell.driver().Cell
    if Entry.kind == "calls":
        prog = Entry(cfg, traffic, factor, device, seed)
        prog.warm(None)
        batches = prog.batches()
        program, _ = judge_points(mat, batches)
        ctrl = []
        for b in batches:
            sig, C, *_ = return_map(mat, b["deps"], b["sigma_n"], dtype=dtype)
            ctrl.append(dict(b, sigma=sig, tangent=C))
        control, _ = judge_points(mat, ctrl)
        return {"program": program, "control": control}
    prog = Entry(cfg, traffic, factor, device, seed)
    loads = schedule(cfg)
    w = steps.run(prog, loads, seed, device, passes=1,
                  sample=traffic["judge"]["sample"] if sample is None else sample,
                  tail=traffic["judge"]["tail"])
    m = cfg["mesh"]
    slope = Slope(m["Nx"], m["Ny"], m["L"], m["H"])
    program = judge_steps(slope, slope.on(device, torch.float64), mat, w.kept)
    arrays = slope.on(device, dtype)
    ctrl = []
    for s in w.kept:
        Du, sig = solve_step(slope, arrays, mat, s["sigma_n"], s["Du_in"], s["load"], dtype,
                             atol=cfg["newton"]["atol"])
        ctrl.append({"load": s["load"], "sigma_n": s["sigma_n"], "Du": Du, "sigma": sig})
    control = judge_steps(slope, slope.on(device, torch.float64), mat, ctrl)
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
    cell = catalog.Cell(args.workload)
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
