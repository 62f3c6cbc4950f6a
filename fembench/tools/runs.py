"""Runs of one cell, each in a fresh process as the benchmark's check runs
them, and the spread of their metrics.

    python3 fembench/tools/runs.py --workload <name> --seeds 11 12 13 \
        [--seconds 30] [--trace 0] [--sets 2] [--out chiprun_out/<file>.jsonl]

``--sets 2`` runs the seeds twice, set after set, as the bounds are
measured.  Each run's last line is appended to ``--out``; the summary
prints, per metric and set, the median and the spread: the distance between
the first and third quartiles (``statistics.quantiles(values, n=4)``) over
the median.  A run that exits non-zero or prints no result is reported and
counted; its last lines of standard error are kept in the file."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

RUN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "run.py")


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = args.out or os.path.join("chiprun_out", f"{args.workload}.jsonl")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    per_set = []
    for s in range(args.sets):
        rows = []
        for seed in args.seeds:
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, RUN, "--workload", args.workload,
                                  "--seed", str(seed), "--seconds", str(args.seconds),
                                  "--trace", str(args.trace)], capture_output=True, text=True)
            wall = time.perf_counter() - t0
            line = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                row = {"error": res.returncode, "stderr": res.stderr[-3000:]}
            row.update(set=s, seed=seed, wall_s=wall, rc=res.returncode)
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
            rows.append(row)
            checks = {k: v["value"] for k, v in row.get("checks", {}).items()}
            metrics = {k: v["value"] for k, v in row.get("metrics", {}).items()}
            print(f"set {s} seed {seed} rc {res.returncode} wall {wall:.1f} "
                  f"correct {row.get('correct')} attempted {row.get('attempted')} "
                  f"failed {row.get('failed')} {json.dumps(metrics)} checks {json.dumps(checks)}",
                  flush=True)
            if "error" in row:
                print(row["stderr"][-1500:], flush=True)
        per_set.append(rows)
    for s, rows in enumerate(per_set):
        names = sorted({k for r in rows for k in r.get("metrics", {})})
        for k in names:
            vals = [r["metrics"][k]["value"] for r in rows if k in r.get("metrics", {})]
            print(f"set {s} {k}: n {len(vals)} median {statistics.median(vals)!r} "
                  f"spread {spread(vals)!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
