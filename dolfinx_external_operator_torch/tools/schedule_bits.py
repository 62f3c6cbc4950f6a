"""The slope's load schedule with each solver of the port, for holding runs
to the same bits: two processes of one version, or two versions on one card.

    python3 -m dolfinx_external_operator_torch.tools.schedule_bits [--device cpu]
        [--solvers dense,bcr,mg,elastic,general] [--n 25] [--loads 0,25,45] [--poison]
        [--time]
    PYTHONPATH=DIR python3 dolfinx_external_operator_torch/tools/schedule_bits.py

The second form runs this file against the version of the package in
``DIR``, which holds it with the top-level ``csrc/`` beside it (``git
archive <commit> dolfinx_external_operator_torch csrc`` unpacked into a
directory that ``.gitignore`` lists; without ``csrc/`` the mesh topology
falls back to another numbering and every fingerprint moves).

``dense``, ``bcr``, ``mg`` and ``elastic`` are the fused step
(``problems.mohr_coulomb_slope_step``) with that ``linear_solver``;
``general`` is the general pipeline (``models.mohr_coulomb.
solve_slope_stability``).  Each runs ``--n`` x ``--n`` over the loads of
``problems.SLOPE_LOADS`` at the indices ``--loads`` (default: all 52)
after one warm-up (the fused step: its first load, then the zero state
again; the general pipeline: a 4x4 slope over the first two loads), and
prints one JSON line: the Newton updates of each step, its inner
iterations (BCR's signed refinement rounds, AMG-CG's and the elastic
solver's PCG iterations, 0 for the dense solve and the general
pipeline), and the fingerprint of each step's Du (``general``: of the
total displacement u after each step), the first 12 hex digits of its
bytes' SHA-256.  A solver named twice runs twice in the process.

``--poison`` runs under ``torch.use_deterministic_algorithms(True,
warn_only=True)`` with ``torch.utils.deterministic.
fill_uninitialized_memory``: every ``torch.empty`` then starts as NaN
(integers at their maximum), so an output that reads memory it never
wrote moves the bits; each line adds the ops that deterministic mode
warned about.  ``--time`` adds ``s_per_step``, the schedule's wall
seconds over its steps (each step's fingerprint reads Du back, so the
device is synchronised at every step), for timing two versions in turns.
The CPU's reductions round by thread count: compare CPU
runs made with the same ``torch.get_num_threads()`` (the first line).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import sys
import time
import warnings

import torch

from dolfinx_external_operator_torch import problems
from dolfinx_external_operator_torch.utils import profiling

SOLVERS = ("dense", "bcr", "mg", "elastic", "general")
FUSED = ("dense", "bcr", "mg", "elastic")
# the warnings of torch's deterministic mode: an op without a
# deterministic implementation, or cuBLAS without a fixed workspace
DETERMINISM_ALERT = re.compile(".*deterministic", re.IGNORECASE)


def fingerprint(Du):
    """The first 12 hex digits of the SHA-256 of Du's bytes."""
    return hashlib.sha256(Du.detach().cpu().numpy().tobytes()).hexdigest()[:12]


def alerts(fn):
    """``fn()`` and the sorted messages of the deterministic-mode warnings
    it raised; other warnings are shown as usual."""
    warned = set()
    with warnings.catch_warnings():
        show = warnings.showwarning

        def note(message, *rest):
            if DETERMINISM_ALERT.search(str(message)):
                warned.add(str(message))
            else:
                show(message, *rest)

        warnings.filterwarnings("always", message=DETERMINISM_ALERT.pattern)
        warnings.showwarning = note
        out = fn()
    return out, sorted(warned)


def u_fingerprints(run):
    """Per step, the fingerprint of the total displacement u of a
    ``solve_slope_stability`` run made with every step captured: u summed
    from the steps' Du as the run sums it, the last equal to the run's u."""
    states, num = run["states"], len(run["iterations"])
    u, out = torch.zeros_like(run["u"].data), []
    for i in range(num):
        Du = states[i + 1][0] if i + 1 < num else run["Du"].data
        u = u + 1.0 * Du
        out.append(fingerprint(u))
    if not torch.equal(u, run["u"].data):
        raise RuntimeError("the steps' Du do not sum to the run's u")
    return out


def fused_schedule(fp, loads):
    """The schedule from the zero state: per-step Newton updates, inner
    iterations and Du fingerprints, and its wall seconds a step."""
    Du, sig = fp.zero_state()
    newton, inner, du = [], [], []
    t0 = time.perf_counter()
    for load in loads:
        Du, sig, _, it, cg = fp.run_step(Du, sig, float(load))
        newton.append(int(it))
        inner.append(int(cg))
        du.append(fingerprint(Du))
    return {"newton": newton, "inner": inner, "du": du,
            "s_per_step": (time.perf_counter() - t0) / len(loads)}


def schedule(solver, device, n=25, loads=problems.SLOPE_LOADS, timed=False):
    """One solver's reading (a dict with the per-step lists ``newton``,
    ``inner`` and ``du``; BCR's also with its factorizations and the levels
    that fell back to the LU inverse; where ``timed``, the fused step's
    ``s_per_step``), after one warm-up."""
    route = "cuda" if device.type == "cuda" else "plain"
    if solver == "general":
        from dolfinx_external_operator_torch.models import mohr_coulomb as mc

        mc.solve_slope_stability(4, 4, loads[:2], device=device, route=route)
        run = mc.solve_slope_stability(n, n, loads, device=device, route=route,
                                       capture=range(len(loads)))
        return {"newton": [int(i) for i in run["iterations"]], "inner": [0] * len(loads),
                "du": u_fingerprints(run), "backtracks": [int(b) for b in run["backtracks"]]}
    if solver not in FUSED:
        raise ValueError(f"unknown solver {solver!r}; one of {SOLVERS}")
    fp = problems.mohr_coulomb_slope_step(n, n, device=device, linear_solver=solver, route=route)
    # the warm-up step refreshes the elastic solver's lagged
    # preconditioner: the schedule starts again from the elastic one
    first = fp._el_precond if solver == "elastic" else None
    fp.run_step(*fp.zero_state(), float(loads[0]))
    if solver == "elastic":
        fp._el_precond = first
    profiling.reset_counters()
    out = fused_schedule(fp, loads)
    if not timed:
        del out["s_per_step"]
    if solver == "bcr":
        c = profiling.counters()
        out.update(factorizations=c.get("bcr.factorizations", 0),
                   inv_levels=c.get("bcr.inv_levels", 0))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--solvers", default=",".join(SOLVERS),
                    help=f"comma-separated, of {', '.join(SOLVERS)}")
    ap.add_argument("--n", type=int, default=25, help="the slope's cells a side")
    ap.add_argument("--loads", default=None,
                    help="comma-separated indices into SLOPE_LOADS (default: all)")
    ap.add_argument("--poison", action="store_true",
                    help="deterministic mode, uninitialized memory filled")
    ap.add_argument("--time", action="store_true",
                    help="add the fused step's wall seconds a step")
    args = ap.parse_args(argv)
    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("schedule_bits: no CUDA device available", file=sys.stderr)
        return 1
    solvers = args.solvers.split(",")
    for s in solvers:
        if s not in SOLVERS:
            ap.error(f"unknown solver {s!r}; one of {', '.join(SOLVERS)}")
    loads = problems.SLOPE_LOADS
    if args.loads is not None:
        loads = loads[[int(i) for i in args.loads.split(",")]]
    head = {"package": problems.__file__,
            "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "threads": torch.get_num_threads(), "n": args.n,
            "loads": [float(x) for x in loads], "poison": args.poison,
            "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG")}
    if args.poison:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = True
        # the mode at work on this device: a fresh allocation reads NaN, and
        # an op without a deterministic implementation is caught
        probe = torch.empty(4, dtype=torch.float64, device=dev)
        _, probe_warned = alerts(lambda: torch.zeros(2, device=dev).put_(
            torch.zeros(2, dtype=torch.long, device=dev), torch.ones(2, device=dev)))
        head.update(empty_is_nan=bool(torch.isnan(probe).all()), probe_warned=probe_warned)
    print(json.dumps(head), flush=True)
    for solver in solvers:
        reading, warned = alerts(lambda: schedule(solver, dev, args.n, loads, args.time))
        line = {"solver": solver, **reading}
        if args.poison:
            line["warned"] = warned
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
