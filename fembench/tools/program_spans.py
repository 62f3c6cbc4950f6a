"""The program's own spans in one cell, read beside the benchmark's.

    python3 fembench/tools/program_spans.py --workload <name> --seed <n> \
        [--repeat 1] [--out chiprun_out/program_spans.<name>.json]

Builds the cell as ``run.py`` does (with the benchmark's spans), traces
its schedule once and drops that reading (the first traced window of a
process pays the profiler's start), then traces it once per side,
``--repeat`` times in turns: with the program's ``deo.*`` spans on, and
with them off (the gate forced shut, the reads still counted).  From the
first it reads the program's spans (``harness.program_spans``: counts,
device seconds, idle by innermost span, host reads, read-begun idle,
launch calls and refinement rounds per update) and holds them to the
benchmark's spans over the same events; from both, the traced step time
and ``device_idle_pct.step``.  Also the
gate's cost per site on this host with no profiler running, against a
bare ``record_function``.  Prints one JSON line and writes it to ``--out``.
Without a CUDA device it exits non-zero."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from fembench.harness import catalog, steps  # noqa: E402
from fembench.harness.program_spans import ProgramSpans  # noqa: E402
from fembench.harness.trace import Trace  # noqa: E402
from fembench.run import card_line, schedule  # noqa: E402

# the program's spans that stand for the benchmark's, by linear solver
_FUSED = {"constitutive": (("deo.constitutive",), ("fembench.constitutive",)),
          "residual": (("deo.residual",), ("fembench.residual",))}
_FORMS = ("operands", "evaluate_operands"), ("external", "evaluate_external_operators"), \
    ("form.vector", "form_vector"), ("form.matrix", "form_matrix"), ("form.action", "form_action")
PAIRS = {
    "dense": dict(_FUSED, dense_solve=(("deo.solve",), ("fembench.dense_solve",))),
    "bcr": dict(_FUSED, bcr_factor=(("deo.solve.factor",), ("fembench.bcr_factor",)),
                bcr_solve=(("deo.solve",), ("fembench.bcr_solve",))),
    "mg": dict(_FUSED, mg_solve=(("deo.solve",), ("fembench.mg_solve",))),
    "lu_ir": {"lu_ir": (("deo.solve",), ("fembench.lu_ir",)),
              **{mine: ((f"deo.{mine}",), (f"fembench.{theirs}",)) for mine, theirs in _FORMS},
              "assembly": (tuple(f"deo.{mine}" for mine, _ in _FORMS),
                           tuple(f"fembench.{theirs}" for _, theirs in _FORMS))},
}


def gate_cost_us(n=200_000):
    """Microseconds per span site with no profiler running: the program's
    gated ``span``, and a bare ``record_function``."""
    from dolfinx_external_operator_torch.utils import profiling

    def timed(make, k):
        t0 = time.perf_counter()
        for _ in range(k):
            with make("deo.cost"):
                pass
        return (time.perf_counter() - t0) / k * 1e6

    timed(profiling.span, 1000)
    return {"gated_us": timed(profiling.span, n),
            "record_function_us": timed(torch.profiler.record_function, n // 10)}


def traced_events(body, device):
    """``body()`` under the profiler as the benchmark traces a window; its
    result and the Chrome trace's events."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
                 ) as prof:
        out = body()
        if cuda:
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return out, json.load(f)["traceEvents"]


def window(prog, loads, seed, device, program_spans, first=0):
    """One traced schedule from its step ``first``, the steps before it run
    untraced (the mix's ``trace_from``); the program's spans on or off."""
    from dolfinx_external_operator_torch.utils import profiling

    shut = (lambda: False) if not program_spans else profiling._recording
    steps.lead_in(prog, loads, first)
    with mock.patch.object(profiling, "_recording", shut):
        profiling.reset_counters()
        w, events = traced_events(lambda: steps.run(prog, loads, seed, device, passes=1,
                                                    sample=0, tail=0, span=True,
                                                    first=first), device)
        sites = sum(profiling.span_counts().values())
    return w, events, sites


def compare(tr, ps, pairs):
    out = {}
    for key, (mine, theirs) in pairs.items():
        n_mine = sum(ps.span_count(n) for n in mine)
        n_theirs = sum(tr.span_count(n) for n in theirs)
        if not n_theirs and not n_mine:
            continue
        s_mine, s_theirs = ps.device_s_in(*mine), tr.device_s_in(*theirs)
        out[key] = {"count": [n_mine, n_theirs], "device_s": [s_mine, s_theirs],
                    "ratio": s_mine / s_theirs if s_theirs > 0 else None}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("program_spans: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = measure(catalog.find(args.workload), args.seed, args.repeat,
                     torch.device("cuda", 0))
    out = args.out or os.path.join("chiprun_out", f"program_spans.{args.workload}.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


def measure(cell, seed, repeat, device):
    """The readings of ``main`` for ``cell`` on ``device``."""
    cfg, traffic = cell.config, cell.traffic
    Entry = cell.driver().Cell
    prog = Entry(cfg, traffic, cell.problem(seed).draw, device, seed, spans=True)
    loads = schedule(cfg)
    prog.warm(loads)
    idle = catalog.metric_reader("device_idle_pct.step")
    result = {"workload": cell.name, "seed": seed,
              "card": card_line() if device.type == "cuda" else "cpu",
              "gate": gate_cost_us(), "runs": []}
    first = traffic.get("trace_from", 0)
    window(prog, loads, seed, device, True, first)
    for k in range(repeat):
        for on in (True, False) if k % 2 == 0 else (False, True):
            w, events, sites = window(prog, loads, seed, device, on, first)
            tr = Trace(events)
            updates = int(sum(w.updates))
            run = {"program_spans": on, "steps": w.steps, "updates": updates,
                   "step_s": w.seconds / w.steps, "window_s": tr.window_s, "busy_s": tr.busy_s,
                   "device_idle_pct.step": idle.read(tr, {}), "breakdown": tr.breakdown()}
            if on:
                ps = ProgramSpans(events)
                run.update(sites_per_update=sites / updates, readings=ps.per_update(),
                           table=ps.table(), idle_by_program_span=ps.idle,
                           compare=compare(tr, ps, PAIRS[prog.counts()["linear_solver"]]))
            result["runs"].append(run)
            del events
    return result


if __name__ == "__main__":
    sys.exit(main())
