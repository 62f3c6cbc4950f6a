"""The window of a load-step cell, whatever path drives the program.

The configuration's schedule runs in order from the zero state, as a
user's script runs it (a closed loop: one step at a time), and starts
again after its last step.  A timed window ends at the first step boundary
after ``seconds``, or with ``whole`` at the first schedule boundary after
it, where the steps' costs differ so much that a window ending inside a
schedule would read as many rates as places it can end.  A traced one runs
``passes`` whole schedules; where a whole schedule's trace would be too
large to read within a run's time, it starts at step ``first`` of the
schedule, from the state that ``lead_in`` left before the profiler
opened.  Each step is timed from one CUDA event at each boundary; the
window by the host clock, from a synchronise to the synchronise after its
last step.

The steps judged afterwards: the first schedule's last ``tail`` steps (the
ones nearest collapse, with the most Newton updates), and of every step
completed, the ``sample`` with the highest draws from the seed.  Only
those steps' states are kept, so memory does not grow with the window.
"""

from __future__ import annotations

import contextlib
import heapq
import time

import numpy as np
import torch

from .timing import EventClock, sync
from .trace import window_span
from .traffic import sample_priorities


class Window:
    """What a window did: steps completed, seconds, each step's time and
    Newton updates, and the captured states of the steps to judge."""

    def __init__(self):
        self.steps = 0
        self.failed = 0
        self.seconds = 0.0
        self.step_s = []
        self.updates = []
        self.kept = []


def lead_in(cell, loads, steps):
    """The schedule's first ``steps`` steps from the zero state, outside any
    window: each step's Newton updates and how many did not converge."""
    updates, failed = [], 0
    if steps:
        cell.start()
        for load in np.asarray(loads, dtype=np.float64)[:steps]:
            its, ok, _ = cell.step(float(load), False)
            updates.append(int(its))
            failed += not ok
    return updates, failed


def run(cell, loads, seed, device, seconds=None, passes=None, sample=16, tail=3,
        span=False, first=0, whole=False):
    """Drive ``cell`` (an entry's load-step cell: ``start()``, ``step(load,
    keep) -> (updates, converged, state or None)``) over ``loads``; with
    ``span``, inside the spans of a traced window; from step ``first``
    where ``lead_in`` ran the steps before it."""
    loads = np.asarray(loads, dtype=np.float64)
    prio = sample_priorities(seed)
    heap, forced = [], []  # (draw, index, state)
    w = Window()
    clock = EventClock(device)
    pos, done_passes = first, 0
    sync(device)
    with window_span() if span else contextlib.nullcontext():
        t0 = time.perf_counter()
        clock.mark()
        if not first:
            cell.start()
        while True:
            draw = next(prio)
            first_tail = done_passes == 0 and pos >= len(loads) - tail
            keep = first_tail or len(heap) < sample or (sample > 0 and draw > heap[0][0])
            ctx = (torch.profiler.record_function("fembench.step") if span
                   else contextlib.nullcontext())
            with ctx:
                its, ok, state = cell.step(float(loads[pos]), keep)
            clock.mark()
            w.updates.append(int(its))
            w.failed += not ok
            if state is not None:
                state["load"] = float(loads[pos])
                if first_tail:
                    forced.append(state)
                elif len(heap) < sample:
                    heapq.heappush(heap, (draw, w.steps, state))
                else:
                    heapq.heapreplace(heap, (draw, w.steps, state))
            w.steps += 1
            pos += 1
            if pos == len(loads):
                pos, done_passes = 0, done_passes + 1
                if passes is not None and done_passes == passes:
                    break
                cell.start()
            if (seconds is not None and time.perf_counter() - t0 >= seconds
                    and (pos == 0 or not whole)):
                break
        sync(device)
        w.seconds = time.perf_counter() - t0
    w.step_s = clock.intervals_s()
    w.kept = forced + [s for _, _, s in sorted(heap, key=lambda h: h[1])]
    return w


def step_metrics(w):
    """``step_s``: the window over the steps completed in it;
    ``step_p95_s``: the 95th percentile of the steps' times."""
    out = {"step_s": w.seconds / w.steps if w.steps else float("nan")}
    if w.step_s:
        out["step_p95_s"] = float(np.percentile(np.asarray(w.step_s), 95))
    return out
