"""Tracing/profiling hooks: the port of ``dolfinx_external_operator_tpu/
utils/profiling.py``, with ``torch.profiler`` in place of
``jax.profiler``.

``trace(logdir)`` records the host and, where there is a card, the
device activity of its block and writes a Chrome trace
(``trace.json``, viewable in Perfetto) into ``logdir``; ``StepStats``
records per-load-step wall times and counts for the demos.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

__all__ = ["trace", "StepStats"]


@contextlib.contextmanager
def trace(logdir: str | None):
    """Capture a ``torch.profiler`` trace into ``logdir/trace.json`` when
    ``logdir`` is given; no-op otherwise."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepStats:
    """Per-load-step statistics: wall time, Newton/CG iterations, inner
    return-map telemetry (iters histogram, max |f|, max ||r||).

    ``device``: the device the steps' tensors live on.  Where it is a card,
    ``stop`` synchronizes it first, or the wall time would be only the
    time to launch the step's work."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.steps = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, **fields):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = None if self._t0 is None else time.perf_counter() - self._t0
        rec = {"wall_s": wall, **fields}
        self.steps.append(rec)
        self._t0 = None
        return rec

    def summary(self):
        if not self.steps:
            return {}
        walls = [s["wall_s"] for s in self.steps if s.get("wall_s") is not None]
        out = {"n_steps": len(self.steps)}
        if walls:
            out.update(total_wall_s=sum(walls), mean_wall_s=sum(walls) / len(walls),
                       max_wall_s=max(walls))
        for key in ("newton_its", "cg_its"):
            vals = [s[key] for s in self.steps if key in s]
            if vals:
                out[f"total_{key}"] = int(sum(vals))
        return out

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump({"steps": self.steps, "summary": self.summary()}, f, indent=1)
