"""The traced window: ``torch.profiler`` over the window, its Chrome trace
read into the device's busy time, the kernels launched inside each span of
the benchmark's own, and the idle gaps by the span the host was in.

Follows ``chip_smoke.py:695-731`` (``traced``, ``profile_step``: device events are
the trace's kernels, copies and fills; the idle share is one less the busy
share of the window), with the busy time taken as the union of the device
intervals, so that overlapping streams count once.  The spans are the
``record_function`` ranges named ``fembench.*`` that ``harness.spans``
puts around the program's layer entry points; ``fembench.window`` bounds
the window.  The trace file lives in a temporary directory under
``TMPDIR`` and is gone when the reading is done."""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "fembench.window"


def short_name(name):
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:120]


class Trace:
    """The reading of one traced window from its Chrome-trace events."""

    def __init__(self, events):
        spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                 for e in events if e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith("fembench.")]
        windows = [s for s in spans if s[0] == WINDOW]
        if len(windows) != 1:
            raise RuntimeError(f"the trace holds {len(windows)} '{WINDOW}' spans, not one")
        _, w0, w1 = windows[0]
        self.window_s = (w1 - w0) * 1e-6
        launch = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launch[e["args"]["correlation"]] = float(e["ts"])
        self.kernels = []  # (short name, start, duration, launch time), microseconds
        for e in events:
            if e.get("cat") in DEVICE_CATS:
                ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
                if ts + dur <= w0 or ts >= w1:
                    continue
                self.kernels.append((short_name(str(e.get("name", ""))), ts, dur,
                                     launch.get(e.get("args", {}).get("correlation"), ts)))
        self.spans = [s for s in spans if s[0] != WINDOW]
        self._by_name = {}
        for name, a, b in sorted(self.spans, key=lambda s: s[1]):
            self._by_name.setdefault(name, ([], []))
            self._by_name[name][0].append(a)
            self._by_name[name][1].append(b)
        merged = []
        for _, ts, dur, _ in sorted(self.kernels, key=lambda k: k[1]):
            a, b = max(ts, w0), min(ts + dur, w1)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        self._gaps = self._idle_gaps(merged, w0, w1)

    def span_count(self, name):
        return len(self._by_name.get(name, ((), ()))[0])

    def device_s_in(self, *names):
        """Device seconds of the operations launched inside a span of any of
        ``names``."""
        total = 0.0
        for _, _, dur, at in self.kernels:
            for name in names:
                starts, ends = self._by_name.get(name, ((), ()))
                i = bisect.bisect_right(starts, at) - 1
                if i >= 0 and at <= ends[i]:
                    total += dur
                    break
        return total * 1e-6

    def idle_s_in(self, name):
        """Idle seconds of the gaps that began where span ``name`` was the
        innermost of the benchmark's spans open."""
        return self._gaps.get(name, 0.0)

    def device_s_of(self, pattern):
        """Device seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(dur for name, _, dur, _ in self.kernels if rx.search(name)) * 1e-6

    def _idle_gaps(self, merged, w0, w1):
        """Idle seconds by the innermost span open where each gap began."""
        starts = [w0] + [b for _, b in merged]
        ends = [a for a, _ in merged] + [w1]
        gaps = sorted((a, b - a) for a, b in zip(starts, ends) if b > a)
        marks = sorted([(a, 1, i) for i, (_, a, _) in enumerate(self.spans)]
                       + [(b, 0, i) for i, (_, _, b) in enumerate(self.spans)])
        out, stack, j = {}, [], 0
        for at, length in gaps:
            while j < len(marks) and marks[j][0] <= at:
                _, opening, i = marks[j]
                if opening:
                    stack.append(i)
                elif i in stack:
                    stack.remove(i)
                j += 1
            name = self.spans[stack[-1]][0] if stack else WINDOW
            out[name] = out.get(name, 0.0) + length * 1e-6
        return out

    def breakdown(self, top=10):
        ops = {}
        for name, _, dur, _ in self.kernels:
            ops[name] = ops.get(name, 0.0) + dur * 1e-6
        def top_of(d):
            return sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]

        return {"device_ops": top_of(ops), "idle_gaps": top_of(self._gaps)}


@contextlib.contextmanager
def traced(device, box):
    """Profile the body; ``box["trace"]`` holds its ``Trace`` afterwards.
    The body records one ``fembench.window`` span."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            box["trace"] = Trace(json.load(f)["traceEvents"])


def window_span():
    return torch.profiler.record_function(WINDOW)
