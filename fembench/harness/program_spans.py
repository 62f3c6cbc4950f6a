"""The program's own spans in a traced window: the ``deo.*`` ranges that
``dolfinx_external_operator_torch.utils.profiling`` records while a
``torch.profiler`` session runs, read from the same Chrome-trace events as
``harness.trace.Trace`` reads, beside it and in the same way (a span's
device time is that of the operations launched inside it; a gap of the
device goes to the innermost span open where it began).

Two readings ``Trace`` has no counterpart for: the idle that began inside
``deo.host_read`` (the device drained while the host waited on a read,
and stayed idle until the host launched again), and the launch calls made
inside a span, each counted once however many operations it ran (a CUDA
graph's replay is one call)."""

from __future__ import annotations

import bisect

from .trace import DEVICE_CATS, LAUNCH_CATS, WINDOW

PREFIX = "deo."
READ = "deo.host_read"


class ProgramSpans:
    """The ``deo.*`` spans of one traced window, from its Chrome-trace
    events; the window is the ``fembench.window`` span where there is one,
    else the whole trace."""

    def __init__(self, events):
        windows = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("name") == WINDOW]
        device = [e for e in events if e.get("cat") in DEVICE_CATS]
        if windows:
            w0, w1 = windows[0]
        else:
            stamps = [float(e["ts"]) for e in events if "ts" in e]
            w0 = min(stamps, default=0.0)
            w1 = max((float(e["ts"]) + float(e.get("dur", 0.0)) for e in events if "ts" in e),
                     default=0.0)
        self.window_s = (w1 - w0) * 1e-6
        self.spans = sorted(
            ((str(e["name"]), float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(PREFIX)
             and w0 <= float(e["ts"]) <= w1), key=lambda s: s[1])
        launch = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launch[e["args"]["correlation"]] = float(e["ts"])
        self.ops = []  # (start, duration, launch time, correlation), microseconds
        for e in device:
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if ts + dur <= w0 or ts >= w1:
                continue
            corr = e.get("args", {}).get("correlation")
            self.ops.append((ts, dur, launch.get(corr, ts), corr))
        self._counts, self._union = {}, {}
        for name, a, b in self.spans:  # sorted by start: nested spans merge
            self._counts[name] = self._counts.get(name, 0) + 1
            starts, ends = self._union.setdefault(name, ([], []))
            if ends and a <= ends[-1]:
                ends[-1] = max(ends[-1], b)
            else:
                starts.append(a)
                ends.append(b)
        merged = []
        for ts, dur, _, _ in sorted(self.ops):
            a, b = max(ts, w0), min(ts + dur, w1)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        self.idle = self._idle_by_innermost(merged, w0, w1)

    def _inside(self, at, names):
        for name in names:
            starts, ends = self._union.get(name, ((), ()))
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= ends[i]:
                return True
        return False

    def span_count(self, name):
        return self._counts.get(name, 0)

    def device_s_in(self, *names):
        """Device seconds of the operations launched inside a span of any of
        ``names``."""
        return sum(dur for _, dur, at, _ in self.ops if self._inside(at, names)) * 1e-6

    def launches_in(self, *names):
        """Launch calls inside a span of any of ``names``: the operations'
        correlations, each counted once."""
        return len({corr if corr is not None else (at, ts)
                    for ts, _, at, corr in self.ops if self._inside(at, names)})

    def _idle_by_innermost(self, merged, w0, w1):
        """Idle seconds by the innermost ``deo.*`` span open where each gap
        began (outside every one: ``fembench.window``)."""
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

    def read_idle_s(self):
        """Idle seconds in the gaps that began inside a host read."""
        return self.idle.get(READ, 0.0)

    def table(self):
        """{span: {count, device_s, idle_s}} for every ``deo.*`` span."""
        return {name: {"count": self.span_count(name), "device_s": self.device_s_in(name),
                       "idle_s": self.idle.get(name, 0.0)} for name in sorted(self._counts)}

    def per_update(self):
        """The readings per Newton update (one ``deo.solve`` each): host
        reads, idle milliseconds begun in a read, launch calls inside
        ``deo.step``, refinement rounds."""
        updates = self.span_count("deo.solve")
        if not updates:
            return {}
        return {"host_reads_per_update": self.span_count(READ) / updates,
                "read_idle_ms_per_update": 1e3 * self.read_idle_s() / updates,
                "launches_per_update": self.launches_in("deo.step") / updates,
                "refine_rounds_per_update": self.span_count("deo.solve.round") / updates}
