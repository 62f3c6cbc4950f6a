"""Clocks: the process's age, and per-step times from CUDA events.

``EventClock`` follows ``chip_smoke.py:430-440`` (``cuda_time_ms``: events
recorded on the stream, read after one synchronise), one event at each step
boundary: a step is tens of milliseconds, too short for the host clock,
whose reading of one step is off by about half a millisecond.  On the CPU (the tests) it
falls back to the host clock."""

from __future__ import annotations

import os
import time

import torch


def process_age_s():
    """Seconds since this process started, from ``/proc`` (10 ms ticks),
    or since the interpreter imported this module where ``/proc`` has no
    record."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class EventClock:
    """Boundary marks; ``intervals_s()`` after the last mark."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_s(self):
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) * 1e-3 for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]
