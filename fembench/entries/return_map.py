"""The constitutive operator alone: the material's ``batched_kernel`` (the
hand-written kernel K1 on the card), the callback that both paths evaluate
once a Newton pass, called back to back over a pool of strain batches of
the configuration's Gauss-point count, cycled in order.  The host never
waits inside the window: the calls queue, and the window ends with a
synchronise.  The latest output of each batch is kept for judging."""

from __future__ import annotations

import contextlib
import time

import torch

from ..harness.timing import sync
from ..harness.trace import window_span
from ..harness.traffic import strain_pool
from .common import port_material


class Window:
    def __init__(self):
        self.calls = 0
        self.seconds = 0.0
        self.failed = 0


class Cell:
    kind = "calls"

    def __init__(self, config, traffic, factor, device, seed, spans=False):
        self.material = port_material(config["material"], factor)
        self.kernel = self.material.batched_kernel(traffic["route"])
        m = config["mesh"]
        self.points = 2 * m["Nx"] * m["Ny"] * config["quadrature_points_per_cell"]
        self.deps, self.sigma_n = strain_pool(traffic["mix"], self.points, seed, device)
        self.device = device
        self.spans = spans
        self.latest = [None] * self.deps.shape[0]

    def warm(self, loads):
        for k in range(self.deps.shape[0]):
            self.latest[k] = self.kernel(self.deps[k], self.sigma_n[k])

    def run(self, seconds=None, calls=None):
        w, nb = Window(), self.deps.shape[0]
        sync(self.device)
        with window_span() if self.spans else contextlib.nullcontext():
            t0 = time.perf_counter()
            while True:
                k = w.calls % nb
                with (torch.profiler.record_function("fembench.k1_call") if self.spans
                      else contextlib.nullcontext()):
                    self.latest[k] = self.kernel(self.deps[k], self.sigma_n[k])
                w.calls += 1
                if calls is not None and w.calls == calls:
                    break
                if calls is None and time.perf_counter() - t0 >= seconds:
                    break
            sync(self.device)
            w.seconds = time.perf_counter() - t0
        return w

    def batches(self):
        """Each batch's inputs and the program's latest outputs."""
        return [{"deps": self.deps[k], "sigma_n": self.sigma_n[k], "tangent": C, "sigma": s}
                for k, (C, s) in enumerate(self.latest) if C is not None]

    def counts(self):
        return {"points": self.points, "batches": self.deps.shape[0]}
