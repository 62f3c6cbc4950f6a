"""CUDA-graph replay of the solvers' fixed work: the one rule of where it
may replay, and the one routine that captures it.

A solver's f32 iteration on the card is hundreds of small launches over
tensors that stay put between calls (an AMG cycle, a batch of PCG
iterations, a BCR refinement round, the ICNN's batched tangent); captured
once in a CUDA graph, each call is one replay.  A graph can hold an NCCL
all-reduce, not gloo's, which stages through the host (``replayable``).
``capture`` makes one eager call first, on the current stream: first-use
work (library handles, workspaces) stays out of the graph, and a new
stream per capture would give cuBLAS a workspace that it keeps.
"""

from __future__ import annotations

import gc

import torch

from .profiling import count

__all__ = ["capture", "replayable"]


def replayable(device, device_mesh=None, collective=True):
    """Whether work on ``device`` may replay from a CUDA graph: on the card,
    and without a ``device_mesh`` (``parallel.dist.DeviceMesh``), or with
    no ``collective`` in the work, or with NCCL as the mesh's backend."""
    return device.type == "cuda" and (device_mesh is None or not collective
                                      or device_mesh.backend == "nccl")


def _tensors(a):
    """The tensors an argument holds: itself, a dict's values, or none."""
    if isinstance(a, torch.Tensor):
        return (a,)
    return tuple(a.values()) if isinstance(a, dict) else ()


def capture(fn, *args, pool=None):
    """``fn(*args)`` captured once in a CUDA graph over copies of its
    tensor arguments (a tensor, or a dict of tensors; any other argument is
    passed as it is).  Returns ``run(*args)``: it copies its tensor
    arguments in, replays, and returns the graph's outputs, which the next
    replay overwrites.  ``run.pool`` is the graph's memory pool; a later
    capture given it as ``pool`` shares it.  Where a tensor argument is not
    on the card there is nothing to capture, and ``run`` is ``fn``.
    Counts ``graphs.captures`` a capture and ``graphs.replays`` a replay."""
    if not all(replayable(t.device) for a in args for t in _tensors(a)):
        return fn
    inputs = [a.clone() if isinstance(a, torch.Tensor)
              else {k: v.clone() for k, v in a.items()} if isinstance(a, dict) else a
              for a in args]
    fn(*inputs)
    graph = torch.cuda.CUDAGraph()
    # no cyclic garbage collection while capturing: a graph it frees (an
    # earlier solver's, held in a reference cycle) invalidates the capture
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            out = fn(*inputs)
    finally:
        if collecting:
            gc.enable()
    count("graphs.captures")

    def run(*args):
        for dst, src in zip(inputs, args):
            if isinstance(dst, dict):
                for k, v in src.items():
                    dst[k].copy_(v)
            elif isinstance(dst, torch.Tensor):
                dst.copy_(src)
        graph.replay()
        count("graphs.replays")
        return out

    run.pool = graph.pool()
    return run
