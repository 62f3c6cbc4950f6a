"""The port's tracing layer: spans, counters and host reads.

* ``span(name, args=None)``: a ``torch.profiler.record_function`` range
  while a ``torch.profiler`` session records, else one shared no-op
  context (the gate costs well under a microsecond; a bare
  ``record_function`` costs about twenty times as much).  The spans land
  in the session's Chrome trace beside the kernels, copies and launches,
  on the profiler's clock, so each gap of the device can be put down to
  what the host was doing.  The program's spans, nested as the calls
  nest:

  ``deo.step``           a load step (``FusedPlasticityStep.run_step``,
                         ``run_step_host``, ``NewtonSolver.solve``); args:
                         the load where the caller gives one
  ``deo.pass``           a Newton pass: the constitutive update, the
                         residual and its norm
  ``deo.constitutive``   the fused step's strain and return map (E1, K1)
  ``deo.residual``       the fused step's residual (E2)
  ``deo.solve``          one Newton update's linear solve
  ``deo.solve.factor``   its factorization (Cholesky, LU, block-cyclic
                         reduction)
  ``deo.solve.setup``    the AMG hierarchy's values (``mg.AMGCG.setup``,
                         both Newton loops)
  ``deo.solve.round``    each refinement round (dense, ``ir_direct``,
                         ``lu_refine``, ``ir_pcg``)
  ``deo.operands``       ``evaluate_operands``
  ``deo.external``       ``evaluate_external_operators`` (the callback)
  ``deo.form.vector``, ``deo.form.matrix``, ``deo.form.action``
                         ``CompiledForm.vector``, ``matrix``, ``action``
  ``deo.host_read``      a device-to-host read (``host_read``)

* ``count(name, n=1)``: always-on Python counters: ``newton.passes``,
  ``newton.updates``, ``solve.rounds``, ``solve.short`` (solves that
  ``ir_direct`` ended above their target), ``host.reads``,
  ``bcr.factorizations``, ``bcr.inv_levels``, ``bcr.round_replays``
  (BCR's refinement rounds replayed from CUDA graphs: all of a solver's
  rounds on the card), ``solve.inner`` (f32 PCG iterations in
  ``mg.ir_pcg``, from its host-side count), ``mg.setups`` (AMG
  hierarchy values set) and ``graphs.captures`` (CUDA graphs captured,
  ``utils.graphs.capture``: BCR's two round graphs, AMG-CG's PCG batches
  and round starts or gmres's cycle, the ICNN map's batch sizes) and
  ``graphs.replays`` (their replays).  ``counters()`` is a
  snapshot of them and of the kernel wrappers' own launch counts
  (``launches.<wrapper>``, read where they live); ``reset_counters()``
  zeroes the registry (not the wrappers' counts).
* ``span_counts()``: how many times each span was entered while a
  session recorded, and ``recorded_counts()``: what the counters added
  while a session recorded, each since the process began or
  ``reset_counters()``.
* ``host_read(t, kind=float)``: ``kind(t)``, counted, inside a
  ``deo.host_read`` span.
* ``trace(logdir)``: records its block into ``logdir/trace.json`` (a
  Chrome trace, viewable in Perfetto) and writes ``logdir/counters.json``,
  the counters over the block.  Inside it only, the Mohr-Coulomb return
  map (K1) also sums on the device its points' count, its listed (plastic)
  lanes and the largest residual it left (``k1.points``, ``k1.listed``,
  ``k1.max_norm_res``), read once when the block closes.

No span or counter changes what the program computes.
"""

from __future__ import annotations

import contextlib
import json
import os

import torch

__all__ = ["span", "count", "counters", "reset_counters", "span_counts", "recorded_counts",
           "host_read", "trace", "k1_tally"]

_recording = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_counts = {}
_spans = {}
_recorded = {}
_k1 = None  # {device: [points, tensor([listed, max norm_res])]} inside trace()


def span(name, args=None):
    """The range ``name`` in a recording profiler's trace, else a no-op;
    ``args`` (any value) is written beside it as text."""
    if not _recording():
        return _NULL
    _spans[name] = _spans.get(name, 0) + 1
    return torch.profiler.record_function(name, None if args is None else str(args))


def count(name, n=1):
    _counts[name] = _counts.get(name, 0) + n
    if _recording():
        _recorded[name] = _recorded.get(name, 0) + n


def host_read(t, kind=float):
    """``kind(t)`` for a device tensor ``t`` (``float``, ``int``, ``bool``,
    ``torch.Tensor.tolist``): the host waits for the device there."""
    count("host.reads")
    if not _recording():
        return kind(t)
    with span("deo.host_read"):
        return kind(t)


def _launches():
    from ..ops import element_chain as ec
    from ..ops import mg_cycle, mohr_coulomb, vonmises

    out = dict(ec.launch_counts())
    out.update(mg_cycle.launch_counts())
    out["mc_return_map"] = mohr_coulomb.mc_return_map.launches
    out["vonmises_return_map"] = vonmises.vonmises_return_map.launches
    out["vonmises_return_map_f64"] = vonmises.vonmises_return_map_f64.launches
    return {f"launches.{k}": v for k, v in out.items()}


def counters():
    """A snapshot: the registry's counters and the wrappers' launch counts."""
    return {**_counts, **_launches()}


def reset_counters():
    _counts.clear()
    _spans.clear()
    _recorded.clear()


def span_counts():
    return dict(_spans)


def recorded_counts():
    return dict(_recorded)


def k1_tally(points, listed, norm_res):
    """Inside ``trace()``: add a return-map call's ``points``, its listed
    lanes (a device integer tensor of one entry) and the largest entry of
    its ``norm_res`` to the block's sums, on the device.  Else nothing."""
    if _k1 is None or points == 0:
        return
    slot = _k1.get(norm_res.device)
    if slot is None:
        slot = _k1[norm_res.device] = [0, torch.zeros(2, dtype=torch.float64,
                                                      device=norm_res.device)]
    slot[0] += points
    acc = slot[1]
    acc[:1] += listed.reshape(1)
    acc[1:] = torch.maximum(acc[1:], norm_res.max().reshape(1))


def _k1_read(sums):
    if not sums:
        return {}
    reads = [(points, acc.tolist()) for points, acc in sums.values()]
    return {"k1.points": sum(p for p, _ in reads),
            "k1.listed": int(sum(a[0] for _, a in reads)),
            "k1.max_norm_res": max(a[1] for _, a in reads)}


@contextlib.contextmanager
def trace(logdir: str | None):
    """Capture a ``torch.profiler`` trace of the block into
    ``logdir/trace.json`` and the counters over the block into
    ``logdir/counters.json`` when ``logdir`` is given; no-op otherwise."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    global _k1
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    before = counters()
    _k1 = {}
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        sums, _k1 = _k1, None
    after = counters()
    out = {k: v - before.get(k, 0) for k, v in after.items()}
    out.update(_k1_read(sums))
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "counters.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
