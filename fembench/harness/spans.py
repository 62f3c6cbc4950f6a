"""Spans from the benchmark's own files: a ``record_function`` range around
a callable of the program, put on the instance (or module) that the
benchmark built, in traced runs only.  A callable that is not there (a
later change renamed it) is left alone, and the metric that reads its span
then finds nothing and is left out of the run's line."""

from __future__ import annotations

import functools

import torch


def wrap(owner, attr, span):
    """Put span ``span`` around ``owner.attr``; False where there is none."""
    fn = getattr(owner, attr, None)
    if fn is None or not callable(fn):
        return False

    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with torch.profiler.record_function(span):
            return fn(*args, **kwargs)

    setattr(owner, attr, spanned)
    return True
