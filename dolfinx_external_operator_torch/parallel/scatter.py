"""Deterministic scatter-adds without atomics.

CUDA's ``index_add_`` adds with atomics, so its sums depend on the order in
which threads arrive.  Every scatter of the port goes through a padded
gather table instead: each destination sums, in increasing order, the
positions that point at it.  Where most destinations of a large flat
array receive nothing (band arrays, ELL value vectors, dense matrices),
the destinations are first deduplicated on the host: the contributions are
summed per unique destination and written once into a zeroed array.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["dedup_table", "dedup_write", "segment_sum", "segment_table"]


def segment_table(seg, n_segments):
    """Padded gather table for a deterministic segment sum: row ``s`` lists,
    in increasing order, the positions ``i`` with ``seg[i] == s``; the pad
    entry is ``len(seg)``, which points at an appended zero.  Segment ids
    outside ``[0, n_segments)`` (padded cells) are dropped."""
    seg = np.asarray(seg, dtype=np.int64).ravel()
    pad = seg.size
    keep = np.flatnonzero((seg >= 0) & (seg < n_segments))
    order = keep[np.argsort(seg[keep], kind="stable")]
    s_sorted = seg[order]
    counts = np.bincount(s_sorted, minlength=n_segments)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(order.size) - starts[s_sorted]
    table = np.full((n_segments, max(int(counts.max(initial=0)), 1)), pad, dtype=np.int64)
    table[s_sorted, slot] = order
    return table


def segment_sum(vals, table):
    """``vals`` flat (m,) -> (n_segments,) sums by ``segment_table``."""
    ext = torch.cat([vals, vals.new_zeros(1)])
    return ext[table].sum(dim=1)


def dedup_table(dst, size, device):
    """Host plan of a scatter-add of flat contributions into ``size`` slots:
    ``dst[i]`` is the slot of contribution ``i`` (entries outside
    ``[0, size)`` are dropped).  Returns ``(table, slots, size)``: the
    gather table over the unique slots, the unique slots, and the size."""
    dst = np.asarray(dst, dtype=np.int64).ravel()
    keep = np.flatnonzero((dst >= 0) & (dst < size))
    slots, inv = np.unique(dst[keep], return_inverse=True)
    seg = np.full(dst.size, -1, dtype=np.int64)
    seg[keep] = inv
    return (torch.as_tensor(segment_table(seg, slots.size), device=device),
            torch.as_tensor(slots, device=device), int(size))


def dedup_write(vals, plan):
    """The scatter-add that ``plan = dedup_table(...)`` describes: a flat
    (size,) array, zero where no contribution lands."""
    table, slots, size = plan
    out = vals.new_zeros(size)
    out[slots] = segment_sum(vals.reshape(-1), table)
    return out
