"""Cell sharding over ``torch.distributed`` ranks: the mesh, the two
collectives, and a launcher.

The JAX package shards the fused step's cell axis over a 1D
``jax.sharding.Mesh`` with ``shard_map`` and sums every scatter with
``psum`` (``dolfinx_external_operator_tpu/parallel/spmd.py:45-49``,
``:955-989``).  PyTorch's idiom is one process per rank: each rank owns a
slice of the cells and holds every dof vector whole, and each scatter is
the rank's own segment sum followed by one ``all_reduce(SUM)``
(``psum``).  The general pipeline also gathers the rank's rows of a
batch into the whole batch (``all_gather``), where the JAX package's
global arrays are whole by construction.  ``spawn`` starts the ranks on
one host, the counterpart of the reference CI's ``mpirun -n 3``.

Backends: NCCL, one rank per card; gloo on the CPU, and gloo with CUDA
tensors for several ranks on one card (NCCL refuses two ranks on one
GPU; gloo stages each CUDA all-reduce through the host).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from .. import resolve_device

__all__ = ["DeviceMesh", "all_gather", "make_device_mesh", "psum", "spawn"]

# a rank that waits longer than this in a collective raises
_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """One rank's view of the 1D mesh over the cell axis (the JAX
    package's ``"cells"``): its process group, its rank and the group's
    size, the device its tensors live on, and the group's backend."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str


def _rank_device(rank, device=None):
    """The device of ``rank``: the CPU, or card ``rank % device_count``
    (``None`` means CUDA and raises without a card)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_device_mesh(n_devices=None, backend=None, device=None):
    """The calling rank's ``DeviceMesh`` over all ranks, the counterpart of
    the JAX package's ``make_device_mesh``.  Called in every rank after
    ``torch.distributed.init_process_group`` (``spawn`` does both).

    ``n_devices``: the rank count the caller expects (the world size; a
    mesh over fewer ranks than the world is not supported).  ``backend``:
    the world's backend, which the mesh's group is; ``"gloo"`` with CUDA
    tensors puts several ranks on one card.  ``device``: ``"cpu"``, or
    ``None``/``"cuda"``, which puts rank r on card ``r % device_count``;
    NCCL needs one card per rank."""
    if not tdist.is_initialized():
        raise RuntimeError("make_device_mesh runs in a rank after "
                           "torch.distributed.init_process_group (see parallel.dist.spawn)")
    size, rank = tdist.get_world_size(), tdist.get_rank()
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"a mesh of {n_devices} ranks in a world of {size}: the mesh spans "
                         "every rank")
    world_backend = tdist.get_backend()
    backend = backend or world_backend
    if backend != world_backend:
        raise ValueError(f"backend {backend!r} in a {world_backend!r} world: start the ranks "
                         f"with the backend the mesh needs (spawn(fn, n, {backend!r}, ...))")
    group = tdist.group.WORLD
    dev = _rank_device(rank, device)
    if backend == "nccl" and (dev.type != "cuda" or size > torch.cuda.device_count()):
        raise ValueError(f"NCCL needs one card per rank: {size} ranks, "
                         f"{torch.cuda.device_count()} cards; use backend='gloo'")
    return DeviceMesh(group, rank, size, dev, backend)


def psum(x, group=None):
    """Sum of ``x`` over the ranks of ``group``, in place; returns it.

    Every collective of the sharded step goes through this function, and
    ``psum.calls`` counts them.  Every rank receives the same bits: the
    sharded Newton and Krylov loops branch on host floats derived from
    these sums, and ranks that branched apart would deadlock."""
    psum.calls += 1
    tdist.all_reduce(x, op=tdist.ReduceOp.SUM, group=group)
    return x


psum.calls = 0


def all_gather(x, n=None, group=None):
    """The whole of a batch cut in equal blocks over the ranks of
    ``group``: each rank passes its block ``x`` (``k`` rows, the same ``k``
    on every rank), every rank receives the ``size * k`` rows in rank
    order, cut to the first ``n`` (the padding sliced off).

    Every gather of the general pipeline goes through this function, and
    ``all_gather.calls`` counts them.  Gloo gathers CUDA tensors too
    (staged through the host), so several ranks on one card use it as
    they use ``psum``."""
    all_gather.calls += 1
    parts = [torch.empty_like(x) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(parts, x.contiguous(), group=group)
    whole = torch.cat(parts)
    return whole if n is None else whole[:n]


all_gather.calls = 0


def _rank_main(rank, fn, n, backend, device, tmp, args, kwargs):
    """One rank of ``spawn``: rendezvous through a file, run ``fn`` on the
    rank's mesh, write its result for the caller."""
    torch.set_num_threads(1)
    dev = _rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = tdist.FileStore(os.path.join(tmp, "store"), n)
    tdist.init_process_group(backend, store=store, rank=rank, world_size=n, timeout=_TIMEOUT)
    try:
        out = fn(make_device_mesh(n, device=dev), *args, **kwargs)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        tdist.destroy_process_group()


def spawn(fn, n, backend, device, *args, **kwargs):
    """Run ``fn(mesh, *args, **kwargs)`` on ``n`` ranks, one process each,
    and return the ranks' results in rank order.

    The processes start with the ``spawn`` method, so ``fn`` and its
    arguments are pickled: ``fn`` must be a module-level function of a
    module that imports no JAX (the ranks import it anew).  The ranks meet through a
    ``FileStore`` in a temporary directory (no network port) and run with
    one intra-op thread each.  ``fn`` returns host values (numbers, numpy
    arrays, CPU tensors).  A rank that raises ends the others and raises
    here."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(fn, n, backend, device, tmp, args, kwargs),
                           nprocs=n, join=True, start_method="spawn")
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
