"""Load-step checkpoint/resume for Gauss-point state.

The port of ``dolfinx_external_operator_tpu/utils/checkpoint.py:24-48``,
in its ``.npz`` layout (``__step__`` and one array per name), so a file
saved by either package loads in the other.  The state (dof vectors,
Gauss-point arrays, the step counter) is read to the host once per save
and written compressed through a temporary file and ``os.replace``;
``load_state`` writes each array into its target Function on that
Function's device.

Cell-sharded (``parallel.set_default_device_mesh``), every rank holds the
state whole: only rank 0 writes, every rank waits for it (a ``psum`` of
a zero), and every rank reads.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..function import Function

__all__ = ["save_state", "load_state"]


def _to_numpy(a):
    a = a.data if isinstance(a, Function) else a
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_state(path: str, step: int, **arrays) -> None:
    """Save named state arrays (Functions, tensors or numpy arrays) plus
    the step; under a device mesh, on rank 0 only."""
    from ..parallel import get_default_device_mesh

    assert path.endswith(".npz"), "checkpoint path must end in .npz"
    out = {"__step__": np.asarray(step)}
    for name, a in arrays.items():
        out[name] = _to_numpy(a)
    device_mesh = get_default_device_mesh()
    if device_mesh is None or device_mesh.rank == 0:
        tmp = path[:-4] + ".tmp.npz"
        np.savez_compressed(tmp, **out)
        os.replace(tmp, path)
    if device_mesh is not None:
        # no rank returns before rank 0 has written the file
        from ..parallel import dist

        dist.psum(torch.zeros(1, device=device_mesh.device), device_mesh.group)


def load_state(path: str, **targets):
    """Restore arrays saved by ``save_state`` (either package's).
    ``targets`` maps name -> Function (its dof vector replaced, on its
    device) or None (returned as a CPU tensor).  Returns (step, {name:
    tensor for None targets})."""
    with np.load(path) as data:
        step = int(data["__step__"])
        extra = {}
        for name, tgt in targets.items():
            arr = data[name]
            if isinstance(tgt, Function):
                tgt.x.array = arr
            else:
                extra[name] = torch.as_tensor(arr)
    return step, extra
