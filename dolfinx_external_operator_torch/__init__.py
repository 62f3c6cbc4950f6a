"""dolfinx_external_operator_torch — the PyTorch/CUDA port of
``dolfinx_external_operator_tpu``.

The JAX package stays the reference; this package re-implements it slice by
slice on PyTorch, with every Pallas kernel of the JAX package rewritten by
hand for NVIDIA Hopper (``csrc/``).  It imports no JAX: the numpy host
modules it needs are its own copies.

This slice holds the fused plasticity load step
(``parallel.spmd.FusedPlasticityStep``, one device, dense and CG solvers)
driven by the von Mises return map (``models.von_mises``), whose f32 form is
the CUDA kernel ``ops.vonmises``.

Entry points take ``device=None``, meaning ``"cuda"``; without a card they
raise unless the caller passes ``device="cpu"``.
"""

import torch

# f32 phases run true f32, as the JAX package forces with
# ``jax_default_matmul_precision="float32"``; torch's default dtype is left
# alone and every tensor is created with an explicit dtype.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``.  Raises if CUDA is asked for and absent: no
    entry point drops to the CPU unless the caller passes ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


from .assembly import locate_dofs_geometrical, locate_dofs_topological  # noqa: E402
from .elements import element, quadrature_element  # noqa: E402
from .functionspace import functionspace  # noqa: E402
from .mesh import Mesh, create_rectangle, create_unit_square  # noqa: E402
from .models.von_mises import (  # noqa: E402
    VonMisesMaterial,
    batched_kernel_f32,
    batched_kernel_f64,
    return_mapping_kernel,
)
from .ops.vonmises import vonmises_return_map, vonmises_return_map_reference  # noqa: E402
from .parallel.spmd import FusedPlasticityStep  # noqa: E402
from .problems import build_plasticity_block, von_mises_block_step  # noqa: E402

__all__ = [
    "FusedPlasticityStep",
    "Mesh",
    "VonMisesMaterial",
    "batched_kernel_f32",
    "batched_kernel_f64",
    "build_plasticity_block",
    "create_rectangle",
    "create_unit_square",
    "element",
    "functionspace",
    "locate_dofs_geometrical",
    "locate_dofs_topological",
    "quadrature_element",
    "resolve_device",
    "return_mapping_kernel",
    "von_mises_block_step",
    "vonmises_return_map",
    "vonmises_return_map_reference",
]
