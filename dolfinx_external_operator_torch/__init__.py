"""dolfinx_external_operator_torch — the PyTorch/CUDA port of
``dolfinx_external_operator_tpu``.

The JAX package stays the reference; this package re-implements it slice by
slice on PyTorch, with every Pallas kernel of the JAX package rewritten by
hand for NVIDIA Hopper (``csrc/``).  It imports no JAX: the numpy host
modules it needs are its own copies.

Slice 1 holds the fused plasticity load step
(``parallel.spmd.FusedPlasticityStep``, one device, dense and CG solvers)
driven by the von Mises return map (``models.von_mises``), whose f32 form is
the CUDA kernel ``ops.vonmises``.

Slice 2 adds the main path: the Mohr-Coulomb slope load step
(``problems.mohr_coulomb_slope_step``, the 52-step ``SLOPE_LOADS``) with the
Abbo-Sloan surface (``ops.abbo_sloan``), the material and its plain f64
return map (``models.mohr_coulomb``), and the return map as the CUDA kernel
``ops.mohr_coulomb`` (one thread per Gauss point).

The fused step's other solvers: block-cyclic reduction on lattice meshes
(``parallel.bcr``), and CG preconditioned by aggregation AMG
(``parallel.mg``) or by a lagged elastic inverse.

Cell sharding runs one process per rank (``parallel.dist``:
``make_device_mesh``, ``psum``, ``spawn``); ``entry`` and
``dryrun_multichip`` are the counterparts of the JAX package's entry points
(``__graft_entry__.py``).

The general external-operator pipeline, the paper's own subject: the
symbolic form language (``sym``, a copy of the JAX package's),
``Function``/``Constant``, the batched expression evaluator
(``compile``, ``expression``), assembly (``assembly``), the
``FEMExternalOperator`` node with ``evaluate_operands``,
``evaluate_external_operators`` and ``replace_external_operators``
(``external_operator``), the Newton solver (``solvers``, ``petsc``), and the
Mohr-Coulomb slope written the way the reference demo writes it
(``models.mohr_coulomb.build_slope_problem``), with K1 as the operator's
callback.  Its linear solvers: the dense f32 LU with f64 refinement, and
element-by-element CG, GMRES and BiCGStab (``krylov``) with Jacobi or
aggregation-AMG preconditioning; bound-constrained Newton
(``vinewtonrsls``).  Through it run the reference's other demos: the von
Mises cylinder (``models.von_mises.solve_von_mises`` and its pure-form
twin) and the ICNN hyperelasticity model (``models.icnn``,
``models.hyperelasticity``).

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


from . import sym  # noqa: E402
from .assembly import (  # noqa: E402
    DirichletBC,
    apply_lifting,
    assemble_matrix,
    assemble_scalar,
    assemble_vector,
    create_form,
    dirichletbc,
    form,
    locate_dofs_geometrical,
    locate_dofs_topological,
    set_bc,
)
from .dtypes import default_scalar_type, scalar_type_context  # noqa: E402
from .elements import element, mixed_element, quadrature_element  # noqa: E402
from .entry import dryrun_multichip, entry  # noqa: E402
from .expression import Expression  # noqa: E402
from .external_operator import (  # noqa: E402
    FEMExternalOperator,
    evaluate_external_operators,
    evaluate_operands,
    replace_external_operators,
    unique_external_operators,
)
from .function import Constant, Function  # noqa: E402
from .functionspace import DualSpace, FunctionSpace, functionspace  # noqa: E402
from .mesh import (  # noqa: E402
    Mesh,
    build_cylinder_quarter,
    build_square_with_elliptic_holes,
    create_box,
    create_interval,
    create_rectangle,
    create_unit_cube,
    create_unit_interval,
    create_unit_square,
    locate_entities_boundary,
)
from .models.mohr_coulomb import MohrCoulombMaterial  # noqa: E402
from .models.von_mises import (  # noqa: E402
    VonMisesMaterial,
    batched_kernel_f32,
    batched_kernel_f64,
    return_mapping_kernel,
)
from .ops.mohr_coulomb import mc_return_map  # noqa: E402
from .ops.vonmises import vonmises_return_map, vonmises_return_map_reference  # noqa: E402
from .parallel.dist import make_device_mesh  # noqa: E402
from .parallel.spmd import FusedPlasticityStep  # noqa: E402
from .problems import (  # noqa: E402
    SLOPE_LOADS,
    build_plasticity_block,
    mohr_coulomb_slope_step,
    von_mises_block_step,
)
from .quadrature import make_quadrature  # noqa: E402
from .sym import (  # noqa: E402
    FacetNormal,
    Form,
    Identity,
    Measure,
    SpatialCoordinate,
    TestFunction,
    TrialFunction,
    action,
    adjoint,
    arcsin,
    as_matrix,
    as_tensor,
    as_vector,
    cos,
    derivative,
    dev,
    div,
    dot,
    exp,
    expand_derivatives,
    grad,
    inner,
    ln,
    outer,
    sign,
    sin,
    sqrt,
    tan,
    tr,
    transpose,
)
from .sym import sym as symmetric  # noqa: E402

from . import petsc, solvers  # noqa: E402

__all__ = [
    # the reference package's exports
    "DualSpace",
    "FEMExternalOperator",
    "FunctionSpace",
    "evaluate_external_operators",
    "evaluate_operands",
    "functionspace",
    "petsc",
    "replace_external_operators",
    # the form layer
    "Mesh", "create_unit_square", "create_rectangle", "create_unit_interval",
    "create_interval", "create_unit_cube", "create_box",
    "build_cylinder_quarter", "build_square_with_elliptic_holes",
    "locate_entities_boundary",
    "element", "quadrature_element", "mixed_element", "make_quadrature",
    "Function", "Constant", "Expression",
    "TestFunction", "TrialFunction", "Measure", "Form",
    "SpatialCoordinate", "FacetNormal", "Identity",
    "grad", "div", "inner", "dot", "outer", "tr", "dev", "transpose",
    "symmetric", "sqrt", "exp", "ln", "sin", "cos", "tan", "arcsin",
    "sign", "as_vector", "as_matrix", "as_tensor",
    "derivative", "expand_derivatives", "action", "adjoint",
    "assemble_scalar", "assemble_vector", "assemble_matrix",
    "create_form", "form",
    "DirichletBC", "dirichletbc", "locate_dofs_topological",
    "locate_dofs_geometrical", "apply_lifting", "set_bc",
    "solvers", "sym", "unique_external_operators",
    "scalar_type_context", "default_scalar_type",
    # the fused step, the kernels and the entry points
    "FusedPlasticityStep",
    "MohrCoulombMaterial",
    "SLOPE_LOADS",
    "VonMisesMaterial",
    "batched_kernel_f32",
    "batched_kernel_f64",
    "build_plasticity_block",
    "dryrun_multichip",
    "entry",
    "make_device_mesh",
    "mc_return_map",
    "mohr_coulomb_slope_step",
    "resolve_device",
    "return_mapping_kernel",
    "von_mises_block_step",
    "vonmises_return_map",
    "vonmises_return_map_reference",
]
