"""The fused step's element chain: per-cell products of fixed summation
order.

The JAX package computes these as XLA einsums (``parallel/spmd.py:493``
strain, ``:508`` residual, ``:514-516`` tangent matvec, ``:521``
diagonal, the element blocks at ``:612``, ``:651``, ``:745``, ``:794``,
``:947``, the element-blocked matvec ``_ebe`` at ``:617-620``).  Here each
is one hand-written kernel (``csrc/element_chain.cu``, bodies in
``csrc/element_chain.cuh``) beside its plain PyTorch version:

* E1 ``cell_strain``: ``deps[c,q,i] = sum_k B[c,q,i,k] u[dofmap[c,k]]``;
* E2 ``cell_residual``: ``r[c,k] = sum_q w[c,q] sum_i B[c,q,i,k] sig[c,q,i]``;
* E3 ``cell_tangent``: the tangent matvec against a gathered vector, its
  diagonal, and the element blocks ``K[c,k,l]`` in f64 or f32 (masked by
  ``keep`` where given);
* E4 ``ebe_cell_matvec``: ``y[c,a] = sum_b K[c,a,b] x[idx[c,b]]``, per dof
  (``bs = 1``) or per node (``bs = 2``), in f32 or f64: the AMG plan's
  element-blocked matvec and the general pipeline's matrix-free action;
* E5 ``cell_product``: a two-operand einsum with one contracted index, a
  batched product ``out[b0,b1,m,n] = sum_k A[b0,b1,m,k] B[b0,b1,k,n]`` at
  any strides (a table broadcast over the cells by stride 0), in f64 or
  f32: the general pipeline's operand evaluation (``assembly.py``, the
  JAX package's ``assembly.py:114-139``); ``cell_values_grads``, one
  coefficient's values and gradients at the points, two such products
  in one launch; and ``cell_triple``, the AMG setup's level-1 triple
  ``(W^T K) W`` (``parallel/mg.py``, the JAX package's
  ``parallel/mg.py:890``), one launch at the repo's shape, else two
  products.

On CUDA tensors each launches its kernel, in which every output is one
sum in a fixed order that depends on nothing but the output's indices: a
rank's cells give the whole batch's bits, on any slice.  On CPU tensors
each runs its plain version (``*_reference``: the einsums and ``torch.bmm``
that the fused step ran before), so the CPU bits stay those of the JAX
comparisons.  There is no fallback from the kernel to the plain version.
``*_host`` runs the kernel's own bodies, built with g++, on CPU tensors
(tests only): they give the card's bits (every operation of the bodies
rounds once, fused multiply-adds spelt out).

Each wrapper counts its kernel launches (``.launches``).  The wrappers
take B, w, the index maps and x contiguous, sigma, the tangent and the
blocks at any strides (the return maps hand them as views), and raise on
anything else.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

import torch
import torch.nn.functional as F

__all__ = ["cell_strain", "cell_residual", "cell_tangent", "ebe_cell_matvec", "cell_product",
           "cell_values_grads", "cell_triple", "cell_strain_reference", "cell_residual_reference",
           "cell_tangent_reference", "ebe_cell_matvec_reference", "cell_product_reference",
           "cell_values_grads_reference", "cell_triple_reference", "cell_strain_host",
           "cell_residual_host", "cell_tangent_host", "ebe_cell_matvec_host",
           "cell_product_host", "cell_values_grads_host", "cell_triple_host", "TANGENT_MODES",
           "VALUES_EQ", "GRADS_EQ", "max_components", "staged_cells", "staged_quad",
           "staged_e5", "reset_launches", "launch_counts"]

_F64, _F32, _I64 = torch.float64, torch.float32, torch.int64
# E3's modes, as the launcher numbers them ("blocks" in f32 is mode 3)
TANGENT_MODES = ("matvec", "diag", "blocks")


_CSRC = Path(__file__).resolve().parent.parent / "csrc"


@functools.cache
def max_components():
    """The strain components a Gauss point may have: ``kEcMaxComp`` of
    ``csrc/element_chain.cuh``, which sizes the kernels' per-thread
    arrays."""
    text = (_CSRC / "element_chain.cuh").read_text()
    return int(re.search(r"constexpr int kEcMaxComp = (\d+);", text).group(1))


@functools.cache
def staged_cells():
    """``(na, nb, G)``: E1 (``na = nq * ni``, ``nb = nk``) and E4 at this
    shape run staged, G cells a block (``csrc/element_chain.cu``); every
    other shape runs one thread an output without staging."""
    text = (_CSRC / "element_chain.cu").read_text()
    num = {k: int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
           for k in ("kThreads", "kStagedNA", "kStagedNB")}
    return num["kStagedNA"], num["kStagedNB"], num["kThreads"] // num["kStagedNA"]


@functools.cache
def staged_quad():
    """``(nq, ni, nk, G, Gb)``: E2 and E3 at this shape (``nq`` points of
    ``ni`` components, ``nk`` dofs a cell) run staged, the matvec G cells
    a block and the blocks Gb (``csrc/element_chain.cuh``); every other
    shape runs one thread an output without staging."""
    text = (_CSRC / "element_chain.cuh").read_text()
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
                 for k in ("kEcNQ", "kEcNI", "kEcNK", "kEcVecCells", "kEcBlockCells"))


@functools.cache
def staged_e5():
    """E5's staged shapes (``csrc/element_chain.cuh``): ``product_nk`` the
    summed lengths of the staged product and pair, ``pair_ng`` the pair's
    gradient width, ``pair_threads`` its block (a cell's nq bs (1 + ng)
    outputs must fit it), ``table`` the most elements of a table staged
    in shared memory, ``triple`` ``(nk, na, G)`` the level-1 triple's W
    (nc, nk, na), G cells a block."""
    text = (_CSRC / "element_chain.cuh").read_text()

    def num(k):
        return int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))

    nk = re.search(r"constexpr int kEcProductNK\[\] = \{([\d, ]+)\};", text).group(1)
    return {"product_nk": tuple(int(v) for v in nk.split(",")), "pair_ng": num("kEcPairNG"),
            "pair_threads": num("kEcPairThreads"), "table": num("kEcTableMax"),
            "triple": tuple(num(k) for k in ("kEcTripleNK", "kEcTripleNA", "kEcTripleCells"))}


def _need(name, t, dtype, ndim, device, contiguous=True):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _shape(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def _check_B(B):
    if B.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {B.device}")
    _need("B", B, _F64, 4, B.device)
    nc, nq, ni, nk = B.shape
    if not 0 < ni <= max_components():
        raise ValueError(f"B has {ni} strain components, at most {max_components()} are taken")
    return nc, nq, ni, nk


def _check_gather(dofmap, u, nc, nk, device):
    _need("dofmap", dofmap, _I64, 2, device)
    _shape("dofmap", dofmap, (nc, nk))
    _need("x", u, _F64, 1, device)


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _on_current(device):
    """The launchers run on the runtime's current device."""
    if device.index != torch.cuda.current_device():
        raise ValueError(f"inputs lie on {device}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _launched(name, err):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _gather(u, dofmap):
    """u at the cells' dofs, the padding index ``n`` reading 0."""
    return torch.cat([u, u.new_zeros(1)])[dofmap]


# ----------------------------------------------------------------------
# E1: strain
def cell_strain_reference(B, dofmap, u):
    """Plain version: (nc, nq, ni) f64."""
    return torch.einsum("cqik,ck->cqi", B, _gather(u, dofmap))


def _strain_args(B, dofmap, u, alloc=True):
    nc, nq, ni, nk = _check_B(B)
    _check_gather(dofmap, u, nc, nk, B.device)
    if not alloc:
        return None, None
    out = torch.empty((nc, nq, ni), dtype=_F64, device=B.device)
    return out, (B.data_ptr(), dofmap.data_ptr(), u.data_ptr(), u.shape[0], out.data_ptr(),
                 nc, nq, ni, nk)


def cell_strain(B, dofmap, u):
    """E1: B (nc, nq, ni, nk), dofmap (nc, nk) int64 (an index >= n is
    padding and reads 0), u (n,) -> deps (nc, nq, ni), all f64."""
    if B.device.type == "cpu":
        _strain_args(B, dofmap, u, alloc=False)
        return cell_strain_reference(B, dofmap, u)
    from .._native.cuda import cuda_function

    out, args = _strain_args(B, dofmap, u)
    _on_current(B.device)
    _launched("cell_strain", cuda_function("cell_strain")(*args, _stream()))
    cell_strain.launches += 1
    return out


def cell_strain_host(B, dofmap, u):
    """E1's bodies built with g++, on CPU tensors (tests only)."""
    from .._native.cuda import host_function

    out, args = _strain_args(B, dofmap, u)
    host_function("cell_strain")(*args)
    return out


# ----------------------------------------------------------------------
# E2: residual
def cell_residual_reference(B, sigma, wdet):
    """Plain version: (nc, nk) f64."""
    return torch.einsum("cqik,cqi,cq->ck", B, sigma, wdet)


def _residual_args(B, sigma, wdet, alloc=True):
    nc, nq, ni, nk = _check_B(B)
    _need("sigma", sigma, _F64, 3, B.device, contiguous=False)
    _shape("sigma", sigma, (nc, nq, ni))
    _need("wdet", wdet, _F64, 2, B.device)
    _shape("wdet", wdet, (nc, nq))
    if not alloc:
        return None, None
    out = torch.empty((nc, nk), dtype=_F64, device=B.device)
    return out, (B.data_ptr(), sigma.data_ptr(), *sigma.stride(), wdet.data_ptr(),
                 out.data_ptr(), nc, nq, ni, nk)


def cell_residual(B, sigma, wdet):
    """E2: B (nc, nq, ni, nk), sigma (nc, nq, ni) at any strides, wdet (nc,
    nq) -> r (nc, nk), all f64."""
    if B.device.type == "cpu":
        _residual_args(B, sigma, wdet, alloc=False)
        return cell_residual_reference(B, sigma, wdet)
    from .._native.cuda import cuda_function

    out, args = _residual_args(B, sigma, wdet)
    _on_current(B.device)
    _launched("cell_residual", cuda_function("cell_residual")(*args, _stream()))
    cell_residual.launches += 1
    return out


def _staged_host(name, args, what):
    """Runs the staged CPU entry ``name``, which returns 1, writing
    nothing, off its staged shapes."""
    from .._native.cuda import host_function

    if host_function(name)(*args) != 0:
        raise ValueError(f"{name}: {what} is not the staged shape")


def _quad(args):
    return f"(nq, ni, nk) = {args[-3:]}, staged {staged_quad()[:3]},"


def cell_residual_host(B, sigma, wdet, staged=False):
    """E2's bodies built with g++, on CPU tensors (tests only); with
    ``staged`` the staged kernel's loads and stages, over its groups of
    cells (the staged shape only)."""
    from .._native.cuda import host_function

    out, args = _residual_args(B, sigma, wdet)
    if staged:
        _staged_host("cell_residual_staged", args, _quad(args))
    else:
        host_function("cell_residual")(*args)
    return out


# ----------------------------------------------------------------------
# E3: tangent
def cell_tangent_reference(mode, B, C, wdet, dofmap=None, x=None, keep=None, dtype=_F64):
    """Plain version of ``cell_tangent``."""
    if mode == "matvec":
        dde = torch.einsum("cqik,ck->cqi", B, _gather(x, dofmap))
        dsig = torch.einsum("cqij,cqj->cqi", C, dde)
        return torch.einsum("cqik,cqi,cq->ck", B, dsig, wdet)
    if mode == "diag":
        return torch.einsum("cqik,cqij,cqjk,cq->ck", B, C, B, wdet)
    if dtype == _F64:
        K = torch.einsum("cqik,cqij,cqjl,cq->ckl", B, C, B, wdet)
    else:
        K = torch.einsum("cqik,cqij,cqjl,cq->ckl", B.to(_F32), C.to(_F32), B.to(_F32),
                         wdet.to(_F32))
    if keep is None:
        return K
    km = keep.to(dtype)
    return K * km[:, :, None] * km[:, None, :]


def _tangent_args(mode, B, C, wdet, dofmap, x, keep, dtype, alloc=True):
    if mode not in TANGENT_MODES:
        raise ValueError(f"cell_tangent mode must be one of {TANGENT_MODES}, got {mode!r}")
    nc, nq, ni, nk = _check_B(B)
    dev = B.device
    _need("C", C, _F64, 4, dev, contiguous=False)
    _shape("C", C, (nc, nq, ni, ni))
    _need("wdet", wdet, _F64, 2, dev)
    _shape("wdet", wdet, (nc, nq))
    if (mode == "matvec") != (dofmap is not None and x is not None):
        raise ValueError("the matvec takes dofmap and x; the other modes take neither")
    if mode == "matvec":
        _check_gather(dofmap, x, nc, nk, dev)
    if keep is not None:
        if mode != "blocks":
            raise ValueError("keep masks the blocks only")
        _need("keep", keep, _F64, 2, dev)
        _shape("keep", keep, (nc, nk))
    if dtype not in (_F64, _F32) or (dtype == _F32 and mode != "blocks"):
        raise TypeError(f"the {mode} is computed in float64 (blocks also in float32), "
                        f"not {dtype}")
    if not alloc:
        return None, None
    shape = (nc, nk, nk) if mode == "blocks" else (nc, nk)
    out = torch.empty(shape, dtype=dtype, device=dev)
    code = TANGENT_MODES.index(mode) + (dtype == _F32)
    return out, (code, B.data_ptr(), C.data_ptr(), *C.stride(), wdet.data_ptr(),
                 None if dofmap is None else dofmap.data_ptr(),
                 None if x is None else x.data_ptr(), 0 if x is None else x.shape[0],
                 None if keep is None else keep.data_ptr(), out.data_ptr(), nc, nq, ni, nk)


def cell_tangent(mode, B, C, wdet, dofmap=None, x=None, keep=None, dtype=_F64):
    """E3, one kernel in three modes; B (nc, nq, ni, nk), the tangent C (nc,
    nq, ni, ni) at any strides and wdet (nc, nq), all f64:

    * ``"matvec"``: with dofmap (nc, nk) int64 and x (n,) f64 (an index
      >= n reads 0) -> (nc, nk) f64, the cells' ``B^T C B x``;
    * ``"diag"``: -> (nc, nk) f64, the blocks' diagonal (the same bits as
      the f64 blocks' diagonal);
    * ``"blocks"``: -> (nc, nk, nk) in ``dtype`` (f64, or f32 from the
      inputs rounded to f32), masked ``K * keep_k * keep_l`` by keep
      (nc, nk) f64 where given."""
    if B.device.type == "cpu":
        _tangent_args(mode, B, C, wdet, dofmap, x, keep, dtype, alloc=False)
        return cell_tangent_reference(mode, B, C, wdet, dofmap, x, keep, dtype)
    from .._native.cuda import cuda_function

    out, args = _tangent_args(mode, B, C, wdet, dofmap, x, keep, dtype)
    _on_current(B.device)
    _launched("cell_tangent", cuda_function("cell_tangent")(*args, _stream()))
    cell_tangent.launches += 1
    return out


def cell_tangent_host(mode, B, C, wdet, dofmap=None, x=None, keep=None, dtype=_F64,
                      staged=False):
    """E3's bodies built with g++, on CPU tensors (tests only); with
    ``staged`` the staged kernels' loads and stages, over their groups of
    cells (the staged shape only)."""
    from .._native.cuda import host_function

    out, args = _tangent_args(mode, B, C, wdet, dofmap, x, keep, dtype)
    if staged:
        _staged_host("cell_tangent_staged", args, _quad(args))
    else:
        host_function("cell_tangent")(*args)
    return out


# ----------------------------------------------------------------------
# E4: element-blocked matvec
def ebe_cell_matvec_reference(K, idx, x, bs):
    """Plain version: ``torch.bmm`` of the blocks with the gathered x."""
    nc, na, nb = K.shape
    if bs == 1:
        u = F.pad(x, (0, 1))
        return torch.bmm(K, u[idx].unsqueeze(-1)).view(nc, na)
    u = F.pad(x.view(-1, bs), (0, 0, 0, 1))
    return torch.bmm(K, u[idx].view(nc, nb, 1)).view(nc, na)


def _ebe_args(K, idx, x, bs, alloc=True):
    if K.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {K.device}")
    if K.dtype not in (_F64, _F32):
        raise TypeError(f"K must be float64 or float32, got {K.dtype}")
    _need("K", K, K.dtype, 3, K.device, contiguous=False)
    nc, na, nb = K.shape
    if bs not in (1, 2) or nb % bs:
        raise ValueError(f"K's {nb} columns are not gathered by {bs} dofs a node")
    _need("idx", idx, _I64, 2, K.device)
    _shape("idx", idx, (nc, nb // bs))
    _need("x", x, K.dtype, 1, K.device)
    if x.shape[0] % bs:
        raise ValueError(f"x's length {x.shape[0]} is not a multiple of {bs}")
    if not alloc:
        return None, None
    out = torch.empty((nc, na), dtype=K.dtype, device=K.device)
    return out, (int(K.dtype == _F32), K.data_ptr(), *K.stride(), idx.data_ptr(), x.data_ptr(),
                 x.shape[0], out.data_ptr(), nc, na, nb, bs)


def ebe_cell_matvec(K, idx, x, bs):
    """E4: the blocks K (nc, na, nb) in f64 or f32, at any strides, against
    x (n,) of the same dtype, gathered by ``idx`` (nc, nb // bs) int64 per
    node of ``bs`` dofs (dof ``idx * bs + b % bs``; a node past the end is
    padding and reads 0) -> (nc, na)."""
    if K.device.type == "cpu":
        _ebe_args(K, idx, x, bs, alloc=False)
        return ebe_cell_matvec_reference(K, idx, x, bs)
    from .._native.cuda import cuda_function

    out, args = _ebe_args(K, idx, x, bs)
    _on_current(K.device)
    _launched("ebe_matvec", cuda_function("ebe_matvec")(*args, _stream()))
    ebe_cell_matvec.launches += 1
    return out


def ebe_cell_matvec_host(K, idx, x, bs):
    """E4's bodies built with g++, on CPU tensors (tests only)."""
    from .._native.cuda import host_function

    out, args = _ebe_args(K, idx, x, bs)
    host_function("ebe_matvec")(*args)
    return out


# ----------------------------------------------------------------------
# E5: batched product
@functools.cache
def _product_plan(eq):
    """For a two-operand einsum ``eq`` with one contracted index: each
    output index's axis in the first and in the second operand (None where
    that operand lacks it), and the contracted index's axis in each."""
    eq = eq.replace(" ", "")
    ins, arrow, out = eq.partition("->")
    subs = ins.split(",")
    if not arrow or len(subs) != 2 or "." in eq:
        raise ValueError(f"cell_product takes 'ab,cd->ef' with two operands, got {eq!r}")
    x, y = subs
    for s in (x, y, out):
        if len(set(s)) != len(s):
            raise ValueError(f"cell_product: an index repeats within {s!r} of {eq!r}")
    summed = (set(x) | set(y)) - set(out)
    if len(summed) != 1 or not all(i in x and i in y for i in summed):
        raise ValueError(f"cell_product sums one index that both operands have: {eq!r}")
    if set(out) - set(x) - set(y) or len(out) > 4:
        raise ValueError(f"cell_product's output takes at most 4 of the operands' indices: "
                         f"{eq!r}")
    (k,) = summed
    axes = tuple((x.index(i) if i in x else None, y.index(i) if i in y else None) for i in out)
    return axes, (x.index(k), y.index(k)), len(x), len(y)


def cell_product_reference(eq, x, y):
    """Plain version: ``torch.einsum(eq, x, y)``."""
    return torch.einsum(eq, x, y)


def _product_args(eq, x, y, alloc=True):
    axes, (kx, ky), nx, ny = _product_plan(eq)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (_F64, _F32):
        raise TypeError(f"cell_product takes float64 or float32, got {x.dtype}")
    _need("x", x, x.dtype, nx, x.device, contiguous=False)
    _need("y", y, x.dtype, ny, x.device, contiguous=False)
    if x.shape[kx] != y.shape[ky]:
        raise ValueError(f"{eq}: the summed axis has {x.shape[kx]} and {y.shape[ky]} entries")
    shape, sx, sy = [], [], []
    for ax, ay in axes:
        if ax is not None and ay is not None and x.shape[ax] != y.shape[ay]:
            raise ValueError(f"{eq}: shapes {tuple(x.shape)} and {tuple(y.shape)} disagree")
        shape.append(x.shape[ax] if ax is not None else y.shape[ay])
        sx.append(0 if ax is None else x.stride(ax))
        sy.append(0 if ay is None else y.stride(ay))
    if not alloc:
        return None, None
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    pad = 4 - len(shape)
    return out, (int(x.dtype == _F32), x.data_ptr(), y.data_ptr(), out.data_ptr(),
                 *([1] * pad + shape), *([0] * pad + sx), *([0] * pad + sy),
                 x.stride(kx), y.stride(ky), x.shape[kx])


def cell_product(eq, x, y):
    """E5: ``torch.einsum(eq, x, y)`` for an ``eq`` of two operands that
    sums one index they share, with at most 4 output indices (each in
    either operand: an index of one operand alone broadcasts the other
    along it), x and y f64 or f32 alike, at any strides -> the output,
    contiguous.  Each output sums the contracted index in ascending order
    (``csrc/element_chain.cuh``)."""
    if x.device.type == "cpu":
        _product_args(eq, x, y, alloc=False)
        return cell_product_reference(eq, x, y)
    from .._native.cuda import cuda_function

    out, args = _product_args(eq, x, y)
    _on_current(x.device)
    _launched("cell_product", cuda_function("cell_product")(*args, _stream()))
    cell_product.launches += 1
    return out


def cell_product_host(eq, x, y, staged=False):
    """E5's body built with g++, on CPU tensors (tests only); with
    ``staged`` the staged kernel's table and stages (the staged shapes
    only)."""
    from .._native.cuda import host_function

    out, args = _product_args(eq, x, y)
    if staged:
        _staged_host("cell_product_staged", args, f"{eq} on {tuple(x.shape)}, {tuple(y.shape)}")
    else:
        host_function("cell_product")(*args)
    return out


# the operand evaluation's pair (assembly._coeff_values_at_qps): a
# coefficient's values and gradients at the points from its cells' dofs
VALUES_EQ, GRADS_EQ = "qb,cbk->cqk", "cqbg,cbk->cqkg"


def _reach(t):
    """The largest element offset that ``t``'s view reads."""
    return 0 if t.numel() == 0 else sum((n - 1) * s for n, s in zip(t.shape, t.stride()))


def _pair_staged(phi, gp, d2):
    """Whether the pair runs as one staged launch: ``ec_pair_staged_form``
    of ``csrc/element_chain.cuh``, whose launcher refuses the other
    shapes."""
    e5 = staged_e5()
    nc, nq, nb, ng = gp.shape
    bs = d2.shape[2]
    return (nb in e5["product_nk"] and ng == e5["pair_ng"] and nq >= 1 and bs >= 1
            and nq * bs * (1 + ng) <= e5["pair_threads"] and nc * nq * bs * ng < 2**31
            and _reach(phi) < e5["table"] and _reach(gp) < 2**31 and _reach(d2) < 2**31)


def cell_values_grads_reference(phi, gp, d2):
    """Plain version: the two einsums."""
    return (cell_product_reference(VALUES_EQ, phi, d2),
            cell_product_reference(GRADS_EQ, gp, d2))


def _check_pair(phi, gp, d2):
    _product_args(VALUES_EQ, phi, d2, alloc=False)
    _product_args(GRADS_EQ, gp, d2, alloc=False)


def _pair_args(phi, gp, d2):
    """The pair's outputs and launcher arguments, for inputs already checked."""
    nc, nq, nb, ng = gp.shape
    bs = d2.shape[2]
    val = torch.empty((nc, nq, bs), dtype=d2.dtype, device=d2.device)
    grad = torch.empty((nc, nq, bs, ng), dtype=d2.dtype, device=d2.device)
    return (val, grad), (int(d2.dtype == _F32), phi.data_ptr(), *phi.stride(), gp.data_ptr(),
                         *gp.stride(), d2.data_ptr(), *d2.stride(), val.data_ptr(),
                         grad.data_ptr(), nc, nq, nb, bs, ng)


def cell_values_grads(phi, gp, d2):
    """E5, one coefficient's values and gradients at the points: phi (nq,
    nb), gp (nc, nq, nb, ng) and d2 (nc, nb, bs), f64 or f32 alike, at any
    strides -> (``cell_product(VALUES_EQ, phi, d2)``,
    ``cell_product(GRADS_EQ, gp, d2)``), the same bits.  At the staged
    shapes (``staged_e5()``: nb one of ``product_nk``, ng ``pair_ng``, a
    cell's outputs within ``pair_threads``) one launch writes both,
    reading d2 once into shared memory; elsewhere the two products."""
    _check_pair(phi, gp, d2)
    if d2.device.type == "cpu":
        return cell_values_grads_reference(phi, gp, d2)
    if not _pair_staged(phi, gp, d2):
        return cell_product(VALUES_EQ, phi, d2), cell_product(GRADS_EQ, gp, d2)
    from .._native.cuda import cuda_function

    out, args = _pair_args(phi, gp, d2)
    _on_current(d2.device)
    _launched("cell_values_grads", cuda_function("cell_values_grads")(*args, _stream()))
    cell_values_grads.launches += 1
    return out


def cell_values_grads_host(phi, gp, d2, staged=False):
    """The pair's bodies built with g++, on CPU tensors (tests only): the
    two products' bodies, or with ``staged`` the staged kernel's table
    and stages (the staged shapes only)."""
    if not staged:
        return cell_product_host(VALUES_EQ, phi, d2), cell_product_host(GRADS_EQ, gp, d2)
    _check_pair(phi, gp, d2)
    out, args = _pair_args(phi, gp, d2)
    _staged_host("cell_values_grads_staged", args,
                 f"{tuple(phi.shape)}, {tuple(gp.shape)}, {tuple(d2.shape)}")
    return out


def cell_triple_reference(W, K):
    """Plain version: ``W^T K W`` as the torch matmuls ``W.transpose(1, 2)
    @ K @ W``."""
    return W.transpose(1, 2) @ K @ W


def _check_triple(W, K):
    if W.dim() != 3 or K.dim() != 3 or K.shape[0] != W.shape[0] or \
            K.shape[1] != W.shape[1] or K.shape[2] != W.shape[1]:
        raise ValueError(f"W^T K W needs W (nc, nk, na) and K (nc, nk, nk), got "
                         f"{tuple(W.shape)} and {tuple(K.shape)}")
    _product_args("cia,cij->caj", W, K, alloc=False)


def _triple(product, W, K):
    return product("caj,cjb->cab", product("cia,cij->caj", W, K), W)


def _triple_staged(W, K):
    """Whether the triple runs as one staged launch: ``ec_triple_staged``
    of ``csrc/element_chain.cuh``, whose launcher refuses the other
    shapes."""
    nk, na, _ = staged_e5()["triple"]
    return (W.dtype == _F32 and tuple(W.shape[1:]) == (nk, na) and W.is_contiguous()
            and K.is_contiguous() and W.shape[0] < (2**31 - 1) // (nk * nk))


def _triple_args(W, K):
    nc, nk, na = W.shape
    out = torch.empty((nc, na, na), dtype=W.dtype, device=W.device)
    return out, (W.data_ptr(), *W.stride(), K.data_ptr(), *K.stride(), out.data_ptr(), nc, nk,
                 na)


def cell_triple(W, K):
    """E5, the per-cell ``W^T K W`` of W (nc, nk, na) and K (nc, nk, nk),
    f32 or f64 alike, at any strides, as ``(W^T K) W`` -> (nc, na, na):
    at the staged shape (``staged_e5()["triple"]``, f32, contiguous) one
    launch; elsewhere two ``cell_product``s, the same bits."""
    _check_triple(W, K)
    if W.device.type == "cpu":
        return cell_triple_reference(W, K)
    if not _triple_staged(W, K):
        return _triple(cell_product, W, K)
    from .._native.cuda import cuda_function

    out, args = _triple_args(W, K)
    _on_current(W.device)
    _launched("cell_triple", cuda_function("cell_triple")(*args, _stream()))
    cell_triple.launches += 1
    return out


def cell_triple_host(W, K, staged=False):
    """The triple's bodies built with g++, on CPU tensors (tests only):
    E5's body twice, or with ``staged`` the staged kernel's loads and
    stages (the staged shape only)."""
    _check_triple(W, K)
    if not staged:
        return _triple(cell_product_host, W, K)
    out, args = _triple_args(W, K)
    _staged_host("cell_triple_staged", args, f"{tuple(W.shape)}, {tuple(K.shape)}")
    return out


_COUNTED = (cell_strain, cell_residual, cell_tangent, ebe_cell_matvec, cell_product,
            cell_values_grads, cell_triple)


def reset_launches():
    """Set every E kernel's launch count to 0."""
    for fn in _COUNTED:
        fn.launches = 0


def launch_counts():
    """{wrapper name: kernel launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in _COUNTED}


reset_launches()
