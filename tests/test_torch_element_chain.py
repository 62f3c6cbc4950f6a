"""The element chain's kernels E1-E5 (``ops/element_chain.py``) on the CPU.

Inputs: the port's Mohr-Coulomb slope step (dense, plain return map) at
4x4 and 8x8 after two load steps (2.0, 6.0): Du, sigma and the tangent
there, and a vector drawn from a numpy seed.  E5's operands at the
slope's shapes (P2 vector triangles, 3 points a cell) from the same
seed: the geometry's reference gradients and vertex coordinates, the
basis tables, inverse Jacobians and cell dofs of the operand evaluation,
and restriction weights W (nc, 12, 6) against the element blocks in f32
for the level-1 triple.

* The plain versions (what a CPU tensor runs, and what the fused step ran
  before the kernels) against the JAX package's element chain: its own
  ``_local_ops`` (``parallel/spmd.py:477-524``) for the strain, the
  residual, the tangent matvec and diagonal, called with an identity
  dofmap so that its scatter keeps each cell's values, and its einsums of
  the element blocks (``:612``, ``:745``) and of ``_ebe`` (``:617-620``)
  on the same arrays: within 1e-12 relative in f64, 1e-6 in f32 (the two
  libraries sum f32 products in other orders).  E5's against the JAX
  package's own operand evaluation (``compile.geometry_factors``,
  ``assembly._basis_arrays`` and ``assembly._coeff_values_at_qps``,
  ``assembly.py:114-139``, vmapped over the cells) and the level-1
  triple's einsum (``parallel/mg.py:890``).
* The kernels' own bodies, built with g++ (``*_host``), against the plain
  versions: within 1e-13 relative in f64, 1e-5 in f32.
* The bodies on the cells of 2 and of 3 slices, and on the cells in
  reverse order: bitwise the whole batch's rows, the property that makes
  a rank's cells give the whole batch's bits (E5 with tables broadcast
  over the cells by stride 0, and the values' dofs a strided view).
* Padded cells (B and w zero, every dof the padding index, keep 0; E5's
  per-cell operands zero) give zero, in the plain versions and in the
  bodies.
* E2 and E3's staged composition (the staged kernels' loads and stages,
  run on the CPU over the kernels' groups of cells): the bodies' bits at
  the groups' edges, with padded cells, C and sigma the strided views of
  the return map; and the staged shape is the launchers'.
* E5's staged composition likewise: the operand products, the
  values-and-gradients pair (two products in one launch) and the level-1
  triple (one launch, T kept in shared memory) give the unstaged bodies'
  bits at the groups' edges and with padded cells, on the strided view of
  the dofs and with a table broadcast over the cells at stride 0; the
  staged shapes are the launchers', and the wrappers' predicates agree
  with them.

The kernels themselves run on a card in ``test_torch_cuda.py``.
"""
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from types import SimpleNamespace

from dolfinx_external_operator_tpu import assembly as assembly_j
from dolfinx_external_operator_tpu import compile as compile_j
from dolfinx_external_operator_tpu.parallel.spmd import FusedPlasticityStep as StepJ

import dolfinx_external_operator_torch as pt
from dolfinx_external_operator_torch.ops import element_chain as ec
from test_torch_bcr import _jax_slope

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)

LOADS = (2.0, 6.0)
F32, F64 = torch.float32, torch.float64
# product -> its dtype
PRODUCTS = {"strain": F64, "residual": F64, "tangent_matvec": F64, "tangent_diag": F64,
            "blocks_f64": F64, "blocks_f32": F32, "ebe_f64": F64, "ebe_f32": F32,
            "ebe_node_f64": F64, "ebe_node_f32": F32, "operand_geometry": F64,
            "operand_gphys": F64, "operand_values": F64, "operand_grads": F64,
            "triple_f32": F32}
# E5's operand einsums (assembly.py, compile.py)
OPERAND = {"operand_geometry": "qvd,cvg->cqgd", "operand_gphys": "qbd,cqdg->cqbg",
           "operand_values": "qb,cbk->cqk", "operand_grads": "cqbg,cbk->cqkg"}
# the operand evaluation's shapes: points, basis functions, value size,
# geometry vertices; the triple's coarse dofs a cell
NQ, NB, BS, NV, NA = 3, 6, 2, 3, 6


class _Coefficient:
    """What the JAX package's operand evaluation reads of a coefficient:
    a vector P2 space's value shape and block size."""
    function_space = SimpleNamespace(value_shape=(BS,), bs=BS)


@pytest.fixture(scope="module", params=[4, 8], ids=lambda n: f"{n}x{n}")
def chain(request):
    """The inputs at N x N after two load steps; the element chain's
    arguments, by product, as functions of a cell selection."""
    N = request.param
    fp = pt.mohr_coulomb_slope_step(N, N, device="cpu", linear_solver="dense", route="plain")
    Du, sig_n = fp.zero_state()
    for load in LOADS:
        Du, sig_n, *_ = fp.run_step(Du, sig_n, load)
    C, sigma = fp._constitutive(Du, sig_n)
    rng = np.random.default_rng(N)
    x = torch.as_tensor(rng.standard_normal(fp.n_dofs))
    st = fp.statics
    # E4's blocks: the whole batch's, sliced like the other inputs
    K = ec.cell_tangent_reference("blocks", st["B"], C, st["wdet"], keep=fp._keep_cell)
    nc = fp.nc

    def draw(*shape, dtype=F64):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype)

    dphi, Jinv = draw(NQ, NB, 2), draw(nc, NQ, 2, 2)
    return {"N": N, "fp": fp, "Du": Du, "sig_n": sig_n, "C": C, "sigma": sigma, "x": x,
            "B": st["B"], "w": st["wdet"], "dof": st["dofmap"], "keep": fp._keep_cell,
            "node": st["dofmap"][:, ::2] // 2, "K": K,
            "dphi_g": draw(NQ, NV, 2), "coords": draw(nc, NV, 2), "phi": draw(NQ, NB),
            "dphi": dphi, "Jinv": Jinv, "gp": torch.einsum("qbd,cqdg->cqbg", dphi, Jinv),
            "d2w": draw(nc, NB, BS + 1), "W": draw(nc, 12, NA, dtype=F32)}


def _args(ch, name, cells=slice(None)):
    """(function of ops.element_chain by suffix, its arguments) of product
    ``name`` on ``cells`` (any row selection)."""
    def r(t):
        return t[cells].contiguous()

    B, C, w, dof, x = r(ch["B"]), ch["C"][cells], r(ch["w"]), r(ch["dof"]), ch["x"]
    if name == "operand_values_grads":
        return "cell_values_grads", (ch["phi"], r(ch["gp"]), r(ch["d2w"])[:, :, :BS]), {}
    if name == "operand_values_expanded":  # the table broadcast by stride 0
        d2 = r(ch["d2w"])[:, :, :BS]
        return "cell_product", ("cqb,cbk->cqk", ch["phi"].expand(d2.shape[0], NQ, NB), d2), {}
    if name in OPERAND:
        # the cells' dofs as a strided view (a mixed space's columns)
        d2 = r(ch["d2w"])[:, :, :BS]
        x, y = {"operand_geometry": (ch["dphi_g"], r(ch["coords"])),
                "operand_gphys": (ch["dphi"], r(ch["Jinv"])),
                "operand_values": (ch["phi"], d2), "operand_grads": (r(ch["gp"]), d2)}[name]
        return "cell_product", (OPERAND[name], x, y), {}
    if name == "triple_f32":
        return "cell_triple", (r(ch["W"]), r(ch["K"]).to(F32)), {}
    if name == "strain":
        return "cell_strain", (B, dof, ch["Du"]), {}
    if name == "residual":
        return "cell_residual", (B, ch["sigma"][cells], w), {}
    if name == "tangent_matvec":
        return "cell_tangent", ("matvec", B, C, w, dof, x), {}
    if name == "tangent_diag":
        return "cell_tangent", ("diag", B, C, w), {}
    if name.startswith("blocks"):
        return "cell_tangent", ("blocks", B, C, w), {
            "keep": r(ch["keep"]), "dtype": F32 if name.endswith("f32") else F64}
    dt = F32 if name.endswith("f32") else F64
    K = ch["K"][cells].to(dt)
    if "node" in name:
        return "ebe_cell_matvec", (K, r(ch["node"]), x.to(dt), 2), {}
    return "ebe_cell_matvec", (K, dof, x.to(dt), 1), {}


def _run(ch, name, kind, cells=slice(None)):
    fn, args, kw = _args(ch, name, cells)
    return getattr(ec, f"{fn}{kind}")(*args, **kw)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def jax_chain(chain):
    """The JAX package's products on the same arrays, by name, per cell."""
    N = chain["N"]
    fp_j = StepJ(*_jax_slope(N))
    st_t = {k: chain[k].numpy() for k in ("B", "w", "dof", "keep")}
    st = {"B": jnp.asarray(st_t["B"]), "wdet": jnp.asarray(st_t["w"]),
          "dofmap": jnp.asarray(st_t["dof"])}
    for k, k_j in (("B", "B"), ("w", "wdet"), ("dof", "dofmap")):
        assert np.array_equal(st_t[k], np.asarray(fp_j.statics[k_j])), k
    nc, nk = st_t["dof"].shape
    psum = lambda v: v  # noqa: E731
    C = jnp.asarray(chain["C"].numpy())
    x = chain["x"].numpy()
    # the strain: the JAX constitutive step with a return map that hands
    # the strain back as the stress
    fp_j._vkernel = lambda d, s: (jnp.zeros((4, 4, d.shape[1])), d)
    constitutive = fp_j._local_ops()[0]
    _, strain = constitutive(st, jnp.asarray(chain["Du"].numpy()),
                             jnp.zeros((nc, fp_j.nq, 4)), psum)
    # per-cell values: an identity dofmap over nc * nk slots
    fp_j.n_dofs = nc * nk
    _, residual, tangent_matvec, tangent_diag, _ = fp_j._local_ops()
    st_id = dict(st, dofmap=jnp.arange(nc * nk).reshape(nc, nk))
    x_cell = np.concatenate([x, [0.0]])[st_t["dof"]]
    out = {"strain": strain,
           "residual": residual(st_id, jnp.asarray(chain["sigma"].numpy()), 0.0, psum,
                                jnp.zeros(nc * nk)).reshape(nc, nk),
           "tangent_matvec": tangent_matvec(st_id, C, jnp.asarray(x_cell.ravel()),
                                            psum).reshape(nc, nk),
           "tangent_diag": tangent_diag(st_id, C, psum).reshape(nc, nk)}
    # the element blocks (spmd.py:612, :745) and _ebe (:617-620)
    km = jnp.asarray(st_t["keep"])
    K = jnp.einsum("cqik,cqij,cqjl,cq->ckl", st["B"], C, st["B"], st["wdet"])
    out["blocks_f64"] = K = K * km[:, :, None] * km[:, None, :]
    f32 = jnp.float32
    km32 = km.astype(f32)
    K32 = jnp.einsum("cqik,cqij,cqjl,cq->ckl", st["B"].astype(f32), C.astype(f32),
                     st["B"].astype(f32), st["wdet"].astype(f32))
    out["blocks_f32"] = K32 * km32[:, :, None] * km32[:, None, :]
    for name, Kd in (("ebe_f64", K), ("ebe_f32", K.astype(f32))):
        u = jnp.concatenate([jnp.asarray(x, Kd.dtype), jnp.zeros(1, Kd.dtype)])
        out[name] = out[name.replace("ebe", "ebe_node")] = jnp.einsum(
            "cab,cb->ca", Kd, u[st["dofmap"]])
    # E5: the operand evaluation, one cell at a time as the JAX package
    # evaluates it (vmapped), and the level-1 triple's einsum
    e = {k: jnp.asarray(chain[k].numpy()) for k in ("dphi_g", "coords", "phi", "dphi", "Jinv",
                                                      "W")}
    d2 = jnp.asarray(chain["d2w"].numpy()[:, :, :BS])
    out["operand_geometry"] = jax.vmap(
        lambda c: compile_j.geometry_factors(c, e["dphi_g"])[0])(e["coords"])
    scalar = SimpleNamespace(num_sub_spaces=0, bs=1, value_shape=())
    out["operand_gphys"] = jax.vmap(lambda Ji: jnp.swapaxes(
        assembly_j._basis_arrays(scalar, (e["phi"], e["dphi"]), Ji)[1], 0, 1))(e["Jinv"])
    f = _Coefficient()
    plan = [(f, "tab", (e["phi"], e["dphi"], True))]
    vals, grads = jax.vmap(lambda d, Ji: assembly_j._coeff_values_at_qps(
        plan, [d.reshape(-1)], Ji)[f])(d2, e["Jinv"])
    out["operand_values"], out["operand_grads"] = vals, grads
    out["triple_f32"] = jnp.einsum("cia,cij,cjb->cab", e["W"], K.astype(f32), e["W"])
    return out


@pytest.mark.parametrize("name", list(PRODUCTS))
def test_plain_matches_jax(chain, jax_chain, name):
    plain = _run(chain, name, "_reference")
    tol = 1e-6 if PRODUCTS[name] == F32 else 1e-12
    assert plain.dtype == PRODUCTS[name]
    assert _rel(plain.numpy(), np.asarray(jax_chain[name])) < tol


@pytest.mark.parametrize("name", list(PRODUCTS))
def test_wrapper_runs_plain_on_cpu(chain, name):
    """On CPU tensors a wrapper returns its plain version's bits and
    launches nothing."""
    before = ec.launch_counts()
    assert torch.equal(_run(chain, name, ""), _run(chain, name, "_reference"))
    assert ec.launch_counts() == before


@pytest.mark.parametrize("name", list(PRODUCTS))
def test_host_body_matches_plain(chain, name):
    host, plain = _run(chain, name, "_host"), _run(chain, name, "_reference")
    assert host.dtype == plain.dtype and host.shape == plain.shape
    tol = 1e-5 if PRODUCTS[name] == F32 else 1e-13
    assert _rel(host.numpy(), plain.numpy()) < tol


@pytest.mark.parametrize("name", list(PRODUCTS))
def test_host_body_is_slice_invariant(chain, name):
    """The bodies on the cells of 2 and 3 slices and in reverse order give
    the whole batch's rows bit for bit."""
    whole = _run(chain, name, "_host")
    nc = whole.shape[0]
    for n in (2, 3):
        k = -(-nc // n)
        for r in range(n):
            cells = slice(r * k, min((r + 1) * k, nc))
            assert torch.equal(_run(chain, name, "_host", cells), whole[cells]), (n, r)
    rev = torch.arange(nc - 1, -1, -1)
    assert torch.equal(_run(chain, name, "_host", rev), whole[rev])


def _padded(ch, pad):
    """``ch`` with ``pad`` padded cells appended, as a sharded step pads its
    last rank: B and w zero, every dof the padding index n, keep 0."""
    n = ch["fp"].n_dofs
    out = dict(ch)
    for k, v in (("B", 0.0), ("w", 0.0), ("dof", n), ("keep", 0.0), ("node", n // 2),
                 ("K", 0.0), ("coords", 0.0), ("Jinv", 0.0), ("gp", 0.0), ("d2w", 0.0),
                 ("W", 0.0)):
        t = ch[k]
        out[k] = torch.cat([t, torch.full((pad,) + tuple(t.shape[1:]), v, dtype=t.dtype)])
    C, sigma = ch["C"], ch["sigma"]
    out["C"] = torch.cat([C, C[:pad]])  # a real tangent: B = 0 must zero it
    out["sigma"] = torch.cat([sigma, sigma[:pad]])
    return out


@pytest.mark.parametrize("kind", ["_reference", "_host"])
@pytest.mark.parametrize("name", list(PRODUCTS))
def test_padded_cells_give_zero(chain, name, kind):
    pad = 3
    ch = _padded(chain, pad)
    out = _run(ch, name, kind)
    assert not bool(out[-pad:].any())
    if kind == "_host":
        assert torch.equal(out[:-pad], _run(chain, name, kind))
    else:  # torch's CPU einsum may sum a longer batch in another order
        assert _rel(out[:-pad].numpy(), _run(chain, name, kind).numpy()) < 1e-13


def test_diag_is_the_blocks_diagonal(chain):
    """The diagonal mode gives the f64 blocks' diagonal bit for bit."""
    d = ec.cell_tangent_host("diag", chain["B"], chain["C"], chain["w"])
    K = ec.cell_tangent_host("blocks", chain["B"], chain["C"], chain["w"])
    assert torch.equal(d, torch.diagonal(K, dim1=1, dim2=2))


# E2 and E3's staged variants (the f32 blocks masked, as the elastic and
# AMG paths call them, and unmasked, as the dense update does)
STAGED = ("residual", "tangent_matvec", "tangent_diag", "blocks_f64", "blocks_f32",
          "blocks_f32_unmasked")


def _point_fastest(t):
    """``t`` (cells, points, ...) as a view whose (cell, point) axes are
    the fastest, the layout in which the step's return map hands C and
    sigma (``FusedPlasticityStep._constitutive``)."""
    lead = list(range(2, t.dim())) + [0, 1]
    back = [lead.index(d) for d in range(t.dim())]
    return t.permute(lead).contiguous().permute(back)


# E5's staged variants: the operand products (one of them with its table
# an expanded view, stride 0 over the cells), the pair, the level-1 triple
STAGED_E5 = ("operand_geometry", "operand_gphys", "operand_values", "operand_grads",
             "operand_values_expanded", "operand_values_grads", "triple_f32")
# E5's outputs a cell (the staged product and pair: one a thread)
E5_PER_CELL = {"operand_geometry": NQ * 4, "operand_gphys": NQ * NB * 2, "operand_values": NQ * BS,
               "operand_grads": NQ * BS * 2, "operand_values_expanded": NQ * BS,
               "operand_values_grads": NQ * BS * 3}


def _block_threads():
    src = (Path(ec.__file__).parent.parent / "csrc" / "element_chain.cu").read_text()
    return int(src.split("constexpr int kThreads = ")[1].split(";")[0])


def _group(name):
    """The cells of one group of the staged kernel of ``name``."""
    if name == "triple_f32":
        return ec.staged_e5()["triple"][2]
    if name == "operand_values_grads":
        return ec.staged_e5()["pair_threads"] // E5_PER_CELL[name]
    if name in E5_PER_CELL:  # the cells whose outputs fill a block
        return _block_threads() // E5_PER_CELL[name]
    return ec.staged_quad()[4 if name.startswith("blocks") else 3]


@pytest.mark.parametrize("cells", ["1", "G-1", "G", "G+1", "37", "padded"])
@pytest.mark.parametrize("name", STAGED + STAGED_E5)
def test_staged_host_matches_body(chain, name, cells):
    """The staged kernels' composition, run on the CPU stage by stage
    over the kernels' groups of G cells (E2 and the matvec 10, the E3
    blocks 1; E5's triple 3, the pair 7, its products the cells that fill
    a block of outputs), gives the bodies' bits: at 1, G-1, G, G+1 and 37
    cells (past a 4x4 batch's 32 cells, padded cells), and on the batch
    with 3 padded cells appended, as a sharded step pads its last rank; C
    and sigma the strided views that the return map hands (points
    fastest), E5's dofs a strided view."""
    G = _group(name)
    nc = chain["fp"].nc
    want = {"1": 1, "G-1": G - 1, "G": G, "G+1": G + 1, "37": 37, "padded": nc + 3}[cells]
    ch = chain
    if want > nc:
        ch = _padded(chain, want - nc)
        ch["C"], ch["sigma"] = _point_fastest(ch["C"]), _point_fastest(ch["sigma"])
    assert ch["C"].stride()[:2] == (3, 1) and ch["sigma"].stride()[:2] == (3, 1)
    fn, args, kw = _args(ch, name.replace("_unmasked", ""), slice(0, want))
    if name.endswith("_unmasked"):
        del kw["keep"]
    host = getattr(ec, f"{fn}_host")
    staged, body = host(*args, staged=True, **kw), host(*args, **kw)
    if name == "operand_values_grads":  # the pair: values and gradients
        assert torch.equal(body[0], ec.cell_product_host(ec.VALUES_EQ, args[0], args[2]))
        assert torch.equal(body[1], ec.cell_product_host(ec.GRADS_EQ, args[1], args[2]))
    else:
        staged, body = (staged,), (body,)
    for st, bd in zip(staged, body):
        assert st.shape[0] == want and st.dtype == bd.dtype
        assert torch.equal(st, bd)


@pytest.mark.parametrize("shape", [(3, 4, 12), (2, 6, 12), (4, 3, 12), (6, 2, 12), (3, 4, 10),
                                   (3, 3, 12), (1, 4, 12)])
def test_staged_shape_is_the_launchers(shape):
    """The staged shape that ``staged_quad()`` reads from the header is the
    only one that the staged entries take (they refuse the others, which
    nq * ni == nk alone would not tell apart), and both launchers of E2
    and E3 test that predicate, ``ec_quad_staged``, before they launch a
    staged kernel."""
    nq, ni, nk = shape
    nc, n = 3, 20
    rng = np.random.default_rng(7)
    B = torch.as_tensor(rng.standard_normal((nc, nq, ni, nk)))
    C = _point_fastest(torch.as_tensor(rng.standard_normal((nc, nq, ni, ni))))
    sig, w = torch.zeros(nc, nq, ni, dtype=F64), torch.ones(nc, nq, dtype=F64)
    dof = torch.as_tensor(rng.integers(0, n + 1, (nc, nk)))
    calls = [lambda: ec.cell_residual_host(B, sig, w, staged=True),
             lambda: ec.cell_tangent_host("matvec", B, C, w, dof, torch.ones(n, dtype=F64),
                                          staged=True),
             lambda: ec.cell_tangent_host("diag", B, C, w, staged=True),
             lambda: ec.cell_tangent_host("blocks", B, C, w, dtype=F32, staged=True)]
    for call in calls:
        if shape == ec.staged_quad()[:3]:
            call()
        else:
            with pytest.raises(ValueError, match="not the staged shape"):
                call()
    src = (Path(ec.__file__).parent.parent / "csrc" / "element_chain.cu").read_text()
    for launcher in ("ec_residual_launch", "ec_tangent_launch"):
        body = src[src.index(f"int {launcher}("):]
        assert "ec_quad_staged(nq, ni, nk)" in body[:body.index("\n}\n")], launcher


# E5 shapes: (kernel, what varies, staged?)
E5_SHAPES = [("product", 2, True), ("product", 3, True), ("product", 6, True),
             ("product", 1, False), ("product", 4, False), ("product", 7, False),
             ("pair", (6, 2, 2), True), ("pair", (3, 2, 1), True), ("pair", (2, 2, 14), True),
             ("pair", (6, 3, 2), False), ("pair", (10, 2, 2), False), ("pair", (6, 1, 2), False),
             ("pair", (6, 2, 15), False),
             ("triple", (12, 6, "c"), True), ("triple", (12, 4, "c"), False),
             ("triple", (10, 6, "c"), False), ("triple", (12, 6, "K^T"), False),
             ("triple", (12, 6, "W^T"), False)]


@pytest.mark.parametrize("case", E5_SHAPES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_e5_staged_shape_is_the_launchers(case):
    """E5's staged shapes (``staged_e5()``, read from the header): the
    staged entries take them and refuse the others; the wrappers'
    predicates (the pair's and the triple's, which pick one launch or
    two) agree with the entries; each launcher tests its predicate
    (``ec_product_staged_form``, ``ec_pair_staged_form``,
    ``ec_triple_staged``) before it launches a staged kernel."""
    kernel, var, staged = case
    rng = np.random.default_rng(11)
    nc = 5

    def draw(*shape, dtype=F64):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype)

    if kernel == "product":
        assert (var in ec.staged_e5()["product_nk"]) == staged
        x, y = draw(NQ, var), draw(nc, var, BS)
        call = lambda: ec.cell_product_host("qb,cbk->cqk", x, y, staged=True)  # noqa: E731
        agree = None
    elif kernel == "pair":
        nb, ng, bs = var  # a cell's NQ bs (1 + ng) outputs within a block of 128 or not
        phi, gp, d2 = draw(NQ, nb), draw(nc, NQ, nb, ng), draw(nc, nb, bs + 1)[:, :, :bs]
        call = lambda: ec.cell_values_grads_host(phi, gp, d2, staged=True)  # noqa: E731
        agree = ec._pair_staged(phi, gp, d2)
    else:
        nk, na, layout = var
        W, K = draw(nc, nk, na, dtype=F32), draw(nc, nk, nk, dtype=F32)
        if layout == "K^T":
            K = K.transpose(1, 2)
        elif layout == "W^T":
            W = draw(nc, na, nk, dtype=F32).transpose(1, 2)
        call = lambda: ec.cell_triple_host(W, K, staged=True)  # noqa: E731
        agree = ec._triple_staged(W, K)
    if staged:
        call()
    else:
        with pytest.raises(ValueError, match="not the staged shape"):
            call()
    assert agree is None or agree == staged
    src = (Path(ec.__file__).parent.parent / "csrc" / "element_chain.cu").read_text()
    for launcher, test, launch in (
            ("ec_product_launch", "ec_product_staged_form(p, q)", "launch_staged_product("),
            ("ec_values_grads_launch", "ec_pair_staged_form(", "launch_staged_pair("),
            ("ec_triple_launch", "ec_triple_staged(nc, nk, na, ws, ks)", "<<<")):
        body = src[src.index(f"int {launcher}("):]
        body = body[:body.index("\n}\n")]
        assert test in body and launch in body, launcher
        assert body.index(test) < body.index(launch), launcher


def test_values_grads_pair_is_the_two_products(chain):
    """The pair (``cell_values_grads``): on CPU tensors the two products'
    plain bits and no launch; its g++ body the two products' bodies,
    within 1e-13 of the plain version, and a slice's rows bitwise the
    whole batch's."""
    fn, args, _ = _args(chain, "operand_values_grads")
    phi, gp, d2 = args
    before = ec.launch_counts()
    v, g = ec.cell_values_grads(*args)
    assert ec.launch_counts() == before
    assert torch.equal(v, ec.cell_product_reference(ec.VALUES_EQ, phi, d2))
    assert torch.equal(g, ec.cell_product_reference(ec.GRADS_EQ, gp, d2))
    hv, hg = ec.cell_values_grads_host(*args, staged=True)
    assert _rel(hv.numpy(), v.numpy()) < 1e-13 and _rel(hg.numpy(), g.numpy()) < 1e-13
    nc = hv.shape[0]
    part = slice(nc // 3, nc - 2)
    pv, pg = ec.cell_values_grads_host(*_args(chain, "operand_values_grads", part)[1], staged=True)
    assert torch.equal(pv, hv[part]) and torch.equal(pg, hg[part])


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "mode", "dtype_mix",
                                  "product_sums", "product_dtype_mix", "product_shape",
                                  "triple_shape", "values_grads_shape",
                                  "values_grads_dtype_mix", "values_grads_rank"])
def test_wrappers_refuse_what_the_kernels_do_not_take(chain, case):
    B, C, w, dof = chain["B"], chain["C"], chain["w"], chain["dof"]
    with pytest.raises((TypeError, ValueError)):
        if case == "dtype":
            ec.cell_strain(B.to(F32), dof, chain["Du"])
        elif case == "shape":
            ec.cell_residual(B, chain["sigma"][:, :2], w)
        elif case == "contiguity":
            ec.cell_strain(B.transpose(2, 3), dof, chain["Du"])
        elif case == "mode":
            ec.cell_tangent("diag", B, C, w, dtype=F32)
        elif case == "dtype_mix":
            ec.ebe_cell_matvec(torch.zeros(3, 12, 12), dof[:3], chain["x"], 1)
        elif case == "product_sums":  # two summed indices
            ec.cell_product("qbd,cqbd->cq", chain["dphi"], chain["gp"])
        elif case == "product_dtype_mix":
            ec.cell_product("qb,cbk->cqk", chain["phi"].to(F32), chain["d2w"])
        elif case == "product_shape":
            ec.cell_product("qb,cbk->cqk", chain["phi"], chain["d2w"][:, :4])
        elif case == "triple_shape":
            ec.cell_triple(chain["W"][:, :10], chain["K"].to(F32))
        elif case == "values_grads_shape":  # gp's basis functions are not phi's
            ec.cell_values_grads(chain["phi"], chain["gp"][:, :, :4], chain["d2w"])
        elif case == "values_grads_dtype_mix":
            ec.cell_values_grads(chain["phi"], chain["gp"].to(F32), chain["d2w"])
        else:  # gp without its cell axis
            ec.cell_values_grads(chain["phi"], chain["gp"][0], chain["d2w"])


@pytest.mark.parametrize("dtype", [F64, F32])
def test_ebe_non_square_blocks(dtype):
    """E4 on (nc, na, nb) blocks (a form's test and trial spaces differ):
    the g++ body within 1e-13 (f64) or 1e-5 (f32) of the plain version,
    and bitwise on a slice of the cells."""
    rng = np.random.default_rng(5)
    nc, na, nb, n = 40, 6, 10, 57
    K = torch.as_tensor(rng.standard_normal((nc, na, nb)), dtype=dtype)
    idx = torch.as_tensor(rng.integers(0, n + 1, (nc, nb)))  # n: padding
    x = torch.as_tensor(rng.standard_normal(n), dtype=dtype)
    host, plain = ec.ebe_cell_matvec_host(K, idx, x, 1), ec.ebe_cell_matvec_reference(K, idx, x, 1)
    assert host.shape == (nc, na)
    assert _rel(host.numpy(), plain.numpy()) < (1e-5 if dtype == F32 else 1e-13)
    part = ec.ebe_cell_matvec_host(K[13:29].contiguous(), idx[13:29].contiguous(), x, 1)
    assert torch.equal(part, host[13:29])
