"""Card-only tests of the port's CUDA kernel; each skips without a GPU.

This file imports no JAX, so that it runs on a machine that has PyTorch
with CUDA but no JAX (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import dolfinx_external_operator_torch as pt
from dolfinx_external_operator_torch.models import von_mises as vm
from dolfinx_external_operator_torch.ops import vonmises as ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (see README: the port's card-only tests)")
    return torch.device("cuda")


def _inputs(n, device, seed=3):
    """The strain/stress mix of test_pallas_ops.py (half the points
    plastic), SoA f32."""
    rng = np.random.default_rng(seed)
    deps = rng.normal(scale=2e-3, size=(n, 4))
    deps[: n // 2, 3] += 6e-3
    sig_n = rng.normal(scale=20.0, size=(n, 4))
    p = np.abs(rng.normal(scale=1e-3, size=n))
    return [torch.tensor(a.T.copy(), dtype=torch.float32, device=device)
            for a in (deps, sig_n)] + [torch.tensor(p, dtype=torch.float32, device=device)]


def test_cuda_kernel_matches_plain(cuda):
    """The kernel against the plain version on the card, at a ragged n."""
    args = _inputs(3750, cuda) + [vm.PARAMS]
    before = ops.vonmises_return_map.launches
    C, sig, dp = ops.vonmises_return_map(*args)
    C_r, sig_r, dp_r = ops.vonmises_return_map_reference(*args)
    torch.cuda.synchronize()
    assert ops.vonmises_return_map.launches == before + 1
    assert float((C - C_r).abs().max() / C_r.abs().max()) < 1e-5
    assert float((sig - sig_r).abs().max() / max(float(sig_r.abs().max()), 1.0)) < 1e-5
    assert float((dp - dp_r).abs().max()) < 1e-7


def _run(fp):
    Du, sig = fp.zero_state()
    its = []
    for load in (200.0, 400.0, 600.0):
        Du, sig, _, it, _ = fp.run_step(Du, sig, load)
        its.append(it)
    return Du, its


def test_cuda_fused_step_through_kernel(cuda):
    """The fused step on the card, 8x8 block, dense solver: the f64 path
    gives the JAX package's Newton list [1, 5, 7]; the f32 kernel path
    converges within 10 updates a step, launches the kernel once per Newton
    pass, agrees with the f64 path to 1e-3, and repeats bitwise (the
    scatters use no atomics)."""
    fp64 = pt.von_mises_block_step(8, 8, "f64", linear_solver="dense")
    fp32 = pt.von_mises_block_step(8, 8, "f32", linear_solver="dense",
                                   newton_rtol=1e-5, newton_atol=1e-3)
    assert fp32.device.type == "cuda" and fp32._dense_fact == "chol"
    Du64, its64 = _run(fp64)
    before = ops.vonmises_return_map.launches
    Du32, its32 = _run(fp32)
    assert its64 == [1, 5, 7]
    assert all(i <= 10 for i in its32), its32
    assert ops.vonmises_return_map.launches - before == sum(its32) + len(its32)
    assert float((Du32 - Du64).abs().max() / Du64.abs().max()) < 1e-3
    Du32_again, its32_again = _run(fp32)
    assert its32_again == its32 and torch.equal(Du32_again, Du32)
