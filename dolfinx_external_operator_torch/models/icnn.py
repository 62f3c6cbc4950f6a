"""Input-Convex Neural Network constitutive model.

The port of ``dolfinx_external_operator_tpu/models/icnn.py``: the
EUCLID-hyperelasticity ICNN of the reference (``demo_hyperelasticity.py:
221-300``; architecture from github.com/EUCLID-code/EUCLID-hyperelasticity-NN),
a 3 -> [64, 64, 64] -> 1 network over the invariant features (K1, K2, K3)
of the deformation gradient, with softplus-positive hidden weights (input
convexity) and linear skip connections.  The pretrained weights are the
port's own copy of the reference's ``Isihara_noise=high.pth`` checkpoint
(``models/data``), read as f64.

The stress is the energy gradient with the NN-EUCLID correction
(``demo_hyperelasticity.py:361-381``): ``P(F) = dW_NN/dF + F @ H`` with
``H = -dW_NN/dF`` at ``F = I``, so the reference state is stress-free.  The
consistent tangent dP/dF is ``torch.func.vmap(torch.func.jacfwd(...))``
over the energy's ``torch.func.grad``, as the reference demo computes it
(``demo_hyperelasticity.py:448``).  Eagerly that is a few thousand small
launches per call; on the card each batch size's call is captured once in
a CUDA graph and replayed (``parallel.mg.cuda_graphed``), where the JAX
package jits it.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

__all__ = ["ICNN", "load_isihara_weights", "DEFAULT_WEIGHTS_PATH"]

DEFAULT_WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "data", "Isihara_noise=high.pth")

_F64 = torch.float64


def load_isihara_weights(path: str | None = None):
    """The pretrained ICNN checkpoint as a dict of f64 numpy arrays, keyed
    by the torch module names (``layers.{0..3}``, ``skip_layers.{1..3}``)."""
    path = path or DEFAULT_WEIGHTS_PATH
    if not os.path.exists(path):
        raise FileNotFoundError(f"ICNN weights not found at {path}")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: np.asarray(v.detach().numpy(), dtype=np.float64) for k, v in sd.items()}


def _softplus(x):
    """``log(1 + exp(x))`` without a linear cut-off (``jax.nn.softplus``;
    ``torch.nn.functional.softplus`` returns ``x`` above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


class _Affine(nn.Module):
    """``weight @ x + bias``."""

    def __init__(self, n_in, n_out, device):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_out, n_in, dtype=_F64, device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(n_out, dtype=_F64, device=device), requires_grad=False)

    def forward(self, x):
        return self.weight @ x + self.bias


class _Positive(nn.Module):
    """``softplus(weights) @ x``: a layer with positive weights."""

    def __init__(self, n_in, n_out, device):
        super().__init__()
        self.weights = nn.Parameter(torch.zeros(n_out, n_in, dtype=_F64, device=device),
                                    requires_grad=False)

    def forward(self, x):
        return _softplus(self.weights) @ x


class ICNN(nn.Module):
    """The EUCLID ICNN energy with the corrected stress and its tangent, in
    f64 on ``device`` (``None``: the card; raises without one).

    ``weights``: a dict of arrays keyed as the checkpoint's state dict
    (default: ``load_isihara_weights()``)."""

    def __init__(self, weights: dict | None = None, n_hidden=(64, 64, 64), device=None):
        from .. import resolve_device

        super().__init__()
        dev = resolve_device(device)
        if weights is None:
            weights = load_isihara_weights()
        self.depth = len(n_hidden)
        widths = (3,) + tuple(n_hidden)
        self.layers = nn.ModuleList(
            [_Affine(3, n_hidden[0], dev)]
            + [_Positive(widths[i], widths[i + 1], dev) for i in range(1, self.depth)]
            + [_Positive(n_hidden[-1], 1, dev)])
        # skip connections from layer 1 on (index 0 holds no parameters)
        self.skip_layers = nn.ModuleList(
            [nn.Module()] + [_Affine(3, n_hidden[i], dev) for i in range(1, self.depth)]
            + [_Positive(3, 1, dev)])
        self.load_state_dict({k: torch.as_tensor(np.asarray(v), dtype=_F64)
                              for k, v in weights.items()})

        # correction tensor H = -dW_NN/dF at F = I (stress-free reference)
        F0 = torch.tensor([1.0, 0.0, 0.0, 1.0], dtype=_F64, device=dev)
        h = -torch.func.grad(self.energy)(F0)
        z = torch.zeros((), dtype=_F64, device=dev)
        self.register_buffer("H", torch.stack([
            torch.stack([h[0], h[1], z, z]),
            torch.stack([h[2], h[3], z, z]),
            torch.stack([z, z, h[0], h[1]]),
            torch.stack([z, z, h[2], h[3]]),
        ]), persistent=False)
        self._stress_and_tangent = torch.func.vmap(
            torch.func.jacfwd(self._stress_point, has_aux=True))
        self._graphs = {}  # batch size -> the call replayed from a CUDA graph

    # -- energy ---------------------------------------------------------
    @staticmethod
    def features(F_flat):
        """Invariant features (K1, K2, K3) of the flat 2D deformation
        gradient [F11, F12, F21, F22] under plane strain."""
        F11, F12, F21, F22 = F_flat[0], F_flat[1], F_flat[2], F_flat[3]
        C11 = F11 * F11 + F21 * F21
        C12 = F11 * F12 + F21 * F22
        C22 = F12 * F12 + F22 * F22
        I1 = C11 + C22 + 1.0
        I2 = C11 + C22 - C12 * C12 + C11 * C22
        I3 = C11 * C22 - C12 * C12
        K1 = I1 * torch.pow(I3, -1.0 / 3.0) - 3.0
        K2 = I2 * torch.pow(I3, -2.0 / 3.0) - 3.0
        K3 = (torch.sqrt(I3) - 1.0) ** 2
        return torch.stack([K1, K2, K3])

    def energy(self, F_flat):
        """W_NN(F): the scalar energy at one point (uncorrected)."""
        x = self.features(F_flat)
        z = self.layers[0](x)
        for i in range(1, self.depth):
            z = self.layers[i](z) + self.skip_layers[i](x)
            z = _softplus(z)
            z = z * z / 12.0
        y = self.layers[self.depth](z) + self.skip_layers[self.depth](x)
        return y[0]

    # -- stress / tangent -------------------------------------------------
    def _stress_point(self, F_flat):
        P = torch.func.grad(self.energy)(F_flat) + F_flat @ self.H
        return P, P

    def stress_and_tangent(self, F_batch_flat):
        """Batched (dP/dF (n, 4, 4), P (n, 4)), flattened: the external
        function's body (reference ``dP_dF_impl``,
        ``demo_hyperelasticity.py:445-456``)."""
        F = torch.as_tensor(F_batch_flat, dtype=_F64).reshape(-1, 4)
        n = F.shape[0]
        if F.device.type != "cuda":
            dP, P = self._stress_and_tangent(F)
            return dP.reshape(-1), P.reshape(-1)
        graphed = self._graphs.get(n)
        if graphed is None:
            from ..parallel.mg import cuda_graphed

            graphed = self._graphs[n] = cuda_graphed(
                lambda x: torch.cat([t.reshape(-1) for t in self._stress_and_tangent(x)]),
                F.contiguous())
        out = graphed(F)
        return out[:16 * n], out[16 * n:]
