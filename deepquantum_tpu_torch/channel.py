"""Qubit Kraus channels (density matrices only).

PyTorch counterpart of ``deepquantum_tpu/channel.py``. Every channel uses
the sin^2(theta) parametrisation: the stored parameter is theta and the
probability sin(theta)^2. A Kraus function maps the channel's packed
parameters, (npara,) or a batch (B, npara), to its stacked Kraus set
(K, 2, 2) or (B, K, 2, 2), complex in the policy dtype, on the parameters'
device. The circuit applies a set as sum_k K rho K^dagger (the einsum
route) or as its superoperator sum_k K (x) conj(K) (the planar route).
"""

from __future__ import annotations

import torch

from .config import cdtype

__all__ = ['CHANNEL_REGISTRY']


def _probs(p: torch.Tensor) -> torch.Tensor:
    return torch.sin(p) ** 2


def _kraus(*mats):
    """(..., K, 2, 2) complex from K Kraus operators, each given as its four
    row-major real entries (tensors of the parameters' batch shape, or 0)."""
    ref = next(e for m in mats for e in m if torch.is_tensor(e))
    rows = [torch.stack([e if torch.is_tensor(e) else torch.zeros_like(ref) + e for e in m], -1)
            for m in mats]
    return torch.stack(rows, -2).reshape(*ref.shape, len(mats), 2, 2).to(cdtype())


def _paulis(coeffs: torch.Tensor) -> torch.Tensor:
    """sum of Pauli Kraus operators c_0 I, c_1 X, c_2 Y, c_3 Z from (..., 4)
    real coefficients: (..., 4, 2, 2)."""
    c = coeffs.to(cdtype())
    zero = torch.zeros_like(c[..., 0])
    i, x, y, z = c.unbind(-1)
    mats = [(i, zero, zero, i), (zero, x, x, zero), (zero, -1j * y, 1j * y, zero),
            (z, zero, zero, -z)]
    return torch.stack([torch.stack(m, -1) for m in mats], -2).reshape(*c.shape[:-1], 4, 2, 2)


def bit_flip_kraus(p, device=None):
    prob = _probs(p[..., 0])
    return _kraus((torch.sqrt(1 - prob), 0, 0, torch.sqrt(1 - prob)),
                  (0, torch.sqrt(prob), torch.sqrt(prob), 0))


def phase_flip_kraus(p, device=None):
    prob = _probs(p[..., 0])
    return _kraus((torch.sqrt(1 - prob), 0, 0, torch.sqrt(1 - prob)),
                  (torch.sqrt(prob), 0, 0, -torch.sqrt(prob)))


def depolarizing_kraus(p, device=None):
    prob = _probs(p[..., 0])
    s = torch.sqrt(prob / 3)
    return _paulis(torch.stack([torch.sqrt(1 - prob), s, s, s], -1))


def pauli_kraus(p, device=None):
    prob = _probs(p)
    return _paulis(torch.sqrt(prob / prob.sum(-1, keepdim=True)))


def amplitude_damping_kraus(p, device=None):
    prob = _probs(p[..., 0])
    return _kraus((1, 0, 0, torch.sqrt(1 - prob)), (0, torch.sqrt(prob), 0, 0))


def phase_damping_kraus(p, device=None):
    prob = _probs(p[..., 0])
    return _kraus((1, 0, 0, torch.sqrt(1 - prob)), (0, 0, 0, torch.sqrt(prob)))


def generalized_amplitude_damping_kraus(p, device=None):
    prob = _probs(p)
    pr, gamma = prob[..., 0], prob[..., 1]
    a, b = torch.sqrt(pr), torch.sqrt(1 - pr)
    return _kraus((a, 0, 0, a * torch.sqrt(1 - gamma)), (0, a * torch.sqrt(gamma), 0, 0),
                  (b * torch.sqrt(1 - gamma), 0, 0, b), (0, 0, b * torch.sqrt(gamma), 0))


# name -> npara and the Kraus function (p, device) -> (..., K, 2, 2), the
# calling convention of the gate registry
CHANNEL_REGISTRY = {
    'BitFlip': dict(npara=1, fn=bit_flip_kraus),
    'PhaseFlip': dict(npara=1, fn=phase_flip_kraus),
    'Depolarizing': dict(npara=1, fn=depolarizing_kraus),
    'Pauli': dict(npara=4, fn=pauli_kraus),
    'AmplitudeDamping': dict(npara=1, fn=amplitude_damping_kraus),
    'PhaseDamping': dict(npara=1, fn=phase_damping_kraus),
    'GeneralizedAmplitudeDamping': dict(npara=2, fn=generalized_amplitude_damping_kraus),
}

