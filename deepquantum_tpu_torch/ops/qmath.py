"""Quantum math helpers (the slice of ``deepquantum_tpu/ops/qmath.py`` the
port needs so far)."""

from __future__ import annotations

import torch

__all__ = ['expectation_pauli']


def expectation_pauli(state: torch.Tensor, obs_state: torch.Tensor) -> torch.Tensor:
    """Re<psi|O|psi> given the state and O|psi>."""
    return torch.sum(torch.conj(state.reshape(-1)) * obs_state.reshape(-1)).real
