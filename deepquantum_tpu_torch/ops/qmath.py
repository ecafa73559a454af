"""Quantum math helpers (the slice of ``deepquantum_tpu/ops/qmath.py`` the
port needs so far)."""

from __future__ import annotations

from typing import Any

import torch

from ..config import cdtype

__all__ = ['amplitude_encoding', 'expectation_pauli']


def amplitude_encoding(data: Any, nqubit: int) -> torch.Tensor:
    """Normalise data into state amplitudes, shape (batch, 2^n, 1), or
    (2^n, 1) for one vector: zero-pad or truncate to 2^n, then L2-normalise
    along the last axis (a zero vector stays zero)."""
    data = torch.as_tensor(data)
    single = data.dim() == 1 or (data.dim() == 2 and data.shape[-1] == 1)
    data = data.reshape(1 if single else data.shape[0], -1).to(cdtype())
    n = 2 ** nqubit
    data = data[:, :n]
    norm = torch.linalg.vector_norm(data, dim=-1, keepdim=True)
    data = data / torch.where(norm == 0, torch.ones_like(norm), norm)
    state = torch.nn.functional.pad(data, (0, n - data.shape[1]))[..., None]
    return state[0] if single else state


def expectation_pauli(state: torch.Tensor, obs_state: torch.Tensor,
                      nqubit: int | None = None) -> torch.Tensor:
    """Re<psi|O|psi> given the state and O|psi>; with ``nqubit``, one value
    per state of a batch whose last nqubit axes are the qubits."""
    if nqubit is None:
        return torch.sum(torch.conj(state.reshape(-1)) * obs_state.reshape(-1)).real
    axes = tuple(range(state.dim() - nqubit, state.dim()))
    return torch.sum(torch.conj(state) * obs_state, dim=axes).real
