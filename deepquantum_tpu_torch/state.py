"""Qubit state container.

PyTorch counterpart of ``deepquantum_tpu/state.py``: a pure state, a
(2^n, 1) complex tensor on an explicit device, built from 'zeros', 'equal',
'ghz' (or 'entangle'/'GHZ') or an explicit array, which is
amplitude-encoded (truncated or zero-padded to 2^n, then normalised); or,
with ``den_mat``, the density matrix |s><s| (2^n, 2^n) of such a state, or a
given (2^n, 2^n) matrix as it is.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .config import cdtype, resolve_device

__all__ = ['QubitState']


class QubitState:
    """A pure state of ``nqubit`` qubits, shape (2^n, 1), or with ``den_mat``
    a density matrix (2^n, 2^n)."""

    def __init__(self, nqubit: int = 1, state: Any = 'zeros', den_mat: bool = False,
                 device=None) -> None:
        self.nqubit = nqubit
        self.den_mat = den_mat
        device = resolve_device(device)
        dim = 2 ** nqubit
        if den_mat and not isinstance(state, str):
            data = torch.as_tensor(np.asarray(state) if not torch.is_tensor(state) else state)
            if tuple(data.shape[-2:]) == (dim, dim):
                self.state = data.to(device=device, dtype=cdtype())
                return
        if isinstance(state, str):
            s = torch.zeros((dim, 1), dtype=cdtype(), device=device)
            if state == 'zeros':
                s[0, 0] = 1
            elif state == 'equal':
                s.fill_(dim ** -0.5)
            elif state in ('entangle', 'GHZ', 'ghz'):
                s[0, 0] = 2 ** -0.5
                s[-1, 0] = 2 ** -0.5
            else:
                raise ValueError(f'Unknown init state: {state}')
        else:
            data = torch.as_tensor(np.asarray(state) if not torch.is_tensor(state) else state)
            data = data.reshape(-1).to(device=device, dtype=cdtype())[:dim]
            s = torch.zeros((dim, 1), dtype=cdtype(), device=device)
            norm = torch.linalg.vector_norm(data)
            s[:data.numel(), 0] = data / torch.where(norm == 0, torch.ones_like(norm), norm)
        self.state = s @ s.conj().T if den_mat else s
